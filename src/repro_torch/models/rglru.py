"""RG-LRU recurrent block (RecurrentGemma / Griffin) on PyTorch.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t)),  c = 8.

Port of ``repro.models.rglru``.  Prefill scans the linear recurrence in
log2(S) doubling steps (``_linear_scan``) where the reference uses
``lax.associative_scan``: both combine the same pairs, associated
differently, so the sums agree to rounding (~1e-6 in f32).  Decode is the
O(1) per-token update.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed import sharding
from .layers import _init

C_FACTOR = 8.0


def rglru_params(cfg, gen: torch.Generator) -> Dict:
    W = cfg.rglru_dim or cfg.d_model
    dt = cfg.torch_param_dtype
    return {
        "w_x": _init(gen, (cfg.d_model, W), dt),
        "w_y": _init(gen, (W, cfg.d_model), dt, scale=1.0 / math.sqrt(W)),
        "conv": _init(gen, (cfg.d_conv, W), dt, scale=0.5),
        "w_input_gate": _init(gen, (W, W), dt),
        "w_a_gate": _init(gen, (W, W), dt),
        "lam": torch.ones((W,), dtype=dt, device=gen.device) * 2.0,
    }


def _conv1d(x, w, conv_state=None):
    Bsz, S, C = x.shape
    K = w.shape[0]
    pad = (torch.zeros((Bsz, K - 1, C), dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state)
    xp = torch.cat([pad, x], dim=1)
    out = torch.einsum("bsck,kc->bsc", xp.unfold(1, K, 1), w.to(x.dtype))
    return out, (xp[:, -(K - 1):] if K > 1 else None)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t, h_{-1} = 0, along axis 1.

    Each doubling step combines every element with the one ``d`` before
    it, (a, b) <- (a_{t-d} a_t, a_t b_{t-d} + b_t), the reference's
    ``combine``.  Products of a_t in (0, 1] only shrink, so no step can
    overflow (a closed form through exp(-cumsum(log a)) would)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_block(cfg, p, x, state=None):
    """Returns (out, new_state); state = dict(h=(B,W) f32, conv=(B,K-1,W)).
    A state with S > 1 feeds its conv window but not its ``h`` (the
    reference's convention: prefill starts the recurrence from zero).
    Over a mesh each rank runs the block on its rows of the batch
    (``sharding.batch_local``)."""
    if sharding.is_dtensor(x):
        return sharding.batch_local(
            lambda xl, pl, st: rglru_block(cfg, pl, xl, st), x, p, state)
    dt = cfg.torch_dtype
    S = x.shape[1]
    u = x @ p["w_x"].to(dt)  # (B,S,W)
    conv_state = state["conv"] if state is not None else None
    u, new_conv = _conv1d(u, p["conv"], conv_state)

    gate_i = torch.sigmoid(u @ p["w_input_gate"].to(dt))
    gate_a = torch.sigmoid(u @ p["w_a_gate"].to(dt))
    log_a = (-C_FACTOR * F.softplus(p["lam"].float())
             * gate_a.float())  # (B,S,W) < 0
    a = torch.exp(log_a)
    gated = (gate_i * u).float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                   1e-12)) * gated

    if state is None or S > 1:
        h = _linear_scan(a, b)
        h_last = h[:, -1]
    else:
        h_last = a[:, 0] * state["h"] + b[:, 0]
        h = h_last[:, None]

    y = h.to(dt) @ p["w_y"].to(dt)
    return y, {"h": h_last, "conv": new_conv}


def init_rglru_state(cfg, batch: int, device=None):
    W = cfg.rglru_dim or cfg.d_model
    return {
        "h": torch.zeros((batch, W), device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, W),
                            dtype=cfg.torch_dtype, device=device),
    }
