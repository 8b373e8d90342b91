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
    # the window copied out: a view would keep all of ``xp`` alive in the
    # cache (the reference's slice is a copy)
    return out, (xp[:, -(K - 1):].clone() if K > 1 else None)


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


def _recurrence(lam, gate_i, gate_a, u, h_prev):
    """The gated linear recurrence of every channel of ``u`` (B, S, W):
    (h (B, S, W) f32, h_last (B, W)).  ``h_prev`` None, or S > 1, starts
    from zero (the reference's convention)."""
    log_a = (-C_FACTOR * F.softplus(lam.float())
             * gate_a.float())  # (B,S,W) < 0
    a = torch.exp(log_a)
    gated = (gate_i * u).float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                   1e-12)) * gated
    if h_prev is None or u.shape[1] > 1:
        h = _linear_scan(a, b)
        # a copy, not a view of every step's h kept in the cache
        return h, h[:, -1].clone()
    h_last = a[:, 0] * h_prev + b[:, 0]
    return h_last[:, None], h_last


def rglru_block(cfg, p, x, state=None):
    """Returns (out, new_state); state = dict(h=(B,W) f32, conv=(B,K-1,W)).
    A state with S > 1 feeds its conv window but not its ``h`` (the
    reference's convention: prefill starts the recurrence from zero).
    Over a mesh whose mode splits the channels, each rank runs its
    channels (``_rglru_sharded``); else each rank runs the block on its
    rows of the batch (``sharding.batch_local``)."""
    if sharding.is_dtensor(x):
        W = p["w_x"].shape[1]
        layout = sharding.channel_layout((x.shape[0], x.shape[1], W))
        if layout is not None:
            return _rglru_sharded(cfg, p, x, state, layout)
        return sharding.batch_local(
            lambda xl, pl, st: rglru_block(cfg, pl, xl, st), x, p, state)
    dt = cfg.torch_dtype
    u = x @ p["w_x"].to(dt)  # (B,S,W)
    conv_state = state["conv"] if state is not None else None
    u, new_conv = _conv1d(u, p["conv"], conv_state)

    gate_i = torch.sigmoid(u @ p["w_input_gate"].to(dt))
    gate_a = torch.sigmoid(u @ p["w_a_gate"].to(dt))
    h, h_last = _recurrence(p["lam"], gate_i, gate_a, u,
                            None if state is None else state["h"])
    y = h.to(dt) @ p["w_y"].to(dt)
    return y, {"h": h_last, "conv": new_conv}


def _rglru_sharded(cfg, p, x, state, layout):
    """``rglru_block`` over a mesh whose mode splits the channels (W)
    over 'mlp''s axes (``layout``, from ``sharding.channel_layout``), as
    the reference lays out the weights: each rank projects onto its
    channels (``w_x``'s columns, split locally where the layout left them
    whole), runs the conv, the gates' nonlinearity and the recurrence on
    them (``local_map``), and multiplies by its rows of ``w_y``.  The
    gate products (``("mlp", "mlp2")``) contract each rank's channels: a
    partial sum, reduce-scattered back onto the channels, their outputs
    split over a mesh dim that the rows leave idle as the reference's are
    (``_gate_weight``); ``w_y``'s is
    reduced by the output's constraint, as the MLP's is.  The new state is
    gathered into the cache's layout (channels whole)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dt = cfg.torch_dtype
    mesh = x.device_mesh
    run = sharding.placements(layout, mesh)  # (B, S, W): rows, channels
    chan = tuple(Shard(1) if p_.is_shard(2) else Replicate() for p_ in run)
    vec = tuple(Shard(0) if p_.is_shard(2) else Replicate() for p_ in run)
    st_h = tuple(Shard(1) if p_.is_shard(2) else p_ for p_ in run)
    x = sharding.constrain(x, ("batch", None, None))
    u = sharding.redistribute(x @ sharding.split_columns(p["w_x"]).to(dt),
                              layout)
    conv_in = [u, p["conv"]] + ([state["conv"]] if state else [])
    conv_pl = [run, chan] + ([run] if state else [])
    conv = local_map(
        lambda ul, wl, *st: _conv1d(ul, wl, st[0] if st else None),
        out_placements=(run, run), in_placements=conv_pl,
        in_grad_placements=[sharding.summed_where_split(pl, run)
                            for pl in conv_pl],
        device_mesh=mesh, redistribute_inputs=True)
    u, new_conv = conv(*conv_in)

    gate_i = sharding.redistribute(u @ _gate_weight(p["w_input_gate"], run)
                                   .to(dt), layout)
    gate_a = sharding.redistribute(u @ _gate_weight(p["w_a_gate"], run)
                                   .to(dt), layout)
    rec_in = [p["lam"], gate_i, gate_a, u] + ([state["h"]] if state else [])
    rec_pl = [vec, run, run, run] + ([st_h] if state else [])
    rec = local_map(
        lambda lam, gi, ga, ul, *h: _recurrence(
            lam, torch.sigmoid(gi), torch.sigmoid(ga), ul,
            h[0] if h else None),
        out_placements=(run, st_h), in_placements=rec_pl,
        in_grad_placements=[sharding.summed_where_split(pl, run)
                            for pl in rec_pl],
        device_mesh=mesh, redistribute_inputs=True)
    h, h_last = rec(*rec_in)
    y = sharding.constrain(h.to(dt) @ p["w_y"].to(dt), ("batch", None, None))
    if state is None:
        return y, {"h": h_last, "conv": new_conv}
    return y, {"h": sharding._moved(h_last, state["h"].placements),
               "conv": sharding._moved(new_conv, state["conv"].placements)}


def _gate_weight(w, run):
    """The gate's weight ``w`` (W, W) for a product with the channels laid
    out by ``run``: its output columns split (a local slice) over the mesh
    dims of extent above 1 that the mode's 'embed' rule maps to and that
    split neither the rows nor the channels, where they divide W.  A batch
    of one leaves 'data' so under ``tp_fsdp``, and the reference's compile
    then splits the gates' outputs over it (``[160] <- [160]`` on
    recurrentgemma-2b long_500k over pod), so each rank forms only its
    share of them, and ``redistribute`` brings the product to the
    channels' layout.  Elsewhere ``w`` itself."""
    from torch.distributed.tensor import Shard

    mesh = w.device_mesh
    idle = [d for d in sharding._rule_dims(mesh, sharding.active()[1],
                                           "embed")
            if mesh.size(d) > 1 and not run[d].is_shard()
            and not w.placements[d].is_shard()]
    if not idle or w.shape[1] % math.prod(mesh.size(d) for d in idle):
        return w
    return sharding._moved(w, tuple(Shard(1) if d in idle else p_
                                    for d, p_ in enumerate(w.placements)))


def init_rglru_state(cfg, batch: int, device=None):
    W = cfg.rglru_dim or cfg.d_model
    return {
        "h": torch.zeros((batch, W), device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, W),
                            dtype=cfg.torch_dtype, device=device),
    }
