"""Mamba2 / SSD (state-space duality) blocks on PyTorch.

Port of ``repro.models.ssm``.  Prefill uses the chunked dual form:
quadratic attention-like computation within chunks plus a linear
recurrence over per-chunk states, here a loop over chunks in place of
``lax.scan``.  Decode is the O(1)-per-token recurrent update.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed import sharding
from .layers import _init


def ssm_params(cfg, gen: torch.Generator) -> Dict:
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    N = cfg.ssm_state
    dt = cfg.torch_param_dtype
    dev = gen.device
    return {
        # projections: z (gate), x, B, C, dt
        "w_in": _init(gen, (cfg.d_model,
                            2 * d_inner + 2 * N + cfg.ssm_heads), dt),
        "conv": _init(gen, (cfg.d_conv, d_inner + 2 * N), dt, scale=0.5),
        "A_log": torch.zeros((cfg.ssm_heads,), dtype=dt, device=dev)
        + math.log(1.0),
        "D": torch.ones((cfg.ssm_heads,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((cfg.ssm_heads,), dtype=dt, device=dev),
        "w_out": _init(gen, (d_inner, cfg.d_model), dt,
                       scale=1.0 / math.sqrt(d_inner)),
        "norm_scale": torch.ones((d_inner,), dtype=dt, device=dev),
    }


def _causal_conv(xBC, w, conv_state=None):
    """Depthwise causal conv then SiLU; returns (out, new_conv_state)."""
    Bsz, S, C = xBC.shape
    K = w.shape[0]
    pad = (torch.zeros((Bsz, K - 1, C), dtype=xBC.dtype, device=xBC.device)
           if conv_state is None else conv_state)
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+K-1, C)
    windows = xp.unfold(1, K, 1)  # (B, S, C, K)
    out = torch.einsum("bsck,kc->bsc", windows, w.to(xBC.dtype))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(out), new_state


def ssd_chunked(cfg, x, Bm, Cm, dtm, A):
    """Chunked SSD scan.

    x:  (B, S, H, P)   per-head inputs
    Bm: (B, S, N)      input matrix (shared across heads, n_groups=1)
    Cm: (B, S, N)      output matrix
    dtm:(B, S, H)      softplus'd timestep (>0)
    A:  (H,)           negative decay rate
    Returns (y (B, S, H, P), final state (B, H, N, P) f32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(cfg.ssm_chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dtm = F.pad(dtm, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    Af = A.float()
    h = torch.zeros((Bsz, H, N, P), device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xk, bk, ck = x[:, sl].float(), Bm[:, sl].float(), Cm[:, sl].float()
        dk = dtm[:, sl].float()  # (B,L,H)
        logdec = dk * Af[None, None, :]
        cum = torch.cumsum(logdec, dim=1)
        # intra-chunk: y_j += sum_{i<=j} C_j.B_i dt_i x_i e^{cum_j - cum_i}
        decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,j,i,H)
        # masked before the exp, not after: above the diagonal the decay
        # is a sum of positive terms, whose exp overflows at the published
        # chunk of 256, and the reference's where(causal, exp(decay), 0)
        # then has a NaN gradient (0 * inf); the values are the same
        gamma = torch.exp(torch.where(causal[None, :, :, None], decay,
                                      -math.inf))
        cb = torch.einsum("bjn,bin->bji", ck, bk)
        y_intra = torch.einsum("bji,bjih,bih,bihp->bjhp", cb, gamma, dk, xk)
        # inter-chunk: y_j += C_j . (h * e^{cum_j})
        y_inter = torch.einsum("bjn,bjh,bhnp->bjhp", ck, torch.exp(cum), h)
        # state update: h' = e^{cum_L} h + sum_i e^{cum_L - cum_i} B_i dt_i x_i
        end = cum[:, -1:, :]
        w = torch.exp(end - cum) * dk
        s_c = torch.einsum("bin,bih,bihp->bhnp", bk, w, xk)
        h = h * torch.exp(end[:, 0])[..., None, None] + s_c
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def ssm_block(cfg, p, x, state=None):
    """Full Mamba2 block.  state = dict(h=(B,H,N,P), conv=(B,K-1,C)) for
    decode; None for training/prefill.  A state with S > 1 feeds its conv
    window but not its ``h`` (the reference's convention: prefill starts
    the recurrence from zero).  Returns (out, new_state).  Over a mesh
    each rank runs the block on its rows of the batch
    (``sharding.batch_local``): the projection's z | xBC | dt columns and
    the heads' parameters are whole there."""
    if sharding.is_dtensor(x):
        return sharding.batch_local(
            lambda xl, pl, st: ssm_block(cfg, pl, xl, st), x, p, state)
    Bsz, S, D = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P
    dt = cfg.torch_dtype
    proj = x @ p["w_in"].to(dt)
    z, xBC, dtraw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv"], conv_state)
    xs, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    dtm = F.softplus(dtraw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if state is None or S > 1:
        # training or prefill-from-scratch: chunked dual form
        y, h_last = ssd_chunked(cfg, xs, Bm, Cm, dtm, A)
    else:
        # recurrent decode: h = h * exp(dt A) + dt B x ; y = C . h
        h = state["h"]
        dec = torch.exp(dtm[:, 0] * A[None, :])  # (B,H)
        upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), dtm[:, 0],
                           xs[:, 0].float())
        h_last = h * dec[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h_last)[:, None]

    y = y + xs.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(dt)
    # gated RMSNorm then output projection
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)).to(dt)
    y = y * p["norm_scale"].to(dt)
    out = y @ p["w_out"].to(dt)
    return out, {"h": h_last, "conv": new_conv}


def init_ssm_state(cfg, batch: int, device=None):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    C = H * P + 2 * N
    return {
        "h": torch.zeros((batch, H, N, P), device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, C),
                            dtype=cfg.torch_dtype, device=device),
    }
