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
    # the window copied out: a view would keep all of ``xp`` alive in the
    # cache (the reference's slice is a copy)
    new_state = xp[:, -(K - 1):].clone() if K > 1 else None
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
    whose mode splits the channels (``d_inner``) each rank runs its
    channels (``_ssm_sharded``); else each rank runs the block on its
    rows of the batch (``sharding.batch_local``): the projection's z |
    xBC | dt columns and the heads' parameters are whole there."""
    if sharding.is_dtensor(x):
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        layout = sharding.channel_layout((x.shape[0], x.shape[1], d_inner))
        if layout is not None:
            return _ssm_sharded(cfg, p, x, state, layout)
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
    y, h_last = _scan(cfg, xs, Bm, Cm, dtm, A,
                      None if state is None else state["h"])
    y = y + xs.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(dt)
    out = _gated_out(p, y, z, dt)
    return out, {"h": h_last, "conv": new_conv}


def _scan(cfg, xs, Bm, Cm, dtm, A, h):
    """y (B, S, H, P) and the last state (B, H, N, P) of the SSD over
    ``xs`` (B, S, H, P): the chunked dual form for training or a prefill
    from scratch (``h`` None, or S > 1), else the recurrent decode step
    h = h * exp(dt A) + dt B x, y = C . h."""
    if h is None or xs.shape[1] > 1:
        return ssd_chunked(cfg, xs, Bm, Cm, dtm, A)
    dec = torch.exp(dtm[:, 0] * A[None, :])  # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), dtm[:, 0],
                       xs[:, 0].float())
    h_last = h * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h_last)[:, None]
    return y, h_last


def _gated_out(p, y, z, dt):
    """The gated RMSNorm of ``y`` (B, S, d_inner) and the output
    projection.  Over a mesh whose mode splits the channels the mean's
    partial sums are reduced first (one all-reduce of (B, S, 1)) and the
    product is a partial sum over the channels' axes, reduced by the
    caller's constraint."""
    y = y * F.silu(z)
    if sharding.is_dtensor(y):  # the sum's partial sums reduced, then /n
        var = sharding.constrain(
            torch.sum(torch.square(y.float()), -1, keepdim=True),
            ("batch", None, None)) / y.shape[-1]
    else:
        var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)).to(dt)
    y = y * p["norm_scale"].to(dt)
    return y @ p["w_out"].to(dt)


def _ssm_sharded(cfg, p, x, state, layout):
    """``ssm_block`` over a mesh whose mode splits the channels
    (``d_inner``) over 'mlp''s axes (``layout``, from
    ``sharding.channel_layout``), as the reference lays out ``w_in``'s,
    ``norm_scale``'s and ``w_out``'s: each rank runs the SSD on its
    channels, each channel a head of one (its head's dt, A and D), which
    is the per-head scan split within heads (mamba2-130m's 24 heads over
    16 ranks).  The projection: where ``w_in``'s columns are whole over
    the channels' axes, each rank projects onto its own z and x columns
    (a local split) and every rank onto B, C and dt, which all heads
    share; where they are split (a contiguous chunk of z | x | B | C |
    dt, which matches no rank's channels), the product's columns are
    gathered (activations, not the weight).  ``conv`` (K x C) and the
    heads' vectors are small and taken whole.  The gated norm and
    ``w_out`` run at the DTensor level on the split channels
    (``_gated_out``).  The new state is gathered into the cache's layout
    (channels whole)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P
    dt = cfg.torch_dtype
    mesh = x.device_mesh
    run = sharding.placements(layout, mesh)  # (B, S, d_inner)
    rows = tuple(p_ if p_.is_shard(0) else Replicate() for p_ in run)
    by_row = tuple(Shard(1) if p_.is_shard(2) else p_ for p_ in run)
    x = sharding.constrain(x, ("batch", None, None))
    w = p["w_in"]
    if any(p_.is_shard(1) for p_ in w.placements):
        proj = sharding.constrain(x @ w.to(dt), ("batch", None, None))
        z, xs, rest = torch.split(proj, [d_inner, d_inner, 2 * N + H], -1)
    else:
        z, xs = (x @ sharding.split_columns(w[:, i * d_inner:
                                               (i + 1) * d_inner]).to(dt)
                 for i in (0, 1))
        rest = x @ w[:, 2 * d_inner:].to(dt)
    z = sharding.redistribute(z, layout)
    xs = sharding.redistribute(xs, layout)
    rest = sharding.constrain(rest, ("batch", None, None))
    c0 = sharding.local_offset(xs, 2)

    def core(xl, restl, conv_w, A_log, D, dt_bias, *st):
        Bsz, S, C = xl.shape
        head = torch.arange(c0, c0 + C, device=xl.device) // P
        Bm, Cm, dtraw = torch.split(restl, [N, N, H], dim=-1)
        own = slice(c0, c0 + C)
        cols = torch.cat([conv_w[:, own], conv_w[:, d_inner:]], dim=-1)
        cst = (torch.cat([st[1][..., own], st[1][..., d_inner:]], dim=-1)
               if st else None)
        xBC, new_conv = _causal_conv(torch.cat([xl, Bm, Cm], dim=-1), cols,
                                     cst)
        xc, Bm, Cm = torch.split(xBC, [C, N, N], dim=-1)
        dtm = F.softplus(dtraw.float() + dt_bias.float())[..., head]
        A = -torch.exp(A_log.float())[head]
        h = None
        if st:  # (B, H, N, P) -> this rank's channels, (B, C, N, 1)
            h = st[0].transpose(2, 3).reshape(Bsz, H * P, N)[:, own, :, None]
        y, h_last = _scan(cfg, xc.reshape(Bsz, S, C, 1), Bm, Cm, dtm, A, h)
        y = y[..., 0] + xc.float() * D.float()[head]
        new_x, new_bc = torch.split(new_conv, [C, 2 * N], dim=-1)
        return y.to(dt), h_last[..., 0], new_x, new_bc

    whole = (Replicate(),) * mesh.ndim
    ins = [xs, rest, p["conv"], p["A_log"], p["D"], p["dt_bias"]]
    in_pl = [run, rows, whole, whole, whole, whole]
    if state:
        ins += [state["h"], state["conv"]]
        in_pl += [rows, rows]
    fn = local_map(core, out_placements=(run, by_row, run, rows),
                   in_placements=in_pl,
                   in_grad_placements=[sharding.summed_where_split(pl, run)
                                       for pl in in_pl],
                   device_mesh=mesh, redistribute_inputs=True)
    y, h_ch, new_x, new_bc = fn(*ins)
    out = sharding.constrain(_gated_out(p, y, z, dt), ("batch", None, None))
    # the new state, channels whole: h (B, d_inner, N) -> (B, H, N, P)
    h_last = sharding._moved(h_ch, rows).reshape(x.shape[0], H, P, N)
    h_last = h_last.transpose(2, 3)
    new_conv = torch.cat([sharding._moved(new_x, rows), new_bc], dim=-1)
    if state is None:
        return out, {"h": h_last, "conv": new_conv}
    return out, {"h": sharding._moved(h_last, state["h"].placements),
                 "conv": sharding._moved(new_conv, state["conv"].placements)}


def init_ssm_state(cfg, batch: int, device=None):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    C = H * P + 2 * N
    return {
        "h": torch.zeros((batch, H, N, P), device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, C),
                            dtype=cfg.torch_dtype, device=device),
    }
