"""Core layers on PyTorch: norms, RoPE, chunked attention, MLP, MoE.

Port of ``repro.models.layers``.  Layers are functions over explicit
parameter dicts laid out as the reference's pytrees, so weights carry
across leaf for leaf (``models.weights.params_from_numpy``).  Where the
port differs:

- parameter creators draw from a ``torch.Generator`` (``jax.random`` cannot
  be reproduced) and return the parameters only: their sharding specs
  come from ``models.lm.param_specs``;
- over a mesh the parameters and activations are DTensors: the
  ``constrain`` calls redistribute them, and the attention core runs per
  rank (``_attend``);
- ``flash_attention``'s ``custom_vjp`` is a ``torch.autograd.Function``
  (``_Flash``) with the same manual backward (reference ``:158-239``);
- a KV cache holds its fill index ``idx`` as a host int, not a 0-d device
  array (a device index would force a host sync in every layer), and is
  written in place, clamped as ``lax.dynamic_update_slice`` clamps.

Every ``p[...].to(dt)`` is the reference's ``.astype(dt)``: a copy on
every call for a parameter kept in another dtype, none for one already
cast (``models.weights.cast_for_compute``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..distributed.sharding import constrain, constrain_any

Params = Dict


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar in a JAX op takes the array's dtype (weak typing),
    so the reference rounds it to that dtype first; torch would not."""
    return torch.tensor(value, dtype=dtype).item()


def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm_params(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S).  A bf16 ``x`` times the f32
    cos/sin promotes to f32 and is cast back, as in the reference."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (streaming softmax over KV chunks, torch ops)
# ---------------------------------------------------------------------------

def attention_params(cfg, gen: torch.Generator) -> Params:
    dt = cfg.torch_param_dtype
    p = {
        "wq": _init(gen, (cfg.d_model, cfg.q_dim), dt),
        "wk": _init(gen, (cfg.d_model, cfg.kv_dim), dt),
        "wv": _init(gen, (cfg.d_model, cfg.kv_dim), dt),
        "wo": _init(gen, (cfg.q_dim, cfg.d_model), dt,
                    scale=1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=dt, device=gen.device)
    return p


def _mask_for(causal: bool, window: int, q_pos, k_pos,
              kv_valid: int) -> torch.Tensor:
    mask = (k_pos < kv_valid)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask  # (qc, kc)


def _chunk_masked(causal: bool, window: int, q_lo: int, q_hi: int,
                  k_lo: int, k_hi: int, kv_valid: int) -> bool:
    """Whether every (q, k) of a block is masked.  Skipping such a block is
    exact for every row that sees a key: it would add p = 0 after a finite
    running max, and before one its sums are zeroed by corr = 0."""
    return (k_lo >= kv_valid or (causal and k_lo > q_hi)
            or (window > 0 and k_hi <= q_lo - window))


def _flash_fwd(q, k, v, cfgt):
    """The forward over padded, grouped ``q`` (B, Sqp, Hkv, rep, Dh) and
    ``k``/``v`` (B, Skp, Hkv, Dh): (out like ``q``, lse (B, Hkv, rep, Sqp)
    f32), the reference's ``_flash_fwd_impl``."""
    causal, window, q_chunk, kv_chunk, q_offset, kv_valid = cfgt
    B, Sqp, Hkv, rep, Dh = q.shape
    nq, nk = Sqp // q_chunk, k.shape[1] // kv_chunk
    scale = weak_scalar(1.0 / math.sqrt(Dh), q.dtype)
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        q_lo = q_offset + qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        qb = (q[:, qi * q_chunk:(qi + 1) * q_chunk] * scale).float()
        m = torch.full((B, Hkv, rep, q_chunk), -math.inf, device=dev)
        l = torch.zeros((B, Hkv, rep, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, rep, q_chunk, Dh), device=dev)
        for ci in range(nk):
            k_lo = ci * kv_chunk
            if _chunk_masked(causal, window, q_lo, q_lo + q_chunk - 1, k_lo,
                             k_lo + kv_chunk - 1, kv_valid):
                continue
            kblk = k[:, k_lo:k_lo + kv_chunk].float()
            vblk = v[:, k_lo:k_lo + kv_chunk]
            k_pos = k_lo + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kblk)
            mask = _mask_for(causal, window, q_pos, k_pos, kv_valid)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(q.dtype).float(), vblk.float())
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd(q, k, v, out, lse, dout, cfgt):
    """The reference's manual flash backward (``_flash_bwd_impl``): each
    block's p is recomputed from the saved logsumexp, so nothing is kept
    per kv step; ``delta = rowsum(dout * out)``, ``ds = p (dp - delta)``.
    p, dout and ds are rounded to q's dtype before each product, the
    products are summed in f32, and dq/dk/dv accumulate in f32.  The blocks
    the forward skips are skipped here too: their p is exactly 0."""
    causal, window, q_chunk, kv_chunk, q_offset, kv_valid = cfgt
    B, Sqp, Hkv, rep, Dh = q.shape
    nq, nk = Sqp // q_chunk, k.shape[1] // kv_chunk
    dt = q.dtype
    q_scale = weak_scalar(1.0 / math.sqrt(Dh), dt)
    scale = weak_scalar(1.0 / math.sqrt(Dh), torch.float32)
    dev = q.device
    delta = torch.einsum("bsgrd,bsgrd->bgrs", dout.float(), out.float())
    dk = torch.zeros(k.shape, device=dev)
    dv = torch.zeros(v.shape, device=dev)
    dqs = []
    for qi in range(nq):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        q_lo = q_offset + qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        qblk = q[:, rows]
        qb = (qblk * q_scale).float()
        qf = qblk.float()
        dob = dout[:, rows].to(dt).float()
        lse_b, delta_b = lse[..., rows, None], delta[..., rows, None]
        dq = torch.zeros(qblk.shape, device=dev)
        for ci in range(nk):
            k_lo = ci * kv_chunk
            if _chunk_masked(causal, window, q_lo, q_lo + q_chunk - 1, k_lo,
                             k_lo + kv_chunk - 1, kv_valid):
                continue
            cols = slice(k_lo, k_lo + kv_chunk)
            kblk, vblk = k[:, cols].float(), v[:, cols].float()
            k_pos = k_lo + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kblk)
            mask = _mask_for(causal, window, q_pos, k_pos, kv_valid)
            p = torch.where(mask, torch.exp(s - lse_b), 0.0)
            dv[:, cols] += torch.einsum("bgrqk,bqgrd->bkgd",
                                        p.to(dt).float(), dob)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", dob, vblk)
            dsb = (p * (dp - delta_b)).to(dt).float()
            dq += torch.einsum("bgrqk,bkgd->bqgrd", dsb, kblk) * scale
            dk[:, cols] += torch.einsum("bgrqk,bqgrd->bkgd", dsb, qf) * scale
        dqs.append(dq)
    return (torch.cat(dqs, dim=1).to(dt), dk.to(k.dtype), dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The chunked attention with the manual backward, the reference's
    ``custom_vjp``.  ``cfgt`` (masking, chunks, ``q_offset``,
    ``kv_valid``) gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cfgt):
        out, lse = _flash_fwd(q, k, v, cfgt)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfgt = cfgt
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, ctx.cfgt), None)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 512, kv_valid: Optional[int] = None):
    """Streaming softmax attention, chunked over q and kv, with the
    reference's manual flash backward (``_Flash``).

    q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh).  GQA: Hq % Hkv == 0.
    ``q_offset`` is the absolute position of q[0] relative to k[0] (decode
    with a cache passes the fill index); keys at or past ``kv_valid``
    (default Sk) are masked.  Scores and the running (m, l, acc) are f32,
    p is cast to q's dtype before P.V; masked scores are -1e30, m starts
    at -inf, l is floored at 1e-30.  Where no gradient is wanted (serving
    runs under ``no_grad``) the forward runs alone and keeps nothing for
    a backward.  Returns (B, Sq, Hq, Dh).
    """
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kv_chunk = min(kv_chunk, Sk)
    q_chunk = min(q_chunk, Sq)
    nk = -(-Sk // kv_chunk)
    nq = -(-Sq // q_chunk)
    pad_k, pad_q = nk * kv_chunk - Sk, nq * q_chunk - Sq
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    qg = q.reshape(B, nq * q_chunk, Hkv, rep, Dh)
    cfgt = (bool(causal), int(window), q_chunk, kv_chunk, int(q_offset),
            Sk if kv_valid is None else int(kv_valid))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _Flash.apply(qg, k, v, cfgt)
    else:
        out = _flash_fwd(qg, k, v, cfgt)[0]
    return out.reshape(B, nq * q_chunk, Hq, Dh)[:, :Sq]


def _attend(q, k, v, **kw):
    """``flash_attention(q, k, v, **kw)``.  On DTensors it runs per rank
    under ``local_map``, on the layouts of ``sharding.attention_pspecs``:
    attention is independent per (batch, head), so each rank's result is
    exact, and a sequence sharded by ``act_seq`` is gathered first."""
    if not sharding.is_dtensor(q):
        return flash_attention(q, k, v, **kw)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qs, kvs = sharding.attention_pspecs(q.shape, k.shape)
    qp, kvp = sharding.placements(qs, mesh), sharding.placements(kvs, mesh)
    core = local_map(functools.partial(flash_attention, **kw),
                     out_placements=list(qp), in_placements=(qp, kvp, kvp),
                     device_mesh=mesh, redistribute_inputs=True)
    return core(q, k, v)


def _whole_seq(x):
    """``x`` (B, S, d) with its sequence whole on every rank before a
    projection: the all-gather that ends sequence parallelism (GSPMD
    inserts it for the reference), so a product never flattens a split
    sequence into its rows.  A plain tensor is ``x`` itself."""
    return constrain(x, ("batch", None, None))


def _qkv(cfg, p: Params, x, src):
    B, S, _ = x.shape
    dt = cfg.torch_dtype
    x = _whole_seq(x)
    src = x if src is None else _whole_seq(src)
    q = x @ p["wq"].to(dt)
    k = src @ p["wk"].to(dt)
    v = src @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    Sk = src.shape[1]
    q = sharding.splittable(q, -1, cfg.n_heads)
    k = sharding.splittable(k, -1, cfg.n_kv_heads)
    v = sharding.splittable(v, -1, cfg.n_kv_heads)
    q = constrain_any(q.reshape(B, S, cfg.n_heads, cfg.d_head),
                      [("batch", None, "heads", None),
                       ("batch", "act_seq", None, None)])
    k = constrain_any(k.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head),
                      [("batch", None, "kv", None),
                       ("batch", "act_seq", None, None)])
    v = constrain_any(v.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head),
                      [("batch", None, "kv", None),
                       ("batch", "act_seq", None, None)])
    return q, k, v


def update_slice(buf: torch.Tensor, upd: torch.Tensor,
                 start: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, upd, (0, start, ...))`` in place: the
    start is clamped so that the update fits, as XLA clamps it.  A DTensor
    ``buf`` is written on each rank's own shard: ``upd`` is laid out as
    ``buf`` is first, and a sequence sharded over ranks takes the rows
    that fall in each rank's range."""
    start = min(max(start, 0), buf.shape[1] - upd.shape[1])
    if sharding.is_dtensor(buf):
        upd = sharding.seq_replicated_like(upd, buf).to_local()
        local = buf.to_local()
        lo = sharding.local_offset(buf, 1)
        a = max(start, lo)
        b = min(start + upd.shape[1], lo + local.shape[1])
        if a < b:
            local[:, a - lo:b - lo] = upd[:, a - start:b - start]
        return buf
    buf[:, start:start + upd.shape[1]] = upd
    return buf


def ring_fill(buf: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """The ring ``buf`` (B, W, ...) filled in place with the last W rows
    of ``upd`` (B, S >= W, ...), row ``t`` at slot ``t % W``: the
    reference's ``zeros_like(buf).at[:, slots].set(upd[:, last])``, whose
    slots cover the ring.  A DTensor ``buf`` is written on each rank's own
    shard of its slots, as ``update_slice`` writes."""
    W, S = buf.shape[1], upd.shape[1]
    local, lo = buf, 0
    if sharding.is_dtensor(buf):
        upd = sharding.seq_replicated_like(upd, buf).to_local()
        local, lo = buf.to_local(), sharding.local_offset(buf, 1)
    ring = torch.roll(upd[:, S - W:], S % W, dims=1)
    local.copy_(ring[:, lo:lo + local.shape[1]])
    return buf


def attention_block(cfg, p: Params, x, positions, *, cache=None,
                    causal=True, window=0, kv_from=None):
    """Full attention block; returns (out, new_cache).

    cache layouts (decode), updated in place:
      full:  dict(k=(B,Smax,Hkv,Dh), v=..., idx=int) — global attention.
      ring:  same tensors with Smax == window — local attention keeps only
             the last ``window`` tokens; keys are stored *already roped* at
             their absolute positions, slot = pos % window.
    kv_from: cross-attention memory (B, Sm, d) — non-causal, no cache.
    """
    B, S, _ = x.shape
    dt = cfg.torch_dtype
    q, k, v = _qkv(cfg, p, x, kv_from)

    if kv_from is not None:
        out = sharding.pinned(_attend(q, k, v, causal=False)
                              .reshape(B, S, cfg.q_dim))
        return constrain(out @ p["wo"].to(dt), ("batch", None, None)), None

    new_cache = None
    if cache is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = _attend(q, k, v, causal=causal, window=window)
    else:
        idx = cache["idx"]
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        ring = window and Smax == window
        qpos = (idx + torch.arange(S, device=x.device))[None, :].expand(B, S)
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
        if ring:
            if S == 1:
                slot = idx % window
                update_slice(ck, k.to(dt), slot)
                update_slice(cv, v.to(dt), slot)
                out = _attend(q, ck, cv, causal=False,
                              kv_valid=min(idx + 1, window))
            else:
                # windowed prefill: compute without the cache, then stash
                # the last `window` roped K/V at their ring slots
                assert S >= window, "prefill shorter than window"
                out = _attend(q, k, v, causal=True, window=window,
                              q_offset=0)
                ring_fill(ck, k.to(dt))
                ring_fill(cv, v.to(dt))
        else:
            update_slice(ck, k.to(dt), idx)
            update_slice(cv, v.to(dt), idx)
            out = _attend(q, ck, cv, causal=True, window=window,
                          q_offset=idx, kv_valid=idx + S)
        new_cache = {"k": ck, "v": cv, "idx": idx + S}
    # heads merged back: where they were not split over ranks, the
    # gradient must come back whole along them (``sharding.pinned``)
    out = sharding.pinned(out.reshape(B, S, cfg.q_dim))
    # the MLP's output layout: the partial sums reduced, and the gradient
    # back through this product arrives with a whole sequence
    return constrain(out @ p["wo"].to(dt), ("batch", None, None)), new_cache


def cross_attention_cached(cfg, p: Params, x, ck, cv):
    """Cross-attention against precomputed (cached) memory K/V."""
    B, S, _ = x.shape
    dt = cfg.torch_dtype
    q = _whole_seq(x) @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = sharding.splittable(q, -1, cfg.n_heads)
    q = constrain_any(q.reshape(B, S, cfg.n_heads, cfg.d_head),
                      [("batch", None, "heads", None),
                       ("batch", "act_seq", None, None)])
    out = sharding.pinned(_attend(q, ck, cv, causal=False)
                          .reshape(B, S, cfg.q_dim))
    return constrain(out @ p["wo"].to(dt), ("batch", None, None))


def cross_kv(cfg, p: Params, memory):
    dt = cfg.torch_dtype
    B, Sm, _ = memory.shape
    memory = _whole_seq(memory)
    k = memory @ p["wk"].to(dt)
    v = memory @ p["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    k = sharding.splittable(k, -1, cfg.n_kv_heads)
    v = sharding.splittable(v, -1, cfg.n_kv_heads)
    return (k.reshape(B, Sm, cfg.n_kv_heads, cfg.d_head),
            v.reshape(B, Sm, cfg.n_kv_heads, cfg.d_head))


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and MoE
# ---------------------------------------------------------------------------

def mlp_params(cfg, gen: torch.Generator) -> Params:
    dt = cfg.torch_param_dtype
    return {
        "wg": _init(gen, (cfg.d_model, cfg.d_ff), dt),
        "wu": _init(gen, (cfg.d_model, cfg.d_ff), dt),
        "wd": _init(gen, (cfg.d_ff, cfg.d_model), dt,
                    scale=1.0 / math.sqrt(cfg.d_ff)),
    }


def mlp(cfg, p: Params, x):
    dt = cfg.torch_dtype
    x = _whole_seq(x)
    g = F.silu(constrain(x @ p["wg"].to(dt), ("batch", None, "mlp")))
    u = constrain(x @ p["wu"].to(dt), ("batch", None, "mlp"))
    return constrain((g * u) @ p["wd"].to(dt), ("batch", None, None))


def moe_params(cfg, gen: torch.Generator) -> Params:
    dt = cfg.torch_param_dtype
    E = cfg.n_experts
    return {
        "router": _init(gen, (cfg.d_model, E), dt),
        "wg": _init(gen, (E, cfg.d_model, cfg.d_ff), dt),
        "wu": _init(gen, (E, cfg.d_model, cfg.d_ff), dt),
        "wd": _init(gen, (E, cfg.d_ff, cfg.d_model), dt,
                    scale=1.0 / math.sqrt(cfg.d_ff)),
    }


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values (``torch.topk`` does
    not promise an order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(cfg, p: Params, x):
    """Top-k token-choice MoE with fixed expert capacity (dropping).

    Returns (out, aux_loss).  Tokens past an expert's capacity go to a
    scratch slot at index ``capacity`` and are weighted 0 on the way back.
    The scatters accumulate with ``index_put_``; on CUDA the order of the
    additions into one row is not fixed.  Over a mesh it runs per rank
    (``_moe_sharded``) and gives the one-device result for the whole
    batch."""
    if sharding.is_dtensor(x):
        return _moe_sharded(cfg, p, x)
    return _moe(cfg, p["router"], p["wg"], p["wu"], p["wd"], x)


def _moe(cfg, router, wg, wu, wd, x, e0: int = 0):
    """The MoE on plain tensors: every token of ``x`` is routed, and the
    experts ``e0``, ``e0 + 1``, ... that ``wg``/``wu``/``wd`` hold (all of
    them, or a rank's share, each perhaps a slice of the ff dim) compute
    their tokens.  Returns (out, aux): out sums only those experts' (and
    ff columns') contributions."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    dt = cfg.torch_dtype
    logits = (xt @ router.float().to(dt)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)  # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    flat_expert = expert_idx.reshape(-1)  # (T*K,)
    # (T*K, E): ``F.one_hot``'s values, by ops that run alike on real and
    # fake tensors (``one_hot`` checks its input's range on real ones)
    onehot = (flat_expert[:, None]
              == torch.arange(E, device=x.device)).long()
    # the counts of ``bincount``, in a shape that does not depend on the
    # data (the dry-run traces it)
    ce = onehot.sum(0).float() / (T * K)
    aux = E * torch.sum(me * ce)

    capacity = int(max(1, math.ceil(T * K * cfg.capacity_factor / E)))
    # position of each (token, k) within its expert's queue
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    pos = pos_in_expert.gather(1, flat_expert[:, None])[:, 0]  # (T*K,)
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity)  # overflow -> scratch slot
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    w = (gate_vals.reshape(-1) * keep).to(dt)
    n_local = wg.shape[0]
    if n_local < E:
        # a rank's experts: the other experts' (token, k) pairs go to
        # the scratch slot of expert 0 with weight 0, as dropped ones do
        # (a shape that does not depend on the routing: the dry-run
        # traces it)
        mine = (flat_expert >= e0) & (flat_expert < e0 + n_local)
        flat_expert = torch.where(mine, flat_expert - e0, 0)
        slot = torch.where(mine, slot, capacity)
        w = w * mine

    # dispatch: (E, capacity+1, D); scratch row absorbs dropped tokens
    buf = torch.zeros((n_local, capacity + 1, D), dtype=dt, device=x.device)
    buf.index_put_((flat_expert, slot), xt[tok_idx].to(dt), accumulate=True)
    buf = constrain(buf, ("expert", None, None))

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, wu.to(dt))
    y = torch.einsum("ecf,efd->ecd", h * u, wd.to(dt))

    # combine
    gathered = y[flat_expert, slot]  # (T*K, D)
    out = torch.zeros((T, D), dtype=dt, device=x.device).index_put_(
        (tok_idx,), gathered * w[:, None], accumulate=True)
    return out.reshape(B, S, D), aux


def _moe_sharded(cfg, p: Params, x):
    """``_moe`` over a mesh, per rank under ``local_map``, with the
    reference's global semantics: every rank routes the whole batch
    (gathered), so capacity, queue positions and the aux loss's means are
    the batch's, and computes only its experts ('expert' over 'model',
    the reference's ``("expert", None, None)`` buffer) and, under
    ``tp_ep``, its slice of their ff dim ('mlp' over 'data').  The output
    is the sum over the mesh dims that split them (a ``Partial``, reduced
    by the caller's constraint), and their gradients with respect to the
    tokens and the router are partial sums the same way.  The aux loss,
    the same on every rank, is counted once: by the rank at coordinate 0
    of those dims."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    # the rules split the three alike: experts over 'model', their ff
    # columns over 'data' under tp_ep; a rank computes with their 'embed'
    # dim whole (tp_fsdp splits it over 'data' where the layers stay
    # whole), so it is gathered here and its gradient comes back whole
    w_pl = [sharding._whole_along(w.placements, d)
            for w, d in ((wg, 1), (wu, 1), (wd, 2))]
    split = [pl.is_shard() for pl in w_pl[0]]
    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if s else Replicate() for s in split)
    e0 = sharding.local_offset(wg, 0)
    coord = mesh.get_coordinate()
    lead = all(c == 0 for c, s in zip(coord, split) if s)

    def per_rank(xf, router, wg, wu, wd):
        out, aux = _moe(cfg, router, wg, wu, wd, xf, e0)
        return out, aux if lead else aux * 0.0

    fn = local_map(per_rank, out_placements=(summed, summed),
                   in_placements=(whole, whole, *w_pl),
                   in_grad_placements=(summed, summed, *w_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    out, aux = fn(x, p["router"], wg, wu, wd)
    return (constrain(out, ("batch", None, None)),
            aux.redistribute(mesh, whole))


def embedding_params(cfg, gen: torch.Generator) -> Params:
    return {"tok": _init(gen, (cfg.vocab, cfg.d_model),
                         cfg.torch_param_dtype, scale=1.0)}
