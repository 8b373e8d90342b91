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
from typing import Dict, NamedTuple, Optional, Tuple

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


class _Cfg(NamedTuple):
    """What the chunked attention needs besides its tensors: masking,
    chunks, where q chunk ``qi`` starts (``q_offset + qi * q_step``: rows
    of one chunk are contiguous, chunks ``q_step`` apart), where k[0]
    lies (``k_offset``) and the keys at or past ``kv_valid`` masked, all
    in absolute positions."""
    causal: bool
    window: int
    q_chunk: int
    kv_chunk: int
    q_offset: int
    kv_valid: int
    q_step: int
    k_offset: int = 0


def _chunk_online(q, k, v, cfgt, qi, scale):
    """q chunk ``qi``'s running (m, l, acc), f32, of the streaming softmax
    over every block of ``k``/``v`` it sees, scores scaled by ``scale``:
    m, l (B, Hkv, rep, q_chunk), acc (B, Hkv, rep, q_chunk, Dh)."""
    causal, window, q_chunk, kv_chunk, q_offset, kv_valid, q_step, k0 = cfgt
    B, _, Hkv, rep, Dh = q.shape
    nk = k.shape[1] // kv_chunk
    dev = q.device
    q_lo = q_offset + qi * q_step
    q_pos = q_lo + torch.arange(q_chunk, device=dev)
    qb = (q[:, qi * q_chunk:(qi + 1) * q_chunk] * scale).float()
    m = torch.full((B, Hkv, rep, q_chunk), -math.inf, device=dev)
    l = torch.zeros((B, Hkv, rep, q_chunk), device=dev)
    acc = torch.zeros((B, Hkv, rep, q_chunk, Dh), device=dev)
    for ci in range(nk):
        k_lo = ci * kv_chunk
        if _chunk_masked(causal, window, q_lo, q_lo + q_chunk - 1, k0 + k_lo,
                         k0 + k_lo + kv_chunk - 1, kv_valid):
            continue
        kblk = k[:, k_lo:k_lo + kv_chunk].float()
        vblk = v[:, k_lo:k_lo + kv_chunk]
        k_pos = k0 + k_lo + torch.arange(kv_chunk, device=dev)
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
    return m, l, acc


def _flash_fwd(q, k, v, cfgt):
    """The forward over padded, grouped ``q`` (B, Sqp, Hkv, rep, Dh) and
    ``k``/``v`` (B, Skp, Hkv, Dh): (out like ``q``, lse (B, Hkv, rep, Sqp)
    f32), the reference's ``_flash_fwd_impl``."""
    scale = weak_scalar(1.0 / math.sqrt(q.shape[-1]), q.dtype)
    outs, lses = [], []
    for qi in range(q.shape[1] // cfgt.q_chunk):
        m, l, acc = _chunk_online(q, k, v, cfgt, qi, scale)
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
    causal, window, q_chunk, kv_chunk, q_offset, kv_valid, q_step, k0 = cfgt
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
        q_lo = q_offset + qi * q_step
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        qblk = q[:, rows]
        qb = (qblk * q_scale).float()
        qf = qblk.float()
        dob = dout[:, rows].to(dt).float()
        lse_b, delta_b = lse[..., rows, None], delta[..., rows, None]
        dq = torch.zeros(qblk.shape, device=dev)
        for ci in range(nk):
            k_lo = ci * kv_chunk
            if _chunk_masked(causal, window, q_lo, q_lo + q_chunk - 1,
                             k0 + k_lo, k0 + k_lo + kv_chunk - 1, kv_valid):
                continue
            cols = slice(k_lo, k_lo + kv_chunk)
            kblk, vblk = k[:, cols].float(), v[:, cols].float()
            k_pos = k0 + k_lo + torch.arange(kv_chunk, device=dev)
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


def _grouped(q, k, v, *, causal, window, q_offset, q_chunk, kv_chunk,
             kv_valid, q_step=None, k_offset=0):
    """``q``, ``k``, ``v`` padded to whole chunks, ``q`` grouped as
    (B, Sqp, Hkv, rep, Dh), and their ``_Cfg``."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
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
    qg = q.reshape(B, nq * q_chunk, Hkv, Hq // Hkv, Dh)
    cfgt = _Cfg(bool(causal), int(window), q_chunk, kv_chunk, int(q_offset),
                k_offset + Sk if kv_valid is None else int(kv_valid),
                q_chunk if q_step is None else int(q_step), int(k_offset))
    return qg, k, v, cfgt


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 512, kv_valid: Optional[int] = None,
                    q_step: Optional[int] = None):
    """Streaming softmax attention, chunked over q and kv, with the
    reference's manual flash backward (``_Flash``).

    q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh).  GQA: Hq % Hkv == 0.
    ``q_offset`` is the absolute position of q[0] relative to k[0] (decode
    with a cache passes the fill index); keys at or past ``kv_valid``
    (default Sk) are masked.  ``q_step`` (default ``q_chunk``) is the
    distance in positions between the first rows of consecutive q chunks:
    a rank's share of the rows of every chunk (``_own_rows``) passes its
    rows' chunk and the whole chunk's length.  Scores and the running
    (m, l, acc) are f32, p is cast to q's dtype before P.V; masked scores
    are -1e30, m starts at -inf, l is floored at 1e-30.  Where no gradient
    is wanted (serving runs under ``no_grad``) the forward runs alone and
    keeps nothing for a backward.  Returns (B, Sq, Hq, Dh).
    """
    B, Sq, Hq, Dh = q.shape
    qg, k, v, cfgt = _grouped(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, kv_valid=kv_valid,
                              q_step=q_step)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _Flash.apply(qg, k, v, cfgt)
    else:
        out = _flash_fwd(qg, k, v, cfgt)[0]
    return out.reshape(B, qg.shape[1], Hq, Dh)[:, :Sq]


def _attend(q, k, v, **kw):
    """``flash_attention(q, k, v, **kw)``.  On DTensors it runs per rank
    under ``local_map``, on the layouts of ``sharding.attention_pspecs``:
    attention is independent per (batch, head) and per q row, so each
    rank's result is exact, and a sequence sharded by ``act_seq`` is
    gathered first.  Where q's heads are split and k/v's are whole, a
    rank attends with the one kv head its q heads read, and the gradient
    of k/v is a sum over the ranks that split the heads.  Where neither
    splits but each kv head can go to 2 ranks (``sharding.kv_group``), a
    rank attends with its kv head and that head's q heads, and the output
    is the sum over the heads' axes of each rank's share (``_kv_group``).
    Where the q heads are not split (``sharding.heads_split`` names the
    mesh dims that would split them), the ranks of those dims split the
    work instead: for a step of more than one row, the rows of every q
    chunk, as the reference's chunk constraint splits them (a kv group
    over its pair of ranks), padded to whole chunks split evenly as the
    reference pads them; in train each rank its share, zeros on the
    others' rows, the output and the gradients of q, k and v summed over
    those dims (``_own_rows``, ``_kv_group``); in a prefill each rank's
    share gathered in order (``_rows_gathered``).  For one new token (a
    decode step), the keys (``_split_keys``: each rank its slice of the
    cache's slots, the softmax's partial sums merged by collectives),
    where the extent divides the slots.  On a mesh of extent 1 there is
    no split."""
    if not sharding.is_dtensor(q):
        return flash_attention(q, k, v, **kw)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qs, kvs = sharding.attention_pspecs(q.shape, k.shape)
    qp, kvp = sharding.placements(qs, mesh), sharding.placements(kvs, mesh)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    fn, q_grad, kv_grad, out_pl = (functools.partial(flash_attention, **kw),
                                   qp, kvp, qp)
    if qs[2] is None:
        group = sharding.kv_group(q.shape, k.shape)
        dims, n, part = (group[0], group[1], group[3]) if group else \
            sharding.heads_split()
        rows = n > 1 and q.shape[1] > 1
        summed = [tuple(Partial() if i in dims else p for i, p in
                        enumerate(pl)) for pl in (qp, kvp)]
        if rows and not grad:
            # a prefill: each rank's rows, gathered in order (the
            # reference's compile moves its split rows before ``wo``)
            groups = k.shape[2] if group else 1
            fn = functools.partial(
                _rows_gathered, groups=groups, j=group[2] if group else 0,
                part=part, parts=n,
                group=sharding._group(mesh, dims), **kw)
        elif group is not None:
            fn = functools.partial(_kv_group, j=group[2],
                                   rep=q.shape[2] // k.shape[2], c=n,
                                   part=part, rows=rows, **kw)
            q_grad, kv_grad, out_pl = summed[0], summed[1], summed[0]
        elif rows:
            fn = functools.partial(_own_rows, part=part, parts=n, **kw)
            q_grad, kv_grad, out_pl = summed[0], summed[1], summed[0]
        elif (dims and not grad and q.shape[1] == 1
              and k.shape[1] % n == 0):
            kvp = tuple(Shard(1) if i in dims else p
                        for i, p in enumerate(kvp))
            fn = functools.partial(
                _split_keys, lo=part * (k.shape[1] // n),
                group=sharding._group(mesh, dims), **kw)
    elif kvs[2] is None:
        rep = q.shape[2] // k.shape[2]
        j = sharding.local_index(qp, mesh, q.shape)[2].start // rep
        kv_grad = tuple(Partial() if p.is_shard(2) else kp
                        for p, kp in zip(qp, kvp))
        fn = functools.partial(_one_kv_head, j=j, **kw)
    core = local_map(fn, out_placements=list(out_pl),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(q_grad, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)
    return sharding._moved(core(q, k, v), qp)


def _share(q, k, v, *, part: int, parts: int, q_chunk: int = 512,
           q_offset: int = 0, **kw):
    """The attention of share ``part`` of ``parts`` of the rows of every q
    chunk: rows ``part * sub + [0, sub)`` of each chunk of ``q_chunk``
    (sub = q_chunk / parts, rounded up), the reference's split of each
    chunk's rows over 'model' (its ``qcs`` constraint).  ``q`` is padded
    with zero rows to whole chunks, and each chunk to ``parts * sub``
    rows, as the reference pads ``q`` and GSPMD the split dim; the padded
    rows are computed, for the caller to drop.  ``_chunk_masked`` skips
    the blocks that none of the share's rows sees.  Returns (the share's
    rows (B, nq * sub, H, Dh), (nq, sub, q_chunk))."""
    B, Sq, H, Dh = q.shape
    q_chunk = min(q_chunk, Sq)
    nq, sub = -(-Sq // q_chunk), -(-q_chunk // parts)
    lo = part * sub
    chunks = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq)).reshape(
        B, nq, q_chunk, H, Dh)
    mine = F.pad(chunks, (0, 0, 0, 0, 0, parts * sub - q_chunk))[
        :, :, lo:lo + sub].reshape(B, nq * sub, H, Dh)
    out = flash_attention(mine, k, v, q_chunk=sub, q_step=q_chunk,
                          q_offset=q_offset + lo, **kw)
    return out, (nq, sub, q_chunk)


def _own_rows(q, k, v, *, part: int, parts: int, **kw):
    """``_share``'s rows in place, zeros on the other rows and on the
    padding.  Summed over the shares, each row counts once, exactly (x + 0
    is x); only the share's rows reach its gradient of ``q``."""
    B, Sq, H, Dh = q.shape
    out, (nq, sub, q_chunk) = _share(q, k, v, part=part, parts=parts, **kw)
    out = F.pad(out.reshape(B, nq, sub, H, Dh),
                (0, 0, 0, 0, part * sub, (parts - part - 1) * sub))
    return out[:, :, :q_chunk].reshape(B, nq * q_chunk, H, Dh)[:, :Sq]


def _rows_gathered(q, k, v, *, groups: int, j: int, part: int, parts: int,
                   group, **kw):
    """No gradient (a prefill): kv group ``j`` of ``groups`` (its kv heads
    and their q heads; one group is every head) on share ``part`` of
    ``parts`` of the rows of every q chunk (``_share``), all-gathered over
    ``group``, whose ranks are ordered (kv group, share), and put back in
    the order of the rows and heads, the padding dropped.  Every rank ends
    with the whole output, having sent only its share: the reference's
    compile moves the split rows so (an all-to-all before ``wo``), where
    a zero-filled output summed over the ranks would move all of it from
    each."""
    import torch.distributed._functional_collectives as funcol

    B, Sq, Hq, Dh = q.shape
    hq, hk = Hq // groups, k.shape[2] // groups
    out, (nq, sub, q_chunk) = _share(
        q[:, :, j * hq:(j + 1) * hq], k[:, :, j * hk:(j + 1) * hk],
        v[:, :, j * hk:(j + 1) * hk], part=part, parts=parts, **kw)
    # ``all_gather_single`` is ``all_gather_tensor``'s newer name
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    whole = gather(out.contiguous(), 0, group).reshape(
        groups, parts, B, nq, sub, hq, Dh).permute(2, 3, 1, 4, 0, 5, 6)
    whole = whole.reshape(B, nq, parts * sub, Hq, Dh)[:, :, :q_chunk]
    return whole.reshape(B, nq * q_chunk, Hq, Dh)[:, :Sq]


def _split_keys(q, k, v, *, lo: int, group, causal: bool, window: int = 0,
                q_offset: int = 0, q_chunk: int = 512, kv_chunk: int = 512,
                kv_valid: Optional[int] = None):
    """``flash_attention`` of all of ``q`` against this rank's slice of the
    keys, ``k``/``v`` holding slots ``lo + [0, Sk)`` of the whole (split-K):
    each key masked by its slot (``kv_valid`` counts the whole's), this
    slice's running (m, l, acc) in f32, merged with the other slices' by
    the online softmax's own rule over ``group``: the max of m, then the
    sums of l and acc, each rescaled by exp(m - max).  A slice that every
    row's mask hides (m = -inf, l = 0) adds 0.  No gradient: a decode
    step's."""
    import torch.distributed._functional_collectives as funcol

    B, Sq, Hq, Dh = q.shape
    Sk = k.shape[1]
    valid = lo + Sk if kv_valid is None else min(int(kv_valid), lo + Sk)
    qg, k, v, cfgt = _grouped(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, kv_valid=valid, k_offset=lo)
    scale = weak_scalar(1.0 / math.sqrt(Dh), q.dtype)
    parts = [_chunk_online(qg, k, v, cfgt, qi, scale)
             for qi in range(qg.shape[1] // cfgt.q_chunk)]
    m, l, acc = (torch.cat([p[i] for p in parts], dim=3) for i in range(3))
    top = torch.clamp_min(funcol.all_reduce(m, "max", group), -1e30)
    w = torch.exp(m - top)
    l = funcol.all_reduce(l * w, "sum", group)
    acc = funcol.all_reduce(acc * w[..., None], "sum", group)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, qg.shape[1], Hq, Dh)[:, :Sq]


def _one_kv_head(q, k, v, *, j: int, **kw):
    """``flash_attention`` of a rank's q heads with the kv head ``j`` of
    the whole k/v, the one they all read."""
    return flash_attention(q, k[:, :, j:j + 1], v[:, :, j:j + 1], **kw)


def _kv_group(q, k, v, *, j: int, rep: int, c: int, part: int, rows: bool,
              **kw):
    """A rank's share where ``c`` ranks share each kv head: its kv head
    ``j`` with that head's ``rep`` q heads, zeros on the other heads.
    With ``rows`` (a step of more than one row: train or prefill), its
    share ``part`` of the rows of every q chunk (``_own_rows``), zeros on
    the others'; else (one row, a decode step) that row, scaled by 1/c.
    Summed over the ranks each group counts once,
    exactly (``sharding.kv_group`` gives c = 2: x/2 + x/2 is x, and both
    ranks of a group compute the same)."""
    lo = j * rep
    qj, kj, vj = q[:, :, lo:lo + rep], k[:, :, j:j + 1], v[:, :, j:j + 1]
    if rows:
        out = _own_rows(qj, kj, vj, part=part, parts=c, **kw)
    else:
        out = flash_attention(qj, kj, vj, **kw) / c
    return F.pad(out, (0, 0, lo, q.shape[2] - lo - rep))


def _whole_seq(x):
    """``x`` (B, S, d) with its sequence whole on every rank before a
    projection: the all-gather that ends sequence parallelism (GSPMD
    inserts it for the reference), so a product never flattens a split
    sequence into its rows.  A plain tensor is ``x`` itself."""
    return constrain(x, ("batch", None, None))


def _rows_weight(w, dim: int, dt, rows=None):
    """The weight ``w`` for a product with the activations ``rows``, its
    'embed' dim ``dim`` gathered (in the parameter's dtype) where
    ``tp_fsdp`` splits it over the axis that splits the rows, or with no
    ``rows`` wherever it is split (``sharding.whole_along``), cast to
    ``dt``."""
    return sharding.whole_along(w, dim, rows).to(dt)


def _qkv(cfg, p: Params, x, src):
    B, S, _ = x.shape
    dt = cfg.torch_dtype
    x = _whole_seq(x)
    src = x if src is None else _whole_seq(src)
    q = x @ _rows_weight(p["wq"], 0, dt, x)
    k = src @ _rows_weight(p["wk"], 0, dt, src)
    v = src @ _rows_weight(p["wv"], 0, dt, src)
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


def _out_proj(out, wo, dt):
    """``out @ wo`` laid out as the MLP's output: the partial sums reduced,
    and the gradient back through this product arrives with a whole
    sequence.  Where a gradient flows and ``out`` is whole along the
    merged heads, each rank takes its own rows of ``wo`` first
    (``sharding.split_as_rows_of``), so it forms only those rows' weight
    gradient; its 'embed' is gathered first (``_rows_weight``)."""
    wo = _rows_weight(wo, 1, dt, out)
    out = sharding.split_as_rows_of(out, wo)
    return constrain(out @ wo, ("batch", None, None))


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
        return _out_proj(out, p["wo"], dt), None

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
    return _out_proj(out, p["wo"], dt), new_cache


def cross_attention_cached(cfg, p: Params, x, ck, cv):
    """Cross-attention against precomputed (cached) memory K/V."""
    B, S, _ = x.shape
    dt = cfg.torch_dtype
    x = _whole_seq(x)
    q = x @ _rows_weight(p["wq"], 0, dt, x)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = sharding.splittable(q, -1, cfg.n_heads)
    q = constrain_any(q.reshape(B, S, cfg.n_heads, cfg.d_head),
                      [("batch", None, "heads", None),
                       ("batch", "act_seq", None, None)])
    out = sharding.pinned(_attend(q, ck, cv, causal=False)
                          .reshape(B, S, cfg.q_dim))
    return _out_proj(out, p["wo"], dt)


def cross_kv(cfg, p: Params, memory):
    dt = cfg.torch_dtype
    B, Sm, _ = memory.shape
    memory = _whole_seq(memory)
    k = memory @ _rows_weight(p["wk"], 0, dt, memory)
    v = memory @ _rows_weight(p["wv"], 0, dt, memory)
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
    """SwiGLU.  Under ``tp_fsdp`` the weights' 'embed' (split over 'data'
    where the stack keeps its layers whole) is laid out as the reference's
    compile lays it out: gathered for rows that 'data' splits, and for
    ``wd`` always, since its output is constrained whole along d (for a
    batch of one, ``wg`` and ``wu`` contract their split instead)."""
    dt = cfg.torch_dtype
    x = _whole_seq(x)
    g = F.silu(constrain(x @ _rows_weight(p["wg"], 0, dt, x),
                         ("batch", None, "mlp")))
    u = constrain(x @ _rows_weight(p["wu"], 0, dt, x),
                  ("batch", None, "mlp"))
    return constrain((g * u) @ _rows_weight(p["wd"], 1, dt),
                     ("batch", None, None))


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
    """``_moe`` over a mesh with the reference's global semantics (the
    capacity, the queue positions and the aux loss's means are the whole
    batch's), each rank keeping its own rows: it routes its rows
    (``local_map``), gathers only the chosen experts' ids of the batch
    (ints) to place every (token, k) in its expert's queue, scatters its
    rows' tokens into the buffer of its experts ('expert' over 'model',
    the reference's ``("expert", None, None)`` buffer), and the partial
    buffers are summed over the mesh dims that split the rows (each slot
    holds one token).  The experts compute on the whole buffer (under
    ``tp_ep`` their slice of the ff dim, 'mlp' over 'data', whose partial
    sums are reduced), and each rank combines its rows from its experts:
    the output is the sum over the experts' mesh dims (a ``Partial``,
    reduced by the caller's constraint).  So no rank holds the batch's
    tokens or the (token, k) pairs' rows, which the reference's XLA never
    materializes either.  The aux loss is computed alike on every rank
    from the reduced means and the gathered counts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = cfg.torch_dtype
    capacity = int(max(1, math.ceil(T * K * cfg.capacity_factor / E)))
    x = _whole_seq(x)
    rows = tuple(pl if pl.is_shard(0) else Replicate() for pl in x.placements)
    whole = (Replicate(),) * mesh.ndim
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    # the rules split the three alike: experts over 'model', their ff
    # columns over 'data' under tp_ep; a rank computes with their 'embed'
    # dim whole (tp_fsdp splits it over 'data' where the layers stay
    # whole), so it is gathered here and its gradient comes back whole
    w_pl = [sharding._whole_along(w.placements, d)
            for w, d in ((wg, 1), (wu, 1), (wd, 2))]
    experts = [pl.is_shard(0) for pl in w_pl[0]]
    ff = [pl.is_shard(2) for pl in w_pl[0]]
    by_expert = tuple(Shard(0) if e else Replicate() for e in experts)

    def route(xl, router):
        xt = xl.reshape(-1, D)
        probs = torch.softmax((xt @ router.float().to(dt)).float(), dim=-1)
        gate_vals, expert_idx = top_k(probs, K)
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
        shape = xl.shape[:2]
        return (probs.reshape(*shape, E), gate_vals.reshape(*shape, K),
                expert_idx.reshape(*shape, K))

    probs, gate_vals, expert_idx = local_map(
        route, out_placements=(rows, rows, rows), in_placements=(rows, whole),
        in_grad_placements=(rows, sharding.summed_where_split(whole, rows)),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])

    # every (token, k)'s place in its expert's queue, in the batch's order
    flat = sharding._moved(expert_idx, whole).to_local().reshape(-1)
    onehot = (flat[:, None] == torch.arange(E, device=flat.device)).long()
    ce = onehot.sum(0).float() / (T * K)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0].reshape(B, S, K)
    mine_rows = sharding.local_index(rows, mesh, (B, S, K))[0]
    pos, fe = pos[mine_rows], flat.reshape(B, S, K)[mine_rows]
    keep = pos < capacity
    e0 = sharding.local_offset(wg, 0)
    n_local = wg.to_local().shape[0]
    # another rank's experts' pairs go to the scratch slot of expert 0
    # with weight 0, as dropped ones do (a shape that does not depend on
    # the routing: the dry-run traces it)
    mine = (fe >= e0) & (fe < e0 + n_local)
    fe = torch.where(mine, fe - e0, 0)
    slot = torch.where(mine & keep, pos, capacity)
    weight = keep & mine

    def dispatch(xl):
        xt = xl.reshape(-1, D).to(dt)
        buf = torch.zeros((n_local, capacity + 1, D), dtype=dt,
                          device=xl.device)
        for k in range(K):
            buf.index_put_((fe[..., k].reshape(-1), slot[..., k].reshape(-1)),
                           xt, accumulate=True)
        return (buf,)

    summed_rows = tuple(Shard(0) if e else (Partial() if r.is_shard() else
                                            Replicate())
                        for e, r in zip(experts, rows))
    buf = local_map(
        dispatch, out_placements=(summed_rows,), in_placements=(rows,),
        in_grad_placements=(tuple(Partial() if e else r
                                  for e, r in zip(experts, rows)),),
        device_mesh=mesh, redistribute_inputs=True)(x)[0]
    buf = sharding._moved(buf, by_expert)

    def compute(b, wg, wu, wd):
        h = F.silu(torch.einsum("ecd,edf->ecf", b, wg.to(dt)))
        u = torch.einsum("ecd,edf->ecf", b, wu.to(dt))
        return (torch.einsum("ecf,efd->ecd", h * u, wd.to(dt)),)

    summed_ff = tuple(Partial() if f else pl for f, pl in zip(ff, by_expert))
    y = local_map(compute, out_placements=(summed_ff,),
                  in_placements=(by_expert, *w_pl),
                  in_grad_placements=(summed_ff, *w_pl),
                  device_mesh=mesh, redistribute_inputs=True)(buf, wg, wu, wd)[0]
    y = sharding._moved(y, by_expert)

    def combine(yl, gl):
        w = (gl * weight).to(dt).reshape(-1, K)
        out = None
        for k in range(K):
            term = yl[fe[..., k].reshape(-1), slot[..., k].reshape(-1)] \
                * w[:, k:k + 1]
            out = term if out is None else out + term
        return (out.reshape(*gl.shape[:2], D),)

    out_pl = tuple(r if r.is_shard() else (Partial() if e else Replicate())
                   for e, r in zip(experts, rows))
    out = local_map(
        combine, out_placements=(out_pl,), in_placements=(by_expert, rows),
        in_grad_placements=(tuple(Partial() if r.is_shard() else pl
                                  for r, pl in zip(rows, by_expert)),
                            tuple(Partial() if e else r
                                  for e, r in zip(experts, rows))),
        device_mesh=mesh, redistribute_inputs=True)(y, gate_vals)[0]

    # load-balancing aux loss (Switch-style): the batch's means, from the
    # sums of the ranks' rows where a mesh dim splits them
    if any(r.is_shard() for r in rows):
        me = sharding._moved(probs.sum((0, 1)), whole) / T
    else:
        me = probs.reshape(T, E).mean(0)
    aux = E * torch.sum(me * ce)
    return constrain(out, ("batch", None, None)), aux


def embedding_params(cfg, gen: torch.Generator) -> Params:
    return {"tok": _init(gen, (cfg.vocab, cfg.d_model),
                         cfg.torch_param_dtype, scale=1.0)}
