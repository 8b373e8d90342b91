"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``_fa_kernel`` (``flash_attention_pallas``
in ``repro/kernels/flash_attention.py``) with the same conventions (see
``csrc/flash_attention.cu``).  ``flash_attention_cuda`` launches the
kernel: bf16 on tensor cores from a 16-row q tile up, bf16 on the decode
path below that, f32 on the SIMT route.  ``flash_attention_plain`` repeats
its online softmax in PyTorch, one kv tile of ``bk`` keys at a time, and
serves the CPU and the on-card comparison.  Both take the
``(B, S, H, Dh)`` layout as it is, and both take ragged ``Sq``/``Sk``
(``Sq = 1`` decode included), which the TPU kernel's divisibility assert
did not.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.autotile import FA_MMA_BK, FA_MMA_BQ_MAX, SMEM_BYTES, _round4
from . import build
from .matmul import DTYPE_CODES
from .ref import _no_tf32

HEAD_DIMS = (32, 64, 128)
DECODE_THREADS = 256  # threads of one decode-path block


def smem_footprint(bq: int, bk: int, dh: int, in_bytes: int) -> int:
    """Shared memory one block of the kernel asks for.

    bf16 tensor-core path (bq >= 16): the q tile and a double-buffered k
    and v tile, rows padded by 8 elements.  bf16 decode path (bq < 16):
    the kv tile's f32 scores, one f32 per warp for the block reductions and
    the f32 P V partial sums of every key group.  f32: the scaled q tile,
    scores and accumulator, three row vectors (m, l, corr) and the k and v
    tiles, all f32, extents rounded up to 4.
    """
    if in_bytes == 2 and bq >= 16:
        return 2 * (dh + 8) * (bq + 4 * bk)
    if in_bytes == 2:
        return 4 * (bk + DECODE_THREADS // 32 + DECODE_THREADS * 8)
    q4, k4 = _round4(bq), _round4(bk)
    return 4 * (dh * q4 + k4 * q4 + q4 * dh + 3 * q4 + 2 * k4 * dh)


def kernel_takes(bq: int, bk: int, dh: int, in_bytes: int) -> bool:
    """Whether the attention kernel of this dtype launches at (bq, bk):
    the tensor-core path wants bq a multiple of 16 up to
    ``FA_MMA_BQ_MAX`` and bk in ``FA_MMA_BK``; every path wants its shared
    memory to fit.  ``core.autotile.attention_tile`` maps a plan here."""
    if (in_bytes == 2 and bq >= 16
            and (bq % 16 or bq > FA_MMA_BQ_MAX or bk not in FA_MMA_BK)):
        return False
    return min(bq, bk) >= 1 and smem_footprint(bq, bk, dh,
                                               in_bytes) <= SMEM_BYTES


def _check(q, k, v, bq: int, bk: int):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or Hq % Hkv:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"attention takes f32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles must be positive, got {(bq, bk)}")
    return B, Sq, Sk, Hq, Hkv, Dh


def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 64,
                          bk: int = 64) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh).

    Every query row walks the kv tiles in order.  The kernel skips causal
    tiles wholly above a q tile; here they are visited and add exactly
    nothing (p = 0, corr = 1), so ``bq`` changes no value.
    """
    B, Sq, Sk, Hq, Hkv, Dh = _check(q, k, v, bq, bk)
    _no_tf32(q)
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qf = q.transpose(1, 2).float() * scale  # (B, Hq, Sq, Dh)
    kf = k.transpose(1, 2).repeat_interleave(rep, dim=1).float()
    vh = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    m = torch.full((B, Hq, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, Dh), device=q.device)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, Sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            k_pos = torch.arange(k0, min(k0 + bk, Sk), device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos, s,
                            torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vh[:, :, k0:k0 + bk].float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True, bq: int = 64,
                         bk: int = 64) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors; raises on
    anything else."""
    B, Sq, Sk, Hq, Hkv, Dh = _check(q, k, v, bq, bk)
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda takes q/k/v on one CUDA device")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q/k/v need unit stride over the head dim")
    if not kernel_takes(bq, bk, Dh, q.element_size()):
        raise ValueError(f"the {q.dtype} kernel does not take tiles "
                         f"{(bq, bk)} at Dh={Dh}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("bf16 q/k/v rows must be 16-byte aligned")
    o = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=q.device)
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(build.lib().tcm_flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
            Hq, Hkv, Dh, *strides, int(causal), bq, bk, 1.0 / math.sqrt(Dh),
            DTYPE_CODES[q.dtype], stream), "flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
