"""Public wrappers for the kernels, dispatched on the tensors' device.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises — there is no fallback from one
to the other.  ``tcm_matmul`` asks the TCM mapper for the SMEM tiling of
its shape (memoized), so the paper's search drives the kernel schedule.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.autotile import tcm_matmul_tiles
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .matmul import matmul_cuda, matmul_plain


def _on_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got "
                     f"{sorted(kinds)}")


def _pad_to(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % m
    if not pad:
        return x
    widths = [0, 0] * x.ndim  # F.pad lists the last axis first
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def tcm_matmul(a: torch.Tensor, b: torch.Tensor,
               tiles: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """TCM-autotiled matmul.  Shapes are padded to the tile grid; ``tiles``
    overrides the mapper's (bm, bk, bn)."""
    M, K = a.shape
    N = b.shape[1]
    bm, bk, bn = tiles or tcm_matmul_tiles(M, K, N,
                                           word_bytes=a.element_size())
    ap = _pad_to(_pad_to(a, bm, 0), bk, 1)
    bp = _pad_to(_pad_to(b, bk, 0), bn, 1)
    fn = matmul_plain if _on_cpu(a, b) else matmul_cuda
    return fn(ap, bp, bm=bm, bk=bk, bn=bn)[:M, :N]


def flash_attention_op(q, k, v, causal: bool = True, bq: int = 64,
                       bk: int = 64) -> torch.Tensor:
    """Attention forward; q: (B,Sq,Hq,Dh), k/v: (B,Sk,Hkv,Dh).  The default
    64x64 tiles fit shared memory for every supported Dh and dtype."""
    fn = flash_attention_plain if _on_cpu(q, k, v) else flash_attention_cuda
    return fn(q, k, v, causal=causal, bq=bq, bk=bk)
