"""Tiled matmul: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_matmul_kernel`` (``matmul_pallas`` in
``repro/kernels/matmul.py``).  ``matmul_cuda`` launches
``csrc/matmul.cu``; ``matmul_plain`` repeats its arithmetic (an f32
accumulator, one f32 product per ``bk`` step, added in order, cast back to
the input dtype) and serves the CPU and the on-card comparison.
"""
from __future__ import annotations

import torch

from ..core.autotile import SMEM_BYTES, smem_footprint
from . import build
from .ref import _no_tf32

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bk: int, bn: int):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(f"matmul takes two f32 or two bf16 tensors, got "
                        f"{a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    if min(bm, bk, bn) < 1 or M % bm or K % bk or N % bn:
        raise ValueError(f"tiles {(bm, bk, bn)} must divide {(M, K, N)}")
    return M, K, N


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int, bk: int,
                 bn: int) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N); tile dims must divide the shapes."""
    M, K, N = _check(a, b, bm, bk, bn)
    _no_tf32(a)
    acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int, bk: int,
                bn: int) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on CUDA tensors; raises on anything else."""
    M, K, N = _check(a, b, bm, bk, bn)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul_cuda takes two tensors on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes contiguous row-major tensors")
    need = smem_footprint(bm, bk, bn, a.element_size())
    if need > SMEM_BYTES:
        raise ValueError(f"tile {(bm, bk, bn)} needs {need} B of shared "
                         f"memory, over the {SMEM_BYTES} B a block may use")
    z = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(build.lib().tcm_matmul_launch(
            a.data_ptr(), b.data_ptr(), z.data_ptr(), M, K, N, bm, bk, bn,
            DTYPE_CODES[a.dtype], stream), "matmul")
    matmul_cuda.launches += 1
    return z


matmul_cuda.launches = 0
