"""Tiled matmul: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_matmul_kernel`` (``matmul_pallas`` in
``repro/kernels/matmul.py``).  ``matmul_cuda`` launches ``csrc/matmul.cu``:
bf16 through its TMA + ``wgmma`` route, f32 through its SIMT route.
``matmul_plain`` repeats the arithmetic (an f32 accumulator, one f32
product per ``bk`` step, added in order, cast back to the input dtype) and
serves the CPU and the on-card comparison.
"""
from __future__ import annotations

import torch

from ..core.autotile import SMEM_BYTES, kernel_takes, smem_footprint
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


def wgmma_instance(bm: int, bn: int) -> int:
    """The bf16 kernel instance that runs a (bm, bn) tile, as an index below
    :func:`wgmma_instances`; -1 for a tile no instance runs.  The launcher
    in ``csrc/matmul.cu`` makes the choice; this asks the built library."""
    return build.lib().tcm_matmul_bf16_instance(bm, bn)


def wgmma_instances() -> int:
    """How many bf16 kernel instances the build has."""
    return build.lib().tcm_matmul_bf16_instances()


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
    """Launch ``csrc/matmul.cu`` on CUDA tensors; raises on anything else,
    including a tile the dtype's kernel does not take
    (``core.autotile.kernel_takes``)."""
    M, K, N = _check(a, b, bm, bk, bn)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul_cuda takes two tensors on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes contiguous row-major tensors")
    if not kernel_takes(bm, bk, bn, K, a.element_size()):
        raise ValueError(
            f"the {a.dtype} kernel does not take tile {(bm, bk, bn)} "
            f"({smem_footprint(bm, bk, bn, a.element_size())} B of shared "
            f"memory of {SMEM_BYTES}; see core.autotile.kernel_takes)")
    bf16 = a.dtype == torch.bfloat16
    if bf16 and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("TMA needs 16-byte-aligned operands")
    z = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib = build.lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            code = lib.tcm_matmul_bf16_launch(
                a.data_ptr(), b.data_ptr(), z.data_ptr(), M, K, N, bm, bk,
                bn, stream)
        else:
            code = lib.tcm_matmul_f32_launch(
                a.data_ptr(), b.data_ptr(), z.data_ptr(), M, K, N, bm, bk,
                bn, stream)
    build.check(code, "matmul")
    matmul_cuda.launches += 1
    return z


matmul_cuda.launches = 0
