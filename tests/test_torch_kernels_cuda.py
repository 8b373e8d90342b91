"""The CUDA kernels against their plain versions, on the card only.

Duplicates of ``chip_smoke.py`` phase 2 at the reference tests' shapes and
tolerances.  Like the port, this file imports no JAX.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import matmul_cuda, matmul_plain

MM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
             (384, 384, 384)]
FA_SHAPES = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal)
    (1, 256, 256, 2, 2, 128, True),
    (2, 128, 256, 4, 2, 128, False),  # GQA + cross-length
    (1, 384, 384, 4, 1, 128, True),   # MQA
    (8, 1, 100, 4, 2, 32, False),     # decode, ragged kv
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MM_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _t(rng, shape, dtype, dev):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device=dev, dtype=DTYPES[dtype])


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_matmul_kernel_matches_plain_on_card(shape, dtype, cuda_device):
    M, K, N = shape
    rng = np.random.default_rng(0)
    a, b = _t(rng, (M, K), dtype, cuda_device), _t(rng, (K, N), dtype,
                                                   cuda_device)
    tol = MM_TOL[dtype]
    np.testing.assert_allclose(
        _np(matmul_cuda(a, b, bm=128, bk=128, bn=128)),
        _np(matmul_plain(a, b, bm=128, bk=128, bn=128)), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_attention_kernel_matches_plain_on_card(shape, dtype,
                                                      cuda_device):
    B, Sq, Sk, Hq, Hkv, Dh, causal = shape
    rng = np.random.default_rng(2)
    q = _t(rng, (B, Sq, Hq, Dh), dtype, cuda_device)
    k = _t(rng, (B, Sk, Hkv, Dh), dtype, cuda_device)
    v = _t(rng, (B, Sk, Hkv, Dh), dtype, cuda_device)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(
        _np(flash_attention_cuda(q, k, v, causal=causal, bq=64, bk=64)),
        _np(flash_attention_plain(q, k, v, causal=causal, bq=64, bk=64)),
        rtol=tol, atol=tol)
