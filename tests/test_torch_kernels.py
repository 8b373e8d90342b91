"""The port's kernel wrappers and oracles against the JAX reference.

Inputs are made with numpy seeds and handed to both packages.  On the CPU
the port's ops run the kernels' plain versions, held here against the
Pallas kernels run with ``interpret=True`` (as tests/test_kernels.py runs
them) at that file's tolerances.  The CUDA kernels themselves are held
against their plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.autotile import tcm_matmul_tiles as ref_tcm_matmul_tiles
from repro.kernels import ops as ref_ops
from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.matmul import matmul_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as P
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import matmul_cuda, matmul_plain

MM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
             (384, 384, 384)]
FA_SHAPES = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal)
    (1, 256, 256, 2, 2, 128, True),
    (2, 128, 256, 4, 2, 128, False),  # GQA + cross-length
    (1, 384, 384, 4, 1, 128, True),   # MQA
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MM_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(x: np.ndarray, dtype: str):
    """One f32 numpy array as a JAX array and a torch tensor of ``dtype``
    (both round f32 -> bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    x = x.astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _mm_inputs(shape, dtype, seed=0):
    M, K, N = shape
    rng = np.random.default_rng(seed)
    return _pair(rng.normal(size=(M, K)), dtype) + _pair(
        rng.normal(size=(K, N)), dtype)


def _fa_inputs(shape, dtype, seed=2):
    B, Sq, Sk, Hq, Hkv, Dh, _ = shape
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(B, Sq, Hq, Dh)), dtype)
            + _pair(rng.normal(size=(B, Sk, Hkv, Dh)), dtype)
            + _pair(rng.normal(size=(B, Sk, Hkv, Dh)), dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_matmul_ref_matches_reference(shape, dtype):
    ja, ta, jb, tb = _mm_inputs(shape, dtype)
    tol = MM_TOL[dtype]
    np.testing.assert_allclose(_np(P.matmul_ref(ta, tb)),
                               _np(R.matmul_ref(ja, jb)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_attention_ref_matches_reference(shape, dtype):
    jq, tq, jk, tk, jv, tv = _fa_inputs(shape, dtype)
    causal = shape[-1]
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(
        _np(P.attention_ref(tq, tk, tv, causal=causal)),
        _np(R.attention_ref(jq, jk, jv, causal=causal)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_matmul_plain_matches_pallas(shape, dtype):
    ja, ta, jb, tb = _mm_inputs(shape, dtype)
    tol = MM_TOL[dtype]
    want = matmul_pallas(ja, jb, bm=128, bk=128, bn=128, interpret=True)
    np.testing.assert_allclose(
        _np(matmul_plain(ta, tb, bm=128, bk=128, bn=128)), _np(want),
        rtol=tol, atol=tol)


def test_tcm_matmul_cpu_matches_pallas_tcm_tiles():
    """Both packages' TCM-tiled matmul on 512x384x640: each with its own
    mapper's tiles, padded to its tile grid."""
    M, K, N = 512, 384, 640
    ja, ta, jb, tb = _mm_inputs((M, K, N), "float32", seed=1)
    bm, bk, bn = ref_tcm_matmul_tiles(M, K, N, vmem_bytes=1 << 20)
    ap = ref_ops._pad_to(ref_ops._pad_to(ja, bm, 0), bk, 1)
    bp = ref_ops._pad_to(ref_ops._pad_to(jb, bk, 0), bn, 1)
    want = matmul_pallas(ap, bp, bm=bm, bk=bk, bn=bn, interpret=True)[:M, :N]
    np.testing.assert_allclose(_np(ops.tcm_matmul(ta, tb)), _np(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(100, 70, 30), (8, 1024, 96)])
def test_tcm_matmul_pads_ragged_shapes(shape):
    _, ta, _, tb = _mm_inputs(shape, "float32", seed=4)
    out = ops.tcm_matmul(ta, tb)
    assert out.shape == (shape[0], shape[2])
    np.testing.assert_allclose(_np(out), _np(P.matmul_ref(ta, tb)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_attention_op_cpu_matches_pallas(shape, dtype):
    jq, tq, jk, tk, jv, tv = _fa_inputs(shape, dtype)
    causal = shape[-1]
    tol = FA_TOL[dtype]
    want = flash_attention_pallas(jq, jk, jv, causal=causal, bq=128, bk=128,
                                  interpret=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("bq,bk", [(64, 64), (16, 48), (128, 32)])
def test_flash_attention_plain_tiles_change_nothing(bq, bk):
    """The tile sizes change no value of the plain version (skipped or
    visited causal tiles add exactly nothing)."""
    _, tq, _, tk, _, tv = _fa_inputs((1, 96, 96, 2, 1, 32, True), "float32")
    base = flash_attention_plain(tq, tk, tv, causal=True, bq=96, bk=96)
    got = flash_attention_plain(tq, tk, tv, causal=True, bq=bq, bk=bk)
    np.testing.assert_allclose(_np(got), _np(base), rtol=2e-6, atol=2e-6)


def test_cpu_tensors_never_reach_the_kernels():
    t = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        matmul_cuda(t, t, bm=64, bk=64, bn=64)
    q = torch.zeros((1, 64, 2, 32))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        ops.tcm_matmul(t, t.to("meta"))


def test_ptxas_summary_names_each_kernel():
    from repro_torch.kernels.build import ptxas_summary

    fn = ("_ZN41_GLOBAL__N__42bcca10_9_matmul_cu_f49e585212wgmma_matmulILi2E"
          "Li128EEEv14CUtensorMap_stS1_P13__nv_bfloat16iiiiiii")
    f32 = "_ZN41_GLOBAL__N__42bcca10_9_matmul_cu_f49e585215simt_matmul_f32EPKf"
    log = "\n".join([
        f"ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
        f"instructions are serialized due to X in the function '{fn}'",
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fn}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 63 registers, used 1 barriers"])
    assert ptxas_summary(log) == [
        "wgmma_matmul<2,128>: wgmma.mma_async instructions are serialized "
        "due to X",
        "wgmma_matmul<2,128>: 168 registers, 0 bytes stack frame, 0 bytes "
        "spill stores, 0 bytes spill loads",
        "simt_matmul_f32: 63 registers, 0 bytes stack frame, 8 bytes spill "
        "stores, 8 bytes spill loads"]
