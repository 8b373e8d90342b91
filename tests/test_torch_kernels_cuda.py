"""The CUDA kernels against their plain versions, on the card only, and
the training path on the card against the CPU.

Duplicates of ``chip_smoke.py`` phase 2 at the reference tests' shapes and
tolerances, of phase 6 (a)-(b) at smoke size, and of phase 8 (a)'s
compression check.  Like the port, this
file imports no JAX.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import (matmul_cuda, matmul_plain,
                                        wgmma_instance, wgmma_instances)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed import compression
from repro_torch.kernels.ref import attention_ref, matmul_ref
from repro_torch.models import lm
from repro_torch.models.layers import flash_attention
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.training.step import init, make_train_step

MM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
             (384, 384, 384)]
FA_SHAPES = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal)
    (1, 256, 256, 2, 2, 128, True),
    (2, 128, 256, 4, 2, 128, False),  # GQA + cross-length
    (1, 384, 384, 4, 1, 128, True),   # MQA
    (8, 1, 100, 4, 2, 32, False),     # decode, ragged kv
    (2, 100, 130, 4, 2, 32, True),    # ragged edges, Dh 32
    (1, 1024, 1024, 16, 16, 64, True),  # qwen1.5-0.5b prefill 1x1024
    (8, 1, 1024, 16, 16, 64, False),    # qwen1.5-0.5b decode 8x1024
]
# bf16 matmul tiles: (M, K, N, (bm, bk, bn)), every wgmma instance
WGMMA_CASES = [
    (1, 256, 1024, (1, 64, 512)),
    (8, 320, 1536, (8, 64, 192)),
    (8, 192, 512, (8, 64, 64)),
    (8, 8, 64, (8, 8, 64)),
    (8, 128, 8, (8, 64, 8)),
    (8, 1024, 896, (8, 64, 448)),
    (8, 1024, 1024, (8, 64, 128)),
    (8, 256, 640, (8, 64, 320)),
    (8, 128, 768, (8, 64, 384)),
    (64, 256, 1024, (64, 64, 256)),
    (256, 320, 384, (128, 64, 192)),
    (256, 512, 512, (128, 64, 256)),
    (512, 384, 256, (256, 64, 128)),
    (512, 384, 256, (256, 64, 64)),
    (1024, 512, 128, (512, 64, 64)),
    (384, 640, 384, (128, 128, 128)),
]
# bf16 attention tiles: tensor-core path (1, 4, 8 warps) and decode path
FA_BF16_TILES = [(64, 64), (128, 128), (16, 64), (1, 64), (1, 512)]
# bf16 against the plain version: one rounding step (see chip_smoke.py)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 4e-3
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


def _held_bf16(out, plain, oracle, tol):
    """bf16 kernel output within one rounding step of its plain version,
    and within the reference tolerance of the oracle."""
    np.testing.assert_allclose(_np(out), _np(plain), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    np.testing.assert_allclose(_np(out), _np(oracle), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_wgmma_cases_cover_every_instance(cuda_device):
    # the launcher in csrc/matmul.cu picks the instance: ask the build
    assert ({wgmma_instance(t[0], t[2]) for *_, t in WGMMA_CASES}
            == set(range(wgmma_instances())))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_wgmma_matmul_instances_on_card(case, cuda_device):
    M, K, N, (bm, bk, bn) = case
    rng = np.random.default_rng(1)
    a = _t(rng, (M, K), "bfloat16", cuda_device)
    b = _t(rng, (K, N), "bfloat16", cuda_device)
    _held_bf16(matmul_cuda(a, b, bm=bm, bk=bk, bn=bn),
               matmul_plain(a, b, bm=bm, bk=bk, bn=bn), matmul_ref(a, b),
               MM_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", FA_BF16_TILES, ids=str)
@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
def test_bf16_attention_paths_on_card(shape, tiles, cuda_device):
    B, Sq, Sk, Hq, Hkv, Dh, causal = shape
    bq, bk = tiles
    rng = np.random.default_rng(3)
    q = _t(rng, (B, Sq, Hq, Dh), "bfloat16", cuda_device)
    k = _t(rng, (B, Sk, Hkv, Dh), "bfloat16", cuda_device)
    v = _t(rng, (B, Sk, Hkv, Dh), "bfloat16", cuda_device)
    _held_bf16(flash_attention_cuda(q, k, v, causal=causal, bq=bq, bk=bk),
               flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk),
               attention_ref(q, k, v, causal=causal), FA_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
def test_flash_backward_on_card_matches_cpu(window, cuda_device):
    """The flash attention's manual backward, f32, on the card against the
    CPU at the reference's gradient tolerance (5e-4)."""
    rng = np.random.default_rng(4)
    x = [rng.normal(size=s).astype(np.float32) for s in
         ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16), (16,))]
    grads = []
    for dev in ("cpu", cuda_device):
        ins = [torch.from_numpy(a).to(dev).requires_grad_() for a in x[:3]]
        o = flash_attention(*ins, causal=True, window=window, q_chunk=16,
                            kv_chunk=16)
        torch.tanh(o @ torch.from_numpy(x[3]).to(dev)).sum().backward()
        grads.append([_np(t.grad) for t in ins])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One f32 AdamW step of smoke qwen on the card against the CPU: loss
    and grad norm to f32 summation order (1e-5), parameters within 1e-4
    (an element whose gradient is near Adam's eps differs most)."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).scaled(dtype="float32")
    oc = OptConfig(lr=1e-3, warmup=1)
    cpu, cpu_opt = init(cfg, oc, "cpu")
    card = lm.tree_map(lambda t: t.to(cuda_device, copy=True), cpu)
    card_opt = init_opt_state(oc, card)
    batch = next(SyntheticTokens(DataConfig(global_batch=2, seq_len=32,
                                            vocab=cfg.vocab)))
    step = make_train_step(cfg, oc)
    _, _, m_cpu = step(cpu, cpu_opt, batch)
    _, _, m_card = step(card, card_opt, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(m_card[key].item(), m_cpu[key].item(),
                                   rtol=1e-5)
    for a, b in zip(lm.tree_leaves(card), lm.tree_leaves(cpu)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_compression_on_card_equals_cpu_bitwise(cuda_device):
    """int8 codes, scales, dequantized values and residuals on the card
    equal the CPU's bit for bit (a Python-scalar divisor would be taken as
    a product with its reciprocal on CUDA and round differently)."""
    rng = np.random.default_rng(5)
    g = {"w": torch.from_numpy(rng.normal(size=(300, 70)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(4096,)).astype(
            np.float32) * 1e-3)}
    card = lm.tree_map(lambda t: t.to(cuda_device), g)
    for key in g:
        q, s = compression._quant(g[key])
        qc, sc = compression._quant(card[key])
        assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    out = compression.compress_decompress(g, compression.init_error_feedback(
        g))
    out_c = compression.compress_decompress(
        card, compression.init_error_feedback(card))
    for a, b in zip(lm.tree_leaves(out), lm.tree_leaves(out_c)):
        assert torch.equal(b.cpu(), a)
