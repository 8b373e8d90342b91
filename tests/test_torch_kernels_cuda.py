"""The CUDA kernels against their plain versions, on the card only, and
the training path on the card against the CPU.

Duplicates of ``chip_smoke.py`` phase 2 at the reference tests' shapes and
tolerances, of phase 6 (a)-(b) at smoke size, of phase 8 (a)'s
compression check, and of phase 7b's criteria kernel against its plain
version and numpy, bit for bit (at a tile's edges and an odd row width,
through ``evaluate``'s pinned round trip, from two threads at once), with
the search's route on.  Like the
port, this file imports no JAX.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import (matmul_cuda, matmul_plain,
                                        wgmma_instance, wgmma_instances)
from repro_torch.configs import get_config
from repro_torch.core import matmul, symbolic, tcm_map
from repro_torch.core.einsum import batched_matmul
from repro_torch.core.fusion import FusedWorkload, GroupEdge
from repro_torch.core.mapper import tcm_map_group
from repro_torch.core.presets import tpu_v4i_like
from repro_torch.kernels import criteria
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


@functools.lru_cache(maxsize=1)
def _criteria_pairs():
    """Every (kernel, columns) pair the fused QK -> AV search meets
    (``tests/test_fusion.py``'s pair on the TPU-v4i preset), with numpy's
    criteria."""
    seen = []
    orig = symbolic.CriteriaKernel.__call__

    def rec(self, cols):
        out = orig(self, cols)
        seen.append((self, cols.copy(), np.ascontiguousarray(out)))
        return out

    symbolic.CriteriaKernel.__call__ = rec
    try:
        qk = batched_matmul("qk", 8, 4, 32, 64)
        av = batched_matmul("av", 8, 4, 64, 32)
        tcm_map_group(FusedWorkload("qk+av", (qk, av),
                                    (GroupEdge(0, 1, "Z", "A"),)),
                      tpu_v4i_like())
    finally:
        symbolic.CriteriaKernel.__call__ = orig
    return seen


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


@pytest.mark.cuda
def test_criteria_kernel_is_numpy_bit_for_bit_on_card(cuda_device):
    pairs = _criteria_pairs()
    assert {2, 3, 4, 5} <= {e for k, _, _ in pairs for _, e in k._factors}
    before = criteria.criteria_cuda.launches
    for kernel, cols, want in pairs:
        c = criteria.pack(kernel, "cuda")
        x = torch.from_numpy(cols).to(cuda_device)
        got = criteria.criteria_cuda(c, x).cpu().numpy()
        plain = criteria.criteria_plain(c, x).cpu().numpy()
        np.testing.assert_array_equal(_bits(got), _bits(plain))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert criteria.criteria_cuda.launches - before == sum(
        cols.shape[0] > 0 for _, cols, _ in pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 300, 20000])
def test_criteria_kernel_hand_made_on_card(n, cuda_device):
    """Exponents 2-5 and -1, an empty criterion, a constant term; columns
    up to 1000 (every power exact: numpy's bits) and up to 70000 (powers
    past f64's 53 bits: the plain version's bits, numpy's within an ulp of
    each factor)."""
    crits = [((2.0, (("a", 1),)), (3.0, (("b", 2),))),
             (),
             ((1.5, ()), (0.5, (("a", 3), ("b", 1)))),
             ((1.0, (("c", 4),)), (-2.0, (("a", 5), ("c", 1))),
              (0.25, (("a", 1), ("b", 1), ("c", 2)))),
             ((1.0, (("b", -1),)), (4.0, (("a", 2), ("c", -1))))]
    kernel = symbolic.CriteriaKernel(crits, {"a": 0, "b": 1, "c": 2})
    c = criteria.pack(kernel, "cuda")
    rng = np.random.default_rng(n)
    for high in (1000, 70000):
        cols = rng.integers(1, high + 1, size=(n, 3)).astype(np.float64)
        x = torch.from_numpy(cols).to(cuda_device)
        got = criteria.criteria_cuda(c, x).cpu().numpy()
        assert got.shape == (n, len(crits))
        np.testing.assert_array_equal(
            _bits(got), _bits(criteria.criteria_plain(c, x).cpu().numpy()))
        want = kernel(cols)
        if high == 1000:
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:  # within 1e-14 of the criterion's sum of |terms|
            mags = symbolic.CriteriaKernel(
                [tuple((abs(w), pw) for w, pw in cr) for cr in crits],
                {"a": 0, "b": 1, "c": 2})(cols)
            assert (np.abs(got - want) <= 1e-14 * mags).all()


# hand-made criteria over 5 columns (an odd row width): exponents 2-5 and
# -1, an empty criterion, a constant term
ODD_CRITS = [((2.0, (("a", 1),)), (3.0, (("b", 2),))),
             (),
             ((1.5, ()), (0.5, (("a", 3), ("e", 1)))),
             ((1.0, (("c", 4),)), (-2.0, (("a", 5), ("c", 1))),
              (0.25, (("a", 1), ("b", 1), ("c", 2)))),
             ((1.0, (("b", -1),)), (4.0, (("e", 2), ("c", -1))))]
ODD_INDEX = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("n", [3, 1055, 16863, 16864, 16865, 70001])
def test_criteria_kernel_at_tile_edges(n, skip, cuda_device):
    """Tiles of 1 to 128 rows, the last one full or short by one row or
    more; 5 columns, so a tile's bytes are not always a multiple of 16, and
    with ``skip`` the columns start 40 bytes into their buffer (8 past a
    16-byte boundary): the first and last value of a tile outside the bulk
    copy."""
    kernel = symbolic.CriteriaKernel(ODD_CRITS, ODD_INDEX)
    c = criteria.pack(kernel, "cuda")
    rows, _, _ = criteria.tile_plan(c, n, len(ODD_INDEX))
    assert rows & (rows - 1) == 0 and (n == 3 or n // rows > 1)
    cols = np.random.default_rng(n).integers(
        1, 1001, size=(n + skip, len(ODD_INDEX))).astype(np.float64)
    x = torch.from_numpy(cols).to(cuda_device)[skip:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 8 * skip
    got = criteria.criteria_cuda(c, x).cpu().numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(criteria.criteria_plain(c, x).cpu().numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(kernel(cols[skip:])))


@pytest.mark.cuda
def test_criteria_round_trip_is_the_kernel(cuda_device):
    """``evaluate``'s pinned round trip against ``criteria_cuda`` on every
    call the fused search records; each launches once per call with rows."""
    pairs = _criteria_pairs()
    descs = {}
    before = criteria.criteria_cuda.launches
    for kernel, cols, want in pairs:
        c = descs.setdefault(id(kernel), criteria.pack(kernel, "cuda"))
        got = criteria.evaluate(c, cols)
        assert got.shape == want.shape
        direct = criteria.criteria_cuda(
            c, torch.from_numpy(cols).to(cuda_device)).cpu().numpy()
        np.testing.assert_array_equal(_bits(got), _bits(direct))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert criteria.criteria_cuda.launches - before == 2 * sum(
        cols.shape[0] > 0 for _, cols, _ in pairs)


@pytest.mark.cuda
def test_criteria_round_trip_from_two_threads(cuda_device):
    """Two threads evaluating at once, each on its own kernels and rows,
    get their own criteria: the staging buffers are the thread's."""
    pairs = _criteria_pairs()
    halves = [pairs[0::2][:400], pairs[1::2][:400]]
    start, bad, bufs = threading.Barrier(2), [], []

    def run(mine):
        descs = {}
        start.wait()
        for kernel, cols, want in mine:
            c = descs.setdefault(id(kernel), criteria.pack(kernel, "cuda"))
            if not np.array_equal(_bits(criteria.evaluate(c, cols)),
                                  _bits(want)):
                bad.append(cols.shape)
        bufs.append(criteria.staging(torch.device("cuda", 0)))

    threads = [threading.Thread(target=run, args=(h,)) for h in halves]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not bad
    assert len(bufs) == 2 and bufs[0] is not bufs[1]


@pytest.mark.cuda
def test_search_with_the_criteria_route_on_card(cuda_device):
    ein, arch = matmul("mm", 64, 64, 64), tpu_v4i_like()
    off, off_stats = tcm_map(ein, arch)
    before = criteria.criteria_cuda.launches
    try:
        symbolic.set_jit(True)
        on, on_stats = tcm_map(ein, arch)
    finally:
        symbolic.set_jit(False)
    assert criteria.criteria_cuda.launches > before
    assert (on.energy, on.latency, on.edp) == (off.energy, off.latency,
                                               off.edp)
    assert on.mapping == off.mapping

    def counters(s):
        return {k: v for k, v in dataclasses.asdict(s).items()
                if not k.startswith("t_")}

    assert counters(on_stats) == counters(off_stats)
