"""Hopper tile planning: alignment, fit, memoization and the reference's
planner surface, plus the reference behaviours the port must not copy."""
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as port_configs
from repro.core.autotile import tcm_matmul_tiles as ref_tcm_matmul_tiles
from repro.core.einsum import einsum_to_dict
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.netmap.extract import extract_einsums as ref_extract
from repro.netmap.planner import network_blockspec_tiles
from repro_torch.core.autotile import (BLOCK, SMEM_BYTES, smem_footprint,
                                       tcm_matmul_plan, tcm_matmul_tiles)
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.kernels.ref import attention_ref
from repro_torch.netmap.extract import extract_einsums as port_extract
from repro_torch.netmap.planner import model_shapes, model_tiles

MAIN_PATH = [("prefill", 1, 1024), ("decode", 8, 1024)]


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (1024, 1024, 2816),
                                   (8, 1024, 151936), (1, 64, 1024),
                                   (100, 200, 30)])
def test_tiles_block_aligned_and_clamped(shape):
    for dim, t in zip(shape, tcm_matmul_tiles(*shape)):
        assert 1 <= t <= dim
        assert t % BLOCK == 0 or t == dim


def test_tiles_memoized():
    from repro_torch.core.autotile import _search_plan

    _search_plan.cache_clear()
    first = tcm_matmul_plan(512, 384, 640)
    assert tcm_matmul_plan(512, 384, 640, word_bytes=2) is first
    assert tcm_matmul_tiles(512, 384, 640, SMEM_BYTES, 2) is first.tiles
    assert _search_plan.cache_info().hits == 2
    assert _search_plan.cache_info().misses == 1


def test_fallback_when_nothing_fits():
    # 1000 bytes hold no 64x64 block: no mapping exists, so the reference's
    # fallback contract applies (block-sized minima, clamped to the dims)
    assert tcm_matmul_plan(512, 512, 512, smem_bytes=1000).modeled_s is None
    assert tcm_matmul_tiles(512, 512, 512, smem_bytes=1000) == (64, 64, 64)
    assert tcm_matmul_tiles(8, 30, 512, smem_bytes=1000) == (8, 30, 64)


@pytest.mark.parametrize("name", ["qwen1_5_0_5b", "phi3_mini_3_8b"])
@pytest.mark.parametrize("mode,batch,seq", MAIN_PATH)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_footprint_fits_smem(name, mode, batch, seq, dtype):
    cfg = port_configs.get_config(name)
    nbytes = dtype.itemsize
    for shape in set(model_shapes(cfg, mode, batch, seq).values()):
        bm, bk, bn = tcm_matmul_tiles(*shape, word_bytes=nbytes)
        assert smem_footprint(bm, bk, bn, nbytes) <= SMEM_BYTES, shape


@pytest.mark.parametrize("name", ref_configs.ARCHS)
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_extract_einsums_matches_reference(name, mode):
    ref = ref_extract(ref_configs.get_config(name), mode=mode, batch=2,
                      seq=256)
    port = port_extract(port_configs.get_config(name), mode=mode, batch=2,
                        seq=256)
    assert ([(e.layer, e.op, e.count, einsum_to_dict(e.einsum)) for e in ref]
            == [(e.layer, e.op, e.count, einsum_to_dict(e.einsum))
                for e in port])


def test_model_tiles_keys_match_reference_planner():
    ref = network_blockspec_tiles(
        ref_configs.get_config("qwen1_5_0_5b", smoke=True))
    port = model_tiles(port_configs.get_config("qwen1_5_0_5b", smoke=True))
    assert list(port) == list(ref)


def test_reference_lm_head_tile_overreports_port_fits():
    """The reference counts the n=1187 loop above B's SMEM node as part of
    the tile (its ``_tile_products`` starts below the FIRST level-1 node),
    reporting a 1024 x 151936 B tile; the port takes each tensor's own
    extent and fits one H100 block's shared memory."""
    assert ref_tcm_matmul_tiles(512, 1024, 151936) == (512, 1024, 151936)
    bm, bk, bn = tcm_matmul_tiles(512, 1024, 151936)
    assert bn < 151936
    assert smem_footprint(bm, bk, bn, 2) <= SMEM_BYTES


def test_port_attention_takes_decode_sq1():
    """The reference kernel asserts Sq % bq == 0, so decode (Sq = 1) cannot
    run there; the port masks the ragged edge and matches the oracle."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(8, 1, 4, 32)).astype(np.float32)
    k = rng.normal(size=(8, 100, 2, 32)).astype(np.float32)
    v = rng.normal(size=(8, 100, 2, 32)).astype(np.float32)
    out = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, bq=1, bk=64)
    want = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_attention_ref(q, k, v, causal=False)),
        rtol=2e-5, atol=2e-5)


def test_kernel_tile_falls_back_to_least_extents():
    """Z holds 8 n-blocks while B streams them one at a time: in f32 the
    kernel's whole 64 x 512 B slab plus accumulator would overflow, so each
    rank takes the least extent any tensor holds."""
    from repro_torch.core.autotile import _kernel_tile

    held = {"A": {"m": 1, "k": 1}, "B": {"k": 1, "n": 1},
            "Z": {"m": 1, "n": 8}}

    def fits(t):
        return smem_footprint(t["m"] * BLOCK, t["k"] * BLOCK,
                              t["n"] * BLOCK, 4) <= SMEM_BYTES

    assert _kernel_tile(held, lambda t: True) == {"m": 1, "n": 8, "k": 1}
    assert _kernel_tile(held, fits) == {"m": 1, "k": 1, "n": 1}
