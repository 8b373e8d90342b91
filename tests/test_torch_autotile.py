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
from repro_torch.core.autotile import (ACC_ELEMS, BLOCK, SMEM_BYTES,
                                       acc_elems, attention_tile,
                                       kernel_takes, plan_arch, ring_stages,
                                       smem_footprint, tcm_matmul_plan,
                                       tcm_matmul_tiles, wgmma_tile)
from repro_torch.core.einsum import matmul
from repro_torch.core.looptree import Loop, Storage
from repro_torch.core.mapper import tcm_map
from repro_torch.measure import attention_plan
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.kernels.ref import attention_ref
from repro_torch.netmap.extract import extract_einsums as port_extract
from repro_torch.netmap.planner import model_shapes, model_tiles

MAIN_PATH = [("prefill", 1, 1024), ("decode", 8, 1024)]


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (1024, 1024, 2816),
                                   (8, 1024, 151936), (1, 64, 1024),
                                   (100, 200, 30)])
def test_tiles_block_aligned_and_clamped(shape):
    # bf16: a dim below 64 is one block of its own size, rounded up to a
    # multiple of 8 for TMA (the caller pads); f32 keeps it as it is
    for dim, t in zip(shape, tcm_matmul_tiles(*shape)):
        assert 1 <= t <= -(-dim // 8) * 8
        assert t % BLOCK == 0 or t == dim or (t < BLOCK and t % 8 == 0
                                              and t - dim < 8)
    for dim, t in zip(shape, tcm_matmul_tiles(*shape, word_bytes=4)):
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
    # bf16 rounds a k of 30 up to 32 (TMA rows are 16-byte multiples)
    assert tcm_matmul_tiles(8, 30, 512, smem_bytes=1000) == (8, 32, 64)
    assert tcm_matmul_tiles(8, 30, 512, smem_bytes=1000,
                            word_bytes=4) == (8, 30, 64)


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


def _bf16_plans(name, mode, batch, seq):
    cfg = port_configs.get_config(name)
    return {shape: tcm_matmul_plan(*shape)
            for shape in set(model_shapes(cfg, mode, batch, seq).values())}


def _bf16_tiles(name, mode, batch, seq):
    return {shape: plan.tiles
            for shape, plan in _bf16_plans(name, mode, batch, seq).items()}


@pytest.mark.parametrize("name", port_configs.ARCHS)
@pytest.mark.parametrize("mode,batch,seq", MAIN_PATH)
def test_bf16_plans_are_wgmma_kernel_tiles(name, mode, batch, seq):
    """Every bf16 tile the planner gives a config's main path is the
    mapping's own tile (neither the least-extent fallback nor the kernel's
    tile clamp changed it, so the plan keeps its modeled latency), and the
    wgmma kernel takes it as it is: in the tile set, its ring within 227 KB
    and its accumulator within the two consumer warpgroups' registers."""
    for shape, plan in _bf16_plans(name, mode, batch, seq).items():
        bm, bk, bn = plan.tiles
        assert plan.modeled_s is not None, (shape, plan.tiles)
        assert kernel_takes(bm, bk, bn, shape[1], 2), (shape, plan.tiles)
        assert wgmma_tile(bm, bk, bn) == (bm, bk, bn)
        assert smem_footprint(bm, bk, bn, 2) <= SMEM_BYTES
        assert acc_elems(bm, bn) <= ACC_ELEMS
        assert ring_stages(bm, bk, bn) >= 2


@pytest.mark.parametrize("shape,smem,word_bytes,tiles,own", [
    ((1024, 1024, 1024), SMEM_BYTES, 2, (256, 64, 128), True),
    ((8, 1024, 151936), SMEM_BYTES, 2, (8, 64, 128), True),
    ((1024, 1024, 1024), SMEM_BYTES, 4, (256, 64, 128), True),
    ((512, 384, 640), SMEM_BYTES, 4, (128, 64, 64), False),  # fallback
    ((192, 64, 64), SMEM_BYTES, 2, (128, 64, 64), False),  # bm 192 -> 128
    ((64, 1024, 1024), SMEM_BYTES, 4, (64, 64, 64), False),  # fallback
    ((512, 512, 512), 1000, 2, (64, 64, 64), False),  # no mapping at all
])
def test_plan_reports_a_tile_that_is_not_the_mappings(shape, smem,
                                                       word_bytes, tiles,
                                                       own):
    """A plan keeps its mapping's modeled latency only when the tile is
    that mapping's own; the kernel's tile clamp, the least-extent fallback
    and a search without a mapping leave ``modeled_s`` None."""
    plan = tcm_matmul_plan(*shape, smem, word_bytes)
    assert plan.tiles == tiles
    assert (plan.modeled_s is not None) is own


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (1024, 1024, 151936),
                                   (1024, 1024, 64), (8, 1024, 2816),
                                   (1, 64, 1024)])
def test_bf16_plan_holds_z_in_rf_above_every_k_loop(shape):
    """The bf16 arch keeps Z's RF node above every k loop, as the kernel
    holds its accumulator for the whole K loop, and A, B in SMEM below it."""
    M, K, N = shape
    ein = matmul("mm", max(M // BLOCK, 1), max(K // BLOCK, 1),
                 max(N // BLOCK, 1))
    best, _ = tcm_map(ein, plan_arch(word_bytes=2), objective="latency")
    nodes = list(best.mapping)
    z_rf = next(i for i, n in enumerate(nodes)
                if isinstance(n, Storage) and n.tensor == "Z" and n.level == 1)
    assert not any(isinstance(n, Loop) and n.var == "k" and n.bound > 1
                   for n in nodes[:z_rf])
    for t in ("A", "B"):
        at = next(i for i, n in enumerate(nodes)
                  if isinstance(n, Storage) and n.tensor == t and n.level == 2)
        assert at > z_rf


def test_qwen_bf16_plans_match_the_wgmma_model():
    tiles = _bf16_tiles("qwen1_5_0_5b", "prefill", 1, 1024)
    assert tiles[(1024, 1024, 1024)] == (256, 64, 128)
    assert tiles[(1024, 1024, 151936)] == (256, 64, 128)
    assert tiles[(1024, 1024, 64)] == (512, 64, 64)
    tiles = _bf16_tiles("qwen1_5_0_5b", "decode", 8, 1024)
    assert tiles[(8, 1024, 1024)] == (8, 64, 512)
    assert tiles[(8, 1024, 2816)] == (8, 64, 256)
    assert tiles[(8, 1024, 151936)] == (8, 64, 128)


def test_f32_plans_keep_the_simt_model():
    assert tcm_matmul_tiles(512, 384, 640, word_bytes=4) == (128, 64, 64)
    assert plan_arch(word_bytes=4).name == "h100-sm-blocks"
    assert [l.name for l in plan_arch(word_bytes=2).levels] == [
        "HBM", "RF", "SMEM"]
    # the SIMT footprint counts the f32 accumulator; the ring does not
    assert smem_footprint(128, 64, 64, 4) == (128 * 64 + 64 * 64) * 4 + (
        128 * 64 * 4)
    assert smem_footprint(256, 64, 128, 2) == (
        1024 + 4 * (256 * 64 + 64 * 128) * 2 + 2 * 4 * 8)


@pytest.mark.parametrize("tile,want", [
    ((256, 64, 128), (256, 64, 128)),   # already a kernel tile
    ((192, 64, 128), (128, 64, 128)),   # bm rounds down into 128/256/512
    ((384, 64, 64), (256, 64, 64)),
    ((100, 64, 64), (64, 64, 64)),      # 65..127 rows: one 64-row tile
    ((8, 30, 20), (8, 32, 24)),         # below 64: up to a multiple of 8
    ((1, 96, 200), (1, 64, 192)),       # above 64: down to a multiple of 64
])
def test_wgmma_tile_clamp(tile, want):
    assert wgmma_tile(*tile) == want
    assert wgmma_tile(*want) == want


@pytest.mark.parametrize("tile,K,takes", [
    ((256, 64, 128), 1024, True), ((512, 64, 64), 1024, True),
    ((8, 64, 512), 1024, True), ((128, 128, 128), 1024, True),
    ((8, 8, 64), 8, True), ((8, 40, 64), 40, True),  # one box covers K
    ((8, 32, 64), 30, True),    # K padded up to the step
    ((8, 8, 64), 1024, False),  # the kernel would step 64 deep, not 8
    ((8, 32, 64), 64, False),
    ((512, 64, 128), 1024, False),   # 65536 accumulators
    ((256, 64, 256), 1024, False),   # 65536 accumulators
    ((64, 512, 512), 1024, False),   # one 512-deep stage does not fit
    ((192, 64, 64), 1024, False),    # not a kernel tile (see wgmma_tile)
    ((8, 30, 64), 30, False),        # k rows of 60 bytes
])
def test_kernel_takes_bf16(tile, K, takes):
    assert kernel_takes(*tile, K, 2) is takes


def test_ring_stages_shrink_to_fit():
    assert ring_stages(256, 64, 128) == 4
    assert ring_stages(512, 64, 64) == 3   # 9 boxes a stage
    assert ring_stages(128, 128, 128) == 3
    assert ring_stages(64, 512, 512) == 0  # one stage is 576 KB


@pytest.mark.parametrize("tile,word_bytes,want", [
    ((256, 128), 2, (128, 128)),  # 8 warps of 16 rows at most
    ((64, 64), 2, (64, 64)),
    ((100, 300), 2, (96, 128)),
    ((16, 30), 2, (16, 64)),      # a ragged kv tile is masked
    ((1, 512), 2, (1, 512)),      # decode path: any kv tile
    ((8, 64), 2, (8, 64)),
    ((256, 128), 4, (256, 128)),  # f32 SIMT: any tile that fits
])
def test_attention_tile_clamp(tile, word_bytes, want):
    assert attention_tile(*tile, word_bytes) == want


def test_attention_plan_maps_qwen_scores_onto_kernel_tiles():
    assert attention_plan(1024, 1024, 64)[0] == (128, 128)
    assert attention_plan(1, 1024, 64)[0] == (1, 512)
