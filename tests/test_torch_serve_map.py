"""The port's mapping service against the reference's, and its tile route.

The same ``MapRequest`` goes to ``repro.serve_map.MappingService`` and
``repro_torch.serve_map.MappingService`` (einsum and arch carried across as
wire dicts), each on its own cache; served answers must agree exactly.
The port's ``service_matmul_tiles`` must serve the offline plan's tiles.
All on the CPU.
"""
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.presets import tpu_v4i_like
from repro.dse.roofline import einsum_bounds as ref_einsum_bounds
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.matmul import matmul_pallas
from repro.netmap.cache import mapping_to_wire as ref_mapping_to_wire
from repro.serve_map import MapRequest as RefRequest
from repro.serve_map import MappingService as RefService
from repro.serve_map.measure import measure_matmul as ref_measure_matmul
from repro_torch.configs import get_config
from repro_torch.core.autotile import (kernel_takes, plan_arch, plan_einsum,
                                       tcm_matmul_plan)
from repro_torch.core.search import clear_search_caches
from repro_torch.dse.roofline import einsum_bounds
from repro_torch.measure import _randn
from repro_torch.netmap.cache import mapping_to_wire
from repro_torch.netmap.planner import model_shapes
from repro_torch.serve_map import MapRequest, MappingService
from repro_torch.serve_map.__main__ import main as serve_main
from repro_torch.serve_map.measure import (measure_flash_attention,
                                           measure_matmul, run_tile_load,
                                           service_matmul_tiles,
                                           tile_request_shapes)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

ARCHS = {
    "tpu_v4i": lambda: R.arch_to_dict(tpu_v4i_like()),
    "plan_arch": lambda: P.arch_to_dict(plan_arch(word_bytes=2)),
}
# (warm-up einsum, requested einsum, expected source): the warm-up runs
# first on each side (None: cold service)
SCENARIOS = {
    "exact-miss": (None, (4, 8, 4), "search"),
    "exact-hit": ((4, 8, 4), (4, 8, 4), "exact-hit"),
    "bucket-hit": ((4, 8, 4), (3, 8, 4), "bucket-hit"),
}


def _services(tmp_path):
    return (RefService(cache_root=tmp_path / "ref", background_warm=False),
            MappingService(cache_root=tmp_path / "port",
                           background_warm=False))


def _answer(resp, to_wire):
    r = resp.result
    return (resp.source, resp.key, resp.bucketed, resp.gap_bound, r.energy,
            r.latency, r.edp, to_wire(r.mapping))


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_served_answers_bit_identical(tmp_path, arch_name, scenario):
    warm, shape, source = SCENARIOS[scenario]
    arch_d = ARCHS[arch_name]()
    objective = "latency" if arch_name == "plan_arch" else "edp"
    ref_svc, port_svc = _services(tmp_path)
    with ref_svc, port_svc:
        def both(dims):
            ein_d = R.einsum_to_dict(R.matmul("mm", *dims))
            ref = ref_svc.map(RefRequest(
                einsum=R.einsum_from_dict(ein_d),
                arch=R.arch_from_dict(arch_d), objective=objective))
            port = port_svc.map(MapRequest(
                einsum=P.einsum_from_dict(ein_d),
                arch=P.arch_from_dict(arch_d), objective=objective))
            return ref, port

        if warm is not None:
            both(warm)
        ref, port = both(shape)
    assert port.source == source
    assert _answer(port, mapping_to_wire) == _answer(ref,
                                                     ref_mapping_to_wire)
    assert port.served_einsum.rank_shapes == ref.served_einsum.rank_shapes


@pytest.mark.parametrize("arch_name", ["tpu_v4i", "f32_plan"])
def test_deadline_miss_certified_and_never_cached(tmp_path, arch_name):
    """A deadline'd miss: the best mapping found by then, a finite gap
    >= 1 (the roofline floor backstops a truncated search), never
    stored."""
    ein, arch = {
        "tpu_v4i": (P.batched_matmul("qk", 64, 256, 64, 256),
                    P.arch_from_dict(R.arch_to_dict(tpu_v4i_like()))),
        "f32_plan": (P.matmul("mm", 5040, 5040, 5040),
                     plan_arch(word_bytes=4)),
    }[arch_name]
    clear_search_caches()  # a cold search: well past the 10 ms floor
    with MappingService(cache_root=tmp_path / "c",
                        background_warm=False) as svc:
        resp = svc.map(MapRequest(einsum=ein, arch=arch, objective="latency",
                                  deadline_s=0.01))
        assert resp.source == "search" and resp.stats.truncated
        assert math.isfinite(resp.gap_bound) and resp.gap_bound >= 1.0
        assert len(svc.cache) == 0
        again = svc.map(MapRequest(einsum=ein, arch=arch,
                                   objective="latency", deadline_s=0.01))
        assert again.source == "search"


@pytest.mark.parametrize("word_bytes", [2, 4])
@pytest.mark.parametrize("shape", [(1024, 1024, 151936), (8, 1024, 2816),
                                   (1, 64, 1024)])
def test_roofline_floor_sound_on_plan_arch(shape, word_bytes):
    """The floor a truncated search's gap is certified against, on the
    plan archs' level orders (bf16: HBM -> RF(Z) -> SMEM(A, B)): positive
    and never above the exact optimum, so the gap is finite and >= 1."""
    ein, arch = plan_einsum(*shape), plan_arch(word_bytes=word_bytes)
    best, _ = P.tcm_map(ein, arch, objective="latency")
    floor = einsum_bounds(ein, arch)
    for obj in ("latency", "energy", "edp"):
        assert 0 < floor.objective(obj) <= best.objective(obj)


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("dims", [(4, 8, 4), (16, 16, 2374)])
def test_roofline_bounds_match_reference(arch_name, dims):
    arch_d = ARCHS[arch_name]()
    ein_d = R.einsum_to_dict(R.matmul("mm", *dims))
    ref = ref_einsum_bounds(R.einsum_from_dict(ein_d), R.arch_from_dict(arch_d))
    port = einsum_bounds(P.einsum_from_dict(ein_d), P.arch_from_dict(arch_d))
    assert (port.energy, port.latency) == (ref.energy, ref.latency)


def _main_path_shapes():
    cfg = get_config("qwen1_5_0_5b")
    shapes = {}
    for mode, batch in (("prefill", 1), ("decode", 8)):
        shapes.update(dict.fromkeys(model_shapes(cfg, mode, batch, 1024)
                                    .values()))
    return list(shapes)


MAIN_PATH_SHAPES = _main_path_shapes()


def test_main_path_has_twelve_unique_shapes():
    assert len(MAIN_PATH_SHAPES) == 12
    assert (1024, 1024, 151936) in MAIN_PATH_SHAPES
    assert (8, 1024, 151936) in MAIN_PATH_SHAPES


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_service_tiles_equal_offline_plan(tmp_path, shape):
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        cold, resp = service_matmul_tiles(svc, *shape, allow_bucketed=False)
        hot, resp2 = service_matmul_tiles(svc, *shape, allow_bucketed=False)
    assert (resp.source, resp2.source) == ("search", "exact-hit")
    assert not resp.bucketed and resp.served_einsum.rank_shapes == \
        plan_einsum(*shape).rank_shapes
    assert cold == hot == tcm_matmul_plan(*shape)


def test_service_tiles_f32(tmp_path):
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        plan, _ = service_matmul_tiles(svc, 512, 384, 640, word_bytes=4,
                                       allow_bucketed=False)
    assert plan.tiles == (128, 64, 64)
    assert plan == tcm_matmul_plan(512, 384, 640, word_bytes=4)


@pytest.mark.parametrize("shape", [(1, 64, 1000), (8, 1024, 2816),
                                   (24, 1024, 151936), (1000, 64, 1000)])
def test_bucketed_tile_is_one_the_kernel_takes(tmp_path, shape):
    """A ragged shape rides a bucket (2816 = 44 blocks -> 64, 151936 = 2374
    -> 4096): the bucket's mapping is limited to the shape and clamped, so
    its tile is one the bf16 kernel takes, and it carries no modeled
    latency (that would be the bucket's)."""
    M, K, N = shape
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        plan, resp = service_matmul_tiles(svc, M, K, N)
    assert resp.bucketed and resp.source == "search"
    assert plan.modeled_s is None
    assert kernel_takes(*plan.tiles, K, 2)
    assert all(t <= max(d, 8) for t, d in zip(plan.tiles, shape))


def test_decode_score_bucket_rides_the_exact_kv_1024_entry(tmp_path):
    """Decode attention's score matmul at kv 1000 is 15 kv blocks, which
    bucket to the 16 of kv 1024: a bucket hit on that shape's entry."""
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        exact, _ = service_matmul_tiles(svc, 1, 64, 1024,
                                        allow_bucketed=False)
        plan, resp = service_matmul_tiles(svc, 1, 64, 1000)
    assert resp.source == "bucket-hit" and resp.bucketed
    assert resp.served_einsum.rank_shapes == {"m": 1, "k": 1, "n": 16}
    assert plan.tiles == exact.tiles == (1, 64, 512)
    assert kernel_takes(*plan.tiles, 64, 2)


MEASURE_KEYS_NOT_PORTED = {"interpret"}


def test_measure_matmul_cpu_keys_and_output(tmp_path):
    with RefService(cache_root=tmp_path / "ref",
                    background_warm=False) as ref_svc:
        ref_row = ref_measure_matmul(ref_svc, 128, 128, 128, repeats=1,
                                     interpret=True)
    with MappingService(cache_root=tmp_path / "port",
                        background_warm=False) as svc:
        row, out = measure_matmul(svc, 128, 256, 256, repeats=1,
                                  device="cpu", dtype=torch.float32, seed=3,
                                  return_out=True)
        again = measure_matmul(svc, 128, 256, 256, repeats=1, device="cpu",
                               dtype=torch.float32, seed=3)
    assert set(row) == set(ref_row) - MEASURE_KEYS_NOT_PORTED | {"device"}
    assert row["device"] == "cpu" and row["kernel"] == "matmul"
    assert (row["map_source"], again["map_source"]) == ("search",
                                                        "exact-hit")
    assert row["gap_bound"] == 1.0 and row["modeled_s"] > 0
    assert tuple(row["tiles"]) == tcm_matmul_plan(128, 256, 256,
                                                  word_bytes=4).tiles
    # the timed call's output at the served tiles against the reference's
    # Pallas kernel (interpret mode) on the same operands and tiles
    gen = torch.Generator().manual_seed(3)
    a = _randn((128, 256), torch.float32, torch.device("cpu"), gen)
    b = _randn((256, 256), torch.float32, torch.device("cpu"), gen)
    bm, bk, bn = row["tiles"]
    want = np.asarray(matmul_pallas(a.numpy(), b.numpy(), bm=bm, bk=bk,
                                    bn=bn, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-3, rtol=1e-3)


def test_measure_flash_attention_cpu_keys_and_output(tmp_path):
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        row, out = measure_flash_attention(
            svc, B=1, H=2, Sq=128, Sk=128, Dh=64, causal=True, repeats=1,
            device="cpu", dtype=torch.float32, seed=4, return_out=True)
    ref_keys = {"kernel", "shape", "tiles", "default_tiles", "map_source",
                "map_latency_ms", "gap_bound", "measured_s", "default_s",
                "speedup_vs_default", "modeled_s", "measured_vs_modeled",
                "interpret"}
    assert set(row) == ref_keys - MEASURE_KEYS_NOT_PORTED | {"device"}
    assert row["kernel"] == "flash_attention" and row["device"] == "cpu"
    assert row["shape"] == [1, 2, 128, 128, 64]
    gen = torch.Generator().manual_seed(4)
    q, k, v = (_randn((1, 128, 2, 64), torch.float32, torch.device("cpu"),
                      gen) for _ in range(3))
    bq, bkv = row["tiles"]
    want = np.asarray(flash_attention_pallas(
        q.numpy(), k.numpy(), v.numpy(), causal=True, bq=bq, bk=bkv,
        interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)


def test_tile_request_shapes_cover_the_main_path():
    """The route's traffic: qwen1.5-0.5b's matmuls at drawn batches and
    ragged lengths, lm_head included, the same for the same seed."""
    cfg = get_config("qwen1_5_0_5b")
    shapes = tile_request_shapes(cfg, requests=300, seed=5)
    assert shapes == tile_request_shapes(cfg, requests=300, seed=5)
    assert len(shapes) == 300 and shapes != tile_request_shapes(
        cfg, requests=300, seed=6)
    assert {(M, K, N) for M, K, N in shapes if N == cfg.vocab}
    assert any(M % 64 for M, _, _ in shapes if M > 8)  # ragged prefill
    assert any(N % 64 for M, K, N in shapes if K == cfg.d_head)  # kv
    assert {M for M, K, N in shapes if K == cfg.d_model
            and N == cfg.d_model} >= {1, 2, 4, 8}


def test_tile_load_serves_kernel_tiles(tmp_path):
    """A warmed service answers the route's traffic from its indexes with
    tiles the kernel takes (exact hits: the offline plan's tile); a cold
    stampede runs one search and the other clients ride it."""
    cfg = get_config("qwen1_5_0_5b")
    shapes = tile_request_shapes(cfg, requests=80, seed=0)
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        rep = run_tile_load(svc, shapes, clients=4,
                            stampede=(1, cfg.d_head, 2051))
        again = run_tile_load(svc, shapes, clients=1, warmup=False)
    for r in (rep, again):
        assert r["requests"] == 80 and r["refused"] == 0
        assert r["searches"] == 0 and r["hits"] == 80
        assert set(r["sources"]) <= {"exact-hit", "bucket-hit"}
        assert r["deadline_met_ratio"] == 1.0
        assert 0 < r["hit_p50_ms"] <= r["hit_p99_ms"]
        assert r["tile_p50_ms"] >= r["hit_p50_ms"]
    assert rep["warmup_searches"] == rep["unique_buckets"]
    assert again["warmup_searches"] == 0
    assert (rep["stampede_searches"], rep["stampede_coalesced"]) == (1, 3)
    assert rep["coalesce_ratio"] == 0.75 and "coalesce_ratio" not in again
    for (M, K, N), (tile, source) in rep["served"].items():
        assert kernel_takes(*tile, K, 2)
        if source == "exact-hit":
            assert tile == tcm_matmul_plan(M, K, N).tiles
    assert again["served"] == rep["served"]


def test_measure_needs_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        with pytest.raises(RuntimeError, match="CUDA"):
            measure_matmul(svc, 64, 64, 64)


def test_bench_cli_gates_and_cpu_measure(tmp_path, capsys):
    out = tmp_path / "r.json"
    rc = serve_main(["bench", "--fast", "--requests", "16", "--clients", "4",
                     "--seq-max", "256", "--gate-hit-p99-ms", "50",
                     "--gate-deadline-ratio", "0.95",
                     "--gate-coalesce-ratio", "0.5", "--measure",
                     "--device", "cpu", "--json", str(out)])
    assert rc == 0, capsys.readouterr().err
    report = json.loads(out.read_text())
    assert report["gate_failures"] == []
    assert report["stampede_searches"] == 1
    assert [r["device"] for r in report["measure"]] == ["cpu", "cpu"]
    assert "[cpu]" in capsys.readouterr().out


def test_serve_cli_second_request_is_an_exact_hit(tmp_path, monkeypatch,
                                                  capsys):
    lines = [json.dumps({"einsum": R.einsum_to_dict(R.matmul(name, 8, 16,
                                                             4))})
             for name in ("first", "renamed")] + ["{\"bad\": 1}"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve_main(["serve", "--cache-dir", str(tmp_path)]) == 0
    first, second, bad = map(json.loads,
                             capsys.readouterr().out.splitlines())
    assert first["ok"] and first["source"] == "search"
    assert second["source"] == "exact-hit"
    assert second["edp"] == first["edp"]
    assert second["mapping"] == first["mapping"]
    assert bad["ok"] is False


def test_mapper_packages_import_without_torch_jax_or_repro():
    """Search workers import these modules: they must not load torch (nor
    touch the parent's CUDA context), jax or the reference package.  The
    model stack beside ``models.config`` computes with torch and is not
    imported by the mapper.  The data pipeline is numpy only as well.
    Only ``TCM_JIT=1`` changes that, by design: a worker's first criteria
    call then imports ``kernels.criteria`` (torch) and opens a CUDA context
    of its own, because the route runs the search's inner step on the card
    (``tests/test_torch_criteria.py`` holds the switch off to no torch)."""
    pkgs = ("core", "dse", "gap", "testing", "obs", "netmap", "serve_map",
            "configs", "models", "data")
    with_torch = {"serve_map/measure.py"} | {
        f"models/{m}.py" for m in ("layers", "ssm", "rglru", "lm", "weights")}
    mods = ["repro_torch"] + sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for pkg in pkgs for p in (PORT / pkg).rglob("*.py")
        if p.relative_to(PORT).as_posix() not in with_torch)
    code = ("import sys, importlib\n"
            "for m in ('torch', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "repro_torch.serve_map.service" in mods
    assert "repro_torch.netmap.__main__" in mods
    assert "repro_torch.models.config" in mods
    assert "repro_torch.data.pipeline" in mods
    assert {"repro_torch.dse.explore", "repro_torch.dse.__main__",
            "repro_torch.gap.soundness", "repro_torch.gap.__main__",
            "repro_torch.testing.faults", "repro_torch.core.baselines",
            "repro_torch.core.bruteforce",
            "repro_torch.core.shard_planner"} <= set(mods)
