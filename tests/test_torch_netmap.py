"""The port's network planner, mapping cache, presets and search journal
against the reference's, on the CPU.

Both packages plan the same smoke-scale model; the reports must agree
exactly, and a cache or journal written by either package must read as
hits in the other (the wire format and ``CACHE_VERSION`` are shared).
"""
import json
import os

import pytest

import repro.core as R
import repro_torch.core as P
from repro.configs import get_config as ref_get_config
from repro.core import presets as ref_presets
from repro.core.journal import SearchCheckpoint as RefCheckpoint
from repro.core.journal import replay_unit as ref_replay_unit
from repro.core.wire import fused_mapping_to_wire as ref_fused_to_wire
from repro.netmap import MappingCache as RefCache
from repro.netmap import map_network as ref_map_network
from repro.netmap.cache import CACHE_VERSION as REF_CACHE_VERSION
from repro.netmap.cache import mapping_to_wire as ref_mapping_to_wire
from repro_torch.configs import get_config
from repro_torch.core import presets
from repro_torch.core.journal import SearchCheckpoint, unit_from_repro
from repro_torch.core.search import (ProcessPoolEngine, SerialEngine,
                                     clear_search_caches, run_work_unit)
from repro_torch.core.wire import fused_mapping_to_wire
from repro_torch.netmap import CACHE_VERSION, MappingCache, map_network
from repro_torch.netmap.__main__ import ACCEL
from repro_torch.netmap.__main__ import main as netmap_main
from repro_torch.netmap.cache import mapping_to_wire

PRESETS = ["tpu_v4i_like", "nvdla_like", "tpu_v5e_like"]
KW = dict(mode="decode", batch=2, seq=32)
EINSUM = (4, 4, 4)
ARCH_D = R.arch_to_dict(R.Arch("a", (
    R.MemLevel("DRAM", float("inf"), 100, 100, 1e8),
    R.MemLevel("GLB", 12, 1, 1, 1e9)), mac_energy=0.5))


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_search_caches()
    yield
    clear_search_caches()


def _arches():
    ref = ref_presets.nvdla_like(tensors=("A", "B", "Z"))
    return ref, P.arch_from_dict(R.arch_to_dict(ref))


def _ref_report(cache=None, **kw):
    return ref_map_network(ref_get_config("qwen1_5_0_5b", smoke=True),
                           _arches()[0], cache=cache, **KW, **kw)


def _port_report(cache=None, **kw):
    return map_network(get_config("qwen1_5_0_5b", smoke=True), _arches()[1],
                       cache=cache, **KW, **kw)


def _fusion_rows(rep, to_wire):
    return [(f.ops, f.shape, f.n_instances, f.unfused_energy,
             f.unfused_latency, f.adopted, f.pin_level,
             None if f.result is None else
             (f.result.energy, f.result.latency, f.result.edp,
              to_wire(f.result.mapping)))
            for f in rep.fused]


def _unique_rows(rep, to_wire):
    return [(u.op, u.shape, u.n_uses, u.result.energy, u.result.latency,
             to_wire(u.result.mapping)) for u in rep.unique]


@pytest.mark.parametrize("fuse", [True, False])
def test_map_network_matches_reference(fuse):
    ref, port = _ref_report(fuse=fuse), _port_report(fuse=fuse)
    assert port.layer_totals() == ref.layer_totals()
    assert (port.total_energy, port.total_latency, port.total_edp) == \
        (ref.total_energy, ref.total_latency, ref.total_edp)
    assert _unique_rows(port, mapping_to_wire) == \
        _unique_rows(ref, ref_mapping_to_wire)
    assert _fusion_rows(port, fused_mapping_to_wire) == \
        _fusion_rows(ref, ref_fused_to_wire)
    assert bool(port.fused) == fuse
    assert [(r.layer, r.op, r.energy, r.latency) for r in port.rows] == \
        [(r.layer, r.op, r.energy, r.latency) for r in ref.rows]


def test_cache_version_shared():
    assert CACHE_VERSION == REF_CACHE_VERSION == 4


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_reads_as_hits_in_the_other_package(tmp_path, writer):
    """Singleton and fused-group entries written by one package are hits
    in the other, and compose to the same report."""
    if writer == "reference":
        cold = _ref_report(cache=RefCache(root=tmp_path))
        warm = _port_report(cache=MappingCache(root=tmp_path))
    else:
        cold = _port_report(cache=MappingCache(root=tmp_path))
        warm = _ref_report(cache=RefCache(root=tmp_path))
    n = len(cold.unique) + len(cold.fused)
    assert cold.cache_misses == n and cold.cache_hits == 0
    assert warm.cache_misses == 0 and warm.cache_hits == n
    assert warm.total_edp == cold.total_edp
    assert warm.layer_totals() == cold.layer_totals()


def test_cli_second_run_is_all_hits(tmp_path, capsys):
    args = ["--config", "qwen1_5_0_5b", "--fast",
            "--cache-dir", str(tmp_path / "cache"),
            "--json", str(tmp_path / "report.json")]
    assert netmap_main(args) == 0
    out = capsys.readouterr().out
    assert "network totals" in out and "hit rate 0%" in out
    assert "fusion groups" in out
    assert netmap_main(args) == 0
    out = capsys.readouterr().out
    assert "hit rate 100%" in out and "persistent cache" in out
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["cache"]["hit_rate"] == 1.0


def test_cli_accel_presets_are_the_references():
    from repro.netmap.__main__ import ACCEL as REF_ACCEL

    assert sorted(ACCEL) == sorted(REF_ACCEL) == ["nvdla", "tpu_v4i",
                                                  "tpu_v5e"]
    for name, make in ACCEL.items():
        assert P.arch_to_dict(make()) == R.arch_to_dict(REF_ACCEL[name]())


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    for tensors in (("A", "B", "Z"), ("A", "W", "Z")):
        assert P.arch_to_dict(getattr(presets, name)(tensors)) == \
            R.arch_to_dict(getattr(ref_presets, name)(tensors))


def test_preset_workloads_match_reference():
    for fn in ("gpt3_einsums", "mobilenetv3_einsums", "small_matmul_suite"):
        port, ref = getattr(presets, fn)(), getattr(ref_presets, fn)()
        assert list(port) == list(ref)
        assert [P.einsum_to_dict(e) for e in port.values()] == \
            [R.einsum_to_dict(e) for e in ref.values()]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_search_journal_reads_both_ways(tmp_path, writer):
    ein_d, arch_d = R.einsum_to_dict(R.matmul("mm", *EINSUM)), ARCH_D
    ref_args = (R.einsum_from_dict(ein_d), R.arch_from_dict(arch_d))
    port_args = (P.einsum_from_dict(ein_d), P.arch_from_dict(arch_d))
    if writer == "reference":
        ck = RefCheckpoint(root=tmp_path)
        first, _ = R.tcm_map(*ref_args, checkpoint=ck)
        ck2 = SearchCheckpoint(root=tmp_path)
        again, st = P.tcm_map(*port_args, checkpoint=ck2)
    else:
        ck = SearchCheckpoint(root=tmp_path)
        first, _ = P.tcm_map(*port_args, checkpoint=ck)
        ck2 = RefCheckpoint(root=tmp_path)
        again, st = R.tcm_map(*ref_args, checkpoint=ck2)
    assert ck.puts > 0 and ck2.hits == ck.puts
    assert st.n_resumed_units == ck2.hits
    assert (again.energy, again.latency, again.edp) == \
        (first.energy, first.latency, first.edp)


def test_quarantine_writes_a_replayable_repro(tmp_path):
    """A unit the pool gives up on is written as a repro under
    ``quarantine_dir``; the reference replays it to the unit's result."""
    units = []

    class Recording(SerialEngine):
        def run(self, batch, *args, **kw):
            units.extend(batch)
            return super().run(batch, *args, **kw)

    P.tcm_map(P.matmul("mm", *EINSUM), P.arch_from_dict(ARCH_D),
              engine=Recording())
    qdir = tmp_path / "quarantine"
    eng = ProcessPoolEngine(workers=1, quarantine_dir=str(qdir))
    try:
        placeholder = eng._give_up_result(None)(units[0], "boom", 3)
    finally:
        eng.close()
    assert placeholder.truncated and placeholder.lower_bound == 0.0
    assert placeholder.stats.n_quarantined_units == 1
    assert eng.fault_stats["quarantined"] == 1
    (name,) = os.listdir(qdir)
    rec = json.loads((qdir / name).read_text())
    assert rec["error"] == "boom" and rec["attempts"] == 3
    assert unit_from_repro(rec).skeleton == units[0].skeleton
    want = run_work_unit(units[0])
    got = ref_replay_unit(qdir / name)
    assert (got.candidate is None) == (want.candidate is None)
    assert got.stats.n_expanded == want.stats.n_expanded
