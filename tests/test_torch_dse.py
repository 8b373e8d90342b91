"""The port's design-space exploration (``repro_torch.dse``): the twin of
``tests/test_dse.py`` on the port, and the port against the reference.

The twins pin the explorer's contracts on ``repro_torch`` (pruned + seeded
frontier == exhaustive per-point search, roofline floors are sound, serial
and pool backends are value-identical, warm caches round-trip).  The parity
tests run both packages on the same space and workload: the frontier, the
report table and the CLI's ``--json`` must be equal, wall-clock fields
masked, and a ``.tcm_cache`` written by either package warm-starts the
other.
"""
import json
import re

import pytest

from repro.core.search import clear_search_caches as ref_clear
from repro.dse import explore_space as ref_explore_space
from repro.dse import get_space as ref_get_space
from repro.dse import resolve_workload as ref_resolve_workload
from repro.dse.__main__ import main as ref_dse_main
from repro.netmap.cache import MappingCache as RefCache
from repro_torch.core.arch import arch_to_dict
from repro_torch.core.einsum import batched_matmul, einsum_to_dict, matmul
from repro_torch.core.mapper import tcm_map, tcm_map_best_arch
from repro_torch.core.presets import small_matmul_suite
from repro_torch.core.search import clear_search_caches
from repro_torch.dse import (check_parity, einsum_bounds, explore_space,
                             get_space, pareto_keep, resolve_workload)
from repro_torch.dse.__main__ import main as dse_main
from repro_torch.netmap.cache import MappingCache


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_search_caches()
    ref_clear()
    yield
    clear_search_caches()
    ref_clear()


def tiny_pair():
    """The smoke attention pair (QK -> AV shapes, CI-sized)."""
    return [batched_matmul("fqk", 8, 4, 32, 64),
            batched_matmul("fav", 8, 4, 64, 32)]


def edge8():
    return get_space("edge-small")  # 12 combos -> 8 candidate points


def _frontier_sig(report):
    return sorted((r.arch_key, r.objective, r.energy, r.latency, r.area_mm2)
                  for r in report.frontier)


def _evaluated_sig(report):
    return sorted((r.arch_key, r.status, r.objective, r.energy, r.latency)
                  for r in report.rows)


# --------------------------------------------------------------------------
# Oracle: pruned + seeded explorer == exhaustive per-point search
# --------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["edp", "energy", "latency"])
def test_explorer_matches_exhaustive_frontier(objective):
    space, einsums = edge8(), tiny_pair()
    fast = explore_space(space, einsums, objective)
    slow = explore_space(space, einsums, objective, prune=False,
                         seed_incumbents=False)
    assert slow.n_evaluated == 8  # oracle really searched every point
    assert fast.n_pruned_roofline + fast.n_pruned_bound > 0
    assert _frontier_sig(fast) == _frontier_sig(slow)
    assert fast.best.arch_key == slow.best.arch_key
    assert fast.best.objective == slow.best.objective
    assert fast.n_expanded < slow.n_expanded


def test_explorer_evaluated_points_are_exact():
    """Seeded searches that survive the bound return true per-point optima:
    every evaluated row equals an independent unseeded tcm_map total."""
    space, einsums = edge8(), tiny_pair()
    rep = explore_space(space, einsums)
    points = {p.key: p for p in space.points()}
    checked = 0
    for row in rep.rows:
        if row.status != "evaluated":
            continue
        arch = points[row.arch_key].arch
        energy = latency = 0.0
        for e in einsums:
            best, _ = tcm_map(e, arch, collect_sizes=False)
            energy += best.energy
            latency += best.latency
        assert row.energy == energy
        assert row.latency == latency
        checked += 1
    assert checked >= 2


def test_serial_and_process_pool_value_identical():
    space, einsums = edge8(), tiny_pair()
    serial = explore_space(space, einsums)
    pool = explore_space(space, einsums, workers=2)
    assert _evaluated_sig(pool) == _evaluated_sig(serial)
    assert _frontier_sig(pool) == _frontier_sig(serial)
    assert pool.best.arch_key == serial.best.arch_key


def test_check_parity_helper():
    ok, msg = check_parity(edge8(), tiny_pair(), n_points=3)
    assert ok, msg
    assert "parity ok" in msg


def test_resolve_workload_and_named_spaces():
    es = resolve_workload("QK,FFA")
    assert [e.name for e in es] == ["QK", "FFA"]
    with pytest.raises(KeyError):
        resolve_workload("NOPE")
    assert get_space("edge").size == 16
    with pytest.raises(KeyError):
        get_space("nope")


def test_roofline_bounds_are_sound_floors():
    """No valid mapping may beat the roofline floor on energy or latency —
    checked against the true optimum on every point of the CI space."""
    suite = small_matmul_suite()
    einsums = [suite["P0"], tiny_pair()[0]]
    for point in edge8().points():
        for e in einsums:
            b = einsum_bounds(e, point.arch)
            for objective in ("energy", "latency"):
                best, _ = tcm_map(e, point.arch, objective=objective,
                                  collect_sizes=False)
                assert best is not None
                assert b.energy <= best.energy * (1 + 1e-12)
                assert b.latency <= best.latency * (1 + 1e-12)


def test_pareto_keep_semantics():
    pts = [(1.0, 5.0), (2.0, 4.0), (3.0, 3.0), (3.0, 5.0), (1.0, 5.0)]
    assert pareto_keep(pts) == [True, True, True, False, True]


def test_tcm_map_best_arch_matches_per_arch_min():
    qk = tiny_pair()[0]
    arches = [p.arch for p in edge8().points()][:4]
    per = [tcm_map(qk, a, collect_sizes=False)[0] for a in arches]
    want_idx = min(range(len(per)), key=lambda i: per[i].edp)
    idx, best, stats = tcm_map_best_arch(qk, arches)
    assert idx == want_idx
    assert (best.energy, best.latency, best.edp) == (
        per[want_idx].energy, per[want_idx].latency, per[want_idx].edp)
    assert stats.n_expanded > 0
    idx2, best2, _ = tcm_map_best_arch(qk, arches, workers=2)
    assert idx2 == idx and best2.edp == best.edp


def test_tcm_map_seeded_none_is_sound():
    qk = tiny_pair()[0]
    arch = edge8().template.instantiate()
    best, _ = tcm_map(qk, arch, collect_sizes=False)
    loose, _ = tcm_map(qk, arch, collect_sizes=False, inc_obj=best.edp * 2)
    assert loose is not None and loose.edp == best.edp
    tight, _ = tcm_map(qk, arch, collect_sizes=False, inc_obj=best.edp / 2)
    assert tight is None or tight.edp >= best.edp / 2


def test_sweep_warm_cache_round_trip(tmp_path):
    space, einsums = edge8(), tiny_pair()
    cold = explore_space(space, einsums, cache=MappingCache(root=tmp_path))
    assert cold.cache_misses > 0 and cold.cache_hits == 0
    clear_search_caches()
    warm = explore_space(space, einsums, cache=MappingCache(root=tmp_path))
    assert warm.cache_misses == 0
    assert warm.cache_hits == sum(r.cached for r in warm.rows)
    assert warm.t_search == 0.0
    assert _evaluated_sig(warm) == _evaluated_sig(cold)
    assert _frontier_sig(warm) == _frontier_sig(cold)


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------

def _masked(d):
    """A report dict with its wall-clock fields dropped: every ``t_*`` key
    (rows' ``t_search_s``, the search stats' phase times), the ``timing``
    block and ``*wall_s``."""
    if isinstance(d, dict):
        return {k: _masked(v) for k, v in d.items()
                if not (k.startswith("t_") or k == "timing"
                        or k.endswith("wall_s"))}
    if isinstance(d, list):
        return [_masked(v) for v in d]
    return d


def _masked_render(text):
    return re.sub(r"(?m)^  time: .*$", "  time: -", text)


def test_spaces_and_workloads_equal_the_references():
    for name in ("edge-small", "edge"):
        got, want = get_space(name), ref_get_space(name)
        assert got.size == want.size
        assert ([arch_to_dict(p.arch) for p in got.points()]
                == [arch_to_dict(p.arch) for p in want.points()])
        assert [p.key for p in got.points()] == [p.key
                                                 for p in want.points()]
    assert ([einsum_to_dict(e) for e in resolve_workload("QK,FFA,P0")]
            == [einsum_to_dict(e) for e in ref_resolve_workload("QK,FFA,P0")])


@pytest.fixture(scope="module")
def both_sweeps():
    """The reference's and the port's sweeps of edge-small x QK,FFA, for
    each objective, pruned and exhaustive."""
    out = {}
    for objective in ("edp", "latency"):
        for kw in ({}, {"prune": False, "seed_incumbents": False}):
            key = (objective, bool(kw))
            ref_clear()
            clear_search_caches()
            out[key] = (
                ref_explore_space(ref_get_space("edge-small"),
                                  ref_resolve_workload("QK,FFA"), objective,
                                  **kw),
                explore_space(get_space("edge-small"),
                              resolve_workload("QK,FFA"), objective, **kw))
    return out


@pytest.mark.parametrize("objective", ["edp", "latency"])
@pytest.mark.parametrize("exhaustive", [False, True],
                         ids=["pruned", "exhaustive"])
def test_sweep_report_equals_reference(both_sweeps, objective, exhaustive):
    want, got = both_sweeps[(objective, exhaustive)]
    assert _frontier_sig(got) == _frontier_sig(want)
    assert _evaluated_sig(got) == _evaluated_sig(want)
    assert got.n_expanded == want.n_expanded
    assert _masked(got.to_dict()) == _masked(want.to_dict())
    assert _masked_render(got.render()) == _masked_render(want.render())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sweep_cache_warm_starts_the_other_package(tmp_path, writer):
    space = {"reference": ref_get_space, "port": get_space}
    work = {"reference": ref_resolve_workload, "port": resolve_workload}
    explore = {"reference": ref_explore_space, "port": explore_space}
    cache = {"reference": RefCache, "port": MappingCache}
    reader = "port" if writer == "reference" else "reference"
    cold = explore[writer](space[writer]("edge-small"),
                           work[writer]("QK,FFA"),
                           cache=cache[writer](root=tmp_path))
    assert cold.cache_misses > 0 and cold.cache_hits == 0
    warm = explore[reader](space[reader]("edge-small"),
                           work[reader]("QK,FFA"),
                           cache=cache[reader](root=tmp_path))
    assert warm.cache_misses == 0 and warm.cache_hits > 0
    assert warm.t_search == 0.0
    assert _evaluated_sig(warm) == _evaluated_sig(cold)
    assert _frontier_sig(warm) == _frontier_sig(cold)


@pytest.mark.parametrize("argv", [
    ["--fast"],
    ["--space", "edge-small", "--workload", "QK,FFA", "--objective",
     "latency"],
    ["--fast", "--network", "qwen1_5_0_5b"],
], ids=["fast", "latency", "network"])
def test_cli_json_equals_reference(tmp_path, capsys, argv):
    out = {}
    for name, main in (("reference", ref_dse_main), ("port", dse_main)):
        ref_clear()
        clear_search_caches()
        path = tmp_path / f"{name}.json"
        assert main(argv + ["--json", str(path), "--cache-dir",
                            str(tmp_path / f"cache-{name}")]) == 0
        text = capsys.readouterr().out
        out[name] = (_masked(json.loads(path.read_text())),
                     _masked_render(text.replace(str(path), "PATH")))
    assert out["port"] == out["reference"]
    assert out["port"][0]["frontier"]


def test_cli_check_parity(capsys):
    assert dse_main(["--check-parity", "3"]) == 0
    assert "parity ok" in capsys.readouterr().out


def test_tiny_matmul_sweep_equals_reference():
    ein = matmul("mm", 64, 32, 16)
    from repro.core.einsum import matmul as rmatmul
    got = explore_space(get_space("edge-small"), [ein], "energy")
    want = ref_explore_space(ref_get_space("edge-small"),
                             [rmatmul("mm", 64, 32, 16)], "energy")
    assert _masked(got.to_dict()) == _masked(want.to_dict())
