"""The twin of ``tests/test_resilience.py`` on ``repro_torch``: fault-tolerant
execution + checkpoint/resume.

Covers, each held to the reference's values where it returns an optimum:

  * a scripted worker crash mid-search still returns the value-identical
    optimum (bounded retry on a fresh pool, nonzero recovery counters);
  * a poison unit is quarantined after bounded retries with a replayable
    JSON repro, and the run's certificate honestly degrades to
    ``gap_bound=inf`` (one subtree was never searched);
  * engines journal finished work units so an interrupted run resumes
    without re-searching, and a SIGINT'd DSE sweep reaches the same
    Pareto frontier as an uninterrupted one;
  * engine lifecycle is safe: context-manager protocol, idempotent close.

Fault scripting uses ``repro_torch.testing.faults`` (marker-file claims =>
exactly-n-times semantics across processes and retries).
"""
import os

import pytest

import repro.core as R
from repro_torch.core.arch import Arch, MemLevel
from repro_torch.core.budget import SearchBudget
from repro_torch.core.einsum import batched_matmul, matmul
from repro_torch.core.journal import (SearchCheckpoint, replay_unit,
                                     unit_from_repro)
from repro_torch.core.mapper import tcm_map
from repro_torch.core.search import (ProcessPoolEngine, SerialEngine,
                               clear_search_caches)
from repro_torch.testing.faults import installed, write_plan

EINSUM = matmul("mm", 4, 4, 4)
ARCH = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                  MemLevel("GLB", 12, 1, 1, 1e9)), mac_energy=0.5)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_search_caches()
    yield
    clear_search_caches()


def _values(r):
    return (r.energy, r.latency, r.edp)


def _ref_values():
    """The reference's optimum of the same einsum on the same arch
    (computed outside any installed fault plan: both packages' searches
    read ``TCM_FAULT_PLAN``)."""
    best, _ = R.tcm_map(R.einsum_from_dict(R.einsum_to_dict(EINSUM)),
                        R.arch_from_dict(R.arch_to_dict(ARCH)))
    return _values(best)


# --------------------------------------------------------------------------
# engine lifecycle
# --------------------------------------------------------------------------


def test_engines_are_context_managers():
    with SerialEngine() as eng:
        best, _ = tcm_map(EINSUM, ARCH, engine=eng)
    assert best is not None
    with ProcessPoolEngine(workers=2) as eng:
        best_p, _ = tcm_map(EINSUM, ARCH, engine=eng)
    assert _values(best_p) == _values(best)


def test_pool_close_is_idempotent():
    eng = ProcessPoolEngine(workers=2)
    best, _ = tcm_map(EINSUM, ARCH, engine=eng)
    assert best is not None
    eng.close()
    eng.close()  # second close is a no-op, not an error
    with ProcessPoolEngine(workers=2) as eng2:
        pass
    eng2.close()  # close after __exit__ likewise


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------


def test_worker_crash_recovers_value_identical(tmp_path):
    ref, _ = tcm_map(EINSUM, ARCH)
    plan = write_plan(tmp_path / "plan.json", tmp_path / "state",
                      crash={0: 1})
    with installed(plan):
        with ProcessPoolEngine(workers=2) as eng:
            got, stats = tcm_map(EINSUM, ARCH, engine=eng)
            recovered = (eng.fault_stats["retries"]
                         + eng.fault_stats["serial_fallbacks"])
    assert got is not None and _values(got) == _values(ref)
    assert _values(got) == _ref_values()
    assert recovered > 0
    assert stats.n_retried_units > 0
    assert eng.fault_stats["quarantined"] == 0
    assert not stats.truncated  # every unit finished (on retry)


def test_crash_markers_make_faults_one_shot(tmp_path):
    """The same plan fires exactly once: a second run under it is clean."""
    plan = write_plan(tmp_path / "plan.json", tmp_path / "state",
                      crash={0: 1})
    with installed(plan):
        with ProcessPoolEngine(workers=2) as eng:
            tcm_map(EINSUM, ARCH, engine=eng)
            first = dict(eng.fault_stats)
        with ProcessPoolEngine(workers=2) as eng2:
            got, _ = tcm_map(EINSUM, ARCH, engine=eng2)
            second = dict(eng2.fault_stats)
    assert first["retries"] > 0 or first["serial_fallbacks"] > 0
    assert second == {"retries": 0, "pool_restarts": 0,
                      "serial_fallbacks": 0, "quarantined": 0}
    assert got is not None


def test_poison_unit_quarantined_with_replayable_repro(tmp_path):
    qdir = tmp_path / "quarantine"
    plan = write_plan(tmp_path / "plan.json", tmp_path / "state",
                      exc={1: 999})  # deterministic: fails every attempt
    with installed(plan):
        with ProcessPoolEngine(workers=2, quarantine_dir=str(qdir)) as eng:
            got, stats = tcm_map(EINSUM, ARCH, engine=eng)
            q = eng.fault_stats["quarantined"]
    assert q >= 1
    assert stats.n_quarantined_units >= 1
    # the certificate honestly degrades: one subtree was never searched
    assert stats.truncated and stats.gap_bound == float("inf")
    repros = sorted(os.listdir(qdir))
    assert len(repros) == q
    # the repro is self-contained and replayable (outside the fault plan
    # it runs clean and yields the unit's real result)
    path = qdir / repros[0]
    import json

    rec = json.loads(path.read_text())
    unit = unit_from_repro(rec)
    assert dict(unit.einsum.rank_shapes) == dict(EINSUM.rank_shapes)
    result = replay_unit(path)
    assert result.candidate is not None or result.stats.n_expanded >= 0
    # the port's repro replays in the reference to the same unit result
    from repro.core.journal import replay_unit as ref_replay_unit
    want = ref_replay_unit(path)
    assert (result.candidate is None) == (want.candidate is None)
    assert result.stats.n_expanded == want.stats.n_expanded


def test_injected_interrupt_surfaces_to_caller(tmp_path):
    """KeyboardInterrupt is never swallowed by tcm_map itself — drivers
    with partial-report semantics (netmap, dse) catch it above."""
    plan = write_plan(tmp_path / "plan.json", tmp_path / "state",
                      interrupt={0: 1})
    with installed(plan):
        with pytest.raises(KeyboardInterrupt):
            tcm_map(EINSUM, ARCH)
        # the marker is consumed: the retry completes normally
        best, _ = tcm_map(EINSUM, ARCH)
    assert best is not None


# --------------------------------------------------------------------------
# checkpoint / resume
# --------------------------------------------------------------------------


def test_serial_checkpoint_resume_value_identical(tmp_path):
    ref, st_ref = tcm_map(EINSUM, ARCH)
    ck = SearchCheckpoint(root=tmp_path)
    best1, st1 = tcm_map(EINSUM, ARCH, checkpoint=ck)
    assert ck.puts > 0 and st1.n_resumed_units == 0
    assert _values(best1) == _values(ref)

    # a fresh process would re-open the journal from disk
    ck2 = SearchCheckpoint(root=tmp_path)
    assert len(ck2) == ck.puts
    best2, st2 = tcm_map(EINSUM, ARCH, checkpoint=ck2)
    assert ck2.hits > 0
    assert st2.n_resumed_units == ck2.hits
    assert best2.mapping == ref.mapping
    assert _values(best2) == _values(ref) == _ref_values()


def test_pool_checkpoint_resume_value_identical(tmp_path):
    ref, _ = tcm_map(EINSUM, ARCH)
    ck = SearchCheckpoint(root=tmp_path)
    with ProcessPoolEngine(workers=2, checkpoint=ck) as eng:
        best1, _ = tcm_map(EINSUM, ARCH, engine=eng)
    assert ck.puts > 0
    assert _values(best1) == _values(ref)

    ck2 = SearchCheckpoint(root=tmp_path)
    with ProcessPoolEngine(workers=2, checkpoint=ck2) as eng:
        best2, st2 = tcm_map(EINSUM, ARCH, engine=eng)
    assert ck2.hits > 0 and st2.n_resumed_units == ck2.hits
    assert _values(best2) == _values(ref)


def test_truncated_results_are_not_journaled(tmp_path):
    """Budget-expired units must be re-run on resume, so journaling them
    would defeat the point."""
    ck = SearchCheckpoint(root=tmp_path)
    _, stats = tcm_map(EINSUM, ARCH, budget=SearchBudget(deadline_s=0.0),
                       checkpoint=ck)
    assert stats.truncated
    assert ck.puts == 0
    assert len(SearchCheckpoint(root=tmp_path)) == 0


def test_checkpoint_key_ignores_names_but_not_structure(tmp_path):
    """Checkpoint addressing follows the cache's structural-identity
    discipline: renames hit, shape changes miss."""
    ck = SearchCheckpoint(root=tmp_path)
    tcm_map(EINSUM, ARCH, checkpoint=ck)
    n = ck.puts

    ck2 = SearchCheckpoint(root=tmp_path)
    _, st = tcm_map(matmul("renamed", 4, 4, 4), ARCH, checkpoint=ck2)
    assert ck2.hits == n and st.n_resumed_units == n

    ck3 = SearchCheckpoint(root=tmp_path)
    tcm_map(matmul("mm", 4, 4, 8), ARCH, checkpoint=ck3)
    assert ck3.hits == 0


def test_checkpoint_survives_torn_trailing_line(tmp_path):
    from repro_torch.testing.faults import tear_last_line

    ck = SearchCheckpoint(root=tmp_path)
    tcm_map(EINSUM, ARCH, checkpoint=ck)
    assert ck.puts >= 2  # need a survivor after tearing the last line
    tear_last_line(ck.path)
    reloaded = SearchCheckpoint(root=tmp_path)
    assert reloaded.n_corrupt == 1
    assert len(reloaded) == ck.puts - 1


def test_sigint_then_resume_dse_reaches_same_frontier(tmp_path):
    """A Ctrl-C'd DSE sweep resumed from its journal ends on the same
    Pareto frontier as an uninterrupted sweep."""
    from repro_torch.dse import explore_space, get_space

    space = get_space("edge-small")
    einsums = [batched_matmul("fqk", 8, 4, 32, 64),
               batched_matmul("fav", 8, 4, 64, 32)]

    def sig(report):
        return sorted((r.arch_key, r.objective, r.energy, r.latency)
                      for r in report.frontier)

    base = explore_space(space, einsums, "edp")
    assert not base.interrupted and base.frontier

    # interrupt mid-search of the first point (unit 2 of its first einsum):
    # units 0-1 are already journaled when the SIGINT lands
    plan = write_plan(tmp_path / "plan.json", tmp_path / "state",
                      interrupt={2: 1})
    ck = SearchCheckpoint(root=tmp_path)
    with installed(plan):
        partial = explore_space(space, einsums, "edp", checkpoint=ck)
    assert partial.interrupted
    assert ck.puts > 0
    assert len(partial.frontier) == 0 or sig(partial) != sig(base)

    ck2 = SearchCheckpoint(root=tmp_path)
    resumed = explore_space(space, einsums, "edp", checkpoint=ck2)
    assert not resumed.interrupted
    assert ck2.hits > 0  # journaled units were served, not re-searched
    assert sig(resumed) == sig(base)
    from repro.dse import explore_space as ref_explore_space
    from repro.dse import get_space as ref_get_space
    want = ref_explore_space(ref_get_space("edge-small"), [
        R.batched_matmul("fqk", 8, 4, 32, 64),
        R.batched_matmul("fav", 8, 4, 64, 32)], "edp")
    assert sig(resumed) == sig(want)
