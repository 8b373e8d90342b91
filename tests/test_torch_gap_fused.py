"""The port's fused-group soundness checks: the twin of
``tests/test_gap_fused.py`` on ``repro_torch``, and the fused fuzzer and
its exhaustive oracle against the reference's.
"""
import random

import pytest

from repro.gap import soundness as ref_snd
from repro_torch.core.arch import Arch, MemLevel
from repro_torch.core.einsum import batched_matmul
from repro_torch.core.fusion import FusedWorkload, GroupEdge
from repro_torch.core.mapper import tcm_map, tcm_map_group
from repro_torch.core.presets import tpu_v4i_like
from repro_torch.gap import FusedMapspaceGym
from repro_torch.gap import soundness as snd

REL_EPS = 1e-9


@pytest.fixture(scope="module")
def fused_setup():
    qk = batched_matmul("fqk", 8, 4, 32, 64)
    av = batched_matmul("fav", 8, 4, 64, 32)
    group = FusedWorkload("qk+av", (qk, av), (GroupEdge(0, 1, "Z", "A"),))
    arch = tpu_v4i_like()
    bq, _ = tcm_map(qk, arch)
    ba, _ = tcm_map(av, arch)
    fused, _ = tcm_map_group(
        group, arch,
        inc_obj=(bq.energy + ba.energy) * (bq.latency + ba.latency))
    assert fused is not None
    return group, arch, fused


def test_fused_random_samples_never_beat_group_optimum(fused_setup):
    group, arch, fused = fused_setup
    gym = FusedMapspaceGym(group, arch)
    rng = random.Random(0)
    n_valid = 0
    for _ in range(200):
        p = gym.random_point(rng)
        if p is None:
            continue
        res = gym.evaluate(p)
        if not res.valid:
            continue
        n_valid += 1
        assert res.edp >= fused.edp * (1 - REL_EPS), \
            "a random joint mapping beat tcm_map_group — fused pruning bug"
    assert n_valid >= 50, f"only {n_valid}/200 sampled points were valid"


def test_fused_gym_counts_and_determinism(fused_setup):
    group, arch, _ = fused_setup
    a = FusedMapspaceGym(group, arch)
    b = FusedMapspaceGym(group, arch)
    assert len(a.units) == len(b.units) > 0
    pa = a.random_point(random.Random(3))
    pb = b.random_point(random.Random(3))
    assert pa == pb
    ra, rb = a.evaluate(pa), b.evaluate(pb)
    assert (ra.energy, ra.latency, ra.valid) == (rb.energy, rb.latency,
                                                 rb.valid)
    assert a.n_evals == 1


def _tiny_case(shapes=(2, 2, 2, 2, 2), cap=32, objective="edp", module=snd):
    """A tiny fused cascade case of ``module`` (the port's ``soundness`` or
    the reference's, carried across as its wire dict)."""
    arch = Arch("fz_fused",
                (MemLevel("DRAM", float("inf"), 100.0, 100.0, 1e8),
                 MemLevel("GLB", cap, 1.0, 1.0, 1e9)),
                mac_energy=0.5)
    case = snd.FusedFuzzCase(seed=7, shapes=shapes, arch=arch,
                             objective=objective)
    return module.FusedFuzzCase.from_dict(case.to_dict())


@pytest.mark.parametrize("objective", ["edp", "energy", "latency"])
def test_check_fused_case_tiny_cascade_clean(objective):
    violations, n_searches = snd.check_fused_case(
        _tiny_case(objective=objective))
    assert violations == []
    assert n_searches == 4


def test_fused_exhaustive_oracle_matches_group_search():
    case = _tiny_case(shapes=(2, 2, 4, 2, 4))
    oracle = snd._fused_exhaustive_optimum(case)
    fused, _ = tcm_map_group(case.group(), case.arch)
    assert fused is not None and oracle < float("inf")
    assert fused.edp == pytest.approx(oracle, rel=1e-9)


def test_fuzz_fused_small_campaign_clean():
    report = snd.fuzz_fused(8, seed=5, minimize=False)
    assert report.ok, [v.detail for v in report.violations]
    assert report.n_cases == 8
    assert 0 < report.n_oracle_checked <= 8
    assert report.n_baseline_runs == 4 * report.n_oracle_checked


def test_fused_case_dict_roundtrip():
    case = snd.random_fused_case(random.Random(11))
    back = snd.FusedFuzzCase.from_dict(case.to_dict())
    assert back.seed == case.seed
    assert back.shapes == case.shapes
    assert back.objective == case.objective
    assert back.to_dict() == case.to_dict()


def test_replay_dispatches_fused_repro(tmp_path):
    case = _tiny_case()
    v = snd.SoundnessViolation("fused_oracle_mismatch", "synthetic", case)
    path = tmp_path / "fused_repro.json"
    snd.write_repro(v, str(path))
    violations, n_searches = snd.replay(str(path))
    assert violations == []
    assert n_searches == 4


def test_minimize_fused_case_shrinks_while_violating(monkeypatch):
    case = _tiny_case(shapes=(4, 4, 4, 4, 4), cap=64)
    monkeypatch.setattr(
        snd, "_violates_fused",
        lambda c: all(s >= 2 for s in c.shapes))
    small = snd.minimize_fused_case(case)
    assert all(s >= 2 for s in small.shapes)
    assert sum(small.shapes) < sum(case.shapes)
    small.group()


# --------------------------------------------------------------------------
# the fused fuzzer against the reference's
# --------------------------------------------------------------------------

def _masked(d):
    return {k: v for k, v in d.items() if k != "wall_s"}


def test_fuzz_fused_campaign_equals_reference():
    got = snd.fuzz_fused(5, seed=3, minimize=False)
    want = ref_snd.fuzz_fused(5, seed=3, minimize=False)
    assert _masked(got.to_dict()) == _masked(want.to_dict())
    rp, rr = random.Random(3), random.Random(3)
    for _ in range(5):
        assert snd.random_fused_case(rp).to_dict() == \
            ref_snd.random_fused_case(rr).to_dict()


@pytest.mark.parametrize("shapes", [(2, 2, 4, 2, 4), (2, 4, 2, 2, 2)])
def test_fused_exhaustive_oracle_equals_reference(shapes):
    got = snd._fused_exhaustive_optimum(_tiny_case(shapes=shapes))
    want = ref_snd._fused_exhaustive_optimum(
        _tiny_case(shapes=shapes, module=ref_snd))
    assert got == want < float("inf")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fused_repro_replays_in_the_other_package(tmp_path, writer):
    mod = {"reference": ref_snd, "port": snd}[writer]
    other = {"reference": snd, "port": ref_snd}[writer]
    v = mod.SoundnessViolation("fused_oracle_mismatch", "synthetic",
                               _tiny_case(module=mod))
    path = tmp_path / "gap_violation_0.json"
    mod.write_repro(v, str(path))
    violations, n_searches = other.replay(str(path))
    assert violations == [] and n_searches == 4
