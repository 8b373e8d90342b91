"""The port's gap harness (``repro_torch.gap``): the twin of
``tests/test_gap.py`` on the port, and the port against the reference.

The twins pin the harness's contracts on ``repro_torch``: gym samples are
legal and deterministic, moves stay inside the mapspace, gap curves never
dip below 1.0, fuzz cases round-trip through JSON.  The parity tests run
both packages on the same inputs: ``GapReport`` JSON and tables are equal
with the wall-clock fields masked, fuzz verdicts at the same
``derive_seed`` are equal, a planted false optimum gives the same
violations and minimized repros in both, and a ``gap_violation_*.json``
written by either package replays in the other.
"""
import json
import random
import re
import sys

import pytest

import repro.core as R
from repro.gap import soundness as ref_snd
from repro.gap.__main__ import main as ref_gap_main
from repro.gap.runner import run_gap as ref_run_gap
from repro_torch.core.arch import Arch, MemLevel, SpatialFanout, arch_to_dict
from repro_torch.core.einsum import (Einsum, TensorSpec, batched_matmul,
                                     einsum_from_dict, einsum_to_dict,
                                     matmul)
from repro_torch.core.looptree import validate_structure
from repro_torch.core.mapper import tcm_map
from repro_torch.core.refmodel import evaluate
from repro_torch.gap import MapspaceGym, objective_value
from repro_torch.gap import soundness as snd
from repro_torch.gap.__main__ import main as gap_main
from repro_torch.gap.runner import derive_seed, parse_budgets, run_gap
from repro_torch.gap.soundness import (CASE_BUDGET, FuzzCase, check_case,
                                       fuzz, random_case)

REL_EPS = 1e-9


def _setup():
    ein = matmul("mm", 16, 8, 4)
    arch = Arch("sp",
                (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                 MemLevel("GLB", 256, 1, 1, 1e9)),
                fanouts=(SpatialFanout(above_level=1, dims=(2, 2),
                                       multicast_tensor=("A", None),
                                       reduce_tensor=(None, "Z")),),
                mac_energy=0.5)
    return ein, arch


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _to_ref(ein, arch):
    return (R.einsum_from_dict(einsum_to_dict(ein)),
            R.arch_from_dict(arch_to_dict(arch)))


# --------------------------------------------------------------------------
# twins of tests/test_gap.py
# --------------------------------------------------------------------------

def test_gym_samples_are_legal_mappings(setup):
    ein, arch = setup
    gym = MapspaceGym(ein, arch)
    rng = random.Random(0)
    for _ in range(25):
        p = gym.random_point(rng)
        assert p is not None
        m = gym.mapping(p)
        validate_structure(ein, arch, m)
        res = gym.evaluate(p)
        assert res.edp == evaluate(ein, arch, m).edp
    assert gym.n_evals == 25


def test_gym_sampling_deterministic(setup):
    ein, arch = setup
    pts_a = [MapspaceGym(ein, arch).random_point(random.Random(7))
             for _ in range(3)]
    pts_b = [MapspaceGym(ein, arch).random_point(random.Random(7))
             for _ in range(3)]
    assert pts_a == pts_b


def test_gym_moves_stay_inside_the_mapspace(setup):
    ein, arch = setup
    gym = MapspaceGym(ein, arch)
    rng = random.Random(1)
    p = gym.random_point(rng)
    for _ in range(40):
        q = gym.perturb(p, rng)
        if q is None:
            continue
        validate_structure(ein, arch, gym.mapping(q))
        c = gym.crossover(p, q, rng)
        validate_structure(ein, arch, gym.mapping(c))
        p = q


def test_objective_value_rejects_unknown_kind(setup):
    ein, arch = setup
    gym = MapspaceGym(ein, arch)
    res = gym.evaluate(gym.random_point(random.Random(2)))
    assert objective_value(res, "edp") == res.edp
    with pytest.raises(ValueError, match="unknown objective kind"):
        objective_value(res, "area")


def test_parse_budgets():
    assert parse_budgets("1e2..1e4") == [100, 1000, 10000]
    assert parse_budgets("100,500") == [100, 500]
    assert parse_budgets("1e3..1e3") == [1000]


def test_derive_seed_is_stable_and_distinct():
    from repro.gap.runner import derive_seed as ref_derive_seed
    a = derive_seed(0, "QK", "tpu", "sa", 100)
    assert a == derive_seed(0, "QK", "tpu", "sa", 100)
    assert a != derive_seed(0, "QK", "tpu", "sa", 1000)
    assert a != derive_seed(1, "QK", "tpu", "sa", 100)
    assert a == ref_derive_seed(0, "QK", "tpu", "sa", 100)


def test_runner_curves_never_dip_below_optimum(setup):
    ein, arch = setup
    report = run_gap({"mm": ein}, {"toy": arch}, budgets=[60, 120],
                     objectives=("edp", "latency"), seed=3)
    assert not report.violations
    assert len(report.curves) == 2 * 5  # 2 objectives x 5 baselines
    for c in report.curves:
        opt = report.optima[(c.workload, c.arch, c.objective_kind)]
        for p in c.points:
            assert p.objective >= opt * (1 - REL_EPS)
            assert p.gap >= 1 - REL_EPS
    d = report.to_dict()
    assert d["violations"] == []
    json.dumps(d)
    assert "soundness" in report.render()


def test_fuzz_small_run_is_clean_and_counts():
    report = fuzz(6, seed=0, verbose=False)
    assert report.ok, [v.detail for v in report.violations]
    assert report.n_cases == 6
    assert report.n_oracle_checked == 6
    assert report.n_baseline_runs == 6 * 3
    json.dumps(report.to_dict())


def test_fuzz_case_roundtrips_through_json():
    case = random_case(random.Random(11))
    back = FuzzCase.from_dict(json.loads(json.dumps(case.to_dict())))
    assert back.seed == case.seed
    assert back.objective == case.objective
    assert back.einsum == case.einsum
    assert arch_to_dict(back.arch) == arch_to_dict(case.arch)
    assert [v.kind for v in check_case(case, oracle=False)[0]] == \
        [v.kind for v in check_case(back, oracle=False)[0]]


def test_einsum_dict_roundtrip():
    conv = Einsum("c", (TensorSpec("A", (("p", "r"),)),
                        TensorSpec("W", ("r",)),
                        TensorSpec("Z", ("p",), is_output=True)),
                  {"p": 4, "r": 3})
    for ein in (matmul("mm", 6, 4, 2), batched_matmul("b", 2, 3, 2, 2),
                conv):
        assert einsum_from_dict(einsum_to_dict(ein)) == ein
        assert R.einsum_to_dict(R.einsum_from_dict(
            einsum_to_dict(ein))) == einsum_to_dict(ein)


def test_detector_catches_a_planted_false_optimum(setup):
    ein, arch = setup
    best, _ = tcm_map(ein, arch, objective="edp")
    opt = best.objective("edp")
    from repro_torch.core.baselines import simulated_annealing
    r = simulated_annealing(ein, arch, budget_evals=CASE_BUDGET, seed=9)
    obj = r.objective("edp")
    assert obj >= opt * (1 - REL_EPS)
    fake_opt = obj * 1.5
    assert obj < fake_opt * (1 - REL_EPS)


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------

def _masked(d):
    """A gap/fuzz report dict without its wall-clock fields
    (``tcm_wall_s``, each point's ``wall_s``, the fuzz ``wall_s``)."""
    if isinstance(d, dict):
        return {k: _masked(v) for k, v in d.items()
                if not k.endswith("wall_s")}
    if isinstance(d, list):
        return [_masked(v) for v in d]
    return d


def _masked_render(text):
    text = re.sub(r"\(\d+\.\d+s\)", "(-s)", text)
    return re.sub(r"in \d+\.\d+s", "in -s", text)


@pytest.mark.parametrize("objectives", [("edp", "latency"), ("energy",)],
                         ids=["edp+latency", "energy"])
def test_gap_report_equals_reference(setup, objectives):
    ein, arch = setup
    got = run_gap({"mm": ein}, {"toy": arch}, budgets=[60, 120],
                  objectives=objectives, seed=3)
    want = ref_run_gap({"mm": _to_ref(ein, arch)[0]},
                       {"toy": _to_ref(ein, arch)[1]}, budgets=[60, 120],
                       objectives=objectives, seed=3)
    assert _masked(got.to_dict()) == _masked(want.to_dict())
    assert _masked_render(got.render()) == _masked_render(want.render())


@pytest.mark.parametrize("base", [0, 1])
def test_fuzz_verdicts_equal_reference(base):
    """Campaigns drawn from the same ``derive_seed`` give the same cases,
    counters and verdicts in both packages."""
    seed = derive_seed(base, "fuzz-parity")
    got, want = fuzz(3, seed=seed), ref_snd.fuzz(3, seed=seed)
    assert _masked(got.to_dict()) == _masked(want.to_dict())
    rng_p, rng_r = random.Random(seed), random.Random(seed)
    for i in range(3):
        assert random_case(rng_p, snd.OBJECTIVES[i % 3]).to_dict() == \
            ref_snd.random_case(rng_r, ref_snd.OBJECTIVES[i % 3]).to_dict()


class _Inflated:
    """A claimed optimum 1.5x above the real one: the false optimum an
    unsound pruning would report."""

    def __init__(self, best):
        self.best = best

    def objective(self, kind):
        return self.best.objective(kind) * 1.5


def _plant(monkeypatch, module):
    real = module.tcm_map

    def inflated(*args, **kwargs):
        best, stats = real(*args, **kwargs)
        return (None if best is None else _Inflated(best)), stats

    monkeypatch.setattr(module, "tcm_map", inflated)


def _planted_case(case_cls):
    """A tiny case for the planted-optimum checks: 4x2x2 matmul, a
    64-word buffer (minimization can halve both)."""
    ein = matmul("fz_mm", 4, 2, 2)
    arch = Arch("fuzz", (MemLevel("DRAM", float("inf"), 100.0, 100.0, 1e8),
                         MemLevel("GLB", 64, 1.0, 1.0, 1e9)),
                mac_energy=0.5)
    return case_cls.from_dict(FuzzCase(seed=derive_seed(0, "planted"),
                                       einsum=ein, arch=arch,
                                       objective="edp").to_dict())


@pytest.fixture(scope="module")
def planted():
    """A planted false optimum in both packages: one campaign each, and
    the first violation of a tiny case minimized by each."""
    mp = pytest.MonkeyPatch()
    _plant(mp, snd)
    _plant(mp, ref_snd)
    try:
        seed = derive_seed(0, "planted")
        got = fuzz(1, seed=seed, minimize=False)
        want = ref_snd.fuzz(1, seed=seed, minimize=False)
        cases = _planted_case(FuzzCase), _planted_case(ref_snd.FuzzCase)
        vs = snd.check_case(cases[0])[0], ref_snd.check_case(cases[1])[0]
        vs[0][0].minimized = snd.minimize_case(cases[0])
        vs[1][0].minimized = ref_snd.minimize_case(cases[1])
    finally:
        mp.undo()
    return got, want, vs[0], vs[1]


def test_planted_violations_equal_reference(planted):
    got, want, _, _ = planted
    assert not got.ok
    assert {v.kind for v in got.violations} >= {"oracle_mismatch",
                                                "baseline_beats_optimum"}
    assert _masked(got.to_dict()) == _masked(want.to_dict())


def test_planted_minimized_repro_equals_reference(planted):
    _, _, got, want = planted
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
    small = got[0].minimized
    assert small is not None
    assert small.to_dict() != got[0].case.to_dict()  # it did shrink


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_violation_repro_replays_in_the_other_package(
        planted, tmp_path, monkeypatch, writer):
    _, _, got, want = planted
    write = {"reference": ref_snd.write_repro, "port": snd.write_repro}
    path = tmp_path / "gap_violation_0.json"
    write[writer]((want if writer == "reference" else got)[0], str(path))
    other = {"reference": snd, "port": ref_snd}[writer]
    # the bug fixed (no planted optimum): the repro replays clean
    violations, n_runs = other.replay(str(path))
    assert violations == [] and n_runs == 3
    # the bug present in both: the same violations again
    _plant(monkeypatch, snd)
    _plant(monkeypatch, ref_snd)
    got_v, _ = snd.replay(str(path))
    want_v, _ = ref_snd.replay(str(path))
    assert got_v and [(v.kind, v.detail) for v in got_v] == \
        [(v.kind, v.detail) for v in want_v]


def test_cli_gap_json_equals_reference(tmp_path, capsys, monkeypatch):
    out = {}
    for name, main in (("reference", ref_gap_main), ("port", gap_main)):
        path = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", [
            "gap", "--workload", "P0,Q", "--arch", "nvdla", "--budgets",
            "100,300", "--objective", "edp,latency", "--json", str(path)])
        assert main() == 0
        text = capsys.readouterr().out
        out[name] = (_masked(json.loads(path.read_text())),
                     _masked_render(text))
    assert out["port"] == out["reference"]
    assert all(p["gap"] >= 1 - REL_EPS for c in out["port"][0]["curves"]
               for p in c["points"])


def test_cli_soundness_json_equals_reference(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a violation's repro is written to the cwd
    out = {}
    for name, main in (("reference", ref_gap_main), ("port", gap_main)):
        path = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", [
            "gap", "--mode", "soundness", "--cases", "3", "--seed", "4",
            "--json", str(path)])
        assert main() == 0
        out[name] = (_masked(json.loads(path.read_text())),
                     _masked_render(capsys.readouterr().out))
    assert out["port"] == out["reference"]
    assert out["port"][0]["ok"] and out["port"][0]["n_cases"] == 3

