"""The port's metaheuristic baselines (``repro_torch.core.baselines``): the
twin of ``tests/test_baselines.py`` on the port, and every baseline of the
gap harness against the reference's at seeds 0 and 1 — objective,
``n_evaluated``, ``n_valid`` and the rendered best mapping equal — on a
toy spatial arch and on the H100 plan arch the kernels are tiled on.
"""
import pytest

import repro.core as R
from repro.core.looptree import render as ref_render
from repro.gap.runner import BASELINES as REF_BASELINES
from repro_torch.core.arch import (Arch, MemLevel, SpatialFanout,
                                   arch_to_dict)
from repro_torch.core.autotile import plan_arch, plan_einsum
from repro_torch.core.baselines import (evolutionary, loma_like,
                                        simulated_annealing, timeloop_like)
from repro_torch.core.einsum import einsum_to_dict, matmul
from repro_torch.core.looptree import render, validate_structure
from repro_torch.core.mapper import tcm_map
from repro_torch.gap.runner import BASELINES


def _toy():
    ein = matmul("mm", 64, 32, 16)
    arch = Arch(
        "sp",
        (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
         MemLevel("GLB", 2048, 1, 1, 1e9)),
        fanouts=(SpatialFanout(above_level=1, dims=(8, 8),
                               multicast_tensor=("A", None),
                               reduce_tensor=(None, "Z")),),
        mac_energy=0.5)
    return ein, arch


@pytest.fixture(scope="module")
def setup():
    return _toy()


# --------------------------------------------------------------------------
# twins of tests/test_baselines.py
# --------------------------------------------------------------------------

def test_timeloop_like_finds_valid(setup):
    ein, arch = setup
    r = timeloop_like(ein, arch, budget_evals=200, seed=1)
    assert r.n_valid > 0
    assert r.best is not None and r.best.valid


def test_hint_beats_pure_random_usually(setup):
    ein, arch = setup
    rnd = timeloop_like(ein, arch, budget_evals=300, seed=2)
    hint = timeloop_like(ein, arch, budget_evals=300, seed=2,
                         full_spatial_hint=True)
    assert hint.objective() <= rnd.objective() * 1.5


def test_loma_like_valid(setup):
    ein, arch = setup
    r = loma_like(ein, arch, budget_evals=200, lpf_limit=3, seed=3)
    assert r.best is not None and r.best.valid


def test_tcm_at_least_as_good_as_all_baselines(setup):
    """The paper's Table III qualitative result: TCM (optimal) <= baselines."""
    ein, arch = setup
    best, _ = tcm_map(ein, arch)
    assert best is not None
    for r in (timeloop_like(ein, arch, 500, seed=4),
              timeloop_like(ein, arch, 500, seed=4, full_spatial_hint=True),
              loma_like(ein, arch, 500, lpf_limit=3, seed=4),
              simulated_annealing(ein, arch, 500, seed=4),
              evolutionary(ein, arch, 500, seed=4)):
        assert best.edp <= r.objective("edp") * (1 + 1e-9)


def test_sa_and_ga_find_valid_structures(setup):
    ein, arch = setup
    for fn in (simulated_annealing, evolutionary):
        r = fn(ein, arch, budget_evals=200, seed=5)
        assert r.n_valid > 0
        assert r.best is not None and r.best.valid
        assert r.n_evaluated <= 200 + 1
        validate_structure(ein, arch, r.best_mapping)


def test_objective_rejects_unknown_kind(setup):
    ein, arch = setup
    r = timeloop_like(ein, arch, budget_evals=20, seed=6)
    with pytest.raises(ValueError, match="unknown objective kind"):
        r.objective("power")
    for fn in (timeloop_like, loma_like, simulated_annealing, evolutionary):
        with pytest.raises(ValueError, match="unknown objective kind"):
            fn(ein, arch, budget_evals=10, seed=6, objective="power")


def test_all_baselines_deterministic_under_seed(setup):
    ein, arch = setup
    for fn, kwargs in ((timeloop_like, {}),
                       (loma_like, {"lpf_limit": 3}),
                       (simulated_annealing, {}),
                       (evolutionary, {})):
        a = fn(ein, arch, budget_evals=150, seed=7, **kwargs)
        b = fn(ein, arch, budget_evals=150, seed=7, **kwargs)
        assert a.objective("edp") == b.objective("edp")
        assert a.n_evaluated == b.n_evaluated
        assert a.n_valid == b.n_valid
        assert a.best_mapping == b.best_mapping
        c = fn(ein, arch, budget_evals=150, seed=8, **kwargs)
        assert (a.n_valid, a.best_mapping) != (c.n_valid, c.best_mapping) or \
            a.objective("edp") == c.objective("edp")


# --------------------------------------------------------------------------
# every baseline against the reference's, seed for seed
# --------------------------------------------------------------------------

# (einsum, arch, eval budget, objective): the toy spatial arch, and the
# bf16 plan arch at qwen1.5-0.5b's prefill up/gate shape
CASES = {
    "toy-edp": lambda: (*_toy(), 200, "edp"),
    "h100-latency": lambda: (plan_einsum(1024, 1024, 2816), plan_arch(),
                             1000, "latency"),
}


@pytest.fixture(scope="module")
def cases():
    return {k: make() for k, make in CASES.items()}


def _summary(r, kind, render_fn):
    return (r.objective(kind), r.n_evaluated, r.n_valid,
            None if r.best_mapping is None else render_fn(r.best_mapping))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_equals_reference(cases, case, seed, name):
    ein, arch, budget, kind = cases[case]
    ref_ein = R.einsum_from_dict(einsum_to_dict(ein))
    ref_arch = R.arch_from_dict(arch_to_dict(arch))
    got = BASELINES[name](ein, arch, budget, seed, kind)
    want = REF_BASELINES[name](ref_ein, ref_arch, budget, seed, kind)
    assert _summary(got, kind, render) == _summary(want, kind, ref_render)
    if got.best is not None:
        assert (got.best.energy, got.best.latency, got.best.edp) == \
            (want.best.energy, want.best.latency, want.best.edp)


def test_registries_name_the_same_baselines():
    assert list(BASELINES) == list(REF_BASELINES)
