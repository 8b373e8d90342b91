"""Randomized optimality and gap-soundness checks on the port (hypothesis
property tests): the twins of ``tests/test_optimality_property.py`` and
``tests/test_gap_property.py`` on ``repro_torch``.

Skips cleanly when the optional ``hypothesis`` dependency is not
installed, as the reference's do.
"""
import pytest

pytest.importorskip(
    "hypothesis",
    reason="optional dependency: pip install hypothesis "
           "(see requirements.txt)")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core.arch import Arch, MemLevel  # noqa: E402
from repro_torch.core.baselines import (evolutionary,  # noqa: E402
                                        simulated_annealing)
from repro_torch.core.einsum import matmul  # noqa: E402
from repro_torch.core.looptree import validate_structure  # noqa: E402
from repro_torch.core.mapper import tcm_map  # noqa: E402

from test_torch_optimality import _check  # noqa: E402

REL_EPS = 1e-9


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    m=st.sampled_from([2, 3, 4]),
    k=st.sampled_from([2, 4]),
    n=st.sampled_from([2, 3]),
    cap=st.sampled_from([4, 8, 16, 64]),
    dram_e=st.sampled_from([50.0, 200.0]),
    glb_e=st.sampled_from([0.5, 2.0]),
    bw_ratio=st.sampled_from([5.0, 50.0]),
)
def test_property_tcm_matches_bruteforce(m, k, n, cap, dram_e, glb_e,
                                         bw_ratio):
    ein = matmul("mm", m, k, n)
    arch = Arch("a", (
        MemLevel("DRAM", float("inf"), dram_e, dram_e, 1e9 / bw_ratio),
        MemLevel("GLB", cap, glb_e, glb_e, 1e9)), mac_energy=0.5)
    _check(ein, arch)


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    m=st.sampled_from([2, 3, 4]),
    k=st.sampled_from([2, 4]),
    n=st.sampled_from([2, 3]),
    cap=st.sampled_from([8, 16, 64]),
    dram_e=st.sampled_from([50.0, 200.0]),
    objective=st.sampled_from(["edp", "energy", "latency"]),
    seed=st.integers(min_value=0, max_value=2 ** 16),
)
def test_property_metaheuristics_never_beat_tcm(m, k, n, cap, dram_e,
                                                objective, seed):
    """SA and the evolutionary mapper search TCM's own mapspace, so no draw
    may land strictly below ``tcm_map``'s optimum, and every best mapping
    must be structurally legal."""
    ein = matmul("mm", m, k, n)
    arch = Arch("a", (
        MemLevel("DRAM", float("inf"), dram_e, dram_e, 1e8),
        MemLevel("GLB", cap, 1.0, 1.0, 1e9)), mac_energy=0.5)
    best, _ = tcm_map(ein, arch, objective=objective)
    opt = best.objective(objective) if best is not None else float("inf")
    for fn in (simulated_annealing, evolutionary):
        r = fn(ein, arch, budget_evals=30, seed=seed, objective=objective)
        assert r.objective(objective) >= opt * (1 - REL_EPS), \
            f"{fn.__name__} beat the claimed optimum — pruning bug"
        if r.best_mapping is not None:
            validate_structure(ein, arch, r.best_mapping)
