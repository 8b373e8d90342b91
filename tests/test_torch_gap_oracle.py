"""The port's brute-force oracle (``repro_torch.core.bruteforce``): the twin
of ``tests/test_bruteforce.py`` on the port, and the oracle against the
reference's — enumeration counts, optimum and rendered mapping equal.
"""
import pytest

import repro.core as R
from repro.core.bruteforce import brute_force_optimum as ref_brute_force
from repro.core.looptree import render as ref_render
from repro_torch.core.arch import Arch, MemLevel, SpatialFanout, arch_to_dict
from repro_torch.core.bruteforce import (_ordered_factorizations,
                                         brute_force_optimum)
from repro_torch.core.einsum import (Einsum, TensorSpec, batched_matmul,
                                     einsum_to_dict, matmul)
from repro_torch.core.looptree import render
from repro_torch.core.mapper import count_ordered_factorizations, tcm_map

RTOL = 1e-9


@pytest.mark.parametrize("n", [1, 2, 4, 6, 12, 16, 30])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ordered_factorizations_count_matches_closed_form(n, k):
    tuples = list(_ordered_factorizations(n, k))
    for t in tuples:
        assert len(t) == k
        prod = 1
        for f in t:
            prod *= f
        assert prod == n
    assert len(set(tuples)) == len(tuples)
    assert len(tuples) == int(count_ordered_factorizations(n, k))


def _toy_arch(cap=16, fan=False):
    fanouts = ()
    if fan:
        fanouts = (SpatialFanout(above_level=1, dims=(2, 2),
                                 multicast_tensor=("A", None),
                                 reduce_tensor=(None, "Z")),)
    return Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", cap, 1, 1, 1e9)),
                fanouts=fanouts, mac_energy=0.5)


def _matvec():
    return Einsum("mv", (TensorSpec("A", ("m", "k")),
                         TensorSpec("x", ("k",)),
                         TensorSpec("Z", ("m",), is_output=True)),
                  {"m": 4, "k": 3})


def test_keep_unit_loops_parity_without_affine_dims():
    """Unit loops are exact no-ops when no tensor has affine dims: both
    enumerations must agree on the optimum (False just enumerates less)."""
    arch = _toy_arch()
    full = brute_force_optimum(_matvec(), arch, keep_unit_loops=True)
    slim = brute_force_optimum(_matvec(), arch, keep_unit_loops=False)
    assert full is not None and slim is not None
    assert slim.n_enumerated < full.n_enumerated
    assert slim.result.edp == pytest.approx(full.result.edp, rel=RTOL)
    assert slim.result.energy == pytest.approx(full.result.energy, rel=RTOL)
    assert slim.result.latency == pytest.approx(full.result.latency,
                                                rel=RTOL)


EINSUMS = [matmul("mm", 4, 3, 2), matmul("mm2", 6, 2, 2),
           batched_matmul("bmm", 2, 2, 3, 2)]


@pytest.mark.parametrize("objective", ["edp", "energy", "latency"])
@pytest.mark.parametrize("ein", EINSUMS, ids=lambda e: e.name)
@pytest.mark.parametrize("fan", [False, True], ids=["flat", "fanout"])
def test_oracle_agrees_with_tcm(ein, fan, objective):
    arch = _toy_arch(cap=16, fan=fan)
    bf = brute_force_optimum(ein, arch, objective=objective,
                             keep_unit_loops=False)
    best, _ = tcm_map(ein, arch, objective=objective)
    assert (bf is None) == (best is None)
    if bf is None:
        return
    bf_obj = {"edp": bf.result.edp, "energy": bf.result.energy,
              "latency": bf.result.latency}[objective]
    assert best.objective(objective) == pytest.approx(bf_obj, rel=RTOL)
    assert bf.n_valid > 0


# --------------------------------------------------------------------------
# the oracle against the reference's
# --------------------------------------------------------------------------

def _oracle_summary(bf, render_fn):
    if bf is None:
        return None
    return (bf.n_enumerated, bf.n_valid, bf.result.energy,
            bf.result.latency, bf.result.edp, render_fn(bf.mapping))


@pytest.mark.parametrize("ein,fan,objective,keep", [
    (EINSUMS[0], False, "edp", False),
    (EINSUMS[1], True, "energy", False),
    (EINSUMS[2], True, "latency", False),
    (_matvec(), False, "edp", True),
], ids=["mm-flat-edp", "mm2-fanout-energy", "bmm-fanout-latency",
        "matvec-unit-loops"])
def test_oracle_equals_reference(ein, fan, objective, keep):
    arch = _toy_arch(cap=16, fan=fan)
    got = brute_force_optimum(ein, arch, objective=objective,
                              keep_unit_loops=keep)
    want = ref_brute_force(R.einsum_from_dict(einsum_to_dict(ein)),
                           R.arch_from_dict(arch_to_dict(arch)),
                           objective=objective, keep_unit_loops=keep)
    assert got is not None
    assert _oracle_summary(got, render) == _oracle_summary(want, ref_render)


def test_ordered_factorizations_equal_reference():
    from repro.core.bruteforce import _ordered_factorizations as ref_of
    for n in (1, 6, 12, 30):
        for k in (1, 2, 3):
            assert list(_ordered_factorizations(n, k)) == list(ref_of(n, k))
