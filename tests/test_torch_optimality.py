"""TCM's central claim on the port: the pruned search finds the *optimal*
mapping.  The twin of ``tests/test_optimality.py``: ``repro_torch``'s
``tcm_map`` against its own exhaustive enumeration of the unpruned
mapspace (``repro_torch.core.bruteforce``) on small workloads.  The
randomized draws live in ``test_torch_gap_property.py``.
"""
from repro_torch.core.arch import Arch, MemLevel, SpatialFanout
from repro_torch.core.bruteforce import brute_force_optimum
from repro_torch.core.einsum import Einsum, TensorSpec, matmul
from repro_torch.core.mapper import tcm_map

RTOL = 1e-9


def _check(ein, arch, objective="edp", keep_unit_loops=False):
    best, _ = tcm_map(ein, arch, objective=objective)
    bf = brute_force_optimum(ein, arch, objective=objective,
                             keep_unit_loops=keep_unit_loops)
    if bf is None:
        assert best is None, "TCM found a mapping where none is valid"
        return None, None
    assert best is not None, "TCM found nothing but a valid mapping exists"
    tcm_obj = best.objective(objective)
    bf_obj = {"edp": bf.result.edp, "energy": bf.result.energy,
              "latency": bf.result.latency}[objective]
    assert tcm_obj <= bf_obj * (1 + RTOL), (
        f"TCM suboptimal: {tcm_obj} > brute force {bf_obj}")
    assert tcm_obj >= bf_obj * (1 - RTOL), (
        f"TCM better than brute force?! {tcm_obj} < {bf_obj} (model bug)")
    return best, bf


def test_matmul_two_level():
    ein = matmul("mm", 4, 4, 2)
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 12, 1, 1, 1e9)), mac_energy=0.5)
    _check(ein, arch)


def test_matmul_tight_capacity():
    ein = matmul("mm", 4, 4, 4)
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 6, 1, 1, 1e9)), mac_energy=0.5)
    _check(ein, arch)


def test_matmul_three_level():
    ein = matmul("mm", 2, 4, 2)
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 10, 2, 2, 1e9),
                      MemLevel("RF", 4, 0.2, 0.2, 2e9)), mac_energy=0.5)
    _check(ein, arch)


def test_matmul_spatial():
    ein = matmul("mm", 2, 4, 2)
    arch = Arch(
        "sp",
        (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
         MemLevel("GLB", 24, 1, 1, 1e9)),
        fanouts=(SpatialFanout(above_level=0, dims=(2, 2),
                               multicast_tensor=("A", None),
                               reduce_tensor=(None, "Z")),),
        mac_energy=0.5)
    _check(ein, arch)


def test_objective_energy_and_latency():
    ein = matmul("mm", 4, 4, 2)
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 16, 1, 1, 1e9)), mac_energy=0.5)
    _check(ein, arch, objective="energy")
    _check(ein, arch, objective="latency")


def test_conv_with_affine_dims():
    ein = Einsum(
        name="c",
        tensors=(
            TensorSpec("A", (("p", "r"),)),
            TensorSpec("W", ("r",)),
            TensorSpec("Z", ("p",), is_output=True),
        ),
        rank_shapes={"p": 4, "r": 3},
    )
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 8, 1, 1, 1e9)), mac_energy=0.5)
    _check(ein, arch, keep_unit_loops=True)


def test_restricted_level_tensors():
    ein = matmul("mm", 4, 4, 2)
    arch = Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("WB", 8, 0.5, 0.5, 1e9,
                               allowed_tensors=("B",))), mac_energy=0.5)
    _check(ein, arch)
