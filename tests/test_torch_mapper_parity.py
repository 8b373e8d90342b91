"""The port's copy of the mapper against the reference, bit for bit.

The same workload goes to ``repro.core.tcm_map`` and, carried across as
wire dicts (``arch_to_dict`` / ``einsum_to_dict``), to
``repro_torch.core.tcm_map``; the optima must agree exactly.
"""
import dataclasses

import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import autotile as ref_autotile
from repro.core.presets import tpu_v4i_like
from repro_torch.core import autotile as port_autotile

EINSUMS = {
    "matmul": lambda: R.matmul("mm", 8, 16, 4),
    "batched_matmul": lambda: R.batched_matmul("bmm", 2, 4, 8, 4),
    "conv1d": lambda: R.conv1d("conv", 8, 3, 4, 8),
}
ARCHS = {
    "v5e_core": lambda names: ref_autotile._v5e_core(512),
    "tpu_v4i": lambda names: tpu_v4i_like(names),
    "h100_sm": lambda names: R.arch_from_dict(
        P.arch_to_dict(port_autotile._h100_sm(14))),
    # the bf16 plan's HBM -> RF(Z) -> SMEM(A, B) arch, built by the port
    "h100_wgmma": lambda names: R.arch_from_dict(
        P.arch_to_dict(port_autotile._h100_wgmma(7))),
}
# conv1d on the TPU-v4i preset takes seconds per side; the other pairs
# cover the conv einsum.  The wgmma arch admits only tensors A, B and Z, so
# conv1d (A, W, Z) has no mapping there.
CASES = [(e, a) for e in EINSUMS for a in ARCHS
         if (e, a) not in (("conv1d", "tpu_v4i"), ("conv1d", "h100_wgmma"))]


def _nodes(mapping):
    return [(type(n).__name__, dataclasses.astuple(n)) for n in mapping]


def _both(ein_name, arch_name, objective="edp"):
    ein = EINSUMS[ein_name]()
    arch = ARCHS[arch_name](tuple(t.name for t in ein.tensors))
    ref, ref_stats = R.tcm_map(ein, arch, objective=objective)
    port_ein = P.einsum_from_dict(R.einsum_to_dict(ein))
    port_arch = P.arch_from_dict(R.arch_to_dict(arch))
    port, port_stats = P.tcm_map(port_ein, port_arch, objective=objective)
    return ein, port_ein, ref, ref_stats, port, port_stats


@pytest.mark.parametrize("ein_name,arch_name", CASES)
def test_tcm_map_bit_identical(ein_name, arch_name):
    _, _, ref, ref_stats, port, port_stats = _both(ein_name, arch_name)
    assert ref is not None and port is not None
    assert port.energy == ref.energy
    assert port.latency == ref.latency
    assert port.edp == ref.edp
    assert _nodes(port.mapping) == _nodes(ref.mapping)
    assert port_stats.n_expanded == ref_stats.n_expanded


def test_wire_dicts_round_trip():
    for make in EINSUMS.values():
        ein = make()
        assert P.einsum_to_dict(P.einsum_from_dict(
            R.einsum_to_dict(ein))) == R.einsum_to_dict(ein)
    arch = tpu_v4i_like()
    assert P.arch_to_dict(P.arch_from_dict(
        R.arch_to_dict(arch))) == R.arch_to_dict(arch)


@pytest.mark.parametrize("arch_name", ["v5e_core", "h100_sm", "h100_wgmma"])
def test_tile_products_copies_agree(arch_name):
    ein, port_ein, ref, _, port, _ = _both("matmul", arch_name,
                                           objective="latency")
    assert (port_autotile._tile_products(port, port_ein)
            == ref_autotile._tile_products(ref, ein))


def test_wgmma_plan_arch_bit_identical_on_qwen_shape():
    """The bf16 plan's own arch and block einsum (qwen prefill 1024^3 in
    64-blocks) through wire dicts into ``repro.core.tcm_map``."""
    arch = port_autotile.plan_arch(word_bytes=2)
    ein = P.matmul("mm", 16, 16, 16)
    port, port_stats = P.tcm_map(ein, arch, objective="latency")
    ref, ref_stats = R.tcm_map(R.einsum_from_dict(P.einsum_to_dict(ein)),
                               R.arch_from_dict(P.arch_to_dict(arch)),
                               objective="latency")
    assert (port.energy, port.latency, port.edp) == (ref.energy, ref.latency,
                                                     ref.edp)
    assert _nodes(port.mapping) == _nodes(ref.mapping)
    assert port_stats.n_expanded == ref_stats.n_expanded
