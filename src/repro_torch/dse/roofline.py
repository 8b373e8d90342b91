"""Optimistic roofline lower bounds on (energy, latency) per (einsum, arch).

The explorer uses these bounds twice: to *order* architecture points (most
promising first, so the incumbent tightens early) and to *prune* points that
provably cannot beat an already-searched point.  Both uses require the
bounds to be sound — never above what ``refmodel.evaluate`` can assign to
any valid mapping — so every term here is a provable floor of the model's
accounting:

  * **Compute latency**: every mapping runs ``macs`` MACs on at most
    ``total_compute_units`` units at ``frequency``.
  * **Backing-store latency**: every tensor crosses the level-0 boundary at
    least once in full (an input resident only at level 0 is read
    ``macs/disc >= size`` times by the compute node; one with children
    fetches at least the whole tensor through ``parent_reads``; outputs
    symmetrically on the write side).
  * **Energy**: ``macs * mac_energy`` exactly, plus a per-tensor floor that
    is the *minimum* over the two possible innermost placements — resident
    at the backing store (compute operand traffic priced at level-0 energy)
    or buffered on chip (full-tensor level-0 traffic plus compute operand
    traffic priced at the cheapest allowed on-chip level).
  * **Spatial discounts** are credited at their maximum: the product of the
    fanout dims that may multicast (inputs) / reduce (outputs) the tensor,
    capped by the iteration extent of rank vars irrelevant to it (a spatial
    loop can never exceed its var's bound).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from ..core.arch import Arch
from ..core.einsum import Einsum, TensorSpec


@dataclass(frozen=True)
class RooflineBound:
    """Per-(einsum, arch) floors; ``objective()`` combines them."""

    energy: float  # pJ
    latency: float  # s

    def objective(self, kind: str) -> float:
        if kind == "edp":
            return self.energy * self.latency
        if kind == "energy":
            return self.energy
        if kind == "latency":
            return self.latency
        raise ValueError(f"unknown objective {kind!r}")


def _max_discount(einsum: Einsum, arch: Arch, tensor: TensorSpec) -> float:
    """Largest spatial multicast/reduce credit any mapping can earn for
    ``tensor``: capable fanout dims, capped by the irrelevant-var extent."""
    capable = 1
    for f in arch.fanouts:
        for i, d in enumerate(f.dims):
            if tensor.is_output:
                if f.reduce_tensor[i] == tensor.name:
                    capable *= d
            elif f.multicast_tensor[i] == tensor.name:
                capable *= d
    irrelevant = 1
    for v, shape in einsum.rank_shapes.items():
        if v not in tensor.rank_vars():
            irrelevant *= shape
    return float(min(capable, irrelevant))


def _allowed(level, tensor: TensorSpec) -> bool:
    return level.allowed_tensors is None or tensor.name in level.allowed_tensors


def einsum_bounds(einsum: Einsum, arch: Arch) -> RooflineBound:
    """Sound (energy, latency) floor for mapping ``einsum`` on ``arch``."""
    macs = float(einsum.total_computes)
    dram = arch.levels[0]

    energy = macs * arch.mac_energy
    reads0 = 0.0  # level-0 word traffic floors, for the bandwidth term
    writes0 = 0.0
    for t in einsum.tensors:
        size = float(einsum.tensor_size(t))
        operand = macs / _max_discount(einsum, arch, t)
        onchip = [l for l in arch.levels[1:] if _allowed(l, t)]
        if t.is_output:
            writes0 += size
            resident = operand * (dram.read_energy + dram.write_energy)
            if onchip:
                cheapest = min(l.read_energy + l.write_energy for l in onchip)
                buffered = size * dram.write_energy + operand * cheapest
                energy += min(resident, buffered)
            else:
                energy += resident
        else:
            reads0 += size
            resident = operand * dram.read_energy
            if onchip:
                cheapest = min(l.read_energy for l in onchip)
                buffered = size * dram.read_energy + operand * cheapest
                energy += min(resident, buffered)
            else:
                energy += resident

    latency = macs / (arch.total_compute_units * arch.frequency)
    if dram.read_bandwidth is not None:
        wbw = dram.write_bandwidth or dram.read_bandwidth
        latency = max(latency, reads0 / dram.read_bandwidth, writes0 / wbw)
    else:
        latency = max(latency, (reads0 + writes0) / dram.bandwidth)
    return RooflineBound(energy=energy, latency=latency)


def workload_bounds(entries: Sequence[Tuple[Einsum, int]], arch: Arch
                    ) -> RooflineBound:
    """Floor for a whole workload: per-einsum floors, count-scaled and
    summed (members execute sequentially, energies and latencies add)."""
    energy = 0.0
    latency = 0.0
    for einsum, count in entries:
        b = einsum_bounds(einsum, arch)
        energy += count * b.energy
        latency += count * b.latency
    return RooflineBound(energy=energy, latency=latency)
