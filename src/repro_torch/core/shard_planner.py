"""Beyond-paper: TCM over mesh axes — a sharding planner.

The paper maps workloads onto a *within-chip* memory/compute hierarchy.
Here we point the same machinery at the *between-chip* hierarchy: the mesh
axes become spatial fanout dims of a two-level Arch whose outer "memory" is
the pod-wide HBM pool reached over ICI.  For one einsum, TCM then chooses
how much of each rank to parallelize over ('data', 'model') — i.e. the
sharding — by minimizing its modeled latency, including the collective
traffic implied by multicast (activations) and reduction (partial sums).

Used as a design tool / cross-check for the hand-written rules in
``distributed.sharding`` (see EXPERIMENTS.md §Perf cell B: the planner
agrees that a 130M-param model should not tensor-parallelize over 16).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from .arch import Arch, MemLevel, SpatialFanout
from .einsum import Einsum, matmul
from .looptree import Loop, Storage
from .mapper import tcm_map

# v5e chip constants
PEAK = 197e12  # FLOP/s
HBM_BW = 819e9 / 2  # words/s (bf16)
ICI_BW = 50e9 / 2  # words/s per chip


def chip_mesh_arch(data: int, model: int) -> Arch:
    """Two-level arch: 'POOL' (remote HBM over ICI) -> 'CHIP' (local HBM),
    with a (data, model) fanout of chips below the pool.  The model dim
    multicasts activations (A) and reduces partial sums (Z) — matching the
    TP collective pattern; the data dim multicasts weights (B)."""
    return Arch(
        name=f"mesh-{data}x{model}",
        levels=(
            MemLevel("POOL", float("inf"), 1.0, 1.0, ICI_BW),
            MemLevel("CHIP", 8e9, 0.05, 0.05, HBM_BW),
        ),
        fanouts=(SpatialFanout(
            above_level=0, dims=(data, model),
            multicast_tensor=("B", "A"),
            reduce_tensor=(None, "Z")),),
        mac_energy=0.001,
        frequency=PEAK,  # 1 "cycle" = 1 FLOP: latency in seconds
    )


@dataclass
class ShardPlan:
    data_factor: Dict[str, int]
    model_factor: Dict[str, int]
    latency: float


def plan_matmul(M: int, K: int, N: int, data: int = 16,
                model: int = 16) -> ShardPlan:
    """Choose how ranks of Z[M,N]=A[M,K]B[K,N] split across mesh axes.

    A = activations (multicast along model), B = weights (multicast along
    data), Z reduced along model when k is parallelized there.
    """
    ein = matmul("mm", M, K, N)
    arch = chip_mesh_arch(data, model)
    best, _ = tcm_map(ein, arch, objective="latency")
    assert best is not None
    dfac: Dict[str, int] = {v: 1 for v in ein.rank_shapes}
    mfac: Dict[str, int] = {v: 1 for v in ein.rank_shapes}
    for n in best.mapping:
        if isinstance(n, Loop) and n.spatial:
            (dfac if n.dim == 0 else mfac)[n.var] *= n.bound
    return ShardPlan(dfac, mfac, best.latency)
