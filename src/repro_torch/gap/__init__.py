"""repro_torch.gap — the optimality-gap harness and pruning-soundness detector.

One mapspace, one cost model, many searchers: :class:`~repro_torch.gap.gym.
MapspaceGym` exposes TCM's own search space (dataplacement x skeleton x
divisor-constrained tile shapes) under ``refmodel.evaluate`` to the
metaheuristic baselines in ``core.baselines``; ``repro_torch.gap.runner`` draws
EDP-gap-vs-budget curves against ``tcm_map``'s exact optimum and
``repro_torch.gap.soundness`` fuzzes tiny workloads against the brute-force
oracle.  Any baseline ever landing strictly below the claimed optimum is a
pruning-soundness bug, recorded as a minimized, replayable JSON repro.

CLI: ``python -m repro_torch.gap --help``.

NOTE: this module intentionally exports only the gym layer;
``core.baselines`` imports ``repro_torch.gap.gym`` at call time, so keeping
heavier imports (runner/soundness, which import ``core.baselines`` back)
out of the package root avoids an import cycle.
"""
from .gym import (FusedMapspaceGym, GymEval, GymPoint, MapspaceGym,
                  objective_value)

__all__ = [
    "FusedMapspaceGym", "GymEval", "GymPoint", "MapspaceGym",
    "objective_value",
]
