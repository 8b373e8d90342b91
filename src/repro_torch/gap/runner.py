"""Optimality-gap curves: metaheuristic baselines vs. the exact optimum.

For each (workload, arch, objective) the runner computes ``tcm_map``'s exact
optimum once, then runs every registered baseline at a ladder of eval
budgets, recording the best objective, the gap ratio (baseline / optimum),
valid-sample counts and wall-clock.  This reproduces the paper's headline
comparison (TCM's 1.2-6.5x EDP win exists because heuristics leave gap on
the table) and doubles as a standing soundness tripwire: any baseline at any
budget landing strictly below the claimed optimum is recorded as a
*violation* — a bug in the incumbent/dominance/roofline pruning, not a win.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.arch import Arch
from ..core.baselines import (BaselineResult, evolutionary, loma_like,
                              simulated_annealing, timeloop_like)
from ..core.einsum import Einsum
from ..core.mapper import tcm_map
from ..core.presets import (gpt3_einsums, nvdla_like, small_matmul_suite,
                            tpu_v4i_like, tpu_v5e_like)
from ..obs.tracer import active

# a baseline objective this far (relatively) below the optimum is a real
# violation, not compiled-kernel-vs-reference-model float noise (the same
# tolerance the oracle tests use)
REL_EPS = 1e-9

BASELINES: Dict[str, Callable[..., BaselineResult]] = {
    "random": lambda e, a, b, s, o: timeloop_like(
        e, a, budget_evals=b, seed=s, objective=o),
    "random+hint": lambda e, a, b, s, o: timeloop_like(
        e, a, budget_evals=b, seed=s, objective=o, full_spatial_hint=True),
    "loma": lambda e, a, b, s, o: loma_like(
        e, a, budget_evals=b, seed=s, objective=o),
    "sa": lambda e, a, b, s, o: simulated_annealing(
        e, a, budget_evals=b, seed=s, objective=o),
    "ga": lambda e, a, b, s, o: evolutionary(
        e, a, budget_evals=b, seed=s, objective=o),
}

ARCH_PRESETS: Dict[str, Callable[[], Arch]] = {
    "tpu": tpu_v4i_like,
    "nvdla": nvdla_like,
    "tpu-v5e": tpu_v5e_like,
}


def derive_seed(base: int, *parts) -> int:
    """Stable per-(workload, arch, baseline, budget) seed: reordering the
    sweep or adding rungs never changes any existing run's stream."""
    tag = "/".join(str(p) for p in parts)
    return base ^ zlib.crc32(tag.encode())


def parse_budgets(spec: str) -> List[int]:
    """``"1e2..1e4"`` -> [100, 1000, 10000]; ``"100,500"`` -> [100, 500]."""
    spec = spec.strip()
    if ".." in spec:
        lo_s, hi_s = spec.split("..", 1)
        lo, hi = int(float(lo_s)), int(float(hi_s))
        out = []
        b = lo
        while b <= hi:
            out.append(b)
            b *= 10
        return out
    return [int(float(x)) for x in spec.split(",") if x.strip()]


@dataclass
class GapPoint:
    budget: int
    objective: float  # baseline's best (inf when nothing valid found)
    gap: float  # objective / optimum (inf when nothing valid found)
    n_evaluated: int
    n_valid: int
    wall_s: float


@dataclass
class GapCurve:
    workload: str
    arch: str
    objective_kind: str
    baseline: str
    points: List[GapPoint] = field(default_factory=list)


@dataclass
class Violation:
    """A baseline beat the 'optimum' — a pruning-soundness bug record."""

    workload: str
    arch: str
    objective_kind: str
    baseline: str
    budget: int
    seed: int
    baseline_objective: float
    claimed_optimum: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class GapReport:
    curves: List[GapCurve]
    optima: Dict[Tuple[str, str, str], float]  # (workload, arch, kind) -> obj
    optima_wall_s: Dict[Tuple[str, str, str], float]
    violations: List[Violation]

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "optima": [
                {"workload": w, "arch": a, "objective_kind": k,
                 "optimum": obj,
                 "tcm_wall_s": round(self.optima_wall_s[(w, a, k)], 4)}
                for (w, a, k), obj in sorted(self.optima.items())
            ],
            "curves": [
                {"workload": c.workload, "arch": c.arch,
                 "objective_kind": c.objective_kind, "baseline": c.baseline,
                 "points": [dict(p.__dict__) for p in c.points]}
                for c in self.curves
            ],
            "violations": [v.to_dict() for v in self.violations],
        }

    def render(self) -> str:
        out = ["optimality gap (baseline best / exact optimum)", ""]
        header = None
        for (w, a, k), opt in sorted(self.optima.items()):
            curves = [c for c in self.curves
                      if (c.workload, c.arch, c.objective_kind) == (w, a, k)]
            if not curves:
                continue
            budgets = [p.budget for p in curves[0].points]
            if header != budgets:
                header = budgets
                cols = "".join(f"{b:>12}" for b in budgets)
                out.append(f"{'workload/arch/baseline':<34}{cols}")
            out.append(f"{w} @ {a} [{k}]  optimum={opt:.4g} "
                       f"({self.optima_wall_s[(w, a, k)]:.2f}s)")
            for c in curves:
                cells = "".join(
                    f"{p.gap:>11.3f}x" if p.gap != float("inf")
                    else f"{'--':>12}" for p in c.points)
                out.append(f"  {c.baseline:<32}{cells}")
        if self.violations:
            out.append("")
            out.append(f"!! {len(self.violations)} SOUNDNESS VIOLATION(S): "
                       "a baseline beat the claimed optimum")
            for v in self.violations:
                out.append(f"  {v.baseline}@{v.budget} on {v.workload}/"
                           f"{v.arch}/{v.objective_kind}: "
                           f"{v.baseline_objective} < {v.claimed_optimum}")
        else:
            out.append("")
            out.append("soundness: no baseline beat the exact optimum")
        return "\n".join(out)


def resolve_workloads(names: Sequence[str], paper: bool = False
                      ) -> Dict[str, Einsum]:
    suite = gpt3_einsums() if paper else small_matmul_suite()
    out = {}
    for n in names:
        if n not in suite:
            raise SystemExit(
                f"unknown workload {n!r}; choose from {sorted(suite)}")
        out[n] = suite[n]
    return out


def run_gap(workloads: Dict[str, Einsum],
            arches: Dict[str, Arch],
            budgets: Sequence[int],
            objectives: Sequence[str] = ("edp",),
            baselines: Optional[Sequence[str]] = None,
            seed: int = 0,
            verbose: bool = False,
            tracer=None) -> GapReport:
    """The gap harness main loop.

    Baselines are re-run from scratch at every budget rung (rather than
    checkpointed) so each point is an independent, reproducible run — the
    curve answers "what does a *fresh* search with budget B achieve", the
    quantity the paper's comparison tables report.

    ``tracer`` records the exact searches' full telemetry (via ``tcm_map``)
    plus one span per baseline curve, so the harness's own wall-clock
    budget splits between "computing optima" and "running baselines".
    """
    tracer = active(tracer)
    names = list(baselines) if baselines is not None else list(BASELINES)
    for n in names:
        if n not in BASELINES:
            raise SystemExit(
                f"unknown baseline {n!r}; choose from {sorted(BASELINES)}")
    curves: List[GapCurve] = []
    optima: Dict[Tuple[str, str, str], float] = {}
    optima_wall: Dict[Tuple[str, str, str], float] = {}
    violations: List[Violation] = []
    for wname, ein in workloads.items():
        for aname, arch in arches.items():
            for kind in objectives:
                t0 = time.perf_counter()
                best, _ = tcm_map(ein, arch, objective=kind, tracer=tracer)
                optima_wall[(wname, aname, kind)] = time.perf_counter() - t0
                opt = best.objective(kind) if best is not None \
                    else float("inf")
                optima[(wname, aname, kind)] = opt
                if verbose:
                    print(f"# {wname} @ {aname} [{kind}]: optimum {opt:.4g} "
                          f"in {optima_wall[(wname, aname, kind)]:.2f}s",
                          flush=True)
                for bname in names:
                    curve = GapCurve(wname, aname, kind, bname)
                    t_curve = time.time() if tracer is not None else 0.0
                    for budget in budgets:
                        s = derive_seed(seed, wname, aname, bname, budget)
                        r = BASELINES[bname](ein, arch, budget, s, kind)
                        obj = r.objective(kind)
                        gap = obj / opt if opt not in (0.0, float("inf")) \
                            else float("inf")
                        curve.points.append(GapPoint(
                            budget=budget, objective=obj, gap=gap,
                            n_evaluated=r.n_evaluated, n_valid=r.n_valid,
                            wall_s=round(r.wall_s, 4)))
                        if obj < opt * (1 - REL_EPS):
                            violations.append(Violation(
                                wname, aname, kind, bname, budget, s,
                                obj, opt))
                    if tracer is not None:
                        last = curve.points[-1] if curve.points else None
                        tracer.complete(
                            f"baseline:{bname}", t_curve, cat="phase",
                            workload=wname, arch=aname, kind=kind,
                            budgets=list(budgets),
                            final_gap=last.gap if last else None)
                    curves.append(curve)
    return GapReport(curves, optima, optima_wall, violations)
