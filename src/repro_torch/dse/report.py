"""DSE sweep report: per-point rows, Pareto frontier, prune/cache counters.

The frontier is computed over ``(objective value, area_mm2)`` — exactly the
two axes the explorer's pruning is sound for (see ``explore.py``): a pruned
point provably cannot enter this frontier, so the explorer's frontier equals
the exhaustive per-point one.  Each frontier row still reports its full
(energy, latency, area) triple — with ``objective="energy"`` or
``"latency"`` the frontier trades that axis directly against area.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.search import MapperStats

# Point row statuses, in lifecycle order.  Statuses record what the sweep
# *proved*, not ground truth: a point cut under a finite seed threshold is
# "pruned_bound" (provably no better than an evaluated point) even when it
# happens to admit no mapping at all — distinguishing the two would need
# the unseeded re-search the explorer exists to avoid.  "infeasible" is
# reserved for the proven case: a search that came up empty with an
# *infinite* bound, where nothing was cut.
EVALUATED = "evaluated"
PRUNED_ROOFLINE = "pruned_roofline"  # dominated before any search
PRUNED_BOUND = "pruned_bound"  # cut during search by the seeded incumbent
INFEASIBLE = "infeasible"  # proven: no valid mapping (searched unbounded)
SKIPPED_BUDGET = "skipped_budget"  # search budget expired before this point


def pareto_keep(points: Sequence[Tuple[float, ...]]) -> List[bool]:
    """Nondominated mask: point i is dropped iff some j is <= on every axis
    and < on at least one (exact ties are all kept)."""
    keep = [True] * len(points)
    for i, p in enumerate(points):
        for j, q in enumerate(points):
            if j == i or not keep[i]:
                continue
            if all(qa <= pa for qa, pa in zip(q, p)) and any(
                    qa < pa for qa, pa in zip(q, p)):
                keep[i] = False
                break
    return keep


@dataclass
class PointRow:
    """One architecture point's outcome in the sweep."""

    name: str  # derived arch name (deterministic from coords)
    coords: str  # human-readable axis assignment
    arch_key: str
    area_mm2: float
    pe: int  # total compute units
    status: str = EVALUATED
    # roofline floors (always known)
    energy_lb: float = 0.0
    latency_lb: float = 0.0
    obj_lb: float = 0.0
    # exact totals (evaluated points only)
    energy: Optional[float] = None
    latency: Optional[float] = None
    objective: Optional[float] = None
    on_frontier: bool = False
    cached: int = 0  # per-einsum cache hits composing this point
    n_expanded: int = 0
    t_search: float = 0.0
    # merged MapperStats of this point's cold searches (None when every
    # search was served from cache or none ran); like n_expanded/t_search,
    # work done before a bound cut still counts
    stats: Optional[MapperStats] = None
    # per-einsum optimal mappings, rendered (evaluated points only)
    mappings: Dict[str, str] = field(default_factory=dict)
    # resilience: the point's searches hit their budget — its totals are
    # anytime incumbents within gap_bound of the point's true optimum
    truncated: bool = False
    gap_bound: float = 1.0


@dataclass
class DSEReport:
    space: str
    workload: str
    objective: str
    rows: List[PointRow] = field(default_factory=list)  # explorer visit order
    # space enumeration counters (from ArchSpace.materialize)
    n_combos: int = 0
    n_invalid: int = 0
    n_over_pe_budget: int = 0
    n_over_area_budget: int = 0
    n_duplicates: int = 0
    # explorer counters
    n_evaluated: int = 0
    n_pruned_roofline: int = 0
    n_pruned_bound: int = 0
    n_infeasible: int = 0
    n_skipped_budget: int = 0  # points never searched: budget expired first
    cache_hits: int = 0
    cache_misses: int = 0
    n_expanded: int = 0  # total branch-and-bound expansions across points
    t_search: float = 0.0  # seconds in cold mapping searches
    t_total: float = 0.0
    # resilience: truncated = some search hit its budget (frontier/best are
    # over anytime values); interrupted = SIGINT cut the sweep short
    # (rows cover only the points reached); gap_bound = worst per-point
    # certified optimality factor among truncated evaluations
    truncated: bool = False
    gap_bound: float = 1.0
    interrupted: bool = False

    @property
    def n_points(self) -> int:
        return len(self.rows)

    @property
    def frontier(self) -> List[PointRow]:
        return [r for r in self.rows if r.on_frontier]

    @property
    def best(self) -> Optional[PointRow]:
        """The objective-optimal (arch, mapping) pair of the sweep."""
        ev = [r for r in self.rows if r.status == EVALUATED]
        return min(ev, key=lambda r: r.objective) if ev else None

    def finalize_frontier(self) -> None:
        """Mark the (objective, area) Pareto-nondominated evaluated rows."""
        ev = [r for r in self.rows if r.status == EVALUATED]
        keep = pareto_keep([(r.objective, r.area_mm2) for r in ev])
        for r, k in zip(ev, keep):
            r.on_frontier = k

    def to_dict(self) -> dict:
        return {
            "space": self.space,
            "workload": self.workload,
            "objective": self.objective,
            "points": [
                {
                    "name": r.name, "coords": r.coords,
                    "arch_key": r.arch_key, "area_mm2": r.area_mm2,
                    "pe": r.pe, "status": r.status,
                    "energy_lb_pJ": r.energy_lb,
                    "latency_lb_s": r.latency_lb, "obj_lb": r.obj_lb,
                    "energy_pJ": r.energy, "latency_s": r.latency,
                    "objective": r.objective,
                    "on_frontier": r.on_frontier, "cached": r.cached,
                    "n_expanded": r.n_expanded, "t_search_s": r.t_search,
                    "stats": (r.stats.to_dict()
                              if r.stats is not None else None),
                    "mappings": r.mappings,
                    "truncated": r.truncated, "gap_bound": r.gap_bound,
                }
                for r in self.rows
            ],
            "frontier": [r.name for r in self.frontier],
            "best": (self.best.name if self.best else None),
            "space_counters": {
                "n_combos": self.n_combos, "n_invalid": self.n_invalid,
                "n_over_pe_budget": self.n_over_pe_budget,
                "n_over_area_budget": self.n_over_area_budget,
                "n_duplicates": self.n_duplicates,
            },
            "explorer_counters": {
                "n_points": self.n_points,
                "n_evaluated": self.n_evaluated,
                "n_pruned_roofline": self.n_pruned_roofline,
                "n_pruned_bound": self.n_pruned_bound,
                "n_infeasible": self.n_infeasible,
                "n_skipped_budget": self.n_skipped_budget,
                "n_expanded": self.n_expanded,
            },
            "cache": {"hits": self.cache_hits, "misses": self.cache_misses},
            "timing": {"t_search_s": self.t_search,
                       "t_total_s": self.t_total},
            "resilience": {"truncated": self.truncated,
                           "gap_bound": self.gap_bound,
                           "interrupted": self.interrupted},
        }

    def render(self) -> str:
        out = [
            f"design-space exploration: {self.space} x {self.workload} "
            f"[objective={self.objective}]",
            "",
            f"  {self.n_combos} axis combinations -> {self.n_points} "
            f"candidate points ({self.n_invalid} invalid, "
            f"{self.n_over_pe_budget} over PE budget, "
            f"{self.n_over_area_budget} over area budget, "
            f"{self.n_duplicates} duplicates)",
            f"  explored: {self.n_evaluated} evaluated, "
            f"{self.n_pruned_roofline} pruned by roofline dominance, "
            f"{self.n_pruned_bound} pruned by seeded bound"
            + (f", {self.n_infeasible} infeasible"
               if self.n_infeasible else "")
            + (f", {self.n_skipped_budget} skipped (budget expired)"
               if self.n_skipped_budget else ""),
            "",
            f"  {'point':<44} {'area':>8} {'PEs':>6} {'energy(pJ)':>11} "
            f"{'latency(s)':>11} {self.objective:>11} {'status':>16} "
            f"{'front':>5}",
        ]
        for r in self.rows:
            e = f"{r.energy:.4g}" if r.energy is not None else "-"
            l = f"{r.latency:.4g}" if r.latency is not None else "-"
            o = f"{r.objective:.4g}" if r.objective is not None else \
                f">{r.obj_lb:.3g}"
            out.append(
                f"  {r.coords or r.name:<44} {r.area_mm2:>8.2f} {r.pe:>6} "
                f"{e:>11} {l:>11} {o:>11} {r.status:>16} "
                f"{'*' if r.on_frontier else '':>5}")
        front = self.frontier
        best = self.best
        out += [
            "",
            f"  Pareto frontier ({self.objective} vs area): "
            f"{len(front)} point(s)",
        ]
        for r in front:
            out.append(f"    {r.coords or r.name}: {self.objective}="
                       f"{r.objective:.4g}, area={r.area_mm2:.2f} mm2")
        if best is not None:
            out.append(
                f"  best pair: {best.coords or best.name} "
                f"({self.objective}={best.objective:.4g}, "
                f"area={best.area_mm2:.2f} mm2)")
        out += [
            f"  cache: {self.cache_hits} hits / {self.cache_misses} misses",
            f"  nodes expanded: {self.n_expanded}",
            f"  time: {self.t_search:.3f}s searching, "
            f"{self.t_total:.3f}s total",
        ]
        if self.interrupted:
            out.append("  INTERRUPTED: partial sweep (points after the "
                       "interrupt were not reached)")
        if self.truncated:
            gap = ("inf" if self.gap_bound == float("inf")
                   else f"{self.gap_bound:.4g}")
            out.append(f"  ANYTIME: search budget expired; evaluated "
                       f"points certified within {gap}x of their true "
                       f"optima")
        return "\n".join(out)
