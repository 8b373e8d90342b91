"""Human profile report over a search trace.

Aggregates a raw event stream (any ``--trace`` output, either format) into
the four artifacts the search analyses need:

  * **phase breakdown** — where wall-clock went: enumeration vs seeding vs
    exploration, per driver call (the trace-native successor of the
    ``MapperStats`` ``t_*`` fields, with real nesting instead of flat sums).
  * **top-k most-expensive units** — which (dataplacement x skeleton) work
    units dominate a search, with their per-criterion prune attribution
    (dominance vs bound vs invalid), so optimization effort lands where the
    time is.
  * **incumbent timeline** — every global-bound tightening with wall-clock
    timestamp, objective value and source, i.e. *when* the search knew how
    good the optimum was.
  * **worker utilization** — per-process busy time under the driver's search
    span (pool runs only; serial runs show one fully-busy track).

Cache and fusion-decision events are summarized when present so warm netmap
sweeps profile in the same report as cold searches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .tracer import (CAT_CACHE, CAT_DSE, CAT_FUSION, CAT_INCUMBENT,
                     CAT_PHASE, CAT_STEP, CAT_UNIT, Event, event_sort_key)

# per-criterion prune attribution fields carried by "expand" step counters
PRUNE_FIELDS = ("pruned_dominated", "pruned_bound", "pruned_invalid")


@dataclass
class PruneAttribution:
    """Per-criterion prune counts summed over step events."""

    expanded: int = 0
    pruned_dominated: int = 0
    pruned_bound: int = 0
    pruned_invalid: int = 0

    def add(self, args: dict) -> None:
        self.expanded += int(args.get("expanded", 0))
        for f in PRUNE_FIELDS:
            setattr(self, f, getattr(self, f) + int(args.get(f, 0)))

    @property
    def pruned_total(self) -> int:
        return (self.pruned_dominated + self.pruned_bound
                + self.pruned_invalid)


@dataclass
class ProfileReport:
    n_events: int = 0
    wall_s: float = 0.0  # earliest ts -> latest end
    phases: Dict[str, float] = field(default_factory=dict)  # name -> sum dur
    drivers: List[Event] = field(default_factory=list)  # driver-cat spans
    units: List[Event] = field(default_factory=list)  # unit spans, by -dur
    incumbents: List[Event] = field(default_factory=list)  # chronological
    prune: PruneAttribution = field(default_factory=PruneAttribution)
    # pid -> busy seconds inside unit spans; pid order = first appearance
    worker_busy: Dict[int, float] = field(default_factory=dict)
    search_wall_s: float = 0.0  # widest "search" phase span (utilization hub)
    cache_counts: Dict[str, int] = field(default_factory=dict)
    fusion_events: List[Event] = field(default_factory=list)
    dse_counts: Dict[str, int] = field(default_factory=dict)

    def render(self, top_k: int = 10) -> str:
        out = [f"trace profile: {self.n_events} events over "
               f"{self.wall_s:.3f}s wall"]

        out += ["", "phase breakdown (summed span durations):"]
        for d in self.drivers:
            out.append(f"  {d['name']:<42} {d['dur']:>9.3f}s  "
                       f"[{d.get('args', {}).get('backend', '-')}]")
        for name, dur in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            pct = 100 * dur / self.wall_s if self.wall_s else 0.0
            out.append(f"    {name:<40} {dur:>9.3f}s {pct:>5.1f}%")

        if self.prune.expanded:
            p = self.prune
            out += ["", "prune attribution (per-criterion, all units):",
                    f"    expanded          {p.expanded:>12}",
                    f"    pruned dominance  {p.pruned_dominated:>12}",
                    f"    pruned bound      {p.pruned_bound:>12}",
                    f"    pruned invalid    {p.pruned_invalid:>12}"]

        if self.units:
            out += ["", f"top {min(top_k, len(self.units))} most expensive "
                    f"work units (of {len(self.units)}):",
                    f"    {'unit':<26} {'time(s)':>9} {'expanded':>9} "
                    f"{'dom':>8} {'bound':>8} {'invalid':>8}"]
            for u in self.units[:top_k]:
                a = u.get("args", {})
                out.append(
                    f"    {u['name']:<26} {u['dur']:>9.3f} "
                    f"{a.get('n_expanded', 0):>9} "
                    f"{a.get('pruned_dominated', 0):>8} "
                    f"{a.get('pruned_bound', 0):>8} "
                    f"{a.get('pruned_invalid', 0):>8}")

        if self.incumbents:
            t0 = self.incumbents[0]["ts"]
            out += ["", "incumbent timeline (bound tightenings):",
                    f"    {'t(+s)':>9} {'objective':>14} source"]
            for ev in self.incumbents:
                a = ev.get("args", {})
                obj = a.get("objective", a.get("value"))
                obj_s = f"{obj:.6g}" if isinstance(obj, (int, float)) else "-"
                out.append(f"    {ev['ts'] - t0:>9.4f} {obj_s:>14} "
                           f"{a.get('source', '?')}")

        if self.worker_busy:
            out += ["", "pool worker utilization (busy inside unit spans):"]
            denom = self.search_wall_s or self.wall_s
            for i, (pid, busy) in enumerate(self.worker_busy.items()):
                pct = 100 * busy / denom if denom else 0.0
                label = "driver" if i == 0 else f"worker {i}"
                out.append(f"    pid {pid:<8} ({label:<9}) "
                           f"{busy:>9.3f}s busy  {pct:>5.1f}% of "
                           f"{denom:.3f}s search wall")

        if self.cache_counts:
            parts = ", ".join(f"{k}={v}" for k, v in
                              sorted(self.cache_counts.items()))
            out += ["", f"mapping-cache events: {parts}"]
        if self.fusion_events:
            out += ["", "fusion adoption decisions:"]
            for ev in self.fusion_events:
                a = ev.get("args", {})
                out.append(f"    {a.get('ops', '?'):<20} "
                           f"adopted={a.get('adopted')} "
                           f"fused_edp={a.get('fused_edp')} "
                           f"unfused_edp={a.get('unfused_edp')}")
        if self.dse_counts:
            parts = ", ".join(f"{k}={v}" for k, v in
                              sorted(self.dse_counts.items()))
            out += ["", f"dse point outcomes: {parts}"]
        return "\n".join(out)


def profile(events: List[Event]) -> ProfileReport:
    """Aggregate a raw event stream into a :class:`ProfileReport`."""
    rep = ProfileReport(n_events=len(events))
    if not events:
        return rep
    events = sorted(events, key=event_sort_key)
    start = min(ev["ts"] for ev in events)
    end = max(ev["ts"] + ev.get("dur", 0.0) for ev in events)
    rep.wall_s = end - start

    for ev in events:
        cat, ph = ev.get("cat"), ev.get("ph")
        if ph == "X" and cat == "driver":
            rep.drivers.append(ev)
        elif ph == "X" and cat == CAT_PHASE:
            rep.phases[ev["name"]] = (rep.phases.get(ev["name"], 0.0)
                                      + ev.get("dur", 0.0))
            if ev["name"] == "search":
                rep.search_wall_s = max(rep.search_wall_s,
                                        ev.get("dur", 0.0))
        elif ph == "X" and cat == CAT_UNIT:
            rep.units.append(ev)
            pid = ev.get("pid", 0)
            rep.worker_busy[pid] = (rep.worker_busy.get(pid, 0.0)
                                    + ev.get("dur", 0.0))
        elif cat == CAT_STEP:
            rep.prune.add(ev.get("args", {}))
        elif cat == CAT_INCUMBENT:
            rep.incumbents.append(ev)
        elif cat == CAT_CACHE:
            rep.cache_counts[ev["name"]] = (
                rep.cache_counts.get(ev["name"], 0) + 1)
        elif cat == CAT_FUSION:
            rep.fusion_events.append(ev)
        elif cat == CAT_DSE:
            if ph == "X":  # per-point evaluation span: rank with the units
                rep.units.append(ev)
            else:
                rep.dse_counts[ev["name"]] = (
                    rep.dse_counts.get(ev["name"], 0) + 1)

    rep.units.sort(key=lambda u: -u.get("dur", 0.0))
    # single-process traces: "worker utilization" degenerates to one track;
    # drop it so serial profiles stay compact
    if len(rep.worker_busy) <= 1:
        rep.worker_busy.clear()
    return rep
