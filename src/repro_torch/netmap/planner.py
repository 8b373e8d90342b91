"""Network mapping planner: dedup -> batch search -> per-model EDP report.

``map_network`` takes a ``ModelConfig`` + ``Arch`` and produces a
:class:`NetworkReport`:

  1. **Extract** the per-layer einsum list (``extract.extract_einsums``).
  2. **Dedup** repeated shapes with the search layer's structural key —
     a 24-layer dense model collapses to a handful of unique einsums
     (qwen1.5-0.5b: ~200 layer ops -> 6 unique searches).
  3. **Search** each unique einsum through the existing ``tcm_map`` driver,
     sharing one :class:`~repro.core.search.SearchEngine` (so ``--workers``
     pays its pool start-up once for the whole model), consulting the
     persistent :class:`~repro.netmap.cache.MappingCache` first.
  4. **Compose** per-einsum optima into network totals: energy and latency
     sum over the (sequentially executed) layer ops; the headline network
     EDP is ``total_energy * total_latency``; mapspace sizes aggregate as
     the sum of per-unique log10 sizes (the joint space of independent
     per-einsum choices).

``model_tiles`` is the kernel-side hook: one planner call returns the
Hopper matmul kernel's tiles for every matmul of a model (the twin of the
reference's ``network_blockspec_tiles``, which hard-wires the TPU tile
search; this one asks ``core.autotile.tcm_matmul_tiles`` for the H100
SM's tiles).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.arch import Arch
from ..core.budget import ensure_meter
from ..obs.tracer import active
from ..core.fusion import from_group, workload_key
from ..core.mapper import tcm_map, tcm_map_group
from ..core.search import (MapperStats, MappingResult, SearchEngine,
                               einsum_key, make_engine)
from ..core.autotile import tcm_matmul_tiles
from ..models.config import ModelConfig

from .cache import MappingCache
from .extract import LayerEinsum, extract_einsums, extract_graph


class NoValidMappingError(RuntimeError):
    """An extracted layer op admits no valid mapping on the target arch.

    A ``RuntimeError`` subclass for backward compatibility; callers that
    probe architecture candidates (``repro.dse``) catch exactly this so
    engine/pool failures are never mistaken for infeasibility.
    """


@dataclass
class UniqueSearch:
    """One deduplicated einsum search and where its result came from."""

    op: str  # exemplar operator label (first occurrence)
    shape: str  # human-readable rank shapes
    n_uses: int  # how many layer ops this search covers (incl. counts)
    result: MappingResult
    stats: MapperStats
    cached: bool
    t_search: float


@dataclass
class LayerRow:
    """One extracted layer op, costed with its unique search's optimum.

    For an adopted fusion group the member ops collapse into a single row
    (``op`` = joined labels, ``fused`` = True) costed with the joint
    optimum; the intermediate tensors then never touch DRAM.
    """

    layer: int
    op: str
    count: int
    energy: float  # pJ, scaled by count
    latency: float  # s, scaled by count
    edp: float  # energy * latency of this row
    cached: bool
    fused: bool = False


@dataclass
class FusionRow:
    """One deduplicated fusion-group search: joint vs independent outcome."""

    ops: str  # joined member op labels, e.g. "qk+av"
    shape: str  # exemplar member shapes
    n_instances: int  # how many group instances this search covers
    unfused_energy: float  # independent-mapping sums (the fallback)
    unfused_latency: float
    result: Optional[MappingResult]  # joint optimum (None: no fused mapping)
    stats: Optional[MapperStats]
    adopted: bool  # fused won on both axes; rows use the joint optimum
    cached: bool
    t_search: float
    pin_level: Optional[int] = None

    @property
    def unfused_edp(self) -> float:
        return self.unfused_energy * self.unfused_latency

    @property
    def fused_edp(self) -> Optional[float]:
        if self.result is None:
            return None
        return self.result.energy * self.result.latency

    @property
    def edp_delta(self) -> Optional[float]:
        """unfused - fused group EDP (positive = fusion wins)."""
        if self.result is None:
            return None
        return self.unfused_edp - self.fused_edp


@dataclass
class NetworkReport:
    config: str
    arch: str
    mode: str
    objective: str
    batch: int
    seq: int
    fuse: bool = True
    rows: List[LayerRow] = field(default_factory=list)
    unique: List[UniqueSearch] = field(default_factory=list)
    fused: List[FusionRow] = field(default_factory=list)
    total_energy: float = 0.0  # pJ
    total_latency: float = 0.0  # s
    total_edp: float = 0.0  # pJ*s = total_energy * total_latency
    log10_mapspace: float = 0.0  # sum of per-unique log10 |mapspace|
    # model evaluations behind the composing searches; for cache hits this
    # is the original cold search's count, not work done by this call
    n_evaluated: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    t_search: float = 0.0  # seconds spent in cold searches
    t_total: float = 0.0  # wall seconds of the whole planner call
    # resilience: True when any composing search hit its budget; gap_bound
    # is the worst per-unique-search certified optimality factor (each
    # deduplicated search's objective is within this factor of its true
    # optimum; inf when a truncated search certifies nothing).
    truncated: bool = False
    gap_bound: float = 1.0
    # True when the planner was interrupted (SIGINT): rows/totals cover
    # only the layer ops whose searches finished — a best-so-far report.
    interrupted: bool = False

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def layer_totals(self) -> List[Tuple[int, float, float, float]]:
        """(layer, energy, latency, edp) summed over each layer's ops."""
        acc: Dict[int, Tuple[float, float]] = {}
        for r in self.rows:
            e, l = acc.get(r.layer, (0.0, 0.0))
            acc[r.layer] = (e + r.energy, l + r.latency)
        return [(layer, e, l, e * l)
                for layer, (e, l) in sorted(acc.items())]

    def to_dict(self) -> dict:
        return {
            "config": self.config, "arch": self.arch, "mode": self.mode,
            "objective": self.objective, "batch": self.batch, "seq": self.seq,
            "totals": {"energy_pJ": self.total_energy,
                       "latency_s": self.total_latency,
                       "edp_pJs": self.total_edp},
            "layers": [{"layer": r.layer, "op": r.op, "count": r.count,
                        "energy_pJ": r.energy, "latency_s": r.latency,
                        "edp_pJs": r.edp, "cached": r.cached,
                        "fused": r.fused}
                       for r in self.rows],
            "unique_searches": [
                {"op": u.op, "shape": u.shape, "n_uses": u.n_uses,
                 "energy_pJ": u.result.energy, "latency_s": u.result.latency,
                 "edp_pJs": u.result.edp, "cached": u.cached,
                 "t_search_s": u.t_search,
                 "log10_mapspace": u.stats.log10_total}
                for u in self.unique],
            "fusion": [
                {"ops": f.ops, "shape": f.shape,
                 "n_instances": f.n_instances,
                 "unfused_energy_pJ": f.unfused_energy,
                 "unfused_latency_s": f.unfused_latency,
                 "unfused_edp_pJs": f.unfused_edp,
                 "fused_energy_pJ": (f.result.energy if f.result else None),
                 "fused_latency_s": (f.result.latency if f.result else None),
                 "fused_edp_pJs": f.fused_edp,
                 "edp_delta_pJs": f.edp_delta,
                 "pin_level": f.pin_level,
                 "adopted": f.adopted, "cached": f.cached,
                 "t_search_s": f.t_search}
                for f in self.fused],
            "mapspace": {"log10_joint": self.log10_mapspace,
                         "n_evaluated": self.n_evaluated},
            "cache": {"hits": self.cache_hits, "misses": self.cache_misses,
                      "hit_rate": self.cache_hit_rate},
            "timing": {"t_search_s": self.t_search, "t_total_s": self.t_total},
            "resilience": {"truncated": self.truncated,
                           "gap_bound": self.gap_bound,
                           "interrupted": self.interrupted},
        }

    def render(self) -> str:
        """Human-readable per-layer + totals report."""
        out = [
            f"network mapping: {self.config} on {self.arch} "
            f"[{self.mode}, batch={self.batch}, seq={self.seq}, "
            f"objective={self.objective}]",
            "",
            f"  {len(self.rows)} layer ops -> {len(self.unique)} unique "
            f"einsum searches (joint mapspace ~10^{self.log10_mapspace:.0f} "
            f"mappings, {self.n_evaluated} evaluated by the backing "
            f"searches)",
            "",
            "  unique einsums:",
            f"    {'op':<14} {'shape':<28} {'uses':>4} {'energy(pJ)':>12} "
            f"{'latency(s)':>12} {'EDP(pJ*s)':>12} {'src':>6}",
        ]
        for u in self.unique:
            out.append(
                f"    {u.op:<14} {u.shape:<28} {u.n_uses:>4} "
                f"{u.result.energy:>12.4g} {u.result.latency:>12.4g} "
                f"{u.result.edp:>12.4g} {'cache' if u.cached else 'search':>6}")
        if self.fused:
            out += ["", "  fusion groups (joint vs independent mapping):",
                    f"    {'ops':<18} {'inst':>4} {'pin':>4} "
                    f"{'fused EDP':>12} {'unfused EDP':>12} {'delta':>10} "
                    f"{'adopted':>8}"]
            for f in self.fused:
                fe = f"{f.fused_edp:.4g}" if f.fused_edp is not None else "-"
                de = (f"{f.edp_delta:+.3g}" if f.edp_delta is not None
                      else "-")
                pin = str(f.pin_level) if f.pin_level is not None else "-"
                out.append(
                    f"    {f.ops:<18} {f.n_instances:>4} {pin:>4} "
                    f"{fe:>12} {f.unfused_edp:>12.4g} {de:>10} "
                    f"{'yes' if f.adopted else 'no':>8}")
        out += ["", "  per-layer totals:",
                f"    {'layer':<7} {'energy(pJ)':>12} {'latency(s)':>12} "
                f"{'EDP(pJ*s)':>12}"]
        for layer, e, l, edp in self.layer_totals():
            label = "head" if layer < 0 else str(layer)
            out.append(f"    {label:<7} {e:>12.4g} {l:>12.4g} {edp:>12.4g}")
        out += [
            "",
            f"  network totals: energy {self.total_energy:.4g} pJ, "
            f"latency {self.total_latency:.4g} s, "
            f"EDP {self.total_edp:.4g} pJ*s",
            f"  cache: {self.cache_hits} hits / {self.cache_misses} misses "
            f"(hit rate {100 * self.cache_hit_rate:.0f}%)",
            f"  time: {self.t_search:.3f}s searching, "
            f"{self.t_total:.3f}s total",
        ]
        if self.interrupted:
            out.append("  INTERRUPTED: totals cover only the finished "
                       "searches (best-so-far report)")
        if self.truncated:
            gap = ("inf" if self.gap_bound == float("inf")
                   else f"{self.gap_bound:.4g}")
            out.append(f"  ANYTIME: search budget expired; per-search "
                       f"optima certified within {gap}x of true optimum")
        return "\n".join(out)


def _shape_desc(entry: LayerEinsum) -> str:
    shapes = entry.einsum.rank_shapes
    return "x".join(f"{v}={shapes[v]}" for v in sorted(shapes))


def map_network(
    cfg: ModelConfig,
    arch: Arch,
    objective: str = "edp",
    mode: str = "prefill",
    batch: int = 1,
    seq: int = 1024,
    prune_partial: bool = True,
    cache: Optional[MappingCache] = None,
    engine: Optional[SearchEngine] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    fuse: bool = True,
    max_group: int = 4,
    verbose: bool = False,
    tracer=None,
    budget=None,
    checkpoint=None,
) -> NetworkReport:
    """Map every layer of ``cfg`` on ``arch`` and compose the network report.

    ``cache=None`` searches everything cold; pass a
    :class:`~repro.netmap.cache.MappingCache` to serve repeated shapes from
    disk.  ``workers``/``engine`` select the search backend exactly as in
    ``tcm_map`` — one engine is shared across all unique searches, so every
    per-einsum search inherits the engine's two-phase shared-incumbent
    branch-and-bound (``share_incumbents=False`` opts back out; optima are
    value-identical either way, it only changes search time).

    ``fuse=True`` (default) additionally partitions the workload graph into
    fusion groups (legality: single consumer edge, matching rank classes, an
    on-chip pin level), joint-searches each deduplicated group with the
    intermediate pinned on-chip, and *adopts* the joint optimum only when it
    is no worse than the independent sum on both energy and latency (and
    strictly better on one) — so network totals with fusion are never worse
    than the per-einsum baseline, and per-group fused-vs-unfused EDP deltas
    are reported either way.  ``fuse=False`` reproduces the independent
    per-layer planner bit-for-bit, stats included.

    ``tracer`` records the planner's telemetry on top of the per-search
    spans each ``tcm_map`` call emits: one ``hit``/``miss`` cache instant
    per unique lookup (plus ``negative`` for fused groups cached as
    unmappable) and one ``adopted``/``rejected`` instant per fusion-group
    decision.  Observational only — reports are identical traced or not.

    ``budget`` (a :class:`~repro.core.budget.SearchBudget` or ``None``)
    spans the *whole model*: one meter is shared by every composing search,
    so a 60-second deadline bounds the full planner call, not each layer.
    Truncated searches return their best incumbent; the report carries
    ``truncated=True`` and the worst per-search certified ``gap_bound``.
    ``checkpoint`` journals finished work units so an interrupted run
    resumes mid-search (the :class:`MappingCache` already resumes at
    whole-einsum granularity); honored only when this call creates its own
    engine.  ``KeyboardInterrupt`` (SIGINT) returns a best-so-far report
    (``interrupted=True``, totals over the finished searches only) instead
    of propagating.
    """
    tracer = active(tracer)
    t0 = time.perf_counter()
    t_wall = time.time() if tracer is not None else 0.0
    meter = ensure_meter(budget)
    if fuse:
        ng = extract_graph(cfg, mode=mode, batch=batch, seq=seq)
        entries = ng.entries
    else:
        ng = None
        entries = extract_einsums(cfg, mode=mode, batch=batch, seq=seq)
    owns_engine = engine is None
    if owns_engine:
        engine = make_engine(None, workers,
                             share_incumbents=share_incumbents,
                             checkpoint=checkpoint)
    # hit/miss counters are per-cache-instance lifetime totals; snapshot them
    # so the report shows this call's deltas even on a reused cache object
    hits0 = cache.hits if cache is not None else 0
    misses0 = cache.misses if cache is not None else 0

    # dedup: structural einsum key (arch/objective are constant per call)
    order: List[tuple] = []  # unique keys in first-seen order
    groups: Dict[tuple, List[LayerEinsum]] = {}
    for entry in entries:
        key = einsum_key(entry.einsum)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(entry)

    report = NetworkReport(config=cfg.name, arch=arch.name, mode=mode,
                           objective=objective, batch=batch, seq=seq,
                           fuse=fuse)
    searched: Dict[tuple, UniqueSearch] = {}
    # member einsum name -> (first-member name, FusionRow) for adopted groups
    adopted_member: Dict[str, Tuple[str, FusionRow]] = {}
    try:
        for key in order:
            members = groups[key]
            exemplar = members[0]
            hit = (cache.get(exemplar.einsum, arch, objective, prune_partial)
                   if cache is not None else None)
            if tracer is not None and cache is not None:
                tracer.instant("hit" if hit is not None else "miss",
                               cat="cache", op=exemplar.op,
                               einsum=exemplar.einsum.name)
            if hit is not None:
                result, stats, cached, t_search = (hit.result, hit.stats,
                                                   True, hit.t_search)
            else:
                t1 = time.perf_counter()
                result, stats = tcm_map(exemplar.einsum, arch,
                                        objective=objective,
                                        prune_partial=prune_partial,
                                        engine=engine, tracer=tracer,
                                        budget=meter)
                t_search = time.perf_counter() - t1
                if result is None:
                    raise NoValidMappingError(
                        f"no valid mapping for {exemplar.einsum.name} on "
                        f"{arch.name}"
                        + (" (search budget expired before any mapping "
                           "was found)" if stats.truncated else ""))
                report.t_search += t_search
                if stats.truncated:
                    report.truncated = True
                    report.gap_bound = max(report.gap_bound,
                                           stats.gap_bound)
                cached = False
                # truncated results are anytime incumbents, not optima —
                # never cache them as the shape's answer
                if cache is not None and not stats.truncated:
                    cache.put(exemplar.einsum, arch, objective, result,
                              stats, t_search, prune_partial)
            u = UniqueSearch(op=exemplar.op, shape=_shape_desc(exemplar),
                             n_uses=sum(m.count for m in members),
                             result=result, stats=stats, cached=cached,
                             t_search=t_search)
            searched[key] = u
            report.unique.append(u)
            report.log10_mapspace += stats.log10_total
            # n_expanded already includes the final evaluations (it counts
            # every point the curried model was applied to, same as
            # log10_evaluated)
            report.n_evaluated += stats.n_expanded
            if verbose:
                src = "cache" if cached else f"search {t_search:.2f}s"
                print(f"  {exemplar.op:<14} {u.shape:<28} [{src}] "
                      f"edp={result.edp:.4g}")

        if fuse:
            _map_fusion_groups(ng, arch, objective, prune_partial, cache,
                               engine, max_group, searched, report,
                               adopted_member, verbose, tracer=tracer,
                               budget=meter)
    except KeyboardInterrupt:
        # best-so-far report: compose what finished, flag the rest
        report.interrupted = True
        if tracer is not None:
            tracer.instant("interrupted", cat="fault", config=cfg.name,
                           n_finished=len(report.unique))
    finally:
        # engines we created are torn down even when a search raises;
        # caller-provided engines stay open for reuse
        if owns_engine:
            engine.close()

    for entry in entries:
        if einsum_key(entry.einsum) not in searched:
            continue  # interrupted before this op's search finished
        name = entry.einsum.name
        if name in adopted_member:
            first, frow = adopted_member[name]
            if name != first:
                continue  # folded into the group's first-member row
            ops = frow.ops
            report.rows.append(LayerRow(
                layer=entry.layer, op=ops, count=1,
                energy=frow.result.energy, latency=frow.result.latency,
                edp=frow.result.energy * frow.result.latency,
                cached=frow.cached, fused=True))
            report.total_energy += frow.result.energy
            report.total_latency += frow.result.latency
            continue
        u = searched[einsum_key(entry.einsum)]
        energy = u.result.energy * entry.count
        latency = u.result.latency * entry.count
        report.rows.append(LayerRow(
            layer=entry.layer, op=entry.op, count=entry.count,
            energy=energy, latency=latency, edp=energy * latency,
            cached=u.cached))
        report.total_energy += energy
        report.total_latency += latency

    report.total_edp = report.total_energy * report.total_latency
    if cache is not None:
        report.cache_hits = cache.hits - hits0
        report.cache_misses = cache.misses - misses0
    else:
        report.cache_misses = len(report.unique) + len(report.fused)
    report.t_total = time.perf_counter() - t0
    if tracer is not None:
        extra = {}
        if report.truncated:
            extra.update(truncated=True, gap_bound=report.gap_bound)
        if report.interrupted:
            extra.update(interrupted=True)
        tracer.complete(
            f"map_network:{cfg.name}", t_wall, cat="driver",
            backend=engine.backend, arch=arch.name, mode=mode,
            n_layer_ops=len(report.rows), n_unique=len(report.unique),
            n_fused=len(report.fused), edp=report.total_edp,
            cache_hits=report.cache_hits,
            cache_misses=report.cache_misses, **extra)
    return report


def _map_fusion_groups(ng, arch, objective, prune_partial, cache, engine,
                       max_group, searched, report, adopted_member,
                       verbose, tracer=None, budget=None) -> None:
    """Joint-search the workload graph's fusion groups.

    Each structurally distinct group is searched once (dedup by member
    structures + edge wiring); the independent per-member optima — already
    searched above — both seed the joint branch-and-bound (candidates
    provably no better than the fallback are pruned) and decide adoption.
    """
    fgroups = [g for g in
               ng.graph.partition_fusion_groups(arch, max_group=max_group)
               if g.is_fused]
    rows_by_key: Dict[tuple, FusionRow] = {}
    for g in fgroups:
        m_entries = [ng.entry(n) for n in g.members]
        if any(e.count != 1 for e in m_entries):
            continue  # replicated ops (MoE experts) never co-tile
        w = from_group(ng.graph, g,
                       name="+".join(e.op for e in m_entries))
        gkey = workload_key(w)
        row = rows_by_key.get(gkey)
        if row is not None:
            row.n_instances += 1
        else:
            ind_e = sum(searched[einsum_key(e.einsum)].result.energy
                        for e in m_entries)
            ind_l = sum(searched[einsum_key(e.einsum)].result.latency
                        for e in m_entries)
            bound = {"edp": ind_e * ind_l, "energy": ind_e,
                     "latency": ind_l}[objective]
            hit = (cache.get_group(w, arch, objective, prune_partial)
                   if cache is not None else None)
            if tracer is not None and cache is not None:
                # a hit whose result is None is a *negative* entry: the
                # group was searched before and admits no fused mapping
                name = ("miss" if hit is None
                        else "negative" if hit.result is None else "hit")
                tracer.instant(name, cat="cache", group=w.name)
            if hit is not None:
                result, stats, cached, t_search = (hit.result, hit.stats,
                                                   True, hit.t_search)
            else:
                t1 = time.perf_counter()
                result, stats = tcm_map_group(
                    w, arch, objective=objective,
                    prune_partial=prune_partial, engine=engine,
                    inc_obj=bound, tracer=tracer, budget=budget)
                t_search = time.perf_counter() - t1
                report.t_search += t_search
                if stats.truncated:
                    report.truncated = True
                    report.gap_bound = max(report.gap_bound,
                                           stats.gap_bound)
                cached = False
                if cache is not None and not stats.truncated:
                    cache.put_group(w, arch, objective, result, stats,
                                    t_search, prune_partial)
            adopted = (result is not None
                       and result.energy <= ind_e
                       and result.latency <= ind_l
                       and (result.energy < ind_e
                            or result.latency < ind_l))
            row = FusionRow(
                ops=w.name,
                shape=" & ".join(_shape_desc(e) for e in m_entries),
                n_instances=1, unfused_energy=ind_e, unfused_latency=ind_l,
                result=result, stats=stats, adopted=adopted, cached=cached,
                t_search=t_search,
                pin_level=(result.mapping.pin_level
                           if result is not None else None))
            rows_by_key[gkey] = row
            report.fused.append(row)
            if tracer is not None:
                tracer.instant(
                    "adopted" if adopted else "rejected", cat="fusion",
                    ops=w.name, adopted=adopted, fused_edp=row.fused_edp,
                    unfused_edp=row.unfused_edp, pin_level=row.pin_level,
                    cached=cached)
            if stats is not None:
                report.n_evaluated += stats.n_expanded
            if verbose:
                src = "cache" if cached else f"search {t_search:.2f}s"
                fe = (f"{row.fused_edp:.4g}" if row.fused_edp is not None
                      else "-")
                print(f"  [fuse] {w.name:<18} [{src}] fused_edp={fe} "
                      f"unfused_edp={row.unfused_edp:.4g} "
                      f"adopted={row.adopted}")
        if row.adopted:
            first = g.members[0]
            for n in g.members:
                adopted_member[n] = (first, row)


# --------------------------------------------------------------------------
# Kernel hook: whole-model SMEM tiles from one planner call
# --------------------------------------------------------------------------


def _mkn(entry: LayerEinsum) -> Optional[Tuple[int, int, int]]:
    """(M, K, N) of a (possibly batched) matmul entry; None otherwise."""
    shapes = entry.einsum.rank_shapes
    if set(shapes) in ({"m", "k", "n"}, {"h", "m", "k", "n"}):
        return (shapes["m"], shapes["k"], shapes["n"])
    return None


def model_shapes(cfg: ModelConfig, mode: str = "prefill", batch: int = 1,
                 seq: int = 1024) -> Dict[str, Tuple[int, int, int]]:
    """``{"L<layer>.<op>": (M, K, N)}`` for every matmul of one forward pass
    (per head for the batched attention matmuls), keyed as
    :func:`model_tiles` keys its tiles."""
    out: Dict[str, Tuple[int, int, int]] = {}
    for entry in extract_einsums(cfg, mode=mode, batch=batch, seq=seq):
        dims = _mkn(entry)
        if dims is not None:
            label = ("head" if entry.layer < 0 else f"L{entry.layer}")
            out[f"{label}.{entry.op}"] = dims
    return out


def model_tiles(cfg: ModelConfig, mode: str = "prefill", batch: int = 1,
                seq: int = 1024, word_bytes: int = 2
                ) -> Dict[str, Tuple[int, int, int]]:
    """Matmul kernel tiles for every matmul of a model, in one call.

    Returns ``{"L<layer>.<op>": (bm, bk, bn)}`` (``"head.lm_head"`` for the
    LM head) — batched attention matmuls are tiled per head.  Unique shapes
    are searched once (``tcm_matmul_plan`` memoizes).
    """
    return {key: tcm_matmul_tiles(*dims, word_bytes=word_bytes)
            for key, dims in model_shapes(cfg, mode, batch, seq).items()}
