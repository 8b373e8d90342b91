"""The curried model (paper §IV-D, §V-C) and its fused-group extension.

``CurriedModel(einsum, arch, skeleton)`` runs the expensive structural/symbolic
analysis ONCE for a given (dataplacement, dataflow) skeleton, producing
polynomial expressions for energy, latency and per-level usage over one symbol
per loop bound.  ``TileShapeOnlyModel`` then evaluates those expressions for
millions of candidate tile shapes as vectorized numpy arithmetic — the paper's
"tile-shape-only model is run 2M times but consumes <0.1% of runtime".

``FusedCurriedModel`` generalizes the currying to a whole fusion group: each
member einsum is analyzed over its own LoopTree (backing, shared co-tiled
prefix, pinned intermediate nodes, member skeleton) with the prefix loops
bound to *shared* symbols, and the members' expressions compose —

  * energy is the sum of member energy polynomials (members run
    sequentially per prefix iteration);
  * latency is the sum of the member latency maxes, kept as one ``MaxExpr``
    per member so lower bounds and dominance criteria stay arm-wise sound;
  * capacity is phase-local: one constraint per (member, level), plus the
    pinned tiles of intermediates that stay live across a middle member.

Because a pinned intermediate has no level-0 node, its DRAM traffic is
structurally zero and every access is charged at the pin level — the
fusion-aware cost model falls out of the unchanged per-member analysis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arch import Arch
from .einsum import Einsum
from .fusion import (FusedMapping, FusedSkeleton, FusedWorkload,
                     member_prefix_vars, pinned_roles, shared_classes)
from .looptree import Loop, Mapping, Storage
from .refmodel import analyze
from .symbolic import CompiledExpr, MaxExpr, Mono, Poly


@dataclass(frozen=True)
class LoopSite:
    """One loop in the skeleton whose bound is a free symbol."""

    index: int  # position in the skeleton mapping
    sym: str
    var: str
    spatial: bool
    fanout: int
    dim: int


class CurriedModel:
    """FullModel(dataplacement, dataflow) -> TileShapeOnlyModel."""

    def __init__(self, einsum: Einsum, arch: Arch, skeleton: Mapping):
        self.einsum = einsum
        self.arch = arch
        self.skeleton = skeleton

        self.sites: List[LoopSite] = []
        sym_by_id: Dict[int, str] = {}
        for i, n in enumerate(skeleton):
            if isinstance(n, Loop):
                sym = f"b{i}"
                sym_by_id[id(n)] = sym
                self.sites.append(
                    LoopSite(i, sym, n.var, n.spatial, n.fanout, n.dim))
        self.sym_order: Tuple[str, ...] = tuple(s.sym for s in self.sites)

        st = analyze(einsum, arch, skeleton,
                     bound_of=lambda l: Poly.sym(sym_by_id[id(l)]))
        self.stats = st

        # Energy polynomial (pJ).
        energy = st.computes * arch.mac_energy
        self.usage: Dict[int, Poly] = {}
        latency_terms: List[Poly] = [
            st.computes / (st.utilized_units * arch.frequency)
        ]
        for m, lvl in enumerate(arch.levels):
            r = st.level_reads.get(m, Poly.const(0))
            w = st.level_writes.get(m, Poly.const(0))
            u = st.level_usage.get(m, None)
            inst = st.level_instances.get(m, Poly.const(1))
            if u is not None:
                self.usage[m] = _as_poly(u)
            energy = energy + _as_poly(r) * lvl.read_energy \
                + _as_poly(w) * lvl.write_energy
            if lvl.read_bandwidth is not None:
                latency_terms.append(
                    _as_poly(r) / (_as_mono(inst) * lvl.read_bandwidth))
                latency_terms.append(
                    _as_poly(w) / (_as_mono(inst) *
                                   (lvl.write_bandwidth or lvl.read_bandwidth)))
            else:
                latency_terms.append(
                    (_as_poly(r) + _as_poly(w)) / (_as_mono(inst) * lvl.bandwidth))
        self.energy: Poly = _as_poly(energy)
        self.latency: MaxExpr = MaxExpr(latency_terms)
        self.utilized_units: Poly = _as_poly(st.utilized_units)

        # Compiled evaluators (built lazily).
        self._compiled: Optional[TileShapeOnlyModel] = None
        # Per-objective exploration steppers (tileshape._Stepper) with their
        # compiled per-known-set criteria kernels.  Keyed on the objective
        # string; cached here so every explore/beam-dive over this curried
        # model — and repeated tcm_map calls hitting the lru-cached model —
        # reuse one compiled set.  Dropped with the model by clear_caches().
        self.stepper_cache: Dict[str, object] = {}

    @property
    def tile_shape_model(self) -> "TileShapeOnlyModel":
        if self._compiled is None:
            self._compiled = TileShapeOnlyModel(self)
        return self._compiled

    def concretize(self, bounds: Sequence[int]) -> Mapping:
        """Instantiate the skeleton with numeric loop bounds."""
        out = list(self.skeleton)
        for site, b in zip(self.sites, bounds):
            l = out[site.index]
            out[site.index] = Loop(l.var, int(b), l.spatial, l.fanout, l.dim)
        return tuple(out)


class TileShapeOnlyModel:
    """Vectorized numeric evaluation of the curried expressions.

    ``__call__`` takes an int array (n_candidates, n_loops) in site order and
    returns (energy, latency, valid) arrays.
    """

    def __init__(self, cm: CurriedModel):
        self.cm = cm
        order = cm.sym_order
        self._energy = CompiledExpr(cm.energy, order)
        self._latency = CompiledExpr(cm.latency, order)
        self._usage = [
            (cm.arch.levels[m].capacity, CompiledExpr(p, order))
            for m, p in sorted(cm.usage.items())
            if cm.arch.levels[m].capacity != float("inf")
        ]

    def __call__(self, bounds: np.ndarray):
        cols = bounds.astype(np.float64)
        energy = self._energy(cols)
        latency = self._latency(cols)
        valid = np.ones(cols.shape[0], dtype=bool)
        for cap, ucomp in self._usage:
            valid &= ucomp(cols) <= cap
        return energy, latency, valid


# ---------------------------------------------------------------------------
# Fused groups
# ---------------------------------------------------------------------------


class FusedCurriedModel:
    """Joint curried model of a fusion group (same surface as CurriedModel).

    Exposes the exploration interface the tile-shape search consumes —
    ``sites`` / ``sym_order`` / ``tile_shape_model`` / ``concretize`` /
    ``stepper_cache`` — plus the chain structure the fused stepper needs:
    each (member, rank var) pair is a divisibility *chain*; a shared-prefix
    site divides every chain of its class at once, member sites divide their
    own chain, and structurally tied members share sites outright.
    """

    is_fused = True

    def __init__(self, workload: FusedWorkload, arch: Arch,
                 skeleton: FusedSkeleton):
        self.workload = workload
        self.arch = arch
        self.skeleton = skeleton
        classes = shared_classes(workload)
        pvars = member_prefix_vars(workload)
        roles = pinned_roles(workload)
        self.classes = classes
        self.pin_level = skeleton.pin_level
        self.pinned: Tuple[Tuple[int, str], ...] = tuple(
            (i, t) for i, role in enumerate(roles) for t in role)

        # chains: one per (member, rank var)
        self.chain_ids: Dict[Tuple[int, str], int] = {}
        self.chain_shapes: List[int] = []
        for i, m in enumerate(workload.members):
            for v in sorted(m.rank_shapes):
                self.chain_ids[(i, v)] = len(self.chain_shapes)
                self.chain_shapes.append(m.rank_shapes[v])
        self.chain_prefix_sym: List[Optional[str]] = [None] * len(
            self.chain_shapes)
        for j, cls in enumerate(classes):
            for pair in cls:
                self.chain_prefix_sym[self.chain_ids[pair]] = f"p{j}"

        # prefix sites (explored first; one per shared class)
        self.sites: List[LoopSite] = []
        self.site_chains: List[Tuple[int, ...]] = []
        self.site_fans: List[Tuple[Tuple[int, int, int], ...]] = []
        self.site_member: List[Optional[int]] = []
        self.site_writers: List[List[Tuple[int, int]]] = []
        for j, cls in enumerate(classes):
            self.sites.append(LoopSite(
                index=-1, sym=f"p{j}", var="|".join(v for _, v in cls),
                spatial=False, fanout=-1, dim=-1))
            self.site_chains.append(tuple(self.chain_ids[p] for p in cls))
            self.site_fans.append(())
            self.site_member.append(None)
            self.site_writers.append([])

        # member mappings: insert the prefix between level-0 backing and the
        # pinned nodes, bind prefix loops to the shared class symbols and
        # member loops to per-site symbols (tied members share Loop objects,
        # hence sites and symbols)
        bound_map: Dict[int, Poly] = {}
        site_of_loop: Dict[int, int] = {}
        self.member_mappings: List[Tuple] = []
        for i in range(len(workload.members)):
            nodes = list(skeleton.members[i])
            n_l0 = skeleton.n_level0[i]
            prefix_loops = [(j, Loop(v, 1)) for j, v in enumerate(pvars[i])
                            if v is not None]
            mapping = (nodes[:n_l0] + [l for _, l in prefix_loops]
                       + nodes[n_l0:])
            for off, (j, loop) in enumerate(prefix_loops):
                bound_map[id(loop)] = Poly.sym(f"p{j}")
                self.site_writers[j].append((i, n_l0 + off))
            for pos, n in enumerate(mapping):
                if not isinstance(n, Loop) or id(n) in bound_map:
                    if isinstance(n, Loop) and id(n) in site_of_loop:
                        # tied member: same Loop object, shared site
                        k = site_of_loop[id(n)]
                        self.site_writers[k].append((i, pos))
                        ci = self.chain_ids[(i, n.var)]
                        if ci not in self.site_chains[k]:
                            self.site_chains[k] += (ci,)
                        if n.spatial:
                            self.site_fans[k] += ((i, n.fanout, n.dim),)
                    continue
                k = len(self.sites)
                sym = f"m{i}b{pos}"
                bound_map[id(n)] = Poly.sym(sym)
                site_of_loop[id(n)] = k
                self.sites.append(LoopSite(
                    index=pos, sym=sym, var=n.var, spatial=n.spatial,
                    fanout=n.fanout, dim=n.dim))
                self.site_chains.append((self.chain_ids[(i, n.var)],))
                self.site_fans.append(
                    ((i, n.fanout, n.dim),) if n.spatial else ())
                self.site_member.append(i)
                self.site_writers.append([(i, pos)])
            self.member_mappings.append(tuple(mapping))
        self.sym_order: Tuple[str, ...] = tuple(s.sym for s in self.sites)

        # per-member analysis over the shared symbol space
        bound_of = lambda l: bound_map[id(l)]
        energy: Poly = Poly.const(0.0)
        latency_parts: List[MaxExpr] = []
        usage_entries: List[Tuple[float, Poly]] = []
        self.member_stats = []
        for i, m in enumerate(workload.members):
            st = analyze(m, arch, self.member_mappings[i], bound_of=bound_of)
            self.member_stats.append(st)
            e = st.computes * arch.mac_energy
            terms: List[Poly] = [
                st.computes / (st.utilized_units * arch.frequency)]
            for lvl_i, lvl in enumerate(arch.levels):
                r = st.level_reads.get(lvl_i, Poly.const(0))
                w = st.level_writes.get(lvl_i, Poly.const(0))
                u = st.level_usage.get(lvl_i, None)
                inst = st.level_instances.get(lvl_i, Poly.const(1))
                if u is not None:
                    usage_entries.append((lvl.capacity, _as_poly(u)))
                e = e + _as_poly(r) * lvl.read_energy \
                    + _as_poly(w) * lvl.write_energy
                if lvl.read_bandwidth is not None:
                    terms.append(
                        _as_poly(r) / (_as_mono(inst) * lvl.read_bandwidth))
                    terms.append(_as_poly(w) / (_as_mono(inst) * (
                        lvl.write_bandwidth or lvl.read_bandwidth)))
                else:
                    terms.append((_as_poly(r) + _as_poly(w))
                                 / (_as_mono(inst) * lvl.bandwidth))
            energy = energy + _as_poly(e)
            latency_parts.append(MaxExpr(terms))

        # intermediates alive across a middle member's phase add their
        # pinned tile to that member's pin-level footprint
        pin_cap = arch.levels[self.pin_level].capacity
        for mid in range(len(workload.members)):
            extra: Optional[Poly] = None
            for e in workload.edges:
                if e.producer < mid < e.consumer:
                    t = self._pinned_tile_poly(e)
                    extra = t if extra is None else extra + t
            if extra is not None:
                own = self.member_stats[mid].level_usage.get(
                    self.pin_level, 0)
                usage_entries.append((pin_cap, _as_poly(own) + extra))

        self.energy: Poly = energy
        self.latency_parts: Tuple[MaxExpr, ...] = tuple(latency_parts)
        self.usage_entries: Tuple[Tuple[float, Poly], ...] = tuple(
            usage_entries)
        self._compiled: Optional[FusedTileShapeModel] = None
        self.stepper_cache: Dict[str, object] = {}

    def _pinned_tile_poly(self, edge) -> Poly:
        """Tile of ``edge``'s intermediate at the pin level, as analyzed on
        the producer side (a product of member loop bounds — positive
        powers only, so capacity lower-bounding stays monotone)."""
        st = self.member_stats[edge.producer]
        for ns in st.node_stats:
            if ns.storage.level == self.pin_level \
                    and ns.storage.tensor == edge.tensor:
                return _as_poly(ns.tile_size)
        raise AssertionError(
            f"producer {edge.producer} has no pin node for {edge.tensor}")

    @property
    def tile_shape_model(self) -> "FusedTileShapeModel":
        if self._compiled is None:
            self._compiled = FusedTileShapeModel(self)
        return self._compiled

    def concretize(self, bounds: Sequence[int]) -> FusedMapping:
        """Instantiate every member's LoopTree with numeric bounds."""
        mms = [list(m) for m in self.member_mappings]
        for writers, b in zip(self.site_writers, bounds):
            for i, pos in writers:
                l = mms[i][pos]
                mms[i][pos] = Loop(l.var, int(b), l.spatial, l.fanout, l.dim)
        return FusedMapping(members=tuple(tuple(m) for m in mms),
                            pin_level=self.pin_level, pinned=self.pinned)


class FusedTileShapeModel:
    """Vectorized numeric evaluation of a fused group's curried expressions:
    energy sums, per-member latency maxes sum, and every phase-local
    capacity constraint must hold."""

    def __init__(self, cm: FusedCurriedModel):
        self.cm = cm
        order = cm.sym_order
        self._energy = CompiledExpr(cm.energy, order)
        self._latencies = [CompiledExpr(p, order) for p in cm.latency_parts]
        self._usage = [(cap, CompiledExpr(p, order))
                       for cap, p in cm.usage_entries
                       if cap != float("inf")]

    def __call__(self, bounds: np.ndarray):
        cols = bounds.astype(np.float64)
        energy = self._energy(cols)
        latency = self._latencies[0](cols)
        for lat in self._latencies[1:]:
            latency = latency + lat(cols)
        valid = np.ones(cols.shape[0], dtype=bool)
        for cap, ucomp in self._usage:
            valid &= ucomp(cols) <= cap
        return energy, latency, valid


def _as_poly(x) -> Poly:
    if isinstance(x, Poly):
        return x
    return Poly.const(float(x))


def _as_mono(x) -> Mono:
    if isinstance(x, Poly):
        assert len(x.monos) <= 1
        return x.monos[0] if x.monos else Mono.make(0.0)
    return Mono.make(float(x))
