"""MapspaceGym — one mapspace, one cost model, many searchers.

The gym exposes TCM's *own* search space — dataplacement x dataflow
skeleton x divisor-constrained tile shapes — and TCM's *own* cost
(``refmodel.evaluate``) to every metaheuristic baseline, so optimality-gap
curves measure search quality and nothing else ("Demystifying Map Space
Exploration for NPUs" framing: many searchers, one mapspace, one cost
model).  Because the space is identical, the gym doubles as an adversarial
soundness probe: a searcher that ever lands strictly below ``tcm_map``'s
returned optimum has found a bug in the incumbent/dominance/roofline bound
machinery (see ``repro_torch.gap.soundness``).

A point in the gym is a :class:`GymPoint`: a *unit* index (one
dataplacement x skeleton pair, exactly a :class:`~repro_torch.core.search.WorkUnit`)
plus one integer bound per free loop site of that unit's curried model.
Sampling and neighbourhood moves reuse the search's own stepper machinery
(``tileshape._Stepper`` / ``_FusedStepper``), so every sampled point
satisfies the same divisor chains and fanout capacities the exact search
enumerates — ``validate_structure``-clean by construction.

:class:`FusedMapspaceGym` is the same protocol over a fusion group's joint
mapspace (``enumerate_fused_skeletons`` units, ``FusedTileShapeModel``
cost), guarding ``tcm_map_group``'s ``_FusedStepper`` pruning.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.arch import Arch
from ..core.einsum import Einsum
from ..core.factor import prime_factorization
from ..core.fusion import FusedWorkload, enumerate_fused_skeletons
from ..core.looptree import Mapping
from ..core.refmodel import EvalResult, evaluate
from ..core.search import (cached_curried_model, cached_dataplacements,
                           cached_skeletons)
from ..core.tileshape import _Stepper

OBJECTIVE_KINDS = ("edp", "energy", "latency")


def objective_value(result, kind: str) -> float:
    """Objective of an evaluation result; ``ValueError`` on unknown kinds."""
    if kind not in OBJECTIVE_KINDS:
        raise ValueError(
            f"unknown objective kind {kind!r}; expected one of "
            f"{', '.join(OBJECTIVE_KINDS)}")
    return {"edp": result.edp, "energy": result.energy,
            "latency": result.latency}[kind]


@dataclass(frozen=True)
class GymPoint:
    """One complete candidate: a unit index + per-site loop bounds."""

    unit: int
    bounds: Tuple[int, ...]


@dataclass(frozen=True)
class GymEval:
    """Cost-model verdict for one point (fused groups have no
    :class:`~repro_torch.core.refmodel.EvalResult`; this is the shared subset)."""

    energy: float
    latency: float
    valid: bool

    @property
    def edp(self) -> float:
        return self.energy * self.latency


class _GymBase:
    """Sampling/neighbourhood machinery shared by both gym flavours.

    Subclasses provide ``self.units`` (list of ``(family, skeleton)`` where
    *family* groups units for the coarse hop move — the dataplacement index
    for single einsums, the pin level for fused groups), ``self._model(u)``
    and ``self._evaluate_model(model, point)``.
    """

    def __init__(self, seed_families: Sequence[int]):
        self.families = list(seed_families)
        self.by_family: Dict[int, List[int]] = {}
        for u, fam in enumerate(self.families):
            self.by_family.setdefault(fam, []).append(u)
        self.n_evals = 0
        self.n_valid = 0

    # -- per-unit structure -------------------------------------------------

    def _model(self, u: int):
        raise NotImplementedError

    def _stepper(self, u: int):
        # objective choice only affects bound/dominance kernels, which the
        # gym never queries; "edp" shares the cache entry tcm_map's default
        # search builds for the same curried model
        return _Stepper.get(self._model(u), "edp")

    def _site_fans(self, st, k: int) -> List[tuple]:
        """Fanout-capacity columns consumed by site ``k`` (both steppers)."""
        if hasattr(st, "site_fans"):  # fused
            return list(st.site_fans[k])
        s = st.sites[k]
        return [(s.fanout, s.dim)] if s.spatial else []

    def _fan_caps(self, st) -> Dict[tuple, int]:
        if hasattr(st, "site_fans"):
            return {(mi, fi, d): cap for (mi, fi, d, cap) in st.fan_dims}
        return {(fi, d): cap for (fi, d, cap) in st.fan_dims}

    def _site_groups(self, st) -> Dict[tuple, List[int]]:
        """Sites whose bounds are mutually exchangeable: they divide exactly
        the same quotient chains (per rank var for single einsums, per
        chain-set for fused groups)."""
        groups: Dict[tuple, List[int]] = {}
        for k in range(len(st.sites)):
            if hasattr(st, "site_chains"):
                key = tuple(st.site_chains[k])
            else:
                key = (st.sites[k].var,)
            groups.setdefault(key, []).append(k)
        return groups

    # -- sampling -----------------------------------------------------------

    def random_point(self, rng: random.Random,
                     unit: Optional[int] = None,
                     max_tries: int = 64) -> Optional[GymPoint]:
        """Uniform-ish random complete point (random unit, then a random
        walk down the stepper's own expansion order).  ``None`` when no
        valid completion is found within ``max_tries`` walks."""
        for _ in range(max_tries):
            u = unit if unit is not None else rng.randrange(len(self.units))
            bounds = self._walk(u, rng)
            if bounds is not None:
                return GymPoint(u, bounds)
        return None

    def _walk(self, u: int, rng: random.Random) -> Optional[Tuple[int, ...]]:
        """One random descent through the unit's site expansion order.

        At every site the stepper's ``expand`` enumerates exactly the legal
        divisor choices (divisibility chains + fanout capacity); we keep one
        at random.  A walk fails only when some quotient cannot be fully
        absorbed (e.g. a spatial-only var whose remainder exceeds the array
        dim) — callers simply retry.
        """
        st = self._stepper(u)
        cols, rem, fan_rem = st.init_state()
        for k in st.explore_order:
            out = st.expand(k, cols, rem, fan_rem)
            if out is None:
                return None
            ncols, nrem, nfan = out
            i = rng.randrange(ncols.shape[0])
            cols = ncols[i:i + 1]
            rem = nrem[i:i + 1]
            fan_rem = nfan[i:i + 1]
        if (rem != 1).any():
            return None
        return tuple(int(b) for b in cols[0])

    # -- evaluation ---------------------------------------------------------

    def mapping(self, point: GymPoint):
        return self._model(point.unit).concretize(point.bounds)

    def evaluate(self, point: GymPoint):
        self.n_evals += 1
        res = self._evaluate_model(self._model(point.unit), point)
        if res.valid:
            self.n_valid += 1
        return res

    # -- neighbourhood (simulated annealing / mutation) ---------------------

    def perturb(self, point: GymPoint,
                rng: random.Random) -> Optional[GymPoint]:
        """One random neighbourhood move: a tile-factor swap (move one prime
        factor between two sites of the same divisor group), a skeleton hop
        (same family: a loop-order/dataflow transposition), or a family hop
        (different dataplacement / pin level)."""
        move = rng.random()
        if move < 0.6:
            moved = self._factor_move(point, rng)
            if moved is not None:
                return moved
            move = 0.7  # degenerate unit (no movable factor): hop instead
        fam = self.families[point.unit]
        if move < 0.85:
            peers = [u for u in self.by_family[fam] if u != point.unit]
        else:
            peers = [u for u in range(len(self.units))
                     if self.families[u] != fam]
        if not peers:
            peers = [u for u in range(len(self.units)) if u != point.unit]
        if not peers:
            return self._factor_move(point, rng)
        return self.random_point(rng, unit=peers[rng.randrange(len(peers))],
                                 max_tries=8)

    def _factor_move(self, point: GymPoint,
                     rng: random.Random) -> Optional[GymPoint]:
        st = self._stepper(point.unit)
        groups = [ks for ks in self._site_groups(st).values() if len(ks) >= 2]
        rng.shuffle(groups)
        for ks in groups:
            sources = [k for k in ks if point.bounds[k] > 1]
            if not sources:
                continue
            i = sources[rng.randrange(len(sources))]
            primes = [p for p, _ in prime_factorization(point.bounds[i])]
            p = primes[rng.randrange(len(primes))]
            targets = [k for k in ks if k != i]
            j = targets[rng.randrange(len(targets))]
            if not self._fan_move_ok(st, point.bounds, j, p):
                continue
            bounds = list(point.bounds)
            bounds[i] //= p
            bounds[j] *= p
            return GymPoint(point.unit, tuple(bounds))
        return None

    def _fan_move_ok(self, st, bounds: Sequence[int], j: int, p: int) -> bool:
        """Would multiplying site ``j``'s bound by ``p`` stay within every
        fanout dim it occupies?"""
        fans_j = self._site_fans(st, j)
        if not fans_j:
            return True
        caps = self._fan_caps(st)
        used: Dict[tuple, int] = {}
        for k in range(len(st.sites)):
            for fd in self._site_fans(st, k):
                used[fd] = used.get(fd, 1) * int(bounds[k])
        return all(used[fd] * p <= caps[fd] for fd in fans_j)

    # -- crossover (evolutionary mapper) ------------------------------------

    def crossover(self, a: GymPoint, b: GymPoint,
                  rng: random.Random) -> GymPoint:
        """GAMMA-style recombination: when both parents share a unit, the
        child inherits each rank var's (divisor-group's) factorization from
        a random parent; across units the child is a random parent (the
        mutation step supplies cross-unit drift)."""
        if a.unit != b.unit:
            return a if rng.random() < 0.5 else b
        st = self._stepper(a.unit)
        bounds = list(a.bounds)
        for ks in self._site_groups(st).values():
            if rng.random() < 0.5:
                for k in ks:
                    bounds[k] = b.bounds[k]
        child = GymPoint(a.unit, tuple(bounds))
        # mixed groups can overfill a fanout dim shared across vars; fall
        # back to a pure parent rather than produce an illegal point
        caps = self._fan_caps(st)
        used: Dict[tuple, int] = {}
        for k in range(len(st.sites)):
            for fd in self._site_fans(st, k):
                used[fd] = used.get(fd, 1) * child.bounds[k]
        if any(v > caps[fd] for fd, v in used.items()):
            return a if rng.random() < 0.5 else b
        return child


class MapspaceGym(_GymBase):
    """The single-einsum gym: TCM's pruned dataplacement x skeleton units,
    tile shapes divisor-constrained, cost = ``refmodel.evaluate`` on the
    concretized mapping (the numeric reference model, not the compiled
    tile-shape kernels — identical semantics, independent code path, which
    is exactly what a soundness cross-check wants)."""

    def __init__(self, einsum: Einsum, arch: Arch):
        self.einsum = einsum
        self.arch = arch
        self.units: List[tuple] = []
        families: List[int] = []
        for dpi, dp in enumerate(cached_dataplacements(einsum, arch)):
            for sk in cached_skeletons(einsum, arch, dp):
                self.units.append((dpi, sk))
                families.append(dpi)
        super().__init__(families)

    def _model(self, u: int):
        return cached_curried_model(self.einsum, self.arch, self.units[u][1])

    def _evaluate_model(self, model, point: GymPoint) -> EvalResult:
        return evaluate(self.einsum, self.arch, model.concretize(point.bounds))


class FusedMapspaceGym(_GymBase):
    """The fusion-group gym: one unit per fused skeleton (pin level x member
    dataplacements x member skeletons), cost = the joint
    ``FusedTileShapeModel`` — the exact model ``tcm_map_group`` optimizes,
    so a random sample landing below its optimum indicts the
    ``_FusedStepper`` pruning directly."""

    def __init__(self, workload: FusedWorkload, arch: Arch,
                 max_units: Optional[int] = 4096):
        self.workload = workload
        self.arch = arch
        skeletons = enumerate_fused_skeletons(workload, arch,
                                              max_units=max_units)
        self.units = [(sk.pin_level, sk) for sk in skeletons]
        super().__init__([sk.pin_level for sk in skeletons])

    def _model(self, u: int):
        return cached_curried_model(self.workload, self.arch,
                                    self.units[u][1])

    def _evaluate_model(self, model, point: GymPoint) -> GymEval:
        e, l, valid = model.tile_shape_model(
            np.asarray([point.bounds], dtype=np.int64))
        return GymEval(float(e[0]), float(l[0]), bool(valid[0]))
