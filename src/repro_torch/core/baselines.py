"""Baseline mappers (paper §VI-E + the optimality-gap harness): Timeloop-like
random sampling, Timeloop+Hint (full-spatial-utilization constraint), a
LOMA-like tile-shapes-first enumerator with an LPF budget, a simulated-
annealing mapper, and a GAMMA-style evolutionary mapper ("Evolutionary
Mapping of Neural Networks to Spatial Accelerators").

All baselines evaluate with the SAME reference model as TCM, so EDP
comparisons isolate *search* quality, exactly as in the paper.  Budgets are
expressed in model evaluations rather than wall-clock (single-core container;
see DESIGN.md), with wall-clock reported alongside.  Every baseline is fully
deterministic under a given seed — best-mapping selection uses a strict
``<`` in evaluation order with no wall-clock-dependent tie-breaks — so gap
curves and soundness-fuzz repro cases replay bit-identically.

The annealing and evolutionary mappers search through
:class:`repro_torch.gap.gym.MapspaceGym` — TCM's own pruned mapspace under
``refmodel.evaluate`` — while the Timeloop/LOMA samplers draw from the
*unpruned* space; together they probe both layers of the bound machinery
(see ``repro_torch.gap``).
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from itertools import permutations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arch import Arch
from .dataflow import _spatial_block, make_slots
from .dataplacement import enumerate_dataplacements
from .einsum import Einsum
from .looptree import Loop, Mapping, Storage
from .refmodel import EvalResult, evaluate

_OBJECTIVE_KINDS = ("edp", "energy", "latency")


@dataclass
class BaselineResult:
    best_mapping: Optional[Mapping]
    best: Optional[EvalResult]
    n_evaluated: int
    n_valid: int
    wall_s: float

    def objective(self, kind: str = "edp") -> float:
        if kind not in _OBJECTIVE_KINDS:
            raise ValueError(
                f"unknown objective kind {kind!r}; expected one of "
                f"{', '.join(_OBJECTIVE_KINDS)}")
        if self.best is None:
            return float("inf")
        return {"edp": self.best.edp, "energy": self.best.energy,
                "latency": self.best.latency}[kind]


def _check_kind(kind: str) -> None:
    if kind not in _OBJECTIVE_KINDS:
        raise ValueError(
            f"unknown objective kind {kind!r}; expected one of "
            f"{', '.join(_OBJECTIVE_KINDS)}")


def _obj(res, kind: str) -> float:
    """Objective of an evaluation result; ``ValueError`` on unknown kinds."""
    _check_kind(kind)
    return {"edp": res.edp, "energy": res.energy,
            "latency": res.latency}[kind]


def _rand_factorization(rng: random.Random, n: int, k: int) -> List[int]:
    """Uniform-ish random ordered factorization of n into k factors."""
    out = [1] * k
    for p, e in _prime_factors(n):
        for _ in range(e):
            out[rng.randrange(k)] *= p
    return out


def _prime_factors(n: int) -> List[Tuple[int, int]]:
    out = []
    d = 2
    while d * d <= n:
        e = 0
        while n % d == 0:
            n //= d
            e += 1
        if e:
            out.append((d, e))
        d += 1
    if n > 1:
        out.append((n, 1))
    return out


class _MapSampler:
    """Samples random complete mappings from the unpruned mapspace."""

    def __init__(self, einsum: Einsum, arch: Arch, seed: int = 0,
                 full_spatial: bool = False):
        self.einsum = einsum
        self.arch = arch
        self.rng = random.Random(seed)
        self.full_spatial = full_spatial
        self.dps = list(enumerate_dataplacements(einsum, arch))

    def sample(self) -> Optional[Mapping]:
        rng = self.rng
        einsum, arch = self.einsum, self.arch
        dp = rng.choice(self.dps)
        nodes = list(dp)
        last_backing = max(i for i, s in enumerate(nodes) if s.level == 0)
        slots = make_slots(einsum, arch, dp)
        n_slots = len(slots)

        spatial_at: Dict[int, List[Loop]] = {}
        spatial_sites: List[Loop] = []
        for fi, fan in enumerate(arch.fanouts):
            pos = len(nodes)
            for i, s in enumerate(nodes):
                if s.level > fan.above_level:
                    pos = i
                    break
            blk = _spatial_block(einsum, arch, fi)
            spatial_at.setdefault(pos, []).extend(blk)
            spatial_sites.extend(blk)

        # choose spatial bounds first
        sp_bounds: Dict[int, int] = {}
        fan_cap = {(fi, d): c for fi, fan in enumerate(arch.fanouts)
                   for d, c in enumerate(fan.dims)}
        rem_shape = dict(einsum.rank_shapes)
        sp_by_var: Dict[str, List[Loop]] = {}
        for s in spatial_sites:
            sp_by_var.setdefault(s.var, []).append(s)
        for v, sites in sp_by_var.items():
            for s in sites:
                cap = fan_cap[(s.fanout, s.dim)]
                divs = [d for d in range(1, rem_shape[v] + 1)
                        if rem_shape[v] % d == 0 and d <= cap]
                if self.full_spatial:
                    # hint: use the largest divisor that fits the dim
                    b = max(divs)
                else:
                    b = rng.choice(divs)
                sp_bounds[id(s)] = b
                rem_shape[v] //= b
                fan_cap[(s.fanout, s.dim)] = cap // b

        # temporal factorizations across all slots (unpruned space)
        slot_loops: List[List[Loop]] = [[] for _ in range(n_slots)]
        for v in einsum.rank_vars:
            fac = _rand_factorization(rng, rem_shape[v], n_slots)
            for si, b in enumerate(fac):
                slot_loops[si].append(Loop(v, b))
        for sl in slot_loops:
            rng.shuffle(sl)

        m: List = list(nodes[:last_backing + 1])
        for k in range(n_slots):
            node_idx = last_backing + k + 1
            m.extend(slot_loops[k])
            if node_idx in spatial_at:
                for s in spatial_at[node_idx]:
                    b = sp_bounds.get(id(s), 1)
                    m.append(Loop(s.var, b, spatial=True,
                                  fanout=s.fanout, dim=s.dim))
            if node_idx < len(nodes):
                m.append(nodes[node_idx])
        return tuple(m)


def timeloop_like(einsum: Einsum, arch: Arch, budget_evals: int,
                  seed: int = 0, objective: str = "edp",
                  full_spatial_hint: bool = False) -> BaselineResult:
    """Random-sampling mapper (Timeloop [1]); optional +Hint variant that
    maximizes spatial-array utilization (the paper's common user constraint)."""
    sampler = _MapSampler(einsum, arch, seed, full_spatial=full_spatial_hint)
    best: Optional[Tuple[float, Mapping, EvalResult]] = None
    n_valid = 0
    t0 = time.perf_counter()
    for _ in range(budget_evals):
        m = sampler.sample()
        if m is None:
            continue
        res = evaluate(einsum, arch, m)
        if not res.valid:
            continue
        n_valid += 1
        obj = _obj(res, objective)
        if best is None or obj < best[0]:
            best = (obj, m, res)
    wall = time.perf_counter() - t0
    if best is None:
        return BaselineResult(None, None, budget_evals, 0, wall)
    return BaselineResult(best[1], best[2], budget_evals, n_valid, wall)


def loma_like(einsum: Einsum, arch: Arch, budget_evals: int,
              lpf_limit: int = 2, seed: int = 0,
              objective: str = "edp") -> BaselineResult:
    """LOMA-like [9]: enumerate tile shapes first (limited to `lpf_limit`
    prime factors per loop), then assign loops to levels bottom-up with a
    per-level stationarity heuristic; spatial units fully utilized.

    This reproduces LOMA's qualitative behaviour: good mappings quickly, but
    the LPF cap and the one-level-at-a-time heuristic miss the optimum.
    """
    rng = random.Random(seed)
    sampler = _MapSampler(einsum, arch, seed, full_spatial=True)
    best: Optional[Tuple[float, Mapping, EvalResult]] = None
    n_eval = 0
    n_valid = 0
    t0 = time.perf_counter()
    # LOMA factorizes into "loop prime factors"; we emulate the LPF budget by
    # capping the number of >1 factors each rank var may split into.
    while n_eval < budget_evals:
        m = sampler.sample()
        if m is None:
            break
        # enforce LPF: merge var factors until each var has <= lpf_limit
        # non-unit temporal loops (merge into the innermost)
        counts: Dict[str, List[int]] = {}
        out: List = []
        positions: Dict[str, List[int]] = {}
        for i, node in enumerate(m):
            out.append(node)
            if isinstance(node, Loop) and not node.spatial and node.bound > 1:
                positions.setdefault(node.var, []).append(i)
        for v, pos in positions.items():
            while len(pos) > lpf_limit:
                # merge outermost non-unit loop into the innermost
                j = pos.pop(0)
                l_out = out[j]
                k = pos[-1]
                l_in = out[k]
                out[j] = Loop(l_out.var, 1)
                out[k] = Loop(l_in.var, l_in.bound * l_out.bound)
        m2 = tuple(n for n in out
                   if not (isinstance(n, Loop) and n.bound == 1))
        res = evaluate(einsum, arch, m2)
        n_eval += 1
        if not res.valid:
            continue
        n_valid += 1
        obj = _obj(res, objective)
        if best is None or obj < best[0]:
            best = (obj, m2, res)
    wall = time.perf_counter() - t0
    if best is None:
        return BaselineResult(None, None, n_eval, 0, wall)
    return BaselineResult(best[1], best[2], n_eval, n_valid, wall)


# ---------------------------------------------------------------------------
# Gym-based metaheuristics (the optimality-gap harness's competitors)
# ---------------------------------------------------------------------------


def simulated_annealing(einsum: Einsum, arch: Arch, budget_evals: int,
                        seed: int = 0, objective: str = "edp",
                        t_start: float = 0.5, t_end: float = 1e-3,
                        ) -> BaselineResult:
    """Simulated-annealing mapper over TCM's own mapspace.

    Searches through :class:`repro_torch.gap.gym.MapspaceGym` (dataplacement x
    skeleton x divisor-constrained tile shapes, ``refmodel.evaluate`` cost).
    Neighbourhood = tile-factor swaps, loop-order/skeleton transpositions
    and dataplacement hops (``MapspaceGym.perturb``).  Acceptance uses the
    *relative* objective gap ``obj/cur - 1`` so the temperature schedule is
    scale-free across workloads and objectives; the schedule is geometric
    from ``t_start`` to ``t_end`` over the eval budget.  Invalid (capacity-
    violating) candidates consume budget but are never accepted.
    """
    from ..gap.gym import MapspaceGym

    _check_kind(objective)
    gym = MapspaceGym(einsum, arch)
    rng = random.Random(seed)
    t0 = time.perf_counter()
    best: Optional[Tuple[float, Mapping, EvalResult]] = None
    cur: Optional[object] = None
    cur_obj = float("inf")
    alpha = (t_end / t_start) ** (1.0 / max(budget_evals - 1, 1))
    temp = t_start
    while gym.n_evals < budget_evals:
        if cur is None:
            cand = gym.random_point(rng)
            if cand is None:
                break
        else:
            cand = gym.perturb(cur, rng) or gym.random_point(rng)
            if cand is None:
                temp *= alpha
                continue
        res = gym.evaluate(cand)
        temp *= alpha
        if not res.valid:
            continue
        obj = _obj(res, objective)
        if best is None or obj < best[0]:
            best = (obj, gym.mapping(cand), res)
        if (obj < cur_obj
                or rng.random() < math.exp(
                    -max(obj / cur_obj - 1.0, 0.0) / max(temp, 1e-12))):
            cur, cur_obj = cand, obj
    wall = time.perf_counter() - t0
    if best is None:
        return BaselineResult(None, None, gym.n_evals, gym.n_valid, wall)
    return BaselineResult(best[1], best[2], gym.n_evals, gym.n_valid, wall)


def evolutionary(einsum: Einsum, arch: Arch, budget_evals: int,
                 seed: int = 0, objective: str = "edp",
                 pop_size: int = 24, elite: int = 4,
                 tournament: int = 3, mutate_p: float = 0.5,
                 ) -> BaselineResult:
    """GAMMA-style evolutionary mapper over TCM's own mapspace.

    Genome = a :class:`~repro_torch.gap.gym.GymPoint` (unit + per-site tile
    factors).  Crossover recombines per-rank-var factorizations between
    parents sharing a unit (``MapspaceGym.crossover``); mutation is the
    annealer's neighbourhood move, which also drifts across skeletons and
    dataplacements.  Tournament selection + elitism; invalid candidates get
    an infinite fitness.  Fully deterministic under ``seed``.
    """
    from ..gap.gym import MapspaceGym

    _check_kind(objective)
    gym = MapspaceGym(einsum, arch)
    rng = random.Random(seed)
    t0 = time.perf_counter()
    best: Optional[Tuple[float, Mapping, EvalResult]] = None

    def fitness(point):
        nonlocal best
        res = gym.evaluate(point)
        if not res.valid:
            return float("inf")
        obj = _obj(res, objective)
        if best is None or obj < best[0]:
            best = (obj, gym.mapping(point), res)
        return obj

    pop: List[Tuple[float, object]] = []
    while len(pop) < pop_size and gym.n_evals < budget_evals:
        p = gym.random_point(rng)
        if p is None:
            break
        pop.append((fitness(p), p))

    def select():
        # tournament over list positions: ties break to the earlier insert
        contenders = sorted(rng.randrange(len(pop)) for _ in range(tournament))
        return min(contenders, key=lambda i: (pop[i][0], i))

    while pop and gym.n_evals < budget_evals:
        ranked = sorted(range(len(pop)), key=lambda i: (pop[i][0], i))
        nxt = [pop[i] for i in ranked[:elite]]
        while len(nxt) < pop_size and gym.n_evals < budget_evals:
            pa, pb = pop[select()][1], pop[select()][1]
            child = gym.crossover(pa, pb, rng)
            if rng.random() < mutate_p:
                child = gym.perturb(child, rng) or child
            nxt.append((fitness(child), child))
        pop = nxt
    wall = time.perf_counter() - t0
    if best is None:
        return BaselineResult(None, None, gym.n_evals, gym.n_valid, wall)
    return BaselineResult(best[1], best[2], gym.n_evals, gym.n_valid, wall)
