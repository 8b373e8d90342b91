"""Tile-shape exploration with partial-tile-shape pruning (paper §V-D).

Loops are explored one at a time (innermost first, exhausting each rank var
before moving on — the order the paper found most effective).  Divisibility
is maintained as a per-var remaining quotient; the *last-explored temporal*
loop of each var absorbs the remainder, so every exact factorization is
reachable.  Between steps, partial candidates are pruned by two sound rules,
both instances of the paper's criterion "will result in worse metrics
regardless of future tile shape choices" (§IV-C):

  1. **Dominance** over criteria generated from the curried model
     (``symbolic.grouped_criteria``) within cannot-compare groups keyed by
     remaining quotients and remaining fanout capacity.

  2. **Objective lower bounds vs an incumbent** (branch-and-bound): each
     partial candidate's objective is bounded below by substituting, per
     monomial, the unknown bounds that minimize it (1 for positive exponents,
     the max feasible value for negative exponents; reversed for negative
     coefficients).  Candidates whose bound already meets or exceeds the best
     complete mapping found by a cheap beam dive are pruned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .factor import divisors
from .model import CurriedModel, LoopSite
from .symbolic import (Criterion, CriteriaKernel, Poly, expr_polys,
                       grouped_criteria)


@dataclass
class ExploreStats:
    n_expanded: int = 0  # partial candidates generated across all steps
    n_final: int = 0  # full tile shapes evaluated by the tile-shape model
    n_pruned_dominated: int = 0
    n_pruned_invalid: int = 0
    n_pruned_bound: int = 0
    max_frontier: int = 0
    truncated: bool = False  # stopped by an expired SearchBudget


@dataclass
class ExploreResult:
    # best full assignment, site order; None only on a truncated search
    # whose beam dive found no complete mapping (anytime best-so-far absent)
    bounds: Optional[np.ndarray]
    energy: float
    latency: float
    edp: float
    stats: ExploreStats
    truncated: bool = False
    # sound objective lower bound over every valid completion of this unit,
    # inf when the search ran to completion (exact — no gap to certify)
    lower_bound: float = float("inf")


PARETO_EXACT_N = 2048
_UNSET = object()  # sentinel: _Stepper's beam dive not computed yet


def _divisors(n: int) -> np.ndarray:
    return divisors(n)  # prime-power expansion, lru-cached (factor.py)


def _objective(energy: np.ndarray, latency: np.ndarray, kind: str):
    if kind == "edp":
        return energy * latency
    if kind == "energy":
        return energy
    if kind == "latency":
        return latency
    raise ValueError(kind)


def _pareto_keep(C: np.ndarray) -> np.ndarray:
    """Non-dominated rows mask (minimize all columns).

    Exact for small groups; for large groups a sound O(n*K) filter first
    drops rows weakly dominated by per-criterion-minimum references (one
    representative per unique reference value is protected, so duplicates
    cannot eliminate each other), then finishes exactly if tractable."""
    n = C.shape[0]
    if n <= 1:
        return np.ones(n, dtype=bool)
    if n > PARETO_EXACT_N:
        refs_idx = sorted(set(np.argmin(C, axis=0).tolist())
                          | {int(np.argmin(C.sum(axis=1)))})
        # one representative per unique reference row
        uniq: dict = {}
        for ri in refs_idx:
            uniq.setdefault(C[ri].tobytes(), ri)
        dominated = np.zeros(n, dtype=bool)
        for ri in uniq.values():
            d = (C[ri][None, :] <= C).all(axis=1)
            d[ri] = False
            dominated |= d
        keep = ~dominated
        si = np.where(keep)[0]
        if len(si) <= PARETO_EXACT_N:
            sub = _pareto_keep_exact(C[si])
            keep[si[~sub]] = False
        return keep
    return _pareto_keep_exact(C)


def _pareto_keep_exact(C: np.ndarray, block: int = 128) -> np.ndarray:
    """Exact weak-dominance filter via ascending-sum chunked scan.

    A dominator has column-wise <= values hence <= sum, so rows in a chunk
    can only be dominated by kept rows from earlier chunks or by
    earlier/equal rows within the chunk (ties resolve to first occurrence).

    Within a chunk, row ``j`` is removed iff some row earlier in the
    (criteria-sum, original-position) order weakly dominates it — checking
    *any* earlier dominator (one vectorized triangular test) rather than
    only not-yet-removed ones is equivalent, because a removed dominator's
    own remover precedes and dominates ``j`` too (the (sum, position) order
    is total and weak dominance is transitive), so every removal chain ends
    at a kept row.  The removal set is therefore also independent of the
    chunking itself; ``block`` only balances the pairwise tensor size
    against how early the kept-set shrinks."""
    n = C.shape[0]
    if n <= 1:
        return np.ones(n, dtype=bool)
    order = np.argsort(C.sum(axis=1), kind="stable")
    S = C[order]
    kept = np.empty_like(C)
    k = 0
    keep_pos: List[int] = []
    for start in range(0, n, block):
        blk = S[start:start + block]
        b = blk.shape[0]
        if k:
            # (k, b): kept[i] dominates blk[j]
            dom = (kept[:k, None, :] <= blk[None, :, :]).all(-1).any(0)
        else:
            dom = np.zeros(b, dtype=bool)
        # within-chunk: j dominated by an earlier (position order == sorted
        # (sum, original-position) order, argsort being stable) row i
        m = (blk[:, None, :] <= blk[None, :, :]).all(-1)
        dom |= np.triu(m, 1).any(axis=0)
        surv = np.where(~dom)[0]
        take = blk[surv]
        kept[k:k + len(surv)] = take
        k += len(surv)
        keep_pos.extend((start + surv).tolist())
    mask = np.zeros(n, dtype=bool)
    mask[order[np.array(keep_pos, dtype=np.int64)]] = True
    return mask


GROUP_BATCH_MAX = 512  # largest group handled by the batched pairwise path
_PAIRWISE_BUDGET = 1 << 24  # bool elements per batched dominance tensor
_PHASE1_CRITERIA = 6  # criteria scanned with full s*s broadcasts before compacting
_SAMPLE_GROUPS = 64  # groups sampled to rank criteria by refutation power


def _pack_key_cols(keys: np.ndarray) -> tuple:
    """Mixed-radix fold of int64 key columns into as few columns as fit.

    The fold is injective (per-column offsets and radices taken from the
    data), so row equality — the only thing grouping needs — is preserved
    exactly while ``lexsort`` runs over one or two keys instead of a dozen.
    Returns a tuple of int64 arrays ordered for ``np.lexsort`` use.
    """
    n, ncols = keys.shape
    if ncols == 0:
        return (np.zeros(n, dtype=np.int64),)
    if ncols == 1:
        return (keys[:, 0],)
    lo = keys.min(axis=0)
    radix = keys.max(axis=0) - lo + 1
    limit = np.iinfo(np.int64).max
    packed = []
    acc = None
    cap = 1
    for c in range(ncols):
        v = keys[:, c] - lo[c]
        r = int(radix[c])
        if acc is None:
            acc, cap = v, r
        elif cap <= limit // r:
            acc = acc * r + v
            cap *= r
        else:
            packed.append(acc)
            acc, cap = v, r
    packed.append(acc)
    return tuple(packed)


def _grouped_pareto(C: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Per-group non-dominated mask; groups are rows of ``keys`` that compare
    equal (candidates with different remaining quotients / fanout capacity
    cannot dominate each other).

    Groups are found with one stable lexsort + boundary scan, then all groups
    of the same size are filtered through a single vectorized pairwise
    dominance pass (padding-free because sizes match), so the common case —
    thousands of small groups per step — costs a handful of numpy ops instead
    of a Python-level ``_pareto_keep`` call per group.  Oversized groups fall
    back to ``_pareto_keep``; results are bit-identical to the per-group
    loop: a row is removed iff a weak dominator precedes it in
    ``_pareto_keep_exact``'s (criteria-sum, original-position) order — the
    chain of removals always ends at a kept dominator, so checking *any*
    preceding dominator is equivalent to the reference scan's kept-only
    check, floating-point sum ties and all.
    """
    n = C.shape[0]
    keep = np.ones(n, dtype=bool)
    if n <= 1:
        return keep
    # Fold the reference scan's (criteria-sum, frontier-position) order into
    # the grouping sort itself: primary keys group, the per-row criteria sum
    # breaks ties within a group, and lexsort's stability resolves
    # floating-point sum ties to frontier order.  Within each batched group
    # the "earlier" relation is then exactly the triangular mask, so the
    # pairwise pass needs no per-pair sum comparisons.  The sums are the
    # same pairwise row reductions the reference computed (each row of C is
    # a contiguous K-vector either way).
    sums = C.sum(axis=1)
    packed = _pack_key_cols(keys)
    order = np.lexsort((sums,) + packed)
    sk = np.column_stack([p[order] for p in packed])
    starts = np.flatnonzero(
        np.concatenate([[True], (sk[1:] != sk[:-1]).any(axis=1)]))
    sizes = np.diff(np.append(starts, n))
    for s in np.unique(sizes):
        if s < 2:
            continue
        gs = starts[sizes == s]
        if s > GROUP_BATCH_MAX:
            for st0 in gs:
                # restore frontier order so _pareto_keep's tie handling
                # (argmin representatives, stable sum argsort) sees the
                # byte-identical input the per-group reference loop saw
                gi = np.sort(order[st0:st0 + s])
                keep[gi] = _pareto_keep(C[gi])
            continue
        idx = order[gs[:, None] + np.arange(s)[None, :]]  # (n_groups, s)
        if s == 2:
            # pair groups: one direct row-vs-row comparison, no 3-D tensor
            le = (C[idx[:, 0]] <= C[idx[:, 1]]).all(axis=1)
            keep[idx[le, 1]] = False
            continue
        tri = np.triu(np.ones((s, s), dtype=bool), 1)  # [i, j]: i < j
        K = C.shape[1]
        K1 = min(K, _PHASE1_CRITERIA)
        chunk = max(1, _PAIRWISE_BUDGET // int(s * s * K1))
        for c0 in range(0, idx.shape[0], chunk):
            ii = idx[c0:c0 + chunk]
            X = C[ii]  # (g, s, K) in (sum, frontier-position) order
            if K1 < K:
                # Pick the most refuting criteria (sampled on adjacent pairs
                # of a handful of groups): the AND over all criteria is
                # order-independent, so scanning discriminating columns first
                # is bit-identical but kills most pairs in phase 1.
                Xs = X[:_SAMPLE_GROUPS]
                surv = (Xs[:, :-1, :] <= Xs[:, 1:, :]).sum(axis=(0, 1))
                cols = np.argsort(surv, kind="stable")[:K1]
            else:
                cols = range(K)
            # Phase 1: pairwise <=-mask over the strongest few criteria with
            # full (g, s, s) broadcasts, seeded with the triangular mask so
            # only i<j pairs survive.
            le = np.repeat(tri[None], ii.shape[0], axis=0)
            for kk in cols:
                le &= X[:, :, None, kk] <= X[:, None, :, kk]
            if K1 < K:
                # Phase 2: compact to surviving (group, i, j) triples and
                # finish with one flat row-vs-row pass (contiguous row
                # gathers; re-checking the phase-1 columns is cheaper than
                # slicing them out).
                gi, pi, pj = np.nonzero(le)
                dominated = np.zeros((ii.shape[0], s), dtype=bool)
                if gi.size:
                    m = (X[gi, pi] <= X[gi, pj]).all(axis=1)
                    dominated[gi[m], pj[m]] = True
            else:
                dominated = le.any(axis=1)
            keep[ii] = ~dominated
    return keep


def _merged_usage_kernel(entries, index):
    """Compile all finite-capacity usage criteria into ONE kernel.

    ``entries`` yields ``(criteria_list, cap)`` pairs; the merged kernel
    evaluates every criterion in one packed pass and the returned caps
    vector lines up column-for-column, so the per-candidate validity mask is
    a single ``(U <= caps).all(axis=1)`` — boolean-identical to and-ing one
    ``kernel(lower)[:, 0] <= cap`` mask per usage poly (each criterion's
    value is computed by the same packed ops either way).
    Returns ``(kernel, caps)`` or ``(None, None)`` when nothing is gated.
    """
    crits: List = []
    caps: List[float] = []
    for crit_list, cap in entries:
        for crit in crit_list:
            crits.append(crit)
            caps.append(cap)
    if not crits:
        return None, None
    return CriteriaKernel(crits, index), np.array(caps)


def _expand_wave(k: int, divs: np.ndarray, chain_cols, fan_cols,
                 cols, rem, fan_rem):
    """Vectorized one-site frontier expansion shared by both steppers.

    Evaluates the whole ``(divisor, candidate)`` wave at once: a packed
    ``(n_divs, n_candidates)`` legality grid (every chain quotient of site
    ``k`` divisible by ``d``, every fanout-capacity column >= ``d``),
    flattened divisor-major so the emitted rows land in exactly the order
    the historical per-divisor Python loop concatenated them — candidates
    of the smallest divisor first, frontier order within each divisor.
    Returns ``(cols, rem, fan_rem)`` or None when no candidate survives.
    """
    R = rem[:, chain_cols]  # (n, n_chains_of_site)
    ok = (R[None, :, :] % divs[:, None, None] == 0).all(axis=2)
    if fan_cols:
        Fr = fan_rem[:, fan_cols]
        ok &= (Fr[None, :, :] >= divs[:, None, None]).all(axis=2)
    di, ci = np.nonzero(ok)  # C-order scan == divisor-major emission
    if di.size == 0:
        return None
    d = divs[di]
    c = cols[ci]
    c[:, k] = d
    r = rem[ci]
    r[:, chain_cols] //= d[:, None]
    f = fan_rem[ci]
    if fan_cols:
        f[:, fan_cols] //= d[:, None]
    return c, r, f


def _lb_terms(poly: Poly, known: frozenset,
              var_of_sym: Dict[str, str],
              unassigned_by_var: Dict[str, List[str]]) -> Criterion:
    """Lower-bound a poly over completions, per monomial.

    The unknown bounds of each rank var multiply exactly to the remaining
    quotient ``rem_v`` (a per-candidate value exposed as pseudo-symbol
    ``rem:v``).  For a positive-coefficient monomial, the constrained minimum
    of  prod s_i^{e_i}  s.t.  prod_{s_i in var v} s_i = rem_v, s_i >= 1  puts
    all mass on the smallest exponent: rem_v^{min_e} (absent unassigned syms
    count as exponent 0).  Negative coefficients use the max exponent.
    Returns criterion terms [(coeff, powers)] over columns extended with the
    rem pseudo-symbols."""
    terms = []
    for m in poly.monos:
        kp: List[Tuple[str, int]] = []
        unk_exp: Dict[str, Dict[str, int]] = {}
        for s, e in m.powers:
            if s in known:
                kp.append((s, e))
            else:
                v = var_of_sym[s]
                unk_exp.setdefault(v, {})[s] = e
        for v, exps in unk_exp.items():
            es = [exps.get(s, 0) for s in unassigned_by_var[v]]
            e_star = min(es) if m.coeff >= 0 else max(es)
            if e_star != 0:
                kp.append((f"rem:{v}", e_star))
        terms.append((m.coeff, tuple(sorted(kp))))
    return tuple(terms)


def stepper_for(cm: CurriedModel, objective: str) -> "_Stepper":
    """Memoized stepper for a (curried model, objective) pair.

    The cache dict lives on the model instance (``cm.stepper_cache``) and is
    keyed by objective only, so entries from different models can never
    collide through the keying — but a *shared* cache dict (two models handed
    the same dict, e.g. by aliasing bugs or deliberate reuse) would silently
    serve one model's compiled stepper for the other.  Guard against that
    here: a cached entry is only reused when it was built for this exact
    model instance, and the implementation class is re-dispatched from
    ``cm.is_fused`` on every build so a ``FusedCurriedModel`` can never
    receive a plain ``_Stepper`` (or vice versa) regardless of which
    ``.get`` alias the caller went through.
    """
    cache = cm.stepper_cache
    st = cache.get(objective)
    if st is None or st.cm is not cm:
        impl = _FusedStepper if getattr(cm, "is_fused", False) else _Stepper
        st = cache[objective] = impl(cm, objective)
    return st


class _Stepper:
    """Shared expansion machinery over the site exploration order.

    Criteria and lower-bound polynomials depend only on the set of already
    assigned symbols, and the exploration order is fixed — so there are
    exactly ``len(explore_order)`` distinct known-sets per curried model.
    All criteria are therefore lowered once per known-set into packed
    :class:`~repro.core.symbolic.CriteriaKernel` form and memoized
    (``_dom_kernels`` / ``_lb_kernels``), instead of being re-derived and
    interpreted through Python loops at every step of every explore call.
    Steppers themselves are memoized per (curried model, objective) via
    :func:`stepper_for`, so a beam dive and a full explore share one
    compiled set.
    """

    @classmethod
    def get(cls, cm: CurriedModel, objective: str) -> "_Stepper":
        return stepper_for(cm, objective)

    def __init__(self, cm: CurriedModel, objective: str):
        self.cm = cm
        self.objective = objective
        einsum, arch = cm.einsum, cm.arch
        self.sites = cm.sites
        n_sites = len(self.sites)

        by_var: Dict[str, List[int]] = {}
        for k, s in enumerate(self.sites):
            by_var.setdefault(s.var, []).append(k)
        var_order = sorted(
            by_var, key=lambda v: -max(self.sites[k].index for k in by_var[v]))
        self.explore_order: List[int] = []
        self.absorber: Dict[int, bool] = {}
        for v in var_order:
            ks = sorted(by_var[v], key=lambda k: -self.sites[k].index)
            temporal = [k for k in ks if not self.sites[k].spatial]
            if temporal:
                ab = temporal[-1]
                ks = [k for k in ks if k != ab] + [ab]
                self.absorber[ab] = True
            self.explore_order.extend(ks)

        self.sym_index = {s.sym: i for i, s in enumerate(self.sites)}
        self.shapes = dict(einsum.rank_shapes)
        self.vars_list = sorted(self.shapes)
        self.var_idx = {v: i for i, v in enumerate(self.vars_list)}
        self.fan_dims: List[Tuple[int, int, int]] = []
        for fi, fan in enumerate(arch.fanouts):
            for d, cap in enumerate(fan.dims):
                self.fan_dims.append((fi, d, cap))
        self.fd_idx = {(fi, d): i for i, (fi, d, _) in enumerate(self.fan_dims)}
        self.divisor_cache: Dict[int, np.ndarray] = {}

        # lower-bound machinery: rem pseudo-symbols indexed after the sites
        self.var_of_sym = {s.sym: s.var for s in self.sites}
        self.ext_index = dict(self.sym_index)
        for vi, v in enumerate(self.vars_list):
            self.ext_index[f"rem:{v}"] = n_sites + vi

        self.usage_polys = list(cm.usage.values())
        self.usage_caps = [arch.levels[m].capacity for m in cm.usage]
        self.objective_polys = list(expr_polys(cm.latency)) + [cm.energy]
        self.latency_arms = list(expr_polys(cm.latency))
        all_known = frozenset(self.sym_index)
        self.usage_crits = [
            (grouped_criteria([p], all_known), cap)
            for p, cap in zip(self.usage_polys, self.usage_caps)
            if cap != float("inf")
        ]
        # compile-once layer: usage criteria are known-set independent, and
        # all capacity checks merge into one packed kernel + caps vector
        self.usage_kernel, self.usage_caps_vec = _merged_usage_kernel(
            self.usage_crits, self.sym_index)
        # per-known-set compiled kernels, filled lazily along explore_order
        self._dom_kernels: Dict[frozenset, Optional[CriteriaKernel]] = {}
        self._lb_kernels: Dict[
            frozenset, Tuple[CriteriaKernel, Tuple[Tuple[int, int], ...]]] = {}
        # memoized beam-dive result (deterministic).  The two-phase engines
        # dive every unit in phase 1 before exploring it in phase 2; this
        # memo dedupes the two dives whenever both run in one process (the
        # serial engine always; pool workers only when scheduling lands a
        # unit's phases on the same worker, since memos are per-process).
        self._beam: object = _UNSET

    def beam_incumbent(self):
        if self._beam is _UNSET:
            self._beam = _beam_incumbent(self)
        return self._beam

    def dominance_criteria(self, known: frozenset) -> list:
        """Uncompiled dominance criteria for one known-set — the per-node
        reference that :meth:`dominance_kernel` lowers (parity-tested)."""
        return grouped_criteria(
            self.objective_polys + self.usage_polys, known)

    def dominance_kernel(self, known: frozenset) -> Optional[CriteriaKernel]:
        """Compiled dominance criteria for one known-set (None if empty)."""
        if known not in self._dom_kernels:
            crits = self.dominance_criteria(known)
            self._dom_kernels[known] = (
                CriteriaKernel(crits, self.sym_index) if crits else None)
        return self._dom_kernels[known]

    def lb_criteria(self, known: frozenset):
        """Uncompiled lower-bound criteria + latency-arm-group slices — the
        per-node reference that :meth:`lb_kernels` lowers (parity-tested)."""
        unassigned_by_var: Dict[str, List[str]] = {
            v: [] for v in self.vars_list}
        for s in self.sites:
            if s.sym not in known:
                unassigned_by_var[s.var].append(s.sym)
        e_crit = _lb_terms(self.cm.energy, known, self.var_of_sym,
                           unassigned_by_var)
        arm_crits = [
            _lb_terms(a, known, self.var_of_sym, unassigned_by_var)
            for a in self.latency_arms]
        return [e_crit] + arm_crits, ((1, 1 + len(arm_crits)),)

    def lb_kernels(self, known: frozenset
                   ) -> Tuple[CriteriaKernel, Tuple[Tuple[int, int], ...]]:
        """One compiled lower-bound kernel per known-set, over columns
        extended with the ``rem:`` pseudo-symbols.  Column 0 is the energy
        bound; the returned slices delimit each latency arm *group* (one
        group here, one per member for the fused stepper), whose per-row
        max contributes a latency term."""
        if known not in self._lb_kernels:
            crits, slices = self.lb_criteria(known)
            self._lb_kernels[known] = (
                CriteriaKernel(crits, self.ext_index), slices)
        return self._lb_kernels[known]

    def init_state(self):
        n_sites = len(self.sites)
        cols = np.ones((1, n_sites), dtype=np.int64)
        rem = np.array([[self.shapes[v] for v in self.vars_list]],
                       dtype=np.int64)
        fan_rem = (np.array([[c for (_, _, c) in self.fan_dims]],
                            dtype=np.int64)
                   if self.fan_dims else np.zeros((1, 0), dtype=np.int64))
        return cols, rem, fan_rem

    def expand(self, k: int, cols, rem, fan_rem):
        """Expand one site; returns new (cols, rem, fan_rem) or None."""
        site = self.sites[k]
        vi = self.var_idx[site.var]
        if self.absorber.get(k):
            cols = cols.copy()
            cols[:, k] = rem[:, vi]
            rem = rem.copy()
            rem[:, vi] = 1
            return cols, rem, fan_rem
        shape_v = self.shapes[site.var]
        if shape_v not in self.divisor_cache:
            self.divisor_cache[shape_v] = _divisors(shape_v)
        divs = self.divisor_cache[shape_v]
        fan_cols = ([self.fd_idx[(site.fanout, site.dim)]]
                    if site.spatial else [])
        return _expand_wave(k, divs, [vi], fan_cols, cols, rem, fan_rem)

    def usage_lower_ok(self, cols, assigned_set) -> np.ndarray:
        """Monotone lower-bound validity mask.

        ``cols`` already *is* the usage lower bound: unassigned site columns
        stay at their ``init_state`` value 1 (``expand`` only ever writes the
        site being assigned), which is each bound's minimum.
        """
        if self.usage_kernel is None:
            return np.ones(cols.shape[0], dtype=bool)
        U = self.usage_kernel(cols.astype(np.float64))
        return (U <= self.usage_caps_vec).all(axis=1)

    def objective_lower_bound(self, cols, rem, known: frozenset) -> np.ndarray:
        """Sound lower bound of the objective for each partial candidate."""
        ext = np.concatenate(
            [cols.astype(np.float64), rem.astype(np.float64)], axis=1)
        kernel, arm_slices = self.lb_kernels(known)
        out = kernel(ext)
        e_lb = out[:, 0]
        l_lb = None
        for a, b in arm_slices:
            part = out[:, a:b].max(axis=1)
            l_lb = part if l_lb is None else l_lb + part
        if self.objective == "edp":
            return e_lb * l_lb
        if self.objective == "energy":
            return e_lb
        return l_lb

    def dominance_keys(self, rem, fan_rem, step: int) -> np.ndarray:
        """Cannot-compare group keys for the dominance prune at ``step``."""
        return np.concatenate([rem, fan_rem], axis=1)


class _FusedStepper:
    """Expansion machinery for fused-group joint exploration.

    Same public surface as :class:`_Stepper`, generalized from per-rank-var
    quotients to per-(member, var) *chains*: a shared-prefix site divides
    every chain of its class in lockstep (the co-tiling), member sites
    divide their own chain, and sites shared by structurally tied members
    divide all their twins' chains at once.  Prefix sites are explored
    *first*, so from step ``n_classes`` on every chain's remaining quotient
    is exact and the per-chain lower-bound rule of ``_lb_terms`` applies
    unchanged; during the first steps, chains whose prefix bound is still
    free fall back to a relaxed (weaker but sound) per-symbol bound: every
    unknown bound of chain ``c`` divides ``rem_c``, so it lies in
    ``[1, rem_c]``.

    Dominance criteria are arm-wise over all members' latency arms plus the
    summed energy — arm-wise <= implies each member's max <=, hence the
    fused (sum-of-maxes) latency <= — so pruning decisions remain sound for
    the joint objective.
    """

    @classmethod
    def get(cls, cm, objective: str) -> "_FusedStepper":
        return stepper_for(cm, objective)

    def __init__(self, cm, objective: str):
        self.cm = cm
        self.objective = objective
        self.sites = cm.sites
        self.site_chains = cm.site_chains
        self.site_fans = cm.site_fans
        self.site_member = cm.site_member
        self.chain_shapes = list(cm.chain_shapes)
        n_sites = len(self.sites)
        n_chains = len(self.chain_shapes)
        n_members = len(cm.workload.members)

        # fanout capacity is per member phase: each member drives the array
        # on its own, so capacity columns are (member, fanout, dim)
        self.fan_dims: List[Tuple[int, int, int, int]] = []
        for mi in range(n_members):
            for fi, fan in enumerate(cm.arch.fanouts):
                for d, cap in enumerate(fan.dims):
                    self.fan_dims.append((mi, fi, d, cap))
        self.fd_idx = {(mi, fi, d): i
                       for i, (mi, fi, d, _) in enumerate(self.fan_dims)}
        self.divisor_cache: Dict[int, np.ndarray] = {}
        self.sym_index = {s.sym: i for i, s in enumerate(self.sites)}
        self.sym_chains = {s.sym: self.site_chains[k]
                           for k, s in enumerate(self.sites)}
        self.prefix_sym_of_chain = list(cm.chain_prefix_sym)

        # explore order: prefix sites first (class order), then per member
        # the historical heuristic — chains by deepest site, innermost
        # first, temporal absorber last
        self.explore_order: List[int] = [
            k for k in range(n_sites) if self.site_member[k] is None]
        self.absorber: Dict[int, Tuple[int, ...]] = {}
        chain_sites: Dict[int, List[int]] = {ci: [] for ci in range(n_chains)}
        for k in range(n_sites):
            if self.site_member[k] is None:
                continue
            for ci in self.site_chains[k]:
                chain_sites[ci].append(k)
        seen = set(self.explore_order)
        for mi in range(n_members):
            member_chains = [
                ci for (m, v), ci in sorted(cm.chain_ids.items(),
                                            key=lambda kv: kv[1])
                if m == mi and chain_sites[ci]]
            member_chains.sort(
                key=lambda ci: -max(self.sites[k].index
                                    for k in chain_sites[ci]))
            for ci in member_chains:
                ks = sorted(chain_sites[ci],
                            key=lambda k: -self.sites[k].index)
                temporal = [k for k in ks if not self.sites[k].spatial]
                if temporal:
                    ab = temporal[-1]
                    ks = [k for k in ks if k != ab] + [ab]
                    self.absorber[ab] = self.absorber.get(ab, ()) + (ci,)
                for k in ks:
                    if k not in seen:
                        seen.add(k)
                        self.explore_order.append(k)
        assert len(self.explore_order) == n_sites

        # lower-bound machinery: one rem pseudo-symbol per chain
        self.ext_index = dict(self.sym_index)
        for ci in range(n_chains):
            self.ext_index[f"rem:{ci}"] = n_sites + ci

        self.usage_polys = [p for _, p in cm.usage_entries]
        self.latency_arm_groups = [list(part.arms)
                                   for part in cm.latency_parts]
        self.objective_polys = (
            [a for arms in self.latency_arm_groups for a in arms]
            + [cm.energy])
        all_known = frozenset(self.sym_index)
        self.usage_kernel, self.usage_caps_vec = _merged_usage_kernel(
            ((grouped_criteria([p], all_known), cap)
             for cap, p in cm.usage_entries if cap != float("inf")),
            self.sym_index)
        self._dom_kernels: Dict[frozenset, Optional[CriteriaKernel]] = {}
        self._lb_kernels: Dict[frozenset, tuple] = {}
        self._beam: object = _UNSET
        # per-site packed expansion inputs (chain quotient columns and
        # fanout-capacity columns consumed by each site)
        self._site_fan_cols = [
            [self.fd_idx[fd] for fd in self.site_fans[k]]
            for k in range(n_sites)]
        self._rem_sym = [f"rem:{ci}" for ci in range(n_chains)]
        # per-poly lowering plans for _lb_terms_fused: symbol->chain routing
        # is known-set independent, so resolve it once per poly (keyed by
        # object identity; the polys are owned by ``cm`` for our lifetime)
        self._lb_plans: Dict[int, tuple] = {}

        # live-column masks per step: a chain / fanout column whose sites are
        # all expanded can never change again, so keeping it in the
        # cannot-compare keys would only fragment dominance groups (finished
        # members would never prune).  Masks depend only on the fixed
        # explore order, so they are precomputed.
        n_steps = len(self.explore_order)
        self._live_chains = []
        self._live_fans = []
        for step in range(n_steps):
            future = self.explore_order[step + 1:]
            live_c = np.zeros(n_chains, dtype=bool)
            live_f = np.zeros(len(self.fan_dims), dtype=bool)
            for k in future:
                for ci in self.site_chains[k]:
                    live_c[ci] = True
                for fd in self.site_fans[k]:
                    live_f[self.fd_idx[fd]] = True
            self._live_chains.append(live_c)
            self._live_fans.append(live_f)

    def beam_incumbent(self):
        if self._beam is _UNSET:
            self._beam = _beam_incumbent(self)
        return self._beam

    def dominance_criteria(self, known: frozenset) -> list:
        # usage polys whose symbols are all known are fixed: both compared
        # candidates already passed the exact capacity check, so the
        # constraint cannot discriminate futures — drop it from the criteria
        # (objective polys always stay: their known parts feed the objective)
        live_usage = [p for p in self.usage_polys
                      if not p.symbols() <= known]
        return grouped_criteria(self.objective_polys + live_usage, known)

    def dominance_kernel(self, known: frozenset) -> Optional[CriteriaKernel]:
        if known not in self._dom_kernels:
            crits = self.dominance_criteria(known)
            self._dom_kernels[known] = (
                CriteriaKernel(crits, self.sym_index) if crits else None)
        return self._dom_kernels[known]

    def dominance_keys(self, rem, fan_rem, step: int) -> np.ndarray:
        # dead chains normally end absorbed at rem == 1; a spatial-only
        # chain can die unfinished, and such doomed candidates must not be
        # allowed to dominate viable ones — key them apart by a doomed
        # marker instead of the full (group-fragmenting) dead quotients
        dead = ~self._live_chains[step]
        doomed = (rem[:, dead] != 1).astype(np.int64)
        return np.concatenate([rem[:, self._live_chains[step]], doomed,
                               fan_rem[:, self._live_fans[step]]], axis=1)

    def _lb_terms_fused(self, poly: Poly, known: frozenset,
                        unassigned_by_chain: Dict[int, List[str]],
                        relaxed: frozenset) -> Criterion:
        """Per-monomial lower bound over completions, chain-aware.

        Exact chains (prefix bound already assigned): the unknown bounds
        primarily assigned to chain ``c`` multiply to exactly ``rem_c`` —
        the per-var rule of :func:`_lb_terms` applies.  Relaxed chains
        (prefix still free) and free prefix symbols themselves only satisfy
        ``bound in [1, rem_c]`` per symbol, giving the weaker per-symbol
        bound: ``rem_c^e`` for the exponents that hurt (negative under a
        positive coefficient, positive under a negative one).
        """
        plan = self._lb_plans.get(id(poly))
        if plan is None:
            sym_chains = self.sym_chains
            sym_index = self.sym_index
            n_prefix = len(self.cm.classes)
            plan = tuple(
                (m.coeff,
                 tuple((s, e, sym_chains[s][0], sym_index[s] < n_prefix)
                       for s, e in m.powers))
                for m in poly.monos)
            self._lb_plans[id(poly)] = plan
        terms = []
        rem_sym = self._rem_sym
        for coeff, entries in plan:
            kp: Dict[str, int] = {}
            chain_exps: Dict[int, Dict[str, int]] = {}
            pos = coeff >= 0
            for s, e, ci0, is_prefix in entries:
                if s in known:
                    # mono powers carry each symbol once, and site symbols
                    # never collide with the "rem:<chain>" bound keys
                    kp[s] = e
                elif is_prefix:
                    # free prefix symbol: per-symbol relaxed bound against
                    # its first chain's quotient
                    if (e < 0) if pos else (e > 0):
                        key = rem_sym[ci0]
                        kp[key] = kp.get(key, 0) + e
                else:
                    ce = chain_exps.get(ci0)
                    if ce is None:
                        ce = chain_exps[ci0] = {}
                    ce[s] = e
            for ci, exps in chain_exps.items():
                if ci in relaxed:
                    if pos:
                        e_star = sum(e for e in exps.values() if e < 0)
                    else:
                        e_star = sum(e for e in exps.values() if e > 0)
                else:
                    # min/max over *all* unassigned symbols of the chain:
                    # symbols absent from the mono contribute exponent 0
                    vals = exps.values()
                    if pos:
                        e_star = min(vals)
                        if e_star > 0 and len(exps) < len(
                                unassigned_by_chain[ci]):
                            e_star = 0
                    else:
                        e_star = max(vals)
                        if e_star < 0 and len(exps) < len(
                                unassigned_by_chain[ci]):
                            e_star = 0
                if e_star != 0:
                    key = rem_sym[ci]
                    kp[key] = kp.get(key, 0) + e_star
            terms.append((coeff, tuple(sorted(kp.items()))))
        return tuple(terms)

    def lb_criteria(self, known: frozenset):
        """Uncompiled chain-aware LB criteria + member arm-group slices —
        the per-node reference that :meth:`lb_kernels` lowers
        (parity-tested)."""
        unassigned_by_chain: Dict[int, List[str]] = {
            ci: [] for ci in range(len(self.chain_shapes))}
        relaxed = set()
        for k, s in enumerate(self.sites):
            if s.sym in known:
                continue
            if self.site_member[k] is None:
                relaxed.update(self.site_chains[k])
            else:
                unassigned_by_chain[self.site_chains[k][0]].append(s.sym)
        relaxed = frozenset(relaxed)
        crits = [self._lb_terms_fused(self.cm.energy, known,
                                      unassigned_by_chain, relaxed)]
        slices = []
        for arms in self.latency_arm_groups:
            start = len(crits)
            crits.extend(
                self._lb_terms_fused(a, known, unassigned_by_chain,
                                     relaxed) for a in arms)
            slices.append((start, len(crits)))
        return crits, tuple(slices)

    def lb_kernels(self, known: frozenset):
        """One compiled LB kernel per known-set: column 0 is the energy
        bound, followed by every member's latency arms; the returned slices
        delimit each member's arm group (their per-row maxima sum into the
        joint latency bound)."""
        if known not in self._lb_kernels:
            crits, slices = self.lb_criteria(known)
            self._lb_kernels[known] = (
                CriteriaKernel(crits, self.ext_index), slices)
        return self._lb_kernels[known]

    def init_state(self):
        n_sites = len(self.sites)
        cols = np.ones((1, n_sites), dtype=np.int64)
        rem = np.array([list(self.chain_shapes)], dtype=np.int64)
        fan_rem = (np.array([[c for (_, _, _, c) in self.fan_dims]],
                            dtype=np.int64)
                   if self.fan_dims else np.zeros((1, 0), dtype=np.int64))
        return cols, rem, fan_rem

    def expand(self, k: int, cols, rem, fan_rem):
        """Expand one site; returns new (cols, rem, fan_rem) or None."""
        ab = self.absorber.get(k)
        if ab:
            # tied chains track identical quotients; absorb them all
            cols = cols.copy()
            cols[:, k] = rem[:, ab[0]]
            rem = rem.copy()
            for ci in ab:
                rem[:, ci] = 1
            return cols, rem, fan_rem
        chains = self.site_chains[k]
        shape = self.chain_shapes[chains[0]]
        if shape not in self.divisor_cache:
            self.divisor_cache[shape] = _divisors(shape)
        divs = self.divisor_cache[shape]
        return _expand_wave(k, divs, list(chains), self._site_fan_cols[k],
                            cols, rem, fan_rem)

    def usage_lower_ok(self, cols, assigned_set) -> np.ndarray:
        """Monotone lower-bound validity mask (phase-local capacities).

        As in :meth:`_Stepper.usage_lower_ok`, unassigned site columns are
        already 1 — ``cols`` is the usage lower bound as-is.
        """
        if self.usage_kernel is None:
            return np.ones(cols.shape[0], dtype=bool)
        U = self.usage_kernel(cols.astype(np.float64))
        return (U <= self.usage_caps_vec).all(axis=1)

    def objective_lower_bound(self, cols, rem, known: frozenset) -> np.ndarray:
        """Sound joint lower bound: energy LB times the *sum* of per-member
        latency-arm maxima (members run sequentially)."""
        ext = np.concatenate(
            [cols.astype(np.float64), rem.astype(np.float64)], axis=1)
        kernel, arm_slices = self.lb_kernels(known)
        out = kernel(ext)
        e_lb = out[:, 0]
        l_lb = None
        for a, b in arm_slices:
            part = out[:, a:b].max(axis=1)
            l_lb = part if l_lb is None else l_lb + part
        if self.objective == "edp":
            return e_lb * l_lb
        if self.objective == "energy":
            return e_lb
        return l_lb


def beam_objective(cm: CurriedModel, objective: str = "edp") -> float:
    """Objective of the cheap beam-dive mapping (``inf`` when the dive finds
    none).  This is the phase-1 primitive of the two-phase search: every work
    unit is dived first, and the best dive seeds the global incumbent that
    phase-2 full explorations prune against.  Sound as an upper bound — the
    dive only returns objectives of complete, validity-checked mappings."""
    if not cm.sites:
        return float("inf")
    res = _Stepper.get(cm, objective).beam_incumbent()
    return float("inf") if res is None else res[3]


def _beam_incumbent(st: _Stepper, width: int = 64):
    """Cheap beam dive for an initial incumbent (heuristic, sound to use as
    an upper bound).  Returns (bounds, energy, latency, objective) or None."""
    cols, rem, fan_rem = st.init_state()
    assigned: set = set()
    for k in st.explore_order:
        out = st.expand(k, cols, rem, fan_rem)
        if out is None:
            return None
        cols, rem, fan_rem = out
        assigned.add(k)
        ok = st.usage_lower_ok(cols, assigned)
        if ok.any():
            cols, rem, fan_rem = cols[ok], rem[ok], fan_rem[ok]
        if cols.shape[0] > width:
            known = frozenset(st.sites[i].sym for i in assigned)
            lb = st.objective_lower_bound(cols, rem, known)
            top = np.argpartition(lb, width)[:width]
            cols, rem, fan_rem = cols[top], rem[top], fan_rem[top]
    done = (rem == 1).all(axis=1)
    cols = cols[done]
    if cols.shape[0] == 0:
        return None
    energy, latency, valid = st.cm.tile_shape_model(cols)
    if not valid.any():
        return None
    obj = np.where(valid, _objective(energy, latency, st.objective), np.inf)
    b = int(np.argmin(obj))
    return cols[b], float(energy[b]), float(latency[b]), float(obj[b])


def explore(cm: CurriedModel, objective: str = "edp",
            prune_partial: bool = True,
            debug: bool = False,
            inc_obj: float = float("inf"),
            inc_reader: Optional[Callable[[], float]] = None,
            tracer=None,
            budget=None,
            ) -> Optional[ExploreResult]:
    """Full exploration of one curried model's tile shapes.

    ``inc_obj`` is an *external* upper bound on the objective (the best
    complete mapping already known elsewhere — e.g. another work unit's
    optimum); ``inc_reader``, when given, is re-read once per branch-and-bound
    step so an improving global bound published by concurrent workers
    tightens in-flight searches.  Both are sound: candidates are discarded
    only when their objective lower bound already meets or exceeds the value
    of a real, complete mapping, so the *returned optimum's value* is
    unchanged — a unit whose entire subtree is cut returns its local beam
    incumbent (or None), and the caller's merge keeps the external bound's
    unit as the winner.

    ``tracer`` (an *enabled* :class:`repro.obs.Tracer`, or None) samples the
    expansion at step granularity: one ``expand`` counter event per explored
    site with the frontier size and the per-criterion prune attribution
    (dominance vs bound vs invalid) of that step.  Events are observational
    only — tracing never changes which candidates survive, so results are
    bit-identical with tracing on or off; with ``tracer=None`` (the default)
    the only cost is one identity check per emission site.

    ``budget`` (a live meter from ``repro.core.budget``, or None) makes the
    search *anytime*: expansions are charged to the meter and expiry is
    checked once per branch-and-bound step; an expired search stops where
    it is and returns a truncated result — the beam-dive incumbent as the
    best-so-far mapping plus a sound ``lower_bound`` on every valid
    completion of this unit (see :func:`_truncate`).  ``budget=None`` (the
    default) executes the historical instruction stream.
    """
    stats = ExploreStats()
    if not cm.sites:
        return None
    st = _Stepper.get(cm, objective)

    incumbent = st.beam_incumbent() if prune_partial else None
    local_obj = incumbent[3] if incumbent is not None else np.inf
    bound = min(local_obj, inc_obj) if prune_partial else np.inf

    cols, rem, fan_rem = st.init_state()
    assigned: List[int] = []

    def _trace_step(step: int, k: int, expanded: int, frontier: int,
                    p0) -> None:
        # one sampled event per explored site: this step's expansion count,
        # surviving frontier, and per-criterion prune attribution (the
        # deltas sum exactly to the unit's n_pruned_* stats — tested)
        tracer.counter(
            "expand", cat="step", step=step, site=st.sites[k].var,
            spatial=bool(st.sites[k].spatial), expanded=expanded,
            frontier=frontier,
            pruned_invalid=stats.n_pruned_invalid - p0[0],
            pruned_bound=stats.n_pruned_bound - p0[1],
            pruned_dominated=stats.n_pruned_dominated - p0[2])

    for step, k in enumerate(st.explore_order):
        if budget is not None and budget.expired():
            return _truncate(st, cols, rem, assigned, incumbent, bound,
                             stats)
        p0 = (stats.n_pruned_invalid, stats.n_pruned_bound,
              stats.n_pruned_dominated)
        out = st.expand(k, cols, rem, fan_rem)
        if out is None:
            if tracer is not None:
                _trace_step(step, k, 0, 0, p0)
            return _finish(None, incumbent, stats)
        cols, rem, fan_rem = out
        assigned.append(k)
        expanded_here = cols.shape[0]
        stats.n_expanded += expanded_here
        if budget is not None:
            budget.charge(expanded_here)
        last_step = step == len(st.explore_order) - 1
        assigned_set = set(assigned)
        known = frozenset(st.sites[i].sym for i in assigned)

        # ---- validity lower-bound prune ----------------------------------
        if not last_step:
            ok = st.usage_lower_ok(cols, assigned_set)
            stats.n_pruned_invalid += int((~ok).sum())
            if not ok.any():
                if tracer is not None:
                    _trace_step(step, k, expanded_here, 0, p0)
                return _finish(None, incumbent, stats)
            cols, rem, fan_rem = cols[ok], rem[ok], fan_rem[ok]

        # ---- branch-and-bound prune vs incumbent --------------------------
        if prune_partial and inc_reader is not None:
            bound = min(bound, inc_reader())
        if prune_partial and not last_step and np.isfinite(bound):
            lb = st.objective_lower_bound(cols, rem, known)
            ok = lb < bound
            stats.n_pruned_bound += int((~ok).sum())
            if not ok.any():
                if tracer is not None:
                    _trace_step(step, k, expanded_here, 0, p0)
                return _finish(None, incumbent, stats)
            cols, rem, fan_rem = cols[ok], rem[ok], fan_rem[ok]

        # ---- dominance prune over criteria --------------------------------
        if prune_partial and not last_step and cols.shape[0] > 1:
            kernel = st.dominance_kernel(known)
            if kernel is not None:
                C = kernel(cols.astype(np.float64))
                keys = st.dominance_keys(rem, fan_rem, step)
                keep = _grouped_pareto(C, keys)
                stats.n_pruned_dominated += int((~keep).sum())
                cols, rem, fan_rem = cols[keep], rem[keep], fan_rem[keep]
        stats.max_frontier = max(stats.max_frontier, cols.shape[0])
        if tracer is not None:
            _trace_step(step, k, expanded_here, int(cols.shape[0]), p0)
        if debug:
            import time as _t
            print(f"step {step}: site={st.sites[k].var}"
                  f"{'(sp)' if st.sites[k].spatial else ''}"
                  f" frontier={cols.shape[0]} t={_t.perf_counter():.1f}",
                  flush=True)

    done = (rem == 1).all(axis=1)
    cols = cols[done]
    if cols.shape[0] == 0:
        return _finish(None, incumbent, stats)

    energy, latency, valid = cm.tile_shape_model(cols)
    stats.n_final = cols.shape[0]
    if not valid.any():
        return _finish(None, incumbent, stats)
    obj = np.where(valid, _objective(energy, latency, objective), np.inf)
    best = int(np.argmin(obj))
    if incumbent is not None and incumbent[3] < obj[best]:
        return _finish(None, incumbent, stats)
    return ExploreResult(
        bounds=cols[best],
        energy=float(energy[best]),
        latency=float(latency[best]),
        edp=float(energy[best] * latency[best]),
        stats=stats,
    )


def _finish(none, incumbent, stats) -> Optional[ExploreResult]:
    if incumbent is None:
        return None
    bounds, energy, latency, _ = incumbent
    return ExploreResult(bounds=bounds, energy=energy, latency=latency,
                         edp=energy * latency, stats=stats)


def _truncate(st, cols, rem, assigned, incumbent, bound,
              stats) -> ExploreResult:
    """Budget-expired exit: best-so-far result plus a sound lower bound.

    Soundness of ``lower_bound = min(frontier relaxed LB, bound)`` over
    every valid completion of this unit:

      * Surviving frontier rows complete to at least their relaxed-term
        objective lower bound (``objective_lower_bound``, the same bound
        branch-and-bound pruning trusts).
      * Bound-pruned rows completed to at least the bound *at prune time*;
        the running ``bound`` only ever tightens (min of beam incumbent,
        external ``inc_obj`` and ``inc_reader`` re-reads), so they are also
        >= the final ``bound``.
      * Dominance-prune chains terminate at a surviving or bound-pruned
        row whose completions are no worse; invalid-pruned rows admit no
        valid completion at all.

    The returned mapping (the unit's beam-dive incumbent, when one exists)
    is a real, validity-checked mapping, so its objective is itself >= the
    reported lower bound — the certified gap is always >= 1.
    """
    stats.truncated = True
    lb = float(bound) if np.isfinite(bound) else float("inf")
    if cols.shape[0]:
        known = frozenset(st.sites[i].sym for i in assigned)
        frontier_lb = st.objective_lower_bound(cols, rem, known)
        lb = min(lb, float(frontier_lb.min()))
    res = _finish(None, incumbent, stats)
    if res is None:
        res = ExploreResult(bounds=None, energy=float("inf"),
                            latency=float("inf"), edp=float("inf"),
                            stats=stats)
    res.truncated = True
    res.lower_bound = lb
    return res
