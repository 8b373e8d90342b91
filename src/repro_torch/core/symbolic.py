"""Symbolic sum-of-product / max expression IR for the curried TCM model.

The paper's tile-shape-only model (Eq. 4-6) is built from products of loop
bounds, sums of those products, and max/min over them.  We represent:

  * ``Mono``  — coeff * prod(sym_i ** exp_i), integer exponents (may be
    negative: ``Computes / UtilizedUnits`` divides by spatial bounds).
  * ``Poly``  — a sum of monomials, canonicalized by exponent-key.
  * ``MaxExpr`` — max over polynomials (used for latency).

All expressions support:
  * ``subs(env)``     — partial evaluation (the paper's *currying*): known
    symbols fold into coefficients, returning a smaller expression.
  * ``evaluate(env)`` — full numeric evaluation; ``env`` values may be
    numpy arrays, giving vectorized evaluation over candidate tile shapes
    (our 1000x-fast tile-shape-only model).
  * ``partition(known)`` — the paper's criteria rewrite rules: split sums
    and maxes into per-term criteria, factor each monomial into its known
    part (kept, as a minimize-criterion) and unknown part (dropped).
"""
from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Sequence, Tuple, Union

import numpy as np

Env = Mapping[str, Union[int, float, np.ndarray]]


def _canon_powers(powers: Mapping[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted((s, e) for s, e in powers.items() if e != 0))


@dataclass(frozen=True)
class Mono:
    """coeff * prod(sym**exp)."""

    coeff: float
    powers: Tuple[Tuple[str, int], ...]  # sorted, nonzero exponents

    @staticmethod
    def make(coeff: float, powers: Mapping[str, int] | None = None) -> "Mono":
        return Mono(float(coeff), _canon_powers(powers or {}))

    @staticmethod
    def sym(name: str, exp: int = 1) -> "Mono":
        return Mono(1.0, ((name, exp),) if exp else ())

    @property
    def is_const(self) -> bool:
        return not self.powers

    def symbols(self) -> frozenset:
        return frozenset(s for s, _ in self.powers)

    def __mul__(self, other: "Mono | float | int") -> "Mono":
        if isinstance(other, (int, float)):
            return Mono(self.coeff * other, self.powers)
        pw = dict(self.powers)
        for s, e in other.powers:
            pw[s] = pw.get(s, 0) + e
        return Mono(self.coeff * other.coeff, _canon_powers(pw))

    def __truediv__(self, other: "Mono | float | int") -> "Mono":
        if isinstance(other, (int, float)):
            return Mono(self.coeff / other, self.powers)
        pw = dict(self.powers)
        for s, e in other.powers:
            pw[s] = pw.get(s, 0) - e
        return Mono(self.coeff / other.coeff, _canon_powers(pw))

    def subs(self, env: Env) -> "Mono":
        coeff = self.coeff
        rest: Dict[str, int] = {}
        for s, e in self.powers:
            if s in env:
                coeff *= float(env[s]) ** e
            else:
                rest[s] = e
        return Mono(coeff, _canon_powers(rest))

    def evaluate(self, env: Env):
        out = self.coeff
        for s, e in self.powers:
            v = env[s]
            out = out * (v ** e if e != 1 else v)
        return out

    def split(self, known: frozenset) -> Tuple["Mono", "Mono"]:
        """Factor into (known_part_with_coeff, unknown_part)."""
        kp: Dict[str, int] = {}
        up: Dict[str, int] = {}
        for s, e in self.powers:
            (kp if s in known else up)[s] = e
        return Mono(self.coeff, _canon_powers(kp)), Mono(1.0, _canon_powers(up))

    def __repr__(self) -> str:
        parts = [] if self.coeff == 1.0 and self.powers else [f"{self.coeff:g}"]
        for s, e in self.powers:
            parts.append(s if e == 1 else f"{s}^{e}")
        return "*".join(parts) or "1"


class Poly:
    """Sum of monomials, canonicalized by power-key."""

    __slots__ = ("monos",)

    def __init__(self, monos: Iterable[Mono] = ()):  # canonicalizes
        acc: Dict[Tuple[Tuple[str, int], ...], float] = {}
        for m in monos:
            acc[m.powers] = acc.get(m.powers, 0.0) + m.coeff
        self.monos: Tuple[Mono, ...] = tuple(
            Mono(c, p) for p, c in sorted(acc.items()) if c != 0.0
        )

    # -- constructors -------------------------------------------------
    @staticmethod
    def const(c: float) -> "Poly":
        return Poly([Mono.make(c)])

    @staticmethod
    def sym(name: str, exp: int = 1) -> "Poly":
        return Poly([Mono.sym(name, exp)])

    @staticmethod
    def product(syms: Sequence[str]) -> "Poly":
        pw: Dict[str, int] = {}
        for s in syms:
            pw[s] = pw.get(s, 0) + 1
        return Poly([Mono.make(1.0, pw)])

    # -- algebra -------------------------------------------------------
    def __add__(self, other: "Poly | float | int") -> "Poly":
        if isinstance(other, (int, float)):
            other = Poly.const(other)
        return Poly(self.monos + other.monos)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other: "Poly | float | int") -> "Poly":
        if isinstance(other, (int, float)):
            other = Poly.const(other)
        return Poly(self.monos + tuple(m * -1.0 for m in other.monos))

    def __rsub__(self, other):
        return (self * -1.0).__add__(other)

    def __mul__(self, other: "Poly | Mono | float | int") -> "Poly":
        if isinstance(other, (int, float)):
            return Poly(m * other for m in self.monos)
        if isinstance(other, Mono):
            return Poly(m * other for m in self.monos)
        out = []
        for a in self.monos:
            for b in other.monos:
                out.append(a * b)
        return Poly(out)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other: "Poly | Mono | float | int") -> "Poly":
        if isinstance(other, Poly):
            assert len(other.monos) == 1, "can only divide by a monomial"
            other = other.monos[0]
        return Poly(m / other for m in self.monos)

    @property
    def is_const(self) -> bool:
        return all(m.is_const for m in self.monos)

    @property
    def const_value(self) -> float:
        assert self.is_const
        return sum(m.coeff for m in self.monos) if self.monos else 0.0

    def symbols(self) -> frozenset:
        out: set = set()
        for m in self.monos:
            out |= m.symbols()
        return frozenset(out)

    def subs(self, env: Env) -> "Poly":
        return Poly(m.subs(env) for m in self.monos)

    def evaluate(self, env: Env):
        if not self.monos:
            return 0.0
        out = self.monos[0].evaluate(env)
        for m in self.monos[1:]:
            out = out + m.evaluate(env)
        return out

    def __repr__(self) -> str:
        return " + ".join(map(repr, self.monos)) or "0"

    def __eq__(self, other) -> bool:  # structural equality
        return isinstance(other, Poly) and self.monos == other.monos

    def __hash__(self) -> int:
        return hash(self.monos)


class MaxExpr:
    """max over polynomials.  Latency = max(mem terms..., compute term)."""

    __slots__ = ("arms",)

    def __init__(self, arms: Iterable[Poly]):
        # dedupe structurally
        seen = {}
        for a in arms:
            seen[hash(a)] = a
        self.arms: Tuple[Poly, ...] = tuple(seen.values())

    def subs(self, env: Env) -> "MaxExpr":
        return MaxExpr(a.subs(env) for a in self.arms)

    def evaluate(self, env: Env):
        vals = [a.evaluate(env) for a in self.arms]
        out = vals[0]
        for v in vals[1:]:
            out = np.maximum(out, v)
        return out

    def symbols(self) -> frozenset:
        out: set = set()
        for a in self.arms:
            out |= a.symbols()
        return frozenset(out)

    def __repr__(self) -> str:
        return "max(" + ", ".join(map(repr, self.arms)) + ")"


Expr = Union[Poly, MaxExpr]


# ---------------------------------------------------------------------------
# Criteria generation (paper §V-D): partition + drop rewrite rules.
#
# For a minimize-objective polynomial  obj = sum_i c_i * K_i(known) * U_i(unk)
# we *partition* the sum by unknown factor U: all terms sharing the same U are
# summed into one criterion  crit_U(known) = sum c_i K_i.  For any completion
# of the unknowns, obj = sum_U crit_U * U with U > 0, so if candidate A has
# crit_U(A) <= crit_U(B) for every U then obj(A) <= obj(B) for every future —
# dominance is sound even with negative coefficients (e.g. the -1 terms from
# affine window extents and partial-sum revisit counts).  Criteria whose value
# cannot differ between candidates (no known symbols) are *dropped*.  Max
# expressions partition arm-wise (arm-wise <= implies max <=).
# ---------------------------------------------------------------------------

Criterion = Tuple[Tuple[float, Tuple[Tuple[str, int], ...]], ...]
# a criterion is a sum of (coeff, known_powers) terms


def grouped_criteria(polys: Sequence[Poly], known: frozenset) -> list[Criterion]:
    """Partition each poly by unknown factor; return discriminating criteria.

    ``Mono.powers`` is already sorted with nonzero exponents, so the
    known/unknown factorization of each monomial is a plain membership
    filter — no ``Mono.split`` object churn.  This runs once per known-set
    per explored model, which puts it on the stepper-construction hot path.
    """
    out: Dict[Criterion, None] = {}
    for poly in polys:
        groups: Dict[Tuple[Tuple[str, int], ...], list] = {}
        for m in poly.monos:
            kp: list = []
            up: list = []
            for se in m.powers:
                (kp if se[0] in known else up).append(se)
            key = tuple(up)
            g = groups.get(key)
            if g is None:
                groups[key] = g = []
            g.append((m.coeff, tuple(kp)))
        for terms in groups.values():
            if all(not pw for _, pw in terms):
                continue  # constant across candidates: drop
            crit = tuple(sorted(terms, key=lambda t: t[1]))
            out[crit] = None
    return list(out.keys())


def expr_polys(expr: Expr) -> Tuple[Poly, ...]:
    if isinstance(expr, MaxExpr):
        return expr.arms
    return (expr,)


def eval_criteria(crits: Sequence[Criterion], index: Mapping[str, int],
                  cols: np.ndarray) -> np.ndarray:
    """Evaluate criteria over candidate columns -> (n_candidates, n_crits)."""
    n = cols.shape[0]
    out = np.empty((n, len(crits)))
    for j, crit in enumerate(crits):
        acc = np.zeros(n)
        for coeff, powers in crit:
            t = np.full(n, coeff)
            for s, e in powers:
                c = cols[:, index[s]]
                t = t * (c if e == 1 else c.astype(np.float64) ** e)
            acc += t
        out[:, j] = acc
    return out


# Optional on-card evaluation of the packed kernel (the innermost search
# step).  Off by default: the numpy path is the bit-identity reference.
# Enable with TCM_JIT=1 (or set_jit(True)) to evaluate every kernel call
# with the hand-written CUDA kernel of ``repro_torch.kernels.criteria``,
# which repeats numpy's order of operations; set_jit(True, device="cpu")
# runs its plain torch version.  There is no fallback to numpy: without a
# card, or when the build or a launch fails, the call raises.  Search
# workers read TCM_JIT when they import this module; set_jit reaches this
# process only.
_JIT_ENABLED = os.environ.get("TCM_JIT", "0") not in ("", "0")
_JIT_DEVICE = "cuda"


def set_jit(enabled: bool, device: str = "cuda") -> None:
    """Toggle the on-card kernel-evaluation path at runtime."""
    global _JIT_ENABLED, _JIT_DEVICE
    _JIT_ENABLED = bool(enabled)
    _JIT_DEVICE = device


class CriteriaKernel:
    """Compile a criteria list into packed numpy form, evaluated per batch.

    ``eval_criteria`` re-resolves symbols and recomputes every
    ``column ** exponent`` power at each occurrence of each term, every
    batch.  A kernel resolves the symbol indices once at build time and
    evaluates each distinct ``(column, exponent)`` *factor* exactly once per
    batch (``**`` is by far the most expensive elementwise op here).

    Evaluation is fully packed, factor-major: the factor table is one
    ``(n_factors+1, n)`` matrix whose last row is the constant 1, and every
    term of every criterion is one row of a flat ``(n_terms_total, n)``
    product matrix, initialized to ``coeff * first_factor`` in one shot.
    Factor slot ``q`` then multiplies only the rows whose term actually has
    a ``q``-th factor (an index array per slot — no padded multiplies, so a
    single 14-symbol term does not inflate the work of every 2-symbol term
    sharing its kernel).  Finally terms accumulate into their criteria in
    groups of equal term count via a sequential middle-axis reduction.

    Per scalar, products and sums still run left-to-right in the same order
    as the interpreted loops, so kernel results are bit-identical to
    ``eval_criteria`` — pruning decisions compiled through a kernel cannot
    diverge from the reference path.
    """

    __slots__ = ("n_crits", "_factors", "_coeff_flat",
                 "_fid0", "_slots", "_acc_groups", "_factor_groups",
                 "_jit_call")

    def __init__(self, crits: Sequence[Criterion], index: Mapping[str, int]):
        self.n_crits = len(crits)
        self._jit_call = None
        factor_id: Dict[Tuple[int, int], int] = {}
        factors: list = []  # (column, exponent)
        coeff_flat: list = []
        term_fids: list = []  # per flat term: list of factor ids, in order
        by_nterms: Dict[int, tuple] = {}  # nt -> ([crit_idx], [first_row])
        row = 0
        for j, crit in enumerate(crits):
            grp = by_nterms.get(len(crit))
            if grp is None:
                grp = by_nterms[len(crit)] = ([], [])
            grp[0].append(j)
            grp[1].append(row)
            for coeff, powers in crit:
                coeff_flat.append(coeff)
                fids = []
                for s, e in powers:
                    key = (index[s], e)
                    fid = factor_id.get(key)
                    if fid is None:
                        fid = factor_id[key] = len(factors)
                        factors.append(key)
                    fids.append(fid)
                term_fids.append(fids)
                row += 1
        self._factors = tuple(factors)
        ident = len(factors)  # constant terms read the 1.0 row

        # flat term rows sorted (stably) by factor count, so factor slot q
        # applies to a contiguous tail of the product matrix — a slice
        # in-place multiply instead of a gather/scatter per slot.  Typical
        # inputs are tiny (tens of terms), so the packing below runs as
        # plain Python loops: per-call numpy setup overhead would dominate
        # the construction hot path otherwise.
        n_rows = len(term_fids)
        perm = sorted(range(n_rows), key=lambda r: len(term_fids[r]))
        inv = [0] * n_rows
        for pos, r in enumerate(perm):
            inv[r] = pos
        nfac_sorted = [len(term_fids[r]) for r in perm]
        self._coeff_flat = np.array([coeff_flat[r] for r in perm])
        max_nf = nfac_sorted[-1] if n_rows else 0
        self._fid0 = np.array(
            [term_fids[r][0] if term_fids[r] else ident for r in perm],
            dtype=np.intp)
        slots = []
        for q in range(1, max_nf):
            cut = bisect.bisect_left(nfac_sorted, q + 1)
            slots.append((cut, np.array(
                [term_fids[r][q] for r in perm[cut:]], dtype=np.intp)))
        self._slots = tuple(slots)
        # per equal-term-count group: (nt, criteria columns, (b, nt) matrix
        # of sorted flat-row positions, term order preserved)
        self._acc_groups = tuple(
            (nt, np.array(js, dtype=np.intp),
             np.array([[inv[f + t] for t in range(nt)] for f in fr],
                      dtype=np.intp) if nt else None)
            for nt, (js, fr) in sorted(by_nterms.items()))

        # factor rows grouped by exponent: one gather (+ one scalar-exponent
        # power, the same special-cased ufunc dispatch as ``col ** e``) fills
        # every factor of that exponent at once
        by_exp: Dict[int, list] = {}
        for i, (ci, e) in enumerate(factors):
            by_exp.setdefault(e, []).append((i, ci))
        self._factor_groups = tuple(
            (e, np.array([i for i, _ in rows], dtype=np.intp),
             np.array([ci for _, ci in rows], dtype=np.intp))
            for e, rows in by_exp.items())

    def _factor_table(self, cols: np.ndarray) -> np.ndarray:
        nf = len(self._factors)
        F = np.empty((nf + 1, cols.shape[0]))
        for e, rows, cis in self._factor_groups:
            if e == 1:
                F[rows] = cols.T[cis]
            else:
                F[rows] = cols.T[cis] ** e
        F[nf] = 1.0
        return F

    def __call__(self, cols: np.ndarray) -> np.ndarray:
        """cols: float array (n_candidates, n_syms) -> (n_candidates, n_crits)."""
        n = cols.shape[0]
        if self.n_crits == 0:
            return np.empty((n, 0))
        if _JIT_ENABLED:
            res = self._call_jit(cols)
            if res is not None:
                return res
        F = self._factor_table(cols)
        # flat (n_terms_total, n) product matrix, rows sorted by factor
        # count: slot q multiplies the tail of rows that still have a q-th
        # factor, in the reference's left-to-right per-scalar product order
        T = self._coeff_flat[:, None] * F[self._fid0]
        for cut, fids in self._slots:
            T[cut:] *= F[fids]
        outT = np.empty((self.n_crits, n))
        for nt, js, idx in self._acc_groups:
            if nt == 0:
                # empty criterion: the reference accumulator stays 0.0
                outT[js] = 0.0
                continue
            # idx[:, t] locates term t of every criterion in the group;
            # sequential += keeps the reference's left-to-right accumulation
            # order per scalar (bit-identical; no term product is -0.0
            # here: factors positive, real coefficients nonzero)
            acc = T[idx[:, 0]]  # fancy indexing copies, safe to add into
            for t in range(1, nt):
                acc += T[idx[:, t]]
            outT[js] = acc
        return outT.T

    def _call_jit(self, cols: np.ndarray):
        """The route of TCM_JIT=1: the criteria kernel on ``_JIT_DEVICE``.

        The description is packed and uploaded once per kernel (again only
        if ``set_jit`` changed the device); each call copies the columns
        to the device and the criteria back.  Bit-identical to the numpy
        path wherever each factor's exact power is representable in f64
        (see ``repro_torch.kernels.criteria``).  Never None: a missing
        card, build or launch raises.
        """
        from ..kernels import criteria
        if self._jit_call is None or self._jit_call.asked != _JIT_DEVICE:
            self._jit_call = criteria.pack(self, _JIT_DEVICE)
        return criteria.evaluate(self._jit_call, cols)


# ---------------------------------------------------------------------------
# Vectorized compiled evaluation: Poly/MaxExpr -> f(array_env) -> array
# ---------------------------------------------------------------------------

class CompiledExpr:
    """Compile an expression over a fixed symbol ordering into a closure that
    evaluates over numpy arrays (candidates stacked along axis 0).

    This is the deliverable "tile-shape-only model": built once per
    (dataplacement, dataflow), then evaluated for millions of tile shapes.
    """

    def __init__(self, expr: Expr, sym_order: Sequence[str]):
        self.sym_order = tuple(sym_order)
        self.index = {s: i for i, s in enumerate(self.sym_order)}
        if isinstance(expr, MaxExpr):
            self._arms = [self._compile_poly(a) for a in expr.arms]
            self._is_max = True
        else:
            self._arms = [self._compile_poly(expr)]
            self._is_max = False

    def _compile_poly(self, poly: Poly):
        terms = []
        for m in poly.monos:
            idx = [self.index[s] for s, _ in m.powers]
            exps = [e for _, e in m.powers]
            terms.append((m.coeff, idx, exps))
        return terms

    def __call__(self, cols: np.ndarray) -> np.ndarray:
        """cols: float array (n_candidates, n_syms) in sym_order."""
        arms = []
        for terms in self._arms:
            acc = np.zeros(cols.shape[0])
            for coeff, idx, exps in terms:
                t = np.full(cols.shape[0], coeff)
                for i, e in zip(idx, exps):
                    c = cols[:, i]
                    t = t * (c if e == 1 else c ** e)
                acc += t
            arms.append(acc)
        if self._is_max:
            return np.maximum.reduce(arms)
        return arms[0]


def lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
