"""Soundness fuzzing: cross-check TCM against the brute-force oracle and the
gym baselines on tiny random workloads.

Each fuzz case draws a tiny einsum (matmul / batched matmul / conv) and a
small 1-2-level architecture, then asserts, for one objective:

  1. *oracle agreement* — ``tcm_map``'s optimum equals
     ``core.bruteforce.brute_force_optimum``'s over the unpruned space
     (within ``REL_EPS`` relative tolerance, both directions);
  2. *no baseline ever beats the optimum* — random sampling, simulated
     annealing and the evolutionary mapper at a small eval budget all land
     at or above it;
  3. every baseline's best mapping is ``validate_structure``-clean.

A violated case is *minimized* (greedily shrinking rank shapes and memory
capacity while the violation reproduces) and serialized to a replayable
JSON repro (seed + einsum + arch), so a failed CI fuzz run hands the next
session a one-command reproduction instead of a flaky stack trace.
"""
from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.arch import Arch, MemLevel, SpatialFanout, arch_from_dict, \
    arch_to_dict
from ..core.baselines import evolutionary, simulated_annealing, timeloop_like
from ..core.bruteforce import brute_force_optimum
from ..core.einsum import (Einsum, TensorSpec, batched_matmul,
                           einsum_from_dict, einsum_to_dict, matmul)
from ..core.fusion import FusedWorkload, GroupEdge
from ..core.looptree import validate_structure
from ..core.mapper import tcm_map
from .runner import REL_EPS, derive_seed

OBJECTIVES = ("edp", "energy", "latency")

# per-baseline eval budget inside one fuzz case; small on purpose — the
# point is coverage over many (einsum, arch) draws, not search quality
CASE_BUDGET = 40

BASELINE_FNS: Dict[str, Callable] = {
    "random": lambda e, a, s, o: timeloop_like(
        e, a, budget_evals=CASE_BUDGET, seed=s, objective=o),
    "sa": lambda e, a, s, o: simulated_annealing(
        e, a, budget_evals=CASE_BUDGET, seed=s, objective=o),
    "ga": lambda e, a, s, o: evolutionary(
        e, a, budget_evals=CASE_BUDGET, seed=s, objective=o,
        pop_size=8, elite=2),
}


@dataclass
class FuzzCase:
    """One replayable fuzz draw (everything needed to re-run it)."""

    seed: int
    einsum: Einsum
    arch: Arch
    objective: str

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "seed": self.seed,
            "objective": self.objective,
            "einsum": einsum_to_dict(self.einsum),
            "arch": arch_to_dict(self.arch),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FuzzCase":
        return cls(seed=int(d["seed"]),
                   einsum=einsum_from_dict(d["einsum"]),
                   arch=arch_from_dict(d["arch"]),
                   objective=d["objective"])


@dataclass
class SoundnessViolation:
    kind: str  # oracle_mismatch | baseline_beats_optimum | invalid_structure
    detail: str
    case: FuzzCase
    minimized: Optional[FuzzCase] = None

    def to_dict(self) -> dict:
        out = {"kind": self.kind, "detail": self.detail,
               "case": self.case.to_dict()}
        if self.minimized is not None:
            out["minimized"] = self.minimized.to_dict()
        return out


@dataclass
class FuzzReport:
    n_cases: int = 0
    n_oracle_checked: int = 0
    n_baseline_runs: int = 0
    n_resumed: int = 0  # cases served from a resume journal, not re-run
    wall_s: float = 0.0
    violations: List[SoundnessViolation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "n_cases": self.n_cases,
            "n_oracle_checked": self.n_oracle_checked,
            "n_baseline_runs": self.n_baseline_runs,
            "n_resumed": self.n_resumed,
            "wall_s": round(self.wall_s, 3),
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
        }


# shape whitelists keep the brute-force oracle tractable: its enumeration
# grows with the product of per-var ordered-factorization counts (and, for
# affine convs, keep_unit_loops puts every var in every slot's permutation),
# so fuzz diversity comes from many draws, not from big shapes
_MM_SHAPES = ((2, 2, 2), (3, 2, 2), (2, 3, 2), (4, 2, 2), (2, 2, 4),
              (4, 3, 2), (3, 3, 2), (6, 2, 2), (4, 4, 2), (3, 2, 4))
_BMM_SHAPES = ((2, 2, 2, 2), (2, 3, 2, 2), (3, 2, 2, 2), (2, 2, 3, 2),
               (2, 4, 2, 2))
_CONV_SHAPES = ((4, 2), (4, 3), (6, 2))


def random_case(rng: random.Random, objective: Optional[str] = None
                ) -> FuzzCase:
    """Draw one tiny (einsum, arch, objective) triple.

    Shapes stay tiny so the brute-force oracle enumerates each case in
    around a second or less, letting CI clear hundreds of cases per run.
    """
    seed = rng.randrange(2 ** 31)
    r = random.Random(seed)
    kind = r.randrange(3)
    if kind == 0:
        ein = matmul("fz_mm", *r.choice(_MM_SHAPES))
    elif kind == 1:
        ein = batched_matmul("fz_bmm", *r.choice(_BMM_SHAPES))
    else:
        # 1-D conv with an affine input dim (halo); only two rank vars —
        # keep_unit_loops=True enumeration is exponential in the var count
        P, R = r.choice(_CONV_SHAPES)
        ein = Einsum("fz_conv",
                     (TensorSpec("A", (("p", "r"),)),
                      TensorSpec("W", ("r",)),
                      TensorSpec("Z", ("p",), is_output=True)),
                     {"p": P, "r": R})
    dram_e = r.choice([50.0, 100.0, 200.0])
    levels = [MemLevel("DRAM", float("inf"), dram_e, dram_e,
                       r.choice([1e7, 1e8]))]
    cap = r.choice([6, 8, 16, 64, 256])
    glb_e = r.choice([0.5, 1.0, 2.0])
    levels.append(MemLevel("GLB", cap, glb_e, glb_e, 1e9))
    fanouts: Tuple[SpatialFanout, ...] = ()
    if r.random() < 0.4:
        # small spatial array below the innermost level, with multicast /
        # reduction wiring on the einsum's first input and its output
        first_in = ein.inputs[0].name
        out_t = ein.output.name
        fanouts = (SpatialFanout(above_level=1, dims=(2, 2),
                                 multicast_tensor=(first_in, None),
                                 reduce_tensor=(None, out_t)),)
    arch = Arch("fuzz", tuple(levels), fanouts=fanouts,
                mac_energy=r.choice([0.3, 0.5]))
    obj = objective if objective is not None else OBJECTIVES[r.randrange(3)]
    return FuzzCase(seed=seed, einsum=ein, arch=arch, objective=obj)


def check_case(case: FuzzCase, oracle: bool = True
               ) -> Tuple[List[SoundnessViolation], int]:
    """Run one case; returns (violations, n_baseline_runs)."""
    violations: List[SoundnessViolation] = []
    best, _ = tcm_map(case.einsum, case.arch, objective=case.objective)
    opt = best.objective(case.objective) if best is not None else float("inf")

    if oracle:
        # convs have affine (partially-relevant) dims where bound-1 loops
        # matter for halo adjacency; keep them in the oracle's enumeration
        affine = any(isinstance(d, tuple) for t in case.einsum.tensors
                     for d in t.dims)
        bf = brute_force_optimum(case.einsum, case.arch,
                                 objective=case.objective,
                                 keep_unit_loops=affine)
        bf_obj = float("inf")
        if bf is not None:
            bf_obj = {"edp": bf.result.edp, "energy": bf.result.energy,
                      "latency": bf.result.latency}[case.objective]
        if (best is None) != (bf is None):
            violations.append(SoundnessViolation(
                "oracle_mismatch",
                f"tcm={'none' if best is None else opt} vs "
                f"bruteforce={'none' if bf is None else bf_obj}", case))
        elif best is not None and not (
                bf_obj * (1 - REL_EPS) <= opt <= bf_obj * (1 + REL_EPS)):
            violations.append(SoundnessViolation(
                "oracle_mismatch",
                f"tcm optimum {opt} != bruteforce {bf_obj}", case))

    n_runs = 0
    for bname, fn in BASELINE_FNS.items():
        s = derive_seed(case.seed, "fuzz", bname)
        r = fn(case.einsum, case.arch, s, case.objective)
        n_runs += 1
        obj = r.objective(case.objective)
        if obj < opt * (1 - REL_EPS):
            violations.append(SoundnessViolation(
                "baseline_beats_optimum",
                f"{bname} found {obj} < claimed optimum {opt}", case))
        if r.best_mapping is not None:
            try:
                validate_structure(case.einsum, case.arch, r.best_mapping)
            except AssertionError as e:
                violations.append(SoundnessViolation(
                    "invalid_structure", f"{bname}: {e}", case))
    return violations, n_runs


def _violates(case: FuzzCase) -> bool:
    vs, _ = check_case(case)
    return bool(vs)


def minimize_case(case: FuzzCase, max_steps: int = 32) -> FuzzCase:
    """Greedy shrink: repeatedly halve one rank shape (to a proper divisor)
    or the on-chip capacity while the case still violates.  Deterministic;
    returns the smallest still-violating case found."""
    cur = case
    for _ in range(max_steps):
        shrunk = None
        for v, shape in sorted(cur.einsum.rank_shapes.items()):
            if shape <= 2:
                continue
            smaller = max(d for d in range(1, shape) if shape % d == 0)
            if smaller < 2:
                continue
            shapes = dict(cur.einsum.rank_shapes)
            shapes[v] = smaller
            cand = FuzzCase(cur.seed,
                            Einsum(cur.einsum.name, cur.einsum.tensors,
                                   shapes),
                            cur.arch, cur.objective)
            if _violates(cand):
                shrunk = cand
                break
        if shrunk is None:
            d = arch_to_dict(cur.arch)
            cap = d["levels"][-1]["capacity"]
            if isinstance(cap, (int, float)) and cap > 4:
                d["levels"][-1]["capacity"] = int(cap) // 2
                cand = FuzzCase(cur.seed, cur.einsum, arch_from_dict(d),
                                cur.objective)
                if _violates(cand):
                    shrunk = cand
        if shrunk is None:
            return cur
        cur = shrunk
    return cur


def _load_fuzz_journal(path: str, seed: int) -> Dict[int, dict]:
    """Clean finished-case records from a resume journal (torn/corrupt
    lines and other seeds' records are skipped; violating cases are NOT
    served — a resumed run re-checks them so violations are regenerated,
    never trusted from disk)."""
    import os
    done: Dict[int, dict] = {}
    if not path or not os.path.exists(path):
        return done
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn trailing line
            if (isinstance(rec, dict) and rec.get("seed") == seed
                    and rec.get("ok") and isinstance(rec.get("i"), int)):
                done[rec["i"]] = rec
    return done


def fuzz(n_cases: int, seed: int = 0,
         objectives: Sequence[str] = OBJECTIVES,
         oracle: bool = True,
         time_budget_s: Optional[float] = None,
         minimize: bool = True,
         verbose: bool = False,
         journal_path: Optional[str] = None) -> FuzzReport:
    """Run ``n_cases`` fuzz draws (round-robin over ``objectives``).

    ``journal_path`` makes the campaign resumable: every finished case
    appends one durable JSON line, and a later call with the same ``seed``
    skips the cases already proven clean (their counters fold into the
    report with ``n_resumed``).  The RNG is still advanced through skipped
    draws, so case ``i`` is identical whether or not the run was
    interrupted.
    """
    import os
    rng = random.Random(seed)
    report = FuzzReport()
    done = _load_fuzz_journal(journal_path, seed) if journal_path else {}
    jf = None
    if journal_path:
        os.makedirs(os.path.dirname(journal_path) or ".", exist_ok=True)
        jf = open(journal_path, "a", encoding="utf-8")
    t0 = time.perf_counter()
    try:
        for i in range(n_cases):
            if time_budget_s is not None and \
                    time.perf_counter() - t0 > time_budget_s:
                break
            # the draw must happen even for resumed cases: it advances the
            # RNG, keeping every later case bit-identical to an
            # uninterrupted run
            case = random_case(rng,
                               objective=objectives[i % len(objectives)])
            rec = done.get(i)
            if rec is not None:
                report.n_cases += 1
                report.n_resumed += 1
                report.n_oracle_checked += 1 if rec.get("oracle") else 0
                report.n_baseline_runs += int(rec.get("n_runs", 0))
                continue
            vs, n_runs = check_case(case, oracle=oracle)
            report.n_cases += 1
            report.n_oracle_checked += 1 if oracle else 0
            report.n_baseline_runs += n_runs
            for v in vs:
                if minimize:
                    v.minimized = minimize_case(case)
                report.violations.append(v)
            if jf is not None:
                jf.write(json.dumps({"seed": seed, "i": i, "ok": not vs,
                                     "oracle": oracle, "n_runs": n_runs},
                                    separators=(",", ":")) + "\n")
                jf.flush()
                os.fsync(jf.fileno())
            if verbose and (i + 1) % 25 == 0:
                print(f"# fuzz: {i + 1}/{n_cases} cases, "
                      f"{len(report.violations)} violation(s), "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
    finally:
        if jf is not None:
            jf.close()
    report.wall_s = time.perf_counter() - t0
    return report


def write_repro(violation: SoundnessViolation, path: str) -> None:
    with open(path, "w") as f:
        json.dump(violation.to_dict(), f, indent=2, sort_keys=True)


def replay(path: str) -> Tuple[List[SoundnessViolation], int]:
    """Re-run a serialized repro case (the minimized one when present).

    Dispatches on the serialized ``kind``: fused-cascade repros re-run
    through :func:`check_fused_case`, plain einsum repros through
    :func:`check_case`.
    """
    with open(path) as f:
        d = json.load(f)
    cd = d.get("minimized") or d["case"]
    if cd.get("kind") == "fused":
        return check_fused_case(FusedFuzzCase.from_dict(cd))
    return check_case(FuzzCase.from_dict(cd))


# ---------------------------------------------------------------------------
# Fused-group brute-force oracle: tiny 2-member cascades, enumerated
# exhaustively through the joint mapspace and compared against
# ``tcm_map_group`` — the fused counterpart of the single-einsum oracle
# above (closes the ROADMAP "fused-group soundness fuzzing" follow-up).
# ---------------------------------------------------------------------------

# joint-space guard: a draw whose unpruned fused wave outgrows this is
# skipped (counted, not failed) — diversity comes from many tiny draws
FUSED_WAVE_LIMIT = 200_000

# tiny cascade shape pools: (H, M, K, N, N2) for Z0[h,m,n] = A@B feeding
# Z1[h,m,n2] = Z0@C.  H/M = 1 drops the batch / shared-row class entirely,
# exercising degenerate shared-class structure.
_FUSED_DIMS = (1, 2, 4)


@dataclass
class FusedFuzzCase:
    """One replayable fused fuzz draw.

    The cascade is *parametric* — ``shapes = (H, M, K, N, N2)`` rebuilds
    both chained batched matmuls — so greedy minimization can shrink the
    shared contraction structure without ever breaking the producer ->
    consumer shape chain (member 0's ``n`` is member 1's ``k``).
    """

    seed: int
    shapes: Tuple[int, int, int, int, int]  # (H, M, K, N, N2)
    arch: Arch
    objective: str

    def group(self) -> "FusedWorkload":
        h, m, k, n, n2 = self.shapes
        prod = batched_matmul("fz0", h, m, k, n)
        cons = batched_matmul("fz1", h, m, n, n2)
        return FusedWorkload("fz0+fz1", (prod, cons),
                            (GroupEdge(0, 1, "Z", "A"),))

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "kind": "fused",
            "seed": self.seed,
            "objective": self.objective,
            "shapes": list(self.shapes),
            "arch": arch_to_dict(self.arch),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FusedFuzzCase":
        return cls(seed=int(d["seed"]),
                   shapes=tuple(int(s) for s in d["shapes"]),
                   arch=arch_from_dict(d["arch"]),
                   objective=d["objective"])


def random_fused_case(rng: random.Random,
                      objective: Optional[str] = None) -> FusedFuzzCase:
    """Draw one tiny cascade: random chained shapes, random 2-level arch.

    The on-chip capacity draw varies which pin levels
    ``enumerate_fused_skeletons`` admits (the intermediate ``H*M*N`` must
    fit), so fuzz coverage sweeps pin placements as well as shapes.
    """
    seed = rng.randrange(2 ** 31)
    r = random.Random(seed)
    shapes = tuple(r.choice(_FUSED_DIMS) for _ in range(5))
    dram_e = r.choice([50.0, 100.0, 200.0])
    levels = [MemLevel("DRAM", float("inf"), dram_e, dram_e,
                       r.choice([1e7, 1e8]))]
    cap = r.choice([8, 16, 32, 64, 256])
    glb_e = r.choice([0.5, 1.0, 2.0])
    levels.append(MemLevel("GLB", cap, glb_e, glb_e, 1e9))
    fanouts: Tuple[SpatialFanout, ...] = ()
    if r.random() < 0.3:
        fanouts = (SpatialFanout(above_level=1, dims=(2, 2)),)
    arch = Arch("fz_fused", tuple(levels), fanouts=fanouts,
                mac_energy=r.choice([0.3, 0.5]))
    obj = objective if objective is not None else OBJECTIVES[r.randrange(3)]
    return FusedFuzzCase(seed=seed, shapes=shapes, arch=arch, objective=obj)


def _fused_exhaustive_optimum(case: FusedFuzzCase) -> float:
    """Exhaustive minimum of ``case.objective`` over the *entire* joint
    mapspace (every fused skeleton unit, every divisor assignment), using
    the same ``FusedTileShapeModel`` cost the group search optimizes.

    The unpruned frontier is expanded wave-by-wave with the fused
    stepper's own ``expand`` (so the enumeration satisfies exactly the
    divisibility/fanout structure of the search space) but *no* pruning of
    any kind.  Raises :class:`FusedCaseTooBig` past ``FUSED_WAVE_LIMIT``.
    """
    from .gym import FusedMapspaceGym
    gym = FusedMapspaceGym(case.group(), case.arch)
    best = float("inf")
    for u in range(len(gym.units)):
        st = gym._stepper(u)
        cols, rem, fan_rem = st.init_state()
        dead = False
        for k in st.explore_order:
            out = st.expand(k, cols, rem, fan_rem)
            if out is None:
                dead = True
                break
            cols, rem, fan_rem = out
            if cols.shape[0] > FUSED_WAVE_LIMIT:
                raise FusedCaseTooBig(
                    f"unit {u}: wave {cols.shape[0]} > {FUSED_WAVE_LIMIT}")
        if dead:
            continue
        done = (rem == 1).all(axis=1)
        if not done.any():
            continue
        e, l, valid = gym._model(u).tile_shape_model(cols[done])
        if not valid.any():
            continue
        if case.objective == "edp":
            obj = e * l
        elif case.objective == "energy":
            obj = e
        else:
            obj = l
        best = min(best, float(obj[valid].min()))
    return best


class FusedCaseTooBig(Exception):
    """Joint mapspace too large for exhaustive enumeration; skip the draw."""


def check_fused_case(case: FusedFuzzCase
                     ) -> Tuple[List[SoundnessViolation], int]:
    """Cross-check ``tcm_map_group`` against the exhaustive joint optimum.

    Two searches run per case: an *unseeded* one, whose optimum must equal
    the exhaustive minimum exactly (both directions, ``REL_EPS``), and a
    *production-style* one seeded with the independent-search incumbent
    (``inc_obj``), which must return the same optimum whenever the fused
    optimum beats the seed and ``None`` only when it doesn't — so unsound
    incumbent cuts, chain lower bounds and dominance keys all indict
    themselves.  Returns ``(violations, n_searches)``.
    """
    from ..core.mapper import tcm_map_group

    violations: List[SoundnessViolation] = []
    group = case.group()
    obj_kind = case.objective
    oracle = _fused_exhaustive_optimum(case)

    def _obj(res) -> float:
        return {"edp": res.energy * res.latency, "energy": res.energy,
                "latency": res.latency}[obj_kind]

    fused, _ = tcm_map_group(group, case.arch, objective=obj_kind)
    opt = _obj(fused) if fused is not None else float("inf")
    both_none = fused is None and oracle == float("inf")
    if not both_none and not (
            oracle * (1 - REL_EPS) <= opt <= oracle * (1 + REL_EPS)):
        violations.append(SoundnessViolation(
            "fused_oracle_mismatch",
            f"tcm_map_group optimum {opt} != exhaustive {oracle}", case))

    # production path: independent searches seed the incumbent
    inc = float("inf")
    b0, _ = tcm_map(group.members[0], case.arch, objective=obj_kind)
    b1, _ = tcm_map(group.members[1], case.arch, objective=obj_kind)
    if b0 is not None and b1 is not None:
        e = b0.energy + b1.energy
        l = b0.latency + b1.latency
        inc = {"edp": e * l, "energy": e, "latency": l}[obj_kind]
    seeded, _ = tcm_map_group(group, case.arch, objective=obj_kind,
                              inc_obj=inc)
    if seeded is not None:
        s_obj = _obj(seeded)
        if not (oracle * (1 - REL_EPS) <= s_obj <= oracle * (1 + REL_EPS)):
            violations.append(SoundnessViolation(
                "fused_oracle_mismatch",
                f"seeded tcm_map_group optimum {s_obj} != exhaustive "
                f"{oracle}", case))
    elif oracle < inc * (1 - REL_EPS):
        violations.append(SoundnessViolation(
            "fused_incumbent_overprune",
            f"seeded tcm_map_group found nothing below inc {inc} but the "
            f"exhaustive optimum {oracle} beats it", case))
    return violations, 4


def _violates_fused(case: FusedFuzzCase) -> bool:
    try:
        vs, _ = check_fused_case(case)
    except FusedCaseTooBig:
        return False
    return bool(vs)


def minimize_fused_case(case: FusedFuzzCase,
                        max_steps: int = 32) -> FusedFuzzCase:
    """Greedy shrink of a violating cascade: halve one of the five shape
    parameters (keeping the producer/consumer chain consistent by
    construction) or the on-chip capacity while the violation reproduces."""
    cur = case
    for _ in range(max_steps):
        shrunk = None
        for i, dim in enumerate(cur.shapes):
            if dim <= 1:
                continue
            shapes = list(cur.shapes)
            shapes[i] = dim // 2
            cand = FusedFuzzCase(cur.seed, tuple(shapes), cur.arch,
                                 cur.objective)
            if _violates_fused(cand):
                shrunk = cand
                break
        if shrunk is None:
            d = arch_to_dict(cur.arch)
            cap = d["levels"][-1]["capacity"]
            if isinstance(cap, (int, float)) and cap > 4:
                d["levels"][-1]["capacity"] = int(cap) // 2
                cand = FusedFuzzCase(cur.seed, cur.shapes,
                                     arch_from_dict(d), cur.objective)
                if _violates_fused(cand):
                    shrunk = cand
        if shrunk is None:
            return cur
        cur = shrunk
    return cur


def fuzz_fused(n_cases: int, seed: int = 0,
               objectives: Sequence[str] = OBJECTIVES,
               time_budget_s: Optional[float] = None,
               minimize: bool = True,
               verbose: bool = False,
               journal_path: Optional[str] = None) -> FuzzReport:
    """Fused-cascade fuzz campaign; same protocol/report as :func:`fuzz`
    (round-robin objectives, resumable journal, greedy minimization), with
    the exhaustive joint-mapspace optimum as the oracle.  Draws whose
    unpruned joint space exceeds ``FUSED_WAVE_LIMIT`` are skipped without
    counting as oracle-checked."""
    import os
    rng = random.Random(seed)
    report = FuzzReport()
    done = _load_fuzz_journal(journal_path, seed) if journal_path else {}
    jf = None
    if journal_path:
        os.makedirs(os.path.dirname(journal_path) or ".", exist_ok=True)
        jf = open(journal_path, "a", encoding="utf-8")
    t0 = time.perf_counter()
    try:
        for i in range(n_cases):
            if time_budget_s is not None and \
                    time.perf_counter() - t0 > time_budget_s:
                break
            case = random_fused_case(
                rng, objective=objectives[i % len(objectives)])
            rec = done.get(i)
            if rec is not None:
                report.n_cases += 1
                report.n_resumed += 1
                report.n_oracle_checked += 1 if rec.get("oracle") else 0
                report.n_baseline_runs += int(rec.get("n_runs", 0))
                continue
            try:
                vs, n_runs = check_fused_case(case)
                checked = True
            except FusedCaseTooBig:
                vs, n_runs = [], 0
                checked = False
            report.n_cases += 1
            report.n_oracle_checked += 1 if checked else 0
            report.n_baseline_runs += n_runs
            for v in vs:
                if minimize:
                    v.minimized = minimize_fused_case(case)
                report.violations.append(v)
            if jf is not None:
                jf.write(json.dumps({"seed": seed, "i": i, "ok": not vs,
                                     "oracle": checked, "n_runs": n_runs},
                                    separators=(",", ":")) + "\n")
                jf.flush()
                os.fsync(jf.fileno())
            if verbose and (i + 1) % 25 == 0:
                print(f"# fuzz-fused: {i + 1}/{n_cases} cases, "
                      f"{len(report.violations)} violation(s), "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
    finally:
        if jf is not None:
            jf.close()
    report.wall_s = time.perf_counter() - t0
    return report
