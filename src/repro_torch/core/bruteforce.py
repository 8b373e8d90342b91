"""Exhaustive mapspace enumeration — the validation oracle for TCM.

Enumerates the *unpruned* space: every dataplacement x every placement and
order of loops over every rank var in every slot x every exact factorization,
plus spatial loops under the hardware's fanout constraints.  Evaluates each
complete mapping with the numeric reference model.  Exponential — only for
tiny workloads in tests, where TCM's optimum must match.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations, product
from typing import Iterator, List, Optional, Sequence, Tuple

from .arch import Arch
from .dataflow import _spatial_block, make_slots
from .dataplacement import enumerate_dataplacements
from .einsum import Einsum
from .looptree import Loop, Mapping, Storage, validate_structure
from .refmodel import EvalResult, evaluate


def _ordered_factorizations(n: int, k: int) -> Iterator[Tuple[int, ...]]:
    """All tuples (f1..fk) with product == n."""
    if k == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _ordered_factorizations(n // d, k - 1):
                yield (d,) + rest


def enumerate_mappings(einsum: Einsum, arch: Arch,
                       keep_unit_loops: bool = True) -> Iterator[Mapping]:
    vars_ = list(einsum.rank_vars)
    for dp in enumerate_dataplacements(einsum, arch):
        nodes = list(dp)
        last_backing = max(i for i, s in enumerate(nodes) if s.level == 0)
        slots = make_slots(einsum, arch, dp)
        n_slots = len(slots)

        # spatial loop sites (same hardware-legal sites TCM uses)
        spatial_at: dict = {}
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

        # temporal positions: n_slots per var; spatial: per eligible site
        per_var_choices = []
        for v in vars_:
            shape = einsum.rank_shapes[v]
            sp_sites_v = [s for s in spatial_sites if s.var == v]
            k = n_slots + len(sp_sites_v)
            per_var_choices.append(list(_ordered_factorizations(shape, k)))

        for combo in product(*per_var_choices):
            # check fanout capacity
            fan_used: dict = {}
            ok = True
            sp_bounds: dict = {}  # id(site loop) -> bound
            for v, factors in zip(vars_, combo):
                sp_sites_v = [s for s in spatial_sites if s.var == v]
                for s, b in zip(sp_sites_v, factors[n_slots:]):
                    sp_bounds[id(s)] = b
                    key = (s.fanout, s.dim)
                    fan_used[key] = fan_used.get(key, 1) * b
            for (fi, d), used in fan_used.items():
                if used > arch.fanouts[fi].dims[d]:
                    ok = False
            if not ok:
                continue

            # per-slot loop multisets
            slot_loops: List[List[Loop]] = [[] for _ in range(n_slots)]
            for v, factors in zip(vars_, combo):
                for si in range(n_slots):
                    b = factors[si]
                    if b > 1 or keep_unit_loops:
                        slot_loops[si].append(Loop(v, b))

            # permutations per slot
            def rec(si: int, acc: List[Tuple[Loop, ...]]) -> Iterator[Mapping]:
                if si == n_slots:
                    m: List = list(nodes[:last_backing + 1])
                    for kk, loops_k in enumerate(acc):
                        node_idx = last_backing + kk + 1
                        m.extend(loops_k)
                        if node_idx in spatial_at:
                            for s in spatial_at[node_idx]:
                                b = sp_bounds.get(id(s), 1)
                                if b > 1 or keep_unit_loops:
                                    m.append(Loop(s.var, b, spatial=True,
                                                  fanout=s.fanout, dim=s.dim))
                        if node_idx < len(nodes):
                            m.append(nodes[node_idx])
                    yield tuple(m)
                    return
                seen = set()
                for perm in permutations(slot_loops[si]):
                    if perm in seen:
                        continue
                    seen.add(perm)
                    yield from rec(si + 1, acc + [perm])

            yield from rec(0, [])


@dataclass
class BruteForceResult:
    mapping: Mapping
    result: EvalResult
    n_enumerated: int
    n_valid: int


def brute_force_optimum(einsum: Einsum, arch: Arch, objective: str = "edp",
                        keep_unit_loops: bool = True) -> Optional[BruteForceResult]:
    """keep_unit_loops=False shrinks the enumeration by dropping bound-1
    loops; safe when no tensor has affine (partially-relevant) dims, where
    unit loops are exact semantic no-ops (they only matter for halo/line-
    buffer adjacency)."""
    best: Optional[Tuple[float, Mapping, EvalResult]] = None
    n = 0
    n_valid = 0
    for m in enumerate_mappings(einsum, arch, keep_unit_loops=keep_unit_loops):
        n += 1
        res = evaluate(einsum, arch, m)
        if not res.valid:
            continue
        n_valid += 1
        obj = {"edp": res.edp, "energy": res.energy,
               "latency": res.latency}[objective]
        if best is None or obj < best[0]:
            best = (obj, m, res)
    if best is None:
        return None
    return BruteForceResult(best[1], best[2], n, n_valid)
