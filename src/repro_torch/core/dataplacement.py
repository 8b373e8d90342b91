"""Dataplacement enumeration (paper §V-A).

A dataplacement is the set of storage nodes plus their order.  Level-0 (the
outermost backing store) always holds every tensor, in canonical order, with
no loops between its nodes.  For each deeper level we choose which tensors to
keep (subject to ``MemLevel.allowed_tensors`` / ``mandatory``) and the order
of the chosen storage nodes within the level.  Levels appear in hierarchy
order (the paper's default; footnote 4's per-tensor relaxation is future
work and would only enlarge |DP|, which stays small either way).
"""
from __future__ import annotations

from itertools import permutations
from typing import Iterator, List, Mapping, Sequence, Tuple

from .arch import Arch
from .einsum import Einsum
from .looptree import Storage

Dataplacement = Tuple[Storage, ...]


def _level_choices(arch: Arch, level: int, tensors: Sequence[str]) -> List[Tuple[str, ...]]:
    lvl = arch.levels[level]
    allowed = [t for t in tensors
               if lvl.allowed_tensors is None or t in lvl.allowed_tensors]
    out: List[Tuple[str, ...]] = []
    if lvl.mandatory:
        if lvl.fixed_order:
            return [tuple(allowed)]
        # every allowed tensor must be present; orders still vary
        out.extend(permutations(allowed))
        return out
    # all subsets x orderings
    n = len(allowed)
    for mask in range(1 << n):
        subset = [allowed[i] for i in range(n) if mask >> i & 1]
        out.extend(permutations(subset))
    return out


def enumerate_dataplacements(einsum: Einsum, arch: Arch) -> Iterator[Dataplacement]:
    tensors = [t.name for t in einsum.tensors]
    backing = tuple(Storage(0, t) for t in tensors)

    def rec(level: int, acc: Tuple[Storage, ...]) -> Iterator[Dataplacement]:
        if level == len(arch.levels):
            yield acc
            return
        for choice in _level_choices(arch, level, tensors):
            yield from rec(level + 1,
                           acc + tuple(Storage(level, t) for t in choice))

    yield from rec(1, backing)


def count_dataplacements(einsum: Einsum, arch: Arch) -> int:
    tensors = [t.name for t in einsum.tensors]
    total = 1
    for level in range(1, len(arch.levels)):
        total *= len(_level_choices(arch, level, tensors))
    return total


# -- pinned (fused-group member) dataplacements ------------------------------


def enumerate_pinned_dataplacements(
    einsum: Einsum, arch: Arch, pinned: Mapping[str, int],
) -> Iterator[Tuple[Dataplacement, int]]:
    """Dataplacements of one fused-group member with on-chip intermediates.

    ``pinned`` maps tensor names to their pin level (a non-DRAM level).  A
    pinned tensor has **no level-0 (DRAM) node**: its outermost storage node
    sits at the pin level, in the member's *backing region* — the leading
    run of nodes that the fused assembler keeps directly below the shared
    co-tiled loop prefix.  Deeper levels enumerate exactly as in
    :func:`enumerate_dataplacements`, except a pinned tensor is excluded
    from levels at or above its pin (its data never exists there).

    Yields ``(dataplacement, n_backing)`` pairs — ``n_backing`` is the
    length of the backing region (level-0 nodes plus pin nodes), which the
    skeleton enumeration needs to know where loop slots may start.
    """
    tensors = [t.name for t in einsum.tensors]
    backing = tuple(Storage(0, t) for t in tensors if t not in pinned)
    # pin nodes in canonical (tensor-list) order per level, shallow first
    pins = tuple(Storage(lvl, t)
                 for lvl, t in sorted(((pinned[t], t) for t in tensors
                                       if t in pinned),
                                      key=lambda p: (p[0], tensors.index(p[1]))))
    for t, lvl in pinned.items():
        assert lvl >= 1, f"pin level for {t} must be non-DRAM"
        allowed = arch.levels[lvl].allowed_tensors
        assert allowed is None or t in allowed, (
            f"{t} not admitted at pin level {lvl}")
    head = backing + pins
    n_backing = len(head)

    def rec(level: int, acc: Tuple[Storage, ...]) -> Iterator[Dataplacement]:
        if level == len(arch.levels):
            yield acc
            return
        # pinned tensors exist only below their pin level; at the pin level
        # itself the node already sits in the backing region
        visible = [t for t in tensors if pinned.get(t, 0) < level]
        for choice in _level_choices(arch, level, visible):
            yield from rec(level + 1,
                           acc + tuple(Storage(level, t) for t in choice))

    for dp in rec(1, head):
        yield dp, n_backing
