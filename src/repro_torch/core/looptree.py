"""LoopTree mapping IR (paper §II-B).

A mapping for one Einsum is a *linearized* LoopTree: a top-to-bottom sequence
of storage nodes and loops, with the compute node implicit at the bottom.

  * ``Storage(level, tensor)`` — a tile of ``tensor`` is kept at memory level
    ``level`` (index into ``Arch.levels``; 0 = outermost backing store).
  * ``Loop(var, bound)`` — temporal loop over rank var with the given bound.
  * ``Loop(var, bound, spatial=True, fanout=i, dim=j)`` — spatial loop mapped
    to dim ``j`` of ``Arch.fanouts[i]``.

Mapping invariants (checked by ``validate_structure``):
  * exactly one Storage node per (level, tensor) pair at most;
  * level 0 storage nodes come first and include every tensor (backing);
  * per-tensor storage nodes appear in increasing level order;
  * the product of bounds over all loops of a var equals the rank shape;
  * spatial bounds within a fanout dim multiply to <= the dim size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple, Union

from .arch import Arch
from .einsum import Einsum


@dataclass(frozen=True)
class Storage:
    level: int
    tensor: str

    def __repr__(self) -> str:
        return f"S(L{self.level}:{self.tensor})"


@dataclass(frozen=True)
class Loop:
    var: str
    bound: int
    spatial: bool = False
    fanout: int = -1
    dim: int = -1

    def __repr__(self) -> str:
        tag = f"sp{self.fanout}.{self.dim}" if self.spatial else "t"
        return f"L({self.var}={self.bound},{tag})"


Node = Union[Storage, Loop]
Mapping = Tuple[Node, ...]


def loops(mapping: Mapping) -> List[Loop]:
    return [n for n in mapping if isinstance(n, Loop)]


def storages(mapping: Mapping) -> List[Storage]:
    return [n for n in mapping if isinstance(n, Storage)]


def validate_structure(einsum: Einsum, arch: Arch, mapping: Mapping,
                       pinned: Optional[dict] = None) -> None:
    """Check the mapping invariants.

    ``pinned`` (fused-group members only) maps tensor names to a non-DRAM
    pin level: those tensors are *exempt* from level-0 backing — their
    outermost storage node must instead sit at exactly the pin level (the
    intermediate never exists at DRAM).
    """
    pinned = pinned or {}
    seen = set()
    last_level_per_tensor = {}
    names = {t.name for t in einsum.tensors}
    level0 = set()
    seen_nonzero = False
    for n in mapping:
        if isinstance(n, Storage):
            key = (n.level, n.tensor)
            assert key not in seen, f"duplicate storage node {key}"
            seen.add(key)
            assert n.tensor in names, f"unknown tensor {n.tensor}"
            lvl = arch.levels[n.level]
            if lvl.allowed_tensors is not None:
                assert n.tensor in lvl.allowed_tensors, (
                    f"{n.tensor} not allowed at {lvl.name}")
            prev = last_level_per_tensor.get(n.tensor)
            assert prev is None or n.level > prev, (
                f"{n.tensor} storage out of hierarchy order")
            last_level_per_tensor[n.tensor] = n.level
            if n.tensor in pinned:
                assert n.level >= pinned[n.tensor], (
                    f"pinned {n.tensor} must not exist above level "
                    f"{pinned[n.tensor]}")
                if prev is None:
                    assert n.level == pinned[n.tensor], (
                        f"pinned {n.tensor} outermost node must sit at "
                        f"level {pinned[n.tensor]}")
            if n.level == 0:
                assert not seen_nonzero, "backing store must come first"
                level0.add(n.tensor)
            else:
                seen_nonzero = True
    assert level0 == names - set(pinned), (
        f"backing store must hold all unpinned tensors, has {level0}")
    for t in pinned:
        assert t in last_level_per_tensor, f"pinned {t} has no storage node"

    # loop bound products
    prod: dict = {v: 1 for v in einsum.rank_shapes}
    fan_used: dict = {}
    for l in loops(mapping):
        assert l.bound >= 1
        prod[l.var] *= l.bound
        if l.spatial:
            key = (l.fanout, l.dim)
            fan_used[key] = fan_used.get(key, 1) * l.bound
    for v, p in prod.items():
        assert p == einsum.rank_shapes[v], (
            f"var {v}: loop bounds multiply to {p} != {einsum.rank_shapes[v]}")
    for (f, d), used in fan_used.items():
        assert used <= arch.fanouts[f].dims[d], (
            f"fanout {f} dim {d}: {used} > {arch.fanouts[f].dims[d]}")


def render(mapping: Mapping) -> str:
    """Human-readable LoopTree."""
    out = []
    depth = 0
    for n in mapping:
        if isinstance(n, Storage):
            out.append("  " * depth + f"[L{n.level} keep {n.tensor}]")
        else:
            tag = " (spatial)" if n.spatial else ""
            out.append("  " * depth + f"for {n.var} in 0..{n.bound}{tag}")
            depth += 1
    out.append("  " * depth + "compute")
    return "\n".join(out)
