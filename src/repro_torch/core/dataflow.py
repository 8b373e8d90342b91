"""Dataflow generation with pruning (paper §IV-A, §IV-B, §V-B).

Given a dataplacement, loops may be inserted in the *slots* between adjacent
storage nodes (and below the last storage node, above compute).  We apply:

  * **Non-helpful-loop pruning (Table I)** — a loop over rank var ``v`` is
    admitted to a slot iff ``v`` is relevant to the tensor stored immediately
    below the slot (else it refetches the same tile) and irrelevant to the
    tensor immediately above (else it inflates that tile with no reuse).
    Below the last storage node the below-check is omitted; directly under a
    level-0 (backing) node the above-check is omitted.

  * **Redundant-dataflow pruning** — loop order within a slot does not change
    tile shapes or traffic, so a single canonical order is used.  The
    exception is *partially relevant* rank vars (affine indices like conv's
    ``p+r``): the loop directly under a storage node enables a line buffer and
    the loop directly above a (deeper) storage node enables halo reuse, so the
    few choices of which partially-relevant var sits at the slot's boundary
    are enumerated.

  * **Spatial loops** — each arch fanout dim admits loops for vars compatible
    with its multicast/reduce constraint, placed canonically at the level
    boundary; their bounds join the tile-shape search.

A *skeleton* is a Mapping whose loop bounds are placeholders (bound=1) to be
filled in by tile-shape exploration.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import factorial
from typing import Iterator, List, Optional, Sequence, Tuple

from .arch import Arch
from .dataplacement import Dataplacement
from .einsum import Einsum
from .looptree import Loop, Mapping, Storage


@dataclass(frozen=True)
class Slot:
    """A gap between storage nodes where temporal loops may live."""

    above: Storage  # node immediately above
    below: Optional[Storage]  # node immediately below (None = compute)
    above_is_backing: bool
    allowed: Tuple[str, ...]  # admitted rank vars (canonical order)
    # choices of var placed first (directly under `above`; line buffer) and
    # last (directly above `below`; halo).  None = no special placement.
    first_choices: Tuple[Optional[str], ...]
    last_choices: Tuple[Optional[str], ...]


def _admitted(einsum: Einsum, above: Storage, below: Optional[Storage],
              above_is_backing: bool) -> List[str]:
    out = []
    above_t = einsum.tensor(above.tensor)
    below_t = einsum.tensor(below.tensor) if below is not None else None
    for v in einsum.rank_vars:
        if below_t is not None and not below_t.relevant(v):
            continue  # would refetch the same tile of the tensor below
        if not above_is_backing and above_t.relevant(v):
            # would inflate the above tile with no reuse — EXCEPT partially
            # relevant vars, which can line-buffer when directly under the
            # node; those are admitted and handled via first_choices.
            if not above_t.partially_relevant(v):
                continue
        out.append(v)
    return out


def make_slots(einsum: Einsum, arch: Arch, dp: Dataplacement,
               n_backing: Optional[int] = None) -> List[Slot]:
    nodes = list(dp)
    # Slots only start after the last backing node (no loops between backing
    # nodes: nothing above to refetch from).  By default the backing region
    # is the level-0 prefix; fused-group members pass ``n_backing`` to extend
    # it over their pinned-intermediate nodes, which sit directly below the
    # shared co-tiled loop prefix and behave like a backing store for the
    # member's own loops (their tile is fixed by the prefix, so loops below
    # cannot inflate it).
    if n_backing is None:
        last_backing = max(i for i, s in enumerate(nodes) if s.level == 0)
    else:
        last_backing = n_backing - 1
    slots: List[Slot] = []
    for i in range(last_backing, len(nodes)):
        above = nodes[i]
        below = nodes[i + 1] if i + 1 < len(nodes) else None
        # only the slot directly under the backing region counts as
        # backed-above (identical to the historical ``above.level == 0``
        # check when the backing region is the level-0 prefix)
        above_is_backing = i == last_backing
        allowed = _admitted(einsum, above, below, above_is_backing)
        above_t = einsum.tensor(above.tensor)
        below_t = einsum.tensor(below.tensor) if below is not None else None
        first: List[Optional[str]] = [None]
        if not above_is_backing:
            for v in allowed:
                if above_t.partially_relevant(v):
                    first.append(v)
            # partially-relevant vars w.r.t. the above tensor are ONLY useful
            # directly under it; if not chosen as first, drop them.
        last: List[Optional[str]] = [None]
        if below_t is not None:
            for v in allowed:
                if below_t.partially_relevant(v):
                    last.append(v)
        slots.append(Slot(
            above=above, below=below, above_is_backing=above_is_backing,
            allowed=tuple(allowed), first_choices=tuple(first),
            last_choices=tuple(last)))
    return slots


def _spatial_block(einsum: Einsum, arch: Arch, fanout_idx: int) -> List[Loop]:
    """Spatial loops for one fanout, canonical order (bounds placeholder)."""
    fan = arch.fanouts[fanout_idx]
    out: List[Loop] = []
    for d in range(len(fan.dims)):
        mc = fan.multicast_tensor[d]
        rd = fan.reduce_tensor[d]
        for v in einsum.rank_vars:
            ok = True
            if mc is not None and einsum.tensor(mc).relevant(v):
                ok = False  # multicast dim requires vars irrelevant to mc
            if rd is not None and v not in einsum.contraction_vars:
                ok = False  # reduction dim requires contraction vars
            if mc is None and rd is None:
                ok = True  # unconstrained
            if ok:
                out.append(Loop(v, 1, spatial=True, fanout=fanout_idx, dim=d))
    return out


def enumerate_skeletons(einsum: Einsum, arch: Arch, dp: Dataplacement,
                        n_backing: Optional[int] = None) -> Iterator[Mapping]:
    """All non-redundant dataflow skeletons for a dataplacement.

    ``n_backing`` extends the backing region beyond the level-0 prefix (see
    :func:`make_slots`); fused-group members use it so no member loops are
    generated above their pinned-intermediate nodes.
    """
    slots = make_slots(einsum, arch, dp, n_backing)
    nodes = list(dp)
    if n_backing is None:
        last_backing = max(i for i, s in enumerate(nodes) if s.level == 0)
    else:
        last_backing = n_backing - 1

    # spatial blocks sit at the boundary above the first storage node of a
    # level deeper than fanout.above_level (or above compute if none).
    spatial_at: dict = {}
    for fi, fan in enumerate(arch.fanouts):
        pos = len(nodes)  # default: above compute
        for i, s in enumerate(nodes):
            if s.level > fan.above_level:
                pos = i
                break
        spatial_at.setdefault(pos, []).extend(_spatial_block(einsum, arch, fi))

    def slot_orders(slot: Slot) -> Iterator[Tuple[Loop, ...]]:
        for first in slot.first_choices:
            for last in slot.last_choices:
                if first is not None and first == last and len(slot.allowed) > 1:
                    continue
                mid = [v for v in slot.allowed if v not in (first, last)]
                # drop partially-relevant-to-above vars not chosen as first
                above_t = einsum.tensor(slot.above.tensor)
                if not slot.above_is_backing:
                    mid = [v for v in mid if not above_t.partially_relevant(v)]
                order: List[str] = []
                if first is not None:
                    order.append(first)
                order.extend(sorted(mid))
                if last is not None and last != first:
                    order.append(last)
                if not order and (first is None and last is None):
                    yield ()
                else:
                    yield tuple(Loop(v, 1) for v in order)

    def rec(si: int, acc: List[Tuple[Loop, ...]]) -> Iterator[Mapping]:
        if si == len(slots):
            # assemble: backing nodes, then per-slot loops + storage nodes
            m: List = list(nodes[:last_backing + 1])
            for k, slot_loops in enumerate(acc):
                node_idx = last_backing + k + 1
                # spatial block at this node boundary goes at slot bottom
                m.extend(slot_loops)
                if node_idx in spatial_at:
                    m.extend(spatial_at[node_idx])
                if node_idx < len(nodes):
                    m.append(nodes[node_idx])
            yield tuple(m)
            return
        for order in slot_orders(slots[si]):
            yield from rec(si + 1, acc + [order])

    yield from rec(0, [])


def count_unpruned_dataflows(einsum: Einsum, arch: Arch,
                             dp: Dataplacement) -> float:
    """|DF| without pruning: all orders of loops over every rank var in every
    slot (the space prior mappers explore for a fixed storage-node layout)."""
    slots = make_slots(einsum, arch, dp)
    r = len(einsum.rank_vars)
    return float(factorial(r)) ** len(slots)
