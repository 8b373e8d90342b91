"""Fused-group joint mapping: workloads, skeletons and enumeration.

A :class:`FusedWorkload` is one cell of the fusion partition of an
``EinsumGraph`` (see ``core/einsum.py``), lowered to index-based form: the
member einsums in execution order plus :class:`GroupEdge` records naming
which producer output feeds which consumer input.  The joint mapping of a
fused workload is a :class:`FusedMapping` — one complete LoopTree per
member, structured as

    [member's level-0 backing nodes]          (unpinned tensors only)
    [shared co-tiled loop prefix]             (one loop per shared rank
                                               class, same bound in every
                                               member — the co-tiling)
    [pinned intermediate nodes at pin level]  (the intermediate's outermost
                                               storage: never DRAM)
    [member dataflow skeleton + tile loops]   (the member's own search space)

The members execute sequentially per prefix iteration: the producer fills
the pinned intermediate tile, the consumer drains it.  Because every member
keeps its pinned nodes directly below the *whole* prefix and all its own
loops below them, the pinned tile each member sees is

    prod over intermediate dims of  (dim shape / prefix bound of its class)

which is identical for producer and consumer by the edge correspondence —
the tile contract holds for every point of the joint mapspace, so the
per-member analytical model (``refmodel.analyze``) remains exact on fused
members: the intermediate's outermost node has no parent, hence **zero DRAM
traffic**, and its deeper tiles charge reads/writes at the pin level.

The joint mapspace of a group is
``pin level x (member dataplacement x member skeleton) per member`` —
structurally identical members (e.g. the up and gate matmuls of a gated
FFN) are tied to the same choice, which keeps the cross-product quadratic
rather than cubic for the common 3-member FFN group.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Dict, List, Optional, Tuple

from .arch import Arch
from .dataflow import enumerate_skeletons
from .dataplacement import enumerate_pinned_dataplacements
from .einsum import Einsum, EinsumGraph, FusionGroup, pin_levels_for
from .looptree import Loop, Mapping, Storage, validate_structure


@dataclass(frozen=True)
class GroupEdge:
    """Index-based intra-group tensor flow (cf. ``einsum.TensorEdge``)."""

    producer: int  # member index
    consumer: int
    tensor: str  # producer-side (output) tensor name
    consumer_tensor: str  # consumer-side (input) tensor name


@dataclass(frozen=True)
class FusedWorkload:
    """A fusion group's members plus the edges whose tensors stay on-chip."""

    name: str
    members: Tuple[Einsum, ...]
    edges: Tuple[GroupEdge, ...]

    def __post_init__(self):
        for e in self.edges:
            p, c = self.members[e.producer], self.members[e.consumer]
            out, inp = p.tensor(e.tensor), c.tensor(e.consumer_tensor)
            assert out.is_output and not inp.is_output
            assert len(out.dims) == len(inp.dims)
            for dp, dc in zip(out.dims, inp.dims):
                assert isinstance(dp, str) and isinstance(dc, str), (
                    "fused edges require plain (non-affine) dims")
                assert p.rank_shapes[dp] == c.rank_shapes[dc], (
                    f"extent mismatch on {e.tensor}: {dp} vs {dc}")


@dataclass(frozen=True)
class FusedSkeleton:
    """One joint work unit's structure: pin level + per-member skeletons.

    ``members[i]`` is member i's mapping *without* the shared loop prefix
    (backing nodes, pinned nodes, then the member's dataflow skeleton with
    placeholder bounds); ``n_backing[i]`` is the length of its backing
    region (level-0 + pinned nodes) — the prefix is inserted inside it,
    between the level-0 nodes and the pinned nodes, by the fused model.
    """

    pin_level: int
    members: Tuple[Mapping, ...]
    n_backing: Tuple[int, ...]
    n_level0: Tuple[int, ...]  # level-0 node count per member


@dataclass(frozen=True)
class FusedMapping:
    """A concrete joint mapping: one complete LoopTree per member."""

    members: Tuple[Mapping, ...]
    pin_level: int
    pinned: Tuple[Tuple[int, str], ...]  # (member index, tensor name)

    def member_pinned(self, i: int) -> Dict[str, int]:
        return {t: self.pin_level for j, t in self.pinned if j == i}


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def shared_classes(w: FusedWorkload) -> Tuple[Tuple[Tuple[int, str], ...], ...]:
    """Equivalence classes of (member, rank var) tied by the group's edges.

    Each class is co-tiled by one shared prefix loop.  Classes are ordered
    by first appearance (edge order, then dim position), members within a
    class by member index — deterministic, so skeletons and symbols are
    reproducible.
    """
    order: List[Tuple[int, str]] = []
    parent: Dict[Tuple[int, str], Tuple[int, str]] = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def add(x):
        if x not in parent:
            parent[x] = x
            order.append(x)

    for e in w.edges:
        out = w.members[e.producer].tensor(e.tensor)
        inp = w.members[e.consumer].tensor(e.consumer_tensor)
        for dp, dc in zip(out.dims, inp.dims):
            a, b = (e.producer, dp), (e.consumer, dc)
            add(a)
            add(b)
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    classes: Dict[Tuple[int, str], List[Tuple[int, str]]] = {}
    for x in order:
        classes.setdefault(find(x), []).append(x)
    out_classes = []
    for root in sorted(classes, key=order.index):
        cls = tuple(sorted(classes[root]))
        seen_members = [m for m, _ in cls]
        assert len(set(seen_members)) == len(seen_members), (
            f"class {cls} ties two vars of one member")
        out_classes.append(cls)
    return tuple(out_classes)


def pinned_roles(w: FusedWorkload) -> Tuple[Tuple[str, ...], ...]:
    """Per member, the tensor names pinned on-chip (sorted, deduped)."""
    roles: List[set] = [set() for _ in w.members]
    for e in w.edges:
        roles[e.producer].add(e.tensor)
        roles[e.consumer].add(e.consumer_tensor)
    return tuple(tuple(sorted(r)) for r in roles)


def pin_levels(w: FusedWorkload, arch: Arch) -> List[int]:
    """Non-DRAM levels where every pinned tensor of the group may live
    (the per-edge rule of ``EinsumGraph.edge_fusable``, applied over the
    whole group's pinned tensor names)."""
    names = [t for role in pinned_roles(w) for t in role]
    return pin_levels_for(arch, names)


def member_prefix_vars(w: FusedWorkload) -> Tuple[Tuple[Optional[str], ...], ...]:
    """``[member][class] -> var name`` (None when the member is not tied)."""
    classes = shared_classes(w)
    out = []
    for i in range(len(w.members)):
        row = []
        for cls in classes:
            row.append(next((v for m, v in cls if m == i), None))
        out.append(tuple(row))
    return tuple(out)


# ---------------------------------------------------------------------------
# Structural keys (search-layer memoization / cache addressing)
# ---------------------------------------------------------------------------


def _member_key(e: Einsum):
    # same structural identity as search.einsum_key (name ignored); local
    # copy to keep fusion import-free of the executor layer
    return (e.tensors, tuple(sorted(e.rank_shapes.items())))


def workload_key(w: FusedWorkload):
    """Structural cache key: member structures + edge wiring, names ignored."""
    return (tuple(_member_key(m) for m in w.members), w.edges)


def workload_from_key(key) -> FusedWorkload:
    member_keys, edges = key
    members = tuple(
        Einsum(name=f"<m{i}>", tensors=k[0], rank_shapes=dict(k[1]))
        for i, k in enumerate(member_keys))
    return FusedWorkload(name="<cached>", members=members, edges=edges)


def from_group(graph: EinsumGraph, group: FusionGroup,
               name: Optional[str] = None) -> FusedWorkload:
    """Lower a graph-level FusionGroup to the index-based joint workload."""
    idx = {n: i for i, n in enumerate(group.members)}
    edges = tuple(GroupEdge(idx[e.producer], idx[e.consumer],
                            e.tensor, e.consumer_tensor)
                  for e in group.edges)
    return FusedWorkload(
        name=name or "+".join(group.members),
        members=tuple(graph.node(n) for n in group.members),
        edges=edges)


# ---------------------------------------------------------------------------
# Joint enumeration
# ---------------------------------------------------------------------------


def enumerate_fused_skeletons(w: FusedWorkload, arch: Arch,
                              max_units: Optional[int] = 4096,
                              ) -> List[FusedSkeleton]:
    """The joint (pin level x member dataplacement x member skeleton) space.

    Structurally identical members with identical pinned roles are tied to
    one shared choice (symmetry reduction).  Returns an empty list when the
    group admits no pin level, any member admits no pinned sub-mapping, or
    the joint space exceeds ``max_units`` (callers fall back to independent
    mapping — the planner reports the fallback, nothing is silently capped).
    """
    roles = pinned_roles(w)
    # tying two members is only sound when they are interchangeable under
    # the co-tiling classes: shared loop sites divide every tied member's
    # chains identically, so each rank var must land in the same class for
    # all tied members (the member_prefix_vars row).  Parallel twins (FFN
    # up/gate) satisfy this; sequential middle members of a cascade do
    # not — their n/k chains shift one class per hop, and tying them
    # produces mappings whose loop bounds underrun the rank shape.
    pvars = member_prefix_vars(w)
    identity = [(_member_key(m), roles[i], pvars[i])
                for i, m in enumerate(w.members)]
    rep_of: Dict[tuple, int] = {}
    group_idx: List[int] = []  # member -> index into the tied choice vector
    for ident in identity:
        group_idx.append(rep_of.setdefault(ident, len(rep_of)))
    n_choices = len(rep_of)

    out: List[FusedSkeleton] = []
    for pin in pin_levels(w, arch):
        # one unit list per identity class; tied members share the *same*
        # skeleton objects, which is what ties their loop sites (and hence
        # their explored bounds) together in the fused model
        class_units: List[Optional[list]] = [None] * n_choices
        for i, m in enumerate(w.members):
            g = group_idx[i]
            if class_units[g] is not None:
                continue
            pinned = {t: pin for t in roles[i]}
            units = []
            for dp, nb in enumerate_pinned_dataplacements(m, arch, pinned):
                n_l0 = sum(1 for s in dp[:nb] if s.level == 0)
                for sk in enumerate_skeletons(m, arch, dp, n_backing=nb):
                    units.append((sk, nb, n_l0))
            class_units[g] = units
        if any(not u for u in class_units):
            continue
        for combo in product(*(range(len(u)) for u in class_units)):
            skels, nbs, nl0s = [], [], []
            for i in range(len(w.members)):
                sk, nb, n_l0 = class_units[group_idx[i]][combo[group_idx[i]]]
                skels.append(sk)
                nbs.append(nb)
                nl0s.append(n_l0)
            out.append(FusedSkeleton(pin, tuple(skels), tuple(nbs),
                                     tuple(nl0s)))
            if max_units is not None and len(out) > max_units:
                return []
    return out


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def validate_fused(w: FusedWorkload, arch: Arch, fm: FusedMapping) -> None:
    """Joint-mapping invariants: per-member structure + co-tiling contract."""
    classes = shared_classes(w)
    pvars = member_prefix_vars(w)
    prefix_bounds: Dict[int, int] = {}
    for i, mapping in enumerate(fm.members):
        validate_structure(w.members[i], arch, mapping,
                           pinned=fm.member_pinned(i))
        # the loops above the member's first pinned node are exactly its
        # shared-prefix loops, in class order
        first_pin = next(
            (j for j, n in enumerate(mapping)
             if isinstance(n, Storage) and (i, n.tensor) in fm.pinned),
            len(mapping))
        prefix = [n for n in mapping[:first_pin] if isinstance(n, Loop)]
        expect = [(j, v) for j, v in enumerate(pvars[i]) if v is not None]
        assert len(prefix) == len(expect), (
            f"member {i}: {len(prefix)} prefix loops, expected {len(expect)}")
        for loop, (j, v) in zip(prefix, expect):
            assert loop.var == v and not loop.spatial
            if j in prefix_bounds:
                assert prefix_bounds[j] == loop.bound, (
                    f"class {classes[j]} co-tiled inconsistently")
            else:
                prefix_bounds[j] = loop.bound
