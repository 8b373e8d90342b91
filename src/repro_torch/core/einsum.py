"""Einsum workload IR and the workload-graph IR layered on top of it.

An Einsum names a set of *rank variables* with integer shapes, and a set of
tensors.  Each tensor dim is either a single rank var (fully relevant) or an
affine pair ``(p, r)`` meaning index ``p + r`` (both vars *partially
relevant*, e.g. convolution sliding windows).

An :class:`EinsumGraph` is a DAG of Einsum nodes connected by
:class:`TensorEdge` records (one per producer-output -> consumer-input
tensor flow).  :meth:`EinsumGraph.partition_fusion_groups` partitions the
graph into :class:`FusionGroup`\\ s — maximal sets of nodes whose connecting
edges are *fusable*, meaning the intermediate tensor can legally stay
pinned in an on-chip memory level while producer and consumer are co-tiled
over their shared rank vars (see ``core/fusion.py`` for the joint mapping
machinery built on these groups).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce
from typing import Dict, List, Mapping, Sequence, Tuple, Union

Dim = Union[str, Tuple[str, str]]


@dataclass(frozen=True)
class TensorSpec:
    name: str
    dims: Tuple[Dim, ...]
    is_output: bool = False
    word_bits: int = 16  # element width; energies/capacities scale by words

    def rank_vars(self) -> frozenset:
        out = set()
        for d in self.dims:
            if isinstance(d, tuple):
                out.update(d)
            else:
                out.add(d)
        return frozenset(out)

    def relevant(self, var: str) -> bool:
        """Does ``var`` index into this tensor (fully or partially)?"""
        return var in self.rank_vars()

    def partially_relevant(self, var: str) -> bool:
        return any(isinstance(d, tuple) and var in d for d in self.dims)


@dataclass(frozen=True)
class Einsum:
    name: str
    tensors: Tuple[TensorSpec, ...]
    rank_shapes: Mapping[str, int]  # rank var -> exclusive upper bound

    def __post_init__(self):
        outs = [t for t in self.tensors if t.is_output]
        assert len(outs) == 1, "exactly one output tensor"
        for t in self.tensors:
            for v in t.rank_vars():
                assert v in self.rank_shapes, f"unknown rank var {v}"

    @property
    def output(self) -> TensorSpec:
        return next(t for t in self.tensors if t.is_output)

    @property
    def inputs(self) -> Tuple[TensorSpec, ...]:
        return tuple(t for t in self.tensors if not t.is_output)

    def tensor(self, name: str) -> TensorSpec:
        return next(t for t in self.tensors if t.name == name)

    @property
    def rank_vars(self) -> Tuple[str, ...]:
        return tuple(sorted(self.rank_shapes))

    @property
    def contraction_vars(self) -> frozenset:
        """Rank vars not indexing the output (summed over)."""
        return frozenset(self.rank_shapes) - self.output.rank_vars()

    @property
    def total_computes(self) -> int:
        # One MAC per point in the full iteration space.
        return reduce(lambda a, b: a * b, self.rank_shapes.values(), 1)

    def tensor_size(self, t: TensorSpec) -> int:
        size = 1
        for d in t.dims:
            if isinstance(d, tuple):
                p, r = d
                size *= self.rank_shapes[p] + self.rank_shapes[r] - 1
            else:
                size *= self.rank_shapes[d]
        return size


# -- serialization -----------------------------------------------------------


def einsum_to_dict(einsum: Einsum) -> dict:
    """Strict-JSON canonical form (the ``arch_to_dict`` analogue).

    Affine dims ``(p, r)`` are encoded as two-element lists; plain dims as
    strings.  ``einsum_from_dict`` is the exact inverse, so fuzzed
    soundness-violation repro cases (``repro.gap.soundness``) round-trip
    workloads bit-exactly through JSON.
    """
    return {
        "name": einsum.name,
        "rank_shapes": {v: int(s) for v, s in
                        sorted(einsum.rank_shapes.items())},
        "tensors": [
            {
                "name": t.name,
                "dims": [list(d) if isinstance(d, tuple) else d
                         for d in t.dims],
                "is_output": t.is_output,
                "word_bits": t.word_bits,
            }
            for t in einsum.tensors
        ],
    }


def einsum_from_dict(d: dict) -> Einsum:
    """Inverse of :func:`einsum_to_dict`; tolerant of key order."""
    tensors = tuple(
        TensorSpec(
            name=t["name"],
            dims=tuple(tuple(x) if isinstance(x, list) else x
                       for x in t["dims"]),
            is_output=bool(t.get("is_output", False)),
            word_bits=int(t.get("word_bits", 16)),
        )
        for t in d["tensors"]
    )
    return Einsum(name=d["name"], tensors=tensors,
                  rank_shapes={v: int(s)
                               for v, s in d["rank_shapes"].items()})


# -- workload graph ----------------------------------------------------------


def pin_levels_for(arch, tensor_names: Sequence[str]) -> List[int]:
    """Non-DRAM levels that can host pinned intermediates named
    ``tensor_names``: the level must admit every name
    (``allowed_tensors``) and sit at or above every spatial fanout boundary
    (the pinned tile is shared by all instances).  Single source of the pin
    legality rule — ``EinsumGraph.edge_fusable`` applies it per edge,
    ``core/fusion.pin_levels`` over a whole group's pinned set."""
    out = []
    for m in range(1, len(arch.levels)):
        lvl = arch.levels[m]
        if any(f.above_level < m for f in arch.fanouts):
            continue
        if lvl.allowed_tensors is not None and any(
                t not in lvl.allowed_tensors for t in tensor_names):
            continue
        out.append(m)
    return out


@dataclass(frozen=True)
class TensorEdge:
    """One producer-output -> consumer-input tensor flow in an EinsumGraph.

    ``tensor`` is the producer-side (output) tensor name, ``consumer_tensor``
    the consumer-side (input) tensor name — they are the *same* data, named
    per each einsum's local tensor namespace.  ``fusable`` is the extractor's
    semantic veto (False for flows through token routing, head reshapes,
    recurrences or stage-cached state, which the cost-model einsums cannot
    co-tile); structural legality is checked on top by
    :meth:`EinsumGraph.edge_fusable`.
    """

    producer: str  # producer einsum name
    consumer: str  # consumer einsum name
    tensor: str  # tensor name on the producer side (its output)
    consumer_tensor: str  # tensor name on the consumer side (an input)
    fusable: bool = True
    reason: str = ""  # why not fusable (when fusable is False)


@dataclass(frozen=True)
class FusionGroup:
    """One cell of the fusion partition: member einsum names (execution
    order) plus the intra-group edges whose intermediates stay on-chip.
    Singleton groups have no edges and map independently."""

    members: Tuple[str, ...]
    edges: Tuple[TensorEdge, ...] = ()

    @property
    def is_fused(self) -> bool:
        return len(self.members) > 1


class EinsumGraph:
    """A DAG of Einsum nodes with producer->consumer tensor edges.

    Nodes are keyed by ``Einsum.name`` (must be unique).  Node order is
    execution order; partitions preserve it.
    """

    def __init__(self, nodes: Sequence[Einsum],
                 edges: Sequence[TensorEdge] = ()):
        self.nodes: Tuple[Einsum, ...] = tuple(nodes)
        self._by_name: Dict[str, Einsum] = {}
        self._pos: Dict[str, int] = {}
        for i, n in enumerate(self.nodes):
            assert n.name not in self._by_name, f"duplicate node {n.name}"
            self._by_name[n.name] = n
            self._pos[n.name] = i
        for e in edges:
            p, c = self._by_name[e.producer], self._by_name[e.consumer]
            assert self._pos[e.producer] < self._pos[e.consumer], (
                f"edge {e.producer}->{e.consumer} against execution order")
            assert p.tensor(e.tensor).is_output, (
                f"{e.tensor} is not {e.producer}'s output")
            assert not c.tensor(e.consumer_tensor).is_output, (
                f"{e.consumer_tensor} is not an input of {e.consumer}")
        self.edges: Tuple[TensorEdge, ...] = tuple(edges)

    def node(self, name: str) -> Einsum:
        return self._by_name[name]

    def __len__(self) -> int:
        return len(self.nodes)

    def consumers_of(self, name: str) -> List[TensorEdge]:
        return [e for e in self.edges if e.producer == name]

    def producers_of(self, name: str) -> List[TensorEdge]:
        return [e for e in self.edges if e.consumer == name]

    # -- fusion legality ---------------------------------------------------

    def edge_fusable(self, edge: TensorEdge, arch=None) -> bool:
        """Can ``edge``'s intermediate legally stay pinned on-chip?

        Checks, in order: the extractor's semantic veto; *single consumer
        edge* (a multiply-consumed intermediate would need its full extent
        live); positional rank-var correspondence (same arity, plain vars,
        equal extents — affine/windowed dims cannot be co-tiled); and, when
        ``arch`` is given, that the intermediate's minimal co-tile (shared
        vars tiled to 1, member-local dims at full extent) fits some
        non-DRAM level that admits both the producer- and consumer-side
        tensor names and sits at or above every spatial fanout boundary.
        """
        if not edge.fusable:
            return False
        if len(self.consumers_of(edge.producer)) != 1:
            return False
        prod = self._by_name[edge.producer]
        cons = self._by_name[edge.consumer]
        out, inp = prod.tensor(edge.tensor), cons.tensor(edge.consumer_tensor)
        if len(out.dims) != len(inp.dims):
            return False
        for dp, dc in zip(out.dims, inp.dims):
            if isinstance(dp, tuple) or isinstance(dc, tuple):
                return False  # affine dims: no positional co-tiling
            if prod.rank_shapes[dp] != cons.rank_shapes[dc]:
                return False
        if arch is not None and not self._pin_levels(edge, arch):
            return False
        return True

    def _pin_levels(self, edge: TensorEdge, arch) -> List[int]:
        """Non-DRAM levels where the edge's intermediate may be pinned.

        Every dim of the intermediate belongs to a shared (co-tiled) rank
        class — the edge correspondence is positional and complete — so the
        minimal pinned co-tile is a single element and always fits; what
        disqualifies a level is tensor-name admission or a spatial fanout
        boundary above it (see :func:`pin_levels_for`, the single source of
        the rule shared with ``core/fusion.pin_levels``).
        """
        return pin_levels_for(arch, (edge.tensor, edge.consumer_tensor))

    def fusable_edges(self, arch=None) -> List[TensorEdge]:
        return [e for e in self.edges if self.edge_fusable(e, arch)]

    # -- partition ---------------------------------------------------------

    def partition_fusion_groups(self, arch=None,
                                max_group: int = 4) -> List[FusionGroup]:
        """Partition nodes into fusion groups along fusable edges.

        Greedy in execution order: an edge joins two groups when the merged
        group stays within ``max_group`` members.  Returns groups ordered by
        their first member's execution position; non-fused nodes come back
        as singleton groups, so the partition always covers every node.
        """
        parent: Dict[str, str] = {n.name: n.name for n in self.nodes}

        def find(x: str) -> str:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        members: Dict[str, List[str]] = {n.name: [n.name] for n in self.nodes}
        kept_edges: List[TensorEdge] = []
        for e in self.edges:
            if not self.edge_fusable(e, arch):
                continue
            a, b = find(e.producer), find(e.consumer)
            if a == b:
                kept_edges.append(e)
                continue
            if len(members[a]) + len(members[b]) > max_group:
                continue
            parent[b] = a
            members[a].extend(members.pop(b))
            kept_edges.append(e)

        groups: List[FusionGroup] = []
        for root, names in members.items():
            ordered = tuple(sorted(names, key=self._pos.__getitem__))
            edges = tuple(e for e in kept_edges if find(e.producer) == root)
            groups.append(FusionGroup(members=ordered, edges=edges))
        groups.sort(key=lambda g: self._pos[g.members[0]])
        return groups


# -- convenience constructors ------------------------------------------------

def matmul(name: str, M: int, K: int, N: int) -> Einsum:
    """Z[m,n] = A[m,k] * B[k,n]."""
    return Einsum(
        name=name,
        tensors=(
            TensorSpec("A", ("m", "k")),
            TensorSpec("B", ("k", "n")),
            TensorSpec("Z", ("m", "n"), is_output=True),
        ),
        rank_shapes={"m": M, "k": K, "n": N},
    )


def batched_matmul(name: str, H: int, M: int, K: int, N: int) -> Einsum:
    """Z[h,m,n] = A[h,m,k] * B[h,k,n] (multi-head attention style)."""
    return Einsum(
        name=name,
        tensors=(
            TensorSpec("A", ("h", "m", "k")),
            TensorSpec("B", ("h", "k", "n")),
            TensorSpec("Z", ("h", "m", "n"), is_output=True),
        ),
        rank_shapes={"h": H, "m": M, "k": K, "n": N},
    )


def conv1d(name: str, P: int, R: int, C: int, Kc: int, Nb: int = 1) -> Einsum:
    """Z[n,kc,p] = A[n,c,p+r] * W[kc,c,r]  (pointwise if R == 1)."""
    return Einsum(
        name=name,
        tensors=(
            TensorSpec("A", ("n", "c", ("p", "r"))),
            TensorSpec("W", ("kc", "c", "r")),
            TensorSpec("Z", ("n", "kc", "p"), is_output=True),
        ),
        rank_shapes={"n": Nb, "c": C, "kc": Kc, "p": P, "r": R},
    )


def depthwise_conv1d(name: str, P: int, R: int, C: int, Nb: int = 1) -> Einsum:
    """Z[n,c,p] = A[n,c,p+r] * W[c,r]  (depthwise: channel shared)."""
    return Einsum(
        name=name,
        tensors=(
            TensorSpec("A", ("n", "c", ("p", "r"))),
            TensorSpec("W", ("c", "r")),
            TensorSpec("Z", ("n", "c", "p"), is_output=True),
        ),
        rank_shapes={"n": Nb, "c": C, "p": P, "r": R},
    )
