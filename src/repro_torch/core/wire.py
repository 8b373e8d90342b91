"""JSON-safe wire encodings of the core mapping dataclasses.

Home of the node-by-node (de)serializers historically defined in
``repro.netmap.cache`` — hoisted into core so the resilience layer
(``core.journal``: search checkpoints and quarantine repros) can use them
without a core -> netmap import cycle.  ``netmap.cache`` re-exports every
name, so existing imports keep working; the wire format itself is
unchanged (cache records round-trip across the move).

Floats ride JSON's shortest-repr encoding, which round-trips Python floats
bit-exactly; mappings are encoded node-by-node (``["S", level, tensor]`` /
``["L", var, bound, spatial, fanout, dim]``).
"""
from __future__ import annotations

from typing import Any, Dict, Union

from .fusion import FusedMapping, FusedSkeleton, FusedWorkload, GroupEdge
from .looptree import Loop, Mapping, Storage


def mapping_to_wire(mapping: Mapping) -> list:
    out = []
    for n in mapping:
        if isinstance(n, Storage):
            out.append(["S", n.level, n.tensor])
        else:
            out.append(["L", n.var, n.bound, int(n.spatial), n.fanout, n.dim])
    return out


def mapping_from_wire(wire: list) -> Mapping:
    nodes = []
    for rec in wire:
        if rec[0] == "S":
            nodes.append(Storage(int(rec[1]), rec[2]))
        elif rec[0] == "L":
            nodes.append(Loop(rec[1], int(rec[2]), bool(rec[3]),
                              int(rec[4]), int(rec[5])))
        else:
            raise ValueError(f"unknown mapping node tag {rec[0]!r}")
    return tuple(nodes)


def fused_mapping_to_wire(fm: FusedMapping) -> dict:
    return {
        "members": [mapping_to_wire(m) for m in fm.members],
        "pin_level": fm.pin_level,
        "pinned": [[i, t] for i, t in fm.pinned],
    }


def fused_mapping_from_wire(wire: dict) -> FusedMapping:
    return FusedMapping(
        members=tuple(mapping_from_wire(m) for m in wire["members"]),
        pin_level=int(wire["pin_level"]),
        pinned=tuple((int(i), t) for i, t in wire["pinned"]),
    )


def result_to_wire(result) -> dict:
    if isinstance(result.mapping, FusedMapping):
        mapping: Any = {"fused": fused_mapping_to_wire(result.mapping)}
    else:
        mapping = mapping_to_wire(result.mapping)
    return {
        "mapping": mapping,
        "energy": result.energy,
        "latency": result.latency,
        "edp": result.edp,
    }


def result_from_wire(wire: dict):
    from .search import MappingResult  # deferred: search imports this module
    raw = wire["mapping"]
    if isinstance(raw, dict):
        mapping: Any = fused_mapping_from_wire(raw["fused"])
    else:
        mapping = mapping_from_wire(raw)
    return MappingResult(
        mapping=mapping,
        energy=wire["energy"],
        latency=wire["latency"],
        edp=wire["edp"],
    )


# stats ride the canonical MapperStats serialization (to_dict /
# stats_from_dict), shared with benchmark --json payloads and dse reports;
# these aliases keep the wire-format vocabulary of this module uniform
def stats_to_wire(stats) -> dict:
    return stats.to_dict()


def stats_from_wire(wire: dict):
    from .search import stats_from_dict
    return stats_from_dict(wire)


# --------------------------------------------------------------------------
# Skeletons and workloads (quarantine repros / checkpoint keys)
# --------------------------------------------------------------------------


def skeleton_to_wire(sk: Union[Mapping, FusedSkeleton]) -> Union[list, dict]:
    """Encode a work unit's skeleton — a plain dataflow skeleton (a Mapping
    with placeholder bounds) or a fused pin-level skeleton."""
    if isinstance(sk, FusedSkeleton):
        return {"fused": {
            "pin_level": sk.pin_level,
            "members": [mapping_to_wire(m) for m in sk.members],
            "n_backing": list(sk.n_backing),
            "n_level0": list(sk.n_level0),
        }}
    return mapping_to_wire(sk)


def skeleton_from_wire(wire: Union[list, dict]) -> Union[Mapping,
                                                         FusedSkeleton]:
    if isinstance(wire, dict):
        f = wire["fused"]
        return FusedSkeleton(
            pin_level=int(f["pin_level"]),
            members=tuple(mapping_from_wire(m) for m in f["members"]),
            n_backing=tuple(int(n) for n in f["n_backing"]),
            n_level0=tuple(int(n) for n in f["n_level0"]),
        )
    return mapping_from_wire(wire)


def workload_to_wire(w: FusedWorkload) -> dict:
    from .einsum import einsum_to_dict
    return {
        "name": w.name,
        "members": [einsum_to_dict(m) for m in w.members],
        "edges": [[e.producer, e.consumer, e.tensor, e.consumer_tensor]
                  for e in w.edges],
    }


def workload_from_wire(wire: dict) -> FusedWorkload:
    from .einsum import einsum_from_dict
    return FusedWorkload(
        name=wire.get("name", "<repro>"),
        members=tuple(einsum_from_dict(m) for m in wire["members"]),
        edges=tuple(GroupEdge(int(p), int(c), t, ct)
                    for p, c, t, ct in wire["edges"]),
    )
