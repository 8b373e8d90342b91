"""The analytical performance model (paper Eq. 4-6 + named extensions).

``analyze`` performs the *structural* analysis of a mapping — which loops sit
above/below which storage nodes, multicast/reduction discounts, halo and
line-buffer effects — generically over an arithmetic domain.  With numeric
loop bounds it is the reference model; with symbolic bounds (``Poly`` per
loop) it produces the curried tile-shape-only model of paper §V-C.

Model semantics (documented in DESIGN.md):
  * TileSize(s)       = prod of extents from loops below s (affine dims use
                        the sliding-window extent P+R-1; a partially-relevant
                        loop directly below s is excluded: line buffer).
  * TilesFetched(s)   = prod of loop bounds above s.  Halo: when the loop
                        directly above s is partially relevant, overlapped
                        window elements are fetched once.
  * Traffic s<->parent charges reads at the parent + writes at s for inputs;
    reversed for outputs.  Spatial loops between s and its parent discount
    parent-side traffic on multicast (inputs) / reduction (outputs) dims.
    Temporal contraction loops above an output node cause partial-sum
    revisits (write up + read back).
  * Compute operands are read from each tensor's innermost storage node once
    per MAC, discounted by multicast/reduction spatial dims below that node;
    output accumulation is a read+write per MAC at the innermost output node.
  * Usage(m) = sum of TileSize over nodes at m (per instance), must fit.
  * Latency = max over levels of accesses/(bw * instances), and compute
    MACs/(utilized units * frequency).  Energy = sum of access energies + MACs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .arch import Arch
from .einsum import Einsum, TensorSpec
from .looptree import Loop, Mapping, Storage


@dataclass
class NodeStats:
    """Traffic attributed to one storage node, in the arithmetic domain."""

    storage: Storage
    tile_size: object = 1  # per-instance usage contribution
    reads: object = 0  # at this node
    writes: object = 0  # at this node
    parent_reads: object = 0  # attributed at parent's level
    parent_writes: object = 0
    parent_level: Optional[int] = None


@dataclass
class ModelStats:
    node_stats: List[NodeStats]
    computes: object
    utilized_units: object
    level_reads: Dict[int, object]
    level_writes: Dict[int, object]
    level_usage: Dict[int, object]
    level_instances: Dict[int, object]


def _extent(
    einsum: Einsum,
    tensor: TensorSpec,
    below: Sequence[Loop],
    bound_of: Callable[[Loop], object],
    exclude: Optional[Loop] = None,
):
    """Tile volume of ``tensor`` given the loops below its storage node.

    Returns (volume, per_pair_extents) where per_pair_extents maps an affine
    dim index to its (P_below, R_below) factor products (needed for halo).
    """
    var_prod: Dict[str, object] = {}
    for l in below:
        if l is exclude:
            continue
        var_prod[l.var] = var_prod.get(l.var, 1) * bound_of(l)
    vol = 1
    for d in tensor.dims:
        if isinstance(d, tuple):
            p, r = d
            pe = var_prod.get(p, 1)
            re = var_prod.get(r, 1)
            vol = vol * (pe + re - 1)
        else:
            vol = vol * var_prod.get(d, 1)
    return vol


def analyze(
    einsum: Einsum,
    arch: Arch,
    mapping: Mapping,
    bound_of: Callable[[Loop], object] = lambda l: l.bound,
) -> ModelStats:
    nodes = list(mapping)
    contraction = einsum.contraction_vars

    # Positions of storage nodes and loops.
    storage_pos: List[Tuple[int, Storage]] = [
        (i, n) for i, n in enumerate(nodes) if isinstance(n, Storage)
    ]
    loop_pos: List[Tuple[int, Loop]] = [
        (i, n) for i, n in enumerate(nodes) if isinstance(n, Loop)
    ]

    # Total computes and utilized units.
    computes = 1
    utilized = 1
    for _, l in loop_pos:
        computes = computes * bound_of(l)
        if l.spatial:
            utilized = utilized * bound_of(l)

    stats: List[NodeStats] = []
    innermost: Dict[str, Tuple[int, Storage]] = {}
    for i, s in storage_pos:
        innermost[s.tensor] = (i, s)

    for i, s in storage_pos:
        tensor = einsum.tensor(s.tensor)
        ns = NodeStats(storage=s)
        below = [l for j, l in loop_pos if j > i]
        above = [(j, l) for j, l in loop_pos if j < i]

        # ---- tile size (usage): line-buffer exclusion ------------------
        exclude = None
        if i + 1 < len(nodes) and isinstance(nodes[i + 1], Loop):
            nxt = nodes[i + 1]
            if not nxt.spatial and tensor.partially_relevant(nxt.var):
                exclude = nxt
        ns.tile_size = _extent(einsum, tensor, below, bound_of, exclude=exclude)

        # ---- parent traffic --------------------------------------------
        parent: Optional[Tuple[int, Storage]] = None
        for j, q in storage_pos:
            if q.tensor == s.tensor and j < i:
                parent = (j, q)
        if parent is not None:
            pj, pq = parent
            ns.parent_level = pq.level

            # fetch volume with halo on the directly-above loop
            halo_loop = None
            if i - 1 >= 0 and isinstance(nodes[i - 1], Loop):
                prv = nodes[i - 1]
                if not prv.spatial and tensor.partially_relevant(prv.var):
                    halo_loop = prv
            tile_vol = _extent(einsum, tensor, below, bound_of)

            f_all = 1
            for _, l in above:
                f_all = f_all * bound_of(l)

            if halo_loop is not None:
                # covered extent along the affine axis across the halo loop
                var_prod: Dict[str, object] = {}
                for l in below:
                    var_prod[l.var] = var_prod.get(l.var, 1) * bound_of(l)
                vol = 1
                for d in tensor.dims:
                    if isinstance(d, tuple) and halo_loop.var in d:
                        p, r = d
                        pe = var_prod.get(p, 1)
                        re = var_prod.get(r, 1)
                        if halo_loop.var == p:
                            vol = vol * (bound_of(halo_loop) * pe + re - 1)
                        else:
                            vol = vol * (pe + bound_of(halo_loop) * re - 1)
                    elif isinstance(d, tuple):
                        p, r = d
                        vol = vol * (var_prod.get(p, 1) + var_prod.get(r, 1) - 1)
                    else:
                        vol = vol * var_prod.get(d, 1)
                fetch_vol = vol * (f_all / bound_of(halo_loop))
            else:
                fetch_vol = tile_vol * f_all

            # spatial discounts between s and parent
            mcast = 1
            red = 1
            for j, l in above:
                if j > pj and l.spatial:
                    fan = arch.fanouts[l.fanout]
                    if fan.multicast_tensor[l.dim] == s.tensor:
                        mcast = mcast * bound_of(l)
                    if fan.reduce_tensor[l.dim] == s.tensor:
                        red = red * bound_of(l)

            if tensor.is_output:
                # temporal contraction loops above -> partial-sum revisits
                fc = 1
                for _, l in above:
                    if not l.spatial and l.var in contraction:
                        fc = fc * bound_of(l)
                f_nc = f_all / fc
                ns.parent_writes = tile_vol * f_all / red
                ns.parent_reads = tile_vol * f_nc * (fc - 1)
                ns.reads = tile_vol * f_all
                ns.writes = tile_vol * f_nc * (fc - 1)
            else:
                ns.parent_reads = fetch_vol / mcast
                ns.writes = fetch_vol

        stats.append(ns)

    # ---- compute-node operand traffic at innermost storage nodes -------
    for tname, (i, s) in innermost.items():
        tensor = einsum.tensor(tname)
        ns = next(x for x in stats if x.storage is s)
        disc = 1
        for j, l in loop_pos:
            if j > i and l.spatial:
                fan = arch.fanouts[l.fanout]
                if tensor.is_output:
                    if fan.reduce_tensor[l.dim] == tname:
                        disc = disc * bound_of(l)
                else:
                    if fan.multicast_tensor[l.dim] == tname:
                        disc = disc * bound_of(l)
        if tensor.is_output:
            updates = computes / disc
            ns.reads = ns.reads + updates
            ns.writes = ns.writes + updates
        else:
            ns.reads = ns.reads + computes / disc

    # ---- aggregate per level -------------------------------------------
    level_reads: Dict[int, object] = {}
    level_writes: Dict[int, object] = {}
    level_usage: Dict[int, object] = {}
    level_instances: Dict[int, object] = {}

    for ns in stats:
        m = ns.storage.level
        level_reads[m] = level_reads.get(m, 0) + ns.reads
        level_writes[m] = level_writes.get(m, 0) + ns.writes
        level_usage[m] = level_usage.get(m, 0) + ns.tile_size
        if ns.parent_level is not None:
            p = ns.parent_level
            level_reads[p] = level_reads.get(p, 0) + ns.parent_reads
            level_writes[p] = level_writes.get(p, 0) + ns.parent_writes

    # instances of a level = prod of spatial bounds above its first node
    for i, s in storage_pos:
        if s.level in level_instances:
            continue
        inst = 1
        for j, l in loop_pos:
            if j < i and l.spatial:
                inst = inst * bound_of(l)
        level_instances[s.level] = inst

    return ModelStats(
        node_stats=stats,
        computes=computes,
        utilized_units=utilized,
        level_reads=level_reads,
        level_writes=level_writes,
        level_usage=level_usage,
        level_instances=level_instances,
    )


@dataclass(frozen=True)
class EvalResult:
    energy: float  # pJ
    latency: float  # s
    valid: bool
    usage: Dict[int, float]
    reads: Dict[int, float]
    writes: Dict[int, float]
    utilization: float

    @property
    def edp(self) -> float:
        return self.energy * self.latency


def evaluate(einsum: Einsum, arch: Arch, mapping: Mapping) -> EvalResult:
    """Numeric reference evaluation of a complete mapping."""
    st = analyze(einsum, arch, mapping)
    energy = st.computes * arch.mac_energy
    latency_terms = [st.computes / (st.utilized_units * arch.frequency)]
    valid = True
    usage = {}
    for m, lvl in enumerate(arch.levels):
        r = float(st.level_reads.get(m, 0))
        w = float(st.level_writes.get(m, 0))
        u = float(st.level_usage.get(m, 0))
        inst = float(st.level_instances.get(m, 1))
        usage[m] = u
        if u > lvl.capacity:
            valid = False
        energy += r * lvl.read_energy + w * lvl.write_energy
        if lvl.read_bandwidth is not None:
            latency_terms.append(r / (lvl.read_bandwidth * inst))
            latency_terms.append(w / ((lvl.write_bandwidth or lvl.read_bandwidth) * inst))
        else:
            latency_terms.append((r + w) / (lvl.bandwidth * inst))
    latency = max(latency_terms)
    return EvalResult(
        energy=float(energy),
        latency=float(latency),
        valid=valid,
        usage=usage,
        reads={m: float(v) for m, v in st.level_reads.items()},
        writes={m: float(v) for m, v in st.level_writes.items()},
        utilization=float(st.utilized_units) / arch.total_compute_units,
    )
