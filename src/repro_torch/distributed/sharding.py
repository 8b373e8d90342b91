"""Logical-axis sharding rules (MaxText-style), and tensors placed by them.

Port of ``repro.distributed.sharding``.  Model code annotates every
parameter with logical axis names (``models.lm.param_specs``); the rules
map logical names to mesh axes.  The reference's modes are kept:

  * ``tp``      — tensor parallelism over 'model', data parallelism over
                  ('pod','data'); params replicated across data.
  * ``dp``      — pure data parallelism over every mesh axis.
  * ``tp_ep``   — expert weights in their compute layout (experts over
                  'model', the ff dim over 'data').
  * ``tp_fsdp`` — additionally shards the layer stack over ('pod','data')
                  and 'embed' over 'data' (ZeRO-3-style).

On torch the layout of a tensor is a ``PartitionSpec``: one entry per
dimension, None or a mesh-axis name or a tuple of them, for a mesh of
``launch.mesh`` (a frozen ``Mesh`` or a ``DeviceMesh``).  No process group
is needed to plan one: ``spec_to_pspec`` reads only the mesh's axis names
and extents, so the reference's production meshes (16x16, 2x16x16) plan
here as they do there.

On a ``DeviceMesh`` a layout places a tensor as a DTensor: ``placements``
turns a ``PartitionSpec`` into one ``Shard``/``Replicate`` per mesh dim,
``place`` and ``distribute`` put tensors and trees on the mesh.
``constrain`` and ``constrain_any`` pin activations inside
``activation_sharding_ctx`` as the reference's ``with_sharding_constraint``
does: a DTensor is redistributed to the divisibility-gated spec.  On a
plain tensor, or outside a context, both return ``x`` itself, so the
one-device path is unchanged.  Inside the context plain tensors made by
the model (positions, masks) mix with DTensors as replicated ones.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh, as_mesh

Spec = Tuple[Optional[str], ...]

RULES: Dict[str, Dict[str, Any]] = {
    "tp": {
        "embed": None,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "mlp2": None,
        "vocab": "model",
        "expert": "model",
        "layers": None,
        "batch": ("pod", "data"),
        "seq": None,
        # sequence parallelism: residual-stream activations shard their
        # sequence dim over 'model' between attention/MLP blocks; skipped
        # when not divisible (e.g. decode steps with S=1)
        "act_seq": "model",
    },
    # pure data parallelism over every mesh axis: no intra-layer
    # collectives; params/optimizer replicated (small models)
    "dp": {
        "embed": None,
        "heads": None,
        "kv": None,
        "mlp": None,
        "mlp2": None,
        "vocab": None,
        "expert": None,
        "layers": None,
        "batch": ("pod", "data", "model"),
        "seq": None,
        "act_seq": None,
    },
    # expert-parallel mode for large MoE: expert weights stored in their
    # compute layout, experts over 'model' and the ff dim over 'data'
    "tp_ep": {
        "embed": None,
        "heads": "model",
        "kv": "model",
        "mlp": "data",
        "mlp2": None,
        "vocab": "model",
        "expert": "model",
        "layers": None,
        "batch": ("pod", "data"),
        "seq": None,
        "act_seq": "model",
    },
    # ZeRO-3-style: stacked per-layer params shard their LAYER dim over
    # ('pod', 'data'); non-stacked params shard 'embed' over 'data'
    "tp_fsdp": {
        "embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "mlp2": None,
        "vocab": "model",
        "expert": "model",
        "layers": ("pod", "data"),
        "batch": ("pod", "data"),
        "seq": None,
        "act_seq": "model",
    },
}


class PartitionSpec(tuple):
    """A tensor's layout: per dimension None, a mesh-axis name or a tuple
    of them (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A layout on a mesh (``jax.sharding.NamedSharding``).  On a
    ``DeviceMesh`` it places tensors (``place``); on a ``Mesh`` it only
    describes."""
    mesh: Any
    spec: PartitionSpec


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(as_mesh(mesh).axis_names)


def placements(spec: PartitionSpec, dmesh) -> Tuple:
    """``spec`` as DTensor placements on ``dmesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim whose entry names it, else
    ``Replicate()``.  A tuple entry shards its dim over each of its axes,
    major to minor as JAX does, which is DTensor's mesh-dim order; an
    entry whose axes are out of that order raises ValueError.  A mesh dim
    of extent 1 replicates: one device holds the whole dim either way,
    and DTensor would refuse to reshape a dim it counts as split."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} is not in the mesh's order {names}")
        for i in idx:
            if dmesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def place(x, sharding: NamedSharding):
    """``x`` (a tensor on this rank's device, the same on every rank) as
    a DTensor laid out by ``sharding``, whose mesh is a ``DeviceMesh``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh,
                             placements(sharding.spec, sharding.mesh))


def distribute(tree, specs, dmesh, mode: str = "tp", like=None):
    """Every leaf of ``tree`` placed on ``dmesh`` by its logical spec in
    ``specs``, through ``shardings_for(..., like=)``: a mapping is taken
    only where the mesh extent divides the dim, as the reference gates it.
    ``like`` defaults to ``tree`` itself."""
    rules = RULES[mode]

    def one(spec, leaf, shaped):
        return place(leaf, NamedSharding(dmesh, spec_to_pspec(
            tuple(spec), rules, dmesh, dims=tuple(shaped.shape))))

    return map_specs(one, specs, tree, tree if like is None else like)


# --------------------------------------------------------------------------
# Activation sharding constraints: model code calls ``constrain(x, spec)``
# with logical names; the step factories install the active (mesh, mode).
# --------------------------------------------------------------------------

# the (mesh, mode) of the innermost context; a process-wide value, not a
# thread-local one: autograd's device threads run the backward (and the
# recomputed forward of a checkpointed layer) outside the caller's thread
_ACTIVE: Dict[str, Any] = {"ctx": None}


@contextlib.contextmanager
def activation_sharding_ctx(mesh, mode: str = "tp"):
    """Install (mesh, mode) for ``constrain``: the reference's context.
    On a ``DeviceMesh`` the model's DTensors are redistributed by it, and
    plain tensors mix with them as replicated ones; on a ``Mesh``
    description nothing is placed, so ``constrain`` has nothing to move;
    with ``mesh`` None it installs nothing."""
    from torch.distributed.tensor.experimental import implicit_replication

    if mesh is None:  # one device: nothing is placed
        yield
        return
    prev, _ACTIVE["ctx"] = _ACTIVE["ctx"], (mesh, mode)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE["ctx"] = prev


def active():
    """The (mesh, mode) installed by ``activation_sharding_ctx``, or
    None."""
    return _ACTIVE["ctx"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full(x):
    """``x`` whole on every rank: a DTensor gathered (a collective), any
    other tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# what the model runs over a mesh: every family, in every mode of RULES
SHARDED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
SHARDED_MODES = tuple(RULES)


def check_sharded(cfg, mode: str, mesh=None) -> None:
    """Raises ValueError unless the model runs ``cfg`` over a mesh in
    ``mode``, and, given ``mesh``, unless the mesh extent that ``mode``
    shards the layer stacks over divides each stack of more than one
    layer (``lm._stack_groups``).  A one-layer stack keeps its layer
    whole and its 'embed' takes the axis instead, as the reference lays
    it out by ``shardings_for(..., like=)``; a longer stack the extent
    does not divide the reference's jit'd step refuses."""
    from ..models.lm import _stack_groups

    if cfg.family not in SHARDED_FAMILIES or mode not in SHARDED_MODES:
        raise ValueError(
            f"the sharded path runs the {'/'.join(SHARDED_FAMILIES)} "
            f"families in modes {'/'.join(SHARDED_MODES)}; not "
            f"{cfg.name} ({cfg.family}) in mode {mode!r}")
    if mesh is None:
        return
    mesh = as_mesh(mesh)
    axes = spec_to_pspec(("layers",), RULES[mode], mesh)[0]
    n = 1 if axes is None else _extent(mesh, axes)
    for kinds, count in _stack_groups(cfg):
        if count > 1 and count % n:
            raise ValueError(
                f"mode {mode!r} shards the layer stacks over {axes!r} of "
                f"extent {n}, which does not divide {cfg.name}'s "
                f"{'/'.join(kinds)} stack of {count} layers")


def _extent(mesh: Mesh, entry) -> int:
    size = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        size *= mesh.shape[a]
    return size


def _padded(pspec, ndim: int) -> Tuple:
    return tuple(pspec) + (None,) * (ndim - len(pspec))


def _moved(x, pl):
    """The DTensor ``x`` with placements ``pl`` on its own mesh (itself
    if it already has them)."""
    pl = tuple(pl)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def _whole_along(pl, dim: int) -> Tuple:
    """``pl`` with every split of tensor dim ``dim`` replicated."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_shard(dim) else p for p in pl)


def redistribute(x, pspec: PartitionSpec):
    """The DTensor ``x`` laid out by ``pspec`` on its own mesh (itself if
    it already is and no gradient flows back through it).  Where a
    gradient will flow back over a mesh of more than one device, the
    layout is applied even when no data moves, so that the gradient is
    laid out by ``pspec`` too: a product whose output is already whole
    along its sequence (an MLP whose 'mlp' axis is not split) gets its
    gradient whole, not split by the next layer's ``act_seq``, which a
    strided shard would follow.  (On one device every placement is
    ``Replicate``, and the autograd graph stays the one-device one, so
    are its sums.)"""
    pl = placements(pspec, x.device_mesh)
    if (x.requires_grad and torch.is_grad_enabled()
            and x.device_mesh.size() > 1):
        return x.redistribute(x.device_mesh, pl)
    return _moved(x, pl)


def pinned(x):
    """``x`` itself, except that where a gradient flows back over a mesh
    of more than one device it is laid out as ``x`` is (a redistribution
    to ``x``'s own placements: nothing moves forward).  Before a reshape
    that merged a dim the mesh does not split evenly (10 heads' columns
    over 4 ranks), the gradient must arrive whole along it, not split as
    the next product's backward leaves it."""
    if (is_dtensor(x) and x.requires_grad and torch.is_grad_enabled()
            and x.device_mesh.size() > 1):
        return x.redistribute(x.device_mesh, x.placements)
    return x


def constrain(x, spec: Spec):
    """``with_sharding_constraint`` by logical axis names: a DTensor inside
    ``activation_sharding_ctx`` is redistributed to the spec, each mapping
    dropped where its mesh extent does not divide the dim (e.g. decode's
    one-token sequence); anything else is returned as it is."""
    ctx = active()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, mode = as_mesh(ctx[0]), ctx[1]
    pspec = spec_to_pspec(tuple(spec), RULES[mode], mesh)
    fixed = [e if e is None or dim % _extent(mesh, e) == 0 else None
             for dim, e in zip(x.shape, _padded(pspec, x.ndim))]
    return redistribute(x, P(*fixed))


def constrain_any(x, specs: Sequence[Spec]):
    """Apply the first logical spec whose every mapped axis divides the
    corresponding dim and which shards something (e.g. attention heads
    over 'model' when the head count divides, else the sequence); else
    ``constrain`` by the last."""
    ctx = active()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, mode = as_mesh(ctx[0]), ctx[1]
    for spec in specs:
        pspec = spec_to_pspec(tuple(spec), RULES[mode], mesh)
        sizes = [(dim, _extent(mesh, e))
                 for dim, e in zip(x.shape, _padded(pspec, x.ndim))
                 if e is not None]
        if all(dim % n == 0 for dim, n in sizes) and \
                any(n > 1 for _, n in sizes):
            return redistribute(x, pspec)
    return constrain(x, specs[-1])


def attention_pspecs(q_shape, kv_shape) -> Tuple[PartitionSpec,
                                                 PartitionSpec]:
    """The layouts the attention core runs in inside the active context,
    for q (B, Sq, Hq, Dh) and k/v (B, Sk, Hkv, Dh): batch over the mode's
    batch axes and heads over its 'heads' axes where both head counts
    divide, so each rank's q heads see their own kv heads (GQA groups
    stay whole).  The sequence is never split: attention is exact per
    (batch, head), not per sequence shard.  Raises RuntimeError outside
    ``activation_sharding_ctx``."""
    if active() is None:
        raise RuntimeError("DTensor attention runs inside "
                           "activation_sharding_ctx")
    mesh, mode = active()
    mesh = as_mesh(mesh)
    rules = RULES[mode]
    q = spec_to_pspec(("batch", None, "heads", None), rules, mesh,
                      dims=tuple(q_shape))
    kv = spec_to_pspec(("batch", None, "kv", None), rules, mesh,
                       dims=(q_shape[0],) + tuple(kv_shape[1:]))
    if q[2] != kv[2]:
        q, kv = P(q[0], None, None, None), P(kv[0], None, None, None)
    return q, kv


def local_offset(x, dim: int) -> int:
    """Where this rank's shard of the DTensor ``x`` starts along ``dim``
    (even shards, major to minor over the mesh dims that split it)."""
    return local_index(x.placements, x.device_mesh, x.shape)[dim].start


def local_index(pl, dmesh, shape) -> Tuple[slice, ...]:
    """The slices of a tensor of whole ``shape`` that this rank holds
    under placements ``pl`` on ``dmesh``: even shards, major to minor over
    the mesh dims that split a dim, as DTensor cuts them."""
    coord = dmesh.get_coordinate()
    lo, size = [0] * len(shape), list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            size[p.dim] //= dmesh.size(i)
            lo[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def _from_local(local, dmesh, pl, shape):
    """The DTensor of whole ``shape`` whose shard on this rank is
    ``local``, laid out by ``pl``."""
    from torch.distributed.tensor import DTensor

    whole = torch.empty(shape, device="meta")
    return DTensor.from_local(local, dmesh, pl, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def local_part(spec, shape, dmesh, mode: str):
    """Where a leaf of logical ``spec`` and whole ``shape`` lies on this
    rank of ``dmesh`` by ``mode``'s rules (divisibility-gated, as
    ``distribute`` places it): (the slices this rank holds, the function
    that makes those slices, as a tensor, the DTensor)."""
    pl = placements(spec_to_pspec(tuple(spec), RULES[mode], dmesh,
                                  dims=tuple(shape)), dmesh)
    return (local_index(pl, dmesh, shape),
            lambda local: _from_local(local, dmesh, pl, shape))


def sharded_zeros(spec, shape, dtype, dmesh, mode: str, device):
    """Zeros of whole ``shape`` placed on ``dmesh`` as ``local_part``
    places a leaf of logical ``spec``; only this rank's shard is
    allocated, on ``device``."""
    index, wrap = local_part(spec, shape, dmesh, mode)
    return wrap(torch.zeros([s.stop - s.start for s in index], dtype=dtype,
                            device=device))


def layer(stack, i: int):
    """Layer ``i`` of the stacked parameter ``stack``: ``stack[i]``, or,
    for a DTensor whose layer dim is split over ranks (``tp_fsdp``), the
    layer broadcast from the rank that holds it to the others of its
    group, keeping its other placements.  In the backward the layer's
    gradient is reduced onto that rank: the reference's reduce-scatter of
    a layer-sharded stack."""
    if is_dtensor(stack) and any(p.is_shard(0) for p in stack.placements):
        return _LayerGather.apply(stack, i)
    return stack[i]


def _gather_plan(stack, i: int):
    """(mesh dim splitting the stack's layers, the owner's global rank,
    whether this rank owns layer ``i``, its index in the owner's shard,
    the layer's placements)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = stack.device_mesh, tuple(stack.placements)
    dims = [m for m, p in enumerate(pl) if p.is_shard(0)]
    if len(dims) != 1:
        raise NotImplementedError(
            f"a layer stack split over {len(dims)} mesh dims ({pl}); the "
            f"layer gather takes one")
    dim = dims[0]
    per = stack.shape[0] // mesh.size(dim)
    owner, j = divmod(i, per)
    coord = list(mesh.get_coordinate())
    mine = coord[dim] == owner
    coord[dim] = owner
    src = int(mesh.mesh[tuple(coord)])
    layer_pl = tuple(Replicate() if m == dim else
                     (Shard(p.dim - 1) if p.is_shard() else p)
                     for m, p in enumerate(pl))
    return dim, src, mine, j, layer_pl


class _LayerGather(torch.autograd.Function):
    """``layer``'s gather: a broadcast from the owner in the forward, a
    reduce onto it in the backward."""

    @staticmethod
    def forward(ctx, stack, i):
        dim, src, mine, j, layer_pl = _gather_plan(stack, i)
        mesh, local = stack.device_mesh, stack.to_local()
        buf = (local[j].contiguous() if mine else
               torch.empty(local.shape[1:], dtype=local.dtype,
                           device=local.device))
        dist.broadcast(buf, src=src, group=mesh.get_group(dim))
        ctx.plan = (dim, src, mine, j, layer_pl)
        ctx.stack = (mesh, tuple(stack.placements), tuple(stack.shape),
                     local.shape)
        return _from_local(buf, mesh, layer_pl, stack.shape[1:])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        if g is None:
            return None, None
        dim, src, mine, j, layer_pl = ctx.plan
        mesh, pl, shape, local_shape = ctx.stack
        # the layer's own layout, except that a sum still pending over the
        # owner's group is reduced onto the owner alone
        pending = g.placements[dim]
        target = list(layer_pl)
        target[dim] = pending if pending.is_partial() else Replicate()
        g = g.redistribute(mesh, target).to_local()
        if pending.is_partial():
            if pending.reduce_op != "sum":
                raise NotImplementedError(f"a {pending} gradient")
            g = g.contiguous().clone()
            dist.reduce(g, dst=src, group=mesh.get_group(dim))
        out = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        if mine:
            out[j] = g
        return _from_local(out, mesh, pl, shape), None


def batch_local(fn, x, params: Dict, state: Optional[Dict] = None):
    """``fn(x, params, state) -> (out, new_state)`` on plain tensors, run on
    each rank's share of the batch under ``local_map``: every parameter
    whole on every rank, ``x`` (B, S, d) with its sequence whole, the
    batch split as the state's batch is (the cache rule), or without a
    state as the mode's 'batch' rule splits it.  The recurrent blocks
    (RG-LRU, SSD) mix channels in their gates and scan the sequence, so a
    rank runs the whole block on its rows, as the reference's compiled
    step does per device once GSPMD has gathered the channels.  The
    parameters' gradients are partial sums over the mesh dims that split
    the batch, reduced by the train step's constraint.  Returns (out with
    the batch's split, the new state laid out as ``state`` is, or None
    without a state)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if active() is None:
        raise RuntimeError("DTensor recurrent blocks run inside "
                           "activation_sharding_ctx")
    mesh = x.device_mesh
    keys = sorted(params)
    skeys = [] if state is None else sorted(state)
    if state is None:
        ref = placements(spec_to_pspec(("batch", None, None),
                                       RULES[active()[1]], mesh,
                                       dims=tuple(x.shape)), mesh)
    else:
        ref = state[skeys[0]].placements
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in ref)
    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in rows)

    def per_rank(xl, *rest):
        pl = dict(zip(keys, rest[:len(keys)]))
        st = dict(zip(skeys, rest[len(keys):])) if skeys else None
        out, new = fn(xl, pl, st)
        return (out,) if st is None else (out, *(new[k] for k in skeys))

    n_out = 1 + len(skeys)
    run = local_map(per_rank, out_placements=(rows,) * n_out,
                    in_placements=(rows, *([whole] * len(keys)),
                                   *([rows] * len(skeys))),
                    in_grad_placements=(rows, *([summed] * len(keys)),
                                        *([rows] * len(skeys))),
                    device_mesh=mesh, redistribute_inputs=True)
    outs = run(x, *(params[k] for k in keys),
               *(state[k] for k in skeys))
    if state is None:
        return outs[0], None
    return outs[0], {k: _moved(v, state[k].placements)
                     for k, v in zip(skeys, outs[1:])}


def seq_replicated_like(upd, buf):
    """The DTensor ``upd`` laid out as ``buf`` is, except that its dim 1
    (the sequence being written) is whole on every rank."""
    return _moved(upd, _whole_along(buf.placements, 1))


def splittable(x, dim: int, parts: int):
    """``x`` ready to split ``dim`` into (``parts``, rest): a DTensor whose
    shards of ``dim`` do not hold whole parts (e.g. 2 kv heads' columns
    over 4 ranks) has ``dim`` gathered first; anything else is ``x``."""
    if not is_dtensor(x):
        return x
    dim %= x.ndim
    n = 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            n *= x.device_mesh.size(i)
    return x if parts % n == 0 else _moved(x, _whole_along(x.placements,
                                                           dim))


def spec_to_pspec(spec: Spec, rules: Dict[str, Any], mesh: Mesh,
                  dims: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """Logical spec -> PartitionSpec.  When ``dims`` is given, a mapping is
    only taken if the mesh extent divides the dim — and the axis it would
    have used stays free for a later logical axis (e.g. a 60-layer stack
    can't shard 'layers' over 16, so 'embed' picks up 'data' instead)."""
    mesh = as_mesh(mesh)
    axes = _mesh_axes(mesh)
    out = []
    used = set()
    for i, logical in enumerate(spec):
        if logical is None:
            out.append(None)
            continue
        mapped = rules.get(logical)
        if mapped is None:
            out.append(None)
            continue
        if not isinstance(mapped, tuple):
            mapped = (mapped,)
        mapped = tuple(a for a in mapped if a in axes and a not in used)
        if not mapped:
            out.append(None)
            continue
        if dims is not None:
            size = 1
            for a in mapped:
                size *= mesh.shape[a]
            if dims[i] % size != 0:
                # try a shrinking prefix of the mapped axes
                while mapped and dims[i] % size != 0:
                    size //= mesh.shape[mapped[-1]]
                    mapped = mapped[:-1]
                if not mapped or dims[i] % size != 0:
                    out.append(None)
                    continue
        used.update(mapped)
        out.append(mapped if len(mapped) > 1 else mapped[0])
    return P(*out)


def is_logical_spec(x) -> bool:
    """A logical-axis spec leaf: tuple of axis names / None (may be empty)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def map_specs(fn: Callable, specs, *others):
    """``fn(spec, *the nodes of others at its place)`` on every logical
    spec of ``specs`` (nested dicts and lists), in ``specs``' structure:
    ``jax.tree.map(fn, specs, *others, is_leaf=is_logical_spec)``."""
    if is_logical_spec(specs):
        return fn(specs, *others)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(o[k] for o in others))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(o[i] for o in others))
                for i, v in enumerate(specs)]
    raise TypeError(f"not a specs tree node: {specs!r}")


def shardings_for(specs, mesh: Mesh, mode: str = "tp", like=None):
    """Map a specs tree (tuples of logical names) to NamedShardings.

    ``like``: optional tree of the same structure whose leaves' shapes
    gate each mapping by divisibility (tensors, fake tensors, or anything
    with ``.shape``)."""
    rules = RULES[mode]

    if like is None:
        return map_specs(lambda spec: NamedSharding(
            mesh, spec_to_pspec(tuple(spec), rules, mesh)), specs)

    return map_specs(lambda spec, leaf: NamedSharding(
        mesh, spec_to_pspec(tuple(spec), rules, mesh,
                            dims=tuple(leaf.shape))), specs, like)


def batch_pspec(mesh: Mesh, extra_dims: int = 1) -> PartitionSpec:
    axes = [a for a in ("pod", "data") if a in _mesh_axes(mesh)]
    return P(tuple(axes), *([None] * extra_dims))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, batch_pspec(mesh, extra_dims=ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def cache_sharding(cfg, mesh: Mesh, mode: str = "tp"):
    """KV caches: batch over ('pod','data'), heads over 'model'; SSM/RG-LRU
    states: batch over data axes.  Returns the reference's per-leaf rule,
    by rank, for any leaf with ``.ndim`` and ``.shape``."""

    def shard_leaf(x):
        nd = x.ndim
        axes = [a for a in ("pod", "data") if a in _mesh_axes(mesh)]
        model = "model" if "model" in _mesh_axes(mesh) else None
        if nd == 0 or tuple(x.shape) == ():
            return NamedSharding(mesh, P())
        # stacked cache leaves: (L, B, ...) — batch axis second
        if nd >= 5:
            # (L, B, S, H, D) attention cache: shard B and heads
            return NamedSharding(
                mesh, P(None, tuple(axes), None, model, None))
        if nd == 4:
            # (L, B, ...) states
            return NamedSharding(mesh, P(None, tuple(axes), None, None))
        if nd == 3:
            return NamedSharding(mesh, P(None, tuple(axes), None))
        if nd == 2:
            return NamedSharding(mesh, P(None, tuple(axes)))
        return NamedSharding(mesh, P())

    return shard_leaf
