"""Logical-axis sharding rules (MaxText-style), planned on one device.

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
``launch.mesh``.  No process group and no DTensor are needed to plan one:
``spec_to_pspec`` reads only the mesh's axis names and extents, so the
reference's production meshes (16x16, 2x16x16) plan here as they do there.

``constrain`` and ``constrain_any`` pin activations to the active mesh in
the reference.  The port runs on one device, where a sharding constraint
moves nothing (the reference's ``with_sharding_constraint`` on one device
moves nothing either), so both return ``x`` itself, inside
``activation_sharding_ctx`` or not.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

from ..launch.mesh import Mesh

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
    """A layout on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec


def _mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


@contextlib.contextmanager
def activation_sharding_ctx(mesh: Mesh, mode: str = "tp"):
    """The reference's context that installs (mesh, mode) for
    ``constrain``.  Kept for the reference's call sites; on one device
    ``constrain`` reads neither, so it stores nothing."""
    yield


def constrain(x, spec: Spec):
    """The reference's ``with_sharding_constraint`` by logical names, on
    one device: ``x`` itself (nothing moves)."""
    return x


def constrain_any(x, specs: Sequence[Spec]):
    """The reference's first-divisible-spec constraint, on one device:
    ``x`` itself (nothing moves)."""
    return x


def spec_to_pspec(spec: Spec, rules: Dict[str, Any], mesh: Mesh,
                  dims: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """Logical spec -> PartitionSpec.  When ``dims`` is given, a mapping is
    only taken if the mesh extent divides the dim — and the axis it would
    have used stays free for a later logical axis (e.g. a 60-layer stack
    can't shard 'layers' over 16, so 'embed' picks up 'data' instead)."""
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
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
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
        axes = [a for a in ("pod", "data") if a in mesh.axis_names]
        model = "model" if "model" in mesh.axis_names else None
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
