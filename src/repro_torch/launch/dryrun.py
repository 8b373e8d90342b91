"""Dry-run: trace every (arch x shape x mesh) cell, allocating nothing.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k [--mesh one|pod|multipod|both] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
      [--by-op]
Results land in experiments/dryrun/<arch>__<shape>__<mesh>.json;
``--by-op`` adds each cell's FLOPs and peak-live bytes by op.  Cells are
traced one after another; to trace them side by side, run one cell a
process (``--arch A --shape S --mesh M``), as the README shows.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's jit'd step against a 256- or 512-device mesh and reads XLA's memory
and cost analyses and the optimized HLO.  Torch emits no HLO, so
``repro.launch.hlo_parse`` has no counterpart here.  Instead the step
(``training.step.make_train_step``, or ``serving.engine``'s prefill or
decode) runs once under ``FakeTensorMode`` on the requested device: every
op computes its output's shape and dtype, and no memory is allocated.

``--mesh one`` (the default) traces the step on one device.  ``--mesh
pod`` and ``multipod`` trace rank 0 of the reference's production meshes
(16x16 = 256 devices, 2x16x16 = 512; ``both`` does the two): this process
joins a fake process group of that many ranks (``launch.mesh.fake_group``,
whose collectives move nothing), places its share of every parameter,
optimizer state, input and cache as the sharded path places them
(``init_sharded``, ``batch_shardings``, ``place_cache``), and runs the
sharded step in the reference's per-arch mode (``MODE_OVERRIDES``, ``dp``
falling back to ``tp_fsdp`` for serve cells) on those DTensors.  A cell
whose step fails is written with ``"error"``, as the reference writes it.
(The reference's dry-run gates every layout by the leaf's shape, so a
``tp_fsdp`` stack the split extent does not divide, or a ``dp`` batch
smaller than the mesh, compiles there; it runs here too: the sharded
step's ``strict`` refusal is the reference's launchers', not its dry-run's.)

One dispatch mode (``_Counters``) watches that run and counts, for the
rank, what the reference reads from XLA per device:

  * the bytes of live tensors, arguments included, and their peak —
    ``peak_live_bytes`` (each storage rounded as the CUDA caching
    allocator rounds, the rule of ``MemTracker``);
  * the matrix products' FLOPs by ``FlopCounterMode``'s formulas —
    ``flops``;
  * the number of ops, and the bytes each non-view op reads and writes —
    ``bytes accessed``, the same upper bound the reference's HLO parser
    gives (it charges every materialized buffer);
  * the operand bytes of every collective, by kind — ``collective_bytes``
    and their sum ``total_collective_bytes``, under the HLO parser's names
    and ``broadcast``/``reduce`` for the layer gather (``_Counters``).
    The kinds are the ops the process group runs: on the CPU (gloo)
    DTensor does an all-to-all as an all-gather.

The same counters run on real tensors: ``count(*make_inputs(...))``
outside fake mode is the real step, on one device or in each rank of a
real group, so a fake trace can be held against it (``chip_smoke.py``
phase 8 holds its peak against ``torch.cuda.max_memory_allocated`` and
its FLOPs against ``FlopCounterMode``; ``--sharded`` does so on 4 cards).

The JSON keeps the reference's keys, so either package's ``roofline`` reads
it; one device moves no collective bytes.  The ``hlo`` block holds the
traced counts under the reference's names; ``ops`` and ``trace_s`` take
the place of ``hlo_chars`` and ``parse_s``.  On one device the JSON's
``mode`` is recorded only: one device shards nothing.

``--as-reference`` traces the cell as the reference's compiled step
computes it (``as_reference``): the attention's masked kv blocks too,
and a prefill's logits at every position.  Its FLOPs are then comparable
with the reference's; its peak is not the port's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ALIASES, SHAPES, cells_for, get_config
from ..distributed.sharding import RULES, _extent, place, spec_to_pspec
from ..measure import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import OptConfig, init_opt_state
from ..serving.engine import batch_shardings, make_serve_steps, place_cache
from ..training.step import init_sharded, make_train_step
from .mesh import (Mesh, as_mesh, device_mesh, fake_group,
                   make_production_mesh)

VLM_PATCHES = 576

# per-arch sharding mode of the reference (recorded; one device shards
# nothing)
MODE_OVERRIDES = {
    "mamba2-130m": "dp",
    "qwen1.5-0.5b": "dp",
    "seamless-m4t-medium": "dp",
    "llama4-scout-17b-a16e": "tp_ep",
    "phi3.5-moe-42b-a6.6b": "tp_ep",
}

# the reference's grad-accumulation factors for the train_4k cell
DEFAULT_MICROBATCHES = {
    "yi-34b": 4,
    "llava-next-34b": 4,
    "llama4-scout-17b-a16e": 4,
    "phi3.5-moe-42b-a6.6b": 2,
    "minitron-8b": 2,
}

class InputSpec(NamedTuple):
    """The stand-in for ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, cell) -> Dict[str, InputSpec]:
    """The reference's model inputs of this cell.  Token ids are int64,
    as the port's steps index with them."""
    B, S = cell.global_batch, cell.seq_len
    ids, f32 = torch.int64, torch.float32
    if cell.kind == "decode":  # one new token against a cache of length S
        return {"tokens": InputSpec((B, 1), ids)}
    toks = S - (VLM_PATCHES if cfg.family == "vlm" else 0)
    batch = {"tokens": InputSpec((B, toks), ids)}
    if cell.kind == "train":
        batch["labels"] = InputSpec((B, toks), ids)
    if cfg.family == "vlm":
        batch["embeds"] = InputSpec((B, VLM_PATCHES, cfg.frontend_dim), f32)
    if cfg.family == "audio":
        batch["enc_frames"] = InputSpec((B, S, cfg.frontend_dim), f32)
    return batch


class Cell(NamedTuple):
    """What ``trace_step`` runs: ``kind`` at ``global_batch`` x
    ``seq_len``; a decode step reads a cache of ``cache_len`` (default
    ``seq_len``) holding ``seq_len - 1`` tokens."""
    kind: str
    global_batch: int
    seq_len: int
    cache_len: Optional[int] = None


# the collectives a rank's step issues, under the reference's HLO names
# where the op is the same collective; the layer gather's broadcast and
# reduce (``sharding.layer``) under their own; and the index of the
# argument that holds the operand each moves (``hlo_parse``'s operand
# bytes, per device)
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
    "_c10d_functional.broadcast_": ("broadcast", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.broadcast_": ("broadcast", 0),
    "c10d.reduce_": ("reduce", 0),
}
WAIT = "_c10d_functional.wait_tensor"


class _Pause:
    """A reentrant context in which ``_Counters`` counts nothing."""

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


class _Counters(TorchDispatchMode):
    """One dispatch mode that counts what the reference's compiled-program
    analyses report, per device (this rank):

      * ops, and the bytes each op that is not a view reads (its tensor
        inputs) and writes (its tensor outputs);
      * FLOPs, by ``torch.utils.flop_counter``'s formulas (those of
        ``FlopCounterMode``);
      * live bytes and their peak: each storage counted once, from the op
        that creates it (or ``track``) until it is freed, rounded up to
        512 bytes on CUDA as the caching allocator rounds (the rule of
        ``torch.distributed._tools.mem_tracker.MemTracker``);
      * collective bytes: the operand bytes of each collective
        (``COLLECTIVES``), as ``repro.launch.hlo_parse`` reads them from
        the HLO — ``all-gather``, ``all-reduce``, ``reduce-scatter``,
        ``all-to-all``, ``collective-permute`` — plus ``broadcast`` and
        ``reduce``, the layer gather of a layer-split stack (``tp_fsdp``),
        which XLA does as an all-gather and a reduce-scatter.  Waiting on
        a collective (``wait_tensor``) is not an op.

    A DTensor's op is not counted at its global shapes: the mode declines
    it (``NotImplemented``), DTensor runs it as this rank's local ops and
    the collectives of its redistributions, and those are counted.  The
    ops DTensor runs on global shapes to propagate shardings (inside
    ``hidden``) are not counted, nor are metadata queries (``prim`` ops,
    which only fake mode dispatches).  (One mode in place of
    ``FlopCounterMode``, ``MemTracker``, ``CommDebugMode`` and an op
    counter stacked, whose bookkeeping cost more than the fake replay
    itself.)
    """

    def __init__(self, by_op: bool = False):
        super().__init__()
        self.ops = self.bytes = self.flops = 0
        self.live = self.peak = 0
        self.collectives: Dict[str, int] = {}
        self._sizes = WeakIdKeyDictionary()
        self.hidden = _Pause()
        # with ``by_op``: FLOPs by op and operand shapes, and the bytes
        # live at the peak by the op (and output shape) that made them
        self.by_op = by_op
        self.flops_by: Dict[str, int] = {}
        self._live_by: Dict[str, int] = {}
        self.peak_by: Dict[str, int] = {}
        self._maker = "arguments"

    def track(self, t: torch.Tensor, like: Optional[torch.Tensor] = None
              ) -> None:
        """Count ``t``'s storage as live until it is freed; with ``like``,
        as the same memory as ``like``'s storage, freed when both are."""
        st = t.untyped_storage()
        if st in self._sizes:
            return
        if like is not None:
            held = self._sizes.get(like.untyped_storage())
            if held is not None:
                held[1] += 1
                self._sizes[st] = held
                weakref.finalize(st, self._free, held)
                return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // 512) * 512
        # bytes, storages holding them, the op that made them
        held = self._sizes[st] = [n, 1, self._maker]
        weakref.finalize(st, self._free, held)
        self.live += n
        if self.by_op:
            self._live_by[held[2]] = self._live_by.get(held[2], 0) + n
            if self.live > self.peak:
                self.peak_by = dict(self._live_by)
        self.peak = max(self.peak, self.live)

    def _free(self, held: list) -> None:
        held[1] -= 1
        if not held[1]:
            self.live -= held[0]
            if self.by_op:
                self._live_by[held[2]] -= held[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func._overloadpacket)
        if self.hidden.depth or func.namespace == "prim":
            return out
        if name == WAIT:  # the collective's own tensor, once it is done
            self.track(out, like=args[0])
            return out
        self.ops += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if self.by_op:
            self._maker = f"{name} -> {_shapes(outs)}"
        for t in outs:
            self.track(t)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            if self.by_op:
                key = f"{name} {_shapes(tree_flatten(args)[0])}"
                self.flops_by[key] = self.flops_by.get(key, 0) + f
        if name in COLLECTIVES:
            kind, at = COLLECTIVES[name]
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                _nbytes(t) for t in tree_flatten(args[at])[0])
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in tree_flatten((args, kwargs))[0])
        return out


@contextlib.contextmanager
def _waited_collectives():
    """Every functional collective waited on as it is issued, as torch
    always does under ``FakeTensorMode``; on real tensors it would
    otherwise return a tensor that waits at its first use, which holds
    memory for other spans in a real run than in a fake one."""
    import torch.distributed._functional_collectives as funcol

    prev = funcol._are_we_tracing
    funcol._are_we_tracing = lambda: True
    try:
        yield
    finally:
        funcol._are_we_tracing = prev


@contextlib.contextmanager
def _hidden_propagation(pause: _Pause):
    """DTensor's sharding propagation, which runs each new op once on
    fake tensors of its global shapes, inside ``pause``: around the
    propagator's method that runs it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    run = ShardingPropagator._propagate_tensor_meta_non_cached

    def hidden(self, *a, **k):
        with pause:
            return run(self, *a, **k)

    ShardingPropagator._propagate_tensor_meta_non_cached = hidden
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = run


def _shapes(ts) -> str:
    return " ".join("x".join(map(str, t.shape)) or "()" for t in ts
                    if isinstance(t, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``; of a DTensor, this rank's local tensor."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in lm.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def fill_cache(cache, n: int):
    """``cache`` as if it held ``n`` tokens: every attention cache's fill
    index and the position set to ``n`` (the contents stay zero)."""
    def walk(node):
        if isinstance(node, dict):
            if "idx" in node:
                node["idx"] = n
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(cache["groups"])
    cache["pos"] = n
    return cache


def make_inputs(cfg: ModelConfig, cell: Cell, device, microbatches: int = 1,
                oc: Optional[OptConfig] = None, mesh=None,
                mode: str = "tp") -> Tuple[Callable, tuple]:
    """(step, arguments) of ``cell`` on ``device``, built under whatever
    tensor mode is active: parameters from ``lm.init`` (seed 0), the
    optimizer state, seeded inputs of ``input_specs``' shapes, the cache.

    Over the ``DeviceMesh`` ``mesh`` this rank's part of each, as the
    reference's dry-run places them in ``mode``: parameters and state by
    ``init_sharded`` (layouts gated by each leaf's shape, ``strict``
    off), the inputs by ``batch_shardings``, the cache by
    ``place_cache``; the step is the sharded one (``make_train_step`` or
    ``make_serve_steps`` over ``mesh``)."""
    oc = oc or OptConfig()
    gen = torch.Generator().manual_seed(0)
    train = cell.kind == "train"
    if mesh is None:
        params = lm.init(cfg, gen, device)
        opt_state = init_opt_state(oc, params) if train else None
    else:
        params, _, opt_state = init_sharded(cfg, oc if train else None,
                                            mesh, mode, device=device,
                                            strict=False)
    batch = {}
    for name, spec in input_specs(cfg, cell).items():
        if spec.dtype == torch.int64:
            t = torch.randint(0, cfg.vocab, spec.shape, generator=gen)
        else:
            t = torch.randn(spec.shape, generator=gen)
        batch[name] = t.to(device)
    if mesh is not None:
        sh = batch_shardings(mesh, batch)
        batch = {k: place(v, sh[k]) for k, v in batch.items()}
    if train:
        step = make_train_step(cfg, oc, microbatches, mesh, mode,
                               strict=False)
        return step, (params, opt_state, batch)
    prefill_step, decode_step = make_serve_steps(cfg, mesh, mode,
                                                 strict=False)
    B, S = cell.global_batch, cell.seq_len
    cache = lm.init_cache(cfg, B, cell.cache_len or S, device)
    if mesh is not None:
        cache = place_cache(cfg, cache, mesh)
    if cell.kind == "prefill":
        return prefill_step, (params, batch, cache)
    return decode_step, (params, batch["tokens"], fill_cache(cache, S - 1))


def count(step: Callable, args: tuple, by_op: bool = False) -> Dict:
    """Runs ``step(*args)`` once under the counters and returns the
    reference's ``memory_per_device``, ``cost_analysis`` and ``hlo``
    blocks, for this rank (of a DTensor, its local tensor); with
    ``by_op``, also ``by_op``: the FLOPs by op and operand shapes, and
    the bytes live at the peak by the op that made them."""
    arg_tensors = _tensors(args)
    arg_storages = {t.untyped_storage()._cdata for t in arg_tensors}
    arg_bytes = sum(_nbytes(t) for t in arg_tensors)
    c = _Counters(by_op)
    for t in arg_tensors:
        c.track(t)
    t0 = time.perf_counter()
    with _hidden_propagation(c.hidden), _waited_collectives(), c:
        out = _tensors(step(*args))
    trace_s = time.perf_counter() - t0
    aliased = [t.untyped_storage()._cdata in arg_storages for t in out]
    extra = ({"by_op": {"flops": c.flops_by, "peak_live": c.peak_by}}
             if by_op else {})
    return {**extra,
        "memory_per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": sum(_nbytes(t) for t, a in zip(out, aliased)
                                if not a),
            "temp_bytes": c.peak - arg_bytes,
            "alias_bytes": sum(_nbytes(t) for t, a in zip(out, aliased)
                               if a),
            "peak_live_bytes": c.peak,
        },
        "cost_analysis": {"flops": float(c.flops),
                          "bytes accessed": float(c.bytes)},
        "hlo": {
            "per_device_flops": float(c.flops),
            "per_device_bytes": float(c.bytes),
            "collective_bytes": {k: float(v)
                                 for k, v in sorted(c.collectives.items())},
            "total_collective_bytes": float(sum(c.collectives.values())),
            "ops": c.ops,
            "trace_s": round(trace_s, 1),
        },
    }


def trace_step(cfg: ModelConfig, cell: Cell, device, *,
               microbatches: int = 1, oc: Optional[OptConfig] = None,
               mesh: Optional[Mesh] = None, mode: str = "tp",
               by_op: bool = False) -> Dict:
    """``cell``'s step on ``device`` once, under the counters, in
    ``FakeTensorMode`` (nothing allocated).  With ``mesh`` (a ``Mesh``
    description), rank 0 of it: this process joins a fake group of
    ``mesh.size`` ranks (``launch.mesh.fake_group``), builds the
    ``DeviceMesh`` and traces its step in ``mode``.  Returns the
    reference's ``memory_per_device``, ``cost_analysis`` and ``hlo``
    blocks; the same step on real tensors is ``count(*make_inputs(...))``
    (over a mesh, in each rank of a real group)."""
    device = torch.device(device)
    if mesh is None:
        with FakeTensorMode():
            return count(*make_inputs(cfg, cell, device, microbatches, oc),
                         by_op)
    with fake_group(mesh):
        dmesh = device_mesh(mesh, device.type)
        with FakeTensorMode():
            return count(*make_inputs(cfg, cell, device, microbatches, oc,
                                      dmesh, mode), by_op)


def _fit(a, b, d: Tuple[int, int], n_layers: int):
    """Each count of ``a`` (traced at ``d[0]`` layers) and ``b`` (at
    ``d[1]``) extrapolated linearly to ``n_layers``, in integers (every
    count is whole); a count missing from one block is 0 there."""
    if isinstance(a, dict) or isinstance(b, dict):
        return {k: _fit(a.get(k, 0), b.get(k, 0), d, n_layers)
                for k in list(a) + [k for k in b if k not in a]}
    step = (n_layers - d[0]) * (int(b) - int(a))
    return type(a)(int(a) + step // (d[1] - d[0]))


def _layer_axes(cfg: ModelConfig, n_layers: int, mesh: Optional[Mesh],
                mode: str):
    """The mesh axes a stack of ``n_layers`` splits its layers over in
    ``mode`` (gated by the depth, as ``shardings_for(like=)``), or
    None."""
    if mesh is None:
        return None
    return spec_to_pspec(("layers",), RULES[mode], mesh,
                         dims=(n_layers,))[0]


def fit_depths(cfg: ModelConfig, mesh: Optional[Mesh] = None,
               mode: str = "tp") -> Optional[Tuple[int, int]]:
    """The two depths below ``cfg.n_layers`` that ``trace_cell`` traces a
    serve cell at, or None to trace it at full depth.

    Both keep the full depth's layout of the stack: the same split of its
    layers over the same mesh axes, ``n`` ways (1 on one device or where
    the layers stay whole).  They are the two smallest multiples of ``n``
    from 2 on whose layout is the full depth's; at such a depth each rank
    holds a ``1/n`` share of the layers, so every count grows by the same
    amount per ``n`` layers.  None where no two such depths lie below the
    full depth (e.g. minitron-8b's 32 layers split 16 or 32 ways)."""
    L = cfg.n_layers
    want = _layer_axes(cfg, L, mesh, mode)
    n = 1 if want is None else _extent(as_mesh(mesh), want)
    depths = [d for d in range(n * -(-2 // n), L, n)
              if _layer_axes(cfg, d, mesh, mode) == want][:2]
    return tuple(depths) if len(depths) == 2 else None


def trace_cell(cfg: ModelConfig, cell: Cell, device, microbatches: int = 1,
               mesh: Optional[Mesh] = None, mode: str = "tp",
               by_op: bool = False) -> Dict:
    """``trace_step`` of ``cell`` at ``cfg``'s depth (over ``mesh`` in
    ``mode`` when given); ``traced_layers`` says which depths were traced.

    A serve step (prefill, decode) over a stack of one layer kind runs the
    same ops on the same shapes in every layer, and keeps from each layer
    only its slice of the parameters and the cache (arguments) and, for a
    recurrent layer, its new state: from the second layer on, every count
    grows by the same amount a layer.  (The first differs: its input is
    the embedding, which the caller keeps.)  Over a mesh whose mode splits
    the layers ``n`` ways (``tp_fsdp``), each rank holds ``1/n`` of them
    and gathers each in turn, so every count grows by the same amount per
    ``n`` layers, as long as the stack keeps its layout.  Such a cell is
    traced at the two depths of ``fit_depths`` (2 and 3 where the layers
    are not split) and extrapolated: at prefill_32k the chunked attention
    dispatches ~120k ops a layer, which a full-depth trace would take many
    minutes to replay.  A train step, whose live activations and gradients
    change from layer to layer, a stack of several kinds, and a stack
    with no two such depths below its own are traced at full depth.
    """
    L = cfg.n_layers
    groups = lm._stack_groups(cfg)
    depths = (None if cell.kind == "train" or len(groups) > 1
              or len(groups[0][0]) > 1 else fit_depths(cfg, mesh, mode))
    kw = dict(microbatches=microbatches, mesh=mesh, mode=mode, by_op=by_op)
    if depths is None:
        return {**trace_step(cfg, cell, device, **kw), "traced_layers": [L]}
    a, b = (trace_step(cfg.scaled(n_layers=d), cell, device, **kw)
            for d in depths)
    trace_s = round(a["hlo"].pop("trace_s") + b["hlo"].pop("trace_s"), 1)
    out = _fit(a, b, depths, L)
    out["hlo"]["trace_s"] = trace_s
    out["traced_layers"] = list(depths)
    return out


# the entries of each ``by_op`` breakdown a cell's JSON keeps
BY_OP_KEPT = 40

# the reference's production meshes: --mesh name -> (JSON name, multi_pod)
MESHES = {"pod": ("pod_16x16", False), "multipod": ("multipod_2x16x16", True)}


def _masked(cfgt, qi: int, nk: int) -> List[int]:
    """The first keys of the kv blocks that q chunk ``qi`` of a chunked
    attention (``layers._Cfg`` ``cfgt``, ``nk`` blocks) skips."""
    from ..models import layers

    causal, window, q_chunk, kv_chunk, q_offset, kv_valid, q_step, k0 = cfgt
    q_lo = q_offset + qi * q_step
    return [ci * kv_chunk for ci in range(nk) if layers._chunk_masked(
        causal, window, q_lo, q_lo + q_chunk - 1, k0 + ci * kv_chunk,
        k0 + ci * kv_chunk + kv_chunk - 1, kv_valid)]


@contextlib.contextmanager
def as_reference():
    """Inside, the model also computes what the reference's compiled step
    computes where the port skips work: the attention's matrix products
    over every kv block, the masked ones too (the port skips a block no
    query of which sees a key, ``layers._chunk_masked``), and a prefill's
    head on every position before the last is kept (the port's runs on
    the last only).  The values do not change: a skipped block's products
    are formed and dropped (they would add p = 0), so a trace inside
    counts the FLOPs the reference's dry-run counts for its own step.
    (Only its matrix products carry FLOPs, so a skipped block runs those
    alone: a 32k prefill's every block at full softmax cost is 2 M traced
    ops, ~430 s on a host core.)"""
    from ..models import layers

    full = {}
    trunk, head = lm._trunk, lm._head
    online, backward = layers._chunk_online, layers._flash_bwd

    def trunk_kept(*a, **k):
        out = trunk(*a, **k)
        full["x"] = out[0]
        return out

    def head_all(cfg, params, x):
        whole = full.pop("x", None)
        if whole is not None and x.shape[1] == 1 < whole.shape[1]:
            return head(cfg, params, whole)[:, -1:]
        return head(cfg, params, x)

    def online_all(q, k, v, cfgt, qi, scale):
        qc, kc = cfgt.q_chunk, cfgt.kv_chunk
        masked = _masked(cfgt, qi, k.shape[1] // kc)
        if masked:
            # the block's S = Q K^T and P V as two batched products over
            # (batch x kv head), the FLOPs of ``_chunk_online``'s einsums
            B, _, Hkv, rep, Dh = q.shape
            qb = q[:, qi * qc:(qi + 1) * qc].permute(0, 2, 3, 1, 4).reshape(
                B * Hkv, rep * qc, Dh)
            kt = k.permute(0, 2, 3, 1).reshape(B * Hkv, Dh, -1)
            vt = v.permute(0, 2, 1, 3).reshape(B * Hkv, -1, Dh)
            for lo in masked:
                torch.bmm(torch.bmm(qb, kt[:, :, lo:lo + kc]),
                          vt[:, lo:lo + kc])
        return online(q, k, v, cfgt, qi, scale)

    def backward_all(q, k, v, out, lse, dout, cfgt):
        qc, kc = cfgt.q_chunk, cfgt.kv_chunk
        for qi in range(q.shape[1] // qc):
            rows = slice(qi * qc, (qi + 1) * qc)
            qb, dob = q[:, rows], dout[:, rows]
            for lo in _masked(cfgt, qi, k.shape[1] // kc):
                kb, vb = k[:, lo:lo + kc], v[:, lo:lo + kc]
                p = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb)
                torch.einsum("bgrqk,bqgrd->bkgd", p, dob)
                torch.einsum("bqgrd,bkgd->bgrqk", dob, vb)
                torch.einsum("bgrqk,bkgd->bqgrd", p, kb)
                torch.einsum("bgrqk,bqgrd->bkgd", p, qb)
        return backward(q, k, v, out, lse, dout, cfgt)

    lm._trunk, lm._head = trunk_kept, head_all
    layers._chunk_online, layers._flash_bwd = online_all, backward_all
    try:
        yield
    finally:
        lm._trunk, lm._head = trunk, head
        layers._chunk_online, layers._flash_bwd = online, backward


def run_cell(arch: str, shape: str, serve_param_dtype: str = "bfloat16",
             microbatches: int = 0, device="cuda", mesh: str = "one",
             by_op: bool = False, counted_as_reference: bool = False
             ) -> dict:
    """The reference's ``run_cell``: the cell's config (serve cells with
    ``serve_param_dtype`` parameters), its sharding mode (the reference's
    per-arch mode, ``dp`` falling back to ``tp_fsdp`` for serve cells) and
    microbatches, traced on ``device`` — on one device (``mesh`` "one",
    where the mode is recorded only), or as rank 0 of the reference's
    ``pod`` (16x16) or ``multipod`` (2x16x16) mesh in that mode.  With
    ``by_op``, ``by_op`` holds the largest entries of ``count``'s
    breakdown (``BY_OP_KEPT`` of each), largest first.  With
    ``counted_as_reference``, traced ``as_reference`` (recorded as
    ``"as_reference": true``)."""
    cell = SHAPES[shape]
    cfg = get_config(arch)
    mode = MODE_OVERRIDES.get(arch, "tp_fsdp")
    if mode == "dp" and cell.kind != "train":
        mode = "tp_fsdp"
    if not microbatches:
        microbatches = (DEFAULT_MICROBATCHES.get(arch, 1)
                        if cell.kind == "train" else 1)
    if cell.kind != "train":
        cfg = cfg.scaled(param_dtype=serve_param_dtype)
    if mesh == "one":
        name, m = "one", None
    else:
        name, multi_pod = MESHES[mesh]
        m = make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape, "mesh": name, "mode": mode,
              "kind": cell.kind, "n_devices": 1 if m is None else m.size,
              "microbatches": microbatches,
              "device": str(torch.device(device)),
              "as_reference": counted_as_reference}
    t0 = time.perf_counter()
    with as_reference() if counted_as_reference else contextlib.nullcontext():
        blocks = trace_cell(cfg, Cell(cell.kind, cell.global_batch,
                                      cell.seq_len), device, microbatches,
                            m, mode, by_op)
    if by_op:
        blocks["by_op"] = {k: dict(sorted(v.items(), key=lambda kv: -kv[1])
                                   [:BY_OP_KEPT])
                           for k, v in blocks["by_op"].items()}
    # tracing is the port's lowering and compiling both
    result["lower_s"] = result["compile_s"] = round(
        time.perf_counter() - t0, 1)
    result.update(blocks)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("one", "pod", "multipod", "both"),
                    default="one",
                    help="one device (default), or rank 0 of the "
                    "reference's pod (16x16) or multipod (2x16x16) mesh, "
                    "or both of those")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the fake tensors live on "
                    "(default cuda)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--by-op", action="store_true",
                    help="also write each cell's FLOPs and peak-live bytes "
                    "by op (``by_op``)")
    ap.add_argument("--as-reference", action="store_true",
                    help="trace as the reference's compiled step computes "
                    "(``as_reference``): masked kv blocks and a prefill's "
                    "every logit counted")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    meshes = {"both": ["pod", "multipod"]}.get(args.mesh, [args.mesh])

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ALIASES)
    for arch in archs:
        cfg = get_config(arch)
        for shape in [args.shape] if args.shape else cells_for(cfg):
            for mesh in meshes:
                fn = outdir / f"{arch}__{shape}__{mesh}.json"
                if fn.exists():
                    print(f"skip {fn} (exists)", flush=True)
                    continue
                print(f"=== {arch} x {shape} x {mesh} ===", flush=True)
                try:
                    res = run_cell(arch, shape, device=device, mesh=mesh,
                                   by_op=args.by_op,
                                   counted_as_reference=args.as_reference)
                    print(json.dumps(res["memory_per_device"]), flush=True)
                    print(json.dumps(res["hlo"]), flush=True)
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    res = {"arch": arch, "shape": shape, "mesh": mesh,
                           "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"FAILED: {e}", flush=True)
                fn.write_text(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
