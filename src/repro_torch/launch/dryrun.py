"""Dry-run on one device: trace every (arch x shape) cell, allocating nothing.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Results land in experiments/dryrun/<arch>__<shape>__one.json.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's jit'd step against a 256- or 512-device mesh and reads XLA's memory
and cost analyses and the optimized HLO.  Torch emits no HLO, so
``repro.launch.hlo_parse`` has no counterpart here.  Instead the step
(``training.step.make_train_step``, or ``serving.engine``'s prefill or
decode) runs once under ``FakeTensorMode`` on the requested device: every
op computes its output's shape and dtype, and no memory is allocated.  One
dispatch mode (``_Counters``) watches that run and counts what the
reference reads from XLA:

  * the bytes of live tensors, arguments included, and their peak —
    ``peak_live_bytes`` (each storage rounded as the CUDA caching
    allocator rounds, the rule of ``MemTracker``);
  * the matrix products' FLOPs by ``FlopCounterMode``'s formulas —
    ``flops``;
  * the number of ops, and the bytes each non-view op reads and writes —
    ``bytes accessed``, the same upper bound the reference's HLO parser
    gives (it charges every materialized buffer).

The same counters run on real tensors: ``count(*make_inputs(...))``
outside fake mode is the real step, so a fake trace can be held against it
(``chip_smoke.py`` phase 8 holds its peak against
``torch.cuda.max_memory_allocated`` and its FLOPs against
``FlopCounterMode``).

The JSON keeps the reference's keys, so either package's ``roofline`` reads
it.  One device moves no collective bytes: ``collective_bytes`` is ``{}``
and ``total_collective_bytes`` 0.  The ``hlo`` block holds the traced counts
under the reference's names; ``ops`` and ``trace_s`` take the place of
``hlo_chars`` and ``parse_s``.  ``--mesh`` takes ``one`` only: the
reference's ``pod`` and ``multipod`` meshes need 256 and 512 devices.  The
JSON's ``mode`` is the reference's per-arch sharding mode, recorded only:
one device shards nothing.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ALIASES, SHAPES, cells_for, get_config
from ..measure import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import OptConfig, init_opt_state
from ..serving.engine import make_serve_steps
from ..training.step import make_train_step

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

MESH_DEVICES = {"pod": 256, "multipod": 512}


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


class _Counters(TorchDispatchMode):
    """One dispatch mode that counts what the reference's compiled-program
    analyses report:

      * ops, and the bytes each op that is not a view reads (its tensor
        inputs) and writes (its tensor outputs);
      * FLOPs, by ``torch.utils.flop_counter``'s formulas (those of
        ``FlopCounterMode``);
      * live bytes and their peak: each storage counted once, from the op
        that creates it (or ``track``) until it is freed, rounded up to
        512 bytes on CUDA as the caching allocator rounds (the rule of
        ``torch.distributed._tools.mem_tracker.MemTracker``).

    Metadata queries (``prim`` ops, which only fake mode dispatches) are
    not ops.  (One mode in place of ``FlopCounterMode``, ``MemTracker``
    and an op counter stacked, whose bookkeeping cost more than the fake
    replay itself.)
    """

    def __init__(self):
        super().__init__()
        self.ops = self.bytes = self.flops = 0
        self.live = self.peak = 0
        self._sizes = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._sizes:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // 512) * 512
        self._sizes[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        self.ops += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in tree_flatten((args, kwargs))[0])
        return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in lm.tree_leaves(tree) if isinstance(t, torch.Tensor)]


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
                oc: Optional[OptConfig] = None) -> Tuple[Callable, tuple]:
    """(step, arguments) of ``cell`` on ``device``, built under whatever
    tensor mode is active: parameters from ``lm.init`` (seed 0), the
    optimizer state, seeded inputs of ``input_specs``' shapes, the cache."""
    oc = oc or OptConfig()
    gen = torch.Generator().manual_seed(0)
    params = lm.init(cfg, gen, device)
    batch = {}
    for name, spec in input_specs(cfg, cell).items():
        if spec.dtype == torch.int64:
            t = torch.randint(0, cfg.vocab, spec.shape, generator=gen)
        else:
            t = torch.randn(spec.shape, generator=gen)
        batch[name] = t.to(device)
    if cell.kind == "train":
        step = make_train_step(cfg, oc, microbatches=microbatches)
        return step, (params, init_opt_state(oc, params), batch)
    prefill_step, decode_step = make_serve_steps(cfg)
    B, S = cell.global_batch, cell.seq_len
    cache = lm.init_cache(cfg, B, cell.cache_len or S, device)
    if cell.kind == "prefill":
        return prefill_step, (params, batch, cache)
    return decode_step, (params, batch["tokens"], fill_cache(cache, S - 1))


def count(step: Callable, args: tuple) -> Dict:
    """Runs ``step(*args)`` once under the counters and returns the
    reference's ``memory_per_device``, ``cost_analysis`` and ``hlo``
    blocks."""
    arg_tensors = _tensors(args)
    arg_storages = {t.untyped_storage()._cdata for t in arg_tensors}
    arg_bytes = sum(_nbytes(t) for t in arg_tensors)
    c = _Counters()
    for t in arg_tensors:
        c.track(t)
    t0 = time.perf_counter()
    with c:
        out = _tensors(step(*args))
    trace_s = time.perf_counter() - t0
    aliased = [t.untyped_storage()._cdata in arg_storages for t in out]
    return {
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
            "collective_bytes": {},
            "total_collective_bytes": 0,
            "ops": c.ops,
            "trace_s": round(trace_s, 1),
        },
    }


def trace_step(cfg: ModelConfig, cell: Cell, device, *,
               microbatches: int = 1, oc: Optional[OptConfig] = None
               ) -> Dict:
    """``cell``'s step on ``device`` once, under the counters, in
    ``FakeTensorMode`` (nothing allocated).  Returns the reference's
    ``memory_per_device``, ``cost_analysis`` and ``hlo`` blocks; the same
    step on real tensors is ``count(*make_inputs(...))``."""
    with FakeTensorMode():
        return count(*make_inputs(cfg, cell, torch.device(device),
                                  microbatches, oc))


def _fit(two, three, n_layers: int):
    """Each count of ``two`` (2 layers) and ``three`` (3 layers)
    extrapolated linearly to ``n_layers``."""
    if isinstance(two, dict):
        return {k: _fit(two[k], three[k], n_layers) for k in two}
    return two + (n_layers - 2) * (three - two)


def trace_cell(cfg: ModelConfig, cell: Cell, device,
               microbatches: int = 1) -> Dict:
    """``trace_step`` of ``cell`` at ``cfg``'s depth; ``traced_layers``
    says which depths were traced.

    A serve step (prefill, decode) over a stack of one layer kind runs the
    same ops on the same shapes in every layer, and keeps from each layer
    only its slice of the parameters and the cache (arguments) and, for a
    recurrent layer, its new state: from the second layer on, every count
    grows by the same amount a layer.  (The first differs: its input is
    the embedding, which the caller keeps.)  Such a cell is traced at 2
    and 3 layers and extrapolated: at prefill_32k the chunked attention
    dispatches ~120k ops a layer, which a full-depth trace would take many
    minutes to replay.  A train step, whose live activations and gradients
    change from layer to layer, and a stack of several kinds are traced at
    full depth.
    """
    L = cfg.n_layers
    groups = lm._stack_groups(cfg)
    if cell.kind == "train" or L <= 3 or len(groups) > 1 \
            or len(groups[0][0]) > 1:
        return {**trace_step(cfg, cell, device, microbatches=microbatches),
                "traced_layers": [L]}
    two, three = (trace_step(cfg.scaled(n_layers=n), cell, device,
                             microbatches=microbatches) for n in (2, 3))
    trace_s = two["hlo"]["trace_s"] + three["hlo"]["trace_s"]
    for b in (two, three):
        del b["hlo"]["trace_s"], b["hlo"]["collective_bytes"]
    out = _fit(two, three, L)
    out["hlo"].update(collective_bytes={}, trace_s=trace_s)
    out["traced_layers"] = [2, 3]
    return out


def run_cell(arch: str, shape: str, serve_param_dtype: str = "bfloat16",
             microbatches: int = 0, device="cuda") -> dict:
    """The reference's ``run_cell`` on the one-device mesh: the cell's
    config (serve cells with ``serve_param_dtype`` parameters) and
    microbatches, traced on ``device``; the reference's sharding mode is
    recorded."""
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
    result = {"arch": arch, "shape": shape, "mesh": "one", "mode": mode,
              "kind": cell.kind, "n_devices": 1,
              "microbatches": microbatches,
              "device": str(torch.device(device))}
    t0 = time.perf_counter()
    blocks = trace_cell(cfg, Cell(cell.kind, cell.global_batch,
                                  cell.seq_len), device, microbatches)
    # tracing is the port's lowering and compiling both
    result["lower_s"] = result["compile_s"] = round(
        time.perf_counter() - t0, 1)
    result.update(blocks)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="one",
                    help="one (the only mesh of one device)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the fake tensors live on "
                    "(default cuda)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.mesh != "one":
        need = MESH_DEVICES.get(args.mesh)
        ap.error(f"--mesh {args.mesh}: " + (
            f"the reference's {args.mesh} mesh needs {need} devices; the "
            f"port dry-runs on one" if need else "choose one"))
    device = resolve_device(args.device)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ALIASES)
    for arch in archs:
        cfg = get_config(arch)
        cells = [args.shape] if args.shape else cells_for(cfg)
        for shape in cells:
            fn = outdir / f"{arch}__{shape}__one.json"
            if fn.exists():
                print(f"skip {fn} (exists)", flush=True)
                continue
            print(f"=== {arch} x {shape} x one ===", flush=True)
            try:
                res = run_cell(arch, shape, device=device)
                print(json.dumps(res["memory_per_device"]), flush=True)
                print(json.dumps(res["hlo"]), flush=True)
            except Exception as e:  # noqa: BLE001 - recorded per cell
                res = {"arch": arch, "shape": shape, "mesh": "one",
                       "error": str(e),
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"FAILED: {e}", flush=True)
            fn.write_text(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
