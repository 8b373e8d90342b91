"""The reference's other two sharding modes, ``tp_fsdp`` and ``tp_ep``, and
the MoE family over a mesh, against the JAX reference on 2 and 4 host
devices.

f32 smoke configs at 4 layers train 3 AdamW steps at global batch 4 x 32
and serve a prefill of 16 and 4 greedy tokens on the meshes (data, model)
(2, 1), (1, 2), (2, 2), (4, 1) and (1, 4): qwen1.5-0.5b in ``tp_fsdp``,
phi3.5-moe in ``tp``, ``dp``, ``tp_ep`` and ``tp_fsdp``, and phi3.5-moe
with ``capacity_factor`` 0.5 (half its routed tokens dropped) in ``tp_ep``
and ``tp_fsdp`` on (2, 1) and (2, 2): a capacity or a queue counted per
rank instead of over the whole batch would part from the reference there.

The runners are ``tests/test_torch_sharded.py``'s: the reference in
subprocesses of this file with 4 host devices, the port in gloo ranks
(one group of 4, then one of 2) joined through a file store, every
process under a deadline.  Besides the parity checks the ranks hold
``init_sharded`` against ``distribute(init(...))`` bit for bit, count the
gathered layers a remat'd ``tp_fsdp`` step keeps alive, and restore
``tp_fsdp``/``tp_ep`` checkpoints across modes and meshes and both ways
with the reference.

Tolerances are ``tests/test_torch_sharded.py``'s: loss, grad norm and
parameters after 3 steps 1e-4; greedy tokens equal, last logits 1e-4;
shard shapes, initial parameters and checkpoints exact.  One exception,
for the MoE's parameters (``_params_close``): an element whose gradient
is f32 roundoff of a sum that cancels (moe.wd at layer 0, expert 0,
[72, 72] here: -8.15e-9 in JAX, 3.36e-9 in the port, against a leaf
maximum of 0.043) is moved by AdamW by a sizeable share of the learning
rate either way, since Adam divides a gradient by its own size.  The
one-device port parts from JAX there by 1.3e-4 after 3 steps.  So up to
``ROUNDOFF_ELEMENTS`` elements of an MoE leaf may exceed 1e-4, each
within ``ROUNDOFF_TOL``.
"""
from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sharded import (GROUP_TIMEOUT_S, TOL, _env, _finish,  # noqa
                                _full, _jax_mesh, _join, _leaves, _load,
                                _output, _watch_strided_layouts)

HERE = Path(__file__).resolve()
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
# model name -> (arch, overrides of the f32 smoke config)
MODELS = {"qwen": ("qwen1.5-0.5b", {}),
          "moe": ("phi3.5-moe-42b-a6.6b", {}),
          "moe_drop": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5})}
LAYERS = 4
RUNS = [("qwen", "tp_fsdp"), ("moe", "tp"), ("moe", "dp"), ("moe", "tp_ep"),
        ("moe", "tp_fsdp")]
DROPS = [("moe_drop", "tp_ep"), ("moe_drop", "tp_fsdp")]
DROP_MESHES = ((2, 1), (2, 2))
STEPS, BATCH, SEQ, PROMPT, GEN = 3, 4, 32, 16, 4
OPT = dict(lr=1e-3, warmup=2, decay_steps=50)
CKPT_STEP = STEPS
# the checkpoints: the port's after its 3 steps here, the reference's after
# 1 step, restored onto these (source, mesh, mode)
CKPT_AT = ((2, 2), "moe", "tp_fsdp")
RESTORES = {4: [("ref", (2, 2), "tp_fsdp"), ("ref", (4, 1), "tp_ep")],
            2: [("port", (2, 1), "tp_ep"), ("port", (1, 2), "tp_fsdp")]}
HELD_MESH = (4, 1)  # one layer of each stack per rank
DEADLINE_S = 900  # every subprocess and group of ranks (~110 s alone)
ROUNDOFF_ELEMENTS = 4  # per MoE leaf (observed: 1)
ROUNDOFF_TOL = 1e-3  # absolute, for those (observed: 3.7e-4)


def _runs_on(shape) -> list:
    return RUNS + (DROPS if shape in DROP_MESHES else [])


CASES = [(shape, model, mode) for n in (2, 4) for shape in MESHES[n]
         for model, mode in _runs_on(shape)]
IDS = [f"{s[0]}x{s[1]}-{model}-{mode}" for s, model, mode in CASES]


def _tag(shape, model, mode) -> str:
    return f"{shape[0]}x{shape[1]}_{model}_{mode}"


# --------------------------------------------------------------------------
# the reference, in subprocesses with 4 host devices
# --------------------------------------------------------------------------

def _jax_setup(model: str):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    from repro.configs import get_config
    from repro.optim.adamw import OptConfig
    from repro.training.step import _abstract_init

    arch, kw = MODELS[model]
    cfg = get_config(arch, smoke=True).scaled(dtype="float32",
                                              n_layers=LAYERS, **kw)
    params_abs, specs = _abstract_init(cfg, jax.random.PRNGKey(0))
    return jax, cfg, OptConfig(**OPT), params_abs, specs


def _jax_state(jax, oc, params_abs, specs, mesh, mode, params):
    """The reference's parameters placed by ``mode`` on ``mesh`` and their
    optimizer state, with its layouts."""
    from repro.distributed.sharding import shardings_for
    from repro.optim.adamw import init_opt_state, opt_state_specs

    psh = shardings_for(specs, mesh, mode, like=params_abs)
    p = jax.tree.map(jax.device_put, params, psh)
    opt_abs = jax.eval_shape(lambda q: init_opt_state(oc, q), params_abs)
    osh = shardings_for(opt_state_specs(oc, specs), mesh, mode, like=opt_abs)
    o = jax.jit(lambda q: init_opt_state(oc, q), out_shardings=osh)(p)
    return p, o, psh, osh, opt_abs


def reference_init(out: Path) -> None:
    """JAX's initial parameters of every model (``init_sharded`` on one
    device) as ``init_<model>.npz``, and a JAX checkpoint of the MoE's
    parameters and optimizer state after one ``tp_fsdp`` step on (2, 2)."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.training.step import init_sharded, make_train_step

    for model in MODELS:
        jax, cfg, oc, params_abs, specs = _jax_setup(model)
        params, _, _ = init_sharded(cfg, oc, _jax_mesh(jax, (1, 1)))
        np.savez(out / f"init_{model}.npz",
                 **{f"leaf_{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(params))})
        if model != CKPT_AT[1]:
            continue
        mesh = _jax_mesh(jax, CKPT_AT[0])
        p, o, _, _, _ = _jax_state(jax, oc, params_abs, specs, mesh,
                                   CKPT_AT[2], jax.tree.map(np.asarray,
                                                            params))
        step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=CKPT_AT[2],
                                     donate=False, params_abs=params_abs)
        data = SyntheticTokens(DataConfig(global_batch=BATCH, seq_len=SEQ,
                                          vocab=cfg.vocab))
        p, o, _ = step(p, o, next(data))
        CheckpointManager(str(out / "ckpt_ref")).save(1, {"params": p,
                                                          "opt": o})
    (out / "ref_refuses.json").write_text(json.dumps(_reference_2_layers()))


def _reference_2_layers() -> dict:
    """The reference's ``tp_fsdp`` with a 2-layer stack on (4, 1) as its
    ``launch.train`` runs it (``init_sharded``, then ``make_train_step``
    with no ``params_abs``) for one step: the error that stops it."""
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.training.step import init_sharded, make_train_step

    jax, cfg, oc, _, _ = _jax_setup("qwen")
    cfg = cfg.scaled(n_layers=2)
    mesh = _jax_mesh(jax, (4, 1))
    try:
        p, specs, o = init_sharded(cfg, oc, mesh, mode="tp_fsdp")
        step, _, _ = make_train_step(cfg, oc, mesh, specs, mode="tp_fsdp",
                                     donate=False)
        step(p, o, next(SyntheticTokens(DataConfig(
            global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab))))
    except Exception as e:  # noqa: BLE001 — the failure is the result
        return {"failed": True, "error": f"{type(e).__name__}: {e}"[:2000]}
    return {"failed": False, "error": None}


def reference_run(out: Path, n: int, models) -> None:
    """Every run of ``models`` on every mesh of ``n`` devices: 3 train
    steps, the greedy serve, the parameters' shard shapes."""
    import jax.numpy as jnp
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.distributed.sharding import shardings_for
    from repro.models import lm
    from repro.serving.engine import make_serve_steps
    from repro.training.step import make_train_step

    for model in models:
        jax, cfg, oc, params_abs, specs = _jax_setup(model)
        host = jax.tree.unflatten(jax.tree.structure(params_abs),
                                  _leaves(out / f"init_{model}.npz"))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                    (BATCH, PROMPT))
        for shape in MESHES[n]:
            mesh = _jax_mesh(jax, shape)
            for m, mode in _runs_on(shape):
                if m != model:
                    continue
                p, o, _, _, _ = _jax_state(jax, oc, params_abs, specs, mesh,
                                           mode, host)
                shapes = [list(x.addressable_shards[0].data.shape)
                          for x in jax.tree.leaves(p)]
                step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=mode,
                                             donate=False,
                                             params_abs=params_abs)
                data = SyntheticTokens(DataConfig(
                    global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab))
                losses, gnorms = [], []
                for _ in range(STEPS):
                    p, o, met = step(p, o, next(data))
                    losses.append(float(met["loss"]))
                    gnorms.append(float(met["grad_norm"]))
                batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
                cache_abs = jax.eval_shape(
                    lambda: lm.init_cache(cfg, BATCH, PROMPT + GEN))
                prefill, decode, _ = make_serve_steps(cfg, mesh, specs,
                                                      cache_abs, batch,
                                                      mode=mode)
                sp = jax.tree.map(jax.device_put, host,
                                  shardings_for(specs, mesh, mode))
                last, cache = prefill(sp, batch,
                                      lm.init_cache(cfg, BATCH, PROMPT + GEN))
                lasts = [np.asarray(last)]
                toks = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
                out_toks = [np.asarray(toks)]
                for _ in range(GEN - 1):
                    logits, cache = decode(sp, toks, cache)
                    lasts.append(np.asarray(logits))
                    toks = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                    out_toks.append(np.asarray(toks))
                tag = _tag(shape, model, mode)
                np.savez(out / f"ref_{tag}.npz", loss=np.asarray(losses),
                         grad_norm=np.asarray(gnorms),
                         logits=np.stack(lasts),
                         tokens=np.concatenate(out_toks, axis=1),
                         **{f"leaf_{i}": np.asarray(x) for i, x in
                            enumerate(jax.tree.leaves(p))})
                (out / f"ref_{tag}_shapes.json").write_text(
                    json.dumps(shapes))


def reference_reads(out: Path) -> None:
    """The reference's ``restore_sharded`` of the port's ``tp_fsdp``
    checkpoint on its own (2, 1) mesh in ``tp_fsdp``: each leaf, and its
    sharding."""
    jax, cfg, oc, params_abs, specs = _jax_setup(CKPT_AT[1])
    from repro.checkpoint.manager import CheckpointManager
    from repro.distributed.sharding import shardings_for
    from repro.optim.adamw import init_opt_state, opt_state_specs

    mesh = _jax_mesh(jax, (2, 1))
    psh = shardings_for(specs, mesh, "tp_fsdp", like=params_abs)
    opt_abs = jax.eval_shape(lambda q: init_opt_state(oc, q), params_abs)
    osh = shardings_for(opt_state_specs(oc, specs), mesh, "tp_fsdp",
                        like=opt_abs)
    tree, _ = CheckpointManager(str(out / "ckpt_port")).restore_sharded(
        CKPT_STEP, {"params": params_abs, "opt": opt_abs},
        {"params": psh, "opt": osh})
    want = _leaves(out / "ckpt_port" / f"step_{CKPT_STEP:08d}" /
                   "arrays.npz")
    got = jax.tree.leaves(tree)
    sh = jax.tree.leaves({"params": psh, "opt": osh})
    (out / "ref_reads.json").write_text(json.dumps({
        "n": len(got), "n_file": len(want),
        "equal": [bool(np.array_equal(np.asarray(g), w) and
                       g.dtype == w.dtype) for g, w in zip(got, want)],
        "placed": [bool(g.sharding.is_equivalent_to(s, g.ndim))
                   for g, s in zip(got, sh)],
        "split": sum(len(g.sharding.device_set) > 1 and
                     not g.sharding.is_fully_replicated for g in got)}))


# --------------------------------------------------------------------------
# the port, in gloo ranks
# --------------------------------------------------------------------------

def _port_cfg(model: str, **kw):
    from repro_torch.configs import get_config

    arch, over = MODELS[model]
    return get_config(arch, smoke=True).scaled(dtype="float32",
                                               n_layers=LAYERS, **over, **kw)


def _port_params(out: Path, model: str):
    """JAX's initial parameters of ``model`` as the port's, on the CPU."""
    from repro_torch.models import lm
    from repro_torch.models.weights import params_from_numpy

    cfg = _port_cfg(model)
    like = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return params_from_numpy(cfg, lm.tree_unflatten(
        like, _leaves(out / f"init_{model}.npz")), "cpu")


def _greedy(cfg, params, mesh, mode):
    """Prefill the prompts and decode greedily; (last logits of each of
    the GEN steps, tokens), as numpy."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_serve_steps, place_cache

    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)))
    prefill, decode = make_serve_steps(cfg, mesh, mode)
    cache = lm.init_cache(cfg, BATCH, PROMPT + GEN, "cpu")
    if mesh is not None:
        cache = place_cache(cfg, cache, mesh)
    last, cache = prefill(params, {"tokens": prompts}, cache)
    lasts, toks = [last], torch.argmax(last, -1)[:, None]
    out = [toks]
    for _ in range(GEN - 1):
        last, cache = decode(params, toks, cache)
        lasts.append(last)
        toks = torch.argmax(last, -1)[:, None]
        out.append(toks)
    return torch.stack(lasts).numpy(), torch.cat(out, 1).numpy()


def _train(cfg, params, opt, mesh, mode, steps=STEPS):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import make_train_step

    step = make_train_step(cfg, OptConfig(**OPT), mesh=mesh, mode=mode)
    data = SyntheticTokens(DataConfig(global_batch=BATCH, seq_len=SEQ,
                                      vocab=cfg.vocab))
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, opt, losses, gnorms


def _port_rank(rank: int, world: int, out: str) -> None:
    """One gloo rank: every run on every mesh of ``world`` devices, the
    initial-parameter and held-layer checks, the checkpoint restores."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out)
    strided = _watch_strided_layouts()
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store{world}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        report = _port_work(rank, world, out)
        report["strided"] = strided
        (out / f"port{world}_r{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _port_work(rank: int, world: int, out: Path) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    oc = OptConfig(**OPT)
    hosts = {m: _port_params(out, m) for m in MODELS}
    report = {"init": {}}
    for shape in MESHES[world]:
        mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
        for model, mode in _runs_on(shape):
            tag = _tag(shape, model, mode)
            cfg, host = _port_cfg(model), hosts[model]
            specs = lm.param_specs(cfg)
            params = distribute(lm.tree_map(torch.clone, host), specs, mesh,
                                mode)
            opt = distribute(init_opt_state(oc, host),
                             opt_state_specs(oc, specs), mesh, mode)
            (out / f"port_{tag}_shapes_r{rank}.json").write_text(json.dumps(
                [list(x.to_local().shape) for x in lm.tree_leaves(params)]))
            params, opt, losses, gnorms = _train(cfg, params, opt, mesh,
                                                 mode)
            final = [_full(x) for x in lm.tree_leaves(params)]
            if (shape, model, mode) == CKPT_AT:
                CheckpointManager(str(out / "ckpt_port")).save(
                    CKPT_STEP, {"params": params, "opt": opt})
            served = cast_for_compute(cfg, distribute(
                lm.tree_map(torch.clone, host), specs, mesh, mode))
            logits, tokens = _greedy(cfg, served, mesh, mode)
            if rank == 0:
                np.savez(out / f"port_{tag}.npz", loss=np.asarray(losses),
                         grad_norm=np.asarray(gnorms), logits=logits,
                         tokens=tokens,
                         **{f"leaf_{i}": x for i, x in enumerate(final)})
        for model in ("qwen", "moe"):
            for mode in ("tp_fsdp", "tp_ep"):
                report["init"][_tag(shape, model, mode)] = _init_equal(
                    _port_cfg(model), oc, mesh, mode)
    if world == 4:
        report["held"] = {model: _held_layers(model, hosts[model])
                          for model in ("qwen", "moe")}
        report["logits"] = {model: _logits_layout(model, hosts[model])
                            for model in ("qwen", "moe")}
    report["restores"] = {f"{src}_{_tag(shape, CKPT_AT[1], mode)}":
                          _restore(out, src, shape, mode, hosts[CKPT_AT[1]])
                          for src, shape, mode in RESTORES[world]}
    return report


def _init_equal(cfg, oc, mesh, mode) -> dict:
    """``init_sharded`` against ``distribute(init(...))``: every local
    shard bit for bit, every placement the same, for the parameters and
    the optimizer state."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import lm
    from repro_torch.optim.adamw import init_opt_state, opt_state_specs
    from repro_torch.training.step import init, init_sharded

    got_p, specs, got_o = init_sharded(cfg, oc, mesh, mode, seed=1)
    host, _ = init(cfg, None, "cpu", seed=1)
    want_p = distribute(host, specs, mesh, mode)
    want_o = distribute(init_opt_state(oc, host), opt_state_specs(oc, specs),
                        mesh, mode)

    def same(a, b):
        return (a.placements == b.placements and a.shape == b.shape
                and a.dtype == b.dtype
                and torch.equal(a.to_local(), b.to_local()))

    return {"params": [same(a, b) for a, b in zip(lm.tree_leaves(got_p),
                                                   lm.tree_leaves(want_p))],
            "opt": [same(a, b) for a, b in zip(lm.tree_leaves(got_o),
                                                lm.tree_leaves(want_o))],
            "split": sum(any(p.is_shard() for p in a.placements)
                         for a in lm.tree_leaves(got_p))}


def _held_layers(model: str, host) -> dict:
    """One remat'd ``tp_fsdp`` train step on ``HELD_MESH`` with every
    layer gather watched: the most gathered layers of one stack alive at
    once, forward and backward, and the step's loss and grad norm."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    cfg = _port_cfg(model, remat=True)
    oc = OptConfig(**OPT)
    mesh = device_mesh(Mesh(("data", "model"), HELD_MESH), "cpu")
    specs = lm.param_specs(cfg)
    params = distribute(lm.tree_map(torch.clone, host), specs, mesh,
                        "tp_fsdp")
    opt = distribute(init_opt_state(oc, host), opt_state_specs(oc, specs),
                     mesh, "tp_fsdp")
    alive, peak = {}, {}
    gather = sharding._LayerGather.forward

    def watched(ctx, stack, i):
        out = gather(ctx, stack, i)
        refs = [r for r in alive.get(id(stack), []) if r() is not None]
        refs.append(weakref.ref(out._local_tensor))
        alive[id(stack)] = refs
        peak[id(stack)] = max(peak.get(id(stack), 0), len(refs))
        return out

    sharding._LayerGather.forward = staticmethod(watched)
    try:
        _, _, losses, gnorms = _train(cfg, params, opt, mesh, "tp_fsdp",
                                      steps=1)
    finally:
        sharding._LayerGather.forward = staticmethod(gather)
    return {"peak": sorted(peak.values()), "stacks": len(peak),
            "loss": losses[0], "grad_norm": gnorms[0]}


def _logits_layout(model: str, host) -> dict:
    """The placements of the f32 logits of a ``tp_fsdp`` forward on (2,
    2), whose head is split over 'data' along 'embed', and whether this
    rank's shard is finite (reading it waits for the last collective)."""
    from repro_torch.distributed.sharding import (activation_sharding_ctx,
                                                  distribute)
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.serving.engine import _placed

    cfg = _port_cfg(model)
    mesh = device_mesh(Mesh(("data", "model"), (2, 2)), "cpu")
    params = distribute(lm.tree_map(torch.clone, host), lm.param_specs(cfg),
                        mesh, "tp_fsdp")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)))
    with torch.no_grad(), activation_sharding_ctx(mesh, "tp_fsdp"):
        logits, _, _ = lm.forward(cfg, params,
                                  _placed(mesh, {"t": tokens})["t"])
    return {"placements": [str(p) for p in logits.placements],
            "finite": bool(torch.isfinite(logits.to_local()).all())}


def _restore(out: Path, src: str, shape, mode, host) -> dict:
    """The ``src`` checkpoint of the MoE restored onto ``shape`` in
    ``mode``: each leaf against the file, and its placements against the
    mode's layout."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import placements, shardings_for
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    oc = OptConfig(**OPT)
    cfg = _port_cfg(CKPT_AT[1])
    specs = lm.param_specs(cfg)
    mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
    mgr = CheckpointManager(str(out / f"ckpt_{src}"))
    step = mgr.latest_step()
    like = {"params": host, "opt": init_opt_state(oc, host)}
    sh = {"params": shardings_for(specs, mesh, mode, like=host),
          "opt": shardings_for(opt_state_specs(oc, specs), mesh, mode,
                               like=like["opt"])}
    tree, _ = mgr.restore_sharded(step, like, sh)
    want, _ = mgr.restore(step, like)
    got_l, want_l = lm.tree_leaves(tree), lm.tree_leaves(want)
    return {"n": len(got_l), "n_file": len(want_l),
            "equal": [bool(np.array_equal(_full(g), w)
                           and _full(g).dtype == w.dtype)
                      for g, w in zip(got_l, want_l)],
            "placed": [tuple(g.placements) == placements(s.spec, s.mesh)
                       for g, s in lm.tree_zip(tree, sh)],
            "split": sum(any(p.is_shard() for p in g.placements)
                         for g in got_l)}


# --------------------------------------------------------------------------
# orchestration, with deadlines
# --------------------------------------------------------------------------

def _popen(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(HERE), *map(str, args)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _ranks(world: int, out: Path):
    import torch.multiprocessing as tmp

    return tmp.start_processes(_port_rank, args=(world, str(out)),
                               nprocs=world, join=False,
                               start_method="spawn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference and the port; the directory of their results."""
    out = tmp_path_factory.mktemp("sharded_modes")
    deadline = time.monotonic() + DEADLINE_S
    _finish(_popen("reference-init", out), deadline)
    procs = [_popen("reference", out, n, *models) for n in (2, 4)
             for models in (("qwen", "moe_drop"), ("moe",))]
    try:
        _join(_ranks(4, out), deadline)
        procs.append(_popen("reference-reads", out))
        _join(_ranks(2, out), deadline)
        for proc in procs:
            _finish(proc, deadline)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
    return out


@pytest.fixture(scope="module")
def one_device(runs):
    """The one-device port from JAX's weights, per model: {"train": ...,
    "serve": ...}, and one remat'd step for the held-layer runs."""
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import OptConfig, init_opt_state

    res = {}
    for model in MODELS:
        cfg, host = _port_cfg(model), _port_params(runs, model)
        served = cast_for_compute(cfg, lm.tree_map(torch.clone, host))
        params = lm.tree_map(torch.clone, host)
        trained, _, losses, gnorms = _train(
            cfg, params, init_opt_state(OptConfig(**OPT), params), None,
            "tp")
        logits, tokens = _greedy(cfg, served, None, "tp")
        params = lm.tree_map(torch.clone, host)
        _, _, rl, rg = _train(_port_cfg(model, remat=True), params,
                              init_opt_state(OptConfig(**OPT), params),
                              None, "tp", steps=1)
        res[model] = {"loss": np.asarray(losses),
                      "grad_norm": np.asarray(gnorms),
                      "params": [_full(x) for x in lm.tree_leaves(trained)],
                      "logits": logits, "tokens": tokens,
                      "remat_loss": rl[0], "remat_grad_norm": rg[0]}
    return res


def _params_close(model: str, got, want) -> None:
    """Every leaf of ``got`` within 1e-4 of ``want``; in the MoE, up to
    ``ROUNDOFF_ELEMENTS`` elements a leaf within ``ROUNDOFF_TOL`` (see the
    module's docstring)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if model == "qwen":
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
            continue
        off = np.abs(a - b) > TOL + TOL * np.abs(b)
        assert off.sum() <= ROUNDOFF_ELEMENTS, (i, int(off.sum()))
        np.testing.assert_allclose(a, b, atol=ROUNDOFF_TOL, err_msg=str(i))


def _report(runs: Path, world: int, rank: int) -> dict:
    return json.loads((runs / f"port{world}_r{rank}.json").read_text())


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_train_steps_match_reference_on_the_same_mesh(runs, shape, model,
                                                      mode):
    got = _load(runs / f"port_{_tag(shape, model, mode)}.npz")
    want = _load(runs / f"ref_{_tag(shape, model, mode)}.npz")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                   err_msg=key)
    _params_close(model, got["params"], want["params"])


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_greedy_serve_matches_reference_on_the_same_mesh(runs, shape, model,
                                                         mode):
    got = _load(runs / f"port_{_tag(shape, model, mode)}.npz")
    want = _load(runs / f"ref_{_tag(shape, model, mode)}.npz")
    assert got["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_every_rank_holds_the_reference_shard_shapes(runs, shape, model,
                                                     mode):
    """Each rank's local shard of every parameter has the shape of JAX's
    shard on the same mesh; in ``tp_fsdp`` on a mesh with data > 1 a
    rank holds a part of each layer stack, not all of it."""
    tag = _tag(shape, model, mode)
    want = json.loads((runs / f"ref_{tag}_shapes.json").read_text())
    for r in range(shape[0] * shape[1]):
        got = json.loads((runs / f"port_{tag}_shapes_r{r}.json")
                         .read_text())
        assert got == want, f"rank {r}"
    if mode == "tp_fsdp" and shape[0] > 1:
        assert any(s[0] == LAYERS // shape[0] for s in want)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_sharded_port_equals_one_device_port(runs, one_device, shape, model,
                                             mode):
    got = _load(runs / f"port_{_tag(shape, model, mode)}.npz")
    one = one_device[model]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], one[key], rtol=TOL,
                                   err_msg=key)
    _params_close(model, got["params"], one["params"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    np.testing.assert_allclose(got["logits"], one["logits"], rtol=TOL,
                               atol=TOL)


def test_dropping_runs_drop_tokens(runs):
    """With ``capacity_factor`` 0.5 the dropping runs differ from the
    full-capacity ones from the first step: tokens are dropped there."""
    for shape in DROP_MESHES:
        drop = _load(runs / f"ref_{_tag(shape, 'moe_drop', 'tp_ep')}.npz")
        full = _load(runs / f"ref_{_tag(shape, 'moe', 'tp_ep')}.npz")
        assert abs(drop["loss"][0] - full["loss"][0]) > 1e-3


@pytest.mark.parametrize("world", [2, 4])
def test_init_sharded_equals_distributed_init_bitwise(runs, world):
    """``init_sharded`` keeps only each rank's shards and gives
    ``distribute(init(...))``'s parameters bit for bit, with its
    placements, and its optimizer state as zeros in the sharded layout,
    for both models in ``tp_fsdp`` and ``tp_ep`` on every mesh."""
    for r in range(world):
        rep = _report(runs, world, r)["init"]
        assert len(rep) == 4 * len(MESHES[world])
        for tag, got in rep.items():
            assert got["params"] and all(got["params"]), (r, tag)
            assert got["opt"] and all(got["opt"]), (r, tag)
        assert any(got["split"] for got in rep.values())


@pytest.mark.parametrize("model", ["qwen", "moe"])
def test_tp_fsdp_holds_one_gathered_layer_per_stack(runs, one_device,
                                                    model):
    """A remat'd ``tp_fsdp`` step on (4, 1), each rank holding one layer of
    every stack, never keeps two gathered layers of one stack alive: the
    forward drops each after its layer and the backward gathers it again.
    The step equals the one-device one."""
    for r in range(4):
        rep = _report(runs, 4, r)["held"][model]
        assert rep["stacks"] > 0 and rep["peak"] == [1] * rep["stacks"], r
        np.testing.assert_allclose(rep["loss"],
                                   one_device[model]["remat_loss"], rtol=TOL)
        np.testing.assert_allclose(rep["grad_norm"],
                                   one_device[model]["remat_grad_norm"],
                                   rtol=TOL)


@pytest.mark.parametrize("world,key", [
    (w, f"{src}_{_tag(shape, CKPT_AT[1], mode)}")
    for w in (4, 2) for src, shape, mode in RESTORES[w]])
def test_checkpoints_restore_bitwise_across_modes_and_meshes(runs, world,
                                                             key):
    """The port's (2, 2) ``tp_fsdp`` checkpoint onto (2, 1) ``tp_ep`` and
    (1, 2) ``tp_fsdp``; the reference's (2, 2) ``tp_fsdp`` one onto (2, 2)
    ``tp_fsdp`` and (4, 1) ``tp_ep``: every leaf bit for bit, placed by
    the new layout, on every rank."""
    for r in range(world):
        rep = _report(runs, world, r)["restores"][key]
        assert rep["n"] == rep["n_file"] > 0 and rep["split"] > 0
        assert all(rep["equal"]) and all(rep["placed"])


def test_reference_restores_the_port_tp_fsdp_checkpoint(runs):
    rep = json.loads((runs / "ref_reads.json").read_text())
    assert rep["n"] == rep["n_file"] > 0 and rep["split"] > 0
    assert all(rep["equal"]) and all(rep["placed"])


@pytest.mark.parametrize("world", [2, 4])
def test_no_product_flattens_a_split_sequence(runs, world):
    for r in range(world):
        assert _report(runs, world, r)["strided"] == [], f"rank {r}"


@pytest.mark.parametrize("layers,shape,refused", [
    (2, (4, 1), True), (6, (4, 1), True), (2, (2, 2), False),
    (4, (4, 1), False), (2, (1, 4), False)])
def test_tp_fsdp_refuses_a_stack_the_data_extent_does_not_divide(
        layers, shape, refused):
    """The reference cannot run such a stack either: its 'layers' mapping
    is dropped, 'embed' takes 'data', and its jit'd step refuses the
    layout.  The port says so up front, naming both numbers, before
    anything is drawn."""
    from repro_torch.distributed.sharding import check_sharded
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training.step import init_sharded

    cfg = _port_cfg("qwen").scaled(n_layers=layers)
    mesh = Mesh(("data", "model"), shape)
    if not refused:
        check_sharded(cfg, "tp_fsdp", mesh)
        return
    msg = rf"extent {shape[0]}, which does not divide .* {layers} layers"
    with pytest.raises(ValueError, match=msg):
        check_sharded(cfg, "tp_fsdp", mesh)
    with pytest.raises(ValueError, match=msg):
        init_sharded(cfg, None, mesh, "tp_fsdp")
    check_sharded(cfg, "tp_ep", mesh)  # only tp_fsdp splits the stack


@pytest.mark.parametrize("model", ["qwen", "moe"])
def test_tp_fsdp_logits_keep_the_batch_split(runs, model):
    """The head's weight is gathered along 'embed' (split over 'data' like
    the batch), not the batch: the f32 logits keep their batch split over
    'data' and are never whole on a rank."""
    for r in range(4):
        got = _report(runs, 4, r)["logits"][model]
        assert got["finite"], r
        assert got["placements"][0] == "S(0)", (r, got)
        assert got["placements"][1] != "R", (r, got)


def test_reference_cannot_run_what_tp_fsdp_refuses(runs):
    """The reference's own ``tp_fsdp`` on (4, 1) with 2 layers fails: the
    stack's layout is refused as not divisible by the data extent."""
    rep = json.loads((runs / "ref_refuses.json").read_text())
    assert rep["failed"] and "divisible" in rep["error"], rep["error"]


# --------------------------------------------------------------------------
# the launchers under torch.distributed.run
# --------------------------------------------------------------------------

def _launch(module: str, *args, cwd: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *map(str, args)],
        env=_env(), cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _train_args(arch, mode, mp, steps, ckpt, json_path=None) -> list:
    return (["--arch", arch, "--smoke", "--global-batch", "4", "--seq-len",
             "32", "--device", "cpu", "--model-parallel", str(mp),
             "--mode", mode, "--steps", str(steps), "--ckpt-every", "2",
             "--log-every", "1", "--ckpt-dir", str(ckpt)]
            + ([] if json_path is None else ["--json", str(json_path)]))


def _serve_args(arch) -> list:
    return ["--arch", arch, "--smoke", "--batch", "4", "--prompt-len", "16",
            "--gen", "4", "--device", "cpu"]


@pytest.mark.parametrize("arch,mode,mp,resume_mode,resume_mp", [
    ("qwen1.5-0.5b", "tp_fsdp", 1, "tp", 2),
    ("phi3.5-moe-42b-a6.6b", "tp_ep", 2, "tp_fsdp", 1)])
def test_launchers_run_the_mode_under_torch_distributed_run(
        tmp_path, arch, mode, mp, resume_mode, resume_mp):
    """``launch.train --mode`` over 2 gloo ranks prints the mesh, trains
    and checkpoints, and resumes in another mode on another mesh;
    ``launch.serve`` in the mode gives the single-process run's
    tokens."""
    from repro_torch.launch import serve

    deadline = time.monotonic() + DEADLINE_S
    ckpt = tmp_path / "ckpt"
    train = _launch("repro_torch.launch.train",
                    *_train_args(arch, mode, mp, 2, ckpt,
                                 tmp_path / "t.json"), cwd=tmp_path)
    served = _launch("repro_torch.launch.serve", *_serve_args(arch),
                     "--model-parallel", mp, "--mode", mode, "--json",
                     tmp_path / "s.json", cwd=tmp_path)
    out = _output(train, deadline)
    assert f"mesh: {{'data': {2 // mp}, 'model': {mp}}} devices=2" in out
    assert out.count("done at step 2") == 1
    rep = json.loads((tmp_path / "t.json").read_text())
    assert rep["mode"] == mode and len(rep["loss"]) == 2
    out = _output(_launch("repro_torch.launch.train",
                          *_train_args(arch, resume_mode, resume_mp, 3, ckpt),
                          cwd=tmp_path), deadline)
    assert "resumed from step 2" in out and "done at step 3" in out
    _output(served, deadline)
    want = serve.main(_serve_args(arch))
    got = json.loads((tmp_path / "s.json").read_text())
    assert got["mode"] == mode
    np.testing.assert_array_equal(np.asarray(got["tokens"]), want)


if __name__ == "__main__":
    _cmd, _out = sys.argv[1], Path(sys.argv[2])
    if _cmd == "reference-init":
        reference_init(_out)
    elif _cmd == "reference":
        reference_run(_out, int(sys.argv[3]), sys.argv[4:])
    elif _cmd == "reference-reads":
        reference_reads(_out)
    else:
        raise SystemExit(f"unknown command {_cmd!r}")
