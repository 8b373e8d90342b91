"""The runners of ``tests/test_torch_sharded_families_*.py``: the ssm,
hybrid, vlm and audio families over a mesh against the JAX reference on 2
and 4 host devices.

f32 smoke configs, widened only in depth and window: recurrentgemma-2b at
14 layers (4 groups of (rglru, rglru, wattn) and two one-layer rglru
stacks, like the 26 layers of the full model) with ``window`` 8, so a
prompt of 16 fills the ring and decoding wraps it; llava-next-34b at 4
layers with 8 patch embeddings before the text; mamba2-130m at 4 layers;
seamless-m4t-medium at its smoke 2 + 2.  Each trains 3 AdamW steps at
global batch 4 x 32 and serves a prefill of 16 and 4 greedy tokens, in its
reference modes (``REF_MODES``, the dry-run's choice for the full model:
train in ``dp`` and serve in ``tp_fsdp`` for ssm and audio, ``tp_fsdp``
for the others) on the meshes (data, model) (2, 1), (1, 2), (2, 2), (4, 1)
and (1, 4), in every other mode on (2, 2), and the audio in ``tp_ep`` on
(1, 2) (``EXTRA_RUNS``).  A mesh that ``check_sharded``
refuses (the audio's 2-layer stacks over data 4 in ``tp_fsdp``) is held
by the refusal tests instead.

The runners are ``tests/test_torch_sharded.py``'s: the reference in
subprocesses of the test file with 4 host devices (``python
tests/test_torch_sharded_families_<pair>.py
reference-init|reference-ckpt|reference N|reference-reads DIR MODELS``,
and ``reference-layout DIR MODEL DxM MODE ROWS OVERRIDES`` for the layout
checks),
the port in gloo ranks (a group of 4, then one of 2) joined through a
file store, every process under a deadline.  The
reference lays parameters out by ``shardings_for(..., like=params_abs)``
for training and serving alike, as its dry-run compiles the serve steps:
its ``make_serve_steps`` lays them out without ``like`` and refuses the
hybrid's one-layer stacks on a data extent above 1.

Tolerances are ``tests/test_torch_sharded.py``'s: loss, grad norm and
parameters after 3 steps 1e-4; greedy tokens equal, last logits 1e-4;
shard shapes (parameters and caches) and checkpoints exact.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import signal
import subprocess
import sys
import time
import weakref
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from test_torch_sharded import (GROUP_TIMEOUT_S, TOL, _env, _finish,  # noqa
                                _full, _jax_mesh, _join, _leaves, _load,
                                _output, _watch_strided_layouts)

MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
MODES = ("tp", "dp", "tp_ep", "tp_fsdp")
# model name -> (arch, overrides of the f32 smoke config)
MODELS = {"hybrid": ("recurrentgemma-2b", {"n_layers": 14, "window": 8}),
          "vlm": ("llava-next-34b", {"n_layers": 4}),
          "ssm": ("mamba2-130m", {"n_layers": 4}),
          "audio": ("seamless-m4t-medium", {}),
          "dense": ("qwen1.5-0.5b", {})}
REF_MODES = {"hybrid": ("tp_fsdp",), "vlm": ("tp_fsdp",),
             "ssm": ("dp", "tp_fsdp"), "audio": ("dp", "tp_fsdp")}
ALL_MODES_ON = (2, 2)
# and besides: the audio's MLP, whose 'mlp' axis tp_ep maps to 'data' (of
# extent 1 here), is not split while 'act_seq' splits the sequence: its
# gradient must still reach the product whole
EXTRA_RUNS = {("audio", (1, 2)): ("tp_ep",)}
STEPS, BATCH, SEQ, PROMPT, GEN = 3, 4, 32, 16, 4
PATCHES = 8  # the vlm's patch embeddings, in training and serving
OPT = dict(lr=1e-3, warmup=2, decay_steps=50)
CKPT_STEP = STEPS
# each model's checkpoints: the port's after its 3 steps on (2, 2) in its
# first reference mode, the reference's after 1 step there; restored onto
# these (source, mesh, mode) by the group of 4 and the group of 2
CKPT_MESH = (2, 2)
RESTORES = {4: [("port", (1, 4), "tp")],
            2: [("port", (2, 1), "tp_ep"), ("port", (1, 2), "tp_fsdp"),
                ("ref", (2, 1), "tp_fsdp"), ("ref", (1, 2), "tp")]}
READ_AT = ((2, 1), "tp_fsdp")  # where the reference reads the port's
HELD_MESH = (4, 1)  # one layer of the hybrid's group stack per rank
# recurrentgemma-2b's head layout at smoke width, over 4 ranks in tp: its
# 10 heads' columns split unevenly, so they are gathered before the head
# reshape and their gradient must come back whole
HEADS = {"n_layers": 5, "n_heads": 10, "n_kv_heads": 1, "d_head": 16}
HEADS_MESH = (1, 4)
DEADLINE_S = 900  # every subprocess and group of ranks
DECODES = 2  # decode steps after the prefill in the layout checks


def ckpt_mode(model: str) -> str:
    return REF_MODES[model][0]


def cfg_of(model: str, **kw):
    """The port's config of ``model`` (the reference's is the same
    ``ModelConfig`` fields), in f32 unless ``kw`` names a dtype."""
    from repro_torch.configs import get_config

    arch, over = MODELS[model]
    return get_config(arch, smoke=True).scaled(
        **{"dtype": "float32", **over, **kw})


def refused(model: str, shape, mode: str) -> bool:
    from repro_torch.distributed.sharding import check_sharded
    from repro_torch.launch.mesh import Mesh

    try:
        check_sharded(cfg_of(model), mode, Mesh(("data", "model"), shape))
    except ValueError:
        return True
    return False


def runs_on(models, shape) -> list:
    """The (model, mode) runs of ``models`` on ``shape``."""
    out = []
    for model in models:
        modes = (MODES if shape == ALL_MODES_ON else REF_MODES[model]
                 + EXTRA_RUNS.get((model, shape), ()))
        out += [(model, mode) for mode in modes
                if not refused(model, shape, mode)]
    return out


def cases(models) -> list:
    return [(shape, model, mode) for n in (2, 4) for shape in MESHES[n]
            for model, mode in runs_on(models, shape)]


def ids(cs) -> list:
    return [f"{s[0]}x{s[1]}-{model}-{mode}" for s, model, mode in cs]


def tag(shape, model, mode) -> str:
    return f"{shape[0]}x{shape[1]}_{model}_{mode}"


def _data(cfg, lib):
    return lib.SyntheticTokens(lib.DataConfig(
        global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        frontend_len=PATCHES))


def _prompts(cfg) -> dict:
    """The serve batch as numpy, drawn as ``launch.serve.make_batch``
    draws it: tokens, then the vlm's embeddings or the audio's frames."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT))}
    if cfg.family == "vlm":
        batch["embeds"] = rng.normal(
            size=(BATCH, PATCHES, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = rng.normal(
            size=(BATCH, PROMPT, cfg.frontend_dim)).astype(np.float32)
    return batch


def _cache_len(cfg) -> int:
    return PROMPT + GEN + (PATCHES if cfg.family == "vlm" else 0)


# --------------------------------------------------------------------------
# the reference, in subprocesses with 4 host devices
# --------------------------------------------------------------------------

def _jax_setup(model: str, **kw):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    from repro.configs import get_config
    from repro.optim.adamw import OptConfig
    from repro.training.step import _abstract_init

    arch, over = MODELS[model]
    cfg = get_config(arch, smoke=True).scaled(dtype="float32",
                                              **{**over, **kw})
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


def _jax_serve_steps(jax, cfg, mesh, psh, cache_abs, batch, mode):
    """Prefill and decode jit'd as the reference's dry-run compiles them:
    parameters by ``psh`` (divisibility-gated), the cache and the batch
    by ``serving.engine``'s rules, inside the activation context."""
    from repro.distributed.sharding import activation_sharding_ctx
    from repro.models import lm
    from repro.serving.engine import batch_shardings, cache_shardings

    csh = cache_shardings(cfg, cache_abs, mesh)
    bsh = batch_shardings(mesh, batch)
    tsh = batch_shardings(mesh, {"t": batch["tokens"][:, :1]})["t"]

    def prefill_fn(params, b, cache):
        with activation_sharding_ctx(mesh, mode):
            return lm.prefill(cfg, params, b, cache)

    def decode_fn(params, tok, cache):
        with activation_sharding_ctx(mesh, mode):
            return lm.decode_step(cfg, params, tok, cache)

    prefill = jax.jit(prefill_fn, in_shardings=(psh, bsh, csh),
                      out_shardings=(None, csh))
    decode = jax.jit(decode_fn, in_shardings=(psh, tsh, csh),
                     out_shardings=(None, csh))
    return prefill, decode


def _jax_cache_shapes(jax, cache) -> dict:
    """Each cache buffer's shard shape on the first device, without the
    stack's layer dim, keyed as ``_port_cache_shapes`` keys the port's."""
    out = {}
    for g, group in enumerate(cache["groups"]):
        if group is None:
            continue
        for ki, kind in enumerate(group):
            if kind is None:
                continue
            flat = jax.tree_util.tree_flatten_with_path(kind)[0]
            for path, x in flat:
                if x.ndim <= 1:  # the fill indices
                    continue
                key = f"g{g}.k{ki}." + ".".join(
                    str(getattr(p, "key", p)) for p in path)
                out[key] = list(x.addressable_shards[0].data.shape[1:])
    return out


def reference_init(out: Path, models) -> None:
    """JAX's initial parameters of every model (``init_sharded`` on one
    device) as ``init_<model>.npz``."""
    from repro.training.step import init_sharded

    for model in models:
        jax, cfg, oc, _, _ = _jax_setup(model)
        params, _, _ = init_sharded(cfg, oc, _jax_mesh(jax, (1, 1)))
        np.savez(out / f"init_{model}.npz",
                 **{f"leaf_{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(params))})


def reference_ckpt(out: Path, models) -> None:
    """A JAX checkpoint of each model after one step on ``CKPT_MESH`` in
    its first reference mode; for the hybrid, the reference's answer on
    its one-layer stacks (``ref_stacks.json``)."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.data import pipeline
    from repro.training.step import make_train_step

    for model in models:
        jax, cfg, oc, params_abs, specs = _jax_setup(model)
        host = jax.tree.unflatten(jax.tree.structure(params_abs),
                                  _leaves(out / f"init_{model}.npz"))
        mesh = _jax_mesh(jax, CKPT_MESH)
        mode = ckpt_mode(model)
        p, o, _, _, _ = _jax_state(jax, oc, params_abs, specs, mesh, mode,
                                   host)
        step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=mode,
                                     donate=False, params_abs=params_abs)
        p, o, _ = step(p, o, next(_data(cfg, pipeline)))
        CheckpointManager(str(out / f"ckpt_ref_{model}")).save(
            1, {"params": p, "opt": o})
    if "hybrid" in models:
        (out / "ref_stacks.json").write_text(json.dumps(
            _reference_one_layer_stacks()))


def _reference_one_layer_stacks() -> dict:
    """The reference's hybrid (4 groups and 2 one-layer stacks) in
    ``tp_fsdp`` on (2, 1) for one step, run as ``launch.train`` runs it
    (no ``params_abs``) and as the dry-run compiles it (``shardings_for
    (..., like=params_abs)``): each run's error or loss, and the layout
    of a one-layer stack's leaves."""
    from repro.data import pipeline
    from repro.training.step import init_sharded, make_train_step

    jax, cfg, oc, params_abs, _ = _jax_setup("hybrid")
    mesh = _jax_mesh(jax, (2, 1))
    res = {}
    for way, kw in (("launch_train", {}),
                    ("params_abs", {"params_abs": params_abs})):
        try:
            p, specs, o = init_sharded(cfg, oc, mesh, mode="tp_fsdp")
            step, psh, _ = make_train_step(cfg, oc, mesh, specs,
                                           mode="tp_fsdp", donate=False,
                                           **kw)
            _, _, met = step(p, o, next(_data(cfg, pipeline)))
            res[way] = {"failed": False, "loss": float(met["loss"]),
                        "tail": [str(tuple(s.spec)) for s in
                                 jax.tree.leaves(psh["groups"][1])]}
        except Exception as e:  # noqa: BLE001 — the failure is the result
            res[way] = {"failed": True,
                        "error": f"{type(e).__name__}: {e}"[:2000]}
    return res


def reference_run(out: Path, n: int, models) -> None:
    """Every run of ``models`` on every mesh of ``n`` devices: 3 train
    steps, the greedy serve, the parameters' and the cache's shard
    shapes."""
    import jax.numpy as jnp
    from repro.data import pipeline
    from repro.models import lm
    from repro.training.step import make_train_step

    for model in models:
        jax, cfg, oc, params_abs, specs = _jax_setup(model)
        host = jax.tree.unflatten(jax.tree.structure(params_abs),
                                  _leaves(out / f"init_{model}.npz"))
        batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else
                                jnp.float32)
                 for k, v in _prompts(cfg).items()}
        cache_abs = jax.eval_shape(
            lambda: lm.init_cache(cfg, BATCH, _cache_len(cfg)))
        for shape in MESHES[n]:
            mesh = _jax_mesh(jax, shape)
            for m, mode in runs_on([model], shape):
                p, o, psh, _, _ = _jax_state(jax, oc, params_abs, specs,
                                             mesh, mode, host)
                shapes = [list(x.addressable_shards[0].data.shape)
                          for x in jax.tree.leaves(p)]
                step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=mode,
                                             donate=False,
                                             params_abs=params_abs)
                data = _data(cfg, pipeline)
                losses, gnorms = [], []
                for _ in range(STEPS):
                    p, o, met = step(p, o, next(data))
                    losses.append(float(met["loss"]))
                    gnorms.append(float(met["grad_norm"]))
                prefill, decode = _jax_serve_steps(jax, cfg, mesh, psh,
                                                   cache_abs, batch, mode)
                sp = jax.tree.map(jax.device_put, host, psh)
                last, cache = prefill(sp, batch, lm.init_cache(
                    cfg, BATCH, _cache_len(cfg)))
                # the tokens go back through the host, uncommitted: the
                # logits' layout is the compiler's choice
                lasts = [np.asarray(last)]
                toks = np.argmax(lasts[-1], -1)[:, None].astype(np.int32)
                out_toks = [toks]
                for _ in range(GEN - 1):
                    logits, cache = decode(sp, toks, cache)
                    lasts.append(np.asarray(logits))
                    toks = np.argmax(lasts[-1], -1)[:, None].astype(np.int32)
                    out_toks.append(toks)
                t = tag(shape, model, mode)
                np.savez(out / f"ref_{t}.npz", loss=np.asarray(losses),
                         grad_norm=np.asarray(gnorms),
                         logits=np.stack(lasts),
                         tokens=np.concatenate(out_toks, axis=1),
                         **{f"leaf_{i}": np.asarray(x) for i, x in
                            enumerate(jax.tree.leaves(p))})
                (out / f"ref_{t}_shapes.json").write_text(json.dumps(
                    {"params": shapes,
                     "cache": _jax_cache_shapes(jax, cache)}))


def reference_layout(out: Path, model: str, shape, mode: str, rows: int,
                     over: dict, prompt: int = PROMPT,
                     decodes: int = DECODES) -> None:
    """The reference's ``_layout_run`` of ``model`` (its smoke config with
    ``over``) from the port's weights in ``layout_init.npz``, over
    ``shape`` in ``mode``: the last logits of ``rows`` prompts of
    ``prompt`` tokens prefilled and decoded ``decodes`` steps, then one
    train step's loss and grad norm, as ``ref_layout.npz``."""
    import jax.numpy as jnp
    from repro.data import pipeline
    from repro.models import lm
    from repro.training.step import make_train_step

    jax, cfg, oc, params_abs, specs = _jax_setup(model, **over)
    host = jax.tree.unflatten(jax.tree.structure(params_abs),
                              _leaves(out / "layout_init.npz"))
    mesh = _jax_mesh(jax, shape)
    p, o, psh, _, _ = _jax_state(jax, oc, params_abs, specs, mesh, mode,
                                 host)
    batch = {k: jnp.asarray(v[:rows, :prompt] if k == "tokens" else v[:rows],
                            jnp.int32 if k == "tokens" else jnp.float32)
             for k, v in _prompts(cfg).items()}
    cache_abs = jax.eval_shape(
        lambda: lm.init_cache(cfg, rows, _cache_len(cfg)))
    prefill, decode = _jax_serve_steps(jax, cfg, mesh, psh, cache_abs, batch,
                                       mode)
    last, cache = prefill(p, batch, lm.init_cache(cfg, rows, _cache_len(cfg)))
    lasts = [np.asarray(last)]
    for _ in range(decodes):
        toks = np.argmax(lasts[-1], -1)[:, None].astype(np.int32)
        logits, cache = decode(p, toks, cache)
        lasts.append(np.asarray(logits))
    step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=mode,
                                 donate=False, params_abs=params_abs)
    _, _, met = step(p, o, next(_data(cfg, pipeline)))
    np.savez(out / "ref_layout.npz", logits=np.stack(lasts),
             loss=np.asarray([float(met["loss"])]),
             grad_norm=np.asarray([float(met["grad_norm"])]))


def reference_reads(out: Path, models) -> None:
    """The reference's ``restore_sharded`` of each model's port checkpoint
    on ``READ_AT``: each leaf, and its sharding."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.distributed.sharding import shardings_for
    from repro.optim.adamw import init_opt_state, opt_state_specs

    report = {}
    for model in models:
        jax, cfg, oc, params_abs, specs = _jax_setup(model)
        shape, mode = READ_AT
        mesh = _jax_mesh(jax, shape)
        psh = shardings_for(specs, mesh, mode, like=params_abs)
        opt_abs = jax.eval_shape(lambda q: init_opt_state(oc, q), params_abs)
        osh = shardings_for(opt_state_specs(oc, specs), mesh, mode,
                            like=opt_abs)
        d = out / f"ckpt_port_{model}"
        tree, _ = CheckpointManager(str(d)).restore_sharded(
            CKPT_STEP, {"params": params_abs, "opt": opt_abs},
            {"params": psh, "opt": osh})
        want = _leaves(d / f"step_{CKPT_STEP:08d}" / "arrays.npz")
        got = jax.tree.leaves(tree)
        sh = jax.tree.leaves({"params": psh, "opt": osh})
        report[model] = {
            "n": len(got), "n_file": len(want),
            "equal": [bool(np.array_equal(np.asarray(g), w) and
                           g.dtype == w.dtype) for g, w in zip(got, want)],
            "placed": [bool(g.sharding.is_equivalent_to(s, g.ndim))
                       for g, s in zip(got, sh)],
            "split": sum(len(g.sharding.device_set) > 1 and
                         not g.sharding.is_fully_replicated for g in got)}
    (out / "ref_reads.json").write_text(json.dumps(report))


# --------------------------------------------------------------------------
# the port, in gloo ranks
# --------------------------------------------------------------------------

def port_params(out: Path, model: str):
    """JAX's initial parameters of ``model`` as the port's, on the CPU."""
    from repro_torch.models import lm
    from repro_torch.models.weights import params_from_numpy

    cfg = cfg_of(model)
    like = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return params_from_numpy(cfg, lm.tree_unflatten(
        like, _leaves(out / f"init_{model}.npz")), "cpu")


def _port_cache_shapes(cache) -> dict:
    """Each cache buffer's local shape (layer 0 of each stack, as every
    layer's buffers are laid out alike), keyed as the reference's."""
    out = {}
    for g, group in enumerate(cache["groups"]):
        if group is None:
            continue
        for ki, kind in enumerate(group[0]):
            if kind is None:
                continue

            def walk(node, path):
                if isinstance(node, dict):
                    for k in sorted(node):
                        walk(node[k], path + [k])
                elif isinstance(node, torch.Tensor):
                    x = node.to_local() if hasattr(node, "to_local") else node
                    out[f"g{g}.k{ki}." + ".".join(path)] = list(x.shape)

            walk(kind, [])
    return out


def greedy(cfg, params, mesh, mode):
    """Prefill the prompts and decode greedily: (last logits of each of
    the GEN steps, tokens, the cache's local shapes), as numpy and
    lists."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_serve_steps, place_cache

    batch = {k: torch.from_numpy(v) for k, v in _prompts(cfg).items()}
    prefill, decode = make_serve_steps(cfg, mesh, mode)
    cache = lm.init_cache(cfg, BATCH, _cache_len(cfg), "cpu")
    if mesh is not None:
        cache = place_cache(cfg, cache, mesh)
    last, cache = prefill(params, batch, cache)
    lasts, toks = [last], torch.argmax(last, -1)[:, None]
    out = [toks]
    for _ in range(GEN - 1):
        last, cache = decode(params, toks, cache)
        lasts.append(last)
        toks = torch.argmax(last, -1)[:, None]
        out.append(toks)
    return (torch.stack(lasts).numpy(), torch.cat(out, 1).numpy(),
            _port_cache_shapes(cache))


def train(cfg, params, opt, mesh, mode, steps=STEPS, strict=True):
    from repro_torch.data import pipeline
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import make_train_step

    step = make_train_step(cfg, OptConfig(**OPT), mesh=mesh, mode=mode,
                           strict=strict)
    data = _data(cfg, pipeline)
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, opt, losses, gnorms


def port_rank(rank: int, world: int, out: str, models) -> None:
    """One gloo rank: every run of ``models`` on every mesh of ``world``
    devices, the held-layer check, the checkpoint restores."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out)
    strided = _watch_strided_layouts()
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store{world}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        report = _port_work(rank, world, out, models)
        report["strided"] = strided
        (out / f"port{world}_r{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _port_work(rank: int, world: int, out: Path, models) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    oc = OptConfig(**OPT)
    hosts = {m: port_params(out, m) for m in models}
    report = {}
    for shape in MESHES[world]:
        mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
        for model, mode in runs_on(models, shape):
            t = tag(shape, model, mode)
            cfg, host = cfg_of(model), hosts[model]
            specs = lm.param_specs(cfg)
            params = distribute(lm.tree_map(torch.clone, host), specs, mesh,
                                mode)
            opt = distribute(init_opt_state(oc, host),
                             opt_state_specs(oc, specs), mesh, mode)
            shapes = [list(x.to_local().shape) for x in lm.tree_leaves(params)]
            params, opt, losses, gnorms = train(cfg, params, opt, mesh, mode)
            final = [_full(x) for x in lm.tree_leaves(params)]
            if (shape, mode) == (CKPT_MESH, ckpt_mode(model)):
                CheckpointManager(str(out / f"ckpt_port_{model}")).save(
                    CKPT_STEP, {"params": params, "opt": opt})
            served = cast_for_compute(cfg, distribute(
                lm.tree_map(torch.clone, host), specs, mesh, mode))
            logits, tokens, cache = greedy(cfg, served, mesh, mode)
            (out / f"port_{t}_shapes_r{rank}.json").write_text(json.dumps(
                {"params": shapes, "cache": cache}))
            if rank == 0:
                np.savez(out / f"port_{t}.npz", loss=np.asarray(losses),
                         grad_norm=np.asarray(gnorms), logits=logits,
                         tokens=tokens,
                         **{f"leaf_{i}": x for i, x in enumerate(final)})
    if world == 4 and "hybrid" in models:
        report["held"] = held_layers(hosts["hybrid"])
    report["restores"] = {
        f"{model}_{src}_{tag(shape, model, mode)}":
            _restore(out, model, src, shape, mode, hosts[model])
        for model in models for src, shape, mode in RESTORES[world]}
    return report


def held_layers(host) -> dict:
    """One remat'd ``tp_fsdp`` train step of the hybrid on ``HELD_MESH``
    with every layer gather watched: per stacked leaf, the most gathered
    layers alive at once, forward and backward, and the step's loss and
    grad norm."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    cfg = cfg_of("hybrid", remat=True)
    oc = OptConfig(**OPT)
    mesh = device_mesh(Mesh(("data", "model"), HELD_MESH), "cpu")
    specs = lm.param_specs(cfg)
    params = distribute(lm.tree_map(torch.clone, host), specs, mesh,
                        "tp_fsdp")
    opt = distribute(init_opt_state(oc, host), opt_state_specs(oc, specs),
                     mesh, "tp_fsdp")
    group = params["groups"][0]
    kinds = {id(a): ki for ki in range(len(group))
             for a in lm.tree_leaves(group[ki])}
    alive, peak = {}, {}
    gather = sharding._LayerGather.forward

    def watched(ctx, stack, i):
        got = gather(ctx, stack, i)
        refs = [r for r in alive.get(id(stack), []) if r() is not None]
        refs.append(weakref.ref(got._local_tensor))
        alive[id(stack)] = refs
        peak[id(stack)] = max(peak.get(id(stack), 0), len(refs))
        return got

    sharding._LayerGather.forward = staticmethod(watched)
    try:
        _, _, losses, gnorms = train(cfg, params, opt, mesh, "tp_fsdp",
                                     steps=1)
    finally:
        sharding._LayerGather.forward = staticmethod(gather)
    return {"peak": sorted(peak.values()), "stacks": len(peak),
            "kinds": sorted({kinds.get(k, -1) for k in peak}),
            "group_leaves": len(kinds),
            "loss": losses[0], "grad_norm": gnorms[0]}


def _restore(out: Path, model: str, src: str, shape, mode, host) -> dict:
    """``model``'s ``src`` checkpoint restored onto ``shape`` in ``mode``:
    each leaf against the file, and its placements against the mode's
    layout."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import placements, shardings_for
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    oc = OptConfig(**OPT)
    specs = lm.param_specs(cfg_of(model))
    mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
    mgr = CheckpointManager(str(out / f"ckpt_{src}_{model}"))
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


def heads_rank(rank: int, world: int, out: str) -> None:
    """One gloo rank of ``HEADS_MESH``: the hybrid with recurrentgemma-2b's
    head layout (10 heads, 1 kv head), whose heads 4 ranks do not split,
    3 steps and the greedy serve in ``tp`` from ``lm.init``'s weights;
    rank 0 also runs them on one device and writes both."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    torch.set_num_threads(1)
    out = Path(out)
    strided = _watch_strided_layouts()
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store_heads", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        cfg = cfg_of("hybrid", **HEADS)
        oc = OptConfig(**OPT)
        host = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        specs = lm.param_specs(cfg)
        mesh = device_mesh(Mesh(("data", "model"), HEADS_MESH), "cpu")
        runs = {}
        for name, m in (("mesh", mesh), ("one", None)):
            if m is None and rank:
                break
            p, o = lm.tree_map(torch.clone, host), init_opt_state(oc, host)
            served = cast_for_compute(cfg, lm.tree_map(torch.clone, host))
            if m is not None:
                p = distribute(p, specs, m, "tp")
                o = distribute(o, opt_state_specs(oc, specs), m, "tp")
                served = distribute(served, specs, m, "tp")
            p, _, losses, gnorms = train(cfg, p, o, m, "tp")
            logits, tokens, _ = greedy(cfg, served, m, "tp")
            runs[name] = {"loss": losses, "grad_norm": gnorms,
                          "params": [_full(x).tolist()
                                     for x in lm.tree_leaves(p)],
                          "logits": logits.tolist(),
                          "tokens": tokens.tolist()}
        if rank == 0:
            runs["strided"] = strided
            (out / "heads.json").write_text(json.dumps(runs))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# orchestration, with deadlines
# --------------------------------------------------------------------------

def _popen(script: Path, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(script), *map(str, args)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _ranks(world: int, out: Path, models):
    import torch.multiprocessing as tmp

    return tmp.start_processes(port_rank, args=(world, str(out), models),
                               nprocs=world, join=False,
                               start_method="spawn")


def serve_rows(cfg, params, mesh, mode: str, rows: int,
               steps: int = DECODES, prompt: int = PROMPT,
               strict: bool = True):
    """``rows`` prompts (the first of ``_prompts``, their first ``prompt``
    tokens) prefilled and decoded greedily for ``steps`` tokens: the last
    logits of each, as numpy.  ``strict`` as for ``check_sharded``: off,
    a stack the data extent does not divide runs as the reference's
    dry-run lays it out ('embed' over 'data')."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_serve_steps, place_cache

    batch = {k: torch.from_numpy(v[:rows, :prompt] if k == "tokens"
                                 else v[:rows])
             for k, v in _prompts(cfg).items()}
    prefill, decode = make_serve_steps(cfg, mesh, mode, strict)
    cache = lm.init_cache(cfg, rows, _cache_len(cfg), "cpu")
    if mesh is not None:
        cache = place_cache(cfg, cache, mesh)
    with phase("prefill"):
        last, cache = prefill(params, batch, cache)
    lasts = [last]
    with phase("decode"):
        for _ in range(steps):
            last, cache = decode(params, torch.argmax(last, -1)[:, None],
                                 cache)
            lasts.append(last)
    return np.stack([_full(x) for x in lasts])


def _layout_run(cfg, host, mesh, mode: str, rows: int,
                serve=(PROMPT, DECODES), strict: bool = True) -> dict:
    """``serve_rows`` (prompts of ``serve[0]`` tokens, ``serve[1]`` decode
    steps) and one train step (loss, grad norm) of ``cfg`` from the
    weights ``host``, over ``mesh`` in ``mode`` (None: one device);
    ``strict`` as for ``serve_rows``."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)

    oc, specs = OptConfig(**OPT), lm.param_specs(cfg)
    params, opt = lm.tree_map(torch.clone, host), init_opt_state(oc, host)
    if mesh is not None:
        opt = distribute(opt, opt_state_specs(oc, specs), mesh, mode)
        params = distribute(params, specs, mesh, mode)
    logits = serve_rows(cfg, params, mesh, mode, rows, steps=serve[1],
                        prompt=serve[0], strict=strict)
    with phase("train"):
        _, _, losses, gnorms = train(cfg, params, opt, mesh, mode, steps=1,
                                     strict=strict)
    return {"logits": logits, "loss": np.asarray(losses),
            "grad_norm": np.asarray(gnorms)}


# the step that ``attended`` counts for: "prefill" and "decode" inside
# ``serve_rows``, "train" elsewhere
PHASES = ("prefill", "decode", "train")
_PHASE = ["train"]
Q_CHUNK = 512  # the attention's q chunk (``layers.flash_attention``)


@contextlib.contextmanager
def phase(name: str):
    """Count the attention's triples inside as ``name``'s."""
    prev, _PHASE[0] = _PHASE[0], name
    try:
        yield
    finally:
        _PHASE[0] = prev


def row_share(rows: int, parts: int) -> Fraction:
    """The share of one device's (row, head, key) triples in a step of
    ``rows`` rows that one of ``parts`` ranks splitting its rows runs
    (``layers._share``): each q chunk's rows padded up to a multiple of
    ``parts``."""
    q_chunk = min(Q_CHUNK, rows)
    return Fraction(-(-q_chunk // parts), q_chunk)


@contextlib.contextmanager
def attended(count: list):
    """Adds to ``count[PHASES.index(step)]`` the (q row, q head, key)
    triples of every block of q rows that the attention's forward runs in
    this process during each step (``phase``): ``layers._chunk_online``,
    by its operands' shapes, a rank's rows and its keys."""
    from repro_torch.models import layers

    inner = layers._chunk_online

    def counted(q, k, v, cfgt, qi, scale):
        B, _, Hkv, rep, _ = q.shape
        count[PHASES.index(_PHASE[0])] += (B * Hkv * rep * cfgt.q_chunk
                                           * k.shape[1])
        return inner(q, k, v, cfgt, qi, scale)

    layers._chunk_online = counted
    try:
        yield
    finally:
        layers._chunk_online = inner


def layout_rank(rank: int, world: int, out: str, model: str, shape,
                mode: str, rows: int, over: dict,
                serve=(PROMPT, DECODES), strict: bool = True) -> None:
    """One gloo rank of ``_layout_run`` over ``shape`` (data, model) from
    seeded weights; rank 0 writes the results, with the (row, head, key)
    triples its attention ran (``attended``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm

    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store_layout", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        cfg = cfg_of(model, **over)
        mesh = device_mesh(Mesh(("data", "model"), tuple(shape)), "cpu")
        host = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        count = [0] * len(PHASES)
        with attended(count):
            got = _layout_run(cfg, host, mesh, mode, rows, serve, strict)
        if rank == 0:
            np.savez(out / "layout.npz", attended=np.asarray(count), **got)
    finally:
        dist.destroy_process_group()


def modes_rank(rank: int, world: int, out: str, model: str, shape,
               modes, rows: int, over: dict,
               serve=(PROMPT, DECODES)) -> None:
    """One gloo rank serving ``model`` (its smoke config with ``over``)
    over ``shape`` in each of ``modes`` from the same seeded weights, cast
    to the compute dtype once as ``launch.serve`` casts them, the dry-run's
    layouts (``strict`` off); rank 0 writes each mode's last logits
    (``serve_rows``) to ``modes.npz``."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute

    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store_modes", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        cfg = cfg_of(model, **over)
        mesh = device_mesh(Mesh(("data", "model"), tuple(shape)), "cpu")
        host = cast_for_compute(cfg, lm.init(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        got = {mode: serve_rows(cfg, distribute(host, lm.param_specs(cfg),
                                                mesh, mode),
                                mesh, mode, rows, steps=serve[1],
                                prompt=serve[0], strict=False)
               for mode in modes}
        if rank == 0:
            np.savez(out / "modes.npz", **got)
    finally:
        dist.destroy_process_group()


def serve_modes(tmp: Path, model: str, shape, modes, rows: int,
                serve=(PROMPT, DECODES), **over) -> dict:
    """``modes_rank`` on 4 gloo ranks: each mode's last logits, (steps + 1,
    rows, vocab) f32."""
    import torch.multiprocessing as mp

    _join(mp.start_processes(modes_rank, args=(4, str(tmp), model, shape,
                                               modes, rows, over, serve),
                             nprocs=4, join=False, start_method="spawn"),
          time.monotonic() + DEADLINE_S)
    return _load(tmp / "modes.npz")


def check_layout(script: Path, tmp: Path, model: str, shape, mode: str,
                 rows: int, serve=(PROMPT, DECODES), split=0,
                 strict: bool = True, **over) -> None:
    """``model`` (its smoke config with ``over``) from ``lm.init``'s
    weights, served for ``rows`` prompts (``serve``: their length and
    the decode steps after them) and trained one step over ``shape`` in
    ``mode`` on 4 gloo ranks: the last logits, the loss and the grad norm
    equal the reference's on the same mesh (a subprocess of ``script``
    with 4 host devices, from the same weights) and one device's, within
    ``TOL``.  With ``split``, rank 0's attention ran exactly 1/``split``
    of the (row, head, key) triples one device's ran (``attended``) in
    each step, or, given a dict, each step's share (a Fraction) of
    ``PHASES``' steps it names.
    ``strict`` as for ``serve_rows``."""
    import torch.multiprocessing as mp
    from repro_torch.models import lm

    cfg = cfg_of(model, **over)
    host = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    np.savez(tmp / "layout_init.npz",
             **{f"leaf_{i}": x.numpy()
                for i, x in enumerate(lm.tree_leaves(host))})
    deadline = time.monotonic() + DEADLINE_S
    ref = _popen(script, "reference-layout", tmp, model,
                 f"{shape[0]}x{shape[1]}", mode, rows, json.dumps(over),
                 *serve)
    try:
        _join(mp.start_processes(layout_rank, args=(4, str(tmp), model,
                                                    shape, mode, rows, over,
                                                    serve, strict),
                                 nprocs=4, join=False, start_method="spawn"),
              deadline)
        alone = [0] * len(PHASES)
        with attended(alone):
            one = _layout_run(cfg, host, None, mode, rows, serve)
        _finish(ref, deadline)
    finally:
        if ref.poll() is None:
            os.killpg(ref.pid, signal.SIGKILL)
    got = _load(tmp / "layout.npz")
    for name, want in (("reference", _load(tmp / "ref_layout.npz")),
                       ("one device", one)):
        for key in one:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{key}, {name}")
    shares = (split if isinstance(split, dict) else
              dict.fromkeys(PHASES, Fraction(1, split)) if split else {})
    for step, share in shares.items():
        i = PHASES.index(step)
        assert int(got["attended"][i]) == alone[i] * share, (
            step, int(got["attended"][i]), alone[i], share)


def run_all(script: Path, out: Path, models) -> Path:
    """Run the reference (subprocesses of ``script``) and the port (gloo
    ranks) for ``models``; the directory of their results."""
    deadline = time.monotonic() + DEADLINE_S
    _finish(_popen(script, "reference-init", out, *models), deadline)
    ckpt = _popen(script, "reference-ckpt", out, *models)
    procs = [ckpt] + [_popen(script, "reference", out, n, model)
                      for n in (2, 4) for model in models]
    try:
        _join(_ranks(4, out, models), deadline)
        procs.append(_popen(script, "reference-reads", out, *models))
        _finish(ckpt, deadline)
        _join(_ranks(2, out, models), deadline)
        for proc in procs:
            _finish(proc, deadline)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
    return out


def one_device(out: Path, models) -> dict:
    """The one-device port from JAX's weights, per model: the 3 steps, the
    greedy serve, and one remat'd step for the held-layer run."""
    from repro_torch.models import lm
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import OptConfig, init_opt_state

    res = {}
    for model in models:
        cfg, host = cfg_of(model), port_params(out, model)
        served = cast_for_compute(cfg, lm.tree_map(torch.clone, host))
        params = lm.tree_map(torch.clone, host)
        trained, _, losses, gnorms = train(
            cfg, params, init_opt_state(OptConfig(**OPT), params), None,
            "tp")
        logits, tokens, _ = greedy(cfg, served, None, "tp")
        res[model] = {"loss": np.asarray(losses),
                      "grad_norm": np.asarray(gnorms),
                      "params": [_full(x) for x in lm.tree_leaves(trained)],
                      "logits": logits, "tokens": tokens}
        if model == "hybrid":
            params = lm.tree_map(torch.clone, host)
            _, _, rl, rg = train(cfg_of(model, remat=True), params,
                                 init_opt_state(OptConfig(**OPT), params),
                                 None, "tp", steps=1)
            res[model].update(remat_loss=rl[0], remat_grad_norm=rg[0])
    return res


def report(runs: Path, world: int, rank: int) -> dict:
    return json.loads((runs / f"port{world}_r{rank}.json").read_text())


def main(argv) -> None:
    cmd, out = argv[1], Path(argv[2])
    if cmd == "reference-init":
        reference_init(out, argv[3:])
    elif cmd == "reference-ckpt":
        reference_ckpt(out, argv[3:])
    elif cmd == "reference":
        reference_run(out, int(argv[3]), argv[4:])
    elif cmd == "reference-reads":
        reference_reads(out, argv[3:])
    elif cmd == "reference-layout":
        reference_layout(out, argv[3], tuple(map(int, argv[4].split("x"))),
                         argv[5], int(argv[6]), json.loads(argv[7]),
                         *map(int, argv[8:10]))
    else:
        raise SystemExit(f"unknown command {cmd!r}")


# --------------------------------------------------------------------------
# the checks each test file runs for its models
# --------------------------------------------------------------------------

def check_train(runs, shape, model, mode) -> None:
    got = _load(runs / f"port_{tag(shape, model, mode)}.npz")
    want = _load(runs / f"ref_{tag(shape, model, mode)}.npz")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                   err_msg=key)
    assert len(got["params"]) == len(want["params"])
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=str(i))


def check_serve(runs, shape, model, mode) -> None:
    got = _load(runs / f"port_{tag(shape, model, mode)}.npz")
    want = _load(runs / f"ref_{tag(shape, model, mode)}.npz")
    assert got["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                               atol=TOL)


def check_shapes(runs, shape, model, mode) -> None:
    """Each rank's local shard of every parameter and of every cache
    buffer has the shape of JAX's shard on the same mesh."""
    t = tag(shape, model, mode)
    want = json.loads((runs / f"ref_{t}_shapes.json").read_text())
    assert want["cache"]
    for r in range(shape[0] * shape[1]):
        got = json.loads((runs / f"port_{t}_shapes_r{r}.json").read_text())
        assert got["params"] == want["params"], f"rank {r}"
        assert got["cache"] == want["cache"], f"rank {r}"


def check_one_device(runs, one, shape, model, mode) -> None:
    got = _load(runs / f"port_{tag(shape, model, mode)}.npz")
    one = one[model]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], one[key], rtol=TOL,
                                   err_msg=key)
    for a, b in zip(got["params"], one["params"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    np.testing.assert_allclose(got["logits"], one["logits"], rtol=TOL,
                               atol=TOL)


def restore_keys(models) -> list:
    return [(w, f"{model}_{src}_{tag(shape, model, mode)}")
            for model in models for w in (4, 2)
            for src, shape, mode in RESTORES[w]]


def check_restore(runs, world, key) -> None:
    for r in range(world):
        rep = report(runs, world, r)["restores"][key]
        assert rep["n"] == rep["n_file"] > 0 and rep["split"] > 0
        assert all(rep["equal"]) and all(rep["placed"]), r


def check_reference_reads(runs, model) -> None:
    rep = json.loads((runs / "ref_reads.json").read_text())[model]
    assert rep["n"] == rep["n_file"] > 0 and rep["split"] > 0
    assert all(rep["equal"]) and all(rep["placed"])


def check_not_strided(runs, world) -> None:
    for r in range(world):
        assert report(runs, world, r)["strided"] == [], f"rank {r}"


def launch(module: str, *args, cwd: Path, nproc: int = 2) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *map(str, args)],
        env=_env(), cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def check_launchers(tmp_path: Path, arch, mode, mp, resume_mode,
                    resume_mp) -> None:
    """``launch.train --mode`` over 2 gloo ranks prints the mesh, trains
    and checkpoints, and resumes in another mode on another mesh;
    ``launch.serve`` in the mode gives the single-process run's tokens."""
    from repro_torch.launch import serve

    def train_args(mode, mp, steps, json_path=None):
        return (["--arch", arch, "--smoke", "--global-batch", "4",
                 "--seq-len", "32", "--device", "cpu", "--model-parallel",
                 str(mp), "--mode", mode, "--steps", str(steps),
                 "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir",
                 str(tmp_path / "ckpt")]
                + ([] if json_path is None else ["--json", str(json_path)]))

    serve_args = ["--arch", arch, "--smoke", "--batch", "4", "--prompt-len",
                  "16", "--gen", "4", "--device", "cpu"]
    deadline = time.monotonic() + DEADLINE_S
    trained = launch("repro_torch.launch.train",
                     *train_args(mode, mp, 2, tmp_path / "t.json"),
                     cwd=tmp_path)
    served = launch("repro_torch.launch.serve", *serve_args,
                    "--model-parallel", mp, "--mode", mode, "--json",
                    tmp_path / "s.json", cwd=tmp_path)
    log = _output(trained, deadline)
    assert f"mesh: {{'data': {2 // mp}, 'model': {mp}}} devices=2" in log
    assert log.count("done at step 2") == 1
    rep = json.loads((tmp_path / "t.json").read_text())
    assert rep["mode"] == mode and len(rep["loss"]) == 2
    assert all(np.isfinite(rep["loss"]))
    log = _output(launch("repro_torch.launch.train",
                         *train_args(resume_mode, resume_mp, 3),
                         cwd=tmp_path), deadline)
    assert "resumed from step 2" in log and "done at step 3" in log
    _output(served, deadline)
    want = serve.main(serve_args)
    got = json.loads((tmp_path / "s.json").read_text())
    assert got["mode"] == mode
    np.testing.assert_array_equal(np.asarray(got["tokens"]), want)
