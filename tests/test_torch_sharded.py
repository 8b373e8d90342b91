"""The sharded path against the JAX reference on 2 and 4 host devices.

The smoke qwen1.5-0.5b in f32 trains 3 AdamW steps at global batch 4 x 32
and serves a prefill of 16 and 4 greedy tokens, in modes ``tp`` and
``dp``, on the meshes (data, model) (2, 1) and (1, 2) of 2 devices and
(2, 2), (4, 1) and (1, 4) of 4.

- The reference runs in subprocesses of this file (``python
  tests/test_torch_sharded.py reference ...``), which set
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before they
  import jax; the suite's own process keeps its one device.  The first
  writes JAX's initial parameters and a JAX checkpoint; the others run
  every mesh of 2 and of 4 devices, and read the port's checkpoint.
- The port runs in gloo ranks started with
  ``torch.multiprocessing.start_processes`` (one group of 2, one of 4),
  each joining through a file store under the test's temporary directory,
  so parallel test workers never contend for a port.  The ranks load
  JAX's weights through ``models.weights.params_from_numpy``.
- Every process has a deadline: a hung rank or subprocess is killed and
  fails the tests, it does not hang the suite.

Tolerances: per-step loss and grad norm, and the parameters after 3 steps,
1e-4 (``tests/test_torch_train.py``'s 3-step tolerance; the reference's
own meshes disagree at 4e-5 relative, reduction order); greedy tokens
equal, last logits 1e-4 (f32); shard shapes, checkpoints and
``quantized_psum`` exact.
"""
from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
MODES = ("tp", "dp")
CASES = [(shape, mode) for n in (2, 4) for shape in MESHES[n]
         for mode in MODES]
IDS = [f"{s[0]}x{s[1]}-{m}" for s, m in CASES]
STEPS, BATCH, SEQ, PROMPT, GEN = 3, 4, 32, 16, 4
OPT = dict(lr=1e-3, warmup=2, decay_steps=50)
TOL = 1e-4
PSUM_SIZE = 300  # per participant: not a whole number of 256-blocks
CKPT_STEP = STEPS
DEADLINE_S = 600  # every subprocess and group of ranks (~65 s is usual)
GROUP_TIMEOUT_S = 60


def _tag(shape, mode) -> str:
    return f"{shape[0]}x{shape[1]}_{mode}"


def _env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _leaves(path: Path) -> list:
    with np.load(path) as f:
        return [f[f"leaf_{i}"] for i in range(
            sum(k.startswith("leaf_") for k in f.files))]


# --------------------------------------------------------------------------
# the reference, in subprocesses with 4 host devices
# --------------------------------------------------------------------------

def _jax_setup():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    from repro.configs import get_config
    from repro.optim.adamw import OptConfig
    from repro.training.step import _abstract_init

    cfg = get_config("qwen1.5-0.5b", smoke=True).scaled(dtype="float32")
    params_abs, specs = _abstract_init(cfg, jax.random.PRNGKey(0))
    return jax, cfg, OptConfig(**OPT), params_abs, specs


def _jax_mesh(jax, shape):
    from jax.sharding import AxisType, Mesh

    n = shape[0] * shape[1]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _jax_opt_shardings(jax, cfg, oc, params_abs, specs, mesh, mode):
    from repro.distributed.sharding import shardings_for
    from repro.optim.adamw import init_opt_state, opt_state_specs

    opt_abs = jax.eval_shape(lambda p: init_opt_state(oc, p), params_abs)
    return opt_abs, shardings_for(opt_state_specs(oc, specs), mesh, mode,
                                  like=opt_abs)


def reference_init(out: Path) -> None:
    """JAX's initial parameters (``init_sharded`` on one device) as
    ``init.npz``, and a JAX checkpoint of them and their optimizer state
    after one step on (1, 2) ``tp``."""
    jax, cfg, oc, params_abs, specs = _jax_setup()
    from repro.checkpoint.manager import CheckpointManager
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.distributed.sharding import shardings_for
    from repro.training.step import init_sharded, make_train_step

    params, _, _ = init_sharded(cfg, oc, _jax_mesh(jax, (1, 1)))
    np.savez(out / "init.npz", **{f"leaf_{i}": np.asarray(x) for i, x in
                                  enumerate(jax.tree.leaves(params))})
    mesh = _jax_mesh(jax, (1, 2))
    host = jax.tree.map(np.asarray, params)
    p = jax.tree.map(jax.device_put, host,
                     shardings_for(specs, mesh, "tp", like=params_abs))
    _, osh = _jax_opt_shardings(jax, cfg, oc, params_abs, specs, mesh, "tp")
    from repro.optim.adamw import init_opt_state
    o = jax.jit(lambda q: init_opt_state(oc, q), out_shardings=osh)(p)
    step, _, _ = make_train_step(cfg, oc, mesh, specs, mode="tp",
                                 donate=False, params_abs=params_abs)
    data = SyntheticTokens(DataConfig(global_batch=BATCH, seq_len=SEQ,
                                      vocab=cfg.vocab))
    p, o, _ = step(p, o, next(data))
    CheckpointManager(str(out / "ckpt_ref")).save(1, {"params": p, "opt": o})


def reference_run(out: Path, n: int) -> None:
    """Every mesh of ``n`` devices in both modes: 3 train steps, the
    greedy serve, the parameters' shard shapes; and ``quantized_psum``
    over ``n`` participants."""
    jax, cfg, oc, params_abs, specs = _jax_setup()
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.distributed.compression import quantized_psum
    from repro.distributed.sharding import shardings_for
    from repro.models import lm
    from repro.serving.engine import make_serve_steps
    from repro.training.step import make_train_step

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    host = jax.tree.unflatten(jax.tree.structure(params_abs),
                              _leaves(out / "init.npz"))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    for shape in MESHES[n]:
        mesh = _jax_mesh(jax, shape)
        for mode in MODES:
            psh = shardings_for(specs, mesh, mode, like=params_abs)
            params = jax.tree.map(jax.device_put, host, psh)
            shapes = [list(x.addressable_shards[0].data.shape)
                      for x in jax.tree.leaves(params)]
            from repro.optim.adamw import init_opt_state
            _, osh = _jax_opt_shardings(jax, cfg, oc, params_abs, specs,
                                        mesh, mode)
            opt = jax.jit(lambda q: init_opt_state(oc, q),
                          out_shardings=osh)(params)
            step, _, _ = make_train_step(cfg, oc, mesh, specs, mode=mode,
                                         donate=False,
                                         params_abs=params_abs)
            data = SyntheticTokens(DataConfig(
                global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab))
            p, o, losses, gnorms = params, opt, [], []
            for _ in range(STEPS):
                p, o, m = step(p, o, next(data))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
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
            tag = _tag(shape, mode)
            np.savez(out / f"ref_{tag}.npz", loss=np.asarray(losses),
                     grad_norm=np.asarray(gnorms),
                     logits=np.stack(lasts),
                     tokens=np.concatenate(out_toks, axis=1),
                     **{f"leaf_{i}": np.asarray(x) for i, x in
                        enumerate(jax.tree.leaves(p))})
            (out / f"ref_{tag}_shapes.json").write_text(json.dumps(shapes))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("d",))
    x = np.random.default_rng(5).normal(size=(n * PSUM_SIZE,)).astype(
        np.float32)
    got = shard_map(lambda v: quantized_psum(v, "d"), mesh=mesh,
                    in_specs=PartitionSpec("d"),
                    out_specs=PartitionSpec("d"))(jnp.asarray(x))
    np.savez(out / f"psum_{n}.npz", x=x, out=np.asarray(got))


def reference_reads(out: Path) -> None:
    """The reference's ``restore_sharded`` of the port's (2, 2) ``tp``
    checkpoint on its own (1, 2) mesh: each leaf, and its sharding."""
    jax, cfg, oc, params_abs, specs = _jax_setup()
    from repro.checkpoint.manager import CheckpointManager
    from repro.distributed.sharding import shardings_for

    mesh = _jax_mesh(jax, (1, 2))
    psh = shardings_for(specs, mesh, "tp", like=params_abs)
    opt_abs, osh = _jax_opt_shardings(jax, cfg, oc, params_abs, specs, mesh,
                                      "tp")
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
                   for g, s in zip(got, sh)]}))


# --------------------------------------------------------------------------
# the port, in gloo ranks
# --------------------------------------------------------------------------

def _port_setup():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config("qwen1.5-0.5b", smoke=True).scaled(dtype="float32")
    return cfg, OptConfig(**OPT), lm, params_from_numpy


def _port_params(out: Path):
    """JAX's initial parameters as the port's, on the CPU."""
    cfg, _, lm, params_from_numpy = _port_setup()
    like = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return params_from_numpy(cfg, lm.tree_unflatten(
        like, _leaves(out / "init.npz")), "cpu")


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


def _train(cfg, oc, params, opt, mesh, mode):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.training.step import make_train_step

    step = make_train_step(cfg, oc, mesh=mesh, mode=mode)
    data = SyntheticTokens(DataConfig(global_batch=BATCH, seq_len=SEQ,
                                      vocab=cfg.vocab))
    losses, gnorms = [], []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, opt, losses, gnorms


def _full(x) -> np.ndarray:
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach() \
        .numpy()


def _port_rank(rank: int, world: int, out: str) -> None:
    """One gloo rank: every mesh of ``world`` devices in both modes, the
    checkpoint restores, and ``quantized_psum`` over the world."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out)
    strided = _watch_strided_layouts()
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store{world}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        _port_work(rank, world, out)
        (out / f"port{world}_r{rank}_strided.json").write_text(
            json.dumps(strided))
    finally:
        dist.destroy_process_group()


def _watch_strided_layouts() -> list:
    """Record every DTensor made with a strided shard: a product that
    flattens a split sequence into its rows makes one, and older torch
    releases refuse that reshape instead."""
    from torch.distributed.tensor import DTensor

    seen, new = [], DTensor.__new__

    def watched(cls, local, spec, **kw):
        if any(type(p).__name__ == "_StridedShard" for p in spec.placements):
            seen.append(str(spec.placements))
        return new(cls, local, spec, **kw)

    DTensor.__new__ = staticmethod(watched)
    return seen


def _port_work(rank: int, world: int, out: Path) -> None:
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.compression import quantized_psum
    from repro_torch.distributed.sharding import distribute, shardings_for
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import init_opt_state, opt_state_specs

    cfg, oc, lm, _ = _port_setup()
    host = _port_params(out)
    specs = lm.param_specs(cfg)

    def fresh():
        return lm.tree_map(torch.clone, host)

    for shape in MESHES[world]:
        mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
        for mode in MODES:
            tag = _tag(shape, mode)
            params = distribute(fresh(), specs, mesh, mode)
            opt = distribute(init_opt_state(oc, host),
                             opt_state_specs(oc, specs), mesh, mode)
            shapes = [list(x.to_local().shape)
                      for x in lm.tree_leaves(params)]
            (out / f"port_{tag}_shapes_r{rank}.json").write_text(
                json.dumps(shapes))
            params, opt, losses, gnorms = _train(cfg, oc, params, opt, mesh,
                                                 mode)
            final = [_full(x) for x in lm.tree_leaves(params)]
            if (shape, mode) == ((2, 2), "tp"):
                CheckpointManager(str(out / "ckpt_port")).save(
                    CKPT_STEP, {"params": params, "opt": opt})
            served = cast_for_compute(cfg, distribute(fresh(), specs, mesh,
                                                      mode))
            logits, tokens = _greedy(cfg, served, mesh, mode)
            if rank == 0:
                np.savez(out / f"port_{tag}.npz", loss=np.asarray(losses),
                         grad_norm=np.asarray(gnorms), logits=logits,
                         tokens=tokens,
                         **{f"leaf_{i}": x for i, x in enumerate(final)})
    # checkpoints across meshes: the reference's on (2, 2) tp; the port's
    # (2, 2) tp one onto (1, 2) tp and (2, 1) dp
    restores = ([("ref", (2, 2), "tp")] if world == 4 else
                [("port", (1, 2), "tp"), ("port", (2, 1), "dp")])
    report = {}
    for src, shape, mode in restores:
        mesh = device_mesh(Mesh(("data", "model"), shape), "cpu")
        mgr = CheckpointManager(str(out / f"ckpt_{src}"))
        step = mgr.latest_step()
        params, opt = fresh(), init_opt_state(oc, host)
        sh = {"params": shardings_for(specs, mesh, mode, like=params),
              "opt": shardings_for(opt_state_specs(oc, specs), mesh, mode,
                                   like=opt)}
        like = {"params": params, "opt": opt}
        tree, _ = mgr.restore_sharded(step, like, sh)
        want, _ = mgr.restore(step, like)
        got_l, want_l = lm.tree_leaves(tree), lm.tree_leaves(want)
        report[f"{src}_{_tag(shape, mode)}"] = {
            "n": len(got_l), "n_file": len(want_l),
            "equal": [bool(np.array_equal(_full(g), w)
                           and _full(g).dtype == w.dtype)
                      for g, w in zip(got_l, want_l)],
            "placed": [list(map(str, g.placements)) == list(map(
                str, _placements(s))) for g, s in
                zip(got_l, _sharding_leaves(lm, tree, sh))]}
    if world == 4:
        report["gqa"] = _gqa_case(cfg, oc, lm)
    x = np.random.default_rng(5).normal(size=(world * PSUM_SIZE,)).astype(
        np.float32)
    mine = torch.from_numpy(x[rank * PSUM_SIZE:(rank + 1) * PSUM_SIZE])
    report["psum"] = quantized_psum(mine, dist.group.WORLD).tolist()
    (out / f"port{world}_r{rank}.json").write_text(json.dumps(report))


def _gqa_case(cfg, oc, lm) -> dict:
    """2 kv heads on a 'model' axis of 4 (``tp``, mesh (1, 4)): the kv
    projections' column shards split heads and are gathered before the
    head reshape, the attention core runs on whole heads, and the KV cache
    shards its sequence over 'model' (each rank writes the rows in its
    range).  One train step and the greedy serve, against the same run on
    one device."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.optim.adamw import init_opt_state, opt_state_specs
    from repro_torch.training.step import init

    gqa = cfg.scaled(n_kv_heads=2)
    mesh = device_mesh(Mesh(("data", "model"), (1, 4)), "cpu")
    host, _ = init(gqa, None, "cpu")
    specs = lm.param_specs(gqa)

    def fresh():
        return lm.tree_map(torch.clone, host)

    def one(m):
        p, o = fresh(), init_opt_state(oc, host)
        if m is not None:
            p = distribute(p, specs, m, "tp")
            o = distribute(o, opt_state_specs(oc, specs), m, "tp")
        _, _, losses, _ = _train(gqa, oc, p, o, m, "tp")
        served = fresh() if m is None else distribute(fresh(), specs, m,
                                                      "tp")
        logits, tokens = _greedy(gqa, served, m, "tp")
        return losses, logits, tokens

    (l1, g1, t1), (l0, g0, t0) = one(mesh), one(None)
    return {"loss": [l1, l0], "logits_diff": float(np.abs(g1 - g0).max()),
            "tokens_equal": bool((t1 == t0).all())}


def _placements(s):
    from repro_torch.distributed.sharding import placements

    return placements(s.spec, s.mesh)


def _sharding_leaves(lm, tree, shardings) -> list:
    return [s for _, s in lm.tree_zip(tree, shardings)]


# --------------------------------------------------------------------------
# orchestration, with deadlines
# --------------------------------------------------------------------------

def _popen(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(HERE), *map(str, args)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc: subprocess.Popen, deadline: float) -> None:
    """Wait for ``proc`` until ``deadline`` (monotonic); kill its group
    and fail if it is still running or failed."""
    try:
        log, _ = proc.communicate(timeout=max(deadline - time.monotonic(),
                                              1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{proc.args} passed its deadline:\n"
                             f"{log[-4000:]}")
    assert proc.returncode == 0, f"{proc.args} failed:\n{log[-4000:]}"


def _ranks(world: int, out: Path):
    import torch.multiprocessing as tmp

    return tmp.start_processes(_port_rank, args=(world, str(out)),
                               nprocs=world, join=False,
                               start_method="spawn")


def _join(ctx, deadline: float) -> None:
    """Join the ranks until ``deadline``; a rank that raised fails here,
    and ranks still running at the deadline are killed."""
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise AssertionError("a rank passed its deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference and the port; the directory of their results."""
    out = tmp_path_factory.mktemp("sharded")
    deadline = time.monotonic() + DEADLINE_S
    _finish(_popen("reference-init", out), deadline)
    procs = [_popen("reference", out, n) for n in (2, 4)]
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
    """The one-device port from JAX's weights: {"train": ..., "serve":
    ...}."""
    from repro_torch.models.weights import cast_for_compute
    from repro_torch.optim.adamw import init_opt_state

    cfg, oc, lm, _ = _port_setup()
    params = _port_params(runs)
    served = cast_for_compute(cfg, lm.tree_map(torch.clone, params))
    params, _, losses, gnorms = _train(cfg, oc, params,
                                       init_opt_state(oc, params), None,
                                       "tp")
    logits, tokens = _greedy(cfg, served, None, "tp")
    return {"loss": np.asarray(losses), "grad_norm": np.asarray(gnorms),
            "params": [_full(x) for x in lm.tree_leaves(params)],
            "logits": logits, "tokens": tokens}


def _load(path: Path) -> dict:
    with np.load(path) as f:
        d = {k: f[k] for k in f.files if not k.startswith("leaf_")}
    d["params"] = _leaves(path)
    return d


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_train_steps_match_reference_on_the_same_mesh(runs, shape, mode):
    got = _load(runs / f"port_{_tag(shape, mode)}.npz")
    want = _load(runs / f"ref_{_tag(shape, mode)}.npz")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                   err_msg=key)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_greedy_serve_matches_reference_on_the_same_mesh(runs, shape, mode):
    got = _load(runs / f"port_{_tag(shape, mode)}.npz")
    want = _load(runs / f"ref_{_tag(shape, mode)}.npz")
    assert got["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_every_rank_holds_the_reference_shard_shapes(runs, shape, mode):
    """Each rank's local shard of every parameter has the shape of JAX's
    shard on the same mesh: nothing is replicated that the reference
    shards (a full parameter on every rank would show here)."""
    tag = _tag(shape, mode)
    want = json.loads((runs / f"ref_{tag}_shapes.json").read_text())
    for r in range(shape[0] * shape[1]):
        got = json.loads((runs / f"port_{tag}_shapes_r{r}.json")
                         .read_text())
        assert got == want, f"rank {r}"
    if mode == "tp" and shape[1] > 1:
        whole = json.loads((runs / f"ref_{_tag(shape, 'dp')}_shapes.json")
                           .read_text())
        assert any(g != w for g, w in zip(want, whole))


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_sharded_port_equals_one_device_port(runs, one_device, shape,
                                             mode):
    got = _load(runs / f"port_{_tag(shape, mode)}.npz")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], one_device[key], rtol=TOL,
                                   err_msg=key)
    for a, b in zip(got["params"], one_device["params"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["tokens"], one_device["tokens"])
    np.testing.assert_allclose(got["logits"], one_device["logits"],
                               rtol=TOL, atol=TOL)


def _restore_report(runs: Path, world: int, key: str) -> list:
    reports = [json.loads((runs / f"port{world}_r{r}.json").read_text())
               [key] for r in range(world)]
    return reports


@pytest.mark.parametrize("key", ["port_1x2_tp", "port_2x1_dp"])
def test_port_checkpoint_restores_bitwise_across_meshes(runs, key):
    """The (2, 2) ``tp`` checkpoint restored onto (1, 2) ``tp`` and (2, 1)
    ``dp``: every leaf equal bit for bit, and placed by the new mesh's
    layout, on every rank."""
    for rep in _restore_report(runs, 2, key):
        assert rep["n"] == rep["n_file"] > 0
        assert all(rep["equal"]) and all(rep["placed"])


def test_port_checkpoint_restores_bitwise_on_one_device(runs):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import init_opt_state

    cfg, oc, lm, _ = _port_setup()
    params = _port_params(runs)
    like = {"params": params, "opt": init_opt_state(oc, params)}
    mgr = CheckpointManager(str(runs / "ckpt_port"))
    tree, _ = mgr.restore_to(CKPT_STEP, like, "cpu")
    want = _leaves(runs / "ckpt_port" / f"step_{CKPT_STEP:08d}" /
                   "arrays.npz")
    got = lm.tree_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    final = _load(runs / "port_2x2_tp.npz")["params"]
    for g, w in zip(lm.tree_leaves(tree["params"]), final):
        np.testing.assert_array_equal(g.numpy(), w)


def test_reference_restore_sharded_reads_the_port_checkpoint(runs):
    rep = json.loads((runs / "ref_reads.json").read_text())
    assert rep["n"] == rep["n_file"] > 0
    assert all(rep["equal"]) and all(rep["placed"])


def test_port_restore_sharded_reads_the_reference_checkpoint(runs):
    for rep in _restore_report(runs, 4, "ref_2x2_tp"):
        assert rep["n"] == rep["n_file"] > 0
        assert all(rep["equal"]) and all(rep["placed"])


@pytest.mark.parametrize("world", [2, 4])
def test_no_product_flattens_a_split_sequence(runs, world):
    """Sequence parallelism ends before every projection (the sequence
    is gathered) and after it (the output is reduced whole), so no DTensor
    on the train or serve path, forward or backward, holds a strided
    shard."""
    for r in range(world):
        assert json.loads((runs / f"port{world}_r{r}_strided.json")
                          .read_text()) == [], f"rank {r}"


def test_kv_heads_that_do_not_divide_model_are_gathered(runs):
    """GQA with 2 kv heads over 4 ranks trains and serves as on one
    device (the port's own one-device run; the reference would reshard
    the same way)."""
    for r in range(4):
        rep = json.loads((runs / f"port4_r{r}.json").read_text())["gqa"]
        np.testing.assert_allclose(*rep["loss"], rtol=TOL)
        assert rep["tokens_equal"] and rep["logits_diff"] <= TOL


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_psum_equals_reference_bitwise(runs, n):
    """The twin of ``tests/test_extras.py``'s ``quantized_psum`` test at
    n > 1: gloo groups of 2 and 4 against ``shard_map`` over 2 and 4 host
    devices, each participant holding its own slice."""
    with np.load(runs / f"psum_{n}.npz") as f:
        want = f["out"]
    for r in range(n):
        got = np.asarray(json.loads((runs / f"port{n}_r{r}.json")
                                    .read_text())["psum"], np.float32)
        np.testing.assert_array_equal(
            got, want[r * PSUM_SIZE:(r + 1) * PSUM_SIZE])


# --------------------------------------------------------------------------
# the launchers under torch.distributed.run
# --------------------------------------------------------------------------

def _launch(module: str, *args, cwd: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *map(str, args)],
        env=_env(), cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _output(proc: subprocess.Popen, deadline: float) -> str:
    try:
        log, _ = proc.communicate(timeout=max(deadline - time.monotonic(),
                                              1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"passed its deadline:\n{log[-4000:]}")
    assert proc.returncode == 0, log[-4000:]
    return log


TRAIN = ["--arch", "qwen1.5-0.5b", "--smoke", "--global-batch", "4",
         "--seq-len", "32", "--device", "cpu", "--model-parallel", "2",
         "--ckpt-every", "2", "--log-every", "1"]
SERVE = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "4",
         "--prompt-len", "16", "--gen", "4", "--device", "cpu"]


def test_launchers_run_over_a_mesh_under_torch_distributed_run(tmp_path):
    """``launch.train`` with ``--model-parallel 2`` over 2 gloo ranks
    prints the mesh and, rerun, resumes; ``launch.serve`` over the same
    launcher gives the single-process run's tokens; ``--model-parallel 3``
    over 2 ranks fails, it does not run on fewer."""
    from repro_torch.launch import serve

    deadline = time.monotonic() + DEADLINE_S
    ckpt = tmp_path / "ckpt"
    train = _launch("repro_torch.launch.train", *TRAIN, "--steps", "2",
                    "--ckpt-dir", ckpt, "--json", tmp_path / "t.json",
                    cwd=tmp_path)
    served = _launch("repro_torch.launch.serve", *SERVE, "--model-parallel",
                     "2", "--mode", "tp", "--json", tmp_path / "s.json",
                     cwd=tmp_path)
    refused = _launch("repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
                      "--smoke", "--device", "cpu", "--steps", "1",
                      "--model-parallel", "3", cwd=tmp_path)
    out = _output(train, deadline)
    assert "mesh: {'data': 1, 'model': 2} devices=2" in out
    assert out.count("done at step 2") == 1  # rank 0 prints, rank 1 not
    rep = json.loads((tmp_path / "t.json").read_text())
    assert rep["mesh"] == {"data": 1, "model": 2} and rep["mode"] == "tp"
    assert len(rep["peak_bytes_per_rank"]) == 2
    out = _output(_launch("repro_torch.launch.train", *TRAIN, "--steps", "3",
                          "--mode", "dp", "--ckpt-dir", ckpt,
                          cwd=tmp_path), deadline)
    assert "resumed from step 2" in out and "done at step 3" in out
    _output(served, deadline)
    with pytest.raises(AssertionError, match="2 devices do not split into "
                       "model=3"):
        _output(refused, deadline)
    want = serve.main(SERVE)
    got = json.loads((tmp_path / "s.json").read_text())
    assert got["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_array_equal(np.asarray(got["tokens"]), want)


if __name__ == "__main__":
    _cmd, _out = sys.argv[1], Path(sys.argv[2])
    if _cmd == "reference-init":
        reference_init(_out)
    elif _cmd == "reference":
        reference_run(_out, int(sys.argv[3]))
    elif _cmd == "reference-reads":
        reference_reads(_out)
    else:
        raise SystemExit(f"unknown command {_cmd!r}")
