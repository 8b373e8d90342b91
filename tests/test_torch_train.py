"""The port's training path against the JAX reference: optimizer updates,
the learning-rate schedule, train steps, checkpoints (read both ways), the
data pipeline and the training launcher, mirroring
``tests/test_integration.py`` and ``tests/test_system.py``.

Tolerances: ``apply_updates`` on identical parameters, gradients and state
1e-6 (rtol and atol; both compute in f32).  Three f32 train steps from
equal parameters and data: losses and grad norms 1e-5 relative,
parameters 1e-4 absolute — the gradients agree to ~1e-6 of their size,
but Adam divides each by its own root-mean-square, so an element whose
gradient is near ``eps`` moves by a different fraction of the step in each
framework (observed at most 5.6e-5 after 3 steps at lr 1e-3, where a step
moves a parameter up to 1e-3).
"""
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch.mesh import make_elastic_mesh
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.training.step import init_sharded
from repro.training.step import make_train_step as jmake_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.models.weights import params_from_numpy
from repro_torch.optim.adamw import (OptConfig, apply_updates, init_opt_state,
                                     lr_at)
from repro_torch.training.step import init, make_train_step

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
            d_ff=128, vocab=256)
OPT = dict(lr=1e-3, warmup=2, decay_steps=50)
UPDATE_TOL = 1e-6
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def _tiny(dtype="bfloat16"):
    """tests/test_integration.py's tiny qwen, in both packages."""
    return (jget_config("qwen1.5-0.5b", smoke=True).scaled(**TINY,
                                                          dtype=dtype),
            get_config("qwen1.5-0.5b", smoke=True).scaled(**TINY,
                                                          dtype=dtype))


def _data(cfg, start=0, cls=SyntheticTokens, dcls=DataConfig):
    return cls(dcls(global_batch=4, seq_len=32, vocab=cfg.vocab),
               start_step=start)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_trees_close(got, want, tol, equal=False):
    a, b = lm.tree_leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if equal:
            np.testing.assert_array_equal(_np(x), np.asarray(y))
        else:
            np.testing.assert_allclose(_np(x), np.asarray(y), rtol=tol,
                                       atol=tol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_at_matches_reference():
    for oc_kw in (OPT, dict(lr=3e-4, warmup=100, decay_steps=10_000),
                  dict(lr=1e-2, warmup=0, decay_steps=0)):
        oc, joc = OptConfig(**oc_kw), jadamw.OptConfig(**oc_kw)
        for step in (0, 1, 2, 3, 25, 52, 100, 101, 5000, 10_100, 20_000):
            got = lr_at(oc, step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(),
                                       float(jadamw.lr_at(joc, step)),
                                       rtol=1e-7, err_msg=f"{oc_kw} {step}")
    assert lr_at(OptConfig(**OPT), torch.tensor(1, dtype=torch.int32)) \
        .item() == pytest.approx(5e-4)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_matches_reference(kind):
    """Three updates from the same parameters, gradients and state; the
    gradients' norm (~20) is far above the clip (1.0)."""
    cfg_j, cfg = _tiny()
    params_j, _ = jlm.init(cfg_j, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, params_j),
                               "cpu")
    oc, joc = OptConfig(kind=kind, **OPT), jadamw.OptConfig(kind=kind, **OPT)
    state, state_j = init_opt_state(oc, params), jadamw.init_opt_state(
        joc, params_j)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads_np = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(np.float32)
            * rng.uniform(0.01, 1.0), params_j)
        params_j, state_j, gnorm_j = jadamw.apply_updates(
            joc, params_j, jax.tree.map(jnp.asarray, grads_np), state_j)
        grads = params_from_numpy(cfg, grads_np, "cpu")
        params, state, gnorm = apply_updates(oc, params, grads, state)
        assert float(gnorm_j) > 10 * oc.grad_clip
        np.testing.assert_allclose(gnorm.item(), float(gnorm_j),
                                   rtol=UPDATE_TOL)
        _assert_trees_close(params, params_j, UPDATE_TOL)
        _assert_trees_close(state, state_j, UPDATE_TOL)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32


def test_opt_state_layout_matches_reference():
    cfg_j, cfg = _tiny()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params_j = jax.eval_shape(lambda: jlm.init(cfg_j,
                                               jax.random.PRNGKey(0))[0])
    for kind in ("adamw", "adafactor"):
        got = lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                          init_opt_state(OptConfig(kind=kind), params))
        want = jax.eval_shape(lambda: jadamw.init_opt_state(
            jadamw.OptConfig(kind=kind), params_j))
        want = jax.tree.map(lambda a: (tuple(a.shape),
                                       "torch." + str(a.dtype)), want)
        assert got == want


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _reference_setup(kind="adamw"):
    cfg_j, cfg = _tiny("float32")
    joc = jadamw.OptConfig(kind=kind, **OPT)
    mesh = make_elastic_mesh(target_model=1)
    params_j, specs, opt_j = init_sharded(cfg_j, joc, mesh)
    step_j, *_ = jmake_train_step(cfg_j, joc, mesh, specs, donate=False)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, params_j),
                               "cpu")
    return cfg, params_j, opt_j, step_j, params


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_steps_match_reference(kind):
    cfg, params_j, opt_j, step_j, params = _reference_setup(kind)
    oc = OptConfig(kind=kind, **OPT)
    opt = init_opt_state(oc, params)
    step = make_train_step(cfg, oc)
    data_j = _data(cfg, cls=JSyntheticTokens, dcls=JDataConfig)
    data = _data(cfg)
    for _ in range(3):
        params_j, opt_j, m_j = step_j(params_j, opt_j, next(data_j))
        params, opt, m = step(params, opt, next(data))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(m_j[key]),
                                       rtol=LOSS_TOL, err_msg=key)
        _assert_trees_close(params, params_j, PARAM_TOL)


def test_microbatches_match_one_batch():
    """Two microbatches give the mean loss and the same update as one
    batch, up to f32 summation order."""
    _, cfg = _tiny("float32")
    oc = OptConfig(**OPT)
    batch = next(_data(cfg))
    out = []
    for mb in (1, 2):
        params, opt = init(cfg, oc, "cpu")
        params, opt, m = make_train_step(cfg, oc, microbatches=mb)(
            params, opt, batch)
        out.append((params, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=LOSS_TOL)
    for a, b in zip(lm.tree_leaves(p1), lm.tree_leaves(p2)):
        np.testing.assert_allclose(_np(b), _np(a), atol=PARAM_TOL)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, oc, microbatches=3)(p1, init(cfg, oc, "cpu")[1],
                                                 batch)


def test_loss_decreases():
    _, cfg = _tiny()
    oc = OptConfig(**OPT)
    params, opt = init(cfg, oc, "cpu")
    step, data = make_train_step(cfg, oc), _data(cfg)
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, next(data))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0], f"no learning: {losses[0]} -> {losses[-1]}"


def test_checkpoint_resume_bitwise(tmp_path):
    """Training 6 steps == training 3, checkpoint (async), restore, 3."""
    _, cfg = _tiny()
    oc = OptConfig(**OPT)
    step = make_train_step(cfg, oc)

    params, opt = init(cfg, oc, "cpu")
    data = _data(cfg)
    for _ in range(6):
        params, opt, _ = step(params, opt, next(data))
    want = [_np(t) for t in lm.tree_leaves(params)]

    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    params, opt = init(cfg, oc, "cpu")
    data = _data(cfg)
    for _ in range(3):
        params, opt, _ = step(params, opt, next(data))
    mgr.save_async(3, {"params": params, "opt": opt},
                   extra={"data": data.state()})
    # the step updates in place: the save copied to host before returning
    params, opt, _ = step(params, opt, next(_data(cfg, start=99)))
    mgr.wait()

    state, extra = mgr.restore_to(3, {"params": params, "opt": opt}, "cpu")
    data2 = _data(cfg)
    data2.restore(extra["data"])
    assert data2.step == 3
    params, opt = state["params"], state["opt"]
    for _ in range(3):
        params, opt, _ = step(params, opt, next(data2))
    for a, b in zip(want, lm.tree_leaves(params)):
        np.testing.assert_array_equal(a, _np(b))


def test_checkpoint_atomicity_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8.0), "b": [torch.ones(2), torch.zeros(3)]}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, extra={"s": s})
    assert mgr.all_steps() == [3, 4]  # retention
    # a stale .tmp dir must not be listed as a checkpoint
    (tmp_path / "step_00000099.tmp").mkdir()
    assert mgr.latest_step() == 4
    restored, extra = mgr.restore(4, tree)
    np.testing.assert_array_equal(restored["w"], np.arange(8.0))
    np.testing.assert_array_equal(restored["b"][1], np.zeros(3))
    assert extra["s"] == 4
    assert [w["step"] for w in mgr.writes] == [1, 2, 3, 4]
    assert all(w["bytes"] > 0 for w in mgr.writes)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(4, {"w": tree["w"]})


def test_async_write_error_raised_by_wait(tmp_path):
    """A write that fails in the writer thread raises in the next
    ``wait``, once, and leaves no checkpoint behind."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"w": torch.ones(2)})
    mgr.save_async(2, {"w": torch.ones(2)}, extra={"bad": object()})
    with pytest.raises(TypeError, match="JSON serializable"):
        mgr.wait()
    mgr.wait()
    assert mgr.all_steps() == [1]


def _bf16_bits(x) -> np.ndarray:
    """The 2-byte bits of a bf16 leaf: a torch tensor, a JAX array, or
    the ``|V2`` array a checkpoint restores."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.detach().cpu().view(torch.int16).numpy()
    a = np.asarray(x)
    assert a.dtype.itemsize == 2 and a.dtype.kind in "Vf", a.dtype
    return a.view(np.int16)


def test_checkpoints_read_both_ways(tmp_path):
    """A checkpoint the reference writes restores in the port, and the
    port's in the reference: same leaves, same order, same values; a bf16
    leaf bit for bit both ways (stored as ``|V2``)."""
    cfg_j, cfg = _tiny()
    params_j, _ = jlm.init(cfg_j, jax.random.PRNGKey(0))
    joc = jadamw.OptConfig(kind="adafactor", **OPT)
    opt_j = jadamw.init_opt_state(joc, params_j)
    opt_j = dict(opt_j, step=jnp.asarray(7, jnp.int32))
    rng = np.random.default_rng(0)
    tree_j = {"params": params_j, "opt": opt_j,
              "w_bf16": jnp.asarray(rng.standard_normal((3, 5)),
                                    jnp.bfloat16)}
    JCheckpointManager(str(tmp_path / "j")).save(7, tree_j,
                                                 extra={"data": {"step": 7}})

    params = lm.init(cfg, torch.Generator().manual_seed(5), "cpu")
    opt = init_opt_state(OptConfig(kind="adafactor"), params)
    like = {"params": params, "opt": opt,
            "w_bf16": torch.from_numpy(rng.standard_normal((3, 5))).to(
                torch.bfloat16)}
    got, extra = CheckpointManager(str(tmp_path / "j")).restore_to(
        7, like, "cpu")
    assert extra == {"data": {"step": 7}}
    f32 = ("params", "opt")
    _assert_trees_close({k: got[k] for k in f32},
                        {k: tree_j[k] for k in f32}, 0, equal=True)
    assert got["opt"]["step"].dtype == torch.int32
    assert got["w_bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got["w_bf16"]),
                                  _bf16_bits(tree_j["w_bf16"]))

    CheckpointManager(str(tmp_path / "t")).save(3, like)
    back, _ = JCheckpointManager(str(tmp_path / "t")).restore(3, tree_j)
    _assert_trees_close({k: like[k] for k in f32},
                        {k: back[k] for k in f32}, 0, equal=True)
    assert back["w_bf16"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(_bf16_bits(back["w_bf16"]),
                                  _bf16_bits(like["w_bf16"]))
    port_back, _ = CheckpointManager(str(tmp_path / "t")).restore_to(
        3, like, "cpu")
    assert torch.equal(port_back["w_bf16"], like["w_bf16"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_pipeline_determinism_and_sharding():
    cfg = DataConfig(global_batch=8, seq_len=16, vocab=100, n_hosts=2,
                     host_id=0)
    a = SyntheticTokens(cfg)
    b = SyntheticTokens(DataConfig(global_batch=8, seq_len=16, vocab=100,
                                   n_hosts=2, host_id=1))
    x0, y0 = next(a), next(b)
    assert x0["tokens"].shape == (4, 16)  # per-host shard
    assert not np.array_equal(x0["tokens"], y0["tokens"])  # different hosts
    a2 = SyntheticTokens(cfg)
    a2.restore({"step": 1, "seed": 0, "host_id": 0})
    np.testing.assert_array_equal(next(a)["tokens"], next(a2)["tokens"])


@pytest.mark.parametrize("kw", [
    dict(global_batch=8, seq_len=16, vocab=100, n_hosts=2, host_id=1),
    dict(global_batch=2, seq_len=8, vocab=151936, seed=3),
    dict(global_batch=2, seq_len=8, vocab=64, frontend="patch",
         frontend_dim=4, frontend_len=5),
    dict(global_batch=2, seq_len=8, vocab=64, frontend="frames",
         frontend_dim=4),
], ids=["hosts", "seed", "patch", "frames"])
def test_data_stream_bit_identical_to_reference(kw):
    got, want = SyntheticTokens(DataConfig(**kw), start_step=2), \
        JSyntheticTokens(JDataConfig(**kw), start_step=2)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert got.state() == want.state()


# ---------------------------------------------------------------------------
# the launcher (launch.train)
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen1.5-0.5b", "--smoke", "--global-batch", "2",
       "--seq-len", "32", "--device", "cpu"]


def test_train_cli_smoke(tmp_path, capsys):
    """The launcher end to end, with resume (the reference's
    ``test_train_cli_smoke``), and its JSON summary."""
    path = tmp_path / "run.json"
    train_mod.main(CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path / "c"),
                          "--ckpt-every", "3", "--log-every", "2",
                          "--json", str(path)])
    out = capsys.readouterr().out
    assert out.startswith("mesh: {'data': 1, 'model': 1} devices=1\n")
    assert "step 4: loss=" in out and "done at step 6; final loss" in out
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.all_steps() == [3, 6]
    rep = json.loads(path.read_text())
    assert rep["steps"] == 6 and rep["device"] == "cpu"
    assert rep["tok_s"] > 0 and len(rep["loss"]) == 6
    assert [w["step"] for w in rep["checkpoints"]] == [3, 6, 6]
    # resume from the checkpoint and continue
    loss = train_mod.main(CLI + ["--steps", "8", "--ckpt-dir",
                                 str(tmp_path / "c"), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done at step 8" in out
    assert np.isfinite(loss) and mgr.latest_step() == 8


def test_train_cli_preemption_checkpoints_and_exits(tmp_path, monkeypatch,
                                                    capsys):
    """SIGTERM during a step: checkpoint at the next boundary and exit."""

    class Preempted(SyntheticTokens):
        def __next__(self):
            if self.step == 2:
                signal.raise_signal(signal.SIGTERM)
            return super().__next__()

    monkeypatch.setattr(train_mod, "SyntheticTokens", Preempted)
    before = signal.getsignal(signal.SIGTERM)
    train_mod.main(CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path)])
    assert "preempted: checkpointed, exiting cleanly" in \
        capsys.readouterr().out
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3]
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["extra"]["data"]["step"] == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_cli_refusals():
    with pytest.raises(ValueError, match="one device"):
        train_mod.main(CLI + ["--model-parallel", "2"])
    with pytest.raises(ValueError, match="--device cuda"):
        train_mod.main(CLI + ["--profile"])


def test_train_cli_needs_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"])


def test_production_path_smoke():
    """The twin of ``tests/test_system.py::test_production_path_smoke``:
    mamba2 smoke, three steps."""
    cfg = get_config("mamba2-130m", smoke=True)
    oc = OptConfig(lr=1e-3)
    params, opt = init(cfg, oc, "cpu")
    step = make_train_step(cfg, oc)
    data = SyntheticTokens(DataConfig(global_batch=2, seq_len=64,
                                      vocab=cfg.vocab))
    for _ in range(3):
        params, opt, m = step(params, opt, next(data))
    assert np.isfinite(m["loss"].item())
