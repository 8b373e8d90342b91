"""The port's model stack (``repro_torch.models.lm``) against the JAX
reference on all 10 smoke configs: forward logits, the loss value, prefill's
last logits and two decode steps, from JAX's own parameters carried across
by ``params_from_numpy`` and the same numpy-drawn inputs.

Tolerances: 1e-4 (rtol and atol) with ``cfg.scaled(dtype="float32")``;
3e-2 in bf16, looser than ``tests/test_arch_smoke.py``'s 2e-2 between
prefill and forward of one framework, because two frameworks round bf16
intermediates in different places.  In bf16 the absolute term is 3e-2 of
the largest |logit|: the head's bf16 product rounds each logit to 2^-8 of
its own size, and the tied-embedding smoke models (mamba2, recurrentgemma)
have logits up to ~150, where one bf16 step is 1.0, so a logit near 0 is a
cancellation of terms that large.  A bf16 MoE may also route a token
differently: where the router's k-th and (k+1)-th probabilities differ by
less than one rounding of its input (phi3.5-moe smoke, layer 1: one token
of 128 with a gap of 5e-4), the other framework picks the other expert and
the token's row differs entirely.  So in bf16 MoE up to 2% of the rows may
fall outside the tolerance; every other row is held to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.weights import cast_for_compute, params_from_numpy

B, S = 2, 64
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _batch(cfg, seed):
    """tests/test_arch_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        batch["embeds"] = rng.normal(size=(B, 8, cfg.frontend_dim))
    if cfg.family == "audio":
        batch["enc_frames"] = rng.normal(size=(B, S, cfg.frontend_dim))
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.float32) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i"
            else torch.from_numpy(v).float() for k, v in batch.items()}


def _models(arch, dtype, seed=0):
    cfg_j = jget_config(arch, smoke=True).scaled(dtype=dtype)
    cfg = get_config(arch, smoke=True).scaled(dtype=dtype)
    params_j, _ = jlm.init(cfg_j, jax.random.PRNGKey(seed))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, params_j),
                               "cpu")
    return cfg_j, params_j, cfg, params


def _close(port, ref, tol, what, scaled=False, rows_off=0.0):
    """Elementwise within ``tol``; ``scaled``: the absolute term is ``tol``
    of the largest |ref|; ``rows_off``: the share of rows (last axis) that
    may fall outside."""
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    atol = tol * np.abs(ref).max() if scaled else tol
    if rows_off:
        rows = (np.abs(port - ref) > atol + tol * np.abs(ref)).any(-1)
        if rows.sum() <= int(rows_off * rows.size):
            port = np.where(rows[..., None], ref, port)
        what = f"{what}: {rows.sum()} of {rows.size} rows off"
    np.testing.assert_allclose(port, ref, rtol=tol, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype):
    cfg_j, params_j, cfg, params = _models(arch, dtype)
    bf16 = dict(scaled=True, rows_off=0.02 if cfg.n_experts else 0.0)
    tol, kw = TOL[dtype], bf16 if dtype == "bfloat16" else {}
    batch = _batch(cfg, 0)
    bj, bt = _jbatch(batch), _tbatch(batch)
    extra = dict(embeds="embeds", enc_frames="enc_frames")
    kw_j = {k: bj[v] for k, v in extra.items() if v in bj}
    kw_t = {k: bt[v] for k, v in extra.items() if v in bt}

    logits, _, aux = lm.forward(cfg, params, bt["tokens"], **kw_t)
    ref, _, ref_aux = jlm.forward(cfg_j, params_j, bj["tokens"], **kw_j)
    _close(logits, ref, tol, "forward logits", **kw)
    _close(aux, ref_aux, tol, "aux")
    loss, parts = lm.loss_fn(cfg, params, bt)
    ref_loss, ref_parts = jlm.loss_fn(cfg_j, params_j, bj)
    _close(loss, ref_loss, tol, "loss")
    _close(parts["ce"], ref_parts["ce"], tol, "ce")

    n_extra = batch["embeds"].shape[1] if "embeds" in batch else 0
    cache = lm.init_cache(cfg, B, S + n_extra + 4, "cpu")
    cache_j = jlm.init_cache(cfg_j, B, S + n_extra + 4)
    last, cache = lm.prefill(cfg, params, bt, cache)
    ref_last, cache_j = jlm.prefill(cfg_j, params_j, bj, cache_j)
    _close(last, ref_last, tol, "prefill last logits", **kw)
    assert cache["pos"] == int(cache_j["pos"])
    tok = np.asarray(jnp.argmax(ref_last, -1))[:, None]
    for step in range(2):
        logits, cache = lm.decode_step(cfg, params, torch.tensor(tok),
                                       cache)
        ref, cache_j = jlm.decode_step(cfg_j, params_j,
                                       jnp.asarray(tok, jnp.int32), cache_j)
        _close(logits, ref, tol, f"decode step {step}", **kw)
        assert cache["pos"] == int(cache_j["pos"])
        tok = np.asarray(jnp.argmax(ref, -1))[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_reference(arch):
    """``init`` builds the reference's tree: same keys, stacks, shapes and
    dtypes (the values come from a torch generator)."""
    cfg_j = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    want = jax.eval_shape(lambda: jlm.init(cfg_j, jax.random.PRNGKey(0))[0])
    got = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    got = lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype)), got)
    ref = jax.tree.map(lambda a: (tuple(a.shape), "torch." + str(a.dtype)),
                       want)
    assert got == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_head_on_last_position_equals_forward(arch):
    """Prefill runs the head on the last position only; its logits equal
    the last row of ``forward``'s, up to the order the f32 matmul sums a
    row in (1e-6 of the largest |logit|)."""
    cfg = get_config(arch, smoke=True).scaled(dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    bt = _tbatch(_batch(cfg, 2))
    full, _, _ = lm.forward(cfg, params, bt["tokens"],
                            embeds=bt.get("embeds"),
                            enc_frames=bt.get("enc_frames"))
    n_extra = bt["embeds"].shape[1] if "embeds" in bt else 0
    last, _ = lm.prefill(cfg, params, bt,
                         lm.init_cache(cfg, B, S + n_extra + 4, "cpu"))
    want = full[:, -1]
    torch.testing.assert_close(last, want, rtol=1e-6,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_for_compute_keeps_values(arch):
    """Weights cast once to bf16 give the very logits of f32 weights cast
    on every call."""
    cfg = get_config(arch, smoke=True)
    params = lm.init(cfg, torch.Generator().manual_seed(3), "cpu")
    cast = cast_for_compute(cfg, params)
    kinds = set()
    lm.tree_map(lambda t: kinds.add(t.dtype), cast)
    assert kinds == {torch.bfloat16, torch.float32}
    bt = _tbatch(_batch(cfg, 4))
    kw = {k: bt[k] for k in ("embeds", "enc_frames") if k in bt}
    a, _, _ = lm.forward(cfg, params, bt["tokens"], **kw)
    b, _, _ = lm.forward(cfg, cast, bt["tokens"], **kw)
    assert torch.equal(a, b)


def test_params_from_numpy_rejects_another_config():
    cfg_j, params_j, cfg, _ = _models("qwen1_5_0_5b", "float32")
    tree = jax.tree.map(np.asarray, params_j)
    with pytest.raises(ValueError, match="group"):
        params_from_numpy(get_config("qwen1_5_0_5b", smoke=True).scaled(
            n_layers=3), tree, "cpu")
    with pytest.raises(ValueError, match="layer groups"):
        params_from_numpy(get_config("seamless_m4t_medium", smoke=True),
                          tree, "cpu")
