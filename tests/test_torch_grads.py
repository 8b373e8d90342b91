"""Gradients of the port's model stack against the JAX reference.

The port's flash attention (a ``torch.autograd.Function`` with the
reference's manual backward) against the reference's ``custom_vjp`` on the
cases of ``tests/test_flash_attention.py``, and ``lm.loss_fn``'s gradients
against ``jax.grad`` of the reference's on all 10 smoke configs, from
JAX's own parameters carried across by ``params_from_numpy``.

Tolerances: flash gradients 5e-4 (the reference's own gradient test), in
bf16 3e-2 of the largest |g|.  ``loss_fn`` gradients in f32
(``cfg.scaled(dtype="float32")``) leaf by leaf at 1e-4 relative and 1e-4
of the leaf's largest |g| absolute (observed: at most 1e-5 of it); in
bf16, on the configs without experts, ``tests/test_torch_lm.py``'s 3e-2
with the absolute term 3e-2 of the leaf's largest |g|.  A bf16 MoE routes
a token to another expert where the router's k-th and (k+1)-th
probabilities tie within one rounding (see ``tests/test_torch_lm.py``):
the gradients of those experts' weights then jump, so the MoE configs in
bf16 are held on the loss and the global gradient norm only, at 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import lm
from repro_torch.models.weights import params_from_numpy

B, S = 2, 64
FA_GRAD_TOL = 5e-4
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MOE_ARCHS = [a for a in ARCHS if get_config(a, smoke=True).n_experts]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _fa_inputs(rng, B, Sq, Sk, Hq, Hkv, Dh):
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh), (Dh,))]


def _fa_grads(q, k, v, w, dtype, **kw):
    """d/d(q, k, v) of sum(tanh(flash(q, k, v) @ w)), the reference's
    test function, in JAX and in the port."""
    jdt = jnp.dtype(dtype)

    def f(q, k, v):
        o = jl.flash_attention(q, k, v, **kw)
        return jnp.sum(jnp.tanh(o.astype(jnp.float32) @ w))

    ref = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o = tl.flash_attention(*ts, **kw)
    torch.tanh(o.float() @ torch.from_numpy(w)).sum().backward()
    return [np.asarray(r, np.float32) for r in ref], [
        t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("case", [
    # (Hkv, causal, window, q_offset, kv_valid, Sq, Sk): the reference
    # test's four cases, then a query offset and a masked kv tail
    (4, True, 0, 0, None, 64, 64),
    (2, True, 0, 0, None, 64, 64),
    (2, False, 0, 0, None, 64, 64),
    (1, True, 24, 0, None, 64, 64),
    (2, True, 0, 40, None, 24, 64),
    (2, False, 0, 0, 37, 24, 64),
], ids=str)
def test_flash_grads_match_reference(case):
    hkv, causal, window, q_offset, kv_valid, Sq, Sk = case
    rng = np.random.default_rng(1)
    q, k, v, w = _fa_inputs(rng, 2, Sq, Sk, 4, hkv, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid, q_chunk=16, kv_chunk=16)
    ref, got = _fa_grads(q, k, v, w, "float32", **kw)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a, b, rtol=FA_GRAD_TOL, atol=FA_GRAD_TOL,
                                   err_msg=f"d{name}")
    if kv_valid is not None:  # the masked tail gets no gradient
        assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:]\
            .any()


def test_flash_grads_bf16_match_reference():
    """bf16 in, the reference's rounding points: p, dout and ds rounded to
    bf16 before each product, f32 sums; padded q and kv (50 of 64)."""
    rng = np.random.default_rng(2)
    q, k, v, w = _fa_inputs(rng, 2, 50, 50, 4, 2, 16)
    ref, got = _fa_grads(q, k, v, w, "bfloat16", causal=True, q_chunk=16,
                         kv_chunk=16)
    for a, b, name in zip(got, ref, "qkv"):
        tol = TOL["bfloat16"]
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max(),
                                   err_msg=f"d{name}")


def test_flash_forward_without_grad_is_unchanged():
    """Under ``no_grad`` (serving) the forward runs alone; its output is
    bit for bit the autograd Function's."""
    rng = np.random.default_rng(3)
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _fa_inputs(rng, 2, 40, 40, 4, 2, 16))
    kw = dict(causal=True, q_chunk=16, kv_chunk=16)
    with torch.no_grad():
        plain = tl.flash_attention(q, k, v, **kw)
    graded = tl.flash_attention(q.requires_grad_(), k, v, **kw)
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())


# ---------------------------------------------------------------------------
# loss_fn gradients
# ---------------------------------------------------------------------------

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


def _grads(cfg, params, batch):
    """(loss, gradient leaves in ``jax.tree.leaves`` order) of the port."""
    leaves = lm.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    bt = {k: torch.from_numpy(v) if v.dtype.kind == "i"
          else torch.from_numpy(v).float() for k, v in batch.items()}
    loss = lm.loss_fn(cfg, params, bt)[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


def _both(arch, dtype):
    """The reference's and the port's (loss, gradient leaves) on JAX's
    parameters and one batch."""
    cfg_j = jget_config(arch, smoke=True).scaled(dtype=dtype)
    cfg = get_config(arch, smoke=True).scaled(dtype=dtype)
    params_j, _ = jlm.init(cfg_j, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, params_j),
                               "cpu")
    batch = _batch(cfg, 1)
    bj = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                         else jnp.float32) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(cfg_j, p, bj)[0]))(params_j)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(grads_j)[0]]
    ref = [np.asarray(g, np.float32) for g in jax.tree.leaves(grads_j)]
    loss, got = _grads(cfg, params, batch)
    assert len(got) == len(ref)
    return (float(loss_j), paths, ref), (loss, [g.float().numpy()
                                               for g in got])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference_f32(arch):
    (loss_j, paths, ref), (loss, got) = _both(arch, "float32")
    tol = TOL["float32"]
    np.testing.assert_allclose(loss, loss_j, rtol=tol)
    for path, a, b in zip(paths, got, ref):
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max(), err_msg=path)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE_ARCHS])
def test_loss_grads_match_reference_bf16(arch):
    (loss_j, paths, ref), (loss, got) = _both(arch, "bfloat16")
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(loss, loss_j, rtol=tol)
    for path, a, b in zip(paths, got, ref):
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max(), err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grad_norm_match_reference_bf16(arch):
    (loss_j, _, ref), (loss, got) = _both(arch, "bfloat16")
    tol = TOL["bfloat16"]

    def norm(leaves):
        return np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                           for g in leaves))

    np.testing.assert_allclose(loss, loss_j, rtol=tol)
    np.testing.assert_allclose(norm(got), norm(ref), rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step(arch):
    """The twin of ``tests/test_arch_smoke.py::test_grad_step``: the
    default config (bf16 compute, remat on), the port's own weights."""
    cfg = get_config(arch, smoke=True)
    params = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    _, grads = _grads(cfg, params, _batch(cfg, 1))
    assert all(bool(torch.isfinite(g).all()) for g in grads), \
        f"{arch}: NaN grad"
    assert any(float(g.abs().max()) > 0 for g in grads), f"{arch}: zero grad"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_grads(arch):
    """Recomputing each layer in the backward changes no gradient."""
    cfg = get_config(arch, smoke=True).scaled(dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = _batch(cfg, 3)
    loss_on, on = _grads(cfg.scaled(remat=True), params, batch)
    loss_off, off = _grads(cfg.scaled(remat=False), params, batch)
    assert loss_on == loss_off
    for a, b in zip(on, off):
        assert torch.equal(a, b)
