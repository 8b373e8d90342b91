"""The port's model layers (``repro_torch.models.{layers,ssm,rglru}``)
against the JAX reference on the same inputs, drawn from a numpy seed.
JAX's own initialised parameters are carried across through numpy.

Tolerances: f32 2e-5 for attention (the reference's own flash test), 1e-5
elsewhere in f32; bf16 3e-2 (two frameworks round bf16 intermediates in
different places; ``tests/test_kernels.py`` holds bf16 attention at 3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import rglru as jr
from repro.models import ssm as js
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import layers as tl
from repro_torch.models import rglru as tr
from repro_torch.models import ssm as ts
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.lm import tree_map

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
FA_TOL = 2e-5


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=96, vocab=64)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _t(a, dtype=None):
    """jax/numpy -> torch (bf16 through f32, exactly)."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if jnp.asarray(a).dtype == jnp.bfloat16 else np.array(a)
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


def _params(p):
    """A JAX parameter tree as the port's, dtypes kept."""
    return tree_map(lambda a: _t(a, getattr(torch, str(a.dtype))), p)


def _close(port, ref, tol, msg="", scaled=False):
    """Elementwise within ``tol`` (relative and absolute); ``scaled`` makes
    the absolute term ``tol`` of the largest |ref|, for outputs that are
    sums of bf16 terms which can cancel to near 0."""
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    atol = tol * np.abs(ref).max() if scaled else tol
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=tol,
                               atol=atol, err_msg=msg)


def _normal(rng, shape, dtype="float32"):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, dtype), _t(a, getattr(torch, dtype))


# ---------------------------------------------------------------------------
# flash attention (forward)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (B, Sq, Sk, Hq, Hkv, Dh, causal, window, chunk): the reference test's
    # shapes at chunk 16, then padding, a window behind an offset and the
    # default 512 chunks with padding
    (2, 64, 64, 4, 4, 16, True, 0, 16),
    (2, 64, 64, 4, 2, 16, True, 0, 16),     # GQA
    (1, 48, 48, 6, 2, 8, False, 0, 16),     # non-causal, non-pow2 seq
    (2, 64, 64, 4, 1, 16, True, 24, 16),    # local window + MQA
    (1, 1, 96, 4, 2, 16, True, 0, 16),      # decode-style single query
    (2, 50, 70, 4, 2, 16, True, 0, 16),     # ragged: q and kv padded
    (1, 40, 100, 2, 1, 16, True, 16, 16),   # window behind a q offset
    (1, 600, 600, 2, 2, 8, True, 0, 512),   # default chunks, padded
])
def test_flash_attention_matches_reference(shape):
    B, Sq, Sk, Hq, Hkv, Dh, causal, window, chunk = shape
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _normal(rng, s) for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh),
                                  (B, Sk, Hkv, Dh)))
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq, q_chunk=chunk,
              kv_chunk=chunk)
    _close(tl.flash_attention(qt, kt, vt, **kw),
           jl.flash_attention(qj, kj, vj, **kw), FA_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kv_valid_tail(dtype):
    """Keys past ``kv_valid`` are masked: garbage there changes nothing,
    and the result equals the reference's."""
    B, S, H, Dh = 1, 32, 2, 8
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (
        _normal(rng, s, dtype) for s in ((B, 1, H, Dh), (B, S, H, Dh),
                                         (B, S, H, Dh)))
    kw = dict(causal=False, kv_valid=20, q_chunk=8, kv_chunk=8)
    out = tl.flash_attention(qt, kt, vt, **kw)
    kg, vg = kt.clone(), vt.clone()
    kg[:, 20:] = 1e3
    vg[:, 20:] = 1e3
    assert torch.equal(out, tl.flash_attention(qt, kg, vg, **kw))
    _close(out, jl.flash_attention(qj, kj, vj, **kw),
           FA_TOL if dtype == "float32" else TOL[dtype])


# ---------------------------------------------------------------------------
# norms, rope, MLP, MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(3)
    xj, xt = _normal(rng, (2, 12, 4, 16), dtype)
    scale = rng.normal(size=16).astype(np.float32)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, xt),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, xj), TOL[dtype])
    pos = np.arange(12)[None].repeat(2, 0) + np.array([[0], [7]])
    out = tl.rope(xt, torch.from_numpy(pos), 1e6)
    assert out.dtype == xt.dtype
    _close(out, jl.rope(xj, jnp.asarray(pos), 1e6), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    cj, ct = _cfgs(dtype=dtype)
    pj = jl.mlp_params(cj, jax.random.PRNGKey(0))[0]
    xj, xt = _normal(np.random.default_rng(4), (2, 8, 64), dtype)
    _close(tl.mlp(ct, _params(pj), xt), jl.mlp(cj, pj, xj), TOL[dtype])


@pytest.mark.parametrize("dtype,cap", [("float32", 1.25), ("bfloat16", 1.25),
                                       ("float32", 0.5)])
def test_moe(dtype, cap):
    """Output and aux loss; capacity 0.5 drops tokens to the scratch
    slot.  In bf16 an output is the sum of top_k gated expert rows of
    magnitude ~10 whose bf16 roundings differ between the frameworks by an
    ulp (1/16 there), so it is held to 3e-2 of the output's scale."""
    cj, ct = _cfgs(dtype=dtype, n_experts=4, top_k=2, capacity_factor=cap)
    pj = jl.moe_params(cj, jax.random.PRNGKey(1))[0]
    xj, xt = _normal(np.random.default_rng(5), (2, 16, 64), dtype)
    out, aux = tl.moe(ct, _params(pj), xt)
    ref, ref_aux = jl.moe(cj, pj, xj)
    _close(out, ref, TOL[dtype], scaled=dtype == "bfloat16")
    _close(aux, ref_aux, 1e-6)


def test_top_k_breaks_ties_as_lax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = tl.top_k(torch.from_numpy(probs), 2)
    rv, ri = jax.lax.top_k(jnp.asarray(probs), 2)
    assert idx.tolist() == np.asarray(ri).tolist() == [[0, 1], [1, 2],
                                                       [0, 2]]
    assert vals.tolist() == np.asarray(rv).tolist()


# ---------------------------------------------------------------------------
# recurrent blocks, with and without state
# ---------------------------------------------------------------------------

SSM = dict(family="ssm", ssm_state=8, ssm_heads=4, ssm_head_dim=8,
           ssm_chunk=16)
RGLRU = dict(family="hybrid", rglru_dim=48)


def _state(init_j, init_t, cfg_j, cfg_t, rng, dtype):
    """A nonzero state of the block's shapes, the same on both sides."""
    zero = init_j(cfg_j, 2)
    sj, st = {}, {}
    for key, z in zero.items():
        a = rng.normal(size=z.shape).astype(np.float32)
        sj[key] = jnp.asarray(a, z.dtype)
        st[key] = _t(a, getattr(torch, str(z.dtype)))
    assert set(init_t(cfg_t, 2)) == set(st)
    return sj, st


@pytest.mark.parametrize("kind", ["ssm", "rglru"])
@pytest.mark.parametrize("mode", ["none", "decode", "prefill-with-state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block(kind, mode, dtype):
    """No state (S = 40: SSD pads its 16-chunks), a one-token decode from
    a state, and a prefill given a state (its conv window is used, its h
    is not: the reference's convention)."""
    extra = SSM if kind == "ssm" else RGLRU
    cj, ct = _cfgs(dtype=dtype, **extra)
    mod_j, mod_t = (js, ts) if kind == "ssm" else (jr, tr)
    params_j = getattr(mod_j, f"{kind}_params")(cj, jax.random.PRNGKey(2))[0]
    block_j = getattr(mod_j, f"{kind}_block")
    block_t = getattr(mod_t, f"{kind}_block")
    init_j = getattr(mod_j, f"init_{kind}_state")
    init_t = getattr(mod_t, f"init_{kind}_state")
    rng = np.random.default_rng(6)
    S = {"none": 40, "decode": 1, "prefill-with-state": 20}[mode]
    xj, xt = _normal(rng, (2, S, 64), dtype)
    sj = st = None
    if mode != "none":
        sj, st = _state(init_j, init_t, cj, ct, rng, dtype)
    out, new = block_t(ct, _params(params_j), xt, st)
    ref, ref_new = block_j(cj, params_j, xj, sj)
    _close(out, ref, TOL[dtype])
    for key in ref_new:
        _close(new[key], ref_new[key], TOL[dtype], key)


def test_linear_scan_matches_sequential_on_long_input():
    """The doubling scan against the plain recurrence over 5000 steps with
    decays near 0 and near 1, where exp(-cumsum(log a)) would overflow.
    Associated differently, the sums agree at the 1e-6 level."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 5000, 8), generator=g) * 0.999 + 1e-3
    b = torch.randn((2, 5000, 8), generator=g)
    h = torch.zeros((2, 8))
    want = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = tr._linear_scan(a, b)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-6,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# attention block: the three cache modes, the clamp, cross attention
# ---------------------------------------------------------------------------

def _attn(dtype, window=0, **kw):
    cj, ct = _cfgs(dtype=dtype, qkv_bias=True, window=window, **kw)
    pj = jl.attention_params(cj, jax.random.PRNGKey(3))[0]
    rng = np.random.default_rng(7)
    # the reference initialises biases at zero: give them values
    for b in ("bq", "bk", "bv"):
        pj[b] = jnp.asarray(rng.normal(size=pj[b].shape), pj[b].dtype)
    return cj, ct, pj, _params(pj), rng


def _cache(cfg_j, cfg_t, B, Smax):
    z = np.zeros((B, Smax, cfg_j.n_kv_heads, cfg_j.d_head), np.float32)
    return ({"k": jnp.asarray(z, cfg_j.jdtype),
             "v": jnp.asarray(z, cfg_j.jdtype), "idx": jnp.int32(0)},
            {"k": _t(z, cfg_t.torch_dtype), "v": _t(z, cfg_t.torch_dtype),
             "idx": 0})


def _steps(cj, ct, pj, pt, rng, dtype, lengths, Smax, window, tol):
    """Feeds chunks of ``lengths`` tokens through both blocks on one cache
    each, comparing outputs, caches and idx after every call."""
    cache_j, cache_t = _cache(cj, ct, 2, Smax)
    for S in lengths:
        xj, xt = _normal(rng, (2, S, 64), dtype)
        out, cache_t = tl.attention_block(ct, pt, xt, None, cache=cache_t,
                                          window=window)
        ref, cache_j = jl.attention_block(cj, pj, xj, None, cache=cache_j,
                                          window=window)
        _close(out, ref, tol)
        _close(cache_t["k"], cache_j["k"], tol)
        _close(cache_t["v"], cache_j["v"], tol)
        assert cache_t["idx"] == int(cache_j["idx"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_no_cache(dtype):
    cj, ct, pj, pt, rng = _attn(dtype)
    xj, xt = _normal(rng, (2, 24, 64), dtype)
    pos = np.arange(24)[None].repeat(2, 0)
    for causal, window in ((True, 0), (False, 0), (True, 8)):
        out, c = tl.attention_block(ct, pt, xt, torch.from_numpy(pos),
                                    causal=causal, window=window)
        ref, _ = jl.attention_block(cj, pj, xj, jnp.asarray(pos),
                                    causal=causal, window=window)
        assert c is None
        _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_full_cache(dtype):
    """Prefill 12 then three decode steps into a cache of 16."""
    cj, ct, pj, pt, rng = _attn(dtype)
    _steps(cj, ct, pj, pt, rng, dtype, [12, 1, 1, 1], 16, 0,
           TOL[dtype])


def test_attention_block_cache_write_clamps_like_xla():
    """Writes past capacity: ``lax.dynamic_update_slice`` clamps the start
    so the update fits (the last slot is overwritten); the port does the
    same, and attends with the unclamped offsets as the reference does."""
    cj, ct, pj, pt, rng = _attn("float32")
    tol = TOL["float32"]
    _steps(cj, ct, pj, pt, rng, "float32", [6, 1, 1, 1, 1], 8, 0, tol)
    cache_j, cache_t = _cache(cj, ct, 2, 8)
    xj, xt = _normal(rng, (2, 4, 64), "float32")
    cache_t["idx"] = 6  # a 4-token write at 6 lands at 4..7
    cache_j["idx"] = jnp.int32(6)
    out, cache_t = tl.attention_block(ct, pt, xt, None, cache=cache_t)
    ref, cache_j = jl.attention_block(cj, pj, xj, None, cache=cache_j)
    _close(cache_t["k"], cache_j["k"], tol)
    assert cache_t["k"][:, :4].abs().max() == 0
    _close(out, ref, tol)
    row = tl.update_slice(torch.zeros(1, 5), torch.ones(1, 3), 4)[0]
    assert row.tolist() == [0, 0, 1, 1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_ring(dtype):
    """Windowed prefill (20 tokens, window 8: the last 8 roped K/V go to
    their ring slots) then ring decode past the window's wrap."""
    cj, ct, pj, pt, rng = _attn(dtype, window=8)
    _steps(cj, ct, pj, pt, rng, dtype, [20] + [1] * 10, 8, 8,
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention(dtype):
    cj, ct, pj, pt, rng = _attn(dtype)
    tol = TOL[dtype]
    xj, xt = _normal(rng, (2, 6, 64), dtype)
    mj, mt = _normal(rng, (2, 10, 64), dtype)
    out, _ = tl.attention_block(ct, pt, xt, None, kv_from=mt)
    _close(out, jl.attention_block(cj, pj, xj, None, kv_from=mj)[0], tol)
    kt, vt = tl.cross_kv(ct, pt, mt)
    kj, vj = jl.cross_kv(cj, pj, mj)
    _close(kt, kj, tol)
    _close(vt, vj, tol)
    _close(tl.cross_attention_cached(ct, pt, xt, kt, vt),
           jl.cross_attention_cached(cj, pj, xj, kj, vj), tol)
