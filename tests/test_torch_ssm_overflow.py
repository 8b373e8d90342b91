"""The SSD chunk's decay at the published chunk length: the port masks
above the diagonal before the exp, the reference after it.

Above the diagonal ``decay = cum_j - cum_i`` is a sum of positive terms
(``dt * |A|``); over mamba2-130m's chunk of 256 it passes f32's exp range
(~88.7) once dt averages ~0.35.  The values are the same either way (the
masked entries are 0), but the reference's ``where(causal, exp(decay),
0)`` has a NaN gradient there (0 * inf): at full width its first train
step's grad norm is NaN.  The port's ``exp(where(causal, decay, -inf))``
gives the reference's gradient wherever that is finite, and a finite one
where it is not.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

CHUNK = 64
B, S, H, P, N = 1, 2 * CHUNK, 2, 4, 8


def _inputs(dt: float) -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(B, S, H, P)).astype(np.float32),
            "Bm": rng.normal(size=(B, S, N)).astype(np.float32),
            "Cm": rng.normal(size=(B, S, N)).astype(np.float32),
            "dtm": (dt * (1.0 + 0.1 * rng.random((B, S, H))))
            .astype(np.float32),
            "A": -np.ones((H,), np.float32),
            "w": rng.normal(size=(B, S, H, P)).astype(np.float32)}


def _reference(a: dict):
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    cfg = SimpleNamespace(ssm_chunk=CHUNK)

    def loss(x, bm, cm, dtm):
        y, h = ssd_chunked(cfg, x, bm, cm, dtm, jnp.asarray(a["A"]))
        return jnp.sum(y * a["w"]) + jnp.sum(h)

    args = [jnp.asarray(a[k]) for k in ("x", "Bm", "Cm", "dtm")]
    y, _ = ssd_chunked(cfg, *args, jnp.asarray(a["A"]))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port(a: dict):
    from repro_torch.models.ssm import ssd_chunked

    cfg = SimpleNamespace(ssm_chunk=CHUNK)
    args = [torch.from_numpy(a[k]).requires_grad_(True)
            for k in ("x", "Bm", "Cm", "dtm")]
    y, h = ssd_chunked(cfg, *args, torch.from_numpy(a["A"]))
    (y * torch.from_numpy(a["w"])).sum().add(h.sum()).backward()
    return y.detach().numpy(), [t.grad.numpy() for t in args]


@pytest.mark.parametrize("dt", [0.05, 0.5])
def test_ssd_values_equal_the_reference(dt):
    want, _ = _reference(_inputs(dt))
    got, _ = _port(_inputs(dt))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ssd_gradients_equal_the_reference_where_it_is_finite():
    _, want = _reference(_inputs(0.05))
    _, got = _port(_inputs(0.05))
    for g, w in zip(got, want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """dt ~2 over a chunk of 64: the decay above the diagonal reaches
    ~130, past exp's range: the reference's gradients hold NaN, the
    port's are finite."""
    a = _inputs(2.0)
    _, want = _reference(a)
    _, got = _port(a)
    assert any(not np.isfinite(w).all() for w in want)
    assert all(np.isfinite(g).all() for g in got)
