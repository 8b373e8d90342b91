"""The port's distributed pieces against the reference, on the CPU.

Parameter specs (``models.lm.param_specs``) and optimizer-state specs
against ``repro``'s trees; ``distributed.sharding``'s layouts against the
reference's on its production meshes (as ``jax.sharding.AbstractMesh``,
so no 256 devices are needed); ``launch.mesh``'s arithmetic; and
``distributed.compression`` bitwise against the JAX functions, plus the
twins of ``tests/test_extras.py``'s compression tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.distributed import compression as ref_comp
from repro.distributed import sharding as ref_sh
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.optim.adamw import opt_state_specs as ref_opt_state_specs
from repro.training.step import _abstract_init
from repro_torch.configs import get_config
from repro_torch.distributed import compression, sharding
from repro_torch.distributed.compression import (compress_decompress,
                                                 init_error_feedback,
                                                 quantized_psum)
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import OptConfig, init_opt_state, opt_state_specs

MODES = ("tp", "dp", "tp_ep", "tp_fsdp")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, smoke: bool):
    """The reference's abstract parameters and specs (``jax.eval_shape``:
    nothing allocated)."""
    return _abstract_init(ref_get_config(arch, smoke=smoke),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _fake_params(arch: str):
    """The port's full-size parameters as fake tensors (shapes only)."""
    with FakeTensorMode():
        return lm.init(get_config(arch), torch.Generator(), "cpu")


# --------------------------------------------------------------------------
# parameter and optimizer-state specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, smoke):
    assert lm.param_specs(get_config(arch, smoke=smoke)) == \
        _reference(arch, smoke)[1]


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_reference(arch, smoke, kind):
    specs = lm.param_specs(get_config(arch, smoke=smoke))
    want = ref_opt_state_specs(RefOptConfig(kind=kind),
                               _reference(arch, smoke)[1])
    assert opt_state_specs(OptConfig(kind=kind), specs) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_mirror_the_params_and_the_state(arch):
    """One spec per parameter, one entry per dimension; the state's specs
    mirror ``init_opt_state``'s tree the same way."""
    cfg = get_config(arch, smoke=True)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = lm.param_specs(cfg)
    ranks = sharding.map_specs(lambda s, p: (len(s), p.ndim), specs, params)
    assert all(a == b for a, b in _pairs(ranks))
    for kind in ("adamw", "adafactor"):
        oc = OptConfig(kind=kind)
        state = init_opt_state(oc, params)
        ost = opt_state_specs(oc, specs)
        ranks = sharding.map_specs(lambda s, t: (len(s), t.ndim), ost, state)
        assert all(a == b for a, b in _pairs(ranks))


def _pairs(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _pairs(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _pairs(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

def _meshes(name):
    shape, axes = MESHES[name]
    return port_mesh.Mesh(axes, shape), AbstractMesh(shape, axes)


def _ref_pspecs(tree):
    return [s.spec for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _port_pspecs(tree):
    """The port's layouts as jax ``PartitionSpec``s, in
    ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, sharding.NamedSharding):
        return [JP(*tree.spec)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _port_pspecs(tree[k])]
    return [p for v in tree for p in _port_pspecs(v)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_for_equal_reference(arch, mode, mesh):
    """Per-leaf layouts of every parameter, gated by the port's own
    (fake) parameter shapes, equal the reference's on the production
    meshes; and without shapes."""
    pm, am = _meshes(mesh)
    params_abs, ref_specs = _reference(arch, False)
    specs = lm.param_specs(get_config(arch))
    for like, ref_like in ((_fake_params(arch), params_abs), (None, None)):
        got = _port_pspecs(sharding.shardings_for(specs, pm, mode,
                                                  like=like))
        want = _ref_pspecs(ref_sh.shardings_for(ref_specs, am, mode,
                                                like=ref_like))
        assert got == want


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "phi3_5_moe_42b",
                                  "mamba2_130m"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_shardings_equal_reference(arch, kind):
    pm, am = _meshes("pod")
    params_abs, ref_specs = _reference(arch, False)
    oc, roc = OptConfig(kind=kind), RefOptConfig(kind=kind)
    with FakeTensorMode():
        state = init_opt_state(oc, _fake_params(arch))
    opt_abs = jax.eval_shape(lambda p: ref_init_opt_state(roc, p),
                             params_abs)
    specs = opt_state_specs(oc, lm.param_specs(get_config(arch)))
    got = sharding.shardings_for(specs, pm, "tp_fsdp", like=state)
    want = ref_sh.shardings_for(ref_opt_state_specs(roc, ref_specs), am,
                                "tp_fsdp", like=opt_abs)
    assert _port_pspecs(got) == _ref_pspecs(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_batch_and_replicated_layouts_equal_reference(mesh):
    pm, am = _meshes(mesh)
    port_rule = sharding.cache_sharding(None, pm)
    ref_rule = ref_sh.cache_sharding(None, am)
    dims = (2, 32, 48, 16, 64, 8)
    for nd in range(len(dims) + 1):
        t = torch.empty(dims[:nd], device="meta")
        x = jax.ShapeDtypeStruct(dims[:nd], jnp.float32)
        assert JP(*port_rule(t).spec) == ref_rule(x).spec, nd
    for extra in (0, 1, 3):
        assert JP(*sharding.batch_pspec(pm, extra)) == \
            ref_sh.batch_pspec(am, extra)
    assert JP(*sharding.batch_sharding(pm, 3).spec) == \
        ref_sh.batch_sharding(am, 3).spec
    assert JP(*sharding.replicated(pm).spec) == ref_sh.replicated(am).spec


def test_spec_to_pspec_gates_by_divisibility_like_the_reference():
    """yi-34b's 60-layer stack cannot shard 'layers' over data x pod, so
    the shrinking prefix and the freed axis decide; 56 heads do not divide
    16."""
    for name in MESHES:
        pm, am = _meshes(name)
        for spec, dims in [(("layers", "embed", "heads"), (60, 7168, 7168)),
                           (("layers", "embed", "heads"), (64, 7168, 56)),
                           (("expert", "embed", "mlp"), (16, 5120, 8192)),
                           (("vocab", "embed"), (151936, 1024))]:
            for mode in MODES:
                got = sharding.spec_to_pspec(spec, sharding.RULES[mode], pm,
                                             dims=dims)
                assert JP(*got) == ref_sh.spec_to_pspec(
                    spec, ref_sh.RULES[mode], am, dims=dims)
    assert sharding.RULES == ref_sh.RULES


def test_constrain_is_the_identity_inside_a_context():
    x = torch.randn(2, 3)
    pm, _ = _meshes("pod")
    with sharding.activation_sharding_ctx(pm, "tp_fsdp"):
        assert sharding.constrain(x, ("batch", None)) is x
        assert sharding.constrain_any(x, [("batch", None)]) is x


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

def test_production_meshes_describe_the_reference():
    pod = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert (multi.shape, multi.size) == (
        {"pod": 2, "data": 16, "model": 16}, 512)
    assert port_mesh.describe(port_mesh.make_elastic_mesh(
        devs=port_mesh.devices("cpu"))) == \
        "mesh: {'data': 1, 'model': 1} devices=1"


@pytest.mark.parametrize("n,target,want", [
    (1, 16, (1, 1)), (8, 16, (1, 8)), (6, 4, (2, 3)), (12, 16, (1, 12)),
    (32, 16, (2, 16)), (7, 2, (7, 1))])
def test_elastic_and_host_mesh_arithmetic(n, target, want, monkeypatch):
    """The reference's arithmetic: 'model' kept at the target where the
    device count allows, 'data' absorbing the rest; the default device
    list is every card."""
    devs = [torch.device("cpu")] * n
    assert port_mesh.make_elastic_mesh(target, devs).axis_sizes == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    assert port_mesh.make_elastic_mesh(target).axis_sizes == want
    assert port_mesh.make_host_mesh(1).axis_sizes == (n, 1)
    assert port_mesh.make_host_mesh(want[1]).axis_sizes == want


def test_meshes_refuse_what_the_reference_asserts(monkeypatch):
    with pytest.raises(ValueError, match="do not split"):
        port_mesh.make_host_mesh(3, [torch.device("cpu")] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_host_mesh(1)


# --------------------------------------------------------------------------
# compression: bitwise against the JAX functions, and the reference's
# own tests' twins
# --------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(300, 7)).astype(np.float32),  # pads
            "b": (rng.normal(size=(1024,)) * 1e-3).astype(np.float32),
            "h": rng.normal(size=(64, 40)).astype(np.float32)}  # as bf16


def _jax_tree(a):
    return {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"]),
            "h": jnp.asarray(a["h"], jnp.bfloat16)}


def _torch_tree(a):
    return {"w": torch.from_numpy(a["w"]), "b": torch.from_numpy(a["b"]),
            "h": torch.from_numpy(a["h"]).to(torch.bfloat16)}


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def test_quantization_codes_and_scales_equal_jax_bitwise():
    rng = np.random.default_rng(3)
    for shape in [(300, 7), (256,), (37, 513), (5,)]:
        a = rng.normal(size=shape).astype(np.float32)
        a.flat[0] = 0.5 * np.abs(a).max()  # a code at an exact .5 tie
        qj, sj = ref_comp._quant(jnp.asarray(a))
        qt, st = compression._quant(torch.from_numpy(a))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(
            compression._dequant(qt, st, shape).numpy(),
            np.asarray(ref_comp._dequant(qj, sj, shape)))


def test_compress_decompress_equals_jax_bitwise_over_steps():
    a = _inputs()
    gj, gt = _jax_tree(a), _torch_tree(a)
    ej, et = ref_comp.init_error_feedback(gj), init_error_feedback(gt)
    for _ in range(3):
        dj, ej = ref_comp.compress_decompress(gj, ej)
        dt, et = compress_decompress(gt, et)
        for k in a:
            assert dt[k].dtype == gt[k].dtype
            np.testing.assert_array_equal(_np(dt[k]), _np(dj[k]))
            np.testing.assert_array_equal(et[k].numpy(), np.asarray(ej[k]))


def test_compression_roundtrip_small_error():
    """Twin of ``test_extras.py::test_compression_roundtrip_small_error``."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))}
    deq, _ = compress_decompress(g, init_error_feedback(g))
    err = float((deq["w"] - g["w"]).abs().max())
    blk_scale = float(g["w"].abs().max()) / 127.0
    assert err <= blk_scale + 1e-6  # one quantization step per block


def test_compression_error_feedback_converges():
    """Twin of ``test_extras.py::test_compression_error_feedback_
    converges``."""
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)) \
        * 0.01
    e = init_error_feedback({"g": g_true})
    applied = torch.zeros_like(g_true)
    for _ in range(50):
        deq, e = compress_decompress({"g": g_true}, e)
        applied = applied + deq["g"]
    np.testing.assert_allclose((applied / 50).numpy(), g_true.numpy(),
                               atol=2e-4)


@pytest.fixture
def group_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_quantized_psum_matches_psum(group_of_one):
    """Twin of ``test_extras.py::test_quantized_psum_matches_psum``, and
    bitwise equal to the reference's ``shard_map`` over one device."""
    x = np.random.default_rng(2).normal(size=(256,)).astype(np.float32)
    out = quantized_psum(torch.from_numpy(x), group_of_one)
    np.testing.assert_allclose(out.numpy(), x, atol=2e-2, rtol=2e-2)
    mesh = jax.make_mesh((1,), ("d",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ref = jax.shard_map(lambda v: ref_comp.quantized_psum(v, "d"), mesh=mesh,
                    in_specs=JP("d"), out_specs=JP("d"))(jnp.asarray(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_quantized_psum_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        quantized_psum(torch.ones(4), None)
