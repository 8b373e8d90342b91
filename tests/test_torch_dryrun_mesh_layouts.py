"""What one rank of the reference's production meshes holds in the port's
dry-run, against the reference's layouts, at full size, on the CPU.

For every arch x cell x {pod (16x16), multipod (2x16x16)}, in the mode
the reference's dry-run applies (its ``MODE_OVERRIDES``, ``dp`` falling
back to ``tp_fsdp`` for serve cells): rank 0's parameters, optimizer state
(train cells) and cache (serve cells), cut by the layouts
``launch.dryrun.make_inputs`` places them with over a fake group of 256
or 512 ranks (``init_sharded``'s ``local_part``, ``batch_shardings``,
``cache_shardings``; shapes from fake tensors, nothing drawn or traced),
hold exactly the bytes of the reference's shard shapes
(``shardings_for(..., like=)`` and its cache and batch rules on
``jax.sharding.AbstractMesh``, as ``tests/test_torch_distributed.py``
builds it), and each input's shard has the reference's shape (token ids
are int64 in the port, int32 there).  The reference's dry-run gates every
layout by the leaf's shape, so none of its layouts fails to divide a
leaf; the port refuses none of these cells either.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so
its ``input_specs`` and tables come from ``tests/test_torch_dryrun.py``,
which reads them from its source.
"""
from __future__ import annotations

import functools
from math import prod

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import shardings_for
from repro.models import lm as ref_lm
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.optim.adamw import opt_state_specs as ref_opt_state_specs
from repro.serving.engine import batch_shardings as ref_batch_shardings
from repro.serving.engine import cache_shardings as ref_cache_shardings
from repro.training.step import _abstract_init
from repro_torch.configs import ALIASES, SHAPES, cells_for, get_config
from repro_torch.distributed.sharding import (check_sharded, local_index,
                                              local_part, map_specs,
                                              placements)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (device_mesh, fake_group,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.optim.adamw import OptConfig, init_opt_state, opt_state_specs
from repro_torch.serving.engine import batch_shardings, cache_shardings
from test_torch_dryrun import REF

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, shape) for arch in ALIASES
         for shape in cells_for(get_config(arch))]


def _mode(arch: str, kind: str) -> str:
    mode = dryrun.MODE_OVERRIDES.get(arch, "tp_fsdp")
    return "tp_fsdp" if mode == "dp" and kind != "train" else mode


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str, serve: bool):
    cfg = ref_get_config(arch)
    if serve:
        cfg = cfg.scaled(param_dtype="bfloat16")
    return cfg, _abstract_init(cfg, jax.random.PRNGKey(0))


def _shard_bytes(abstract, shardings) -> int:
    """The bytes one device holds of each leaf; ValueError where a layout
    does not divide its leaf (what the reference's jit'd step refuses)."""
    leaves = jax.tree.leaves(abstract)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shs)
    return sum(prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for x, sh in zip(leaves, shs))


def _reference(arch: str, shape: str, mesh: str):
    """The reference's per-device bytes of parameters, optimizer state and
    cache, and each input's shard shape; None where a layout does not
    divide its leaf."""
    cell = SHAPES[shape]
    train = cell.kind == "train"
    mode = _mode(arch, cell.kind)
    cfg, (params_abs, specs) = _reference_params(arch, not train)
    amesh = AbstractMesh(*MESHES[mesh])
    try:
        out = {"params": _shard_bytes(params_abs, shardings_for(
            specs, amesh, mode, like=params_abs))}
        if train:
            oc = RefOptConfig()
            opt_abs = jax.eval_shape(lambda p: ref_init_opt_state(oc, p),
                                     params_abs)
            out["opt_state"] = _shard_bytes(opt_abs, shardings_for(
                ref_opt_state_specs(oc, specs), amesh, mode, like=opt_abs))
        else:
            cache_abs = jax.eval_shape(lambda: ref_lm.init_cache(
                cfg, cell.global_batch, cell.seq_len))
            floats = jax.tree.map(
                lambda x: x if jnp_floating(x) else None, cache_abs)
            out["cache"] = _shard_bytes(floats, ref_cache_shardings(
                cfg, floats, amesh))
        batch_abs = REF["input_specs"](cfg, cell)
        sh = ref_batch_shardings(amesh, batch_abs)
        out["inputs"] = {k: sh[k].shard_shape(v.shape)
                         for k, v in batch_abs.items()}
    except ValueError:
        return None
    return out


def jnp_floating(x) -> bool:
    return np.issubdtype(x.dtype, np.floating) or x.dtype == jax.numpy.bfloat16


@functools.lru_cache(maxsize=None)
def _port_leaves(arch: str, serve: bool):
    """The port's config and its whole parameters and optimizer state as
    fake tensors (shapes and dtypes only; nothing drawn)."""
    cfg = get_config(arch)
    if serve:
        cfg = cfg.scaled(param_dtype="bfloat16")
    with FakeTensorMode():
        params = lm.init(cfg, torch.Generator(), "cpu")
        opt = None if serve else init_opt_state(OptConfig(), params)
    return cfg, params, opt


def _placed_bytes(specs, tree, dm, mode) -> int:
    """The bytes of this rank's part of every leaf of ``tree`` placed by
    its logical spec, as ``init_sharded`` cuts it (``local_part``)."""
    total = []
    map_specs(lambda spec, t: total.append(prod(
        s.stop - s.start for s in local_part(spec, tuple(t.shape), dm,
                                             mode)[0]) * t.element_size()),
              specs, tree)
    return sum(total)


def _local_shape(sharding, shape) -> tuple:
    return tuple(s.stop - s.start for s in local_index(
        placements(sharding.spec, sharding.mesh), sharding.mesh, shape))


def _pairs(shardings, tree):
    """(sharding, tensor) at each tensor of ``tree``."""
    if isinstance(tree, torch.Tensor):
        yield shardings, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(shardings[k], tree[k])
    elif isinstance(tree, (list, tuple)):
        for s, t in zip(shardings, tree):
            yield from _pairs(s, t)


def port_bytes(arch: str, shape: str, mesh: str):
    """Rank 0's bytes of parameters, optimizer state and cache, and each
    input's local shape, by the layouts ``launch.dryrun.make_inputs``
    places them with (``init_sharded``'s ``local_part``, ``sharded_zeros``,
    ``batch_shardings``, ``place_cache``); None where the port refuses the
    cell."""
    cell = SHAPES[shape]
    train = cell.kind == "train"
    mode = _mode(arch, cell.kind)
    cfg, params, opt = _port_leaves(arch, not train)
    m = make_production_mesh(multi_pod=mesh == "multipod")
    try:
        check_sharded(cfg, mode, m, strict=False)
    except ValueError:
        return None
    specs = lm.param_specs(cfg)
    with fake_group(m):
        dm = device_mesh(m, "cpu")
        out = {"params": _placed_bytes(specs, params, dm, mode)}
        if train:
            out["opt_state"] = _placed_bytes(
                opt_state_specs(OptConfig(), specs), opt, dm, mode)
        else:
            with FakeTensorMode():
                cache = lm.init_cache(cfg, cell.global_batch, cell.seq_len,
                                      "cpu")
            out["cache"] = sum(
                prod(_local_shape(s, tuple(t.shape))) * t.element_size()
                for s, t in _pairs(cache_shardings(cfg, cache, dm), cache)
                if t.is_floating_point())
        specs_in = dryrun.input_specs(cfg, cell)
        sh = batch_shardings(dm, specs_in)
        out["inputs"] = {k: _local_shape(sh[k], v.shape)
                         for k, v in specs_in.items()}
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_rank_holds_the_reference_shards(arch, shape, mesh):
    """Exact bytes per rank; the same cells refused (none)."""
    want = _reference(arch, shape, mesh)
    got = port_bytes(arch, shape, mesh)
    assert (got is None) == (want is None)
    assert got == want
