"""Serving steps, on one device or over a mesh: prefill and single-token
decode.

Port of ``repro.serving.engine``.  ``make_serve_steps`` returns the
prefill and decode steps; both update the cache in place, which takes the
place of the reference's ``donate_argnums``.  Over a ``DeviceMesh``
(``mesh=``) the parameters are DTensors (``training.step.init_sharded``'s
layouts), the cache is placed by ``cache_shardings`` (``place_cache``), the
prompts and tokens by ``batch_shardings``, both steps run inside
``activation_sharding_ctx``, and the logits come back replicated: a plain
tensor, the same on every rank.  ``decode_mapping_plan`` is the
reference's, verbatim (it is jax-free there too).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..distributed.sharding import (NamedSharding, P, activation_sharding_ctx,
                                    check_sharded, full, place)
from ..launch.mesh import as_mesh
from ..models import lm
from ..models.config import ModelConfig


def _axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = as_mesh(mesh).shape
    n = 1
    for a in names:
        if a in shape:
            n *= shape[a]
    return n


def _div(x: int, mesh, names) -> bool:
    s = _axis_size(mesh, names)
    return s > 1 and x % s == 0


def cache_shardings(cfg: ModelConfig, cache, mesh):
    """The reference's structural cache rule on the port's layout: one
    NamedSharding per tensor of ``cache`` (``lm.init_cache``'s tree; the
    fill indices stay host ints).  Each layer's (B, S, Hkv, Dh) buffer is
    the reference's stacked (L, B, S, H, D) without L: batch over
    ('pod', 'data') when it divides, kv heads over 'model' when they
    divide, else the kv sequence over 'model', and a batch of one shards
    its sequence over the data axes.  Recurrent states shard their batch
    only."""
    one = _cache_rule(mesh)
    return lm.tree_map(lambda x: one(x) if isinstance(x, torch.Tensor)
                       else x, cache)


def _cache_rule(mesh):
    axes = as_mesh(mesh).axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)

    def one(x):
        shp = tuple(x.shape)
        nd = len(shp)
        spec = [None] * nd
        if nd == 0:
            return NamedSharding(mesh, P())
        if _div(shp[0], mesh, batch_axes):
            spec[0] = batch_axes
        if nd == 4:
            if _div(shp[2], mesh, "model"):
                spec[2] = "model"
            elif _div(shp[1], mesh, "model"):
                spec[1] = "model"
            if spec[1] is None and shp[0] == 1 and \
                    _div(shp[1], mesh, batch_axes):
                spec[1] = batch_axes
        return NamedSharding(mesh, P(*spec))

    return one


def batch_shardings(mesh, batch):
    """Each array of ``batch`` split over ('pod', 'data') on its leading
    axis where that divides, else replicated (the reference's rule)."""
    axes = as_mesh(mesh).axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)

    def one(x):
        nd = len(x.shape)
        if nd == 0 or not _div(x.shape[0], mesh, batch_axes):
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(batch_axes, *([None] * (nd - 1))))

    return {k: one(v) for k, v in batch.items()}


def place_cache(cfg: ModelConfig, cache, mesh):
    """``cache`` with every tensor placed on the ``DeviceMesh`` ``mesh`` by
    ``cache_shardings``."""
    one = _cache_rule(mesh)
    return lm.tree_map(lambda x: place(x, one(x))
                       if isinstance(x, torch.Tensor) else x, cache)


def _placed(mesh, batch):
    sh = batch_shardings(mesh, batch)
    return {k: place(v, sh[k]) for k, v in batch.items()}


def make_serve_steps(cfg: ModelConfig, mesh=None, mode: str = "tp"):
    """(prefill_step(params, batch, cache), decode_step(params, tok,
    cache)); each returns (last logits (B, vocab) f32, cache).  With a
    ``DeviceMesh`` the batch and the tokens may be plain tensors (the same
    on every rank): they are placed by ``batch_shardings``; the logits
    come back as a plain replicated tensor."""
    if mesh is not None:
        check_sharded(cfg, mode, mesh)

    def placed(batch):
        return batch if mesh is None else _placed(mesh, batch)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        with activation_sharding_ctx(mesh, mode):
            last, cache = lm.prefill(cfg, params, placed(batch), cache)
        return full(last), cache

    @torch.no_grad()
    def decode_step(params, tok, cache):
        with activation_sharding_ctx(mesh, mode):
            logits, cache = lm.decode_step(cfg, params,
                                           placed({"tok": tok})["tok"],
                                           cache)
        return full(logits), cache

    return prefill_step, decode_step


def decode_mapping_plan(cfg: ModelConfig, service, arch, batch: int,
                        kv_len: int, objective: str = "edp",
                        deadline_s: Optional[float] = None
                        ) -> Dict[str, Any]:
    """Per-decode-step mapping plan from the online mapper.

    Queries the :class:`repro_torch.serve_map.MappingService` for every
    structurally unique einsum of one decode step at the *exact*
    ``(batch, kv_len)`` shape — the KV length grows by one every step, so
    consecutive steps collapse onto the service's shape buckets and only
    bucket-boundary crossings pay a search.  Returns ``{einsum name:
    MapResponse}``; each response carries the mapping, its provenance
    (hit/bucket/search) and a certified ``gap_bound``.

    Deliberately jax-free: safe to call from schedulers and admission
    controllers without touching the sharded execution path.
    """
    return service.map_model(cfg, arch, mode="decode", batch=batch,
                             seq=kv_len, objective=objective,
                             deadline_s=deadline_s)
