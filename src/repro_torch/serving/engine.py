"""Serving steps on one device: prefill and single-token decode.

Port of ``repro.serving.engine``.  ``make_serve_steps`` returns the
prefill and decode steps; both update the cache in place, which takes the
place of the reference's ``donate_argnums``.  The reference's
``cache_shardings`` and ``batch_shardings``, and the mesh, specs and
abstract shapes its ``make_serve_steps`` takes, are not ported: on one
device there is nothing to shard.  ``decode_mapping_plan`` is the
reference's, verbatim (it is jax-free there too).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import lm
from ..models.config import ModelConfig


def make_serve_steps(cfg: ModelConfig):
    """(prefill_step(params, batch, cache), decode_step(params, tok,
    cache)); each returns (last logits (B, vocab) f32, cache)."""

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return lm.prefill(cfg, params, batch, cache)

    @torch.no_grad()
    def decode_step(params, tok, cache):
        return lm.decode_step(cfg, params, tok, cache)

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
