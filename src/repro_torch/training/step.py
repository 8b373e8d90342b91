"""The train step, on one device or over a mesh.

Port of ``repro.training.step``.  ``make_train_step`` returns a step that
moves a numpy batch to the parameters' device, takes the gradient of the
loss (of the mean of the microbatch losses, with ``microbatches`` > 1) and
updates parameters and optimizer state in place, which takes the place of
the reference's donated buffers.

Over a ``DeviceMesh`` (``mesh=``) the parameters and the optimizer state
are DTensors placed by ``init_sharded`` (the reference's ``shardings_for``
layouts), each microbatch is split over ('pod', 'data') by ``batch_pspec``,
the loss and its gradient run inside ``activation_sharding_ctx``, and each
gradient is redistributed to its parameter's placements before the update
(the reference's gradient constraint: an all-reduce or reduce-scatter of
the partial sums).  ``init`` is the one-device twin of ``init_sharded``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import (NamedSharding, _from_local,
                                    activation_sharding_ctx, batch_pspec,
                                    check_sharded, full, is_dtensor,
                                    local_part, map_specs, place,
                                    sharded_zeros)
from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import (OptConfig, apply_updates, init_opt_state,
                           opt_state_specs)

def _to_device(batch: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """A numpy batch, or a batch of tensors, on ``device``: integer arrays
    as int64 (torch indexes and gathers with them), float arrays as f32.
    A tensor already on ``device`` in that dtype is taken as it is."""
    def one(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v))
        return v.to(device, torch.float32 if v.is_floating_point()
                    else torch.int64)
    return {k: one(v) for k, v in batch.items()}


def _place_batch(batch: Dict[str, torch.Tensor], mesh):
    """Each array split over ('pod', 'data') on ``mesh`` (the reference's
    ``batch_pspec``); an array already placed (a DTensor) as it is."""
    return {k: v if is_dtensor(v) else place(v, NamedSharding(
        mesh, batch_pspec(mesh, v.ndim - 1))) for k, v in batch.items()}


def _microbatch(v, i: int, microbatches: int):
    """Part ``i`` of ``microbatches`` of the batch array ``v`` along its
    leading axis: rows ``i*n:(i+1)*n`` of a plain array; of a placed one
    (a DTensor), on every rank part ``i`` of its own rows, so no row
    moves between ranks (the parts differ from the plain array's, their
    mean loss and summed gradient do not)."""
    if not is_dtensor(v):
        n = v.shape[0] // microbatches
        return v[i * n:(i + 1) * n]
    if microbatches == 1:
        return v
    local = v.to_local()
    n, rest = divmod(local.shape[0], microbatches)
    if rest:
        raise ValueError(f"{local.shape[0]} rows on a rank do not split "
                         f"into {microbatches} microbatches")
    return _from_local(local[i * n:(i + 1) * n], v.device_mesh,
                       v.placements, (v.shape[0] // microbatches,)
                       + tuple(v.shape[1:]))


def make_train_step(cfg: ModelConfig, oc: OptConfig, microbatches: int = 1,
                    mesh=None, mode: str = "tp", strict: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; the metrics are 0-d f32 tensors on the
    device, plain (the same on every rank) over a mesh.  The batch's
    leading axis splits into ``microbatches`` equal parts; the loss is
    their losses' mean, as the reference's scan sums them and divides,
    and its gradient the sum of each part's gradient divided by their
    count.  ``mesh`` is a ``DeviceMesh`` over which the parameters and the
    state are placed (``init_sharded``), or None for one device; over a
    mesh the batch may come placed (DTensors, the reference's
    ``batch_shardings``) or whole (the same on every rank: placed here).
    ``strict`` as for ``check_sharded``."""
    if mesh is not None:
        check_sharded(cfg, mode, mesh, strict)

    def train_step(params, opt_state, batch):
        leaves = lm.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = _to_device(batch, leaves[0].device)
        B = next(iter(batch.values())).shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        total, grads = 0.0, None
        for i in range(microbatches):
            part = {k: _microbatch(v, i, microbatches)
                    for k, v in batch.items()}
            if mesh is not None:
                part = _place_batch(part, mesh)
            with activation_sharding_ctx(mesh, mode):
                loss = lm.loss_fn(cfg, params, part)[0]
                g = torch.autograd.grad(loss / microbatches, leaves,
                                        allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(leaves, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total = total + loss.detach()
        if mesh is not None:
            # the reference's constraint of each gradient to its
            # parameter's layout: the partial sums are reduced here
            grads = [x.redistribute(p.device_mesh, p.placements)
                     for p, x in zip(leaves, grads)]
        params, opt_state, gnorm = apply_updates(
            oc, params, lm.tree_unflatten(params, grads), opt_state)
        metrics = {"loss": full(total / microbatches).float(),
                   "grad_norm": full(gnorm).float()}
        return params, opt_state, metrics

    return train_step


def init(cfg: ModelConfig, oc: Optional[OptConfig], device,
         seed: int = 0) -> Tuple[lm.Params, Optional[Dict]]:
    """Parameters drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU (the same weights on every device), on ``device``, and the
    optimizer state beside them (None without ``oc``)."""
    params = lm.init(cfg, torch.Generator().manual_seed(seed), device)
    return params, None if oc is None else init_opt_state(oc, params)


def init_sharded(cfg: ModelConfig, oc: Optional[OptConfig], mesh,
                 mode: str = "tp", seed: int = 0, device=None,
                 strict: bool = True):
    """``init``'s parameters and optimizer state (None without ``oc``),
    placed on the ``DeviceMesh`` ``mesh`` by the reference's layouts:
    ``shardings_for(param_specs, like=params)`` and ``opt_state_specs``.
    Every rank draws the same parameters from the same CPU generator
    stream as ``init``, leaf by leaf and layer by layer, and keeps only
    its shard of each on ``device`` (default the mesh's device, e.g.
    ``cuda:LOCAL_RANK``): the values equal ``distribute(init(...))`` bit
    for bit, and no rank holds more than one whole leaf or layer at a
    time, on the CPU.  The optimizer state is made in its sharded layout
    as zeros.  ``strict`` as for ``check_sharded``.  Returns (params,
    specs, opt_state), the reference's ``init_sharded``."""
    check_sharded(cfg, mode, mesh, strict)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    specs = lm.param_specs(cfg)
    params = lm.init(cfg, torch.Generator().manual_seed(seed), device,
                     part=lambda spec, shape: local_part(spec, shape, mesh,
                                                         mode))
    if oc is None:
        return params, specs, None
    # the state's shapes, from meta tensors shaped like the parameters
    shapes = init_opt_state(oc, lm.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params))
    opt_state = map_specs(
        lambda spec, t: sharded_zeros(spec, tuple(t.shape), t.dtype, mesh,
                                      mode, device),
        opt_state_specs(oc, specs), shapes)
    return params, specs, opt_state
