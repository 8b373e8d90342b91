"""The train step on one device.

Port of ``repro.training.step``.  ``make_train_step`` returns a step that
moves a numpy batch to the parameters' device, takes the gradient of the
loss (of the mean of the microbatch losses, with ``microbatches`` > 1) and
updates parameters and optimizer state in place, which takes the place of
the reference's donated buffers.  ``init`` is the twin of ``init_sharded``.
The reference's shardings (``in_shardings``, ``out_shardings``, the
gradient constraint, the activation-sharding context) have no meaning on
one device and are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import OptConfig, apply_updates, init_opt_state


def _to_device(batch: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: integer arrays as int64 (torch indexes
    and gathers with them), float arrays as f32."""
    return {k: torch.from_numpy(np.asarray(v)).to(
        device, torch.int64 if np.asarray(v).dtype.kind in "iu"
        else torch.float32) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, oc: OptConfig, microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; the metrics are 0-d f32 tensors on the
    device.  The batch's leading axis splits into ``microbatches`` equal
    parts; the loss is their losses' mean, as the reference's scan sums
    them and divides, and its gradient the sum of each part's gradient
    divided by their count."""

    def train_step(params, opt_state, batch):
        leaves = lm.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = _to_device(batch, leaves[0].device)
        B = next(iter(batch.values())).shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        n = B // microbatches
        total, grads = 0.0, None
        for i in range(microbatches):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss = lm.loss_fn(cfg, params, part)[0]
            g = torch.autograd.grad(loss / microbatches, leaves,
                                    allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(leaves, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total = total + loss.detach()
        params, opt_state, gnorm = apply_updates(
            oc, params, lm.tree_unflatten(params, grads), opt_state)
        metrics = {"loss": (total / microbatches).float(),
                   "grad_norm": gnorm.float()}
        return params, opt_state, metrics

    return train_step


def init(cfg: ModelConfig, oc: Optional[OptConfig], device,
         seed: int = 0) -> Tuple[lm.Params, Optional[Dict]]:
    """Parameters drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU (the same weights on every device), on ``device``, and the
    optimizer state beside them (None without ``oc``)."""
    params = lm.init(cfg, torch.Generator().manual_seed(seed), device)
    return params, None if oc is None else init_opt_state(oc, params)
