"""AdamW and Adafactor on torch tensors, with f32 moments.

Port of ``repro.optim.adamw``: the reference's update rule, not
``torch.optim.AdamW`` — global-norm clipping, the warmup-cosine schedule,
AdamW with f32 ``m``/``v``, bias correction by ``step`` and decoupled
weight decay, and factored Adafactor.  The state keeps the reference's
layout (``{"m", "v", "step"}`` or ``{"f", "step"}``, ``step`` a 0-d int32
tensor), so a checkpoint of either package restores in the other.  The
update runs on the parameters' device, in f32 as the reference computes
it, and writes parameters and state in place under ``torch.no_grad()``:
that takes the place of the reference's donated buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed.sharding import map_specs
from ..models.lm import tree_leaves, tree_map, tree_zip


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), f32: a
    linear warmup over ``warmup`` steps, then a cosine from ``lr`` down to
    a tenth of it over ``decay_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(oc.warmup, 1), 1.0)
    prog = torch.clamp((step - oc.warmup) / max(oc.decay_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(oc: OptConfig, params):
    """Zeroed f32 state beside ``params`` on their device."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if oc.kind == "adamw":
        def zeros(p):
            return torch.zeros(p.shape, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}
    if oc.kind == "adafactor":
        def factored(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, device=p.device)}
        return {"f": tree_map(factored, params), "step": step}
    raise ValueError(oc.kind)


def opt_state_specs(oc: OptConfig, specs):
    """Logical-axis specs of the state, in ``init_opt_state``'s tree, from
    the parameters' (``models.lm.param_specs``): AdamW's ``m`` and ``v``
    take the parameters' specs, Adafactor's factors drop the last axis
    (``vr``) or the one before it (``vc``); ``step`` is a scalar, ``()``."""
    if oc.kind == "adamw":
        return {"m": specs, "v": specs, "step": ()}
    if oc.kind == "adafactor":
        def factored(spec):
            spec = tuple(spec)
            if len(spec) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"f": map_specs(factored, specs), "step": ()}
    raise ValueError(oc.kind)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(oc: OptConfig, params, grads, state):
    """One update of ``params`` by ``grads`` (same structure), in place.
    Returns (params, state, grad global norm before clipping), the first
    two the objects passed in."""
    state["step"] += 1
    step = state["step"]
    lr = lr_at(oc, step)
    gnorm = _global_norm(grads)
    scale = (torch.clamp_max(oc.grad_clip / torch.clamp_min(gnorm, 1e-9),
                             1.0) if oc.grad_clip else 1.0)

    if oc.kind == "adamw":
        b1, b2 = oc.b1, oc.b2
        stepf = step.float()
        for p, g, m, v in tree_zip(params, grads, state["m"], state["v"]):
            g = g.float() * scale
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mh = m2 / (1 - b1 ** stepf)
            vh = v2 / (1 - b2 ** stepf)
            delta = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * \
                p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m2)
            v.copy_(v2)
        return params, state, gnorm

    if oc.kind == "adafactor":
        for p, g, f in tree_zip(params, grads, state["f"]):
            g = g.float() * scale
            if p.ndim >= 2:
                vr = 0.999 * f["vr"] + 0.001 * torch.mean(g * g, -1)
                vc = 0.999 * f["vc"] + 0.001 * torch.mean(g * g, -2)
                r = vr / torch.clamp_min(torch.mean(vr, -1, keepdim=True),
                                         1e-30)
                prec = torch.sqrt(r[..., None] * vc[..., None, :]) + oc.eps
                delta = g / prec
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = 0.999 * f["v"] + 0.001 * g * g
                delta = g / (torch.sqrt(v) + oc.eps)
                f["v"].copy_(v)
            delta = delta + oc.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return params, state, gnorm
    raise ValueError(oc.kind)
