"""Carrying weights into the port, and casting them once for serving.

``params_from_numpy`` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameters: the same nested dicts and lists, leaf for leaf, same dtypes.
``cast_for_compute`` stores every weight the layers use in the compute
dtype in that dtype, so a served step reads bf16 weights instead of
casting f32 ones on every call as the reference does; the values are the
same.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .lm import Params, _stack_groups, tree_map

# leaves the layers read in f32 whatever the compute dtype: norm scales and
# the recurrences' decay and skip parameters
F32_LEAVES = frozenset({"scale", "A_log", "D", "dt_bias", "lam"})


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot read
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(cfg: ModelConfig, tree: Params, device) -> Params:
    """The reference's parameters (numpy leaves) as the port's, on
    ``device``.  Raises ValueError if the tree's layer groups are not the
    ones ``cfg`` builds."""
    groups = _stack_groups(cfg)
    if len(tree["groups"]) != len(groups):
        raise ValueError(f"{len(tree['groups'])} layer groups, {cfg.name} "
                         f"has {len(groups)}")
    for (kinds, count), group in zip(groups, tree["groups"]):
        leads = []
        tree_map(lambda a: leads.append(a.shape[0]), group)
        if len(group) != len(kinds) or set(leads) != {count}:
            raise ValueError(f"group {kinds} x {count} does not match the "
                             f"tree's stacks {sorted(set(leads))}")
    return tree_map(lambda a: _tensor(a).to(device), tree)


def cast_for_compute(cfg: ModelConfig, params: Params) -> Params:
    """``params`` with every leaf outside ``F32_LEAVES`` in the compute
    dtype (a leaf already in it is kept, not copied)."""
    dt = cfg.torch_dtype

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, key) for v in tree)
        return tree if key in F32_LEAVES else tree.to(dt)

    return walk(params)
