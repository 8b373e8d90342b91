"""Activation sharding constraints on one device.

The reference (``repro.distributed.sharding``) pins activations to a mesh
by logical axis names, and returns ``x`` unchanged when no mesh is active.
The port runs on one GPU, where no mesh exists, so both calls are
documented identities: model code keeps the reference's call sites, and
the specs stay readable where they say how a layer would shard.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

Spec = Tuple[Optional[str], ...]


def constrain(x, spec: Spec):
    """The reference's ``constrain`` with no active mesh: ``x`` itself."""
    return x


def constrain_any(x, specs: Sequence[Spec]):
    """The reference's ``constrain_any`` with no active mesh: ``x``
    itself."""
    return x
