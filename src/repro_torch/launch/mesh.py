"""Device meshes, described for planning on one device.

Port of ``repro.launch.mesh``.  The port's mesh is a small frozen
description — axis names and extents — not a ``jax`` mesh and not a
``torch.distributed`` ``DeviceMesh``, which would need a process group.
``distributed.sharding`` plans layouts on it.

``make_production_mesh`` describes the reference's production meshes:
single-pod 16x16 = 256 chips (data x model), multi-pod 2x16x16 = 512
(pod x data x model).  They are for planning layouts only.
``make_host_mesh`` and ``make_elastic_mesh`` keep the reference's
arithmetic over the devices given, by default every card
(``torch.cuda.device_count()``); ``devices("cpu")`` is one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, in axis order (``jax`` mesh ``.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def describe(mesh: Mesh) -> str:
    """The launchers' log line, as the reference prints it."""
    return f"mesh: {mesh.shape} devices={mesh.size}"


def devices(kind: str = "cuda") -> List[torch.device]:
    """Every device of ``kind`` on this host: each card, or the CPU as one
    device.  Raises RuntimeError if there is no card."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device; pass devices('cpu') to plan on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(model: int = 1,
                   devs: Optional[Sequence[torch.device]] = None) -> Mesh:
    """(data, model) mesh over ``devs`` (default every card)."""
    n = len(devices() if devs is None else devs)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return Mesh(("data", "model"), (n // model, model))


def make_elastic_mesh(target_model: int = 16,
                      devs: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Largest (data, model) mesh from ``devs`` (default every card):
    keeps the 'model' extent at ``target_model`` where the devices allow
    (the TP degree is baked into layouts) and absorbs device loss by
    shrinking 'data'."""
    n = len(devices() if devs is None else devs)
    model = min(target_model, n)
    while n % model:
        model -= 1
    return Mesh(("data", "model"), (n // model, model))
