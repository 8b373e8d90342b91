"""Device meshes: frozen descriptions, and the process group behind them.

Port of ``repro.launch.mesh``.  The port's mesh is a small frozen
description — axis names and extents — on which ``distributed.sharding``
plans layouts; ``device_mesh`` turns it into a ``torch.distributed``
``DeviceMesh`` over the ranks of the process group, on which tensors are
placed as DTensors.

``make_production_mesh`` describes the reference's production meshes:
single-pod 16x16 = 256 chips (data x model), multi-pod 2x16x16 = 512
(pod x data x model).  They plan layouts, and the dry-run traces one
rank of them in a fake group (``fake_group``).
``make_host_mesh`` and ``make_elastic_mesh`` keep the reference's
arithmetic over the ranks of the process group when one is up, else over
the devices given, by default every card (``torch.cuda.device_count()``);
``devices("cpu")`` is one device.

``init_distributed`` reads the environment ``torch.distributed.run`` sets
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``) and joins the group: NCCL on
``cuda:LOCAL_RANK``, or gloo on the CPU when the CPU is asked for.  Its
collectives time out (``GROUP_TIMEOUT_S``), so a rank that never joins a
collective fails the run instead of hanging it.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a collective may wait for every rank before it fails
GROUP_TIMEOUT_S = 60


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


def as_mesh(mesh) -> Mesh:
    """The description of ``mesh``: a ``Mesh`` itself, or a
    ``DeviceMesh``'s dim names and extents."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


# the mesh axes whose product ``device_mesh`` flattens into one group of
# its own: ``tp_fsdp`` splits the layer stacks over both ('pod', 'data')
FLATTENED = ("pod", "data")


def device_mesh(mesh: Mesh, device_type: str):
    """``mesh`` over the ranks of the process group, as a ``DeviceMesh``
    of ``device_type`` (``"cuda"`` or ``"cpu"``).  Where the mesh has both
    axes of ``FLATTENED``, their product is flattened into a mesh dim of
    its own (``"pod_data"``), whose group ``distributed.sharding.layer``
    gathers a layer over; it is built here, with the mesh, because every
    rank must build it and ``DeviceMesh`` cannot under ``FakeTensorMode``.
    Raises ValueError unless the group has ``mesh.size`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices over {n} ranks")
    dm = init_device_mesh(device_type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    if set(FLATTENED) <= set(mesh.axis_names):
        dm[FLATTENED]._flatten()
    return dm


@contextlib.contextmanager
def fake_group(mesh: Mesh):
    """This process as rank 0 of a fake process group of ``mesh.size``
    ranks (``torch.testing._internal.distributed.fake_pg``): collectives
    run on this rank alone, moving nothing, so one process can trace one
    rank's step over the reference's 256- and 512-device meshes (the
    dry-run, on fake tensors).  The group is destroyed on exit.  Raises
    RuntimeError while a process group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is up; a fake group of "
                           f"{mesh.size} ranks would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def launched() -> bool:
    """Whether ``torch.distributed.run`` started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group of a ``torch.distributed.run`` launch and
    return this rank's device: ``cuda:LOCAL_RANK`` under NCCL, or the CPU
    under gloo when ``device`` is ``"cpu"``.  A rank with no card of its
    own raises.  Collectives time out after ``GROUP_TIMEOUT_S``."""
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        backend = "gloo"
    else:
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {os.environ.get('RANK')} wants cuda:{local}, but "
                f"this host shows {torch.cuda.device_count()} CUDA "
                f"device(s)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, timeout=timeout, **kw)
    return dev


def run_launched(model_parallel: int, dev: torch.device, run):
    """A launcher's run: ``run(dev, mesh, device_mesh)``.  Under
    ``torch.distributed.run`` the ranks join the group (``init_distributed``
    on ``dev``'s type, left again at the end) and form the (data, model)
    mesh with 'model' = ``model_parallel``, which must divide them; a
    process started alone runs on ``dev`` with no ``DeviceMesh`` (None),
    and there ``model_parallel`` above 1 raises ValueError."""
    if not launched():
        if model_parallel != 1:
            raise ValueError(
                f"--model-parallel {model_parallel} does not divide one "
                f"device: a process started alone is one device; start a "
                f"multiple of {model_parallel} ranks with python -m "
                f"torch.distributed.run")
        return run(dev, make_host_mesh(1, devs=[dev]), None)
    dev = init_distributed(dev.type)
    try:
        mesh = make_host_mesh(model_parallel)
        return run(dev, mesh, device_mesh(mesh, dev.type))
    finally:
        dist.destroy_process_group()


def is_main() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(*args, **kwargs) -> None:
    """``print`` on rank 0, or in the only process; nothing elsewhere."""
    if is_main():
        print(*args, **kwargs)


def per_rank(value) -> list:
    """``value`` from every rank, in rank order (a collective under a
    process group; ``[value]`` without one)."""
    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


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


def _count(devs: Optional[Sequence[torch.device]]) -> int:
    """The devices a mesh spans: ``devs``, else the ranks of the process
    group when one is up, else every card."""
    if devs is not None:
        return len(devs)
    if dist.is_initialized():
        return dist.get_world_size()
    return len(devices())


def make_host_mesh(model: int = 1,
                   devs: Optional[Sequence[torch.device]] = None) -> Mesh:
    """(data, model) mesh over ``devs`` (default the group's ranks, or
    every card)."""
    n = _count(devs)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return Mesh(("data", "model"), (n // model, model))


def make_elastic_mesh(target_model: int = 16,
                      devs: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Largest (data, model) mesh from ``devs`` (default the group's
    ranks, or every card): keeps the 'model' extent at ``target_model``
    where the devices allow (the TP degree is baked into layouts) and
    absorbs device loss by shrinking 'data'."""
    n = _count(devs)
    model = min(target_model, n)
    while n % model:
        model -= 1
    return Mesh(("data", "model"), (n // model, model))
