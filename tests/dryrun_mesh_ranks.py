"""The gloo ranks of ``tests/test_torch_dryrun_mesh.py``: the dry-run's
counters over the real sharded step, against its fake trace.

A group of 4 ranks runs the meshes (data, model) (2, 2) and (pod, data,
model) (2, 2, 1); a group of 2 runs (2, 1) and (1, 2).  Every rank runs
every case's real step (``CASES``; ``POD_CASES`` on (2, 2, 1)) under the
dry-run's counters (``count(*make_inputs(...))``), and rank 0 writes what
it counted; a process of its own traces each case as rank 0 of a fake
group (``launch.dryrun.trace_step``, ``fake_main``).  The group of 4 then
trains the dense model at 4 layers in ``tp_fsdp`` on (2, 2, 1) for
``STEPS`` steps, where each layer is gathered over the flattened ('pod',
'data') group, and rank 0 writes the losses, grad norms and parameters.
Only torch and ``repro_torch`` are imported here.
"""
from __future__ import annotations

import datetime
import json
from pathlib import Path

import torch

# rank count -> its meshes, (axis extents, axis names)
MESHES = {4: [((2, 2), ("data", "model")),
              ((2, 2, 1), ("pod", "data", "model"))],
          2: [((2, 1), ("data", "model")), ((1, 2), ("data", "model"))]}
# model -> (arch, overrides of its smoke config): the dense and ssm stacks
# of 4 layers split over ('pod', 'data') on (2, 2, 1); the moe's 2 split
# over 'pod' there, its 'embed' over 'data'
MODELS = {"dense": ("qwen1.5-0.5b", {"n_layers": 4}),
          "moe": ("phi3.5-moe-42b-a6.6b", {}),
          "ssm": ("mamba2-130m", {"n_layers": 4})}
# (model, kind, mode): each model's reference modes (the dry-run's: dp
# trains and tp_fsdp serves the dense and ssm, tp_ep runs the moe) and
# tp_fsdp
CASES = [("dense", "train", "dp"), ("dense", "train", "tp_fsdp"),
         ("dense", "decode", "tp_fsdp"),
         ("moe", "train", "tp_ep"), ("moe", "decode", "tp_ep"),
         ("moe", "train", "tp_fsdp"), ("moe", "decode", "tp_fsdp"),
         ("ssm", "train", "dp"), ("ssm", "train", "tp_fsdp"),
         ("ssm", "decode", "tp_fsdp")]
# on (2, 2, 1), whose three mesh dims make DTensor's first planning of
# each op several times dearer, the cases its 'pod' axis changes most:
# the batch over ('pod', 'data'), the layer gather over both, the experts
POD_CASES = [("dense", "train", "dp"), ("dense", "train", "tp_fsdp"),
             ("dense", "decode", "tp_fsdp"), ("moe", "train", "tp_ep"),
             ("ssm", "decode", "tp_fsdp")]
BATCH, SEQ, CACHE = 4, 16, 24
STEPS = 3
OPT = dict(lr=1e-3, warmup=2, decay_steps=50)
GATHER_MESH = ((2, 2, 1), ("pod", "data", "model"))


def cases_on(shape) -> list:
    return POD_CASES if len(shape) == 3 else CASES


def cfg_of(model: str, kind: str):
    """The smoke config of ``model``; serve cells with bf16 parameters,
    as the dry-run serves."""
    from repro_torch.configs import get_config

    arch, over = MODELS[model]
    cfg = get_config(arch, smoke=True).scaled(**over)
    return cfg if kind == "train" else cfg.scaled(param_dtype="bfloat16")


def cell_of(kind: str):
    from repro_torch.launch.dryrun import Cell

    if kind == "train":
        return Cell("train", BATCH, SEQ)
    return Cell("decode", BATCH, SEQ + 1, CACHE)


def tag(shape, case) -> str:
    return "x".join(map(str, shape)) + "_" + "_".join(case)


def gather_cfg():
    """The f32 dense model trained over (2, 2, 1) and on one device."""
    return cfg_of("dense", "train").scaled(dtype="float32")


def batches(cfg, steps: int = STEPS) -> list:
    """The training batches, seeded, as plain tensors."""
    g = torch.Generator().manual_seed(1)
    return [{k: torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g)
             for k in ("tokens", "labels")} for _ in range(steps)]


def train(cfg, mesh=None, mode: str = "tp"):
    """``STEPS`` AdamW steps from ``init_sharded``'s (or ``init``'s)
    weights: (losses, grad norms, the parameters whole)."""
    from repro_torch.distributed.sharding import full
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import init, init_sharded, make_train_step

    oc = OptConfig(**OPT)
    if mesh is None:
        params, opt = init(cfg, oc, "cpu")
    else:
        params, _, opt = init_sharded(cfg, oc, mesh, mode)
    step = make_train_step(cfg, oc, mesh=mesh, mode=mode)
    losses, gnorms = [], []
    for b in batches(cfg):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, [full(p).detach() for p in lm.tree_leaves(params)]


def fake_main(_: int, world: int, out: str) -> None:
    """Rank 0's fake trace of every case on each mesh of ``world`` ranks,
    in a process of its own: DTensor caches its sharding decisions by the
    mesh's layout, not its group, so a process that traced over a fake
    group must not then run over a real one."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    torch.set_num_threads(1)
    for shape, axes in MESHES[world]:
        for case in cases_on(shape):
            model, kind, mode = case
            got = dryrun.trace_step(cfg_of(model, kind), cell_of(kind),
                                    "cpu", mesh=Mesh(axes, shape),
                                    mode=mode)
            (Path(out) / f"fake_{tag(shape, case)}.json").write_text(
                json.dumps(got))


def rank_main(rank: int, world: int, out: str) -> None:
    """One gloo rank of ``world``: every case's real step on each mesh
    under the dry-run's counters (rank 0 writes them), then, in the group
    of 4, the training over (2, 2, 1)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import GROUP_TIMEOUT_S, Mesh, device_mesh

    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store{world}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        for shape, axes in MESHES[world]:
            dm = device_mesh(Mesh(axes, shape), "cpu")
            for case in cases_on(shape):
                model, kind, mode = case
                got = dryrun.count(*dryrun.make_inputs(
                    cfg_of(model, kind), cell_of(kind), torch.device("cpu"),
                    mesh=dm, mode=mode))
                if rank == 0:
                    (out / f"real_{tag(shape, case)}.json").write_text(
                        json.dumps(got))
        if world == 4:
            shape, axes = GATHER_MESH
            losses, gnorms, params = train(
                gather_cfg(), device_mesh(Mesh(axes, shape), "cpu"),
                "tp_fsdp")
            if rank == 0:
                (out / "gather.json").write_text(json.dumps(
                    {"loss": losses, "grad_norm": gnorms,
                     "params": [p.tolist() for p in params]}))
    finally:
        dist.destroy_process_group()
