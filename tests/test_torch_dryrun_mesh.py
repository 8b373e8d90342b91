"""The dry-run's fake trace of one rank against the real sharded step on
gloo ranks, on the CPU.

On the meshes (data, model) (2, 1), (1, 2), (2, 2) and (pod, data, model)
(2, 2, 1), rank 0's fake trace (``launch.dryrun.trace_step`` over a fake
group) of each case of ``dryrun_mesh_ranks.CASES`` (the smoke dense, moe
and ssm configs, train and decode, in their reference modes and
``tp_fsdp``; on (2, 2, 1) the five of ``POD_CASES``) equals the same
counters over the real step on rank 0 of a gloo group: FLOPs, bytes, ops,
every memory count (arguments, peak) and the collective bytes of each
kind, exactly.  And the dense model trained 3 steps in ``tp_fsdp`` on
(2, 2, 1), where each layer is gathered over the flattened ('pod',
'data') group, equals one device at ``tests/test_torch_sharded_modes.py``'s
tolerance.

The ranks (``tests/dryrun_mesh_ranks.py``, torch only) run as two groups,
of 4 and of 2, started once for every case, beside one process per group
that traces its cases; all under a deadline.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import dryrun_mesh_ranks as R
from test_torch_sharded import TOL, _join

DEADLINE_S = 600
RUNS = [(shape, case) for world in (4, 2) for shape, _ in R.MESHES[world]
        for case in R.cases_on(shape)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups of ranks, at once; the directory of their results."""
    import torch.multiprocessing as tmp

    out = tmp_path_factory.mktemp("dryrun_mesh")
    deadline = time.monotonic() + DEADLINE_S
    groups = [tmp.start_processes(fn, args=(world, str(out)), nprocs=n,
                                  join=False, start_method="spawn")
              for world in (4, 2)
              for fn, n in ((R.rank_main, world), (R.fake_main, 1))]
    try:
        for g in groups:
            _join(g, deadline)
    finally:
        for g in groups:
            for p in g.processes:
                if p.is_alive():
                    p.kill()
    return out


@pytest.mark.parametrize("shape,case", RUNS,
                         ids=[R.tag(s, c) for s, c in RUNS])
def test_fake_trace_equals_the_real_step(runs, shape, case):
    fake = json.loads((runs / f"fake_{R.tag(shape, case)}.json").read_text())
    real = json.loads((runs / f"real_{R.tag(shape, case)}.json").read_text())
    assert fake["memory_per_device"] == real["memory_per_device"]
    assert fake["cost_analysis"] == real["cost_analysis"]
    for key in ("per_device_flops", "per_device_bytes", "collective_bytes",
                "total_collective_bytes", "ops"):
        assert fake["hlo"][key] == real["hlo"][key], key
    assert fake["hlo"]["per_device_flops"] > 0
    world = 1
    for n in shape:
        world *= n
    assert (real["hlo"]["total_collective_bytes"] > 0) == (world > 1)


def test_layers_gathered_over_two_mesh_dims_train_as_one_device(runs):
    """The stacks of 4 layers split over ('pod', 'data') of (2, 2, 1) (a
    ``Shard(0)`` on both dims; the gather broadcasts each layer over the
    flattened group and reduces its gradient back), 3 AdamW steps: loss,
    grad norm and parameters against one device at ``TOL``."""
    from repro_torch.launch.mesh import Mesh, device_mesh, fake_group
    from repro_torch.training.step import init_sharded

    shape, axes = R.GATHER_MESH
    with fake_group(Mesh(axes, shape)):
        dm = device_mesh(Mesh(axes, shape), "cpu")
        with FakeTensorMode():
            params = init_sharded(R.gather_cfg(), None, dm, "tp_fsdp")[0]
        wq = params["groups"][0][0]["attn"]["wq"]
        assert [p.is_shard(0) for p in wq.placements] == [True, True, False]
    got = json.loads((runs / "gather.json").read_text())
    losses, gnorms, params = R.train(R.gather_cfg())
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL)
    np.testing.assert_allclose(got["grad_norm"], gnorms, rtol=TOL)
    assert len(got["params"]) == len(params)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=TOL,
                                   atol=TOL)
    assert torch.isfinite(torch.tensor(got["loss"])).all()
