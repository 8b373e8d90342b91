"""Each rank's host memory in a sharded checkpoint, on 2 gloo ranks.

``CheckpointManager.save``/``save_async`` gather every DTensor leaf on
every rank (a collective), but only the writer, rank 0, copies it to host
memory; ``restore_sharded`` reads, places and frees one leaf at a time.
The ranks count the bytes ``manager._host`` returns and the bytes and
live arrays of every npz member read (``NpzFile.__getitem__`` wrapped,
each array watched through a weak reference), for a tree of (8, 1000) f32
DTensors split on dim 0: a leaf is 32000 bytes whole.
"""
from __future__ import annotations

import datetime
import json
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sharded import GROUP_TIMEOUT_S, _join

WORLD = 2
SHAPE = (8, 1000)
LEAF_BYTES = SHAPE[0] * SHAPE[1] * 4
DEADLINE_S = 120


def _rank(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        report = _work(rank, out)
        (out / f"r{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _work(rank: int, out: Path) -> dict:
    from repro_torch.checkpoint import manager
    from repro_torch.distributed.sharding import (NamedSharding, P, place)
    from repro_torch.launch.mesh import Mesh, device_mesh

    mesh = device_mesh(Mesh(("data",), (WORLD,)), "cpu")
    split = NamedSharding(mesh, P("data", None))
    gen = torch.Generator().manual_seed(0)
    whole = {k: torch.randn(SHAPE, generator=gen) for k in ("v", "w")}
    report = {"save": {}}

    copied = {"bytes": 0}
    host = manager._host

    def counted(x):
        a = host(x)
        copied["bytes"] += a.nbytes
        return a

    manager._host = counted
    try:
        for how in ("save", "save_async"):
            copied["bytes"] = 0
            mgr = manager.CheckpointManager(str(out / how))
            tree = {"w": place(whole["w"].clone(), split)}
            getattr(mgr, how)(1, tree)
            mgr.wait()
            report["save"][how] = copied["bytes"]
    finally:
        manager._host = host

    mgr = manager.CheckpointManager(str(out / "two"))
    mgr.save(1, {k: place(t.clone(), split) for k, t in whole.items()})
    reads, live = [], []
    getitem = np.lib.npyio.NpzFile.__getitem__

    def watched(self, key):
        a = getitem(self, key)
        held = [r for r in live if r() is not None]
        reads.append({"bytes": int(a.nbytes), "held": len(held) + 1})
        live[:] = held + [weakref.ref(a)]
        return a

    np.lib.npyio.NpzFile.__getitem__ = watched
    try:
        tree, _ = mgr.restore_sharded(1, {"v": 0, "w": 0},
                                      {"v": split, "w": split})
    finally:
        np.lib.npyio.NpzFile.__getitem__ = getitem
    report["reads"] = reads
    report["equal"] = {k: bool(torch.equal(tree[k].full_tensor(), whole[k]))
                       for k in whole}
    report["local_rows"] = {k: list(tree[k].to_local().shape)
                            for k in whole}
    return report


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    import torch.multiprocessing as tmp

    out = tmp_path_factory.mktemp("ckpt_ranks")
    ctx = tmp.start_processes(_rank, args=(WORLD, str(out)), nprocs=WORLD,
                              join=False, start_method="spawn")
    _join(ctx, time.monotonic() + DEADLINE_S)
    return [json.loads((out / f"r{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("how", ["save", "save_async"])
def test_only_the_writer_copies_a_gathered_leaf_to_the_host(reports, how):
    """Rank 0 copies the whole leaf (32000 B); rank 1 joins the gather and
    copies nothing."""
    assert reports[0]["save"][how] == LEAF_BYTES
    assert reports[1]["save"][how] == 0


def test_restore_sharded_holds_one_leaf_at_a_time(reports):
    """Each rank reads both leaves whole, one after the other: the first
    is freed (placed as its shard) before the second is read."""
    for r, rep in enumerate(reports):
        assert [x["bytes"] for x in rep["reads"]] == [LEAF_BYTES] * 2, r
        assert max(x["held"] for x in rep["reads"]) == 1, (r, rep["reads"])


def test_restore_sharded_is_bitwise_and_keeps_the_split(reports):
    for rep in reports:
        assert all(rep["equal"].values())
        assert rep["local_rows"] == {k: [SHAPE[0] // WORLD, SHAPE[1]]
                                     for k in ("v", "w")}
