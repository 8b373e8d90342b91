"""Checkpointing: atomic, async, retention-managed.

Port of ``repro.checkpoint.manager``, with its layout:
``<dir>/step_<N>/arrays.npz + meta.json``.  Writes go to ``step_<N>.tmp``
and are renamed into place with ``os.replace``, so a preempted or crashed
writer never corrupts the latest checkpoint; ``keep`` checkpoints are
retained.  ``save_async`` copies the tensors to host memory before it
returns (the train step then updates them in place) and hands the write to
a thread; one write is outstanding at a time, and its error is raised by
the next ``wait``.  Leaves are numbered in ``jax.tree.flatten``'s order
(dict keys sorted, lists and tuples in order), so a checkpoint written by
either package restores in the other.  ``restore`` returns numpy arrays;
``restore_to`` puts them on one device and ``restore_sharded`` places them
on the current mesh, whatever mesh wrote them (the elastic restore).

Under a process group a DTensor leaf is gathered whole (``full_tensor``,
a collective) on the calling thread, never in the writer thread, where it
would race the step's collectives; rank 0 writes, and only rank 0 copies
the gathered leaves to host memory: the others drop each on the device
before the next gather.  Every rank leaves ``save`` and ``wait`` only once
the write is committed (a barrier).  ``restore_sharded`` reads, places and
frees one leaf at a time, so no rank holds more than one whole leaf in
host memory.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import full, is_dtensor, place
from ..models.lm import tree_leaves, tree_map, tree_unflatten, tree_zip


def _grouped() -> bool:
    return dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not _grouped() or dist.get_rank() == 0


def _host(x) -> np.ndarray:
    """A copy of ``x`` in host memory, which later in-place updates of
    ``x`` do not reach.  numpy has no bfloat16: a bf16 tensor keeps its
    2-byte bits as ``|V2``, as the reference's file holds a bf16 leaf.
    A DTensor is gathered whole first (a collective on every rank)."""
    if isinstance(x, torch.Tensor):
        x = full(x).detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.array(x)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor; a ``|V2`` leaf is read back as bfloat16."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """The writer's host copy of every leaf, by name.  Every other rank
    joins each DTensor leaf's gather (a collective) and drops the result
    on its device before the next one: it keeps no host copy."""
    if _writer():
        return {f"leaf_{i}": _host(x)
                for i, x in enumerate(tree_leaves(tree))}
    for x in tree_leaves(tree):
        if is_dtensor(x):
            full(x)
    return {}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # one entry per finished write: step, seconds to write, bytes
        self.writes: List[Dict] = []

    # ---------------- write path ----------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        arrays = _flatten(tree)
        if _writer():
            self._write(step, arrays, extra or {})
        if _grouped():
            dist.barrier()

    def save_async(self, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        self.wait()  # one outstanding write at a time
        # host copy (and the gather of DTensor leaves) happens here,
        # synchronously, on the calling thread
        arrays = _flatten(tree)
        if not _writer():
            return

        def work():
            try:
                self._write(step, arrays, extra or {})
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the outstanding write; under a process group every
        rank waits for rank 0's.  Raises the write's error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _grouped():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               extra: Dict) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "n_arrays": len(arrays), "extra": extra}))
        nbytes = sum(f.stat().st_size for f in tmp.iterdir())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()
        self.writes.append({"step": step, "write_s": time.perf_counter() - t0,
                            "bytes": nbytes})

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- read path ----------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like_tree`` (its leaves are not
        read): (tree of numpy arrays, the ``extra`` saved with it)."""
        d = self.dir / f"step_{step:08d}"
        with np.load(d / "arrays.npz") as data:
            arrays = {k: data[k] for k in data.files}
        meta = json.loads((d / "meta.json").read_text())
        return tree_unflatten(like_tree, [arrays[f"leaf_{i}"]
                                          for i in range(len(arrays))]), \
            meta.get("extra", {})

    def restore_to(self, step: int, like_tree, device) -> Tuple[Any, Dict]:
        """``restore``, with every array a tensor on ``device`` (a
        ``|V2`` leaf as bfloat16)."""
        host_tree, extra = self.restore(step, like_tree)
        return tree_map(lambda a: _tensor(a).to(device), host_tree), extra

    def restore_sharded(self, step: int, like_tree,
                        shardings) -> Tuple[Any, Dict]:
        """``restore``, with every array placed by its ``NamedSharding`` in
        ``shardings`` (``like_tree``'s structure) on that sharding's
        ``DeviceMesh``: each rank reads the file one leaf at a time, keeps
        its shards on its own device and frees the leaf before reading
        the next, whatever mesh wrote it.  Raises ValueError unless the
        file holds one array per leaf of ``like_tree``."""
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        pairs = list(tree_zip(like_tree, shardings))
        leaves = []
        # ``np.load`` of an npz reads a member only when it is indexed
        with np.load(d / "arrays.npz") as data:
            if len(data.files) != len(pairs):
                raise ValueError(f"{len(data.files)} leaves for a tree of "
                                 f"{len(pairs)}")
            for i, (_, s) in enumerate(pairs):
                leaves.append(place(_tensor(data[f"leaf_{i}"])
                                    .to(_device(s.mesh)), s))
        return tree_unflatten(like_tree, leaves), meta.get("extra", {})


def _device(mesh) -> torch.device:
    """This rank's device of the ``DeviceMesh`` ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
