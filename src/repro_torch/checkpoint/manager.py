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
``restore_to`` puts them on a device and takes the place of the
reference's ``restore_sharded``.
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

from ..models.lm import tree_leaves, tree_map, tree_unflatten


def _host(x) -> np.ndarray:
    """A copy of ``x`` in host memory, which later in-place updates of
    ``x`` do not reach.  numpy has no bfloat16: a bf16 tensor keeps its
    2-byte bits as ``|V2``, as the reference's file holds a bf16 leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
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
    return {f"leaf_{i}": _host(x) for i, x in enumerate(tree_leaves(tree))}


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
        self._write(step, _flatten(tree), extra or {})

    def save_async(self, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        self.wait()  # one outstanding write at a time
        arrays = _flatten(tree)  # host copy happens here, synchronously

        def work():
            try:
                self._write(step, arrays, extra or {})
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
