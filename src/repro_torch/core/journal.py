"""Search checkpoints and replayable unit repros (resilience layer).

Two durable artifacts live here, both JSON under ``.tcm_cache/`` by
default:

  * :class:`SearchCheckpoint` — a JSON-lines journal of finished
    :class:`~repro.core.search.WorkResult` records, addressed by a
    *content* key of the work unit (workload structure + ``arch_key`` +
    skeleton + objective + pruning flag — deliberately **not** the unit's
    positional index, so a resumed run whose enumeration order shifted
    still hits).  Engines append each result as it completes (flush +
    fsync, so a crash mid-run loses at most the in-flight line) and serve
    journaled units without re-searching on the next run — this is what
    makes interrupted DSE sweeps, netmap full-model runs and gap fuzzing
    campaigns resumable.  Truncated (budget-expired) and quarantined
    results are *not* served on resume: they are exactly the units a
    resumed run should finish properly.

  * Quarantine repros — single-file JSON descriptions of work units that
    repeatedly killed pool workers (``write_unit_repro``), in the same
    spirit and envelope style as ``gap/soundness.py`` fuzz repros
    (``schema`` + serialized workload + arch), plus the skeleton and the
    failure note.  ``replay_unit`` reloads one and runs it in-process
    under a debugger.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Union

from .arch import arch_from_dict, arch_key, arch_to_dict
from .einsum import einsum_from_dict, einsum_to_dict
from .fusion import FusedWorkload
from .wire import (result_from_wire, result_to_wire, skeleton_from_wire,
                   skeleton_to_wire, workload_from_wire, workload_to_wire)

CHECKPOINT_VERSION = 1
REPRO_SCHEMA = 1
DEFAULT_ROOT = ".tcm_cache"
QUARANTINE_DIRNAME = "quarantine"


def unit_checkpoint_key(unit) -> str:
    """Content hash of everything a unit's outcome depends on.

    Same structural-identity discipline as ``netmap.cache.compute_key``:
    the einsum enters via its structural key (name ignored), the arch via
    ``arch_key``; the skeleton's deterministic dataclass ``repr`` pins the
    exact (dataplacement, dataflow) slice this unit searches.
    """
    from .fusion import workload_key
    from .search import einsum_key
    if isinstance(unit.einsum, FusedWorkload):
        wl = ("fused", workload_key(unit.einsum))
    else:
        wl = ("einsum", einsum_key(unit.einsum))
    payload = repr((CHECKPOINT_VERSION, wl, arch_key(unit.arch),
                    repr(unit.skeleton), str(unit.objective),
                    bool(unit.prune_partial)))
    return hashlib.sha256(payload.encode()).hexdigest()


def _fsync_append(path: Path, line: str) -> None:
    """Append one journal line durably: flush + fsync before returning, so
    an interrupt after the call cannot lose the record and an interrupt
    during it can at worst leave one torn trailing line (tolerated and
    counted by the loader)."""
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


class SearchCheckpoint:
    """JSON-lines journal of finished work-unit results, content-addressed.

    ``get``/``put`` take the :class:`~repro.core.search.WorkUnit` itself;
    keys are computed internally.  Loading tolerates torn/corrupt lines
    (``n_corrupt``, skipped) and duplicate keys (last write wins), so the
    journal survives the crashes it exists to cover.
    """

    def __init__(self, root: Union[str, Path] = DEFAULT_ROOT,
                 filename: str = "search_checkpoint.jsonl"):
        self.root = Path(root)
        self.path = self.root / filename
        self._entries: Dict[str, dict] = {}
        self.hits = 0
        self.puts = 0
        self.n_corrupt = 0
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict) or "key" not in rec:
                        raise ValueError("missing key")
                except (ValueError, TypeError):
                    self.n_corrupt += 1
                    continue
                if rec.get("v") != CHECKPOINT_VERSION:
                    continue
                self._entries[rec["key"]] = rec

    def get(self, unit):
        """Return the journaled :class:`WorkResult` for ``unit`` (re-indexed
        to the unit's current position), or ``None``.  Truncated and
        quarantined records are treated as misses — a resumed run re-runs
        exactly the units the interrupted run did not finish properly."""
        from .search import WorkResult, stats_from_dict
        rec = self._entries.get(unit_checkpoint_key(unit))
        if rec is None or rec.get("truncated") or rec.get("quarantined"):
            return None
        try:
            cand = (None if rec.get("candidate") is None
                    else result_from_wire(rec["candidate"]))
            stats = stats_from_dict(rec.get("stats", {}))
        except (KeyError, IndexError, TypeError, ValueError):
            self._entries.pop(unit_checkpoint_key(unit), None)
            self.n_corrupt += 1
            return None
        stats.n_resumed_units = 1
        self.hits += 1
        return WorkResult(unit.index, cand, stats)

    def put(self, unit, result) -> Optional[str]:
        """Journal one finished result.  Truncated or quarantined results
        are skipped (they must be re-run on resume, so journaling them
        would defeat the point); returns the key when written."""
        if result.truncated or result.stats.n_quarantined_units:
            return None
        key = unit_checkpoint_key(unit)
        rec = {
            "v": CHECKPOINT_VERSION,
            "key": key,
            "index": unit.index,
            "objective": str(unit.objective),
            "candidate": (None if result.candidate is None
                          else result_to_wire(result.candidate)),
            "stats": result.stats.to_dict(),
            "truncated": bool(result.truncated),
        }
        self._entries[key] = rec
        _fsync_append(self.path, json.dumps(rec, separators=(",", ":")))
        self.puts += 1
        return key

    def clear(self) -> None:
        self._entries.clear()
        if self.path.exists():
            self.path.unlink()

    def __len__(self) -> int:
        return len(self._entries)


# --------------------------------------------------------------------------
# Quarantine repros
# --------------------------------------------------------------------------


def unit_to_repro(unit, error: str = "", attempts: int = 0) -> dict:
    """Self-contained JSON description of one work unit (the fuzz-repro
    envelope of ``gap/soundness.py``, extended with the skeleton)."""
    rec: Dict[str, object] = {
        "schema": REPRO_SCHEMA,
        "kind": "work_unit",
        "index": unit.index,
        "objective": str(unit.objective),
        "prune_partial": bool(unit.prune_partial),
        "arch": arch_to_dict(unit.arch),
        "skeleton": skeleton_to_wire(unit.skeleton),
        "error": error,
        "attempts": int(attempts),
    }
    if isinstance(unit.einsum, FusedWorkload):
        rec["workload"] = workload_to_wire(unit.einsum)
    else:
        rec["einsum"] = einsum_to_dict(unit.einsum)
    return rec


def unit_from_repro(rec: dict):
    from .search import WorkUnit
    if "workload" in rec:
        einsum = workload_from_wire(rec["workload"])
    else:
        einsum = einsum_from_dict(rec["einsum"])
    return WorkUnit(
        index=int(rec.get("index", 0)),
        einsum=einsum,
        arch=arch_from_dict(rec["arch"]),
        skeleton=skeleton_from_wire(rec["skeleton"]),
        objective=rec.get("objective", "edp"),
        prune_partial=bool(rec.get("prune_partial", True)),
    )


def write_unit_repro(unit, error: str, attempts: int,
                     root: Union[str, Path]) -> str:
    """Write a replayable quarantine repro; atomic (temp + ``os.replace``)
    so a crash mid-write cannot leave a torn repro file."""
    root = Path(root)
    os.makedirs(root, exist_ok=True)
    rec = unit_to_repro(unit, error=error, attempts=attempts)
    path = root / f"unit_{unit_checkpoint_key(unit)[:16]}.json"
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return str(path)


def replay_unit(path: Union[str, Path]):
    """Reload a quarantine repro and run it in-process (no pool, no budget)
    — the debugging entry point for poison units."""
    from .search import run_work_unit
    with open(path, "r", encoding="utf-8") as f:
        rec = json.load(f)
    return run_work_unit(unit_from_repro(rec))
