"""Persistent mapping cache: on-disk memoization of ``tcm_map`` optima.

A JSON-lines store under ``.tcm_cache/`` keyed by a content hash of
(einsum structure, architecture, objective, pruning flags, cache-format
version).  Re-mapping a model whose einsums were searched before is then
O(cache-hit) — the paper's seconds-per-einsum search cost is paid once per
unique (workload, arch, objective) and served in milliseconds afterwards.

Design points:

  * **Content-addressed keys.** ``compute_key`` hashes the *structural*
    einsum identity (``search.einsum_key`` — tensors + rank shapes, name
    ignored), the structural architecture identity (``arch.arch_key`` —
    canonical serialization, name ignored), the search objective and the
    pruning flag, plus :data:`CACHE_VERSION`.  Changing any of these yields
    a different key, so stale entries are never served — bumping
    ``CACHE_VERSION`` when the cost model changes invalidates the whole
    store without deleting it.
  * **Exact round-trips.** Mappings are serialized node-by-node and floats
    go through JSON's shortest-repr encoding, which round-trips Python
    floats bit-exactly — a cache hit returns a ``MappingResult`` identical
    to the cold search's (tested in ``tests/test_netmap_cache.py``).
  * **Append-only JSON-lines, torn-write safe.** Each ``put`` appends one
    line with flush + fsync, so a crash *after* a put cannot lose it and a
    crash *during* one leaves at most a single torn trailing line.  Loading
    tolerates corrupt or truncated lines as a backstop — they are counted
    (``n_corrupt``/``n_quarantined``), moved to a ``.quarantine`` side file
    for post-mortems, and the store is compacted in place (atomic temp +
    rename) so the damage never survives a reload.  Duplicate keys: last
    write wins.
  * **Thread-safe in-memory index with stat-based invalidation.** All
    public methods take an internal ``RLock``: concurrent ``get``/``put``
    from service threads can never tear the stats counters or interleave
    appends mid-line.  ``get``/``__contains__`` consult only the in-memory
    index — the JSONL is *never* rescanned per request.  External writers
    (another process warming the same store) are detected by a cheap
    ``os.stat`` signature (mtime_ns, size): when the file grew, only the
    new tail bytes are parsed incrementally; a shrink (external compaction
    or truncation) triggers a full reload with the usual quarantine
    behavior.  A trailing line with no newline is treated as an append in
    flight and left for the next poll, not quarantined.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union

from ..core.arch import Arch, arch_key
from ..core.einsum import Einsum
from ..core.fusion import FusedWorkload
from ..core.search import MapperStats, MappingResult, einsum_key
# wire helpers grew out of this module; they now live in core (the search
# checkpoint journal shares them) and are re-exported here for compatibility
from ..core.wire import (fused_mapping_from_wire, fused_mapping_to_wire,
                             mapping_from_wire, mapping_to_wire,
                             result_from_wire, result_to_wire,
                             stats_from_wire, stats_to_wire)

__all__ = [
    "CACHE_VERSION", "DEFAULT_ROOT", "CacheHit", "MappingCache",
    "compute_key", "compute_group_key",
    "mapping_to_wire", "mapping_from_wire", "fused_mapping_to_wire",
    "fused_mapping_from_wire", "result_to_wire", "result_from_wire",
    "stats_to_wire", "stats_from_wire",
]

# v2: two-phase shared-incumbent search — optimum *values* are unchanged,
# but a value-tied optimal mapping can be tie-broken differently than the
# per-unit search, so pre-existing entries are invalidated wholesale to keep
# the "a hit is identical to a cold search" guarantee honest.
# v3: fusion-aware planner — fused-group entries (keyed by group *content*:
# member structures + edge wiring) join the store and singleton results can
# now be composed against them, so the whole store is invalidated again.
# v4: architectures enter the key through their structural content hash
# (``arch_key``: name-insensitive canonical serialization) instead of
# ``repr(arch)`` — a DSE sweep point that derives hardware identical to a
# preset (or to another space's point) now shares its entry, so warm starts
# cross tool and naming boundaries; old name-keyed entries are invalidated.
CACHE_VERSION = 4
DEFAULT_ROOT = ".tcm_cache"


# --------------------------------------------------------------------------
# Keys
# --------------------------------------------------------------------------


def compute_key(einsum: Einsum, arch: Arch, objective: str,
                prune_partial: bool = True,
                version: Optional[int] = None) -> str:
    """Content hash of everything the search outcome depends on.

    Both workload and hardware enter through *structural* identities: the
    einsum via its structural key and the architecture via ``arch_key``
    (canonical serialization, names ignored) — matching the search-layer
    memoization, and letting DSE sweep points share entries with presets
    that describe the same hardware under a different name.
    """
    if version is None:
        version = CACHE_VERSION
    payload = repr((einsum_key(einsum), arch_key(arch), str(objective),
                    bool(prune_partial), int(version)))
    return hashlib.sha256(payload.encode()).hexdigest()


def compute_group_key(workload: FusedWorkload, arch: Arch, objective: str,
                      prune_partial: bool = True,
                      version: Optional[int] = None) -> str:
    """Content hash of a fusion group's joint-search inputs.

    Keyed by group *content*: every member's structural identity (names
    ignored, as for single einsums) plus the index-based edge wiring —
    two layers whose (qk, av) pairs have identical shapes and identical
    producer->consumer plumbing share one entry.
    """
    if version is None:
        version = CACHE_VERSION
    payload = repr((tuple(einsum_key(m) for m in workload.members),
                    workload.edges, arch_key(arch), str(objective),
                    bool(prune_partial), int(version)))
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclass
class CacheHit:
    """A deserialized cache entry: the optimum plus its search metadata.

    ``result`` is None for a *negative* fused-group entry — the group was
    searched and admits no fused mapping (or none was retained); the
    planner's fallback applies without re-running the joint search.
    """

    result: Optional[MappingResult]
    stats: MapperStats
    t_search: float  # wall seconds the original cold search took


# --------------------------------------------------------------------------
# The store
# --------------------------------------------------------------------------

_REQUIRED = ("v", "key", "mapping", "energy", "latency", "edp")


class MappingCache:
    """On-disk JSON-lines mapping store with hit/miss accounting."""

    def __init__(self, root: Union[str, Path] = DEFAULT_ROOT,
                 filename: str = "mappings.jsonl"):
        self.root = Path(root)
        self.path = self.root / filename
        self.quarantine_path = self.path.with_suffix(
            self.path.suffix + ".quarantine")
        self._entries: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.n_corrupt = 0  # lifetime total, incl. malformed-entry drops
        self.n_quarantined = 0  # corrupt *lines* moved aside at load
        self.n_reloads = 0  # external-change reloads (full or incremental)
        self._lock = threading.RLock()
        self._sig: Optional[tuple] = None  # (st_mtime_ns, st_size) or None
        self._offset = 0  # byte offset of JSONL consumed into the index
        with self._lock:
            self._load()

    # -- persistence -------------------------------------------------------

    def _stat_sig(self) -> Optional[tuple]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _load(self) -> None:
        """Full (re)scan of the JSONL into the in-memory index.

        Caller holds ``self._lock``.  Quarantines corrupt lines and
        compacts the store atomically, exactly as at construction time.
        """
        self._entries.clear()
        self._offset = 0
        self._sig = None
        if not self.path.exists():
            return
        surviving: list = []  # raw lines to keep on compaction
        quarantined: list = []
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                    if not isinstance(rec, dict) or any(
                            k not in rec for k in _REQUIRED):
                        raise ValueError("missing required fields")
                except (ValueError, TypeError):
                    self.n_corrupt += 1
                    quarantined.append(stripped)
                    continue
                surviving.append(stripped)
                if rec["v"] != CACHE_VERSION:
                    continue  # older format: invalidated, not corrupt
                self._entries[rec["key"]] = rec  # duplicate keys: last wins
        if quarantined:
            # move the damage aside for post-mortems, then compact the
            # store atomically so the torn lines never survive a reload
            self.n_quarantined += len(quarantined)
            with open(self.quarantine_path, "a", encoding="utf-8") as f:
                for line in quarantined:
                    f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            tmp = self.path.with_suffix(self.path.suffix + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                for line in surviving:
                    f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        self._sig = self._stat_sig()
        self._offset = self._sig[1] if self._sig is not None else 0

    def _maybe_reload(self) -> None:
        """Fold external writes into the index without per-request rescans.

        Caller holds ``self._lock``.  One ``os.stat`` per call; when the
        signature matches the last consumed state this is a no-op.  Growth
        is consumed incrementally from the tracked byte offset; shrinkage
        (external compaction/truncation) or a corrupt complete line forces
        a full reload (which quarantines + compacts as usual).  Our own
        ``_append`` advances the signature itself, so same-process puts
        never pay a reload.
        """
        sig = self._stat_sig()
        if sig == self._sig:
            return
        self.n_reloads += 1
        if sig is None or sig[1] < self._offset:
            self._load()
            return
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            tail = f.read()
        pos = 0
        while True:
            nl = tail.find(b"\n", pos)
            if nl < 0:
                break  # no newline yet: append in flight, retry next poll
            raw, pos = tail[pos:nl], nl + 1
            stripped = raw.strip()
            if not stripped:
                continue
            try:
                rec = json.loads(stripped.decode("utf-8"))
                if not isinstance(rec, dict) or any(
                        k not in rec for k in _REQUIRED):
                    raise ValueError("missing required fields")
            except (ValueError, TypeError):
                # corrupt *complete* line: take the full-reload path so it
                # is quarantined and compacted exactly like at load time
                self._load()
                return
            if rec["v"] == CACHE_VERSION:
                self._entries[rec["key"]] = rec
        self._offset += pos
        if pos == len(tail):
            self._sig = sig  # fully caught up

    def _append(self, rec: dict) -> None:
        """Durable append: flush + fsync, so a crash after ``put`` returns
        cannot lose the entry and a crash mid-write can at worst leave one
        torn trailing line (quarantined and compacted away on next load).
        Holds the cache lock so two threads can never interleave lines or
        tear the tracked offset/signature."""
        with self._lock:
            os.makedirs(self.root, exist_ok=True)
            self._maybe_reload()  # consume any external tail first
            data = json.dumps(rec, separators=(",", ":")) + "\n"
            # a crashed external writer can leave a torn, newline-less tail;
            # appending straight after it would corrupt OUR line too.  Heal
            # it: terminate the partial line first so it quarantines alone.
            prefix = ""
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            if size:
                with open(self.path, "rb") as rf:
                    rf.seek(size - 1)
                    if rf.read(1) != b"\n":
                        prefix = "\n"
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(prefix + data)
                f.flush()
                os.fsync(f.fileno())
            sig = self._stat_sig()
            nbytes = len(data.encode("utf-8"))
            if sig is not None and sig[1] == self._offset + nbytes:
                # the common case: nothing slipped in between — advance the
                # signature so our own put never triggers a reload
                self._offset = sig[1]
                self._sig = sig
            # else: an external writer interleaved; leave the signature
            # stale so the next access incrementally consumes the mixed
            # tail (re-parsing our own line is idempotent: same key, same
            # record)

    # -- API ---------------------------------------------------------------

    def get(self, einsum: Einsum, arch: Arch, objective: str,
            prune_partial: bool = True) -> Optional[CacheHit]:
        key = compute_key(einsum, arch, objective, prune_partial)
        with self._lock:
            self._maybe_reload()
            rec = self._entries.get(key)
            if rec is None:
                self.misses += 1
                return None
            try:
                hit = CacheHit(result=result_from_wire(rec),
                               stats=stats_from_wire(rec.get("stats", {})),
                               t_search=float(rec.get("t_search", 0.0)))
            except (KeyError, IndexError, TypeError, ValueError):
                # JSON-valid but structurally malformed entry (hand-edited
                # or bit-rotted): drop it and fall back to a cold search
                del self._entries[key]
                self.n_corrupt += 1
                self.misses += 1
                return None
            self.hits += 1
            return hit

    def put(self, einsum: Einsum, arch: Arch, objective: str,
            result: MappingResult, stats: Optional[MapperStats] = None,
            t_search: float = 0.0, prune_partial: bool = True) -> str:
        key = compute_key(einsum, arch, objective, prune_partial)
        rec = {
            "v": CACHE_VERSION,
            "key": key,
            "einsum": einsum.name,
            "arch": arch.name,
            "arch_key": arch_key(arch),  # structural id: DSE sweep dedup/debug
            "objective": str(objective),
            "t_search": float(t_search),
            "stats": stats_to_wire(stats) if stats is not None else {},
            **result_to_wire(result),
        }
        with self._lock:
            self._entries[key] = rec
            self._append(rec)
        return key

    # -- fused groups ------------------------------------------------------

    def get_group(self, workload: FusedWorkload, arch: Arch, objective: str,
                  prune_partial: bool = True) -> Optional[CacheHit]:
        """Fused-group lookup; a hit may carry ``result=None`` (the group
        was searched before and admits no fused mapping)."""
        key = compute_group_key(workload, arch, objective, prune_partial)
        with self._lock:
            self._maybe_reload()
            rec = self._entries.get(key)
            if rec is None:
                self.misses += 1
                return None
            try:
                result = (None if rec["mapping"] is None
                          else result_from_wire(rec))
                hit = CacheHit(result=result,
                               stats=stats_from_wire(rec.get("stats", {})),
                               t_search=float(rec.get("t_search", 0.0)))
            except (KeyError, IndexError, TypeError, ValueError):
                del self._entries[key]
                self.n_corrupt += 1
                self.misses += 1
                return None
            self.hits += 1
            return hit

    def put_group(self, workload: FusedWorkload, arch: Arch, objective: str,
                  result: Optional[MappingResult],
                  stats: Optional[MapperStats] = None,
                  t_search: float = 0.0, prune_partial: bool = True) -> str:
        key = compute_group_key(workload, arch, objective, prune_partial)
        rec = {
            "v": CACHE_VERSION,
            "key": key,
            "group": workload.name,
            "arch": arch.name,
            "arch_key": arch_key(arch),
            "objective": str(objective),
            "t_search": float(t_search),
            "stats": stats_to_wire(stats) if stats is not None else {},
            **(result_to_wire(result) if result is not None
               else {"mapping": None, "energy": None, "latency": None,
                     "edp": None}),
        }
        with self._lock:
            self._entries[key] = rec
            self._append(rec)
        return key

    def clear(self) -> None:
        """Drop all entries, in memory and on disk."""
        with self._lock:
            self._entries.clear()
            self._sig = None
            self._offset = 0
            if self.path.exists():
                self.path.unlink()
            if self.quarantine_path.exists():
                self.quarantine_path.unlink()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            self._maybe_reload()
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            self._maybe_reload()
            return key in self._entries
