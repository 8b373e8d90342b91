"""Structured search telemetry: spans, typed events, process-safe buffers.

The tracing model is deliberately tiny — three event kinds, stored as plain
JSON-safe dicts so they cross process boundaries (pickled inside
``WorkResult.events``) and serialize to both the JSONL event log and the
Chrome-trace/Perfetto export (``obs/export.py``) without translation layers:

  * **span** (``ph="X"``): a named duration with wall-clock start and
    length — driver phases (``enumerate``, ``search``), per-work-unit
    explorations, per-DSE-point evaluations.  Spans nest lexically via a
    context manager; the hierarchy is reconstructed from (pid, time
    containment) at read time, so emitting stays allocation-cheap.
  * **instant** (``ph="i"``): a point event — incumbent tightenings, cache
    hits/misses, fusion adoption decisions, roofline prunes.
  * **counter** (``ph="C"``): numeric samples — per-step frontier sizes and
    per-criterion prune attribution inside the tile-shape search.

Timestamps are ``time.time()`` epoch seconds: comparable *across processes*
on one host, which is what lets pool-worker buffers merge with the driver's
events into one coherent timeline (worker wall clocks and the driver's share
an epoch; ``perf_counter`` offsets would not).

**Zero-overhead contract.**  Tracing is off by default everywhere: hot-path
functions take ``tracer=None`` and guard every emission with an identity
check, so a disabled run executes the exact pre-tracing instruction stream —
bit-identical optima and ``MapperStats`` (tested in ``tests/test_obs.py``).
:class:`NullTracer` exists for call sites that prefer unconditional calls;
:func:`active` normalizes either spelling (``None`` or a disabled tracer)
to ``None`` at API boundaries.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

Event = Dict[str, Any]

# event categories (the taxonomy; see docs/observability.md)
CAT_DRIVER = "driver"  # tcm_map / tcm_map_group / map_network / sweeps
CAT_PHASE = "phase"  # enumerate / seed / search phases inside a driver call
CAT_UNIT = "unit"  # one (dataplacement x skeleton) work-unit exploration
CAT_STEP = "step"  # per-site expansion samples inside one unit
CAT_INCUMBENT = "incumbent"  # global bound tightenings
CAT_CACHE = "cache"  # MappingCache hit / miss / negative-entry events
CAT_FUSION = "fusion"  # per-group fusion adoption decisions
CAT_DSE = "dse"  # per-arch-point outcomes in a design-space sweep
CAT_BUDGET = "budget"  # anytime-search events: expiry, skipped points
CAT_FAULT = "fault"  # resilience events: retries, pool restarts,
#                      serial fallbacks, quarantines, interrupts
CAT_CHECKPOINT = "checkpoint"  # journal resume hits
CAT_SERVICE = "service"  # online mapping service: per-request spans, queue
#                          depth, hit/miss/coalesced/bucketed counters


class NullTracer:
    """Disabled tracer: every operation is a no-op.

    Usable anywhere a :class:`Tracer` is, with the same surface; the
    bit-identical-results contract is tested against both this and plain
    ``tracer=None`` (hot paths normalize one to the other via
    :func:`active`).
    """

    enabled = False
    events: List[Event] = []  # always empty; never mutated

    @contextmanager
    def span(self, name: str, cat: str = CAT_DRIVER, **args) -> Iterator[None]:
        yield

    def complete(self, name: str, t0: float, cat: str = CAT_DRIVER,
                 **args) -> None:
        pass

    def instant(self, name: str, cat: str = CAT_DRIVER, **args) -> None:
        pass

    def counter(self, name: str, cat: str = CAT_STEP, **args) -> None:
        pass

    def extend(self, events: Optional[List[Event]]) -> None:
        pass


NULL_TRACER = NullTracer()


def active(tracer) -> Optional["Tracer"]:
    """Normalize a ``tracer`` argument: enabled tracer or ``None``.

    Public entry points accept ``None`` *or* any tracer object; hot loops
    only ever see an enabled tracer or ``None``, so the disabled path is a
    single identity comparison.
    """
    if tracer is None or not getattr(tracer, "enabled", False):
        return None
    return tracer


class Tracer:
    """In-memory event buffer with wall-clock spans/instants/counters.

    One tracer belongs to one process: the driver owns the master buffer;
    pool workers build a fresh ``Tracer`` per work unit and ship its
    ``events`` back inside the picklable ``WorkResult``, where the engine
    merges them in unit order (deterministic stream layout regardless of
    worker scheduling).
    """

    enabled = True

    def __init__(self) -> None:
        self.events: List[Event] = []
        self.pid = os.getpid()

    # -- emission ----------------------------------------------------------

    @contextmanager
    def span(self, name: str, cat: str = CAT_DRIVER, **args) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.events.append({
                "ph": "X", "name": name, "cat": cat, "ts": t0,
                "dur": time.time() - t0, "pid": self.pid, "tid": 0,
                "args": args,
            })

    def complete(self, name: str, t0: float, cat: str = CAT_DRIVER,
                 **args) -> None:
        """Append a span whose start ``t0`` (``time.time()``) the caller
        timed — for hot functions with multiple exits where a context
        manager would force restructuring."""
        self.events.append({
            "ph": "X", "name": name, "cat": cat, "ts": t0,
            "dur": time.time() - t0, "pid": self.pid, "tid": 0,
            "args": args,
        })

    def instant(self, name: str, cat: str = CAT_DRIVER, **args) -> None:
        self.events.append({
            "ph": "i", "name": name, "cat": cat, "ts": time.time(),
            "pid": self.pid, "tid": 0, "args": args,
        })

    def counter(self, name: str, cat: str = CAT_STEP, **args) -> None:
        self.events.append({
            "ph": "C", "name": name, "cat": cat, "ts": time.time(),
            "pid": self.pid, "tid": 0, "args": args,
        })

    # -- merging / persistence --------------------------------------------

    def extend(self, events: Optional[List[Event]]) -> None:
        """Append a worker-side buffer (already in that worker's emission
        order); callers merge buffers in unit order for determinism."""
        if events:
            self.events.extend(events)

    def save(self, path) -> None:
        """Write the buffer: ``*.jsonl`` -> JSONL event log, anything else
        -> Chrome-trace/Perfetto JSON (see ``obs/export.py``)."""
        from .export import write_chrome, write_jsonl
        if str(path).endswith(".jsonl"):
            write_jsonl(self.events, path)
        else:
            write_chrome(self.events, path)


def event_sort_key(ev: Event):
    """Chronological ordering key (stable across merged buffers)."""
    return (ev["ts"], ev.get("dur", 0.0))


def to_jsonable(events: List[Event]) -> List[Event]:
    """Defensive pass-through: every event must already be JSON-safe (they
    cross process *and* file boundaries); raise early if one is not."""
    for ev in events:
        json.dumps(ev)
    return events
