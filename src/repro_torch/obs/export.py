"""Trace exports: JSONL event log and Chrome-trace/Perfetto JSON.

Two on-disk formats, one in-memory event model (``tracer.Event`` dicts):

  * **JSONL** (``write_jsonl`` / ``read_jsonl``): one event per line,
    verbatim — the canonical machine-readable log (append-friendly, greppable,
    loadable back for ``python -m repro.obs report``).
  * **Chrome trace** (``write_chrome``): the ``{"traceEvents": [...]}``
    JSON object format both ``chrome://tracing`` and https://ui.perfetto.dev
    load directly.  Spans become complete ("X") events, instants "i",
    counters "C"; timestamps are rebased to the earliest event and converted
    to microseconds; per-pid metadata ("M") events name the driver and
    worker tracks.  All of our ``args`` ride along, so nothing is lost in
    the conversion — ``read_trace`` inverts it.

``read_trace`` auto-detects either format, so every consumer (the report
CLI, tests) accepts whichever file a ``--trace`` flag produced.
"""
from __future__ import annotations

import json
from typing import List

from .tracer import Event, event_sort_key


def write_jsonl(events: List[Event], path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for ev in sorted(events, key=event_sort_key):
            f.write(json.dumps(ev, separators=(",", ":")) + "\n")


def read_jsonl(path) -> List[Event]:
    out: List[Event] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def to_chrome(events: List[Event]) -> dict:
    """Convert to the Chrome trace-event JSON object format."""
    events = sorted(events, key=event_sort_key)
    t0 = events[0]["ts"] if events else 0.0
    pids: List[int] = []
    trace: List[dict] = []
    for ev in events:
        if ev["pid"] not in pids:
            pids.append(ev["pid"])
        rec = {
            "ph": ev["ph"],
            "name": ev["name"],
            "cat": ev.get("cat", "trace"),
            "ts": (ev["ts"] - t0) * 1e6,
            "pid": ev["pid"],
            "tid": ev.get("tid", 0),
            "args": ev.get("args", {}),
        }
        if ev["ph"] == "X":
            rec["dur"] = ev.get("dur", 0.0) * 1e6
        elif ev["ph"] == "i":
            rec["s"] = "p"  # process-scoped instant marker
        trace.append(rec)
    # name the tracks: the first pid seen is the driver (its spans open the
    # trace), later pids are pool workers in first-appearance order
    meta = []
    for i, pid in enumerate(pids):
        name = "mapper driver" if i == 0 else f"search worker {i}"
        meta.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                     "args": {"name": name}})
    return {
        "traceEvents": meta + trace,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro.obs", "epoch_s": t0},
    }


def write_chrome(events: List[Event], path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome(events), f, separators=(",", ":"))


def from_chrome(doc: dict) -> List[Event]:
    """Invert ``to_chrome``: recover the internal event list."""
    t0 = float(doc.get("otherData", {}).get("epoch_s", 0.0))
    out: List[Event] = []
    for rec in doc.get("traceEvents", []):
        if rec.get("ph") == "M":
            continue
        ev: Event = {
            "ph": rec["ph"],
            "name": rec["name"],
            "cat": rec.get("cat", "trace"),
            "ts": t0 + rec["ts"] / 1e6,
            "pid": rec.get("pid", 0),
            "tid": rec.get("tid", 0),
            "args": rec.get("args", {}),
        }
        if rec.get("ph") == "X":
            ev["dur"] = rec.get("dur", 0.0) / 1e6
        out.append(ev)
    return out


def read_trace(path) -> List[Event]:
    """Load a trace file in either format (JSONL or Chrome JSON).

    Both formats open with ``{``, so detection must actually parse: a file
    that loads as one JSON document holding ``traceEvents`` is a Chrome
    trace; anything else (including a one-line event log, which is also a
    complete JSON document) is treated as JSONL.
    """
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "traceEvents" in doc:
            return from_chrome(doc)
    except json.JSONDecodeError:
        pass  # multi-line JSONL is not a single JSON document
    return read_jsonl(path)
