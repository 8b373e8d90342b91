"""CLI: inspect and convert search traces.

  # human profile report (phase breakdown, top units, incumbent timeline)
  PYTHONPATH=src python -m repro_torch.obs report trace.jsonl
  PYTHONPATH=src python -m repro_torch.obs trace.json --top 20  # report

  # convert a JSONL event log to Chrome-trace JSON (load in Perfetto)
  PYTHONPATH=src python -m repro_torch.obs chrome trace.jsonl -o trace.json

Trace files come from the ``--trace PATH`` flag on ``python -m
repro_torch.netmap`` (and, in the reference package, on ``repro.dse``,
``repro.gap`` and ``benchmarks.run``): a ``.jsonl`` path writes the raw JSONL event log, any
other extension writes Chrome-trace JSON directly.  Both commands here
accept either format.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .export import read_trace, write_chrome, write_jsonl
from .report import profile

COMMANDS = ("report", "chrome", "jsonl")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Search-trace profile reports and format conversion.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="print the human profile report")
    rep.add_argument("trace", help="trace file (.jsonl or Chrome JSON)")
    rep.add_argument("--top", type=int, default=10,
                     help="most-expensive work units to list (default: 10)")

    chrome = sub.add_parser(
        "chrome", help="convert to Chrome-trace JSON (Perfetto-loadable)")
    chrome.add_argument("trace")
    chrome.add_argument("-o", "--out", required=True)

    jsonl = sub.add_parser("jsonl", help="convert to the JSONL event log")
    jsonl.add_argument("trace")
    jsonl.add_argument("-o", "--out", required=True)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # bare `python -m repro_torch.obs trace.jsonl` implies `report`
    if argv and argv[0] not in COMMANDS and not argv[0].startswith("-"):
        argv.insert(0, "report")
    args = build_parser().parse_args(argv)

    events = read_trace(args.trace)
    if args.cmd == "report":
        try:
            print(profile(events).render(top_k=args.top))
        except BrokenPipeError:  # report piped into head/less and truncated
            sys.stderr.close()  # suppress the interpreter's EPIPE warning
            return 0
    elif args.cmd == "chrome":
        write_chrome(events, args.out)
        print(f"wrote {args.out} ({len(events)} events) — load it at "
              "https://ui.perfetto.dev or chrome://tracing")
    else:
        write_jsonl(events, args.out)
        print(f"wrote {args.out} ({len(events)} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
