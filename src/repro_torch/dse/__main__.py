"""CLI: sweep an architecture design space against a workload.

  PYTHONPATH=src python -m repro_torch.dse --space edge-small --workload QK,FFA
  PYTHONPATH=src python -m repro_torch.dse --space edge --workload QK --workers 4
  PYTHONPATH=src python -m repro_torch.dse --space edge-small \
      --network qwen1_5_0_5b --fast        # whole-model sweep via netmap

Per-(einsum, arch-point) optima persist in the mapping cache
(``--cache-dir``, default ``.tcm_cache/``), so re-running a sweep — or a
sweep whose points overlap another space — is served warm.
``--check-parity N`` re-runs the first N points exhaustively and verifies
the pruned explorer returns the identical frontier (the CI smoke gate).

Resilience: ``--deadline S`` / ``--max-expanded N`` bound the whole sweep
(points past expiry are reported ``skipped_budget``; truncated evaluations
carry a certified optimality gap); ``--resume`` journals finished work
units so a Ctrl-C'd sweep — which prints its partial report and exits 130 —
continues where it stopped on the next identical invocation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.dse.explore import (check_parity, explore_space,
                               explore_space_network)
from repro_torch.dse.space import SPACES, get_space, resolve_workload
from repro_torch.netmap.cache import MappingCache
from repro_torch.obs import Tracer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description="Architecture x mapping co-search over a design space.")
    ap.add_argument("--space", default="edge-small",
                    help=f"design space (one of: {', '.join(sorted(SPACES))})")
    wl = ap.add_mutually_exclusive_group()
    wl.add_argument("--workload", default="QK",
                    help="comma-separated einsum names from the small suite "
                    "(default: QK); --paper resolves GPT-3 shapes instead")
    wl.add_argument("--network", default=None, metavar="CONFIG",
                    help="sweep against a whole model config via "
                    "repro_torch.netmap (e.g. qwen1_5_0_5b)")
    ap.add_argument("--paper", action="store_true",
                    help="resolve --workload names at paper scale "
                    "(GPT-3 6.7B shapes)")
    ap.add_argument("--objective", choices=("edp", "energy", "latency"),
                    default="edp")
    ap.add_argument("--mode", choices=("prefill", "decode"), default="decode",
                    help="--network serving shape (default: decode)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--fuse", action="store_true",
                    help="--network: fusion-aware planner per point "
                    "(disables dominance pruning; roofline orders only)")
    ap.add_argument("--workers", type=int, default=None,
                    help="search-engine worker processes (default: serial)")
    ap.add_argument("--max-points", type=int, default=None,
                    help="truncate the space to its first N candidates")
    ap.add_argument("--fast", action="store_true",
                    help="CI scale: smoke model config, tiny shapes, "
                    "space truncated to 8 points")
    ap.add_argument("--no-prune", action="store_true",
                    help="disable roofline dominance pruning")
    ap.add_argument("--no-seed", action="store_true",
                    help="disable cross-point incumbent seeding")
    ap.add_argument("--no-roofline-order", action="store_true",
                    help="visit points in enumeration order")
    ap.add_argument("--check-parity", type=int, default=None, metavar="N",
                    help="verify pruned-vs-exhaustive frontier parity on "
                    "the first N points, then exit")
    ap.add_argument("--cache-dir", default=".tcm_cache")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the full report as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a search trace: *.jsonl for the raw event "
                    "log, anything else for Chrome-trace JSON (Perfetto); "
                    "inspect with python -m repro_torch.obs report PATH")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="wall-clock budget (seconds) for the whole sweep")
    ap.add_argument("--max-expanded", type=int, default=None, metavar="N",
                    help="cap on total expanded search nodes for the sweep")
    ap.add_argument("--resume", action="store_true",
                    help="journal finished work units under the cache dir; "
                    "an interrupted sweep resumes mid-search on the next "
                    "identical invocation")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    space = get_space(args.space)
    max_points = args.max_points
    if args.fast and max_points is None:
        max_points = 8

    if args.check_parity is not None:
        if args.network is not None:
            # the parity oracle re-runs per-einsum searches exhaustively;
            # network sweeps have no seeding hook to verify against
            print("error: --check-parity supports einsum workloads only "
                  "(not --network)", file=sys.stderr)
            return 2
        einsums = resolve_workload(args.workload, paper_scale=args.paper)
        ok, msg = check_parity(space, einsums, args.objective,
                               n_points=args.check_parity,
                               workers=args.workers)
        print(msg)
        return 0 if ok else 1

    cache = None if args.no_cache else MappingCache(root=args.cache_dir)
    budget = None
    if args.deadline is not None or args.max_expanded is not None:
        from repro_torch.core.budget import SearchBudget
        budget = SearchBudget(deadline_s=args.deadline,
                              max_expanded=args.max_expanded)
    checkpoint = None
    if args.resume:
        from repro_torch.core.journal import SearchCheckpoint
        checkpoint = SearchCheckpoint(root=args.cache_dir)
        if len(checkpoint):
            print(f"resuming: {len(checkpoint)} journaled work units "
                  f"under {args.cache_dir}", file=sys.stderr)
    tracer = Tracer() if args.trace else None
    common = dict(objective=args.objective, cache=cache,
                  workers=args.workers, max_points=max_points,
                  roofline_order=not args.no_roofline_order,
                  prune=not args.no_prune, verbose=args.verbose,
                  tracer=tracer, budget=budget, checkpoint=checkpoint)
    if args.network is not None:
        from repro_torch.configs import get_config

        cfg = get_config(args.network, smoke=args.fast)
        batch, seq = args.batch, args.seq
        if args.fast:
            batch, seq = min(batch, 2), min(seq, 128)
        report = explore_space_network(
            space, cfg, mode=args.mode, batch=batch, seq=seq,
            fuse=args.fuse, **common)
    else:
        einsums = resolve_workload(args.workload, paper_scale=args.paper)
        report = explore_space(
            space, einsums, seed_incumbents=not args.no_seed, **common)

    print(report.render())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"  wrote {args.json}")
    if tracer is not None:
        tracer.save(args.trace)
        print(f"  wrote trace {args.trace} ({len(tracer.events)} events)")
    return 130 if report.interrupted else 0


if __name__ == "__main__":
    sys.exit(main())
