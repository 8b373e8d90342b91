"""CLI: map every layer of a model config and print the network EDP report.

  PYTHONPATH=src python -m repro_torch.netmap --config qwen1_5_0_5b
  PYTHONPATH=src python -m repro_torch.netmap --config qwen1_5_0_5b --fast
  PYTHONPATH=src python -m repro_torch.netmap --config phi3_mini_3_8b \
      --mode prefill --batch 1 --seq 256 --workers 4

The first invocation searches each unique einsum cold and persists the
optima under ``--cache-dir`` (default ``.tcm_cache/``); later invocations
with the same (config, arch, shape, objective) are served from the cache in
milliseconds — the report prints the hit rate and timing either way.

Resilience: ``--deadline S`` / ``--max-expanded N`` bound the whole run
(anytime report with a certified per-search optimality gap on expiry);
``--resume`` journals finished work units under the cache dir and resumes
an interrupted run mid-search; Ctrl-C prints the best-so-far report
(exit code 130) instead of a traceback.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..configs import ARCHS, get_config
from ..core.presets import nvdla_like, tpu_v4i_like, tpu_v5e_like
from ..obs import Tracer
from .cache import MappingCache
from .planner import map_network

ACCEL = {
    "tpu_v4i": lambda: tpu_v4i_like(),
    "tpu_v5e": lambda: tpu_v5e_like(),
    # matmul einsums name their tensors A/B/Z
    "nvdla": lambda: nvdla_like(tensors=("A", "B", "Z")),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.netmap",
        description="Whole-network optimal mapping with a persistent cache.")
    ap.add_argument("--config", required=True,
                    help=f"model config id (one of: {', '.join(ARCHS)})")
    ap.add_argument("--accel", choices=sorted(ACCEL), default="tpu_v4i",
                    help="target accelerator preset (default: tpu_v4i)")
    ap.add_argument("--mode", choices=("prefill", "decode"), default="decode",
                    help="serving shape (default: decode)")
    ap.add_argument("--batch", type=int, default=32,
                    help="sequences in flight (default: 32)")
    ap.add_argument("--seq", type=int, default=4096,
                    help="sequence / KV-cache length (default: 4096)")
    ap.add_argument("--objective", choices=("edp", "energy", "latency"),
                    default="edp")
    ap.add_argument("--workers", type=int, default=None,
                    help="search-engine worker processes (default: serial)")
    ap.add_argument("--no-share-incumbents", action="store_true",
                    help="disable cross-unit bound propagation (slower, "
                    "value-identical optima; for benchmarking)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable fusion-aware joint mapping: map every "
                    "layer op independently (reproduces the per-layer "
                    "planner bit-for-bit)")
    ap.add_argument("--fast", action="store_true",
                    help="smoke-scale config + tiny shapes (CI-friendly)")
    ap.add_argument("--cache-dir", default=".tcm_cache",
                    help="persistent mapping-cache directory")
    ap.add_argument("--no-cache", action="store_true",
                    help="search everything cold, do not touch the cache")
    ap.add_argument("--clear-cache", action="store_true",
                    help="drop the cache before mapping")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the full report as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a search trace: *.jsonl for the raw event "
                    "log, anything else for Chrome-trace JSON (Perfetto); "
                    "inspect with python -m repro_torch.obs report PATH")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="wall-clock budget (seconds) for the whole run; "
                    "on expiry the best mappings found so far are reported "
                    "with a certified optimality gap")
    ap.add_argument("--max-expanded", type=int, default=None, metavar="N",
                    help="cap on total expanded search nodes across the run "
                    "(anytime semantics, same as --deadline)")
    ap.add_argument("--resume", action="store_true",
                    help="journal finished work units under the cache dir "
                    "and serve them on the next identical invocation "
                    "(resume an interrupted run mid-search)")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.config, smoke=args.fast)
    if args.fast:
        args.batch, args.seq = min(args.batch, 2), min(args.seq, 128)
    arch = ACCEL[args.accel]()

    if args.clear_cache:  # honored even with --no-cache
        MappingCache(root=args.cache_dir).clear()
    cache = None if args.no_cache else MappingCache(root=args.cache_dir)
    if cache is not None and cache.n_corrupt:
        print(f"warning: skipped {cache.n_corrupt} corrupt cache line(s)",
              file=sys.stderr)

    budget = None
    if args.deadline is not None or args.max_expanded is not None:
        from ..core.budget import SearchBudget
        budget = SearchBudget(deadline_s=args.deadline,
                              max_expanded=args.max_expanded)
    checkpoint = None
    if args.resume:
        from ..core.journal import SearchCheckpoint
        checkpoint = SearchCheckpoint(root=args.cache_dir)
        if len(checkpoint):
            print(f"resuming: {len(checkpoint)} journaled work units "
                  f"under {args.cache_dir}", file=sys.stderr)

    tracer = Tracer() if args.trace else None
    report = map_network(cfg, arch, objective=args.objective, mode=args.mode,
                         batch=args.batch, seq=args.seq, cache=cache,
                         workers=args.workers,
                         share_incumbents=not args.no_share_incumbents,
                         fuse=not args.no_fuse,
                         verbose=args.verbose, tracer=tracer,
                         budget=budget, checkpoint=checkpoint)
    print(report.render())
    if cache is not None:
        # the report line above shows this call's deltas; this one adds the
        # cache object's lifetime accounting (reused caches span calls)
        print(f"  cache lifetime: {cache.hits} hits / {cache.misses} misses "
              f"(hit rate {100 * cache.hit_rate:.0f}%, "
              f"{len(cache)} entries)")
    if report.cache_hits and not report.cache_misses:
        t_cold = (sum(u.t_search for u in report.unique)
                  + sum(f.t_search for f in report.fused))
        print("  (all mappings served from the persistent cache — "
              f"cold search would have taken {t_cold:.3f}s)")
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
