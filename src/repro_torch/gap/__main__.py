"""CLI: optimality-gap curves + pruning-soundness fuzzing.

  # gap curves: 2 workloads x 2 arch presets, budgets 1e2..1e4
  PYTHONPATH=src python -m repro_torch.gap --json

  # CI smoke: tiny workloads, budgets 1e2..1e3
  PYTHONPATH=src python -m repro_torch.gap --fast --json gap_smoke.json

  # soundness fuzz: 200 cases vs the brute-force oracle, fixed seed
  PYTHONPATH=src python -m repro_torch.gap --mode soundness --cases 200 --seed 0

  # fused-group soundness fuzz: tiny 2-member cascades, exhaustively
  # enumerated joint mapspace vs tcm_map_group
  PYTHONPATH=src python -m repro_torch.gap --mode soundness-fused --cases 50

  # replay a serialized violation repro
  PYTHONPATH=src python -m repro_torch.gap --mode replay --repro gap_violation_0.json

Exit status is nonzero whenever a soundness violation is found (in either
mode) — CI gates on it.  ``--json`` without a path writes the machine-
readable report to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.gap.runner import (ARCH_PRESETS, BASELINES, parse_budgets,
                              resolve_workloads, run_gap)
from repro_torch.gap import soundness as snd
from repro_torch.obs import Tracer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.gap",
        description="Optimality-gap harness: metaheuristic baselines vs. "
        "TCM's exact optimum, wired as a pruning-soundness bug detector.")
    ap.add_argument("--mode",
                    choices=("gap", "soundness", "soundness-fused",
                             "replay"),
                    default="gap")
    ap.add_argument("--workload", default="QK,P0",
                    help="comma-separated einsum names from the small suite "
                    "(default: QK,P0); --paper resolves GPT-3/MobileNet "
                    "shapes instead")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--arch", default="tpu,nvdla",
                    help="comma-separated arch presets "
                    f"(available: {', '.join(sorted(ARCH_PRESETS))})")
    ap.add_argument("--budgets", default="1e2..1e4", metavar="SPEC",
                    help="eval-budget ladder: '1e2..1e5' (decades) or "
                    "'100,500,2000' (default: 1e2..1e4)")
    ap.add_argument("--objective", default="edp",
                    help="comma-separated objectives (edp,energy,latency)")
    ap.add_argument("--baselines", default=None,
                    help="comma-separated subset of: "
                    f"{', '.join(BASELINES)} (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="CI scale: tiny attention-pair workloads, budgets "
                    "1e2..1e3")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write the machine-readable report (no PATH: "
                    "stdout)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="gap mode: record a search trace of the exact "
                    "optima plus one span per baseline curve: *.jsonl for "
                    "the raw event log, anything else for Chrome-trace "
                    "JSON (Perfetto); inspect with python -m repro_torch.obs "
                    "report PATH")
    # soundness mode
    ap.add_argument("--cases", type=int, default=200,
                    help="soundness: number of fuzz cases (default: 200)")
    ap.add_argument("--time-budget", type=float, default=None, metavar="S",
                    help="soundness: stop drawing new cases after S seconds")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="soundness: alias for --time-budget (the "
                    "repo-wide anytime flag)")
    ap.add_argument("--resume", action="store_true",
                    help="soundness: journal finished cases under "
                    "--cache-dir; an interrupted campaign (Ctrl-C, "
                    "deadline) continues where it stopped on the next "
                    "identical invocation")
    ap.add_argument("--cache-dir", default=".tcm_cache",
                    help="directory for the --resume journal")
    ap.add_argument("--no-oracle", action="store_true",
                    help="soundness: skip the brute-force cross-check")
    ap.add_argument("--repro-prefix", default="gap_violation",
                    metavar="PREFIX",
                    help="soundness: violation repro files are written to "
                    "PREFIX_<n>.json (default: gap_violation)")
    # replay mode
    ap.add_argument("--repro", default=None, metavar="PATH",
                    help="replay: serialized violation repro to re-run")
    return ap


def _emit(record: dict, dest: str) -> None:
    if dest == "-":
        json.dump(record, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        with open(dest, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {dest}", file=sys.stderr)


def main() -> int:
    args = build_parser().parse_args()

    if args.mode == "replay":
        if not args.repro:
            raise SystemExit("--mode replay requires --repro PATH")
        violations, _ = snd.replay(args.repro)
        for v in violations:
            print(f"VIOLATION {v.kind}: {v.detail}")
        if not violations:
            print("repro no longer violates (fixed?)")
        return 1 if violations else 0

    if args.mode in ("soundness", "soundness-fused"):
        fused = args.mode == "soundness-fused"
        time_budget = (args.time_budget if args.time_budget is not None
                       else args.deadline)
        journal = None
        if args.resume:
            import os
            tag = "gap_fuzz_fused" if fused else "gap_fuzz"
            journal = os.path.join(
                args.cache_dir, f"{tag}_seed{args.seed}.jsonl")
        if fused:
            report = snd.fuzz_fused(args.cases, seed=args.seed,
                                    time_budget_s=time_budget, verbose=True,
                                    journal_path=journal)
        else:
            report = snd.fuzz(args.cases, seed=args.seed,
                              oracle=not args.no_oracle,
                              time_budget_s=time_budget, verbose=True,
                              journal_path=journal)
        resumed = (f", {report.n_resumed} resumed from journal"
                   if report.n_resumed else "")
        print(f"soundness fuzz: {report.n_cases} cases "
              f"({report.n_oracle_checked} oracle-checked, "
              f"{report.n_baseline_runs} baseline runs{resumed}) in "
              f"{report.wall_s:.1f}s — "
              f"{'OK' if report.ok else 'VIOLATIONS FOUND'}")
        for i, v in enumerate(report.violations):
            path = f"{args.repro_prefix}_{i}.json"
            snd.write_repro(v, path)
            print(f"  [{v.kind}] {v.detail}\n    repro: {path} "
                  f"(replay: python -m repro_torch.gap --mode replay "
                  f"--repro {path})")
        if args.json:
            _emit(report.to_dict(), args.json)
        return 0 if report.ok else 1

    # gap mode
    if args.fast:
        from repro_torch.core.einsum import batched_matmul
        workloads = {"fqk": batched_matmul("fqk", 8, 4, 32, 64),
                     "fav": batched_matmul("fav", 8, 4, 64, 32)}
        budgets = parse_budgets("1e2..1e3")
    else:
        workloads = resolve_workloads(
            [w.strip() for w in args.workload.split(",") if w.strip()],
            paper=args.paper)
        budgets = parse_budgets(args.budgets)
    arches = {}
    for a in args.arch.split(","):
        a = a.strip()
        if not a:
            continue
        if a not in ARCH_PRESETS:
            raise SystemExit(f"unknown arch preset {a!r}; choose from "
                             f"{sorted(ARCH_PRESETS)}")
        arches[a] = ARCH_PRESETS[a]()
    baselines = None
    if args.baselines:
        baselines = [b.strip() for b in args.baselines.split(",")
                     if b.strip()]
    objectives = [o.strip() for o in args.objective.split(",") if o.strip()]

    tracer = Tracer() if args.trace else None
    report = run_gap(workloads, arches, budgets, objectives=objectives,
                     baselines=baselines, seed=args.seed, verbose=True,
                     tracer=tracer)
    print(report.render())
    if args.json:
        _emit(report.to_dict(), args.json)
    if tracer is not None:
        tracer.save(args.trace)
        print(f"# wrote trace {args.trace} ({len(tracer.events)} events)",
              file=sys.stderr)
    return 0 if not report.violations else 1


if __name__ == "__main__":
    sys.exit(main())
