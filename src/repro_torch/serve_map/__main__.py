"""CLI for the online mapping service.

Bench — load-generate mixed decode-shape traffic and gate on the SLOs::

  PYTHONPATH=src python -m repro_torch.serve_map bench --fast \\
      --requests 200 --clients 8 --gate-hit-p99-ms 50 \\
      --gate-deadline-ratio 0.95 --gate-coalesce-ratio 0.5 --json report.json

Serve — a JSONL request/response loop over stdin/stdout (one request per
line: ``{"einsum": {...}, "objective": "edp", "deadline_s": 0.25}`` in
``einsum_to_dict`` form; one JSON answer per line, mappings in the cache's
wire form)::

  echo '{"einsum": {...}}' | \\
      PYTHONPATH=src python -m repro_torch.serve_map serve

Exit codes: 0 ok, 1 a bench gate failed, 2 bad usage.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional

from ..configs import ARCHS, get_config
from ..core.einsum import einsum_from_dict, einsum_to_dict
from ..netmap.__main__ import ACCEL
from ..netmap.cache import mapping_to_wire

from .loadgen import run_loadgen
from .request import MapRequest
from .service import MappingService


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve_map",
        description="Mapping-as-a-service: online mapper with bounded "
        "tail latency.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="load generator + SLO gates")
    b.add_argument("--config", default="qwen1_5_0_5b",
                   help=f"model config id (one of: {', '.join(ARCHS)})")
    b.add_argument("--accel", choices=sorted(ACCEL), default="tpu_v4i")
    b.add_argument("--fast", action="store_true",
                   help="smoke-scale model config (CI-friendly)")
    b.add_argument("--requests", type=int, default=200)
    b.add_argument("--clients", type=int, default=8)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--deadline", type=float, default=0.25, metavar="S",
                   help="per-request deadline, seconds (default 0.25)")
    b.add_argument("--objective", choices=("edp", "energy", "latency"),
                   default="edp")
    b.add_argument("--seq-min", type=int, default=16)
    b.add_argument("--seq-max", type=int, default=1024)
    b.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    b.add_argument("--no-warmup", action="store_true",
                   help="skip the per-bucket warmup pass (timed phase "
                   "then includes cold budgeted searches)")
    b.add_argument("--no-stampede", action="store_true",
                   help="skip the thundering-herd coalescing probe")
    b.add_argument("--cache-dir", default=None,
                   help="persistent cache dir (default: fresh temp dir, "
                   "so every bench starts cold)")
    b.add_argument("--measure", action="store_true",
                   help="also run one matmul + one flash-attention shape "
                   "on the CUDA kernels at service tiles and time them")
    b.add_argument("--device", default="cuda",
                   help="device --measure runs on ('cpu' runs the plain "
                   "versions; default cuda)")
    b.add_argument("--json", default=None, metavar="PATH",
                   help="dump the full report as JSON")
    b.add_argument("--gate-hit-p99-ms", type=float, default=None,
                   help="fail (exit 1) if warm-hit p99 exceeds this")
    b.add_argument("--gate-deadline-ratio", type=float, default=None,
                   help="fail if the deadline-met ratio falls below this")
    b.add_argument("--gate-coalesce-ratio", type=float, default=None,
                   help="fail if the stampede coalescing ratio falls "
                   "below this")

    s = sub.add_parser("serve", help="JSONL request loop on stdin/stdout")
    s.add_argument("--accel", choices=sorted(ACCEL), default="tpu_v4i")
    s.add_argument("--cache-dir", default=".tcm_cache")
    s.add_argument("--workers", type=int, default=None)
    s.add_argument("--deadline", type=float, default=None, metavar="S",
                   help="default per-request deadline (request field wins)")
    return ap


def _bench(args) -> int:
    cfg = get_config(args.config, smoke=args.fast)
    arch = ACCEL[args.accel]()
    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="tcm-serve-")
    with MappingService(cache_root=cache_dir) as svc:
        report = run_loadgen(
            svc, cfg, arch, requests=args.requests, clients=args.clients,
            seed=args.seed, deadline_s=args.deadline,
            objective=args.objective, batch_choices=tuple(args.batches),
            seq_range=(args.seq_min, args.seq_max),
            warmup=not args.no_warmup, stampede=not args.no_stampede)
        if args.measure:
            from .measure import measure_flash_attention, measure_matmul
            report["measure"] = [
                measure_matmul(svc, device=args.device),
                measure_flash_attention(svc, device=args.device)]
        svc.drain_warm(timeout_s=120.0)
        report["service"] = svc.stats.to_dict()  # post-drain counters

    print(f"serve_map bench: {report['requests']} requests / "
          f"{report['clients']} clients over "
          f"{report['unique_shapes']} shapes -> "
          f"{report['unique_buckets']} buckets")
    print(f"  latency ms: p50 {report['p50_ms']:.3f} "
          f"p99 {report['p99_ms']:.3f} "
          f"(hits: p50 {report['hit_p50_ms']:.3f} "
          f"p99 {report['hit_p99_ms']:.3f})")
    print(f"  deadline met: {100 * report['deadline_met_ratio']:.1f}%  "
          f"throughput: {report['rps']:.0f} req/s")
    print(f"  stampede: {report['stampede_searches']} search(es), "
          f"{report['stampede_coalesced']} coalesced "
          f"(ratio {report['coalesce_ratio']:.2f})")
    for row in report.get("measure", ()):
        print(f"  measured {row['kernel']} {row['shape']}: "
              f"tiles {row['tiles']} {row['measured_s'] * 1e3:.2f} ms vs "
              f"default {row['default_s'] * 1e3:.2f} ms "
              f"(x{row['speedup_vs_default']:.2f}); "
              f"measured/modeled {row['measured_vs_modeled']:.1f}"
              f" [{row['device']}]")

    failures = []
    if args.gate_hit_p99_ms is not None and \
            report["hit_p99_ms"] > args.gate_hit_p99_ms:
        failures.append(f"hit p99 {report['hit_p99_ms']:.3f} ms > "
                        f"{args.gate_hit_p99_ms} ms")
    if args.gate_deadline_ratio is not None and \
            report["deadline_met_ratio"] < args.gate_deadline_ratio:
        failures.append(
            f"deadline-met ratio {report['deadline_met_ratio']:.3f} < "
            f"{args.gate_deadline_ratio}")
    if args.gate_coalesce_ratio is not None and \
            report["coalesce_ratio"] < args.gate_coalesce_ratio:
        failures.append(f"coalesce ratio {report['coalesce_ratio']:.2f} < "
                        f"{args.gate_coalesce_ratio}")
    report["gate_failures"] = failures
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"  wrote {args.json}")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


def _serve(args) -> int:
    arch = ACCEL[args.accel]()
    with MappingService(cache_root=args.cache_dir,
                        workers=args.workers) as svc:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                req = MapRequest(
                    einsum=einsum_from_dict(d["einsum"]), arch=arch,
                    objective=d.get("objective", "edp"),
                    deadline_s=d.get("deadline_s", args.deadline),
                    allow_bucketed=bool(d.get("allow_bucketed", True)))
                resp = svc.map(req)
                out = {
                    "ok": True, "source": resp.source, "key": resp.key,
                    "bucketed": resp.bucketed,
                    "served_einsum": einsum_to_dict(resp.served_einsum),
                    "gap_bound": resp.gap_bound,
                    "latency_ms": resp.latency_s * 1e3,
                    "deadline_met": resp.deadline_met,
                    "energy": resp.result.energy,
                    "latency": resp.result.latency,
                    "edp": resp.result.edp,
                    "mapping": mapping_to_wire(resp.result.mapping),
                }
            except Exception as e:  # one bad request must not kill the loop
                out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(out), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        return _bench(args)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
