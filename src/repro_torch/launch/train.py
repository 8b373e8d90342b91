"""Training launcher on one device: auto-resuming and preemption-safe.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

Port of ``repro.launch.train``, with its flags, log lines and behaviour:
  * auto-resume: on start, restore the latest checkpoint (parameters,
    optimizer state, the data iterator's state) if one exists;
  * preemption: SIGTERM/SIGINT checkpoint and exit at the next step
    boundary (atomic commit; a killed writer never corrupts state);
  * async checkpoints every --ckpt-every steps, off the critical path;
  * straggler watchdog: an EWMA of the step time; a step slower than
    --straggler-factor x the EWMA is logged for triage.
Added: ``--device`` (default ``cuda``; with no card and no ``--device cpu``
it raises), ``--json`` (a summary of the run) and ``--profile`` (on the
card: after the run and its last checkpoint, one more step under
``torch.profiler``, whose update is not saved).  One device runs the
whole model: ``--model-parallel`` above 1 raises and ``--mode`` changes
nothing.  Parameters are drawn from ``torch.Generator().manual_seed(0)``
on the CPU, so every device trains the same model.
"""
from __future__ import annotations

import argparse
import json
import signal
import statistics
import sys
import time
from typing import Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticTokens
from ..measure import device_name, device_time, resolve_device
from ..models import lm
from ..optim.adamw import OptConfig
from ..training.step import init, make_train_step
from .mesh import describe, make_elastic_mesh


def _summary(cfg, args, dev, start_step, times, losses, gnorms,
             mgr: Optional[CheckpointManager], prof) -> Dict:
    """The run's times, losses, peak memory and checkpoint writes."""
    tokens = args.global_batch * args.seq_len
    step_s = statistics.median(times[1:] or times)
    return {
        "arch": cfg.name, "device": device_name(dev), "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat,
        "optimizer": args.optimizer, "global_batch": args.global_batch,
        "seq_len": args.seq_len, "microbatches": args.microbatches,
        "start_step": start_step, "steps": len(times),
        "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tok_s": tokens / step_s,
        "loss": losses, "grad_norm": gnorms,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "checkpoints": [] if mgr is None else mgr.writes,
        "profile": prof}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mode", default="tp",
                    help="the reference's sharding mode; one device has "
                    "no sharding, so it changes nothing")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="must be 1: the port trains on one device")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--json", default=None,
                    help="write the run's step times, losses, peak memory "
                    "and checkpoint writes to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the run, one more step under torch.profiler "
                    "(not saved): the card's activities and busy share "
                    "(needs the card)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: the port "
                         f"trains on one device")
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise ValueError("--profile reads the card's activities: it needs "
                         "--device cuda")

    cfg = get_config(args.arch, smoke=args.smoke)
    oc = OptConfig(kind=args.optimizer, lr=args.lr,
                   decay_steps=max(args.steps, 10))
    # the mesh of the one device this run trains on
    print(describe(make_elastic_mesh(target_model=args.model_parallel,
                                     devs=[dev])))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    params, opt_state = init(cfg, oc, dev)
    step_fn = make_train_step(cfg, oc, microbatches=args.microbatches)

    data = SyntheticTokens(DataConfig(
        global_batch=args.global_batch, seq_len=args.seq_len,
        vocab=cfg.vocab, frontend=cfg.frontend,
        frontend_dim=cfg.frontend_dim))

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_step()
        if latest is not None:
            # the restore reads only the tree's structure: the fresh
            # tensors go first, so the device never holds two copies
            like = lm.tree_map(lambda t: 0, {"params": params,
                                             "opt": opt_state})
            params = opt_state = None
            restored, extra = mgr.restore_to(latest, like, dev)
            params, opt_state = restored["params"], restored["opt"]
            data.restore(extra["data"])
            start_step = latest
            print(f"resumed from step {latest}")
    if start_step >= args.steps:
        raise ValueError(f"nothing to train: the run starts at step "
                         f"{start_step} of --steps {args.steps}")

    # preemption handling: checkpoint-and-exit at the next boundary
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    old_handlers = {s: signal.signal(s, _on_term)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        ewma = None
        times, losses, gnorms = [], [], []
        for step in range(start_step, args.steps):
            batch = next(data)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            times.append(dt)
            losses.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > args.straggler_factor * ewma and step > start_step + 3:
                print(f"[straggler] step {step}: {dt:.2f}s vs ewma "
                      f"{ewma:.2f}s", file=sys.stderr)
            if step % args.log_every == 0:
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if mgr and ((step + 1) % args.ckpt_every == 0
                        or preempted["flag"]):
                mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                               extra={"data": data.state()})
            if preempted["flag"]:
                print("preempted: checkpointed, exiting cleanly")
                break
        if mgr:
            mgr.save_async(min(step + 1, args.steps),
                           {"params": params, "opt": opt_state},
                           extra={"data": data.state()})
            mgr.wait()
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    print(f"done at step {step + 1}; final loss "
          f"{float(metrics['loss']):.4f}")
    print(f"device: {device_name(dev)}")

    prof = None
    if args.profile:
        batch = next(data)
        prof = device_time(lambda: step_fn(params, opt_state, batch))
        print(f"profile: one step, {prof['activities']} device activities, "
              f"busy {prof['device_ms']} of {prof['wall_ms']:.3f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(_summary(cfg, args, dev, start_step, times, losses,
                               gnorms, mgr, prof), f, indent=1)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
