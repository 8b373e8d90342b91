"""Training launcher, on one device or over a mesh: auto-resuming and
preemption-safe.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --model-parallel 2 --mode tp [--device cpu]

Port of ``repro.launch.train``, with its flags, log lines and behaviour:
  * auto-resume: on start, restore the latest checkpoint (parameters,
    optimizer state, the data iterator's state) if one exists;
  * preemption: SIGTERM/SIGINT checkpoint and exit at the next step
    boundary (atomic commit; a killed writer never corrupts state);
  * async checkpoints every --ckpt-every steps, off the critical path;
  * straggler watchdog: an EWMA of the step time; a step slower than
    --straggler-factor x the EWMA is logged for triage.
Under ``torch.distributed.run`` every rank joins the process group (NCCL
on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``), the (data, model)
mesh spans the ranks with 'model' = ``--model-parallel`` (which must
divide the ranks, as the reference's ``make_host_mesh`` asserts), and
``--mode`` (``tp``, ``dp``, ``tp_ep`` or ``tp_fsdp``) lays parameters,
optimizer state, batch and activations out by the reference's rules
(``training.step``).  Rank 0
prints and writes; checkpoints restore onto whatever mesh the run has.
Without the launcher's environment the run is one process on one device,
where ``--model-parallel`` above 1 does not divide and ``--mode`` is not
read.  Added: ``--device`` (default ``cuda``; with no card and no
``--device cpu`` it raises), ``--json`` (a summary of the run) and
``--profile`` (on the card: after the run and its last checkpoint, one
more step under ``torch.profiler``, whose update is not saved).
Parameters are drawn from ``torch.Generator().manual_seed(0)`` on the CPU,
so every device and every rank trains the same model.
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
from ..distributed.sharding import shardings_for
from ..optim.adamw import OptConfig, opt_state_specs
from ..training.step import init, init_sharded, make_train_step
from .mesh import describe, is_main, per_rank, run_launched, say


def _summary(cfg, args, dev, mesh, sharded, start_step, times, losses,
             gnorms, mgr: Optional[CheckpointManager], prof,
             peaks) -> Dict:
    """The run's mesh, times, losses, peak memory and checkpoint
    writes."""
    tokens = args.global_batch * args.seq_len
    step_s = statistics.median(times[1:] or times)
    return {
        "mesh": mesh.shape, "mode": args.mode if sharded else None,
        "peak_bytes_per_rank": peaks,
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
                    help="the reference's sharding mode over the ranks of "
                    "a torch.distributed.run launch: tp, dp, tp_ep or "
                    "tp_fsdp")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's 'model' extent; must divide the ranks")
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
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise ValueError("--profile reads the card's activities: it needs "
                         "--device cuda")
    return run_launched(args.model_parallel, dev,
                        lambda d, mesh, dmesh: _run(args, d, mesh, dmesh))


def _run(args, dev, mesh, dmesh):
    """The run on ``dev``; over the ``DeviceMesh`` ``dmesh`` when one is
    given (``mesh`` describes it), else on ``dev`` alone."""
    cfg = get_config(args.arch, smoke=args.smoke)
    oc = OptConfig(kind=args.optimizer, lr=args.lr,
                   decay_steps=max(args.steps, 10))
    say(describe(mesh))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if dmesh is None:
        params, opt_state = init(cfg, oc, dev)
        step_fn = make_train_step(cfg, oc, microbatches=args.microbatches)
    else:
        params, specs, opt_state = init_sharded(cfg, oc, dmesh, args.mode,
                                                device=dev)
        step_fn = make_train_step(cfg, oc, microbatches=args.microbatches,
                                  mesh=dmesh, mode=args.mode)

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
            if dmesh is not None:
                shardings = {
                    "params": shardings_for(specs, dmesh, args.mode,
                                            like=params),
                    "opt": shardings_for(opt_state_specs(oc, specs), dmesh,
                                         args.mode, like=opt_state)}
            params = opt_state = None
            if dmesh is None:
                restored, extra = mgr.restore_to(latest, like, dev)
            else:
                restored, extra = mgr.restore_sharded(latest, like,
                                                      shardings)
            params, opt_state = restored["params"], restored["opt"]
            data.restore(extra["data"])
            start_step = latest
            say(f"resumed from step {latest}")
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
                say(f"[straggler] step {step}: {dt:.2f}s vs ewma "
                    f"{ewma:.2f}s", file=sys.stderr)
            if step % args.log_every == 0:
                say(f"step {step}: loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if mgr and ((step + 1) % args.ckpt_every == 0
                        or preempted["flag"]):
                mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                               extra={"data": data.state()})
            if preempted["flag"]:
                say("preempted: checkpointed, exiting cleanly")
                break
        if mgr:
            mgr.save_async(min(step + 1, args.steps),
                           {"params": params, "opt": opt_state},
                           extra={"data": data.state()})
            mgr.wait()
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    say(f"done at step {step + 1}; final loss "
        f"{float(metrics['loss']):.4f}")
    say(f"device: {device_name(dev)}")

    prof = None
    if args.profile:
        batch = next(data)
        prof = device_time(lambda: step_fn(params, opt_state, batch))
        say(f"profile: one step, {prof['activities']} device activities, "
            f"busy {prof['device_ms']} of {prof['wall_ms']:.3f} ms")
    # every rank's peak of allocated device memory (None off the card)
    peaks = per_rank(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None)
    if args.json and is_main():
        with open(args.json, "w") as f:
            json.dump(_summary(cfg, args, dev, mesh, dmesh is not None,
                               start_step, times, losses, gnorms, mgr, prof,
                               peaks), f, indent=1)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
