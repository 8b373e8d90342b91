"""Batched serving, on one device or over a mesh: prefill a batch of
prompts, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --smoke --model-parallel 2 --mode tp [--device cpu]

Port of ``repro.launch.serve``, with its flags plus ``--device`` (default
``cuda``; with no card and no ``--device cpu`` it raises), ``--json`` and
``--profile`` (on the card: one more run under ``torch.profiler``).
Weights are drawn from ``torch.Generator().manual_seed(0)`` on the CPU, so
every device and every rank serves the same model, and cast once to the
compute dtype.  Under ``torch.distributed.run`` the ranks form a (data,
model) mesh with 'model' = ``--model-parallel`` (which must divide them)
and serve by ``--mode`` (``tp``, ``dp``, ``tp_ep`` or ``tp_fsdp``)
through ``serving.engine.make_serve_steps``; every rank decodes the same
tokens and rank 0 prints and writes.  Without the launcher's environment
the run is one process on one device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..measure import device_name, device_time, resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..models.weights import cast_for_compute
from ..serving.engine import make_serve_steps, place_cache
from ..training.step import init_sharded
from .mesh import describe, is_main, per_rank, run_launched, say

VLM_EMBEDS = 8  # frontend embeddings a vlm prompt carries, as the reference


def _plan_decode_mappings(cfg, B, P, G, deadline_s) -> Dict:
    """Query the online mapper for every decode step's exact shape.

    The KV length grows by one per generated token, so the G steps
    collapse onto a handful of shape buckets — the printed summary shows
    how many searches the whole trajectory actually paid.  The plan is
    informational: the served matmuls do not read it.  The preset is the
    reference's TPU-like one, so the summary compares with the reference's.
    """
    from ..core.presets import tpu_v4i_like
    from ..serve_map import MappingService
    from ..serving.engine import decode_mapping_plan

    arch = tpu_v4i_like()
    t0 = time.perf_counter()
    with MappingService() as svc:
        worst_gap = 1.0
        for step in range(G):
            plan = decode_mapping_plan(cfg, svc, arch, B, P + step + 1,
                                       deadline_s=deadline_s)
            worst_gap = max(worst_gap,
                            max(r.gap_bound for r in plan.values()))
        svc.drain_warm(timeout_s=60.0)
        st = svc.stats
        p50, p99 = st.latency_quantiles()
    t_plan = time.perf_counter() - t0
    print(f"map-service: {st.requests} shape queries over {G} decode "
          f"steps -> {st.searches} searches "
          f"({st.exact_hits} exact + {st.bucket_hits} bucket hits, "
          f"{st.coalesced} coalesced); "
          f"p50 {p50 * 1e3:.2f}ms p99 {p99 * 1e3:.2f}ms, "
          f"worst certified gap {worst_gap:.3f}, "
          f"planned in {t_plan:.2f}s")
    return {"requests": st.requests, "searches": st.searches,
            "exact_hits": st.exact_hits, "bucket_hits": st.bucket_hits,
            "coalesced": st.coalesced, "p50_ms": p50 * 1e3,
            "p99_ms": p99 * 1e3, "worst_gap": worst_gap,
            "planned_s": t_plan}


def make_batch(cfg: ModelConfig, B: int, P: int, device,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference CLI's prompts, drawn from ``np.random
    .default_rng(seed)`` in its order: tokens, then vlm embeddings or
    audio frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P))).to(device)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.normal(
            size=(B, VLM_EMBEDS, cfg.frontend_dim))).float().to(device)
    if cfg.family == "audio":
        batch["enc_frames"] = torch.from_numpy(rng.normal(
            size=(B, P, cfg.frontend_dim))).float().to(device)
    return batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(cfg: ModelConfig, params, batch, gen: int, measure,
            mesh=None, mode: str = "tp"):
    """Prefill ``batch`` and decode ``gen`` tokens greedily (the first from
    the prefill's logits, then ``gen - 1`` decode steps), each of the two
    phases run by ``measure(fn)``.  Over the ``DeviceMesh`` ``mesh`` the
    cache is placed by ``serving.engine.cache_shardings``.  Returns the
    tokens (B, gen) and what ``measure`` returned for prefill and for
    decode."""
    tokens = batch["tokens"]
    B, P = tokens.shape
    extra = batch["embeds"].shape[1] if "embeds" in batch else 0
    prefill_step, decode_step = make_serve_steps(cfg, mesh, mode)
    cache = lm.init_cache(cfg, B, P + gen + extra, tokens.device)
    if mesh is not None:
        cache = place_cache(cfg, cache, mesh)
    out = []

    def prefill():
        nonlocal cache
        last, cache = prefill_step(params, batch, cache)
        out.append(last)

    def decode():
        nonlocal cache
        toks = torch.argmax(out.pop(), -1)[:, None]
        out.append(toks)
        for _ in range(gen - 1):
            logits, cache = decode_step(params, toks, cache)
            toks = torch.argmax(logits, -1)[:, None]
            out.append(toks)

    pre = measure(prefill)
    dec = measure(decode)
    return torch.cat(out, dim=1).cpu().numpy(), pre, dec


def generate(cfg: ModelConfig, params, batch, gen: int, mesh=None,
             mode: str = "tp") -> Tuple[np.ndarray, Dict]:
    """The greedy run, timed: prefill ends when its logits are ready,
    decode when the last token is; on CUDA the peak of allocated memory
    over the run (weights included) is read too.  ``mesh``/``mode`` as
    for ``_greedy``.  Returns the tokens (B, gen) and the times."""
    dev = batch["tokens"].device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def wall(fn) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    toks, t_prefill, t_decode = _greedy(cfg, params, batch, gen, wall,
                                        mesh, mode)
    B, steps = toks.shape[0], gen - 1
    return toks, {
        "device": device_name(dev), "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3, "decode_steps": steps,
        "decode_ms_per_step": t_decode * 1e3 / max(steps, 1),
        "tok_s": steps * B / max(t_decode, 1e-9),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None)}


def profile_run(cfg: ModelConfig, params, batch, gen: int, mesh=None,
                mode: str = "tp") -> Dict:
    """One more greedy run, each phase under ``torch.profiler``: what the
    card did in prefill and in a decode step, and its busy share of their
    wall time."""
    _, pre, dec = _greedy(cfg, params, batch, gen, device_time, mesh, mode)
    steps = max(gen - 1, 1)
    return {"prefill": pre, "decode": dec, "decode_per_step": {
        "activities": dec["activities"] / steps,
        "device_ms": (None if dec["device_ms"] is None
                      else dec["device_ms"] / steps),
        "wall_ms": dec["wall_ms"] / steps}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mode", default="tp",
                    help="the reference's sharding mode over the ranks of "
                    "a torch.distributed.run launch: tp, dp, tp_ep or "
                    "tp_fsdp")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's 'model' extent; must divide the ranks")
    ap.add_argument("--map-service", action="store_true",
                    help="plan the decode tiling online: query the mapping "
                    "service (repro_torch.serve_map) at every decode step's "
                    "exact (batch, kv_len) shape and print the "
                    "bucket-collapse summary before running")
    ap.add_argument("--map-deadline-ms", type=float, default=50.0,
                    help="per-query deadline for --map-service (ms)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--json", default=None,
                    help="write the run's times, peak memory and "
                    "map-service summary to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed run, prefill and decode once more "
                    "under torch.profiler and report the card's activities "
                    "and busy share (needs the card)")
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
    say(describe(mesh))
    B, P, G = args.batch, args.prompt_len, args.gen
    plan: Optional[Dict] = None
    if args.map_service and is_main():
        plan = _plan_decode_mappings(cfg, B, P, G, args.map_deadline_ms / 1e3)

    if dmesh is None:
        params = lm.init(cfg, torch.Generator().manual_seed(0), dev)
    else:
        params = init_sharded(cfg, None, dmesh, args.mode, device=dev)[0]
    params = cast_for_compute(cfg, params)
    batch = make_batch(cfg, B, P, dev)
    gen, stats = generate(cfg, params, batch, G, dmesh, args.mode)
    prof = (profile_run(cfg, params, batch, G, dmesh, args.mode)
            if args.profile else None)
    peaks = per_rank(stats["peak_bytes"])

    say(f"prefill {B}x{P}: {stats['prefill_ms']:.0f}ms  "
          f"decode {G-1} steps: {stats['decode_ms']:.0f}ms "
          f"({stats['tok_s']:.1f} tok/s)")
    say("sample:", gen[0][:16])
    say(f"device: {stats['device']}")
    if prof is not None:
        pre, d = prof["prefill"], prof["decode_per_step"]
        say(f"profile: prefill {pre['activities']} device activities, "
              f"busy {pre['device_ms']} of {pre['wall_ms']:.3f} ms; decode "
              f"{d['activities']:.0f} a step, busy {d['device_ms']} of "
              f"{d['wall_ms']:.3f} ms")
    if args.json and is_main():
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "batch": B, "prompt_len": P,
                       "gen": G, "dtype": cfg.dtype, "mesh": mesh.shape,
                       "mode": args.mode if dmesh is not None else None,
                       "tokens": gen.tolist(), "peak_bytes_per_rank": peaks,
                       **stats,
                       "map_service": plan, "profile": prof}, f, indent=1)
    return gen


if __name__ == "__main__":
    main()
