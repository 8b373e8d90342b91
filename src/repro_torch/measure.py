"""Close the loop: mapper tiles -> hand-written CUDA kernels -> time on the card.

The mapper's tiles for the block-unit SMEM arch of one H100 SM
(``core.autotile``) drive the kernels; each kernel is then timed with CUDA
events (after a warm-up launch) against the reference's default tiling, and
the report carries the measured-vs-modeled ratio.  The modeled latency is
that of ONE SM doing the whole product, while the kernel spreads its tiles
over the card's 132 SMs, so the ratio is well below 1 for large shapes.

``run_model`` drives one model's main path: every unique matmul of one
forward pass at the mapper's tiles, then the layer's attention.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(then the plain versions run and times come from the host clock); with no
CUDA device and no such request they raise.

    python -m repro_torch.measure --config qwen1_5_0_5b
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .configs import get_config
from .core.autotile import (TilePlan, attention_tile, tcm_matmul_plan,
                             wgmma_tile)
from .kernels.ops import flash_attention_op, tcm_matmul
from .models.config import ModelConfig
from .netmap.planner import model_shapes, model_tiles

__all__ = ["time_matmul", "time_flash_attention", "run_model",
           "main_path_rows", "attention_shape", "time_call", "resolve_device"]


def resolve_device(device: str = "cuda") -> torch.device:
    """``device`` as a torch device; raises if it is CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# substrings of the device kernels that compute matrix products (cuBLAS's
# gemm / xmma / nvjet kernels, CUTLASS's)
GEMM_NAMES = ("gemm", "xmma", "nvjet", "cutlass")


def device_time(fn: Callable[[], object]) -> Dict:
    """Runs ``fn`` under ``torch.profiler`` and returns the card's side of
    it: device activities (kernels, copies, fills), their summed duration
    (one stream: they do not overlap), the wall time of the profiled run
    (the profiler's own cost included), the share of the busy time spent
    in matrix products (cuBLAS and CUTLASS gemms, by name) and the ten
    activities that took longest, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: Dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values()) if n else None  # None: nothing traced
    gemm = sum(ms for name, ms in by_name.items()
               if any(w in name for w in GEMM_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"activities": n, "device_ms": busy, "wall_ms": wall * 1e3,
            "busy_share": None if busy is None else busy / (wall * 1e3),
            "matmul_share": None if not busy else gemm / busy,
            "top": [{"name": k[:80], "ms": v} for k, v in top]}


def time_call(fn: Callable[[], object], dev: torch.device,
              repeats: int = 3, iters: int = 5) -> float:
    """Seconds per call of ``fn``: best of ``repeats`` runs of ``iters``
    back-to-back calls, after one warm-up call.  On CUDA the calls are
    queued behind a short device-side sleep and timed by CUDA events, so
    host launch overhead does not count when the calls outlast it."""
    fn()
    if dev.type != "cuda":
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best
    best = float("inf")
    with torch.cuda.device(dev):
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)  # ~1 ms: lets the launches queue
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def _randn(shape, dtype, dev, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _report(kernel, shape, tiles, dflt, t_map, t_tcm, t_dflt, modeled_s,
            dev) -> dict:
    return {
        "kernel": kernel,
        "shape": list(shape),
        "tiles": list(tiles),
        "default_tiles": list(dflt),
        "map_source": "tcm_matmul_tiles",
        "map_latency_ms": t_map * 1e3,
        "gap_bound": 1.0 if modeled_s is not None else float("inf"),
        "measured_s": t_tcm,
        "default_s": t_dflt,
        "speedup_vs_default": t_dflt / t_tcm if t_tcm > 0 else 0.0,
        "modeled_s": modeled_s,
        "measured_vs_modeled": (t_tcm / modeled_s if modeled_s else 0.0),
        "device": device_name(dev),
    }


def time_matmul(a: torch.Tensor, b: torch.Tensor,
                tiles: Tuple[int, int, int], modeled_s: Optional[float], *,
                t_map: float, repeats: int = 3
                ) -> Tuple[dict, torch.Tensor]:
    """Report row: ``tcm_matmul`` on these operands at ``tiles`` against
    the default 128-cube tiling (clamped to the bf16 kernel's tiles by
    ``wgmma_tile``), timed on the operands' device; and the output of the
    last timed call at ``tiles``."""
    (M, K), N = a.shape, b.shape[1]
    dflt = (min(M, 128), min(K, 128), min(N, 128))
    if a.dtype == torch.bfloat16:
        dflt = wgmma_tile(*dflt)
    held = {}

    def run():
        held["out"] = tcm_matmul(a, b, tiles=tiles)

    t_tcm = time_call(run, a.device, repeats)
    t_dflt = time_call(lambda: tcm_matmul(a, b, tiles=dflt), a.device,
                       repeats)
    return _report("matmul", (M, K, N), tiles, dflt, t_map, t_tcm, t_dflt,
                   modeled_s, a.device), held["out"]


def score_tiles(plan: TilePlan, Sq: int, Sk: int,
                word_bytes: int) -> Tuple[int, int]:
    """The attention kernel's (bq, bk) from a plan of the score matmul
    ``S = Q @ K^T`` (per head: M=Sq, K=Dh, N=Sk): its bm becomes the query
    tile, bn the kv tile, mapped onto the kernel's tiles by
    ``core.autotile.attention_tile`` (bf16 prefill 256 x 128 -> 128 x 128;
    decode 1 x 512 stays)."""
    bm, _, bn = plan.tiles
    return attention_tile(min(bm, Sq), min(bn, Sk), word_bytes)


def attention_plan(Sq: int, Sk: int, Dh: int,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[Tuple[int, int], Optional[float]]:
    """(bq, bk) from the mapper's plan of the score matmul
    (:func:`score_tiles`) and that mapping's modeled latency."""
    plan = tcm_matmul_plan(Sq, Dh, Sk, word_bytes=dtype.itemsize)
    return score_tiles(plan, Sq, Sk, dtype.itemsize), plan.modeled_s


def time_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         tiles: Tuple[int, int], modeled_s: Optional[float],
                         *, causal: bool, t_map: float, repeats: int = 3
                         ) -> Tuple[dict, torch.Tensor]:
    """Report row: ``flash_attention_op`` on these inputs at ``tiles``
    (bq, bk) against default 128 tiles (through ``attention_tile``), timed
    on the inputs' device; and the output of the last timed call at
    ``tiles``."""
    B, Sq, Hq, Dh = q.shape
    Sk = k.shape[1]
    bq, bkv = tiles
    dflt = attention_tile(min(128, Sq), min(128, Sk), q.element_size())
    held = {}

    def run():
        held["out"] = flash_attention_op(q, k, v, causal=causal, bq=bq,
                                         bk=bkv)

    t_tcm = time_call(run, q.device, repeats)
    t_dflt = time_call(lambda: flash_attention_op(
        q, k, v, causal=causal, bq=dflt[0], bk=dflt[1]), q.device, repeats)
    return _report("flash_attention", (B, Hq, Sq, Sk, Dh), tiles, dflt,
                   t_map, t_tcm, t_dflt, modeled_s, q.device), held["out"]


# --------------------------------------------------------------------------
# One model's main path
# --------------------------------------------------------------------------


@dataclass
class MatmulCall:
    """One unique matmul shape of a forward pass and the ops that share it."""

    shape: Tuple[int, int, int]
    tiles: Tuple[int, int, int]
    modeled_s: Optional[float]
    t_map: float  # seconds the mapper took to plan this shape
    ops: List[str] = field(default_factory=list)
    inputs: Tuple[torch.Tensor, ...] = ()
    out: Optional[torch.Tensor] = None


@dataclass
class AttentionCall:
    """The layer attention of a forward pass: (B, Sq, Sk, Hq, Hkv, Dh)."""

    shape: Tuple[int, int, int, int, int, int]
    causal: bool
    tiles: Tuple[int, int]
    modeled_s: Optional[float]
    t_map: float
    inputs: Tuple[torch.Tensor, ...] = ()
    out: Optional[torch.Tensor] = None


def attention_shape(cfg: ModelConfig, mode: str, batch: int, seq: int
                    ) -> Tuple[Tuple[int, int, int, int, int, int], bool]:
    """Prefill: causal self-attention over ``seq`` tokens.  Decode: one new
    token per sequence over a ``seq``-long cache, not causal (the kernel's
    mask is top-left, so the whole cache is attended, as the reference's
    decode measurement does)."""
    sq = seq if mode == "prefill" else 1
    return ((batch, sq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.d_head),
            mode == "prefill")


def run_model(cfg: ModelConfig, mode: str = "prefill", batch: int = 1,
              seq: int = 1024, *, dtype: torch.dtype = torch.bfloat16,
              device: str = "cuda", seed: int = 0
              ) -> Tuple[List[MatmulCall], AttentionCall]:
    """Drive ``cfg``'s main path once: plan each unique matmul shape (timed;
    the plans are memoized, so ``model_tiles`` then gives every op its tile
    from them), run each unique shape through ``ops.tcm_matmul`` on random
    operands (seeded), then the attention through
    ``ops.flash_attention_op`` at the tiles of its score matmul."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = model_shapes(cfg, mode, batch, seq)
    calls: Dict[Tuple[int, int, int], MatmulCall] = {}
    for shp in dict.fromkeys(shapes.values()):
        t0 = time.perf_counter()
        plan = tcm_matmul_plan(*shp, word_bytes=dtype.itemsize)
        calls[shp] = MatmulCall(shp, plan.tiles, plan.modeled_s,
                                time.perf_counter() - t0)
    tiles = model_tiles(cfg, mode, batch, seq, word_bytes=dtype.itemsize)
    for key, shp in shapes.items():
        assert tiles[key] == calls[shp].tiles, key
        calls[shp].ops.append(key)
    for call in calls.values():
        M, K, N = call.shape
        call.inputs = (_randn((M, K), dtype, dev, gen),
                       _randn((K, N), dtype, dev, gen))
        call.out = tcm_matmul(*call.inputs, tiles=call.tiles)
    (B, Sq, Sk, Hq, Hkv, Dh), causal = attention_shape(cfg, mode, batch, seq)
    t0 = time.perf_counter()
    attn_tiles, modeled_s = attention_plan(Sq, Sk, Dh, dtype)
    attn = AttentionCall((B, Sq, Sk, Hq, Hkv, Dh), causal, attn_tiles,
                         modeled_s, time.perf_counter() - t0)
    attn.inputs = (_randn((B, Sq, Hq, Dh), dtype, dev, gen),
                   _randn((B, Sk, Hkv, Dh), dtype, dev, gen),
                   _randn((B, Sk, Hkv, Dh), dtype, dev, gen))
    attn.out = flash_attention_op(*attn.inputs, causal=causal,
                                  bq=attn.tiles[0], bk=attn.tiles[1])
    return list(calls.values()), attn


def main_path_rows(calls: List[MatmulCall], attn: AttentionCall,
                   repeats: int = 3) -> List[dict]:
    """One report row per call of a :func:`run_model` result, on the
    call's own inputs and tiles, in order (the attention last)."""
    rows = [time_matmul(*c.inputs, c.tiles, c.modeled_s, t_map=c.t_map,
                        repeats=repeats)[0] for c in calls]
    rows.append(time_flash_attention(*attn.inputs, attn.tiles, attn.modeled_s,
                                     causal=attn.causal, t_map=attn.t_map,
                                     repeats=repeats)[0])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.measure",
        description="Time the mapper-tiled CUDA kernels on one model's "
                    "unique matmul and attention shapes, prefill 1x1024 and "
                    "decode 8x1024.")
    ap.add_argument("--config", default="qwen1_5_0_5b")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs the plain versions (host-clock times)")
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    cfg = get_config(args.config)
    rows = []
    for seed, (mode, batch, seq) in enumerate((("prefill", 1, 1024),
                                               ("decode", 8, 1024))):
        calls, attn = run_model(cfg, mode, batch, seq, device=args.device,
                                seed=seed)
        rows += [dict(mode=mode, **row)
                 for row in main_path_rows(calls, attn)]
    for row in rows:
        print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
