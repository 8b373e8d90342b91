#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):
  1. environment: the card's name and power limit, then the kernel build
     (registers and spills per kernel from ptxas);
  2. each hand-written kernel against its plain PyTorch version and the
     oracle on the card: the matmul's f32 route and every bf16 wgmma
     instance (M = 1 and 8, bn 64 / 192 / 448 / 512, bm up to 512, bk 128),
     the attention's f32 route and both bf16 paths (tensor cores, decode)
     at the reference tests' shapes, a ragged Dh-32 shape and qwen1.5-0.5b's
     attention shapes;
  3. the main path: qwen1.5-0.5b at full width, prefill 1x1024 and decode
     8x1024 — the mapper plans every matmul's tiles, every unique matmul
     shape (lm_head included) and both attention shapes run once on bf16
     operands through the port's ops, launch counts read right after; then
     each is checked against its plain version and timed, with its grid
     (blocks against the card's SMs) and its share of the bound;
  4. the service route: a MappingService on a fresh cache serves the same
     model's tiles — every unique main-path matmul shape exactly, first
     from a cold search and then from the hot index, each equal to the
     tile phase 3 ran — plus decode attention's score matmul at kv 1000
     from a bucket; the kernels run at those tiles (launch counts read
     right after) and are held against their plain versions, prefill
     attention runs through ``serve_map.measure.measure_flash_attention``
     (its timed output is held against the plain version), the load
     generator's ``bench --fast`` runs in process as a pass/fail gate, and
     the route's own traffic runs at full width: 2000 tile requests of
     qwen1.5-0.5b's forward passes at drawn batches and ragged lengths
     (``serve_map.measure.run_tile_load``) from 8 client threads, then 1,
     then 8, after a stampede of 8 on one cold shape; the kernels then run
     at a sample of the tiles it served from buckets; one JSON line
     {"service": {...}} with map sources and times, tiles, kernel times and
     errors, and per load run hit and tile p50/p99, sources, searches and
     coalescing;
  5. the served model, qwen1.5-0.5b at full width through the model stack
     (``repro_torch.models``, ``serving.engine``, ``launch.serve``; torch
     matmuls, no kernel of this repo): (a) in f32 from seeded weights, the
     card's logits at every greedy step (batch 2, prompt 32, 4 tokens) are
     held against the port's own CPU run, and the greedy tokens must be
     equal; (b) ``launch.serve.main`` serves batch 8 x prompt 1024 + 32
     generated tokens in bf16 with ``--map-service``, and one JSON line
     {"served": {...}} carries its prefill and decode times, tokens/s, peak
     memory, the map-service summary, the bounds of prefill and decode,
     and one more run under ``torch.profiler`` (the card's activities and
     busy time in prefill and per decode step);
  6. the training path, qwen1.5-0.5b at full width (``repro_torch.models``
     with the flash backward, ``optim``, ``training``, ``checkpoint``,
     ``launch.train``; torch ops, no kernel of this repo): (a) the flash
     attention's manual backward on the card against autograd through a
     naive f32 attention, f32 and bf16; (b) one f32 AdamW step from seeded
     weights on the card against the port's own CPU step (loss, grad norm,
     updated parameters); (c) ``launch.train.main`` trains bf16 batch 8 x
     1024 for 6 steps with async checkpoints every 3, one more step under
     ``torch.profiler``, then a second ``main`` resumes to step 8; one JSON
     line {"trained": {...}} carries step times, tokens/s, peak memory,
     losses, checkpoint writes, the card's busy share and
     ``trained_bounds``; (d) in a child process with deterministic
     algorithms, 6 steps straight and 3 + checkpoint + restore + 3 give
     bitwise equal parameters (2 layers at full width);
  7. the mapper's evidence (``repro_torch.gap``, ``dse``, ``core.baselines``;
     numpy on the host, then the matmul kernel): (a) the CLIs in process in
     a temp cwd: ``gap --mode soundness --cases 30 --seed 0`` must find no
     violation, ``gap --fast`` must give every curve cell >= 1.000x, ``dse
     --fast`` must reach its frontier; (b) the gap harness on the card's own
     plan arch (``plan_arch()``, objective latency, budgets 100 and 1000)
     over qwen1.5-0.5b's 12 unique main-path matmul shapes: no baseline may
     beat TCM's modeled latency; (c) at each of those shapes, each
     baseline's best mapping at 1000 evaluations (seed 0) becomes a kernel
     tile (``plan_from_mapping``), and the bf16 matmul runs at every
     searcher's tile and TCM's, each output held against the plain version
     and timed; one JSON line {"gap": [...]} with, per shape, each
     searcher's modeled latency, tile and kernel ms, the bound and TCM's
     rank by kernel time (a baseline's tile faster than TCM's is a finding,
     not a failure);
  8. the one-device tools (``repro_torch.distributed``, ``launch.dryrun``,
     ``launch.roofline``, ``examples``; torch ops, the matmul kernel in the
     autotune twin): (a) ``compress_decompress`` over seeded gradients
     shaped like qwen1.5-0.5b's f32 parameters, held against the port's CPU
     run on the embedding and layer 0 (codes, scales, dequantized values),
     timed beside its bytes bound, and ``quantized_psum`` on an NCCL group
     of one against the round trip; (b) the dry-run of qwen1.5-0.5b's
     reference cells (train_4k, prefill_32k, decode_32k) at full width on
     the card, and ``roofline.analyze_cell`` over each with the H100's
     constants; (c) the dry-run of phase 6's train step (8 x 1024) and of
     phase 5's prefill (8 x 1024) and one decode step after it, each held
     against the same step run on the card: traced peak within 10% of
     ``torch.cuda.max_memory_allocated``, FLOPs equal to
     ``FlopCounterMode`` over the real run, the step's time (the median of
     5 runs after a warm-up) beside the roofline's bound; (d) the example twins ``kernel_autotune`` (must
     print ``(OK)``), ``train_e2e`` (20 steps) and ``quickstart``; one
     JSON line {"tools": {...}};
  9. one JSON line with each kernel's launches on the main path (phase 3),
     error and times;
  10. the last line: {"ok": true, "device": {...}}.

Needs torch with CUDA, nvcc and one card; it fails without them.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.autotile import (kernel_takes,  # noqa: E402
                                       plan_arch, plan_einsum,
                                       plan_from_mapping, tcm_matmul_plan)
from repro_torch.core.search import clear_search_caches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.matmul import (matmul_cuda,  # noqa: E402
                                        matmul_plain, wgmma_instance,
                                        wgmma_instances)
from repro_torch.kernels.ops import _pad_to, tcm_matmul  # noqa: E402
from repro_torch.kernels.ref import attention_ref, matmul_ref  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.dse.__main__ import main as dse_main  # noqa: E402
from repro_torch.examples import (kernel_autotune, quickstart,  # noqa
                                  train_e2e)
from repro_torch.gap.__main__ import main as gap_main  # noqa: E402
from repro_torch.gap.runner import BASELINES, REL_EPS, run_gap  # noqa
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.dryrun import (Cell, count, fill_cache,  # noqa
                                       make_inputs, run_cell, trace_step)
from repro_torch.launch.roofline import (analytic_hbm_bytes,  # noqa: E402
                                         analyze_cell)
from repro_torch.measure import (_randn, main_path_rows,  # noqa: E402
                                 run_model, time_call)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import flash_attention  # noqa: E402
from repro_torch.netmap.planner import model_shapes  # noqa: E402
from repro_torch.serve_map import MappingService  # noqa: E402
from repro_torch.serve_map.__main__ import main as serve_map_main  # noqa
from repro_torch.serve_map.measure import (  # noqa: E402
    measure_flash_attention, run_tile_load, service_matmul_tiles,
    tile_request_shapes)
from repro_torch.optim.adamw import (OptConfig, apply_updates,  # noqa
                                     init_opt_state)
from repro_torch.serving.engine import make_serve_steps  # noqa: E402
from repro_torch.training.step import init, make_train_step  # noqa: E402

# H100 SXM datasheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
SMS = 132
# qwen1.5-0.5b's main path: (mode, batch, seq)
RUNS = [("prefill", 1, 1024), ("decode", 8, 1024)]
# decode attention's score matmul at a kv length off the 64-wide grid: 15
# kv blocks, served from the bucket of 16
BUCKETED_KV = 1000
# the route's own traffic: tile requests of qwen1.5-0.5b's forward passes
# at drawn batches and ragged lengths, from 8 client threads, then 1, then 8;
# the stampede asks for decode scores past the drawn kv lengths (cold)
LOAD_REQUESTS = 2000
LOAD_CLIENTS = (8, 1, 8)
LOAD_KERNELS = 8  # bucket-hit shapes of the load run on the card
# the load generator's gates (hit p99 ms, deadline-met, coalesce ratio)
GATES = (50.0, 0.95, 0.5)
BENCH_ARGS = ["bench", "--fast", "--config", "qwen1_5_0_5b", "--requests",
              "60", "--clients", "8", "--gate-hit-p99-ms", "50",
              "--gate-deadline-ratio", "0.95", "--gate-coalesce-ratio",
              "0.5"]

# the served model (phase 5): (batch, prompt, greedy tokens) of the f32
# card-against-CPU check, and the bf16 serve of PERF.md's main path
SERVE_CHECK = (2, 32, 4)
SERVE = (8, 1024, 32)
# f32 logits on the card against the CPU's, elementwise: the two sum each
# product in another order (no TF32), so they agree to rounding; 1e-4
# (absolute and relative) is the port's f32 tolerance against JAX
LOGIT_TOL = 1e-4

# the training path (phase 6): the flash backward at qwen's attention
# (B, S, heads, Dh) with the model's 512/512 chunks; the reference's
# gradient tolerance in f32 (tests/test_flash_attention.py), and in bf16
# (p, dout and ds rounded to bf16 before each product) 3e-2 of the largest
# |g|, the bf16 tolerance of the port's CPU tests
FA_BWD = (2, 1024, 16, 64)
FA_GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
# one f32 AdamW step, card against CPU, at batch x tokens; lr 1e-3 from the
# first step (warmup 1), so every parameter moves by up to ~1e-3.  Loss and
# grad norm agree to f32 summation order; an updated parameter may differ
# where its gradient is near Adam's eps (Adam divides by its own size)
TRAIN_CHECK = (2, 32)
TRAIN_CHECK_OPT = OptConfig(lr=1e-3, warmup=1)
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4}
# training as users run it: global batch, sequence, steps, checkpoint
# interval, the step a second run resumes to
TRAIN = (8, 1024, 6, 3, 8)
# resume exactness: layers (full width), batch, sequence, steps before and
# after the checkpoint
RESUME = (2, 4, 256, 3)

# the mapper's evidence (phase 7): the gap harness's budgets on the card's
# plan arch, and the budget and seed of each baseline whose best tile the
# kernel runs
GAP_BUDGETS = [100, 1000]
GAP_KERNEL_BUDGET = 1000
GAP_SEED = 0
GAP_ARCH = "h100-wgmma"

MM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
             (384, 384, 384)]
FA_SHAPES = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal)
    (1, 256, 256, 2, 2, 128, True),
    (2, 128, 256, 4, 2, 128, False),  # GQA + cross-length
    (1, 384, 384, 4, 1, 128, True),   # MQA
    (2, 100, 130, 4, 2, 32, True),    # ragged edges, Dh 32
    (8, 1, 100, 4, 2, 32, False),     # decode, ragged last kv tile
    (1, 1024, 1024, 16, 16, 64, True),  # qwen1.5-0.5b prefill 1x1024
    (8, 1, 1024, 16, 16, 64, False),    # qwen1.5-0.5b decode 8x1024
]
# bf16 matmul tiles beyond the 128-cube: (M, K, N, (bm, bk, bn)); together
# they launch every instance (MT, N0, N1) of csrc/matmul.cu
WGMMA_CASES = [
    (1, 256, 1024, (1, 64, 512)),      # M = 1: (1, 256, 256)
    (8, 320, 1536, (8, 64, 192)),      # M = 8, (1, 128, 64), ring wraps
    (8, 192, 512, (8, 64, 64)),        # (1, 64, 0): second warpgroup idle
    (8, 8, 64, (8, 8, 64)),            # K below one box (zero-filled)
    (8, 128, 8, (8, 64, 8)),           # N below one box
    (8, 1024, 896, (8, 64, 448)),      # seven 64-wide boxes: (1, 256, 192)
    (8, 1024, 1024, (8, 64, 128)),     # (1, 64, 64): decode lm_head's
    (8, 256, 640, (8, 64, 320)),       # (1, 192, 128)
    (8, 128, 768, (8, 64, 384)),       # (1, 192, 192) side by side
    (64, 256, 1024, (64, 64, 256)),    # (1, 128, 128)
    (256, 320, 384, (128, 64, 192)),   # split along m: (1, 192, 192)
    (256, 512, 512, (128, 64, 256)),   # (1, 256, 256)
    (512, 384, 256, (256, 64, 128)),   # (2, 128, 128): the prefill tile
    (512, 384, 256, (256, 64, 64)),    # (2, 64, 64)
    (1024, 512, 128, (512, 64, 64)),   # (4, 64, 64): bm 512, three stages
    (384, 640, 384, (128, 128, 128)),  # bk 128: two boxes a stage
]
# bf16 attention tiles: the tensor-core path at 1, 4 and 8 warps and kv
# tiles of 64 and 128, and the decode path (q tile below 16)
FA_BF16_TILES = [(64, 64), (128, 128), (16, 64), (1, 64), (1, 512)]
# reference tolerances (tests/test_kernels.py)
MM_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
MM_TCM_TOL = 1e-4  # the TCM-tiled f32 case
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# A bf16 kernel output is also held elementwise against its plain version,
# which does the same arithmetic: both add the same f32 products in another
# order, so an output may round to the neighbouring bf16 value, one step of
# which is at most 2^-7 of the value itself.  The absolute term covers
# outputs near 0, whose f32 sums cancel (attention outputs are ~0.05).
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 4e-3

FAILURES = []


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        FAILURES.append(name)


def close(out, ref, tol, rtol=None) -> tuple:
    """(all |out - ref| <= tol + rtol * |ref|, max |out - ref|); rtol
    defaults to tol, as in the reference tests."""
    err = (out.float() - ref.float()).abs()
    bound = tol + (tol if rtol is None else rtol) * ref.float().abs()
    return bool((err <= bound).all()), err.max().item()


def close_to_plain(out, plain, tol) -> tuple:
    """The kernel against its plain version: the reference's ``tol`` for
    f32, one bf16 rounding step for bf16.  (ok, max|err|, tolerance)."""
    if out.dtype == torch.bfloat16:
        return (*close(out, plain, BF16_ATOL, BF16_RTOL),
                f"{BF16_ATOL} + 2^-7|plain|")
    return (*close(out, plain, tol), f"{tol}")


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def randn(shape, dtype, g) -> torch.Tensor:
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def phase_environment() -> str:
    print("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    print(f"built {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in build.ptxas_summary(build.ptxas_log):
        print("  " + line)
    return smi


def check_matmul(dtype, M, K, N, tiles, g) -> None:
    bm, bk, bn = tiles
    a, b = randn((M, K), dtype, g), randn((K, N), dtype, g)
    out = matmul_cuda(a, b, bm=bm, bk=bk, bn=bn)
    tol = MM_TOL[dtype]
    ok1, e1, t1 = close_to_plain(out, matmul_plain(a, b, bm=bm, bk=bk, bn=bn),
                                 tol)
    ok2, e2 = close(out, matmul_ref(a, b), tol)
    inst = (f" instance {wgmma_instance(bm, bn)}"
            if dtype == torch.bfloat16 else "")
    check(f"matmul {dtype} {M}x{K}x{N} tiles {tiles}{inst}", ok1 and ok2,
          f"max|err| vs plain {e1:.3g} (tol {t1}), vs oracle {e2:.3g} "
          f"(tol {tol})")


def phase_kernels() -> None:
    print("== phase 2: kernels against plain versions on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for i, (M, K, N) in enumerate(MM_SHAPES):
            check_matmul(dtype, M, K, N, (128, 128, 128), gen(i))
    launched = set()
    for i, (M, K, N, tiles) in enumerate(WGMMA_CASES):
        check_matmul(torch.bfloat16, M, K, N, tiles, gen(30 + i))
        launched.add(wgmma_instance(tiles[0], tiles[2]))
    check("every bf16 wgmma instance launched",
          launched == set(range(wgmma_instances())),
          f"{sorted(launched)} of {wgmma_instances()} instances")
    for dtype in (torch.float32, torch.bfloat16):
        M, K, N = 512, 384, 640
        g = gen(10)
        a, b = randn((M, K), dtype, g), randn((K, N), dtype, g)
        tiles = tcm_matmul_plan(M, K, N, word_bytes=a.element_size()).tiles
        out = tcm_matmul(a, b)
        ap = _pad_to(_pad_to(a, tiles[0], 0), tiles[1], 1)
        bp = _pad_to(_pad_to(b, tiles[1], 0), tiles[2], 1)
        plain = matmul_plain(ap, bp, bm=tiles[0], bk=tiles[1],
                             bn=tiles[2])[:M, :N]
        ok, e, t = close_to_plain(out, plain, MM_TCM_TOL)
        check(f"tcm_matmul {dtype} {M}x{K}x{N} tiles {tiles}", ok,
              f"max|err| vs plain {e:.3g} (tol {t})")
    for dtype in (torch.float32, torch.bfloat16):
        tol = FA_TOL[dtype]
        tile_list = FA_BF16_TILES if dtype == torch.bfloat16 else [(64, 64)]
        for i, (B, Sq, Sk, Hq, Hkv, Dh, causal) in enumerate(FA_SHAPES):
            g = gen(20 + i)
            q = randn((B, Sq, Hq, Dh), dtype, g)
            k = randn((B, Sk, Hkv, Dh), dtype, g)
            v = randn((B, Sk, Hkv, Dh), dtype, g)
            want = attention_ref(q, k, v, causal=causal)
            for bq, bkv in tile_list:
                out = flash_attention_cuda(q, k, v, causal=causal, bq=bq,
                                           bk=bkv)
                ok1, e1, t1 = close_to_plain(out, flash_attention_plain(
                    q, k, v, causal=causal, bq=bq, bk=bkv), tol)
                ok2, e2 = close(out, want, tol)
                check(f"flash_attention {dtype} {(B, Sq, Sk, Hq, Hkv, Dh)} "
                      f"causal={causal} tiles {(bq, bkv)}", ok1 and ok2,
                      f"max|err| vs plain {e1:.3g} (tol {t1}), "
                      f"vs oracle {e2:.3g} (tol {tol})")
    torch.cuda.synchronize()


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the data needs: top-left causal rows see q+1."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, i + 1) for i in range(Sq))


def bound_s(nbytes: float, flops: float) -> tuple:
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(tb, tf), ("bytes" if tb >= tf else "operations"), tb, tf


def phase_main_path() -> dict:
    print("== phase 3: main path, qwen1.5-0.5b at full width, bf16")
    cfg = get_config("qwen1_5_0_5b")
    matmul_cuda.launches = 0
    flash_attention_cuda.launches = 0
    driven = [(mode, *run_model(cfg, mode, batch, seq, dtype=torch.bfloat16,
                                seed=s))
              for s, (mode, batch, seq) in enumerate(RUNS)]
    torch.cuda.synchronize()
    launches = {"matmul": matmul_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    print(f"  launches on the main path: {launches}")

    dev = torch.device("cuda")
    tot = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      tb=0.0, tf=0.0, err=0.0)
           for name in launches}

    def held(label, out, plain, shape) -> float:
        ok, err, t = close_to_plain(out, plain, None)
        check(label, tuple(out.shape) == shape
              and bool(torch.isfinite(out).all()) and ok,
              f"max|err| {err:.3g} (tol {t})")
        return err

    def record(name, err, row, plain, library, nbytes, flops, blocks):
        """Adds the plain, library, bound and grid columns to measure's
        row."""
        t, t_d = row["measured_s"], row["default_s"]
        t_p, t_l = (time_call(f, dev) for f in (plain, library))
        bnd, by, tb, tf = bound_s(nbytes, flops)
        modeled = row["modeled_s"]
        print(f"    ms {t * 1e3:.4f} default{tuple(row['default_tiles'])} "
              f"{t_d * 1e3:.4f} plain {t_p * 1e3:.4f} library "
              f"{t_l * 1e3:.4f} ({t / t_l:.2f}x) bound {bnd * 1e3:.4g} ({by}, "
              f"share {bnd / t:.3f}) grid {blocks} blocks / {SMS} SMs "
              f"modeled(one SM) "
              f"{'none' if modeled is None else f'{modeled * 1e3:.4f}'}")
        s = tot[name]
        for key, val in (("ms", t), ("plain_ms", t_p), ("library_ms", t_l),
                         ("bound_ms", bnd)):
            s[key] += val * 1e3
        s["tb"] += tb
        s["tf"] += tf
        s["err"] = max(s["err"], err)

    for mode, calls, attn in driven:
        rows = main_path_rows(calls, attn)
        for c, row in zip(calls, rows):
            (M, K, N), (bm, bk, bn) = c.shape, c.tiles
            a, b = c.inputs
            ap = _pad_to(_pad_to(a, bm, 0), bk, 1)
            bp = _pad_to(_pad_to(b, bk, 0), bn, 1)
            err = held(f"{mode} matmul {M}x{K}x{N} tiles {c.tiles} "
                       f"({', '.join(c.ops[:3])}"
                       f"{', ...' if len(c.ops) > 3 else ''})", c.out,
                       matmul_plain(ap, bp, bm=bm, bk=bk, bn=bn)[:M, :N],
                       (M, N))
            record("matmul", err, row,
                   lambda: matmul_plain(ap, bp, bm=bm, bk=bk, bn=bn),
                   lambda: torch.matmul(a, b),
                   2 * (M * K + K * N + M * N), 2 * M * K * N,
                   (ap.shape[0] // bm) * (bp.shape[1] // bn))

        (B, Sq, Sk, Hq, Hkv, Dh), causal, (bq, bkv) = (attn.shape,
                                                       attn.causal, attn.tiles)
        q, k, v = attn.inputs
        err = held(f"{mode} flash_attention {attn.shape} causal={causal} "
                   f"tiles {attn.tiles}", attn.out,
                   flash_attention_plain(q, k, v, causal=causal, bq=bq,
                                         bk=bkv), tuple(q.shape))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        record("flash_attention", err, rows[-1],
               lambda: flash_attention_plain(q, k, v, causal=causal, bq=bq,
                                             bk=bkv),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv),
               2 * (2 * B * Sq * Hq * Dh + 2 * B * Sk * Hkv * Dh),
               4 * B * Hq * Dh * attention_pairs(Sq, Sk, causal),
               B * Hq * (Sq if bq < 16 else -(-Sq // bq)))
    torch.cuda.synchronize()
    return {"launches": launches, "totals": tot}


def held_at_tile(a, b, tile, out) -> tuple:
    """``tcm_matmul``'s output at ``tile`` against the plain version on the
    same padded operands: (ok, max|err|, tolerance)."""
    (M, K), N = a.shape, b.shape[1]
    bm, bk, bn = tile
    ap = _pad_to(_pad_to(a, bm, 0), bk, 1)
    bp = _pad_to(_pad_to(b, bk, 0), bn, 1)
    ok, err, tol = close_to_plain(
        out, matmul_plain(ap, bp, bm=bm, bk=bk, bn=bn)[:M, :N], None)
    return (tuple(out.shape) == (M, N) and bool(torch.isfinite(out).all())
            and ok), err, tol


def phase_service() -> None:
    print("== phase 4: service route, qwen1.5-0.5b at full width, bf16")
    cfg = get_config("qwen1_5_0_5b")
    shapes = list(dict.fromkeys(
        shp for mode, batch, seq in RUNS
        for shp in model_shapes(cfg, mode, batch, seq).values()))
    bucketed = (1, cfg.d_head, BUCKETED_KV)
    clear_search_caches()  # phase 3's plans warmed them: search cold
    dev = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory(prefix="tcm-serve-") as root, \
            MappingService(cache_root=root) as svc:
        tiles = {}
        for shp in shapes:
            cold, first = service_matmul_tiles(svc, *shp,
                                               allow_bucketed=False)
            hot, second = service_matmul_tiles(svc, *shp,
                                               allow_bucketed=False)
            want = tcm_matmul_plan(*shp).tiles
            check(f"serve {'x'.join(map(str, shp))}",
                  (first.source, second.source) == ("search", "exact-hit")
                  and cold.tiles == hot.tiles == want,
                  f"{first.source} {first.latency_s * 1e3:.3f} ms, then "
                  f"{second.source} {second.latency_s * 1e3:.4f} ms; tile "
                  f"{cold.tiles} (phase 3: {want})")
            tiles[shp] = cold.tiles
            rows.append({"shape": list(shp), "tile": list(cold.tiles),
                         "map": [first.source, second.source],
                         "map_ms": [first.latency_s * 1e3,
                                    second.latency_s * 1e3]})
        plan, resp = service_matmul_tiles(svc, *bucketed)
        check(f"serve {'x'.join(map(str, bucketed))} (decode scores, kv "
              f"{BUCKETED_KV})", resp.bucketed and kernel_takes(
                  *plan.tiles, bucketed[1], 2),
              f"{resp.source} of {resp.served_einsum.rank_shapes} in "
              f"{resp.latency_s * 1e3:.4f} ms; tile {plan.tiles}")
        tiles[bucketed] = plan.tiles
        rows.append({"shape": list(bucketed), "tile": list(plan.tiles),
                     "map": [resp.source], "map_ms": [resp.latency_s * 1e3]})
        svc.drain_warm()

        matmul_cuda.launches = 0
        flash_attention_cuda.launches = 0
        g = gen(40)
        driven = []
        for shp, tile in tiles.items():
            M, K, N = shp
            a, b = randn((M, K), torch.bfloat16, g), randn((K, N),
                                                          torch.bfloat16, g)
            driven.append((a, b, tile, tcm_matmul(a, b, tiles=tile)))
        B, Sq, H, Dh = 1, 1024, cfg.n_heads, cfg.d_head
        fa, fa_out = measure_flash_attention(
            svc, B, H, Sq, Sq, Dh, causal=True, dtype=torch.bfloat16,
            seed=41, return_out=True)
        torch.cuda.synchronize()
        launches = {"matmul": matmul_cuda.launches,
                    "flash_attention": flash_attention_cuda.launches}
        print(f"  launches on the service route: {launches}")
        check("every kernel launched on the service route",
              min(launches.values()) > 0, f"{launches}")

    for row, (a, b, tile, out) in zip(rows, driven):
        (M, K), N = a.shape, b.shape[1]
        ok, err, tol = held_at_tile(a, b, tile, out)
        row["kernel_ms"] = time_call(
            lambda: tcm_matmul(a, b, tiles=tile), dev) * 1e3
        row["max_abs_err"] = err
        check(f"kernel at served tile {M}x{K}x{N} {tile}", ok,
              f"max|err| {err:.3g} (tol {tol}), {row['kernel_ms']:.4f} ms")
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v = (_randn((B, Sq, H, Dh), torch.bfloat16, dev, g)
               for _ in range(3))  # as measure_flash_attention made them
    bq, bkv = fa["tiles"]
    ok, err, tol = close_to_plain(fa_out, flash_attention_plain(
        q, k, v, causal=True, bq=bq, bk=bkv), None)
    check(f"flash_attention at served tiles {(B, Sq, Sq, H, H, Dh)} "
          f"{(bq, bkv)}", fa["map_source"] == "exact-hit" and ok,
          f"{fa['map_source']} {fa['map_latency_ms']:.4f} ms, kernel "
          f"{fa['measured_s'] * 1e3:.4f} ms (default tiles "
          f"{fa['default_s'] * 1e3:.4f} ms), max|err| {err:.3g} (tol {tol})")
    rows.append({"shape": fa["shape"], "tile": fa["tiles"],
                 "map": [fa["map_source"]], "map_ms": [fa["map_latency_ms"]],
                 "kernel_ms": fa["measured_s"] * 1e3, "max_abs_err": err})

    with tempfile.TemporaryDirectory(prefix="tcm-bench-") as tmp:
        path = os.path.join(tmp, "bench.json")
        rc = serve_map_main(BENCH_ARGS + ["--json", path])
        with open(path) as f:
            bench = json.load(f)
    check("serve_map bench --fast, 60 requests, 8 clients, gates", rc == 0,
          f"exit {rc}, gate failures {bench['gate_failures']}")

    load, load_kernels = phase_service_load(cfg, dev)
    print(json.dumps({"service": {
        "launches": launches, "shapes": rows,
        "bench_fast_gates": {"exit": rc,
                             "failures": bench["gate_failures"]},
        "load": load, "load_kernels": load_kernels}}))


def phase_service_load(cfg, dev) -> tuple:
    """The route's own traffic at full width through ``run_tile_load``: a
    fresh service, warmed once per bucket, then LOAD_CLIENTS runs of the
    same requests; then the kernels at a sample of the tiles it served
    from buckets, each held against its plain version."""
    shapes = tile_request_shapes(cfg, requests=LOAD_REQUESTS, seed=0)
    herd = (1, cfg.d_head, 2 * 1024 + 3)  # kv past the drawn range: cold
    load, served = [], {}
    with tempfile.TemporaryDirectory(prefix="tcm-load-") as root, \
            MappingService(cache_root=root) as svc:
        for i, clients in enumerate(LOAD_CLIENTS):
            rep = run_tile_load(svc, shapes, clients=clients,
                                warmup=i == 0,
                                stampede=herd if i == 0 else None)
            served.update(rep.pop("served"))
            p99, met, coal = GATES
            rep["gates_met"] = (rep["hit_p99_ms"] <= p99
                                and rep["deadline_met_ratio"] >= met
                                and rep.get("coalesce_ratio", 1.0) >= coal)
            load.append(rep)
            check(f"tile load, {rep['requests']} requests, {clients} "
                  f"client(s)", rep["requests"] == len(shapes)
                  and rep["refused"] == 0 and rep["searches"] == 0
                  and (i > 0 or (rep["stampede_searches"],
                                 rep["stampede_coalesced"])
                       == (1, clients - 1)),
                  f"{rep['unique_shapes']} shapes in {rep['unique_buckets']} "
                  f"buckets ({rep['warmup_searches']} warm-up searches, "
                  f"{rep['warmup_s'] * 1e3:.1f} ms), {rep['sources']}; hit "
                  f"p50 {rep['hit_p50_ms']:.4f} p99 {rep['hit_p99_ms']:.4f} "
                  f"ms, tile p50 {rep['tile_p50_ms']:.4f} p99 "
                  f"{rep['tile_p99_ms']:.4f} ms, deadline-met "
                  f"{rep['deadline_met_ratio']:.4f}, coalesce "
                  f"{rep.get('coalesce_ratio', '-')}, refused "
                  f"{rep['refused']}; SLO gates "
                  f"{'met' if rep['gates_met'] else 'MISSED'}")

    bucketed = sorted(shp for shp, (_, src) in served.items()
                      if src == "bucket-hit")
    step = max(1, len(bucketed) // LOAD_KERNELS)
    g = gen(42)
    kernels = []
    for M, K, N in bucketed[::step][:LOAD_KERNELS]:
        bm, bk, bn = served[(M, K, N)][0]
        a, b = randn((M, K), torch.bfloat16, g), randn((K, N),
                                                      torch.bfloat16, g)
        out = tcm_matmul(a, b, tiles=(bm, bk, bn))
        ok, err, tol = held_at_tile(a, b, (bm, bk, bn), out)
        ms = time_call(lambda: tcm_matmul(a, b, tiles=(bm, bk, bn)),
                       dev) * 1e3
        check(f"kernel at load-served tile {M}x{K}x{N} {(bm, bk, bn)}", ok,
              f"max|err| {err:.3g} (tol {tol}), {ms:.4f} ms")
        kernels.append({"shape": [M, K, N], "tile": [bm, bk, bn],
                        "kernel_ms": ms, "max_abs_err": err})
    return load, kernels


def greedy(cfg, params, dev, B, P, G) -> tuple:
    """The serving steps' greedy run on ``dev``: each step's logits (on
    the CPU) and the tokens."""
    prefill_step, decode_step = make_serve_steps(cfg)
    batch = serve.make_batch(cfg, B, P, dev, seed=1)
    cache = lm.init_cache(cfg, B, P + G, dev)
    logits, cache = prefill_step(params, batch, cache)
    steps, toks = [logits.cpu()], [logits.argmax(-1)[:, None]]
    for _ in range(G - 1):
        logits, cache = decode_step(params, toks[-1], cache)
        steps.append(logits.cpu())
        toks.append(logits.argmax(-1)[:, None])
    return steps, torch.cat(toks, dim=1).cpu()


def served_bounds(cfg, B, P, G) -> dict:
    """Least times of the bf16 serve, from its shapes: a decode step reads
    the bf16 weights it multiplies (f32 norm scales, the head, the B
    embedding rows) and the valid KV cache, and writes one K/V row per
    layer and the f32 logits; prefill does the matmuls of B*P tokens, the
    causal attention (4 Dh operations a (query, key) pair), and the head
    on the last position, and moves the weights once, the K/V it caches
    and the logits."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    q, kv, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    layer_macs = 2 * d * q + 2 * d * kv + 3 * d * ff  # per token
    weights = (L * (layer_macs + q + 2 * kv) * 2 + (2 * L + 1) * d * 4
               + d * V * 2)
    kv_row = 2 * kv * 2  # K and V of one token in one layer, bf16
    decode = [bound_s(weights + B * d * 2 + L * B * (P + i + 1) * kv_row
                      + L * B * kv_row + B * V * 4,
                      2 * B * (L * layer_macs + d * V)
                      + L * 4 * B * cfg.n_heads * cfg.d_head * (P + i + 1))
              for i in range(G - 1)]
    flops = (2 * B * P * L * layer_macs + 2 * B * d * V
             + L * 4 * B * cfg.n_heads * cfg.d_head * P * (P + 1) // 2)
    nbytes = weights + B * P * d * 2 + L * B * P * kv_row + B * V * 4
    pb, pby, _, _ = bound_s(nbytes, flops)
    db = sum(b[0] for b in decode) / len(decode)
    return {"prefill_ms": pb * 1e3, "prefill_by": pby,
            "prefill_tflop": flops / 1e12,
            "decode_ms_per_step": db * 1e3, "decode_by": decode[0][1],
            "tok_s": B / db}


def phase_served_model() -> None:
    print("== phase 5: served model, qwen1.5-0.5b at full width")
    B, P, G = SERVE_CHECK
    cfg = get_config("qwen1_5_0_5b").scaled(dtype="float32")
    t0 = time.perf_counter()
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = lm.tree_map(lambda t: t.to("cuda"), cpu)
    print(f"  f32 weights drawn and copied in "
          f"{time.perf_counter() - t0:.1f} s")
    want, want_toks = greedy(cfg, cpu, torch.device("cpu"), B, P, G)
    got, got_toks = greedy(cfg, card, torch.device("cuda"), B, P, G)
    del cpu, card
    for step, (a, b) in enumerate(zip(got, want)):
        ok, err = close(a, b, LOGIT_TOL)
        check(f"f32 logits, card against CPU, step {step} "
              f"{'(prefill)' if step == 0 else '(decode)'}",
              ok and a.shape == (B, cfg.vocab)
              and bool(torch.isfinite(a).all()),
              f"max|d logits| {err:.3g} of max|logit| "
              f"{b.abs().max().item():.3g} (tol {LOGIT_TOL} + "
              f"{LOGIT_TOL}|cpu|)")
    check("greedy tokens, card equal to CPU",
          torch.equal(got_toks, want_toks), f"{got_toks.tolist()}")
    torch.cuda.empty_cache()

    B, P, G = SERVE
    with tempfile.TemporaryDirectory(prefix="tcm-serve-model-") as tmp:
        path = os.path.join(tmp, "serve.json")
        cwd = os.getcwd()
        os.chdir(tmp)  # the mapping service caches under the cwd
        try:
            gen = serve.main(["--arch", "qwen1.5-0.5b", "--batch", str(B),
                              "--prompt-len", str(P), "--gen", str(G),
                              "--map-service", "--profile", "--json",
                              path])
        finally:
            os.chdir(cwd)
        with open(path) as f:
            rep = json.load(f)
    cfg = get_config("qwen1_5_0_5b")
    plan = rep["map_service"]
    check(f"bf16 serve {B}x{P} + {G}", gen.shape == (B, G)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all())
          and rep["device"] == torch.cuda.get_device_name(0)
          and plan["requests"] == 6 * G,
          f"prefill {rep['prefill_ms']:.3f} ms, decode "
          f"{rep['decode_ms_per_step']:.3f} ms a step, "
          f"{rep['tok_s']:.1f} tokens/s, peak "
          f"{rep['peak_bytes'] / 2**30:.3f} GiB; map-service "
          f"{plan['requests']} queries, {plan['searches']} searches")
    rep["bounds"] = served_bounds(cfg, B, P, G)
    prof = rep["profile"]["decode_per_step"]
    busy = prof["device_ms"]
    share = (None if busy is None
             else f"{busy / rep['decode_ms_per_step']:.3f}")
    print(f"  profiled decode step: {prof['activities']:.0f} device "
          f"activities, busy {busy} ms; busy share of the unprofiled step "
          f"{share} (None: the profiler traced no device activity)")
    print(json.dumps({"served": rep}))


def check_flash_backward() -> dict:
    """(a): d(q, k, v) of sum(tanh(attention @ w)), the reference test's
    function, through the port's flash attention and through autograd of
    the naive f32 attention (``kernels.ref.attention_ref``), on the
    card."""
    B, S, H, Dh = FA_BWD
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = gen(60)
        ins = [randn((B, S, H, Dh), dtype, g).requires_grad_()
               for _ in range(3)]
        w = randn((Dh,), torch.float32, g)
        got, want = (torch.autograd.grad(
            torch.tanh(fn(*ins).float() @ w).sum(), ins) for fn in (
                lambda q, k, v: flash_attention(q, k, v, causal=True),
                lambda q, k, v: attention_ref(q, k, v, causal=True)))
        tol = FA_GRAD_TOL[dtype]
        errs = []
        for name, a, b in zip("qkv", got, want):
            atol = tol if dtype == torch.float32 else tol * b.abs().max()
            ok, err = close(a, b, float(atol), tol)
            errs.append(err)
            check(f"flash backward {dtype} d{name} {(B, S, H, Dh)} causal, "
                  f"chunks 512/512, against autograd of naive f32",
                  ok and bool(torch.isfinite(a).all()),
                  f"max|err| {err:.3g} of max|g| {b.abs().max().item():.3g} "
                  f"(tol {float(atol):.3g} + {tol}|g|)")
        out[str(dtype)] = {"max_abs_err": errs}
    return out


def check_train_step_card_vs_cpu() -> dict:
    """(b): one f32 AdamW step at full width from the same weights and
    batch, on the card and on the CPU."""
    B, S = TRAIN_CHECK
    cfg = get_config("qwen1_5_0_5b").scaled(dtype="float32")
    oc = TRAIN_CHECK_OPT
    t0 = time.perf_counter()
    cpu, cpu_opt = init(cfg, oc, "cpu")
    card = lm.tree_map(lambda t: t.to("cuda", copy=True), cpu)
    card_opt = init_opt_state(oc, card)
    print(f"  f32 weights drawn and copied in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = next(SyntheticTokens(DataConfig(global_batch=B, seq_len=S,
                                            vocab=cfg.vocab, seed=1)))
    step = make_train_step(cfg, oc)
    res = {}
    for name, params, opt in (("cpu", cpu, cpu_opt), ("card", card,
                                                       card_opt)):
        _, _, m = step(params, opt, batch)
        res[name] = {k: v.item() for k, v in m.items()}
    for key in ("loss", "grad_norm"):
        a, b = res["card"][key], res["cpu"][key]
        check(f"f32 train step {B}x{S}, {key}, card against CPU",
              math.isfinite(a) and abs(a - b) <= TRAIN_TOL[key] * abs(b),
              f"{a:.9g} vs {b:.9g} (rel tol {TRAIN_TOL[key]})")
    dmax = max((a.detach().cpu() - b.detach()).abs().max().item()
               for a, b in zip(lm.tree_leaves(card), lm.tree_leaves(cpu)))
    check(f"f32 train step {B}x{S}, updated parameters, card against CPU",
          dmax <= TRAIN_TOL["params"],
          f"max|d param| {dmax:.3g} (tol {TRAIN_TOL['params']}; a step "
          f"moves a parameter up to ~{oc.lr})")
    res["max_abs_param_err"] = dmax
    # the optimizer's share of a step: one update of every f32 parameter
    # (the values do not change its work)
    ones = lm.tree_map(torch.ones_like, card)
    res["optimizer_ms"] = time_call(
        lambda: apply_updates(oc, card, ones, card_opt),
        torch.device("cuda")) * 1e3
    print(f"  AdamW update of {len(lm.tree_leaves(card))} f32 leaves on the "
          f"card: {res['optimizer_ms']:.3f} ms")
    del cpu, cpu_opt, card, card_opt, ones
    torch.cuda.empty_cache()
    return res


def time_attention(cfg, B, S) -> dict:
    """Attention's share of a bf16 train step: the flash forward and
    forward + backward of one layer at the step's shapes (CUDA events), and
    the step's total, each layer's forward run twice (remat re-runs it)
    and its backward once."""
    g = gen(61)
    q, k, v = (randn((B, S, cfg.n_heads, cfg.d_head), torch.bfloat16, g)
               .requires_grad_() for _ in range(3))
    dout = randn((B, S, cfg.n_heads, cfg.d_head), torch.bfloat16, g)
    dev = torch.device("cuda")
    fwd = time_call(lambda: flash_attention(q, k, v, causal=True), dev)
    fwd_bwd = time_call(lambda: torch.autograd.grad(
        flash_attention(q, k, v, causal=True), (q, k, v), dout), dev)
    out = {"fwd_ms": fwd * 1e3, "fwd_bwd_ms": fwd_bwd * 1e3,
           "step_ms": cfg.n_layers * (fwd + fwd_bwd) * 1e3}
    print(f"  flash attention {B}x{S}x{cfg.n_heads}x{cfg.d_head} bf16: "
          f"forward {out['fwd_ms']:.3f} ms, forward + backward "
          f"{out['fwd_bwd_ms']:.3f} ms a layer; {out['step_ms']:.3f} ms "
          f"in a step of {cfg.n_layers} layers with remat")
    return out


def trained_bounds(cfg, B, S) -> dict:
    """Least time of one bf16 train step at batch B x S tokens: the
    matmuls of forward and backward (6 operations a parameter a token, the
    head included, the embedding a gather), the causal attention's forward
    and backward (3 x 4 Dh operations a (query, key) pair), against the
    bytes the step must move: the f32 parameters and the optimizer's m and
    v read once and written once, and the tokens.  Remat's recomputation is
    work the algorithm does not need, so it is not counted."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    q, kv, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    layer = 2 * d * q + 2 * d * kv + 3 * d * ff + q + 2 * kv + 2 * d
    matmul_params = L * (2 * d * q + 2 * d * kv + 3 * d * ff) + d * V
    params = L * layer + 2 * d * V + d
    flops = (6 * matmul_params * B * S
             + L * 3 * 4 * cfg.n_heads * cfg.d_head * B * S * (S + 1) // 2)
    nbytes = 2 * 3 * 4 * params + 2 * B * S * 4
    bnd, by, _, _ = bound_s(nbytes, flops)
    return {"step_ms": bnd * 1e3, "step_by": by, "tflop": flops / 1e12,
            "gbytes": nbytes / 1e9, "tok_s": B * S / bnd,
            "params": params, "static_bytes": 4 * 4 * params}


def run_training(tmp: str) -> dict:
    """(c): ``launch.train.main`` as a user runs it, then a resume."""
    B, S, steps, every, resumed = TRAIN
    args = ["--arch", "qwen1.5-0.5b", "--global-batch", str(B), "--seq-len",
            str(S), "--ckpt-dir", os.path.join(tmp, "ckpt"),
            "--ckpt-every", str(every), "--log-every", "1"]
    paths = [os.path.join(tmp, f"run{i}.json") for i in (1, 2)]
    losses = [train.main(args + ["--steps", str(steps), "--profile",
                                 "--json", paths[0]]),
              train.main(args + ["--steps", str(resumed), "--json",
                                 paths[1]])]
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    first, second = runs
    cfg = get_config("qwen1_5_0_5b")
    check(f"bf16 training {B}x{S}, {steps} steps then resumed to {resumed}",
          first["steps"] == steps and second["start_step"] == steps
          and second["steps"] == resumed - steps
          and all(math.isfinite(x) for r in runs for x in r["loss"])
          and first["device"] == torch.cuda.get_device_name(0)
          and CheckpointManager(os.path.join(tmp, "ckpt")).all_steps()
          == [every, steps, resumed],
          f"loss {first['loss'][0]:.4f} -> {losses[0]:.4f} -> "
          f"{losses[1]:.4f}, step {first['step_ms_median']:.1f} ms "
          f"(median after the first), {first['tok_s']:.0f} tokens/s, peak "
          f"{first['peak_bytes'] / 2**30:.3f} GiB")
    prof = first["profile"]
    busy = prof["device_ms"]
    bounds = trained_bounds(cfg, B, S)
    attention = time_attention(cfg, B, S)
    share = None if busy is None else busy / first["step_ms_median"]
    print(f"  profiled step: {prof['activities']} device activities, busy "
          f"{busy} ms of {prof['wall_ms']:.3f} ms profiled, matrix products "
          f"{prof['matmul_share']} of it; busy share of the unprofiled "
          f"median step {share} (None: the profiler traced no device "
          f"activity); bound {bounds['step_ms']:.3f} ms ({bounds['step_by']})")
    return {"run": first, "resumed": second, "bounds": bounds,
            "busy_share": share, "attention": attention}


def resume_check() -> None:
    """(d), in a child process started with CUBLAS_WORKSPACE_CONFIG set:
    with deterministic algorithms, training 2N steps straight equals N,
    checkpoint, restore, N more, bit for bit.  Prints one JSON line."""
    import warnings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    L, B, S, n = RESUME
    cfg = get_config("qwen1_5_0_5b").scaled(n_layers=L)
    oc = OptConfig()
    step = make_train_step(cfg, oc)

    def data():
        return SyntheticTokens(DataConfig(global_batch=B, seq_len=S,
                                          vocab=cfg.vocab))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        params, opt = init(cfg, oc, "cuda")
        stream = data()
        for _ in range(2 * n):
            params, opt, _ = step(params, opt, next(stream))
        want = [t.detach().cpu() for t in lm.tree_leaves(params)]
        del params, opt
        params, opt = init(cfg, oc, "cuda")
        stream = data()
        for _ in range(n):
            params, opt, _ = step(params, opt, next(stream))
        with tempfile.TemporaryDirectory(prefix="tcm-resume-") as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save_async(n, {"params": params, "opt": opt},
                           extra={"data": stream.state()})
            mgr.wait()
            state, extra = mgr.restore_to(n, {"params": params, "opt": opt},
                                          "cuda")
        params, opt = state["params"], state["opt"]
        stream = data()
        stream.restore(extra["data"])
        for _ in range(n):
            params, opt, _ = step(params, opt, next(stream))
        got = [t.detach().cpu() for t in lm.tree_leaves(params)]
    unequal = sum(not torch.equal(a, b) for a, b in zip(got, want))
    dmax = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(json.dumps({"resume": {
        "layers": L, "batch": B, "seq": S, "steps": [n, n],
        "leaves": len(got), "unequal_leaves": unequal,
        "max_abs_diff": dmax,
        "nondeterministic_warnings": sorted({
            str(w.message)[:200] for w in caught
            if "deterministic" in str(w.message)})}}))


def check_resume() -> dict:
    """(d): runs ``resume_check`` in a child process, so that cuBLAS takes
    its deterministic workspace before CUDA starts there."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--resume-check"], env=env, capture_output=True,
                         text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith('{"resume"')]
    rep = json.loads(lines[-1])["resume"] if lines else None
    L, B, S, n = RESUME
    check(f"resume on the card, deterministic algorithms, {L} layers at "
          f"full width, batch {B}x{S}: {2 * n} steps == {n} + checkpoint + "
          f"restore + {n}", res.returncode == 0 and rep is not None
          and rep["unequal_leaves"] == 0,
          f"exit {res.returncode}; " + (
              f"{rep['unequal_leaves']} of {rep['leaves']} leaves differ, "
              f"max|diff| {rep['max_abs_diff']:.3g}; ops without a "
              f"deterministic implementation: "
              f"{rep['nondeterministic_warnings'] or 'none'}"
              if rep else res.stderr[-2000:]))
    return rep


def phase_training() -> None:
    print("== phase 6: training path, qwen1.5-0.5b at full width")
    t0 = time.perf_counter()
    fa = check_flash_backward()
    step = check_train_step_card_vs_cpu()
    with tempfile.TemporaryDirectory(prefix="tcm-train-") as tmp:
        rep = run_training(tmp)
    rep.update(flash_backward=fa, step_card_vs_cpu=step)
    rep["resume_check"] = check_resume()
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  phase 6 took {rep['phase_s']:.1f} s")
    print(json.dumps({"trained": rep}))


def run_argv(main_fn, argv):
    """``main_fn()``, which reads ``sys.argv``, with ``argv`` in it."""
    saved = sys.argv
    sys.argv = argv
    try:
        return main_fn()
    finally:
        sys.argv = saved


def run_gap_cli(argv) -> int:
    """``python -m repro_torch.gap`` in this process (it reads
    ``sys.argv``)."""
    return run_argv(gap_main, ["repro_torch.gap"] + argv)


def evidence_clis() -> None:
    """(a): the gap and dse CLIs' own gates, in a temp cwd (they write
    ``.tcm_cache`` and any violation repro there)."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="tcm-evidence-") as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rc = run_gap_cli(["--mode", "soundness", "--cases", "30",
                              "--seed", "0", "--json", "sound.json"])
            with open("sound.json") as f:
                sound = json.load(f)
            check("gap --mode soundness --cases 30 --seed 0",
                  rc == 0 and sound["ok"] and sound["n_cases"] == 30
                  and not sound["violations"],
                  f"exit {rc}, {sound['n_cases']} cases "
                  f"({sound['n_oracle_checked']} oracle-checked, "
                  f"{sound['n_baseline_runs']} baseline runs), "
                  f"{len(sound['violations'])} violations in "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            rc = run_gap_cli(["--fast", "--json", "gap.json"])
            with open("gap.json") as f:
                fast = json.load(f)
            cells = [p["gap"] for c in fast["curves"] for p in c["points"]]
            check("gap --fast: every curve cell >= 1.000x",
                  rc == 0 and not fast["violations"]
                  and min(cells) >= 1 - REL_EPS,
                  f"exit {rc}, {len(cells)} cells, least {min(cells):.4f}x, "
                  f"{len(fast['violations'])} violations in "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            rc = dse_main(["--fast", "--json", "dse.json"])
            with open("dse.json") as f:
                dse = json.load(f)
            check("dse --fast reaches its frontier",
                  rc == 0 and bool(dse["frontier"])
                  and not dse["resilience"]["interrupted"],
                  f"exit {rc}, {len(dse['frontier'])} frontier points of "
                  f"{dse['explorer_counters']['n_points']}, best "
                  f"{dse['best']} in {time.perf_counter() - t0:.1f} s")
        finally:
            os.chdir(cwd)


def phase_evidence(cfg) -> None:
    print("== phase 7: the mapper's evidence (soundness, gap, dse; the "
          "kernel at each searcher's tile)")
    t0 = time.perf_counter()
    evidence_clis()

    shapes = list(dict.fromkeys(
        shp for mode, batch, seq in RUNS
        for shp in model_shapes(cfg, mode, batch, seq).values()))
    arch = plan_arch()
    names = {shp: "x".join(map(str, shp)) for shp in shapes}
    t1 = time.perf_counter()
    report = run_gap({names[s]: plan_einsum(*s) for s in shapes},
                     {GAP_ARCH: arch}, budgets=GAP_BUDGETS,
                     objectives=("latency",))
    print(f"  gap on {GAP_ARCH}: {len(shapes)} shapes x {len(BASELINES)} "
          f"baselines x budgets {GAP_BUDGETS} in "
          f"{time.perf_counter() - t1:.1f} s")
    for shp in shapes:
        w = names[shp]
        curves = {c.baseline: [p.gap for p in c.points]
                  for c in report.curves if c.workload == w}
        beaten = [v.baseline for v in report.violations if v.workload == w]
        opt = report.optima[(w, GAP_ARCH, "latency")]
        check(f"gap {w}: no baseline beats TCM's modeled latency",
              not beaten and opt < float("inf"),
              f"TCM {opt * 1e3:.5g} ms modeled; gap at {GAP_BUDGETS}: "
              + ", ".join(f"{b} " + "/".join(f"{g:.3f}x" for g in gs)
                          for b, gs in curves.items())
              + (f"; beaten by {beaten}" if beaten else ""))

    dev = torch.device("cuda")
    g = gen(70)
    matmul_cuda.launches = 0
    rows = []
    for shp in shapes:
        M, K, N = shp
        ein = plan_einsum(M, K, N)
        plan = tcm_matmul_plan(M, K, N)
        searchers = {"tcm": {
            "modeled_s": report.optima[(names[shp], GAP_ARCH, "latency")],
            "tile": plan.tiles}}
        for name, fn in BASELINES.items():
            r = fn(ein, arch, GAP_KERNEL_BUDGET, GAP_SEED, "latency")
            searchers[name] = {
                "modeled_s": None if r.best is None else r.best.latency,
                # plan_from_mapping reads a result's mapping and latency
                "tile": None if r.best is None else plan_from_mapping(
                    SimpleNamespace(mapping=r.best_mapping,
                                    latency=r.best.latency), ein,
                    M, K, N).tiles,
                "n_valid": r.n_valid}
        a = randn((M, K), torch.bfloat16, g)
        b = randn((K, N), torch.bfloat16, g)
        timed = {}
        for tile in dict.fromkeys(s["tile"] for s in searchers.values()
                                  if s["tile"] is not None):
            out = tcm_matmul(a, b, tiles=tile)
            ok, err, tol = held_at_tile(a, b, tile, out)
            ms = time_call(lambda: tcm_matmul(a, b, tiles=tile), dev) * 1e3
            by = [n for n, s in searchers.items() if s["tile"] == tile]
            check(f"kernel {M}x{K}x{N} at tile {tile} ({', '.join(by)})",
                  ok, f"max|err| {err:.3g} (tol {tol}), {ms:.4f} ms")
            timed[tile] = (ms, err)
        for s in searchers.values():
            s["ms"], s["max_abs_err"] = timed.get(s["tile"], (None, None))
            s["tile"] = None if s["tile"] is None else list(s["tile"])
        bnd, by, _, _ = bound_s(2 * (M * K + K * N + M * N), 2 * M * K * N)
        tcm_ms = searchers["tcm"]["ms"]
        rank = 1 + sum(s["ms"] is not None and s["ms"] < tcm_ms
                       for n, s in searchers.items() if n != "tcm")
        rows.append({
            "shape": [M, K, N], "bound_ms": bnd * 1e3, "bound_by": by,
            "tcm_rank": rank, "of": sum(s["ms"] is not None
                                        for s in searchers.values()),
            "searchers": searchers,
            "gap": {c.baseline: [None if p.gap == float("inf") else p.gap
                                 for p in c.points]
                    for c in report.curves if c.workload == names[shp]}})
        print(f"  {M}x{K}x{N}: TCM {plan.tiles} {tcm_ms:.4f} ms, rank "
              f"{rank} of {rows[-1]['of']}; bound {bnd * 1e3:.4g} ms ({by})"
              + "".join(f"; {n} {s['tile']} "
                        + ("-" if s["ms"] is None else f"{s['ms']:.4f} ms")
                        for n, s in searchers.items() if n != "tcm"))
    torch.cuda.synchronize()
    check("the kernel launched at every searcher's tile",
          matmul_cuda.launches > 0, f"{matmul_cuda.launches} launches")
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"gap": rows}))


# the one-device tools (phase 8): compression over a tree shaped like
# qwen1.5-0.5b's f32 parameters; the model's reference dry-run cells; the
# dry-run held against the steps on the card (phase 6's train step, phase
# 5's prefill and one decode step after it); the example twins
TOOLS_ARCH = "qwen1.5-0.5b"
TOOLS_CELLS = ("train_4k", "prefill_32k", "decode_32k")
TOOLS_STEPS = [Cell("train", 8, 1024), Cell("prefill", 8, 1024, 1056),
               Cell("decode", 8, 1025, 1056)]
TOOLS_REPEATS = 5  # timed runs of each held step, after a warm-up
PEAK_TOL = 0.10  # dry-run peak against torch.cuda.max_memory_allocated
E2E_STEPS = 20  # train_e2e's 300 steps, cut for time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_compression(cfg) -> dict:
    """(a): ``compress_decompress`` over seeded gradients shaped like the
    f32 parameters on the card, held against the port's CPU run on the
    embedding and layer 0's leaves (codes and scales bitwise, or the tie
    differences counted), timed beside its bytes bound; ``quantized_psum``
    on an NCCL group of one equal to the round trip."""
    with FakeTensorMode():
        like = lm.init(cfg, torch.Generator(), "cpu")
    g = gen(8)
    grads = lm.tree_unflatten(like, [
        torch.randn(t.shape, generator=g, device="cuda")
        for t in lm.tree_leaves(like)])
    n = sum(t.numel() for t in lm.tree_leaves(grads))
    sub = {"embed": grads["embed"],
           "layer0": lm.tree_map(lambda t: t[0], grads["groups"][0])}
    code_diff = scale_diff = 0
    worst_step = 0
    for leaf in lm.tree_leaves(sub):
        q, s = compression._quant(leaf)
        qc, sc = compression._quant(leaf.cpu())
        diff = q.cpu().int() - qc.int()
        code_diff += int((diff != 0).sum())
        worst_step = max(worst_step, int(diff.abs().max()))
        scale_diff += int((s.cpu() != sc).sum())
    deq, err = compression.compress_decompress(
        sub, compression.init_error_feedback(sub))
    cpu = lm.tree_map(lambda t: t.cpu(), sub)
    deq_c, err_c = compression.compress_decompress(
        cpu, compression.init_error_feedback(cpu))
    deq_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
        lm.tree_leaves(deq) + lm.tree_leaves(err),
        lm.tree_leaves(deq_c) + lm.tree_leaves(err_c)))
    n_sub = sum(t.numel() for t in lm.tree_leaves(sub))
    # a tie coded the other way (one step) may change its dequantized
    # value and residual; nothing else may differ
    check(f"compression on the card vs the CPU ({n_sub} values: embedding "
          f"and layer 0)", scale_diff == 0 and worst_step <= 1
          and (deq_equal or code_diff > 0),
          f"{code_diff} codes differ (at most {worst_step} step), "
          f"{scale_diff} scales differ, dequantized values and residuals "
          f"{'bitwise equal' if deq_equal else 'differ'}")
    del deq, err, cpu, deq_c, err_c
    carry = compression.init_error_feedback(grads)
    ms = time_call(lambda: compression.compress_decompress(grads, carry),
                   torch.device("cuda"), repeats=3, iters=2) * 1e3
    nbytes = 16 * n  # read g and e, write deq and e, f32
    bound = nbytes / PEAK_BYTES_S * 1e3
    check(f"compress_decompress over {n} f32 values", math.isfinite(ms),
          f"{ms:.3f} ms, bound {bound:.3f} ms (bytes, {nbytes / 1e9:.2f} "
          f"GB), {bound / ms:.3f} of it")
    del carry
    x = grads["embed"]["tok"][:4096]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        out = compression.quantized_psum(x, dist.group.WORLD)
        q, s = compression._quant(x)
        same = torch.equal(out, compression._dequant(q, s, x.shape))
    finally:
        dist.destroy_process_group()
    check(f"quantized_psum on an NCCL group of 1 ({x.numel()} values) == "
          f"the round trip", same, "bitwise" if same else "differs")
    return {"values": n, "ms": ms, "bound_ms": bound, "bytes": nbytes,
            "held_values": n_sub, "codes_differ": code_diff,
            "scales_differ": scale_diff, "deq_bitwise": deq_equal,
            "psum_bitwise": same}


def check_dryrun_cells(tmp: str) -> list:
    """(b): the reference's dry-run cells of the model on the card, and
    the roofline over them with the H100's constants."""
    rows = []
    for shape in TOOLS_CELLS:
        res = run_cell(TOOLS_ARCH, shape, device="cuda")
        path = Path(tmp) / f"{TOOLS_ARCH}__{shape}__one.json"
        path.write_text(json.dumps(res))
        roof = analyze_cell(path)
        mem = res["memory_per_device"]
        check(f"dry-run {TOOLS_ARCH} {shape}", "error" not in res
              and res["n_devices"] == 1
              and res["hlo"]["per_device_flops"] > 0
              and res["hlo"]["total_collective_bytes"] == 0,
              f"traced layers {res['traced_layers']} in "
              f"{res['hlo']['trace_s']} s, {res['hlo']['ops']} ops, "
              f"{res['hlo']['per_device_flops']:.4g} FLOPs, peak "
              f"{mem['peak_live_bytes'] / 2**30:.2f} GiB; roofline "
              f"compute {roof['compute_s']:.4g} s, memory "
              f"{roof['memory_s']:.4g} s ({roof['dominant']}), useful "
              f"FLOP ratio {roof['useful_ratio']:.3f}")
        rows.append({"shape": shape, "dryrun": res, "roofline": roof})
    return rows


def step_bound_ms(cfg, cell, flops: float) -> tuple:
    """The roofline's bound of a step: its traced FLOPs at the bf16 peak
    against ``analytic_hbm_bytes`` at the HBM rate."""
    tf = flops / PEAK_BF16_FLOPS * 1e3
    tb = analytic_hbm_bytes(cfg, cell) / PEAK_BYTES_S * 1e3
    return max(tf, tb), "operations" if tf >= tb else "bytes"


def check_dryrun_vs_card(cfg) -> list:
    """(c): each step's fake trace against the same step on the card:
    peak within ``PEAK_TOL`` of the allocator's peak over the real run
    (from a reset before its inputs exist), FLOPs equal to
    ``FlopCounterMode`` over it; then the step after a warm-up,
    ``TOOLS_REPEATS`` times on the host's clock (each to a
    synchronize), and their median."""
    dev = torch.device("cuda")
    rows = []
    for cell in TOOLS_STEPS:
        c = cfg if cell.kind == "train" else cfg.scaled(
            param_dtype="bfloat16")
        fake = trace_step(c, cell, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step, args = make_inputs(c, cell, dev)
        with FlopCounterMode(display=False) as fc:
            real = count(step, args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        samples = []
        for _ in range(1 + TOOLS_REPEATS):  # a warm-up, then the repeats
            if cell.kind != "train":  # rewind the cache the step filled
                fill_cache(args[2], 0 if cell.kind == "prefill"
                           else cell.seq_len - 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        samples = samples[1:]
        ms = statistics.median(samples)
        del step, args
        want = fake["memory_per_device"]["peak_live_bytes"]
        flops = fake["hlo"]["per_device_flops"]
        bound, by = step_bound_ms(c, cell, flops)
        check(f"dry-run vs the card: {cell.kind} {cell.global_batch}x"
              f"{cell.seq_len}", abs(want - peak) <= PEAK_TOL * peak
              and flops == fc.get_total_flops()
              and flops == real["hlo"]["per_device_flops"],
              f"peak {want} B traced vs {peak} B allocated "
              f"({want / peak - 1:+.4f}; tracked on the card "
              f"{real['memory_per_device']['peak_live_bytes']} B), FLOPs "
              f"{flops:.6g} traced vs {fc.get_total_flops():.6g} counted, "
              f"{ms:.2f} ms (median of {TOOLS_REPEATS}) against the bound {bound:.3f} ms ({by})")
        rows.append({"kind": cell.kind, "batch": cell.global_batch,
                     "seq": cell.seq_len, "cache_len": cell.cache_len,
                     "traced_peak_bytes": want, "allocated_peak_bytes": peak,
                     "tracked_peak_bytes_on_card":
                         real["memory_per_device"]["peak_live_bytes"],
                     "flops": flops, "counted_flops": fc.get_total_flops(),
                     "ms": ms, "ms_samples": samples, "bound_ms": bound, "bound_by": by,
                     "trace_s": fake["hlo"]["trace_s"]})
    return rows


def check_examples(tmp: str) -> dict:
    """(d): the example twins on the card, each in a temp cwd."""
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for name, run in (
                ("kernel_autotune", lambda: kernel_autotune.main([])),
                ("train_e2e", lambda: train_e2e.main([
                    "--steps", str(E2E_STEPS), "--ckpt-dir",
                    os.path.join(tmp, "e2e")])),
                ("quickstart", lambda: run_argv(quickstart.main,
                                                ["quickstart"]))):
            buf = io.StringIO()
            launches = matmul_cuda.launches
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = run()
            text = buf.getvalue()
            out[name] = {"s": time.perf_counter() - t0,
                         "last": text.strip().splitlines()[-1],
                         "matmul_launches": matmul_cuda.launches - launches}
            ok = {"kernel_autotune": res is True
                  and out[name]["last"].endswith("(OK)")
                  and out[name]["matmul_launches"] > 0,
                  "train_e2e": res is not None and math.isfinite(res),
                  "quickstart": "whole-model mapping" in text}[name]
            check(f"example twin {name}", ok,
                  f"{out[name]['last']!r} in {out[name]['s']:.1f} s, "
                  f"{out[name]['matmul_launches']} matmul kernel launches")
    finally:
        os.chdir(cwd)
    return out


def phase_tools() -> None:
    print("== phase 8: the one-device tools (compression, dry-run and "
          "roofline, example twins)")
    t0 = time.perf_counter()
    cfg = get_config(TOOLS_ARCH)
    rep = {"compression": check_compression(cfg)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tcm-tools-") as tmp:
        rep["dryrun"] = check_dryrun_cells(tmp)
        rep["dryrun_vs_card"] = check_dryrun_vs_card(cfg)
        rep["examples"] = check_examples(tmp)
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  phase 8 took {rep['phase_s']:.1f} s")
    print(json.dumps({"tools": rep}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays IEEE
    phase_environment()
    phase_kernels()
    if FAILURES:
        print(f"phase 2 failed: {FAILURES}", file=sys.stderr)
        return 1
    main_path = phase_main_path()
    if FAILURES:
        print(f"phase 3 failed: {FAILURES}", file=sys.stderr)
        return 1
    phase_service()
    if FAILURES:
        print(f"phase 4 failed: {FAILURES}", file=sys.stderr)
        return 1

    phase_served_model()
    if FAILURES:
        print(f"phase 5 failed: {FAILURES}", file=sys.stderr)
        return 1
    phase_training()
    if FAILURES:
        print(f"phase 6 failed: {FAILURES}", file=sys.stderr)
        return 1

    phase_evidence(get_config("qwen1_5_0_5b"))
    if FAILURES:
        print(f"phase 7 failed: {FAILURES}", file=sys.stderr)
        return 1
    phase_tools()
    if FAILURES:
        print(f"phase 8 failed: {FAILURES}", file=sys.stderr)
        return 1

    print("== phase 9: kernels (times summed over the main path's unique "
          "shapes, each once)")
    src = {"matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:19"),
           "flash_attention": ("src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:21")}
    kernels = []
    for name, n in main_path["launches"].items():
        s = main_path["totals"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": n,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["tb"] >= s["tf"] else "operations",
            "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        print(f"kernels never launched on the main path: {missing}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--resume-check"]:
        resume_check()
        sys.exit(0)
    sys.exit(main())
