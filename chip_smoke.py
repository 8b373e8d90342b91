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
  7b. the mapper's inner search step on the card (``TCM_JIT``:
     ``core.symbolic.CriteriaKernel`` through ``kernels/csrc/criteria.cu``),
     timed as its own phase, over qwen1.5-0.5b's 12 main-path shapes on
     the card's plan arch, GPT-3's Q projection and the fused QK -> AV pair
     on the TPU-v4i preset: (b) each searched serially with the route off
     (every kernel call recorded) and on (after one call that sets the
     route up in this process, timed apart; launch counts reset before,
     read after: the criteria kernel's launches), then the fused pair alone
     with 2 spawned workers off and on (``TCM_JIT=1`` in their
     environment; both pools in one child process, ``mapper_pools``,
     which imports beside the serial runs and (a) and searches after them):
     mapping, energy, latency and EDP equal, every counter equal in the
     serial runs, each worker's launches, no unit retried or run in this
     process, the card's memory with the workers' CUDA contexts up, wall
     times; (a) on every recorded call the kernel on the card equals numpy
     bit for bit (a power past f64's 53 bits is held against numpy with
     the kernel's factors and within an ulp a factor; counted, with the
     exponents seen and the non-integer columns), and its plain version on
     the card equals the kernel on every 4th call; (c) one evaluation of
     the heaviest recorded call's kernel at 3 to 20000 rows: numpy on the
     host, the kernel alone, with its copies, the plain version on the
     card, beside the bound (bytes at 3.35 TB/s, f64 operations at the
     H100's 34 TFLOP/s without tensor cores), the call with its copies
     taken apart (staging, the C entry: copy in, kernel, copy out and the
     driver's share; the Python left), the kernel's device time under
     ``torch.profiler`` against the CUDA events', ``pack``'s time over the
     recorded kernels, the largest description met and its tile plan,
     ptxas's report of the kernel; one JSON line {"mapper_on_card": {...}};
  8. the one-device tools (``repro_torch.distributed``, ``launch.dryrun``,
     ``launch.roofline``, ``examples``; torch ops, the matmul kernel in the
     autotune twin): (a) ``compress_decompress`` over seeded gradients
     shaped like qwen1.5-0.5b's f32 parameters, held against the port's CPU
     run on the embedding and layer 0 (codes, scales, dequantized values),
     timed beside its bytes bound, and ``quantized_psum`` on an NCCL group
     of one against the round trip; (b) the dry-run of qwen1.5-0.5b's
     reference cells (train_4k, prefill_32k, decode_32k) at full width on
     the card, and ``roofline.analyze_cell`` over each with the H100's
     constants (through its CLI, each cell in a child process of its own,
     side by side, read after (d)); (c), after (b), the dry-run of
     phase 6's train step (8 x 1024) and of phase 5's prefill (8 x 1024)
     and one decode step after it, each held
     against the same step run on the card: traced peak within 10% of
     ``torch.cuda.max_memory_allocated``, FLOPs equal to
     ``FlopCounterMode`` over the real run, the step's time (the median of
     5 runs after a warm-up) beside the roofline's bound; (d) the example twins ``kernel_autotune`` (must
     print ``(OK)``), ``train_e2e`` (20 steps) and ``quickstart``; (e)
     the dry-run over the reference's production meshes through its CLI,
     each cell in a child process of its own, side by side: rank 0 of a
     fake group of 256 or 512 ranks, fake tensors on the card, for
     qwen1.5-0.5b's train_4k on the pod mesh (dp), minitron-8b's
     decode_32k on the pod and multipod meshes (tp_fsdp, its 32 layers
     gathered over 'data' and over ('pod', 'data')), mamba2-130m's
     long_500k and recurrentgemma-2b's prefill_32k on the pod mesh
     (tp_fsdp, the recurrent blocks on each rank's channels), and
     recurrentgemma-2b's decode_32k, long_500k and train_4k on the pod
     mesh (its 10 q heads over 'model' 16: each rank attends with its
     slots of the ring, or its rows of every q chunk), each through
     ``roofline.analyze_cell``: no error, 256 or 512 devices, collective
     bytes above 0, the collective term beside compute and memory; the
     last five held against the reference's own compile
     (``MESH_REFERENCE``: FLOPs within 0.8-1.25x, peak at most 2.0x),
     recurrentgemma-2b's prefill_32k by its FLOPs counted as the
     reference counts them (``MESH_AS_REFERENCE``: a second child traces
     it ``--as-reference``, the masked kv blocks and every position's
     logits counted; both readings printed, the peak the port's own)
     (timed as its own phase, "8e", the wait that is left, and by its
     children's wall from their start).  The twelve tracing children trace
     on the host, one process a cell, single-threaded: (b)'s and (e)'s
     as-reference trace start before phase 6 (prefill_32k alone takes
     minutes) and (e)'s others before phase 7;
     all of them have ended before phase 7b (the wait is timed as "wait"),
     so 7b and (c), whose times are host-bound, run beside no tracing.
     JSON lines {"tools": {...}} and
     {"mesh_dryrun": {...}};
  9. the sharded path (``repro_torch.launch.train``/``serve`` over a
     ``torch.distributed`` mesh, ``distributed.sharding``'s DTensor
     layouts; torch ops, no kernel of this repo): one child of
     ``torch.distributed.run --standalone`` with NCCL over every card
     (``--qwen``) runs ``launch.train.main`` on phase 6's bf16 8 x 1024
     for 3 steps in ``--mode dp`` (the reference's mode for this arch),
     ``tp`` and ``tp_fsdp``, and ``launch.serve.main`` on phase 5's 8 x
     1024 + 32 in ``tp`` and ``tp_fsdp``, one after another in the
     process group it joins once; the losses and
     grad norms are held against phase 6's first steps at the bf16
     tolerance, the greedy tokens against phase 5's (equal).  On one card
     the mesh is 1x1 and ``--model-parallel 2`` must fail; with two or
     more, a 2-way run is held the same way, its tokens by the first of
     each sequence (bf16 partial sums are reduced across cards, so later
     tokens may part) and their equal share.  One JSON line {"sharded":
     {...}}: step, prefill and decode ms beside the one-device run's,
     each rank's peak memory.  Then phi3.5-moe at full width and 2 of its
     32 layers, through the library in one child of this script (``--moe
     all`` under ``torch.distributed.run``): bf16 8 x 1024 + 32 served and
     3 steps of 8 x 1024 trained in ``tp_ep`` and ``tp_fsdp`` on the 1x1
     mesh, then one device, the model drawn once, held against the
     one-device run (losses and grad norms at the bf16 tolerance, the
     first token of each sequence equal); one JSON line {"sharded_moe":
     {...}}.  Then the
     other four families at full width (``FAMILIES``: mamba2-130m at 24
     layers and seamless-m4t-medium at 12 + 12 trained in ``dp`` and
     served in ``tp_fsdp``, recurrentgemma-2b at 8 of 26 layers serving 4
     x 4096 + 32 so that its window of 2048 runs the ring, llava-next-34b
     at 2 of 60 layers with 576 patch embeddings before 448 tokens, both
     in ``tp_fsdp``), in one child of this script (``--families``): each
     in its reference modes on the 1x1 mesh, drawn once by
     ``init_sharded``, then one device from the same initial weights, held
     against the one-device run (losses and grad norms at the bf16
     tolerance, every token equal); one JSON line {"sharded_families":
     {...}} with step, prefill and decode ms beside the one-device run's,
     peak memory and the CPU draw's seconds;
  10. one JSON line with each kernel's launches on the main path (phase 3;
     the criteria kernel's in phase 7b's serial searches), error and times
     (the criteria kernel's summed over 7b (c)'s row counts, with numpy's);
  11. the last line: {"ok": true, "device": {...}}.

Needs torch with CUDA, nvcc and one card; it fails without them.
``python3 chip_smoke.py --sharded [PART...]`` runs, of its parts
(``SHARDED_PARTS``: qwen minitron moe hybrid dp vlm kv_group dryrun; all
by default), phase 9's qwen runs alone (over
every card the machine shows), after one-device runs of ``launch.train``
and ``launch.serve`` at phase 6's and phase 5's shapes to hold them
against, then the runs that need 4 cards (``phase_wide``): minitron-8b at
full width trained (3 steps of bf16 8 x 1024) and served (8 x 1024 + 32)
in ``tp_fsdp`` on (2, 2) against ``tp`` on (1, 4), and phi3.5-moe at 4
layers in ``tp_ep`` on (2, 2) against ``tp`` on (1, 4), with each rank's
peak memory and step times; one JSON line {"sharded_wide": {...}}; then
``phase_wide_families``: recurrentgemma-2b at full width and depth
trained and served in ``tp_fsdp`` on (2, 2) against ``tp`` on (1, 4),
llava-next-34b served at full width and depth the same two ways, and
mamba2-130m and seamless-m4t-medium trained in ``dp`` on (4, 1) against
one card (llava-next-34b drawn once per layout and served in f32, where
every first token must equal the baseline's, then in bf16, where a first
token may part only where the top-1 minus top-2 logit gap is within
twice the layouts' max |diff| of the first logits); one JSON line
{"sharded_wide_families": {...}}.  To run only that part: ``python3 -c
'import chip_smoke as c, sys; c.phase_wide_families(); sys.exit(1 if
c.FAILURES else 0)'``.  Then ``phase_kv_group``: llava-next-34b at full
width and 2 of its 60 layers with its heads cut to 14 q and 2 kv heads
(groups of 7, as its 56 and 8; no config has 2 kv heads at full width),
so that over 'model' 4 each kv head goes to 2 ranks, trained 3 steps and
served in ``tp_fsdp`` on (1, 4) against the same config on one card
(losses and grad norms at the bf16 tolerance, first tokens by the bf16
gap rule); one JSON line {"sharded_kv_group": {...}}.  Last,
``phase_mesh_dryrun_vs_card``: rank 0's
fake trace (the dry-run over a fake group of 4) of phase 9's qwen train
step in tp_fsdp on (2, 2) and tp on (1, 4), held against the same
counters over the real step on rank 0 of 4 cards (FLOPs and each kind's
collective bytes equal, the traced peak within 10% of
``torch.cuda.max_memory_allocated``); one JSON line {"dryrun_vs_cards":
[...]}.
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
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.autotile import (kernel_takes,  # noqa: E402
                                       plan_arch, plan_einsum,
                                       plan_from_mapping, tcm_matmul_plan)
from repro_torch.core import symbolic, tcm_map  # noqa: E402
from repro_torch.core.einsum import batched_matmul  # noqa: E402
from repro_torch.core.fusion import FusedWorkload, GroupEdge  # noqa: E402
from repro_torch.core.mapper import tcm_map_group  # noqa: E402
from repro_torch.core.presets import gpt3_einsums, tpu_v4i_like  # noqa
from repro_torch.core.search import (ProcessPoolEngine,  # noqa: E402
                                     clear_search_caches)
from repro_torch.kernels import build, criteria  # noqa: E402
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
                                       make_inputs, trace_step)
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
                                     init_opt_state, opt_state_specs)
from repro_torch.serving.engine import (make_serve_steps,  # noqa: E402
                                        place_cache)
from repro_torch.training.step import (init, init_sharded,  # noqa: E402
                                       make_train_step)
from repro_torch.launch.mesh import (Mesh, init_distributed,  # noqa
                                     is_main, per_rank, run_launched)
from repro_torch.models.weights import cast_for_compute  # noqa: E402
from repro_torch.distributed.sharding import distribute  # noqa: E402

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


def phase_served_model() -> dict:
    """Phase 5; returns the bf16 serve's report, its tokens included."""
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
    return rep


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


def phase_training() -> dict:
    """Phase 6; returns its report (``run``: the first training run's)."""
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
    return rep


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


# the mapper's inner search step on the card (phase 7b): the search workers
# of (b)'s process pool; the row counts of (c)'s one evaluation (fig8's n
# is 20000, benchmarks/fig8_model_speed.py:81); the H100 SXM datasheet's
# FP64 rate without tensor cores (no matrix product here)
MAPPER_WORKERS = 2
MAPPER_POOLED = "qk+av fused tpu_v4i"  # the pools' workload (the most calls)
PLAIN_EVERY = 4  # (a) holds the plain version on every 4th recorded call
CRITERIA_ROWS = (3, 89, 256, 1024, 15298, 20000)
PEAK_F64_FLOPS = 34e12


def mapper_workloads() -> list:
    """(label, search) of phase 7b: qwen1.5-0.5b's 12 unique main-path
    shapes on the card's plan arch (as phase 7 builds them), GPT-3's Q
    projection and ``tests/test_fusion.py``'s fused QK -> AV pair on the
    TPU-v4i preset.  ``search(engine)`` returns (result, stats) pairs.
    GPT-3's K and V are cut for time: ``gpt3_einsums`` gives them Q's shape,
    so their searches meet the same kernels and columns as Q's."""
    cfg = get_config("qwen1_5_0_5b")
    shapes = list(dict.fromkeys(
        shp for mode, batch, seq in RUNS
        for shp in model_shapes(cfg, mode, batch, seq).values()))
    arch, tpu, gpt3 = plan_arch(), tpu_v4i_like(), gpt3_einsums()
    pair = FusedWorkload("qk+av", (batched_matmul("qk", 8, 4, 32, 64),
                                   batched_matmul("av", 8, 4, 64, 32)),
                         (GroupEdge(0, 1, "Z", "A"),))
    return [
        ("qwen1.5-0.5b x12 plan_arch",
         lambda eng: [tcm_map(plan_einsum(*s), arch, engine=eng)
                      for s in shapes]),
        ("gpt3 Q tpu_v4i", lambda eng: [tcm_map(gpt3["Q"], tpu, engine=eng)]),
        ("qk+av fused tpu_v4i",
         lambda eng: [tcm_map_group(pair, tpu, engine=eng)]),
    ]


def searched(results) -> list:
    """What the route may not change: the rendered mapping, energy,
    latency, EDP and every ``MapperStats`` counter (not the timings)."""
    return [(repr(r.mapping), r.energy, r.latency, r.edp,
             {k: v for k, v in vars(st).items() if not k.startswith("t_")})
            for r, st in results]


def _exact_product(a, b):
    """Where a * b is exact in f64 (Dekker's product: the rounding error of
    a * b, itself exact, is zero)."""
    def split(x):
        t = 134217729.0 * x  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl == 0


def inexact_powers(kernel, cols) -> int:
    """(row, factor) entries where numpy's power may not be the kernel's:
    a power of 3 or more (numpy's libm ``pow``, the kernel's repeated
    products) whose products round, and every power below -1 (libm's
    ``pow`` against one over the product)."""
    n = 0
    for ci, e in kernel._factors:
        if e <= -2:
            n += cols.shape[0]
        elif e >= 3:
            x = cols[:, ci]
            p, ok = x, np.ones(len(x), dtype=bool)
            for _ in range(e - 1):
                ok &= _exact_product(p, x)
                p = p * x
            n += int((~ok).sum())
    return n


def numpy_with_products(kernel, cols) -> np.ndarray:
    """numpy's packed evaluation (``CriteriaKernel.__call__``) with each
    factor taken as the kernel takes it (``criteria.power``): where a power
    rounds, the kernel must still equal this bit for bit."""
    nf = len(kernel._factors)
    F = np.empty((nf + 1, cols.shape[0]))
    for f, (ci, e) in enumerate(kernel._factors):
        F[f] = criteria.power(torch.from_numpy(cols[:, ci]), e).numpy()
    F[nf] = 1.0
    T = kernel._coeff_flat[:, None] * F[kernel._fid0]
    for cut, fids in kernel._slots:
        T[cut:] *= F[fids]
    outT = np.zeros((kernel.n_crits, cols.shape[0]))
    for nt, js, idx in kernel._acc_groups:
        if nt:
            acc = T[idx[:, 0]]
            for t in range(1, nt):
                acc += T[idx[:, t]]
            outT[js] = acc
    return outT.T


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def launch_report(wait_s: float) -> tuple:
    """(this process's id, its criteria kernel launches) after ``wait_s``
    seconds: asked of each worker of a pool (a spawned worker imports this
    module by name), the wait keeping the first ones busy so that each
    worker takes one."""
    time.sleep(wait_s)
    return os.getpid(), criteria.criteria_cuda.launches


def mapper_pool(jit: bool, workloads) -> dict:
    """(b) with ``MAPPER_WORKERS`` spawned workers, the route on or off by
    ``TCM_JIT`` (a worker reads it when it imports the mapper): the
    results, the wall time (the workers' start included), the engine's
    fault counts, and with the route on each worker's launches and the
    card's memory beside the workers' CUDA contexts; ``report_s`` and
    ``close_s``, the seconds of that report and of closing the pool."""
    def used() -> int:
        free, total = torch.cuda.mem_get_info()
        return total - free

    base = used()
    if jit:
        os.environ["TCM_JIT"] = "1"
    eng = ProcessPoolEngine(workers=MAPPER_WORKERS, start_method="spawn")
    try:
        t0 = time.perf_counter()
        out = {"results": {label: searched(run(eng))
                           for label, run in workloads}}
        out["wall_s"] = time.perf_counter() - t0
        out["fault_stats"] = dict(eng.fault_stats)
        if jit:
            ex = eng._get_executor()
            reports = [f.result() for f in [
                ex.submit(launch_report, 0.5)
                for _ in range(MAPPER_WORKERS)]]
            out["worker_launches"] = dict(reports)
            out["card_used_bytes"] = {"before": base, "workers_up": used()}
            out["compute_apps"] = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()
        out["report_s"] = time.perf_counter() - t0 - out["wall_s"]
    finally:
        t1 = time.perf_counter()
        eng.close()
        os.environ.pop("TCM_JIT", None)
    out["close_s"] = time.perf_counter() - t1
    return out


def mapper_pools(launched: float) -> dict:
    """(b)'s pooled runs of ``MAPPER_POOLED``, route off then on, in a child
    process of their own (``python3 -c 'import chip_smoke as c; ...
    c.mapper_pools()'``): its main module has no file for spawned workers
    to import again, and it holds none of the earlier phases' memory (with
    the pools run from the whole script they took 18.9 and 20.9 s on an
    H100's host, after phase 1 alone 4.7 and 15.4 s).  ``launched``, the
    parent's ``time.time()`` when it started the child, gives ``start_s``,
    the child's start and imports; the child then waits for the parent's
    ``go`` line on its standard input (``go_s``; it exits on anything
    else).  JSON-ready: tuples come back as lists."""
    out = {"start_s": time.time() - launched}
    if sys.stdin.readline() != "go\n":
        sys.exit(1)
    out["go_s"] = time.time() - launched - out["start_s"]
    workloads = [w for w in mapper_workloads() if w[0] == MAPPER_POOLED]
    out.update({str(jit): mapper_pool(jit, workloads)
                for jit in (False, True)})
    out["done_at"] = time.time()
    return out


def criteria_split(c, cols, us) -> dict:
    """One ``criteria.evaluate`` call of ``cols`` taken apart, in us: the
    columns copied into this thread's pinned staging (host clock), the C
    entry alone (``tcm_criteria_eval``, host clock: the copies, the launch
    and the sync), within it the copy in and the copy out on the same
    pinned buffers (CUDA events) and the kernel (``us["kernel"]``, CUDA
    events), the driver's calls and waits left in the entry, and the Python
    left in ``us["with_copies"]`` (the call's own, host clock)."""
    cpu, dev = torch.device("cpu"), c.device
    n, n_syms = cols.shape
    d = c.desc.nbytes
    n_in, n_out = d + 8 * n * n_syms, 8 * n * c.n_crits
    criteria.evaluate(c, cols)  # the buffers sized, the description in
    st = criteria.staging(dev)
    view = st.host_in_f64[d // 8:n_in // 8].reshape(n, n_syms)
    host_in, dev_in, dev_out, host_out = st.ptrs
    lib = build.lib()
    rows, threads, _ = criteria.tile_plan(c, n, n_syms)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entry():
        build.check(lib.tcm_criteria_eval(
            dev.index, host_in, dev_in, n_in, d, c.n_factors, c.n_terms,
            c.n_crits, n, n_syms, rows.bit_length() - 1, threads, dev_out,
            host_out, stream), "entry")

    out = {"staging": time_call(lambda: np.copyto(view, cols), cpu),
           "entry": time_call(entry, cpu),
           "h2d": time_call(lambda: st.dev_in[:n_in].copy_(
               st.host_in[:n_in], non_blocking=True), dev),
           "d2h": time_call(lambda: st.host_out[:n_out].copy_(
               st.dev_out[:n_out], non_blocking=True), dev)}
    out = {k: v * 1e6 for k, v in out.items()}
    out["kernel"] = us["kernel"]
    out["driver"] = out["entry"] - out["h2d"] - out["kernel"] - out["d2h"]
    out["python"] = us["with_copies"] - out["staging"] - out["entry"]
    return out


def criteria_profiled(c, cols, dev) -> dict:
    """The criteria kernel under ``torch.profiler``: 10 launches at each of
    ``CRITERIA_ROWS`` (in that order), the median device time of each
    count's launches in us, by the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xs = [torch.from_numpy(np.ascontiguousarray(
        cols[np.arange(n) % len(cols)])).to(dev) for n in CRITERIA_ROWS]
    for x in xs:
        criteria.criteria_cuda(c, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs:
            for _ in range(10):
                criteria.criteria_cuda(c, x)
            torch.cuda.synchronize()
    ks = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "criteria_kernel" in e.name),
                key=lambda e: e.time_range.start)
    us = [statistics.median(e.time_range.elapsed_us()
                            for e in ks[10 * i:10 * i + 10])
          if len(ks) >= 10 * i + 10 else None
          for i in range(len(CRITERIA_ROWS))]
    return {"kernels": len(ks), "names": sorted({e.name for e in ks}),
            "us": us}


def phase_mapper_on_card() -> dict:
    """Phase 7b.  The pools' child (``mapper_pools``) starts first and
    imports while (b)'s serial searches and (a) run here; it searches once
    they are done, and (c) runs after it has ended."""
    print("== phase 7b: the mapper's inner search step on the card "
          "(TCM_JIT: CriteriaKernel through csrc/criteria.cu)")
    launched = time.time()
    child = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as c; "
         f"print(json.dumps(c.mapper_pools({launched!r})))"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        return mapper_on_card(child, launched)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()


def mapper_on_card(child, launched: float) -> dict:
    dev = torch.device("cuda")
    workloads = mapper_workloads()
    rep = {"workloads": [label for label, _ in workloads]}

    # (b) serial: the route off (every kernel call recorded for (a)), on
    pairs = []
    numpy_call = symbolic.CriteriaKernel.__call__

    def record(self, cols):
        out = numpy_call(self, cols)
        pairs.append((self, cols.copy(), out))
        return out

    off, on, wall = {}, {}, {}
    symbolic.CriteriaKernel.__call__ = record
    try:
        for label, run in workloads:
            t0, before = time.perf_counter(), len(pairs)
            off[label] = searched(run(None))
            wall[label] = {"off_s": time.perf_counter() - t0,
                           "calls": len(pairs) - before}
    finally:
        symbolic.CriteriaKernel.__call__ = numpy_call
    # the route's set-up in this process (the thread's pinned buffers, the
    # kernel's first launch), timed apart from the searches
    t0 = time.perf_counter()
    criteria.evaluate(criteria.pack(pairs[0][0], "cuda"), pairs[0][1])
    first_call_s = time.perf_counter() - t0
    criteria.criteria_cuda.launches = 0
    try:
        symbolic.set_jit(True)
        for label, run in workloads:
            t0 = time.perf_counter()
            on[label] = searched(run(None))
            wall[label]["on_s"] = time.perf_counter() - t0
    finally:
        symbolic.set_jit(False)
    torch.cuda.synchronize()
    launches = criteria.criteria_cuda.launches
    for label, _ in workloads:
        check(f"search {label}, route on == off (serial)",
              on[label] == off[label],
              f"{len(off[label])} searches, n_expanded "
              f"{sum(r[4]['n_expanded'] for r in off[label])}, "
              f"{wall[label]['calls']} kernel calls; wall off "
              f"{wall[label]['off_s']:.2f} s (with the recording's copies), "
              f"on {wall[label]['on_s']:.2f} s")
    with_rows = sum(1 for k, cols, _ in pairs if cols.shape[0] and k.n_crits)
    check("criteria kernel launched once a serial call with rows",
          launches == with_rows > 0,
          f"{launches} launches for {len(pairs)} kernel calls ({with_rows} "
          f"with rows); the route's first call in this process "
          f"{first_call_s * 1e3:.2f} ms")
    rep["serial"] = {"wall_s": wall, "launches": launches,
                     "calls": len(pairs), "first_call_s": first_call_s}

    # (a) every recorded call: the kernel on the card against numpy, bit
    # for bit (a power that rounds: against numpy with the kernel's
    # factors, each factor within an ulp of numpy's), and on every
    # PLAIN_EVERY-th call the plain version on the card against the kernel
    t0 = time.perf_counter()
    descs, exps = {}, Counter()
    n_inexact = n_nonint = n_values = n_plain = 0
    err, bad = 0.0, []
    for i, (kernel, cols, want) in enumerate(pairs):
        if id(kernel) not in descs:
            descs[id(kernel)] = criteria.pack(kernel, "cuda")
            exps.update(e for _, e in kernel._factors)
        c = descs[id(kernel)]
        x = torch.from_numpy(cols).to(dev)
        got = criteria.criteria_cuda(c, x).cpu().numpy()
        n_nonint += int((cols != np.floor(cols)).any(axis=0).sum())
        n_values += cols.size
        inexact = inexact_powers(kernel, cols)
        n_inexact += inexact
        ref = numpy_with_products(kernel, cols) if inexact else want
        ok = np.array_equal(bits(got), bits(ref))
        if i % PLAIN_EVERY == 0:
            plain = criteria.criteria_plain(c, x).cpu().numpy()
            n_plain += 1
            if got.size:
                err = max(err, float(np.abs(got - plain).max()))
            ok &= np.array_equal(bits(got), bits(plain))
        if inexact:
            for ci, e in kernel._factors:
                col = cols[:, ci]
                ok &= bool((np.abs(col ** e - criteria.power(
                    torch.from_numpy(col), e).numpy())
                    <= np.spacing(np.abs(col ** e))).all())
        if not ok:
            bad.append((cols.shape, kernel.n_crits))
    torch.cuda.synchronize()
    check(f"criteria kernel == numpy on every recorded call ({len(pairs)} "
          f"calls, {len(descs)} kernels), plain version == kernel on "
          f"{n_plain} of them", not bad,
          f"exponents {dict(sorted(exps.items()))}, powers past f64's 53 "
          f"bits {n_inexact}, non-integer columns {n_nonint} of "
          f"{n_values} values, max|kernel - plain| {err}, "
          f"{time.perf_counter() - t0:.1f} s"
          + (f"; differ at {bad[:5]}" if bad else ""))
    rep["checked"] = {"calls": len(pairs), "kernels": len(descs),
                      "plain_calls": n_plain,
                      "values": n_values,
                      "exponents": {str(e): k for e, k in exps.items()},
                      "inexact_powers": n_inexact,
                      "non_integer_columns": n_nonint,
                      "max_abs_err": err, "differ": len(bad)}

    # (b) with workers, on MAPPER_POOLED alone (the others are cut for
    # time): the route off, then on.  The workers share their incumbents,
    # so when one sees another's bound decides what it prunes: the counters
    # of two pooled runs differ with the route off alone, and these runs
    # are held by their optima
    stdout, stderr = child.communicate("go\n", timeout=600)
    child_s = time.time() - launched
    if child.returncode:
        check("the pooled searches' child process", False,
              f"rc {child.returncode} in {child_s:.1f} s: {stderr[-2000:]}")
        return rep
    res = json.loads(stdout.splitlines()[-1])
    pools = {jit: res[str(jit)] for jit in (False, True)}
    split = {"start": res["start_s"], "go": res["go_s"],
             **{f"{k}_{s}": pools[jit][f"{s}_s"]
                for k, jit in (("off", False), ("on", True))
                for s in ("wall", "report", "close")},
             "exit": time.time() - res["done_at"]}
    check("the pooled searches' child process", True,
          f"rc 0 in {child_s:.1f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " s")
    for label in pools[True]["results"]:
        got = [r[:4] for r in pools[True]["results"][label]]
        check(f"search {label}, route on == off ({MAPPER_WORKERS} workers)",
              got == [r[:4] for r in pools[False]["results"][label]]
              and [r[1:] for r in got] == [list(r[1:4]) for r in off[label]],
              "mapping, energy, latency and EDP equal; energy, latency and "
              "EDP equal the serial search's")
    wl = pools[True]["worker_launches"]
    faults = [p["fault_stats"] for p in pools.values()]
    check("criteria kernel launched in the workers, no unit retried or run "
          "in this process", sum(wl.values()) > 0
          and not any(v for f in faults for v in f.values()),
          f"launches by worker pid {wl}; fault stats off/on {faults}; "
          f"card memory used "
          f"{pools[True]['card_used_bytes']}, compute apps "
          f"{pools[True]['compute_apps']}; wall off "
          f"{pools[False]['wall_s']:.2f} s, on {pools[True]['wall_s']:.2f} s")
    rep["workers"] = {"n": MAPPER_WORKERS, "workload": MAPPER_POOLED,
                      "child_s": child_s, "child_split_s": split,
                      "wall_s": {"off": pools[False]["wall_s"],
                                 "on": pools[True]["wall_s"]},
                      "worker_launches": wl,
                      "card_used_bytes": pools[True]["card_used_bytes"],
                      "compute_apps": pools[True]["compute_apps"]}

    # (c) one evaluation of the heaviest recorded call's kernel (rows times
    # f64 operations a row), its rows repeated to each count: the kernel
    # alone, one call with its copies taken apart, the profiler's view of
    # the kernel; then pack's cost over the recorded kernels, the largest
    # description met and its tiles, ptxas's report
    kernel, cols, _ = max(pairs, key=lambda p: (
        p[1].shape[0] * descs[id(p[0])].ops_per_row))
    c = descs[id(kernel)]
    cpu, rows = torch.device("cpu"), []
    for n in CRITERIA_ROWS:
        cn = np.ascontiguousarray(cols[np.arange(n) % len(cols)])
        x = torch.from_numpy(cn).to(dev)
        us = {"numpy": time_call(lambda: kernel(cn), cpu),
              "kernel": time_call(lambda: criteria.criteria_cuda(c, x), dev),
              "with_copies": time_call(lambda: criteria.evaluate(c, cn), cpu),
              "plain": time_call(lambda: criteria.criteria_plain(c, x), dev)}
        us = {k: v * 1e6 for k, v in us.items()}
        split = criteria_split(c, cn, us)
        nbytes = 8 * n * (cn.shape[1] + c.n_crits)
        tb, tf = nbytes / PEAK_BYTES_S, c.ops_per_row * n / PEAK_F64_FLOPS
        rows.append({"rows": n, **{f"{k}_us": v for k, v in us.items()},
                     "tile": criteria.tile_plan(c, n, cn.shape[1]),
                     "split_us": split,
                     "bound_us": max(tb, tf) * 1e6,
                     "bound_by": "bytes" if tb >= tf else "operations",
                     "tb": tb, "tf": tf})
        print(f"  {n} rows x {cn.shape[1]} columns -> {c.n_crits} criteria "
              f"(R, threads, shared memory B {rows[-1]['tile']}): "
              + ", ".join(f"{k} {v:.2f} us" for k, v in us.items())
              + f"; bound {max(tb, tf) * 1e6:.4f} us "
              f"({rows[-1]['bound_by']}); the call: "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " us")
    # a measurement, not a check: inside the whole script the profiler has
    # traced only some of the launches (26 of 60 on an H100)
    profiled = criteria_profiled(c, cols, dev)
    print(f"  the kernel under torch.profiler: {profiled['kernels']} of "
          f"{10 * len(CRITERIA_ROWS)} launches traced ({profiled['names']}); "
          "median device us by rows "
          + ", ".join(f"{n}: {profiled['us'][i]} (events "
                      f"{r['kernel_us']})"
                      for i, (n, r) in enumerate(zip(CRITERIA_ROWS, rows))))
    pack_us = []
    for k in {id(p[0]): p[0] for p in pairs}.values():
        t0 = time.perf_counter()
        criteria.pack(k, "cuda")
        pack_us.append((time.perf_counter() - t0) * 1e6)
    big = max(descs.values(), key=lambda d: d.desc.nbytes)
    ptxas = [ln for ln in build.ptxas_summary(build.ptxas_log)
             if ln.startswith("criteria_kernel")]
    plans = {n: criteria.tile_plan(big, n, big.n_cols) for n in CRITERIA_ROWS}
    print(f"  pack over {len(pack_us)} kernels: median "
          f"{statistics.median(pack_us):.1f} us, mean "
          f"{statistics.fmean(pack_us):.1f} us; largest description "
          f"{big.desc.nbytes} B ({big.n_terms} terms, {big.n_factors} "
          f"factors, {big.n_crits} criteria, {big.n_cols} columns), (R, "
          f"threads, shared memory B) by rows {plans}; ptxas: "
          f"{ptxas or 'no build log'}")
    rep["cost"] = [{k: v for k, v in r.items() if k not in ("tb", "tf")}
                   for r in rows]
    rep["profiled_kernel_us"] = profiled["us"]
    rep["pack_us"] = {"kernels": len(pack_us),
                      "median": statistics.median(pack_us),
                      "mean": statistics.fmean(pack_us)}
    rep["largest_description"] = {
        "bytes": big.desc.nbytes, "terms": big.n_terms,
        "factors": big.n_factors, "criteria": big.n_crits,
        "columns": big.n_cols,
        "tiles": {str(n): list(p) for n, p in plans.items()}}
    rep["ptxas"] = ptxas
    tb, tf = sum(r["tb"] for r in rows), sum(r["tf"] for r in rows)
    rep["kernel"] = {
        "name": "criteria", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/criteria.cu",
        "replaces": "src/repro/core/symbolic.py:482", "launches": launches,
        "max_abs_err": err,
        "ms": sum(r["kernel_us"] for r in rows) / 1e3,
        "plain_ms": sum(r["plain_us"] for r in rows) / 1e3,
        "bound_ms": sum(r["bound_us"] for r in rows) / 1e3,
        "bound_by": "bytes" if tb >= tf else "operations",
        "library_ms": None,
        "numpy_ms": sum(r["numpy_us"] for r in rows) / 1e3,
        "with_copies_ms": sum(r["with_copies_us"] for r in rows) / 1e3}
    print(json.dumps({"mapper_on_card": rep}))
    return rep


# the one-device tools (phase 8): compression over a tree shaped like
# qwen1.5-0.5b's f32 parameters; the model's reference dry-run cells; the
# dry-run held against the steps on the card (phase 6's train step, phase
# 5's prefill and one decode step after it); the example twins
TOOLS_ARCH = "qwen1.5-0.5b"
TOOLS_CELLS = ("train_4k", "prefill_32k", "decode_32k")
TOOLS_STEPS = [Cell("train", 8, 1024), Cell("prefill", 8, 1024, 1056),
               Cell("decode", 8, 1025, 1056)]
TOOLS_REPEATS = 5  # timed runs of each held step, after a warm-up
TOOLS_DRYRUN_TIMEOUT_S = 600  # (b)'s children, from the start of a wait
PEAK_TOL = 0.10  # dry-run peak against torch.cuda.max_memory_allocated
E2E_STEPS = 20  # train_e2e's 300 steps, cut for time
# (e): the dry-run over the reference's production meshes, rank 0 of 256
# or 512: qwen's train_4k in dp (one row a rank) and minitron-8b's
# decode_32k in tp_fsdp, its 32 layers split over data 16 and over
# ('pod', 'data') 32; the recurrent blocks over a model-split mesh:
# mamba2-130m's long_500k (one row: 'embed' contracted over 'data') and
# recurrentgemma-2b's prefill_32k (the RG-LRU on each rank's channels),
# both tp_fsdp on pod; and recurrentgemma-2b's decode_32k, long_500k and
# train_4k on pod, whose 10 q heads cannot go to 'model' 16: a decode step
# attends with each rank's slots of the ring, a train step with each
# rank's rows of every q chunk (phi3.5-moe's prefill_32k and the 34B
# train cells are left out: their traces alone take minutes)
MESH_CELLS = (("qwen1.5-0.5b", "train_4k", "pod"),
              ("minitron-8b", "decode_32k", "pod"),
              ("minitron-8b", "decode_32k", "multipod"),
              ("mamba2-130m", "long_500k", "pod"),
              ("recurrentgemma-2b", "prefill_32k", "pod"),
              ("recurrentgemma-2b", "decode_32k", "pod"),
              ("recurrentgemma-2b", "long_500k", "pod"),
              ("recurrentgemma-2b", "train_4k", "pod"))
MESH_DRYRUN_TIMEOUT_S = 300
# the reference's rank 0 in the cells held against it: (hlo.per_device_
# flops, memory_per_device.peak_live_bytes) of its own compile on a host
# CPU, ``PYTHONPATH=src python -m repro.launch.dryrun --arch A --shape S
# --mesh pod`` (jax 0.9.0); a cell is held when the port's FLOPs are
# within MESH_FLOPS_BOUNDS of these and its peak at most MESH_PEAK_BOUND
# times (``tests/dryrun_sweep_compare.py``'s bounds)
MESH_REFERENCE = {
    ("mamba2-130m", "long_500k", "pod"): (5627136.0, 16909736),
    ("recurrentgemma-2b", "prefill_32k", "pod"): (33738478059520.0,
                                                  7168983388),
    ("recurrentgemma-2b", "decode_32k", "pod"): (2944061440.0, 432130420),
    ("recurrentgemma-2b", "long_500k", "pod"): (102586880.0, 156925400),
    ("recurrentgemma-2b", "train_4k", "pod"): (90177536000000.0,
                                               25713649428),
}
MESH_FLOPS_BOUNDS = (0.8, 1.25)
MESH_PEAK_BOUND = 2.0
# the held cells whose FLOPs are held as the reference counts them: traced
# a second time ``--as-reference`` (``launch.dryrun.as_reference``: the
# attention's masked kv blocks and a prefill's every logit, which the
# reference computes and the port skips), the peak held on the port's own
# trace.  A prefill's raw count can hide a rank's repeated attention:
# recurrentgemma-2b's read 0.910x raw while each of its 16 'model' ranks
# ran all 10 heads over every row (5.888x counted so)
MESH_AS_REFERENCE = (("recurrentgemma-2b", "prefill_32k", "pod"),)


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


def dryrun_child(tmp: str, arch: str, shape: str, mesh: str,
                 *extra: str):
    """The dry-run's CLI for one cell in a child process of its own, its
    JSON and its log (``<arch>__<shape>__<mesh>.log``) in ``tmp``, with
    the CLI's ``extra`` arguments: one process traces one cell (the fake
    replay is host-bound and single-threaded; prefill_32k alone takes
    minutes)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    os.makedirs(tmp, exist_ok=True)
    with open(Path(tmp) / f"{arch}__{shape}__{mesh}.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", tmp, *extra],
            cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)


def settle(procs: list, timeout_s: float) -> None:
    """Wait for ``procs`` to end; kill those still running ``timeout_s``
    seconds from now."""
    end = time.perf_counter() + timeout_s
    for proc in procs:
        try:
            proc.wait(timeout=max(end - time.perf_counter(), 0.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def child_result(tmp: str, arch: str, shape: str, mesh: str, proc) -> dict:
    """A cell's JSON, or its child's exit code and the end of its log."""
    path = Path(tmp) / f"{arch}__{shape}__{mesh}.json"
    if path.exists():
        return json.loads(path.read_text())
    log = (Path(tmp) / f"{arch}__{shape}__{mesh}.log").read_text()
    return {"error": f"exit {proc.returncode}: {log[-1500:]}"}


def start_dryrun_cells(tmp: str) -> list:
    """(b), started: the reference's dry-run cells of the model on the
    card, side by side, each in its own ``dryrun_child``.  Not beside (c)
    or phase 7b, whose times they would slow (the decode step, host-bound,
    took 122.61 against 68.16 ms beside them on an H100's host)."""
    return [(shape, time.perf_counter(),
             dryrun_child(tmp, TOOLS_ARCH, shape, "one"))
            for shape in TOOLS_CELLS]


def check_dryrun_cells(tmp: str, procs: list) -> list:
    """(b), read: each cell's JSON, checked, and the roofline over it with
    the H100's constants."""
    settle([proc for *_, proc in procs], TOOLS_DRYRUN_TIMEOUT_S)
    rows = []
    for shape, t0, proc in procs:
        path = Path(tmp) / f"{TOOLS_ARCH}__{shape}__one.json"
        res = child_result(tmp, TOOLS_ARCH, shape, "one", proc)
        if "error" in res:
            check(f"dry-run {TOOLS_ARCH} {shape}", False, res["error"])
            rows.append({"shape": shape, "dryrun": res})
            continue
        roof = analyze_cell(path)
        mem = res["memory_per_device"]
        check(f"dry-run {TOOLS_ARCH} {shape}", res["n_devices"] == 1
              and res["hlo"]["per_device_flops"] > 0
              and res["hlo"]["total_collective_bytes"] == 0,
              f"traced layers {res['traced_layers']} in "
              f"{res['hlo']['trace_s']} s, {res['hlo']['ops']} ops, "
              f"{res['hlo']['per_device_flops']:.4g} FLOPs, peak "
              f"{mem['peak_live_bytes'] / 2**30:.2f} GiB; roofline "
              f"compute {roof['compute_s']:.4g} s, memory "
              f"{roof['memory_s']:.4g} s ({roof['dominant']}), useful "
              f"FLOP ratio {roof['useful_ratio']:.3f}")
        rows.append({"shape": shape, "dryrun": res, "roofline": roof,
                     "child_s": time.perf_counter() - t0})
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


def as_reference_dir(tmp: str) -> str:
    """Where (e)'s cells traced ``--as-reference`` write their JSONs."""
    return os.path.join(tmp, "as_reference")


def start_as_reference(tmp: str) -> list:
    """(e)'s cells of ``MESH_AS_REFERENCE``, started: each traced
    ``--as-reference`` in its own ``dryrun_child`` (every kv block of a
    32k prefill: minutes, so ``main`` starts them beside (b)'s)."""
    return [dryrun_child(as_reference_dir(tmp), *cell, "--as-reference")
            for cell in MESH_AS_REFERENCE]


def start_mesh_dryrun(tmp: str, as_ref=None) -> tuple:
    """(e), started: ``MESH_CELLS``, each as rank 0 of the reference's 256-
    or 512-device mesh over a fake group, fake tensors on the card, side by
    side, each in its own ``dryrun_child``, and ``start_as_reference``'s
    children, unless ``as_ref`` holds them already.  (start time, [(arch,
    shape, mesh, process)], [the as-reference processes])."""
    return time.perf_counter(), [
        (arch, shape, mesh, dryrun_child(tmp, arch, shape, mesh))
        for arch, shape, mesh in MESH_CELLS], (
        start_as_reference(tmp) if as_ref is None else as_ref)


def check_mesh_dryrun(tmp: str, started: tuple) -> dict:
    """(e), read: each cell through ``roofline.analyze_cell``; ``wall_s``
    from the children's start to their reading (each cell's own trace
    seconds are in its ``hlo``)."""
    t0, procs, as_ref = started
    settle([proc for *_, proc in procs] + as_ref, MESH_DRYRUN_TIMEOUT_S)
    as_ref = dict(zip(MESH_AS_REFERENCE, as_ref))
    rows = []
    for arch, shape, mesh, proc in procs:
        path = Path(tmp) / f"{arch}__{shape}__{mesh}.json"
        res = child_result(tmp, arch, shape, mesh, proc)
        n = {"pod": 256, "multipod": 512}[mesh]
        ok = ("error" not in res and res["n_devices"] == n
              and res["hlo"]["total_collective_bytes"] > 0)
        if not ok:
            check(f"dry-run {arch} {shape} on {mesh}", False,
                  res.get("error", json.dumps(res.get("hlo"))))
            rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "dryrun": res})
            continue
        roof = analyze_cell(path)
        mem = res["memory_per_device"]
        check(f"dry-run {arch} {shape} on {res['mesh']} ({n} devices, "
              f"mode {res['mode']})", True,
              f"traced layers {res['traced_layers']} in "
              f"{res['hlo']['trace_s']} s, {res['hlo']['ops']} ops; per "
              f"device: {res['hlo']['per_device_flops']:.6g} FLOPs, peak "
              f"{mem['peak_live_bytes']} B, collective bytes "
              f"{res['hlo']['collective_bytes']}; roofline compute "
              f"{roof['compute_s']:.4g} s, memory {roof['memory_s']:.4g} s, "
              f"collective {roof['collective_s']:.4g} s "
              f"({roof['dominant']})")
        row = {"arch": arch, "shape": shape, "mesh": mesh, "dryrun": res,
               "roofline": roof}
        if (arch, shape, mesh) in MESH_REFERENCE:
            ref_flops, ref_peak = MESH_REFERENCE[arch, shape, mesh]
            row["flops_ratio"] = res["hlo"]["per_device_flops"] / ref_flops
            row["peak_ratio"] = mem["peak_live_bytes"] / ref_peak
            held, how = row["flops_ratio"], ""
            if (arch, shape, mesh) in as_ref:
                counted = child_result(as_reference_dir(tmp), arch, shape,
                                       mesh, as_ref[arch, shape, mesh])
                row["as_reference"] = counted
                held = row["as_reference_flops_ratio"] = (
                    counted["hlo"]["per_device_flops"] / ref_flops
                    if "error" not in counted else math.nan)
                how = (f"counted as the reference counts "
                       f"(--as-reference) {held:.3f}x, raw "
                       f"{row['flops_ratio']:.3f}x; ")
            lo, hi = MESH_FLOPS_BOUNDS
            check(f"dry-run {arch} {shape} on {mesh} held against the "
                  f"reference's compile",
                  lo <= held <= hi and row["peak_ratio"] <= MESH_PEAK_BOUND,
                  f"FLOPs {how or f'{held:.3f}x '}the reference's "
                  f"{ref_flops:.6g} (bounds {lo}-{hi}), peak "
                  f"{row['peak_ratio']:.3f}x its {ref_peak} B (bound "
                  f"{MESH_PEAK_BOUND})")
        rows.append(row)
    return {"cells": rows, "wall_s": time.perf_counter() - t0}


def phase_mesh_dryrun(started: tuple, tmp: str) -> None:
    """Phase 8(e), timed on its own: ``check_mesh_dryrun`` over the
    children ``started`` in ``tmp`` (by ``main`` before phase 7, so its
    phase time is the wait that is left; alone,
    ``phase_mesh_dryrun(start_mesh_dryrun(d), d)``)."""
    print("== phase 8(e): the dry-run over the reference's production "
          "meshes (rank 0 of 256 and 512)")
    torch.cuda.empty_cache()
    rep = check_mesh_dryrun(tmp, started)
    print(f"  phase 8(e): its children read {rep['wall_s']:.1f} s after "
          f"they started")
    print(json.dumps({"mesh_dryrun": rep}))


def phase_tools(started: list, cells: str) -> None:
    """Phase 8.  (b)'s children, ``started`` in ``cells`` (by ``main``
    before phase 6; alone, ``phase_tools(start_dryrun_cells(d), d)``), are
    read after (d), and (c) runs after them, beside no tracing."""
    print("== phase 8: the one-device tools (compression, dry-run and "
          "roofline, example twins)")
    t0 = time.perf_counter()
    cfg = get_config(TOOLS_ARCH)
    rep = {"compression": check_compression(cfg)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tcm-tools-") as tmp:
        rep["examples"] = check_examples(tmp)
    rep["dryrun"] = check_dryrun_cells(cells, started)
    rep["dryrun_vs_card"] = check_dryrun_vs_card(cfg)
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  phase 8 took {rep['phase_s']:.1f} s")
    print(json.dumps({"tools": rep}))


# the sharded path (phase 9): launch.train and launch.serve as children of
# torch.distributed.run over every card (NCCL), at phase 6's and phase 5's
# shapes; the reference's mode for this arch (dry-run MODE_OVERRIDES) first
SHARDED_TRAIN_STEPS = 3
SHARDED_MODES = ("dp", "tp", "tp_fsdp")
SHARDED_SERVE_MODES = ("tp", "tp_fsdp")
SHARDED_TIMEOUT_S = 300  # each child launch
QWEN_TIMEOUT_S = 600  # the one child of phase 9's qwen runs
# the sharded run against the one-device run on the same card, in bf16:
# the losses within phase 6's bf16 tolerance, the greedy tokens equal (the
# first of each sequence where 'model' > 1; see sharded_serve)
SHARDED_LOSS_RTOL = FA_GRAD_TOL[torch.bfloat16]
QWEN = "qwen1.5-0.5b"
# the MoE over a mesh: phi3.5-moe at full width, cut in depth, through the
# library in children of this script (``--moe``; the launchers take no
# depth): on one card 2 of its 32 layers (~2.86 G parameters, ~46 GB of
# f32 training state) one-device and in MOE_MODES on the 1x1 mesh
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 2
MOE_MODES = ("tp_ep", "tp_fsdp")
# ``--sharded`` on 4 cards: minitron-8b at full width (~9.88 G parameters,
# whose f32 training state one card cannot hold) in tp_fsdp on (2, 2)
# against tp on (1, 4), trained and served; phi3.5-moe at 4 layers in
# tp_ep on (2, 2) against tp on (1, 4).  No checkpoint: the manager
# gathers every leaf whole onto rank 0.
WIDE_ARCH = "minitron-8b"
WIDE_RUNS = (("tp", 4), ("tp_fsdp", 2))  # (mode, 'model'); baseline first
WIDE_MOE_LAYERS = 4
WIDE_MOE_RUNS = (("tp", 4), ("tp_ep", 2))
WIDE_CARDS = 4
# the serves across cards that two layouts hold against each other (the
# MoE's and llava-next-34b's, WIDE_MOE_RUNS and WIDE_RUNS, baseline
# first), each from one draw in f32 and then in bf16: f32 must give every
# first token of the baseline; in bf16 a first token may part only where
# the baseline's top-1 minus top-2 logit gap is within twice the two
# layouts' max |diff| of that sequence's first logits (the least change
# that can flip it)
SERVE_DTYPES = ("float32", "bfloat16")
WIDE_TIMEOUT_S = 900  # each wide child: every rank draws the whole model


def launch(target: list, nproc: int, args: list, cwd: str,
           timeout: int = SHARDED_TIMEOUT_S) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc target args`` in ``cwd`` (``target``: ``["-m", module]`` or a
    script), killed with its ranks at ``timeout``: (exit code, output
    tail, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *target, *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        out += f"\n(killed at {timeout} s)"
    return proc.returncode, out, time.perf_counter() - t0


def failure(rc: int, out: str) -> str:
    """A failed child's exit code and the lines that name its error."""
    lines = [ln for ln in out.splitlines() if ("Error" in ln or "killed"
             in ln) and "ChildFailedError" not in ln]
    return f"exit {rc}: " + " | ".join(lines[-6:])[-2000:]


def gib(peaks: list) -> list:
    return [p / 2**30 for p in peaks]


def held_train(label: str, rep: dict, base: dict, held: str) -> dict:
    """``rep``'s 3 steps held against ``base``'s first ones (losses and
    grad norms at ``SHARDED_LOSS_RTOL``), checked and summarized."""
    n = SHARDED_TRAIN_STEPS
    # like for like: the steps after the first (which pays DTensor's
    # planning) and before any checkpoint write
    base_ms = statistics.median(base["step_ms"][1:n])
    rel = [abs(a / b - 1) for a, b in zip(rep["loss"], base["loss"][:n])]
    grel = [abs(a / b - 1) for a, b in zip(rep["grad_norm"],
                                             base["grad_norm"][:n])]
    finite = all(math.isfinite(v) for v in rep["loss"] + rep["grad_norm"])
    ok = len(rel) == n and finite and max(rel + grel) <= SHARDED_LOSS_RTOL
    check(f"{label}: losses and grad norms against {held}", ok,
          f"loss {rep['loss']}, max rel diff loss {max(rel):.3g}, grad norm "
          f"{max(grel):.3g} (tol {SHARDED_LOSS_RTOL}); step "
          f"{rep['step_ms_median']:.1f} ms ({held} {base_ms:.1f}); first "
          f"step {rep['step_ms'][0]:.1f} ms; peak per rank "
          f"{gib(rep['peak_bytes_per_rank'])} GiB")
    return {"mesh": rep["mesh"], "mode": rep["mode"], "held_against": held,
            "loss": rep["loss"], "grad_norm": rep["grad_norm"],
            "loss_max_rel_diff": max(rel),
            "grad_norm_max_rel_diff": max(grel), "step_ms": rep["step_ms"],
            "step_ms_median": rep["step_ms_median"],
            "base_step_ms_median": base_ms,
            "host_overhead_ms": rep["step_ms_median"] - base_ms,
            "peak_bytes_per_rank": rep["peak_bytes_per_rank"]}


def held_serve(label: str, rep: dict, base: dict, held: str,
               all_tokens: bool) -> dict:
    """``rep``'s greedy tokens held against ``base``'s: all of them, or
    the first of each sequence (bf16 partial sums reduced across cards
    round where one card rounds once, so later tokens may part)."""
    got, want = torch.tensor(rep["tokens"]), torch.tensor(base["tokens"])
    same = torch.equal(got, want)
    share = (got == want).float().mean().item()
    first = bool((got[:, 0] == want[:, 0]).all())
    ok = same if all_tokens else first
    check(f"{label}: greedy tokens against {held} "
          f"({'all' if all_tokens else 'the first of each'} equal)", ok,
          f"{share:.4f} of tokens equal, the first of each "
          f"{'equal' if first else 'not all equal'}; prefill "
          f"{rep['prefill_ms']:.3f} "
          f"ms ({held} {base['prefill_ms']:.3f}), decode "
          f"{rep['decode_ms_per_step']:.3f} ms a step ({held} "
          f"{base['decode_ms_per_step']:.3f}); peak per rank "
          f"{gib(rep['peak_bytes_per_rank'])} GiB")
    return {"mesh": rep["mesh"], "mode": rep["mode"], "held_against": held,
            "tokens_equal": same, "tokens_equal_share": share,
            "first_tokens_equal": first, "prefill_ms": rep["prefill_ms"],
            "decode_ms_per_step": rep["decode_ms_per_step"],
            "base_prefill_ms": base["prefill_ms"],
            "base_decode_ms_per_step": base["decode_ms_per_step"],
            "host_overhead_prefill_ms": rep["prefill_ms"]
            - base["prefill_ms"],
            "host_overhead_decode_ms_per_step": rep["decode_ms_per_step"]
            - base["decode_ms_per_step"],
            "peak_bytes_per_rank": rep["peak_bytes_per_rank"]}


def run_child(label: str, target: list, nproc: int, args: list, tmp: str,
              path: str, timeout: int = SHARDED_TIMEOUT_S):
    """A child of ``launch`` that writes its report to ``path``: the
    report (with the child's seconds), or None after a failed check."""
    rc, out, secs = launch(target, nproc, args, tmp, timeout)
    if rc != 0 or not os.path.exists(path):
        check(label, False, failure(rc, out))
        return None
    with open(path) as f:
        rep = json.load(f)
    rep["child_s"] = secs
    print(f"  {label}: child {secs:.1f} s")
    return rep


def train_run(tmp: str, nproc: int, mp: int, mode: str, arch: str) -> tuple:
    """(label, ``launch.train``'s arguments, report path) of a sharded
    train run: bf16 8 x 1024, 3 steps, over ``nproc`` ranks with 'model'
    = ``mp``."""
    B, S = TRAIN[:2]
    path = os.path.join(tmp, f"train_{arch}_{nproc}_{mp}_{mode}.json")
    return (f"{arch} train {B}x{S}, {nproc} rank(s), model={mp}, --mode "
            f"{mode}", [
                "--arch", arch, "--global-batch", str(B), "--seq-len",
                str(S), "--steps", str(SHARDED_TRAIN_STEPS), "--mode", mode,
                "--model-parallel", str(mp), "--log-every", "1", "--json",
                path], path)


def serve_run(tmp: str, nproc: int, mp: int, mode: str, arch: str) -> tuple:
    """(label, ``launch.serve``'s arguments, report path) of a sharded
    serve: bf16 8 x 1024 + 32 over ``nproc`` ranks with 'model' =
    ``mp``."""
    B, P, G = SERVE
    path = os.path.join(tmp, f"serve_{arch}_{nproc}_{mp}_{mode}.json")
    return (f"{arch} serve {B}x{P} + {G}, {nproc} rank(s), model={mp}, "
            f"--mode {mode}", [
                "--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                "--gen", str(G), "--mode", mode, "--model-parallel", str(mp),
                "--json", path], path)


def sharded_train(tmp: str, nproc: int, mp: int, mode: str, arch: str = QWEN,
                  timeout: int = SHARDED_TIMEOUT_S):
    """``launch.train`` (``train_run``) in a child launch of its own: its
    report, or None after a failed check."""
    label, args, path = train_run(tmp, nproc, mp, mode, arch)
    return run_child(label, ["-m", "repro_torch.launch.train"], nproc, args,
                     tmp, path, timeout)


def sharded_serve(tmp: str, nproc: int, mp: int, mode: str, arch: str = QWEN,
                  timeout: int = SHARDED_TIMEOUT_S):
    """``launch.serve`` (``serve_run``) in a child launch of its own: its
    report, or None after a failed check."""
    label, args, path = serve_run(tmp, nproc, mp, mode, arch)
    return run_child(label, ["-m", "repro_torch.launch.serve"], nproc, args,
                     tmp, path, timeout)


def qwen_runs(tmp: str, nproc: int, meshes) -> list:
    """Phase 9's qwen runs for each 'model' of ``meshes``: (kind, mode,
    'model', label, the launcher's arguments, report path), ``launch.train``
    in ``SHARDED_MODES``, then ``launch.serve`` in
    ``SHARDED_SERVE_MODES``."""
    runs = []
    for mp in meshes:
        runs += [("train", mode, mp, *train_run(tmp, nproc, mp, mode, QWEN))
                 for mode in SHARDED_MODES]
        runs += [("serve", mode, mp, *serve_run(tmp, nproc, mp, mode, QWEN))
                 for mode in SHARDED_SERVE_MODES]
    return runs


def qwen_child(tmp: str, meshes) -> None:
    """``--qwen DIR MP...``, in the ranks of one ``torch.distributed.run``
    launch: every run of ``qwen_runs``, each the launcher's own ``main``
    (``launch.train.main``, ``launch.serve.main``) with its arguments, one
    after another in the process group this child joins once (a launcher
    run in a group already up leaves it up).  One launch pays the start,
    the imports, the card's context and the group's set-up once, where a
    launch a run paid them for each.  Each run writes its report into
    DIR."""
    dev = init_distributed("cuda")
    try:
        for kind, *_, args, _ in qwen_runs(tmp, dist.get_world_size(),
                                           meshes):
            (train if kind == "train" else serve).main(args)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def phase_sharded(served: dict, trained: dict) -> dict:
    """Phase 9's qwen runs: the sharded path under torch.distributed.run
    and NCCL at full width, over every card, in one child (``--qwen``),
    against phases 5 and 6."""
    print("== phase 9: the sharded path (torch.distributed.run, NCCL), "
          f"{QWEN} at full width")
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the children need the card's memory
    rep = {"cards": cards, "train": [], "serve": []}
    with tempfile.TemporaryDirectory(prefix="tcm-sharded-") as tmp:
        meshes = [1] + ([2] if cards >= 2 else [])
        if cards < 2:
            print(f"  ran 1-way only: the machine shows {cards} card")
            # no fallback: 2-way on one card must fail, not run 1-way
            rc, out, _ = launch(["-m", "repro_torch.launch.train"], cards, [
                "--arch", QWEN, "--smoke", "--steps", "1",
                "--model-parallel", "2"], tmp)
            check("--model-parallel 2 over 1 card refuses",
                  rc != 0 and "do not split into model=2" in out,
                  f"exit {rc}")
        rc, out, secs = launch([os.path.join(ROOT, "chip_smoke.py"),
                                "--qwen", tmp], cards, list(map(str, meshes)),
                               tmp, QWEN_TIMEOUT_S)
        rep["child_s"] = secs
        print(f"  {QWEN}'s runs (one child, {cards} rank(s)): child "
              f"{secs:.1f} s")
        for kind, mode, mp, label, _, path in qwen_runs(tmp, cards, meshes):
            if not os.path.exists(path):
                check(label, False, failure(rc, out))
                break
            with open(path) as f:
                r = json.load(f)
            if kind == "train":
                rep["train"].append(held_train(
                    f"sharded train, {cards} rank(s), mesh {r['mesh']}, "
                    f"--mode {mode}", r, trained, "the one-device run"))
            else:
                rep["serve"].append(held_serve(
                    f"sharded serve, {cards} rank(s), mesh {r['mesh']}, "
                    f"--mode {mode}", r, served, "the one-device run",
                    all_tokens=mp == 1))
        if rc != 0:
            check(f"{QWEN}'s runs (one child)", False, failure(rc, out))
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  phase 9 ({QWEN}) took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded": rep}))
    return rep


def moe_child(mode: str, layers: int, mp: int, path: str) -> None:
    """``--moe``, in the ranks of a ``torch.distributed.run`` launch:
    phi3.5-moe at full width and ``layers`` layers, bf16 with f32 master
    weights and remat as ``launch.train`` runs it, through the library:
    the parameters and optimizer state from ``init_sharded`` over the
    (data, model) mesh of the ranks with 'model' = ``mp``; for each of
    ``SERVE_DTYPES`` (the drawn f32 weights, then cast once to bf16) a
    greedy serve of 8 x 1024 + 32, whose first logits rank 0 writes
    beside ``path`` (``moe_run``'s ``first``), then 3 train steps of
    8 x 1024.  ``mode`` "all", on one rank: ``MOE_MODES`` on the 1x1 mesh
    and one device, the model drawn once (``moe_all``), served in bf16
    alone.  Rank 0 writes the report (for "all", the reports by mode) to
    ``path``."""
    cfg = get_config(MOE_ARCH).scaled(n_layers=layers)
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))

    def write(rep) -> None:  # inside the group: rank 0 alone
        if is_main():
            with open(path, "w") as f:
                json.dump(rep, f)

    if mode == "all":
        torch.cuda.set_device(dev)
        run_launched(1, dev, lambda d, mesh, dmesh: write(moe_all(
            cfg, d, dmesh, mesh.shape)))
    else:
        run_launched(mp, dev, lambda d, mesh, dmesh: write(moe_run(
            cfg, d, dmesh, mode, mesh.shape, first=path)[0]))


def moe_all(cfg, dev, dmesh, mesh_shape) -> dict:
    """``MOE_MODES`` on the 1x1 mesh ``dmesh``, then one device: the
    first mode's weights drawn by ``init_sharded`` and kept in host memory
    (the card holds no second copy beside the MoE's ~71 GiB peak), the
    others' copied from there; on the 1x1 mesh every mode places every
    leaf whole, so the weights are ``init``'s, bit for bit.  The reports
    by mode ("one" for one device)."""
    if dmesh.size() != 1:
        raise ValueError(f"--moe all runs on one rank, not {mesh_shape}")
    reps, start = {}, None
    for mode in MOE_MODES + ("one",):
        mesh = None if mode == "one" else dmesh
        reps[mode], kept = moe_run(cfg, dev, mesh, None if mesh is None
                                   else mode, mesh_shape, start)
        start = start or kept
    return reps


def moe_run(cfg, dev, dmesh, mode, mesh_shape=None, start=None,
            first=None) -> tuple:
    """One MoE run; its weights drawn (``init``, or ``init_sharded`` over
    ``dmesh``), or copied from ``start`` (whole leaves in host memory).
    Served in bf16 (the weights cast once); with ``first`` (a path), in
    each of ``SERVE_DTYPES``, one prefill's first logits written by rank 0
    to ``first.<dtype>.npy`` and the serve's report under its dtype, the
    bf16 one's also at the top.  Returns (the report, a host copy of the
    drawn weights or None)."""
    B, S = TRAIN[:2]
    SB, P, G = SERVE
    oc = OptConfig(decay_steps=10)  # launch.train's, for a short run
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kept = None
    if start is not None:
        params = lm.tree_map(lambda h: h.to(dev), start)
        opt = init_opt_state(oc, params)
        if dmesh is not None:
            specs = lm.param_specs(cfg)
            params = distribute(params, specs, dmesh, mode)
            opt = distribute(opt, opt_state_specs(oc, specs), dmesh, mode)
    elif dmesh is None:
        params, opt = init(cfg, oc, dev)
    else:
        params, _, opt = init_sharded(cfg, oc, dmesh, mode, device=dev)
        kept = lm.tree_map(lambda p: p.full_tensor().detach().to(
            "cpu", copy=True), params)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    served_by = {}
    for dt in SERVE_DTYPES if first else (None,):
        c = cfg if dt is None else cfg.scaled(dtype=dt)
        served = cast_for_compute(c, params)  # f32 keeps the leaves
        batch = serve.make_batch(c, SB, P, dev)
        if first:
            prefill_step, _ = make_serve_steps(c, dmesh, mode)
            logits, _ = prefill_step(served, batch, place_cache(
                c, lm.init_cache(c, SB, P + G, dev), dmesh))
            if is_main():
                np.save(f"{first}.{dt}.npy", logits.float().cpu().numpy())
            del logits
        tokens, stats = serve.generate(c, served, batch, G, dmesh,
                                       mode or "tp")
        del served
        served_by[dt] = {"tokens": tokens.tolist(),
                         "prefill_ms": stats["prefill_ms"],
                         "decode_ms_per_step": stats["decode_ms_per_step"],
                         "peak_bytes_per_rank": per_rank(
                             stats["peak_bytes"])}
    step = make_train_step(cfg, oc, mesh=dmesh, mode=mode or "tp")
    data = SyntheticTokens(DataConfig(global_batch=B, seq_len=S,
                                      vocab=cfg.vocab))
    times, losses, gnorms = [], [], []
    for _ in range(SHARDED_TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        times.append((time.perf_counter() - t) * 1e3)
    peaks = per_rank(torch.cuda.max_memory_allocated(dev))
    del params, opt, step
    torch.cuda.empty_cache()
    bf16 = served_by[SERVE_DTYPES[-1] if first else None]
    return {"arch": cfg.name, "layers": cfg.n_layers, "mode": mode,
            "mesh": mesh_shape if dmesh is not None else None,
            "init_s": init_s, "drawn": start is None,
            "tokens": bf16["tokens"], "prefill_ms": bf16["prefill_ms"],
            "decode_ms_per_step": bf16["decode_ms_per_step"],
            **({dt: served_by[dt] for dt in SERVE_DTYPES} if first else {}),
            "step_ms": times, "step_ms_median": statistics.median(times[1:]),
            "loss": losses, "grad_norm": gnorms,
            "peak_bytes_per_rank": peaks}, kept


def moe_held(label: str, r: dict, base: dict, held: str) -> dict:
    """``r`` held against ``base`` (losses and grad norms at
    ``SHARDED_LOSS_RTOL``, the first token of each sequence equal)."""
    how = "drawn" if r["drawn"] else "copied"
    print(f"  {label}: init {r['init_s']:.1f} s ({how}), peak per rank "
          f"{gib(r['peak_bytes_per_rank'])} GiB, steps {r['step_ms']} ms")
    return {"train": held_train(label, r, base, held),
            "serve": held_serve(label, r, base, held, False),
            "init_s": r["init_s"], "drawn": r["drawn"]}


def moe_label(layers: int, mode: str, nproc: int, mp: int) -> str:
    return (f"{MOE_ARCH} at {layers} layers, bf16, "
            f"{'one device' if mode == 'one' else f'--mode {mode}'}, "
            f"{nproc} rank(s), model={mp}")


def moe_runs(tmp: str, layers: int, runs, nproc: int) -> list:
    """The ``--moe`` children of ``runs`` ((mode, 'model') pairs, the
    first the baseline) over ``nproc`` ranks, each held against the
    first: training by ``held_train``, the serves in f32 and bf16 by
    ``held_first_tokens``."""
    reps, logits = [], []
    for mode, mp in runs:
        path = os.path.join(tmp, f"moe_{layers}_{mode}_{mp}.json")
        label = moe_label(layers, mode, nproc, mp)
        r = run_child(label, [os.path.join(ROOT, "chip_smoke.py"), "--moe"],
                      nproc, [mode, str(layers), str(mp), path], tmp, path,
                      WIDE_TIMEOUT_S)
        if r is None:
            return reps
        logits.append(first_logits(path))
        if not reps:
            print(f"  {label}: init {r['init_s']:.1f} s, peak per rank "
                  f"{gib(r['peak_bytes_per_rank'])} GiB, steps "
                  f"{r['step_ms']} ms")
            reps.append({"base": r})
            continue
        base = reps[0]["base"]
        held = f"{runs[0][0]}, model={runs[0][1]}"
        how = "drawn" if r["drawn"] else "copied"
        print(f"  {label}: init {r['init_s']:.1f} s ({how}), peak per rank "
              f"{gib(r['peak_bytes_per_rank'])} GiB, steps {r['step_ms']} "
              f"ms")
        reps.append({"train": held_train(label, r, base, held),
                     "serve": held_first_tokens(
                         f"{MOE_ARCH} at {layers} layers", [base, r],
                         [logits[0], logits[-1]]),
                     "init_s": r["init_s"], "drawn": r["drawn"],
                     "child_s": r["child_s"]})
    return reps


def phase_moe() -> dict:
    """Phase 9's MoE: phi3.5-moe at full width and 2 layers on one card,
    in MOE_MODES on the 1x1 mesh and one device, in one child (``--moe
    all``) that draws the model once; each mesh run held against the
    one-device run."""
    print(f"== phase 9: {MOE_ARCH} at full width, {MOE_LAYERS} layers, "
          f"one device and {'/'.join(MOE_MODES)}")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tcm-moe-") as tmp:
        path = os.path.join(tmp, "moe.json")
        got = run_child(f"{MOE_ARCH} at {MOE_LAYERS} layers (one child, "
                        f"1 rank)", [os.path.join(ROOT, "chip_smoke.py"),
                                     "--moe"], 1,
                        ["all", str(MOE_LAYERS), "1", path], tmp, path,
                        WIDE_TIMEOUT_S)
    reps = []
    if got is not None:
        base = got["one"]
        print(f"  {moe_label(MOE_LAYERS, 'one', 1, 1)}: init "
              f"{base['init_s']:.1f} s (copied), peak per rank "
              f"{gib(base['peak_bytes_per_rank'])} GiB, steps "
              f"{base['step_ms']} ms")
        reps.append({"base": base})
        reps += [moe_held(moe_label(MOE_LAYERS, mode, 1, 1), got[mode], base,
                          "one, model=1") for mode in MOE_MODES]
    rep = {"runs": reps, "child_s": got and got["child_s"],
           "phase_s": time.perf_counter() - t0}
    print(f"  phase 9 ({MOE_ARCH}) took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded_moe": rep}))
    return rep


# the other four families over a mesh (phase 9): at full width, bf16 with
# f32 master weights and remat as launch.train runs them, each one device
# and in its reference modes (the dry-run's: dp trains and tp_fsdp serves
# ssm and audio, tp_fsdp runs the others) on the 1x1 mesh, all in one
# child of torch.distributed.run (``--families``).  family -> (arch,
# layers (None: all), train mode, serve mode, serve (batch, prompt, gen)).
# The hybrid serves a 4096 prompt so that its window of 2048 runs the
# ring; the vlm's 1024 positions are 576 patch embeddings and 448 tokens.
FAMILIES = {
    "ssm": ("mamba2-130m", None, "dp", "tp_fsdp", (8, 1024, 32)),
    "audio": ("seamless-m4t-medium", None, "dp", "tp_fsdp", (8, 1024, 32)),
    "hybrid": ("recurrentgemma-2b", 8, "tp_fsdp", "tp_fsdp", (4, 4096, 32)),
    "vlm": ("llava-next-34b", 2, "tp_fsdp", "tp_fsdp", (8, 448, 32)),
}
VLM_PATCHES = 576
FAMILIES_TIMEOUT_S = 600


def family_batch(cfg, B: int, P: int, dev) -> dict:
    """The serve batch: ``launch.serve.make_batch``'s, with the vlm's
    ``VLM_PATCHES`` embeddings before its ``P`` tokens."""
    batch = serve.make_batch(cfg, B, P, dev)
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, VLM_PATCHES, cfg.frontend_dim))).float().to(dev)
    return batch


def family_run(spec: tuple, dev, dmesh, mesh_shape=None, start=None,
               keep: bool = True, first=None):
    """One family's run (``spec``: a ``FAMILIES`` entry, perhaps with the
    config's overrides last): the weights drawn by ``init_sharded`` in the
    train mode over ``dmesh``, or, one device (``dmesh`` None), copied
    from ``start``: the mesh run's initial weights, which on the 1x1 mesh
    are whole (``init``'s, bit for bit), so the model is drawn once; or,
    without ``start``, drawn by ``init`` (the same weights
    ``init_sharded`` places); then a greedy serve in the serve mode and 3
    train steps in the train mode.  With ``first`` (a path), rank 0 saves
    the serve's first logits there as ``.npy``.  Returns (times, losses,
    tokens and peak memory; over a mesh and with ``keep``, a copy of the
    initial weights in host memory, off the card's peak)."""
    arch, layers, tmode, smode, (SB, P, G), *over = spec
    cfg = get_config(arch).scaled(**(over[0] if over else {}))
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    oc = OptConfig(decay_steps=10)  # launch.train's, for a short run
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kept = None
    if dmesh is None and start is None:
        params, opt = init(cfg, oc, dev)
    elif dmesh is None:
        params = lm.tree_map(lambda h: h.to(dev), start)
        opt = init_opt_state(oc, params)
    else:
        params, _, opt = init_sharded(cfg, oc, dmesh, tmode, device=dev)
        if keep:
            kept = lm.tree_map(lambda p: p.full_tensor().detach().to(
                "cpu", copy=True), params)
    torch.cuda.synchronize(dev)
    draw_s = time.perf_counter() - t0
    # on the 1x1 mesh every mode places every leaf alike (Replicate), so
    # the weights drawn in the train mode serve in the serve mode as drawn
    served = cast_for_compute(cfg, params)
    batch = family_batch(cfg, SB, P, dev)
    if first is not None:
        prefill_step, _ = make_serve_steps(cfg, dmesh, smode)
        cache = lm.init_cache(cfg, SB, P + G + batch.get(
            "embeds", torch.empty(0, 0)).shape[1], dev)
        logits, _ = prefill_step(served, batch, cache if dmesh is None
                                 else place_cache(cfg, cache, dmesh))
        if is_main():
            np.save(first, logits.float().cpu().numpy())
        del cache, logits
    tokens, stats = serve.generate(cfg, served, batch, G, dmesh, smode)
    del served
    serve_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    B, S = TRAIN[0], TRAIN[1] - (VLM_PATCHES if cfg.family == "vlm" else 0)
    step = make_train_step(cfg, oc, mesh=dmesh, mode=tmode)
    data = SyntheticTokens(DataConfig(
        global_batch=B, seq_len=S, vocab=cfg.vocab, frontend=cfg.frontend,
        frontend_dim=cfg.frontend_dim, frontend_len=VLM_PATCHES))
    times, losses, gnorms = [], [], []
    for _ in range(SHARDED_TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        times.append((time.perf_counter() - t) * 1e3)
    train_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in lm.tree_leaves(params))
    del params, opt, step
    torch.cuda.empty_cache()
    mesh = None if dmesh is None else mesh_shape
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
            "draw_s": draw_s,
            "train": {"mesh": mesh, "mode": tmode if mesh else None,
                      "batch": [B, S], "step_ms": times,
                      "step_ms_median": statistics.median(times[1:]),
                      "loss": losses, "grad_norm": gnorms,
                      "peak_bytes_per_rank": per_rank(train_peak)},
            "serve": {"mesh": mesh, "mode": smode if mesh else None,
                      "batch": [SB, P, G], "tokens": tokens.tolist(),
                      "prefill_ms": stats["prefill_ms"],
                      "decode_ms_per_step": stats["decode_ms_per_step"],
                      "peak_bytes_per_rank": per_rank(serve_peak)}}, kept


def families_child(path: str) -> None:
    """``--families``, in the one rank of a ``torch.distributed.run``
    launch: every family of ``FAMILIES`` over the 1x1 mesh, then one
    device from the same initial weights.  Writes the reports to
    ``path``."""
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)

    def body(d, mesh, dmesh):
        if mesh.size != 1:
            raise ValueError(f"--families runs on one rank, not {mesh}")
        out = {}
        for fam in FAMILIES:
            t0 = time.perf_counter()
            on_mesh, start = family_run(FAMILIES[fam], d, dmesh, mesh.shape)
            one, _ = family_run(FAMILIES[fam], d, None, start=start)
            del start
            torch.cuda.empty_cache()
            out[fam] = {"one": one, "mesh": on_mesh,
                        "run_s": time.perf_counter() - t0}
        with open(path, "w") as f:
            json.dump(out, f)

    run_launched(1, dev, body)


def phase_families() -> dict:
    """Phase 9's other families: ssm, audio, hybrid and vlm at full width
    (depth cut by ``FAMILIES``), one device and in their reference modes
    on the 1x1 mesh of one card, in one child; each mesh run held against
    its one-device run (losses and grad norms at ``SHARDED_LOSS_RTOL``,
    every token equal)."""
    print("== phase 9: the ssm, audio, hybrid and vlm families at full "
          "width, one device and their reference modes on the 1x1 mesh")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rep = {}
    with tempfile.TemporaryDirectory(prefix="tcm-families-") as tmp:
        path = os.path.join(tmp, "families.json")
        got = run_child("families (one child, 1 rank)",
                        [os.path.join(ROOT, "chip_smoke.py"), "--families"],
                        1, [path], tmp, path, FAMILIES_TIMEOUT_S)
    for fam, r in (got or {}).items():
        if fam == "child_s":
            rep[fam] = r
            continue
        one, mesh = r["one"], r["mesh"]
        label = (f"{fam} {one['arch']} ({one['layers']} layers, "
                 f"{one['params'] / 1e9:.3f} G parameters)")
        train_held = held_train(f"{label} train --mode "
                                f"{mesh['train']['mode']}", mesh["train"],
                                one["train"], "the one-device run")
        serve_held = held_serve(f"{label} serve --mode "
                                f"{mesh['serve']['mode']}", mesh["serve"],
                                one["serve"], "the one-device run", True)
        bitwise = (mesh["train"]["loss"] == one["train"]["loss"] and
                   mesh["train"]["grad_norm"] == one["train"]["grad_norm"])
        print(f"  {label}: draw {mesh['draw_s']:.1f} s (one device: a "
              f"copy, {one['draw_s']:.3f} s); losses bitwise equal: "
              f"{bitwise}; run {r['run_s']:.1f} s")
        rep[fam] = {"arch": one["arch"], "layers": one["layers"],
                    "params": one["params"], "bitwise": bitwise,
                    "draw_s": {"one": one["draw_s"], "mesh": mesh["draw_s"]},
                    "one": {"train": {k: one["train"][k] for k in (
                        "loss", "grad_norm", "step_ms", "step_ms_median",
                        "peak_bytes_per_rank")},
                        "serve": {k: one["serve"][k] for k in (
                            "prefill_ms", "decode_ms_per_step",
                            "peak_bytes_per_rank")}},
                    "train": train_held, "serve": serve_held,
                    "run_s": r["run_s"]}
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  phase 9 (families) took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded_families": rep}))
    return rep


def phase_wide(parts=("minitron", "moe")) -> dict:
    """``--sharded``'s runs that need 4 cards: minitron-8b trained and
    served in tp_fsdp on (2, 2) against tp on (1, 4), and phi3.5-moe at 4
    layers in tp_ep on (2, 2) against tp on (1, 4); those of ``parts``."""
    cards = torch.cuda.device_count()
    print(f"== --sharded: {WIDE_ARCH} at full width and {MOE_ARCH} at "
          f"{WIDE_MOE_LAYERS} layers over {WIDE_CARDS} cards")
    if cards < WIDE_CARDS:
        check(f"{WIDE_CARDS} cards for the wide runs", False,
              f"the machine shows {cards}")
        return {}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rep = {"train": [], "serve": []}
    with tempfile.TemporaryDirectory(prefix="tcm-wide-") as tmp:
        base = None
        for mode, mp in WIDE_RUNS if "minitron" in parts else ():
            r = sharded_train(tmp, WIDE_CARDS, mp, mode, WIDE_ARCH,
                              WIDE_TIMEOUT_S)
            if r is None:
                break
            if base is None:
                base, held = r, f"{mode}, model={mp}"
                print(f"  {WIDE_ARCH} {mode}: steps {r['step_ms']} ms, "
                      f"losses {r['loss']}, peak per rank "
                      f"{gib(r['peak_bytes_per_rank'])} GiB")
                rep["train"].append({"base": r})
                continue
            rep["train"].append(held_train(
                f"{WIDE_ARCH} train, mesh {r['mesh']}, --mode {mode}", r,
                base, held))
        base = None
        for mode, mp in WIDE_RUNS if "minitron" in parts else ():
            r = sharded_serve(tmp, WIDE_CARDS, mp, mode, WIDE_ARCH,
                              WIDE_TIMEOUT_S)
            if r is None:
                break
            if base is None:
                base, held = r, f"{mode}, model={mp}"
                rep["serve"].append({"base": r})
                continue
            rep["serve"].append(held_serve(
                f"{WIDE_ARCH} serve, mesh {r['mesh']}, --mode {mode}", r,
                base, held, False))
        if "moe" in parts:
            rep["moe"] = moe_runs(tmp, WIDE_MOE_LAYERS, WIDE_MOE_RUNS,
                                  WIDE_CARDS)
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  the wide runs took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded_wide": rep}))
    return rep


# ``--sharded``'s other families on 4 cards: recurrentgemma-2b at full
# width and depth (26 layers: 8 groups split over data 2, the two
# one-layer stacks whole) trained and served in tp_fsdp on (2, 2) against
# tp on (1, 4); llava-next-34b served in bf16 at full width and depth (60
# layers, ~34.4 G parameters: its bf16 weights alone are ~69 GB) the same
# two ways; mamba2-130m and seamless-m4t-medium trained in dp on (4, 1)
# against one card.
WIDE_HYBRID = "recurrentgemma-2b"
WIDE_VLM = "llava-next-34b"
WIDE_DP = ("mamba2-130m", "seamless-m4t-medium")


def wide_pair(tmp: str, run, arch: str, runs, rep: list) -> None:
    """``run(tmp, nproc, mp, mode, arch, timeout)`` (``sharded_train`` or
    ``sharded_serve``) for each (ranks, mode, 'model') of ``runs``, each
    held against the first; the reports appended to ``rep``."""
    base = None
    for nproc, mode, mp in runs:
        r = run(tmp, nproc, mp, mode, arch, WIDE_TIMEOUT_S)
        if r is None:
            return
        if base is None:
            base, held = r, f"{mode}, {nproc} rank(s), model={mp}"
            rep.append({"base": r})
            continue
        label = f"{arch}, mesh {r['mesh']}, --mode {mode}"
        rep.append(held_train(label, r, base, held) if run is sharded_train
                   else held_serve(label, r, base, held, False))


def vlm_child(mode: str, mp: int, path: str) -> None:
    """``--vlm MODE MP PATH``, in the ranks of a ``torch.distributed.run``
    launch: ``WIDE_VLM`` at full width and depth drawn once by
    ``init_sharded`` over the (data, model) mesh with 'model' = ``mp``,
    then for each of ``SERVE_DTYPES`` (f32 first, as drawn; then cast to
    bf16 and the f32 copy freed) one prefill of ``launch.serve``'s prompts
    (``SERVE``) whose first logits rank 0 writes to ``PATH.<dtype>.npy``,
    and the greedy serve of ``launch.serve``.  Rank 0 writes the report
    to ``path``."""
    B, P, G = SERVE
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))

    def body(d, mesh, dmesh):
        cfg = get_config(WIDE_VLM)
        t0 = time.perf_counter()
        params = init_sharded(cfg, None, dmesh, mode, device=d)[0]
        rep = {"mesh": mesh.shape, "mode": mode, "draw_s":
               time.perf_counter() - t0}
        for dt in SERVE_DTYPES:
            c = cfg.scaled(dtype=dt)
            params = cast_for_compute(c, params)  # f32 keeps the leaves
            torch.cuda.empty_cache()
            batch = serve.make_batch(c, B, P, d)
            prefill_step, _ = make_serve_steps(c, dmesh, mode)
            cache = place_cache(c, lm.init_cache(
                c, B, P + G + batch["embeds"].shape[1], d), dmesh)
            first, _ = prefill_step(params, batch, cache)
            del cache
            if is_main():
                np.save(f"{path}.{dt}.npy", first.float().cpu().numpy())
            del first
            tokens, stats = serve.generate(c, params, batch, G, dmesh, mode)
            rep[dt] = {"tokens": tokens.tolist(),
                       "prefill_ms": stats["prefill_ms"],
                       "decode_ms_per_step": stats["decode_ms_per_step"],
                       "peak_bytes_per_rank": per_rank(stats["peak_bytes"])}
        if is_main():
            with open(path, "w") as f:
                json.dump(rep, f)

    run_launched(mp, dev, body)


def vlm_layouts(tmp: str) -> dict:
    """``WIDE_VLM`` served in each layout of ``WIDE_RUNS`` (one child
    each, ``--vlm``), held against the first (``held_first_tokens``)."""
    reps, logits = [], []
    for mode, mp in WIDE_RUNS:
        path = os.path.join(tmp, f"vlm_{mode}_{mp}.json")
        r = run_child(f"{WIDE_VLM} serve {SERVE[0]}x{SERVE[1]} + {SERVE[2]} "
                      f"in f32 then bf16, {WIDE_CARDS} ranks, model={mp}, "
                      f"--mode {mode}", [os.path.join(ROOT, "chip_smoke.py"),
                                         "--vlm", mode, str(mp)],
                      WIDE_CARDS, [path], tmp, path, WIDE_TIMEOUT_S)
        if r is None:
            return {"runs": reps}
        reps.append(r)
        logits.append(first_logits(path))
    return {"runs": reps, **held_first_tokens(WIDE_VLM, reps, logits)}


def first_logits(path: str) -> dict:
    """The first logits that a child's rank 0 wrote beside ``path``, by
    dtype."""
    return {dt: np.load(f"{path}.{dt}.npy") for dt in SERVE_DTYPES}


def held_first_tokens(name: str, reps: list, logits: list) -> dict:
    """Two layouts' serves of ``name`` (``reps``, the baseline first, each
    with a report per dtype of ``SERVE_DTYPES``; their first logits in
    ``logits``) held by the rule that settled C9: per dtype the share of
    equal tokens, and per sequence whether the first token parts, the two
    layouts' max |diff| of the first logits and the baseline's top-1
    minus top-2 gap.  f32: every first token equal; bf16: a first token
    parts only where the gap is at most twice the max |diff|."""
    base, other = reps
    out = {}
    for dt in SERVE_DTYPES:
        want, got = (torch.tensor(r[dt]["tokens"]) for r in reps)
        lb, lo = (torch.from_numpy(x[dt]) for x in logits)
        diff = (lb - lo).abs().amax(-1)
        top2 = lb.topk(2, -1).values
        gap = top2[:, 0] - top2[:, 1]
        parts = got[:, 0] != want[:, 0]
        stats = {"tokens_equal_share": (got == want).float().mean().item(),
                 "first_parts": parts.tolist(),
                 "first_logits_max_abs_diff": diff.tolist(),
                 "base_gap": gap.tolist(),
                 "gap_below_diff": (gap < diff).tolist(),
                 "prefill_ms": [r[dt]["prefill_ms"] for r in reps],
                 "decode_ms_per_step": [r[dt]["decode_ms_per_step"]
                                        for r in reps],
                 "peak_bytes_per_rank": [r[dt]["peak_bytes_per_rank"]
                                         for r in reps]}
        out[dt] = stats
        label = (f"{name} {dt}, mesh {other['mesh']} --mode "
                 f"{other['mode']} against {base['mesh']} --mode "
                 f"{base['mode']}")
        detail = (f"{stats['tokens_equal_share']:.4f} of tokens equal, "
                  f"first tokens part at {parts.nonzero().flatten().tolist()}"
                  f"; per sequence max |diff| of the first logits "
                  f"{[float(f'{v:.4g}') for v in diff.tolist()]}, top-1 "
                  f"minus top-2 gap "
                  f"{[float(f'{v:.4g}') for v in gap.tolist()]}; prefill "
                  f"{stats['prefill_ms']} ms, decode "
                  f"{stats['decode_ms_per_step']} ms a step")
        if dt == "float32":
            check(f"{label}: every first token equal", not parts.any(),
                  detail)
        else:
            check(f"{label}: first tokens part only within rounding "
                  f"(gap <= 2 max |diff|)", bool(
                      (gap[parts] <= 2 * diff[parts]).all()), detail)
    return out


def phase_wide_families(parts=("hybrid", "dp", "vlm")) -> dict:
    """``--sharded``'s runs of the ssm, hybrid, vlm and audio families on
    ``WIDE_CARDS`` cards, each held against its baseline; those of
    ``parts`` (``dp``: the ssm's and the audio's)."""
    cards = torch.cuda.device_count()
    print(f"== --sharded: {WIDE_HYBRID} and {WIDE_VLM} at full width and "
          f"depth, {'/'.join(WIDE_DP)} in dp, over {WIDE_CARDS} cards")
    if cards < WIDE_CARDS:
        check(f"{WIDE_CARDS} cards for the wide runs", False,
              f"the machine shows {cards}")
        return {}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rep = {"hybrid_train": [], "hybrid_serve": [], "vlm_serve": [],
           "dp_train": {}}
    with tempfile.TemporaryDirectory(prefix="tcm-wide-families-") as tmp:
        pair = [(WIDE_CARDS, mode, mp) for mode, mp in WIDE_RUNS]
        if "hybrid" in parts:
            wide_pair(tmp, sharded_train, WIDE_HYBRID, pair,
                      rep["hybrid_train"])
            wide_pair(tmp, sharded_serve, WIDE_HYBRID, pair,
                      rep["hybrid_serve"])
        for arch in WIDE_DP if "dp" in parts else ():
            rep["dp_train"][arch] = []
            wide_pair(tmp, sharded_train, arch,
                      [(1, "dp", 1), (WIDE_CARDS, "dp", 1)],
                      rep["dp_train"][arch])
        # last: each of its ranks draws all ~34.4 G parameters (~280 s)
        if "vlm" in parts:
            rep["vlm_serve"] = vlm_layouts(tmp)
    rep["phase_s"] = time.perf_counter() - t0
    print(f"  the wide families took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded_wide_families": rep}))
    return rep


# ``--sharded``'s kv-group run: llava-next-34b at full width (d_model
# 7168) and 2 of its 60 layers, with its heads cut to 14 q and 2 kv heads
# (groups of 7 q heads, as its 56 and 8): no config has 2 kv heads at full
# width, and over 'model' 4 neither count divides while 4 is twice the kv
# heads, so each kv head goes to 2 ranks (``sharding.kv_group``) and a
# train step splits the rows of every q chunk between them.  Trained 3
# steps and served in tp_fsdp on (1, 4) (``--kvgroup``, one child of 4
# ranks) against the same config on one card (one child of 1 rank, drawn
# by ``init``: the weights ``init_sharded`` places), at the bf16
# tolerances of the other runs: losses and grad norms at
# ``SHARDED_LOSS_RTOL``, a first token parting only where the top-1 minus
# top-2 gap of the one-card run's first logits is within twice the two
# runs' max |diff| (as ``vlm_layouts`` holds bf16).
KV_GROUP = ("llava-next-34b", 2, "tp_fsdp", "tp_fsdp", (8, 448, 32),
            {"n_heads": 14, "n_kv_heads": 2})
KV_GROUP_MP = 4


def kv_group_child(path: str) -> None:
    """``--kvgroup PATH``, in the ranks of a ``torch.distributed.run``
    launch: ``family_run`` of ``KV_GROUP`` over the (1, ranks) mesh, or
    on one device when the launch has one rank; rank 0 writes the report
    to ``path`` and the first logits to ``path.npy``."""
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)

    def body(d, mesh, dmesh):
        one = dmesh.size() == 1
        rep, _ = family_run(KV_GROUP, d, None if one else dmesh,
                            mesh.shape, keep=False, first=f"{path}.npy")
        if is_main():
            with open(path, "w") as f:
                json.dump(rep, f)

    run_launched(int(os.environ.get("WORLD_SIZE", "1")), dev, body)


def phase_kv_group() -> dict:
    """``--sharded``'s kv-group run (``KV_GROUP``): the one-card child,
    then the (1, 4) child in tp_fsdp, held against it."""
    arch, layers, *_, over = KV_GROUP
    label = (f"{arch} at {layers} layers with {over['n_heads']} q and "
             f"{over['n_kv_heads']} kv heads")
    print(f"== --sharded: {label}, tp_fsdp on (1, {KV_GROUP_MP}) against one "
          f"card")
    cards = torch.cuda.device_count()
    if cards < KV_GROUP_MP:
        check(f"{KV_GROUP_MP} cards for the kv-group run", False,
              f"the machine shows {cards}")
        return {}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="tcm-kv-group-") as tmp:
        for nproc in (1, KV_GROUP_MP):
            path = os.path.join(tmp, f"kv_group_{nproc}.json")
            r = run_child(f"{label}, {nproc} rank(s)",
                          [os.path.join(ROOT, "chip_smoke.py"), "--kvgroup"],
                          nproc, [path], tmp, path, WIDE_TIMEOUT_S)
            if r is None:
                return {"runs": runs}
            r["first_logits"] = np.load(f"{path}.npy")
            runs[nproc] = r
    one, got = runs[1], runs[KV_GROUP_MP]
    rep = {"train": held_train(f"{label} train, mesh {got['train']['mesh']},"
                               f" --mode tp_fsdp", got["train"], one["train"],
                               "one card")}
    want_t, got_t = (torch.tensor(r["serve"]["tokens"]) for r in (one, got))
    lb, lo = (torch.from_numpy(r.pop("first_logits")) for r in (one, got))
    diff = (lb - lo).abs().amax(-1)
    top2 = lb.topk(2, -1).values
    gap = top2[:, 0] - top2[:, 1]
    parts = got_t[:, 0] != want_t[:, 0]
    serve_s = got["serve"]
    check(f"{label} serve, mesh {serve_s['mesh']}, --mode tp_fsdp: first "
          f"tokens part only within rounding (gap <= 2 max |diff|)",
          bool((gap[parts] <= 2 * diff[parts]).all()),
          f"{(got_t == want_t).float().mean().item():.4f} of tokens equal, "
          f"first tokens part at {parts.nonzero().flatten().tolist()}; per "
          f"sequence max |diff| of the first logits "
          f"{[float(f'{v:.4g}') for v in diff.tolist()]}, gap "
          f"{[float(f'{v:.4g}') for v in gap.tolist()]}; prefill "
          f"{serve_s['prefill_ms']:.3f} ms (one card "
          f"{one['serve']['prefill_ms']:.3f}), decode "
          f"{serve_s['decode_ms_per_step']:.3f} ms a step (one card "
          f"{one['serve']['decode_ms_per_step']:.3f}); peak per rank "
          f"{gib(serve_s['peak_bytes_per_rank'])} GiB")
    rep.update(runs=runs, first_parts=parts.tolist(),
               first_logits_max_abs_diff=diff.tolist(), base_gap=gap.tolist(),
               phase_s=time.perf_counter() - t0)
    print(f"  the kv-group run took {rep['phase_s']:.1f} s")
    print(json.dumps({"sharded_kv_group": rep}))
    return rep


# ``--sharded``'s dry-run over 4 cards (phase 8(c) over a mesh): rank 0's
# fake trace of phase 9's qwen train step (bf16 with f32 master weights,
# remat, 8 x 1024) against the same counters over the real step on rank 0
# of each (mode, 'model') of 4 ranks
COUNT_RUNS = (("tp_fsdp", 2), ("tp", 4))


def count_child(mode: str, mp: int, path: str) -> None:
    """``--count MODE MP PATH``, in the ranks of a ``torch.distributed.run``
    launch: the train step ``launch.dryrun.make_inputs`` builds over the
    (data, model) mesh of the ranks with 'model' = ``mp``, run once under
    the dry-run's counters (``count``) on every rank; rank 0 writes its
    counts and the allocator's peak over the run, from a reset before the
    step's inputs exist."""
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))

    def body(d, mesh, dmesh):
        cfg = get_config(QWEN)
        torch.cuda.synchronize(d)
        base = torch.cuda.memory_allocated(d)
        torch.cuda.reset_peak_memory_stats(d)
        got = count(*make_inputs(cfg, Cell("train", *TRAIN[:2]), d,
                                 mesh=dmesh, mode=mode))
        torch.cuda.synchronize(d)
        peak = torch.cuda.max_memory_allocated(d) - base
        if is_main():
            with open(path, "w") as f:
                json.dump({"mesh": mesh.shape, "mode": mode, "real": got,
                           "allocated_peak_bytes": peak}, f)

    run_launched(mp, dev, body)


def phase_mesh_dryrun_vs_card() -> list:
    """``--sharded``'s fake trace of rank 0 against the real step on 4
    cards: FLOPs and each kind's collective bytes equal, the traced peak
    within ``PEAK_TOL`` of ``torch.cuda.max_memory_allocated``."""
    cards = torch.cuda.device_count()
    print(f"== --sharded: the dry-run of {QWEN}'s train step "
          f"{TRAIN[0]}x{TRAIN[1]} against the real step over {WIDE_CARDS} "
          f"cards")
    if cards < WIDE_CARDS:
        check(f"{WIDE_CARDS} cards for the dry-run against the real step",
              False, f"the machine shows {cards}")
        return []
    cfg, cell = get_config(QWEN), Cell("train", *TRAIN[:2])
    rows = []
    with tempfile.TemporaryDirectory(prefix="tcm-count-") as tmp:
        for mode, mp in COUNT_RUNS:
            shape = (WIDE_CARDS // mp, mp)
            fake = trace_step(cfg, cell, "cuda",
                              mesh=Mesh(("data", "model"), shape), mode=mode)
            path = os.path.join(tmp, f"count_{mode}.json")
            r = run_child(f"{QWEN} train step under the dry-run's counters, "
                          f"mesh {shape}, --mode {mode}",
                          [os.path.join(ROOT, "chip_smoke.py"), "--count",
                           mode, str(mp)], WIDE_CARDS, [path], tmp, path)
            if r is None:
                continue
            real, peak = r["real"], r["allocated_peak_bytes"]
            want = fake["memory_per_device"]["peak_live_bytes"]
            flops = (fake["hlo"]["per_device_flops"],
                     real["hlo"]["per_device_flops"])
            coll = (fake["hlo"]["collective_bytes"],
                    real["hlo"]["collective_bytes"])
            check(f"dry-run of rank 0 vs the real step, mesh {shape}, "
                  f"--mode {mode}", flops[0] == flops[1]
                  and coll[0] == coll[1]
                  and abs(want - peak) <= PEAK_TOL * peak,
                  f"FLOPs {flops[0]:.6g} traced vs {flops[1]:.6g} counted; "
                  f"collective bytes {coll[0]} traced vs {coll[1]}; peak "
                  f"{want} B traced vs {peak} B allocated "
                  f"({want / peak - 1:+.4f}; tracked on the card "
                  f"{real['memory_per_device']['peak_live_bytes']} B); "
                  f"trace {fake['hlo']['trace_s']} s")
            rows.append({"mesh": shape, "mode": mode, "fake": fake,
                         "real": real, "allocated_peak_bytes": peak,
                         "child_s": r["child_s"]})
    print(json.dumps({"dryrun_vs_cards": rows}))
    return rows


def one_device_qwen() -> tuple:
    """One-device ``launch.serve`` and ``launch.train`` (3 steps) at phase
    5's and phase 6's shapes, to hold phase 9 against: (served,
    trained)."""
    with tempfile.TemporaryDirectory(prefix="tcm-one-") as tmp:
        B, S = TRAIN[:2]
        train.main(["--arch", QWEN, "--global-batch", str(B), "--seq-len",
                    str(S), "--steps", str(SHARDED_TRAIN_STEPS),
                    "--log-every", "1", "--json",
                    os.path.join(tmp, "t.json")])
        torch.cuda.empty_cache()
        B, P, G = SERVE
        serve.main(["--arch", QWEN, "--batch", str(B), "--prompt-len",
                    str(P), "--gen", str(G), "--json",
                    os.path.join(tmp, "s.json")])
        with open(os.path.join(tmp, "s.json")) as fs, \
                open(os.path.join(tmp, "t.json")) as ft:
            return json.load(fs), json.load(ft)


# ``--sharded [PART...]``'s parts, in the order they run (all by default)
SHARDED_PARTS = ("qwen", "minitron", "moe", "hybrid", "dp", "vlm",
                 "kv_group", "dryrun")


def sharded_alone(parts=SHARDED_PARTS) -> int:
    """``--sharded``: phase 9's qwen runs over every card, held against
    one-device runs of ``launch.train`` (3 steps) and ``launch.serve`` at
    phase 6's and phase 5's shapes, then the wide runs (4 cards); of
    ``SHARDED_PARTS``, those of ``parts``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(parts) - set(SHARDED_PARTS)
    if unknown:
        print(f"chip_smoke: --sharded takes parts of {SHARDED_PARTS}, not "
              f"{sorted(unknown)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    if "qwen" in parts:
        served, trained = one_device_qwen()
        torch.cuda.empty_cache()
        phase_sharded(served, trained)
    if {"minitron", "moe"} & set(parts):
        phase_wide(parts)
    if {"hybrid", "dp", "vlm"} & set(parts):
        phase_wide_families(parts)
    if "kv_group" in parts:
        phase_kv_group()
    if "dryrun" in parts:
        phase_mesh_dryrun_vs_card()
    print(f"  --sharded {' '.join(parts)} took "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if FAILURES else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays IEEE
    phase_s = {}

    def timed(name: str, fn, *args):
        """``fn(*args)``, its seconds kept under ``name``; None once a
        phase has failed (the caller stops)."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"  phase {name}: {phase_s[name]:.1f} s")
        if FAILURES:
            print(f"phase {name} failed: {FAILURES}", file=sys.stderr)
        return out

    timed("1-2", lambda: (phase_environment(), phase_kernels()))
    if FAILURES:
        return 1
    main_path = timed("3", phase_main_path)
    if FAILURES:
        return 1
    timed("4", phase_service)
    if FAILURES:
        return 1
    served = timed("5", phase_served_model)
    if FAILURES:
        return 1
    # phase 8's twelve dry-run children trace on the host, one process a cell
    # (single-threaded): (b)'s and (e)'s as-reference trace beside phase 6
    # (prefill_32k alone takes minutes), (e)'s others beside phase 7;
    # phase 7b waits for all of them
    with tempfile.TemporaryDirectory(prefix="tcm-dryrun-") as tmp:
        cells, mesh = os.path.join(tmp, "cells"), os.path.join(tmp, "mesh")
        os.mkdir(cells)
        os.mkdir(mesh)
        procs = []
        try:
            tools = start_dryrun_cells(cells)
            as_ref = start_as_reference(mesh)
            procs += [p for *_, p in tools] + as_ref
            trained = timed("6", phase_training)
            if FAILURES:
                return 1
            meshes = start_mesh_dryrun(mesh, as_ref)
            procs += [p for *_, p in meshes[1]]
            timed("7", phase_evidence, get_config("qwen1_5_0_5b"))
            if FAILURES:
                return 1
            timed("wait", settle, procs, TOOLS_DRYRUN_TIMEOUT_S)
            mapper = timed("7b", phase_mapper_on_card)
            if FAILURES:
                return 1
            timed("8", phase_tools, tools, cells)
            if FAILURES:
                return 1
            timed("8e", phase_mesh_dryrun, meshes, mesh)
            if FAILURES:
                return 1
        finally:
            settle(procs, 0)
    timed("9", lambda: (phase_sharded(served, trained["run"]), phase_moe(),
                        phase_families()))
    if FAILURES:
        return 1

    print("== phase 10: kernels (times summed over the main path's unique "
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
    kernels.append(mapper["kernel"])
    print(json.dumps({"phase_s": phase_s}))
    print(f"  phases 1-10 took {time.perf_counter() - t_start:.1f} s")
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
    if sys.argv[1:2] == ["--sharded"]:
        sys.exit(sharded_alone(tuple(sys.argv[2:]) or SHARDED_PARTS))
    if sys.argv[1:2] == ["--qwen"]:
        qwen_child(sys.argv[2], [int(m) for m in sys.argv[3:]])
        sys.exit(0)
    if sys.argv[1:2] == ["--kvgroup"]:
        kv_group_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--families"]:
        families_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--count"]:
        count_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--vlm"]:
        vlm_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--moe"]:
        moe_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
        sys.exit(0)
    sys.exit(main())
