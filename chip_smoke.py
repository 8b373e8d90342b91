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
  4. one JSON line with each kernel's launches, error and times;
  5. the last line: {"ok": true, "device": {...}}.

Needs torch with CUDA, nvcc and one card; it fails without them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.autotile import tcm_matmul_plan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.matmul import (matmul_cuda,  # noqa: E402
                                        matmul_plain, wgmma_instance,
                                        wgmma_instances)
from repro_torch.kernels.ops import _pad_to, tcm_matmul  # noqa: E402
from repro_torch.kernels.ref import attention_ref, matmul_ref  # noqa: E402
from repro_torch.measure import (main_path_rows, run_model,  # noqa: E402
                                 time_call)

# H100 SXM datasheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
SMS = 132

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
    runs = [("prefill", 1, 1024), ("decode", 8, 1024)]
    driven = [(mode, *run_model(cfg, mode, batch, seq, dtype=torch.bfloat16,
                                seed=s))
              for s, (mode, batch, seq) in enumerate(runs)]
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

    print("== phase 4: kernels (times summed over the main path's unique "
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
    sys.exit(main())
