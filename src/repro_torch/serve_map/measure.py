"""Close the loop: served mappings -> CUDA kernel tiles -> time on the card.

The service's answers are *modeled*-optimal; this module checks them on
the card.  A mapping for the block-unit arch of one H100 SM
(``core.autotile.plan_arch``) is requested **through the service** —
exercising its hot path: bucketing, coalescing, hot index, persistent
cache — and turned into the kernel's tile by the same code as the offline
plan (``core.autotile.plan_from_mapping``).  The kernel is then timed with
CUDA events (``repro_torch.measure.time_call``) against the default
128-cube tiling, and the report carries the measured-vs-modeled ratio.

``run_tile_load`` drives the service with the traffic this route sends it:
the tile requests of a model's forward passes at drawn batch sizes and
ragged lengths (``tile_request_shapes``), from many client threads.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(then the kernels' plain versions run and times come from the host clock;
such rows say ``"device": "cpu"`` and are never compared for speed).
"""
from __future__ import annotations

import random
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.autotile import (TilePlan, kernel_takes, plan_arch, plan_einsum,
                             plan_from_mapping)
from ..core.search import einsum_key
from ..measure import (_randn, resolve_device, score_tiles,
                       time_flash_attention, time_matmul)
from ..netmap.planner import model_shapes
from .request import MapRequest, MapResponse
from .service import MappingService

__all__ = ["service_matmul_tiles", "measure_matmul",
           "measure_flash_attention", "tile_request_shapes", "run_tile_load"]

Shape = Tuple[int, int, int]


def service_matmul_tiles(service: MappingService, M: int, K: int, N: int,
                         *, word_bytes: int = 2,
                         deadline_s: Optional[float] = None,
                         allow_bucketed: bool = True,
                         ) -> Tuple[TilePlan, MapResponse]:
    """The kernel's tile plan for ``Z[M,N] = A[M,K] @ B[K,N]`` via the
    service, and the service's response (source, gap_bound, latency).

    The online twin of ``core.autotile.tcm_matmul_plan``: the same
    block-unit einsum and arch and the latency objective, but the mapping
    comes from ``service.map`` — so a repeated shape is a hot-index hit,
    and with ``allow_bucketed`` a novel shape can ride a bucket.  A
    bucketed answer maps a larger einsum; its tile is limited to the shape
    and clamped onto the kernel's like any other, and its ``modeled_s`` is
    None (it is the latency of the bucket).
    """
    ein = plan_einsum(M, K, N)
    resp = service.map(MapRequest(einsum=ein,
                                  arch=plan_arch(word_bytes=word_bytes),
                                  objective="latency", deadline_s=deadline_s,
                                  allow_bucketed=allow_bucketed))
    plan = plan_from_mapping(resp.result, resp.served_einsum, M, K, N,
                             word_bytes=word_bytes)
    if resp.bucketed:
        plan = plan._replace(modeled_s=None)
    return plan, resp


def _provenance(row: dict, resp: MapResponse) -> dict:
    """The row's mapping columns from the service's response."""
    row.update(map_source=resp.source, map_latency_ms=resp.latency_s * 1e3,
               gap_bound=resp.gap_bound)
    return row


def measure_matmul(service: MappingService, M: int = 512, K: int = 512,
                   N: int = 512, *, repeats: int = 3, device: str = "cuda",
                   dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, return_out: bool = False):
    """Time the service-tiled matmul (``ops.tcm_matmul``) vs the default
    128-cube tiling, on random operands made from ``seed``.  With
    ``return_out``, also the output of the timed call at the served tile
    (``(row, out)``)."""
    dev = resolve_device(device)
    plan, resp = service_matmul_tiles(service, M, K, N,
                                      word_bytes=dtype.itemsize)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = _randn((M, K), dtype, dev, gen)
    b = _randn((K, N), dtype, dev, gen)
    row, out = time_matmul(a, b, plan.tiles, plan.modeled_s, t_map=0.0,
                           repeats=repeats)
    row = _provenance(row, resp)
    return (row, out) if return_out else row


def measure_flash_attention(service: MappingService, B: int = 1,
                            H: int = 4, Sq: int = 256, Sk: int = 256,
                            Dh: int = 128, *, causal: bool = False,
                            repeats: int = 3, device: str = "cuda",
                            dtype: torch.dtype = torch.bfloat16,
                            seed: int = 1, return_out: bool = False):
    """Time flash attention (``ops.flash_attention_op``) with
    service-chosen (bq, bk) vs default 128s; with ``return_out``, also the
    output of the timed call at the served tiles (``(row, out)``).

    The score matmul ``S = Q @ K^T`` (per head: M=Sq, K=Dh, N=Sk) drives
    the tiling: the service's bm becomes the query tile and bn the kv tile,
    mapped onto the kernel's tiles (``measure.score_tiles``).
    """
    dev = resolve_device(device)
    plan, resp = service_matmul_tiles(service, Sq, Dh, Sk,
                                      word_bytes=dtype.itemsize)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn((B, Sq, H, Dh), dtype, dev, gen)
    k = _randn((B, Sk, H, Dh), dtype, dev, gen)
    v = _randn((B, Sk, H, Dh), dtype, dev, gen)
    row, out = time_flash_attention(
        q, k, v, score_tiles(plan, Sq, Sk, dtype.itemsize), plan.modeled_s,
        causal=causal, t_map=0.0, repeats=repeats)
    row = _provenance(row, resp)
    return (row, out) if return_out else row


# --------------------------------------------------------------------------
# The route's own traffic
# --------------------------------------------------------------------------


# the route's traffic: one pass in eight is a prefill, the rest decode
# steps; batches and lengths as the reference load generator draws them
PREFILL_SHARE = 0.125
BATCHES = (1, 2, 4, 8)
SEQ_RANGE = (16, 1024)
DEADLINE_S = 0.25  # the reference bench's default
WORD_BYTES = 2  # the bf16 kernels


def tile_request_shapes(cfg, *, requests: int = 2000,
                        seed: int = 0) -> List[Shape]:
    """``requests`` matmul shapes (M, K, N), in the order a fleet serving
    ``cfg`` asks for their tiles.  Each draw is one forward pass: with
    probability :data:`PREFILL_SHARE` a prefill of one prompt whose length
    is drawn from :data:`SEQ_RANGE`, else a decode step of a batch drawn
    from :data:`BATCHES` over a kv cache whose length is drawn from
    :data:`SEQ_RANGE`.  A pass contributes each of its unique matmul
    shapes once (``netmap.planner.model_shapes``, lm_head included).
    Deterministic for a fixed ``seed``."""
    rng = random.Random(seed)
    memo: Dict[tuple, List[Shape]] = {}
    out: List[Shape] = []
    while len(out) < requests:
        if rng.random() < PREFILL_SHARE:
            mode, batch = "prefill", 1
        else:
            mode, batch = "decode", rng.choice(BATCHES)
        seq = rng.randint(*SEQ_RANGE)
        key = (mode, batch, seq)
        if key not in memo:
            memo[key] = list(dict.fromkeys(
                model_shapes(cfg, mode, batch, seq).values()))
        out.extend(memo[key][:requests - len(out)])
    rng.shuffle(out)
    return out


def _quantile(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, max(0, int(p * (len(xs) - 1) + 0.5)))]


def run_tile_load(service: MappingService, shapes: Sequence[Shape], *,
                  clients: int = 8, warmup: bool = True,
                  stampede: Optional[Shape] = None) -> dict:
    """Serve ``shapes`` through :func:`service_matmul_tiles` (bf16,
    bucketing allowed, each request under :data:`DEADLINE_S`) from
    ``clients`` threads that drain them in order; return the report.

    ``warmup`` first asks, one at a time and without a deadline, for one
    shape of every bucket, so the timed phase measures the steady state.
    ``stampede`` is a shape every client asks for at once before the timed
    phase (a cold one, so coalescing shows).  The report carries the
    service's answer time (``p50_ms``/``p99_ms``, ``hit_*`` for hits), the
    time until the caller holds the kernel's tile (``tile_*``: the answer
    and :func:`~repro_torch.core.autotile.plan_from_mapping`), answer
    sources, deadline-met ratio, searches in the timed phase, the tiles the
    kernel would refuse (``refused``, by ``kernel_takes``), the stampede's
    coalescing ratio, and ``served``: the last tile and source per
    distinct shape.
    """
    t0 = time.perf_counter()
    searches = service.stats.searches
    buckets = set()
    for shp in shapes:
        bucket, _ = service.bucketer.bucket_einsum(plan_einsum(*shp))
        k = einsum_key(bucket)
        if k not in buckets:
            buckets.add(k)
            if warmup:
                service_matmul_tiles(service, *shp, word_bytes=WORD_BYTES)
    service.drain_warm()
    warm_s = time.perf_counter() - t0
    warm_searches = service.stats.searches - searches

    rows: List[tuple] = []
    served: Dict[Shape, tuple] = {}
    lock = threading.Lock()
    errors: List[BaseException] = []
    idx = {"i": 0}
    barrier = threading.Barrier(clients)
    herd: List[str] = []

    def ask(shp: Shape) -> None:
        t = time.perf_counter()
        plan, resp = service_matmul_tiles(service, *shp,
                                          word_bytes=WORD_BYTES,
                                          deadline_s=DEADLINE_S)
        t_tile = time.perf_counter() - t
        takes = kernel_takes(*plan.tiles, shp[1], WORD_BYTES)
        with lock:
            rows.append((resp.latency_s, t_tile, resp.source,
                         resp.deadline_met, resp.gap_bound, takes))
            served[shp] = (plan.tiles, resp.source)

    def worker() -> None:
        try:
            barrier.wait()
            if stampede is not None:
                _, resp = service_matmul_tiles(service, *stampede,
                                               word_bytes=WORD_BYTES)
                with lock:
                    herd.append(resp.source)
            while True:
                with lock:
                    i = idx["i"]
                    if i >= len(shapes):
                        return
                    idx["i"] = i + 1
                ask(shapes[i])
        except BaseException as e:  # surfaced to the caller below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=worker, name=f"tile-load-{i}")
               for i in range(clients)]
    searches = service.stats.searches
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    n = len(rows)
    lat = sorted(r[0] for r in rows)
    tile = sorted(r[1] for r in rows)
    hit = sorted(r[0] for r in rows if r[2] in ("exact-hit", "bucket-hit"))
    report = {
        "requests": n, "clients": clients,
        "unique_shapes": len(set(shapes)), "unique_buckets": len(buckets),
        "warmup_s": warm_s, "warmup_searches": warm_searches,
        "elapsed_s": elapsed, "rps": n / elapsed if elapsed > 0 else 0.0,
        "p50_ms": _quantile(lat, 0.50) * 1e3,
        "p99_ms": _quantile(lat, 0.99) * 1e3,
        "hit_p50_ms": _quantile(hit, 0.50) * 1e3,
        "hit_p99_ms": _quantile(hit, 0.99) * 1e3,
        "tile_p50_ms": _quantile(tile, 0.50) * 1e3,
        "tile_p99_ms": _quantile(tile, 0.99) * 1e3,
        "hits": len(hit),
        "sources": dict(Counter(r[2] for r in rows)),
        "deadline_met_ratio": (sum(1 for r in rows if r[3]) / n
                               if n else 1.0),
        "max_gap_bound": max((r[4] for r in rows), default=1.0),
        "refused": sum(1 for r in rows if not r[5]),
    }
    if stampede is not None:
        s, c = herd.count("search"), herd.count("coalesced")
        report.update(stampede_searches=s, stampede_coalesced=c,
                      coalesce_ratio=c / max(1, c + s))
    report["searches"] = (service.stats.searches - searches
                          - herd.count("search"))
    report["served"] = served
    return report
