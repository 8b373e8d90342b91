"""TCM as a compile-time tile autotuner for the Hopper matmul kernels.

Each dtype route of ``kernels/csrc/matmul.cu`` has its own block-unit Arch
of one H100 SM for the mapper.  Tiles are searched in units of 64x64 blocks
(``wgmma`` takes 64 rows), so the rank shapes are divided by 64 before the
search and the chosen extents are scaled back.

- bf16 (:func:`_h100_wgmma`): HBM -> RF -> SMEM.  The ``wgmma`` kernel keeps
  the f32 accumulator Z in registers for the whole K loop and streams A and
  B through a ring of :data:`STAGES` shared-memory stages, so Z alone lives
  in RF and A, B alone in SMEM, both levels ``mandatory``.  RF comes first:
  with SMEM above it the mapper is free to put a k loop above Z's node and
  send partial sums back to HBM, which the kernel never does.
- f32 (:func:`_h100_sm`): the SIMT kernel, one ``mandatory`` SMEM level that
  holds A, B and the f32 accumulator Z in one capacity.

The kernel's tile is the extent each tensor holds below its own innermost
storage node (see :func:`_kernel_tile`), mapped onto the tiles the kernel
takes by :func:`wgmma_tile` and checked against :func:`smem_footprint`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

from .arch import Arch, MemLevel
from .einsum import Einsum, matmul
from .looptree import Loop, Storage
from .mapper import tcm_map

BLOCK = 64
SMEM_BYTES = 232_448  # dynamic shared memory one block may use (227 KB)
ACC_BYTES = 4  # f32 accumulator
# bf16 route (kernels/csrc/matmul.cu, wgmma): stages of the A/B ring that the
# plan's SMEM capacity is priced for, and the f32 accumulator the two
# consumer warpgroups hold in registers (2 x 128 threads x 128 registers)
STAGES = 4
ACC_ELEMS = 32_768
BARRIER_BYTES = 8  # one mbarrier
SMEM_ALIGN = 1024  # the 128-byte swizzle wants 1024-byte-aligned stages
WGMMA_BM = (128, 256, 512)  # tile rows above one 64-row wgmma tile

# H100 SXM datasheet values, taken as one SM's share of the card.
H100_SMS = 132
H100_HBM_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_SM_CLOCK_HZ = 1.98e9
H100_SMEM_BYTES_CLK = 128


def _h100_sm(smem_blocks: int, word_bytes: int = 2) -> Arch:
    """Block-unit model of one H100 SXM SM running the SIMT kernel: the
    'word' is a 64x64 tile and a 'MAC' is one 64x64x64 block product.

    HBM:    3.35 TB/s / 132 SMs / (word_bytes * 64^2)  (3.1e6 blocks/s, bf16)
    MMA:    989 TFLOP/s / 132 SMs / (2 * 64^3)          (1.4e7 block-MMAs/s)
    SMEM:   128 B/clk * 1.98 GHz / (word_bytes * 64^2)  (3.1e7 blocks/s, bf16)
    """
    block_bytes = word_bytes * BLOCK * BLOCK
    return Arch(
        name="h100-sm-blocks",
        levels=(
            MemLevel("HBM", float("inf"), 40.0, 40.0,
                     H100_HBM_BYTES_S / H100_SMS / block_bytes),
            MemLevel("SMEM", smem_blocks, 1.0, 1.0,
                     H100_SMEM_BYTES_CLK * H100_SM_CLOCK_HZ / block_bytes,
                     mandatory=True),
        ),
        mac_energy=0.2,
        frequency=H100_BF16_FLOPS / H100_SMS / (2 * BLOCK ** 3),
    )


def _h100_wgmma(smem_blocks: int) -> Arch:
    """Block-unit model of one H100 SXM SM running the bf16 ``wgmma``
    kernel, levels in the kernel's order HBM -> RF(Z) -> SMEM(A, B).

    HBM, MMA and SMEM rates are the datasheet anchors of :func:`_h100_sm`
    at 2-byte words.  RF: the tensor cores read and write the accumulator
    in place, one Z block each way per block product, so its bandwidth is
    set to twice the MMA block rate (a model value, not a datasheet one):
    it never binds before the MMA does.  Capacities: the :data:`ACC_ELEMS`
    f32 accumulators of Z the kernel holds in registers (8 blocks), and
    ``smem_blocks`` bf16 blocks of A and B per ring stage.
    """
    block_bytes = 2 * BLOCK * BLOCK
    mma = H100_BF16_FLOPS / H100_SMS / (2 * BLOCK ** 3)
    return Arch(
        name="h100-sm-wgmma-blocks",
        levels=(
            MemLevel("HBM", float("inf"), 40.0, 40.0,
                     H100_HBM_BYTES_S / H100_SMS / block_bytes),
            MemLevel("RF", ACC_ELEMS // BLOCK ** 2, 0.1, 0.1, 2 * mma,
                     allowed_tensors=("Z",), mandatory=True),
            MemLevel("SMEM", smem_blocks, 1.0, 1.0,
                     H100_SMEM_BYTES_CLK * H100_SM_CLOCK_HZ / block_bytes,
                     allowed_tensors=("A", "B"), mandatory=True),
        ),
        mac_energy=0.2,
        frequency=mma,
    )


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _round64(x: int) -> int:
    return -(-x // BLOCK) * BLOCK


def ring_stage_bytes(bm: int, bk: int, bn: int) -> int:
    """One stage of the bf16 kernel's A/B ring: a bm x bk slab of A and a
    bk x bn slab of B, each extent below 64 taken as one whole 64-wide TMA
    box (the hardware zero-fills past the tensor's edge)."""
    return 2 * _round64(bk) * (_round64(bm) + _round64(bn))


def ring_stages(bm: int, bk: int, bn: int,
                smem_bytes: int = SMEM_BYTES) -> int:
    """Stages the bf16 kernel runs at this tile: :data:`STAGES`, or fewer
    where they do not fit (a 512 x 64 A slab leaves room for 3).  The
    launcher picks them by the same rule (``Ring`` in csrc/matmul.cu); this
    is the planner's model of it."""
    per = ring_stage_bytes(bm, bk, bn) + 2 * BARRIER_BYTES
    return min(STAGES, max(smem_bytes - SMEM_ALIGN, 0) // per)


def smem_footprint(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Dynamic shared memory the matmul kernel asks for at tile (bm, bk, bn).

    bf16 (``in_bytes`` 2), the ``wgmma`` kernel: ``stages * (bm*bk + bk*bn)
    * 2`` for the ring (extents below 64 rounded up to a TMA box, stages
    from :func:`ring_stages`), a full and an empty barrier per stage, and
    the slack that aligns the ring to 1024 bytes.  The accumulator is in
    registers.  f32, the SIMT kernel: ``(bm*bk + bk*bn) * 4 + bm*bn*4``,
    one stage, each extent rounded up to a multiple of 4 as it lays the
    tiles out.
    """
    if in_bytes == 2:
        stages = ring_stages(bm, bk, bn)
        return (SMEM_ALIGN + stages * ring_stage_bytes(bm, bk, bn)
                + 2 * stages * BARRIER_BYTES)
    m, k, n = _round4(bm), _round4(bk), _round4(bn)
    return (m * k + k * n) * in_bytes + m * n * ACC_BYTES


def acc_elems(bm: int, bn: int) -> int:
    """f32 accumulators the bf16 kernel holds in registers for a bm x bn
    tile: a tile below 64 rows still fills one 64-row ``wgmma`` tile, and
    a width below 64 one 64-wide instruction."""
    return max(bm, BLOCK) * _round64(bn)


def wgmma_tile(bm: int, bk: int, bn: int) -> Tuple[int, int, int]:
    """The bf16 kernel's tile for a planned (bm, bk, bn): the one clamp
    between a plan and the kernel.

    The kernel takes bm <= 64 (one 64-row ``wgmma`` tile; rows past M are
    zero-filled) or bm in :data:`WGMMA_BM`; bk and bn multiples of 64, or
    below 64 multiples of 8 (TMA rows are 16-byte multiples; a bk below
    64 must also be the whole K, see :func:`kernel_takes`).  So bm above
    64 rounds down into ``WGMMA_BM`` (192 -> 128, 384 -> 256), bk and bn
    below 64 round up to a multiple of 8 (the caller pads the operands to
    the tile grid) and above 64 down to a multiple of 64.  Block-unit plans
    only ever need the rounding below 64 and the bm rule;
    :func:`kernel_takes` says whether the result fits.
    """
    def width(x: int) -> int:
        return -(-x // 8) * 8 if x < BLOCK else x // BLOCK * BLOCK

    if bm > BLOCK:
        bm = max([b for b in WGMMA_BM if b <= bm] or [BLOCK])
    return bm, width(bk), width(bn)


def kernel_takes(bm: int, bk: int, bn: int, K: int, in_bytes: int,
                 smem_bytes: int = SMEM_BYTES) -> bool:
    """Whether the matmul kernel of this dtype launches at (bm, bk, bn) on
    a reduction of length K.  bf16 stages 64-deep boxes of A and B, so a
    k step below 64 is taken only where it covers K (the caller pads K up
    to the step): over a longer K the kernel would not run the step asked
    for."""
    if min(bm, bk, bn) < 1:
        return False
    if in_bytes != 2:
        return smem_footprint(bm, bk, bn, in_bytes) <= smem_bytes
    return (wgmma_tile(bm, bk, bn) == (bm, bk, bn)
            and (bk >= BLOCK or bk >= K)
            and acc_elems(bm, bn) <= ACC_ELEMS
            and ring_stages(bm, bk, bn, smem_bytes) >= 2)


FA_MMA_BQ_MAX = 128  # bf16 tensor-core attention: 8 warps of 16 query rows
FA_MMA_BK = (64, 128)  # its kv tiles (compile-time instances)


def attention_tile(bq: int, bk: int, word_bytes: int = 2) -> Tuple[int, int]:
    """The attention kernel's (bq, bk) for a planned (query, kv) tile, as
    :func:`wgmma_tile` is the matmul's.

    bf16: a q tile below 16 rows takes the decode path, which runs one
    query row per block and takes any kv tile, so (bq, bk) stay.  From 16
    rows on, the tensor-core path gives each warp 16 rows, at most
    :data:`FA_MMA_BQ_MAX` rows a block, over a kv tile of 64 or 128 keys:
    bq rounds down to a multiple of 16 within that cap (256 -> 128), bk to
    128 from 128 on and to 64 below (a ragged last tile is masked).  f32:
    the SIMT kernel takes any tile whose shared memory fits, so (bq, bk)
    stay.
    """
    if word_bytes != 2 or bq < 16:
        return bq, bk
    return (min(bq, FA_MMA_BQ_MAX) // 16 * 16,
            FA_MMA_BK[1] if bk >= FA_MMA_BK[1] else FA_MMA_BK[0])


def smem_blocks_for(smem_bytes: int = SMEM_BYTES, word_bytes: int = 2) -> int:
    """SMEM capacity in 64x64 blocks.

    bf16: blocks of A and B one ring stage may hold, ``smem_bytes //
    (STAGES * 8192)`` (7 on an H100).  f32: the mapper charges every tensor
    one word per element, so every block is priced at the dearest tensor's
    block in :func:`smem_footprint`: an A/B operand block or a block of the
    f32 accumulator.
    """
    if word_bytes == 2:
        return smem_bytes // (STAGES * 2 * BLOCK * BLOCK)
    block = max(smem_footprint(BLOCK, BLOCK, 0, word_bytes),
                smem_footprint(BLOCK, 0, BLOCK, word_bytes))
    return smem_bytes // block


def plan_arch(smem_bytes: int = SMEM_BYTES, word_bytes: int = 2) -> Arch:
    """The Arch a plan of this dtype searches: bf16 runs the ``wgmma``
    kernel, anything else the SIMT kernel."""
    blocks = smem_blocks_for(smem_bytes, word_bytes)
    if word_bytes == 2:
        return _h100_wgmma(blocks)
    return _h100_sm(blocks, word_bytes)


def _tile_products(best, einsum, level: int = 1) -> Dict[str, int]:
    """Per-rank-var product of loop bounds below the first `level` storage
    node — the tile each VMEM block covers."""
    nodes = list(best.mapping)
    first = next(i for i, n in enumerate(nodes)
                 if isinstance(n, Storage) and n.level == level)
    out: Dict[str, int] = {v: 1 for v in einsum.rank_shapes}
    for n in nodes[first + 1:]:
        if isinstance(n, Loop):
            out[n.var] *= n.bound
    return out


def _held_extents(best, einsum) -> Dict[str, Dict[str, int]]:
    """Per tensor, the extent (in blocks) it holds in each of its ranks at
    its innermost storage node (Z in RF and A, B in SMEM on the bf16 arch,
    all three in SMEM on the f32 one): the product of the loops below that
    node.  Loops above it re-fill it; they do not grow it."""
    nodes = list(best.mapping)
    out: Dict[str, Dict[str, int]] = {}
    for t in einsum.tensors:
        at = max(i for i, n in enumerate(nodes)
                 if isinstance(n, Storage) and n.tensor == t.name)
        held = {v: 1 for v in t.rank_vars()}
        for n in nodes[at + 1:]:
            if isinstance(n, Loop) and n.var in held:
                held[n.var] *= n.bound
        out[t.name] = held
    return out


def _own_tile(held: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """The mapping's own (m, k, n) tile, in blocks: a block of the kernel
    owns one output tile and steps through K inside, so (m, n) is the
    accumulator Z's extent and k the slab that A and B both hold."""
    return {"m": held["Z"]["m"], "n": held["Z"]["n"],
            "k": min(held["A"]["k"], held["B"]["k"])}


def _kernel_tile(held: Dict[str, Dict[str, int]], fits) -> Dict[str, int]:
    """The matmul kernel's (m, k, n) tile, in blocks, from the held extents.

    The mapping's own tile (:func:`_own_tile`) if it ``fits``.  If not (the
    kernel loads a whole bk x bn slab of B where the mapping may stream it
    in parts), each rank takes the least extent among the tensors that
    carry it: every operand tile is then no larger than the mapping's,
    which fits by construction.
    """
    tile = _own_tile(held)
    if fits(tile):
        return tile
    least: Dict[str, int] = {}
    for ext in held.values():
        for v, e in ext.items():
            least[v] = min(least.get(v, e), e)
    return least


class TilePlan(NamedTuple):
    tiles: Tuple[int, int, int]  # (bm, bk, bn)
    # the modeled latency on one SM of the mapping whose own tile ``tiles``
    # is; None where it is not one (no mapping was found, or the least-extent
    # fallback or the kernel's tile clamp changed the mapping's tile)
    modeled_s: Optional[float]


def plan_einsum(M: int, K: int, N: int) -> Einsum:
    """The block-unit einsum a plan of Z[M,N] = A[M,K] @ B[K,N] searches:
    each dim in 64-wide blocks, at least one."""
    return matmul("mm", max(M // BLOCK, 1), max(K // BLOCK, 1),
                  max(N // BLOCK, 1))


def plan_from_mapping(best, einsum: Einsum, M: int, K: int, N: int,
                      smem_bytes: int = SMEM_BYTES,
                      word_bytes: int = 2) -> TilePlan:
    """The kernel's tile for the mapping ``best`` of the block-unit
    ``einsum`` (the shape's own :func:`plan_einsum`, or a larger one that
    covers it, such as a mapping service's bucket), and that mapping's
    modeled latency where the tile is the mapping's own.

    The tile is each tensor's held extent (:func:`_held_extents`), taken as
    the kernel's tile by :func:`_kernel_tile` where :func:`kernel_takes`
    accepts it, limited to the shape and clamped onto the kernel's tiles
    (:func:`wgmma_tile` in bf16).  ``best`` None (no mapping) gives one
    block per dim.
    """
    def limit(t):
        return (min(M, t["m"] * BLOCK), min(K, t["k"] * BLOCK),
                min(N, t["n"] * BLOCK))

    def clamp(t):
        return wgmma_tile(*limit(t)) if word_bytes == 2 else limit(t)

    if best is None:
        return TilePlan(clamp({"m": 1, "k": 1, "n": 1}), None)
    held = _held_extents(best, einsum)
    t = _kernel_tile(held, lambda t: kernel_takes(
        *clamp(t), K, word_bytes, smem_bytes))
    own = t == _own_tile(held) and clamp(t) == limit(t)
    return TilePlan(clamp(t), best.latency if own else None)


def tcm_matmul_plan(M: int, K: int, N: int,
                    smem_bytes: int = SMEM_BYTES,
                    word_bytes: int = 2) -> TilePlan:
    """Optimal SMEM tile for Z[M,N] = A[M,K] @ B[K,N] and its modeled
    latency (None where the tile is not the mapping's own).  Memoized per
    shape."""
    return _search_plan(M, K, N, smem_bytes, word_bytes)


@lru_cache(maxsize=None)
def _search_plan(M: int, K: int, N: int, smem_bytes: int,
                 word_bytes: int) -> TilePlan:
    # one cache entry per shape, however the caller spells the defaults
    ein = plan_einsum(M, K, N)
    best, _ = tcm_map(ein, plan_arch(smem_bytes, word_bytes),
                      objective="latency")
    return plan_from_mapping(best, ein, M, K, N, smem_bytes, word_bytes)


def tcm_matmul_tiles(M: int, K: int, N: int,
                     smem_bytes: int = SMEM_BYTES,
                     word_bytes: int = 2) -> Tuple[int, int, int]:
    """Optimal (bm, bk, bn) SMEM tile for Z[M,N] = A[M,K] @ B[K,N]: the
    tile of :func:`tcm_matmul_plan`.

    Falls back to 64-aligned minima when no mapping is found, and clamps
    each tile to its dimension (a dim below 64 is one block of its own
    size, rounded up to a multiple of 8 in bf16; see :func:`wgmma_tile`).
    """
    return tcm_matmul_plan(M, K, N, smem_bytes, word_bytes).tiles
