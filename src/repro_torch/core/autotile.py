"""TCM as a compile-time tile autotuner for the Hopper matmul kernel.

The HBM->SMEM hierarchy of one H100 SM is a two-level Arch for the mapper.
Tiles are searched in units of 64x64 blocks (``wgmma`` takes 64 rows; a
128-unit block would leave only 3-7 blocks in 227 KB), so the rank shapes
are divided by 64 before the search and the chosen extents are scaled back.

The SMEM level is ``mandatory``: A, B and the f32 accumulator Z all hold a
tile there, and all three are charged against one capacity.  The kernel's
tile is the extent each tensor actually holds below its *own* SMEM storage
node (see :func:`_kernel_tile`), checked against the kernel's
:func:`smem_footprint`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

from .arch import Arch, MemLevel
from .einsum import matmul
from .looptree import Loop, Storage
from .mapper import tcm_map

BLOCK = 64
SMEM_BYTES = 232_448  # dynamic shared memory one block may use (227 KB)
ACC_BYTES = 4  # f32 accumulator
STAGES = 1  # SMEM buffers per operand tile in kernels/csrc/matmul.cu

# H100 SXM datasheet values, taken as one SM's share of the card.
H100_SMS = 132
H100_HBM_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_SM_CLOCK_HZ = 1.98e9
H100_SMEM_BYTES_CLK = 128


def _h100_sm(smem_blocks: int, word_bytes: int = 2) -> Arch:
    """Block-unit model of one H100 SXM SM: the 'word' is a 64x64 tile and
    a 'MAC' is one 64x64x64 block product.

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


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def smem_footprint(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Dynamic shared memory the matmul kernel asks for at tile (bm, bk, bn):
    ``STAGES * (bm*bk + bk*bn) * in_bytes + bm*bn*4``, each extent rounded up
    to a multiple of 4 as the kernel lays the tiles out."""
    m, k, n = _round4(bm), _round4(bk), _round4(bn)
    return STAGES * (m * k + k * n) * in_bytes + m * n * ACC_BYTES


def smem_blocks_for(smem_bytes: int = SMEM_BYTES, word_bytes: int = 2) -> int:
    """SMEM capacity in 64x64 blocks.  The mapper charges every tensor one
    word per element, so every block is priced at the dearest tensor's
    block in :func:`smem_footprint`: an A/B operand block or a block of the
    f32 accumulator."""
    block = max(smem_footprint(BLOCK, BLOCK, 0, word_bytes),
                smem_footprint(BLOCK, 0, BLOCK, word_bytes))
    return smem_bytes // block


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


def _held_extents(best, einsum, level: int = 1) -> Dict[str, Dict[str, int]]:
    """Per tensor, the extent (in blocks) it holds in each of its ranks at
    `level`: the product of the loops below its *own* storage node there.
    Loops above that node re-fill it; they do not grow it."""
    nodes = list(best.mapping)
    out: Dict[str, Dict[str, int]] = {}
    for t in einsum.tensors:
        at = next(i for i, n in enumerate(nodes)
                  if isinstance(n, Storage) and n.level == level
                  and n.tensor == t.name)
        held = {v: 1 for v in t.rank_vars()}
        for n in nodes[at + 1:]:
            if isinstance(n, Loop) and n.var in held:
                held[n.var] *= n.bound
        out[t.name] = held
    return out


def _kernel_tile(held: Dict[str, Dict[str, int]], fits) -> Dict[str, int]:
    """The matmul kernel's (m, k, n) tile, in blocks, from the held extents.

    A block of the kernel owns one output tile and steps through K inside,
    so (m, n) is the accumulator Z's extent and k the slab that A and B
    both hold.  If that tile does not ``fits`` (the kernel loads a whole
    bk x bn slab of B where the mapping may stream it in parts), each rank
    takes the least extent among the tensors that carry it: every operand
    tile is then no larger than the mapping's, which fits by construction.
    """
    tile = {"m": held["Z"]["m"], "n": held["Z"]["n"],
            "k": min(held["A"]["k"], held["B"]["k"])}
    if fits(tile):
        return tile
    least: Dict[str, int] = {}
    for ext in held.values():
        for v, e in ext.items():
            least[v] = min(least.get(v, e), e)
    return least


class TilePlan(NamedTuple):
    tiles: Tuple[int, int, int]  # (bm, bk, bn)
    modeled_s: Optional[float]  # the mapping's latency on one SM's model


def tcm_matmul_plan(M: int, K: int, N: int,
                    smem_bytes: int = SMEM_BYTES,
                    word_bytes: int = 2) -> TilePlan:
    """Optimal SMEM tile for Z[M,N] = A[M,K] @ B[K,N] and its modeled
    latency (None on the fallback tile).  Memoized per shape."""
    return _search_plan(M, K, N, smem_bytes, word_bytes)


@lru_cache(maxsize=None)
def _search_plan(M: int, K: int, N: int, smem_bytes: int,
                 word_bytes: int) -> TilePlan:
    # one cache entry per shape, however the caller spells the defaults
    mb = max(M // BLOCK, 1)
    kb = max(K // BLOCK, 1)
    nb = max(N // BLOCK, 1)
    ein = matmul("mm", mb, kb, nb)
    arch = _h100_sm(smem_blocks_for(smem_bytes, word_bytes), word_bytes)
    best, _ = tcm_map(ein, arch, objective="latency")
    if best is None:
        return TilePlan((min(M, BLOCK), min(K, BLOCK), min(N, BLOCK)), None)

    def clamp(t):
        return (min(M, t["m"] * BLOCK), min(K, t["k"] * BLOCK),
                min(N, t["n"] * BLOCK))

    t = _kernel_tile(_held_extents(best, ein), lambda t: smem_footprint(
        *clamp(t), word_bytes) <= smem_bytes)
    return TilePlan(clamp(t), best.latency)


def tcm_matmul_tiles(M: int, K: int, N: int,
                     smem_bytes: int = SMEM_BYTES,
                     word_bytes: int = 2) -> Tuple[int, int, int]:
    """Optimal (bm, bk, bn) SMEM tile for Z[M,N] = A[M,K] @ B[K,N]: the
    tile of :func:`tcm_matmul_plan`.

    Falls back to 64-aligned minima when no mapping is found, and clamps
    each tile to its dimension (a dim below 64 is one block of its own
    size).
    """
    return tcm_matmul_plan(M, K, N, smem_bytes, word_bytes).tiles
