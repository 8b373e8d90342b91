"""Kernel hook: whole-model SMEM tiles from one planner call.

The Hopper twin of ``network_blockspec_tiles`` in the reference planner,
which hard-wires the TPU tile search; this one asks
``core.autotile.tcm_matmul_tiles`` for the H100 SM's tiles.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.autotile import tcm_matmul_tiles
from ..models.config import ModelConfig
from .extract import LayerEinsum, extract_einsums


def _mkn(entry: LayerEinsum) -> Optional[Tuple[int, int, int]]:
    """(M, K, N) of a (possibly batched) matmul entry; None otherwise."""
    shapes = entry.einsum.rank_shapes
    if set(shapes) in ({"m", "k", "n"}, {"h", "m", "k", "n"}):
        return (shapes["m"], shapes["k"], shapes["n"])
    return None


def model_shapes(cfg: ModelConfig, mode: str = "prefill", batch: int = 1,
                 seq: int = 1024) -> Dict[str, Tuple[int, int, int]]:
    """``{"L<layer>.<op>": (M, K, N)}`` for every matmul of one forward pass
    (per head for the batched attention matmuls), keyed as
    :func:`model_tiles` keys its tiles."""
    out: Dict[str, Tuple[int, int, int]] = {}
    for entry in extract_einsums(cfg, mode=mode, batch=batch, seq=seq):
        dims = _mkn(entry)
        if dims is not None:
            label = ("head" if entry.layer < 0 else f"L{entry.layer}")
            out[f"{label}.{entry.op}"] = dims
    return out


def model_tiles(cfg: ModelConfig, mode: str = "prefill", batch: int = 1,
                seq: int = 1024, word_bytes: int = 2
                ) -> Dict[str, Tuple[int, int, int]]:
    """Matmul kernel tiles for every matmul of a model, in one call.

    Returns ``{"L<layer>.<op>": (bm, bk, bn)}`` (``"head.lm_head"`` for the
    LM head) — batched attention matmuls are tiled per head.  Unique shapes
    are searched once (``tcm_matmul_plan`` memoizes).
    """
    return {key: tcm_matmul_tiles(*dims, word_bytes=word_bytes)
            for key, dims in model_shapes(cfg, mode, batch, seq).items()}
