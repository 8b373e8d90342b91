"""Assigned architecture configs (``--arch <id>``).

Each module defines ``CONFIG`` (the full published configuration) built from
public sources noted inline.  ``get_config(name)`` resolves by id;
``ARCHS`` lists all ids; ``SHAPES`` defines the assigned input-shape cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig, smoke_config

ARCHS = (
    "qwen1_5_0_5b",
    "minitron_8b",
    "yi_34b",
    "phi3_mini_3_8b",
    "mamba2_130m",
    "phi3_5_moe_42b",
    "llama4_scout_17b",
    "llava_next_34b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
)

# canonical ids from the assignment -> module names
ALIASES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "minitron-8b": "minitron_8b",
    "yi-34b": "yi_34b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mamba2-130m": "mamba2_130m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "llava-next-34b": "llava_next_34b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = import_module(f".{mod_name}", __name__)
    cfg: ModelConfig = mod.CONFIG
    return smoke_config(cfg) if smoke else cfg


def cells_for(cfg: ModelConfig):
    """The shape cells this arch runs; long_500k only for sub-quadratic
    state (SSM / hybrid) — skips are recorded in DESIGN.md."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
