"""Unified model configuration for all assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    d_conv: int = 4

    # hybrid (recurrentgemma): block pattern, e.g. ("rglru", "rglru", "attn")
    block_pattern: Tuple[str, ...] = ()
    window: int = 0  # local attention window (0 = full)
    rglru_dim: int = 0

    # encoder-decoder (audio family)
    is_encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stub: 'none' | 'patch' (vlm) | 'frames' (audio)
    frontend: str = "none"
    frontend_dim: int = 0  # embedding dim of precomputed frontend features

    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # unroll the layer stack instead of lax.scan: larger HLO, but sharded
    # stacked weights are consumed in place (no hoisted full-stack gather)
    unroll_layers: bool = False

    # sub-quadratic long-context support (for the long_500k shape)
    supports_long_context: bool = False

    # torch is imported lazily so config consumers that never build tensors
    # (the tile planner) start fast
    @property
    def torch_dtype(self):
        import torch

        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self):
        import torch

        return getattr(torch, self.param_dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (for smoke tests)."""
        return replace(self, **kw)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config: few layers, narrow width, small vocab."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256,
        vocab=512,
        remat=False,
    )
    if cfg.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_heads"] = 4
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 32
    if cfg.block_pattern:
        kw["n_layers"] = len(cfg.block_pattern)
        kw["rglru_dim"] = 128
        kw["window"] = min(cfg.window, 64) if cfg.window else 0
    if cfg.is_encdec:
        kw["enc_layers"] = 2
        kw["dec_layers"] = 2
        kw["n_layers"] = 4
    if cfg.frontend != "none":
        kw["frontend_dim"] = 64
    return cfg.scaled(**kw)
