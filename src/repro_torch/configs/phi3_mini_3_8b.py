"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d=3072 32H (kv=32) ff=8192
vocab=32064, RoPE SwiGLU."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064,
)
