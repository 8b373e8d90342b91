"""recurrentgemma-2b [arXiv:2402.19427]: 26L d=2560 10H (GQA kv=1) ff=7680
vocab=256000; RG-LRU + local attention 1:2 (2 recurrent : 1 local-attn),
window 2048.  State is O(width) -> runs long_500k."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "wattn"), window=2048,
    rglru_dim=2560, tie_embeddings=True,
    supports_long_context=True,
)
