"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 48L d=5120
40H (GQA kv=8) ff=8192, MoE 16 experts top-1, vocab=202048.

We model attention as global full attention (the released model's
chunked-attention/iRoPE long-context variant is out of scope; noted in
DESIGN.md — hence no long_500k cell)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048, n_experts=16, top_k=1,
)
