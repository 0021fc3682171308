"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT frontend STUBBED (precomputed patch embeddings) +
Qwen2-style LM backbone [arXiv:2404.16821; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, head_dim=64, act="swiglu", tie_embeddings=True,
    frontend="vision", frontend_seq=256,
)
