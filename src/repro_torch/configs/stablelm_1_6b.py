"""stablelm-1.6b — stablelm-2: LayerNorm, qkv bias, 25% partial rotary
[hf:stabilityai/stablelm-2-1_6b].  24L d=2048 32H kv=32 ff=5632 v=100352."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="stablelm-1.6b", family="dense",
    d_model=2048, n_layers=24, n_heads=32, n_kv=32, d_ff=5632, vocab=100352,
    head_dim=64, act="swiglu", norm="ln", use_bias=True, rope_pct=0.25,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="stablelm-1.6b", family="dense",
    d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    head_dim=16, act="swiglu", norm="ln", use_bias=True, rope_pct=0.25,
    tie_embeddings=False,
)
