"""paligemma-3b — gemma-2b backbone + SigLIP frontend (stubbed: precomputed
patch embeddings) [arXiv:2407.07726].
18L d=2048 8H kv=1 (MQA) head_dim=256 ff=16384 v=257216; 256 patch tokens."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="paligemma-3b", family="vlm",
    d_model=2048, n_layers=18, n_heads=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, act="geglu", norm="rms", tie_embeddings=True,
    embed_scale=True, n_prefix=256,
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="paligemma-3b", family="vlm",
    d_model=64, n_layers=2, n_heads=4, n_kv=1, d_ff=128, vocab=512,
    head_dim=16, act="geglu", norm="rms", tie_embeddings=True,
    embed_scale=True, n_prefix=8,
)
