"""rwkv6-1.6b — Finch, attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; heads = d/64 = 32 (head_dim 64).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

FULL = ModelConfig(
    arch_id="rwkv6-1.6b", family="rwkv",
    d_model=2048, n_layers=24, n_heads=32, n_kv=32, d_ff=7168, vocab=65536,
    head_dim=64, norm="ln", tie_embeddings=False,
    rwkv=RWKVConfig(head_dim=64, decay_lora_rank=64, chunk=32),
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="rwkv6-1.6b", family="rwkv",
    d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    head_dim=16, norm="ln", tie_embeddings=False,
    rwkv=RWKVConfig(head_dim=16, decay_lora_rank=8, chunk=8),
)
