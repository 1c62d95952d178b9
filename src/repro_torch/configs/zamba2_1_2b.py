"""zamba2-1.2b — Mamba2 backbone + shared attention block w/ per-occurrence
LoRA [arXiv:2411.15242].  38 mamba blocks d=2048 ssm_state=64; shared block:
32H kv=32 head_dim=64, ff=8192; v=32000.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

FULL = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    d_model=2048, n_layers=38, n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    head_dim=64, act="gelu", norm="rms", tie_embeddings=True,
    ssm=SSMConfig(d_state=64, conv_kernel=4, expansion=2, head_dim=64,
                  n_groups=1, chunk=64, shared_attn_every=6,
                  shared_attn_lora_rank=128),
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="zamba2-1.2b", family="hybrid",
    d_model=64, n_layers=4, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    head_dim=16, act="gelu", norm="rms", tie_embeddings=True,
    ssm=SSMConfig(d_state=16, conv_kernel=4, expansion=2, head_dim=16,
                  n_groups=1, chunk=8, shared_attn_every=2,
                  shared_attn_lora_rank=8),
)
