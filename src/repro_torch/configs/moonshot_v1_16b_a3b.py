"""moonshot-v1-16b-a3b — Moonlight (kimi): deepseek-style MoE, 64 experts
top-6 (+2 shared experts per HF config) [hf:moonshotai/Moonlight-16B-A3B].
48L d=2048 16H kv=16 expert_ff=1408 v=163840 (the reference's numbers)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe",
    d_model=2048, n_layers=48, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    head_dim=128, act="swiglu", norm="rms", tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, capacity_factor=1.25),
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="moonshot-v1-16b-a3b", family="moe",
    d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=96, vocab=512,
    head_dim=16, act="swiglu", norm="rms", tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                  n_shared_experts=1, capacity_factor=2.0),
)
