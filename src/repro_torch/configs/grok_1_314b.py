"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].
64L d=6144 48H kv=8 expert_ff=32768 v=131072; logit softcap 30.  FULL is
631 GB in bf16: the card serves SMOKE only."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    d_model=6144, n_layers=64, n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    head_dim=128, act="swiglu", norm="rms", tie_embeddings=True,
    logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="grok-1-314b", family="moe",
    d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=128, vocab=512,
    head_dim=16, act="swiglu", norm="rms", tie_embeddings=True,
    logit_softcap=30.0,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, capacity_factor=2.0),
)
