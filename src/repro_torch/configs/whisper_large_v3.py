"""whisper-large-v3 — encoder-decoder; conv frontend STUBBED (precomputed
1500 frame embeddings) [arXiv:2212.04356].
32 enc + 32 dec layers, d=1280 20H kv=20 ff=5120 v=51866, GELU, LayerNorm+bias."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

FULL = ModelConfig(
    arch_id="whisper-large-v3", family="audio",
    d_model=1280, n_layers=32, n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    head_dim=64, act="gelu", norm="ln", use_bias=True, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
)

SMOKE = ModelConfig(
    dtype="float32",
    arch_id="whisper-large-v3", family="audio",
    d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    head_dim=16, act="gelu", norm="ln", use_bias=True, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=2, n_frames=16),
)
