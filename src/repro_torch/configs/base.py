"""Model config schema (the dense, moe, rwkv, hybrid, vlm and audio subset
of `repro.configs.base`).

The port keeps its own copy so it imports nothing of the JAX package; the
fields and defaults are the reference's.  `torch_dtype` replaces the
reference's `jdtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "einsum"        # "einsum" (GShard baseline) | "gather" (sorted)
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    conv_kernel: int = 4
    expansion: int = 2
    head_dim: int = 64              # P
    n_groups: int = 1
    chunk: int = 64
    # Zamba-style hybrid: a single shared attention block applied every k
    # SSM blocks (0 = pure SSM stack)
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora_rank: int = 64
    chunk: int = 32


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (frontend stubbed to precomputed embeddings)."""
    n_layers: int = 32
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | rwkv | hybrid | vlm | audio
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rms"                # rms | ln
    use_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False
    rope_theta: float = 10000.0
    # stablelm publishes 25% partial rotary, but the reference rotates the
    # whole head and never reads this field; the port matches the reference
    rope_pct: float = 1.0
    tie_embeddings: bool = True
    embed_scale: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_prefix: int = 0                # vlm: number of (stub) patch-embedding tokens
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "model"
    weight_dtype: str = "model"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]
