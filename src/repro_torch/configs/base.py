"""Model config schema (the dense subset of `repro.configs.base`).

The port keeps its own copy so it imports nothing of the JAX package; the
fields and defaults are the reference's.  `torch_dtype` replaces the
reference's `jdtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense (the only family ported so far)
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu
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
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "model"
    weight_dtype: str = "model"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]
