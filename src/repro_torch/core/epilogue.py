"""Static epilogue specs for the fused projection kernels.

Mirrors `repro.core.epilogue`: an `Epilogue` declares the tail a kernel
applies to its f32 accumulator before the one output write, and `apply` is
the single semantic definition the plain versions use.  Order, in f32:

    h = acc + bias          (bias broadcast over rows)
    h = activation(h)       (silu | gelu (tanh form) | relu)
    h = h * acc2            (gate: dual-GEMM second accumulator, SwiGLU)
    h = h + residual        (skip connection)

The CUDA kernels apply the same order in `csrc/common.cuh`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

#: activation name -> f32 callable
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "relu": F.relu,
}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What the kernel does to the accumulator before the output write."""

    activation: Optional[str] = None  # "silu" | "gelu" | "relu" | None
    bias: bool = False
    gate: bool = False
    residual: bool = False

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(ACTIVATIONS)}, got {self.activation!r}"
            )

    def apply(self, acc, *, acc2=None, bias=None, residual=None):
        """The epilogue semantic in f32; `bias`/`residual` are cast up."""
        h = acc.float()
        if self.bias:
            h = h + bias.float()
        if self.activation is not None:
            h = ACTIVATIONS[self.activation](h)
        if self.gate:
            h = h * acc2.float()
        if self.residual:
            h = h + residual.float()
        return h
