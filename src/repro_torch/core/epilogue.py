"""Static epilogue specs for the fused projection kernels.

Mirrors `repro.core.epilogue`: an `Epilogue` declares the tail a kernel
applies to its accumulator before the one output write, and `apply` is the
single semantic definition the plain versions use.  Order, in accumulator
precision (f32 for f32/bf16 operands, f64 for the D-prefix routines):

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

#: activation name -> accumulator-precision callable
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

    @property
    def is_identity(self) -> bool:
        return not (self.activation or self.bias or self.gate or self.residual)

    def apply(self, acc, *, acc2=None, bias=None, residual=None):
        """The epilogue semantic in accumulator precision, max(f32, acc's
        dtype); `acc2`, `bias` and `residual` are cast up to it."""
        h = acc.to(torch.promote_types(torch.float32, acc.dtype))
        if self.bias:
            h = h + bias.to(h.dtype)
        if self.activation is not None:
            h = ACTIVATIONS[self.activation](h)
        if self.gate:
            h = h * acc2.to(h.dtype)
        if self.residual:
            h = h + residual.to(h.dtype)
        return h


def make(activation: Optional[str] = None, *, bias=None, gate=None,
         residual=None) -> Epilogue:
    """The spec from operand presence (args may be tensors or bools)."""
    return Epilogue(
        activation=activation,
        bias=bias is not None and bias is not False,
        gate=gate is not None and gate is not False,
        residual=residual is not None and residual is not False,
    )


def as_epilogue(spec) -> Epilogue:
    """An Epilogue passes through, a string is an activation-only spec,
    None is the identity."""
    if spec is None:
        return Epilogue()
    if isinstance(spec, Epilogue):
        return spec
    if isinstance(spec, str):
        return Epilogue(activation=spec)
    raise TypeError(f"epilogue must be Epilogue | str | None, got {type(spec)}")
