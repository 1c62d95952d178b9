"""Model-layer projections routed onto the batched kernels.

Mirrors the kernel routing of `repro.core.blas.matmul` / `matmul_fused`
(blas.py:451-592): a decode-shaped (..., 1, d) input is ONE broadcast-weight
bgemv launch that streams w in its stored (d, f) layout; any other input is
one bgemm launch with w broadcast across the batch.  The epilogue (bias,
activation, dual-GEMM gate, residual) is fused into that launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def matmul_fused(
    x: torch.Tensor,                          # (..., d)
    w: torch.Tensor,                          # (d, f)
    *,
    w2: Optional[torch.Tensor] = None,        # (d, f) dual-GEMM gate operand
    bias: Optional[torch.Tensor] = None,      # (f,)
    residual: Optional[torch.Tensor] = None,  # (..., f)
    activation: Optional[str] = None,         # "silu" | "gelu" | "relu"
) -> torch.Tensor:
    """y = act(x @ w + bias) [* (x @ w2)] [+ residual], one kernel launch."""
    lead = x.shape[:-1]
    d, f = w.shape
    if x.ndim >= 3 and x.shape[-2] == 1:
        # decode-shaped: y[b] = w^T x[b], w streamed in its stored layout
        rb = None if residual is None else residual.reshape(-1, f)
        out = ops.bgemv(w, x.reshape(-1, d), a2=w2, bias=bias, residual=rb,
                        activation=activation, transpose_a=True)
    else:
        # 2-D inputs run as a batch of one (the reference's 2-D gemm kernel
        # is not on this path)
        rows = x.shape[-2] if x.ndim >= 2 else 1
        rb = None if residual is None else residual.reshape(-1, rows, f)
        out = ops.bgemm(x.reshape(-1, rows, d), w, b2=w2, bias=bias,
                        residual=rb, activation=activation)
    return out.reshape(*lead, f)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f) -> (..., f) through the same routing."""
    return matmul_fused(x, w)
