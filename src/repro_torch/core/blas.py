"""Level-1/2/3 BLAS and the model-layer projections, over the port's kernels.

Mirrors `repro.core.blas` under its "pallas" backend: every function sends
its tensors through `kernels.ops`, so CUDA tensors run the hand-written
kernels and CPU tensors their plain versions.  BLAS semantics (alpha/beta
scaling, accumulating into y/C) are functional: results are returned, never
written into an argument.  f32, bf16 and f64 throughout; sums run in
max(f32, dtype), and alpha/beta are applied after the kernel in the output
dtype, as the reference does.

Routing of the model-layer entry points (`matmul`, `matmul_fused`, as in
blas.py:451-592): a 1-D or 2-D input is one `gemm` launch; a decode-shaped
(..., 1, d) input is ONE broadcast-weight bgemv launch that streams w in
its stored (d, f) layout; any other input is one bgemm launch with w
broadcast across the batch.  The epilogue (bias, activation, dual-GEMM
gate, residual) is fused into that launch.

A block-scaled int8 weight (`core.quant.QuantizedTensor`, from
`models.layers.quantize_weights`) takes the same routes through the packed
kernels (blas.py:468-499, 539-570): decode-shaped inputs one packed bgemv
over the output-major stored rows, other 3-D inputs one packed bgemm, 2-D
inputs one packed gemm.  A packed weight NOT stored output-major is
dequantized to x's dtype for the decode route and runs the dense bgemv,
as the reference does.  `gemv`, `gemm` and `batched_gemm` take a packed A
or B in its stored layout and refuse the transpose flags.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import epilogue as _epilogue
from repro_torch.core import quant as _quant
from repro_torch.core.epilogue import Epilogue
from repro_torch.kernels import ops


def _epi_spec(epilogue, gate, bias, residual) -> Epilogue:
    """The spec from the user's epilogue (Epilogue | activation str | None)
    and the operands actually passed, which set its flags."""
    return _epilogue.make(_epilogue.as_epilogue(epilogue).activation,
                          bias=bias, gate=gate, residual=residual)


def _check_no_blas_params(epi: Epilogue, alpha, beta, C, what: str) -> None:
    if not epi.is_identity and (alpha != 1.0 or beta != 0.0 or C is not None):
        raise ValueError(
            f"{what}: alpha/beta/C accumulate-scaling cannot be combined with a "
            "fused epilogue (apply one or the other)"
        )


def _alpha_beta(out, alpha, beta, y):
    """alpha * out + beta * y, each product in out's dtype (`scal`), as
    the reference applies them after the kernel."""
    if alpha != 1.0:
        out = scal(alpha, out)
    if y is not None and beta != 0.0:
        out = out + scal(beta, y)
    return out


def _t(a: torch.Tensor) -> torch.Tensor:
    """The transpose of the last two axes, materialised for the kernels."""
    return a.transpose(-2, -1).contiguous()


# --------------------------------------------------------------------------
# Level 1
# --------------------------------------------------------------------------

def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ddot: x^T y, a 0-d tensor in x's dtype."""
    return ops.dot(x, y)


def nrm2(x: torch.Tensor) -> torch.Tensor:
    """dnrm2: sqrt(x^T x), a 0-d tensor in x's dtype."""
    return ops.nrm2(x)


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """daxpy: alpha * x + y."""
    return ops.axpy(alpha, x, y)


def scal(alpha, x: torch.Tensor) -> torch.Tensor:
    """alpha * x with alpha rounded to x's dtype first, as the reference."""
    return x * torch.tensor(alpha, dtype=x.dtype)


# --------------------------------------------------------------------------
# Level 2
# --------------------------------------------------------------------------

def gemv(A: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
         alpha=1.0, beta=0.0, trans: bool = False) -> torch.Tensor:
    """dgemv: y = alpha * op(A) x + beta * y (op = A or A^T).  trans=True
    materialises A^T before the kernel, as the reference does.  A packed A
    streams in its stored (m, n) layout: no trans, no transposed storage."""
    if _quant.is_quantized(A) and (trans or A.transposed):
        raise ValueError("quantized gemv streams A in its stored (m, n) layout; "
                         "quantize the transpose instead of passing trans=True")
    if trans:
        A = _t(A)
    return _alpha_beta(ops.gemv(A, x), alpha, beta, y)


def batched_gemv(A: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                 alpha=1.0, beta=0.0, trans: bool = False) -> torch.Tensor:
    """Batched dgemv: y[b] = alpha * op(A[b]) x[b] + beta * y[b] -> (batch,
    m), op = A or A^T (trans).  A is (batch, m, n), one matrix a member, or
    (m, n) broadcast across the batch (before trans); either is streamed in
    its stored layout by one bgemv launch, the op folded into the kernel.
    A packed A must be stored as the op (QuantSpec(transpose=trans))."""
    return _alpha_beta(ops.bgemv(A, x, transpose_a=trans), alpha, beta, y)


# --------------------------------------------------------------------------
# Level 3
# --------------------------------------------------------------------------

def _gemm_like(kernel, what, A, B, C, alpha, beta, transpose_a, transpose_b, B2, bias,
               residual, epilogue) -> torch.Tensor:
    """gemm's semantics over one kernel wrapper (ops.gemm or ops.bgemm):
    transposes materialised, the epilogue fused, alpha/beta/C after."""
    if _quant.is_quantized(B) and (transpose_a or transpose_b):
        raise ValueError(f"quantized {what} streams B in its stored layout; fold the "
                         "transpose into QuantSpec(transpose=...) instead")
    if transpose_a:
        A = _t(A)
    if transpose_b:
        B = _t(B)
        if B2 is not None:
            B2 = _t(B2)
    epi = _epi_spec(epilogue, B2, bias, residual)
    _check_no_blas_params(epi, alpha, beta, C, what)
    out = kernel(A, B, b2=B2, bias=bias, residual=residual, activation=epi.activation)
    return _alpha_beta(out, alpha, beta, C)


def gemm(A: torch.Tensor, B: torch.Tensor, C: Optional[torch.Tensor] = None, *,
         alpha=1.0, beta=0.0, transpose_a: bool = False, transpose_b: bool = False,
         B2: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, epilogue=None) -> torch.Tensor:
    """dgemm: C = alpha * op(A) op(B) + beta * C, or, with an epilogue,
    C = epilogue(op(A) op(B) [, op(A) op(B2)]) fused into the kernel.

    `epilogue` is an `Epilogue` or an activation name; `bias` (n,),
    `residual` (m, n) and the gate operand `B2` are applied to the
    accumulator before the one output write.  2-D operands only."""
    return _gemm_like(ops.gemm, "gemm", A, B, C, alpha, beta, transpose_a, transpose_b,
                      B2, bias, residual, epilogue)


def batched_gemm(A: torch.Tensor, B, C: Optional[torch.Tensor] = None, *,
                 alpha=1.0, beta=0.0, transpose_a: bool = False,
                 transpose_b: bool = False, out_dtype=None,
                 B2=None, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, epilogue=None) -> torch.Tensor:
    """C[b] = alpha * op(A[b]) op(B[b]) + beta * C[b], or the fused epilogue
    as `gemm`, in one bgemm launch for the whole batch.  B (and B2) is
    (batch, k, n), one per member (the MoE's expert stacks), or (k, n)
    broadcast across the batch, dense or packed.  The kernel writes the
    result in `out_dtype` (None: A's dtype), the accumulator rounded once;
    alpha/beta are applied after it in that dtype.  A 2-D B with A's dtype
    out (f32 or bf16) is one GEMM over the batch * m rows; every other form
    is bgemm's batched launch."""
    broadcast = B.ndim == 2 and out_dtype in (None, A.dtype) and A.dtype != torch.float64
    out = None if broadcast else (out_dtype or A.dtype)

    def kernel(a, b, **kw):
        return ops.bgemm(a, b, out_dtype=out, **kw)

    return _gemm_like(kernel, "batched_gemm", A, B, C, alpha, beta, transpose_a,
                      transpose_b, B2, bias, residual, epilogue)


# --------------------------------------------------------------------------
# Model-layer projections
# --------------------------------------------------------------------------

def matmul_fused(
    x: torch.Tensor,                          # (..., d)
    w,                                        # (d, f) tensor or QuantizedTensor
    *,
    w2=None,                                  # (d, f) dual-GEMM gate operand
    bias: Optional[torch.Tensor] = None,      # (f,)
    residual: Optional[torch.Tensor] = None,  # (..., f)
    activation: Optional[str] = None,         # "silu" | "gelu" | "relu"
) -> torch.Tensor:
    """y = act(x @ w + bias) [* (x @ w2)] [+ residual], one kernel launch."""
    lead = x.shape[:-1]
    d, f = w.shape
    if x.ndim <= 2:
        x2 = x.reshape(-1, d)
        r2 = None if residual is None else residual.reshape(x2.shape[0], f)
        out = ops.gemm(x2, w, b2=w2, bias=bias, residual=r2, activation=activation)
    elif x.shape[-2] == 1:
        # decode-shaped: y[b] = w^T x[b], w streamed in its stored layout
        # (packed: output-major rows; other packed storage dequantized first)
        rb = None if residual is None else residual.reshape(-1, f)
        if _quant.is_quantized(w) and not w.transposed:
            w = w.dequantize(x.dtype)
            w2 = None if w2 is None else w2.dequantize(x.dtype)
        out = ops.bgemv(w, x.reshape(-1, d), a2=w2, bias=bias, residual=rb,
                        activation=activation, transpose_a=True)
    else:
        rows = x.shape[-2]
        rb = None if residual is None else residual.reshape(-1, rows, f)
        out = ops.bgemm(x.reshape(-1, rows, d), w, b2=w2, bias=bias,
                        residual=rb, activation=activation)
    return out.reshape(*lead, f)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., d) @ w (d, f) -> (..., f) through the same routing."""
    return matmul_fused(x, w)
