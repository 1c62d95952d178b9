"""Broadcast-weight batched GEMM: the prefill projection kernel.

Replaces `repro/kernels/bgemm.py` (`_bgemm_kernel`, Pallas call at :217) in
the broadcast-B "kn" form the prefill path uses: C[b] = epi(A[b] @ B
[, A[b] @ B2]).  With A contiguous this is one GEMM over the batch * M rows,
so the CUDA entry point `bgemm_launch` runs the dense GEMM kernel of
`csrc/gemm.cu` (a shared-memory tiled GEMM on the CUDA cores) over them;
that source note says what bounds it (the tensor-core rate) and how far it
is from that.  It keeps its own entry point and launch count.

A packed B (`core.quant.QuantizedTensor`, the int8 body of
`_bgemm_kernel`, bgemm.py:80-90, "kn" or the output-major "nk" layout of
`serve --quantize int8`) runs gemm.cu's int8-B variant over the same batch
* M rows (`launch_int8`, its own launch count); `reference_int8` is its
plain version.

`reference` and `reference_int8` are the plain PyTorch versions: CPU
tensors use them, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.quant import dequantize_in
from repro_torch.kernels import _build
from repro_torch.kernels import gemm as _gemm

#: launches of the CUDA kernel in this process
launches = 0
#: launches of the int8-B variant through `launch_int8`
launches_int8 = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def reference(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """C = epi(a @ b [, a @ b2]) in f32, cast once to a's dtype."""
    epi = Epilogue(activation, bias is not None, b2 is not None, residual is not None)
    af = a.float()
    acc = af @ b.float()
    acc2 = af @ b2.float() if b2 is not None else None
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(a.dtype)


def launch(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int):
    """Launch `bgemm_launch` on the current stream; operands are validated
    CUDA tensors (kernels/ops.py), `out` is (batch, M, N) and preallocated."""
    global launches
    batch, m, k = a.shape
    n = b.shape[1]
    fn = _build.function("bgemm_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(bias),
                 _build.ptr(residual), out.data_ptr(), batch, m, k, n, act_code,
                 stream)
    if err:
        raise RuntimeError(f"bgemm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def reference_int8(a, qb, *, qb2=None, bias=None, residual=None, activation=None):
    """The int8-B kernel's plain version: B (and B2) dequantized in f32 (the
    accumulator of f32 and bf16 operands) in logical (K, N) orientation,
    then the dense plain version."""
    b2 = None if qb2 is None else dequantize_in(qb2, torch.float32)
    return reference(a, dequantize_in(qb, torch.float32), b2=b2, bias=bias,
                     residual=residual, activation=activation)


def launch_int8(a, qb, out, *, qb2, bias, residual, act_code: int, dtype_code: int):
    """C[b] = epi(A[b] @ deq(B) [, A[b] @ deq(B2)]): one int8-B launch over
    the batch * M rows, counted."""
    global launches_int8
    batch, m, _ = a.shape
    _gemm.q8(a, qb, out, qb2=qb2, bias=bias, residual=residual, m=batch * m,
             act_code=act_code, dtype_code=dtype_code)
    launches_int8 += 1
    return out
