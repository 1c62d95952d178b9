"""Dense GEMM with a fused epilogue: the Level-3 BLAS kernel.

Replaces `repro/kernels/gemm.py` (`_gemm_kernel`, Pallas call at :184) in
its dense "kn" form: C = epi(A @ B [, A @ B2]) with A (M, K), B and B2
(K, N), in f32, bf16 and f64.  The CUDA kernel is `csrc/gemm.cu`, a
shared-memory tiled GEMM on the CUDA cores whose threads each own 4 x 4
register blocks (the paper's DOT4 PE); its source note says what bounds it
and how far it is from that.  Ragged edges are masked in the kernel, where
the reference pads in `ops._gemm_call`.

A packed B (`core.quant.QuantizedTensor`: int8 with f32 block scales, the
int8 body of `_gemm_kernel`, gemm.py:63-76) runs gemm.cu's int8-B variant
(`gemm_q8_launch`) in the "kn" layout (stored (K, N)) or the output-major
"nk" layout (stored (N, K), `QuantSpec.transpose`), dequantized in the
accumulator type on the way into shared memory.  `launch_int8` binds it
(its own launch count; `kernels/bgemm.py` reaches it too) and
`reference_int8` is its plain version.

`reference` and `reference_int8` are the plain PyTorch versions: CPU
tensors use them, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epilogue import make
from repro_torch.core.quant import dequantize_in
from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
launches = 0
#: launches of the int8-B variant through `launch_int8`
launches_int8 = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reference(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """C = epi(a @ b [, a @ b2]) in max(f32, dtype), cast once to a's dtype."""
    epi = make(activation, bias=bias, gate=b2, residual=residual)
    acc = torch.promote_types(torch.float32, a.dtype)
    af = a.to(acc)
    h = af @ b.to(acc)
    h2 = af @ b2.to(acc) if b2 is not None else None
    return epi.apply(h, acc2=h2, bias=bias, residual=residual).to(a.dtype)


def launch(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int):
    """Launch `gemm_launch` on the current stream; operands are validated
    CUDA tensors (kernels/ops.py), `out` is (M, N) and preallocated."""
    global launches
    m, k = a.shape
    n = b.shape[1]
    fn = _build.function("gemm_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(bias),
                 _build.ptr(residual), out.data_ptr(), m, k, n, act_code, stream)
    if err:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


_Q_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def reference_int8(a, qb, *, qb2=None, bias=None, residual=None, activation=None):
    """The int8-B kernel's plain version: B (and B2) dequantized in max(f32,
    a's dtype) in logical (K, N) orientation, then the dense plain version."""
    acc = torch.promote_types(torch.float32, a.dtype)
    b2 = None if qb2 is None else dequantize_in(qb2, acc)
    return reference(a, dequantize_in(qb, acc), b2=b2, bias=bias, residual=residual,
                     activation=activation)


def q8(a, qb, out, *, qb2, bias, residual, m: int, act_code: int, dtype_code: int):
    """Launch `gemm_q8_launch` on the current stream over m rows of a
    (the batch * M rows of bgemm's broadcast form); operands are validated
    CUDA tensors (kernels/ops.py)."""
    k, n = qb.shape
    qa, qbk = qb.block
    fn = _build.function("gemm_q8_launch", _Q_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), qb.values.data_ptr(), qb.scales.data_ptr(),
                 None if qb2 is None else qb2.values.data_ptr(),
                 None if qb2 is None else qb2.scales.data_ptr(), qa, qbk, int(qb.transposed),
                 _build.ptr(bias), _build.ptr(residual), out.data_ptr(), m, k, n, act_code,
                 stream)
    if err:
        raise RuntimeError(f"gemm int8 kernel launch failed: CUDA error {err}")
    return out


def launch_int8(a, qb, out, *, qb2, bias, residual, act_code: int, dtype_code: int):
    """C (M, N) = epi(A @ deq(B) [, A @ deq(B2)]): one int8-B launch, counted."""
    global launches_int8
    q8(a, qb, out, qb2=qb2, bias=bias, residual=residual, m=a.shape[0], act_code=act_code,
       dtype_code=dtype_code)
    launches_int8 += 1
    return out
