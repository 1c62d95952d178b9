"""Dense GEMM with a fused epilogue: the Level-3 BLAS kernel.

Replaces `repro/kernels/gemm.py` (`_gemm_kernel`, Pallas call at :184) in
its dense "kn" form: C = epi(A @ B [, A @ B2]) with A (M, K), B and B2
(K, N), in f32, bf16 and f64.  The CUDA kernel is `csrc/gemm.cu`, a
shared-memory tiled GEMM on the CUDA cores whose threads each own 4 x 4
register blocks (the paper's DOT4 PE); its source note says what bounds it
and how far it is from that.  Ragged edges are masked in the kernel, where
the reference pads in `ops._gemm_call`.

`reference` is the plain PyTorch version: CPU tensors use it, and on the
card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epilogue import make
from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
launches = 0

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
