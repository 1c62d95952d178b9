"""Dense GEMV: the Level-2 BLAS kernel.

Replaces `repro/kernels/gemv.py` (`_gemv_kernel`, Pallas call at :146) in
its dense form: y = A x with A (M, N) row-major, in f32, bf16 and f64.  The
CUDA kernel is `csrc/gemv.cu`; its source note says what bounds it (A over
HBM) and how (one or more warps per row, 16-byte loads along the row).

A packed A (`core.quant.QuantizedTensor`, stored (M, N) int8 with block
scales; the int8 body of `_gemv_kernel`, gemv.py:89-90) runs the packed
row-dot kernel `csrc/qgemv.cu` at batch 1 (`launch_int8`, its own launch
count); `reference_int8` is its plain version.  The output is in x's dtype,
summed in max(f32, x's dtype).

`reference` and `reference_int8` are the plain PyTorch versions: CPU
tensors use them, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import dequantize_in
from repro_torch.kernels import _build
from repro_torch.kernels import bgemv as _bgemv

#: the warps-a-row rule of csrc/gemv.cu (shared with the op = A bgemv body)
warps_per_row = _bgemv.warps_per_row

#: launches of the CUDA kernel in this process
launches = 0
#: launches of the packed kernel (csrc/qgemv.cu) through `launch_int8`
launches_int8 = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reference(a, x):
    """y = a @ x in max(f32, dtype), cast once to a's dtype."""
    acc = torch.promote_types(torch.float32, a.dtype)
    return (a.to(acc) @ x.to(acc)).to(a.dtype)


def launch(a, x, out, *, dtype_code: int):
    """Launch `gemv_launch` on the current stream; operands are validated
    CUDA tensors (kernels/ops.py), `out` is (M,) and preallocated."""
    global launches
    m, n = a.shape
    wpr = warps_per_row(m, n, a.element_size(), _build.sm_count(a.device.index))
    fn = _build.function("gemv_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, wpr, stream)
    if err:
        raise RuntimeError(f"gemv kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def reference_int8(qa, x):
    """y = deq(A) x, A dequantized in max(f32, x's dtype), cast once to x's
    dtype."""
    acc = torch.promote_types(torch.float32, x.dtype)
    return (dequantize_in(qa, acc) @ x.to(acc)).to(x.dtype)


def launch_int8(qa, x, out, *, dtype_code: int):
    """y (M,) = deq(A) x: one packed row-dot launch (csrc/qgemv.cu) at batch
    1, no epilogue."""
    global launches_int8
    _bgemv.qgemv(qa, x[None], out[None], qw2=None, bias=None, residual=None, act_code=0,
                 dtype_code=dtype_code)
    launches_int8 += 1
    return out
