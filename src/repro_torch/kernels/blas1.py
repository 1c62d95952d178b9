"""Level-1 BLAS: dot, nrm2 and axpy.

Replaces `repro/kernels/blas1.py`: `_reduce` (the `dot` / `nrm2` Pallas
call at :55) and `axpy` (:92), in f32, bf16 and f64.  The CUDA kernels are
in `csrc/blas1.cu`; its source note says what bounds them (the vectors over
HBM) and how the reduction stays deterministic (block partials summed in a
fixed order by a second one-block pass, no atomics).

Arithmetic mirrors the reference's Pallas path: sums in max(f32, dtype), the
result rounded once to x's dtype (a 0-d tensor, bf16 for bf16 input); nrm2
is the plain sqrt of the sum of squares; axpy is alpha * x + y in
max(f32, dtype), so f32 math for bf16.

`dot_reference`, `nrm2_reference` and `axpy_reference` are the plain
PyTorch versions: CPU tensors use them, and on the card only comparisons
(`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches of the reduction kernel (dot, nrm2) and of axpy in this process;
#: a reduction's two passes count as one launch
reduce_launches = 0
axpy_launches = 0

_THREADS = 256           # threads per block (csrc/blas1.cu)
_BLOCKS_PER_SM = 8       # a grid-stride grid that fills the card once
_REDUCE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_AXPY_ARGTYPES = ([ctypes.c_int, ctypes.c_double] + [ctypes.c_void_p] * 3
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(torch.float32, t.dtype)


def dot_reference(x, y):
    acc = _acc(x)
    return (x.to(acc) * y.to(acc)).sum().to(x.dtype)


def nrm2_reference(x):
    xa = x.to(_acc(x))
    return torch.sqrt((xa * xa).sum()).to(x.dtype)


def axpy_reference(alpha, x, y):
    acc = _acc(x)
    return (alpha * x.to(acc) + y.to(acc)).to(x.dtype)


def grid_blocks(n: int, elem_size: int, sms: int) -> int:
    """Grid-stride blocks: one 16-byte load per thread covers the vector,
    capped at _BLOCKS_PER_SM per SM (one full wave of 256-thread blocks)."""
    per_block = _THREADS * (16 // elem_size)
    return max(1, min(-(-n // per_block), _BLOCKS_PER_SM * sms))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def reduce_launch(x, y, out, *, nrm2: bool, dtype_code: int):
    """Launch `blas1_reduce_launch` (dot, or nrm2 with y unread); operands
    are validated CUDA tensors (kernels/ops.py), `out` is 0-d in x's dtype."""
    global reduce_launches
    n = x.numel()
    blocks = grid_blocks(n, x.element_size(), _build.sm_count(x.device.index))
    partial = torch.empty(blocks, dtype=_acc(x), device=x.device)
    fn = _build.function("blas1_reduce_launch", _REDUCE_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(dtype_code, x.data_ptr(), _build.ptr(y), partial.data_ptr(), out.data_ptr(),
                 n, blocks, int(nrm2), _stream(x))
    if err:
        raise RuntimeError(f"blas1 reduce kernel launch failed: CUDA error {err}")
    reduce_launches += 1
    return out


def axpy_launch(alpha: float, x, y, out, *, dtype_code: int):
    """Launch `blas1_axpy_launch`: out = alpha * x + y."""
    global axpy_launches
    n = x.numel()
    blocks = grid_blocks(n, x.element_size(), _build.sm_count(x.device.index))
    fn = _build.function("blas1_axpy_launch", _AXPY_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(dtype_code, float(alpha), x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                 blocks, _stream(x))
    if err:
        raise RuntimeError(f"blas1 axpy kernel launch failed: CUDA error {err}")
    axpy_launches += 1
    return out
