"""Broadcast-weight batched GEMV: the decode-step projection kernel.

Replaces `repro/kernels/bgemv.py` (`_bgemv_kernel`, Pallas call at :230) in
the `transpose_a=True` form the decode path uses: y[b] = epi(x[b] @ W
[, x[b] @ W2]) with W (d_in, d_out) streamed in its stored layout.  The CUDA
kernel is `csrc/bgemv.cu`; its source note says what bounds it on the card
(the weight stream over HBM) and what the design does about it (each weight
element read once for the whole batch, the K sweep split across warps and
across blocks, whose partials a second pass sums before the epilogue).

The packed form (`_bgemv_kernel`'s int8 body, bgemv.py:80-83) is
`csrc/qgemv.cu`: W is a `core.quant.QuantizedTensor` stored output-major
(N, K), so each output is one dot over a stored row, dequantized in the
accumulator type.  `launch_int8` binds it (with its own launch count) and
`reference_int8` is its plain version; `kernels/gemv.py` reaches the same
kernel at batch 1 through `qgemv`.

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

#: launches of the CUDA kernel in this process (comparisons excluded: they
#: run the plain version)
launches = 0
#: launches of the packed kernel (csrc/qgemv.cu) through `launch_int8`
launches_int8 = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BATCH_CHUNK = 4   # batch members per block (BMAX in csrc/bgemv.cu)


def splits_for(k: int, n: int, batch: int, elem_size: int, sms: int) -> int:
    """Blocks along K: about two blocks per SM over the whole grid, and at
    least 64 rows (8 per warp) per block."""
    tile = 32 * (16 // elem_size)                      # columns per block
    blocks = -(-n // tile) * -(-batch // _BATCH_CHUNK)
    return max(1, min(-(-2 * sms // blocks), k // 64))


def reference(w, x, *, w2=None, bias=None, residual=None, activation=None):
    """y = epi(x @ w [, x @ w2]) in max(f32, dtype), cast once to x's dtype."""
    epi = Epilogue(activation, bias is not None, w2 is not None, residual is not None)
    acc_dt = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(acc_dt)
    acc = xf @ w.to(acc_dt)
    acc2 = xf @ w2.to(acc_dt) if w2 is not None else None
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(x.dtype)


def _deq_kn(qt, acc_dt):
    """A packed weight dequantized in `acc_dt` as the (K, N) operand of
    y = x @ W: the logical (d, f) for output-major storage, else the
    transpose of the stored (N, K) rows."""
    w = dequantize_in(qt, acc_dt)
    return w if qt.transposed else w.t()


def reference_int8(qw, x, *, qw2=None, bias=None, residual=None, activation=None):
    """The packed kernel's plain version: y[b, i] = epi(sum_k deq(W)[i, k]
    x[b, k] [, ...W2]) over W's stored rows, dequantized in the accumulator
    dtype max(f32, x's dtype), then the dense plain version."""
    acc_dt = torch.promote_types(torch.float32, x.dtype)
    w2 = None if qw2 is None else _deq_kn(qw2, acc_dt)
    return reference(_deq_kn(qw, acc_dt), x, w2=w2, bias=bias, residual=residual,
                     activation=activation)


def launch(w, x, out, *, w2, bias, residual, act_code: int, dtype_code: int):
    """Launch `bgemv_launch` on the current stream; operands are validated
    CUDA tensors (kernels/ops.py), `out` is (B, N) and preallocated."""
    global launches
    k, n = w.shape
    b = x.shape[0]
    splits = splits_for(k, n, b, x.element_size(), _build.sm_count(x.device.index))
    # f32 partial sums of every K split, summed in order by the second pass
    ws = torch.empty((2 if w2 is not None else 1) * splits * b * n,
                     dtype=torch.float32, device=x.device)
    fn = _build.function("bgemv_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(dtype_code, w.data_ptr(), _build.ptr(w2), x.data_ptr(), _build.ptr(bias),
                 _build.ptr(residual), out.data_ptr(), ws.data_ptr(), b, k, n, splits,
                 act_code, stream)
    if err:
        raise RuntimeError(f"bgemv kernel launch failed: CUDA error {err}")
    launches += 1
    return out


_Q_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def qgemv(qw, x, out, *, qw2, bias, residual, act_code: int, dtype_code: int):
    """Launch `qgemv_launch` (csrc/qgemv.cu) on the current stream: out (B, N)
    = epi over the stored (N, K) int8 rows of qw (and qw2); operands are
    validated CUDA tensors (kernels/ops.py)."""
    n, k = qw.values.shape
    qm, qn = qw.block
    fn = _build.function("qgemv_launch", _Q_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(dtype_code, qw.values.data_ptr(), qw.scales.data_ptr(),
                 None if qw2 is None else qw2.values.data_ptr(),
                 None if qw2 is None else qw2.scales.data_ptr(), x.data_ptr(),
                 _build.ptr(bias), _build.ptr(residual), out.data_ptr(), x.shape[0], k, n,
                 qm, qn, act_code, stream)
    if err:
        raise RuntimeError(f"qgemv kernel launch failed: CUDA error {err}")
    return out


def launch_int8(qw, x, out, *, qw2, bias, residual, act_code: int, dtype_code: int):
    """The packed decode projection: one `qgemv` launch, counted."""
    global launches_int8
    qgemv(qw, x, out, qw2=qw2, bias=bias, residual=residual, act_code=act_code,
          dtype_code=dtype_code)
    launches_int8 += 1
    return out
