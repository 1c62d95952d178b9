"""Broadcast-weight batched GEMV: the decode-step projection kernel.

Replaces `repro/kernels/bgemv.py` (`_bgemv_kernel`, Pallas call at :230) in
the `transpose_a=True` form the decode path uses: y[b] = epi(x[b] @ W
[, x[b] @ W2]) with W (d_in, d_out) streamed in its stored layout.  The CUDA
kernel is `csrc/bgemv.cu`; its source note says what bounds it on the card
(the weight stream over HBM) and what the design does about it (each weight
element read once for the whole batch, the K sweep split across warps and
across blocks, whose partials a second pass sums before the epilogue).

`reference` is the plain PyTorch version: CPU tensors use it, and on the
card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process (comparisons excluded: they
#: run the plain version)
launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BATCH_CHUNK = 4   # batch members per block (BMAX in csrc/bgemv.cu)


def splits_for(k: int, n: int, batch: int, elem_size: int, sms: int) -> int:
    """Blocks along K: about two blocks per SM over the whole grid, and at
    least 64 rows (8 per warp) per block."""
    tile = 32 * (16 // elem_size)                      # columns per block
    blocks = -(-n // tile) * -(-batch // _BATCH_CHUNK)
    return max(1, min(-(-2 * sms // blocks), k // 64))


def reference(w, x, *, w2=None, bias=None, residual=None, activation=None):
    """y = epi(x @ w [, x @ w2]) in f32, cast once to x's dtype."""
    epi = Epilogue(activation, bias is not None, w2 is not None, residual is not None)
    xf = x.float()
    acc = xf @ w.float()
    acc2 = xf @ w2.float() if w2 is not None else None
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(x.dtype)


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

