"""Chunked Mamba2 SSD recurrence (scalar decay per head and step) with a
carried (N x P) state.

Replaces `repro/kernels/mamba2.py` (`_ssd_kernel`, Pallas call at :84) with
the contract of the model's `ssd_chunked` (`repro/models/mamba.py:23`): an
optional f32 initial state `h0` (BH, N, P) in and the final state out, so
one launch carries a layer's prefill from the cached state.

    H_t = exp(a_t) H_{t-1} + b_t x_t^T        (a_t <= 0 log-decay)
    y_t = c_t^T H_t

x (BH, T, P), a_log (BH, T) f32, b, c (BH, T, N) -> y (BH, T, P) in x's
dtype, h_fin (BH, N, P) f32.  Time is cut into chunks of min(chunk, T)
rows, the last padded with rows where a = 0 and x = b = c = 0 (which leave
the state exact).  The CUDA kernel is `csrc/mamba2.cu`, three launches a
call (the chunks' state increments, the state carried across chunks
element by element, then every chunk's outputs), parallel across rows and
chunks; its source note says what bounds it and what the design does
about it.  The f32 workspaces (the per-chunk states and decays) are
allocated per call.

`reference` is the plain PyTorch version, a copy of `ssd_chunked`'s body:
CPU tensors use it, and on the card only comparisons (`ops.reference_mode`)
do.  Both it and the kernel sum the chunk's log-decays L in f64 and round
each exponent (a difference of L) to f32 once, where the reference sums in
f32: under strong decay |L| passes 10^3 within a chunk, and an f32 prefix
sum then loses ~1e-4 of every exponent difference, which two summation
orders would not lose alike.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
launches = 0

#: the kernel's limits (csrc/mamba2.cu: NMAX, PMAX, CMAX)
MAX_STATE = 64
MAX_HEAD_DIM = 64
MAX_CHUNK = 64

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: device launches a call: states, the carried-state scan, outputs
DEVICE_LAUNCHES = 3


def workspace_shapes(bh: int, t: int, n: int, p: int, chunk: int) -> tuple:
    """The f32 workspaces of one call: the per-chunk states (BH, chunks, N,
    P) (increments, then the state entering each chunk) and decays (BH,
    chunks)."""
    nc = -(-t // min(chunk, t))
    return (bh, nc, n, p), (bh, nc)


def reference(x, a_log, b, c, h0=None, chunk: int = 64):
    """The chunked recurrence in f32 (L in f64), chunk by chunk; every
    exponent is a forward-interval sum of log-decays (<= 0).  Returns (y in
    x's dtype, h_fin f32)."""
    bh, t, p = x.shape
    n = b.shape[-1]
    ck = min(chunk, t)
    pad = (-t) % ck
    if pad:
        x, b, c = (F.pad(z, (0, 0, 0, pad)) for z in (x, b, c))
        a_log = F.pad(a_log, (0, pad))
    nc = x.shape[1] // ck
    xs, bs, cs = (z.reshape(bh, nc, ck, -1).float() for z in (x, b, c))
    as_ = a_log.reshape(bh, nc, ck).float()
    h = (torch.zeros((bh, n, p), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float().clone())
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xs[:, i], as_[:, i], bs[:, i], cs[:, i]
        L = torch.cumsum(ac.double(), dim=1)                           # (BH, C) f64
        y = torch.exp(L.float())[:, :, None] * torch.bmm(cc, h)
        E = (L[:, :, None] - L[:, None, :]).float()                    # (BH, C, C)
        A = torch.bmm(cc, bc.transpose(1, 2)) * torch.exp(torch.clamp(E, max=0.0)) * mask
        y = y + torch.bmm(A, xc)
        l_last = L[:, -1]
        b_sc = bc * torch.exp((l_last[:, None] - L).float())[:, :, None]
        h = torch.exp(l_last.float())[:, None, None] * h + torch.bmm(b_sc.transpose(1, 2), xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(x.dtype), h


def launch(x, a_log, b, c, h0, y, h_fin, *, chunk: int, dtype_code: int):
    """Launch `mamba2_ssd_launch` (three kernels) on the current stream;
    operands are validated CUDA tensors (kernels/ops.py), y and h_fin
    preallocated, the workspaces allocated here."""
    global launches
    bh, t, p = x.shape
    n = b.shape[-1]
    dh_shape, dec_shape = workspace_shapes(bh, t, n, p, chunk)
    dh = torch.empty(dh_shape, dtype=torch.float32, device=x.device)
    dec = torch.empty(dec_shape, dtype=torch.float32, device=x.device)
    fn = _build.function("mamba2_ssd_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(dtype_code, x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
                 _build.ptr(h0), y.data_ptr(), h_fin.data_ptr(), dh.data_ptr(), dec.data_ptr(),
                 bh, t, n, p, min(chunk, t), stream)
    if err:
        raise RuntimeError(f"mamba2 SSD kernel launch failed: CUDA error {err}")
    launches += 1
    return y, h_fin
