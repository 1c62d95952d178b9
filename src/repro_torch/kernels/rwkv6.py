"""Chunked RWKV6 (Finch) WKV recurrence with a carried (K x V) state.

Replaces `repro/kernels/rwkv6.py` (`_wkv6_kernel`, Pallas call at :99) with
the contract of the model's `wkv6_chunked` (`repro/models/rwkv.py:31`): an
optional f32 initial state `s0` (BH, K, V) in and the final state out, so
one launch carries a layer's prefill from the cached state.

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t = log-decay <= 0)

r, k, w (BH, T, K), v (BH, T, V), u (BH, K) -> y (BH, T, V) in r's dtype,
s_fin (BH, K, V) f32.  Time is cut into chunks of min(chunk, T) rows, the
last padded with zero rows (which leave the state unchanged).  The CUDA
kernel is `csrc/rwkv6.cu`, three launches a call (the chunks' state
increments, the state carried across chunks element by element, then every
chunk's outputs), parallel across rows, chunks and state columns; its
source note says what bounds it and what the design does about it.  The
f32 workspaces (the per-chunk states and decays) are allocated per call.

`reference` is the plain PyTorch version, a copy of `wkv6_chunked`'s body:
CPU tensors use it, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
launches = 0

#: the kernel's limits (csrc/rwkv6.cu: KMAX, VMAX, CMAX)
MAX_HEAD_DIM = 64
MAX_CHUNK = 32

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: device launches a call: states, the carried-state scan, outputs
DEVICE_LAUNCHES = 3


def workspace_shapes(bh: int, t: int, kk: int, vv: int, chunk: int) -> tuple:
    """The f32 workspaces of one call: the per-chunk states (BH, chunks, K,
    V) (increments, then the state entering each chunk) and decays (BH,
    chunks, K)."""
    nc = -(-t // min(chunk, t))
    return (bh, nc, kk, vv), (bh, nc, kk)


def reference(r, k, v, w_log, u, s0=None, chunk: int = 32):
    """The chunked recurrence in f32, chunk by chunk; every exponent is a
    forward-interval sum of log-decays (<= 0).  Returns (y in r's dtype,
    s_fin f32)."""
    bh, t, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        r, k, v, w_log = (F.pad(z, (0, 0, 0, pad)) for z in (r, k, v, w_log))
    nc = r.shape[1] // c
    rs, ks, vs, ws = (z.reshape(bh, nc, c, -1).float() for z in (r, k, v, w_log))
    uf = u.float()
    s = (torch.zeros((bh, kk, vv), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float().clone())
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32, device=r.device), -1)
    ys = []
    for n in range(nc):
        rc, kc, vc, wc = rs[:, n], ks[:, n], vs[:, n], ws[:, n]       # (BH, C, K/V)
        L = torch.cumsum(wc, dim=1)
        Lprev = L - wc
        y = torch.bmm(rc * torch.exp(Lprev), s)
        E = Lprev[:, :, None, :] - L[:, None, :, :]                    # (BH, C, C, K)
        A = (rc[:, :, None, :] * kc[:, None, :, :]
             * torch.exp(torch.clamp(E, max=0.0))).sum(-1) * mask
        y = y + torch.bmm(A, vc)
        diag = (rc * uf[:, None, :] * kc).sum(-1, keepdim=True)
        y = y + diag * vc
        l_last = L[:, -1:, :]
        k_sc = kc * torch.exp(l_last - L)
        s = torch.exp(l_last[:, 0, :])[:, :, None] * s + torch.bmm(k_sc.transpose(1, 2), vc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(r.dtype), s


def launch(r, k, v, w_log, u, s0, y, s_fin, *, chunk: int, dtype_code: int):
    """Launch `rwkv6_launch` (three kernels) on the current stream; operands
    are validated CUDA tensors (kernels/ops.py), y and s_fin preallocated,
    the workspaces allocated here."""
    global launches
    bh, t, kk = r.shape
    vv = v.shape[-1]
    ds_shape, dec_shape = workspace_shapes(bh, t, kk, vv, chunk)
    ds = torch.empty(ds_shape, dtype=torch.float32, device=r.device)
    dec = torch.empty(dec_shape, dtype=torch.float32, device=r.device)
    fn = _build.function("rwkv6_launch", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(dtype_code, r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                 u.data_ptr(), _build.ptr(s0), y.data_ptr(), s_fin.data_ptr(), ds.data_ptr(),
                 dec.data_ptr(), bh, t, kk, vv, min(chunk, t), stream)
    if err:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return y, s_fin
