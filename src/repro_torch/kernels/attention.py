"""Causal flash attention over the KV cache's native layout.

Replaces `repro/kernels/attention.py` (`_flash_kernel`, Pallas call at :329)
in the form prefill and ragged slot decode use: q (B, Tq, H, D) against the
dense cache k/v (B, S, KVH, D) with one real KV length per (slot, head) row
and GQA folding (query head h reads KV head h // (H // KVH)).  The CUDA
kernel is `csrc/attention.cu`; its source note says what bounds it (the K/V
stream) and what the design does about it.  The paged pool, int8 K/V and the
prefix-LM / non-causal masks are not ported yet.

`reference` is the plain PyTorch version: CPU tensors use it, and on the
card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of the CUDA kernel in this process
launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]


def reference(q, k, v, kv_lens):
    """Masked softmax attention in f32.

    Row (b, h) sees keys [0, kvl) with kvl = min(kv_lens[b*H + h], S), query
    t at absolute position t + kvl - Tq; K/V rows at or past kvl are zeroed
    before use so garbage there cannot reach the output.  A row needs at
    least one visible key (kvl >= Tq), as in the reference kernel.
    """
    b, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kvl = torch.clamp(kv_lens.reshape(b, h).to(torch.int64), max=s)   # (B, H)
    kpos = torch.arange(s, device=q.device)
    live = kpos[None, None, :] < kvl[..., None]                      # (B, H, S)
    qf = q.float().permute(0, 2, 1, 3) * d ** -0.5                   # (B, H, Tq, D)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)   # (B, H, S, D)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    kf = torch.where(live[..., None], kf, 0.0)
    vf = torch.where(live[..., None], vf, 0.0)
    scores = qf @ kf.transpose(-1, -2)                               # (B, H, Tq, S)
    qpos = torch.arange(tq, device=q.device)[None, None, :] + (kvl - tq)[..., None]
    keep = live[:, :, None, :] & (qpos[..., None] >= kpos)
    p = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
    return (p @ vf).permute(0, 2, 1, 3).to(q.dtype)


def launch(q, k, v, kv_lens, out, *, dtype_code: int):
    """Launch `attention_launch` on the current stream; operands are
    validated CUDA tensors (kernels/ops.py), kv_lens is int32 (B*H,)."""
    global launches
    b, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    fn = _build.function("attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(dtype_code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_lens.data_ptr(), out.data_ptr(), b, tq, h, s, kvh, d,
                 float(d ** -0.5), stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
