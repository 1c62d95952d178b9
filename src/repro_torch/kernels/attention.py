"""Causal flash attention over the KV cache's native layout, dense or paged,
with K/V in the model dtype or packed int8.

Replaces `repro/kernels/attention.py` (`_flash_kernel`: the dense Pallas
call at :329 and the paged one at :316) in the forms prefill and ragged
slot decode use: q (B, Tq, H, D) against k/v with one real KV length per
(slot, head) row and GQA folding (query head h reads KV head
h // (H // KVH)).  k/v are the dense cache (B, S, KVH, D) or, with a
(B, max_pages) int32 `page_table`, the page pool (num_pages, P, KVH, D)
in which logical key s of slot b lives at pool[page_table[b, s // P],
s % P].  int8 k/v come with f32 `k_scales`/`v_scales` in their layout with
D -> 1 (one scale a (token, head) row, core.quant.quantize_kv) and are
dequantized as values * scale in f32.  The CUDA kernel is
`csrc/attention.cu`; its source note says what bounds it (the K/V stream)
and what the design does about it.  The prefix-LM / non-causal masks and
the flat (BH, T, D) layout are not ported yet.

`reference` is the plain PyTorch version: CPU tensors use it, and on the
card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of the CUDA kernel in this process, by form: `launches` the
#: dense cache in the model dtype, `launches_paged` every launch through a
#: page table, `launches_int8` every launch with int8 K/V (a paged int8
#: launch counts in both)
launches = 0
launches_paged = 0
launches_int8 = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def gather_pages(pool, page_table):
    """The pool's pages of each slot in table order: (num_pages, P, ...) ->
    (B, max_pages * P, ...), the dense cache the table describes."""
    b, n = page_table.shape
    return pool[page_table.long()].reshape((b, n * pool.shape[1]) + tuple(pool.shape[2:]))


def reference(q, k, v, kv_lens, k_scales=None, v_scales=None, page_table=None):
    """Masked softmax attention in f32.

    Row (b, h) sees keys [0, kvl) with kvl = min(kv_lens[b*H + h], S), query
    t at absolute position t + kvl - Tq; K/V rows at or past kvl are zeroed
    before use so garbage there cannot reach the output.  A row needs at
    least one visible key (kvl >= Tq), as in the reference kernel.  A paged
    call gathers each slot's pages into the dense cache first (so it is
    bitwise the dense call on that cache); int8 K/V dequantize as
    values.float() * scales.
    """
    if page_table is not None:
        k, v = gather_pages(k, page_table), gather_pages(v, page_table)
        if k_scales is not None:
            k_scales = gather_pages(k_scales, page_table)
            v_scales = gather_pages(v_scales, page_table)
    if k_scales is not None:
        k, v = k.float() * k_scales, v.float() * v_scales
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


def launch(q, k, v, kv_lens, out, *, dtype_code: int, k_scales=None, v_scales=None,
           page_table=None):
    """Launch `attention_launch` on the current stream; operands are
    validated CUDA tensors (kernels/ops.py), kv_lens is int32 (B*H,)."""
    global launches, launches_paged, launches_int8
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    if page_table is None:
        s, page_size, max_pages = k.shape[1], 0, 0
    else:
        page_size, max_pages = k.shape[1], page_table.shape[1]
        s = page_size * max_pages
    int8 = k_scales is not None
    fn = _build.function("attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(dtype_code, int(int8), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _build.ptr(k_scales), _build.ptr(v_scales), kv_lens.data_ptr(),
                 _build.ptr(page_table), out.data_ptr(), b, tq, h, s, kvh, d, page_size,
                 max_pages, float(d ** -0.5), stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    if page_table is not None:
        launches_paged += 1
    if int8:
        launches_int8 += 1
    if page_table is None and not int8:
        launches += 1
    return out
