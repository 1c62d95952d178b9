"""Flash attention over the KV cache's native layout, dense or paged, with
K/V in the model dtype or packed int8, under the causal, prefix-LM or
non-causal mask.

Replaces `repro/kernels/attention.py` (`_flash_kernel`: the dense Pallas
call at :329 and the paged one at :316) in the forms prefill, ragged slot
decode, whisper's encoder and cross-attention and paligemma's patch prefix
use: q (B, Tq, H, D) against k/v with one real KV length per (slot, head)
row and GQA folding (query head h reads KV head h // (H // KVH)).  k/v are
the dense cache (B, S, KVH, D) or, with a (B, max_pages) int32
`page_table`, the page pool (num_pages, P, KVH, D) in which logical key s
of slot b lives at pool[page_table[b, s // P], s % P].  int8 k/v come with
f32 `k_scales`/`v_scales` in their layout with D -> 1 (one scale a (token,
head) row, core.quant.quantize_kv) and are dequantized as values * scale in
f32.  Head dims 16-256.

The flat layout (attention.py:234-238, 289-294) is the same kernels on
views, with no copy: q (BH, Tq, D) against k/v (BH // g, Tk, D) is the
cache layout with B = BH // g, H = g and KVH = 1 (`cache_view`); k/v and
their scales are that layout as they sit, and q and out are (B, Tq, H, D)
views whose head stride is Tq * D and token stride D.  "mma" and "ffma"
take q's token and head strides as launch arguments (out is allocated like
q, so they are out's too), and a strided instantiation of each reads them;
the cache layout keeps the instantiations it had.  "splitkv" needs none:
at Tq = 1 the head stride is D in both layouts.  `kv_lens` None means
every row sees all S keys, the queries aligned to the end of them
(attention.py:209-211): the kernels get `all_keys`, a persistent buffer of
INT32_MAX lengths that every kernel clamps to S.

The masks, with the reference kernel's semantics (attention.py:117-123,
149-155, 209-211): row (b, h) sees keys [0, kvl), kvl = min(kv_lens[b*H +
h], S), and query t sits at absolute position t + kvl - Tq.  Causal: key s
is visible to query t when s <= t + kvl - Tq.  Prefix-LM (`prefix_len`):
keys below prefix_len are visible to every query, causal after.
Non-causal: every key below kvl is visible (prefix_len is ignored).  The
kernels take one integer for all three, `visible_prefix`: keys below it are
seen by every query, the causal rule holds above it (0 causal, prefix_len
prefix-LM, S non-causal, which covers every kvl).

Three CUDA kernels carry it, and `plan` picks one from host-known shapes
alone (it never reads `kv_lens`, and the mask never changes the route):

- "splitkv" (`csrc/attention_splitkv.cu`) for Tq = 1 in every dtype, form
  and mask (its one query sits at kvl - 1, where all three masks see
  exactly [0, kvl), so the kernel has no mask code): the keys cut at fixed
  absolute positions into chunks of CHUNK, one block per (chunk, slot, KV
  head) holding all query heads of the group, the chunks' partials
  combined in order inside the same launch;
- "mma" (`csrc/attention_mma.cu`) for a bf16 query block (Tq > 1), K/V
  bf16 or int8: both products on the tensor cores (mma.sync), P rounded to
  bf16 for P V;
- "ffma" (`csrc/attention.cu`) for an f32 query block: both products as f32
  FFMA on the CUDA cores (TF32 would change f32 results), each thread a
  register tile of scores and of outputs fed by 16-byte shared loads, over
  a cp.async ring of K/V tiles in dynamic shared memory; the plan names its
  tile (`FFMA_TILES`: queries and keys a block, from the head dim alone).

Each source note says what bounds its kernel and what its design does about
it.  Every route reads keys in tiles or chunks at fixed absolute positions,
so a row's bits depend on its kv length and mask and not on S or the page
size: a paged launch is bitwise the dense launch on the gathered cache.

`reference` is the plain PyTorch version: CPU tensors use it, and on the
card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import ctypes
import functools
import typing

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
#: every launch by the route its plan named and its mask: "causal",
#: "prefix" (prefix-LM, prefix_len > 0) or "noncausal"
ROUTES = ("splitkv", "mma", "ffma")
MASKS = ("causal", "prefix", "noncausal")
launches_by_route_mask = {(r, m): 0 for r in ROUTES for m in MASKS}
#: every launch by its route and the layout of its operands: "cache" (B,
#: Tq, H, D) or "flat" (BH, Tq, D)
LAYOUTS = ("cache", "flat")
launches_by_route_layout = {(r, lay): 0 for r in ROUTES for lay in LAYOUTS}
#: a row length past every cache: the kernels clamp kv lengths to S
ALL_KEYS = 2 ** 31 - 1
_all_keys = {}

#: head dims the kernels are built for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: keys of a "splitkv" split: split j covers [j * CHUNK, (j + 1) * CHUNK).
#: Measured on the H100 (PERF.md §6, scripts/torch_attention_study.py): 64
#: and 128 tie at S = 160 (~13 us), 128 runs S = 4096 9-24% faster than 64
#: (each split ends in a merge of its row groups), and 256 and up leave a
#: GQA decode at S = 160 too few blocks
CHUNK = 128
#: "ffma" tiles by head dim: (queries, keys) a block.  The keys a tile come
#: from D alone (a row's bits depend on them), 64 to D = 64 and 32 above, so
#: that two blocks an SM hold their rings in shared memory (one at D = 256)
FFMA_TILES = {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 32), 256: (32, 32)}
#: the H100's streaming multiprocessors: the plan's default card
H100_SMS = 132
#: a "splitkv" block streams consecutive splits until the grid is down to
#: about this many blocks an SM (a short cache: one split a block)
BLOCKS_PER_SM = 8

_FFMA_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
                  + [ctypes.c_float, ctypes.c_void_p])
_SPLITKV_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                     + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
_MMA_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                 + [ctypes.c_float, ctypes.c_void_p])


class Plan(typing.NamedTuple):
    """How one attention call runs: the route ("splitkv", "mma" or "ffma");
    for "splitkv", the chunk of keys a split covers, the number of splits
    (ceil(S / chunk); splits at or past a row's kv length load nothing and
    its combine skips them) and the consecutive splits a block streams (the
    grid; a split's arithmetic does not depend on it); for "ffma", the
    queries and keys a block takes (`FFMA_TILES`; the kernel refuses a tile
    it was not built for)."""

    route: str
    splits: int = 1
    chunk: int = 0
    per_block: int = 1
    block_q: int = 0
    block_k: int = 0


@functools.lru_cache(maxsize=1024)  # a serve plans a handful of shapes
def plan(b: int, tq: int, h: int, kvh: int, d: int, s: int, dtype, int8: bool,
         chunk: int = CHUNK, sms: int = H100_SMS) -> Plan:
    """The route and key split of q (b, tq, h, d) over a cache of s logical
    keys (the dense cache's S, or max_pages * P of a page pool) with kvh KV
    heads, K/V int8 or q's dtype.  Host-known shapes only: no device value
    is read.  Tq = 1 takes "splitkv" in every dtype and form; a bf16 block
    "mma"; an f32 block "ffma" with the head dim's tile (`FFMA_TILES`).
    Head dims outside HEAD_DIMS raise.

    "splitkv" cuts S into ceil(s / chunk) splits; a block streams
    per_block of them, so that the grid of b * kvh rows is about
    BLOCKS_PER_SM blocks an SM of `sms` (one split a block where that
    leaves fewer)."""
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel: head dim {d} not in {HEAD_DIMS}")
    if min(b, tq, h, kvh, s) < 1 or h % kvh:
        raise ValueError(f"flash_attention: no plan for b={b}, tq={tq}, h={h}, kvh={kvh}, s={s}")
    if tq == 1:
        splits = -(-s // chunk)
        return Plan("splitkv", splits, chunk,
                    max(1, splits * b * kvh // (BLOCKS_PER_SM * sms)))
    if dtype == torch.bfloat16:
        return Plan("mma")
    if dtype == torch.float32:
        block_q, block_k = FFMA_TILES[d]
        return Plan("ffma", block_q=block_q, block_k=block_k)
    raise TypeError(f"flash_attention: no route for dtype {dtype}")


def cache_view(q, k, v, k_scales=None, v_scales=None, kv_groups: int = 1):
    """Flat operands q (BH, Tq, D), k/v (BH // g, Tk, D) and their scales
    (BH // g, Tk, 1) as views in the cache layout, no copy: q (B, Tq, H, D)
    with B = BH // g and H = g (head stride Tq * D, token stride D), k/v
    (B, Tk, 1, D) and the scales (B, Tk, 1, 1).  Row r = b * H + h of the
    cache layout is flat row r, and query head h reads KV head 0 of slot b:
    flat KV row r // g, the reference's GQA fold."""
    bh, tq, d = q.shape
    q4 = q.view(bh // kv_groups, kv_groups, tq, d).transpose(1, 2)
    kv4 = [None if t is None else t.unsqueeze(2) for t in (k, v, k_scales, v_scales)]
    return (q4, *kv4)


def all_keys(device, n: int) -> torch.Tensor:
    """n int32 kv lengths of ALL_KEYS on `device`: the kv_lens of a call that
    passes none (every row sees its whole cache).  A view of one persistent
    buffer a device, filled once, so such a call launches nothing but its
    kernel."""
    t = _all_keys.get(device)
    if t is None or t.numel() < n:
        t = _all_keys[device] = torch.full((max(n, 1024),), ALL_KEYS, dtype=torch.int32,
                                           device=device)
    return t[:n]


def gather_pages(pool, page_table):
    """The pool's pages of each slot in table order: (num_pages, P, ...) ->
    (B, max_pages * P, ...), the dense cache the table describes."""
    b, n = page_table.shape
    return pool[page_table.long()].reshape((b, n * pool.shape[1]) + tuple(pool.shape[2:]))


def mask_name(causal: bool = True, prefix_len=None) -> str:
    """"causal", "prefix" or "noncausal": the mask a call runs under
    (prefix_len is ignored when causal is False, and 0 or None is none)."""
    if not causal:
        return "noncausal"
    return "prefix" if prefix_len else "causal"


def visible_prefix(s: int, causal: bool = True, prefix_len=None) -> int:
    """The kernels' one mask argument: keys below it are visible to every
    query, the causal rule holds above it.  s is the logical cache length
    (no kvl exceeds it), so s makes a launch non-causal."""
    if not causal:
        return s
    return min(int(prefix_len or 0), s)


def reference(q, k, v, kv_lens=None, k_scales=None, v_scales=None, page_table=None,
              causal: bool = True, prefix_len=None, kv_groups: int = 1):
    """Masked softmax attention in f32.

    Flat operands (q (BH, Tq, D), k/v (BH // kv_groups, Tk, D)) run as
    their cache-layout views (`cache_view`) and return (BH, Tq, D).
    Row (b, h) sees keys [0, kvl) with kvl = min(kv_lens[b*H + h], S) (no
    kv_lens: kvl = S), query
    t at absolute position t + kvl - Tq: causally (key s visible when s <=
    t + kvl - Tq), with every key below prefix_len visible too (prefix-LM),
    or, causal=False, all of them.  K/V rows at or past kvl are zeroed
    before use so garbage there cannot reach the output.  A row needs at
    least one visible key (kvl >= Tq under the causal mask), as in the
    reference kernel.  A paged call gathers each slot's pages into the
    dense cache first (so it is bitwise the dense call on that cache); int8
    K/V dequantize as values.float() * scales.
    """
    if q.ndim == 3:
        q4, k, v, k_scales, v_scales = cache_view(q, k, v, k_scales, v_scales, kv_groups)
        out = reference(q4, k, v, kv_lens, k_scales, v_scales, causal=causal,
                        prefix_len=prefix_len)
        return out.transpose(1, 2).reshape(q.shape)
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
    if kv_lens is None:
        kv_lens = torch.full((b * h,), s, dtype=torch.int64, device=q.device)
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
    seen = (qpos[..., None] >= kpos) | (kpos < visible_prefix(s, causal, prefix_len))
    keep = live[:, :, None, :] & seen
    p = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
    return (p @ vf).permute(0, 2, 1, 3).to(q.dtype)


def plan_for(q, k, page_table=None, int8: bool = False, sms: int = H100_SMS) -> Plan:
    """`plan` of a call's operands, from their shapes and q's dtype alone."""
    b, tq, h, d = q.shape
    return plan(b, tq, h, k.shape[2], d, _logical(k, page_table)[0], q.dtype, int8,
                sms=sms)


def _logical(k, page_table):
    """(S, page size, max pages): the logical cache length the kernels see."""
    if page_table is None:
        return k.shape[1], 0, 0
    return k.shape[1] * page_table.shape[1], k.shape[1], page_table.shape[1]


def run(q, k, v, kv_lens, out, p: Plan, *, dtype_code: int, k_scales=None, v_scales=None,
        page_table=None, causal: bool = True, prefix_len=None):
    """One launch of p's route on the current stream, uncounted; operands
    are validated CUDA tensors (kernels/ops.py), kv_lens is int32 (B*H,),
    q and out (B, Tq, H, D), contiguous or flat operands' cache_view (out
    strided as q).  The "splitkv" partials' workspace is allocated here.
    "splitkv" takes no mask: its one query sits at kvl - 1, where every
    mask sees [0, kvl); and no strides: at Tq = 1 both layouts put head h
    of slot b at (b * H + h) * D.  "ffma" takes p's tile."""
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    s, page_size, max_pages = _logical(k, page_table)
    int8 = int(k_scales is not None)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scales),
              _build.ptr(v_scales), kv_lens.data_ptr(), _build.ptr(page_table), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if p.route == "splitkv":
            work = torch.empty(b * kvh * p.splits * (h // kvh) * (d + 2), dtype=torch.float32,
                               device=q.device)
            fn = _build.function("attention_splitkv_launch", _SPLITKV_ARGTYPES)
            err = fn(dtype_code, int8, *common, work.data_ptr(),
                     _build.tickets(q.device, b * kvh).data_ptr(), b, h, s, kvh, d, page_size,
                     max_pages, p.chunk, p.splits, p.per_block, float(d ** -0.5), stream)
        elif p.route == "mma":
            fn = _build.function("attention_mma_launch", _MMA_ARGTYPES)
            err = fn(int8, *common, b, tq, h, s, kvh, d, page_size, max_pages,
                     visible_prefix(s, causal, prefix_len), q.stride(1), q.stride(2),
                     float(d ** -0.5), stream)
        else:
            fn = _build.function("attention_launch", _FFMA_ARGTYPES)
            err = fn(int8, *common, b, tq, h, s, kvh, d, page_size, max_pages,
                     visible_prefix(s, causal, prefix_len), q.stride(1), q.stride(2),
                     p.block_q, p.block_k, float(d ** -0.5), stream)
    if err:
        raise RuntimeError(f"attention {p.route} kernel launch failed: CUDA error {err}")
    return out


def launch(q, k, v, kv_lens, out, *, dtype_code: int, k_scales=None, v_scales=None,
           page_table=None, causal: bool = True, prefix_len=None, kv_groups: int = 1):
    """One launch of the kernel `plan` names, counted by form, route, mask
    and layout; operands are validated CUDA tensors (kernels/ops.py) in the
    cache layout or flat (then run as their `cache_view`, out allocated
    like q), kv_lens None: `all_keys`."""
    global launches, launches_paged, launches_int8
    layout = "flat" if q.ndim == 3 else "cache"
    result = out
    if layout == "flat":
        q, k, v, k_scales, v_scales = cache_view(q, k, v, k_scales, v_scales, kv_groups)
        b, tq, h, d = q.shape
        out = out.view(b, h, tq, d).transpose(1, 2)  # strided as q
    if kv_lens is None:
        kv_lens = all_keys(q.device, q.shape[0] * q.shape[2])
    int8 = k_scales is not None
    p = plan_for(q, k, page_table, int8, _build.sm_count(q.device.index or 0))
    run(q, k, v, kv_lens, out, p, dtype_code=dtype_code, k_scales=k_scales, v_scales=v_scales,
        page_table=page_table, causal=causal, prefix_len=prefix_len)
    if page_table is not None:
        launches_paged += 1
    if int8:
        launches_int8 += 1
    if page_table is None and not int8:
        launches += 1
    launches_by_route_mask[p.route, mask_name(causal, prefix_len)] += 1
    launches_by_route_layout[p.route, layout] += 1
    return result
