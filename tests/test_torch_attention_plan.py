"""The attention plan (`repro_torch.kernels.attention.plan`) and plain models
of its two new routes' arithmetic, on the CPU.

The plan picks the kernel of a `flash_attention` call from host-known
shapes alone: "splitkv" (csrc/attention_splitkv.cu) for one query token a
row, "mma" (csrc/attention_mma.cu) for a bf16 query block, "ffma"
(csrc/attention.cu) for an f32 one; and for "splitkv" the chunk of keys a
block takes and the number of splits, from the cache length S alone.

The kernels run only on the card.  Here the arithmetic they do is written
out in plain PyTorch and held to the JAX package's Pallas kernel
(`repro.kernels.attention.attention`, interpret mode, as
tests/test_torch_kv.py runs it) and to the port's plain version:

- `_splitkv_model`: per query head, partials (m, l, acc) over chunks of
  keys at fixed absolute positions [j*C, (j+1)*C) ∩ [0, kvl), then the
  combine over the splits below kvl in split order.  f32 within 1e-5 of
  both (only the summation order differs), and bitwise independent of S;
- `_mma_model`: the tensor-core prefill's rounding: online softmax over
  64-key tiles in the log2 domain, the D^-0.5 scale on the f32 scores after
  the product, int8 scales folded into score and P columns, P rounded to
  bf16 for P V, under the causal, prefix-LM and non-causal masks (keys
  below `attention.visible_prefix` seen by every query).  Within bf16's
  rtol = atol = 1.6e-2 of the Pallas kernel (chip_smoke.py's per-launch
  gate) at the smoke model's widths, and bitwise independent of S under
  every mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattention
from repro_torch.core import quant
from repro_torch.kernels import attention

BF16, F32 = torch.bfloat16, torch.float32
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
NEG_INF = attention.NEG_INF


# --------------------------------------------------------------------------
# (a) the plan
# --------------------------------------------------------------------------

#: the "ffma" tile (queries, keys a block) by head dim, as csrc/attention.cu
#: builds it
FFMA_TILE_PINS = {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 32), 256: (32, 32)}


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("tq", [1, 2, 64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_plan_routes_by_dtype_and_query_length(dtype, tq, int8, d):
    """The route by dtype and query length; an "ffma" plan carries its head
    dim's tile, and the keys a tile (on which a row's bits depend) are the
    same at every batch, query length, cache length, KV head count and K/V
    form (the plan takes no mask, so no mask moves them either)."""
    p = attention.plan(4, tq, 32, 8, d, 160, dtype, int8)
    want = "splitkv" if tq == 1 else ("mma" if dtype == BF16 else "ffma")
    assert p.route == want
    if want == "splitkv":
        assert (p.chunk, p.splits) == (attention.CHUNK, -(-160 // attention.CHUNK))
    else:
        assert p.splits == 1
    if want != "ffma":
        assert (p.block_q, p.block_k) == (0, 0)
        return
    assert (p.block_q, p.block_k) == FFMA_TILE_PINS[d]
    tiles = {attention.plan(b, t, 32, kvh, d, s, F32, i8)[4:]
             for b in (1, 3, 64) for t in (2, 63, 65, 1500) for kvh in (32, 8, 1)
             for s in (t, 160, 4097) for i8 in (False, True)}
    assert tiles == {FFMA_TILE_PINS[d]}


@pytest.mark.parametrize("s", [1, 63, 64, 65, 128, 160, 4096, 4097])
def test_plan_splits_come_from_the_cache_length_alone(s):
    """ceil(S / CHUNK) splits, whatever the batch, heads, head dim, dtype
    and K/V form: the grid; the kernel never reads kv_lens on the host."""
    want = -(-s // attention.CHUNK)
    plans = {attention.plan(b, 1, h, kvh, d, s, dtype, int8)[:3]
             for b, h, kvh in ((1, 4, 4), (4, 32, 32), (3, 32, 8))
             for d in attention.HEAD_DIMS for dtype in (F32, BF16) for int8 in (False, True)}
    assert plans == {("splitkv", want, attention.CHUNK)}


@pytest.mark.parametrize("b,kvh,s", [(4, 32, 160), (4, 32, 4096), (4, 8, 4096), (1, 1, 64),
                                     (4, 8, 160), (64, 32, 32768)])
def test_plan_streams_splits_until_the_grid_fills_the_card(b, kvh, s):
    """One split a block while b * kvh * splits is at most BLOCKS_PER_SM
    blocks an SM; past that, consecutive splits a block so that the grid
    stays about that size (and never below it), down to one block a row."""
    p = attention.plan(b, 1, 4 * kvh, kvh, 64, s, BF16, False)
    rows, target = b * kvh, attention.BLOCKS_PER_SM * attention.H100_SMS
    blocks = rows * -(-p.splits // p.per_block)
    if rows * p.splits <= target:
        assert p.per_block == 1
    elif rows < target:
        assert target <= blocks < 2 * target
    else:
        assert blocks == rows


@pytest.mark.parametrize("s", [37, 128, 160, 1031, 4096])
@pytest.mark.parametrize("tq", [1, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_of_a_pool_is_the_plan_of_its_dense_cache(s, tq, dtype):
    """The pool of the same logical cache at P = 7 and P = 16 holds
    max_pages * P >= S keys: the same route and chunk, and any split the
    pool adds starts at or past S, so it loads nothing for any row."""
    dense = attention.plan(4, tq, 32, 32, 64, s, dtype, False)
    for page in (7, 16):
        pooled = attention.plan(4, tq, 32, 32, 64, -(-s // page) * page, dtype, False)
        assert (pooled.route, pooled.chunk) == (dense.route, dense.chunk)
        assert pooled.splits >= dense.splits
        assert dense.splits * dense.chunk >= s if dense.route == "splitkv" else pooled == dense
        if dense.route == "splitkv" and -(-s // page) * page <= dense.splits * dense.chunk:
            assert pooled[:3] == dense[:3]


@pytest.mark.parametrize("d", [8, 48, 96, 512])
def test_plan_refuses_head_dims_without_a_kernel(d):
    for tq, dtype in ((1, BF16), (128, BF16), (128, F32)):
        with pytest.raises(NotImplementedError, match="head dim"):
            attention.plan(2, tq, 4, 4, d, 64, dtype, False)


@pytest.mark.parametrize("tq,dtype", [(1, BF16), (9, BF16), (9, F32)])
def test_plan_reads_no_device_value(tq, dtype):
    """The launch's plan comes from the operands' shapes: on the meta device,
    where reading any value raises, it is the plan of the dense cache."""
    q = torch.empty(4, tq, 32, 64, dtype=dtype, device="meta")
    pool = torch.empty(99, 16, 8, 64, dtype=torch.int8, device="meta")
    table = torch.empty(4, 10, dtype=torch.int32, device="meta")
    assert attention.plan_for(q, pool, table, True) == attention.plan(4, tq, 32, 8, 64, 160,
                                                                      dtype, True)


# --------------------------------------------------------------------------
# shared inputs: numpy, garbage past every length
# --------------------------------------------------------------------------

def _case(rng, lens, *, tq=1, h=8, kvh=2, d=16, s=None, int8=False, page_size=None):
    """q (B, Tq, H, D), a dense cache (B, S, KVH, D) with NaN values (int8:
    random values under NaN scales) past each slot's length, kv_lens per
    (slot, head); with page_size the same keys in a pool (`_paged`).
    Returns (q, cache operands, page table or None, kv_lens)."""
    b = len(lens)
    s = s or max(lens)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    cache = {}
    for name in "kv":
        x = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
        if int8:
            qt = quant.quantize_kv(torch.from_numpy(x))
            vals, sc = qt.values.numpy().copy(), qt.scales.numpy().copy()
            for i, n in enumerate(lens):
                vals[i, n:] = rng.integers(-127, 128, vals[i, n:].shape)
                sc[i, n:] = np.nan
            cache[name], cache[name + "_scales"] = vals, sc
        else:
            for i, n in enumerate(lens):
                x[i, n:] = np.nan
            cache[name] = x
    kv_lens = np.repeat(np.asarray(lens, np.int32), h)
    if page_size is None:
        return q, cache, None, kv_lens
    return (q, *_paged(rng, cache, lens, page_size), kv_lens)


def _paged(rng, cache, lens, page_size):
    """The dense cache's live pages in a shuffled pool whose dead entries
    point at the trash page 0 (garbage everywhere else): (pools, table)."""
    b, s = cache["k"].shape[:2]
    max_pages = -(-s // page_size)
    num_pages = 1 + b * max_pages
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, max_pages).astype(np.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // page_size):] = 0
    pools = {}
    for name, t in cache.items():
        pool = (rng.integers(-127, 128, (num_pages, page_size) + t.shape[2:]).astype(np.int8)
                if t.dtype == np.int8 else
                np.full((num_pages, page_size) + t.shape[2:], np.nan, t.dtype))
        for i, n in enumerate(lens):
            for j in range(-(-n // page_size)):
                rows = t[i, j * page_size:(j + 1) * page_size]
                pool[table[i, j], :len(rows)] = rows
        pools[name] = pool
    return pools, table


def _gathered(t, table):
    return t if table is None else attention.gather_pages(t, torch.from_numpy(table))


def _rows(cache, table, b, j0, j1, kh):
    """Keys [j0, j1) of slot b, KV head kh, as f32 (int8: value * scale) —
    only those rows are touched."""
    k = _gathered(cache["k"], table)[b, j0:j1, kh].float()
    v = _gathered(cache["v"], table)[b, j0:j1, kh].float()
    if "k_scales" in cache:
        k = k * _gathered(cache["k_scales"], table)[b, j0:j1, kh]
        v = v * _gathered(cache["v_scales"], table)[b, j0:j1, kh]
    return k, v


def _torch(cache):
    return {n: torch.from_numpy(t) for n, t in cache.items()}


# --------------------------------------------------------------------------
# (b) the split-KV arithmetic
# --------------------------------------------------------------------------

def _splitkv_model(q, cache, table, kv_lens, chunk):
    """Route "splitkv" in plain PyTorch, f32: q (B, 1, H, D)."""
    b, _, h, d = q.shape
    kvh = cache["k"].shape[2]
    s = cache["k"].shape[1] * (table.shape[1] if table is not None else 1)
    g = h // kvh
    out = torch.empty(b, 1, h, d)
    for bi in range(b):
        for hi in range(h):
            kvl = min(int(kv_lens[bi * h + hi]), s)
            qs = q[bi, 0, hi].float() * d ** -0.5
            parts = []
            for j0 in range(0, kvl, chunk):  # the splits below kvl, in order
                k, v = _rows(cache, table, bi, j0, min(j0 + chunk, kvl), hi // g)
                sc = k @ qs
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), p @ v))
            big_m = max(m for m, _, _ in parts)
            lsum, acc = torch.zeros(()), torch.zeros(d)
            for m, l, a in parts:
                w = torch.exp(m - big_m)
                lsum = lsum + w * l
                acc = acc + w * a
            out[bi, 0, hi] = acc / lsum
    return out


def _pallas(q, cache, table, kv_lens, groups, *, dtype=jnp.float32, block_k=64, **mask):
    kw = dict(kv_lens=jnp.asarray(kv_lens), kv_groups=groups, interpret=True,
              block_k=cache["k"].shape[1] if table is not None else block_k, **mask)
    if table is not None:
        kw["page_table"] = jnp.asarray(table)
    if "k_scales" in cache:
        kw.update(k_scales=jnp.asarray(cache["k_scales"]), v_scales=jnp.asarray(cache["v_scales"]))
        k, v = jnp.asarray(cache["k"]), jnp.asarray(cache["v"])
    else:
        k, v = jnp.asarray(cache["k"], dtype), jnp.asarray(cache["v"], dtype)
    return np.asarray(jattention.attention(jnp.asarray(q, dtype), k, v, **kw), np.float32)


def _reference(q, cache, table, kv_lens, dtype=F32, **mask):
    t = _torch(cache)
    if "k_scales" not in t:
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return attention.reference(torch.from_numpy(q).to(dtype), t["k"], t["v"],
                               torch.from_numpy(kv_lens), k_scales=t.get("k_scales"),
                               v_scales=t.get("v_scales"),
                               page_table=None if table is None else torch.from_numpy(table),
                               **mask)


SPLITKV_CASES = [  # (lens, heads, kv heads, int8, page size)
    ((9, 64, 128, 100), 4, 4, False, None),   # below, at, a multiple of the chunk
    ((9, 64, 128, 100), 8, 2, False, None),   # GQA, G = 4
    ((9, 64, 128, 100), 8, 2, True, None),    # int8, NaN scales past kvl
    ((9, 64, 128, 100), 4, 4, False, 7),      # pages of 7
    ((70, 1, 33, 128), 8, 2, True, 7),        # all of it
]


@pytest.mark.parametrize("chunk", [16, attention.CHUNK])
@pytest.mark.parametrize("lens,h,kvh,int8,page_size", SPLITKV_CASES)
def test_splitkv_model_matches_pallas_and_reference(chunk, lens, h, kvh, int8, page_size):
    rng = np.random.default_rng(sum(lens) + 7 * h + int8 + (page_size or 0))
    q, cache, table, kv_lens = _case(rng, lens, h=h, kvh=kvh, int8=int8, page_size=page_size)
    got = _splitkv_model(torch.from_numpy(q), _torch(cache), table, kv_lens, chunk)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _pallas(q, cache, table, kv_lens, h // kvh),
                               **F32_TOL)
    torch.testing.assert_close(got, _reference(q, cache, table, kv_lens), **F32_TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [None, 7, 16])
def test_splitkv_model_bits_do_not_depend_on_the_cache_length(int8, page_size):
    """A cache far longer than every kv length (more splits, all past every
    row's length) gives the bits of the same call with S cut to the
    longest; the pool's bits are the dense cache's."""
    rng = np.random.default_rng(3 + int8)
    lens = (9, 64, 100)
    q, long, _, kv_lens = _case(rng, lens, h=8, kvh=2, int8=int8, s=1000)
    cut = {n: t[:, :max(lens)] for n, t in long.items()}
    qt = torch.from_numpy(q)
    want = _splitkv_model(qt, _torch(cut), None, kv_lens, attention.CHUNK)
    assert torch.equal(_splitkv_model(qt, _torch(long), None, kv_lens, attention.CHUNK), want)
    if page_size is not None:
        pools, table = _paged(rng, long, lens, page_size)
        assert torch.equal(_splitkv_model(qt, _torch(pools), table, kv_lens,
                                          attention.CHUNK), want)


# --------------------------------------------------------------------------
# (c) the tensor-core prefill's rounding
# --------------------------------------------------------------------------

def _mma_model(q, cache, table, kv_lens, bk=64, causal=True, prefix_len=None):
    """Route "mma" in plain PyTorch: q (B, Tq, H, D) bf16 -> bf16, keys
    below `attention.visible_prefix` seen by every query."""
    b, tq, h, d = q.shape
    kvh = cache["k"].shape[2]
    s = cache["k"].shape[1] * (table.shape[1] if table is not None else 1)
    g, c = h // kvh, d ** -0.5 * float(np.log2(np.e))
    int8 = "k_scales" in cache
    prefix = attention.visible_prefix(s, causal, prefix_len)
    out = torch.empty(b, tq, h, d, dtype=BF16)
    for bi in range(b):
        for hi in range(h):
            kvl = min(int(kv_lens[bi * h + hi]), s)
            qpos = torch.arange(tq) + kvl - tq
            qf = q[bi, :, hi].float()
            m = torch.full((tq,), NEG_INF)
            lsum, acc = torch.zeros(tq), torch.zeros(tq, d)
            for k0 in range(0, kvl, bk):
                j1 = min(k0 + bk, kvl)
                k = _gathered(cache["k"], table)[bi, k0:j1, hi // g].float()  # exact in bf16
                v = _gathered(cache["v"], table)[bi, k0:j1, hi // g].float()
                sc = qf @ k.T
                if int8:
                    sc = sc * _gathered(cache["k_scales"], table)[bi, k0:j1, hi // g, 0]
                kpos = torch.arange(k0, j1)
                seen = (kpos[None, :] <= qpos[:, None]) | (kpos[None, :] < prefix)
                sc = torch.where(seen, sc * c, NEG_INF)
                m_new = torch.maximum(m, sc.max(dim=1).values)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new[:, None])
                lsum = alpha * lsum + p.sum(dim=1)
                if int8:
                    p = p * _gathered(cache["v_scales"], table)[bi, k0:j1, hi // g, 0]
                acc = alpha[:, None] * acc + p.to(BF16).float() @ v
                m = m_new
            out[bi, :, hi] = (acc / lsum[:, None]).to(BF16)
    return out


MMA_CASES = [  # (lens, Tq, heads, kv heads, int8, page size); the smoke model's D = 16
    ((130, 70, 64), 64, 4, 4, False, None),
    ((130, 70, 64), 64, 4, 4, True, None),
    ((130, 70, 100), 70, 8, 2, False, 7),
    ((130, 70, 100), 70, 8, 2, True, 7),
]


#: the three masks: causal, prefix-LM over 90 keys (past some rows' query
#: blocks, inside others'), non-causal
MMA_MASKS = [dict(), dict(prefix_len=90), dict(causal=False)]


@pytest.mark.parametrize("mask", MMA_MASKS, ids=["causal", "prefix", "noncausal"])
@pytest.mark.parametrize("lens,tq,h,kvh,int8,page_size", MMA_CASES)
def test_mma_model_stays_within_the_bf16_gate_of_pallas(lens, tq, h, kvh, int8, page_size,
                                                         mask):
    rng = np.random.default_rng(sum(lens) + tq + int8 + (page_size or 0))
    q, cache, table, kv_lens = _case(rng, lens, tq=tq, h=h, kvh=kvh, int8=int8,
                                     page_size=page_size)
    t = _torch(cache)
    if not int8:
        t = {n: x.to(BF16) for n, x in t.items()}
    qb = torch.from_numpy(q).to(BF16)
    got = _mma_model(qb, t, table, kv_lens, **mask)
    assert torch.isfinite(got.float()).all()
    want = _pallas(qb.float().numpy(), cache if int8 else {n: x.float().numpy()
                                                           for n, x in t.items()},
                   table, kv_lens, h // kvh, dtype=jnp.bfloat16, **mask)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    torch.testing.assert_close(got.float(),
                               _reference(q, cache, table, kv_lens, BF16, **mask).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("mask", MMA_MASKS, ids=["causal", "prefix", "noncausal"])
@pytest.mark.parametrize("page_size", [None, 7])
def test_mma_model_bits_do_not_depend_on_the_cache_length(mask, page_size):
    """Under every mask a row's bits depend on its kv length alone: a cache
    far longer than every length (the non-causal launch's visible prefix
    is S, which grows with it) gives the bits of the cache cut to the
    longest, and the pool's bits are the dense cache's."""
    rng = np.random.default_rng(5 + (page_size or 0))
    lens = (130, 70, 100)
    q, long, _, kv_lens = _case(rng, lens, tq=70, h=8, kvh=2, s=400)
    cut = {n: torch.from_numpy(t[:, :max(lens)]).to(BF16) for n, t in long.items()}
    qb = torch.from_numpy(q).to(BF16)
    want = _mma_model(qb, cut, None, kv_lens, **mask)
    longb = {n: torch.from_numpy(t).to(BF16) for n, t in long.items()}
    assert torch.equal(_mma_model(qb, longb, None, kv_lens, **mask), want)
    if page_size is not None:
        pools, table = _paged(rng, long, lens, page_size)
        poolsb = {n: torch.from_numpy(t).to(BF16) for n, t in pools.items()}
        assert torch.equal(_mma_model(qb, poolsb, table, kv_lens, **mask), want)
