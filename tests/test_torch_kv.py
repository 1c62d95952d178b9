"""The int8 and paged KV cache in the port against the JAX package, on the CPU.

- `core.quant.quantize_kv` / `dequantize_kv` bitwise against
  `repro.core.quant`, all-zero rows included.
- `launch.paging.PageAllocator` against `repro.launch.paging`: the same
  outputs (and the same refusals) over a seeded random sequence of calls.
- `kernels.attention.reference` in its paged and int8 forms against the
  Pallas kernel `repro.kernels.attention.attention` in interpret mode, at
  block_k = page_size: f32 within 2e-5 (the reference's own paged tolerance,
  tests/test_paged.py), bf16 q within 1.6e-2 (one output rounding step).  A
  paged call is bitwise the dense call on the cache its table gathers.
- The cache-write helpers of `models.layers` bitwise against JAX's on the
  same K/V block; `attention_layer` over a paged and an int8 cache against
  JAX's under its `xla` backend: written cache within one int8 step (scales
  rtol 1e-5, K/V come out of f32 projections and rope summed in another
  order) and outputs within 1e-5.
- `init_cache`, `graft_pages` and `copy_pages` against JAX's.
- `serve(kv_cache=, kv_page_size=, prefix_reuse=, pool_pages=)` against
  JAX serve with backend="ref" on the f32 smoke model (int8 KV dequantizes
  in f32 on both sides): equal greedy tokens, page stats, statuses,
  preemptions and rejections; and the CLI.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import attention as jattention
from repro.launch import paging as jpaging
from repro.launch.serve import serve as jax_serve
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.core import quant
from repro_torch.kernels import attention as tattention
from repro_torch.kernels import ops
from repro_torch.launch import paging
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "stablelm-1.6b"
PAGED_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)


# --------------------------------------------------------------------------
# quantize_kv / dequantize_kv
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (1, 3, 2, 64), (3, 1, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero (token, head) row: scale 0, exact zeros
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, got = jquant.quantize_kv(jx), quant.quantize_kv(tx)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert tuple(got.scales.shape) == shape[:-1] + (1,) and got.block == (1, shape[-1])
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert float(got.scales[0, 0, 0]) == 0.0 and not got.values[0, 0, 0].any()
    for out_dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        deq = quant.dequantize_kv(got.values, got.scales, out_dtype)
        jdeq = jquant.dequantize_kv(want.values, want.scales, jdt)
        np.testing.assert_array_equal(deq.float().numpy(), np.asarray(jdeq, np.float32))


# --------------------------------------------------------------------------
# PageAllocator
# --------------------------------------------------------------------------

def _outcome(fn, *args):
    """(result, or the exception's type name) of one allocator call."""
    try:
        return fn(*args)
    except (paging.PoolExhausted, paging.PageError, jpaging.PoolExhausted,
            jpaging.PageError, AssertionError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_decides_as_the_reference(seed):
    """alloc / retain / release / free / match / register / invalidate / cow
    / can_admit over a seeded random sequence (some calls invalid on
    purpose: double frees, dead retains, exhaustion): both allocators give
    the same outputs, refusals and stats after every call."""
    rng = np.random.default_rng(seed)
    ps = 4
    mine, ref = paging.PageAllocator(12, ps), jpaging.PageAllocator(12, ps)
    prompts = [rng.integers(3, 9, size=int(n)).tolist() for n in rng.integers(1, 14, 6)]
    prompts += [prompts[0][:5] + [7, 7], list(prompts[1])]  # shared prefixes
    held = []  # page lists handed out so far (may go stale on purpose)
    for _ in range(300):
        op = rng.integers(9)
        pages = list(held[rng.integers(len(held))]) if held else [1]
        toks = prompts[rng.integers(len(prompts))]
        if op == 0:
            n = int(rng.integers(0, 5))
            got, want = _outcome(mine.alloc, n), _outcome(ref.alloc, n)
            if got and isinstance(got, list):
                held.append(got)
        elif op == 1:
            got, want = _outcome(mine.retain, pages), _outcome(ref.retain, pages)
        elif op == 2:
            got, want = _outcome(mine.release, pages), _outcome(ref.release, pages)
        elif op == 3:
            got, want = _outcome(mine.free, pages), _outcome(ref.free, pages)
        elif op == 4:
            got, want = mine.match_prefix(toks), ref.match_prefix(toks)
            if got[0]:
                held.append(got[0])
        elif op == 5:
            got, want = mine.register_prefix(toks, pages), ref.register_prefix(toks, pages)
        elif op == 6:
            got, want = mine.invalidate(pages[0]), ref.invalidate(pages[0])
        elif op == 7:
            got, want = _outcome(mine.cow, pages[0]), _outcome(ref.cow, pages[0])
            if isinstance(got, int):
                held.append([got])
        else:
            n, rec = int(rng.integers(0, 40)), int(rng.integers(0, 6))
            got, want = mine.can_admit(n, rec), ref.can_admit(n, rec)
        assert got == want, (op, got, want)
        stats = lambda a: (a.pages_live(), a.pages_shared(), a.pages_logical(),  # noqa: E731
                           a.capacity_multiplier(), a.free_pages(), a.cow_copies,
                           [a.refcount(p) for p in range(12)])
        assert stats(mine) == stats(ref)
        assert _outcome(mine.leak_check) == _outcome(ref.leak_check)


# --------------------------------------------------------------------------
# attention.reference: paged and int8 forms against the Pallas kernel
# --------------------------------------------------------------------------

def _pool_case(rng, page_size, groups, int8, b=3, tq=1, kvh=2, d=16, lens=(13, 6, 1)):
    """numpy q, a dense cache (B, S, KVH, D) with garbage past each length,
    the same keys in a pool under a shuffled table (dead entries on the
    trash page), and per-row kv_lens.  int8: values and per-(token, head)
    scales from quantize_kv, NaN scales past each length."""
    h = kvh * groups
    max_pages = -(-max(lens) // page_size)
    s = max_pages * page_size
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    dense = {}
    for name in "kv":
        x = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
        if int8:
            qt = quant.quantize_kv(torch.from_numpy(x))
            vals, sc = qt.values.numpy().copy(), qt.scales.numpy().copy()
            for i, n in enumerate(lens):
                sc[i, n:] = np.nan
            dense[name], dense[name + "_scales"] = vals, sc
        else:
            for i, n in enumerate(lens):
                x[i, n:] = np.nan
            dense[name] = x
    num_pages = 1 + b * max_pages
    perm = rng.permutation(np.arange(1, num_pages)).reshape(b, max_pages).astype(np.int32)
    for i, n in enumerate(lens):
        perm[i, -(-n // page_size):] = 0
    pools = {}
    for name, t in dense.items():
        pool = np.full((num_pages, page_size) + t.shape[2:], np.nan, np.float32).astype(t.dtype) \
            if t.dtype != np.int8 else rng.integers(-127, 128, (num_pages, page_size)
                                                    + t.shape[2:]).astype(np.int8)
        for i, n in enumerate(lens):
            for j in range(-(-n // page_size)):
                pool[perm[i, j]] = t[i, j * page_size:(j + 1) * page_size]
        pools[name] = pool
    kv_lens = np.repeat(np.asarray(lens, np.int32), h)
    return q, dense, pools, perm, kv_lens


def _torch_attend(q, ops_kw, kv_lens, groups, table=None, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in ops_kw.items()}
    if "k_scales" not in t:
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return ops.flash_attention(torch.from_numpy(q).to(dtype), t["k"], t["v"],
                               kv_lens=torch.from_numpy(kv_lens), kv_groups=groups,
                               k_scales=t.get("k_scales"), v_scales=t.get("v_scales"),
                               page_table=None if table is None else torch.from_numpy(table))


@pytest.mark.parametrize("page_size", [1, 3, 4, 8])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_and_int8_attention_match_pallas(page_size, groups, int8):
    rng = np.random.default_rng(page_size * 10 + groups * 2 + int8)
    q, dense, pools, table, kv_lens = _pool_case(rng, page_size, groups, int8)
    kw = dict(kv_lens=jnp.asarray(kv_lens), page_table=jnp.asarray(table), kv_groups=groups,
              block_k=page_size, interpret=True)
    if int8:
        kw.update(k_scales=jnp.asarray(pools["k_scales"]), v_scales=jnp.asarray(pools["v_scales"]))
    want = jattention.attention(jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
                                **kw)
    got = _torch_attend(q, pools, kv_lens, groups, table)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAGED_TOL)
    gathered = {k: tattention.gather_pages(torch.from_numpy(v), torch.from_numpy(table)).numpy()
                for k, v in pools.items()}
    assert torch.equal(got, _torch_attend(q, gathered, kv_lens, groups))


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_bf16_q_matches_pallas(int8):
    """bf16 q (and bf16 K/V unless int8): the output is rounded once."""
    rng = np.random.default_rng(7)
    q, _, pools, table, kv_lens = _pool_case(rng, 4, 2, int8, tq=3, d=32, lens=(17, 9, 5))
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    kw = dict(kv_lens=jnp.asarray(kv_lens), page_table=jnp.asarray(table), kv_groups=2,
              block_k=4, interpret=True)
    if int8:
        kw.update(k_scales=jnp.asarray(pools["k_scales"]), v_scales=jnp.asarray(pools["v_scales"]))
        k, v = jnp.asarray(pools["k"]), jnp.asarray(pools["v"])
    else:
        k, v = jb(pools["k"]), jb(pools["v"])
    want = jattention.attention(jb(q), k, v, **kw)
    got = _torch_attend(q, pools, kv_lens, 2, table, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    q, dense, pools, table, kv_lens = _pool_case(rng, 4, 1, True)
    t = {k: torch.from_numpy(v) for k, v in pools.items()}
    qt, lens, pt = torch.from_numpy(q), torch.from_numpy(kv_lens), torch.from_numpy(table)
    with pytest.raises(ValueError, match="both"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, k_scales=t["k_scales"],
                            page_table=pt)
    with pytest.raises(TypeError, match="int8"):
        ops.flash_attention(qt, t["k"].float(), t["v"].float(), kv_lens=lens,
                            k_scales=t["k_scales"], v_scales=t["v_scales"], page_table=pt)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, k_scales=t["k_scales"].double(),
                            v_scales=t["v_scales"], page_table=pt)
    with pytest.raises(ValueError, match="k_scales shape"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, k_scales=t["k_scales"][:, :2],
                            v_scales=t["v_scales"], page_table=pt)
    with pytest.raises(TypeError, match="page_table must be int32"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, k_scales=t["k_scales"],
                            v_scales=t["v_scales"], page_table=pt.long())
    with pytest.raises(ValueError, match="page_table"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, k_scales=t["k_scales"],
                            v_scales=t["v_scales"], page_table=pt[:2])
    with pytest.raises(TypeError, match="dtype"):  # int8 K/V without scales
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, page_table=pt)
    shifted = torch.zeros(t["k"].numel() + 1, dtype=torch.int8)[1:].view(t["k"].shape)
    with pytest.raises(ValueError, match="boundary"):  # staged 4 elements a load
        ops.flash_attention(qt, shifted, t["v"], kv_lens=lens, k_scales=t["k_scales"],
                            v_scales=t["v_scales"], page_table=pt)


# --------------------------------------------------------------------------
# the cache write path and attention_layer
# --------------------------------------------------------------------------

def _kv_block(rng, b=3, t=2, kvh=2, hd=16):
    return rng.standard_normal((b, t, kvh, hd)).astype(np.float32)


@pytest.mark.parametrize("per_slot", [False, True])
def test_cache_writes_are_bitwise_the_reference(per_slot):
    """The same (B, T, KVH, hd) block written by the port and by JAX: the
    dense int8 write (values + scales at pos), and the paged write in the
    model dtype and in int8 through a table (the page index clipped, dead
    entries on the trash page)."""
    rng = np.random.default_rng(int(per_slot))
    b, t, ps = 3, 2, 4
    new = _kv_block(rng, b, t)
    pos = np.array([0, 5, 11], np.int32) if per_slot else np.int32(6)
    tpos = torch.from_numpy(pos) if per_slot else int(pos)
    qt, jq = quant.quantize_kv(torch.from_numpy(new)), jquant.quantize_kv(jnp.asarray(new))
    # dense int8
    vbuf, sbuf = torch.zeros(b, 13, 2, 16, dtype=torch.int8), torch.zeros(b, 13, 2, 1)
    layers._cache_write_kv((vbuf, sbuf), qt, tpos)
    jv, js = jlayers._cache_write_kv((jnp.zeros((b, 13, 2, 16), jnp.int8),
                                      jnp.zeros((b, 13, 2, 1))), jq, jnp.asarray(pos))
    np.testing.assert_array_equal(vbuf.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(sbuf.numpy(), np.asarray(js))
    # paged: coordinates, model dtype and int8
    table = np.array([[3, 4, 0, 0], [5, 6, 7, 0], [8, 9, 10, 1]], np.int32)
    pages, offs = layers._paged_write_coords(torch.from_numpy(table), tpos, t, ps)
    jpages, joffs = jlayers._paged_write_coords(jnp.asarray(table), jnp.asarray(pos), t, ps)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    pool = torch.zeros(11, ps, 2, 16)
    layers._paged_cache_write(pool, torch.from_numpy(new), pages, offs)
    jpool = jlayers._paged_cache_write(jnp.zeros((11, ps, 2, 16)), jnp.asarray(new), jpages, joffs)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    vpool, spool = torch.zeros(11, ps, 2, 16, dtype=torch.int8), torch.zeros(11, ps, 2, 1)
    layers._paged_cache_write_kv((vpool, spool), qt, pages, offs)
    jv, js = jlayers._paged_cache_write_kv((jnp.zeros((11, ps, 2, 16), jnp.int8),
                                            jnp.zeros((11, ps, 2, 1))), jq, jpages, joffs)
    np.testing.assert_array_equal(vpool.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(spool.numpy(), np.asarray(js))


def _attn_params(rng, d=64, h=4, kv=2, hd=16):
    p = {"wq": rng.standard_normal((d, h * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, kv * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, kv * hd)) * d ** -0.5,
         "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5,
         "bq": rng.standard_normal(h * hd) * 0.1, "bk": rng.standard_normal(kv * hd) * 0.1,
         "bv": rng.standard_normal(kv * hd) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("paged,int8", [(True, False), (False, True), (True, True)])
def test_attention_layer_over_paged_and_int8_caches(paged, int8):
    """A prefill block then a ragged decode step through attention_layer, the
    port and JAX (`xla` backend) on the same params and cache: the written
    cache and the outputs agree."""
    from repro.core import blas as jblas
    rng = np.random.default_rng(3 + 2 * paged + int8)
    b, h, kv, hd, ps, s = 3, 4, 2, 16, 4, 12
    cfg = layers.AttnConfig(d_model=64, n_heads=h, n_kv=kv, head_dim=hd, use_bias=True)
    jcfg = jlayers.AttnConfig(d_model=64, n_heads=h, n_kv=kv, head_dim=hd, use_bias=True)
    p = _attn_params(rng)
    tp, jp = ({k: torch.from_numpy(v) for k, v in p.items()},
              {k: jnp.asarray(v) for k, v in p.items()})
    dt = np.int8 if int8 else np.float32
    shape = (1 + b * (s // ps), ps, kv, hd) if paged else (b, s, kv, hd)
    cache = {"k": np.zeros(shape, dt), "v": np.zeros(shape, dt)}
    if int8:
        cache.update(k_scale=np.zeros(shape[:-1] + (1,), np.float32),
                     v_scale=np.zeros(shape[:-1] + (1,), np.float32))
    if paged:
        perm = rng.permutation(np.arange(1, shape[0])).reshape(b, s // ps).astype(np.int32)
        cache["page_table"] = perm
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    with jblas.use_backend("xla"):
        for step, (t, pos) in enumerate([(5, np.zeros(b, np.int32)),
                                         (1, np.array([5, 5, 5], np.int32))]):
            x = rng.standard_normal((b, t, 64)).astype(np.float32)
            positions = pos[:, None] + np.arange(t)[None]
            tcache["pos"], jcache["pos"] = torch.from_numpy(pos), jnp.asarray(pos)
            got, tcache = layers.attention_layer(tp, torch.from_numpy(x), cfg,
                                                 positions=torch.from_numpy(positions),
                                                 cache=tcache)
            want, jcache = jlayers.attention_layer(jp, jnp.asarray(x), jcfg,
                                                   positions=jnp.asarray(positions),
                                                   cache=jcache)
            if paged:  # the layer's cache view carries no table (forward adds it)
                jcache["page_table"] = jnp.asarray(cache["page_table"])
                tcache["page_table"] = torch.from_numpy(cache["page_table"])
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
            for key in ("k", "v"):
                g, w = tcache[key].numpy(), np.asarray(jcache[key])
                if int8:  # a rounding tie may fall the other way: one int8 step
                    assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
                    np.testing.assert_allclose(tcache[key + "_scale"].numpy(),
                                               np.asarray(jcache[key + "_scale"]), rtol=1e-5)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# init_cache, graft_pages, copy_pages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_cache", ["model", "int8"])
@pytest.mark.parametrize("page_size", [0, 4])
def test_init_cache_matches_the_reference(kv_cache, page_size):
    tcfg = dataclasses.replace(get_config(ARCH, "smoke"), kv_cache_dtype=kv_cache)
    jcfg = dataclasses.replace(jax_config(ARCH, "smoke"), kv_cache_dtype=kv_cache)
    got = tf.init_cache(tcfg, 3, 17, per_slot=True, page_size=page_size, device="cpu")
    want = jtf.init_cache(jcfg, 3, 17, per_slot=True, page_size=page_size)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[1] == str(w.dtype), key
        assert not got[key].any()


@pytest.mark.parametrize("kv_cache", ["model", "int8"])
def test_graft_and_copy_pages_match_the_reference(kv_cache):
    rng = np.random.default_rng(5)
    tcfg = dataclasses.replace(get_config(ARCH, "smoke"), kv_cache_dtype=kv_cache)
    jcfg = dataclasses.replace(jax_config(ARCH, "smoke"), kv_cache_dtype=kv_cache)
    cache = {k: np.asarray(v) for k, v in
             jtf.init_cache(jcfg, 2, 8, per_slot=True, page_size=4).items()}
    mini = {k: np.asarray(v) for k, v in jtf.init_cache(jcfg, 2, 8).items()}
    for src in (cache, mini):
        for k in ("k", "v", "k_scale", "v_scale"):
            if k in src:
                vals = rng.standard_normal(src[k].shape) * 50
                src[k] = vals.astype(src[k].dtype)
    # (rows, toks, pages, offs): mini rows and positions into pool pages 1-4
    coords = [np.array(c, np.int32) for c in ([0, 0, 1, 1], [0, 3, 2, 5], [1, 2, 3, 4],
                                              [0, 3, 1, 2])]
    jc = jtf.graft_pages({k: jnp.asarray(v) for k, v in cache.items()},
                         {k: jnp.asarray(v) for k, v in mini.items()},
                         *(jnp.asarray(c) for c in coords))
    jc = jtf.copy_pages(jc, jnp.asarray([2, 4]), jnp.asarray([3, 1]))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items() if k != "pos"}
    tc["pos"] = torch.from_numpy(cache["pos"].copy())
    tf.graft_pages(tc, {k: torch.from_numpy(v) for k, v in mini.items() if k != "pos"},
                   *(torch.from_numpy(c).long() for c in coords))
    tf.copy_pages(tc, torch.tensor([2, 4]), torch.tensor([3, 1]))
    for key in jc:
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)


# --------------------------------------------------------------------------
# serve: paged and int8 KV against JAX serve
# --------------------------------------------------------------------------

PAGE_STATS = ("pages_live", "pages_shared", "cow_copies", "paged_capacity_multiplier")


@pytest.fixture(scope="module")
def params():
    """JAX's init_params(PRNGKey(0)), what JAX serve builds, as the port's."""
    jparams = jtf.init_params(jax.random.PRNGKey(0), jax_config(ARCH, "smoke"))
    return from_jax_params(jax.tree.map(np.asarray, jparams), get_config(ARCH, "smoke"),
                           device="cpu")


def _shared_prefix_prompts(vocab, n=6, sys_len=10, tail=3, seed=11):
    """tests/test_paged.py's prompts: every even request starts with one
    system prompt (10 tokens: at page size 4 its tail page is shared and is
    written next)."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(3, vocab, size=(sys_len,), dtype=np.int32)
    return [np.concatenate([sysp, rng.integers(3, vocab, size=(tail,), dtype=np.int32)])
            if i % 2 == 0 else rng.integers(3, vocab, size=(sys_len + tail,), dtype=np.int32)
            for i in range(n)]


def _both(params, **kw):
    want = jax_serve(ARCH, "smoke", eos=-1, verbose=False, backend="ref", **kw)
    got = serve(ARCH, "smoke", eos=-1, verbose=False, params=params, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("kv_cache,page_size,reuse", [
    ("int8", None, True), ("model", 4, True), ("int8", 4, True), ("model", 4, False)])
def test_kv_serve_matches_jax_serve(params, kv_cache, page_size, reuse):
    prompts = _shared_prefix_prompts(get_config(ARCH, "smoke").vocab)
    got, want = _both(params, batch=3, prompts=prompts, gen_lens=[4, 2, 5, 3, 4, 2],
                      kv_cache=kv_cache, kv_page_size=page_size, prefix_reuse=reuse)
    assert got["outputs"] == want["outputs"]
    assert got["completed"] == len(prompts) and got["status"] == want["status"]
    for key in ("tokens", "prefills", "decode_steps", "preemptions", "rejections"):
        assert got[key] == want[key], key
    if page_size:
        for key in PAGE_STATS:
            assert got[key] == want[key], key
        assert (got["pages_shared"] > 0) == reuse
        assert (got["paged_capacity_multiplier"] > 1.0) == reuse


def test_pressured_pool_preempts_as_jax_serve(params):
    """scripts/ci.sh's small pool: 6 prompts of 10 tokens, gen_lens 4-8 from
    default_rng(0), batch 2, page size 4, 7 pool pages."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, size=(10,), dtype=np.int32) for _ in range(6)]
    gen_lens = rng.integers(4, 9, size=6).tolist()
    kw = dict(batch=2, prompts=prompts, gen_lens=gen_lens, kv_page_size=4)
    got, want = _both(params, pool_pages=7, **kw)
    assert got["outputs"] == want["outputs"]
    for key in ("status", "preemptions", "rejections", "prefills", "decode_steps") + PAGE_STATS:
        assert got[key] == want[key], key
    assert got["preemptions"] >= 1 and "preempted_resumed" in got["status"]
    roomy = serve(ARCH, "smoke", eos=-1, verbose=False, params=params, device="cpu", **kw)
    assert got["outputs"] == roomy["outputs"] and roomy["preemptions"] == 0


def test_prompt_too_long_for_the_pool_is_rejected(params):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 256, size=(n,), dtype=np.int32) for n in (6, 30, 5)]
    got, want = _both(params, batch=2, prompts=prompts, gen_lens=[3, 3, 3], kv_page_size=4,
                      pool_pages=6)
    assert got["status"] == want["status"] == ["ok", "rejected", "ok"]
    assert got["outputs"] == want["outputs"] and got["outputs"][1] == []
    assert got["rejections"] == want["rejections"] == 1 and got["completed"] == 2


def test_paged_and_int8_options_are_checked():
    for kw, err in (({"kv_page_size": 0}, ValueError), ({"pool_pages": 7}, ValueError),
                    ({"kv_page_size": 4, "pool_pages": 1}, ValueError),
                    ({"kv_cache": "fp8"}, ValueError)):
        with pytest.raises(err):
            serve(ARCH, "smoke", requests=1, verbose=False, device="cpu", **kw)


def test_kv_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--kv-cache",
         "int8", "--kv-page-size", "4", "--requests", "3", "--batch", "2", "--prompt-len", "6",
         "--gen", "3"], capture_output=True, text=True, timeout=120, check=True)
    assert "[serve] stablelm-1.6b (continuous): 3 requests, 9 tokens" in out.stdout
    assert "pages" in out.stdout
