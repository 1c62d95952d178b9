"""Flash attention's causal, prefix-LM and non-causal masks and head dim
256 in the port against the JAX package, on the CPU.

- `kernels.attention.reference` (the plain version CPU tensors take through
  `ops.flash_attention`) against the Pallas kernel through
  `repro.kernels.ops.flash_attention` (interpret mode, as
  tests/test_attention_engine.py runs it): every mask, D in {16, 64, 256},
  MHA, GQA and MQA, K/V dense, int8, paged and paged int8, ragged per-row
  kv lengths with garbage past them.  f32 within 2e-5 (the reference's own
  paged tolerance, tests/test_paged.py); bf16 q within 1.6e-2 (one output
  rounding step).  A paged call is bitwise the dense call on the cache its
  table gathers.
- At one query (the "splitkv" route, which has no mask code) the three
  masks give the same bits, the Pallas kernel's non-causal output.
- `visible_prefix`, `mask_name`, the per-mask launch counts (CPU calls
  count nothing) and the validation of `causal` / `prefix_len`.
- `layers.attention_layer` without a cache (prefill, encoder) and with a
  dense, int8 and paged cache under each mask, rope on and off, and
  `layers.attention_dispatch` (whisper's cross-attention, Tq != Tk),
  against JAX's under the pallas backend (the flash kernel, interpret
  mode): outputs within 1e-5 (f32 projections summed in another order),
  written caches within 1e-5 (int8: one step of the values, scales 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.core import quant
from repro_torch.kernels import attention
from repro_torch.kernels import ops
from repro_torch.models import layers

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: (causal, prefix_len): the three masks, and a prefix past every kv length
MASKS = [(True, None), (True, 6), (False, None), (True, 40)]
MASK_IDS = ["causal", "prefix", "noncausal", "prefix_past_kvl"]


def _case(rng, *, b=3, tq=4, kvh=2, groups=2, d=16, lens=(13, 7, 21), int8=False,
          page_size=None):
    """q (B, Tq, H, D) and K/V (B, S, KVH, D) in f32 (int8: values and
    per-(token, head) scales from quantize_kv), NaN past every row's length
    (int8: NaN scales over random values); with page_size the same keys in
    a shuffled pool whose dead entries point at the trash page 0.  Returns
    (q, operands for flash_attention, page table or None, kv_lens)."""
    h = kvh * groups
    s = max(lens)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    ops_kw = {}
    for name in "kv":
        x = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
        if int8:
            qt = quant.quantize_kv(torch.from_numpy(x))
            vals, sc = qt.values.numpy().copy(), qt.scales.numpy().copy()
            for i, n in enumerate(lens):
                vals[i, n:] = rng.integers(-127, 128, vals[i, n:].shape)
                sc[i, n:] = np.nan
            ops_kw[name], ops_kw[name + "_scales"] = vals, sc
        else:
            for i, n in enumerate(lens):
                x[i, n:] = np.nan
            ops_kw[name] = x
    kv_lens = np.repeat(np.asarray(lens, np.int32), h)
    if page_size is None:
        return q, ops_kw, None, kv_lens
    max_pages = -(-s // page_size)
    num_pages = 1 + b * max_pages
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, max_pages).astype(np.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // page_size):] = 0
    pools = {}
    for name, t in ops_kw.items():
        pool = (rng.integers(-127, 128, (num_pages, page_size) + t.shape[2:]).astype(np.int8)
                if t.dtype == np.int8 else
                np.full((num_pages, page_size) + t.shape[2:], np.nan, np.float32))
        for i, n in enumerate(lens):
            for j in range(-(-n // page_size)):
                rows = t[i, j * page_size:(j + 1) * page_size]
                pool[table[i, j], :len(rows)] = rows
        pools[name] = pool
    return q, pools, table, kv_lens


def _port(q, ops_kw, table, kv_lens, groups, causal, prefix_len, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in ops_kw.items()}
    if "k_scales" not in t:
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return ops.flash_attention(torch.from_numpy(q).to(dtype), t["k"], t["v"],
                               kv_lens=torch.from_numpy(kv_lens), kv_groups=groups,
                               k_scales=t.get("k_scales"), v_scales=t.get("v_scales"),
                               page_table=None if table is None else torch.from_numpy(table),
                               causal=causal, prefix_len=prefix_len)


def _pallas(q, ops_kw, table, kv_lens, groups, causal, prefix_len, dtype=jnp.float32):
    kw = dict(kv_lens=jnp.asarray(kv_lens), kv_groups=groups, causal=causal,
              prefix_len=prefix_len, block_k=ops_kw["k"].shape[1] if table is not None else 8)
    if table is not None:
        kw["page_table"] = jnp.asarray(table)
    if "k_scales" in ops_kw:
        kw.update(k_scales=jnp.asarray(ops_kw["k_scales"]),
                  v_scales=jnp.asarray(ops_kw["v_scales"]))
        k, v = jnp.asarray(ops_kw["k"]), jnp.asarray(ops_kw["v"])
    else:
        k, v = jnp.asarray(ops_kw["k"], dtype), jnp.asarray(ops_kw["v"], dtype)
    return np.asarray(jops.flash_attention(jnp.asarray(q, dtype), k, v, **kw), np.float32)


# --------------------------------------------------------------------------
# the plain version against the Pallas kernel
# --------------------------------------------------------------------------

#: (D, KV heads, groups): MHA at the smoke width, GQA at whisper's head dim,
#: MQA at paligemma's (one KV head for 4 query heads)
HEADS = [(16, 4, 1), (64, 2, 2), (256, 1, 4)]
FORMS = [(False, None), (True, None), (False, 4), (True, 3)]
FORM_IDS = ["dense", "int8", "paged", "paged_int8"]


@pytest.mark.parametrize("causal,prefix_len", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("d,kvh,groups", HEADS, ids=[f"D{d}" for d, _, _ in HEADS])
@pytest.mark.parametrize("int8,page_size", FORMS, ids=FORM_IDS)
def test_reference_matches_pallas_under_every_mask(causal, prefix_len, d, kvh, groups, int8,
                                                   page_size):
    rng = np.random.default_rng(d + 3 * kvh + int8 + (page_size or 0) + (prefix_len or 0))
    q, ops_kw, table, kv_lens = _case(rng, tq=5, kvh=kvh, groups=groups, d=d, int8=int8,
                                      page_size=page_size)
    got = _port(q, ops_kw, table, kv_lens, groups, causal, prefix_len)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               _pallas(q, ops_kw, table, kv_lens, groups, causal, prefix_len),
                               **F32_TOL)
    if table is not None:
        gathered = {k: attention.gather_pages(torch.from_numpy(v), torch.from_numpy(table)).numpy()
                    for k, v in ops_kw.items()}
        assert torch.equal(got, _port(q, gathered, None, kv_lens, groups, causal, prefix_len))


@pytest.mark.parametrize("causal,prefix_len", MASKS[:3], ids=MASK_IDS[:3])
@pytest.mark.parametrize("int8", [False, True])
def test_bf16_reference_matches_pallas(causal, prefix_len, int8):
    """bf16 q (and K/V unless int8) at paligemma's head dim under MQA."""
    rng = np.random.default_rng(11 + int8)
    q, ops_kw, _, kv_lens = _case(rng, tq=6, kvh=1, groups=4, d=256, int8=int8)
    got = _port(q, ops_kw, None, kv_lens, 4, causal, prefix_len, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _pallas(q, ops_kw, None, kv_lens, 4, causal, prefix_len, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("d,kvh,groups", HEADS, ids=[f"D{d}" for d, _, _ in HEADS])
@pytest.mark.parametrize("int8,page_size", FORMS, ids=FORM_IDS)
def test_one_query_sees_every_key_below_kvl_under_every_mask(d, kvh, groups, int8, page_size):
    """At Tq = 1 the query sits at kvl - 1, so the causal, prefix-LM and
    non-causal masks see the same keys: the "splitkv" route carries no mask
    code, and the plain version gives the same bits under each; they are
    the Pallas kernel's non-causal output (whisper's cross-attention
    decode)."""
    rng = np.random.default_rng(d + int8 + (page_size or 0))
    q, ops_kw, table, kv_lens = _case(rng, tq=1, kvh=kvh, groups=groups, d=d, int8=int8,
                                      page_size=page_size)
    outs = [_port(q, ops_kw, table, kv_lens, groups, c, p) for c, p in MASKS]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    np.testing.assert_allclose(outs[0].numpy(),
                               _pallas(q, ops_kw, table, kv_lens, groups, False, None), **F32_TOL)


def test_prefix_masks_between_causal_and_noncausal():
    """prefix_len 0 is the causal mask, a prefix at or past every key the
    non-causal one; a prefix in between differs from both (the mask is
    live); causal=False ignores prefix_len."""
    rng = np.random.default_rng(5)
    q, ops_kw, _, kv_lens = _case(rng, tq=6, lens=(13, 7, 21))
    run = lambda c, p: _port(q, ops_kw, None, kv_lens, 2, c, p)  # noqa: E731
    assert torch.equal(run(True, 0), run(True, None))
    assert torch.equal(run(True, 21), run(False, None))
    assert torch.equal(run(False, 9), run(False, None))
    mid = run(True, 9)
    assert not torch.equal(mid, run(True, None)) and not torch.equal(mid, run(False, None))


def test_visible_prefix_and_mask_names():
    assert attention.visible_prefix(100) == 0
    assert attention.visible_prefix(100, prefix_len=256) == 100
    assert attention.visible_prefix(400, prefix_len=256) == 256
    assert attention.visible_prefix(400, causal=False, prefix_len=7) == 400
    assert [attention.mask_name(c, p) for c, p in MASKS] == [
        "causal", "prefix", "noncausal", "prefix"]
    assert attention.mask_name(True, 0) == "causal"


def test_mask_arguments_are_checked_and_cpu_calls_count_nothing():
    rng = np.random.default_rng(1)
    q, ops_kw, _, kv_lens = _case(rng)
    t = {k: torch.from_numpy(v) for k, v in ops_kw.items()}
    qt, lens = torch.from_numpy(q), torch.from_numpy(kv_lens)
    with pytest.raises(TypeError, match="causal"):
        ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, kv_groups=2, causal=1)
    for bad in (-1, 2.0):
        with pytest.raises(ValueError, match="prefix_len"):
            ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, kv_groups=2, prefix_len=bad)
    ops.reset_launch_counts()
    ops.flash_attention(qt, t["k"], t["v"], kv_lens=lens, kv_groups=2, causal=False)
    assert set(ops.attention_masks().values()) == {0}


def test_head_dim_256_plans_every_route():
    for tq, dtype, route in ((1, torch.float32, "splitkv"), (1, torch.bfloat16, "splitkv"),
                             (384, torch.bfloat16, "mma"), (384, torch.float32, "ffma")):
        for int8 in (False, True):
            assert attention.plan(4, tq, 8, 1, 256, 416, dtype, int8).route == route


# --------------------------------------------------------------------------
# attention_layer and attention_dispatch against JAX's (pallas backend)
# --------------------------------------------------------------------------

def _attn_params(rng, d, h, kvh, hd, bias):
    p = {"wq": rng.standard_normal((d, h * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, kvh * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, kvh * hd)) * d ** -0.5,
         "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5}
    if bias:
        p.update(bq=rng.standard_normal(h * hd) * 0.3, bk=rng.standard_normal(kvh * hd) * 0.3,
                 bv=rng.standard_normal(kvh * hd) * 0.3)
    return {k: v.astype(np.float32) for k, v in p.items()}


LAYER_CASES = [  # (causal, prefix_len, use_rope, hd, kv heads)
    (True, 5, True, 16, 1),      # paligemma: prefix-LM, MQA, rope
    (False, None, False, 16, 4),  # whisper's encoder: non-causal, no rope
    (True, None, False, 16, 4),  # whisper's decoder self-attention
    (True, 5, True, 256, 1),     # paligemma's head dim
]


@pytest.mark.parametrize("causal,prefix_len,use_rope,hd,kvh", LAYER_CASES)
def test_cacheless_attention_layer_matches_jax(causal, prefix_len, use_rope, hd, kvh):
    rng = np.random.default_rng(hd + kvh + causal)
    d, h, b, t = 32, 4, 2, 11
    p = _attn_params(rng, d, h, kvh, hd, bias=not use_rope)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    res = rng.standard_normal((b, t, d)).astype(np.float32)
    kw = dict(d_model=d, n_heads=h, n_kv=kvh, head_dim=hd, use_bias=not use_rope,
              causal=causal, use_rope=use_rope)
    with jblas.use_backend("pallas"):
        want, _ = jlayers.attention_layer({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x), jlayers.AttnConfig(**kw),
                                          positions=jnp.arange(t), prefix_len=prefix_len,
                                          residual=jnp.asarray(res))
    got, none = layers.attention_layer({k: torch.from_numpy(v) for k, v in p.items()},
                                       torch.from_numpy(x), layers.AttnConfig(**kw),
                                       positions=torch.arange(t), prefix_len=prefix_len,
                                       residual=torch.from_numpy(res))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("form", ["dense", "int8", "paged"])
@pytest.mark.parametrize("causal,prefix_len", MASKS[:3], ids=MASK_IDS[:3])
def test_cached_attention_layer_matches_jax(form, causal, prefix_len):
    """A prefill of 7 tokens then a decode step at ragged per-slot
    positions, over a dense, int8 or paged (page 4) cache, each mask."""
    rng = np.random.default_rng(len(form) + causal + (prefix_len or 0))
    d, h, kvh, hd, b, s = 32, 4, 1, 16, 2, 16
    p = _attn_params(rng, d, h, kvh, hd, bias=False)
    kw = dict(d_model=d, n_heads=h, n_kv=kvh, head_dim=hd, causal=causal)
    jcfg, tcfg = jlayers.AttnConfig(**kw), layers.AttnConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if form == "paged":
        table = np.asarray([[3, 5, 1, 0], [2, 4, 6, 7]], np.int32)
        shape = (8, 4, kvh, hd)
    else:
        shape = (b, s, kvh, hd)
    if form == "int8":
        zeros = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
                 "k_scale": np.zeros(shape[:-1] + (1,), np.float32),
                 "v_scale": np.zeros(shape[:-1] + (1,), np.float32)}
    else:
        zeros = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    jc = {k: jnp.asarray(v) for k, v in zeros.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in zeros.items()}
    if form == "paged":
        jc["page_table"], tc["page_table"] = jnp.asarray(table), torch.from_numpy(table)
    steps = [(7, 0, 0), (1, np.asarray([7, 5], np.int32), None)]
    for t, jpos, tpos in steps:
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        if tpos is None:
            tpos = torch.from_numpy(jpos)
            positions = (jnp.asarray(jpos)[:, None] + jnp.arange(t)[None], tpos[:, None]
                         + torch.arange(t)[None])
        else:
            positions = (jnp.arange(t), torch.arange(t))
        with jblas.use_backend("pallas"):
            want, jnew = jlayers.attention_layer(jp, jnp.asarray(x), jcfg,
                                                 positions=positions[0],
                                                 cache={**jc, "pos": jnp.asarray(jpos)},
                                                 prefix_len=prefix_len)
        got, tnew = layers.attention_layer(tp, torch.from_numpy(x), tcfg, positions=positions[1],
                                           cache={**tc, "pos": tpos}, prefix_len=prefix_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
        jc = {k: v for k, v in jnew.items() if k != "pos"}
        if form == "paged":
            jc["page_table"] = jnp.asarray(table)
        for key in ("k", "v"):
            if form == "int8":
                diff = np.abs(tnew[key].numpy().astype(np.int32)
                              - np.asarray(jnew[key]).astype(np.int32))
                assert diff.max() <= 1
                np.testing.assert_allclose(tnew[key + "_scale"].numpy(),
                                           np.asarray(jnew[key + "_scale"]), rtol=1e-5)
            else:
                np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **LAYER_TOL)


@pytest.mark.parametrize("tq,kvh", [(5, 4), (1, 4), (6, 2)])
def test_attention_dispatch_matches_jax_cross_attention(tq, kvh):
    """Whisper's cross-attention: q from the decoder (Tq tokens) over the
    encoder's K/V (Tk = 13 frames), non-causal, K/V un-expanded."""
    rng = np.random.default_rng(tq + kvh)
    h, hd, tk = 4, 16, 13
    q = rng.standard_normal((2, tq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, tk, kvh, hd)).astype(np.float32) for _ in range(2))
    with jblas.use_backend("pallas"):
        want = jlayers.attention_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=False, groups=h // kvh)
    got = layers.attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    causal=False, groups=h // kvh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
