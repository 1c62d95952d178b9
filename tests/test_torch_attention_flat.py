"""Flash attention's flat (BH, T, D) layout and optional kv_lens in the port
against the JAX package, on the CPU.

`repro_torch.kernels.ops.flash_attention` on CPU tensors runs the plain
version (`kernels.attention.reference`, which runs flat operands as their
cache-layout views); the JAX side runs `repro.kernels.ops.flash_attention`,
the Pallas kernel in interpret mode, as tests/test_kernels.py:124-240 and
tests/test_attention_engine.py:44-58 run it.  Same numpy inputs through
both: the reference's sweep, padded lengths, int8 K/V, GQA, per-row kv
lengths and prefix-LM cases, kv_lens None in both layouts, and a page table
with flat operands refused by both.

Tolerances: f32 rtol = atol = 1e-5 (the softmax summed in another order);
bf16 q/K/V 2e-2 (one bf16 rounding step of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro_torch.kernels import attention, ops

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype in (np.int8, np.int32):
        return jnp.asarray(a), torch.from_numpy(a.copy())
    a = a.astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, dtype="float32"):
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def _packed(rng, rows, tk, d):
    """int8 K and V (values, per-(token, row) f32 scales) from the JAX
    package's quantize_kv, as numpy."""
    out = []
    for _ in range(2):
        qt = jquant.quantize_kv(jnp.asarray(rng.standard_normal((rows, tk, d)), jnp.float32))
        out += [np.array(qt.values), np.array(qt.scales)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,d,causal", [
    (256, 256, 64, True), (128, 256, 64, True), (1, 256, 64, True), (128, 128, 128, False)])
def test_flat_sweep_matches_pallas(tq, tk, d, causal, dtype):
    """test_kernels.py's sweep: square, decode-aligned (queries at the end of
    the keys), single-token decode and non-causal, kv_lens None."""
    rng = np.random.default_rng(tq * tk + d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal((3, n, d)), dtype)
                                    for n in (tq, tk, tk))
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=max(1, min(64, tq)),
                                block_k=64)
    _close(ops.flash_attention(qt, kt, vt, causal=causal), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("tq,tk,causal", [
    (128, 100, False), (100, 100, False), (100, 100, True), (1, 100, True), (60, 200, True)])
def test_flat_padded_lengths_match_pallas(tq, tk, causal):
    """Key counts off the block size; the causal offset from the real
    lengths (queries aligned to the end of the keys)."""
    rng = np.random.default_rng(tq * 31 + tk)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal((2, n, 64))) for n in (tq, tk, tk))
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=64, block_k=64)
    _close(ops.flash_attention(qt, kt, vt, causal=causal), want)


@pytest.mark.parametrize("tq,tk,d,causal", [
    (128, 128, 64, True), (1, 256, 64, True), (100, 100, 32, True), (60, 200, 32, True),
    (64, 128, 64, False)])
def test_flat_int8_kv_matches_pallas(tq, tk, d, causal):
    """int8 K/V with per-(token, row) f32 scales (BH, Tk, 1), dequantized in
    f32, in the flat layout."""
    rng = np.random.default_rng(tq * 131 + tk)
    qj, qt = _pair(rng.standard_normal((3, tq, d)))
    (k8j, k8t), (ksj, kst), (v8j, v8t), (vsj, vst) = (_pair(a) for a in _packed(rng, 3, tk, d))
    want = jops.flash_attention(qj, k8j, v8j, k_scales=ksj, v_scales=vsj, causal=causal,
                                block_q=64, block_k=64)
    got = ops.flash_attention(qt, k8t, v8t, k_scales=kst, v_scales=vst, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tq", [16, 1])
def test_flat_gqa_matches_pallas(quantized, tq):
    """kv_groups = 3: query row r reads KV row r // 3, dense and int8, at a
    prefill and a decode step."""
    b, h, kvh, tk, d = 2, 6, 2, 96, 32
    g = h // kvh
    rng = np.random.default_rng(9 + tq)
    qj, qt = _pair(rng.standard_normal((b * h, tq, d)))
    if quantized:
        (kj, kt), (ksj, kst), (vj, vt), (vsj, vst) = (_pair(a) for a in _packed(rng, b * kvh,
                                                                                 tk, d))
        kw_j, kw_t = dict(k_scales=ksj, v_scales=vsj), dict(k_scales=kst, v_scales=vst)
    else:
        (kj, kt), (vj, vt) = (_pair(rng.standard_normal((b * kvh, tk, d))) for _ in range(2))
        kw_j = kw_t = {}
    want = jops.flash_attention(qj, kj, vj, kv_groups=g, causal=True, block_k=64, **kw_j)
    _close(ops.flash_attention(qt, kt, vt, kv_groups=g, **kw_t), want)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tq,g", [(1, 1), (1, 2), (4, 2)])
def test_flat_per_row_kv_lens_match_pallas(quantized, tq, g):
    """kv_lens (BH,): a first block, a ragged middle, the whole range and a
    single visible key (at decode), NaN past every row's length."""
    bh, tk, d = 6, 160, 32
    lens = np.asarray([5, 37, 64, 160, 1, 97] if tq == 1 else [5, 37, 64, 160, 4, 97],
                      np.int32)
    rng = np.random.default_rng(13 + tq + g)
    qj, qt = _pair(rng.standard_normal((bh, tq, d)))
    lj, lt = _pair(lens)
    rows = bh // g
    if quantized:
        k8, ks, v8, vs = _packed(rng, rows, tk, d)
        for r in range(rows):
            top = lens[r * g:(r + 1) * g].max()
            ks[r, top:] = vs[r, top:] = np.nan
        (kj, kt), (ksj, kst), (vj, vt), (vsj, vst) = (_pair(a) for a in (k8, ks, v8, vs))
        kw_j, kw_t = dict(k_scales=ksj, v_scales=vsj), dict(k_scales=kst, v_scales=vst)
    else:
        k, v = (rng.standard_normal((rows, tk, d)) for _ in range(2))
        for r in range(rows):
            top = lens[r * g:(r + 1) * g].max()
            k[r, top:] = v[r, top:] = np.nan
        (kj, kt), (vj, vt) = _pair(k), _pair(v)
        kw_j = kw_t = {}
    want = jops.flash_attention(qj, kj, vj, kv_lens=lj, kv_groups=g, causal=True, block_k=64,
                                **kw_j)
    _close(ops.flash_attention(qt, kt, vt, kv_lens=lt, kv_groups=g, **kw_t), want)


@pytest.mark.parametrize("tq,tk,pfx", [(16, 16, 4), (97, 97, 5), (64, 64, 33)])
def test_flat_prefix_lm_matches_pallas(tq, tk, pfx):
    """test_attention_engine.py's prefix-LM cases at D = 32: the first pfx
    keys seen by every query, causal after; the prefix changes the result."""
    rng = np.random.default_rng(tq + pfx)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal((4, n, 32))) for n in (tq, tk, tk))
    want = jops.flash_attention(qj, kj, vj, causal=True, prefix_len=pfx, block_q=32, block_k=32)
    got = ops.flash_attention(qt, kt, vt, prefix_len=pfx)
    _close(got, want)
    assert (got - ops.flash_attention(qt, kt, vt)).abs().max() > 1e-3


@pytest.mark.parametrize("layout", ["flat", "cache"])
@pytest.mark.parametrize("tq", [1, 12])
def test_kv_lens_none_sees_every_key_in_both_layouts(layout, tq):
    """kv_lens None: every row's length is S and the queries align to the
    end of the keys, in the flat and the cache layout, as the reference;
    the same as kv_lens = S for every row."""
    b, h, kvh, s, d = 2, 4, 2, 40, 16
    rng = np.random.default_rng(21 + tq)
    if layout == "flat":
        shapes = ((b * h, tq, d), (b * kvh, s, d))
    else:
        shapes = ((b, tq, h, d), (b, s, kvh, d))
    qj, qt = _pair(rng.standard_normal(shapes[0]))
    (kj, kt), (vj, vt) = (_pair(rng.standard_normal(shapes[1])) for _ in range(2))
    want = jops.flash_attention(qj, kj, vj, kv_groups=h // kvh, causal=True, block_k=16)
    got = ops.flash_attention(qt, kt, vt, kv_groups=h // kvh)
    _close(got, want)
    lens = torch.full((b * h,), s, dtype=torch.int32)
    assert torch.equal(got, ops.flash_attention(qt, kt, vt, kv_lens=lens, kv_groups=h // kvh))


def test_flat_is_the_cache_layout_view():
    """A flat call is the cache-layout call on its views (B = BH / g, H = g,
    KVH = 1): the same bits, and the views share the operands' memory."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((8, 5, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
            for _ in range(2))
    q4, k4, v4, ks4, vs4 = attention.cache_view(q, k, v, kv_groups=4)
    assert q4.shape == (2, 5, 4, 16) and k4.shape == (2, 9, 1, 16) and ks4 is vs4 is None
    assert q4.data_ptr() == q.data_ptr() and q4.stride() == (320, 16, 80, 1)
    assert torch.equal(ops.flash_attention(q, k, v, kv_groups=4),
                       ops.flash_attention(q4.contiguous(), k4, v4, kv_groups=4)
                       .transpose(1, 2).reshape(8, 5, 16))


def test_flat_operands_refuse_a_page_table_as_the_reference():
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng.standard_normal((4, 1, 16)))
    kj, kt = _pair(rng.standard_normal((4, 8, 16)))
    table_j, table_t = _pair(np.zeros((4, 1), np.int32))
    with pytest.raises(ValueError, match="page_table requires"):
        ops.flash_attention(qt, kt, kt, page_table=table_t)
    with pytest.raises(ValueError, match="page_table requires"):
        jops.flash_attention(qj, kj, kj, page_table=table_j)


def test_flat_calls_count_nothing_on_the_cpu():
    """CPU calls take the plain version and count no launch; the layout
    counters have a key for each route and layout."""
    ops.reset_launch_counts()
    q = torch.randn(4, 3, 16)
    ops.flash_attention(q, q, q)
    assert set(ops.attention_layouts()) == {f"{r}/{lay}" for r in attention.ROUTES
                                            for lay in attention.LAYOUTS}
    assert set(ops.attention_layouts().values()) == {0}
    assert set(ops.launch_counts().values()) == {0}


def test_flat_wrapper_checks_its_operands():
    q, k = torch.randn(6, 2, 16), torch.randn(3, 8, 16)
    with pytest.raises(ValueError, match="does not match"):
        ops.flash_attention(q, k, k, kv_groups=3)
    with pytest.raises(ValueError, match="kv_lens shape"):
        ops.flash_attention(q, k, k, kv_groups=2, kv_lens=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="flat"):
        ops.flash_attention(q, k[:, :, None], k[:, :, None], kv_groups=2)
    with pytest.raises(ValueError, match="kv_groups"):
        ops.flash_attention(q, k, k, kv_groups=0)
    k8 = torch.zeros(3, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scales shape"):
        ops.flash_attention(q, k8, k8, kv_groups=2, k_scales=torch.ones(3, 8),
                            v_scales=torch.ones(3, 8))
