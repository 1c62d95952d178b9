"""zamba2-1.2b (hybrid Mamba2 + shared attention) in the port against the
JAX package, on the CPU.

- `kernels.mamba2.reference` (the SSD kernel's plain version, which CPU
  tensors take through `ops.mamba2_ssd`) against the Pallas kernel
  `repro.kernels.ops.mamba2_ssd` in interpret mode (from zero, T a multiple
  of the chunk and ragged, f32 and bf16), against the model's
  `repro.models.mamba.ssd_chunked` (y and the final state from a random h0,
  N != P once) and the token-by-token oracle `repro.kernels.ref.ssd`, and
  under strong decay.  f32: rtol = atol = 1e-5 on inputs of unit scale
  (the same chunked sums in another order); bf16 y: 1.6e-2 (one output
  rounding step).
- `ssd_step`, `_causal_conv` (bitwise in bf16: the reference rounds every
  product and add), `mamba_block` (with and without state, and at t = 1),
  the gelu MLP, `_shared_attn_block` with non-zero LoRA "*b" factors at two
  occurrences, `init_cache`, `forward`, `prefill` and `decode_step` against
  JAX on the same params (converted with `models.convert.from_jax_params`):
  f32 outputs and states within 1e-5, logits within 1e-4; the bf16 model's
  logits within 5% of max |logit|.
- `serve("zamba2-1.2b", scheduler="batch")` against JAX serve with
  backend="ref": equal greedy tokens and stats; the reference's ValueErrors
  for the continuous scheduler, the paged cache and speculation, and the
  port's own for --quantize int8 (where the reference crashes).
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import serve as jax_serve
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.kernels import mamba2 as tmamba2
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models import mamba
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "zamba2-1.2b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NO_EOS = -1


def _ssd_inputs(bh, t, p, n, seed, strong=False):
    """x, a_log, b, c, h0 as f32 numpy arrays: x, b, c of unit-ish scale,
    a_log = -exp(N(0, 1)) * 0.3 (the model's -exp(A) * dt), or up to -40 a
    step when `strong`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, t, p)).astype(np.float32)
    b, c = (rng.standard_normal((bh, t, n)).astype(np.float32) * 0.5 for _ in range(2))
    if strong:
        a = -40.0 * rng.random((bh, t)).astype(np.float32)
    else:
        a = (-np.exp(rng.standard_normal((bh, t))) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((bh, n, p)).astype(np.float32)
    return x, a, b, c, h0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return x.float().numpy()


# --------------------------------------------------------------------------
# The SSD kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(16, 8), (21, 8), (6, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel(t, chunk, dtype):
    """From a zero state (the Pallas body's contract); T a multiple of the
    chunk, ragged, and shorter than one chunk."""
    x, a, b, c, _ = _ssd_inputs(2, t, 16, 16, seed=t + chunk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jops.mamba2_ssd(jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b, jdt),
                           jnp.asarray(c, jdt), chunk=chunk)
    got, h_fin = ops.mamba2_ssd(_t(x, tdt), _t(a), _t(b, tdt), _t(c, tdt), chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == (2, t, 16)
    assert h_fin.dtype == torch.float32 and tuple(h_fin.shape) == (2, 16, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bfloat16" else F32_TOL))


@pytest.mark.parametrize("t,chunk,p,n", [(32, 8, 16, 16), (37, 16, 16, 16), (20, 64, 16, 16),
                                         (1, 8, 16, 16), (27, 8, 8, 16)])
def test_reference_matches_ssd_chunked_from_state(t, chunk, p, n):
    """The model's contract: y and the final state from a random h0 (T <
    chunk takes one chunk of T rows, as the reference); N != P once, so a
    swapped state layout shows."""
    x, a, b, c, h0 = _ssd_inputs(3, t, p, n, seed=7 + t)
    wy, wh = jmamba.ssd_chunked(*(jnp.asarray(z) for z in (x, a, b, c)), h0=jnp.asarray(h0),
                                chunk=chunk)
    gy, gh = ops.mamba2_ssd(*(_t(z) for z in (x, a, b, c)), h0=_t(h0), chunk=chunk)
    assert tuple(gh.shape) == (3, n, p)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **F32_TOL)
    gy2, gh2 = mamba.ssd_chunked(*(_t(z) for z in (x, a, b, c)), h0=_t(h0), chunk=chunk)
    assert torch.equal(gy2, gy) and torch.equal(gh2, gh)


@pytest.mark.parametrize("with_h0,p,n", [(False, 16, 16), (True, 16, 16), (True, 8, 16)])
def test_reference_matches_token_oracle(with_h0, p, n):
    x, a, b, c, h0 = _ssd_inputs(2, 45, p, n, seed=11)
    h0j = jnp.asarray(h0) if with_h0 else None
    wy, wh = jref.ssd(*(jnp.asarray(z) for z in (x, a, b, c)), h0=h0j)
    gy, gh = tmamba2.reference(*(_t(z) for z in (x, a, b, c)),
                               h0=_t(h0) if with_h0 else None, chunk=16)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **F32_TOL)


def test_strong_decay_stays_finite():
    """a_log down to -40 a step (L falls past -10^2 within a chunk): every
    exponent is a forward-interval sum, so nothing overflows."""
    x, a, b, c, h0 = _ssd_inputs(2, 40, 16, 16, seed=0, strong=True)
    wy, wh = jref.ssd(*(jnp.asarray(z) for z in (x, a, b, c)), h0=jnp.asarray(h0))
    gy, gh = ops.mamba2_ssd(*(_t(z) for z in (x, a, b, c)), h0=_t(h0), chunk=16)
    assert torch.isfinite(gy).all() and torch.isfinite(gh).all()
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **F32_TOL)


def test_strong_decay_at_chunk_64_matches_token_oracle():
    """The serving chunk under a_log in [-40, 0]: L falls past -10^3 within
    a chunk, where an f32 prefix sum loses ~1e-4 of every exponent
    difference.  The token oracle takes no prefix sum (one exp a step), so
    it checks the plain version's f64 sum of L independently; f32 TOL."""
    x, a, b, c, h0 = _ssd_inputs(2, 150, 16, 32, seed=5, strong=True)
    assert float(a[:, :64].sum(axis=1).max()) < -1000.0
    wy, wh = jref.ssd(*(jnp.asarray(z) for z in (x, a, b, c)), h0=jnp.asarray(h0))
    gy, gh = tmamba2.reference(*(_t(z) for z in (x, a, b, c)), h0=_t(h0), chunk=64)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **F32_TOL)


def test_ops_mamba2_ssd_validates_operands():
    x, a, b, c, h0 = (_t(z) for z in _ssd_inputs(2, 8, 16, 16, seed=1))
    with pytest.raises(TypeError, match="a_log"):
        ops.mamba2_ssd(x, a.to(torch.bfloat16), b, c)
    with pytest.raises(TypeError, match="b dtype"):
        ops.mamba2_ssd(x, a, b.to(torch.bfloat16), c)
    with pytest.raises(TypeError, match="h0"):
        ops.mamba2_ssd(x, a, b, c, h0=h0.double())
    with pytest.raises(TypeError, match="dtype must be"):
        ops.mamba2_ssd(x.double(), a, b.double(), c.double())
    with pytest.raises(ValueError, match="h0 shape"):
        ops.mamba2_ssd(x, a, b, c, h0=h0[:, :8])
    with pytest.raises(ValueError, match="a_log shape"):
        ops.mamba2_ssd(x, a[:, :4], b, c)
    with pytest.raises(ValueError, match="c shape"):
        ops.mamba2_ssd(x, a, b, c[:, :, :8])
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba2_ssd(x, a, b, c, chunk=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba2_ssd(x.transpose(0, 1).contiguous().transpose(0, 1), a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba2_ssd(x, a, b.transpose(0, 1).contiguous().transpose(0, 1), c)
    with pytest.raises(ValueError, match="on meta"):
        ops.mamba2_ssd(x, a, b.to("meta"), c)
    before = ops.launch_counts()["mamba2_ssd"]
    ops.mamba2_ssd(x, a, b, c)
    assert ops.launch_counts()["mamba2_ssd"] == before  # a CPU tensor never launches
    assert tmamba2.MAX_CHUNK == 64 and tmamba2.MAX_STATE == tmamba2.MAX_HEAD_DIM == 64


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _params(dtype="float32", seed=0, lora_seed=None):
    """JAX init_params(PRNGKey(seed)) of the smoke model (in `dtype`) and
    the same params in the port's layout.  lora_seed fills the LoRA "*b"
    factors (zeros at init) with seeded random values, so the merge and
    its occurrence index are exercised."""
    jcfg = dataclasses.replace(jax_config(ARCH, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    if lora_seed is not None:
        rng = np.random.default_rng(lora_seed)
        lora = dict(jp["shared_lora"])
        for key in ("qb", "kb", "vb"):
            vals = rng.standard_normal(lora[key].shape).astype(np.float32) * 0.3
            lora[key] = jnp.asarray(vals, lora[key].dtype)
        jp = {**jp, "shared_lora": lora}
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


def _state(cfg, b, seed):
    """A random Mamba2 block state in both layouts."""
    s, _, nh, d_xbc = mamba._dims(cfg)
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, s.conv_kernel - 1, d_xbc)).astype(np.float32)
    h = rng.standard_normal((b, nh, s.d_state, s.head_dim)).astype(np.float32)
    return ({"conv": jnp.asarray(conv), "h": jnp.asarray(h)},
            {"conv": _t(conv), "h": _t(h)})


def test_ssd_step_matches_jax():
    x, a, b, c, h0 = _ssd_inputs(4, 1, 8, 16, seed=3)
    want_y, want_h = jmamba.ssd_step(*(jnp.asarray(z[:, 0]) for z in (x, a, b, c)),
                                     jnp.asarray(h0))
    got_y, got_h = mamba.ssd_step(*(_t(z[:, 0]) for z in (x, a, b, c)), _t(h0))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_bitwise_jax(dtype, with_state):
    """In bf16 every product and add rounds to the model dtype in the
    reference (jit'd on the CPU); the port repeats the op order, so the
    result is bitwise equal (one f32 sum would differ by a bf16 ulp).  In
    f32 XLA contracts products and adds into FMAs: F32_TOL."""
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32) * 2
    w = rng.standard_normal((4, 48)).astype(np.float32) * 0.2
    bias = rng.standard_normal((48,)).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 48)).astype(np.float32) if with_state else None
    jconv = jax.jit(jmamba._causal_conv)
    want, want_st = jconv(*(jnp.asarray(z, jdt) for z in (x, w, bias)),
                          None if st is None else jnp.asarray(st, jdt))
    got, got_st = mamba._causal_conv(*(_t(z, tdt) for z in (x, w, bias)),
                                     None if st is None else _t(st, tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got_st), np.asarray(want_st, np.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("t", [1, 7, 19])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_jax(t, with_state):
    """T = 1 with a state takes ssd_step; every other call the chunked SSD
    (chunk 8: T = 19 runs three chunks, the last padded)."""
    jcfg, cfg, jp, params = _params()
    x = np.random.default_rng(t).standard_normal((2, t, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=t) if with_state else (None, None)
    want, want_st = jmamba.mamba_block(_layer(jp, 1), jnp.asarray(x), jcfg, jst)
    got, got_st = mamba.mamba_block(params["layers"][1], _t(x), cfg, tst)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got_st["h"]), np.asarray(want_st["h"]), **F32_TOL)
    np.testing.assert_allclose(_np(got_st["conv"]), np.asarray(want_st["conv"]), **F32_TOL)


@pytest.mark.parametrize("use_bias", [False, True])
def test_gelu_mlp_matches_jax(use_bias):
    rng = np.random.default_rng(2)
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 96, "gelu", jnp.float32, use_bias)
    if use_bias:  # zeros at init: make them count
        jp = {**jp, "b_up": jnp.asarray(rng.standard_normal(96), jnp.float32),
              "b_down": jnp.asarray(rng.standard_normal(32), jnp.float32)}
    params = {k: _t(v) for k, v in jp.items()}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    res = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = jlayers.mlp(jp, jnp.asarray(x), "gelu", residual=jnp.asarray(res))
    got = layers.mlp(params, _t(x), "gelu", residual=_t(res))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    own = layers.init_mlp(torch.Generator().manual_seed(0), 32, 96, "gelu", torch.float32,
                          "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: jp[k].shape for k in ("w_up", "w_down")}
    with pytest.raises(NotImplementedError, match="relu"):
        layers.mlp(params, _t(x), "relu")


@pytest.mark.parametrize("occ", [0, 1])
@pytest.mark.parametrize("with_cache", [False, True])
def test_shared_attn_block_matches_jax_with_nonzero_lora(occ, with_cache):
    """Random LoRA "*b" factors, so each occurrence merges its own delta
    into wq/wk/wv; the two occurrences give different outputs."""
    jcfg, cfg, jp, params = _params(lora_seed=4)
    rng = np.random.default_rng(occ)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jcache = tcache = None
    pos = 3 if with_cache else 0
    if with_cache:
        k = rng.standard_normal((2, 12, cfg.n_kv, cfg.hd)).astype(np.float32)
        v = rng.standard_normal((2, 12, cfg.n_kv, cfg.hd)).astype(np.float32)
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos, jnp.int32)}
        tcache = {"k": _t(k), "v": _t(v), "pos": pos}
    jpos = jnp.arange(6, dtype=jnp.int32) + pos
    want, want_c = jtf._shared_attn_block(jp, jnp.asarray(x), jcfg, jpos, occ, jcache)
    got, got_c = tf._shared_attn_block(params, _t(x), cfg, torch.arange(6) + pos, occ, tcache)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    if with_cache:
        np.testing.assert_allclose(_np(got_c["k"]), np.asarray(want_c["k"]), **F32_TOL)
        np.testing.assert_allclose(_np(got_c["v"]), np.asarray(want_c["v"]), **F32_TOL)
    other, _ = tf._shared_attn_block(params, _t(x), cfg, torch.arange(6), 1 - occ, None)
    mine, _ = tf._shared_attn_block(params, _t(x), cfg, torch.arange(6), occ, None)
    assert (other - mine).abs().max() > 1e-3


def test_model_routes_one_ssd_call_a_layer_a_prefill(monkeypatch):
    """Every projection through core.blas.matmul (bgemm at T > 1, bgemv at
    T = 1: 2 a Mamba2 block, 6 a shared-block occurrence), the LoRA merges
    through gemm (3 an occurrence, every forward), one SSD call a layer a
    prefill and none at decode; counted through the plain versions the CPU
    path takes."""
    from repro_torch.kernels import attention, bgemm, bgemv, gemm
    calls = {"bgemv": 0, "bgemm": 0, "gemm": 0, "attention": 0, "mamba2_ssd": 0}
    for mod, key in ((bgemv, "bgemv"), (bgemm, "bgemm"), (gemm, "gemm"),
                     (attention, "attention"), (tmamba2, "mamba2_ssd")):
        def counted(*a, _f=mod.reference, _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, "reference", counted)
    _, cfg, _, params = _params()
    n, occ = cfg.n_layers, cfg.n_layers // cfg.ssm.shared_attn_every
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    toks = torch.randint(3, cfg.vocab, (2, 6), dtype=torch.int32)
    _, cache = tf.prefill(params, toks, cache, cfg)
    assert calls == {"bgemv": 0, "bgemm": 2 * n + 6 * occ, "gemm": 3 * occ,
                     "attention": occ, "mamba2_ssd": n}
    tf.decode_step(params, toks[:, :1], cache, cfg)
    assert calls == {"bgemv": 2 * n + 6 * occ, "bgemm": 2 * n + 6 * occ, "gemm": 6 * occ,
                     "attention": 2 * occ, "mamba2_ssd": n}


# --------------------------------------------------------------------------
# Model: params, cache, forward, prefill, decode
# --------------------------------------------------------------------------

def test_convert_keeps_the_f32_leaves_of_a_bf16_model():
    _, cfg, jp, params = _params("bfloat16", lora_seed=1)
    blk = params["layers"][2]
    for key in ("a_log", "dt_bias", "d_skip"):
        assert blk[key].dtype == torch.float32, key
        np.testing.assert_array_equal(blk[key].numpy(), np.asarray(jp["layers"][key][2]))
    assert blk["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(params["shared_lora"]["kb"]),
                                  np.asarray(jp["shared_lora"]["kb"], np.float32))
    # the seeded init has the same leaves, shapes and dtypes
    own = tf.init_params(cfg, 0, "cpu")
    flat = lambda p: {k: (tuple(v.shape), v.dtype) for k, v in p.items()  # noqa: E731
                      if isinstance(v, torch.Tensor)}
    assert flat(own["layers"][0]) == flat(params["layers"][0])
    assert flat(own["shared_lora"]) == flat(params["shared_lora"])
    for grp in ("ln1", "ln2", "attn", "ffn"):
        assert flat(own["shared_attn"][grp]) == flat(params["shared_attn"][grp]), grp
    assert not any(own["shared_lora"][k].any() for k in ("qb", "kb", "vb"))


@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("kv_cache_dtype", ["model", "int8"])
def test_init_cache_matches_jax(variant, kv_cache_dtype):
    """The hybrid cache is built in the model dtype whatever kv_cache_dtype
    says, as the reference builds it (so --kv-cache int8 changes nothing)."""
    jcfg = dataclasses.replace(jax_config(ARCH, variant), kv_cache_dtype=kv_cache_dtype)
    cfg = dataclasses.replace(get_config(ARCH, variant), kv_cache_dtype=kv_cache_dtype)
    want = jax.eval_shape(lambda: jtf.init_cache(jcfg, 2, 16))
    got = tf.init_cache(cfg, 2, 16, device="meta" if variant == "full" else "cpu")
    assert got["pos"] == 0 and set(got) == set(want)
    dt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for grp in ("mamba", "attn"):
        assert set(got[grp]) == set(want[grp])
        for key, arr in want[grp].items():
            assert tuple(got[grp][key].shape) == arr.shape, (grp, key)
            assert got[grp][key].dtype == dt[arr.dtype], (grp, key)
            if variant == "smoke":
                assert not got[grp][key].any()
    # no per-slot or paged form: the reference's ValueErrors, word for word
    for kw in (dict(per_slot=True), dict(page_size=4)):
        with pytest.raises(ValueError) as want_err:
            jtf.init_cache(jcfg, 2, 16, **kw)
        with pytest.raises(ValueError) as got_err:
            tf.init_cache(cfg, 2, 16, device="cpu", **kw)
        assert str(got_err.value) == str(want_err.value)


def test_forward_prefill_and_decode_match_jax():
    jcfg, cfg, jp, params = _params(lora_seed=6)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, cfg.vocab, size=(3, 12), dtype=np.int32)
    want_x, _, _ = jtf.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got_x, none = tf.forward(params, torch.from_numpy(toks), cfg)
    assert none is None
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), **F32_TOL)

    jcache = jtf.init_cache(jcfg, 3, 16)
    cache = tf.init_cache(cfg, 3, 16, device="cpu")
    want, jcache = jtf.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache, jcfg)
    got, cache = tf.prefill(params, torch.from_numpy(toks), cache, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    for step in range(3):
        tok = rng.integers(3, cfg.vocab, size=(3, 1), dtype=np.int32)
        want, jcache = jtf.decode_step(jp, jnp.asarray(tok), jcache, jcfg)
        got, cache = tf.decode_step(params, torch.from_numpy(tok), cache, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
        assert cache["pos"] == 13 + step
    for grp, key in (("mamba", "h"), ("mamba", "conv"), ("attn", "k"), ("attn", "v")):
        np.testing.assert_allclose(_np(cache[grp][key]), np.asarray(jcache[grp][key]),
                                   **F32_TOL)


def test_bf16_model_logits_follow_jax():
    """The bf16 smoke model through prefill and two decode steps: the same
    op order and casts as the reference, so the logits agree to within
    bf16 rounding of the activations (5% of max |logit|, chip_smoke's
    forced-logit limit for stablelm) and the greedy tokens are equal."""
    jcfg, cfg, jp, params = _params("bfloat16", seed=2, lora_seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab, size=(2, 9), dtype=np.int32)
    jcache, cache = jtf.init_cache(jcfg, 2, 16), tf.init_cache(cfg, 2, 16, device="cpu")
    feeds = [toks] + [rng.integers(3, cfg.vocab, size=(2, 1), dtype=np.int32) for _ in range(2)]
    for i, tok in enumerate(feeds):
        jfn, tfn = (jtf.prefill, tf.prefill) if i == 0 else (jtf.decode_step, tf.decode_step)
        jin = {"tokens": jnp.asarray(tok)} if i == 0 else jnp.asarray(tok)
        want, jcache = jfn(jp, jin, jcache, jcfg)
        got, cache = tfn(params, torch.from_numpy(tok), cache, cfg)
        want = np.asarray(want, np.float32)
        assert np.abs(_np(got) - want).max() <= 0.05 * np.abs(want).max()
        np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


# --------------------------------------------------------------------------
# Serving under the batch scheduler
# --------------------------------------------------------------------------

def _prompts(n, plen, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=(plen,), dtype=np.int32) for _ in range(n)]


STAT_KEYS = ("completed", "tokens", "prefills", "decode_steps", "status", "preemptions",
             "rejections")


def test_serve_gives_the_reference_tokens():
    """JAX serve's tokens on this request set (ref and pallas backends give
    the same), reached by the port on the converted params."""
    _, _, _, params = _params()
    got = serve(ARCH, "smoke", requests=4, batch=2, prompt_len=8, gen=4, scheduler="batch",
                params=params, device="cpu", verbose=False)
    assert got["outputs"] == [[426, 371, 477, 109], [12, 347, 339, 316],
                              [264, 481, 248, 322], [30, 162, 64, 426]]
    assert (got["completed"], got["prefills"], got["decode_steps"]) == (4, 2, 6)


@pytest.mark.parametrize("gen_lens,batch", [
    ([3, 7, 4, 6, 5], 2),   # the last group has a padding row
    ([4, 2, 5], 1),         # batch 1: the head split of a (1, T, d) prefill
])
def test_serve_matches_jax_batch_serve(gen_lens, batch, monkeypatch):
    """On params with non-zero LoRA "*b" factors, handed to JAX serve in
    place of its seeded init."""
    _, _, jp, params = _params(lora_seed=2)
    monkeypatch.setattr(jtf, "init_params", lambda key, cfg: jp)
    prompts = _prompts(len(gen_lens), 10, get_config(ARCH, "smoke").vocab, len(gen_lens))
    kw = dict(batch=batch, gen_lens=gen_lens, eos=NO_EOS, prompts=prompts,
              scheduler="batch", verbose=False)
    want = jax_serve(ARCH, "smoke", backend="ref", **kw)
    got = serve(ARCH, "smoke", params=params, device="cpu", **kw)
    assert got["outputs"] == want["outputs"]
    assert [len(o) for o in got["outputs"]] == gen_lens
    for key in STAT_KEYS:
        assert got[key] == want[key], key
    assert got["occupancy"] == pytest.approx(want["occupancy"])


def test_serve_kv_int8_changes_nothing_and_quantize_int8_is_refused():
    """--kv-cache int8 leaves the hybrid cache in the model dtype (the
    reference's cache too), so it gives the plain tokens; --quantize int8
    raises the port's error (the reference crashes at the LoRA merge)."""
    _, _, _, params = _params()
    kw = dict(requests=3, batch=2, prompt_len=6, gen=3, eos=NO_EOS, scheduler="batch",
              verbose=False, params=params, device="cpu")
    plain = serve(ARCH, "smoke", **kw)
    assert serve(ARCH, "smoke", kv_cache="int8", **kw)["outputs"] == plain["outputs"]
    with pytest.raises(ValueError, match="hybrid family.*ROADMAP §3"):
        serve(ARCH, "smoke", quantize="int8", **kw)


@pytest.mark.parametrize("kw", [dict(scheduler="continuous"),
                                dict(scheduler="batch", kv_page_size=4),
                                dict(scheduler="batch", speculate=2)])
def test_hybrid_options_raise_the_reference_errors(kw):
    common = dict(requests=2, batch=2, prompt_len=4, gen=2, verbose=False)
    with pytest.raises(ValueError) as want:
        jax_serve(ARCH, "smoke", **common, **kw)
    with pytest.raises(ValueError) as got:
        serve(ARCH, "smoke", device="cpu", **common, **kw)
    assert str(got.value) == str(want.value)


def test_cli_serves_zamba_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--scheduler", "batch", "--requests", "3", "--batch", "2", "--prompt-len", "6",
         "--gen", "3"],
        capture_output=True, text=True, timeout=120, check=True)
    assert "[serve] zamba2-1.2b (batch): 3 requests, 9 tokens" in out.stdout
