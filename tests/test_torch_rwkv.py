"""rwkv6-1.6b in the port against the JAX package, on the CPU.

- `kernels.rwkv6.reference` (the WKV6 kernel's plain version, which CPU
  tensors take through `ops.rwkv6`) against the Pallas kernel
  `repro.kernels.ops.rwkv6` in interpret mode (chunks 8/16/32, T a multiple
  of the chunk and ragged, f32 and bf16), against the model's
  `repro.models.rwkv.wkv6_chunked` (y and the final state from a random
  initial state), against the token-by-token oracle `repro.kernels.ref.rwkv6`
  and under strong decay.  f32: rtol = atol = 1e-5 on inputs of unit scale
  (the same chunked sums in another order); bf16 y: 1.6e-2 (one output
  rounding step).
- `wkv6_step`, `time_mix`, `channel_mix`, `rwkv_block` (with and without
  state), `init_cache`, `forward`, `prefill` and `decode_step` against JAX
  on the same params (converted with `models.convert.from_jax_params`):
  f32 outputs and states within 1e-5, logits within 1e-4.
- `serve("rwkv6-1.6b", scheduler="batch")` against JAX serve with
  backend="ref": equal greedy tokens and stats; the reference's ValueErrors
  for the continuous scheduler, the paged cache and speculation.
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
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as trwkv6
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models import rwkv
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "rwkv6-1.6b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NO_EOS = -1


def _wkv_inputs(bh, t, kk, seed, scale=0.5):
    """r, k, v, w_log, u, s0 as f32 numpy arrays of unit-ish scale."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, t, kk)).astype(np.float32) * scale for _ in range(3))
    w = -np.exp(rng.standard_normal((bh, t, kk))).astype(np.float32)
    u = rng.standard_normal((bh, kk)).astype(np.float32) * scale
    s0 = rng.standard_normal((bh, kk, kk)).astype(np.float32)
    return r, k, v, w, u, s0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return x.float().numpy()


# --------------------------------------------------------------------------
# The WKV6 kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel(chunk, ragged, dtype):
    t = 2 * chunk + (5 if ragged else 0)
    r, k, v, w, u, _ = _wkv_inputs(2, t, 16, seed=chunk + t)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jin = [jnp.asarray(a, jdt) for a in (r, k, v, w, u)]
    want = jops.rwkv6(*jin, chunk=chunk)
    # the port takes w and u in f32: the bf16 values cast exactly
    got, s_fin = ops.rwkv6(*(_t(a, tdt) for a in (r, k, v)),
                           *(_t(np.asarray(a, np.float32)) for a in jin[3:]), chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == (2, t, 16)
    assert s_fin.dtype == torch.float32 and tuple(s_fin.shape) == (2, 16, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bfloat16" else F32_TOL))


@pytest.mark.parametrize("t,chunk", [(32, 8), (37, 16), (20, 32), (1, 8)])
def test_reference_matches_wkv6_chunked_from_state(t, chunk):
    """The model's contract: y and the final state from a random s0 (T < chunk
    takes one chunk of T rows, as the reference)."""
    r, k, v, w, u, s0 = _wkv_inputs(3, t, 16, seed=7 + t)
    wy, ws = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                s0=jnp.asarray(s0), chunk=chunk)
    gy, gs = ops.rwkv6(*(_t(a) for a in (r, k, v, w, u)), s0=_t(s0), chunk=chunk)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gs), np.asarray(ws), **F32_TOL)
    gy2, gs2 = rwkv.wkv6_chunked(*(_t(a) for a in (r, k, v, w, u)), s0=_t(s0), chunk=chunk)
    assert torch.equal(gy2, gy) and torch.equal(gs2, gs)


@pytest.mark.parametrize("with_s0", [False, True])
def test_reference_matches_token_oracle(with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(2, 45, 16, seed=11)
    s0j = jnp.asarray(s0) if with_s0 else None
    wy, ws = jref.rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), s0=s0j)
    gy, gs = trwkv6.reference(*(_t(a) for a in (r, k, v, w, u)),
                              s0=_t(s0) if with_s0 else None, chunk=16)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gs), np.asarray(ws), **F32_TOL)


def test_strong_decay_stays_finite():
    """tests/test_kernels.py's strong-decay case (w = -15, decay ~3e-7 a
    step): every exponent is a forward-interval sum, so nothing overflows."""
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32) for _ in range(3))
    w = np.full((2, 64, 16), -15.0, np.float32)
    u = np.zeros((2, 16), np.float32)
    want, _ = jref.rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    pallas = jops.rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=16)
    got, s_fin = ops.rwkv6(*(_t(a) for a in (r, k, v, w, u)), chunk=16)
    assert torch.isfinite(got).all() and torch.isfinite(s_fin).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), **F32_TOL)


def test_ops_rwkv6_validates_operands():
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(2, 8, 16, seed=1))
    with pytest.raises(TypeError, match="w_log"):
        ops.rwkv6(r, k, v, w.to(torch.bfloat16), u)
    with pytest.raises(TypeError, match="k dtype"):
        ops.rwkv6(r, k.to(torch.bfloat16), v, w, u)
    with pytest.raises(ValueError, match="s0 shape"):
        ops.rwkv6(r, k, v, w, u, s0=s0[:, :8])
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6(r, k, v, w, u, chunk=0)
    before = ops.launch_counts()["rwkv6"]
    ops.rwkv6(r, k, v, w, u)
    assert ops.launch_counts()["rwkv6"] == before  # a CPU tensor never launches


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _params(dtype="float32", seed=0):
    """JAX init_params(PRNGKey(seed)) of the smoke model (in `dtype`) and
    the same params in the port's layout."""
    jcfg = dataclasses.replace(jax_config(ARCH, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


def _state(cfg, b, seed):
    """A random block state in both layouts."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    tm_x = rng.standard_normal((b, d)).astype(np.float32)
    s = rng.standard_normal((b, d // hd, hd, hd)).astype(np.float32)
    cm_x = rng.standard_normal((b, d)).astype(np.float32)
    jst = {"tm": {"x_prev": jnp.asarray(tm_x), "s": jnp.asarray(s)},
           "cm": {"x_prev": jnp.asarray(cm_x)}}
    tst = {"tm": {"x_prev": _t(tm_x), "s": _t(s)}, "cm": {"x_prev": _t(cm_x)}}
    return jst, tst


def test_wkv6_step_matches_jax():
    r, k, v, w, u, s0 = _wkv_inputs(4, 1, 16, seed=3)
    want_y, want_s = jrwkv.wkv6_step(*(jnp.asarray(a[:, 0]) for a in (r, k, v, w)),
                                     jnp.asarray(u), jnp.asarray(s0))
    got_y, got_s = rwkv.wkv6_step(*(_t(a[:, 0]) for a in (r, k, v, w)), _t(u), _t(s0))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s), **F32_TOL)


@pytest.mark.parametrize("t", [1, 7, 19])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_mix_match_jax(t, with_state):
    jcfg, cfg, jp, params = _params()
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=t) if with_state else (None, None)
    jl, tl = _layer(jp, 1), params["layers"][1]
    want, want_st = jrwkv.time_mix(jl["tm"], jnp.asarray(x), jcfg,
                                   None if jst is None else jst["tm"])
    got, got_st = rwkv.time_mix(tl["tm"], _t(x), cfg, None if tst is None else tst["tm"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got_st["s"]), np.asarray(want_st["s"]), **F32_TOL)
    np.testing.assert_array_equal(_np(got_st["x_prev"]), np.asarray(want_st["x_prev"]))
    want, _ = jrwkv.channel_mix(jl["cm"], jnp.asarray(x), None if jst is None else jst["cm"])
    got, _ = rwkv.channel_mix(tl["cm"], _t(x), None if tst is None else tst["cm"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_block_matches_jax(with_state):
    jcfg, cfg, jp, params = _params()
    x = np.random.default_rng(5).standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 3, seed=6) if with_state else (None, None)
    want, want_st = jrwkv.rwkv_block(_layer(jp, 0), jnp.asarray(x), jcfg, jst)
    got, got_st = rwkv.rwkv_block(params["layers"][0], _t(x), cfg, tst)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got_st["tm"]["s"]), np.asarray(want_st["tm"]["s"]),
                               **F32_TOL)
    for grp in ("tm", "cm"):  # the normed inputs of the two mixes
        np.testing.assert_allclose(_np(got_st[grp]["x_prev"]),
                                   np.asarray(want_st[grp]["x_prev"]), **F32_TOL)


def test_block_runs_ten_projections_and_one_wkv6_launch_a_prefill(monkeypatch):
    """Every projection through core.blas.matmul (bgemm at T > 1, bgemv at
    T = 1) and one WKV6 call a prefill, none at decode: counted through the
    plain versions the CPU path takes."""
    from repro_torch.kernels import bgemm, bgemv
    calls = {"bgemv": 0, "bgemm": 0, "rwkv6": 0}
    for mod, key in ((bgemv, "bgemv"), (bgemm, "bgemm"), (trwkv6, "rwkv6")):
        def counted(*a, _f=mod.reference, _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, "reference", counted)
    _, cfg, _, params = _params()
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    toks = torch.randint(3, cfg.vocab, (2, 6), dtype=torch.int32)
    _, cache = tf.prefill(params, toks, cache, cfg)
    assert calls == {"bgemv": 0, "bgemm": 10 * cfg.n_layers, "rwkv6": cfg.n_layers}
    tf.decode_step(params, toks[:, :1], cache, cfg)
    assert calls == {"bgemv": 10 * cfg.n_layers, "bgemm": 10 * cfg.n_layers,
                     "rwkv6": cfg.n_layers}


# --------------------------------------------------------------------------
# Model: params, cache, forward, prefill, decode
# --------------------------------------------------------------------------

def test_convert_keeps_the_f32_leaves_of_a_bf16_model():
    _, cfg, jp, params = _params("bfloat16")
    tm = params["layers"][1]["tm"]
    assert tm["decay_w0"].dtype == torch.float32 and tm["u"].dtype == torch.float32
    assert tm["w_r"].dtype == torch.bfloat16 and params["head"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tm["u"].numpy(), np.asarray(jp["layers"]["tm"]["u"][1]))
    # the seeded init has the same leaves, shapes and dtypes
    own = tf.init_params(cfg, 0, "cpu")
    flat = lambda p: {k: (tuple(v.shape), v.dtype) for k, v in p.items()}  # noqa: E731
    for grp in ("tm", "cm", "ln1", "ln2"):
        assert flat(own["layers"][0][grp]) == flat(params["layers"][0][grp]), grp


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_init_cache_matches_jax(variant):
    jcfg, cfg = jax_config(ARCH, variant), get_config(ARCH, variant)
    want = jtf.init_cache(jcfg, 2, 16)
    got = tf.init_cache(cfg, 2, 16, device="cpu")
    assert got["pos"] == 0 and set(got) == set(want)
    dt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for grp in ("tm", "cm"):
        assert set(got[grp]) == set(want[grp])
        for key, arr in want[grp].items():
            assert tuple(got[grp][key].shape) == arr.shape, (grp, key)
            assert got[grp][key].dtype == dt[arr.dtype], (grp, key)
            assert not got[grp][key].any()
    # no per-slot or paged form: the reference's ValueErrors, word for word
    for kw in (dict(per_slot=True), dict(page_size=4)):
        with pytest.raises(ValueError) as want_err:
            jtf.init_cache(jcfg, 2, 16, **kw)
        with pytest.raises(ValueError) as got_err:
            tf.init_cache(cfg, 2, 16, device="cpu", **kw)
        assert str(got_err.value) == str(want_err.value)


def test_forward_prefill_and_decode_match_jax():
    jcfg, cfg, jp, params = _params()
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
    np.testing.assert_allclose(_np(cache["tm"]["s"]), np.asarray(jcache["tm"]["s"]),
                               **F32_TOL)
    np.testing.assert_allclose(_np(cache["cm"]["x_prev"]), np.asarray(jcache["cm"]["x_prev"]),
                               **F32_TOL)


def test_bf16_model_logits_follow_jax():
    """The bf16 smoke model through prefill and two decode steps: the same
    op order and casts as the reference, so the logits agree to within
    bf16 rounding of the activations (5% of max |logit|, chip_smoke's
    forced-logit limit) and the greedy tokens are equal."""
    jcfg, cfg, jp, params = _params("bfloat16", seed=2)
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


@pytest.mark.parametrize("gen_lens,batch", [
    ([3, 7, 4, 6], 2),      # the batch divides the requests
    ([3, 7, 4, 6, 5], 2),   # the last group has a padding row
    ([5, 2, 6], 4),         # one group, one padding row
    ([4, 2, 5], 1),         # batch 1: the head split of a (1, T, d) prefill
])
def test_serve_matches_jax_batch_serve(gen_lens, batch):
    _, _, _, params = _params()
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


def test_serve_eos_and_int8_options_match_jax():
    """EOS taken from the free-running outputs stops a request early, as in
    JAX serve; --quantize int8 packs no rwkv weight (none is in
    QUANT_WEIGHT_KEYS) and --kv-cache int8 leaves the state alone, so both
    give the plain tokens."""
    _, _, _, params = _params()
    prompts = _prompts(4, 8, get_config(ARCH, "smoke").vocab, 3)
    kw = dict(batch=2, gen_lens=[9] * 4, prompts=prompts, scheduler="batch", verbose=False)
    free = serve(ARCH, "smoke", eos=NO_EOS, params=params, device="cpu", **kw)
    eos = free["outputs"][1][3]
    want = jax_serve(ARCH, "smoke", eos=eos, backend="ref", **kw)
    got = serve(ARCH, "smoke", eos=eos, params=params, device="cpu", **kw)
    assert got["outputs"] == want["outputs"] and got["outputs"][1][-1] == eos
    assert got["decode_steps"] == want["decode_steps"]
    assert layers.quantize_weights(params)["layers"][0]["tm"]["w_r"] is params["layers"][0]["tm"]["w_r"]
    for opt in (dict(quantize="int8"), dict(kv_cache="int8")):
        assert serve(ARCH, "smoke", eos=NO_EOS, params=params, device="cpu",
                     **kw, **opt)["outputs"] == free["outputs"], opt


@pytest.mark.parametrize("kw", [dict(scheduler="continuous"),
                                dict(scheduler="batch", kv_page_size=4),
                                dict(scheduler="batch", speculate=2)])
def test_rwkv_options_raise_the_reference_errors(kw):
    common = dict(requests=2, batch=2, prompt_len=4, gen=2, verbose=False)
    with pytest.raises(ValueError) as want:
        jax_serve(ARCH, "smoke", **common, **kw)
    with pytest.raises(ValueError) as got:
        serve(ARCH, "smoke", device="cpu", **common, **kw)
    assert str(got.value) == str(want.value)


def test_cli_serves_rwkv_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--scheduler", "batch", "--requests", "3", "--batch", "2", "--prompt-len", "6",
         "--gen", "3"],
        capture_output=True, text=True, timeout=120, check=True)
    assert "[serve] rwkv6-1.6b (batch): 3 requests, 9 tokens" in out.stdout
