"""paligemma-3b (vlm) and whisper-large-v3 (audio) in the port against the
JAX package, on the CPU, at the smoke widths.

Params come from the reference's init_params, with every norm and bias
leaf redrawn at random (the init leaves them at 0 and 1, where a wrong
bias, a dropped norm or a swapped residual would not show) and the output
projections scaled by 4 (at init the greedy token is the input token
whatever the blocks compute), converted by
`models.convert.from_jax_params`.

- paligemma: a dense block under the prefix-LM mask, `forward` with the
  patch prefix, `prefill` (patches + prompt into the cache) and
  `decode_step`, over dense and int8 caches: f32 hidden states within
  1e-5, logits within 1e-4, written caches within 1e-5 (int8: one value
  step); the bf16 model's logits within 5% of max |logit| with equal
  greedy tokens.
- whisper: the encoder block and the decoder block (causal self-attention
  over a cache, non-causal cross-attention, the biased gelu MLP) against
  the reference's composition of them (transformer.py:373-381, 398-438),
  `forward` without a cache, `prefill` and `decode_step`: the same limits.
  The reference's packed tree (--quantize int8 packs "xattn" too)
  converts to the port's packing bitwise, and its forward follows the
  reference's under backend "ref" within 1e-4.
  The reference decides whether to encode by whether its cache holds
  "enc", which its init_cache always allocates, so its prefill and serve
  never run the encoder (ROADMAP §3); these comparisons give the reference
  a cache without "enc", which makes its prefill encode the frames and
  store the output, as the port always does.
- serve: greedy tokens and stats of the port equal JAX serve's
  (backend="ref") on the same params, prompts and seed (the stub
  frontends' patches and frames come from the same numpy generator):
  paligemma under both schedulers, --kv-cache int8, --kv-page-size and
  --quantize int8; whisper under the batch scheduler and --quantize int8,
  --kv-cache int8 changing nothing (its cache stays in the model dtype, as
  the reference's), and the reference's ValueErrors for whisper's
  continuous scheduler, paged cache and speculation; the CLI for both.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.launch.serve import serve as jax_serve
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

VLM, AUDIO = "paligemma-3b", "whisper-large-v3"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NO_EOS = -1
_REDRAWN = ("'scale'", "'bias'", "'bq'", "'bk'", "'bv'", "'b_up'", "'b_down'")
#: the output projections of every attention and MLP scaled up, so that the
#: blocks and not the (tied, sqrt(d)-scaled) input embedding decide the
#: greedy token: at init the smoke models echo their input token forever
_BLOCK_GAIN = 4.0


def _redraw(jp, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in _REDRAWN):
            return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.5, a.dtype)
        if "'wo'" in name or "'w_down'" in name:
            return (a.astype(jnp.float32) * _BLOCK_GAIN).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, jp)


def _params(arch, dtype="float32", seed=0, **over):
    jcfg = dataclasses.replace(jax_config(arch, "smoke"), dtype=dtype, **over)
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype, **over)
    jp = _redraw(jtf.init_params(jax.random.PRNGKey(seed), jcfg), seed + 1)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _np(x):
    return x.float().numpy()


def _extras(cfg, rng, b):
    """The stub frontend's embeddings: (numpy f32, the batch dict key)."""
    if cfg.family == "vlm":
        return rng.standard_normal((b, cfg.n_prefix, cfg.d_model)).astype(np.float32), "patches"
    return rng.standard_normal((b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32), "frames"


def _jax_cache(jcfg, b, s):
    """The reference's cache, without the audio family's zero "enc" (so its
    prefill encodes the frames)."""
    cache = jtf.init_cache(jcfg, b, s)
    cache.pop("enc", None)
    return cache


# --------------------------------------------------------------------------
# paligemma
# --------------------------------------------------------------------------

def test_vlm_block_under_the_prefix_mask_matches_jax():
    jcfg, cfg, jp, params = _params(VLM)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, cfg.n_prefix + 5, cfg.d_model)).astype(np.float32)
    pos = np.arange(x.shape[1])
    with jblas.use_backend("pallas"):
        want, _, _ = jtf.dense_block(jax.tree.map(lambda a: a[0], jp["layers"]), jnp.asarray(x),
                                     jcfg, positions=jnp.asarray(pos), prefix_len=cfg.n_prefix)
    got, _ = tf.dense_block(params["layers"][0], torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos), prefix_len=cfg.n_prefix)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    causal, _ = tf.dense_block(params["layers"][0], torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos))
    assert not torch.allclose(causal, got)  # the prefix mask is live


@pytest.mark.parametrize("kv_cache", ["model", "int8"])
def test_vlm_forward_prefill_and_decode_match_jax(kv_cache):
    jcfg, cfg, jp, params = _params(VLM, kv_cache_dtype=kv_cache)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab, size=(3, 6), dtype=np.int32)
    patches, key = _extras(cfg, rng, 3)
    batch = {"tokens": jnp.asarray(toks), key: jnp.asarray(patches)}
    want_x, _, _ = jtf.forward(jp, batch, jcfg)
    got_x, none = tf.forward(params, torch.from_numpy(toks), cfg,
                             patches=torch.from_numpy(patches))
    assert none is None and tuple(got_x.shape) == (3, cfg.n_prefix + 6, cfg.d_model)
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), **F32_TOL)

    s = cfg.n_prefix + 10
    jcache, cache = jtf.init_cache(jcfg, 3, s), tf.init_cache(cfg, 3, s, device="cpu")
    want, jcache = jtf.prefill(jp, batch, jcache, jcfg)
    got, cache = tf.prefill(params, torch.from_numpy(toks), cache, cfg,
                            patches=torch.from_numpy(patches))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    assert cache["pos"] == cfg.n_prefix + 6
    for step in range(3):
        tok = rng.integers(3, cfg.vocab, size=(3, 1), dtype=np.int32)
        want, jcache = jtf.decode_step(jp, jnp.asarray(tok), jcache, jcfg)
        got, cache = tf.decode_step(params, torch.from_numpy(tok), cache, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    for key in ("k", "v"):
        if kv_cache == "int8":
            diff = _np(cache[key]) - np.asarray(jcache[key], np.float32)
            assert np.abs(diff).max() <= 1
        else:
            np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]), **F32_TOL)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_bf16_model_logits_follow_jax(arch):
    """The bf16 smoke model through prefill (with its patches or frames) and
    two decode steps: within 5% of max |logit| (chip_smoke.py's forced
    limit), equal greedy tokens."""
    jcfg, cfg, jp, params = _params(arch, "bfloat16", seed=2)
    rng = np.random.default_rng(6)
    toks = rng.integers(3, cfg.vocab, size=(2, 5), dtype=np.int32)
    extra, key = _extras(cfg, rng, 2)
    jcache, cache = _jax_cache(jcfg, 2, 24), tf.init_cache(cfg, 2, 24, device="cpu")
    feeds = [toks] + [rng.integers(3, cfg.vocab, size=(2, 1), dtype=np.int32) for _ in range(2)]
    for i, tok in enumerate(feeds):
        if i == 0:
            want, jcache = jtf.prefill(jp, {"tokens": jnp.asarray(tok), key: jnp.asarray(extra)},
                                       jcache, jcfg)
            got, cache = tf.prefill(params, torch.from_numpy(tok), cache, cfg,
                                    **{key: torch.from_numpy(extra)})
        else:
            want, jcache = jtf.decode_step(jp, jnp.asarray(tok), jcache, jcfg)
            got, cache = tf.decode_step(params, torch.from_numpy(tok), cache, cfg)
        want = np.asarray(want, np.float32)
        assert np.abs(_np(got) - want).max() <= 0.05 * np.abs(want).max()
        np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


# --------------------------------------------------------------------------
# whisper
# --------------------------------------------------------------------------

def _jax_encoder_block(lp, x, jcfg):
    """The reference's enc_body (transformer.py:373-381)."""
    h, _ = jlayers.attention_layer(lp["attn"], jlayers.apply_norm(lp["ln1"], x, jcfg.norm),
                                   jtf._attn_cfg(jcfg, causal=False, use_rope=False),
                                   positions=jnp.arange(x.shape[1]), residual=x)
    return jlayers.mlp(lp["ffn"], jlayers.apply_norm(lp["ln2"], h, jcfg.norm), jcfg.act,
                       residual=h)


def _jax_decoder_block(lp, x, enc, jcfg, cache):
    """The reference's dec_body (transformer.py:398-438) over a self-
    attention cache {"k", "v", "pos"}."""
    h, new_cache = jlayers.attention_layer(
        lp["attn"], jlayers.apply_norm(lp["ln1"], x, jcfg.norm),
        jtf._attn_cfg(jcfg, causal=True, use_rope=False),
        positions=cache["pos"] + jnp.arange(x.shape[1]), cache=cache, residual=x)
    hx = jlayers.apply_norm(lp["ln_x"], h, jcfg.norm)
    xp = lp["xattn"]
    q = jblas.matmul_fused(hx, xp["wq"], bias=xp["bq"])
    k = jblas.matmul_fused(enc, xp["wk"], bias=xp["bk"])
    v = jblas.matmul_fused(enc, xp["wv"], bias=xp["bv"])
    b, t, _ = hx.shape
    shape = (jcfg.n_heads, jcfg.hd)
    ho = jlayers.attention_dispatch(q.reshape(b, t, *shape), k.reshape(b, enc.shape[1], *shape),
                                    v.reshape(b, enc.shape[1], *shape), causal=False, groups=1)
    x = jblas.matmul_fused(ho.reshape(b, t, -1), xp["wo"], residual=h)
    return jlayers.mlp(lp["ffn"], jlayers.apply_norm(lp["ln2"], x, jcfg.norm), jcfg.act,
                       residual=x), new_cache


def test_whisper_encoder_and_decoder_blocks_match_jax():
    jcfg, cfg, jp, params = _params(AUDIO, seed=1)
    rng = np.random.default_rng(8)
    f, d = cfg.encoder.n_frames, cfg.d_model
    x_enc = rng.standard_normal((2, f, d)).astype(np.float32)
    with jblas.use_backend("pallas"):
        want_enc = _jax_encoder_block(jax.tree.map(lambda a: a[1], jp["enc_layers"]),
                                      jnp.asarray(x_enc), jcfg)
    got_enc = tf.encoder_block(params["enc_layers"][1], torch.from_numpy(x_enc), cfg)
    np.testing.assert_allclose(_np(got_enc), np.asarray(want_enc), **F32_TOL)

    lp = jax.tree.map(lambda a: a[0], jp["dec_layers"])
    kv = np.zeros((2, 12, cfg.n_kv, cfg.hd), np.float32)
    jc = {"k": jnp.asarray(kv), "v": jnp.asarray(kv), "pos": jnp.asarray(0, jnp.int32)}
    tc = {"k": torch.from_numpy(kv.copy()), "v": torch.from_numpy(kv.copy()), "pos": 0}
    for t in (5, 1, 1):  # a prefill, then two decode steps over the cache
        x = rng.standard_normal((2, t, d)).astype(np.float32)
        with jblas.use_backend("pallas"):
            want, jc = _jax_decoder_block(lp, jnp.asarray(x), jnp.asarray(x_enc), jcfg, jc)
        got, tc = tf.decoder_block(params["dec_layers"][0], torch.from_numpy(x),
                                   torch.from_numpy(x_enc), cfg,
                                   positions=torch.arange(t) + tc["pos"], cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32_TOL)


def test_whisper_forward_prefill_and_decode_match_jax():
    jcfg, cfg, jp, params = _params(AUDIO, seed=3)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, cfg.vocab, size=(3, 6), dtype=np.int32)
    frames, _ = _extras(cfg, rng, 3)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    want_x, _, _ = jtf.forward(jp, batch, jcfg)
    got_x, none = tf.forward(params, torch.from_numpy(toks), cfg, frames=torch.from_numpy(frames))
    assert none is None
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), **F32_TOL)

    jcache, cache = _jax_cache(jcfg, 3, 12), tf.init_cache(cfg, 3, 12, device="cpu")
    want, jcache = jtf.prefill(jp, batch, jcache, jcfg)
    got, cache = tf.prefill(params, torch.from_numpy(toks), cache, cfg,
                            frames=torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(_np(cache["enc"]), np.asarray(jcache["enc"]), **F32_TOL)
    for step in range(3):
        tok = rng.integers(3, cfg.vocab, size=(3, 1), dtype=np.int32)
        want, jcache = jtf.decode_step(jp, jnp.asarray(tok), jcache, jcfg)
        got, cache = tf.decode_step(params, torch.from_numpy(tok), cache, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
        assert cache["pos"] == 7 + step
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]), **F32_TOL)


def test_whisper_packed_params_convert_and_match_jax():
    """--quantize int8 packs the cross-attention ("xattn") too
    (QUANT_WEIGHT_KEYS): the reference's packed tree converts to the port's
    packed leaves, bitwise the port's own packing of the same weights, and
    the packed model's forward follows the reference's (backend "ref": its
    dequantization in f32, as the port's)."""
    jcfg, cfg, jp, params = _params(AUDIO, seed=6)
    packed = from_jax_params(jax.tree.map(np.asarray, jlayers.quantize_weights(jp)), cfg,
                             device="cpu")
    mine = layers.quantize_weights(params)
    for lp, want in zip(packed["dec_layers"], mine["dec_layers"]):
        for key in ("wq", "wk", "wv", "wo"):
            got_w, want_w = lp["xattn"][key], want["xattn"][key]
            assert got_w.transposed and got_w.block == want_w.block
            assert torch.equal(got_w.values, want_w.values)
            assert torch.equal(got_w.scales, want_w.scales)
    rng = np.random.default_rng(10)
    toks = rng.integers(3, cfg.vocab, size=(2, 5), dtype=np.int32)
    frames, _ = _extras(cfg, rng, 2)
    with jblas.use_backend("ref"):
        want, _, _ = jtf.forward(jlayers.quantize_weights(jp),
                                 {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                                 jcfg)
    got, _ = tf.forward(packed, torch.from_numpy(toks), cfg, frames=torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def test_whisper_init_cache_matches_the_reference():
    """The reference's layout and dtypes ("enc" included, in the model
    dtype under --kv-cache int8 too); no per-slot or paged form, with the
    reference's errors."""
    for kv_cache in ("model", "int8"):
        jcfg = dataclasses.replace(jax_config(AUDIO, "smoke"), kv_cache_dtype=kv_cache)
        cfg = dataclasses.replace(get_config(AUDIO, "smoke"), kv_cache_dtype=kv_cache)
        want = jtf.init_cache(jcfg, 2, 9, enc_frames=5)
        got = tf.init_cache(cfg, 2, 9, device="cpu", enc_frames=5)
        assert set(got) == set(want) and got["pos"] == 0
        for key in ("enc", "k", "v"):
            assert tuple(got[key].shape) == want[key].shape
            assert got[key].dtype == torch.float32 and not got[key].any()
    for kw in (dict(per_slot=True), dict(page_size=4)):
        with pytest.raises(ValueError) as want_err:
            jtf.init_cache(jcfg, 2, 16, **kw)
        with pytest.raises(ValueError) as got_err:
            tf.init_cache(cfg, 2, 16, device="cpu", **kw)
        assert str(got_err.value) == str(want_err.value)


def test_whisper_forward_needs_frames_or_an_encoded_cache():
    _, cfg, _, params = _params(AUDIO)
    with pytest.raises(ValueError, match="frames"):
        tf.forward(params, torch.zeros((1, 2), dtype=torch.int64), cfg)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

STAT_KEYS = ("completed", "tokens", "prefills", "decode_steps", "status", "preemptions",
             "rejections")


@pytest.fixture
def served(monkeypatch):
    """serve(arch, **kw) through both packages on one set of redrawn params:
    (port stats, JAX stats).  The reference's init_cache loses its zero
    "enc", so its whisper prefill encodes the frames (module docstring);
    the options in `reference_drops` reach the port's serve only."""
    orig = jtf.init_cache

    def init_cache(*args, **kw):
        cache = orig(*args, **kw)
        cache.pop("enc", None)
        return cache

    monkeypatch.setattr(jtf, "init_cache", init_cache)

    def run(arch, quantize="none", reference_drops=(), **kw):
        _, _, jp, params = _params(arch, seed=4)
        monkeypatch.setattr(jtf, "init_params", lambda key, cfg: jp)
        common = dict(eos=NO_EOS, verbose=False, quantize=quantize, **kw)
        ref = {k: v for k, v in common.items() if k not in reference_drops}
        return (serve(arch, "smoke", params=params, device="cpu", **common),
                jax_serve(arch, "smoke", backend="ref", **ref))

    return run


VLM_SERVES = [
    dict(scheduler="continuous", gen_lens=[3, 6, 2, 5, 4], batch=2, prompt_len=6),
    dict(scheduler="continuous", requests=4, batch=2, prompt_len=6, gen=5, kv_cache="int8",
         kv_page_size=4),
    dict(scheduler="batch", gen_lens=[3, 6, 2, 5, 4], batch=2, prompt_len=6),
    # the reference's paged batch serve under-reserves a vlm row (ROADMAP
    # §3): held to its dense batch serve, which the paged one must equal
    dict(scheduler="batch", requests=3, batch=2, prompt_len=6, gen=4, kv_page_size=4),
    dict(scheduler="continuous", requests=3, batch=2, prompt_len=6, gen=4, quantize="int8"),
]


@pytest.mark.parametrize("kw", VLM_SERVES, ids=["continuous", "kv_int8_paged", "batch",
                                                "batch_paged", "quantize_int8"])
def test_vlm_serve_matches_jax_serve(served, kw):
    paged_batch = kw["scheduler"] == "batch" and "kv_page_size" in kw
    got, want = served(VLM, reference_drops=("kv_page_size",) if paged_batch else (), **kw)
    if paged_batch:
        assert got["kv_page_size"] == kw["kv_page_size"] and got["pages_live"] > 0
    assert got["outputs"] == want["outputs"]
    assert any(len(set(o)) > 1 for o in got["outputs"])  # not a constant stream
    for key in STAT_KEYS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_whisper_batch_serve_matches_jax_serve(served, quantize):
    got, want = served(AUDIO, quantize=quantize, scheduler="batch", gen_lens=[3, 6, 2, 5, 4],
                       batch=2, prompt_len=6)
    assert got["outputs"] == want["outputs"]
    for key in STAT_KEYS:
        assert got[key] == want[key], key
    assert got["occupancy"] == pytest.approx(want["occupancy"])


def test_whisper_kv_int8_changes_nothing():
    _, _, _, params = _params(AUDIO, seed=5)
    kw = dict(requests=3, batch=2, prompt_len=5, gen=4, eos=NO_EOS, scheduler="batch",
              verbose=False, params=params, device="cpu")
    assert (serve(AUDIO, "smoke", kv_cache="int8", **kw)["outputs"]
            == serve(AUDIO, "smoke", **kw)["outputs"])


@pytest.mark.parametrize("kw", [dict(scheduler="continuous"),
                                dict(scheduler="batch", kv_page_size=4),
                                dict(scheduler="batch", speculate=2)])
def test_whisper_options_raise_the_reference_errors(kw):
    common = dict(requests=2, batch=2, prompt_len=4, gen=2, verbose=False)
    with pytest.raises(ValueError) as want:
        jax_serve(AUDIO, "smoke", **common, **kw)
    with pytest.raises(ValueError) as got:
        serve(AUDIO, "smoke", device="cpu", **common, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch,extra", [(VLM, []), (AUDIO, ["--scheduler", "batch"])])
def test_cli_serves_on_cpu(arch, extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--requests", "3", "--batch", "2", "--prompt-len", "6", "--gen", "3", *extra],
        capture_output=True, text=True, timeout=120, check=True)
    assert f"[serve] {arch} (" in out.stdout and ": 3 requests, 9 tokens" in out.stdout
