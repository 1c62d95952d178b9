"""The port's layers against the JAX package's, on the CPU.

Same numpy inputs through both; JAX runs its `xla` backend.  f32 tolerance
rtol = atol = 1e-5 per op: only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _xla_backend():
    with jblas.use_backend("xla"):
        yield


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def test_layer_norm_and_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    _close(tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_rotates_the_whole_head(per_slot):
    """Full-head half-split rotary, as the reference does (rope_pct unread)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = (np.array([[3], [11]]) + np.arange(5)[None]) if per_slot else np.arange(5) + 7
    pos = pos.astype(np.int32)
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jl.rope(jnp.asarray(x), jnp.asarray(pos)))


def _mlp_params(rng, d=64, f=128):
    return {"w_gate": rng.standard_normal((d, f)) * d ** -0.5,
            "w_up": rng.standard_normal((d, f)) * d ** -0.5,
            "w_down": rng.standard_normal((f, d)) * f ** -0.5}


@pytest.mark.parametrize("t", [1, 6])  # decode-shaped (bgemv) and prefill (bgemm)
def test_swiglu_mlp_with_residual(t):
    rng = np.random.default_rng(2)
    p = {k: v.astype(np.float32) for k, v in _mlp_params(rng).items()}
    x = rng.standard_normal((3, t, 64)).astype(np.float32)
    res = rng.standard_normal((3, t, 64)).astype(np.float32)
    _close(tl.mlp(_t(p), torch.from_numpy(x), "swiglu", residual=torch.from_numpy(res)),
           jl.mlp(_j(p), jnp.asarray(x), "swiglu", residual=jnp.asarray(res)))


def _attn(n_kv):
    d, h, hd = 64, 4, 16
    rng = np.random.default_rng(n_kv)
    p = {"wq": rng.standard_normal((d, h * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, n_kv * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, n_kv * hd)) * d ** -0.5,
         "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5,
         # nonzero biases: init leaves them at zero, which would not test them
         "bq": rng.standard_normal(h * hd), "bk": rng.standard_normal(n_kv * hd),
         "bv": rng.standard_normal(n_kv * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jcfg = jl.AttnConfig(d_model=d, n_heads=h, n_kv=n_kv, head_dim=hd, use_bias=True)
    tcfg = tl.AttnConfig(d_model=d, n_heads=h, n_kv=n_kv, head_dim=hd, use_bias=True)
    return p, jcfg, tcfg, rng


@pytest.mark.parametrize("n_kv", [4, 2])  # GQA groups 1 and 2
def test_attention_layer_no_cache(n_kv):
    p, jcfg, tcfg, rng = _attn(n_kv)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    res = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    want, _ = jl.attention_layer(_j(p), jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                 residual=jnp.asarray(res))
    got, cache = tl.attention_layer(_t(p), torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(pos),
                                    residual=torch.from_numpy(res))
    assert cache is None
    _close(got, want)


def _empty_cache(b, s, n_kv, hd=16):
    return np.zeros((b, s, n_kv, hd), np.float32)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_attention_layer_dense_cache_scalar_pos(n_kv):
    """Prefill a block at pos 0, then a second block at pos 5, through a
    scalar-pos cache; outputs and the (in-place) cache match JAX's."""
    p, jcfg, tcfg, rng = _attn(n_kv)
    jp, tp = _j(p), _t(p)
    jc = {"k": jnp.asarray(_empty_cache(2, 12, n_kv)), "v": jnp.asarray(_empty_cache(2, 12, n_kv)),
          "pos": jnp.asarray(0, jnp.int32)}
    tc = {"k": torch.zeros(2, 12, n_kv, 16), "v": torch.zeros(2, 12, n_kv, 16), "pos": 0}
    for t in (5, 3):
        x = rng.standard_normal((2, t, 64)).astype(np.float32)
        pos = np.arange(t, dtype=np.int32) + tc["pos"]
        want, jc = jl.attention_layer(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), cache=jc)
        got, tc = tl.attention_layer(tp, torch.from_numpy(x), tcfg,
                                     positions=torch.from_numpy(pos), cache=tc)
        _close(got, want)
        assert tc["pos"] == int(jc["pos"])
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("n_kv", [4, 2])
def test_attention_layer_dense_cache_per_slot_pos(n_kv):
    """Ragged slot decode: each slot appends at its own (B,) position over a
    cache that holds garbage past it."""
    p, jcfg, tcfg, rng = _attn(n_kv)
    k0 = rng.standard_normal((3, 16, n_kv, 16)).astype(np.float32)
    v0 = rng.standard_normal((3, 16, n_kv, 16)).astype(np.float32)
    pos = np.array([4, 9, 15], np.int32)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    res = rng.standard_normal((3, 1, 64)).astype(np.float32)
    positions = pos[:, None]
    want, jc = jl.attention_layer(
        _j(p), jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.asarray(pos)},
        residual=jnp.asarray(res))
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
          "pos": torch.from_numpy(pos)}
    got, tc = tl.attention_layer(_t(p), torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(positions), cache=tc,
                                 residual=torch.from_numpy(res))
    _close(got, want)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def test_embed():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 5), dtype=np.int32)
    for scale in (False, True):
        _close(tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tok), scale),
               jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tok), scale))
