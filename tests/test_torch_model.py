"""The port's dense model against the JAX package's, on the CPU.

Params come from the reference's `init_params`; its biases and LayerNorm
leaves start at 0 / 1, which would leave the bias epilogue and the norms'
affine terms untested, so those leaves are overwritten with seeded nonzero
values before both packages get the params.  Logit tolerance (f32):
rtol = atol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "stablelm-1.6b"
TOL = dict(rtol=1e-4, atol=1e-4)
AFFINE = {"bq", "bk", "bv", "scale", "bias"}


@pytest.fixture(scope="module")
def params():
    """(JAX params, numpy tree, port params) with nonzero affine leaves."""
    rng = np.random.default_rng(7)

    def perturb(node):
        return {k: perturb(v) if isinstance(v, dict) else
                (np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
                 if k in AFFINE else np.asarray(v))
                for k, v in node.items()}

    tree = perturb(jtf.init_params(jax.random.PRNGKey(0), jax_config(ARCH, "smoke")))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, tree, from_jax_params(tree, get_config(ARCH, "smoke"), device="cpu")


@pytest.fixture(autouse=True)
def _xla_backend():
    with jblas.use_backend("xla"):
        yield


def test_from_jax_params_round_trip(params):
    """Every leaf arrives unchanged: top-level as is, stacked ones per layer."""
    _, tree, tp = params
    cfg = get_config(ARCH, "smoke")
    assert len(tp["layers"]) == cfg.n_layers
    for group in ("embed", "final_norm", "head"):
        for k, v in tree[group].items():
            np.testing.assert_array_equal(tp[group][k].numpy(), v)
    for i, layer in enumerate(tp["layers"]):
        for block, leaves in tree["layers"].items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(layer[block][k].numpy(), v[i])


def test_from_jax_params_keeps_bfloat16_bits():
    cfg = jax_config(ARCH, "smoke")
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(1), cfg))
    tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    tp = from_jax_params(tree, get_config(ARCH, "smoke"), device="cpu")
    w = tp["layers"][1]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), tree["layers"]["attn"]["wq"][1].astype(np.float32))


def test_prefill_and_decode_logits_match_jax(params):
    """Prefill a batch, graft it into a per-slot cache with the slots
    swapped, then decode at ragged per-slot positions; logits match JAX's
    at every step and the caches agree."""
    jparams, _, tp = params
    jcfg, cfg = jax_config(ARCH, "smoke"), get_config(ARCH, "smoke")
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, cfg.vocab, size=(2, 9), dtype=np.int32)

    jmini = jtf.init_cache(jcfg, 2, 16)
    jl, jmini = jtf.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jmini, jcfg)
    tmini = tf.init_cache(cfg, 2, 16, device="cpu")
    tlog, tmini = tf.prefill(tp, torch.from_numpy(tokens), tmini, cfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), **TOL)

    slots = np.array([1, 0], np.int32)
    jc = jtf.insert_slots_cache(jtf.init_cache(jcfg, 2, 16, per_slot=True), jmini,
                                jnp.asarray(slots))
    tc = tf.insert_slots_cache(tf.init_cache(cfg, 2, 16, per_slot=True, device="cpu"),
                               tmini, slots)
    # ragged: slot 1 rewinds to position 6 (its first 6 prefilled keys stay)
    jc = {**jc, "pos": jnp.asarray([9, 6], jnp.int32)}
    tc["pos"] = torch.tensor([9, 6], dtype=torch.int32)
    for _ in range(3):
        tok = rng.integers(3, cfg.vocab, size=(2, 1), dtype=np.int32)
        jl, jc = jtf.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tlog, tc = tf.decode_step(tp, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_init_params_mirrors_the_reference_tree():
    """Seeded random params: the reference's leaves and shapes (stacked
    leaves per layer), the config's dtype, reproducible from the seed."""
    jcfg, cfg = jax_config(ARCH, "smoke"), get_config(ARCH, "smoke")
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    a, b = tf.init_params(cfg, 3, "cpu"), tf.init_params(cfg, 3, "cpu")
    for group in ("embed", "final_norm", "head"):
        for k, v in shapes[group].items():
            assert tuple(a[group][k].shape) == v.shape
    for block, leaves in shapes["layers"].items():
        for k, v in leaves.items():
            assert tuple(a["layers"][0][block][k].shape) == v.shape[1:]
            assert a["layers"][0][block][k].dtype == cfg.torch_dtype
            assert torch.equal(a["layers"][1][block][k], b["layers"][1][block][k])
    w = a["layers"][0]["ffn"]["w_down"]
    assert w.std().item() == pytest.approx(cfg.d_ff ** -0.5, rel=0.1)
