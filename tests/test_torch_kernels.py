"""The port's kernel entry points against the JAX package's Pallas kernels.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs `repro.kernels.ops` in Pallas interpret mode, as the JAX tests
do.  Same numpy inputs through both, weights at the model's fan_in^-0.5 scale.
Tolerances: f32 rtol = atol = 1e-5
(only the summation order differs); bf16 one bf16 rounding step of the
output (rtol = atol = 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import quant
from repro_torch.kernels import attention as tattention
from repro_torch.kernels import bgemm as tbgemm
from repro_torch.kernels import bgemv as tbgemv
from repro_torch.kernels import ops

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# (activation, bias, gate, residual): every epilogue stage, alone and combined
EPILOGUES = [
    (None, False, False, False),
    (None, True, False, False),
    ("silu", False, True, False),
    (None, False, False, True),
    ("gelu", True, False, True),
    ("relu", True, True, True),
]


def _pair(a, dtype=np.float32):
    """The same values as a JAX array and a torch CPU tensor."""
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _epi_operands(rng, act, bias, gate, res, w_shape, out_shape, w_std):
    """Epilogue operands at the model's scales: gate weights normal * w_std
    (fan_in^-0.5, so every accumulator is O(1)), bias and residual O(1)."""
    ops_j, ops_t = {}, {}
    if gate:
        ops_j["a2"], ops_t["a2"] = _pair(rng.standard_normal(w_shape) * w_std)
    if bias:
        ops_j["bias"], ops_t["bias"] = _pair(rng.standard_normal(w_shape[-1]))
    if res:
        ops_j["residual"], ops_t["residual"] = _pair(rng.standard_normal(out_shape))
    ops_j["activation"] = ops_t["activation"] = act
    return ops_j, ops_t


@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("batch,n,m", [(3, 37, 53), (4, 64, 128)])
def test_bgemv_matches_pallas(act, bias, gate, res, batch, n, m):
    """transpose_a: a is the stored (d_in, d_out) weight, y[b] = a^T x[b]."""
    rng = np.random.default_rng(batch * 1000 + n)
    a_j, a_t = _pair(rng.standard_normal((n, m)) * n ** -0.5)
    x_j, x_t = _pair(rng.standard_normal((batch, n)))
    ej, et = _epi_operands(rng, act, bias, gate, res, (n, m), (batch, m), n ** -0.5)
    want = jops.bgemv(a_j, x_j, transpose_a=True, **ej)
    got = ops.bgemv(a_t, x_t, transpose_a=True, **et)
    assert got.shape == (batch, m) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("batch,m,k,n", [(2, 13, 37, 29), (1, 8, 64, 48)])
def test_bgemm_matches_pallas(act, bias, gate, res, batch, m, k, n):
    """Ragged m/k/n (primes) exercise every fringe of the reference."""
    rng = np.random.default_rng(batch * 1000 + k)
    a_j, a_t = _pair(rng.standard_normal((batch, m, k)))
    b_j, b_t = _pair(rng.standard_normal((k, n)) * k ** -0.5)
    ej, et = _epi_operands(rng, act, bias, gate, res, (k, n), (batch, m, n), k ** -0.5)
    ej["b2"], et["b2"] = ej.pop("a2", None), et.pop("a2", None)
    want = jops.bgemm(a_j, b_j, **ej)
    got = ops.bgemm(a_t, b_t, **et)
    assert got.shape == (batch, m, n)
    _close(got, want, F32_TOL)


def test_bgemv_bgemm_bf16_match_pallas():
    rng = np.random.default_rng(5)
    w_j, w_t = _pair(rng.standard_normal((48, 40)) * 0.2, "bfloat16")
    w2_j, w2_t = _pair(rng.standard_normal((48, 40)) * 0.2, "bfloat16")
    x_j, x_t = _pair(rng.standard_normal((3, 48)), "bfloat16")
    want = jops.bgemv(w_j, x_j, a2=w2_j, activation="silu", transpose_a=True)
    got = ops.bgemv(w_t, x_t, a2=w2_t, activation="silu")
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), BF16_TOL)
    a_j, a_t = _pair(rng.standard_normal((2, 5, 48)), "bfloat16")
    bias_j, bias_t = _pair(rng.standard_normal(40), "bfloat16")
    want = jops.bgemm(a_j, w_j, bias=bias_j, out_dtype=jnp.bfloat16)
    got = ops.bgemm(a_t, w_t, bias=bias_t)
    _close(got, want.astype(jnp.float32), BF16_TOL)


def _cache_case(rng, b, tq, h, kvh, d, s, lens_per_slot):
    """q (B, Tq, H, D) and a cache k/v (B, S, KVH, D) holding NaN past each
    slot's real length (stale or uninitialised rows)."""
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    for i, n in enumerate(lens_per_slot):
        k[i, n:] = np.nan
        v[i, n:] = np.nan
    lens = np.repeat(np.asarray(lens_per_slot, np.int32), h)  # (B*H,) row-major
    return q, k, v, lens


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("tq,lens", [
    (1, [9, 17, 24]),    # ragged slot decode
    (5, [5, 12, 20]),    # cached prefill block at ragged positions
    (20, [20, 20, 20]),  # admission prefill from position 0
])
def test_flash_attention_matches_pallas(groups, tq, lens):
    rng = np.random.default_rng(tq * 10 + groups)
    h = 4
    q, k, v, kv_lens = _cache_case(rng, 3, tq, h, h // groups, 16, 24, lens)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_lens=jnp.asarray(kv_lens), kv_groups=groups)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              kv_lens=torch.from_numpy(kv_lens), kv_groups=groups)
    assert torch.isfinite(got).all()
    _close(got, want, F32_TOL)


def test_flash_attention_bf16_matches_pallas():
    rng = np.random.default_rng(3)
    q, k, v, kv_lens = _cache_case(rng, 2, 1, 4, 4, 32, 40, [33, 40])
    to_j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    want = jops.flash_attention(to_j(q), to_j(k), to_j(v), kv_lens=jnp.asarray(kv_lens))
    got = ops.flash_attention(to_t(q), to_t(k), to_t(v), kv_lens=torch.from_numpy(kv_lens))
    _close(got, want.astype(jnp.float32), BF16_TOL)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results and
    never count a kernel launch."""
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    w, x = torch.randn(24, 16, generator=g), torch.randn(2, 24, generator=g)
    a = torch.randn(2, 3, 24, generator=g)
    assert torch.equal(ops.bgemv(w, x), tbgemv.reference(w, x))
    assert torch.equal(ops.bgemm(a, w), tbgemm.reference(a, w))
    q = torch.randn(2, 1, 2, 16, generator=g)
    kv = torch.randn(2, 8, 2, 16, generator=g)
    lens = torch.tensor([3, 3, 8, 8], dtype=torch.int32)
    assert torch.equal(ops.flash_attention(q, kv, kv, kv_lens=lens),
                       tattention.reference(q, kv, kv, lens))
    qw = quant.quantize(w, quant.QuantSpec(8, None, transpose=True))
    assert torch.equal(ops.bgemv(qw, x), tbgemv.reference_int8(qw, x))
    assert torch.equal(ops.bgemm(a, qw), tbgemm.reference_int8(a, qw))
    assert ops.launch_counts() == {"bgemv": 0, "bgemm": 0, "attention": 0, "gemm": 0,
                                   "gemv": 0, "blas1_reduce": 0, "blas1_axpy": 0,
                                   "bgemv_int8": 0, "gemv_int8": 0, "gemm_int8": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    w, x = torch.randn(24, 16), torch.randn(2, 24)
    with pytest.raises(ValueError, match="shape"):
        ops.bgemv(w, torch.randn(2, 23))
    with pytest.raises(TypeError, match="dtype"):
        ops.bgemv(w, x.double())
    with pytest.raises(TypeError, match="dtype"):
        ops.bgemv(w.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bgemm(torch.randn(2, 24, 3).transpose(1, 2), w)
    with pytest.raises(ValueError, match="bias shape"):
        ops.bgemm(torch.randn(2, 3, 24), w, bias=torch.randn(15))
    with pytest.raises(ValueError, match="activation"):
        ops.bgemv(w, x, activation="tanh")
    with pytest.raises(NotImplementedError):
        ops.bgemv(w, x, transpose_a=False)
    q, kv = torch.randn(1, 1, 4, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(TypeError, match="int32"):
        ops.flash_attention(q, kv, kv, kv_lens=torch.ones(4, dtype=torch.int64), kv_groups=2)
    with pytest.raises(ValueError, match="kv_groups"):
        ops.flash_attention(q, kv, kv, kv_lens=torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("k,n,elem", [(2048, 2048, 2), (2048, 5632, 2), (5632, 2048, 2),
                                      (2048, 2048, 4), (37, 53, 4)])
def test_bgemv_split_plan(k, n, elem):
    """The K split fills the card (~2 blocks per SM at batch 4) without
    going below 64 rows (8 per warp) per block; tiny K takes one split."""
    splits = tbgemv.splits_for(k, n, 4, elem, sms=132)
    tiles = -(-n // (32 * (16 // elem)))
    assert 1 <= splits <= max(1, k // 64)
    assert splits == 1 or tiles * splits >= min(2 * 132, tiles * (k // 64))
