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
from repro_torch.core.epilogue import Epilogue
from repro_torch.kernels import attention as tattention
from repro_torch.kernels import bgemm as tbgemm
from repro_torch.kernels import bgemv as tbgemv
from repro_torch.kernels import mamba2 as tmamba2
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as trwkv6

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
    got = ops.bgemv(w_t, x_t, a2=w2_t, activation="silu", transpose_a=True)
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
    assert torch.equal(ops.bgemv(w, x, transpose_a=True), tbgemv.reference(w, x))
    assert torch.equal(ops.bgemm(a, w), tbgemm.reference(a, w))
    q = torch.randn(2, 1, 2, 16, generator=g)
    kv = torch.randn(2, 8, 2, 16, generator=g)
    lens = torch.tensor([3, 3, 8, 8], dtype=torch.int32)
    assert torch.equal(ops.flash_attention(q, kv, kv, kv_lens=lens),
                       tattention.reference(q, kv, kv, lens))
    qw = quant.quantize(w, quant.QuantSpec(8, None, transpose=True))
    assert torch.equal(ops.bgemv(qw, x, transpose_a=True), tbgemv.reference_int8(qw, x))
    assert torch.equal(ops.bgemm(a, qw), tbgemm.reference_int8(a, qw))
    wb = torch.randn(2, 24, 16, generator=g)
    assert torch.equal(ops.bgemm(a, wb, out_dtype=torch.float64),
                       tbgemm.reference_batched(a, wb, out_dtype=torch.float64))
    r = torch.randn(2, 5, 16, generator=g)
    w_log = -torch.rand(2, 5, 16, generator=g)
    u = r[:, 0].contiguous()
    got = ops.rwkv6(r, r, r, w_log, u, chunk=4)
    want = trwkv6.reference(r, r, r, w_log, u, chunk=4)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, want))
    got = ops.mamba2_ssd(r, w_log[:, :, 0].contiguous(), r, r, chunk=4)
    want = tmamba2.reference(r, w_log[:, :, 0].contiguous(), r, r, chunk=4)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, want))
    assert ops.launch_counts() == {"bgemv": 0, "bgemm": 0, "attention": 0,
                                   "attention_paged": 0, "attention_int8": 0, "gemm": 0,
                                   "gemv": 0, "blas1_reduce": 0, "blas1_axpy": 0,
                                   "bgemv_int8": 0, "bgemv_broadcast_t": 0,
                                   "bgemv_broadcast_n": 0, "bgemv_batched_t": 0,
                                   "bgemv_batched_n": 0, "bgemv_members": 0,
                                   "gemv_int8": 0, "gemm_int8": 0,
                                   "rwkv6": 0, "mamba2_ssd": 0, "gemm_wgmma": 0,
                                   "gemm_dmma": 0, "gemm_ffma_sm90": 0, "gemm_ffma": 0,
                                   "gemm_wgmma_staged": 0, "gemm_dmma_copy8": 0,
                                   "gemm_ffma_sm90_staged": 0, "gemm_ffma_sm90_odd": 0,
                                   "bgemm_wgmma": 0, "bgemm_dmma": 0, "bgemm_ffma_sm90": 0,
                                   "bgemm_ffma": 0, "bgemm_wgmma_staged": 0,
                                   "bgemm_dmma_copy8": 0, "bgemm_ffma_sm90_staged": 0,
                                   "bgemm_ffma_sm90_odd": 0,
                                   "bgemm_batched": 0,
                                   "bgemm_batched_int8": 0, "bgemm_batched_staged": 0,
                                   "bgemm_batched_wgmma": 0, "bgemm_batched_dmma": 0,
                                   "bgemm_batched_ffma_sm90": 0, "bgemm_batched_ffma": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    w, x = torch.randn(24, 16), torch.randn(2, 24)
    with pytest.raises(ValueError, match="shape"):
        ops.bgemv(w, torch.randn(2, 23), transpose_a=True)
    with pytest.raises(TypeError, match="dtype"):
        ops.bgemv(w, x.double(), transpose_a=True)
    with pytest.raises(TypeError, match="dtype"):
        ops.bgemv(w.to(torch.bfloat16), x, transpose_a=True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bgemm(torch.randn(2, 24, 3).transpose(1, 2), w)
    with pytest.raises(ValueError, match="bias shape"):
        ops.bgemm(torch.randn(2, 3, 24), w, bias=torch.randn(15))
    with pytest.raises(ValueError, match="activation"):
        ops.bgemv(w, x, activation="tanh", transpose_a=True)
    with pytest.raises(ValueError, match="shape"):  # op = A: a (24, 16) takes x (2, 16)
        ops.bgemv(w, x)
    q, kv = torch.randn(1, 1, 4, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(TypeError, match="int32"):
        ops.flash_attention(q, kv, kv, kv_lens=torch.ones(4, dtype=torch.int64), kv_groups=2)
    with pytest.raises(ValueError, match="kv_groups"):
        ops.flash_attention(q, kv, kv, kv_lens=torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("k,n,elem", [(2048, 2048, 2), (2048, 5632, 2), (5632, 2048, 2),
                                      (2048, 2048, 4), (37, 53, 4), (64, 2048, 2),
                                      (2048, 64, 2), (8192, 2048, 2), (0, 16, 4)])
@pytest.mark.parametrize("batch", [1, 4, 9])
@pytest.mark.parametrize("gate", [False, True])
def test_bgemv_split_plan(k, n, elem, batch, gate):
    """The plan covers K exactly, split after split in order, in whole 32-row
    steps, at least MIN_ROWS[gate] (less a step of rounding), at most MAX_ROWS
    rows a split; its column tiles are 128 bytes, so at least as many as the
    first design's 512-byte tiles (N = 2048: 32 / 64 against 8 / 16); the K
    split takes the grid as close to BLOCKS_PER_SM blocks an SM as those
    limits allow, past it only where MAX_ROWS forces more slices."""
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    p = tbgemv.plan(batch, k, n, dtype, gate=gate, sms=132)
    slices = p.k_slices(k)
    assert p.tile * elem == 128
    assert -(-n // p.tile) >= -(-n // (32 * (16 // elem)))
    assert len(slices) == p.splits >= 1
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(slices, slices[1:]))
    assert all(k0 < k1 for k0, k1 in slices) or k == 0
    assert p.rows % tbgemv.ROW_STEP == 0 and p.rows <= tbgemv.MAX_ROWS
    assert p.splits == 1 or p.rows >= tbgemv.MIN_ROWS[gate] - tbgemv.ROW_STEP
    base = p.blocks(batch, n) // p.splits
    most = tbgemv.BLOCKS_PER_SM * 132
    assert p.blocks(batch, n) <= max(most, base) or p.rows == tbgemv.MAX_ROWS
    # one more split would pass the blocks or the rows limit (or K)
    assert (base * (p.splits + 1) > most or k // tbgemv.MIN_ROWS[gate] <= p.splits
            or p.rows == tbgemv.MAX_ROWS)


def test_bgemv_plan_reads_no_tensor():
    """The plan comes from the shapes and the dtype alone: meta tensors (no
    data, no device) give the plan of real ones, and a repeated shape is a
    cache hit."""
    w = torch.empty(2048, 5632, dtype=torch.bfloat16, device="meta")
    x = torch.empty(4, 2048, dtype=torch.bfloat16, device="meta")
    tbgemv.plan.cache_clear()
    p = tbgemv.plan(x.shape[0], *w.shape, x.dtype, gate=True)
    assert p == tbgemv.plan(4, 2048, 5632, torch.bfloat16, gate=True)
    assert tbgemv.plan.cache_info().hits == 1


def _bgemv_emulation(w, x, p, *, w2=None, bias=None, residual=None, activation=None):
    """The kernel's arithmetic on the CPU: f32 partials of each K slice of
    the plan, summed in split order, then the epilogue in f32, rounded once
    to x's dtype."""
    xf = x.float()
    acc = acc2 = None
    for k0, k1 in p.k_slices(x.shape[1]):
        part = xf[:, k0:k1] @ w[k0:k1].float()
        acc = part if acc is None else acc + part
        if w2 is not None:
            part2 = xf[:, k0:k1] @ w2[k0:k1].float()
            acc2 = part2 if acc2 is None else acc2 + part2
    epi = Epilogue(activation, bias is not None, w2 is not None, residual is not None)
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("batch,k,n", [(4, 1000, 72), (9, 600, 130)])
def test_bgemv_split_emulation_matches_pallas_and_plain(dtype, act, bias, gate, res, batch,
                                                         k, n):
    """The plan splits these K into several slices; their ordered sum and
    the f32 epilogue stay within the tolerance of the Pallas kernel
    (interpret mode) and of the plain version."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = tbgemv.plan(batch, k, n, tdt, gate=gate)
    assert p.splits > 1
    rng = np.random.default_rng(batch * 100 + n)
    w_j, w_t = _pair(rng.standard_normal((k, n)) * k ** -0.5, dtype)
    x_j, x_t = _pair(rng.standard_normal((batch, k)), dtype)
    kj, kt = {}, {}
    if gate:
        kj["a2"], kt["w2"] = _pair(rng.standard_normal((k, n)) * k ** -0.5, dtype)
    if bias:
        kj["bias"], kt["bias"] = _pair(rng.standard_normal(n), dtype)
    if res:
        kj["residual"], kt["residual"] = _pair(rng.standard_normal((batch, n)), dtype)
    kj["activation"] = kt["activation"] = act
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    got = _bgemv_emulation(w_t, x_t, p, **kt)
    want = jops.bgemv(w_j, x_j, transpose_a=True, **kj)
    _close(got, want.astype(jnp.float32), tol)
    plain = tbgemv.reference(w_t, x_t, **kt)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **tol)
