"""Batched GEMV's whole dense contract in the port against the JAX package.

The port's `core.blas.batched_gemv` and `kernels.ops.bgemv` take op = A and
op = A^T over a broadcast 2-D A or one A a member, in f32, bf16 and f64.
On the CPU they run the plain version (`kernels.bgemv.reference`); the JAX
side runs `repro.core.blas.batched_gemv` under `use_backend("pallas")` and
`repro.kernels.ops.bgemv`, both reaching the Pallas kernel in interpret
mode, as the JAX package's own tests run them
(tests/test_blas_conformance.py, tests/test_kernels.py).  Same numpy inputs
through both; f64 inside `jax.enable_x64(True)`.

Tolerances: f64 rtol = atol = 1e-12 and f32 1e-5 (only the summation order
differs); bf16 2e-2, one bf16 rounding step of the output.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro_torch.core import blas, quant
from repro_torch.kernels import bgemv, ops

DTYPES = ["float32", "bfloat16", "float64"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2),
       "float64": dict(rtol=1e-12, atol=1e-12)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

# (activation, bias, gate, residual): every epilogue stage, alone and combined
EPILOGUES = [
    (None, False, False, False),
    (None, True, False, False),
    ("silu", False, True, False),
    (None, False, False, True),
    ("gelu", True, False, True),
    ("relu", True, True, True),
]


@contextlib.contextmanager
def precision(dtype):
    """f64 needs JAX's 64-bit mode; the other dtypes run as the JAX tests do."""
    if dtype == "float64":
        with jax.enable_x64(True):
            yield
    else:
        yield


def _pair(a, dtype):
    """The same values as a JAX array and a torch CPU tensor of `dtype`."""
    a = np.ascontiguousarray(a, np.float64)
    if dtype == "float64":
        return jnp.asarray(a, jnp.float64), torch.from_numpy(a.copy())
    a32 = a.astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(torch.bfloat16)
    return jnp.asarray(a32), torch.from_numpy(a32)


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want).astype(np.float64),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,m,n", [(1, 1, 1), (3, 7, 129), (2, 129, 7)])
def test_batched_gemv_conformance_matches_reference(dtype, batch, m, n):
    """The reference's conformance calls (test_blas_conformance.py:134): a
    per-member A, a broadcast W, alpha/beta into y, and trans=True on the
    swapped A, each against repro.core.blas.batched_gemv under pallas."""
    rng = np.random.default_rng(batch * 17 + m)
    a = rng.standard_normal((batch, m, n)) * n ** -0.5
    w = rng.standard_normal((m, n)) * n ** -0.5
    x, y = rng.standard_normal((batch, n)), rng.standard_normal((batch, m))
    with precision(dtype):
        (aj, at), (wj, wt), (xj, xt), (yj, yt) = (_pair(v, dtype) for v in (a, w, x, y))
        (atj, att) = _pair(np.swapaxes(a, 1, 2), dtype)
        with jblas.use_backend("pallas"):
            want = [jblas.batched_gemv(aj, xj), jblas.batched_gemv(wj, xj),
                    jblas.batched_gemv(aj, xj, yj, alpha=0.5, beta=1.5),
                    jblas.batched_gemv(atj, xj, trans=True)]
        got = [blas.batched_gemv(at, xt), blas.batched_gemv(wt, xt),
               blas.batched_gemv(at, xt, yt, alpha=0.5, beta=1.5),
               blas.batched_gemv(att, xt, trans=True)]
        for g, w_ in zip(got, want):
            _close(g, w_, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("batch,m,n", [(3, 257, 131), (2, 13, 89), (3, 101, 640), (64, 32, 32),
                                       (33, 7, 5)])
def test_batched_gemv_prime_sizes_match_reference(dtype, trans, batch, m, n):
    """The reference's prime shapes (test_kernels.py:300-326), per-member
    and broadcast A, both ops: ragged m and n, rows off 16 bytes; and short
    members (the short-member body's plan on the card), whole and ragged."""
    rng = np.random.default_rng(batch * m + n)
    a = rng.standard_normal((batch, n, m) if trans else (batch, m, n)) * n ** -0.5
    x = rng.standard_normal((batch, n))
    with precision(dtype):
        (aj, at), (xj, xt) = _pair(a, dtype), _pair(x, dtype)
        with jblas.use_backend("pallas"):
            want = [jblas.batched_gemv(aj, xj, trans=trans),
                    jblas.batched_gemv(aj[0], xj, trans=trans)]
        _close(blas.batched_gemv(at, xt, trans=trans), want[0], dtype)
        _close(blas.batched_gemv(at[0].contiguous(), xt, trans=trans), want[1], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
def test_bgemv_every_epilogue_on_a_batched_a(dtype, trans, act, bias, gate, res):
    """ops.bgemv with a per-member A under each epilogue stage, alone and
    combined, against repro.kernels.ops.bgemv (interpret mode)."""
    batch, m, n = 3, 37, 53
    rng = np.random.default_rng(batch * 1000 + n + 7 * trans)
    shape = (batch, n, m) if trans else (batch, m, n)
    with precision(dtype):
        aj, at = _pair(rng.standard_normal(shape) * n ** -0.5, dtype)
        xj, xt = _pair(rng.standard_normal((batch, n)), dtype)
        kj, kt = {"activation": act}, {"activation": act}
        if gate:
            kj["a2"], kt["a2"] = _pair(rng.standard_normal(shape) * n ** -0.5, dtype)
        if bias:
            kj["bias"], kt["bias"] = _pair(rng.standard_normal(m), dtype)
        if res:
            kj["residual"], kt["residual"] = _pair(rng.standard_normal((batch, m)), dtype)
        want = jops.bgemv(aj, xj, transpose_a=trans, **kj)
        _close(ops.bgemv(at, xt, transpose_a=trans, **kt), want, dtype)


def test_bgemv_default_op_is_a_as_the_reference():
    """ops.bgemv(a, x) on a square dense A is A x, as the reference's (the
    port once defaulted to A^T x); a packed A stored transposed needs
    transpose_a=True in both, and raises without it."""
    rng = np.random.default_rng(11)
    aj, at = _pair(rng.standard_normal((16, 16)) * 0.25, "float32")
    xj, xt = _pair(rng.standard_normal((3, 16)), "float32")
    got = ops.bgemv(at, xt)
    _close(got, jops.bgemv(aj, xj), "float32")
    torch.testing.assert_close(got, xt @ at.t(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, xt @ at, rtol=1e-3, atol=1e-3)
    spec = quant.QuantSpec(8, None, transpose=True)
    qt = quant.quantize(at, spec)
    with pytest.raises(ValueError, match="stored layout"):
        ops.bgemv(qt, xt)
    qj = jquant.quantize(aj, jquant.QuantSpec(8, None, transpose=True))
    with pytest.raises(ValueError, match="stored layout"):
        jops.bgemv(qj, xj)
    np.testing.assert_allclose(ops.bgemv(qt, xt, transpose_a=True).numpy(),
                               np.asarray(jops.bgemv(qj, xj, transpose_a=True)),
                               rtol=1e-5, atol=1e-5)


def test_bgemv_refuses_a_batched_packed_a_as_the_reference():
    """The reference's packed bgemv asserts a broadcast weight
    (repro/kernels/bgemv.py:158); the port raises a ValueError that says so."""
    qa = quant.quantize(torch.randn(2, 16, 8), quant.QuantSpec(transpose=True))
    with pytest.raises(ValueError, match="refuses a batched one too"):
        ops.bgemv(qa, torch.randn(2, 16), transpose_a=True)


@pytest.mark.parametrize("trans,batched,form", [(True, False, "broadcast_t"),
                                                (False, False, "broadcast_n"),
                                                (True, True, "batched_t"),
                                                (False, True, "batched_n")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("b,k,n", [(32, 2048, 2048), (4096, 32, 32), (4096, 64, 64)])
def test_bgemv_plan_names_the_form(trans, batched, form, dtype, b, k, n):
    """plan picks the body from the op, A's rank and a member's bytes: a
    member of at most MEMBER_MAX_BYTES ((32, 32) in every dtype, (64, 64) in
    bf16 and f32) takes the short-member body, MEMBERS members a block,
    under the same plan at every batch and with or without the gate; a
    longer member ((64, 64) f64, (2048, 2048)) and a broadcast A take
    `split_plan`.  The column body's tile is 128
    bytes of a row (512 a member) and its K split covers K in order (a
    member a batch chunk when batched); the row body's split is 1-8 warps a
    row, and a warp that takes a row alone takes ROW_BLOCK of them (half as
    many under the gate) under a broadcast A or rows shorter than one sweep
    of its 16-byte loads."""
    p = bgemv.plan(b, k, n, dtype, trans=trans, batched=batched)
    assert p.form == form
    elem = torch.finfo(dtype).bits // 8
    short = batched and k * n * elem <= bgemv.MEMBER_MAX_BYTES
    assert short == (batched and (k == 32 or (k == 64 and dtype != torch.float64)))
    if short:
        assert (p.members, p.splits, p.tile, p.rows, p.wpr) == (bgemv.MEMBERS, 1, 0, 0, 0)
        assert p.k_slices(k) == [(0, k)] and p.blocks(b, n) == -(-b // bgemv.MEMBERS)
        assert {bgemv.plan(batch, k, n, dtype, gate=gate, trans=trans, batched=True)
                for batch in (1, 7, 4096) for gate in (False, True)} == {p}
    elif trans:
        assert p.members == 0 and p.tile * elem == (512 if batched else 128)
        assert p.k_slices(k)[-1][1] == k
        assert p.rows % (bgemv.MEMBER_ROW_STEP if batched else bgemv.ROW_STEP) == 0
        assert p.chunks(b) == (b if batched else -(-b // bgemv.BATCH_CHUNK))
        assert p.blocks(b, n) == -(-n // p.tile) * p.splits * p.chunks(b)
    else:
        assert p.members == 0 and p.wpr in (1, 2, 4, 8) and p.splits == 1
        assert p.rows == (bgemv.ROW_BLOCK if p.wpr == 1 and not batched else 1)
        gated = bgemv.plan(b, k, n, dtype, gate=True, trans=trans, batched=batched)
        assert gated.rows == (bgemv.ROW_BLOCK // 2 if p.wpr == 1 and not batched else 1)
        small = bgemv.split_plan(4096, 32, 32, torch.float64, trans=False, batched=batched)
        assert (small.wpr, small.rows) == (1, bgemv.ROW_BLOCK)  # rows shorter than a sweep
        assert p.blocks(b, n) == -(-n // (bgemv.ROW_WARPS // p.wpr * p.rows)) * p.chunks(b)
    x = torch.empty(b, k, dtype=dtype, device="meta")
    a = torch.empty(((b,) if batched else ()) + ((k, n) if trans else (n, k)), device="meta")
    assert bgemv.plan_for(a, x, transpose_a=trans) == p


def test_bgemv_forms_count_nothing_on_the_cpu():
    """CPU tensors take the plain version in every form and count no launch;
    launch_counts has a key for each form and one for the short-member
    body."""
    ops.reset_launch_counts()
    a = torch.randn(2, 5, 7)
    for trans in (False, True):
        ops.bgemv(a, torch.randn(2, 5 if trans else 7), transpose_a=trans)
        ops.bgemv(a[0], torch.randn(2, 5 if trans else 7), transpose_a=trans)
    counts = ops.launch_counts()
    assert {f"bgemv_{f}" for f in bgemv.FORMS} | {"bgemv_members"} <= set(counts)
    assert set(counts.values()) == {0}
