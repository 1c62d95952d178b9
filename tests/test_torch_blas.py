"""The port's BLAS library against the JAX package's.

On the CPU the port's kernel wrappers (`repro_torch.kernels.ops`: gemm,
gemv, dot, nrm2, axpy) run their kernels' plain PyTorch versions; the JAX
side runs `repro.kernels.ops` in Pallas interpret mode, and `repro.core.blas`
under `use_backend("pallas")`.  Same numpy inputs through both; f64 cases
run JAX inside `jax.enable_x64(True)` so its arrays stay float64.

Tolerances: f64 rtol = atol = 1e-12 and f32 1e-5 (only the summation order
differs); bf16 2e-2, one bf16 rounding step of the output.  dot and nrm2
return one number, held to out * |want| + acc * sum |x_i y_i| (for nrm2,
||x||), since a sum's error scales with the condition and not with the
result: `acc` is the accumulator's summation error (1e-7 for the f32
accumulator of f32 and bf16, 1e-14 for f64) and `out` one rounding flip of
the output (2^-7 bf16, 2^-23 f32, 2^-52 f64).  Each such check also asserts that a zero result
would fall outside the limit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.core import epilogue as jepilogue
from repro.kernels import ops as jops
from repro_torch.core import blas, epilogue
from repro_torch.kernels import blas1, gemv as tgemv, ops

DTYPES = ["float32", "bfloat16", "float64"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2),
       "float64": dict(rtol=1e-12, atol=1e-12)}
SUM_TOL = {"float32": (2 ** -23, 1e-7), "bfloat16": (2 ** -7, 1e-7),
           "float64": (2 ** -52, 1e-14)}
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
    a = np.asarray(a, np.float64)
    if dtype == "float64":
        return jnp.asarray(a, jnp.float64), torch.from_numpy(a.copy())
    a32 = a.astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(torch.bfloat16)
    return jnp.asarray(a32), torch.from_numpy(a32)


def _numpy(want):
    return np.asarray(want).astype(np.float64)


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.double().numpy(), _numpy(want), **TOL[dtype])


def _close_sum(got: torch.Tensor, want, dtype, cond: float):
    """|got - want| <= out * |want| + acc * cond for a reduction with
    condition cond, a limit that a zero result would not meet."""
    assert got.dtype == TORCH[dtype] and got.shape == ()
    want = float(_numpy(want))
    out, acc = SUM_TOL[dtype]
    limit = out * abs(want) + acc * cond
    assert abs(got.double().item() - want) <= limit < abs(want), (got, want, limit)


def _operands(rng, dtype, **shapes):
    """Normal operands by name; a trailing '_w' scales a (k, n) weight by
    k^-0.5 so every accumulator is O(1)."""
    js, ts = {}, {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape)
        if name.endswith("_w"):
            a = a * shape[0] ** -0.5
        js[name], ts[name] = _pair(a, dtype)
    return js, ts


# --------------------------------------------------------------------------
# kernel wrappers: repro_torch.kernels.ops against repro.kernels.ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("m,k,n", [(13, 37, 29), (8, 64, 48)])
def test_gemm_matches_pallas(dtype, act, bias, gate, res, m, k, n):
    """Ragged primes and sizes below one 128-wide tile, every epilogue."""
    rng = np.random.default_rng(m * 100 + k)
    shapes = dict(a=(m, k), b_w=(k, n))
    if gate:
        shapes["b2_w"] = (k, n)
    if bias:
        shapes["bias"] = (n,)
    if res:
        shapes["residual"] = (m, n)
    kw = lambda d: {key: d.get(key) for key in ("bias", "residual")}  # noqa: E731
    with precision(dtype):  # JAX arrays made inside it stay float64
        js, ts = _operands(rng, dtype, **shapes)
        want = jops.gemm(js["a"], js["b_w"], b2=js.get("b2_w"), activation=act, **kw(js))
        got = ops.gemm(ts["a"], ts["b_w"], b2=ts.get("b2_w"), activation=act, **kw(ts))
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(37, 53), (5, 300), (64, 128), (1, 7)])
def test_gemv_matches_pallas(dtype, m, n):
    rng = np.random.default_rng(m * 1000 + n)
    with precision(dtype):
        js, ts = _operands(rng, dtype, a=(m, n), x=(n,))
        _close(ops.gemv(ts["a"], ts["x"]), jops.gemv(js["a"], js["x"]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 37, 300, 2049])
def test_level1_matches_pallas(dtype, n):
    """dot, nrm2 (0-d results in x's dtype) and axpy, ragged n around the
    reference's 2048-element strip."""
    rng = np.random.default_rng(n)
    with precision(dtype):
        js, ts = _operands(rng, dtype, x=(n,), y=(n,))
        xd, yd = ts["x"].double(), ts["y"].double()
        _close_sum(ops.dot(ts["x"], ts["y"]), jops.dot(js["x"], js["y"]), dtype,
                   (xd * yd).abs().sum().item())
        _close_sum(ops.nrm2(ts["x"]), jops.nrm2(js["x"]), dtype, xd.norm().item())
        _close(ops.axpy(-1.75, ts["x"], ts["y"]), jops.axpy(-1.75, js["x"], js["y"]), dtype)


# --------------------------------------------------------------------------
# the public library: repro_torch.core.blas against repro.core.blas
# --------------------------------------------------------------------------

M, K, N, B = 13, 37, 29, 3

# name -> call(L, E, v) on either library L with its Epilogue class E and
# its operands v; both libraries take the same arguments
CALLS = {
    "gemm alpha beta C": lambda L, E, v: L.gemm(v["A"], v["B"], v["C"], alpha=1.5, beta=-0.5),
    "gemm transposes": lambda L, E, v: L.gemm(v["At"], v["Bt"], transpose_a=True,
                                              transpose_b=True, alpha=-2.0),
    "gemm epilogue str": lambda L, E, v: L.gemm(v["A"], v["B"], bias=v["bias"], epilogue="gelu"),
    "gemm Epilogue gate": lambda L, E, v: L.gemm(
        v["A"], v["Bt"], transpose_b=True, B2=v["B2t"], residual=v["C"],
        epilogue=E(activation="silu", gate=True, residual=True)),
    "gemv alpha beta y": lambda L, E, v: L.gemv(v["A"], v["xk"], v["ym"], alpha=0.5, beta=2.0),
    "gemv trans": lambda L, E, v: L.gemv(v["A"], v["xm"], v["yk"], alpha=-1.0, beta=0.25,
                                         trans=True),
    "batched_gemm broadcast B": lambda L, E, v: L.batched_gemm(v["A3"], v["B"], alpha=2.0),
    "batched_gemm fused": lambda L, E, v: L.batched_gemm(v["A3"], v["B"], B2=v["B2"],
                                                         bias=v["bias"], epilogue="silu"),
    "batched_gemv trans": lambda L, E, v: L.batched_gemv(v["A"], v["XB"], v["YB"],
                                                         beta=-1.0, trans=True),
    "matmul_fused 2-D": lambda L, E, v: L.matmul_fused(v["A"], v["B"], w2=v["B2"],
                                                       bias=v["bias"], residual=v["C"],
                                                       activation="relu"),
    "matmul 1-D": lambda L, E, v: L.matmul(v["xk"], v["B"]),
    "axpy": lambda L, E, v: L.axpy(1.25, v["xk"], v["yk"]),
    "scal": lambda L, E, v: L.scal(-3.0, v["xk"]),
}
SUMS = {  # name -> (call, condition from the float64 operands)
    "dot": (lambda L, v: L.dot(v["xk"], v["yk"]),
            lambda v: (v["xk"].double() * v["yk"].double()).abs().sum().item()),
    "nrm2": (lambda L, v: L.nrm2(v["xk"]), lambda v: v["xk"].double().norm().item()),
}


def _blas_operands(dtype):
    rng = np.random.default_rng(7)
    return _operands(rng, dtype, A=(M, K), At=(K, M), B_w=(K, N), Bt=(N, K), B2_w=(K, N),
                     B2t=(N, K), C=(M, N), bias=(N,), A3=(B, M, K), xk=(K,), yk=(K,),
                     xm=(M,), ym=(M,), XB=(B, M), YB=(B, K))


def _named(d):
    """Operand names without the weight-scale suffix."""
    return {k.removesuffix("_w"): v for k, v in d.items()}


# the batched forms run the serving kernels (bgemm, bgemv), which take
# f32 and bf16 only (test_serving_kernels_refuse_f64)
CALL_CASES = [(name, dtype) for name in sorted(CALLS) for dtype in DTYPES
              if not (name.startswith("batched") and dtype == "float64")]


@pytest.mark.parametrize("name,dtype", CALL_CASES)
def test_core_blas_matches_pallas(name, dtype):
    call = CALLS[name]
    with precision(dtype), jblas.use_backend("pallas"):
        js, ts = (_named(d) for d in _blas_operands(dtype))
        want = call(jblas, jepilogue.Epilogue, js)
        got = call(blas, epilogue.Epilogue, ts)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(SUMS))
def test_core_blas_sums_match_pallas(dtype, name):
    call, cond = SUMS[name]
    with precision(dtype), jblas.use_backend("pallas"):
        js, ts = (_named(d) for d in _blas_operands(dtype))
        _close_sum(call(blas, ts), call(jblas, js), dtype, cond(ts))


def test_blas_rejects_what_the_reference_rejects():
    a, b = torch.randn(4, 6), torch.randn(6, 5)
    with pytest.raises(ValueError, match="fused epilogue"):
        blas.gemm(a, b, alpha=2.0, epilogue="relu")
    with pytest.raises(ValueError, match="fused epilogue"):
        blas.gemm(a, b, torch.randn(4, 5), beta=1.0, bias=torch.randn(5))
    with pytest.raises(ValueError, match="fused epilogue"):
        blas.batched_gemm(a[None], b, alpha=0.5, B2=b, epilogue="silu")
    with pytest.raises(TypeError, match="epilogue"):
        blas.gemm(a, b, epilogue=3)
    with pytest.raises(ValueError, match="shape"):
        blas.gemv(a, torch.randn(5))
    with pytest.raises(ValueError, match="1-D"):
        blas.dot(torch.randn(3), torch.randn(4))
    with pytest.raises(TypeError, match="dtype"):
        blas.axpy(1.0, torch.randn(3), torch.randn(3).double())
    with pytest.raises(TypeError, match="dtype"):
        blas.gemm(a.half(), b.half())


def test_unported_forms_name_their_roadmap_item():
    a = torch.randn(2, 3, 4)
    with pytest.raises(NotImplementedError, match="item 3"):
        blas.batched_gemm(a, torch.randn(2, 4, 5))
    with pytest.raises(NotImplementedError, match="item 1"):
        blas.batched_gemv(torch.randn(4, 3), torch.randn(2, 3))
    with pytest.raises(NotImplementedError, match="item 1"):
        blas.batched_gemv(a, torch.randn(2, 4), trans=True)


@pytest.mark.parametrize("op", ["bgemv", "bgemm"])
def test_serving_kernels_refuse_f64(op):
    """The serving kernels take f32 and bf16 only; f64 is the BLAS kernels'."""
    w = torch.randn(8, 6, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        if op == "bgemv":
            ops.bgemv(w, torch.randn(2, 8, dtype=torch.float64))
        else:
            ops.bgemm(torch.randn(2, 3, 8, dtype=torch.float64), w)


@pytest.mark.parametrize("shape,kernel", [((7, 16), "gemm"), ((16,), "gemm"),
                                          ((2, 1, 16), "bgemv"), ((2, 5, 16), "bgemm")])
def test_matmul_fused_routes_like_the_reference(monkeypatch, shape, kernel):
    """1-D and 2-D inputs reach ops.gemm (blas.py:546-551); decode-shaped
    inputs the broadcast bgemv, other batched inputs bgemm."""
    seen = []
    for name in ("gemm", "bgemv", "bgemm"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **k: seen.append(_n) or _r(*a, **k))
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(*shape, generator=g), torch.randn(16, 12, generator=g)
    res = torch.randn(*shape[:-1], 12, generator=g)
    got = blas.matmul_fused(x, w, w2=w, residual=res, activation="silu")
    assert seen == [kernel] and got.shape == (*shape[:-1], 12)
    want = torch.nn.functional.silu(x @ w) * (x @ w) + res
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_epilogue_apply_keeps_f64():
    """Accumulator precision: f64 stays f64 (bias/residual cast up to it),
    bf16 and f32 accumulate in f32, matching JAX's apply under x64."""
    rng = np.random.default_rng(3)
    acc, acc2, bias, res = (rng.standard_normal(s) for s in ((4, 5), (4, 5), (5,), (4, 5)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    spec = dict(activation="gelu", bias=True, gate=True, residual=True)
    got = epilogue.Epilogue(**spec).apply(t(acc), acc2=t(acc2), bias=t(bias).float(),
                                          residual=t(res).to(torch.bfloat16))
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = jepilogue.Epilogue(**spec).apply(
            jnp.asarray(acc), acc2=jnp.asarray(acc2), bias=jnp.asarray(bias, jnp.float32),
            residual=jnp.asarray(res, jnp.bfloat16))
        assert want.dtype == jnp.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    low = epilogue.Epilogue("silu").apply(t(acc).to(torch.bfloat16))
    assert low.dtype == torch.float32


@pytest.mark.parametrize("spec", [None, "relu", epilogue.Epilogue("gelu", bias=True)])
@pytest.mark.parametrize("bias,gate,res", [(False, False, False), (True, True, True),
                                           (False, True, False)])
def test_epilogue_spec_helpers_match_reference(spec, bias, gate, res):
    """as_epilogue + make derive the same spec (flags from the operands
    actually passed) and is_identity as the reference's helpers."""
    jspec = (jepilogue.Epilogue(spec.activation, spec.bias, spec.gate, spec.residual)
             if isinstance(spec, epilogue.Epilogue) else spec)
    operand = lambda flag: torch.ones(1) if flag else None  # noqa: E731
    got = epilogue.make(epilogue.as_epilogue(spec).activation, bias=operand(bias),
                        gate=operand(gate), residual=operand(res))
    want = jepilogue.make(jepilogue.as_epilogue(jspec).activation, bias=bias or None,
                          gate=gate or None, residual=res or None)
    fields = lambda e: (e.activation, e.bias, e.gate, e.residual)  # noqa: E731
    assert fields(got) == fields(want)
    assert got.is_identity == want.is_identity


def test_cpu_blas_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.randn(6)
    blas.gemm(torch.randn(3, 6), torch.randn(6, 2))
    blas.gemv(torch.randn(3, 6), x)
    blas.dot(x, x), blas.nrm2(x), blas.axpy(2.0, x, x)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("m,n,elem", [(16384, 16384, 8), (16383, 16385, 4), (512, 2048, 4),
                                      (3, 16384, 2), (37, 53, 8)])
def test_gemv_warps_per_row_plan(m, n, elem):
    """One warp a row while the rows fill the card; up to 8 for few long
    rows, never so many that a warp has under two unrolled sweeps."""
    wpr = tgemv.warps_per_row(m, n, elem, sms=132)
    assert wpr in (1, 2, 4, 8)
    assert wpr == 1 or m * wpr // 2 < 32 * 132
    assert wpr == 1 or n // wpr >= 2 * 32 * (16 // elem) * 4


@pytest.mark.parametrize("n,elem", [(2 ** 26, 8), (2 ** 26 - 3, 4), (1, 2), (0, 4)])
def test_blas1_grid_fills_the_card_once(n, elem):
    blocks = blas1.grid_blocks(n, elem, sms=132)
    assert 1 <= blocks <= 8 * 132
    assert blocks == 8 * 132 or blocks * 256 * (16 // elem) >= n
