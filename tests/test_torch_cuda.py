"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: each test skips without a CUDA device (always the case in
the CPU container).  On the GPU machine, which has no jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Small ragged and aligned shapes, so both the vector and the element-load
paths of each kernel run (chip_smoke.py holds them at the serving shapes).
Tolerances: f32 rtol = atol = 1e-4 (summation order), bf16 1.6e-2 (one
output rounding step at |y| ~ 4), f64 1e-10 (summation order).  dot and
nrm2 return one number, held to out * |plain| + acc * sum |x_i y_i| (nrm2:
||x||): `acc` the accumulator's summation error (1e-7 for the f32
accumulator of f32 and bf16, 1e-14 for f64), `out` one rounding flip of
the output (2^-7 bf16, 2^-23 f32, 2^-52 f64).  A kernel that returns 0 or drops half the vector falls
outside that limit (test_sum_limit_rejects_planted_faults, on the CPU).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import blas, quant
from repro_torch.kernels import ops

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2),
       torch.float64: dict(rtol=1e-10, atol=1e-10)}
SUM_TOL = {torch.float32: (2 ** -23, 1e-7), torch.bfloat16: (2 ** -7, 1e-7),
           torch.float64: (2 ** -52, 1e-14)}
BLAS_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _sum_limit(dtype, want: float, cond: float) -> float:
    out, acc = SUM_TOL[dtype]
    return out * abs(want) + acc * cond


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, dtype, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


def _against_plain(call, dtype):
    got = call()
    with ops.reference_mode():
        want = call()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,k,n", [(3, 37, 53), (4, 256, 512), (6, 1000, 264), (1, 64, 8)])
def test_bgemv_kernel_matches_plain(cuda, dtype, batch, k, n):
    w, w2 = _rand(cuda, dtype, k, n, std=k ** -0.5), _rand(cuda, dtype, k, n, std=k ** -0.5)
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    _against_plain(lambda: ops.bgemv(w, x), dtype)
    _against_plain(lambda: ops.bgemv(w, x, a2=w2, bias=bias, residual=res, activation="silu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgemm_kernel_matches_plain(cuda, dtype):
    a, b, b2 = (_rand(cuda, dtype, 2, 13, 37), _rand(cuda, dtype, 37, 53, std=37 ** -0.5),
                _rand(cuda, dtype, 37, 53, std=37 ** -0.5))
    bias, res = _rand(cuda, dtype, 53), _rand(cuda, dtype, 2, 13, 53)
    _against_plain(lambda: ops.bgemm(a, b, b2=b2, bias=bias, residual=res, activation="gelu"), dtype)
    _against_plain(lambda: ops.bgemm(a, b, activation="relu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_attention_kernel_matches_plain(cuda, dtype, d):
    q, kv = _rand(cuda, dtype, 3, 5, 4, d), _rand(cuda, dtype, 3, 24, 2, d)
    kv[1, 12:] = float("nan")  # garbage past slot 1's length
    lens = torch.tensor([5] * 4 + [12] * 4 + [20] * 4, dtype=torch.int32, device="cuda")
    _against_plain(lambda: ops.flash_attention(q, kv, kv, kv_lens=lens, kv_groups=2), dtype)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    ops.reset_launch_counts()
    w, x = _rand(cuda, torch.float32, 64, 32), _rand(cuda, torch.float32, 2, 64)
    ops.bgemv(w, x)
    ops.bgemm(x[None], w)
    ops.gemm(x, w)
    ops.gemv(w, x[0, :32])
    ops.dot(x[0], x[1])
    ops.nrm2(x[0])
    ops.axpy(2.0, x[0], x[1])
    qt, qn = (quant.quantize(w, quant.QuantSpec(16, None, transpose=t)) for t in (True, False))
    ops.bgemv(qt, x)
    ops.bgemm(x[None], qt)
    ops.gemm(x, qn)
    ops.gemv(quant.quantize(w.t().contiguous()), x[0])
    with ops.reference_mode():
        ops.bgemv(w, x)
        ops.gemm(x, w)
        ops.dot(x[0], x[1])
        ops.bgemv(qt, x)
        ops.gemm(x, qn)
    assert ops.launch_counts() == {"bgemv": 1, "bgemm": 1, "attention": 0, "gemm": 1,
                                   "gemv": 1, "blas1_reduce": 2, "blas1_axpy": 1,
                                   "bgemv_int8": 1, "gemv_int8": 1, "gemm_int8": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("m,k,n", [(13, 37, 53), (128, 64, 256), (130, 9, 67), (1, 300, 5),
                                   (0, 8, 3)])
def test_gemm_kernel_matches_plain(cuda, dtype, m, k, n):
    """Ragged and whole tiles, K below one k-step, a single row, no rows."""
    a, b, b2 = (_rand(cuda, dtype, m, k), _rand(cuda, dtype, k, n, std=k ** -0.5),
                _rand(cuda, dtype, k, n, std=k ** -0.5))
    bias, res = _rand(cuda, dtype, n), _rand(cuda, dtype, m, n)
    _against_plain(lambda: ops.gemm(a, b), dtype)
    _against_plain(lambda: ops.gemm(a, b, b2=b2, bias=bias, residual=res, activation="silu"),
                   dtype)
    _against_plain(lambda: ops.gemm(a, b, bias=bias, residual=res, activation="gelu"), dtype)
    _against_plain(lambda: ops.gemm(a, b, b2=b2, activation="relu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("m,n", [(37, 53), (256, 512), (1000, 264), (5, 4099), (3, 16384),
                                 (0, 16)])
def test_gemv_kernel_matches_plain(cuda, dtype, m, n):
    """Aligned rows (16-byte loads), ragged rows (element loads), few long
    rows (several warps a row), and an x that starts off 16 bytes."""
    a = _rand(cuda, dtype, m, n, std=n ** -0.5)
    xbuf = _rand(cuda, dtype, n + 1)
    _against_plain(lambda: ops.gemv(a, xbuf[:n]), dtype)
    _against_plain(lambda: ops.gemv(a, xbuf[1:]), dtype)


def _against_plain_sum(call, dtype, cond):
    """dot / nrm2: |kernel - plain| within _sum_limit, which a zero result
    would not meet."""
    got = call()
    with ops.reference_mode():
        want = call()
    torch.cuda.synchronize()
    assert got.shape == () and got.dtype == dtype
    want = want.double().item()
    limit = _sum_limit(dtype, want, cond)
    assert abs(got.double().item() - want) <= limit < abs(want), (got, want, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("n", [1, 37, 4096, 100003])
def test_blas1_kernels_match_plain(cuda, dtype, n):
    """dot, nrm2 and axpy on aligned vectors and on views that start one
    element in (element loads)."""
    buf_x, buf_y = _rand(cuda, dtype, n + 1), _rand(cuda, dtype, n + 1)
    for x, y in ((buf_x[:n], buf_y[:n]), (buf_x[1:], buf_y[1:])):
        cond = (x.double() * y.double()).abs().sum().item()
        _against_plain_sum(lambda: ops.dot(x, y), dtype, cond)
        _against_plain_sum(lambda: ops.nrm2(x), dtype, x.double().norm().item())
        _against_plain(lambda: ops.axpy(-1.75, x, y), dtype)


@pytest.mark.parametrize("dtype", BLAS_DTYPES)
def test_sum_limit_rejects_planted_faults(dtype):
    """On the CPU (plain versions): the dot/nrm2 limit above passes the
    result but not a zero result or one that drops half the vector."""
    gen = torch.Generator().manual_seed(1)
    n = 100003
    x, y = (torch.randn(n, generator=gen).to(dtype) for _ in range(2))
    cases = ((ops.dot, (x, y), (x.double() * y.double()).abs().sum().item()),
             (ops.nrm2, (x,), x.double().norm().item()))
    for fn, args, cond in cases:
        want = fn(*args).double().item()
        half = fn(*(a[: n // 2] for a in args)).double().item()
        limit = _sum_limit(dtype, want, cond)
        assert abs(want) > limit and abs(half - want) > limit, (fn, want, half, limit)


# --------------------------------------------------------------------------
# packed int8 weights (csrc/qgemv.cu, gemm.cu's int8-B variant)
# --------------------------------------------------------------------------

# (k, n, spec): the serving spec, per-chunk scales (qn a multiple of 16), an
# awkward _fit_block block with a ragged K (element loads), tiny blocks
PACKED_SPECS = [(256, 96, quant.QuantSpec(64, None)), (128, 70, quant.QuantSpec(16, 32)),
                (61, 45, quant.QuantSpec(61, None)), (50, 33, quant.QuantSpec(7, 5))]


def _packed(gen, k, n, spec, transpose):
    w = _rand(gen, torch.float32, k, n, std=k ** -0.5)
    return quant.quantize(w, quant.QuantSpec(spec.block_m, spec.block_n, transpose=transpose))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("batch", [1, 4, 6])
@pytest.mark.parametrize("k,n,spec", PACKED_SPECS)
def test_packed_bgemv_kernel_matches_plain(cuda, dtype, batch, k, n, spec):
    """Output-major rows: one row scale, per-chunk scales and element loads;
    the dual gate and every epilogue stage; batches below, at and above 4."""
    qw, qw2 = (_packed(cuda, k, n, spec, True) for _ in range(2))
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    _against_plain(lambda: ops.bgemv(qw, x), dtype)
    _against_plain(lambda: ops.bgemv(qw, x, a2=qw2, bias=bias, residual=res,
                                     activation="silu"), dtype)
    _against_plain(lambda: ops.bgemv(qw, x, bias=bias, activation="gelu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("k,n,spec", PACKED_SPECS)
def test_packed_gemv_kernel_matches_plain(cuda, dtype, k, n, spec):
    """BLAS gemv over a packed (m, n) A, and an x that starts off 16 bytes."""
    qa = _packed(cuda, n, k, spec, False)  # stored (n, k): y (n,) = A x (k,)
    xbuf = _rand(cuda, dtype, k + 1)
    _against_plain(lambda: ops.gemv(qa, xbuf[:k]), dtype)
    _against_plain(lambda: ops.gemv(qa, xbuf[1:]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m,k,n,spec", [(13, 37, 53, quant.QuantSpec(37, None)),
                                        (130, 64, 67, quant.QuantSpec(8, 16)),
                                        (9, 40, 130, quant.QuantSpec(8, None)),
                                        (20, 33, 29, quant.QuantSpec(11, 3)),
                                        (33, 40, 132, quant.QuantSpec(8, None)),
                                        (7, 68, 50, quant.QuantSpec(10, 17)),
                                        (0, 16, 8, quant.QuantSpec(8, None))])
def test_packed_gemm_kernel_matches_plain(cuda, dtype, transpose, m, k, n, spec):
    """int8 B in the "nk" and "kn" layouts: ragged tiles, awkward blocks."""
    qb, qb2 = (_packed(cuda, k, n, spec, transpose) for _ in range(2))
    a, bias, res = _rand(cuda, dtype, m, k), _rand(cuda, dtype, n), _rand(cuda, dtype, m, n)
    _against_plain(lambda: ops.gemm(a, qb), dtype)
    _against_plain(lambda: ops.gemm(a, qb, b2=qb2, bias=bias, residual=res,
                                    activation="silu"), dtype)
    if dtype != torch.float64:
        a3, r3 = _rand(cuda, dtype, 2, 7, k), _rand(cuda, dtype, 2, 7, n)
        _against_plain(lambda: ops.bgemm(a3, qb, bias=bias, residual=r3, activation="gelu"),
                       dtype)


@pytest.mark.cuda
def test_quantize_on_the_card_is_bitwise_the_cpu(cuda):
    w = _rand(cuda, torch.bfloat16, 300, 200)
    w[:64] = 0  # an all-zero block
    for spec in (quant.QuantSpec(64, None, transpose=True), quant.QuantSpec(7, 16)):
        got, want = quant.quantize(w, spec), quant.quantize(w.cpu(), spec)
        assert torch.equal(got.values.cpu(), want.values)
        assert torch.equal(got.scales.cpu(), want.scales)


@pytest.mark.cuda
def test_packed_matmul_fused_routes_through_the_packed_kernels(cuda):
    qw = _packed(cuda, 64, 48, quant.QuantSpec(16, None), True)
    ops.reset_launch_counts()
    for shape in ((4, 1, 64), (2, 5, 64), (5, 64)):
        x = _rand(cuda, torch.bfloat16, *shape)
        _against_plain(lambda: blas.matmul_fused(x, qw, activation="relu"), torch.bfloat16)
    counts = ops.launch_counts()
    assert (counts["bgemv_int8"], counts["gemm_int8"]) == (1, 2)
    assert counts["bgemv"] == counts["bgemm"] == counts["gemm"] == 0


@pytest.mark.cuda
def test_int8_smoke_serve_matches_plain_path(cuda):
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config("stablelm-1.6b", "smoke")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
    kw = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, prompts=prompts, quantize="int8",
              params=tf.init_params(cfg, 0, "cuda"), verbose=False, device="cuda")
    ops.reset_launch_counts()
    got = serve("stablelm-1.6b", "smoke", **kw)
    counts = ops.launch_counts()
    with ops.reference_mode():
        want = serve("stablelm-1.6b", "smoke", **kw)
    assert got["outputs"] == want["outputs"]
    assert counts["bgemv_int8"] > 0 and counts["gemm_int8"] > 0
    assert counts["bgemv"] == counts["bgemm"] == 0
