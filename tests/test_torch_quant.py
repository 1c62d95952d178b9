"""Block-scaled int8 weights in the port against the JAX package.

- `repro_torch.core.quant` (quantize, dequantize, elementwise_bound, the
  degenerate-block contract, byte helpers) against `repro.core.quant` on
  the same numpy inputs: values, scales and dequantized tensors bitwise.
  matvec_error_bound takes its f32 sums (|x| over a block, the block terms
  of a row) in another order than XLA's reduce, so it is held within rtol
  1e-6 (a few f32 ulps), and shown to bound the packed product's error.
- Each packed kernel's plain version (`repro_torch.kernels.ops`: bgemv,
  bgemm "nk", gemm "kn"/"nk", gemv) against `repro.kernels.ops` in Pallas
  interpret mode, both fed one quantized tensor built from the same numpy
  arrays.  Tolerances as the dense parity tests: f32 rtol = atol = 1e-5 and
  f64 1e-12 (summation order), bf16 1.6e-2 (one output rounding step).
  bf16 is held against the Pallas kernels, which dequantize in the f32
  accumulator as the port does, not against the `ref` backend, which rounds
  the weight to bf16 first.
- `quantize_weights`, `from_jax_params` on a packed tree, `matmul_fused`'s
  routes, and `serve(quantize="int8")` against JAX serve with
  `backend="ref"` (exact W8A16 on the f32 smoke model; the `xla` backend's
  W8A8 host path gives other tokens).
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
from repro.launch.serve import serve as jax_serve
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.core import blas, quant
from repro_torch.kernels import bgemm as tbgemm
from repro_torch.kernels import bgemv as tbgemv
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemv as tgemv
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "stablelm-1.6b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
       "float64": dict(rtol=1e-12, atol=1e-12)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}

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
    return jnp.asarray(a32, JAX[dtype]), torch.from_numpy(a32).to(TORCH[dtype])


def _packed_pair(w, spec: quant.QuantSpec):
    """One packed weight for both packages: quantized by the port, the JAX
    QuantizedTensor built from the same int8 values and f32 scales."""
    qt = quant.quantize(torch.from_numpy(np.asarray(w, np.float32)), spec)
    qj = jquant.QuantizedTensor(values=jnp.asarray(qt.values.numpy()),
                                scales=jnp.asarray(qt.scales.numpy()), block=qt.block,
                                transposed=qt.transposed)
    return qj, qt


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want).astype(np.float64),
                               **TOL[dtype])


def _spec(block, transpose):
    return quant.QuantSpec(block_m=block[0], block_n=block[1], transpose=transpose)


def _jspec(block, transpose):
    return jquant.QuantSpec(block_m=block[0], block_n=block[1], transpose=transpose)


# --------------------------------------------------------------------------
# core.quant
# --------------------------------------------------------------------------

# the serving block, 2-D blocks, and awkward dims that _fit_block shrinks
# (61 -> 45 rows of 90; 7 x 5 blocks of 70 x 45 -> (7, 5))
BLOCKS = [(64, None), (16, 32), (61, None), (7, 5)]
SHAPES = [(90, 70), (3, 48, 45)]


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 2.0
    w[..., :16, :16] = 0.0  # an all-zero block at every block size here
    return w


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_is_bitwise_the_reference(shape, block, transpose):
    w = _weights(shape, len(shape) * 10 + block[0])
    want = jquant.quantize(jnp.asarray(w), _jspec(block, transpose))
    got = quant.quantize(torch.from_numpy(w), _spec(block, transpose))
    assert got.block == tuple(want.block) and got.transposed == want.transposed
    assert got.shape == tuple(want.shape) and got.stored_shape == tuple(want.stored_shape)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert got.values.is_contiguous() and got.scales.is_contiguous()
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    np.testing.assert_array_equal(got.dequantize(torch.bfloat16).float().numpy(),
                                  np.asarray(want.dequantize(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(got.elementwise_bound().numpy(),
                                  np.asarray(want.elementwise_bound()))
    # the kernels' in-accumulator dequantization equals the oracle in f32
    np.testing.assert_array_equal(quant.dequantize_in(got, torch.float32).numpy(),
                                  np.asarray(want.dequantize()))


@pytest.mark.parametrize("block", BLOCKS)
def test_matvec_error_bound_matches_the_reference(block):
    w = _weights((90, 70), block[0])
    x = np.random.default_rng(1).standard_normal(70).astype(np.float32)
    want = jquant.matvec_error_bound(jquant.quantize(jnp.asarray(w), _jspec(block, False)),
                                     jnp.asarray(x))
    qt = quant.quantize(torch.from_numpy(w), _spec(block, False))
    got = quant.matvec_error_bound(qt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # and it bounds the packed product's error
    err = (qt.dequantize().double() @ torch.from_numpy(x).double()
           - torch.from_numpy(w).double() @ torch.from_numpy(x).double()).abs()
    assert bool((err <= got.double() * (1 + 1e-5)).all())


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_inputs_propagate_to_their_block_scale(bad):
    w = _weights((64, 48), 7)
    w[20, 5] = bad  # block (16, 16) row 1, column 0
    spec = (16, 16)
    want = jquant.quantize(jnp.asarray(w), _jspec(spec, False))
    got = quant.quantize(torch.from_numpy(w), _spec(spec, False))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert not quant.scales_finite(got) and not jquant.scales_finite(want)
    bad_block = ~np.isfinite(got.scales.numpy())
    assert bad_block.sum() == 1 and bad_block[1, 0]
    # the values of every other block are specified, and equal
    keep = np.repeat(np.repeat(~bad_block, 16, 0), 16, 1)
    np.testing.assert_array_equal(got.values.numpy()[keep], np.asarray(want.values)[keep])
    with pytest.raises(ValueError, match="NaN/Inf"):
        quant.quantize(torch.from_numpy(w), _spec(spec, False), validate=True)


def test_all_zero_blocks_get_scale_zero_and_exact_zeros():
    w = np.zeros((32, 32), np.float32)
    w[16:, 16:] = 1.5
    got = quant.quantize(torch.from_numpy(w), quant.QuantSpec(16, 16), validate=True)
    assert got.scales.tolist() == [[0.0, 0.0], [0.0, float(np.float32(1.5) / np.float32(127))]]
    assert quant.scales_finite(got)
    np.testing.assert_array_equal(got.dequantize().numpy()[:16], 0.0)


def test_packed_helpers_match_the_reference():
    for shape, block in (((2048, 5632), (64, None)), ((24, 5632, 2048), (64, None)),
                         ((61, 67), (16, 32))):
        assert quant.packed_weight_bytes(shape, block) == jquant.packed_weight_bytes(shape, block)
        for full in (2, 4):
            assert quant.weight_traffic_ratio(shape, full_bytes_per_elem=full, block=block) == \
                jquant.weight_traffic_ratio(shape, full_bytes_per_elem=full, block=block)
    qt = quant.quantize(torch.randn(8, 4))
    assert quant.is_quantized(qt) and not quant.is_quantized(qt.values)
    moved = qt.to("cpu")
    assert moved.block == qt.block and torch.equal(moved.values, qt.values)
    with pytest.raises(ValueError, match="matrix"):
        quant.quantize(torch.randn(5))
    with pytest.raises(ValueError, match="int8"):
        quant.QuantSpec(dtype="int4")


# --------------------------------------------------------------------------
# the packed kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------------

def _epi(rng, dtype, act, bias, gate, res, w_shape, spec, out_shape, n):
    """Epilogue operands for both packages: a packed gate weight, bias (n,)
    and residual of out_shape."""
    js, ts = {"activation": act}, {"activation": act}
    if gate:
        w2 = rng.standard_normal(w_shape) * w_shape[0] ** -0.5
        js["gate"], ts["gate"] = _packed_pair(w2, spec)
    if bias:
        js["bias"], ts["bias"] = _pair(rng.standard_normal(n), dtype)
    if res:
        js["residual"], ts["residual"] = _pair(rng.standard_normal(out_shape), dtype)
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("batch,d,f,block", [(3, 48, 40, (64, None)), (5, 45, 37, (7, None)),
                                             (2, 64, 24, (8, 16))])
def test_packed_bgemv_matches_pallas(dtype, act, bias, gate, res, batch, d, f, block):
    """Output-major (transposed) packed weights, the decode layout; ragged
    dims and awkward blocks."""
    rng = np.random.default_rng(batch * 100 + d)
    spec = _spec(block, True)
    wj, wt = _packed_pair(rng.standard_normal((d, f)) * d ** -0.5, spec)
    xj, xt = _pair(rng.standard_normal((batch, d)), dtype)
    ej, et = _epi(rng, dtype, act, bias, gate, res, (d, f), spec, (batch, f), f)
    want = jops.bgemv(wj, xj, a2=ej.pop("gate", None), transpose_a=True, **ej)
    got = ops.bgemv(wt, xt, a2=et.pop("gate", None), transpose_a=True, **et)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
@pytest.mark.parametrize("batch,m,k,n,block", [(2, 5, 48, 40, (64, None)),
                                               (3, 7, 45, 37, (7, None))])
def test_packed_bgemm_nk_matches_pallas(dtype, act, bias, gate, res, batch, m, k, n, block):
    """The prefill route: output-major packed B ("nk"), ragged prompts."""
    rng = np.random.default_rng(batch * 100 + k)
    spec = _spec(block, True)
    bj, bt = _packed_pair(rng.standard_normal((k, n)) * k ** -0.5, spec)
    aj, at = _pair(rng.standard_normal((batch, m, k)), dtype)
    ej, et = _epi(rng, dtype, act, bias, gate, res, (k, n), spec, (batch, m, n), n)
    want = jops.bgemm(aj, bj, b2=ej.pop("gate", None), out_dtype=JAX[dtype], **ej)
    got = ops.bgemm(at, bt, b2=et.pop("gate", None), **et)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("act,bias,gate,res", [EPILOGUES[0], EPILOGUES[2], EPILOGUES[4],
                                               EPILOGUES[5]])
@pytest.mark.parametrize("m,k,n,block", [(13, 48, 40, (64, None)), (9, 45, 36, (9, 12))])
def test_packed_gemm_matches_pallas(dtype, transpose, act, bias, gate, res, m, k, n, block):
    """int8 B in both layouts ("nk" for transposed storage, else "kn")."""
    rng = np.random.default_rng(m * 100 + k)
    spec = _spec(block, transpose)
    with precision(dtype):
        bj, bt = _packed_pair(rng.standard_normal((k, n)) * k ** -0.5, spec)
        aj, at = _pair(rng.standard_normal((m, k)), dtype)
        ej, et = _epi(rng, dtype, act, bias, gate, res, (k, n), spec, (m, n), n)
        want = jops.gemm(aj, bj, b2=ej.pop("gate", None), out_dtype=JAX[dtype], **ej)
        got = ops.gemm(at, bt, b2=et.pop("gate", None), **et)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("m,n,block", [(37, 48, (64, None)), (45, 35, (9, 7)), (64, 300, (16, 100))])
def test_packed_gemv_matches_pallas(dtype, m, n, block):
    rng = np.random.default_rng(m * 1000 + n)
    with precision(dtype):
        aj, at = _packed_pair(rng.standard_normal((m, n)) * n ** -0.5, _spec(block, False))
        xj, xt = _pair(rng.standard_normal(n), dtype)
        _close(ops.gemv(at, xt), jops.gemv(aj, xj), dtype)


def test_packed_wrappers_check_their_operands():
    qt = quant.quantize(torch.randn(16, 8), quant.QuantSpec(8, None, transpose=True))
    qn = quant.quantize(torch.randn(16, 8), quant.QuantSpec(8, None))
    x = torch.randn(2, 16)
    with pytest.raises(ValueError, match="stored layout"):
        ops.bgemv(qt, x, transpose_a=False)
    with pytest.raises(ValueError, match="share one quantization spec"):
        ops.bgemv(qt, x, a2=qn)
    with pytest.raises(ValueError, match="share one quantization spec"):
        ops.gemm(x, qt, b2=torch.randn(16, 8))
    with pytest.raises(ValueError, match="stored layout"):
        ops.gemv(qt.to("cpu"), torch.randn(8))
    with pytest.raises(TypeError, match="int8"):
        ops.gemm(x, quant.QuantizedTensor(qn.values.float(), qn.scales, qn.block))
    with pytest.raises(ValueError, match="tile"):
        ops.gemm(x, quant.QuantizedTensor(qn.values, qn.scales[:1], qn.block))
    with pytest.raises(ValueError, match="shape"):
        ops.bgemv(qt, torch.randn(2, 9))
    with pytest.raises(NotImplementedError, match="item 1"):
        ops.bgemv(quant.quantize(torch.randn(2, 16, 8), quant.QuantSpec(transpose=True)), x)


def test_packed_call_on_another_device_raises():
    """No fallback: a packed call on a device with no kernel raises."""
    qt = quant.quantize(torch.randn(16, 8), quant.QuantSpec(8, None, transpose=True)).to("meta")
    with pytest.raises(ValueError, match="no kernel or plain version for device meta"):
        ops.bgemv(qt, torch.empty(2, 16, device="meta"))
    with pytest.raises(ValueError, match="on cpu, expected meta"):
        ops.bgemv(quant.quantize(torch.randn(16, 8), quant.QuantSpec(transpose=True)),
                  torch.empty(2, 16, device="meta"))


def test_plain_versions_dequantize_in_the_accumulator_dtype():
    """f64 activations dequantize in f64 (exact value * scale products), as
    the Pallas bodies' dequant_tile(dtype=acc) does: not through f32."""
    qa = quant.quantize(torch.randn(6, 40, dtype=torch.float64), quant.QuantSpec(3, None))
    x = torch.randn(40, dtype=torch.float64)
    want = (qa.values.double() * qa.scales.double().repeat_interleave(3, 0)) @ x
    torch.testing.assert_close(tgemv.reference_int8(qa, x), want, rtol=1e-15, atol=1e-15)
    assert quant.dequantize_in(qa, torch.float64).dtype == torch.float64
    # CPU tensors take the plain versions and launch nothing
    ops.reset_launch_counts()
    qb = quant.quantize(torch.randn(40, 6), quant.QuantSpec(8, None, transpose=True))
    xb = torch.randn(2, 3, 40)
    assert torch.equal(ops.bgemm(xb, qb), tbgemm.reference_int8(xb, qb))
    assert torch.equal(ops.gemm(xb[0], qb), tgemm.reference_int8(xb[0], qb))
    x0 = xb[:, 0].contiguous()
    assert torch.equal(ops.bgemv(qb, x0), tbgemv.reference_int8(qb, x0))
    assert set(ops.launch_counts().values()) == {0}


# --------------------------------------------------------------------------
# the model: quantize_weights, convert, matmul_fused, serve
# --------------------------------------------------------------------------

def _jax_params(seed=0):
    return jtf.init_params(jax.random.PRNGKey(seed), jax_config(ARCH, "smoke"))


def _port_params(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams), get_config(ARCH, "smoke"),
                           device="cpu")


def test_quantize_weights_packs_what_the_reference_packs():
    jparams = _jax_params()
    want = jlayers.quantize_weights(jparams)
    got = layers.quantize_weights(_port_params(jparams))
    for i, lp in enumerate(got["layers"]):
        for grp, leaves in lp.items():
            for key, leaf in leaves.items():
                ref = want["layers"][grp][key]
                assert quant.is_quantized(leaf) == jquant.is_quantized(ref), (grp, key)
                assert quant.is_quantized(leaf) == (key in layers.QUANT_WEIGHT_KEYS)
                if quant.is_quantized(leaf):
                    assert leaf.transposed and leaf.block == tuple(ref.block)
                    assert leaf.stored_shape == tuple(ref.stored_shape[1:])
                    np.testing.assert_array_equal(leaf.values.numpy(),
                                                  np.asarray(ref.values[i]))
                    np.testing.assert_array_equal(leaf.scales.numpy(),
                                                  np.asarray(ref.scales[i]))
    assert not quant.is_quantized(got["head"]["w"]) and not quant.is_quantized(
        got["embed"]["table"])
    # packed leaves pass through a second pass
    again = layers.quantize_weights(got)
    assert again["layers"][0]["attn"]["wq"] is got["layers"][0]["attn"]["wq"]
    bad = _port_params(jparams)
    bad["layers"][1]["ffn"]["w_up"][0, 0] = float("nan")
    with pytest.raises(ValueError, match="NaN/Inf"):
        layers.quantize_weights(bad)


def test_quantize_weights_keeps_the_expert_rule():
    """Under a dict holding a "router", 3-D expert stacks keep the GEMM
    orientation; its "shared" subtree and 2-D weights do not."""
    rng = np.random.default_rng(4)
    tree = {"router": rng.standard_normal((16, 4)).astype(np.float32),
            "w_gate": rng.standard_normal((4, 16, 32)).astype(np.float32),
            "w_down": rng.standard_normal((4, 32, 16)).astype(np.float32),
            "shared": {"w_up": rng.standard_normal((16, 32)).astype(np.float32)},
            "wo": rng.standard_normal((16, 16)).astype(np.float32)}
    want = jlayers.quantize_weights(jax.tree.map(jnp.asarray, {"moe": tree}))["moe"]
    got = layers.quantize_weights(
        {"moe": {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                     else torch.from_numpy(v)) for k, v in tree.items()}})["moe"]
    assert not quant.is_quantized(got["router"])
    for path in (("w_gate",), ("w_down",), ("shared", "w_up"), ("wo",)):
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        assert g.transposed == w.transposed and g.block == tuple(w.block), path
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
    assert not got["w_gate"].transposed and got["shared"]["w_up"].transposed


def test_from_jax_params_carries_packed_leaves():
    jparams = _jax_params()
    got = _port_params(jlayers.quantize_weights(jparams))
    want = layers.quantize_weights(_port_params(jparams))
    for lg, lw in zip(got["layers"], want["layers"]):
        for grp in ("attn", "ffn"):
            for key, leaf in lw[grp].items():
                g = lg[grp][key]
                assert type(g) is type(leaf)
                if quant.is_quantized(leaf):
                    assert (g.block, g.transposed) == (leaf.block, leaf.transposed)
                    assert torch.equal(g.values, leaf.values)
                    assert torch.equal(g.scales, leaf.scales)
                else:
                    assert torch.equal(g, leaf)


ROUTES = [((4, 1, 48), True, "bgemv"), ((2, 5, 48), True, "bgemm"), ((5, 48), True, "gemm"),
          ((4, 1, 48), False, "bgemv")]


@pytest.mark.parametrize("shape,transposed,kernel", ROUTES)
def test_packed_matmul_fused_routes_like_the_reference(monkeypatch, shape, transposed, kernel):
    """Decode-shaped inputs one bgemv (a packed weight not stored
    output-major is dequantized to x's dtype first, blas.py:561-562), other
    3-D inputs one bgemm, 2-D inputs one gemm; each matches
    repro.core.blas.matmul_fused under the pallas backend."""
    seen = []
    for name in ("gemm", "bgemv", "bgemm"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **k: seen.append(
            (_n, quant.is_quantized(a[1] if _n != "bgemv" else a[0]))) or _r(*a, **k))
    rng = np.random.default_rng(len(shape))
    spec = _spec((16, None), transposed)
    wj, wt = _packed_pair(rng.standard_normal((48, 24)) * 48 ** -0.5, spec)
    w2j, w2t = _packed_pair(rng.standard_normal((48, 24)) * 48 ** -0.5, spec)
    xj, xt = _pair(rng.standard_normal(shape), "float32")
    rj, rt = _pair(rng.standard_normal(shape[:-1] + (24,)), "float32")
    with jblas.use_backend("pallas"):
        want = jblas.matmul_fused(xj, wj, w2=w2j, residual=rj, activation="silu")
    got = blas.matmul_fused(xt, wt, w2=w2t, residual=rt, activation="silu")
    assert seen == [(kernel, transposed)]
    _close(got, want, "float32")


def test_packed_blas_routines_refuse_transposes():
    qn = quant.quantize(torch.randn(6, 8))
    qt = quant.quantize(torch.randn(8, 6), quant.QuantSpec(transpose=True))
    a = torch.randn(4, 6)
    with pytest.raises(ValueError, match="stored"):
        blas.gemv(qn, torch.randn(6), trans=True)
    with pytest.raises(ValueError, match="stored"):
        blas.gemv(qt, torch.randn(6))
    with pytest.raises(ValueError, match="stored layout"):
        blas.gemm(a, qn, transpose_b=True)
    with pytest.raises(ValueError, match="stored layout"):
        blas.batched_gemm(a[None], qn, transpose_a=True)
    torch.testing.assert_close(blas.gemv(qn, torch.ones(8), alpha=2.0),
                               2.0 * (qn.dequantize() @ torch.ones(8)))
    torch.testing.assert_close(blas.batched_gemv(qt, torch.ones(3, 8), trans=True),
                               (torch.ones(3, 8) @ qt.dequantize()))


def _prompts(plens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=(pl,), dtype=np.int32) for pl in plens]


@pytest.mark.parametrize("plens,gen_lens,seed", [
    ([8] * 5, [3, 7, 4, 6, 5], 0),        # mixed budgets, slot reuse at batch 2
    ([8, 14, 5, 11], [6, 10, 4, 8], 11),  # ragged prompts: one prefill per length
])
def test_int8_serve_matches_jax_serve(plens, gen_lens, seed):
    """The cells of test_serve_matches_jax_serve with --quantize int8: the
    port packs the converted weights itself and must give JAX's tokens."""
    prompts = _prompts(plens, get_config(ARCH, "smoke").vocab, seed)
    want = jax_serve(ARCH, "smoke", batch=2, gen_lens=gen_lens, eos=-1, verbose=False,
                     prompts=prompts, quantize="int8", backend="ref")
    got = serve(ARCH, "smoke", batch=2, gen_lens=gen_lens, eos=-1, verbose=False,
                prompts=prompts, params=_port_params(_jax_params()), quantize="int8",
                device="cpu")
    assert got["outputs"] == want["outputs"]
    assert got["completed"] == len(prompts)
    for key in ("tokens", "prefills", "decode_steps"):
        assert got[key] == want[key], key
