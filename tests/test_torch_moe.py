"""The port's MoE family against the JAX package's, on the CPU.

`repro_torch.models.moe` (`_capacity`, `_route`, `moe_einsum`,
`moe_gather`, `moe_layer`), `core.blas.batched_gemm` with a per-expert B
(the batched launch's plain version), `models.convert.from_jax_params` on
MoE trees, and the moonshot-v1-16b-a3b and grok-1-314b SMOKE models'
logits and greedy serves.  The JAX side runs `repro.core.blas` under
`use_backend("pallas")` (Pallas interpret mode), f64 inside
`jax.enable_x64(True)`; serves run JAX serve's default backend (the f32
smoke models: the same sums), and `backend="ref"` with `--quantize int8`
(exact W8A16, as tests/test_torch_quant.py).

Tolerances: f32 rtol = atol = 1e-5 (summation order), bf16 1.6e-2 (one
output rounding step), f64 1e-10.  Router indices and capacity are held
exactly.  Dropping is exercised: at capacity factor 1.25 the reference
drops assignments on these inputs (asserted), at 16 it drops none.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import blas as jblas
from repro.core import quant as jquant
from repro.launch.serve import serve as jax_serve
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import blas, quant
from repro_torch.kernels import gemm, ops
from repro_torch.launch.serve import serve
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.registry import get_config

ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
       "float64": dict(rtol=1e-10, atol=1e-10), "float16": dict(rtol=1.6e-2, atol=1.6e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64,
         "float16": torch.float16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64,
       "float16": jnp.float16}
NO_EOS = -1


@contextlib.contextmanager
def precision(dtype):
    """f64 operands or outputs need JAX's 64-bit mode."""
    if "float64" in dtype:
        with jax.enable_x64(True):
            yield
    else:
        yield


def _close(got, want, dtype):
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want).astype(np.float64),
                               **TOL[dtype])


def _mcfgs(arch, capacity_factor=None):
    """The SMOKE MoE config of `arch` in both packages, with the capacity
    factor replaced if given."""
    jm, tm = jax_config(arch, "smoke").moe, get_config(arch, "smoke").moe
    if capacity_factor is not None:
        jm = dataclasses.replace(jm, capacity_factor=capacity_factor)
        tm = dataclasses.replace(tm, capacity_factor=capacity_factor)
    return jm, tm


def _moe_params(arch, dispatch="einsum", seed=0):
    """(JAX params, port params) of one SMOKE MoE layer from the reference's
    init_moe; router and expert stacks f32."""
    cfg = jax_config(arch, "smoke")
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe, cfg.act, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(lambda a: to_tensor(a, "cpu"), tree)
    return jax.tree.map(jnp.asarray, tree), tp


def _x(arch, b=2, t=32, seed=5):
    """Tokens sharing one direction, so the router favours a few experts
    (capacity drops at factor 1.25; the smoke routers are random)."""
    d = get_config(arch, "smoke").d_model
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)) + 1.5 * rng.standard_normal(d)).astype(np.float32)


def _drops(top_i, mcfg, c):
    """Assignments the reference's capacity drops: per batch row and expert,
    those past the first c."""
    top_i = np.asarray(top_i)
    counts = np.stack([(top_i == e).reshape(top_i.shape[0], -1).sum(1)
                       for e in range(mcfg.num_experts)], axis=1)
    return int(np.clip(counts - c, 0, None).sum())


# --------------------------------------------------------------------------
# the layer's pieces
# --------------------------------------------------------------------------

def test_moe_config_mirrors_the_reference():
    fields = {f.name: f.default for f in dataclasses.fields(MoEConfig)}
    assert fields == {f.name: f.default for f in dataclasses.fields(JMoEConfig)}
    for arch in ARCHS:
        for variant in ("full", "smoke"):
            jc, tc = jax_config(arch, variant), get_config(arch, variant)
            assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
            for f in dataclasses.fields(tc):
                if hasattr(jc, f.name) and f.name != "moe":
                    assert getattr(tc, f.name) == getattr(jc, f.name), (arch, f.name)


@pytest.mark.parametrize("t", [1, 9, 32, 128, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_the_reference(arch, t):
    for variant in ("full", "smoke"):
        assert moe._capacity(t, get_config(arch, variant).moe) == jmoe._capacity(
            t, jax_config(arch, variant).moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_the_reference(arch):
    """Renormalised top-k weights (f32), their expert indices exactly, and the
    Switch aux loss."""
    jp, tp = _moe_params(arch)
    jm, tm = _mcfgs(arch)
    x = _x(arch)
    jw, ji, jaux = jmoe._route(jp, jnp.asarray(x), jm)
    tw, ti, taux = moe._route(tp, torch.from_numpy(x), tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, "float32")
    _close(taux, jaux, "float32")


# (dispatch, capacity factor, drops expected)
DISPATCH_CASES = [("einsum", 1.25, True), ("einsum", 16.0, False), ("gather", 1.25, True),
                  ("gather", 16.0, False)]


@pytest.mark.parametrize("dispatch,cf,dropping", DISPATCH_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_the_reference(arch, dispatch, cf, dropping):
    """moe_einsum / moe_gather on the same routed tokens: y and the aux loss
    as the reference's, with and without capacity drops; the port's gather
    equals its einsum at equal capacity."""
    jp, tp = _moe_params(arch)
    jm, tm = _mcfgs(arch, cf)
    x = _x(arch)
    _, ji, _ = jmoe._route(jp, jnp.asarray(x), jm)
    drops = _drops(ji, jm, jmoe._capacity(x.shape[1], jm))
    assert (drops > 0) == dropping, drops
    jfn = jmoe.moe_gather if dispatch == "gather" else jmoe.moe_einsum
    tfn = moe.moe_gather if dispatch == "gather" else moe.moe_einsum
    with jblas.use_backend("pallas"):
        jy, jaux = jfn(jp, jnp.asarray(x), jm, "swiglu")
    ty, taux = tfn(tp, torch.from_numpy(x), tm, "swiglu")
    _close(ty, jy, "float32")
    _close(taux, jaux, "float32")
    other, _ = (moe.moe_einsum if dispatch == "gather" else moe.moe_gather)(
        tp, torch.from_numpy(x), tm, "swiglu")
    _close(other, ty.numpy(), "float32")


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_the_reference(arch, dispatch):
    """The routed experts plus (moonshot) the shared experts, at decode (T =
    1) and prefill shapes."""
    jp, tp = _moe_params(arch)
    jm, tm = _mcfgs(arch)
    jm, tm = (dataclasses.replace(m, dispatch=dispatch) for m in (jm, tm))
    for t in (1, 24):
        x = _x(arch, b=3, t=t, seed=t)
        with jblas.use_backend("pallas"):
            jy, jaux = jmoe.moe_layer(jp, jnp.asarray(x), jm, "swiglu")
        ty, taux = moe.moe_layer(tp, torch.from_numpy(x), tm, "swiglu")
        _close(ty, jy, "float32")
        _close(taux, jaux, "float32")


def test_expert_ffn_bf16_matches_pallas():
    """The two batched launches in bf16 on one dispatch buffer: the gate
    half written in bf16, the down projection in f32 then cast to bf16."""
    cfg = jax_config(ARCHS[0], "smoke")
    jp = jmoe.init_moe(jax.random.PRNGKey(2), cfg.d_model, cfg.moe, cfg.act, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(lambda a: to_tensor(a, "cpu"), tree)
    h = np.random.default_rng(1).standard_normal(
        (cfg.moe.num_experts, 2, 8, cfg.d_model)).astype(np.float32)
    hj = jnp.asarray(h, jnp.bfloat16)
    with jblas.use_backend("pallas"):
        want = jmoe._expert_ffn(hj, jax.tree.map(jnp.asarray, tree), "swiglu")
    got = moe._expert_ffn(to_tensor(np.asarray(hj), "cpu"), tp, "swiglu")
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want), "bfloat16")


def test_init_moe_mirrors_the_reference_tree():
    """Seeded random params: the reference's leaves, shapes and dtypes (the
    router f32), std as the reference's distributions."""
    cfg = get_config(ARCHS[0], "smoke")
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jax_config(ARCHS[0], "smoke")))
    p = tf.init_params(cfg, 1, "cpu")
    jffn = shapes["layers"]["ffn"]
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(p["layers"][0]["ffn"][key].shape) == jffn[key].shape[1:]
        assert p["layers"][0]["ffn"][key].dtype == TORCH[str(jffn[key].dtype)]
    for key, leaf in jffn["shared"].items():
        assert tuple(p["layers"][1]["ffn"]["shared"][key].shape) == leaf.shape[1:]
    w = p["layers"][0]["ffn"]["w_down"]
    assert w.std().item() == pytest.approx(cfg.moe.d_ff_expert ** -0.5, rel=0.1)


# --------------------------------------------------------------------------
# batched_gemm with a per-expert B: the batched launch's plain version
# --------------------------------------------------------------------------

E, M, K, N = 3, 7, 37, 29
EPILOGUES = [(None, False, False, False), (None, True, False, False),
             ("silu", False, True, False), (None, False, False, True),
             ("gelu", True, False, True), ("relu", True, True, True)]
# (operand dtype, out_dtype): None and each dtype the batched launch writes
OUT_CASES = [(dt, out) for dt in ("float32", "bfloat16", "float64")
             for out in (None, "float32", "bfloat16", "float64", "float16")]


def _batched_operands(dtype, act, bias, gate, res, shared=False):
    rng = np.random.default_rng(11)
    lead = () if shared else (E,)
    arrays = {"A": rng.standard_normal((E, M, K)),
              "B": rng.standard_normal(lead + (K, N)) * K ** -0.5,
              "B2": rng.standard_normal(lead + (K, N)) * K ** -0.5 if gate else None,
              "bias": rng.standard_normal((N,)) if bias else None,
              "residual": rng.standard_normal((E, M, N)) if res else None}
    js = {k: None if v is None else jnp.asarray(v, JAX[dtype]) for k, v in arrays.items()}
    ts = {k: None if v is None else to_tensor(np.asarray(js[k]), "cpu") for k, v in arrays.items()}
    return js, ts


@pytest.mark.parametrize("dtype,out", OUT_CASES)
@pytest.mark.parametrize("act,bias,gate,res", EPILOGUES)
def test_batched_gemm_per_expert_b_matches_pallas(dtype, out, act, bias, gate, res):
    with precision(dtype + str(out)):
        js, ts = _batched_operands(dtype, act, bias, gate, res)
        with jblas.use_backend("pallas"):
            want = jblas.batched_gemm(js["A"], js["B"], B2=js["B2"], bias=js["bias"],
                                      residual=js["residual"], epilogue=act,
                                      out_dtype=out and JAX[out])
        got = blas.batched_gemm(ts["A"], ts["B"], B2=ts["B2"], bias=ts["bias"],
                                residual=ts["residual"], epilogue=act,
                                out_dtype=out and TORCH[out])
        assert str(want.dtype) == (out or dtype)
        want = np.asarray(want)
    assert got.dtype == TORCH[out or dtype]
    # the coarser of the operands' and the output's tolerance
    tol = max((dtype, out or dtype), key=lambda d: TOL[d]["rtol"])
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_batched_gemm_alpha_beta_and_transposes(dtype):
    """alpha/beta/C after the kernel in the output dtype, and transposed
    per-expert operands, as the reference."""
    with precision(dtype):
        js, ts = _batched_operands(dtype, None, False, False, True)
        tj = lambda a: jnp.swapaxes(a, -2, -1)  # noqa: E731
        tt = lambda a: a.transpose(-2, -1).contiguous()  # noqa: E731
        with jblas.use_backend("pallas"):
            want = jblas.batched_gemm(tj(js["A"]), tj(js["B"]), js["residual"], alpha=-1.5,
                                      beta=0.5, transpose_a=True, transpose_b=True)
        got = blas.batched_gemm(tt(ts["A"]), tt(ts["B"]), ts["residual"], alpha=-1.5, beta=0.5,
                                transpose_a=True, transpose_b=True)
        want = np.asarray(want)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("k,n,block_m,block_n,std", [(48, 40, 16, None, 1.0),
                                                     (128, 48, 64, None, 128 ** -0.5),
                                                     (128, 48, 64, 16, 128 ** -0.5)])
def test_packed_per_expert_b_matches_pallas(dtype, transpose, gate, k, n, block_m, block_n,
                                            std):
    """Packed expert stacks with per-expert block scales ("kn", the expert
    rule of quantize_weights, and "nk"), out in A's dtype and in f32: small
    blocks, and the expert rule's block_m = 64 (the tensor-core route's
    k-step scales) with one scale across N and with scales that vary along
    N, at a model's weight scale (std k ** -0.5, as _batched_operands)."""
    rng = np.random.default_rng(3)
    spec = dict(block_m=block_m, block_n=block_n)
    wb = (rng.standard_normal((E, k, n)) * std).astype(np.float32)
    wb2 = (rng.standard_normal((E, k, n)) * std).astype(np.float32)
    a = rng.standard_normal((E, M, k))
    with precision(dtype):
        jq = [jquant.quantize(jnp.asarray(w), jquant.QuantSpec(transpose=transpose, **spec))
              for w in (wb, wb2)]
        tq = [quant.quantize(torch.from_numpy(w), quant.QuantSpec(transpose=transpose, **spec))
              for w in (wb, wb2)]
        ja, ta = jnp.asarray(a, JAX[dtype]), to_tensor(np.asarray(jnp.asarray(a, JAX[dtype])), "cpu")
        for out in (None, "float32"):
            kw = dict(epilogue="silu") if gate else {}
            with jblas.use_backend("pallas"):
                want = jblas.batched_gemm(ja, jq[0], B2=jq[1] if gate else None,
                                          out_dtype=out and JAX[out], **kw)
            got = blas.batched_gemm(ta, tq[0], B2=tq[1] if gate else None,
                                    out_dtype=out and TORCH[out], **kw)
            assert got.dtype == TORCH[out or dtype]
            tol = max((dtype, out or dtype), key=lambda d: TOL[d]["rtol"])
            _close(got, np.asarray(want), tol)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("act,bias,gate,res", [(None, False, False, False),
                                               ("gelu", True, False, True),
                                               ("silu", True, True, True)])
@pytest.mark.parametrize("k,n,block_m,block_n", [(128, 48, 64, None), (96, 64, 32, 16)])
def test_packed_f32_kn_stacks_match_the_pallas_bgemm(shared, act, bias, gate, res, k, n,
                                                     block_m, block_n):
    """f32 A against packed "kn" stacks (a stack a member, or one shared)
    with f32 out and the epilogue: the port's batched plain path
    (`reference_batched_int8`, what the f32 ring computes in another order)
    and, for a per-member stack, each member through `reference_int8`,
    against `repro.kernels.bgemm.bgemm` itself in interpret mode, fed the
    same int8 values and scales."""
    from repro.core.epilogue import Epilogue as JEpilogue
    from repro.kernels.bgemm import bgemm as pallas_bgemm
    from repro_torch.kernels import bgemm as tbgemm
    rng = np.random.default_rng(k + n + block_m)
    lead = () if shared else (E,)
    spec = dict(block_m=block_m, block_n=block_n)
    ws = [(rng.standard_normal(lead + (k, n)) * k ** -0.5).astype(np.float32) for _ in range(2)]
    tq = [quant.quantize(torch.from_numpy(w), quant.QuantSpec(**spec)) for w in ws]
    a = rng.standard_normal((E, M, k)).astype(np.float32)
    bias_v = rng.standard_normal(n).astype(np.float32) if bias else None
    res_v = rng.standard_normal((E, M, n)).astype(np.float32) if res else None
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = pallas_bgemm(
        jnp.asarray(a), j(tq[0].values.numpy()), b2=j(tq[1].values.numpy()) if gate else None,
        bias=None if bias_v is None else jnp.asarray(bias_v)[None], residual=j(res_v),
        epilogue=JEpilogue(act, bias, gate, res), scales=j(tq[0].scales.numpy()),
        b2_scales=j(tq[1].scales.numpy()) if gate else None, q_block=tq[0].block,
        b_layout="kn", block_m=8, block_n=16, block_k=32, out_dtype=jnp.float32,
        interpret=True)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    kw = dict(qb2=tq[1] if gate else None, bias=t(bias_v), residual=t(res_v), activation=act)
    got = tbgemm.reference_batched_int8(torch.from_numpy(a), tq[0], out_dtype=torch.float32,
                                        **kw)
    _close(got, want, "float32")
    if not shared:
        for z in range(E):
            member = [quant.QuantizedTensor(q.values[z], q.scales[z], q.block) for q in tq]
            one = gemm.reference_int8(torch.from_numpy(a[z]), member[0],
                                      qb2=member[1] if gate else None, bias=t(bias_v),
                                      residual=None if res_v is None else t(res_v[z]),
                                      activation=act)
            _close(one, np.asarray(want)[z], "float32")


def test_batched_wrapper_checks_its_operands():
    a, b = torch.randn(3, 4, 8), torch.randn(3, 8, 5)
    with pytest.raises(ValueError, match="shape"):
        ops.bgemm(a, torch.randn(2, 8, 5))
    with pytest.raises(ValueError, match="b2"):
        ops.bgemm(a, b, b2=torch.randn(8, 5))
    with pytest.raises(TypeError, match="out_dtype"):
        ops.bgemm(a, b, out_dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        ops.bgemm(a, b.double())


BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
EXPERT_KN = ("kn", (64, 1408))  # quantize_weights' expert rule at N = 1408
# (batch, m, k, n, dtype, out, gate, packed layout and block, route, tile,
# stage): moonshot FULL's expert launches at decode (M = 32) and prefill (M
# = 64), dense and packed, the f32 smoke's, the BLAS cases of chip_smoke,
# and what stays on the CUDA-core tile
BATCHED_PLANS = [
    (64, 32, 2048, 1408, BF16, BF16, True, None, "wgmma", (64, 64), False),
    (64, 32, 1408, 2048, BF16, F32, False, None, "wgmma", (64, 64), False),
    (64, 64, 2048, 1408, BF16, BF16, True, None, "wgmma", (64, 64), False),
    (64, 64, 1408, 2048, BF16, F32, False, None, "wgmma", (64, 64), False),
    (4, 300, 2048, 2048, BF16, None, False, None, "wgmma", (128, 64), False),
    (2, 130, 512, 512, BF16, None, True, None, "wgmma", (64, 64), False),
    (16, 2047, 2047, 2048, BF16, None, False, None, "wgmma", (128, 64), True),
    # f32 and f64 on the kernels of their 2-D counterparts
    (8, 16, 64, 96, F32, F32, True, None, "ffma_sm90", (32, 64), False),
    (64, 32, 1408, 2048, F32, F32, False, None, "ffma_sm90", (32, 64), False),
    (64, 64, 1408, 2048, F32, F32, False, None, "ffma_sm90", (64, 64), False),
    (16, 2048, 2048, 2048, F32, None, False, None, "ffma_sm90", (128, 128), False),
    (8, 16, 96, 64, F64, None, False, None, "dmma", (64, 64), False),
    (64, 32, 1408, 2048, F64, F64, False, None, "dmma", (64, 64), False),
    (16, 2048, 2048, 2048, F64, None, False, None, "dmma", (128, 128), False),
    (4, 70, 95, 63, F64, None, True, None, "dmma", (64, 64), False),
    # f32 TMA cannot address in place: the ring on staged operands (K or N
    # odd, or even but not multiples of 4)
    (8, 16, 66, 96, F32, F32, False, None, "ffma_sm90", (32, 64), True),
    (8, 16, 64, 98, F32, F32, True, None, "ffma_sm90", (32, 64), True),
    (64, 32, 1407, 2048, F32, F32, False, None, "ffma_sm90", (32, 64), True),
    (16, 2047, 2047, 2048, F32, None, False, None, "ffma_sm90", (128, 128), True),
    # packed stacks under f32 A whose int8 rows TMA can address: the ring,
    # dequantized in its staging
    (64, 32, 2048, 1408, F32, F32, True, EXPERT_KN, "ffma_sm90", (32, 64), False),
    (64, 32, 1408, 2048, F32, F32, False, ("kn", (64, 2048)), "ffma_sm90", (32, 64), False),
    (64, 32, 2048, 1408, F32, F32, False, ("nk", (64, 2048)), "ffma_sm90", (32, 64), False),
    # packed stacks under f64 A, every layout: DMMA, 16-byte copies, the
    # operands staged where the int8 rows are not a multiple of 16 bytes or K
    # is odd
    (64, 32, 2048, 1408, F64, F64, False, EXPERT_KN, "dmma", (64, 64), False),
    (64, 32, 1408, 2048, F64, F64, True, ("kn", (64, 2048)), "dmma", (64, 64), False),
    (64, 32, 2048, 1408, F64, F64, False, ("nk", (64, 2048)), "dmma", (64, 64), False),
    (16, 2048, 2048, 2048, F64, F64, False, ("nk-kblocks", (64, 64)), "dmma", (128, 128),
     False),
    (8, 16, 96, 72, F64, F64, True, ("kn", (32, 72)), "dmma", (64, 64), True),
    (8, 16, 100, 64, F64, F64, False, ("nk", (64, 100)), "dmma", (64, 64), True),
    (4, 70, 95, 63, F64, F64, False, ("kn", (19, 63)), "dmma", (64, 64), True),
    # odd K bf16: A staged
    (64, 32, 2047, 1408, BF16, None, False, None, "wgmma", (64, 64), True),
    (64, 32, 1407, 2048, BF16, F32, False, None, "wgmma", (64, 64), True),
    # packed "kn" expert stacks of bf16 A: scaled each k-step
    (64, 32, 2048, 1408, BF16, BF16, True, EXPERT_KN, "wgmma", (64, 64), False),
    (64, 32, 1408, 2048, BF16, F32, False, ("kn", (64, 2048)), "wgmma", (64, 64), False),
    (64, 64, 1408, 2048, BF16, F32, False, ("kn", (128, 64)), "wgmma", (64, 64), False),
    # what stays on the CUDA-core tile
    (64, 32, 2048, 1400, F32, F32, True, ("kn", (64, 1400)), "ffma", (128, 64), False),
    (64, 32, 2040, 1408, F32, F32, False, ("nk", (64, 2040)), "ffma", (128, 128), False),
    (64, 32, 1440, 1408, BF16, BF16, False, ("kn", (48, 1408)), "ffma", (128, 128), False),
    (64, 32, 2048, 1400, BF16, BF16, False, ("kn", (64, 1400)), "ffma", (128, 128), False),
    (64, 32, 2048, 1408, BF16, BF16, False, ("nk", (64, 2048)), "ffma", (128, 128), False),
    (64, 32, 2048, 1408, BF16, torch.float16, False, None, "ffma", (128, 128), False),
    (64, 32, 2048, 1404, BF16, BF16, False, None, "ffma", (128, 128), False),
    (8, 16, 0, 96, F32, F32, True, None, "ffma", (128, 64), False),
    (8, 16, 96, 64, F64, F32, False, None, "ffma", (128, 128), False),
    (8, 16, 64, 96, F32, BF16, False, None, "ffma", (128, 128), False),
    (4, 8, 0, 16, BF16, None, False, None, "ffma", (128, 128), False),
]


@pytest.mark.parametrize("batch,m,k,n,dtype,out,gate,packed,route,tile,stage", BATCHED_PLANS)
def test_plan_batched_routes(batch, m, k, n, dtype, out, gate, packed, route, tile, stage):
    """Each form's route, tile and staging; the copy width (dense f64: 16 or
    8; packed f64: 16); and where an operand starts off 16 bytes: A staged
    on "wgmma" (the packed form's int8 B refused there), on the f32 ring
    (dense B) and on packed "dmma" (A or B, on the same tile), 8-byte
    copies on dense "dmma", the CUDA-core tile for packed f32."""
    layout, block = packed or (None, None)
    kw = dict(gate=gate, packed_layout=layout, block=block)
    p = gemm.plan_batched(batch, m, k, n, dtype, out, **kw)
    assert (p.route, p.tile, p.splits, p.stage) == (route, tile, 1, stage)
    even = k % 2 == 0 and n % 2 == 0
    assert p.copy == ((16 if even or packed else 8) if route == "dmma" else 0)
    off_a = gemm.plan_batched(batch, m, k, n, dtype, out, a_aligned=False, **kw)
    off_b = gemm.plan_batched(batch, m, k, n, dtype, out, b_aligned=False, **kw)
    if route == "wgmma":
        assert (off_a.route, off_a.stage) == ("wgmma", True)
        assert (off_b.route, off_b.stage) == (("ffma", False) if packed else ("wgmma", True))
    elif route == "dmma" and packed:  # A or B off 16 bytes: staged, on the same tile
        assert (off_a.route, off_a.copy, off_a.stage) == (off_b.route, off_b.copy, off_b.stage) \
            == ("dmma", 16, True)
        assert off_a.tile == off_b.tile == p.tile
    elif route == "dmma":
        assert (off_a.route, off_a.copy, off_b.route, off_b.copy) == ("dmma", 8, "dmma", 8)
    elif route == "ffma_sm90" and not packed:
        assert (off_a.route, off_a.stage) == (off_b.route, off_b.stage) == ("ffma_sm90", True)
    else:
        assert off_a.route == off_b.route == "ffma" and not off_a.stage


# --------------------------------------------------------------------------
# params, logits and serves of the two configs
# --------------------------------------------------------------------------

def _tree(arch, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(seed),
                                                    jax_config(arch, "smoke")))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_the_moe_leaves(arch, packed):
    """The f32 router and the (L, E, d, f) expert stacks sliced per layer,
    packed (per-expert scales sliced in lockstep) or not."""
    tree = _tree(arch)
    dense = from_jax_params(tree, get_config(arch, "smoke"), device="cpu")
    if packed:
        tree = jax.tree.map(np.asarray, jlayers.quantize_weights(jax.tree.map(jnp.asarray, tree)))
    tp = from_jax_params(tree, get_config(arch, "smoke"), device="cpu")
    jffn = tree["layers"]["ffn"]
    for i, layer in enumerate(tp["layers"]):
        ffn = layer["ffn"]
        assert ffn["router"].dtype == torch.float32
        np.testing.assert_array_equal(ffn["router"].numpy(), jffn["router"][i])
        for key in ("w_gate", "w_up", "w_down"):
            got, want = ffn[key], jffn[key]
            if packed:
                assert quant.is_quantized(got) and not got.transposed
                assert got.block == tuple(want.block)
                np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values)[i])
                np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales)[i])
                assert got.values.ndim == 3 and got.scales.shape[0] == got.values.shape[0]
            else:
                np.testing.assert_array_equal(got.numpy(), want[i])
        if "shared" in jffn:
            w = ffn["shared"]["w_down"]
            assert quant.is_quantized(w) == packed and (not packed or w.transposed)
        if packed:  # the port's own pass packs what the reference's packed
            mine = moe.quantize_weights(dense["layers"][i]["ffn"])
            for key in ("w_gate", "w_up", "w_down"):
                assert torch.equal(mine[key].values, ffn[key].values)
                assert torch.equal(mine[key].scales, ffn[key].scales)
            assert torch.equal(mine["router"], ffn["router"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill a ragged batch into per-slot rows and decode three steps:
    logits as the reference's under the pallas backend."""
    jcfg, cfg = jax_config(arch, "smoke"), get_config(arch, "smoke")
    tree = _tree(arch, seed=1)
    jp, tp = jax.tree.map(jnp.asarray, tree), from_jax_params(tree, cfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, cfg.vocab, size=(2, 9), dtype=np.int32)
    with jblas.use_backend("pallas"):
        jl, jmini = jtf.prefill(jp, {"tokens": jnp.asarray(tokens)}, jtf.init_cache(jcfg, 2, 16),
                                jcfg)
    tl, tmini = tf.prefill(tp, torch.from_numpy(tokens), tf.init_cache(cfg, 2, 16, device="cpu"),
                           cfg)
    _close(tl, jl, "float32")
    slots = np.array([1, 0], np.int32)
    jc = jtf.insert_slots_cache(jtf.init_cache(jcfg, 2, 16, per_slot=True), jmini,
                                jnp.asarray(slots))
    tc = tf.insert_slots_cache(tf.init_cache(cfg, 2, 16, per_slot=True, device="cpu"), tmini,
                               slots)
    jc = {**jc, "pos": jnp.asarray([9, 6], jnp.int32)}
    tc["pos"] = torch.tensor([9, 6], dtype=torch.int32)
    for _ in range(3):
        tok = rng.integers(3, cfg.vocab, size=(2, 1), dtype=np.int32)
        with jblas.use_backend("pallas"):
            jl, jc = jtf.decode_step(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = tf.decode_step(tp, torch.from_numpy(tok), tc, cfg)
        _close(tl, jl, "float32")


def _prompts(plens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 512, size=(pl,), dtype=np.int32) for pl in plens]


# (serve keywords): both schedulers, the paged cache (a pool that
# preempts), the int8 KV cache, int8 weights
SERVES = [dict(), dict(scheduler="batch"), dict(kv_page_size=4),
          dict(kv_page_size=4, pool_pages=7), dict(kv_cache="int8"),
          dict(quantize="int8")]


@pytest.mark.parametrize("kw", SERVES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())
                         or "continuous")
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_serve(arch, kw):
    """Greedy tokens and counters of the f32 smoke serve as JAX serve's (the
    batch scheduler takes one prompt length)."""
    prompts = _prompts([8] * 4 if kw.get("scheduler") == "batch" else [8, 14, 8, 11], 7)
    gen_lens = [6, 10, 4, 8]
    backend = "ref" if kw.get("quantize") == "int8" else "xla"
    want = jax_serve(arch, "smoke", batch=2, gen_lens=gen_lens, eos=NO_EOS, verbose=False,
                     prompts=prompts, backend=backend, **kw)
    got = serve(arch, "smoke", batch=2, gen_lens=gen_lens, eos=NO_EOS, verbose=False,
                prompts=prompts, params=from_jax_params(_tree(arch), get_config(arch, "smoke"),
                                                        device="cpu"),
                device="cpu", **kw)
    assert got["outputs"] == want["outputs"]
    assert got["completed"] == len(prompts)
    for key in ("tokens", "prefills", "decode_steps", "preemptions"):
        assert got[key] == want[key], key
