"""Kernel entry points: validate, then launch the CUDA kernel or, for CPU
tensors, run its plain version.

Mirrors `repro/kernels/ops.py` (`bgemv`, `bgemm`, `flash_attention`, and the
BLAS kernels `gemm`, `gemv`, `dot`, `nrm2`, `axpy`).  Every wrapper checks
shapes, dtypes (each wrapper's own set, all operands alike), devices and
contiguity and raises on what the kernel does not take.  The serving
kernels take float32 and bfloat16; the BLAS kernels also take float64.  A
CUDA tensor goes to the kernel; a failed build or launch raises.  Nothing
falls back: the plain version runs on the card only inside
`reference_mode()`, which comparisons (chip_smoke.py, tests) enter
explicitly.

`bgemv` takes the reference's whole dense contract: op = A or A^T
(`transpose_a`, default False as in the reference) over a broadcast 2-D A
or a per-member 3-D one, in f32, bf16 and f64.

A block-scaled int8 `core.quant.QuantizedTensor` weight (bgemv's `a`,
gemm/bgemm's `b`, gemv's `a`) takes the packed kernels: bgemv and gemv the
row-dot `csrc/qgemv.cu` over the stored rows, gemm and bgemm the int8-B
routes `kernels/gemm.py::plan` names (the tensor cores for bf16 "nk" and
"kn" with a scale block of whole k-steps, the f32 ring for f32
activations, the f64 tensor cores for f64 ones, gemm.cu's int8-B variant
for the rest), in the "nk" layout if the weight is stored transposed, else
"kn".  Outputs are in the activation's dtype, summed and dequantized in
max(f32, dtype); the two operands of a dual GEMM must share one spec.

`bgemm` also takes a per-member B (batch, k, n), dense or packed with
per-member block scales (the MoE expert stacks), and an `out_dtype`: one
batched launch (`kernels/bgemm.py::launch_batched`) whose kernel writes
the result in that dtype.

`flash_attention` takes the cache layout or the flat (BH, T, D) one, with
or without per-row kv lengths, int8 K/V with per-(token, head) f32 scales, a
page table over a page pool and the causal, prefix-LM or non-causal mask: a
CUDA tensor goes to the kernel of the route `kernels.attention.plan` names
("splitkv" for decode, "mma" for a bf16 prefill, "ffma" for an f32 one) in
every form and mask, a CPU tensor to its plain version.

`rwkv6` is the chunked WKV6 recurrence (`csrc/rwkv6.cu`) and `mamba2_ssd`
the chunked Mamba2 SSD (`csrc/mamba2.cu`), each with the model's contract:
an optional f32 initial state in, the final state out.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core import quant as _quant
from repro_torch.kernels import attention as _attention
from repro_torch.kernels import bgemm as _bgemm
from repro_torch.kernels import bgemv as _bgemv
from repro_torch.kernels import blas1 as _blas1
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemv as _gemv
from repro_torch.kernels import mamba2 as _mamba2
from repro_torch.kernels import rwkv6 as _rwkv6

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2, torch.float16: 3}
_SERVE_DTYPES = (torch.float32, torch.bfloat16)
_BLAS_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
#: what the batched launch writes: the accumulator rounded once to any of these
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float64, torch.float16)
_ACTS = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
_state = threading.local()


@contextlib.contextmanager
def reference_mode():
    """Send CUDA tensors to the plain PyTorch versions inside this block —
    for comparing a kernel with its plain version on the card only."""
    old = getattr(_state, "reference", False)
    _state.reference = True
    try:
        yield
    finally:
        _state.reference = old


def launch_counts() -> dict:
    """Kernel launches since the last reset; bgemv counts every dense bgemv
    launch and bgemv_broadcast_t / bgemv_broadcast_n / bgemv_batched_t /
    bgemv_batched_n split them by form (op = A^T or A, over a broadcast A
    or one A a member; the decode projections are broadcast_t);
    bgemv_members counts the batched ones that ran the short-member body
    (csrc/bgemv_members.cu) among them; gemm_int8
    counts the int8-B variant reached from gemm and from bgemm.  attention counts the dense
    cache in the model dtype, attention_paged every launch through a page
    table and attention_int8 every launch with int8 K/V (a paged int8
    launch counts in both).  gemm_wgmma / gemm_dmma / gemm_ffma_sm90 /
    gemm_ffma split every launch of `gemm` (dense and int8) by the route its
    plan named (the bf16 tensor-core kernel, the f64 one, the f32 CUDA-core
    one on a TMA ring, or the first CUDA-core one), bgemm_wgmma /
    bgemm_dmma / bgemm_ffma_sm90 / bgemm_ffma every launch of `bgemm`
    (whose f32 and bf16 operands never take "dmma": the key is there for
    the same dict shape).  gemm_wgmma_staged / gemm_ffma_sm90_staged /
    gemm_dmma_copy8 (and bgemm_...) count the dense launches among those
    that took the route's form for rows off 16 bytes: operands copied to
    padded rows first, and 8-byte copies; gemm_ffma_sm90_odd (and bgemm_)
    those on "ffma_sm90" that wrote C one element a store (the ODD
    instantiations: N % 4 != 0 or C off 16 bytes).  bgemm_batched counts bgemm's batched launches (a
    per-member B, or an out_dtype given: the MoE experts), apart from
    bgemm, and bgemm_batched_wgmma / bgemm_batched_dmma /
    bgemm_batched_ffma_sm90 / bgemm_batched_ffma split them by the route
    `gemm.plan_batched` named; bgemm_batched_staged counts the "wgmma" ones
    whose operands were copied into rows TMA can address first, and
    bgemm_batched_int8 the packed ones (any route)."""
    return {"bgemv": _bgemv.launches, "bgemm": _bgemm.launches,
            "attention": _attention.launches, "attention_paged": _attention.launches_paged,
            "attention_int8": _attention.launches_int8, "gemm": _gemm.launches,
            "gemv": _gemv.launches, "blas1_reduce": _blas1.reduce_launches,
            "blas1_axpy": _blas1.axpy_launches, "bgemv_int8": _bgemv.launches_int8,
            **{f"bgemv_{form}": n for form, n in _bgemv.launches_by_form.items()},
            "bgemv_members": _bgemv.launches_members,
            "gemv_int8": _gemv.launches_int8,
            "gemm_int8": _gemm.launches_int8 + _bgemm.launches_int8,
            "rwkv6": _rwkv6.launches, "mamba2_ssd": _mamba2.launches,
            "bgemm_batched": sum(_bgemm.launches_batched.values()),
            "bgemm_batched_int8": _bgemm.launches_batched_int8,
            "bgemm_batched_staged": _bgemm.launches_batched_staged,
            **{f"bgemm_batched_{key}": n for key, n in _bgemm.launches_batched.items()},
            **{f"{name}_{key}": n for name, mod in (("gemm", _gemm), ("bgemm", _bgemm))
               for key, n in (*mod.launches_by_route.items(), *mod.launches_by_form.items())}}


def attention_masks() -> dict:
    """Attention launches since the last reset by route and by the mask they
    ran under ("causal", "prefix" (prefix-LM), "noncausal"), keyed
    "route/mask" ("mma/noncausal").  Beside attention_routes()."""
    return {f"{r}/{m}": n for (r, m), n in _attention.launches_by_route_mask.items()}


def attention_layouts() -> dict:
    """Attention launches since the last reset by route and by the layout
    of their operands ("cache" (B, Tq, H, D) or "flat" (BH, Tq, D)), keyed
    "route/layout" ("mma/flat").  Beside attention_routes()."""
    return {f"{r}/{lay}": n for (r, lay), n in _attention.launches_by_route_layout.items()}


def attention_routes() -> dict:
    """Attention launches since the last reset by the route their plan
    named (`kernels.attention.plan`): "splitkv", "mma" and "ffma".  Beside
    launch_counts(), whose attention keys count by form."""
    return {r: sum(_attention.launches_by_route_mask[r, m] for m in _attention.MASKS)
            for r in _attention.ROUTES}


def reset_launch_counts() -> None:
    _bgemv.launches = _bgemm.launches = _attention.launches = 0
    _bgemv.launches_by_form.update(dict.fromkeys(_bgemv.FORMS, 0))
    _bgemv.launches_members = 0
    _attention.launches_paged = _attention.launches_int8 = 0
    _gemm.launches = _gemv.launches = 0
    _blas1.reduce_launches = _blas1.axpy_launches = 0
    _bgemv.launches_int8 = _gemv.launches_int8 = 0
    _gemm.launches_int8 = _bgemm.launches_int8 = 0
    _rwkv6.launches = _mamba2.launches = 0
    _bgemm.launches_batched.update(wgmma=0, dmma=0, ffma_sm90=0, ffma=0)
    _bgemm.launches_batched_int8 = _bgemm.launches_batched_staged = 0
    for mod in (_gemm, _bgemm):
        mod.launches_by_route.update(wgmma=0, dmma=0, ffma_sm90=0, ffma=0)
        mod.launches_by_form.update(wgmma_staged=0, dmma_copy8=0, ffma_sm90_staged=0,
                                    ffma_sm90_odd=0)
    _attention.launches_by_route_mask.update(dict.fromkeys(_attention.launches_by_route_mask, 0))
    _attention.launches_by_route_layout.update(
        dict.fromkeys(_attention.launches_by_route_layout, 0))


def _use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel.  False: the plain version (a CPU
    tensor, or a CUDA tensor inside reference_mode).  Other devices raise."""
    if t.device.type == "cuda":
        return not getattr(_state, "reference", False)
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check(name: str, main: torch.Tensor, dtypes=_SERVE_DTYPES, **operands) -> None:
    if main.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[1] for d in dtypes)
        raise TypeError(f"{name}: dtype must be {names}, got {main.dtype}")
    for key, t in operands.items():
        if t is None:
            continue
        if t.dtype != main.dtype:
            raise TypeError(f"{name}: {key} dtype {t.dtype} != {main.dtype}")
        if t.device != main.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {main.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not main.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")


def _check_shape(name: str, what: str, t, shape) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} shape {tuple(t.shape)} != {tuple(shape)}")


def _check_packed(name: str, qa, qa2, main: torch.Tensor) -> None:
    """A packed weight (and its dual-GEMM partner) the kernels can stream:
    int8 values and f32 scales of the block grid, contiguous, on main's
    device; the partner shares the spec."""
    if qa2 is not None and (not _quant.is_quantized(qa2) or qa2.block != qa.block
                            or qa2.transposed != qa.transposed
                            or qa2.stored_shape != qa.stored_shape):
        raise ValueError(f"{name}: dual-GEMM operands must share one quantization spec")
    for key, q in (("weight", qa), ("gate weight", qa2)):
        if q is None:
            continue
        v, sc = q.values, q.scales
        (m, n), (qm, qn) = v.shape[-2:], q.block
        if v.dtype != torch.int8 or sc.dtype != torch.float32:
            raise TypeError(f"{name}: packed {key} must be int8 values with float32 "
                            f"scales, got {v.dtype} and {sc.dtype}")
        if m % qm or n % qn or tuple(sc.shape) != tuple(v.shape[:-2]) + (m // qm, n // qn):
            raise ValueError(f"{name}: packed {key} scales {tuple(sc.shape)} do not tile "
                             f"values {tuple(v.shape)} in blocks {q.block}")
        for t in (v, sc):
            if t.device != main.device:
                raise ValueError(f"{name}: packed {key} on {t.device}, expected {main.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: packed {key} must be contiguous")


def _act_code(activation) -> int:
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(a for a in _ACTS if a)} "
                         f"or None, got {activation!r}")
    return _ACTS[activation]


def bgemv(a, x, *, a2=None, bias=None, residual=None, activation=None,
          transpose_a=False):
    """epilogue(op(a[b]) x[b] [, op(a2[b]) x[b]]) -> (batch, m), as the
    reference's `ops.bgemv`: a is ((batch,) m, n), or ((batch,) n, m) under
    transpose_a (op = A^T, a streamed in its stored layout: the decode
    projection x @ W); a 2-D a is broadcast across the batch.  x (batch,
    n), bias (m,), residual (batch, m); f32, bf16 and f64.  One launch:
    csrc/bgemv.cu for op = A^T, csrc/bgemv_rows.cu for op = A."""
    if _quant.is_quantized(a):
        return _bgemv_int8(a, x, a2, bias, residual, activation, transpose_a)
    if a.ndim not in (2, 3) or x.ndim != 2:
        raise ValueError(f"bgemv shape mismatch: {tuple(a.shape)} @ {tuple(x.shape)}")
    if transpose_a:
        n, m = a.shape[-2:]
    else:
        m, n = a.shape[-2:]
    if x.shape[1] != n or (a.ndim == 3 and a.shape[0] != x.shape[0]):
        raise ValueError(f"bgemv shape mismatch: {tuple(a.shape)} @ {tuple(x.shape)}")
    _check_shape("bgemv", "a2", a2, a.shape)
    _check_shape("bgemv", "bias", bias, (m,))
    _check_shape("bgemv", "residual", residual, (x.shape[0], m))
    _check("bgemv", x, _BLAS_DTYPES, a=a, a2=a2, bias=bias, residual=residual)
    act = _act_code(activation)
    if not _use_kernel(x):
        return _bgemv.reference(a, x, w2=a2, bias=bias, residual=residual,
                                activation=activation, transpose_a=transpose_a)
    out = torch.empty((x.shape[0], m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out  # an empty grid: nothing to launch
    return _bgemv.launch(a, x, out, w2=a2, bias=bias, residual=residual, act_code=act,
                         dtype_code=_DTYPE_CODES[x.dtype], transpose_a=transpose_a)


def _bgemv_int8(a, x, a2, bias, residual, activation, transpose_a):
    """Packed bgemv: a's stored layout already encodes the op (transposed
    storage = transpose_a), so every output is a dot over a stored row."""
    if transpose_a != a.transposed:
        raise ValueError("quantized bgemv streams the stored layout; quantize with "
                         f"transpose={transpose_a} to request op=A^T={transpose_a}")
    if a.values.ndim != 2:
        raise ValueError("bgemv: a packed A is a broadcast 2-D weight; the reference's "
                         "packed bgemv refuses a batched one too")
    m, n = a.values.shape  # stored (outputs, contraction)
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"bgemv shape mismatch: packed {a.shape} @ {tuple(x.shape)}")
    _check_shape("bgemv", "bias", bias, (m,))
    _check_shape("bgemv", "residual", residual, (x.shape[0], m))
    _check("bgemv", x, _BLAS_DTYPES, bias=bias, residual=residual)
    _check_packed("bgemv", a, a2, x)
    act = _act_code(activation)
    if not _use_kernel(x):
        return _bgemv.reference_int8(a, x, qw2=a2, bias=bias, residual=residual,
                                     activation=activation)
    out = torch.empty((x.shape[0], m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    return _bgemv.launch_int8(a, x, out, qw2=a2, bias=bias, residual=residual, act_code=act,
                              dtype_code=_DTYPE_CODES[x.dtype])


def bgemm(a, b, *, b2=None, bias=None, residual=None, activation=None, out_dtype=None):
    """epilogue(a (batch, m, k) @ b [, a @ b2]) -> (batch, m, n); bias (n,),
    residual (batch, m, n).  b is (k, n), broadcast across the batch, or
    (batch, k, n), one per member; a packed b (and b2) runs the int8-B
    kernels.  A 2-D b without `out_dtype` runs one GEMM over the batch * m
    rows (f32 and bf16); a 3-D b, or any `out_dtype` given, runs the
    batched launch (f32, bf16 and f64 operands), whose kernel writes the
    result in out_dtype (f32, bf16, f64 or f16; None: a's dtype)."""
    if b.ndim == 3 or out_dtype is not None:
        return _bgemm_batched(a, b, b2, bias, residual, activation, out_dtype)
    if a.ndim != 3 or b.ndim != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"bgemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    batch, m, _ = a.shape
    n = b.shape[1]
    _check_shape("bgemm", "b2", b2, b.shape)
    _check_shape("bgemm", "bias", bias, (n,))
    _check_shape("bgemm", "residual", residual, (batch, m, n))
    act = _act_code(activation)
    if _quant.is_quantized(b):
        _check("bgemm", a, bias=bias, residual=residual)
        _check_packed("bgemm", b, b2, a)
        if not _use_kernel(a):
            return _bgemm.reference_int8(a, b, qb2=b2, bias=bias, residual=residual,
                                         activation=activation)
        out = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
        if out.numel() == 0:
            return out
        return _bgemm.launch_int8(a, b, out, qb2=b2, bias=bias, residual=residual,
                                  act_code=act, dtype_code=_DTYPE_CODES[a.dtype])
    _check("bgemm", a, b=b, b2=b2, bias=bias, residual=residual)
    if not _use_kernel(a):
        return _bgemm.reference(a, b, b2=b2, bias=bias, residual=residual,
                                activation=activation)
    out = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    return _bgemm.launch(a, b, out, b2=b2, bias=bias, residual=residual,
                         act_code=act, dtype_code=_DTYPE_CODES[a.dtype])


def _bgemm_batched(a, b, b2, bias, residual, activation, out_dtype):
    """bgemm's batched launch: a per-member or shared B, dense or packed,
    any output dtype."""
    name = "bgemm"
    if a.ndim != 3 or b.ndim not in (2, 3) or a.shape[2] != b.shape[-2] or (
            b.ndim == 3 and b.shape[0] != a.shape[0]):
        raise ValueError(f"bgemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT_DTYPES:
        names = ", ".join(str(d).split(".")[1] for d in _OUT_DTYPES)
        raise TypeError(f"{name}: out_dtype must be one of {names}, got {out_dtype}")
    batch, m, _ = a.shape
    n = b.shape[-1]
    _check_shape(name, "b2", b2, b.shape)
    _check_shape(name, "bias", bias, (n,))
    _check_shape(name, "residual", residual, (batch, m, n))
    act = _act_code(activation)
    packed = _quant.is_quantized(b)
    if packed:
        _check(name, a, _BLAS_DTYPES, bias=bias, residual=residual)
        _check_packed(name, b, b2, a)
    else:
        _check(name, a, _BLAS_DTYPES, b=b, b2=b2, bias=bias, residual=residual)
    if not _use_kernel(a):
        ref = _bgemm.reference_batched_int8 if packed else _bgemm.reference_batched
        kw = {"qb2": b2} if packed else {"b2": b2}
        return ref(a, b, bias=bias, residual=residual, activation=activation,
                   out_dtype=out_dtype, **kw)
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out  # an empty grid: nothing to launch
    return _bgemm.launch_batched(a, b, out, b2=b2, bias=bias, residual=residual, act_code=act,
                                 dtype_code=_DTYPE_CODES[a.dtype],
                                 out_code=_DTYPE_CODES[out_dtype])


def _check_side(name: str, what: str, t, dtype, device) -> None:
    """An int32 or f32 side operand of the kernel: dtype, device, contiguity."""
    if t.dtype != dtype or t.device != device:
        raise TypeError(f"{name}: {what} must be {str(dtype).split('.')[1]} on {device}, "
                        f"got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def flash_attention(q, k, v, *, kv_lens=None, kv_groups=1, k_scales=None, v_scales=None,
                    page_table=None, causal=True, prefix_len=None):
    """Attention of q (B, Tq, H, D) over the cache layout k/v
    (B, S, H // kv_groups, D) -> (B, Tq, H, D), or of flat q (BH, Tq, D)
    over k/v (BH // kv_groups, S, D) -> (BH, Tq, D) (query row r reads KV
    row r // kv_groups).  kv_lens (rows,) int32, rows = B*H or BH, is each
    row's real KV length (pos + Tq on the cached paths); keys at or past it
    are masked and their V rows zeroed; None: every row sees all S keys.
    Query t sits at absolute position t + kvl - Tq: causal=True masks the
    keys after it, except the first prefix_len (prefix-LM: visible to every
    query); causal=False sees every key below kvl and ignores prefix_len.

    page_table (B, max_pages) int32 (cache layout only, as the
    reference): k/v are the page pool (num_pages, P, H // kv_groups, D) and
    slot b's logical key s lives at pool[page_table[b, s // P], s % P].
    int8 k/v need both k_scales and v_scales, f32 in k's layout with D -> 1;
    otherwise k/v are q's dtype.

    A CUDA tensor runs the kernel of the route `kernels.attention.plan`
    names from the shapes alone: "splitkv" at Tq = 1, "mma" (tensor cores,
    P rounded to bf16) for a bf16 query block, "ffma" for an f32 one; flat
    operands stream as they sit (`kernels.attention.cache_view`).
    q, k and v start on 16-byte boundaries (the kernels' 16-byte loads and
    cp.async copies)."""
    name = "flash_attention"
    if not isinstance(causal, bool):
        raise TypeError(f"{name}: causal must be a bool, got {causal!r}")
    if prefix_len is not None and (not isinstance(prefix_len, int) or prefix_len < 0):
        raise ValueError(f"{name}: prefix_len must be None or an int >= 0, got {prefix_len!r}")
    if not isinstance(kv_groups, int) or kv_groups < 1:
        raise ValueError(f"{name}: kv_groups must be an int >= 1, got {kv_groups!r}")
    flat = q.ndim == 3
    if q.ndim not in (3, 4) or k.ndim != q.ndim or k.shape != v.shape:
        raise ValueError(f"{name} wants flat (BH, T, D) or 4-D cache-layout operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if flat:
        if page_table is not None:
            raise ValueError(f"{name}: page_table requires the (B, Tq, H, D) q layout")
        rows, _, d = q.shape
        if k.shape[0] * kv_groups != rows or k.shape[2] != d:
            raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                             f"{tuple(q.shape)} with kv_groups={kv_groups}")
    else:
        b, tq, h, d = q.shape
        rows = b * h
        if ((page_table is None and k.shape[0] != b) or k.shape[3] != d
                or k.shape[2] * kv_groups != h):
            raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                             f"{tuple(q.shape)} with kv_groups={kv_groups}")
        if page_table is not None:
            if page_table.ndim != 2 or page_table.shape[0] != b:
                raise ValueError(f"{name}: page_table {tuple(page_table.shape)} is not "
                                 f"(B={b}, max_pages)")
            _check_side(name, "page_table", page_table, torch.int32, q.device)
    if kv_lens is not None:
        _check_shape(name, "kv_lens", kv_lens, (rows,))
        _check_side(name, "kv_lens", kv_lens, torch.int32, q.device)
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: int8 K/V need both k_scales and v_scales")
    if k_scales is not None:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"{name}: k_scales/v_scales come with int8 k/v, got "
                            f"{k.dtype} and {v.dtype}")
        for what, t, vals in (("k_scales", k_scales, k), ("v_scales", v_scales, v)):
            _check_shape(name, what, t, tuple(vals.shape[:-1]) + (1,))
            _check_side(name, what, t, torch.float32, q.device)
            _check_side(name, what[0], vals, torch.int8, q.device)
        _check(name, q)
    else:
        _check(name, q, k=k, v=v)
    for what, t in (("q", q), ("k", k), ("v", v)):  # 16-byte loads and cp.async copies
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte boundary")
    if not _use_kernel(q):
        return _attention.reference(q, k, v, kv_lens, k_scales=k_scales, v_scales=v_scales,
                                    page_table=page_table, causal=causal,
                                    prefix_len=prefix_len, kv_groups=kv_groups)
    out = torch.empty_like(q)
    return _attention.launch(q, k, v, kv_lens, out, dtype_code=_DTYPE_CODES[q.dtype],
                             k_scales=k_scales, v_scales=v_scales, page_table=page_table,
                             causal=causal, prefix_len=prefix_len, kv_groups=kv_groups)


def rwkv6(r, k, v, w_log, u, *, s0=None, chunk: int = 32):
    """Chunked WKV6 over r, k, w_log (BH, T, K), v (BH, T, V), u (BH, K)
    from the state s0 (BH, K, V) (None: zeros) -> (y (BH, T, V) in r's
    dtype, s_fin (BH, K, V) f32).  r/k/v share one dtype (f32 or bf16);
    w_log, u and s0 are f32.  T is cut into chunks of min(chunk, T), the
    last padded with zero rows."""
    name = "rwkv6"
    if r.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{name} wants (BH, T, K) operands, got {tuple(r.shape)}, "
                         f"{tuple(v.shape)}")
    bh, t, kk = r.shape
    vv = v.shape[2]
    if t < 1 or chunk < 1:
        raise ValueError(f"{name}: needs T >= 1 and chunk >= 1, got T={t}, chunk={chunk}")
    _check_shape(name, "k", k, r.shape)
    _check_shape(name, "v", v, (bh, t, vv))
    _check_shape(name, "w_log", w_log, r.shape)
    _check_shape(name, "u", u, (bh, kk))
    _check_shape(name, "s0", s0, (bh, kk, vv))
    _check(name, r, k=k, v=v)
    for what, side in (("w_log", w_log), ("u", u), ("s0", s0)):
        if side is not None:
            _check_side(name, what, side, torch.float32, r.device)
    if not _use_kernel(r):
        return _rwkv6.reference(r, k, v, w_log, u, s0=s0, chunk=chunk)
    if kk > _rwkv6.MAX_HEAD_DIM or vv > _rwkv6.MAX_HEAD_DIM or min(chunk, t) > _rwkv6.MAX_CHUNK:
        raise NotImplementedError(f"{name} kernel: K, V <= {_rwkv6.MAX_HEAD_DIM} and chunk "
                                  f"<= {_rwkv6.MAX_CHUNK}, got K={kk}, V={vv}, chunk={chunk}")
    y = torch.empty((bh, t, vv), dtype=r.dtype, device=r.device)
    s_fin = torch.empty((bh, kk, vv), dtype=torch.float32, device=r.device)
    return _rwkv6.launch(r, k, v, w_log, u, s0, y, s_fin, chunk=chunk,
                         dtype_code=_DTYPE_CODES[r.dtype])


def mamba2_ssd(x, a_log, b, c, *, h0=None, chunk: int = 64):
    """Chunked Mamba2 SSD over x (BH, T, P), a_log (BH, T) (every value <=
    0), b, c (BH, T, N) from the state h0 (BH, N, P) (None: zeros) ->
    (y (BH, T, P) in x's dtype, h_fin (BH, N, P) f32).  x/b/c share one
    dtype (f32 or bf16); a_log and h0 are f32.  T is cut into chunks of
    min(chunk, T), the last padded with rows that leave the state exact."""
    name = "mamba2_ssd"
    if x.ndim != 3 or b.ndim != 3:
        raise ValueError(f"{name} wants (BH, T, P) and (BH, T, N) operands, got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    bh, t, p = x.shape
    n = b.shape[2]
    if t < 1 or chunk < 1:
        raise ValueError(f"{name}: needs T >= 1 and chunk >= 1, got T={t}, chunk={chunk}")
    _check_shape(name, "a_log", a_log, (bh, t))
    _check_shape(name, "b", b, (bh, t, n))
    _check_shape(name, "c", c, (bh, t, n))
    _check_shape(name, "h0", h0, (bh, n, p))
    _check(name, x, b=b, c=c)
    _check_side(name, "a_log", a_log, torch.float32, x.device)
    if h0 is not None:
        _check_side(name, "h0", h0, torch.float32, x.device)
    if not _use_kernel(x):
        return _mamba2.reference(x, a_log, b, c, h0=h0, chunk=chunk)
    if n > _mamba2.MAX_STATE or p > _mamba2.MAX_HEAD_DIM or min(chunk, t) > _mamba2.MAX_CHUNK:
        raise NotImplementedError(
            f"{name} kernel: N <= {_mamba2.MAX_STATE}, P <= {_mamba2.MAX_HEAD_DIM} and "
            f"chunk <= {_mamba2.MAX_CHUNK}, got N={n}, P={p}, chunk={chunk}")
    y = torch.empty((bh, t, p), dtype=x.dtype, device=x.device)
    h_fin = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    return _mamba2.launch(x, a_log, b, c, h0, y, h_fin, chunk=chunk,
                          dtype_code=_DTYPE_CODES[x.dtype])


# --------------------------------------------------------------------------
# BLAS kernels: f32, bf16 and f64
# --------------------------------------------------------------------------

def gemm(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """epilogue(a (m, k) @ b (k, n) [, a @ b2]) -> (m, n) in a's dtype;
    bias (n,), residual (m, n).  A packed b (and b2) runs the int8-B
    kernel; its logical shape is (k, n) in either stored layout."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    m, n = a.shape[0], b.shape[1]
    _check_shape("gemm", "b2", b2, b.shape)
    _check_shape("gemm", "bias", bias, (n,))
    _check_shape("gemm", "residual", residual, (m, n))
    act = _act_code(activation)
    if _quant.is_quantized(b):
        _check("gemm", a, _BLAS_DTYPES, bias=bias, residual=residual)
        _check_packed("gemm", b, b2, a)
        if not _use_kernel(a):
            return _gemm.reference_int8(a, b, qb2=b2, bias=bias, residual=residual,
                                        activation=activation)
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        if out.numel() == 0:
            return out
        return _gemm.launch_int8(a, b, out, qb2=b2, bias=bias, residual=residual,
                                 act_code=act, dtype_code=_DTYPE_CODES[a.dtype])
    _check("gemm", a, _BLAS_DTYPES, b=b, b2=b2, bias=bias, residual=residual)
    if not _use_kernel(a):
        return _gemm.reference(a, b, b2=b2, bias=bias, residual=residual,
                               activation=activation)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out  # an empty grid: nothing to launch
    return _gemm.launch(a, b, out, b2=b2, bias=bias, residual=residual,
                        act_code=act, dtype_code=_DTYPE_CODES[a.dtype])


def gemv(a, x):
    """a (m, n) @ x (n,) -> (m,) in a's dtype.  A packed a (stored (m, n),
    not transposed) runs the packed row-dot kernel; the output is then in
    x's dtype."""
    if a.ndim != 2 or x.ndim != 1 or a.shape[1] != x.shape[0]:
        raise ValueError(f"gemv shape mismatch: {tuple(a.shape)} @ {tuple(x.shape)}")
    if _quant.is_quantized(a):
        if a.transposed:
            raise ValueError("gemv streams A in its stored layout; quantize with "
                             "transpose=False")
        _check("gemv", x, _BLAS_DTYPES)
        _check_packed("gemv", a, None, x)
        if not _use_kernel(x):
            return _gemv.reference_int8(a, x)
        out = torch.empty(a.shape[0], dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        return _gemv.launch_int8(a, x, out, dtype_code=_DTYPE_CODES[x.dtype])
    _check("gemv", a, _BLAS_DTYPES, x=x)
    if not _use_kernel(a):
        return _gemv.reference(a, x)
    out = torch.empty(a.shape[0], dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out  # an empty grid: nothing to launch
    return _gemv.launch(a, x, out, dtype_code=_DTYPE_CODES[a.dtype])


def _check_vectors(name, x, y=None):
    if x.ndim != 1 or (y is not None and y.shape != x.shape):
        raise ValueError(f"{name} wants 1-D operands of one length, got {tuple(x.shape)}"
                         + ("" if y is None else f" and {tuple(y.shape)}"))
    _check(name, x, _BLAS_DTYPES, y=y)


def dot(x, y):
    """x . y -> 0-d tensor in x's dtype, summed in max(f32, dtype)."""
    _check_vectors("dot", x, y)
    if not _use_kernel(x):
        return _blas1.dot_reference(x, y)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    return _blas1.reduce_launch(x, y, out, nrm2=False, dtype_code=_DTYPE_CODES[x.dtype])


def nrm2(x):
    """sqrt(x . x) -> 0-d tensor in x's dtype, summed in max(f32, dtype)."""
    _check_vectors("nrm2", x)
    if not _use_kernel(x):
        return _blas1.nrm2_reference(x)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    return _blas1.reduce_launch(x, None, out, nrm2=True, dtype_code=_DTYPE_CODES[x.dtype])


def axpy(alpha, x, y):
    """alpha * x + y -> (n,) in x's dtype, computed in max(f32, dtype);
    alpha is a host scalar."""
    _check_vectors("axpy", x, y)
    alpha = float(alpha)
    if not _use_kernel(x):
        return _blas1.axpy_reference(alpha, x, y)
    out = torch.empty_like(x)
    return _blas1.axpy_launch(alpha, x, y, out, dtype_code=_DTYPE_CODES[x.dtype])
