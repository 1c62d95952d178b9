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

A block-scaled int8 `core.quant.QuantizedTensor` weight (bgemv's `a`,
gemm/bgemm's `b`, gemv's `a`) takes the packed kernels: bgemv and gemv the
row-dot `csrc/qgemv.cu` over the stored rows, gemm and bgemm gemm.cu's
int8-B variant in the "nk" layout if the weight is stored transposed, else
"kn".  Outputs are in the activation's dtype, summed and dequantized in
max(f32, dtype); the two operands of a dual GEMM must share one spec.
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_SERVE_DTYPES = (torch.float32, torch.bfloat16)
_BLAS_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_ACTS = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
_HEAD_DIMS = (16, 32, 64, 128)
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
    """Kernel launches since the last reset; gemm_int8 counts the int8-B
    variant reached from gemm and from bgemm."""
    return {"bgemv": _bgemv.launches, "bgemm": _bgemm.launches,
            "attention": _attention.launches, "gemm": _gemm.launches,
            "gemv": _gemv.launches, "blas1_reduce": _blas1.reduce_launches,
            "blas1_axpy": _blas1.axpy_launches, "bgemv_int8": _bgemv.launches_int8,
            "gemv_int8": _gemv.launches_int8,
            "gemm_int8": _gemm.launches_int8 + _bgemm.launches_int8}


def reset_launch_counts() -> None:
    _bgemv.launches = _bgemm.launches = _attention.launches = 0
    _gemm.launches = _gemv.launches = 0
    _blas1.reduce_launches = _blas1.axpy_launches = 0
    _bgemv.launches_int8 = _gemv.launches_int8 = 0
    _gemm.launches_int8 = _bgemm.launches_int8 = 0


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
          transpose_a=True):
    """epilogue(a^T x[b] [, a2^T x[b]]) -> (batch, m) with a (n, m) broadcast
    across the batch, streamed in its stored layout; x (batch, n), bias
    (m,), residual (batch, m).  Only the transpose_a form is ported (the one
    the decode path uses)."""
    if _quant.is_quantized(a):
        return _bgemv_int8(a, x, a2, bias, residual, activation, transpose_a)
    if not transpose_a:
        raise NotImplementedError("bgemv: only transpose_a=True (the decode "
                                  "projection form) is ported")
    if a.ndim != 2 or x.ndim != 2 or a.shape[0] != x.shape[1]:
        raise ValueError(f"bgemv shape mismatch: {tuple(a.shape)} @ {tuple(x.shape)}")
    n, m = a.shape
    _check_shape("bgemv", "a2", a2, a.shape)
    _check_shape("bgemv", "bias", bias, (m,))
    _check_shape("bgemv", "residual", residual, (x.shape[0], m))
    _check("bgemv", x, a=a, a2=a2, bias=bias, residual=residual)
    act = _act_code(activation)
    if not _use_kernel(x):
        return _bgemv.reference(a, x, w2=a2, bias=bias, residual=residual,
                                activation=activation)
    out = torch.empty((x.shape[0], m), dtype=x.dtype, device=x.device)
    return _bgemv.launch(a, x, out, w2=a2, bias=bias, residual=residual,
                         act_code=act, dtype_code=_DTYPE_CODES[x.dtype])


def _bgemv_int8(a, x, a2, bias, residual, activation, transpose_a):
    """Packed bgemv: a's stored layout already encodes the op (transposed
    storage = transpose_a), so every output is a dot over a stored row."""
    if transpose_a != a.transposed:
        raise ValueError("quantized bgemv streams the stored layout; quantize with "
                         f"transpose={transpose_a} to request op=A^T={transpose_a}")
    if a.values.ndim != 2:
        raise NotImplementedError("bgemv: only a broadcast 2-D packed weight is ported "
                                  "(ROADMAP §2 item 1: batched A)")
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


def bgemm(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """epilogue(a (batch, m, k) @ b (k, n) [, a @ b2]) -> (batch, m, n); b
    broadcasts across the batch, bias (n,), residual (batch, m, n).  A packed
    b (and b2) runs the int8-B kernel."""
    if _quant.is_quantized(b) and b.ndim != 2:
        raise NotImplementedError("bgemm: only a broadcast 2-D packed B is ported "
                                  "(ROADMAP §2 item 3: batched B)")
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


def flash_attention(q, k, v, *, kv_lens, kv_groups=1):
    """Causal attention of q (B, Tq, H, D) over the cache layout k/v
    (B, S, H // kv_groups, D) -> (B, Tq, H, D).  kv_lens (B*H,) int32 is
    each (slot, head) row's real KV length (pos + Tq on the cached paths);
    keys at or past it are masked and their V rows zeroed."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants 4-D cache-layout operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] * kv_groups != h:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} with kv_groups={kv_groups}")
    _check_shape("flash_attention", "kv_lens", kv_lens, (b * h,))
    if kv_lens.dtype != torch.int32 or kv_lens.device != q.device:
        raise TypeError("flash_attention: kv_lens must be int32 on q's device")
    _check("flash_attention", q, k=k, v=v)
    if not kv_lens.is_contiguous():
        raise ValueError("flash_attention: kv_lens must be contiguous")
    if not _use_kernel(q):
        return _attention.reference(q, k, v, kv_lens)
    if d not in _HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel: head dim {d} not in {_HEAD_DIMS}")
    out = torch.empty_like(q)
    return _attention.launch(q, k, v, kv_lens, out, dtype_code=_DTYPE_CODES[q.dtype])


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
