"""Broadcast-weight batched GEMM: the prefill projection kernel.

Replaces `repro/kernels/bgemm.py` (`_bgemm_kernel`, Pallas call at :217) in
the broadcast-B "kn" form the prefill path uses: C[b] = epi(A[b] @ B
[, A[b] @ B2]).  With A contiguous this is one GEMM over the batch * M rows,
so it runs `kernels/gemm.py`'s kernels over them, through the route that
`gemm.plan` names: in bf16 (every served prefill projection) the
tensor-core kernel of `csrc/gemm_sm90.cu` (K or N not a multiple of 8, or
an unaligned operand: the same kernel on copies with padded rows), in f32
the CUDA-core kernel on a TMA ring of `csrc/gemm_f32.cu` (K or N not a
multiple of 4, or an unaligned operand: the same kernel on copies with
padded rows); each source note says
what bounds it.  It keeps its own launch counts.

A packed B (`core.quant.QuantizedTensor`, the int8 body of
`_bgemm_kernel`, bgemm.py:80-90, "kn" or the output-major "nk" layout of
`serve --quantize int8`) runs gemm.py's int8-B routes over the same batch
* M rows (`launch_int8`, its own launch count): the serving layout and "kn"
with a scale block of whole k-steps on the tensor cores in bf16, every
layout on the f32 ring (`csrc/gemm_f32_q8.cu`) under f32 A and on the f64
tensor cores (`csrc/gemm_f64_q8.cu`) under f64 A; `reference_int8` is its
plain version.

The batched-B form (`bgemm.py:180-182`: a per-member B (batch, K, N), the
MoE's expert stacks) and any `out_dtype` run `launch_batched`: one launch
over the whole batch through the route `gemm.plan_batched` names, each the
kernel of its 2-D counterpart with a batch coordinate: the tensor-core
kernel of `csrc/gemm_sm90.cu` (bf16, out bf16 or f32: every expert launch
of a bf16 MoE serve, the packed "kn" expert stacks of an int8 one with
per-member scales, and bf16 TMA cannot address in place, staged), the f64
tensor cores of `csrc/gemm_f64.cu` (f64 out; packed stacks
`csrc/gemm_f64_q8.cu`), the f32 ring (f32 out; fed
by TMA, on staged copies where TMA cannot address the rows in place, or
from packed int8 stacks dequantized in its staging) or the CUDA-core tile of
`csrc/gemm_batched*.cu` (the rest: other out dtypes, packed bf16 "nk" or
"kn" the tensor cores cannot take, packed f32 whose int8 rows TMA cannot
address).  The kernel writes the accumulator,
rounded once, in `out_dtype`; its launches count apart
(`launches_batched`, `launches_batched_staged`, `launches_batched_int8`).

`reference`, `reference_int8`, `reference_batched` and
`reference_batched_int8` are the plain PyTorch versions: CPU tensors use
them, and on the card only comparisons (`ops.reference_mode`) do.
"""

from __future__ import annotations

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.quant import dequantize_in, is_quantized
from repro_torch.kernels import gemm as _gemm

#: launches through `launch` in this process (either kernel)
launches = 0
#: launches of the int8-B variant through `launch_int8`
launches_int8 = 0
#: every launch of `launch` and `launch_int8`, by the route its plan named
launches_by_route = {"wgmma": 0, "dmma": 0, "ffma_sm90": 0, "ffma": 0}
#: the launches of `launch` that took a route's form for rows off 16 bytes
#: (`gemm.launches_by_form`)
launches_by_form = {"wgmma_staged": 0, "dmma_copy8": 0, "ffma_sm90_staged": 0,
                    "ffma_sm90_odd": 0}
#: launches through `launch_batched`, by the route `gemm.plan_batched` named
launches_batched = {"wgmma": 0, "dmma": 0, "ffma_sm90": 0, "ffma": 0}
#: the ones among them whose operands were first copied into rows padded to
#: 16 bytes (`gemm.Plan.stage`: "wgmma", "ffma_sm90", packed "dmma")
launches_batched_staged = 0
#: the packed ones among them (any route)
launches_batched_int8 = 0


def reference(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """C = epi(a @ b [, a @ b2]) in f32, cast once to a's dtype."""
    epi = Epilogue(activation, bias is not None, b2 is not None, residual is not None)
    af = a.float()
    acc = af @ b.float()
    acc2 = af @ b2.float() if b2 is not None else None
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(a.dtype)


def launch(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int):
    """One launch over the batch * M rows of a through the kernel
    `gemm.plan` names, counted; operands are validated CUDA tensors
    (kernels/ops.py), `out` is (batch, M, N) and preallocated."""
    global launches
    batch, m, _ = a.shape
    p = _gemm.dense(a, b, out, b2=b2, bias=bias, residual=residual, act_code=act_code,
                    dtype_code=dtype_code, m=batch * m)
    launches += 1
    _gemm.tally(p, launches_by_route, launches_by_form, out)
    return out


def reference_int8(a, qb, *, qb2=None, bias=None, residual=None, activation=None):
    """The int8-B kernel's plain version: B (and B2) dequantized in f32 (the
    accumulator of f32 and bf16 operands) in logical (K, N) orientation,
    then the dense plain version."""
    b2 = None if qb2 is None else dequantize_in(qb2, torch.float32)
    return reference(a, dequantize_in(qb, torch.float32), b2=b2, bias=bias,
                     residual=residual, activation=activation)


def launch_int8(a, qb, out, *, qb2, bias, residual, act_code: int, dtype_code: int):
    """C[b] = epi(A[b] @ deq(B) [, A[b] @ deq(B2)]): one int8-B launch over
    the batch * M rows, counted."""
    global launches_int8
    batch, m, _ = a.shape
    route = _gemm.q8(a, qb, out, qb2=qb2, bias=bias, residual=residual, m=batch * m,
                     act_code=act_code, dtype_code=dtype_code)
    launches_int8 += 1
    launches_by_route[route] += 1
    return out


def reference_batched(a, b, *, b2=None, bias=None, residual=None, activation=None,
                      out_dtype=None):
    """C[z] = epi(a[z] @ b[z] [, a[z] @ b2[z]]) (b 2-D: shared by every
    member), summed in max(f32, a's dtype) (f64 for f64 operands), cast once
    to out_dtype (None: a's dtype)."""
    epi = Epilogue(activation, bias is not None, b2 is not None, residual is not None)
    acc = torch.promote_types(torch.float32, a.dtype)
    af = a.to(acc)
    h = torch.matmul(af, b.to(acc))
    h2 = torch.matmul(af, b2.to(acc)) if b2 is not None else None
    return epi.apply(h, acc2=h2, bias=bias, residual=residual).to(out_dtype or a.dtype)


def reference_batched_int8(a, qb, *, qb2=None, bias=None, residual=None, activation=None,
                           out_dtype=None):
    """The packed batched launch's plain version: each member's B (and B2)
    dequantized in max(f32, a's dtype) in logical (K, N) orientation, then
    `reference_batched`."""
    acc = torch.promote_types(torch.float32, a.dtype)
    b2 = None if qb2 is None else dequantize_in(qb2, acc)
    return reference_batched(a, dequantize_in(qb, acc), b2=b2, bias=bias, residual=residual,
                             activation=activation, out_dtype=out_dtype)


def launch_batched(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int,
                   out_code: int):
    """out[z] = epi(a[z] @ B[z] [, a[z] @ B2[z]]) for every member z in one
    launch, counted by route; b (b2) dense (batch, K, N) or (K, N), or
    packed (`QuantizedTensor`, per-member scales); `out` (batch, M, N) is
    preallocated in the output dtype.  Operands are validated CUDA tensors
    (kernels/ops.py)."""
    global launches_batched_int8, launches_batched_staged
    p = _gemm.batched(a, b, out, b2=b2, bias=bias, residual=residual, act_code=act_code,
                      dtype_code=dtype_code, out_code=out_code)
    launches_batched[p.route] += 1
    launches_batched_staged += int(p.stage)
    launches_batched_int8 += int(is_quantized(b))
    return out
