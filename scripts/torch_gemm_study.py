#!/usr/bin/env python3
"""The measurements behind the GEMM and bgemv plans and gates, on one GPU.

    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py tiles
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py witness [--ffma]
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f64
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py bgemv
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py flush
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f32
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py axpy
    PYTHONPATH=TREE/src:TREE python3 scripts/torch_gemm_study.py axpy
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py host
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py qgemv
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py odd
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py bgemv_rows
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py bgemv_members
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py packed
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f32feed
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f32q8
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f32vec OTHER_TREE
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f64q8
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py f64vs OTHER_TREE

tiles: the tensor-core kernel (csrc/gemm_sm90.cu) at every tile it
instantiates, and at K splits where the tiles leave half the card idle, at
the served prefill shapes (4 x 128 rows) and at 8192^3; each checked against
the plain version, then timed as chip_smoke.py times kernels (cold L2,
median).  `kernels.gemm.plan`'s tile table comes from these times.

witness: chip_smoke.py's end-to-end witness of forced_rwkv and forced_zamba
(the bf16 kernel path's logits no further from the f32 path than the plain
bf16 path's, plus 2% of max |logit|) over several token seeds, the gate's own
seed first.  With --ffma the kernel path is also run with every plan forced
to the CUDA-core kernel (the loop the tensor cores replaced), in this
process only.  One JSON line per seed: each path's distance to the f32 path
per step, and each kernel path's distance to the plain path.

f64: the f64 tensor-core kernel (csrc/gemm_f64.cu) at 8192^3 with each mma
shape it carries (m8n8k4, m16n8k4, m16n8k8, m16n8k16) and with BK = 32 in 3
stages, at 128 x 128, then at every tile of `gemm.DMMA_TILES` and, with the
gate, `DMMA_GATE_TILES`, and on a ragged (4095, 4098) @ (4098, 4094);
beside the CUDA-core kernel (csrc/gemm.cu) and torch.matmul.  The kernel's
default mma shape and k-step and the plan's tile tables come from these.

bgemv: csrc/bgemv.cu at every decode projection shape of stablelm-1.6b,
rwkv6-1.6b and zamba2-1.2b (batch 4, bf16) under K splits from one to one
per 32 rows, each checked against the plain version; beside the plan's
choice and torch.matmul.  `bgemv.BLOCKS_PER_SM` and `MIN_ROWS` come from
these.

flush: the stablelm qkv bgemv and the 2^26 f64 axpy (kernel and library
call) timed after a write flush of L2 and after a read flush (clean lines),
20 launches each, twice in turns; chip_smoke.time_ms's default flush comes
from these.

f32: the f32 CUDA-core kernel on a TMA ring (csrc/gemm_f32.cu) at 8192^3,
zamba2's LoRA merge (2048, 128) @ (128, 2048), an aligned ragged (4095,
4096) @ (4096, 4092), the stablelm prefill's qkv and down at 512 rows and
the f32 smoke serves' prefill shapes, at every
tile of `gemm.FFMA_SM90_TILES` (with the gate, at (512, 2048) @ (2048,
5632), `FFMA_SM90_GATE_TILES`); beside the first CUDA-core kernel
(csrc/gemm.cu) and torch.matmul (TF32 off).  The plan's tile table comes
from these.

axpy: ops.axpy in f64, f32 and bf16 at 2^26 (16-byte loads), 2^26 - 3 (and
an element tail) and 2^26 one element in (element loads), each checked
bitwise against the plain version, beside torch.add(y, x, alpha=alpha).
With TREE (another checkout of the port, e.g. the parent commit unpacked
by `git archive`) first on the path, the same cases run that tree's kernel
and timing helpers: run parent, change, change, parent in one session.

host: the host's time to issue one ops.gemm at zamba2's LoRA merge shape
(2048, 128) @ (128, 2048) in f32 (what a host-bound serve pays for each of
its 18 merges a forward): 100 calls without a sync, median of 7 runs; with
TREE first on the path as for axpy.

qgemv: the packed int8 GEMV (csrc/qgemv.cu) at one block (4 x 128 -> 16:
the time of a launch that moves nearly nothing), at stablelm-1.6b's int8
decode projections (batch 4, bf16 x, the serving spec's one scale a row)
and the BLAS gemv 16384^2 (batch 1, f32 and f64 x) under K splits from one
to 8 on the plan's route (on the tensor cores with 4 and 8 warps a block),
each checked against the plain version; beside the plan's
choice, the dense bgemv on the same weights in bf16 and the first packed
design (scripts/replaced/qgemv_rows4.cu).  `bgemv.INT8_BLOCKS_PER_SM` comes
from these.

odd: the dense forms TMA and 16-byte copies cannot address in place.
The bf16 tensor-core kernel (csrc/gemm_sm90.cu) on staged operands (rows
copied to 16-byte strides by `gemm.tma_rows`, then one launch) at every
tile of `gemm.TC_TILES` (with the gate, `GATE_TILES`) at the BLAS odd
shape (4095, 4097) @ (4097, 4093), (8192, 8191) @ (8191, 8192), the
ragged bgemm rows (508, 2047) @ (2047, 2001) and the gate at (512, 2047)
@ (2047, 5631), and the staging copies alone; the f64 tensor-core kernel
(csrc/gemm_f64.cu) at the odd shape with 8-byte copies and at the even
neighbour (4095, 4098) @ (4098, 4094) with 16- and 8-byte copies, at
every tile of `gemm.DMMA_TILES`; each checked against the plain version,
beside the first CUDA-core kernel (csrc/gemm.cu) and torch.matmul.  The
staged route's cost and the copy widths' come from these.

bgemv_rows: the op = A body of bgemv (csrc/bgemv_rows.cu) at chip_smoke's
batched-GEMV shapes (a broadcast (8192, 8192) against 4 rows of x in bf16,
one (2048, 2048) A a member for 32 members in f64, f32 and bf16, and 4096
members of (32, 32) in f64) with one warp a row taking 1 row and
`bgemv.ROW_BLOCK` rows, and with 2-8 warps a row, each checked against the
plain version; beside the plan's choice and torch.bmm / F.linear on the
same operands; and the broadcast case on variants of the body compiled
from its source (2 loads a row in flight where a warp takes ROW_BLOCK
rows).  `bgemv.ROW_BLOCK` comes from these.

bgemv_members: the short-member body (csrc/bgemv_members.cu) over square
members of 32 to 128 rows in f64, f32 and bf16, both ops, a batch of about
32 MB of A, at 8, 16, 32 and 64 members a block; beside the bodies of a
long member (`bgemv.split_plan`), the first design (`first_bgemv_plan`:
scripts/replaced/bgemv_first.cu for op = A^T) and torch.bmm on the same
operands, each checked against the plain version, and beside variants of
the body compiled from its source (2, 3 or 4 blocks an SM for every
instantiation; 8 chunks a batch; A loads that do not allocate in L1; each
bitwise the body); then one long member
(32 of (2048, 2048), op = A^T, each dtype) on csrc/bgemv.cu's per-member
body at the plan's split and at 2 and 4 splits, beside the first design and
torch.bmm.  `bgemv.MEMBER_MAX_BYTES` and `MEMBERS` come from these.

packed: the tensor-core kernel's packed int8 "kn" form (csrc/gemm_sm90.cu,
`KnLayout`) as the tree builds it and in variants compiled from its source
beside it.  Batched, at moonshot's decode expert shapes (the gate+up dual
launch and the down launch, 64 experts of 32 rows, scales one a 64-row
k-step): the launch bound 1 (blocks an SM as the registers allow, no
`setmaxnreg`), 6 staging stages (shared memory for fewer blocks an SM)
and, without the gate, the registers left as compiled (no `setmaxnreg`),
beside the dense batched launch on the same bf16 weights.  2-D, at 8192^3
(one scale a k-step across N, and one every 16 columns) and at the ragged
(4095, 4096) @ (4096, 2064) with the gate, at every tile of
`gemm.PACKED_TILES` (the gate's `PACKED_GATE_TILES`): the BM = 128 form
with 4 staging stages, with the whole tile's partial a step (not half),
with 3 bf16 stages (not 2), with one converter warpgroup (not two), and
(timing only, output not checked) with no conversion,
beside the dense 2-D launch at the plan's tile and the first CUDA-core
kernel (csrc/gemm.cu).  Each other launch is checked against the plain
version.  `KnLayout`'s blocks, stages, registers and partial and
`gemm.PACKED_TILES` come from these.

f32feed: the dense f32 forms TMA cannot address in place, on the f32 ring
on staged operands (`Plan.stage`: A and B copied into rows padded to 4
floats, C one element a store where N % 4 != 0) at every tile
of `gemm.FFMA_SM90_TILES`, beside the staging copies alone, the first
CUDA-core kernel (csrc/gemm.cu) and torch.matmul (TF32 off); at the BLAS
odd shape (4095, 4097) @ (4097, 4093), the ragged bgemm rows (508, 2047) @
(2047, 2001) and the even (4095, 4098) @ (4098, 4094); each checked
against the plain version.

f32q8: f32 A against packed int8 B on the f32 ring (csrc/gemm_f32_q8.cu)
at 8192^3 in the "kn", "nk" and "nk-kblocks" layouts and at moonshot's
decode expert shapes (64 experts of 32 rows: the down launch and the
gate+up dual launch, "kn" stacks, one scale a 64-row k-step), each checked
against the plain version, beside the same launch on the first design
(csrc/gemm.cu, csrc/gemm_batched.cu), the dense f32 ring on the
dequantized weights and a variant compiled from the source without the
conversion (the ring's time without it; its output is not checked).

f32vec: the f32 TMA ring's launch (`gemm_f32_launch`) built from this
tree's f32 ring sources and from OTHER_TREE's (csrc/gemm_f32*.cu but the
int8 feed; e.g. an earlier design unpacked by `git archive` under
build/), each source compiled by its own nvcc, all at once, timed in turns (other, this, this, other) at 8192^3 and
zamba2's LoRA merge (2048, 128) @ (128, 2048) (C on 16-byte stores), and
at the BLAS odd shape (4095, 4097) @ (4097, 4093) (element stores), each
as the plain product and with +bias gelu +residual, on the plan's tile;
at the odd shape on operands staged once (`gemm.tma_rows`) before the
timing, beside the staging copies alone and torch.matmul, so that the
odd form's time splits into staging, ring and epilogue.  Each output is
checked against the plain version.

f64q8: f64 A against packed int8 B on the f64 tensor cores
(csrc/gemm_f64_q8.cu) at 8192^3 in the "kn" and "nk" layouts, at the BLAS
ragged case (4095, 4097) @ (4097, 4093), block (17, N) (its operands
staged once into rows padded to 16 bytes before the timing, beside the
whole `ops.gemm` call, staging included, and csrc/gemm.cu's int8-B kernel
on the same inputs) and at moonshot's decode down stacks (64 experts of 32
rows, "kn", one scale a 64-row k-step), as the tree builds it and in
variants compiled from its source beside it: two blocks an SM at BM = 64
(less registers a warpgroup), and (timing only) no conversion; each
variant's nvcc log (ptxas's registers and spills) is kept beside its
library under build/study_variants/; each held bitwise against the dense
launch on the dequantized B and timed beside it.  The kernel's order of
conversion and products and its blocks an SM come from these.

f64vs: the dense f64 DMMA launch (`gemm_f64_launch`) built from this
tree's csrc/gemm_f64.cu and from OTHER_TREE's (e.g. a parent commit
unpacked by `git archive` under build/), each by its own nvcc, both at
once, timed in turns (other, this, this, other) at 8192^3, at the BLAS
odd shape (4095, 4097) @ (4097, 4093) (8-byte copies) and at 8192^3 with
+bias gelu +residual, on the plan's tile; each output held against the
plain version and the two trees' products bitwise against each other
where no epilogue runs; ptxas's registers and spills of both builds are
printed.

Needs chip_smoke.py at the repository root (its timing and forced-run
helpers) and a CUDA device.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs


def f64q8():
    from repro_torch.core import quant
    from repro_torch.kernels import _build, gemm, ops
    variants = source_variants("gemm_f64_q8.cu", F64Q8_VARIANTS, "gemm_f64_q8_launch",
                               gemm._F64_Q8_ARGTYPES)
    fns = {"design": _build.function("gemm_f64_q8_launch", gemm._F64_Q8_ARGTYPES), **variants}
    g = torch.Generator(device="cuda").manual_seed(23)
    f64 = torch.float64
    n8 = 8192
    e, m, k, n = 64, 32, 1408, 2048
    cases = [(f"8192^3 {lay}", torch.randn(n8, n8, generator=g, device="cuda", dtype=f64),
              quant.quantize(torch.randn(n8, n8, generator=g, device="cuda") * n8 ** -0.5,
                             quant.QuantSpec(64, None, transpose=lay == "nk")))
             for lay in ("kn", "nk")]
    cases.append(("ragged (4095,4097)@(4097,4093) block (17, N)",
                  torch.randn(4095, 4097, generator=g, device="cuda", dtype=f64),
                  quant.quantize(torch.randn(4097, 4093, generator=g, device="cuda") * 4097 ** -0.5,
                                 quant.QuantSpec(17, None))))
    cases.append((f"decode down ({e},{m},{k})@({e},{k},{n})",
                  torch.randn(e, m, k, generator=g, device="cuda", dtype=f64),
                  quant.quantize(torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5,
                                 quant.QuantSpec(64, None))))
    for label, a, qb in cases:
        batch = a.shape[0] if a.ndim == 3 else 1
        mm, kk = a.shape[-2:]
        nn = qb.shape[-1]
        out = torch.empty(*a.shape[:-1], nn, dtype=f64, device="cuda")
        deq = quant.dequantize_in(qb, f64).contiguous()
        dense = (lambda: ops.gemm(a, deq)) if a.ndim == 2 else (
            lambda: ops.bgemm(a, deq, out_dtype=f64))
        want = dense()
        p = (gemm.plan(mm, kk, nn, f64, packed_layout=gemm.packed_layout(qb), block=qb.block)
             if a.ndim == 2 else gemm.plan_batched(batch, mm, kk, nn, f64, f64,
                                                   packed_layout="kn", block=qb.block))
        (sa, lda), (sv, ldq) = gemm.tma_rows(a, zero_pad=True), gemm.tma_rows(qb.values)

        def launch(fn):
            err = fn(sa.data_ptr(), sv.data_ptr(), qb.scales.data_ptr(), None, None,
                     *qb.block, int(qb.transposed), None, None, out.data_ptr(), batch,
                     int(qb.values.ndim == 3), mm, kk, nn, lda, ldq, 0, *p.tile,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"f64q8: launch failed ({err})")

        us = {}
        for name, fn in fns.items():
            launch(fn)
            torch.cuda.synchronize()
            if not name.startswith("timing only") and not torch.equal(out, want):
                raise AssertionError(f"f64q8: {name} is not the dense launch's bits at {label}")
            us[name] = 1e3 * cs.time_ms(lambda fn=fn: launch(fn), iters=5 if batch == 1 else 20)
        us["dense DMMA on the dequantized B"] = 1e3 * cs.time_ms(dense, iters=5 if batch == 1
                                                                 else 20)
        if p.stage:
            got = ops.gemm(a, qb)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"f64q8: ops.gemm is not the dense launch's bits at {label}")
            us["ops.gemm (staging + kernel)"] = 1e3 * cs.time_ms(lambda: ops.gemm(a, qb), iters=5)
            us["staging copies alone"] = 1e3 * cs.time_ms(
                lambda: (gemm.tma_rows(a, zero_pad=True), gemm.tma_rows(qb.values)), iters=5)
        if a.ndim == 2:
            us["csrc/gemm.cu int8-B kernel"] = 1e3 * cs.time_ms(lambda: cs.ffma_launch(a, qb),
                                                                iters=3)
        print(json.dumps({"case": label, "plan": str(p), "us": us}), flush=True)
        del out, deq, want, sa, sv


def tiles():
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(512, 2048, 2048, False), (512, 2048, 5632, True), (512, 5632, 2048, False),
              (512, 2048, 7168, False), (512, 7168, 2048, False), (512, 2048, 64, False),
              (512, 64, 2048, False), (512, 2048, 8384, False), (512, 4096, 2048, False),
              (512, 2048, 8192, False), (512, 8192, 2048, False), (8192, 8192, 8192, False)]
    for m, k, n, gate in shapes:
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        b = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).bfloat16()
        b2 = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).bfloat16() if gate else None
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.gemm(a, b, b2=b2, activation=act)
        us = {}
        for bm, bn in gemm.GATE_TILES if gate else gemm.TC_TILES:
            n_tiles = -(-m // bm) * -(-n // bn)
            splits = (1, 2, 4, 8, 16) if n_tiles < (1 - gemm.IDLE) * sm_count() else (1,)
            for s in (s for s in splits if s <= -(-k // gemm.BK)):
                p = gemm.Plan("wgmma", (bm, bn), s)

                def call(p=p):
                    return gemm.tc(a, b, out, p, b2=b2, bias=None, residual=None,
                                   act_code=ops._ACTS[act], m=m, k=k, n=n)

                call()
                torch.cuda.synchronize()
                if not torch.allclose(out.float(), want.float(), **cs.TOL[torch.bfloat16]):
                    raise AssertionError(f"tiles: {p} at {(m, k, n)} disagrees with plain")
                us[f"{bm}x{bn}/{s}"] = cs.time_ms(call, iters=5 if m > 4096 else 20) * 1e3
        print(json.dumps({"shape": f"{m}x{k}->{n}" + (" gate" if gate else ""),
                          "plan": str(gemm.plan(m, k, n, torch.bfloat16, gate=gate)),
                          "fastest": min(us, key=us.get), "us": us}), flush=True)


def f64():
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(6)
    for m, k, n, gate in ((8192, 8192, 8192, False), (8192, 8192, 8192, True),
                          (4095, 4098, 4094, False)):
        a = torch.randn(m, k, generator=g, device="cuda", dtype=torch.float64)
        b = torch.randn(k, n, generator=g, device="cuda", dtype=torch.float64) * k ** -0.5
        b2 = (torch.randn(k, n, generator=g, device="cuda", dtype=torch.float64) * k ** -0.5
              if gate else None)
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.gemm(a, b, b2=b2, activation=act)
        out = torch.empty(m, n, dtype=torch.float64, device="cuda")
        ms = {}
        runs = [(f"{bm}x{bn}", (bm, bn), 0)
                for bm, bn in (gemm.DMMA_GATE_TILES if gate else gemm.DMMA_TILES)]
        if not gate and m == 8192:
            runs += [(f"128x128 {name}", (128, 128), code) for code, name in
                     ((1, "m8n8k4"), (2, "m16n8k4"), (3, "m16n8k8"), (4, "m16n8k16"),
                      (5, "BK=32 3 stages"))]
        for label, tile, code in runs:
            def call(tile=tile, code=code):
                return gemm.dmma(a, b, out, gemm.Plan("dmma", tile, copy=16), b2=b2, bias=None,
                                 residual=None, act_code=ops._ACTS[act], m=m, k=k, n=n,
                                 variant=code)

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **cs.TOL[torch.float64]):
                err = (out - want).abs().max().item()
                raise AssertionError(f"f64: {label} at {(m, k, n)} disagrees with plain ({err})")
            ms[label] = cs.time_ms(call, iters=5)
        ms["ffma (csrc/gemm.cu)"] = cs.time_ms(lambda: cs.ffma_launch(a, b, b2=b2,
                                                                      activation=act), iters=5)
        if not gate:
            ms["torch.matmul"] = cs.time_ms(lambda: torch.matmul(a, b), iters=5)
        flops = 2 * m * k * n * (2 if gate else 1)
        print(json.dumps({"shape": f"({m},{k})@({k},{n})" + (" gate" if gate else ""),
                          "plan": str(gemm.plan(m, k, n, torch.float64, gate=gate)),
                          "bound_ms": flops / cs.PEAK_FLOP_S[torch.float64] * 1e3,
                          "ms": ms}), flush=True)
        del a, b, b2, want, out


# the decode projections of the served models at batch 4: (what, K, N, gate)
BGEMV_SHAPES = [("stablelm qkv", 2048, 2048, False), ("stablelm gate+up", 2048, 5632, True),
                ("stablelm down", 5632, 2048, False), ("rwkv lora down", 2048, 64, False),
                ("rwkv lora up", 64, 2048, False), ("rwkv key", 2048, 7168, False),
                ("rwkv value", 7168, 2048, False), ("zamba2 in_proj", 2048, 8384, False),
                ("zamba2 out_proj", 4096, 2048, False), ("zamba2 up", 2048, 8192, False),
                ("zamba2 down", 8192, 2048, False)]


def bgemv_sweep():
    from repro_torch.kernels import bgemv, ops
    g = torch.Generator(device="cuda").manual_seed(7)
    dt = torch.bfloat16
    for what, k, n, gate in BGEMV_SHAPES:
        x = torch.randn(4, k, generator=g, device="cuda").to(dt)
        w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
        w2 = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dt) if gate else None
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.bgemv(w, x, a2=w2, activation=act, transpose_a=True)
        out = torch.empty(4, n, dtype=dt, device="cuda")
        chosen = bgemv.plan(4, k, n, dt, gate=gate)
        plans = {}
        for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64):
            rows = bgemv._cdiv(bgemv._cdiv(k, s), bgemv.ROW_STEP) * bgemv.ROW_STEP
            if rows <= bgemv.MAX_ROWS and s <= bgemv._cdiv(k, bgemv.ROW_STEP):
                plans[bgemv.Plan(chosen.tile, bgemv._cdiv(k, rows), rows)] = True
        us = {}
        for p in plans:
            def call(p=p):
                return bgemv.run(w, x, out, p, w2=w2, bias=None, residual=None,
                                 act_code=ops._ACTS[act], dtype_code=ops._DTYPE_CODES[dt])

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), **cs.TOL[dt]):
                raise AssertionError(f"bgemv: {p} at {what} disagrees with plain")
            us[f"{p.splits}x{p.rows} ({p.blocks(4, n)} blocks)"] = cs.time_ms(call) * 1e3
        lib = (lambda: torch.matmul(x, torch.cat([w, w2], 1))) if gate else (
            lambda: torch.matmul(x, w))
        nb = (w.numel() * (2 if gate else 1) + x.numel() + 4 * n) * 2
        print(json.dumps({"shape": f"{what} 4x{k}->{n}" + (" gate" if gate else ""),
                          "plan": f"{chosen.splits}x{chosen.rows}",
                          "fastest": min(us, key=us.get), "us": us,
                          "matmul_us": cs.time_ms(lib) * 1e3,
                          "bound_us": nb / cs.HBM_BYTES_S * 1e6}), flush=True)


QGEMV_SHAPES = [  # (what, batch, K, N, gate, x dtype)
    ("one block", 4, 128, 16, False, torch.bfloat16),  # the launch's floor
    ("qkv", 4, 2048, 2048, False, torch.bfloat16), ("gate+up", 4, 2048, 5632, True, torch.bfloat16),
    ("down", 4, 5632, 2048, False, torch.bfloat16),
    ("gemv 16384^2 f32", 1, 16384, 16384, False, torch.float32),
    ("gemv 16384^2 f64", 1, 16384, 16384, False, torch.float64)]


BGEMV_ROWS_SHAPES = [  # (what, batch, M, N, dtype, per-member A)
    ("broadcast (8192,8192) x 4", 4, 8192, 8192, torch.bfloat16, False),
    ("per-member (32,2048,2048)", 32, 2048, 2048, torch.float64, True),
    ("per-member (32,2048,2048)", 32, 2048, 2048, torch.float32, True),
    ("per-member (32,2048,2048)", 32, 2048, 2048, torch.bfloat16, True),
    ("per-member (4096,32,32)", 4096, 32, 32, torch.float64, True)]


def bgemv_rows_sweep():
    from repro_torch.kernels import bgemv, ops
    variants = source_variants("bgemv_rows.cu", ROWS_VARIANTS, "bgemv_rows_launch",
                               bgemv._ROWS_ARGTYPES)
    g = torch.Generator(device="cuda").manual_seed(8)
    for what, b, m, n, dt, batched in BGEMV_ROWS_SHAPES:
        a = (torch.randn(*((b,) if batched else ()), m, n, generator=g, device="cuda")
             * n ** -0.5).to(dt)
        x = torch.randn(b, n, generator=g, device="cuda").to(dt)
        with ops.reference_mode():
            want = ops.bgemv(a, x)
        out = torch.empty(b, m, dtype=dt, device="cuda")
        chosen = bgemv.plan(b, n, m, dt, trans=False, batched=batched)
        plans = [bgemv.Plan(0, 1, rows, batched, False, wpr)
                 for wpr, rows in ((1, 1), (1, bgemv.ROW_BLOCK), (2, 1), (4, 1), (8, 1))]
        us = {}
        for p in plans:
            def call(p=p):
                return bgemv.run(a, x, out, p, w2=None, bias=None, residual=None, act_code=0,
                                 dtype_code=ops._DTYPE_CODES[dt])

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.double(), want.double(), **cs.TOL[dt]):
                raise AssertionError(f"bgemv_rows: {p} at {what} {dt} disagrees with plain")
            us[f"wpr={p.wpr} rows={p.rows} ({p.blocks(b, m)} blocks)"] = cs.time_ms(call) * 1e3
        if not batched:  # the body's variants at the broadcast case, the plan's split
            for name, fn in variants.items():
                out = torch.empty(b, m, dtype=dt, device="cuda")

                def call(fn=fn, out=out):
                    with torch.cuda.device(x.device):
                        err = fn(ops._DTYPE_CODES[dt], a.data_ptr(), None, x.data_ptr(), None,
                                 None, out.data_ptr(), b, m, n, 0, chosen.wpr, chosen.rows, 0,
                                 torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"bgemv_rows: variant {name!r} error {err}")

                call()
                torch.cuda.synchronize()
                if not torch.allclose(out.double(), want.double(), **cs.TOL[dt]):
                    raise AssertionError(f"bgemv_rows: variant {name!r} disagrees with plain")
                us[f"{name} (wpr={chosen.wpr} rows={chosen.rows})"] = cs.time_ms(call) * 1e3
        lib = (lambda: torch.bmm(a, x[..., None])) if batched else (lambda: F.linear(x, a))
        nb = (a.numel() + x.numel() + b * m) * a.element_size()
        print(json.dumps({"shape": what, "dtype": str(dt).split(".")[1],
                          "plan": f"wpr={chosen.wpr} rows={chosen.rows}",
                          "fastest": min(us, key=us.get), "us": us,
                          "library_us": cs.time_ms(lib) * 1e3,
                          "bound_us": nb / cs.HBM_BYTES_S * 1e6}), flush=True)
        del a, x, want, out


#: variants of csrc/bgemv_rows.cu and csrc/bgemv_members.cu timed beside
#: them: (old, new) source edits
ROWS_VARIANTS = {"2 loads a row at R > 1": [
    ("constexpr int U = R == 1 ? UNROLL : 1;", "constexpr int U = R == 1 ? UNROLL : 2;")]}
MEMBERS_VARIANTS = {
    "2 blocks an SM": [("constexpr int MIN_BLOCKS = TRANS && !GATE ? 3 : 2;",
                        "constexpr int MIN_BLOCKS = 2;")],
    "3 blocks an SM": [("constexpr int MIN_BLOCKS = TRANS && !GATE ? 3 : 2;",
                        "constexpr int MIN_BLOCKS = 3;")],
    "4 blocks an SM": [("constexpr int MIN_BLOCKS = TRANS && !GATE ? 3 : 2;",
                        "constexpr int MIN_BLOCKS = 4;")],
    "8 chunks a batch": [("constexpr int U = GATE ? 2 : 4;", "constexpr int U = GATE ? 4 : 8;")],
    "A not kept in L1": [("if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));",
                          "if (aligned) {\n        uint4 r;\n        asm volatile(\"ld.global.nc."
                          "L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\" : \"=r\"(r.x), "
                          "\"=r\"(r.y), \"=r\"(r.z), \"=r\"(r.w) : \"l\"(p));\n"
                          "        return r;\n      }")]}


def source_variants(source: str, variants: dict, symbol: str, argtypes: list,
                    units: tuple = ()) -> dict:
    """{name: `symbol` of a library compiled from csrc/`source` with each
    variant's edits (a header: compiled through the csrc sources `units`,
    which include it), built under build/study_variants in parallel with
    each other and with the port's own library (`_build.build`)."""
    import ctypes

    from repro_torch.kernels import _build
    csrc = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    out_dir = Path(__file__).resolve().parents[1] / "build" / "study_variants"
    jobs = {}
    for name, edits in variants.items():
        src = (csrc / source).read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{source}: variant {name!r} does not apply: {old!r}")
            src = src.replace(old, new)
        d = out_dir / (Path(source).stem + "_" + "".join(c if c.isalnum() else "_" for c in name))
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(src)
        for unit in units:  # (their include of `source` finds the edited copy first)
            (d / unit).write_text((csrc / unit).read_text())
        jobs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", "-I", str(csrc), "-o", str(d / "lib.so"),
             *(str(d / u) for u in (units or (source,)))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _build.build()
    fns = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        (path.parent / "nvcc.log").write_text(log)  # ptxas's registers and spills
        if proc.returncode:
            raise RuntimeError(f"{source}: nvcc failed for {name!r}:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def bgemv_members_sweep():
    from repro_torch.kernels import bgemv, ops
    jobs = cs.replaced_build_start()
    variants = source_variants("bgemv_members.cu", MEMBERS_VARIANTS, "bgemv_members_launch",
                               bgemv._MEMBERS_ARGTYPES)
    cs.replaced_build_finish(jobs)
    g = torch.Generator(device="cuda").manual_seed(9)
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        elem = torch.finfo(dt).bits // 8
        for side in (32, 48, 64, 96, 128):
            b = max(64, (32 << 20) // (side * side * elem))
            for trans in (False, True):
                a = (torch.randn(b, side, side, generator=g, device="cuda") * side ** -0.5).to(dt)
                x = torch.randn(b, side, generator=g, device="cuda").to(dt)
                with ops.reference_mode():
                    want = ops.bgemv(a, x, transpose_a=trans)
                plans = {f"members={m}": bgemv.Plan(0, 1, 0, True, trans, members=m)
                         for m in (8, 16, 32, 64)}
                plans["split_plan"] = bgemv.split_plan(b, side, side, dt, trans=trans,
                                                       batched=True)
                us, want_kernel = {}, {}
                for label, p in plans.items():
                    out = torch.empty_like(want)

                    def call(p=p, out=out):
                        return bgemv.run(a, x, out, p, w2=None, bias=None, residual=None,
                                         act_code=0, dtype_code=ops._DTYPE_CODES[dt])

                    call()
                    torch.cuda.synchronize()
                    if not torch.allclose(out.double(), want.double(), **cs.TOL[dt]):
                        raise AssertionError(f"bgemv_members: {label} at {side} {dt} disagrees")
                    if p.members:
                        want_kernel[p.members] = out.clone()
                    us[label] = cs.time_ms(call) * 1e3
                for (name, fn), m in itertools.product(variants.items(), (8, 16)):
                    out = torch.empty_like(want)

                    def call(fn=fn, m=m, out=out):
                        with torch.cuda.device(x.device):
                            err = fn(ops._DTYPE_CODES[dt], a.data_ptr(), None, x.data_ptr(), None,
                                     None, out.data_ptr(), b, side, side, 1, int(trans), m, 0,
                                     torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"bgemv_members: variant {name!r} error {err}")

                    call()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want_kernel[m]):
                        raise AssertionError(f"bgemv_members: variant {name!r} changed the bits")
                    us[f"{name} members={m}"] = cs.time_ms(call) * 1e3
                us["first design"] = cs.time_ms(
                    lambda: cs.replaced_bgemv(a, x, transpose_a=trans)) * 1e3
                op = a.transpose(1, 2) if trans else a
                nb = (a.numel() + x.numel() + b * side) * elem
                print(json.dumps({"member": f"({side},{side})", "dtype": str(dt).split(".")[1],
                                  "trans": trans, "batch": b, "member_bytes": side * side * elem,
                                  "plan": str(bgemv.plan(b, side, side, dt, trans=trans,
                                                         batched=True)),
                                  "fastest": min(us, key=us.get), "us": us,
                                  "bmm_us": cs.time_ms(lambda: torch.bmm(op, x[..., None])) * 1e3,
                                  "bound_us": nb / cs.HBM_BYTES_S * 1e6}), flush=True)
                del a, x, want
    for dt in (torch.bfloat16, torch.float64, torch.float32):
        b, k, n = 32, 2048, 2048
        a = (torch.randn(b, k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
        x = torch.randn(b, k, generator=g, device="cuda").to(dt)
        with ops.reference_mode():
            want = ops.bgemv(a, x, transpose_a=True)
        chosen = bgemv.plan(b, k, n, dt, batched=True)
        us = {}
        for splits in sorted({chosen.splits, 2, 4}):
            step = bgemv.MEMBER_ROW_STEP
            rows = bgemv._cdiv(bgemv._cdiv(k, splits), step) * step
            p = bgemv.Plan(chosen.tile, bgemv._cdiv(k, rows), rows, True)
            out = torch.empty_like(want)

            def call(p=p, out=out):
                return bgemv.run(a, x, out, p, w2=None, bias=None, residual=None, act_code=0,
                                 dtype_code=ops._DTYPE_CODES[dt])

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.double(), want.double(), **cs.TOL[dt]):
                raise AssertionError(f"bgemv_members: {p} at (32, 2048, 2048) {dt} disagrees")
            us[f"{p.splits}x{p.rows} ({p.blocks(b, n)} blocks)"] = cs.time_ms(call) * 1e3
        us["first design"] = cs.time_ms(
            lambda: cs.replaced_bgemv(a, x, transpose_a=True)) * 1e3
        nb = (a.numel() + x.numel() + b * n) * a.element_size()
        print(json.dumps({"member": "(2048,2048) x 32", "dtype": str(dt).split(".")[1],
                          "trans": True, "plan": str(chosen), "fastest": min(us, key=us.get),
                          "us": us, "bmm_us": cs.time_ms(
                              lambda: torch.bmm(a.transpose(1, 2), x[..., None])) * 1e3,
                          "bound_us": nb / cs.HBM_BYTES_S * 1e6}), flush=True)
        del a, x, want


def qgemv_sweep():
    from repro_torch.core import quant
    from repro_torch.kernels import bgemv, ops
    cs.replaced_build_finish(cs.replaced_build_start())
    g = torch.Generator(device="cuda").manual_seed(8)
    for what, b, k, n, gate, dt in QGEMV_SHAPES:
        spec = quant.QuantSpec(64, None, transpose=True)
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        w2 = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5 if gate else None
        qw, qw2 = quant.quantize(w, spec), quant.quantize(w2, spec) if gate else None
        x = torch.randn(b, k, generator=g, device="cuda").to(dt)
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.bgemv(qw, x, a2=qw2, activation=act, transpose_a=True)
        out = torch.empty(b, n, dtype=dt, device="cuda")
        chosen = bgemv.plan_int8(b, k, n, dt, gate=gate)
        us = {}
        plans = []
        for splits in (1, 2, 3, 4, 6, 8):
            cols = k if splits == 1 else bgemv._cdiv(bgemv._cdiv(k, splits), 16) * 16
            for warps in ((4, 8) if chosen.route == "tc" else (8,)):
                p = bgemv.Int8Plan(chosen.route, chosen.rows, bgemv._cdiv(k, cols), cols, warps)
                if p.x_bytes(b, dt) <= bgemv.INT8_MAX_X_BYTES and p not in plans:
                    plans.append(p)
        for p in plans:

            def call(p=p):
                return bgemv.run_int8(qw, x, out, p, qw2=qw2, bias=None, residual=None,
                                      act_code=ops._ACTS[act], dtype_code=ops._DTYPE_CODES[dt])

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.double(), want.double(), **cs.TOL[dt]):
                raise AssertionError(f"qgemv: {p} at {what} disagrees with plain")
            us[f"{p.splits}x{p.cols} w{p.warps} ({p.blocks(b, n)} blocks)"] = cs.time_ms(call) * 1e3
        row = {"shape": f"{what} {b}x{k}->{n}" + (" gate" if gate else ""),
               "plan": f"{chosen.route} {chosen.splits}x{chosen.cols} w{chosen.warps}",
               "fastest": min(us, key=us.get),
               "us": us, "first_design_us": cs.time_ms(
                   lambda: cs.replaced_qgemv(qw, x, qw2=qw2, activation=act)) * 1e3,
               "bound_us": (qw.values.numel() * (2 if gate else 1) + x.numel() * x.element_size()
                            + b * n * x.element_size()) / cs.HBM_BYTES_S * 1e6}
        if dt == torch.bfloat16:
            wd, w2d = w.to(dt), (w2.to(dt) if gate else None)
            row["dense_bgemv_us"] = cs.time_ms(
                lambda: ops.bgemv(wd, x, a2=w2d, activation=act, transpose_a=True)) * 1e3
        print(json.dumps(row), flush=True)


def flush():
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(4, 2048, generator=g, device="cuda").bfloat16()
    w = (torch.randn(2048, 2048, generator=g, device="cuda") * 2048 ** -0.5).bfloat16()
    bias = torch.randn(2048, generator=g, device="cuda").bfloat16()
    u = torch.randn(2 ** 26, generator=g, device="cuda", dtype=torch.float64)
    v = torch.randn(2 ** 26, generator=g, device="cuda", dtype=torch.float64)
    calls = {"bgemv qkv 4x2048->2048 +bias":
             lambda: ops.bgemv(w, x, bias=bias, transpose_a=True),
             "addmm qkv": lambda: torch.addmm(bias, x, w),
             "axpy f64 2^26": lambda: ops.axpy(0.75, u, v),
             "add f64 2^26": lambda: torch.add(v, u, alpha=0.75)}
    for name, call in calls.items():
        ms = {kind: [] for kind in ("write", "read")}
        for kind in ("write", "read", "read", "write"):
            ms[kind].append(cs.time_ms(call, flush=kind))
        print(json.dumps({"call": name, "ms_write_flush": ms["write"],
                          "ms_read_flush": ms["read"]}), flush=True)


# (what, M, K, N, gate)
F32_SHAPES = [("8192^3", 8192, 8192, 8192, False),
              ("zamba2 LoRA merge", 2048, 128, 2048, False),
              ("aligned ragged", 4095, 4096, 4092, False),
              ("gate 512x2048->5632", 512, 2048, 5632, True),
              ("prefill qkv 512x2048->2048", 512, 2048, 2048, False),
              ("prefill down 512x5632->2048", 512, 5632, 2048, False),
              ("smoke qkv 28x64->64", 28, 64, 64, False),
              ("smoke in_proj 20x64->296", 20, 64, 296, False),
              ("smoke gate+up 28x64->128", 28, 64, 128, True)]


def f32():
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(9)
    for what, m, k, n, gate in F32_SHAPES:
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        b2 = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5 if gate else None
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.gemm(a, b, b2=b2, activation=act)
        out = torch.empty(m, n, device="cuda")
        iters = 5 if m * n * k > 2 ** 36 else 20
        us = {}
        for tile in gemm.FFMA_SM90_GATE_TILES if gate else gemm.FFMA_SM90_TILES:
            def call(tile=tile):
                return gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", tile), b2=b2, bias=None,
                                      residual=None, act_code=ops._ACTS[act], m=m, k=k, n=n)

            label = f"{tile[0]}x{tile[1]}"
            call()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **cs.TOL[torch.float32]):
                err = (out - want).abs().max().item()
                raise AssertionError(f"f32: {label} at {(m, k, n)} disagrees with plain ({err})")
            us[label] = cs.time_ms(call, iters=iters) * 1e3
        us["ffma (csrc/gemm.cu)"] = cs.time_ms(lambda: cs.ffma_launch(a, b, b2=b2, activation=act),
                                               iters=iters) * 1e3
        both = torch.cat([b, b2], 1) if gate else b
        us["torch.matmul" + (" [B|B2]" if gate else "")] = cs.time_ms(
            lambda: torch.matmul(a, both), iters=iters) * 1e3
        flops = 2 * m * k * n * (2 if gate else 1)
        print(json.dumps({"shape": f"{what} ({m},{k})@({k},{n})",
                          "plan": str(gemm.plan(m, k, n, torch.float32, gate=gate)),
                          "bound_us": cs.bound(4 * (m * k + k * n * (2 if gate else 1) + m * n),
                                               flops, torch.float32)[0] * 1e3,
                          "us": us}), flush=True)
        del a, b, b2, want, out


def axpy_sweep():
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(10)
    tree = str(Path(ops.__file__).resolve().parents[3])
    n = 2 ** 26
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        for what, size, offset in (("2^26", n, 0), ("2^26-3", n - 3, 0),
                                   ("2^26 one element in", n, 1)):
            x = torch.randn(size + offset, generator=g, device="cuda").to(dt)[offset:]
            y = torch.randn(size + offset, generator=g, device="cuda").to(dt)[offset:]
            with ops.reference_mode():
                want = ops.axpy(0.75, x, y)
            got = ops.axpy(0.75, x, y)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"axpy: {what} {dt} differs from the plain version")
            ms = {"ops.axpy": cs.time_ms(lambda: ops.axpy(0.75, x, y)),
                  "torch.add": cs.time_ms(lambda: torch.add(y, x, alpha=0.75))}
            print(json.dumps({"tree": tree, "axpy": f"{what} {str(dt).split('.')[1]}",
                              "bound_ms": 3 * size * x.element_size() / cs.HBM_BYTES_S * 1e3,
                              "ms": ms}), flush=True)
            del x, y, got, want


def host():
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn(2048, 128, generator=g, device="cuda")
    b = torch.randn(128, 2048, generator=g, device="cuda") * 128 ** -0.5
    ops.gemm(a, b)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(100):
            ops.gemm(a, b)
        per_call.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"tree": str(Path(ops.__file__).resolve().parents[3]),
                      "host_us_per_call": statistics.median(per_call),
                      "runs_us": per_call,
                      "routes": {k: v for k, v in ops.launch_counts().items()
                                 if k.startswith("gemm_")}}), flush=True)


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def witness(with_ffma: bool):
    from repro_torch.kernels import gemm, ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    plan = gemm.plan

    def ffma_plan(m, k, n, dtype, gate=False, packed_layout=None, aligned=True, sms=132):
        return gemm.Plan("ffma", gemm.FFMA_TILE[bool(gate)])

    models = ((cs.RWKV, lambda c: c["tm"]["s"], [8, 1, 2, 3, 4, 5]),
              (cs.ZAMBA, lambda c: c["mamba"]["h"], [12, 1, 2, 3]))
    for arch, state_of, seeds in models:
        cfg = get_config(arch, "full")
        params = tf.init_params(cfg, 0, "cuda")
        params32 = cs._map_tensors(params, lambda t: t.float())
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        for seed in seeds:  # the tokens of phase_forced_recurrent for this seed
            rng = np.random.default_rng(seed)
            tokens = torch.from_numpy(
                rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda()
            steps = [torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1),
                                                   dtype=np.int32)).cuda() for _ in range(3)]
            runs = {"wgmma": cs._forced_state_run(params, cfg, tokens, steps, state_of)[0]}
            if with_ffma:
                gemm.plan = ffma_plan
                try:
                    runs["ffma"] = cs._forced_state_run(params, cfg, tokens, steps, state_of)[0]
                finally:
                    gemm.plan = plan
            with ops.reference_mode():
                plain = cs._forced_state_run(params, cfg, tokens, steps, state_of)[0]
                f32 = cs._forced_state_run(params32, cfg32, tokens, steps, state_of)[0]
            row = {"arch": arch, "seed": seed,
                   "plain_to_f32": [cs._rel(x, w) for x, w in zip(plain, f32)]}
            for name, logits in runs.items():
                row[f"{name}_to_f32"] = [cs._rel(x, w) for x, w in zip(logits, f32)]
                row[f"{name}_to_plain"] = [cs._rel(x, w) for x, w in zip(logits, plain)]
            print(json.dumps(row), flush=True)
        del params, params32
        torch.cuda.empty_cache()


def odd():
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(torch.bfloat16, 4095, 4097, 4093, False, (16,)),
             (torch.bfloat16, 8192, 8191, 8192, False, (16,)),
             (torch.bfloat16, 508, 2047, 2001, False, (16,)),
             (torch.bfloat16, 512, 2047, 5631, True, (16,)),
             (torch.float64, 4095, 4097, 4093, False, (8,)),
             (torch.float64, 4095, 4098, 4094, False, (16, 8))]
    for dtype, m, k, n, gate, copies in cases:
        a = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        b = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dtype)
        b2 = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dtype) if gate else None
        act = "silu" if gate else None
        with ops.reference_mode():
            want = ops.gemm(a, b, b2=b2, activation=act)
        out = torch.empty(m, n, dtype=dtype, device="cuda")
        f64 = dtype == torch.float64
        tiles = ((gemm.DMMA_GATE_TILES if gate else gemm.DMMA_TILES) if f64
                 else (gemm.GATE_TILES if gate else gemm.TC_TILES))
        ms = {}
        for tile in tiles:
            for copy in copies:
                def call(tile=tile, copy=copy):
                    kw = dict(b2=b2, bias=None, residual=None, act_code=ops._ACTS[act], m=m,
                              k=k, n=n)
                    if f64:
                        return gemm.dmma(a, b, out, gemm.Plan("dmma", tile, copy=copy), **kw)
                    return gemm.tc(a, b, out, gemm.Plan("wgmma", tile, stage=True), **kw)

                label = f"{tile[0]}x{tile[1]}" + (f" copy={copy}B" if f64 else " staged")
                call()
                torch.cuda.synchronize()
                if not torch.allclose(out.double(), want.double(), **cs.TOL[dtype]):
                    err = (out.double() - want.double()).abs().max().item()
                    raise AssertionError(f"odd: {label} at {(m, k, n)} disagrees ({err})")
                ms[label] = cs.time_auto(call)
        if not f64:
            ms["staging copies alone"] = cs.time_auto(
                lambda: [gemm.tma_rows(x) for x in (a, b, b2) if x is not None])
        ms["ffma (csrc/gemm.cu)"] = cs.time_auto(lambda: cs.ffma_launch(a, b, b2=b2,
                                                                        activation=act))
        if not gate:
            ms["torch.matmul"] = cs.time_auto(lambda: torch.matmul(a, b))
        flops = 2 * m * k * n * (2 if gate else 1)
        print(json.dumps({"shape": f"({m},{k})@({k},{n})" + (" gate" if gate else ""),
                          "dtype": str(dtype).split(".")[1],
                          "plan": str(gemm.plan(m, k, n, dtype, gate=gate)),
                          "bound_ms": flops / cs.PEAK_FLOP_S[dtype] * 1e3, "ms": ms}),
              flush=True)
        del a, b, b2, want, out


# the packed study's variants of csrc/gemm_sm90.cu: (old, new) text edits,
# each found exactly once
PACKED_VARIANTS = {  # the batched form's (BM = 64)
    "launch bound 1": [
        ("Q == INT8_KN ? KnLayout<Cfg<BM, BN, GATE, Q>>::BLOCKS : 1)", "1)"),
        ("static constexpr bool SPLIT_REGS = WIDE || !C::GATE;",
         "static constexpr bool SPLIT_REGS = WIDE;")],
    "6 staging stages": [("static constexpr int STAGES = WIDE ? 6 : 4, BUFS = 2;",
                          "static constexpr int STAGES = 6, BUFS = 2;")],
    "registers not moved": [("static constexpr bool SPLIT_REGS = WIDE || !C::GATE;",
                             "static constexpr bool SPLIT_REGS = WIDE;")],
}
PACKED_2D_VARIANTS = {  # the 2-D form's at BM = 128 ("timing only": results not checked)
    "wide: 4 staging stages": [("static constexpr int STAGES = WIDE ? 6 : 4, BUFS = 2;",
                                "static constexpr int STAGES = 4, BUFS = 2;")],
    "wide: the whole tile's partial": [("static constexpr int HALVES = WIDE ? C::BN / 64 : 2;",
                                        "static constexpr int HALVES = WIDE ? 1 : 2;")],
    "wide: 3 bf16 stages": [("static constexpr int STAGES = WIDE ? 6 : 4, BUFS = 2;",
                             "static constexpr int STAGES = WIDE ? 6 : 4, BUFS = WIDE ? 3 : 2;")],
    "wide: one converter warpgroup": [
        ("static constexpr int CONVERTERS = (WIDE ? 2 : 1) * 128;",
         "static constexpr int CONVERTERS = 128;"),
        ("static constexpr int CONVERTER_REGS = WIDE ? 72 : 56, CONSUMER_REGS = WIDE ? 184 : 104;",
         "static constexpr int CONVERTER_REGS = WIDE ? 88 : 56, CONSUMER_REGS = WIDE ? 208 : 104;")],
    "timing only: no conversion": [("        convert_kn<BN, C::NB,",
                                    "        if (K < 0) convert_kn<BN, C::NB,")],
}
F64Q8_VARIANTS = {
    "BM = 64: two blocks an SM (96 and 48 registers)": [
        ("static constexpr int BLOCKS = 1;", "static constexpr int BLOCKS = T::BM == 64 ? 2 : 1;"),
        ("static constexpr int CONSUMER_REGS = T::BM == 64 ? 128 : 192;",
         "static constexpr int CONSUMER_REGS = T::BM == 64 ? 96 : 192;"),
        ("static constexpr int CONVERTER_REGS = T::BM == 64 ? 248 : 120;",
         "static constexpr int CONVERTER_REGS = T::BM == 64 ? 48 : 120;")],
    "timing only: no conversion": [
        ("      if (kt + 1 < KT)\n        convert_q8<T, LAYOUT>(land((kt + 1) % STAGES)",
         "      if (K < 0)\n        convert_q8<T, LAYOUT>(land((kt + 1) % STAGES)")],
}


def packed():
    from repro_torch.core import quant
    from repro_torch.kernels import _build, gemm, ops
    variants = source_variants("gemm_sm90.cu", {**PACKED_VARIANTS, **PACKED_2D_VARIANTS},
                               "gemm_tc_launch", gemm._TC_ARGTYPES)
    lib = _build.build()  # built beside the variants: the design's library
    design = _build.function("gemm_tc_launch", gemm._TC_ARGTYPES)
    fns = {"design": design, **{k: variants[k] for k in PACKED_VARIANTS}}
    g = torch.Generator(device="cuda").manual_seed(21)
    e, d, f, m = 64, 2048, 1408, 32

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    spec = quant.QuantSpec(block_m=64, block_n=None)
    wg, wu = rnd(e, d, f, std=d ** -0.5), rnd(e, d, f, std=d ** -0.5)
    wd = rnd(e, f, d, std=f ** -0.5)
    qg, qu, qd = (quant.quantize(w, spec) for w in (wg, wu, wd))
    h, mid = rnd(e, m, d), rnd(e, m, f)
    cases = {"gate_up": (h, (qg, qu), (wg, wu), 1, torch.bfloat16),
             "down": (mid, (qd, None), (wd, None), 0, torch.float32)}
    for label, (a, (q1, q2), (w1, w2), act, out_dtype) in cases.items():
        k, n = a.shape[2], w1.shape[2]
        out = torch.empty(e, m, n, dtype=out_dtype, device="cuda")
        with ops.reference_mode():
            want = ops.bgemm(a, q1, b2=q2, activation="silu" if act else None,
                             out_dtype=out_dtype)

        def launch(fn, b, b2, scales=None, scales2=None, qb=0):
            err = fn(a.data_ptr(), b.data_ptr(), 0 if b2 is None else b2.data_ptr(),
                     0 if scales is None else scales.data_ptr(),
                     0 if scales2 is None else scales2.data_ptr(), 64, qb, None, None,
                     out.data_ptr(), None, e, 1, m, k, n, k, n, act,
                     int(out_dtype == torch.float32), 64, 64, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"packed: launch failed ({err})")

        us = {}
        for name, fn in fns.items():
            def call(fn=fn):
                launch(fn, q1.values, None if q2 is None else q2.values, q1.scales,
                       None if q2 is None else q2.scales, n)

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.double(), want.double(), **cs.TOL[out_dtype]):
                raise AssertionError(f"packed: {name} disagrees at {label}")
            us[name] = 1e3 * cs.time_ms(call)
        us["dense bf16 (batched wgmma)"] = 1e3 * cs.time_ms(lambda: launch(fns["design"], w1, w2))
        nbytes = cs.nbytes(a, q1.values, q1.scales, out) + (
            0 if q2 is None else cs.nbytes(q2.values, q2.scales))
        print(json.dumps({"case": f"{label} ({e},{m},{k})@({e},{k},{n})", "us": us,
                          "bound_us": nbytes / cs.HBM_BYTES_S * 1e6,
                          "library": str(lib.name)}), flush=True)
    packed_2d({"design": design, **{k: variants[k] for k in PACKED_2D_VARIANTS}})


def packed_2d(fns: dict):
    """`packed`'s 2-D half: bf16 A against int8 "kn" B at every tile of the
    plan's tile set, through each library's gemm_tc_launch."""
    from repro_torch.core import quant
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(22)
    for m, k, n, block_n, gate in ((8192, 8192, 8192, None, False), (8192, 8192, 8192, 16, False),
                                   (4095, 4096, 2064, None, True)):
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = [torch.randn(k, n, generator=g, device="cuda") * k ** -0.5 for _ in range(1 + gate)]
        q = [quant.quantize(x, quant.QuantSpec(64, block_n)) for x in w]
        qb, qb2 = q[0], q[1] if gate else None
        act = "silu" if gate else None
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        with ops.reference_mode():
            want = ops.gemm(a, qb, b2=qb2, activation=act)

        def launch(fn, tile):
            err = fn(a.data_ptr(), qb.values.data_ptr(), 0 if qb2 is None else qb2.values.data_ptr(),
                     qb.scales.data_ptr(), 0 if qb2 is None else qb2.scales.data_ptr(), *qb.block,
                     None, None, out.data_ptr(), None, 1, 0, m, k, n, k, n, ops._ACTS[act], 0,
                     *tile, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"packed_2d: launch failed ({err}) at {tile}")

        us = {}
        for name, fn in fns.items():
            for tile in gemm.PACKED_GATE_TILES if gate else gemm.PACKED_TILES:
                if name != "design" and tile[0] != 128:
                    continue  # the variants change the BM = 128 form only
                launch(fn, tile)
                torch.cuda.synchronize()
                if not name.startswith("timing only") and not torch.allclose(
                        out.float(), want.float(), **cs.TOL[torch.bfloat16]):
                    raise AssertionError(f"packed_2d: {name} {tile} disagrees at {(m, k, n)}")
                us[f"{name} {tile[0]}x{tile[1]}"] = 1e3 * cs.time_ms(
                    lambda fn=fn, tile=tile: launch(fn, tile), iters=5)
        dense = [x.bfloat16() for x in w]
        us["dense bf16 (plan)"] = 1e3 * cs.time_ms(
            lambda: ops.gemm(a, dense[0], b2=dense[1] if gate else None, activation=act), iters=5)
        us["gemm.cu"] = 1e3 * cs.time_ms(lambda: cs.ffma_launch(a, qb, b2=qb2, activation=act),
                                         iters=5)
        plan = gemm.plan(m, k, n, torch.bfloat16, gate=gate, packed_layout="kn", block=qb.block)
        print(json.dumps({"case": f"2-D kn ({m},{k})@({k},{n}) block {qb.block}"
                          + (" gate" if gate else ""), "plan": str(plan),
                          "fastest": min(us, key=us.get), "us": us}), flush=True)


def f32feed():
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(9)
    for m, k, n in ((4095, 4097, 4093), (508, 2047, 2001), (4095, 4098, 4094)):
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        with ops.reference_mode():
            want = ops.gemm(a, b)
        out = torch.empty(m, n, device="cuda")
        kw = dict(b2=None, bias=None, residual=None, act_code=0, m=m, k=k, n=n)
        ms = {}
        for tile in gemm.FFMA_SM90_TILES:
            def call(tile=tile):
                return gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", tile, stage=True),
                                      **kw)

            label = f"{tile[0]}x{tile[1]} staged"
            call()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **cs.TOL[torch.float32]):
                raise AssertionError(f"f32feed: {label} at {(m, k, n)} disagrees")
            ms[label] = cs.time_auto(call)
        ms["staging copies alone"] = cs.time_auto(lambda: (gemm.tma_rows(a), gemm.tma_rows(b)))
        ms["ffma (csrc/gemm.cu)"] = cs.time_auto(lambda: cs.ffma_launch(a, b))
        ms["torch.matmul"] = cs.time_auto(lambda: torch.matmul(a, b))
        print(json.dumps({"shape": f"({m},{k})@({k},{n})",
                          "plan": str(gemm.plan(m, k, n, torch.float32)),
                          "bound_ms": 2 * m * k * n / cs.PEAK_FLOP_S[torch.float32] * 1e3,
                          "ms": ms}), flush=True)
        del a, b, want, out


# f32q8's variant of csrc/gemm_f32_q8.cu: (old, new) text edits, each found
# exactly once
Q8_VARIANTS = {
    "no conversion": [("  convert_stage<C, LAYOUT>(p, sc, smem, 0, 0, n0, tid);\n", ""),
                      ("      convert_stage<C, LAYOUT>(p, sc, smem, f % STAGES, f * BK, n0, tid);\n",
                       "")]}


def f32q8():
    from repro_torch.core import quant
    from repro_torch.kernels import gemm, ops
    variants = source_variants("gemm_f32_q8.cu", Q8_VARIANTS, "gemm_f32_q8_launch",
                               gemm._F32_Q8_ARGTYPES)
    g = torch.Generator(device="cuda").manual_seed(23)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def launch(fn, a, q, q2, out, p, m, k, n, act, batch):
        err = fn(a.data_ptr(), q.values.data_ptr(), q.scales.data_ptr(),
                 None if q2 is None else q2.values.data_ptr(),
                 None if q2 is None else q2.scales.data_ptr(), *q.block, int(q.transposed), None,
                 None, out.data_ptr(), batch, int(q.values.ndim == 3), m, k, n, act, *p.tile,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"f32q8: a variant's launch failed ({err})")

    def timed(ms, call, got, want, a, q, q2, p, m, k, n, act, batch):
        ms["ring (gemm_f32_q8.cu)"] = cs.time_auto(call)
        for name, fn in variants.items():
            got.zero_()
            launch(fn, a, q, q2, got, p, m, k, n, act, batch)
            torch.cuda.synchronize()
            if name != "no conversion" and not torch.allclose(got, want, **cs.TOL[torch.float32]):
                raise AssertionError(f"f32q8: variant {name!r} disagrees")
            ms[name] = cs.time_auto(lambda fn=fn: launch(fn, a, q, q2, got, p, m, k, n, act,
                                                         batch))

    n8 = 8192
    a = rnd(n8, n8)
    w = rnd(n8, n8, std=n8 ** -0.5)
    for layout, spec in (("kn", quant.QuantSpec(64, None)),
                         ("nk", quant.QuantSpec(64, None, transpose=True)),
                         ("nk-kblocks", quant.QuantSpec(64, 64, transpose=True))):
        qw = quant.quantize(w, spec)
        with ops.reference_mode():
            want = ops.gemm(a, qw)
        got = ops.gemm(a, qw)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **cs.TOL[torch.float32]):
            raise AssertionError(f"f32q8: {layout} disagrees")
        p = gemm.plan(n8, n8, n8, torch.float32, packed_layout=layout)
        ms = {}
        timed(ms, lambda: ops.gemm(a, qw), got, want, a, qw, None, p, n8, n8, n8, 0, 1)
        deq = quant.dequantize_in(qw, torch.float32).contiguous()
        ms["ffma (csrc/gemm.cu)"] = cs.time_auto(lambda: cs.ffma_launch(a, qw))
        ms["dense ring"] = cs.time_auto(lambda: ops.gemm(a, deq))
        print(json.dumps({"case": f"{layout} {n8}^3", "plan": str(p),
                          "bound_ms": 2 * n8 ** 3 / cs.PEAK_FLOP_S[torch.float32] * 1e3,
                          "ms": ms}), flush=True)
        del qw, want, got, deq
    del a, w
    e, d, f, m = 64, 2048, 1408, 32
    spec = quant.QuantSpec(64, None)
    for label, k, n, gate in (("down", f, d, False), ("gate_up", d, f, True)):
        x = rnd(e, m, k)
        q1 = quant.quantize(rnd(e, k, n, std=k ** -0.5), spec)
        q2 = quant.quantize(rnd(e, k, n, std=k ** -0.5), spec) if gate else None
        act = "silu" if gate else None
        kw = dict(b2=q2, activation=act, out_dtype=torch.float32)
        with ops.reference_mode():
            want = ops.bgemm(x, q1, **kw)
        got = ops.bgemm(x, q1, **kw)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **cs.TOL[torch.float32]):
            raise AssertionError(f"f32q8: batched {label} disagrees")
        p = gemm.plan_batched(e, m, k, n, torch.float32, torch.float32, gate=gate,
                              packed_layout="kn", block=q1.block)
        ms = {}
        timed(ms, lambda: ops.bgemm(x, q1, **kw), got, want, x, q1, q2, p, m, k, n,
              ops._ACTS[act], e)
        out = torch.empty(e, m, n, device="cuda")
        d1 = quant.dequantize_in(q1, torch.float32).contiguous()
        d2 = None if q2 is None else quant.dequantize_in(q2, torch.float32).contiguous()
        first = dict(b2=q2, bias=None, residual=None, act_code=ops._ACTS[act], dtype_code=0,
                     out_code=0)
        ms["ffma (csrc/gemm_batched.cu)"] = cs.time_auto(
            lambda: gemm.batched_ffma(x, q1, out, **first))
        ms["dense ring"] = cs.time_auto(lambda: ops.bgemm(x, d1, **dict(kw, b2=d2)))
        nbytes = cs.nbytes(x, q1.values, q1.scales, out) + (
            0 if q2 is None else cs.nbytes(q2.values, q2.scales))
        flops = 2 * e * m * k * n * (2 if gate else 1)
        print(json.dumps({"case": f"batched {label} ({e},{m},{k})@({e},{k},{n})", "plan": str(p),
                          "bound_ms": cs.bound(nbytes, flops, torch.float32)[0],
                          "ms": ms}), flush=True)
        del x, q1, q2, want, got, out, d1, d2


#: f32vec's cases: (label, m, k, n)
VEC_SHAPES = [("8192^3", 8192, 8192, 8192), ("LoRA merge", 2048, 128, 2048),
              ("odd", 4095, 4097, 4093)]


def ring_libraries(other: Path) -> dict:
    """{"this": gemm_f32_launch of this tree's f32 ring sources (gemm_f32*.cu
    but the int8 feed), "other": of OTHER's}, every source compiled by its
    own nvcc, all at once, under build/study_variants."""
    import ctypes

    from repro_torch.kernels import _build, gemm
    root = Path(__file__).resolve().parents[1]
    out_dir = root / "build" / "study_variants" / "f32vec"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"this": root, "other": other.resolve()}
    objs, procs = {t: [] for t in trees}, []
    for tag, tree in trees.items():
        csrc = tree / "src" / "repro_torch" / "csrc"
        for src in sorted(csrc.glob("gemm_f32*.cu")):
            if src.name == "gemm_f32_q8.cu":
                continue
            obj = out_dir / f"{tag}_{src.stem}.o"
            objs[tag].append(obj)
            procs.append((src, subprocess.Popen(
                [_build._nvcc(), *_build.FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"f32vec: nvcc failed for {src}:\n{log[-3000:]}")
    fns = {}
    for tag, files in objs.items():
        lib = out_dir / f"{tag}.so"
        subprocess.run([_build._nvcc(), "-shared", "-o", str(lib), *map(str, files)], check=True)
        fn = getattr(ctypes.CDLL(str(lib)), "gemm_f32_launch")
        fn.argtypes, fn.restype = gemm._F32_ARGTYPES, ctypes.c_int
        fns[tag] = fn
    return fns


def f64vs():
    """The dense f64 DMMA kernel of this tree and of OTHER_TREE in one run
    (see the module notes)."""
    import ctypes
    import re

    from repro_torch.kernels import _build, gemm, ops
    if len(sys.argv) < 3:
        raise SystemExit("f64vs needs OTHER_TREE")
    root = Path(__file__).resolve().parents[1]
    out_dir = root / "build" / "study_variants" / "f64vs"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"this": root, "other": Path(sys.argv[2]).resolve()}
    procs = {}
    for tag, tree in trees.items():
        csrc = tree / "src" / "repro_torch" / "csrc"
        procs[tag] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", "-I", str(csrc), "-o",
             str(out_dir / f"{tag}.so"), str(csrc / "gemm_f64.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"f64vs: nvcc failed for {tag}:\n{log[-3000:]}")
        # ptxas's line pairs: the entry function, then its registers / spills
        ptxas, fn_name = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn_name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn_name:
                ptxas.setdefault(fn_name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn_name:
                ptxas.setdefault(fn_name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        named = {cs._f64_name(k): v for k, v in ptxas.items() if cs._f64_name(k)}
        print(json.dumps({"tree": tag, "ptxas": named}), flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{tag}.so")), "gemm_f64_launch")
        fn.argtypes, fn.restype = gemm._DMMA_ARGTYPES, ctypes.c_int
        fns[tag] = fn
    g = torch.Generator(device="cuda").manual_seed(37)
    f64 = torch.float64
    for label, m, k, n, epi in (("8192^3", 8192, 8192, 8192, False),
                                ("odd", 4095, 4097, 4093, False),
                                ("8192^3 +bias gelu +residual", 8192, 8192, 8192, True)):
        a = torch.randn(m, k, generator=g, device="cuda", dtype=f64)
        b = torch.randn(k, n, generator=g, device="cuda", dtype=f64) * k ** -0.5
        bias = torch.randn(n, generator=g, device="cuda", dtype=f64) if epi else None
        res = torch.randn(m, n, generator=g, device="cuda", dtype=f64) if epi else None
        kw = dict(bias=bias, residual=res, activation="gelu" if epi else None)
        with ops.reference_mode():
            want = ops.gemm(a, b, **kw)
        p = gemm.plan(m, k, n, f64)
        outs = {t: torch.empty(m, n, dtype=f64, device="cuda") for t in fns}

        def launch(tag):
            err = fns[tag](a.data_ptr(), b.data_ptr(), None, _build.ptr(bias), _build.ptr(res),
                           outs[tag].data_ptr(), m, k, n, ops._ACTS[kw["activation"]], *p.tile,
                           0, p.copy, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"f64vs: {tag} launch failed ({err})")

        ms = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            launch(tag)
            torch.cuda.synchronize()
            if not torch.allclose(outs[tag], want, **cs.TOL[f64]):
                raise AssertionError(f"f64vs: {tag} disagrees with plain at {label}")
            ms[tag].append(cs.time_ms(lambda tag=tag: launch(tag), iters=5))
        same = bool(torch.equal(outs["this"], outs["other"]))
        if not epi and not same:
            raise AssertionError(f"f64vs: the two trees' products differ at {label}")
        print(json.dumps({"case": f"{label} ({m},{k})@({k},{n})", "plan": str(p), "ms": ms,
                          "bitwise_equal": same}), flush=True)
        del a, b, bias, res, want, outs


def f32vec():
    from repro_torch.kernels import gemm, ops
    if len(sys.argv) < 3:
        raise SystemExit("f32vec needs OTHER_TREE")
    fns = ring_libraries(Path(sys.argv[2]))
    g = torch.Generator(device="cuda").manual_seed(31)
    for label, m, k, n in VEC_SHAPES:
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        bias = torch.randn(n, generator=g, device="cuda")
        res = torch.randn(m, n, generator=g, device="cuda")
        (sa, lda), (sb, ldb) = gemm.tma_rows(a), gemm.tma_rows(b)
        p = gemm.plan(m, k, n, torch.float32)
        out = torch.empty(m, n, device="cuda")
        row = {"case": f"{label} ({m},{k})@({k},{n})", "plan": str(p),
               "bound_ms": 2 * m * k * n / cs.PEAK_FLOP_S[torch.float32] * 1e3}
        for epi in (False, True):
            kw = dict(bias=bias, residual=res, activation="gelu") if epi else {}
            with ops.reference_mode():
                want = ops.gemm(a, b, **kw)

            def launch(fn):
                err = fn(sa.data_ptr(), sb.data_ptr(), None, bias.data_ptr() if epi else None,
                         res.data_ptr() if epi else None, out.data_ptr(), m, k, n, lda, ldb,
                         ops._ACTS["gelu" if epi else None], *p.tile,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"f32vec: launch failed ({err})")

            ms = {"other": [], "this": []}
            for tag in ("other", "this", "this", "other"):
                out.zero_()
                launch(fns[tag])
                torch.cuda.synchronize()
                if not torch.allclose(out, want, **cs.TOL[torch.float32]):
                    raise AssertionError(f"f32vec: {tag} disagrees at {label} (epilogue {epi})")
                ms[tag].append(cs.time_auto(lambda tag=tag: launch(fns[tag])))
            row["ring, +bias gelu +residual" if epi else "ring, plain"] = ms
        if p.stage:
            row["staging copies alone"] = cs.time_auto(
                lambda: (gemm.tma_rows(a), gemm.tma_rows(b)))
            row["ops.gemm plain (staging + ring)"] = cs.time_auto(lambda: ops.gemm(a, b))
        row["torch.matmul"] = cs.time_auto(lambda: torch.matmul(a, b))
        print(json.dumps(row), flush=True)
        del a, b, bias, res, sa, sb, out, want


def main() -> int:
    runs = {"tiles": tiles, "witness": lambda: witness("--ffma" in sys.argv), "f64": f64,
            "bgemv": bgemv_sweep, "flush": flush, "f32": f32, "axpy": axpy_sweep,
            "host": host, "qgemv": qgemv_sweep, "odd": odd, "bgemv_rows": bgemv_rows_sweep,
            "bgemv_members": bgemv_members_sweep, "packed": packed, "f32feed": f32feed,
            "f32q8": f32q8, "f32vec": f32vec, "f64q8": f64q8, "f64vs": f64vs}
    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in runs:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    with torch.inference_mode():
        runs[sys.argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
