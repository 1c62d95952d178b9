#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (nonzero exit):

1. device  - nvidia-smi's name and power limit, torch's device name;
2. build   - nvcc builds the kernels from csrc/, one process a file (timed);
3. kernels - bgemv, bgemm and flash attention, each against its plain
             PyTorch version on the card at the stablelm-1.6b serving shapes,
             in bf16 and f32, with times beside the card's bound;
4. smoke   - stablelm-1.6b SMOKE served in f32 through the kernels and again
             through the plain versions: equal greedy tokens;
5. serve   - stablelm-1.6b FULL (published widths, seeded random weights),
             bf16: 8 requests, batch 4, prompt 128, gen 32, all logits finite;
6. forced  - prefill + 3 decode steps at full width, kernels vs plain on the
             same tokens: logits within the stated bf16 tolerance;
7. launches - each serving kernel's launch count from phase 5 (and 6);
8. profile - torch.profiler over full-width decode steps: device time by
             kernel and the device's idle share;
9. blas    - the BLAS library (`repro_torch.core.blas`: gemm, gemv, dot,
             nrm2, axpy) at full size in f64, f32 and bf16, each call held
             against its plain version and counted as one launch of its
             kernel (gemm, gemv, blas1 reduce, blas1 axpy); then each timed
             beside its bound and one PyTorch library call;
10. quant_kernels - block-scaled int8 weights through core.blas: the decode
             projections (packed bgemv), the prefill projections (int8-B
             bgemm, "nk"), gemm "kn"/"nk" 8192^3 and gemv 16384^2 with packed
             operands, and ragged awkward-block cases; each counted as one
             launch of its packed kernel, held against its plain version,
             then timed beside its bound and the dense kernel at the same
             shape;
11. quantize - `layers.quantize_weights` on the full stablelm-1.6b weights on
             the card, one layer bitwise equal to the CPU's quantize;
12. smoke_int8 - the SMOKE serve with --quantize int8: kernels and plain
             versions give equal greedy tokens;
13. serve_int8, forced_int8, launches, profile_int8 - the FULL serve with
             --quantize int8 (8/8 complete, greedy agreement with the bf16
             serve), the teacher-forced run (logits within 5% of max |logit|
             of the plain path), the launch counts of both (every projection
             on the packed kernels, 144 a decode step and 144 a prefill, none
             dense), and phase 8's profile of the int8 decode step.

Then a `kernels` summary line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 989 TFLOP/s bf16
dense (tensor cores), 67 TFLOP/s f32 (CUDA cores), 67 TFLOP/s f64 (tensor
cores; the CUDA cores' DFMA peaks at 34).  Detail (nvcc's ptxas
report, every number printed) goes to build/chip_smoke/.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "chip_smoke"
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.float64: 67e12}
# kernel vs plain version on the card: f32 and f64 differ in summation order
# only (K up to 8192); bf16 outputs are rounded once, so a rounding flip is
# one bf16 step (2^-8 relative) — allow four.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2),
       torch.float64: dict(rtol=1e-10, atol=1e-10)}
# dot and nrm2 return one number: |kernel - plain| <= out * |plain| + acc * cond,
# cond = sum |x_i y_i| (nrm2: ||x||).  `acc` is the accumulator's summation
# error (f32 for f32 and bf16, f64 for f64); `out` is one rounding flip of the
# output in its dtype.
SUM_TOL = {torch.float32: dict(out=2 ** -23, acc=1e-7),
           torch.bfloat16: dict(out=2 ** -7, acc=1e-7),
           torch.float64: dict(out=2 ** -52, acc=1e-14)}
SLOW_MS = 50.0  # launches above this are timed 5 times, not 20
# full-width teacher-forced logits: max |kernel - plain| <= 5% of max |plain|
# (bf16 activations between every projection, 24 layers deep)
FORCED_REL_TOL = 0.05
ARCH = "stablelm-1.6b"
RESULTS = {}


def sum_limit(dtype, want: float, cond: float) -> float:
    return SUM_TOL[dtype]["out"] * abs(want) + SUM_TOL[dtype]["acc"] * cond


def emit(phase: str, **fields):
    RESULTS.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

_flush = None
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's ~1.98 GHz boost clock


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of fn over `iters` launches, each with a cold L2
    (a 256 MB write evicts the 50 MB cache first: on the serving path every
    layer's weights arrive from HBM).  A device-side sleep before each
    launch keeps the queue full while the host enqueues fn, so the events
    time the device's work and not the host's Python overhead."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        _flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_auto(fn) -> float:
    """time_ms with 20 launches, or 5 where one launch takes over SLOW_MS."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return time_ms(fn, iters=5 if start.elapsed_time(end) > SLOW_MS else 20)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the serving shapes
# --------------------------------------------------------------------------

def kernel_cases(dtype):
    """(kernel, case, call, library call or None, bytes, flops) at the
    stablelm-1.6b FULL serving shapes, batch 4."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    d, f, b = 2048, 5632, 4
    cases = []
    # bgemv: decode projections, y[b] = epi(x[b] @ W)
    x, xf = rnd(b, d), rnd(b, f)
    w_qkv, bias = rnd(d, d, std=d ** -0.5), rnd(d)
    w_g, w_u = rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5)
    w_dn, res = rnd(f, d, std=f ** -0.5), rnd(b, d)
    cases += [
        ("bgemv", "qkv 4x2048->2048 +bias",
         lambda: ops.bgemv(w_qkv, x, bias=bias),
         lambda: torch.addmm(bias, x, w_qkv),
         nbytes(w_qkv, x, bias) + b * d * x.element_size(), 2 * b * d * d),
        ("bgemv", "gate_up 4x2048->5632 x2 silu-gate",
         lambda: ops.bgemv(w_g, x, a2=w_u, activation="silu"), None,
         nbytes(w_g, w_u, x) + b * f * x.element_size(), 4 * b * d * f),
        ("bgemv", "down 4x5632->2048 +residual",
         lambda: ops.bgemv(w_dn, xf, residual=res),
         lambda: torch.addmm(res, xf, w_dn),
         nbytes(w_dn, xf, res) + b * d * x.element_size(), 2 * b * f * d),
    ]
    # bgemm: admission-prefill projections, C[b] = epi(A[b] @ B)
    a = rnd(b, 128, d)
    a2d = a.view(-1, d)
    ar, wr = rnd(b, 127, 2047), rnd(2047, 2001, std=2047 ** -0.5)
    br, rr = rnd(2001), rnd(b, 127, 2001)
    cases += [
        ("bgemm", "gate_up (4,128,2048)@(2048,5632) x2 silu-gate",
         lambda: ops.bgemm(a, w_g, b2=w_u, activation="silu"), None,
         nbytes(a, w_g, w_u) + b * 128 * f * a.element_size(), 4 * b * 128 * d * f),
        ("bgemm", "qkv (4,128,2048)@(2048,2048) +bias",
         lambda: ops.bgemm(a, w_qkv, bias=bias),
         lambda: torch.addmm(bias, a2d, w_qkv),
         nbytes(a, w_qkv, bias) + b * 128 * d * a.element_size(), 2 * b * 128 * d * d),
        ("bgemm", "ragged (4,127,2047)@(2047,2001) +bias gelu +residual",
         lambda: ops.bgemm(ar, wr, bias=br, residual=rr, activation="gelu"), None,
         nbytes(ar, wr, br, rr) + rr.numel() * rr.element_size(),
         2 * b * 127 * 2047 * 2001),
    ]
    # flash attention over the cache layout, garbage past every kvl
    h, hd, s = 32, 64, 160
    for label, tq, lens in (("prefill B=4 Tq=128 H=32 D=64 S=160", 128, [128] * 4),
                            ("decode B=4 Tq=1 H=32 D=64 S=160", 1, [129, 140, 150, 160])):
        q = rnd(b, tq, h, hd)
        k, v = rnd(b, s, h, hd), rnd(b, s, h, hd)
        for i, n in enumerate(lens):
            k[i, n:] = float("nan")
            v[i, n:] = float("nan")
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
        pos = torch.arange(s, device="cuda")
        qpos = torch.arange(tq, device="cuda")[None, :] + (torch.tensor(lens, device="cuda") - tq)[:, None]
        mask = (pos[None, None, :] <= qpos[..., None]) & (pos[None, None, :] < torch.tensor(lens, device="cuda")[:, None, None])
        mask = mask[:, None]                               # (B, 1, Tq, S)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = sum(min(t + n - tq + 1, n) for n in lens for t in range(tq)) * h
        kv_read = sum(lens) * h * hd * 2 * q.element_size()
        cases.append((
            "attention", label,
            lambda q=q, k=k, v=v, kv_lens=kv_lens: ops.flash_attention(q, k, v, kv_lens=kv_lens),
            lambda qt=qt, kt=kt, vt=vt, mask=mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            2 * nbytes(q) + kv_read + kv_lens.numel() * 4, 4 * pairs * hd))
    return cases


def phase_kernels():
    from repro_torch.kernels import ops
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, case, call, lib, nb, flops in kernel_cases(dtype):
            got = call()
            with ops.reference_mode():
                want = call()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), **TOL[dtype])
            ms = time_ms(call)
            with ops.reference_mode():
                plain_ms = time_ms(call)
            lib_ms = time_ms(lib) if lib is not None else None
            b_ms, by = bound(nb, flops, dtype)
            row = dict(kernel=name, case=case, dtype=str(dtype).split(".")[1],
                       max_abs_err=err, tol=TOL[dtype], within_tol=ok, kernel_ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=by, bytes=nb, flops=flops)
            emit("kernels", **row)
            if not ok:
                raise AssertionError(f"{name} [{case}] {dtype}: max |kernel - plain| "
                                     f"= {err} outside {TOL[dtype]}")
            rows[(name, case, row["dtype"])] = row
    return rows


# --------------------------------------------------------------------------
# phases 4-7: the main path
# --------------------------------------------------------------------------

def phase_smoke():
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH, "smoke")
    params = tf.init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
    kw = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, prompts=prompts,
              params=params, verbose=False, device="cuda")
    got = serve(ARCH, "smoke", **kw)
    with ops.reference_mode():
        want = serve(ARCH, "smoke", **kw)
    equal = got["outputs"] == want["outputs"]
    emit("smoke", dtype="float32", requests=len(prompts), completed=got["completed"],
         tokens_equal=equal, outputs=got["outputs"])
    if not equal or got["completed"] != len(prompts):
        raise AssertionError(f"smoke serve: kernels {got['outputs']} != plain {want['outputs']}")


def phase_serve(params, cfg):
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    finite = []
    logits_chunk = tf._logits_chunk

    def checked(*args, **kwargs):  # every logit of the run, checked on device
        out = logits_chunk(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out

    tf._logits_chunk = checked
    try:
        stats = serve(ARCH, "full", requests=8, batch=4, prompt_len=128, gen=32,
                      seed=0, eos=-1, params=params, device="cuda")
    finally:
        tf._logits_chunk = logits_chunk
    all_finite = bool(torch.stack(finite).all())
    in_range = all(0 <= t < cfg.vocab for o in stats["outputs"] for t in o)
    emit("serve", arch=ARCH, variant="full", dtype="bfloat16", requests=8, batch=4,
         prompt_len=128, gen=32, completed=stats["completed"], tokens=stats["tokens"],
         tok_s=stats["tok_s"], elapsed_s=stats["elapsed_s"],
         ttft_p50_s=statistics.median(stats["ttft"]), prefills=stats["prefills"],
         decode_steps=stats["decode_steps"], occupancy=stats["occupancy"],
         logit_checks=len(finite), all_logits_finite=all_finite)
    if stats["completed"] != 8 or not all_finite or not in_range:
        raise AssertionError(f"full serve: completed {stats['completed']}/8, "
                             f"finite {all_finite}, tokens in range {in_range}")
    if any(len(o) != 32 for o in stats["outputs"]):
        raise AssertionError("full serve: a request stopped before its budget")
    return stats["outputs"]


def _forced_run(params, cfg, tokens, steps):
    """Prefill (4, 128) then decode the given tokens; returns the logits of
    every step and device times (ms) of the prefill and each decode step."""
    from repro_torch.models import transformer as tf
    cache = tf.init_cache(cfg, 4, 160, device="cuda")
    logits, times = [], []
    feeds = [(tf.prefill, tokens)] + [(tf.decode_step, t) for t in steps]
    for fn, tok in feeds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, cache = fn(params, tok, cache, cfg)
        end.record()
        logits.append(out)
        times.append((start, end))
    torch.cuda.synchronize()
    return logits, [s.elapsed_time(e) for s, e in times]


def phase_forced(params, cfg, phase="forced"):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda()
    steps = [torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1), dtype=np.int32)).cuda()
             for _ in range(3)]
    got, t_kernel = _forced_run(params, cfg, tokens, steps)
    with ops.reference_mode():
        want, t_plain = _forced_run(params, cfg, tokens, steps)
    errs, scales, agree = [], [], []
    for gl, wl in zip(got, want):
        errs.append((gl - wl).abs().max().item())
        scales.append(wl.abs().max().item())
        agree.append((gl.argmax(-1) == wl.argmax(-1)).float().mean().item())
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    ok = finite and all(e <= FORCED_REL_TOL * s for e, s in zip(errs, scales))
    emit(phase, arch=ARCH, variant="full", dtype="bfloat16", steps=["prefill", 1, 2, 3],
         max_abs_err=errs, max_abs_logit=scales, rel_tol=FORCED_REL_TOL,
         argmax_agreement=agree, all_finite=finite, within_tol=ok,
         prefill_ms=t_kernel[0], decode_ms_per_step=statistics.mean(t_kernel[1:]),
         plain_prefill_ms=t_plain[0], plain_decode_ms_per_step=statistics.mean(t_plain[1:]))
    if not ok:
        raise AssertionError(f"{phase} logits: errors {errs} vs scales {scales}")


def phase_profile(params, cfg, steps: int = 5, phase: str = "profile"):
    """Where a full-width decode step's time goes (batch 4, 128 cached
    tokens): the wall clock per step without the profiler, then
    torch.profiler over the same steps for device time per kernel name;
    the idle share is 1 - device busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(6)
    cache = tf.init_cache(cfg, 4, 160, device="cuda")
    _, cache = tf.prefill(params, torch.from_numpy(
        rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda(), cache, cfg)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1), dtype=np.int32)).cuda()
    for _ in range(2):
        _, cache = tf.decode_step(params, tok, cache, cfg)
    # wall clock without the profiler, whose host overhead would inflate it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, cache = tf.decode_step(params, tok, cache, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, cache = tf.decode_step(params, tok, cache, cfg)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): aten ops would count twice
    by_name = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit(phase, what="full-width decode step, batch 4, 128 cached tokens",
         wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy or None,
         device_idle_share=(1 - busy / wall_ms) if busy else None,
         device_events_per_step=sum(n for _, n in by_name.values()),
         top=[{"name": k[:90], "ms_per_step": ms, "calls_per_step": n}
              for k, (ms, n) in top])


# --------------------------------------------------------------------------
# phase 9: the BLAS library at full size
# --------------------------------------------------------------------------

D8K, N16K, N26 = 8192, 16384, 2 ** 26
DTYPES = (torch.float64, torch.float32, torch.bfloat16)


def blas_cases():
    """(kernel counter, routine, case, dtype, make) for every BLAS case;
    make() builds the inputs from a seeded generator and returns (call
    through core.blas, library call or None, bytes, flops, sums), where sums
    is None (elementwise tolerance) or, for dot and nrm2, (cond, the same
    call on the first half of each vector: a planted fault)."""
    from repro_torch.core import blas

    def rnd(g, dtype, *shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    def gemm_case(dtype, m, k, n, seed, epi=None, fused=False):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a, b = rnd(g, dtype, m, k), rnd(g, dtype, k, n, std=k ** -0.5)
            out_b = m * n * a.element_size()
            if fused:  # stablelm gate+up on a flattened (512-token) prefill
                b2 = rnd(g, dtype, k, n, std=k ** -0.5)
                return (lambda: blas.matmul_fused(a, b, w2=b2, activation="silu"), None,
                        nbytes(a, b, b2) + out_b, 4 * m * n * k, None)
            if epi:
                bias, res = rnd(g, dtype, n), rnd(g, dtype, m, n)
                return (lambda: blas.gemm(a, b, bias=bias, residual=res, epilogue=epi), None,
                        nbytes(a, b, bias, res) + out_b, 2 * m * n * k, None)
            return (lambda: blas.gemm(a, b), lambda: torch.matmul(a, b),
                    nbytes(a, b) + out_b, 2 * m * n * k, None)
        return make

    def gemv_case(dtype, m, n, seed, trans=False):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a = rnd(g, dtype, n, m, std=m ** -0.5) if trans else rnd(g, dtype, m, n, std=n ** -0.5)
            x = rnd(g, dtype, n)
            at = a.t() if trans else a
            return (lambda: blas.gemv(a, x, trans=trans), lambda: torch.mv(at, x),
                    nbytes(a, x) + m * a.element_size(), 2 * m * n, None)
        return make

    def level1_case(routine, dtype, n, seed):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            x, y = rnd(g, dtype, n), rnd(g, dtype, n)
            size, h = x.element_size(), n // 2
            if routine == "dot":
                cond = (x.double() * y.double()).abs().sum().item()
                return (lambda: blas.dot(x, y), lambda: torch.dot(x, y),
                        nbytes(x, y) + size, 2 * n, (cond, lambda: blas.dot(x[:h], y[:h])))
            if routine == "nrm2":
                cond = x.double().norm().item()
                return (lambda: blas.nrm2(x), lambda: torch.linalg.vector_norm(x),
                        nbytes(x) + size, 2 * n, (cond, lambda: blas.nrm2(x[:h])))
            return (lambda: blas.axpy(0.75, x, y), lambda: torch.add(y, x, alpha=0.75),
                    nbytes(x, y) + n * size, 2 * n, None)
        return make

    cases = []
    for i, dt in enumerate(DTYPES):
        cases.append(("gemm", "gemm", f"{D8K}x{D8K}x{D8K}", dt, gemm_case(dt, D8K, D8K, D8K, 10 + i)))
    cases += [
        ("gemm", "gemm", "ragged (4095,4097)@(4097,4093) +bias gelu +residual", torch.float32,
         gemm_case(torch.float32, 4095, 4097, 4093, 13, epi="gelu")),
        ("gemm", "matmul_fused", "2-D (512,2048)@(2048,5632) x2 silu-gate", torch.bfloat16,
         gemm_case(torch.bfloat16, 512, 2048, 5632, 14, fused=True)),
    ]
    for i, dt in enumerate(DTYPES):
        cases.append(("gemv", "gemv", f"{N16K}x{N16K}", dt, gemv_case(dt, N16K, N16K, 20 + i)))
    cases += [
        ("gemv", "gemv", "ragged 16383x16385", torch.float32,
         gemv_case(torch.float32, 16383, 16385, 23)),
        ("gemv", "gemv", f"trans=True {N16K}x{N16K} (transpose materialised)", torch.float32,
         gemv_case(torch.float32, N16K, N16K, 24, trans=True)),
    ]
    for r, routine in enumerate(("dot", "nrm2")):
        for i, dt in enumerate(DTYPES):
            cases.append(("blas1_reduce", routine, "n=2^26", dt, level1_case(routine, dt, N26, 30 + 10 * r + i)))
        cases.append(("blas1_reduce", routine, "ragged n=2^26-3", torch.float32,
                      level1_case(routine, torch.float32, N26 - 3, 33 + 10 * r)))
    for i, dt in enumerate(DTYPES):
        cases.append(("blas1_axpy", "axpy", "n=2^26", dt, level1_case("axpy", dt, N26, 50 + i)))
    return cases


def phase_blas():
    """Drive every case once through core.blas with the launch counts reset
    just before (each call must add exactly one launch to its kernel's
    count), hold it against its plain version, then time it."""
    from repro_torch.kernels import ops
    cases = blas_cases()
    checked = []
    ops.reset_launch_counts()
    for kernel, routine, case, dtype, make in cases:
        call, _, _, _, sums = make()
        before = ops.launch_counts()
        got = call()
        after = ops.launch_counts()
        with ops.reference_mode():
            want = call()
            planted = None if sums is None else sums[1]()
        torch.cuda.synchronize()
        rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        diff = (got.double() - want.double()).abs()
        err = diff.max().item()
        finite = bool(torch.isfinite(got).all())
        chk = dict(err=err, cond=None, tol=TOL[dtype])
        if sums is None:
            tol = TOL[dtype]
            ok = finite and bool((diff <= tol["atol"] + tol["rtol"] * want.double().abs()).all())
        else:
            # the limit must reject a kernel that returns 0 or drops half the vector
            w = want.double().item()
            limit = sum_limit(dtype, w, sums[0])
            rejects = {"zero": abs(w) > limit, "half": abs(planted.double().item() - w) > limit}
            chk.update(cond=sums[0], tol=SUM_TOL[dtype], limit=limit, planted_rejected=rejects)
            if not all(rejects.values()):
                raise AssertionError(f"blas {routine} [{case}] {dtype}: the limit {limit} "
                                     f"passes a planted fault {rejects}")
            ok = finite and err <= limit
        ok = ok and got.dtype == dtype and got.shape == want.shape
        chk["ok"] = ok
        checked.append(chk)
        if not ok or rose != {kernel: 1}:
            emit("blas", kernel=kernel, routine=routine, case=case, dtype=str(dtype).split(".")[1],
                 max_abs_err=err, tol=chk["tol"], within_tol=ok, launches_added=rose)
            raise AssertionError(f"blas {routine} [{case}] {dtype}: within_tol={ok}, "
                                 f"launches added {rose} (want {{{kernel!r}: 1}})")
        del call, got, want, diff, planted
    counts = ops.launch_counts()
    emit("launches", run="blas", **counts)
    for kernel in ("gemm", "gemv", "blas1_reduce", "blas1_axpy"):
        expected = sum(c[0] == kernel for c in cases)
        if counts[kernel] != expected:
            raise AssertionError(f"blas launches {counts}: {kernel} {counts[kernel]} != {expected}")

    rows = {}
    for (kernel, routine, case, dtype, make), chk in zip(cases, checked):
        call, lib, nb, flops, _ = make()
        ms = time_auto(call)
        with ops.reference_mode():
            plain_ms = time_auto(call)
        lib_ms = time_auto(lib) if lib is not None else None
        b_ms, by = bound(nb, flops, dtype)
        row = dict(kernel=kernel, routine=routine, case=case, dtype=str(dtype).split(".")[1],
                   max_abs_err=chk["err"], tol=chk["tol"],
                   tol_scale="out*|plain| + acc*cond" if chk["cond"] is not None else "elementwise",
                   cond=chk["cond"], limit=chk.get("limit"),
                   planted_rejected=chk.get("planted_rejected"), within_tol=chk["ok"],
                   kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
                   bytes=nb, flops=flops)
        emit("blas", **row)
        rows[(routine, case, row["dtype"])] = row
        del call, lib
    return rows, counts


# --------------------------------------------------------------------------
# phases 10-13: block-scaled int8 weights
# --------------------------------------------------------------------------

SERVE_SPEC = dict(block_m=64, block_n=None)   # layers.quantize_weights' spec
AWKWARD_SPEC = dict(block_m=61, block_n=None)  # _fit_block shrinks 61 to a divisor


def quant_cases():
    """(packed kernel counter, dense counter, case, dtype, make) for every
    int8 case; make() builds the inputs from a seeded generator and returns
    (call through core.blas, the same call on the dense weight, bytes,
    flops).  Bytes count the int8 values, the f32 scales, the activations
    and the output once each."""
    from repro_torch.core import blas, quant

    def rnd(g, dtype, *shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    def pack(w, spec, transpose):
        return quant.quantize(w, quant.QuantSpec(transpose=transpose, **spec))

    def proj_case(dtype, rows, d, f, seed, epi, spec=SERVE_SPEC):
        """a serving projection x (4, rows, d) through matmul_fused; rows == 1
        is the decode bgemv, else the prefill bgemm, weights output-major"""
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = rnd(g, dtype, 4, rows, d)
            w, w2 = rnd(g, dtype, d, f, std=d ** -0.5), rnd(g, dtype, d, f, std=d ** -0.5)
            kw, dense_kw, extra = {}, {}, 0
            if epi == "gate":
                qw2 = pack(w2, spec, True)
                kw, dense_kw = dict(w2=qw2, activation="silu"), dict(w2=w2, activation="silu")
                extra = nbytes(qw2.values, qw2.scales)
            elif epi == "bias":
                b = rnd(g, dtype, f)
                kw = dense_kw = dict(bias=b)
                extra = nbytes(b)
            elif epi == "residual":
                r = rnd(g, dtype, 4, rows, f)
                kw = dense_kw = dict(residual=r)
                extra = nbytes(r)
            elif epi == "all":
                b, r = rnd(g, dtype, f), rnd(g, dtype, 4, rows, f)
                kw = dense_kw = dict(bias=b, residual=r, activation="gelu")
                extra = nbytes(b, r)
            qw = pack(w, spec, True)
            out = 4 * rows * f * x.element_size()
            return (lambda: blas.matmul_fused(x, qw, **kw),
                    lambda: blas.matmul_fused(x, w, **dense_kw),
                    nbytes(x, qw.values, qw.scales) + extra + out,
                    2 * 4 * rows * d * f * (2 if epi == "gate" else 1))
        return make

    def gemm_case(dtype, m, k, n, seed, transpose, spec=SERVE_SPEC, epi=False):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a, b = rnd(g, dtype, m, k), rnd(g, dtype, k, n, std=k ** -0.5)
            qb = pack(b, spec, transpose)
            kw, extra = {}, 0
            if epi:
                bias, res = rnd(g, dtype, n), rnd(g, dtype, m, n)
                kw, extra = dict(bias=bias, residual=res, epilogue="gelu"), nbytes(bias, res)
            return (lambda: blas.gemm(a, qb, **kw), lambda: blas.gemm(a, b, **kw),
                    nbytes(a, qb.values, qb.scales) + extra + m * n * a.element_size(),
                    2 * m * n * k)
        return make

    def gemv_case(dtype, m, n, seed, spec=SERVE_SPEC):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a, x = rnd(g, dtype, m, n, std=n ** -0.5), rnd(g, dtype, n)
            qa = pack(a, spec, False)
            return (lambda: blas.gemv(qa, x), lambda: blas.gemv(a, x),
                    nbytes(qa.values, qa.scales, x) + m * x.element_size(), 2 * m * n)
        return make

    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    cases = []
    for rows, kernel, dense, what in ((1, "bgemv_int8", "bgemv", "decode"),
                                      (128, "gemm_int8", "bgemm", "prefill")):
        shape = f"4x{rows}x"
        cases += [
            (kernel, dense, f"{what} qkv {shape}2048->2048 +bias", bf16,
             proj_case(bf16, rows, 2048, 2048, 60 + rows, "bias")),
            (kernel, dense, f"{what} wo {shape}2048->2048 +residual", bf16,
             proj_case(bf16, rows, 2048, 2048, 61 + rows, "residual")),
            (kernel, dense, f"{what} gate_up {shape}2048->5632 x2 silu-gate", bf16,
             proj_case(bf16, rows, 2048, 5632, 62 + rows, "gate")),
            (kernel, dense, f"{what} down {shape}5632->2048 +residual", bf16,
             proj_case(bf16, rows, 5632, 2048, 63 + rows, "residual")),
        ]
    for i, (dt, transpose) in enumerate(((f32, False), (f32, True), (bf16, False), (bf16, True))):
        layout = "nk" if transpose else "kn"
        cases.append(("gemm_int8", "gemm", f'gemm "{layout}" {D8K}x{D8K}x{D8K}', dt,
                      gemm_case(dt, D8K, D8K, D8K, 70 + i, transpose)))
    for i, dt in enumerate((f32, f64)):
        cases.append(("gemv_int8", "gemv", f"gemv {N16K}x{N16K}", dt,
                      gemv_case(dt, N16K, N16K, 80 + i)))
    cases += [
        ("bgemv_int8", "bgemv", "ragged decode 4x4097->4095 block (61->45, K) +bias gelu +res", f32,
         proj_case(f32, 1, 4097, 4095, 90, "all", AWKWARD_SPEC)),
        ("gemm_int8", "gemm", 'ragged gemm "kn" (4095,4097)@(4097,4093) block (61->17, N) '
         "+bias gelu +res", f32, gemm_case(f32, 4095, 4097, 4093, 91, False, AWKWARD_SPEC, True)),
        ("gemv_int8", "gemv", "ragged gemv 4095x4097 block (61->45, K)", f32,
         gemv_case(f32, 4095, 4097, 92, AWKWARD_SPEC)),
    ]
    return cases


def phase_quant_kernels():
    """Drive every int8 case once through core.blas with the launch counts
    reset just before (each call must add exactly one launch to its packed
    kernel's count), hold it against its plain version, then time it beside
    its bound, its plain version and the dense kernel at the same shape."""
    from repro_torch.kernels import ops
    cases = quant_cases()
    errs = []
    ops.reset_launch_counts()
    for kernel, _, case, dtype, make in cases:
        call, _, _, _ = make()
        before = ops.launch_counts()
        got = call()
        after = ops.launch_counts()
        with ops.reference_mode():
            want = call()
        torch.cuda.synchronize()
        rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        err = (got.double() - want.double()).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(got).all()) and got.dtype == dtype and got.shape == want.shape
              and torch.allclose(got.double(), want.double(), **tol))
        errs.append((err, ok))
        if not ok or rose != {kernel: 1}:
            emit("quant_kernels", kernel=kernel, case=case, dtype=str(dtype).split(".")[1],
                 max_abs_err=err, tol=tol, within_tol=ok, launches_added=rose)
            raise AssertionError(f"int8 [{case}] {dtype}: within_tol={ok}, launches added "
                                 f"{rose} (want {{{kernel!r}: 1}})")
        del call, got, want
    counts = ops.launch_counts()
    emit("launches", run="quant_kernels", **counts)
    for kernel in ("bgemv_int8", "gemm_int8", "gemv_int8"):
        expected = sum(c[0] == kernel for c in cases)
        if counts[kernel] != expected:
            raise AssertionError(f"int8 launches {counts}: {kernel} {counts[kernel]} != {expected}")

    rows = {}
    for (kernel, dense, case, dtype, make), (err, ok) in zip(cases, errs):
        call, dense_call, nb, flops = make()
        ms = time_auto(call)
        with ops.reference_mode():
            plain_ms = time_auto(call)
        dense_ms = time_auto(dense_call)
        b_ms, by = bound(nb, flops, dtype)
        row = dict(kernel=kernel, case=case, dtype=str(dtype).split(".")[1], max_abs_err=err,
                   tol=TOL[dtype], within_tol=ok, kernel_ms=ms, plain_ms=plain_ms,
                   dense_kernel=dense, dense_ms=dense_ms, bound_ms=b_ms, bound_by=by,
                   share_of_bound=b_ms / ms, bytes=nb, flops=flops)
        emit("quant_kernels", **row)
        rows[(kernel, case, row["dtype"])] = row
        del call, dense_call
    return rows, counts


def phase_quantize(params):
    """Pack the full model's projections on the card (timed), then hold one
    layer's packed weights bitwise against quantize on the CPU."""
    from repro_torch.core import quant
    from repro_torch.models import layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = layers.quantize_weights(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    spec = quant.QuantSpec(transpose=True, **SERVE_SPEC)
    mism = []
    layer, qlayer = params["layers"][11], qparams["layers"][11]
    for group, key in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                       ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")):
        want = quant.quantize(layer[group][key].cpu(), spec)
        got = qlayer[group][key]
        if not (torch.equal(got.values.cpu(), want.values)
                and torch.equal(got.scales.cpu(), want.scales) and got.block == want.block):
            mism.append(key)
    packed = sum(q.values.numel() + 4 * q.scales.numel() for lp in qparams["layers"]
                 for grp in ("attn", "ffn") for q in lp[grp].values() if quant.is_quantized(q))
    dense = sum(nbytes(w) for lp in params["layers"] for grp in ("attn", "ffn")
                for k, w in lp[grp].items() if k in layers.QUANT_WEIGHT_KEYS)
    emit("quantize", what="layers.quantize_weights, stablelm-1.6b FULL bf16, on the card",
         seconds=seconds, layer_checked=11, bitwise_equal_to_cpu=not mism, mismatched=mism,
         packed_projection_bytes=packed, bf16_projection_bytes=dense)
    if mism:
        raise AssertionError(f"quantize on the card differs from the CPU for {mism}")
    return qparams


def phase_smoke_int8():
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH, "smoke")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
    kw = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, prompts=prompts, quantize="int8",
              params=tf.init_params(cfg, 0, "cuda"), verbose=False, device="cuda")
    got = serve(ARCH, "smoke", **kw)
    with ops.reference_mode():
        want = serve(ARCH, "smoke", **kw)
    equal = got["outputs"] == want["outputs"]
    emit("smoke_int8", dtype="float32", quantize="int8", requests=len(prompts),
         completed=got["completed"], tokens_equal=equal, outputs=got["outputs"])
    if not equal or got["completed"] != len(prompts):
        raise AssertionError(f"int8 smoke serve: kernels {got['outputs']} != plain "
                             f"{want['outputs']}")


def phase_serve_int8(params, cfg, bf16_outputs):
    """The full-width serve with --quantize int8 (serve() packs `params`
    before its timed region); counts are read by the caller."""
    from repro_torch.launch.serve import serve
    stats = serve(ARCH, "full", requests=8, batch=4, prompt_len=128, gen=32, seed=0, eos=-1,
                  params=params, quantize="int8", device="cuda")
    same = [a == b for o, p in zip(stats["outputs"], bf16_outputs) for a, b in zip(o, p)]
    in_range = all(0 <= t < cfg.vocab for o in stats["outputs"] for t in o)
    emit("serve_int8", arch=ARCH, variant="full", dtype="bfloat16", quantize="int8",
         requests=8, batch=4, prompt_len=128, gen=32, completed=stats["completed"],
         tokens=stats["tokens"], tok_s=stats["tok_s"], elapsed_s=stats["elapsed_s"],
         ttft_p50_s=statistics.median(stats["ttft"]), prefills=stats["prefills"],
         decode_steps=stats["decode_steps"], occupancy=stats["occupancy"],
         greedy_agreement_with_bf16=sum(same) / len(same))
    if stats["completed"] != 8 or not in_range or any(len(o) != 32 for o in stats["outputs"]):
        raise AssertionError(f"int8 full serve: completed {stats['completed']}/8, "
                             f"tokens in range {in_range}")
    return stats


def check_int8_launches(counts: dict, what: str, prefills: int, decode_steps: int):
    """Every projection on the packed kernels: 6 a layer (q, k, v, wo,
    gate+up, down) x 24 layers for each prefill and each decode step, and
    no dense projection launch."""
    per = 24 * 6
    want = {"bgemv_int8": per * decode_steps, "gemm_int8": per * prefills,
            "bgemv": 0, "bgemm": 0, "attention": 24 * (prefills + decode_steps)}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{what} launches {counts}: (got, want) {bad}")


def check_launches(counts: dict, what: str):
    layers_x_proj = 24 * 6
    bad = [k for k in ("bgemv", "bgemm", "attention") if counts[k] == 0]
    bad += [k for k in ("bgemv", "bgemm") if counts[k] % layers_x_proj]
    if counts["attention"] % 24:
        bad.append("attention")
    if bad:
        raise AssertionError(f"{what} launches {counts}: {bad} never launched or "
                             f"not a whole number of 24-layer forwards")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config

    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = _build.build()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds,
         library=str(lib.relative_to(HERE)))
    (OUT / "ptxas.txt").write_text(_build.build_log)

    with torch.inference_mode():
        rows = phase_kernels()
        phase_smoke()

        cfg = get_config(ARCH, "full")
        params = tf.init_params(cfg, 0, "cuda")
        ops.reset_launch_counts()
        bf16_outputs = phase_serve(params, cfg)
        serve_counts = ops.launch_counts()
        emit("launches", run="serve", **serve_counts)
        check_launches(serve_counts, "serve")
        ops.reset_launch_counts()
        phase_forced(params, cfg)
        forced_counts = ops.launch_counts()
        emit("launches", run="forced", **forced_counts)
        check_launches(forced_counts, "forced")
        phase_profile(params, cfg)
        qparams = phase_quantize(params)
        phase_smoke_int8()
        ops.reset_launch_counts()
        int8_stats = phase_serve_int8(params, cfg, bf16_outputs)
        int8_counts = ops.launch_counts()
        emit("launches", run="serve_int8", **int8_counts)
        # the serve's warm-up runs one prefill and one decode step first
        check_int8_launches(int8_counts, "serve_int8", int8_stats["prefills"] + 1,
                            int8_stats["decode_steps"] + 1)
        ops.reset_launch_counts()
        phase_forced(qparams, cfg, phase="forced_int8")
        forced_int8 = ops.launch_counts()
        emit("launches", run="forced_int8", **forced_int8)
        check_int8_launches(forced_int8, "forced_int8", 1, 3)
        phase_profile(qparams, cfg, phase="profile_int8")
        del params, qparams
        blas_rows, blas_counts = phase_blas()
        quant_rows, quant_counts = phase_quant_kernels()

    sources = {"bgemv": ("src/repro_torch/csrc/bgemv.cu", "src/repro/kernels/bgemv.py:230",
                         "qkv 4x2048->2048 +bias"),
               "bgemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/bgemm.py:217",
                         "qkv (4,128,2048)@(2048,2048) +bias"),
               "attention": ("src/repro_torch/csrc/attention.cu",
                             "src/repro/kernels/attention.py:329",
                             "decode B=4 Tq=1 H=32 D=64 S=160")}
    summary = []
    for name, (src, replaces, case) in sources.items():
        r = rows[(name, case, "bfloat16")]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": serve_counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": case, "dtype": "bfloat16"})
    # the BLAS kernels: f64 (the paper's D-prefix routines) at full size,
    # launches from the blas phase
    blas_sources = {
        "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:184",
                 ("gemm", f"{D8K}x{D8K}x{D8K}")),
        "gemv": ("src/repro_torch/csrc/gemv.cu", "src/repro/kernels/gemv.py:146",
                 ("gemv", f"{N16K}x{N16K}")),
        "blas1_reduce": ("src/repro_torch/csrc/blas1.cu", "src/repro/kernels/blas1.py:55",
                         ("dot", "n=2^26")),
        "blas1_axpy": ("src/repro_torch/csrc/blas1.cu", "src/repro/kernels/blas1.py:92",
                       ("axpy", "n=2^26")),
    }
    for name, (src, replaces, (routine, case)) in blas_sources.items():
        r = blas_rows[(routine, case, "float64")]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": blas_counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": f"{routine} {case}", "dtype": "float64"})
    # the packed kernels: launches from the int8 serve (bgemv_int8, gemm_int8)
    # and from the packed BLAS run of phase 10 (gemv_int8)
    quant_sources = {
        "bgemv_int8": ("src/repro_torch/csrc/qgemv.cu", "src/repro/kernels/bgemv.py:230",
                       "decode qkv 4x1x2048->2048 +bias", "bfloat16", int8_counts),
        "gemm_int8": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/bgemm.py:217",
                      "prefill qkv 4x128x2048->2048 +bias", "bfloat16", int8_counts),
        "gemv_int8": ("src/repro_torch/csrc/qgemv.cu", "src/repro/kernels/gemv.py:146",
                      f"gemv {N16K}x{N16K}", "float32", quant_counts),
    }
    for name, (src, replaces, case, dtype, counts) in quant_sources.items():
        r = quant_rows[(name, case, dtype)]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "dense_ms": r["dense_ms"], "shape": case, "dtype": dtype})
    (OUT / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
