#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (nonzero exit):

1. device  - nvidia-smi's name and power limit, torch's device name;
2. build   - nvcc builds the kernels from csrc/, one process a file (timed),
             and beside them the designs four redesigns replaced
             (scripts/replaced/: the packed GEMV's, WKV6's, the SSD's and
             the f32 attention route's first designs), each a library of its
             own, timed in phases 3, 10, 14, 20, 24, 33 and 38 and
             profile_prefill_zamba;
   sass    - the HGMMA (wgmma) instructions cuobjdump finds in each
             tensor-core GEMM kernel (csrc/gemm_sm90.cu, the odd-N
             instantiations too; none, or a spill, fails the run), with
             ptxas's registers, spills and notes and the kernel's dynamic
             shared memory; the same for the HMMA (mma.sync) of each
             tensor-core attention kernel (csrc/attention_mma.cu; none fails
             the run), and ptxas's registers and spills for the split-KV
             decode kernels (csrc/attention_splitkv.cu); the DMMA (f64
             mma.sync) in each f64 GEMM kernel (csrc/gemm_f64.cu; none, or a
             spill, fails the run) and ptxas for bgemv (csrc/bgemv.cu,
             bgemv_rows.cu and bgemv_members.cu: 72 instantiations, a spill
             fails the run); the
             FFMA in each f32 GEMM kernel on the TMA ring (csrc/gemm_f32.cu)
             with its ptxas registers and spills (none, or a spill, fails);
             the HMMA (mma.sync) in csrc/qgemv.cu's tensor-core kernels (none
             fails the run), ptxas's registers and spills for csrc/qgemv.cu
             and csrc/rwkv6.cu; the HMMA in csrc/mamba2.cu's bf16 outputs
             kernel, with ptxas for the file (no HMMA, or a spill, fails),
             and DMMA in csrc/gemm_f64.cu
             kernels of both copy widths (16 and 8 bytes) or the run fails;
             HGMMA in the 4 2-D int8 "kn" instantiations of
             csrc/gemm_sm90.cu and DMMA in the 6 of csrc/gemm_f64_q8.cu
             (packed B under f64 A), none spilling, or the run fails;
             FFMA in each of csrc/attention.cu's 40 instantiations (the f32
             route "ffma"), with no tensor-core instruction and no spill, or
             the run fails;
3. kernels - bgemv, bgemm and flash attention, each against its plain
             PyTorch version on the card at the stablelm-1.6b serving shapes
             (bgemv and bgemm also at zamba2-1.2b's), in bf16 and f32, with
             times beside the card's bound and one PyTorch call; each bgemv
             case prints its plan (`kernels.bgemv.plan`: tile, K splits,
             rows) and a split one is held bitwise against a second launch;
             each GEMM case prints the
             plan `kernels.gemm.plan` gives it (route, tile, K slices), adds
             one launch on that route, and, where that is not the first
             CUDA-core kernel, the time of that kernel (csrc/gemm.cu on the
             same inputs); a split-K or "ffma_sm90" case is also held
             bitwise against a second launch; each attention case
             prints its plan (`kernels.attention.plan`: route "splitkv" at
             decode, "mma" for the bf16 prefill, "ffma" for f32; splits,
             the "ffma" tile) and the time of the f32 route's first design
             (scripts/replaced/attention_first.cu) on the same inputs
             (replaced_ms), every case held bitwise against a second
             launch;
   gemm_precision - the share of bf16 outputs of the tensor-core GEMM,
             the CUDA-core one and the plain version that equal the
             correctly rounded f64 product, at five prefill shapes ("wgmma")
             and two odd ones ("wgmma staged": the BLAS (4095, 4097) @
             (4097, 4093) and K = 7167); the tensor-core kernel may not fall below the
             plain version's share by more than ROUNDING_SLACK;
4. smoke   - stablelm-1.6b SMOKE served in f32 through the kernels and again
             through the plain versions: equal greedy tokens, every gemm and
             bgemm launch on the f32 TMA-ring route "ffma_sm90" (also for
             every f32 serve of smoke_kv, serve_batch, smoke_rwkv and
             smoke_zamba);
5. serve   - stablelm-1.6b FULL (published widths, seeded random weights),
             bf16: 8 requests, batch 4, prompt 128, gen 32, all logits finite;
6. forced  - prefill + 3 decode steps at full width, kernels vs plain on the
             same tokens: logits within the stated bf16 tolerance;
7. launches - each serving kernel's launch count from phase 5 (and 6); every
             bf16 prefill projection counted on the tensor-core route (also
             for serve_int8, serve_rwkv and serve_zamba: "routes" lines);
8. profile - torch.profiler over full-width decode steps: device time by
             kernel (attention's and bgemv's apart) and the device's idle
             share; one bgemv device launch a bgemv call (144 a stablelm
             step, 240 rwkv6, 112 zamba2) and one qgemv device launch a
             packed one (144 an int8 step), or the run fails (a profile
             whose kernel counts come up short, and none long, is taken
             again, up to PROFILE_ATTEMPTS in all: the profiler loses a
             kernel record now and then; every window opens with
             PROFILE_HEAD_SLEEPS sleep kernels, left out of every count, so
             the records lost at its start are theirs);
             profile_prefill the same over full-width prefills (wall, device
             busy, the tensor-core GEMM's and attention's shares; for rwkv6,
             profile_prefill_rwkv, the WKV6 kernels' ms and device launches,
             three an ops.rwkv6 call or the run fails); every
             serve's attention launches are checked by route ("routes"
             lines: the bf16 serves' prefills on "mma" and decode steps on
             "splitkv", the f32 smoke serve's prefills on "ffma");
9. blas    - the BLAS library (`repro_torch.core.blas`: gemm, gemv,
             batched_gemv, dot, nrm2, axpy) at full size in f64, f32 and
             bf16 (batched_gemv: one A a member at (32, 2048, 2048) and
             (4096, 32, 32), both ops, a broadcast A at (4, 8192, 8192), and
             ops.bgemv's epilogue on a ragged (3, 257, 131); short members
             on csrc/bgemv_members.cu: (4096, 32, 32) in every dtype, (4096,
             64, 64) bf16, a ragged (1000, 37, 19) off 16 bytes, the gate,
             members at and just past kernels.bgemv.MEMBER_MAX_BYTES; every
             bgemv case bitwise on a second launch and timed beside the
             first design's plan (replaced_ms), and two short shapes bitwise
             alone and in a batch of 4096), each call held
             against its plain version and counted as one launch of its
             kernel (gemm, gemv, bgemv, blas1 reduce, blas1 axpy; a bgemv
             also on the form its plan names, a gemm on
             the route its plan names: every dense f64 call on the f64
             tensor cores (16-byte copies, or 8-byte ones for odd K or N),
             bf16 on wgmma, where TMA cannot address it (odd K or N) on
             copies with padded rows, f32 with K and N multiples of 4 on the TMA ring
             (8192^3, an aligned ragged case, zamba2's LoRA merge), odd f32
             on the first CUDA-core kernel; the plain product at (4095, 4097)
             @ (4097, 4093) in each dtype beside torch.matmul; axpy, also
             ragged and one
             element in, bitwise the plain version); then each timed beside
             its bound and one PyTorch library call (a gemm off "ffma" also
             beside the first CUDA-core kernel);
10. quant_kernels - block-scaled int8 weights through core.blas: the decode
             projections (packed bgemv), the prefill projections (int8-B
             bgemm, "nk"), gemm "kn"/"nk" 8192^3 under f32, bf16 and f64 A
             and gemv 16384^2 with packed operands, ragged awkward-block
             cases (bf16 "kn" with the gate and with the epilogue; f32 on
             the CUDA-core tile, f64 on staged rows); each counted as one
             launch of its packed
             kernel, held against its plain version (under f64 A also
             bitwise against the dense launch on the dequantized B), then
             timed beside its bound, the dense kernel at the same shape and,
             a GEMM, csrc/gemm.cu's int8-B kernel (ffma_ms), each GEMM
             bitwise a second launch; each packed GEMV also prints its plan
             (`kernels.bgemv.plan_int8`: rows, K splits, columns), is held
             bitwise against a second launch and timed beside the first
             design (replaced_ms);
11. quantize - `layers.quantize_weights` on the full stablelm-1.6b weights on
             the card, one layer bitwise equal to the CPU's quantize;
12. smoke_int8 - the SMOKE serve with --quantize int8: kernels and plain
             versions give equal greedy tokens;
13. serve_int8, forced_int8, launches, profile_int8 - the FULL serve with
             --quantize int8 (8/8 complete, greedy agreement with the bf16
             serve), the teacher-forced run (logits within 5% of max |logit|
             of the plain path), the launch counts of both (every projection
             on the packed kernels, 144 a decode step and 144 a prefill, none
             dense), and phase 8's profile of the int8 decode step;
14. attention_kv - the int8-K/V and paged forms of flash attention: full-width
             decode (B=4, H=32, D=64, S=160, page 16, shuffled table; GQA
             32/8), the int8 prefill and the bf16 prefill over the page pool
             (Tq=128), long context (S=4096, bf16 and int8, dense and paged)
             and a ragged f32 case (page 7, GQA 32/8, D=128); each one launch
             of its form on its plan's route, against its plain version, a
             paged launch bitwise the dense launch on the gathered cache, two
             launches bitwise equal, then timed beside its bound, sdpa, the
             dense kernel and the f32 route's first design
             (scripts/replaced/attention_first.cu, replaced_ms); f32
             prefills at the smoke head dims (D = 16 and 32, Tq off the
             tile, kv lengths past Tq, NaN past them; dense, paged P = 7,
             int8) also hold a slot's rows bitwise equal alone and in the
             batch;
15. smoke_kv - SMOKE f32 serves with --kv-cache int8 and --kv-page-size 4
             (prefix reuse on and off, a 7-page pool that preempts): kernels
             and plain versions give equal tokens, paged equal dense, the
             small pool equal the default pool;
16. serve_paged - FULL bf16, 8 requests sharing a 96-token system prompt,
             page 16: tokens equal the dense serve's, pages shared, then a
             pool of ~2/3 the peak pages that preempts: every stretch
             between two admissions equals a dense serve started from that
             admission's prompt + emitted tokens (the agreement with the
             unpressured tokens is recorded, not required: see PERF.md);
17. serve_kv_int8, forced_kv_int8 - FULL --kv-cache int8, dense and paged,
             bf16 and int8 weights: paged tokens equal dense; forced logits
             within 5% of max |logit| of the plain path; pool bytes;
18. profile_kv_int8 - phase 8's profile with the int8 KV cache.  Every serve
             above checks its attention launches by form: a paged decode
             runs only the paged form, an int8 cache only the int8 one;
19. serve_batch - the batch scheduler (--scheduler batch): SMOKE f32 serves
             (dense, int8 KV, paged page 4, a 7-page pool that preempts),
             kernels vs plain versions equal tokens, the small pool the
             default pool's; stablelm-1.6b FULL bf16, 8/8 complete, its
             tokens' agreement with phase 5's continuous serve and its tok/s;
20. wkv6   - the chunked WKV6 kernel against its plain version: the prefill
             shape (BH=128, T=128, bf16 r/k/v, f32 w/u) from zero and from a
             state, long (T=4096), ragged (T=100), f32 at the smoke widths,
             strong decay; each one launch (three device launches), y and
             the final state within TOL, bitwise a second launch, timed
             beside its bound (and the bound with the design's workspace
             traffic), its exp count, the plain version and the serial first
             design (replaced_ms);
21. rwkv_kernels - bgemv and bgemm at the shapes rwkv6-1.6b adds (the decay
             LoRA 2048->64->2048, the channel mix 2048<->7168), decode and
             prefill, against their plain versions, timed;
22. smoke_rwkv, serve_rwkv - rwkv6-1.6b SMOKE (f32) under --scheduler batch,
             kernels vs plain equal tokens at batch 2 and batch 1; FULL bf16 (seeded random
             weights), 8 requests, batch 4, prompt 128, gen 32: 8/8, finite
             logits, one rwkv6 launch a layer a prefill and none at decode,
             240 bgemv a decode step and 240 bgemm a prefill, no attention;
23. forced_rwkv, profile_rwkv - prefill + 3 decode steps at full width:
             every rwkv6 launch against the plain version on its inputs (y
             bf16 TOL, state f32 TOL), every block teacher-forced on the
             plain path's activations within 2% of max |plain| (state
             0.2%), the end-to-end logits no further from the f32 path than
             the plain bf16 path's plus 2% of max |logit|; phase 8's
             profile of the rwkv decode step;
24. ssd     - the chunked Mamba2 SSD kernel against its plain version: the
             zamba2 prefill shape (BH=256, T=128, P=N=64, chunk 64, bf16
             x/b/c, f32 a/h) from zero and from h0, long (T=4096, B=1),
             ragged (T=100), f32 at the smoke widths (P=N=16, chunk 8),
             strong decay; each one launch (three device launches), y and
             the final state within TOL, bitwise a second launch, timed beside
             its bound (and the bound with the design's workspace traffic),
             the plain version and the serial first design (replaced_ms),
             with the profiler's device ms by kernel;
25. smoke_zamba - zamba2-1.2b SMOKE (f32) under --scheduler batch, kernels
             vs plain equal tokens at batch 2 and batch 1;
26. serve_zamba - zamba2-1.2b FULL bf16 (seeded random weights), 8
             requests, batch 4, prompt 128, gen 32: 8/8, finite logits, one
             mamba2_ssd launch a Mamba2 block a prefill and none at decode,
             112 bgemm a prefill and 112 bgemv a decode step, 18 LoRA-merge
             gemm (f32, on "ffma_sm90") and 6 attention launches every
             forward;
27. forced_zamba, profile_zamba - prefill + 3 decode steps at full width:
             every mamba2_ssd launch against the plain version on its
             inputs, every Mamba2 block and shared-block occurrence
             teacher-forced on the plain path's activations within 2% of max
             |plain| (SSD state 1%), the end-to-end logits no further from
             the f32 path than the plain bf16 path's plus 2%; phase 8's
             profile of the zamba2 decode step (every profile line also
             gives the f32 ring GEMM's device ms and launches a step: the
             LoRA merges); profile_prefill_zamba: the full-width zamba2
             prefill's device time, the SSD kernels' ms and device launches
             (three an ops.mamba2_ssd call or the run fails), and the same
             prefills again through the serial first design, its SSD ms
             beside.

28. moe_kernels - bgemm's batched launch (a per-expert B, an out_dtype) at
             moonshot-v1-16b-a3b FULL's expert shapes (64 experts, d 2048, f
             1408; 32 rows an expert at decode, 64 at prefill): the gate+up
             dual launch (silu, bf16 out) and the down launch (f32 out) on
             the tensor cores, the packed expert stacks, f32, f64 (packed
             stacks too, bitwise the dense launch on the dequantized
             stacks) and odd K on the kernels of their 2-D counterparts,
             output-major packed stacks under bf16 A on the CUDA-core tile
             (csrc/gemm_batched*.cu); each one launch on its plan's route,
             against its plain version, bitwise a second launch, timed
             beside its bound, the plain version, torch.bmm on the same
             operands (products only) and the CUDA-core tile;
29. smoke_moe - moonshot and grok-1-314b SMOKE (f32), continuous and batch
             schedulers and --quantize int8, kernels vs plain versions equal
             greedy tokens, two batched expert launches a layer a forward;
30. serve_moe - moonshot FULL bf16 (seeded random weights, 57.8 GB): 8
             requests, batch 4, prompt 128, gen 32: 8/8, finite logits, no
             plain version called, every expert launch on the batched
             tensor-core route (2 x 48 a forward), peak device memory;
31. forced_moe - prefill + 3 decode steps at full width: every expert launch
             against its plain version on its inputs, every block
             (`_expert_ffn` on the plain path's dispatch buffer, `moe_layer`
             on its h) within 2% of max |plain|, the logits within 5% of the
             plain path's or no further from an f32 witness (each layer
             upcast as the forward reaches it) than the plain bf16 path's +
             2%; the share of (token, layer) top-6 sets that agree;
32. profile_moe, profile_prefill_moe - phase 8's profiles of moonshot's
             decode step (96 tensor-core GEMM launches a step) and prefill.
33. attention_masks - flash attention under the causal, prefix-LM and
             non-causal masks at D = 64, 128 and 256, decode ("splitkv") and
             prefill ("mma" bf16, "ffma" f32), K/V dense, int8 and paged, at
             the serving shapes (whisper's encoder B=4 H=20 T=1500 D=64 and
             its cross-attention over 1500 frames at Tq=1 and Tq=128;
             paligemma's 4 x (256 + 128)-token prefill, H 8 / KVH 1, D=256,
             prefix 256, and its decode at S ~ 416): each one launch on its
             route counted under its mask, within TOL of its plain version,
             paged bitwise dense, a second launch bitwise, a decode launch
             bitwise the causal one; timed beside its bound, its plain
             version and sdpa with a boolean mask;
34. smoke_family - paligemma-3b (continuous and batch) and whisper-large-v3
             (batch) SMOKE f32, kernels vs plain equal tokens, attention
             launches by route and mask (paligemma's prefills prefix-LM,
             whisper's encoder and cross-attention non-causal) and
             projections counted;
35. serve_vlm, serve_audio - both FULL bf16 (seeded random weights), 8
             requests, batch 4, prompt 128, gen 32 (paligemma continuous and
             batch, whisper batch): 8/8, finite logits, no plain version,
             the launches by route and mask and the projections exact, tok/s,
             TTFT p50, prefill and decode ms, peak memory;
36. forced_vlm, forced_audio - prefill + 3 decode steps at full width:
             every block of the prefill (paligemma's dense block, whisper's
             encoder and decoder blocks) on the plain path's input within 2%
             of max |plain|, the logits within 5% of max |logit| of the plain
             path or no further from an f32 witness than it plus 2%;
37. profile_vlm, profile_prefill_vlm, profile_audio, profile_prefill_audio
             - phase 8's profiles of a full-width decode step and prefill,
             fed the family's patches or frames: besides, exactly the
             attention device launches by route and the wrappers' by mask
             (whisper: 64 "splitkv" a step, 96 "mma" a prefill; paligemma:
             18 and 18) and the step's bgemv calls (108; 256).
38. attention_flat - flash attention on flat (BH, T, D) operands with
             kv_lens None: a causal bf16 prefill (BH=64, T=1024, "mma"), a
             decode over 4096 keys ("splitkv"), GQA g=4 over int8 K/V (both),
             an f32 prefill ("ffma") and a prefix-LM prefill; driven once
             with the counts set to 0 (one flat launch a case on its route),
             each within TOL of its plain version, bitwise a second launch,
             timed beside its bound, its plain version and sdpa; one flat GQA
             call profiled: the attention kernel alone, no copy.

Then a `done` line (the script's seconds), a `kernels` summary line, and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 989 TFLOP/s bf16
dense (tensor cores), 67 TFLOP/s f32 (CUDA cores: FFMA), 67 TFLOP/s f64
(tensor cores; the CUDA cores' DFMA peaks at 34).  Every time is taken with a
cold L2 (time_ms: a read of 256 MB before each launch).  Detail (nvcc's
ptxas report, every number printed) goes to build/chip_smoke/.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
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
# rwkv6 FULL bf16 (forced_rwkv), set from three runs on an H100 80GB HBM3 at
# 700 W that read the same numbers (PERF.md, section 6): a teacher-forced
# block's output within 2% of max |plain| (measured at most 0.94%), its new
# state within 0.2% (measured at most 0.090%); end to end, the kernel path's
# logits no further from the f32 path's than the plain bf16 path's are, plus
# 2% of max |logit| (measured excess at most 0.64%).
RWKV_TF_OUT_TOL = 0.02
RWKV_TF_STATE_TOL = 0.002
RWKV_E2E_MARGIN = 0.02
# zamba2-1.2b FULL bf16 (forced_zamba), stated before its first run as
# forced_rwkv's limits: a teacher-forced Mamba2 block's output (and a shared
# block occurrence's) within 2% of max |plain|, its new SSD state within
# 1%; end to end no further from the f32 path than the plain bf16 path's
# logits are, plus 2% of max |logit|.
ZAMBA_TF_OUT_TOL = 0.02
ZAMBA_TF_STATE_TOL = 0.01
ZAMBA_E2E_MARGIN = 0.02
# torch.profiler loses a kernel record now and then on the H100 (a
# moonshot decode profile read 1436 of its 1440 bgemv launches, an SSD
# call's 2 of its 3), so a profile whose launch counts come up short, and
# none long, is taken again, up to this many in all (profile_until_whole);
# a kernel launched no time or twice reads wrong in every profile
PROFILE_ATTEMPTS = 3
# a paligemma decode-step profile read 107.4 bgemv device launches a step
# for 108 calls in all three attempts (measured on one H100), and the other
# kernels of a step's first norm short too: the first ~20 kernels of a
# profile window go unrecorded.  Every profile window opens with this many
# sleep kernels (profile_by_name; SLEEP_KERNEL names them, left out of every
# count), so what is lost is theirs.
PROFILE_HEAD_SLEEPS = 256
SLEEP_KERNEL = r"spin_kernel|_sleep"
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


def time_ms(fn, iters: int = 20, flush: str = "read") -> float:
    """Median device time of fn over `iters` launches, each with a cold L2:
    a pass over 256 MB evicts the 50 MB cache first (on the serving path
    every layer's weights arrive from HBM).  `flush` "read" sums the buffer,
    leaving clean lines; "write" zeroes it, and the timed launch then pays
    for writing those dirty lines back: measured on the H100
    (scripts/torch_gemm_study.py flush, PERF.md), the qkv bgemv took 15.8 us
    and addmm 11.5 after the write, 14.8 and 10.4 after the read (2^26 f64
    axpy 0.550 / 0.541 ms).  A device-side sleep before each launch keeps
    the queue full while the host enqueues fn, so the events time the
    device's work and not the host's Python overhead."""
    global _flush
    if _flush is None:
        _flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    evict = _flush.sum if flush == "read" else _flush.zero_
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        evict()
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
# phase 2b: the tensor-core kernel's machine code
# --------------------------------------------------------------------------

def _tc_config(mangled: str):
    """(BM, BN, GATE, Q) of a mangled gemm_tc_kernel<BM, BN, GATE, Q, ODD, BATCHED, TO>
    name (Q: 0 bf16 B, 1 int8 "nk", 2 int8 "kn")."""
    m = re.search(r"gemm_tc_kernelILi(\d+)ELi(\d+)ELb(\d)ELi(\d)E", mangled)
    return tuple(int(v) for v in m.groups()) if m else None


def _tc_name(mangled: str) -> str:
    """'BMxBN [gate] [int8 nk|kn] [odd] [batched] [f32 out]' for a
    gemm_tc_kernel instantiation (odd: the epilogue for an odd N or a C off
    4 bytes; batched: the batched-B form's rank-3 maps; f32 out: C in f32,
    the MoE's down projection)."""
    cfg = _tc_config(mangled)
    if cfg is None:
        return mangled[:60]
    bm, bn, gate, q = cfg
    head = r"gemm_tc_kernelILi\d+ELi\d+ELb\dELi\d"
    odd = re.search(head + r"ELb1E", mangled)
    batched = re.search(head + r"ELb\dELb1E", mangled)
    f32 = re.search(head + r"ELb\dELb\dEfE", mangled)
    return (f"{bm}x{bn}" + (" gate" if gate else "") + ("", " int8 nk", " int8 kn")[q]
            + (" odd" if odd else "") + (" batched" if batched else "")
            + (" f32 out" if f32 else ""))


def _attn_name(mangled: str):
    """'mma bf16 D=64' / 'splitkv bf16/int8 D=64 G4' / 'ffma f32/int8 D=256
    32x32' for an attention kernel instantiation (csrc/attention_mma.cu,
    csrc/attention_splitkv.cu, csrc/attention.cu: query x key tile), with
    ' prefix' for the prefix-LM / non-causal instantiation and ' strided' for
    the flat layout's (q and out strided), else None."""
    types = {"13__nv_bfloat16": "bf16", "S1_": "bf16", "f": "f32", "a": "int8"}
    masks = {"0": "", "1": " prefix"}
    layouts = {"0": "", "1": " strided"}
    m = re.search(r"attention_mma_kernelI(13__nv_bfloat16|a)Li(\d+)ELb(\d)ELb(\d)EE", mangled)
    if m:
        return f"mma {types[m.group(1)]} D={m.group(2)}{masks[m.group(3)]}{layouts[m.group(4)]}"
    m = re.search(r"attention_splitkv_kernelI(13__nv_bfloat16|f)(S1_|f|a)Li(\d+)ELi(\d+)EE",
                  mangled)
    if m:
        return f"splitkv {types[m.group(1)]}/{types[m.group(2)]} D={m.group(3)} G{m.group(4)}"
    m = re.search(r"attention_kernelI(f|a)Li(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb(\d)EE", mangled)
    if m:
        return (f"ffma f32/{types[m.group(1)]} D={m.group(2)} "
                f"{m.group(3)}x{m.group(4)}{masks[m.group(5)]}{layouts[m.group(6)]}")
    return None


def _bgemv_name(mangled: str):
    """'bgemv f32 [gate] [batched]' (csrc/bgemv.cu, op = A^T), 'bgemv_rows
    f64 [gate] [batched] rows=R' (csrc/bgemv_rows.cu, op = A, R rows a
    warp) or 'bgemv_members bf16 [gate] t|n chunk=16B|1 [wide]' (csrc/
    bgemv_members.cu, the short-member body of either op; wide: op = A rows
    of more than 32 chunks) for a bgemv kernel instantiation, else None."""
    m = re.search(r"bgemv_members_kernelI(f|d|13__nv_bfloat16)Lb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                  mangled)
    if m:
        t, gate, trans, vec, wide = m.groups()
        return (f"bgemv_members {dict(f='f32', d='f64').get(t, 'bf16')}"
                + (" gate" if gate == "1" else "") + (" t" if trans == "1" else " n")
                + (" chunk=16B" if vec == "1" else " chunk=1") + (" wide" if wide == "1" else ""))
    m = re.search(r"(bgemv(?:_rows)?)_kernelI(f|d|13__nv_bfloat16)Lb(\d)ELb(\d)E(?:Li(\d+)E)?",
                  mangled)
    if m is None:
        return None
    kernel, t, gate, batched, rows = m.groups()
    return (f"{kernel} {dict(f='f32', d='f64').get(t, 'bf16')}" + (" gate" if gate == "1" else "")
            + (" batched" if batched == "1" else "") + (f" rows={rows}" if rows else ""))


def _f64_config(mangled: str):
    """(BM, BN, BK, STAGES, MI, KI, GATE, VEC, BATCHED) of a gemm_f64_kernel
    instantiation (VEC: doubles a cp.async copies), else None."""
    m = re.search(r"gemm_f64_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)"
                  r"ELi(\d+)ELb(\d)E", mangled)
    return tuple(int(v) for v in m.groups()) if m else None


def _f64_name(mangled: str):
    """'BMxBN [gate] mMIn8kKI BK=.. S=.. copy=..B [batched]' for a
    gemm_f64_kernel instantiation, else None."""
    cfg = _f64_config(mangled)
    if cfg is None:
        return None
    bm, bn, bk, stages, mi, ki, gate, vec, batched = cfg
    return (f"{bm}x{bn}" + (" gate" if gate else "") + f" m{mi}n8k{ki} BK={bk} S={stages}"
            f" copy={8 * vec}B" + (" batched" if batched else ""))


def _f64_q8_name(mangled: str):
    """'BMxBN [gate] kn|nk' for a gemm_f64_q8_kernel instantiation
    (csrc/gemm_f64_q8.cu), else None."""
    m = re.search(r"gemm_f64_q8_kernelI.*?TileILi(\d+)ELi(\d+)ELi\d+ELi\d+ELi\d+ELb(\d)EEELi(\d)E",
                  mangled)
    if m is None:
        return None
    bm, bn, gate, layout = (int(v) for v in m.groups())
    return f"{bm}x{bn}" + (" gate" if gate else "") + (" nk" if layout else " kn")


def _mma_name(mangled: str):
    """'ssd outputs bf16|f32' / 'ssd states ..' / 'ssd scan V=.. U=..' for
    csrc/mamba2.cu's kernels, else None."""
    m = re.search(r"ssd_(states|outputs)_kernel(I13__nv_bfloat16|IfE)", mangled)
    if m:
        return f"ssd {m.group(1)} " + ("bf16" if "bfloat16" in m.group(2) else "f32")
    m = re.search(r"ssd_scan_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"ssd scan V={m.group(1)} U={m.group(2)}"
    return None


def _f32_name(mangled: str):
    """'BMxBN TMxTN [gate] [batched] [odd]' for a gemm_f32_kernel
    instantiation (csrc/gemm_f32.cu, csrc/gemm_f32_odd.cu), else None."""
    m = re.search(r"gemm_f32_kernelI.*?CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)EE+Lb(\d)E"
                  r"Lb(\d)E", mangled)
    if m is None:
        return None
    bm, bn, tm, tn, gate, batched, odd = (int(v) for v in m.groups())
    return (f"{bm}x{bn} {tm}x{tn}" + (" gate" if gate else "") + (" batched" if batched else "")
            + (" odd" if odd else ""))


def _f32_q8_name(mangled: str):
    """'BMxBN TMxTN [gate] kn|nk' for a gemm_f32_q8_kernel instantiation
    (csrc/gemm_f32_q8.cu), else None."""
    m = re.search(r"gemm_f32_q8_kernelI.*?CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)EEELi(\d)E",
                  mangled)
    if m is None:
        return None
    bm, bn, tm, tn, gate, layout = (int(v) for v in m.groups())
    return f"{bm}x{bn} {tm}x{tn}" + (" gate" if gate else "") + (" nk" if layout else " kn")


def phase_sass(lib: Path) -> dict:
    """HGMMA (wgmma) instructions in each tensor-core GEMM kernel, HMMA
    (mma.sync) in each tensor-core attention kernel and DMMA (f64 mma.sync)
    in each f64 GEMM kernel of the built library (cuobjdump -sass), and
    ptxas's registers, shared memory, spills and performance notes for them,
    for the split-KV attention kernels and for bgemv (this process's build
    log); FFMA in each f32 GEMM kernel on the TMA ring (csrc/gemm_f32.cu)
    (csrc/gemm_f32.cu, its ODD instantiations in csrc/gemm_f32_odd.cu) with
    its ptxas registers and spills, and in each instantiation of its int8
    feed (csrc/gemm_f32_q8.cu), with their tensor-core instructions; FFMA
    and tensor-core instructions
    in each instantiation of the f32 attention route (csrc/attention.cu).
    Fails if a tensor-core kernel holds no HGMMA, HMMA or DMMA, an f32 ring
    kernel no FFMA, or an f64 or f32 one spills; unless there are 12 ODD
    ring instantiations and 14 int8 ones, each with FFMA, the int8 ones with
    no tensor-core instruction and, where this process built them, no
    spill; or unless each of the 40
    f32 attention instantiations holds FFMA, no tensor-core instruction and,
    where this process built it, spills nothing."""
    from repro_torch.kernels import _build
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    hgmma, hmma, dmma, ffma, qhmma, mma, fn = {}, {}, {}, {}, {}, {}, None
    dmma_q8 = {}  # csrc/gemm_f64_q8.cu
    attn_ffma, attn_tc, ffma_fn = {}, {}, None  # csrc/attention.cu: FFMA, tensor cores
    q8_ffma, q8_tc, q8_fn = {}, {}, None  # csrc/gemm_f32_q8.cu: FFMA, tensor cores
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            ffma_fn = _attn_name(fn) if "attention_kernel" in fn else None
            q8_fn = _f32_q8_name(fn)
            if q8_fn:
                q8_ffma[q8_fn] = q8_tc[q8_fn] = 0
            if "gemm_tc_kernel" in fn:
                hgmma[_tc_name(fn)] = 0
            elif (_attn_name(fn) or "").startswith("mma"):
                hmma[_attn_name(fn)] = 0
            elif ffma_fn:
                attn_ffma[ffma_fn] = attn_tc[ffma_fn] = 0
            elif _f64_name(fn):
                dmma[_f64_name(fn)] = 0
            elif _f64_q8_name(fn):
                dmma_q8[_f64_q8_name(fn)] = 0
            elif _f32_name(fn):
                ffma[_f32_name(fn)] = 0
            elif "qgemv_tc_kernel" in fn:
                qhmma["gate" if "Lb1E" in fn else "plain"] = 0
            elif _mma_name(fn):
                mma[_mma_name(fn)] = 0
        elif fn and _mma_name(fn) in mma and re.search(r"\bHMMA\b", line):
            mma[_mma_name(fn)] += 1
        elif q8_fn:
            if re.search(r"\bFFMA\b", line):
                q8_ffma[q8_fn] += 1
            elif re.search(r"\b(HMMA|HGMMA|DMMA|IMMA|IGMMA|QGMMA|BMMA|BGMMA)\b", line):
                q8_tc[q8_fn] += 1
        elif ffma_fn:
            if re.search(r"\bFFMA\b", line):
                attn_ffma[ffma_fn] += 1
            elif re.search(r"\b(HMMA|HGMMA|DMMA|IMMA|IGMMA|QGMMA|BMMA|BGMMA)\b", line):
                attn_tc[ffma_fn] += 1  # (HFMA2.MMA is a move, not a matrix product)
        elif fn and "gemm_tc_kernel" in fn and re.search(r"\bHGMMA\b", line):
            hgmma[_tc_name(fn)] += 1
        elif fn and _attn_name(fn) in hmma and re.search(r"\bHMMA\b", line):
            hmma[_attn_name(fn)] += 1
        elif fn and _f64_name(fn) in dmma and re.search(r"\bDMMA\b", line):
            dmma[_f64_name(fn)] += 1
        elif fn and _f64_q8_name(fn) in dmma_q8 and re.search(r"\bDMMA\b", line):
            dmma_q8[_f64_q8_name(fn)] += 1
        elif fn and _f32_name(fn) in ffma and re.search(r"\bFFMA\b", line):
            ffma[_f32_name(fn)] += 1
        elif fn and "qgemv_tc_kernel" in fn and re.search(r"\bHMMA\b", line):
            qhmma["gate" if "Lb1E" in fn else "plain"] += 1
    smem = _build.function("gemm_tc_smem_bytes", [ctypes.c_int] * 4)
    attn_smem = _build.function("attention_mma_smem_bytes", [ctypes.c_int] * 2)
    ptxas, attn_ptxas, f64_ptxas, bgemv_ptxas, f32_ptxas = {}, {}, {}, {}, {}
    q8_ptxas, f64_q8_ptxas = {}, {}
    qgemv_ptxas, wkv6_ptxas, mma_ptxas = {}, {}, {}
    notes, entry = [], None
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, entry = m.group(1), None
            if "gemm_tc_kernel" in fn:
                entry = ptxas[_tc_name(fn)] = {"dynamic_smem_bytes": smem(*_tc_config(fn))}
            elif _mma_name(fn):
                entry = mma_ptxas[_mma_name(fn)] = {}
            elif _f64_config(fn):
                bm, bn, bk, stages, _, _, gate, _, _ = _f64_config(fn)
                ring = stages * (bm * (bk + 4) + (1 + gate) * bk * (bn + 4)) * 8  # padded rows
                entry = f64_ptxas[_f64_name(fn)] = {"dynamic_smem_bytes": ring}
            elif _f64_q8_name(fn):
                entry = f64_q8_ptxas[_f64_q8_name(fn)] = {}
            elif _f32_name(fn):
                entry = f32_ptxas[_f32_name(fn)] = {}
            elif _f32_q8_name(fn):
                entry = q8_ptxas[_f32_q8_name(fn)] = {}
            elif _bgemv_name(fn):
                entry = bgemv_ptxas[_bgemv_name(fn)] = {}
            elif re.search(r"qgemv\w*_kernel", fn):
                entry = qgemv_ptxas[re.sub(r".*(qgemv\w*_kernel)I", r"\1 ", fn)[:40]] = {}
            elif "wkv6_" in fn:
                entry = wkv6_ptxas[re.sub(r".*(wkv6_\w+?_kernel)", r"\1", fn)[:40]] = {}
            elif _attn_name(fn):
                name = _attn_name(fn)
                entry = attn_ptxas[name] = {}
                if name.startswith("mma"):
                    entry["dynamic_smem_bytes"] = attn_smem(int("int8" in name),
                                                            int(name.split("D=")[1].split()[0]))
            continue
        if entry is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            entry["static_smem_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
    for line in _build.build_log.splitlines():
        if re.search(r"\(C75\d\d\)", line):
            notes.append(line.split("ptxas info    :")[-1].strip()[:220])
    (OUT / "sass_hgmma.json").write_text(json.dumps({"hgmma": hgmma, "ptxas": ptxas,
                                                     "hmma": hmma, "attention_ptxas": attn_ptxas,
                                                     "notes": notes}, indent=1))
    tc_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                 for k, v in ptxas.items()}
    emit("sass", what="HGMMA in csrc/gemm_sm90.cu's kernels (cuobjdump -sass)",
         hgmma_total=sum(hgmma.values()), hgmma_per_kernel=hgmma,
         ptxas=ptxas or "not built in this process", ptxas_notes=sorted(set(notes)),
         tc_spill_bytes=tc_spills)
    spills = {k: v.get("spill_stores", 0) for k, v in attn_ptxas.items()
              if v.get("spill_stores", 0)}
    emit("sass", what="HMMA in csrc/attention_mma.cu's kernels (cuobjdump -sass); ptxas for "
         "them and csrc/attention_splitkv.cu's and csrc/attention.cu's",
         hmma_total=sum(hmma.values()), hmma_per_kernel=hmma, ptxas=attn_ptxas or "not built in this process",
         attention_kernels_with_spills=spills,
         d256={k: {f: v.get(f) for f in ("registers", "spill_stores", "spill_loads",
                                         "dynamic_smem_bytes", "static_smem_bytes")}
               for k, v in attn_ptxas.items() if "D=256" in k})
    f64_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                  for k, v in f64_ptxas.items()}
    bgemv_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                    for k, v in bgemv_ptxas.items()}
    emit("sass", what="DMMA in csrc/gemm_f64.cu's kernels (cuobjdump -sass); ptxas for them "
         "and csrc/bgemv.cu's, csrc/bgemv_rows.cu's and csrc/bgemv_members.cu's",
         dmma_total=sum(dmma.values()),
         dmma_per_kernel=dmma, ptxas=f64_ptxas or "not built in this process",
         bgemv_ptxas=bgemv_ptxas, f64_spill_bytes=f64_spills, bgemv_spill_bytes=bgemv_spills)
    f64_q8_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                     for k, v in f64_q8_ptxas.items()}
    emit("sass", what="DMMA in csrc/gemm_f64_q8.cu's kernels (cuobjdump -sass); ptxas for them",
         dmma_per_kernel=dmma_q8,
         registers={k: v.get("registers") for k, v in f64_q8_ptxas.items()},
         spill_bytes=f64_q8_spills or "not built in this process")
    (OUT / "sass_dmma.json").write_text(json.dumps({"dmma": dmma, "ptxas": f64_ptxas,
                                                    "bgemv_ptxas": bgemv_ptxas,
                                                    "dmma_q8": dmma_q8,
                                                    "q8_ptxas": f64_q8_ptxas}, indent=1))
    # the 2 stored layouts x 3 tiles (DMMA_TILES and DMMA_Q8_GATE_TILES)
    if (len(dmma_q8) != 6 or min(dmma_q8.values()) == 0
            or (_build.build_log and (len(f64_q8_spills) != 6 or any(f64_q8_spills.values())))):
        raise AssertionError(f"f64 int8 instantiations (want 6, each with DMMA, no spill): "
                             f"DMMA {dmma_q8}, spills {f64_q8_spills}")
    f32_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                  for k, v in f32_ptxas.items()}
    emit("sass", what="FFMA in csrc/gemm_f32.cu's kernels (cuobjdump -sass); ptxas for them",
         ffma_total=sum(ffma.values()), ffma_per_kernel=ffma,
         ptxas=f32_ptxas or "not built in this process", f32_spill_bytes=f32_spills)
    q8_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                   for k, v in q8_ptxas.items()}
    emit("sass", what="FFMA and tensor-core instructions in csrc/gemm_f32_q8.cu's kernels "
         "(cuobjdump -sass); ptxas for them",
         ffma_per_kernel=q8_ffma, tensor_core_per_kernel=q8_tc,
         registers={k: v.get("registers") for k, v in q8_ptxas.items()},
         spill_bytes=q8_spills or "not built in this process")
    (OUT / "sass_ffma.json").write_text(json.dumps({"ffma": ffma, "ptxas": f32_ptxas,
                                                    "q8_ffma": q8_ffma,
                                                    "q8_ptxas": q8_ptxas}, indent=1))
    # 7 tiles (FFMA_SM90_BATCHED_TILES and the gate's) x the 2 layouts
    layouts = {f: sorted(k for k in q8_ffma if k.endswith(f)) for f in ("kn", "nk")}
    if (any(len(v) != 7 for v in layouts.values()) or min(q8_ffma.values()) == 0
            or any(q8_tc.values())
            or (_build.build_log and (len(q8_spills) != 14 or any(q8_spills.values())))):
        raise AssertionError(f"f32 int8 instantiations (want 7 a layout, each with FFMA, no "
                             f"tensor-core instruction, no spill): {layouts}, FFMA {q8_ffma}, "
                             f"tensor core {q8_tc}, spills {q8_spills}")
    emit("sass", what="HMMA in csrc/qgemv.cu's tensor-core kernels (cuobjdump -sass); ptxas "
         "for csrc/qgemv.cu's and csrc/rwkv6.cu's kernels", qgemv_tc_hmma=qhmma,
         qgemv_ptxas=qgemv_ptxas, wkv6_ptxas=wkv6_ptxas)
    mma_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                  for k, v in mma_ptxas.items()}
    emit("sass", what="HMMA in csrc/mamba2.cu's kernels (cuobjdump -sass); ptxas for them",
         hmma_per_kernel=mma,
         ptxas=mma_ptxas or "not built in this process", spill_bytes=mma_spills)
    (OUT / "sass_mma.json").write_text(json.dumps({"hmma": mma, "ptxas": mma_ptxas}, indent=1))
    if not mma.get("ssd outputs bf16"):
        raise AssertionError(f"the SSD's bf16 outputs kernel without HMMA: {mma}")
    if any(mma_spills.values()):
        raise AssertionError(f"mamba2.cu kernels spill: {mma_spills}")
    widths = {name.split("copy=")[1].split()[0] for name, n in dmma.items() if n}
    if widths != {"16B", "8B"}:
        raise AssertionError(f"f64 tensor-core kernels with DMMA only in copies of {widths}")
    if len(qhmma) != 2 or min(qhmma.values()) == 0:
        raise AssertionError(f"packed GEMV tensor-core kernels without HMMA: {qhmma}")
    if not ffma or min(ffma.values()) == 0:
        raise AssertionError(f"f32 ring kernels without FFMA: {ffma}")
    if any(f32_spills.values()):
        raise AssertionError(f"f32 ring kernels spill: {f32_spills}")
    if not hgmma or min(hgmma.values()) == 0:
        raise AssertionError(f"tensor-core kernels without HGMMA: {hgmma}")
    batched = sorted(k for k in hgmma if "batched" in k)
    if len(batched) != 12:  # gate x bf16 / f32 out x (2 tiles dense, 64 x 64 int8 "kn" B)
        raise AssertionError(f"batched tensor-core instantiations {batched}, want 12")
    kn_2d = sorted(k for k in hgmma if "int8 kn" in k and "batched" not in k)
    if len(kn_2d) != 4:  # the 2-D int8 "kn" form: PACKED_TILES and PACKED_GATE_TILES
        raise AssertionError(f"2-D int8 kn tensor-core instantiations {kn_2d}, want 4")
    # f64: 2 tiles x gate x 2 copy widths; f32: FFMA_SM90_BATCHED_TILES and
    # the gate's, and as many ODD ones, with the 5 2-D ODD ones
    for kind, names, want, end in (("f64", dmma, 8, "batched"), ("f32", ffma, 7, "batched"),
                                   ("f32 odd", ffma, 7, "batched odd")):
        if len([k for k in names if k.endswith(end)]) != want:
            raise AssertionError(f"batched {kind} instantiations: {sorted(names)}")
    if len([k for k in ffma if k.endswith("odd")]) != 12:
        raise AssertionError(f"f32 ring ODD instantiations (want 12): {sorted(ffma)}")
    if any(tc_spills.values()):
        raise AssertionError(f"tensor-core GEMM kernels spill: {tc_spills}")
    if not hmma or min(hmma.values()) == 0:
        raise AssertionError(f"tensor-core attention kernels without HMMA: {hmma}")
    ffma_ptxas = {k: v for k, v in attn_ptxas.items() if k.startswith("ffma")}
    ffma_spills = {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                   for k, v in ffma_ptxas.items()}
    emit("sass", what="FFMA and tensor-core instructions in csrc/attention.cu's kernels (the "
         "f32 route \"ffma\"; cuobjdump -sass); ptxas for them",
         ffma_per_kernel=attn_ffma, tensor_core_per_kernel=attn_tc,
         registers={k: v.get("registers") for k, v in ffma_ptxas.items()},
         spill_bytes=ffma_spills or "not built in this process")
    if (len(attn_ffma) != 40 or min(attn_ffma.values()) == 0 or any(attn_tc.values())
            or (_build.build_log and (len(ffma_spills) != 40 or any(ffma_spills.values())))):
        raise AssertionError(f"f32 attention instantiations (want 40, each with FFMA, no "
                             f"tensor-core instruction, no spill): FFMA {attn_ffma}, tensor "
                             f"core {attn_tc}, spills {ffma_spills}")
    if not dmma or min(dmma.values()) == 0:
        raise AssertionError(f"f64 tensor-core kernels without DMMA: {dmma}")
    if any(f64_spills.values()):
        raise AssertionError(f"f64 tensor-core kernels spill: {f64_spills}")
    # 36 in bgemv.cu and bgemv_rows.cu (3 dtypes x gate x batched, x 1 or 4
    # rows a warp in bgemv_rows.cu), and since the short-member body 36 in
    # bgemv_members.cu (3 dtypes x gate x 16-byte or element chunks x op =
    # A^T, op = A, op = A over rows of more than 32 chunks)
    if bgemv_ptxas and (len(bgemv_ptxas) != 72 or any(bgemv_spills.values())):
        raise AssertionError(f"bgemv kernels (want 72: 12 in bgemv.cu, 24 in bgemv_rows.cu, 36 "
                             f"in bgemv_members.cu) {sorted(bgemv_ptxas)}, spilling "
                             f"{bgemv_spills}")
    return hgmma


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the serving shapes
# --------------------------------------------------------------------------

def ffma_launch(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """The first CUDA-core kernel (csrc/gemm.cu) on the same inputs, launched
    straight through its C entry point and counted nowhere: the loop the
    "wgmma", "dmma" and "ffma_sm90" routes took over, timed beside them in
    the same run.  b (and b2) are dense (K, N) or packed (`gemm_q8_launch`);
    a is (..., K)."""
    from repro_torch.core import quant
    from repro_torch.kernels import _build, gemm, ops
    k, n = b.shape
    out = torch.empty(tuple(a.shape[:-1]) + (n,), dtype=a.dtype, device=a.device)
    args = (_build.ptr(bias), _build.ptr(residual), out.data_ptr(), a.numel() // k, k, n,
            ops._ACTS[activation], torch.cuda.current_stream().cuda_stream)
    code = ops._DTYPE_CODES[a.dtype]
    if quant.is_quantized(b):
        fn = _build.function("gemm_q8_launch", gemm._Q_ARGTYPES)
        err = fn(code, a.data_ptr(), b.values.data_ptr(), b.scales.data_ptr(),
                 None if b2 is None else b2.values.data_ptr(),
                 None if b2 is None else b2.scales.data_ptr(), b.block[0], b.block[1],
                 int(b.transposed), *args)
    else:
        fn = _build.function("gemm_launch", gemm._ARGTYPES)
        err = fn(code, a.data_ptr(), b.data_ptr(), _build.ptr(b2), *args)
    if err:
        raise RuntimeError(f"ffma_launch: CUDA error {err}")
    return out


REPLACED_DIR = HERE / "scripts" / "replaced"
_replaced = {}


def replaced_build_start() -> list:
    """Start nvcc on each design a redesign replaced (scripts/replaced/*.cu,
    kept to be timed beside its successor in the same run), one process a
    file beside the port's own build; each into build/replaced/ as a shared
    library of its own."""
    from repro_torch.kernels import _build
    out = HERE / "build" / "replaced"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(REPLACED_DIR.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        cmd = [_build._nvcc(), *[f for f in _build.FLAGS if f != "-v" and f != "-Xptxas"],
               "-shared", "-I", str(_build.CSRC), str(src), "-o", str(lib)]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    return jobs


def replaced_build_finish(jobs: list) -> list:
    """Wait for replaced_build_start's nvcc processes; load each library."""
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        _replaced[lib.stem[3:]] = ctypes.CDLL(str(lib))
    return sorted(_replaced)


def replaced_qgemv(qw, x, *, qw2=None, bias=None, residual=None, activation=None):
    """The packed GEMV's first design (scripts/replaced/qgemv_rows4.cu: 4
    rows a block, x read beside every weight chunk) on the same operands,
    counted nowhere: y (B, N) in x's dtype from x (B, K)."""
    from repro_torch.kernels import _build, ops
    fn = _replaced["qgemv_rows4"].qgemv_rows4_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    n, k = qw.values.shape
    out = torch.empty(x.shape[0], n, dtype=x.dtype, device=x.device)
    err = fn(ops._DTYPE_CODES[x.dtype], qw.values.data_ptr(), qw.scales.data_ptr(),
             None if qw2 is None else qw2.values.data_ptr(),
             None if qw2 is None else qw2.scales.data_ptr(), x.data_ptr(), _build.ptr(bias),
             _build.ptr(residual), out.data_ptr(), x.shape[0], k, n, qw.block[0], qw.block[1],
             ops._ACTS[activation], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"replaced_qgemv: CUDA error {err}")
    return out


def first_bgemv_plan(b: int, k: int, n: int, dtype, gate: bool, trans: bool, batched: bool):
    """kernels.bgemv.plan as the first design had it, before the
    short-member body: every member on csrc/bgemv_rows.cu (op = A;
    `split_plan`, unchanged) or on the broadcast column body with one member
    a block, 128-byte tiles and at most 1024 rows a K slice (op = A^T;
    scripts/replaced/bgemv_first.cu, `replaced_bgemv`)."""
    from repro_torch.kernels import bgemv
    if not (trans and batched):
        return bgemv.split_plan(b, k, n, dtype, gate, trans=trans, batched=batched)
    cdiv, tile = bgemv._cdiv, 128 // (torch.finfo(dtype).bits // 8)
    splits = max(1, min(bgemv.BLOCKS_PER_SM * bgemv.H100_SMS // max(cdiv(n, tile) * b, 1),
                        k // bgemv.MIN_ROWS[bool(gate)]))
    rows = min(bgemv.MAX_ROWS, max(bgemv.ROW_STEP, cdiv(cdiv(k, splits), bgemv.ROW_STEP)
                                   * bgemv.ROW_STEP))
    return bgemv.Plan(tile, max(1, cdiv(k, rows)), rows, True)


def replaced_bgemv(a, x, *, transpose_a, a2=None, bias=None, residual=None, activation=None):
    """ops.bgemv under the first design's plan (`first_bgemv_plan`),
    counted nowhere: op = A on csrc/bgemv_rows.cu through kernels.bgemv.run,
    op = A^T on the first column design (scripts/replaced/bgemv_first.cu: a
    member a block of the broadcast column body)."""
    from repro_torch.kernels import _build, bgemv, ops
    if transpose_a:
        k, n = a.shape[-2:]
    else:
        n, k = a.shape[-2:]
    b = x.shape[0]
    p = first_bgemv_plan(b, k, n, x.dtype, a2 is not None, transpose_a, a.ndim == 3)
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    if not transpose_a:
        return bgemv.run(a, x, out, p, w2=a2, bias=bias, residual=residual,
                         act_code=ops._ACTS[activation], dtype_code=ops._DTYPE_CODES[x.dtype])
    fn = _replaced["bgemv_first"].bgemv_first_launch
    fn.argtypes, fn.restype = bgemv._ARGTYPES, ctypes.c_int
    ws = tickets = None
    if p.splits > 1:
        ws = torch.empty((2 if a2 is not None else 1) * p.splits * b * n,
                         dtype=torch.promote_types(torch.float32, x.dtype), device=x.device)
        tickets = _build.tickets(x.device, -(-n // p.tile) * p.chunks(b))
    err = fn(ops._DTYPE_CODES[x.dtype], a.data_ptr(), _build.ptr(a2), x.data_ptr(),
             _build.ptr(bias), _build.ptr(residual), out.data_ptr(), _build.ptr(ws),
             _build.ptr(tickets), b, k, n, p.splits, p.rows, ops._ACTS[activation],
             int(a.ndim == 3), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"replaced_bgemv: CUDA error {err}")
    return out


def replaced_attention(q, k, v, kv_lens=None, *, k_scales=None, v_scales=None, page_table=None,
                       causal: bool = True, prefix_len=None, kv_groups: int = 1):
    """Flash attention's first CUDA-core design (scripts/replaced/
    attention_first.cu: 128-thread blocks, each key tile staged through
    registers into static shared memory, two 4-byte shared loads an FMA) on
    ops.flash_attention's operands, counted nowhere; it takes q in f32 or
    bf16, every K/V form and mask, and both layouts (flat operands as their
    `cache_view`)."""
    from repro_torch.kernels import _build, attention, ops
    fn = _replaced["attention_first"].attention_first_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    result = out = torch.empty_like(q)
    if q.ndim == 3:
        q, k, v, k_scales, v_scales = attention.cache_view(q, k, v, k_scales, v_scales,
                                                           kv_groups)
        out = out.view(q.shape[0], q.shape[2], q.shape[1], q.shape[3]).transpose(1, 2)
    b, tq, h, d = q.shape
    if kv_lens is None:
        kv_lens = attention.all_keys(q.device, b * h)
    s, page_size, max_pages = attention._logical(k, page_table)
    err = fn(ops._DTYPE_CODES[q.dtype], int(k_scales is not None), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), _build.ptr(k_scales), _build.ptr(v_scales), kv_lens.data_ptr(),
             _build.ptr(page_table), out.data_ptr(), b, tq, h, s, k.shape[2], d, page_size,
             max_pages, attention.visible_prefix(s, causal, prefix_len), q.stride(1),
             q.stride(2), float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"replaced_attention: CUDA error {err}")
    return result


def replaced_rwkv6(r, k, v, w, u, s0=None, chunk: int = 32):
    """WKV6's first design (scripts/replaced/rwkv6_serial.cu: a block a row
    walking the chunks in series) on the same operands, counted nowhere."""
    from repro_torch.kernels import _build, ops
    fn = _replaced["rwkv6_serial"].rwkv6_serial_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bh, t, kk = r.shape
    vv = v.shape[-1]
    y = torch.empty(bh, t, vv, dtype=r.dtype, device=r.device)
    s_fin = torch.empty(bh, kk, vv, dtype=torch.float32, device=r.device)
    err = fn(ops._DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), _build.ptr(s0), y.data_ptr(), s_fin.data_ptr(), bh, t, kk, vv,
             min(chunk, t), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"replaced_rwkv6: CUDA error {err}")
    return y, s_fin


def serial_ssd_launch(x, a, b, c, h0, y, h_fin, *, chunk: int, dtype_code: int):
    """The SSD's first design (scripts/replaced/mamba2_serial.cu: a block a
    (row, 16-column slice) walking the chunks in series) into y and h_fin,
    with `kernels.mamba2.launch`'s arguments, counted nowhere."""
    from repro_torch.kernels import _build
    fn = _replaced["mamba2_serial"].mamba2_serial_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bh, t, p = x.shape
    err = fn(dtype_code, x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), _build.ptr(h0),
             y.data_ptr(), h_fin.data_ptr(), bh, t, b.shape[-1], p, min(chunk, t),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"serial_ssd_launch: CUDA error {err}")
    return y, h_fin


def replaced_mamba2(x, a, b, c, h0=None, chunk: int = 64):
    """serial_ssd_launch on the same operands as ops.mamba2_ssd."""
    from repro_torch.kernels import ops
    bh, t, p = x.shape
    y = torch.empty(bh, t, p, dtype=x.dtype, device=x.device)
    h_fin = torch.empty(bh, b.shape[-1], p, dtype=torch.float32, device=x.device)
    return serial_ssd_launch(x, a, b, c, h0, y, h_fin, chunk=chunk,
                             dtype_code=ops._DTYPE_CODES[x.dtype])


def plan_of(m: int, k: int, n: int, dtype, gate: bool = False, layout=None,
            aligned: bool = True) -> dict:
    """gemm.plan's route, tile, K slices, copy width and staging for a case
    (fresh, aligned tensors unless said otherwise), and `odd`: a dense
    launch on "ffma_sm90" that writes C one element a store (N % 4 != 0;
    a fresh C starts on 16 bytes)."""
    from repro_torch.kernels import gemm
    p = gemm.plan(m, k, n, dtype, gate=gate, packed_layout=layout, aligned=aligned)
    return dict(route=p.route, tile=list(p.tile), splits=p.splits, copy=p.copy, stage=p.stage,
                odd=p.route == "ffma_sm90" and layout is None and n % 4 != 0)


def launch_keys(kernel: str, plan: dict) -> dict:
    """The launch_counts() keys one launch under plan_of's plan adds to
    beside `kernel` ("gemm" or "bgemm"): its route's, and its form's where
    the route took the one for rows off 16 bytes."""
    keys = {f"{kernel}_{plan['route']}": 1}
    if plan["stage"]:
        keys[f"{kernel}_{plan['route']}_staged"] = 1
    if plan["route"] == "dmma" and plan["copy"] == 8:
        keys[f"{kernel}_dmma_copy8"] = 1
    if plan.get("odd"):
        keys[f"{kernel}_ffma_sm90_odd"] = 1
    return keys


def kernel_cases(dtype):
    """Cases (dicts: kernel, case, call, lib and lib_call (one PyTorch call
    on the same inputs, or None), bytes, flops; for the GEMMs also plan and
    ffma, csrc/gemm.cu on the same inputs where the plan names wgmma; for
    attention its plan and replaced, the f32 route's first design on the
    same inputs) at the
    stablelm-1.6b and zamba2-1.2b FULL serving shapes, batch 4; bgemv cases
    carry their plan (`kernels.bgemv.plan`: tile, splits, rows)."""
    from repro_torch.kernels import attention, bgemv, ops
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    def case(kernel, label, call, lib, lib_call, nb, flops, **extra):
        return dict(kernel=kernel, case=label, call=call, lib=lib, lib_call=lib_call,
                    bytes=nb, flops=flops, **extra)

    d, f, b = 2048, 5632, 4
    cases = []
    # bgemv: decode projections, y[b] = epi(x[b] @ W), of stablelm and zamba2
    # (its Mamba2 in/out projections and the shared block's gelu MLP)
    x, xf = rnd(b, d), rnd(b, f)
    w_qkv, bias = rnd(d, d, std=d ** -0.5), rnd(d)
    w_g, w_u = rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5)
    w_gu = torch.cat([w_g, w_u], dim=1)
    w_dn, res = rnd(f, d, std=f ** -0.5), rnd(b, d)

    def gemv_case(label, w, xx, lib, lib_call, *, w2=None, **kw):
        k, n = w.shape
        p = bgemv.plan(b, k, n, dtype, gate=w2 is not None)
        return case("bgemv", label, lambda: ops.bgemv(w, xx, a2=w2, **kw, transpose_a=True), lib,
                    lib_call,
                    nbytes(w, w2, xx, kw.get("bias"), kw.get("residual"))
                    + b * n * xx.element_size(), 2 * b * k * n * (2 if w2 is not None else 1),
                    plan=dict(tile=p.tile, splits=p.splits, rows=p.rows))

    din, dz, dff = 8384, 4096, 8192
    xz, xh = rnd(b, dz), rnd(b, dff)
    wz_in, wz_out = rnd(d, din, std=d ** -0.5), rnd(dz, d, std=dz ** -0.5)
    wz_up, wz_down = rnd(d, dff, std=d ** -0.5), rnd(dff, d, std=dff ** -0.5)
    cases += [
        gemv_case("qkv 4x2048->2048 +bias", w_qkv, x, lambda: torch.addmm(bias, x, w_qkv),
                  "addmm", bias=bias),
        gemv_case("gate_up 4x2048->5632 x2 silu-gate", w_g, x, lambda: torch.matmul(x, w_gu),
                  "matmul [W_g|W_u] (products only)", w2=w_u, activation="silu"),
        gemv_case("down 4x5632->2048 +residual", w_dn, xf, lambda: torch.addmm(res, xf, w_dn),
                  "addmm", residual=res),
        gemv_case("zamba2 in_proj 4x2048->8384", wz_in, x, lambda: torch.matmul(x, wz_in),
                  "matmul"),
        gemv_case("zamba2 out_proj 4x4096->2048", wz_out, xz, lambda: torch.matmul(xz, wz_out),
                  "matmul"),
        gemv_case("zamba2 shared up 4x2048->8192 gelu", wz_up, x,
                  lambda: torch.matmul(x, wz_up), "matmul (products only)", activation="gelu"),
        gemv_case("zamba2 shared down 4x8192->2048 +residual", wz_down, xh,
                  lambda: torch.addmm(res, xh, wz_down), "addmm", residual=res),
    ]
    # bgemm: admission-prefill projections, C[b] = epi(A[b] @ B), over the
    # 4 x 128 prompt rows: every prefill shape of stablelm and zamba2
    rows = b * 128

    def gemm_case(label, k, n, a, w, lib, lib_call, gate=False, **kw):
        out_b = rows * n * a.element_size()
        wb = nbytes(w, kw.get("b2"), kw.get("bias"), kw.get("residual"))
        p = plan_of(rows, k, n, dtype, gate=gate)
        ffma = (lambda: ffma_launch(a, w, **kw)) if p["route"] != "ffma" else None
        return case("bgemm", label, lambda: ops.bgemm(a, w, **kw), lib, lib_call,
                    nbytes(a) + wb + out_b, 2 * rows * k * n * (2 if gate else 1),
                    plan=p, ffma=ffma)

    a, af = rnd(b, 128, d), rnd(b, 128, f)
    a2d, af2d = a.view(-1, d), af.view(-1, f)
    res3 = rnd(b, 128, d)
    cases += [
        gemm_case("gate_up (4,128,2048)@(2048,5632) x2 silu-gate", d, f, a, w_g,
                  lambda: torch.matmul(a2d, w_gu), "matmul [W_g|W_u] (products only)",
                  gate=True, b2=w_u, activation="silu"),
        gemm_case("qkv (4,128,2048)@(2048,2048) +bias", d, d, a, w_qkv,
                  lambda: torch.addmm(bias, a2d, w_qkv), "addmm", bias=bias),
        gemm_case("wo (4,128,2048)@(2048,2048) +residual", d, d, a, w_qkv,
                  lambda: torch.addmm(res3.view(-1, d), a2d, w_qkv), "addmm", residual=res3),
        gemm_case("down (4,128,5632)@(5632,2048) +residual", f, d, af, w_dn,
                  lambda: torch.addmm(res3.view(-1, d), af2d, w_dn), "addmm", residual=res3),
    ]
    # zamba2-1.2b: the Mamba2 in/out projections, the shared block's gelu MLP
    # (its attention projections are stablelm's 2048 -> 2048)
    din, dz, dff = 8384, 4096, 8192
    w_in, w_out = rnd(d, din, std=d ** -0.5), rnd(dz, d, std=dz ** -0.5)
    w_up, w_down = rnd(d, dff, std=d ** -0.5), rnd(dff, d, std=dff ** -0.5)
    az, ah = rnd(b, 128, dz), rnd(b, 128, dff)
    cases += [
        gemm_case("zamba2 in_proj (4,128,2048)@(2048,8384)", d, din, a, w_in,
                  lambda: torch.matmul(a2d, w_in), "matmul"),
        gemm_case("zamba2 out_proj (4,128,4096)@(4096,2048)", dz, d, az, w_out,
                  lambda: torch.matmul(az.view(-1, dz), w_out), "matmul"),
        gemm_case("zamba2 shared up (4,128,2048)@(2048,8192) gelu", d, dff, a, w_up,
                  lambda: torch.matmul(a2d, w_up), "matmul (products only)",
                  activation="gelu"),
        gemm_case("zamba2 shared down (4,128,8192)@(8192,2048) +residual", dff, d, ah, w_down,
                  lambda: torch.addmm(res3.view(-1, d), ah.view(-1, dff), w_down), "addmm",
                  residual=res3),
    ]
    ar, wr = rnd(b, 127, 2047), rnd(2047, 2001, std=2047 ** -0.5)
    br, rr = rnd(2001), rnd(b, 127, 2001)
    cases.append(case(
        "bgemm", "ragged (4,127,2047)@(2047,2001) +bias gelu +residual",
        lambda: ops.bgemm(ar, wr, bias=br, residual=rr, activation="gelu"), None, None,
        nbytes(ar, wr, br, rr) + rr.numel() * rr.element_size(), 2 * b * 127 * 2047 * 2001,
        plan=plan_of(b * 127, 2047, 2001, dtype),
        ffma=(lambda: ffma_launch(ar, wr, bias=br, residual=rr, activation="gelu"))
        if plan_of(b * 127, 2047, 2001, dtype)["route"] != "ffma" else None))
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
        p = attention.plan_for(q, k)
        cases.append(case(
            "attention", label,
            lambda q=q, k=k, v=v, kv_lens=kv_lens: ops.flash_attention(q, k, v, kv_lens=kv_lens),
            lambda qt=qt, kt=kt, vt=vt, mask=mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            "scaled_dot_product_attention",
            2 * nbytes(q) + kv_read + kv_lens.numel() * 4, 4 * pairs * hd,
            plan=dict(route=p.route, splits=p.splits, chunk=p.chunk, per_block=p.per_block,
                      block_q=p.block_q, block_k=p.block_k),
            replaced=lambda q=q, k=k, v=v, kv_lens=kv_lens: replaced_attention(
                q, k, v, kv_lens)))
    return cases


# the tensor-core kernels' bf16 outputs must be correctly rounded (against
# the f64 product) at least as often as the plain version's (cuBLAS in f32),
# less this share; without promotion wgmma fell 0.37 points short at K = 7168
ROUNDING_SLACK = 5e-4


def phase_gemm_precision():
    """At the rwkv and stablelm prefill shapes (the "wgmma" route) and at
    the BLAS odd shape (4095, 4097) @ (4097, 4093) and the odd K = 7167
    prefill shape ("wgmma" on staged operands), the share of bf16 outputs
    equal to the correctly rounded f64 product, and the mean error in bf16
    ulps, for the tensor-core kernel the plan names, the CUDA-core kernel
    (csrc/gemm.cu on the same inputs) and the plain version.  Fails if the tensor-core
    kernel's share falls below the plain version's by more than
    ROUNDING_SLACK."""
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for m, k, n in ((512, 2048, 2048), (512, 7168, 2048), (512, 2048, 7168), (512, 2048, 64),
                    (512, 5632, 2048), (4095, 4097, 4093), (512, 7167, 2047)):
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).bfloat16()
        p = gemm.plan(m, k, n, torch.bfloat16)
        route = p.route + (" staged" if p.stage else "")
        exact = a.double() @ w.double()
        rounded = exact.to(torch.bfloat16).double()
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 7)
        outs = {route: ops.gemm(a, w), "ffma": ffma_launch(a, w)}
        with ops.reference_mode():
            outs["plain"] = ops.gemm(a, w)
        share, err = {}, {}
        for name, o in outs.items():
            o = o.double()
            share[name] = (o == rounded).double().mean().item()
            err[name] = ((o - exact).abs() / ulp).mean().item()
        ok = share[route] >= share["plain"] - ROUNDING_SLACK
        emit("gemm_precision", case=f"({m},{k})@({k},{n}) bf16", route=route,
             correctly_rounded_share=share, mean_error_bf16_ulps=err,
             slack=ROUNDING_SLACK, within_slack=ok)
        rows.append(ok)
        if not ok:
            raise AssertionError(f"gemm_precision ({m}, {k}, {n}): the {route} kernel rounds "
                                 f"{share[route]:.5f} of outputs right, the plain "
                                 f"version {share['plain']:.5f}")
        del a, w, exact, rounded, ulp, outs
    return rows


def split_deterministic(call, got) -> bool:
    """A second launch on the same inputs gives the same bits."""
    again = call()
    torch.cuda.synchronize()
    return bool(torch.equal(got, again))


def phase_kernels():
    from repro_torch.kernels import ops
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c in kernel_cases(dtype):
            name, label, call = c["kernel"], c["case"], c["call"]
            plan = c.get("plan")
            before = ops.launch_counts()
            got = call()
            if name == "bgemm":  # one launch, on the route its plan names
                after = ops.launch_counts()
                rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                if rose != {"bgemm": 1, **launch_keys("bgemm", plan)}:
                    raise AssertionError(f"bgemm [{label}] {dtype}: launches added {rose}, "
                                         f"plan {plan}")
            with ops.reference_mode():
                want = call()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), **TOL[dtype])
            twice = plan and (plan["splits"] > 1 or name == "attention"
                              or plan["route"] == "ffma_sm90")
            same = split_deterministic(call, got) if twice else None
            ms = time_ms(call)
            with ops.reference_mode():
                plain_ms = time_ms(call)
            lib_ms = time_ms(c["lib"]) if c["lib"] is not None else None
            ffma_ms = time_ms(c["ffma"]) if c.get("ffma") is not None else None
            replaced_ms = time_ms(c["replaced"]) if c.get("replaced") is not None else None
            b_ms, by = bound(c["bytes"], c["flops"], dtype)
            row = dict(kernel=name, case=label, dtype=str(dtype).split(".")[1], plan=plan,
                       max_abs_err=err, tol=TOL[dtype], within_tol=ok, kernel_ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, library_call=c["lib_call"],
                       ffma_ms=ffma_ms, replaced_ms=replaced_ms,
                       split_bitwise_deterministic=same, bound_ms=b_ms,
                       bound_by=by, share_of_bound=b_ms / ms, bytes=c["bytes"],
                       flops=c["flops"])
            emit("kernels", **row)
            if not ok:
                raise AssertionError(f"{name} [{label}] {dtype}: max |kernel - plain| "
                                     f"= {err} outside {TOL[dtype]}")
            if same is False:
                raise AssertionError(f"{name} [{label}] {dtype}: two launches differ")
            rows[(name, label, row["dtype"])] = row
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
    ops.reset_launch_counts()
    got = serve(ARCH, "smoke", **kw)
    check_f32_routes(ops.launch_counts(), "smoke")
    routes = check_attention_routes("smoke", cfg.n_layers, f32=True)
    with ops.reference_mode():
        want = serve(ARCH, "smoke", **kw)
    equal = got["outputs"] == want["outputs"]
    emit("smoke", dtype="float32", requests=len(prompts), completed=got["completed"],
         tokens_equal=equal, outputs=got["outputs"])
    if not equal or got["completed"] != len(prompts):
        raise AssertionError(f"smoke serve: kernels {got['outputs']} != plain {want['outputs']}")
    return routes


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


def _forced_run(params, cfg, tokens, steps, extras=None, cache_len: int = 160):
    """Prefill (4, 128), with the family's patches or frames in `extras`,
    then decode the given tokens; returns the logits of every step and
    device times (ms) of the prefill and each decode step."""
    from repro_torch.models import transformer as tf
    cache = tf.init_cache(cfg, 4, cache_len, device="cuda")
    logits, times = [], []
    feeds = [(tf.prefill, tokens, extras or {})] + [(tf.decode_step, t, {}) for t in steps]
    for fn, tok, kw in feeds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, cache = fn(params, tok, cache, cfg, **kw)
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


def profile_until_whole(profiled):
    """Call `profiled` (one profile, returning its device events by name and
    {kernel: (launches wanted, device launches read)}) until no count comes
    up short, or one comes up long, or PROFILE_ATTEMPTS profiles were taken.
    Returns the last profile's events and counts, and the counts of the
    profiles read short before it."""
    short = []
    while True:
        by_name, counts = profiled()
        low = any(got < want for want, got in counts.values())
        high = any(got > want for want, got in counts.values())
        if not low or high or len(short) + 1 >= PROFILE_ATTEMPTS:
            return by_name, counts, short
        short.append(counts)


def profile_by_name(call, n: int, cpu: bool = True) -> dict:
    """torch.profiler over n calls of `call`: {kernel name: (device ms,
    device launches)}, each a call, device-side events only (kernels,
    copies: aten ops would count twice).  The window opens with
    PROFILE_HEAD_SLEEPS sleep kernels, left out, so the records the
    profiler drops at its start are theirs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_HEAD_SLEEPS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not re.search(SLEEP_KERNEL, e.key)}


# each attention route's device kernel and its source
ATTENTION_KERNELS = {"splitkv": "attention_splitkv_kernel", "mma": "attention_mma_kernel",
                     "ffma": "attention_kernel"}
ATTENTION_SOURCES = {"splitkv": "attention_splitkv.cu", "mma": "attention_mma.cu",
                     "ffma": "attention.cu"}


def attention_profile_counts(by_name: dict, want: dict) -> dict:
    """profile_until_whole's entries for attention: each route's launches a
    call that `want` ("route/mask": launches a call) names, beside the
    device launches of its kernel the profile read."""
    return {f"attention_{r}": (sum(v for k, v in want.items() if k.startswith(r + "/")),
                               sum(c for k, (_, c) in by_name.items() if re.search(pat, k)))
            for r, pat in ATTENTION_KERNELS.items()}


def masks_since(before: dict, n: int) -> dict:
    """The attention wrappers' launches by route and mask since `before`
    (ops.attention_masks()), each of n calls; zeros left out."""
    from repro_torch.kernels import ops
    return {k: (v - before[k]) / n for k, v in ops.attention_masks().items() if v != before[k]}


def check_profile_attention(phase: str, counts: dict, by_mask: dict, want: dict):
    """Fail unless every route's device launches and the wrappers' counts by
    route and mask are what `want` names."""
    bad = {k: v for k, v in counts.items() if k.startswith("attention_") and v[0] != v[1]}
    want_masks = {k: v for k, v in want.items() if v}
    if bad or by_mask != want_masks:
        raise AssertionError(f"{phase}: attention (want, device) {bad}, by route/mask "
                             f"{by_mask} (want {want_masks})")


def phase_profile(params, cfg, bgemv_per_step: int | None = None, steps: int = 5,
                  phase: str = "profile", tc_per_step: int | None = None, extras=None,
                  cache_len: int = 160, attention_want: dict | None = None):
    """Where a full-width decode step's time goes (batch 4, 128 cached
    tokens): the wall clock per step without the profiler, then
    torch.profiler over the same steps for device time per kernel name;
    the idle share is 1 - device busy / wall.  Fails unless the device runs
    one bgemv kernel a bgemv call and one qgemv kernel a packed bgemv call
    (csrc/bgemv.cu and csrc/qgemv.cu combine their K splits in the same
    launch) and, where `bgemv_per_step` is given, the profiled steps call
    bgemv that many times a step; where `tc_per_step` is given (the MoE's
    batched expert launches), the tensor-core GEMM kernel runs that many
    device launches a step; where `attention_want` is given ("route/mask":
    launches a step), each attention route's kernel runs that many device
    launches and the wrappers count them under those masks.  `extras`: the
    family's patches or frames for the prefill that fills the cache.  A
    profile whose launches come up short is taken again
    (profile_until_whole); those read short are printed."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(6)
    cache = tf.init_cache(cfg, 4, cache_len, device="cuda")
    _, cache = tf.prefill(params, torch.from_numpy(
        rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda(), cache, cfg,
        **(extras or {}))
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

    def step():
        nonlocal cache
        _, cache = tf.decode_step(params, tok, cache, cfg)

    masks = {}

    def profiled():
        before, masks_before = ops.launch_counts(), ops.attention_masks()
        by_name = profile_by_name(step, steps)
        after = ops.launch_counts()
        masks.update(by_mask=masks_since(masks_before, steps))

        def launches(pattern):
            return sum(n for k, (_, n) in by_name.items() if re.search(pattern, k))

        counts = {"bgemv": ((after["bgemv"] - before["bgemv"]) / steps,
                            launches("bgemv_kernel")),
                  "qgemv": ((after["bgemv_int8"] - before["bgemv_int8"]) / steps,
                            launches(r"qgemv\w*_kernel"))}
        if tc_per_step is not None:
            counts["gemm_tc"] = (tc_per_step, launches("gemm_tc_kernel"))
        if attention_want is not None:
            counts.update(attention_profile_counts(by_name, attention_want))
        return by_name, counts

    by_name, counts, short = profile_until_whole(profiled)
    by_mask = masks["by_mask"]
    bgemv_calls, bgemv_launches = counts["bgemv"]
    int8_calls, qgemv_launches = counts["qgemv"]
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit(phase, what="full-width decode step, batch 4, 128 cached tokens",
         profiles_read_short=short,
         bgemv_calls_per_step=bgemv_calls, bgemv_device_launches_per_step=bgemv_launches,
         bgemv_ms_per_step=sum(ms for k, (ms, _) in by_name.items() if "bgemv_kernel" in k),
         qgemv_calls_per_step=int8_calls, qgemv_device_launches_per_step=qgemv_launches,
         qgemv_ms_per_step=sum(ms for k, (ms, _) in by_name.items()
                               if re.search(r"qgemv\w*_kernel", k)),
         kv_cache=cfg.kv_cache_dtype, wall_ms_per_step=wall_ms,
         attention_ms_per_step=sum(ms for k, (ms, _) in by_name.items()
                                   if re.search(r"attention\w*_kernel", k)),
         attention_launches_per_step=sum(n for k, (_, n) in by_name.items()
                                         if re.search(r"attention\w*_kernel", k)),
         f32_gemm_ms_per_step=sum(ms for k, (ms, _) in by_name.items()
                                  if "gemm_f32_kernel" in k),
         f32_gemm_launches_per_step=sum(n for k, (_, n) in by_name.items()
                                        if "gemm_f32_kernel" in k),
         tc_gemm_ms_per_step=sum(ms for k, (ms, _) in by_name.items() if "gemm_tc_kernel" in k),
         tc_gemm_launches_per_step=sum(n for k, (_, n) in by_name.items()
                                       if "gemm_tc_kernel" in k),
         device_busy_ms_per_step=busy or None,
         device_idle_share=(1 - busy / wall_ms) if busy else None,
         device_events_per_step=sum(n for _, n in by_name.values()),
         attention_device_launches_per_step={k: v[1] for k, v in counts.items()
                                             if k.startswith("attention_")} or None,
         attention_by_route_mask_per_step=by_mask,
         top=[{"name": k[:90], "ms_per_step": ms, "calls_per_step": n}
              for k, (ms, n) in top])
    if attention_want is not None:
        check_profile_attention(phase, counts, by_mask, attention_want)
    if bgemv_launches != bgemv_calls or bgemv_per_step not in (None, bgemv_calls):
        raise AssertionError(f"{phase}: {bgemv_calls} bgemv calls a decode step (want "
                             f"{bgemv_per_step}) ran {bgemv_launches} device launches")
    if qgemv_launches != int8_calls:
        raise AssertionError(f"{phase}: {int8_calls} packed bgemv calls a decode step ran "
                             f"{qgemv_launches} qgemv device launches")
    if tc_per_step is not None and counts["gemm_tc"][1] != tc_per_step:
        raise AssertionError(f"{phase}: {counts['gemm_tc'][1]} tensor-core GEMM device "
                             f"launches a decode step, want {tc_per_step}")


# the recurrent kernels a prefill profile reads apart: ops counter, the
# prefix of their device kernels' names, and their module (DEVICE_LAUNCHES)
STATE_KERNELS = {"rwkv6": ("rwkv6", "wkv6"), "mamba2_ssd": ("mamba2", "ssd")}


def phase_profile_prefill(params, cfg, reps: int = 3, phase: str = "profile_prefill",
                          state_kernel: str | None = "rwkv6", serial_launch=None, extras=None,
                          cache_len: int = 160, attention_want: dict | None = None):
    """Where a full-width prefill's time goes (batch 4, 128 prompt tokens):
    its wall clock without the profiler, then torch.profiler over the same
    prefills for device time per kernel name (the tensor-core GEMM's, the
    recurrent `state_kernel`'s (WKV6 or the SSD; None for a model with
    none) and the rest) and the device's idle share.  Fails unless every call of `state_kernel` ran its
    kernels' DEVICE_LAUNCHES device launches.  With `serial_launch` (a
    stand-in for that kernel module's `launch`: the design it replaced), the
    same prefills are profiled again through it, and its device time is
    printed beside the kernel's.  `extras` and `attention_want` as for
    phase_profile, a prefill's."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    module, prefix = STATE_KERNELS[state_kernel] if state_kernel else ("bgemm", "none")
    kmod = importlib.import_module(f"repro_torch.kernels.{module}")
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda()

    def prefill():
        return tf.prefill(params, tokens, tf.init_cache(cfg, 4, cache_len, device="cuda"), cfg,
                          **(extras or {}))

    masks = {}

    def profiled():
        before = ops.launch_counts().get(state_kernel, 0)
        masks_before = ops.attention_masks()
        by_name = profile_by_name(prefill, reps)
        masks.update(by_mask=masks_since(masks_before, reps))
        calls = (ops.launch_counts().get(state_kernel, 0) - before) / reps
        launches = sum(n for k, (_, n) in by_name.items() if f"{prefix}_" in k)
        counts = ({state_kernel: (kmod.DEVICE_LAUNCHES * calls, launches)}
                  if state_kernel else {})
        if attention_want is not None:
            counts.update(attention_profile_counts(by_name, attention_want))
        return by_name, counts

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name, counts, short = profile_until_whole(profiled)
    by_mask = masks["by_mask"]
    calls = counts[state_kernel][0] / kmod.DEVICE_LAUNCHES if state_kernel else 0
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    mine = {k: (ms, n) for k, (ms, n) in by_name.items() if f"{prefix}_" in k}
    launches = sum(n for _, n in mine.values())
    serial = {}
    if serial_launch is not None:
        own = kmod.launch
        kmod.launch = serial_launch
        try:
            prefill()
            s_by, _ = profiled()
        finally:
            kmod.launch = own
        s_ms = sum(ms for k, (ms, _) in s_by.items() if f"{prefix}_" in k)
        serial = {f"serial_{prefix}_ms_per_prefill": s_ms,
                  "serial_device_busy_ms_per_prefill": sum(ms for ms, _ in s_by.values()),
                  f"{prefix}_ms_lower_than_serial": s_ms - sum(ms for ms, _ in mine.values())}
    state = {} if not state_kernel else {
        f"{state_kernel}_calls_per_prefill": calls,
        f"{prefix}_device_launches_per_prefill": launches,
        f"{prefix}_ms_per_prefill": sum(ms for ms, _ in mine.values()),
        f"{prefix}_by_kernel": {k[:60]: {"ms": ms, "launches": n} for k, (ms, n) in mine.items()}}
    emit(phase, what=f"full-width prefill, batch 4, 128 prompt tokens, {cfg.arch_id}",
         wall_ms_per_prefill=wall_ms, profiles_read_short=short, **state, **serial,
         tensor_core_gemm_ms=sum(ms for k, (ms, _) in by_name.items()
                                 if "gemm_tc_kernel" in k or "splitk_epilogue" in k),
         attention_ms_per_prefill=sum(ms for k, (ms, _) in by_name.items()
                                      if re.search(r"attention\w*_kernel", k)),
         attention_launches_per_prefill=sum(n for k, (_, n) in by_name.items()
                                            if re.search(r"attention\w*_kernel", k)),
         device_busy_ms_per_prefill=busy or None,
         device_idle_share=(1 - busy / wall_ms) if busy else None,
         device_events_per_prefill=sum(n for _, n in by_name.values()),
         attention_device_launches_per_prefill={k: v[1] for k, v in counts.items()
                                                if k.startswith("attention_")} or None,
         attention_by_route_mask_per_prefill=by_mask,
         top=[{"name": k[:90], "ms_per_prefill": ms, "calls_per_prefill": n}
              for k, (ms, n) in top])
    if attention_want is not None:
        check_profile_attention(phase, counts, by_mask, attention_want)
    if state_kernel and launches != kmod.DEVICE_LAUNCHES * calls:
        raise AssertionError(f"{phase}: {calls} {state_kernel} calls a prefill ran "
                             f"{launches} device launches (want {kmod.DEVICE_LAUNCHES} a call)")


# --------------------------------------------------------------------------
# phase 9: the BLAS library at full size
# --------------------------------------------------------------------------

D8K, N16K, N26 = 8192, 16384, 2 ** 26
# batched GEMV's cases: one A a member at a BLAS size, many small members,
# a broadcast A (per-member shapes before trans)
BGEMV_MEMBERS = "per-member (32,2048,2048)"
BGEMV_SMALL = "per-member (4096,32,32)"
BGEMV_BROADCAST = "broadcast (8192,8192) x (4,8192)"
BGEMV_RAGGED = "per-member ragged (1000,37,19) off 16 bytes"


def bgemv_threshold_cols(rows: int, dtype) -> int:
    """Columns that make a member of `rows` rows exactly
    kernels.bgemv.MEMBER_MAX_BYTES, the largest the short-member body takes."""
    from repro_torch.kernels import bgemv
    return bgemv.MEMBER_MAX_BYTES // (rows * (torch.finfo(dtype).bits // 8))
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
ODD = "odd (4095,4097)@(4097,4093)"
F32_OFF = "(4096,4096)@(4096,4096), A one element off 16 bytes"
F32_SHORT = "ragged (508,2047)@(2047,2001)"


def blas_cases():
    """(kernel counter, routine, case, dtype, make) for every BLAS case;
    make() builds the inputs from a seeded generator and returns (call
    through core.blas, library call or None, bytes, flops, sums, ffma,
    route, replaced), where sums is None (elementwise tolerance) or, for dot
    and nrm2, (cond, the same call on the first half of each vector: a
    planted fault), ffma the CUDA-core kernel on the same inputs where the
    tensor cores run the call, route the gemm plan `plan_of` gives (bgemv:
    its form and members a block; None for the other routines), and
    replaced a bgemv call under the first design's plan (`replaced_bgemv`;
    None for the other routines)."""
    from repro_torch.core import blas

    def rnd(g, dtype, *shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    def gemm_case(dtype, m, k, n, seed, epi=None, fused=False, shift=0):
        """shift: A starts that many elements past an aligned base"""
        off = shift * torch.empty((), dtype=dtype).element_size()
        route = plan_of(m, k, n, dtype, gate=fused, aligned=off % 16 == 0)

        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a = rnd(g, dtype, m * k + shift)[shift:].view(m, k)
            b = rnd(g, dtype, k, n, std=k ** -0.5)
            out_b = m * n * a.element_size()
            on_tc = route["route"] != "ffma"
            if fused:  # stablelm gate+up on a flattened (512-token) prefill
                b2 = rnd(g, dtype, k, n, std=k ** -0.5)
                both = torch.cat([b, b2], dim=1)  # the library's products, no epilogue
                return (lambda: blas.matmul_fused(a, b, w2=b2, activation="silu"),
                        lambda: torch.matmul(a, both),
                        nbytes(a, b, b2) + out_b, 4 * m * n * k, None,
                        (lambda: ffma_launch(a, b, b2=b2, activation="silu")) if on_tc else None,
                        route, None)
            if epi:
                bias, res = rnd(g, dtype, n), rnd(g, dtype, m, n)
                return (lambda: blas.gemm(a, b, bias=bias, residual=res, epilogue=epi), None,
                        nbytes(a, b, bias, res) + out_b, 2 * m * n * k, None,
                        (lambda: ffma_launch(a, b, bias=bias, residual=res, activation=epi))
                        if on_tc else None, route, None)
            return (lambda: blas.gemm(a, b), lambda: torch.matmul(a, b),
                    nbytes(a, b) + out_b, 2 * m * n * k, None,
                    (lambda: ffma_launch(a, b)) if on_tc else None, route, None)
        return make

    def gemv_case(dtype, m, n, seed, trans=False):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a = rnd(g, dtype, n, m, std=m ** -0.5) if trans else rnd(g, dtype, m, n, std=n ** -0.5)
            x = rnd(g, dtype, n)
            at = a.t() if trans else a
            return (lambda: blas.gemv(a, x, trans=trans), lambda: torch.mv(at, x),
                    nbytes(a, x) + m * a.element_size(), 2 * m * n, None, None, None, None)
        return make

    def bgemv_case(dtype, b, m, n, seed, trans=False, batched=True, epi=None, shift=0):
        """batched_gemv (epi "gelu": ops.bgemv with bias, gelu and residual;
        "silu": with a second A, bias and residual, the gate; batched_gemv
        takes neither) of op(A) (m, n) a member, A ((b,) m, n) or ((b,) n,
        m) under trans, `shift` elements into its allocation, and x (b, n);
        the library call is one torch.bmm (F.linear for a broadcast A) on
        the same operands."""
        from repro_torch.kernels import bgemv, ops
        p = bgemv.plan(b, n, m, dtype, gate=epi == "silu", trans=trans, batched=batched)
        form = dict(form=p.form, members=p.members)

        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            shape = ((b,) if batched else ()) + ((n, m) if trans else (m, n))
            a = rnd(g, dtype, math.prod(shape) + shift, std=n ** -0.5)[shift:].view(shape)
            x = rnd(g, dtype, b, n)
            op = a.transpose(-2, -1) if trans else a
            out_b = b * op.shape[-2] * a.element_size()
            flops = 2 * b * m * n
            if epi:
                a2 = (rnd(g, dtype, *shape, std=n ** -0.5) if epi == "silu" else None)
                bias, res = rnd(g, dtype, op.shape[-2]), rnd(g, dtype, b, op.shape[-2])
                kw = dict(a2=a2, bias=bias, residual=res, activation=epi, transpose_a=trans)
                return (lambda: ops.bgemv(a, x, **kw), None,
                        nbytes(a, a2, x, bias, res) + out_b, flops * (2 if a2 is not None else 1),
                        None, None, form, lambda: replaced_bgemv(a, x, **kw))
            lib = (lambda: torch.bmm(op, x[..., None])) if batched else (
                lambda: F.linear(x, op))
            return (lambda: blas.batched_gemv(a, x, trans=trans), lib, nbytes(a, x) + out_b,
                    flops, None, None, form, lambda: replaced_bgemv(a, x, transpose_a=trans))
        return make

    def level1_case(routine, dtype, n, seed, offset=0):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            x, y = rnd(g, dtype, n + offset)[offset:], rnd(g, dtype, n + offset)[offset:]
            size, h = x.element_size(), n // 2
            if routine == "dot":
                cond = (x.double() * y.double()).abs().sum().item()
                return (lambda: blas.dot(x, y), lambda: torch.dot(x, y),
                        nbytes(x, y) + size, 2 * n, (cond, lambda: blas.dot(x[:h], y[:h])), None,
                        None, None)
            if routine == "nrm2":
                cond = x.double().norm().item()
                return (lambda: blas.nrm2(x), lambda: torch.linalg.vector_norm(x),
                        nbytes(x) + size, 2 * n, (cond, lambda: blas.nrm2(x[:h])), None, None,
                        None)
            return (lambda: blas.axpy(0.75, x, y), lambda: torch.add(y, x, alpha=0.75),
                    nbytes(x, y) + n * size, 2 * n, None, None, None, None)
        return make

    cases = []
    for i, dt in enumerate(DTYPES):
        cases.append(("gemm", "gemm", f"{D8K}x{D8K}x{D8K}", dt, gemm_case(dt, D8K, D8K, D8K, 10 + i)))
    ragged = "ragged (4095,4097)@(4097,4093) +bias gelu +residual"
    cases += [
        ("gemm", "gemm", ragged, torch.float32,
         gemm_case(torch.float32, 4095, 4097, 4093, 13, epi="gelu")),
        ("gemm", "matmul_fused", "2-D (512,2048)@(2048,5632) x2 silu-gate", torch.bfloat16,
         gemm_case(torch.bfloat16, 512, 2048, 5632, 14, fused=True)),
        # f64: odd K and N take the f64 tensor cores with 8-byte copies,
        # even ragged ones with 16-byte copies, the gate too
        ("gemm", "gemm", ragged, torch.float64,
         gemm_case(torch.float64, 4095, 4097, 4093, 15, epi="gelu")),
        ("gemm", "gemm", "ragged (4095,4098)@(4098,4094) +bias gelu +residual", torch.float64,
         gemm_case(torch.float64, 4095, 4098, 4094, 16, epi="gelu")),
        ("gemm", "matmul_fused", "2-D (4096,4096)@(4096,4096) x2 silu-gate", torch.float64,
         gemm_case(torch.float64, 4096, 4096, 4096, 17, fused=True)),
        # f32: K and N multiples of 4 take the TMA ring ("ffma_sm90") in
        # place, odd ones (above) on staged operands; zamba2's LoRA merge
        ("gemm", "gemm", "aligned ragged (4095,4096)@(4096,4092) +bias gelu +residual",
         torch.float32, gemm_case(torch.float32, 4095, 4096, 4092, 18, epi="gelu")),
        ("gemm", "gemm", "zamba2 LoRA merge (2048,128)@(128,2048)", torch.float32,
         gemm_case(torch.float32, 2048, 128, 2048, 19)),
        # odd K and N: the plain product beside torch.matmul in each dtype,
        # and bf16 with the epilogue
        ("gemm", "gemm", ragged, torch.bfloat16,
         gemm_case(torch.bfloat16, 4095, 4097, 4093, 60, epi="gelu")),
    ]
    for i, dt in enumerate(DTYPES):
        cases.append(("gemm", "gemm", ODD, dt, gemm_case(dt, 4095, 4097, 4093, 61 + i)))
    # f32 TMA cannot address in place (staged): A one element off an
    # aligned 4096^2, K and N even but not multiples of 4, the ragged bgemm
    # rows (508, 2047) @ (2047, 2001)
    cases += [
        ("gemm", "gemm", F32_OFF, torch.float32,
         gemm_case(torch.float32, 4096, 4096, 4096, 64, shift=1)),
        ("gemm", "gemm", "even ragged (4095,4098)@(4098,4094)", torch.float32,
         gemm_case(torch.float32, 4095, 4098, 4094, 65)),
        ("gemm", "gemm", F32_SHORT, torch.float32,
         gemm_case(torch.float32, 508, 2047, 2001, 66)),
    ]
    for i, dt in enumerate(DTYPES):
        cases.append(("gemv", "gemv", f"{N16K}x{N16K}", dt, gemv_case(dt, N16K, N16K, 20 + i)))
    # batched GEMV (kernel 1's other forms): one A a member, both ops
    for i, dt in enumerate(DTYPES):
        for trans in (False, True):
            cases.append(("bgemv", "batched_gemv", f"{BGEMV_MEMBERS} trans={trans}", dt,
                          bgemv_case(dt, 32, 2048, 2048, 70 + 2 * i + trans, trans=trans)))
    cases += [
        ("bgemv", "batched_gemv", f"{BGEMV_SMALL} trans={trans}", torch.float64,
         bgemv_case(torch.float64, 4096, 32, 32, 76 + trans, trans=trans))
        for trans in (False, True)]
    # short members (csrc/bgemv_members.cu) in f32 and bf16 too, a longer
    # short one, ragged rows of elements off 16 bytes, the gate, and members
    # just at and just past the plan's MEMBER_MAX_BYTES
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        cases += [("bgemv", "batched_gemv", f"{BGEMV_SMALL} trans={trans}", dt,
                   bgemv_case(dt, 4096, 32, 32, 82 + 2 * i + trans, trans=trans))
                  for trans in (False, True)]
    at_n = bgemv_threshold_cols(64, torch.float32)
    cases += [
        ("bgemv", "batched_gemv", "per-member (4096,64,64) trans=True", torch.bfloat16,
         bgemv_case(torch.bfloat16, 4096, 64, 64, 86, trans=True)),
        *[("bgemv", "batched_gemv", f"{BGEMV_RAGGED} trans={trans}", torch.float32,
           bgemv_case(torch.float32, 1000, 37, 19, 87 + trans, trans=trans, shift=1))
          for trans in (False, True)],
        ("bgemv", "bgemv", f"{BGEMV_SMALL} gate +bias silu +residual trans=True",
         torch.float32, bgemv_case(torch.float32, 4096, 32, 32, 89, trans=True, epi="silu")),
        *[("bgemv", "batched_gemv", f"threshold (1024,64,{cols}) trans=False", torch.float32,
           bgemv_case(torch.float32, 1024, 64, cols, 90 + j))
          for j, cols in enumerate((at_n, at_n + 4))],
    ]
    cases += [
        ("bgemv", "batched_gemv", f"{BGEMV_BROADCAST} trans=False", torch.bfloat16,
         bgemv_case(torch.bfloat16, 4, 8192, 8192, 78, batched=False)),
        ("bgemv", "batched_gemv", f"{BGEMV_BROADCAST} trans=True", torch.float64,
         bgemv_case(torch.float64, 4, 8192, 8192, 79, trans=True, batched=False)),
        ("bgemv", "bgemv", "ragged (3,257,131) +bias gelu +residual trans=False", torch.float32,
         bgemv_case(torch.float32, 3, 257, 131, 80, epi="gelu")),
        ("bgemv", "bgemv", "ragged (3,257,131) +bias gelu +residual trans=True", torch.float64,
         bgemv_case(torch.float64, 3, 257, 131, 81, trans=True, epi="gelu")),
    ]
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
    cases += [
        ("blas1_axpy", "axpy", "ragged n=2^26-3", torch.float64,
         level1_case("axpy", torch.float64, N26 - 3, 53)),
        ("blas1_axpy", "axpy", "n=2^26, views one element in", torch.float32,
         level1_case("axpy", torch.float32, N26, 54, offset=1)),
    ]
    return cases


def phase_blas():
    """Drive every case once through core.blas with the launch counts reset
    just before (each call must add exactly one launch to its kernel's
    count), hold it against its plain version, then time it; a bgemv case
    also bitwise on a second launch and beside the first design's plan on the same
    inputs (replaced_ms), and two short-member shapes bitwise alone and in
    a batch of 4096 (`bgemv_batch_invariance`)."""
    from repro_torch.kernels import ops
    cases = blas_cases()
    checked = []
    ops.reset_launch_counts()
    for kernel, routine, case, dtype, make in cases:
        call, _, _, _, sums, _, route, _ = make()
        before = ops.launch_counts()
        got = call()
        after = ops.launch_counts()
        with ops.reference_mode():
            want = call()
            planted = None if sums is None else sums[1]()
        torch.cuda.synchronize()
        rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want_rose = {kernel: 1}
        if kernel == "gemm":  # the route its plan names
            want_rose.update(launch_keys("gemm", route))
        if kernel == "bgemv":  # the form its plan names, and the body
            want_rose[f"bgemv_{route['form']}"] = 1
            if route["members"]:
                want_rose["bgemv_members"] = 1
        diff = (got.double() - want.double()).abs()
        err = diff.max().item()
        finite = bool(torch.isfinite(got).all())
        chk = dict(err=err, cond=None, tol=TOL[dtype])
        if routine == "axpy":  # the plain version's two roundings: the same bits
            chk["tol"] = "bitwise"
            ok = bool(torch.equal(got, want))
        elif sums is None:
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
        if not ok or rose != want_rose:
            emit("blas", kernel=kernel, routine=routine, case=case, dtype=str(dtype).split(".")[1],
                 max_abs_err=err, tol=chk["tol"], within_tol=ok, launches_added=rose)
            raise AssertionError(f"blas {routine} [{case}] {dtype}: within_tol={ok}, "
                                 f"launches added {rose} (want {want_rose})")
        chk["route"] = route and (
            route["form"] + (f" members={route['members']}" if route["members"] else "")
            if kernel == "bgemv" else route["route"] + (" staged" if route["stage"] else "")
            + (" copy=8B" if route["copy"] == 8 else ""))
        if kernel == "bgemv":  # bitwise on a second launch (in the timing pass)
            chk["got"] = got
        del call, got, want, diff, planted
    counts = ops.launch_counts()
    emit("launches", run="blas", **counts)
    for kernel in ("gemm", "gemv", "bgemv", "blas1_reduce", "blas1_axpy"):
        expected = sum(c[0] == kernel for c in cases)
        if counts[kernel] != expected:
            raise AssertionError(f"blas launches {counts}: {kernel} {counts[kernel]} != {expected}")

    rows = {}
    for (kernel, routine, case, dtype, make), chk in zip(cases, checked):
        call, lib, nb, flops, _, ffma, _, replaced = make()
        if "got" in chk and not torch.equal(call(), chk.pop("got")):
            raise AssertionError(f"blas {routine} [{case}] {dtype}: a second launch gave "
                                 f"other bits")
        ms = time_auto(call)
        with ops.reference_mode():
            plain_ms = time_auto(call)
        lib_ms = time_auto(lib) if lib is not None else None
        ffma_ms = time_auto(ffma) if ffma is not None else None
        replaced_ms = time_auto(replaced) if replaced is not None else None
        b_ms, by = bound(nb, flops, dtype)
        row = dict(kernel=kernel, routine=routine, case=case, dtype=str(dtype).split(".")[1],
                   route=chk["route"], max_abs_err=chk["err"], tol=chk["tol"],
                   tol_scale=("out*|plain| + acc*cond" if chk["cond"] is not None
                              else "bitwise" if routine == "axpy" else "elementwise"),
                   cond=chk["cond"], limit=chk.get("limit"),
                   planted_rejected=chk.get("planted_rejected"), within_tol=chk["ok"],
                   kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ffma_ms=ffma_ms,
                   replaced_ms=replaced_ms, bound_ms=b_ms, bound_by=by,
                   share_of_bound=b_ms / ms, bytes=nb, flops=flops)
        emit("blas", **row)
        rows[(routine, case, row["dtype"])] = row
        del call, lib, ffma, replaced
    bgemv_batch_invariance()
    return rows, counts


def bgemv_batch_invariance():
    """Two short-member shapes through ops.bgemv: members alone (a batch of
    1) bitwise the same as in a batch of 4096 (the short-member body sums a
    member in an order set by its shape alone)."""
    from repro_torch.kernels import bgemv, ops
    g = torch.Generator(device="cuda").manual_seed(95)
    for dtype, trans, (m, n) in ((torch.float64, True, (32, 32)),
                                 (torch.bfloat16, False, (64, 64))):
        shape = (4096, n, m) if trans else (4096, m, n)
        a = (torch.randn(*shape, generator=g, device="cuda") * n ** -0.5).to(dtype)
        x = torch.randn(4096, n, generator=g, device="cuda").to(dtype)
        assert bgemv.plan_for(a, x, transpose_a=trans).members
        full = ops.bgemv(a, x, transpose_a=trans)
        members = (0, 1, 2047, 4095)
        alone = [ops.bgemv(a[i:i + 1], x[i:i + 1], transpose_a=trans)[0] for i in members]
        torch.cuda.synchronize()
        same = [bool(torch.equal(full[i], y)) for i, y in zip(members, alone)]
        emit("blas", check="bgemv_batch_invariance", dtype=str(dtype).split(".")[1],
             trans=trans, member=[m, n], batch=4096, members=list(members), bitwise=same)
        if not all(same):
            raise AssertionError(f"bgemv short members {(m, n)} {dtype} trans={trans}: alone "
                                 f"and in a batch of 4096 differ ({same})")


# --------------------------------------------------------------------------
# phases 10-13: block-scaled int8 weights
# --------------------------------------------------------------------------

SERVE_SPEC = dict(block_m=64, block_n=None)   # layers.quantize_weights' spec
AWKWARD_SPEC = dict(block_m=61, block_n=None)  # _fit_block shrinks 61 to a divisor
RAGGED_KN_F32 = 'ragged gemm "kn" (4095,4097)@(4097,4093) block (61->17, N) +bias gelu +res'
RAGGED_KN_F64 = RAGGED_KN_F32.replace("ragged gemm", "ragged f64 gemm")
RAGGED_KN_BF16 = 'ragged gemm "kn" (4095,4096)@(4096,2064) block (64, N)'


def int8_plan(b: int, k: int, n: int, dtype, gate: bool) -> dict:
    """kernels.bgemv.plan_int8 of a packed GEMV case, as a dict."""
    from repro_torch.kernels import bgemv
    return dataclasses.asdict(bgemv.plan_int8(b, k, n, dtype, gate=gate))


def quant_cases():
    """(packed kernel counter, dense counter, case, dtype, make, route key)
    for every int8 case; make() builds the inputs from a seeded generator and
    returns (call through core.blas, the same call on the dense weight,
    bytes, flops, ffma: csrc/gemm.cu's int8-B kernel on the same inputs where
    a GEMM runs, replaced: the packed GEMV's first design on the same inputs
    where the call runs csrc/qgemv.cu, plan: the packed GEMV's, deq: under
    f64 A the same call on the dequantized B (`dequantize_in(B, float64)`),
    whose bits the packed launch must give).  Bytes count the int8 values,
    the f32 scales, the activations and the output once each.  The route key
    is the launch count each call adds beside its kernel's: bf16 GEMMs over
    the serving layout ("nk", one scale block across K) and over "kn" with a
    scale block of whole k-steps on the tensor cores (8192^3, and ragged
    with the gate and with bias, gelu and the residual), f32 ones whose int8
    rows TMA can address on the f32 ring (the dense f32 ring the `dense`
    call), f64 ones on the f64 tensor cores (every layout; the ragged one on
    operands staged into rows padded to 16 bytes), the rest on the first
    CUDA-core kernel."""
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
            ffma = replaced = None
            if rows > 1 and dtype == torch.bfloat16:
                fkw = {("b2" if k == "w2" else k): v for k, v in kw.items()}
                ffma = lambda: ffma_launch(x, qw, **fkw)  # noqa: E731
            if rows == 1:
                rkw = {("qw2" if k == "w2" else k): (v.reshape(4, f) if k == "residual" else v)
                       for k, v in kw.items()}
                replaced = lambda: replaced_qgemv(qw, x.reshape(4, d), **rkw)  # noqa: E731
            return (lambda: blas.matmul_fused(x, qw, **kw),
                    lambda: blas.matmul_fused(x, w, **dense_kw),
                    nbytes(x, qw.values, qw.scales) + extra + out,
                    2 * 4 * rows * d * f * (2 if epi == "gate" else 1), ffma, replaced,
                    int8_plan(4, d, f, dtype, epi == "gate") if rows == 1 else None, None)
        return make

    def gemm_case(dtype, m, k, n, seed, transpose, spec=SERVE_SPEC, epi=None):
        """epi: None, "all" (bias, gelu, residual) or "gate" (B2, silu)"""
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a, b = rnd(g, dtype, m, k), rnd(g, dtype, k, n, std=k ** -0.5)
            qb = pack(b, spec, transpose)
            kw, fkw, dense_kw, extra, qb2 = {}, {}, {}, 0, None
            if epi == "all":
                bias, res = rnd(g, dtype, n), rnd(g, dtype, m, n)
                kw = dense_kw = dict(bias=bias, residual=res, epilogue="gelu")
                fkw, extra = dict(bias=bias, residual=res, activation="gelu"), nbytes(bias, res)
            elif epi == "gate":
                b2 = rnd(g, dtype, k, n, std=k ** -0.5)
                qb2 = pack(b2, spec, transpose)
                kw, dense_kw = dict(B2=qb2, epilogue="silu"), dict(B2=b2, epilogue="silu")
                fkw, extra = dict(b2=qb2, activation="silu"), nbytes(qb2.values, qb2.scales)
            deq = None
            if dtype == torch.float64:  # the dense launch on the dequantized B (and B2)
                def deq():
                    d2 = {} if qb2 is None else dict(
                        B2=quant.dequantize_in(qb2, dtype).contiguous())
                    return blas.gemm(a, quant.dequantize_in(qb, dtype).contiguous(),
                                     **dict(kw, **d2))
            return (lambda: blas.gemm(a, qb, **kw), lambda: blas.gemm(a, b, **dense_kw),
                    nbytes(a, qb.values, qb.scales) + extra + m * n * a.element_size(),
                    2 * m * n * k * (2 if epi == "gate" else 1),
                    lambda: ffma_launch(a, qb, **fkw), None, None, deq)
        return make

    def gemv_case(dtype, m, n, seed, spec=SERVE_SPEC):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            a, x = rnd(g, dtype, m, n, std=n ** -0.5), rnd(g, dtype, n)
            qa = pack(a, spec, False)
            return (lambda: blas.gemv(qa, x), lambda: blas.gemv(a, x),
                    nbytes(qa.values, qa.scales, x) + m * x.element_size(), 2 * m * n, None,
                    lambda: replaced_qgemv(qa, x[None]), int8_plan(1, n, m, dtype, False), None)
        return make

    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    cases = []
    for rows, kernel, dense, what, route in ((1, "bgemv_int8", "bgemv", "decode", None),
                                             (128, "gemm_int8", "bgemm", "prefill",
                                              "bgemm_wgmma")):
        shape = f"4x{rows}x"
        cases += [
            (kernel, dense, f"{what} qkv {shape}2048->2048 +bias", bf16,
             proj_case(bf16, rows, 2048, 2048, 60 + rows, "bias"), route),
            (kernel, dense, f"{what} wo {shape}2048->2048 +residual", bf16,
             proj_case(bf16, rows, 2048, 2048, 61 + rows, "residual"), route),
            (kernel, dense, f"{what} gate_up {shape}2048->5632 x2 silu-gate", bf16,
             proj_case(bf16, rows, 2048, 5632, 62 + rows, "gate"), route),
            (kernel, dense, f"{what} down {shape}5632->2048 +residual", bf16,
             proj_case(bf16, rows, 5632, 2048, 63 + rows, "residual"), route),
        ]
    for i, (dt, transpose) in enumerate(((f32, False), (f32, True), (bf16, False), (bf16, True),
                                         (f64, False), (f64, True))):
        layout = "nk" if transpose else "kn"
        route = {bf16: "gemm_wgmma", f32: "gemm_ffma_sm90", f64: "gemm_dmma"}[dt]
        cases.append(("gemm_int8", "gemm", f'gemm "{layout}" {D8K}x{D8K}x{D8K}', dt,
                      gemm_case(dt, D8K, D8K, D8K, 70 + i, transpose), route))
    for i, dt in enumerate((f32, f64)):
        cases.append(("gemv_int8", "gemv", f"gemv {N16K}x{N16K}", dt,
                      gemv_case(dt, N16K, N16K, 80 + i), None))
    cases += [
        ("bgemv_int8", "bgemv", "ragged decode 4x4097->4095 block (61->45, K) +bias gelu +res", f32,
         proj_case(f32, 1, 4097, 4095, 90, "all", AWKWARD_SPEC), None),
        ("gemm_int8", "gemm", RAGGED_KN_F32, f32,
         gemm_case(f32, 4095, 4097, 4093, 91, False, AWKWARD_SPEC, "all"), "gemm_ffma"),
        ("gemm_int8", "gemm", RAGGED_KN_F64, f64,
         gemm_case(f64, 4095, 4097, 4093, 93, False, AWKWARD_SPEC, "all"), "gemm_dmma"),
        ("gemm_int8", "gemm", f"{RAGGED_KN_BF16} x2 silu-gate", bf16,
         gemm_case(bf16, 4095, 4096, 2064, 94, False, epi="gate"), "gemm_wgmma"),
        ("gemm_int8", "gemm", f"{RAGGED_KN_BF16} +bias gelu +res", bf16,
         gemm_case(bf16, 4095, 4096, 2064, 95, False, epi="all"), "gemm_wgmma"),
        ("gemv_int8", "gemv", "ragged gemv 4095x4097 block (61->45, K)", f32,
         gemv_case(f32, 4095, 4097, 92, AWKWARD_SPEC), None),
    ]
    return cases


def phase_quant_kernels():
    """Drive every int8 case once through core.blas with the launch counts
    reset just before (each call must add exactly one launch to its packed
    kernel's count), hold it against its plain version (under f64 A also
    bitwise against the dense launch on the dequantized B), then time it
    beside its bound, its plain version, the dense kernel at the same shape,
    for a GEMM `gemm.cu`'s int8-B kernel (`ffma_ms`) and, for a packed GEMV,
    the design it replaced (`replaced_ms`) and its plan; a GEMM's or a split
    plan's launch is held bitwise against a second launch.  Returns (rows,
    the phase's launch counts, the launches each case added)."""
    from repro_torch.kernels import ops
    cases = quant_cases()
    errs, added = [], {}
    ops.reset_launch_counts()
    for kernel, _, case, dtype, make, route in cases:
        made = make()
        call, deq = made[0], made[7]
        before = ops.launch_counts()
        got = call()
        after = ops.launch_counts()
        with ops.reference_mode():
            want = call()
        dense_bits = bool(torch.equal(got, deq())) if deq is not None else None
        torch.cuda.synchronize()
        rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want_rose = {kernel: 1, **({route: 1} if route else {})}
        err = (got.double() - want.double()).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(got).all()) and got.dtype == dtype and got.shape == want.shape
              and torch.allclose(got.double(), want.double(), **tol))
        errs.append((err, ok, dense_bits))
        added[(case, str(dtype).split(".")[1])] = rose
        if not ok or rose != want_rose or dense_bits is False:
            emit("quant_kernels", kernel=kernel, case=case, dtype=str(dtype).split(".")[1],
                 max_abs_err=err, tol=tol, within_tol=ok, launches_added=rose,
                 bitwise_dense_on_dequantized=dense_bits)
            raise AssertionError(f"int8 [{case}] {dtype}: within_tol={ok}, launches added "
                                 f"{rose} (want {want_rose}), bitwise the dense launch on the "
                                 f"dequantized B: {dense_bits}")
        del call, got, want, made
    counts = ops.launch_counts()
    emit("launches", run="quant_kernels", **counts)
    for kernel in ("bgemv_int8", "gemm_int8", "gemv_int8"):
        expected = sum(c[0] == kernel for c in cases)
        if counts[kernel] != expected:
            raise AssertionError(f"int8 launches {counts}: {kernel} {counts[kernel]} != {expected}")

    rows = {}
    for (kernel, dense, case, dtype, make, route), (err, ok, dense_bits) in zip(cases, errs):
        call, dense_call, nb, flops, ffma, replaced, plan, _ = make()
        same = replaced_err = None
        if replaced is not None or kernel == "gemm_int8" and ffma is not None:
            got = call()  # two launches' bits; the packed GEMV's first design
            same = split_deterministic(call, got)
            if replaced is not None:
                replaced_err = (replaced().double() - got.reshape(-1, got.shape[-1]).double()
                                ).abs().max().item()
            del got
        ms = time_auto(call)
        with ops.reference_mode():
            plain_ms = time_auto(call)
        dense_ms = time_auto(dense_call)
        ffma_ms = time_auto(ffma) if ffma is not None else None
        replaced_ms = time_auto(replaced) if replaced is not None else None
        b_ms, by = bound(nb, flops, dtype)
        row = dict(kernel=kernel, case=case, dtype=str(dtype).split(".")[1], route=route,
                   max_abs_err=err, tol=TOL[dtype], within_tol=ok, kernel_ms=ms,
                   plain_ms=plain_ms, ffma_ms=ffma_ms, dense_kernel=dense,
                   dense_ms=dense_ms, replaced_ms=replaced_ms,
                   replaced="scripts/replaced/qgemv_rows4.cu" if replaced else None,
                   replaced_max_abs_diff=replaced_err, plan=plan, bitwise_deterministic=same,
                   bitwise_dense_on_dequantized=dense_bits,
                   bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms, bytes=nb, flops=flops)
        emit("quant_kernels", **row)
        rows[(kernel, case, row["dtype"])] = row
        if same is False:
            raise AssertionError(f"int8 [{case}] {dtype}: two launches differ")
        del call, dense_call, ffma, replaced
    return rows, counts, added


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
    ops.reset_launch_counts()
    got = serve(ARCH, "smoke", **kw)
    check_f32_routes(ops.launch_counts(), "smoke_int8")
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


def check_prefill_routes(counts: dict, what: str):
    """Every prefill projection of a full-width bf16 serve (bgemm, dense or
    int8 "nk"; the serves run no 2-D packed gemm) ran on the tensor cores:
    bgemm_wgmma counts them all and bgemm_ffma none."""
    projections = counts["bgemm"] + counts["gemm_int8"]
    routes = {k: counts[k] for k in ("bgemm_wgmma", "bgemm_wgmma_staged", "bgemm_ffma",
                                     "gemm_wgmma", "gemm_wgmma_staged", "gemm_ffma")}
    emit("routes", run=what, prefill_projections=projections, **routes)
    if projections == 0 or counts["bgemm_wgmma"] != projections or counts["bgemm_ffma"]:
        raise AssertionError(f"{what}: {projections} prefill projections, routes {routes}: "
                             "not all on wgmma")


def check_f32_routes(counts: dict, what: str):
    """An f32 serve's GEMMs, dense and packed: every gemm, bgemm and int8-B
    launch, and every batched (expert) launch, on the "ffma_sm90" route,
    none on the first CUDA-core kernel or the tensor cores; at least one
    prefill projection among them."""
    routes = {k: counts[k] for k in ("gemm", "gemm_ffma_sm90", "gemm_wgmma", "gemm_ffma",
                                     "bgemm", "bgemm_ffma_sm90", "bgemm_wgmma", "bgemm_ffma",
                                     "gemm_int8", "bgemm_batched", "bgemm_batched_ffma_sm90",
                                     "bgemm_batched_ffma", "bgemm_batched_wgmma")}
    emit("routes", run=what, **routes)
    launched = counts["gemm"] + counts["bgemm"] + counts["gemm_int8"]
    if (counts["bgemm"] + counts["gemm_int8"] == 0
            or counts["gemm_ffma_sm90"] + counts["bgemm_ffma_sm90"] != launched
            or counts["bgemm_batched_ffma_sm90"] != counts["bgemm_batched"]
            or counts["gemm_ffma"] or counts["bgemm_ffma"] or counts["bgemm_batched_ffma"]):
        raise AssertionError(f"{what}: f32 GEMM routes {routes}: not all on 'ffma_sm90'")


def check_attention_routes(what: str, layers: int, f32: bool = False) -> dict:
    """Every attention launch since the last reset on the route its shape
    takes: each prefill (Tq > 1) on "mma" in bf16 or "ffma" in f32, each
    decode step on "splitkv"; both a whole number of forwards of `layers`
    attention launches.  Emits a "routes" line; returns the counts."""
    from repro_torch.kernels import ops
    routes = ops.attention_routes()
    prefill, other = ("ffma", "mma") if f32 else ("mma", "ffma")
    emit("routes", run=what, attention=routes)
    if (routes[other] or not routes[prefill] or not routes["splitkv"]
            or routes[prefill] % layers or routes["splitkv"] % layers):
        raise AssertionError(f"{what}: attention routes {routes}: prefills not all on "
                             f"{prefill!r} or decode steps not all on 'splitkv'")
    return routes


# --------------------------------------------------------------------------
# phases 14-18: the int8 and paged KV cache
# --------------------------------------------------------------------------

def kv_case(dtype, int8, page_size, *, b=4, tq=1, h=32, kvh=32, d=64, lens=(129, 140, 150, 160),
            s=None, seed=0):
    """One attention case on the card: q (B, Tq, H, D) and a dense cache
    (B, S, KVH, D) in `dtype` or int8 with per-(token, head) f32 scales,
    garbage past each slot's length (NaN values, or random int8 under NaN
    scales).  With page_size the same keys also sit in a pool under a
    shuffled table whose dead entries point at the trash page 0.  Returns
    (q, kv_lens, form operands, the dense operands the table gathers, the
    gathered cache dequantized to q's dtype)."""
    from repro_torch.core import quant
    from repro_torch.kernels.attention import gather_pages
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = s or max(lens)
    q = torch.randn(b, tq, h, d, generator=g, device="cuda").to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
    dense = {}
    for name in "kv":
        x = torch.randn(b, s, kvh, d, generator=g, device="cuda")
        if int8:
            qt = quant.quantize_kv(x)
            dense[name], dense[name + "_scales"] = qt.values, qt.scales
            for i, n in enumerate(lens):
                qt.values[i, n:] = torch.randint(-127, 128, qt.values[i, n:].shape, generator=g,
                                                 device="cuda", dtype=torch.int8)
                qt.scales[i, n:] = float("nan")
        else:
            x = x.to(dtype)
            for i, n in enumerate(lens):
                x[i, n:] = float("nan")
            dense[name] = x
    form = dict(dense)
    if page_size:
        max_pages = -(-s // page_size)
        num_pages = 1 + b * max_pages
        table = (torch.randperm(num_pages - 1, generator=g, device="cuda") + 1).reshape(
            b, max_pages).to(torch.int32)
        for i, n in enumerate(lens):
            table[i, -(-n // page_size):] = 0
        live = table != 0
        form = {"page_table": table}
        for name, t in dense.items():
            tail = tuple(t.shape[2:])
            pool = (torch.randint(-127, 128, (num_pages, page_size) + tail, generator=g,
                                  device="cuda", dtype=torch.int8) if int8 and t.dtype == torch.int8
                    else torch.full((num_pages, page_size) + tail, float("nan"), device="cuda",
                                    dtype=t.dtype))
            padded = torch.zeros((b, max_pages * page_size) + tail, dtype=t.dtype, device="cuda")
            padded[:, :s] = t
            pool[table[live].long()] = padded.reshape((b, max_pages, page_size) + tail)[live]
            form[name] = pool
        dense = {k: gather_pages(v, table).contiguous() for k, v in form.items()
                 if k != "page_table"}
    if int8:
        deq = {n: (dense[n].float() * dense[n + "_scales"]).to(dtype) for n in "kv"}
    else:
        deq = {n: dense[n] for n in "kv"}
    return q, kv_lens, form, dense, deq


def attend(q, kv_lens, ops_kw, **mask):
    from repro_torch.kernels import ops
    g = q.shape[2] // ops_kw["k"].shape[2]
    return ops.flash_attention(q, ops_kw["k"], ops_kw["v"], kv_lens=kv_lens, kv_groups=g,
                               k_scales=ops_kw.get("k_scales"), v_scales=ops_kw.get("v_scales"),
                               page_table=ops_kw.get("page_table"), **mask)


KV_CASES = [  # (label, q dtype, int8, page size, kv_case keywords)
    ("decode bf16 paged P=16 B=4 H=32 D=64 S=160", torch.bfloat16, False, 16, {}),
    ("decode int8 dense B=4 H=32 D=64 S=160", torch.bfloat16, True, None, {}),
    ("decode int8 paged P=16 B=4 H=32 D=64 S=160", torch.bfloat16, True, 16, {}),
    ("prefill int8 dense B=4 Tq=128 H=32 D=64 S=160", torch.bfloat16, True, None,
     dict(tq=128, lens=(128,) * 4, s=160)),
    ("prefill bf16 paged P=16 B=4 Tq=128 H=32 D=64 S=160", torch.bfloat16, False, 16,
     dict(tq=128, lens=(128,) * 4, s=160)),
    ("decode bf16 GQA H=32/KVH=8 B=4 D=64 S=160", torch.bfloat16, False, None, dict(kvh=8)),
    ("long bf16 dense B=4 Tq=1 S=4096", torch.bfloat16, False, None, dict(lens=(4096,) * 4)),
    ("long bf16 paged P=16 B=4 Tq=1 S=4096", torch.bfloat16, False, 16, dict(lens=(4096,) * 4)),
    ("long int8 dense B=4 Tq=1 S=4096", torch.bfloat16, True, None, dict(lens=(4096,) * 4)),
    ("long int8 paged P=16 B=4 Tq=1 S=4096", torch.bfloat16, True, 16, dict(lens=(4096,) * 4)),
    ("ragged f32 paged P=7 GQA H=32/KVH=8 D=128 lens 2048/1031/517/75", torch.float32, False, 7,
     dict(kvh=8, d=128, lens=(2048, 1031, 517, 75))),
    # f32 prefills ("ffma") at the smoke head dims: Tq off the 64-query
    # tile, kv lengths past Tq, NaN past each length
    ("prefill f32 dense B=4 Tq=100 H=4/KVH=2 D=16 lens 160/131/100/117", torch.float32, False,
     None, dict(tq=100, h=4, kvh=2, d=16, lens=(160, 131, 100, 117))),
    ("prefill f32 paged P=7 B=4 Tq=100 H=4/KVH=2 D=16 lens 160/131/100/117", torch.float32,
     False, 7, dict(tq=100, h=4, kvh=2, d=16, lens=(160, 131, 100, 117))),
    ("prefill f32 int8 dense B=4 Tq=70 H=8/KVH=2 D=32 lens 200/70/133/97", torch.float32, True,
     None, dict(tq=70, h=8, kvh=2, d=32, lens=(200, 70, 133, 97))),
    ("prefill f32 int8 paged P=16 B=4 Tq=70 H=8/KVH=2 D=32 lens 200/70/133/97", torch.float32,
     True, 16, dict(tq=70, h=8, kvh=2, d=32, lens=(200, 70, 133, 97))),
]


def one_slot(q, kv_lens, form, i: int):
    """Slot i of a kv_case alone: its q and kv lengths and, dense, its cache
    rows (paged: its table row over the same pool)."""
    h = q.shape[2]
    one = {}
    for name, t in form.items():
        if name == "page_table" or "page_table" not in form:
            one[name] = t[i:i + 1]
        else:
            one[name] = t
    return q[i:i + 1], kv_lens[i * h:(i + 1) * h], one


def phase_attention_kv():
    """Each int8 / paged attention case once with the counts reset (one
    launch of its form, on the route its plan names), against its plain
    version (and, paged, bitwise against the dense launch on the cache its
    table gathers; bitwise against a second launch; an f32 prefill's last
    slot bitwise alone and in the batch), then timed (cold L2, median of 20)
    beside its bound, its plain version, sdpa on the gathered dequantized
    cache, the dense kernel at the same shape and the f32 route's first
    design (scripts/replaced/attention_first.cu) on the same inputs."""
    from repro_torch.kernels import attention, ops
    rows = {}
    for i, (label, dtype, int8, page_size, kw) in enumerate(KV_CASES):
        q, kv_lens, form, dense, deq = kv_case(dtype, int8, page_size, seed=100 + i, **kw)
        p = attention.plan_for(q, form["k"], form.get("page_table"), int8)
        ops.reset_launch_counts()
        got = attend(q, kv_lens, form)
        counts = ops.launch_counts()
        routes = ops.attention_routes()
        with ops.reference_mode():
            want = attend(q, kv_lens, form)
        same_as_dense = None
        if page_size:
            same_as_dense = bool(torch.equal(got, attend(q, kv_lens, dense)))
        same_twice = bool(torch.equal(got, attend(q, kv_lens, form)))
        same_alone = None
        if p.route == "ffma":  # the last slot's rows alone, as in the batch
            last = q.shape[0] - 1
            same_alone = bool(torch.equal(got[last:], attend(*one_slot(q, kv_lens, form, last))))
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(),
                                                                **TOL[dtype])
        want_counts = {"attention": int(not int8 and not page_size),
                       "attention_int8": int(int8), "attention_paged": int(bool(page_size)),
                       "route_" + p.route: 1}
        rose = {k: counts[k] if k in counts else routes[k[6:]] for k in want_counts}
        if sum(routes.values()) != 1:
            rose["other_routes"] = routes
        b, tq, h, d = q.shape
        lens = kw.get("lens", (129, 140, 150, 160))
        kvh = kw.get("kvh", 32)
        kv_bytes = sum(lens) * kvh * d * 2 * (1 if int8 else q.element_size())
        if int8:
            kv_bytes += sum(lens) * kvh * 2 * 4
        nb = kv_bytes + 2 * nbytes(q) + nbytes(kv_lens, form.get("page_table"))
        pairs = sum(min(t + n - tq + 1, n) for n in lens for t in range(tq)) * h
        b_ms, by = bound(nb, 4 * pairs * d, dtype)
        fields = dict(case=label, dtype=str(dtype).split(".")[1], route=p.route,
                      splits=p.splits, chunk=p.chunk, per_block=p.per_block,
                      block_q=p.block_q, block_k=p.block_k, max_abs_err=err, tol=TOL[dtype],
                      within_tol=ok, launches_added=rose,
                      bitwise_equal_to_dense_on_gathered=same_as_dense,
                      bitwise_equal_second_launch=same_twice,
                      bitwise_equal_slot_alone=same_alone)
        if (not ok or rose != want_counts or same_as_dense is False or not same_twice
                or same_alone is False):
            emit("attention_kv", **fields)
            raise AssertionError(f"attention [{label}]: within_tol={ok}, launches {rose} "
                                 f"(want {want_counts}), paged == dense {same_as_dense}, "
                                 f"second launch equal {same_twice}, slot alone equal "
                                 f"{same_alone}")
        del got, want
        ms = time_ms(lambda: attend(q, kv_lens, form))
        with ops.reference_mode():
            plain_ms = time_ms(lambda: attend(q, kv_lens, form))
        dense_ms = time_ms(lambda: attend(q, kv_lens, deq))
        replaced_ms = time_ms(lambda: replaced_attention(
            q, form["k"], form["v"], kv_lens, k_scales=form.get("k_scales"),
            v_scales=form.get("v_scales"), page_table=form.get("page_table")))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, deq["k"], deq["v"]))
        s = kt.shape[2]
        kpos = torch.arange(s, device="cuda")
        lens_t = torch.tensor(lens, device="cuda")
        qpos = torch.arange(tq, device="cuda")[None, :] + (lens_t - tq)[:, None]
        mask = ((kpos[None, None, :] <= qpos[..., None])
                & (kpos[None, None, :] < lens_t[:, None, None]))[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh))
        row = dict(fields, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library="sdpa on the gathered, dequantized cache", dense_kernel_ms=dense_ms,
                   replaced_ms=replaced_ms,
                   bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms, bytes=nb,
                   flops=4 * pairs * d)
        emit("attention_kv", **row)
        rows[label] = row
        del q, form, dense, deq, qt, kt, vt, mask
    return rows


def check_kv_launches(counts: dict, what: str, n_layers: int, prefills: int, steps: int,
                      int8: bool, paged: bool, paged_prefill: bool = False):
    """Attention launches by form over `prefills` prefills and `steps`
    decode steps (a serve adds its warm-up: one of each).  The continuous
    scheduler prefills over the dense admission cache; the batch scheduler
    (paged_prefill) prefills into the group's paged cache.  A paged decode
    runs only the paged form."""
    pre, dec = n_layers * prefills, n_layers * steps
    paged_pre = pre if paged and paged_prefill else 0
    want = {"attention": 0 if int8 else pre - paged_pre + (0 if paged else dec),
            "attention_int8": pre + dec if int8 else 0,
            "attention_paged": paged_pre + dec if paged else 0}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{what} attention launches {counts}: (got, want) {bad}")


def shared_prefix_prompts(vocab, n=6, sys_len=10, tail=3, seed=11):
    """tests/test_paged.py's prompts: even requests share a system prompt."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(3, vocab, size=(sys_len,), dtype=np.int32)
    return [np.concatenate([sysp, rng.integers(3, vocab, size=(tail,), dtype=np.int32)])
            if i % 2 == 0 else rng.integers(3, vocab, size=(sys_len + tail,), dtype=np.int32)
            for i in range(n)]


def phase_smoke_kv():
    """SMOKE f32 serves with the int8 and paged KV cache: kernels against
    the plain versions (equal tokens), paged against dense, a pressured
    pool against the default one; every attention launch by form."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH, "smoke")
    params = tf.init_params(cfg, 0, "cuda")
    shared = dict(batch=3, prompts=shared_prefix_prompts(cfg.vocab),
                  gen_lens=[4, 2, 5, 3, 4, 2])
    rng = np.random.default_rng(0)
    ci_prompts = [rng.integers(3, 256, size=(10,), dtype=np.int32) for _ in range(6)]
    ci = dict(batch=2, prompts=ci_prompts, gen_lens=rng.integers(4, 9, size=6).tolist(),
              kv_page_size=4)
    runs = [("model dense", shared, {}), ("model paged reuse", shared, dict(kv_page_size=4)),
            ("model paged no-reuse", shared, dict(kv_page_size=4, prefix_reuse=False)),
            ("int8 dense", shared, dict(kv_cache="int8")),
            ("int8 paged reuse", shared, dict(kv_cache="int8", kv_page_size=4)),
            ("ci default pool", ci, {}), ("ci pool_pages=7", ci, dict(pool_pages=7))]
    out = {}
    for name, base, kw in runs:
        args = dict(base, **kw, eos=-1, params=params, verbose=False, device="cuda")
        ops.reset_launch_counts()
        got = serve(ARCH, "smoke", **args)
        counts = ops.launch_counts()
        with ops.reference_mode():
            want = serve(ARCH, "smoke", **args)
        check_kv_launches(counts, f"smoke_kv {name}", cfg.n_layers, got["prefills"] + 1,
                          got["decode_steps"] + 1, args.get("kv_cache") == "int8",
                          "kv_page_size" in args)
        check_f32_routes(counts, f"smoke_kv {name}")
        fields = {k: got.get(k) for k in ("pages_live", "pages_shared", "cow_copies",
                                          "paged_capacity_multiplier", "preemptions",
                                          "rejections")}
        equal = got["outputs"] == want["outputs"]
        emit("smoke_kv", run=name, dtype="float32", tokens_equal_plain=equal,
             completed=got["completed"], status=got["status"], **fields,
             launches={k: counts[k] for k in ("attention", "attention_int8", "attention_paged")})
        if not equal:
            raise AssertionError(f"smoke_kv {name}: kernels {got['outputs']} != plain "
                                 f"{want['outputs']}")
        out[name] = got
    pairs = [("model paged reuse", "model dense"), ("model paged no-reuse", "model dense"),
             ("int8 paged reuse", "int8 dense"), ("ci pool_pages=7", "ci default pool")]
    for a, b in pairs:
        if out[a]["outputs"] != out[b]["outputs"]:
            raise AssertionError(f"smoke_kv: {a} tokens differ from {b}")
    if out["ci pool_pages=7"]["preemptions"] < 1 or out["model paged reuse"]["pages_shared"] < 1:
        raise AssertionError("smoke_kv: the small pool never preempted, or nothing was shared")


def resume_segments(prompts, stats):
    """A serve's output split at each admission of each request: (request,
    first token, end, admission prompt = prompt + the tokens emitted before
    it).  One segment a request unless it was preempted."""
    segs = []
    for rid, starts in enumerate(stats["admitted_at"]):
        out = stats["outputs"][rid]
        for i, n in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else len(out)
            segs.append((rid, n, end, np.concatenate([prompts[rid], np.asarray(out[:n], np.int32)])))
    return segs


def phase_serve_paged(params, cfg):
    """FULL bf16, 8 requests of a 96-token shared system prompt + 32 unique
    tokens, gen 32, batch 4: dense, paged (page 16), and paged in a pool of
    about 2/3 of the paged run's peak pages.  The paged run must give the
    dense run's tokens.  The pressured run resumes each preempted request
    by prefilling its prompt + emitted tokens, which the unpressured runs
    decoded one by one: every segment between two admissions must equal a
    dense serve started from that admission's prompt (exact), and its
    agreement with the unpressured tokens is recorded.  Returns the paged
    run's stats and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    rng = np.random.default_rng(7)
    sysp = rng.integers(3, cfg.vocab, size=96, dtype=np.int32)
    prompts = [np.concatenate([sysp, rng.integers(3, cfg.vocab, size=32, dtype=np.int32)])
               for _ in range(8)]
    kw = dict(batch=4, eos=-1, params=params, verbose=False, device="cuda")
    dense = serve(ARCH, "full", prompts=prompts, gen=32, **kw)
    ops.reset_launch_counts()
    paged = serve(ARCH, "full", prompts=prompts, gen=32, kv_page_size=16, **kw)
    counts = ops.launch_counts()
    check_attention_routes("serve_paged", cfg.n_layers)
    check_kv_launches(counts, "serve_paged", cfg.n_layers, paged["prefills"] + 1,
                      paged["decode_steps"] + 1, False, True)
    pool = max(10, round(2 * paged["pages_live"] / 3))
    pressed = serve(ARCH, "full", prompts=prompts, gen=32, kv_page_size=16, pool_pages=pool, **kw)
    segs = resume_segments(prompts, pressed)
    recomputed = serve(ARCH, "full", prompts=[sg[3] for sg in segs],
                       gen_lens=[sg[2] - sg[1] for sg in segs], **kw)
    seg_equal = [recomputed["outputs"][j] == pressed["outputs"][rid][n:end]
                 for j, (rid, n, end, _) in enumerate(segs)]
    first = [pressed["admitted_at"][r][1] if len(pressed["admitted_at"][r]) > 1 else 32
             for r in range(8)]
    agree = [a == b for o, p in zip(pressed["outputs"], dense["outputs"]) for a, b in zip(o, p)]
    for name, st in (("paged", paged), ("pressured", pressed)):
        extra = {}
        if st is pressed:
            extra = dict(pool_pages=pool, resume_segments=len(segs),
                         segments_equal_dense_recompute=sum(seg_equal),
                         token_agreement_with_dense=sum(agree) / len(agree),
                         tokens_before_first_resume_equal_dense=all(
                             o[:f] == p[:f] for o, p, f in
                             zip(pressed["outputs"], dense["outputs"], first)),
                         recompute_tok_s=recomputed["tok_s"])
        emit("serve_paged", run=name, arch=ARCH, variant="full", dtype="bfloat16", requests=8,
             batch=4, prompt="96 shared + 32 unique", gen=32, kv_page_size=16,
             completed=st["completed"], tokens_equal_dense=st["outputs"] == dense["outputs"],
             tok_s=st["tok_s"], ttft_p50_s=statistics.median(st["ttft"]),
             prefills=st["prefills"], decode_steps=st["decode_steps"],
             pages_live=st["pages_live"], pages_shared=st["pages_shared"],
             cow_copies=st["cow_copies"],
             paged_capacity_multiplier=st["paged_capacity_multiplier"],
             preemptions=st["preemptions"], status=st["status"],
             dense_tok_s=dense["tok_s"], dense_ttft_p50_s=statistics.median(dense["ttft"]),
             **extra)
    if paged["outputs"] != dense["outputs"] or paged["completed"] != 8:
        raise AssertionError("serve_paged: paged tokens differ from the dense serve's")
    if paged["pages_shared"] < 1 or paged["paged_capacity_multiplier"] <= 1:
        raise AssertionError(f"serve_paged: nothing shared ({paged['pages_shared']} pages, "
                             f"x{paged['paged_capacity_multiplier']})")
    if (pressed["preemptions"] < 1 or not all(seg_equal) or pressed["completed"] != 8
            or any(len(o) != 32 for o in pressed["outputs"])):
        raise AssertionError(f"serve_paged pool {pool}: {pressed['preemptions']} preemptions, "
                             f"{sum(seg_equal)}/{len(segs)} segments equal their dense "
                             f"recompute, completed {pressed['completed']}")
    return paged, counts


def phase_serve_kv_int8(params, qparams, cfg):
    """FULL --kv-cache int8, dense and paged (page 16), with bf16 and with
    int8 weights: paged tokens equal dense tokens; the pools' bytes against
    the bf16 cache's.  Returns the bf16-weight dense run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    kw = dict(requests=8, batch=4, prompt_len=128, gen=32, seed=0, eos=-1, verbose=False,
              kv_cache="int8", device="cuda")
    main_counts = None
    for weights, p in (("bf16", params), ("int8", qparams)):
        runs = {}
        for page_size in (None, 16):
            ops.reset_launch_counts()
            st = serve(ARCH, "full", params=p, kv_page_size=page_size, **kw)
            counts = ops.launch_counts()
            check_attention_routes(f"serve_kv_int8 {weights} weights page {page_size}",
                                   cfg.n_layers)
            check_kv_launches(counts, f"serve_kv_int8 {weights} weights", cfg.n_layers,
                              st["prefills"] + 1, st["decode_steps"] + 1, True,
                              page_size is not None)
            if weights == "bf16" and page_size is None:
                main_counts = counts
            runs[page_size] = st
            emit("serve_kv_int8", weights=weights, kv_cache="int8", kv_page_size=page_size,
                 completed=st["completed"], tok_s=st["tok_s"], elapsed_s=st["elapsed_s"],
                 ttft_p50_s=statistics.median(st["ttft"]), prefills=st["prefills"],
                 decode_steps=st["decode_steps"], pages_live=st.get("pages_live"),
                 launches={k: counts[k] for k in ("attention", "attention_int8",
                                                  "attention_paged")})
            if st["completed"] != 8 or any(len(o) != 32 for o in st["outputs"]):
                raise AssertionError(f"serve_kv_int8 {weights}/{page_size}: incomplete")
        if runs[16]["outputs"] != runs[None]["outputs"]:
            raise AssertionError(f"serve_kv_int8 {weights} weights: paged int8 tokens differ "
                                 "from dense int8 tokens")
    int8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    pools = {name: sum(nbytes(t) for k, t in tf.init_cache(c, 4, 160, device="cuda").items()
                       if k != "pos")
             for name, c in (("bf16", cfg), ("int8", int8_cfg))}
    emit("serve_kv_int8", what="dense KV cache bytes, batch 4, 160 positions, 24 layers",
         bf16_bytes=pools["bf16"], int8_bytes=pools["int8"],
         ratio=pools["int8"] / pools["bf16"])
    return main_counts


# --------------------------------------------------------------------------
# phases 19-25: rwkv6-1.6b under the batch scheduler, and the dense batch
# scheduler
# --------------------------------------------------------------------------

RWKV = "rwkv6-1.6b"
# exp evaluations a second on the special-function units: 16 a clock on each
# of the 132 SMs at the ~1.98 GHz boost clock (reported beside the bound,
# not part of it)
SFU_EXP_S = 132 * 16 * 1.98e9

WKV6_CASES = [  # (label, BH, T, K = V, r/k/v dtype, from s0, log-decay range, chunk)
    ("prefill B=4 H=32 T=128 K=V=64 bf16 from zero", 128, 128, 64, torch.bfloat16, False,
     (-6.0, 0.0), 32),
    ("prefill B=4 H=32 T=128 K=V=64 bf16 from s0", 128, 128, 64, torch.bfloat16, True,
     (-6.0, 0.0), 32),
    ("long B=1 H=32 T=4096 K=V=64 bf16 from s0", 32, 4096, 64, torch.bfloat16, True,
     (-6.0, 0.0), 32),
    ("ragged B=4 H=32 T=100 K=V=64 bf16 from s0", 128, 100, 64, torch.bfloat16, True,
     (-6.0, 0.0), 32),
    ("smoke f32 B=4 H=4 T=10 K=V=16 chunk 8 from s0", 16, 10, 16, torch.float32, True,
     (-6.0, 0.0), 8),
    ("strong decay w_log in [-20, -15] B=4 H=32 T=128 bf16 from s0", 128, 128, 64,
     torch.bfloat16, True, None, 32),
]


def wkv6_work(bh: int, t: int, kk: int, vv: int, chunk: int) -> tuple:
    """(f32 operations, exp evaluations) of the chunked algorithm over the
    chunks this T runs (the last one padded): per chunk (C rows, P = C(C-1)/2
    pairs) r~ S and the state update 2CKV each, A 3PK (a product, a scale
    and a sum per pair and channel), A v 2PV, the bonus 2CK + 2CV, the
    scalings of r and k 2CK and of S KV; exps PK for A, 2CK for r~ and k~,
    K for the decay."""
    c = min(chunk, t)
    nc = -(-t // c)
    p = c * (c - 1) // 2
    flops = 4 * c * kk * vv + 3 * p * kk + 2 * p * vv + 4 * c * kk + 2 * c * vv + kk * vv
    exps = p * kk + 2 * c * kk + kk
    return bh * nc * flops, bh * nc * exps


def wkv6_inputs(bh, t, kk, dtype, with_s0, decay, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    r, k, v = (rnd(bh, t, kk).to(dtype) for _ in range(3))
    lo, hi = decay if decay is not None else (None, None)
    if decay is None:  # strong decay: the log-decay itself near the -20 clamp
        w = -15.0 - 5.0 * torch.rand(bh, t, kk, generator=g, device="cuda")
    else:  # -exp(U(lo, hi)), the model's form w = -exp(w0 + lora)
        w = -torch.exp(lo + (hi - lo) * torch.rand(bh, t, kk, generator=g, device="cuda"))
    u = rnd(bh, kk, std=0.1)
    s0 = rnd(bh, kk, kk) if with_s0 else None
    return r, k, v, w, u, s0


def state_kernel_case(phase: str, kernel: str, label: str, call, dtype, chunk: int,
                      nb: int, flops: int, replaced=None, **extra) -> dict:
    """One case of a chunked-recurrence kernel (`kernel`, an ops function
    returning (y, final f32 state)): run once with the counts reset (one
    launch), y against the plain version within the y dtype's TOL and the
    state within f32 TOL, then timed (cold L2, median) beside its bound (nb
    bytes, flops f32 operations), the plain version and, where given, the
    design the kernel replaced (`replaced`, same inputs: `replaced_ms`); a
    second launch must give the same bits.  No PyTorch call computes either
    recurrence (library: none)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    y, s_fin = call()
    launched = ops.launch_counts()[kernel]
    with ops.reference_mode():
        want_y, want_s = call()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_fin).all())
    ok = (finite and y.dtype == dtype and s_fin.shape == want_s.shape
          and torch.allclose(y.float(), want_y.float(), **TOL[dtype])
          and torch.allclose(s_fin, want_s, **TOL[torch.float32]))
    again_y, again_s = call()
    torch.cuda.synchronize()
    same = bool(torch.equal(y, again_y)) and bool(torch.equal(s_fin, again_s))
    del again_y, again_s
    fields = dict(case=label, dtype=str(dtype).split(".")[1], chunk=chunk,
                  max_abs_err_y=(y.float() - want_y.float()).abs().max().item(),
                  max_abs_y=want_y.float().abs().max().item(), tol_y=TOL[dtype],
                  max_abs_err_state=(s_fin - want_s).abs().max().item(),
                  max_abs_state=want_s.abs().max().item(), tol_state=TOL[torch.float32],
                  all_finite=finite, within_tol=ok, launches_added=launched,
                  bitwise_deterministic=same)
    if not ok or launched != 1 or not same:
        emit(phase, **fields)
        raise AssertionError(f"{phase} [{label}]: within_tol={ok}, finite={finite}, "
                             f"{launched} {kernel} launches (want 1), second launch same: "
                             f"{same}")
    del y, s_fin, want_y, want_s
    ms = time_auto(call)
    with ops.reference_mode():
        plain_ms = time_auto(call)
    replaced_ms = time_auto(replaced) if replaced is not None else None
    b_ms, by = bound(nb, flops, torch.float32)
    row = dict(fields, kernel_ms=ms, plain_ms=plain_ms, replaced_ms=replaced_ms,
               library_ms=None, bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
               bytes=nb, flops=flops, **extra)
    emit(phase, **row)
    return row


def phase_wkv6():
    """Each WKV6 case through state_kernel_case, with its exp count, the
    serial first design's time on the same inputs, its blocks (the states
    and outputs launches: a block a row and chunk), its device launches and
    a second bound that adds the design's own traffic
    (bound_with_workspace_ms): the second read of k, v and w_log, and the
    workspace's per-chunk states and decays, written once, then read and
    rewritten by the scan and read by the outputs launch."""
    from repro_torch.kernels import ops, rwkv6
    rows = {}
    for i, (label, bh, t, kk, dtype, with_s0, decay, chunk) in enumerate(WKV6_CASES):
        r, k, v, w, u, s0 = wkv6_inputs(bh, t, kk, dtype, with_s0, decay, 200 + i)
        nb = nbytes(r, k, v, w, u, s0) + r.numel() * r.element_size() + bh * kk * kk * 4
        flops, exps = wkv6_work(bh, t, kk, kk, chunk)
        ds_shape, _ = rwkv6.workspace_shapes(bh, t, kk, kk, chunk)
        # 4 passes over the states and decays: written, scanned (read and
        # rewritten), read by the outputs launch
        ws_bytes = 4 * 4 * bh * ds_shape[1] * kk * (kk + 1) + nbytes(k, v, w)
        rows[label] = state_kernel_case(
            "wkv6", "rwkv6", label, lambda: ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk),
            dtype, chunk, nb, flops,
            replaced=lambda: replaced_rwkv6(r, k, v, w, u, s0=s0, chunk=chunk),
            replaced_design="scripts/replaced/rwkv6_serial.cu", exp_evaluations=exps,
            sfu_exp_ms=exps / SFU_EXP_S * 1e3, blocks_per_launch=bh * ds_shape[1],
            device_launches_per_call=rwkv6.DEVICE_LAUNCHES, workspace_bytes=ws_bytes,
            bound_with_workspace_ms=bound(nb + ws_bytes, flops, torch.float32)[0])
        del r, k, v, w, u, s0
    return rows


def phase_rwkv_kernels():
    """bgemv and bgemm at the shapes rwkv6-1.6b adds (batch 4): the decay
    LoRA 2048 -> 64 -> 2048 and the channel mix 2048 <-> 7168, decode
    (B, 1, d) and prefill (B, 128, d), through core.blas.matmul: each call
    one launch of its kernel (a prefill one on the tensor-core route),
    against its plain version (a split-K plan also bitwise against a second
    launch), then timed beside its bound, its plain version, torch.matmul
    and, for a prefill, the CUDA-core kernel it replaced; a decode case
    prints its bgemv plan (tile, splits, rows)."""
    from repro_torch.core import blas
    from repro_torch.kernels import bgemv, ops
    g = torch.Generator(device="cuda").manual_seed(300)
    rows = {}
    for rows_t, kernel in ((1, "bgemv"), (128, "bgemm")):
        for d_in, d_out in ((2048, 64), (64, 2048), (2048, 7168), (7168, 2048)):
            x = torch.randn(4, rows_t, d_in, generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn(d_in, d_out, generator=g, device="cuda") * d_in ** -0.5).to(
                torch.bfloat16)
            label = f"{'decode' if rows_t == 1 else 'prefill'} (4,{rows_t},{d_in})@({d_in},{d_out})"
            ops.reset_launch_counts()
            got = blas.matmul(x, w)
            counts = ops.launch_counts()
            with ops.reference_mode():
                want = blas.matmul(x, w)
            torch.cuda.synchronize()
            rose = {k: n for k, n in counts.items() if n}
            want_rose = {kernel: 1, **({"bgemm_wgmma": 1} if kernel == "bgemm"
                                       else {"bgemv_broadcast_t": 1})}
            if rows_t > 1:
                plan = plan_of(4 * rows_t, d_in, d_out, torch.bfloat16)
            else:
                p = bgemv.plan(4, d_in, d_out, torch.bfloat16)
                plan = dict(tile=p.tile, splits=p.splits, rows=p.rows)
            same = (split_deterministic(lambda: blas.matmul(x, w), got)
                    if plan["splits"] > 1 else None)
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), **TOL[torch.bfloat16])
            fields = dict(kernel=kernel, case=label, dtype="bfloat16", plan=plan,
                          max_abs_err=err, tol=TOL[torch.bfloat16], within_tol=ok,
                          launches_added=rose, split_bitwise_deterministic=same)
            if not ok or rose != want_rose or same is False:
                emit("rwkv_kernels", **fields)
                raise AssertionError(f"rwkv_kernels [{label}]: within_tol={ok}, launches "
                                     f"{rose} (want {want_rose}), split deterministic {same}")
            ms = time_ms(lambda: blas.matmul(x, w))
            with ops.reference_mode():
                plain_ms = time_ms(lambda: blas.matmul(x, w))
            lib_ms = time_ms(lambda: torch.matmul(x, w))
            ffma_ms = time_ms(lambda: ffma_launch(x, w)) if rows_t > 1 else None
            nb = nbytes(x, w) + 4 * rows_t * d_out * 2
            b_ms, by = bound(nb, 2 * 4 * rows_t * d_in * d_out, torch.bfloat16)
            row = dict(fields, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_call="matmul", ffma_ms=ffma_ms, bound_ms=b_ms, bound_by=by,
                       share_of_bound=b_ms / ms, bytes=nb, flops=2 * 4 * rows_t * d_in * d_out)
            emit("rwkv_kernels", **row)
            rows[label] = row
    return rows


def check_rwkv_launches(counts: dict, what: str, cfg, prefills: int, steps: int):
    """rwkv: one rwkv6 launch a layer a prefill and none at decode; every
    projection (10 a layer) on bgemv at decode and on bgemm at prefill; no
    attention of any form."""
    n = cfg.n_layers
    want = {"rwkv6": n * prefills, "bgemv": 10 * n * steps, "bgemm": 10 * n * prefills,
            "attention": 0, "attention_paged": 0, "attention_int8": 0}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{what} launches {counts}: (got, want) {bad}")


def phase_smoke_batch(arch: str, phase: str, check):
    """A recurrent-state model's SMOKE (f32) under the batch scheduler
    through the kernels and again through the plain versions: equal greedy
    tokens, at batch 2 and at batch 1 (where a prefill's head split is a
    strided view); `check` holds the kernel run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config(arch, "smoke")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, size=(10,), dtype=np.int32) for _ in range(5)]
    params = tf.init_params(cfg, 0, "cuda")
    for batch in (2, 1):
        kw = dict(batch=batch, gen_lens=[3, 7, 4, 6, 5], eos=-1, prompts=prompts,
                  scheduler="batch", params=params, verbose=False, device="cuda")
        ops.reset_launch_counts()
        got = serve(arch, "smoke", **kw)
        counts = ops.launch_counts()
        with ops.reference_mode():
            want = serve(arch, "smoke", **kw)
        equal = got["outputs"] == want["outputs"]
        emit(phase, arch=arch, dtype="float32", scheduler="batch", batch=batch,
             requests=len(prompts), completed=got["completed"], tokens_equal=equal,
             outputs=got["outputs"], launches={k: n for k, n in counts.items() if n})
        if not equal or got["completed"] != len(prompts):
            raise AssertionError(f"{phase}, batch {batch}: kernels {got['outputs']} != "
                                 f"plain {want['outputs']}")
        # the serve's warm-up runs one prefill and one decode step first
        check(counts, f"{phase} batch {batch}", cfg, got["prefills"] + 1,
              got["decode_steps"] + 1)
        check_f32_routes(counts, f"{phase} batch {batch}")


def _instrumented_serve(arch: str, params, cfg, **kw) -> tuple:
    """serve(arch, "full") of 8 requests, batch 4, prompt 128, gen 32,
    greedy, with every logit checked finite on the device, CUDA events
    around every prefill and decode step, every plain version's calls
    counted (_count_plain_calls) and the launch counts and peak device
    memory reset first.  Returns (stats, the fields every full serve prints,
    launch counts, plain calls)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    finite = []
    events = {"prefill": [], "decode_step": []}
    originals = {name: getattr(tf, name) for name in ("_logits_chunk", *events)}

    def checked(*args, **kwargs):
        out = originals["_logits_chunk"](*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out

    def timed(name):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return out
        return call

    tf._logits_chunk = checked
    for name in events:
        setattr(tf, name, timed(name))
    plain, restore = _count_plain_calls()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        stats = serve(arch, "full", requests=8, batch=4, prompt_len=128, gen=32, seed=0,
                      eos=-1, params=params, device="cuda", **kw)
    finally:
        for name, fn in originals.items():
            setattr(tf, name, fn)
        restore()
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    ms = {name: [s.elapsed_time(e) for s, e in pairs[1:]]  # [0]: the warm-up
          for name, pairs in events.items()}
    fields = dict(
        arch=arch, variant="full", dtype="bfloat16", requests=8, batch=4, prompt_len=128,
        gen=32, **kw, completed=stats["completed"], tokens=stats["tokens"],
        tok_s=stats["tok_s"], elapsed_s=stats["elapsed_s"],
        ttft_p50_s=statistics.median(stats["ttft"]), prefills=stats["prefills"],
        decode_steps=stats["decode_steps"], occupancy=stats["occupancy"],
        prefill_ms=statistics.mean(ms["prefill"]),
        decode_ms_per_step=statistics.median(ms["decode_step"]),
        logit_checks=len(finite), all_logits_finite=bool(torch.stack(finite).all()),
        tokens_in_range=all(0 <= t < cfg.vocab for o in stats["outputs"] for t in o),
        plain_version_calls=sum(plain.values()),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    return stats, fields, counts, plain


def check_full_serve(what: str, stats: dict, fields: dict, plain: dict | None = None):
    """Fail unless the serve completed 8/8, every request its 32 tokens,
    every logit finite and every token in the vocabulary, and (`plain`
    given) no plain version ran."""
    if (stats["completed"] != 8 or not fields["all_logits_finite"]
            or not fields["tokens_in_range"]):
        raise AssertionError(f"{what}: completed {stats['completed']}/8, finite "
                             f"{fields['all_logits_finite']}, tokens in range "
                             f"{fields['tokens_in_range']}")
    if any(len(o) != 32 for o in stats["outputs"]):
        raise AssertionError(f"{what}: a request stopped before its budget")
    if plain is not None and sum(plain.values()):
        raise AssertionError(f"{what}: plain versions ran: "
                             f"{ {k: v for k, v in plain.items() if v} }")


def phase_serve_recurrent(arch: str, phase: str, params, cfg, check):
    """A recurrent-state model FULL bf16 under the batch scheduler: 8
    requests, batch 4, prompt 128, gen 32, every logit finite, launches
    held by `check`; reports tok/s, TTFT and the prefill's and decode
    step's stream time (CUDA events around each call, warm-up excluded);
    returns the launch counts."""
    stats, fields, counts, _ = _instrumented_serve(arch, params, cfg, scheduler="batch")
    emit(phase, **fields)
    emit("launches", run=phase, **counts)
    check_full_serve(phase, stats, fields)
    check(counts, phase, cfg, stats["prefills"] + 1, stats["decode_steps"] + 1)
    return counts


def _forced_state_run(params, cfg, tokens, steps, state_of):
    """Prefill (4, 128) then decode the given tokens on the recurrent cache;
    returns the logits of every step, a copy of `state_of(cache)` after the
    prefill, and device times (ms) of the prefill and each decode step."""
    from repro_torch.models import transformer as tf
    cache = tf.init_cache(cfg, 4, 160, device="cuda")
    logits, times, state = [], [], None
    feeds = [(tf.prefill, tokens)] + [(tf.decode_step, t) for t in steps]
    for fn, tok in feeds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, cache = fn(params, tok, cache, cfg)
        end.record()
        logits.append(out)
        times.append((start, end))
        if state is None:
            state = state_of(cache).clone()
    torch.cuda.synchronize()
    return logits, state, [s.elapsed_time(e) for s, e in times]


def _map_tensors(tree, fn):
    """fn over every tensor of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def _tensors(tree):
    """Every tensor of a params tree (dicts and lists), in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _teacher_forced_rwkv(params, cfg, feeds):
    """Layer by layer on the plain path's activations: at every step (the
    prefill, then each decode token) each block runs twice on the same
    input x and state, through the kernels and through the plain versions,
    and the plain output and state go on to the next block.  Returns the
    per-(step, layer) errors of the block output ("out") and of the new WKV
    state ("state"), each over max |plain|."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, rwkv
    from repro_torch.models import transformer as tf
    cache = tf.init_cache(cfg, 4, 160, device="cuda")
    states = [{grp: {k: v[i] for k, v in cache[grp].items()} for grp in ("tm", "cm")}
              for i in range(cfg.n_layers)]
    rel = {"out": [], "state": []}
    for tok in feeds:
        x = layers.embed(params["embed"], tok)
        for i, lp in enumerate(params["layers"]):
            got, got_st = rwkv.rwkv_block(lp, x, cfg, states[i])
            with ops.reference_mode():
                x, states[i] = rwkv.rwkv_block(lp, x, cfg, states[i])
            rel["out"].append(_rel(got, x))
            rel["state"].append(_rel(got_st["tm"]["s"], states[i]["tm"]["s"]))
    return rel


def phase_forced_recurrent(phase: str, arch: str, params, cfg, *, kernel: str, seed: int,
                           state_of, teacher_forced, limits: dict, margin: float, check):
    """A recurrent-state model FULL bf16: prefill + 3 decode steps on the
    same tokens.

    Gated: (1) every launch of `kernel` (an ops function returning (y,
    final state)) on the kernel path against the plain version on the same
    inputs, y within bf16 TOL and the state within f32 TOL; (2)
    teacher-forced (`teacher_forced`), every block at every step through
    the kernels against the plain versions on the same input and state,
    each error series within its `limits` share of max |plain|; (3) end to
    end, at every step, the kernel path's logits no further from the plain
    path in f32 on the same weights (upcast) than the plain bf16 path's
    logits are, plus `margin` of max |logit|; (4) every logit and state
    finite.  The kernel path is not held to the plain bf16 path's logits
    directly: a random-weight model amplifies a rounding difference from
    layer to layer, so two faithful bf16 paths can part by tens of percent
    of max |logit| (rwkv6-1.6b, PERF.md section 6); that distance is
    recorded."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda()
    steps = [torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1), dtype=np.int32)).cuda()
             for _ in range(3)]
    captured = []
    launch = getattr(ops, kernel)

    def capture(*args, **kwargs):
        # copies: an initial state may be a view of a cache that the
        # forward then overwrites with the new state in place
        args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        kwargs = {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()}
        out = launch(*args, **kwargs)
        captured.append((args, kwargs, out))
        return out

    setattr(ops, kernel, capture)
    try:
        ops.reset_launch_counts()
        got, got_state, t_kernel = _forced_state_run(params, cfg, tokens, steps, state_of)
        counts = ops.launch_counts()
    finally:
        setattr(ops, kernel, launch)
    with ops.reference_mode():
        want, want_state, t_plain = _forced_state_run(params, cfg, tokens, steps, state_of)
    layer_err_y, layer_err_s, layer_ok = [], [], []
    for args, kwargs, (y, s_fin) in captured:
        with ops.reference_mode():
            wy, ws = launch(*args, **kwargs)
        layer_err_y.append((y.float() - wy.float()).abs().max().item())
        layer_err_s.append((s_fin - ws).abs().max().item())
        layer_ok.append(torch.allclose(y.float(), wy.float(), **TOL[torch.bfloat16])
                        and torch.allclose(s_fin, ws, **TOL[torch.float32]))
    del captured
    dims = tuple(range(1, got_state.ndim))
    state_rel = ((got_state - want_state).abs().amax(dim=dims)
                 / want_state.abs().amax(dim=dims)).tolist()
    errs, scales, agree = [], [], []
    for gl, wl in zip(got, want):
        errs.append((gl - wl).abs().max().item())
        scales.append(wl.abs().max().item())
        agree.append((gl.argmax(-1) == wl.argmax(-1)).float().mean().item())
    tf_rel = teacher_forced(params, cfg, [tokens] + steps)
    params32 = _map_tensors(params, lambda t: t.float())
    with ops.reference_mode():
        want32, _, _ = _forced_state_run(params32, dataclasses.replace(cfg, dtype="float32"),
                                         tokens, steps, state_of)
    del params32

    def rel32(logits):
        return [_rel(x, w) for x, w in zip(logits, want32)]

    finite = all(bool(torch.isfinite(x).all()) for x in got) and bool(
        torch.isfinite(got_state).all())
    kernel32, plain32 = rel32(got), rel32(want)
    e2e_ok = all(k <= p + margin for k, p in zip(kernel32, plain32))
    tf_max = {k: max(v) for k, v in tf_rel.items()}
    tf_ok = all(tf_max[k] <= limits[k] for k in tf_rel)
    ok = finite and len(layer_ok) == cfg.n_layers and all(layer_ok) and e2e_ok and tf_ok
    emit(phase, arch=arch, variant="full", dtype="bfloat16", steps=["prefill", 1, 2, 3],
         max_abs_err=errs, max_abs_logit=scales,
         rel_err=[e / s for e, s in zip(errs, scales)], argmax_agreement=agree,
         kernel_rel_err_to_f32=kernel32, plain_rel_err_to_f32=plain32,
         e2e_margin=margin, e2e_within_margin=e2e_ok, state_rel_err_by_layer=state_rel,
         all_finite=finite, layer_launches_checked=len(layer_ok),
         layer_max_abs_err_y=max(layer_err_y), layer_max_abs_err_state=max(layer_err_s),
         layers_within_tol=sum(layer_ok), teacher_forced_limits=limits,
         teacher_forced_runs={k: len(v) for k, v in tf_rel.items()},
         teacher_forced_max_rel=tf_max, teacher_forced_rel_out_prefill=tf_rel["out"][
             :cfg.n_layers], within_tol=ok, prefill_ms=t_kernel[0],
         decode_ms_per_step=statistics.mean(t_kernel[1:]), plain_prefill_ms=t_plain[0],
         plain_decode_ms_per_step=statistics.mean(t_plain[1:]),
         launches={k: n for k, n in counts.items() if n})
    if not ok:
        raise AssertionError(f"{phase}: finite {finite}, {kernel} launches within tol "
                             f"{sum(layer_ok)}/{len(layer_ok)}, teacher-forced max rel "
                             f"{tf_max} (limits {limits}), to f32: kernel {kernel32} vs "
                             f"plain {plain32} + {margin}")
    check(counts, phase, cfg, 1, 3)


# --------------------------------------------------------------------------
# phases 24-27: zamba2-1.2b (hybrid Mamba2 + shared attention) and the SSD
# --------------------------------------------------------------------------

ZAMBA = "zamba2-1.2b"

SSD_CASES = [  # (label, BH, T, P, N, x/b/c dtype, from h0, strong decay, chunk)
    ("prefill B=4 NH=64 T=128 P=N=64 bf16 from zero", 256, 128, 64, 64, torch.bfloat16,
     False, False, 64),
    ("prefill B=4 NH=64 T=128 P=N=64 bf16 from h0", 256, 128, 64, 64, torch.bfloat16,
     True, False, 64),
    ("long B=1 NH=64 T=4096 P=N=64 bf16 from h0", 64, 4096, 64, 64, torch.bfloat16, True,
     False, 64),
    ("ragged B=4 NH=64 T=100 P=N=64 bf16 from h0", 256, 100, 64, 64, torch.bfloat16, True,
     False, 64),
    ("smoke f32 B=4 NH=8 T=10 P=N=16 chunk 8 from h0", 32, 10, 16, 16, torch.float32, True,
     False, 8),
    ("strong decay a_log in [-40, 0] B=4 NH=64 T=128 bf16 from h0", 256, 128, 64, 64,
     torch.bfloat16, True, True, 64),
]


def ssd_flops(bh: int, t: int, p: int, n: int, chunk: int) -> int:
    """The fewest f32 operations that compute the SSD on these inputs: the
    lesser of the chunked form's, counting only the causal lower triangle
    of c b^T and A x (C(C+1) N and C(C+1) P a chunk and head) beside c H and
    b^T x (2 C N P each), and the token recurrence's (H <- e^a H + b x^T,
    3 N P; y = c^T H, 2 N P; a token and head).  At the shapes here the
    recurrence's is the lesser, also when c b^T (bf16 operands, exact) is
    charged at the bf16 tensor-core rate.  Both count the T live rows only
    (a ragged last chunk as its own length)."""
    c = min(chunk, t)
    sizes = [c] * (t // c) + ([t % c] if t % c else [])
    chunked = bh * sum(k * (k + 1) * (n + p) + 4 * k * n * p for k in sizes)
    return min(chunked, bh * t * 5 * n * p)


def ssd_inputs(bh, t, p, n, dtype, with_h0, strong, seed):
    """x of unit scale, b and c of scale 0.5; the log-decay -exp(N(0, 1)) *
    0.3 (slow, so the carried state matters), or U(-40, 0) a step when
    `strong` (L falls past -10^3 within a 64-row chunk); h0 f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    x = rnd(bh, t, p).to(dtype)
    b, c = (rnd(bh, t, n, std=0.5).to(dtype) for _ in range(2))
    if strong:
        a = -40.0 * torch.rand(bh, t, generator=g, device="cuda")
    else:
        a = -torch.exp(rnd(bh, t)) * 0.3
    h0 = rnd(bh, n, p) if with_h0 else None
    return x, a, b, c, h0


def device_ms_by_kernel(call, reps: int = 10) -> dict:
    """torch.profiler's device ms a call by kernel name, over `reps` calls
    (warm L2: the breakdown's shares, beside time_ms's cold-L2 total)."""
    call()
    torch.cuda.synchronize()
    return {re.sub(r"\(.*", "", key.replace("(anonymous namespace)::", ""))[-40:]: ms
            for key, (ms, _) in profile_by_name(call, reps, cpu=False).items()}


def phase_ssd():
    """Each SSD case through state_kernel_case, with the serial first
    design's time on the same inputs (replaced_ms), its blocks (the states
    and outputs launches: a block a row and chunk), its device launches, the
    profiler's device ms by kernel, and a second bound that adds the
    design's own traffic (bound_with_workspace_ms): the second read of x, b
    and a_log, and the workspace's per-chunk states and decays, written
    once, then read and rewritten by the scan and read by the outputs
    launch."""
    from repro_torch.kernels import mamba2, ops
    rows = {}
    for i, (label, bh, t, p, n, dtype, with_h0, strong, chunk) in enumerate(SSD_CASES):
        x, a, b, c, h0 = ssd_inputs(bh, t, p, n, dtype, with_h0, strong, 400 + i)
        nb = nbytes(x, a, b, c, h0) + x.numel() * x.element_size() + bh * n * p * 4
        dh_shape, _ = mamba2.workspace_shapes(bh, t, n, p, chunk)
        ws_bytes = 4 * 4 * bh * dh_shape[1] * (n * p + 1) + nbytes(x, b, a)
        rows[label] = state_kernel_case(
            "ssd", "mamba2_ssd", label,
            lambda: ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk), dtype, chunk, nb,
            ssd_flops(bh, t, p, n, chunk),
            replaced=lambda: replaced_mamba2(x, a, b, c, h0=h0, chunk=chunk),
            replaced_design="scripts/replaced/mamba2_serial.cu",
            blocks_per_launch=bh * dh_shape[1], device_launches_per_call=mamba2.DEVICE_LAUNCHES,
            device_ms_by_kernel=device_ms_by_kernel(
                lambda: ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)),
            workspace_bytes=ws_bytes,
            bound_with_workspace_ms=bound(nb + ws_bytes, ssd_flops(bh, t, p, n, chunk),
                                          torch.float32)[0])
        del x, a, b, c, h0
    return rows


def check_zamba_launches(counts: dict, what: str, cfg, prefills: int, steps: int):
    """zamba2: one mamba2_ssd launch a Mamba2 block a prefill and none at
    decode; every projection (2 a block, 6 a shared-block occurrence) on
    bgemm at prefill and on bgemv at decode; the 3 LoRA merges of each
    occurrence on gemm (f32, the "ffma_sm90" route) and one attention launch
    an occurrence, every forward; no paged, int8 or WKV6 launch."""
    n = cfg.n_layers
    occ = n // cfg.ssm.shared_attn_every
    proj = 2 * n + 6 * occ
    want = {"mamba2_ssd": n * prefills, "bgemm": proj * prefills, "bgemv": proj * steps,
            "gemm": 3 * occ * (prefills + steps), "gemm_ffma_sm90": 3 * occ * (prefills + steps),
            "attention": occ * (prefills + steps),
            "attention_paged": 0, "attention_int8": 0, "rwkv6": 0}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{what} launches {counts}: (got, want) {bad}")


def _teacher_forced_zamba(params, cfg, feeds):
    """Block by block on the plain path's activations: at every step (the
    prefill, then each decode token) each Mamba2 block and each shared-block
    occurrence runs twice on the same input and state (or cache), through
    the kernels and through the plain versions, and the plain output and
    state go on.  Returns the per-(step, block) errors of the Mamba2 block
    output ("out"), of its new SSD state ("state") and of the shared
    block's output ("shared"), each over max |plain|."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, mamba
    from repro_torch.models import transformer as tf
    cache = tf.init_cache(cfg, 4, 160, device="cuda")
    n = cfg.n_layers
    every = cfg.ssm.shared_attn_every
    states = [{k: cache["mamba"][k][i] for k in ("conv", "h")} for i in range(n)]
    rel = {"out": [], "state": [], "shared": []}
    pos = 0
    for tok in feeds:
        t = tok.shape[1]
        positions = torch.arange(t, device="cuda") + pos
        x = layers.embed(params["embed"], tok)
        occ = 0
        for i, lp in enumerate(params["layers"]):
            got, got_st = mamba.mamba_block(lp, x, cfg, states[i])
            with ops.reference_mode():
                x, states[i] = mamba.mamba_block(lp, x, cfg, states[i])
            rel["out"].append(_rel(got, x))
            rel["state"].append(_rel(got_st["h"], states[i]["h"]))
            if (i + 1) % every == 0 and occ < n // every:
                ac = {"k": cache["attn"]["k"][occ], "v": cache["attn"]["v"][occ], "pos": pos}
                got, _ = tf._shared_attn_block(params, x, cfg, positions, occ, ac)
                with ops.reference_mode():  # rewrites this step's K/V with the plain path's
                    x, _ = tf._shared_attn_block(params, x, cfg, positions, occ, ac)
                rel["shared"].append(_rel(got, x))
                occ += 1
        pos += t
    return rel


def phase_serve_batch(params, cfg, continuous_outputs):
    """The dense batch scheduler: SMOKE f32 serves (dense, int8 KV, paged
    page 4, and a 7-page pool that preempts) through the kernels and the
    plain versions give equal tokens, the small pool the default pool's;
    then stablelm-1.6b FULL bf16 under --scheduler batch, 8/8 complete, and
    its tokens' agreement with the continuous serve of phase 5."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    smoke = get_config(ARCH, "smoke")
    smoke_params = tf.init_params(smoke, 0, "cuda")
    rng = np.random.default_rng(0)
    base = dict(batch=3, prompts=[rng.integers(3, 256, size=(10,), dtype=np.int32)
                                  for _ in range(6)],
                gen_lens=rng.integers(4, 9, size=6).tolist())
    runs = [("dense", {}), ("int8 KV", dict(kv_cache="int8")),
            ("paged P=4", dict(kv_page_size=4)),
            ("paged P=4 pool_pages=7", dict(kv_page_size=4, pool_pages=7))]
    out = {}
    for name, kw in runs:
        args = dict(base, **kw, eos=-1, scheduler="batch", params=smoke_params,
                    verbose=False, device="cuda")
        ops.reset_launch_counts()
        got = serve(ARCH, "smoke", **args)
        counts = ops.launch_counts()
        with ops.reference_mode():
            want = serve(ARCH, "smoke", **args)
        check_kv_launches(counts, f"serve_batch {name}", smoke.n_layers, got["prefills"] + 1,
                          got["decode_steps"] + 1, kw.get("kv_cache") == "int8",
                          "kv_page_size" in kw, paged_prefill=True)
        check_f32_routes(counts, f"serve_batch {name}")
        equal = got["outputs"] == want["outputs"]
        emit("serve_batch", run=name, arch=ARCH, variant="smoke", dtype="float32",
             tokens_equal_plain=equal, completed=got["completed"], status=got["status"],
             prefills=got["prefills"], decode_steps=got["decode_steps"],
             preemptions=got["preemptions"], pages_live=got.get("pages_live"))
        if not equal:
            raise AssertionError(f"serve_batch {name}: kernels {got['outputs']} != plain "
                                 f"{want['outputs']}")
        out[name] = got
    if out["paged P=4 pool_pages=7"]["outputs"] != out["paged P=4"]["outputs"]:
        raise AssertionError("serve_batch: the 7-page pool's tokens differ from the default pool's")
    if out["paged P=4 pool_pages=7"]["preemptions"] < 1:
        raise AssertionError("serve_batch: the 7-page pool never preempted")
    if out["paged P=4"]["outputs"] != out["dense"]["outputs"]:
        raise AssertionError("serve_batch: paged tokens differ from dense tokens")
    ops.reset_launch_counts()
    stats = serve(ARCH, "full", requests=8, batch=4, prompt_len=128, gen=32, seed=0, eos=-1,
                  scheduler="batch", params=params, device="cuda")
    counts = ops.launch_counts()
    check_attention_routes("serve_batch", cfg.n_layers)
    same = [a == b for o, p in zip(stats["outputs"], continuous_outputs) for a, b in zip(o, p)]
    emit("serve_batch", run="full", arch=ARCH, variant="full", dtype="bfloat16",
         scheduler="batch", requests=8, batch=4, prompt_len=128, gen=32,
         completed=stats["completed"], tokens=stats["tokens"], tok_s=stats["tok_s"],
         elapsed_s=stats["elapsed_s"], ttft_p50_s=statistics.median(stats["ttft"]),
         prefills=stats["prefills"], decode_steps=stats["decode_steps"],
         occupancy=stats["occupancy"],
         token_agreement_with_continuous=sum(same) / len(same),
         requests_equal_continuous=sum(o == p for o, p in zip(stats["outputs"],
                                                               continuous_outputs)))
    emit("launches", run="serve_batch", **counts)
    if stats["completed"] != 8 or any(len(o) != 32 for o in stats["outputs"]):
        raise AssertionError(f"serve_batch full: completed {stats['completed']}/8")
    check_launches(counts, "serve_batch")


# --------------------------------------------------------------------------
# phases 28-33: the MoE family (moonshot-v1-16b-a3b, grok-1-314b) and
# bgemm's batched launch
# --------------------------------------------------------------------------

MOE = "moonshot-v1-16b-a3b"
GROK = "grok-1-314b"
# moonshot FULL bf16 (forced_moe), stated before its first run: on identical
# inputs, a block's `_expert_ffn` (the dispatch buffer of the plain path)
# and its whole `moe_layer` (the plain path's normed h: the same routing)
# within 2% of max |plain|, as the rwkv and zamba2 blocks; end to end the
# logits within FORCED_REL_TOL of the plain path's, or, where top-6 routing
# flips carry the two bf16 paths apart, no further from the f32 path than
# the plain bf16 path's logits are, plus 2% of max |logit|.
MOE_TF_OUT_TOL = 0.02
MOE_E2E_MARGIN = 0.02
# moe_kernels' operation-bound BLAS cases (batch, m, k, n): aligned (f64,
# f32) and, in bf16, odd M and K (A staged)
BLAS_BATCHED = (16, 2048, 2048, 2048)
BLAS_BATCHED_ODD = (16, 2047, 2047, 2048)


def moe_cases():
    """The batched launch at moonshot FULL's expert shapes (64 experts, d =
    2048, f = 1408): the gate+up dual launch (silu, bf16 out) and the down
    launch (f32 out) at decode (32 rows an expert: batch 4 x capacity 8)
    and prefill (64: 4 x 16), dense and packed (`--quantize int8`'s "kn"
    expert stacks, per-expert scales: one a 64-row k-step across N, and
    one case whose scales vary along N too), on the tensor cores; f32 (the
    TMA ring), f64 (DMMA), odd-K bf16 (A staged) and odd-K f32 (the ring,
    A staged) at the decode down shape; packed stacks under
    f32 A (the ring, dequantized in its staging) and f64 A (DMMA, bitwise
    the dense launch on the dequantized stacks), and output-major ("nk")
    packed stacks under bf16 A (the CUDA-core tile: no Hopper kernel takes
    them); and one
    operation-bound BLAS case a dtype through `blas.batched_gemm`: (16,
    2048, 2048, 2048) in f64 and f32, (16, 2047, 2047, 2048) in bf16.
    Dicts: label, call, lib (torch.bmm on the same operands, products
    only, or None), ffma (the same launch on the CUDA-core tile of
    csrc/gemm_batched*.cu, the first design), bytes, flops, dtype,
    out_dtype, packed, gate, shape, plan_kw (`gemm.plan_batched`'s packed
    layout and block), dense (the label of the dense case at that shape, or
    None), deq (under f64 A the same launch on the dequantized stacks, or
    None)."""
    from repro_torch.core import blas, quant
    from repro_torch.kernels import gemm, ops
    g = torch.Generator(device="cuda").manual_seed(21)
    e, d, f = 64, 2048, 1408

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    wg, wu = rnd(e, d, f, std=d ** -0.5), rnd(e, d, f, std=d ** -0.5)
    wgu = torch.cat([wg, wu], dim=2)
    wd = rnd(e, f, d, std=f ** -0.5)
    spec = quant.QuantSpec(block_m=64, block_n=None)  # quantize_weights' expert rule
    qg, qu, qd = (quant.quantize(w, spec) for w in (wg, wu, wd))
    cases = []

    def case(label, a, b, lib, *, b2=None, activation=None, out_dtype, dense=None, call=None):
        packed = quant.is_quantized(b)
        deq = None
        if packed and a.dtype == torch.float64:
            def deq():
                d2 = None if b2 is None else quant.dequantize_in(b2, a.dtype).contiguous()
                return ops.bgemm(a, quant.dequantize_in(b, a.dtype).contiguous(), b2=d2,
                                 activation=activation, out_dtype=out_dtype)
        batch, m, k = a.shape
        n = b.shape[-1]
        out_b = batch * m * n * torch.empty((), dtype=out_dtype).element_size()
        w_b = (nbytes(b.values, b.scales, *(() if b2 is None else (b2.values, b2.scales)))
               if packed else nbytes(b, b2))
        first = torch.empty(batch, m, n, dtype=out_dtype, device="cuda")
        cases.append(dict(
            label=label, call=call or (lambda: ops.bgemm(a, b, b2=b2, activation=activation,
                                                         out_dtype=out_dtype)),
            lib=lib, ffma=lambda: gemm.batched_ffma(
                a, b, first, b2=b2, bias=None, residual=None, act_code=ops._ACTS[activation],
                dtype_code=ops._DTYPE_CODES[a.dtype], out_code=ops._DTYPE_CODES[out_dtype]),
            bytes=nbytes(a) + w_b + out_b,
            flops=2 * batch * m * k * n * (2 if b2 is not None else 1), dtype=a.dtype,
            out_dtype=out_dtype, packed=packed, gate=b2 is not None, shape=(batch, m, k, n),
            plan_kw=dict(packed_layout=gemm.packed_layout(b), block=b.block) if packed else {},
            dense=dense, deq=deq))

    for m, what in ((32, "decode"), (64, "prefill")):
        h, mid = rnd(e, m, d), rnd(e, m, f)
        gate_up = f"{what} gate_up ({e},{m},{d})@({e},{d},{f}) x2 silu bf16 out"
        down = f"{what} down ({e},{m},{f})@({e},{f},{d}) f32 out"
        case(gate_up, h, wg, lambda h=h: torch.bmm(h, wgu), b2=wu, activation="silu",
             out_dtype=torch.bfloat16)
        case(down, mid, wd, lambda mid=mid: torch.bmm(mid, wd), out_dtype=torch.float32)
        case(f"int8 {gate_up}", h, qg, None, b2=qu, activation="silu",
             out_dtype=torch.bfloat16, dense=gate_up)
        case(f"int8 {down}", mid, qd, None, out_dtype=torch.float32, dense=down)
        if m == 32:
            qd_n = quant.quantize(wd, quant.QuantSpec(block_m=64, block_n=128))
            case(f"int8 block_n=128 {down}", mid, qd_n, None, out_dtype=torch.float32,
                 dense=down)
            mid32, wd32 = mid.float(), wd.float()
            case(f"f32 {down}", mid32, wd32, lambda: torch.bmm(mid32, wd32),
                 out_dtype=torch.float32, dense=down)
            case(f"int8 f32 {down}", mid32, qd, None, out_dtype=torch.float32,
                 dense=f"f32 {down}")
            mid64, wd64 = mid.double(), wd.double()
            down64 = f"f64 {down.replace('f32 out', 'f64 out')}"
            case(down64, mid64, wd64, lambda: torch.bmm(mid64, wd64), out_dtype=torch.float64,
                 dense=down)
            case(f"int8 {down64}", mid64, qd, None, out_dtype=torch.float64, dense=down64)
            qd_nk = quant.quantize(wd, quant.QuantSpec(block_m=64, block_n=None, transpose=True))
            case(f"int8 nk {down}", mid, qd_nk, None, out_dtype=torch.float32, dense=down)
            odd, wodd = mid[..., :f - 1].contiguous(), wd[:, :f - 1].contiguous()
            odd_down = f"odd K {what} down ({e},{m},{f - 1})@({e},{f - 1},{d}) f32 out"
            case(odd_down, odd, wodd, lambda: torch.bmm(odd, wodd), out_dtype=torch.float32,
                 dense=down)
            odd32, wodd32 = odd.float(), wodd.float()
            case(f"f32 {odd_down}", odd32, wodd32, lambda: torch.bmm(odd32, wodd32),
                 out_dtype=torch.float32, dense=f"f32 {down}")
    for dtype, (bb, bm, bk, bn) in ((torch.float64, BLAS_BATCHED), (torch.float32, BLAS_BATCHED),
                                    (torch.bfloat16, BLAS_BATCHED_ODD)):
        x, w = rnd(bb, bm, bk, dtype=dtype), rnd(bb, bk, bn, std=bk ** -0.5, dtype=dtype)
        case(f"blas batched_gemm ({bb},{bm},{bk})@({bb},{bk},{bn}) {str(dtype)[6:]}", x, w,
             lambda x=x, w=w: torch.bmm(x, w), out_dtype=dtype,
             call=lambda x=x, w=w: blas.batched_gemm(x, w))
    return cases


def phase_moe_kernels():
    """Each batched case: one launch, counted on the route
    `gemm.plan_batched` names (and as packed, and as staged, where it is);
    within TOL of its plain version (f32 out: the f32 tolerance, the sums
    differing in order only), bitwise a second launch; timed beside its
    bound, the plain version, torch.bmm on the same operands (products
    only) and, off the "ffma" route, the same launch on the CUDA-core tile
    (`first_tile_ms`, the design these forms left); under f64 A a packed
    launch is held bitwise against the dense launch on the dequantized
    stacks.  Returns (rows by label, the launches of the checked calls by
    key, with `bgemm_batched_{route}_int8` the packed ones among a route's)."""
    from repro_torch.kernels import gemm, ops
    rows, launched = {}, {}
    for c in moe_cases():
        batch, m, k, n = c["shape"]
        p = gemm.plan_batched(batch, m, k, n, c["dtype"], c["out_dtype"], gate=c["gate"],
                              **c["plan_kw"])
        before = ops.launch_counts()
        got = c["call"]()
        after = ops.launch_counts()
        rose = {key: after[key] - before[key] for key in after if after[key] != before[key]}
        want_rose = {"bgemm_batched": 1, f"bgemm_batched_{p.route}": 1,
                     **({"bgemm_batched_int8": 1} if c["packed"] else {}),
                     **({"bgemm_batched_staged": 1} if p.stage else {})}
        if rose != want_rose:
            raise AssertionError(f"moe_kernels [{c['label']}]: launches added {rose}, "
                                 f"plan {p}")
        for key, v in rose.items():
            launched[key] = launched.get(key, 0) + v
        if c["packed"]:
            key = f"bgemm_batched_{p.route}_int8"
            launched[key] = launched.get(key, 0) + rose[f"bgemm_batched_{p.route}"]
        with ops.reference_mode():
            want = c["call"]()
        dense_bits = bool(torch.equal(got, c["deq"]())) if c["deq"] is not None else None
        torch.cuda.synchronize()
        tol = TOL[c["out_dtype"] if c["out_dtype"] in TOL else c["dtype"]]
        err = (got.double() - want.double()).abs().max().item()
        ok = (got.dtype == c["out_dtype"] and bool(torch.isfinite(got).all())
              and torch.allclose(got.double(), want.double(), **tol))
        same = split_deterministic(c["call"], got)
        ms = time_auto(c["call"])
        with ops.reference_mode():
            plain_ms = time_auto(c["call"])
        lib_ms = time_auto(c["lib"]) if c["lib"] is not None else None
        first_ms = time_auto(c["ffma"]) if p.route != "ffma" else None
        b_ms, by = bound(c["bytes"], c["flops"], c["dtype"])
        row = dict(case=c["label"], dtype=str(c["dtype"]).split(".")[1],
                   out_dtype=str(c["out_dtype"]).split(".")[1], packed=c["packed"],
                   plan=dict(route=p.route, tile=list(p.tile), stage=p.stage, copy=p.copy),
                   max_abs_err=err, tol=tol,
                   within_tol=ok, bitwise_second_launch=same, kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_call="torch.bmm (products only)" if lib_ms
                   else None, first_tile_ms=first_ms, bound_ms=b_ms, bound_by=by,
                   share_of_bound=b_ms / ms,
                   dense_ms=rows[c["dense"]]["kernel_ms"] if c["dense"] else None,
                   bitwise_dense_on_dequantized=dense_bits, bytes=c["bytes"], flops=c["flops"])
        emit("moe_kernels", **row)
        if not ok or not same or dense_bits is False:
            raise AssertionError(f"moe_kernels [{c['label']}]: max |kernel - plain| {err} "
                                 f"(tol {tol}), second launch bitwise {same}, bitwise the "
                                 f"dense launch on the dequantized stacks {dense_bits}")
        rows[c["label"]] = row
    emit("launches", run="moe_kernels", **launched)
    torch.cuda.empty_cache()
    return rows, launched


def check_moe_launches(counts: dict, what: str, cfg, prefills: int, steps: int,
                       route: str, int8: bool = False):
    """A MoE serve's launches: two batched expert launches a layer every
    forward, all on `route` (packed with int8 weights); the projections of
    attention (q, k, v, wo) and of the shared experts (gate+up, down) on
    bgemv at decode and bgemm at prefill (their packed kernels with int8
    weights); one attention launch a layer every forward."""
    n = cfg.n_layers
    proj = 4 + (2 if cfg.moe.n_shared_experts else 0)
    forwards = prefills + steps
    want = {"bgemm_batched": 2 * n * forwards, f"bgemm_batched_{route}": 2 * n * forwards,
            "bgemm_batched_int8": 2 * n * forwards if int8 else 0,
            "bgemv_int8" if int8 else "bgemv": proj * n * steps,
            "gemm_int8" if int8 else "bgemm": proj * n * prefills,
            "bgemv" if int8 else "bgemv_int8": 0, "bgemm" if int8 else "gemm_int8": 0,
            "attention": n * forwards}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{what} launches {counts}: (got, want) {bad}")


def phase_smoke_moe():
    """moonshot and grok SMOKE (f32) served through the kernels and through
    the plain versions: equal greedy tokens under the continuous scheduler
    (ragged prompts), the batch scheduler and --quantize int8; every expert
    launch batched, on the route `gemm.plan_batched` names for the smoke's
    f32 expert shapes (the TMA ring, "ffma_sm90"), packed under int8 too (f32
    A: the ring, the int8 dequantized in its staging); every f32 projection,
    dense or packed, on "ffma_sm90" (check_f32_routes).
    Returns the launch counts of the moonshot continuous and int8 serves."""
    from repro_torch.kernels import gemm, ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    out = {}
    for arch in (MOE, GROK):
        cfg = get_config(arch, "smoke")
        params = tf.init_params(cfg, 0, "cuda")
        d, f = cfg.d_model, cfg.moe.d_ff_expert
        f32 = torch.float32
        dense_routes = {gemm.plan_batched(cfg.moe.num_experts, 1, k, n, f32, f32, gate=gate).route
                        for k, n, gate in ((d, f, True), (f, d, False))}
        if len(dense_routes) != 1:
            raise AssertionError(f"smoke_moe {arch}: expert launches on {dense_routes}")
        rng = np.random.default_rng(1)
        ragged = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
        even = [rng.integers(3, cfg.vocab, size=(10,), dtype=np.int32) for _ in range(5)]
        for name, kw in (("continuous", dict(prompts=ragged)),
                         ("batch", dict(prompts=even, scheduler="batch")),
                         ("int8", dict(prompts=ragged, quantize="int8"))):
            args = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, params=params,
                        verbose=False, device="cuda", **kw)
            ops.reset_launch_counts()
            got = serve(arch, "smoke", **args)
            counts = ops.launch_counts()
            with ops.reference_mode():
                want = serve(arch, "smoke", **args)
            equal = got["outputs"] == want["outputs"]
            emit("smoke_moe", arch=arch, dtype="float32", run=name, requests=5,
                 completed=got["completed"], tokens_equal=equal, outputs=got["outputs"],
                 launches={k: v for k, v in counts.items() if v})
            if not equal or got["completed"] != 5:
                raise AssertionError(f"smoke_moe {arch} {name}: kernels {got['outputs']} != "
                                     f"plain {want['outputs']}")
            # the serve's warm-up runs one prefill and one decode step first
            check_moe_launches(counts, f"smoke_moe {arch} {name}", cfg, got["prefills"] + 1,
                               got["decode_steps"] + 1, next(iter(dense_routes)),
                               int8=name == "int8")
            check_f32_routes(counts, f"smoke_moe {arch} {name}")
            out[(arch, name)] = counts
        del params
    return out


def _count_plain_calls():
    """Wrap every plain version of the kernel modules (`reference*`) with a
    call counter; returns (counts dict, restore())."""
    import importlib
    calls, saved = {}, []
    for name in ("bgemm", "bgemv", "gemm", "gemv", "attention", "blas1"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for attr in [a for a in dir(mod) if a.startswith("reference")]:
            fn = getattr(mod, attr)
            key = f"{name}.{attr}"
            calls[key] = 0

            def counted(*args, _fn=fn, _key=key, **kwargs):
                calls[_key] += 1
                return _fn(*args, **kwargs)

            saved.append((mod, attr, fn))
            setattr(mod, attr, counted)

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

    return calls, restore


def phase_serve_moe(params, cfg):
    """moonshot FULL bf16 (seeded random weights, 57.8 GB): 8 requests,
    batch 4, prompt 128, gen 32, continuous scheduler; every logit finite,
    no plain version called, two batched expert launches a layer every
    forward, all on the tensor cores ("wgmma"), the prefill projections on
    wgmma, attention on its routes; peak device memory.  Returns (the
    launch counts, the fields printed)."""
    stats, fields, counts, plain = _instrumented_serve(MOE, params, cfg)
    check_attention_routes("serve_moe", cfg.n_layers)
    emit("serve_moe", **fields,
         params_b=sum(t.numel() for t in _tensors(params)) / 1e9,
         params_gb=sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    emit("launches", run="serve_moe", **counts)
    check_full_serve("serve_moe", stats, fields, plain)
    check_moe_launches(counts, "serve_moe", cfg, stats["prefills"] + 1,
                       stats["decode_steps"] + 1, "wgmma")
    check_prefill_routes(counts, "serve_moe")
    return counts, fields


def phase_serve_moe_int8(params, cfg, bf16_fields: dict) -> dict:
    """moonshot FULL with --quantize int8: the bf16 params packed in place
    one layer at a time (`layers.quantize_weights` on each
    params["layers"][i], that layer's bf16 leaves dropped before the next
    is packed, so the peak stays near the bf16 tree's 57.8 GB; packing the
    whole tree at once would hold it beside ~30 GB of int8), then 8
    requests, batch 4, prompt 128, gen 32, greedy, `quantize="int8"` (the
    packed leaves pass through serve()'s own packing).  Every logit finite,
    no plain version called, every expert launch packed on the tensor cores
    ("wgmma"), the projections on the packed kernels, attention on its
    routes; tok/s, TTFT and decode ms/step beside serve_moe's bf16 ones.
    Returns the launch counts."""
    from repro_torch.models import layers
    t0 = time.perf_counter()
    for i in range(len(params["layers"])):
        params["layers"][i] = layers.quantize_weights(params["layers"][i])
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    stats, fields, counts, plain = _instrumented_serve(MOE, params, cfg, quantize="int8")
    check_attention_routes("serve_moe_int8", cfg.n_layers)
    emit("serve_moe_int8", **fields, pack_seconds=pack_s,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         **{f"bf16_{k}": bf16_fields[k] for k in ("tok_s", "ttft_p50_s", "decode_ms_per_step",
                                                  "prefill_ms", "max_memory_allocated_gb")})
    emit("launches", run="serve_moe_int8", **counts)
    check_full_serve("serve_moe_int8", stats, fields, plain)
    check_moe_launches(counts, "serve_moe_int8", cfg, stats["prefills"] + 1,
                       stats["decode_steps"] + 1, "wgmma", int8=True)
    return counts


def logit_gate(got: list, want: list, want32: list, margin: float) -> dict:
    """The end-to-end gate of a forced run: every logit of the kernel path
    (`got`) finite, and at every step within FORCED_REL_TOL of max |logit|
    of the plain bf16 path (`want`), or no further from the f32 witness
    (`want32`) than the plain path plus `margin`.  Returns the fields to
    print, "e2e_ok" the verdict."""
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    rel = [e / s for e, s in zip(errs, scales)]
    kernel32 = [_rel(x, w) for x, w in zip(got, want32)]
    plain32 = [_rel(x, w) for x, w in zip(want, want32)]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    e2e_plain = all(r <= FORCED_REL_TOL for r in rel)
    e2e_witness = all(k <= p + margin for k, p in zip(kernel32, plain32))
    return dict(steps=["prefill", 1, 2, 3], max_abs_err=errs, max_abs_logit=scales,
                rel_err=rel, rel_tol=FORCED_REL_TOL, within_plain_tol=e2e_plain,
                argmax_agreement=[(g.argmax(-1) == w.argmax(-1)).float().mean().item()
                                  for g, w in zip(got, want)],
                kernel_rel_err_to_f32=kernel32, plain_rel_err_to_f32=plain32,
                e2e_margin=margin, e2e_within_witness_margin=e2e_witness, all_finite=finite,
                e2e_ok=finite and (e2e_plain or e2e_witness))


class _LazyF32Layers(list):
    """A params["layers"] list that hands the forward each layer upcast to
    f32 as it reaches it: the f32 witness of a model whose f32 weights do
    not fit the card at once."""

    def __iter__(self):
        for lp in list.__iter__(self):
            yield _map_tensors(lp, lambda t: t.float())


def phase_forced_moe(params, cfg):
    """moonshot FULL bf16: prefill (4, 128) + 3 decode steps on the same
    tokens, kernels and plain versions.  Gated: (1) every batched expert
    launch of the kernel path against its plain version on the same inputs
    (bf16 out: bf16 TOL; f32 out: f32 TOL); (2) every block on the plain
    path's inputs: `_expert_ffn` on the plain path's dispatch buffer and
    `moe_layer` on its normed h (the same routing), kernels against plain,
    within MOE_TF_OUT_TOL of max |plain|; (3) end to end, the logits within
    FORCED_REL_TOL of max |plain logit|, or else at every step no further
    from the f32 witness (the plain versions on each layer upcast as the
    forward reaches it) than the plain bf16 path's logits are, plus
    MOE_E2E_MARGIN; (4) every logit finite.  Reports the share of (token,
    layer) top-6 sets that agree between the two paths.  The kernel path's
    times include its launches' checks (`profile_moe` times it clean)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 128), dtype=np.int32)).cuda()
    steps = [torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1), dtype=np.int32)).cuda()
             for _ in range(3)]
    launch_err, launch_ok = [], []
    bgemm, route, layer_fn, ffn_fn = ops.bgemm, moe._route, moe.moe_layer, moe._expert_ffn
    picks = {"kernel": [], "plain": []}

    def checked(a, b, **kw):
        out = bgemm(a, b, **kw)
        if b.ndim == 3:  # an expert launch
            with ops.reference_mode():
                want = bgemm(a, b, **kw)
            tol = TOL[out.dtype]
            launch_err.append((out.float() - want.float()).abs().max().item())
            launch_ok.append(torch.allclose(out.float(), want.float(), **tol))
        return out

    def routed(path):
        def call(*args, **kwargs):
            top_w, top_i, aux = route(*args, **kwargs)
            picks[path].append(torch.sort(top_i, dim=-1).values)
            return top_w, top_i, aux
        return call

    ops.bgemm, moe._route = checked, routed("kernel")
    try:
        ops.reset_launch_counts()
        got, t_kernel = _forced_run(params, cfg, tokens, steps)
        counts = ops.launch_counts()
    finally:
        ops.bgemm, moe._route = bgemm, route
    blocks, ffns = [], []

    def layer_capture(lp, h, *args, **kwargs):
        out = layer_fn(lp, h, *args, **kwargs)
        blocks.append((lp, h, args, out[0]))
        return out

    def ffn_capture(h, lp, act):
        out = ffn_fn(h, lp, act)
        ffns.append((h, lp, act, out))
        return out

    moe._route, moe.moe_layer, moe._expert_ffn = routed("plain"), layer_capture, ffn_capture
    try:
        with ops.reference_mode():
            want, t_plain = _forced_run(params, cfg, tokens, steps)
    finally:
        moe._route, moe.moe_layer, moe._expert_ffn = route, layer_fn, ffn_fn
    tf_rel = {"expert_ffn": [], "moe_layer": []}
    for h, lp, act, plain_out in ffns:
        tf_rel["expert_ffn"].append(_rel(moe._expert_ffn(h, lp, act), plain_out))
    for lp, h, args, plain_out in blocks:
        tf_rel["moe_layer"].append(_rel(moe.moe_layer(lp, h, *args)[0], plain_out))
    del ffns, blocks
    agree = [(k == p).all(dim=-1).float().mean().item()
             for k, p in zip(picks["kernel"], picks["plain"])]
    n = cfg.n_layers
    agree_by_step = [statistics.mean(agree[i * n:(i + 1) * n]) for i in range(len(agree) // n)]
    torch.cuda.empty_cache()
    params32 = {k: (_LazyF32Layers(v) if k == "layers" else _map_tensors(v, lambda t: t.float()))
                for k, v in params.items()}
    with ops.reference_mode():
        want32, _ = _forced_run(params32, dataclasses.replace(cfg, dtype="float32"), tokens,
                                steps)
    del params32
    gate = logit_gate(got, want, want32, MOE_E2E_MARGIN)
    del want32
    torch.cuda.empty_cache()
    tf_max = {k: max(v) for k, v in tf_rel.items()}
    launches_ok = len(launch_ok) == 2 * n * 4 and all(launch_ok)
    ok = (gate["e2e_ok"] and launches_ok
          and all(v <= MOE_TF_OUT_TOL for v in tf_max.values()))
    emit("forced_moe", arch=MOE, variant="full", dtype="bfloat16", **gate,
         expert_launches_checked=len(launch_ok), expert_launches_within_tol=sum(launch_ok),
         expert_launch_max_abs_err=max(launch_err), teacher_forced_limit=MOE_TF_OUT_TOL,
         teacher_forced_runs={k: len(v) for k, v in tf_rel.items()},
         teacher_forced_max_rel=tf_max,
         teacher_forced_rel_moe_layer_prefill=tf_rel["moe_layer"][:n],
         top6_sets_agreeing_by_step=agree_by_step,
         top6_sets_agreeing_prefill_by_layer=agree[:n],
         top6_sets_agreeing=statistics.mean(agree), within_tol=ok,
         checked_prefill_ms=t_kernel[0],
         checked_decode_ms_per_step=statistics.mean(t_kernel[1:]),
         plain_prefill_ms=t_plain[0], plain_decode_ms_per_step=statistics.mean(t_plain[1:]),
         launches={k: v for k, v in counts.items() if v})
    if not ok:
        raise AssertionError(
            f"forced_moe: finite {gate['all_finite']}, expert launches within tol "
            f"{sum(launch_ok)}/{len(launch_ok)}, blocks {tf_max} (limit {MOE_TF_OUT_TOL}), "
            f"logits rel {gate['rel_err']} (tol {FORCED_REL_TOL}), to f32: kernel "
            f"{gate['kernel_rel_err_to_f32']} vs plain {gate['plain_rel_err_to_f32']}")
    check_moe_launches(counts, "forced_moe", cfg, 1, 3, "wgmma")


# --------------------------------------------------------------------------
# phases 33-38: flash attention's masks and head dim 256; the vlm and audio
# families (paligemma-3b, whisper-large-v3)
# --------------------------------------------------------------------------

VLM, AUDIO = "paligemma-3b", "whisper-large-v3"
# forced_vlm / forced_audio, stated before their first run as forced_zamba's
# and forced_moe's: every block (paligemma's dense block, whisper's encoder
# and decoder blocks) on the plain path's inputs within 2% of max |plain|;
# the logits within FORCED_REL_TOL of max |plain logit|, or at every step no
# further from the f32 witness than the plain bf16 path's plus 2% of max
# |logit|.
FAMILY_TF_OUT_TOL = 0.02
FAMILY_E2E_MARGIN = 0.02
# (label, kv_case keywords, prefix_len of the prefix-LM case): a prefill and
# a decode shape a head dim, the serving shapes where a model has them
# (whisper's encoder over 1500 frames and its cross-attention decode over
# them; paligemma's 256-patch + 128-token prefill and its decode at S = 416)
MASK_SHAPES = [
    ("whisper encoder B=4 H=20 T=1500 D=64",
     dict(tq=1500, h=20, kvh=20, d=64, lens=(1500,) * 4), 256),
    ("whisper cross decode B=4 H=20 Tq=1 S=1500 D=64",
     dict(tq=1, h=20, kvh=20, d=64, lens=(1500,) * 4), 256),
    ("D=128 prefill B=4 H=32/KVH=8 Tq=128 S=512",
     dict(tq=128, h=32, kvh=8, d=128, lens=(512,) * 4), 448),
    ("D=128 decode B=4 H=32/KVH=8 S=512",
     dict(tq=1, h=32, kvh=8, d=128, lens=(512, 480, 400, 300)), 256),
    ("paligemma prefill B=4 H=8/KVH=1 Tq=384 D=256",
     dict(tq=384, h=8, kvh=1, d=256, lens=(384,) * 4), 256),
    ("paligemma decode B=4 H=8/KVH=1 S=416 D=256",
     dict(tq=1, h=8, kvh=1, d=256, lens=(416, 410, 400, 390)), 256),
]
# whisper's cross-attention in its prefill: 128 decoder tokens over 1500
# frames, non-causal only
CROSS_PREFILL = ("whisper cross prefill B=4 H=20 Tq=128 S=1500 D=64",
                 dict(tq=128, h=20, kvh=20, d=64, lens=(1500,) * 4))
MASK_FORMS = [("dense", False, None), ("int8", True, None), ("paged", False, 16)]


def mask_kw(mask: str, prefix: int) -> dict:
    return {"causal": {}, "prefix": {"prefix_len": prefix},
            "noncausal": {"causal": False}}[mask]


def visible_pairs(lens, tq: int, h: int, mask: str, prefix: int) -> int:
    """(query, key) pairs the mask lets through, over every row: the
    attention's work on these inputs."""
    total = 0
    for n in lens:
        qpos = np.arange(tq) + n - tq
        if mask == "noncausal":
            vis = np.full(tq, n)
        else:
            vis = np.minimum(qpos + 1, n)
            if mask == "prefix":
                vis = np.maximum(vis, min(prefix, n))
        total += int(np.clip(vis, 0, None).sum())
    return total * h


def sdpa_mask(lens, tq: int, s: int, mask: str, prefix: int):
    """The boolean (B, 1, Tq, S) mask sdpa takes for the same keys."""
    kpos = torch.arange(s, device="cuda")
    lens_t = torch.tensor(lens, device="cuda")
    seen = (kpos[None, :] < lens_t[:, None])[:, None, :]
    if mask != "noncausal":
        qpos = torch.arange(tq, device="cuda")[None, :] + (lens_t - tq)[:, None]
        vis = kpos[None, None, :] <= qpos[..., None]
        if mask == "prefix":
            vis = vis | (kpos < prefix)
        seen = seen & vis
    return seen[:, None]


def phase_attention_masks():
    """Flash attention under the causal, prefix-LM and non-causal masks at
    D = 64, 128 and 256, decode (Tq = 1: "splitkv") and prefill (bf16:
    "mma", f32: "ffma"), K/V dense, int8 and paged (P = 16), at the serving
    shapes (MASK_SHAPES, and whisper's cross-attention prefill non-causal):
    each case one launch on its plan's route counted under its mask, within
    TOL of its plain version, a paged launch bitwise the dense launch on the
    gathered cache, two launches bitwise equal, a decode launch bitwise the
    causal launch (the route has no mask code); then timed (cold L2, median
    of 5) beside its bound, its plain version and sdpa with a boolean mask
    on the gathered, dequantized cache, and an "ffma" case beside the f32
    route's first design on the same inputs (replaced_ms)."""
    from repro_torch.kernels import attention, ops
    rows = {}
    cases = [(label, kw, prefix, mask) for label, kw, prefix in MASK_SHAPES
             for mask in ("causal", "prefix", "noncausal")]
    cases.append((CROSS_PREFILL[0], CROSS_PREFILL[1], 0, "noncausal"))
    seed = 500
    for label, kw, prefix, mask in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for form_name, int8, page_size in MASK_FORMS:
                seed += 1
                q, kv_lens, form, dense, deq = kv_case(dtype, int8, page_size, seed=seed, **kw)
                mkw = mask_kw(mask, prefix)
                p = attention.plan_for(q, form["k"], form.get("page_table"), int8)
                route = "splitkv" if kw["tq"] == 1 else (
                    "mma" if dtype == torch.bfloat16 else "ffma")
                ops.reset_launch_counts()
                got = attend(q, kv_lens, form, **mkw)
                added = {k: n for k, n in ops.attention_masks().items() if n}
                want_added = {f"{route}/{mask}": 1}
                with ops.reference_mode():
                    want = attend(q, kv_lens, form, **mkw)
                same_as_dense = (bool(torch.equal(got, attend(q, kv_lens, dense, **mkw)))
                                 if page_size else None)
                same_twice = bool(torch.equal(got, attend(q, kv_lens, form, **mkw)))
                same_causal = (bool(torch.equal(got, attend(q, kv_lens, form)))
                               if route == "splitkv" else None)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got.float(), want.float(), **TOL[dtype])
                fields = dict(case=label, mask=mask, prefix_len=prefix if mask == "prefix"
                              else None, dtype=str(dtype).split(".")[1], form=form_name,
                              route=p.route, splits=p.splits, block_q=p.block_q,
                              block_k=p.block_k, max_abs_err=err, tol=TOL[dtype],
                              within_tol=ok, launches_added=added,
                              bitwise_equal_to_dense_on_gathered=same_as_dense,
                              bitwise_equal_second_launch=same_twice,
                              bitwise_equal_causal_launch=same_causal)
                if (not ok or p.route != route or added != want_added
                        or same_as_dense is False or not same_twice or same_causal is False):
                    emit("attention_masks", **fields)
                    raise AssertionError(f"attention masks [{label} {mask} {dtype} {form_name}]: "
                                         f"{fields}")
                del got, want
                b, tq, h, d = q.shape
                lens, kvh = kw["lens"], kw["kvh"]
                kv_bytes = sum(lens) * kvh * d * 2 * (1 if int8 else q.element_size())
                if int8:
                    kv_bytes += sum(lens) * kvh * 2 * 4
                nb = kv_bytes + 2 * nbytes(q) + nbytes(kv_lens, form.get("page_table"))
                pairs = visible_pairs(lens, tq, h, mask, prefix)
                b_ms, by = bound(nb, 4 * pairs * d, dtype)
                ms = time_ms(lambda: attend(q, kv_lens, form, **mkw), iters=5)
                with ops.reference_mode():
                    plain_ms = time_ms(lambda: attend(q, kv_lens, form, **mkw), iters=5)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, deq["k"], deq["v"]))
                sm = sdpa_mask(lens, tq, kt.shape[2], mask, prefix)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sm, enable_gqa=h != kvh), iters=5)
                replaced_ms = time_ms(lambda: replaced_attention(
                    q, form["k"], form["v"], kv_lens, k_scales=form.get("k_scales"),
                    v_scales=form.get("v_scales"), page_table=form.get("page_table"),
                    **mkw), iters=5) if route == "ffma" else None
                row = dict(fields, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           replaced_ms=replaced_ms,
                           library="sdpa, boolean mask, on the gathered dequantized cache",
                           bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms, bytes=nb,
                           flops=4 * pairs * d)
                emit("attention_masks", **row)
                rows[(label, mask, row["dtype"], form_name)] = row
                del q, form, dense, deq, qt, kt, vt, sm
    torch.cuda.empty_cache()
    return rows


# flat (BH, T, D) attention (phase attention_flat): (label, BH, kv_groups,
# Tq, S, D, q dtype, int8 K/V, mask, prefix_len), each with kv_lens None
FLAT_CASES = [
    ("flat causal prefill BH=64 T=1024 D=64", 64, 1, 1024, 1024, 64, torch.bfloat16, False,
     "causal", 0),
    ("flat decode BH=64 Tq=1 S=4096 D=64", 64, 1, 1, 4096, 64, torch.bfloat16, False,
     "causal", 0),
    ("flat GQA g=4 int8 K/V prefill BH=64 T=1024 D=64", 64, 4, 1024, 1024, 64, torch.bfloat16,
     True, "causal", 0),
    ("flat GQA g=4 int8 K/V decode BH=64 Tq=1 S=4096 D=64", 64, 4, 1, 4096, 64, torch.bfloat16,
     True, "causal", 0),
    ("flat f32 prefill BH=32 T=512 D=64", 32, 1, 512, 512, 64, torch.float32, False,
     "causal", 0),
    ("flat prefix-LM prefill BH=32 T=384 D=64 prefix 256", 32, 1, 384, 384, 64, torch.bfloat16,
     False, "prefix", 256),
]
# the flat GQA call whose profile must show the attention launch alone
FLAT_PROFILED = 2


def flat_case(label, bh, g, tq, s, d, dtype, int8, seed):
    """q (BH, Tq, D) and K/V (BH // g, S, D) on the card, in `dtype` or int8
    with f32 scales (BH // g, S, 1); the same K/V dequantized to q's dtype
    for sdpa."""
    from repro_torch.core import quant
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(bh, tq, d, generator=gen, device="cuda").to(dtype)
    kv, deq = {}, {}
    for name in "kv":
        x = torch.randn(bh // g, s, d, generator=gen, device="cuda")
        if int8:
            qt = quant.quantize_kv(x)
            kv[name], kv[name + "_scales"] = qt.values, qt.scales
            deq[name] = (qt.values.float() * qt.scales).to(dtype)
        else:
            kv[name] = deq[name] = x.to(dtype)
    return q, kv, deq


def phase_attention_flat():
    """ops.flash_attention on flat (BH, T, D) operands with kv_lens None (the
    reference's other layout): a causal bf16 prefill ("mma"), a decode over
    4096 keys ("splitkv"), GQA g = 4 over int8 K/V at both, an f32 prefill
    ("ffma") and a prefix-LM prefill.  The launch counts are set to 0, every
    case is driven once, and each route it names must read one flat launch
    a case (ops.attention_layouts()); then each case is held against its
    plain version within TOL, bitwise a second launch, timed beside its
    bound, its plain version and sdpa (the flat operands as (B, H, T, D)
    views, a boolean mask for the prefix, GQA by enable_gqa) on the same
    values (an "ffma" case also beside the f32 route's first design,
    replaced_ms); and one flat GQA call is profiled: its device launches are
    the attention kernel alone (no copy of q, k or v, no fill of the
    lengths)."""
    from repro_torch.kernels import attention, ops
    inputs = [flat_case(label, bh, g, tq, s, d, dt, int8, 900 + i)
              for i, (label, bh, g, tq, s, d, dt, int8, _, _) in enumerate(FLAT_CASES)]
    calls = [lambda q=q, kv=kv, g=c[2], mask=c[8], prefix=c[9]: ops.flash_attention(
        q, kv_groups=g, **kv, **mask_kw(mask, prefix)) for c, (q, kv, _) in zip(FLAT_CASES,
                                                                                inputs)]
    routes = [attention.plan(c[1] // c[2], c[3], c[2], 1, c[5], c[4], c[6], c[7]).route
              for c in FLAT_CASES]
    ops.reset_launch_counts()
    outs = [call() for call in calls]
    torch.cuda.synchronize()
    layouts = {k: n for k, n in ops.attention_layouts().items() if n}
    want = {f"{r}/flat": routes.count(r) for r in set(routes)}
    emit("launches", run="attention_flat", by_route_layout=layouts, want=want)
    if layouts != want:
        raise AssertionError(f"attention_flat: launches by route/layout {layouts}, want {want}")
    rows = {}
    for c, (q, kv, deq), call, got, route in zip(FLAT_CASES, inputs, calls, outs, routes):
        label, bh, g, tq, s, d, dtype, int8, mask, prefix = c
        with ops.reference_mode():
            want_out = call()
        same_twice = bool(torch.equal(got, call()))
        torch.cuda.synchronize()
        err = (got.float() - want_out.float()).abs().max().item()
        ok = (bool(torch.isfinite(got).all()) and got.shape == q.shape
              and torch.allclose(got.float(), want_out.float(), **TOL[dtype]))
        if not ok or not same_twice:
            raise AssertionError(f"attention_flat [{label}]: max |kernel - plain| {err} "
                                 f"(within {TOL[dtype]}: {ok}), bitwise twice {same_twice}")
        del want_out
        slots = bh // g
        kv_bytes = slots * s * d * 2 * (1 if int8 else q.element_size()) + (
            slots * s * 2 * 4 if int8 else 0)
        nb = kv_bytes + 2 * nbytes(q)
        pairs = visible_pairs([s] * slots, tq, g, mask, prefix)
        b_ms, by = bound(nb, 4 * pairs * d, dtype)
        ms = time_ms(call, iters=10)
        with ops.reference_mode():
            plain_ms = time_ms(call, iters=5)
        q4 = q.view(slots, g, tq, d)
        k4, v4 = (deq[n].view(slots, 1, s, d) for n in "kv")
        sm = sdpa_mask([s] * slots, tq, s, mask, prefix) if mask == "prefix" else None
        causal = mask == "causal" and tq > 1  # tq == s: sdpa's causal mask is the same
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=sm, is_causal=causal, enable_gqa=g > 1), iters=10)
        replaced_ms = None
        if route == "ffma":
            replaced_ms = time_ms(lambda: replaced_attention(
                q, kv_groups=g, **kv, **mask_kw(mask, prefix)), iters=10)
        row = dict(case=label, route=route, layout="flat", kv_groups=g, mask=mask,
                   prefix_len=prefix or None, dtype=str(dtype).split(".")[1],
                   kv="int8" if int8 else "dense", kv_lens=None, max_abs_err=err,
                   tol=TOL[dtype], within_tol=ok, bitwise_equal_second_launch=same_twice,
                   kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, replaced_ms=replaced_ms,
                   library="sdpa on (B, H, T, D) views of the same values (int8 dequantized)",
                   bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms, bytes=nb,
                   flops=4 * pairs * d)
        emit("attention_flat", **row)
        rows[label] = row
        del q4, k4, v4, sm
    # one flat GQA call, profiled: the attention kernel and nothing else
    call, route = calls[FLAT_PROFILED], routes[FLAT_PROFILED]
    pattern = ATTENTION_KERNELS[route]

    def profiled():
        by_name = profile_by_name(call, 1)
        attn = sum(n for k, (_, n) in by_name.items() if re.search(pattern, k))
        return by_name, {f"attention_{route}": (1, attn)}

    by_name, counts, short = profile_until_whole(profiled)
    others = {k: v for k, v in by_name.items() if not re.search(pattern, k)}
    emit("profile_attention_flat", case=FLAT_CASES[FLAT_PROFILED][0], route=route,
         device_kernels={k: {"ms": ms, "launches": n} for k, (ms, n) in by_name.items()},
         counts=counts, profiles_read_short=short, other_kernels=list(others))
    if counts[f"attention_{route}"][1] != 1 or others:
        raise AssertionError(f"attention_flat profile: attention launches "
                             f"{counts[f'attention_{route}'][1]} (want 1), other device "
                             f"kernels {others}")
    del inputs, calls, outs
    torch.cuda.empty_cache()
    return rows, layouts


def family_inputs(cfg, rng, b: int = 4, prompt: int = 128):
    """A (b, prompt) token block and the family's stub frontend embeddings
    (f32, as serve draws them): paligemma's patches, whisper's frames."""
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(b, prompt),
                                           dtype=np.int32)).cuda()
    if cfg.family == "vlm":
        shape, key = (b, cfg.n_prefix, cfg.d_model), "patches"
    else:
        shape, key = (b, cfg.encoder.n_frames, cfg.d_model), "frames"
    return tokens, {key: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()}


def family_cache_len(cfg, prompt: int = 128, gen: int = 32) -> int:
    return prompt + gen + (cfg.n_prefix if cfg.family == "vlm" else 0)


def family_attention_want(cfg, prefills: int, steps: int, f32: bool = False) -> dict:
    """Attention launches by route and mask over `prefills` prefills and
    `steps` decode steps: paligemma's prefills on the prefix-LM mask and its
    decode steps causal; whisper's prefill an encoder layer's non-causal
    launch, and a decoder layer's causal self-attention and non-causal
    cross-attention, its decode step a causal and a non-causal "splitkv"
    launch a decoder layer."""
    from repro_torch.kernels import ops
    pre, n = ("ffma" if f32 else "mma"), cfg.n_layers
    want = dict.fromkeys(ops.attention_masks(), 0)
    if cfg.family == "vlm":
        want[f"{pre}/prefix"] = n * prefills
        want["splitkv/causal"] = n * steps
    else:
        want[f"{pre}/noncausal"] = (cfg.encoder.n_layers + n) * prefills
        want[f"{pre}/causal"] = n * prefills
        want["splitkv/causal"] = want["splitkv/noncausal"] = n * steps
    return want


def family_projections_want(cfg, prefills: int, steps: int) -> dict:
    """bgemm and bgemv launches: paligemma's six projections a layer (q, k,
    v, wo, gate+up, down); whisper's encoder layer six, its decoder layer
    ten a prefill (self q, k, v, wo; cross q, k, v, wo; up, down) and, a
    decode step, eight bgemv and two bgemm (the cross K/V over the encoder
    output, recomputed every step)."""
    n = cfg.n_layers
    if cfg.family == "vlm":
        return {"bgemm": 6 * n * prefills, "bgemv": 6 * n * steps}
    return {"bgemm": (6 * cfg.encoder.n_layers + 10 * n) * prefills + 2 * n * steps,
            "bgemv": 8 * n * steps}


def check_family_launches(counts: dict, by_mask: dict, what: str, cfg, prefills: int,
                          steps: int, f32: bool = False):
    want = family_attention_want(cfg, prefills, steps, f32)
    bad = {k: (by_mask[k], v) for k, v in want.items() if by_mask[k] != v}
    proj = family_projections_want(cfg, prefills, steps)
    bad.update({k: (counts[k], v) for k, v in proj.items() if counts[k] != v})
    emit("routes", run=what, attention_by_route_mask={k: v for k, v in by_mask.items() if v},
         projections={k: counts[k] for k in proj})
    if bad:
        raise AssertionError(f"{what}: launches (got, want) {bad}")


def phase_smoke_family():
    """paligemma-3b and whisper-large-v3 SMOKE (f32) through the kernels and
    through the plain versions: equal greedy tokens (paligemma under the
    continuous scheduler with ragged prompts and under the batch scheduler,
    whisper under the batch scheduler); every attention launch on its route
    and mask (family_attention_want: prefills on "ffma", decode steps on
    "splitkv"), the projections counted, the f32 GEMMs on "ffma_sm90".
    Returns the route/mask launch counts of each kernel run."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    out = {}
    for arch, runs in ((VLM, ("continuous", "batch")), (AUDIO, ("batch",))):
        cfg = get_config(arch, "smoke")
        params = tf.init_params(cfg, 0, "cuda")
        rng = np.random.default_rng(2)
        ragged = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
        even = [rng.integers(3, cfg.vocab, size=(10,), dtype=np.int32) for _ in range(5)]
        for run in runs:
            kw = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, params=params, verbose=False,
                      device="cuda", scheduler=run,
                      prompts=ragged if run == "continuous" else even)
            ops.reset_launch_counts()
            got = serve(arch, "smoke", **kw)
            counts, by_mask = ops.launch_counts(), ops.attention_masks()
            with ops.reference_mode():
                want = serve(arch, "smoke", **kw)
            equal = got["outputs"] == want["outputs"]
            emit("smoke_family", arch=arch, dtype="float32", scheduler=run, requests=5,
                 completed=got["completed"], tokens_equal=equal, outputs=got["outputs"])
            if not equal or got["completed"] != 5:
                raise AssertionError(f"smoke_family {arch} {run}: kernels {got['outputs']} != "
                                     f"plain {want['outputs']}")
            # the serve's warm-up runs one prefill and one decode step first
            check_family_launches(counts, by_mask, f"smoke_family {arch} {run}", cfg,
                                  got["prefills"] + 1, got["decode_steps"] + 1, f32=True)
            check_f32_routes(counts, f"smoke_family {arch} {run}")
            out[(arch, run)] = by_mask
        del params
    return out


def phase_serve_family(arch: str, params, cfg, scheduler: str):
    """A vlm or audio model FULL bf16 (seeded random weights): 8 requests,
    batch 4, prompt 128, gen 32, greedy, under `scheduler`; every logit
    finite, no plain version called, every attention launch on its route
    and mask and the projections counted (check_family_launches), every
    prefill projection on wgmma; tok/s, TTFT p50, the prefill's and decode
    step's stream time and peak device memory.  Returns (launch counts,
    route/mask counts)."""
    from repro_torch.kernels import ops
    stats, fields, counts, plain = _instrumented_serve(arch, params, cfg, scheduler=scheduler)
    by_mask = ops.attention_masks()
    phase = f"serve_{cfg.family}"
    emit(phase, **fields,
         params_b=sum(t.numel() for t in _tensors(params)) / 1e9,
         params_gb=sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9)
    emit("launches", run=f"{phase} {scheduler}", **counts)
    check_full_serve(f"{phase} {scheduler}", stats, fields, plain)
    check_family_launches(counts, by_mask, f"{phase} {scheduler}", cfg, stats["prefills"] + 1,
                          stats["decode_steps"] + 1)
    check_prefill_routes(counts, f"{phase} {scheduler}")
    return counts, by_mask


def phase_forced_family(params, cfg):
    """A vlm or audio model FULL bf16: prefill (4, 128, with its patches or
    frames) + 3 decode steps on the same tokens, kernels and plain
    versions.  Gated: (1) every block of the plain prefill (paligemma's
    dense block under the prefix mask, whisper's encoder and decoder
    blocks) run again through the kernels on the plain path's input, within
    FAMILY_TF_OUT_TOL of max |plain| (the prefill's cache is empty, so the
    block runs without one on the same keys); (2) the logits within
    FORCED_REL_TOL of max |plain logit|, or at every step no further from
    the f32 witness (the plain versions on the params upcast to f32) than
    the plain bf16 path's plus FAMILY_E2E_MARGIN; (3) every logit finite."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(17)
    tokens, extras = family_inputs(cfg, rng)
    steps = [torch.from_numpy(rng.integers(3, cfg.vocab, size=(4, 1), dtype=np.int32)).cuda()
             for _ in range(3)]
    ops.reset_launch_counts()
    cache_len = family_cache_len(cfg)
    got, t_kernel = _forced_run(params, cfg, tokens, steps, extras, cache_len)
    counts, by_mask = ops.launch_counts(), ops.attention_masks()
    names = ("dense_block",) if cfg.family == "vlm" else ("encoder_block", "decoder_block")
    originals = {name: getattr(tf, name) for name in names}
    captured = {name: [] for name in names}

    def capture(name):
        def call(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            x = out[0] if isinstance(out, tuple) else out
            if kwargs.get("cache") is None or kwargs["cache"]["pos"] == 0:
                captured[name].append((args, {k: v for k, v in kwargs.items()
                                              if k != "cache"}, x.clone()))
            return out
        return call

    for name in names:
        setattr(tf, name, capture(name))
    try:
        with ops.reference_mode():
            want, t_plain = _forced_run(params, cfg, tokens, steps, extras, cache_len)
    finally:
        for name, fn in originals.items():
            setattr(tf, name, fn)
    tf_rel = {}
    for name, runs in captured.items():
        rels = []
        for args, kwargs, plain_out in runs:
            out = originals[name](*args, **kwargs)
            rels.append(_rel(out[0] if isinstance(out, tuple) else out, plain_out))
        tf_rel[name] = rels
    del captured
    params32 = _map_tensors(params, lambda t: t.float())
    with ops.reference_mode():
        want32, _ = _forced_run(params32, dataclasses.replace(cfg, dtype="float32"), tokens,
                                steps, extras, cache_len)
    del params32
    torch.cuda.empty_cache()
    gate = logit_gate(got, want, want32, FAMILY_E2E_MARGIN)
    tf_max = {k: max(v) for k, v in tf_rel.items()}
    n_blocks = {k: len(v) for k, v in tf_rel.items()}
    want_blocks = ({"dense_block": cfg.n_layers} if cfg.family == "vlm" else
                   {"encoder_block": cfg.encoder.n_layers, "decoder_block": cfg.n_layers})
    ok = (gate["e2e_ok"] and n_blocks == want_blocks
          and all(v <= FAMILY_TF_OUT_TOL for v in tf_max.values()))
    phase = f"forced_{cfg.family}"
    emit(phase, arch=cfg.arch_id, variant="full", dtype="bfloat16", **gate,
         teacher_forced_limit=FAMILY_TF_OUT_TOL, teacher_forced_blocks=n_blocks,
         teacher_forced_max_rel=tf_max, teacher_forced_rel=tf_rel,
         within_tol=ok, prefill_ms=t_kernel[0],
         decode_ms_per_step=statistics.mean(t_kernel[1:]), plain_prefill_ms=t_plain[0],
         plain_decode_ms_per_step=statistics.mean(t_plain[1:]))
    if not ok:
        raise AssertionError(f"{phase}: finite {gate['all_finite']}, blocks {n_blocks} (want "
                             f"{want_blocks}) {tf_max} (limit {FAMILY_TF_OUT_TOL}), logits rel "
                             f"{gate['rel_err']} (tol {FORCED_REL_TOL}), to f32: kernel "
                             f"{gate['kernel_rel_err_to_f32']} vs plain "
                             f"{gate['plain_rel_err_to_f32']}")
    check_family_launches(counts, by_mask, phase, cfg, 1, 3)


def main() -> int:
    t_start = time.perf_counter()
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
    replaced_jobs = replaced_build_start()
    lib = _build.build()
    replaced = replaced_build_finish(replaced_jobs)
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds,
         nvcc_seconds_by_file=_build.build_seconds_by_file,
         library=str(lib.relative_to(HERE)), replaced_designs=replaced)
    (OUT / "ptxas.txt").write_text(_build.build_log)
    phase_sass(lib)

    with torch.inference_mode():
        rows = phase_kernels()
        phase_gemm_precision()
        smoke_routes = phase_smoke()

        cfg = get_config(ARCH, "full")
        params = tf.init_params(cfg, 0, "cuda")
        ops.reset_launch_counts()
        bf16_outputs = phase_serve(params, cfg)
        serve_counts = ops.launch_counts()
        emit("launches", run="serve", **serve_counts)
        check_launches(serve_counts, "serve")
        check_prefill_routes(serve_counts, "serve")
        serve_routes = check_attention_routes("serve", cfg.n_layers)
        ops.reset_launch_counts()
        phase_forced(params, cfg)
        forced_counts = ops.launch_counts()
        emit("launches", run="forced", **forced_counts)
        check_launches(forced_counts, "forced")
        check_prefill_routes(forced_counts, "forced")
        check_attention_routes("forced", cfg.n_layers)
        phase_profile(params, cfg, 6 * cfg.n_layers)
        phase_profile_prefill(params, cfg)
        qparams = phase_quantize(params)
        phase_smoke_int8()
        ops.reset_launch_counts()
        int8_stats = phase_serve_int8(params, cfg, bf16_outputs)
        int8_counts = ops.launch_counts()
        emit("launches", run="serve_int8", **int8_counts)
        # the serve's warm-up runs one prefill and one decode step first
        check_int8_launches(int8_counts, "serve_int8", int8_stats["prefills"] + 1,
                            int8_stats["decode_steps"] + 1)
        check_prefill_routes(int8_counts, "serve_int8")
        check_attention_routes("serve_int8", cfg.n_layers)
        ops.reset_launch_counts()
        phase_forced(qparams, cfg, phase="forced_int8")
        forced_int8 = ops.launch_counts()
        emit("launches", run="forced_int8", **forced_int8)
        check_int8_launches(forced_int8, "forced_int8", 1, 3)
        check_prefill_routes(forced_int8, "forced_int8")
        phase_profile(qparams, cfg, 0, phase="profile_int8")  # the packed kernel
        kv_rows = phase_attention_kv()
        phase_smoke_kv()
        paged_stats, paged_counts = phase_serve_paged(params, cfg)
        emit("launches", run="serve_paged", **paged_counts)
        kv_int8_counts = phase_serve_kv_int8(params, qparams, cfg)
        emit("launches", run="serve_kv_int8", **kv_int8_counts)
        kv_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        ops.reset_launch_counts()
        phase_forced(params, kv_cfg, phase="forced_kv_int8")
        forced_kv = ops.launch_counts()
        emit("launches", run="forced_kv_int8", **forced_kv)
        check_kv_launches(forced_kv, "forced_kv_int8", cfg.n_layers, 1, 3, True, False)
        phase_profile(params, kv_cfg, 6 * cfg.n_layers, phase="profile_kv_int8")
        phase_serve_batch(params, cfg, bf16_outputs)
        del params, qparams
        wkv6_rows = phase_wkv6()
        phase_rwkv_kernels()
        phase_smoke_batch(RWKV, "smoke_rwkv", check_rwkv_launches)
        rwkv_cfg = get_config(RWKV, "full")
        rwkv_params = tf.init_params(rwkv_cfg, 0, "cuda")
        rwkv_counts = phase_serve_recurrent(RWKV, "serve_rwkv", rwkv_params, rwkv_cfg,
                                            check_rwkv_launches)
        check_prefill_routes(rwkv_counts, "serve_rwkv")
        phase_forced_recurrent(
            "forced_rwkv", RWKV, rwkv_params, rwkv_cfg, kernel="rwkv6", seed=8,
            state_of=lambda cache: cache["tm"]["s"], teacher_forced=_teacher_forced_rwkv,
            limits={"out": RWKV_TF_OUT_TOL, "state": RWKV_TF_STATE_TOL},
            margin=RWKV_E2E_MARGIN, check=check_rwkv_launches)
        phase_profile(rwkv_params, rwkv_cfg, 10 * rwkv_cfg.n_layers, phase="profile_rwkv")
        phase_profile_prefill(rwkv_params, rwkv_cfg, phase="profile_prefill_rwkv")
        del rwkv_params
        ssd_rows = phase_ssd()
        phase_smoke_batch(ZAMBA, "smoke_zamba", check_zamba_launches)
        zamba_cfg = get_config(ZAMBA, "full")
        zamba_params = tf.init_params(zamba_cfg, 0, "cuda")
        zamba_counts = phase_serve_recurrent(ZAMBA, "serve_zamba", zamba_params, zamba_cfg,
                                             check_zamba_launches)
        check_prefill_routes(zamba_counts, "serve_zamba")
        check_attention_routes("serve_zamba",
                               zamba_cfg.n_layers // zamba_cfg.ssm.shared_attn_every)
        phase_forced_recurrent(
            "forced_zamba", ZAMBA, zamba_params, zamba_cfg, kernel="mamba2_ssd", seed=12,
            state_of=lambda cache: cache["mamba"]["h"], teacher_forced=_teacher_forced_zamba,
            limits={"out": ZAMBA_TF_OUT_TOL, "state": ZAMBA_TF_STATE_TOL,
                    "shared": ZAMBA_TF_OUT_TOL},
            margin=ZAMBA_E2E_MARGIN, check=check_zamba_launches)
        zamba_occ = zamba_cfg.n_layers // zamba_cfg.ssm.shared_attn_every
        phase_profile(zamba_params, zamba_cfg, 2 * zamba_cfg.n_layers + 6 * zamba_occ,
                      phase="profile_zamba")
        phase_profile_prefill(zamba_params, zamba_cfg, phase="profile_prefill_zamba",
                              state_kernel="mamba2_ssd", serial_launch=serial_ssd_launch)
        del zamba_params
        torch.cuda.empty_cache()
        moe_rows, moe_launched = phase_moe_kernels()
        moe_smoke = phase_smoke_moe()
        moe_cfg = get_config(MOE, "full")
        moe_params = tf.init_params(moe_cfg, 0, "cuda")
        moe_counts, moe_fields = phase_serve_moe(moe_params, moe_cfg)
        phase_forced_moe(moe_params, moe_cfg)
        phase_profile(moe_params, moe_cfg, 6 * moe_cfg.n_layers, phase="profile_moe",
                      tc_per_step=2 * moe_cfg.n_layers)
        phase_profile_prefill(moe_params, moe_cfg, phase="profile_prefill_moe",
                              state_kernel=None)
        moe_int8_counts = phase_serve_moe_int8(moe_params, moe_cfg, moe_fields)
        del moe_params
        torch.cuda.empty_cache()
        mask_rows = phase_attention_masks()
        flat_rows, flat_layouts = phase_attention_flat()
        family_smoke = phase_smoke_family()
        family = {}
        for arch, schedulers in ((VLM, ("continuous", "batch")), (AUDIO, ("batch",))):
            fcfg = get_config(arch, "full")
            fparams = tf.init_params(fcfg, 0, "cuda")
            for scheduler in schedulers:
                family[(arch, scheduler)] = phase_serve_family(arch, fparams, fcfg, scheduler)
            phase_forced_family(fparams, fcfg)
            # a decode step and a prefill: exact attention launches by
            # route and mask, the bgemv calls of a step
            extras = family_inputs(fcfg, np.random.default_rng(19))[1]
            cache_len = family_cache_len(fcfg, gen=64)
            phase_profile(fparams, fcfg, family_projections_want(fcfg, 0, 1)["bgemv"],
                          phase=f"profile_{fcfg.family}", extras=extras, cache_len=cache_len,
                          attention_want=family_attention_want(fcfg, 0, 1))
            phase_profile_prefill(fparams, fcfg, phase=f"profile_prefill_{fcfg.family}",
                                  state_kernel=None, extras=extras, cache_len=cache_len,
                                  attention_want=family_attention_want(fcfg, 1, 0))
            del extras
            del fparams
            torch.cuda.empty_cache()
        blas_rows, blas_counts = phase_blas()
        quant_rows, quant_counts, quant_added = phase_quant_kernels()

    # the prefill projections: every bgemm launch of the serve on the
    # tensor-core kernel (check_prefill_routes)
    sources = {"bgemv": ("src/repro_torch/csrc/bgemv.cu", "src/repro/kernels/bgemv.py:230",
                         "qkv 4x2048->2048 +bias"),
               "bgemm": ("src/repro_torch/csrc/gemm_sm90.cu", "src/repro/kernels/bgemm.py:217",
                         "qkv (4,128,2048)@(2048,2048) +bias"),
               "attention": ("src/repro_torch/csrc/attention_splitkv.cu",
                             "src/repro/kernels/attention.py:329",
                             "decode B=4 Tq=1 H=32 D=64 S=160")}
    summary = []
    for name, (src, replaces, case) in sources.items():
        r = rows[(name, case, "bfloat16")]
        launches = serve_routes["splitkv"] if name == "attention" else serve_counts[name]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ffma_ms": r["ffma_ms"], "shape": case, "dtype": "bfloat16",
                        **({"attention_route": "splitkv", "replaced_ms": r["replaced_ms"]}
                           if name == "attention" else {})})
    # the attention prefill's two routes: the bf16 serve's prefills on the
    # tensor cores, the f32 smoke serve's on the CUDA-core kernel
    prefill = "prefill B=4 Tq=128 H=32 D=64 S=160"
    for name, src, dtype, launches in (
            ("attention_mma", "src/repro_torch/csrc/attention_mma.cu", "bfloat16",
             serve_routes["mma"]),
            ("attention_ffma", "src/repro_torch/csrc/attention.cu", "float32",
             smoke_routes["ffma"])):
        r = rows[("attention", prefill, dtype)]
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": "src/repro/kernels/attention.py:329", "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "replaced_ms": r["replaced_ms"], "shape": prefill, "dtype": dtype,
                        "attention_route": name.split("_")[1],
                        "launches_from": "serve" if dtype == "bfloat16" else "smoke (f32)"})
    # the BLAS kernels: f64 (the paper's D-prefix routines) at full size,
    # launches from the blas phase; gemm's four routes apart: f64 on the f64
    # tensor cores, bf16 on the bf16 ones, aligned f32 on the CUDA cores fed
    # by the TMA ring (launches: the blas phase's f32 gemm launches on
    # csrc/gemm_f32.cu's instantiations, in place or staged; also at
    # zamba2's LoRA merge, launches from its serve), odd-K/N f32 on the same
    # ring on staged operands, C through the ODD instantiations (launches:
    # the blas phase's f32 gemm launches that took them: N % 4 != 0 or C
    # off 16 bytes)
    f32_ragged = "ragged (4095,4097)@(4097,4093) +bias gelu +residual"
    lora = "zamba2 LoRA merge (2048,128)@(128,2048)"
    blas_sources = {
        "gemm": ("src/repro_torch/csrc/gemm_f32_odd.cu", "src/repro/kernels/gemm.py:184",
                 ("gemm", f32_ragged), "float32", blas_counts["gemm_ffma_sm90_odd"]),
        "gemm_ffma_sm90": ("src/repro_torch/csrc/gemm_f32.cu", "src/repro/kernels/gemm.py:184",
                           ("gemm", f"{D8K}x{D8K}x{D8K}"), "float32",
                           blas_counts["gemm_ffma_sm90"] - blas_counts["gemm_ffma_sm90_odd"]),
        "gemm_ffma_sm90_lora": ("src/repro_torch/csrc/gemm_f32.cu",
                                "src/repro/kernels/gemm.py:184", ("gemm", lora), "float32",
                                zamba_counts["gemm_ffma_sm90"]),
        "gemm_dmma": ("src/repro_torch/csrc/gemm_f64.cu", "src/repro/kernels/gemm.py:184",
                      ("gemm", f"{D8K}x{D8K}x{D8K}"), "float64", blas_counts["gemm_dmma"]),
        "gemm_dmma_8_byte_copies": ("src/repro_torch/csrc/gemm_f64.cu",
                                    "src/repro/kernels/gemm.py:184", ("gemm", ODD), "float64",
                                    blas_counts["gemm_dmma_copy8"]),
        "gemm_wgmma_staged": ("src/repro_torch/csrc/gemm_sm90.cu",
                              "src/repro/kernels/gemm.py:184", ("gemm", ODD), "bfloat16",
                              blas_counts["gemm_wgmma_staged"]),
        "gemm_wgmma": ("src/repro_torch/csrc/gemm_sm90.cu", "src/repro/kernels/gemm.py:184",
                       ("gemm", f"{D8K}x{D8K}x{D8K}"), "bfloat16", blas_counts["gemm_wgmma"]),
        "gemv": ("src/repro_torch/csrc/gemv.cu", "src/repro/kernels/gemv.py:146",
                 ("gemv", f"{N16K}x{N16K}"), "float64", blas_counts["gemv"]),
        "blas1_reduce": ("src/repro_torch/csrc/blas1.cu", "src/repro/kernels/blas1.py:55",
                         ("dot", "n=2^26"), "float64", blas_counts["blas1_reduce"]),
        "blas1_axpy": ("src/repro_torch/csrc/blas1.cu", "src/repro/kernels/blas1.py:92",
                       ("axpy", "n=2^26"), "float64", blas_counts["blas1_axpy"]),
    }
    for name, (src, replaces, (routine, case), dtype, launches) in blas_sources.items():
        r = blas_rows[(routine, case, dtype)]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ffma_ms": r["ffma_ms"], "shape": f"{routine} {case}", "dtype": dtype,
                        **({"launches_from": "serve_zamba"} if name.endswith("_lora") else {})})
    # the packed kernels: launches from the int8 serve (bgemv_int8, gemm_int8:
    # every prefill projection on the tensor cores) and from the packed BLAS
    # run of phase 10 (gemv_int8; gemm_int8_ffma_sm90, f32 A on the f32 ring,
    # there every such launch; gemm_int8_wgmma_kn, bf16 A against "kn" B on
    # the tensor cores, its three launches there; gemm_int8_dmma, f64 A on
    # the f64 tensor cores, its three; gemm_int8_ffma, the int8-B
    # forms none takes, there every packed gemm launch on the first
    # CUDA-core kernel)
    kn_launches = sum(rose.get("gemm_wgmma", 0) for (case, dtype), rose in quant_added.items()
                      if dtype == "bfloat16" and '"kn"' in case)
    f64_launches = sum(rose.get("gemm_dmma", 0) for (_, dtype), rose in quant_added.items()
                       if dtype == "float64")  # (the dense launches on the dequantized B apart)
    quant_sources = {
        "bgemv_int8": ("src/repro_torch/csrc/qgemv.cu", "src/repro/kernels/bgemv.py:230",
                       "decode qkv 4x1x2048->2048 +bias", "bfloat16", int8_counts["bgemv_int8"]),
        "gemm_int8": ("src/repro_torch/csrc/gemm_sm90.cu", "src/repro/kernels/bgemm.py:217",
                      "prefill qkv 4x128x2048->2048 +bias", "bfloat16", int8_counts["gemm_int8"]),
        "gemm_int8_ffma": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:184",
                           RAGGED_KN_F32, "float32", quant_counts["gemm_ffma"]),
        "gemm_int8_wgmma_kn": ("src/repro_torch/csrc/gemm_sm90.cu",
                               "src/repro/kernels/gemm.py:184", f'gemm "kn" {D8K}x{D8K}x{D8K}',
                               "bfloat16", kn_launches),
        "gemm_int8_dmma": ("src/repro_torch/csrc/gemm_f64_q8.cu",
                           "src/repro/kernels/gemm.py:184", f'gemm "kn" {D8K}x{D8K}x{D8K}',
                           "float64", f64_launches),
        "gemm_int8_ffma_sm90": ("src/repro_torch/csrc/gemm_f32_q8.cu",
                                "src/repro/kernels/gemm.py:184", f'gemm "kn" {D8K}x{D8K}x{D8K}',
                                "float32", quant_counts["gemm_ffma_sm90"]),
        "gemv_int8": ("src/repro_torch/csrc/qgemv.cu", "src/repro/kernels/gemv.py:146",
                      f"gemv {N16K}x{N16K}", "float32", quant_counts["gemv_int8"]),
    }
    for name, (src, replaces, case, dtype, launches) in quant_sources.items():
        kernel = "gemm_int8" if name.startswith("gemm_int8_") else name
        r = quant_rows[(kernel, case, dtype)]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "dense_ms": r["dense_ms"], "ffma_ms": r["ffma_ms"], "shape": case,
                        "dtype": dtype,
                        **({"replaced_ms": r["replaced_ms"], "plan": r["plan"]}
                           if r["replaced_ms"] is not None else {})})
    # the int8 and paged forms of the attention kernel: launches from the
    # paged bf16 serve and the int8-KV serve (bf16 weights, dense cache)
    kv_sources = {
        "attention_paged": ("src/repro/kernels/attention.py:316",
                            "decode bf16 paged P=16 B=4 H=32 D=64 S=160", paged_counts),
        "attention_int8": ("src/repro/kernels/attention.py:329",
                           "decode int8 dense B=4 H=32 D=64 S=160", kv_int8_counts),
    }
    for name, (replaces, case, counts) in kv_sources.items():
        r = kv_rows[case]
        summary.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/attention_{r['route']}.cu",
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "dense_ms": r["dense_kernel_ms"], "replaced_ms": r["replaced_ms"],
                        "shape": case, "dtype": "bfloat16", "attention_route": r["route"]})
    # the WKV6 kernel: the prefill case's times, launches from the rwkv serve
    # (ops.rwkv6 calls; each runs DEVICE_LAUNCHES device launches), the long
    # case's time beside it
    r, long_r = wkv6_rows[WKV6_CASES[0][0]], wkv6_rows[WKV6_CASES[2][0]]
    summary.append({"name": "rwkv6", "route": "cuda", "source": "src/repro_torch/csrc/rwkv6.cu",
                    "replaces": "src/repro/kernels/rwkv6.py:99",
                    "launches": rwkv_counts["rwkv6"], "max_abs_err": r["max_abs_err_y"],
                    "max_abs_err_state": r["max_abs_err_state"], "ms": r["kernel_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None, "shape": r["case"],
                    "dtype": "bfloat16", "replaced_ms": r["replaced_ms"],
                    "device_launches_per_call": r["device_launches_per_call"],
                    "bound_with_workspace_ms": r["bound_with_workspace_ms"],
                    "long_shape": long_r["case"], "long_ms": long_r["kernel_ms"],
                    "long_replaced_ms": long_r["replaced_ms"], "long_bound_ms": long_r["bound_ms"]})
    # the SSD kernel: the prefill case's times, launches from the zamba serve
    # (ops.mamba2_ssd calls; each runs DEVICE_LAUNCHES device launches), the
    # long case's time beside it
    r, long_r = ssd_rows[SSD_CASES[0][0]], ssd_rows[SSD_CASES[2][0]]
    summary.append({"name": "mamba2_ssd", "route": "cuda",
                    "source": "src/repro_torch/csrc/mamba2.cu",
                    "replaces": "src/repro/kernels/mamba2.py:84",
                    "launches": zamba_counts["mamba2_ssd"], "max_abs_err": r["max_abs_err_y"],
                    "max_abs_err_state": r["max_abs_err_state"], "ms": r["kernel_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None, "shape": r["case"],
                    "dtype": "bfloat16", "replaced_ms": r["replaced_ms"],
                    "device_launches_per_call": r["device_launches_per_call"],
                    "bound_with_workspace_ms": r["bound_with_workspace_ms"],
                    "long_shape": long_r["case"], "long_ms": long_r["kernel_ms"],
                    "long_replaced_ms": long_r["replaced_ms"], "long_bound_ms": long_r["bound_ms"]})
    # bgemm's batched launch (the MoE experts and the BLAS batched_gemm), a
    # row a route and form: dense bf16 on the tensor cores with launches
    # from the moonshot serve and the packed "kn" stacks there with
    # launches from its int8 serve (the gate+up dual launch at the decode
    # shape; the down projection's case beside it); f32 on the TMA ring
    # with launches from the f32 moonshot smoke serve; f64 on DMMA and bf16
    # with A staged with launches from moe_kernels' checked calls (no served
    # model runs them; the BLAS case beside each); packed stacks under f32 A
    # on the f32 ring with launches from the f32 smoke serve under
    # --quantize int8; packed stacks under f64 A on DMMA, and output-major
    # packed stacks under bf16 A on the CUDA-core tile, with launches from
    # moe_kernels' checked calls
    moe_launched["bgemm_batched_dmma_dense"] = (moe_launched.get("bgemm_batched_dmma", 0)
                                                - moe_launched.get("bgemm_batched_dmma_int8", 0))
    dec_gu = "decode gate_up (64,32,2048)@(64,2048,1408) x2 silu bf16 out"
    dec_dn = "decode down (64,32,1408)@(64,1408,2048) f32 out"
    blas_label = "blas batched_gemm ({0},{1},{2})@({0},{2},{3}) {4}".format
    for name, src, case, counts, key, launches_from, side in (
            ("bgemm_batched_wgmma", "gemm_sm90.cu", dec_gu, moe_counts, "bgemm_batched_wgmma",
             "serve_moe", dec_dn),
            ("bgemm_batched_int8", "gemm_sm90.cu", f"int8 {dec_gu}", moe_int8_counts,
             "bgemm_batched_int8", "serve_moe_int8", f"int8 {dec_dn}"),
            ("bgemm_batched_ffma_sm90", "gemm_f32.cu", f"f32 {dec_dn}",
             moe_smoke[(MOE, "continuous")], "bgemm_batched_ffma_sm90", "smoke_moe (f32)",
             blas_label(*BLAS_BATCHED, "float32")),
            ("bgemm_batched_dmma", "gemm_f64.cu",
             f"f64 {dec_dn.replace('f32 out', 'f64 out')}", moe_launched,
             "bgemm_batched_dmma_dense", "moe_kernels", blas_label(*BLAS_BATCHED, "float64")),
            ("bgemm_batched_wgmma_staged", "gemm_sm90.cu",
             "odd K decode down (64,32,1407)@(64,1407,2048) f32 out", moe_launched,
             "bgemm_batched_staged", "moe_kernels", blas_label(*BLAS_BATCHED_ODD, "bfloat16")),
            ("bgemm_batched_int8_ffma_sm90", "gemm_f32_q8.cu", f"int8 f32 {dec_dn}",
             moe_smoke[(MOE, "int8")], "bgemm_batched_ffma_sm90", "smoke_moe int8 (f32)",
             f"f32 odd K {dec_dn.replace('1408', '1407')}"),
            ("bgemm_batched_int8_dmma", "gemm_f64_q8.cu",
             f"int8 f64 {dec_dn.replace('f32 out', 'f64 out')}", moe_launched,
             "bgemm_batched_dmma_int8", "moe_kernels", None),
            ("bgemm_batched_ffma", "gemm_batched_bf16.cu", f"int8 nk {dec_dn}", moe_launched,
             "bgemm_batched_ffma", "moe_kernels", None)):
        r = moe_rows[case]
        extra = {}
        if side is not None:
            o = moe_rows[side]
            extra = {"side_shape": side, "side_ms": o["kernel_ms"], "side_plain_ms": o["plain_ms"],
                     "side_bound_ms": o["bound_ms"], "side_library_ms": o["library_ms"],
                     "side_first_tile_ms": o["first_tile_ms"]}
        summary.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                        "replaces": "src/repro/kernels/bgemm.py:217", "launches": counts[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": case, "dtype": r["dtype"], "out_dtype": r["out_dtype"],
                        "plan": r["plan"], "launches_from": launches_from,
                        "first_tile_ms": r["first_tile_ms"], **extra,
                        **({"dense_ms": r["dense_ms"]} if r["dense_ms"] else {})})
    # flash attention's masks and head dim 256 (phase attention_masks, the
    # dense bf16 / f32 case at each serving shape), launches from the
    # full-width serves (whisper's batch serve, paligemma's continuous one)
    # and, for the f32 CUDA-core route, the f32 smoke serves, which run at
    # their smoke head dim: an entry names the head dim of its time
    # ("head_dim") and of its launches ("launches_head_dim")
    audio_by, vlm_by = family[(AUDIO, "batch")][1], family[(VLM, "continuous")][1]
    smoke_head_dim = {arch: get_config(arch, "smoke").head_dim for arch in (VLM, AUDIO)}
    full_head_dim = {arch: get_config(arch, "full").head_dim for arch in (VLM, AUDIO)}
    for name, src, (shape, mask, dtype), launches, launches_from, launches_head_dim in (
            ("attention_mma_noncausal", "attention_mma.cu", (MASK_SHAPES[0][0], "noncausal",
                                                             "bfloat16"),
             audio_by["mma/noncausal"], "serve_audio", full_head_dim[AUDIO]),
            ("attention_splitkv_noncausal", "attention_splitkv.cu",
             (MASK_SHAPES[1][0], "noncausal", "bfloat16"), audio_by["splitkv/noncausal"],
             "serve_audio", full_head_dim[AUDIO]),
            ("attention_mma_prefix_d256", "attention_mma.cu", (MASK_SHAPES[4][0], "prefix",
                                                               "bfloat16"),
             vlm_by["mma/prefix"], "serve_vlm", full_head_dim[VLM]),
            ("attention_splitkv_d256", "attention_splitkv.cu", (MASK_SHAPES[5][0], "causal",
                                                                "bfloat16"),
             vlm_by["splitkv/causal"], "serve_vlm", full_head_dim[VLM]),
            ("attention_ffma_noncausal", "attention.cu", (MASK_SHAPES[0][0], "noncausal",
                                                          "float32"),
             family_smoke[(AUDIO, "batch")]["ffma/noncausal"], "smoke_family whisper (f32)",
             smoke_head_dim[AUDIO]),
            ("attention_ffma_prefix", "attention.cu", (MASK_SHAPES[4][0], "prefix", "float32"),
             family_smoke[(VLM, "continuous")]["ffma/prefix"], "smoke_family paligemma (f32)",
             smoke_head_dim[VLM])):
        r = mask_rows[(shape, mask, dtype, "dense")]
        summary.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                        "replaces": "src/repro/kernels/attention.py:329", "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape, "mask": mask, "dtype": dtype,
                        "attention_route": r["route"], "launches_from": launches_from,
                        "head_dim": int(re.search(r"D=(\d+)", shape).group(1)),
                        "launches_head_dim": launches_head_dim,
                        **({"replaced_ms": r["replaced_ms"]} if r["replaced_ms"] else {})})
    # kernel 1's other forms (the BLAS library's batched GEMV), launches
    # from the blas phase: short members on csrc/bgemv_members.cu (both ops;
    # launches: every short-member launch), long members on csrc/bgemv.cu's
    # per-member body (op = A^T) and csrc/bgemv_rows.cu (op = A), a
    # broadcast A on the decode bodies; each beside the first design's plan on the same
    # inputs (replaced_ms: scripts/replaced/bgemv_first.cu for op = A^T)
    for name, src, (routine, case), dtype, key in (
            ("bgemv_batched_n", "bgemv_rows.cu", ("batched_gemv", f"{BGEMV_MEMBERS} trans=False"),
             "float64", "batched_n"),
            ("bgemv_batched_t", "bgemv.cu", ("batched_gemv", f"{BGEMV_MEMBERS} trans=True"),
             "float64", "batched_t"),
            ("bgemv_batched_t_bf16", "bgemv.cu",
             ("batched_gemv", f"{BGEMV_MEMBERS} trans=True"), "bfloat16", "batched_t"),
            ("bgemv_members_n", "bgemv_members.cu",
             ("batched_gemv", f"{BGEMV_SMALL} trans=False"), "float64", "members"),
            ("bgemv_members_t", "bgemv_members.cu",
             ("batched_gemv", f"{BGEMV_SMALL} trans=True"), "float64", "members"),
            ("bgemv_members_n_bf16", "bgemv_members.cu",
             ("batched_gemv", f"{BGEMV_SMALL} trans=False"), "bfloat16", "members"),
            ("bgemv_members_t_bf16", "bgemv_members.cu",
             ("batched_gemv", f"{BGEMV_SMALL} trans=True"), "bfloat16", "members"),
            ("bgemv_broadcast_n", "bgemv_rows.cu",
             ("batched_gemv", f"{BGEMV_BROADCAST} trans=False"), "bfloat16", "broadcast_n"),
            ("bgemv_broadcast_t_f64", "bgemv.cu",
             ("batched_gemv", f"{BGEMV_BROADCAST} trans=True"), "float64", "broadcast_t")):
        r = blas_rows[(routine, case, dtype)]
        summary.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                        "replaces": "src/repro/kernels/bgemv.py:230",
                        "launches": blas_counts[f"bgemv_{key}"], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "replaced_ms": r["replaced_ms"],
                        "shape": f"{routine} {case}", "dtype": dtype, "form": r["route"],
                        "launches_from": "blas"})
    # kernel 2's flat layout, launches from the attention_flat phase's run
    for name, label in (("attention_mma_flat", FLAT_CASES[0][0]),
                        ("attention_splitkv_flat", FLAT_CASES[1][0]),
                        ("attention_mma_flat_gqa_int8", FLAT_CASES[2][0]),
                        ("attention_ffma_flat", FLAT_CASES[4][0])):
        r = flat_rows[label]
        summary.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{ATTENTION_SOURCES[r['route']]}",
                        "replaces": "src/repro/kernels/attention.py:329",
                        "launches": flat_layouts[f"{r['route']}/flat"],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": label, "dtype": r["dtype"], "attention_route": r["route"],
                        "layout": "flat", "launches_from": "attention_flat",
                        **({"replaced_ms": r["replaced_ms"]} if r["replaced_ms"] else {})})
    emit("done", seconds=time.perf_counter() - t_start, nvcc_seconds=_build.build_seconds,
         nvcc_seconds_by_file=_build.build_seconds_by_file)
    (OUT / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
