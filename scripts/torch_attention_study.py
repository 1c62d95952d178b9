#!/usr/bin/env python3
"""The measurement behind the split-KV attention plan's chunk, on one GPU.

    PYTHONPATH=src:. python3 scripts/torch_attention_study.py chunks
    PYTHONPATH=src:. python3 scripts/torch_attention_study.py causal
    PYTHONPATH=src:. python3 scripts/torch_attention_study.py ffma

chunks: the "splitkv" decode kernel (csrc/attention_splitkv.cu) at every
chunk of keys a split may cover (16-512, each with the plan's splits a
block), and at the plan's chunk with 1-32 splits a block, at the serving
decode shape (B = 4, H = 32, D = 64, S = 160) and at long context (S =
4096), in bf16, int8 K/V and GQA 32/8; each checked against the plain
version, then timed as chip_smoke.py times kernels (cold L2, median of 20).
`kernels.attention.CHUNK` and `BLOCKS_PER_SM` come from these times.  One
JSON line a case: microseconds by chunk ("64") or by chunk and splits a
block ("64x8"), the fastest, and the plan.

causal: every causal case of chip_smoke.py's attention_kv phase, and the
dense bf16 and f32 prefills beside them, through ops.flash_attention and
through the f32 route's first design (scripts/replaced/attention_first.cu,
chip_smoke.replaced_attention) on the same inputs, timed as above, with
ptxas's registers and spills for the attention kernels this process built.
It reads only what chip_smoke.py has had since that design was replaced
(`kv_case`, `attend`, `KV_CASES`, `TOL`, `time_ms`, `_attn_name`,
`replaced_build_start`, `replaced_attention`), so the same file times two
such trees in one call: run it from each tree's root in turn
(PYTHONPATH=src:. there), parent, change, change, parent.

ffma: the f32 route (csrc/attention.cu) as built against variants compiled
from its source with other tiles (`FFMA_VARIANTS`: threads a block,
queries and keys a block, stages, lanes along the keys, warps along d,
blocks an SM), each with its ptxas registers and spills, at the f32
prefill cases chip_smoke.py times (whisper's encoder non-causal, the flat
causal T = 512 as its cache-layout view, the smoke prefill, D = 128 GQA,
paligemma's prefix-LM at D = 256, the smoke head dims 16 and 32): each
checked against the plain version, timed as above in turns (design, each
variant, design again).  One JSON line a case: microseconds by design.

Needs chip_smoke.py at the repository root (its inputs and timing) and a
CUDA device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

import chip_smoke as cs

CHUNKS = (16, 32, 64, 128, 256, 512)
PER_BLOCK = (1, 2, 4, 8, 16, 32)
CASES = [  # (label, int8, page size, chip_smoke.kv_case keywords)
    ("decode bf16 S=160", False, None, {}),
    ("decode int8 S=160", True, None, {}),
    ("decode bf16 paged P=16 S=160", False, 16, {}),
    ("decode bf16 GQA 32/8 S=160", False, None, dict(kvh=8)),
    ("long bf16 S=4096", False, None, dict(lens=(4096,) * 4)),
    ("long int8 S=4096", True, None, dict(lens=(4096,) * 4)),
    ("long bf16 GQA 32/8 S=4096", False, None, dict(kvh=8, lens=(4096,) * 4)),
]


def chunks():
    from repro_torch.kernels import attention, ops
    for i, (label, int8, page_size, kw) in enumerate(CASES):
        q, kv_lens, form, _, _ = cs.kv_case(torch.bfloat16, int8, page_size, seed=200 + i, **kw)
        with ops.reference_mode():
            want = cs.attend(q, kv_lens, form)
        k, table = form["k"], form.get("page_table")
        s = attention._logical(k, table)[0]
        out = torch.empty_like(q)
        us = {}
        b, _, h, d = q.shape
        plans = {f"{c}": attention.plan(b, 1, h, k.shape[2], d, s, q.dtype, int8, chunk=c)
                 for c in CHUNKS}
        base = attention.plan_for(q, k, table, int8)
        plans.update({f"{base.chunk}x{n}": base._replace(per_block=n) for n in PER_BLOCK
                      if n <= base.splits and n != base.per_block})
        for c, p in plans.items():

            def call(p=p):
                return attention.run(q, k, form["v"], kv_lens, out, p, dtype_code=1,
                                     k_scales=form.get("k_scales"),
                                     v_scales=form.get("v_scales"), page_table=table)

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), **cs.TOL[torch.bfloat16]):
                raise AssertionError(f"chunks: {p} at [{label}] disagrees with plain")
            us[c] = cs.time_ms(call) * 1e3
        print(json.dumps({"case": label, "us": us, "fastest": min(us, key=us.get),
                          "plan": base._asdict()}), flush=True)


CAUSAL_EXTRA = [  # dense prefills beside chip_smoke.KV_CASES (same fields)
    ("prefill bf16 dense B=4 Tq=128 H=32 D=64 S=160", torch.bfloat16, False, None,
     dict(tq=128, lens=(128,) * 4, s=160)),
    ("prefill bf16 dense B=4 Tq=128 H=16 D=128 S=160", torch.bfloat16, False, None,
     dict(tq=128, h=16, kvh=16, d=128, lens=(128,) * 4, s=160)),
    ("prefill f32 dense B=4 Tq=128 H=32 D=64 S=160", torch.float32, False, None,
     dict(tq=128, lens=(128,) * 4, s=160)),
]


def causal():
    from repro_torch.kernels import _build, attention, ops
    jobs = cs.replaced_build_start()
    lib = _build.build()
    cs.replaced_build_finish(jobs)
    ptxas, name = {}, None
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w*attention(?:_mma)?_kernel\w*)'", line)
        if m or "Compiling entry function" in line:
            name = (cs._attn_name(m.group(1)) or m.group(1)) if m else None
            continue
        if name and (m := re.search(r"Used (\d+) registers", line)):
            ptxas.setdefault(name, {})["registers"] = int(m.group(1))
        if name and (m := re.search(r"(\d+) bytes spill stores", line)):
            ptxas.setdefault(name, {})["spill_stores"] = int(m.group(1))
    print(json.dumps({"library": lib.name, "attention_ptxas": ptxas or "loaded as built"}),
          flush=True)
    for i, (label, dtype, int8, page_size, kw) in enumerate([*cs.KV_CASES, *CAUSAL_EXTRA]):
        q, kv_lens, form, _, _ = cs.kv_case(dtype, int8, page_size, seed=300 + i, **kw)
        got = cs.attend(q, kv_lens, form)
        with ops.reference_mode():
            want = cs.attend(q, kv_lens, form)
        ok = torch.allclose(got.float(), want.float(), **cs.TOL[dtype])
        row = {"case": label, "route": attention.plan_for(q, form["k"], form.get("page_table"),
                                                           int8).route, "within_tol": ok,
               "kernel_us": 1e3 * cs.time_ms(lambda: cs.attend(q, kv_lens, form)),
               "replaced_us": 1e3 * cs.time_ms(lambda: cs.replaced_attention(
                   q, form["k"], form["v"], kv_lens, k_scales=form.get("k_scales"),
                   v_scales=form.get("v_scales"), page_table=form.get("page_table")))}
        print(json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"attention [{label}] disagrees with its plain version")


#: tile variants of csrc/attention.cu: name -> {head dim: (THREADS, BQ, BK,
#: STAGES, SX, WX, BLOCKS)}, each replacing that head dim's `Tile`
FFMA_VARIANTS = {
    "w8": {16: (256, 64, 64, 3, 8, 1, 2), 32: (256, 64, 64, 3, 8, 1, 2),
           64: (256, 64, 64, 2, 8, 2, 2), 128: (256, 64, 32, 2, 8, 2, 2),
           256: (256, 32, 32, 2, 8, 4, 1)},
    "w4 sx16": {64: (128, 64, 64, 2, 16, 1, 2)},
    "w8 bq128": {64: (256, 128, 64, 2, 8, 1, 1)},
}
FFMA_FIELDS = ("THREADS", "BQ", "BK", "STAGES", "SX", "WX", "BLOCKS")
FFMA_CASES = [  # (label, mask, prefix_len, chip_smoke.kv_case keywords)
    ("whisper encoder B=4 H=20 T=1500 D=64", "noncausal", 0,
     dict(tq=1500, h=20, kvh=20, d=64, lens=(1500,) * 4)),
    ("flat causal BH=32 T=512 D=64 (cache view)", "causal", 0,
     dict(b=32, tq=512, h=1, kvh=1, d=64, lens=(512,) * 32)),
    ("smoke prefill B=4 Tq=128 H=32 D=64 S=160", "causal", 0,
     dict(tq=128, lens=(128,) * 4, s=160)),
    ("D=128 prefill B=4 H=32/KVH=8 Tq=128 S=512", "causal", 0,
     dict(tq=128, h=32, kvh=8, d=128, lens=(512,) * 4)),
    ("paligemma prefill B=4 H=8/KVH=1 Tq=384 D=256", "prefix", 256,
     dict(tq=384, h=8, kvh=1, d=256, lens=(384,) * 4)),
    ("D=16 prefill B=4 Tq=100 H=4/KVH=2", "causal", 0,
     dict(tq=100, h=4, kvh=2, d=16, lens=(160, 131, 100, 117))),
    ("D=32 prefill B=4 Tq=70 H=8/KVH=2", "causal", 0,
     dict(tq=70, h=8, kvh=2, d=32, lens=(200, 70, 133, 97))),
]


def ffma():
    import ctypes
    from pathlib import Path

    from repro_torch.kernels import _build, attention, ops
    root = Path(__file__).resolve().parents[1]
    csrc = root / "src" / "repro_torch" / "csrc"
    out_dir = root / "build" / "study_ffma"
    jobs = {}
    for name, tiles in FFMA_VARIANTS.items():
        src = (csrc / "attention.cu").read_text()
        for d, values in tiles.items():
            pattern = (rf"(template <> struct Tile<{d}> {{\n  static constexpr int )[^;]*;")
            fields = ", ".join(f"{f} = {v}" for f, v in zip(FFMA_FIELDS, values))
            src, n = re.subn(pattern, lambda m: m.group(1) + fields + ";", src)
            if n != 1:
                raise RuntimeError(f"ffma: variant {name!r} does not apply at D = {d}")
        vdir = out_dir / name.replace(" ", "_")
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "attention.cu").write_text(src)
        jobs[name] = (vdir / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", "-I", str(csrc), "-o",
             str(vdir / "lib.so"), str(vdir / "attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build()
    fns = {"design": _build.function("attention_launch", attention._FFMA_ARGTYPES)}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ffma: nvcc failed for {name!r}:\n{log[-3000:]}")
        regs = {}
        for fn_name, used in re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) regis",
                                        log, flags=re.S):
            regs[cs._attn_name(fn_name)] = int(used)
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        print(json.dumps({"variant": name, "tiles": tiles, "registers": regs,
                          "spill_store_bytes": spills}), flush=True)
        fn = ctypes.CDLL(str(path)).attention_launch
        fn.argtypes, fn.restype = attention._FFMA_ARGTYPES, ctypes.c_int
        fns[name] = fn
    for i, (label, mask, prefix, kw) in enumerate(FFMA_CASES):
        q, kv_lens, form, _, _ = cs.kv_case(torch.float32, False, None, seed=400 + i, **kw)
        mkw = cs.mask_kw(mask, prefix)
        with ops.reference_mode():
            want = cs.attend(q, kv_lens, form, **mkw)
        b, tq, h, d = q.shape
        k, v = form["k"], form["v"]
        s = k.shape[1]
        p = attention.plan_for(q, k)
        out = torch.empty_like(q)
        order = ["design"] + [n for n in FFMA_VARIANTS if d in FFMA_VARIANTS[n]] + ["design"]
        us = {}
        for n in order:
            tile = (p.block_q, p.block_k) if n == "design" else FFMA_VARIANTS[n][d][1:3]

            def call(fn=fns[n], tile=tile):
                err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                         kv_lens.data_ptr(), None, out.data_ptr(), b, tq, h, s, k.shape[2], d,
                         0, 0, attention.visible_prefix(s, **mkw), q.stride(1), q.stride(2),
                         *tile, float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ffma: {n} launch failed ({err})")

            call()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **cs.TOL[torch.float32]):
                raise AssertionError(f"ffma: {n} at [{label}] disagrees with plain")
            key = n if n not in us else n + " again"
            us[key] = 1e3 * cs.time_ms(call, iters=10)
        print(json.dumps({"case": label, "mask": mask, "us": us,
                          "fastest": min(us, key=us.get)}), flush=True)


def main() -> int:
    modes = {"chunks": chunks, "causal": causal, "ffma": ffma}
    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    with torch.inference_mode():
        modes[sys.argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
