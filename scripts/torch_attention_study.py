#!/usr/bin/env python3
"""The measurement behind the split-KV attention plan's chunk, on one GPU.

    PYTHONPATH=src:. python3 scripts/torch_attention_study.py chunks
    PYTHONPATH=src:. python3 scripts/torch_attention_study.py causal

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
through the CUDA-core kernel csrc/attention.cu on the same inputs, timed as
above, with ptxas's registers and spills for the attention kernels this
process built.  It reads only what the parent of a kernel change also has
(`kv_case`, `attend`, `KV_CASES`, `TOL`, `time_ms`, `_attn_name`), so the
same file times two trees in one call: run it from each tree's root in
turn (PYTHONPATH=src:. there), parent, change, change, parent.

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
    lib = _build.build()
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
        out = torch.empty_like(q)
        row = {"case": label, "route": attention.plan_for(q, form["k"], form.get("page_table"),
                                                           int8).route, "within_tol": ok,
               "kernel_us": 1e3 * cs.time_ms(lambda: cs.attend(q, kv_lens, form)),
               "ffma_us": 1e3 * cs.time_ms(lambda: attention.ffma(
                   q, form["k"], form["v"], kv_lens, out, dtype_code=ops._DTYPE_CODES[dtype],
                   k_scales=form.get("k_scales"), v_scales=form.get("v_scales"),
                   page_table=form.get("page_table")))}
        print(json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"attention [{label}] disagrees with its plain version")


def main() -> int:
    modes = {"chunks": chunks, "causal": causal}
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
