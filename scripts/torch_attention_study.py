#!/usr/bin/env python3
"""The measurement behind the split-KV attention plan's chunk, on one GPU.

    PYTHONPATH=src:. python3 scripts/torch_attention_study.py chunks

chunks: the "splitkv" decode kernel (csrc/attention_splitkv.cu) at every
chunk of keys a split may cover (16-512, each with the plan's splits a
block), and at the plan's chunk with 1-32 splits a block, at the serving
decode shape (B = 4, H = 32, D = 64, S = 160) and at long context (S =
4096), in bf16, int8 K/V and GQA 32/8; each checked against the plain
version, then timed as chip_smoke.py times kernels (cold L2, median of 20).
`kernels.attention.CHUNK` and `BLOCKS_PER_SM` come from these times.  One
JSON line a case: microseconds by chunk ("64") or by chunk and splits a
block ("64x8"), the fastest, and the plan.

Needs chip_smoke.py at the repository root (its inputs and timing) and a
CUDA device.
"""

from __future__ import annotations

import json
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


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] != "chunks":
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    with torch.inference_mode():
        chunks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
