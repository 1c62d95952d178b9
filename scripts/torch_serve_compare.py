#!/usr/bin/env python3
"""End-to-end numbers of one tree of the port, for comparing two trees on
one GPU in one session.

    python3 scripts/torch_serve_compare.py [TREE [ARCH [int8]]]

TREE (default: this repository) is a checkout of the port; its kernels are
built from its own csrc/ into its own build/kernels/.  Serves ARCH (default
stablelm-1.6b; rwkv6-1.6b and zamba2-1.2b under --scheduler batch) FULL
(seeded random weights, bf16; 8 requests, batch 4, prompt 128, gen 32,
greedy, no EOS; with `int8`, stablelm with --quantize int8) and then
profiles a decode step (and, for stablelm and rwkv6, a prefill) as
chip_smoke.py's profile phases do.  Prints one JSON line:
tok/s, TTFT p50, wall and device ms per decode step (and per prefill), the
device's idle share, attention's device ms, the decode step's device
events, the bgemv and packed-GEMV (qgemv) kernels', the WKV6 kernels' (a
prefill) and the f32 GEMM kernels' (zamba2's LoRA
merges: csrc/gemm.cu's float instantiations or csrc/gemm_f32.cu) device ms
and launches (among the step's top 12).  Run it for the parent and the
change in turns (parent, change, change, parent) and compare within one
session.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cs.OUT.mkdir(parents=True, exist_ok=True)
    arch = sys.argv[2] if len(sys.argv) > 2 else cs.ARCH
    int8 = len(sys.argv) > 3 and sys.argv[3] == "int8"
    dense = arch == cs.ARCH
    with torch.inference_mode():
        cfg = get_config(arch, "full")
        params = tf.init_params(cfg, 0, "cuda")
        stats = serve(arch, "full", requests=8, batch=4, prompt_len=128, gen=32, seed=0,
                      eos=-1, params=params, verbose=False, device="cuda",
                      **({} if dense else {"scheduler": "batch"}),
                      **({"quantize": "int8"} if int8 else {}))
        if int8:
            from repro_torch.models import layers
            params = layers.quantize_weights(params)
        cs.phase_profile(params, cfg)
        if dense or arch == cs.RWKV:
            cs.phase_profile_prefill(params, cfg)
    prof = cs.RESULTS["profile"][-1]
    pre = cs.RESULTS["profile_prefill"][-1] if "profile_prefill" in cs.RESULTS else {"top": []}

    def top(*names):  # (device ms, launches) a step of the top-12 kernels named
        rows = [t for t in prof["top"] if any(n in t["name"] for n in names)]
        return sum(t["ms_per_step"] for t in rows), sum(t["calls_per_step"] for t in rows)

    print(json.dumps({
        "tree": str(tree), "arch": arch, "quantize": "int8" if int8 else None,
        "tok_s": stats["tok_s"],
        "ttft_p50_s": statistics.median(stats["ttft"]),
        "decode_wall_ms": prof["wall_ms_per_step"],
        "decode_device_ms": prof["device_busy_ms_per_step"],
        "decode_idle_share": prof["device_idle_share"],
        "decode_attention_ms": prof["attention_ms_per_step"],
        "decode_events": prof["device_events_per_step"],
        "decode_bgemv_ms_launches": top("bgemv"),
        "decode_qgemv_ms_launches": top("qgemv"),
        "prefill_wkv6_ms": pre.get("wkv6_ms_per_prefill", sum(  # all, or those in the top 12
            t["ms_per_prefill"] for t in pre["top"] if "wkv6" in t["name"])),
        "decode_f32_gemm_ms_launches": top("gemm_kernel<float", "gemm_f32_kernel"),
        "prefill_wall_ms": pre.get("wall_ms_per_prefill"),
        "prefill_device_ms": pre.get("device_busy_ms_per_prefill"),
        "prefill_attention_ms": pre.get("attention_ms_per_prefill", sum(
            t["ms_per_prefill"] for t in pre["top"] if "attention" in t["name"]))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
