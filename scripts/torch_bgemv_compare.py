#!/usr/bin/env python3
"""bgemv of one tree of the port at the served decode shapes, for comparing
two trees in one run on one GPU.

    python3 scripts/torch_bgemv_compare.py [TREE]

TREE (default: this repository) is a checkout of the port; its kernels are
built from its own csrc/ into its own build/kernels/.  Times `ops.bgemv`
of that tree at every decode projection shape of stablelm-1.6b, rwkv6-1.6b
and zamba2-1.2b (batch 4, bf16, seeded inputs) beside torch.matmul on the
same inputs (the gate: `matmul` of x and [W_g|W_u], products only), with
this repository's chip_smoke.time_ms (cold L2, median of 20).  Prints one
JSON line.  Run it for the parent and the change in turns (parent, change,
change, parent) and compare within one run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

# (what, K, N, gate): the decode projections of the served models
SHAPES = [("stablelm qkv", 2048, 2048, False), ("stablelm gate+up", 2048, 5632, True),
          ("stablelm down", 5632, 2048, False), ("rwkv 2048->64", 2048, 64, False),
          ("rwkv 64->2048", 64, 2048, False), ("rwkv 2048->7168", 2048, 7168, False),
          ("rwkv 7168->2048", 7168, 2048, False), ("zamba2 in", 2048, 8384, False),
          ("zamba2 out", 4096, 2048, False), ("zamba2 up", 2048, 8192, False),
          ("zamba2 down", 8192, 2048, False)]


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[1]
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else root).resolve()
    sys.path[:0] = [str(tree / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(7)
    row = {"tree": str(tree)}
    with torch.inference_mode():
        for what, k, n, gate in SHAPES:
            x = torch.randn(4, k, generator=g, device="cuda").bfloat16()
            w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).bfloat16()
            w2 = ((torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).bfloat16()
                  if gate else None)
            both = torch.cat([w, w2], 1) if gate else w
            act = "silu" if gate else None
            row[what] = {
                "us": cs.time_ms(lambda: ops.bgemv(w, x, a2=w2, activation=act,
                                                   transpose_a=True)) * 1e3,
                "matmul_us": cs.time_ms(lambda: torch.matmul(x, both)) * 1e3}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
