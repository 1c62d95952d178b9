#!/usr/bin/env python3
"""Two measurements behind the tensor-core GEMM's plan and gates, on one GPU.

    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py tiles
    PYTHONPATH=src:. python3 scripts/torch_gemm_study.py witness [--ffma]

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

Needs chip_smoke.py at the repository root (its timing and forced-run
helpers) and a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


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


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in ("tiles",
                                                                                "witness"):
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    with torch.inference_mode():
        if sys.argv[1] == "tiles":
            tiles()
        else:
            witness("--ffma" in sys.argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
