"""Parent vs change, in turns, in one call: the bf16 GEMM shapes of the
2-D path (8192^3 and the prefill projections), timed by chip_smoke.py's
`time_ms` (cold L2).

    git archive <parent> | tar -x -C build/parent   # the parent tree
    python scripts/torch_gemm_turns.py               # on the GPU, from the root

Both trees build their kernels first (in parallel); then each side runs in a
process of its own, in the order parent, change, change, parent, parent,
change.  Results to chiprun_out/ab.json."""
import json, subprocess, sys, time
TREES = {"parent": "build/parent", "change": "."}
CODE = r'''
import json, sys, torch
sys.path.insert(0, "{tree}/src"); sys.path.insert(0, "{tree}")
import chip_smoke as cs
from repro_torch.kernels import _build, ops
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cuda").manual_seed(0)
def r(*s, std=1.0):
    return (torch.randn(*s, generator=g, device="cuda") * std).bfloat16()
out = {{}}
a, b = r(8192, 8192), r(8192, 8192, std=8192 ** -0.5)
out["8192^3"] = cs.time_ms(lambda: ops.gemm(a, b), iters=10)
del a, b
x = r(4, 128, 2048)
for name, k, n, kw in (("qkv", 2048, 2048, {{}}), ("gate_up", 2048, 5632, {{"gate": 1}}),
                       ("in_proj", 2048, 8384, {{}})):
    w = r(k, n, std=k ** -0.5)
    w2 = r(k, n, std=k ** -0.5) if kw else None
    out[name] = cs.time_ms(lambda: ops.bgemm(x, w, b2=w2, activation="silu" if w2 is not None else None))
xd = r(4, 128, 5632); wd = r(5632, 2048, std=5632 ** -0.5); res = r(4, 128, 2048)
out["down"] = cs.time_ms(lambda: ops.bgemm(xd, wd, residual=res))
print("RESULT", json.dumps(out))
'''
def run(tree):
    p = subprocess.run([sys.executable, "-c", CODE.format(tree=TREES[tree])], capture_output=True, text=True)
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT")]
    if not line:
        print(p.stdout[-3000:], p.stderr[-3000:]); raise SystemExit(1)
    return json.loads(line[0][7:])
t0 = time.time()
# build both first, in parallel
procs = [subprocess.Popen([sys.executable, "-c", f"import sys; sys.path.insert(0, '{t}/src'); from repro_torch.kernels import _build; _build.build()"]) for t in TREES.values()]
for p in procs: p.wait()
print("built", time.time() - t0, flush=True)
res = {"parent": [], "change": []}
for tree in ("parent", "change", "change", "parent", "parent", "change"):
    res[tree].append(run(tree))
    print(tree, res[tree][-1], flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
json.dump(res, open("chiprun_out/ab.json", "w"), indent=1)
