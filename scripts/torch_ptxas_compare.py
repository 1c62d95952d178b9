#!/usr/bin/env python3
"""ptxas's registers, spills and shared memory of the same kernels in two
trees of the port, for showing that a change left some instantiations'
code as it was.

    python3 scripts/torch_ptxas_compare.py OTHER_TREE [FILE.cu ...]

Compiles each FILE (default: bgemv.cu attention.cu attention_mma.cu
attention_splitkv.cu) of src/repro_torch/csrc/ in this repository and in
OTHER_TREE (e.g. the parent unpacked under build/) with the flags the
build uses (`kernels._build.FLAGS`, `-Xptxas -v`), all in parallel, into
build/ptxas_compare/.  Each kernel of OTHER_TREE is matched to the one of
this tree with the same name whose template arguments are the other's
followed only by `false` (a flag this tree added, off: the form the other
tree had).  Prints one JSON line: for every matched pair the registers,
spill stores and loads and static shared memory of both and whether they
are equal, the kernels of this tree with no counterpart, and `same`, true
when every matched pair is equal.  Exits 1 when one is not, or when a
kernel of OTHER_TREE has no counterpart.  Needs nvcc (the GPU machine).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_FILES = ["bgemv.cu", "attention.cu", "attention_mma.cu", "attention_splitkv.cu"]


def compile_all(jobs: list) -> dict:
    """{(tag, file): ptxas log} of nvcc over every (tag, tree, file), run at once."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = ROOT / "build" / "ptxas_compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, tree, name in jobs:
        src = tree / "src" / "repro_torch" / "csrc" / name
        cmd = [_build._nvcc(), *_build.FLAGS, "-c", str(src), "-o", str(out / f"{tag}_{name}.o")]
        procs[tag, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)
    logs = {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    return logs


def demangle(names: list) -> dict:
    tool = shutil.which("cu++filt") or str(Path(_nvcc_dir()) / "cu++filt")
    if not Path(tool).exists():
        tool = "c++filt"
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, res))


def _nvcc_dir() -> str:
    from repro_torch.kernels import _build
    return str(Path(_build._nvcc()).parent)


def kernels(log: str) -> dict:
    """{mangled name: {registers, spill_stores, spill_loads, smem}} from a
    ptxas -v log."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = found.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            entry["smem"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
    return found


def _arg(a: str) -> str:
    """A template argument as c++filt and cu++filt both print it: cu++filt
    writes `(bool)0` and `(int)64` where c++filt writes `false` and `64`."""
    a = a.strip()
    m = re.fullmatch(r"\((\w+)\)(-?\d+)", a)
    if m:
        return {"0": "false", "1": "true"}[m.group(2)] if m.group(1) == "bool" else m.group(2)
    return a


def split_template(demangled: str) -> tuple:
    """(name, [template arguments]) of a demangled function."""
    start = re.search(r"\w<", demangled).end() - 1  # not `<unnamed>::`
    depth, args, cur = 0, [], ""
    for i, c in enumerate(demangled[start:], start):
        if c == "<":
            depth += 1
            if depth == 1:
                continue
        elif c == ">":
            depth -= 1
            if depth == 0:
                args.append(_arg(cur))
                return demangled[:start].split("::")[-1], args
        elif c == "," and depth == 1:
            args.append(_arg(cur))
            cur = ""
            continue
        cur += c
    raise ValueError(demangled)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    files = sys.argv[2:] or DEFAULT_FILES
    logs = compile_all([(tag, tree, f) for tag, tree in (("this", ROOT), ("other", other))
                        for f in files])
    result, same = {}, True
    for f in files:
        mine, theirs = kernels(logs["this", f]), kernels(logs["other", f])
        names = demangle(list(mine) + list(theirs))
        mine_t = {k: split_template(names[k]) for k in mine}
        matched, pairs, missing = set(), {}, []
        for k, stats in theirs.items():
            name, args = split_template(names[k])
            hit = [m for m, (n2, a2) in mine_t.items()
                   if n2 == name and a2[:len(args)] == args
                   and all(a == "false" for a in a2[len(args):])]
            if len(hit) != 1:
                missing.append(names[k])
                continue
            matched.add(hit[0])
            equal = mine[hit[0]] == stats
            same &= equal
            pairs[f"{name}<{', '.join(args)}>"] = {"this": mine[hit[0]], "other": stats,
                                                   "equal": equal}
        same &= not missing
        result[f] = {"pairs": pairs, "unmatched_other": missing,
                     "new_in_this": sorted(names[k] for k in mine if k not in matched)}
    print(json.dumps({"same": same, "files": result}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
