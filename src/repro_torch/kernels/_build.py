"""Build the port's CUDA kernels into one shared library and load it.

Every `csrc/*.cu` is compiled by its own nvcc process, all started together,
for `sm_90a`; the objects are linked into one `.so` with a plain C interface
that `ctypes` loads.  The library's file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is loaded as
built.  The build lands in `build/kernels/` at the repository root, which
git ignores.

Nothing here runs at import time: the CPU tests import every module on
machines without nvcc.  A missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_functions = {}
#: seconds the last build in this process took (None: loaded as built)
build_seconds = None
#: nvcc's output of the last build (ptxas registers, shared memory, spills)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                           "CUDA kernels are built from source at first use")
    return str(path)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless this exact build exists."""
    global build_seconds, build_log
    lib = _library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = lib.stem
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}_{src.stem}.o"
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode:
            failed.append(obj.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (grid sizing)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ptr(t):
    """A tensor's device address for a c_void_p argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def function(name: str, argtypes: list):
    """The C entry point `name` of the built library, typed (returns int)."""
    global _lib
    if name not in _functions:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]
