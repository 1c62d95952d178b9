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
_tickets = {}
#: seconds the last build in this process took (None: loaded as built)
build_seconds = None
#: seconds each source's nvcc took in that build, by file name
build_seconds_by_file = {}
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
    global build_seconds, build_log, build_seconds_by_file
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
        log = obj.with_suffix(".log")
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        with open(log, "w") as out:
            jobs.append((src.name, obj, log, subprocess.Popen(cmd, stdout=out,
                                                              stderr=subprocess.STDOUT)))
    seconds = {}
    while len(seconds) < len(jobs):
        for name, _, _, proc in jobs:
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.1)
    logs = [log.read_text() for _, _, log, _ in jobs]
    failed = [obj.name for _, obj, _, proc in jobs if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_seconds_by_file = seconds
    build_log = "\n".join(logs)
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (grid sizing)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tickets(device, n: int) -> torch.Tensor:
    """At least n int32 tickets on `device`, zero: one persistent buffer a
    device for the kernels whose last block combines the others' partials
    (csrc/attention_splitkv.cu, csrc/bgemv.cu).  Each launch leaves every
    ticket it takes at zero again, and launches on one stream run in order,
    so the kernels share it."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = _tickets[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


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
