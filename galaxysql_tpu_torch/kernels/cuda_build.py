"""Build and load the hand-written CUDA kernels (`kernels/csrc/*.cu`).

Each source compiles with `nvcc` for `sm_90a` into a shared library with a plain C
interface, loaded with ctypes.  Builds are keyed by a hash of the source and the flags,
into `kernels/_build/` beside this file, and happen at first use: nothing is built or
imported from CUDA when the module is imported.  `build()` compiles every missing
library at once, one `nvcc` process per source, all started together.

The same directory caches the C++ host runtime (`galaxysql_tpu_torch/native`):
`build_host` compiles a host source with g++ under the same kind of key, once across
threads and processes.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("join_slots.cu", "expand_offsets.cu", "hash_place.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def _compile_stats() -> dict:
    from galaxysql_tpu_torch.exec.operators import COMPILE_STATS
    return COMPILE_STATS


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in `sources` that is not built yet; returns
    source -> library path.  Raises with nvcc's output when a build fails.
    Each source built counts one `retraces` in `exec/operators.COMPILE_STATS` and
    adds the wall ms from the start of the builds to its nvcc's exit to
    `compile_ms`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(paths[s])]
    if not todo:
        return paths
    compiler = nvcc()
    t0 = time.perf_counter()
    stats = _compile_stats()
    procs = []
    for s in todo:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, s)]
        procs.append((s, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT)))
    failures = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        stats["retraces"] += 1
        stats["compile_ms"] += (time.perf_counter() - t0) * 1000.0
        if p.returncode != 0:
            failures.append(f"{s}: nvcc exited {p.returncode}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[s])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all missing ones first.  A
    library that was on disk before the build counts one `cache_hits`."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            cached = os.path.exists(library_path(source))
            paths = build()
            lib = ctypes.CDLL(paths[source])
            _LIBS[source] = lib
            if cached:
                _compile_stats()["cache_hits"] += 1
    return lib


def host_library_path(source_path: str, compiler: str, flags: Sequence[str]) -> str:
    """Where a host C++ library builds: `BUILD_DIR/<stem>-<key>.so`, the key a hash
    of the source, the flags, the compiler's version and the macros it defines for
    `flags` (so a `-march=native` build made for one CPU is never loaded on
    another)."""
    with open(source_path, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(flags).encode())
    for probe in ([compiler, "--version"],
                  [compiler, *flags, "-dM", "-E", "-x", "c++", "-"]):
        h.update(subprocess.run(probe, input=b"", capture_output=True,
                                timeout=60).stdout)
    stem = os.path.splitext(os.path.basename(source_path))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_host(source_path: str, compiler: str, flags: Sequence[str]) -> str:
    """Build a host C++ source into a shared library unless it is built already;
    returns its path.  An exclusive lock on a file beside the library makes the
    processes that race here build it once; the library appears by an atomic
    rename, so no process ever loads a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = host_library_path(source_path, compiler, flags)
    if os.path.exists(path):
        return path
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run([compiler, *flags, "-o", tmp, source_path], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)
    return path


def function(source: str, name: str, argtypes):
    """A typed ctypes entry point (int return: the CUDA error code)."""
    fn = getattr(library(source), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {rc}")
