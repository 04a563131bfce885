"""Build and load the hand-written CUDA kernels (`kernels/csrc/*.cu`).

Each source compiles with `nvcc` for `sm_90a` into a shared library with a plain C
interface, loaded with ctypes.  Builds are keyed by a hash of the source and the flags,
into `kernels/_build/` beside this file, and happen at first use: nothing is built or
imported from CUDA when the module is imported.  `build()` compiles every missing
library at once, one `nvcc` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in `sources` that is not built yet; returns
    source -> library path.  Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(paths[s])]
    if not todo:
        return paths
    compiler = nvcc()
    procs = []
    for s in todo:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, s)]
        procs.append((s, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT)))
    failures = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"{s}: nvcc exited {p.returncode}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[s])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all missing ones first."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            paths = build()
            lib = ctypes.CDLL(paths[source])
            _LIBS[source] = lib
    return lib


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
