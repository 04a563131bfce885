"""The reference's C++ host runtime (`galaxystore.cpp`, a verbatim copy of
`galaxysql_tpu/native/galaxystore.cpp`), bound with ctypes.

The library builds at first use, not at import: the first read of `AVAILABLE` or
the first call below runs `g++ -O3 -march=native -shared -fPIC` into
`kernels/_build/` through the CUDA kernels' build cache (`kernels/cuda_build.
build_host`: keyed by a hash of the source, the flags and the compiler's target
macros; built once across threads and processes; published by an atomic rename).
Where no compiler exists, or the build fails, every function runs its numpy body and
`AVAILABLE` is False, the reference's contract.

The port routes three of the reference's entry points through the library:

- `visible_mask`: MVCC visibility on the host, under the host scan
  (`storage/table_store.TableStore.scan`) and the point gets;
- `hash_partition`: the row router's shard of a key (`meta/catalog.hash_partition_of`);
- `bloom_build`: the runtime bloom filter of the sort-branch hash join, built on the
  host over the live build keys and queried on the device by
  `kernels.relational.bloom_query_device`.

Each has its numpy body beside it (`*_plain`), the reference's fallback, which the
library equals bit for bit.  The reference's native hash join (`join_build`,
`join_probe` and their single-key forms) is not bound: the reference takes it only
on its CPU backend, where the port holds its plain kernels against the reference.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "galaxystore.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_loaded = False
_lock = threading.Lock()
# why the library is not live (the build's or the loader's error), or None
BUILD_ERROR: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None where it cannot be."""
    global _lib, _loaded, AVAILABLE, BUILD_ERROR
    if _loaded:
        return _lib
    with _lock:
        if _loaded:
            return _lib
        lib = None
        compiler = shutil.which("g++")
        if compiler is not None:
            from galaxysql_tpu_torch.kernels import cuda_build
            try:
                lib = ctypes.CDLL(cuda_build.build_host(SOURCE, compiler, FLAGS))
            except (OSError, subprocess.SubprocessError) as e:
                # a failed build leaves the numpy bodies live, as in the reference
                BUILD_ERROR = f"{type(e).__name__}: {e}"
        if lib is not None:
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            st = ctypes.c_size_t
            lib.gx_hash_partition.argtypes = [i64p, i32p, st, ctypes.c_int32]
            lib.gx_hash_partition.restype = None
            lib.gx_visible_mask.argtypes = [i64p, i64p, u8p, st, ctypes.c_int64,
                                            ctypes.c_int64]
            lib.gx_visible_mask.restype = None
            lib.gx_bloom_build.argtypes = [i64p, st, u64p, st]
            lib.gx_bloom_build.restype = None
        _lib = lib
        AVAILABLE = lib is not None
        _loaded = True
        return _lib


def load() -> bool:
    """Build (at the first call of the process) and load the library; whether it
    is live.  `Instance` calls it, so no statement pays the build."""
    return _load() is not None


def __getattr__(name: str):
    # `AVAILABLE` is read lazily: its first read builds and loads the library
    if name == "AVAILABLE":
        _load()
        return globals()["AVAILABLE"]
    raise AttributeError(name)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# -- routed entry points -------------------------------------------------------------

def hash_partition(keys: np.ndarray, nparts: int) -> np.ndarray:
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is not None and keys.size:
        out = np.empty(keys.size, dtype=np.int32)
        lib.gx_hash_partition(_ptr(keys, ctypes.c_int64), _ptr(out, ctypes.c_int32),
                              keys.size, nparts)
        return out
    return hash_partition_plain(keys, nparts)


def visible_mask(begin_ts: np.ndarray, end_ts: np.ndarray, snapshot_ts: Optional[int],
                 txn_id: int = 0) -> np.ndarray:
    """MVCC visibility.  Uncommitted changes carry NEGATIVE timestamps (-txn_id),
    visible only to the owning transaction; commit turns them into TSO values.  A
    None snapshot (the newest committed state) runs the numpy body, as in the
    reference."""
    begin_ts = np.ascontiguousarray(begin_ts, dtype=np.int64)
    end_ts = np.ascontiguousarray(end_ts, dtype=np.int64)
    if begin_ts.shape != end_ts.shape or begin_ts.ndim != 1:
        raise ValueError(f"stamp lanes of shapes {begin_ts.shape} and {end_ts.shape}")
    n = begin_ts.shape[0]
    lib = _load() if n and snapshot_ts is not None else None
    if lib is not None:
        out = np.empty(n, dtype=np.uint8)
        lib.gx_visible_mask(_ptr(begin_ts, ctypes.c_int64), _ptr(end_ts, ctypes.c_int64),
                            _ptr(out, ctypes.c_uint8), n, int(snapshot_ts), int(txn_id))
        return out.view(np.bool_)
    return visible_mask_plain(begin_ts, end_ts, snapshot_ts, txn_id)


def bloom_build(keys: np.ndarray, nwords: int) -> np.ndarray:
    """nwords MUST be a power of two; returns the u64 word array."""
    if nwords <= 0 or nwords & (nwords - 1):
        raise ValueError(f"bloom of {nwords} words: not a power of two")
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is not None and keys.size:
        words = np.zeros(nwords, dtype=np.uint64)
        lib.gx_bloom_build(_ptr(keys, ctypes.c_int64), keys.size,
                           _ptr(words, ctypes.c_uint64), nwords)
        return words
    return bloom_build_plain(keys, nwords)


# -- the numpy bodies (the reference's fallbacks) ------------------------------------

def hash_partition_plain(keys: np.ndarray, nparts: int) -> np.ndarray:
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    with np.errstate(over="ignore"):
        h = keys.astype(np.uint64)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xc4ceb9fe1a85ec53)
        h ^= h >> np.uint64(33)
    return (h % np.uint64(nparts)).astype(np.int32)


def visible_mask_plain(b: np.ndarray, e: np.ndarray, snapshot_ts: Optional[int],
                       txn_id: int = 0) -> np.ndarray:
    if snapshot_ts is None:
        ins = b >= 0
        dele = e != np.iinfo(np.int64).max
    else:
        ins = (b >= 0) & (b <= snapshot_ts)
        dele = (e >= 0) & (e <= snapshot_ts)
    if txn_id:
        ins = ins | (b == -txn_id)
        dele = dele | (e == -txn_id)
    return ins & ~dele


def bloom_build_plain(keys: np.ndarray, nwords: int) -> np.ndarray:
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    words = np.zeros(nwords, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = _mix_np(keys.astype(np.uint64))
    m = np.uint64(nwords - 1)
    w1 = (h >> np.uint64(6)) & m
    w2 = (h >> np.uint64(38)) & m
    np.bitwise_or.at(words, w1.astype(np.int64), np.uint64(1) << (h & np.uint64(63)))
    np.bitwise_or.at(words, w2.astype(np.int64),
                     np.uint64(1) << ((h >> np.uint64(32)) & np.uint64(63)))
    return words


def _mix_np(h):
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xff51afd7ed558ccd)
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xc4ceb9fe1a85ec53)
    h = h ^ (h >> np.uint64(33))
    return h
