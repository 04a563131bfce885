"""CUDA kernels of the CSR hash join, with their plain PyTorch versions.

Ports of `galaxysql_tpu/kernels/pallas_join.py`:

- `build_slots` (Pallas `build_slots`, `_make_slots_kernel(masked=True)`): build-row
  slot ids `hash_columns(keys) & (M-1)`, dead rows parked at slot M.
- `hash_slots` (Pallas `hash_slots`, masked=False): the same mix for probe rows.
- `expand_offsets` (Pallas `expand_offsets`, `_make_expand_kernel`): the probe->pair
  owner map.  The plain version is the reference's scatter-max at segment starts
  followed by a running max; the kernel is one launch that writes every pair slot
  once (a load-balanced segment fill), which needs `starts` to be the exclusive
  prefix sum of `counts`, as `relational.hash_join_probe_csr` builds it.

All three are memory-bound (see `csrc/join_slots.cu`, `csrc/expand_offsets.cu`).
Each wrapper takes the tensors' device as the route: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version beside it.  `LAUNCHES`
counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Sequence, Tuple

import torch

from galaxysql_tpu_torch.kernels import cuda_build as cb
from galaxysql_tpu_torch.kernels.hashing import hash_columns

MAX_KEY_LANES = 8
LAUNCHES = {"build_slots": 0, "hash_slots": 0, "expand_offsets": 0}

_INT_LANES = (torch.int8, torch.int16, torch.uint8, torch.bool)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions -------------------------------------------------------------

def build_slots_plain(keys: Sequence[Tuple[Any, Optional[Any]]], live, M: int):
    s = (hash_columns(keys) & (M - 1)).to(torch.int32)
    return torch.where(live, s, torch.full_like(s, M))


def hash_slots_plain(keys: Sequence[Tuple[Any, Optional[Any]]], M: int):
    return (hash_columns(keys) & (M - 1)).to(torch.int32)


def expand_offsets_plain(counts, starts, cap: int):
    """The reference's general formulation: a scatter-max of row ids at segment starts,
    then a running max.  It takes any `starts` unique among non-empty rows; the kernel
    behind `expand_offsets` agrees with it only when `starts` is the exclusive prefix
    sum of `counts`, the one form its call site passes."""
    npr = counts.shape[0]
    at = torch.where((counts > 0) & (starts < cap), starts, torch.full_like(starts, cap))
    p_of = torch.zeros(cap + 1, dtype=torch.int32, device=counts.device)
    p_of.scatter_reduce_(0, at, torch.arange(npr, dtype=torch.int32, device=counts.device),
                         reduce="amax", include_self=True)
    return torch.cummax(p_of[:cap], 0).values


# -- kernel plumbing --------------------------------------------------------------

def key_lane_args(keys: Sequence[Tuple[Any, Optional[Any]]], n: int, device):
    """ctypes pointer arrays for up to 8 (data, valid) lanes on `device`.  Narrow
    integer and bool lanes widen to int32 (the same sign/zero extension the uint64
    cast applies); float lanes are not key lanes of this kernel.  Returns the
    arrays and the tensors they point into (kept alive by the caller)."""
    if not 1 <= len(keys) <= MAX_KEY_LANES:
        raise ValueError(f"{len(keys)} key lanes: the kernel takes 1 to {MAX_KEY_LANES}")
    data = (ctypes.c_void_p * MAX_KEY_LANES)()
    valid = (ctypes.c_void_p * MAX_KEY_LANES)()
    wide = (ctypes.c_int * MAX_KEY_LANES)()
    hold = []
    for j, (d, v) in enumerate(keys):
        check_lane(d, n, device, "key lane")
        if d.dtype in _INT_LANES:
            d = d.to(torch.int32)
        elif d.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"key lane dtype {d.dtype} is not an integer lane")
        data[j] = d.data_ptr()
        wide[j] = 1 if d.dtype == torch.int64 else 0
        hold.append(d)
        if v is not None:
            check_lane(v, n, device, "valid lane", torch.bool)
            valid[j] = v.data_ptr()
            hold.append(v)
    return data, valid, wide, hold


def check_lane(t, n: int, device, what: str, dtype=None):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{what} must be a tensor on {device}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what} must have shape ({n},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


_VP = ctypes.c_void_p
_SLOTS_ARGS = (ctypes.c_int, _VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_longlong,
               ctypes.c_longlong, _VP)
_EXPAND_ARGS = (ctypes.c_int, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_longlong, _VP)


def _slots_kernel(keys, live, M: int, name: str):
    device = keys[0][0].device
    n = int(keys[0][0].shape[0])
    if not 1 <= M <= (1 << 30):
        raise ValueError(f"slot count {M} out of range")
    data, valid, wide, hold = key_lane_args(keys, n, device)
    if live is not None:
        check_lane(live, n, device, "live lane", torch.bool)
    out = torch.empty(n, dtype=torch.int32, device=device)
    rc = cb.function("join_slots.cu", "gx_join_slots", _SLOTS_ARGS)(
        cb.device_index(out), ctypes.cast(data, _VP), ctypes.cast(valid, _VP),
        ctypes.cast(wide, _VP), len(keys), cb.ptr(live), cb.ptr(out), n, M,
        cb.stream_of(out))
    cb.check(rc, name)
    LAUNCHES[name] += 1
    return out


# -- wrappers -----------------------------------------------------------------------

def build_slots(keys: Sequence[Tuple[Any, Optional[Any]]], live, M: int):
    """Build-side slot vector: `(hash_columns(keys) & (M-1))`, dead rows -> M.
    `live` is the build rows' effective live mask (live and no NULL key)."""
    if not keys[0][0].is_cuda:
        return build_slots_plain(keys, live, M)
    return _slots_kernel(keys, live, M, "build_slots")


def hash_slots(keys: Sequence[Tuple[Any, Optional[Any]]], M: int):
    """Probe-side slot vector (no live mask): `hash_columns(keys) & (M-1)`."""
    if not keys[0][0].is_cuda:
        return hash_slots_plain(keys, M)
    return _slots_kernel(keys, None, M, "hash_slots")


def expand_offsets(counts, starts, cap: int):
    """Probe->pair owner map: for pair slot j, the probe row whose
    [start, start+count) segment covers j (int32[cap]); slots past the last segment
    take the last non-empty row (0 if none).

    Precondition of the kernel: `starts` is the exclusive prefix sum of `counts`
    (`starts[0] == 0`, `starts[i+1] == starts[i] + counts[i]`), which the only call
    site, `relational.hash_join_probe_csr`, guarantees.  The plain version takes any
    starts unique among non-empty rows."""
    if not counts.is_cuda:
        return expand_offsets_plain(counts, starts, cap)
    device = counts.device
    npr = int(counts.shape[0])
    check_lane(counts, npr, device, "counts", torch.int64)
    check_lane(starts, npr, device, "starts", torch.int64)
    if cap < 0:
        raise ValueError("negative pair capacity")
    p_of = torch.empty(cap, dtype=torch.int32, device=device)
    rc = cb.function("expand_offsets.cu", "gx_expand_offsets", _EXPAND_ARGS)(
        cb.device_index(p_of), cb.ptr(counts), cb.ptr(starts), cb.ptr(p_of), npr, cap,
        cb.stream_of(p_of))
    cb.check(rc, "expand_offsets")
    LAUNCHES["expand_offsets"] += 1
    return p_of
