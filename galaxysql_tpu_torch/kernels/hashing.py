"""The key hash every join and group-by formulation shares, in int64 torch ops.

The reference hashes in uint64 (`galaxysql_tpu/kernels/relational.py` `hash_columns`:
SplitMix64 per key lane, a NULL tag, and the combine `mix(h*31 + lane + GOLDEN)`).
torch has no `>>` or `+` for uint64, so the lanes here are int64 holding the same
bits: multiply and add wrap identically, and a logical right shift is an arithmetic
shift with the sign-extended high bits masked off.  The CUDA kernels compute the same
mix in native uint64 and must agree with this module bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch


def _signed(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


M1 = 0xff51afd7ed558ccd
M2 = 0xc4ceb9fe1a85ec53
GOLDEN = 0x9e3779b97f4a7c15
NULL_TAG = 0xDEADBEEFCAFEBABE

_M1 = _signed(M1)
_M2 = _signed(M2)
_GOLDEN = _signed(GOLDEN)
_NULL_TAG = _signed(NULL_TAG)


def lsr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def as_u64_bits(data: torch.Tensor) -> torch.Tensor:
    """`data.astype(uint64)` of the reference, as int64 bits: integer lanes
    sign-extend (the uint64 cast of a negative int32 is its sign-extended bits)."""
    if data.dtype == torch.int64:
        return data
    return data.to(torch.int64)


def _mix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ lsr(h, 33)
    h = h * _M1
    h = h ^ lsr(h, 33)
    h = h * _M2
    h = h ^ lsr(h, 33)
    return h


def hash_columns(cols: Sequence[Tuple[Any, Optional[Any]]]) -> torch.Tensor:
    """Combine key columns (data, valid) into one hash lane (int64 holding the
    reference's uint64 bits).  NULL contributes a distinct tag."""
    h = None
    for data, valid in cols:
        lane = _mix64(as_u64_bits(data))
        if valid is not None:
            lane = torch.where(valid, lane, torch.full_like(lane, _NULL_TAG))
        h = lane if h is None else _mix64(h * 31 + lane + _GOLDEN)
    assert h is not None
    return h
