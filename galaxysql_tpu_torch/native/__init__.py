"""Host helpers of the storage runtime, as the numpy bodies of the reference's
`galaxysql_tpu/native/__init__.py` (its C++ library is not built for the port: each
function here is the reference's own numpy path, and gives the library's words).

- `bloom_build`: the runtime bloom filter of the sort-branch hash join, built on the
  host over the live build keys and queried on the device by
  `kernels.relational.bloom_query_device`.
"""

from __future__ import annotations

import numpy as np


def bloom_build(keys: np.ndarray, nwords: int) -> np.ndarray:
    """nwords MUST be a power of two; returns the u64 word array."""
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
