"""Hash partitioning of lane values (numpy).

The port's own copy of the JAX package's native `hash_partition` (its numpy
form): SplitMix64 of the int64 lane, modulo the partition count.  Row routing
must agree with the reference bit for bit, so a table loaded into either engine
lands in the same partitions.
"""

from __future__ import annotations

import numpy as np


def hash_partition(keys: np.ndarray, nparts: int) -> np.ndarray:
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    with np.errstate(over="ignore"):
        h = keys.astype(np.uint64)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xc4ceb9fe1a85ec53)
        h ^= h >> np.uint64(33)
    return (h % np.uint64(nparts)).astype(np.int32)
