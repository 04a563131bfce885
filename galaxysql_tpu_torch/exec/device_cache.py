"""Device residency cache: hot table columns pinned in device memory.

Counterpart of `galaxysql_tpu/exec/device_cache.py`.  Whole column lanes live on the
instance's device keyed by (table, partition set, column, table-version, length): a
version bump invalidates, eviction is LRU by byte budget, and a cache hit skips the
O(table) host materialization.  Scans then read device memory instead of shipping
lanes over PCIe per query.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Tuple

import torch

from galaxysql_tpu_torch.chunk.batch import as_tensor

Key = Tuple[int, Any, str, int, int]  # (store.uid, partitions, column, version, length)


def hbm_high_water(device) -> Dict[str, int]:
    """Peak allocated device memory (bytes) of a CUDA device; empty on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {str(device): int(torch.cuda.max_memory_allocated(device))}


class DeviceCache:
    def __init__(self, device, budget_bytes: int = 8 << 30):
        self.device = torch.device(device)
        self.budget = budget_bytes
        self._map: "collections.OrderedDict[Key, Any]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_lane_built(self, store, pid, column: str, version: int, length: int,
                       builder) -> torch.Tensor:
        """Device lane for the key, building the host array lazily on a miss."""
        key = (store.uid, pid, column, version, length)
        with self._lock:
            got = self._map.get(key)
            if got is not None:
                self._map.move_to_end(key)
                self.hits += 1
                return got
        dev = as_tensor(builder(), self.device)
        nbytes = dev.numel() * dev.element_size()
        with self._lock:
            self.misses += 1
            self._map[key] = dev
            self._bytes += nbytes
            while self._bytes > self.budget and len(self._map) > 1:
                _, old = self._map.popitem(last=False)
                self._bytes -= old.numel() * old.element_size()
        return dev

    @property
    def nbytes(self) -> int:
        return self._bytes

    def clear(self):
        with self._lock:
            self._map.clear()
            self._bytes = 0
