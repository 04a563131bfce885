"""Device residency cache: hot table columns pinned in device memory.

Counterpart of `galaxysql_tpu/exec/device_cache.py`.  Whole column lanes live on the
instance's device keyed by (table, partition set, column, table-version, length): a
version bump invalidates, eviction is LRU by byte budget, and a cache hit skips the
O(table) host materialization.  Scans then read device memory instead of shipping
lanes over PCIe per query.

Concurrent misses on one key are single-flighted, as in the reference: the first
thread runs the builder and the transfer, the others wait on a per-key event and
take its entry; a failed build frees the claim for the next waiter.  A table that
leaves for good (DROP without the recycle bin, PURGE, DROP DATABASE, DROP INDEX of a
GSI) drops its entries at once (`evict_store`) instead of waiting for LRU eviction.  Every miss
adds its bytes and one transfer to `TRANSFER_STATS` (EXPLAIN ANALYZE's
`-- transfer:` line) and, inside a traced query, an `h2d:<column>` transfer event
with its bytes under the operator span doing the pull.

`bind_metrics` surfaces the reference's `device_cache_hits`, `_misses`, `_bytes` and
`_entries` gauges through an instance's registry (SHOW METRICS,
`information_schema.metrics`, the web console's `/metrics`).  As in the reference, a
build or a clear pushes the gauges and a hit refreshes them every 64th hit.  The
port's cache belongs to one instance, where the reference's is process-wide, so
the gauges count this instance's lanes only.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Dict, Tuple

import torch

from galaxysql_tpu_torch.chunk.batch import as_tensor
from galaxysql_tpu_torch.utils import tracing

Key = Tuple[int, Any, str, int, int]  # (store.uid, partitions, column, version, length)

# host->device transfer accounting: every cache miss ships one lane to the device
TRANSFER_STATS = {"bytes": 0, "transfers": 0}


def hbm_high_water(device) -> Dict[str, int]:
    """Peak allocated device memory (bytes) of a CUDA device; empty on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {str(device): int(torch.cuda.max_memory_allocated(device))}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCache:
    def __init__(self, device, budget_bytes: int = 8 << 30):
        self.device = torch.device(device)
        self.budget = budget_bytes
        self._map: "collections.OrderedDict[Key, Any]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._building: Dict[Key, threading.Event] = {}
        # weakly held registries: a dead instance's registry is not pinned
        self._metrics_refs: list = []
        self.hits = 0
        self.misses = 0

    def bind_metrics(self, registry):
        """Surface hits, misses, bytes and entries through a typed
        `MetricsRegistry` as the `device_cache_*` gauges."""
        if not any(r() is registry for r in self._metrics_refs):
            self._metrics_refs.append(weakref.ref(registry))
        self._push_metrics()

    def _push_metrics(self):
        if not self._metrics_refs:
            return
        live = []
        for r in self._metrics_refs:
            m = r()
            if m is None:
                continue
            live.append(r)
            m.gauge("device_cache_hits", "device lane cache hits").set(self.hits)
            m.gauge("device_cache_misses", "device lane cache misses").set(self.misses)
            m.gauge("device_cache_bytes",
                    "device lane cache resident bytes").set(self._bytes)
            m.gauge("device_cache_entries",
                    "device lane cache entries").set(len(self._map))
        self._metrics_refs = live

    def _lookup_or_claim(self, key: Key):
        """(value, None) on a hit, (None, event) when this thread owns the build.
        Waiters block on the owner's event and look again: either the entry landed
        (a hit) or the owner failed (the waiter claims the build)."""
        while True:
            with self._lock:
                got = self._map.get(key)
                if got is not None:
                    self._map.move_to_end(key)
                    self.hits += 1
                    return got, None
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    return None, ev
            ev.wait()

    def get_lane_built(self, store, pid, column: str, version: int, length: int,
                       builder) -> torch.Tensor:
        """Device lane for the key, building the host array lazily on a miss;
        concurrent misses on one key run the builder once."""
        key = (store.uid, pid, column, version, length)
        got, ev = self._lookup_or_claim(key)
        if ev is None:
            # the scan's hot path: refresh the gauges every 64th hit only (builds
            # and clears always push), as the reference does
            if self.hits % 64 == 1:
                self._push_metrics()
            return got
        try:
            dev = as_tensor(builder(), self.device)
            nbytes = _nbytes(dev)
            tc = tracing.current()
            if tc is not None:
                tc.event(f"h2d:{column}", kind="transfer", bytes=nbytes)
            with self._lock:
                TRANSFER_STATS["bytes"] += nbytes
                TRANSFER_STATS["transfers"] += 1
                self.misses += 1
                # only the claim's owner inserts its key, so no entry is replaced
                # and no lane's bytes are counted twice
                self._map[key] = dev
                self._bytes += nbytes
                while self._bytes > self.budget and len(self._map) > 1:
                    _, old = self._map.popitem(last=False)
                    self._bytes -= _nbytes(old)
        finally:
            with self._lock:
                self._building.pop(key, None)
            ev.set()
        self._push_metrics()
        return dev

    @property
    def nbytes(self) -> int:
        return self._bytes

    def evict_store(self, uid: int) -> int:
        """Drop every entry of the store `uid` (a table that left for good);
        returns the bytes freed."""
        freed = 0
        with self._lock:
            for key in [k for k in self._map if k[0] == uid]:
                freed += _nbytes(self._map.pop(key))
            self._bytes -= freed
        self._push_metrics()
        return freed

    def clear(self):
        with self._lock:
            self._map.clear()
            self._bytes = 0
        self._push_metrics()
