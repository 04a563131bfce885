"""Timestamp oracle: monotonic TSO for MVCC snapshots and commit ordering.

Reference analog: `ClusterTimestampOracle` fetching `GET_TSO` from GMS (SURVEY.md §3.4).
Same layout as the reference's TSO: physical millis << 22 | logical counter, so
timestamps are globally ordered yet roughly wall-clock-meaningful.  In-process here; the
multi-host deployment fronts this with the gRPC metadata service (meta/gms.py).
"""

from __future__ import annotations

import threading
import time

LOGICAL_BITS = 22


class TimestampOracle:
    def __init__(self):
        self._lock = threading.Lock()
        self._last_physical = 0
        self._logical = 0

    def next_timestamp(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000)
            if phys <= self._last_physical:
                phys = self._last_physical
                self._logical += 1
                if self._logical >= (1 << LOGICAL_BITS):
                    phys += 1
                    self._logical = 0
            else:
                self._logical = 0
            self._last_physical = phys
            return (phys << LOGICAL_BITS) | self._logical

    def observe(self, ts: int):
        """Advance past an externally issued timestamp (a coordinator's commit
        TSO): local snapshots taken after this must order after `ts` even under
        clock skew between hosts."""
        with self._lock:
            phys = ts >> LOGICAL_BITS
            if phys > self._last_physical or (
                    phys == self._last_physical and
                    (ts & ((1 << LOGICAL_BITS) - 1)) > self._logical):
                self._last_physical = phys
                self._logical = ts & ((1 << LOGICAL_BITS) - 1)

    def next_timestamps(self, n: int) -> list:
        """Batched fetch: ONE lock acquisition allocates a contiguous logical
        range (the reference batches waiter requests the same way —
        `ClusterTimestampOracle.java:109-133` drains its taskQueue into one
        grouped GTS fetch; batching is what keeps a remote TSO off the commit
        critical path)."""
        if n <= 0:
            return []
        with self._lock:
            phys = int(time.time() * 1000)
            if phys <= self._last_physical:
                phys = self._last_physical
                base = self._logical + 1
            else:
                self._last_physical = phys
                base = 0
            out = []
            logical = base
            for _ in range(n):
                if logical >= (1 << LOGICAL_BITS):
                    phys += 1
                    self._last_physical = phys
                    logical = 0
                out.append((phys << LOGICAL_BITS) | logical)
                logical += 1
            self._logical = logical - 1
            return out
