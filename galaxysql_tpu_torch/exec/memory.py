"""Hierarchical memory pools + spill hooks.

Reference analog: `optimizer/memory` (SURVEY.md §2.5) — pools global → query →
operator with revoke hooks that trigger spilling (`MemoryRevoker`, §2.6 spill
framework).  Host-side accounting: operators reserve before materializing; a failed
reservation first asks revocable consumers (spillable operators) to release, then
raises.  Device HBM is governed separately by the DeviceCache byte budget.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from galaxysql_tpu_torch.utils import errors


class MemoryLimitExceeded(errors.TddlError):
    errno = 1038  # ER_OUT_OF_SORTMEMORY
    sqlstate = "HY001"


class MemoryPool:
    def __init__(self, name: str, limit: int, parent: Optional["MemoryPool"] = None):
        self.name = name
        self.limit = limit
        self.parent = parent
        self.reserved = 0
        self._lock = threading.Lock()
        self._revokers: List[Callable[[int], int]] = []
        self.children: List["MemoryPool"] = []
        if parent is not None:
            parent.children.append(self)

    def child(self, name: str, limit: Optional[int] = None) -> "MemoryPool":
        return MemoryPool(name, limit if limit is not None else self.limit, self)

    def add_revoker(self, fn: Callable[[int], int]):
        """fn(nbytes) -> bytes actually released (spilled)."""
        with self._lock:
            self._revokers.append(fn)

    def remove_revoker(self, fn):
        with self._lock:
            if fn in self._revokers:
                self._revokers.remove(fn)

    def try_reserve(self, nbytes: int) -> bool:
        with self._lock:
            if self.reserved + nbytes > self.limit:
                return False
            self.reserved += nbytes
        if self.parent is not None:
            if not self.parent.try_reserve(nbytes):
                with self._lock:
                    self.reserved -= nbytes
                return False
        return True

    def reserve(self, nbytes: int):
        """Reserve, revoking (spilling) from registered consumers if needed."""
        if self.try_reserve(nbytes):
            return
        self.revoke(nbytes)
        if not self.try_reserve(nbytes):
            raise MemoryLimitExceeded(
                f"memory pool '{self.name}' exhausted "
                f"({self.reserved + nbytes} > {self.limit} bytes)")

    def revoke(self, nbytes: int) -> int:
        """Ask revocable consumers (bottom-up) to release at least nbytes."""
        released = 0
        for c in list(self.children):
            released += c.revoke(nbytes - released)
            if released >= nbytes:
                return released
        with self._lock:
            revokers = list(self._revokers)
        for fn in revokers:
            released += fn(nbytes - released)
            if released >= nbytes:
                break
        return released

    def release(self, nbytes: int):
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)
        if self.parent is not None:
            self.parent.release(nbytes)

    def close(self):
        self.release(self.reserved)
        if self.parent is not None and self in self.parent.children:
            self.parent.children.remove(self)


GLOBAL_POOL = MemoryPool("global", 16 << 30)


def query_pool(conn_id: int, limit: int = 4 << 30) -> MemoryPool:
    return GLOBAL_POOL.child(f"query-{conn_id}", limit)


class PoolCharge:
    """An operator's running reservation against a per-query pool.

    Pipeline breakers (hash-join build, agg partials, sort slabs) call
    ``to(nbytes)`` as their resident state grows; a failed adjustment means
    the pool hierarchy is exhausted even after asking other consumers to
    revoke — the caller must take its spill path and re-charge at zero.
    ``squeeze`` is the cross-thread revocation flag: a revoker invoked from
    another query's reservation (or the memory governor's CRITICAL
    revoke-largest) cannot safely spill this operator's state mid-batch, so
    it flips the flag and the operator spills at its next batch boundary.

    A None pool (admission disabled, bare operator tests) makes every call a
    no-op — the hot path pays one attribute check."""

    __slots__ = ("pool", "held", "squeeze", "_revoker")

    def __init__(self, pool: Optional[MemoryPool]):
        self.pool = pool
        self.held = 0
        self.squeeze = False
        self._revoker = None
        if pool is not None:
            def _revoke(nbytes, _self=self):
                _self.squeeze = True
                return 0  # advisory: bytes free at the next batch boundary
            self._revoker = _revoke
            pool.add_revoker(_revoke)

    def to(self, nbytes: int) -> bool:
        """Adjust the held reservation to `nbytes`; False = pool exhausted
        (caller spills, then calls to(0))."""
        if self.pool is None:
            return True
        delta = int(nbytes) - self.held
        if delta <= 0:
            if delta:
                self.pool.release(-delta)
                self.held = int(nbytes)
            return True
        if self.pool.try_reserve(delta):
            self.held = int(nbytes)
            return True
        self.pool.revoke(delta)  # ask spillable consumers first
        if self.pool.try_reserve(delta):
            self.held = int(nbytes)
            # the revoke above ran OUR revoker too: with the reservation now
            # holding, that self-inflicted squeeze would only force a
            # pointless spill at the caller's next check
            self.squeeze = False
            return True
        return False

    def close(self):
        if self.pool is None:
            return
        if self.held:
            self.pool.release(self.held)
            self.held = 0
        if self._revoker is not None:
            self.pool.remove_revoker(self._revoker)
            self._revoker = None


def usage_fraction(pool: MemoryPool = GLOBAL_POOL) -> float:
    """Root-pool usage in [0, 1] — the memory governor's pressure input."""
    limit = pool.limit or 1
    return pool.reserved / limit


def largest_query_child(pool: MemoryPool = GLOBAL_POOL):
    """The biggest per-query child pool (revoke target under CRITICAL
    pressure), or None when no query holds revocable memory."""
    best = None
    for c in list(pool.children):
        if not c.name.startswith("query-") or c.reserved <= 0:
            continue
        if best is None or c.reserved > best.reserved:
            best = c
    return best
