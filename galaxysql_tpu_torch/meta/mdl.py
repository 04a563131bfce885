"""Metadata locks (MDL): per-table reader/writer locks guarding DDL cutover.

Reference analog: the per-CN metadata lock manager (`executor/mdl/MdlManager.java:35`,
SURVEY.md §2.6) — in-flight queries and DML hold a SHARED lock on every table they
touch for the statement's duration; a DDL that swaps table metadata (repartition
cutover, schema change) takes the EXCLUSIVE lock, which waits for open readers and
blocks new ones.  Writer-preference: once an exclusive request is queued, new shared
requests wait, so DDL cannot starve behind a stream of queries.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterable, Optional

from galaxysql_tpu_torch.utils import errors


class _TableLock:
    __slots__ = ("cond", "readers", "writer", "writers_waiting")

    def __init__(self):
        self.cond = threading.Condition()
        self.readers = 0
        self.writer = False
        self.writers_waiting = 0


class MdlManager:
    def __init__(self):
        self._locks: Dict[str, _TableLock] = {}
        self._mu = threading.Lock()

    def _lock(self, key: str) -> _TableLock:
        with self._mu:
            l = self._locks.get(key)
            if l is None:
                l = _TableLock()
                self._locks[key] = l
            return l

    def acquire_shared(self, key: str, timeout: Optional[float] = None) -> bool:
        l = self._lock(key)
        with l.cond:
            ok = l.cond.wait_for(
                lambda: not l.writer and l.writers_waiting == 0, timeout)
            if not ok:
                return False
            l.readers += 1
            return True

    def release_shared(self, key: str):
        l = self._lock(key)
        with l.cond:
            l.readers -= 1
            if l.readers == 0:
                l.cond.notify_all()

    def acquire_exclusive(self, key: str, timeout: Optional[float] = None) -> bool:
        l = self._lock(key)
        with l.cond:
            l.writers_waiting += 1
            try:
                ok = l.cond.wait_for(
                    lambda: not l.writer and l.readers == 0, timeout)
                if not ok:
                    return False
                l.writer = True
                return True
            finally:
                l.writers_waiting -= 1

    def release_exclusive(self, key: str):
        l = self._lock(key)
        with l.cond:
            l.writer = False
            l.cond.notify_all()

    @contextmanager
    def shared(self, keys: Iterable[str], timeout: Optional[float] = 30.0):
        """Statement-scope shared locks over every touched table (sorted to keep
        acquisition order deadlock-free)."""
        acquired = []
        try:
            for k in sorted(set(keys)):
                if not self.acquire_shared(k, timeout):
                    raise errors.TddlError(
                        f"MDL wait timeout on '{k}' (DDL in progress)")
                acquired.append(k)
            yield
        finally:
            for k in acquired:
                self.release_shared(k)

    @contextmanager
    def exclusive(self, key: str, timeout: Optional[float] = 30.0):
        if not self.acquire_exclusive(key, timeout):
            raise errors.TddlError(
                f"MDL exclusive wait timeout on '{key}' (queries still open)")
        try:
            yield
        finally:
            self.release_exclusive(key)
