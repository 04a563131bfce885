"""User-level named locks: GET_LOCK / RELEASE_LOCK / IS_FREE_LOCK / IS_USED_LOCK.

Reference analog: `polardbx-common/.../common/lock/LockingFunctionManager.java` —
cross-session advisory locks with MySQL semantics: re-entrant for the owning
session, blocking acquire with timeout, auto-released when the session closes.
The reference persists them in the metadb so they span CNs; this engine's
single-process collapse makes the instance-scoped table the same thing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class _Lock:
    __slots__ = ("owner", "count", "cond")

    def __init__(self):
        self.owner: Optional[int] = None
        self.count = 0
        self.cond = threading.Condition()


class LockingFunctionManager:
    def __init__(self):
        self._locks: Dict[str, _Lock] = {}
        self._mu = threading.Lock()

    def _lock(self, name: str) -> _Lock:
        with self._mu:
            l = self._locks.get(name)
            if l is None:
                l = _Lock()
                self._locks[name] = l
            return l

    def get_lock(self, name: str, timeout: float, conn_id: int) -> int:
        """1 = acquired, 0 = timeout (MySQL GET_LOCK).  Re-entrant per session."""
        l = self._lock(name)
        with l.cond:
            if l.owner == conn_id:
                l.count += 1
                return 1
            ok = l.cond.wait_for(lambda: l.owner is None,
                                 timeout if timeout >= 0 else None)
            if not ok:
                return 0
            l.owner = conn_id
            l.count = 1
            return 1

    def release_lock(self, name: str, conn_id: int) -> Optional[int]:
        """1 = released, 0 = held by another session, NULL = not held at all."""
        with self._mu:
            l = self._locks.get(name)
        if l is None:
            return None
        with l.cond:
            if l.owner is None:
                return None
            if l.owner != conn_id:
                return 0
            l.count -= 1
            if l.count == 0:
                l.owner = None
                l.cond.notify_all()
            return 1

    def is_free_lock(self, name: str) -> int:
        with self._mu:
            l = self._locks.get(name)
        if l is None:
            return 1
        with l.cond:
            return 1 if l.owner is None else 0

    def is_used_lock(self, name: str) -> Optional[int]:
        """Owning connection id, or NULL when free (MySQL IS_USED_LOCK)."""
        with self._mu:
            l = self._locks.get(name)
        if l is None:
            return None
        with l.cond:
            return l.owner

    def release_all(self, conn_id: int):
        """Session close: drop every lock the connection still holds."""
        with self._mu:
            locks = list(self._locks.values())
        for l in locks:
            with l.cond:
                if l.owner == conn_id:
                    l.owner = None
                    l.count = 0
                    l.cond.notify_all()
