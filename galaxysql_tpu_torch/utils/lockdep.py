"""Runtime lock-order witness (lockdep): catches POTENTIAL deadlocks.

Reference analog: the Linux kernel's lockdep validator — instead of waiting for
an interleaving that actually deadlocks, record every held->acquired edge
between lock CLASSES per thread and fail loudly the moment the acquisition
graph grows a cycle.  A test run that merely *touches* both orders of a pair
of locks proves the inversion, even if the threads never actually collide —
which is exactly what the chaos/dml/batch smoke suites do all day.

Disarmed (the default), `named_lock()` returns a plain `threading.Lock`/
`RLock` — zero wrapper, zero overhead, nothing on the hot path.  Armed via
`GALAXYSQL_LOCKDEP=1` in the environment (read at import) or `enable()`
(affects locks created afterwards — tests call it before building their
Instance), every named lock is wrapped in a `_DepLock` that reports each
acquisition to the process-wide `WITNESS` before blocking on the real lock.

Lock classes wired today (the canonical order, outermost first):

    append_lock  -> partition -> metadb
    instance     (coarse instance/DDL lock; unordered vs the chain above
                  until an edge proves otherwise)

The witness is ORDER-AGNOSTIC: it learns edges from execution and only fails
on a cycle, so a new subsystem's locks join the proof without registration.
Violations raise `LockOrderViolation` (an AssertionError: this is test
machinery, not a typed wire error) and are also recorded in
`WITNESS.violations` for harnesses that assert after the fact.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation", "named_lock", "enabled", "enable", "disable",
    "WITNESS",
]


class LockOrderViolation(AssertionError):
    """A lock acquisition completed a cycle in the held->acquired graph
    (or two locks of the same unordered class were held together)."""


_enabled = os.environ.get("GALAXYSQL_LOCKDEP", "") not in ("", "0", "false")


def enabled() -> bool:
    return _enabled


def enable():
    """Arm lockdep for locks created from now on (tests: call before
    building the Instance under test)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


class _Held(threading.local):
    def __init__(self):
        self.stack: List["_DepLock"] = []


class Witness:
    """Process-wide acquisition-order graph over lock class names."""

    def __init__(self):
        self._graph: Dict[str, Set[str]] = {}
        # (a, b) -> one-line provenance of the first time a->b was seen
        self._edges: Dict[Tuple[str, str], str] = {}
        self._lock = threading.Lock()
        self._held = _Held()
        self.violations: List[str] = []

    # -- bookkeeping ---------------------------------------------------------

    def reset(self):
        with self._lock:
            self._graph.clear()
            self._edges.clear()
            self.violations.clear()

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return dict(self._edges)

    def assert_clean(self):
        if self.violations:
            raise LockOrderViolation("; ".join(self.violations))

    # -- the check -----------------------------------------------------------

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS for src ->* dst in the edge graph (caller holds self._lock)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _violate(self, msg: str):
        site = traceback.extract_stack(limit=8)
        # skip lockdep's own frames when naming the acquisition site
        frames = [f for f in site if "lockdep" not in (f.filename or "")]
        where = f" at {frames[-1].filename}:{frames[-1].lineno}" if frames else ""
        full = msg + where
        self.violations.append(full)
        raise LockOrderViolation(full)

    def on_acquire(self, lk: "_DepLock"):
        """Called BEFORE the real acquire: the failing thread does not end up
        holding the inverted lock."""
        held = self._held.stack
        if any(h is lk for h in held):
            return  # re-entrant on the same instance: no new edge
        for h in held:
            if h.dep_name == lk.dep_name:
                self._violate(
                    f"lockdep: two '{lk.dep_name}' locks held by one thread "
                    f"(no intra-class order is declared)")
        with self._lock:
            for h in held:
                a, b = h.dep_name, lk.dep_name
                if b in self._graph.get(a, ()):
                    continue  # known-good edge
                cycle = self._path(b, a)
                if cycle is not None:
                    chain = " -> ".join(cycle + [b])
                    known = self._edges.get((cycle[0], cycle[1]), "")
                    self._violate(
                        f"lockdep: acquiring '{b}' while holding '{a}' "
                        f"inverts the established order ({chain}"
                        f"{'; first seen ' + known if known else ''})")
                self._graph.setdefault(a, set()).add(b)
                caller = traceback.extract_stack(limit=6)
                frames = [f for f in caller
                          if "lockdep" not in (f.filename or "")]
                self._edges[(a, b)] = (
                    f"{frames[-1].filename}:{frames[-1].lineno}"
                    if frames else "?")

    def did_acquire(self, lk: "_DepLock"):
        self._held.stack.append(lk)

    def did_release(self, lk: "_DepLock"):
        stack = self._held.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lk:
                del stack[i]
                return


WITNESS = Witness()


class _DepLock:
    """Thin lock wrapper reporting acquisitions to the witness.

    Supports the `with` protocol plus explicit acquire/release (timeouts
    included) so it drops in for every named-lock use in the engine."""

    __slots__ = ("dep_name", "_real")

    def __init__(self, name: str, reentrant: bool = True):
        self.dep_name = name
        self._real = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        WITNESS.on_acquire(self)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            WITNESS.did_acquire(self)
        return ok

    def release(self):
        self._real.release()
        WITNESS.did_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<DepLock {self.dep_name}>"


def named_lock(name: str, reentrant: bool = True):
    """The one constructor for the engine's named locks.

    Disarmed (default): a plain threading primitive — identical hot-path cost
    to before lockdep existed.  Armed: a witness-wrapped lock whose every
    acquisition extends the order proof."""
    if not _enabled:
        return threading.RLock() if reentrant else threading.Lock()
    return _DepLock(name, reentrant)
