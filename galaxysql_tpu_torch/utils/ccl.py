"""CCL: SQL concurrency control (admission, queuing, throttling).

Reference analog: `optimizer/ccl` (SURVEY.md §2.5) — rule-matched query queuing with
wait queues and timeouts, integrated at the top of query execution the way
ServerConnection reschedules (`Reschedulable`).  Rules match on keyword substring
and/or user; a matched query must win a slot or wait (bounded queue + timeout).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from galaxysql_tpu_torch.utils import errors


@dataclasses.dataclass
class CclRule:
    name: str
    max_concurrency: int
    keyword: Optional[str] = None        # match: substring of the SQL (ci)
    user: Optional[str] = None           # match: session user
    wait_queue_size: int = 64
    wait_timeout_ms: int = 10_000

    def matches(self, user: str, sql: str) -> bool:
        if self.user and self.user != user:
            return False
        if self.keyword and self.keyword.lower() not in sql.lower():
            return False
        return True


class _RuleState:
    def __init__(self, rule: CclRule):
        self.rule = rule
        self.sem = threading.BoundedSemaphore(rule.max_concurrency)
        self.waiting = 0
        self.running = 0
        self.total_matched = 0
        self.total_rejected = 0
        self.lock = threading.Lock()


class _Admission:
    """Handle returned by admit(); release() frees the slot."""

    def __init__(self, state: Optional[_RuleState]):
        self._state = state
        self._released = False

    def release(self):
        if self._state is not None and not self._released:
            self._released = True
            with self._state.lock:
                self._state.running -= 1
            self._state.sem.release()


_NO_ADMISSION = _Admission(None)


class CclManager:
    def __init__(self):
        self._rules: Dict[str, _RuleState] = {}
        self._lock = threading.Lock()

    def add_rule(self, rule: CclRule):
        with self._lock:
            self._rules[rule.name.lower()] = _RuleState(rule)

    def drop_rule(self, name: str) -> bool:
        with self._lock:
            return self._rules.pop(name.lower(), None) is not None

    def rules(self) -> List[_RuleState]:
        with self._lock:
            return list(self._rules.values())

    def clear(self):
        with self._lock:
            self._rules.clear()

    def admit(self, session, sql: str) -> _Admission:
        """Block (bounded) until the query may run; raise CclRejectError on overflow
        or timeout.  Returns a handle whose release() must be called when done."""
        if not self._rules:
            # rule-free fast path: no lock on the per-query hot path — the
            # batched TP serving loop calls admit() at millions/sec and a
            # contended lock here would serialize the whole admission plane
            # (dict truthiness is a single atomic read; a rule added
            # concurrently applies from the next statement on)
            return _NO_ADMISSION
        with self._lock:
            states = list(self._rules.values())
        for st in states:
            if not st.rule.matches(getattr(session, "user", "root"), sql):
                continue
            with st.lock:
                st.total_matched += 1
            if st.sem.acquire(blocking=False):
                with st.lock:
                    st.running += 1
                return _Admission(st)
            # slot busy: join the bounded wait queue
            with st.lock:
                if st.waiting >= st.rule.wait_queue_size:
                    st.total_rejected += 1
                    self._publish_reject(st, "queue_full")
                    raise errors.CclRejectError(
                        f"CCL rule '{st.rule.name}': wait queue full")
                st.waiting += 1
            ok = st.sem.acquire(timeout=st.rule.wait_timeout_ms / 1000.0)
            with st.lock:
                st.waiting -= 1
                if not ok:
                    st.total_rejected += 1
                else:
                    st.running += 1
            if not ok:
                self._publish_reject(st, "wait_timeout")
                raise errors.CclRejectError(
                    f"CCL rule '{st.rule.name}': wait timeout")
            return _Admission(st)
        return _NO_ADMISSION

    @staticmethod
    def _publish_reject(st: _RuleState, reason: str):
        """CCL rejects land in the typed event journal (deduped per
        rule x reason so a flood cannot evict rarer events)."""
        from galaxysql_tpu_torch.utils import events
        events.publish("ccl_reject",
                       f"CCL rule '{st.rule.name}' rejected a query "
                       f"({reason})",
                       dedupe=f"ccl-{st.rule.name}-{reason}",
                       rule=st.rule.name, reason=reason)


GLOBAL_CCL = CclManager()
