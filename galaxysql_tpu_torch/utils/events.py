"""Instance event journal: a bounded ring of typed infrastructure events.

Reference analog: SURVEY.md §L2 manager surfaces — the reference scatters
"something happened" signals (DDL runs, breaker trips, failovers, cache heals)
across counters and log lines; this journal gives them one typed home so
`SHOW EVENTS`, `information_schema.events`, the web console, and Prometheus
all render the same stream.  The plan-regression sentinel
(meta/statement_summary.py) publishes here too.

Process-shared like SLOW_LOG and the fault-tolerance counters: most publishers
(WorkerClient breakers, skew activation checks, remote-scan failover) have no
Instance handle.  Each event carries the publishing node id when known.

Everything is host-side appends under one lock — nothing here may touch
device state (publishers sit on query hot paths)."""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

# Known kinds (open set — publishers may mint new ones; these are the ones
# wired today).  severity defaults: warn for failure-shaped kinds, info else.
KINDS = (
    "ddl", "breaker_open", "breaker_close", "worker_failover",
    "sync_failure", "sync_heal", "skew_activate", "skew_deactivate",
    "batch_fallback", "plan_regression",
    # self-heal loop (plan/spm.py quarantine machine, driven by the
    # statement-summary sentinel): quarantine opened with a rollback pin /
    # targeted statistics repair, probation verdicts
    "plan_rollback", "stats_repair", "plan_promoted", "plan_heal_failed",
    # resource-governance plane (server/admission.py, utils/ccl.py,
    # net/dn.py retry budgets): overload sheds, CCL rejects/queue-fulls,
    # memory-pressure tier transitions, exhausted retry budgets
    "admission_reject", "ccl_reject", "mem_pressure",
    "retry_budget_exhausted",
    # SLO plane (server/slo.py): burn-rate transitions over the metric
    # history + robust-EWMA counter-rate anomalies (retrace storms,
    # breaker flaps, shed spikes) — detection only, never fails a query
    "slo_burn", "slo_recovered", "metric_anomaly",
    # serving tier (server/router.py): peer coordinators joining/leaving the
    # front router's ring — a leave also fires when failover evicts a dead
    # peer mid-statement
    "coordinator_joined", "coordinator_left",
)

_WARN_KINDS = frozenset({
    "breaker_open", "worker_failover", "sync_failure", "batch_fallback",
    "plan_regression", "plan_rollback", "plan_heal_failed",
    "admission_reject", "ccl_reject", "retry_budget_exhausted",
    "slo_burn", "metric_anomaly", "coordinator_left",
})


@dataclasses.dataclass
class InstanceEvent:
    seq: int
    at: float                  # wall-clock seconds
    kind: str
    severity: str              # info | warn
    node: str                  # publishing node id ("" when unknown)
    detail: str                # one human line
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # correlation keys: link this event to a retained trace
    # (utils/tracing.TraceStore) and/or a statement-summary digest so SHOW
    # EVENTS rows and incident bundles jump straight to their evidence.
    # Lifted out of **attrs by publish(); 0/"" = uncorrelated.
    trace_id: int = 0
    digest: str = ""


class EventJournal:
    """Bounded ring of InstanceEvents + lifetime per-kind counters.

    The counters outlive ring eviction (Prometheus sees totals, the ring shows
    the recent tail) — same split as SLOW_LOG vs slow_queries."""

    def __init__(self, capacity: int = 512):
        self._ring: Deque[InstanceEvent] = collections.deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._deduped: set = set()

    def publish(self, kind: str, detail: str = "", severity: str = "",
                node: str = "", dedupe: Optional[str] = None,
                **attrs) -> InstanceEvent:
        """Append an event.  `dedupe`: for per-execution publishers (skew
        activation fires on EVERY hybrid join) — the kind counter always
        bumps, but only the FIRST occurrence of a dedupe key lands in the
        ring, so a steady hot workload cannot evict the rare breaker/
        failover/regression events the journal exists to retain."""
        trace_id = attrs.pop("trace_id", 0)
        digest = attrs.pop("digest", "")
        try:
            trace_id = int(trace_id or 0)
        except (TypeError, ValueError):
            trace_id = 0
        ev = InstanceEvent(next(self._seq), time.time(), kind,
                           severity or ("warn" if kind in _WARN_KINDS
                                        else "info"),
                           node, detail[:512], attrs,
                           trace_id=trace_id, digest=str(digest or ""))
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if dedupe is not None:
                if dedupe in self._deduped:
                    return ev
                if len(self._deduped) > 4096:
                    self._deduped.clear()  # epoch reset, bounded
                self._deduped.add(dedupe)
            self._ring.append(ev)
        return ev

    def entries(self, kind: Optional[str] = None,
                severity: Optional[str] = None,
                kind_like: Optional[str] = None) -> List[InstanceEvent]:
        """Recent tail, optionally filtered: exact `kind`, exact
        `severity` (info|warn|critical), and/or `kind_like` — a SQL LIKE
        pattern over the kind (SHOW EVENTS ... LIKE 'slo%' triage)."""
        with self._lock:
            evs = list(self._ring)
        if kind:
            evs = [e for e in evs if e.kind == kind]
        if severity:
            evs = [e for e in evs if e.severity == severity.lower()]
        if kind_like:
            import fnmatch
            pat = kind_like.lower().replace("%", "*").replace("_", "?")
            evs = [e for e in evs if fnmatch.fnmatchcase(e.kind, pat)]
        return evs

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._deduped.clear()


EVENTS = EventJournal()


def publish(kind: str, detail: str = "", **kw) -> InstanceEvent:
    """Module-level convenience over the process journal."""
    return EVENTS.publish(kind, detail, **kw)
