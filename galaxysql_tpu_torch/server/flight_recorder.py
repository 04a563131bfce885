"""Incident flight recorder: trigger-driven correlated evidence capture.

The engine *detects* trouble end to end — burn-rate alerts (server/slo.py),
plan-regression sentinels (meta/statement_summary.py), breaker opens
(net/dn.py), shed storms (server/admission.py), columnar tail faults
(storage/columnar.py) — but an event row is a bare fact.  This module turns
the fact into a diagnosis: on every trigger event it snapshots an **incident
bundle** — the implicated digests' tail-retained traces (utils/tracing
.TraceStore) with their phase breakdowns, the matching statement-summary
rows, the metric-history window around the trigger, the admission/memory/
columnar state, and the recent event tail — deduped per episode
(breaker-style cooldown: one bundle per burn, not one per tick) and
persisted to ``data_dir/incidents/`` under a bounded ring.

Surfaces: ``SHOW INCIDENTS [id]``, ``information_schema.incidents``, web
``/incidents[/<id>]`` (the bundle carries its traces in Chrome-trace-graftable
span-dict form, so ``/trace/<id>`` stays Perfetto-linkable).

Discipline: runs only on the slo_tick maintenance path — never on a query
path, never raises (advisory plane, same contract as the SLO engine)."""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from galaxysql_tpu_torch.utils.events import EVENTS

# Trigger kinds captured straight off the journal.  admission_reject is NOT
# here: single rejects are routine backpressure — the recorder watches the
# lifetime counter and fires only on a storm (INCIDENT_REJECT_STORM delta
# per tick).
EVENT_TRIGGERS = frozenset({
    "slo_burn", "plan_regression", "breaker_open",
    "columnar_tail_failed", "metric_anomaly",
})

# metric-history series worth freezing into a bundle (substring match) —
# the latency/burn/shed families plus whatever metric the trigger names.
_WINDOW_HINTS = ("latency", "queries_total", "query_errors", "admission_",
                 "slow_queries", "columnar_lag", "breaker")
_WINDOW_SAMPLES = 24          # history points per frozen series
_WINDOW_SERIES_CAP = 16       # series per bundle
_EVENT_TAIL = 32              # journal entries per bundle
_TRACES_PER_DIGEST = 3
_SUMMARY_ROWS_CAP = 32


@dataclasses.dataclass
class IncidentBundle:
    """One captured incident: trigger identity + frozen evidence."""

    incident_id: str
    at: float
    kind: str                 # trigger event kind (admission_reject = storm)
    severity: str
    episode: str              # dedupe key (kind + correlation)
    detail: str
    node: str
    digests: List[str] = dataclasses.field(default_factory=list)
    trace_ids: List[int] = dataclasses.field(default_factory=list)
    traces: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    summary_rows: List[list] = dataclasses.field(default_factory=list)
    metric_window: Dict[str, List] = dataclasses.field(default_factory=dict)
    admission: List[list] = dataclasses.field(default_factory=list)
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Per-instance recorder ticked from ``Instance.slo_tick``."""

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._ring: "collections.deque[IncidentBundle]" = \
            collections.deque(maxlen=256)
        self._seq = itertools.count(1)
        self._last_seq = 0            # journal high-water at last tick
        self._reject_base: Optional[int] = None
        self._episodes: Dict[str, float] = {}   # episode key -> last capture
        self.captured = 0
        self.suppressed = 0
        # the recorder is advisory and must never break serving, but its own
        # faults must not vanish either: every best-effort handler logs here
        self.faults = 0
        self.last_fault = ""

    def _note_fault(self, where: str, e: BaseException):
        self.faults += 1
        self.last_fault = f"{where}: {type(e).__name__}: {e}"[:256]

    # -- config ----------------------------------------------------------------

    def _cfg(self, name, default):
        try:
            v = self.instance.config.get(name)
            return default if v is None else v
        except Exception as e:
            self._note_fault("cfg", e)
            return default

    def enabled(self) -> bool:
        return bool(self._cfg("ENABLE_FLIGHT_RECORDER", True))

    def _dir(self) -> Optional[str]:
        d = getattr(self.instance, "data_dir", None)
        if not d:
            return None
        return os.path.join(d, "incidents")

    # -- tick ------------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """Scan the journal since the last tick; capture one bundle per new
        trigger episode.  Advisory: never raises."""
        try:
            return self._tick(now=now)
        except Exception as e:  # pragma: no cover - defensive (advisory plane)
            self._note_fault("tick", e)
            return 0

    def _tick(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        counts = EVENTS.counts()
        rejects = int(counts.get("admission_reject", 0))
        if self._reject_base is None:
            self._reject_base = rejects
        if not self.enabled():
            self._reject_base = rejects
            return 0
        made = 0
        evs = EVENTS.entries()
        new = [e for e in evs if e.seq > self._last_seq
               and e.kind in EVENT_TRIGGERS]
        if evs:
            self._last_seq = max(self._last_seq, evs[-1].seq)
        for e in new:
            if self._capture_event(e, now):
                made += 1
        # shed STORM detector: dedupe collapses reject events in the ring,
        # so storms are judged off the lifetime counter delta per tick
        storm_n = int(self._cfg("INCIDENT_REJECT_STORM", 20))
        if storm_n > 0 and rejects - self._reject_base >= storm_n:
            tail = [e for e in evs if e.kind == "admission_reject"]
            last = tail[-1] if tail else None
            attrs = dict(last.attrs) if last is not None else {}
            attrs["rejects_delta"] = rejects - self._reject_base
            if self._capture(
                    "admission_reject", "warn",
                    f"shed storm: {rejects - self._reject_base} rejects "
                    f"since last tick",
                    attrs, trace_id=getattr(last, "trace_id", 0) if last
                    else 0, now=now):
                made += 1
        self._reject_base = rejects
        return made

    def _capture_event(self, e, now: float) -> bool:
        return self._capture(e.kind, e.severity, e.detail, dict(e.attrs),
                             trace_id=int(getattr(e, "trace_id", 0) or 0),
                             digest=str(getattr(e, "digest", "") or ""),
                             now=now)

    # -- capture ---------------------------------------------------------------

    @staticmethod
    def _correlation(kind: str, attrs: Dict[str, Any], digest: str) -> str:
        return str(digest or attrs.get("digest") or attrs.get("slo")
                   or attrs.get("metric") or attrs.get("worker")
                   or attrs.get("table") or attrs.get("reason") or "")

    def _capture(self, kind: str, severity: str, detail: str,
                 attrs: Dict[str, Any], trace_id: int = 0, digest: str = "",
                 now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        corr = self._correlation(kind, attrs, digest)
        episode = f"{kind}:{corr}"
        cooldown = float(self._cfg("INCIDENT_COOLDOWN_S", 60.0))
        with self._lock:
            last = self._episodes.get(episode)
            if last is not None and now - last < cooldown:
                self.suppressed += 1
                return False
            self._episodes[episode] = now
            if len(self._episodes) > 1024:
                self._episodes.clear()  # epoch reset, bounded
            seq = next(self._seq)
        inst = self.instance
        bundle = IncidentBundle(
            incident_id=f"inc-{seq}", at=now, kind=kind,
            severity=severity or "warn", episode=episode,
            detail=str(detail)[:512], node=inst.node_id)
        bundle.state["trigger_attrs"] = {
            k: v for k, v in attrs.items() if isinstance(
                v, (str, int, float, bool, type(None)))}
        self._implicate(bundle, attrs, trace_id, digest)
        self._freeze_state(bundle, attrs)
        with self._lock:
            self._ring.append(bundle)
            self.captured += 1
        self._persist(bundle)
        return True

    def _implicate(self, bundle: IncidentBundle, attrs: Dict[str, Any],
                   trace_id: int, digest: str):
        """Resolve the trigger to digests + retained traces."""
        inst = self.instance
        digests: List[str] = []
        for d in (digest, attrs.get("digest")):
            if d and d not in digests:
                digests.append(str(d))
        store = getattr(inst, "trace_store", None)
        traces: List[Dict[str, Any]] = []
        seen_ids = set()
        if not digests:
            # no digest on the trigger (slo_burn / metric_anomaly): implicate
            # from evidence — recent tail-retained slow/error/shed traces
            # first (the burn's victims), then the hottest summary digests
            if store is not None:
                for rt in store.entries(limit=32):
                    if rt.reason != "sampled" and rt.digest and \
                            rt.digest not in digests:
                        wl = str(attrs.get("workload", "") or "").upper()
                        if wl and rt.workload and rt.workload.upper() != wl:
                            continue
                        sch = str(attrs.get("schema", "") or "").lower()
                        if sch and rt.schema.lower() != sch:
                            continue
                        digests.append(rt.digest)
                    if len(digests) >= 4:
                        break
            if not digests:
                try:
                    for r in inst.stmt_summary.rows()[:4]:
                        digests.append(str(r[0]))
                except Exception as e:
                    self._note_fault("implicate:summary", e)
        if store is not None:
            if trace_id:
                rt = store.get(trace_id)
                if rt is not None:
                    traces.append(rt.to_dict())
                    seen_ids.add(rt.trace_id)
            for d in digests:
                for rt in store.for_digest(d, limit=_TRACES_PER_DIGEST):
                    if rt.trace_id not in seen_ids:
                        seen_ids.add(rt.trace_id)
                        traces.append(rt.to_dict())
        bundle.digests = digests
        bundle.traces = traces
        bundle.trace_ids = sorted(seen_ids)
        try:
            dset = set(digests)
            bundle.summary_rows = [
                list(r) for r in inst.stmt_summary.rows()
                if str(r[0]) in dset][:_SUMMARY_ROWS_CAP]
        except Exception as e:
            self._note_fault("implicate:rows", e)
            bundle.summary_rows = []

    def _freeze_state(self, bundle: IncidentBundle, attrs: Dict[str, Any]):
        inst = self.instance
        mh = getattr(inst, "metric_history", None)
        if mh is not None:
            hints = _WINDOW_HINTS
            trig_metric = str(attrs.get("metric", "") or "").lower()
            if trig_metric:
                hints = hints + (trig_metric,)
            window: Dict[str, List] = {}
            try:
                for name in mh.names():
                    low = name.lower()
                    if any(h and h in low for h in hints):
                        pts = mh.series(name, samples=_WINDOW_SAMPLES)
                        if pts:
                            window[name] = [[round(t, 3), v] for t, v in pts]
                    if len(window) >= _WINDOW_SERIES_CAP:
                        break
            except Exception as e:
                self._note_fault("freeze:metrics", e)
            bundle.metric_window = window
        try:
            bundle.admission = [list(r) for r in
                                inst.admission.stats_rows()]
            bundle.state["mem_tier"] = int(inst.admission.governor.tier())
        except Exception as e:
            self._note_fault("freeze:admission", e)
        try:
            bundle.state["burning"] = list(inst.slo.burning_names())
        except Exception as e:
            self._note_fault("freeze:slo", e)
        try:
            bundle.state["columnar"] = [list(r) for r in
                                        inst.columnar.rows()[:16]]
        except Exception as e:
            self._note_fault("freeze:columnar", e)
        try:
            store = getattr(inst, "trace_store", None)
            if store is not None:
                bundle.state["trace_store"] = store.stats()
        except Exception as e:
            self._note_fault("freeze:traces", e)
        bundle.events = [
            {"seq": e.seq, "at": round(e.at, 3), "kind": e.kind,
             "severity": e.severity, "node": e.node, "detail": e.detail,
             "trace_id": int(getattr(e, "trace_id", 0) or 0),
             "digest": str(getattr(e, "digest", "") or ""),
             "attrs": {k: v for k, v in e.attrs.items() if isinstance(
                 v, (str, int, float, bool, type(None)))}}
            for e in EVENTS.entries()[-_EVENT_TAIL:]]

    # -- persistence -----------------------------------------------------------

    def _persist(self, bundle: IncidentBundle):
        d = self._dir()
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{bundle.incident_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle.to_dict(), f, default=str)
            os.replace(tmp, path)
            # bounded on disk too: reap oldest past INCIDENT_RING
            keep = int(self._cfg("INCIDENT_RING", 64))
            files = sorted((os.path.getmtime(os.path.join(d, n)),
                            os.path.join(d, n))
                           for n in os.listdir(d) if n.endswith(".json"))
            for _mt, p in files[:-keep] if keep > 0 else []:
                os.unlink(p)
        except Exception as e:  # pragma: no cover - disk faults are advisory
            self._note_fault("persist", e)

    # -- surfaces --------------------------------------------------------------

    def bundles(self) -> List[IncidentBundle]:
        with self._lock:
            return list(reversed(self._ring))

    def get(self, incident_id: str) -> Optional[IncidentBundle]:
        want = str(incident_id)
        if want and not want.startswith("inc-"):
            want = f"inc-{want}"
        with self._lock:
            for b in self._ring:
                if b.incident_id == want:
                    return b
        # fall through to disk (post-restart retrieval)
        d = self._dir()
        if d:
            path = os.path.join(d, f"{want}.json")
            try:
                with open(path) as f:
                    raw = json.load(f)
                b = IncidentBundle(
                    incident_id=str(raw.get("incident_id", want)),
                    at=float(raw.get("at", 0.0)),
                    kind=str(raw.get("kind", "")),
                    severity=str(raw.get("severity", "")),
                    episode=str(raw.get("episode", "")),
                    detail=str(raw.get("detail", "")),
                    node=str(raw.get("node", "")))
                b.digests = list(raw.get("digests") or [])
                b.trace_ids = list(raw.get("trace_ids") or [])
                b.traces = list(raw.get("traces") or [])
                b.summary_rows = list(raw.get("summary_rows") or [])
                b.metric_window = dict(raw.get("metric_window") or {})
                b.admission = list(raw.get("admission") or [])
                b.state = dict(raw.get("state") or {})
                b.events = list(raw.get("events") or [])
                return b
            except Exception as e:
                self._note_fault("get", e)
                return None
        return None

    def rows(self) -> List[tuple]:
        """SHOW INCIDENTS / information_schema.incidents row source:
        (id, at, kind, severity, episode, node, digests, traces, events,
        detail) — newest first."""
        out = []
        for b in self.bundles():
            out.append((b.incident_id, round(b.at, 3), b.kind, b.severity,
                        b.episode, b.node, ",".join(b.digests),
                        len(b.traces), len(b.events), b.detail))
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._episodes.clear()
            self.captured = 0
            self.suppressed = 0
