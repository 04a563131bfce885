"""Windowed metric history: the retention leg of the SLO plane.

``MetricHistory`` periodically snapshots every scalar the node already
exposes — the typed metrics registry (histograms expanded to
p50/p95/p99/count/sum), per-class admission stats, statement-summary
per-(schema, workload) rollups, and the host-side compile/dispatch
telemetry dicts — into a bounded, delta-encoded ring.  Everything read
is a host float that its owner already maintains under its own lock:
sampling never touches a device buffer, never forces a sync, and never
runs on the query hot path (the maintain loop and explicit
``Instance.slo_tick`` calls are the only drivers).

Storage is delta-encoded: one full ``_base`` dict holding the state
just before the oldest retained sample, plus a deque of
``(ts, {name: new_value})`` entries recording only the names that
changed at each tick.  Most counters are idle most of the time, so a
360-sample window costs far less than 360 full snapshots; trimming
folds the evicted delta into ``_base`` so replay stays exact.

Hatch duo (same convention as the statement summary / Pallas tiers):

* ``GALAXYSQL_METRIC_HISTORY=0`` env var — read once at import, kills
  sampling process-wide.
* ``ENABLE_METRIC_HISTORY`` config param — per-instance/session toggle.
"""

from __future__ import annotations

import os
import re
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# escape hatch: read once at import time (hot-loop code must not pay a
# getenv per sample), flipped only for tests via monkeypatch
ENABLED = os.environ.get("GALAXYSQL_METRIC_HISTORY", "1") != "0"

_NAME_RE = re.compile(r"[^a-z0-9_]+")


def _sanitize(name: str) -> str:
    """Normalize arbitrary stat labels into metric-name idiom."""
    return _NAME_RE.sub("_", str(name).strip().lower()).strip("_")


class MetricHistory:
    """Bounded delta-encoded ring of node-wide metric snapshots."""

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        # state strictly before the oldest retained delta
        self._base: Dict[str, float] = {}
        # (ts, {name: value}) — only names whose value changed that tick
        self._deltas: Deque[Tuple[float, Dict[str, float]]] = deque()
        # state after the newest delta (== replayed tip), plus its stamp
        self._last: Dict[str, float] = {}
        self._last_at = 0.0
        # name -> "counter" | "gauge" | "histogram" | "derived"; counters
        # (and histogram _count rows) are what the anomaly detector rates
        self._kinds: Dict[str, str] = {}
        self._samples_total = instance.metrics.counter(
            "metric_history_samples", "history snapshots taken on this node")

    # -- hatches ---------------------------------------------------------------

    def on(self) -> bool:
        if not ENABLED:
            return False
        try:
            return bool(self.instance.config.get("ENABLE_METRIC_HISTORY"))
        except Exception:
            return True

    def interval_s(self) -> float:
        try:
            return float(self.instance.config.get("METRIC_HISTORY_INTERVAL_S"))
        except Exception:
            return 5.0

    def bound(self) -> int:
        try:
            return max(2, int(self.instance.config.get(
                "METRIC_HISTORY_SAMPLES")))
        except Exception:
            return 360

    # -- collection ------------------------------------------------------------

    def collect(self) -> Dict[str, float]:
        """One full host-side snapshot; never raises, never syncs.

        Each source is read under that source's own lock (registry,
        admission, statement summary) and merged into a plain dict —
        the history lock is NOT held here, so there is no lock-order
        edge between the sampler and the stores it reads.
        """
        vals: Dict[str, float] = {}
        kinds: Dict[str, str] = {}
        inst = self.instance
        try:
            for name, kind, value, _help in inst.metrics.rows():
                vals[name] = float(value)
                if kind == "histogram" and name.endswith("_count"):
                    kinds[name] = "counter"  # monotone — rateable
                else:
                    kinds[name] = kind
        except Exception:
            pass
        adm = getattr(inst, "admission", None)
        if adm is not None:
            try:
                for stat, value in adm.stats_rows():
                    n = f"admission_{_sanitize(stat)}"
                    vals[n] = float(value)
                    kinds[n] = "gauge"
            except Exception:
                pass
        col = getattr(inst, "columnar", None)
        if col is not None:
            try:
                # live freshness: the columnar_lag_ms gauge only moves on
                # tailer cycles, but lag keeps growing while the tailer is
                # wedged — recompute from the watermarks at sample time so
                # the SLO burn engine judges reality
                lag = 0.0
                for rep in col.replicas.values():
                    if getattr(rep, "state", "") == "READY":
                        lag = max(lag, float(rep.lag_ms()))
                vals["columnar_lag_ms"] = round(max(lag, 0.0), 3)
                kinds["columnar_lag_ms"] = "gauge"
            except Exception:
                pass
        ss = getattr(inst, "stmt_summary", None)
        if ss is not None:
            try:
                for name, kind, value in ss.class_stats_rows():
                    n = f"stmt_{name}"
                    vals[n] = float(value)
                    kinds[n] = kind
            except Exception:
                pass
        try:
            from galaxysql_tpu_torch.exec import operators as ops
            vals["compile_retraces"] = float(ops.COMPILE_STATS["retraces"])
            vals["compile_ms_total"] = float(ops.COMPILE_STATS["compile_ms"])
            vals["compile_cache_hits"] = float(ops.COMPILE_STATS["cache_hits"])
            vals["exec_dispatches"] = float(ops.DISPATCH_STATS["dispatches"])
            for n in ("compile_retraces", "compile_ms_total",
                      "compile_cache_hits", "exec_dispatches"):
                kinds[n] = "counter"
        except Exception:
            pass
        with self._lock:
            self._kinds.update(kinds)
        return vals

    # -- sampling --------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> Optional[Dict[str, float]]:
        """Take one snapshot unconditionally (tests and the ``health``
        sync action call this; the maintain loop goes through
        ``maybe_sample``).  Returns the full snapshot dict, or None
        when the hatch is off."""
        if not self.on():
            return None
        if now is None:
            import time
            now = time.time()
        vals = self.collect()
        with self._lock:
            delta = {k: v for k, v in vals.items()
                     if self._last.get(k) != v}
            self._deltas.append((float(now), delta))
            self._last = vals
            self._last_at = float(now)
            bound = self.bound()
            while len(self._deltas) > bound:
                _ts, evicted = self._deltas.popleft()
                self._base.update(evicted)
        self._samples_total.inc()
        return vals

    def maybe_sample(self,
                     now: Optional[float] = None) -> Optional[Dict[str, float]]:
        """Interval-gated sample — the maintain-loop entry point."""
        if not self.on():
            return None
        if now is None:
            import time
            now = time.time()
        with self._lock:
            due = (now - self._last_at) >= self.interval_s()
        if not due:
            return None
        return self.sample(now=now)

    # -- queries ---------------------------------------------------------------

    @property
    def samples_count(self) -> int:
        """Retained sample count — cheap enough for reply piggybacks."""
        with self._lock:
            return len(self._deltas)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._base) | set(self._last))

    def counter_names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, k in self._kinds.items() if k == "counter")

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            return self._last.get(name, self._base.get(name))

    def series(self, name: str,
               samples: Optional[int] = None) -> List[Tuple[float, float]]:
        """Replay ``(ts, value)`` points for one metric, oldest first.

        A name absent from a delta means "unchanged since the previous
        point", so the replayed series always has one point per sample
        taken while the metric existed.
        """
        with self._lock:
            deltas = list(self._deltas)
            value = self._base.get(name)
        out: List[Tuple[float, float]] = []
        for ts, delta in deltas:
            if name in delta:
                value = delta[name]
            if value is not None:
                out.append((ts, value))
        if samples is not None and samples > 0:
            out = out[-samples:]
        return out

    def rate(self, name: str, samples: Optional[int] = None) -> float:
        """Average per-second rate over the (tail of the) series —
        meaningful for counters; 0.0 when underdetermined."""
        pts = self.series(name, samples=samples)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        dt = t1 - t0
        if dt <= 0:
            return 0.0
        return (v1 - v0) / dt

    def derivative(self, name: str,
                   samples: Optional[int] = None) -> List[Tuple[float, float]]:
        """Per-step rates: ``(ts, dv/dt)`` for each adjacent pair."""
        pts = self.series(name, samples=samples)
        out: List[Tuple[float, float]] = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            dt = t1 - t0
            if dt > 0:
                out.append((t1, (v1 - v0) / dt))
        return out

    def mean(self, name: str, samples: Optional[int] = None) -> float:
        pts = self.series(name, samples=samples)
        if not pts:
            return 0.0
        return sum(v for _t, v in pts) / len(pts)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {"samples": float(len(self._deltas)),
                    "names": float(len(self._last) or len(self._base)),
                    "last_at": self._last_at,
                    "interval_s": self.interval_s(),
                    "enabled": 1.0 if self.on() else 0.0}

    def rows(self, like: Optional[str] = None) -> List[Tuple]:
        """SHOW METRIC HISTORY / information_schema.metric_history rows:
        (name, points, latest, min, max, rate_per_s)."""
        import fnmatch
        pat = None
        if like:
            pat = like.replace("%", "*").replace("_", "?").lower()
        out: List[Tuple] = []
        for name in self.names():
            if pat is not None and not fnmatch.fnmatchcase(name.lower(), pat):
                continue
            pts = self.series(name)
            if not pts:
                continue
            values = [v for _t, v in pts]
            out.append((name, len(pts), values[-1], min(values), max(values),
                        round(self.rate(name), 6)))
        return out
