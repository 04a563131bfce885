"""SLO engine: declarative objectives + multi-window burn-rate alerting.

Objectives are evaluated against the node's :class:`MetricHistory`
(utils/metric_history.py) on every sample tick, never on the query
path.  Two window lengths — fast (``SLO_FAST_WINDOW_SAMPLES``) and
slow (``SLO_SLOW_WINDOW_SAMPLES``), both expressed in *samples* so the
wall-clock windows scale with ``METRIC_HISTORY_INTERVAL_S`` and tests
can drive the whole burn/recover cycle with synthetic tick timestamps
in milliseconds — give the classic multi-window burn-rate rule:

* BURNING when fast-window burn >= ``SLO_BURN_FAST`` **and**
  slow-window burn >= ``SLO_BURN_SLOW`` (fast window catches the page,
  slow window suppresses blips);
* RECOVERED when the fast-window burn falls back under 1.0.

Transitions publish typed ``slo_burn`` / ``slo_recovered`` journal
events (severity ``critical`` at >= 2x the fast threshold, else
``warn``) and the ``slo_burn_active`` gauge tracks how many objectives
are currently burning.

Alongside the declarative objectives, a robust-EWMA anomaly detector
rates every counter in the history (retrace storms, breaker flaps,
shed spikes) and publishes ``metric_anomaly`` events when a rate blows
past ``mean + ANOMALY_SIGMA * mean-abs-deviation``.  Detection only:
the whole engine is advisory — it can journal, never fail a query.

SQL-created objectives (``CREATE SLO ... WITH ...``) persist in the
metadb kv space under ``slo.def.<name>`` and reload on restart, so a
tenant objective survives a coordinator bounce like CCL rules do.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from galaxysql_tpu_torch.utils import events

_KV_PREFIX = "slo.def."
_KINDS = ("latency_p99", "error_ratio", "columnar_lag")


@dataclass
class SloDef:
    """One objective.  ``param`` names a config param to read the target
    from live (built-in defaults track SET GLOBAL); SQL-created SLOs
    carry a literal ``target``."""
    name: str
    kind: str                       # latency_p99 | error_ratio
    target: Optional[float] = None  # literal target (SQL-created)
    param: Optional[str] = None     # config param backing the target
    schema: str = ""                # "" = all schemas
    workload: str = ""              # "TP" | "AP" | "" = all classes
    source: str = "sql"             # default | sql

    def resolve_target(self, config) -> float:
        if self.param:
            try:
                return float(config.get(self.param))
            except (TypeError, ValueError):
                pass  # unparsable SET value: fall through to the literal
        return float(self.target or 0.0)


@dataclass
class _Status:
    burning: bool = False
    since: float = 0.0
    fast_burn: float = 0.0
    slow_burn: float = 0.0
    measured: float = 0.0


@dataclass
class _AnomalyState:
    mean: float = 0.0
    dev: float = 0.0
    n: int = 0
    firing: bool = False


_DEFAULTS = (
    SloDef("tp_latency_p99", "latency_p99", param="SLO_TP_P99_MS",
           workload="TP", source="default"),
    SloDef("ap_latency_p99", "latency_p99", param="SLO_AP_P99_MS",
           workload="AP", source="default"),
    SloDef("typed_error_ratio", "error_ratio", param="SLO_ERROR_RATIO",
           source="default"),
    # HTAP freshness: the columnar replica's apply lag
    # joins the burn engine — a wedged tailer burns like a latency storm
    SloDef("columnar_freshness", "columnar_lag", param="SLO_COLUMNAR_LAG_MS",
           source="default"),
)


class SloEngine:
    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._slos: Dict[str, SloDef] = {}
        self._status: Dict[str, _Status] = {}
        self._anom: Dict[str, _AnomalyState] = {}
        self._gauge = instance.metrics.gauge(
            "slo_burn_active", "objectives currently burning on this node")
        for d in _DEFAULTS:
            self._slos[d.name] = d
            self._status[d.name] = _Status()
        self._load_persisted()

    # -- definition management -------------------------------------------------

    def _load_persisted(self):
        try:
            rows = self.instance.metadb.kv_scan(_KV_PREFIX)
        except Exception:  # galaxylint: disable=swallow -- a metadb without a kv space still serves the built-in objectives; persistence is additive
            return
        for _key, raw in rows:
            try:
                d = json.loads(raw)
                slo = SloDef(name=d["name"], kind=d["kind"],
                             target=d.get("target"),
                             schema=d.get("schema", ""),
                             workload=d.get("workload", ""), source="sql")
                with self._lock:
                    self._slos[slo.name] = slo
                    self._status.setdefault(slo.name, _Status())
            except Exception:  # galaxylint: disable=swallow -- one corrupt persisted SLO row must not block loading the rest
                continue

    def create_sql(self, stmt) -> SloDef:
        """CREATE SLO dispatch target (session.py).  Exactly one of
        TARGET_P99_MS / ERROR_RATIO picks the kind."""
        from galaxysql_tpu_torch.utils import errors
        name = stmt.name.lower()
        with self._lock:
            exists = name in self._slos
        if exists:
            if stmt.if_not_exists:
                return self._slos[name]
            raise errors.TddlError(f"SLO '{name}' already exists")
        if (stmt.p99_ms is None) == (stmt.error_ratio is None):
            raise errors.TddlError(
                "CREATE SLO requires exactly one of TARGET_P99_MS or "
                "ERROR_RATIO")
        if stmt.p99_ms is not None:
            kind, target = "latency_p99", float(stmt.p99_ms)
            workload = (stmt.workload or "TP").upper()
        else:
            kind, target = "error_ratio", float(stmt.error_ratio)
            workload = (stmt.workload or "").upper()
        if target <= 0:
            raise errors.TddlError("SLO target must be > 0")
        if workload not in ("", "TP", "AP"):
            raise errors.TddlError(f"unknown SLO class '{workload}'")
        slo = SloDef(name=name, kind=kind, target=target,
                     schema=(stmt.schema or "").lower(), workload=workload,
                     source="sql")
        with self._lock:
            self._slos[name] = slo
            self._status[name] = _Status()
        try:
            self.instance.metadb.kv_put(_KV_PREFIX + name, json.dumps({
                "name": name, "kind": kind, "target": target,
                "schema": slo.schema, "workload": workload}))
        except Exception:  # galaxylint: disable=swallow -- persistence is best-effort: the in-memory objective is already live and judged
            pass
        return slo

    def drop_sql(self, name: str, if_exists: bool = False):
        from galaxysql_tpu_torch.utils import errors
        name = name.lower()
        with self._lock:
            slo = self._slos.pop(name, None)
            self._status.pop(name, None)
        if slo is None:
            if if_exists:
                return
            raise errors.TddlError(f"unknown SLO '{name}'")
        if slo.source == "sql":
            try:
                self.instance.metadb.kv_delete(_KV_PREFIX + name)
            except Exception:  # galaxylint: disable=swallow -- best-effort unpersist: the objective is already gone from evaluation
                pass
        self._refresh_gauge()

    def defs(self) -> List[SloDef]:
        with self._lock:
            return [self._slos[n] for n in sorted(self._slos)]

    # -- measurement -----------------------------------------------------------

    def _latency_metric(self, slo: SloDef) -> str:
        wl = (slo.workload or "TP").lower()
        if slo.schema:
            return f"stmt_tenant_{slo.schema}_{wl}_recent_p99_ms"
        return f"stmt_class_{wl}_recent_p99_ms"

    def _error_metrics(self, slo: SloDef) -> Tuple[str, str]:
        if slo.schema or slo.workload:
            wl = (slo.workload or "TP").lower()
            base = (f"stmt_tenant_{slo.schema}_{wl}" if slo.schema
                    else f"stmt_class_{wl}")
            return f"{base}_errors", f"{base}_execs"
        return "query_errors", "queries_total"

    def _burn(self, slo: SloDef, target: float, window: int) -> Tuple[float, float]:
        """(burn ratio, measured value) over the last ``window`` samples."""
        hist = self.instance.metric_history
        if target <= 0:
            return 0.0, 0.0
        if slo.kind == "latency_p99":
            measured = hist.mean(self._latency_metric(slo), samples=window)
            return measured / target, measured
        if slo.kind == "columnar_lag":
            measured = hist.mean("columnar_lag_ms", samples=window)
            return measured / target, measured
        err_name, tot_name = self._error_metrics(slo)
        errs = hist.series(err_name, samples=window)
        tots = hist.series(tot_name, samples=window)
        if len(errs) < 2 or len(tots) < 2:
            return 0.0, 0.0
        d_err = errs[-1][1] - errs[0][1]
        d_tot = tots[-1][1] - tots[0][1]
        if d_tot <= 0:
            return 0.0, 0.0
        ratio = max(0.0, d_err) / d_tot
        return ratio / target, ratio

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None):
        """One tick: burn-rate every objective, then rate-anomaly every
        counter.  Called by Instance.slo_tick right after a history
        sample lands; advisory, so any internal error is swallowed
        after journaling through the typed path it owns."""
        if now is None:
            import time
            now = time.time()
        try:
            self._evaluate_slos(now)
        except Exception:  # galaxylint: disable=swallow -- advisory plane: a broken objective must not fail the maintain tick (pragma: no cover)
            pass
        try:
            self._evaluate_anomalies(now)
        except Exception:  # galaxylint: disable=swallow -- advisory plane: detector errors must not fail the maintain tick (pragma: no cover)
            pass

    def _evaluate_slos(self, now: float):
        cfg = self.instance.config
        hist = self.instance.metric_history
        fast_n = max(2, int(cfg.get("SLO_FAST_WINDOW_SAMPLES")))
        slow_n = max(fast_n, int(cfg.get("SLO_SLOW_WINDOW_SAMPLES")))
        fast_thresh = float(cfg.get("SLO_BURN_FAST"))
        slow_thresh = float(cfg.get("SLO_BURN_SLOW"))
        n_samples = int(hist.summary()["samples"])
        for slo in self.defs():
            st = self._status.setdefault(slo.name, _Status())
            target = slo.resolve_target(cfg)
            fast, measured = self._burn(slo, target, fast_n)
            slow, _ = self._burn(slo, target, slow_n)
            st.fast_burn, st.slow_burn, st.measured = fast, slow, measured
            if n_samples < fast_n:
                continue  # not enough history to judge yet
            if not st.burning and fast >= fast_thresh and slow >= slow_thresh:
                st.burning, st.since = True, now
                severity = ("critical" if fast >= 2 * fast_thresh else "warn")
                events.publish(  # galaxylint: disable=event-uncorrelated -- a burn implicates a workload/schema, not one statement; the flight recorder resolves digests from tail-retained traces
                    "slo_burn",
                    f"SLO {slo.name} burning: fast={fast:.2f}x "
                    f"slow={slow:.2f}x target={target:g} "
                    f"measured={measured:g}",
                    severity=severity, node=self.instance.node_id,
                    slo=slo.name, slo_kind=slo.kind,
                    fast_burn=round(fast, 4), slow_burn=round(slow, 4),
                    target=target, measured=round(measured, 4),
                    schema=slo.schema, workload=slo.workload)
            elif st.burning and fast < 1.0:
                st.burning = False
                events.publish(
                    "slo_recovered",
                    f"SLO {slo.name} recovered: fast={fast:.2f}x after "
                    f"{max(0.0, now - st.since):.1f}s",
                    severity="info", node=self.instance.node_id,
                    slo=slo.name, slo_kind=slo.kind,
                    fast_burn=round(fast, 4),
                    burned_s=round(max(0.0, now - st.since), 3))
        self._refresh_gauge()

    def _refresh_gauge(self):
        with self._lock:
            burning = sum(1 for s in self._status.values() if s.burning)
        self._gauge.set(burning)

    def _evaluate_anomalies(self, now: float):
        cfg = self.instance.config
        hist = self.instance.metric_history
        alpha = float(cfg.get("ANOMALY_EWMA_ALPHA"))
        sigma = float(cfg.get("ANOMALY_SIGMA"))
        min_rate = float(cfg.get("ANOMALY_MIN_RATE"))
        for name in hist.counter_names():
            pts = hist.series(name, samples=2)
            if len(pts) < 2:
                continue
            dt = pts[1][0] - pts[0][0]
            if dt <= 0:
                continue
            rate = max(0.0, (pts[1][1] - pts[0][1]) / dt)
            st = self._anom.setdefault(name, _AnomalyState())
            if st.n >= 3:  # judged only after a warmed-up baseline
                floor = max(0.05 * st.mean, 1e-6)
                thresh = max(min_rate, st.mean + sigma * max(st.dev, floor))
                if rate > thresh:
                    if not st.firing:
                        st.firing = True
                        events.publish(  # galaxylint: disable=event-uncorrelated -- a counter-rate anomaly names a metric, not a statement; the flight recorder resolves digests from tail-retained traces
                            "metric_anomaly",
                            f"counter {name} rate {rate:.1f}/s vs baseline "
                            f"{st.mean:.1f}±{st.dev:.1f}/s",
                            severity="warn", node=self.instance.node_id,
                            metric=name, rate=round(rate, 3),
                            baseline=round(st.mean, 3),
                            deviation=round(st.dev, 3))
                    # damp the baseline update so a sustained storm does
                    # not immediately become the new normal
                    rate = thresh
                else:
                    st.firing = False
            st.dev = (1 - alpha) * st.dev + alpha * abs(rate - st.mean)
            st.mean = (1 - alpha) * st.mean + alpha * rate
            st.n += 1

    # -- surfaces --------------------------------------------------------------

    def burning_names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._status.items() if s.burning)

    def rows(self) -> List[Tuple]:
        """SHOW SLO / information_schema.slo_status rows."""
        cfg = self.instance.config
        out: List[Tuple] = []
        for slo in self.defs():
            st = self._status.get(slo.name) or _Status()
            out.append((slo.name, slo.kind, slo.schema or "*",
                        slo.workload or "*", slo.resolve_target(cfg),
                        round(st.measured, 4), round(st.fast_burn, 4),
                        round(st.slow_burn, 4),
                        "BURNING" if st.burning else "OK",
                        round(st.since, 3) if st.burning else 0.0,
                        slo.source))
        return out
