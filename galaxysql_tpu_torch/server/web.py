"""REST observability: JSON endpoints over the engine's runtime state.

Reference analog: `polardbx-executor/.../mpp/web/*` (query/stage/cluster JSON
resources served by the MPP coordinator's HTTP server).  Endpoints:

- /status            node identity, uptime, engine counters
- /queries           per-session state + last trace + the slow-query log
- /cluster           HA node states, leader, attached workers + fence state
- /plan-cache        hit/miss/size
- /baselines         SPM baselines (SHOW BASELINE as JSON)
- /scheduler         background jobs + recent firings
- /query-stats       last-N QueryProfile summaries (newest first)
- /statements        statement-digest summary store: top digests (ranked by
                     total time), per digest x plan rows, window history,
                     and the recent instance-event journal
- /query/<trace_id>  one query's full profile: per-operator rows/time,
                     fused-segment spans, trace tags (QueryStats analog)
- /trace/<trace_id>  the query's span tree as Chrome-trace/Perfetto JSON
                     (load in chrome://tracing or ui.perfetto.dev: one pid
                     per node — coordinator + each worker — one tid row per
                     mesh shard, compile/transfer events attributed in place;
                     falls back to the tail-sampled TraceStore, so retained
                     traces — including router-grafted cluster paths —
                     outlive the profile ring)
- /traces            the TraceStore's retained-trace index (id, digest,
                     reason, elapsed, phases) + store budget stats
- /incidents         flight-recorder bundle index (newest first)
- /incidents/<id>    one incident bundle's full evidence JSON
- /metrics           the typed counter/gauge registry in Prometheus text
                     exposition format (the scrape endpoint)
- /health            machine-readable liveness/readiness: SLO burn state,
                     per-worker breaker/fence telemetry, history summary
                     (status=degraded while any objective burns or any
                     worker is unreachable/fenced)
- /timeseries/<m>    one metric's windowed (ts, value) points from the
                     delta-encoded history ring, for plotting
- /events            journal tail; ?kind= / ?severity= / ?like= filters

Read-only by design: mutations go through SQL/DAL, never HTTP.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class WebConsole:
    def __init__(self, instance, host: str = "127.0.0.1", port: int = 0):
        self.instance = instance
        self.host = host
        self.port = port
        self.started_at = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- resources -----------------------------------------------------------

    def resource(self, path: str):
        inst = self.instance
        # query-string support (only /events and /timeseries use it today):
        # resource() is also called directly by tests with bare paths
        query = {}
        if "?" in path:
            from urllib.parse import parse_qs
            path, _, qs = path.partition("?")
            path = path.rstrip("/") or path
            query = {k: v[-1] for k, v in parse_qs(qs).items()}
        if path == "/status":
            return {"node_id": inst.node_id,
                    "uptime_s": round(time.time() - self.started_at, 1),
                    "counters": dict(inst.counters),
                    "sessions": len(inst.sessions)}
        if path == "/queries":
            from galaxysql_tpu_torch.utils.tracing import SLOW_LOG
            sessions = []
            for cid, s in list(inst.sessions.items()):
                sessions.append({
                    "conn_id": cid, "schema": getattr(s, "schema", None),
                    "user": getattr(s, "user", None),
                    "in_txn": getattr(s, "txn", None) is not None,
                    "last_trace": list(getattr(s, "last_trace", []))[-8:]})
            slow = [{"sql": e.sql, "elapsed_s": e.elapsed_s,
                     "conn_id": e.conn_id, "at": e.at,
                     "trace_id": e.trace_id, "workload": e.workload,
                     "error": e.error, "digest": e.digest}
                    for e in SLOW_LOG.entries()]
            return {"sessions": sessions, "slow_queries": slow[-50:]}
        if path == "/cluster":
            inst.ha.check()
            return {"nodes": dict(inst.ha.states),
                    "leader": inst.ha.leader(),
                    "workers": [{"host": h, "port": p,
                                 "fenced": inst.ha.worker_fenced((h, p))}
                                for (h, p) in inst.workers]}
        if path == "/plan-cache":
            c = inst.planner.cache
            return {"hits": c.hits, "misses": c.misses,
                    "size": len(c._map), "capacity": c.capacity}
        if path == "/baselines":
            cols = ["baseline_id", "schema", "sql", "accepted", "origin",
                    "runs", "avg_ms", "candidate", "regressions",
                    "last_regression", "state", "rollbacks", "last_heal"]
            return {"baselines": [dict(zip(cols, r))
                                  for r in inst.planner.spm.rows()]}
        if path == "/scheduler":
            jobs = [{"name": n, "kind": k, "schema": s, "table": t,
                     "interval_s": i, "enabled": bool(e), "last_fire": lf}
                    for n, k, s, t, i, e, lf in inst.scheduler.jobs()]
            hist = [{"name": n, "fired_at": at, "status": st, "detail": d}
                    for n, at, st, d in inst.scheduler.history()[-50:]]
            return {"jobs": jobs, "history": hist}
        if path == "/query-stats":
            return {"queries": [
                {"trace_id": p.trace_id, "conn_id": p.conn_id,
                 "schema": p.schema, "workload": p.workload,
                 "engine": p.engine, "elapsed_ms": p.elapsed_ms,
                 "rows": p.rows, "profiled": p.profiled, "sql": p.sql}
                for p in reversed(inst.profiles.entries())]}
        if path == "/statements":
            from galaxysql_tpu_torch.utils.events import EVENTS
            ss = inst.stmt_summary
            k = int(inst.config.get("STMT_SUMMARY_PROM_TOPK"))
            sum_cols = ["digest", "schema", "plan", "engines", "execs",
                        "errors", "avg_ms", "p95_ms", "p99_ms",
                        "rows_returned", "rows_examined", "retraces",
                        "frag_hits", "rf_rows_pruned", "skew_activations",
                        "rpc_retries", "spill_bytes", "peak_rss_kb",
                        "regressed", "join_order", "sql"]
            hist_cols = ["digest", "schema", "plan", "window_start", "execs",
                         "errors", "avg_ms", "min_ms", "max_ms",
                         "rows_returned", "rows_examined", "retraces",
                         "frag_hits", "rf_rows_pruned", "rpc_retries",
                         "spill_bytes", "sql"]
            return {"top": ss.top_digests(k),
                    "statements": [dict(zip(sum_cols, r))
                                   for r in ss.rows()],
                    "history": [dict(zip(hist_cols, r))
                                for r in ss.history_rows()[:200]],
                    "events": [{"seq": e.seq, "at": e.at, "kind": e.kind,
                                "severity": e.severity, "node": e.node,
                                "detail": e.detail, "attrs": e.attrs}
                               for e in EVENTS.entries()[-50:]]}
        if path.startswith("/query/"):
            try:
                trace_id = int(path[len("/query/"):])
            except ValueError:
                return None
            p = inst.profiles.get(trace_id)
            if p is None:
                return None
            return p.to_dict()  # segments/op_stats serialized there
        if path.startswith("/trace/"):
            from galaxysql_tpu_torch.utils.tracing import (chrome_trace,
                                                     span_from_dict)
            tid = path[len("/trace/"):]
            p = inst.profiles.get(tid)
            if p is not None and p.spans:
                return chrome_trace(p.trace_id, p.spans)
            # tail-retained traces (slow/shed/errored/sampled, and the
            # router's grafted cluster paths) outlive the profile ring
            store = getattr(inst, "trace_store", None)
            rt = store.get(tid) if store is not None else None
            if rt is None or not rt.spans:
                return None  # untraced query: no tree to export
            return chrome_trace(rt.trace_id,
                                [span_from_dict(d) for d in rt.spans])
        if path == "/traces":
            # the retained-trace index: what the tail sampler kept and why
            store = getattr(inst, "trace_store", None)
            if store is None:
                return None
            return {"stats": store.stats(),
                    "traces": [{"trace_id": rt.trace_id, "digest": rt.digest,
                                "reason": rt.reason, "node": rt.node,
                                "at": round(rt.at, 3),
                                "elapsed_ms": rt.elapsed_ms,
                                "error": rt.error, "phases": rt.phases,
                                "spans": len(rt.spans), "sql": rt.sql}
                               for rt in store.entries(limit=128)]}
        if path.startswith("/incidents"):
            rec = getattr(inst, "recorder", None)
            if rec is None:
                return None
            rest = path[len("/incidents"):].strip("/")
            if rest:
                b = rec.get(rest)
                return b.to_dict() if b is not None else None
            return {"incidents": [
                {"incident_id": b.incident_id, "at": round(b.at, 3),
                 "kind": b.kind, "severity": b.severity,
                 "episode": b.episode, "node": b.node,
                 "digests": list(b.digests), "traces": len(b.traces),
                 "events": len(b.events), "detail": b.detail}
                for b in rec.bundles()],
                "captured": rec.captured, "suppressed": rec.suppressed}
        if path == "/health":
            # machine-readable liveness/readiness + SLO burn state + per-
            # worker telemetry; `status` is degraded while any objective
            # burns or any worker is unreachable/fenced (load balancers
            # key off this — it must render even when a worker is wedged,
            # so worker state comes from piggybacked telemetry, no pull)
            mh = inst.metric_history
            burning = inst.slo.burning_names()
            workers = []
            degraded = bool(burning)
            for (h, p), client in sorted(inst.workers.items()):
                bk = client.breaker_snapshot() \
                    if hasattr(client, "breaker_snapshot") else {"state": "closed"}
                fenced = bool(inst.ha.worker_fenced((h, p)))
                state = ("FENCED" if fenced else
                         "UNREACHABLE" if bk["state"] == "open" else "OK")
                degraded = degraded or state != "OK"
                workers.append({"host": h, "port": p, "state": state,
                                "breaker": bk["state"], "fenced": fenced,
                                "queue_depth": getattr(client, "load_q", 0),
                                "mem_tier": getattr(client, "load_tier", 0)})
            return {"status": "degraded" if degraded else "ok",
                    "live": True,
                    "ready": not degraded,
                    "node_id": inst.node_id,
                    "leader": bool(inst.ha.is_leader()),
                    "uptime_s": round(time.time() - inst.started_at, 1),
                    "burning_slos": burning,
                    "slo": [{"name": r[0], "state": r[8],
                             "fast_burn": r[6], "slow_burn": r[7]}
                            for r in inst.slo.rows()],
                    "history": mh.summary(),
                    "qps": round(mh.rate("queries_total"), 3),
                    "error_rate": round(mh.rate("query_errors"), 6),
                    "mem_tier": int(inst.admission.governor.tier()),
                    "workers": workers}
        if path.startswith("/timeseries/"):
            # one metric's replayed (ts, value) points for plotting
            name = path[len("/timeseries/"):]
            mh = inst.metric_history
            pts = mh.series(name)
            if not pts:
                return None  # unknown metric (or history disarmed): 404
            return {"metric": name,
                    "points": [[round(t, 3), v] for t, v in pts],
                    "rate_per_s": round(mh.rate(name), 6)}
        if path == "/events":
            # journal tail with ?kind= / ?severity= / ?like= triage filters
            from galaxysql_tpu_torch.utils.events import EVENTS
            evs = EVENTS.entries(kind=query.get("kind"),
                                 severity=query.get("severity"),
                                 kind_like=query.get("like"))
            return {"events": [{"seq": e.seq, "at": round(e.at, 3),
                                "kind": e.kind, "severity": e.severity,
                                "node": e.node, "detail": e.detail,
                                "attrs": e.attrs, "trace_id": e.trace_id,
                                "digest": e.digest}
                               for e in reversed(evs)]}
        return None

    def metrics_text(self) -> str:
        """Prometheus text for /metrics: the instance registry plus a few
        point-in-time gauges stamped at scrape time.  The scrape-time gauges
        live in a throwaway registry — persisting them in the instance
        registry would leave stale point-in-time values visible to SHOW
        METRICS / information_schema.metrics between scrapes."""
        from galaxysql_tpu_torch.utils.metrics import MetricsRegistry
        from galaxysql_tpu_torch.utils.tracing import GLOBAL_STATS
        scrape = MetricsRegistry()
        scrape.gauge("sessions_active", "open sessions").set(
            len(self.instance.sessions))
        scrape.gauge("uptime_seconds", "web console uptime").set(
            round(time.time() - self.started_at, 1))
        scrape.gauge("query_profiles_retained",
                     "profiles in the last-N ring").set(
            len(self.instance.profiles.entries()))
        for name, value in GLOBAL_STATS.snapshot():
            scrape.gauge(f"instance_{name}",
                         "MatrixStatistics counter").set(value)
        return self.instance.metrics.prometheus_text() + \
            scrape.prometheus_text() + self._insight_text()

    def _insight_text(self) -> str:
        """Workload-insight exposition: instance-event counters (a `kind`
        label per event type) and the top-K statement digests' latency
        summaries (a `digest` label, bounded cardinality — top-K by total
        time only, K = STMT_SUMMARY_PROM_TOPK)."""
        from galaxysql_tpu_torch.utils.events import EVENTS
        inst = self.instance
        ns = inst.metrics.namespace
        out = ["# HELP %s_events_total instance events by kind" % ns,
               "# TYPE %s_events_total counter" % ns]
        for kind, n in sorted(EVENTS.counts().items()):
            out.append(f'{ns}_events_total{{kind="{kind}"}} {n}')
        ss = getattr(inst, "stmt_summary", None)
        if ss is not None:
            # K=0 is a real setting (digest labels off), not "use default"
            k = int(inst.config.get("STMT_SUMMARY_PROM_TOPK"))
            tops = ss.top_digests(k) if k > 0 else []
            if tops:
                out.append(f"# HELP {ns}_stmt_latency_ms top-{k} statement "
                           "digests, latency summary")
                out.append(f"# TYPE {ns}_stmt_latency_ms summary")
                for d in tops:
                    lbl = f'digest="{d["digest"]}"'
                    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"),
                                   (0.99, "p99_ms")):
                        out.append(f'{ns}_stmt_latency_ms{{{lbl},'
                                   f'quantile="{q}"}} {d[key]}')
                    out.append(f'{ns}_stmt_latency_ms_sum{{{lbl}}} '
                               f'{d["total_ms"]}')
                    out.append(f'{ns}_stmt_latency_ms_count{{{lbl}}} '
                               f'{d["execs"]}')
                out.append(f"# HELP {ns}_stmt_errors_total top-{k} statement "
                           "digests, failed executions")
                out.append(f"# TYPE {ns}_stmt_errors_total counter")
                for d in tops:
                    out.append(f'{ns}_stmt_errors_total{{digest='
                               f'"{d["digest"]}"}} {d["errors"]}')
        return "\n".join(out) + "\n"

    # -- http ----------------------------------------------------------------

    def start(self):
        console = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") == "/metrics":
                    # Prometheus scrape endpoint: text exposition, not JSON
                    try:
                        data = console.metrics_text().encode()
                    except Exception as e:
                        self.send_response(500)
                        self.end_headers()
                        self.wfile.write(json.dumps({"error": str(e)}).encode())
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                try:
                    body = console.resource(self.path.rstrip("/") or "/status")
                except Exception as e:  # a broken resource must not kill the server
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(json.dumps({"error": str(e)}).encode())
                    return
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b'{"error": "unknown resource"}')
                    return
                data = json.dumps(body, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # no stderr chatter
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="web-console")
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
