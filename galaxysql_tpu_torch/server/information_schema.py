"""information_schema views (port of `galaxysql_tpu/server/information_schema.py`).

Every view of the reference is a table of the `information_schema` schema, so the
binder knows its columns.  The views are filled from live state before any query
that reads the schema (`refresh`): schemata, tables, columns, statistics,
partitions, processlist, engines, global_variables, session_variables, plan_cache,
engine_counters, batch_stats, node_info (the metadb's node registry), ddl_jobs,
columnar_replica, fragment_cache, workers, and the operations plane's views:
query_stats, query_spans, metrics, admission_stats, ccl_rules, statement_summary,
statement_summary_history, events, incidents, plan_baselines, slo_status,
metric_history and cluster_health (from the workers' piggybacked telemetry, no
pull), and placement's rebalance_jobs (`ddl/rebalance.progress_rows`) and
coordinators (the peer registry from the last gossip snapshots, no pull).  They are
ordinary stores, read by the planner and the operators on the instance's device.
"""

from __future__ import annotations

from typing import Dict, List

from galaxysql_tpu_torch.meta.catalog import ColumnMeta, TableMeta
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils.ccl import GLOBAL_CCL
from galaxysql_tpu_torch.utils.events import EVENTS

_V = dt.VARCHAR
_I = dt.BIGINT
_D = dt.DOUBLE

_DEFS: Dict[str, List] = {
    "schemata": [("catalog_name", _V), ("schema_name", _V),
                 ("default_character_set_name", _V), ("default_collation_name", _V)],
    "tables": [("table_catalog", _V), ("table_schema", _V), ("table_name", _V),
               ("table_type", _V), ("engine", _V), ("table_rows", _I),
               ("auto_increment", _I), ("table_comment", _V)],
    "columns": [("table_schema", _V), ("table_name", _V), ("column_name", _V),
                ("ordinal_position", _I), ("is_nullable", _V), ("data_type", _V),
                ("column_type", _V), ("column_key", _V), ("extra", _V)],
    "statistics": [("table_schema", _V), ("table_name", _V), ("index_name", _V),
                   ("non_unique", _I), ("seq_in_index", _I), ("column_name", _V),
                   ("index_type", _V), ("index_status", _V)],
    "partitions": [("table_schema", _V), ("table_name", _V), ("partition_name", _V),
                   ("partition_method", _V), ("partition_expression", _V),
                   ("table_rows", _I)],
    "processlist": [("id", _I), ("user", _V), ("host", _V), ("db", _V),
                    ("command", _V), ("time", _I), ("state", _V), ("info", _V)],
    "engines": [("engine", _V), ("support", _V), ("comment", _V)],
    "global_variables": [("variable_name", _V), ("variable_value", _V)],
    "session_variables": [("variable_name", _V), ("variable_value", _V)],
    "ddl_jobs": [("job_id", _I), ("schema_name", _V), ("ddl_sql", _V),
                 ("state", _V)],
    "node_info": [("node_id", _V), ("role", _V), ("host", _V), ("port", _I)],
    "plan_cache": [("schema_name", _V), ("cache_key", _V), ("workload", _V),
                   ("hit_count", _I)],
    "engine_counters": [("counter_name", _V), ("value", _I)],
    # per-query runtime statistics (QueryProfile ring; RuntimeStatistics /
    # MPP QueryStats analog, §5.1) — one row per recent query
    "query_stats": [("trace_id", _I), ("conn_id", _I), ("schema_name", _V),
                    ("workload", _V), ("engine", _V), ("elapsed_ms", _D),
                    ("rows_returned", _I), ("operator_count", _I),
                    ("segment_count", _I), ("profiled", _I),
                    ("peak_rss_kb", _I), ("sql_text", _V)],
    # per-query span trees (TraceContext; ENABLE_QUERY_TRACING) — one row per
    # span of every retained traced profile, worker-side spans included
    "query_spans": [("trace_id", _I), ("span_id", _I), ("parent_id", _I),
                    ("span_name", _V), ("kind", _V), ("node", _V),
                    ("start_us", _I), ("dur_us", _D), ("attrs", _V)],
    # the typed counter/gauge registry (utils/metrics.py)
    "metrics": [("metric_name", _V), ("metric_kind", _V), ("value", _D),
                ("help", _V)],
    # cross-query fragment cache entries (exec/fragment_cache.py)
    "fragment_cache": [("entry_kind", _V), ("tables", _V), ("rows_cached", _I),
                       ("bytes", _I), ("hits", _I)],
    # cross-session point-query batching (server/batch_scheduler.py):
    # group sizes, waits, hit ratio, window occupancy — SHOW BATCH STATS twin
    "batch_stats": [("stat_name", _V), ("value", _D)],
    # attached worker endpoints: fence + circuit-breaker state and lifetime
    # retry/failure counters (net/dn.WorkerClient; SHOW WORKERS twin)
    "workers": [("host", _V), ("port", _I), ("breaker_state", _V),
                ("fenced", _I), ("consec_failures", _I), ("retries", _I),
                ("failures", _I), ("breaker_opens", _I), ("last_error", _V),
                ("retry_budget", _I)],
    # admission control + memory governance (server/admission.py):
    # per-class limits/in-flight/queue depth, shed counters, pressure tier,
    # retry-budget headroom — SHOW ADMISSION twin
    "admission_stats": [("stat_name", _V), ("value", _D)],
    # CCL rule states (utils/ccl.py; SHOW CCL_RULES twin) — rules are
    # SQL-manageable via CREATE/DROP CCL_RULE
    "ccl_rules": [("rule_name", _V), ("max_concurrency", _I),
                  ("keyword", _V), ("user", _V), ("running", _I),
                  ("waiting", _I), ("matched", _I), ("rejected", _I)],
    # statement-digest store (meta/statement_summary.py): per digest x plan
    # fingerprint aggregates — SHOW STATEMENT SUMMARY twin
    "statement_summary": [
        ("digest", _V), ("schema_name", _V), ("plan_fingerprint", _V),
        ("engines", _V), ("exec_count", _I), ("error_count", _I),
        ("avg_latency_ms", _D), ("p95_latency_ms", _D),
        ("p99_latency_ms", _D), ("rows_returned", _I), ("rows_examined", _I),
        ("retraces", _I), ("frag_cache_hits", _I), ("rf_rows_pruned", _I),
        ("skew_activations", _I), ("rpc_retries", _I), ("spill_bytes", _I),
        ("peak_rss_kb", _I),
        ("regressed", _I), ("join_order", _V), ("sample_sql", _V)],
    # time-bucketed windows per digest x plan (SHOW STATEMENT SUMMARY
    # HISTORY twin), newest bucket first
    "statement_summary_history": [
        ("digest", _V), ("schema_name", _V), ("plan_fingerprint", _V),
        ("window_start", _I), ("exec_count", _I), ("error_count", _I),
        ("avg_latency_ms", _D), ("min_latency_ms", _D),
        ("max_latency_ms", _D), ("rows_returned", _I), ("rows_examined", _I),
        ("retraces", _I), ("frag_cache_hits", _I), ("rf_rows_pruned", _I),
        ("rpc_retries", _I), ("spill_bytes", _I), ("sample_sql", _V)],
    # typed instance-event journal (utils/events.py; SHOW EVENTS twin) —
    # trace_id/digest link an event to its retained trace / statement-summary row
    "events": [("seq", _I), ("at", _D), ("kind", _V), ("severity", _V),
               ("node", _V), ("detail", _V), ("attrs", _V),
               ("trace_id", _I), ("digest", _V)],
    # flight-recorder incident bundles (server/flight_recorder.py;
    # SHOW INCIDENTS twin) — one row per retained bundle, newest first
    "incidents": [
        ("incident_id", _V), ("at", _D), ("kind", _V), ("severity", _V),
        ("episode", _V), ("node", _V), ("digests", _V), ("traces", _I),
        ("events", _I), ("detail", _V)],
    # elastic-rebalance jobs (ddl/rebalance.py; SHOW REBALANCE twin):
    # live job phase/progress + bounded finished-job history
    "rebalance_jobs": [
        ("job_id", _I), ("table_name", _V), ("kind", _V), ("state", _V),
        ("phase", _V), ("src_partitions", _V), ("targets", _I),
        ("rows_copied", _I), ("events_applied", _I), ("catchup_lag_ms", _D),
        ("last_checkpoint", _V), ("router_epoch", _I)],
    # SPM plan baselines incl. the self-heal quarantine machine
    # (plan/spm.py; SHOW BASELINE twin)
    "plan_baselines": [
        ("baseline_id", _I), ("schema_name", _V), ("parameterized_sql", _V),
        ("accepted_plan", _V), ("origin", _V), ("runs", _I), ("avg_ms", _D),
        ("candidate_plan", _V), ("regressions", _I), ("last_regression", _V),
        ("state", _V), ("rollbacks", _I), ("last_heal", _V)],
    # SLO plane (server/slo.py + utils/metric_history.py; SHOW SLO /
    # SHOW METRIC HISTORY / SHOW CLUSTER HEALTH twins)
    "slo_status": [
        ("slo_name", _V), ("kind", _V), ("schema_name", _V),
        ("workload", _V), ("target", _D), ("measured", _D),
        ("fast_burn", _D), ("slow_burn", _D), ("state", _V),
        ("since", _D), ("source", _V)],
    "metric_history": [
        ("metric_name", _V), ("points", _I), ("latest", _D),
        ("min_value", _D), ("max_value", _D), ("rate_per_s", _D)],
    "cluster_health": [
        ("node_id", _V), ("role", _V), ("addr", _V), ("state", _V),
        ("leader", _I), ("uptime_s", _D), ("sessions", _D), ("qps", _D),
        ("error_rate", _D), ("mem_tier", _I), ("burning_slos", _V),
        ("samples", _I)],
    "coordinators": [
        ("node_id", _V), ("role", _V), ("state", _V), ("epoch", _I),
        ("tp_limit", _D), ("ap_limit", _D), ("tp_inflight", _D),
        ("ap_inflight", _D), ("routed", _I), ("affinity_ratio", _D),
        ("gossip_age_s", _D)],
    # columnar HTAP replica tier (storage/columnar.py; SHOW COLUMNAR
    # REPLICA twin): per-table tailer state + watermark freshness
    "columnar_replica": [
        ("table_name", _V), ("state", _V), ("watermark", _I),
        ("lag_ms", _D), ("delta_rows", _I), ("base_stripes", _I),
        ("compactions", _I), ("reseeds", _I), ("pruned_stripes", _I),
        ("applied_events", _I), ("applied_rows", _I)],
}

def ensure_tables(instance):
    """Create the views' TableMetas and stores once (idempotent)."""
    s = instance.catalog.schema("information_schema")
    for name, cols in _DEFS.items():
        if name in s.tables:
            continue
        tm = TableMeta("information_schema", name,
                       [ColumnMeta(c, t) for c, t in cols])
        instance.catalog.add_table(tm, if_not_exists=True)
        instance.register_table(tm, persist=False)


def refresh(instance, session=None):
    """Re-materialize every view from live state."""
    ensure_tables(instance)
    ts = instance.tso.next_timestamp()
    cat = instance.catalog

    def fill(name: str, rows):
        rows = [list(r) for r in rows]
        store = instance.store("information_schema", name)
        store.truncate()
        if rows:
            names = [c for c, _ in _DEFS[name]]
            data = {nm: [r[i] for r in rows] for i, nm in enumerate(names)}
            store.insert_pylists(data, ts)
        store.table.stats.row_count = store.row_count()

    fill("schemata", (["def", s.name, "utf8mb4", "utf8mb4_general_ci"]
                      for s in cat.schemas.values()))

    tables, columns, stats, parts = [], [], [], []
    for s in cat.schemas.values():
        if s.name == "information_schema":
            continue
        for tm in s.tables.values():
            if tm.name.startswith("__recycle__"):
                continue
            store = instance.stores.get(instance.store_key(tm.schema, tm.name))
            nrows = store.row_count() if store else 0
            tables.append(["def", tm.schema, tm.name, "BASE TABLE", "TPU_COLUMNAR",
                           nrows, tm.auto_increment_next, tm.comment or ""])
            for i, c in enumerate(tm.columns, 1):
                key = "PRI" if c.name in tm.primary_key else ""
                columns.append([tm.schema, tm.name, c.name, i,
                                "YES" if c.nullable else "NO",
                                c.dtype.sql_name().split("(")[0].lower(),
                                c.dtype.sql_name().lower(), key,
                                "auto_increment" if c.auto_increment else ""])
            for seq, c in enumerate(tm.primary_key, 1):
                stats.append([tm.schema, tm.name, "PRIMARY", 0, seq, c, "LOCAL",
                              "PUBLIC"])
            for idx in tm.indexes:
                for seq, c in enumerate(idx.columns, 1):
                    stats.append([tm.schema, tm.name, idx.name,
                                  0 if idx.unique else 1, seq, c,
                                  "GLOBAL" if idx.global_index else "LOCAL",
                                  idx.status])
            p = tm.partition
            for pid in range(p.num_partitions):
                pname = (p.boundaries[pid][0] if pid < len(p.boundaries)
                         else f"p{pid}")
                prows = store.partitions[pid].num_rows if store else 0
                parts.append([tm.schema, tm.name, pname, p.method.upper(),
                              ",".join(p.columns), prows])
    fill("tables", tables)
    fill("columns", columns)
    fill("statistics", stats)
    fill("partitions", parts)

    fill("processlist", (
        [sid, getattr(se, "user", "root"), "localhost", se.schema or "", "Sleep",
         0, "", ""] for sid, se in list(instance.sessions.items())))
    fill("engines", [["TPU_COLUMNAR", "DEFAULT", "device-resident columnar engine"]])
    reg = instance.config.registry()
    gv = [[k.lower(), str(instance.config.get(k))] for k in sorted(reg)]
    fill("global_variables", gv)
    sv = gv if session is None else \
        [[k.lower(), str(instance.config.get(k, session.vars))] for k in sorted(reg)]
    fill("session_variables", sv)
    pc = instance.planner.cache
    with pc._lock:
        entries = [[k[0], k[1][:120], p.workload, 0] for k, p in pc._map.items()]
    fill("plan_cache", entries)
    fill("node_info", instance.metadb.alive_nodes())
    fill("engine_counters", ([k, int(v)] for k, v in
                             sorted(getattr(instance, "counters", {}).items())))
    fill("ddl_jobs", instance.metadb.query(
        "SELECT job_id, schema_name, ddl_sql, state FROM ddl_engine"))
    fill("columnar_replica", (list(r) for r in instance.columnar.rows()))
    fill("fragment_cache", ([k, t, r, b, h] for k, t, r, b, h in
                            instance.frag_cache.rows()))
    fill("batch_stats", ([n, float(v)] for n, v in
                         instance.batch_scheduler.stats_rows() +
                         instance.dml_batch_scheduler.stats_rows()))
    fill("workers", (list(r) for r in instance.worker_rows()))
    import json as _json
    profiles = instance.profiles
    fill("query_stats", ([p.trace_id, p.conn_id, p.schema, p.workload,
                          p.engine, p.elapsed_ms, p.rows, len(p.op_stats),
                          len(p.segments), 1 if p.profiled else 0,
                          p.peak_rss_kb, p.sql]
                         for p in profiles.entries()))
    fill("query_spans", ([p.trace_id, sp.span_id, sp.parent_id, sp.name,
                          sp.kind, sp.node, sp.start_us, float(sp.dur_us),
                          _json.dumps(sp.attrs, default=str)[:512]]
                         for p in profiles.entries() for sp in p.spans))
    fill("metrics", ([n, k, float(v), h] for n, k, v, h in instance.metrics.rows()))
    fill("admission_stats", ([n, float(v)] for n, v in
                             instance.admission.stats_rows()))
    fill("ccl_rules", ([st.rule.name, st.rule.max_concurrency,
                        st.rule.keyword or "", st.rule.user or "",
                        st.running, st.waiting, st.total_matched,
                        st.total_rejected] for st in GLOBAL_CCL.rules()))
    ss = instance.stmt_summary
    fill("statement_summary", (list(r) for r in ss.rows()))
    fill("statement_summary_history", (list(r) for r in ss.history_rows()))
    fill("events", ([e.seq, round(e.at, 3), e.kind, e.severity, e.node,
                     e.detail, _json.dumps(e.attrs, default=str)[:512],
                     e.trace_id, e.digest]
                    for e in EVENTS.entries()))
    fill("incidents", (list(r) for r in instance.recorder.rows()))
    fill("plan_baselines", (list(r) for r in instance.planner.spm.rows()))
    fill("slo_status", (list(r) for r in instance.slo.rows()))
    fill("metric_history", (list(r) for r in instance.metric_history.rows()))
    # pull=False: the refresh renders the workers' piggybacked telemetry only, so
    # a wedged worker cannot stall an unrelated catalog query
    fill("cluster_health", (list(r) for r in instance.cluster_health(pull=False)))
    from galaxysql_tpu_torch.ddl.rebalance import progress_rows
    fill("rebalance_jobs", (list(r) for r in progress_rows(instance)))
    # pull=False: the serving tier's rows from the gossip snapshots only, the same
    # no-stall rule
    fill("coordinators", (list(r) for r in instance.coordinator_rows(pull=False)))
