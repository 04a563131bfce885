"""SHOW command handlers (port of `galaxysql_tpu/server/show_handlers.py`).

Every kind of the reference but two, with the reference's columns and text:
databases, tables, columns, create table, variables, processlist, index / indexes /
keys, warnings, trace (the tags, then the span tree of a traced query), status,
engines, charset, collation, batch stats (the point batcher's rows, then the DML
batcher's and the async applier's), the binlog events, the recycle bin, the DDL
jobs, the columnar replica, the fragment cache, the attached workers, and the
operations plane's surfaces: baseline, slow, profiles, [full] stats, statement
summary [history] and its cluster form, events, incidents, metrics and its cluster
form, metric history, slo, cluster health, admission and ccl rules, and
placement's rebalance (the elastic jobs, `ddl/rebalance.progress_rows`) and
coordinators (the serving tier, `Instance.coordinator_rows`).  The cluster forms
merge the peer coordinators' rows (`_peer_pull` over `Instance.coordinators`).
"""

from __future__ import annotations

import fnmatch
from typing import List, Tuple

from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

# the default collation of each charset (MySQL 8.0)
_DEFAULT_COLLATIONS = {"utf8mb4": "utf8mb4_0900_ai_ci", "utf8": "utf8_general_ci",
                       "utf8mb3": "utf8mb3_general_ci", "latin1": "latin1_swedish_ci",
                       "ascii": "ascii_general_ci", "gbk": "gbk_chinese_ci",
                       "big5": "big5_chinese_ci", "gb18030": "gb18030_chinese_ci",
                       "utf16": "utf16_general_ci", "utf32": "utf32_general_ci",
                       "ucs2": "ucs2_general_ci", "binary": "binary"}


def _like_filter(names: List[str], pattern) -> List[str]:
    if not pattern:
        return names
    translated = pattern.replace("%", "*").replace("_", "?")
    return [n for n in names if fnmatch.fnmatch(n.lower(), translated.lower())]


def _peer_pull(inst, want: List[str]):
    """(node_id, reply-or-None) per serving-tier peer: a `health` pull with
    `want` sections (statement_summary / metrics rollups).  Transport
    failures yield None — CLUSTER surfaces render them as rows, never
    errors."""
    out = []
    for node_id, peer in sorted(getattr(inst, "coordinators", {}).items()):
        try:
            out.append((node_id, peer.sync_action("health", {"want": want})))
        except Exception:
            # unreachable peer: record None -- CLUSTER surfaces render it as
            # an UNREACHABLE row, never an error
            out.append((node_id, None))
    return out


def _unreachable_row(node: str, types) -> Tuple:
    """A typed placeholder row for a peer that did not answer the pull."""
    row = [node, "UNREACHABLE"]
    for t in types[2:]:
        row.append("" if t is dt.VARCHAR else 0)
    return tuple(row)


def _max_shard_rows(p) -> int:
    """Largest per-shard live-row count across the profile's MPP stages —
    slow-query triage sees shard skew straight from SHOW PROFILES, without
    tracing enabled (0 for local-engine or unprofiled queries)."""
    m = 0
    for st in p.op_stats:
        per = st.get("rows_per_shard")
        if per:
            m = max(m, max(per))
    return m


def _profile_rows(inst):
    """Last-N QueryProfiles as a result set, newest first (SHOW FULL STATS)."""
    from galaxysql_tpu_torch.server.session import ResultSet
    rows = []
    for p in reversed(inst.profiles.entries()):
        rows.append((p.trace_id, p.conn_id, p.schema, p.workload, p.engine,
                     p.elapsed_ms, p.rows, len(p.op_stats), len(p.segments),
                     _max_shard_rows(p), 1 if p.profiled else 0, p.sql))
    return ResultSet(
        ["Trace_id", "Conn", "Schema", "Workload", "Engine", "Elapsed_ms",
         "Rows", "Operators", "Segments", "Max_shard_rows", "Profiled",
         "SQL"],
        [dt.BIGINT, dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.DOUBLE,
         dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.VARCHAR],
        rows)


def handle(session, stmt: ast.Show):
    from galaxysql_tpu_torch.server.session import ResultSet

    kind = stmt.kind
    inst = session.instance
    if kind == "databases":
        names = sorted(s.name for s in inst.catalog.schemas.values())
        names = _like_filter(names, stmt.like)
        return ResultSet(["Database"], [dt.VARCHAR], [(n,) for n in names])
    if kind == "tables":
        schema = stmt.target or session.schema
        if not schema:
            raise errors.TddlError("No database selected")
        s = inst.catalog.schema(schema)
        names = sorted(t.name for t in s.tables.values()
                       if not t.name.startswith("__recycle__"))
        names = _like_filter(names, stmt.like)
        return ResultSet([f"Tables_in_{schema}"], [dt.VARCHAR], [(n,) for n in names])
    if kind == "recyclebin":
        return ResultSet(["NAME", "ORIGINAL_NAME", "SCHEMA_NAME", "DROP_TIME"],
                         [dt.VARCHAR] * 4, inst.recycle.rows())
    if kind == "ddl":
        rows = inst.metadb.query(
            "SELECT job_id, schema_name, state, ddl_sql FROM ddl_engine "
            "ORDER BY job_id DESC LIMIT 50")
        return ResultSet(["Job_id", "Schema", "State", "SQL"],
                         [dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR], rows)
    if kind == "columns":
        return session._describe(ast.TableName([stmt.target]))
    if kind == "binlog":
        # SHOW BINLOG EVENTS: the ordered global change stream (`txn/cdc.py`)
        return ResultSet(
            ["SEQ", "COMMIT_TSO", "SCHEMA_NAME", "TABLE_NAME", "KIND", "PAYLOAD"],
            [dt.BIGINT, dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR],
            inst.cdc.events())
    if kind == "create_table":
        return _create_table(inst.catalog.table(session.schema, stmt.target))
    if kind == "variables":
        reg = inst.config.registry()
        rows: List[Tuple] = []
        for name in sorted(reg):
            rows.append((name.lower(), str(inst.config.get(name, session.vars))))
        for name, v in sorted(session.vars.items()):
            if name.upper() not in reg:
                rows.append((name.lower(), str(v)))
        names = _like_filter([r[0] for r in rows], stmt.like)
        rows = [r for r in rows if r[0] in names]
        return ResultSet(["Variable_name", "Value"], [dt.VARCHAR, dt.VARCHAR], rows)
    if kind == "processlist":
        rows = [(cid, getattr(s, "user", "root"), "localhost", s.schema or "", "Query",
                 0, "", "") for cid, s in sorted(inst.sessions.items())]
        return ResultSet(["Id", "User", "Host", "db", "Command", "Time", "State",
                          "Info"],
                         [dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
                          dt.BIGINT, dt.VARCHAR, dt.VARCHAR], rows)
    if kind in ("index", "indexes", "keys"):
        tm = inst.catalog.table(session.schema, stmt.target)
        rows = []
        for i in tm.indexes:
            for seq, c in enumerate(i.columns, 1):
                rows.append((tm.name, 0 if i.unique else 1, i.name, seq, c,
                             "GLOBAL" if i.global_index else "LOCAL", i.status))
        for seq, c in enumerate(tm.primary_key, 1):
            rows.append((tm.name, 0, "PRIMARY", seq, c, "LOCAL", "PUBLIC"))
        return ResultSet(["Table", "Non_unique", "Key_name", "Seq_in_index",
                          "Column_name", "Index_type", "Status"],
                         [dt.VARCHAR, dt.BIGINT, dt.VARCHAR, dt.BIGINT, dt.VARCHAR,
                          dt.VARCHAR, dt.VARCHAR], rows)
    if kind == "batch" and (stmt.target or "").lower() == "stats":
        # the cross-session point-query batching scheduler (group sizes, waits,
        # hit ratio, window occupancy), then the DML batcher's group rows and the
        # async applier's backlog and lag
        rows = inst.batch_scheduler.stats_rows() + inst.dml_batch_scheduler.stats_rows()
        return ResultSet(["Stat", "Value"], [dt.VARCHAR, dt.DOUBLE],
                         [(n, float(v)) for n, v in rows])
    if kind == "warnings":
        return ResultSet(["Level", "Code", "Message"],
                         [dt.VARCHAR, dt.BIGINT, dt.VARCHAR], [])
    if kind == "trace":
        # the last query's trace tags, then its span tree when it ran traced
        lines = list(session.last_trace)
        spans = getattr(session, "last_spans", None)
        if spans:
            from galaxysql_tpu_torch.utils.tracing import span_tree_lines
            lines += span_tree_lines(spans)
        return ResultSet(["Trace"], [dt.VARCHAR], [(t,) for t in lines])
    if kind == "columnar_replica":
        # SHOW COLUMNAR REPLICA: per-table tailer state, watermark freshness and
        # tier shape (storage/columnar.py)
        return ResultSet(
            ["Table", "State", "Watermark", "Lag_ms", "Delta_rows",
             "Base_stripes", "Compactions", "Reseeds", "Pruned_stripes",
             "Applied_events", "Applied_rows"],
            [dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.DOUBLE, dt.BIGINT,
             dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT,
             dt.BIGINT],
            inst.columnar.rows())
    if kind == "workers":
        # attached worker endpoints with fence and circuit-breaker state and
        # lifetime retry/failure counts (information_schema.workers's twin)
        return ResultSet(
            ["Host", "Port", "Breaker", "Fenced", "Consec_failures",
             "Retries", "Failures", "Breaker_opens", "Last_error",
             "Retry_budget"],
            [dt.VARCHAR, dt.BIGINT, dt.VARCHAR, dt.BIGINT, dt.BIGINT,
             dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.VARCHAR, dt.BIGINT],
            inst.worker_rows())
    if kind == "engines":
        return ResultSet(["Engine", "Support", "Comment"], [dt.VARCHAR] * 3,
                         [("TPU_COLUMNAR", "DEFAULT",
                           "Device-resident columnar engine")])
    if kind == "collation":
        return _collations(stmt.like)
    if kind == "fragment" and (stmt.target or "").lower() == "cache":
        # SHOW FRAGMENT CACHE: one row per resident entry, MRU first
        return ResultSet(["Kind", "Tables", "Rows", "Bytes", "Hits"],
                         [dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.BIGINT, dt.BIGINT],
                         inst.frag_cache.rows())
    if kind in ("status", "charset"):
        return ResultSet(["Variable_name", "Value"], [dt.VARCHAR, dt.VARCHAR], [])
    if kind == "baseline":
        # SPM DAL (PlanManager.java DAL analog): one row per plan baseline;
        # REGRESSIONS/LAST_REGRESSION carry the statement-summary sentinel's
        # runtime verdict on the accepted plan, STATE/ROLLBACKS/LAST_HEAL the
        # self-heal quarantine machine (HEALTHY -> REGRESSED -> PROBATION ->
        # HEALED | EVOLVED | HEAL_FAILED)
        rows = inst.planner.spm.rows()
        return ResultSet(
            ["BASELINE_ID", "SCHEMA_NAME", "PARAMETERIZED_SQL", "ACCEPTED_PLAN",
             "ORIGIN", "RUNS", "AVG_MS", "CANDIDATE_PLAN", "REGRESSIONS",
             "LAST_REGRESSION", "STATE", "ROLLBACKS", "LAST_HEAL"],
            [dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
             dt.BIGINT, dt.DOUBLE, dt.VARCHAR, dt.BIGINT, dt.VARCHAR,
             dt.VARCHAR, dt.BIGINT, dt.VARCHAR], rows)
    if kind == "slow":
        from galaxysql_tpu_torch.utils.tracing import SLOW_LOG
        # Trace_id links a slow row to its profile (SHOW FULL STATS /
        # information_schema.query_stats / web /query/<trace_id>); Error is
        # non-empty for queries that died mid-execution AFTER crossing the
        # slow gate — slow failures explain themselves here too
        # Digest jumps a slow row straight to its SHOW STATEMENT SUMMARY
        # aggregate (same digest key: schema + parameterized text)
        rows = [(e.conn_id, round(e.elapsed_s * 1000, 1), e.sql,
                 e.trace_id, e.workload, e.error, e.digest)
                for e in SLOW_LOG.entries()]
        return ResultSet(["Conn", "Elapsed_ms", "SQL", "Trace_id", "Workload",
                          "Error", "Digest"],
                         [dt.BIGINT, dt.DOUBLE, dt.VARCHAR, dt.BIGINT,
                          dt.VARCHAR, dt.VARCHAR, dt.VARCHAR], rows)
    if kind == "statement_summary":
        # SHOW STATEMENT SUMMARY [HISTORY]: the statement-digest store
        # (meta/statement_summary.py) — per digest x plan aggregates, or the
        # time-bucketed window history (information_schema twins)
        ss = inst.stmt_summary
        if getattr(stmt, "cluster", False):
            # SHOW CLUSTER STATEMENT SUMMARY: peer rollups merged under a
            # leading Node column; an unreachable peer renders as a row,
            # never an error (triage must work mid-outage)
            names = ["Node", "Digest", "Schema", "Plan", "Engines", "Execs",
                     "Errors", "Avg_ms", "P95_ms", "P99_ms", "Rows_returned",
                     "Rows_examined", "Retraces", "Frag_hits",
                     "Rf_rows_pruned", "Skew_activations", "Rpc_retries",
                     "Spill_bytes", "Peak_rss_kb", "Regressed", "Join_order",
                     "SQL"]
            types = [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
                     dt.VARCHAR, dt.BIGINT, dt.BIGINT, dt.DOUBLE, dt.DOUBLE,
                     dt.DOUBLE, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT,
                     dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT,
                     dt.BIGINT, dt.VARCHAR, dt.VARCHAR]
            rows = [(inst.node_id,) + tuple(r) for r in ss.rows()]
            for node, resp in _peer_pull(inst, ["statement_summary"]):
                if resp is None:
                    rows.append(_unreachable_row(node, types))
                    continue
                for r in resp.get("statement_summary") or []:
                    rows.append((node,) + tuple(r))
            return ResultSet(names, types, rows)
        if (stmt.target or "").lower() == "history":
            return ResultSet(
                ["Digest", "Schema", "Plan", "Window_start", "Execs",
                 "Errors", "Avg_ms", "Min_ms", "Max_ms", "Rows_returned",
                 "Rows_examined", "Retraces", "Frag_hits", "Rf_rows_pruned",
                 "Rpc_retries", "Spill_bytes", "SQL"],
                [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.BIGINT,
                 dt.BIGINT, dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.BIGINT,
                 dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT,
                 dt.BIGINT, dt.VARCHAR], ss.history_rows())
        return ResultSet(
            ["Digest", "Schema", "Plan", "Engines", "Execs", "Errors",
             "Avg_ms", "P95_ms", "P99_ms", "Rows_returned", "Rows_examined",
             "Retraces", "Frag_hits", "Rf_rows_pruned", "Skew_activations",
             "Rpc_retries", "Spill_bytes", "Peak_rss_kb", "Regressed",
             "Join_order", "SQL"],
            [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.BIGINT,
             dt.BIGINT, dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.BIGINT,
             dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT,
             dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.VARCHAR,
             dt.VARCHAR],
            ss.rows())
    if kind == "events":
        # SHOW EVENTS [WARN|INFO|CRITICAL] [LIKE 'kind%']: the typed
        # instance-event journal (utils/events.py) — newest first.  The
        # optional severity word and kind LIKE-pattern make slo_burn /
        # metric_anomaly triage a one-liner instead of a journal scroll.
        import json as _json
        from galaxysql_tpu_torch.utils.events import EVENTS
        severity = (stmt.target or "").lower()
        if severity and severity not in ("info", "warn", "critical"):
            raise errors.NotSupportedError(
                f"SHOW EVENTS severity '{stmt.target}' "
                "(expected INFO|WARN|CRITICAL)")
        rows = [(e.seq, round(e.at, 3), e.kind, e.severity, e.node, e.detail,
                 _json.dumps(e.attrs, default=str)[:512],
                 e.trace_id, e.digest)
                for e in reversed(EVENTS.entries(
                    severity=severity or None,
                    kind_like=stmt.like or None))]
        return ResultSet(
            ["Seq", "At", "Kind", "Severity", "Node", "Detail", "Attrs",
             "Trace_id", "Digest"],
            [dt.BIGINT, dt.DOUBLE, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
             dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.VARCHAR], rows)
    if kind == "incidents":
        # SHOW INCIDENTS [<seq>]: flight-recorder incident bundles
        # (server/flight_recorder.py), newest first.  With a seq the full
        # evidence detail renders as Field/Value lines — implicated
        # digests, metric-history window tails, retained trace trees with
        # their phase breakdowns, and the event tail around the trigger.
        import json as _json
        rec = getattr(inst, "recorder", None)
        if stmt.target:
            b = rec.get(stmt.target) if rec is not None else None
            if b is None:
                raise errors.TddlError(
                    f"unknown incident '{stmt.target}' (SHOW INCIDENTS "
                    "lists retained bundles)")
            rows = [("incident_id", b.incident_id), ("at", f"{b.at:.3f}"),
                    ("kind", b.kind), ("severity", b.severity),
                    ("episode", b.episode), ("node", b.node),
                    ("detail", b.detail),
                    ("digests", ",".join(b.digests)),
                    ("trace_ids", ",".join(str(t) for t in b.trace_ids)),
                    ("admission",
                     _json.dumps(b.admission, default=str)[:512]),
                    ("state", _json.dumps(b.state, default=str)[:512])]
            for name in sorted(b.metric_window):
                rows.append((f"metric:{name}", _json.dumps(
                    b.metric_window[name][-8:], default=str)[:512]))
            from galaxysql_tpu_torch.utils.tracing import (span_from_dict,
                                                     span_tree_lines)
            for tr in b.traces:
                tid = tr.get("trace_id")
                rows.append((f"trace:{tid}",
                             (f"{tr.get('reason')} "
                              f"{tr.get('elapsed_ms')}ms phases="
                              f"{_json.dumps(tr.get('phases') or {})}")
                             [:512]))
                spans = [span_from_dict(d) for d in tr.get("spans") or []]
                for ln in span_tree_lines(spans)[:24]:
                    rows.append((f"trace:{tid}", ln[:512]))
            for e in b.events[-16:]:
                rows.append((f"event:{e.get('seq')}",
                             f"{e.get('kind')} {e.get('detail', '')}"[:256]))
            return ResultSet(["Field", "Value"], [dt.VARCHAR, dt.VARCHAR],
                             rows)
        rows = rec.rows() if rec is not None else []
        return ResultSet(
            ["Incident", "At", "Kind", "Severity", "Episode", "Node",
             "Digests", "Traces", "Events", "Detail"],
            [dt.VARCHAR, dt.DOUBLE, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
             dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.BIGINT, dt.VARCHAR],
            rows)
    if kind == "admission":
        # SHOW ADMISSION: the overload plane (server/admission.py) — per-class
        # adaptive limits/in-flight/queue depth, shed counters, memory tier,
        # retry-budget headroom (information_schema.admission_stats twin)
        adm = getattr(inst, "admission", None)
        rows = adm.stats_rows() if adm is not None else []
        return ResultSet(["Stat", "Value"], [dt.VARCHAR, dt.DOUBLE],
                         [(n, float(v)) for n, v in rows])
    if kind == "metrics":
        # the typed counter/gauge registry (information_schema.metrics twin)
        if getattr(stmt, "cluster", False):
            # SHOW CLUSTER METRICS: every peer's registry under a leading
            # Node column (unreachable peers as rows, never errors)
            types = [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.DOUBLE,
                     dt.VARCHAR]
            rows = [(inst.node_id, n, k, float(v), h)
                    for n, k, v, h in inst.metrics.rows()]
            for node, resp in _peer_pull(inst, ["metrics"]):
                if resp is None:
                    rows.append(_unreachable_row(node, types))
                    continue
                for r in resp.get("metrics") or []:
                    n, k, v, h = r
                    rows.append((node, n, k, float(v), h))
            return ResultSet(["Node", "Name", "Kind", "Value", "Help"],
                             types, rows)
        rows = [(n, k, float(v), h) for n, k, v, h in inst.metrics.rows()]
        return ResultSet(["Name", "Kind", "Value", "Help"],
                         [dt.VARCHAR, dt.VARCHAR, dt.DOUBLE, dt.VARCHAR],
                         rows)
    if kind == "profiles":
        return _profile_rows(inst)
    if kind == "ccl_rules":
        from galaxysql_tpu_torch.utils.ccl import GLOBAL_CCL
        rows = []
        for st in GLOBAL_CCL.rules():
            r = st.rule
            rows.append((r.name, r.max_concurrency, r.keyword or "", r.user or "",
                         st.running, st.waiting, st.total_matched, st.total_rejected))
        return ResultSet(["Rule", "Max_concurrency", "Keyword", "User", "Running",
                          "Waiting", "Matched", "Rejected"],
                         [dt.VARCHAR, dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.BIGINT,
                          dt.BIGINT, dt.BIGINT, dt.BIGINT], rows)
    if kind == "stats":
        # SHOW STATS = instance counters (§5.5); SHOW FULL STATS = the last-N
        # per-query runtime profiles (the reference's SHOW FULL STATS surface)
        if stmt.full:
            return _profile_rows(inst)
        from galaxysql_tpu_torch.utils.tracing import GLOBAL_STATS
        return ResultSet(["Name", "Value"], [dt.VARCHAR, dt.BIGINT],
                         GLOBAL_STATS.snapshot())
    if kind == "slo":
        # SHOW SLO: every objective (built-in + CREATE SLO) with its live
        # fast/slow burn ratios and BURNING/OK state (server/slo.py)
        return ResultSet(
            ["Name", "Kind", "Schema", "Class", "Target", "Measured",
             "Fast_burn", "Slow_burn", "State", "Since", "Source"],
            [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.DOUBLE,
             dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.VARCHAR, dt.DOUBLE,
             dt.VARCHAR],
            session.instance.slo.rows())
    if kind == "metric_history":
        # SHOW METRIC HISTORY [LIKE pattern]: per-metric window summaries
        # from the delta-encoded ring (utils/metric_history.py)
        return ResultSet(
            ["Metric", "Points", "Latest", "Min", "Max", "Rate_per_s"],
            [dt.VARCHAR, dt.BIGINT, dt.DOUBLE, dt.DOUBLE, dt.DOUBLE,
             dt.DOUBLE],
            session.instance.metric_history.rows(stmt.like))
    if kind == "cluster_health":
        # SHOW CLUSTER HEALTH: this coordinator + a fresh `health` pull
        # from every attached worker (UNREACHABLE rows, never errors)
        return ResultSet(
            ["Node", "Role", "Addr", "State", "Leader", "Uptime_s",
             "Sessions", "Qps", "Error_rate", "Mem_tier", "Burning_slos",
             "Samples"],
            [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.BIGINT,
             dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.BIGINT,
             dt.VARCHAR, dt.BIGINT],
            session.instance.cluster_health(pull=True))
    if kind == "rebalance":
        # SHOW REBALANCE: the live elastic jobs (phase, rows copied, catchup lag,
        # last checkpoint) and the bounded history of finished ones
        from galaxysql_tpu_torch.ddl.rebalance import progress_rows
        return ResultSet(
            ["JOB_ID", "TABLE_NAME", "KIND", "STATE", "PHASE", "SRC_PARTITIONS",
             "TARGETS", "ROWS_COPIED", "EVENTS_APPLIED", "CATCHUP_LAG_MS",
             "LAST_CHECKPOINT", "ROUTER_EPOCH"],
            [dt.BIGINT, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.VARCHAR,
             dt.VARCHAR, dt.BIGINT, dt.BIGINT, dt.BIGINT, dt.DOUBLE,
             dt.VARCHAR, dt.BIGINT], progress_rows(session.instance))
    if kind == "coordinators":
        # SHOW COORDINATORS: every coordinator of the serving tier with its epoch,
        # admission limits, routed counts, affinity ratio and gossip age; a dead
        # peer is an UNREACHABLE row
        return ResultSet(
            ["Node", "Role", "State", "Epoch", "Tp_limit", "Ap_limit",
             "Tp_inflight", "Ap_inflight", "Routed", "Affinity_ratio",
             "Gossip_age_s"],
            [dt.VARCHAR, dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.DOUBLE,
             dt.DOUBLE, dt.DOUBLE, dt.DOUBLE, dt.BIGINT, dt.DOUBLE,
             dt.DOUBLE],
            session.instance.coordinator_rows(pull=True))
    raise errors.NotSupportedError(f"SHOW {kind}")


def _create_table(tm):
    from galaxysql_tpu_torch.server.session import ResultSet
    parts = []
    for c in tm.columns:
        nn = "" if c.nullable else " NOT NULL"
        ai = " AUTO_INCREMENT" if c.auto_increment else ""
        parts.append(f"  `{c.name}` {c.dtype.sql_name()}{nn}{ai}")
    if tm.primary_key:
        parts.append("  PRIMARY KEY (" + ", ".join(f"`{k}`" for k in tm.primary_key) +
                     ")")
    for i in tm.indexes:
        g = "GLOBAL " if i.global_index else ""
        u = "UNIQUE " if i.unique else ""
        parts.append(f"  {g}{u}KEY `{i.name}` (" +
                     ", ".join(f"`{c}`" for c in i.columns) + ")")
    p = tm.partition
    tail = ""
    if p.method == "broadcast":
        tail = " BROADCAST"
    elif p.method == "single":
        tail = " SINGLE"
    elif p.method in ("hash", "key"):
        tail = (f" PARTITION BY {p.method.upper()}(" + ", ".join(p.columns) +
                f") PARTITIONS {p.count}")
    elif p.method.startswith(("range", "list")):
        tail = f" PARTITION BY {p.method.upper()}({', '.join(p.columns)}) (...)"
    ddl = "\n".join([f"CREATE TABLE `{tm.name}` (", ",\n".join(parts), ")" + tail])
    return ResultSet(["Table", "Create Table"], [dt.VARCHAR, dt.VARCHAR],
                     [(tm.name, ddl)])


def _collations(like):
    """The enumerated collation registry (`types/collation.py`); the charset is the
    name's prefix and Default marks each charset's default collation."""
    from galaxysql_tpu_torch.server.session import ResultSet
    from galaxysql_tpu_torch.types.collation import COLLATIONS
    rows = []
    names = _like_filter(sorted(COLLATIONS), like)
    for i, name in enumerate(sorted(COLLATIONS), 1):
        if name not in names:
            continue
        charset = name.split("_")[0] if "_" in name else name
        rows.append((name, charset, i,
                     "Yes" if _DEFAULT_COLLATIONS.get(charset) == name else "", "Yes",
                     1))
    return ResultSet(["Collation", "Charset", "Id", "Default", "Compiled", "Sortlen"],
                     [dt.VARCHAR, dt.VARCHAR, dt.BIGINT, dt.VARCHAR, dt.VARCHAR,
                      dt.BIGINT], rows)
