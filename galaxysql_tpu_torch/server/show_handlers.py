"""SHOW command handlers (port of `galaxysql_tpu/server/show_handlers.py`).

The kinds whose data the port holds, with the reference's columns and text: databases,
tables, columns, create table, variables, processlist, index / indexes / keys,
warnings, trace, status, engines, charset, collation, batch stats (the point
batcher's rows, then the DML batcher's and the async applier's), the binlog events,
the recycle bin, the DDL jobs, the columnar replica, the fragment cache and the
attached workers.  Every other kind raises `NotSupportedError` naming the module it
waits for.
"""

from __future__ import annotations

import fnmatch
from typing import List, Tuple

from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

# SHOW kinds of the reference the port does not take yet -> the module each waits for
_WAITING = {
    "baseline": "the plan-baseline surface of the operations plane "
                "(ROADMAP Queue 1 item 16)",
    "slow": "utils/tracing.py (ROADMAP Queue 1 item 16)",
    "profiles": "utils/tracing.py (ROADMAP Queue 1 item 16)",
    "stats": "utils/tracing.py (ROADMAP Queue 1 item 16)",
    "statement_summary": "meta/statement_summary.py (ROADMAP Queue 1 item 16)",
    "events": "utils/events.py (ROADMAP Queue 1 item 16)",
    "incidents": "server/flight_recorder.py (ROADMAP Queue 1 item 16)",
    "metrics": "utils/metrics.py (ROADMAP Queue 1 item 16)",
    "metric_history": "utils/metric_history.py (ROADMAP Queue 1 item 16)",
    "slo": "server/slo.py (ROADMAP Queue 1 item 16)",
    "cluster_health": "server/slo.py (ROADMAP Queue 1 item 16)",
    "admission": "server/admission.py (ROADMAP Queue 1 item 16)",
    "ccl_rules": "utils/ccl.py (ROADMAP Queue 1 item 16)",
    "rebalance": "ddl/rebalance.py (ROADMAP Queue 1 item 16)",
    "coordinators": "server/router.py (ROADMAP Queue 1 item 16)",
}

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
        # the last query's trace tags (the reference adds its span tree, which
        # waits for utils/tracing.py)
        return ResultSet(["Trace"], [dt.VARCHAR], [(t,) for t in session.last_trace])
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
    waits = _WAITING.get(kind)
    if waits is not None:
        raise errors.NotSupportedError(f"SHOW {kind} waits for {waits}")
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
