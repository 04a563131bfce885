"""GMS: the metadata store (sqlite-backed metadb).

Reference analog: `polardbx-gms` + the GMS metadb (SURVEY.md §2.8, Appendix B) — system
tables for schemata/tables/columns/partitions, the DDL job queue, config listener rows,
sequences, and node info.  The reference fronts a MySQL fork; an embedded sqlite file
plays that role here (the CN is the unit of deployment; multi-host GMS goes behind gRPC
in a later round — the accessor API is the seam).

Implements:
- catalog persistence: save/load the full Catalog + auto-increment state
- the DDL engine tables (`ddl_engine`, `ddl_engine_task`) used by ddl/jobs.py
- `config_listener`: dataId + op_version rows polled for change propagation
  (`MetaDbConfigManager` analog, §5.6)
- `sequence` ranges for GroupSequence (§2.6 sequences)
- `node_info` heartbeats (cluster registry, §2.7 discovery)
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from galaxysql_tpu_torch.meta.catalog import (Catalog, ColumnMeta, IndexMeta, PartitionInfo,
                                        TableMeta)
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils.lockdep import named_lock

_SCHEMA = """
CREATE TABLE IF NOT EXISTS schemata (
    schema_name TEXT PRIMARY KEY, created REAL);
CREATE TABLE IF NOT EXISTS tables (
    schema_name TEXT, table_name TEXT, meta_json TEXT, version INTEGER,
    auto_increment INTEGER, PRIMARY KEY (schema_name, table_name));
CREATE TABLE IF NOT EXISTS ddl_engine (
    job_id INTEGER PRIMARY KEY AUTOINCREMENT, schema_name TEXT, ddl_sql TEXT,
    state TEXT, job_json TEXT, created REAL, updated REAL);
CREATE TABLE IF NOT EXISTS ddl_engine_task (
    job_id INTEGER, task_id INTEGER, name TEXT, state TEXT, payload_json TEXT,
    PRIMARY KEY (job_id, task_id));
CREATE TABLE IF NOT EXISTS config_listener (
    data_id TEXT PRIMARY KEY, op_version INTEGER, updated REAL);
CREATE TABLE IF NOT EXISTS inst_config (
    param_key TEXT PRIMARY KEY, param_val TEXT);
CREATE TABLE IF NOT EXISTS sequence (
    schema_name TEXT, seq_name TEXT, next_value INTEGER, increment_by INTEGER,
    cache_size INTEGER, PRIMARY KEY (schema_name, seq_name));
CREATE TABLE IF NOT EXISTS node_info (
    node_id TEXT PRIMARY KEY, role TEXT, host TEXT, port INTEGER, heartbeat REAL);
CREATE TABLE IF NOT EXISTS global_tx_log (
    txn_id INTEGER PRIMARY KEY, state TEXT, commit_ts INTEGER, updated REAL);
CREATE TABLE IF NOT EXISTS views (
    schema_name TEXT, view_name TEXT, columns_json TEXT, view_sql TEXT,
    PRIMARY KEY (schema_name, view_name));
"""


def _type_to_json(t: dt.DataType) -> dict:
    return {"sql": t.sql_name(), "precision": t.precision, "scale": t.scale,
            "nullable": t.nullable}


def _type_from_json(j: dict) -> dt.DataType:
    name = j["sql"].split("(")[0]
    return dt.from_sql_name(name, j.get("precision", 0), j.get("scale", 0))


class MetaDb:
    """The metadb connection (thread-safe; one sqlite file or :memory:)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or ":memory:"
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        # named for the lockdep witness: rank 2 in the canonical order
        # (append_lock -> partition -> metadb); plain RLock when disarmed
        self._lock = named_lock("metadb")
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def execute(self, sql: str, params: Tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def query(self, sql: str, params: Tuple = ()) -> List[Tuple]:
        with self._lock:
            return list(self._conn.execute(sql, params))

    # -- catalog persistence -------------------------------------------------

    def save_table(self, tm: TableMeta):
        meta = {
            "columns": [{
                "name": c.name, "type": _type_to_json(c.dtype),
                "nullable": c.nullable, "default": c.default,
                "auto_increment": c.auto_increment, "comment": c.comment,
            } for c in tm.columns],
            "primary_key": tm.primary_key,
            "partition": {
                "method": tm.partition.method, "columns": tm.partition.columns,
                "count": tm.partition.count, "boundaries": tm.partition.boundaries,
                "bucket_map": tm.partition.bucket_map,
                "placement": tm.partition.placement,
            },
            "indexes": [{
                "name": i.name, "columns": i.columns, "unique": i.unique,
                "global": i.global_index, "covering": i.covering, "status": i.status,
            } for i in tm.indexes],
            "comment": tm.comment,
        }
        self.execute(
            "INSERT OR REPLACE INTO tables VALUES (?,?,?,?,?)",
            (tm.schema.lower(), tm.name.lower(), json.dumps(meta), tm.version,
             tm.auto_increment_next))

    def drop_table(self, schema: str, name: str):
        self.execute("DELETE FROM tables WHERE schema_name=? AND table_name=?",
                     (schema.lower(), name.lower()))

    def save_view(self, v):
        self.execute("INSERT OR REPLACE INTO views VALUES (?,?,?,?)",
                     (v.schema.lower(), v.name.lower(),
                      json.dumps(v.columns), v.sql))

    def drop_view(self, schema: str, name: str):
        self.execute("DELETE FROM views WHERE schema_name=? AND view_name=?",
                     (schema.lower(), name.lower()))

    def save_schema(self, name: str):
        self.execute("INSERT OR IGNORE INTO schemata VALUES (?,?)",
                     (name.lower(), time.time()))

    def drop_schema(self, name: str):
        self.execute("DELETE FROM schemata WHERE schema_name=?", (name.lower(),))
        self.execute("DELETE FROM tables WHERE schema_name=?", (name.lower(),))

    def load_catalog(self, catalog: Catalog) -> List[TableMeta]:
        """Rebuild catalog contents from the metadb; returns loaded table metas."""
        loaded: List[TableMeta] = []
        for (sname,) in self.query("SELECT schema_name FROM schemata"):
            catalog.create_schema(sname, if_not_exists=True)
        for sname, tname, meta_json, version, auto_inc in self.query(
                "SELECT schema_name, table_name, meta_json, version, auto_increment "
                "FROM tables"):
            meta = json.loads(meta_json)
            cols = [ColumnMeta(c["name"], _type_from_json(c["type"]), c["nullable"],
                               c.get("default"), c.get("auto_increment", False),
                               c.get("comment"))
                    for c in meta["columns"]]
            part = PartitionInfo(meta["partition"]["method"],
                                 meta["partition"]["columns"],
                                 meta["partition"]["count"],
                                 [tuple(b) for b in meta["partition"]["boundaries"]],
                                 meta["partition"].get("bucket_map"),
                                 meta["partition"].get("placement") or [])
            idx = [IndexMeta(i["name"], i["columns"], i["unique"], i["global"],
                             i["covering"], status=i.get("status", "PUBLIC"))
                   for i in meta.get("indexes", [])]
            tm = TableMeta(sname, tname, cols, meta["primary_key"], part, idx,
                           meta.get("comment"))
            tm.version = version
            tm.auto_increment_next = auto_inc
            catalog.create_schema(sname, if_not_exists=True)
            catalog.add_table(tm, if_not_exists=True)
            loaded.append(tm)
        from galaxysql_tpu_torch.meta.catalog import ViewDef
        for sname, vname, cols_json, vsql in self.query(
                "SELECT schema_name, view_name, columns_json, view_sql FROM views"):
            catalog.create_schema(sname, if_not_exists=True)
            catalog.add_view(ViewDef(sname, vname, json.loads(cols_json), vsql),
                             or_replace=True)
        return loaded

    # -- config listener ------------------------------------------------------

    def notify(self, data_id: str):
        """Bump a dataId's op_version (the reference's MetaDbConfigManager.notify)."""
        self.execute(
            "INSERT INTO config_listener VALUES (?, 1, ?) "
            "ON CONFLICT(data_id) DO UPDATE SET op_version = op_version + 1, "
            "updated = excluded.updated", (data_id, time.time()))

    def versions(self) -> Dict[str, int]:
        return dict(self.query("SELECT data_id, op_version FROM config_listener"))

    # -- sequences --------------------------------------------------------------

    def sequence_next_range(self, schema: str, name: str, cache: int = 1000
                            ) -> Tuple[int, int]:
        """Grab [start, start+cache) atomically (GroupSequence range-grab)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT next_value, increment_by FROM sequence "
                "WHERE schema_name=? AND seq_name=?",
                (schema.lower(), name.lower())).fetchone()
            if row is None:
                self._conn.execute("INSERT INTO sequence VALUES (?,?,?,?,?)",
                                   (schema.lower(), name.lower(), 1, 1, cache))
                row = (1, 1)
            start, inc = row
            self._conn.execute(
                "UPDATE sequence SET next_value=? WHERE schema_name=? AND seq_name=?",
                (start + cache * inc, schema.lower(), name.lower()))
            self._conn.commit()
            return start, start + cache * inc

    # -- node registry -----------------------------------------------------------

    def heartbeat(self, node_id: str, role: str, host: str, port: int):
        self.execute("INSERT OR REPLACE INTO node_info VALUES (?,?,?,?,?)",
                     (node_id, role, host, port, time.time()))

    def alive_nodes(self, timeout_s: float = 30.0) -> List[Tuple]:
        cutoff = time.time() - timeout_s
        return self.query("SELECT node_id, role, host, port FROM node_info "
                          "WHERE heartbeat >= ?", (cutoff,))

    # -- global transaction log ----------------------------------------------------

    def kv_put(self, key: str, val: str):
        self.execute("INSERT OR REPLACE INTO inst_config VALUES (?,?)", (key, val))

    def kv_get(self, key: str) -> Optional[str]:
        rows = self.query("SELECT param_val FROM inst_config WHERE param_key=?",
                          (key,))
        return rows[0][0] if rows else None

    def kv_scan(self, prefix: str) -> List[Tuple[str, str]]:
        return self.query(
            "SELECT param_key, param_val FROM inst_config WHERE param_key LIKE ?",
            (prefix + "%",))

    def kv_delete(self, key: str):
        self.execute("DELETE FROM inst_config WHERE param_key=?", (key,))

    def tx_log_put(self, txn_id: int, state: str, commit_ts: int = 0):
        self.execute("INSERT OR REPLACE INTO global_tx_log VALUES (?,?,?,?)",
                     (txn_id, state, commit_ts, time.time()))

    def tx_log_put_many(self, entries):
        """Group-commit write: every (txn_id, state, commit_ts) entry lands
        in ONE sqlite transaction — the commit-point fsync amortized across
        a flush group of concurrent committers (txn/xa.GroupCommitGate)."""
        if not entries:
            return
        now = time.time()
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO global_tx_log VALUES (?,?,?,?)",
                [(tid, state, cts, now) for tid, state, cts in entries])
            self._conn.commit()

    def tx_log_get(self, txn_id: int) -> Optional[Tuple[str, int]]:
        rows = self.query("SELECT state, commit_ts FROM global_tx_log "
                          "WHERE txn_id=?", (txn_id,))
        return (rows[0][0], rows[0][1]) if rows else None


class ConfigListener:
    """Polls config_listener op_versions and fires callbacks on change (§5.6)."""

    def __init__(self, metadb: MetaDb):
        self.metadb = metadb
        self._known: Dict[str, int] = {}
        self._handlers: Dict[str, List] = {}
        self._lock = threading.Lock()

    def bind(self, data_id: str, handler):
        with self._lock:
            self._handlers.setdefault(data_id, []).append(handler)

    def poll(self) -> List[str]:
        """One poll cycle; returns fired dataIds."""
        current = self.metadb.versions()
        fired = []
        with self._lock:
            for data_id, ver in current.items():
                if self._known.get(data_id, 0) < ver:
                    self._known[data_id] = ver
                    fired.append(data_id)
                    for h in self._handlers.get(data_id, []):
                        h(data_id, ver)
        return fired
