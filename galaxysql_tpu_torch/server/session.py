"""Session: statement dispatch (trimmed port of `galaxysql_tpu/server/session.py`).

Handles CREATE DATABASE, USE, CREATE TABLE, ANALYZE TABLE, SELECT, INSERT, UPDATE,
DELETE, TRUNCATE TABLE and BEGIN / COMMIT / ROLLBACK.  A SELECT goes parse -> bind ->
optimise -> plan on the host (the planner and its plan cache), then through the
operator tree on the instance's device; the compacted result batch comes back as
rows.  ANALYZE builds the statistics on the host (`meta/statistics.py`).  Every
planned query runs on the instance's device: the reference's pinning of TP plans to
the host CPU is not carried over.

The point path is the reference's.  A planned TP statement of the shape `SELECT cols
FROM t WHERE key = ?` registers a PointPlan after its first run; re-executions of it
skip binder and planner.  With several point queries in flight they go to the
cross-session batch scheduler (`server/batch_scheduler.py`, one device program per
touched partition for the group); otherwise the sequential fast path runs, as in
the reference: a host key-get over the row store (the partition's sorted key index,
visibility at the session's snapshot, the output columns gathered on the host), with
no operator and no device work.  The reference's privilege check, shared MDL and
archive check on this path are absent, as the port has none of them (MDL comes with
DDL).

Transactions are the reference's TSO transactions under snapshot isolation: BEGIN
takes a snapshot timestamp that doubles as the transaction id; writes inside carry
provisional (-txn_id) stamps that only the owner sees; COMMIT stamps them with one
commit timestamp (`txn/xa.py`); a row another live transaction wrote, or one deleted
after the snapshot, cannot be written again (first writer wins, `TransactionError`).
The WHERE of UPDATE and DELETE and UPDATE's SET expressions run as the reference runs
them, `ExprCompiler(np)` over the partitions' host lanes, so the stored lanes equal
the reference's bit for bit; every read, including INSERT ... SELECT, runs on the
instance's device at the session's snapshot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Column
from galaxysql_tpu_torch.exec.operators import run_to_batch
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import ExprCompiler
from galaxysql_tpu_torch.meta.catalog import (ColumnMeta, IndexMeta, PartitionInfo,
                                              PartitionRouter, SINGLE, TableMeta)
from galaxysql_tpu_torch.meta.statistics import analyze_store
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.binder import Binder, Scope
from galaxysql_tpu_torch.plan.physical import ExecContext, build_operator
from galaxysql_tpu_torch.plan.rules import _col_lit_cmp, _lane_encode
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.lexer import split_statements
from galaxysql_tpu_torch.sql.parameterize import DecimalParam, parameterize
from galaxysql_tpu_torch.sql.parser import parse
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.txn.xa import participants_of
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors


@dataclasses.dataclass
class ResultSet:
    names: List[str]
    types: List[dt.DataType]
    rows: List[Tuple]
    affected: int = 0
    last_insert_id: int = 0
    info: str = ""
    # compacted result ColumnBatch (queries only), lanes on the instance's device
    batch: Any = None

    @property
    def is_query(self) -> bool:
        return bool(self.names)


def ok(affected: int = 0, info: str = "") -> ResultSet:
    return ResultSet([], [], [], affected, 0, info)


class Transaction:
    """TSO transaction: snapshot at begin, provisional (-txn_id) stamps on writes,
    finalized to a fresh commit timestamp at COMMIT."""

    def __init__(self, ts: int):
        self.snapshot_ts = ts
        self.txn_id = ts  # TSO values are unique; the snapshot doubles as txn id
        # (store, pid, start_row, n) appended ranges awaiting commit stamp
        self.inserted: List[Tuple[Any, int, int, int]] = []
        # (store, pid, row_ids, old_end_ts) provisional deletes
        self.deleted: List[Tuple[Any, int, np.ndarray, np.ndarray]] = []


class Session:
    _SELECT_RE = __import__("re").compile(
        r"^\s*(?:/\*.*?\*/\s*)*select\b", __import__("re").I | __import__("re").S)

    def __init__(self, instance: Instance, schema: Optional[str] = None):
        self.instance = instance
        self.conn_id = instance.allocate_conn_id()
        self.schema = schema
        self.last_trace: List[str] = []
        self.txn: Optional[Transaction] = None
        instance.sessions[self.conn_id] = self

    def execute(self, sql: str, params: Optional[list] = None) -> ResultSet:
        """Run statement(s); returns the LAST result."""
        results = self.execute_all(sql, params)
        return results[-1] if results else ok()

    def execute_all(self, sql: str, params: Optional[list] = None) -> List[ResultSet]:
        if ";" not in sql:
            return [self._execute_one(sql, params)] if sql.strip() else [ok()]
        stmts = split_statements(sql)
        return [self._execute_one(s, params) for s in stmts] if stmts else [ok()]

    def close(self):
        """Roll back an open transaction, then leave the instance."""
        try:
            if self.txn is not None:
                self._rollback()
        finally:
            self.instance.sessions.pop(self.conn_id, None)

    def _lock_fn(self, name: str, vals: list):
        raise errors.NotSupportedError(f"{name.upper()} is not supported by this engine")

    def _execute_one(self, sql: str, params: Optional[list]) -> ResultSet:
        if self._SELECT_RE.match(sql):
            # the plan cache keys on the parameterized text and carries the AST
            return self._run_query(None, sql, params)
        return self.execute_statement(parse(sql), sql, params)

    def execute_statement(self, stmt: ast.Statement, sql: str = "",
                          params: Optional[list] = None) -> ResultSet:
        if isinstance(stmt, (ast.Select, ast.SetOpSelect)):
            return self._run_query(stmt, sql, params)
        if isinstance(stmt, (ast.Insert, ast.Update, ast.Delete)):
            return self._run_dml(stmt, params)
        if isinstance(stmt, ast.CreateTable):
            return self._run_create_table(stmt)
        if isinstance(stmt, ast.TruncateTable):
            return self._run_truncate(stmt)
        if isinstance(stmt, ast.AnalyzeTable):
            return self._run_analyze(stmt)
        if isinstance(stmt, ast.CreateDatabase):
            self.instance.catalog.create_schema(stmt.name, stmt.if_not_exists)
            return ok()
        if isinstance(stmt, ast.UseDb):
            self.instance.catalog.schema(stmt.name)  # validates
            self.schema = stmt.name
            return ok()
        if isinstance(stmt, ast.Begin):
            self._begin()
            return ok()
        if isinstance(stmt, ast.Commit):
            self._commit()
            return ok()
        if isinstance(stmt, ast.Rollback):
            self._rollback()
            return ok()
        raise errors.NotSupportedError(f"statement {type(stmt).__name__}")

    def _require_schema(self) -> str:
        if not self.schema:
            raise errors.TddlError("No database selected")
        return self.schema

    def _snapshot_ts(self) -> int:
        if self.txn is not None:
            return self.txn.snapshot_ts
        return self.instance.tso.next_timestamp()

    def _run_query(self, stmt, sql: str, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        if sql and self.instance.point_plans:
            rs = self._try_point_exec(sql, params, schema)
            if rs is not None:
                return rs
        planner = self.instance.planner
        if sql:
            plan = planner.plan_select(sql, schema, params, self)
        else:
            plan = planner.bind_statement(stmt, schema, params or [], self)
        ctx = ExecContext(self.instance.stores, self._snapshot_ts(),
                          self.instance.device, self.instance.device_cache,
                          params=params or [],
                          txn_id=self.txn.txn_id if self.txn is not None else 0,
                          hints=getattr(plan, "hints", None))
        batch = run_to_batch(build_operator(plan.rel, ctx)).compact()
        rows = batch.to_pylist()
        self.last_trace = ctx.trace
        if plan.workload == "TP":
            self._register_point_plan(plan)
        return ResultSet(plan.display_names, [t for _, t, _ in plan.fields()], rows,
                         batch=batch)

    # -- point-plan fast path: archetypal `SELECT cols FROM t WHERE key = ?`
    # statements skip binder and planner on re-execution; the registered PointPlan
    # routes to the owning partition and reads index candidates on the host.

    def _register_point_plan(self, plan):
        if plan.spm_key is None or plan.param_count != 1 or \
                getattr(plan, "hints", None):
            return
        rel = plan.rel
        proj = rel if isinstance(rel, L.Project) else None
        inner = proj.child if proj is not None else rel
        if not (isinstance(inner, L.Filter) and isinstance(inner.child, L.Scan)):
            return
        scan = inner.child
        if scan.point_eq is None or scan.as_of is not None or \
                getattr(scan.table, "remote", None) is not None:
            return
        cond = inner.cond
        if not (isinstance(cond, ir.Call) and cond.op == "eq"):
            return
        cl = _col_lit_cmp(cond)
        if cl is None:
            return
        col, lit, _flip = cl
        id_to_col = {oid: c for oid, c in scan.columns}
        if id_to_col.get(col.name, "").lower() != scan.point_eq[0].lower():
            return
        bound = getattr(plan, "bound_params", None)
        b0 = bound[0] if bound else None
        if isinstance(b0, DecimalParam):
            b0 = b0.value
        if not bound or lit.value != b0:
            return  # the one param must BE the point key value
        out = []
        if proj is not None:
            for _name, e in proj.exprs:
                if not isinstance(e, ir.ColRef) or e.name not in id_to_col:
                    return
                out.append(id_to_col[e.name])
        else:
            out = [c for _, c in scan.columns]
        tm = scan.table
        pp = {
            "schema": tm.schema, "table": tm.name,
            "key_col": scan.point_eq[0], "out_cols": out,
            "names": list(plan.display_names),
            "types": [t for _, t, _ in plan.fields()],
            "schema_version": self.instance.catalog.schema_version,
        }
        if len(self.instance.point_plans) > 512:
            self.instance.point_plans.clear()
        self.instance.point_plans[plan.spm_key] = pp

    def _try_point_exec(self, sql: str, params: Optional[list],
                        schema: str) -> Optional[ResultSet]:
        p = parameterize(sql)
        key = (schema.lower(), p.cache_key)
        pp = self.instance.point_plans.get(key)
        if pp is None:
            return None
        if pp["schema_version"] != self.instance.catalog.schema_version:
            self.instance.point_plans.pop(key, None)
            return None
        # bracket the WHOLE point path (batched or sequential): the batch
        # scheduler's adaptive window keys off live point-query concurrency
        sched = self.instance.batch_scheduler
        sched.point_begin()
        try:
            return self._point_exec(pp, p, params, schema)
        finally:
            sched.point_end()

    def _point_exec(self, pp: dict, p, params: Optional[list],
                    schema: str) -> Optional[ResultSet]:
        vals = p.resolve(params or [])
        if len(vals) != 1:
            return None
        value = vals[0]
        if isinstance(value, DecimalParam):
            value = value.value
        try:
            tm = self.instance.catalog.table(pp["schema"], pp["table"])
            store = self.instance.store(pp["schema"], pp["table"])
        except (errors.TddlError, KeyError):
            return None
        key_col = pp["key_col"]
        t0 = time.perf_counter()
        if value is None:
            rows = []  # eq NULL matches nothing
        else:
            lane_val = _lane_encode(tm, key_col, value)
            if lane_val is None:
                return None
            # cross-session batching: coalesce with other sessions executing this
            # same parameterized statement (None -> run it here)
            brs = self._try_batched_point(pp, p, lane_val, schema)
            if brs is not None:
                return brs
            rows = self._point_get(tm, store, key_col, lane_val, pp["out_cols"])
        self.last_trace = [f"point-plan {pp['table']}.{key_col}",
                           f"elapsed={time.perf_counter() - t0:.6f}s workload=TP"]
        self.instance.count("point_plan_queries")
        return ResultSet(pp["names"], pp["types"], rows)

    def _point_get(self, tm: TableMeta, store, key_col: str, lane_val,
                   out_cols: List[str]) -> List[Tuple]:
        """Host key-get over the row store: the owning partition's index
        candidates, their validity and visibility at the session's snapshot,
        then the output columns gathered and decoded."""
        # route in LANE domain: hash routing keys off the lane values.  int()
        # matches route_rows' astype(int64) truncation of float lanes, so a float
        # key routes to the shard it was written to
        pids = PartitionRouter(tm).prune_eq(key_col, int(lane_val))
        if pids is None:
            pids = range(len(store.partitions))
        snap = self._snapshot_ts()
        txn_id = self.txn.txn_id if self.txn is not None else 0
        rows: List[Tuple] = []
        for pid in pids:
            part = store.partitions[pid]
            if part.num_rows == 0:
                continue
            with part.lock:
                ids = part.key_rows(key_col, lane_val, snap, txn_id)
                if ids.size == 0:
                    continue
                cols = [Column(part.lanes[c][ids], part.valid[c][ids],
                               tm.column(c).dtype,
                               tm.dictionaries.get(c.lower())).to_pylist()
                        for c in out_cols]
            rows.extend(zip(*cols))
        return rows

    def _try_batched_point(self, pp: dict, psql, lane_val,
                           schema: str) -> Optional[ResultSet]:
        """Submit this point read to the cross-session batch scheduler
        (`server/batch_scheduler.py`).  Returns the scattered ResultSet, or None
        when the session must run the sequential path itself: batching disabled,
        arrival rate too low (window 0), singleton group, or a group-scope
        fallback.

        Snapshot semantics: a transaction holding ANY writes bypasses — its
        provisional (-txn_id) stamps need own-txn visibility the shared group
        program must not apply to other members.  A read-only transaction groups
        only with sessions pinned to the SAME snapshot (pinned_ts rides the group
        key); autocommit sessions share one flush-time TSO."""
        sched = self.instance.batch_scheduler
        if not sched.enabled():
            return None
        pinned = None
        if self.txn is not None:
            if self.txn.inserted or self.txn.deleted:
                return None  # own-txn writes: sequential own-visibility path
            pinned = self.txn.snapshot_ts
        gkey = (schema.lower(), psql.cache_key, pinned, pp["schema_version"])
        req = sched.submit(gkey, pp, lane_val, pinned)
        if req is None:
            return None
        if req.error is not None:
            raise req.error  # isolated to this session; group members proceed
        self.last_trace = req.trace
        return ResultSet(pp["names"], pp["types"], req.rows)

    # -- transactions -------------------------------------------------------------

    def _begin(self):
        if self.txn is None:
            self.txn = Transaction(self.instance.tso.next_timestamp())

    def _commit(self):
        """The TSO policy: one commit timestamp, then every touched store's
        participant stamps its provisional rows with it."""
        txn = self.txn
        self.txn = None
        if txn is None:
            return
        parts = participants_of(txn)
        commit_ts = self.instance.tso.next_timestamp()
        for sp in parts:
            sp.commit(commit_ts)
        if txn.inserted or txn.deleted:
            self.instance.catalog.version += 1

    def _rollback(self):
        txn = self.txn
        self.txn = None
        if txn is None:
            return
        # own appended rows are stamped permanently dead and provisional delete
        # stamps restored; lanes never shrink (see StoreParticipant.rollback)
        for sp in participants_of(txn):
            sp.rollback()

    def _dml_ts(self) -> Tuple[int, Optional[Transaction]]:
        """Timestamp to stamp writes with: provisional (-txn_id) inside a transaction,
        a real TSO value for autocommit single-statement writes."""
        if self.txn is not None:
            return -self.txn.txn_id, self.txn
        return self.instance.tso.next_timestamp(), None

    # -- DML ------------------------------------------------------------------------

    def _run_dml(self, stmt, params: Optional[list]) -> ResultSet:
        if isinstance(stmt, ast.Insert):
            if stmt.ignore or stmt.replace or stmt.on_dup_update:
                raise errors.NotSupportedError(
                    "INSERT IGNORE, REPLACE and ON DUPLICATE KEY UPDATE")
            return self._run_insert(stmt, params)
        if stmt.order_by or stmt.limit is not None:
            raise errors.NotSupportedError("ORDER BY or LIMIT in UPDATE and DELETE")
        if isinstance(stmt, ast.Update):
            return self._run_update(stmt, params)
        return self._run_delete(stmt, params)

    def _run_insert(self, stmt: ast.Insert, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(stmt.table.schema or schema, stmt.table.table)
        store = self.instance.store(tm.schema, tm.name)
        ts, txn = self._dml_ts()
        columns = stmt.columns or tm.column_names()
        if stmt.select is not None:
            # the SELECT runs on the instance's device at the session's snapshot
            sub = self._run_query(stmt.select, "", params)
            data = {c: [r[i] for r in sub.rows] for i, c in enumerate(columns)}
        else:
            binder = Binder(self.instance.catalog, schema, params or [])
            scope = Scope()
            data: Dict[str, List[Any]] = {c: [] for c in columns}
            for row in stmt.rows:
                if len(row) != len(columns):
                    raise errors.TddlError("Column count doesn't match value count")
                for c, v in zip(columns, row):
                    e = binder._bind_expr(v, scope)
                    if not isinstance(e, ir.Literal):
                        e = _fold_constant(e)
                    data[c].append(e.value)
        # normalize column name case
        data = {tm.column(c).name: vals for c, vals in data.items()}
        # a bad value fails here, before anything is appended
        lanes, valid, n = store.encode_pylists(data)
        with store.append_lock:
            before = [p.num_rows for p in store.partitions]
            store.append_encoded(lanes, valid, n, ts)
            ranges = [(pid, before[pid], p.num_rows - before[pid])
                      for pid, p in enumerate(store.partitions)
                      if p.num_rows - before[pid]]
        if txn is not None:
            for pid, start, added in ranges:
                txn.inserted.append((store, pid, start, added))
        tm.bump_version()
        self.instance.catalog.version += 1
        return ok(affected=n)

    def _dml_match(self, tm: TableMeta, where: Optional[ast.ExprNode],
                   params: Optional[list], alias: str):
        """Evaluate WHERE on the host lanes per partition -> (store, pid, row_ids)."""
        store = self.instance.store(tm.schema, tm.name)
        binder = Binder(self.instance.catalog, tm.schema, params or [])
        scope = Scope()
        fields = [(f"{alias}.{c.name}", c.dtype, tm.dictionaries.get(c.name.lower()))
                  for c in tm.columns]
        scope.add(alias, fields)
        pred = None
        if where is not None:
            cond = binder._bind_expr(where, scope)
            pred = ExprCompiler(np).compile_predicate(cond)
        ts = self._snapshot_ts()
        txn_id = self.txn.txn_id if self.txn is not None else 0
        for pid, p in enumerate(store.partitions):
            # visibility and lane references under the partition lock: an append
            # rebinds the lanes, and pre-append visibility over post-append lanes
            # would tear the read; the caller re-checks conflicts before stamping
            with p.lock:
                vis = p.visible_mask(ts, txn_id)
                env = {f"{alias}.{c.name}": (p.lanes[c.name], p.valid[c.name])
                       for c in tm.columns}
            if not vis.any():
                continue
            if pred is None:
                ids0 = np.nonzero(vis)[0]
                self._check_write_conflict(p, ids0)
                yield store, pid, ids0
                continue
            ids = np.nonzero(pred(env) & vis)[0]
            if ids.size:
                self._check_write_conflict(p, ids)
                yield store, pid, ids

    def _check_write_conflict(self, p, ids: np.ndarray):
        """First-writer-wins snapshot isolation: a row may be written again only
        while its end stamp is INFINITY (or our own provisional stamp).  A
        provisional -txn stamp means a live transaction holds it; a committed end
        stamp means a later committer already deleted it.  No lock waits, so no
        deadlocks."""
        own = -self.txn.txn_id if self.txn is not None else None
        pend = p.end_ts[ids]
        conflict = pend != INFINITY_TS
        if own is not None:
            conflict &= (pend != own)
        if conflict.any():
            raise errors.TransactionError(
                "write conflict: row locked or deleted by a concurrent transaction")

    def _run_delete(self, stmt: ast.Delete, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(stmt.table.schema or schema, stmt.table.table)
        ts, txn = self._dml_ts()
        alias = (stmt.table.alias or stmt.table.table).lower()
        n = 0
        for store, pid, ids in self._dml_match(tm, stmt.where, params, alias):
            p = store.partitions[pid]
            with p.lock:
                # re-check under the lock: the match and this stamp are otherwise
                # not atomic against other sessions
                self._check_write_conflict(p, ids)
                old_end = p.end_ts[ids].copy()
                p.delete_rows(ids, ts)
            if txn is not None:
                txn.deleted.append((store, pid, ids, old_end))
            n += ids.size
        tm.stats.row_count = max(tm.stats.row_count - n, 0)
        tm.bump_version()
        self.instance.catalog.version += 1
        return ok(affected=n)

    def _run_update(self, stmt: ast.Update, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        if not isinstance(stmt.table, ast.TableName):
            raise errors.NotSupportedError("multi-table UPDATE")
        tm = self.instance.catalog.table(stmt.table.schema or schema, stmt.table.table)
        ts, txn = self._dml_ts()
        alias = (stmt.table.alias or stmt.table.table).lower()
        binder = Binder(self.instance.catalog, schema, params or [])
        scope = Scope()
        fields = [(f"{alias}.{c.name}", c.dtype, tm.dictionaries.get(c.name.lower()))
                  for c in tm.columns]
        scope.add(alias, fields)
        sets: List[Tuple[str, Any]] = []
        for name, vexpr in stmt.sets:
            cm = tm.column(name.simple)
            e = binder._bind_expr(vexpr, scope)
            target = cm.dtype
            if target.is_string and isinstance(e, ir.Literal) \
                    and isinstance(e.value, str):
                # SET strcol = 'literal': encode into the column's dictionary
                # (growing it if new); the lane stores codes, not text
                d_ = tm.dictionaries[cm.name.lower()]
                code = np.asarray(d_.encode_one(e.value, add=True), np.int32)
                sets.append((cm.name, lambda env, _c=code: (_c, None)))
                continue
            if not (e.dtype.clazz == target.clazz and e.dtype.scale == target.scale) \
                    and e.dtype.clazz != dt.TypeClass.NULL and not target.is_string:
                e = ir.Cast(e, target)
            sets.append((cm.name, ExprCompiler(np).compile(e)))
        n = 0
        for store, pid, ids in self._dml_match(tm, stmt.where, params, alias):
            p = store.partitions[pid]
            # append_lock before the partition lock (every appender's order):
            # update_rows appends the new versions
            with store.append_lock, p.lock:
                self._check_write_conflict(p, ids)
                env = {f"{alias}.{c.name}": (p.lanes[c.name][ids], p.valid[c.name][ids])
                       for c in tm.columns}
                new_lanes: Dict[str, np.ndarray] = {}
                new_valid: Dict[str, np.ndarray] = {}
                for cname, fn in sets:
                    cm = tm.column(cname)
                    d, v = fn(env)
                    d = np.broadcast_to(np.asarray(d),
                                        (ids.size,)).astype(cm.dtype.lane)
                    vm = np.ones(ids.size, np.bool_) if v is None else \
                        np.broadcast_to(np.asarray(v), (ids.size,))
                    new_lanes[cm.name] = d
                    new_valid[cm.name] = vm.copy()
                old_end = p.end_ts[ids].copy()
                start = p.num_rows
                p.update_rows(ids, new_lanes, new_valid, ts)
                if txn is not None:
                    txn.deleted.append((store, pid, ids, old_end))
                    txn.inserted.append((store, pid, start, ids.size))
            n += ids.size
        tm.bump_version()
        self.instance.catalog.version += 1
        return ok(affected=n)

    def _run_truncate(self, stmt: ast.TruncateTable) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(stmt.name.schema or schema, stmt.name.table)
        self.instance.store(tm.schema, tm.name).truncate()
        tm.bump_version()
        self.instance.catalog.version += 1
        return ok()

    def _run_analyze(self, stmt: ast.AnalyzeTable) -> ResultSet:
        schema = self._require_schema()
        rows = []
        for name in stmt.names:
            tm = self.instance.catalog.table(name.schema or schema, name.table)
            # per-partition HLL sketches merged + equi-depth histograms, on the host
            analyze_store(tm, self.instance.store(tm.schema, tm.name))
            rows.append((f"{tm.schema}.{tm.name}", "analyze", "status", "OK"))
        self.instance.catalog.version += 1
        # the statistics epoch the plan baselines (`plan/spm.py`) key on
        self.instance.catalog.stats_version += 1
        return ResultSet(["Table", "Op", "Msg_type", "Msg_text"], [dt.VARCHAR] * 4, rows)

    def _run_create_table(self, stmt: ast.CreateTable) -> ResultSet:
        schema = stmt.name.schema or self._require_schema()
        if stmt.like is not None:
            src = self.instance.catalog.table(stmt.like.schema or schema,
                                              stmt.like.table)
            tm = TableMeta(schema, stmt.name.table, src.columns, src.primary_key,
                           src.partition, src.indexes)
        else:
            cols = []
            pk = list(stmt.primary_key)
            for cd in stmt.columns:
                typ = dt.from_sql_name(
                    cd.type_name + (" UNSIGNED" if cd.unsigned else ""),
                    cd.precision, cd.scale)
                default = None
                if cd.default is not None and not isinstance(cd.default, ast.NullLit):
                    default = _ast_literal_value(cd.default)
                cols.append(ColumnMeta(cd.name, typ, cd.nullable and not cd.primary_key,
                                       default, cd.auto_increment, cd.comment))
                if cd.primary_key:
                    pk.append(cd.name)
            part = _partition_info(stmt, cols)
            indexes = [IndexMeta(i.name or f"i_{k}", i.columns, i.unique,
                                 i.global_index, i.covering)
                       for k, i in enumerate(stmt.indexes) if i.columns]
            tm = TableMeta(schema, stmt.name.table, cols, pk, part, indexes,
                           stmt.comment)
        if self.instance.catalog.add_table(tm, stmt.if_not_exists):
            self.instance.register_table(tm)
        return ok()


def _fold_constant(e: ir.Expr) -> ir.Literal:
    f = ExprCompiler(np).compile(e)
    d, v = f({})
    if v is not None and not np.all(np.asarray(v)):
        return ir.Literal(None, e.dtype)
    val = np.asarray(d).item()
    if e.dtype.clazz == dt.TypeClass.DECIMAL:
        val = val / (10 ** e.dtype.scale)
    return ir.Literal(val, e.dtype)


def _partition_info(stmt: ast.CreateTable, cols: List[ColumnMeta]) -> PartitionInfo:
    if stmt.broadcast:
        return PartitionInfo("broadcast")
    if stmt.single or stmt.partition is None:
        return SINGLE
    p = stmt.partition
    colnames = []
    for e in p.exprs:
        if isinstance(e, ast.Name):
            colnames.append(e.simple)
        else:
            raise errors.NotSupportedError("partition expressions must be columns")
    boundaries = []
    by_name = {c.name.lower(): c for c in cols}
    for pname, vals in p.boundaries:
        enc = []
        for v in vals:
            if isinstance(v, ast.Name) and v.simple.upper() == "MAXVALUE":
                enc.append(None)
            else:
                lit = _ast_literal_value(v)
                cm = by_name.get(colnames[0].lower())
                from galaxysql_tpu_torch.meta.catalog import encode_partition_value
                enc.append(encode_partition_value(lit, cm.dtype) if cm else lit)
        boundaries.append((pname, enc))
    count = p.count or (len(boundaries) if boundaries else 8)
    return PartitionInfo(p.method, colnames, count, boundaries)


def _ast_literal_value(e: ast.ExprNode):
    if isinstance(e, ast.NumberLit):
        return e.value
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.BoolLit):
        return 1 if e.value else 0
    if isinstance(e, ast.Unary) and e.op == "-":
        return -_ast_literal_value(e.arg)
    if isinstance(e, ast.Func):
        return str(e.name)
    if isinstance(e, ast.DateLit):
        return e.value
    raise errors.NotSupportedError("expected literal value")
