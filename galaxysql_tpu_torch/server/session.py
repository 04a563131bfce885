"""Session: statement dispatch (trimmed port of `galaxysql_tpu/server/session.py`).

Handles CREATE DATABASE, USE, CREATE TABLE, ANALYZE TABLE, SELECT, INSERT, UPDATE,
DELETE, TRUNCATE TABLE, BEGIN / COMMIT / ROLLBACK, the session statements (SET in
session, user and global scope, SHOW (`server/show_handlers.py`), DESCRIBE, EXPLAIN
[ANALYZE], CREATE USER, DROP USER, GRANT, REVOKE, KILL) and DDL: DROP TABLE (into the
recycle bin while ENABLE_RECYCLEBIN is on), FLASHBACK TABLE ... TO BEFORE DROP [RENAME
TO], PURGE RECYCLEBIN / PURGE TABLE, DROP DATABASE, CREATE [OR REPLACE] VIEW, DROP
VIEW, ALTER TABLE (ADD/DROP COLUMN, ADD/DROP INDEX, RENAME), CREATE/DROP [UNIQUE|GLOBAL]
INDEX, ADVISE INDEX and LOAD DATA [LOCAL] INFILE (a server-side file, appended in
DML_BATCH_SIZE batches, GSIs maintained, nothing logged to the binlog: the
reference's), CREATE/DROP CCL_RULE, CREATE/DROP SLO and BASELINE DELETE/EVOLVE.
ALTER TABLE and the index statements run as jobs of the instance's `ddl_engine`
(`ddl/jobs.py`); the recycle bin and the advisor are `server/maintain.py`.  The
placement statements are the reference's: ALTER TABLE ... PARTITION BY (an online
repartition, `ddl/repartition.py`), SPLIT / MERGE / MOVE PARTITION (`ddl/rebalance.py`),
REBALANCE TABLE / DATABASE [DRY RUN] (`server/balancer.py`) and CHECK TABLE (with
each GSI's FastChecker checksum, `server/maintain.check_table`).  A statement that
carries the router's `/*trace:id:parent:node:sampled*/` prefix has it stripped before
the digest, and a traced query adopts its trace id and is kept by the trace store
when the router sampled it.  Every statement is
authorized as in the reference (`_authorize` against the instance's
`PrivilegeManager`); a query that reads `information_schema` refreshes its views
first (`server/information_schema.py`).  A SELECT goes parse -> bind ->
optimise -> plan on the host (the planner and its plan cache), then through the
operator tree on the instance's device; the compacted result batch comes back as
rows; the session's SORT_SPILL_BYTES and JOIN_SPILL_BYTES become the execution's
spill thresholds.  ANALYZE builds the statistics on the host (`meta/statistics.py`).
Every planned query runs on the instance's device: the reference's pinning of TP
plans to the host CPU is not carried over.

The engine dispatch is the reference's (`_try_mpp`): a query under the ENGINE(MPP)
hint, or an AP plan past MPP_MIN_AP_ROWS scanned rows while ENABLE_MPP holds, runs on
the instance's mesh through `parallel/mpp.MppExecutor`, and EXPLAIN ANALYZE reports
that engine; a plan shape MPP does not distribute (`NotSupportedError`) falls back to
the local engine, counted in `mpp_fallback_local` and traced as `mpp-fallback`.  An
instance on one device has no mesh, so it runs everything locally.

The point path is the reference's.  A planned TP statement of the shape `SELECT cols
FROM t WHERE key = ?` registers a PointPlan after its first run; re-executions of it
skip binder and planner.  With several point queries in flight they go to the
cross-session batch scheduler (`server/batch_scheduler.py`, one device program per
touched partition for the group); otherwise the sequential fast path runs, as in
the reference: a host key-get over the row store (the partition's sorted key index,
visibility at the session's snapshot, the output columns gathered on the host), with
no operator and no device work.  The reference's privilege check on this path is
kept, and so is its archive check: a table with archived rows takes the planned path.

Columnar routing is the reference's (`_maybe_route_columnar`): an autocommit query
whose every gate opens reads the columnar replica (`storage/columnar.py`) at the
minimum watermark of its tables' replicas instead of the row store.  The gates, in
order: the COLUMNAR hint, ENABLE_COLUMNAR_REPLICA, the GALAXYSQL_COLUMNAR environment
switch, no transaction, no AS OF, no remote table, no point scan unless
COLUMNAR(ON), the size signal, READY replicas of the tables' current columns, the
session's own last write below the watermark (read your writes), and
COLUMNAR_MAX_LAG_MS.  The size signal is the reference's: the statement summary's
observed rows examined of the digest, and for a digest it has not seen the
planner's estimate, against COLUMNAR_MIN_SCAN_ROWS.

Metadata locks are the reference's: every query, DML statement, sequential point
lookup and EXPLAIN ANALYZE holds a shared MDL (`meta/mdl.py`) on each table it reads
or writes for the statement's execution, and the schema-mutating DDL tasks take the
exclusive one, which waits for those statements and holds new ones back.  One repair
on the reference: a statement does not take a second shared lock on a table it
already holds (INSERT ... SELECT from its own table), which in the reference waits
behind a queued exclusive request until that request times out.

Global secondary indexes are maintained on the write path as in the reference:
INSERT appends the new rows to every WRITE_ONLY or PUBLIC GSI's table, DELETE stamps
the GSI rows of the deleted primary keys, UPDATE does both; the GSI rows carry the
base rows' (possibly provisional) stamps and register with the transaction, so COMMIT
and ROLLBACK finalize or undo them with the base rows.  Every write bumps the GSI
tables' versions with the base table's (`_note_write`), so no cached lane of a GSI
is served after a write.

The change log (`txn/cdc.py`) is the reference's: INSERT logs its appended rows,
DELETE the rows it deletes, UPDATE both images; an autocommit statement's events are
written at its timestamp, a transaction's buffer on it and are written by COMMIT at
the commit timestamp (all three commit paths), and ROLLBACK drops them.  TRUNCATE
logs nothing, as in the reference.

Batched point writes are the reference's (`server/dml_batch.py`): an autocommit
INSERT/UPDATE/DELETE whose shape registered a DML batch plan after a sequential run
skips parse and bind and goes to the cross-session DML batcher; its GSI work may go
to the async applier (`txn/async_apply.py`), and the session's next statement waits
for its own applies (`_apply_fence`).  A sequential DML on a GSI-bearing table waits
for every pending apply first (the global barrier).

Transactions are the reference's TSO transactions under snapshot isolation: BEGIN
takes a snapshot timestamp that doubles as the transaction id; writes inside carry
provisional (-txn_id) stamps that only the owner sees; COMMIT logs the commit point
in the metadb's transaction log through the group-commit gate, stamps them with its
commit timestamp and logs DONE, or under `TRANSACTION_POLICY = 'XA'` runs the
two-phase coordinator (`txn/xa.py`); a row another live transaction wrote, or one
deleted after the snapshot, cannot be written again (first writer wins,
`TransactionError`).

Writes to a remote table (one a worker process holds, `Instance.attach_remote_table`)
are the reference's (`_remote_dml`): the statement text ships to the worker, and to
every live replica, as a branch of the session's transaction keyed by its xid; an
autocommit statement is a one-statement transaction whose replica legs go to the
async applier; a transaction with branches always commits through the two-phase
coordinator, and its scans read through the branches (`ExecContext.remote_xids`).
Each such write bumps the table's fragment-cache epoch here and broadcasts it on the
sync bus, again once the transaction's outcome holds.  MAX_EXECUTION_TIME (the
session value or the statement hint) sets the statement's deadline, which the scans
and the worker RPCs honour (`QueryTimeoutError`).
The operations plane is the reference's.  Every query, DML statement and point
lookup (sequential or batched) carries a QueryProfile and a snapshot of the process
counters the statement summary attributes (`_ss0`, host-side reads); it passes the
admission gate (`server/admission.py`: a shed is a typed `ServerOverloadError` with
`retry_after_ms`) and, for a query, the CCL queue (`utils/ccl.py`), and a governed
query runs under a per-query memory pool (`exec/memory.query_pool`) whose pressure
tier scales its spill thresholds.  One exit ramp (`_finish_query`) records the
profile, the query metrics, the statement summary and the slow log, and a shed or
failed query records its partial profile and trace.  A plan bound under a heal
episode salts its fragment fingerprints (`heal_pin`) and reports its latency as a
probation sample; the verdict goes to the summary's `apply_heal_verdict`.  GET_LOCK
and RELEASE_LOCK hold the instance's `locks`, released when the session closes.
None of this reads a device tensor: only EXPLAIN ANALYZE and profiling
(ENABLE_QUERY_PROFILING) synchronize with the device.

The WHERE of UPDATE and DELETE and UPDATE's SET expressions run as the reference runs
them, `ExprCompiler(np)` over the partitions' host lanes, so the stored lanes equal
the reference's bit for bit; every read, including INSERT ... SELECT, runs on the
instance's device at the session's snapshot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import Column
from galaxysql_tpu_torch.ddl.jobs import alter_table_job, create_index_job, drop_index_job
from galaxysql_tpu_torch.exec import skew as _skew
from galaxysql_tpu_torch.exec.device_cache import TRANSFER_STATS
from galaxysql_tpu_torch.exec.runtime_filter import RuntimeFilterManager
from galaxysql_tpu_torch.exec.memory import query_pool
from galaxysql_tpu_torch.exec.operators import COMPILE_STATS, run_to_batch
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import ExprCompiler
from galaxysql_tpu_torch.meta.tso import LOGICAL_BITS
from galaxysql_tpu_torch.meta.catalog import (ColumnMeta, IndexMeta, PartitionInfo,
                                              PartitionRouter, SINGLE, TableMeta, ViewDef)
from galaxysql_tpu_torch.meta import statement_summary as _ss
from galaxysql_tpu_torch.meta.statistics import analyze_store
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.binder import Binder, Scope
from galaxysql_tpu_torch.plan.physical import (ExecContext, annotate_explain,
                                               build_operator)
from galaxysql_tpu_torch.plan.rules import _col_lit_cmp, _lane_encode, estimate_rows
from galaxysql_tpu_torch.server import dml_batch, information_schema
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.maintain import advise_indexes
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.lexer import split_statements
from galaxysql_tpu_torch.sql.hints import parse_hints
from galaxysql_tpu_torch.sql.parameterize import DecimalParam, parameterize
from galaxysql_tpu_torch.sql.parser import parse
from galaxysql_tpu_torch.storage import columnar as _col
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS, visible_rows
from galaxysql_tpu_torch.txn.xa import participants_of, remote_participants_of
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors, events, tracing
from galaxysql_tpu_torch.utils.ccl import GLOBAL_CCL, CclRule
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_SLO_LATENCY_MS
from galaxysql_tpu_torch.utils.metrics import QUERY_TIMEOUTS


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
        # binlog events buffered until COMMIT (`txn/cdc.py`); ROLLBACK drops them
        self.cdc_events: List[tuple] = []
        # worker branches of this txn: (host, port) -> xid, committed through the
        # 2PC coordinator
        self.remote: Dict[Tuple[str, int], str] = {}
        # (schema, table) of the worker-held tables this txn wrote: their fragment
        # epochs bump again once the outcome is applied
        self.remote_tables: set = set()

    def touched_tables(self):
        """The stores this transaction wrote (provisional rows visible to it only)."""
        seen = {}
        for store, *_ in self.inserted + self.deleted:
            seen[id(store)] = store
        return seen.values()


def gsi_targets(instance, tm):
    """(index, GSI table, GSI store) of each WRITE_ONLY or PUBLIC global index."""
    out = []
    for i in tm.indexes:
        if i.global_index and i.status in ("WRITE_ONLY", "PUBLIC"):
            gsi_name = f"{tm.name}${i.name}"
            try:
                gtm = instance.catalog.table(tm.schema, gsi_name)
                out.append((i, gtm, instance.store(tm.schema, gsi_name)))
            except (errors.UnknownTableError, KeyError):
                pass
    return out


def gsi_write_rows(instance, tm, base_store, pid: int, start: int, n: int,
                   ts: int, txn):
    """Propagate base rows appended at [start, start+n) of partition `pid` into
    every GSI store, with the same (possibly provisional) stamp; inside a
    transaction they register with it."""
    targets = gsi_targets(instance, tm)
    if not targets or n == 0:
        return
    p = base_store.partitions[pid]
    for _i, gtm, gstore in targets:
        cols = gtm.column_names()
        lanes = {c: p.lanes[c][start:start + n] for c in cols}
        valid = {c: p.valid[c][start:start + n] for c in cols}
        pids = gstore._route(lanes)
        # the GSI store's append_lock: another writer's appends must not fall
        # inside this writer's (before, append) range
        with gstore.append_lock:
            for gp in np.unique(pids):
                sel = np.nonzero(pids == gp)[0]
                gpart = gstore.partitions[int(gp)]
                before = gpart.num_rows
                gpart.append({k: v[sel] for k, v in lanes.items()},
                             {k: v[sel] for k, v in valid.items()}, ts)
                if txn is not None:
                    txn.inserted.append((gstore, int(gp), before, sel.size))


def _pk_void(arrays: List[np.ndarray]) -> np.ndarray:
    """Parallel key arrays packed into one comparable lane (exact tuple matching:
    per-column isin would match the cross product of composite keys)."""
    return np.rec.fromarrays(arrays)


def gsi_delete(instance, tm, base_store, pid: int, row_ids: np.ndarray,
               ts: int, txn):
    """Stamp the GSI rows of deleted base rows, matched on the primary key.  A
    one-column key is looked up in each GSI partition's sorted key index
    (`Partition.key_candidates_many`); a composite one is matched over every row,
    as the reference matches both."""
    if not tm.primary_key:
        return
    targets = gsi_targets(instance, tm)
    if not targets:
        return
    p = base_store.partitions[pid]
    del_lanes = [p.lanes[c][row_ids] for c in tm.primary_key]
    del_keys = _pk_void(del_lanes) if len(del_lanes) > 1 else None
    for _i, gtm, gstore in targets:
        if not all(gtm.has_column(c) for c in tm.primary_key):
            continue
        for gp_id, gp in enumerate(gstore.partitions):
            if len(tm.primary_key) == 1:
                with gp.lock:
                    ids = gp.key_candidates_many(tm.primary_key[0], del_lanes[0])
                    ids = ids[visible_rows(gp.begin_ts[ids], gp.end_ts[ids], None)]
            else:
                vis = gp.visible_mask(None)
                keys = _pk_void([gp.lanes[c] for c in tm.primary_key])
                ids = np.nonzero(vis & np.isin(keys, del_keys))[0]
            if ids.size:
                if txn is not None:
                    txn.deleted.append((gstore, gp_id, ids, gp.end_ts[ids].copy()))
                gp.delete_rows(ids, ts)


class Session:
    # the bound wait of a replica's DML leg: a hung replica costs this, then goes
    # stale
    REPLICA_DML_TIMEOUT_S = 30.0
    _SELECT_RE = __import__("re").compile(
        r"^\s*(?:/\*.*?\*/\s*)*select\b", __import__("re").I | __import__("re").S)
    _DML_RE = __import__("re").compile(
        r"^\s*(?:insert|update|delete)\b", __import__("re").I)
    # the router's trace hint, `/*trace:<id>:<parent>:<node>:<0|1>*/`, prefixed
    # onto a routed statement: parsed and stripped before the digest and the
    # parameterization, so plan-cache keys and digests never split per trace id
    _TRACE_HINT_RE = __import__("re").compile(
        r"^/\*trace:(\d+):(\d+):([^:*]*):([01])\*/\s*")

    def __init__(self, instance: Instance, schema: Optional[str] = None):
        self.instance = instance
        self.conn_id = instance.allocate_conn_id()
        self.schema = schema
        self.autocommit = True
        self.txn: Optional[Transaction] = None
        self.vars: Dict[str, Any] = {}
        self.user_vars: Dict[str, Any] = {}
        self.user = "root"
        self.last_trace: List[str] = []
        self.last_op_stats: List[dict] = []
        # the router's trace hint of the current statement: (trace id, parent span
        # id, origin node, sampled), None for a statement that originates here
        self._trace_hint: Optional[tuple] = None
        # tables this session's running statement holds a shared MDL on
        self._mdl_held: set = set()
        # commit timestamp of this session's last COMMIT
        self._last_commit_ts = 0
        # the async applier's watermark of this session's own batched writes
        self._apply_mark = 0
        # per-statement MAX_EXECUTION_TIME deadline (absolute seconds, None = none)
        self._deadline: Optional[float] = None
        # the statement in flight's (text, ParameterizedSql), `_parameterized`
        self._pmemo = None
        # the running statement's text and parameters (a write to a remote table
        # ships them to the worker, which plans the statement again)
        self._current_sql = ""
        self._current_params: Optional[list] = None
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
        """Roll back an open transaction, then leave the instance.  A failed
        rollback must not leak the session's advisory locks or its registry
        entry, nor vanish silently: it lands in the event journal."""
        try:
            if self.txn is not None:
                self._rollback()
        except Exception as rex:
            events.publish(
                "session_close_failed",
                f"rollback on session close failed for conn "
                f"{self.conn_id}: {type(rex).__name__}: {rex}",
                severity="warn", node=self.instance.node_id)
        finally:
            self.instance.locks.release_all(self.conn_id)
            self.instance.sessions.pop(self.conn_id, None)

    @contextlib.contextmanager
    def _mdl_shared(self, keys):
        """Statement-scope shared MDL on `keys` (`Instance.store_key`s).  A key the
        statement already holds is not taken again: behind a queued exclusive
        request a second shared request waits for the DDL that waits for the
        first."""
        new = set(keys) - self._mdl_held
        with self.instance.mdl.shared(new):
            self._mdl_held |= new
            try:
                yield
            finally:
                self._mdl_held -= new

    def _scan_keys(self, rel) -> set:
        """MDL keys of every table a plan scans."""
        return {self.instance.store_key(n.table.schema, n.table.name)
                for n in L.walk(rel) if isinstance(n, L.Scan)}

    def _lock_fn(self, name: str, vals: list):
        """The GET_LOCK family over the instance's `utils/locks.py` manager."""
        lm = self.instance.locks
        key = str(vals[0])
        if name == "get_lock":
            timeout = float(vals[1]) if len(vals) > 1 else 0.0
            return lm.get_lock(key, timeout, self.conn_id)
        if name == "release_lock":
            return lm.release_lock(key, self.conn_id)
        if name == "is_free_lock":
            return lm.is_free_lock(key)
        return lm.is_used_lock(key)

    def _execute_one(self, sql: str, params: Optional[list]) -> ResultSet:
        if sql.startswith("/*trace:"):
            m = self._TRACE_HINT_RE.match(sql)
            if m is not None:
                self._trace_hint = (int(m.group(1)), int(m.group(2)),
                                    m.group(3), m.group(4) == "1")
                sql = sql[m.end():]
        elif self._trace_hint is not None:
            self._trace_hint = None  # a hint covers exactly one statement
        # statement deadline: MAX_EXECUTION_TIME = 0 (the default) keeps it None
        ms = self.instance.config.get("MAX_EXECUTION_TIME", self.vars)
        self._deadline = time.time() + ms / 1000.0 if ms else None
        if self._SELECT_RE.match(sql):
            # the plan cache keys on the parameterized text and carries the AST
            return self._run_query(None, sql, params)
        if self.txn is None and self.instance.dml_plans and \
                "/*" not in sql and self._DML_RE.match(sql):
            # the DML hot path: a registered batch plan runs without parse or bind,
            # coalesced with plan-identical statements of other sessions.  The
            # whole statement, batched or sequential, brackets the batcher's
            # in-flight count, the signal its adaptive window keys off
            sched = self.instance.dml_batch_scheduler
            sched.point_begin()
            try:
                rs = self._try_batched_dml(sql, params)
                if rs is not None:
                    return rs
                return self.execute_statement(parse(sql), sql, params)
            finally:
                sched.point_end()
        return self.execute_statement(parse(sql), sql, params)

    def _try_batched_dml(self, sql: str, params: Optional[list]) -> Optional[ResultSet]:
        """Submit this autocommit point DML to the cross-session write batcher.
        Returns the scattered result, or None when the session must run the
        sequential path (no plan, batching off, window closed, singleton group or
        a group-scope fallback)."""
        sched = self.instance.dml_batch_scheduler
        if not sched.enabled(self) or not self.schema:
            return None
        schema = self.schema
        p = parameterize(sql)
        key = (schema.lower(), p.cache_key)
        pp = self.instance.dml_plans.get(key)
        if pp is None:
            return None
        if pp["schema_version"] != self.instance.catalog.schema_version:
            self.instance.dml_plans.pop(key, None)
            return None
        try:
            vals = p.resolve(params or [])
        except Exception:
            return None
        # the privilege gate the sequential path applies to its statement
        priv = {"insert": "INSERT", "update": "UPDATE", "delete": "DELETE"}[pp["kind"]]
        self.instance.privileges.check(self.user, priv, pp["schema"], pp["table"])
        self._apply_fence()
        prof = tracing.QueryProfile(
            trace_id=self.instance.trace_ids.next(), sql=sql[:512],
            schema=schema, conn_id=self.conn_id, started_at=time.time())
        self._ss0 = _ss.counters_snapshot(self.instance)
        ticket = self.instance.admission.admit(self, sql)
        try:
            gkey = (schema.lower(), p.cache_key, pp["schema_version"])
            req = sched.submit(gkey, pp, vals, None, prof)
        except Exception:
            ticket.release(error=True)
            raise
        if req is None:
            # the sequential path admits the statement again
            ticket.release()
            return None
        if req.error is not None:
            ticket.release(error=True)
            raise req.error  # isolated to this session; the other members go on
        if req.apply_seq:
            self._apply_mark = max(self._apply_mark, req.apply_seq)
        # the leader finished the profile and the query metrics at scatter; the
        # member's tail is the summary record and the admission feedback
        self.last_trace = prof.trace
        self._summary_record(sql, prof, "TP", "dml_batch", req.affected)
        ticket.release(prof)
        return ok(affected=req.affected)

    def _apply_wait_s(self) -> float:
        # not `ms or default`: a configured 0 means never wait
        ms = self.instance.config.get("APPLY_WAIT_MS", self.vars)
        return (10_000.0 if ms is None else float(ms)) / 1000.0

    def _apply_fence(self):
        """Read-your-writes: wait (bounded) until this session's own async GSI
        applies have landed.  One int compare when idle."""
        mark = self._apply_mark
        if not mark:
            return
        applier = self.instance.applier
        if applier.applied_seq < mark:
            applier.wait_applied(mark, self._apply_wait_s())
        self._apply_mark = 0

    _PRIV_BY_STMT = {
        ast.Select: "SELECT", ast.SetOpSelect: "SELECT", ast.Insert: "INSERT",
        ast.Update: "UPDATE", ast.Delete: "DELETE", ast.CreateTable: "CREATE",
        ast.DropTable: "DROP", ast.TruncateTable: "DELETE", ast.AlterTable: "ALTER",
        ast.CreateView: "CREATE", ast.DropView: "DROP",
        ast.CreateIndex: "INDEX", ast.DropIndex: "INDEX", ast.LoadData: "INSERT",
        ast.CreateDatabase: "CREATE", ast.DropDatabase: "DROP",
        ast.CheckTable: "SELECT", ast.FlashbackTable: "CREATE",
        ast.PurgeRecycleBin: "DROP", ast.AdviseIndex: "SELECT",
        ast.Rebalance: "ALTER",
    }

    @staticmethod
    def _stmt_tables(node) -> List[ast.TableName]:
        """Every TableName a statement references (joins and subqueries included)."""
        out: List[ast.TableName] = []
        seen = set()

        def walk(x):
            if id(x) in seen or x is None:
                return
            seen.add(id(x))
            if isinstance(x, ast.TableName):
                out.append(x)
                return
            if isinstance(x, ast.Node) and hasattr(x, "__dataclass_fields__"):
                for f in x.__dataclass_fields__:
                    walk(getattr(x, f))
            elif isinstance(x, (list, tuple)):
                for item in x:
                    walk(item)
        walk(node)
        return out

    def _authorize(self, stmt: ast.Statement):
        pm = self.instance.privileges
        if isinstance(stmt, (ast.CreateUser, ast.DropUser, ast.GrantStmt,
                             ast.RevokeStmt)):
            # account administration requires the super user
            if not pm.is_super(self.user):
                raise errors.AccessDeniedError(
                    f"user administration denied to '{self.user}'")
            return
        priv = self._PRIV_BY_STMT.get(type(stmt))
        if priv is None:
            return
        if isinstance(stmt, (ast.CreateDatabase, ast.DropDatabase)):
            pm.check(self.user, priv, stmt.name)
            return
        tables = self._stmt_tables(stmt)
        if not tables:
            pm.check(self.user, priv, self.schema or "*")
            return
        for t in tables:
            pm.check(self.user, priv, t.schema or self.schema or "*", t.table)

    def execute_statement(self, stmt: ast.Statement, sql: str = "",
                          params: Optional[list] = None) -> ResultSet:
        self._authorize(stmt)
        self._current_sql = sql
        self._current_params = params
        if isinstance(stmt, (ast.Select, ast.SetOpSelect)):
            return self._run_query(stmt, sql, params)
        if isinstance(stmt, (ast.Insert, ast.Update, ast.Delete)):
            return self._run_dml(stmt, sql, params)
        if isinstance(stmt, ast.CreateTable):
            return self._run_create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._run_drop_table(stmt)
        if isinstance(stmt, ast.CreateView):
            return self._run_create_view(stmt)
        if isinstance(stmt, ast.DropView):
            return self._run_drop_view(stmt)
        if isinstance(stmt, ast.TruncateTable):
            return self._run_truncate(stmt)
        if isinstance(stmt, ast.AnalyzeTable):
            return self._run_analyze(stmt)
        if isinstance(stmt, ast.CheckTable):
            return self._run_check_table(stmt)
        if isinstance(stmt, ast.CreateDatabase):
            self.instance.catalog.create_schema(stmt.name, stmt.if_not_exists)
            self.instance.metadb.save_schema(stmt.name)
            return ok()
        if isinstance(stmt, ast.DropDatabase):
            self.instance.recycle.purge_schema(stmt.name)
            self._drop_database(stmt)
            return ok()
        if isinstance(stmt, ast.FlashbackTable):
            return self._run_flashback_table(stmt)
        if isinstance(stmt, ast.PurgeRecycleBin):
            return ok(affected=self.instance.recycle.purge(stmt.name))
        if isinstance(stmt, ast.AdviseIndex):
            return self._run_advise_index(stmt, params)
        if isinstance(stmt, ast.AlterTable):
            return self._run_alter(stmt, sql)
        if isinstance(stmt, ast.Rebalance):
            return self._run_rebalance(stmt)
        if isinstance(stmt, (ast.CreateIndex, ast.DropIndex)):
            return self._run_index_ddl(stmt, sql)
        if isinstance(stmt, ast.KillStmt):
            return ok(info="kill acknowledged")
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
        if isinstance(stmt, ast.SetStmt):
            return self._run_set(stmt)
        if isinstance(stmt, ast.Show):
            return self._run_show(stmt)
        if isinstance(stmt, ast.Explain):
            return self._run_explain(stmt, params)
        if isinstance(stmt, ast.Describe):
            return self._describe(stmt.table)
        if isinstance(stmt, ast.CreateUser):
            self.instance.privileges.create_user(stmt.user, stmt.password,
                                                 if_not_exists=stmt.if_not_exists)
            return self._sync_privileges()
        if isinstance(stmt, ast.DropUser):
            self.instance.privileges.drop_user(stmt.user, stmt.if_exists)
            return self._sync_privileges()
        if isinstance(stmt, ast.GrantStmt):
            schema = self._require_schema() if stmt.schema == "" else stmt.schema
            self.instance.privileges.grant(stmt.user, stmt.privileges, schema,
                                           stmt.table)
            return self._sync_privileges()
        if isinstance(stmt, ast.RevokeStmt):
            schema = self._require_schema() if stmt.schema == "" else stmt.schema
            self.instance.privileges.revoke(stmt.user, stmt.privileges, schema,
                                            stmt.table)
            return self._sync_privileges()
        if isinstance(stmt, ast.LoadData):
            return self._run_load_data(stmt)
        if isinstance(stmt, ast.CreateCclRule):
            if any(st.rule.name.lower() == stmt.name.lower()
                   for st in GLOBAL_CCL.rules()):
                # replacing a live rule would zero its counters and orphan its
                # in-flight admissions: an error unless IF NOT EXISTS
                if stmt.if_not_exists:
                    return ok()
                raise errors.TddlError(f"CCL rule '{stmt.name}' already exists")
            GLOBAL_CCL.add_rule(CclRule(
                stmt.name, stmt.max_concurrency, stmt.keyword, stmt.user,
                stmt.wait_queue_size, stmt.wait_timeout_ms))
            return ok()
        if isinstance(stmt, ast.DropCclRule):
            if not GLOBAL_CCL.drop_rule(stmt.name) and not stmt.if_exists:
                raise errors.TddlError(f"unknown CCL rule '{stmt.name}'")
            return ok()
        if isinstance(stmt, ast.CreateSlo):
            self.instance.slo.create_sql(stmt)
            return ok()
        if isinstance(stmt, ast.DropSlo):
            self.instance.slo.drop_sql(stmt.name, stmt.if_exists)
            return ok()
        if isinstance(stmt, ast.BaselineStmt):
            return self._run_baseline(stmt)
        raise errors.NotSupportedError(f"statement {type(stmt).__name__}")

    def _sync_privileges(self) -> ResultSet:
        """After a user or grant change: peer coordinators share the metadb but keep
        their own privilege decision caches, so the drop is broadcast (workers
        ignore the action)."""
        self.instance.sync_bus.broadcast("invalidate_privilege_cache", {})
        return ok()

    def _note_remote_write(self, schema: str, table: str):
        """A worker-held table changed: bump its fragment epoch here and on every
        node of the sync bus (workers and peer coordinators)."""
        self.instance.frag_cache.bump_epoch(self.instance.store_key(schema, table))
        self.instance.sync_bus.broadcast(
            "invalidate_fragment_cache", {"schema": schema, "table": table})

    def _require_schema(self) -> str:
        if not self.schema:
            raise errors.TddlError("No database selected")
        return self.schema

    def _snapshot_ts(self) -> int:
        if self.txn is not None:
            return self.txn.snapshot_ts
        return self.instance.tso.next_timestamp()

    def _profiling_enabled(self) -> bool:
        return bool(self.instance.config.get("ENABLE_QUERY_PROFILING", self.vars))

    def _tracing_enabled(self) -> bool:
        # always on by default (host-side ramp timestamps only); the
        # GALAXYSQL_TRACING=0 environment switch or the parameter turn it off
        return tracing.ALWAYS_ON and bool(
            self.instance.config.get("ENABLE_QUERY_TRACING", self.vars))

    def _parameterized(self, sql: str):
        """`parameterize(sql)`, kept for the statement in flight: the admission
        gate, the trace sampler, the summary and the slow log each ask for the
        same text's digest, and the module's own memo skips texts past 4 KB (a
        multi-row INSERT would be tokenized once per asker)."""
        memo = self._pmemo
        if memo is not None and memo[0] is sql:
            return memo[1]
        p = parameterize(sql)
        self._pmemo = (sql, p)
        return p

    def _digest_of(self, sql: str, schema: str = "") -> str:
        """Statement digest of a raw SQL text ('' for internal statements)."""
        if not sql or sql.startswith("<"):
            return ""
        return _ss.digest_key((schema or self.schema or "").lower(),
                              self._parameterized(sql).parameterized)

    def _summary_record(self, sql: str, prof, workload: str, engine: str,
                        rows: int, plan=None, error: bool = False):
        """Feed the statement-summary store from the exit ramps: host-side adds,
        the counter deltas against the snapshot taken at the statement's entry."""
        if not sql or sql.startswith("<"):
            return
        ss = self.instance.stmt_summary
        if not ss.on(self.vars):
            return
        p = self._parameterized(sql)
        if engine in ("point", "batch"):
            fp, orders = "point", ""  # both serve the cached PointPlan shape
        elif engine in ("dml", "dml_batch"):
            fp, orders = "dml", ""  # write statements have no join order
        elif error and plan is None:
            fp, orders = "unknown", ""
        else:
            fp = _ss.plan_fingerprint(plan)
            orders = _ss.encode_orders(getattr(plan, "join_orders", None))
        ss.record(prof.schema, p.parameterized, sql, fp, orders, workload,
                  engine, prof.elapsed_ms, rows,
                  rows_examined=int(getattr(plan, "scanned_rows", 0) or 0),
                  error=error, peak_rss_kb=prof.peak_rss_kb,
                  extras=None if error else
                  _ss.counters_delta(getattr(self, "_ss0", None), self.instance))

    def _finish_query(self, sql: str, elapsed: float, prof, workload: str,
                      engine: str, rows: int, ctx=None, plan=None):
        """Every query's exit ramp, the reference's: fill and record the
        QueryProfile, bump the metrics, feed the statement summary and apply the
        slow-SQL gate.  Host-side reads and adds only: no device sync."""
        if FAIL_POINTS.active:
            # SLO-plane burn determinism: inflate the OBSERVED latency of matching
            # queries (no sleeping), so the histogram, the summary and the burn
            # windows all see the storm
            spec = FAIL_POINTS.value(FP_SLO_LATENCY_MS)
            if spec is not None:
                if isinstance(spec, dict):
                    wl_want = str(spec.get("workload", "") or "").upper()
                    sch_want = str(spec.get("schema", "") or "").lower()
                    if (not wl_want or wl_want == (workload or "").upper()) \
                            and (not sch_want or sch_want ==
                                 (prof.schema or "").lower()):
                        elapsed += float(spec.get("ms", 0.0)) / 1000.0
                else:
                    elapsed += float(spec) / 1000.0
        prof.workload = workload
        prof.engine = engine
        prof.rows = rows
        prof.elapsed_ms = round(elapsed * 1000, 3)
        if ctx is not None:
            prof.profiled = bool(getattr(ctx, "collect_stats", False))
            if prof.profiled:
                prof.op_stats = list(ctx.op_stats)
            prof.trace = list(ctx.trace)
        # compile-phase attribution: the process-wide compile_ms delta across this
        # query (kernel builds; absent in steady state)
        c0 = getattr(self, "_compile_ms0", None)
        if c0 is not None:
            cms = COMPILE_STATS["compile_ms"] - c0
            if cms > 0.0:
                prof.phases["compile"] = round(cms, 3)
        inst = self.instance
        slow_ms = inst.config.get("SLOW_SQL_MS", self.vars)
        # 0 logs every query (MySQL long_query_time=0); negative disables
        is_slow = (slow_ms is not None and slow_ms >= 0 and elapsed * 1000 >= slow_ms)
        digest = self._digest_of(sql, prof.schema)
        rt = None
        store = inst.trace_store
        if prof.traced and (prof.spans or is_slow):
            if prof.spans and prof.phases:
                prof.spans[0].attrs["phases"] = dict(prof.phases)
            hint = self._trace_hint
            rt = store.offer(prof, digest, slow=bool(is_slow),
                             forced=bool(hint is not None and hint[3]))
        if prof.profiled or rt is not None:
            try:
                import resource
                prof.peak_rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            except Exception:  # galaxylint: disable=swallow -- a non-POSIX host: the profile lacks the memory datapoint
                pass
        inst.profiles.record(prof)
        lat_h, q_total, q_wl, q_eng = inst.finish_handles(workload, engine)
        lat_h.observe(elapsed * 1000)
        q_total.inc()
        q_wl.inc()
        q_eng.inc()
        tracing.GLOBAL_STATS.bump("queries")
        self._summary_record(sql, prof, workload, engine, rows, plan)
        if is_slow:
            tracing.SLOW_LOG.record(sql or "<stmt>", elapsed, self.conn_id,
                                    trace_id=prof.trace_id, workload=workload,
                                    digest=digest)
            tracing.GLOBAL_STATS.bump("slow")
            inst.metrics.counter("slow_queries", "queries over SLOW_SQL_MS").inc()

    def _run_query(self, stmt, sql: str, params: Optional[list]) -> ResultSet:
        """The query ramp, the reference's: the read-your-writes fence, the
        profile and the counter snapshot, the trace context, the admission gate
        and the CCL queue, then `_run_query_admitted`; a shed or a failure
        leaves its profile, trace and summary record behind."""
        schema = self._require_schema()
        _pc = time.perf_counter
        f0 = _pc()
        self._apply_fence()
        fence_ms = (_pc() - f0) * 1000.0
        t0 = time.time()
        prof = tracing.QueryProfile(trace_id=self.instance.trace_ids.next(),
                                    sql=(sql or "<stmt>")[:512], schema=schema,
                                    conn_id=self.conn_id, started_at=t0)
        if fence_ms >= 0.05:  # steady state: the fence is one int compare
            prof.phases["fence_wait"] = round(fence_ms, 3)
        # the statement-summary counter bracket: host-side dict reads
        self._ss0 = _ss.counters_snapshot(self.instance)
        self._compile_ms0 = COMPILE_STATS["compile_ms"]
        info = "information_schema" in (sql or "").lower() or \
            schema.lower() == "information_schema"
        if info:
            information_schema.refresh(self.instance, self)
        # trace collection first, so even a shed query leaves a (tiny) tree
        tc = None
        if self._tracing_enabled():
            prof.traced = True
            store = self.instance.trace_store
            hint = self._trace_hint
            if hint is not None:
                # adopt the router's trace id: it pulls this id back over the sync
                # wire and grafts these spans under its route span
                prof.trace_id = hint[0]
                prof.sampled = hint[3]
                full = True
            else:
                # the always-on budget: one dict probe and one compare; sampled
                # queries build the full span tree, and an explicit session
                # opt-in always does (SHOW TRACE debugging)
                prof.sampled = store.sampler.decide(self._digest_of(sql, schema))
                full = prof.sampled or bool(self.vars.get("ENABLE_QUERY_TRACING"))
            if full:
                tc = tracing.TraceContext(prof.trace_id, node=self.instance.node_id)
                prof.spans = tc.spans
            else:
                self.last_spans = []
        else:
            self.last_spans = []
        ticket = None
        admission = None
        try:
            a0 = _pc()
            try:
                ticket = self.instance.admission.admit(self, sql or "")
            finally:
                # a shed query keeps its admission wait in its phases
                prof.phases["admission"] = round((_pc() - a0) * 1000, 3)
            q0 = _pc()
            try:
                admission = GLOBAL_CCL.admit(self, sql or "")
            finally:
                prof.phases["queue"] = round((_pc() - q0) * 1000, 3)
            if tc is None:
                return self._run_query_admitted(stmt, sql, params, schema, t0, prof,
                                                info)
            root = tc.begin("query", kind="query", sql=prof.sql[:128],
                            conn=self.conn_id, schema=schema)
            prev = tracing.swap_active(tc)
            try:
                rs = self._run_query_admitted(stmt, sql, params, schema, t0, prof,
                                              info)
            except BaseException as e:
                root.attrs["error"] = f"{type(e).__name__}: {e}"[:256]
                raise
            finally:
                tracing.swap_active(prev)
                tc.end(root)
            self._finish_trace(tc)
            return rs
        except errors.ServerOverloadError as e:
            self._record_query_shed(sql, t0, prof, e, tc)
            raise
        except Exception as e:
            self._record_query_error(sql, t0, prof, e, tc)
            raise
        finally:
            if admission is not None:
                admission.release()
            if ticket is not None:
                ticket.release(prof)

    def _finish_trace(self, tc):
        """Close out a traced query: stamp the allocator's peak on the root span
        (host-side allocator statistics, no device sync) and keep the tree for
        SHOW TRACE."""
        if tc.spans and self.instance.device.type == "cuda":
            dev = self.instance.device
            tc.spans[0].attrs["hbm_peak_bytes"] = {
                str(dev): int(torch.cuda.max_memory_allocated(dev))}
        self.last_spans = list(tc.spans)

    def _record_query_shed(self, sql, t0, prof, exc, tc):
        """Admission shed this query before execution: no error metrics (the
        admission plane counted and published the typed shed), but the phase
        attribution and the trace skeleton are kept."""
        elapsed = time.time() - t0
        prof.elapsed_ms = round(elapsed * 1000, 3)
        prof.error = f"{type(exc).__name__}: {exc}"[:512]
        if tc is not None:
            tc.add("shed", kind="error", parent=tc.root_id, **errors.span_attrs(exc))
            self._finish_trace(tc)
        inst = self.instance
        inst.profiles.record(prof)
        if prof.traced:
            if prof.spans and prof.phases:
                prof.spans[0].attrs["phases"] = dict(prof.phases)
            inst.trace_store.offer(prof, self._digest_of(sql, prof.schema), shed=True)
        self.last_trace = [f"trace-id {prof.trace_id}", f"shed {prof.error}",
                           f"elapsed={elapsed:.3f}s"]

    def _record_query_error(self, sql, t0, prof, exc, tc):
        """A query that dies mid-execution still records its profile (with the
        error), an error span closing its trace, its summary record and a
        slow-log entry when the time spent crosses the slow gate."""
        elapsed = time.time() - t0
        prof.elapsed_ms = round(elapsed * 1000, 3)
        prof.error = f"{type(exc).__name__}: {exc}"[:512]
        inst = self.instance
        if tc is not None:
            tc.add("error", kind="error", parent=tc.root_id, **errors.span_attrs(exc))
            self._finish_trace(tc)
        if prof.traced:
            if prof.spans and prof.phases:
                prof.spans[0].attrs["phases"] = dict(prof.phases)
            inst.trace_store.offer(prof, self._digest_of(sql, prof.schema))
        inst.profiles.record(prof)
        tracing.GLOBAL_STATS.bump("errors")
        inst.metrics.counter("query_errors", "queries failed mid-execution").inc()
        if isinstance(exc, errors.QueryTimeoutError):
            QUERY_TIMEOUTS.inc()
        self._summary_record(sql, prof, prof.workload or "TP", prof.engine, 0,
                             error=True)
        self.last_trace = [f"trace-id {prof.trace_id}", f"error {prof.error}",
                           f"elapsed={elapsed:.3f}s"]
        slow_ms = inst.config.get("SLOW_SQL_MS", self.vars)
        if slow_ms is not None and slow_ms >= 0 and elapsed * 1000 >= slow_ms:
            tracing.SLOW_LOG.record(sql or "<stmt>", elapsed, self.conn_id,
                                    trace_id=prof.trace_id, workload=prof.workload,
                                    error=type(exc).__name__,
                                    digest=self._digest_of(sql, prof.schema))
            tracing.GLOBAL_STATS.bump("slow")
            inst.metrics.counter("slow_queries", "queries over SLOW_SQL_MS").inc()

    def _run_query_admitted(self, stmt, sql, params, schema, t0, prof,
                            info: bool) -> ResultSet:
        if sql and self.instance.point_plans:
            rs = self._try_point_exec(sql, params, schema, t0, prof)
            if rs is not None:
                return rs
        planner = self.instance.planner
        p0 = time.perf_counter()
        if sql:
            plan = planner.plan_select(sql, schema, params, self)
        else:
            plan = planner.bind_statement(stmt, schema, params or [], self)
        prof.phases["plan"] = round((time.perf_counter() - p0) * 1000, 3)
        if stmt is None:
            # the SELECT hot path skipped the raw parse; authorize on the plan's
            # (parameterized) AST: the same table names, no second parse
            self._authorize(plan.statement)
        ctx = self._exec_context(plan, params)
        # resource governance (server/admission.py): memory-pressure tiers lower
        # the spill thresholds (NORMAL scale is 1.0), and a per-query pool child
        # charges join builds, agg partials and sort slabs against GLOBAL_POOL
        adm = self.instance.admission
        governed = adm.enabled(self, sql or "")
        if governed:
            scale = adm.governor.spill_scale()
            if scale != 1.0:
                ctx.sort_spill_bytes = int(ctx.sort_spill_bytes * scale)
                ctx.join_spill_bytes = int(ctx.join_spill_bytes * scale)
                ctx.agg_spill_bytes = int(ctx.agg_spill_bytes * scale)
        # the profile rides the context; stats collection (device syncs) only
        # when profiling is asked for
        ctx.profile = prof
        ctx.collect_stats = self._profiling_enabled()
        # large AP scans flip to the CDC-fed replica at a TSO watermark; TP point
        # reads and fresh-read sessions stay on the row store
        self._maybe_route_columnar(plan, ctx, sql, schema)
        if governed:
            # created just before the try that closes it, so an exception in
            # between cannot leak the child onto GLOBAL_POOL
            ctx.mem_pool = query_pool(
                self.conn_id,
                int(self.instance.config.get("QUERY_MEM_BYTES", self.vars)
                    or (4 << 30)))
        try:
            with self._mdl_shared(self._scan_keys(plan.rel)):
                return self._run_query_locked(plan, ctx, sql, t0, prof)
        finally:
            # the per-query pool releases what a failed operator left reserved
            # and leaves the global hierarchy
            if ctx.mem_pool is not None:
                ctx.mem_pool.close()

    def _run_query_locked(self, plan, ctx, sql, t0, prof) -> ResultSet:
        span_scope = tracing.SEGMENT_TRACER.scoped(prof.segments) \
            if ctx.collect_stats else contextlib.nullcontext()
        x0 = time.perf_counter()
        with span_scope:
            batch = self._try_mpp(plan, ctx, count=True)
            mpp_used = batch is not None
            if batch is None:
                batch = run_to_batch(build_operator(plan.rel, ctx))
        prof.phases["execute"] = round((time.perf_counter() - x0) * 1000, 3)
        s0 = time.perf_counter()
        batch = batch.compact()
        rows = batch.to_pylist()
        prof.phases["serialize"] = round((time.perf_counter() - s0) * 1000, 3)
        if plan.workload == "TP":
            self._register_point_plan(plan)
        elapsed = time.time() - t0
        if getattr(plan, "spm_key", None) is not None:
            # during PROBATION this execution is a heal verification sample; a
            # filled quota returns the episode's verdict.  Heal bookkeeping never
            # fails the user query: the result set is already computed
            try:
                verdict = self.instance.planner.spm.record_execution(
                    plan.spm_key, elapsed * 1000.0,
                    getattr(plan, "bound_params", None),
                    orders=plan.join_orders,
                    stats_version=self.instance.catalog.stats_version)
                if verdict is not None:
                    self.instance.stmt_summary.apply_heal_verdict(verdict)
            except Exception as heal_exc:  # pragma: no cover - defensive
                try:
                    self.instance.stmt_summary.heal_failures.inc()
                    self.instance.planner.spm.abort_heal(
                        plan.spm_key, f"verdict error {heal_exc!r}")
                    events.publish("plan_heal_failed",
                                   f"heal verdict error {heal_exc!r}",
                                   node=self.instance.node_id,
                                   reason="internal_error")
                except Exception:  # galaxylint: disable=swallow -- the journal itself failed; the query's result stands
                    pass
        self.last_trace = [f"trace-id {prof.trace_id}"] + ctx.trace + \
            [f"elapsed={elapsed:.3f}s workload={plan.workload}"]
        self._finish_query(sql, elapsed, prof, plan.workload,
                           "mpp" if mpp_used else "local", len(rows), ctx, plan=plan)
        return ResultSet(plan.display_names, [t for _, t, _ in plan.fields()], rows,
                         batch=batch)

    def _try_mpp(self, plan, ctx, count: bool):
        """Engine dispatch shared by real execution and EXPLAIN ANALYZE (which must
        report the engine users actually run): the MPP result batch, or None for the
        local engine.  MPP runs under the ENGINE(MPP) hint, or for an AP plan past
        MPP_MIN_AP_ROWS scanned rows while ENABLE_MPP holds, over the instance's
        mesh (None on one device).  `count` bumps `mpp_queries` /
        `mpp_fallback_local` (real executions only)."""
        engine_hint = getattr(plan, "hints", {}).get("engine")
        want_mpp = engine_hint == "MPP" or (
            engine_hint is None and plan.workload == "AP" and
            self.instance.config.get("ENABLE_MPP", self.vars) and
            plan.scanned_rows >= self.instance.config.get("MPP_MIN_AP_ROWS",
                                                          self.vars))
        if not want_mpp:
            return None
        mesh = self.instance.mesh()
        if mesh is None:
            return None
        from galaxysql_tpu_torch.parallel.mpp import MppExecutor
        try:
            batch = MppExecutor(ctx, mesh).execute(plan.rel)
            if count:
                self.instance.count("mpp_queries")
            return batch
        except (errors.NotSupportedError, errors.WorkerUnavailableError) as e:
            # a plan shape not distributed, or a worker died mid-MPP: the local
            # engine, never silently (the trace tag and
            # information_schema.engine_counters)
            if count:
                self.instance.count("mpp_fallback_local")
            ctx.trace.append(f"mpp-fallback {e}")
            # a fresh runtime-filter hub: the aborted MPP walk may have consumed
            # scan edges the local run must wire again
            ctx.rf = RuntimeFilterManager(hints=ctx.hints,
                                          metrics=self.instance.metrics)
            return None

    def _exec_context(self, plan, params: Optional[list]) -> ExecContext:
        """A query's context: the instance's device, the session's snapshot and
        transaction, and its spill thresholds (a governed query scales them under
        memory pressure in `_run_query_admitted`).  The engine is the reference's
        choice: an AP plan gets the device cache while ENABLE_TPU_ENGINE holds
        (instance, global or session scope); a TP plan, or any plan with the engine
        off, gets none, so its scans yield host batches that Filter, Project and
        fused segments run with numpy (`exec/operators.TP_HOST_ROWS`).  EXPLAIN
        ANALYZE takes its context from here too."""
        cache = None
        if plan.workload == "AP" and self.instance.config.get("ENABLE_TPU_ENGINE",
                                                              self.vars):
            cache = self.instance.device_cache
        ctx = ExecContext(self.instance.stores, self._snapshot_ts(),
                          self.instance.device, cache,
                          params=params or [],
                          txn_id=self.txn.txn_id if self.txn is not None else 0,
                          hints=getattr(plan, "hints", None),
                          archive=self.instance.archive, archive_instance=self.instance)
        ctx.sort_spill_bytes = self.instance.config.get("SORT_SPILL_BYTES", self.vars)
        ctx.join_spill_bytes = self.instance.config.get("JOIN_SPILL_BYTES", self.vars)
        # session-scoped SET ENABLE_SKEW_EXECUTION (the context's default only sees
        # instance scope)
        ctx.skew_modes = _skew.exec_modes(ctx.hints, self.instance, self.vars)
        # self-heal pin: plans bound under a live quarantine episode salt the
        # fragment-cache fingerprints ('' steady state)
        ctx.plan_pin = getattr(plan, "heal_pin", "")
        # MAX_EXECUTION_TIME: the hint overrides the session's value for this
        # statement
        hint_ms = (getattr(plan, "hints", None) or {}).get("max_execution_time")
        ctx.deadline = time.time() + hint_ms / 1000.0 if hint_ms else self._deadline
        if self.txn is not None:
            # the fragment cache bypasses any table this txn has uncommitted writes
            # on (provisional rows are visible to this session only)
            ctx.txn_write_uids = frozenset(st.uid for st in self.txn.touched_tables())
            ctx.remote_xids = dict(self.txn.remote)
        return ctx

    # -- columnar HTAP routing (storage/columnar.py) ---------------------------

    def _maybe_route_columnar(self, plan, ctx, sql="", schema=""):
        """Route this query's scans onto the columnar replica when every gate
        opens: hatch trio (COLUMNAR hint > ENABLE_COLUMNAR_REPLICA >
        GALAXYSQL_COLUMNAR env), autocommit read (no txn), no flashback, no
        remote tables, the estimated scan size clears COLUMNAR_MIN_SCAN_ROWS,
        every scanned table has a READY replica whose schema matches, the
        read-your-writes fence passes, and the routed watermark is inside the
        COLUMNAR_MAX_LAG_MS freshness SLA.  On route: snapshot_ts pins to the
        watermark and scans read ReplicaView snapshots."""
        if not _col.ENABLED:
            return
        hint = (ctx.hints or {}).get("columnar")
        if hint == "off":
            return
        mgr = self.instance.columnar
        if hint != "on" and not mgr.enabled(self):
            return
        if self.txn is not None or ctx.txn_id:
            return  # txn reads must see their own provisional rows
        scans = [n for n in L.walk(plan.rel) if isinstance(n, L.Scan)]
        if not scans:
            return
        for n in scans:
            if n.as_of is not None or \
                    getattr(n.table, "remote", None) is not None:
                return  # flashback / plan-shipped scans stay where they are
            if n.point_eq is not None and hint != "on":
                return  # TP index path: the row store's key-Get wins
        if hint != "on" and not self._columnar_signal(sql, schema, scans):
            return
        views = {}
        for n in scans:
            key = f"{n.table.schema.lower()}.{n.table.name.lower()}"
            if key in views:
                continue
            rep = mgr.replica(n.table.schema, n.table.name)
            if hint == "on" and (rep is None or rep.state != _col.READY):
                rep = mgr.ensure_ready(n.table.schema, n.table.name)
            elif rep is None:
                # the size signal fired: enroll asynchronously; this query (and
                # every one until READY) stays on the row store
                mgr.request(n.table.schema, n.table.name)
                return
            if rep.sig != tuple(n.table.column_names()):
                return  # DDL outran the tailer; reseed pending
            view = rep.view()
            if view is None:
                return
            views[key] = view
        # one snapshot timestamp for the whole query: the minimum watermark.
        # Every view serves any ts in [seed_ts, its watermark], so min(W) is
        # exact everywhere, unless a fresh seed starts above it.
        w = min(v.watermark for v in views.values())
        if w <= 0 or w < max(v.seed_ts for v in views.values()):
            return
        if getattr(self, "_last_commit_ts", 0) > w:
            return  # read-your-writes fence: this session wrote past W
        if hint != "on":
            max_lag = float(self.instance.config.get(
                "COLUMNAR_MAX_LAG_MS", self.vars) or 10_000)
            if time.time() * 1000.0 - (w >> LOGICAL_BITS) > max_lag:
                return  # freshness SLA blown: fall back to the row store
        ctx.snapshot_ts = w
        ctx.columnar = views
        mgr.routed.inc()

    def _columnar_signal(self, sql, schema, scans) -> bool:
        """Is this statement big enough for the replica?  The statement summary's
        observed rows examined of the digest first; a cold digest falls back to the
        planner's estimate, both against COLUMNAR_MIN_SCAN_ROWS."""
        min_rows = int(self.instance.config.get(
            "COLUMNAR_MIN_SCAN_ROWS", self.vars) or 50_000)
        if sql and not sql.startswith("<"):
            try:
                execs, avg_rx = self.instance.stmt_summary.digest_signal(
                    (schema or self.schema or "").lower(),
                    parameterize(sql).parameterized)
            except Exception:  # galaxylint: disable=swallow -- the size signal is advisory: a summary fault defers to the estimate below
                execs, avg_rx = 0, 0.0
            if execs > 0:
                return avg_rx >= min_rows
        est = 0
        for n in scans:
            try:
                est += int(estimate_rows(n) or 0)
            except Exception:  # galaxylint: disable=swallow -- estimate faults defer to "too small": mis-estimating must never fail a query
                pass
        return est >= min_rows

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

    def _try_point_exec(self, sql: str, params: Optional[list], schema: str,
                        t0: float, prof) -> Optional[ResultSet]:
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
            return self._point_exec(pp, p, sql, params, schema, t0, prof)
        finally:
            sched.point_end()

    def _point_exec(self, pp: dict, p, sql: str, params: Optional[list],
                    schema: str, t0: float, prof) -> Optional[ResultSet]:
        vals = p.resolve(params or [])
        if len(vals) != 1:
            return None
        # the privilege gate the planned path applies to its statement's AST
        self.instance.privileges.check(self.user, "SELECT",
                                       pp["schema"], pp["table"])
        value = vals[0]
        if isinstance(value, DecimalParam):
            value = value.value
        try:
            tm = self.instance.catalog.table(pp["schema"], pp["table"])
            store = self.instance.store(pp["schema"], pp["table"])
        except (errors.TddlError, KeyError):
            return None
        if self.instance.archive.files_for(self.instance.store_key(tm.schema, tm.name),
                                           None):
            return None  # cold rows live outside the index: the planned path
        key_col = pp["key_col"]
        x0 = time.perf_counter()
        if value is None:
            rows = []  # eq NULL matches nothing
        else:
            lane_val = _lane_encode(tm, key_col, value)
            if lane_val is None:
                return None
            # cross-session batching: coalesce with other sessions executing this
            # same parameterized statement (None -> run it here)
            brs = self._try_batched_point(pp, p, lane_val, sql, t0, prof, schema)
            if brs is not None:
                return brs
            with self._mdl_shared({self.instance.store_key(tm.schema, tm.name)}):
                rows = self._point_get(tm, store, key_col, lane_val, pp["out_cols"])
        prof.phases["execute"] = round((time.perf_counter() - x0) * 1000, 3)
        elapsed = time.time() - t0
        self.last_trace = [f"trace-id {prof.trace_id}",
                           f"point-plan {pp['table']}.{key_col}",
                           f"elapsed={elapsed:.3f}s workload=TP"]
        prof.trace = list(self.last_trace)
        self._finish_query(sql, elapsed, prof, "TP", "point", len(rows))
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

    def _try_batched_point(self, pp: dict, psql, lane_val, sql: str, t0: float,
                           prof, schema: str) -> Optional[ResultSet]:
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
        if not sched.enabled(self):
            return None
        pinned = None
        if self.txn is not None:
            if self.txn.inserted or self.txn.deleted or self.txn.remote:
                return None  # own-txn writes: sequential own-visibility path
            pinned = self.txn.snapshot_ts
        gkey = (schema.lower(), psql.cache_key, pinned, pp["schema_version"])
        req = sched.submit(gkey, pp, lane_val, pinned, prof)
        if req is None:
            return None
        if req.error is not None:
            raise req.error  # isolated to this session; group members proceed
        # the leader finished the profile and the query metrics at scatter; the
        # member's tail is SHOW TRACE state, the summary record and the slow gate
        self.last_trace = prof.trace
        self._summary_record(sql, prof, "TP", "batch", len(req.rows))
        slow_ms = self.instance.config.get("SLOW_SQL_MS", self.vars)
        if slow_ms is not None and slow_ms >= 0:
            elapsed = time.time() - t0
            if elapsed * 1000 >= slow_ms:
                tracing.SLOW_LOG.record(sql, elapsed, self.conn_id,
                                        trace_id=prof.trace_id, workload="TP",
                                        digest=self._digest_of(sql, schema))
                tracing.GLOBAL_STATS.bump("slow")
                self.instance.metrics.counter(
                    "slow_queries", "queries over SLOW_SQL_MS").inc()
        return ResultSet(pp["names"], pp["types"], req.rows)

    # -- transactions -------------------------------------------------------------

    def _begin(self):
        if self.txn is None:
            self.txn = Transaction(self.instance.tso.next_timestamp())

    def _commit(self):
        txn = self.txn
        self.txn = None
        if txn is None:
            return
        try:
            self._commit_txn(txn)
        finally:
            # the epochs of the worker-held tables this txn wrote bump again once
            # the outcome holds: a peer may have cached the pre-commit state under
            # the statement-time epoch
            for sch, tbl in txn.remote_tables:
                self._note_remote_write(sch, tbl)

    def _commit_txn(self, txn):
        """COMMIT under the session's TRANSACTION_POLICY.  'XA' runs the two-phase
        coordinator (prepare, PREPARED, commit point, stamps, DONE).  The TSO
        policy logs the commit point first, through the group-commit gate, then
        stamps every touched store and logs DONE: a crash between the two is
        resolved at boot as committed on every store, never half.  Either way the
        transaction's binlog events are written at its commit timestamp
        (`cdc.flush_txn`), also when XA raises after its commit point.  A
        transaction with worker branches always takes the two-phase path: its
        branches need the protocol."""
        policy = str(self.instance.config.get("TRANSACTION_POLICY", self.vars))
        if policy.upper() == "XA" or txn.remote:
            try:
                cts = self.instance.xa_coordinator.commit(txn)
            except errors.TransactionError as e:
                cts = getattr(e, "commit_ts", None)
                if cts is not None:
                    # committed with in-doubt participants: the outcome is
                    # decided, so the binlog records it at the commit ts
                    self.instance.cdc.flush_txn(txn, cts)
                    if txn.inserted or txn.deleted:
                        self.instance.catalog.version += 1
                raise
            self.instance.cdc.flush_txn(txn, cts)
            if txn.inserted or txn.deleted:
                self.instance.catalog.version += 1
            self._last_commit_ts = cts
            return
        parts = participants_of(txn)
        gate = self.instance.xa_coordinator.group_gate
        if parts:
            commit_ts = gate.commit_point(txn.txn_id)
            for sp in parts:
                sp.commit(commit_ts)
            gate.log_state(txn.txn_id, "DONE", commit_ts)
        else:
            commit_ts = self.instance.tso.next_timestamp()
        self.instance.cdc.flush_txn(txn, commit_ts)
        if txn.inserted or txn.deleted:
            self.instance.catalog.version += 1
        self._last_commit_ts = commit_ts

    def _rollback(self):
        txn = self.txn
        self.txn = None
        if txn is None:
            return
        for sch, tbl in txn.remote_tables:
            self._note_remote_write(sch, tbl)
        # own appended rows are stamped permanently dead and provisional delete
        # stamps restored; lanes never shrink (see StoreParticipant.rollback)
        for sp in participants_of(txn):
            sp.rollback()
        for rp in remote_participants_of(self.instance, txn):
            rp.rollback()

    def _dml_ts(self) -> Tuple[int, Optional[Transaction]]:
        """Timestamp to stamp writes with: provisional (-txn_id) inside a transaction,
        a real TSO value for autocommit single-statement writes."""
        if self.txn is not None:
            return -self.txn.txn_id, self.txn
        ts = self.instance.tso.next_timestamp()
        # read-your-writes fence for the columnar router: a later scan must not
        # route to a replica watermark below this write (COMMIT stamps it too)
        self._last_commit_ts = ts
        return ts, None

    # -- DML ------------------------------------------------------------------------

    def _run_dml(self, stmt, sql: str, params: Optional[list]) -> ResultSet:
        """DML under the statement-scope shared MDL of every table it names, after
        the session's own async applies (the fence) and, on a GSI-bearing table
        with applies pending, after all of them (a sequential delete racing ahead
        of a queued GSI insert would orphan the index row).  A successful
        autocommit statement registers its DML batch plan."""
        tables = self._stmt_tables(stmt)
        keys = {self.instance.store_key(t.schema or self._require_schema(), t.table)
                for t in tables}
        self._apply_fence()
        applier = self.instance.applier
        if applier.pending():
            try:
                tms = [self.instance.catalog.table(t.schema or self.schema, t.table)
                       for t in tables]
            except errors.TddlError:
                tms = []
            if any(gsi_targets(self.instance, tm) for tm in tms):
                applier.barrier(self._apply_wait_s())
        # the MAX_EXECUTION_TIME hint binds DML too (a remote write carries it)
        hint_ms = parse_hints(getattr(stmt, "hints", None)).get("max_execution_time")
        if hint_ms:
            self._deadline = time.time() + hint_ms / 1000.0
        t0 = time.time()
        prof = tracing.QueryProfile(
            trace_id=self.instance.trace_ids.next(), sql=(sql or "<dml>")[:512],
            schema=self.schema or "", conn_id=self.conn_id, started_at=t0)
        self._ss0 = _ss.counters_snapshot(self.instance)
        # DML rides the admission gate too (TP class): under overload a write
        # queue degrades typed instead of piling onto the store locks
        ticket = self.instance.admission.admit(self, sql or "")
        try:
            with self._mdl_shared(keys):
                if isinstance(stmt, ast.Insert):
                    if stmt.ignore or stmt.replace or stmt.on_dup_update:
                        raise errors.NotSupportedError(
                            "INSERT IGNORE, REPLACE and ON DUPLICATE KEY UPDATE")
                    rs = self._run_insert(stmt, params)
                elif stmt.order_by or stmt.limit is not None:
                    raise errors.NotSupportedError(
                        "ORDER BY or LIMIT in UPDATE and DELETE")
                elif isinstance(stmt, ast.Update):
                    rs = self._run_update(stmt, params)
                else:
                    rs = self._run_delete(stmt, params)
        except Exception:
            ticket.release(error=True)
            raise
        else:
            prof.workload = "TP"
            prof.engine = "dml"
            prof.elapsed_ms = round((time.time() - t0) * 1000, 3)
            # the digest's observed write cost feeds the summary and the
            # admission classifier
            self._summary_record(sql, prof, "TP", "dml", rs.affected)
            if self.txn is None:
                dml_batch.try_register(self, stmt, sql, params)
            return rs
        finally:
            ticket.release(prof)

    def _run_load_data(self, stmt: ast.LoadData) -> ResultSet:
        """Server-side CSV ingestion (LOAD DATA INFILE), the reference's: the file is
        read with `csv.reader` (`""` and `\\N` read as NULL, short rows padded with
        NULL) and appended in DML_BATCH_SIZE batches under the statement-scope shared
        MDL, GSIs included.  LOCAL reads the same server-side path, and the rows
        are not logged to the binlog, as in the reference."""
        import csv
        schema = stmt.table.schema or self._require_schema()
        tm = self.instance.catalog.table(schema, stmt.table.table)
        store = self.instance.store(tm.schema, tm.name)
        columns = stmt.columns or tm.column_names()
        ts, txn = self._dml_ts()
        total = 0
        batch_size = self.instance.config.get("DML_BATCH_SIZE", self.vars) or 10_000
        delim = stmt.field_terminator.replace("\\t", "\t") or ","
        quote = stmt.enclosed_by or '"'
        try:
            fh = open(stmt.path, newline="")
        except OSError as e:
            raise errors.TddlError(f"Can't read file '{stmt.path}' ({e.strerror})")
        # a concurrent ADD/DROP COLUMN swapping partition lanes mid-load would be a
        # torn write
        with fh as f, self._mdl_shared({self.instance.store_key(tm.schema, tm.name)}):
            reader = csv.reader(f, delimiter=delim, quotechar=quote)
            rows: List[List[Any]] = []
            for i, row in enumerate(reader):
                if i < stmt.ignore_lines:
                    continue
                rows.append([None if v in ("", "\\N") else v for v in row])
                if len(rows) >= batch_size:
                    total += self._load_rows(tm, store, columns, rows, ts, txn)
                    rows = []
            if rows:
                total += self._load_rows(tm, store, columns, rows, ts, txn)
        tm.bump_version()
        self._note_write(tm)
        self.instance.catalog.version += 1
        return ok(affected=total, info=f"Records: {total}")

    def _load_rows(self, tm, store, columns, rows, ts, txn) -> int:
        data = {c: [r[i] if i < len(r) else None for r in rows]
                for i, c in enumerate(columns)}
        data = {tm.column(c).name: vals for c, vals in data.items()}
        with store.append_lock:
            before = [p.num_rows for p in store.partitions]
            n = store.insert_pylists(data, ts)
            ranges = [(pid, before[pid], p.num_rows - before[pid])
                      for pid, p in enumerate(store.partitions)
                      if p.num_rows - before[pid]]
        for pid, start, added in ranges:
            if txn is not None:
                txn.inserted.append((store, pid, start, added))
            gsi_write_rows(self.instance, tm, store, pid, start, added, ts, txn)
        return n

    def _note_write(self, tm: TableMeta):
        """After a write: the GSI tables took the same write, so their versions
        move with the base table's and no cached lane of theirs is served.  The
        version bump already makes stale fragment fingerprints unreachable; the
        fragment cache drops their entries here to free the bytes at once."""
        metas = [tm]
        for _i, gtm, _gstore in gsi_targets(self.instance, tm):
            gtm.bump_version()
            metas.append(gtm)
        for t in metas:
            self.instance.frag_cache.invalidate_table(
                self.instance.store_key(t.schema, t.name))

    def _remote_dml(self, tm) -> Optional[ResultSet]:
        """DML on a worker-held table: the statement ships to the owning worker
        inside a branch of a distributed transaction, committed by the XA
        coordinator with the local stores as co-participants.  None for a local
        table.

        Synchronous replication: the statement goes to the primary and every live
        replica as branches of the same transaction; a fenced replica is marked
        stale and left out of reads until rebuilt.  An autocommit statement
        commits once the primary applied it and hands its replica legs to the
        async applier (uid-stamped, so a retry is exactly-once; the session's
        next statement waits for them).  Failures keep the reference's
        contract: a replica's failure marks it stale and the statement succeeds;
        a primary's failure whose outcome is unknown (bytes may have reached the
        worker) rolls the whole transaction back, while one known to have applied
        nothing is statement-scoped."""
        if getattr(tm, "remote", None) is None:
            return None
        inst = self.instance
        primary = (tm.remote["host"], tm.remote["port"])
        if inst.workers.get(primary) is None:
            raise errors.TddlError(f"remote table {tm.name}: no worker attached")
        if inst.ha.worker_fenced(primary) and not inst.try_revive_worker(primary):
            raise errors.WorkerUnavailableError(
                f"remote table {tm.name}: worker {primary[0]}:{primary[1]} "
                "is fenced", sent=False)
        endpoints = [primary]
        for r in tm.replicas:
            a = (r["host"], r["port"])
            if r.get("stale") or a not in inst.workers:
                continue
            if inst.ha.worker_fenced(a):
                r["stale"] = True
                continue
            endpoints.append(a)
        auto = self.txn is None
        async_rep = (auto and len(endpoints) > 1 and
                     bool(inst.config.get("ENABLE_ASYNC_APPLY", self.vars)))
        rep_addrs = []
        if async_rep:
            rep_addrs = endpoints[1:]
            endpoints = [primary]
        self._begin()
        affected = 0
        # one statement uid: each worker's dedupe window replays a reconnect
        # retry's recorded result instead of applying the write twice
        stmt_uid = f"{inst.node_id}:{inst.trace_ids.next()}"
        for addr in endpoints:
            had_branch = addr in self.txn.remote
            xid = self.txn.remote.setdefault(addr, f"g{self.txn.txn_id}")
            try:
                # only the primary leg carries the statement deadline: once the
                # primary applied, every replica must get the write or go stale;
                # a replica leg waits a fixed bound
                leg_deadline = self._deadline if addr == primary \
                    else time.time() + self.REPLICA_DML_TIMEOUT_S
                resp, _ = inst.workers[addr].request({
                    "op": "dml", "xid": xid, "schema": tm.schema,
                    "sql": self._current_sql, "uid": stmt_uid,
                    "params": list(self._current_params or [])},
                    deadline=leg_deadline)
                err = None
                ambiguous = False
                reached = True
            except errors.QueryTimeoutError as e:
                if addr != primary:
                    # a hung replica: mark it stale below, the statement goes on
                    err = str(e)
                    ambiguous = False
                    reached = True
                else:
                    QUERY_TIMEOUTS.inc()
                    if auto:
                        self._rollback()
                        raise
                    if getattr(e, "sent", True):
                        # the write may have applied before the reply was lost:
                        # only rolling the transaction back keeps both sides equal
                        self._rollback()
                        raise errors.TransactionError(
                            f"query deadline exceeded with unknown branch "
                            f"outcome; transaction rolled back: {e}")
                    if not had_branch:
                        self.txn.remote.pop(addr, None)  # never opened
                    raise
            except errors.ProtocolError as e:
                # a corrupt reply: the worker executed, the outcome is unknown;
                # an outbound validation failure (never shipped) applied nothing
                err = str(e)
                reached = bool(getattr(e, "_gx_sent", True))
                ambiguous = reached
            except (errors.WorkerUnavailableError, ConnectionError, OSError) as e:
                # transport death: ambiguous only if bytes may have reached the
                # worker (a breaker fast-fail or a refused connect applied nothing)
                err = str(e)
                reached = bool(getattr(e, "sent", True))
                ambiguous = reached
            except errors.TddlError as e:
                # a worker-reported error: nothing applied, the outcome is known
                err = str(e)
                ambiguous = False
                reached = True
            if err:
                if addr != primary:
                    for r in tm.replicas:
                        if (r["host"], r["port"]) == addr:
                            r["stale"] = True
                    self.txn.remote.pop(addr, None)
                    try:
                        # bounded: a hung replica must not stall the statement on
                        # its own cleanup (xa_recover resolves the branch later)
                        inst.workers[addr].request({"op": "xa_rollback", "xid": xid},
                                                   deadline=time.time() + 5.0)
                    except Exception as cex:
                        events.publish(
                            "replica_cleanup_failed",
                            f"replica rollback for {xid} at {addr} failed "
                            f"({type(cex).__name__}); branch resolves via "
                            f"xa_recover", severity="warn", node=inst.node_id,
                            dedupe=f"dml-rb:{addr}")
                    continue
                if auto:
                    self._rollback()
                    raise errors.TddlError(f"worker DML failed: {err}")
                if ambiguous:
                    self._rollback()
                    raise errors.TransactionError(
                        f"worker DML failed with unknown outcome; "
                        f"transaction rolled back: {err}")
                if not reached and not had_branch:
                    # nothing reached the worker and this statement registered the
                    # branch: unregister it, or COMMIT would prepare a branch the
                    # worker never opened
                    self.txn.remote.pop(addr, None)
                raise errors.TddlError(f"worker DML failed: {err}")
            if addr == primary:
                affected = int(resp.get("affected", 0))
        # remote tables have no version here: bump the fragment epoch and tell
        # every node on the sync bus (again after the outcome, `_commit`)
        self.txn.remote_tables.add((tm.schema, tm.name))
        self._note_remote_write(tm.schema, tm.name)
        if auto:
            self._commit()
            if rep_addrs:
                mark = inst.applier.enqueue([
                    {"kind": "replica", "addr": a, "schema": tm.schema,
                     "sql": self._current_sql,
                     "params": list(self._current_params or []),
                     "uid": f"{stmt_uid}:r{ai}", "commit_ts": self._last_commit_ts,
                     "timeout_s": self.REPLICA_DML_TIMEOUT_S,
                     "base_schema": tm.schema, "base_table": tm.name}
                    for ai, a in enumerate(rep_addrs)])
                self._apply_mark = max(self._apply_mark, mark)
        return ok(affected=affected)

    def _run_insert(self, stmt: ast.Insert, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(stmt.table.schema or schema, stmt.table.table)
        rrs = self._remote_dml(tm)
        if rrs is not None:
            return rrs
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
        store._lockdep_probe()  # FP_LOCK_INVERT only; disarmed = one bool
        with store.append_lock:
            before = [p.num_rows for p in store.partitions]
            store.append_encoded(lanes, valid, n, ts)
            ranges = [(pid, before[pid], p.num_rows - before[pid])
                      for pid, p in enumerate(store.partitions)
                      if p.num_rows - before[pid]]
        for pid, start, added in ranges:
            if txn is not None:
                txn.inserted.append((store, pid, start, added))
            gsi_write_rows(self.instance, tm, store, pid, start, added, ts, txn)
            self.instance.cdc.capture_range(tm, store, pid, start, added, ts, txn, self)
        tm.bump_version()
        self._note_write(tm)
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
        rrs = self._remote_dml(tm)
        if rrs is not None:
            return rrs
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
                self.instance.cdc.capture_rows(tm, store, pid, ids, "delete", ts, txn,
                                               self)
                gsi_delete(self.instance, tm, store, pid, ids, ts, txn)
                p.delete_rows(ids, ts)
            if txn is not None:
                txn.deleted.append((store, pid, ids, old_end))
            n += ids.size
        tm.stats.row_count = max(tm.stats.row_count - n, 0)
        tm.bump_version()
        self._note_write(tm)
        self.instance.catalog.version += 1
        return ok(affected=n)

    def _run_update(self, stmt: ast.Update, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        if not isinstance(stmt.table, ast.TableName):
            raise errors.NotSupportedError("multi-table UPDATE")
        tm = self.instance.catalog.table(stmt.table.schema or schema, stmt.table.table)
        rrs = self._remote_dml(tm)
        if rrs is not None:
            return rrs
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
                self.instance.cdc.capture_rows(tm, store, pid, ids, "delete", ts, txn,
                                               self)
                gsi_delete(self.instance, tm, store, pid, ids, ts, txn)
                start = p.num_rows
                p.update_rows(ids, new_lanes, new_valid, ts)
                if txn is not None:
                    txn.deleted.append((store, pid, ids, old_end))
                    txn.inserted.append((store, pid, start, ids.size))
                gsi_write_rows(self.instance, tm, store, pid, start, ids.size, ts, txn)
                self.instance.cdc.capture_range(tm, store, pid, start, ids.size, ts,
                                                txn, self)
            n += ids.size
        tm.bump_version()
        self._note_write(tm)
        self.instance.catalog.version += 1
        return ok(affected=n)

    def _run_truncate(self, stmt: ast.TruncateTable) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(stmt.name.schema or schema, stmt.name.table)
        self.instance.store(tm.schema, tm.name).truncate()
        tm.bump_version()
        self._note_write(tm)
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
            self.instance.metadb.save_schema(schema)
            self.instance.metadb.notify(f"table.{schema}.{tm.name}")
            events.publish("ddl", f"CREATE TABLE {schema}.{tm.name}",
                           node=self.instance.node_id, schema=schema, table=tm.name)
        return ok()

    # -- DDL ------------------------------------------------------------------------

    def _run_drop_table(self, stmt: ast.DropTable) -> ResultSet:
        schema = self._require_schema()
        for name in stmt.names:
            s = name.schema or schema
            self.instance.invalidate_fragment_cache(s, name.table)
            if self.instance.config.get("ENABLE_RECYCLEBIN", self.vars):
                try:
                    tm = self.instance.catalog.table(s, name.table)
                except errors.TddlError:
                    tm = None
                if tm is not None and self.instance.recycle.drop(tm):
                    # parked in the bin: FLASHBACK can restore it
                    events.publish("ddl", f"DROP TABLE {s}.{name.table} (recycled)",
                                   node=self.instance.node_id, schema=s,
                                   table=name.table)
                    continue
            if self.instance.catalog.drop_table(s, name.table, stmt.if_exists):
                self.instance.drop_store(s, name.table)
                events.publish("ddl", f"DROP TABLE {s}.{name.table}",
                               node=self.instance.node_id, schema=s, table=name.table)
        return ok()

    def _drop_database(self, stmt: ast.DropDatabase):
        cat = self.instance.catalog
        key = stmt.name.lower()
        if key in cat.schemas:
            for t in list(cat.schemas[key].tables.values()):
                self.instance.drop_store(t.schema, t.name)
        cat.drop_schema(stmt.name, stmt.if_exists)
        self.instance.metadb.drop_schema(stmt.name)
        if self.schema and self.schema.lower() == key:
            self.schema = None

    def _run_flashback_table(self, stmt: ast.FlashbackTable) -> ResultSet:
        schema = stmt.name.schema or self._require_schema()
        restored = self.instance.recycle.flashback(schema, stmt.name.table,
                                                   stmt.rename_to)
        return ok(info=f"restored as {restored}")

    def _run_create_view(self, stmt: ast.CreateView) -> ResultSet:
        schema = stmt.name.schema or self._require_schema()
        # the view must bind against the current metadata, and an explicit column
        # list must match the SELECT's output arity
        plan = self.instance.planner.bind_statement(stmt.select, schema, [], self)
        if stmt.columns is not None and len(stmt.columns) != len(plan.display_names):
            raise errors.TddlError(
                f"View '{stmt.name.table}' column list length mismatch")
        v = ViewDef(schema, stmt.name.table, stmt.columns, stmt.select_sql)
        self.instance.catalog.add_view(v, or_replace=stmt.or_replace)
        self.instance.metadb.save_view(v)
        return ok()

    def _run_drop_view(self, stmt: ast.DropView) -> ResultSet:
        schema_default = self._require_schema()
        for nm in stmt.names:
            schema = nm.schema or schema_default
            if self.instance.catalog.drop_view(schema, nm.table, stmt.if_exists):
                self.instance.metadb.drop_view(schema, nm.table)
        return ok()

    def _run_alter(self, stmt: ast.AlterTable, sql: str) -> ResultSet:
        schema = stmt.table.schema or self._require_schema()
        self.instance.catalog.table(schema, stmt.table.table)  # validate early
        if any(a[0] == "repartition" for a in stmt.actions):
            if len(stmt.actions) != 1:
                raise errors.NotSupportedError(
                    "PARTITION BY cannot be combined with other ALTER actions")
            job = self._repartition_job(stmt, sql, schema)
        elif any(a[0] in ("split_partition", "merge_partitions", "move_partition")
                 for a in stmt.actions):
            if len(stmt.actions) != 1:
                raise errors.NotSupportedError(
                    "SPLIT/MERGE/MOVE PARTITION cannot be combined with "
                    "other ALTER actions")
            job = self._partition_rebalance_job(stmt, sql, schema)
        else:
            job = alter_table_job(schema, sql, stmt.table.table, stmt.actions)
        try:
            self.instance.ddl_engine.submit_and_run(job)
        finally:
            self.instance.invalidate_fragment_cache(schema, stmt.table.table)
        return ok()

    def _repartition_job(self, stmt: ast.AlterTable, sql: str, schema: str):
        """Online repartition (`ddl/repartition.py`): a shadow table with the
        target partitioning, a chunked backfill, the catchup, the FastChecker
        verify and the cutover under the exclusive MDL."""
        from galaxysql_tpu_torch.ddl.repartition import repartition_job
        pd = stmt.actions[0][1]
        cols = []
        for e in pd.exprs:
            if not isinstance(e, ast.Name):
                raise errors.NotSupportedError(
                    "PARTITION BY expression must be a column name")
            cols.append(e.parts[-1])
        tm = self.instance.catalog.table(schema, stmt.table.table)
        for c in cols:
            tm.column(c)  # the partition column must exist
        method = pd.method if pd.method in ("hash", "key", "range") else "hash"
        count = pd.count or tm.partition.num_partitions or 4
        return repartition_job(schema, sql, stmt.table.table, method, cols, count)

    def _partition_rebalance_job(self, stmt: ast.AlterTable, sql: str, schema: str):
        """SPLIT / MERGE / MOVE PARTITION (`ddl/rebalance.py`): shadow partitions
        backfilled, caught up from the binlog, verified, and swapped in at a TSO
        fence under the exclusive MDL."""
        from galaxysql_tpu_torch.ddl import rebalance as rb
        action = stmt.actions[0]
        table = stmt.table.table
        if action[0] == "split_partition":
            return rb.split_partition_job(schema, sql, table, action[1],
                                          into=action[3], at=action[2])
        if action[0] == "merge_partitions":
            return rb.merge_partitions_job(schema, sql, table, action[1], action[2])
        return rb.move_partition_job(schema, sql, table, action[1], action[2])

    def _run_rebalance(self, stmt: ast.Rebalance) -> ResultSet:
        """REBALANCE TABLE / DATABASE [DRY RUN]: one pass of the balancer; the rows
        are its proposals and, unless DRY RUN, what became of the first."""
        schema = stmt.schema or (None if stmt.table is None
                                 else self._require_schema())
        props = self.instance.balancer.run_once(schema, stmt.table,
                                                apply=not stmt.dry_run)
        rows = [(p["table"], p["op"], ",".join(str(i) for i in p["pids"]),
                 p.get("group", ""), p["why"],
                 "applied" if p.get("applied") else p.get("error", "proposed"),
                 p.get("job_id") or 0)
                for p in props]
        return ResultSet(["TABLE_NAME", "OP", "PARTITIONS", "TARGET_GROUP", "REASON",
                          "STATUS", "JOB_ID"], [dt.VARCHAR] * 6 + [dt.BIGINT], rows)

    def _run_check_table(self, stmt: ast.CheckTable) -> ResultSet:
        from galaxysql_tpu_torch.server.maintain import check_table
        schema = self._require_schema()
        rows = []
        for name in stmt.names:
            tm = self.instance.catalog.table(name.schema or schema, name.table)
            if getattr(tm, "remote", None) is not None:
                raise errors.NotSupportedError(
                    f"CHECK TABLE on worker-resident table '{tm.name}' is not "
                    "supported from this CN (run it on the worker)")
            store = self.instance.store(tm.schema, tm.name)
            rows.extend(check_table(self.instance, tm, store))
        return ResultSet(["Table", "Op", "Msg_type", "Msg_text"],
                         [dt.VARCHAR] * 4, rows)

    def _run_index_ddl(self, stmt, sql: str) -> ResultSet:
        schema = stmt.table.schema or self._require_schema()
        if isinstance(stmt, ast.CreateIndex):
            idx = stmt.index
            job = create_index_job(schema, sql, stmt.table.table,
                                   idx.name or f"i_{idx.columns[0]}", idx.columns,
                                   idx.unique, idx.global_index, idx.covering)
        else:
            job = drop_index_job(schema, sql, stmt.table.table, stmt.name)
        try:
            self.instance.ddl_engine.submit_and_run(job)
        finally:
            self.instance.invalidate_fragment_cache(schema, stmt.table.table)
        return ok()

    def _run_advise_index(self, stmt: ast.AdviseIndex,
                          params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        plan = self.instance.planner.bind_statement(stmt.select, schema,
                                                    params or [], self)
        return ResultSet(["TABLE", "COLUMN", "REASON", "SUGGESTION"],
                         [dt.VARCHAR] * 4, advise_indexes(self.instance, plan))

    # -- session statements ----------------------------------------------------------

    def _run_set(self, stmt: ast.SetStmt) -> ResultSet:
        for scope, name, vexpr in stmt.assignments:
            value = _ast_literal_value(vexpr)
            if scope == "user":
                self.user_vars[name.lower()] = value
            elif scope == "global":
                self.instance.config.set_instance(name, value)
                # kept in the metadb as the reference keeps it; the config
                # listener reloads it on notify
                self.instance.metadb.kv_put(
                    f"config.param.{name.upper()}", json.dumps(value))
                self.instance.metadb.notify("config.params")
            else:
                self.vars[name.upper() if name.upper() in
                          self.instance.config.registry() else name.lower()] = value
        return ok()

    def _run_baseline(self, stmt: ast.BaselineStmt) -> ResultSet:
        """BASELINE EVOLVE runs the unaccepted candidates with their join order
        forced on the instance's device and promotes measurably faster ones;
        BASELINE DELETE drops a baseline (the reference's)."""
        spm = self.instance.planner.spm
        if stmt.action == "delete":
            found = spm.delete(stmt.baseline_id)
            return ok(affected=1 if found else 0)

        def measure(key, orders):
            schema, psql = key
            params = spm.last_params(key)
            plan = self.instance.planner.bind_statement(
                parse(psql), schema, params, self, forced_orders=orders)
            # no device cache, as the reference's measure context has none
            ctx = ExecContext(self.instance.stores, self._snapshot_ts(),
                              self.instance.device, None,
                              params=params, archive=self.instance.archive,
                              archive_instance=self.instance)
            op = build_operator(plan.rel, ctx)
            t0 = time.time()
            run_to_batch(op)
            return (time.time() - t0) * 1000.0

        rows = spm.evolve(measure)
        return ResultSet(["BASELINE_ID", "PROMOTED", "CANDIDATE_MS", "ACCEPTED_MS"],
                         [dt.BIGINT, dt.BOOL, dt.DOUBLE, dt.DOUBLE],
                         [(i, p, c, a) for i, p, c, a in rows])

    def _run_show(self, stmt: ast.Show) -> ResultSet:
        from galaxysql_tpu_torch.server import show_handlers
        return show_handlers.handle(self, stmt)

    def _run_explain(self, stmt: ast.Explain, params) -> ResultSet:
        """EXPLAIN: the plan's explain lines.  EXPLAIN ANALYZE runs the plan as
        `_run_query` does (the instance's device and device cache) with every
        operator wrapped in a `StatsOp`, and annotates the lines with each
        operator's rows, batches and wall time; then the rows, the elapsed time,
        the host-to-device transfers, the trace and one line per operator."""
        schema = self._require_schema()
        inner = stmt.stmt
        if not isinstance(inner, (ast.Select, ast.SetOpSelect)):
            return ResultSet(["plan"], [dt.VARCHAR], [("not a plannable statement",)])
        plan = self.instance.planner.bind_statement(inner, schema, params or [])
        lines = plan.explain().split("\n")
        col_views = None
        if stmt.analyze:
            ctx = self._exec_context(plan, params)
            ctx.collect_stats = True
            # the real path's columnar routing: ANALYZE numbers describe the tier
            # the query actually reads
            self._maybe_route_columnar(plan, ctx)
            col_views = ctx.columnar
            prof = tracing.QueryProfile(trace_id=self.instance.trace_ids.next(),
                                        sql="<explain analyze>", schema=schema,
                                        conn_id=self.conn_id, started_at=time.time())
            ctx.profile = prof
            # compile and transfer attribution: deltas of the process counters
            # around this execution (host-side reads)
            c0 = dict(COMPILE_STATS)
            x0 = dict(TRANSFER_STATS)
            t0 = time.time()
            with self._mdl_shared(self._scan_keys(plan.rel)), \
                    tracing.SEGMENT_TRACER.scoped(prof.segments):
                # the real path's engine dispatch: an AP query past the MPP
                # threshold reports its per-shard stages (rows per shard, skew,
                # HotKeys/Salted decisions), not a local stand-in
                batch = self._try_mpp(plan, ctx, count=False)
                if batch is None:
                    batch = run_to_batch(build_operator(plan.rel, ctx))
            elapsed = time.time() - t0
            rows = batch.num_live()
            lines = annotate_explain(plan.rel, ctx.op_stats, rf=ctx.rf,
                                     skew_stats=ctx.skew_stats)
            # the per-operator stats behind the lines (under MPP: engine, rows per
            # shard, shard skew); the profile records them too
            self.last_op_stats = ctx.op_stats
            d_retr = COMPILE_STATS["retraces"] - c0["retraces"]
            d_cms = COMPILE_STATS["compile_ms"] - c0["compile_ms"]
            d_cached = COMPILE_STATS["cache_hits"] - c0["cache_hits"]
            lines += [f"-- trace_id: {prof.trace_id}", f"-- rows: {rows}",
                      f"-- elapsed: {elapsed:.3f}s",
                      f"-- compile: retraces={d_retr} wall={d_cms:.3f}ms "
                      f"cached={d_cached}",
                      f"-- transfer: h2d_bytes={TRANSFER_STATS['bytes'] - x0['bytes']} "
                      f"transfers={TRANSFER_STATS['transfers'] - x0['transfers']}"] + \
                [f"-- {t}" for t in ctx.trace]
            for st in ctx.op_stats:
                tag = f" fused({st['segment']})" if st.get("fused") else ""
                lines.append(f"-- op {st['operator']}: rows={st['rows_out']} "
                             f"batches={st['batches']} wall={st['wall_ms']}ms{tag}")
            for sp in prof.segments:
                lines.append(f"-- segment {sp.segment_id} {sp.chain}: "
                             f"rows_in={sp.rows_in} rows_out={sp.rows_out} "
                             f"compiled={sp.compiled} wall={sp.wall_ms}ms")
            self._finish_query(prof.sql, elapsed, prof, plan.workload, "local", rows,
                               ctx, plan=plan)
        if col_views is None:
            # plain EXPLAIN: dry-run the routing decision against a throwaway probe
            # so freshness shows up without executing anything
            probe = ExecContext({}, None, "cpu", hints=getattr(plan, "hints", None))
            self._maybe_route_columnar(plan, probe)
            col_views = probe.columnar
        for key in sorted(col_views or {}):
            v = col_views[key]
            lag = max(time.time() * 1000.0 - (v.watermark >> LOGICAL_BITS), 0.0)
            lines.append(f"-- columnar: {key} watermark={v.watermark} "
                         f"freshness_lag_ms={lag:.1f} "
                         f"stripes={len(v.stripes)} "
                         f"delta_chunks={len(v.delta)}")
        lines.append(f"-- workload: {plan.workload}")
        return ResultSet(["plan"], [dt.VARCHAR], [(ln,) for ln in lines])

    def _describe(self, name: ast.TableName) -> ResultSet:
        schema = self._require_schema()
        tm = self.instance.catalog.table(name.schema or schema, name.table)
        rows = []
        for c in tm.columns:
            key = "PRI" if c.name in tm.primary_key else ""
            rows.append((c.name, c.dtype.sql_name().lower(),
                         "YES" if c.nullable else "NO", key,
                         None if c.default is None else str(c.default),
                         "auto_increment" if c.auto_increment else ""))
        return ResultSet(["Field", "Type", "Null", "Key", "Default", "Extra"],
                         [dt.VARCHAR] * 6, rows)


def _fold_constant(e: ir.Expr) -> ir.Literal:
    f = ExprCompiler(np).compile(e)
    d, v = f({})
    if v is not None and not np.all(np.asarray(v)):
        return ir.Literal(None, e.dtype)
    val = np.asarray(d).item()  # galaxylint: disable=jit-device-sync -- np-backend constant fold at bind time: d is a host numpy scalar, no device involved
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
