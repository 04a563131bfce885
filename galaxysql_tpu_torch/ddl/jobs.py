"""DDL job engine: crash-recoverable online schema changes (port of
`galaxysql_tpu/ddl/jobs.py`).

A job is a linear list of idempotent tasks persisted in the metadb (`ddl_engine` /
`ddl_engine_task`); `DdlEngine` runs the tasks with a checkpoint after each (and after
every backfill chunk), resumes a crashed job from its last completed task
(`recover()`), and rolls a job that fails with a `TddlError` back by undoing its
completed tasks in reverse.  Tasks register by name so persisted jobs can be
rehydrated.

GSI builds follow the online state machine CREATING -> WRITE_ONLY -> PUBLIC: the
index table is created and backfilled from a snapshot in `GsiBackfillTask.CHUNK`-row
chunks while the status makes writers maintain it, then published.

The catalog, the lanes and the backfill are host work, as in the reference; what a
DDL changes on the device is what the instance's `device_cache` holds.  Column DDL
bumps the table version and every partition's `lane_gen` (`invalidate_indexes`), so
cached lanes, scan metadata, sorted key indexes and the batched point lanes all
miss; `InvalidatePlansTask` drops the planner cache and the instance's device cache.

Differences from the reference: `InvalidatePlansTask` clears the instance's own
`device_cache` (the port has no process-wide one); and `AddColumnTask`
encodes the default once and repeats its lane value, which gives the lanes and
dictionary the reference's per-row `column_from_pylist` gives.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Dictionary, column_from_pylist
from galaxysql_tpu_torch.meta.catalog import (ColumnMeta, IndexMeta, PartitionInfo,
                                              TableMeta)
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors, events
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_AFTER_DDL_TASK,
                                                 FP_BACKFILL_PAUSE, FP_BEFORE_DDL_TASK)

_TASK_REGISTRY: Dict[str, type] = {}


def task(cls):
    _TASK_REGISTRY[cls.__name__] = cls
    return cls


class DdlTask:
    """An idempotent unit of DDL work with an undo."""

    def __init__(self, payload: Dict[str, Any]):
        self.payload = payload

    def run(self, ctx: "DdlContext"):
        raise NotImplementedError

    def undo(self, ctx: "DdlContext"):
        pass  # default: nothing to undo


class DdlContext:
    def __init__(self, instance, schema: str):
        self.instance = instance
        self.schema = schema
        self.job_id: Optional[int] = None

    def table(self, name: str) -> TableMeta:
        return self.instance.catalog.table(self.schema, name)

    def bump(self, tm: TableMeta):
        tm.bump_version()
        self.instance.catalog.bump_schema()
        self.instance.metadb.save_table(tm)
        self.instance.metadb.notify(f"table.{tm.schema}.{tm.name}")

    def _checkpoint(self):
        pass  # replaced by the engine for the running task


# ---------------------------------------------------------------------------
# task library
# ---------------------------------------------------------------------------

def _mdl_exclusive(ctx, table_name: str):
    """Exclusive metadata lock for schema-mutating tasks: statements hold SHARED on
    every table they touch for their duration, so a column add/drop or rename
    cannot swap lanes under a running query or DML."""
    tm = ctx.table(table_name)
    return ctx.instance.mdl.exclusive(ctx.instance.store_key(tm.schema, tm.name))


@task
class ValidateTableTask(DdlTask):
    def run(self, ctx):
        ctx.table(self.payload["table"])  # raises if missing


@task
class AddColumnTask(DdlTask):
    def run(self, ctx):
        with _mdl_exclusive(ctx, self.payload["table"]):
            self._run_locked(ctx)

    def _run_locked(self, ctx):
        tm = ctx.table(self.payload["table"])
        name = self.payload["name"]
        if tm.has_column(name):
            return  # idempotent re-run after a crash
        typ = dt.from_sql_name(self.payload["type"], self.payload.get("precision", 0),
                               self.payload.get("scale", 0))
        cm = ColumnMeta(name, typ, self.payload.get("nullable", True),
                        self.payload.get("default"))
        after = self.payload.get("after")
        pos = len(tm.columns)
        if after == "":
            pos = 0  # FIRST
        elif after:
            pos = next((i + 1 for i, c in enumerate(tm.columns)
                        if c.name.lower() == after.lower()), pos)
        # resolution structures before the column list shows the column: the
        # planner reads tm.columns without the MDL
        if typ.is_string:
            tm.dictionaries[name.lower()] = Dictionary()
        tm.by_name[name.lower()] = cm
        tm.columns.insert(pos, cm)
        store = ctx.instance.store(tm.schema, tm.name)
        dv = self.payload.get("default")
        for p in store.partitions:
            n = p.num_rows
            fill = np.zeros(n, dtype=typ.lane)
            valid = np.zeros(n, dtype=np.bool_)
            if dv is not None and n:
                # every row holds the same value: encode it once (a string
                # default enters the dictionary at the first non-empty partition,
                # as the reference's per-row encoding puts it there)
                one = column_from_pylist([dv], typ, tm.dictionaries.get(name.lower()))
                fill = np.repeat(one.np_data(), n)
                valid = np.repeat(one.np_valid(), n)
            p.lanes[cm.name] = fill
            p.valid[cm.name] = valid
            p.invalidate_indexes()
        ctx.bump(tm)

    def undo(self, ctx):
        with _mdl_exclusive(ctx, self.payload["table"]):
            tm = ctx.table(self.payload["table"])
            name = self.payload["name"]
            if not tm.has_column(name):
                return
            tm.columns = [c for c in tm.columns if c.name.lower() != name.lower()]
            tm.by_name.pop(name.lower(), None)
            store = ctx.instance.store(tm.schema, tm.name)
            for p in store.partitions:
                p.lanes.pop(name, None)
                p.valid.pop(name, None)
                p.invalidate_indexes()
            ctx.bump(tm)


@task
class DropColumnTask(DdlTask):
    def run(self, ctx):
        with _mdl_exclusive(ctx, self.payload["table"]):
            self._run_locked(ctx)

    def _run_locked(self, ctx):
        tm = ctx.table(self.payload["table"])
        name = self.payload["name"]
        if not tm.has_column(name):
            return
        if name in tm.primary_key:
            raise errors.TddlError(f"cannot drop primary key column '{name}'")
        if name.lower() in (c.lower() for c in tm.partition.columns):
            raise errors.TddlError(f"cannot drop partition column '{name}'")
        tm.columns = [c for c in tm.columns if c.name.lower() != name.lower()]
        tm.by_name.pop(name.lower(), None)
        store = ctx.instance.store(tm.schema, tm.name)
        for p in store.partitions:
            p.lanes.pop(name, None)
            p.valid.pop(name, None)
            p.invalidate_indexes()
        ctx.bump(tm)
    # undo of a drop would need the saved lane; the factories run destructive tasks
    # last so a rollback never has to restore them (as the reference does)


@task
class RenameTableTask(DdlTask):
    def run(self, ctx):
        with _mdl_exclusive(ctx, self.payload["table"]):
            self._run_locked(ctx)

    def _run_locked(self, ctx):
        tm = ctx.table(self.payload["table"])
        new = self.payload["new_name"]
        inst = ctx.instance
        s = inst.catalog.schema(tm.schema)
        if new.lower() in s.tables:
            return  # already applied
        store = inst.store(tm.schema, tm.name)
        del s.tables[tm.name.lower()]
        # the store stays under the new name: its device-cache entries stay too
        inst.stores.pop(inst.store_key(tm.schema, tm.name), None)
        inst.metadb.drop_table(tm.schema, tm.name)
        tm.name = new
        s.tables[new.lower()] = tm
        inst.stores[inst.store_key(tm.schema, new)] = store
        ctx.bump(tm)


@task
class AddIndexMetaTask(DdlTask):
    """Index metadata in CREATING state (the online build's entry point)."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        name = self.payload["name"]
        if any(i.name.lower() == name.lower() for i in tm.indexes):
            return
        for c in self.payload["columns"]:
            tm.column(c)
        meta = IndexMeta(name, self.payload["columns"], self.payload.get("unique", False),
                         self.payload.get("global", False),
                         self.payload.get("covering", []))
        meta.status = "CREATING"
        tm.indexes.append(meta)
        ctx.bump(tm)

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        tm.indexes = [i for i in tm.indexes
                      if i.name.lower() != self.payload["name"].lower()]
        ctx.bump(tm)


@task
class CreateGsiTableTask(DdlTask):
    """The GSI as a partitioned table of its own, partitioned by the index's first
    column, holding the index columns, the covering columns and the primary key."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        gsi_name = _gsi_table_name(tm.name, self.payload["name"])
        try:
            ctx.instance.catalog.table(tm.schema, gsi_name)
            return  # already created
        except errors.UnknownTableError:
            pass
        cols = []
        wanted = list(self.payload["columns"]) + list(self.payload.get("covering", [])) + \
            [c for c in tm.primary_key if c not in self.payload["columns"]]
        seen = set()
        for c in wanted:
            if c.lower() in seen:
                continue
            seen.add(c.lower())
            src = tm.column(c)
            cols.append(ColumnMeta(src.name, src.dtype, src.nullable))
        part = PartitionInfo("hash", [self.payload["columns"][0]],
                             tm.partition.count if tm.partition.method == "hash" else 8)
        gsi_tm = TableMeta(tm.schema, gsi_name, cols, tm.primary_key, part)
        # the base table's dictionaries: the codes align for lookups
        for c in cols:
            if c.dtype.is_string:
                gsi_tm.dictionaries[c.name.lower()] = tm.dictionaries[c.name.lower()]
        ctx.instance.catalog.add_table(gsi_tm, if_not_exists=True)
        ctx.instance.register_table(gsi_tm)
        ctx.bump(gsi_tm)

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        gsi_name = _gsi_table_name(tm.name, self.payload["name"])
        if ctx.instance.catalog.drop_table(tm.schema, gsi_name, if_exists=True):
            ctx.instance.drop_store(tm.schema, gsi_name)


@task
class GsiBackfillTask(DdlTask):
    """Chunked snapshot backfill with a persisted position checkpoint, so a crashed
    backfill resumes mid-table."""

    CHUNK = 8192

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        gsi_name = _gsi_table_name(tm.name, self.payload["name"])
        gsi_tm = ctx.instance.catalog.table(tm.schema, gsi_name)
        base = ctx.instance.store(tm.schema, tm.name)
        gsi = ctx.instance.store(tm.schema, gsi_name)
        snapshot = self.payload.get("snapshot_ts") or \
            ctx.instance.tso.next_timestamp()
        self.payload["snapshot_ts"] = snapshot
        cols = gsi_tm.column_names()
        pstart, roffset = self.payload.get("position", [0, 0])  # [partition, row]
        for pid in range(pstart, len(base.partitions)):
            p = base.partitions[pid]
            idx = np.nonzero(p.visible_mask(snapshot))[0]
            start = roffset if pid == pstart else 0
            while start < idx.shape[0]:
                FAIL_POINTS.inject(FP_BACKFILL_PAUSE, f"p{pid}@{start}")
                chunk = idx[start:start + self.CHUNK]
                lanes = {c: p.lanes[c][chunk] for c in cols}
                valid = {c: p.valid[c][chunk] for c in cols}
                pids = gsi._route(lanes)
                for gp in np.unique(pids):
                    sel = np.nonzero(pids == gp)[0]
                    gsi.partitions[int(gp)].append(
                        {k: v[sel] for k, v in lanes.items()},
                        {k: v[sel] for k, v in valid.items()}, snapshot)
                start += self.CHUNK
                # checkpoint after every chunk (the resume granularity)
                self.payload["position"] = [pid, start]
                ctx._checkpoint()
            roffset = 0
        gsi_tm.stats.row_count = gsi.row_count()

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        gsi_name = _gsi_table_name(tm.name, self.payload["name"])
        try:
            ctx.instance.store(tm.schema, gsi_name).truncate()
        except KeyError:
            pass


@task
class UpdateIndexStatusTask(DdlTask):
    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        for i in tm.indexes:
            if i.name.lower() == self.payload["name"].lower():
                i.status = self.payload["status"]
        ctx.bump(tm)

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        prev = self.payload.get("prev_status", "CREATING")
        for i in tm.indexes:
            if i.name.lower() == self.payload["name"].lower():
                i.status = prev
        ctx.bump(tm)


@task
class DropIndexTask(DdlTask):
    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        name = self.payload["name"]
        before = len(tm.indexes)
        dropped = [i for i in tm.indexes if i.name.lower() == name.lower()]
        tm.indexes = [i for i in tm.indexes if i.name.lower() != name.lower()]
        if dropped and dropped[0].global_index:
            gsi_name = _gsi_table_name(tm.name, name)
            if ctx.instance.catalog.drop_table(tm.schema, gsi_name, if_exists=True):
                ctx.instance.drop_store(tm.schema, gsi_name)
        if len(tm.indexes) != before:
            ctx.bump(tm)


@task
class InvalidatePlansTask(DdlTask):
    """Flush the plan cache and the instance's device cache after a metadata
    change."""

    def run(self, ctx):
        ctx.instance.planner.cache.invalidate_all()
        ctx.instance.device_cache.clear()


def _gsi_table_name(table: str, index: str) -> str:
    return f"{table}${index}"


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class DdlJob:
    def __init__(self, schema: str, sql: str, tasks: List[DdlTask]):
        self.schema = schema
        self.sql = sql
        self.tasks = tasks
        self.job_id: Optional[int] = None


class DdlEngine:
    """Runs jobs with per-task persisted state and reverse-order rollback."""

    def __init__(self, instance):
        self.instance = instance

    @property
    def metadb(self):
        return self.instance.metadb

    def submit_and_run(self, job: DdlJob):
        db = self.metadb
        cur = db.execute(
            "INSERT INTO ddl_engine (schema_name, ddl_sql, state, job_json, "
            "created, updated) VALUES (?,?,?,?,?,?)",
            (job.schema, job.sql, "RUNNING", "", time.time(), time.time()))
        job.job_id = cur.lastrowid
        for tid, t in enumerate(job.tasks):
            db.execute("INSERT INTO ddl_engine_task VALUES (?,?,?,?,?)",
                       (job.job_id, tid, type(t).__name__, "PENDING",
                        json.dumps(t.payload)))
        events.publish("ddl", f"{job.schema}: {job.sql}"[:256],
                       node=self.instance.node_id, schema=job.schema,
                       job_id=job.job_id)
        self._execute(job)

    def _execute(self, job: DdlJob, start_from: int = 0):
        ctx = DdlContext(self.instance, job.schema)
        ctx.job_id = job.job_id
        db = self.metadb

        def checkpoint_task(tid, t, state):
            db.execute("UPDATE ddl_engine_task SET state=?, payload_json=? "
                       "WHERE job_id=? AND task_id=?",
                       (state, json.dumps(t.payload), job.job_id, tid))

        done: List[int] = list(range(start_from))
        try:
            for tid in range(start_from, len(job.tasks)):
                t = job.tasks[tid]
                FAIL_POINTS.inject(FP_BEFORE_DDL_TASK, type(t).__name__)
                ctx._checkpoint = lambda _t=t, _tid=tid: checkpoint_task(
                    _tid, _t, "RUNNING")
                t.run(ctx)
                checkpoint_task(tid, t, "DONE")
                done.append(tid)
                FAIL_POINTS.inject(FP_AFTER_DDL_TASK, type(t).__name__)
            db.execute("UPDATE ddl_engine SET state='DONE', updated=? WHERE job_id=?",
                       (time.time(), job.job_id))
        except errors.TddlError:
            # a semantic failure: undo the completed tasks in reverse
            self._rollback(job, ctx, done)
            raise
        # crashes (FailPointError and the like) propagate with the job left
        # RUNNING: recover() resumes it from its last completed task

    def _rollback(self, job: DdlJob, ctx: DdlContext, done: List[int]):
        for tid in reversed(done):
            try:
                job.tasks[tid].undo(ctx)
            except Exception:
                pass  # best effort, as the reference: the job is marked ROLLBACK
        self.metadb.execute("UPDATE ddl_engine SET state='ROLLBACK', updated=? "
                            "WHERE job_id=?", (time.time(), job.job_id))

    def recover(self) -> List[int]:
        """Resume RUNNING jobs from their last completed task (crash recovery)."""
        db = self.metadb
        resumed = []
        for job_id, schema, sql in db.query(
                "SELECT job_id, schema_name, ddl_sql FROM ddl_engine "
                "WHERE state='RUNNING'"):
            tasks = []
            first_pending = 0
            for tid, name, state, payload_json in db.query(
                    "SELECT task_id, name, state, payload_json FROM ddl_engine_task "
                    "WHERE job_id=? ORDER BY task_id", (job_id,)):
                tasks.append(_TASK_REGISTRY[name](json.loads(payload_json)))
                if state == "DONE":
                    first_pending = tid + 1
            job = DdlJob(schema, sql, tasks)
            job.job_id = job_id
            self._execute(job, start_from=first_pending)
            resumed.append(job_id)
        return resumed


# ---------------------------------------------------------------------------
# job factories
# ---------------------------------------------------------------------------

def alter_table_job(schema: str, sql: str, table: str, actions) -> DdlJob:
    from galaxysql_tpu_torch.server.session import _ast_literal_value
    from galaxysql_tpu_torch.sql import ast as A
    tasks: List[DdlTask] = [ValidateTableTask({"table": table})]
    destructive: List[DdlTask] = []
    for action in actions:
        kind = action[0]
        if kind == "add_column":
            cd, after = action[1], action[2]
            default = None
            if cd.default is not None and not isinstance(cd.default, A.NullLit):
                default = _ast_literal_value(cd.default)
            tasks.append(AddColumnTask({
                "table": table, "name": cd.name,
                "type": cd.type_name + (" UNSIGNED" if cd.unsigned else ""),
                "precision": cd.precision, "scale": cd.scale,
                "nullable": cd.nullable, "default": default, "after": after}))
        elif kind == "drop_column":
            destructive.append(DropColumnTask({"table": table, "name": action[1]}))
        elif kind == "add_index":
            idx = action[1]
            tasks.extend(create_index_tasks(table, idx.name or f"i_{idx.columns[0]}",
                                            idx.columns, idx.unique,
                                            idx.global_index, idx.covering))
        elif kind == "drop_index":
            destructive.append(DropIndexTask({"table": table, "name": action[1]}))
        elif kind == "rename":
            destructive.append(RenameTableTask({"table": table, "new_name": action[1]}))
        elif kind == "modify_column":
            raise errors.NotSupportedError("MODIFY COLUMN not supported yet")
        else:
            raise errors.NotSupportedError(f"ALTER action {kind}")
    # destructive tasks run last so a rollback never restores dropped data
    tasks.extend(destructive)
    tasks.append(InvalidatePlansTask({}))
    return DdlJob(schema, sql, tasks)


def create_index_tasks(table: str, name: str, columns, unique: bool,
                       global_index: bool, covering) -> List[DdlTask]:
    tasks: List[DdlTask] = [AddIndexMetaTask({
        "table": table, "name": name, "columns": list(columns), "unique": unique,
        "global": global_index, "covering": list(covering)})]
    if global_index:
        tasks.append(CreateGsiTableTask({"table": table, "name": name,
                                         "columns": list(columns),
                                         "covering": list(covering)}))
        tasks.append(UpdateIndexStatusTask({"table": table, "name": name,
                                            "status": "WRITE_ONLY",
                                            "prev_status": "CREATING"}))
        tasks.append(GsiBackfillTask({"table": table, "name": name}))
    tasks.append(UpdateIndexStatusTask({"table": table, "name": name,
                                        "status": "PUBLIC",
                                        "prev_status": "WRITE_ONLY"}))
    return tasks


def create_index_job(schema: str, sql: str, table: str, name: str, columns,
                     unique: bool, global_index: bool, covering) -> DdlJob:
    tasks: List[DdlTask] = [ValidateTableTask({"table": table})]
    tasks += create_index_tasks(table, name, columns, unique, global_index, covering)
    tasks.append(InvalidatePlansTask({}))
    return DdlJob(schema, sql, tasks)


def drop_index_job(schema: str, sql: str, table: str, name: str) -> DdlJob:
    return DdlJob(schema, sql, [ValidateTableTask({"table": table}),
                                DropIndexTask({"table": table, "name": name}),
                                InvalidatePlansTask({})])
