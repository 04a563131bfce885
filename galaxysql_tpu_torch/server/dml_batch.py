"""Cross-session batched point writes (port of `galaxysql_tpu/server/dml_batch.py`).

The write-side mirror of the point-read batcher (`server/batch_scheduler.py`):
plan-identical autocommit point DMLs (single-row INSERT VALUES, UPDATE/DELETE on
one equality key) arriving inside the collection window coalesce into one flush:

- one shared flush-time TSO for the whole group;
- one vectorized apply per touched partition: the INSERT members' rows encode and
  append as one `encode_pylists` / `append_encoded`; the UPDATE/DELETE keys
  resolve through `exec/operators.batched_point_lookup` on the instance's device
  cache (the torch program on the card for a CUDA instance) and stamp in one
  partition pass;
- one `cdc.write_events` per flush (one metadb transaction), one version bump;
- GSI maintenance handed to the async applier (`txn/async_apply.py`) under
  ENABLE_ASYNC_APPLY, with the session's read-your-writes fence; synchronous in
  the flush otherwise.

Error isolation is per member: a poisoned key (FP_DML_POISON_KEY, the duplicate-key
stand-in), a NOT NULL violation, a per-key routing error or a write conflict fails
only its own session; a group-scope failure sends every member back to the
sequential path.  UPDATE/DELETE members sharing one key fall back too (their effects
depend on their order; the sequential path serializes them).

Only autocommit statements come here (`Session._try_batched_dml`): a transaction's
writes need own-txn visibility and undo.  The group key carries the catalog
schema_version; a change between submit and flush falls the group back.  The flush
holds the shared MDL of its table.

Escape hatches: the `DML_BATCH(OFF)` hint (any hint comment keeps a statement on the
sequential path and from registering), ENABLE_DML_BATCHING and the environment's
`GALAXYSQL_DML_BATCHING=0`.

Archive-backed tables take the sequential path, as in the reference: no plan
registers for them, and a flush finding archived rows evicts its plan and falls back.

Each flush invalidates the fragment cache's entries of its table (and, in the
synchronous apply, of its GSI tables) once, as in the reference.

Each member carries its session's QueryProfile and admission ticket, as in the
reference: the leader fills the served members' profiles and records them with the
query metrics once a flush, and the counters (`dml_batched_queries`, ...) and the
`dml_group_size` / `dml_wait_ms` histograms are the reference's, in the instance's
metrics registry.  Remote tables never register a plan, as in the reference: their
writes, replica legs included, take `Session._remote_dml`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.exec.operators import batched_point_lookup
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import ExprCompiler
from galaxysql_tpu_torch.plan.rules import _lane_encode
from galaxysql_tpu_torch.server.batch_scheduler import BatchRequest, BatchScheduler
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.parameterize import DecimalParam, parameterize
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_DML_POISON_KEY,
                                                 FailPointError)

# kill switch: GALAXYSQL_DML_BATCHING=0 disables the whole write batcher
ENABLED = os.environ.get("GALAXYSQL_DML_BATCHING", "1") != "0"


# -- plan registration ---------------------------------------------------------
#
# A DML batch plan is the write-side PointPlan: the statement's shape, extracted
# once after a successful sequential execution and keyed by the parameterized text,
# so later executions skip parse and bind and can coalesce.  Sources map each
# written column and the key to a parameter slot or a constant.

def _literal_source(e, vals, cursor):
    """AST literal -> ("slot", i) | ("const", v), advancing the slot cursor.
    Returns (source, cursor), or (None, cursor) when the shape does not register."""
    if isinstance(e, ast.NumberLit) or (
            isinstance(e, ast.Unary) and e.op == "-" and
            isinstance(e.arg, ast.NumberLit)):
        want = e.value if isinstance(e, ast.NumberLit) else -e.arg.value
        if cursor < len(vals):
            v = vals[cursor]
            got = v.value if isinstance(v, DecimalParam) else v
            if got == want:
                return ("slot", cursor), cursor + 1
        return ("const", want), cursor
    if isinstance(e, ast.StringLit):
        if cursor < len(vals) and vals[cursor] == e.value:
            return ("slot", cursor), cursor + 1
        return ("const", e.value), cursor
    if isinstance(e, ast.NullLit):
        return ("const", None), cursor
    return None, cursor


def _eq_key(where, vals, cursor):
    """WHERE col = <literal> -> (col_name, source, cursor) or None."""
    if not (isinstance(where, ast.Binary) and where.op == "=" and
            isinstance(where.left, ast.Name)):
        return None
    src, cursor = _literal_source(where.right, vals, cursor)
    if src is None:
        return None
    return where.left.parts[-1], src, cursor


def try_register(session, stmt, sql: str, params) -> None:
    """Register a DML batch plan after a successful sequential execution.  Only
    archetypal shapes register, and hinted statements never do."""
    inst = session.instance
    sched = inst.dml_batch_scheduler
    if not sched.enabled(session):
        return
    if not sql or "/*" in sql or getattr(stmt, "hints", None):
        return
    p = parameterize(sql)
    if not p.slots:
        return  # no parameterized literal: nothing identical to coalesce on
    key = ((session.schema or "").lower(), p.cache_key)
    if key in inst.dml_plans:
        return
    try:
        vals = p.resolve(params or [])
    except Exception:
        return
    schema = stmt.table.schema or session.schema
    if not schema:
        return
    try:
        tm = inst.catalog.table(schema, stmt.table.table)
    except errors.TddlError:
        return
    if getattr(tm, "remote", None) is not None:
        return  # a worker's table: its writes ship as branches, never batched here
    if inst.archive.files_for(f"{tm.schema.lower()}.{tm.name.lower()}", None):
        return  # archived cold rows: the flush would only ever fall back
    plan = _extract_plan(stmt, tm, vals)
    if plan is None:
        return
    plan["schema"] = tm.schema
    plan["table"] = tm.name
    plan["schema_version"] = inst.catalog.schema_version
    if len(inst.dml_plans) > 512:
        inst.dml_plans.clear()
    inst.dml_plans[key] = plan


def _extract_plan(stmt, tm, vals) -> Optional[dict]:
    cursor = 0
    if isinstance(stmt, ast.Insert):
        if stmt.select is not None or stmt.rows is None or \
                len(stmt.rows) != 1 or stmt.ignore or stmt.replace or \
                stmt.on_dup_update:
            return None
        columns = stmt.columns or tm.column_names()
        row = stmt.rows[0]
        if len(row) != len(columns):
            return None
        sources = []
        for e in row:
            src, cursor = _literal_source(e, vals, cursor)
            if src is None:
                return None
            sources.append(src)
        if cursor != len(vals):
            return None  # unconsumed params: the shape has literals we missed
        try:
            cols = [tm.column(c).name for c in columns]
        except errors.TddlError:
            return None
        # the poison/fallback identity key: the first primary-key column's value
        # when present, else the first column's
        key_ix = 0
        if tm.primary_key:
            for i, c in enumerate(cols):
                if c == tm.primary_key[0]:
                    key_ix = i
                    break
        return {"kind": "insert", "columns": cols, "sources": sources,
                "key_ix": key_ix}
    if isinstance(stmt, ast.Delete):
        if stmt.order_by or stmt.limit is not None:
            return None
        ek = _eq_key(stmt.where, vals, cursor)
        if ek is None:
            return None
        col, src, cursor = ek
        if cursor != len(vals):
            return None
        try:
            key_col = tm.column(col).name
        except errors.TddlError:
            return None
        return {"kind": "delete", "key_col": key_col, "key_src": src}
    if isinstance(stmt, ast.Update):
        if not isinstance(stmt.table, ast.TableName) or stmt.order_by or \
                stmt.limit is not None:
            return None
        sets = []
        for name, vexpr in stmt.sets:
            src, cursor = _literal_source(vexpr, vals, cursor)
            if src is None:
                return None
            try:
                cm = tm.column(name.simple)
            except errors.TddlError:
                return None
            sets.append((cm.name, src))
        ek = _eq_key(stmt.where, vals, cursor)
        if ek is None:
            return None
        col, ksrc, cursor = ek
        if cursor != len(vals):
            return None
        try:
            key_col = tm.column(col).name
        except errors.TddlError:
            return None
        if any(c.lower() == key_col.lower() for c, _ in sets):
            return None  # SET of the match key: order-sensitive, sequential
        return {"kind": "update", "key_col": key_col, "key_src": ksrc,
                "sets": sets}
    return None


def _src_value(src, vals):
    kind, v = src
    v = vals[v] if kind == "slot" else v
    return v.value if isinstance(v, DecimalParam) else v


def _encode_set_value(tm, cname: str, value):
    """One member's SET value -> (lane scalar, valid), as the sequential
    `Session._run_update` encodes it (dictionary codes for string literals,
    otherwise the binder literal and its Cast on the host), so batched and
    sequential updates store the same lanes."""
    cm = tm.column(cname)
    target = cm.dtype
    if target.is_string and isinstance(value, str):
        d = tm.dictionaries[cm.name.lower()]
        return np.asarray(d.encode_one(value, add=True), np.int32), True
    if isinstance(value, DecimalParam):
        e = ir.Literal(value.value, dt.decimal(18, value.scale))
    elif value is None:
        e = ir.lit(None, dt.NULLTYPE)
    else:
        e = ir.lit(value)
    if not (e.dtype.clazz == target.clazz and e.dtype.scale == target.scale) \
            and e.dtype.clazz != dt.TypeClass.NULL and not target.is_string:
        e = ir.Cast(e, target)
    data, valid = ExprCompiler(np).compile(e)({})
    ok = True if valid is None else bool(np.all(np.asarray(valid)))
    return np.asarray(data).astype(cm.dtype.lane), ok


class DmlBatchScheduler(BatchScheduler):
    """Leader/follower write batcher; sessions reach it through
    `Session._try_batched_dml`.  The read batcher's collection protocol (the
    adaptive window gated on live DML concurrency, group-commit pacing, early
    seal, the follower timeout), with the vectorized write flush as execution."""

    WINDOW_PARAM = "DML_BATCH_WINDOW_US"
    PREFIX = "dml_"
    COUNTER_HELP = (
        ("batched_queries", "DML statements served by a batch group"),
        ("batch_flushes", "DML batch group executions"),
        ("batch_fallbacks", "DML batch members returned to the sequential path"),
        ("batch_singletons", "DML groups flushed with a single member"))

    def enabled(self, session=None) -> bool:
        return ENABLED and bool(self.instance.config.get(
            "ENABLE_DML_BATCHING", session.vars if session is not None else None))

    def _histograms(self):
        from galaxysql_tpu_torch.utils.metrics import DML_GROUP_SIZE, DML_WAIT_MS
        return DML_GROUP_SIZE, DML_WAIT_MS

    def _async_apply_on(self) -> bool:
        return bool(self.instance.config.get("ENABLE_ASYNC_APPLY"))

    # -- group execution -------------------------------------------------------

    def _execute(self, gkey: Tuple, pp: dict, pinned_ts: Optional[int],
                 reqs: List[BatchRequest]):
        inst = self.instance
        if inst.catalog.schema_version != pp["schema_version"]:
            raise RuntimeError("schema changed under the group")  # galaxylint: disable=untyped-raise -- group fallback signal caught by the flush; never crosses the wire
        tm = inst.catalog.table(pp["schema"], pp["table"])
        store = inst.store(pp["schema"], pp["table"])
        if inst.archive.files_for(f"{tm.schema.lower()}.{tm.name.lower()}", None):
            # cold rows moved in since registration: evict the plan so later
            # statements go sequential directly instead of paying a window and a
            # fallback on every execution
            inst.dml_plans.pop((gkey[0], gkey[1]), None)
            raise RuntimeError("archive-backed table")  # galaxylint: disable=untyped-raise -- group fallback signal (archive) caught by the flush; never crosses the wire
        # one shared flush-time TSO: every member's write stamps at the instant
        # the group linearizes at
        ts = inst.tso.next_timestamp()
        poison = FAIL_POINTS.value(FP_DML_POISON_KEY) if FAIL_POINTS.active else None
        cdc_sink: List[tuple] = []
        tasks: List[dict] = []
        with inst.mdl.shared({inst.store_key(tm.schema, tm.name)}):
            if pp["kind"] == "insert":
                self._flush_insert(pp, tm, store, reqs, ts, poison, cdc_sink, tasks)
            else:
                self._flush_point_write(pp, tm, store, reqs, ts, poison,
                                        cdc_sink, tasks)
        # once per flush, not per statement: one binlog transaction, one bump, one
        # fragment-cache invalidation
        inst.cdc.write_events(ts, cdc_sink)
        tm.bump_version()
        inst.frag_cache.invalidate_table(inst.store_key(tm.schema, tm.name))
        if not tasks:
            # the synchronous apply wrote the GSI stores inline: their versions
            # move here, as after a sequential write (`Session._note_write`); the
            # async applier bumps at apply time (`AsyncApplier._finish_batch`)
            from galaxysql_tpu_torch.server.session import gsi_targets
            for _i, gtm, _g in gsi_targets(inst, tm):
                gtm.bump_version()
                inst.frag_cache.invalidate_table(inst.store_key(gtm.schema, gtm.name))
        inst.catalog.version += 1
        mark = inst.applier.enqueue(tasks) if tasks else 0
        for r in reqs:
            if r.error is None and not r.fallback:
                r.apply_seq = mark

    # -- INSERT ---------------------------------------------------------------

    def _flush_insert(self, pp, tm, store, reqs, ts, poison, cdc_sink, tasks):
        cols = pp["columns"]
        sources = pp["sources"]
        key_ix = pp["key_ix"]
        by_col: Dict[str, list] = {c: [] for c in cols}
        served: List[BatchRequest] = []
        for r in reqs:
            row = [_src_value(s, r.lane_val) for s in sources]  # resolved params
            if poison is not None and row[key_ix] == poison:
                r.error = FailPointError(
                    f"failpoint {FP_DML_POISON_KEY} fired (key {row[key_ix]!r})")
                continue
            err = self._row_error(tm, cols, row)
            if err is not None:
                r.error = err
                continue
            for c, v in zip(cols, row):
                by_col[c].append(v)
            served.append(r)
        if not served:
            return
        # append_lock: the before/after range derivation must not interleave with
        # another writer's appends
        with store.append_lock:
            try:
                # encode before any mutation: a value the column cannot take sends
                # the group to the sequential path, where only its member fails
                lanes, valid, nrows = store.encode_pylists(by_col)
            except Exception:
                for r in served:
                    r.fallback = True
                return
            before = [p.num_rows for p in store.partitions]
            try:
                store.append_encoded(lanes, valid, nrows, ts)
            except Exception as ex:
                # the mutation may be partial: errors are per member from here (a
                # fallback would apply rows that already landed again)
                for r in served:
                    r.error = ex
                return
            ranges = [(pid, before[pid], p.num_rows - before[pid])
                      for pid, p in enumerate(store.partitions)
                      if p.num_rows - before[pid]]
        async_on = self._async_apply_on() and _has_gsi(self.instance, tm)
        from galaxysql_tpu_torch.server.session import gsi_write_rows
        for pid, start, added in ranges:
            self.instance.cdc.capture_range(tm, store, pid, start, added, ts,
                                            sink=cdc_sink)
            if async_on:
                tasks.append({"kind": "gsi_insert", "tm": tm, "store": store,
                              "pid": pid, "start": start, "n": added, "ts": ts})
            else:
                gsi_write_rows(self.instance, tm, store, pid, start, added, ts, None)
        for r in served:
            r.affected = 1

    @staticmethod
    def _row_error(tm, cols, row):
        """Per-member NOT NULL check: the sequential path's store-level check,
        applied row by row so one bad member cannot fail the group."""
        have = dict(zip(cols, row))
        for c in tm.columns:
            v = have.get(c.name, c.default)
            if v is None and not c.nullable and c.default is None \
                    and not c.auto_increment:
                return errors.TddlError(f"Column '{c.name}' cannot be null")
        return None

    # -- point UPDATE / DELETE ------------------------------------------------

    def _flush_point_write(self, pp, tm, store, reqs, ts, poison, cdc_sink, tasks):
        from galaxysql_tpu_torch.server.session import gsi_delete, gsi_write_rows
        key_col = pp["key_col"]
        kind = pp["kind"]
        # unique keys only: members sharing a key depend on their order, so they
        # fall back and serialize on the sequential path
        by_key: Dict[Any, List[BatchRequest]] = {}
        for r in reqs:
            kv = _src_value(pp["key_src"], r.lane_val)
            if poison is not None and kv == poison:
                r.error = FailPointError(
                    f"failpoint {FP_DML_POISON_KEY} fired (key {kv!r})")
                continue
            if kv is None:
                r.affected = 0  # eq NULL matches nothing, as on the read path
                continue
            lane = _lane_encode(tm, key_col, kv)
            if lane is None:
                r.fallback = True
                continue
            by_key.setdefault(lane, []).append(r)
        uvals, members = [], []
        for lane, rs in by_key.items():
            if len(rs) > 1:
                for r in rs:
                    r.fallback = True
                continue
            uvals.append(lane)
            members.append(rs[0])
        if not uvals:
            return
        errs: List[Optional[BaseException]] = [None] * len(uvals)
        # SET values encode before any mutation: a bad cast fails its member
        # here, never with partitions half stamped
        set_scalars: List[Optional[list]] = [None] * len(uvals)
        if kind == "update":
            for u, r in enumerate(members):
                try:
                    set_scalars[u] = [
                        (cname,) + _encode_set_value(
                            tm, cname, _src_value(src, r.lane_val))
                        for cname, src in pp["sets"]]
                except Exception as ex:
                    errs[u] = ex
        by_pid = self._route(tm, key_col, uvals, errs, len(store.partitions))
        counts = [0] * len(uvals)
        async_on = self._async_apply_on() and _has_gsi(self.instance, tm)
        for pid in sorted(by_pid):
            part = store.partitions[pid]
            if part.num_rows == 0:
                continue
            sub = [u for u in by_pid[pid] if errs[u] is None]
            if not sub:
                continue
            try:
                # the instance's device cache: the torch program runs on the card
                # for a CUDA instance, the numpy sweep for a CPU one
                ids, offs = batched_point_lookup(
                    store, pid, part, key_col, tm.version, [uvals[i] for i in sub],
                    ts, 0, device_cache=self.instance.device_cache)
            except Exception as ex:
                for u in sub:  # this partition's keys only; the others go on
                    errs[u] = ex
                continue
            if ids.size == 0:
                continue
            # append_lock before the partition lock (every appender's order):
            # update_rows appends new versions a concurrent inserter's range
            # derivation must not take for its own
            try:
                with store.append_lock, part.lock:
                    # first writer wins, re-checked under the lock per key, so one
                    # contended row fails only its own session
                    conflict = part.end_ts[ids] != INFINITY_TS
                    keep: List[Tuple[int, int, int]] = []  # (u, lo, hi)
                    for j, u in enumerate(sub):
                        lo, hi = int(offs[j]), int(offs[j + 1])
                        if hi <= lo:
                            continue
                        if conflict[lo:hi].any():
                            errs[u] = errors.TransactionError(
                                "write conflict: row locked or deleted by a "
                                "concurrent transaction")
                            continue
                        keep.append((u, lo, hi))
                    if not keep:
                        continue
                    ok_ids = np.concatenate([ids[lo:hi] for _, lo, hi in keep])
                    seg_sizes = [hi - lo for _, lo, hi in keep]
                    self.instance.cdc.capture_rows(tm, store, pid, ok_ids, "delete",
                                                   ts, sink=cdc_sink)
                    if async_on:
                        tasks.append({"kind": "gsi_delete", "tm": tm, "store": store,
                                      "pid": pid, "row_ids": ok_ids.copy(),
                                      "ts": ts})
                    else:
                        gsi_delete(self.instance, tm, store, pid, ok_ids, ts, None)
                    if kind == "delete":
                        part.delete_rows(ok_ids, ts)
                    else:
                        start = part.num_rows
                        nl, nv = self._set_lanes(
                            tm, pp["sets"], [set_scalars[u] for u, _, _ in keep],
                            seg_sizes)
                        part.update_rows(ok_ids, nl, nv, ts)
                        if async_on:
                            tasks.append({"kind": "gsi_insert", "tm": tm,
                                          "store": store, "pid": pid, "start": start,
                                          "n": ok_ids.size, "ts": ts})
                        else:
                            gsi_write_rows(self.instance, tm, store, pid, start,
                                           ok_ids.size, ts, None)
                        self.instance.cdc.capture_range(tm, store, pid, start,
                                                        ok_ids.size, ts,
                                                        sink=cdc_sink)
                    for (u, _lo, _hi), nmatch in zip(keep, seg_sizes):
                        counts[u] += nmatch
            except Exception as ex:
                # the mutation may have begun: errors are per member from here (a
                # group fallback would apply partitions already stamped again);
                # keys already counted keep their result
                for u in sub:
                    if errs[u] is None and counts[u] == 0:
                        errs[u] = ex
        ndel = 0
        for u, r in enumerate(members):
            if r.error is None and errs[u] is not None:
                r.error = errs[u]
            elif r.error is None and not r.fallback:
                r.affected = counts[u]
                ndel += counts[u]
        if kind == "delete" and ndel:
            tm.stats.row_count = max(tm.stats.row_count - ndel, 0)

    @staticmethod
    def _set_lanes(tm, sets, member_scalars, seg_sizes):
        """A partition's SET lanes: each kept member's encoded scalar repeated over
        its matched segment (one np.repeat per SET column)."""
        new_lanes: Dict[str, np.ndarray] = {}
        new_valid: Dict[str, np.ndarray] = {}
        reps = np.asarray(seg_sizes)
        for ci, (cname, _src) in enumerate(sets):
            cm = tm.column(cname)
            datas = [ms[ci][1] for ms in member_scalars]
            valids = [ms[ci][2] for ms in member_scalars]
            new_lanes[cm.name] = np.repeat(np.asarray(datas, dtype=cm.dtype.lane), reps)
            new_valid[cm.name] = np.repeat(np.asarray(valids, dtype=np.bool_), reps)
        return new_lanes, new_valid

    # -- bookkeeping -----------------------------------------------------------

    def _bulk_finish(self, pp: dict, reqs: List[BatchRequest], flush_t: float):
        """Leader-side group finish: counters, group size, waits and each served
        member's trace lines, once per flush."""
        exec_us = (time.perf_counter() - flush_t) * 1e6
        n = len(reqs)
        nfall = served = 0
        waits = []
        profs, serve_ms = [], []
        for r in reqs:
            r.wait_us = (flush_t - r.t0) * 1e6
            waits.append(r.wait_us / 1000.0)
            if r.fallback:
                nfall += 1
                continue
            if r.error is not None:
                continue
            total_us = r.wait_us + exec_us
            r.trace = [f"dml-batch {pp['table']} {pp['kind']} "
                       f"[group={n} wait={r.wait_us:.0f}us exec={exec_us:.0f}us]",
                       f"elapsed={total_us / 1e6:.3f}s workload=TP"]
            served += 1
            if r.prof is not None:
                p = r.prof
                p.workload, p.engine, p.rows = "TP", "dml_batch", r.affected
                p.elapsed_ms = round(total_us / 1000.0, 3)
                p.trace = [f"trace-id {p.trace_id}"] + r.trace
                profs.append(p)
                serve_ms.append(total_us / 1000.0)
        group_h, wait_h = self._histograms()
        group_h.observe(n)
        wait_h.observe_many(waits)
        self._count("batch_flushes")
        self._count("batch_fallbacks", nfall)
        self._count("batched_queries", served)
        if profs:
            self._finish_served(profs, serve_ms, "dml_batch")
        with self._stats_lock:
            self.group_sizes.append(n)
            self.wait_ms.extend(waits)

    # -- observability ---------------------------------------------------------

    def stats_rows(self) -> List[Tuple[str, float]]:
        """The DML groups' rows for SHOW BATCH STATS and
        `information_schema.batch_stats`, after the read batcher's: the counters,
        group-size and wait quantiles of recent flushes, the live window state and
        the async applier's backlog and lag."""
        with self._stats_lock:
            counts = dict(self.counts)
            sizes = np.asarray(self.group_sizes, dtype=np.float64)
            waits = np.asarray(self.wait_ms, dtype=np.float64)

        def q(a, p):
            return float(np.quantile(a, p)) if a.size else 0.0

        applier = self.instance.applier
        with self._lock:
            open_groups = len(self._groups)
            window_us = self._window_s() * 1e6
        return [
            *((k, float(v)) for k, v in counts.items()),
            ("dml_group_size_mean",
             round(float(sizes.mean()), 3) if sizes.size else 0.0),
            ("dml_group_size_p50", q(sizes, 0.5)),
            ("dml_group_size_p95", q(sizes, 0.95)),
            ("dml_group_size_p99", q(sizes, 0.99)),
            ("dml_wait_ms_p50", q(waits, 0.5)),
            ("dml_wait_ms_p95", q(waits, 0.95)),
            ("dml_window_us", round(window_us, 1)),
            ("dml_open_groups", float(open_groups)),
            ("dml_inflight", float(self._inflight)),
            ("gsi_apply_backlog", float(applier.backlog)),
            ("gsi_apply_lag_ms", round(applier.lag_ms(), 3)),
        ]


def _has_gsi(instance, tm) -> bool:
    from galaxysql_tpu_torch.server.session import gsi_targets
    return bool(gsi_targets(instance, tm))
