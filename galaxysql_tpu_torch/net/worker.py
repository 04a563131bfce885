"""Worker process: a second-process engine serving shipped plan fragments (port of
`galaxysql_tpu/net/worker.py`).

The worker boots its own `Instance` (own stores, own metadb, own planner) on its
torch device and serves the reference's ops over the reference's wire
(`net/dn.py`), so a coordinator of either package can attach it:

- exec_sql: run shipped SQL in a session of its own, or in an open branch's session
  when the header names its xid; the result ships as columnar arrays (string and
  DATE/DATETIME columns as text, a DECIMAL lane as scaled int64 when the result
  batch holds it);
- exec_plan: a bound scan fragment (table, pruned columns, lane-domain SARGs,
  runtime-filter IN-lists, a point key, a branch xid) run straight against the
  store's partitions on the host, with no parse or plan;
- dml and the XA branch ops (xa_prepare, xa_commit, xa_rollback, xa_recover): one
  open local transaction a branch xid, prepared durably (`save()` before the
  PREPARED marker), committed at the coordinator's commit timestamp with its binlog
  events (`cdc.flush_txn`), and held in doubt across a restart until the coordinator
  decides it (`TwoPhaseCoordinator.recover_remote`);
- sync: the sync-action bus (plan/fragment/baseline invalidation, SET config,
  table_meta, query_log, failpoint, worker_stats, and `health`: a sample of the
  worker's own metric history with its query rate, error rate, memory tier and
  burning SLOs, the reference's);
- ping.

Every request may carry the sender's sync epoch (a missed broadcast heals the
worker's caches at the next contact), a deadline budget, and a trace context whose
spans ship back; uid-stamped writes run exactly once inside a bounded dedupe window.
Every reply carries the reference's load piggyback `wl`: the queue depth, the
memory-pressure tier, the uptime and the metric-history sample count.

    python -m galaxysql_tpu_torch.net.worker [--port P] [--data-dir DIR]
                                             [--init-sql SQL] [--device cuda|cpu]

serves on the card by default and prints `WORKER_READY <port>` once listening;
without CUDA it exits non-zero unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os as _os
import socket
import sys
import threading
import time as _time
import traceback
from typing import Dict, Optional

import numpy as np

from galaxysql_tpu_torch.net.dn import recv_msg, send_msg
from galaxysql_tpu_torch.utils import errors, events
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_WORKER_CRASH,
                                                 FP_WORKER_SLOW_DRAIN)


class Worker:
    # bounded exactly-once window: uid -> recorded response, sized so a
    # coordinator's retry horizon (seconds) fits.  Scoped to the process lifetime:
    # transactional DML that must survive a crash rides the XA branch protocol.
    DEDUPE_WINDOW = 1024

    def __init__(self, data_dir=None, device=None):
        from galaxysql_tpu_torch.server.instance import Instance
        self.instance = Instance(data_dir=data_dir, device=device)
        self.queries: list = []  # shipped-SQL log (tests assert pushdown)
        self._lock = threading.Lock()
        # open distributed-txn branches: xid -> Session with an open local txn
        self._branches: Dict[str, object] = {}
        # per-branch execution locks: a rollback on a fresh connection waits for
        # the branch's in-flight statement instead of tearing its session out
        self._branch_locks: Dict[str, threading.RLock] = {}
        # resolved-branch tombstones: a late DML that lost the lock race to its
        # own txn's rollback must not recreate the branch (bounded like the
        # dedupe window; xids are unique per txn)
        self._resolved_xids: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()
        # idempotency window: a reconnect replay of a uid-stamped write returns
        # the recorded result instead of applying twice
        self._dedupe: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self.dedupe_hits = 0
        # origin node -> last-applied broadcast epoch (persisted in the metadb so
        # a restart keeps the gap detector armed)
        self._sync_epochs: Dict[str, int] = {}
        self.heals = 0
        # in-flight request tokens: the queue-depth half of the load piggyback
        self._active: list = []

    # -- request handlers ----------------------------------------------------

    def handle(self, header: dict, arrays: Dict[str, np.ndarray]):
        if FAIL_POINTS.active and FAIL_POINTS.rpc_spec(
                FP_WORKER_CRASH, header.get("op")) is not None:
            print(f"FP_WORKER_CRASH fired on {header.get('op')}",
                  file=sys.stderr, flush=True)
            _os._exit(137)  # hard crash: no atexit, no flush
        self._active.append(None)
        try:
            if FAIL_POINTS.active:
                # a browned-out worker: alive and correct, just late; the sleep
                # sits inside the active bracket so the queue depth shows it
                spec = FAIL_POINTS.rpc_spec(FP_WORKER_SLOW_DRAIN,
                                            header.get("op"))
                if spec is not None:
                    _time.sleep(float(spec.get("ms", 25.0)) / 1000.0)
            resp, out = self._handle_epochs(header, arrays)
        finally:
            try:
                self._active.pop()
            except IndexError:  # pragma: no cover - bracket imbalance guard
                pass
        if isinstance(resp, dict):
            # backpressure piggyback: queue depth, memory-pressure tier, uptime
            # and history samples ride every reply (no device syncs)
            try:
                resp["wl"] = {"q": len(self._active),
                              "mt": self.instance.admission.governor.tier(),
                              "up": round(_time.time() - self.instance.started_at, 1),
                              "ns": self.instance.metric_history.samples_count}
            except Exception as tex:
                # load telemetry must never fail a data request, but a broken
                # piggyback is journaled once instead of swallowed
                events.publish(
                    "worker_telemetry_failed",
                    f"load piggyback failed: {type(tex).__name__}: {tex}",
                    severity="warn", dedupe="worker-wl")
        return resp, out

    def _handle_epochs(self, header: dict, arrays: Dict[str, np.ndarray]):
        origin, se = header.get("origin"), header.get("se")
        be = header.get("bcast_epoch")
        want_heal = bool(header.get("heal"))  # coordinator-tracked miss
        epoch = None
        if origin and (se is not None or be is not None):
            origin = str(origin)
            epoch = int(be if be is not None else se)
            want_heal |= self._sync_epoch_gap(origin, epoch,
                                              is_bcast=be is not None)
        if want_heal:
            # heal before the epoch advances: a failed invalidation raises, the
            # request fails and the next request retries the heal
            self._heal_caches()
        if epoch is not None:
            self._note_sync_epoch(origin, epoch)
        dl = header.get("deadline_ms")
        if dl is not None:
            # the remaining-budget form survives clock skew between processes
            header["_deadline"] = _time.time() + max(0, int(dl)) / 1000.0
        tr = header.get("trace")
        if tr:
            return self._handle_traced(header, arrays, tr)
        return self._handle(header, arrays)

    # -- sync-epoch healing --------------------------------------------------

    def _last_sync_epoch(self, origin: str) -> Optional[int]:
        """Caller holds self._lock."""
        last = self._sync_epochs.get(origin)
        if last is None:
            v = self.instance.metadb.kv_get(f"sync.epoch.{origin}")
            last = int(v) if v is not None else None
        return last

    def _sync_epoch_gap(self, origin: str, se: int, is_bcast: bool) -> bool:
        """A missed SyncBus broadcast: True when a heal is due (the stored mark
        advances only after a due heal succeeded).  Only non-broadcast requests
        drive the check: they carry the coordinator's settled epoch, while
        concurrent broadcasts may arrive out of order."""
        with self._lock:
            last = self._last_sync_epoch(origin)
            return not is_bcast and last is not None and se > last

    def _note_sync_epoch(self, origin: str, se: int):
        with self._lock:
            last = self._last_sync_epoch(origin)
            if last is None or se > last:
                self._sync_epochs[origin] = se
                self.instance.metadb.kv_put(f"sync.epoch.{origin}", str(se))

    def _heal_caches(self):
        """Wholesale invalidation (missed-broadcast repair).  Failures propagate:
        the request fails rather than record a half-done heal."""
        from galaxysql_tpu_torch.utils import events
        from galaxysql_tpu_torch.utils.metrics import SYNC_HEALS
        inst = self.instance
        inst.planner.cache.invalidate_all()
        inst.frag_cache.clear()
        inst.privileges.invalidate_cache()
        with self._lock:
            self.heals += 1
        SYNC_HEALS.inc()
        events.publish("sync_heal",
                       "missed sync broadcast detected: plan/fragment/"
                       "privilege caches wholesale-invalidated",
                       node=inst.node_id)

    # -- idempotency dedupe window -------------------------------------------

    def _dedupe_execute(self, uid: Optional[str], fn):
        """Exactly-once execution of uid-stamped writes, including a replay that
        arrives on a fresh connection while the original still runs: the window
        holds an in-flight marker, and the racer waits for the owner's outcome."""
        if not uid:
            return fn()
        while True:
            with self._lock:
                ent = self._dedupe.get(uid)
                if ent is None:
                    ev = threading.Event()
                    self._dedupe[uid] = ("pending", ev, None)
                    break  # this request owns the execution
            if ent[0] == "done":
                with self._lock:
                    self.dedupe_hits += 1
                resp = dict(ent[1])
                resp["dedup"] = True
                return resp, ent[2]
            # in flight: wait for the owner, then look again (a failed owner
            # removes the entry and the racer executes fresh)
            if not ent[1].wait(timeout=120.0):
                # the original still runs: its outcome is unknown to this replay
                return {"error": f"duplicate of uid {uid} still executing",
                        "ambiguous": True}, {}
        try:
            resp, out = fn()
        except Exception:
            with self._lock:
                self._dedupe.pop(uid, None)
            ev.set()
            raise
        with self._lock:
            if resp.get("error"):
                # nothing applied: a retry may execute again
                self._dedupe.pop(uid, None)
            else:
                self._dedupe[uid] = ("done", dict(resp), out)
                self._dedupe.move_to_end(uid)
                while len(self._dedupe) > self.DEDUPE_WINDOW:
                    # evict the oldest settled entry; in-flight markers stay
                    victim = next((k for k, v in self._dedupe.items()
                                   if v[0] != "pending"), None)
                    if victim is None:
                        break
                    del self._dedupe[victim]
        ev.set()
        return resp, out

    def _handle_traced(self, header: dict, arrays: Dict[str, np.ndarray],
                       tr: dict):
        """Run the request under a worker-local TraceContext and ship its spans
        back with this process's receive/send clocks (the coordinator corrects
        the clock offset before grafting them)."""
        from galaxysql_tpu_torch.utils import tracing
        w_recv = tracing.now_us()
        tc = tracing.TraceContext(int(tr.get("trace_id", 0)),
                                  node=self.instance.node_id)
        with tracing.activate(tc):
            with tc.span(f"worker:{header.get('op')}", kind="worker"):
                resp, out = self._handle(header, arrays)
        resp = dict(resp)
        resp["trace"] = {"w_recv_us": w_recv, "w_send_us": tracing.now_us(),
                         "spans": [s.to_dict() for s in tc.spans]}
        return resp, out

    def _handle(self, header: dict, arrays: Dict[str, np.ndarray]):
        op = header.get("op")
        if op == "ping":
            return {"ok": True, "node": self.instance.node_id}, {}

        def _deadline_gate():
            dl = header.get("_deadline")
            if dl is not None and _time.time() > dl:
                # abort before doing work; `unapplied` keeps a write caller's
                # statement-scoped semantics
                return {"error": f"deadline exceeded before {op}",
                        "errno": errors.QueryTimeoutError.errno,
                        "unapplied": True}, {}
            return None

        uid = header.get("uid") if op in ("dml", "exec_sql") else None
        if uid:
            # a replay outranks the deadline: a retry of an applied write must
            # report the recorded success
            handler = self._exec_sql if op == "exec_sql" else self._dml
            return self._dedupe_execute(
                uid, lambda: _deadline_gate() or handler(header))
        gated = _deadline_gate()
        if gated is not None:
            return gated
        if op == "exec_sql":
            return self._exec_sql(header)
        if op == "sync":
            return self._sync(header)
        if op == "exec_plan":
            return self._exec_plan(header)
        if op == "dml":
            return self._dml(header)
        if op == "xa_prepare":
            return self._xa_prepare(header)
        if op == "xa_commit":
            return self._xa_commit(header)
        if op == "xa_rollback":
            return self._xa_rollback(header)
        if op == "xa_recover":
            return self._xa_recover()
        return {"error": f"unknown op {op!r}"}, {}

    # -- distributed-txn branch ops ------------------------------------------

    def _branch_lock(self, xid: str) -> threading.RLock:
        with self._lock:
            lk = self._branch_locks.get(xid)
            if lk is None:
                lk = self._branch_locks[xid] = threading.RLock()
            return lk

    def _tombstone_branch(self, xid: str):
        """Record a resolved xid (inside the branch lock, so a parked DML sees it
        the moment it wakes)."""
        with self._lock:
            self._resolved_xids[xid] = True
            while len(self._resolved_xids) > self.DEDUPE_WINDOW * 4:
                self._resolved_xids.popitem(last=False)

    def _dml(self, header: dict):
        """Execute shipped DML inside the branch's open local transaction."""
        from galaxysql_tpu_torch.server.session import Session
        xid = header["xid"]
        with self._branch_lock(xid):
            with self._lock:
                self.queries.append(header["sql"])
                s = self._branches.get(xid)
                if s is None and xid in self._resolved_xids:
                    # a late DML must not resurrect a resolved branch as an
                    # orphaned open transaction
                    return {"error":
                            f"branch {xid!r} already resolved"}, {}
                if s is None:
                    s = Session(self.instance,
                                schema=header.get("schema") or None)
                    s.autocommit = False
                    s._begin()
                    self._branches[xid] = s
            if header.get("schema"):
                s.schema = header["schema"]
            rs = self._with_deadline(
                s, header.get("_deadline"),
                lambda: s.execute(header["sql"], header.get("params") or []))
            return {"ok": True, "affected": rs.affected}, {}

    _UNSET = object()

    @classmethod
    def _with_deadline(cls, sess, deadline, fn):
        """Run `fn` with the remaining deadline budget as the session's
        MAX_EXECUTION_TIME; a branch session's own value is restored after."""
        if deadline is None:
            return fn()
        prior = sess.vars.get("MAX_EXECUTION_TIME", cls._UNSET)
        sess.vars["MAX_EXECUTION_TIME"] = \
            max(1, int((deadline - _time.time()) * 1000))
        try:
            return fn()
        finally:
            if prior is cls._UNSET:
                sess.vars.pop("MAX_EXECUTION_TIME", None)
            else:
                sess.vars["MAX_EXECUTION_TIME"] = prior

    def _xa_prepare(self, header: dict):
        from galaxysql_tpu_torch.txn.xa import participants_of
        xid = header["xid"]
        with self._branch_lock(xid):
            s = self._branches.get(xid)
            if s is None or s.txn is None:
                return {"ok": False, "error": f"unknown branch {xid!r}"}, {}
            parts = participants_of(s.txn)
            for sp in parts:
                if not sp.prepare():
                    for done in parts:
                        done.rollback()
                    self._branches.pop(xid, None)
                    s.txn = None
                    s.close()  # a leaked session reads as an open txn
                    return {"ok": False, "error": "branch prepare failed"}, {}
            # store snapshots first, the marker last: a crash before the marker
            # means the prepare was never acknowledged (presumed abort); after it
            # the provisional rows are on disk and recovery holds them in doubt
            self.instance.save()
            self.instance.metadb.kv_put(
                f"xa.branch.{xid}",
                json.dumps({"txn_id": s.txn.txn_id, "state": "PREPARED"}))
            return {"ok": True}, {}

    def _branch_txn_id(self, xid: str):
        v = self.instance.metadb.kv_get(f"xa.branch.{xid}")
        if v is None:
            return None
        try:
            return int(json.loads(v)["txn_id"])
        except (ValueError, KeyError, TypeError):
            return None  # a corrupt record reads as no such branch

    def _finalize_stamps(self, txn_id: int, commit_ts):
        """Resolve the ±txn_id provisional stamps across all stores (the branch
        session died with the process; mirrors `recover_persisted`)."""
        from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
        own = -txn_id
        for store in self.instance.stores.values():
            for p in store.partitions:
                with p.lock:
                    if commit_ts is not None:
                        p.begin_ts[p.begin_ts == own] = commit_ts
                        p.end_ts[p.end_ts == own] = commit_ts
                    else:
                        p.end_ts[p.end_ts == own] = INFINITY_TS
                        mine = p.begin_ts == own
                        p.begin_ts[mine] = INFINITY_TS
                        p.end_ts[mine] = 0
            store.table.bump_version()
        self.instance.catalog.version += 1

    def _xa_commit(self, header: dict):
        xid = header["xid"]
        with self._branch_lock(xid):
            out = self._xa_commit_locked(header, xid)
            self._tombstone_branch(xid)
        with self._lock:
            # resolved: drop its lock entry (one RLock per txn would leak)
            self._branch_locks.pop(xid, None)
        return out

    def _xa_commit_locked(self, header, xid):
        from galaxysql_tpu_torch.txn.xa import participants_of
        commit_ts = int(header["commit_ts"])
        # the coordinator's TSO is the clock: local snapshots must pass the
        # commit stamp or the new rows would be invisible to local reads
        self.instance.tso.observe(commit_ts)
        s = self._branches.pop(xid, None)
        if s is not None and s.txn is not None:
            txn = s.txn
            s.txn = None
            for sp in participants_of(txn):
                sp.commit(commit_ts)
            self.instance.cdc.flush_txn(txn, commit_ts)
            self.instance.catalog.version += 1
            s.close()
            txn_id = txn.txn_id
        else:
            txn_id = self._branch_txn_id(xid)
            if txn_id is None:
                # idempotent: the branch is already resolved (a re-sent commit)
                return {"ok": True, "already": True}, {}
            self._finalize_stamps(txn_id, commit_ts)
        self.instance.metadb.tx_log_put(txn_id, "DONE", commit_ts)
        self.instance.metadb.kv_put(f"xa.branch.{xid}",
                                    json.dumps({"txn_id": txn_id,
                                                "state": "DONE"}))
        self.instance.save()
        return {"ok": True}, {}

    def _xa_rollback(self, header: dict):
        xid = header["xid"]
        # serialized against an in-flight _dml of the same branch
        with self._branch_lock(xid):
            out = self._xa_rollback_locked(xid)
            self._tombstone_branch(xid)
        with self._lock:
            self._branch_locks.pop(xid, None)
        return out

    def _xa_rollback_locked(self, xid):
        from galaxysql_tpu_torch.txn.xa import participants_of
        s = self._branches.pop(xid, None)
        if s is not None and s.txn is not None:
            txn = s.txn
            s.txn = None
            for sp in participants_of(txn):
                sp.rollback()
            s.close()
            txn_id = txn.txn_id
        else:
            txn_id = self._branch_txn_id(xid)
            if txn_id is None:
                return {"ok": True, "already": True}, {}
            self._finalize_stamps(txn_id, None)
        self.instance.metadb.tx_log_put(txn_id, "ABORTED")
        self.instance.metadb.kv_put(f"xa.branch.{xid}",
                                    json.dumps({"txn_id": txn_id,
                                                "state": "ABORTED"}))
        self.instance.save()
        return {"ok": True}, {}

    def _xa_recover(self):
        """The PREPARED (in-doubt) branches, for the coordinator to resolve."""
        xids = []
        for k, v in self.instance.metadb.kv_scan("xa.branch."):
            try:
                if json.loads(v).get("state") == "PREPARED":
                    xids.append(k[len("xa.branch."):])
            except (ValueError, AttributeError):
                continue  # one corrupt record must not hide the other xids
        return {"ok": True, "xids": xids}, {}

    def _exec_sql(self, header: dict):
        from galaxysql_tpu_torch.server.session import Session
        from galaxysql_tpu_torch.utils import tracing
        sql = header["sql"]
        with self._lock:
            self.queries.append(sql)
        tc = tracing.current()

        def scope(name):
            return tc.span(name, kind="operator") if tc is not None \
                else contextlib.nullcontext()
        # an xid routes the statement through that branch's open session, so
        # reads see the branch's own uncommitted writes
        branch = self._branches.get(header.get("xid")) \
            if header.get("xid") else None
        dl = header.get("_deadline")
        if branch is not None:
            if header.get("schema"):
                branch.schema = header["schema"]
            with scope("execute"):
                rs = self._with_deadline(branch, dl,
                                         lambda: branch.execute(sql))
            with scope("serialize"):
                return self._serialize_rs(rs)
        s = Session(self.instance, schema=header.get("schema") or None)
        try:
            with scope("execute"):
                rs = self._with_deadline(s, dl, lambda: s.execute(sql))
            with scope("serialize"):
                return self._serialize_rs(rs)
        finally:
            s.close()

    @staticmethod
    def _serialize_rs(rs):
        """ResultSet -> wire response (the plain and the branch paths)."""
        cols = rs.names
        arrays: Dict[str, np.ndarray] = {}
        types = []
        batch_cols = None
        if rs.batch is not None:
            bc = rs.batch.compact()
            if len(bc.names()) == len(rs.names):
                batch_cols = [bc.columns[n] for n in bc.names()]
        for i, (name, typ) in enumerate(zip(rs.names, rs.types)):
            vals = [r[i] for r in rs.rows]
            valid = np.array([v is not None for v in vals], dtype=bool)
            if typ.is_string:
                data = np.array([v if v is not None else "" for v in vals],
                                dtype=object).astype(str)
            elif typ.sql_name().startswith("DECIMAL") and batch_cols is not None:
                # lane-exact: the scaled int64 lane itself (a float round trip
                # loses digits past 15-16)
                data = batch_cols[i].np_data().astype(np.int64)
                arrays[f"d::{name}"] = data
                if not valid.all():
                    arrays[f"v::{name}"] = valid
                types.append(typ.sql_name() + "#scaled")
                continue
            elif typ.sql_name().startswith(("DECIMAL", "DOUBLE", "FLOAT")):
                data = np.array([v if v is not None else 0.0 for v in vals],
                                dtype=np.float64)
            elif typ.sql_name() in ("DATE", "DATETIME"):
                data = np.array([v if v is not None else "" for v in vals],
                                dtype=object).astype(str)
            else:
                data = np.array([v if v is not None else 0 for v in vals],
                                dtype=np.int64)
            arrays[f"d::{name}"] = data
            if not valid.all():
                arrays[f"v::{name}"] = valid
            types.append(typ.sql_name())
        return ({"columns": cols, "types": types, "rows": len(rs.rows),
                 "affected": rs.affected}, arrays)

    _SARG_OPS = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
                 "gt": np.greater, "ge": np.greater_equal}

    @staticmethod
    def _wire_text(lane: np.ndarray, text_of) -> np.ndarray:
        """Format each distinct lane value once and gather: the array the
        reference builds value by value (`np.array(list, object).astype(str)`,
        so the same values and the same `<U` width)."""
        if not lane.size:
            return np.zeros(0, dtype="U1")
        uniq, inv = np.unique(lane, return_inverse=True)
        text = np.array([text_of(x) for x in uniq.tolist()],
                        dtype=object).astype(str)
        return text[inv.reshape(-1)]

    @classmethod
    def _wire_lane(cls, tm, cname: str, lane: np.ndarray):
        """Lane -> wire array + type tag: the one encoder for fragment results and
        deleted-key lists (strings decode through the dictionary, DATE/DATETIME
        format to text, DECIMAL ships scaled int64 tagged '#scaled')."""
        cm = tm.column(cname)
        tname = cm.dtype.sql_name()
        if cm.dtype.is_string:
            d = tm.dictionaries.get(cname.lower())
            if d is None:
                return (np.array([""] * lane.size, dtype=object).astype(str)
                        if lane.size else np.zeros(0, dtype="U1")), tname
            n = len(d.values)
            return cls._wire_text(lane, lambda c: d.values[c]
                                  if 0 <= c < n else ""), tname
        if tname.startswith("DECIMAL"):
            return lane.astype(np.int64), tname + "#scaled"
        if tname in ("DATE", "DATETIME"):
            from galaxysql_tpu_torch.types import temporal
            fmt = temporal.format_date if tname == "DATE" \
                else temporal.format_datetime
            return cls._wire_text(lane, fmt), tname
        if tname in ("DOUBLE", "FLOAT"):
            return lane.astype(np.float64), tname
        return lane.astype(np.int64), tname

    def _exec_plan(self, header: dict):
        """Execute a shipped scan fragment straight against the store: table,
        pruned columns, lane-domain SARGs, optional point key.  An unsupported
        shape raises and the coordinator degrades to SQL text."""
        from galaxysql_tpu_torch.utils import tracing
        f = header["fragment"]
        with self._lock:
            self.queries.append(f"PLAN:{f['schema']}.{f['table']}"
                                f":{','.join(f['columns'])}")
        inst = self.instance
        tm = inst.catalog.table(f["schema"], f["table"])
        store = inst.store(f["schema"], f["table"])
        snapshot = inst.tso.next_timestamp()
        # read-your-own-writes across the seam: a fragment carrying the session's
        # branch xid sees that branch's provisional rows
        txn_id = 0
        bs = self._branches.get(f.get("xid")) if f.get("xid") else None
        if bs is not None and bs.txn is not None:
            txn_id = bs.txn.txn_id
        point = f.get("point")
        # the coordinator ships point keys already in the lane domain
        lane_point = point[1] if point is not None else None
        sargs = f.get("sargs") or []
        since = f.get("since")  # delta reads (an online table move's catch-up)
        del_of = f.get("deleted_since_of")
        cols_out: Dict[str, list] = {c: [] for c in f["columns"]}
        valid_out: Dict[str, list] = {c: [] for c in f["columns"]}
        deleted_keys: list = []
        # traced fragments: scan / rf-prune / serialize child spans under the
        # worker root (grafted into the coordinator's tree by the RPC layer)
        tc = tracing.current()
        scan_scope = tc.span("scan", kind="operator",
                             table=f"{f['schema']}.{f['table']}") \
            if tc is not None else contextlib.nullcontext()
        # rf-prune attribution only when traced: counting rows costs a pass
        rf_clock = [0.0, 0] \
            if tc is not None and (f.get("rf_in") or sargs) else None
        with scan_scope:
            err = self._exec_plan_scan(f, store, snapshot, txn_id, lane_point,
                                       point, sargs, since, del_of, cols_out,
                                       valid_out, deleted_keys, rf_clock,
                                       deadline=header.get("_deadline"))
        if err is not None:
            return err, {}
        if rf_clock is not None:
            tc.add("rf-prune", kind="operator",
                   dur_us=round(rf_clock[0] * 1e6, 1),
                   rows_pruned=rf_clock[1])
        ser_scope = tc.span("serialize", kind="operator") \
            if tc is not None else contextlib.nullcontext()
        with ser_scope:
            return self._exec_plan_reply(f, tm, del_of, cols_out, valid_out,
                                         deleted_keys, snapshot)

    def _exec_plan_scan(self, f, store, snapshot, txn_id, lane_point, point,
                        sargs, since, del_of, cols_out, valid_out,
                        deleted_keys, rf_clock, deadline=None):
        """The fragment's scan on the host, a partition at a time (the reference
        reads the partitions directly, not through the device)."""
        from galaxysql_tpu_torch.storage.table_store import visible_rows
        for p in store.partitions:
            if deadline is not None and _time.time() > deadline:
                # a partition boundary is the worker's drain boundary
                raise errors.QueryTimeoutError(
                    f"fragment deadline exceeded scanning "
                    f"{f['schema']}.{f['table']}")
            if p.num_rows == 0:
                continue
            with p.lock:
                if lane_point is not None:
                    ids = p.key_candidates(point[0], lane_point)
                    if ids.size == 0:
                        continue
                    # visibility over the candidate slice only
                    keep = p.valid[point[0]][ids] & visible_rows(
                        p.begin_ts[ids], p.end_ts[ids], snapshot, txn_id)
                    ids = ids[keep]
                else:
                    vis = p.visible_mask(snapshot, txn_id)
                    if since is not None:
                        vis = vis & (p.begin_ts > int(since))
                    t_rf = _time.perf_counter() if rf_clock is not None else 0.0
                    before = int(vis.sum()) if rf_clock is not None else 0
                    for col, op, val in sargs:
                        opf = self._SARG_OPS.get(op)
                        if opf is None:
                            return {"error": f"unsupported sarg op {op!r}"}
                        lane = p.lanes[col]
                        # integer lanes compare in int64: a float64 cast
                        # collapses values past 2^53
                        if isinstance(val, int) and \
                                np.issubdtype(lane.dtype, np.integer):
                            vis = vis & p.valid[col] & \
                                opf(lane.astype(np.int64), np.int64(val))
                        else:
                            vis = vis & p.valid[col] & \
                                opf(lane.astype(np.float64), float(val))
                    for col, vals in (f.get("rf_in") or []):
                        # a small join build's runtime-filter IN-list: exact
                        # membership before rows cross the process seam
                        lane = p.lanes[col]
                        arr = np.asarray(vals)
                        vis = vis & p.valid[col] & \
                            np.isin(lane, arr.astype(lane.dtype, copy=False))
                    ids = np.nonzero(vis)[0]
                    if rf_clock is not None:
                        rf_clock[0] += _time.perf_counter() - t_rf
                        rf_clock[1] += before - int(ids.size)
                if del_of is not None:
                    dmask = (p.end_ts >= 0) & (p.end_ts > int(since or 0)) & \
                        (p.end_ts <= snapshot)
                    if dmask.any():
                        deleted_keys.append(p.lanes[del_of][dmask])
                if ids.size == 0:
                    continue
                for c in f["columns"]:
                    cols_out[c].append(p.lanes[c][ids])
                    valid_out[c].append(p.valid[c][ids])
        return None

    def _exec_plan_reply(self, f, tm, del_of, cols_out, valid_out,
                         deleted_keys, snapshot):
        """Wire-encode the gathered lanes (the `serialize` span's work)."""
        arrays: Dict[str, np.ndarray] = {}
        types = []
        for c in f["columns"]:
            lane = (np.concatenate(cols_out[c]) if cols_out[c]
                    else np.zeros(0, dtype=tm.column(c).dtype.lane))
            v = (np.concatenate(valid_out[c]) if valid_out[c]
                 else np.zeros(0, dtype=np.bool_))
            arr, tname = self._wire_lane(tm, c, lane)
            arrays[f"d::{c}"] = arr
            if lane.size and not bool(v.all()):
                arrays[f"v::{c}"] = v
            types.append(tname)
        if del_of is not None:
            dk = (np.concatenate(deleted_keys) if deleted_keys
                  else np.zeros(0, dtype=np.int64))
            # the wire-value domain, so the caller's DELETE literals match
            arrays["deleted::keys"], _ = self._wire_lane(tm, del_of, dk)
        n = int(arrays[f"d::{f['columns'][0]}"].shape[0]) if f["columns"] else 0
        return ({"columns": list(f["columns"]), "types": types, "rows": n,
                 "affected": 0, "snapshot": snapshot}, arrays)

    def _sync(self, header: dict):
        """The sync-action bus."""
        action = header.get("action")
        payload = header.get("payload") or {}
        inst = self.instance
        if action == "invalidate_plan_cache":
            inst.planner.cache.invalidate_all()
            return {"ok": True, "action": action}, {}
        if action == "invalidate_fragment_cache":
            # a coordinator wrote a table this node may hold cached fragments
            # of: bump the epoch (remote-keyed fragments) and drop the entries
            key = payload.get("table_key") or \
                (f"{payload.get('schema', '').lower()}"
                 f".{payload.get('table', '').lower()}")
            inst.frag_cache.bump_epoch(key)
            return {"ok": True, "action": action}, {}
        if action == "invalidate_baselines":
            for row in list(inst.planner.spm.rows()):
                inst.planner.spm.delete(row[0])
            return {"ok": True, "action": action}, {}
        if action == "set_config":
            inst.config.set_instance(payload["name"], payload["value"])
            return {"ok": True, "action": action}, {}
        if action == "table_meta":
            tm = inst.catalog.table(payload["schema"], payload["table"])
            return {"ok": True,
                    "columns": [[c.name, c.dtype.sql_name().split("(")[0],
                                 c.dtype.precision, c.dtype.scale, c.nullable]
                                for c in tm.columns],
                    "primary_key": list(tm.primary_key)}, {}
        if action == "query_log":
            with self._lock:
                return {"ok": True, "queries": list(self.queries)}, {}
        if action == "failpoint":
            # remote fault arming (e.g. FP_WORKER_CRASH)
            if payload.get("clear"):
                FAIL_POINTS.clear()
            elif payload.get("disarm"):
                FAIL_POINTS.disarm(payload["key"])
            else:
                FAIL_POINTS.arm(payload["key"], payload.get("value", True))
            return {"ok": True, "action": action}, {}
        if action == "worker_stats":
            with self._lock:
                return {"ok": True, "node": inst.node_id,
                        "dedupe_entries": len(self._dedupe),
                        "dedupe_hits": self.dedupe_hits,
                        "heals": self.heals,
                        "sync_epochs": dict(self._sync_epochs)}, {}
        if action == "health":
            # the SLO plane's cluster view: the worker runs the same sampler over
            # its own registries; a pull takes an interval-gated sample, then
            # reports a snapshot summary
            mh = inst.metric_history
            mh.maybe_sample()
            return {"ok": True, "action": action, "node": inst.node_id,
                    "uptime_s": round(_time.time() - inst.started_at, 3),
                    "active": float(len(self._active)),
                    "qps": round(mh.rate("queries_total"), 3),
                    "error_rate": round(mh.rate("query_errors"), 6),
                    "mem_tier": int(inst.admission.governor.tier()),
                    "samples": int(mh.summary()["samples"]),
                    "burning": inst.slo.burning_names()}, {}
        return {"error": f"unknown sync action {action!r}"}, {}

    # -- server loop ---------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        self.port = srv.getsockname()[1]
        print(f"WORKER_READY {self.port}", flush=True)
        while True:
            conn, _ = srv.accept()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                header, arrays = recv_msg(conn)
                try:
                    resp, out = self.handle(header, arrays)
                except Exception as e:
                    traceback.print_exc(file=sys.stderr)
                    # typed errors keep their errno across the wire, so the
                    # coordinator raises the same class again
                    resp, out = {"error": f"{type(e).__name__}: {e}",
                                 "errno": int(getattr(e, "errno", 1105)
                                              or 1105)}, {}
                try:
                    send_msg(conn, resp, out)
                except errors.ProtocolError as pe:
                    # an oversized result: encode_msg refused it before any byte
                    # shipped, so the stream is still aligned
                    send_msg(conn, {"error": str(pe), "errno": pe.errno}, {})
        except (ConnectionError, OSError):
            pass
        except errors.ProtocolError:
            # a corrupt frame: the stream is unrecoverable, drop the connection
            traceback.print_exc(file=sys.stderr)
        finally:
            conn.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the torch device the worker's instance runs on "
                         "(default: cuda; cpu only when asked)")
    ap.add_argument("--init-sql", default=None,
                    help="semicolon-separated bootstrap statements")
    args = ap.parse_args(argv)
    try:
        w = Worker(data_dir=args.data_dir, device=args.device)
    except RuntimeError as e:
        print(f"worker: {e}", file=sys.stderr, flush=True)
        sys.exit(2)
    if args.init_sql:
        from galaxysql_tpu_torch.server.session import Session
        s = Session(w.instance)
        s.execute(args.init_sql)
        s.close()
    w.serve(port=args.port)


if __name__ == "__main__":
    main()
