"""Asynchronous apply of GSI maintenance (port of `galaxysql_tpu/txn/async_apply.py`).

The batched write path (`server/dml_batch.py`) enqueues its GSI work here instead of
writing every global secondary index inside the flush: the base rows a flush group
appended or deleted propagate into every GSI store in one apply per flush task (the
lanes are MVCC-immutable, so deferred reads of the enqueued row ids and ranges are
stable).  An autocommit write to a remote table with replicas enqueues its replica
legs here (`replica` tasks, `Session._remote_dml`): each ships as a branch DML and
xa_commit at the statement's commit timestamp, uid-stamped so the worker's dedupe
window makes a retry exactly-once; a leg that still fails marks its replica stale
(excluded from reads until rebuilt), the synchronous path's contract applied late.

Read-your-writes: `enqueue` returns a monotonic watermark; the writing session keeps
it and its own next statement waits (bounded by APPLY_WAIT_MS) until `applied_seq`
reaches it (`Session._apply_fence`).  Other sessions never wait: they see GSI rows
eventually, within the apply lag that `lag_ms()` and the `gsi_apply_backlog` /
`gsi_apply_lag_ms` values show (SHOW BATCH STATS).

The worker thread is lazy (created on the first enqueue, daemon).  Version bumps
happen once per drained batch, at apply time: a cached covering-index scan never
serves a half-applied GSI state, because the GSI's version moves only when the apply
has landed.  Only idempotent tasks retry: a `gsi_delete` three times (re-stamping by
primary key is a no-op), a `gsi_insert` once (a retry of a partial append would
append twice).

The counters `gsi_async_applies`, `replica_async_applies` and `async_apply_failures`
and the gauges `gsi_apply_backlog` and `gsi_apply_lag_ms` live in the instance's
metrics registry under the reference's names, and a task that still fails publishes
`async_apply_failed` (a stranded replica branch `replica_cleanup_failed`) into the
event journal, as in the reference.  `backlog`, `peak_backlog` and `peak_lag_ms`
stay as plain values beside the gauges for the chip smoke's peaks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from galaxysql_tpu_torch.utils import errors, events
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_APPLY_DELAY_MS


class AsyncApplier:
    """Per-Instance background applier with a FIFO queue and watermarks."""

    IDLE_WAIT_S = 0.5

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Tuple[int, float, dict]] = []  # (seq, t, task)
        self._seq = 0
        self.applied_seq = 0
        self._thread: Optional[threading.Thread] = None
        # the reference's gauge `gsi_apply_backlog` (`lag_ms()` is its
        # `gsi_apply_lag_ms`), and the largest of each since the instance began
        self.backlog = 0
        self.peak_backlog = 0
        self.peak_lag_ms = 0.0
        m = instance.metrics
        self.gsi_applies = m.counter(
            "gsi_async_applies", "GSI maintenance tasks applied async")
        self.replica_applies = m.counter(
            "replica_async_applies", "replica DML legs applied async")
        self.apply_failures = m.counter(
            "async_apply_failures", "async apply tasks that failed "
            "(GSI apply error or replica marked stale)")
        self.backlog_gauge = m.gauge(
            "gsi_apply_backlog", "async apply tasks queued, not yet applied")
        self.lag_gauge = m.gauge(
            "gsi_apply_lag_ms", "age of the oldest pending async apply task")

    # -- producer side -------------------------------------------------------

    def enqueue(self, tasks: List[dict]) -> int:
        """Append tasks FIFO; returns the watermark covering all of them.  A session
        fences its own reads on this value (`wait_applied`)."""
        now = time.time()
        with self._cond:
            for t in tasks:
                self._seq += 1
                self._queue.append((self._seq, now, t))
            mark = self._seq
            self.backlog = len(self._queue)
            self.peak_backlog = max(self.peak_backlog, self.backlog)
            self.backlog_gauge.set(self.backlog)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="async-applier", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return mark

    def wait_applied(self, mark: int, timeout_s: float) -> bool:
        """Block until `applied_seq >= mark` (read-your-writes fence)."""
        if self.applied_seq >= mark:
            return True
        deadline = time.time() + timeout_s
        with self._cond:
            while self.applied_seq < mark:
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.1))
        return True

    def pending(self) -> bool:
        """Anything enqueued but not yet applied?"""
        return self.applied_seq < self._seq

    def barrier(self, timeout_s: float) -> bool:
        """Wait for everything enqueued so far (sequential DML on a GSI-bearing
        table must not race pending applies)."""
        return self.wait_applied(self._seq, timeout_s)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for the whole queue to apply (checkpoints, tests)."""
        with self._lock:
            mark = self._seq
        return self.wait_applied(mark, timeout_s)

    def lag_ms(self) -> float:
        with self._lock:
            if not self._queue:
                return 0.0
            return (time.time() - self._queue[0][1]) * 1000.0

    # -- consumer side -------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait(self.IDLE_WAIT_S)
                batch = self._queue
                self._queue = []
            delay = FAIL_POINTS.value(FP_APPLY_DELAY_MS) \
                if FAIL_POINTS.active else None
            if delay:
                time.sleep(float(delay) / 1000.0)
            touched: Dict[str, Any] = {}
            for _seq, _t0, task in batch:
                attempts = 3 if task.get("kind") == "gsi_delete" else 1
                for att in range(attempts):
                    try:
                        self._apply(task, touched)
                        break
                    except Exception as ex:
                        if att + 1 < attempts:
                            time.sleep(0.05 * (att + 1))
                            continue
                        self.apply_failures.inc()
                        try:
                            events.publish(
                                "async_apply_failed",
                                f"{task.get('kind')} apply failed after "
                                f"{attempts} attempt(s): "
                                f"{type(ex).__name__}: {ex}",
                                severity="error",
                                node=self.instance.node_id,
                                kind=task.get("kind", ""))
                        except Exception:  # galaxylint: disable=swallow -- guards the journal itself; there is nowhere left to report to
                            pass
            self._finish_batch(touched)
            with self._cond:
                self.applied_seq = batch[-1][0]
                self.backlog = len(self._queue)
                self.backlog_gauge.set(self.backlog)
                self.peak_lag_ms = max(self.peak_lag_ms,
                                       (time.time() - batch[0][1]) * 1000.0)
                self.lag_gauge.set(
                    (time.time() - self._queue[0][1]) * 1000.0
                    if self._queue else 0.0)
                self._cond.notify_all()

    def _apply(self, task: dict, touched: Dict[str, Any]):
        from galaxysql_tpu_torch.server import session as _sess
        kind = task["kind"]
        if kind == "replica":
            self._apply_replica(task)
            return
        tm = task["tm"]
        if kind == "gsi_insert":
            _sess.gsi_write_rows(self.instance, tm, task["store"], task["pid"],
                                 task["start"], task["n"], task["ts"], None)
        elif kind == "gsi_delete":
            _sess.gsi_delete(self.instance, tm, task["store"], task["pid"],
                             task["row_ids"], task["ts"], None)
        else:  # pragma: no cover - queue corruption guard
            raise errors.TddlError(f"unknown async apply task kind {kind!r}")
        self.gsi_applies.inc()
        for _i, gtm, _g in _sess.gsi_targets(self.instance, tm):
            touched[f"{gtm.schema.lower()}.{gtm.name.lower()}"] = gtm

    def _finish_batch(self, touched: Dict[str, Any]):
        """Version and cache hygiene once per drained batch: bump every touched
        GSI's version and drop its cached fragments, so version-keyed caches
        (fragment cache, device lanes) re-key now that the apply has landed."""
        if not touched:
            return
        for key, gtm in touched.items():
            gtm.bump_version()
            self.instance.frag_cache.invalidate_table(key)
        self.instance.catalog.version += 1

    def _apply_replica(self, task: dict):
        """Ship one replica DML leg: dml and xa_commit under a fresh branch xid,
        uid-stamped (a reconnect retry replays the recorded response).  A leg
        that fails marks the replica stale and rolls its branch back."""
        addr = task["addr"]
        client = self.instance.workers.get(addr)
        uid = task["uid"]
        xid = f"a{uid.replace(':', '_')}"
        try:
            if client is None:
                raise ConnectionError(f"worker {addr} not attached")
            deadline = time.time() + task.get("timeout_s", 30.0)
            client.request({"op": "dml", "xid": xid, "schema": task["schema"],
                            "sql": task["sql"], "uid": uid,
                            "params": list(task.get("params") or [])},
                           deadline=deadline)
            client.request({"op": "xa_commit", "xid": xid,
                            "commit_ts": int(task["commit_ts"])},
                           deadline=deadline)
            self.replica_applies.inc()
        except Exception:
            self.apply_failures.inc()
            self._mark_stale(task)
            if client is not None:
                try:
                    client.request({"op": "xa_rollback", "xid": xid},
                                   deadline=time.time() + 5.0)
                except Exception as cex:
                    # the branch stays in doubt until xa_recover resolves it
                    from galaxysql_tpu_torch.utils import events
                    events.publish(
                        "replica_cleanup_failed",
                        f"replica rollback for {xid} failed "
                        f"({type(cex).__name__}); branch resolves via "
                        f"xa_recover", severity="warn",
                        node=self.instance.node_id,
                        dedupe=f"apply-rb:{task.get('addr')}")
            raise

    def _mark_stale(self, task: dict):
        try:
            tm = self.instance.catalog.table(task["base_schema"], task["base_table"])
        except errors.TddlError:
            return
        for r in getattr(tm, "replicas", []):
            if (r["host"], r["port"]) == task["addr"]:
                r["stale"] = True
