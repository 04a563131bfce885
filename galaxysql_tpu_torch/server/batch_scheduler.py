"""Cross-session batched point reads (trimmed port of
`galaxysql_tpu/server/batch_scheduler.py`).

The scheduler coalesces sessions executing the SAME parameterized point statement
(plan-cache identity: `ParameterizedSql.cache_key` + the registered PointPlan)
inside a short collection window into ONE vectorized lookup: the parameter keys
are stacked into one device program per partition
(`exec/operators.batched_point_lookup`), results gathered once and scattered back
per session.

Protocol (leader/follower, no dedicated threads):

- `submit()` under the scheduler lock either JOINS an open group for the
  statement (follower: parks on a per-request event) or OPENS one (leader).
- The leader waits the collection window — adaptive: the window opens only
  when several point queries are IN FLIGHT right now (sequential traffic sees
  window 0 and falls straight back to the unbatched fast path) and sizes itself
  by the observed arrival rate toward `MAX_WINDOW_S` — then seals the group,
  executes it, scatters rows/errors, and wakes followers.
- A group that fills to `BATCH_MAX_GROUP` (at most the 1,024-key bucket cap), or
  that the open-time in-flight demand has all joined, seals early.  While a
  statement's flush drains, its next group keeps collecting (group-commit
  pacing).  A follower whose leader never sealed returns to the sequential path
  after 5 s.

Correctness envelope:

- Snapshot semantics: autocommit sessions share ONE flush-time TSO; sessions
  inside a read-only transaction group only with sessions pinned to the SAME
  snapshot (the group key carries `pinned_ts`); sessions whose transaction holds
  writes bypass batching (the caller checks).
- Error isolation: a poisoned key fails only its own session(s)
  (`FP_BATCH_POISON_KEY` is the lever); any group-scope failure sends every
  member back to the sequential path.
- Plan validity: the group key carries the catalog schema_version; a change
  between submit and flush fails the version re-check and falls back.

The counters (`batched_queries`, `batch_flushes`, `batch_fallbacks`,
`batch_singletons`) and the group-size and wait histograms (`batch_group_size`,
`batch_wait_ms`) are the reference's, in the instance's metrics registry; the leader
fills each served member's QueryProfile and records the group's profiles and query
metrics once a flush, as the reference does.  Trimmed against the reference: the
SHOW BATCH STATS quantiles come from the recent flushes kept here; the memory-pool
child is dropped; `events.publish` becomes a line in `trace`; the `GALAXYSQL_BATCHING`
environment switch is not carried over — `ENABLE_BATCH_SCHEDULER`, read in the
session's scope, does the same.  The flush holds the shared MDL of its table, and a
table with archived rows falls back to the sequential path, as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Column
from galaxysql_tpu_torch.exec.operators import BATCH_MAX_KEYS, batched_point_lookup
from galaxysql_tpu_torch.meta.catalog import PartitionRouter
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_BATCH_POISON_KEY,
                                                 FailPointError)

_HISTORY = 1 << 16  # recent flushes kept for the group-size and wait quantiles


@dataclasses.dataclass
class BatchRequest:
    """One session's slot in a group; the leader fills rows/error/fallback."""

    lane_val: Any
    t0: float
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    rows: Optional[List[tuple]] = None
    error: Optional[BaseException] = None
    fallback: bool = False
    wait_us: float = 0.0
    trace: List[str] = dataclasses.field(default_factory=list)
    # DML members (`server/dml_batch.py`): affected-row count and the async-apply
    # watermark the session fences its own reads on (0 = nothing async)
    affected: int = 0
    apply_seq: int = 0
    # the session's QueryProfile: the leader bulk-finishes it
    prof: Any = None


class _Group:
    __slots__ = ("gkey", "pp", "pinned_ts", "requests", "t0", "full",
                 "sealed", "target")

    def __init__(self, gkey, pp, pinned_ts, t0, target=None):
        self.gkey = gkey
        self.pp = pp
        self.pinned_ts = pinned_ts
        self.requests: List[BatchRequest] = []
        self.t0 = t0
        self.full = threading.Event()
        self.sealed = False
        # adaptive mode: the in-flight demand at open time — once this many
        # members joined, all known demand has arrived and the group seals
        # without waiting out the window (None = pinned-window mode)
        self.target = target


class BatchScheduler:
    """Per-Instance scheduler; sessions reach it via `_try_batched_point`."""

    # the config parameter naming the fixed-window override, and the prefix of the
    # counters' names (the DML batcher rebinds both: `server/dml_batch.py`)
    WINDOW_PARAM = "BATCH_WINDOW_US"
    PREFIX = ""
    # the registry counters' names (after PREFIX) and help texts, the reference's
    COUNTER_HELP = (
        ("batched_queries", "point queries served by a batch group"),
        ("batch_flushes", "batch group executions (vectorized flushes)"),
        ("batch_fallbacks", "batch members returned to the sequential path"),
        ("batch_singletons", "groups flushed with a single member"))

    MIN_WINDOW_S = 100e-6
    MAX_WINDOW_S = 500e-6
    # adaptive collection extends past one window quantum WHILE members keep
    # arriving (follower wake->resubmit is serialized by the interpreter); this
    # caps the total collection time of any one group
    MAX_COLLECT_S = 25e-3
    # below this many point queries in flight RIGHT NOW, batching cannot pay for
    # its wait: the window collapses to 0 and sequential traffic keeps its p50
    MIN_INFLIGHT = 4
    TARGET_GROUP = 256  # window sizes itself to collect about this many
    FOLLOWER_TIMEOUT_S = 5.0

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._groups: Dict[Tuple, _Group] = {}
        # group-commit pacing: gkey -> done-event of the flush in progress
        self._flush_done: Dict[Tuple, threading.Event] = {}
        # point-path executions in flight right now; deque append/pop are single
        # GIL-atomic operations, so the two-per-query bracket never parks a thread
        self._inflight_tokens: collections.deque = collections.deque()
        # EWMA of submit inter-arrival gap (seconds); starts "slow"
        self._interval_ewma = 1.0
        self._last_arrival = time.perf_counter()
        self._window_open_s = 0.0
        self._born = time.perf_counter()
        self._stats_lock = threading.Lock()
        m = instance.metrics
        self._counters = {self.PREFIX + n: m.counter(self.PREFIX + n, h)
                          for n, h in self.COUNTER_HELP}
        self.group_sizes: collections.deque = collections.deque(maxlen=_HISTORY)
        self.wait_ms: collections.deque = collections.deque(maxlen=_HISTORY)
        self.trace: collections.deque = collections.deque(maxlen=256)

    @property
    def counts(self) -> Dict[str, int]:
        """The counters' values by name (the metrics registry holds them)."""
        return {k: c.value for k, c in self._counters.items()}

    def _count(self, name: str, n: int = 1):
        if n:
            self._counters[self.PREFIX + name].inc(n)

    def _histograms(self):
        """The process-shared group-size and collection-wait histograms."""
        from galaxysql_tpu_torch.utils.metrics import BATCH_GROUP_SIZE, BATCH_WAIT_MS
        return BATCH_GROUP_SIZE, BATCH_WAIT_MS

    def _finish_served(self, served: list, serve_ms: list, engine: str):
        """Record the served members' profiles and bump the query metrics once
        for the flush (the reference's bulk finish)."""
        from galaxysql_tpu_torch.utils.tracing import GLOBAL_STATS
        inst = self.instance
        inst.profiles.record_many(served)
        lat_h, q_total, q_wl, q_eng = inst.finish_handles("TP", engine)
        lat_h.observe_many(serve_ms)
        q_total.inc(len(served))
        q_wl.inc(len(served))
        q_eng.inc(len(served))
        GLOBAL_STATS.bump("queries", len(served))

    # -- gating ----------------------------------------------------------------

    def enabled(self, session=None) -> bool:
        """ENABLE_BATCH_SCHEDULER in the session's scope (instance scope without
        one)."""
        return bool(self.instance.config.get(
            "ENABLE_BATCH_SCHEDULER", session.vars if session is not None else None))

    def _max_group(self) -> int:
        cfg = self.instance.config.get("BATCH_MAX_GROUP") or BATCH_MAX_KEYS
        return max(1, min(int(cfg), BATCH_MAX_KEYS))

    def point_begin(self):
        """Sessions bracket the whole point path (batched OR sequential) so
        `_window_s` sees true point-query concurrency."""
        self._inflight_tokens.append(None)

    def point_end(self):
        try:
            self._inflight_tokens.pop()
        except IndexError:  # pragma: no cover - bracket imbalance guard
            pass

    @property
    def _inflight(self) -> int:
        return len(self._inflight_tokens)

    def _window_s(self) -> float:
        """Collection window for a group opening NOW (caller holds the lock).

        `BATCH_WINDOW_US` > 0 pins it; otherwise the window opens only when
        >= MIN_INFLIGHT point queries are in flight, sized to collect
        ~TARGET_GROUP keys at the observed arrival rate, clamped to
        [MIN_WINDOW_S, MAX_WINDOW_S]."""
        fixed = self.instance.config.get(self.WINDOW_PARAM)
        if fixed:
            return float(fixed) / 1e6
        if self._inflight < self.MIN_INFLIGHT:
            return 0.0
        return min(max(self.TARGET_GROUP * self._interval_ewma,
                       self.MIN_WINDOW_S), self.MAX_WINDOW_S)

    # -- submit/wait -----------------------------------------------------------

    def submit(self, gkey: Tuple, pp: dict, lane_val,
               pinned_ts: Optional[int], prof=None) -> Optional[BatchRequest]:
        """Join or open the statement's batch group; block until the group
        flushes.  Returns the caller's filled BatchRequest, or None when the
        caller must run the sequential path itself (window closed, singleton
        group, or group-scope fallback)."""
        now = time.perf_counter()
        # arrival-gap EWMA outside the lock: a benign race on a heuristic
        gap = now - self._last_arrival
        self._last_arrival = now
        self._interval_ewma += 0.2 * (min(gap, 0.05) - self._interval_ewma)
        cap = self._max_group()
        with self._lock:
            g = self._groups.get(gkey)
            if g is not None and not g.sealed:
                req = BatchRequest(lane_val, now, prof=prof)
                g.requests.append(req)
                if len(g.requests) >= cap or (
                        g.target is not None and len(g.requests) >= g.target):
                    g.sealed = True
                    g.full.set()
                leader = False
            else:
                window = self._window_s()
                if window <= 0.0:
                    return None
                fixed = bool(self.instance.config.get(self.WINDOW_PARAM))
                target = None if fixed else min(max(self._inflight, 2), cap)
                g = _Group(gkey, pp, pinned_ts, now, target)
                req = BatchRequest(lane_val, now, prof=prof)
                g.requests.append(req)
                self._groups[gkey] = g
                prev_done = self._flush_done.get(gkey)
                leader = True
        if not leader:
            if not req.event.wait(timeout=self.FOLLOWER_TIMEOUT_S):
                with self._lock:
                    if not g.sealed:
                        # leader vanished pre-seal: withdraw (so a woken leader
                        # never serves us twice) and retire the zombie group
                        try:
                            g.requests.remove(req)
                        except ValueError:  # pragma: no cover
                            pass
                        if self._groups.get(gkey) is g:
                            self._groups.pop(gkey)
                        return None
                # sealed: the leader owns this request and its finally-block
                # guarantees scatter + wake
                req.event.wait()
            return None if req.fallback else req
        # -- leader: collect, seal, execute, scatter ---------------------------
        deadline = g.t0 + (window if g.target is None else self.MAX_COLLECT_S)
        if prev_done is not None and g.target is not None:
            prev_done.wait(self.MAX_COLLECT_S)
        joined = 1
        while not g.full.wait(window):
            n_now = len(g.requests)  # racy read; the seal below is exact
            if g.target is None or n_now <= joined or \
                    time.perf_counter() >= deadline:
                break  # pinned window spent, arrivals stalled, or hard cap
            joined = n_now
        flush_t = time.perf_counter()
        done = threading.Event()
        with self._lock:
            g.sealed = True
            if self._groups.get(gkey) is g:
                self._groups.pop(gkey)
            reqs = list(g.requests)
            self._window_open_s += flush_t - g.t0
            if len(reqs) > 1:
                self._flush_done[gkey] = done
        try:
            if len(reqs) == 1:
                self._count("batch_singletons")
                req.fallback = True
            else:
                self._execute(gkey, pp, pinned_ts, reqs)
                self._bulk_finish(pp, reqs, flush_t)
        except Exception as ex:
            # group-scope failure: every member re-executes sequentially and gets
            # its own error attribution there
            for r in reqs:
                r.fallback = True
            self._count("batch_fallbacks", len(reqs))
            self.trace.append(f"batch_fallback group={len(reqs)} "
                              f"{type(ex).__name__}: {ex}")
        finally:
            # unpark the NEXT group's leader before the followers
            done.set()
            with self._lock:
                if self._flush_done.get(gkey) is done:
                    del self._flush_done[gkey]
            for r in reqs:
                if r is not req:
                    r.event.set()
        return None if req.fallback else req

    def _bulk_finish(self, pp: dict, reqs: List[BatchRequest], flush_t: float):
        """Leader-side group finish: counters, group size, waits and each served
        member's trace lines, once per flush, so a woken follower only builds its
        ResultSet."""
        end_t = time.perf_counter()
        exec_us = (end_t - flush_t) * 1e6
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
            r.trace = [f"point-plan {pp['table']}.{pp['key_col']} "
                       f"[batched group={n} wait={r.wait_us:.0f}us "
                       f"exec={exec_us:.0f}us]",
                       f"elapsed={total_us / 1e6:.3f}s workload=TP"]
            served += 1
            if r.prof is not None:
                p = r.prof
                p.workload, p.engine, p.rows = "TP", "batch", len(r.rows or ())
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
        with self._stats_lock:
            self.group_sizes.append(n)
            self.wait_ms.extend(waits)
        if profs:
            self._finish_served(profs, serve_ms, "batch")
        if served:
            self.instance.count("batched_point_queries", served)

    # -- group execution -------------------------------------------------------

    def _execute(self, gkey: Tuple, pp: dict, pinned_ts: Optional[int],
                 reqs: List[BatchRequest]):
        """One vectorized flush: stack unique keys, route to partitions, run one
        lookup per touched partition, gather each output column ONCE across all
        matches, slice rows back per key."""
        inst = self.instance
        if inst.catalog.schema_version != pp["schema_version"]:
            raise RuntimeError("schema changed under the group")  # galaxylint: disable=untyped-raise -- group fallback signal caught by the flush; never crosses the wire
        tm = inst.catalog.table(pp["schema"], pp["table"])
        store = inst.store(pp["schema"], pp["table"])
        if inst.archive.files_for(f"{tm.schema.lower()}.{tm.name.lower()}", None):
            raise RuntimeError("archive-backed table")  # galaxylint: disable=untyped-raise -- group fallback signal (cold rows) caught by the flush; never crosses the wire
        snap = pinned_ts if pinned_ts is not None else inst.tso.next_timestamp()
        key_col = pp["key_col"]
        out_cols = pp["out_cols"]

        uniq: Dict[Any, int] = {}
        for r in reqs:
            uniq.setdefault(r.lane_val, len(uniq))
        uvals = list(uniq)
        results: List[List[tuple]] = [[] for _ in uvals]
        errors: List[Optional[BaseException]] = [None] * len(uvals)

        by_pid = self._route(tm, key_col, uvals, errors, len(store.partitions))
        # the shared MDL around the partition loop, as a sequential point lookup
        # holds it: column DDL cannot swap lanes under the flush
        with inst.mdl.shared({inst.store_key(tm.schema, tm.name)}):
            for pid in sorted(by_pid):
                part = store.partitions[pid]
                if part.num_rows == 0:
                    continue
                sub = by_pid[pid]
                ids, offs = batched_point_lookup(
                    store, pid, part, key_col, tm.version, [uvals[i] for i in sub],
                    snap, 0, device_cache=inst.device_cache)
                if ids.size == 0:
                    continue
                with part.lock:
                    lists = [Column(part.lanes[cname][ids], part.valid[cname][ids],
                                    tm.column(cname).dtype,
                                    tm.dictionaries.get(cname.lower())).to_pylist()
                             for cname in out_cols]
                flat = list(zip(*lists))
                for j, u in enumerate(sub):
                    seg = flat[offs[j]:offs[j + 1]]
                    if seg:
                        results[u].extend(seg)

        poison = FAIL_POINTS.value(FP_BATCH_POISON_KEY)
        if poison is not None:
            for u, v in enumerate(uvals):
                if v == poison:
                    errors[u] = FailPointError(
                        f"failpoint {FP_BATCH_POISON_KEY} fired (key {v!r})")

        handed = [False] * len(uvals)
        for r in reqs:
            u = uniq[r.lane_val]
            if errors[u] is not None:
                r.error = errors[u]
            else:
                # each session's ResultSet takes ownership of its rows list;
                # duplicate-key members get their own copy
                r.rows = list(results[u]) if handed[u] else results[u]
                handed[u] = True

    def _route(self, tm, key_col: str, uvals, errors,
               nparts: int) -> Dict[int, List[int]]:
        """pid -> [unique-key index] routing, mirroring the sequential path's
        `PartitionRouter.prune_eq(key_col, int(lane_val))` (vectorized for the
        single-column hash/key case).  A per-key routing error is isolated to
        that key's sessions."""
        router = PartitionRouter(tm)
        info = tm.partition
        by_pid: Dict[int, List[int]] = {}
        if info.method in ("single", "broadcast"):
            by_pid[0] = list(range(len(uvals)))
            return by_pid
        if info.method in ("hash", "key") and len(info.columns) == 1 and \
                info.columns[0].lower() == key_col.lower():
            # int() matches prune_eq's route_literal([int(v)]) lane truncation
            arr = np.asarray([int(v) for v in uvals], dtype=np.int64)
            for u, pid in enumerate(router.route_rows([arr])):
                by_pid.setdefault(int(pid), []).append(u)
            return by_pid
        for u, v in enumerate(uvals):
            try:
                pids = router.prune_eq(key_col, int(v))
            except Exception as e:
                errors[u] = e
                continue
            if pids is None:
                pids = range(nparts)
            for pid in pids:
                by_pid.setdefault(int(pid), []).append(u)
        return by_pid

    # -- observability ------------------------------------------------------------

    def stats_rows(self) -> List[Tuple[str, float]]:
        """(stat_name, value) rows: the counters, group-size and wait quantiles of
        recent flushes, hit ratio over all point-plan executions, window
        occupancy and live window state."""
        with self._stats_lock:
            counts = dict(self.counts)
            sizes = np.asarray(self.group_sizes, dtype=np.float64)
            waits = np.asarray(self.wait_ms, dtype=np.float64)

        def q(a, p):
            return float(np.quantile(a, p)) if a.size else 0.0

        batched = counts["batched_queries"]
        sequential = self.instance.counters.get("point_plan_queries", 0)
        uptime = max(time.perf_counter() - self._born, 1e-9)
        with self._lock:
            open_groups = len(self._groups)
            window_us = self._window_s() * 1e6
        return [
            *((k, float(v)) for k, v in counts.items()),
            ("group_size_mean", round(float(sizes.mean()), 3) if sizes.size else 0.0),
            ("group_size_p50", q(sizes, 0.5)),
            ("group_size_p95", q(sizes, 0.95)),
            ("group_size_p99", q(sizes, 0.99)),
            ("wait_ms_p50", q(waits, 0.5)),
            ("wait_ms_p95", q(waits, 0.95)),
            ("hit_ratio", round(batched / max(batched + sequential, 1), 4)),
            ("window_occupancy", round(min(self._window_open_s / uptime, 1.0), 4)),
            ("window_us", round(window_us, 1)),
            ("open_groups", float(open_groups)),
            ("point_inflight", float(self._inflight)),
        ]
