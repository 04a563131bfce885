"""Columnar HTAP replica: a CDC-fed delta+base tier serving AP scans (port of
`galaxysql_tpu/storage/columnar.py`).

The replica's state is host numpy, as in the reference, and the protocol is the
reference's line for line.  What differs is the scan: `scan_view` yields batches of
torch tensors on the execution device.  A stripe is immutable, so its lanes stay on
the device between queries in the instance's device cache, keyed by the stripe's uid
(`ColumnarReplicaManager.cache_uid`); the visibility mask of a stripe with deletes,
and the delta, go over per query.  The tailer's failures, which the reference
publishes as `columnar_tail_failed` events, are published too and also kept in
`ColumnarReplicaManager.tail_errors`.


Reference analog: PolarDB-X's columnar index / IMCI-style HTAP replica
(PAPER.md §HTAP) — a continuously-maintained column store fed from the global
binlog, snapshot-consistent at a TSO watermark, serving analytical scans while
TP stays on the row store.  The pieces here:

- **Tailer** (`ColumnarReplicaManager.tail_once` + a lazy poll thread, the
  `txn/async_apply.py` shape): drains `txn/cdc.py`'s commit-TSO-ordered
  stream per enrolled table.  Inserts land in an in-memory columnar *delta*
  (per-event chunks in lane domain); deletes stamp `end_ts` through a PK
  multiset map — the replica mirrors the row store's MVCC lanes exactly, so
  a read at watermark W is *bit-identical* to a row-store read at W.
- **Base stripes**: compaction folds the delta into immutable, pre-padded
  stripes with per-column zone maps (`storage/zonemap.py`, shared with the
  TTL parquet archive) used for SARG stripe pruning.  Stripe lanes keep the
  live table's dictionary codes, so decoded batches drop straight into the
  fused pipeline next to row-store batches.
- **Watermark protocol**: seeding scans the row store at a *lagged*
  `ts0 = now − margin` (commits at or below ts0 have their lane stamps
  landed) and starts the tail cursor at the last binlog event with
  `commit_ts <= ts0` — commits inside the margin window are invisible at
  ts0, so their events replay; events with `commit_ts <= ts0` are skipped
  (covered by the seed).  The watermark only ever advances to
  `t_head − margin` after a drain that reached the binlog head, where
  `t_head` was fetched before the drain — the same "binlog writes trail row
  visibility by less than the margin" assumption the rebalance verifier
  (`REBALANCE_VERIFY_LAG_MS`) already relies on.  Never to the last applied
  commit_ts: a concurrent commit with a smaller TSO may not have reached
  the binlog yet.

Concurrency: one manager lock (lockdep class "columnar", rank 0) serializes
tailer operations — seed, apply, compact, persist.  The QUERY path takes no
lock at all: routing snapshots `replica.tier` (an immutable (stripes, delta)
tuple replaced wholesale by writers) plus the watermark into a `ReplicaView`,
so a compaction mid-query can never mix tiers.  Compaction only drops dead
rows below the MINIMUM watermark across replicas — a multi-table query routes
at `min(W_v)`, so no future view can need them.

Escape hatches (the standard trio): `COLUMNAR(OFF|ON)` statement hint,
`ENABLE_COLUMNAR_REPLICA` param (default off), `GALAXYSQL_COLUMNAR=0` env.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.meta.tso import LOGICAL_BITS
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.storage.zonemap import lane_minmax, sargs_refuted
from galaxysql_tpu_torch.utils import errors, events

# environment escape hatch (trio leg 3): kills routing AND tailing wholesale
ENABLED = os.environ.get("GALAXYSQL_COLUMNAR", "1") != "0"

SEEDING = "SEEDING"
READY = "READY"
RESEED = "RESEED"


# -- RLE (persistence encoding) ---------------------------------------------

def rle_encode(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(run values, run lengths).  begin_ts/end_ts lanes are near-constant
    per stripe (one commit stamps many rows), so runs collapse them to a
    handful of entries on disk."""
    if arr.size == 0:
        return arr, np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.nonzero(np.diff(arr))[0] + 1])
    lengths = np.diff(np.concatenate([starts, [arr.size]]))
    return arr[starts], lengths.astype(np.int64)


def rle_decode(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.repeat(values, lengths)


def _save_lane(arrays: Dict[str, np.ndarray], name: str, arr: np.ndarray):
    """Store `arr` under `name`, RLE-encoded when the runs actually pay."""
    vals, lens = rle_encode(arr)
    if vals.size * 2 < arr.size:
        arrays[f"rv::{name}"] = vals
        arrays[f"rn::{name}"] = lens
    else:
        arrays[name] = arr


def _load_lane(z, name: str) -> Optional[np.ndarray]:
    if name in z:
        return z[name]
    if f"rv::{name}" in z:
        return rle_decode(z[f"rv::{name}"], z[f"rn::{name}"])
    return None


# -- tiers -------------------------------------------------------------------

class Stripe:
    """Immutable columnar slab, pre-padded to a power-of-two bucket so every
    query reuses one compiled kernel shape (and one device-cache entry —
    stripe lanes never change, which is the whole point vs. re-concatenating
    the row store per version bump).  `end_ts` is the one mutable side array:
    delete events stamp it; `has_deletes` retires the static fast path."""

    __slots__ = ("uid", "lanes", "valid", "begin_ts", "end_ts", "num_rows",
                 "cap", "zmap", "max_begin", "has_deletes", "_pad_live")

    def __init__(self, uid: int, lanes, valid, begin_ts, end_ts,
                 num_rows: int, cap: int, zmap):
        self.uid = uid
        self.lanes = lanes          # col -> np lane, length cap
        self.valid = valid          # col -> np bool lane or None (all valid)
        self.begin_ts = begin_ts    # length cap; padding rows are dead
        self.end_ts = end_ts        # length cap; padding gets end_ts=0
        self.num_rows = num_rows
        self.cap = cap
        self.zmap = zmap            # col -> (lo, hi), numeric lanes only
        self.max_begin = int(begin_ts[:num_rows].max()) if num_rows else 0
        self.has_deletes = bool(
            (end_ts[:num_rows] != INFINITY_TS).any()) if num_rows else False
        self._pad_live = None if cap == num_rows else \
            (np.arange(cap) < num_rows)

    def live_mask(self, w: int):
        """MVCC visibility at watermark `w` — the numpy twin of
        native.visible_mask for rows that are never provisional (the tailer
        only ever applies committed stamps)."""
        if not self.has_deletes and self.max_begin <= w:
            return self._pad_live  # None = all rows live
        m = (self.begin_ts <= w) & (self.end_ts > w)
        return m


class _DeltaChunk:
    """One insert event's rows, unpadded: the scan path concatenates all
    chunks into a single padded batch, so sustained small-row DML costs one
    extra batch per query, not one per event."""

    __slots__ = ("lanes", "valid", "begin_ts", "end_ts")

    def __init__(self, lanes, valid, begin_ts, end_ts):
        self.lanes = lanes
        self.valid = valid
        self.begin_ts = begin_ts
        self.end_ts = end_ts


class ReplicaView:
    """Lock-free query-time snapshot: (stripes, delta) tuple + watermark
    captured once at routing.  Consistent by construction — writers replace
    `replica.tier` wholesale, never mutate it."""

    __slots__ = ("replica", "stripes", "delta", "watermark", "seed_ts",
                 "events", "max_applied_ts")

    def __init__(self, replica, stripes, delta, watermark, seed_ts,
                 events, max_applied_ts):
        self.replica = replica
        self.stripes = stripes
        self.delta = delta
        self.watermark = watermark
        self.seed_ts = seed_ts
        # content generation for the fragment cache: (seed_ts, events)
        # changes exactly when the visible set can change, and
        # max_applied_ts bounds the commit range the tier carries — any
        # watermark at or above it sees the identical visible set, so
        # cached artifacts stay valid across idle watermark advances
        self.events = events
        self.max_applied_ts = max_applied_ts


class TableReplica:
    """Per-table replica state.  All mutation happens under the manager lock;
    `tier`, `watermark`, `state` are read lock-free by the router."""

    def __init__(self, key: str):
        self.key = key
        self.state = SEEDING
        self.sig: Tuple[str, ...] = ()
        self.tier: Tuple[tuple, tuple] = ((), ())   # (stripes, delta chunks)
        self.delta_rows = 0
        self.watermark = 0       # replica is exact for any ts in
        self.seed_ts = 0         # [seed_ts, watermark]
        self.seq = 0             # last binlog seq consumed
        self.pk = None           # lazy: match-key -> [[obj, row], ...]
        self.max_applied_ts = 0  # highest commit_ts stamped into the tier
        self.snap = None         # published consistent view tuple (below)
        self.compactions = 0
        self.reseeds = 0
        self.pruned_stripes = 0
        self.applied_events = 0
        self.applied_rows = 0

    def lag_ms(self) -> float:
        if self.watermark <= 0:
            return -1.0
        return max(time.time() * 1000.0 - (self.watermark >> LOGICAL_BITS),
                   0.0)

    def publish(self):
        """Tailer-side: expose the current tier/watermark/generation as ONE
        tuple swap.  Queries snapshot it with a single attribute read, so a
        view can never pair a drained watermark with a pre-drain tier (or a
        stale generation with a fresh tier).  In-place end_ts stamps applied
        after a publish are benign: their commit_ts exceeds every already-
        published watermark (the margin invariant), so they are invisible at
        any watermark a live view can carry."""
        stripes, delta = self.tier
        self.snap = (stripes, delta, self.watermark, self.seed_ts,
                     self.applied_events, self.max_applied_ts)

    def view(self) -> Optional[ReplicaView]:
        snap = self.snap  # one read: atomic vs. the tailer's publish()
        if self.state != READY or snap is None:
            return None
        return ReplicaView(self, *snap)


# -- scan --------------------------------------------------------------------

def scan_view(view: ReplicaView, tm, columns: List[str], sargs=None,
              manager=None, device_cache=None):
    """Yield padded ColumnBatches for `columns` at the view's watermark on
    `device_cache`'s device, zone-map-pruning stripes the SARGs refute.
    Lock-free: operates purely on the snapshot.  Stripe lanes (immutable) come
    from the device cache under the stripe's uid; the live mask of a stripe
    with deletes or rows above the watermark, and the delta, are shipped."""
    from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch, as_tensor
    from galaxysql_tpu_torch.exec.operators import bucket_capacity
    w = view.watermark
    sargs = sargs or []
    dev = device_cache.device
    ns = _CacheSpace(manager.cache_uid if manager is not None
                     else ("columnar", id(view.replica)))
    for s in view.stripes:
        if sargs and sargs_refuted(s.zmap, sargs):
            view.replica.pruned_stripes += 1
            if manager is not None:
                manager.pruned.inc()
            continue
        cols = {}
        for c in columns:
            cm = tm.column(c)
            data = device_cache.get_lane_built(ns, s.uid, c, 0, s.cap,
                                               lambda s=s, c=c: s.lanes[c])
            valid = None
            if s.valid[c] is not None:
                valid = device_cache.get_lane_built(ns, s.uid, f"valid::{c}", 0,
                                                    s.cap,
                                                    lambda s=s, c=c: s.valid[c])
            cols[c] = Column(data, valid, cm.dtype, tm.dictionaries.get(c.lower()))
        live = s.live_mask(w)
        if live is s._pad_live and live is not None:
            live = device_cache.get_lane_built(ns, s.uid, "::padlive", 0, s.cap,
                                               lambda s=s: s._pad_live)
        elif live is not None:
            live = as_tensor(live, dev)
        yield ColumnBatch(cols, live)
    if not view.delta:
        return
    chunks = view.delta
    n = sum(ch.begin_ts.shape[0] for ch in chunks)
    if n == 0:
        return
    cap = bucket_capacity(n)
    begin = np.concatenate([ch.begin_ts for ch in chunks])
    end = np.concatenate([ch.end_ts for ch in chunks])
    live = (begin <= w) & (end > w)
    if cap != n:
        live = np.concatenate([live, np.zeros(cap - n, dtype=np.bool_)])
    cols = {}
    for c in columns:
        cm = tm.column(c)
        lane = np.concatenate([ch.lanes[c] for ch in chunks])
        if cap != n:
            lane = np.concatenate(
                [lane, np.zeros(cap - n, dtype=lane.dtype)])
        valid = None
        if any(ch.valid.get(c) is not None for ch in chunks):
            valid = np.concatenate(
                [ch.valid[c] if ch.valid.get(c) is not None else
                 np.ones(ch.begin_ts.shape[0], dtype=np.bool_)
                 for ch in chunks])
            if cap != n:
                valid = np.concatenate(
                    [valid, np.zeros(cap - n, dtype=np.bool_)])
        cols[c] = Column(as_tensor(lane, dev),
                         None if valid is None else as_tensor(valid, dev),
                         cm.dtype, tm.dictionaries.get(c.lower()))
    yield ColumnBatch(cols, as_tensor(live, dev))


class _CacheSpace:
    """The device cache's store slot for stripe lanes: a replica manager's own key
    space (stripe uids count from 0, as store uids do)."""

    __slots__ = ("uid",)

    def __init__(self, uid):
        self.uid = uid


# -- the manager -------------------------------------------------------------

class ColumnarReplicaManager:
    """Owns every table replica plus the tailer thread (`instance.columnar`).

    Lock discipline: `self._lock` (lockdep class "columnar") is TAILER-ONLY —
    held across seed/apply/compact/persist, and ordered BEFORE partition and
    metadb locks (seeding scans partitions, draining queries the binlog).
    Nothing acquires it under those, and the query path never takes it."""

    IDLE_WAIT_S = 0.5

    def __init__(self, instance):
        self.instance = instance
        self.replicas: Dict[str, TableReplica] = {}
        from galaxysql_tpu_torch.utils.lockdep import named_lock
        self._lock = named_lock("columnar")
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._next_uid = 0
        # device-cache key space of this manager's stripe lanes (`scan_view`)
        self.cache_uid = ("columnar", id(self))
        self.tail_errors: List[str] = []
        m = instance.metrics
        self.events_applied = m.counter(
            "columnar_events_applied", "binlog events applied to replicas")
        self.rows_applied = m.counter(
            "columnar_rows_applied", "rows applied to columnar replicas")
        self.compactions = m.counter(
            "columnar_compactions", "delta->base stripe compactions")
        self.pruned = m.counter(
            "columnar_pruned_stripes", "stripes skipped by zone-map SARGs")
        self.routed = m.counter(
            "columnar_routed_queries", "queries served by the columnar replica")
        self.reseed_count = m.counter(
            "columnar_reseeds", "replica reseeds (DDL mid-tail / delete miss)")
        self.lag_gauge = m.gauge(
            "columnar_lag_ms", "max replica watermark lag (ms)")
        self.delta_gauge = m.gauge(
            "columnar_delta_rows", "total uncompacted delta rows")

    # -- enrollment -----------------------------------------------------------

    def enabled(self, session=None) -> bool:
        if not ENABLED:
            return False
        v = self.instance.config.get(
            "ENABLE_COLUMNAR_REPLICA", session.vars if session else None)
        return bool(v)

    def replica(self, schema: str, table: str) -> Optional[TableReplica]:
        return self.replicas.get(self.instance.store_key(schema, table))

    def request(self, schema: str, table: str) -> TableReplica:
        """Async enroll: register the table (SEEDING) and wake the tailer.
        Routing keeps using the row store until the replica turns READY."""
        key = self.instance.store_key(schema, table)
        with self._lock:
            rep = self.replicas.get(key)
            if rep is None:
                rep = TableReplica(key)
                self.replicas[key] = rep
        self._start_thread()
        with self._cond:
            self._cond.notify_all()
        return rep

    def ensure_ready(self, schema: str, table: str,
                     timeout_s: float = 30.0) -> TableReplica:
        """Synchronous enroll + seed + drain (COLUMNAR(ON) hint, tests)."""
        rep = self.request(schema, table)
        deadline = time.time() + timeout_s
        while rep.state != READY:
            self.tail_once()
            if rep.state != READY and time.time() > deadline:
                raise errors.TddlError(
                    f"columnar replica {rep.key} did not become READY "
                    f"within {timeout_s}s (state={rep.state})")
        return rep

    def drop(self, schema: str, table: str):
        with self._lock:
            self.replicas.pop(self.instance.store_key(schema, table), None)

    # -- tailer ---------------------------------------------------------------

    def _start_thread(self):
        poll_ms = self.instance.config.get("COLUMNAR_POLL_MS")
        if poll_ms is None or float(poll_ms) <= 0:
            return  # synchronous mode (tests drive tail_once directly)
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="columnar-tailer", daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop:
            poll = float(self.instance.config.get("COLUMNAR_POLL_MS") or 50)
            with self._cond:
                self._cond.wait(min(poll / 1000.0, self.IDLE_WAIT_S))
            if self._stop:
                return
            try:
                self.tail_once()
            except Exception as e:
                # background plane: a tail fault is published as an error event
                # (and kept in `tail_errors`) and retried next poll; dying
                # silently would freeze the watermark
                self.tail_errors = (self.tail_errors + [
                    f"columnar tailer cycle failed: {type(e).__name__}: {e}"])[-16:]
                events.publish(  # galaxylint: disable=event-uncorrelated -- background tailer cycle: no query trace or statement digest exists
                    "columnar_tail_failed",
                    f"columnar tailer cycle failed: {e}",
                    severity="error", node=self.instance.node_id,
                    error=f"{type(e).__name__}")
                time.sleep(self.IDLE_WAIT_S)

    def shutdown(self):
        self._stop = True
        with self._cond:
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def margin(self) -> int:
        lag_ms = int(self.instance.config.get("COLUMNAR_WATERMARK_LAG_MS")
                     or 100)
        return lag_ms << LOGICAL_BITS

    def tail_once(self) -> int:
        """One synchronous tail cycle: seed/reseed pending replicas, drain
        the binlog into READY ones, advance watermarks, compact.  Returns the
        number of events applied."""
        if not ENABLED:
            return 0
        applied = 0
        with self._lock:
            for key, rep in list(self.replicas.items()):
                if rep.state in (SEEDING, RESEED):
                    self._seed(rep)
            for rep in self.replicas.values():
                if rep.state == READY:
                    applied += self._drain(rep)
            for rep in self.replicas.values():
                if rep.state == READY:
                    self._maybe_compact(rep)
            self._update_gauges()
        return applied

    def _meta(self, rep: TableReplica):
        schema, table = rep.key.split(".", 1)
        try:
            tm = self.instance.catalog.table(schema, table)
        except Exception:
            tm = None
        store = self.instance.stores.get(rep.key)
        return tm, store

    def _seed(self, rep: TableReplica):
        """Snapshot the row store into base stripes.  Protocol: scan at a
        *lagged* ts0 = now − margin (every commit at or below ts0 has its
        lane stamps landed — the margin absorbs stamps trailing their TSO
        fetch), and start the tail cursor at the LAST binlog event with
        commit_ts <= ts0, not the head: commits inside the margin window are
        invisible at ts0, so their events must replay.  The binlog is
        commit-TSO-ordered (one write lock, stamp-then-publish), so every
        event past the cursor has commit_ts > ts0; the `cts <= seed_ts`
        drain skip then covers events published late for seeded commits."""
        inst = self.instance
        tm, store = self._meta(rep)
        if tm is None or store is None:
            self.replicas.pop(rep.key, None)  # table dropped mid-enrollment
            return
        ts0 = max(inst.tso.next_timestamp() - self.margin(), 1)
        row = inst.metadb.query(
            "SELECT COALESCE(MAX(seq), 0) FROM binlog_events "
            "WHERE commit_ts <= ?", (ts0,))
        s0 = int(row[0][0]) if row else 0
        cols = tm.column_names()
        parts_data = []
        for p in store.partitions:
            if p.num_rows == 0:
                continue
            with p.lock:
                ids = np.nonzero(p.visible_mask(ts0))[0]
                if ids.size == 0:
                    continue
                lanes = {c: p.lanes[c][ids] for c in cols}
                valid = {c: p.valid[c][ids].copy() for c in cols}
                begin = p.begin_ts[ids].copy()
            parts_data.append((lanes, valid, begin))
        ckey = self._cluster_key(rep, tm)
        if ckey is None:
            stripes = [self._make_stripe(
                tm, lanes, valid, begin,
                np.full(begin.shape[0], INFINITY_TS, dtype=np.int64))
                for lanes, valid, begin in parts_data]
        else:
            stripes = self._clustered_stripes(tm, cols, ckey, parts_data)
        if rep.state == RESEED:
            rep.reseeds += 1
            self.reseed_count.inc()
        rep.sig = tuple(cols)
        rep.tier = (tuple(stripes), ())
        rep.delta_rows = 0
        rep.pk = None
        rep.seq = s0
        rep.seed_ts = ts0
        rep.watermark = ts0
        rep.max_applied_ts = ts0
        rep.state = READY
        rep.publish()

    def _cluster_key(self, rep: TableReplica, tm) -> Optional[str]:
        """Resolve COLUMNAR_CLUSTER_BY ('table:column,...') for this
        replica's table; None when unconfigured or the column is unknown."""
        spec = str(self.instance.config.get("COLUMNAR_CLUSTER_BY") or "")
        if not spec:
            return None
        table = rep.key.split(".", 1)[1]
        for part in spec.split(","):
            if ":" not in part:
                continue
            t, c = part.split(":", 1)
            if t.strip().lower().split(".")[-1] != table:
                continue
            c = c.strip().lower()
            for cn in tm.column_names():
                if cn.lower() == c:
                    return cn
        return None

    def _clustered_stripes(self, tm, cols, ckey, parts_data) -> list:
        """Globally sort the seed snapshot on the cluster column and slice it
        into compaction-threshold stripes: consecutive stripes then cover
        disjoint key ranges, so the per-stripe zone maps turn range SARGs
        into whole-stripe prunes instead of per-row filter work.  Delta
        compactions keep arrival order — clustering is a seed-time layout."""
        if not parts_data:
            return []
        lanes = {c: np.concatenate([pl[c] for pl, _, _ in parts_data])
                 for c in cols}
        valid = {c: np.concatenate([pv[c] for _, pv, _ in parts_data])
                 for c in cols}
        begin = np.concatenate([b for _, _, b in parts_data])
        order = np.argsort(lanes[ckey], kind="stable")
        lanes = {c: a[order] for c, a in lanes.items()}
        valid = {c: a[order] for c, a in valid.items()}
        begin = begin[order]
        threshold = int(self.instance.config.get("COLUMNAR_COMPACT_ROWS")
                        or 65536)
        stripes = []
        for lo in range(0, int(begin.shape[0]), threshold):
            hi = min(lo + threshold, int(begin.shape[0]))
            stripes.append(self._make_stripe(
                tm, {c: a[lo:hi] for c, a in lanes.items()},
                {c: a[lo:hi] for c, a in valid.items()}, begin[lo:hi],
                np.full(hi - lo, INFINITY_TS, dtype=np.int64)))
        return stripes

    def _make_stripe(self, tm, lanes, valid, begin, end) -> Stripe:
        from galaxysql_tpu_torch.exec.operators import bucket_capacity
        n = int(begin.shape[0])
        cap = bucket_capacity(max(n, 1))

        def pad(arr, fill=0):
            if arr.shape[0] == cap:
                return arr
            return np.concatenate(
                [arr, np.full(cap - arr.shape[0], fill, dtype=arr.dtype)])

        zmap = {}
        out_lanes, out_valid = {}, {}
        for c, lane in lanes.items():
            v = valid.get(c)
            all_valid = v is None or bool(v.all())
            if not tm.column(c).dtype.is_string:
                # dictionary codes carry no order: a code-lane zone map would
                # wrongly refute range sargs, so string lanes get no stats
                mm = lane_minmax(lane[:n], None if all_valid else v[:n])
                if mm is not None:
                    zmap[c] = mm
            out_lanes[c] = pad(lane)
            out_valid[c] = None if all_valid else pad(v, False)
        uid = self._next_uid
        self._next_uid += 1
        # padding rows: end_ts=0 keeps them dead at every watermark
        return Stripe(uid, out_lanes, out_valid, pad(begin),
                      pad(end, 0), n, cap, zmap)

    def _drain(self, rep: TableReplica) -> int:
        """Page this replica's events from the binlog; advance the watermark
        only when the drain reached the head (see module docstring)."""
        inst = self.instance
        tm, store = self._meta(rep)
        if tm is None or store is None:
            self.replicas.pop(rep.key, None)
            return 0
        if tuple(tm.column_names()) != rep.sig:
            rep.state = RESEED  # DDL landed: delta lanes no longer line up
            rep.snap = None
            return 0
        t_head = inst.tso.next_timestamp()
        applied = 0
        reached_head = False
        while True:
            evs = inst.cdc.events_after_seq(rep.seq, limit=5000)
            for seq, cts, schema, table, kind, payload in evs:
                rep.seq = seq
                if f"{schema}.{table}" != rep.key:
                    continue
                if cts <= rep.seed_ts:
                    continue  # covered by the seed snapshot
                d = json.loads(payload)
                if tuple(d["columns"]) != rep.sig:
                    # DDL mid-tail: this event predates/postdates our lane
                    # layout.  Reseed — the fresh seed's ts0 exceeds every
                    # stale commit_ts, so skipping the rest stays sound.
                    rep.state = RESEED
                    rep.snap = None
                    return applied
                if kind == "insert":
                    self._apply_insert(rep, tm, d, cts)
                elif kind == "delete":
                    if not self._apply_delete(rep, tm, d, cts):
                        rep.state = RESEED  # unmatched image: self-heal
                        rep.snap = None
                        return applied
                else:
                    raise errors.TddlError(
                        f"unknown binlog event kind {kind!r}")
                applied += 1
                rep.applied_events += 1
                rep.max_applied_ts = max(rep.max_applied_ts, cts)
                rep.applied_rows += len(d["rows"])
                self.events_applied.inc()
                self.rows_applied.inc(len(d["rows"]))
            if len(evs) < 5000:
                reached_head = True
                break
        if reached_head:
            rep.watermark = max(rep.watermark, t_head - self.margin())
        if applied or reached_head:
            rep.publish()
        return applied

    def _apply_insert(self, rep: TableReplica, tm, d: dict, cts: int):
        from galaxysql_tpu_torch.chunk.batch import column_from_pylist
        cols = d["columns"]
        rows = d["rows"]
        n = len(rows)
        if n == 0:
            return
        lanes, valid = {}, {}
        for i, c in enumerate(cols):
            cm = tm.column(c)
            col = column_from_pylist([r[i] for r in rows], cm.dtype,
                                     tm.dictionaries.get(c.lower()))
            lanes[c] = col.np_data()
            valid[c] = None if col.valid is None else col.np_valid()
        chunk = _DeltaChunk(lanes, valid,
                            np.full(n, cts, dtype=np.int64),
                            np.full(n, INFINITY_TS, dtype=np.int64))
        stripes, delta = rep.tier
        rep.tier = (stripes, delta + (chunk,))
        rep.delta_rows += n
        if rep.pk is not None:
            match_cols = tm.primary_key or cols
            ix = {c: i for i, c in enumerate(cols)}
            for ri, r in enumerate(rows):
                key = tuple(str(r[ix[c]]) for c in match_cols)
                rep.pk.setdefault(key, []).append([chunk, ri])

    def _apply_delete(self, rep: TableReplica, tm, d: dict,
                      cts: int) -> bool:
        """Stamp end_ts on the rows matching the event's images — a multiset
        pop (one live ref per event row), which mirrors the row store: the
        event rows ARE the rows the row store deleted, and identical images
        are indistinguishable.  False = an image had no live match (the
        replica diverged; caller reseeds)."""
        if rep.pk is None:
            rep.pk = self._build_pk(rep, tm)
        cols = d["columns"]
        match_cols = tm.primary_key or cols
        ix = {c: i for i, c in enumerate(cols)}
        for r in d["rows"]:
            key = tuple(str(r[ix[c]]) for c in match_cols)
            refs = rep.pk.get(key)
            hit = None
            while refs:
                obj, row = refs[0]
                if obj.end_ts[row] == INFINITY_TS:
                    hit = (obj, row)
                    break
                refs.pop(0)  # already dead: retire the stale ref
            if hit is None:
                return False
            obj, row = hit
            refs.pop(0)
            if not refs:
                rep.pk.pop(key, None)
            obj.end_ts[row] = cts
            if isinstance(obj, Stripe):
                obj.has_deletes = True
        return True

    def _build_pk(self, rep: TableReplica, tm) -> Dict[tuple, list]:
        """Match-key map over every LIVE row in the current tier.  Built
        lazily on the first delete — insert-only tables (the AP common case)
        never pay the python-domain decode."""
        from galaxysql_tpu_torch.chunk.batch import Column
        from galaxysql_tpu_torch.types import datatype as dt
        match_cols = tm.primary_key or list(tm.column_names())
        nonint = (dt.TypeClass.DECIMAL, dt.TypeClass.DATE,
                  dt.TypeClass.DATETIME, dt.TypeClass.FLOAT,
                  dt.TypeClass.BOOL)
        pk: Dict[tuple, list] = {}
        stripes, delta = rep.tier
        for obj in list(stripes) + list(delta):
            n = obj.num_rows if isinstance(obj, Stripe) else \
                obj.begin_ts.shape[0]
            if n == 0:
                continue
            keys = []
            for c in match_cols:
                cm = tm.column(c)
                lane = obj.lanes[c][:n]
                v = obj.valid.get(c)
                if v is None and not cm.dtype.is_string and \
                        cm.dtype.clazz not in nonint and \
                        lane.dtype.kind in "iu":
                    # integer pk lane, no NULLs: astype('U') renders the
                    # same decimal strings str(int(x)) would, without the
                    # per-element to_pylist loop (the common-case pk map
                    # over a million-row table must not stall the tailer)
                    keys.append(lane.astype("U21").tolist())
                    continue
                col = Column(lane, None if v is None else v[:n], cm.dtype,
                             tm.dictionaries.get(c.lower()))
                keys.append([str(x) for x in col.to_pylist()])
            end = obj.end_ts
            live = np.nonzero(end[:n] == INFINITY_TS)[0]
            tups = list(zip(*keys))
            for i in live.tolist():
                pk.setdefault(tups[i], []).append([obj, i])
        return pk

    def _min_watermark(self) -> int:
        ws = [r.watermark for r in self.replicas.values()
              if r.state == READY and r.watermark > 0]
        return min(ws) if ws else 0

    def _maybe_compact(self, rep: TableReplica):
        """Fold the delta into a new base stripe once it crosses the
        threshold.  Dead rows are dropped only below the MINIMUM watermark
        across replicas: multi-table queries route at min(W_v), and views
        hold tier snapshots, so no reader can need a dropped row."""
        threshold = int(self.instance.config.get("COLUMNAR_COMPACT_ROWS")
                        or 65536)
        if rep.delta_rows < threshold:
            return
        tm, _store = self._meta(rep)
        if tm is None:
            return
        stripes, delta = rep.tier
        if not delta:
            return
        horizon = self._min_watermark()
        begin = np.concatenate([ch.begin_ts for ch in delta])
        end = np.concatenate([ch.end_ts for ch in delta])
        keep = end > horizon
        lanes, valid = {}, {}
        for c in rep.sig:
            lane = np.concatenate([ch.lanes[c] for ch in delta])[keep]
            lanes[c] = lane
            if any(ch.valid.get(c) is not None for ch in delta):
                valid[c] = np.concatenate(
                    [ch.valid[c] if ch.valid.get(c) is not None else
                     np.ones(ch.begin_ts.shape[0], dtype=np.bool_)
                     for ch in delta])[keep]
            else:
                valid[c] = None
        stripe = self._make_stripe(tm, lanes, valid, begin[keep], end[keep])
        rep.tier = (stripes + (stripe,), ())
        rep.delta_rows = 0
        rep.pk = None  # refs point at retired chunks; rebuilt lazily
        rep.compactions += 1
        self.compactions.inc()
        # compaction preserves the visible set above the horizon, so the
        # generation (applied_events) deliberately does NOT move: cached
        # scan artifacts stay valid across the tier swap
        rep.publish()

    def _update_gauges(self):
        lag = 0.0
        delta = 0
        for rep in self.replicas.values():
            if rep.state == READY:
                lag = max(lag, rep.lag_ms())
                delta += rep.delta_rows
        self.lag_gauge.set(round(lag, 3))
        self.delta_gauge.set(float(delta))

    # -- surfaces -------------------------------------------------------------

    def rows(self) -> List[tuple]:
        """SHOW COLUMNAR REPLICA / information_schema.columnar_replica rows:
        (table, state, watermark, lag_ms, delta_rows, base_stripes,
        compactions, reseeds, pruned_stripes, applied_events, applied_rows)."""
        out = []
        for key in sorted(self.replicas):
            rep = self.replicas[key]
            stripes, _delta = rep.tier
            out.append((key, rep.state, rep.watermark,
                        round(rep.lag_ms(), 3), rep.delta_rows,
                        len(stripes), rep.compactions, rep.reseeds,
                        rep.pruned_stripes, rep.applied_events,
                        rep.applied_rows))
        return out

    # -- persistence ----------------------------------------------------------

    def save(self):
        """Checkpoint READY replicas: stripes + delta as npz (RLE-encoded
        lanes where runs pay) under data_dir/columnar, watermark/seq/sig in
        the metadb kv — a restarted tailer resumes from the persisted seq."""
        data_dir = self.instance.data_dir
        if not data_dir:
            return
        with self._lock:
            for key, rep in self.replicas.items():
                if rep.state != READY:
                    continue
                d = os.path.join(data_dir, "columnar",
                                 key.replace(".", os.sep))
                os.makedirs(d, exist_ok=True)
                for f in os.listdir(d):
                    if f.endswith(".npz"):
                        os.remove(os.path.join(d, f))
                stripes, delta = rep.tier
                for i, s in enumerate(stripes):
                    arrays: Dict[str, np.ndarray] = {}
                    n = s.num_rows
                    for c, lane in s.lanes.items():
                        _save_lane(arrays, f"lane__{c}", lane[:n])
                        if s.valid[c] is not None:
                            arrays[f"valid__{c}"] = s.valid[c][:n]
                    _save_lane(arrays, "begin_ts", s.begin_ts[:n])
                    _save_lane(arrays, "end_ts", s.end_ts[:n])
                    np.savez(os.path.join(d, f"stripe{i}.npz"), **arrays)
                if delta:
                    arrays = {}
                    begin = np.concatenate([ch.begin_ts for ch in delta])
                    n = begin.shape[0]
                    _save_lane(arrays, "begin_ts", begin)
                    _save_lane(arrays, "end_ts",
                               np.concatenate([ch.end_ts for ch in delta]))
                    for c in rep.sig:
                        _save_lane(arrays, f"lane__{c}", np.concatenate(
                            [ch.lanes[c] for ch in delta]))
                        if any(ch.valid.get(c) is not None for ch in delta):
                            arrays[f"valid__{c}"] = np.concatenate(
                                [ch.valid[c] if ch.valid.get(c) is not None
                                 else np.ones(ch.begin_ts.shape[0],
                                              dtype=np.bool_)
                                 for ch in delta])
                    np.savez(os.path.join(d, "delta.npz"), **arrays)
                meta = {"stripes": len(stripes), "delta": bool(delta),
                        "seq": rep.seq, "watermark": rep.watermark,
                        "seed_ts": rep.seed_ts, "sig": list(rep.sig)}
                self.instance.metadb.kv_put(f"columnar.{key}.meta",
                                            json.dumps(meta))

    def load(self):
        """Boot-time restore: rebuild stripes (zone maps recomputed) and
        resume the tail from the persisted seq.  Dictionary codes persisted
        in stripe lanes stay valid because dictionaries are append-only and
        checkpointed in the same save()."""
        if not self.instance.data_dir:
            return
        with self._lock:
            for k, v in self.instance.metadb.kv_scan("columnar."):
                key = k[len("columnar."):-len(".meta")]
                if not k.endswith(".meta") or "." not in key:
                    continue
                try:
                    meta = json.loads(v)
                except Exception:
                    continue  # a corrupt record must not poison boot
                schema, table = key.split(".", 1)
                try:
                    tm = self.instance.catalog.table(schema, table)
                except Exception:
                    tm = None
                if tm is None or tuple(tm.column_names()) != \
                        tuple(meta["sig"]):
                    continue  # schema moved since the checkpoint: reseed lazily
                d = os.path.join(self.instance.data_dir, "columnar",
                                 key.replace(".", os.sep))
                rep = TableReplica(key)
                rep.sig = tuple(meta["sig"])
                stripes = []
                try:
                    for i in range(int(meta["stripes"])):
                        with np.load(os.path.join(d, f"stripe{i}.npz")) as z:
                            stripes.append(self._load_tier_chunk(tm, rep, z,
                                                                 as_stripe=True))
                    delta = ()
                    if meta.get("delta"):
                        with np.load(os.path.join(d, "delta.npz")) as z:
                            delta = (self._load_tier_chunk(tm, rep, z,
                                                           as_stripe=False),)
                except (OSError, KeyError):
                    continue  # missing/partial files: leave unenrolled
                rep.tier = (tuple(stripes), delta)
                rep.delta_rows = sum(ch.begin_ts.shape[0] for ch in delta)
                rep.seq = int(meta["seq"])
                rep.watermark = int(meta["watermark"])
                rep.seed_ts = int(meta["seed_ts"])
                # stamps applied inside the margin window can exceed the
                # persisted watermark: recover the true bound from the tier
                mx = rep.watermark
                for ch in list(rep.tier[0]) + list(rep.tier[1]):
                    n = ch.num_rows if isinstance(ch, Stripe) else \
                        int(ch.begin_ts.shape[0])
                    if n == 0:
                        continue
                    mx = max(mx, int(ch.begin_ts[:n].max()))
                    e = ch.end_ts[:n]
                    e = e[e < INFINITY_TS]
                    if e.size:
                        mx = max(mx, int(e.max()))
                rep.max_applied_ts = mx
                rep.state = READY
                rep.publish()
                self.replicas[key] = rep
        if self.replicas:
            self._start_thread()

    def _load_tier_chunk(self, tm, rep, z, as_stripe: bool):
        begin = _load_lane(z, "begin_ts")
        end = _load_lane(z, "end_ts")
        lanes, valid = {}, {}
        for c in rep.sig:
            lanes[c] = _load_lane(z, f"lane__{c}")
            valid[c] = z[f"valid__{c}"] if f"valid__{c}" in z else None
        if as_stripe:
            return self._make_stripe(tm, lanes, valid, begin, end)
        return _DeltaChunk(lanes, valid, begin, end)
