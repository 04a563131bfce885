"""Cross-query fragment cache: versioned reuse of execution artifacts.

PR 1 fused streaming segments and PR 3 pruned probe rows, but every execution
still recomputes its pipeline breakers from scratch: hash-join build sides are
re-scanned, re-filtered and re-hashed, and the runtime filters derived from
them are rebuilt — even when the underlying tables are unchanged, which is the
steady state of a CN serving millions of parameterized queries.  The reference
stops reuse at the plan (`PlanCache.java:80` keys plans on a metadata version);
this module carries the same version-driven idea into the EXECUTION plane
(the "fine-tuning data structures" direction of arxiv 2112.13099 and the
reusable-partial-results shape of arxiv 2603.26698):

- **fragment fingerprints**: a canonical, value-sensitive key for a physical
  subtree — operator shape + bound literals (via `expr_cache_key`, which bakes
  literal values and dictionary signatures/collations) + the
  ``(table, partition-set, version)`` set the subtree reads, reusing the
  table-version scheme `exec/device_cache.py` already keys lanes on;
- **hash-join build artifacts** (`BuildArtifact`): the materialized build-side
  batch, the host-built slot CSR / native chained-hash table, and the
  published runtime filters, so a warm Q5/Q9 goes straight to probe dispatch
  with filters already in hand (`exec/operators.HashJoinOp`,
  `parallel/mpp.MppExecutor._join`);
- **deterministic subplan results** (`CachedSubplanOp`): the output batches of
  small build-side subtrees (dimension scan→filter→project chains), capped by
  rows/bytes and admission-gated through the `exec/memory.py` pool hierarchy.

Correctness is version-driven, never TTL-driven:

- any DML/DDL bumps the table version (`TableMeta.bump_version` fires at
  statement time AND at commit/rollback stamping), so every fingerprint that
  read the table changes — stale entries become unreachable and age out LRU;
- a cached result must equal the canonical current-version visibility, so a
  scan only fingerprints when the execution snapshot is at or past the
  table's *settled* timestamp (the max committed begin/end MVCC stamp at this
  version): below it, an old snapshot could observe a different row set under
  the same version;
- sessions with uncommitted writes on a touched table bypass (provisional
  ±txn_id rows are visible to them only), as do `AS OF` flashback reads and
  scans over tables with cold archive files (archive attach does not ride the
  version);
- a subtree whose scans consume runtime filters PRODUCED OUTSIDE the subtree
  bypasses: those filters prune by another table's build values, which the
  fingerprint does not cover (in-subtree producer/consumer pairs are
  self-contained and stay cacheable);
- worker-resident (remote) tables have no CN-side version, so their
  fingerprints ride a per-table *epoch* that bumps on local DML and on
  ``invalidate_fragment_cache`` sync actions — cross-coordinator invalidation
  rides the existing `SyncBus` (`net/dn.py`), the same bus the reference's
  `SyncManagerHelper` uses for plan-cache invalidation.

Escape hatches: `FRAGMENT_CACHE(OFF)` statement hint, the
``GALAXYSQL_FRAGMENT_CACHE=0`` environment switch, and the
``ENABLE_FRAGMENT_CACHE`` instance config param.  Observability:
``frag_cache_{hits,misses,bytes,evictions}`` in the typed metrics registry,
``[cached build]`` annotations in EXPLAIN ANALYZE, ``SHOW FRAGMENT CACHE`` and
``information_schema.fragment_cache``.
"""

from __future__ import annotations

import collections
import os
import threading
import weakref
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np

# kill switch: GALAXYSQL_FRAGMENT_CACHE=0 disables the whole subsystem (the
# A/B lever for the cache-on-vs-off equivalence suite and benchmarks)
ENABLED = os.environ.get("GALAXYSQL_FRAGMENT_CACHE", "1") != "0"

# admission caps: the subplan lane is for SMALL build-side subtrees
# (dimension chains); anything bigger is served by the join-build lane, whose
# per-entry ceiling tracks the byte budget
SUBPLAN_MAX_ROWS = 1 << 20
SUBPLAN_MAX_BYTES = 64 << 20
DEFAULT_BUDGET = 2 << 30

_INT64_MAX = np.iinfo(np.int64).max


def default_enabled(hints: Optional[dict]) -> bool:
    """Module switch + FRAGMENT_CACHE(OFF) statement hint."""
    return ENABLED and (hints or {}).get("fragment_cache") != "off"


def for_context(instance, hints: Optional[dict]):
    """The FragmentCache an ExecContext should use, or None when disabled
    (env switch, statement hint, or ENABLE_FRAGMENT_CACHE=0)."""
    if instance is None or not default_enabled(hints):
        return None
    cache = getattr(instance, "frag_cache", None)
    if cache is None:
        return None
    try:
        if not instance.config.get("ENABLE_FRAGMENT_CACHE"):
            return None
    except Exception:
        pass  # bare instances without the config param: stay enabled
    return cache


# -- settled timestamps -------------------------------------------------------

# per-(store.uid, version) max committed MVCC stamp: the O(table) reduction
# runs once per version, same stance as plan/physical._SCAN_META
_SETTLED: Dict[Tuple[int, int], int] = {}


def settled_ts(store, version: int) -> int:
    """Max committed begin/end stamp across the store at this version.  A
    snapshot at or past this value observes the one canonical row set of the
    version: provisional (negative) stamps are invisible to other txns at ANY
    snapshot, and every committed stamp is in the past."""
    key = (store.uid, version)
    v = _SETTLED.get(key)
    if v is not None:
        return v
    m = 0
    for p in store.partitions:
        if p.num_rows == 0:
            continue
        b = p.begin_ts
        committed = b[b >= 0]
        if committed.size:
            m = max(m, int(committed.max()))
        e = p.end_ts
        ended = e[(e >= 0) & (e != _INT64_MAX)]
        if ended.size:
            m = max(m, int(ended.max()))
    if len(_SETTLED) > 512:
        _SETTLED.clear()
    _SETTLED[key] = m
    return m


# -- fragment fingerprints ----------------------------------------------------


class FragKey(NamedTuple):
    key: Tuple                    # canonical hashable subtree identity
    tables: FrozenSet[str]        # "schema.table" labels (invalidation/SHOW)


class _Uncacheable(Exception):
    pass


def fingerprint(node, ctx) -> Optional[FragKey]:
    """Canonical value-sensitive fingerprint of a physical subtree, or None
    when the subtree (or this execution) must bypass the cache."""
    frag = getattr(ctx, "frag", None)
    if frag is None:
        return None
    if getattr(ctx, "txn_id", 0) and \
            getattr(ctx, "txn_write_uids", None) is None:
        return None  # in a txn whose write set is unknown: never risk it
    tables: set = set()
    plans: set = set()      # runtime-filter ids PRODUCED by in-subtree joins
    targets: set = set()    # runtime-filter ids CONSUMED by in-subtree scans
    try:
        key = _fp(node, ctx, frag, tables, plans, targets)
        if targets - plans:
            # a scan in here is masked by a filter built from a table OUTSIDE
            # the subtree — the fingerprint cannot see that table's version
            raise _Uncacheable
        # self-heal pin: executions under a live quarantine episode get their
        # own keyspace — rolled-back (probation) artifacts and regressed-plan
        # artifacts must never cross, and probation timings stay honest.
        # (Columnar-routed executions need no statement-wide salt: each
        # replica scan fingerprints as ("cscan", seed_ts, events) below, so
        # subtrees over unchanged tables stay warm while the watermark moves.)
        pin = getattr(ctx, "plan_pin", "")
        fk = FragKey(("frag", pin, key) if pin else ("frag", key),
                     frozenset(tables))
        hash(fk.key)  # unhashable literal (list param etc.): bypass
        return fk
    except (_Uncacheable, TypeError):
        return None


def _expr_key(e):
    from galaxysql_tpu_torch.exec.operators import expr_cache_key
    if e is None:
        return None
    return expr_cache_key(e)


def _fp(node, ctx, frag, tables, plans, targets) -> Tuple:
    from galaxysql_tpu_torch.plan import logical as L
    if isinstance(node, L.Scan):
        return _fp_scan(node, ctx, frag, tables, targets)
    if isinstance(node, L.Filter):
        return ("f", _expr_key(node.cond),
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Project):
        return ("p", tuple((n, _expr_key(e)) for n, e in node.exprs),
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Aggregate):
        from galaxysql_tpu_torch.exec import skew as _skew
        return ("a", tuple((n, _expr_key(e)) for n, e in node.groups),
                tuple((a.kind, _expr_key(a.arg), a.out_id, a.distinct)
                      for a in node.aggs),
                # salted execution changes float-summation order: cached MPP
                # twins must not cross the salt boundary, and a re-ANALYZE
                # that shifts the hot-key candidates re-keys the entry
                _skew.node_signature(node, ctx),
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Join):
        from galaxysql_tpu_torch.exec import skew as _skew
        plans.update(p.filter_id for p in getattr(node, "rf_plans", []) or [])
        return ("j", node.kind, getattr(node, "scalar", False),
                tuple((_expr_key(a), _expr_key(b)) for a, b in node.equi),
                _expr_key(node.residual),
                # hybrid-join hot-key set: an artifact computed over one hot
                # set must go unreachable when ANALYZE shifts the candidates
                _skew.node_signature(node, ctx),
                _fp(node.left, ctx, frag, tables, plans, targets),
                _fp(node.right, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Sort):
        return ("s", tuple((_expr_key(e), d) for e, d in node.keys),
                node.limit, node.offset,
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Limit):
        return ("l", node.limit, node.offset,
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Union):
        return ("u", node.all,
                tuple(_fp(c, ctx, frag, tables, plans, targets)
                      for c in node.children))
    if isinstance(node, L.Window):
        return ("w", tuple(_expr_key(p) for p in node.partitions),
                tuple((_expr_key(e), d) for e, d in node.orders),
                tuple((c.kind, _expr_key(c.arg), c.out_id, c.offset, c.frame)
                      for c in node.calls),
                _fp(node.child, ctx, frag, tables, plans, targets))
    if isinstance(node, L.Values):
        return ("v", tuple(f[0] for f in node.schema),
                tuple(tuple(r) for r in node.rows))
    raise _Uncacheable


def _fp_scan(node, ctx, frag, tables, targets) -> Tuple:
    t = node.table
    tkey = f"{t.schema.lower()}.{t.name.lower()}"
    if node.as_of is not None:
        raise _Uncacheable  # flashback read: historical visibility
    if t.schema.lower() == "information_schema":
        raise _Uncacheable  # refreshed in place without a version bump
    targets.update(rt.filter_id for rt in getattr(node, "rf_targets", []) or [])
    cols = tuple((oid, c) for oid, c in node.columns)
    parts = None if node.partitions is None else tuple(node.partitions)
    sargs = tuple((c, op, v) for c, op, v in getattr(node, "sargs", []) or [])
    point = node.point_eq
    if getattr(t, "remote", None) is not None:
        if getattr(ctx, "remote_xids", None):
            raise _Uncacheable  # reads through an open worker txn branch
        tables.add(tkey)
        return ("rscan", tkey, frag.epoch(tkey), cols, parts, sargs, point)
    store = ctx.stores.get(tkey)
    if store is None:
        raise _Uncacheable
    am = getattr(ctx, "archive", None)
    if am is not None and am.files_for(tkey, getattr(ctx, "snapshot_ts", None)):
        raise _Uncacheable  # cold archive rows: not covered by the version
    cviews = getattr(ctx, "columnar", None)
    if cviews:
        view = cviews.get(tkey)
        if view is not None:
            # replica-fed scan: content-addressed by the replica generation
            # (seed_ts, applied-event count) instead of the watermark — the
            # visible set is identical for every watermark at or above the
            # tier's highest applied commit_ts, so idle watermark advances
            # (and DML against OTHER tables) keep this subtree warm
            if (getattr(ctx, "snapshot_ts", 0) or 0) < view.max_applied_ts:
                raise _Uncacheable  # watermark still below an applied stamp
            tables.add(tkey)
            return ("cscan", tkey, view.seed_ts, view.events,
                    cols, parts, sargs, point)
    if getattr(ctx, "txn_id", 0) and \
            store.uid in (getattr(ctx, "txn_write_uids", None) or ()):
        raise _Uncacheable  # own uncommitted writes are visible to us only
    snap = getattr(ctx, "snapshot_ts", None)
    if snap is not None and snap < settled_ts(store, t.version):
        raise _Uncacheable  # old snapshot: visibility differs from canonical
    tables.add(tkey)
    return ("scan", store.uid, t.version, cols, parts, sargs, point)


# -- cached values ------------------------------------------------------------


class BuildArtifact:
    """Reusable hash-join build-side state: the materialized (processed)
    build batch, the probe acceleration structure for one key set (slot CSR
    on the device path, the native chained-hash table on the CPU path), and
    the runtime filters published from the build — warm executions publish
    them without touching the build subplan at all."""

    __slots__ = ("batch", "csr", "native", "filters", "rows")

    def __init__(self, batch=None):
        self.batch = batch        # ColumnBatch (local) or DistBatch (MPP)
        self.csr = None           # (perm, starts, counts, M) | None
        self.native = None        # dict of native-join build state | None
        self.filters: Dict = {}   # (filter_id, kinds) -> RuntimeFilter
        self.rows = 0


def _nbytes_of(obj) -> int:
    """Approximate byte size of a cached value (batches, CSR tuples, native
    table structs, lists of batches)."""
    if obj is None:
        return 0
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes_of(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_nbytes_of(x) for x in obj.values())
    cols = getattr(obj, "columns", None)
    if cols is not None:  # ColumnBatch / DistBatch
        total = 0
        for c in cols.values():
            total += _nbytes_of(getattr(c, "data", None))
            total += _nbytes_of(getattr(c, "valid", None))
        return total + _nbytes_of(getattr(obj, "live", None))
    return 0


def artifact_nbytes(art: BuildArtifact) -> int:
    return (_nbytes_of(art.batch) + _nbytes_of(art.csr) +
            _nbytes_of(art.native))


class _Entry:
    __slots__ = ("value", "nbytes", "tables", "kind", "hits", "rows")

    def __init__(self, value, nbytes: int, tables: FrozenSet[str], kind: str,
                 rows: int = 0):
        self.value = value
        self.nbytes = int(nbytes)
        self.tables = tables
        self.kind = kind
        self.hits = 0
        self.rows = rows


# -- the cache ----------------------------------------------------------------


class FragmentCache:
    """Byte-budgeted LRU over fragment-keyed execution artifacts.

    Host-side bookkeeping only (the values may hold device arrays, but no
    cache operation touches device state).  Admission is gated through a
    dedicated `exec/memory.py` pool child: global memory pressure revokes
    cache bytes before queries start spilling."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET, metrics=None,
                 name: str = "fragment-cache", mem_parent=None):
        from galaxysql_tpu_torch.exec.memory import GLOBAL_POOL
        self.budget = budget_bytes
        self.entry_max_bytes = max(budget_bytes // 8, SUBPLAN_MAX_BYTES)
        self._map: "collections.OrderedDict[Tuple, _Entry]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._epochs: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admission_rejects = 0
        self.invalidations = 0
        self._metrics = metrics
        self.pool = (mem_parent or GLOBAL_POOL).child(name, budget_bytes)
        # memory pressure elsewhere sheds cached fragments first.  The
        # revoker holds the cache WEAKLY and a finalizer detaches the pool:
        # Instances are created freely (tests, workers) and have no teardown,
        # so a strongly-referenced revoker would pin every dead cache's
        # entries and pool reservation on GLOBAL_POOL forever.
        ref = weakref.ref(self)

        def _revoke(nbytes, _ref=ref):
            c = _ref()
            return c._evict_bytes(nbytes) if c is not None else 0

        self._revoker = _revoke
        self.pool.add_revoker(_revoke)
        weakref.finalize(self, _detach_pool, self.pool, _revoke)

    def set_budget(self, nbytes: int):
        """Resize the cache's byte budget live (memory governor: ELEVATED
        pressure halves it, NORMAL restores).  Shrinking evicts LRU down to
        the new cap immediately and lowers the pool ceiling so future
        admissions respect it; growing just raises both."""
        nbytes = max(0, int(nbytes))
        with self._lock:
            self.budget = nbytes
            over = self._bytes - nbytes
        self.pool.limit = nbytes
        if over > 0:
            self._evict_bytes(over)

    # -- epochs (remote tables without a CN-side version) ---------------------

    def epoch(self, table_key: str) -> int:
        with self._lock:
            return self._epochs.get(table_key, 0)

    def bump_epoch(self, table_key: str):
        with self._lock:
            self._epochs[table_key] = self._epochs.get(table_key, 0) + 1
        self.invalidate_table(table_key)

    # -- lookup / insert ------------------------------------------------------

    def get(self, key: Tuple):
        with self._lock:
            e = self._map.get(key)
            if e is None:
                self.misses += 1
                self._push_metrics_locked()
                hit, kind, rows = False, str(key[0]), 0
            else:
                self._map.move_to_end(key)
                e.hits += 1
                self.hits += 1
                self._push_metrics_locked()
                hit, kind, rows = True, e.kind, e.rows
        # traced queries see cache decisions as zero-duration spans under the
        # operator that asked (hit = the subtree below it never ran)
        from galaxysql_tpu_torch.utils import tracing as _tr
        tc = _tr.current()
        if tc is not None:
            tc.event(f"frag-cache:{kind}", kind="cache", hit=hit, rows=rows)
        return e.value if e is not None else None

    def put(self, key: Tuple, value, nbytes: int, tables: FrozenSet[str],
            kind: str, rows: int = 0) -> bool:
        """Admission-gated insert; returns False when rejected.  Concurrent
        inserts of the same key keep the FIRST entry (byte accounting stays
        exact; the values are equivalent by construction)."""
        nbytes = int(nbytes)
        if nbytes > self.entry_max_bytes:
            with self._lock:
                self.admission_rejects += 1
            return False
        if not self.pool.try_reserve(nbytes):
            # shed LRU entries, then retry the reservation once
            self._evict_bytes(nbytes)
            if not self.pool.try_reserve(nbytes):
                with self._lock:
                    self.admission_rejects += 1
                return False
        release = 0
        with self._lock:
            if key in self._map:
                release = nbytes  # lost the race: keep the first entry
            else:
                self._map[key] = _Entry(value, nbytes, tables, kind, rows)
                self._bytes += nbytes
                while self._bytes > self.budget and len(self._map) > 1:
                    _, old = self._map.popitem(last=False)
                    self._bytes -= old.nbytes
                    release += old.nbytes
                    self.evictions += 1
            self._push_metrics_locked()
        if release:
            self.pool.release(release)
        return True

    # -- eviction / invalidation ----------------------------------------------

    def _evict_bytes(self, nbytes: int) -> int:
        freed = 0
        with self._lock:
            while self._map and freed < nbytes:
                _, old = self._map.popitem(last=False)
                self._bytes -= old.nbytes
                freed += old.nbytes
                self.evictions += 1
            self._push_metrics_locked()
        if freed:
            self.pool.release(freed)
        return freed

    def _revoke(self, nbytes: int) -> int:
        return self._evict_bytes(nbytes)

    def invalidate_table(self, table_key: str) -> int:
        """Drop every entry that read `table_key` ("schema.table", lower).
        Version/epoch keying already makes stale entries unreachable — this
        frees their bytes immediately (DML hygiene + SyncBus actions)."""
        freed = 0
        with self._lock:
            dead = [k for k, e in self._map.items() if table_key in e.tables]
            for k in dead:
                e = self._map.pop(k)
                self._bytes -= e.nbytes
                freed += e.nbytes
            if dead:
                self.invalidations += len(dead)
            self._push_metrics_locked()
        if freed:
            self.pool.release(freed)
        return len(dead)

    def drop_kind(self, kind: str) -> int:
        """Drop every entry of one lane (subplan / join_build / mpp_*) —
        operational lever (and test hook) for steering which reuse engages."""
        freed = 0
        with self._lock:
            dead = [k for k, e in self._map.items() if e.kind == kind]
            for k in dead:
                e = self._map.pop(k)
                self._bytes -= e.nbytes
                freed += e.nbytes
            self._push_metrics_locked()
        if freed:
            self.pool.release(freed)
        return len(dead)

    def clear(self):
        with self._lock:
            freed = self._bytes
            self._map.clear()
            self._bytes = 0
            self._push_metrics_locked()
        if freed:
            self.pool.release(freed)

    def close(self):
        self.clear()
        _detach_pool(self.pool, self._revoker)

    # -- observability --------------------------------------------------------

    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._map)

    def rows(self) -> List[Tuple[str, str, int, int, int]]:
        """(kind, tables, rows, bytes, hits) per entry, MRU first — the
        SHOW FRAGMENT CACHE / information_schema.fragment_cache row shape."""
        with self._lock:
            entries = list(self._map.values())
        return [(e.kind, ",".join(sorted(e.tables)), e.rows, e.nbytes, e.hits)
                for e in reversed(entries)]

    def _push_metrics_locked(self):
        m = self._metrics
        if m is None:
            return
        # Counter._set under the registry's own locks; safe while holding
        # self._lock (the registry never calls back into the cache)
        m.counter("frag_cache_hits", "fragment cache hits")._set(self.hits)
        m.counter("frag_cache_misses",
                  "fragment cache misses")._set(self.misses)
        m.counter("frag_cache_evictions",
                  "fragment cache LRU evictions")._set(self.evictions)
        m.gauge("frag_cache_bytes",
                "fragment cache resident bytes").set(self._bytes)
        m.gauge("frag_cache_entries",
                "fragment cache entries").set(len(self._map))


def _detach_pool(pool, revoker):
    """Release a (possibly dead) cache's pool from its parent — also the
    weakref.finalize target, so it must not reference the cache itself."""
    pool.remove_revoker(revoker)
    pool.close()


# -- the subplan result lane --------------------------------------------------


class CachedSubplanOp:
    """Operator wrapper caching the full output of a small deterministic
    subtree.  A warm pull never touches the wrapped operator; a cold pull
    streams through unchanged and admits the collected batches only when the
    subtree drained completely within the row/byte caps."""

    def __init__(self, inner, cache: FragmentCache, fkey: FragKey, trace=None):
        self.inner = inner
        self.cache = cache
        self.fkey = fkey
        self.trace = trace

    def batches(self):
        key = ("subplan", self.fkey.key)
        got = self.cache.get(key)
        if got is not None:
            if self.trace is not None:
                self.trace.append(f"frag-subplan hit batches={len(got)}")
            yield from got
            return
        out = []
        nbytes = 0
        rows = 0
        fits = True
        for b in self.inner.batches():
            if fits:
                out.append(b)
                nbytes += _nbytes_of(b)
                rows += b.capacity
                if rows > SUBPLAN_MAX_ROWS or nbytes > SUBPLAN_MAX_BYTES:
                    fits = False
                    out = []
            yield b
        if fits:
            self.cache.put(key, out, nbytes, self.fkey.tables,
                           kind="subplan", rows=rows)
