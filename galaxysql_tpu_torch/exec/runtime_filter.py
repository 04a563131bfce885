"""Planned runtime filters: join build sides prune probe-side scans.

Reference analog: the runtime-filter planning rules of `core/planner/rule/mpp/
runtimefilter` (`JoinToRuntimeFilterJoinRule`, `PushBloomFilterRule`, SURVEY.md
§2.5) plus the execution plane of `RuntimeFilterBuilderExec` →
`util/{bloomfilter,minmaxfilter}` → scan pushdown (§2.6, §5.1).  The planner
(`plan/rules.plan_runtime_filters`) walks inner/semi hash joins, matches build
keys to probe-side base-table columns through projections/renames, and
annotates the plan with filter edges: a `RuntimeFilterPlan` on the join (the
producer) and a `RuntimeFilterTarget` on the probe-side scan (the consumer).

At execution the hash-join build side, once materialized, publishes a
`RuntimeFilter` — a byte-plane bloom over the join key plus a min/max range
(and an IN-list for very small builds) — into the per-execution
`RuntimeFilterManager`.  Consumers read it lazily at first probe pull, which
in every engine (pull-model local executor, recursive MPP walk) happens after
the build side has drained, so no cross-operator synchronization is needed:

- local scans apply the filter on-device as an `("rf", …)` prelude stage
  inside a `FusedSegment` (`exec/fusion.py`): cache keys carry only the static
  shape (`nbits`, has-minmax), the filter words/range arrive as runtime
  kernel arguments — a plan-cache hit never retraces;
- MPP shards apply the same fused stage over the distributed lanes before the
  probe-stage dispatch (`parallel/mpp.py`), the filter built once on the host
  and reused by every shard;
- remote-worker scan fragments ship the min/max range (and small builds as an
  IN-list) inside the XPlan fragment (`net/dn.py`/`net/worker.py`) so the DN
  prunes before rows cross the process seam;
- cold parquet scans feed the min/max range into the SARG file refutation
  (`storage/archive.py`) to skip whole files.

Filter semantics are exact for the planned join kinds (inner/semi): a
filter-negative probe row is provably unmatched, NULL join keys never match,
and an EMPTY build side publishes a pass-NOTHING filter (never pass-all).
An absent filter (grace-spilled build, skipped publish) means pass-all.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

# -- planning gates (consulted by plan/rules.plan_runtime_filters) ------------

RF_MIN_PROBE_ROWS = 8192        # probe below this is already cheap: no filter
RF_MAX_SELECTIVITY = 0.75       # filter passing more than this prunes nothing
RF_BLOOM_MAX_BUILD = 1 << 20    # bloom kind only below this build cardinality
RF_BLOOM_MIN_BITS = 1 << 12
RF_BLOOM_MAX_BITS = 1 << 22     # 4MB flags ceiling (host build + device arg)
RF_IN_LIST_MAX = 256            # small builds additionally ship an IN-list
RF_PUBLISH_MAX_ROWS = 1 << 22   # LIVE build rows above this skip publishing
RF_PUBLISH_MAX_LANES = RF_PUBLISH_MAX_ROWS * 4  # transfer-size bail-out:
# a padded/mostly-dead build keeps its filter as long as the key-lane
# transfer stays bounded; above this even the transfer is not worth it

# module-level accounting (bench.py probe-rows delta metric; the DISPATCH_STATS
# idiom: plain int adds, no locks, reset around measured runs).  `enabled`
# gates the one extra pre-bloom num_live() sync in HashJoinOp so the default
# hot path pays nothing.
RF_STATS = {"enabled": False, "probe_rows": 0, "rows_pruned": 0,
            "files_pruned": 0, "filters_built": 0, "filters_cached": 0}


def reset_rf_stats(enabled: bool = False):
    RF_STATS.update(probe_rows=0, rows_pruned=0, files_pruned=0,
                    filters_built=0, filters_cached=0, enabled=enabled)


# -- plan annotations ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeFilterTarget:
    """Consumer edge on a probe-side L.Scan: apply filter `filter_id` to the
    scan output column `out_id` (storage column `column`)."""
    filter_id: int
    out_id: str                  # plan field id (the env key filters mask on)
    column: str                  # storage column name (remote/archive pushdown)
    kinds: FrozenSet[str]        # {"bloom", "minmax"}


@dataclasses.dataclass(frozen=True)
class RuntimeFilterPlan:
    """Producer edge on an L.Join: equi pair `pair_index` publishes filter
    `filter_id` when the side holding the target scan ends up the probe."""
    filter_id: int
    pair_index: int
    target_side: str             # "left" | "right" — side the target scan is on
    kinds: FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class RfPublish:
    """Resolved producer spec handed to HashJoinOp: evaluate `build_key` over
    the materialized build side, publish in `probe_key`'s lane domain."""
    filter_id: int
    build_key: object            # ir.Expr
    probe_key: object            # ir.Expr
    kinds: FrozenSet[str]


# -- the filter value ---------------------------------------------------------


def _bloom_positions(xp, data, nbits: int):
    """THE bit-position scheme of the planned-filter bloom: two positions per
    key from one mix64.  The ONE home for this math — the host build
    (`_bloom_flags`) and the np/jnp probe stages (`RfStageRef.make_fn`) must
    stay hash-identical or bloom false negatives silently drop join rows."""
    if xp is np:
        from galaxysql_tpu_torch.meta.statistics import _mix64 as mix
    else:
        from galaxysql_tpu_torch.kernels.relational import _mix64 as mix
    h = mix(data.astype(xp.int64).astype(xp.uint64))
    m = xp.uint64(nbits - 1)
    return ((h & m).astype(xp.int32),
            ((h >> xp.uint64(32)) & m).astype(xp.int32))


def _bloom_flags(keys: np.ndarray, nbits: int) -> np.ndarray:
    """Byte-plane bloom (one flag byte per bit — no packing, so the device
    query is two gathers + AND)."""
    with np.errstate(over="ignore"):
        b1, b2 = _bloom_positions(np, keys, nbits)
    flags = np.zeros(nbits, dtype=np.uint8)
    flags[b1] = 1
    flags[b2] = 1
    return flags


class RuntimeFilter:
    """Published build-side filter: bloom flags + min/max range + IN-list.

    The static shape (`nbits`, has-minmax) keys the compiled consumer program;
    the values (`flags`, `lo`, `hi`) are runtime arguments — same lifting
    stance as `LiftedLiterals`, so repeated executions never retrace."""

    __slots__ = ("n_build", "flags", "nbits", "lo", "hi", "in_values")

    def __init__(self, n_build: int, flags: Optional[np.ndarray], nbits: int,
                 lo, hi, in_values: Optional[np.ndarray]):
        self.n_build = n_build
        self.flags = flags
        self.nbits = nbits
        self.lo = lo
        self.hi = hi
        self.in_values = in_values

    @classmethod
    def build(cls, keys: np.ndarray, kinds,
              key_is_string: bool = False) -> Optional["RuntimeFilter"]:
        kinds = set(kinds)
        n = int(keys.size)
        if n == 0:
            # EMPTY build side: the filter must pass NOTHING (an inner/semi
            # join over an empty build produces no rows), never everything —
            # an inverted range refutes every value of any dtype
            return cls(0, None, 0, np.int64(1), np.int64(0),
                       np.zeros(0, dtype=np.int64)
                       if "bloom" in kinds else None)
        lo = hi = None
        flags = None
        nbits = 0
        in_vals = None
        if "minmax" in kinds:
            lo, hi = keys.min(), keys.max()
        if "bloom" in kinds and n <= RF_BLOOM_MAX_BUILD:
            nbits = 1 << max(RF_BLOOM_MIN_BITS.bit_length() - 1,
                             int(n * 16 - 1).bit_length())  # ~16 bits/key
            nbits = min(nbits, RF_BLOOM_MAX_BITS)
            flags = _bloom_flags(keys, nbits)
        # the IN-list is exact membership — the bloom family: honoring the
        # RUNTIME_FILTER(MINMAX) hint means no membership pushdown either
        if "bloom" in kinds and n <= RF_IN_LIST_MAX * 4 and not key_is_string:
            u = np.unique(keys)
            if u.size <= RF_IN_LIST_MAX:
                in_vals = u
        if flags is None and lo is None and in_vals is None:
            return None
        return cls(n, flags, nbits, lo, hi, in_vals)

    def static_key(self) -> Tuple:
        return (self.nbits, self.lo is not None)

    def runtime_args(self) -> Tuple:
        return (self.flags if self.flags is not None
                else np.zeros(1, dtype=np.uint8),
                np.asarray(self.lo if self.lo is not None else 0),
                np.asarray(self.hi if self.hi is not None else 0))

    def pass_nothing(self) -> bool:
        return self.n_build == 0


def build_filter(env_np: Dict[str, Tuple], live: np.ndarray, build_key,
                 probe_key, kinds) -> Optional[RuntimeFilter]:
    """Evaluate `build_key` over a host build-side env and build the filter in
    `probe_key`'s lane domain (string codes translated build→probe dictionary;
    codes absent from the probe dictionary match no probe row and drop out)."""
    from galaxysql_tpu_torch.chunk.batch import dictionary_translation
    from galaxysql_tpu_torch.expr.compiler import ExprCompiler, _find_dictionary
    n = int(live.shape[0])
    if n == 0:
        return RuntimeFilter.build(np.zeros(0, dtype=np.int64), kinds)
    d, v = ExprCompiler(np).compile(build_key)(env_np)
    d = np.broadcast_to(np.asarray(d), (n,))
    eff = live
    if v is not None:
        eff = eff & np.broadcast_to(np.asarray(v), (n,))
    keys = d[eff]
    is_string = build_key.dtype.is_string and probe_key.dtype.is_string
    if is_string:
        db = _find_dictionary(build_key)
        dp = _find_dictionary(probe_key)
        if db is not None and dp is not None and db is not dp:
            trans = dictionary_translation(dp, db)
            keys = trans[np.clip(keys, 0, trans.shape[0] - 1)]
            keys = keys[keys >= 0]
    RF_STATS["filters_built"] += 1
    return RuntimeFilter.build(keys, kinds, key_is_string=is_string)


# -- per-execution manager ----------------------------------------------------


class RuntimeFilterManager:
    """Per-execution publish/consume hub (the coordinator merge hub of
    `QueryBloomFilter.java` collapsed to one process: producers publish once,
    consumers read lazily after the build has drained)."""

    def __init__(self, hints: Optional[dict] = None, metrics=None):
        h = hints or {}
        mode = str(h.get("runtime_filter") or "").lower()
        self.mode = "off" if (h.get("no_bloom") or mode == "off") else "on"
        self.filters: Dict[int, RuntimeFilter] = {}
        self._consumed: set = set()      # id(L.Scan) already wired to a segment
        self.metrics = metrics           # utils/metrics.MetricsRegistry or None
        self.build_ms = 0.0
        # filter_id -> {"node_id","column","kinds","pruned"} (EXPLAIN ANALYZE)
        self.stats: Dict[int, dict] = {}

    # -- producer side --------------------------------------------------------

    def publish(self, filter_id: int, f: Optional[RuntimeFilter]):
        if f is not None:
            self.filters[filter_id] = f

    def note_build(self, ms: float):
        self.build_ms += ms
        if self.metrics is not None:
            self.metrics.gauge("rf_build_ms",
                               "runtime-filter build wall ms").inc(ms)
            # register the prune counters eagerly so SHOW METRICS lists the
            # whole rf_* family as soon as any filter exists
            self.metrics.counter("rf_rows_pruned",
                                 "probe rows pruned by runtime filters")
            self.metrics.counter("rf_files_pruned",
                                 "archive files pruned by runtime filters")

    # -- consumer side --------------------------------------------------------

    def published(self, filter_id: int) -> Optional[RuntimeFilter]:
        if self.mode == "off":
            return None
        return self.filters.get(filter_id)

    def stages_for(self, node) -> List[Tuple[str, "RfStageRef"]]:
        """("rf", ref) fused-segment stages for a probe-side scan node."""
        from galaxysql_tpu_torch.plan import logical as L
        if self.mode == "off" or not isinstance(node, L.Scan):
            return []
        targets = getattr(node, "rf_targets", None) or []
        return [("rf", RfStageRef(self, t)) for t in targets]

    def mark_consumed(self, node):
        self._consumed.add(id(node))

    def consumed(self, node) -> bool:
        return id(node) in self._consumed

    def segment_for_scan(self, node):
        """The ONE scan-level consume step shared by the local and MPP
        engines: an rf-only FusedSegment for the scan's unconsumed planned
        filters (marked consumed), or None when there is nothing to apply."""
        if self.consumed(node):
            return None
        stages = self.stages_for(node)
        if not stages:
            return None
        self.mark_consumed(node)
        from galaxysql_tpu_torch.exec.fusion import FusedSegment
        return FusedSegment(stages)

    # -- observability --------------------------------------------------------

    def note_pruned(self, target: RuntimeFilterTarget, pruned: int,
                    node_id: Optional[int] = None):
        st = self.stats.setdefault(
            target.filter_id,
            {"node_id": node_id, "column": target.column,
             "kinds": "+".join(sorted(target.kinds)), "pruned": 0})
        if node_id is not None:
            st["node_id"] = node_id
        st["pruned"] += int(pruned)
        RF_STATS["rows_pruned"] += int(pruned)
        if self.metrics is not None and pruned > 0:
            self.metrics.counter(
                "rf_rows_pruned",
                "probe rows pruned by runtime filters").inc(int(pruned))

    def note_file_pruned(self, path: str = ""):
        RF_STATS["files_pruned"] += 1
        if self.metrics is not None:
            self.metrics.counter(
                "rf_files_pruned",
                "archive files pruned by runtime filters").inc()

    # -- pushdown extraction (remote fragments / archive SARGs) ---------------

    def scan_pushdown(self, node) -> Tuple[List[Tuple[str, str, float]],
                                           List[Tuple[str, list]]]:
        """(minmax sargs, in-lists) in lane domain for a scan's published
        filters — numeric columns only (string codes are assignment-ordered
        CN-side and mean nothing to a worker's own dictionary)."""
        sargs: List[Tuple[str, str, float]] = []
        inlists: List[Tuple[str, list]] = []
        for t in getattr(node, "rf_targets", None) or []:
            f = self.published(t.filter_id)
            if f is None:
                continue
            cm = node.table.column(t.column)
            if cm.dtype.is_string:
                continue
            if f.lo is not None:
                sargs.append((t.column, "ge", _lane_num(f.lo)))
                sargs.append((t.column, "le", _lane_num(f.hi)))
            if f.in_values is not None and f.in_values.size <= RF_IN_LIST_MAX:
                inlists.append((t.column,
                                [_lane_num(x) for x in f.in_values.tolist()]))
        return sargs, inlists


def _lane_num(v):
    """Lane value -> JSON-safe number (ints stay exact ints)."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    f = float(v)
    return int(f) if f.is_integer() else f


# -- fused-segment stage ------------------------------------------------------


class RfStageRef:
    """One ("rf", …) stage inside a FusedSegment: a lazy binding of a scan
    column to a published RuntimeFilter.  Resolution happens at first program
    build — after the producing join's build side drained — and memoizes per
    segment instance (segments are rebuilt per execution)."""

    def __init__(self, manager: RuntimeFilterManager,
                 target: RuntimeFilterTarget):
        self.manager = manager
        self.target = target
        self._resolved = None

    def _resolve(self):
        if self._resolved is None:
            f = self.manager.published(self.target.filter_id)
            if f is None:
                self._resolved = (("off",), ())
            else:
                self._resolved = (f.static_key(), f.runtime_args())
        return self._resolved

    def static_key(self) -> Tuple:
        return ("rf", self.target.out_id, self._resolve()[0])

    def runtime_args(self) -> Tuple:
        return self._resolve()[1]

    def make_fn(self, xp):
        """(env, live, args) -> live' for the segment's apply loop."""
        static = self._resolve()[0]
        if static == ("off",):
            return lambda env, live, args: live
        nbits, has_minmax = static
        col = self.target.out_id

        def fn(env, live, args):
            flags, lo, hi = args
            d, v = env[col]
            n = live.shape[0]
            d = xp.broadcast_to(xp.asarray(d), (n,))
            hit = None
            if nbits:
                b1, b2 = _bloom_positions(xp, d, nbits)
                fl = xp.asarray(flags)
                hit = (fl[b1] & fl[b2]) > 0
            if has_minmax:
                mm = (d >= lo) & (d <= hi)
                hit = mm if hit is None else hit & mm
            if v is not None:
                # NULL probe keys never match an inner/semi join
                hit = hit & xp.broadcast_to(xp.asarray(v), (n,))
            return live & hit

        if xp is np:
            def fn_np(env, live, args, _fn=fn):
                with np.errstate(over="ignore"):
                    return _fn(env, live, args)
            return fn_np
        return fn


# -- producer helpers (HashJoinOp / MppExecutor) ------------------------------


def specs_for(node, probe_side: str,
              manager: Optional[RuntimeFilterManager]) -> List[RfPublish]:
    """Producer specs for a join node's ACTIVE filter edges: only those whose
    annotated target side matches the side that actually ended up the probe
    (a stats shift since planning flips the build choice — the edge then
    deactivates rather than filtering the wrong side).  The ONE home for the
    equi-pair side-flip convention, shared by the local and MPP engines."""
    plans = getattr(node, "rf_plans", None) or []
    if manager is None or manager.mode == "off" or not plans:
        return []
    out: List[RfPublish] = []
    for p in plans:
        if p.target_side != probe_side:
            continue
        le, re_ = node.equi[p.pair_index]
        bk, pk = (re_, le) if probe_side == "left" else (le, re_)
        out.append(RfPublish(p.filter_id, bk, pk, p.kinds))
    return out


def _build_key_columns(specs: List[RfPublish]) -> set:
    from galaxysql_tpu_torch.expr import ir
    needed: set = set()
    for spec in specs:
        needed.update(ir.referenced_columns(spec.build_key))
    return needed


def publish_from_env(manager: Optional[RuntimeFilterManager],
                     specs: List[RfPublish], env_np: Dict, live: np.ndarray):
    """Build + publish every spec's filter from a host build-side env."""
    if manager is None or not specs or manager.mode == "off":
        return
    # gate on LIVE rows (same stance as the bloom caps): a padded or
    # mostly-dead build side keeps its filter; only true cardinality bails
    if int(np.count_nonzero(live)) > RF_PUBLISH_MAX_ROWS:
        return
    t0 = time.perf_counter()
    for spec in specs:
        f = build_filter(env_np, live, spec.build_key, spec.probe_key,
                         spec.kinds)
        manager.publish(spec.filter_id, f)
    manager.note_build(round((time.perf_counter() - t0) * 1000, 3))


def publish_from_batch(manager: Optional[RuntimeFilterManager],
                       specs: List[RfPublish], build_batch):
    """HashJoinOp entry: publish from a materialized build ColumnBatch.
    Size-gated BEFORE any device→host transfer, and only the build-KEY
    columns are materialized — never the whole build payload."""
    if manager is None or not specs or manager.mode == "off":
        return
    if build_batch.capacity == 0:
        t0 = time.perf_counter()
        for spec in specs:
            manager.publish(spec.filter_id,
                            RuntimeFilter.build(np.zeros(0, dtype=np.int64),
                                                spec.kinds))
        manager.note_build(round((time.perf_counter() - t0) * 1000, 3))
        return
    if build_batch.capacity > RF_PUBLISH_MAX_LANES:
        return  # even the key-lane transfer is not worth it at this size
    needed = _build_key_columns(specs)
    env = {n: (c.np_data(), None if c.valid is None else c.np_valid())
           for n, c in build_batch.columns.items() if n in needed}
    publish_from_env(manager, specs, env, build_batch.np_live())


def capture_published(manager: Optional[RuntimeFilterManager],
                      specs: List[RfPublish]) -> Dict:
    """Snapshot the filters `specs` just published, keyed (filter_id, kinds)
    — the fragment-cache handoff: a warm execution re-publishes the snapshot
    instead of re-reading the build side (exec/fragment_cache.BuildArtifact).
    A spec absent from the manager (size-gated publish) stays absent: absent
    filters mean pass-all on both the cold and the warm path."""
    out: Dict = {}
    if manager is None:
        return out
    for spec in specs:
        f = manager.filters.get(spec.filter_id)
        if f is not None:
            out[(spec.filter_id, spec.kinds)] = f
    return out


def publish_captured(manager: Optional[RuntimeFilterManager],
                     specs: List[RfPublish], filters: Dict) -> int:
    """Publish a cached filter snapshot for this execution's active specs.
    Keys carry the filter kinds, so a snapshot built under a different
    RUNTIME_FILTER(...) hint never leaks across hint modes."""
    if manager is None or manager.mode == "off" or not specs or not filters:
        return 0
    n = 0
    for spec in specs:
        f = filters.get((spec.filter_id, spec.kinds))
        if f is not None:
            manager.publish(spec.filter_id, f)
            n += 1
    if n:
        RF_STATS["filters_cached"] += n
        manager.note_build(0.0)  # registers the rf_* metric family
    return n


def publish_from_dist(manager: Optional[RuntimeFilterManager],
                      specs: List[RfPublish], columns: Dict, live):
    """MppExecutor entry: publish from distributed build lanes (gathered to
    host once, build-key columns only)."""
    if manager is None or not specs or manager.mode == "off":
        return
    if int(live.shape[0]) > RF_PUBLISH_MAX_LANES:
        return  # even the key-lane transfer is not worth it at this size
    needed = _build_key_columns(specs)
    env = {i: (np.asarray(c.data),
               None if c.valid is None else np.asarray(c.valid))
           for i, c in columns.items() if i in needed}
    publish_from_env(manager, specs, env, np.asarray(live))
