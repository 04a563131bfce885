"""Skew-aware distributed execution policy: heavy-hitter hybrid joins and
salted aggregation.

Real traffic is Zipfian; a plain hash repartition routes every probe row of a
hot join key to ONE mesh shard, so the whole MPP stage runs at the speed of
the hottest device — and, in this engine's fixed-shape discipline, the per-
destination `quota` of `parallel/exchange.repartition_by_hash` balloons
through the overflow-retry ladder until the hot key fits, inflating every
(src, dst) bucket S-fold.  JSPIM (PAPERS.md) grounds the skew-aware join
shape; "Fine-Tuning Data Structures for Analytical Query Processing"
(PAPERS.md) grounds choosing the per-key execution strategy from observed
statistics rather than a fixed plan shape.

The division of labor:

- **detection** lives in `meta/statistics.HeavyHitterSketch` (Space-Saving),
  populated by ANALYZE and refreshed from materialized hash-join build sides
  (`exec/operators.HashJoinOp` → `observe_build_keys`, no extra device sync);
- **planning** (`plan/rules.plan_skew`) plants `SkewJoinPlan`s on joins whose
  probe-key column has heavy hitters and a `SaltAggPlan` on aggregates whose
  group-key column does — candidate values + frequencies only, because the
  planner does not know the mesh size;
- **activation** happens here at execution time: the executor thresholds the
  candidates by its actual shard count, re-checks the stats for drift
  (mirroring how runtime filters deactivate instead of misfiring), and hands
  `parallel/mpp.py` the hot-key hash set / salt fan-out;
- **escape hatches**: `SKEW(OFF|JOIN|AGG)` statement hint (structural: the
  planning pass never plants plans it covers), the `ENABLE_SKEW_EXECUTION`
  instance param, and the ``GALAXYSQL_SKEW=0`` environment switch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, FrozenSet, Optional, Tuple

import numpy as np

# kill switch: GALAXYSQL_SKEW=0 disables detection, planning and execution
ENABLED = os.environ.get("GALAXYSQL_SKEW", "1") != "0"

# planner candidate floor: the sketch's own error bound is total/K = 1/64 of
# observed rows, so frequencies below it are noise
MIN_CANDIDATE_FRAC = 1.0 / 64

# execution threshold: value v is HOT on an S-shard mesh when freq(v) * S >=
# HOT_RATIO — i.e. the key alone would fill its destination shard to at least
# HOT_RATIO times the fair per-shard share.  0.5 removes every lump big
# enough to push a destination bucket toward quota-ladder doubling; a hot
# key's rows on the OTHER side are few, so the broadcast stays cheap
HOT_RATIO = 0.5

# salted aggregation demands stronger dominance: unlike the join (whose
# shuffle happens either way — hybrid only re-routes it), salting REPLACES
# the local-partial path with a raw-row repartition, so a merely-popular
# low-NDV key (GROUP BY a 7-value status column) must not trigger it
AGG_HOT_RATIO = 1.5

# probe/input row floor: tiny inputs repartition cheaply no matter how skewed
MIN_SKEW_ROWS = 1 << 15

# at most this many hot keys broadcast (also the sketch capacity)
MAX_HOT = 64

# stats-drift deactivation: live row count vs ANALYZE-time sketch total
DRIFT_RATIO = 1.5

# salted aggregation fan-out bounds (small on purpose: the final merge stage
# re-combines one partial group per salt bucket)
SALT_MIN_FACTOR = 2
SALT_MAX_FACTOR = 8


def hint_mode(hints) -> str:
    """SKEW hint value: 'all' (default), 'join', 'agg', or 'off'."""
    m = (hints or {}).get("skew")
    return m if m in ("off", "join", "agg") else "all"


def plan_modes(hints) -> FrozenSet[str]:
    """Feature set the PLANNER may plant ('join'/'agg').  The SKEW hint and
    the env switch act here — structurally: a mode absent from this set never
    gets a plan on the node, so the hybrid path cannot engage at all."""
    if not ENABLED:
        return frozenset()
    m = hint_mode(hints)
    if m == "off":
        return frozenset()
    if m in ("join", "agg"):
        return frozenset((m,))
    return frozenset(("join", "agg"))


def exec_modes(hints, instance, session_overlay=None) -> FrozenSet[str]:
    """Feature set the EXECUTOR may activate: planner modes further gated by
    the ENABLE_SKEW_EXECUTION param (dynamic — cached plans keep their skew
    annotations, this switch makes them inert).  `session_overlay` is the
    session's SET variables (the session re-derives ctx.skew_modes with it,
    same stance as SORT_SPILL_BYTES et al)."""
    modes = plan_modes(hints)
    if not modes or instance is None or \
            getattr(instance, "config", None) is None:
        return modes  # bare instances without a config: stay enabled
    if not instance.config.get("ENABLE_SKEW_EXECUTION", session_overlay):
        return frozenset()
    return modes


# -- plan annotations ---------------------------------------------------------


@dataclasses.dataclass
class SkewJoinPlan:
    """Hybrid-join annotation for ONE probe direction of an equi join.

    `candidates` are (lane value, estimated frequency) pairs of the probe-side
    key column — the executor thresholds them by its actual mesh size, so one
    plan serves any S.  `tm` is the probe scan's TableMeta (runtime re-check
    reads its live stats); `total` is the sketch's observed row count at
    planning, the baseline the drift check compares against."""

    pair_index: int
    target_side: str                     # the skewed PROBE side: left|right
    candidates: Tuple[Tuple[Any, float], ...]
    table: str                           # "schema.table" of the probe scan
    column: str                          # storage column name
    total: int
    tm: Any = None

    def signature(self) -> Tuple:
        return ("skewj", self.pair_index, self.target_side, self.table,
                self.column, self.candidates)


@dataclasses.dataclass
class SaltAggPlan:
    """Salted-repartition annotation for a GROUP BY whose key column is
    skewed: rows repartition on hash(key, salt) with a small fan-out factor,
    a per-shard partial aggregates, and a final merge stage re-combines the
    salt buckets (plan/rules.plan_skew plants it; MppExecutor executes)."""

    candidates: Tuple[Tuple[Any, float], ...]
    table: str
    column: str
    total: int
    tm: Any = None

    def signature(self) -> Tuple:
        return ("skewa", self.table, self.column, self.candidates)


# -- execution-time activation ------------------------------------------------


@dataclasses.dataclass
class ActiveJoinSkew:
    plan: SkewJoinPlan
    values: Tuple[Any, ...]      # lane values hot at THIS mesh size
    # which executor side is skewed: 'probe' (hot build rows broadcast, hot
    # probe rows stay local) or 'build' (the mirror: hot PROBE rows
    # broadcast, the skewed build side's hot rows stay where the scan layout
    # already balanced them; inner joins only)
    orientation: str = "probe"

    def hot_mass(self) -> float:
        """Estimated row fraction the hot set covers on the skewed side —
        the cold shuffle's quotas shrink by it (discounted 25% for sketch
        error; the overflow ladder covers underestimates)."""
        vs = set(self.values)
        return 0.75 * sum(f for v, f in self.plan.candidates if v in vs)

    def hot_hashes(self) -> np.ndarray:
        return hot_hash_lane(self.values)


def hot_hash_lane(values) -> np.ndarray:
    """Host twin of `kernels.relational.hash_columns` for one non-NULL
    integer key lane: the hybrid join classifies rows by this hash on device,
    so the host-computed hot set must reproduce it bit-for-bit (int lanes
    convert through int64 sign extension exactly like jnp.astype)."""
    from galaxysql_tpu_torch.meta.statistics import _mix64
    v = np.asarray(list(values), dtype=np.int64).astype(np.uint64)
    return _mix64(v)


def _hot_values(candidates, S: int, ratio: float = HOT_RATIO) \
        -> Tuple[Any, ...]:
    return tuple(v for v, f in candidates if f * S >= ratio)[:MAX_HOT]


def recheck(plan, ctx) -> bool:
    """Runtime stats re-check, mirroring runtime-filter deactivation: stats
    drift disables the skew path instead of executing a stale shape.

    Two triggers: (1) the live row count has drifted more than DRIFT_RATIO
    from the ANALYZE-time sketch total (bulk DML since ANALYZE); (2) the
    runtime heavy-hitter twin — refreshed whenever this column materializes
    as a hash-join build key — has seen a comparable sample and the planned
    top key is no longer remotely hot in it."""
    store = ctx.stores.get(plan.table)
    if store is None or plan.total <= 0:
        return False
    n = store.row_count()
    if n <= 0:
        return False
    r = n / float(plan.total)
    if r > DRIFT_RATIO or r < 1.0 / DRIFT_RATIO:
        return False
    tm = plan.tm
    if tm is not None and plan.candidates:
        hh = tm.stats.heavy_rt.get(plan.column)
        if hh is not None and hh.total >= plan.total / 4:
            top_v, top_f = plan.candidates[0]
            if hh.counts.get(top_v, 0) / hh.total < top_f / 8.0:
                return False
    return True


def active_join_skew(node, ctx, probe_side: str, S: int) \
        -> Optional[ActiveJoinSkew]:
    """The hybrid-join activation for the sides the executor actually chose,
    or None (no plan / stats drift / nothing hot at this mesh size / skew
    execution disabled).

    A plan whose skewed column lands on the executor's PROBE side activates
    in 'probe' orientation; one landing on the BUILD side (the engine keeps
    the right side as build unless the left is 4x smaller, so a skewed fact
    often IS the build) activates in 'build' orientation — inner joins only,
    because broadcasting hot probe rows would multiply left/semi/anti
    unmatched semantics S-fold."""
    if "join" not in getattr(ctx, "skew_modes", frozenset()):
        return None
    for p in getattr(node, "skew_plans", None) or []:
        if p.target_side == probe_side:
            orientation = "probe"
        elif node.kind == "inner":
            orientation = "build"
        else:
            continue
        if not recheck(p, ctx):
            ctx.trace.append(
                f"skew-deactivated join {p.table}.{p.column} (stats drift)")
            from galaxysql_tpu_torch.utils import events
            events.publish("skew_deactivate",
                           f"hybrid join {p.table}.{p.column}: stats drift",
                           dedupe=f"skew-off:join:{p.table}.{p.column}",
                           table=p.table, column=p.column, op="join")
            continue
        values = _hot_values(p.candidates, S)
        if values:
            from galaxysql_tpu_torch.utils import events
            # per-execution publisher: the counter counts every activation,
            # the ring keeps one event per join site (dedupe) so a steady
            # skewed workload cannot evict rare fault/regression events
            events.publish("skew_activate",
                           f"hybrid join {p.table}.{p.column}: "
                           f"{len(values)} hot keys ({orientation})",
                           dedupe=f"skew:join:{p.table}.{p.column}:"
                                  f"{orientation}",
                           table=p.table, column=p.column, op="join",
                           orientation=orientation, hot_keys=len(values))
            return ActiveJoinSkew(p, values, orientation)
    return None


def active_salt(node, ctx, S: int) -> Optional[int]:
    """The salt fan-out factor for a planted aggregate, or None.  The factor
    scales with how far the hottest key overshoots the fair per-shard share,
    clamped to a small power of two (the merge stage pays factor x groups)."""
    if "agg" not in getattr(ctx, "skew_modes", frozenset()):
        return None
    p = getattr(node, "salt_plan", None)
    if p is None:
        return None
    if not recheck(p, ctx):
        ctx.trace.append(
            f"skew-deactivated agg {p.table}.{p.column} (stats drift)")
        from galaxysql_tpu_torch.utils import events
        events.publish("skew_deactivate",
                       f"salted agg {p.table}.{p.column}: stats drift",
                       dedupe=f"skew-off:agg:{p.table}.{p.column}",
                       table=p.table, column=p.column, op="agg")
        return None
    values = _hot_values(p.candidates, S, AGG_HOT_RATIO)
    if not values:
        return None
    fmax = max(f for v, f in p.candidates if v in set(values))
    factor = 1
    while factor < fmax * S and factor < SALT_MAX_FACTOR:
        factor *= 2
    factor = max(factor, SALT_MIN_FACTOR)
    from galaxysql_tpu_torch.utils import events
    events.publish("skew_activate",
                   f"salted agg {p.table}.{p.column}: factor {factor}",
                   dedupe=f"skew:agg:{p.table}.{p.column}:{factor}",
                   table=p.table, column=p.column, op="agg", factor=factor)
    return factor


# -- fragment-cache fingerprints ----------------------------------------------


def node_signature(node, ctx) -> Optional[Tuple]:
    """The skew identity a fragment fingerprint must absorb for this node:
    the planted hot-key candidates / salt plan AND whether this execution may
    activate them.  A re-ANALYZE that shifts the hot-key set changes the
    candidates, so cached MPP twins keyed over the old set become
    unreachable; toggling skew execution separates the cached shapes too."""
    modes = getattr(ctx, "skew_modes", frozenset())
    plans = getattr(node, "skew_plans", None) or []
    jsig = tuple(p.signature() for p in plans) \
        if plans and "join" in modes else ()
    sp = getattr(node, "salt_plan", None)
    asig = sp.signature() if sp is not None and "agg" in modes else None
    if not jsig and asig is None:
        return None
    return ("skew", jsig, asig)


# -- observability ------------------------------------------------------------


def note(ctx, node, **info):
    """Record a skew decision for EXPLAIN ANALYZE (`HotKeys(n, broadcast)` /
    `Salted(f)` annotations) and the stage span attributes."""
    stats = getattr(ctx, "skew_stats", None)
    if stats is not None:
        stats[id(node)] = dict(info)


def explain_line(info) -> str:
    if info.get("kind") == "agg":
        return f"Salted({info['factor']})"
    return f"HotKeys({info['hot']}, broadcast)"
