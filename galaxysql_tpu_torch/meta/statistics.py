"""Column statistics: equi-depth histograms + HLL NDV + heavy-hitter sketches.

Reference analog: `polardbx-optimizer/.../config/table/statistic/Histogram.java`
(equi-depth buckets driving range selectivity) and `executor/statistic/ndv/*`
(HLL sketches, mergeable per-shard so ANALYZE can union partition sketches
without a global distinct pass).  `_selectivity` in plan/rules.py consults
these instead of hard-coded guesses, so skewed data can flip the join order.

`HeavyHitterSketch` (Space-Saving / batched Misra-Gries) tracks the frequent
lane values of each column: ANALYZE builds one per column alongside the
HLL/histogram, and hash-join build sides refresh a runtime twin as they
materialize key columns (exec/operators.HashJoinOp) — the skew-aware planner
(plan/rules.plan_skew + exec/skew.py) reads both to decide hybrid
broadcast/shuffle joins and salted aggregation.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * _M1
    h = h ^ (h >> np.uint64(33))
    h = h * _M2
    return h ^ (h >> np.uint64(33))


class NdvSketch:
    """HyperLogLog with 2^P registers (mergeable; ~1.6% error at P=12)."""

    P = 12
    M = 1 << P

    def __init__(self, registers: Optional[np.ndarray] = None):
        self.registers = registers if registers is not None \
            else np.zeros(self.M, dtype=np.uint8)

    def add_array(self, values: np.ndarray):
        if values.size == 0:
            return
        if values.dtype.kind == "f":
            v = values[~np.isnan(values)]
            h = _mix64(v.astype(np.float64).view(np.uint64))
        else:
            h = _mix64(values.astype(np.int64).astype(np.uint64))
        idx = (h >> np.uint64(64 - self.P)).astype(np.int64)
        rest = h << np.uint64(self.P)
        # rank = leading zeros of the remaining 64-P bits, +1 (cap at 64-P+1)
        lz = np.full(h.shape, 64 - self.P + 1, dtype=np.uint8)
        found = np.zeros(h.shape, dtype=bool)
        for bit in range(64 - self.P):
            is_set = ~found & (((rest >> np.uint64(63 - bit)) &
                                np.uint64(1)) == 1)
            lz[is_set] = bit + 1
            found |= is_set
        np.maximum.at(self.registers, idx, lz)

    def merge(self, other: "NdvSketch") -> "NdvSketch":
        return NdvSketch(np.maximum(self.registers, other.registers))

    def estimate(self) -> int:
        m = float(self.M)
        alpha = 0.7213 / (1 + 1.079 / m)
        inv = np.power(2.0, -self.registers.astype(np.float64))
        e = alpha * m * m / inv.sum()
        zeros = int((self.registers == 0).sum())
        if e <= 2.5 * m and zeros:
            e = m * np.log(m / zeros)  # small-range correction
        return max(int(round(e)), 1)

    def to_json(self) -> str:
        return base64.b64encode(self.registers.tobytes()).decode()

    @classmethod
    def from_json(cls, s: str) -> "NdvSketch":
        return cls(np.frombuffer(base64.b64decode(s), dtype=np.uint8).copy())


class HeavyHitterSketch:
    """Frequent-item sketch over lane values (Space-Saving / batched
    Misra-Gries).  At most K counters; after folding a batch in, the
    (K+1)-th largest count is subtracted from every counter and non-positive
    counters drop — the classic MG guarantee survives batching: any value
    with true frequency above total/K is retained, and a retained counter
    under-estimates its true count by at most total/K.

    Mergeable (counter-wise sum + one prune) so ANALYZE unions per-partition
    sketches, and cheap to refresh from hash-join build sides at runtime:
    `add_array` is one np.unique over an already-host-resident lane.  Values
    are stored in LANE domain (dictionary codes for strings, scaled ints for
    decimals, day numbers for dates) — the same domain join-key hashing and
    repartitioning operate in."""

    K = 64

    def __init__(self, counts: Optional[Dict[Any, int]] = None,
                 total: int = 0):
        self.counts: Dict[Any, int] = counts if counts is not None else {}
        self.total = int(total)

    def add_array(self, values: np.ndarray):
        if values.size == 0:
            return
        if values.dtype.kind == "f":
            values = values[~np.isnan(values)]
            if values.size == 0:
                return
        vals, cnts = np.unique(values, return_counts=True)
        self.total += int(values.size)
        counts = self.counts
        if vals.size > 32 * self.K:
            # high-NDV batch: only its top counts (plus already-tracked
            # values) can survive the MG prune — fold just those instead of
            # paying a Python dict op per distinct value (measured ~150ms
            # for a 600k-distinct lane; this is on the hash-join hot path).
            # A value frequent in the STREAM is frequent in the batch, so
            # the retained-candidate guarantee is preserved; dropped tail
            # values only deepen the (already bounded) undercount.
            top = np.argpartition(cnts, -32 * self.K)[-32 * self.K:]
            keep = np.zeros(vals.size, dtype=np.bool_)
            keep[top] = True
            if counts:
                keep |= np.isin(vals, np.asarray(list(counts),
                                                 dtype=vals.dtype))
            vals, cnts = vals[keep], cnts[keep]
        for v, c in zip(vals.tolist(), cnts.tolist()):
            counts[v] = counts.get(v, 0) + int(c)
        self._prune()

    def merge(self, other: "HeavyHitterSketch") -> "HeavyHitterSketch":
        out = dict(self.counts)
        for v, c in other.counts.items():
            out[v] = out.get(v, 0) + c
        m = HeavyHitterSketch(out, self.total + other.total)
        m._prune()
        return m

    def _prune(self):
        if len(self.counts) <= self.K:
            return
        ordered = sorted(self.counts.values(), reverse=True)
        cut = ordered[self.K]  # (K+1)-th largest count
        self.counts = {v: c - cut for v, c in self.counts.items() if c > cut}

    def candidates(self, min_frac: float) -> List[Tuple[Any, float]]:
        """(value, estimated frequency) for every retained counter at or above
        `min_frac` of the observed total, most frequent first."""
        if self.total <= 0:
            return []
        out = [(v, c / self.total) for v, c in self.counts.items()
               if c / self.total >= min_frac]
        out.sort(key=lambda x: (-x[1], repr(x[0])))
        return out

    def to_json(self) -> dict:
        # lane values are numeric scalars (codes/ints/floats): json-native
        return {"counts": [[v, c] for v, c in self.counts.items()],
                "total": self.total}

    @classmethod
    def from_json(cls, d: dict) -> "HeavyHitterSketch":
        return cls({v: int(c) for v, c in d.get("counts", [])},
                   int(d.get("total", 0)))


class Histogram:
    """Equi-depth histogram over numeric lane values (Histogram.java analog)."""

    BUCKETS = 64

    def __init__(self, bounds: np.ndarray, total: int, ndv: int):
        self.bounds = bounds          # [B+1] ascending bucket edges
        self.total = total
        self.ndv = max(ndv, 1)

    @classmethod
    def build(cls, values: np.ndarray, ndv: int) -> Optional["Histogram"]:
        if values.size == 0:
            return None
        if values.dtype.kind == "f":
            values = values[~np.isnan(values)]
            if values.size == 0:
                return None
        b = min(cls.BUCKETS, values.size)
        qs = np.linspace(0.0, 1.0, b + 1)
        bounds = np.quantile(values.astype(np.float64), qs)
        return cls(bounds, int(values.size), ndv)

    def frac_le(self, v: float) -> float:
        """P(col <= v) by linear interpolation inside the covering bucket."""
        bounds = self.bounds
        if v < bounds[0]:
            return 0.0
        if v >= bounds[-1]:
            return 1.0
        i = int(np.searchsorted(bounds, v, side="right")) - 1
        lo, hi = bounds[i], bounds[i + 1]
        within = 0.0 if hi <= lo else (v - lo) / (hi - lo)
        b = len(bounds) - 1
        return (i + within) / b

    def frac_eq(self, v: float) -> float:
        """P(col == v): bounded by the covering bucket's mass and 1/ndv."""
        if v < self.bounds[0] or v > self.bounds[-1]:
            return 0.0
        return min(1.0 / self.ndv, 1.0)

    def frac_range(self, lo: Optional[float], hi: Optional[float],
                   lo_inc: bool = True, hi_inc: bool = True) -> float:
        a = 0.0 if lo is None else self.frac_le(lo) - \
            (self.frac_eq(lo) if lo_inc else 0.0)
        b = 1.0 if hi is None else self.frac_le(hi) + \
            (self.frac_eq(hi) if hi_inc and hi >= self.bounds[-1] else 0.0)
        return float(np.clip(b - a, 0.0, 1.0))

    def to_json(self) -> dict:
        return {"bounds": self.bounds.tolist(), "total": self.total,
                "ndv": self.ndv}

    @classmethod
    def from_json(cls, d: dict) -> "Histogram":
        return cls(np.asarray(d["bounds"], dtype=np.float64), d["total"],
                   d["ndv"])


def analyze_store(tm, store, sample_cap: int = 262144):
    """ANALYZE: per-partition HLL sketches merged + equi-depth histograms.

    Numeric/date/decimal columns get histograms over lane values; every column
    gets an HLL NDV (string columns sketch dictionary codes).  Results land on
    tm.stats (ndv / min_max kept for compatibility; histograms/sketches in the
    new fields)."""
    tm.stats.row_count = store.row_count()
    per_part = max(sample_cap // max(len(store.partitions), 1), 4096)
    for c in tm.columns:
        sk = NdvSketch()
        hh = HeavyHitterSketch()
        samples: List[np.ndarray] = []
        col_min = col_max = None
        for p in store.partitions:
            lane = p.lanes[c.name][:p.num_rows]
            valid = p.valid[c.name][:p.num_rows]
            vals = lane[valid] if not bool(valid.all()) else lane
            if vals.size == 0:
                continue
            sk.add_array(vals)  # per-partition sketch; np.maximum.at merges
            hh.add_array(vals)  # frequent items fold across partitions too
            if vals.size > per_part:
                # strided sample: a leading-prefix slice of insertion-ordered
                # data (e.g. monotone timestamps) sees only the oldest rows and
                # skews every bucket; a stride covers the whole value range
                stride = (vals.size + per_part - 1) // per_part
                samples.append(vals[::stride][:per_part])
            else:
                samples.append(vals)
            if not c.dtype.is_string:
                lo, hi = vals.min().item(), vals.max().item()
                col_min = lo if col_min is None else min(col_min, lo)
                col_max = hi if col_max is None else max(col_max, hi)
        vals = np.concatenate(samples) if samples else np.zeros(0)
        ndv = sk.estimate() if vals.size else 0
        # small columns: exact beats the sketch's floor error
        if 0 < vals.size <= 65536:
            ndv = int(len(np.unique(vals)))
        tm.stats.ndv[c.name] = ndv
        tm.stats.sketches[c.name] = sk
        tm.stats.heavy[c.name] = hh
        # ANALYZE resets the runtime refresh: fresh full-table truth wins
        tm.stats.heavy_rt.pop(c.name, None)
        if vals.size and not c.dtype.is_string:
            # min/max over the FULL valid lanes, not the sample
            tm.stats.min_max[c.name] = (col_min, col_max)
            tm.stats.histograms[c.name] = Histogram.build(vals, ndv)


# stats-drift repair tolerance: a table whose live row count is within this
# factor of its ANALYZE-time row count is considered healthy (no repair)
STATS_DRIFT_TOLERANCE = 1.5


def analyzed_rows(tm) -> int:
    """Rows the last ANALYZE folded into this table's sketches (0 = never
    analyzed).  `stats.row_count` tracks inserts/deletes live, but the
    NDV/histogram/heavy-hitter sketches only move on ANALYZE — the gap
    between the two IS the statistics drift."""
    return max((hh.total for hh in tm.stats.heavy.values()), default=0)


def repair_table_stats(tm, store, observed_rows: Optional[int] = None,
                       tolerance: float = STATS_DRIFT_TOLERANCE
                       ) -> Optional[dict]:
    """Targeted stats-drift repair, driven by runtime truth instead of a DBA.

    The self-heal loop (plan/spm.py + meta/statement_summary.py) calls this
    when a digest regresses under the SAME plan fingerprint — no alternative
    plan exists, so the plan is innocent and the statistics that justified it
    have drifted.  Evidence of drift: the live store row count (host-resident,
    O(partitions)) and any observed operator cardinality from profiled
    QueryProfile rings, compared against the row count the last ANALYZE
    actually sketched (`analyzed_rows`).  Beyond `tolerance`, the table's
    statistics are rebuilt in place (the same per-partition sketch fold
    ANALYZE runs, scoped to just this table) so NDVs, histograms, and
    heavy-hitter sets match reality again.

    Returns a delta dict when a repair ran, None when stats were within
    tolerance (the common case — repair must be idempotent-cheap)."""
    seen = float(analyzed_rows(tm))
    truth = float(store.row_count())
    if observed_rows:
        # a profiled scan that materialized more rows than the store reports
        # (e.g. mid-ingest) is still evidence of drift
        truth = max(truth, float(observed_rows))
    if truth <= 0 and seen <= 0:
        return None  # empty and never analyzed: nothing to repair
    if seen > 0 and truth > 0 and \
            (1.0 / tolerance) <= truth / seen <= tolerance:
        return None
    analyze_store(tm, store)
    return {"table": f"{tm.schema}.{tm.name}",
            "analyzed_rows_before": int(seen),
            "analyzed_rows_after": int(analyzed_rows(tm)),
            "observed_rows": int(observed_rows or 0)}


# minimum live build rows before a runtime observation is worth folding in: a
# tiny (or heavily filtered) build side says nothing about column skew
RUNTIME_HH_MIN_ROWS = 4096


def observe_build_keys(tm, column: str, values: np.ndarray):
    """Runtime heavy-hitter refresh from a materialized hash-join build side.

    The build pass already holds the key lane on the host (exec/operators.py
    CSR construction — no extra device sync), so folding it into a sketch is
    one np.unique.  Observations land in `tm.stats.heavy_rt` — a runtime twin
    of the ANALYZE sketch, NOT the sketch itself: build sides are filtered
    subsets, so their frequencies refresh the drift re-check
    (exec/skew.recheck) without rewriting the planner's full-table truth.
    ANALYZE clears the twin."""
    if values.size < RUNTIME_HH_MIN_ROWS:
        return
    hh = tm.stats.heavy_rt.get(column)
    if hh is None:
        hh = tm.stats.heavy_rt[column] = HeavyHitterSketch()
    hh.add_array(values)
