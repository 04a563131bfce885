"""Statement-digest summary store: workload insight across queries and time.

Reference analog: the CN's `statement_summary` / Top-SQL layer (SURVEY.md §L2
manager surfaces) — every finished query is normalized to a **statement
digest** and aggregated per digest x plan fingerprint into time-bucketed
sliding windows, so "which statements run, under which plans, and how has
each been behaving lately" is answerable without tracing anything.

Digesting is ~free on the hot path: the digest KEY is the parameterized SQL
text `sql/parameterize.parameterize` already memoizes for the plan cache, so
the summary layer pays one dict probe plus host-side integer adds under one
lock.  The printable digest (a short hash of schema+text) is minted once per
entry, never per execution.  Nothing here may touch device state.

Two consumers ride the store:

- the **plan-regression sentinel**: when a known digest starts executing
  under a new plan fingerprint (or the same plan drifts) and its windowed
  latency degrades beyond `PLAN_REGRESSION_FACTOR` x the digest's frozen
  baseline, it publishes a typed `plan_regression` event
  (utils/events.py), bumps the `plan_regressions` counter, and annotates
  the SPM `PlanRecord` (plan/spm.py) so baselines can be audited;
- the Prometheus top-K exporter (server/web.py): per-digest latency
  summaries with a bounded-cardinality `digest` label.

Round 10 closes the loop the sentinel opened — the store now ACTS on what it
sees (self-healing plan management, ROADMAP item 1a/1b):

- a regression under a **new plan fingerprint** opens a quarantine episode on
  the SPM baseline (`PlanManager.begin_quarantine`): the digest's plan-cache
  entry is retired, the next bind re-plans pinned to the frozen known-good
  join orders (rollback), and the next `PLAN_HEAL_VERIFY_EXECS` executions
  are judged against the frozen latency baseline — promote (HEALED) or, when
  the old plan is slow now too, keep the new plan and re-freeze the baseline
  on it (EVOLVED);
- a regression under the **same fingerprint** (pure stats drift — no
  alternative plan) triggers a targeted statistics repair
  (`meta/statistics.repair_table_stats`: live store row counts + observed
  scan cardinalities from profiled QueryProfile rings correct the drifted
  row counts/NDVs/histograms), then re-enters verification unpinned so the
  corrected stats can pick a better order; still slow => HEAL_FAILED, parked
  until ANALYZE/DDL re-arms it;
- flap damping is breaker-style (per-digest cooldown + max episodes) and the
  whole state machine persists in the metadb, so a coordinator restart
  resumes probation rather than re-thrashing.

Escape hatches: `ENABLE_STATEMENT_SUMMARY` param (SET-able) and the
`GALAXYSQL_STMT_SUMMARY=0` environment kill switch; the heal loop has its own
pair — `ENABLE_PLAN_AUTOHEAL` and `GALAXYSQL_PLAN_AUTOHEAL=0` — which restore
the detect-only (annotate, never act) behavior."""

from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple
from zlib import crc32

from galaxysql_tpu_torch.utils.metrics import Histogram

# kill switch: GALAXYSQL_STMT_SUMMARY=0 disables recording entirely (surfaces
# stay queryable, just empty) — read once at import like the other hatches
ENABLED = os.environ.get("GALAXYSQL_STMT_SUMMARY", "1") != "0"

# kill switch for the self-heal loop only: detection/annotation stays live,
# the engine just never acts (the PR-9 detect-only behavior)
AUTOHEAL_ENABLED = os.environ.get("GALAXYSQL_PLAN_AUTOHEAL", "1") != "0"


# -- digests -------------------------------------------------------------------

_DIGEST_CACHE: Dict[Tuple[str, str], str] = {}
_DIGEST_CACHE_CAP = 8192


def digest_key(schema: str, ptext: str) -> str:
    """Printable 16-hex digest of (schema, parameterized SQL).  Memoized by
    the same epoch-reset discipline as the parameterize cache: OLTP traffic
    repeats statements, so the hash runs once per distinct text."""
    k = (schema, ptext)
    hit = _DIGEST_CACHE.get(k)
    if hit is not None:
        return hit
    d = hashlib.blake2b(f"{schema}\x00{ptext}".encode(),
                        digest_size=8).hexdigest()
    if len(_DIGEST_CACHE) >= _DIGEST_CACHE_CAP:
        _DIGEST_CACHE.clear()
    _DIGEST_CACHE[k] = d
    return d


def encode_orders(join_orders) -> str:
    """Join-order text carried per _PlanAgg: forests joined by ';', labels
    within a forest by '>'.  `parse_orders` is the exact inverse.  Labels
    are lowercased dotted identifiers ('schema.table') or 'rel:'-prefixed
    field-id digests (','-separated) — neither contains the separators, the
    invariant both helpers rely on."""
    return ";".join(">".join(o) for o in (join_orders or []))


def parse_orders(orders: str):
    """Inverse of encode_orders: [(label, ...)] per forest, or None."""
    if not orders:
        return None
    return [tuple(seg.split(">")) for seg in orders.split(";") if seg]


def plan_fingerprint(plan) -> str:
    """Stable fingerprint of the one high-blast-radius physical identity this
    engine has — the join order (the SPM plan identity; every other physical
    choice is deterministic given the join tree).  Joinless plans share the
    'scan' fingerprint; the point fast path records as 'point'."""
    orders = getattr(plan, "join_orders", None)
    if not orders:
        return "scan"
    return f"j{crc32(repr(sorted(orders)).encode()) & 0xFFFFFFFF:08x}"


# -- per-query counter attribution --------------------------------------------
#
# The engine's compile/cache/filter/retry truth lives in process counters
# (COMPILE_STATS, RF_STATS, frag cache hits, RPC_RETRIES, skew events).
# Bracketing a query with two host-side snapshot reads attributes their
# deltas to the digest.  Under concurrency the deltas are approximate
# (concurrent queries' work can cross-attribute) — fine for aggregate
# insight, and the price is six dict/attr reads, no locks, no syncs.

def counters_snapshot(instance) -> tuple:
    from galaxysql_tpu_torch.exec.operators import COMPILE_STATS
    from galaxysql_tpu_torch.exec.runtime_filter import RF_STATS
    from galaxysql_tpu_torch.utils.events import EVENTS
    from galaxysql_tpu_torch.utils.metrics import RPC_RETRIES, SPILL_BYTES
    fc = getattr(instance, "frag_cache", None)
    return (COMPILE_STATS["retraces"],
            fc.hits if fc is not None else 0,
            RF_STATS["rows_pruned"],
            EVENTS._counts.get("skew_activate", 0),  # GIL-atomic dict read
            RPC_RETRIES.value,
            SPILL_BYTES.value)


def counters_delta(base: Optional[tuple], instance) -> Optional[dict]:
    if base is None:
        return None
    now = counters_snapshot(instance)
    return {"retraces": now[0] - base[0], "frag_hits": now[1] - base[1],
            "rf_rows_pruned": now[2] - base[2],
            "skew_activations": now[3] - base[3],
            "rpc_retries": now[4] - base[4],
            # spill attribution: a regressed digest whose windows show spill
            # bytes explains ITSELF (memory pressure, not a plan change)
            "spill_bytes": (now[5] - base[5]) if len(base) > 5 else 0}


# -- aggregation structures ----------------------------------------------------

_EXTRA_KEYS = ("retraces", "frag_hits", "rf_rows_pruned", "skew_activations",
               "rpc_retries", "spill_bytes")


class _Bucket:
    """One time window of one digest x plan (host-side adds only)."""

    __slots__ = ("start", "execs", "errors", "sum_ms", "min_ms", "max_ms",
                 "rows_returned", "rows_examined", "peak_rss_kb", "extras",
                 "lat")

    def __init__(self, start: float):
        self.start = start
        self.execs = 0
        self.errors = 0
        self.sum_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0
        self.rows_returned = 0
        self.rows_examined = 0
        self.peak_rss_kb = 0
        self.extras = dict.fromkeys(_EXTRA_KEYS, 0)
        # bounded latency reservoir: the sentinel judges the window's MEDIAN
        # — a mean would let one compile-heavy retrace fake a regression (or
        # one cached replay hide a real one)
        self.lat = Histogram("w", reservoir=64)

    @property
    def avg_ms(self) -> float:
        return self.sum_ms / self.execs if self.execs else 0.0


class _PlanAgg:
    """Lifetime + windowed stats of one digest x plan fingerprint."""

    __slots__ = ("fp", "orders", "engines", "workloads", "first_seen",
                 "last_seen", "execs", "errors", "total_ms", "latency",
                 "buckets", "flagged", "flagged_at", "rows_returned",
                 "rows_examined", "peak_rss_kb", "extras")

    def __init__(self, fp: str, orders: str, history: int):
        self.fp = fp
        self.orders = orders          # json-ish join-order text ("" joinless)
        self.engines: set = set()
        self.workloads: set = set()   # TP | AP seen under this plan
        self.first_seen = 0.0
        self.last_seen = 0.0
        self.execs = 0
        self.errors = 0
        self.total_ms = 0.0
        self.latency = Histogram(f"stmt_{fp}", reservoir=256)
        self.buckets: collections.deque = collections.deque(maxlen=history)
        self.flagged = False          # sentinel: currently regressed
        self.flagged_at = 0.0         # when the current episode was flagged
        # lifetime totals (the summary row): buckets roll off the bounded
        # history deque, so summing them would silently undercount
        self.rows_returned = 0
        self.rows_examined = 0
        self.peak_rss_kb = 0
        self.extras = dict.fromkeys(_EXTRA_KEYS, 0)

    def bucket(self, now: float, window_s: float) -> _Bucket:
        start = now - (now % window_s)
        if not self.buckets or self.buckets[-1].start != start:
            self.buckets.append(_Bucket(start))
        return self.buckets[-1]


class _Entry:
    """One statement digest: plans seen + the sentinel's frozen baseline."""

    __slots__ = ("schema", "ptext", "digest", "sample_sql", "first_seen",
                 "last_seen", "plans", "baseline_fp", "baseline_ms",
                 "baseline_samples")

    def __init__(self, schema: str, ptext: str, sample_sql: str):
        self.schema = schema
        self.ptext = ptext
        self.digest = digest_key(schema, ptext)
        self.sample_sql = sample_sql[:512]
        self.first_seen = 0.0
        self.last_seen = 0.0
        self.plans: Dict[str, _PlanAgg] = {}
        # baseline: MEDIAN of the FIRST plan's first `min_execs` successful
        # runs, frozen once established — the yardstick the sentinel judges
        # later windows (any plan) against.  Median, not mean: the first
        # execution usually pays the compile.
        self.baseline_fp: Optional[str] = None
        self.baseline_ms: Optional[float] = None
        self.baseline_samples: List[float] = []


class _ClassRoll:
    """Per-(schema, workload-class) rollup for SLO scoping: cumulative
    exec/error counts (the history ring turns them into rates) plus a
    small ring of recent successful latencies for a recent-window p99.
    The 128-observation window is count-bounded, not time-bounded, so
    burn/recover tests are deterministic: 128 good queries fully flush
    an injected-latency storm out of the window."""

    __slots__ = ("execs", "errors", "recent")

    def __init__(self):
        self.execs = 0
        self.errors = 0
        self.recent: "collections.deque" = collections.deque(maxlen=128)

    def recent_p99(self) -> float:
        if not self.recent:
            return 0.0
        vals = sorted(self.recent)
        return vals[int(0.99 * (len(vals) - 1))]


class StatementSummaryStore:
    """Per-Instance digest x plan x window aggregator + regression sentinel.

    One plain lock guards everything: updates are a handful of float adds
    (the concurrency suite proves multi-session totals exact), and readers
    materialize row snapshots under the same lock."""

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        # (schema, ptext) -> _Entry, LRU by last update for digest eviction
        self._entries: "collections.OrderedDict[Tuple[str, str], _Entry]" = \
            collections.OrderedDict()
        # ("" | schema, workload-class) -> _ClassRoll: the SLO plane's
        # per-tenant scoping signal, tagged with the digest's schema at
        # record time; ("", wl) aggregates across all schemas
        self._class_roll: Dict[Tuple[str, str], _ClassRoll] = {}
        self._regressions = instance.metrics.counter(
            "plan_regressions",
            "digests whose windowed latency regressed vs their plan baseline")
        self.recorded = instance.metrics.counter(
            "stmt_summary_recorded", "queries aggregated into the summary")
        # self-heal loop outcome counters (Prometheus + SHOW METRICS)
        self.heals = instance.metrics.counter(
            "plan_heals",
            "heal episodes that promoted a verified plan (rollback healed "
            "or new plan evolved)")
        self.heal_failures = instance.metrics.counter(
            "plan_heal_failures",
            "heal episodes parked in HEAL_FAILED (verification missed the "
            "baseline, flap damping, or an internal heal error)")

    # -- config (read per call: SET-able hatches must apply live) ----------

    def on(self, session_vars: Optional[dict] = None) -> bool:
        return ENABLED and bool(self.instance.config.get(
            "ENABLE_STATEMENT_SUMMARY", session_vars))

    def _cfg(self, name: str, default):
        v = self.instance.config.get(name)
        return default if v is None else v

    # -- recording ----------------------------------------------------------

    def record(self, schema: str, ptext: str, raw_sql: str, plan_fp: str,
               orders: str, workload: str, engine: str, elapsed_ms: float,
               rows: int, rows_examined: int = 0, error: bool = False,
               peak_rss_kb: int = 0, extras: Optional[dict] = None,
               now: Optional[float] = None):
        """Aggregate one finished query (success or failure).  Host-side
        adds under the store lock; the sentinel check rides the same hold."""
        now = time.time() if now is None else now
        window_s = float(self._cfg("STMT_SUMMARY_WINDOW_S", 60))
        history = int(self._cfg("STMT_SUMMARY_HISTORY", 16))
        max_digests = int(self._cfg("STMT_SUMMARY_MAX_DIGESTS", 512))
        key = (schema.lower(), ptext)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = _Entry(schema.lower(), ptext, raw_sql or ptext)
                e.first_seen = now
                self._entries[key] = e
                while len(self._entries) > max_digests:
                    self._entries.popitem(last=False)  # LRU digest eviction
            else:
                self._entries.move_to_end(key)
            e.last_seen = now
            agg = e.plans.get(plan_fp)
            if agg is None:
                agg = _PlanAgg(plan_fp, orders, history)
                agg.first_seen = now
                e.plans[plan_fp] = agg
                if len(e.plans) > 16:
                    # plan-churn bound: a digest replanned under many
                    # fingerprints keeps only the 16 most recently seen
                    # (the baseline yardstick lives on the entry, not here)
                    stale = min((a for a in e.plans.values()
                                 if a is not agg), key=lambda a: a.last_seen)
                    del e.plans[stale.fp]
            agg.last_seen = now
            agg.engines.add(engine)
            if workload:
                agg.workloads.add(workload)
            agg.execs += 1
            b = agg.bucket(now, window_s)
            b.execs += 1
            if error:
                agg.errors += 1
                b.errors += 1
            else:
                agg.total_ms += elapsed_ms
                agg.latency.observe(elapsed_ms)
                b.sum_ms += elapsed_ms
                b.min_ms = min(b.min_ms, elapsed_ms)
                b.max_ms = max(b.max_ms, elapsed_ms)
                b.lat.observe(elapsed_ms)
            b.rows_returned += rows
            agg.rows_returned += rows
            b.rows_examined += rows_examined
            agg.rows_examined += rows_examined
            if peak_rss_kb:
                b.peak_rss_kb = max(b.peak_rss_kb, peak_rss_kb)
                agg.peak_rss_kb = max(agg.peak_rss_kb, peak_rss_kb)
            if extras:
                bx, ax = b.extras, agg.extras
                for k in _EXTRA_KEYS:
                    v = extras.get(k, 0)
                    if v > 0:  # concurrent-delta noise must not go negative
                        bx[k] += v
                        ax[k] += v
            self.recorded.inc()
            wl = (workload or "TP").upper()
            for rkey in (("", wl), (schema.lower(), wl)):
                roll = self._class_roll.get(rkey)
                if roll is None:
                    if rkey[0] and len(self._class_roll) >= 512:
                        continue  # tenant-cardinality bound; globals always fit
                    roll = self._class_roll[rkey] = _ClassRoll()
                roll.execs += 1
                if error:
                    roll.errors += 1
                else:
                    roll.recent.append(elapsed_ms)
            flagged = self._sentinel(e, agg, b, elapsed_ms, now) \
                if not error else None
        if flagged is not None:
            # event publish + SPM annotation (a metadb write) happen OUTSIDE
            # the store lock: every query's exit ramp contends on it, and a
            # slow persist must not stall concurrent sessions
            self._flag(e, agg, flagged)

    def class_stats_rows(self) -> List[Tuple[str, str, float]]:
        """(name, kind, value) rows the metric-history sampler folds into
        each snapshot (prefixed `stmt_`): per-class and per-tenant
        cumulative execs/errors plus the recent-window p99 the SLO
        burn-rate windows judge.  `class_<wl>_*` aggregates all schemas;
        `tenant_<schema>_<wl>_*` is the per-tenant cut."""
        out: List[Tuple[str, str, float]] = []
        with self._lock:
            for (schema, wl), roll in self._class_roll.items():
                base = (f"tenant_{schema}_{wl.lower()}" if schema
                        else f"class_{wl.lower()}")
                out.append((f"{base}_execs", "counter", float(roll.execs)))
                out.append((f"{base}_errors", "counter", float(roll.errors)))
                out.append((f"{base}_recent_p99_ms", "gauge",
                            float(roll.recent_p99())))
        return out

    # -- plan-regression sentinel -------------------------------------------

    def _sentinel(self, e: _Entry, agg: _PlanAgg, b: _Bucket,
                  elapsed_ms: float, now: float) -> Optional[float]:
        """Judge this window under the store lock; returns the regressed
        window median when a NEW regression episode just started (the caller
        publishes after releasing the lock), else None."""
        min_execs = int(self._cfg("PLAN_REGRESSION_MIN_EXECS", 5))
        factor = float(self._cfg("PLAN_REGRESSION_FACTOR", 1.5))
        if e.baseline_ms is None:
            # baseline forms from the digest's FIRST plan only: a digest
            # born under two plans has no stable yardstick yet
            if e.baseline_fp is None:
                e.baseline_fp = agg.fp
            if agg.fp == e.baseline_fp:
                e.baseline_samples.append(elapsed_ms)
                if len(e.baseline_samples) >= min_execs:
                    s = sorted(e.baseline_samples)
                    e.baseline_ms = s[len(s) // 2]
                    e.baseline_samples = []
            return None
        good = b.execs - b.errors
        if good < min_execs or e.baseline_ms <= 0:
            return None
        cur = b.lat.quantile(0.5)
        if cur > factor * e.baseline_ms:
            if not agg.flagged:
                agg.flagged = True
                agg.flagged_at = now
                return cur  # new episode: caller publishes outside the lock
            # SUSTAINED regression: the latched flag would otherwise pin a
            # continuously slow digest in detect-only forever once one heal
            # attempt was swallowed by the episode cooldown — re-fire once
            # per cooldown period so the heal loop gets its retry (and the
            # journal gets a still-regressed heartbeat).  Detect-only mode
            # keeps the PR-9 one-event-per-episode semantics.
            if self.autoheal_on():
                cooldown = float(self._cfg("PLAN_HEAL_COOLDOWN_S", 300))
                if now - agg.flagged_at >= cooldown > 0:
                    agg.flagged_at = now
                    return cur
        else:
            agg.flagged = False  # window recovered: re-arm the sentinel
        return None

    def _flag(self, e: _Entry, agg: _PlanAgg, cur_ms: float):
        from galaxysql_tpu_torch.utils import events
        reason = "new_plan" if agg.fp != e.baseline_fp else "plan_drift"
        inst = self.instance
        self._regressions.inc()
        events.publish(
            "plan_regression",
            f"digest {e.digest} plan {agg.fp}: window {cur_ms:.1f}ms vs "
            f"baseline {e.baseline_ms:.1f}ms ({reason})",
            node=inst.node_id, digest=e.digest, plan=agg.fp, reason=reason,
            schema=e.schema, window_ms=round(cur_ms, 2),
            baseline_ms=round(e.baseline_ms, 2),
            baseline_plan=e.baseline_fp)
        # annotate the SPM record so BASELINE audits see the runtime verdict
        # (returns False when this key never captured a baseline — hinted or
        # uncached plans — which needs no handling here)
        inst.planner.spm.note_regression(
            (e.schema, e.ptext),
            f"{reason}: plan {agg.fp} {cur_ms:.1f}ms vs baseline "
            f"{e.baseline_fp} {e.baseline_ms:.1f}ms")
        # act on it: the self-heal loop (quarantine + rollback/stats repair).
        # A heal bug must never fail the user query riding this exit ramp.
        if self.autoheal_on():
            try:
                self._autoheal(e, agg, cur_ms, reason)
            except Exception as exc:  # pragma: no cover - defensive
                self.heal_failures.inc()
                events.publish(
                    "plan_heal_failed",
                    f"digest {e.digest}: heal loop error {exc!r}",
                    node=inst.node_id, digest=e.digest,
                    reason="internal_error")

    # -- self-heal loop ------------------------------------------------------

    def autoheal_on(self, session_vars: Optional[dict] = None) -> bool:
        return AUTOHEAL_ENABLED and bool(self.instance.config.get(
            "ENABLE_PLAN_AUTOHEAL", session_vars))

    _parse_orders = staticmethod(parse_orders)

    def _autoheal(self, e: _Entry, agg: _PlanAgg, cur_ms: float, reason: str):
        """Open a quarantine episode for a freshly flagged digest: rollback
        for a new-plan regression, targeted stats repair for same-plan drift.
        Runs outside the store lock (metadb writes + ANALYZE-grade work)."""
        inst = self.instance
        key = (e.schema, e.ptext)
        rollback_orders = None
        if reason == "new_plan":
            base_agg = e.plans.get(e.baseline_fp)
            if base_agg is not None:
                rollback_orders = self._parse_orders(base_agg.orders)
        mode = "rollback" if rollback_orders else "repair"
        if mode == "repair" and not self._parse_orders(agg.orders):
            return  # joinless/point digests have no plan decision to heal
        action = inst.planner.spm.begin_quarantine(
            key, mode, reason, rollback_orders,
            baseline_ms=e.baseline_ms,
            factor=float(self._cfg("PLAN_REGRESSION_FACTOR", 1.5)),
            verify_execs=int(self._cfg("PLAN_HEAL_VERIFY_EXECS", 5)),
            max_rollbacks=int(self._cfg("PLAN_HEAL_MAX_ROLLBACKS", 3)),
            cooldown_s=float(self._cfg("PLAN_HEAL_COOLDOWN_S", 300)),
            stats_version=inst.catalog.stats_version,
            regressed_ms=cur_ms)
        if action is None:
            return  # no baseline / episode live / parked / cooling down
        from galaxysql_tpu_torch.utils import events
        if action["action"] == "damped":
            self.heal_failures.inc()
            events.publish(
                "plan_heal_failed",
                f"digest {e.digest}: flap damping cap hit after "
                f"{action['rollbacks']} episodes; parked until ANALYZE/DDL",
                node=inst.node_id, digest=e.digest, schema=e.schema,
                reason="flap_damped", baseline_id=action["baseline_id"],
                rollbacks=action["rollbacks"])
            return
        if action["action"] == "repair":
            # repair FIRST, then arm the (inert) episode, then retire the
            # cached plan: a concurrent bind racing the repair keeps the
            # pinned plan instead of anchoring probation on drifted stats
            try:
                self._repair_stats(e, agg, action)
            except Exception:
                # an unarmed episode nothing will ever arm is a permanent
                # wedge — abort it (un-parked: the sentinel may retry after
                # the cooldown) and let _flag's handler publish the error
                inst.planner.spm.abort_heal(key, "stats repair failed")
                raise
            inst.planner.spm.arm_heal(key)
            inst.planner.cache.invalidate(key)
            return
        # retire the regressed cached plan: the next bind enters probation
        inst.planner.cache.invalidate(key)
        events.publish(
            "plan_rollback",
            f"digest {e.digest}: rolled back to baseline plan "
            f"{e.baseline_fp} for verification ({cur_ms:.1f}ms vs "
            f"{e.baseline_ms:.1f}ms)",
            node=inst.node_id, digest=e.digest, schema=e.schema,
            reason=reason, plan=agg.fp, baseline_plan=e.baseline_fp,
            baseline_id=action["baseline_id"], rollbacks=action["rollbacks"],
            window_ms=round(cur_ms, 2), baseline_ms=round(e.baseline_ms, 2))

    def _observed_scan_floor(self, e: _Entry) -> int:
        """Largest materialized Scan cardinality any PROFILED run of this
        digest left in the QueryProfile ring — runtime evidence of drift the
        store row count may not yet reflect (0 when nothing was profiled)."""
        floor = 0
        profiles = getattr(self.instance, "profiles", None)
        if profiles is None:
            return 0
        from galaxysql_tpu_torch.sql.parameterize import parameterize
        for p in profiles.entries():
            if not p.op_stats or not p.sql or p.sql.startswith("<"):
                continue
            try:
                if digest_key((p.schema or "").lower(),
                              parameterize(p.sql).parameterized) != e.digest:
                    continue
            except Exception:
                continue
            for st in p.op_stats:
                if st.get("operator") == "Scan":
                    floor = max(floor, int(st.get("rows_out", 0)))
        return floor

    def _repair_stats(self, e: _Entry, agg: _PlanAgg, action: dict):
        """Same-plan drift: correct the drifted statistics of the digest's
        tables from runtime truth, then let probation re-plan unpinned.

        Deliberately SYNCHRONOUS on the flagging query's exit ramp: the very
        next bind of this digest must see the corrected stats, or probation
        would verify the same broken plan.  The cost is bounded in practice —
        at most one episode per digest per cooldown window, only the tables
        whose sketch/live row gap exceeds STATS_DRIFT_TOLERANCE are rebuilt,
        and the flagging query was already regressed.  Continuous BACKGROUND
        repair (decoupled from heal episodes) is the roadmap follow-up."""
        from galaxysql_tpu_torch.meta.statistics import repair_table_stats
        from galaxysql_tpu_torch.utils import events
        inst = self.instance
        labels = [lab for forest in (self._parse_orders(agg.orders) or [])
                  for lab in forest if "." in lab and
                  not lab.startswith("rel:")]
        floor = self._observed_scan_floor(e)
        targets = []
        for lab in dict.fromkeys(labels):  # de-dup, keep order
            schema, _, table = lab.partition(".")
            try:
                targets.append((inst.catalog.table(schema, table),
                                inst.store(schema, table)))
            except Exception:
                continue  # dropped since the plan ran
        # the observed scan floor corroborates the LARGEST table (a scan
        # never returns more rows than its table holds)
        biggest = max(targets, key=lambda t: t[1].row_count(), default=None)
        repaired = []
        for tm, store in targets:
            delta = repair_table_stats(
                tm, store,
                observed_rows=floor if biggest is not None and
                tm is biggest[0] else None)
            if delta is not None:
                repaired.append(delta)
        if repaired:
            # corrected stats must reach every cached plan, exactly like
            # ANALYZE (catalog.version keys the plan cache; stats_version
            # re-arms HEAL_FAILED-parked digests over the repaired tables)
            inst.catalog.version += 1
            inst.catalog.stats_version += 1
        events.publish(
            "stats_repair",
            f"digest {e.digest}: repaired {len(repaired)} drifted table(s) "
            + (", ".join(f"{d['table']} sketched "
                         f"{d['analyzed_rows_before']}->"
                         f"{d['analyzed_rows_after']}" for d in repaired)
               if repaired else "(no drift found; re-verifying)"),
            node=inst.node_id, digest=e.digest, schema=e.schema,
            plan=agg.fp, baseline_id=action["baseline_id"],
            observed_scan_rows=floor, repaired=repaired)

    def apply_heal_verdict(self, verdict: dict):
        """Close out a probation episode judged by
        PlanManager.record_execution: publish the typed outcome event, bump
        the heal counters, retire the probation-pinned cached plan, and (for
        EVOLVED) re-freeze the digest's latency baseline on the new plan."""
        from galaxysql_tpu_torch.utils import events
        inst = self.instance
        key = tuple(verdict["key"])
        dg = digest_key(key[0], key[1])
        inst.planner.cache.invalidate(key)
        kind = verdict["kind"]
        detail = (f"digest {dg}: probation median {verdict['median_ms']}ms "
                  f"vs baseline {verdict['baseline_ms']}ms "
                  f"(x{verdict['factor']})")
        if kind in ("promoted", "evolved"):
            self.heals.inc()
            events.publish(
                "plan_promoted",
                f"{detail} — " + ("rollback promoted (HEALED)"
                                  if kind == "promoted" else
                                  "new plan kept as evolved baseline "
                                  "(EVOLVED)"),
                node=inst.node_id, digest=dg, schema=key[0], outcome=kind,
                reason=verdict["reason"], mode=verdict["mode"],
                baseline_id=verdict["baseline_id"],
                median_ms=verdict["median_ms"],
                baseline_ms=verdict["baseline_ms"])
            self._reset_baseline(key, refreeze=verdict.get("refreeze", False))
        else:
            self.heal_failures.inc()
            events.publish(
                "plan_heal_failed",
                f"{detail} — still regressed after "
                f"{verdict['mode']}; parked until ANALYZE/DDL",
                node=inst.node_id, digest=dg, schema=key[0],
                reason=verdict["reason"], mode=verdict["mode"],
                baseline_id=verdict["baseline_id"],
                median_ms=verdict["median_ms"],
                baseline_ms=verdict["baseline_ms"])

    def _reset_baseline(self, key: Tuple[str, str], refreeze: bool):
        """Clear the episode's sentinel flags; `refreeze` additionally drops
        the frozen latency baseline so it re-forms on the (evolved) plan the
        digest now runs — the new normal becomes the new yardstick."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            for a in e.plans.values():
                a.flagged = False
            if refreeze:
                e.baseline_fp = None
                e.baseline_ms = None
                e.baseline_samples = []

    # -- surfaces ------------------------------------------------------------

    def digest_signal(self, schema: str, ptext: str) -> Tuple[int, float]:
        """(executions, avg rows_examined) of a digest across its plans —
        the columnar router's observed-size signal (storage/columnar.py):
        a digest that historically examined many rows routes to the replica
        even when the planner's estimate is cold or wrong."""
        with self._lock:
            e = self._entries.get((schema.lower(), ptext))
            if e is None:
                return 0, 0.0
            execs = sum(a.execs for a in e.plans.values())
            rx = sum(a.rows_examined for a in e.plans.values())
            return execs, rx / max(execs, 1)

    def rows(self) -> List[tuple]:
        """SHOW STATEMENT SUMMARY / information_schema.statement_summary: one
        row per digest x plan, hottest (total time) first."""
        out = []
        with self._lock:
            for e in self._entries.values():
                for agg in e.plans.values():
                    qs = agg.latency.quantiles()
                    ex = agg.extras
                    out.append((agg.total_ms, (
                        e.digest, e.schema, agg.fp,
                        ",".join(sorted(agg.engines)), agg.execs, agg.errors,
                        round(agg.total_ms / max(agg.execs - agg.errors, 1),
                              3),
                        round(qs[0.95], 3), round(qs[0.99], 3),
                        agg.rows_returned, agg.rows_examined,
                        ex["retraces"], ex["frag_hits"],
                        ex["rf_rows_pruned"], ex["skew_activations"],
                        ex["rpc_retries"], ex["spill_bytes"],
                        agg.peak_rss_kb,
                        1 if agg.flagged else 0,
                        agg.orders, e.sample_sql)))
        out.sort(key=lambda t: -t[0])  # hottest = most total time consumed
        return [r for _, r in out]

    def history_rows(self) -> List[tuple]:
        """SHOW STATEMENT SUMMARY HISTORY: one row per digest x plan x
        window bucket, newest bucket first."""
        out = []
        with self._lock:
            for e in self._entries.values():
                for agg in e.plans.values():
                    for b in agg.buckets:
                        out.append((
                            e.digest, e.schema, agg.fp, int(b.start),
                            b.execs, b.errors, round(b.avg_ms, 3),
                            0.0 if b.min_ms == float("inf")
                            else round(b.min_ms, 3),
                            round(b.max_ms, 3), b.rows_returned,
                            b.rows_examined, b.extras["retraces"],
                            b.extras["frag_hits"],
                            b.extras["rf_rows_pruned"],
                            b.extras["rpc_retries"],
                            b.extras["spill_bytes"], e.sample_sql[:128]))
        out.sort(key=lambda r: (-r[3], r[0], r[2]))
        return out

    def top_digests(self, k: int) -> List[dict]:
        """Top-K digests by total time — the bounded-cardinality Prometheus
        export (server/web.py) and the /statements JSON ranking."""
        ranked: List[Tuple[float, dict]] = []
        with self._lock:
            for e in self._entries.values():
                total_ms = sum(a.total_ms for a in e.plans.values())
                execs = sum(a.execs for a in e.plans.values())
                errors = sum(a.errors for a in e.plans.values())
                # blended quantiles across plans: sample the per-plan
                # reservoirs proportionally (host-side, tiny)
                merged = Histogram("m", reservoir=256)
                for a in e.plans.values():
                    with a.latency._lock:
                        buf = list(a.latency._buf)
                    merged.observe_many(buf)
                qs = merged.quantiles()
                ranked.append((total_ms, {
                    "digest": e.digest, "schema": e.schema,
                    "sql": e.sample_sql, "execs": execs, "errors": errors,
                    "total_ms": round(total_ms, 3),
                    "plans": sorted(e.plans),
                    "workloads": sorted(set().union(
                        *(a.workloads for a in e.plans.values()))),
                    "regressed": any(a.flagged for a in e.plans.values()),
                    "p50_ms": round(qs[0.5], 3), "p95_ms": round(qs[0.95], 3),
                    "p99_ms": round(qs[0.99], 3)}))
        ranked.sort(key=lambda t: -t[0])
        return [d for _, d in ranked[:k]]

    def clear(self):
        with self._lock:
            self._entries.clear()
