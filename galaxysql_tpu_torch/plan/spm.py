"""SPM — SQL Plan Management: baselines, accepted plans, evolution.

Reference analog: `polardbx-optimizer/.../planmanager/PlanManager.java:92` and
`BaselineInfo`/`PlanInfo`: per parameterized-SQL *baselines* pin the join order
the executor runs, independent of what the cost model would pick today.  The
first execution captures the cost-based choice as the accepted plan; later
plannings reuse it even when statistics drift would flip the greedy order
(plan stability).  When the cost model disagrees with the accepted plan, its
choice is kept as an *unaccepted candidate*; `BASELINE EVOLVE` executes
candidates and promotes one that is measurably faster (plan evolution).
Baselines are invalidated by DDL (catalog version) and persisted in the metadb
kv store so they survive restarts.

The plan identity here is the join order — the one decision our optimizer makes
that is both cost-driven and high-blast-radius (the reference's PlanInfo stores
full RelNode JSON; on this engine every other physical choice is deterministic
given the join tree).

Self-healing (round 10): each baseline is additionally a persisted per-digest
quarantine state machine driven by the statement-summary sentinel
(meta/statement_summary.py):

    HEALTHY --sentinel--> REGRESSED --next bind--> PROBATION
                                                     |-- verified fast --> HEALED
                                                     |-- old plan slow too --> EVOLVED
                                                     '-- repair didn't help --> HEAL_FAILED

A REGRESSED baseline's next bind re-plans pinned to the episode's rollback
orders (the frozen known-good PlanRecord) — or, for same-plan stats drift,
unpinned so repaired statistics can pick a better order — then the next
`PLAN_HEAL_VERIFY_EXECS` executions are judged against the frozen latency
baseline median.  Flap damping is breaker-style (per-digest cooldown + a max
episode count); HEAL_FAILED parks the digest until ANALYZE/DDL moves the
catalog version.  The whole machine persists in the metadb baseline record so
a coordinator restart resumes probation instead of re-thrashing."""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

_KV_PREFIX = "spm.baseline."
# record-format version: 2 = orders captured in GOO MERGE order (left-deep
# replay reproduces the captured tree); older records are dropped at attach
_KV_VERSION = 2

# quarantine states of a baseline's heal machine (SHOW BASELINE `STATE`)
HEAL_STATES = ("HEALTHY", "REGRESSED", "PROBATION", "HEALED", "EVOLVED",
               "HEAL_FAILED")
# states with a live episode: the sentinel must not start another
_ACTIVE_STATES = frozenset({"REGRESSED", "PROBATION"})


class HealEpisode:
    """One in-flight quarantine episode (persisted with its baseline)."""

    __slots__ = ("mode", "reason", "rollback_orders", "baseline_ms",
                 "regressed_ms", "factor", "verify_execs", "samples",
                 "observed_orders", "started_at", "armed", "rejects")

    def __init__(self, mode: str, reason: str,
                 rollback_orders: Optional[List[Tuple[str, ...]]],
                 baseline_ms: float, regressed_ms: float, factor: float,
                 verify_execs: int, started_at: float):
        self.mode = mode              # rollback | repair
        self.reason = reason          # new_plan | plan_drift
        self.rollback_orders = [tuple(o) for o in (rollback_orders or [])]
        self.baseline_ms = baseline_ms
        self.regressed_ms = regressed_ms  # the flagged window's median
        self.factor = factor
        self.verify_execs = max(int(verify_execs), 1)
        self.samples: List[float] = []
        # join orders the probation executions actually ran (the promote
        # target; for rollback mode these equal rollback_orders, for repair
        # mode they are whatever the corrected stats made the cost model pick)
        self.observed_orders: List[Tuple[str, ...]] = []
        self.started_at = started_at
        # repair episodes stay UNARMED (binds keep the pinned accepted plan)
        # until the synchronous stats repair completes — a bind racing the
        # repair would otherwise anchor probation on still-drifted stats
        self.armed = mode == "rollback"
        # probation executions whose orders did not match the expected plan;
        # a bounded count closes a wedged episode instead of pinning the
        # digest in PROBATION forever
        self.rejects = 0

    def to_json(self):
        return {"mode": self.mode, "reason": self.reason,
                "rollback_orders": [list(o) for o in self.rollback_orders],
                "baseline_ms": self.baseline_ms,
                "regressed_ms": self.regressed_ms, "factor": self.factor,
                "verify_execs": self.verify_execs, "samples": self.samples,
                "observed_orders": [list(o) for o in self.observed_orders],
                "started_at": self.started_at, "armed": self.armed,
                "rejects": self.rejects}

    @classmethod
    def from_json(cls, d):
        h = cls(d.get("mode", "rollback"), d.get("reason", "new_plan"),
                [tuple(o) for o in d.get("rollback_orders", [])],
                d.get("baseline_ms", 0.0), d.get("regressed_ms", 0.0),
                d.get("factor", 1.5), d.get("verify_execs", 5),
                d.get("started_at", 0.0))
        h.samples = [float(v) for v in d.get("samples", [])]
        h.observed_orders = [tuple(o) for o in d.get("observed_orders", [])]
        h.armed = d.get("armed", True)
        h.rejects = int(d.get("rejects", 0))
        return h


class SpmContext:
    """Per-planning handshake with build_join_tree: carries the forced order in
    and the chosen order out (one entry per join forest, preorder)."""

    def __init__(self, forced: Optional[List[Tuple[str, ...]]] = None):
        self.forced = forced or []   # list of label tuples, one per forest
        self.chosen: List[Tuple[str, ...]] = []
        # what the cost model would pick (== chosen unless a baseline forced)
        self.cost_preferred: List[Tuple[str, ...]] = []
        self._forest_ix = 0

    def next_forced(self) -> Optional[Tuple[str, ...]]:
        ix = self._forest_ix
        self._forest_ix += 1
        if ix < len(self.forced):
            return self.forced[ix]
        return None


class PlanRecord:
    __slots__ = ("orders", "origin", "runs", "total_ms", "regressions",
                 "last_regression")

    def __init__(self, orders: List[Tuple[str, ...]], origin: str = "cost",
                 runs: int = 0, total_ms: float = 0.0):
        self.orders = [tuple(o) for o in orders]
        self.origin = origin          # cost | evolved | manual
        self.runs = runs
        self.total_ms = total_ms
        # runtime-regression audit trail, written by the statement-summary
        # sentinel (meta/statement_summary.py): how often this accepted plan
        # was flagged against the digest's latency baseline, and why last
        self.regressions = 0
        self.last_regression = ""

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.runs if self.runs else float("inf")

    def to_json(self):
        return {"orders": [list(o) for o in self.orders], "origin": self.origin,
                "runs": self.runs, "total_ms": self.total_ms,
                "regressions": self.regressions,
                "last_regression": self.last_regression}

    @classmethod
    def from_json(cls, d):
        r = cls([tuple(o) for o in d["orders"]], d.get("origin", "cost"),
                d.get("runs", 0), d.get("total_ms", 0.0))
        r.regressions = d.get("regressions", 0)
        r.last_regression = d.get("last_regression", "")
        return r


class Baseline:
    __slots__ = ("key", "catalog_version", "accepted", "candidate", "baseline_id",
                 "last_params", "state", "rollbacks", "last_heal",
                 "last_heal_at", "park_version", "heal")

    def __init__(self, key: Tuple[str, str], catalog_version: int,
                 accepted: PlanRecord, baseline_id: int,
                 candidate: Optional[PlanRecord] = None):
        self.key = key
        self.catalog_version = catalog_version
        self.accepted = accepted
        self.candidate = candidate
        self.baseline_id = baseline_id
        self.last_params: list = []  # most recent bind values (evolution input)
        # self-heal quarantine machine (HEAL_STATES); all persisted so a
        # coordinator restart resumes probation instead of re-thrashing
        self.state = "HEALTHY"
        self.rollbacks = 0            # lifetime heal episodes (flap damping)
        self.last_heal = ""           # one human line about the last verdict
        self.last_heal_at = 0.0       # episode-start stamp (cooldown gate)
        self.park_version = -1        # catalog version at HEAL_FAILED park
        self.heal: Optional[HealEpisode] = None


class PlanManager:
    """Baseline store + accepted-plan choice + evolution (PlanManager.java:92)."""

    def __init__(self):
        self._baselines: Dict[Tuple[str, str], Baseline] = {}
        self._lock = threading.Lock()
        self._metadb = None
        self._next_id = 1
        self.enabled = True
        # live heal episodes (REGRESSED/PROBATION).  heal_pin() reads this
        # without the lock so the zero-episode hot path costs one int compare.
        self._healing = 0

    # -- persistence --------------------------------------------------------

    def attach(self, metadb):
        """Bind the metadb and reload persisted baselines."""
        self._metadb = metadb
        for k, v in metadb.kv_scan(_KV_PREFIX):
            try:
                d = json.loads(v)
                if d.get("v", 1) < _KV_VERSION:
                    # pre-merge-order records hold lead-concat label orders:
                    # replaying one left-deep can reconstruct a DIFFERENT
                    # (possibly m:n-first) tree than the plan it pinned —
                    # drop it; the next execution re-captures correctly
                    metadb.kv_delete(k)
                    continue
                key = (d["schema"], d["sql"])
                b = Baseline(key, d["catalog_version"],
                             PlanRecord.from_json(d["accepted"]),
                             d.get("id", self._next_id),
                             PlanRecord.from_json(d["candidate"])
                             if d.get("candidate") else None)
                b.state = d.get("state", "HEALTHY")
                b.rollbacks = d.get("rollbacks", 0)
                b.last_heal = d.get("last_heal", "")
                b.last_heal_at = d.get("last_heal_at", 0.0)
                b.park_version = d.get("park_version", -1)
                if d.get("heal"):
                    b.heal = HealEpisode.from_json(d["heal"])
                if b.heal is not None and not b.heal.armed:
                    # crash between begin_quarantine and arm_heal: whether
                    # the stats repair completed is unknowable — abort the
                    # episode (un-parked) instead of reloading a wedge the
                    # sentinel could never close
                    b.state = "HEAL_FAILED"
                    b.park_version = -1
                    b.last_heal = "aborted: repair interrupted by restart"
                    b.heal = None
                with self._lock:
                    self._baselines[key] = b
                    self._next_id = max(self._next_id, b.baseline_id + 1)
                    if b.state in _ACTIVE_STATES and b.heal is not None:
                        self._healing += 1  # restart resumes probation
            except Exception:
                continue  # a corrupt record must not poison boot

    def _persist(self, b: Baseline):
        if self._metadb is None:
            return
        d = {"v": _KV_VERSION,
             "schema": b.key[0], "sql": b.key[1], "id": b.baseline_id,
             "catalog_version": b.catalog_version,
             "accepted": b.accepted.to_json(),
             "candidate": b.candidate.to_json() if b.candidate else None,
             "state": b.state, "rollbacks": b.rollbacks,
             "last_heal": b.last_heal, "last_heal_at": b.last_heal_at,
             "park_version": b.park_version,
             "heal": b.heal.to_json() if b.heal else None}
        self._metadb.kv_put(_KV_PREFIX + f"{b.baseline_id}", json.dumps(d))

    def _unpersist(self, b: Baseline):
        if self._metadb is not None:
            self._metadb.kv_delete(_KV_PREFIX + f"{b.baseline_id}")

    # -- planning-time API --------------------------------------------------

    def choose(self, key: Tuple[str, str],
               catalog_version: int) -> Optional[List[Tuple[str, ...]]]:
        """Accepted join orders for this SQL, or None.  A DDL since capture
        (catalog version mismatch) drops the stale baseline (invalidation).

        A REGRESSED baseline's next bind enters PROBATION here: rollback
        episodes pin the frozen known-good orders; repair (stats-drift)
        episodes return None so the corrected statistics drive a fresh cost
        choice.  The probation plan is then judged by record_execution."""
        if not self.enabled:
            return None
        with self._lock:
            b = self._baselines.get(key)
            if b is None:
                return None
            if b.catalog_version != catalog_version:
                if b.state in _ACTIVE_STATES and b.heal is not None:
                    self._healing -= 1  # DDL aborts the episode with the plan
                del self._baselines[key]
                self._unpersist(b)
                return None
            if b.heal is not None and b.state in _ACTIVE_STATES and \
                    b.heal.armed:
                if b.state == "REGRESSED":
                    b.state = "PROBATION"
                    self._persist(b)
                if b.heal.mode == "rollback":
                    return [tuple(o) for o in b.heal.rollback_orders]
                return None  # repair probation: repaired stats pick the plan
            # an UNARMED repair episode keeps the pinned plan: the stats
            # repair has not finished yet, so probation must not start
            return list(b.accepted.orders)

    def heal_pin(self, key: Tuple[str, str]) -> str:
        """Fragment-cache salt for plans bound while this key's heal episode
        is live: probation artifacts and regressed-plan artifacts must never
        cross in the cache.  '' (steady state) costs one int compare."""
        if self._healing == 0:
            return ""
        with self._lock:
            b = self._baselines.get(key)
            if b is None or b.heal is None or b.state not in _ACTIVE_STATES:
                return ""
            return f"heal:{b.baseline_id}:{b.rollbacks}"

    # -- self-heal loop (statement-summary sentinel drives this) -------------

    def arm_heal(self, key: Tuple[str, str]):
        """Arm a repair episode once the stats repair has completed: from
        the NEXT bind on, probation runs unpinned and anchors on the
        corrected-stats cost choice (capture)."""
        with self._lock:
            b = self._baselines.get(key)
            if b is not None and b.heal is not None and not b.heal.armed:
                b.heal.armed = True
                self._persist(b)

    def abort_heal(self, key: Tuple[str, str], note: str):
        """Close a live episode that cannot proceed (repair raised, heal
        machinery error).  Unlike a judged HEAL_FAILED, an abort does NOT
        park: park_version stays -1, so the sentinel may open a fresh
        episode after the cooldown — an interrupted repair must not kill the
        digest's heal loop forever."""
        with self._lock:
            b = self._baselines.get(key)
            if b is None or b.heal is None or b.state not in _ACTIVE_STATES:
                return
            b.state = "HEAL_FAILED"
            b.park_version = -1
            b.last_heal = f"aborted: {note}"[:256]
            b.heal = None
            self._healing -= 1
            self._persist(b)

    def begin_quarantine(self, key: Tuple[str, str], mode: str, reason: str,
                         rollback_orders: Optional[List[Tuple[str, ...]]],
                         baseline_ms: float, factor: float, verify_execs: int,
                         max_rollbacks: int, cooldown_s: float,
                         stats_version: int, regressed_ms: float = 0.0,
                         now: Optional[float] = None) -> Optional[dict]:
        """Open a heal episode for a sentinel-flagged digest.  Returns the
        action taken — {"action": "rollback"|"repair"|"damped", ...} — or
        None when no episode may start (no baseline, one already live,
        parked, or cooling down).  Breaker-style flap damping: a digest that
        keeps regressing within the cooldown, or that has burned its episode
        budget, parks in HEAL_FAILED until ANALYZE/DDL/stats-repair moves
        the STATS epoch (`Catalog.stats_version` — deliberately not
        `catalog.version`, which every DML commit bumps)."""
        now = time.time() if now is None else now
        with self._lock:
            b = self._baselines.get(key)
            if b is None or not self.enabled:
                return None
            if b.state in _ACTIVE_STATES:
                return None  # one episode at a time
            if b.state == "HEAL_FAILED":
                if b.park_version == stats_version:
                    return None  # parked: re-arm only on ANALYZE/DDL
                # stats/schema moved since the park: re-arm with a fresh
                # episode budget
                b.rollbacks = 0
                b.park_version = -1
            if b.last_heal_at and now - b.last_heal_at < cooldown_s:
                return None  # cooling down: detect-only until it elapses
            if b.rollbacks >= max(int(max_rollbacks), 1):
                b.state = "HEAL_FAILED"
                b.park_version = stats_version
                b.last_heal = f"flap_damped: {b.rollbacks} episodes"
                b.heal = None
                self._persist(b)
                return {"action": "damped", "baseline_id": b.baseline_id,
                        "rollbacks": b.rollbacks}
            b.heal = HealEpisode(mode, reason, rollback_orders, baseline_ms,
                                 regressed_ms, factor, verify_execs, now)
            b.state = "REGRESSED"
            b.rollbacks += 1
            b.last_heal_at = now
            self._healing += 1
            self._persist(b)
            return {"action": mode, "baseline_id": b.baseline_id,
                    "rollbacks": b.rollbacks,
                    "rollback_orders": [list(o)
                                        for o in b.heal.rollback_orders]}

    def capture(self, key: Tuple[str, str], chosen: List[Tuple[str, ...]],
                catalog_version: int, followed_baseline: bool,
                cost_preferred: Optional[List[Tuple[str, ...]]] = None):
        """Record the planner's outcome.  First sight => accepted baseline;
        a cost-model disagreement (cost_preferred != accepted) => unaccepted
        candidate (evolution input), while execution keeps following the
        accepted plan."""
        if not self.enabled or not chosen:
            return
        with self._lock:
            b = self._baselines.get(key)
            if b is None:
                b = Baseline(key, catalog_version, PlanRecord(chosen, "cost"),
                             self._next_id)
                self._next_id += 1
                self._baselines[key] = b
                self._persist(b)
                return
            if b.state == "PROBATION" and b.heal is not None and \
                    b.heal.mode == "repair" and not b.heal.observed_orders:
                # anchor the repair episode on the POST-REPAIR bind's cost
                # choice: only executions of THIS plan count as verification
                # samples (an in-flight regressed-plan straggler never
                # re-binds, so it can neither set nor match the anchor)
                b.heal.observed_orders = [tuple(o) for o in chosen]
                self._persist(b)
            pref = [tuple(o) for o in (cost_preferred or chosen)]
            if pref != b.accepted.orders and \
                    (b.candidate is None or pref != b.candidate.orders):
                b.candidate = PlanRecord(pref, "cost")
                self._persist(b)

    def record_execution(self, key: Tuple[str, str], elapsed_ms: float,
                         params: Optional[list] = None,
                         orders: Optional[List[Tuple[str, ...]]] = None,
                         stats_version: int = -1) -> Optional[dict]:
        """Per-execution bookkeeping; during PROBATION also a verification
        sample.  Returns a heal VERDICT dict once the episode's sample quota
        fills — {"kind": "promoted"|"evolved"|"failed", ...} — else None (the
        steady-state path pays one extra attribute compare)."""
        with self._lock:
            b = self._baselines.get(key)
            if b is None:
                return None
            b.accepted.runs += 1
            b.accepted.total_ms += elapsed_ms
            if params is not None:
                b.last_params = list(params)
            if b.state != "PROBATION" or b.heal is None:
                return None
            h = b.heal
            # verification samples must come from the PROBATION plan: a
            # regressed-plan execution already in flight when the episode
            # opened (bound before the cache invalidation) would otherwise
            # pollute the median — or, worse, land as observed_orders and
            # get PROMOTED as the "verified" plan.  Rollback episodes expect
            # exactly the pinned orders; repair episodes lock onto whatever
            # the first post-repair bind chose.
            got = [tuple(o) for o in orders] if orders else None
            if got is None:
                return None  # unattributable execution: not a sample
            expected = h.rollback_orders if h.mode == "rollback" \
                else h.observed_orders  # anchored by the probation bind
            if not expected or got != expected:
                # straggler of another plan (or pre-anchor).  Bounded: a
                # probation that only ever sees mismatching executions would
                # otherwise wedge the digest in PROBATION forever — close it
                # as failed once the rejects clearly outnumber any plausible
                # straggler tail.
                h.rejects += 1
                if h.rejects > 8 * h.verify_execs:
                    b.last_heal = (f"heal_failed({h.reason}): probation "
                                   f"never observed the expected plan "
                                   f"({h.rejects} mismatched executions)")
                    b.state = "HEAL_FAILED"
                    b.park_version = stats_version
                    verdict = {"key": b.key, "baseline_id": b.baseline_id,
                               "mode": h.mode, "reason": h.reason,
                               "kind": "failed", "median_ms": 0.0,
                               "baseline_ms": round(h.baseline_ms, 3),
                               "factor": h.factor, "rollbacks": b.rollbacks,
                               "refreeze": False}
                    b.heal = None
                    self._healing -= 1
                    self._persist(b)
                    return verdict
                return None
            h.samples.append(elapsed_ms)
            if len(h.samples) < h.verify_execs:
                self._persist(b)  # probation progress survives a restart
                return None
            return self._judge_locked(b, stats_version)

    def _judge_locked(self, b: Baseline, stats_version: int) -> dict:
        """Close the episode: compare the probation median against the frozen
        latency baseline and promote / evolve / park.  Caller holds _lock."""
        h = b.heal
        s = sorted(h.samples)
        median = s[len(s) // 2]
        met_baseline = h.baseline_ms > 0 and median <= h.factor * h.baseline_ms
        # the baseline may be unreachable (real data growth) while the
        # probation plan still clearly beats the regressed one — keeping the
        # regressed plan because probation "only" won by 100x would be
        # perverse; promote, but re-freeze the latency baseline to the new
        # normal so the sentinel keeps an honest yardstick
        beats_regressed = h.regressed_ms > 0 and \
            median * h.factor <= h.regressed_ms
        verdict = {"key": b.key, "baseline_id": b.baseline_id, "mode": h.mode,
                   "reason": h.reason, "median_ms": round(median, 3),
                   "baseline_ms": round(h.baseline_ms, 3),
                   "factor": h.factor, "rollbacks": b.rollbacks,
                   "refreeze": False}
        if met_baseline or beats_regressed:
            # probation plan verified: promote it as the accepted plan
            # (rollback mode: the frozen known-good orders; repair mode:
            # whatever the corrected stats made the cost model pick)
            orders = h.observed_orders or h.rollback_orders
            if orders:
                b.accepted = PlanRecord([tuple(o) for o in orders], "healed",
                                        runs=len(h.samples),
                                        total_ms=sum(h.samples))
            b.candidate = None
            b.state = "HEALED"
            b.last_heal = (f"healed({h.reason}): median {median:.1f}ms vs "
                           f"baseline {h.baseline_ms:.1f}ms"
                           + ("" if met_baseline else
                              f" (baseline unreachable; beat regressed "
                              f"{h.regressed_ms:.1f}ms, re-frozen)"))
            verdict["kind"] = "promoted"
            verdict["orders"] = [list(o) for o in b.accepted.orders]
            verdict["refreeze"] = not met_baseline
        elif h.mode == "rollback":
            # the old plan is slow now too: the regression wasn't the plan's
            # fault — keep the new plan and let the latency baseline re-freeze
            # on it (plan evolution under drifted data)
            b.accepted.origin = "evolved"
            b.candidate = None
            b.state = "EVOLVED"
            b.last_heal = (f"evolved({h.reason}): rollback median "
                           f"{median:.1f}ms missed baseline "
                           f"{h.baseline_ms:.1f}ms; new plan kept, "
                           f"baseline re-frozen")
            verdict["kind"] = "evolved"
            verdict["orders"] = [list(o) for o in b.accepted.orders]
            verdict["refreeze"] = True
        else:
            # stats repair didn't recover the digest: park until ANALYZE/DDL
            b.state = "HEAL_FAILED"
            b.park_version = stats_version
            b.last_heal = (f"heal_failed({h.reason}): post-repair median "
                           f"{median:.1f}ms vs baseline {h.baseline_ms:.1f}ms")
            verdict["kind"] = "failed"
        b.heal = None
        self._healing -= 1
        self._persist(b)
        return verdict

    def last_params(self, key: Tuple[str, str]) -> list:
        with self._lock:
            b = self._baselines.get(key)
            return list(b.last_params) if b is not None else []

    def note_regression(self, key: Tuple[str, str], note: str) -> bool:
        """Statement-summary sentinel verdict: stamp the accepted PlanRecord
        so BASELINE audits (SHOW BASELINE, /baselines) carry the runtime
        truth.  Returns False when the key has no baseline (hinted or
        uncached plans never captured one)."""
        with self._lock:
            b = self._baselines.get(key)
            if b is None:
                return False
            b.accepted.regressions += 1
            b.accepted.last_regression = note[:256]
            self._persist(b)
            return True

    # -- DAL ----------------------------------------------------------------

    def rows(self) -> List[tuple]:
        """SHOW BASELINE rows."""
        out = []
        with self._lock:
            for b in sorted(self._baselines.values(),
                            key=lambda x: x.baseline_id):
                out.append((b.baseline_id, b.key[0], b.key[1],
                            json.dumps([list(o) for o in b.accepted.orders]),
                            b.accepted.origin, b.accepted.runs,
                            round(b.accepted.avg_ms, 3) if b.accepted.runs else None,
                            json.dumps([list(o) for o in b.candidate.orders])
                            if b.candidate else None,
                            b.accepted.regressions,
                            b.accepted.last_regression,
                            b.state, b.rollbacks, b.last_heal))
        return out

    def delete(self, baseline_id: int) -> bool:
        with self._lock:
            for k, b in list(self._baselines.items()):
                if b.baseline_id == baseline_id:
                    if b.state in _ACTIVE_STATES and b.heal is not None:
                        self._healing -= 1
                    del self._baselines[k]
                    self._unpersist(b)
                    return True
        return False

    def evolve(self, measure, min_gain: float = 0.8) -> List[tuple]:
        """Execute unaccepted candidates and promote the measurably faster ones.

        `measure(key, orders) -> elapsed_ms` runs the SQL with the given join
        orders forced (the session provides this).  A candidate is promoted
        when its measured time is < min_gain * accepted's average.  Returns
        (baseline_id, promoted, candidate_ms, accepted_avg_ms) per candidate."""
        results = []
        with self._lock:
            pending = [(k, b) for k, b in self._baselines.items()
                       if b.candidate is not None]
        for k, b in pending:
            cand_ms = measure(k, list(b.candidate.orders))
            accepted_avg = b.accepted.avg_ms
            promoted = cand_ms < min_gain * accepted_avg
            with self._lock:
                if promoted:
                    b.candidate.origin = "evolved"
                    b.candidate.runs = 1
                    b.candidate.total_ms = cand_ms
                    b.accepted = b.candidate
                b.candidate = None
                self._persist(b)
            results.append((b.baseline_id, promoted, round(cand_ms, 3),
                            round(accepted_avg, 3)))
        return results
