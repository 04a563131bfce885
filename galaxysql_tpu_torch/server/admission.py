"""Adaptive admission control + memory-pressure governance (overload plane).

Reference analog: the CN resource-governance subsystems the reference treats
as first-class (`optimizer/ccl` rule queuing, SURVEY.md §2.5, and the
memory/spill framework, §2.6), extended with the serving-stack shape every
saturated system needs: admit only work the box can finish, degrade with
typed errors, never collapse.

Four cooperating pieces:

- **Workload-class admission gate** in front of every query: statements
  classify TP (point/batched/short) vs AP (heavy) from the per-digest
  statement-summary cost (the PR 10 runtime-truth substrate — each finished
  query feeds its digest's observed class + latency EWMA back here) with a
  keyword heuristic for never-seen digests.  Each class holds an adaptive
  concurrency limit, AIMD-adjusted on observed latency: additive increase
  while the class meets its latency target, multiplicative decrease when the
  EWMA blows through it — the same control loop TCP uses to find a link's
  capacity, here finding the box's.
- **Deadline-aware shedding**: a statement whose remaining
  MAX_EXECUTION_TIME cannot cover its digest's predicted service time is
  refused immediately (typed, retry-after) instead of burning a slot on work
  that is already dead.
- **Memory-pressure tiers** (NORMAL -> ELEVATED -> CRITICAL) computed from
  the root `exec/memory.py` pool: ELEVATED shrinks the fragment-cache budget
  and drops spill thresholds 4x (queries trade disk for headroom);
  CRITICAL refuses new AP admissions and revokes the largest revocable
  query's pool (its operators spill at the next batch boundary) rather than
  letting the process OOM.
- **Typed refusals**: every shed is a `ServerOverloadError` carrying
  `retry_after_ms`, published to the event journal — the overload harness
  (`make overload-smoke`) asserts no other failure mode exists under flood.

Hot-path stance: when limits are idle the admit fast path is LOCK-FREE —
class token lists (GIL-atomic append/pop), one dict read for the digest
cost, one comparison against the limit.  The condition lock is touched only
by waiters and by releases that observe waiters.

Escape hatches (house trio): `ENABLE_ADMISSION_CONTROL` param,
``GALAXYSQL_ADMISSION=0`` env, per-statement ``ADMISSION(OFF)`` hint.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from galaxysql_tpu_torch.utils import errors

# kill switch: GALAXYSQL_ADMISSION=0 disables the whole subsystem (the A/B
# lever for the overload bench and the no-governance equivalence tests)
ENABLED = os.environ.get("GALAXYSQL_ADMISSION", "1") != "0"

TIERS = ("NORMAL", "ELEVATED", "CRITICAL")

# never-seen digests: heavy-shaped SQL (joins, grouping, global aggregates)
# is presumed AP until its first execution records the truth
_AP_GUESS_RE = re.compile(
    r"\b(?:group\s+by|join|order\s+by|sum\s*\(|avg\s*\(|count\s*\()", re.I)
# a hint comment can only matter when one exists; this pre-gate keeps the
# regex off plain statements
_HINT_MARK = "/*"


class MemoryGovernor:
    """Pressure tiers over the root memory pool + the responses per tier.

    ``tier()`` is called on every admission (and by workers piggybacking
    pressure into RPC replies): one division and a compare on the steady
    path.  Tier TRANSITIONS apply the governance actions — fragment-cache
    budget shrink/restore — and publish a `mem_pressure` event."""

    def __init__(self, instance=None, pool=None):
        from galaxysql_tpu_torch.exec.memory import GLOBAL_POOL
        self.instance = instance
        self.pool = pool if pool is not None else GLOBAL_POOL
        self._last_tier = 0
        self._frag_base: Optional[int] = None
        self._lock = threading.Lock()

    def _pct(self, name: str, default: int) -> float:
        inst = self.instance
        if inst is not None:
            v = inst.config.get(name)
            if v is not None:
                return int(v) / 100.0
        return default / 100.0

    def usage(self) -> float:
        from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_MEM_PRESSURE
        if FAIL_POINTS.active:
            v = FAIL_POINTS.value(FP_MEM_PRESSURE)
            if v is not None:
                if v == "elevated":
                    return self._pct("MEM_ELEVATED_PCT", 70)
                if v == "critical":
                    return self._pct("MEM_CRITICAL_PCT", 90)
                try:
                    return float(v)
                except (TypeError, ValueError):
                    return 1.0
        from galaxysql_tpu_torch.exec.memory import usage_fraction
        return usage_fraction(self.pool)

    def tier(self) -> int:
        u = self.usage()
        if u >= self._pct("MEM_CRITICAL_PCT", 90):
            t = 2
        elif u >= self._pct("MEM_ELEVATED_PCT", 70):
            t = 1
        else:
            t = 0
        if t != self._last_tier:
            self._on_transition(t, u)
        return t

    def _on_transition(self, t: int, usage: float):
        with self._lock:
            prev = self._last_tier
            if t == prev:
                return
            self._last_tier = t
        inst = self.instance
        fcache = getattr(inst, "frag_cache", None) if inst else None
        if fcache is not None:
            if self._frag_base is None:
                self._frag_base = fcache.budget
            # ELEVATED halves the cache's claim on host memory, CRITICAL
            # quarters it; NORMAL restores the boot budget.  set_budget
            # evicts LRU down to the new cap immediately.
            scale = (1.0, 0.5, 0.25)[t]
            fcache.set_budget(int(self._frag_base * scale))
        if inst is not None:
            inst.metrics.gauge(
                "memory_pressure_tier",
                "memory governor tier (0=NORMAL 1=ELEVATED 2=CRITICAL)"
            ).set(t)
        from galaxysql_tpu_torch.utils import events
        events.publish(
            "mem_pressure",
            f"memory pressure {TIERS[prev]} -> {TIERS[t]} "
            f"(root pool {usage:.0%} used)",
            severity="warn" if t > prev else "info",
            node=getattr(inst, "node_id", "") if inst else "",
            tier=TIERS[t], usage=round(usage, 3))

    def spill_scale(self) -> float:
        """Spill-threshold multiplier per tier: under pressure operators
        trade disk for resident state sooner."""
        return (1.0, 0.25, 0.125)[self.tier()]

    def revoke_largest_query(self) -> int:
        """CRITICAL response: flag the biggest per-query pool's operators to
        spill (flag-based revoke — the owning thread spills at its next
        batch boundary).  Returns the targeted pool's resident bytes."""
        from galaxysql_tpu_torch.exec.memory import largest_query_child
        victim = largest_query_child(self.pool)
        if victim is None:
            return 0
        held = victim.reserved
        victim.revoke(held)
        from galaxysql_tpu_torch.utils import events
        events.publish("mem_pressure",
                       f"CRITICAL: revoking largest query pool "
                       f"'{victim.name}' ({held} bytes resident)",
                       severity="warn", dedupe=f"revoke-{victim.name}",
                       pool=victim.name, bytes=held)
        return held


class _Ticket:
    """Admission handle: release() feeds observed latency + the true
    workload class back into the AIMD loop and the digest cost map.
    Idempotent (the Session exception paths may cross release sites)."""

    __slots__ = ("ctl", "cls", "digest", "t0", "_released")

    def __init__(self, ctl: Optional["AdmissionController"], cls: str,
                 digest: str):
        self.ctl = ctl
        self.cls = cls
        self.digest = digest
        self.t0 = time.time() if ctl is not None else 0.0
        self._released = False

    def release(self, prof=None, error: bool = False):
        if self.ctl is None or self._released:
            return
        self._released = True
        workload = getattr(prof, "workload", "") if prof is not None else ""
        err = error or bool(getattr(prof, "error", "")) \
            if prof is not None else error
        self.ctl._on_release(self, workload, err)


_NO_TICKET = _Ticket(None, "TP", "")


class AdmissionController:
    """Per-instance admission gate (see module docstring)."""

    # AIMD cadence: adjust a class's limit every N completions (per class)
    AIMD_SAMPLE = 16
    # multiplicative decrease / additive increase constants
    MD_FACTOR = 0.7
    AI_STEP = 1.0
    # digest cost map bound (plain dict, lock-free reads)
    MAX_DIGESTS = 4096

    def __init__(self, instance):
        self.instance = instance
        self.governor = MemoryGovernor(instance)
        # class -> in-flight tokens (list append/pop is GIL-atomic: the idle
        # fast path never takes a lock)
        self._tokens: Dict[str, list] = {"TP": [], "AP": []}
        # digest -> (class, latency EWMA ms); fed by _on_release
        self._digest_cost: Dict[str, Tuple[str, float]] = {}
        self._cond = threading.Condition()
        self._nwait = {"TP": 0, "AP": 0}  # plain-int waiter counts
        self._limit: Dict[str, float] = {}
        self._limit_max: Dict[str, float] = {}
        # config generation the cached limits were derived from: SET GLOBAL
        # ADMISSION_*_LIMIT must apply live (resetting AIMD state — config
        # changes are rare, a stale operator knob forever is worse)
        self._cfg_ver = -1
        self._ewma: Dict[str, float] = {"TP": 0.0, "AP": 0.0}
        self._since_adjust: Dict[str, int] = {"TP": 0, "AP": 0}
        self._aimd_lock = threading.Lock()
        # lifetime stats (SHOW ADMISSION / information_schema.admission_stats)
        self.admitted: Dict[str, int] = {"TP": 0, "AP": 0}
        self.shed_queue_full = 0
        self.shed_timeout = 0
        self.shed_deadline = 0
        self.shed_memory = 0
        self._stats_lock = threading.Lock()
        # cluster gossip (serving tier): node -> (snapshot, received_at) fed
        # by the health sync action / router gossip_tick.  The hot path only
        # reads `_cluster_min` (one dict get) — recomputed lazily when the
        # freshness window rolls, never per-admit.
        self._peer_snaps: Dict[str, Tuple[dict, float]] = {}
        self._cluster_min: Dict[str, float] = {}
        self._cluster_expire = 0.0

    # -- config ---------------------------------------------------------------

    def enabled(self, session=None, sql: str = "") -> bool:
        if not ENABLED:
            return False
        svars = getattr(session, "vars", None) if session is not None else None
        if not self.instance.config.get("ENABLE_ADMISSION_CONTROL", svars):
            return False
        if sql and _HINT_MARK in sql[:160]:
            from galaxysql_tpu_torch.sql.hints import parse_hints
            if parse_hints(sql).get("admission") == "off":
                return False
        return True

    @staticmethod
    def _cfg_int(v, default: int) -> int:
        # NOT `v or default`: a configured 0 is a real value (queue size 0 =
        # shed immediately, limit 0 = refuse the class), never the fallback
        return default if v is None else int(v)

    def limit(self, cls: str) -> float:
        ver = self.instance.config.version
        if ver != self._cfg_ver:
            self._cfg_ver = ver
            self._limit.clear()
            self._limit_max.clear()
        lim = self._limit.get(cls)
        if lim is None:
            base = self.instance.config.get(
                "ADMISSION_TP_LIMIT" if cls == "TP" else "ADMISSION_AP_LIMIT")
            lim = float(self._cfg_int(base, 256 if cls == "TP" else 8))
            self._limit[cls] = lim
            self._limit_max[cls] = max(lim, 1.0) * 4
        return lim

    def _target_ms(self, cls: str) -> float:
        return float(self._cfg_int(
            self.instance.config.get(
                "ADMISSION_TARGET_TP_MS" if cls == "TP"
                else "ADMISSION_TARGET_AP_MS"),
            100 if cls == "TP" else 5000))

    # -- cluster gossip (serving tier) ----------------------------------------

    def cluster_snapshot(self) -> dict:
        """This node's admission state as gossiped to peers (rides the
        `health` sync action reply): per-class AIMD limit + in-flight, plus
        total sheds.  Small and JSON-plain — it travels the dn wire."""
        snap = {"node": self.instance.node_id}
        for cls in ("TP", "AP"):
            snap[cls.lower()] = {
                "limit": round(self.limit(cls), 2),
                "inflight": len(self._tokens[cls]),
                "ewma_ms": round(self._ewma[cls], 2),
            }
        snap["shed"] = (self.shed_queue_full + self.shed_timeout +
                        self.shed_deadline + self.shed_memory)
        return snap

    def note_peer(self, node: str, snap: Optional[dict],
                  at: Optional[float] = None):
        """Record a peer coordinator's gossiped admission snapshot.  Feeds
        effective_limit(): the cluster-wide clamp is min(local AIMD limit,
        fresh peer limits) — a flood that collapsed peer A's AP limit drags
        every peer's effective AP limit down with it until A recovers."""
        if not node or node == self.instance.node_id \
                or not isinstance(snap, dict):
            return
        with self._stats_lock:
            self._peer_snaps[node] = (snap, at if at is not None
                                      else time.time())
            self._cluster_expire = 0.0  # force a lazy recompute

    def forget_peer(self, node: str):
        with self._stats_lock:
            self._peer_snaps.pop(node, None)
            self._cluster_expire = 0.0

    def _fresh_s(self) -> float:
        v = self.instance.config.get("GOSSIP_FRESH_S")
        return float(v) if v is not None else 5.0

    def _recompute_cluster(self, now: float):
        """Rebuild the per-class min over FRESH peer limits.  `_cluster_expire`
        is set to the earliest moment the picture can change (a snapshot
        aging out or the freshness window), so the admit fast path pays one
        float compare between recomputes."""
        fresh = self._fresh_s()
        with self._stats_lock:
            mins: Dict[str, float] = {}
            next_expire = now + fresh
            for node, (snap, at) in list(self._peer_snaps.items()):
                age = now - at
                if age > max(fresh * 4, 30.0):
                    del self._peer_snaps[node]  # long-dead peer: drop it
                    continue
                if age > fresh:
                    continue  # stale: ignored but retained for SHOW rows
                next_expire = min(next_expire, at + fresh)
                for cls in ("TP", "AP"):
                    ent = snap.get(cls.lower())
                    if isinstance(ent, dict) and "limit" in ent:
                        lim = float(ent["limit"])
                        mins[cls] = min(mins.get(cls, lim), lim)
            self._cluster_min = mins
            self._cluster_expire = next_expire

    def effective_limit(self, cls: str) -> float:
        """The limit admit() enforces: the local AIMD limit clamped to the
        min of fresh peer limits when cluster admission is on.  Floors at
        ADMISSION_MIN_LIMIT — a peer's collapse throttles, never starves.
        Single-coordinator cost: one empty-dict check."""
        lim = self.limit(cls)
        if not self._peer_snaps:
            return lim
        if not self.instance.config.get("ENABLE_CLUSTER_ADMISSION"):
            return lim
        now = time.time()
        if now > self._cluster_expire:
            self._recompute_cluster(now)
        m = self._cluster_min.get(cls)
        if m is None or m >= lim:
            return lim
        floor = float(self._cfg_int(
            self.instance.config.get("ADMISSION_MIN_LIMIT"), 1))
        return max(floor, m)

    def peer_gossip_rows(self):
        """(node, snapshot, age_s) for SHOW COORDINATORS — stale peers
        included (the age column IS the staleness report)."""
        now = time.time()
        with self._stats_lock:
            return [(node, dict(snap), now - at)
                    for node, (snap, at) in sorted(self._peer_snaps.items())]

    # -- classification -------------------------------------------------------

    def classify(self, session, sql: str) -> Tuple[str, Optional[float], str]:
        """(class, predicted service ms | None, digest key).  Digest truth
        wins (the summary-fed cost map); unknown digests fall back to the
        heavy-SQL keyword guess."""
        digest = ""
        try:
            digest = session._digest_of(sql)
        except Exception:
            pass  # unparseable text classifies by heuristic; admit decides
        if digest:
            info = self._digest_cost.get(digest)
            if info is not None:
                return info[0], info[1], digest
        if "information_schema" in sql[:256].lower():
            return "TP", None, digest  # observability must stay reachable
        if _AP_GUESS_RE.search(sql):
            return "AP", None, digest
        return "TP", None, digest

    # -- admit / release ------------------------------------------------------

    def admit(self, session, sql: str) -> _Ticket:
        if not self.enabled(session, sql):
            return _NO_TICKET
        cls, predicted_ms, digest = self.classify(session, sql)
        # deadline-aware shed: remaining MAX_EXECUTION_TIME budget that
        # cannot cover the digest's predicted service time is dead work
        deadline = getattr(session, "_deadline", None)
        if deadline is not None and predicted_ms:
            remaining_ms = (deadline - time.time()) * 1000.0
            if remaining_ms < predicted_ms:
                self._shed("deadline", cls, digest,
                           f"remaining deadline {remaining_ms:.0f}ms cannot "
                           f"cover predicted {predicted_ms:.0f}ms",
                           retry_after_ms=int(predicted_ms))
        tier = self.governor.tier()
        if tier >= 2:
            # CRITICAL: shed load AND free memory — refuse the AP admission
            # and squeeze the largest resident query toward disk
            self.governor.revoke_largest_query()
            if cls == "AP":
                self._shed("memory", cls, digest,
                           "memory pressure CRITICAL: AP admission refused",
                           retry_after_ms=500)
        tokens = self._tokens[cls]
        tokens.append(None)  # optimistic claim (GIL-atomic)
        if len(tokens) <= self.effective_limit(cls):
            # idle/uncontended fast path: no lock was taken
            self.admitted[cls] += 1  # benign GIL race; aggregate insight
            return _Ticket(self, cls, digest)
        # over the limit: give the claim back and take the queued slow path
        self._pop_token(cls)
        return self._admit_queued(session, cls, digest, predicted_ms)

    def _pop_token(self, cls: str):
        try:
            self._tokens[cls].pop()
        except IndexError:  # pragma: no cover - bracket imbalance guard
            pass

    def _admit_queued(self, session, cls: str, digest: str,
                      predicted_ms: Optional[float]) -> _Ticket:
        qsize = self._cfg_int(
            self.instance.config.get("ADMISSION_QUEUE_SIZE"), 64)
        wait_s = self._cfg_int(
            self.instance.config.get("ADMISSION_WAIT_MS"), 1000) / 1000.0
        retry_ms = int(predicted_ms or 100)
        with self._cond:
            if self._nwait[cls] >= qsize:
                self._shed("queue_full", cls, digest,
                           f"{cls} admission queue full "
                           f"({self._nwait[cls]} waiting)",
                           retry_after_ms=retry_ms)
            self._nwait[cls] += 1
            self._update_queue_gauges()
            deadline = time.time() + wait_s
            try:
                while True:
                    tokens = self._tokens[cls]
                    if len(tokens) < self.effective_limit(cls):
                        tokens.append(None)
                        self.admitted[cls] += 1
                        return _Ticket(self, cls, digest)
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        self._shed("timeout", cls, digest,
                                   f"{cls} admission wait timed out "
                                   f"({wait_s * 1000:.0f}ms)",
                                   retry_after_ms=retry_ms)
                    self._cond.wait(remaining)
            finally:
                self._nwait[cls] -= 1
                self._update_queue_gauges()

    def _shed(self, reason: str, cls: str, digest: str, msg: str,
              retry_after_ms: int):
        with self._stats_lock:
            if reason == "queue_full":
                self.shed_queue_full += 1
            elif reason == "timeout":
                self.shed_timeout += 1
            elif reason == "deadline":
                self.shed_deadline += 1
            else:
                self.shed_memory += 1
        m = self.instance.metrics
        m.counter("admission_shed_total",
                  "queries refused by admission control (typed)").inc()
        m.counter(f"admission_shed_{reason}",
                  f"admission sheds: {reason}").inc()
        from galaxysql_tpu_torch.utils import events
        events.publish("admission_reject", msg, node=self.instance.node_id,
                       dedupe=f"adm-{reason}-{cls}",
                       reason=reason, workload=cls, digest=digest)
        raise errors.ServerOverloadError(
            f"server overloaded: {msg}; retry after {retry_after_ms}ms",
            retry_after_ms=retry_after_ms)

    def _on_release(self, ticket: _Ticket, workload: str, error: bool):
        self._pop_token(ticket.cls)
        if self._nwait["TP"] or self._nwait["AP"]:
            with self._cond:
                self._cond.notify_all()
        elapsed_ms = (time.time() - ticket.t0) * 1000.0
        cls = workload if workload in ("TP", "AP") else ticket.cls
        if ticket.digest:
            # feed the runtime truth back: next admission of this digest
            # classifies from observation, not the keyword guess
            prev = self._digest_cost.get(ticket.digest)
            ewma = elapsed_ms if prev is None \
                else 0.7 * prev[1] + 0.3 * elapsed_ms
            if len(self._digest_cost) > self.MAX_DIGESTS:
                self._digest_cost.clear()  # epoch reset, bounded
            self._digest_cost[ticket.digest] = (cls, ewma)
        if not error:
            self._aimd(cls, elapsed_ms)

    def _aimd(self, cls: str, elapsed_ms: float):
        """Additive-increase / multiplicative-decrease on the class limit,
        driven by the observed latency EWMA vs the class target."""
        with self._aimd_lock:
            self._ewma[cls] = elapsed_ms if self._ewma[cls] == 0.0 \
                else 0.8 * self._ewma[cls] + 0.2 * elapsed_ms
            self._since_adjust[cls] += 1
            if self._since_adjust[cls] < self.AIMD_SAMPLE:
                return
            self._since_adjust[cls] = 0
            lim = self.limit(cls)
            floor = float(self._cfg_int(
                self.instance.config.get("ADMISSION_MIN_LIMIT"), 1))
            if self._ewma[cls] > self._target_ms(cls):
                new = max(floor, lim * self.MD_FACTOR)
            elif len(self._tokens[cls]) >= lim * 0.75:
                # the limit is binding and latency is healthy: probe up
                new = min(self._limit_max.get(cls, lim * 4),
                          lim + self.AI_STEP)
            else:
                return
            if new != lim:
                self._limit[cls] = new
                self.instance.metrics.gauge(
                    f"admission_limit_{cls.lower()}",
                    f"adaptive {cls} admission concurrency limit").set(new)

    # -- observability --------------------------------------------------------

    def _update_queue_gauges(self):
        m = self.instance.metrics
        m.gauge("admission_queue_depth_tp",
                "TP queries waiting for an admission slot"
                ).set(self._nwait["TP"])
        m.gauge("admission_queue_depth_ap",
                "AP queries waiting for an admission slot"
                ).set(self._nwait["AP"])

    def _retry_budget_remaining(self) -> float:
        total = 0.0
        for client in getattr(self.instance, "workers", {}).values():
            b = getattr(client, "retry_budget", None)
            if b is not None:
                total += b.remaining()
        return total

    def stats_rows(self) -> List[Tuple[str, float]]:
        """(stat, value) rows for SHOW ADMISSION and the
        information_schema.admission_stats twin; refreshes the gauges."""
        tier = self.governor.tier()
        m = self.instance.metrics
        m.gauge("memory_pressure_tier",
                "memory governor tier (0=NORMAL 1=ELEVATED 2=CRITICAL)"
                ).set(tier)
        self._update_queue_gauges()
        budget = self._retry_budget_remaining()
        m.gauge("retry_budget_remaining",
                "retry-bucket tokens left across attached workers"
                ).set(budget)
        rows: List[Tuple[str, float]] = [
            ("enabled", 1.0 if self.enabled() else 0.0),
            ("memory_pressure_tier", float(tier)),
            ("memory_usage_frac", round(self.governor.usage(), 4)),
            ("retry_budget_remaining", budget),
        ]
        for cls in ("TP", "AP"):
            rows += [
                (f"{cls.lower()}_limit", float(self.limit(cls))),
                (f"{cls.lower()}_effective_limit",
                 float(self.effective_limit(cls))),
                (f"{cls.lower()}_inflight", float(len(self._tokens[cls]))),
                (f"{cls.lower()}_queue_depth", float(self._nwait[cls])),
                (f"{cls.lower()}_admitted", float(self.admitted[cls])),
                (f"{cls.lower()}_latency_ewma_ms",
                 round(self._ewma[cls], 3)),
            ]
        rows += [
            ("shed_queue_full", float(self.shed_queue_full)),
            ("shed_timeout", float(self.shed_timeout)),
            ("shed_deadline", float(self.shed_deadline)),
            ("shed_memory", float(self.shed_memory)),
        ]
        return rows
