"""Front router: the coordinator-plane serving tier.

Reference analog: the reference deployment puts a stateless front layer
ahead of N compute nodes (CN) sharing one GMS + DN set; any CN can serve
any statement, but plan caches, batch groups and txn state make *which*
CN matters.  This module is that layer for the repo: a `FrontRouter`
spreads statements over peer coordinators with two affinities —

- **session affinity**: a session that opened a transaction, created
  temp state or set session variables is pinned to its peer.  If that
  peer dies the statement fails typed (`CoordinatorUnavailableError`)
  exactly once — the peer-resident session state died with it and cannot
  be transparently replayed — then the session unpins and re-routes.
- **digest affinity**: stateless statements consistent-hash on the
  parameterized digest (`ParameterizedSql.cache_key`), so one statement
  shape keeps hitting one peer and its plan cache / PointPlan
  registrations / batch groups stay hot.  The ring walk skips peers that
  are down, fenced or under memory pressure (gossip piggybacks), so a
  sick peer sheds its shapes to ring successors without operator action.

Placement overrides the ring: a table whose dominant placement group is
bound to a coordinator (server/placement.py) routes to that peer — MOVE
PARTITION changes real locality across the serving tier.

Cluster-wide admission rides the same gossip: each tick exchanges
`AdmissionController.cluster_snapshot()` between peers through the
existing `health` sync action, so a flood shed on peer A clamps
admission on peer B (`effective_limit`).  Gossip is hub-free and
pull-based — any router instance relays the snapshots it has, and
ticks happen inline on the serving path (interval-gated, non-blocking),
so there is no background thread to leak.

Hatch: ENABLE_ROUTER param / GALAXYSQL_ROUTER=0 env.  When off the
router is structurally off-path — `RouterSession.execute` degrades to a
plain local `Session.execute` and `router_routed_queries` stays 0 — so
the single-coordinator path is bit-identical with the tier hatched off.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.events import publish

# process-level hatch (mirrors admission.ENABLED): the param hatch
# (ENABLE_ROUTER) reads live config, this one gates at import
ENABLED = os.environ.get("GALAXYSQL_ROUTER", "1") != "0"

# transport failures that trigger failover.  MySQLError / TddlError are
# app-level (the peer is alive and answered) and propagate untouched.
TRANSPORT_ERRORS = (ConnectionError, OSError, EOFError,
                    errors.WorkerUnavailableError, errors.ProtocolError)

# statements that create peer-resident session state -> pin the session.
# SET GLOBAL persists through the shared metadb (visible to every peer)
# so it does NOT pin; plain SET / BEGIN / START TRANSACTION / CREATE
# TEMPORARY do.
_PIN_RE = re.compile(
    r"^\s*(begin\b|start\s+transaction\b|create\s+temporary\b"
    r"|set\s+(?!global\b))", re.IGNORECASE)

# cheap table hint for placement routing: first FROM/INTO/UPDATE target
_TABLE_RE = re.compile(
    r"\b(?:from|into|update|join)\s+(?:([a-z_][\w$]*)\s*\.\s*)?"
    r"([a-z_][\w$]*)", re.IGNORECASE)

_DOWN_COOLDOWN_S = 2.0  # marked-down peer is skipped until gossip revives it


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


class InprocPeer:
    """A peer backed by an in-process `Instance` (tests, and the local
    coordinator itself).  `down=True` simulates a dead process: every
    call raises ConnectionError, exactly like a closed socket."""

    kind = "inproc"

    def __init__(self, instance, node_id: Optional[str] = None):
        self.instance = instance
        self.node_id = node_id or instance.node_id
        self.down = False
        # router-maintained gossip state
        self.down_until = 0.0
        self.epoch = -1
        self.mem_tier = 0
        self.groups: set = set()
        self.last_gossip_at = 0.0

    def _check(self):
        if self.down:
            raise ConnectionError(f"coordinator {self.node_id} is down")

    def open_session(self, schema: Optional[str] = None):
        self._check()
        from galaxysql_tpu_torch.server.session import Session
        return Session(self.instance, schema=schema)

    def execute(self, sess, sql: str):
        self._check()
        return sess.execute(sql)

    def close_session(self, sess):
        try:
            sess.close()
        except Exception:  # galaxylint: disable=swallow -- teardown is best-effort; the peer session dies with its owner
            pass

    def sync_action(self, action: str, payload: dict) -> dict:
        self._check()
        return self.instance.apply_sync_action(action, payload)

    def close(self):
        pass


class RemotePeer:
    """A peer coordinator in another process: statements over the MySQL
    wire (MiniClient per routed session), gossip over the dn sync wire
    (WorkerClient -> CoordinatorSyncListener), so FP_RPC_* failpoints,
    the circuit breaker and the retry budget govern coordinator gossip
    exactly as they govern worker RPCs."""

    kind = "remote"

    def __init__(self, node_id: str, host: str, port: int, sync_port: int,
                 config=None):
        from galaxysql_tpu_torch.net.dn import WorkerClient
        self.node_id = node_id
        self.host = host
        self.port = int(port)
        self._sync = WorkerClient(host, int(sync_port), timeout=10.0,
                                  config=config)
        self.down_until = 0.0
        self.epoch = -1
        self.mem_tier = 0
        self.groups: set = set()
        self.last_gossip_at = 0.0

    def open_session(self, schema: Optional[str] = None):
        from galaxysql_tpu_torch.net.client import MiniClient
        return MiniClient(self.host, self.port, database=schema, timeout=30.0)

    def execute(self, sess, sql: str):
        from galaxysql_tpu_torch.net.client import MySQLError
        from galaxysql_tpu_torch.server.session import ResultSet
        from galaxysql_tpu_torch.types import datatype as dt
        try:
            names, rows = sess.query(sql)
        except MySQLError as e:
            # app-level error from a live peer: re-raise typed so callers
            # see the same errno surface as a local execution
            err = errors.TddlError(e.message)
            err.errno = e.errno
            err.sqlstate = e.sqlstate
            raise err from None
        if not names:
            return ResultSet([], [], [])
        return ResultSet(list(names), [dt.VARCHAR] * len(names),
                         [tuple(r) for r in rows])

    def close_session(self, sess):
        try:
            sess.close()
        except Exception:  # galaxylint: disable=swallow -- teardown is best-effort; the wire session dies with its socket
            pass

    def sync_action(self, action: str, payload: dict) -> dict:
        return self._sync.sync_action(action, payload)

    def sync_broadcast(self, action: str, payload: dict, epoch: int,
                       deadline_ms: int = 0) -> dict:
        return self._sync.sync_broadcast(action, payload, epoch, deadline_ms)

    def close(self):
        try:
            self._sync.close()
        except Exception:  # galaxylint: disable=swallow -- teardown is best-effort; nothing outlives the socket
            pass


class FrontRouter:
    """Consistent-hash statement router over the peer coordinator set."""

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._gossip_lock = threading.Lock()
        self._gossip_at = 0.0
        self.local = InprocPeer(instance)
        self.peers: Dict[str, object] = {self.local.node_id: self.local}
        self._ring: List[Tuple[int, str]] = []
        self._ring_ver = -1
        # per-peer affinity accounting for SHOW COORDINATORS
        self._routed: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        # digest -> table hint memo (regex runs once per statement shape)
        self._tables: Dict[str, Optional[Tuple[str, str]]] = {}
        m = instance.metrics
        self.m_routed = m.counter(
            "router_routed_queries",
            "statements dispatched through the front router")
        self.m_hits = m.counter(
            "affinity_hits", "statements that landed on their affine peer")
        self.m_misses = m.counter(
            "affinity_misses",
            "statements re-routed off their affine peer (down/fenced/load)")
        self.m_failovers = m.counter(
            "router_failovers",
            "within-statement re-routes after a peer transport failure")
        self.m_staleness = m.gauge(
            "gossip_staleness_ms",
            "age of the oldest peer gossip snapshot held by this router")
        instance.router = self

    # -- membership -----------------------------------------------------------

    def enabled(self) -> bool:
        return ENABLED and bool(self.instance.config.get("ENABLE_ROUTER"))

    def add_peer(self, peer) -> None:
        with self._lock:
            self.peers[peer.node_id] = peer
            self._ring_ver = -1
        self.instance.attach_coordinator(peer.node_id, peer)

    def add_remote(self, host: str, port: int, sync_port: int):
        """Probe a remote coordinator for its node id, then join it."""
        from galaxysql_tpu_torch.net.dn import WorkerClient
        probe = WorkerClient(host, int(sync_port), timeout=10.0)
        try:
            resp = probe.sync_action("health", {})
        finally:
            probe.close()
        node_id = resp.get("node", f"{host}:{port}")
        peer = RemotePeer(node_id, host, port, sync_port,
                          config=self.instance.config)
        peer.epoch = int(resp.get("epoch", -1))
        peer.last_gossip_at = time.time()
        self.add_peer(peer)
        return peer

    def remove_peer(self, node_id: str, reason: str = "detach") -> None:
        with self._lock:
            peer = self.peers.pop(node_id, None)
            self._ring_ver = -1
        if peer is not None and peer is not self.local:
            self.instance.detach_coordinator(node_id, reason=reason)
            peer.close()

    def close(self):
        for node_id in [n for n in list(self.peers)
                        if n != self.local.node_id]:
            self.remove_peer(node_id, reason="shutdown")

    # -- ring -----------------------------------------------------------------

    def _ring_points(self) -> List[Tuple[int, str]]:
        if self._ring_ver != len(self.peers) or not self._ring:
            vnodes = max(1, int(self.instance.config.get("ROUTER_VNODES")))
            pts = []
            for node_id in self.peers:
                for v in range(vnodes):
                    pts.append((_hash(f"{node_id}#{v}"), node_id))
            pts.sort()
            self._ring = pts
            self._ring_ver = len(self.peers)
        return self._ring

    def _healthy(self, peer, now: float) -> bool:
        return now >= peer.down_until and peer.mem_tier < 2

    def ring_owner(self, digest: str) -> str:
        """The ring-preferred peer for a digest, health ignored — this is
        the affinity *target*; `targets_for` applies health."""
        ring = self._ring_points()
        h = _hash(digest)
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]

    def _table_hint(self, digest: str, sql: str,
                    schema: Optional[str]) -> Optional[Tuple[str, str]]:
        if digest not in self._tables:
            if len(self._tables) > 4096:
                self._tables.clear()
            m = _TABLE_RE.search(sql)
            if m and (m.group(1) or schema):
                self._tables[digest] = ((m.group(1) or schema).lower(),
                                        m.group(2).lower())
            else:
                self._tables[digest] = None
        return self._tables.get(digest)

    def targets_for(self, digest: str, sql: str = "",
                    schema: Optional[str] = None) -> List[object]:
        """Ordered candidate peers: placement-preferred first (if bound
        and healthy), then the ring owner and its successors, healthy
        peers before marked-down ones (a fully-down tier still yields
        candidates so the caller's failover loop produces the typed
        error, not an empty route)."""
        now = time.time()
        ring = self._ring_points()
        h = _hash(digest)
        # rotate the ring to start at the owner, dedup to peer order
        idx = 0
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        idx = lo % len(ring)
        order: List[str] = []
        for i in range(len(ring)):
            node_id = ring[(idx + i) % len(ring)][1]
            if node_id not in order:
                order.append(node_id)
            if len(order) == len(self.peers):
                break
        # placement override: a bound coordinator jumps the queue
        hint = self._table_hint(digest, sql, schema) if sql else None
        if hint is not None:
            try:
                pref = self.instance.placement.preferred_coordinator(*hint)
            except Exception:  # galaxylint: disable=swallow -- placement is advisory; a broken binding must not fail routing
                pref = None
            if pref and pref in self.peers and pref in order:
                order.remove(pref)
                order.insert(0, pref)
        peers = [self.peers[n] for n in order if n in self.peers]
        healthy = [p for p in peers if self._healthy(p, now)]
        sick = [p for p in peers if not self._healthy(p, now)]
        return healthy + sick or peers

    # -- accounting -----------------------------------------------------------

    def note_routed(self, node_id: str, affine: bool) -> None:
        self.m_routed.inc()
        self._routed[node_id] = self._routed.get(node_id, 0) + 1
        if affine:
            self.m_hits.inc()
            self._hits[node_id] = self._hits.get(node_id, 0) + 1
        else:
            self.m_misses.inc()

    def affinity_of(self, node_id: str) -> Tuple[int, int, float]:
        routed = self._routed.get(node_id, 0)
        hits = self._hits.get(node_id, 0)
        return routed, hits, (hits / routed) if routed else 1.0

    def mark_down(self, peer, exc: Exception) -> None:
        peer.down_until = time.time() + _DOWN_COOLDOWN_S
        self.m_failovers.inc()
        publish("coordinator_left",
                f"{peer.node_id} unreachable: {type(exc).__name__}",
                node=peer.node_id)

    # -- gossip ---------------------------------------------------------------

    def maybe_gossip(self, now: Optional[float] = None) -> bool:
        """Interval-gated inline gossip: pulls `health` from every remote
        peer, relaying every admission snapshot this router holds (its
        own + third-party peers'), so N routers converge without a hub.
        Non-blocking: a concurrent tick skips."""
        now = time.time() if now is None else now
        interval = float(self.instance.config.get("ROUTER_GOSSIP_INTERVAL_S"))
        if now - self._gossip_at < interval:
            return False
        if not self._gossip_lock.acquire(blocking=False):
            return False
        try:
            self._gossip_at = now
            self.gossip_tick(now)
            return True
        finally:
            self._gossip_lock.release()

    def gossip_tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        adm = self.instance.admission
        relay = {self.local.node_id: adm.cluster_snapshot()}
        for node, snap, _age in adm.peer_gossip_rows():
            relay.setdefault(node, snap)
        for peer in list(self.peers.values()):
            if peer is self.local:
                peer.last_gossip_at = now
                continue
            try:
                resp = peer.sync_action("health", {"peer_admission": relay})
            except TRANSPORT_ERRORS as e:
                if now >= peer.down_until:
                    self.mark_down(peer, e)
                continue
            peer.down_until = 0.0  # gossip revives a marked-down peer
            peer.epoch = int(resp.get("epoch", peer.epoch))
            peer.last_gossip_at = now
            peer.groups = set(resp.get("groups") or [])
            wl = getattr(peer, "_sync", None)
            if wl is not None:
                peer.mem_tier = int(getattr(wl, "load_tier", 0) or 0)
            snap = resp.get("admission")
            if isinstance(snap, dict):
                adm.note_peer(peer.node_id, snap, at=now)
        oldest = min((p.last_gossip_at for p in self.peers.values()),
                     default=now)
        self.m_staleness.set(max(0.0, (now - oldest) * 1000.0))

    def staleness_ms(self) -> float:
        return float(self.m_staleness.value)


class RouterSession:
    """Session facade over the serving tier: the object a front listener
    holds per client connection.  Stateless statements ride the digest
    ring with within-statement failover; state-creating statements pin
    the session to the peer that holds the state."""

    _SHOW_TRACE_RE = re.compile(r"^\s*show\s+trace\s*;?\s*$", re.IGNORECASE)

    def __init__(self, router: FrontRouter, schema: Optional[str] = None):
        self.router = router
        self.schema = schema
        self.pinned: Optional[str] = None
        self._backends: Dict[str, object] = {}  # node_id -> peer session
        # router-side span tree of the last routed statement (grafted with
        # the peer's retained spans when the trace was pulled back) — SHOW
        # TRACE renders the cluster path from here, not from whichever peer
        # the SHOW statement itself would hash to
        self.last_spans: List[object] = []
        self.last_trace_id = 0

    # -- backend session cache ------------------------------------------------

    def _backend(self, peer):
        sess = self._backends.get(peer.node_id)
        if sess is None:
            sess = peer.open_session(self.schema)
            self._backends[peer.node_id] = sess
        return sess

    def _drop_backend(self, peer) -> None:
        sess = self._backends.pop(peer.node_id, None)
        if sess is not None:
            peer.close_session(sess)

    def close(self) -> None:
        for node_id, sess in list(self._backends.items()):
            peer = self.router.peers.get(node_id)
            if peer is not None:
                peer.close_session(sess)
        self._backends.clear()

    # -- execute --------------------------------------------------------------

    def execute(self, sql: str):
        router = self.router
        if not router.enabled():
            # hatch: structurally off-path — no routing, no ring, no
            # router metrics; bit-identical local execution
            return router.local.execute(self._backend(router.local), sql)
        if self.last_spans and self._SHOW_TRACE_RE.match(sql):
            # the last routed statement's trace lives HERE (the grafted
            # router -> peer -> worker path); digest affinity would hash
            # SHOW TRACE to an arbitrary peer that never saw it
            from galaxysql_tpu_torch.server.session import ResultSet
            from galaxysql_tpu_torch.types import datatype as dt
            from galaxysql_tpu_torch.utils import tracing
            lines = [f"trace-id {self.last_trace_id}"]
            lines += tracing.span_tree_lines(self.last_spans)
            return ResultSet(["Trace"], [dt.VARCHAR], [(t,) for t in lines])
        router.maybe_gossip()
        if self.pinned is not None:
            return self._execute_pinned(sql)
        return self._execute_routed(sql)

    def _execute_pinned(self, sql: str):
        router = self.router
        peer = router.peers.get(self.pinned)
        now = time.time()
        if peer is None or getattr(peer, "down", False) or \
                now < peer.down_until:
            node = self.pinned
            self.pinned = None  # fail typed ONCE, then re-route
            self._backends.pop(node, None)
            raise errors.CoordinatorUnavailableError(
                f"pinned coordinator {node} is unavailable; session state "
                f"lost, session unpinned")
        try:
            rs = self._peer_exec(peer, sql)
        except TRANSPORT_ERRORS as e:
            router.mark_down(peer, e)
            node = self.pinned
            self.pinned = None
            self._drop_backend(peer)
            raise errors.CoordinatorUnavailableError(
                f"pinned coordinator {node} died mid-statement: "
                f"{type(e).__name__}; session state lost, session "
                f"unpinned") from e
        router.note_routed(peer.node_id, affine=True)
        return rs

    # -- cross-peer tracing ----------------------------------------------------

    def _peer_exec(self, peer, sql: str, digest: Optional[str] = None):
        """Execute on a peer, carrying trace context across the hop.

        Local (inproc) execution traces natively — same thread, same
        instance, the peer Session's own TraceContext — so only remote
        hops pay the wrap: mint a router-side trace, prefix the statement
        with a `/*trace:id:parent:node:sampled*/` hint (the peer session
        adopts the id and strips the hint BEFORE digesting), and when the
        trace retains — the router's propagated head-sampling decision, a
        slow hop, or an app-level error — pull the peer's retained tree
        back over the sync wire and graft it under the route span, so one
        trace id renders router -> coordinator -> worker."""
        router = self.router
        sess = self._backend(peer)
        if peer is router.local:
            self.last_spans = []  # SHOW TRACE falls through to the session
            return peer.execute(sess, sql)
        inst = router.instance
        from galaxysql_tpu_torch.utils import tracing
        if not (tracing.ALWAYS_ON
                and bool(inst.config.get("ENABLE_QUERY_TRACING"))):
            return peer.execute(sess, sql)
        store = getattr(inst, "trace_store", None)
        if digest is None:  # pinned statements skip the routing digest
            from galaxysql_tpu_torch.sql.parameterize import parameterize
            from galaxysql_tpu_torch.meta.statement_summary import digest_key
            digest = digest_key(self.schema or "",
                                parameterize(sql).cache_key)
        # the router's sampling decision rides the hint (the W3C sampled
        # flag idea): the peer force-retains under OUR id, so the exact-id
        # pull below cannot miss
        sampled = store is not None and store.sampler.decide(digest)
        tid = inst.trace_ids.next()
        tc = tracing.TraceContext(tid, node=inst.node_id)
        root = tc.begin("route", kind="query", peer=peer.node_id,
                        digest=digest)
        hint = (f"/*trace:{tid}:{root.span_id}:{inst.node_id}:"
                f"{1 if sampled else 0}*/")
        app_err = ""
        answered = False
        try:
            rs = peer.execute(sess, hint + sql)
            answered = True
            return rs
        except TRANSPORT_ERRORS:
            raise  # peer is gone — nothing to pull, caller fails over
        except errors.TddlError as e:
            # app-level failure from a live peer: the peer tail-retained
            # its trace under our id — still pullable evidence
            answered = True
            app_err = f"{type(e).__name__}: {e}"
            raise
        finally:
            tc.end(root)
            elapsed_ms = root.dur_us / 1000.0
            slow_ms = inst.config.get("SLOW_SQL_MS")
            slow = (slow_ms is not None and slow_ms >= 0
                    and elapsed_ms >= float(slow_ms))
            self.last_spans = list(tc.spans)
            self.last_trace_id = tid
            if answered and store is not None and \
                    (sampled or slow or app_err):
                reason = "error" if app_err else \
                    ("slow" if slow else "sampled")
                self._graft_peer_trace(peer, tc, root, tid, digest, sql,
                                       elapsed_ms, reason, app_err, store)

    def _graft_peer_trace(self, peer, tc, root, tid, digest, sql,
                          elapsed_ms, reason, error, store) -> None:
        """Pull the peer's retained trace by exact id, graft it under the
        route span, and retain the assembled cluster path locally (so the
        router's /trace/<id>, SHOW TRACE and flight recorder all see it)."""
        from galaxysql_tpu_torch.utils import tracing
        inst = self.router.instance
        try:
            resp = peer.sync_action("health", {"trace_id": tid})
        except TRANSPORT_ERRORS:
            resp = {}  # evidence pull is best-effort; the statement result
            #            already returned — keep the router-side spans
        rtd = resp.get("trace") if isinstance(resp, dict) else None
        if rtd and rtd.get("spans"):
            tc.graft(list(rtd["spans"]), parent=root.span_id)
            self.last_spans = list(tc.spans)
        rt = tracing.RetainedTrace(
            trace_id=tid, digest=digest,
            sql=str((rtd or {}).get("sql") or sql)[:512],
            schema=self.schema or "",
            workload=str((rtd or {}).get("workload") or ""),
            elapsed_ms=round(elapsed_ms, 3),
            error=str(error or (rtd or {}).get("error") or "")[:256],
            reason=reason, node=inst.node_id, at=time.time(),
            phases=dict((rtd or {}).get("phases") or {}),
            spans=[s.to_dict() for s in tc.spans])
        store.put(rt)

    def _execute_routed(self, sql: str):
        from galaxysql_tpu_torch.sql.parameterize import parameterize
        from galaxysql_tpu_torch.meta.statement_summary import digest_key
        router = self.router
        digest = digest_key(self.schema or "", parameterize(sql).cache_key)
        targets = router.targets_for(digest, sql, self.schema)
        pin = _PIN_RE.match(sql) is not None
        last_exc: Optional[Exception] = None
        for i, peer in enumerate(targets):
            try:
                rs = self._peer_exec(peer, sql, digest)
            except TRANSPORT_ERRORS as e:
                router.mark_down(peer, e)
                self._drop_backend(peer)
                last_exc = e
                continue  # re-route within the statement
            router.note_routed(peer.node_id, affine=(i == 0))
            if pin:
                self.pinned = peer.node_id
            return rs
        raise errors.CoordinatorUnavailableError(
            f"no coordinator reachable for statement (tried "
            f"{len(targets)} peers)") from last_exc
