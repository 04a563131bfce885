"""HA: a liveness monitor that ACTS on the heartbeats the GMS already records.

Reference analog: `polardbx-gms/.../gms/ha/impl/StorageHaManager.java:82,1203`
(storage liveness driving failover) + `mpp/discover/PolarDBXNodeStatusManager`
(node status feeding the MPP scheduler).  Three observable behaviors:

1. **Node states.**  `check()` classifies every `node_info` row as ALIVE or
   DEAD by heartbeat age and reports transitions (listeners fire on change).
2. **Leader election for the scheduler role.**  Among ALIVE coordinator rows
   the smallest node_id is leader (deterministic, no extra consensus — the
   shared GMS is the ground truth, like the reference's leader key in metadb).
   `ScheduledJobManager.run_due` consults `is_leader()` so background jobs
   fire exactly once across a fleet sharing one metadb.
3. **Worker fencing.**  Attached remote workers are probed; a worker whose
   probe fails is fenced — remote scans REFUSE fast with a clear error instead
   of hanging on a dead socket — and unfenced on the next successful probe.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS

FP_HB_STALE = "FP_HB_STALE"  # test hook: treat a node's heartbeat as ancient


class HaManager:
    def __init__(self, instance, heartbeat_timeout_s: float = 30.0):
        self.instance = instance
        self.timeout = heartbeat_timeout_s
        self.states: Dict[str, str] = {}          # node_id -> ALIVE | DEAD
        self.listeners: List[Callable[[str, str, str], None]] = []
        self._fenced: Dict[Tuple[str, int], bool] = {}  # worker addr -> fenced
        self._lock = threading.Lock()

    # -- node liveness -------------------------------------------------------

    def heartbeat(self):
        """Refresh this node's own heartbeat row."""
        self.instance.metadb.heartbeat(self.instance.node_id, "coordinator",
                                       "127.0.0.1", 0)

    def check(self, now: Optional[float] = None) -> List[Tuple[str, str, str]]:
        """Classify every node; returns [(node_id, old_state, new_state)]
        transitions and fires listeners on each."""
        now = now if now is not None else time.time()
        transitions = []
        rows = self.instance.metadb.query(
            "SELECT node_id, role, heartbeat FROM node_info")
        with self._lock:
            for node_id, role, hb in rows:
                stale = FAIL_POINTS.value(FP_HB_STALE)
                if stale is not None and (stale is True or stale == node_id):
                    hb = 0.0  # failpoint: treat this node's heartbeat as ancient
                new = "ALIVE" if now - hb < self.timeout else "DEAD"
                old = self.states.get(node_id)
                if old != new:
                    self.states[node_id] = new
                    transitions.append((node_id, old or "UNKNOWN", new))
        for t in transitions:
            for fn in self.listeners:
                fn(*t)
        return transitions

    def alive_nodes(self, role: Optional[str] = None) -> List[str]:
        rows = self.instance.metadb.query(
            "SELECT node_id, role FROM node_info ORDER BY node_id")
        with self._lock:
            return [n for n, r in rows
                    if self.states.get(n) == "ALIVE" and
                    (role is None or r == role)]

    # -- leader election (scheduler role) ------------------------------------

    def leader(self) -> Optional[str]:
        """Smallest ALIVE coordinator node_id: deterministic given shared GMS
        state, re-elected implicitly when the old leader's heartbeat ages out."""
        alive = self.alive_nodes(role="coordinator")
        return alive[0] if alive else None

    def is_leader(self) -> bool:
        self.check()
        lead = self.leader()
        # nobody alive (bootstrap, all stale): act rather than deadlock
        return lead is None or lead == self.instance.node_id

    # -- worker fencing ------------------------------------------------------

    def probe_workers(self) -> Dict[Tuple[str, int], bool]:
        """Ping every attached worker; fence the dead, unfence the recovered."""
        results = {}
        recovered = False
        for client in getattr(self.instance, "workers", {}).values():
            ok = client.ping()
            addr = client.addr
            with self._lock:
                was = self._fenced.get(addr, False)
                self._fenced[addr] = not ok
            if was and ok:
                recovered = True
                for fn in self.listeners:
                    fn(f"worker:{addr[0]}:{addr[1]}", "DEAD", "ALIVE")
            elif not was and not ok:
                for fn in self.listeners:
                    fn(f"worker:{addr[0]}:{addr[1]}", "ALIVE", "DEAD")
        if recovered:
            # a returning worker may hold in-doubt XA branches whose outcome
            # this coordinator already logged — resolve them NOW, not on the
            # next manual recovery call (XARecoverTask runs on reconnect too)
            try:
                self.instance.xa_coordinator.recover_remote()
            except Exception:
                pass  # probing must never fail because recovery hiccuped
        return dict(self._fenced)

    def worker_fenced(self, addr: Tuple[str, int]) -> bool:
        with self._lock:
            return self._fenced.get(addr, False)

    def fence_worker(self, addr: Tuple[str, int], fenced: bool = True):
        with self._lock:
            self._fenced[addr] = fenced
