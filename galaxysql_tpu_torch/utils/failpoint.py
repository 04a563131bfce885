"""Fail-point injection framework.

Reference analog: `executor/utils/failpoint/FailPoint.java:63-111` (SURVEY.md §4) —
no-op unless a key is armed (there via session vars `set @FP_X=...`); used by DDL
crash-recovery tests to kill execution between tasks.

The network-plane keys (FP_RPC_*) drive the chaos harness (tests/test_chaos.py):
they are consulted inside `net/dn.WorkerClient.request` / `net/worker.Worker.handle`
and accept OP-SCOPED arm values so a schedule can say "drop the reply leg of the
next dml" without touching reads.  Arm-value forms for the RPC keys:

- True            applies to every op
- "dml"           applies to that op only
- int n           applies to the first n matching hits, then auto-exhausts
- {"op": "dml", "n": 1, "leg": "reply", "ms": 50}
                  full form: op filter, hit budget, request/reply leg
                  (FP_RPC_DROP), delay milliseconds (FP_RPC_DELAY_MS)
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

FP_BEFORE_DDL_TASK = "FP_BEFORE_DDL_TASK"
FP_AFTER_DDL_TASK = "FP_AFTER_DDL_TASK"
FP_BEFORE_COMMIT = "FP_BEFORE_COMMIT"
FP_BACKFILL_PAUSE = "FP_BACKFILL_PAUSE"
# armed with a key VALUE: the batch scheduler fails exactly that key's
# sessions inside a flush (error-isolation testing, server/batch_scheduler.py)
FP_BATCH_POISON_KEY = "FP_BATCH_POISON_KEY"
# armed with a key VALUE: the DML batch scheduler fails exactly that key's
# sessions inside a write flush — the duplicate-key/constraint-violation
# stand-in proving per-session error isolation (server/dml_batch.py)
FP_DML_POISON_KEY = "FP_DML_POISON_KEY"
# sleep N ms inside the async applier before each task batch
# (txn/async_apply.py): makes the GSI/replica apply lag observable so the
# read-your-writes fence is actually exercised
FP_APPLY_DELAY_MS = "FP_APPLY_DELAY_MS"

# -- network-plane faults (coordinator-side unless noted) ---------------------
# drop the request or reply leg of an RPC: the socket dies mid-exchange.  A
# reply-leg drop is the double-apply trap — the worker HAS executed the op
# when the coordinator's retry fires (dedupe-window territory).
FP_RPC_DROP = "FP_RPC_DROP"
# sleep N ms before sending (slow network / slow worker; deadline fodder)
FP_RPC_DELAY_MS = "FP_RPC_DELAY_MS"
# fail the next N matching requests with a transport error before send
FP_RPC_FAIL_N = "FP_RPC_FAIL_N"
# WORKER-side: the worker process exits hard on the next matching op
# (armed remotely via the `failpoint` sync action)
FP_WORKER_CRASH = "FP_WORKER_CRASH"
# WORKER-side slow drain (overload harness): the worker sleeps N ms inside
# every matching request — a busy/brownout worker, not a dead one, so
# breakers stay closed while queue depth and RTT climb.  Armed remotely via
# the `failpoint` sync action; dict form {"ms": 50, "op": "exec_sql"}.
FP_WORKER_SLOW_DRAIN = "FP_WORKER_SLOW_DRAIN"
# host memory-pressure injection (overload harness): overrides the memory
# governor's computed tier.  Arm value: "elevated" | "critical" | a float
# usage fraction (e.g. 0.95) fed through the normal thresholds.
FP_MEM_PRESSURE = "FP_MEM_PRESSURE"
# -- elastic rebalancing (ddl/rebalance.py) ----------------------------------
# crash inside the shadow backfill's chunk loop, AFTER the [src, offset]
# checkpoint persisted (crash-resume granularity proof)
FP_REBALANCE_CHUNK = "FP_REBALANCE_CHUNK"
# crash inside the CDC catchup loop, between event pages (the persisted seq
# watermark makes the re-applied page idempotent)
FP_REBALANCE_CATCHUP = "FP_REBALANCE_CATCHUP"
# force the verify gate to see a checksum mismatch: drives the engine's
# REAL TddlError -> reverse-order-undo path (rollback restores the source)
FP_REBALANCE_VERIFY_MISMATCH = "FP_REBALANCE_VERIFY_MISMATCH"
# crash inside the cutover critical section BEFORE the partition/router swap
# (resume must redo the final catchup + swap)
FP_REBALANCE_BEFORE_SWAP = "FP_REBALANCE_BEFORE_SWAP"
# crash AFTER the swap + durable cutover marker but before cache
# invalidation/cleanup (resume must detect the swap already happened and
# NOT re-run it)
FP_REBALANCE_AFTER_SWAP = "FP_REBALANCE_AFTER_SWAP"

# lockdep witness proof (tests/test_lint.py): the DML insert ramp performs a
# DELIBERATE partition-lock -> append_lock acquisition (the reverse of the
# canonical order) so the runtime lock-order witness provably trips on a
# real engine code path (storage/table_store.py `_lockdep_probe`)
FP_LOCK_INVERT = "FP_LOCK_INVERT"

# SLO-plane burn-rate determinism (server/session.py _finish_query): pad the
# OBSERVED elapsed time of matching finished queries without sleeping — arm
# with an int (pad every query by N ms) or a dict
# {"ms": N, "workload": "TP", "schema": "s"} to scope the inflation to one
# digest class / tenant; feeds the latency histogram, statement summary and
# the SLO engine's recent-p99 windows deterministically
FP_SLO_LATENCY_MS = "FP_SLO_LATENCY_MS"


class FailPointError(RuntimeError):
    """Raised by an armed fail point (simulated crash)."""


class _FailPoints:
    def __init__(self):
        self._armed: Dict[str, Any] = {}
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()
        # lock-free fast gate: hot paths (the RPC layer) check this plain
        # bool and skip the locked lookup entirely when nothing is armed
        self.active = False

    def arm(self, key: str, value: Any = True):
        with self._lock:
            self._armed[key] = value
            self._hits[key] = 0
            self.active = True

    def disarm(self, key: str):
        with self._lock:
            self._armed.pop(key, None)
            self.active = bool(self._armed)

    def clear(self):
        with self._lock:
            self._armed.clear()
            self._hits.clear()
            self.active = False

    def value(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._armed.get(key)

    def inject(self, key: str, detail: str = ""):
        """Raise FailPointError if `key` is armed.  Armed value semantics:
        True -> fire always; int n -> fire on the n-th hit (1-based)."""
        with self._lock:
            v = self._armed.get(key)
            if v is None:
                return
            self._hits[key] = self._hits.get(key, 0) + 1
            hits = self._hits[key]
        if v is True or (isinstance(v, int) and hits == v):
            raise FailPointError(f"failpoint {key} fired ({detail})")

    def rpc_spec(self, key: str, op: str) -> Optional[dict]:
        """Match an RPC-plane key against `op`; returns the normalized spec
        dict ({"leg","ms",...}) when it applies to THIS hit, else None.

        Int-budget arms ({"n": k} / bare int) consume one unit per matching
        hit and auto-disarm at zero, so "fail the next 2 dml requests" is a
        one-liner in a chaos schedule."""
        with self._lock:
            v = self._armed.get(key)
            if v is None:
                return None
            spec: dict
            if v is True:
                spec = {}
            elif isinstance(v, str):
                if v != op:
                    return None
                spec = {}
            elif isinstance(v, int):
                spec = {"n": v}
            elif isinstance(v, dict):
                spec = dict(v)
                want = spec.get("op")
                if want is not None and want != op:
                    return None
            else:
                return None
            n = spec.get("n")
            if n is not None:
                if n <= 0:
                    return None
                n -= 1
                # write back the decremented budget in the SAME value shape
                # (an exhausted arm stays visible until disarm/clear but no
                # longer fires)
                if isinstance(v, dict):
                    v = dict(v)
                    v["n"] = n
                else:
                    v = n
                self._armed[key] = v
            self._hits[key] = self._hits.get(key, 0) + 1
            return spec


FAIL_POINTS = _FailPoints()
