"""Scheduled background jobs.

Reference analog: `executor/scheduler` (SURVEY.md §2.6) — cron-style jobs persisted in
the metadb (`scheduled_jobs` + `fired_scheduled_jobs`, Appendix B): local-partition/TTL
rotation, OSS purge, statistics refresh.  Interval-based here (cron parsing adds
nothing for an embedded engine); each fire is recorded so SHOW-style introspection and
at-most-once semantics per interval hold across restarts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

_JOBS_SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduled_jobs (
    job_name TEXT PRIMARY KEY, job_kind TEXT, schema_name TEXT, table_name TEXT,
    params_json TEXT, interval_s REAL, enabled INTEGER, last_fire REAL);
CREATE TABLE IF NOT EXISTS fired_scheduled_jobs (
    job_name TEXT, fired_at REAL, status TEXT, detail TEXT);
"""

_KIND_REGISTRY: Dict[str, Callable] = {}


def job_kind(name: str):
    def deco(fn):
        _KIND_REGISTRY[name] = fn
        return fn
    return deco


@job_kind("ttl_archive")
def _run_ttl_archive(instance, schema: str, table: str, params: dict) -> str:
    """TTL rotation: archive rows whose DATE column is older than ttl_days."""
    from galaxysql_tpu_torch.types import temporal
    cutoff = temporal.days_from_civil(*time.gmtime()[:3]) - int(params["ttl_days"])
    n = instance.archive.archive_older_than(instance, schema, table,
                                            params["column"], cutoff)
    return f"archived {n} rows"


@job_kind("analyze")
def _run_analyze(instance, schema: str, table: str, params: dict) -> str:
    from galaxysql_tpu_torch.server.session import Session
    s = Session(instance, schema)
    try:
        s.execute(f"ANALYZE TABLE `{table}`")
    finally:
        s.close()
    return "statistics refreshed"


@job_kind("rebalance")
def _run_rebalance(instance, schema: str, table: str, params: dict) -> str:
    """Maintain-loop tick of the heat-driven balancer (server/balancer.py):
    propose partition split/merge/move from observed heat and execute at most
    one per tick.  Yields (proposes nothing) under admission pressure."""
    props = instance.balancer.run_once(schema or None, table or None,
                                       apply=bool(params.get("apply", True)))
    if not props:
        return "balanced (no proposals)"
    first = props[0]
    applied = f" job={first.get('job_id')}" if first.get("applied") else \
        f" NOT applied ({first.get('error', 'apply=0')})"
    return (f"{len(props)} proposal(s); first: {first['op']} "
            f"{first['table']} p{first['pids']}{applied}")


@job_kind("purge_tx_log")
def _run_purge_tx_log(instance, schema: str, table: str, params: dict) -> str:
    keep_s = float(params.get("keep_seconds", 86400))
    cutoff = time.time() - keep_s
    if instance.data_dir:
        # presumed-abort boot recovery resolves provisional stamps in the LAST
        # CHECKPOINT against this log: an entry may only be purged once a later
        # checkpoint has persisted the txn's final stamps — wall clock alone
        # would let recovery roll back a committed txn from a stale npz
        mark = instance.metadb.kv_get("last_checkpoint_at")
        if mark is None:
            return "purged 0 entries (no checkpoint yet)"
        cutoff = min(cutoff, float(mark))
    cur = instance.metadb.execute(
        "DELETE FROM global_tx_log WHERE state IN ('DONE','ABORTED') "
        "AND updated < ?", (cutoff,))
    return f"purged {cur.rowcount} entries"


class ScheduledJobManager:
    """Registers jobs in the metadb and fires due ones (leader-CN polling model)."""

    def __init__(self, instance):
        self.instance = instance
        with instance.metadb._lock:
            instance.metadb._conn.executescript(_JOBS_SCHEMA)
            instance.metadb._conn.commit()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- registry ------------------------------------------------------------

    def register(self, name: str, kind: str, schema: str, table: str,
                 params: dict, interval_s: float, enabled: bool = True):
        import json
        if kind not in _KIND_REGISTRY:
            from galaxysql_tpu_torch.utils import errors
            raise errors.TddlError(f"unknown job kind '{kind}'")
        self.instance.metadb.execute(
            "INSERT OR REPLACE INTO scheduled_jobs VALUES (?,?,?,?,?,?,?,?)",
            (name, kind, schema, table, json.dumps(params), interval_s,
             int(enabled), 0.0))

    def drop(self, name: str) -> bool:
        cur = self.instance.metadb.execute(
            "DELETE FROM scheduled_jobs WHERE job_name=?", (name,))
        return cur.rowcount > 0

    def jobs(self) -> List[Tuple]:
        return self.instance.metadb.query(
            "SELECT job_name, job_kind, schema_name, table_name, interval_s, "
            "enabled, last_fire FROM scheduled_jobs ORDER BY job_name")

    def history(self, name: Optional[str] = None) -> List[Tuple]:
        if name:
            return self.instance.metadb.query(
                "SELECT job_name, fired_at, status, detail FROM "
                "fired_scheduled_jobs WHERE job_name=? ORDER BY fired_at", (name,))
        return self.instance.metadb.query(
            "SELECT job_name, fired_at, status, detail FROM fired_scheduled_jobs "
            "ORDER BY fired_at")

    # -- firing ------------------------------------------------------------------

    def run_due(self, now: Optional[float] = None) -> List[str]:
        """Fire every enabled job whose interval has elapsed; returns fired names."""
        import json
        now = now if now is not None else time.time()
        # leader-only: with several coordinators sharing one GMS, background
        # jobs fire on exactly one (HA re-elects when the leader's heartbeat
        # ages out — StorageHaManager/leader-key analog)
        if not self.instance.ha.is_leader():
            return []
        fired = []
        for name, kind, schema, table, params_json, interval_s, enabled, last in \
                self.instance.metadb.query(
                    "SELECT job_name, job_kind, schema_name, table_name, "
                    "params_json, interval_s, enabled, last_fire "
                    "FROM scheduled_jobs"):
            if not enabled or now - last < interval_s:
                continue
            # claim the slot first (at-most-once per interval, even if we crash);
            # a concurrent poller that lost the conditional UPDATE must not fire
            cur = self.instance.metadb.execute(
                "UPDATE scheduled_jobs SET last_fire=? WHERE job_name=? "
                "AND last_fire=?", (now, name, last))
            if cur.rowcount == 0:
                continue
            try:
                detail = _KIND_REGISTRY[kind](self.instance, schema, table,
                                              json.loads(params_json))
                status = "SUCCESS"
            except Exception as e:  # jobs must never kill the scheduler
                detail = f"{type(e).__name__}: {e}"
                status = "FAILED"
            self.instance.metadb.execute(
                "INSERT INTO fired_scheduled_jobs VALUES (?,?,?,?)",
                (name, now, status, detail[:512]))
            fired.append(name)
        return fired

    def start(self, poll_interval_s: float = 5.0):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(poll_interval_s):
                try:
                    self.run_due()
                except Exception:
                    pass
                # SLO-plane sampler rides the same maintain poll but is
                # per-node, NOT leader-gated like run_due: every node keeps
                # its own history (interval-gated inside slo_tick)
                try:
                    self.instance.slo_tick()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="scheduled-jobs")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
