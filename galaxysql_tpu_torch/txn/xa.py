"""Two-phase commit over table-store participants, the commit-point log and recovery
(port of `galaxysql_tpu/txn/xa.py`).

A participant is one TableStore's share of a session transaction: the row ranges
the transaction appended with provisional (`-txn_id`) begin stamps and the rows it
stamped provisionally deleted.  COMMIT stamps both with one commit timestamp from
the TSO; ROLLBACK stamps its own inserts permanently dead (begin = INFINITY,
end = 0) and restores the end stamps its deletes replaced.  Each ends with a table
version bump, so plans, scan metadata and cached device lanes of the old stamps miss.

The commit point is the `global_tx_log` COMMITTED row in the instance's metadb
(`meta/gms.py`, a sqlite file under `Instance(data_dir)`): a coordinator that dies
before it leaves a transaction that recovery rolls back; after it, recovery
re-commits at the logged timestamp.  `GroupCommitGate` allocates the commit
timestamps and writes those rows for concurrent committers in one metadb
transaction; `TwoPhaseCoordinator` runs `TRANSACTION_POLICY = 'XA'` (prepare, log
PREPARED, commit point, commit, DONE) and `recover()` resolves its in-doubt
registry within the process; `recover_persisted` resolves the provisional stamps a
booted instance loaded from disk.

A transaction that wrote a table a worker process holds has a branch there
(`RemoteBranchParticipant`, driven over the RPC plane with the worker's xa_prepare /
xa_commit / xa_rollback): `commit` prepares and commits the local participants and
the worker branches together, and `recover_remote` decides the branches a restarted
worker reports in doubt from this coordinator's commit-point log.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

import numpy as np

from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_BEFORE_COMMIT


class StoreParticipant:
    """One store's share of a transaction: the provisional rows it must finalize."""

    def __init__(self, store, txn_id: int):
        self.store = store
        self.txn_id = txn_id
        self.inserted: List = []   # (pid, start, n)
        self.deleted: List = []    # (pid, row_ids, old_end)
        self.prepared = False

    def prepare(self) -> bool:
        """Phase 1: every provisional stamp is still ours (a competing writer would
        have raised earlier; this is the structural XA PREPARE)."""
        own = -self.txn_id
        for pid, start, n in self.inserted:
            p = self.store.partitions[pid]
            with p.lock:
                if not (p.begin_ts[start:start + n] == own).all():
                    return False
        for pid, row_ids, _old in self.deleted:
            p = self.store.partitions[pid]
            with p.lock:
                cur = p.end_ts[row_ids]
                if not ((cur == own) | (cur >= 0)).all():
                    return False
        self.prepared = True
        return True

    def commit(self, commit_ts: int):
        own = -self.txn_id
        for pid, start, n in self.inserted:
            p = self.store.partitions[pid]
            with p.lock:  # append rebinds the lanes under this lock
                seg = p.begin_ts[start:start + n]
                p.begin_ts[start:start + n] = np.where(seg == own, commit_ts, seg)
        for pid, row_ids, _old in self.deleted:
            p = self.store.partitions[pid]
            with p.lock:
                cur = p.end_ts[row_ids]
                p.end_ts[row_ids] = np.where(cur == own, commit_ts, cur)
        self.store.table.bump_version()

    def rollback(self):
        """Stamp own provisional inserts permanently dead (begin=INF, end=0); never
        truncate lanes: other writers hold offsets into the same partition."""
        own = -self.txn_id
        for pid, start, n in reversed(self.inserted):
            p = self.store.partitions[pid]
            with p.lock:
                seg = p.begin_ts[start:start + n]
                mine = seg == own
                p.begin_ts[start:start + n] = np.where(mine, INFINITY_TS, seg)
                end = p.end_ts[start:start + n]
                p.end_ts[start:start + n] = np.where(mine, 0, end)
        for pid, row_ids, old_end in reversed(self.deleted):
            p = self.store.partitions[pid]
            with p.lock:
                # only where the provisional stamp is still ours: an own
                # insert-then-delete row was already stamped dead above
                cur = p.end_ts[row_ids]
                p.end_ts[row_ids] = np.where(cur == own, old_end, cur)
        self.store.table.bump_version()


def participants_of(txn) -> List[StoreParticipant]:
    """Group a session Transaction's undo entries by store (one participant each)."""
    by_store: Dict[int, StoreParticipant] = {}

    def get(store):
        sp = by_store.get(store.uid)
        if sp is None:
            sp = StoreParticipant(store, txn.txn_id)
            by_store[store.uid] = sp
        return sp

    for store, pid, start, n in txn.inserted:
        get(store).inserted.append((pid, start, n))
    for store, pid, row_ids, old_end in txn.deleted:
        get(store).deleted.append((pid, row_ids, old_end))
    return list(by_store.values())


class RemoteBranchParticipant:
    """A worker process's branch of a distributed transaction, driven over the
    RPC plane (ops dml / xa_prepare / xa_commit / xa_rollback)."""

    def __init__(self, instance, addr, xid: str):
        self.instance = instance
        self.addr = addr
        self.xid = xid

    def _client(self):
        return self.instance.workers.get(self.addr)

    def prepare(self) -> bool:
        c = self._client()
        if c is None:
            return False
        try:
            resp, _ = c.request({"op": "xa_prepare", "xid": self.xid})
            return bool(resp.get("ok"))
        except Exception:  # galaxylint: disable=swallow -- a failed prepare IS the answer: the coordinator rolls back
            return False

    def commit(self, commit_ts: int):
        c = self._client()
        if c is None:
            raise errors.TransactionError(
                f"branch {self.xid}: worker {self.addr} unreachable")
        resp, _ = c.request({"op": "xa_commit", "xid": self.xid,
                             "commit_ts": int(commit_ts)})
        if resp.get("error"):
            raise errors.TransactionError(
                f"branch {self.xid} commit failed: {resp['error']}")

    def rollback(self):
        c = self._client()
        if c is None:
            return  # the branch resolves through xa_recover when the worker returns
        try:
            c.request({"op": "xa_rollback", "xid": self.xid})
        except Exception:  # galaxylint: disable=swallow -- an unreachable branch resolves through xa_recover
            pass


def remote_participants_of(instance, txn) -> List[RemoteBranchParticipant]:
    return [RemoteBranchParticipant(instance, addr, xid)
            for addr, xid in getattr(txn, "remote", {}).items()]


def recover_persisted(instance) -> Dict[int, str]:
    """Boot-time recovery: resolve the provisional (-txn_id) stamps of the loaded
    partitions against the metadb's `global_tx_log`.

    A transaction with a logged COMMITTED or DONE commit point is committed at that
    commit_ts; any other (PREPARED, ABORTED or absent from the log) rolls back:
    provisional deletes are restored to INFINITY first, then provisional inserts are
    stamped permanently dead, so a row the transaction inserted and deleted ends as
    (INF, 0), invisible on every visibility path.  A PREPARED branch this node holds
    for another coordinator (`xa.branch.*`) stays in doubt.  Returns {txn_id:
    "committed" | "rolled_back" | "in_doubt"}."""
    out: Dict[int, str] = {}
    resolutions: Dict[int, Optional[int]] = {}  # txn_id -> commit_ts or None

    held: set = set()
    for _k, v in instance.metadb.kv_scan("xa.branch."):
        try:
            d = json.loads(v)
            if d.get("state") == "PREPARED":
                held.add(int(d["txn_id"]))
        except (ValueError, KeyError, TypeError, AttributeError):
            continue

    def resolve(txn_id: int) -> Optional[int]:
        if txn_id not in resolutions:
            state = instance.metadb.tx_log_get(txn_id)
            if state is not None and state[0] in ("COMMITTED", "DONE") and state[1]:
                resolutions[txn_id] = state[1]
            else:
                resolutions[txn_id] = None
        return resolutions[txn_id]

    for store in instance.stores.values():
        for p in store.partitions:
            with p.lock:
                bneg = p.begin_ts < 0
                eneg = p.end_ts < 0
                if not (bneg.any() or eneg.any()):
                    continue
                ids = np.unique(np.concatenate(
                    [-p.begin_ts[bneg], -p.end_ts[eneg]])).astype(np.int64)
                for txn_id in (int(t) for t in ids):
                    if txn_id in held:
                        out[txn_id] = "in_doubt"
                        continue
                    own = -txn_id
                    commit_ts = resolve(txn_id)
                    if commit_ts is not None:
                        p.begin_ts[p.begin_ts == own] = commit_ts
                        p.end_ts[p.end_ts == own] = commit_ts
                        out[txn_id] = "committed"
                    else:
                        p.end_ts[p.end_ts == own] = INFINITY_TS
                        mine = p.begin_ts == own
                        p.begin_ts[mine] = INFINITY_TS
                        p.end_ts[mine] = 0
                        out[txn_id] = "rolled_back"
    for txn_id, res in out.items():
        if res == "committed":
            instance.metadb.tx_log_put(txn_id, "DONE", resolutions[txn_id])
        elif res == "rolled_back":
            instance.metadb.tx_log_put(txn_id, "ABORTED")
    if out:
        # stamps changed in place: plans, scan metadata and cached device lanes of
        # the old stamps must miss
        for store in instance.stores.values():
            store.table.bump_version()
        instance.catalog.version += 1
    return out


class _CommitWaiter:
    __slots__ = ("txn_id", "state", "commit_ts", "event", "ts", "lead",
                 "failed")

    def __init__(self, txn_id: int, state: str, commit_ts: int = 0):
        self.txn_id = txn_id
        self.state = state
        self.commit_ts = commit_ts
        self.event = threading.Event()
        self.ts: Optional[int] = None
        self.lead = False
        self.failed = False


class GroupCommitGate:
    """The commit-point critical path, shared by concurrent committers.

    Every commit pays a TSO fetch and a durable metadb write of its commit point.
    The first committer to find no flush in progress leads: it drains whatever
    queued while the previous flush was writing, allocates the group's commit
    timestamps in one `TimestampOracle.next_timestamps` call and writes every row
    in one metadb transaction (`tx_log_put_many`), then loops for the members that
    queued meanwhile.  Sequential traffic is a group of one with no added wait:
    nobody sleeps waiting for company.  `log_state` groups the non-allocating
    writes (DONE markers) the same way.  A failed flush falls every member back to
    its own solo write: grouping is an optimization, never a correctness
    dependency.  Counted in the registry counters `group_commit_batches` and
    `group_committed_txns`, as in the reference."""

    def __init__(self, instance):
        self.instance = instance
        self._lock = threading.Lock()
        self._flushing = False
        self._waiters: List[_CommitWaiter] = []
        self._counters = None  # bound at the first flush

    def _stat(self):
        if self._counters is None:
            m = self.instance.metrics
            self._counters = (
                m.counter("group_commit_batches", "commit-point flush groups written"),
                m.counter("group_committed_txns",
                          "transactions whose commit point rode a flush group"))
        return self._counters

    def commit_point(self, txn_id: int) -> int:
        """Allocate a commit TSO and durably log `txn_id` COMMITTED at it, grouped
        with concurrent committers.  Returns the commit_ts."""
        return self._submit(_CommitWaiter(txn_id, "COMMITTED"))

    def log_state(self, txn_id: int, state: str, commit_ts: int = 0):
        """Durably log a non-allocating tx-log state (DONE/ABORTED), grouped with
        concurrent writers of the same gate."""
        self._submit(_CommitWaiter(txn_id, state, commit_ts))

    def _submit(self, w: _CommitWaiter) -> int:
        with self._lock:
            self._waiters.append(w)
            if not self._flushing:
                self._flushing = True
                w.lead = True
        if not w.lead:
            # the current leader's flush loop either flushes us or hands us
            # leadership; the timeout is a never-hang backstop
            if not w.event.wait(timeout=30.0):
                with self._lock:
                    try:
                        self._waiters.remove(w)
                    except ValueError:
                        w.event.wait()  # a flusher owns us: it will finish
                        return self._resolve(w)
                return self._solo(w)
            return self._resolve(w)
        self._lead_loop()
        return self._resolve(w)

    def _resolve(self, w: _CommitWaiter) -> int:
        if w.failed or (w.state == "COMMITTED" and w.ts is None):
            return self._solo(w)  # a flush error falls back member by member
        return w.ts if w.ts is not None else w.commit_ts

    def _solo(self, w: _CommitWaiter) -> int:
        ts = self.instance.tso.next_timestamp() \
            if w.state == "COMMITTED" else w.commit_ts
        self.instance.metadb.tx_log_put(w.txn_id, w.state, ts)
        return ts

    def _lead_loop(self):
        while True:
            with self._lock:
                batch = self._waiters
                self._waiters = []
                if not batch:
                    self._flushing = False
                    return
            self._flush(batch)
            # wake the batch only after its rows are durable; then loop to pick
            # up the members that queued during the write
            for w in batch:
                w.event.set()

    def _flush(self, batch: List[_CommitWaiter]):
        try:
            commits = [w for w in batch if w.state == "COMMITTED"]
            if commits:
                tss = self.instance.tso.next_timestamps(len(commits))
                for w, ts in zip(commits, tss):
                    w.ts = ts
            self.instance.metadb.tx_log_put_many(
                [(w.txn_id, w.state,
                  w.ts if w.ts is not None else w.commit_ts) for w in batch])
            batches, txns = self._stat()
            batches.inc()
            txns.inc(len(batch))
        except Exception:
            # every member (DONE markers included) falls back to its own solo
            # write, which raises its own error if the metadb is really down
            for w in batch:
                w.ts = None
                w.failed = True


class TwoPhaseCoordinator:
    """The TSO + 2PC commit protocol of `TRANSACTION_POLICY = 'XA'`."""

    def __init__(self, instance):
        self.instance = instance
        # in-doubt registry: txn_id -> participants (cleared when resolved)
        self._in_doubt: Dict[int, List[StoreParticipant]] = {}
        self._lock = threading.Lock()
        # commit-point group gate: the TSO fetch and the durable COMMITTED / DONE
        # rows amortized across concurrent committers (the TSO policy's too)
        self.group_gate = GroupCommitGate(instance)

    def commit(self, txn) -> int:
        parts = participants_of(txn) + remote_participants_of(self.instance, txn)
        if not parts:
            return self.instance.tso.next_timestamp()
        metadb = self.instance.metadb
        # phase 1: prepare every participant (local stores and worker branches)
        for sp in parts:
            if not sp.prepare():
                for done in parts:
                    done.rollback()
                metadb.tx_log_put(txn.txn_id, "ABORTED")
                raise errors.TransactionError("XA PREPARE failed; rolled back")
        metadb.tx_log_put(txn.txn_id, "PREPARED")
        with self._lock:
            self._in_doubt[txn.txn_id] = parts
        FAIL_POINTS.inject(FP_BEFORE_COMMIT, f"txn {txn.txn_id}")
        # commit point: a fresh TSO value logged durably BEFORE any participant
        # commits, grouped with concurrent committers
        commit_ts = self.group_gate.commit_point(txn.txn_id)
        failed = []
        for sp in parts:
            try:
                sp.commit(commit_ts)
            except Exception as e:
                # past the commit point the outcome is decided: a participant that
                # failed stays in doubt and recover() re-commits it, never rolls
                # it back
                failed.append((sp, e))
        if failed:
            err = errors.TransactionError(
                f"txn {txn.txn_id} committed at {commit_ts} but "
                f"{len(failed)} branch(es) are in doubt (will re-commit): "
                f"{failed[0][1]}")
            # past the commit point the transaction IS committed: callers still
            # apply what follows a commit at this ts
            err.commit_ts = commit_ts
            raise err
        self.group_gate.log_state(txn.txn_id, "DONE", commit_ts)
        with self._lock:
            self._in_doubt.pop(txn.txn_id, None)
        return commit_ts

    def recover(self) -> Dict[int, str]:
        """Resolve the in-doubt transactions of this process: PREPARED without a
        commit point rolls back, COMMITTED re-commits idempotently.  Returns
        {txn_id: resolution}."""
        out: Dict[int, str] = {}
        with self._lock:
            pending = dict(self._in_doubt)
        for txn_id, parts in pending.items():
            state = self.instance.metadb.tx_log_get(txn_id)
            if state is None or state[0] in ("PREPARED", "ABORTED"):
                for sp in parts:
                    sp.rollback()
                self.instance.metadb.tx_log_put(txn_id, "ABORTED")
                out[txn_id] = "rolled_back"
            elif state[0] in ("COMMITTED",):
                for sp in parts:
                    sp.commit(state[1])
                self.instance.metadb.tx_log_put(txn_id, "DONE", state[1])
                out[txn_id] = "committed"
            else:
                out[txn_id] = "done"
            with self._lock:
                self._in_doubt.pop(txn_id, None)
        return out

    def recover_remote(self) -> Dict[str, str]:
        """Resolve the in-doubt branches workers report (`xa_recover`): after a
        worker restart its PREPARED branches wait for the coordinator, which
        decides each from its own commit-point log (the xid encodes this
        coordinator's txn id) and sends xa_commit or xa_rollback.  Returns
        {xid: "committed" | "rolled_back" | "unresolved: ..."}."""
        out: Dict[str, str] = {}
        for addr, client in list(self.instance.workers.items()):
            try:
                resp, _ = client.request({"op": "xa_recover"})
            except Exception:  # galaxylint: disable=swallow -- an unreachable worker is asked again at its next attach or probe
                continue
            for xid in resp.get("xids", []):
                try:
                    txn_id = int(str(xid).lstrip("g"))
                except ValueError:
                    continue
                state = self.instance.metadb.tx_log_get(txn_id)
                try:
                    if state is not None and state[0] in ("COMMITTED", "DONE") \
                            and state[1]:
                        client.request({"op": "xa_commit", "xid": xid,
                                        "commit_ts": int(state[1])})
                        out[xid] = "committed"
                        self.instance.metadb.tx_log_put(txn_id, "DONE", state[1])
                    else:
                        client.request({"op": "xa_rollback", "xid": xid})
                        out[xid] = "rolled_back"
                except Exception as e:
                    out[xid] = f"unresolved: {e}"
        return out
