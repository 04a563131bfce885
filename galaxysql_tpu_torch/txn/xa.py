"""Transaction participants over table stores (trimmed port of `galaxysql_tpu/txn/xa.py`).

A participant is one TableStore's share of a session transaction: the row ranges
the transaction appended with provisional (`-txn_id`) begin stamps and the rows it
stamped provisionally deleted.  COMMIT stamps both with one commit timestamp from
the TSO; ROLLBACK stamps its own inserts permanently dead (begin = INFINITY,
end = 0) and restores the end stamps its deletes replaced.  Each ends with a table
version bump, so plans, scan metadata and cached device lanes of the old stamps miss.

The reference's two-phase coordinator, its durable commit-point log, recovery and
worker branches need the metadata store and workers, which the port does not have.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from galaxysql_tpu_torch.storage.table_store import INFINITY_TS


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
