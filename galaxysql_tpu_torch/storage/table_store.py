"""Partitioned columnar table store (trimmed port of `galaxysql_tpu/storage/table_store.py`).

Each partition is a host-resident struct-of-arrays column set: numpy lanes, null masks
and per-row MVCC stamps (`begin_ts`/`end_ts`; a snapshot at ts sees rows with
begin_ts <= ts < end_ts).  Rows route to partitions with the catalog's
`PartitionRouter`, so a table loaded into the port lands in the same partitions as in
the reference.  The scan reads these lanes through the device cache
(`plan/physical.py`).  Loading is `insert_pylists` (Python values, encoded as the
reference encodes them) or `insert_arrays` (numpy columns); `storage/transfer.py`
adopts the lanes of a reference store as they are.

Writes follow the reference: an insert appends rows stamped with its timestamp, a
delete stamps `end_ts` in place, an update does both (the new versions move to the
end of their partition).  Inside a transaction the stamps are provisional
(`-txn_id`) until `txn/xa.py` finalizes them.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import column_from_pylist
from galaxysql_tpu_torch.meta.catalog import PartitionRouter, TableMeta
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

INFINITY_TS = (1 << 63) - 1  # int64 max; must exceed any TSO value


class Partition:
    """One shard of a table: numpy lanes + validity + MVCC timestamps."""

    def __init__(self, table: TableMeta, pid: int):
        self.table = table
        self.pid = pid
        self.lanes: Dict[str, np.ndarray] = {
            c.name: np.zeros(0, dtype=c.dtype.lane) for c in table.columns}
        self.valid: Dict[str, np.ndarray] = {
            c.name: np.zeros(0, dtype=np.bool_) for c in table.columns}
        self.begin_ts = np.zeros(0, dtype=np.int64)
        self.end_ts = np.zeros(0, dtype=np.int64)
        # re-entrant: update_rows appends under the lock it already holds
        self.lock = threading.RLock()

    @property
    def num_rows(self) -> int:
        return int(self.begin_ts.shape[0])

    def append(self, lanes: Dict[str, np.ndarray], valid: Dict[str, np.ndarray],
               begin_ts: int):
        n = next(iter(lanes.values())).shape[0] if lanes else 0
        with self.lock:
            for c in self.table.columns:
                self.lanes[c.name] = np.concatenate([self.lanes[c.name], lanes[c.name]])
                self.valid[c.name] = np.concatenate([self.valid[c.name], valid[c.name]])
            self.begin_ts = np.concatenate(
                [self.begin_ts, np.full(n, begin_ts, dtype=np.int64)])
            self.end_ts = np.concatenate(
                [self.end_ts, np.full(n, INFINITY_TS, dtype=np.int64)])

    def visible_mask(self, snapshot_ts: Optional[int], txn_id: int = 0) -> np.ndarray:
        """MVCC visibility on the host.  Uncommitted changes carry NEGATIVE
        timestamps (-txn_id), visible only to the owning transaction; commit turns
        them into TSO values.  The reference's numpy body (`native.visible_mask`);
        `plan/physical._device_visibility` is its device twin."""
        b, e = self.begin_ts, self.end_ts
        if snapshot_ts is None:
            ins = b >= 0
            dele = e != np.iinfo(np.int64).max
        else:
            ins = (b >= 0) & (b <= snapshot_ts)
            dele = (e >= 0) & (e <= snapshot_ts)
        if txn_id:
            ins = ins | (b == -txn_id)
            dele = dele | (e == -txn_id)
        return ins & ~dele

    def delete_rows(self, row_ids: np.ndarray, commit_ts: int):
        with self.lock:
            self.end_ts[row_ids] = commit_ts

    def update_rows(self, row_ids: np.ndarray, new_lanes: Dict[str, np.ndarray],
                    new_valid: Dict[str, np.ndarray], commit_ts: int):
        """MVCC update = end old versions + append new versions."""
        with self.lock:
            full_lanes = {}
            full_valid = {}
            for c in self.table.columns:
                if c.name in new_lanes:
                    full_lanes[c.name] = new_lanes[c.name]
                    full_valid[c.name] = new_valid[c.name]
                else:
                    full_lanes[c.name] = self.lanes[c.name][row_ids]
                    full_valid[c.name] = self.valid[c.name][row_ids]
            self.end_ts[row_ids] = commit_ts
            self.append(full_lanes, full_valid, commit_ts)


class TableStore:
    _next_uid = itertools.count(1)

    def __init__(self, table: TableMeta):
        self.table = table
        self.router = PartitionRouter(table)
        n = table.partition.num_partitions
        self.partitions = [Partition(table, i) for i in range(n)]
        # process-unique identity for caches (id() can be recycled after GC)
        self.uid = next(TableStore._next_uid)
        # serializes a writer's (count rows -> append -> derive its appended ranges),
        # taken before any partition lock
        self.append_lock = threading.RLock()

    def insert_pylists(self, data: Dict[str, List[Any]], begin_ts: int) -> int:
        """Encode Python values (None = NULL) and route rows to partitions; returns the
        rows inserted."""
        lanes, valid, n = self.encode_pylists(data)
        return self.append_encoded(lanes, valid, n, begin_ts)

    def encode_pylists(self, data: Dict[str, List[Any]]):
        """Python values -> (lanes, valid, n), changing nothing but the
        auto-increment counter (and growing string dictionaries).  Lanes, validity
        and dictionary codes are those the reference's `encode_pylists` produces
        (`chunk.batch.column_from_pylist`); numeric columns are encoded with
        whole-array numpy operations that give the same values."""
        table = self.table
        n = len(next(iter(data.values()))) if data else 0
        lanes: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for c in table.columns:
            values = data.get(c.name)
            if values is None:
                if c.auto_increment:
                    start = table.auto_increment_next
                    table.auto_increment_next += n
                    lanes[c.name] = np.arange(start, start + n, dtype=c.dtype.lane)
                    valid[c.name] = np.ones(n, dtype=np.bool_)
                    continue
                values = [c.default] * n
            lanes[c.name], valid[c.name] = _encode_pylist(
                values, c.dtype, table.dictionaries.get(c.name.lower()))
            if not c.nullable and not valid[c.name].all() and c.default is None:
                raise errors.TddlError(f"Column '{c.name}' cannot be null")
        return lanes, valid, n

    def insert_arrays(self, data: Dict[str, Any], begin_ts: int) -> int:
        """Bulk ingestion: numeric columns as numpy arrays pass through; string columns
        are dictionary-encoded via np.unique (LOAD DATA analog)."""
        table = self.table
        n = len(next(iter(data.values()))) if data else 0
        lanes: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for c in table.columns:
            values = data.get(c.name)
            if values is None:
                if c.auto_increment:
                    start = table.auto_increment_next
                    table.auto_increment_next += n
                    lanes[c.name] = np.arange(start, start + n, dtype=c.dtype.lane)
                    valid[c.name] = np.ones(n, dtype=np.bool_)
                    continue
                lanes[c.name] = np.zeros(n, dtype=c.dtype.lane)
                valid[c.name] = np.zeros(n, dtype=np.bool_)
                continue
            if c.dtype.is_string:
                arr = np.asarray(values, dtype=object)
                uniq, inverse = np.unique(arr.astype(str), return_inverse=True)
                d = table.dictionaries[c.name.lower()]
                trans = np.fromiter((d.encode_one(u) for u in uniq.tolist()),
                                    dtype=np.int32, count=len(uniq))
                lanes[c.name] = trans[inverse].astype(np.int32)
                valid[c.name] = np.ones(n, dtype=np.bool_)
            elif c.dtype.clazz == dt.TypeClass.DECIMAL:
                a = np.asarray(values, dtype=np.float64)
                lanes[c.name] = np.round(a * 10 ** c.dtype.scale).astype(np.int64)
                valid[c.name] = ~np.isnan(a)
            else:
                lanes[c.name] = np.asarray(values).astype(c.dtype.lane)
                valid[c.name] = np.ones(n, dtype=np.bool_)
        return self.append_encoded(lanes, valid, n, begin_ts)

    def append_encoded(self, lanes: Dict[str, np.ndarray], valid: Dict[str, np.ndarray],
                       n: int, begin_ts: int) -> int:
        """Route encoded lanes to partitions and append them stamped `begin_ts`."""
        pids = self._route(lanes)
        for pid in np.unique(pids):
            sel = np.nonzero(pids == pid)[0]
            self.partitions[int(pid)].append(
                {k: v[sel] for k, v in lanes.items()},
                {k: v[sel] for k, v in valid.items()}, begin_ts)
        self.table.stats.row_count += n
        self.table.bump_version()  # cached device lanes of the old contents go stale
        return n

    def _route(self, lanes: Dict[str, np.ndarray]) -> np.ndarray:
        info = self.table.partition
        n = next(iter(lanes.values())).shape[0] if lanes else 0
        if info.method in ("single", "broadcast"):
            return np.zeros(n, dtype=np.int32)
        keys = [lanes[c] if c in lanes else lanes[self.table.column(c).name]
                for c in info.columns]
        return self.router.route_rows(keys)

    def row_count(self, snapshot_ts: Optional[int] = None, txn_id: int = 0) -> int:
        return sum(int(p.visible_mask(snapshot_ts, txn_id).sum())
                   for p in self.partitions)

    def truncate(self):
        n = self.table.partition.num_partitions
        self.partitions = [Partition(self.table, i) for i in range(n)]
        self.table.stats.row_count = 0


def _encode_pylist(values: Sequence[Any], typ: dt.DataType,
                   dictionary) -> Tuple[np.ndarray, np.ndarray]:
    """(lane, valid) of one column of Python values.  Strings, and dates or datetimes
    given as strings, go value by value through `column_from_pylist` (dictionary codes
    in order of first appearance); other lanes take the same values in one numpy pass:
    a decimal is round(v * 10**scale) with ties to even, as Python's `round` does."""
    valid = np.fromiter((v is not None for v in values), dtype=np.bool_,
                        count=len(values))
    if typ.is_string or (typ.clazz in (dt.TypeClass.DATE, dt.TypeClass.DATETIME) and
                         any(isinstance(v, str) for v in values)):
        col = column_from_pylist(values, typ, dictionary)
        return col.np_data(), col.np_valid()
    filled = values if valid.all() else [0 if v is None else v for v in values]
    if typ.clazz == dt.TypeClass.DECIMAL:
        lane = np.round(np.asarray(filled, dtype=np.float64) * (10 ** typ.scale))
        return lane.astype(typ.lane), valid
    return np.asarray(filled).astype(typ.lane), valid
