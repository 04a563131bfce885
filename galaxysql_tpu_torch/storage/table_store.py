"""Partitioned columnar table store (trimmed port of `galaxysql_tpu/storage/table_store.py`).

Each partition is a host-resident struct-of-arrays column set: numpy lanes, null masks
and per-row MVCC stamps (`begin_ts`/`end_ts`; a snapshot at ts sees rows with
begin_ts <= ts < end_ts), and an append-aware sorted key index per probed column
(`key_index` / `key_candidates` / `key_rows`, the point path's access method).  Rows
route to partitions with the catalog's `PartitionRouter`, so a table loaded into the
port lands in the same partitions as in the reference.  The scan reads these lanes
through the device cache (`plan/physical.py`).  Loading is `insert_pylists` (Python
values, encoded as the reference encodes them) or `insert_arrays` (numpy columns);
`storage/transfer.py` adopts the lanes of a reference store as they are.

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


def visible_rows(b: np.ndarray, e: np.ndarray, snapshot_ts: Optional[int],
                 txn_id: int = 0) -> np.ndarray:
    """MVCC visibility of rows stamped `b`/`e` on the host.  Uncommitted changes
    carry NEGATIVE timestamps (-txn_id), visible only to the owning transaction;
    commit turns them into TSO values.  The reference's numpy body
    (`native.visible_mask`); `plan/physical._device_visibility` and the batched
    point program (`exec/operators._batched_point_program`) are its device twins."""
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
        # append-aware sorted key indexes: col -> (lane_gen, n0, perm, sorted_keys)
        # where perm sorts rows [0, n0).  Appends don't invalidate (MVCC rows are
        # immutable; the [n0, n) tail is probed linearly until it outgrows
        # _INDEX_TAIL); wholesale lane replacement (truncate, `storage/transfer`)
        # bumps lane_gen and forces a rebuild.
        self._key_indexes: Dict[str, Tuple[int, int, np.ndarray, np.ndarray]] = {}
        self.lane_gen = 0

    _INDEX_TAIL = 8192

    def invalidate_indexes(self):
        """Call after replacing lane arrays wholesale."""
        self.lane_gen += 1
        self._key_indexes.clear()

    def key_index(self, col: str):
        """(n0, perm, sorted_keys) of the append-aware sorted index over
        `col` (building it if stale).  `perm` stable-sorts rows [0, n0), so
        perm[lo:hi] enumerates equal-key rows in ascending row-id order; rows
        [n0, num_rows) are the unsorted appended tail the caller must probe
        separately.  Caller must hold `self.lock`."""
        n = self.num_rows
        lane = self.lanes[col]
        entry = self._key_indexes.get(col)
        if entry is None or entry[0] != self.lane_gen or \
                n - entry[1] > self._INDEX_TAIL:
            perm = np.argsort(lane[:n], kind="stable")
            entry = (self.lane_gen, n, perm, lane[:n][perm])
            self._key_indexes[col] = entry
        return entry[1], entry[2], entry[3]

    def key_candidates(self, col: str, lane_value) -> np.ndarray:
        """Row ids whose `col` lane equals the (lane-encoded) value.

        MVCC-unaware: returns every physical row version with that key; the
        caller applies visibility.  O(log n) over the indexed prefix plus a
        linear probe of the unsorted appended tail."""
        with self.lock:
            n = self.num_rows
            lane = self.lanes[col]
            n0, perm, skeys = self.key_index(col)
            lo = np.searchsorted(skeys, lane_value, side="left")
            hi = np.searchsorted(skeys, lane_value, side="right")
            ids = perm[lo:hi]
            if n > n0:
                tail = np.nonzero(lane[n0:n] == lane_value)[0] + n0
                ids = np.concatenate([ids, tail]) if tail.size else ids
            return ids

    def key_rows(self, col: str, lane_value, snapshot_ts: Optional[int],
                 txn_id: int = 0) -> np.ndarray:
        """Row ids of the versions visible at the snapshot whose `col` lane equals
        the (lane-encoded) value and is not NULL, in `key_candidates`' order: the
        sequential key-get."""
        with self.lock:
            ids = self.key_candidates(col, lane_value)
            return ids[self.valid[col][ids] & visible_rows(
                self.begin_ts[ids], self.end_ts[ids], snapshot_ts, txn_id)]

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
        """MVCC visibility of every row on the host (`visible_rows`)."""
        return visible_rows(self.begin_ts, self.end_ts, snapshot_ts, txn_id)

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
        old = self.partitions
        self.partitions = [Partition(self.table, i) for i in range(n)]
        for p in self.partitions:
            # the new lanes carry a later index generation than any the old
            # partition's sorted-key artifacts were built under
            p.lane_gen = old[p.pid].lane_gen
            p.invalidate_indexes()
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
