"""Partitioned columnar table store (trimmed port of `galaxysql_tpu/storage/table_store.py`).

Each partition is a host-resident struct-of-arrays column set: numpy lanes, null masks
and per-row MVCC stamps (`begin_ts`/`end_ts`; a snapshot at ts sees rows with
begin_ts <= ts < end_ts), and an append-aware sorted key index per probed column
(`key_index` / `key_candidates` / `key_rows`, the point path's access method).  Rows
route to partitions with the catalog's `PartitionRouter`, so a table loaded into the
port lands in the same partitions as in the reference.  A statement with a device
cache reads these lanes through it (`plan/physical.py`); one the reference runs
without a cache (TP, or `ENABLE_TPU_ENGINE = 0`) reads host batches from `scan`.
Loading is `insert_pylists` (Python values, encoded as the reference encodes them)
or `insert_arrays` (numpy columns); `storage/transfer.py` adopts the lanes of a
reference store as they are.  `save` and `load` write and read the reference's
checkpoint files, so a data directory crosses between the two packages in both
directions.

Writes follow the reference: an insert appends rows stamped with its timestamp, a
delete stamps `end_ts` in place, an update does both (the new versions move to the
end of their partition).  Inside a transaction the stamps are provisional
(`-txn_id`) until `txn/xa.py` finalizes them.
"""

from __future__ import annotations

import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from galaxysql_tpu_torch import native
from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, as_tensor,
                                             column_from_pylist)
from galaxysql_tpu_torch.meta.catalog import PartitionRouter, TableMeta
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_LOCK_INVERT
from galaxysql_tpu_torch.utils.lockdep import named_lock

INFINITY_TS = (1 << 63) - 1  # int64 max; must exceed any TSO value


def visible_rows(b: np.ndarray, e: np.ndarray, snapshot_ts: Optional[int],
                 txn_id: int = 0) -> np.ndarray:
    """MVCC visibility of rows stamped `b`/`e` on the host.  Uncommitted changes
    carry NEGATIVE timestamps (-txn_id), visible only to the owning transaction;
    commit turns them into TSO values.  The reference's `native.visible_mask`, run by
    the C++ host runtime (`galaxysql_tpu_torch/native`); `plan/physical.
    _device_visibility` and the batched point program
    (`exec/operators._batched_point_program`) are its device twins."""
    return native.visible_mask(b, e, snapshot_ts, txn_id)


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
        # re-entrant: update_rows appends under the lock it already holds.  The
        # lockdep class splits base tables from GSI stores ($-named): UPDATE holds
        # the base partition lock while it maintains the index, a cross-class order
        self.lock = named_lock("partition.gsi" if "$" in table.name else "partition")
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

    def key_candidates_many(self, col: str, lane_values: np.ndarray) -> np.ndarray:
        """Row ids (ascending, unique) whose `col` lane equals any of the
        (lane-encoded) values: `key_candidates` for a whole array of keys, the
        sorted index's ranges found by one `searchsorted` pair and expanded, and
        the appended tail probed with `np.isin`.  MVCC-unaware, like
        `key_candidates`."""
        wanted = np.unique(np.asarray(lane_values, dtype=self.lanes[col].dtype))
        with self.lock:
            n = self.num_rows
            if n == 0 or wanted.size == 0:
                return np.zeros(0, dtype=np.int64)
            n0, perm, skeys = self.key_index(col)
            lo = np.searchsorted(skeys, wanted, side="left")
            cnt = np.searchsorted(skeys, wanted, side="right") - lo
            keep = cnt > 0
            lo, cnt = lo[keep], cnt[keep]
            # CSR expansion of the [lo, lo + cnt) ranges of the sorted index
            pos = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(int(cnt.sum()))
            ids = perm[pos]
            if n > n0:
                tail = np.nonzero(np.isin(self.lanes[col][n0:n], wanted))[0] + n0
                ids = np.concatenate([ids, tail])
            return np.unique(ids).astype(np.int64)

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
        self.append_lock = named_lock(
            "append_lock.gsi" if "$" in table.name else "append_lock")

    def _lockdep_probe(self):
        """FP_LOCK_INVERT: a partition lock and THEN the append_lock, the reverse of
        the canonical order, on the real insert ramp, so the lockdep witness is
        shown to trip where it matters.  Disarmed, one bool read.  Called before
        the ramp takes append_lock (a re-entrant acquisition adds no edge)."""
        if FAIL_POINTS.active and FAIL_POINTS.value(FP_LOCK_INVERT) \
                and self.partitions:
            p = self.partitions[0]
            with p.lock:
                with self.append_lock:  # galaxylint: disable=lock-order -- deliberate seeded inversion proving the lockdep witness trips (tests/test_torch_lint.py)
                    pass

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

    # -- read path: the host scan ------------------------------------------------------

    def scan_partition(self, pid: int, columns: Sequence[str],
                       snapshot_ts: Optional[int] = None, batch_rows: int = 1 << 20,
                       txn_id: int = 0, home=None) -> Iterator[ColumnBatch]:
        """Host batches (CPU tensors marked for `home`, the device they join once
        they leave the host tier) of up to `batch_rows` visible rows of partition
        `pid`.  An empty partition yields one empty batch, as in the reference."""
        p = self.partitions[pid]
        with p.lock:
            idx = np.nonzero(p.visible_mask(snapshot_ts, txn_id))[0]
            data = {c: p.lanes[c][idx] for c in columns}
            valid = {c: p.valid[c][idx] for c in columns}
        n = idx.shape[0]
        table = self.table
        for off in range(0, max(n, 1), batch_rows):
            hi = min(off + batch_rows, n)
            cols = {}
            for c in columns:
                v = valid[c][off:hi]
                cols[c] = Column(as_tensor(data[c][off:hi]),
                                 None if v.all() else as_tensor(v),
                                 table.column(c).dtype, table.dictionaries.get(c.lower()))
            yield ColumnBatch(cols, None, host=home)
            if hi >= n:
                break

    def scan(self, columns: Sequence[str], partitions: Optional[Sequence[int]] = None,
             snapshot_ts: Optional[int] = None, txn_id: int = 0,
             home=None) -> Iterator[ColumnBatch]:
        pids = range(len(self.partitions)) if partitions is None else partitions
        for pid in pids:
            yield from self.scan_partition(pid, columns, snapshot_ts, txn_id=txn_id,
                                           home=home)

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

    # -- persistence -------------------------------------------------------------

    def save(self, directory: str):
        """The reference's checkpoint format: one `np.savez_compressed` file
        `p{pid}.npz` a partition (`lane__<col>`, `valid__<col>`, `begin_ts`,
        `end_ts`) and `dictionaries.json` (each string column's values in code
        order).  The partitions are written in parallel (zlib releases the GIL);
        the files are those the reference writes one by one
        (`tools/save_cost.py` times both orders)."""
        os.makedirs(directory, exist_ok=True)
        workers = min(len(self.partitions), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
            for _ in pool.map(lambda p: self.write_partition(directory, p),
                              self.partitions):
                pass
        self.write_dictionaries(directory)

    def write_partition(self, directory: str, p: Partition):
        with p.lock:
            arrays = {f"lane__{k}": v for k, v in p.lanes.items()}
            arrays.update({f"valid__{k}": v for k, v in p.valid.items()})
            arrays["begin_ts"] = p.begin_ts
            arrays["end_ts"] = p.end_ts
        np.savez_compressed(os.path.join(directory, f"p{p.pid}.npz"), **arrays)

    def write_dictionaries(self, directory: str):
        dicts = {k: d.values for k, d in self.table.dictionaries.items()}
        with open(os.path.join(directory, "dictionaries.json"), "w") as f:
            json.dump(dicts, f)

    def load(self, directory: str):
        """Read what `save` wrote (or the reference's `save`): the dictionary values
        are encoded in their saved order, so the codes come back the same."""
        dpath = os.path.join(directory, "dictionaries.json")
        if os.path.exists(dpath):
            with open(dpath) as f:
                dicts = json.load(f)
            for k, values in dicts.items():
                d = self.table.dictionaries.get(k)
                if d is not None:
                    for v in values:
                        d.encode_one(v)
        for p in self.partitions:
            path = os.path.join(directory, f"p{p.pid}.npz")
            if not os.path.exists(path):
                continue
            with np.load(path, allow_pickle=False) as z, p.lock:
                p.begin_ts = z["begin_ts"]
                p.end_ts = z["end_ts"]
                for c in self.table.columns:
                    p.lanes[c.name] = z[f"lane__{c.name}"]
                    p.valid[c.name] = z[f"valid__{c.name}"]
                p.invalidate_indexes()  # the point path's key index is rebuilt
        self.table.stats.row_count = self.row_count()


def _encode_pylist(values: Sequence[Any], typ: dt.DataType,
                   dictionary) -> Tuple[np.ndarray, np.ndarray]:
    """(lane, valid) of one column of Python values, equal to the reference's
    `column_from_pylist`: the same lanes, and the same exception where a value does not
    fit its lane.  One numpy pass takes a column where it is exact: integers of the
    lane's kind inside its range, floats into a float lane, decimals whose scaled value
    fits int64 (round(v * 10**scale), ties to even as Python's `round`).  Everything
    else goes value by value through `column_from_pylist`: strings (dictionary codes in
    order of first appearance), dates given as strings, mixed ints and floats, object
    columns and values out of range."""
    valid = np.fromiter((v is not None for v in values), dtype=np.bool_,
                        count=len(values))
    if not typ.is_string and values:
        filled = values if valid.all() else [0 if v is None else v for v in values]
        lane = _encode_vectorized(filled, typ)
        if lane is not None:
            return lane, valid
    col = column_from_pylist(values, typ, dictionary)
    return col.np_data(), col.np_valid()


def _encode_vectorized(filled: Sequence[Any], typ: dt.DataType) -> Optional[np.ndarray]:
    """The lane of a column without NULLs in one numpy pass, or None where that pass
    could differ from the reference's value-by-value assignment."""
    if any(isinstance(v, str) for v in filled) and \
            typ.clazz in (dt.TypeClass.DATE, dt.TypeClass.DATETIME):
        return None
    lane_t = np.dtype(typ.lane)
    try:
        if typ.clazz == dt.TypeClass.DECIMAL:
            f = np.round(np.asarray(filled, dtype=np.float64) * (10 ** typ.scale))
            # int64 holds exactly [-2**63, 2**63); NaN fails both tests
            if not ((f >= -2.0 ** 63) & (f < 2.0 ** 63)).all():
                return None
            return f.astype(lane_t)
        arr = np.asarray(filled)
    except (TypeError, ValueError, OverflowError):
        return None
    if lane_t.kind in "iu":
        if arr.dtype.kind not in "iu":
            return None  # floats truncate, objects and bools assign one by one
        info = np.iinfo(lane_t)
        if arr.min() < info.min or arr.max() > info.max:
            return None
        return arr.astype(lane_t)
    if lane_t.kind == "f":
        # float -> float casts round as the reference's assignment does; integers
        # go through float64 there, exact up to 2**53
        if arr.dtype.kind == "f" or (arr.dtype.kind in "iu" and
                                     int(np.abs(arr).max()) <= 1 << 53):
            return arr.astype(lane_t)
        return None
    if lane_t.kind == "b" and arr.dtype.kind == "b":
        return arr
    return None
