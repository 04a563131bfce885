"""Partitioned columnar table store (trimmed port of `galaxysql_tpu/storage/table_store.py`).

Each partition is a host-resident struct-of-arrays column set: numpy lanes, null masks
and per-row MVCC stamps (`begin_ts`/`end_ts`; a snapshot at ts sees rows with
begin_ts <= ts < end_ts).  Rows route to partitions with the catalog's
`PartitionRouter`, so a table loaded into the port lands in the same partitions as in
the reference.  The scan reads these lanes through the device cache
(`plan/physical.py`).  Bulk loading is `insert_arrays`; `storage/transfer.py` adopts
the lanes of a reference store as they are.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict

import numpy as np

from galaxysql_tpu_torch.meta.catalog import PartitionRouter, TableMeta
from galaxysql_tpu_torch.types import datatype as dt

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
        self.lock = threading.Lock()

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


class TableStore:
    _next_uid = itertools.count(1)

    def __init__(self, table: TableMeta):
        self.table = table
        self.router = PartitionRouter(table)
        n = table.partition.num_partitions
        self.partitions = [Partition(table, i) for i in range(n)]
        # process-unique identity for caches (id() can be recycled after GC)
        self.uid = next(TableStore._next_uid)

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
        pids = self._route(lanes)
        for pid in np.unique(pids):
            sel = np.nonzero(pids == pid)[0]
            self.partitions[int(pid)].append(
                {k: v[sel] for k, v in lanes.items()},
                {k: v[sel] for k, v in valid.items()}, begin_ts)
        table.stats.row_count += n
        table.bump_version()  # cached device lanes of the old contents go stale
        return n

    def _route(self, lanes: Dict[str, np.ndarray]) -> np.ndarray:
        info = self.table.partition
        n = next(iter(lanes.values())).shape[0] if lanes else 0
        if info.method in ("single", "broadcast"):
            return np.zeros(n, dtype=np.int32)
        keys = [lanes[c] if c in lanes else lanes[self.table.column(c).name]
                for c in info.columns]
        return self.router.route_rows(keys)

    def row_count(self) -> int:
        return sum(p.num_rows for p in self.partitions)
