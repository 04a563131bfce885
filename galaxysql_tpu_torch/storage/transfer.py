"""Carry a table's state from one engine into the port.

`arrays_of(store)` reads what a table store holds as plain numpy: per partition the
lanes, validity masks and MVCC stamps, plus each string column's dictionary values in
code order.  It reads attributes only, so it works on the reference engine's store as
on the port's.  `store_from_arrays(table, partitions, dictionaries)` builds the port's
`TableStore` from that state with the same partitions, codes and stamps — the part
weight conversion plays for a model: afterwards both engines hold identical lanes, so
scans, slot vectors and query results can be compared bit for bit.  The new store
owns copies of every array: writes stamp `begin_ts`/`end_ts` in place, and a store
sharing them with its source would show one engine's writes in the other.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from galaxysql_tpu_torch.meta.catalog import TableMeta
from galaxysql_tpu_torch.storage.table_store import TableStore

PartitionArrays = Mapping[str, object]  # lanes, valid, begin_ts, end_ts


def arrays_of(store) -> Tuple[List[Dict[str, object]], Dict[str, List[str]]]:
    """(partitions, dictionaries) of any table store with the reference layout."""
    parts = []
    for p in store.partitions:
        parts.append({"lanes": {k: np.asarray(v) for k, v in p.lanes.items()},
                      "valid": {k: np.asarray(v) for k, v in p.valid.items()},
                      "begin_ts": np.asarray(p.begin_ts),
                      "end_ts": np.asarray(p.end_ts)})
    dicts = {k: list(d.values) for k, d in store.table.dictionaries.items()}
    return parts, dicts


def store_from_arrays(table: TableMeta, partitions: Sequence[PartitionArrays],
                      dictionaries: Mapping[str, Sequence[str]]) -> TableStore:
    """The port's store for `table` holding exactly `partitions`.  String columns'
    dictionaries take `dictionaries[column]` in code order, so every code keeps its
    string; the table's dictionaries must be empty or already agree."""
    for name, values in dictionaries.items():
        d = table.dictionaries.get(name.lower())
        if d is None:
            raise ValueError(f"{table.name} has no string column {name}")
        for code, v in enumerate(values):
            if d.encode_one(v) != code:
                raise ValueError(f"{table.name}.{name}: dictionary code of {v!r} differs")
    store = TableStore(table)
    if len(partitions) != len(store.partitions):
        raise ValueError(f"{table.name}: {len(partitions)} partitions given, the table "
                         f"has {len(store.partitions)}")
    rows = 0
    for p, src in zip(store.partitions, partitions):
        n = int(np.asarray(src["begin_ts"]).shape[0])
        for c in table.columns:
            lane = np.array(src["lanes"][c.name], dtype=c.dtype.lane, order="C")
            valid = np.array(src["valid"][c.name], dtype=np.bool_, order="C")
            if lane.shape != (n,) or valid.shape != (n,):
                raise ValueError(f"{table.name}.{c.name}: lane length differs from "
                                 f"the partition's {n} rows")
            p.lanes[c.name] = lane
            p.valid[c.name] = valid
        p.begin_ts = np.array(src["begin_ts"], dtype=np.int64, order="C")
        p.end_ts = np.array(src["end_ts"], dtype=np.int64, order="C")
        if p.end_ts.shape != (n,):
            raise ValueError(f"{table.name}: end_ts length differs from begin_ts")
        rows += n
    table.stats.row_count = rows
    table.bump_version()
    return store
