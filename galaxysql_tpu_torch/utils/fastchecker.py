"""FastChecker: order-insensitive hash comparison of base table vs GSI content.

Reference analog: `executor/fastchecker/FastChecker.java` (SURVEY.md App.F) — per-batch
hash aggregates pushed to both sides; equal checksums mean the index is consistent with
its base table.  The checksum is the elementwise sum of mixed row-hashes over the
shared columns, so row order and partition placement don't matter.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.utils import errors

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint64(33))
        h = h * np.uint64(0xff51afd7ed558ccd)
        h = h ^ (h >> np.uint64(33))
        h = h * np.uint64(0xc4ceb9fe1a85ec53)
        h = h ^ (h >> np.uint64(33))
    return h


def table_checksum(store, columns: List[str], snapshot_ts: Optional[int] = None
                   ) -> Tuple[int, int]:
    """(row_count, order-insensitive checksum) over visible rows of `columns`."""
    return partitions_checksum(store.partitions, columns, snapshot_ts)


def partitions_checksum(partitions, columns: List[str],
                        snapshot_ts: Optional[int] = None) -> Tuple[int, int]:
    """table_checksum over an explicit partition list: the rebalance verify
    gate compares one table's SOURCE partitions against the job's shadow
    partitions (which live outside any store until cutover)."""
    total = np.uint64(0)
    count = 0
    with np.errstate(over="ignore"):
        for p in partitions:
            # a consistent cut per partition: a concurrent append rebinds the
            # lane arrays, so visibility and lanes read OUTSIDE the lock can
            # disagree on length (torn read -> bogus mismatch/IndexError).
            # Appends never mutate the [0, n) prefix, so slicing to one
            # locked row count is exact.
            with p.lock:
                n_rows = p.num_rows
                vis = p.visible_mask(snapshot_ts)[:n_rows]
                raws = {c: p.lanes[c][:n_rows][vis] for c in columns}
                valids = {c: p.valid[c][:n_rows][vis] for c in columns}
            n = int(vis.sum())
            if not n:
                continue
            count += n
            h = np.zeros(n, dtype=np.uint64)
            for c in columns:
                raw = raws[c]
                if raw.dtype.kind == "f":
                    # hash the BIT PATTERN: astype would truncate fractions and
                    # miss sub-integer corruption
                    lane = raw.view(np.uint32 if raw.dtype.itemsize == 4
                                    else np.uint64).astype(np.uint64)
                else:
                    lane = raw.astype(np.int64).astype(np.uint64)
                lane = np.where(valids[c], _mix(lane),
                                np.uint64(0xdeadbeefcafebabe))
                h = _mix(h * np.uint64(31) + lane)
            total = (total + h.sum(dtype=np.uint64)) & _MASK
    return count, int(total)


def check_gsi(instance, schema: str, table: str, index: str,
              snapshot_ts: Optional[int] = None) -> dict:
    """Compare a base table against one of its GSIs; returns a report dict."""
    tm = instance.catalog.table(schema, table)
    idx = next((i for i in tm.indexes if i.name.lower() == index.lower()), None)
    if idx is None or not idx.global_index:
        raise errors.TddlError(f"'{index}' is not a global index of {table}")
    gsi_tm = instance.catalog.table(schema, f"{table}${index}")
    ts = snapshot_ts or instance.tso.next_timestamp()
    shared = [c.name for c in gsi_tm.columns if tm.has_column(c.name)]
    base_n, base_sum = table_checksum(instance.store(schema, table), shared, ts)
    gsi_n, gsi_sum = table_checksum(instance.store(schema, gsi_tm.name), shared, ts)
    return {
        "table": f"{schema}.{table}", "index": index, "columns": shared,
        "base_rows": base_n, "gsi_rows": gsi_n,
        "consistent": base_n == gsi_n and base_sum == gsi_sum,
    }
