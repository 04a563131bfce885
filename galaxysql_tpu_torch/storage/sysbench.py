"""The sysbench `oltp_read_write` workload as SQL statements.

Schema and statements follow sysbench's `oltp_common.lua`: table `sbtest<N>` (id INT
AUTO_INCREMENT PRIMARY KEY, k INT with the secondary index k_1, c CHAR(120), pad
CHAR(60)); `c` is ten groups of 11 random digits joined by '-', `pad` five; `k` is
uniform over [1, table size].  One transaction is 10 point selects, one plain range
read, one SUM(k) range, one ORDER BY c range and one DISTINCT ... ORDER BY c range
(100 ids each), an UPDATE of k, an UPDATE of c, a DELETE of one id and the
re-INSERT of that id, then COMMIT.  `point_select` gives the statements of
`oltp_point_select` (one point select each, no transaction).  The table is
partitioned by its primary key, as a distributed deployment shards it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

POINT_SELECTS = 10
RANGE_SIZE = 100


def ddl(table: str = "sbtest1", partitions: int = 8) -> str:
    return (f"CREATE TABLE {table} (\n"
            "    id INT NOT NULL AUTO_INCREMENT,\n"
            "    k INT NOT NULL DEFAULT '0',\n"
            "    c CHAR(120) NOT NULL DEFAULT '',\n"
            "    pad CHAR(60) NOT NULL DEFAULT '',\n"
            "    PRIMARY KEY (id),\n"
            "    INDEX k_1 (k)\n"
            f") PARTITION BY HASH(id) PARTITIONS {partitions}")


def _digit_groups(rng: np.random.Generator, n: int, groups: int) -> np.ndarray:
    """n strings of `groups` groups of 11 random digits joined by '-'."""
    width = groups * 12 - 1
    b = rng.integers(ord("0"), ord("9") + 1, (n, width), dtype=np.uint8)
    b[:, 11::12] = ord("-")
    return np.ascontiguousarray(b).view(f"S{width}").reshape(n).astype(f"U{width}")


def c_value(rng: np.random.Generator) -> str:
    return str(_digit_groups(rng, 1, 10)[0])


def pad_value(rng: np.random.Generator) -> str:
    return str(_digit_groups(rng, 1, 5)[0])


def generate(rows: int, seed: int = 20240601) -> Dict[str, np.ndarray]:
    """Columns of `sbtest<N>` with ids 1..rows, for `TableStore.insert_arrays`."""
    rng = np.random.default_rng(seed)
    return {"id": np.arange(1, rows + 1, dtype=np.int32),
            "k": rng.integers(1, rows + 1, rows).astype(np.int32),
            "c": _digit_groups(rng, rows, 10),
            "pad": _digit_groups(rng, rows, 5)}


def point_select(rng: np.random.Generator, rows: int, n: int,
                 table: str = "sbtest1") -> List[str]:
    """n statements of sysbench's `oltp_point_select.lua`: one point select each,
    `SELECT c FROM sbtest1 WHERE id=<id>`, the id uniform over [1, rows]."""
    return [f"SELECT c FROM {table} WHERE id={int(i)}"
            for i in rng.integers(1, rows + 1, n)]


def transaction(rng: np.random.Generator, rows: int,
                table: str = "sbtest1") -> List[Tuple[str, str]]:
    """One `oltp_read_write` transaction: (statement kind, SQL) pairs."""
    def rid() -> int:
        return int(rng.integers(1, rows + 1))

    def rng_ids() -> Tuple[int, int]:
        lo = int(rng.integers(1, rows - RANGE_SIZE + 2))
        return lo, lo + RANGE_SIZE - 1

    out = [("begin", "BEGIN")]
    out += [("point_select", f"SELECT c FROM {table} WHERE id={rid()}")
            for _ in range(POINT_SELECTS)]
    lo, hi = rng_ids()
    out.append(("simple_range", f"SELECT c FROM {table} WHERE id BETWEEN {lo} AND {hi}"))
    lo, hi = rng_ids()
    out.append(("sum_range", f"SELECT SUM(k) FROM {table} WHERE id BETWEEN {lo} AND {hi}"))
    lo, hi = rng_ids()
    out.append(("order_range", f"SELECT c FROM {table} WHERE id BETWEEN {lo} AND {hi} "
                               "ORDER BY c"))
    lo, hi = rng_ids()
    out.append(("distinct_range", f"SELECT DISTINCT c FROM {table} WHERE id BETWEEN "
                                  f"{lo} AND {hi} ORDER BY c"))
    out.append(("index_update", f"UPDATE {table} SET k=k+1 WHERE id={rid()}"))
    out.append(("non_index_update",
                f"UPDATE {table} SET c='{c_value(rng)}' WHERE id={rid()}"))
    victim = rid()
    out.append(("delete", f"DELETE FROM {table} WHERE id={victim}"))
    out.append(("insert", f"INSERT INTO {table} (id, k, c, pad) VALUES ({victim}, "
                          f"{rid()}, '{c_value(rng)}', '{pad_value(rng)}')"))
    out.append(("commit", "COMMIT"))
    return out
