"""TPC-H refresh functions as SQL statements (TPC-H specification, section 2.5).

RF1 inserts SF x 1,500 new orders with 1 to 7 lineitems each; RF2 deletes SF x 1,500
existing orders and their lineitems.  The new rows come from `tpch.generate(sf /
1000, seed)` (1,500 orders at SF 1), cut to SF x 1,500 orders, with their order keys
moved above the loaded table's largest; the RF2 keys are seeded draws, without
repeats, of the loaded order keys.  RF1 is a few multi-row INSERTs (an INSERT
appends whole partitions, so row-by-row inserts would copy each partition per row),
RF2 one `DELETE ... WHERE ... IN (...)` for lineitem and one for orders.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from galaxysql_tpu_torch.storage import tpch
from galaxysql_tpu_torch.types.temporal import format_date

ORDER_COLUMNS = ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                 "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
                 "o_comment")
LINEITEM_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
                    "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment")
DATE_COLUMNS = {"o_orderdate", "l_shipdate", "l_commitdate", "l_receiptdate"}


def refresh_orders(sf: float) -> int:
    return max(1, int(round(sf * 1500)))


def rf1_rows(sf: float, max_orderkey: int, seed: int = 19980802) -> Dict[str, Dict]:
    """{"orders": columns, "lineitem": columns} of RF1's new rows."""
    n = refresh_orders(sf)
    g = tpch.generate(sf / 1000, seed)
    o, li = g["orders"], g["lineitem"]
    keep = set(o["o_orderkey"][:n])
    orders = {c: list(o[c][:n]) for c in ORDER_COLUMNS}
    rows = [i for i, k in enumerate(li["l_orderkey"]) if k in keep]
    lineitem = {c: [li[c][i] for i in rows] for c in LINEITEM_COLUMNS}
    orders["o_orderkey"] = [max_orderkey + k for k in orders["o_orderkey"]]
    lineitem["l_orderkey"] = [max_orderkey + k for k in lineitem["l_orderkey"]]
    return {"orders": orders, "lineitem": lineitem}


def rf2_keys(sf: float, orderkeys: np.ndarray, seed: int = 19980803) -> List[int]:
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.asarray(orderkeys), refresh_orders(sf), replace=False)
    return sorted(int(k) for k in keys)


def _literal(column: str, v) -> str:
    if v is None:
        return "NULL"
    if column in DATE_COLUMNS:
        return f"'{format_date(v)}'"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return repr(v)


def insert_statements(table: str, columns: Sequence[str], data: Dict,
                      rows_per_statement: int) -> List[str]:
    n = len(data[columns[0]])
    out = []
    for lo in range(0, n, rows_per_statement):
        hi = min(lo + rows_per_statement, n)
        values = ",\n".join(
            "(" + ", ".join(_literal(c, data[c][i]) for c in columns) + ")"
            for i in range(lo, hi))
        out.append(f"INSERT INTO {table} ({', '.join(columns)}) VALUES\n{values}")
    return out


def rf1_statements(rows: Dict[str, Dict], rows_per_statement: int = 1500) -> List[str]:
    return (insert_statements("orders", ORDER_COLUMNS, rows["orders"],
                              rows_per_statement) +
            insert_statements("lineitem", LINEITEM_COLUMNS, rows["lineitem"],
                              rows_per_statement))


def rf2_statements(keys: Sequence[int]) -> List[str]:
    inlist = ", ".join(str(k) for k in keys)
    return [f"DELETE FROM lineitem WHERE l_orderkey IN ({inlist})",
            f"DELETE FROM orders WHERE o_orderkey IN ({inlist})"]
