"""Maintenance surfaces: the recycle bin, CHECK TABLE and the index advisor (port of
`galaxysql_tpu/server/maintain.py`).

- The recycle bin: DROP TABLE renames the table into the bin (`__recycle__<name>_<ms>_
  <seq>`) instead of destroying it; FLASHBACK TABLE ... TO BEFORE DROP restores the
  most recent entry; PURGE destroys for real.  As in the reference, tables with global
  indexes drop directly: a GSI's backing table is not restorable as a pair.  A parked
  table keeps its store, so its lanes stay in the device cache and its first query
  after FLASHBACK is warm; PURGE drops the store and its cached lanes
  (`Instance.drop_store`).
- The index advisor: an equality, IN-list or equi-join column of a scan that no PK
  lead, partition lead or index lead serves becomes a CREATE GLOBAL INDEX suggestion
  covering the scan's other columns, so the suggestion is routable by
  `route_covering_gsi`.

- CHECK TABLE (`check_table`): every partition's lanes, validity and stamps agree
  on the row count, and every PUBLIC global index holds the FastChecker checksum of
  its base table (`utils/fastchecker.check_gsi`, host numpy over the row store).
"""

from __future__ import annotations

import itertools
import json
import time
from typing import List, Optional

from galaxysql_tpu_torch.utils import errors

_BIN_PREFIX = "recycle.bin."
# disambiguates two drops of a same-named table in the same millisecond: a
# collision would overwrite, and lose, the table parked first
_BIN_SEQ = itertools.count(1)


class RecycleBin:
    """DROP TABLE parks tables here instead of destroying them."""

    def __init__(self, instance):
        self.instance = instance

    def _entries(self) -> List[dict]:
        out = []
        for _k, v in self.instance.metadb.kv_scan(_BIN_PREFIX):
            try:
                out.append(json.loads(v))
            except Exception:
                continue
        return sorted(out, key=lambda d: d["dropped_at"])

    def rows(self):
        return [(d["bin_name"], d["original"], d["schema"],
                 time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(d["dropped_at"])))
                for d in self._entries()]

    def drop(self, tm) -> bool:
        """Park `tm` in the bin.  False when the table is not recyclable (it has
        global indexes or is remote): the caller drops it directly."""
        if getattr(tm, "remote", None) is not None or \
                any(i.global_index for i in tm.indexes):
            return False
        inst = self.instance
        bin_name = f"__recycle__{tm.name}_{int(time.time() * 1000)}_{next(_BIN_SEQ)}"
        cat = inst.catalog
        s = cat.schema(tm.schema)
        store = inst.store(tm.schema, tm.name)
        del s.tables[tm.name.lower()]
        inst.metadb.drop_table(tm.schema, tm.name)
        inst.stores.pop(inst.store_key(tm.schema, tm.name), None)
        original = tm.name
        tm.name = bin_name
        s.tables[bin_name.lower()] = tm
        inst.stores[inst.store_key(tm.schema, bin_name)] = store
        inst.metadb.save_table(tm)
        inst.metadb.kv_put(_BIN_PREFIX + bin_name.lower(), json.dumps(
            {"bin_name": bin_name, "original": original, "schema": tm.schema,
             "dropped_at": time.time()}))
        cat.bump_schema()
        return True

    def flashback(self, schema: str, original: str,
                  rename_to: Optional[str] = None) -> str:
        """Restore the most recent bin entry for `original`."""
        inst = self.instance
        cands = [d for d in self._entries()
                 if d["schema"].lower() == schema.lower() and
                 d["original"].lower() == original.lower()]
        if not cands:
            raise errors.TddlError(f"no dropped table '{original}' in the recycle bin")
        entry = cands[-1]
        target = rename_to or original
        cat = inst.catalog
        s = cat.schema(schema)
        if target.lower() in s.tables or cat.view(schema, target) is not None:
            raise errors.TddlError(f"cannot flashback: '{target}' already exists")
        tm = s.tables[entry["bin_name"].lower()]
        store = inst.store(schema, entry["bin_name"])
        del s.tables[entry["bin_name"].lower()]
        inst.metadb.drop_table(schema, entry["bin_name"])
        inst.stores.pop(inst.store_key(schema, entry["bin_name"]), None)
        tm.name = target
        s.tables[target.lower()] = tm
        inst.stores[inst.store_key(schema, target)] = store
        inst.metadb.save_table(tm)
        inst.metadb.kv_delete(_BIN_PREFIX + entry["bin_name"].lower())
        cat.bump_schema()
        return target

    def purge(self, bin_name: Optional[str] = None) -> int:
        """Destroy one entry (by bin name) or every entry; returns the count."""
        inst = self.instance
        n = 0
        for d in self._entries():
            if bin_name is not None and d["bin_name"].lower() != bin_name.lower():
                continue
            schema = d["schema"]
            try:
                inst.catalog.drop_table(schema, d["bin_name"], if_exists=True)
            except errors.TddlError:
                pass
            inst.drop_store(schema, d["bin_name"])
            inst.metadb.kv_delete(_BIN_PREFIX + d["bin_name"].lower())
            n += 1
        if bin_name is not None and n == 0:
            raise errors.TddlError(f"'{bin_name}' is not in the recycle bin")
        return n

    def purge_schema(self, schema: str):
        """DROP DATABASE also empties that schema's bin entries."""
        for d in self._entries():
            if d["schema"].lower() == schema.lower():
                self.instance.metadb.kv_delete(_BIN_PREFIX + d["bin_name"].lower())


def check_table(instance, tm, store) -> List[tuple]:
    """CHECK TABLE rows for one table: the structural invariants, then the GSI
    checksums."""
    rows = []
    ok = True
    # structural: every lane, validity and stamp array agrees on the row count
    for p in store.partitions:
        n = p.num_rows
        for c in tm.columns:
            lane = p.lanes.get(c.name)
            valid = p.valid.get(c.name)
            if lane is None or valid is None or lane.shape[0] != n or \
                    valid.shape[0] != n or p.end_ts.shape[0] != n:
                rows.append((f"{tm.schema}.{tm.name}", "check", "Error",
                             f"partition {p.pid} lane '{c.name}' shape mismatch"))
                ok = False
    # GSI consistency: the order-insensitive checksum of base against index table
    from galaxysql_tpu_torch.utils import fastchecker
    for i in tm.indexes:
        if not i.global_index or i.status != "PUBLIC":
            continue
        try:
            res = fastchecker.check_gsi(instance, tm.schema, tm.name, i.name)
        except errors.TddlError as e:
            rows.append((f"{tm.schema}.{tm.name}", "check", "Error", f"gsi {i.name}: {e}"))
            ok = False
            continue
        if not res.get("consistent", False):
            rows.append((f"{tm.schema}.{tm.name}", "check", "Error",
                         f"gsi {i.name} diverges from base "
                         f"(base_rows={res.get('base_rows')}, "
                         f"gsi_rows={res.get('gsi_rows')})"))
            ok = False
    if ok:
        rows.append((f"{tm.schema}.{tm.name}", "check", "status", "OK"))
    return rows


def advise_indexes(instance, plan) -> List[tuple]:
    """GSI suggestions for a bound SELECT plan: (table, column, reason, CREATE
    GLOBAL INDEX statement) for every unserved equality, IN-list or join-key
    column of a scan."""
    from galaxysql_tpu_torch.expr import ir
    from galaxysql_tpu_torch.plan import logical as L
    from galaxysql_tpu_torch.plan.rules import _col_lit_cmp, conjuncts

    suggestions = []
    seen = set()

    def served(tm, col: str) -> bool:
        leads = set()
        if tm.primary_key:
            leads.add(tm.primary_key[0].lower())
        if tm.partition.columns:
            leads.add(tm.partition.columns[0].lower())
        for i in tm.indexes:
            if i.columns:
                leads.add(i.columns[0].lower())
        return col.lower() in leads

    def suggest(scan, col: str, why: str):
        tm = scan.table
        if "$" in tm.name or getattr(tm, "remote", None) is not None:
            return
        if served(tm, col):
            return
        key = (tm.schema.lower(), tm.name.lower(), col.lower())
        if key in seen:
            return
        seen.add(key)
        covering = [c for _, c in scan.columns
                    if c.lower() != col.lower() and
                    c.lower() not in (x.lower() for x in tm.primary_key)]
        cov = f" COVERING ({', '.join(covering)})" if covering else ""
        suggestions.append((tm.name, col, why,
                            f"CREATE GLOBAL INDEX g_{col} ON {tm.name} ({col}){cov}"))

    def eq_cols_of(cond, scan):
        id_to_col = {oid: c for oid, c in scan.columns}
        for c in conjuncts(cond):
            if isinstance(c, ir.Call) and c.op == "eq" and len(c.args) == 2:
                cl = _col_lit_cmp(c)
                if cl is not None and cl[0].name in id_to_col:
                    yield id_to_col[cl[0].name], "equality predicate"
            if isinstance(c, ir.InList) and not c.negated and \
                    isinstance(c.arg, ir.ColRef) and c.arg.name in id_to_col:
                yield id_to_col[c.arg.name], "IN-list predicate"

    scans_by_id = {}
    for n in L.walk(plan.rel):
        if isinstance(n, L.Scan):
            for oid, col in n.columns:
                scans_by_id[oid] = (n, col)

    for n in L.walk(plan.rel):
        if isinstance(n, L.Filter) and isinstance(n.child, L.Scan):
            for col, why in eq_cols_of(n.cond, n.child):
                suggest(n.child, col, why)
        if isinstance(n, L.Join):
            for a, b in n.equi:
                for side in (a, b):
                    if isinstance(side, ir.ColRef) and side.name in scans_by_id:
                        scan, col = scans_by_id[side.name]
                        suggest(scan, col, "join key")
    return suggestions
