"""Physical planning: logical plan -> operator tree (trimmed port of
`galaxysql_tpu/plan/physical.py`).

- scans read whole tables as one device-resident batch (lanes cached per table
  version), with MVCC visibility computed on the device; a scan the rules marked
  `point_eq` reads its candidate rows through the partitions' sorted key indexes on
  the host and ships them as one small batch;
- hash join sides: build = smaller estimated input (the probe side streams);
  left/semi/anti joins fix the probe side to the preserved/output side;
- aggregates use estimated group counts to size the fixed-shape kernel output;
- cross joins (the scalar-subquery shape) keep their build side whole; a filter over
  a cross join is run as an equi join where it can be (`_through_cross`);
- UNION children are renamed to the first child's ids, and string codes translated
  into the first child's dictionaries, on the lanes' device; UNION DISTINCT and
  ROLLUP's grouping sets run `DistinctOp` / `HashAggOp` over that;
- VALUES rows and window functions have their own operators.

Filter and Project run as separate operators.  The runtime filters and skew plans the
rules plant on the logical tree are ignored here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, as_tensor,
                                             batch_from_pydict,
                                             dictionary_union_translation)
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.rules import conjuncts, estimate_rows
from galaxysql_tpu_torch.storage.table_store import TableStore
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors


class ExecContext:
    """Per-execution context: stores, snapshot, params, device, device cache."""

    def __init__(self, stores: Dict[str, TableStore], snapshot_ts: Optional[int],
                 device, device_cache: Optional[DeviceCache] = None,
                 params: Optional[list] = None, txn_id: int = 0, hints=None):
        self.stores = stores          # "schema.table" -> TableStore
        self.snapshot_ts = snapshot_ts
        self.device = torch.device(device)
        self.device_cache = device_cache if device_cache is not None \
            else DeviceCache(self.device)
        if self.device_cache.device != self.device:
            raise ValueError(f"device cache on {self.device_cache.device}, "
                             f"execution on {self.device}")
        self.params = params or []
        self.txn_id = txn_id          # owning txn for MVCC visibility (0 = none)
        self.hints = hints or {}
        self.trace: List[str] = []


# per-(store, version, partitions) scan metadata: O(table) host reductions run once
# per version, not per query
_SCAN_META: Dict = {}


def _scan_meta(store, version: int, pids) -> Dict:
    key = (store.uid, version, pids)
    meta = _SCAN_META.get(key)
    if meta is None:
        all_current = True
        max_begin = 0
        for pid in pids:
            p = store.partitions[pid]
            if p.num_rows == 0:
                continue
            if not (bool((p.end_ts == np.iinfo(np.int64).max).all()) and
                    bool((p.begin_ts >= 0).all())):
                all_current = False
            else:
                max_begin = max(max_begin, int(p.begin_ts.max()))
        meta = {"all_current": all_current, "max_begin": max_begin, "valid_all": {}}
        if len(_SCAN_META) > 512:
            _SCAN_META.clear()
        _SCAN_META[key] = meta
    return meta


def _device_visibility(begin, end, ts, txn_id):
    """Device-side MVCC visibility: the twin of `table_store.visible_rows` (one change
    of the semantics must touch both).  Stamps stay int64 throughout; the fused pad
    rows (begin 0, end -1) come out visible and are masked by `::padlive`."""
    if ts is None:
        ins_ok = begin >= 0
        dele = end != np.iinfo(np.int64).max
    else:
        ins_ok = (begin >= 0) & (begin <= ts)
        dele = (end >= 0) & (end <= ts)
    if txn_id:
        ins_ok = ins_ok | (begin == -txn_id)
        dele = dele | (end == -txn_id)
    return ins_ok & ~dele


class ScanSource(ops.Operator):
    """Storage scan renamed into plan field-id space: the scanned partitions fused
    into ONE batch whose lanes come from the device cache."""

    def __init__(self, node: L.Scan, ctx: ExecContext):
        self.node = node
        self.ctx = ctx

    def batches(self) -> Iterator[ColumnBatch]:
        t = self.node.table
        if getattr(t, "remote", None) is not None:
            raise errors.NotSupportedError(f"remote table {t.name}")
        if self.node.as_of is not None:
            raise errors.NotSupportedError("AS OF TSO scans")
        store = self.ctx.stores[f"{t.schema.lower()}.{t.name.lower()}"]
        rename = {c: oid for oid, c in self.node.columns}
        pids = tuple(range(len(store.partitions)) if self.node.partitions is None
                     else self.node.partitions)
        if self.node.point_eq is not None:
            b = self._point_batch(t, store, pids)
            if b is not None:
                yield b.rename(rename)
            return
        self.ctx.trace.append(
            f"scan {t.name} partitions={self.node.partitions or 'all'}")
        b = self._fused_table_batch(t, store, pids)
        if b is not None:
            yield b.rename(rename)  # fused cols are storage-name keyed

    def _point_batch(self, t, store, pids) -> Optional[ColumnBatch]:
        """Index access path: candidate rows from each partition's sorted key index
        instead of whole lanes (the reference's `_point_batches`).  The index and the
        row store live on the host, so the candidates are found and gathered there
        and shipped as ONE small batch on the context's device.  The Filter above
        the scan re-verifies the whole predicate, so candidates only need to be a
        superset of the matches for the indexed column; MVCC visibility is applied
        here (`Partition.key_rows`)."""
        col, val = self.node.point_eq
        ts, txn_id = self.ctx.snapshot_ts, self.ctx.txn_id
        lanes: Dict[str, List[np.ndarray]] = {c: [] for _oid, c in self.node.columns}
        valids: Dict[str, List[np.ndarray]] = {c: [] for _oid, c in self.node.columns}
        total = 0
        for pid in pids:
            p = store.partitions[pid]
            if p.num_rows == 0:
                continue
            with p.lock:
                ids = p.key_rows(col, val, ts, txn_id)
                if ids.size == 0:
                    continue
                for _oid, cname in self.node.columns:
                    lanes[cname].append(p.lanes[cname][ids])
                    valids[cname].append(p.valid[cname][ids])
            self.ctx.trace.append(f"point-get {t.name} p{pid} rows={ids.size}")
            total += ids.size
        if total == 0:
            return None
        dev = self.ctx.device
        cols = {}
        for _oid, cname in self.node.columns:
            v = np.concatenate(valids[cname])
            cols[cname] = Column(as_tensor(np.concatenate(lanes[cname]), dev),
                                 None if bool(v.all()) else as_tensor(v, dev),
                                 t.column(cname).dtype, t.dictionaries.get(cname.lower()))
        return ColumnBatch(cols, None)

    def _fused_table_batch(self, t, store, pids) -> Optional[ColumnBatch]:
        cache = self.ctx.device_cache
        ts = self.ctx.snapshot_ts
        parts = [store.partitions[p] for p in pids]
        total = sum(p.num_rows for p in parts)
        if total == 0:
            return None
        cap = ops.bucket_capacity(total)
        sig = -1 if self.node.partitions is None else pids

        def fused(name, arrays, fill=0):
            def build():
                lane = np.full(cap, fill, dtype=arrays[0].dtype)
                off = 0
                for arr in arrays:
                    lane[off:off + arr.shape[0]] = arr
                    off += arr.shape[0]
                return lane
            # lazy: a cache hit must not pay the O(table) host concatenation
            return cache.get_lane_built(store, sig, name, t.version, cap, build)

        meta = _scan_meta(store, t.version, pids)
        cols = {}
        for _oid, cname in self.node.columns:
            cm = t.column(cname)
            data = fused(cname, [p.lanes[cname] for p in parts])
            valid = None
            v_all = meta["valid_all"].get(cname)
            if v_all is None:
                v_all = all(bool(p.valid[cname].all()) for p in parts)
                meta["valid_all"][cname] = v_all
            if not v_all:
                valid = fused(f"valid::{cname}", [p.valid[cname] for p in parts], False)
            cols[cname] = Column(data, valid, cm.dtype, t.dictionaries.get(cname.lower()))
        all_current = meta["all_current"] and (ts is None or meta["max_begin"] <= ts)
        pad_live = None
        if cap != total:
            # the pad mask is version-static: cache it beside the lanes
            pad_live = cache.get_lane_built(store, sig, "::padlive", t.version, cap,
                                            lambda: np.arange(cap) < total)
        if all_current:
            live = pad_live
        else:
            begin = fused("::begin_ts", [p.begin_ts for p in parts])
            end = fused("::end_ts", [p.end_ts for p in parts], -1)
            live = _device_visibility(begin, end, ts, self.ctx.txn_id)
            if pad_live is not None:
                live = live & pad_live
        return ColumnBatch(cols, live)


class ValuesSource(ops.Operator):
    """Literal rows (and SELECT without FROM: one anonymous row) on the context's
    device."""

    def __init__(self, node: L.Values, ctx: ExecContext):
        self.node = node
        self.ctx = ctx

    def batches(self) -> Iterator[ColumnBatch]:
        rows = self.node.rows
        if not self.node.schema:
            b = batch_from_pydict({"__one": [1] * max(len(rows), 1)},
                                  {"__one": dt.BIGINT})
        else:
            data = {fid: [r[i] for r in rows] for i, (fid, _, _) in
                    enumerate(self.node.schema)}
            schema = {fid: typ for fid, typ, _ in self.node.schema}
            dicts = {fid: d for fid, typ, d in self.node.schema if d is not None}
            b = batch_from_pydict(data, schema, dicts)
        dev = self.ctx.device
        yield ColumnBatch({n: Column(c.data.to(dev),
                                     None if c.valid is None else c.valid.to(dev),
                                     c.dtype, c.dictionary)
                           for n, c in b.columns.items()}, None)


class UnionOp(ops.Operator):
    """UNION ALL: every child renamed to the first child's field ids, string codes
    translated into the first child's dictionaries (children from different tables
    encode against different dictionaries, and concatenating raw codes would decode
    wrong values).  The translation table goes to the lane's device; the lane does
    not leave it."""

    def __init__(self, children: List[ops.Operator], id_lists: List[List[str]],
                 target_dicts: Dict):
        self.children_ops = children
        self.id_lists = id_lists
        self.target_dicts = target_dicts

    def batches(self) -> Iterator[ColumnBatch]:
        first_ids = self.id_lists[0]
        for op, ids in zip(self.children_ops, self.id_lists):
            rename = dict(zip(ids, first_ids))
            for b in op.batches():
                yield self._align(b.rename(rename))

    def _align(self, b: ColumnBatch) -> ColumnBatch:
        cols = {}
        for fid, c in b.columns.items():
            tgt = self.target_dicts.get(fid)
            if c.dictionary is None or tgt is None or c.dictionary is tgt:
                cols[fid] = c
                continue
            trans = as_tensor(dictionary_union_translation(tgt, c.dictionary),
                              c.data.device)
            cols[fid] = Column(trans[c.data.to(torch.int64)], c.valid, c.dtype, tgt)
        return ColumnBatch(cols, b.live)


def build_operator(node: L.RelNode, ctx: ExecContext) -> ops.Operator:
    if isinstance(node, L.Scan):
        return ScanSource(node, ctx)
    if isinstance(node, L.Values):
        return ValuesSource(node, ctx)
    if isinstance(node, L.Filter):
        rewritten = _through_cross(node)
        if rewritten is not None:
            return build_operator(rewritten, ctx)
        return ops.FilterOp(build_operator(node.child, ctx), node.cond)
    if isinstance(node, L.Project):
        return ops.ProjectOp(build_operator(node.child, ctx), node.exprs)
    if isinstance(node, L.Aggregate):
        est = estimate_rows(node)
        max_groups = 1 << max(int(est * 2).bit_length(), 10)
        max_groups = min(max_groups, 1 << 22)
        calls = [ops.AggCall(a.kind, a.arg, a.out_id) for a in node.aggs]
        return ops.HashAggOp(build_operator(node.child, ctx), node.groups, calls,
                             max_groups=max_groups)
    if isinstance(node, L.Window):
        return ops.WindowOp(build_operator(node.child, ctx), node.partitions,
                            node.orders, node.calls, out_schema=node.fields())
    if isinstance(node, L.Join):
        return _build_join(node, ctx)
    if isinstance(node, L.Sort):
        return ops.SortOp(build_operator(node.child, ctx), node.keys, node.limit,
                          node.offset)
    if isinstance(node, L.Limit):
        return ops.LimitOp(build_operator(node.child, ctx), node.limit, node.offset)
    if isinstance(node, L.Union):
        u = UnionOp([build_operator(c, ctx) for c in node.children],
                    [c.field_ids() for c in node.children],
                    {fid: d for fid, _t, d in node.children[0].fields()})
        if node.all:
            return u
        return ops.DistinctOp(u, [(fid, ir.ColRef(fid, typ, d))
                                  for fid, typ, d in node.fields()])
    raise errors.NotSupportedError(f"no physical operator for {type(node).__name__}")


def _through_cross(node: L.Filter) -> Optional[L.RelNode]:
    """A filter over a cross join as the operators run it, or None to run it as is.

    The copied rules leave a predicate above a scalar cross (an uncorrelated scalar
    subquery) even where it reads only the cross's probe side, so an equi predicate
    between the two sides of a plain cross below never becomes a join key: TPC-H
    Q15's supplier x revenue0, 10,000 x 10,000 rows at SF 1, past
    `CrossJoinOp.MAX_CELLS`.  Here conjuncts that read only the probe side move below
    a scalar cross (which keeps each probe row once), and equi conjuncts across a
    plain cross make it an inner equi join.  The rows are the same; the logical plan
    is not touched."""
    child = node.child
    if not (isinstance(child, L.Join) and child.kind == "cross"):
        return None
    conj = conjuncts(node.cond)
    left_ids = set(child.left.field_ids())
    if child.scalar:
        below = [set(ir.referenced_columns(c)) <= left_ids for c in conj]
        if not any(below):
            return None
        j = L.Join(L.Filter(child.left, ir.and_(*[c for c, b in zip(conj, below) if b])),
                   child.right, "cross", [])
        j.scalar = True
        rest = [c for c, b in zip(conj, below) if not b]
        return L.Filter(j, ir.and_(*rest)) if rest else j
    right_ids = set(child.right.field_ids())
    equi, rest = [], []
    for c in conj:
        if isinstance(c, ir.Call) and c.op == "eq":
            a, b = c.args
            ra, rb = set(ir.referenced_columns(a)), set(ir.referenced_columns(b))
            if ra and rb and ra <= left_ids and rb <= right_ids:
                equi.append((a, b))
                continue
            if ra and rb and rb <= left_ids and ra <= right_ids:
                equi.append((b, a))
                continue
        rest.append(c)
    if not equi:
        return None
    j = L.Join(child.left, child.right, "inner", equi)
    return L.Filter(j, ir.and_(*rest)) if rest else j


def _build_join(node: L.Join, ctx: ExecContext) -> ops.Operator:
    if node.kind == "cross":
        bschema = {fid: (typ, d) for fid, typ, d in node.right.fields()}
        return ops.CrossJoinOp(build_operator(node.right, ctx),
                               build_operator(node.left, ctx),
                               scalar=getattr(node, "scalar", False),
                               build_schema=bschema)
    lkeys = [a for a, _ in node.equi]
    rkeys = [b for _, b in node.equi]
    bloom = not ctx.hints.get("no_bloom", False)
    if node.kind in ("left", "semi", "anti"):
        # probe side MUST be the preserved/output (left) side
        right_schema = {fid: (typ, d) for fid, typ, d in node.right.fields()}
        return ops.HashJoinOp(build_operator(node.right, ctx),
                              build_operator(node.left, ctx),
                              rkeys, lkeys, node.kind, residual=node.residual,
                              build_schema=right_schema, enable_bloom=bloom)
    # inner: build the smaller estimated side
    if estimate_rows(node.right) <= estimate_rows(node.left):
        build_node, probe_node = node.right, node.left
        build_keys, probe_keys = rkeys, lkeys
    else:
        build_node, probe_node = node.left, node.right
        build_keys, probe_keys = lkeys, rkeys
    build_schema = {fid: (typ, d) for fid, typ, d in build_node.fields()}
    return ops.HashJoinOp(build_operator(build_node, ctx), build_operator(probe_node, ctx),
                          build_keys, probe_keys, "inner", residual=node.residual,
                          build_schema=build_schema, enable_bloom=bloom)
