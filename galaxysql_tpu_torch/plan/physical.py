"""Physical planning: logical plan -> operator tree (trimmed port of
`galaxysql_tpu/plan/physical.py`).

- scans read whole tables as one device-resident batch (lanes cached per table
  version), with MVCC visibility computed on the device;
- hash join sides: build = smaller estimated input (the probe side streams);
  left/semi/anti joins fix the probe side to the preserved/output side;
- aggregates use estimated group counts to size the fixed-shape kernel output.

Filter and Project run as separate operators.  The runtime filters and skew plans the
rules plant on the logical tree are ignored here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.rules import estimate_rows
from galaxysql_tpu_torch.storage.table_store import TableStore
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
    """Device-side MVCC visibility (the reference's `_device_visibility`)."""
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
        self.ctx.trace.append(
            f"scan {t.name} partitions={self.node.partitions or 'all'}")
        b = self._fused_table_batch(t, store, pids)
        if b is not None:
            yield b.rename(rename)  # fused cols are storage-name keyed

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


def build_operator(node: L.RelNode, ctx: ExecContext) -> ops.Operator:
    if isinstance(node, L.Scan):
        return ScanSource(node, ctx)
    if isinstance(node, L.Filter):
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
    if isinstance(node, L.Join):
        return _build_join(node, ctx)
    if isinstance(node, L.Sort):
        return ops.SortOp(build_operator(node.child, ctx), node.keys, node.limit,
                          node.offset)
    if isinstance(node, L.Limit):
        return ops.LimitOp(build_operator(node.child, ctx), node.limit, node.offset)
    raise errors.NotSupportedError(f"no physical operator for {type(node).__name__}")


def _build_join(node: L.Join, ctx: ExecContext) -> ops.Operator:
    if node.kind == "cross":
        raise errors.NotSupportedError("cross joins")
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
