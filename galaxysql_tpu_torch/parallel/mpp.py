"""MPP executor: the logical plan run as per-shard stages over a device mesh (port of
`galaxysql_tpu/parallel/mpp.py`).

The reference compiles each plan node into one `shard_map` program over a
`jax.sharding.Mesh` and dispatches it from one host loop; its exchanges are
collectives inside that program.  The port keeps the single controller: one host loop
runs each stage body once per shard on that shard's tensors (`parallel/mesh.py`), and
the exchanges move blocks between the shards' tensors (`parallel/exchange.py`).  Each
shard's work launches on its own device: the join and group-by kernels take their
device from their inputs, and every tensor a stage body creates is made on its
shard's device.  Joins pick broadcast or hash shuffle by estimated build size, and
the skew plans the rules planted activate here (`exec/skew.py`): the hybrid join
splits hot keys off the shuffle, the salted aggregation spreads a hot group.

Execution state is a `DistBatch`: lanes distributed (a list of S per-shard tensors of
R rows, shard s holding the reference's slice s) or replicated (one tensor on the
mesh's home device, for post-merge results).  Row order follows the reference's:
shards concatenate 0..S-1 and an exchange delivers a destination's rows source by
source in source order, so integer, string and date results are the reference's
bit for bit and float sums differ only in their order of addition.  Each stage's
overflow flags are read together, in one host read, and drive the reference's retry
ladders.  Unsupported plan shapes raise `NotSupportedError` with the reference's
messages and the session falls back to the local engine, counted and traced; no other
error is caught.

Changes of shape, none of the rows or of any shard's rows: a join's output is cut to
its live rows (`_compact_shards`; the reference keeps the fixed pair capacity, which
multiplies down a chain of joins past one card's memory when all shards share it);
shards on one device share one broadcast copy of a join's build side and one slot CSR
over it (the reference builds one a device); a shuffle join's retry after a
pair-capacity overflow alone reuses its exchanged sides; and a single-flag retry
ladder (a broadcast join's pair capacity, an aggregation's group slots) stops its
round at the first shard that overflows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, as_tensor,
                                             dictionary_union_translation, to_device)
from galaxysql_tpu_torch.exec import fusion as _fusion
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec import skew
from galaxysql_tpu_torch.exec.operators import (DISPATCH_STATS, AggCall, HashAggOp,
                                                SortOp, SourceOp, broadcast_value, bucket_capacity,
                                                closure_cache, expr_cache_key)
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import ExprCompiler, TorchXP, _find_dictionary
from galaxysql_tpu_torch.kernels import relational as K
from galaxysql_tpu_torch.parallel import exchange
from galaxysql_tpu_torch.parallel.exchange import any_flag, read_flags
from galaxysql_tpu_torch.parallel.mesh import GLOBAL_MESH_CACHE, Mesh
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.rules import estimate_rows
from galaxysql_tpu_torch.types import collation as _coll
from galaxysql_tpu_torch.utils import errors, tracing

BROADCAST_BUILD_LIMIT = 1 << 19  # est. rows: at or below, broadcast the build side


def _shard_skew_ratio(per_shard) -> Optional[float]:
    """max/mean live rows per shard, or None for an empty stage."""
    total = float(np.sum(per_shard))
    if total <= 0:
        return None
    mean = total / len(per_shard)
    return round(float(np.max(per_shard)) / mean, 2)


def _pack_lanes(pairs):
    """Flatten [(data, valid)] lanes into one exchange payload: data lanes first,
    then the non-None valid lanes (`_unpack_lanes` mirrors the layout)."""
    return [d for d, _v in pairs] + [v for _d, v in pairs if v is not None]


def _unpack_lanes(out_lanes, template):
    """Rebuild [(data, valid)] pairs from an exchange's output lanes, using
    `template` (the pre-exchange pairs) for validity presence."""
    vix = len(template)
    res = []
    for i, (_d, v) in enumerate(template):
        nv = None
        if v is not None:
            nv = out_lanes[vix]
            vix += 1
        res.append((out_lanes[i], nv))
    return res


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def _cat_pairs(pairs, device=None):
    """Concatenate [(data, valid)] pieces into one (data, valid) pair (valid None
    when every piece's is), moved to `device` when given."""
    def mv(t):
        return t if device is None else t.to(device, non_blocking=True)
    datas = [mv(d) for d, _v in pairs]
    if all(v is None for _d, v in pairs):
        return torch.cat(datas), None
    return torch.cat(datas), torch.cat(
        [_ones(d.shape[0], d.device) if v is None else mv(v)
         for d, (_d, v) in zip(datas, pairs)])


@dataclasses.dataclass
class DistBatch:
    """Distributed: each `Column.data` (and a non-None `Column.valid`) and `live` is
    a list of S per-shard tensors.  Replicated: one tensor each, on the home
    device."""
    columns: Dict[str, Column]
    live: Any
    replicated: bool

    def env(self, s: Optional[int] = None):
        if self.replicated:
            return {n: (c.data, c.valid) for n, c in self.columns.items()}
        return {n: (c.data[s], None if c.valid is None else c.valid[s])
                for n, c in self.columns.items()}

    @property
    def capacity(self) -> int:
        """Rows of every lane together (the reference's S*R or N)."""
        if self.replicated:
            return int(self.live.shape[0])
        return sum(int(x.shape[0]) for x in self.live)

    def shard_rows(self) -> int:
        """R, the rows of one shard (all shards alike)."""
        return int(self.live[0].shape[0])


def _dist_from_shards(outs: List[Tuple[Dict[str, Tuple[Any, Any]], Any]],
                      meta: Dict[str, Tuple[Any, Any]], order=None) -> DistBatch:
    """A distributed DistBatch from per-shard ((id -> (data, valid)), live) results;
    `meta[id]` = (DataType, Dictionary)."""
    ids = order if order is not None else list(outs[0][0].keys())
    cols: Dict[str, Column] = {}
    for i in ids:
        datas = [o[0][i][0] for o in outs]
        valids = [o[0][i][1] for o in outs]
        if all(v is None for v in valids):
            vlist = None
        else:
            vlist = [_ones(d.shape[0], d.device) if v is None else v
                     for d, v in zip(datas, valids)]
        typ, dic = meta.get(i, (None, None))
        cols[i] = Column(datas, vlist, typ, dic)
    return DistBatch(cols, [o[1] for o in outs], False)


def _join_block(benv, blive, penv, plive, bk, pk, kind, residual_pred, cap,
                build_ids, probe_ids, pairs_fn=K.hash_join_pairs):
    """Per-shard equi-join: ((cols, live), overflow).

    For inner/left the output region is [cap] matched pairs; left joins append an
    [R_probe] region of null-extended unmatched probe rows (fixed total shape).
    `pairs_fn` is the pair enumeration: the CSR probe, or `hash_join_probe_hybrid`
    over the unioned broadcast + shuffled partitions of the hybrid join."""
    bkeys = [f(benv) for f in bk]
    pkeys = [f(penv) for f in pk]
    pairs = pairs_fn(bkeys, pkeys, blive, plive, cap)
    over = pairs.overflow

    bcols = {i: (K._gather(benv[i][0], pairs.build_idx),
                 None if benv[i][1] is None else K._gather(benv[i][1], pairs.build_idx))
             for i in build_ids}
    pcols = {i: (K._gather(penv[i][0], pairs.probe_idx),
                 None if penv[i][1] is None else K._gather(penv[i][1], pairs.probe_idx))
             for i in probe_ids}
    live = pairs.live
    if residual_pred is not None:
        live = live & residual_pred({**bcols, **pcols})

    if kind in ("semi", "anti"):
        matched = K.probe_matched_from(live, pairs.probe_starts, pairs.probe_offsets)
        out_live = plive & (matched if kind == "semi" else ~matched)
        return ({i: penv[i] for i in probe_ids}, out_live), over

    if kind == "left":
        matched = K.probe_matched_from(live, pairs.probe_starts, pairs.probe_offsets)
        unmatched = plive & ~matched
        dev = plive.device
        n_p = plive.shape[0]
        out = {}
        for i in build_ids:
            d, v = bcols[i]
            nd = torch.zeros(n_p, dtype=d.dtype, device=dev)
            out[i] = (torch.cat([d, nd]),
                      torch.cat([v if v is not None else torch.ones_like(live),
                                 torch.zeros(n_p, dtype=torch.bool, device=dev)]))
        for i in probe_ids:
            d, v = pcols[i]
            pd, pv = penv[i]
            out[i] = (torch.cat([d, pd]),
                      None if (v is None and pv is None) else
                      torch.cat([v if v is not None else torch.ones_like(live),
                                 pv if pv is not None else torch.ones_like(unmatched)]))
        out_live = torch.cat([live, unmatched])
        return (out, out_live), over

    # inner
    return ({**bcols, **pcols}, live), over


def _csr_pairs(csr):
    """A `pairs_fn` probing a slot CSR built once for the build lanes."""
    perm, starts, counts, M = csr

    def pairs(bkeys, pkeys, blive, plive, cap):
        return K.hash_join_probe_csr(bkeys, pkeys, blive, plive, perm, starts,
                                     counts, M, cap)
    return pairs


class MppExecutor:
    def __init__(self, ctx, mesh: Mesh):
        self.ctx = ctx
        self.mesh = mesh
        self.S = mesh.shape["shard"]
        self.devices = mesh.devices
        self.home = mesh.home

    # -- entry ---------------------------------------------------------------

    def execute(self, node: L.RelNode) -> ColumnBatch:
        return self._to_host(self.run(node))

    def _concat(self, b: DistBatch, device) -> Tuple[Dict[str, Column], torch.Tensor]:
        """Every lane of a distributed batch concatenated (shards 0..S-1) on
        `device`."""
        cols = {}
        for name, c in b.columns.items():
            pieces = [(c.data[s], None if c.valid is None else c.valid[s])
                      for s in range(self.S)]
            d, v = _cat_pairs(pieces, device)
            cols[name] = Column(d, v, c.dtype, c.dictionary)
        live = torch.cat([x.to(device, non_blocking=True) for x in b.live])
        return cols, live

    def _to_host(self, b: DistBatch) -> ColumnBatch:
        """The result batch, compacted, on the home device."""
        if b.replicated:
            return ColumnBatch(dict(b.columns), b.live).compact()
        cols, live = self._concat(b, self.home)
        return ColumnBatch(cols, live).compact()

    def _gather(self, b: DistBatch) -> DistBatch:
        """Distributed -> replicated (the live rows, compacted on the home device)."""
        host = self._to_host(b)
        n = host.capacity
        return DistBatch(dict(host.columns), _ones(n, self.home), True)

    def _rep_env(self, b: DistBatch, device):
        """A replicated batch's environment on `device`."""
        return {n: (c.data.to(device, non_blocking=True),
                    None if c.valid is None else c.valid.to(device, non_blocking=True))
                for n, c in b.columns.items()}

    # -- dispatch ------------------------------------------------------------

    def run(self, node: L.RelNode) -> DistBatch:
        # MPP stage boundary: a deadline-killed query aborts between stages with a
        # typed error instead of dispatching the rest of the plan
        self.ctx.check_deadline()
        tc = tracing.current()
        collecting = getattr(self.ctx, "collect_stats", False)
        if tc is None:
            return self._run_collect(node) if collecting else self._run_node(node)
        # traced: one `stage` span per plan node, with per-shard child spans on
        # sharded outputs (one Chrome-trace row per shard); counting shard rows
        # syncs the device, so tracing is opt-in like profiling
        sp = tc.begin(f"mpp:{type(node).__name__}", kind="stage")
        try:
            out = self._run_collect(node) if collecting else self._run_node(node)
        finally:
            tc.end(sp)
        per_shard = self._per_shard_rows(out)
        sp.attrs["rows"] = int(np.sum(per_shard))
        sp.attrs["replicated"] = out.replicated
        if not out.replicated and out.capacity:
            for si, rn in enumerate(per_shard):
                tc.add(f"shard{si}", kind="shard", parent=sp.span_id,
                       start_us=sp.start_us, dur_us=sp.dur_us, shard=si, rows=int(rn))
            ratio = _shard_skew_ratio(per_shard)
            if ratio is not None:
                # skew = max/mean live rows per shard: 1.0 is perfectly balanced,
                # ~S means one shard holds everything
                sp.attrs["skew"] = ratio
                self._note_shard_skew(ratio)
        info = getattr(self.ctx, "skew_stats", {}).get(id(node))
        if info is not None:
            sp.attrs["skew_exec"] = skew.explain_line(info)
        return out

    def _per_shard_rows(self, out: DistBatch) -> List[int]:
        """Live rows of each shard (one value for a replicated batch), in one host
        read."""
        if out.replicated:
            return [int(out.live.sum())]
        counts = torch.stack([x.sum().to(self.home) for x in out.live])
        return [int(v) for v in counts.tolist()]

    def _run_collect(self, node: L.RelNode) -> DistBatch:
        # profiling: per-stage wall and row counts (the reference's MPP
        # QueryStats/StageStats/TaskStats); counting live rows syncs the device per
        # stage, which is why the default path never enters this branch
        t0 = time.perf_counter()
        out = self._run_node(node)
        if any(st.get("node_id") == id(node) for st in self.ctx.op_stats):
            # _streaming_chain already reported this node (a fused entry with
            # per-stage rows): a second plain entry would double-count it
            return out
        per_shard = self._per_shard_rows(out)
        st = {"node_id": id(node), "operator": type(node).__name__,
              "engine": "mpp", "batches": 1, "rows_out": int(np.sum(per_shard)),
              "wall_ms": round((time.perf_counter() - t0) * 1000, 3),
              "replicated": out.replicated}
        if not out.replicated:
            # per-shard task stats: shard s's rows
            st["rows_per_shard"] = per_shard
            ratio = _shard_skew_ratio(per_shard)
            if ratio is not None:
                st["shard_skew"] = ratio
                self._note_shard_skew(ratio)
        self.ctx.op_stats.append(st)
        return out

    def _note_shard_skew(self, ratio: float):
        """`mpp_shard_skew` gauge: max/mean live rows per shard of the last
        profiled/traced MPP stage."""
        inst = getattr(self.ctx, "archive_instance", None)
        m = getattr(inst, "metrics", None)
        if m is not None:
            m.gauge("mpp_shard_skew",
                    "max/mean live rows per shard (last profiled MPP stage)"
                    ).set(ratio)

    def _run_node(self, node: L.RelNode) -> DistBatch:
        if isinstance(node, L.Scan):
            return self._scan(node)
        if isinstance(node, L.Filter):
            if self._fusing():
                return self._streaming_chain(node)
            return self._filter(node)
        if isinstance(node, L.Project):
            if self._fusing():
                return self._streaming_chain(node)
            return self._project(node)
        if isinstance(node, L.Aggregate):
            return self._aggregate_cached(node)
        if isinstance(node, L.Join):
            return self._join(node)
        if isinstance(node, L.Sort):
            return self._sort(node)
        if isinstance(node, L.Limit):
            return self._limit(node)
        if isinstance(node, L.Window):
            return self._window(node)
        if isinstance(node, L.Union):
            return self._union(node)
        raise errors.NotSupportedError(f"MPP: {type(node).__name__}")

    # -- scan ------------------------------------------------------------------

    def _scan(self, node: L.Scan) -> DistBatch:
        if node.as_of is not None:
            # flashback reads run on the local engine (loud fallback): sharded
            # lanes are keyed by the current table version only
            raise errors.NotSupportedError("AS OF scan under MPP")
        if getattr(node.table, "remote", None) is not None:
            raise errors.NotSupportedError("remote-table scan under MPP")
        t = node.table
        key = f"{t.schema.lower()}.{t.name.lower()}"
        store = self.ctx.stores[key]
        storage_cols = [c for _, c in node.columns]
        st = GLOBAL_MESH_CACHE.get(store, self.mesh, storage_cols,
                                   self.ctx.snapshot_ts, self.ctx.txn_id)
        cols = {oid: st.columns[cname] for oid, cname in node.columns}
        self.ctx.trace.append(f"mpp-scan {t.name} shards={self.S}")
        hot = DistBatch(cols, st.live, False)
        am = getattr(self.ctx, "archive", None)
        if am is not None and am.files_for(key, self.ctx.snapshot_ts):
            hot = self._concat_shards([hot, self._archive_scan(node, am, key)])
        return self._apply_scan_rf(node, hot)

    def _run_segment(self, seg, b: DistBatch):
        """One FusedSegment over every shard of `b` (once for a replicated batch):
        (computed lanes {name: [(data, valid)] per shard}, live per shard).  With
        a stats sink, one entry: the live counts after each stage summed over the
        shards, and the wall ms."""
        sink = seg.stats_sink
        tc = tracing.current()
        t0 = time.perf_counter()
        DISPATCH_STATS["dispatches"] += 1
        shards = [None] if b.replicated else list(range(self.S))
        outs, lives, counts = [], [], []
        for s in shards:
            env_in = b.env(s)
            live_in = b.live if s is None else b.live[s]
            cols = {n: Column(d, v, b.columns[n].dtype, b.columns[n].dictionary)
                    for n, (d, v) in env_in.items()}
            cb = ColumnBatch(cols, live_in)
            n = int(live_in.shape[0])
            dev = live_in.device
            if sink is not None:
                cs = [live_in.sum()]

                def on_stage(_kind, lv, _cs=cs, _n=n):
                    _cs.append(torch.broadcast_to(lv, (_n,)).sum())
                env, live = seg.apply_batch(cb, on_stage)
                counts.append(torch.stack([c.to(self.home) for c in cs]))
            else:
                env, live = seg.apply_batch(cb)
            live = live_in if live is None else torch.broadcast_to(live, (n,))
            xp = TorchXP(dev)
            outs.append({name: broadcast_value(n, *env[name], xp)
                         for name in seg.computed})
            lives.append(live)
        totals = torch.stack(counts).sum(0).cpu().numpy() if sink is not None else None
        if sink is not None or tc is not None or _fusion._tracer_on():
            # the reference's timed run: the wall histogram, the sink row, and in a
            # traced query the `segment` span
            seg._observe(tc, sink, totals, round((time.perf_counter() - t0) * 1000, 3))
        return outs, lives

    def _segment_batch(self, seg, child: DistBatch) -> DistBatch:
        """`child` with `seg` applied: computed lanes attached, passthrough lanes
        reattached from the input."""
        outs, lives = self._run_segment(seg, child)
        if child.replicated:
            cols = seg.attach_columns(child.columns, outs[0])
            return DistBatch(cols, lives[0], True)
        merged = {}
        for name in seg.computed:
            datas = [o[name][0] for o in outs]
            valids = [o[name][1] for o in outs]
            merged[name] = (datas, None if all(v is None for v in valids) else
                            [_ones(d.shape[0], d.device) if v is None else v
                             for d, v in zip(datas, valids)])
        cols = seg.attach_columns(child.columns, merged)
        return DistBatch(cols, lives, False)

    def _apply_scan_rf(self, node: L.Scan, batch: DistBatch) -> DistBatch:
        """Planned runtime filters on an MPP probe-side scan: the build side's
        published filter masks each shard's live rows before any probe stage."""
        rf = getattr(self.ctx, "rf", None)
        seg = rf.segment_for_scan(node) if rf is not None else None
        if seg is None:
            return batch
        if seg.inert():
            return batch  # filters never published: skip the identity stage
        sink = None
        if getattr(self.ctx, "collect_stats", False):
            sink = []
            seg.stats_sink = sink
        _outs, lives = self._run_segment(seg, batch)
        self.ctx.trace.append(f"mpp-rf-scan {node.table.name} filters={len(seg.stages)}")
        if sink:
            from galaxysql_tpu_torch.plan.physical import record_rf_stats
            record_rf_stats(self.ctx, seg, node, np.sum([c for c, _ in sink], axis=0))
        return DistBatch(batch.columns, lives[0] if batch.replicated else lives,
                         batch.replicated)

    def _archive_scan(self, node: L.Scan, am, key: str) -> DistBatch:
        """Cold Parquet rows row-sharded over the mesh: read on the host, padded to a
        multiple of S, shard s owning slice s (archive scans join the same MPP plan
        as hot data)."""
        inst = getattr(self.ctx, "archive_instance", None)
        t = node.table
        storage_cols = [c for _, c in node.columns]
        host = [b.compact() for b in am.scan_archive(inst, t.schema, t.name,
                                                     storage_cols, self.ctx.snapshot_ts)]
        host = [b for b in host if b.capacity]
        n = sum(b.capacity for b in host)
        Ra = max((n + self.S - 1) // self.S, 1)
        cols = {}
        for oid, cname in node.columns:
            cm = t.column(cname)
            data = np.zeros(self.S * Ra, dtype=cm.dtype.lane)
            valid = None
            if n:
                parts = [b.columns[cname] for b in host]
                data[:n] = np.concatenate([c.np_data() for c in parts])
                if any(c.valid is not None for c in parts):
                    valid = np.zeros(self.S * Ra, dtype=np.bool_)
                    valid[:n] = np.concatenate([c.np_valid() for c in parts])
            dic = t.dictionaries.get(cname.lower()) if cm.dtype.is_string else None
            cols[oid] = Column(
                [as_tensor(data[s * Ra:(s + 1) * Ra], self.devices[s])
                 for s in range(self.S)],
                None if valid is None else
                [as_tensor(valid[s * Ra:(s + 1) * Ra], self.devices[s])
                 for s in range(self.S)], cm.dtype, dic)
        live = np.zeros(self.S * Ra, dtype=np.bool_)
        live[:n] = True
        self.ctx.trace.append(f"mpp-scan-archive {t.name} rows={n}")
        return DistBatch(cols, [as_tensor(live[s * Ra:(s + 1) * Ra], self.devices[s])
                                for s in range(self.S)], False)

    # -- stateless row ops ------------------------------------------------------

    def _fusing(self) -> bool:
        # a direct read: a context type without the field must fail loudly, not
        # silently bypass NO_FUSE
        return self.ctx.enable_fusion

    def _streaming_chain(self, node) -> DistBatch:
        """A maximal Filter/Project chain as one fused segment (exec/fusion.py) over
        every shard; passthrough column buffers are reattached, never copied."""
        from galaxysql_tpu_torch.exec.fusion import chain_nodes, segment_for
        base, seg = segment_for(node, rf=getattr(self.ctx, "rf", None))
        sink = None
        if getattr(self.ctx, "collect_stats", False):
            sink = []
            seg.stats_sink = sink  # per-stage rows inside the fused chain
        child = self.run(base)
        if len(seg.stages) >= 2:
            self.ctx.trace.append(f"mpp-fuse-segment {seg.chain}")
        out = self._segment_batch(seg, child)
        if sink:
            totals = np.sum([c for c, _ in sink], axis=0)
            wall = round(sum(w for _, w in sink), 3)
            from galaxysql_tpu_torch.plan.physical import record_rf_stats
            record_rf_stats(self.ctx, seg, base if isinstance(base, L.Scan) else None,
                            totals)
            off = 1 + seg.rf_stage_count  # input count + rf prelude stages
            for i, nd in enumerate(chain_nodes(node)):
                self.ctx.op_stats.append(
                    {"node_id": id(nd), "operator": type(nd).__name__,
                     "engine": "mpp", "batches": len(sink),
                     "rows_out": int(totals[off + i]), "wall_ms": wall,
                     "fused": True, "segment": seg.chain})
        return out

    def _shards_of(self, b: DistBatch):
        """(shard index or None, device) for each stage-body run over `b`."""
        if b.replicated:
            return [(None, self.home)]
        return [(s, self.devices[s]) for s in range(self.S)]

    def _filter(self, node: L.Filter) -> DistBatch:
        child = self.run(node.child)
        DISPATCH_STATS["dispatches"] += 1
        lives = []
        for s, dev in self._shards_of(child):
            pred = closure_cache(
                ("mpp_filter", str(dev), expr_cache_key(node.cond)),
                lambda _d=dev: ExprCompiler(TorchXP(_d)).compile_predicate(node.cond))
            live = child.live if s is None else child.live[s]
            lives.append(live & pred(child.env(s)))
        return DistBatch(child.columns, lives[0] if child.replicated else lives,
                         child.replicated)

    def _project(self, node: L.Project) -> DistBatch:
        child = self.run(node.child)
        DISPATCH_STATS["dispatches"] += 1
        outs = []
        for s, dev in self._shards_of(child):
            fns = closure_cache(
                ("mpp_project", str(dev),
                 tuple((n, expr_cache_key(e)) for n, e in node.exprs)),
                lambda _d=dev: [(name, ExprCompiler(TorchXP(_d)).compile(e))
                                for name, e in node.exprs])
            live = child.live if s is None else child.live[s]
            n = int(live.shape[0])
            xp = TorchXP(dev)
            env = child.env(s)
            outs.append(({name: broadcast_value(n, *f(env), xp) for name, f in fns},
                         live))
        meta = {name: (e.dtype, _find_dictionary(e)) for name, e in node.exprs}
        if child.replicated:
            env, live = outs[0]
            cols = {name: Column(env[name][0], env[name][1], *meta[name])
                    for name, _e in node.exprs}
            return DistBatch(cols, live, True)
        return _dist_from_shards(outs, meta, [name for name, _e in node.exprs])

    # -- aggregate ---------------------------------------------------------------

    def _aggregate_cached(self, node: L.Aggregate) -> DistBatch:
        """Fragment-cached aggregate: the grouped output is deterministic and
        version-keyed, so a warm repeated query replays it instead of re-running the
        stage tree.  Profiling runs bypass (the stats must describe real stages)."""
        from galaxysql_tpu_torch.exec import fragment_cache as fc
        cache = getattr(self.ctx, "frag", None)
        if cache is None or getattr(self.ctx, "collect_stats", False):
            return self._aggregate(node)
        fkey = fc.fingerprint(node, self.ctx)
        if fkey is None:
            return self._aggregate(node)
        akey = ("mpp_agg", fkey.key, self.S, id(self.mesh), K.formulation())
        got = cache.get(akey)
        if got is not None:
            self.ctx.trace.append(
                f"frag-cache mpp agg hit [{','.join(sorted(fkey.tables))}]")
            return got
        out = self._aggregate(node)
        cache.put(akey, out, fc._nbytes_of(out), fkey.tables,
                  kind="mpp_agg", rows=out.capacity)
        return out

    def _aggregate(self, node: L.Aggregate) -> DistBatch:
        calls = [AggCall(a.kind, a.arg, a.out_id) for a in node.aggs]
        child_node, prelude = node.child, None
        if self._fusing():
            # the feeding Filter/Project chain runs inside the per-shard partial
            # pass; the base scan's runtime filters ride along as rf stages
            from galaxysql_tpu_torch.exec.fusion import segment_for
            base, prelude = segment_for(node.child, rf=getattr(self.ctx, "rf", None))
            if prelude is not None:
                child_node = base
                self.ctx.trace.append(f"mpp-fuse-agg-prelude {prelude.chain}")
        child = self.run(child_node)
        factor = skew.active_salt(node, self.ctx, self.S)
        if factor is not None and not child.replicated:
            p = node.salt_plan
            self.ctx.trace.append(
                f"mpp-salted-agg factor={factor} col={p.table}.{p.column}")
            skew.note(self.ctx, node, kind="agg", factor=factor,
                      column=f"{p.table}.{p.column}")
            return self._aggregate_salted(child, node.groups, calls,
                                          estimate_rows(node), factor, prelude=prelude)
        return self._aggregate_batch(child, node.groups, calls, estimate_rows(node),
                                     prelude=prelude)

    @staticmethod
    def _agg_specs(helper: HashAggOp):
        inputs, lanes = helper._partial_specs()
        lane_names = tuple(name for name, _ in lanes)
        specs = tuple(s for _, s in lanes)
        merge_specs = tuple(
            K.AggSpec("sum" if s.kind in ("count", "count_star", "sum") else s.kind, i)
            for i, (_, s) in enumerate(lanes))
        return inputs, lane_names, specs, merge_specs

    def _shard_input(self, child: DistBatch, s, prelude):
        """(env, live, n) of one stage-body run: the shard's lanes with the
        prelude segment applied."""
        env = child.env(s)
        live = child.live if s is None else child.live[s]
        n = int(live.shape[0])
        if prelude is not None:
            cols = {nm: Column(d, v, child.columns[nm].dtype, child.columns[nm].dictionary)
                    for nm, (d, v) in env.items()}
            env, plive = prelude.apply_batch(ColumnBatch(cols, live))
            live = live if plive is None else torch.broadcast_to(plive, (n,))
        return env, live, n

    def _merge_partials(self, partials, merge_specs, G):
        """Gather every shard's partial groups on the home device and merge them
        (the replicated result)."""
        def gather(field, i):
            return _cat_pairs([getattr(r, field)[i] for r in partials], self.home)
        flat_keys = [gather("keys", i) for i in range(len(partials[0].keys))]
        flat_aggs = [gather("aggs", j) for j in range(len(partials[0].aggs))]
        live_g = torch.cat([r.live.to(self.home, non_blocking=True) for r in partials])
        return K.groupby(flat_keys, flat_aggs, merge_specs, live_g, G)

    def _aggregate_batch(self, child: DistBatch, groups, calls, est: float,
                         prelude=None) -> DistBatch:
        helper = HashAggOp(None, groups, calls)  # spec decomposition + finalize
        inputs, lane_names, specs, merge_specs = self._agg_specs(helper)
        G = 1 << max(int(est * 2).bit_length(), 8)
        while True:
            r, overflow = self._agg_round(groups, child, inputs, specs, merge_specs, G,
                                          prelude)
            if not overflow:
                break
            G *= 2
            if G > (1 << 22):
                raise errors.TddlError("MPP aggregation exceeds group ceiling")
        # the reference's stage programs take the finalize's numpy lanes into jnp
        batch = to_device(helper._finalize(r, lane_names))
        return DistBatch(batch.columns, batch.live_mask(), True)

    def _agg_round(self, groups, child, inputs, specs, merge_specs, G, prelude=None):
        """One round of the partial + merge aggregation at G slots: (result,
        overflow).  A shard whose partial overflows ends the round at once: any
        overflow retries the whole round with 2G, as in the reference."""
        DISPATCH_STATS["dispatches"] += 1
        partials = []
        for s, dev in self._shards_of(child):
            gfns, ifns = _agg_expr_fns(groups, inputs, dev)
            env, live, n = self._shard_input(child, s, prelude)
            xp = TorchXP(dev)
            keys = [broadcast_value(n, *f(env), xp) for f in gfns]
            ins = [broadcast_value(n, *f(env), xp) for f in ifns]
            r = K.groupby(keys, ins, specs, live, G)
            if any_flag([r.overflow]):
                return None, True
            partials.append(r)
        if child.replicated:
            return partials[0], False
        m = self._merge_partials(partials, merge_specs, G)
        return m, any_flag([m.overflow])

    def _aggregate_salted(self, child: DistBatch, groups, calls, est: float,
                          factor: int, prelude=None) -> DistBatch:
        """Skew-aware salted aggregation (plan/rules.plan_skew's SaltAggPlan): rows
        repartition on hash(group key, salt), salt = row % factor, so a hot group's
        rows spread over `factor` destinations instead of piling on one; each shard
        aggregates what it received and a final merge re-combines the (at most
        factor x S) partials per group.  Same overflow ladders and finalize as the
        default path, so results are identical up to float-summation order."""
        helper = HashAggOp(None, groups, calls)
        inputs, lane_names, specs, merge_specs = self._agg_specs(helper)
        R = child.shard_rows()
        quota = max(2 * R // self.S, 128)
        G = 1 << max(int(est * 2).bit_length(), 8)
        while True:
            r, over_shuffle, over_groups = self._salted_agg_round(
                groups, child, inputs, specs, merge_specs, G, factor, quota, prelude)
            if not (over_shuffle or over_groups):
                break
            if over_shuffle:
                quota *= 2
            if over_groups:
                G *= 2
            if max(quota, G) > (1 << 22):
                raise errors.TddlError("MPP salted aggregation exceeds capacity ceiling")
        # the reference's stage programs take the finalize's numpy lanes into jnp
        batch = to_device(helper._finalize(r, lane_names))
        return DistBatch(batch.columns, batch.live_mask(), True)

    def _salted_agg_round(self, groups, child, inputs, specs, merge_specs, G, factor,
                          quota, prelude=None):
        DISPATCH_STATS["dispatches"] += 1
        payload, lives, hashes, templates = [], [], [], []
        for s, dev in self._shards_of(child):
            gfns, ifns = _agg_expr_fns(groups, inputs, dev)
            env, live, n = self._shard_input(child, s, prelude)
            xp = TorchXP(dev)
            keys0 = [broadcast_value(n, *f(env), xp) for f in gfns]
            ins0 = [broadcast_value(n, *f(env), xp) for f in ifns]
            # salted destination: the key hash (NULL-tagged, the lane a plain
            # repartition would use) mixed with row % factor
            kh = K.hash_columns(keys0) if keys0 else \
                torch.zeros(n, dtype=torch.int64, device=dev)
            salt = torch.remainder(torch.arange(n, dtype=torch.int64, device=dev), factor)
            hashes.append(K.hash_columns([(kh, None), (salt, None)]))
            pairs = keys0 + ins0
            templates.append(pairs)
            payload.append(_pack_lanes(pairs))
            lives.append(live)
        out_lanes, live_x, over_x = exchange.repartition_by_hash(
            payload, lives, hashes, quota, self.devices)
        nk = len(groups)
        partials = []
        for d in range(self.S):
            moved = _unpack_lanes(out_lanes[d], templates[d])
            partials.append(K.groupby(moved[:nk], moved[nk:], specs, live_x[d], G))
        m = self._merge_partials(partials, merge_specs, G)
        over_shuffle, over_groups = read_flags(
            [over_x], [r.overflow for r in partials] + [m.overflow])
        return m, over_shuffle, over_groups

    # -- join --------------------------------------------------------------------

    def _join(self, node: L.Join) -> DistBatch:
        if node.kind == "cross":
            left = self.run(node.left)
            right = self.run(node.right)
            # cross product is symmetric: keep a distributed side as the left
            # (stays sharded), replicate the other (small: scalar subqueries,
            # aggregated views)
            if left.replicated and not right.replicated:
                left, right = right, left
            if not right.replicated:
                right = self._gather(right)
            if int(right.live.sum()) == 1:
                return self._cross_attach(left, right)
            return self._cross_product(left, right)

        # build = right side by default; inner joins may flip to the smaller side
        build_node, probe_node = node.right, node.left
        build_keys = [b for _, b in node.equi]
        probe_keys = [a for a, _ in node.equi]
        if node.kind == "inner" and \
                estimate_rows(node.left) < estimate_rows(node.right) / 4:
            build_node, probe_node = node.left, node.right
            build_keys, probe_keys = probe_keys, build_keys

        build = self._build_side(node, build_node)
        probe = self.run(probe_node)
        if probe.replicated:
            raise errors.NotSupportedError("MPP join: replicated probe side unsupported")
        build_ids = list(build.columns.keys())
        probe_ids = list(probe.columns.keys())

        if build.replicated or estimate_rows(build_node) <= BROADCAST_BUILD_LIMIT:
            out = self._broadcast_join(node, build, probe, build_keys, probe_keys,
                                       build_ids, probe_ids)
        else:
            # shuffle shape: a heavy-hitter probe key would pile one shard, so the
            # join hybrid-splits when planning planted a skew plan for the side
            # actually probed AND its stats survive the runtime re-check
            active = skew.active_join_skew(
                node, self.ctx, "left" if probe_node is node.left else "right", self.S)
            if active is not None:
                out = self._hybrid_join(node, build, probe, build_keys, probe_keys,
                                        build_ids, probe_ids, active)
            else:
                out = self._shuffle_join(node, build, probe, build_keys, probe_keys,
                                         build_ids, probe_ids)
        return self._join_result(node, out)

    def _build_side(self, node: L.Join, build_node: L.RelNode) -> DistBatch:
        """Run (or reuse) a join's build side.  The distributed build lanes and the
        runtime filters published from them are fragment-cached per mesh: a warm
        join goes straight to the probe subtree with the sharded build already on
        the devices and the filters in hand."""
        from galaxysql_tpu_torch.exec import fragment_cache as fc
        from galaxysql_tpu_torch.exec import runtime_filter as rfmod
        build_is_left = build_node is node.left
        cache = getattr(self.ctx, "frag", None)
        akey = None
        active_specs = rfmod.specs_for(node, "right" if build_is_left else "left",
                                       getattr(self.ctx, "rf", None))
        if cache is not None:
            fkey = fc.fingerprint(build_node, self.ctx)
            if fkey is not None:
                # the active filter-spec set is part of the identity: a
                # RUNTIME_FILTER(OFF) run must not poison the filters-on path
                rf_sig = tuple(sorted((s.filter_id, tuple(sorted(s.kinds)))
                                      for s in active_specs))
                akey = ("mpp_build", fkey.key, self.S, id(self.mesh), rf_sig,
                        K.formulation())
                art = cache.get(akey)
                if art is not None:
                    self.ctx.trace.append(
                        f"frag-cache mpp build hit [{','.join(sorted(fkey.tables))}]")
                    if getattr(self.ctx, "collect_stats", False):
                        self.ctx.op_stats.append(
                            {"node_id": id(build_node), "engine": "mpp",
                             "operator": type(build_node).__name__,
                             "batches": 0, "rows_out": art.rows,
                             "wall_ms": 0.0, "cached": True})
                    rfmod.publish_captured(getattr(self.ctx, "rf", None),
                                           active_specs, art.filters)
                    return art.batch
        build = self.run(build_node)
        specs = self._publish_rf(node, build, build_is_left)
        if akey is not None:
            art = fc.BuildArtifact(batch=build)
            art.rows = build.capacity
            art.filters = rfmod.capture_published(getattr(self.ctx, "rf", None), specs)
            cache.put(akey, art, fc.artifact_nbytes(art), fkey.tables,
                      kind="mpp_build", rows=art.rows)
        return build

    def _publish_rf(self, node: L.Join, build: DistBatch, build_is_left: bool):
        """Publish the build side's runtime filters: the reference's size gate on
        the build's lanes, then the filters built on the home device from the
        build-key columns (`fusion.publish_on_device`, held to the reference's host
        build)."""
        from galaxysql_tpu_torch.exec import fusion
        from galaxysql_tpu_torch.exec import runtime_filter as rfmod
        rf = getattr(self.ctx, "rf", None)
        probe_side = "right" if build_is_left else "left"
        specs = rfmod.specs_for(node, probe_side, rf)
        if not specs:
            return []
        if rf.mode != "off" and build.capacity <= rfmod.RF_PUBLISH_MAX_LANES:
            needed = rfmod._build_key_columns(specs)
            sub = DistBatch({i: c for i, c in build.columns.items() if i in needed},
                            build.live, build.replicated)
            if build.replicated:
                cols, live = dict(sub.columns), sub.live
            else:
                cols, live = self._concat(sub, self.home)
            fusion.publish_on_device(rf, specs, ColumnBatch(cols, live))
        self.ctx.trace.append(f"mpp-rf-publish filters={len(specs)}")
        return specs

    def _join_key_fns(self, build_keys, probe_keys, dev):
        """Key closures on `dev` (the local join's: string keys from different
        dictionaries translate probe codes into the build dictionary's space)."""
        return ops.HashJoinOp(None, None, build_keys, probe_keys)._key_compilers(dev)

    def _residual(self, node, dev):
        if node.residual is None:
            return None
        return closure_cache(("mpp_residual", str(dev), expr_cache_key(node.residual)),
                             lambda: ExprCompiler(TorchXP(dev)).compile_predicate(
                                 node.residual))

    def _broadcast_join(self, node, build, probe, build_keys, probe_keys,
                        build_ids, probe_ids):
        probe_R = probe.shard_rows()
        cap = bucket_capacity(max(probe_R * 2, 1024))
        # every shard gets the whole build side: replicated already, or all-gathered
        # (shards on one device share one copy, and one slot CSR over it)
        if build.replicated:
            benvs = {}
            for dev in self.devices:
                if str(dev) not in benvs:
                    benvs[str(dev)] = (self._rep_env(build, dev),
                                       build.live.to(dev, non_blocking=True))
            per_shard = [benvs[str(dev)] for dev in self.devices]
        else:
            ids = list(build.columns.keys())
            pairs = [[build.env(s)[i] for i in ids] for s in range(self.S)]
            glanes, glive = exchange.broadcast_all(
                [_pack_lanes(p) for p in pairs], build.live, self.devices)
            per_shard = []
            for s in range(self.S):
                moved = _unpack_lanes(glanes[s], pairs[s])
                per_shard.append((dict(zip(ids, moved)), glive[s]))
        # the sort branch builds no CSR: each shard's pairs come from the sorted
        # build hashes (`K.hash_join_pairs`), as in the reference's broadcast join
        csrs: Dict[int, Any] = {}
        scatter = K.prefer_scatter()
        while True:
            outs = []
            for s in range(self.S):
                dev = self.devices[s]
                bk, pk = self._join_key_fns(build_keys, probe_keys, dev)
                benv, blive = per_shard[s]
                pairs_fn = K.hash_join_pairs
                if scatter:
                    csr = csrs.get(id(blive))
                    if csr is None:
                        bkeys = [f(benv) for f in bk]
                        csr = K._device_csr(bkeys, blive, int(blive.shape[0]))
                        csrs[id(blive)] = csr
                    pairs_fn = _csr_pairs(csr)
                res, over = _join_block(benv, blive, probe.env(s), probe.live[s], bk, pk,
                                        node.kind, self._residual(node, dev), cap,
                                        build_ids, probe_ids, pairs_fn=pairs_fn)
                if any_flag([over]):
                    break  # the one flag of the round: retry at once with 2 cap
                outs.append(res)
            if len(outs) == self.S:
                return outs
            cap *= 2
            if cap > (1 << 24):
                raise errors.TddlError("MPP join output exceeds capacity ceiling")

    def _exchange_side(self, b: DistBatch, key_fns_of, quota, live=None, hashes=None):
        """Hash-repartition a distributed side on its join keys: per destination
        (env, live), and the overflow flag.  `live` overrides the batch's live
        masks (the hybrid join's cold rows); `hashes` are precomputed key hashes."""
        ids = list(b.columns.keys())
        payload, templates, lives, hs = [], [], [], []
        for s in range(self.S):
            env = b.env(s)
            pairs = [env[i] for i in ids]
            templates.append(pairs)
            payload.append(_pack_lanes(pairs))
            lives.append(b.live[s] if live is None else live[s])
            if hashes is None:
                keys = [f(env) for f in key_fns_of(self.devices[s])]
                hs.append(K.hash_columns(keys))
        out_lanes, live_x, over = exchange.repartition_by_hash(
            payload, lives, hs if hashes is None else hashes, quota, self.devices)
        envs = [dict(zip(ids, _unpack_lanes(out_lanes[d], templates[d])))
                for d in range(self.S)]
        return envs, live_x, over

    def _shuffle_join(self, node, build, probe, build_keys, probe_keys,
                      build_ids, probe_ids):
        bR = build.shard_rows()
        pR = probe.shard_rows()
        quota_b = max(2 * bR // self.S, 128)
        quota_p = max(2 * pR // self.S, 128)
        cap = bucket_capacity(max(2 * quota_p * self.S, 1024))

        def bkf(dev):
            return self._join_key_fns(build_keys, probe_keys, dev)[0]

        def pkf(dev):
            return self._join_key_fns(build_keys, probe_keys, dev)[1]
        moved: Dict[Tuple[str, int], Any] = {}
        while True:
            if ("b", quota_b) not in moved:
                moved = {k: v for k, v in moved.items() if k[0] != "b"}
                moved[("b", quota_b)] = self._exchange_side(build, bkf, quota_b)
            if ("p", quota_p) not in moved:
                moved = {k: v for k, v in moved.items() if k[0] != "p"}
                moved[("p", quota_p)] = self._exchange_side(probe, pkf, quota_p)
            benvs, blives, over_b = moved[("b", quota_b)]
            penvs, plives, over_p = moved[("p", quota_p)]
            outs, caps = [], []
            for d in range(self.S):
                dev = self.devices[d]
                bk, pk = self._join_key_fns(build_keys, probe_keys, dev)
                res, over = _join_block(benvs[d], blives[d], penvs[d], plives[d], bk, pk,
                                        node.kind, self._residual(node, dev), cap,
                                        build_ids, probe_ids)
                outs.append(res)
                caps.append(over)
            ob, op_, oc = read_flags([over_b], [over_p], caps)
            if not (ob or op_ or oc):
                return outs
            if ob:
                quota_b *= 2
            if op_:
                quota_p *= 2
            if oc:
                cap *= 2
            if max(quota_b, quota_p, cap) > (1 << 24):
                raise errors.TddlError("MPP shuffle exceeds capacity ceiling")

    def _hybrid_join(self, node, build, probe, build_keys, probe_keys,
                     build_ids, probe_ids, active):
        """Skew-aware hybrid shuffle join (hot/cold split).

        The skewed side's hot rows stay where the scan layout already balanced
        them (the hash shuffle is what would concentrate them), and the other
        side's hot rows, few, are broadcast to every shard, compacted into a fixed
        `hot_quota` lane first.  Cold rows of both sides hash-shuffle as in
        `_shuffle_join`, with quotas sized for the unskewed remainder.  Orientation
        'probe': skew on the probe side (hot build rows broadcast); 'build': skew on
        the build side (hot probe rows broadcast; inner joins only).  Each shard then
        probes the union of its broadcast and shuffled partitions in one
        `hash_join_probe_hybrid` pass.  Rows are classified by the same combined key
        hash on both sides, so a hot row's matches are always resident and a cold
        row's always shuffle to its hash shard: each output pair materializes
        exactly once whatever the hot set holds."""
        hot = active.hot_hashes()
        H = max(8, 1 << max(len(hot) - 1, 0).bit_length())  # static pad ladder
        hot_h = np.zeros(H, np.uint64)
        hot_h[:len(hot)] = hot
        hot_v = np.zeros(H, np.bool_)
        hot_v[:len(hot)] = True
        skew_on_probe = active.orientation == "probe"
        bR = build.shard_rows()
        pR = probe.shard_rows()
        # the broadcast side carries few rows per hot key, so start small and let
        # the ladder grow; the kept-local hot rows of the skewed side compact into
        # their own quota lane (~hot-mass x R per shard)
        hot_quota = max(2 * H, 128)
        loc_quota = max((pR if skew_on_probe else bR) // 2, 128)
        # the skewed side's cold shuffle excludes the hot mass: size its quota for
        # the remainder (the ladder covers sketch underestimates)
        cold = 1.0 - active.hot_mass()
        quota_b = max(2 * bR // self.S, 128)
        quota_p = max(2 * pR // self.S, 128)
        if skew_on_probe:
            quota_p = max(int(quota_p * cold), 128)
        else:
            quota_b = max(int(quota_b * cold), 128)
        p = active.plan
        self.ctx.trace.append(
            f"mpp-hybrid-join hot={len(hot)} col={p.table}.{p.column} "
            f"skew={active.orientation}")
        skew.note(self.ctx, node, kind="join", hot=len(hot),
                  column=f"{p.table}.{p.column}")
        # pair capacity as in _shuffle_join: hybrid pairs are balanced across
        # shards (that is the point), so the fair-share bound holds
        cap = bucket_capacity(max(2 * quota_p * self.S, 1024))

        # per shard: key lanes, hash lanes and the hot masks (independent of the
        # quotas, so computed once for every round of the ladder)
        cls = []
        for s in range(self.S):
            dev = self.devices[s]
            bk, pk = self._join_key_fns(build_keys, probe_keys, dev)
            benv, penv = build.env(s), probe.env(s)
            bkeys = [f(benv) for f in bk]
            pkeys = [f(penv) for f in pk]
            hoth, hotv = as_tensor(hot_h, dev), as_tensor(hot_v, dev)
            hot_b = K.hot_key_mask(bkeys, hoth, hotv) & build.live[s]
            hot_p = K.hot_key_mask(pkeys, hoth, hotv) & probe.live[s]
            cls.append((hot_b, hot_p, K.hash_columns(bkeys), K.hash_columns(pkeys)))

        def compact_hot(env, hot_mask, ids, q):
            """Rows under `hot_mask` compacted into a [q] lane env: a rank scatter on
            the scatter branch, the first q of a stable argsort (live rows first) on
            the sort branch, as in the reference."""
            dev = hot_mask.device
            over = hot_mask.to(torch.int32).sum() > q
            if K.prefer_scatter():
                rank = torch.cumsum(hot_mask.to(torch.int64), 0) - 1
                pos = torch.where(hot_mask & (rank < q), rank,
                                  torch.full_like(rank, q))
                slots = torch.full((q + 1,), hot_mask.shape[0], dtype=torch.int64,
                                   device=dev)
                slots[pos] = torch.arange(hot_mask.shape[0], device=dev)
                slots = slots[:q]
            else:
                slots = torch.argsort((~hot_mask).to(torch.int8), stable=True)[:q]

            def compact(lane):
                return exchange._take(lane, slots)
            out = {i: (compact(env[i][0]),
                       None if env[i][1] is None else compact(env[i][1])) for i in ids}
            return out, compact(hot_mask), over

        def union(a_env, a_live, b_env, b_live, ids):
            out = {i: _cat_pairs([a_env[i], b_env[i]]) for i in ids}
            return out, torch.cat([a_live, b_live])

        while True:
            cold_b = [build.live[s] & ~cls[s][0] for s in range(self.S)]
            cold_p = [probe.live[s] & ~cls[s][1] for s in range(self.S)]
            cb_envs, cb_live, over_b = self._exchange_side(
                build, None, quota_b, live=cold_b, hashes=[c[2] for c in cls])
            cp_envs, cp_live, over_p = self._exchange_side(
                probe, None, quota_p, live=cold_p, hashes=[c[3] for c in cls])
            # the broadcast side's hot rows, compacted per shard, then all-gathered
            src, src_ids, src_mask = (build, build_ids, 0) if skew_on_probe else \
                (probe, probe_ids, 1)
            loc, loc_ids, loc_mask = (probe, probe_ids, 1) if skew_on_probe else \
                (build, build_ids, 0)
            hot_pairs, hot_lives, overs_h = [], [], []
            for s in range(self.S):
                cenv, clive, over = compact_hot(src.env(s), cls[s][src_mask], src_ids,
                                                hot_quota)
                hot_pairs.append([cenv[i] for i in src_ids])
                hot_lives.append(clive)
                overs_h.append(over)
            glanes, glive = exchange.broadcast_all(
                [_pack_lanes(pr) for pr in hot_pairs], hot_lives, self.devices)
            outs, overs_l, caps = [], [], []
            for s in range(self.S):
                dev = self.devices[s]
                ghot = dict(zip(src_ids, _unpack_lanes(glanes[s], hot_pairs[s])))
                lenv, llive, over_l = compact_hot(loc.env(s), cls[s][loc_mask], loc_ids,
                                                  loc_quota)
                overs_l.append(over_l)
                if skew_on_probe:
                    ubenv, ublive = union(ghot, glive[s], cb_envs[s], cb_live[s],
                                          build_ids)
                    upenv, uplive = union(lenv, llive, cp_envs[s], cp_live[s],
                                          probe_ids)
                else:
                    ubenv, ublive = union(lenv, llive, cb_envs[s], cb_live[s],
                                          build_ids)
                    upenv, uplive = union(ghot, glive[s], cp_envs[s], cp_live[s],
                                          probe_ids)
                bk, pk = self._join_key_fns(build_keys, probe_keys, dev)
                res, over_cap = _join_block(ubenv, ublive, upenv, uplive, bk, pk,
                                            node.kind, self._residual(node, dev), cap,
                                            build_ids, probe_ids,
                                            pairs_fn=K.hash_join_probe_hybrid)
                outs.append(res)
                caps.append(over_cap)
            over_h, over_l, ob, op_, oc = read_flags(overs_h, overs_l, [over_b],
                                                     [over_p], caps)
            if not (over_h or over_l or ob or op_ or oc):
                return outs
            if over_h:
                hot_quota *= 2
            if over_l:
                loc_quota *= 2
            if ob:
                quota_b *= 2
            if op_:
                quota_p *= 2
            if oc:
                cap *= 2
            if max(hot_quota, loc_quota, quota_b, quota_p, cap) > (1 << 24):
                raise errors.TddlError("MPP hybrid join exceeds capacity ceiling")

    def _join_result(self, node, outs) -> DistBatch:
        src_meta = {fid: (typ, d)
                    for fid, typ, d in (node.left.fields() + node.right.fields())}
        return _dist_from_shards(self._compact_shards(outs), src_meta)

    def _compact_shards(self, outs):
        """Per-shard join outputs with their live rows first, cut to one bucketed
        length for every shard.  The reference keeps each output at its pair
        capacity (a fixed shape a device), and the next stage sizes its own capacity
        from that shape, so a chain of joins multiplies it; with every shard on one
        card that runs out of its memory at SF 1.  A stable order keeps each shard's
        rows, and their order, as they were."""
        counts = torch.stack([lv.sum().to(self.home) for _c, lv in outs]).tolist()
        R = bucket_capacity(max(max(counts), 1))
        if R >= int(outs[0][1].shape[0]):
            return outs
        out = []
        for cols, live in outs:
            idx = torch.argsort((~live).to(torch.int8), stable=True)[:R]
            out.append(({i: (d[idx], None if v is None else v[idx])
                         for i, (d, v) in cols.items()}, live[idx]))
        return out

    def _cross_attach(self, left: DistBatch, right: DistBatch) -> DistBatch:
        # a 1-row replicated right side (an uncorrelated scalar subquery):
        # broadcast its columns
        idx = int(torch.argmax(right.live.to(torch.int8)))
        cols = dict(left.columns)
        for name, c in right.columns.items():
            if left.replicated:
                n = int(left.live.shape[0])
                d = c.data[idx].expand(n)
                v = None if c.valid is None else c.valid[idx].expand(n)
            else:
                d = [c.data[idx].to(dev).expand(int(lv.shape[0]))
                     for dev, lv in zip(self.devices, left.live)]
                v = None if c.valid is None else \
                    [c.valid[idx].to(dev).expand(int(lv.shape[0]))
                     for dev, lv in zip(self.devices, left.live)]
            cols[name] = Column(d, v, c.dtype, c.dictionary)
        return DistBatch(cols, left.live, left.replicated)

    # -- window -------------------------------------------------------------------

    def _window(self, node: L.Window) -> DistBatch:
        """Window functions distribute by hash-repartitioning rows on the PARTITION
        BY keys, then running the window kernel per shard: partitions are wholly
        shard-local after the shuffle, so the frames are exact."""
        from galaxysql_tpu_torch.exec.operators import WindowOp, _U64Order, _u64_input
        child = self.run(node.child)
        if child.replicated or not node.partitions:
            # a global window needs every row in one place: the local operator
            child = child if child.replicated else self._gather(child)
            batch = ColumnBatch(dict(child.columns), child.live)
            op = WindowOp(SourceOp([batch.pad_to(bucket_capacity(max(batch.capacity,
                                                                     1)))]),
                          node.partitions, node.orders, node.calls,
                          out_schema=node.fields())
            out = next(iter(op.batches()))
            return DistBatch(dict(out.columns), out.live_mask(), True)

        helper = WindowOp(None, node.partitions, node.orders, node.calls)
        inputs, lanes = helper._specs()
        specs = tuple(s for _, s in lanes)
        quota = max(2 * child.shard_rows() // self.S, 128)
        cids = list(child.columns.keys())

        def fns(dev):
            key = ("mpp_window", str(dev),
                   tuple(expr_cache_key(p) for p in node.partitions),
                   tuple((expr_cache_key(e), d) for e, d in node.orders),
                   tuple(e.key() if isinstance(e, _U64Order) else expr_cache_key(e)
                         for e in inputs))

            def build():
                comp = ExprCompiler(TorchXP(dev))
                return ([comp.compile(p) for p in node.partitions],
                        [(comp.compile(e), d) for e, d in node.orders],
                        [_u64_input(comp.compile(e.expr)) if isinstance(e, _U64Order)
                         else comp.compile(e) for e in inputs])
            return closure_cache(key, build)

        while True:
            payload, templates, hashes = [], [], []
            for s in range(self.S):
                dev = self.devices[s]
                pfns, _o, _i = fns(dev)
                env = child.env(s)
                n = int(child.live[s].shape[0])
                xp = TorchXP(dev)
                # shuffle rows so each partition-key group lands on one shard
                hashes.append(K.hash_columns([broadcast_value(n, *f(env), xp)
                                              for f in pfns]))
                pairs = [env[i] for i in cids]
                templates.append(pairs)
                payload.append(_pack_lanes(pairs))
            out_lanes, live_x, over = exchange.repartition_by_hash(
                payload, child.live, hashes, quota, self.devices)
            if not bool(over):
                break
            quota *= 2
            if quota > (1 << 24):
                raise errors.TddlError("MPP window shuffle exceeds capacity")

        results = []
        for d in range(self.S):
            dev = self.devices[d]
            pfns, ofns, ifns = fns(dev)
            new_env = dict(zip(cids, _unpack_lanes(out_lanes[d], templates[d])))
            n = int(live_x[d].shape[0])
            xp = TorchXP(dev)
            pk = [broadcast_value(n, *f(new_env), xp) for f in pfns]
            ok = []
            for f, desc in ofns:
                dd, vv = broadcast_value(n, *f(new_env), xp)
                ok.append((dd, vv, desc, not desc))
            ins = [broadcast_value(n, *f(new_env), xp) for f in ifns]
            order, live_s, outs = K.window_eval(pk, ok, ins, specs, live_x[d])
            cols = {}
            for i in cids:
                c = child.columns[i]
                dd, vv = new_env[i]
                cols[i] = Column(dd[order], None if vv is None else vv[order],
                                 c.dtype, c.dictionary)
            results.append(helper.finalize_calls(cols, live_s, outs, lanes))
        meta = {i: (c.dtype, c.dictionary) for i, c in results[0].columns.items()}
        return _dist_from_shards(
            [({i: (c.data, c.valid) for i, c in b.columns.items()}, b.live)
             for b in results], meta, list(results[0].columns.keys()))

    # -- union ---------------------------------------------------------------------

    def _union(self, node: L.Union) -> DistBatch:
        """UNION [ALL]: per-shard concatenation of the children (no data movement);
        UNION DISTINCT adds a group-by-all-columns dedup on top."""
        outs = [self.run(c) for c in node.children]
        first = node.children[0]
        first_ids = first.field_ids()
        fields = first.fields()
        # align column ids and dictionaries to the first child (fresh merged
        # dictionaries when children encode strings against different tables)
        aligned: List[DistBatch] = []
        out_dicts: Dict[str, Any] = {fid: dic for fid, _typ, dic in fields}
        for child, b in zip(node.children, outs):
            mapping = dict(zip(child.field_ids(), first_ids))
            cols = {}
            for i, c in b.columns.items():
                fid = mapping[i]
                target = out_dicts.get(fid)
                if c.dictionary is not None and target is not None and \
                        c.dictionary is not target:
                    # translate codes into the first child's dictionary (grown with
                    # any values only the other children carry)
                    trans = dictionary_union_translation(target, c.dictionary)
                    if b.replicated:
                        data = as_tensor(trans, c.data.device)[c.data.to(torch.int64)]
                    else:
                        data = [as_tensor(trans, d.device)[d.to(torch.int64)]
                                for d in c.data]
                    c = Column(data, c.valid, c.dtype, target)
                else:
                    c = Column(c.data, c.valid, c.dtype, target)
                cols[fid] = c
            aligned.append(DistBatch(cols, b.live, b.replicated))

        if any(b.replicated for b in aligned):
            from galaxysql_tpu_torch.chunk.batch import concat_batches
            host = [self._to_host(b) for b in aligned]
            merged = concat_batches(host)
            cols = {fid: Column(c.data.to(self.home), None if c.valid is None else
                                c.valid.to(self.home), c.dtype, out_dicts[fid])
                    for fid, c in merged.columns.items()}
            result = DistBatch(cols, _ones(merged.capacity, self.home), True)
        else:
            result = self._concat_shards(aligned)

        if node.all:
            return result
        groups = [(fid, ir.ColRef(fid, typ, out_dicts[fid])) for fid, typ, _d in fields]
        est = sum(estimate_rows(c) for c in node.children)
        return self._aggregate_batch(result, groups, [], est)

    def _concat_shards(self, batches: List[DistBatch]) -> DistBatch:
        """Per-shard concatenation of distributed batches with identical column
        ids: shard s of the result is every input's shard s, in order (a
        zero-communication UNION ALL)."""
        ids = list(batches[0].columns.keys())
        ref = batches[0].columns
        cols = {}
        for fid in ids:
            datas, valids = [], []
            for s in range(self.S):
                d, v = _cat_pairs([(b.columns[fid].data[s],
                                    None if b.columns[fid].valid is None else
                                    b.columns[fid].valid[s]) for b in batches])
                datas.append(d)
                valids.append(v)
            cols[fid] = Column(datas, None if all(v is None for v in valids) else valids,
                               ref[fid].dtype, ref[fid].dictionary)
        live = [torch.cat([b.live[s] for b in batches]) for s in range(self.S)]
        return DistBatch(cols, live, False)

    def _cross_product(self, left: DistBatch, right: DistBatch) -> DistBatch:
        """General cartesian: each shard pairs its left rows with the (compacted)
        replicated right side; the filter above extracts any join predicate."""
        rb = ColumnBatch(dict(right.columns), right.live).compact()
        if rb.capacity == 0:  # empty right side: empty product, shapes kept
            cols = dict(left.columns)
            for i, c in right.columns.items():
                if left.replicated:
                    n = int(left.live.shape[0])
                    cols[i] = Column(torch.zeros(n, dtype=c.data.dtype, device=self.home),
                                     torch.zeros(n, dtype=torch.bool, device=self.home),
                                     c.dtype, c.dictionary)
                else:
                    cols[i] = Column(
                        [torch.zeros(int(lv.shape[0]), dtype=c.data.dtype,
                                     device=lv.device) for lv in left.live],
                        [torch.zeros(int(lv.shape[0]), dtype=torch.bool,
                                     device=lv.device) for lv in left.live],
                        c.dtype, c.dictionary)
            dead = torch.zeros_like(left.live) if left.replicated else \
                [torch.zeros_like(lv) for lv in left.live]
            return DistBatch(cols, dead, left.replicated)
        M = rb.capacity
        R = left.capacity if left.replicated else left.shard_rows()
        if R * M > (1 << 22):
            raise errors.NotSupportedError(
                f"MPP cross product too large ({R}x{M} per shard)")

        def block(lenv, llive, dev):
            out = {}
            for i, (d, v) in lenv.items():
                out[i] = (torch.repeat_interleave(d, M),
                          None if v is None else torch.repeat_interleave(v, M))
            for i, c in rb.columns.items():
                d = c.data.to(dev)
                out[i] = (d.repeat(R), None if c.valid is None else
                          c.valid.to(dev).repeat(R))
            live = torch.repeat_interleave(llive, M) & _ones(M, dev).repeat(R)
            return out, live

        meta = {i: (c.dtype, c.dictionary) for i, c in left.columns.items()}
        meta.update({i: (c.dtype, c.dictionary) for i, c in rb.columns.items()})
        order = list(left.columns.keys()) + list(rb.columns.keys())
        if left.replicated:
            out, live = block(left.env(), left.live, self.home)
            return DistBatch({i: Column(out[i][0], out[i][1], *meta[i]) for i in order},
                             live, True)
        return _dist_from_shards([block(left.env(s), left.live[s], self.devices[s])
                                  for s in range(self.S)], meta, order)

    # -- sort / limit ----------------------------------------------------------------

    def _sort(self, node: L.Sort) -> DistBatch:
        child = self.run(node.child)
        if not child.replicated and node.limit is not None:
            # distributed top-n: each shard keeps only its local top (limit+offset)
            # rows before the gather; the global winners are among them
            child = self._local_topn(node, child)
        if not child.replicated:
            child = self._gather(child)
        batch = ColumnBatch(dict(child.columns), child.live)
        op = SortOp(SourceOp([batch.pad_to(bucket_capacity(max(batch.capacity, 1)))]),
                    node.keys, node.limit, node.offset)
        out = next(iter(op.batches()))
        return DistBatch(out.columns, out.live_mask(), True)

    def _local_topn(self, node: L.Sort, child: DistBatch) -> DistBatch:
        R = child.shard_rows()
        k = min(node.limit + node.offset, R)
        if k >= R:  # nothing to cut
            return child
        cids = list(child.columns.keys())
        outs = []
        for s in range(self.S):
            dev = self.devices[s]
            kfns = closure_cache(
                ("mpp_topn", str(dev),
                 tuple((expr_cache_key(e), d) for e, d in node.keys)),
                lambda _d=dev: [(ExprCompiler(TorchXP(_d)).compile(e), d)
                                for e, d in node.keys])
            env = child.env(s)
            live = child.live[s]
            n = int(live.shape[0])
            xp = TorchXP(dev)
            keys = []
            for f, desc in kfns:
                d, v = broadcast_value(n, *f(env), xp)
                # MySQL default: NULLs first ascending, last descending
                keys.append((d, v, desc, not desc))
            top = K.sort_indices(keys, live)[:k]
            outs.append(({i: (env[i][0][top], None if env[i][1] is None else
                              env[i][1][top]) for i in cids}, live[top]))
        self.ctx.trace.append(f"mpp-topn k={k}")
        meta = {i: (c.dtype, c.dictionary) for i, c in child.columns.items()}
        return _dist_from_shards(outs, meta, cids)

    def _limit(self, node: L.Limit) -> DistBatch:
        child = self.run(node.child)
        if not child.replicated:
            child = self._gather(child)
        live = K.limit_mask(child.live, node.offset, node.limit)
        return DistBatch(child.columns, live, True)


def _agg_expr_fns(groups, inputs, dev):
    """(group fns, input fns) of an aggregation stage on `dev`: compiled group keys
    and agg inputs, dictionary-code inputs re-ranked for collation-correct MIN/MAX
    and BIGINT UNSIGNED MIN/MAX inputs read in unsigned order (as `HashAggOp`'s
    partial pass does)."""
    key = ("mpp_agg_fns", str(dev), tuple((n, expr_cache_key(e)) for n, e in groups),
           tuple(e.key() if isinstance(e, ops._U64Order) else expr_cache_key(e)
                 for e in inputs))

    def build():
        comp = ExprCompiler(TorchXP(dev))
        gfns = [comp.compile(e) for _, e in groups]
        ifns = []
        for e in inputs:
            if isinstance(e, ops._U64Order):
                ifns.append(ops._u64_input(comp.compile(e.expr)))
                continue
            f = comp.compile(e)
            d_ = ops._needs_rank(e)
            if d_ is not None:
                f = ops._ranked(f, _coll.sort_rank_array(e, d_), dev)
            ifns.append(f)
        return gfns, ifns
    return closure_cache(key, build)
