"""Physical planning: logical plan -> operator tree (trimmed port of
`galaxysql_tpu/plan/physical.py`).

- the engine is the reference's choice (`Session._exec_context`): an AP plan, while
  ENABLE_TPU_ENGINE holds, scans whole tables as one device-resident batch (lanes
  cached per table version) with MVCC visibility computed on the device, and a
  full-table scan of more than FUSE_MAX_ROWS rows streams one cached batch a
  partition instead; a context without a device cache (a TP plan, or the engine off)
  scans `TableStore.scan`'s host batches, up to 1M visible rows a partition, padded to
  their capacity bucket; a scan the rules marked `point_eq` reads its candidate rows
  through the partitions' sorted key indexes on the host, one host batch a partition;
  VALUES rows are a host batch too.  Filter, Project and fused segments run a host
  batch of at most `ops.TP_HOST_ROWS` rows with numpy, and every other operator
  takes it onto the context's device (`chunk.batch.to_device`);
- a scan of a remote table (one a worker process holds, `net/worker.py`) ships a
  bound fragment (pruned columns, lane-domain SARGs, runtime-filter ranges and
  IN-lists, a point key, the session's branch xid) to an endpoint `read_endpoint`
  picks, failing over within the statement, and degrades to SQL text when the
  worker refuses the fragment; the rows come back as one batch on the context's
  device, strings encoded into this instance's dictionaries (`remote_column`);
- a scan reads at the context's snapshot, or, under AS OF TSO n, at n with no
  transaction's provisional rows; the archive's batches of the table come first
  (`storage/archive.py`), then, where the session routed the query to the columnar
  replica (`ExecContext.columnar`, never for AS OF), the replica's stripes pruned by
  the scan's SARGs (`storage/columnar.py`), else the row store;
- hash join sides: build = smaller estimated input (the probe side streams);
  left/semi/anti joins fix the probe side to the preserved/output side;
- aggregates use estimated group counts to size the fixed-shape kernel output;
- aggregates, hash joins and sorts get the context's spill thresholds
  (`SORT_SPILL_BYTES`, `JOIN_SPILL_BYTES` per session, the agg threshold fixed): past
  them they spill partials, grace-partition both join sides, or merge sorted runs
  through host files (`exec/spill.py`);
- cross joins (the scalar-subquery shape) keep their build side whole; a filter over
  a cross join is run as an equi join where it can be (`_through_cross`);
- UNION children are renamed to the first child's ids, and string codes translated
  into the first child's dictionaries, on the lanes' device; UNION DISTINCT and
  ROLLUP's grouping sets run `DistinctOp` / `HashAggOp` over that;
- VALUES rows and window functions have their own operators.

The reference's single-device execution hub, on by default with its switches:

- pipeline fusion (`exec/fusion.py`; `GALAXYSQL_FUSION=0`, the NO_FUSE hint): a
  Filter/Project chain of two or more stages runs as one `FusedPipelineOp`; the chain
  feeding an aggregate runs inside its partial pass (`HashAggOp(prelude=...)`) and an
  all-filter chain above an inner join's probe scan inside the probe
  (`HashJoinOp(probe_prelude=...)`);
- runtime filters (`exec/runtime_filter.py`; NO_BLOOM, RUNTIME_FILTER(OFF)): join
  builds publish bloom/min-max filters into `ExecContext.rf`; the probe-side scans
  apply them as `("rf", ...)` stages of a segment (`_wrap_scan_rf` where no segment
  took them), and their min/max ranges refute archive files and replica stripes
  (`_rf_pushdown`);
- the cross-query fragment cache (`exec/fragment_cache.py`; FRAGMENT_CACHE(OFF),
  `ENABLE_FRAGMENT_CACHE`, `GALAXYSQL_FRAGMENT_CACHE=0`): join builds reuse cached
  build artifacts, and aggregates and build subtrees replay their output
  (`CachedSubplanOp`).  The skew plans the rules plant stay inert here: as in the
  reference, only MPP execution (`parallel/mpp.py`) activates them.

With `ExecContext.collect_stats` set (EXPLAIN ANALYZE) every operator is wrapped in a
`StatsOp` that records its batches, live rows and wall time in `ctx.op_stats`; fused
chains report per-stage rows through `SegmentStatsOp`, runtime filters their pruned
rows; `annotate_explain` draws them onto the plan's explain lines.  Profiling runs
no preludes and replays no aggregate, as in the reference.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, Dictionary,
                                             as_tensor, batch_from_pydict,
                                             dictionary_union_translation)
from galaxysql_tpu_torch.exec import fragment_cache as fc
from galaxysql_tpu_torch.exec import fusion
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec import skew as _skew
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.exec.runtime_filter import RuntimeFilterManager, specs_for
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.rules import conjuncts, estimate_rows
from galaxysql_tpu_torch.storage.table_store import TableStore
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal
from galaxysql_tpu_torch.utils import errors, events, tracing
from galaxysql_tpu_torch.utils.metrics import WORKER_FAILOVERS


class ExecContext:
    """Per-execution context: stores, snapshot, params, device, device cache."""

    def __init__(self, stores: Dict[str, TableStore], snapshot_ts: Optional[int],
                 device, device_cache: Optional[DeviceCache] = None,
                 params: Optional[list] = None, txn_id: int = 0, hints=None,
                 archive=None, archive_instance=None):
        self.stores = stores          # "schema.table" -> TableStore
        self.snapshot_ts = snapshot_ts
        self.device = torch.device(device)
        # None: no device cache, the reference's engine for TP statements and for
        # ENABLE_TPU_ENGINE = 0 (`Session._exec_context`): scans yield host batches
        self.device_cache = device_cache
        if device_cache is not None and device_cache.device != self.device:
            raise ValueError(f"device cache on {device_cache.device}, "
                             f"execution on {self.device}")
        self.params = params or []
        self.txn_id = txn_id          # owning txn for MVCC visibility (0 = none)
        self.archive = archive        # ArchiveManager (cold parquet scans)
        self.archive_instance = archive_instance
        self.hints = hints or {}
        self.trace: List[str] = []
        # open worker branches of the session's txn: addr -> xid.  Remote scans
        # ship the xid so the worker reads through the branch (read-your-own-
        # writes across the process seam)
        self.remote_xids: Dict = {}
        # EXPLAIN ANALYZE instrumentation: per-operator rows/batches/wall time
        self.collect_stats = False
        self.op_stats: List[dict] = []
        self.sort_spill_bytes = 256 << 20   # SORT_SPILL_BYTES (session override)
        self.join_spill_bytes = 256 << 20   # JOIN_SPILL_BYTES
        self.agg_spill_bytes = 256 << 20    # partial-agg spill threshold
        # per-query memory pool (exec/memory.py) that join builds, agg partials and
        # sort slabs charge: the session makes one for a query admission control
        # governs (`Session._run_query_admitted`); None makes every charge a no-op
        self.mem_pool = None
        # columnar replica routing (storage/columnar.py): table key -> ReplicaView
        # snapshot taken at routing; scans of those tables read the replica at the
        # routed watermark instead of the row store
        self.columnar: Dict[str, object] = {}
        # pipeline segment fusion (exec/fusion.py): module switch + NO_FUSE hint
        self.enable_fusion = fusion.default_enabled(self.hints)
        # per-execution runtime-filter hub: joins publish build-side filters here,
        # probe-side scans consume them; NO_BLOOM / RUNTIME_FILTER(OFF) turn it off
        self.rf = RuntimeFilterManager(
            hints=self.hints, metrics=getattr(archive_instance, "metrics", None))
        # cross-query fragment cache, or None when disabled (env, config, hint) or
        # outside an Instance
        self.frag = fc.for_context(archive_instance, self.hints)
        # store uids this execution's txn has written (the session fills it in);
        # None with a live txn means "unknown write set": the cache bypasses
        self.txn_write_uids = frozenset() if txn_id == 0 else None
        # skew plans this execution may activate (fingerprints absorb them)
        self.skew_modes = _skew.exec_modes(self.hints, archive_instance)
        self.skew_stats: Dict[int, dict] = {}
        # self-heal pin (plan/spm.py heal_pin): salts fragment-cache fingerprints
        self.plan_pin = ""
        # MAX_EXECUTION_TIME deadline (absolute time.time() seconds, or None),
        # checked at MPP stage boundaries (`parallel/mpp.py`)
        self.deadline: Optional[float] = None

    def check_deadline(self):
        """Raise a typed QueryTimeoutError once the deadline passes (a None deadline
        costs one attribute read)."""
        if self.deadline is not None and time.time() > self.deadline:
            raise errors.QueryTimeoutError("query exceeded MAX_EXECUTION_TIME deadline")


# a full-table scan of more rows than this streams one device batch a partition
# instead of fusing every partition into one (the reference's limit, inline there)
FUSE_MAX_ROWS = 1 << 27

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


def remote_column(arr: np.ndarray, valid: Optional[np.ndarray], typ: dt.DataType,
                  dictionary, scaled: bool):
    """A shipped wire array -> (host lane, validity or None, dictionary): the lanes,
    validity and dictionary codes the reference's decode gives
    (`chunk.batch.column_from_pylist` over the values, NULL where `valid` is
    False), computed on whole arrays.  Strings are encoded in first-seen order,
    DATE/DATETIME text is parsed once a distinct value, and a DECIMAL shipped
    scaled is adopted as it is.  A BIGINT UNSIGNED value past 2^63 arrives as
    negative int64 bits and raises OverflowError there, as in the reference."""
    if scaled:
        return (arr.astype(typ.lane),
                None if valid is None else valid.astype(np.bool_), dictionary)
    n = arr.shape[0]
    ok = np.ones(n, dtype=np.bool_) if valid is None else valid.astype(np.bool_)
    out_valid = None if bool(ok.all()) else ok
    if typ.is_string:
        dictionary = dictionary if dictionary is not None else Dictionary()
        lane = np.zeros(n, dtype=np.int32)
        present = arr[ok]
        if present.size:
            uniq, first, inv = np.unique(present, return_index=True,
                                         return_inverse=True)
            order = np.argsort(first, kind="stable")
            codes = np.empty(uniq.shape[0], dtype=np.int32)
            for u in order.tolist():
                codes[u] = dictionary.encode_one(str(uniq[u]))
            lane[ok] = codes[inv.reshape(-1)]
        return lane, out_valid, dictionary
    lane = np.zeros(n, dtype=typ.lane)
    if typ.clazz in (dt.TypeClass.DATE, dt.TypeClass.DATETIME) and arr.dtype.kind == "U":
        present = arr[ok]
        if present.size:
            parse = temporal.parse_date if typ.clazz == dt.TypeClass.DATE \
                else temporal.parse_datetime
            uniq, inv = np.unique(present, return_inverse=True)
            vals = np.array([parse(str(x)) for x in uniq.tolist()], dtype=np.int64)
            lane[ok] = vals[inv.reshape(-1)]
        return lane, out_valid, dictionary
    if typ.clazz == dt.TypeClass.DECIMAL:
        # the reference's round(float(v) * 10**scale), half to even
        lane[ok] = np.round(arr[ok].astype(np.float64) *
                            float(10 ** typ.scale)).astype(typ.lane)
        return lane, out_valid, dictionary
    present = arr[ok]
    if typ.lane == np.uint64 and present.size and \
            np.issubdtype(present.dtype, np.signedinteger) and bool((present < 0).any()):
        bad = int(present[np.argmax(present < 0)])
        raise OverflowError(f"Python integer {bad} out of bounds for uint64")
    lane[ok] = present.astype(typ.lane)
    return lane, out_valid, dictionary


class ScanSource(ops.Operator):
    """Storage scan renamed into plan field-id space: with a device cache, the
    scanned partitions fused into ONE batch whose lanes come from the cache, or, for
    a full-table scan past FUSE_MAX_ROWS rows, one such batch a partition; without
    one, the store's host batches."""

    def __init__(self, node: L.Scan, ctx: ExecContext):
        self.node = node
        self.ctx = ctx

    def batches(self) -> Iterator[ColumnBatch]:
        t = self.node.table
        self.ctx.check_deadline()  # drain boundary: scans feed every pipeline
        if getattr(t, "remote", None) is not None:
            yield from self._remote_batches(t)
            return
        key = f"{t.schema.lower()}.{t.name.lower()}"
        store = self.ctx.stores[key]
        storage_cols = [c for _, c in self.node.columns]
        rename = {c: oid for oid, c in self.node.columns}
        # flashback (AS OF TSO n): the scan reads at the requested snapshot, own-txn
        # provisional rows excluded (a historical read, not a txn read)
        as_of = self.node.as_of
        snap = as_of if as_of is not None else self.ctx.snapshot_ts
        txn_id = 0 if as_of is not None else self.ctx.txn_id
        yield from self._archive_batches(t, storage_cols, rename, snap)
        # columnar-replica route: the session snapshotted a ReplicaView at the routed
        # watermark (== ctx.snapshot_ts).  The archive batches above still run: TTL-
        # archived rows never reached the replica's seed scan.  Flashback reads
        # always stay on the row store.
        if self.ctx.columnar and as_of is None:
            view = self.ctx.columnar.get(key)
            if view is not None:
                yield from self._columnar_batches(t, view, storage_cols, rename)
                return
        pids = tuple(range(len(store.partitions)) if self.node.partitions is None
                     else self.node.partitions)
        if self.node.point_eq is not None:
            for b in self._point_batches(t, store, pids, snap, txn_id):
                yield b.rename(rename)
            return
        self.ctx.trace.append(
            f"scan {t.name} partitions={self.node.partitions or 'all'}" +
            (f" as_of={as_of}" if as_of is not None else ""))
        if self.ctx.device_cache is None:
            # the reference's host scan: batches of up to 1M visible rows a
            # partition, padded to their capacity bucket, marked for the device
            for b in store.scan(storage_cols, self.node.partitions, snap,
                                txn_id=txn_id, home=self.ctx.device):
                self.ctx.check_deadline()  # per-partition drain boundary
                yield b.pad_to(ops.bucket_capacity(b.capacity)).rename(rename)
            return
        if self.node.partitions is None and \
                sum(p.num_rows for p in store.partitions) > FUSE_MAX_ROWS:
            # the reference's per-partition loop: one batch a partition, its lanes
            # cached under the partition's id
            n = 0
            for pid in pids:
                b = self._fused_table_batch(t, store, (pid,), pid, snap, txn_id)
                if b is not None:
                    n += 1
                    yield b.rename(rename)
            self.ctx.trace.append(f"scan {t.name} streamed batches={n}")
            return
        b = self._fused_table_batch(t, store, pids,
                                    -1 if self.node.partitions is None else pids,
                                    snap, txn_id)
        if b is not None:
            yield b.rename(rename)  # fused cols are storage-name keyed

    def _remote_batches(self, t) -> Iterator[ColumnBatch]:
        """Plan shipping to the worker that holds the table, with weighted read
        routing over the primary and its replicas: a failed request fences a
        ping-verified dead endpoint (or re-routes off a live erroring one) and
        tries another within the same statement."""
        inst = self.ctx.archive_instance
        if inst is None:
            raise errors.TddlError(
                f"remote table {t.name} needs an owning instance context")
        last_err = None
        for _attempt in range(1 + len(getattr(t, "replicas", []))):
            addr, client = inst.read_endpoint(t)
            try:
                # materialized before yielding: a failover must not emit rows
                # already handed downstream
                got = list(self._remote_batches_from(t, addr, client))
                yield from got
                return
            except errors.QueryTimeoutError:
                raise  # the deadline kills the statement, not the endpoint
            except (errors.TddlError, ConnectionError, OSError) as e:
                last_err = e
                transport = isinstance(
                    e, (errors.WorkerUnavailableError, ConnectionError, OSError))
                if not transport:
                    raise
                dead = not client.ping()
                if dead:
                    # ping-verified dead: fence it (a blip the next ping proves
                    # alive must not fence an endpoint)
                    inst.ha.fence_worker(addr, True)
                WORKER_FAILOVERS.inc()
                where = f"{addr[0]}:{addr[1]}"
                events.publish("worker_failover",
                               f"scan {t.name}: fenced dead endpoint {where}, "
                               f"re-routing" if dead else
                               f"scan {t.name}: rerouted off live endpoint {where}",
                               node=inst.node_id, table=t.name, worker=where,
                               fenced=dead)
                self.ctx.trace.append(f"failover {t.name}: fenced {where}" if dead
                                      else f"failover {t.name}: rerouted off "
                                           f"{where} (alive)")
        raise errors.WorkerUnavailableError(
            f"remote table {t.name}: no serving endpoint ({last_err})")

    def _remote_batches_from(self, t, addr, client) -> Iterator[ColumnBatch]:
        """Ship the bound fragment (the worker runs it with no parse or plan); any
        refusal but a dead endpoint or a blown deadline degrades to SQL text."""
        storage_cols = [c for _, c in self.node.columns]

        def lane_safe(v):
            return int(v) if float(v).is_integer() else float(v)
        # planned runtime filters ride the fragment: the build side's range as
        # extra SARGs, a small build as an IN-list, pruned before rows cross the
        # process seam
        rf_sargs, rf_in = self._rf_pushdown()
        frag = {"schema": t.schema, "table": t.name, "columns": storage_cols,
                "sargs": [[c, op, lane_safe(v)] for c, op, v in
                          list(getattr(self.node, "sargs", [])) + rf_sargs]}
        if rf_in:
            frag["rf_in"] = [[c, vals] for c, vals in rf_in]
        xid = self.ctx.remote_xids.get(addr)
        if xid is not None:
            frag["xid"] = xid  # read through the session's open worker branch
        pe = self.node.point_eq
        if pe is not None and not t.column(pe[0]).dtype.is_string and \
                isinstance(pe[1], (int, np.integer)):
            frag["point"] = [pe[0], int(pe[1])]
        dl = self.ctx.deadline
        try:
            names, rtypes, data, valid = client.exec_plan(frag, deadline=dl)
            how = "remote-plan"
        except (errors.QueryTimeoutError, errors.WorkerUnavailableError):
            # a dead endpoint fails over, a blown deadline kills the statement:
            # SQL text would help neither
            raise
        except errors.TddlError:
            sql = f"SELECT {', '.join(storage_cols)} FROM {t.schema}.{t.name}"
            how = "remote-scan"
            # the degrade path keeps the branch xid: visibility must not depend
            # on the wire form that served the scan
            names, rtypes, data, valid = client.execute(sql, t.schema, xid=xid,
                                                        deadline=dl)
        scaled = {nm for nm, ty in zip(names, rtypes)
                  if isinstance(ty, str) and ty.endswith("#scaled")}
        n = len(next(iter(data.values()))) if data else 0
        # the reference's trace line, with the rows the scan shipped
        self.ctx.trace.append(f"{how} {t.name} -> {addr[0]}:{addr[1]} rows={n}")
        dev = self.ctx.device
        cols = {}
        for oid, cname in self.node.columns:
            cm = t.column(cname)
            d = t.dictionaries.get(cname.lower())
            lane, v, d = remote_column(data[cname], valid.get(cname), cm.dtype, d,
                                       cname in scaled)
            cols[oid] = Column(as_tensor(lane, dev),
                               None if v is None else as_tensor(v, dev),
                               cm.dtype, d)
        if not cols:
            return
        b = ColumnBatch(cols, torch.ones(n, dtype=torch.bool, device=dev))
        yield b.pad_to(ops.bucket_capacity(max(n, 1)))

    def _rf_pushdown(self):
        """(min/max sargs, in-lists) from published runtime filters: the lane-domain
        pushdown the archive's and the replica's SARG pruning share.  Read at the
        scan's first pull, after the producing build published."""
        rf = self.ctx.rf
        if not getattr(self.node, "rf_targets", None):
            return [], []
        sargs, inlists = rf.scan_pushdown(self.node)
        return [[c, op, v] for c, op, v in sargs], inlists

    def _columnar_batches(self, t, view, storage_cols, rename):
        """Columnar-replica scan: the immutable stripes' lanes from the device cache
        and one concatenated delta batch, zone-map-pruned by the same SARGs the
        parquet archive refutes with, MVCC-visible at the routed watermark."""
        from galaxysql_tpu_torch.storage import columnar as _col
        mgr = getattr(self.ctx.archive_instance, "columnar", None)
        sargs = [tuple(s) for s in (getattr(self.node, "sargs", None) or [])]
        rf_sargs, _ = self._rf_pushdown()
        sargs += [tuple(s) for s in rf_sargs]
        pruned0 = view.replica.pruned_stripes
        self.ctx.trace.append(
            f"scan-columnar {t.name} watermark={view.watermark} "
            f"stripes={len(view.stripes)} delta={len(view.delta)}")
        # the replica's stripes always read through a device cache: a context
        # without one (ENABLE_TPU_ENGINE = 0; TP statements never route here) uses
        # the instance's
        cache = self.ctx.device_cache
        if cache is None:
            cache = getattr(self.ctx.archive_instance, "device_cache", None) or \
                DeviceCache(self.ctx.device)
        for b in _col.scan_view(view, t, storage_cols, sargs, mgr, cache):
            yield b.rename(rename)
        pruned = view.replica.pruned_stripes - pruned0
        if pruned:
            self.ctx.trace.append(
                f"scan-columnar {t.name} pruned_stripes={pruned}")

    def _archive_batches(self, t, storage_cols, rename, snap=None):
        """Cold rows from parquet archives, on the context's device."""
        am = self.ctx.archive
        if am is None:
            return
        snap = self.ctx.snapshot_ts if snap is None else snap
        inst_key = f"{t.schema.lower()}.{t.name.lower()}"
        if not am.files_for(inst_key, snap):
            return
        # runtime-filter min/max ranges feed the same parquet SARG refutation as
        # WHERE-derived sargs, skipping whole files the build side refutes
        rf_sargs, _ = self._rf_pushdown()
        for b in am.scan_archive(self.ctx.archive_instance, t.schema, t.name,
                                 storage_cols, snap,
                                 sargs=getattr(self.node, "sargs", None),
                                 rf_sargs=[tuple(s) for s in rf_sargs],
                                 rf_pruned_cb=self.ctx.rf.note_file_pruned):
            self.ctx.trace.append(f"scan-archive {t.name} rows={b.capacity}")
            yield b.pad_to(ops.bucket_capacity(max(b.capacity, 1))).rename(rename)

    def _point_batches(self, t, store, pids, ts, txn_id) -> Iterator[ColumnBatch]:
        """Index access path (the reference's `_point_batches`): each partition's
        candidate rows from its sorted key index instead of whole lanes, gathered on
        the host into one host batch a partition, padded to its capacity bucket.
        The Filter above the scan re-verifies the whole predicate, so candidates
        only need to be a superset of the matches for the indexed column; MVCC
        visibility is applied here (`Partition.key_rows`)."""
        col, val = self.node.point_eq
        for pid in pids:
            p = store.partitions[pid]
            if p.num_rows == 0:
                continue
            with p.lock:
                ids = p.key_rows(col, val, ts, txn_id)
                if ids.size == 0:
                    continue
                cols = {}
                for _oid, cname in self.node.columns:
                    v = p.valid[cname][ids]
                    cols[cname] = Column(as_tensor(p.lanes[cname][ids]),
                                         None if bool(v.all()) else as_tensor(v),
                                         t.column(cname).dtype,
                                         t.dictionaries.get(cname.lower()))
            self.ctx.trace.append(f"point-get {t.name} p{pid} rows={ids.size}")
            yield ColumnBatch(cols, None, self.ctx.device).pad_to(
                ops.bucket_capacity(max(int(ids.size), 1)))

    def _fused_table_batch(self, t, store, pids, sig, ts,
                           txn_id) -> Optional[ColumnBatch]:
        """The partitions `pids` as one padded device batch at snapshot `ts`, its
        lanes cached under `sig` (-1 for the whole table); None when they hold no
        row."""
        cache = self.ctx.device_cache
        parts = [store.partitions[p] for p in pids]
        total = sum(p.num_rows for p in parts)
        if total == 0:
            return None
        cap = ops.bucket_capacity(total)

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
            live = _device_visibility(begin, end, ts, txn_id)
            if pad_live is not None:
                live = live & pad_live
        return ColumnBatch(cols, live)


class ValuesSource(ops.Operator):
    """Literal rows (and SELECT without FROM: one anonymous row) as one host
    batch."""

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
        # a host batch, as the reference's numpy VALUES batch
        yield ColumnBatch(b.columns, None, self.ctx.device)


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
        return ColumnBatch(cols, b.live, b.host, b.nominal)


class StatsOp(ops.Operator):
    """EXPLAIN ANALYZE instrumentation: per-operator batches, rows and wall time.
    Only wrapped when `ctx.collect_stats` is set: `num_live()` reads a count back
    from the device per batch, so the normal path never pays."""

    def __init__(self, inner: ops.Operator, node: L.RelNode, ctx: ExecContext):
        self.inner = inner
        self.node = node
        self.ctx = ctx

    def batches(self):
        t0 = time.perf_counter()
        rows = 0
        nb = 0
        for b in self.inner.batches():
            nb += 1
            rows += b.num_live()
            yield b
        self.ctx.op_stats.append(
            {"node_id": id(self.node), "operator": type(self.node).__name__,
             "batches": nb, "rows_out": rows,
             "wall_ms": round((time.perf_counter() - t0) * 1000, 3)})


class SegmentStatsOp(ops.Operator):
    """Per-operator stats INSIDE a fused segment: drains the segment's stats sink
    (per-stage live counts per batch) and attributes stage i's rows back to chain
    node i.  Wall time is the whole segment's; each chain row carries it, flagged
    `fused`.  The sink's leading count is the segment INPUT; runtime-filter prelude
    stages (`rf_node` = the scan they mask) report rows pruned per filter to the
    execution's RuntimeFilterManager (the EXPLAIN ANALYZE `RuntimeFilter(...)`
    lines)."""

    def __init__(self, inner: ops.Operator, segment, nodes: List[L.RelNode],
                 ctx: ExecContext, rf_node: Optional[L.RelNode] = None):
        self.inner = inner
        self.segment = segment
        self.nodes = nodes
        self.ctx = ctx
        self.rf_node = rf_node
        segment.stats_sink = []

    def covers(self, node: L.RelNode) -> bool:
        return node is self.rf_node or any(n is node for n in self.nodes)

    def batches(self):
        yield from self.inner.batches()
        sink = self.segment.stats_sink
        if not sink:
            return
        totals = np.sum([c for c, _ in sink], axis=0)
        wall = round(sum(w for _, w in sink), 3)
        record_rf_stats(self.ctx, self.segment, self.rf_node, totals)
        off = 1 + self.segment.rf_stage_count  # input count + rf preludes
        for i, n in enumerate(self.nodes):
            self.ctx.op_stats.append(
                {"node_id": id(n), "operator": type(n).__name__,
                 "batches": len(sink), "rows_out": int(totals[off + i]),
                 "wall_ms": wall, "fused": True, "segment": self.segment.chain})


def record_rf_stats(ctx, segment, rf_node, totals):
    """Attribute per-rf-stage pruned rows (stats-sink deltas) to the manager.
    totals[0] is the segment input count; rf stages are a prefix."""
    for j, ref in enumerate(segment.rf_refs):
        pruned = int(totals[j]) - int(totals[j + 1])
        ctx.rf.note_pruned(ref.target, pruned,
                           node_id=id(rf_node) if rf_node is not None else None)


class TraceOp(ops.Operator):
    """The span-tracing wrapper, the reference's: one `operator` span a plan node,
    parented at build time (the plan tree is the span tree) and timed at drain
    time.  While a batch is pulled from the wrapped operator the trace cursor
    points at this span, so what fires inside the pull (fused segment runs,
    device-cache transfers, worker RPCs) lands under the operator doing the work.
    It measures host wall time only: no row counts, no device sync."""

    def __init__(self, inner: ops.Operator, span, tc):
        self.inner = inner
        self.span = span
        self.tc = tc

    def batches(self):
        tc, sp = self.tc, self.span
        sp.start_us = tracing.now_us()
        t0 = time.perf_counter()
        batches = 0
        it = self.inner.batches()
        while True:
            prev = tc.cursor
            tc.cursor = sp.span_id
            try:
                try:
                    b = next(it)
                except StopIteration:
                    break
            finally:
                tc.cursor = prev
            batches += 1
            # finalized at every pull: a LIMIT above may drop the generator early
            sp.dur_us = round((time.perf_counter() - t0) * 1e6, 1)
            sp.attrs["batches"] = batches
            yield b
        sp.dur_us = round((time.perf_counter() - t0) * 1e6, 1)
        sp.attrs["batches"] = batches


def _build_with_stats(node: L.RelNode, ctx: ExecContext) -> ops.Operator:
    op = _build_operator(node, ctx)
    if ctx.collect_stats and not (isinstance(op, SegmentStatsOp) and op.covers(node)):
        return StatsOp(op, node, ctx)
    return op


def build_operator(node: L.RelNode, ctx: ExecContext) -> ops.Operator:
    tc = tracing.current()
    if tc is None:
        return _build_with_stats(node, ctx)
    # a traced build: this node's span under its parent operator's (the recursion
    # threads the parent through ctx), then the drain wrapped
    parent = getattr(ctx, "_trace_parent", None)
    sp = tc.add(type(node).__name__, kind="operator",
                parent=tc.cursor if parent is None else parent)
    ctx._trace_parent = sp.span_id
    try:
        op = _build_with_stats(node, ctx)
    finally:
        ctx._trace_parent = parent
    return TraceOp(op, sp, tc)


def _fusing(ctx: ExecContext) -> bool:
    # prelude fusion (chains folded INTO the HashAgg partial pass / join probe) has
    # no per-stage observation point, so profiling keeps those chains as segments of
    # their own; standalone segment fusion stays on under collect_stats
    return ctx.enable_fusion and not ctx.collect_stats


def _cross_stop(n: L.RelNode) -> bool:
    """A filter the port runs rewritten over a cross join (`_through_cross`) is a
    segment boundary: it is built on its own."""
    return isinstance(n, L.Filter) and _through_cross(n) is not None


def _wrap_scan_rf(src: ops.Operator, node: L.Scan, ctx: ExecContext) -> ops.Operator:
    """Scan-level runtime-filter fallback: when no downstream fused segment consumed
    the scan's planned filters (bare join-probe scans, fusion off, profiling), apply
    them here as an rf-only FusedSegment."""
    seg = ctx.rf.segment_for_scan(node)
    if seg is None:
        return src
    ctx.trace.append(f"rf-scan {node.table.name} filters={len(seg.stages)}")
    if ctx.collect_stats:
        # the inner StatsOp keeps the scan's own (pre-filter) actual rows; the
        # SegmentStatsOp reports the per-filter pruned counts
        return SegmentStatsOp(fusion.FusedPipelineOp(StatsOp(src, node, ctx), seg),
                              seg, [], ctx, rf_node=node)
    return fusion.FusedPipelineOp(src, seg)


def _build_operator(node: L.RelNode, ctx: ExecContext) -> ops.Operator:
    if isinstance(node, L.Scan):
        return _wrap_scan_rf(ScanSource(node, ctx), node, ctx)
    if isinstance(node, L.Values):
        return ValuesSource(node, ctx)
    if isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            rewritten = _through_cross(node)
            if rewritten is not None:
                # the rewritten nodes are not in the logical plan: their stats stand
                # under this filter's line (the StatsOp around this call)
                return _build_operator(rewritten, ctx)
        if ctx.enable_fusion:
            # profiling fuses single-stage chains too: in production those fold into
            # the downstream prelude, which profiling holds off
            collecting = ctx.collect_stats
            base, seg = fusion.segment_for(node, min_stages=1 if collecting else 2,
                                           rf=ctx.rf, stop=_cross_stop)
            if seg is not None:
                ctx.trace.append(f"fuse-segment {seg.chain}")
                inner = fusion.FusedPipelineOp(build_operator(base, ctx), seg)
                if collecting:
                    return SegmentStatsOp(
                        inner, seg, fusion.chain_nodes(node, _cross_stop), ctx,
                        rf_node=base if isinstance(base, L.Scan) else None)
                return inner
        if isinstance(node, L.Filter):
            return ops.FilterOp(build_operator(node.child, ctx), node.cond)
        return ops.ProjectOp(build_operator(node.child, ctx), node.exprs)
    if isinstance(node, L.Aggregate):
        est = estimate_rows(node)
        max_groups = 1 << max(int(est * 2).bit_length(), 10)
        max_groups = min(max_groups, 1 << 22)
        calls = [ops.AggCall(a.kind, a.arg, a.out_id) for a in node.aggs]
        child_node, prelude = node.child, None
        if _fusing(ctx):
            # the aggregate is a pipeline breaker: its feeding chain (and the base
            # scan's runtime filters) runs inside the partial pass
            base, prelude = fusion.segment_for(node.child, rf=ctx.rf, stop=_cross_stop)
            if prelude is not None:
                child_node = base
                ctx.trace.append(f"fuse-agg-prelude {prelude.chain}")
        agg = ops.HashAggOp(build_operator(child_node, ctx), node.groups, calls,
                            max_groups=max_groups, spill_threshold=ctx.agg_spill_bytes,
                            prelude=prelude, mem_pool=ctx.mem_pool,
                            device=ctx.device)
        # a deterministic, usually tiny output: replayed from the fragment cache
        # while its tables' versions hold.  Profiling measures the real pipeline.
        if not ctx.collect_stats:
            fkey = fc.fingerprint(node, ctx)
            if fkey is not None:
                return fc.CachedSubplanOp(agg, ctx.frag, fkey, trace=ctx.trace)
        return agg
    if isinstance(node, L.Window):
        return ops.WindowOp(build_operator(node.child, ctx), node.partitions,
                            node.orders, node.calls, out_schema=node.fields())
    if isinstance(node, L.Join):
        return _build_join(node, ctx)
    if isinstance(node, L.Sort):
        return ops.SortOp(build_operator(node.child, ctx), node.keys, node.limit,
                          node.offset, spill_threshold=ctx.sort_spill_bytes,
                          mem_pool=ctx.mem_pool)
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


def annotate_explain(rel: L.RelNode, op_stats: List[dict], rf=None,
                     skew_stats=None) -> List[str]:
    """EXPLAIN ANALYZE tree: the logical plan's explain lines, each node annotated
    with its measured rows, batches and wall time (matched by node identity).
    Operators that ran inside a fused segment carry a `fused(<chain>)` tag, a join
    build served from the fragment cache `[cached build]`.  `rf` (the execution's
    RuntimeFilterManager) adds one `RuntimeFilter(column, kinds, pruned=...)` line
    under each scan a planned runtime filter masked, and `skew_stats`
    (`ExecContext.skew_stats`, filled by MPP execution) one `HotKeys(n, broadcast)` /
    `Salted(f)` line under each join or aggregate the skew-aware executor split.
    `explain_lines` emits one line per node in pre-order, which is `L.walk`'s order,
    so lines and nodes zip."""
    by_id: Dict[int, dict] = {}
    for st in op_stats:
        nid = st["node_id"]
        # fused/cached entries win: they mark chain membership (or a cache hit)
        # the plain StatsOp covering the same node cannot see
        if nid not in by_id or st.get("fused") or st.get("cached"):
            by_id[nid] = st
    rf_by_node: Dict[int, List[dict]] = {}
    if rf is not None:
        for st in rf.stats.values():
            rf_by_node.setdefault(st.get("node_id"), []).append(st)
    lines: List[str] = []
    for line, n in zip(rel.explain_lines(), L.walk(rel)):
        st = by_id.get(id(n))
        if st is not None:
            tag = f" fused({st['segment']})" if st.get("fused") else ""
            if st.get("cached"):
                tag += " [cached build]"
            line += (f"  (actual rows={st['rows_out']} "
                     f"batches={st['batches']} wall={st['wall_ms']}ms{tag})")
        lines.append(line)
        indent = " " * (len(line) - len(line.lstrip()) + 2)
        for rst in rf_by_node.get(id(n), []):
            lines.append(f"{indent}RuntimeFilter({rst['column']}, "
                         f"{rst['kinds']}, pruned={rst['pruned']})")
        info = (skew_stats or {}).get(id(n))
        if info is not None:
            lines.append(f"{indent}{_skew.explain_line(info)}")
    return lines


def _through_cross(node: L.Filter) -> Optional[L.RelNode]:
    """A filter over a cross join as the operators run it, or None to run it as is.

    The copied rules leave a predicate above a scalar cross (an uncorrelated scalar
    subquery) even where it reads only the cross's probe side, so an equi predicate
    between the two sides of a plain cross below never becomes a join key: TPC-H
    Q15's supplier x revenue0, 10,000 x 10,000 rows at SF 1, past
    `CrossJoinOp.MAX_CELLS`.  Here, where the probe side of a scalar cross is such a
    plain cross, the conjuncts that read only the probe side move below the scalar
    cross (which keeps each probe row once) to make that cross an inner equi join;
    those left over run above the equi join, a device batch, as the reference runs
    them above the scalar cross.  Any other filter stays as planned.  The rows are
    the same; the logical plan is not touched."""
    child = node.child
    if not (isinstance(child, L.Join) and child.kind == "cross"):
        return None
    conj = conjuncts(node.cond)
    left_ids = set(child.left.field_ids())
    if child.scalar:
        below = [set(ir.referenced_columns(c)) <= left_ids for c in conj]
        if not any(below):
            return None
        joined = _through_cross(
            L.Filter(child.left, ir.and_(*[c for c, b in zip(conj, below) if b])))
        if joined is None:
            return None
        j = L.Join(joined, child.right, "cross", [])
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


def _probe_prelude(ctx: ExecContext, probe_node: L.RelNode):
    """(base node, filter-only FusedSegment | None) for an inner join's probe side:
    the WHERE chain above the probe scan runs inside the probe.  Project stages
    change the column namespace the join gathers from, so only all-filter chains
    collapse here."""
    if not _fusing(ctx):
        return probe_node, None
    base, seg = fusion.segment_for(probe_node, filters_only=True, stop=_cross_stop)
    if seg is not None:
        ctx.trace.append(f"fuse-join-probe {seg.chain}")
    return base, seg


def _rf_publish_specs(node: L.Join, ctx: ExecContext, probe_side: str):
    """Planned runtime-filter producer specs ACTIVE for this execution
    (`runtime_filter.specs_for` holds the side-flip / deactivation rule)."""
    specs = specs_for(node, probe_side, ctx.rf)
    if not specs:
        return None, []
    ctx.trace.append(f"rf-publish join filters={len(specs)}")
    return ctx.rf, specs


def _frag_build_wiring(build_node: L.RelNode, ctx: ExecContext):
    """Fragment-cache wiring for a join build side: (fingerprint, cache, hit-note
    callback).  The note lands the hit in the trace and, under EXPLAIN ANALYZE, as a
    `[cached build]` op stat on the build node, whose subtree never ran."""
    fkey = fc.fingerprint(build_node, ctx)
    if fkey is None:
        return None, None, None

    def note(art, _node=build_node):
        ctx.trace.append(f"frag-cache build hit [{','.join(sorted(fkey.tables))}] "
                         f"rows={art.rows}")
        if ctx.collect_stats:
            ctx.op_stats.append(
                {"node_id": id(_node), "operator": type(_node).__name__,
                 "batches": 0, "rows_out": art.rows, "wall_ms": 0.0, "cached": True})
    return fkey, ctx.frag, note


def _build_side_op(build_node: L.RelNode, ctx: ExecContext, fkey, cache):
    op = build_operator(build_node, ctx)
    # the subplan lane is keyed by the subtree ALONE, so other joins over the same
    # subtree, and executions after an artifact eviction, still skip it.
    # Profiling bypasses, as for the aggregate replay.
    if fkey is not None and not ctx.collect_stats:
        op = fc.CachedSubplanOp(op, cache, fkey, trace=ctx.trace)
    return op


def _skew_watch(build_node: L.RelNode, build_keys, ctx: ExecContext):
    """Heavy-hitter runtime-refresh targets for a join build side: one (TableMeta,
    column, field id) per build key that is a bare scan column."""
    if not ctx.skew_modes:
        return []
    from galaxysql_tpu_torch.plan.rules import _rf_resolve_scan
    out = []
    for e in build_keys:
        if not isinstance(e, ir.ColRef):
            continue
        got = _rf_resolve_scan(build_node, e.name)
        if got is None:
            continue
        scan, out_id = got
        if getattr(scan.table, "remote", None) is not None:
            continue
        colname = dict(scan.columns).get(out_id)
        if colname is not None:
            out.append((scan.table, scan.table.column(colname).name, e.name))
    return out


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
        rf_mgr, rf_specs = _rf_publish_specs(node, ctx, "left") \
            if node.kind == "semi" else (None, [])
        right_schema = {fid: (typ, d) for fid, typ, d in node.right.fields()}
        fkey, cache, note = _frag_build_wiring(node.right, ctx)
        return ops.HashJoinOp(_build_side_op(node.right, ctx, fkey, cache),
                              build_operator(node.left, ctx),
                              rkeys, lkeys, node.kind, residual=node.residual,
                              build_schema=right_schema, enable_bloom=bloom,
                              spill_threshold=ctx.join_spill_bytes,
                              rf_publish=rf_specs, rf_manager=rf_mgr,
                              frag_cache=cache, frag_key=fkey, frag_note=note,
                              skew_watch=_skew_watch(node.right, rkeys, ctx),
                              mem_pool=ctx.mem_pool)
    # inner: build the smaller estimated side
    if estimate_rows(node.right) <= estimate_rows(node.left):
        build_node, probe_node = node.right, node.left
        build_keys, probe_keys = rkeys, lkeys
        probe_side = "left"
    else:
        build_node, probe_node = node.left, node.right
        build_keys, probe_keys = lkeys, rkeys
        probe_side = "right"
    rf_mgr, rf_specs = _rf_publish_specs(node, ctx, probe_side)
    build_schema = {fid: (typ, d) for fid, typ, d in build_node.fields()}
    probe_node, prelude = _probe_prelude(ctx, probe_node)
    fkey, cache, note = _frag_build_wiring(build_node, ctx)
    return ops.HashJoinOp(_build_side_op(build_node, ctx, fkey, cache),
                          build_operator(probe_node, ctx),
                          build_keys, probe_keys, "inner", residual=node.residual,
                          build_schema=build_schema, enable_bloom=bloom,
                          spill_threshold=ctx.join_spill_bytes,
                          probe_prelude=prelude,
                          rf_publish=rf_specs, rf_manager=rf_mgr,
                          frag_cache=cache, frag_key=fkey, frag_note=note,
                          skew_watch=_skew_watch(build_node, build_keys, ctx),
                          mem_pool=ctx.mem_pool)
