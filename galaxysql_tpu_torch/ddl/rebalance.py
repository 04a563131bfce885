"""Online elastic rebalancing: SPLIT / MERGE / MOVE PARTITION while serving.

Reference analog: the scale-out job family at PARTITION scope
(`executor/balancer/Balancer.java`, the changeset backfill + catchup + cutover
flow, SURVEY.md §2.6 / PAPER.md §L8): instead of rebuilding the whole table
(ddl/repartition.py), only the affected partitions move —

1. PREPARE computes the complete TARGET partitioning (for hash/key tables a
   bucket-map indirection is installed first: bucket space = count * K with
   the initial assignment b -> b % count, which routes IDENTICALLY to the
   plain modulo, so the conversion is metadata-only and a later split
   reassigns only the split partition's buckets),
2. chunked snapshot BACKFILL copies the source partitions' visible rows into
   SHADOW partitions routed by the target map, with a persisted
   [src, offset] checkpoint (a crashed backfill resumes mid-partition),
3. CDC CATCHUP tails `txn/cdc.py`'s commit-TSO-ordered stream from a
   persisted seq watermark and replays this table's post-snapshot events
   onto the shadows (delete-by-PK before insert makes re-delivery after a
   crash idempotent — the PR 13 watermark-fencing shape),
4. VERIFY compares FastChecker checksums of source vs shadow at the catchup
   timestamp (one fresh-catchup retry absorbs a benign race),
5. CUTOVER, under the table's EXCLUSIVE MDL: drain open transactions holding
   provisional rows in the store, final catchup to a TSO fence, then swap —
   the partition list, the bucket map/boundaries/placement, and a freshly
   minted versioned PartitionRouter — bump versions, and broadcast
   plan/fragment invalidations over the SyncBus so peer coordinators never
   route by the stale map.  A durable cutover marker makes the swap
   re-run-safe; everything before it undoes by dropping shadows (the source
   partitions are never mutated pre-cutover).

Shadow partitions live OUTSIDE the store (`instance.rebalance_shadows`) so
scans never see half-moved data; a process restart that lost them restarts
the backfill from scratch (detected via a per-attempt nonce), while the
in-process crash-resume the chaos suite drives keeps them and resumes from
the checkpoint.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.ddl.jobs import (DdlJob, DdlTask, InvalidatePlansTask,
                                    ValidateTableTask, task)
from galaxysql_tpu_torch.meta.catalog import PartitionInfo, PartitionRouter
from galaxysql_tpu_torch.meta.tso import LOGICAL_BITS
from galaxysql_tpu_torch.utils import errors, events
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_REBALANCE_AFTER_SWAP,
                                           FP_REBALANCE_BEFORE_SWAP,
                                           FP_REBALANCE_CATCHUP,
                                           FP_REBALANCE_CHUNK,
                                           FP_REBALANCE_VERIFY_MISMATCH)

# bucket space multiplier for the metadata-only hash conversion: a table with
# n partitions gets n * BUCKETS_PER buckets, so one partition can split up to
# BUCKETS_PER ways before bucket granularity runs out
BUCKETS_PER = 16

_CATCHUP_PAGE = 4096


def _kv(schema: str, table: str, field: str) -> str:
    return f"rebal.{schema.lower()}.{table.lower()}.{field}"


def _table_key(tm) -> str:
    return f"{tm.schema.lower()}.{tm.name.lower()}"


# ---------------------------------------------------------------------------
# shadow-partition runtime (in-memory half of a job's state)
# ---------------------------------------------------------------------------

class ShadowSet:
    """The shadow partitions one job backfills into, keyed by target tag."""

    def __init__(self, nonce: str, tm, n_targets: int):
        from galaxysql_tpu_torch.storage.table_store import Partition
        self.nonce = nonce
        self.partitions = [Partition(tm, -(i + 1)) for i in range(n_targets)]


def _shadows(instance) -> Dict[str, ShadowSet]:
    reg = getattr(instance, "rebalance_shadows", None)
    if reg is None:
        reg = instance.rebalance_shadows = {}
    return reg


# ---------------------------------------------------------------------------
# progress (persisted; SHOW REBALANCE reads it)
# ---------------------------------------------------------------------------

def _progress_update(ctx, tm, **fields):
    kv = ctx.instance.metadb
    key = _kv(tm.schema, tm.name, "progress")
    raw = kv.kv_get(key)
    prog = json.loads(raw) if raw else {}
    prog.update(fields)
    prog["job_id"] = ctx.job_id
    prog["updated_at"] = time.time()
    kv.kv_put(key, json.dumps(prog))
    return prog


def progress_rows(instance) -> List[tuple]:
    """SHOW REBALANCE / information_schema.rebalance_jobs row source: live
    jobs (kv progress) plus the bounded history of finished ones."""
    rows = []
    states = {job_id: state for job_id, state in instance.metadb.query(
        "SELECT job_id, state FROM ddl_engine")}
    now_ts = instance.tso.next_timestamp()
    for key, raw in instance.metadb.kv_scan("rebal."):
        if not key.endswith(".progress") and ".hist." not in key:
            continue
        try:
            p = json.loads(raw)
        except Exception:
            continue
        state = p.get("state") or states.get(p.get("job_id"), "RUNNING")
        lag_ms = -1.0
        if p.get("phase") in ("catchup", "cutover") and p.get("last_event_ts"):
            lag_ms = max(0, (now_ts - int(p["last_event_ts"]))
                         >> LOGICAL_BITS) / 1.0
        rows.append((p.get("job_id") or 0, p.get("table", ""),
                     p.get("kind", ""), state, p.get("phase", ""),
                     ",".join(str(s) for s in p.get("src", [])),
                     int(p.get("targets", 0)), int(p.get("rows_copied", 0)),
                     int(p.get("events_applied", 0)), float(lag_ms),
                     json.dumps(p.get("checkpoint") or []),
                     int(p.get("router_epoch", 0))))
    rows.sort(key=lambda r: r[0])
    return rows


def _finish_progress(ctx, tm, state: str):
    """Move the live progress record into bounded history."""
    kv = ctx.instance.metadb
    key = _kv(tm.schema, tm.name, "progress")
    raw = kv.kv_get(key)
    if raw:
        prog = json.loads(raw)
        prog["state"] = state
        kv.kv_put(f"rebal.hist.{prog.get('job_id') or 0}", json.dumps(prog))
        kv.kv_delete(key)
        # bounded history: keep the newest 32 records (numeric job-id sort —
        # lexicographic would retire job 99 while keeping job 100's elders)
        def _job_no(k: str) -> int:
            try:
                return int(k.rsplit(".", 1)[1])
            except ValueError:
                return 0
        hist = sorted((k for k, _ in kv.kv_scan("rebal.hist.")), key=_job_no)
        for k in hist[:-32]:
            kv.kv_delete(k)


# ---------------------------------------------------------------------------
# target-map computation
# ---------------------------------------------------------------------------

def _ensure_bucket_map(ctx, tm) -> List[int]:
    """Metadata-only conversion to bucket-indirection routing (see module
    docstring for why the initial assignment cannot move a row)."""
    info = tm.partition
    if info.bucket_map is not None:
        return info.bucket_map
    if info.method not in ("hash", "key"):
        raise errors.TddlError(
            f"bucket map only applies to hash/key partitioning "
            f"(table is {info.method})")
    info.bucket_map = [b % info.count for b in range(info.count * BUCKETS_PER)]
    ctx.bump(tm)
    return info.bucket_map


def _pad_placement(info: PartitionInfo) -> List[str]:
    pl = list(info.placement)
    while len(pl) < info.num_partitions:
        pl.append(PartitionInfo.DEFAULT_GROUP)
    return pl


def plan_split(ctx, tm, src: int, into: int = 2,
               at: Optional[Any] = None) -> dict:
    info = tm.partition
    if into < 2:
        # a 0/1-way "split" is a no-op at best; into=0 would divide by zero
        # below and wedge the job RUNNING (the engine only undoes TddlError)
        raise errors.TddlError(
            f"SPLIT PARTITION INTO {into}: need at least 2 targets")
    if info.method in ("hash", "key"):
        if at is not None:
            raise errors.TddlError(
                "SPLIT PARTITION AT (value) applies to range tables only; "
                f"{info.method} tables split by bucket (use INTO n)")
        bmap = list(_ensure_bucket_map(ctx, tm))
        src_buckets = [b for b, p in enumerate(bmap) if p == src]
        if len(src_buckets) < into:
            raise errors.TddlError(
                f"partition p{src} holds only {len(src_buckets)} buckets; "
                f"cannot split {into} ways")
        n_old = info.num_partitions
        # target pids: the first replaces src in place, the rest append at
        # the end so every unaffected partition keeps its id
        target_pids = [src] + [n_old + i for i in range(into - 1)]
        for i, b in enumerate(src_buckets):
            bmap[b] = target_pids[i % into]
        placement = _pad_placement(info)
        placement.extend([placement[src]] * (into - 1))
        layout = [["old", i] for i in range(n_old)]
        layout[src] = ["shadow", 0]
        layout += [["shadow", i + 1] for i in range(into - 1)]
        new_info = {"method": info.method, "columns": info.columns,
                    "count": n_old + into - 1, "boundaries": info.boundaries,
                    "bucket_map": bmap, "placement": placement}
    elif info.method in ("range", "range_columns"):
        if at is None:
            raise errors.TddlError("range SPLIT PARTITION requires AT (value)")
        if into != 2:
            raise errors.TddlError(
                "range SPLIT PARTITION AT (value) always yields exactly 2 "
                f"partitions; INTO {into} is not supported")
        bounds = list(info.boundaries)
        lo = bounds[src - 1][1][0] if src > 0 else None
        hi = bounds[src][1][0]
        from galaxysql_tpu_torch.meta.catalog import encode_partition_value
        v = encode_partition_value(at, tm.column(info.columns[0]).dtype)
        if (lo is not None and v <= lo) or (hi is not None and v >= hi):
            raise errors.TddlError(
                f"split point {at!r} is outside partition p{src}'s range")
        bounds[src:src + 1] = [(f"{bounds[src][0]}a", [v]),
                               (f"{bounds[src][0]}b", [bounds[src][1][0]])]
        placement = _pad_placement(info)
        placement[src:src + 1] = [placement[src], placement[src]]
        layout = [["old", i] for i in range(len(info.boundaries))]
        layout[src:src + 1] = [["shadow", 0], ["shadow", 1]]
        new_info = {"method": info.method, "columns": info.columns,
                    "count": info.count, "boundaries": bounds,
                    "bucket_map": None, "placement": placement}
    else:
        raise errors.TddlError(
            f"SPLIT PARTITION not supported for {info.method} tables")
    return {"kind": "split", "src": [src], "layout": layout,
            "partition": new_info}


def plan_merge(ctx, tm, a: int, b: int) -> dict:
    info = tm.partition
    if a == b:
        raise errors.TddlError("MERGE PARTITIONS needs two distinct partitions")
    a, b = sorted((a, b))
    n_old = info.num_partitions
    placement = _pad_placement(info)
    if info.method in ("hash", "key"):
        bmap = list(_ensure_bucket_map(ctx, tm))
        # all of b's buckets fold into a (which becomes the shadow target);
        # pids above b shift down by one
        bmap = [a if p == b else p for p in bmap]
        bmap = [p - 1 if p > b else p for p in bmap]
        layout = [["old", i] for i in range(n_old) if i != b]
        layout[a] = ["shadow", 0]
        placement = [g for i, g in enumerate(placement) if i != b]
        new_info = {"method": info.method, "columns": info.columns,
                    "count": n_old - 1, "boundaries": info.boundaries,
                    "bucket_map": bmap, "placement": placement}
    elif info.method in ("range", "range_columns"):
        if b != a + 1:
            raise errors.TddlError(
                "range MERGE PARTITIONS requires adjacent partitions")
        bounds = list(info.boundaries)
        bounds[a:a + 2] = [(bounds[a][0], bounds[a + 1][1])]
        layout = [["old", i] for i in range(n_old) if i != b]
        layout[a] = ["shadow", 0]
        placement = [g for i, g in enumerate(placement) if i != b]
        new_info = {"method": info.method, "columns": info.columns,
                    "count": info.count, "boundaries": bounds,
                    "bucket_map": None, "placement": placement}
    else:
        raise errors.TddlError(
            f"MERGE PARTITIONS not supported for {info.method} tables")
    return {"kind": "merge", "src": [a, b], "layout": layout,
            "partition": new_info}


def plan_move(ctx, tm, src: int, group: str) -> dict:
    info = tm.partition
    if info.method in ("single", "broadcast"):
        raise errors.TddlError(
            f"MOVE PARTITION not supported for {info.method} tables")
    placement = _pad_placement(info)
    placement[src] = group
    layout = [["old", i] for i in range(info.num_partitions)]
    layout[src] = ["shadow", 0]
    new_info = {"method": info.method, "columns": info.columns,
                "count": info.count, "boundaries": info.boundaries,
                "bucket_map": info.bucket_map, "placement": placement}
    return {"kind": "move", "src": [src], "layout": layout,
            "partition": new_info, "group": group}


def _info_from_desc(d: dict) -> PartitionInfo:
    return PartitionInfo(d["method"], list(d["columns"]), int(d["count"]),
                         [tuple(b) for b in d["boundaries"]],
                         d.get("bucket_map"), list(d.get("placement") or []))


# ---------------------------------------------------------------------------
# row plumbing shared by backfill and catchup
# ---------------------------------------------------------------------------

def _encode_rows(tm, columns: List[str], rows: List[list]):
    """Python-domain CDC row images -> lane/valid dicts (shared dictionaries
    keep string codes aligned with the base table)."""
    from galaxysql_tpu_torch.chunk.batch import column_from_pylist
    lanes: Dict[str, np.ndarray] = {}
    valid: Dict[str, np.ndarray] = {}
    ix = {c.lower(): i for i, c in enumerate(columns)}
    for cm in tm.columns:
        i = ix.get(cm.name.lower())
        vals = [r[i] for r in rows] if i is not None else [None] * len(rows)
        col = column_from_pylist(vals, cm.dtype,
                                 tm.dictionaries.get(cm.name.lower()))
        lanes[cm.name] = col.np_data()
        valid[cm.name] = col.np_valid()
    return lanes, valid


def _route_lanes(tm, router: PartitionRouter,
                 lanes: Dict[str, np.ndarray]) -> np.ndarray:
    info = router.info
    n = next(iter(lanes.values())).shape[0] if lanes else 0
    if info.method in ("single", "broadcast"):
        return np.zeros(n, dtype=np.int32)
    keys = [lanes[tm.column(c).name] for c in info.columns]
    return router.route_rows(keys)


def _pk_tuples(tm, lanes, valid, ids) -> List[tuple]:
    """PK identity tuples in LANE domain (codes/scaled ints compare exactly)."""
    pk = [tm.column(c).name for c in tm.primary_key]
    return [tuple(int(lanes[c][i]) for c in pk) for i in ids]


class _ShadowPkIndex:
    """PK tuple -> (shadow tag, row id) over the LIVE shadow rows.

    Built once per catchup pass, maintained incrementally per event, so
    applying N events over an M-row shadow costs O(M + event rows) instead
    of a full O(M) scan per event.  Matching the LATEST committed state
    (visible_mask(None)) — not the event's commit_ts — is what makes page
    re-delivery after a crash idempotent: a re-applied insert must find the
    copy its first delivery appended even though that copy carries a later
    begin_ts; replaying the whole suffix in seq order then converges."""

    def __init__(self, tm, shadow_parts):
        self.pk = [tm.column(c).name for c in tm.primary_key]
        self.parts = shadow_parts
        self.map: Dict[tuple, Tuple[int, int]] = {}
        for tag, sp in enumerate(shadow_parts):
            if sp.num_rows == 0:
                continue
            vis = sp.visible_mask(None)
            ids = np.nonzero(vis)[0]
            lanes = [sp.lanes[c] for c in self.pk]
            for i in ids.tolist():
                self.map[tuple(int(lane[i]) for lane in lanes)] = (tag, i)

    def delete(self, want, commit_ts: int) -> int:
        by_tag: Dict[int, List[int]] = {}
        for key in want:
            hit = self.map.pop(key, None)
            if hit is not None:
                by_tag.setdefault(hit[0], []).append(hit[1])
        for tag, ids in by_tag.items():
            self.parts[tag].delete_rows(np.asarray(ids, dtype=np.int64),
                                        commit_ts)
        return sum(len(v) for v in by_tag.values())

    def note_appended(self, tag: int, keys: List[tuple], start: int):
        for off, key in enumerate(keys):
            self.map[key] = (tag, start + off)


class _CatchupApplier:
    """Replays this table's CDC events (seq > watermark) onto the shadows.

    Events are filtered to rows that the OLD routing places in the source
    partitions, then routed by the TARGET map.  Inserts delete-by-PK first so
    re-delivery after a crash (the persisted watermark is per PAGE, not per
    event) converges instead of duplicating."""

    def __init__(self, ctx, tm, desc, shadow: ShadowSet):
        self.ctx = ctx
        self.tm = tm
        self.desc = desc
        self.shadow = shadow
        self.src = set(desc["src"])
        self.old_router = PartitionRouter(tm)  # live (pre-cutover) map
        self.new_router = PartitionRouter(tm, _info_from_desc(
            desc["partition"]))
        # NEW pid -> shadow tag (rows may only land on shadow targets)
        self.tag_of = {pid: ent[1]
                       for pid, ent in enumerate(desc["layout"])
                       if ent[0] == "shadow"}
        self.pk_index = _ShadowPkIndex(tm, shadow.partitions)
        self.events_applied = 0
        self.last_event_ts = 0

    def apply_page(self, page: List[tuple]) -> int:
        tm = self.tm
        for _seq, commit_ts, schema, table, kind, payload in page:
            if schema != tm.schema.lower() or table != tm.name.lower():
                continue
            d = json.loads(payload)
            rows = d["rows"]
            if not rows:
                continue
            lanes, valid = _encode_rows(tm, d["columns"], rows)
            old_pids = _route_lanes(tm, self.old_router, lanes)
            keep = np.nonzero(np.isin(old_pids,
                                      np.asarray(sorted(self.src))))[0]
            if keep.size == 0:
                continue
            if kind == "insert":
                want = _pk_tuples(tm, lanes, valid, keep.tolist())
                self.pk_index.delete(set(want), commit_ts)
                new_pids = _route_lanes(tm, self.new_router, lanes)
                key_of = dict(zip(keep.tolist(), want))
                for pid in np.unique(new_pids[keep]):
                    tag = self.tag_of[int(pid)]
                    sel = keep[new_pids[keep] == pid]
                    target = self.shadow.partitions[tag]
                    start = target.num_rows
                    target.append(
                        {k: v[sel] for k, v in lanes.items()},
                        {k: v[sel] for k, v in valid.items()}, commit_ts)
                    self.pk_index.note_appended(
                        tag, [key_of[i] for i in sel.tolist()], start)
            elif kind == "delete":
                want = set(_pk_tuples(tm, lanes, valid, keep.tolist()))
                self.pk_index.delete(want, commit_ts)
            else:
                raise errors.TddlError(f"unknown binlog event kind {kind!r}")
            self.events_applied += 1
            self.last_event_ts = max(self.last_event_ts, int(commit_ts))
        return self.events_applied

    def run_to_head(self, kv, tm) -> int:
        """Page through the stream from the persisted watermark to the head,
        persisting the watermark after every page."""
        cdc = self.ctx.instance.cdc
        key = _kv(tm.schema, tm.name, "cdc_seq")
        last = int(kv.kv_get(key) or 0)
        while True:
            page = cdc.events_after_seq(last, limit=_CATCHUP_PAGE)
            if not page:
                break
            self.apply_page(page)
            last = int(page[-1][0])
            kv.kv_put(key, str(last))
            FAIL_POINTS.inject(FP_REBALANCE_CATCHUP, f"seq={last}")
            if len(page) < _CATCHUP_PAGE:
                break
        return last


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

@task
class RebalancePrepareTask(DdlTask):
    """Compute + persist the complete target partitioning (one elastic job
    per table at a time); converts hash tables to bucket-map routing."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        if "$" in tm.name:
            raise errors.TddlError(
                "elastic rebalancing does not apply to GSI backing tables")
        if getattr(tm, "remote", None) is not None:
            raise errors.TddlError(
                "elastic rebalancing does not apply to remote tables "
                "(use MOVE TABLE)")
        if not tm.primary_key:
            raise errors.TddlError(
                "elastic rebalancing requires a primary key (the CDC catchup "
                "replays deletes by PK)")
        if not ctx.instance.cdc.enabled():
            raise errors.TddlError(
                "elastic rebalancing requires ENABLE_CDC (the catchup tails "
                "the binlog stream)")
        kv = ctx.instance.metadb
        raw = kv.kv_get(_kv(tm.schema, tm.name, "desc"))
        if raw:
            existing = json.loads(raw)
            if existing.get("job_id") == ctx.job_id:
                return  # idempotent re-run after a crash
            raise errors.TddlError(
                f"a rebalance job (#{existing.get('job_id')}) is already "
                f"running on {tm.schema}.{tm.name}")
        op = self.payload["op"]
        n = tm.partition.num_partitions
        for pid in self.payload.get("pids", []):
            if not 0 <= pid < n:
                raise errors.TddlError(f"table has no partition p{pid}")
        if op == "split":
            desc = plan_split(ctx, tm, self.payload["pids"][0],
                              int(self.payload.get("into", 2)),
                              self.payload.get("at"))
        elif op == "merge":
            desc = plan_merge(ctx, tm, *self.payload["pids"][:2])
        elif op == "move":
            desc = plan_move(ctx, tm, self.payload["pids"][0],
                             self.payload["group"])
        else:
            raise errors.TddlError(f"unknown rebalance op {op!r}")
        desc["job_id"] = ctx.job_id
        kv.kv_put(_kv(tm.schema, tm.name, "desc"), json.dumps(desc))
        _progress_update(ctx, tm, table=_table_key(tm), kind=desc["kind"],
                         src=desc["src"],
                         targets=sum(1 for e in desc["layout"]
                                     if e[0] == "shadow"),
                         phase="prepare", rows_copied=0, events_applied=0)
        ctx.instance.counters.inc("rebalance_jobs")
        events.publish("rebalance", f"{desc['kind']} {_table_key(tm)} "
                       f"src={desc['src']}", node=ctx.instance.node_id,
                       job_id=ctx.job_id)

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        kv = ctx.instance.metadb
        _finish_progress(ctx, tm, "ROLLBACK")
        for f in ("desc", "snapshot_ts", "cdc_seq", "catchup_ts", "cutover"):
            kv.kv_delete(_kv(tm.schema, tm.name, f))


@task
class RebalanceBackfillTask(DdlTask):
    """Chunked snapshot copy of the SOURCE partitions into shadow partitions
    routed by the TARGET map, with a persisted [src_index, offset] checkpoint
    (Extractor/Loader at partition scope).  Yields to serving: between chunks
    the memory governor's pressure tier inserts a pacing sleep."""

    CHUNK = 8192

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        store = ctx.instance.store(tm.schema, tm.name)
        kv = ctx.instance.metadb
        desc = json.loads(kv.kv_get(_kv(tm.schema, tm.name, "desc")))
        nonce = f"job{ctx.job_id}"
        reg = _shadows(ctx.instance)
        shadow = reg.get(_table_key(tm))
        n_targets = sum(1 for e in desc["layout"] if e[0] == "shadow")
        position = self.payload.get("position", [0, 0])
        if shadow is None or shadow.nonce != nonce:
            # fresh process (or a different attempt): the in-memory shadows
            # are gone, so any persisted checkpoint is unusable — restart
            # the copy from scratch with clean markers
            shadow = ShadowSet(nonce, tm, n_targets)
            reg[_table_key(tm)] = shadow
            position = [0, 0]
            kv.kv_delete(_kv(tm.schema, tm.name, "snapshot_ts"))
            kv.kv_delete(_kv(tm.schema, tm.name, "cdc_seq"))
            # the abandoned attempt's counters would double-count on top of
            # the from-scratch copy
            _progress_update(ctx, tm, rows_copied=0, events_applied=0,
                             checkpoint=[0, 0])
        # CDC watermark BEFORE the snapshot TSO: every event the snapshot
        # copy might miss has seq > this head (replayed idempotently)
        if kv.kv_get(_kv(tm.schema, tm.name, "cdc_seq")) is None:
            head = kv.query("SELECT COALESCE(MAX(seq), 0) FROM binlog_events")
            kv.kv_put(_kv(tm.schema, tm.name, "cdc_seq"),
                      str(int(head[0][0])))
        raw = kv.kv_get(_kv(tm.schema, tm.name, "snapshot_ts"))
        snapshot = int(raw) if raw else ctx.instance.tso.next_timestamp()
        kv.kv_put(_kv(tm.schema, tm.name, "snapshot_ts"), str(snapshot))
        new_router = PartitionRouter(tm, _info_from_desc(desc["partition"]))
        tag_of = {pid: ent[1] for pid, ent in enumerate(desc["layout"])
                  if ent[0] == "shadow"}
        cols = tm.column_names()
        rows_before = int(json.loads(
            kv.kv_get(_kv(tm.schema, tm.name, "progress")) or "{}"
        ).get("rows_copied") or 0)
        rows_copied = 0
        sstart, roffset = position
        governor = getattr(getattr(ctx.instance, "admission", None),
                           "governor", None)
        throttle_ms = ctx.instance.config.get("REBALANCE_THROTTLE_MS") or 0
        for si in range(sstart, len(desc["src"])):
            p = store.partitions[desc["src"][si]]
            with p.lock:
                vis = p.visible_mask(snapshot)
                idx = np.nonzero(vis)[0]
            start = roffset if si == sstart else 0
            while start < idx.shape[0]:
                chunk = idx[start:start + self.CHUNK]
                # copy under the source lock, append OUTSIDE it: holding a
                # partition lock while taking a shadow partition lock would
                # be a same-class nesting the lockdep witness rejects
                with p.lock:
                    lanes = {c: p.lanes[c][chunk] for c in cols}
                    valid = {c: p.valid[c][chunk] for c in cols}
                    begin = p.begin_ts[chunk]
                new_pids = _route_lanes(tm, new_router, lanes)
                for pid in np.unique(new_pids):
                    tag = tag_of.get(int(pid))
                    if tag is None:
                        raise errors.TddlError(
                            f"rebalance route leak: source row routed to "
                            f"untouched partition p{int(pid)}")
                    sel = np.nonzero(new_pids == pid)[0]
                    target = shadow.partitions[tag]
                    target.append(
                        {k: v[sel] for k, v in lanes.items()},
                        {k: v[sel] for k, v in valid.items()}, snapshot)
                    # preserve the source rows' ORIGINAL begin stamps: the
                    # verify gates can then compare source vs shadow at ANY
                    # timestamp (the online gate deliberately checks at a
                    # lagged one), and the cutover swap keeps MVCC history
                    # consistent for snapshot reads in flight epochs ago.
                    # The shadow is job-private until cutover, so the
                    # post-append fixup cannot race a reader.
                    with target.lock:
                        target.begin_ts[-sel.size:] = begin[sel]
                start += self.CHUNK
                rows_copied += int(chunk.shape[0])
                self.payload["position"] = [si, start]
                ctx._checkpoint()
                # live operator view: SHOW REBALANCE tracks the copy as it
                # runs, not just at phase boundaries
                _progress_update(ctx, tm, phase="backfill",
                                 rows_copied=rows_before + rows_copied,
                                 checkpoint=[si, start])
                FAIL_POINTS.inject(FP_REBALANCE_CHUNK, f"s{si}@{start}")
                if governor is not None and governor.tier() > 0 and \
                        throttle_ms:
                    # graceful degradation: rebalance yields to serving
                    time.sleep(throttle_ms / 1000.0)
            roffset = 0
        _progress_update(ctx, tm, phase="backfill",
                         rows_copied=rows_before + rows_copied,
                         checkpoint=self.payload.get("position"))

    def undo(self, ctx):
        tm = ctx.table(self.payload["table"])
        _shadows(ctx.instance).pop(_table_key(tm), None)


@task
class RebalanceCatchupTask(DdlTask):
    """Online CDC catchup narrowing the delta before the locked cutover."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        kv = ctx.instance.metadb
        desc = json.loads(kv.kv_get(_kv(tm.schema, tm.name, "desc")))
        shadow = _shadows(ctx.instance).get(_table_key(tm))
        if shadow is None:
            raise errors.TddlError(
                "rebalance shadow state lost (process restart mid-job); "
                "the backfill task re-creates it on resume")
        applier = _CatchupApplier(ctx, tm, desc, shadow)
        applier.run_to_head(kv, tm)
        catchup_ts = ctx.instance.tso.next_timestamp()
        kv.kv_put(_kv(tm.schema, tm.name, "catchup_ts"), str(catchup_ts))
        prev = int(json.loads(kv.kv_get(_kv(tm.schema, tm.name, "progress"))
                              or "{}").get("events_applied") or 0)
        _progress_update(ctx, tm, phase="catchup",
                         events_applied=prev + applier.events_applied,
                         last_event_ts=applier.last_event_ts)
        ctx.instance.counters.inc("rebalance_events_applied",
                                  applier.events_applied)


def _checksum_pair(ctx, tm, store, desc, shadow, ts):
    from galaxysql_tpu_torch.utils.fastchecker import partitions_checksum
    cols = tm.column_names()
    src_parts = [store.partitions[i] for i in desc["src"]]
    b = partitions_checksum(src_parts, cols, ts)
    sn, ss = partitions_checksum(shadow.partitions, cols, ts)
    if FAIL_POINTS.active and \
            FAIL_POINTS.value(FP_REBALANCE_VERIFY_MISMATCH):
        ss ^= 1  # drive the REAL mismatch -> rollback path
    return b, (sn, ss)


@task
class RebalanceVerifyTask(DdlTask):
    """Online FastChecker gate, checked at a LAGGED timestamp.

    The binlog write trails row visibility by however long the metadb commit
    takes, so under sustained writes a checksum at "now" would see source
    rows whose events are still in flight — a structural false mismatch.
    The backfill preserved original begin stamps, so source and shadow agree
    at ANY timestamp old enough for its events to have landed: check at
    catchup_ts - REBALANCE_VERIFY_LAG_MS.  (The cutover re-verifies exactly
    at the fence, with writes drained — this gate exists to abort a corrupt
    copy BEFORE taking the exclusive MDL.)  One fresh-catchup retry absorbs
    extreme lag; a second mismatch aborts the job pre-swap and the
    reverse-order undo restores the source exactly — it was never touched."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        store = ctx.instance.store(tm.schema, tm.name)
        kv = ctx.instance.metadb
        desc = json.loads(kv.kv_get(_kv(tm.schema, tm.name, "desc")))
        shadow = _shadows(ctx.instance).get(_table_key(tm))
        if shadow is None:
            raise errors.TddlError("rebalance shadow state lost")
        margin = int(float(ctx.instance.config.get(
            "REBALANCE_VERIFY_LAG_MS") or 5000)) << LOGICAL_BITS

        ts = int(kv.kv_get(_kv(tm.schema, tm.name, "catchup_ts"))) - margin
        b, s = _checksum_pair(ctx, tm, store, desc, shadow, ts)
        if b != s:
            applier = _CatchupApplier(ctx, tm, desc, shadow)
            applier.run_to_head(kv, tm)
            fresh = ctx.instance.tso.next_timestamp()
            kv.kv_put(_kv(tm.schema, tm.name, "catchup_ts"), str(fresh))
            b, s = _checksum_pair(ctx, tm, store, desc, shadow,
                                  fresh - margin)
            if b != s:
                raise errors.TddlError(
                    f"rebalance verify failed: source {b[0]} rows "
                    f"(sum {b[1]:#x}) != shadow {s[0]} rows (sum {s[1]:#x})")
        _progress_update(ctx, tm, phase="verified", verified_rows=b[0])


@task
class RebalanceCutoverTask(DdlTask):
    """TSO-fenced atomic cutover under the table's EXCLUSIVE MDL: drain open
    transactions pinning the store, final CDC catchup to the fence, then swap
    partitions + routing map + versioned router, bump versions, and broadcast
    invalidations so peers and caches never see the stale map.  A durable
    cutover marker makes a crash-resumed re-run skip straight to the
    (idempotent) publication steps."""

    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        store = ctx.instance.store(tm.schema, tm.name)
        kv = ctx.instance.metadb
        desc = json.loads(kv.kv_get(_kv(tm.schema, tm.name, "desc")))
        key = _table_key(tm)
        with ctx.instance.mdl.exclusive(key):
            if kv.kv_get(_kv(tm.schema, tm.name, "cutover")) is None:
                shadow = _shadows(ctx.instance).get(key)
                if shadow is None:
                    raise errors.TddlError("rebalance shadow state lost")
                self._drain_open_txns(ctx, store, desc)
                # the EXACT verify: statements are drained (exclusive MDL
                # covers the whole DML ramp including its binlog write) and
                # open txns resolved, so source and shadow must agree at the
                # fence to the bit — a half-moved partition can never swap
                # in.  Bounded retry: a commit that finalized its stamps
                # just before the drain passed may still be flushing its
                # binlog rows (flush_txn runs after stamping); a fresh
                # catchup moments later picks those up.
                for attempt in range(5):
                    applier = _CatchupApplier(ctx, tm, desc, shadow)
                    applier.run_to_head(kv, tm)
                    fence_ts = ctx.instance.tso.next_timestamp()
                    b, s = _checksum_pair(ctx, tm, store, desc, shadow,
                                          fence_ts)
                    if b == s:
                        break
                    time.sleep(0.02)
                else:
                    raise errors.TddlError(
                        f"rebalance cutover verify failed at the fence: "
                        f"source {b[0]} rows (sum {b[1]:#x}) != shadow "
                        f"{s[0]} rows (sum {s[1]:#x})")
                FAIL_POINTS.inject(FP_REBALANCE_BEFORE_SWAP, key)
                self._swap(ctx, tm, store, desc, shadow)
                kv.kv_put(_kv(tm.schema, tm.name, "cutover"), str(fence_ts))
                FAIL_POINTS.inject(FP_REBALANCE_AFTER_SWAP, key)
            # publication (idempotent; re-run after FP_REBALANCE_AFTER_SWAP
            # must land here WITHOUT re-swapping)
            ctx.bump(tm)
            _progress_update(ctx, tm, phase="cutover",
                             router_epoch=store.router.epoch)
        # peers must never route by the stale map: fragment epoch + plan
        # cache invalidation ride the SyncBus (epoch-bumped broadcast)
        ctx.instance.sync_bus.broadcast("invalidate_fragment_cache",
                                        {"table_key": key})
        ctx.instance.sync_bus.broadcast("invalidate_plan_cache", {})
        events.publish("rebalance", f"cutover {key} ({desc['kind']}) -> "
                       f"{len(store.partitions)} partitions",
                       node=ctx.instance.node_id, job_id=ctx.job_id)

    @staticmethod
    def _drain_open_txns(ctx, store, desc, timeout: Optional[float] = None):
        """Open transactions hold (store, pid, row-range) undo entries that a
        partition swap would orphan — their COMMIT would stamp the detached
        partition objects and the write would silently vanish.  New DML is
        blocked on our exclusive MDL, so waiting converges; a wedge aborts
        typed (rollback leaves the source serving).

        Two checks, because `Session._commit` clears `sess.txn` BEFORE
        applying the commit: (1) session txn pins, (2) provisional
        (negative) MVCC stamps still present in the source partitions — a
        mid-flight commit keeps its stamps provisional until fully applied,
        so the swap cannot slip into that window and detach rows whose
        finalization is racing."""
        if timeout is None:
            timeout = float(ctx.instance.config.get(
                "REBALANCE_DRAIN_TIMEOUT_S") or 30.0)
        deadline = time.time() + timeout
        src_parts = [store.partitions[i] for i in desc["src"]]

        def _pinned():
            for sess in list(ctx.instance.sessions.values()):
                txn = getattr(sess, "txn", None)
                if txn is None:
                    continue
                for ent in list(txn.inserted) + list(txn.deleted):
                    if ent[0] is store:
                        return True
            for p in src_parts:
                with p.lock:
                    if bool((p.begin_ts < 0).any()) or \
                            bool((p.end_ts < 0).any()):
                        return True
            return False

        while _pinned():
            if time.time() > deadline:
                raise errors.TddlError(
                    "rebalance cutover: open transactions pin the table; "
                    "retry later")
            time.sleep(0.02)

    @staticmethod
    def _swap(ctx, tm, store, desc, shadow):
        old_parts = store.partitions
        new_info = _info_from_desc(desc["partition"])
        new_parts = []
        for pid, (src_kind, i) in enumerate(desc["layout"]):
            p = old_parts[i] if src_kind == "old" else shadow.partitions[i]
            p.pid = pid
            p.table = tm
            new_parts.append(p)
        tm.partition = new_info
        store.partitions = new_parts
        store.router = PartitionRouter(tm)  # fresh epoch: versioned swap
        tm.stats.row_count = sum(p.num_rows for p in new_parts)
        _shadows(ctx.instance).pop(_table_key(tm), None)

    # no undo: the durable cutover marker is the job's point of no return
    # (everything before it is reversible; the reference's cutover tasks
    # mark the same boundary)


@task
class RebalanceCleanupTask(DdlTask):
    def run(self, ctx):
        tm = ctx.table(self.payload["table"])
        kv = ctx.instance.metadb
        _finish_progress(ctx, tm, "DONE")
        for f in ("desc", "snapshot_ts", "cdc_seq", "catchup_ts", "cutover"):
            kv.kv_delete(_kv(tm.schema, tm.name, f))
        _shadows(ctx.instance).pop(_table_key(tm), None)


# ---------------------------------------------------------------------------
# job factories
# ---------------------------------------------------------------------------

def _job(schema: str, sql: str, table: str, prepare_payload: dict) -> DdlJob:
    payload = {"table": table}
    return DdlJob(schema, sql, [
        ValidateTableTask({"table": table}),
        RebalancePrepareTask(dict(prepare_payload, table=table)),
        RebalanceBackfillTask(dict(payload)),
        RebalanceCatchupTask(dict(payload)),
        RebalanceVerifyTask(dict(payload)),
        RebalanceCutoverTask(dict(payload)),
        RebalanceCleanupTask(dict(payload)),
        InvalidatePlansTask({}),
    ])


def split_partition_job(schema: str, sql: str, table: str, pid: int,
                        into: int = 2, at: Optional[Any] = None) -> DdlJob:
    return _job(schema, sql, table,
                {"op": "split", "pids": [pid], "into": into, "at": at})


def merge_partitions_job(schema: str, sql: str, table: str, a: int,
                         b: int) -> DdlJob:
    return _job(schema, sql, table, {"op": "merge", "pids": [a, b]})


def move_partition_job(schema: str, sql: str, table: str, pid: int,
                       group: str) -> DdlJob:
    return _job(schema, sql, table,
                {"op": "move", "pids": [pid], "group": group})
