"""Pipeline segment fusion (port of `galaxysql_tpu/exec/fusion.py`).

A *segment* is the maximal chain of streaming operators (`FilterOp`, `ProjectOp`)
between pipeline breakers (HashAgg build, HashJoin build, Sort, Window, Limit,
Union).  The reference compiles a segment into ONE XLA program per batch; here a
segment is an eager composition of the port's `ExprCompiler` stage closures on the
batch's device: a filter stage ANDs its predicate into the live mask, a project stage
rebinds the environment, an `("rf", ...)` stage masks a scan column against a join
build side's published runtime filter (`exec/runtime_filter.py`).  Nothing is
compiled (no `torch.compile`); the composed closure is kept in the operators'
`closure_cache` under the segment's structural key, so a repeated query does not
rebuild it.  The runtime filter's words and range are call-time arguments, as in the
reference, so the cached closure serves every build.  A host batch (`ColumnBatch.host`)
of at most `TP_HOST_ROWS` rows runs the same composition on `ExprCompiler(np)` with
the copied `RfStageRef.make_fn(np)` for its rf stages, the reference's host program,
and stays a host batch; the aggregation and join-probe preludes see device batches
only (their operators pull through `operators.device_batches`), as the reference's
run inside its jitted programs.

What fusion still saves in eager PyTorch: no intermediate `ColumnBatch` per operator,
and zero-copy passthrough.  Output columns that resolve to a bare input column
(possibly renamed through intermediate projects) are never materialized: the
original column buffers are reattached (`attach_columns`).

The `rf` stage is lowered here, not by the copied `RfStageRef.make_fn` (written for
numpy/jnp): bloom positions from `kernels/hashing._mix64` over the lane's int64
bits, which equal `meta/statistics._mix64` over uint64 bit for bit (the copied
`RuntimeFilter.build` hashes with the latter); `flags[b1] & flags[b2]`; `lo <= d <=
hi` in the lane's own order (BIGINT UNSIGNED lanes hold uint64 bits and compare
unsigned); NULL keys masked.  An empty build publishes lo > hi: the stage passes
nothing.  The join build publishes its filters from here too (`publish_on_device`):
flags, range and IN-list are built on the build batch's device, equal to
`RuntimeFilter.build` on the host keys, so the flags never cross to the host and back.

`GALAXYSQL_FUSION=0` (read at import) and the `NO_FUSE` statement hint turn fusion
off, as in the reference.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, as_tensor,
                                             dictionary_translation, to_device,
                                             to_numpy)
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec import runtime_filter as _rf
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import (ExprCompiler, TorchXP, _find_dictionary,
                                               batch_env)
from galaxysql_tpu_torch.kernels.hashing import _mix64, as_u64_bits, lsr
from galaxysql_tpu_torch.types import datatype as dt

# kill switch: GALAXYSQL_FUSION=0 runs every streaming operator on its own (the
# pre-fusion shape), the lever of the fused-vs-unfused equivalence tests
ENABLED = os.environ.get("GALAXYSQL_FUSION", "1") != "0"

# Stage = ("filter", ir.Expr) | ("project", [(name, ir.Expr), ...])
#       | ("rf", runtime_filter.RfStageRef)
Stage = Tuple[str, Any]

_SEGMENT_IDS = itertools.count(1)

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def default_enabled(hints: Optional[dict]) -> bool:
    """Per-execution fusion decision: module switch + NO_FUSE statement hint."""
    return ENABLED and not (hints or {}).get("no_fuse", False)


def _rf_bounds(lo, hi, unsigned: bool):
    """(lo, hi) as Python ints in the compared lane's order, or None when no value
    of the lane lies in [lo, hi].  An unsigned lane compares `u64_ordered` bits,
    whose order is the unsigned value minus 2^63."""
    lo, hi = int(lo), int(hi)
    if unsigned:
        lo, hi = max(lo, 0), min(hi, (1 << 64) - 1)
        lo, hi = lo + _INT64_MIN, hi + _INT64_MIN
    else:
        lo, hi = max(lo, _INT64_MIN), min(hi, _INT64_MAX)
    if lo > hi:
        return None
    return lo, hi


def rf_stage_fn(ref, col_dtype: Optional[dt.DataType]):
    """Torch lowering of one ("rf", ref) stage: `(env, live, args) -> live'` with
    `args` = (flags tensor on the lane's device, lo, hi) from `RfStageRef`."""
    static = ref.static_key()[-1]
    if static == ("off",):
        return lambda env, live, args: live
    nbits, has_minmax = static
    col = ref.target.out_id
    unsigned = col_dtype is not None and col_dtype.clazz == dt.TypeClass.UINT

    def fn(env, live, args):
        flags, lo, hi = args
        d, v = env[col]
        n = live.shape[0]
        d = torch.broadcast_to(torch.as_tensor(d, device=live.device), (n,))
        bits = as_u64_bits(d)  # the int64 lane the bloom hashes and integers compare
        hit = None
        if nbits:
            h = _mix64(bits)
            b1 = h & (nbits - 1)
            b2 = lsr(h, 32) & (nbits - 1)
            hit = (flags[b1] & flags[b2]) > 0
        if has_minmax:
            if d.is_floating_point():
                dd = d.to(torch.float64)
                mm = (dd >= float(lo)) & (dd <= float(hi))
            else:
                bounds = _rf_bounds(lo, hi, unsigned)
                if bounds is None:
                    mm = torch.zeros(n, dtype=torch.bool, device=live.device)
                else:
                    dd = bits ^ _INT64_MIN if unsigned else bits
                    mm = (dd >= bounds[0]) & (dd <= bounds[1])
            hit = mm if hit is None else hit & mm
        if hit is None:
            return live
        if v is not None:
            # NULL probe keys never match an inner/semi join
            hit = hit & torch.broadcast_to(v, (n,))
        return live & hit
    return fn


def _on(flags, device) -> torch.Tensor:
    """Bloom flags on `device`: a filter built on the card already is (no copy)."""
    if isinstance(flags, torch.Tensor):
        return flags.to(device)
    return as_tensor(np.asarray(flags), device)


def _masked_extremes(d: torch.Tensor, keep: torch.Tensor, unsigned: bool):
    """(min, max) of `d` over the rows `keep` marks (at least one), as numpy scalars
    of the lane's numpy type (uint64 for BIGINT UNSIGNED), read in one copy."""
    if unsigned:
        d = d ^ _INT64_MIN  # unsigned order on the int64 bits
    if d.is_floating_point():
        big, small = float("inf"), float("-inf")
    else:
        big, small = torch.iinfo(d.dtype).max, torch.iinfo(d.dtype).min
    lo = torch.where(keep, d, torch.full_like(d, big)).amin()
    hi = torch.where(keep, d, torch.full_like(d, small)).amax()
    lo, hi = to_numpy(torch.stack([lo, hi]))
    if unsigned:
        lo, hi = (np.asarray([lo, hi], dtype=np.int64) ^ np.int64(_INT64_MIN)) \
            .view(np.uint64)
    return lo, hi


def _filter_on_device(batch: ColumnBatch, live: torch.Tensor,
                      spec) -> Optional[_rf.RuntimeFilter]:
    """`runtime_filter.build_filter` over a build batch's own device: the same
    flags, range and IN-list as `RuntimeFilter.build` on the host keys.  Only the
    live key count, the range and an IN-list candidate (at most
    RF_IN_LIST_MAX * 4 keys) reach the host."""
    device = batch.device
    bkey, pkey = spec.build_key, spec.probe_key
    fn = ops.closure_cache(("rf_build_key", str(device), ops.expr_cache_key(bkey)),
                           lambda: ExprCompiler(TorchXP(device)).compile(bkey))
    n = batch.capacity
    d, v = fn(batch_env(batch))
    d = torch.broadcast_to(torch.as_tensor(d, device=device), (n,))
    keep = live if v is None else live & torch.broadcast_to(v, (n,))
    is_string = bkey.dtype.is_string and pkey.dtype.is_string
    if is_string:
        db, dp = _find_dictionary(bkey), _find_dictionary(pkey)
        if db is not None and dp is not None and db is not dp:
            trans = as_tensor(dictionary_translation(dp, db), device)
            d = trans[d.to(torch.int64).clamp(0, trans.shape[0] - 1)]
            keep = keep & (d >= 0)
    _rf.RF_STATS["filters_built"] += 1
    kinds = set(spec.kinds)
    k = int(keep.sum())
    if k == 0:
        return _rf.RuntimeFilter.build(np.zeros(0, dtype=np.int64), kinds)
    unsigned = bkey.dtype.clazz == dt.TypeClass.UINT and d.dtype == torch.int64
    lo = hi = None
    if "minmax" in kinds:
        lo, hi = _masked_extremes(d, keep, unsigned)
    flags, nbits = None, 0
    if "bloom" in kinds and k <= _rf.RF_BLOOM_MAX_BUILD:
        nbits = 1 << max(_rf.RF_BLOOM_MIN_BITS.bit_length() - 1,
                         int(k * 16 - 1).bit_length())
        nbits = min(nbits, _rf.RF_BLOOM_MAX_BITS)
        h = _mix64(as_u64_bits(d))
        flags = torch.zeros(nbits + 1, dtype=torch.uint8, device=device)
        for pos in (h & (nbits - 1), lsr(h, 32) & (nbits - 1)):
            flags[torch.where(keep, pos, torch.full_like(pos, nbits))] = 1
        flags = flags[:nbits]
    in_vals = None
    if "bloom" in kinds and k <= _rf.RF_IN_LIST_MAX * 4 and not is_string:
        keys = to_numpy(d[keep])
        u = np.unique(keys.view(np.uint64) if unsigned else keys)
        if u.size <= _rf.RF_IN_LIST_MAX:
            in_vals = u
    if flags is None and lo is None and in_vals is None:
        return None
    return _rf.RuntimeFilter(k, flags, nbits, lo, hi, in_vals)


def publish_on_device(manager, specs, build_batch: ColumnBatch):
    """HashJoinOp's publish step: `runtime_filter.publish_from_batch`'s gates, with
    each filter built on the build batch's device (`_filter_on_device`) instead of
    from host copies of the key lanes.  The bloom flags stay where the probe-side
    rf stages read them."""
    if manager is None or not specs or manager.mode == "off":
        return
    if build_batch.capacity == 0 or build_batch.capacity > _rf.RF_PUBLISH_MAX_LANES:
        _rf.publish_from_batch(manager, specs, build_batch)  # no lane copy either way
        return
    live = build_batch.live_mask()
    n_live = build_batch.capacity if build_batch.live is None else int(live.sum())
    if n_live > _rf.RF_PUBLISH_MAX_ROWS:
        return
    t0 = time.perf_counter()
    for spec in specs:
        manager.publish(spec.filter_id, _filter_on_device(build_batch, live, spec))
    manager.note_build(round((time.perf_counter() - t0) * 1000, 3))


def _compose(stages: Sequence[Stage], comp: ExprCompiler, rf_fn):
    """The stages compiled by `comp` (rf stages by `rf_fn(ref)`) and composed into
    `(env, live, rf_args[, on_stage]) -> (env', live')`: a filter stage ANDs its
    predicate into the live mask, a project stage rebinds the environment, an rf
    stage masks the live rows with its call-time args."""
    compiled = []
    for kind, payload in stages:
        if kind == "rf":
            compiled.append(("rf", rf_fn(payload)))
        elif kind == "filter":
            compiled.append(("filter", comp.compile_predicate(payload)))
        else:
            compiled.append(("project", [(name, comp.compile(e)) for name, e in payload]))

    def apply(env, live, rf_args, on_stage=None):
        env = dict(env)
        ri = 0
        for kind, fns in compiled:
            if kind == "rf":
                live = fns(env, live, rf_args[ri])
                ri += 1
            elif kind == "filter":
                live = live & fns(env)
            else:
                env = {name: f(env) for name, f in fns}
            if on_stage is not None:
                on_stage(kind, live)
        return env, live
    return apply


class FusedSegment:
    """A streaming-operator chain composed into one closure, plus the passthrough
    metadata the host needs to reattach un-computed lanes."""

    def __init__(self, stages: Sequence[Stage]):
        assert stages, "empty segment"
        self.stages: List[Stage] = list(stages)
        self.segment_id = next(_SEGMENT_IDS)
        self.chain = ">".join(kind for kind, _ in self.stages)
        # runtime-filter prelude stages, in stage order (injected as a prefix)
        self.rf_refs = [p for k, p in self.stages if k == "rf"]
        self.rf_stage_count = len(self.rf_refs)
        self.masks = any(k != "project" for k, _ in self.stages)
        # passthrough analysis: each final output name -> the INPUT column it is a
        # bare rename of, or None when computed.  alias=None means no project
        # stage: the output namespace IS the input namespace.
        alias: Optional[Dict[str, Optional[str]]] = None
        out_meta: Optional[List[Tuple[str, ir.Expr]]] = None
        for kind, payload in self.stages:
            if kind != "project":
                continue
            new_alias: Dict[str, Optional[str]] = {}
            for name, e in payload:
                if isinstance(e, ir.ColRef):
                    src = e.name if alias is None else alias.get(e.name)
                else:
                    src = None
                new_alias[name] = src
            alias = new_alias
            out_meta = list(payload)
        self.alias = alias
        self.out_meta = out_meta
        self.computed = [] if alias is None else \
            [name for name, src in alias.items() if src is None]
        self._dev_args: Dict[str, Tuple] = {}
        self._apply_memo: Dict[str, Any] = {}
        # EXPLAIN ANALYZE sink: when a list, every batch also records the live count
        # after each stage (index 0 = the input) and the wall ms
        self.stats_sink: Optional[list] = None

    # -- identity -----------------------------------------------------------------

    def key(self) -> Tuple:
        """Structural key of the chain (literal values baked in: nothing here is
        compiled, so nothing is lifted)."""
        parts: List[Tuple] = []
        for kind, payload in self.stages:
            if kind == "rf":
                parts.append(payload.static_key())
            elif kind == "filter":
                parts.append(("filter", ops.expr_cache_key(payload)))
            else:
                parts.append(("project", tuple((name, ops.expr_cache_key(e))
                                               for name, e in payload)))
        return ("fused_segment", tuple(parts))

    def inert(self) -> bool:
        """True when every stage is an UNPUBLISHED runtime filter: the segment is
        the identity.  Valid only once the producing build has had its chance to
        publish (from the first probe batch on)."""
        return all(k == "rf" for k, _ in self.stages) and \
            all(r.static_key()[-1] == ("off",) for r in self.rf_refs)

    def _rf_args(self, device) -> Tuple:
        """Each rf stage's call-time args with its bloom flags on `device`, resolved
        at first use (after the build published) and shipped once per segment.  An
        unpublished filter's args are () (its stage is the identity)."""
        key = str(device)
        got = self._dev_args.get(key)
        if got is None:
            got = tuple((_on(a[0], device), a[1], a[2]) if a else ()
                        for a in (r.runtime_args() for r in self.rf_refs))
            self._dev_args[key] = got
        return got

    # -- composition --------------------------------------------------------------

    def build_apply(self, device, rf_dtypes: Optional[Dict[str, dt.DataType]] = None):
        """Stage-composition closure `(env, live, rf_args[, on_stage]) -> (env', live')`
        over torch tensors on `device`.  `rf_dtypes` maps each rf stage's column to
        its SQL type (unsigned lanes compare unsigned).  `on_stage(kind, live)` fires
        after each stage when given (the EXPLAIN ANALYZE counts)."""
        comp = ExprCompiler(TorchXP(device))
        return _compose(self.stages, comp, lambda payload: rf_stage_fn(
            payload, (rf_dtypes or {}).get(payload.target.out_id)))

    def _apply_for(self, batch: ColumnBatch):
        device = batch.device
        got = self._apply_memo.get(str(device))
        if got is not None:
            return got
        rf_dtypes = {}
        for r in self.rf_refs:
            c = batch.columns.get(r.target.out_id)
            if c is not None:
                rf_dtypes[r.target.out_id] = c.dtype
        key = ("fused", str(device), self.key(),
               tuple(sorted((k, v.clazz.name) for k, v in rf_dtypes.items())))
        got = ops.closure_cache(key, lambda: self.build_apply(device, rf_dtypes))
        self._apply_memo[str(device)] = got
        return got

    def _apply_np(self):
        """The stage composition on the numpy expression backend, the reference's
        `_program(False)`: runtime-filter stages lowered by the copied
        `RfStageRef.make_fn(np)`, over the lanes' host views."""
        return ops.closure_cache(("fused-np", self.key()), lambda: _compose(
            self.stages, ExprCompiler(np), lambda payload: payload.make_fn(np)))

    def _rf_args_np(self) -> Tuple:
        """Each rf stage's call-time args with its bloom flags as a host array."""
        got = self._dev_args.get("np")
        if got is None:
            got = tuple((to_numpy(a[0]), a[1], a[2]) if a else ()
                        for a in (r.runtime_args() for r in self.rf_refs))
            self._dev_args["np"] = got
        return got

    def _run_host(self, batch: ColumnBatch, sink):
        """`run_batch`'s host branch: the segment over a host batch with numpy, the
        result a host batch; (result, per-stage live counts or None)."""
        n = batch.capacity
        live_in = batch.np_live()
        counts = None
        on_stage = None
        if sink is not None:
            counts = [int(live_in.sum())]

            def on_stage(_kind, lv):
                counts.append(int(np.broadcast_to(lv, (n,)).sum()))
        env, live = self._apply_np()(ops._host_env(batch), live_in,
                                     self._rf_args_np(), on_stage)
        live = np.broadcast_to(np.asarray(live), (n,))
        out = {}
        for name in self.computed:
            d, v = env[name]
            out[name] = (ops.host_lane(d, n), ops.host_lane(v, n))
        result = ColumnBatch(self.attach_columns(batch.columns, out),
                             ops.host_lane(live, n), batch.host)
        return result, (None if counts is None else np.array(counts, dtype=np.int64))

    def apply_batch(self, batch: ColumnBatch, on_stage=None):
        """(env', live') of the segment over one batch: the prelude form HashAggOp's
        partial pass and HashJoinOp's probe read (no intermediate batch)."""
        live = batch.live_mask() if self.masks or on_stage is not None else batch.live
        return self._apply_for(batch)(batch_env(batch), live,
                                      self._rf_args(batch.device), on_stage)

    # -- execution ----------------------------------------------------------------

    def attach_columns(self, src_columns: Dict[str, Column],
                       out: Dict[str, Any]) -> Dict[str, Column]:
        """Final output columns: computed lanes from the composition, passthrough
        lanes reattached from the ORIGINAL input buffers (zero-copy)."""
        if self.alias is None:
            return dict(src_columns)  # no project stage: identity namespace
        cols: Dict[str, Column] = {}
        for name, e in self.out_meta:
            src = self.alias[name]
            if src is not None:
                c0 = src_columns[src]
                cols[name] = Column(c0.data, c0.valid, c0.dtype, c0.dictionary)
            else:
                d, v = out[name]
                cols[name] = Column(d, v, e.dtype, _find_dictionary(e))
        return cols

    def run_batch(self, batch: ColumnBatch) -> ColumnBatch:
        """Apply the segment to one ColumnBatch.  As FilterOp and ProjectOp do, a
        host batch of at most TP_HOST_ROWS rows runs the numpy backend and stays a
        host batch; a larger one joins the device first."""
        sink = self.stats_sink
        tc = _trace_ctx()
        timed = sink is not None or tc is not None or _tracer_on()
        t0 = time.perf_counter() if timed else 0.0
        if ops._is_host_batch(batch) and batch.capacity <= ops.TP_HOST_ROWS:
            ops.HOST_TIER_STATS["numpy_runs"] += 1
            result, counts = self._run_host(batch, sink)
        else:
            batch = to_device(batch)
            result, counts = self._run_device(batch, sink)
        ops.DISPATCH_STATS["dispatches"] += 1
        if timed:
            wall = round((time.perf_counter() - t0) * 1000, 3)
            self._observe(tc, sink, counts, wall)
            if _tracer_on():
                self._record_span(batch, result, wall)
        return result

    def _run_device(self, batch: ColumnBatch, sink):
        """`run_batch` on the batch's device; (result, per-stage live counts or
        None)."""
        counts = None
        n = batch.capacity
        if sink is not None:
            counts = [batch.num_live()]

            def on_stage(_kind, lv):
                counts.append(torch.broadcast_to(lv, (n,)).sum())
            env, live = self.apply_batch(batch, on_stage)
            counts = np.array([int(c) for c in counts], dtype=np.int64)
        else:
            env, live = self.apply_batch(batch)
        if live is not None:
            live = torch.broadcast_to(live, (n,))
        xp = TorchXP(batch.device)
        out = {name: ops.broadcast_value(n, *env[name], xp) for name in self.computed}
        return ColumnBatch(self.attach_columns(batch.columns, out), live,
                           nominal=batch.nominal), counts

    def run_live_np(self, batch: ColumnBatch) -> np.ndarray:
        """Host live mask of `batch` with the segment's stages applied (the grace
        join's probe prelude, where only the mask is consumed)."""
        _env, live = self.apply_batch(batch)
        if live is None:
            return np.ones(batch.capacity, dtype=np.bool_)
        return np.broadcast_to(to_numpy(live), (batch.capacity,))

    def _observe(self, tc, sink, counts, wall_ms: float):
        """A timed segment run's bookkeeping, the reference's: the wall histogram,
        the stats-sink row, and in a traced query one `segment` span under the
        operator span whose pull ran it (host wall time; no device sync)."""
        from galaxysql_tpu_torch.utils.metrics import SEGMENT_WALL_MS
        SEGMENT_WALL_MS.observe(wall_ms)
        if sink is not None and counts is not None:
            sink.append((counts, wall_ms))
        if tc is not None:
            from galaxysql_tpu_torch.utils import tracing as _tr
            attrs = {"compiled": False, "segment_id": self.segment_id}
            if counts is not None:
                attrs["rows_in"] = int(counts[0])
                attrs["rows_out"] = int(counts[-1])
            tc.add(f"segment:{self.chain}", kind="segment",
                   start_us=_tr.now_us() - int(wall_ms * 1000),
                   dur_us=wall_ms * 1000, **attrs)

    def _record_span(self, batch_in: ColumnBatch, batch_out: ColumnBatch,
                     wall_ms: float):
        from galaxysql_tpu_torch.utils.tracing import SEGMENT_TRACER, SegmentSpan
        SEGMENT_TRACER.record(SegmentSpan(
            segment_id=self.segment_id, chain=self.chain,
            rows_in=batch_in.num_live(), rows_out=batch_out.num_live(),
            compiled=False, wall_ms=wall_ms))


def _tracer_on() -> bool:
    from galaxysql_tpu_torch.utils.tracing import SEGMENT_TRACER
    return SEGMENT_TRACER.active


def _trace_ctx():
    """The thread's active TraceContext (span tracing), or None."""
    from galaxysql_tpu_torch.utils import tracing
    return tracing.current()


class FusedPipelineOp(ops.Operator):
    """Streaming operator applying one FusedSegment per batch, in place of a stack
    of FilterOp/ProjectOp instances."""

    def __init__(self, child: ops.Operator, segment: FusedSegment):
        self.child = child
        self.segment = segment

    def batches(self):
        it = self.child.batches()
        first = next(it, None)
        if first is None:
            return
        if self.segment.inert():
            # rf-only segment whose filters never published (grace-spilled or
            # oversized build, deactivated edge): pure passthrough
            yield first
            yield from it
            return
        yield self.segment.run_batch(first)
        for b in it:
            yield self.segment.run_batch(b)


def segment_for(node, min_stages: int = 1, filters_only: bool = False, rf=None,
                stop=None):
    """(base node, FusedSegment | None): a segment only when the chain above `node`
    has at least `min_stages` stages (and, with `filters_only`, no project stage:
    the join-probe case, where a project would change the column namespace the join
    gathers from).  `rf` (a RuntimeFilterManager) injects the base scan's planned
    runtime filters as ("rf", ...) prelude stages and marks the scan consumed, so
    the scan-level fallback (`plan/physical._wrap_scan_rf`) skips it.  `stop(n)`
    makes a streaming node a boundary (the port's filters that run rewritten over a
    cross join)."""
    stages, base = collapse_streaming_chain(node, stop)
    rf_stages = rf.stages_for(base) if rf is not None else []
    if rf_stages and rf.consumed(base):
        rf_stages = []
    all_stages = rf_stages + stages
    if len(all_stages) < min_stages:
        return node, None
    if filters_only and any(kind == "project" for kind, _ in all_stages):
        return node, None
    if rf_stages:
        rf.mark_consumed(base)
    return base, FusedSegment(all_stages)


def _streaming(cur, stop) -> bool:
    from galaxysql_tpu_torch.plan import logical as L
    return isinstance(cur, (L.Filter, L.Project)) and (stop is None or not stop(cur))


def chain_nodes(node, stop=None) -> List[Any]:
    """The logical Filter/Project nodes a segment built from `node` covers, in stage
    order (bottom-up): EXPLAIN ANALYZE attributes stage i's rows to node i."""
    out: List[Any] = []
    cur = node
    while _streaming(cur, stop):
        out.append(cur)
        cur = cur.child
    out.reverse()
    return out


def collapse_streaming_chain(node, stop=None) -> Tuple[List[Stage], Any]:
    """Maximal chain of streaming logical nodes above `node`'s first pipeline
    breaker: (bottom-up stages, base node)."""
    from galaxysql_tpu_torch.plan import logical as L
    rev: List[Stage] = []
    cur = node
    while _streaming(cur, stop):
        if isinstance(cur, L.Filter):
            rev.append(("filter", cur.cond))
        else:
            rev.append(("project", list(cur.exprs)))
        cur = cur.child
    rev.reverse()
    return rev, cur
