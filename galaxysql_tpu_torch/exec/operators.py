"""Physical operators over ColumnBatches (trimmed port of `galaxysql_tpu/exec/operators.py`).

Pull-model operators: streaming ones (`FilterOp`, `ProjectOp`) transform one batch at
a time; blocking ones (`HashAggOp` and `DistinctOp`, the `HashJoinOp` and `CrossJoinOp`
builds, `SortOp`, `WindowOp`) consume all input then produce.  Every hot loop is a torch formulation from `kernels/relational.py` on
the batch's device, and dynamic cardinality is handled by capacity buckets plus
overflow-doubling retries, exactly as in the reference.

The reference's `global_jit` program cache becomes `closure_cache`: eager PyTorch
compiles nothing, so the cache only spares rebuilding the expression closures of a
repeated query.  `batched_point_lookup` is the cross-session point lookup the batch
scheduler (`server/batch_scheduler.py`) flushes through.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import (Column, ColumnBatch, Dictionary, as_tensor,
                                             concat_batches, dictionary_translation,
                                             torch_dtype)
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import (ExprCompiler, TorchXP, _find_dictionary,
                                               _pow10, _signed_div_round, batch_env)
from galaxysql_tpu_torch.kernels import relational as K
from galaxysql_tpu_torch.storage.table_store import visible_rows
from galaxysql_tpu_torch.types import collation as _coll
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

MIN_BUCKET = 1024


def bucket_capacity(n: int) -> int:
    """Round up to a padding bucket: powers of two up to 64K, then quarter-steps
    {1, 1.25, 1.5, 1.75}x2^k (padding waste capped at 25%)."""
    c = MIN_BUCKET
    while c < n:
        c *= 2
    if c <= (1 << 16) or c == n:
        return c
    half = c // 2
    for q in (5, 6, 7):
        step = half + (half // 4) * (q - 4)
        if n <= step:
            return step
    return c


_CLOSURES: "collections.OrderedDict[Tuple, Any]" = collections.OrderedDict()
_CLOSURES_LOCK = threading.Lock()
_CLOSURES_LIMIT = 4096


def closure_cache(key: Tuple, builder):
    """Process-wide LRU of compiled expression closures, keyed semantically
    (expression keys, dictionary identities and sizes, device)."""
    with _CLOSURES_LOCK:
        f = _CLOSURES.get(key)
        if f is not None:
            _CLOSURES.move_to_end(key)
            return f
    f = builder()
    with _CLOSURES_LOCK:
        while len(_CLOSURES) >= _CLOSURES_LIMIT:
            _CLOSURES.popitem(last=False)
        _CLOSURES[key] = f
    return f


def _dict_sig(e: ir.Expr) -> Tuple:
    """(uid, len) of every dictionary reachable from the expression."""
    out = []
    for n in ir.walk(e):
        d = getattr(n, "dictionary", None)
        if d is not None:
            out.append((d.uid, len(d)))
    return tuple(out)


def expr_cache_key(e: ir.Expr) -> Tuple:
    return (e.key(), _dict_sig(e))


def broadcast_value(n: int, data, valid, xp):
    """Materialize a compiled (data, valid) pair to full row length (constants come
    back 0-d; data and valid broadcast independently)."""
    if not hasattr(data, "shape") or tuple(data.shape) == ():
        data = xp.broadcast_to(xp.asarray(data), (n,)).contiguous()
    if valid is not None and (not hasattr(valid, "shape") or tuple(valid.shape) == ()):
        valid = xp.broadcast_to(xp.asarray(valid), (n,)).contiguous()
    return data, valid


def _ranked(f, rank, device):
    """String key lane -> collation ranks of its codes (codes are assignment-ordered)."""
    r = as_tensor(rank, device)

    def run(env):
        d, v = f(env)
        return r[d.to(torch.int64)], v
    return run


def _needs_rank(e: ir.Expr) -> Optional[Dictionary]:
    d = _find_dictionary(e) if e.dtype.is_string else None
    if d is not None and len(d) and (not d.is_sorted or
                                     _coll.collation_of_expr(e) is not None):
        return d
    return None


@dataclasses.dataclass
class AggCall:
    kind: str                    # sum | count | avg | min | max | count_star
    arg: Optional[ir.Expr]       # None for count_star
    name: str
    distinct: bool = False

    @property
    def dtype(self) -> dt.DataType:
        if self.kind in ("count", "count_star"):
            return dt.BIGINT
        at = self.arg.dtype
        if self.kind == "sum":
            if at.clazz == dt.TypeClass.DECIMAL:
                return dt.decimal(18, at.scale)
            if at.clazz == dt.TypeClass.FLOAT:
                return dt.DOUBLE
            return dt.BIGINT
        if self.kind == "avg":
            if at.clazz == dt.TypeClass.DECIMAL:
                return dt.decimal(18, min(at.scale + 4, 8))
            return dt.DOUBLE
        return at  # min/max


class Operator:
    """Pull-model operator: iterate ColumnBatches."""

    def batches(self) -> Iterator[ColumnBatch]:
        raise NotImplementedError


class FilterOp(Operator):
    """WHERE: ANDs the predicate into the live mask (selection-vector style)."""

    def __init__(self, child: Operator, predicate: ir.Expr):
        self.child = child
        self.predicate = predicate

    def _compiled(self, device):
        key = ("filter", str(device), expr_cache_key(self.predicate))
        return closure_cache(key, lambda: ExprCompiler(TorchXP(device))
                             .compile_predicate(self.predicate))

    def batches(self) -> Iterator[ColumnBatch]:
        for b in self.child.batches():
            pred = self._compiled(b.device)
            yield ColumnBatch(b.columns, b.live_mask() & pred(batch_env(b)))


class ProjectOp(Operator):
    """SELECT expressions; preserves the live mask."""

    def __init__(self, child: Operator, exprs: Sequence[Tuple[str, ir.Expr]]):
        self.child = child
        self.exprs = list(exprs)

    def _compiled(self, device):
        key = ("project", str(device),
               tuple((n, expr_cache_key(e)) for n, e in self.exprs))

        def build():
            xp = TorchXP(device)
            comp = ExprCompiler(xp)
            fns = [(name, e, comp.compile(e)) for name, e in self.exprs]

            def run(batch: ColumnBatch) -> ColumnBatch:
                env = batch_env(batch)
                cols = {}
                n = batch.capacity
                for name, e, f in fns:
                    data, valid = broadcast_value(n, *f(env), xp)
                    cols[name] = Column(data, valid, e.dtype, _find_dictionary(e))
                return ColumnBatch(cols, batch.live)
            return run
        return closure_cache(key, build)

    def batches(self) -> Iterator[ColumnBatch]:
        for b in self.child.batches():
            yield self._compiled(b.device)(b)


class HashAggOp(Operator):
    """Grouped/global aggregation: one partial per input batch, then a merge.

    Partials stay on the device; a single partial is the result as is, several are
    concatenated and merged by the same kernels.  The reference's spill path is not
    part of the port."""

    DENSE_AGG_MAX_DOMAIN = 64
    MAX_GROUPS_CEILING = 1 << 24

    def __init__(self, child: Operator, group_exprs: Sequence[Tuple[str, ir.Expr]],
                 aggs: Sequence[AggCall], max_groups: int = 1 << 16):
        self.child = child
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.max_groups = max_groups

    def _partial_specs(self) -> Tuple[List[ir.Expr], List[Tuple[str, K.AggSpec]]]:
        """Decompose SQL aggs into kernel specs (avg -> sum + count)."""
        inputs: List[ir.Expr] = []
        index: Dict[Tuple, int] = {}

        def arg_ix(e: ir.Expr) -> int:
            k = e.key()
            if k not in index:
                index[k] = len(inputs)
                inputs.append(e)
            return index[k]

        lanes: List[Tuple[str, K.AggSpec]] = []
        for a in self.aggs:
            if a.kind == "count_star":
                lanes.append((a.name, K.AggSpec("count_star", -1)))
            elif a.kind == "count":
                lanes.append((a.name, K.AggSpec("count", arg_ix(a.arg))))
            elif a.kind == "sum":
                lanes.append((a.name, K.AggSpec("sum", arg_ix(a.arg))))
            elif a.kind == "avg":
                lanes.append((a.name + "$sum", K.AggSpec("sum", arg_ix(a.arg))))
                lanes.append((a.name + "$cnt", K.AggSpec("count", arg_ix(a.arg))))
            elif a.kind in ("min", "max"):
                lanes.append((a.name, K.AggSpec(a.kind, arg_ix(a.arg))))
            else:
                raise ValueError(a.kind)
        return inputs, lanes

    def _cache_key(self) -> Tuple:
        return (tuple((n, expr_cache_key(e)) for n, e in self.group_exprs),
                tuple((a.kind, a.name,
                       expr_cache_key(a.arg) if a.arg is not None else None)
                      for a in self.aggs))

    def _small_domains(self) -> Optional[List[int]]:
        """Static key domains if the dense-slot formulation applies, else None:
        every group key is a dictionary string or a boolean and the cross product
        (with a NULL slot per key) stays small.  No keys is domain 1."""
        domains: List[int] = []
        total = 1
        for _n, e in self.group_exprs:
            if e.dtype.clazz == dt.TypeClass.BOOL:
                dom = 2
            elif e.dtype.is_string:
                d = _find_dictionary(e)
                if d is None or len(d) == 0:
                    return None
                dom = len(d)
            else:
                return None
            domains.append(dom)
            total *= dom + 1
            if total > self.DENSE_AGG_MAX_DOMAIN:
                return None
        return domains

    def _partial_fn(self, max_groups: int, device):
        domains = self._small_domains()
        key = ("agg_partial", str(device), self._cache_key(), max_groups,
               tuple(domains) if domains is not None else None)

        def build():
            xp = TorchXP(device)
            comp = ExprCompiler(xp)
            gfns = [comp.compile(e) for _, e in self.group_exprs]
            inputs, lanes = self._partial_specs()
            ifns = []
            for e in inputs:
                f = comp.compile(e)
                # MIN/MAX on dictionary strings compare collation ranks, not codes;
                # _finalize maps ranks back to codes
                d_ = _needs_rank(e)
                if d_ is not None:
                    f = _ranked(f, _coll.sort_rank_array(e, d_), device)
                ifns.append(f)
            specs = tuple(s for _, s in lanes)

            def run(batch: ColumnBatch):
                env = batch_env(batch)
                live = batch.live_mask()
                n = batch.capacity
                keys = [broadcast_value(n, *f(env), xp) for f in gfns]
                ins = [broadcast_value(n, *f(env), xp) for f in ifns]
                return K.groupby(keys, ins, specs, live, max_groups, domains)
            return run
        return closure_cache(key, build)

    def batches(self) -> Iterator[ColumnBatch]:
        inputs, lanes = self._partial_specs()
        lane_names = tuple(name for name, _ in lanes)
        mg = self.max_groups
        # capacity under-estimates retry the whole aggregation with doubled output
        # capacity (children re-iterate; scans re-read from the device cache)
        while True:
            partials: List[K.GroupByResult] = []
            overflowed = False
            for b in self.child.batches():
                r = self._partial_fn(mg, b.device)(b)
                if bool(r.overflow):
                    overflowed = True
                    break
                partials.append(r)
            if not overflowed:
                break
            mg *= 2
            if mg > self.MAX_GROUPS_CEILING:
                raise RuntimeError("group cardinality exceeds engine ceiling")
        out = self._merge(partials, mg, lanes, lane_names)
        if out is not None:
            yield out

    def _merge(self, partials, mg, lanes, lane_names) -> Optional[ColumnBatch]:
        merge_specs = []
        for (_name, spec) in lanes:
            if spec.kind in ("count", "count_star", "sum"):
                merge_specs.append(K.AggSpec("sum", len(merge_specs)))
            else:
                merge_specs.append(K.AggSpec(spec.kind, len(merge_specs)))
        merge_specs = tuple(merge_specs)

        if not partials:
            if self.group_exprs:
                return None  # grouped agg over empty input: no rows at all
            dev = torch.device("cpu")
            empty = [(torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.zeros(1, dtype=torch.bool, device=dev)) for _ in lane_names]
            r = K.GroupByResult(tuple(), tuple(empty),
                                torch.zeros(1, dtype=torch.bool, device=dev), 0, False)
            return self._finalize(r, lane_names)
        if len(partials) == 1:
            # single partial (the common full-table-scan case): it IS the result
            return self._finalize(partials[0], lane_names)

        def cat(lanes_of):
            datas = [d for d, _ in lanes_of]
            if all(v is None for _, v in lanes_of):
                return torch.cat(datas), None
            return torch.cat(datas), torch.cat(
                [torch.ones(d.shape[0], dtype=torch.bool, device=d.device) if v is None
                 else v for d, v in lanes_of])

        key_lanes = [cat([p.keys[i] for p in partials])
                     for i in range(len(self.group_exprs))]
        agg_lanes = [cat([p.aggs[j] for p in partials]) for j in range(len(lane_names))]
        live = torch.cat([p.live for p in partials])
        while True:
            r = K.groupby(key_lanes, agg_lanes, merge_specs, live, mg)
            if not bool(r.overflow):
                return self._finalize(r, lane_names)
            mg *= 2  # distinct groups across partials can exceed one partial's cap
            if mg > self.MAX_GROUPS_CEILING:
                raise RuntimeError("group cardinality exceeds engine ceiling")

    def _finalize(self, r: K.GroupByResult, lane_names: Tuple[str, ...]) -> ColumnBatch:
        """Output batch on the partials' device; avg = sum/count with MySQL decimal
        scale."""
        cols: Dict[str, Column] = {}
        for i, (name, ge) in enumerate(self.group_exprs):
            d, v = r.keys[i]
            cols[name] = Column(d, v, ge.dtype, _find_dictionary(ge))
        lanes = {n: r.aggs[j] for j, n in enumerate(lane_names)}
        groups_live = r.live
        device = groups_live.device
        xp = TorchXP(device)
        if not self.group_exprs and groups_live.shape[0]:
            # global aggregation always yields exactly one row
            groups_live = torch.zeros_like(groups_live)
            groups_live[0] = True
        for a in self.aggs:
            if a.kind == "avg":
                s, _sv = lanes[a.name + "$sum"]
                c, _ = lanes[a.name + "$cnt"]
                at = a.arg.dtype
                rt = a.dtype
                safe = torch.where(c == 0, torch.ones_like(c), c)
                if rt.clazz == dt.TypeClass.DECIMAL:
                    shift = rt.scale - (at.scale if at.clazz == dt.TypeClass.DECIMAL else 0)
                    num = s.to(torch.int64) * _pow10(max(shift, 0))
                    data = _signed_div_round(xp, num, safe)
                else:
                    data = (s.to(torch.float64) / safe).to(torch.float32)
                cols[a.name] = Column(data, c > 0, rt, None)
            else:
                d, v = lanes[a.name]
                rt = a.dtype
                if a.kind == "sum" and rt.clazz == dt.TypeClass.FLOAT:
                    d = d.to(torch.float32)
                if a.kind in ("count", "count_star"):
                    v = None  # COUNT over an empty group is 0, not NULL
                dict_ = _find_dictionary(a.arg) if (a.kind in ("min", "max") and
                                                    a.arg is not None and
                                                    a.arg.dtype.is_string) else None
                if dict_ is not None and _needs_rank(a.arg) is not None:
                    # min/max ran on collation ranks; map winners back to codes
                    order = as_tensor(_coll.sort_order_array(a.arg, dict_), device)
                    d = order[torch.clamp(d, 0, len(order) - 1).to(torch.int64)]
                cols[a.name] = Column(d, v, rt, dict_)
        return ColumnBatch(cols, groups_live)


class HashJoinOp(Operator):
    """Equi hash join: build side fully materialized, probe side streamed.

    join_type: inner | left | semi | anti (probe side is the outer/left side).  The
    build side is compacted and padded to a capacity bucket, a slot CSR is built over
    it on its device (`relational._device_csr`), and every probe batch enumerates its
    verified pairs through `relational.hash_join_probe_csr`."""

    BLOOM_MAX_BUILD = 1 << 20
    BLOOM_DEVICE_MAX_BITS = 1 << 24

    def __init__(self, build: Operator, probe: Operator,
                 build_keys: Sequence[ir.Expr], probe_keys: Sequence[ir.Expr],
                 join_type: str = "inner",
                 residual: Optional[ir.Expr] = None,
                 build_schema: Optional[Dict[str, Tuple[dt.DataType,
                                                        Optional[Dictionary]]]] = None,
                 enable_bloom: bool = True):
        assert join_type in ("inner", "left", "semi", "anti")
        self.build, self.probe = build, probe
        self.build_keys, self.probe_keys = list(build_keys), list(probe_keys)
        self.join_type = join_type
        self.residual = residual
        # build-side output schema, needed to null-extend when the build side is EMPTY
        self.build_schema = build_schema
        self.enable_bloom = enable_bloom  # NO_BLOOM hint disables the probe bloom

    def _key_compilers(self, device):
        """Compile key pairs into a common lane domain.  String keys from different
        dictionaries translate probe codes into the build dictionary's code space;
        absent strings map to -1, which matches no build code."""
        key = ("join_keys", str(device),
               tuple(expr_cache_key(e) for e in self.build_keys),
               tuple(expr_cache_key(e) for e in self.probe_keys))

        def build():
            comp = ExprCompiler(TorchXP(device))
            bk, pk = [], []
            for be, pe in zip(self.build_keys, self.probe_keys):
                bf, pf = comp.compile(be), comp.compile(pe)
                if be.dtype.is_string and pe.dtype.is_string:
                    db = _find_dictionary(be)
                    dp = _find_dictionary(pe)
                    if db is not None and dp is not None and db is not dp:
                        trans = as_tensor(dictionary_translation(db, dp), device)

                        def translated(env, _pf=pf, _t=trans):
                            d, v = _pf(env)
                            return _t[d.to(torch.int64)], v
                        pf = translated
                bk.append(bf)
                pk.append(pf)
            return bk, pk
        return closure_cache(key, build)

    @staticmethod
    def _lanes(fns, batch: ColumnBatch, xp):
        env = batch_env(batch)
        return [broadcast_value(batch.capacity, *f(env), xp) for f in fns]

    def _build_bloom(self, build_batch: ColumnBatch, pf, xp):
        """Byte-plane bloom over the single build key (one flag byte per bloom bit);
        probe rows that cannot match are masked out before pair enumeration.
        Exact for inner/semi joins: bloom-negative rows are provably unmatched."""
        n_build = build_batch.num_live() if build_batch.capacity else 0
        if n_build == 0 or n_build > self.BLOOM_MAX_BUILD:
            return None
        nbits = 1 << max(12, int(n_build * 16 - 1).bit_length())
        nbits = min(nbits, self.BLOOM_DEVICE_MAX_BITS)
        bk, _ = self._key_compilers(build_batch.device)

        def bits(d):
            h = K._mix64(d.to(torch.int64))
            return ((h & (nbits - 1)).to(torch.int64),
                    (K.lsr(h, 32) & (nbits - 1)).to(torch.int64))

        (d, v), = self._lanes(bk[:1], build_batch, xp)
        live = build_batch.live_mask()
        if v is not None:
            live = live & v
        b1, b2 = bits(d)
        flags = torch.zeros(nbits + 1, dtype=torch.uint8, device=d.device)
        flags[torch.where(live, b1, torch.full_like(b1, nbits))] = 1
        flags[torch.where(live, b2, torch.full_like(b2, nbits))] = 1
        flags = flags[:nbits]

        def apply(batch: ColumnBatch) -> ColumnBatch:
            pd, pv = broadcast_value(batch.capacity, *pf(batch_env(batch)), xp)
            q1, q2 = bits(pd)
            live2 = batch.live_mask() & ((flags[q1] & flags[q2]) > 0)
            if pv is not None:
                live2 = live2 & pv  # NULL keys never match an inner/semi join
            return ColumnBatch(batch.columns, live2)
        return apply

    def _empty_build_batches(self) -> Iterator[ColumnBatch]:
        # empty build: inner/semi yield nothing; anti passes probe rows through;
        # left null-extends using the declared build schema
        for pb in self.probe.batches():
            if self.join_type in ("inner", "semi"):
                continue
            if self.join_type == "anti":
                yield pb
                continue
            dev = pb.device
            ncols: Dict[str, Column] = {}
            for name, (typ, d_) in (self.build_schema or {}).items():
                z = torch.zeros(pb.capacity, dtype=torch_dtype(typ.lane), device=dev)
                ncols[name] = Column(z, torch.zeros(pb.capacity, dtype=torch.bool,
                                                    device=dev), typ, d_)
            ncols.update(pb.columns)
            yield ColumnBatch(ncols, pb.live)

    def batches(self) -> Iterator[ColumnBatch]:
        build_batch = concat_batches(list(self.build.batches()))
        if build_batch.capacity == 0:
            yield from self._empty_build_batches()
            return
        # every build-side cost (CSR slot count, verify gathers) scales with
        # capacity, and a build gathered out of an upstream join is mostly dead rows
        build_batch = build_batch.pad_to(bucket_capacity(build_batch.capacity))
        yield from self._device_probe(build_batch)

    @staticmethod
    def _gather(batch: ColumnBatch, idx) -> Dict[str, Column]:
        cols = {}
        for name, c in batch.columns.items():
            cols[name] = Column(c.data[idx], c.valid[idx] if c.valid is not None else None,
                                c.dtype, c.dictionary)
        return cols

    def _device_probe(self, build_batch: ColumnBatch) -> Iterator[ColumnBatch]:
        device = build_batch.device
        xp = TorchXP(device)
        bk, pk = self._key_compilers(device)
        residual_pred = (ExprCompiler(xp).compile_predicate(self.residual)
                         if self.residual is not None else None)
        bloom_filter = None
        if self.enable_bloom and self.join_type in ("inner", "semi") and \
                len(self.build_keys) == 1:
            bloom_filter = self._build_bloom(build_batch, pk[0], xp)

        bkeys = self._lanes(bk, build_batch, xp)
        b_live = build_batch.live_mask()
        perm, starts, counts, M = K._device_csr(bkeys, b_live, build_batch.capacity)
        for pb in self.probe.batches():
            if pb.capacity == 0:
                continue  # no probe rows: nothing matches, nothing to preserve
            if bloom_filter is not None:
                pb = bloom_filter(pb)
            n_live = pb.num_live()
            cap = bucket_capacity(max(n_live * 2, MIN_BUCKET))
            pkeys = self._lanes(pk, pb, xp)
            while True:
                pairs = K.hash_join_probe_csr(bkeys, pkeys, b_live, pb.live_mask(),
                                              perm, starts, counts, M, cap)
                if not pairs.overflow:
                    break
                cap *= 2
            if residual_pred is None and self.join_type in ("semi", "anti"):
                matched = pairs.probe_matched
                live = pb.live_mask() & (matched if self.join_type == "semi" else ~matched)
                yield ColumnBatch(pb.columns, live)
                continue
            bcols = self._gather(build_batch, pairs.build_idx)
            pcols = self._gather(pb, pairs.probe_idx)
            out = ColumnBatch({**bcols, **pcols}, pairs.live)
            if residual_pred is not None:
                mask = residual_pred(batch_env(out))
                out = ColumnBatch(out.columns, out.live_mask() & mask)
            if self.join_type in ("left", "semi", "anti"):
                # matched flags must reflect pairs that ALSO passed the residual
                matched = K.probe_matched_from(out.live_mask(), pairs.probe_starts,
                                               pairs.probe_offsets)
            if self.join_type in ("semi", "anti"):
                live = pb.live_mask() & (matched if self.join_type == "semi" else ~matched)
                yield ColumnBatch(pb.columns, live)
                continue
            yield out
            if self.join_type == "left":
                # null-extended unmatched probe rows
                unmatched = pb.live_mask() & ~matched
                ncols = {}
                for name, c in build_batch.columns.items():
                    ncols[name] = Column(
                        torch.zeros(pb.capacity, dtype=c.data.dtype, device=device),
                        torch.zeros(pb.capacity, dtype=torch.bool, device=device),
                        c.dtype, c.dictionary)
                ncols.update(pb.columns)
                yield ColumnBatch(ncols, unmatched)


class CrossJoinOp(Operator):
    """Cartesian product with a SMALL materialized build side.

    Exists for the uncorrelated-scalar-subquery pattern (a 1-row aggregate
    cross-joined into the outer query: TPC-H Q11/Q15/Q22); guarded against large
    builds.  Every lane stays on the batches' device."""

    MAX_CELLS = 1 << 26

    def __init__(self, build: Operator, probe: Operator, scalar: bool = False,
                 build_schema=None):
        self.build = build
        self.probe = probe
        # scalar subquery semantics: empty build NULL-extends, >1 rows errors
        self.scalar = scalar
        self.build_schema = build_schema

    def batches(self) -> Iterator[ColumnBatch]:
        build = concat_batches(list(self.build.batches()))
        nb = build.num_live() if build.capacity else 0
        if self.scalar and nb > 1:
            raise errors.TddlError("Subquery returns more than 1 row")
        if self.scalar and nb == 0:
            for pb in self.probe.batches():
                ncols = {}
                for name, (typ, d_) in (self.build_schema or {}).items():
                    z = torch.zeros(pb.capacity, dtype=torch_dtype(typ.lane),
                                    device=pb.device)
                    ncols[name] = Column(z, torch.zeros(pb.capacity, dtype=torch.bool,
                                                        device=pb.device), typ, d_)
                ncols.update(pb.columns)
                yield ColumnBatch(ncols, pb.live)
            return
        build = build.compact().pad_to(build.num_live()) if build.capacity else build
        nb = build.capacity
        for pb in self.probe.batches():
            if nb == 0:
                return  # empty build: cross join is empty
            if nb == 1:
                cols = {}
                for name, c in build.columns.items():
                    data = c.data[:1].expand(pb.capacity).contiguous()
                    valid = (c.valid[:1].expand(pb.capacity).contiguous()
                             if c.valid is not None else None)
                    cols[name] = Column(data, valid, c.dtype, c.dictionary)
                cols.update(pb.columns)
                yield ColumnBatch(cols, pb.live)
                continue
            if nb * pb.capacity > self.MAX_CELLS:
                raise RuntimeError("cross join too large")
            # expand: probe rows repeated nb times each
            pidx = torch.repeat_interleave(
                torch.arange(pb.capacity, device=pb.device), nb)
            bidx = torch.arange(nb, device=pb.device).repeat(pb.capacity)
            cols = {}
            for name, c in build.columns.items():
                cols[name] = Column(c.data[bidx],
                                    c.valid[bidx] if c.valid is not None else None,
                                    c.dtype, c.dictionary)
            for name, c in pb.columns.items():
                cols[name] = Column(c.data[pidx],
                                    c.valid[pidx] if c.valid is not None else None,
                                    c.dtype, c.dictionary)
            live = pb.live_mask()[pidx] & build.live_mask()[bidx]
            yield ColumnBatch(cols, live)


class SortOp(Operator):
    """ORDER BY [LIMIT]: in-memory sort on the batch's device.  The reference's
    external sorted-run merge is not part of the port."""

    def __init__(self, child: Operator,
                 keys: Sequence[Tuple[ir.Expr, bool]],  # (expr, descending)
                 limit: Optional[int] = None, offset: int = 0):
        self.child = child
        self.keys = list(keys)
        self.limit = limit
        self.offset = offset

    def _compiled(self, device):
        key = ("sort", str(device),
               tuple((expr_cache_key(e), desc, _coll.collation_of_expr(e))
                     for e, desc in self.keys), self.limit, self.offset)

        def build():
            # bind to locals: the cached closure must not capture self (it would pin
            # the whole child operator tree in the process-global cache)
            limit, offset = self.limit, self.offset
            xp = TorchXP(device)
            comp = ExprCompiler(xp)
            kfns = []
            for e, desc in self.keys:
                f = comp.compile(e)
                d_ = _needs_rank(e)
                if d_ is not None:
                    # dictionary codes are assignment-ordered, not collation-ordered:
                    # sort by the host-computed rank of each code
                    f = _ranked(f, _coll.sort_rank_array(e, d_), device)
                kfns.append((f, desc))

            def run(batch: ColumnBatch) -> ColumnBatch:
                env = batch_env(batch)
                n = batch.capacity
                keys = []
                for f, desc in kfns:
                    d, v = broadcast_value(n, *f(env), xp)
                    keys.append((d, v, desc, not desc))  # NULLs first asc, last desc
                order = K.sort_indices(keys, batch.live_mask())
                cols = {}
                for name, c in batch.columns.items():
                    cols[name] = Column(c.data[order],
                                        c.valid[order] if c.valid is not None else None,
                                        c.dtype, c.dictionary)
                live = batch.live_mask()[order]
                if limit is not None:
                    live = K.limit_mask(live, offset, limit)
                elif offset:
                    live = K.limit_mask(live, offset, batch.capacity)
                return ColumnBatch(cols, live)
            return run
        return closure_cache(key, build)

    def batches(self) -> Iterator[ColumnBatch]:
        merged = concat_batches(list(self.child.batches()))
        if merged.capacity == 0:
            yield merged
            return
        padded = merged.pad_to(bucket_capacity(merged.capacity))
        yield self._compiled(padded.device)(padded)


class LimitOp(Operator):
    def __init__(self, child: Operator, limit: int, offset: int = 0):
        self.child = child
        self.limit = limit
        self.offset = offset

    def batches(self) -> Iterator[ColumnBatch]:
        remaining_skip = self.offset
        remaining = self.limit
        for b in self.child.batches():
            if remaining <= 0:
                break
            n = b.num_live()
            if n == 0:
                continue
            take_mask = K.limit_mask(b.live_mask(), remaining_skip, remaining)
            taken = min(max(n - remaining_skip, 0), remaining)
            remaining_skip = max(remaining_skip - n, 0)
            remaining -= taken
            yield ColumnBatch(b.columns, take_mask)


class DistinctOp(HashAggOp):
    """SELECT DISTINCT / UNION DISTINCT: a grouped aggregation with no aggregates."""

    def __init__(self, child: Operator, exprs: Sequence[Tuple[str, ir.Expr]],
                 max_groups: int = 1 << 16):
        super().__init__(child, exprs, [], max_groups)


class WindowOp(Operator):
    """Window functions: materialize, sort by (partition, order), scan-based frames
    (`relational.window_eval`).

    Output rows come back in window-sort order (SQL imposes no order without an outer
    ORDER BY); all payload columns are gathered through the same permutation."""

    def __init__(self, child: Operator, partitions, orders, calls, out_schema=None):
        self.child = child
        self.partitions = list(partitions)   # [ir.Expr]
        self.orders = list(orders)           # [(ir.Expr, desc)]
        self.calls = list(calls)             # [L.WindowCall]
        # [(id, DataType, Dictionary)]: shapes an EMPTY result
        self.out_schema = out_schema

    def _specs(self):
        inputs: List[ir.Expr] = []
        index: Dict[Tuple, int] = {}

        def arg_ix(e):
            k = expr_cache_key(e)
            if k not in index:
                index[k] = len(inputs)
                inputs.append(e)
            return index[k]

        lanes = []  # (lane_name, WindowSpec)
        for c in self.calls:
            frame = c.frame
            if c.kind in ("row_number", "rank", "dense_rank"):
                lanes.append((c.out_id, K.WindowSpec(c.kind, -1, 0, frame)))
            elif c.kind == "avg":
                ix = arg_ix(c.arg)
                lanes.append((c.out_id + "$sum", K.WindowSpec("sum", ix, 0, frame)))
                lanes.append((c.out_id + "$cnt", K.WindowSpec("count", ix, 0, frame)))
            else:
                lanes.append((c.out_id,
                              K.WindowSpec(c.kind, arg_ix(c.arg), c.offset, frame)))
        return inputs, lanes

    def batches(self) -> Iterator[ColumnBatch]:
        merged = concat_batches(list(self.child.batches()))
        if merged.capacity == 0:
            cols = dict(merged.columns)
            for fid, typ, dic in (self.out_schema or []):
                if fid not in cols:
                    cols[fid] = Column(torch.zeros(0, dtype=torch_dtype(typ.lane)),
                                       None, typ, dic)
            yield ColumnBatch(cols, None)
            return
        padded = merged.pad_to(bucket_capacity(merged.capacity))
        inputs, lanes = self._specs()
        specs = tuple(s for _, s in lanes)
        device = padded.device
        key = ("window", str(device),
               tuple(expr_cache_key(p) for p in self.partitions),
               tuple((expr_cache_key(e), d) for e, d in self.orders),
               tuple(expr_cache_key(e) for e in inputs), specs)

        def build():
            xp = TorchXP(device)
            comp = ExprCompiler(xp)
            pfns = [comp.compile(p) for p in self.partitions]
            ofns = [(comp.compile(e), d) for e, d in self.orders]
            ifns = [comp.compile(e) for e in inputs]

            def run(batch: ColumnBatch):
                env = batch_env(batch)
                n = batch.capacity
                pk = [broadcast_value(n, *f(env), xp) for f in pfns]
                ok = []
                for f, desc in ofns:
                    d, v = broadcast_value(n, *f(env), xp)
                    ok.append((d, v, desc, not desc))
                ins = [broadcast_value(n, *f(env), xp) for f in ifns]
                order, live_s, outs = K.window_eval(pk, ok, ins, specs,
                                                    batch.live_mask())
                cols = {}
                for name, c in batch.columns.items():
                    cols[name] = Column(c.data[order],
                                        c.valid[order] if c.valid is not None else None,
                                        c.dtype, c.dictionary)
                return cols, live_s, outs
            return run

        cols, live_s, outs = closure_cache(key, build)(padded)
        yield self.finalize_calls(cols, live_s, outs, lanes)

    def finalize_calls(self, cols, live_s, outs, lanes) -> ColumnBatch:
        """Attach the window-call outputs to the permuted payload columns on their
        device; avg = sum/count with MySQL decimal scale."""
        cols = dict(cols)
        lane_map = {name: outs[i] for i, (name, _) in enumerate(lanes)}
        for c in self.calls:
            rt = c.dtype
            if c.kind == "avg":
                s, _sv = lane_map[c.out_id + "$sum"]
                cnt, _ = lane_map[c.out_id + "$cnt"]
                safe = torch.where(cnt == 0, torch.ones_like(cnt), cnt)
                at = c.arg.dtype
                if rt.clazz == dt.TypeClass.DECIMAL:
                    shift = rt.scale - (at.scale if at.clazz == dt.TypeClass.DECIMAL
                                        else 0)
                    data = _signed_div_round(TorchXP(s.device), s.to(torch.int64)
                                             * _pow10(max(shift, 0)), safe)
                else:
                    data = (s.to(torch.float64) / safe).to(torch.float32)
                cols[c.out_id] = Column(data, cnt > 0, rt, None)
            else:
                d, v = lane_map[c.out_id]
                if c.kind == "sum" and rt.clazz == dt.TypeClass.FLOAT:
                    d = d.to(torch.float32)
                dic = _find_dictionary(c.arg) if (c.arg is not None and
                                                  c.arg.dtype.is_string) else None
                cols[c.out_id] = Column(d, v, rt, dic)
        return ColumnBatch(cols, live_s)


# -- cross-session batched point lookup (server/batch_scheduler.py) -----------
#
# B parameter keys from concurrent sessions stack into ONE device program per
# partition instead of B separate index probes.  The key batch is padded to a
# static bucket (`_BATCH_KEY_BUCKETS`) and the sorted lanes to the capacity ladder,
# as in the reference, so the device artifacts of one partition version serve every
# flush.

_BATCH_KEY_BUCKETS = (1, 4, 16, 64, 256, 1024)
BATCH_MAX_KEYS = _BATCH_KEY_BUCKETS[-1]
BATCH_MAXDUP = 8  # in-program cap on physical versions per key (overflow -> host)


def batch_key_bucket(n: int) -> int:
    """Smallest static key-batch bucket holding n keys."""
    for b in _BATCH_KEY_BUCKETS:
        if n <= b:
            return b
    return BATCH_MAX_KEYS


def _lane_pad_value(dtype: np.dtype):
    """A sort-order-maximal pad for sorted key lanes (pads never match a real
    searchsorted window because their MVCC stamps mark them dead anyway)."""
    if np.issubdtype(dtype, np.floating):
        return np.inf
    return np.iinfo(dtype).max


def _batched_point_program(skeys: torch.Tensor, sbegin: torch.Tensor,
                           send: torch.Tensor, keys: torch.Tensor, snap: int,
                           txn: int, maxdup: int = BATCH_MAXDUP
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B keys against a capacity-padded sorted key lane, on the lanes' device.

    Inputs:
      skeys[cap]  sorted key lane, padded with the dtype max
      sbegin[cap] begin_ts permuted to sorted order; NULL-key rows and pads
                  carry -1 (never visible)
      send[cap]   end_ts permuted to sorted order, pads 0 (dead)
      keys[B]     the stacked parameter keys (pad slots ignored by the host)
    Returns (pos[B, maxdup], overflow[B]): visible sorted-domain positions (-1 =
    none) in ascending row order per key, and a per-key flag when the equal-key
    window exceeded maxdup (the host resolves that key alone)."""
    cap = skeys.shape[0]
    lo = torch.searchsorted(skeys, keys, side="left")
    hi = torch.searchsorted(skeys, keys, side="right")
    pos = lo[:, None] + torch.arange(maxdup, device=skeys.device)[None, :]
    in_rng = pos < hi[:, None]
    posc = torch.clamp(pos, max=cap - 1)
    b = sbegin[posc]
    e = send[posc]
    # the visibility rule of `table_store.visible_rows`: committed-and-past-snapshot
    # insert, minus committed-and-past-snapshot delete, plus own provisional
    ins = ((b >= 0) & (b <= snap)) | (b == -txn)
    dele = ((e >= 0) & (e <= snap)) | (e == -txn)
    vis = in_rng & ins & ~dele
    return torch.where(vis, posc, torch.full_like(posc, -1)), (hi - lo) > maxdup


def _tail_windows(lane, n0: int, n: int, keys):
    """Sorted probe of the unsorted appended tail rows [n0, n): returns
    (torder, tlo, thi) — torder[tlo[i]:thi[i]] + n0 are key i's candidate
    row ids, in ascending row order (stable argsort).  Shared by the host
    and device batched-point paths so their tail handling stays
    bit-identical."""
    tail = lane[n0:n]
    torder = np.argsort(tail, kind="stable")
    tsorted = tail[torder]
    tlo = np.searchsorted(tsorted, keys, side="left")
    thi = np.searchsorted(tsorted, keys, side="right")
    return torder, tlo, thi


def _host_batched_point(part, col: str, lane_vals, snap: int, txn_id: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """CPU formulation of the batched point lookup: one vectorized numpy sweep over
    the sorted key index for ALL keys.  Caller holds `part.lock`.  Bit-identical
    CSR to the device program path."""
    k = len(lane_vals)
    n = part.num_rows
    lane = part.lanes[col]
    valid = part.valid[col]
    begin, end = part.begin_ts, part.end_ts
    n0, perm, skeys = part.key_index(col)
    keys = np.asarray(lane_vals).astype(lane.dtype)
    lo = np.searchsorted(skeys, keys, side="left")
    hi = np.searchsorted(skeys, keys, side="right")
    if n > n0:
        # unsorted appended tail: extend each key's candidate set
        torder, tlo, thi = _tail_windows(lane, n0, n, keys)
    else:
        tlo = thi = np.zeros(k, dtype=np.int64)
    reps = (hi - lo) + (thi - tlo)
    total = int(reps.sum())
    offsets = np.zeros(k + 1, dtype=np.int64)
    if total == 0:
        return np.zeros(0, dtype=np.int64), offsets
    # within a key, index-window ids (ascending rows) come first, tail ids
    # (all >= n0) after — exactly key_candidates' ordering
    per_key = []
    for i in range(k):
        ids = perm[lo[i]:hi[i]]
        if thi[i] > tlo[i]:
            tids = torder[tlo[i]:thi[i]] + n0
            ids = np.concatenate([ids, tids]) if ids.size else tids
        per_key.append(ids)
    flat = np.concatenate(per_key)
    keep = valid[flat] & visible_rows(begin[flat], end[flat], snap, txn_id)
    key_of = np.repeat(np.arange(k), reps)[keep]
    np.cumsum(np.bincount(key_of, minlength=k), out=offsets[1:])
    return flat[keep], offsets


def batched_point_lookup(store, pid: int, part, col: str, version: int,
                         lane_vals, snap: int, txn_id: int = 0,
                         device_cache=None, force_device: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Visible row ids of `col == v` for a stack of keys against one partition.

    Returns CSR (ids, offsets): ids[offsets[i]:offsets[i+1]] are key i's matching
    row ids, ascending — bit-identical to the sequential key_candidates + validity
    + visibility path.  The route follows the device of `device_cache` (the
    instance's): on a CUDA device the torch program `_batched_point_program` runs on
    the card, always; on the CPU `_host_batched_point` sweeps the index in numpy,
    unless `force_device` asks for the torch program on CPU tensors.  The
    capacity-padded sorted keys and permuted MVCC stamps are version-keyed in
    `device_cache` (no cache: built per call on the CPU), so steady-state flushes
    ship only the B keys; the unsorted appended tail and >BATCH_MAXDUP version
    pileups are probed on the host per flush."""
    device = device_cache.device if device_cache is not None else torch.device("cpu")
    k = len(lane_vals)
    with part.lock:
        if device.type == "cpu" and not force_device:
            return _host_batched_point(part, col, lane_vals, snap, txn_id)
        n = part.num_rows
        lane = part.lanes[col]
        valid = part.valid[col]
        begin, end = part.begin_ts, part.end_ts
        n0, perm, skeys = part.key_index(col)
        cap = bucket_capacity(max(n0, 1))
        B = batch_key_bucket(k)
        pad = _lane_pad_value(lane.dtype)
        keys = np.full(B, pad, dtype=lane.dtype)
        keys[:k] = np.asarray(lane_vals).astype(lane.dtype)

        def _pad(arr, fill):
            if arr.shape[0] == cap:
                return arr
            out = np.full(cap, fill, dtype=arr.dtype)
            out[:arr.shape[0]] = arr
            return out

        def build_keys():
            return _pad(skeys, pad)

        def build_begin():
            # NULL key slots fold into the begin stamp (-1 = never visible):
            # the sequential path's part.valid[col] filter, one array early
            return _pad(np.where(valid[:n0][perm], begin[:n0][perm],
                                 np.int64(-1)), np.int64(-1))

        def build_end():
            return _pad(end[:n0][perm], np.int64(0))

        if device_cache is not None:
            # the cached artifacts are materializations of THIS sorted-index
            # build, so the key carries the index identity (lane_gen, n0) as
            # well as the table version: key_index() can rebuild with a larger
            # n0 within one version, and a (version, cap)-only hit would then
            # map stale sorted positions through the fresh perm
            sig = f"{col}::{part.lane_gen}.{n0}"
            dk = device_cache.get_lane_built(store, pid, f"bp_keys::{sig}",
                                             version, cap, build_keys)
            db = device_cache.get_lane_built(store, pid, f"bp_begin::{sig}",
                                             version, cap, build_begin)
            de = device_cache.get_lane_built(store, pid, f"bp_end::{sig}",
                                             version, cap, build_end)
        else:
            dk, db, de = (as_tensor(build_keys(), device),
                          as_tensor(build_begin(), device),
                          as_tensor(build_end(), device))
        pos, overflow = _batched_point_program(dk, db, de, as_tensor(keys, device),
                                               int(snap), int(txn_id))
        # one device-to-host copy for both outputs
        out = torch.cat([pos, overflow[:, None].to(pos.dtype)], dim=1).cpu().numpy()[:k]
        pos, overflow = out[:, :BATCH_MAXDUP], out[:, BATCH_MAXDUP] != 0

        # fast path: no appended tail, no version-pileup overflow — flatten
        # the position matrix in one shot (row-major keeps per-key ascending)
        mask = pos >= 0
        counts = mask.sum(axis=1)
        if n == n0 and not overflow.any():
            offsets = np.zeros(k + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            return perm[pos[mask]], offsets

        per_key: List[np.ndarray] = [perm[row[row >= 0]] for row in pos]
        if n > n0:
            # unsorted appended tail: one vectorized sorted probe for all keys
            torder, tlo, thi = _tail_windows(lane, n0, n, keys[:k])
            for i in np.nonzero(thi > tlo)[0]:
                tids = torder[tlo[i]:thi[i]] + n0
                tids = tids[valid[tids] & visible_rows(begin[tids], end[tids],
                                                       snap, txn_id)]
                if tids.size:
                    per_key[i] = np.concatenate([per_key[i], tids]) \
                        if per_key[i].size else tids
        for i in np.nonzero(overflow)[0]:
            # >BATCH_MAXDUP physical versions: exact host probe for this key
            per_key[i] = part.key_rows(col, lane_vals[i], snap, txn_id)
        offsets = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(np.asarray([a.size for a in per_key]), out=offsets[1:])
        flat = (np.concatenate(per_key) if offsets[-1]
                else np.zeros(0, dtype=np.int64))
        return flat, offsets


def run_to_batch(op: Operator) -> ColumnBatch:
    """Drain an operator tree into a single compacted batch (on its device)."""
    return concat_batches(list(op.batches()))
