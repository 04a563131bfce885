"""Core relational kernels over fixed-shape torch tensors.

Counterpart of `galaxysql_tpu/kernels/relational.py`.  The reference picks a formulation
per backend (`prefer_scatter`): hash and scatter on XLA:CPU, sort and matmul on a TPU.
Scatters and atomics are cheap on a GPU, so the port runs the scatter branch on every
device by default, and runs the reference's accelerator branch inside a
`formulation_scope("sort")` of the calling thread (from Python only: no hint, parameter
or environment variable reaches it).  The choice is read each time a function runs.

- group-by: small static key domains (dictionary strings, booleans, global
  aggregation) take `scatter_groupby` (scatter-add) or, on the sort branch,
  `matmul_groupby` (a one-hot contraction of byte limbs; a float SUM takes
  `sort_groupby`); general keys take `hash_groupby` (open-addressing placement) or,
  on the sort branch, `sort_groupby` (a stable lexsort, then prefix sums and gathers
  at the group boundaries);
- hash join: a slot-table CSR over the build side, a gather probe and a scatter
  expansion (`hash_join_build_slots`, `hash_join_probe_csr`), or, on the sort branch,
  the sorted build hashes searched by the probe hashes (`_hash_join_pairs_sorted`);
  `bloom_query_device` tests probe keys against a bloom built on the host;
- window functions: a stable sort by (partition, order) keys, then cumulative scans
  and boundary gathers over the partition and peer runs (`window_eval`).

The skew-aware hybrid join of `parallel/mpp.py` classifies rows with `hot_key_mask`
and probes its unioned lanes with `hash_join_probe_hybrid`, the CSR pipeline on both
branches, as in the reference.

The four kernel call sites — build-row slots, probe-row slots, pair expansion and group
placement — sit on the scatter branch and go through `cuda_join` / `cuda_agg`, whose
wrappers launch the hand-written CUDA kernel for a CUDA tensor and run the plain version
for a CPU tensor.  The sort branch's sorts, searches and products are torch calls, as
they are plain XLA in the reference.  Output capacities are arguments; kernels report
`overflow` so the caller can re-bucket and retry.  Dead rows ride `live` masks and are
never compacted implicitly.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
from galaxysql_tpu_torch.kernels.hashing import _mix64, hash_columns, lsr  # noqa: F401


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------

class AggSpec(NamedTuple):
    kind: str  # 'sum' | 'count' | 'count_star' | 'min' | 'max' | 'sum_float'
    arg: int   # operand index into the inputs list (-1 for count_star)


class GroupByResult(NamedTuple):
    keys: Tuple[Tuple[Any, Any], ...]  # per key: (data [slots], valid-or-None)
    aggs: Tuple[Tuple[Any, Any], ...]  # per agg: (data [slots], valid-or-None)
    live: Any                      # [slots] bool — which output slots are real groups
    num_groups: Any                # scalar int32
    overflow: Any                  # scalar bool


FORMULATIONS = ("scatter", "sort")

_FORMULATION_TLS = threading.local()


def formulation() -> str:
    """The calling thread's formulation branch: 'scatter' (the default on every
    device) or 'sort' (the reference's accelerator branch)."""
    return getattr(_FORMULATION_TLS, "name", "scatter")


@contextlib.contextmanager
def formulation_scope(name: str):
    """Run the calling thread's statements on one formulation branch (thread-local,
    as the reference's `kernel_scope`: concurrent sessions keep their own)."""
    if name not in FORMULATIONS:
        raise ValueError(f"unknown formulation {name!r}")
    prev = formulation()
    _FORMULATION_TLS.name = name
    try:
        yield
    finally:
        _FORMULATION_TLS.name = prev


def prefer_scatter() -> bool:
    """The reference's seam: True takes the scatter and hash formulations, False the
    sort and matmul ones.  True unless the thread is inside `formulation_scope("sort")`;
    read when each function runs, so a cache holding state one branch built carries
    `formulation()` in its key."""
    return formulation() == "scatter"


def _neutral(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _segment_sum(vals, seg, num_segments: int):
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


def _segment_reduce(vals, seg, num_segments: int, kind: str):
    out = torch.full((num_segments,), _neutral(vals.dtype, kind), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, vals, reduce="amin" if kind == "min" else "amax",
                               include_self=True)


def _gather(arr, idx):
    """arr[idx] for in-range idx; an empty `arr` gathers zeros (the rows read are
    dead, as they are where the reference gathers out of an empty lane)."""
    if arr.shape[0] == 0:
        return torch.zeros(idx.shape[0], dtype=arr.dtype, device=arr.device)
    return arr[idx]


def _domain_gid(keys, domains, n, device):
    """Encode small-domain key lanes into one dense group id (NULL slot last per
    key) plus per-key sizes."""
    sizes: List[int] = []
    effs: List[Any] = []
    for (data, valid), dom in zip(keys, domains):
        d = torch.clamp(data.to(torch.int32), 0, dom - 1)
        size = dom + (1 if valid is not None else 0)
        effs.append(d if valid is None else torch.where(valid, d, torch.full_like(d, dom)))
        sizes.append(size)
    D = 1
    for s in sizes:
        D *= s
    gid = torch.zeros(n, dtype=torch.int32, device=device)
    for eff, size in zip(effs, sizes):
        gid = gid * size + eff
    return gid, sizes, D


def _domain_out_keys(keys, domains, sizes, D, device):
    """Decode domain slot indices back into per-key code lanes."""
    idx = torch.arange(D, dtype=torch.int32, device=device)
    out_keys: List[Tuple[Any, Any]] = []
    stride = D
    for (data, valid), dom, size in zip(keys, domains, sizes):
        stride //= size
        slot = torch.remainder(torch.div(idx, stride, rounding_mode="floor"), size)
        kd = torch.clamp(slot, 0, dom - 1).to(data.dtype)
        kv = None if valid is None else (slot < dom)
        out_keys.append((kd, kv))
    return out_keys


def _aggregate(specs, inputs, live_cnt, placed, seg, num_slots: int):
    """Per-slot aggregates of `specs` over rows mapped to `seg` (slot `num_slots`
    is the dead-row scratch slot every reduction slices off)."""
    present_of: dict = {}
    pres_cnt: dict = {}
    for spec in specs:
        if spec.arg >= 0 and spec.arg not in present_of:
            _dta, val = inputs[spec.arg]
            p = placed if val is None else (placed & val)
            present_of[spec.arg] = p
            pres_cnt[spec.arg] = _segment_sum(p.to(torch.int64), seg,
                                              num_slots + 1)[:num_slots]
    out_aggs: List[Tuple[Any, Any]] = []
    for spec in specs:
        if spec.kind == "count_star":
            out_aggs.append((live_cnt, None))
            continue
        dta, _val = inputs[spec.arg]
        pres = present_of[spec.arg]
        if spec.kind == "count":
            out_aggs.append((pres_cnt[spec.arg], None))
        elif spec.kind in ("sum", "sum_float"):
            if dta.dtype.is_floating_point:
                masked = torch.where(pres, dta, torch.zeros_like(dta))
            else:
                masked = torch.where(pres, dta.to(torch.int64),
                                     torch.zeros((), dtype=torch.int64, device=dta.device))
            s = _segment_sum(masked, seg, num_slots + 1)[:num_slots]
            out_aggs.append((s, pres_cnt[spec.arg] > 0))
        elif spec.kind in ("min", "max"):
            neutral = _neutral(dta.dtype, spec.kind)
            masked = torch.where(pres, dta, torch.full_like(dta, neutral))
            red = _segment_reduce(masked, seg, num_slots + 1, spec.kind)[:num_slots]
            out_aggs.append((red, pres_cnt[spec.arg] > 0))
        else:
            raise ValueError(f"unsupported agg kind {spec.kind}")
    return out_aggs


def scatter_groupby(keys: Sequence[Tuple[Any, Optional[Any]]],
                    inputs: Sequence[Tuple[Any, Optional[Any]]],
                    specs: Sequence[AggSpec],
                    live: Any,
                    domains: Sequence[int]) -> GroupByResult:
    """Small-domain grouped aggregation via scatter-add.

    Output slots enumerate the key-domain cross product (major key .. minor key, NULL
    slot last); `live` marks the non-empty slots; `overflow` is always False."""
    n = live.shape[0]
    device = live.device
    gid, sizes, D = _domain_gid(keys, domains, n, device)
    seg = torch.where(live, gid, torch.full_like(gid, D)).to(torch.int64)
    live_cnt = _segment_sum(live.to(torch.int64), seg, D + 1)[:D]
    out_live = live_cnt > 0
    num_groups = out_live.to(torch.int32).sum()
    out_keys = _domain_out_keys(keys, domains, sizes, D, device)
    out_aggs = _aggregate(specs, inputs, live_cnt, live, seg, D)
    return GroupByResult(tuple(out_keys), tuple(out_aggs), out_live, num_groups, False)


def _sort_lane(data):
    """A key lane as the sort compares it: booleans as int8, and floats with -0.0 made
    +0.0 and every NaN one NaN, the reference's sort comparator's canonical form (a
    radix sort on the card would otherwise split -0.0 from +0.0).  Equality of
    adjacent canonical values finds the same group boundaries as the raw values."""
    if data.dtype == torch.bool:
        return data.to(torch.int8)
    if data.dtype.is_floating_point:
        d = torch.where(data == 0, torch.zeros_like(data), data)
        return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
    return data


def sort_groupby(keys: Sequence[Tuple[Any, Optional[Any]]],
                 inputs: Sequence[Tuple[Any, Optional[Any]]],
                 specs: Sequence[AggSpec],
                 live: Any,
                 max_groups: int) -> GroupByResult:
    """Grouped aggregation by sort: rows are lexsorted on (dead, key lanes) with a NULL
    flag per nullable key, so groups are contiguous runs; every reduction is a prefix
    sum differenced at the run boundaries (min/max a segmented scan read at each run's
    last row).  No scatter-add and no atomics.

    Groups come out in key order, compacted to a prefix of `max_groups` slots (NULL
    keys sort after every value; dead slots past `num_groups`); `overflow` (a tensor)
    is True when there are more groups than slots, and the caller retries with more."""
    n = keys[0][0].shape[0] if keys else live.shape[0]
    device = live.device
    idx = torch.arange(max_groups, dtype=torch.int64, device=device)
    dead = ~live

    # null flag participates in grouping (SQL GROUP BY: NULLs form one group)
    key_lanes: List[Any] = []
    for data, valid in keys:
        if valid is not None:
            key_lanes.append((~valid).to(torch.int8))
            key_lanes.append(_sort_lane(torch.where(valid, data, torch.zeros_like(data))))
        else:
            key_lanes.append(_sort_lane(data))
    order = lexsort_major_first([dead.to(torch.int8)] + key_lanes)
    live_s = live[order]

    new_group = torch.zeros(n, dtype=torch.bool, device=device)
    if n:
        for lane in key_lanes:
            lane_s = lane[order]
            new_group[1:] |= lane_s[1:] != lane_s[:-1]
        new_group &= live_s
        new_group[0] = live_s[0]
    num_groups = new_group.to(torch.int32).sum()
    overflow = num_groups > max_groups

    # run starts: the first max_groups + 1 positions of new_group, padded with n (the
    # reference's fixed-size nonzero); rows past them write into a spare slot
    ordinal = torch.cumsum(new_group.to(torch.int64), 0) - 1
    slot = torch.where(new_group & (ordinal <= max_groups), ordinal,
                       torch.full_like(ordinal, max_groups + 1))
    starts_raw = torch.full((max_groups + 2,), n, dtype=torch.int64, device=device)
    starts_raw.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=device))
    starts = starts_raw[:max_groups]
    # dead rows sort to the end, so group g covers sorted rows [starts[g], ends[g]);
    # the LAST live group's end is the count of live rows, not n
    n_live = live_s.to(torch.int64).sum()
    ends = torch.minimum(starts_raw[1:max_groups + 1], n_live)
    gvalid = starts < n_live
    starts_c = torch.clamp(starts, 0, max(n - 1, 0))

    def run_reduce_sum(masked):
        c0 = torch.cat([torch.zeros(1, dtype=masked.dtype, device=device),
                        torch.cumsum(masked, 0, dtype=masked.dtype)])
        return c0[ends] - c0[starts_c]

    out_keys = []
    for data, valid in keys:
        out_keys.append((_gather(data[order], starts_c),
                         None if valid is None else _gather(valid[order], starts_c)))

    out_aggs: List[Tuple[Any, Any]] = []
    for spec in specs:
        if spec.kind == "count_star":
            out_aggs.append((run_reduce_sum(live_s.to(torch.int64)), None))
            continue
        data, valid = inputs[spec.arg]
        d_s = data[order]
        present = live_s if valid is None else (live_s & valid[order])
        if spec.kind == "count":
            out_aggs.append((run_reduce_sum(present.to(torch.int64)), None))
        elif spec.kind in ("sum", "sum_float"):
            if d_s.dtype.is_floating_point:
                masked = torch.where(present, d_s, torch.zeros_like(d_s))
            else:
                masked = torch.where(present, d_s.to(torch.int64),
                                     torch.zeros((), dtype=torch.int64, device=device))
            nonempty = run_reduce_sum(present.to(torch.int32)) > 0
            out_aggs.append((run_reduce_sum(masked), nonempty))
        elif spec.kind in ("min", "max"):
            masked = torch.where(present, d_s,
                                 torch.full_like(d_s, _neutral(d_s.dtype, spec.kind)))
            # segmented running min/max restarting at each run boundary; the last
            # row of each run then holds the run's reduction
            m = _segmented_scan(masked, new_group, spec.kind == "min")
            last = torch.clamp(ends - 1, 0, max(n - 1, 0))
            nonempty = run_reduce_sum(present.to(torch.int32)) > 0
            out_aggs.append((_gather(m, last), nonempty))
        else:
            raise ValueError(f"unknown agg kind {spec.kind}")

    kept = torch.clamp(num_groups, max=max_groups)
    out_live = gvalid & (idx < kept)
    return GroupByResult(tuple(out_keys), tuple(out_aggs), out_live,
                         kept.to(torch.int32), overflow)


# rows of one contraction of `matmul_groupby`: a float64 product of 0..255 limbs and
# 0/1 one-hot columns stays exact while rows * 255 < 2^53; the size bounds the
# [rows, lanes] and [rows, D] operands' memory
MATMUL_CHUNK = 1 << 20
# cells of one [rows, D] masked min/max slab of `matmul_groupby`
MATMUL_MINMAX_CELLS = 1 << 25


def matmul_groupby(keys: Sequence[Tuple[Any, Optional[Any]]],
                   inputs: Sequence[Tuple[Any, Optional[Any]]],
                   specs: Sequence[AggSpec],
                   live: Any,
                   domains: Sequence[int]) -> GroupByResult:
    """Small-domain grouped aggregation as a matrix product: no sort, no scatter.

    The group id enumerates the key-domain cross product, and the per-slot counts and
    sums are `A^T @ onehot(gid)`, where A holds a 1 per live row, a presence lane per
    input and the 8 bytes of each SUM input.  Each byte lane sums exactly and the byte
    sums recombine with shifts mod 2^64, so the sums wrap as int64 arithmetic does (the
    reference's int8 byte limbs, byte - 128, sum to the same values).  min/max are
    masked reductions over [rows, D] slabs.  Float SUMs are not supported (the dispatch
    sends them to `sort_groupby`).

    Slots are in domain order (major key .. minor key, NULL slot last), not compacted;
    `live` marks the non-empty slots; `overflow` is always False."""
    n = live.shape[0]
    device = live.device
    gid, sizes, D = _domain_gid(keys, domains, n, device)
    idx = torch.arange(D, dtype=torch.int32, device=device)

    # lane plan: [live] + [present per distinct input] + [8 bytes per sum input]
    present_lane: dict = {}
    present_of: List[Any] = []
    for spec in specs:
        if spec.arg >= 0 and spec.arg not in present_lane:
            _dta, val = inputs[spec.arg]
            present_lane[spec.arg] = len(present_of)
            present_of.append(live if val is None else (live & val))
    sum_args = sorted({s.arg for s in specs if s.kind == "sum" and s.arg >= 0})
    limb_base = {a: 1 + len(present_of) + 8 * i for i, a in enumerate(sum_args)}
    zero = torch.zeros((), dtype=torch.int64, device=device)

    acc = torch.zeros((1 + len(present_of) + 8 * len(sum_args), D), dtype=torch.int64,
                      device=device)
    for s0 in range(0, n, MATMUL_CHUNK):
        s1 = min(s0 + MATMUL_CHUNK, n)
        lv = live[s0:s1]
        parts = [torch.stack([lv] + [p[s0:s1] for p in present_of], 1)
                 .to(torch.float64)]
        for a in sum_args:
            pres = present_of[present_lane[a]][s0:s1]
            v = torch.where(pres, inputs[a][0][s0:s1].to(torch.int64), zero)
            # little-endian bytes: column j is (v >> 8j) & 0xFF
            parts.append(v.contiguous().view(torch.uint8).view(s1 - s0, 8)
                         .to(torch.float64))
        A = torch.cat(parts, 1)
        onehot = ((gid[s0:s1, None] == idx[None, :]) & lv[:, None]).to(torch.float64)
        acc += (A.t() @ onehot).to(torch.int64)

    live_cnt = acc[0]
    out_live = live_cnt > 0
    num_groups = out_live.to(torch.int32).sum()

    def decode_sum(a: int) -> Any:
        total = torch.zeros(D, dtype=torch.int64, device=device)
        for j in range(8):
            total = total + (acc[limb_base[a] + j] << (8 * j))
        return total

    def masked_reduce(dta, pres, kind: str) -> Any:
        neutral = _neutral(dta.dtype, kind)
        red = torch.full((D,), neutral, dtype=dta.dtype, device=device)
        fill = torch.full((), neutral, dtype=dta.dtype, device=device)
        step = max(1, MATMUL_MINMAX_CELLS // max(D, 1))
        for s0 in range(0, n, step):
            s1 = min(s0 + step, n)
            sel = (gid[s0:s1, None] == idx[None, :]) & pres[s0:s1, None]
            m = torch.where(sel, dta[s0:s1, None], fill)
            red = torch.minimum(red, m.amin(0)) if kind == "min" else \
                torch.maximum(red, m.amax(0))
        return red

    out_keys = _domain_out_keys(keys, domains, sizes, D, device)
    out_aggs: List[Tuple[Any, Any]] = []
    for spec in specs:
        if spec.kind == "count_star":
            out_aggs.append((live_cnt, None))
            continue
        pres_cnt = acc[1 + present_lane[spec.arg]]
        if spec.kind == "count":
            out_aggs.append((pres_cnt, None))
        elif spec.kind == "sum":
            out_aggs.append((decode_sum(spec.arg), pres_cnt > 0))
        elif spec.kind in ("min", "max"):
            out_aggs.append((masked_reduce(inputs[spec.arg][0],
                                           present_of[present_lane[spec.arg]],
                                           spec.kind), pres_cnt > 0))
        else:
            raise ValueError(f"unsupported matmul agg kind {spec.kind}")
    return GroupByResult(tuple(out_keys), tuple(out_aggs), out_live, num_groups, False)


def _ident_lanes(keys):
    """Per-key (data_canon, valid) identity lanes for hashing/equality.

    Floats are canonicalized (-0.0 -> +0.0, NaN -> one bit pattern) then bitcast to
    same-width ints, so hash and equality follow SQL GROUP BY semantics."""
    out = []
    for data, valid in keys:
        if data.dtype.is_floating_point:
            d = torch.where(data == 0, torch.zeros_like(data), data)
            d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
            d = d.view(torch.int32 if data.dtype == torch.float32 else torch.int64)
        else:
            d = data
        if valid is not None:
            d = torch.where(valid, d, torch.zeros_like(d))
        out.append((d.contiguous(), None if valid is None else valid.contiguous()))
    return out


def hash_groupby(keys: Sequence[Tuple[Any, Optional[Any]]],
                 inputs: Sequence[Tuple[Any, Optional[Any]]],
                 specs: Sequence[AggSpec],
                 live: Any,
                 max_groups: int,
                 max_rounds: int = 64,
                 rows: Optional[int] = None) -> GroupByResult:
    """General grouped aggregation via open-addressing hash slots — no sort.

    Group ids come from `cuda_agg.hash_place` (the placement kernel); aggregation is
    a scatter by slot.  Output slots are in hash order, not compacted — `live` marks
    real groups.  `overflow` is True when placement fails within `max_rounds`;
    callers retry with doubled `max_groups`.  `rows` is the input capacity the slots
    are sized from where it is not the lanes' (a batch's `nominal` capacity)."""
    n = live.shape[0] if not keys else keys[0][0].shape[0]
    device = live.device
    cap = max(16, min(max_groups, n if rows is None else rows))
    M = 1 << int(cap * 2 - 1).bit_length()  # load factor <= 0.5 at capacity

    ident = _ident_lanes(keys)
    h = hash_columns(ident)
    s0 = h & (M - 1)
    # odd stride => full cycle mod the power-of-two table size
    step = (lsr(h, 32) << 1) | 1
    sentinel = n
    rep, resolved, gid = cuda_agg.hash_place(ident, live.contiguous(), s0.contiguous(),
                                             step.contiguous(), M, max_rounds)
    overflow = bool((~resolved).any())

    placed = resolved & live
    seg = torch.where(placed, gid, torch.full_like(gid, M)).to(torch.int64)
    live_cnt = _segment_sum(live.to(torch.int64), seg, M + 1)[:M]
    out_live = rep != sentinel
    num_groups = out_live.to(torch.int32).sum()

    safe_rep = torch.clamp(rep, 0, max(n - 1, 0)).to(torch.int64)
    out_keys = []
    for data, valid in keys:
        out_keys.append((_gather(data, safe_rep),
                         None if valid is None else (_gather(valid, safe_rep) & out_live)))
    out_aggs = _aggregate(specs, inputs, live_cnt, placed, seg, M)
    return GroupByResult(tuple(out_keys), tuple(out_aggs), out_live, num_groups, overflow)


def groupby(keys, inputs, specs, live, max_groups, domains=None, rows=None):
    """Grouped aggregation dispatch on `prefer_scatter()`, the reference's: small
    static domains (and global aggregation) take the dense slots of `scatter_groupby`,
    or of `matmul_groupby` on the sort branch unless a SUM is over floats; general
    keys take `hash_groupby` (slots sized from `rows`, the input's nominal capacity),
    or `sort_groupby` (`max_groups` slots) on the sort branch."""
    if domains is None and not keys:
        domains = []  # global aggregation: one dense slot, never hash/sort
    if domains is not None:
        if prefer_scatter():
            return scatter_groupby(keys, inputs, specs, live, domains)
        float_sum = any(
            s.kind in ("sum", "sum_float") and s.arg >= 0 and
            inputs[s.arg][0].dtype.is_floating_point for s in specs)
        if not float_sum:
            return matmul_groupby(keys, inputs, specs, live, domains)
    if prefer_scatter():
        return hash_groupby(keys, inputs, specs, live, max_groups, rows=rows)
    return sort_groupby(keys, inputs, specs, live, max_groups)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

class JoinPairs(NamedTuple):
    build_idx: Any      # [cap] int64 indices into build arrays
    probe_idx: Any      # [cap] int64 indices into probe arrays
    live: Any           # [cap] bool — verified pairs
    probe_matched: Any  # [n_probe] bool — probe rows with >=1 verified match
    probe_starts: Any   # [n_probe] int64 — first pair slot of each probe row
    probe_offsets: Any  # [n_probe] int64 — end pair slot of each probe row
    overflow: Any       # scalar bool


def _effective_live(keys, live):
    m = live
    for _, valid in keys:
        if valid is not None:
            m = m & valid
    return m


def hash_join_pairs(build_keys: Sequence[Tuple[Any, Optional[Any]]],
                    probe_keys: Sequence[Tuple[Any, Optional[Any]]],
                    build_live: Any,
                    probe_live: Any,
                    cap: int) -> JoinPairs:
    """Equi-join match enumeration: verified (build, probe) index pairs.  NULL join
    keys never match.  Dispatch on `prefer_scatter()`, the reference's: the slot-table
    CSR (`_hash_join_pairs_table`), or the sorted build hashes
    (`_hash_join_pairs_sorted`) on the sort branch."""
    if prefer_scatter():
        return _hash_join_pairs_table(build_keys, probe_keys, build_live, probe_live,
                                      cap)
    return _hash_join_pairs_sorted(build_keys, probe_keys, build_live, probe_live, cap)


def _no_pairs(cap: int, device) -> JoinPairs:
    """The pairs of an empty probe side: `cap` dead slots."""
    zero = torch.zeros(cap, dtype=torch.int64, device=device)
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return JoinPairs(zero, zero, torch.zeros(cap, dtype=torch.bool, device=device),
                     torch.zeros(0, dtype=torch.bool, device=device), empty, empty,
                     False)


# flipping the sign bit of int64 lanes holding uint64 bits makes their signed order
# the unsigned order of the bits (torch sorts and searches int64, never uint64)
_SIGN_BIT = -(1 << 63)


def _hash_join_pairs_sorted(build_keys, probe_keys, build_live, probe_live,
                            cap: int) -> JoinPairs:
    """The reference's accelerator join: a stable argsort of the build hashes, two
    binary searches of each probe hash for its candidate run, a ragged expansion of
    the runs into `cap` pair slots by a search over the running offsets, and a verify
    of every candidate on the key lanes.  Hashes are ordered as uint64, as the
    reference orders them; dead and NULL-key build rows take the all-ones hash, which
    sorts last and is never verified."""
    b_live = _effective_live(build_keys, build_live)
    p_live = _effective_live(probe_keys, probe_live)
    nb = build_keys[0][0].shape[0]
    npr = probe_keys[0][0].shape[0]
    device = p_live.device
    if npr == 0:
        return _no_pairs(cap, device)

    h_b = torch.where(b_live, hash_columns(build_keys),
                      torch.full((), -1, dtype=torch.int64, device=device))
    h_b = h_b ^ _SIGN_BIT
    perm = torch.argsort(h_b, stable=True)
    h_sorted = h_b[perm].contiguous()
    h_p = (hash_columns(probe_keys) ^ _SIGN_BIT).contiguous()
    left = torch.searchsorted(h_sorted, h_p, side="left")
    right = torch.searchsorted(h_sorted, h_p, side="right")
    counts = torch.where(p_live, right - left,
                         torch.zeros((), dtype=torch.int64, device=device))

    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    overflow = total > cap
    starts = offsets - counts

    # ragged expansion: slot j -> probe row p, its k-th candidate
    slots = torch.arange(cap, dtype=torch.int64, device=device)
    p_of = torch.clamp(torch.searchsorted(offsets, slots, side="right"), 0, npr - 1)
    k = slots - starts[p_of]
    pair_live = slots < torch.clamp(total, max=cap)
    bpos = torch.clamp(left[p_of] + k, 0, max(nb - 1, 0))
    b_of = _gather(perm, bpos)

    # verify candidate pairs on the actual key lanes (hash collisions filtered here)
    verified = pair_live
    for (bd, _bv), (pd, _pv) in zip(build_keys, probe_keys):
        verified = verified & (_gather(bd, b_of) == pd[p_of])
    verified = verified & _gather(b_live, b_of) & p_live[p_of]

    # pair slots are ordered by probe row: "any verified" is a prefix-sum range query
    probe_matched = probe_matched_from(verified, starts, offsets)
    return JoinPairs(b_of, p_of, verified, probe_matched, starts, offsets, overflow)


def _hash_join_pairs_table(build_keys, probe_keys, build_live, probe_live,
                           cap: int) -> JoinPairs:
    """The scatter branch's join: a slot-table CSR over the build side, a gather
    probe and a scatter expansion (`_device_csr` + `hash_join_probe_csr`, the
    pipeline the hybrid probe rides too)."""
    nb = build_keys[0][0].shape[0]
    perm, slot_starts, slot_counts, M = _device_csr(build_keys, build_live, nb)
    return hash_join_probe_csr(build_keys, probe_keys, build_live, probe_live,
                               perm, slot_starts, slot_counts, M, cap)


def _device_csr(build_keys, build_live, nb: int):
    """CSR over the build slots on the build lanes' device: (perm, slot_starts,
    slot_counts, M).  M = 4x build capacity (<= 0.25 expected collision candidates
    per probe, filtered by key verification).  Slot ids come from the `build_slots`
    kernel; a stable argsort groups build row ids contiguously per slot and a
    bincount sizes each slot — the same perm/starts/counts as the reference's host
    CSR (`HashJoinOp._csr_host`)."""
    M = 1 << max(4, int(nb * 4 - 1).bit_length())
    s_b = hash_join_build_slots(build_keys, build_live, M).to(torch.int64)
    perm = torch.argsort(s_b, stable=True).to(torch.int32)
    slot_counts = torch.bincount(s_b, minlength=M + 1)[:M].to(torch.int32)
    slot_ends = torch.cumsum(slot_counts, 0, dtype=torch.int64)
    slot_starts = slot_ends - slot_counts
    return perm, slot_starts, slot_counts, M


def hash_join_build_slots(build_keys: Sequence[Tuple[Any, Optional[Any]]],
                          build_live: Any, M: int) -> Any:
    """Build-side slot ids (hash + mask); dead and NULL-key rows get slot M."""
    b_live = _effective_live(build_keys, build_live)
    keys = [(d.contiguous(), None if v is None else v.contiguous()) for d, v in build_keys]
    return cuda_join.build_slots(keys, b_live.contiguous(), M)


def _expand_offsets(counts, starts, npr: int, cap: int):
    """Ragged probe->pair expansion (the `expand_offsets` kernel)."""
    return cuda_join.expand_offsets(counts.contiguous(), starts.contiguous(), cap)


def hash_join_probe_csr(build_keys, probe_keys, build_live, probe_live,
                        perm, slot_starts, slot_counts,
                        M: int, cap: int) -> JoinPairs:
    """Probe half of the slot-table join against a built CSR."""
    b_live = _effective_live(build_keys, build_live)
    p_live = _effective_live(probe_keys, probe_live)
    nb = build_keys[0][0].shape[0]
    npr = probe_keys[0][0].shape[0]
    device = p_live.device
    if npr == 0:
        return _no_pairs(cap, device)
    slots = torch.arange(cap, dtype=torch.int64, device=device)

    keys = [(d.contiguous(), None if v is None else v.contiguous()) for d, v in probe_keys]
    s_p = cuda_join.hash_slots(keys, M).to(torch.int64)
    counts = torch.where(p_live, slot_counts[s_p].to(torch.int64),
                         torch.zeros((), dtype=torch.int64, device=device))

    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    overflow = total > cap
    starts = offsets - counts  # the exclusive prefix sum the expand kernel requires

    p_of = _expand_offsets(counts, starts, npr, cap).to(torch.int64)
    k = slots - starts[p_of]
    pair_live = slots < min(total, cap)
    bpos = torch.clamp(slot_starts[s_p[p_of]] + k, 0, max(nb - 1, 0))
    b_of = _gather(perm, bpos).to(torch.int64)

    verified = pair_live
    for (bd, _bv), (pd, _pv) in zip(build_keys, probe_keys):
        verified = verified & (_gather(bd, b_of) == pd[p_of])
    verified = verified & _gather(b_live, b_of) & p_live[p_of]

    probe_matched = probe_matched_from(verified, starts, offsets)
    return JoinPairs(b_of, p_of, verified, probe_matched, starts, offsets, overflow)


def hot_key_mask(keys: Sequence[Tuple[Any, Optional[Any]]],
                 hot_hashes: Any, hot_valid: Any) -> Any:
    """Heavy-hitter classification lane of the skew-aware hybrid join: True where
    the row's combined key hash (the `hash_columns` lane the repartition
    destinations come from) is one of the valid `hot_hashes` (int64 bits; the
    padding slots are masked by `hot_valid`, so the hot set's size is a runtime
    value).  Purely hash-based, as in the reference: a cold key colliding with a
    hot hash is hot on both sides of the join, so correctness never depends on the
    hot set's contents."""
    h = hash_columns(keys)
    # the padding slots take a valid slot's value: membership is then exactly the
    # valid set's (no valid slot at all: nothing is hot)
    hot = torch.where(hot_valid, hot_hashes, hot_hashes[torch.argmax(
        hot_valid.to(torch.int8))])
    return torch.isin(h, hot) & hot_valid.any()


def hash_join_probe_hybrid(build_keys: Sequence[Tuple[Any, Optional[Any]]],
                           probe_keys: Sequence[Tuple[Any, Optional[Any]]],
                           build_live: Any, probe_live: Any,
                           cap: int) -> JoinPairs:
    """Union-lane probe of the skew-aware hybrid join: each shard's build lanes are
    the broadcast hot rows and the shuffled cold rows concatenated (likewise the
    probe lanes), and one pass enumerates the verified pairs over the union through
    the same `_device_csr` + `hash_join_probe_csr` pipeline every join shares, so
    `build_slots`, `hash_slots` and `expand_offsets` launch on it."""
    nb = build_keys[0][0].shape[0]
    perm, slot_starts, slot_counts, M = _device_csr(build_keys, build_live, nb)
    return hash_join_probe_csr(build_keys, probe_keys, build_live, probe_live,
                               perm, slot_starts, slot_counts, M, cap)


def probe_matched_from(pair_live: Any, starts: Any, offsets: Any) -> Any:
    """matched[p] = any pair in [starts[p], offsets[p]) is live (prefix-sum ranges)."""
    cap = pair_live.shape[0]
    c = torch.cat([torch.zeros(1, dtype=torch.int64, device=pair_live.device),
                   torch.cumsum(pair_live.to(torch.int64), 0)])
    s = torch.clamp(starts, 0, cap)
    e = torch.clamp(offsets, 0, cap)
    return (c[e] - c[s]) > 0


def bloom_query_device(keys: Any, words: Any) -> Any:
    """Membership of each key in a bloom filter whose words were built on the host
    (`galaxysql_tpu_torch.native.bloom_build`, the reference's layout: two bits a key
    from SplitMix64, in int64 words holding the uint64 bits).  Word indices are
    logical shifts (`lsr`); a bit test of an arithmetic shift reads the same bit."""
    h = _mix64(keys.to(torch.int64))
    m = words.shape[0] - 1
    w1 = words[lsr(h, 6) & m]
    w2 = words[lsr(h, 38) & m]
    hit1 = (w1 >> (h & 63)) & 1
    hit2 = (w2 >> (lsr(h, 32) & 63)) & 1
    return (hit1 & hit2).to(torch.bool)


# ---------------------------------------------------------------------------
# sort / topn
# ---------------------------------------------------------------------------

def lexsort_major_first(lanes: Sequence[Any]) -> Any:
    """Stable lexicographic order, `lanes[0]` the major key (torch has no lexsort:
    a stable argsort per lane, minor key first)."""
    n = lanes[0].shape[0]
    order = torch.arange(n, dtype=torch.int64, device=lanes[0].device)
    for lane in reversed(lanes):
        order = order[torch.argsort(lane[order], stable=True)]
    return order


def sort_indices(keys: Sequence[Tuple[Any, Optional[Any], bool, bool]],
                 live: Any) -> Any:
    """Stable multi-key sort.  Each key: (data, valid, descending, nulls_first).

    Returns a permutation with live rows first in the requested order."""
    lanes: List[Any] = []
    for data, valid, desc, nulls_first in keys:
        if data.dtype.is_floating_point:
            lane = -data if desc else data
        elif data.dtype == torch.bool:
            lane = (~data if desc else data).to(torch.int8)
        else:
            lane = -data.to(torch.int64) if desc else data.to(torch.int64)
        if valid is not None:
            non_null_rank = 1 if nulls_first else 0
            null_rank = 0 if nulls_first else 1
            lanes.append(torch.where(valid, torch.full_like(valid, non_null_rank,
                                                            dtype=torch.int8),
                                     torch.full_like(valid, null_rank, dtype=torch.int8)))
            lane = torch.where(valid, lane, torch.zeros_like(lane))
        lanes.append(lane)
    dead = (~live).to(torch.int8)
    return lexsort_major_first([dead] + lanes)


def compaction_order(live: Any) -> Tuple[Any, Any]:
    """Stable permutation putting live rows first; returns (order, num_live)."""
    order = torch.argsort((~live).to(torch.int8), stable=True)
    return order, live.to(torch.int32).sum()


def limit_mask(live: Any, offset: int, count: int) -> Any:
    """LIMIT offset, count over live rows (order = physical order)."""
    rank = torch.cumsum(live.to(torch.int64), 0) - 1
    return live & (rank >= offset) & (rank < offset + count)


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

def _segmented_scan(x, reset, is_min: bool):
    """Running min/max that restarts where `reset` is True: a log-depth doubling scan
    (Hillis-Steele) of the reference's `associative_scan` combiner, on `x`'s device.

    min and max are separate combiners on purpose: computing max as -scan_min(-x)
    would wrap the integer neutral (-INT_MIN == INT_MIN) and poison groups that
    contain NULLs."""
    pick = torch.minimum if is_min else torch.maximum
    n = x.shape[0]
    pad = _neutral(x.dtype, "min" if is_min else "max")
    vals, flags = x, reset
    shift = 1
    while shift < n:
        # combine(prefix ending `shift` rows back, run ending here): the later run
        # keeps its own value where it holds a reset
        prev = torch.cat([torch.full((shift,), pad, dtype=x.dtype, device=x.device),
                          vals[:-shift]])
        prev_flags = torch.cat([torch.zeros(shift, dtype=torch.bool, device=x.device),
                                flags[:-shift]])
        vals = torch.where(flags, vals, pick(prev, vals))
        flags = flags | prev_flags
        shift *= 2
    return vals


class WindowSpec(NamedTuple):
    kind: str    # row_number | rank | dense_rank | sum | count | min | max |
                 # lag | lead | first_value | last_value
    arg: int     # input lane index (-1 for rank-family)
    offset: int  # lag/lead distance
    # frame: 'running' (ROWS ..CURRENT), 'range' (RANGE ..CURRENT: ties share the
    # run-end value), 'whole' (entire partition)
    frame: str


def _run_bounds(flags, arange, n: int):
    """Per row, the position of the last flagged row at or before it and of the first
    flagged row after it (n where none); `flags[0]` is set.  The reference takes the
    first from a running max of flagged positions and the second from a gather out of
    the padded list of flagged positions; here both are gathers out of that list,
    built with a cumulative sum and one scatter (torch's running max/min with indices
    costs ~18 ms a call over 7.3M rows on an H100, a cumulative sum a fraction of
    one)."""
    ordinal = torch.cumsum(flags.to(torch.int64), 0) - 1   # run of each row
    starts = torch.full((n + 2,), n, dtype=torch.int64, device=flags.device)
    # unflagged rows all write into the spare slot n + 1
    starts.scatter_(0, torch.where(flags, ordinal, torch.full_like(ordinal, n + 1)),
                    arange)
    return starts[ordinal], starts[ordinal + 1]


def window_eval(part_keys: Sequence[Tuple[Any, Optional[Any]]],
                order_keys: Sequence[Tuple[Any, Optional[Any], bool, bool]],
                inputs: Sequence[Tuple[Any, Optional[Any]]],
                specs: Sequence[WindowSpec],
                live: Any):
    """Evaluate window functions scatter-free (the reference's `window_eval`).

    Rows are sorted stably by (partition keys, order keys); all computations are
    cumulative scans + boundary gathers over the contiguous partition/peer runs.
    Returns (order permutation, live_sorted, [(data, valid)] per spec) — outputs align
    to the SORTED order; the operator gathers payload columns with the same
    permutation."""
    n = live.shape[0]
    device = live.device
    sort_keys = [(d, v, False, True) for d, v in part_keys] + list(order_keys)
    order = sort_indices(sort_keys, live)
    live_s = live[order]
    arange = torch.arange(n, dtype=torch.int64, device=device)

    def first_row():
        flag = torch.zeros(n, dtype=torch.bool, device=device)
        flag[0] = True
        return flag

    def boundaries(keys):
        flag = first_row()
        for d, v in keys:
            # canonicalize NULLs: the data under an invalid slot is unspecified and
            # must not split the all-NULLs partition/peer run
            dc = d if v is None else torch.where(v, d, torch.zeros_like(d))
            d_s = dc[order]
            flag[1:] |= d_s[1:] != d_s[:-1]
            if v is not None:
                v_s = v[order]
                flag[1:] |= v_s[1:] != v_s[:-1]
        return flag

    new_part = boundaries(part_keys) if part_keys else first_row()
    new_run = new_part | (boundaries([(d, v) for d, v, _, _ in order_keys])
                          if order_keys else new_part)

    # per-row partition / peer-run start, and END: the position before the NEXT
    # boundary; dead rows sort to the global end, so ends stop at the last LIVE row or
    # a whole/range-frame gather would land on a dead padded slot
    part_start, part_next = _run_bounds(new_part, arange, n)
    run_start, run_next = _run_bounds(new_run, arange, n)
    last_live = torch.clamp(live_s.to(torch.int64).sum() - 1, 0, n - 1)
    run_end = torch.minimum(torch.clamp(run_next - 1, 0, n - 1), last_live)
    part_end = torch.minimum(torch.clamp(part_next - 1, 0, n - 1), last_live)
    zero = torch.zeros((), dtype=torch.int64, device=device)

    out = []
    for spec in specs:
        if spec.kind == "row_number":
            out.append((arange - part_start + 1, None))
            continue
        if spec.kind == "rank":
            out.append((run_start - part_start + 1, None))
            continue
        if spec.kind == "dense_rank":
            c = torch.cumsum(new_run.to(torch.int64), 0)
            out.append((c - c[torch.clamp(part_start, 0, n - 1)] + 1, None))
            continue

        d, v = inputs[spec.arg]
        d_s = d[order]
        v_s = v[order] if v is not None else None
        present = live_s if v_s is None else (live_s & v_s)

        if spec.kind in ("lag", "lead"):
            idx = arange - spec.offset if spec.kind == "lag" else arange + spec.offset
            in_part = (idx >= part_start) & (idx <= part_end)
            idxc = torch.clamp(idx, 0, n - 1)
            out.append((d_s[idxc], in_part & present[idxc]))
            continue
        if spec.kind == "first_value":
            pos = torch.clamp(part_start, 0, n - 1)
            out.append((d_s[pos], present[pos]))
            continue
        if spec.kind == "last_value":
            pos = (run_end if spec.frame == "range" else
                   part_end if spec.frame == "whole" else arange)
            pos = torch.clamp(pos, 0, n - 1)
            out.append((d_s[pos], present[pos]))
            continue

        # aggregates over the frame
        if spec.kind == "count":
            masked = present.to(torch.int64)
        elif spec.kind == "sum":
            if d_s.dtype.is_floating_point:
                masked = torch.where(present, d_s, torch.zeros((), dtype=d_s.dtype,
                                                               device=device))
            else:
                masked = torch.where(present, d_s.to(torch.int64), zero)
        elif spec.kind in ("min", "max"):
            masked = torch.where(present, d_s, torch.full_like(d_s, _neutral(d_s.dtype,
                                                                             spec.kind)))
        else:
            raise ValueError(f"unknown window kind {spec.kind}")

        if spec.kind in ("min", "max"):
            running = _segmented_scan(masked, new_part, spec.kind == "min")
            nonempty_run = _segmented_scan(present.to(torch.int8), new_part, False) > 0
        else:
            c = torch.cumsum(masked, 0)
            prev = torch.clamp(part_start - 1, 0, n - 1)
            running = c - torch.where(part_start > 0, c[prev], torch.zeros_like(c[prev]))
            cp = torch.cumsum(present.to(torch.int64), 0)
            nonempty_run = (cp - torch.where(part_start > 0, cp[prev], zero)) > 0

        pos = (run_end if spec.frame == "range" else
               part_end if spec.frame == "whole" else arange)
        pos = torch.clamp(pos, 0, n - 1)
        data = running[pos]
        out.append((data, None) if spec.kind == "count" else (data, nonempty_run[pos]))
    return order, live_s, out
