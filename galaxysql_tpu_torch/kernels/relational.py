"""Core relational kernels over fixed-shape torch tensors.

Counterpart of `galaxysql_tpu/kernels/relational.py`, trimmed to the formulations the
port runs.  The reference picks a formulation per backend (`prefer_scatter`): hash and
scatter on XLA:CPU, sort and matmul on a TPU.  Scatters and atomics are cheap on a GPU,
so the port takes the scatter branch on every device:

- group-by: `scatter_groupby` for small static key domains (dictionary strings,
  booleans, global aggregation), `hash_groupby` (open-addressing placement) otherwise;
- hash join: a slot-table CSR over the build side, a gather probe and a scatter
  expansion (`hash_join_build_slots`, `hash_join_probe_csr`);
- window functions: a stable sort by (partition, order) keys, then cumulative scans
  and boundary gathers over the partition and peer runs (`window_eval`).

The skew-aware hybrid join of `parallel/mpp.py` classifies rows with `hot_key_mask`
and probes its unioned lanes with `hash_join_probe_hybrid`, the same CSR pipeline.

The four kernel call sites — build-row slots, probe-row slots, pair expansion and group
placement — go through `cuda_join` / `cuda_agg`, whose wrappers launch the hand-written
CUDA kernel for a CUDA tensor and run the plain version for a CPU tensor.  Output
capacities are arguments; kernels report `overflow` so the caller can re-bucket and
retry.  Dead rows ride `live` masks and are never compacted implicitly.
"""

from __future__ import annotations

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


def prefer_scatter() -> bool:
    """The scatter formulations run on every device of the port (see module doc)."""
    return True


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
                 max_rounds: int = 64) -> GroupByResult:
    """General grouped aggregation via open-addressing hash slots — no sort.

    Group ids come from `cuda_agg.hash_place` (the placement kernel); aggregation is
    a scatter by slot.  Output slots are in hash order, not compacted — `live` marks
    real groups.  `overflow` is True when placement fails within `max_rounds`;
    callers retry with doubled `max_groups`."""
    n = live.shape[0] if not keys else keys[0][0].shape[0]
    device = live.device
    cap = max(16, min(max_groups, n))
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


def groupby(keys, inputs, specs, live, max_groups, domains=None):
    """Grouped aggregation dispatch: dense slots for small static domains (and global
    aggregation), hash placement otherwise."""
    if domains is None and not keys:
        domains = []  # global aggregation: one dense slot, never hash
    if domains is not None:
        return scatter_groupby(keys, inputs, specs, live, domains)
    return hash_groupby(keys, inputs, specs, live, max_groups)


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
    """Equi-join match enumeration: verified (build, probe) index pairs, through the
    slot-table CSR formulation.  NULL join keys never match."""
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
    slots = torch.arange(cap, dtype=torch.int64, device=device)
    if npr == 0:
        zero = torch.zeros(cap, dtype=torch.int64, device=device)
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return JoinPairs(zero, zero, torch.zeros(cap, dtype=torch.bool, device=device),
                         torch.zeros(0, dtype=torch.bool, device=device), empty, empty,
                         False)

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
