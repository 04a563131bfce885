"""The four kernels of the PyTorch/CUDA port, on the CPU: each plain version (what the
wrapper runs for a CPU tensor, and what the CUDA kernel is held against on the card)
must be bit-identical to the JAX package's reference formulation and to its Pallas
kernel in interpret mode, on the same seeded numpy inputs.

Edges: NULL key lanes, empty input, duplicate keys, dead rows, negative keys,
multi-lane keys, and the overflow ladder (a round limit too small to place every
group; a pair capacity below the pair count).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galaxysql_tpu.kernels import pallas_agg, pallas_join
from galaxysql_tpu.kernels import relational as R
from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join, hashing
from galaxysql_tpu_torch.kernels import relational as TR

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _key_lanes(case, rng, n):
    """Seeded (data, valid) numpy lanes for one key layout."""
    if case == "int64_dup":
        return [(rng.integers(0, 37, n).astype(np.int64), None)]
    if case == "int32_negative":
        return [(rng.integers(-1000, 1000, n).astype(np.int32), None)]
    if case == "nulls_two_lanes":
        return [(rng.integers(-50, 50, n).astype(np.int32), rng.random(n) > 0.25),
                (rng.integers(0, 1 << 40, n).astype(np.int64), None)]
    if case == "three_lanes":
        return [(rng.integers(0, 7, n).astype(np.int64), rng.random(n) > 0.1),
                (rng.integers(-3, 3, n).astype(np.int32), rng.random(n) > 0.1),
                (rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64), None)]
    raise ValueError(case)


KEY_CASES = ["int64_dup", "int32_negative", "nulls_two_lanes", "three_lanes"]


@pytest.mark.parametrize("case", KEY_CASES)
def test_hash_columns_bits(case):
    rng = np.random.default_rng(11)
    keys = _key_lanes(case, rng, 700)
    ref = np.asarray(R.hash_columns([(_j(d), _j(v)) for d, v in keys]))
    got = hashing.hash_columns([(_t(d), _t(v)) for d, v in keys]).numpy()
    assert np.array_equal(ref.view(np.int64), got)


@pytest.mark.parametrize("case", KEY_CASES + ["empty"])
def test_build_slots(case):
    rng = np.random.default_rng(12)
    n = 0 if case == "empty" else 600
    keys = _key_lanes("int64_dup" if case == "empty" else case, rng, n)
    live = rng.random(n) > 0.2  # dead rows
    eff = live.copy()
    for _, v in keys:
        if v is not None:
            eff &= v
    M = 1 << max(4, int(max(n, 1) * 4 - 1).bit_length())
    jkeys = [(_j(d), _j(v)) for d, v in keys]
    with R.kernel_scope("off"):
        ref = np.asarray(R.hash_join_build_slots(jkeys, _j(live), M))
    got = cuda_join.build_slots_plain([(_t(d), _t(v)) for d, v in keys], _t(eff), M)
    assert got.dtype == torch.int32
    assert np.array_equal(ref, got.numpy())
    # the wrapper on a CPU tensor takes the plain version and launches nothing
    before = cuda_join.LAUNCHES["build_slots"]
    assert torch.equal(cuda_join.build_slots([(_t(d), _t(v)) for d, v in keys],
                                             _t(eff), M), got)
    assert cuda_join.LAUNCHES["build_slots"] == before
    if n:
        with R.kernel_scope("pallas"):  # the Pallas kernel, interpret mode off-TPU
            pal = np.asarray(R.hash_join_build_slots(jkeys, _j(live), M))
        assert np.array_equal(pal, got.numpy())


@pytest.mark.parametrize("case", KEY_CASES + ["empty"])
def test_hash_slots(case):
    rng = np.random.default_rng(13)
    n = 0 if case == "empty" else 500
    keys = _key_lanes("int32_negative" if case == "empty" else case, rng, n)
    M = 1 << 12
    jkeys = [(_j(d), _j(v)) for d, v in keys]
    ref = np.asarray((R.hash_columns(jkeys) & jnp.uint64(M - 1)).astype(jnp.int32))
    got = cuda_join.hash_slots_plain([(_t(d), _t(v)) for d, v in keys], M)
    assert np.array_equal(ref, got.numpy())
    if n:
        pal = np.asarray(pallas_join.hash_slots(jkeys, M))
        assert np.array_equal(pal, got.numpy())


def _expand_inputs(case, rng):
    npr = 0 if case == "empty" else 400
    counts = rng.integers(0, 4, npr).astype(np.int64)
    if case == "all_zero":
        counts[:] = 0
    counts[rng.random(npr) < 0.3] = 0
    offsets = np.cumsum(counts)
    starts = offsets - counts
    total = int(offsets[-1]) if npr else 0
    cap = max(total // 2, 16) if case == "overflow" else total + 128
    return counts, starts, cap


@pytest.mark.parametrize("case", ["ragged", "overflow", "all_zero", "empty"])
def test_expand_offsets(case):
    rng = np.random.default_rng(14)
    counts, starts, cap = _expand_inputs(case, rng)
    npr = counts.shape[0]
    with R.kernel_scope("off"):
        ref = np.asarray(R._expand_offsets(_j(counts), _j(starts), npr, cap))
    got = cuda_join.expand_offsets_plain(_t(counts), _t(starts), cap)
    assert got.dtype == torch.int32
    assert np.array_equal(ref, got.numpy())
    if npr:
        with R.kernel_scope("pallas"):
            pal = np.asarray(R._expand_offsets(_j(counts), _j(starts), npr, cap))
        assert np.array_equal(pal, got.numpy())


def _place_keys(case, rng, n):
    if case == "float_keys":
        f = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25], np.float64), n)
        return [(f, rng.random(n) > 0.2)]
    if case == "overflow":
        return [(rng.permutation(n).astype(np.int64), None)]
    return _key_lanes(case, rng, n)


PLACE_CASES = [("int64_dup", 64), ("int32_negative", 64), ("nulls_two_lanes", 64),
               ("three_lanes", 64), ("float_keys", 64), ("overflow", 3), ("empty", 64)]


@pytest.mark.parametrize("case,rounds", PLACE_CASES)
def test_hash_place(case, rounds):
    rng = np.random.default_rng(15)
    n = 0 if case == "empty" else 256
    keys = _place_keys("int64_dup" if case == "empty" else case, rng, n)
    live = rng.random(n) > 0.15
    max_groups = 16 if case == "overflow" else 1024
    cap = max(16, min(max_groups, n))
    M = 1 << int(cap * 2 - 1).bit_length()
    jident = R._ident_lanes([(_j(d), _j(v)) for d, v in keys])
    h = R.hash_columns(jident)
    s0 = h & jnp.uint64(M - 1)
    step = ((h >> jnp.uint64(32)) << jnp.uint64(1)) | jnp.uint64(1)
    ref = R._hash_place(jident, _j(live), s0, step, M, rounds)

    tident = TR._ident_lanes([(_t(d), _t(v)) for d, v in keys])
    for (jd, jv), (td, tv) in zip(jident, tident):  # identity lanes agree bit for bit
        assert np.array_equal(np.asarray(jd), td.numpy())
    th = hashing.hash_columns(tident)
    ts0 = th & (M - 1)
    tstep = (hashing.lsr(th, 32) << 1) | 1
    assert np.array_equal(np.asarray(s0).view(np.int64), ts0.numpy())
    assert np.array_equal(np.asarray(step).view(np.int64), tstep.numpy())
    got = cuda_agg.hash_place_plain(tident, _t(live), ts0, tstep, M, rounds)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    if case == "overflow":
        assert not bool(got[1].all())  # the round limit leaves rows unplaced
    if n:
        pal = pallas_agg.hash_place(jident, _j(live), s0, step, M, rounds)
        for p, g in zip(pal, got):
            assert np.array_equal(np.asarray(p), g.numpy())


def test_wrappers_reject_what_the_kernel_does_not_take():
    """The CUDA-side argument checks run before any launch, so they hold here."""
    k = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_join.key_lane_args([(k, None)] * 9, 8, k.device)
    with pytest.raises(TypeError):
        cuda_join.key_lane_args([(k.to(torch.float32), None)], 8, k.device)
    with pytest.raises(ValueError):
        cuda_join.key_lane_args([(k[::2], None)], 4, k.device)  # not contiguous
    with pytest.raises(ValueError):
        cuda_join.check_lane(k, 9, k.device, "key lane")


# -- the kernels' designs, mirrored in plain torch/numpy -----------------------------
#
# The CUDA kernels run only on the card; these mirrors restate each kernel's algorithm
# on the CPU and hold it bit for bit against the plain version, the JAX reference
# formulation and the Pallas kernel in interpret mode.

def _prefix_starts(counts):
    offsets = np.cumsum(counts)
    return offsets - counts


def _expand_case(case, rng):
    """The `_expand_inputs` cases plus the segment fill's edges."""
    if case in ("ragged", "overflow", "all_zero", "empty"):
        return _expand_inputs(case, rng)
    counts = rng.integers(0, 4, 300).astype(np.int64)
    counts[rng.random(300) < 0.3] = 0
    if case == "hot_row":
        counts[137] = 100_000
    elif case == "leading_empty":
        counts[:90] = 0
    elif case == "trailing_empty":
        counts[-70:] = 0
    total = int(counts.sum())
    cap = {"hot_row": total + 64, "leading_empty": total + 32, "trailing_empty": total + 32,
           "total_eq_cap": total}.get(case)
    if case == "straddle_cap":  # the cap cuts one segment of 5 after its second pair
        counts[150] = 5
        cap = int(_prefix_starts(counts)[150]) + 2
    return counts, _prefix_starts(counts), cap


EXPAND_CASES = ["ragged", "overflow", "all_zero", "empty", "hot_row", "leading_empty",
                "trailing_empty", "total_eq_cap", "straddle_cap"]


def _expand_segment_fill(counts, starts, cap):
    """The kernel's result, stated directly: each row id repeated over its segment,
    the last non-empty row (0 if none) after the last segment, clipped at cap."""
    npr = counts.shape[0]
    rows = torch.repeat_interleave(torch.arange(npr, dtype=torch.int32), counts)
    nonempty = torch.nonzero(counts > 0).flatten()
    tail = int(nonempty[-1]) if nonempty.numel() else 0
    fill = torch.full((max(cap - rows.shape[0], 0),), tail, dtype=torch.int32)
    return torch.cat([rows, fill])[:cap]


def _warp_partition(lo, hi, pred):
    """`warp_partition` of csrc/expand_offsets.cu: 32 probes a step."""
    lanes = np.arange(1, 33, dtype=np.int64)
    while lo < hi:
        n = hi - lo
        c = int(pred(lo + n * lanes // 33).sum())
        nlo = lo + n * c // 33 + 1 if c > 0 else lo
        hi = lo + n * (c + 1) // 33 if c < 32 else hi
        lo = nlo
    return lo


def _expand_merge_path(counts, starts, cap, tile):
    """`segment_fill_kernel` of csrc/expand_offsets.cu, one tile of `tile` merge items
    (rows + slots) at a time; each slot must be written exactly once."""
    npr = counts.shape[0]
    total = int(starts[-1] + counts[-1]) if npr else 0
    out = np.full(cap, -2, np.int64)
    for d0 in range(0, npr + cap, tile):
        d1 = min(d0 + tile, npr + cap)
        a0, a1 = (_warp_partition(max(d - cap, 0), min(d, npr),
                                  lambda x, d=d: starts[x] <= d - 1 - x) for d in (d0, d1))
        b0, b1 = d0 - a0, d1 - a1
        assert 0 <= b1 - b0 <= tile and (a1 - a0) + (b1 - b0) == d1 - d0
        tail = 0
        if total < min(d1, cap):
            lb = _warp_partition(0, npr, lambda x: starts[x] < total)
            tail = lb - 1 if lb > 0 else 0
        mark = np.full(b1 - b0, -1, np.int64)
        for i in range(a0, a1):
            rel = starts[i] - b0
            if 0 <= rel < b1 - b0 and (i + 1 == a1 or starts[i + 1] != starts[i]):
                mark[rel] = i
        run = np.maximum(np.maximum.accumulate(mark) if mark.size else mark, a0 - 1)
        j = np.arange(b0, b1)
        assert (out[b0:b1] == -2).all()
        out[b0:b1] = np.where(j >= total, tail, np.maximum(run, 0))
    assert (out != -2).all()
    return out.astype(np.int32)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_offsets_segment_fill(case):
    rng = np.random.default_rng(16)
    counts, starts, cap = _expand_case(case, rng)
    npr = counts.shape[0]
    fill = _expand_segment_fill(_t(counts), _t(starts), cap)
    plain = cuda_join.expand_offsets_plain(_t(counts), _t(starts), cap)
    assert fill.dtype == plain.dtype and torch.equal(fill, plain)
    with R.kernel_scope("off"):
        ref = np.asarray(R._expand_offsets(_j(counts), _j(starts), npr, cap))
    assert np.array_equal(ref, fill.numpy())
    if npr and cap:
        with R.kernel_scope("pallas"):
            pal = np.asarray(R._expand_offsets(_j(counts), _j(starts), npr, cap))
        assert np.array_equal(pal, fill.numpy())


@pytest.mark.parametrize("tile", [8, 64, 4096])
@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_offsets_merge_path_tiles(case, tile):
    rng = np.random.default_rng(16)
    counts, starts, cap = _expand_case(case, rng)
    got = _expand_merge_path(counts, starts, cap, tile)
    assert np.array_equal(got, cuda_join.expand_offsets_plain(_t(counts), _t(starts),
                                                              cap).numpy())


def test_expand_offsets_precondition_holds_at_its_call_site(monkeypatch):
    """The kernel's segment fill needs starts == exclusive prefix sum of counts; the
    join's probe builds them so, over duplicates, NULL keys, dead rows and an
    overflowing pair capacity."""
    seen = []
    plain = cuda_join.expand_offsets

    def recording(counts, starts, cap):
        seen.append((counts.clone(), starts.clone(), cap))
        return plain(counts, starts, cap)

    monkeypatch.setattr(cuda_join, "expand_offsets", recording)
    rng = np.random.default_rng(17)
    nb, npr = 300, 500
    bkeys = [(_t(rng.integers(-20, 20, nb).astype(np.int64)), _t(rng.random(nb) > 0.1))]
    pkeys = [(_t(rng.integers(-25, 25, npr).astype(np.int64)), _t(rng.random(npr) > 0.1))]
    blive, plive = _t(rng.random(nb) > 0.2), _t(rng.random(npr) > 0.2)
    for cap in (1 << 14, 64):
        TR.hash_join_pairs(bkeys, pkeys, blive, plive, cap)
    perm, sst, scnt, M = TR._device_csr(bkeys, blive, nb)
    TR.hash_join_probe_csr(bkeys, pkeys, blive, plive, perm, sst, scnt, M, 256)
    assert len(seen) == 3
    for counts, starts, cap in seen:
        assert int(starts[0]) == 0
        assert torch.equal(starts[1:], starts[:-1] + counts[:-1])
        assert bool((counts >= 0).all())


def _place_round_stamped(ident, live, s0, step, M, max_rounds):
    """`place_kernel` of csrc/hash_place.cu: round-stamped election (a min over
    `r << 32 | row` per slot, no occupancy snapshot) over a worklist of the rows
    still unresolved."""
    n = live.shape[0]
    empty = torch.iinfo(torch.int64).max  # the kernel's all-ones uint64
    own = torch.full((M,), empty, dtype=torch.int64)
    resolved = ~live
    gid = torch.zeros(n, dtype=torch.int32)
    work = torch.nonzero(live).flatten()
    r = 0
    while r < max_rounds and work.numel():
        s = (s0[work] + r * step[work]) & (M - 1)
        own.scatter_reduce_(0, s, (r << 32) | work, reduce="amin", include_self=True)
        owner = own[s] & 0xFFFFFFFF
        same = torch.ones(work.shape[0], dtype=torch.bool)
        for d, valid in ident:
            same &= d[owner] == d[work]
            if valid is not None:
                same &= valid[owner] == valid[work]
        resolved[work[same]] = True
        gid[work[same]] = s[same].to(torch.int32)
        work = work[~same]
        r += 1
    rep = torch.where(own == empty, torch.full_like(own, n), own & 0xFFFFFFFF)
    return rep.to(torch.int32), resolved, gid


@pytest.mark.parametrize("case,rounds", PLACE_CASES + [("chain", 128), ("chain", 40)])
def test_hash_place_round_stamped(case, rounds):
    rng = np.random.default_rng(18)
    n = 0 if case == "empty" else 256
    if case == "chain":
        # 100 distinct keys, 3 rows each, every row on the same probe walk: round r
        # places exactly key r, so 40 rounds leave 60 keys unplaced
        n, M = 300, 512
        keys = [((np.arange(n) // 3).astype(np.int64), None)]
        live = np.ones(n, np.bool_)
        s0 = np.full(n, 5, np.uint64)
        step = np.full(n, 35, np.uint64)
        jident = R._ident_lanes([(_j(d), _j(v)) for d, v in keys])
        js0, jstep = _j(s0), _j(step)
    else:
        keys = _place_keys("int64_dup" if case == "empty" else case, rng, n)
        live = rng.random(n) > 0.15
        cap = max(16, min(16 if case == "overflow" else 1024, n))
        M = 1 << int(cap * 2 - 1).bit_length()
        jident = R._ident_lanes([(_j(d), _j(v)) for d, v in keys])
        h = R.hash_columns(jident)
        js0 = h & jnp.uint64(M - 1)
        jstep = ((h >> jnp.uint64(32)) << jnp.uint64(1)) | jnp.uint64(1)
    ts0 = torch.from_numpy(np.array(js0).view(np.int64))
    tstep = torch.from_numpy(np.array(jstep).view(np.int64))
    tident = TR._ident_lanes([(_t(d), _t(v)) for d, v in keys])
    got = _place_round_stamped(tident, _t(live), ts0, tstep, M, rounds)
    plain = cuda_agg.hash_place_plain(tident, _t(live), ts0, tstep, M, rounds)
    ref = R._hash_place(jident, _j(live), js0, jstep, M, rounds)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == p.dtype and torch.equal(g, p)
        assert np.array_equal(np.asarray(r), g.numpy())
    if case == "chain":
        assert int(got[1].sum()) == min(rounds, 100) * 3
    if n:
        pal = pallas_agg.hash_place(jident, _j(live), js0, jstep, M, rounds)
        for p, g in zip(pal, got):
            assert np.array_equal(np.asarray(p), g.numpy())
