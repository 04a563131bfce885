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
