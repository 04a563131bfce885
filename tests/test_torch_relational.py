"""The port's relational formulations against `galaxysql_tpu.kernels.relational` on
the CPU: `hash_groupby`, `scatter_groupby` and `hash_join_pairs` (slot-table CSR
formulation) return bit-identical slot layouts, aggregates, pair layouts and
overflow flags on the same seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galaxysql_tpu.kernels import relational as R
from galaxysql_tpu_torch.kernels import relational as TR

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    assert np.array_equal(ref, got.astype(ref.dtype))


def _same_lanes(ref_lanes, got_lanes):
    assert len(ref_lanes) == len(got_lanes)
    for (rd, rv), (gd, gv) in zip(ref_lanes, got_lanes):
        _same(rd, gd)
        assert (rv is None) == (gv is None)
        if rv is not None:
            _same(rv, gv)


def _groupby_inputs(case, rng, n):
    live = rng.random(n) > 0.1
    if case == "dup_int64":
        keys = [(rng.integers(0, 53, n).astype(np.int64), None)]
    elif case == "nulls_multi":
        keys = [(rng.integers(-20, 20, n).astype(np.int32), rng.random(n) > 0.2),
                (rng.integers(0, 5, n).astype(np.int64), None)]
    elif case == "dates_and_ints":  # the Q3 shape: (orderkey, orderdate, shippriority)
        keys = [(rng.integers(1, 4000, n).astype(np.int64), None),
                (rng.integers(8000, 10000, n).astype(np.int32), None),
                (np.zeros(n, np.int32), None)]
    else:
        raise ValueError(case)
    v = rng.integers(-10_000, 10_000, n).astype(np.int64)
    inputs = [(v, rng.random(n) > 0.05), (rng.integers(0, 99, n).astype(np.int32), None)]
    specs = [R.AggSpec("sum", 0), R.AggSpec("count", 0), R.AggSpec("count_star", -1),
             R.AggSpec("min", 1), R.AggSpec("max", 0)]
    return keys, inputs, specs, live


@pytest.mark.parametrize("mode", ["off", "pallas"])  # reference formulation / Pallas
@pytest.mark.parametrize("case", ["dup_int64", "nulls_multi", "dates_and_ints"])
@pytest.mark.parametrize("max_groups,rounds", [(4096, 64), (16, 4)])
def test_hash_groupby(case, max_groups, rounds, mode):
    rng = np.random.default_rng(21)
    n = 1024
    keys, inputs, specs, live = _groupby_inputs(case, rng, n)
    with R.kernel_scope(mode):
        ref = R.hash_groupby([(_j(d), _j(v)) for d, v in keys],
                             [(_j(d), _j(v)) for d, v in inputs], specs, _j(live),
                             max_groups, rounds)
    tspecs = [TR.AggSpec(s.kind, s.arg) for s in specs]
    got = TR.hash_groupby([(_t(d), _t(v)) for d, v in keys],
                          [(_t(d), _t(v)) for d, v in inputs], tspecs, _t(live),
                          max_groups, rounds)
    assert bool(ref.overflow) == bool(got.overflow)
    _same(ref.live, got.live)
    _same(ref.num_groups, got.num_groups)
    _same_lanes(ref.keys, got.keys)
    _same_lanes(ref.aggs, got.aggs)


@pytest.mark.parametrize("nullable", [False, True])
def test_scatter_groupby(nullable):
    rng = np.random.default_rng(22)
    n = 3000
    live = rng.random(n) > 0.1
    keys = [(rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.1 if nullable else None),
            (rng.integers(0, 2, n).astype(np.int32), None)]
    domains = [3, 2]
    inputs = [(rng.integers(0, 10_000, n).astype(np.int64), None),
              (rng.integers(-5, 5, n).astype(np.int64), rng.random(n) > 0.3)]
    specs = [R.AggSpec("sum", 0), R.AggSpec("count_star", -1), R.AggSpec("count", 1),
             R.AggSpec("min", 1), R.AggSpec("max", 1), R.AggSpec("sum", 1)]
    ref = R.scatter_groupby([(_j(d), _j(v)) for d, v in keys],
                            [(_j(d), _j(v)) for d, v in inputs], specs, _j(live), domains)
    got = TR.scatter_groupby([(_t(d), _t(v)) for d, v in keys],
                             [(_t(d), _t(v)) for d, v in inputs],
                             [TR.AggSpec(s.kind, s.arg) for s in specs], _t(live), domains)
    _same(ref.live, got.live)
    _same(ref.num_groups, got.num_groups)
    _same_lanes(ref.keys, got.keys)
    _same_lanes(ref.aggs, got.aggs)


def test_global_aggregation_is_one_dense_slot():
    rng = np.random.default_rng(23)
    n = 500
    live = rng.random(n) > 0.5
    inputs = [(rng.integers(0, 100, n).astype(np.int64), None)]
    specs = [R.AggSpec("sum", 0), R.AggSpec("count_star", -1)]
    ref = R.groupby([], [(_j(d), _j(v)) for d, v in inputs], specs, _j(live), 1024)
    got = TR.groupby([], [(_t(d), _t(v)) for d, v in inputs],
                     [TR.AggSpec(s.kind, s.arg) for s in specs], _t(live), 1024)
    _same(ref.live, got.live)
    _same_lanes(ref.aggs, got.aggs)


def _join_inputs(case, rng):
    nb, npr = 512, 1024
    if case == "dup_nulls":
        bk = [(rng.integers(0, 37, nb).astype(np.int64), rng.random(nb) > 0.1)]
        pk = [(rng.integers(0, 50, npr).astype(np.int64), rng.random(npr) > 0.1)]
    elif case == "negative_int32":
        bk = [(rng.integers(-300, 300, nb).astype(np.int32), None)]
        pk = [(rng.integers(-400, 400, npr).astype(np.int32), None)]
    elif case == "two_lanes":
        bk = [(rng.integers(0, 20, nb).astype(np.int32), None),
              (rng.integers(0, 5, nb).astype(np.int64), None)]
        pk = [(rng.integers(0, 25, npr).astype(np.int32), None),
              (rng.integers(0, 5, npr).astype(np.int64), None)]
    else:
        raise ValueError(case)
    return bk, pk, rng.random(nb) > 0.1, rng.random(npr) > 0.1


@pytest.mark.parametrize("mode", ["off", "pallas"])
@pytest.mark.parametrize("case", ["dup_nulls", "negative_int32", "two_lanes"])
@pytest.mark.parametrize("cap", [1 << 15, 256])  # 256: overflows (ladder contract)
def test_hash_join_pairs(case, cap, mode):
    rng = np.random.default_rng(24)
    bk, pk, b_live, p_live = _join_inputs(case, rng)
    with R.kernel_scope(mode):
        ref = R.hash_join_pairs([(_j(d), _j(v)) for d, v in bk],
                                [(_j(d), _j(v)) for d, v in pk], _j(b_live), _j(p_live),
                                cap)
    got = TR.hash_join_pairs([(_t(d), _t(v)) for d, v in bk],
                             [(_t(d), _t(v)) for d, v in pk], _t(b_live), _t(p_live), cap)
    assert bool(ref.overflow) == bool(got.overflow)
    assert bool(got.overflow) == (cap == 256)
    for name in ("build_idx", "probe_idx", "live", "probe_matched", "probe_starts",
                 "probe_offsets"):
        _same(getattr(ref, name), getattr(got, name))


def test_sort_and_limit():
    rng = np.random.default_rng(25)
    n = 1000
    a = rng.integers(-5, 5, n).astype(np.int64)
    av = rng.random(n) > 0.2
    b = rng.integers(0, 1000, n).astype(np.int32)
    live = rng.random(n) > 0.1
    keys_j = [(_j(a), _j(av), True, False), (_j(b), None, False, True)]
    keys_t = [(_t(a), _t(av), True, False), (_t(b), None, False, True)]
    _same(R.sort_indices(keys_j, _j(live)), TR.sort_indices(keys_t, _t(live)))
    _same(R.limit_mask(_j(live), 3, 17), TR.limit_mask(_t(live), 3, 17))
    order_j, n_j = R.compaction_order(_j(live))
    order_t, n_t = TR.compaction_order(_t(live))
    _same(order_j, order_t)
    assert int(n_j) == int(n_t)
