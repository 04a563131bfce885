"""The reference's accelerator formulations in the port, against the JAX package on
the CPU.

The reference picks its formulation by backend (`prefer_scatter()`): hash and scatter
on XLA:CPU, sort and matmul on a TPU.  The port runs the scatter branch by default on
every device and the sort branch inside `formulation_scope("sort")`.  Held here:

- `sort_groupby`, `matmul_groupby`, `_hash_join_pairs_sorted` and
  `bloom_query_device` against the JAX functions of the same name on seeded inputs
  (the reference's own cases among them): integers, slots, pairs, starts, offsets and
  flags bit for bit; a float SUM of `sort_groupby` (a difference of two running
  float32 sums on both sides, summed in different orders) within
  4 * n * 2^-24 * sum(|x|), twice the standard bound of a float32 running sum;
- the host-built bloom words against the reference's `native.bloom_build`, with its
  shared library and with its numpy path;
- the `groupby` and `hash_join_pairs` dispatch against the reference's, whose TPU
  branch runs in a fresh process (`prefer_scatter` patched there), so no jit cache
  built under one branch answers for the other;
- whole statements under the scope: the 22 TPC-H queries at SF 0.01 and MPP queries
  on an 8-shard CPU mesh equal to the JAX package, with the sort formulations
  reached and the four kernel call sites of the scatter branch not (but for the
  hybrid probe), the GROUP BY retry ladder on `sort_groupby`'s overflow, and the
  fragment cache keeping the branches' artifacts apart.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxysql_tpu import native as jax_native
from galaxysql_tpu.kernels import relational as R
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch import native
from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
from galaxysql_tpu_torch.kernels import relational as K
from test_torch_mpp import TPCH_ORDERED, assert_same, _pair, run_port
from test_torch_tpch import _engine_pair

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_EPS = 2.0 ** -24


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(ref, got):
    """Equal values; floats bit for bit (NaN payloads and the sign of zero too)."""
    ref, got = np.asarray(ref), _np(got)
    assert ref.shape == got.shape
    if np.issubdtype(ref.dtype, np.floating):
        assert got.dtype == ref.dtype
        ref, got = ref.view(f"u{ref.itemsize}"), got.view(f"u{ref.itemsize}")
    assert np.array_equal(ref, got.astype(ref.dtype))


def _same_lanes(ref_lanes, got_lanes, float_bound=None):
    assert len(ref_lanes) == len(got_lanes)
    for (rd, rv), (gd, gv) in zip(ref_lanes, got_lanes):
        rd = np.asarray(rd)
        if float_bound is not None and np.issubdtype(rd.dtype, np.floating):
            gd = _np(gd)
            assert rd.shape == gd.shape and rd.dtype == gd.dtype
            assert np.all(np.abs(rd.astype(np.float64) - gd.astype(np.float64))
                          <= float_bound)
        else:
            _same(rd, gd)
        assert (rv is None) == (gv is None)
        if rv is not None:
            _same(rv, gv)


def _same_result(ref, got, float_bound=None):
    assert bool(ref.overflow) == bool(got.overflow)
    _same(ref.live, got.live)
    _same(ref.num_groups, got.num_groups)
    _same_lanes(ref.keys, got.keys)
    _same_lanes(ref.aggs, got.aggs, float_bound)


def _both(keys, inputs, live):
    """The lanes as JAX arrays and as CPU tensors."""
    return ([(_j(d), _j(v)) for d, v in keys], [(_j(d), _j(v)) for d, v in inputs],
            _j(live)), ([(_t(d), _t(v)) for d, v in keys],
                        [(_t(d), _t(v)) for d, v in inputs], _t(live))


def _tspecs(specs):
    return [K.AggSpec(s.kind, s.arg) for s in specs]


SPECS = [R.AggSpec("sum", 0), R.AggSpec("count", 0), R.AggSpec("count_star", -1),
         R.AggSpec("min", 0), R.AggSpec("max", 0)]


# -- the scope ------------------------------------------------------------------------

def test_scope_is_the_only_switch_and_thread_local():
    assert K.prefer_scatter() and K.formulation() == "scatter"
    seen = {}
    with K.formulation_scope("sort"):
        assert not K.prefer_scatter() and K.formulation() == "sort"
        t = threading.Thread(target=lambda: seen.update(other=K.prefer_scatter()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        with K.formulation_scope("scatter"):
            assert K.prefer_scatter()
        assert not K.prefer_scatter()
    assert seen == {"other": True}
    assert K.prefer_scatter()
    with pytest.raises(RuntimeError):
        with K.formulation_scope("sort"):
            raise RuntimeError("leaves the scope")
    assert K.prefer_scatter()
    with pytest.raises(ValueError):
        with K.formulation_scope("matmul"):
            pass
    # no module of the port enters the scope: no hint, parameter or environment
    # variable reaches it
    pkg = os.path.join(ROOT, "galaxysql_tpu_torch")
    users = []
    for base, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    text = fh.read()
                if "formulation_scope(" in text or "_FORMULATION_TLS.name =" in text:
                    users.append(os.path.relpath(path, pkg))
    assert users == [os.path.join("kernels", "relational.py")]


# -- sort_groupby -----------------------------------------------------------------------

def _sort_case(case):
    """(keys, inputs, specs, live, max_groups) of one case, from a numpy seed."""
    rng = np.random.default_rng(41)
    if case == "hash_groupby_mk":  # tests/test_cpu_kernels.py:37-46, 48-54
        n = 30_000
        keys = [(rng.integers(-1000, 1000, n), rng.random(n) > 0.1),
                (rng.integers(0, 7, n).astype(np.int32), None)]
        inputs = [(rng.integers(-10**12, 10**12, n), rng.random(n) > 0.2)]
        return keys, inputs, SPECS, rng.random(n) > 0.15, 20_000
    if case == "overflow":  # tests/test_cpu_kernels.py:56-62
        n = 4096
        return ([(np.arange(n, dtype=np.int64), None)], [(np.ones(n, np.int64), None)],
                [R.AggSpec("sum", 0)], np.ones(n, bool), 128)
    if case == "float_keys":  # tests/test_cpu_kernels.py:64-72, NaN payloads too
        nan2 = np.array([0x7FF8000000000123], dtype=np.uint64).view(np.float64)[0]
        f = np.array([np.nan, np.nan, -0.0, 0.0, 1.5, 1.5, np.nan, -np.nan, nan2, 0.0,
                      -0.0, -1.5])
        n = f.shape[0]
        return ([(f, None)], [(np.arange(n, dtype=np.int64), None)],
                [R.AggSpec("count_star", -1), R.AggSpec("sum", 0), R.AggSpec("min", 0)],
                np.ones(n, bool), 16)
    if case == "float32_keys_nullable":
        n = 3000
        f = rng.choice(np.array([np.nan, -0.0, 0.0, 2.5, -2.5, np.inf], np.float32), n)
        return ([(f, rng.random(n) > 0.2)],
                [(rng.integers(-50, 50, n).astype(np.int32), None)],
                [R.AggSpec("count_star", -1), R.AggSpec("max", 0), R.AggSpec("sum", 0)],
                rng.random(n) > 0.1, 4096)
    if case == "int64_beyond_f64":  # tests/test_cpu_kernels.py:74-82
        big = 1 << 60
        return ([(np.zeros(4, np.int32), None)],
                [(np.array([big, big, big, -5], np.int64), None)],
                [R.AggSpec("sum", 0)], np.ones(4, bool), 16)
    if case == "all_dead":  # tests/test_cpu_kernels.py:84-90
        n = 64
        return ([(np.zeros(n, np.int64), None)], [(np.zeros(n, np.int64), None)],
                SPECS, np.zeros(n, bool), 16)
    if case == "global":
        n = 500
        return ([], [(rng.integers(0, 100, n).astype(np.int64), None)],
                [R.AggSpec("sum", 0), R.AggSpec("count_star", -1), R.AggSpec("min", 0)],
                rng.random(n) > 0.5, 16)
    if case == "bool_and_dates":  # a boolean key and the Q3 shape
        n = 5000
        keys = [(rng.random(n) > 0.5, rng.random(n) > 0.1),
                (rng.integers(1, 400, n).astype(np.int64), None),
                (rng.integers(8000, 8100, n).astype(np.int32), None)]
        inputs = [(rng.integers(-10_000, 10_000, n).astype(np.int64), None),
                  (rng.integers(0, 99, n).astype(np.int32), rng.random(n) > 0.3)]
        specs = [R.AggSpec("sum", 0), R.AggSpec("count", 1), R.AggSpec("min", 1),
                 R.AggSpec("max", 1), R.AggSpec("count_star", -1)]
        return keys, inputs, specs, rng.random(n) > 0.1, 8192
    if case == "float_sum":
        n = 20_000
        keys = [(rng.integers(0, 300, n).astype(np.int64), None)]
        inputs = [(rng.uniform(-100, 100, n).astype(np.float32), rng.random(n) > 0.1)]
        specs = [R.AggSpec("sum", 0), R.AggSpec("min", 0), R.AggSpec("max", 0),
                 R.AggSpec("count", 0)]
        return keys, inputs, specs, rng.random(n) > 0.1, 512
    raise ValueError(case)


def _float_bound(inputs, specs, live):
    """4 * n * 2^-24 * sum(|x|) over the float SUM inputs: twice the bound on a
    running float32 sum's error, for the two running sums each side differences."""
    bound = 0.0
    for s in specs:
        d = inputs[s.arg][0] if s.arg >= 0 else None
        if s.kind == "sum" and d is not None and np.issubdtype(d.dtype, np.floating):
            bound = max(bound, 4 * d.shape[0] * F32_EPS *
                        float(np.abs(d[live].astype(np.float64)).sum()))
    return bound


@pytest.mark.parametrize("case", ["hash_groupby_mk", "overflow", "float_keys",
                                  "float32_keys_nullable", "int64_beyond_f64",
                                  "all_dead", "global", "bool_and_dates", "float_sum"])
def test_sort_groupby(case):
    keys, inputs, specs, live, max_groups = _sort_case(case)
    (jk, ji, jl), (tk, ti, tl) = _both(keys, inputs, live)
    ref = jax.jit(R.sort_groupby, static_argnums=(2, 4))(jk, ji, tuple(specs), jl,
                                                         max_groups)
    got = K.sort_groupby(tk, ti, _tspecs(specs), tl, max_groups)
    assert bool(got.overflow) == (case == "overflow")
    _same_result(ref, got, _float_bound(inputs, specs, live))
    if case == "float_keys":  # SQL GROUP BY: -0.0 == 0.0; NaN != NaN in a sort
        assert int(got.num_groups) == 8


# -- matmul_groupby ---------------------------------------------------------------------

def _matmul_case(case):
    rng = np.random.default_rng(43)
    if case in ("nulls_and_negatives", "chunked"):  # tests/test_matmul_agg.py:35-50
        n = 5000
        keys = [(rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.1),
                (rng.integers(0, 2, n).astype(np.int32), None)]
        inputs = [(rng.integers(-10**12, 10**12, n).astype(np.int64),
                   rng.random(n) > 0.2)]
        return keys, inputs, SPECS, rng.random(n) > 0.15, [3, 2]
    if case == "scatter_twin":  # tests/test_cpu_kernels.py:93-108
        n = 8000
        keys = [(rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.1),
                (rng.integers(0, 2, n).astype(np.int32), None)]
        inputs = [(rng.integers(-10**11, 10**11, n), rng.random(n) > 0.2)]
        return keys, inputs, SPECS, rng.random(n) > 0.15, [3, 2]
    if case == "int64_wraparound":  # tests/test_matmul_agg.py:52-61
        big = 1 << 60
        return ([(np.zeros(4, np.int32), None)],
                [(np.array([big, big, big, -5], np.int64), None)],
                [R.AggSpec("sum", 0)], np.ones(4, bool), [1])
    if case == "global_domain_one":  # tests/test_matmul_agg.py:63-71
        x = np.arange(100, dtype=np.int64)
        return ([], [(x, None)], [R.AggSpec("sum", 0), R.AggSpec("count_star", -1)],
                np.arange(100) % 2 == 0, [])
    if case == "empty_input":  # tests/test_matmul_agg.py:73-80
        return ([(np.zeros(16, np.int32), None)], [(np.zeros(16, np.int64), None)],
                [R.AggSpec("sum", 0)], np.zeros(16, bool), [4])
    if case == "q1_shape":  # two dictionary keys, several sums, float min/max
        n = 20_000
        keys = [(rng.integers(0, 3, n).astype(np.int32), None),
                (rng.integers(0, 2, n).astype(np.int32), None)]
        inputs = [(rng.integers(1, 5100, n).astype(np.int64), None),
                  (rng.integers(90_000, 10_500_000, n).astype(np.int64), None),
                  (rng.integers(0, 11, n).astype(np.int64), rng.random(n) > 0.05),
                  (rng.uniform(-1, 1, n).astype(np.float32), None)]
        specs = [R.AggSpec("sum", 0), R.AggSpec("sum", 1), R.AggSpec("sum", 2),
                 R.AggSpec("count", 2), R.AggSpec("count_star", -1),
                 R.AggSpec("min", 3), R.AggSpec("max", 3), R.AggSpec("min", 1)]
        return keys, inputs, specs, rng.random(n) > 0.02, [3, 2]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["nulls_and_negatives", "chunked", "scatter_twin",
                                  "int64_wraparound", "global_domain_one",
                                  "empty_input", "q1_shape"])
def test_matmul_groupby(case, monkeypatch):
    keys, inputs, specs, live, domains = _matmul_case(case)
    if case == "chunked":  # several contractions and min/max slabs per call
        monkeypatch.setattr(K, "MATMUL_CHUNK", 1000)
        monkeypatch.setattr(K, "MATMUL_MINMAX_CELLS", 700)
    (jk, ji, jl), (tk, ti, tl) = _both(keys, inputs, live)
    ref = jax.jit(R.matmul_groupby, static_argnums=(2, 4))(jk, ji, tuple(specs), jl,
                                                           tuple(domains))
    got = K.matmul_groupby(tk, ti, _tspecs(specs), tl, domains)
    assert not bool(got.overflow)
    _same_result(ref, got)
    if case == "int64_wraparound":
        assert int(got.aggs[0][0][0]) == int(np.int64(1 << 60) * 3 - 5)


# -- the sorted join --------------------------------------------------------------------

def _join_case(case):
    rng = np.random.default_rng(45)
    if case == "table_twin":  # tests/test_cpu_kernels.py:124-143
        nb, npr = 2048, 20_000
        return ([(rng.integers(0, 1500, nb), rng.random(nb) > 0.1)],
                [(rng.integers(0, 1500, npr), rng.random(npr) > 0.1)],
                rng.random(nb) > 0.2, rng.random(npr) > 0.2, 1 << 18)
    if case == "empty_build":  # :145-151
        nb, npr = 64, 256
        return ([(np.zeros(nb, np.int64), None)], [(np.zeros(npr, np.int64), None)],
                np.zeros(nb, bool), np.ones(npr, bool), 1024)
    if case == "overflow":  # :153-159
        return ([(np.zeros(128, np.int64), None)], [(np.zeros(128, np.int64), None)],
                np.ones(128, bool), np.ones(128, bool), 256)
    if case == "high_hashes_dead_rows":  # full-range keys: half the hashes >= 2^63
        nb, npr = 3000, 5000
        keys = rng.integers(-2**63, 2**63 - 1, 1200, dtype=np.int64)
        bk = rng.choice(keys, nb)
        pk = np.concatenate([rng.choice(keys, npr // 2),
                             rng.integers(-2**63, 2**63 - 1, npr - npr // 2,
                                          dtype=np.int64)])
        return ([(bk, None)], [(pk, None)], rng.random(nb) > 0.3, rng.random(npr) > 0.1,
                1 << 14)
    if case == "two_lanes_nulls":
        nb, npr = 700, 1500
        return ([(rng.integers(0, 20, nb).astype(np.int32), rng.random(nb) > 0.1),
                 (rng.integers(0, 5, nb).astype(np.int64), None)],
                [(rng.integers(0, 25, npr).astype(np.int32), None),
                 (rng.integers(0, 5, npr).astype(np.int64), rng.random(npr) > 0.1)],
                rng.random(nb) > 0.1, rng.random(npr) > 0.1, 1 << 15)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["table_twin", "empty_build", "overflow",
                                  "high_hashes_dead_rows", "two_lanes_nulls"])
def test_hash_join_pairs_sorted(case):
    bk, pk, b_live, p_live, cap = _join_case(case)
    ref = jax.jit(R._hash_join_pairs_sorted, static_argnums=(4,))(
        [(_j(d), _j(v)) for d, v in bk], [(_j(d), _j(v)) for d, v in pk], _j(b_live),
        _j(p_live), cap)
    got = K._hash_join_pairs_sorted([(_t(d), _t(v)) for d, v in bk],
                                    [(_t(d), _t(v)) for d, v in pk], _t(b_live),
                                    _t(p_live), cap)
    assert bool(ref.overflow) == bool(got.overflow) == (case == "overflow")
    for name in ("build_idx", "probe_idx", "live", "probe_matched", "probe_starts",
                 "probe_offsets"):
        _same(getattr(ref, name), getattr(got, name))
    if case == "high_hashes_dead_rows":
        h = _np(K.hash_columns([(_t(bk[0][0]), None)]))
        assert (h < 0).sum() > len(h) // 3  # hashes at or past 2^63 as uint64
        assert int(_np(got.live).sum()) > 0
        table = K._hash_join_pairs_table([(_t(d), _t(v)) for d, v in bk],
                                         [(_t(d), _t(v)) for d, v in pk], _t(b_live),
                                         _t(p_live), cap)

        def pairs(r):
            live = _np(r.live)
            return sorted(zip(_np(r.build_idx)[live].tolist(),
                              _np(r.probe_idx)[live].tolist()))
        assert pairs(table) == pairs(got)


# -- the bloom --------------------------------------------------------------------------

def _bloom_keys(case):
    rng = np.random.default_rng(47)
    return {"empty": np.zeros(0, np.int64),
            "small": rng.integers(0, 1000, 37),
            "full_range": rng.integers(-2**63, 2**63 - 1, 20_000, dtype=np.int64),
            "dictionary_codes": np.arange(-1, 500, dtype=np.int64)}[case]


@pytest.mark.parametrize("library", [True, False])
@pytest.mark.parametrize("case", ["empty", "small", "full_range", "dictionary_codes"])
def test_host_bloom_build_equals_the_reference(case, library, monkeypatch):
    keys = _bloom_keys(case)
    nwords = 1
    while nwords < max(2 * keys.size // 8, 64):
        nwords *= 2
    if library:
        assert jax_native.AVAILABLE or jax_native._load() is None
    else:
        monkeypatch.setattr(jax_native, "AVAILABLE", False)
    want = jax_native.bloom_build(keys, nwords)
    got = native.bloom_build(keys, nwords)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["small", "full_range", "dictionary_codes"])
def test_bloom_query_device(case):
    rng = np.random.default_rng(48)
    build = _bloom_keys(case)
    nwords = 1
    while nwords < max(2 * build.size // 8, 64):
        nwords *= 2
    words = native.bloom_build(build, nwords)
    probe = np.concatenate([build, rng.integers(-2**63, 2**63 - 1, 5000,
                                                dtype=np.int64)])
    ref = R.bloom_query_device(_j(probe), _j(words))
    got = K.bloom_query_device(_t(probe), _t(words.view(np.int64)))
    _same(ref, got)
    assert _np(got)[:build.size].all()  # no false negative
    assert np.array_equal(_np(got), jax_native.bloom_query(probe, words))


# -- the dispatch -----------------------------------------------------------------------

def _dispatch_cases():
    """name -> (keys, inputs, specs, live, max_groups, domains), from a numpy seed:
    the same arrays in this process and in the reference's fresh one."""
    rng = np.random.default_rng(49)
    n = 2000
    k1 = rng.integers(0, 3, n).astype(np.int32)
    k1v = rng.random(n) > 0.1
    k2 = rng.integers(0, 2, n).astype(np.int32)
    x = rng.integers(-10**9, 10**9, n)
    xv = rng.random(n) > 0.2
    f = rng.uniform(-10, 10, n).astype(np.float32)
    gk = rng.integers(0, 700, n)
    live = rng.random(n) > 0.1
    int_specs = [R.AggSpec("sum", 0), R.AggSpec("count_star", -1),
                 R.AggSpec("min", 0), R.AggSpec("max", 0)]
    float_specs = [R.AggSpec("sum", 1), R.AggSpec("count", 0), R.AggSpec("sum", 0)]
    dom_keys = [(k1, k1v), (k2, None)]
    ins = [(x, xv), (f, None)]
    return {
        "domains": (dom_keys, ins, int_specs, live, 64, [3, 2]),
        "domains_float_sum": (dom_keys, ins, float_specs, live, 64, [3, 2]),
        "global": ([], ins, int_specs, live, 16, None),
        "global_float_sum": ([], ins, float_specs, live, 16, None),
        "general": ([(gk, None)], ins, int_specs, live, 1024, None),
        "empty_input": ([(gk, None)], ins, int_specs, np.zeros(n, bool), 1024, None),
        "empty_domains": (dom_keys, ins, int_specs, np.zeros(n, bool), 64, [3, 2]),
        "overflow": ([(gk, None)], ins, int_specs, live, 128, None),
    }


_JAX_SORT_BRANCH = r"""
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax
import jax.numpy as jnp
import numpy as np
from galaxysql_tpu.kernels import relational as R
from test_torch_formulations import _dispatch_cases, _join_case
R.prefer_scatter = lambda: False  # the reference's TPU branch, in this process only
out = {}
def put(name, v):
    if v is not None:
        out[name] = np.asarray(v)
for name, (keys, inputs, specs, live, mg, domains) in _dispatch_cases().items():
    r = jax.jit(R.groupby, static_argnums=(2, 4, 5))(
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in keys],
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in inputs],
        tuple(specs), jnp.asarray(live), mg, None if domains is None else tuple(domains))
    put(f"{name}/live", r.live)
    put(f"{name}/num_groups", r.num_groups)
    put(f"{name}/overflow", r.overflow)
    for i, (d, v) in enumerate(r.keys):
        put(f"{name}/k{i}d", d)
        put(f"{name}/k{i}v", v)
    for i, (d, v) in enumerate(r.aggs):
        put(f"{name}/a{i}d", d)
        put(f"{name}/a{i}v", v)
for case in ("table_twin", "high_hashes_dead_rows"):
    bk, pk, bl, pl, cap = _join_case(case)
    r = jax.jit(R.hash_join_pairs, static_argnums=(4,))(
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in bk],
        [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in pk],
        jnp.asarray(bl), jnp.asarray(pl), cap)
    for f in r._fields:
        put(f"join_{case}/{f}", getattr(r, f))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_sort_branch(tmp_path_factory):
    """Every dispatch case through the reference's TPU branch, in a fresh process."""
    path = str(tmp_path_factory.mktemp("jax_sort_branch") / "out.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _JAX_SORT_BRANCH, ROOT, path], check=True,
                   env=env, timeout=600, cwd=ROOT)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flat(name, r):
    out = {f"{name}/live": r.live, f"{name}/num_groups": r.num_groups,
           f"{name}/overflow": r.overflow}
    for i, (d, v) in enumerate(r.keys):
        out[f"{name}/k{i}d"] = d
        if v is not None:
            out[f"{name}/k{i}v"] = v
    for i, (d, v) in enumerate(r.aggs):
        out[f"{name}/a{i}d"] = d
        if v is not None:
            out[f"{name}/a{i}v"] = v
    return out


def _port_groupby(case):
    keys, inputs, specs, live, mg, domains = _dispatch_cases()[case]
    return K.groupby([(_t(d), _t(v)) for d, v in keys],
                     [(_t(d), _t(v)) for d, v in inputs], _tspecs(specs), _t(live), mg,
                     domains)


@pytest.mark.parametrize("case", sorted(_dispatch_cases()))
def test_groupby_dispatch_on_the_sort_branch(case, jax_sort_branch, monkeypatch):
    picked = []
    for fn in ("sort_groupby", "matmul_groupby", "hash_groupby", "scatter_groupby"):
        orig = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _f=orig, _n=fn, **kw:
                            picked.append(_n) or _f(*a, **kw))
    with K.formulation_scope("sort"):
        got = _port_groupby(case)
    want_fn = {"domains": "matmul_groupby", "empty_domains": "matmul_groupby",
               "global": "matmul_groupby"}.get(case, "sort_groupby")
    assert picked == [want_fn]
    keys, inputs, specs, live, _mg, _d = _dispatch_cases()[case]
    bound = _float_bound(inputs, specs, live)
    flat = _flat(case, got)
    assert sorted(flat) == sorted(k for k in jax_sort_branch if k.startswith(case + "/"))
    for k, v in flat.items():
        ref = jax_sort_branch[k]
        if np.issubdtype(ref.dtype, np.floating):
            assert np.all(np.abs(ref - _np(v).astype(ref.dtype)) <= bound), k
        else:
            _same(ref, v if isinstance(v, torch.Tensor) else np.asarray(v))
    assert bool(got.overflow) == (case == "overflow")


@pytest.mark.parametrize("case", sorted(_dispatch_cases()))
def test_groupby_dispatch_on_the_scatter_branch(case):
    """Outside the scope the port dispatches as the reference does on the CPU."""
    keys, inputs, specs, live, mg, domains = _dispatch_cases()[case]
    ref = R.groupby([(_j(d), _j(v)) for d, v in keys], [(_j(d), _j(v)) for d, v in inputs],
                    specs, _j(live), mg, domains)
    _same_result(ref, _port_groupby(case))


@pytest.mark.parametrize("case", ["table_twin", "high_hashes_dead_rows"])
def test_join_dispatch_on_the_sort_branch(case, jax_sort_branch):
    bk, pk, bl, pl, cap = _join_case(case)
    with K.formulation_scope("sort"):
        got = K.hash_join_pairs([(_t(d), _t(v)) for d, v in bk],
                                [(_t(d), _t(v)) for d, v in pk], _t(bl), _t(pl), cap)
    for f in got._fields:
        _same(jax_sort_branch[f"join_{case}/{f}"], getattr(got, f))


# -- whole statements -------------------------------------------------------------------

class _Calls:
    """Counts calls of the sort formulations and of the scatter branch's four kernel
    call sites while installed."""

    SORT = ("sort_groupby", "matmul_groupby", "_hash_join_pairs_sorted",
            "bloom_query_device")
    KERNELS = ((cuda_join, "build_slots"), (cuda_join, "hash_slots"),
               (cuda_join, "expand_offsets"), (cuda_agg, "hash_place"))

    def __init__(self, monkeypatch):
        self.n = {}
        for name in self.SORT:
            self._wrap(monkeypatch, K, name)
        for mod, name in self.KERNELS:
            self._wrap(monkeypatch, mod, name)

    def _wrap(self, monkeypatch, mod, name):
        orig = getattr(mod, name)
        self.n[name] = 0

        def counted(*a, **kw):
            self.n[name] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    def kernels(self):
        return {name: self.n[name] for _m, name in self.KERNELS}


@pytest.fixture(scope="module")
def tpch_engines():
    ji, js, pi, ps = _engine_pair(tpch.generate(0.01))
    yield js, ps
    js.close()
    ps.close()


TPCH_SORT_CALLS = {}
NO_CACHE = "/*+TDDL:FRAGMENT_CACHE(OFF)*/ "  # every run executes its operators


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_under_the_sort_branch_equals_the_reference(tpch_engines, q, monkeypatch):
    js, ps = tpch_engines
    want = js.execute(NO_CACHE + QUERIES[q])
    calls = _Calls(monkeypatch)
    with K.formulation_scope("sort"):
        got = ps.execute(NO_CACHE + QUERIES[q])
    assert got.names == want.names
    assert got.rows == want.rows
    assert calls.kernels() == {"build_slots": 0, "hash_slots": 0, "expand_offsets": 0,
                               "hash_place": 0}
    TPCH_SORT_CALLS[q] = {k: calls.n[k] for k in _Calls.SORT}
    if q == 22:  # every sort formulation ran somewhere in the 22
        assert all(sum(c[k] for c in TPCH_SORT_CALLS.values()) > 0
                   for k in _Calls.SORT), TPCH_SORT_CALLS
    # outside the scope the same statement takes the scatter branch again
    calls_after = _Calls(monkeypatch)
    assert ps.execute(NO_CACHE + QUERIES[q]).rows == want.rows
    assert all(calls_after.n[k] == 0 for k in _Calls.SORT)


@pytest.fixture(scope="module")
def mpp_engines():
    js, ps = _pair("tpch", tpch.TPCH_DDL, tpch.TABLE_ORDER, tpch.generate(0.01))
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("q", [1, 3, 5, 9, 13, 18, 21])
def test_mpp_under_the_sort_branch_equals_the_reference(mpp_engines, q, monkeypatch):
    js, ps = mpp_engines
    calls = _Calls(monkeypatch)
    with K.formulation_scope("sort"):
        out, ctx, _plan = run_port(ps, QUERIES[q])
    assert_same(out.to_pylist(), js.execute(QUERIES[q]).rows, TPCH_ORDERED[q])
    assert any(t.startswith("mpp-scan") for t in ctx.trace)
    assert calls.kernels() == {"build_slots": 0, "hash_slots": 0, "expand_offsets": 0,
                               "hash_place": 0}
    assert calls.n["sort_groupby"] + calls.n["matmul_groupby"] > 0


def test_mpp_cached_aggregates_carry_the_branch(mpp_engines):
    """MPP's fragment-cached aggregate is replayed to the branch that stored it only."""
    _js, ps = mpp_engines
    sql = "/*+TDDL: ENGINE(MPP)*/ " + QUERIES[3]
    ps.instance.frag_cache.clear()
    hits = []
    try:
        for branch in ("scatter", "sort", "sort", "scatter"):
            with K.formulation_scope(branch):
                ps.execute(sql)
            hits.append(any("frag-cache mpp agg hit" in t for t in ps.last_trace))
    finally:
        ps.instance.frag_cache.clear()
    assert hits == [False, False, True, True]


@pytest.fixture()
def skew_env():
    """`fact_hot` and `mid` of the skew suite (`tests/test_torch_skew.py`, the
    reference's tables and seed) on an 8-shard CPU mesh, ANALYZEd, every join
    shuffled."""
    from galaxysql_tpu_torch.parallel import mpp as M
    from galaxysql_tpu_torch.parallel.mesh import make_mesh
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from test_torch_skew import _tables
    inst = Instance(device="cpu")
    inst._mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    s = Session(inst)
    s.execute("CREATE DATABASE sk; USE sk")
    for name, ddl, arrays in _tables():
        if name in ("fact_hot", "mid"):
            s.execute(ddl)
            inst.store("sk", name).insert_arrays(arrays, inst.tso.next_timestamp())
    s.execute("ANALYZE TABLE fact_hot, mid")
    old = M.BROADCAST_BUILD_LIMIT
    M.BROADCAST_BUILD_LIMIT = 0  # force the shuffle shape for every join
    try:
        yield inst, inst.mesh()
    finally:
        M.BROADCAST_BUILD_LIMIT = old
        s.close()


def test_hybrid_join_under_the_sort_branch(skew_env, monkeypatch):
    """The hybrid join compacts hot rows by a stable argsort on the sort branch and
    still probes through the CSR, as the reference does; rows equal SKEW(OFF) and the
    scatter branch's."""
    from test_torch_skew import hybrid_engaged, run_mpp
    inst, mesh = skew_env
    sql = ("SELECT f.k, count(*), sum(f.v * m.w) FROM fact_hot f JOIN mid m "
           "ON f.k = m.k GROUP BY f.k")
    scatter_rows, _ctx = run_mpp(inst, mesh, sql)
    calls = _Calls(monkeypatch)
    with K.formulation_scope("sort"):
        rows, ctx = run_mpp(inst, mesh, sql)
        off, _ = run_mpp(inst, mesh, "/*+TDDL: SKEW(OFF)*/ " + sql)
    assert hybrid_engaged(ctx)
    assert rows == off == scatter_rows
    assert calls.n["expand_offsets"] > 0 and calls.n["hash_place"] == 0
    assert calls.n["_hash_join_pairs_sorted"] > 0


def test_groupby_retry_ladder_on_sort_overflow(monkeypatch):
    """A GROUP BY with more groups than the planner's estimate: `sort_groupby`
    overflows and `HashAggOp` retries with doubled slots, as on `hash_groupby`."""
    from galaxysql_tpu.server.instance import Instance as JaxInstance
    from galaxysql_tpu.server.session import Session as JaxSession
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    rng = np.random.default_rng(51)
    n = 6000
    arrays = {"id": np.arange(n, dtype=np.int64), "g": rng.permutation(n) % 5000,
              "v": rng.integers(-1000, 1000, n)}
    sql = "SELECT g, count(*), sum(v), min(v) FROM t GROUP BY g ORDER BY g"
    out = []
    for inst in (JaxInstance(), Instance(device="cpu")):
        s = (JaxSession if isinstance(inst, JaxInstance) else Session)(inst)
        s.execute("CREATE DATABASE r; USE r")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
        inst.store("r", "t").insert_arrays(arrays, inst.tso.next_timestamp())
        out.append(s)
    js, ps = out
    want = js.execute(sql).rows
    seen = []
    orig = K.sort_groupby

    def recorded(keys, inputs, specs, live, max_groups):
        r = orig(keys, inputs, specs, live, max_groups)
        seen.append((max_groups, bool(r.overflow)))
        return r
    monkeypatch.setattr(K, "sort_groupby", recorded)
    with K.formulation_scope("sort"):
        got = ps.execute(sql).rows
    assert got == want and len(got) == 5000
    assert seen[0][1] and not seen[-1][1]
    assert [mg for mg, _o in seen] == [seen[0][0] << i for i in range(len(seen))]
    js.close()
    ps.close()


def test_fragment_cache_keeps_the_branches_apart(tpch_engines):
    """A join-build artifact stored under one branch (the scatter branch's holds a
    slot CSR, the sort branch's none) is never served to the other, and MPP's cached
    aggregates and builds carry the branch too."""
    _js, ps = tpch_engines
    inst = ps.instance
    sql = QUERIES[3]
    want = ps.execute("/*+TDDL:FRAGMENT_CACHE(OFF)*/ " + sql).rows
    try:
        inst.frag_cache.clear()

        def run(branch):
            with K.formulation_scope(branch):
                rows = ps.execute(sql).rows
            inst.frag_cache.drop_kind("subplan")  # let the join level serve next
            assert rows == want
            return sum("frag-cache build hit" in t for t in ps.last_trace)

        def builds():
            with inst.frag_cache._lock:
                entries = list(inst.frag_cache._map.items())
            return sorted((k[2], None if e.value.csr is None else
                           type(e.value.csr).__name__)
                          for k, e in entries if k[0] == "join_build")
        assert run("scatter") == 0
        stored = builds()
        assert stored and all(b == (True, "tuple") for b in stored)
        assert run("sort") == 0  # a miss: the scatter artifacts are not served
        assert builds() == sorted(stored + [(False, None)] * len(stored))
        # warm: each branch is served its own artifacts (an outer build's hit
        # skips the subtree under it, so a hit can hide a deeper build)
        warm_sort = run("sort")
        assert warm_sort > 0 and run("scatter") == warm_sort
    finally:
        inst.frag_cache.clear()
