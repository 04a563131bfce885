"""Planned runtime filters (`exec/runtime_filter.py`, a verbatim copy) on the port's
execution hub, against the JAX package on the CPU.

The `rf` stage of the port's fusion (`exec/fusion.rf_stage_fn`, torch) is held bit for
bit against the copied numpy `RfStageRef` stage: bloom, min/max, NULL keys, the empty
build's pass-nothing filter, and BIGINT UNSIGNED keys on both sides of 2^63; the host
bloom hash (`meta/statistics._mix64`, uint64) against the device one
(`kernels/hashing._mix64`, int64 bits).  The reference's own cases
(`tests/test_runtime_filter.py`) then run as scenarios through both packages: the
rows, the filters built and cached, the probe rows reaching the joins and the
EXPLAIN ANALYZE `RuntimeFilter(...)` lines must be equal; so must the stripes a
columnar replica prunes by a join's filter and the archive files a filter skips.
The remote-worker cases (filters shipped in a worker's fragment) are in
`tests/test_torch_workers.py`.  Left out: the MPP and SSB cases (the port has no SSB
generator), SHOW METRICS (ROADMAP Queue 1 item 16) and the reference's dispatch
counters (no program dispatch in eager PyTorch)."""

import time
import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.exec import runtime_filter as jax_rf
from galaxysql_tpu.plan import logical as JaxL
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.types import temporal
from galaxysql_tpu_torch.chunk.batch import batch_from_pydict
from galaxysql_tpu_torch.exec import runtime_filter as rf
from galaxysql_tpu_torch.exec.fusion import (FusedPipelineOp, FusedSegment,
                                             publish_on_device, rf_stage_fn)
from galaxysql_tpu_torch.exec.operators import SourceOp
from galaxysql_tpu_torch.kernels import hashing
from galaxysql_tpu_torch.meta import statistics
from galaxysql_tpu_torch.plan import logical as PortL
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.types import datatype as dt

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def _jax_instance():
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


JAX = types.SimpleNamespace(name="jax", new=_jax_instance, Session=JaxSession, rf=jax_rf,
                            L=JaxL)
PORT = types.SimpleNamespace(name="port", new=lambda: Instance(device="cpu"),
                             Session=Session, rf=rf, L=PortL)


def _same(scenario):
    """`scenario(pkg)` through both packages; the observations must be equal."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


# -- the rf stage, torch against numpy -------------------------------------------------

def test_mix64_host_and_device_are_bit_identical():
    """The host builds the bloom flags with `statistics._mix64` over uint64, the
    probe stage hashes with `hashing._mix64` over int64 bits: one differing bit is a
    false negative, which drops join rows."""
    rng = np.random.default_rng(12)
    keys = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 4096,
                                        dtype=np.int64),
                           np.arange(-300, 300, dtype=np.int64),
                           np.array([0, -1, np.iinfo(np.int64).min,
                                     np.iinfo(np.int64).max], dtype=np.int64)])
    with np.errstate(over="ignore"):
        host = statistics._mix64(keys.astype(np.uint64))
    dev = hashing._mix64(torch.from_numpy(keys)).numpy().view(np.uint64)
    assert np.array_equal(host, dev)


def _stage_pair(keys, kinds, probe, valid=None, lane_dtype=dt.BIGINT):
    """(torch mask, numpy mask) of one published filter over one probe lane."""
    f = rf.RuntimeFilter.build(keys, kinds)
    mgr = rf.RuntimeFilterManager()
    mgr.publish(1, f)
    ref = rf.RfStageRef(mgr, rf.RuntimeFilterTarget(1, "k", "k", frozenset(kinds)))
    n = probe.shape[0]
    args = ref.runtime_args()
    want = ref.make_fn(np)({"k": (probe, valid)}, np.ones(n, dtype=np.bool_), args)
    lane = probe.view(np.int64) if probe.dtype == np.uint64 else probe
    env = {"k": (torch.from_numpy(np.ascontiguousarray(lane)),
                 None if valid is None else torch.from_numpy(valid))}
    got = rf_stage_fn(ref, lane_dtype)(
        env, torch.ones(n, dtype=torch.bool),
        (torch.from_numpy(np.asarray(args[0])), args[1], args[2]))
    return got.numpy(), np.broadcast_to(np.asarray(want), (n,))


_RNG = np.random.default_rng(7)
_SIGNED = _RNG.integers(-50_000, 50_000, 3000).astype(np.int64)
_U64 = np.concatenate([np.arange(10, dtype=np.uint64),
                       (np.uint64(1) << np.uint64(63)) + np.arange(10, dtype=np.uint64),
                       np.array([(1 << 63) - 1, (1 << 64) - 1], dtype=np.uint64)])


@pytest.mark.parametrize("case", [
    "bloom_minmax", "bloom", "minmax", "nulls", "empty_build", "in_list_small",
    "u64_low_build", "u64_high_build", "u64_both_sides", "int32_dates", "float_keys"])
def test_rf_stage_matches_numpy_stage_bit_for_bit(case):
    kinds = {"bloom", "minmax"}
    valid = None
    lane_dtype = dt.BIGINT
    probe = _RNG.integers(-60_000, 60_000, 5000).astype(np.int64)
    keys = _SIGNED
    if case == "bloom":
        kinds = {"bloom"}
    elif case == "minmax":
        kinds = {"minmax"}
    elif case == "nulls":
        valid = _RNG.random(5000) < 0.8
    elif case == "empty_build":
        keys = np.zeros(0, dtype=np.int64)
    elif case == "in_list_small":
        keys = np.array([-5, 5, 5, 9], dtype=np.int64)
        probe = np.arange(-20, 20, dtype=np.int64)
    elif case.startswith("u64"):
        lane_dtype = dt.UBIGINT
        probe = np.concatenate([_U64, _U64 + np.uint64(3), _U64 - np.uint64(2)])
        keys = {"u64_low_build": _U64[:10], "u64_high_build": _U64[10:20],
                "u64_both_sides": _U64[[2, 5, 14, 21]]}[case]
    elif case == "int32_dates":
        lane_dtype = dt.DATE
        keys = _RNG.integers(8000, 8400, 300).astype(np.int32)
        probe = _RNG.integers(7800, 8600, 4000).astype(np.int32)
    elif case == "float_keys":
        lane_dtype = dt.DOUBLE
        keys = _RNG.normal(0, 100, 500)
        probe = np.concatenate([keys[:100], _RNG.normal(0, 150, 2000)])
    got, want = _stage_pair(keys, kinds, probe, valid, lane_dtype)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    if case == "empty_build":
        assert not got.any()  # pass NOTHING, never everything
    if case in ("bloom_minmax", "int32_dates", "u64_both_sides"):
        assert 0 < got.sum() < got.size
    if case.startswith("u64") or case in ("bloom_minmax", "int32_dates", "float_keys"):
        member = np.isin(probe, keys)
        assert got[member].all()  # no false negatives


def test_host_filter_values_equal_the_reference():
    """The copied `RuntimeFilter.build` gives the JAX package's flags, range and
    IN-list on the same keys, signed and BIGINT UNSIGNED."""
    for keys in (_SIGNED, _U64, np.array([5, 5, 9], dtype=np.int64)):
        a = jax_rf.RuntimeFilter.build(keys, {"bloom", "minmax"})
        b = rf.RuntimeFilter.build(keys, {"bloom", "minmax"})
        assert a.static_key() == b.static_key() and a.lo == b.lo and a.hi == b.hi
        assert np.array_equal(a.flags, b.flags)
        assert (a.in_values is None) == (b.in_values is None)


def _publish_both(build, specs):
    """(host manager, device manager, filters built each way): the copied
    `publish_from_batch` over host copies of the key lanes against the port's
    `fusion.publish_on_device` over the batch's own tensors."""
    out = []
    for publish in (rf.publish_from_batch, publish_on_device):
        mgr = rf.RuntimeFilterManager()
        rf.reset_rf_stats()
        publish(mgr, specs, build)
        out.append((mgr, rf.RF_STATS["filters_built"]))
    rf.reset_rf_stats()
    return out


def _filter_fields(f):
    if f is None:
        return None
    flags = None if f.flags is None else np.asarray(
        f.flags.cpu().numpy() if isinstance(f.flags, torch.Tensor) else f.flags)
    scalar = (lambda x: None if x is None else (np.asarray(x).dtype, np.asarray(x).item()))
    return (f.n_build, f.nbits, f.static_key(), scalar(f.lo), scalar(f.hi),
            None if flags is None else (flags.dtype, flags.tobytes()),
            None if f.in_values is None else (f.in_values.dtype,
                                              f.in_values.tobytes()))


@pytest.mark.parametrize("case", [
    "signed", "negative_small", "u64_both_sides", "u64_low", "int32_dates",
    "float_keys", "nulls_and_dead_rows", "all_dead", "minmax_only", "bloom_only",
    "strings_translated", "strings_same_dictionary", "two_specs"])
def test_device_built_filter_equals_the_host_build(case):
    """The join build publishes from its own device (`fusion.publish_on_device`):
    flags bit for bit, range (value and numpy type), IN-list and the filters-built
    count must equal the copied host path's on the same build batch."""
    from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch, Dictionary
    from galaxysql_tpu_torch.expr import ir
    rng = np.random.default_rng(31)
    typ, dictionary, probe_dictionary = dt.BIGINT, None, None
    valid = live = None
    kinds = frozenset({"bloom", "minmax"})
    data = rng.integers(-(1 << 40), 1 << 40, 5000).astype(np.int64)
    if case == "negative_small":
        data = np.array([-7, -7, -3, 0, 12, -(1 << 62)], dtype=np.int64)
    elif case == "u64_both_sides":
        typ, data = dt.UBIGINT, _U64[[1, 4, 12, 19, 20, 21]].view(np.int64)
    elif case == "u64_low":
        typ, data = dt.UBIGINT, _U64[:10].view(np.int64)
    elif case == "int32_dates":
        typ, data = dt.DATE, rng.integers(8000, 9000, 900).astype(np.int32)
    elif case == "float_keys":
        typ, data = dt.DOUBLE, rng.normal(0, 100, 700).astype(np.float32)
    elif case == "nulls_and_dead_rows":
        data = rng.integers(-500, 500, 3000).astype(np.int64)
        valid, live = rng.random(3000) < 0.7, rng.random(3000) < 0.5
    elif case == "all_dead":
        live = np.zeros(data.shape[0], dtype=np.bool_)
    elif case == "minmax_only":
        kinds = frozenset({"minmax"})
    elif case == "bloom_only":
        kinds = frozenset({"bloom"})
    elif case.startswith("strings"):
        typ = dt.VARCHAR
        words = [f"w{i}" for i in range(40)]
        dictionary = Dictionary(words)
        probe_dictionary = dictionary if case == "strings_same_dictionary" else \
            Dictionary(words[::3] + ["x"])
        data = rng.integers(0, 40, 600).astype(np.int32)
    col = Column(torch.from_numpy(data),
                 None if valid is None else torch.from_numpy(valid), typ, dictionary)
    build = ColumnBatch({"k": col}, None if live is None else torch.from_numpy(live))
    bkey = ir.ColRef("k", typ, dictionary)
    pkey = ir.ColRef("p", typ, probe_dictionary)
    specs = [rf.RfPublish(1, bkey, pkey, kinds)]
    if case == "two_specs":
        specs.append(rf.RfPublish(2, bkey, pkey, frozenset({"minmax"})))
    (host, n_host), (dev, n_dev) = _publish_both(build, specs)
    assert n_host == n_dev == len(specs)
    assert sorted(host.filters) == sorted(dev.filters) == [s.filter_id for s in specs]
    for fid in host.filters:
        assert _filter_fields(dev.filters[fid]) == _filter_fields(host.filters[fid])
    if case == "all_dead":
        assert dev.filters[1].pass_nothing()


def test_device_publish_keeps_the_size_gates(monkeypatch):
    """Past RF_PUBLISH_MAX_ROWS live rows nothing is published (pass-all), on both
    paths; an empty build publishes pass-nothing filters."""
    from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch
    from galaxysql_tpu_torch.expr import ir
    key = ir.ColRef("k", dt.BIGINT, None)
    specs = [rf.RfPublish(1, key, key, frozenset({"bloom", "minmax"}))]
    monkeypatch.setattr(rf, "RF_PUBLISH_MAX_ROWS", 100)
    big = ColumnBatch({"k": Column(torch.arange(101), None, dt.BIGINT, None)}, None)
    padded = ColumnBatch({"k": Column(torch.arange(300), None, dt.BIGINT, None)},
                         torch.arange(300) < 100)
    empty = ColumnBatch({"k": Column(torch.zeros(0, dtype=torch.int64), None,
                                     dt.BIGINT, None)}, None)
    for batch, published in ((big, False), (padded, True), (empty, True)):
        (host, _), (dev, _) = _publish_both(batch, specs)
        assert (1 in host.filters) == (1 in dev.filters) == published
        if published:
            assert _filter_fields(dev.filters[1]) == _filter_fields(host.filters[1])
    assert dev.filters[1].pass_nothing()


def test_absent_and_unpublished_segments_are_identity():
    mgr = rf.RuntimeFilterManager()
    ref = rf.RfStageRef(mgr, rf.RuntimeFilterTarget(3, "k", "k",
                                                    frozenset({"bloom", "minmax"})))
    seg = FusedSegment([("rf", ref)])
    b = batch_from_pydict({"k": [1, 2, 3]}, {"k": dt.BIGINT})
    out = list(FusedPipelineOp(SourceOp([b]), seg).batches())
    assert out[0] is b and seg.inert()  # the very same object: no work at all
    mgr2 = rf.RuntimeFilterManager()
    mgr2.publish(3, rf.RuntimeFilter.build(np.asarray([2], np.int64), {"minmax"}))
    seg2 = FusedSegment([("rf", rf.RfStageRef(mgr2, rf.RuntimeFilterTarget(
        3, "k", "k", frozenset({"minmax"}))))])
    assert not seg2.inert()
    assert seg2.run_batch(b).to_pylist() == [(2,)]


@pytest.mark.parametrize("live_rows,cap,built", [(100, 256, True), (100, 64, False)])
def test_join_bloom_gates_on_live_rows(monkeypatch, live_rows, cap, built):
    """The join's own bloom (`HashJoinOp._build_bloom`) gates and sizes on the live
    build rows, not the padded capacity (the reference's `TestBloomCapUnified`)."""
    from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch
    from galaxysql_tpu_torch.exec.operators import HashJoinOp
    from galaxysql_tpu_torch.expr import ir
    from galaxysql_tpu_torch.expr.compiler import TorchXP
    monkeypatch.setattr(HashJoinOp, "BLOOM_MAX_BUILD", cap)
    data = np.zeros(1024, dtype=np.int64)
    data[:live_rows] = np.arange(live_rows)
    build = ColumnBatch({"k": Column(torch.from_numpy(data), None, dt.BIGINT, None)},
                        torch.from_numpy(np.arange(1024) < live_rows))
    key = [ir.ColRef("k", dt.BIGINT, None)]
    op = HashJoinOp(SourceOp([build]), SourceOp([build]), key, key)
    _bk, pk = op._key_compilers(build.device)
    apply = op._build_bloom(build, pk[0], TorchXP(build.device))
    assert (apply is not None) == built
    if built:
        probe = ColumnBatch({"k": Column(torch.tensor([5, 99, 5000]), None, dt.BIGINT,
                                         None)}, None)
        assert apply(probe).live_mask().tolist() == [True, True, False]


@pytest.mark.parametrize("hint,want", [
    ("/*+TDDL: RUNTIME_FILTER(OFF)*/", {"runtime_filter": "off"}),
    ("/*+TDDL: RUNTIME_FILTER=BLOOM*/", {"runtime_filter": "bloom"}),
    ("/*+TDDL: RUNTIME_FILTER(MINMAX) NO_FUSE*/", {"runtime_filter": "minmax",
                                                   "no_fuse": True}),
    ("/*+TDDL: RUNTIME_FILTER(WAT)*/", {}),
    ("/*+TDDL: NO_BLOOM*/", {"no_bloom": True}),
])
def test_runtime_filter_hints_and_manager_mode(hint, want):
    from galaxysql_tpu.sql.hints import parse_hints as jax_parse_hints
    from galaxysql_tpu_torch.sql.hints import parse_hints
    assert parse_hints(hint) == jax_parse_hints(hint) == want
    mode = rf.RuntimeFilterManager(hints=parse_hints(hint)).mode
    assert mode == ("off" if want.get("runtime_filter") == "off" or
                    want.get("no_bloom") else "on")


def test_scan_pushdown_extraction():
    """The lane-domain min/max SARGs and IN-list a published filter gives a scan (what
    the archive's and the replica's pruning read)."""
    from galaxysql_tpu_torch.plan import logical as L

    class _Col:
        dtype = dt.BIGINT

    class _TM:
        def column(self, n):
            return _Col()
    scan = L.Scan.__new__(L.Scan)
    scan.table = _TM()
    scan.rf_targets = [rf.RuntimeFilterTarget(1, "t.k", "k",
                                              frozenset({"bloom", "minmax"}))]
    mgr = rf.RuntimeFilterManager()
    mgr.publish(1, rf.RuntimeFilter.build(np.asarray([5, 9], np.int64),
                                          {"bloom", "minmax"}))
    sargs, inlists = mgr.scan_pushdown(scan)
    assert ("k", "ge", 5) in sargs and ("k", "le", 9) in sargs
    assert inlists == [("k", [5, 9])]


# -- SQL scenarios (the reference's rf_session) ----------------------------------------

@pytest.mark.parametrize("case", ["probe_scan", "off_hints", "kinds", "small_probe",
                                  "semi_join"])
def test_planning_annotations(case):
    """The copied rules plant the same filter edges in both packages (the reference's
    `TestPlanning`): the probe scan carries the target, the join the producer."""
    def scenario(pkg):
        s = rf_session(pkg)

        def scans(sql):
            plan = s.instance.planner.plan_select(sql, "rf", [], s)
            out = []
            for n in pkg.L.walk(plan.rel):
                for t in getattr(n, "rf_targets", None) or []:
                    out.append((n.table.name, t.column, sorted(t.kinds)))
            return out
        if case == "probe_scan":
            return scans(Q_COUNT)
        if case == "off_hints":
            return [scans(f"/*+TDDL:{h}*/ " + Q_COUNT)
                    for h in ("RUNTIME_FILTER(OFF)", "RUNTIME_FILTER=OFF", "NO_BLOOM")]
        if case == "kinds":
            return [scans(f"/*+TDDL:RUNTIME_FILTER({k})*/ " + Q_COUNT)
                    for k in ("MINMAX", "BLOOM")]
        if case == "small_probe":
            return scans("select count(*) from small a, small b where a.k = b.k")
        return scans("select count(*) from big where big.k in (select k from small)")
    got = _same(scenario)
    want = {"probe_scan": [("big", "k", ["bloom", "minmax"])],
            "off_hints": [[], [], []],
            "kinds": [[("big", "k", ["minmax"])], [("big", "k", ["bloom"])]],
            "small_probe": [], "semi_join": [("big", "k", ["bloom", "minmax"])]}[case]
    assert got == want


Q_JOIN = ("select small.grp, count(*), sum(big.v) from big, small "
          "where big.k = small.k group by small.grp order by small.grp")
Q_COUNT = "select count(*) from big, small where big.k = small.k"


def rf_session(pkg):
    s = pkg.Session(pkg.new())
    inst = s.instance
    s.execute("CREATE DATABASE rf")
    s.execute("USE rf")
    s.execute("CREATE TABLE big (id BIGINT, k BIGINT, v DOUBLE)")
    s.execute("CREATE TABLE small (k BIGINT, grp VARCHAR(4))")
    n = 20000
    inst.store("rf", "big").insert_pylists(
        {"id": list(range(n)), "k": [i % 1000 if i % 17 else None for i in range(n)],
         "v": [float(i) for i in range(n)]}, inst.tso.next_timestamp())
    inst.store("rf", "small").insert_pylists(
        {"k": list(range(100)), "grp": ["a" if i % 2 else "b" for i in range(100)]},
        inst.tso.next_timestamp())
    s.execute("ANALYZE TABLE big, small")
    return s


def _run_counted(pkg, s, sql):
    """(rows, filters built, filters cached, probe rows) of one cold execution."""
    s.instance.frag_cache.clear()
    pkg.rf.reset_rf_stats(enabled=True)
    rows = s.execute(sql).rows
    st = dict(pkg.rf.RF_STATS)
    pkg.rf.reset_rf_stats()
    return rows, st["filters_built"], st["filters_cached"], st["probe_rows"]


@pytest.mark.parametrize("hint", ["", "RUNTIME_FILTER(OFF)", "RUNTIME_FILTER(MINMAX)",
                                  "RUNTIME_FILTER(BLOOM)", "NO_BLOOM", "NO_FUSE",
                                  "NO_FUSE RUNTIME_FILTER(OFF)"])
def test_join_with_null_keys_under_each_hint(hint):
    """big.k has NULLs (every 17th row): the filter masks them and the join does not
    match them.  Rows, filters built and probe rows reaching the join are the
    reference's under each hint; with filters on, far fewer probe rows arrive."""
    head = f"/*+TDDL:{hint}*/ " if hint else ""

    def scenario(pkg):
        s = rf_session(pkg)
        return [_run_counted(pkg, s, head + q) for q in (Q_JOIN, Q_COUNT)]
    got = _same(scenario)
    if hint in ("", "RUNTIME_FILTER(MINMAX)", "RUNTIME_FILTER(BLOOM)", "NO_FUSE"):
        assert got[1][1] > 0 and got[1][3] < 20000 / 2
    else:
        assert got[1][1] == 0


def test_empty_build_yields_empty_not_everything():
    def scenario(pkg):
        s = rf_session(pkg)
        q = ("select count(*) from big, small where big.k = small.k and small.k < 0")
        on = _run_counted(pkg, s, q)
        off = s.execute("/*+TDDL:RUNTIME_FILTER(OFF)*/ " + q).rows
        assert on[0] == off == [(0,)]
        return on
    _same(scenario)


def test_warm_join_publishes_cached_filters():
    """With the aggregate replays dropped, the cached build artifacts hand their
    filters back: none is built, the same number is cached, the rows stay."""
    def scenario(pkg):
        s = rf_session(pkg)
        cold = _run_counted(pkg, s, Q_JOIN)
        s.execute(Q_JOIN)
        s.instance.frag_cache.drop_kind("subplan")
        pkg.rf.reset_rf_stats(enabled=True)
        warm = s.execute(Q_JOIN).rows
        st = dict(pkg.rf.RF_STATS)
        pkg.rf.reset_rf_stats()
        assert warm == cold[0] and st["filters_built"] == 0 and st["filters_cached"] > 0
        return cold, st["filters_cached"], st["probe_rows"]
    _same(scenario)


def test_explain_analyze_runtime_filter_lines():
    def scenario(pkg):
        s = rf_session(pkg)
        lines = [r[0] for r in s.execute("EXPLAIN ANALYZE " + Q_COUNT).rows]
        rfl = [ln for ln in lines if ln.strip().startswith("RuntimeFilter(")]
        assert rfl and "pruned=" in rfl[0]
        return rfl, [ln.split("  (actual rows=")[1].split(" ")[0]
                     for ln in lines if "  (actual rows=" in ln]
    _same(scenario)


def test_bigint_unsigned_keys_on_both_sides_of_2_63():
    """A join on BIGINT UNSIGNED keys spread across 2^63: the min/max range compares
    in unsigned order (a signed compare would prune the high keys) and the rows are
    the reference's, with filters on and off."""
    q = ("select count(*), sum(f.v) from f, d where f.u = d.u and d.tag = 'x'")

    def scenario(pkg):
        s = pkg.Session(pkg.new())
        inst = s.instance
        s.execute("CREATE DATABASE u; USE u")
        s.execute("CREATE TABLE f (u BIGINT UNSIGNED, v BIGINT)")
        s.execute("CREATE TABLE d (u BIGINT UNSIGNED, tag VARCHAR(2))")
        base = (1 << 63) - 500
        n = 20000
        inst.store("u", "f").insert_pylists(
            {"u": [base + (i % 1000) for i in range(n)], "v": list(range(n))},
            inst.tso.next_timestamp())
        inst.store("u", "d").insert_pylists(
            {"u": [base + i for i in range(0, 1000, 10)],
             "tag": ["x" if (i // 10) % 3 else "y" for i in range(0, 1000, 10)]},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE f, d")
        on = _run_counted(pkg, s, q)
        off = s.execute("/*+TDDL:RUNTIME_FILTER(OFF)*/ " + q).rows
        assert on[0] == off and on[1] > 0
        return on
    _same(scenario)


# -- the replica's stripes and the archive's files -------------------------------------

MARGIN_S = 0.005


def _replica_star(pkg):
    """A fact replica clustered on its date (1,024-row stripes) and a date dimension;
    one month of the dimension joined on the date."""
    inst = pkg.new()
    inst.config.set_instance("COLUMNAR_POLL_MS", 0)
    inst.columnar.shutdown()
    inst.config.set_instance("COLUMNAR_WATERMARK_LAG_MS", 1)
    inst.config.set_instance("COLUMNAR_CLUSTER_BY", "ev:d")
    inst.config.set_instance("COLUMNAR_COMPACT_ROWS", 1024)
    s = pkg.Session(inst)
    s.execute("CREATE DATABASE c; USE c")
    s.execute("CREATE TABLE ev (id BIGINT, d DATE, v BIGINT) "
              "PARTITION BY HASH(id) PARTITIONS 4")
    s.execute("CREATE TABLE days (dd DATE, m INT, y INT)")
    base = temporal.parse_date("1995-01-01")
    n = 20000
    inst.store("c", "ev").insert_arrays(
        {"id": np.arange(n), "d": (base + (np.arange(n) * 7919) % 730).astype(np.int32),
         "v": np.arange(n) % 97}, inst.tso.next_timestamp())
    days = base + np.arange(730)
    civil = [temporal.format_date(int(x)) for x in days]
    inst.store("c", "days").insert_arrays(
        {"dd": days.astype(np.int32), "m": np.array([int(c[5:7]) for c in civil]),
         "y": np.array([int(c[:4]) for c in civil])}, inst.tso.next_timestamp())
    s.execute("ANALYZE TABLE ev, days")
    time.sleep(MARGIN_S)
    inst.columnar.ensure_ready("c", "ev")
    inst.columnar.ensure_ready("c", "days")
    return s


def test_replica_stripes_pruned_by_join_filter():
    """The runtime filter's date range refutes the stripes of every other month; the
    rows equal the row store's and the reference's, and RUNTIME_FILTER(OFF) prunes
    nothing."""
    q = ("SELECT count(*), sum(ev.v) FROM ev JOIN days ON ev.d = days.dd "
         "WHERE days.y = 1996 AND days.m = 3")

    def scenario(pkg):
        s = _replica_star(pkg)
        out = []
        for hint in ("COLUMNAR(ON)", "COLUMNAR(ON) RUNTIME_FILTER(OFF)"):
            rep = s.instance.columnar.replica("c", "ev")
            p0 = rep.pruned_stripes
            rows = s.execute(f"/*+TDDL:{hint} FRAGMENT_CACHE(OFF)*/ " + q).rows
            out.append((rows, rep.pruned_stripes - p0))
        row_store = s.execute("/*+TDDL:COLUMNAR(OFF)*/ " + q).rows
        assert out[0][0] == out[1][0] == row_store
        return out
    got = _same(scenario)
    assert got[0][1] > 0 and got[1][1] == 0


def test_archive_files_skipped_by_join_filter(tmp_path):
    """Two archive epochs with disjoint key ranges: a join whose dimension keys fall
    in one of them skips the other's file by the filter's min/max (the reference's
    `TestArchiveFilePrune`)."""
    pytest.importorskip("pyarrow.parquet")

    def scenario(pkg):
        inst = pkg.new()
        inst.archive.directory = str(tmp_path / pkg.name / "arch")
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE a; USE a")
        s.execute("CREATE TABLE fact (k BIGINT, d DATE, v BIGINT)")
        s.execute("CREATE TABLE dim (k BIGINT)")
        today = temporal.days_from_civil(2026, 7, 29)
        store = inst.store("a", "fact")
        for base, age in ((0, 400), (1000, 800)):
            store.insert_pylists(
                {"k": list(range(base, base + 100)),
                 "d": [temporal.format_date(today - age)] * 100, "v": [1] * 100},
                inst.tso.next_timestamp())
            assert inst.archive.archive_older_than(inst, "a", "fact", "d",
                                                   today - age + 1) == 100
        store.insert_pylists(
            {"k": [i % 100 for i in range(10000)],
             "d": [temporal.format_date(today)] * 10000, "v": [1] * 10000},
            inst.tso.next_timestamp())
        inst.store("a", "dim").insert_pylists({"k": list(range(90, 100))},
                                              inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE fact, dim")
        q = "select count(*) from fact, dim where fact.k = dim.k"
        pkg.rf.reset_rf_stats(enabled=True)
        before = inst.archive.rf_pruned_files
        on = s.execute(q).rows
        skipped = inst.archive.rf_pruned_files - before
        files = pkg.rf.RF_STATS["files_pruned"]
        pkg.rf.reset_rf_stats()
        off = s.execute("/*+TDDL:RUNTIME_FILTER(OFF)*/ " + q).rows
        assert on == off
        return on, skipped, files
    got = _same(scenario)
    assert got[1] == got[2] == 1


# -- TPC-H ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(0.01)
    ji, pi = _jax_instance(), Instance(device="cpu")
    js, ps = JaxSession(ji), Session(pi)
    for s in (js, ps):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        js.execute(tpch.TPCH_DDL[t])
        ji.store("tpch", t).insert_pylists(data[t], ji.tso.next_timestamp())
        ps.execute(tpch.TPCH_DDL[t])
        parts, dicts = transfer.arrays_of(ji.store("tpch", t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table("tpch", t),
                                                    parts, dicts))
    for s in (js, ps):
        s.execute("ANALYZE TABLE " + ", ".join(tpch.TABLE_ORDER))
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("q", [3, 5, 9, 18])
def test_tpch_filters_on_equal_off_and_prune_as_the_reference(tpch_pair, q):
    """Filters on and RUNTIME_FILTER(OFF) give the reference's rows; with filters on,
    the filters built, the probe rows reaching the joins and the rows each
    `RuntimeFilter(...)` line reports pruned are the reference's."""
    out = []
    for s, pkg in zip(tpch_pair, (JAX, PORT)):
        on = _run_counted(pkg, s, QUERIES[q])
        off = s.execute("/*+TDDL:RUNTIME_FILTER(OFF)*/ " + QUERIES[q]).rows
        assert on[0] == off
        lines = [r[0].strip() for r in s.execute("EXPLAIN ANALYZE " + QUERIES[q]).rows
                 if r[0].strip().startswith("RuntimeFilter(")]
        out.append((on, lines))
    assert out[1] == out[0]
    if q == 5:
        assert out[1][0][1] > 0 and out[1][1]


def test_rf_cost_tool_runs_every_mode(capsys):
    """`tools/rf_cost.py` on the CPU: the three publish modes give equal rows (the tool
    raises otherwise), and the swapped publish step is put back afterwards."""
    import json
    from galaxysql_tpu_torch.exec import fusion
    from galaxysql_tpu_torch.tools import rf_cost
    before = fusion.publish_on_device
    assert rf_cost.main(["--sf", "0.002", "--device", "cpu", "--repeats", "1"]) == 0
    assert fusion.publish_on_device is before
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["analyzed_ms"]) == {f"Q{q}" for q in range(1, 23)}
    assert all(set(v) == set(rf_cost.MODES) for v in out["analyzed_ms"].values())
