"""The MPP engine (`galaxysql_tpu_torch/parallel/`) against the JAX package on the CPU.

Both sides run 8 shards: the JAX package on the 8 virtual CPU devices `conftest.py`
forces, the port on a mesh of 8 shards on `torch.device("cpu")` installed on its
instance (`Instance.mesh()` is None on one device, in both packages).  The data is
the reference's: TPC-H at SF 0.01 and SSB at SF 0.005 from its generators, loaded
into the JAX package and carried into the port lane for lane
(`storage.transfer`), then ANALYZEd on both.

What each case holds the port's `MppExecutor` to:
- the 22 TPC-H queries, the 13 SSB queries, the shuffle join, semi and anti joins and
  the reference's eight `TestMppOperators` shapes: the JAX package's LOCAL `Session`
  (the comparison `tests/test_mpp.py` makes against the JAX MPP), with
  `tests/test_mpp.py:assert_same`'s tolerance (floats within max(|y|*1e-6, 1e-6), the
  rest equal);
- the archive scan, the session dispatch, the fallback set, EXPLAIN ANALYZE and the
  per-shard rows: the JAX package's own MPP, run as `tests/test_mpp.py` runs it;
- `hot_key_mask`, `hash_join_probe_hybrid` and `repartition_by_hash`: the JAX
  functions on seeded inputs, bit for bit (the JAX exchange inside a `shard_map` on
  the virtual devices).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from galaxysql_tpu.kernels import relational as JK
from galaxysql_tpu.meta import statistics as jax_statistics
from galaxysql_tpu.parallel import exchange as jax_exchange
from galaxysql_tpu.parallel import mpp as jax_mpp
from galaxysql_tpu.parallel.mesh import make_mesh as jax_make_mesh
from galaxysql_tpu.plan import physical as jax_physical
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import archive as jax_archive
from galaxysql_tpu.storage import ssb as jax_ssb
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.types import temporal
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.exec import skew as port_skew
from galaxysql_tpu_torch.kernels import relational as K
from galaxysql_tpu_torch.parallel import exchange
from galaxysql_tpu_torch.parallel import mpp as port_mpp
from galaxysql_tpu_torch.parallel.mesh import GLOBAL_MESH_CACHE, make_mesh
from galaxysql_tpu_torch.plan import physical as port_physical
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import archive as port_archive
from galaxysql_tpu_torch.storage import ssb as port_ssb
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

S = 8


def cpu_mesh(n=S):
    return make_mesh(devices=[torch.device("cpu")] * n)


def _jax_instance():
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


def _port_instance():
    pi = Instance(device="cpu")
    pi._mesh = cpu_mesh()
    return pi


def _pair(schema, ddl, order, data):
    """A JAX and a port session over the same lanes, both ANALYZEd."""
    ji, pi = _jax_instance(), _port_instance()
    js, ps = JaxSession(ji), Session(pi)
    for s in (js, ps):
        s.execute(f"CREATE DATABASE {schema}")
        s.execute(f"USE {schema}")
    for t in order:
        js.execute(ddl[t])
        ps.execute(ddl[t])
        ji.store(schema, t).insert_arrays(data[t], ji.tso.next_timestamp())
        parts, dicts = transfer.arrays_of(ji.store(schema, t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table(schema, t),
                                                    parts, dicts))
    for s in (js, ps):
        s.execute("ANALYZE TABLE " + ", ".join(order))
    return js, ps


@pytest.fixture(scope="module")
def tpch_env():
    js, ps = _pair("tpch", tpch.TPCH_DDL, tpch.TABLE_ORDER, tpch.generate(0.01))
    yield js, ps
    js.close()
    ps.close()


@pytest.fixture(scope="module")
def ssb_env():
    js, ps = _pair("ssb", jax_ssb.SSB_DDL, jax_ssb.TABLE_ORDER, jax_ssb.generate(0.005))
    yield js, ps
    js.close()
    ps.close()


def port_ctx(inst, plan, collect=False):
    ctx = port_physical.ExecContext(inst.stores, inst.tso.next_timestamp(), inst.device,
                                    inst.device_cache, archive=inst.archive,
                                    archive_instance=inst,
                                    hints=getattr(plan, "hints", None))
    ctx.collect_stats = collect
    return ctx


def jax_ctx(inst, plan, collect=False):
    ctx = jax_physical.ExecContext(inst.stores, inst.tso.next_timestamp(), [],
                                   archive=inst.archive, archive_instance=inst,
                                   hints=getattr(plan, "hints", None))
    ctx.collect_stats = collect
    return ctx


def run_port(ps, sql, mesh=None, collect=False):
    inst = ps.instance
    plan = inst.planner.plan_select(sql, ps.schema)
    ctx = port_ctx(inst, plan, collect)
    out = port_mpp.MppExecutor(ctx, mesh or inst.mesh()).execute(plan.rel)
    return out, ctx, plan


def run_jax(js, sql, collect=False):
    inst = js.instance
    plan = inst.planner.plan_select(sql, js.schema)
    ctx = jax_ctx(inst, plan, collect)
    out = jax_mpp.MppExecutor(ctx, jax_make_mesh(S)).execute(plan.rel)
    return out, ctx, plan


def assert_same(mpp_rows, local_rows, ordered):
    """`tests/test_mpp.py:assert_same`."""
    if not ordered:
        keyf = lambda r: tuple(str(x) for x in r)  # noqa: E731
        mpp_rows = sorted(mpp_rows, key=keyf)
        local_rows = sorted(local_rows, key=keyf)
    assert len(mpp_rows) == len(local_rows)
    for a, b in zip(mpp_rows, local_rows):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= max(abs(y) * 1e-6, 1e-6)
            else:
                assert x == y


# `tests/test_mpp.py`'s: True = the result is ordered (compare in order)
TPCH_ORDERED = {1: True, 2: True, 3: True, 4: True, 5: True, 6: False, 7: True,
                8: True, 9: True, 10: True, 11: True, 12: True, 13: True,
                14: False, 15: True, 16: True, 17: False, 18: True, 19: False,
                20: True, 21: True, 22: True}


@pytest.mark.parametrize("qid", sorted(TPCH_ORDERED))
def test_tpch_mpp_matches_reference(tpch_env, qid):
    js, ps = tpch_env
    sql = QUERIES[qid]
    out, ctx, _plan = run_port(ps, sql)
    assert_same(out.to_pylist(), js.execute(sql).rows, TPCH_ORDERED[qid])
    assert any(t.startswith("mpp-scan") for t in ctx.trace)


@pytest.mark.parametrize("qid", sorted(jax_ssb.QUERIES))
def test_ssb_mpp_matches_reference(ssb_env, qid):
    js, ps = ssb_env
    sql = jax_ssb.QUERIES[qid]
    out, _ctx, _plan = run_port(ps, sql)
    assert_same(out.to_pylist(), js.execute(sql).rows, True)


def test_ssb_generator_is_the_reference(tmp_path):
    want, got = jax_ssb.generate(0.001), port_ssb.generate(0.001)
    assert sorted(want) == sorted(got)
    for t in want:
        for c in want[t]:
            assert np.array_equal(np.asarray(want[t][c]), np.asarray(got[t][c])), (t, c)


@pytest.fixture()
def shuffle_only(monkeypatch):
    """Every join takes the hash-shuffle shape (`tests/test_mpp.py`'s lever)."""
    monkeypatch.setattr(port_mpp, "BROADCAST_BUILD_LIMIT", 0)


SHUFFLE_SQL = ("SELECT o_orderpriority, count(*) AS n FROM orders, lineitem "
               "WHERE o_orderkey = l_orderkey AND l_quantity < 10 "
               "GROUP BY o_orderpriority ORDER BY o_orderpriority")


@pytest.mark.parametrize("qid", [None, 3, 5, 9, 18])
def test_shuffle_join_path(tpch_env, shuffle_only, qid):
    js, ps = tpch_env
    sql = SHUFFLE_SQL if qid is None else QUERIES[qid]
    out, ctx, _plan = run_port(ps, sql)
    assert_same(out.to_pylist(), js.execute(sql).rows,
                True if qid is None else TPCH_ORDERED[qid])
    assert not any("mpp-hybrid-join" in t for t in ctx.trace)


def test_semi_anti_join_mpp(tpch_env):
    js, ps = tpch_env
    sql = ("SELECT c_custkey FROM customer WHERE c_custkey IN "
           "(SELECT o_custkey FROM orders WHERE o_totalprice > 100) "
           "ORDER BY c_custkey LIMIT 20")
    assert_same(run_port(ps, sql)[0].to_pylist(), js.execute(sql).rows, True)
    sql2 = ("SELECT count(*) FROM customer WHERE c_custkey NOT IN "
            "(SELECT o_custkey FROM orders)")
    assert_same(run_port(ps, sql2)[0].to_pylist(), js.execute(sql2).rows, False)


class TestMppOperators:
    """`tests/test_mpp.py::TestMppOperators`: window / union / distinct /
    multi-distinct / topn distribute."""

    @pytest.fixture(scope="class")
    def wenv(self):
        rng = np.random.default_rng(5)
        w = {"k": np.array(["a", "b", "c"])[rng.integers(0, 3, 3000)],
             "v": rng.integers(0, 50, 3000), "y": rng.integers(0, 100, 3000)}
        w2 = {"k": np.array(["c", "d", "e"])[rng.integers(0, 3, 500)],
              "v": rng.integers(0, 50, 500)}
        ddl = {"w": "CREATE TABLE w (k VARCHAR(4), v BIGINT, y BIGINT)",
               "w2": "CREATE TABLE w2 (k VARCHAR(4), v BIGINT)"}
        js, ps = _pair("d", ddl, ["w", "w2"], {"w": w, "w2": w2})
        yield js, ps
        js.close()
        ps.close()

    CASES = {
        "window_frames": ("SELECT k, v, sum(v) OVER (PARTITION BY k ORDER BY v),"
                          " row_number() OVER (PARTITION BY k ORDER BY v DESC),"
                          " rank() OVER (PARTITION BY k ORDER BY v) FROM w"),
        "window_avg": "SELECT k, avg(y) OVER (PARTITION BY k) FROM w",
        "window_global": "SELECT k, rank() OVER (ORDER BY v) FROM w WHERE v < 5",
        "union_all": ("SELECT k, v FROM w WHERE v < 10 "
                      "UNION ALL SELECT k, v FROM w2 WHERE v > 40"),
        "union_distinct": "SELECT k FROM w UNION SELECT k FROM w2",
        "distinct": "SELECT DISTINCT k FROM w",
        "multi_distinct": ("SELECT k, count(DISTINCT v), sum(y), min(y) FROM w "
                           "GROUP BY k"),
        "topn": "SELECT k, v, y FROM w ORDER BY y DESC, v, k LIMIT 17",
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_operator_case(self, wenv, case):
        js, ps = wenv
        sql = self.CASES[case]
        ordered = "ORDER BY" in sql and "OVER" not in sql
        assert_same(run_port(ps, sql)[0].to_pylist(), js.execute(sql).rows, ordered)


# -- the archive scan, with and without pyarrow --------------------------------------

JAX = types.SimpleNamespace(name="jax", new=_jax_instance, Session=JaxSession,
                            archive=jax_archive, run=run_jax)
PORT = types.SimpleNamespace(name="port", new=_port_instance, Session=Session,
                             archive=port_archive, run=run_port)

ARCHIVE_SQL = ("SELECT count(*), sum(v) FROM ev",
               "SELECT d, count(*) FROM ev GROUP BY d ORDER BY d LIMIT 10")


@pytest.mark.parametrize("pyarrow_present", [True, False])
def test_archive_scan_distributes(tmp_path, monkeypatch, pyarrow_present):
    """`tests/test_mpp.py::TestMppArchive` through both packages' MPP: the archived
    rows join the scan (or, without pyarrow, the scan reads none of them)."""
    pytest.importorskip("pyarrow.parquet")

    def scenario(pkg):
        inst = pkg.new()
        inst.archive.directory = str(tmp_path / pkg.name)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE a; USE a")
        s.execute("CREATE TABLE ev (id BIGINT, d DATE, v BIGINT)")
        base = temporal.parse_date("2020-01-01")
        inst.store("a", "ev").insert_arrays(
            {"id": np.arange(2000), "d": base + np.arange(2000) % 100,
             "v": np.arange(2000) * 3}, inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE ev")
        n = inst.archive.archive_older_than(inst, "a", "ev", "d", base + 50)
        monkeypatch.setattr(pkg.archive, "PARQUET_AVAILABLE", pyarrow_present)
        seen = [n]
        for sql in ARCHIVE_SQL:
            out, ctx, _plan = pkg.run(s, sql)
            seen.append((out.to_pylist(), [t for t in ctx.trace if "archive" in t]))
        s.close()
        return seen
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert want[0] > 0 and want[1][1] and all("mpp-scan-archive" in t
                                              for t in want[1][1])


# -- session dispatch ------------------------------------------------------------------

def _dispatch_session(pkg, schema, rows, seed, fallback=False):
    inst = pkg.new()
    s = pkg.Session(inst)
    s.execute(f"CREATE DATABASE {schema}; USE {schema}")
    s.execute("CREATE TABLE t (k VARCHAR(4), v BIGINT)")
    rng = np.random.default_rng(seed)
    inst.store(schema, "t").insert_arrays(
        {"k": np.array(["x", "y", "z"])[rng.integers(0, 3, rows)],
         "v": np.arange(rows) if fallback else rng.integers(0, 1000, rows)},
        inst.tso.next_timestamp())
    s.execute("ANALYZE TABLE t")
    s.vars["MPP_MIN_AP_ROWS"] = 1000
    return inst, s


def test_session_runs_mpp_and_counts():
    """An AP query past MPP_MIN_AP_ROWS runs on the mesh: `mpp_queries` grows and
    the trace carries the `mpp-` tags, in both packages."""
    def scenario(pkg):
        inst, s = _dispatch_session(pkg, "sd", 50_000, 0)
        before = inst.counters["mpp_queries"]
        r = s.execute("SELECT k, sum(v), count(*) FROM t GROUP BY k ORDER BY k")
        out = (r.rows, inst.counters["mpp_queries"] - before,
               [t for t in s.last_trace if t.startswith("mpp-")])
        s.close()
        return out
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert want[1] == 1 and want[2]


def test_session_fallback_is_loud(monkeypatch):
    """A plan shape MPP refuses falls back to the local engine: the rows come back,
    `mpp_fallback_local` grows, the trace says `mpp-fallback`, and
    information_schema.engine_counters shows the counter."""
    def scenario(pkg, mod, err):
        def boom(self, node):
            raise err("test shape")
        monkeypatch.setattr(mod.MppExecutor, "run", boom)
        inst, s = _dispatch_session(pkg, "sd2", 60_000, 1, fallback=True)
        before = inst.counters["mpp_fallback_local"]
        r = s.execute("SELECT k, sum(v) FROM t GROUP BY k")
        trace = [t for t in s.last_trace if t.startswith("mpp-fallback")]
        counter = s.execute("SELECT value FROM information_schema.engine_counters "
                            "WHERE counter_name = 'mpp_fallback_local'").rows
        out = (sum(x[1] for x in r.rows), inst.counters["mpp_fallback_local"] - before,
               trace, counter)
        s.close()
        return out
    want = scenario(JAX, jax_mpp, jax_errors.NotSupportedError)
    got = scenario(PORT, port_mpp, errors.NotSupportedError)
    assert got == want
    assert want[0] == int(np.arange(60_000).sum()) and want[1] == 1
    assert want[2] == ["mpp-fallback test shape"] and want[3][0][0] >= 1


# -- the fallback set ------------------------------------------------------------------

# queries of TPC-H at SF 0.01 that fall back, with each reason: none distributes
# locally in either package (`tests/test_mpp.py` runs all 22 through the reference's
# MppExecutor)
MPP_FALLBACK_QUERIES_SF001 = {}


def _fallbacks(s, queries):
    out = {}
    for q in queries:
        s.execute("/*+TDDL: ENGINE(MPP) FRAGMENT_CACHE(OFF)*/ " + QUERIES[q])
        reasons = [t[len("mpp-fallback "):] for t in s.last_trace
                   if t.startswith("mpp-fallback")]
        if reasons:
            out[q] = reasons[0]
    return out


def test_tpch_fallback_set_is_the_constant(tpch_env):
    _js, ps = tpch_env
    before = ps.instance.counters["mpp_queries"]
    assert _fallbacks(ps, range(1, 23)) == MPP_FALLBACK_QUERIES_SF001
    assert ps.instance.counters["mpp_queries"] - before == 22


def test_cross_product_guard_falls_back_alike():
    """The reference's cross-product guard, the fallback the TPC-H Q15 shape meets
    once supplier x revenue0 passes 2^22 cells a shard (at SF 1 on the card,
    `chip_smoke.MPP_FALLBACK_QUERIES`): the same reason in both packages and the same
    rows from the local engine."""
    def scenario(pkg):
        inst = pkg.new()
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE xp; USE xp")
        s.execute("CREATE TABLE a (x BIGINT, y BIGINT)")
        s.execute("CREATE TABLE b (u BIGINT, w BIGINT)")
        inst.store("xp", "a").insert_arrays(
            {"x": np.arange(4096), "y": np.arange(4096) % 97},
            inst.tso.next_timestamp())
        inst.store("xp", "b").insert_arrays(
            {"u": np.arange(1100), "w": np.arange(1100) % 89},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE a, b")
        # one partition: all 4,096 rows on shard 0, times 1,100 > 2^22 cells
        rows = s.execute("/*+TDDL: ENGINE(MPP)*/ SELECT count(*), sum(y) FROM a, b "
                         "WHERE y < w").rows
        reasons = [t for t in s.last_trace if t.startswith("mpp-fallback")]
        s.close()
        return rows, reasons, inst.counters["mpp_fallback_local"]
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert want[1] and "MPP cross product too large" in want[1][0]


# -- EXPLAIN ANALYZE and per-shard rows --------------------------------------------------

_ACTUAL = re.compile(r"^(.*?)  \(actual rows=(\d+) ")


def _explain_nodes(rows):
    """(node line without its measured suffix, actual rows) per plan node, and the
    HotKeys/Salted/RuntimeFilter lines."""
    nodes, extra = [], []
    for (line,) in rows:
        if line.startswith("--"):
            continue
        if line.strip().startswith(("HotKeys(", "Salted(", "RuntimeFilter(")):
            extra.append(line)
            continue
        m = _ACTUAL.match(line)
        nodes.append((m.group(1), int(m.group(2))) if m else (line, None))
    return nodes, extra


@pytest.mark.parametrize("qid", [3, 5])
def test_explain_analyze_under_mpp_matches_reference(tpch_env, qid):
    js, ps = tpch_env
    sql = f"EXPLAIN ANALYZE /*+TDDL: ENGINE(MPP) FRAGMENT_CACHE(OFF)*/ {QUERIES[qid]}"
    want, got = js.execute(sql), ps.execute(sql)
    assert _explain_nodes(got.rows) == _explain_nodes(want.rows)
    assert any(t[0].startswith("-- mpp-scan") for t in got.rows)
    ops_of = [(ln[0].split(":")[0]) for ln in got.rows if ln[0].startswith("-- op ")]
    assert ops_of == [(ln[0].split(":")[0]) for ln in want.rows
                      if ln[0].startswith("-- op ")]


@pytest.mark.parametrize("qid", [3, 5])
def test_rows_per_shard_match_reference(tpch_env, qid):
    """Profiled MPP runs: every stage's rows on every shard equal the reference's
    (scans shard partitions by pid % S, exchanges by hash % S, alike)."""
    js, ps = tpch_env
    sql = "/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + QUERIES[qid]
    _o, jctx, _p = run_jax(js, sql, collect=True)
    _o, pctx, _p = run_port(ps, sql, collect=True)

    def shards(ctx):
        return [(st["operator"], st.get("rows_out"), st.get("rows_per_shard"),
                 st.get("shard_skew"), st.get("replicated"), st.get("fused", False))
                for st in ctx.op_stats]
    assert shards(pctx) == shards(jctx)
    assert any(st.get("rows_per_shard") for st in pctx.op_stats)


# -- placement ------------------------------------------------------------------------

def test_each_shard_stays_on_its_device(tpch_env):
    """A mesh of two shards on two distinct `torch.device` objects, and a context
    whose own device is `meta`: a stage that made a tensor on the context's device
    instead of its shard's would fail or leave it there.  Every output lane lies on
    its shard's device, and the rows equal the reference's."""
    js, ps = tpch_env
    inst = ps.instance
    mesh = make_mesh(devices=[torch.device("cpu"), torch.device("cpu", 0)])
    for q in (3, 5, 18):
        plan = inst.planner.plan_select("/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + QUERIES[q],
                                        "tpch")
        ctx = port_physical.ExecContext(inst.stores, inst.tso.next_timestamp(), "meta",
                                        archive=inst.archive, archive_instance=inst,
                                        hints=plan.hints)
        ex = port_mpp.MppExecutor(ctx, mesh)
        b = ex.run(plan.rel.child if isinstance(plan.rel, port_mpp.L.Sort) else plan.rel)
        if not b.replicated:
            for s, dev in enumerate(mesh.devices):
                assert b.live[s].device.type == dev.type
                for c in b.columns.values():
                    assert c.data[s].device.type == dev.type
        out = port_mpp.MppExecutor(ctx, mesh).execute(plan.rel)
        assert out.live is None or out.live.device.type == "cpu"
        for c in out.columns.values():
            assert c.data.device.type == "cpu"
        assert_same(out.to_pylist(), js.execute(QUERIES[q]).rows, TPCH_ORDERED[q])


def test_mesh_of_one_device_is_none():
    """`Instance.mesh()` is None on one device (here the CPU), as in the reference."""
    assert Instance(device="cpu").mesh() is None


def test_mesh_cache_keys_and_bytes(tpch_env):
    _js, ps = tpch_env
    sql = "/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + QUERIES[6]
    GLOBAL_MESH_CACHE.clear()
    run_port(ps, sql)
    n1 = GLOBAL_MESH_CACHE.nbytes
    assert n1 > 0
    run_port(ps, sql)
    assert GLOBAL_MESH_CACHE.nbytes == n1  # same store, version, mesh and columns
    run_port(ps, sql, mesh=cpu_mesh(4))
    assert GLOBAL_MESH_CACHE.nbytes > n1  # another shard count: its own entry


# -- the hash both sides classify and route by ---------------------------------------------

def test_host_and_device_hash_agree_on_every_lane():
    """`skew.hot_hash_lane` (the host's `_mix64`) and `hash_columns` over the lanes,
    including BIGINT UNSIGNED keys above 2^63 held as their int64 bits."""
    vals = np.array([0, 5, -3, 1 << 40, 123456789, -(1 << 63), (1 << 63) - 1],
                    dtype=np.int64)
    host = port_skew.hot_hash_lane(vals.tolist())
    assert (host.view(np.int64) == K.hash_columns(
        [(torch.from_numpy(vals), None)]).numpy()).all()
    assert (host == np.asarray(JK.hash_columns([(jnp.asarray(vals), None)]))).all()
    v32 = np.array([0, 5, -3, 77], dtype=np.int32)
    assert (port_skew.hot_hash_lane(v32.tolist()).view(np.int64) == K.hash_columns(
        [(torch.from_numpy(v32), None)]).numpy()).all()
    big = np.array([(1 << 63) + 1, (1 << 64) - 1, 1 << 63, 12345], dtype=np.uint64)
    host_u = jax_statistics._mix64(big)
    assert (host_u == port_skew.hot_hash_lane(big.view(np.int64).tolist())).all()
    bits = torch.from_numpy(big.view(np.int64))
    assert (K.hash_columns([(bits, None)]).numpy() == host_u.view(np.int64)).all()
    assert (np.asarray(JK.hash_columns([(jnp.asarray(big), None)])) == host_u).all()


# -- plain versions against the JAX functions ------------------------------------------------

def _hot_inputs(seed, n=4096, nhot=5, H=8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 300, n).astype(np.int64)
    keys2 = rng.integers(-5, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    hot_vals = rng.choice(300, nhot, replace=False).astype(np.int64)
    hot = np.zeros(H, np.uint64)
    hot[:nhot] = jax_statistics._mix64(hot_vals.astype(np.uint64))
    hv = np.zeros(H, np.bool_)
    hv[:nhot] = True
    return keys, keys2, valid, hot, hv


@pytest.mark.parametrize("seed,nhot", [(1, 5), (2, 0), (3, 8), (4, 1)])
def test_hot_key_mask_equals_reference(seed, nhot):
    keys, keys2, valid, hot, hv = _hot_inputs(seed, nhot=nhot)
    for lanes in ([(keys, None)], [(keys, valid)], [(keys, None), (keys2, valid)]):
        want = np.asarray(jax.jit(JK.hot_key_mask)(
            [(jnp.asarray(d), None if v is None else jnp.asarray(v)) for d, v in lanes],
            jnp.asarray(hot), jnp.asarray(hv)))
        got = K.hot_key_mask(
            [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
             for d, v in lanes],
            torch.from_numpy(hot.view(np.int64)), torch.from_numpy(hv)).numpy()
        assert np.array_equal(got, want)
        if nhot:
            assert want.any() or len(lanes) > 1


@pytest.mark.parametrize("seed,nb,npr,cap,dead", [
    (1, 1000, 3000, 4096, ""), (2, 300, 5000, 512, ""),   # the second overflows
    (3, 256, 100, 128, "build"), (4, 500, 256, 256, "probe"),
    (5, 2048, 2048, 16384, "")])
def test_hash_join_probe_hybrid_equals_reference(seed, nb, npr, cap, dead):
    """Seeded union lanes (NULL keys, dead rows; an all-dead build or probe side,
    the shape of a shard whose partitions hold nothing of a join)."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, 200, nb).astype(np.int64)
    pk = rng.integers(0, 260, npr).astype(np.int64)
    bv = rng.random(nb) > 0.05
    pv = rng.random(npr) > 0.05
    bl = (rng.random(nb) > 0.2) & (dead != "build")
    pl = (rng.random(npr) > 0.2) & (dead != "probe")
    want = jax.jit(JK.hash_join_probe_hybrid, static_argnums=4)(
        [(jnp.asarray(bk), jnp.asarray(bv))], [(jnp.asarray(pk), jnp.asarray(pv))],
        jnp.asarray(bl), jnp.asarray(pl), cap)
    got = K.hash_join_probe_hybrid([(torch.from_numpy(bk), torch.from_numpy(bv))],
                                   [(torch.from_numpy(pk), torch.from_numpy(pv))],
                                   torch.from_numpy(bl), torch.from_numpy(pl), cap)
    assert bool(got.overflow) == bool(want.overflow)
    live = np.asarray(want.live)
    assert np.array_equal(got.live.numpy(), live)
    for f in ("build_idx", "probe_idx"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.array_equal(g[live], w[live]), f
    assert np.array_equal(got.probe_matched.numpy(), np.asarray(want.probe_matched))
    assert np.array_equal(got.probe_starts.numpy(), np.asarray(want.probe_starts))
    assert np.array_equal(got.probe_offsets.numpy(), np.asarray(want.probe_offsets))


def _jax_repartition(nshards, lanes, live, h, quota):
    mesh = jax_make_mesh(nshards)
    spec = P("shard")

    def body(live_, h_, *lanes_):
        outs, live_x, over = jax_exchange.repartition_by_hash(list(lanes_), live_, h_,
                                                              quota)
        return (tuple(outs), live_x,
                jax.lax.pmax(over.astype(jnp.int32), "shard"))
    fn = jax.jit(jax_mpp.shard_map(body, mesh=mesh,
                                   in_specs=(spec, spec) + (spec,) * len(lanes),
                                   out_specs=((spec,) * len(lanes), spec, P()),
                                   check_vma=False))
    outs, live_x, over = fn(jnp.asarray(live), jnp.asarray(h),
                            *[jnp.asarray(x) for x in lanes])
    return [np.asarray(o) for o in outs], np.asarray(live_x), bool(over)


@pytest.mark.parametrize("nshards,R,quota,dead,empty", [
    (8, 256, 128, 0.2, None),      # every row fits
    (8, 256, 16, 0.0, None),       # overflow: quota too small
    (8, 256, 64, 0.7, 3),          # mostly dead rows, shard 3 empty
    (1, 512, 512, 0.1, None),      # S = 1
    (4, 128, 128, 0.3, 0),         # four shards, shard 0 empty
])
def test_repartition_by_hash_equals_reference(nshards, R, quota, dead, empty):
    rng = np.random.default_rng(nshards * 1000 + R + quota)
    n = nshards * R
    a = rng.integers(-1000, 1000, n).astype(np.int64)
    b = rng.random(n).astype(np.float32)
    c = rng.random(n) > 0.5
    live = rng.random(n) >= dead
    if empty is not None:
        live[empty * R:(empty + 1) * R] = False
    h = jax_statistics._mix64(rng.integers(0, 1 << 62, n).astype(np.uint64))
    want_lanes, want_live, want_over = _jax_repartition(nshards, [a, b, c], live, h,
                                                        quota)
    devices = [torch.device("cpu")] * nshards
    hb = h.view(np.int64)
    got_lanes, got_live, got_over = exchange.repartition_by_hash(
        [[torch.from_numpy(x[s * R:(s + 1) * R]) for x in (a, b, c)]
         for s in range(nshards)],
        [torch.from_numpy(live[s * R:(s + 1) * R]) for s in range(nshards)],
        [torch.from_numpy(hb[s * R:(s + 1) * R]) for s in range(nshards)],
        quota, devices)
    assert bool(got_over) == want_over
    assert np.array_equal(np.concatenate([x.numpy() for x in got_live]), want_live)
    for i in range(3):
        got = np.concatenate([got_lanes[d][i].numpy() for d in range(nshards)])
        assert np.array_equal(got, want_lanes[i]), i
    if quota == 16:
        assert want_over
