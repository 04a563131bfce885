"""The reference's TP host engine: the port against the JAX package on the CPU.

The reference hands the device cache only to AP plans, and only while
`ENABLE_TPU_ENGINE` holds.  Without a cache a scan yields host batches (numpy lanes
in the reference, marked CPU tensors in the port), and `FilterOp`, `ProjectOp` and
fused segments run them with the numpy expression backend up to `TP_HOST_ROWS`
rows, so floats compute in float64; every other operator takes them onto the
device.  These tests hold the port's rows to the reference's, exactly:

- the statements that showed the fault (float division, float products, `= 0.1`,
  and an AP table with the engine off);
- `ENABLE_TPU_ENGINE = 0` at session and global scope on TPC-H SF 0.01 (Q1, Q3, Q6,
  Q13, Q18 and a window query);
- a one-partition table past `TP_HOST_ROWS` with the engine off, which takes the
  torch formulation and gives the reference's float32 rows;
- TP statements through every device operator over small tables;
- the device cache untouched by TP statements and by their EXPLAIN ANALYZE;
- the C++ host runtime (`galaxysql_tpu_torch/native`): its three routed functions
  against their numpy bodies and the reference's library, and its build at first
  use, once for eight threads.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from galaxysql_tpu import native as jax_native
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch import native
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import table_store, transfer
from galaxysql_tpu_torch.storage.window_queries import WINDOW_QUERIES

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = [
    "CREATE DATABASE d", "USE d",
    "CREATE TABLE t (id INT PRIMARY KEY, a INT, f DOUBLE)",
    "INSERT INTO t VALUES (1, 10, 0.1), (2, 7, 0.2)",
    "CREATE TABLE s (id INT PRIMARY KEY, a INT, g DOUBLE, name VARCHAR(8)) "
    "PARTITION BY HASH(id) PARTITIONS 3",
    "INSERT INTO s VALUES " + ", ".join(
        f"({i}, {i % 7}, {(i % 11) / 4}, '{'xyz'[i % 3]}{i % 5}')" for i in range(1, 41)),
    "INSERT INTO s VALUES (41, NULL, NULL, NULL)",
    "CREATE TABLE u (tid INT, b VARCHAR(8))",
    "INSERT INTO u VALUES (1, 'one'), (2, 'two'), (2, 'deux'), (9, 'nine')",
    "CREATE TABLE big (id INT PRIMARY KEY, a INT, f DOUBLE)",
    "CREATE TABLE big1 (id INT PRIMARY KEY, a INT, f DOUBLE)",
]

# (rows of `big`, rows of `big1`): `big` fits one host batch (bucket 65,536), so it
# is AP by the planner's 50,000-row threshold and host-run with the engine off;
# `big1`'s one partition buckets to 114,688 rows, past TP_HOST_ROWS
BIG_ROWS, BIG1_ROWS = 60_000, 100_000


def _load_big(session, table, n):
    ids = np.arange(1, n + 1)
    inst = session.instance
    inst.store("d", table).insert_arrays(
        {"id": ids, "a": ids % 1000, "f": (ids % 10) / 10.0},
        inst.tso.next_timestamp())


@pytest.fixture(scope="module")
def small():
    js, ps = JaxSession(JaxInstance()), Session(Instance(device="cpu"))
    for s in (js, ps):
        for sql in SMALL:
            s.execute(sql)
        _load_big(s, "big", BIG_ROWS)
        _load_big(s, "big1", BIG1_ROWS)
    yield js, ps
    js.close()
    ps.close()


def _pair(small, sql):
    js, ps = small
    return js.execute(sql).rows, ps.execute(sql).rows


# -- the fault's statements ----------------------------------------------------------

FAULT = {
    "division": ("SELECT a / 3 FROM t WHERE id = 1", [(3.3333333333333335,)]),
    "float_product_ordered": ("SELECT a / 3, f * 3 FROM t ORDER BY id",
                              [(3.3333333333333335, 0.30000000447034836),
                               (2.3333333333333335, 0.6000000089406967)]),
    "float_equality": ("SELECT id FROM t WHERE f = 0.1", []),
}


@pytest.mark.parametrize("case", sorted(FAULT))
def test_fault_statements_give_the_reference_rows(small, case):
    sql, want = FAULT[case]
    ref, got = _pair(small, sql)
    assert ref == want
    assert got == ref


def test_engine_off_ap_table_gives_the_reference_rows(small):
    js, ps = small
    sql = "SELECT id, a / 3, f * 3 FROM big WHERE id < 3 ORDER BY id"
    for s in (js, ps):
        s.execute("SET ENABLE_TPU_ENGINE = 0")
    try:
        ref, got = _pair(small, sql)
    finally:
        for s in (js, ps):
            s.execute("SET ENABLE_TPU_ENGINE = 1")
    assert ref[0] == (1, 0.3333333333333333, 0.30000000447034836)
    assert got == ref
    # with the engine on the statement is AP and computes in float32 in both
    ref_on, got_on = _pair(small, sql)
    assert got_on == ref_on
    assert got_on[0] == (1, 0.3333333432674408, 0.30000001192092896)


# -- TP statements through every operator ---------------------------------------------

TP = {
    "filter_project_host": "SELECT id, a / 4, g * 3, g > 0.5 FROM s WHERE g < 2.25",
    "null_arithmetic": "SELECT id, a + NULL, COALESCE(a, 7) / 2 FROM s WHERE id > 38",
    "strings": "SELECT id, name, name LIKE 'x%' FROM s WHERE name IN ('x1', 'y2', 'z3')",
    "group_by": "SELECT a, COUNT(*), SUM(id), MIN(name), MAX(g) FROM s "
                "WHERE g < 2 GROUP BY a ORDER BY a",
    "group_by_prelude": "SELECT name, SUM(g * 3), AVG(a / 2) FROM s GROUP BY name "
                        "ORDER BY name",
    "global_aggregate": "SELECT COUNT(*), SUM(a), MAX(g * 2) FROM s WHERE a < 5",
    "join": "SELECT t.id, u.b FROM t JOIN u ON t.id = u.tid ORDER BY t.id, u.b",
    "join_filtered_probe": "SELECT s.id, u.b FROM s JOIN u ON s.id = u.tid "
                           "WHERE s.g * 3 > 0.1 ORDER BY s.id, u.b",
    "left_join": "SELECT u.tid, u.b, t.a FROM u LEFT JOIN t ON u.tid = t.id "
                 "ORDER BY u.tid, u.b",
    "semi_join": "SELECT id FROM s WHERE a IN (SELECT a FROM t) ORDER BY id",
    "scalar_subquery": "SELECT id FROM s WHERE a > (SELECT AVG(a) FROM t) ORDER BY id",
    "order_by_float": "SELECT id, g / 3 FROM s ORDER BY g / 3 DESC, id LIMIT 7",
    "limit": "SELECT id, f * 3 FROM t LIMIT 1",
    "distinct": "SELECT DISTINCT a FROM s ORDER BY a",
    "distinct_float": "SELECT DISTINCT g * 3 FROM s WHERE id < 12 ORDER BY 1",
    "union_all": "SELECT a / 3 FROM t UNION ALL SELECT g * 3 FROM s WHERE id < 4",
    "union_distinct": "SELECT a FROM t UNION SELECT a FROM s ORDER BY 1",
    "union_projected": "SELECT x / 3 FROM (SELECT a AS x FROM t UNION ALL "
                       "SELECT id FROM t) v",
    "window": "SELECT id, ROW_NUMBER() OVER (PARTITION BY a ORDER BY id), "
              "SUM(g) OVER (PARTITION BY a ORDER BY id) FROM s ORDER BY id",
    "values": "SELECT 1 / 3, 2.5 * 3, 0.1 + 0.2",
    "point_get_float": "SELECT f * 3, a / 3 FROM t WHERE id = 2",
    # float arithmetic over aggregate outputs: the finalize's host batch runs the
    # HAVING and the projection with numpy, in float64, as the reference's does
    "group_by_float_arithmetic": "SELECT a, SUM(g) / 3, AVG(g) * 3, MAX(g) / 7 FROM s "
                                 "GROUP BY a ORDER BY a",
    "having_float_sum": "SELECT a, COUNT(*) FROM s GROUP BY a HAVING SUM(g) > 2.75 "
                        "ORDER BY a",
    "global_aggregate_float_arithmetic": "SELECT SUM(g) / 3, AVG(s.a) * 0.1, "
                                         "SUM(f) / 3 FROM s, t WHERE s.id = t.id",
    "having_float_avg_over_a_join": "SELECT u.tid, AVG(t.f) * 3 FROM t JOIN u "
                                    "ON t.id = u.tid GROUP BY u.tid "
                                    "HAVING AVG(t.f) > 0.1 ORDER BY u.tid",
}


@pytest.mark.parametrize("case", sorted(TP))
def test_tp_statements_equal_the_reference(small, case):
    ref, got = _pair(small, TP[case])
    assert got == ref


def test_tp_result_is_a_host_batch(small):
    _js, ps = small
    rs = ps.execute("SELECT a / 3 FROM t WHERE id = 1")
    assert rs.batch.host == torch.device("cpu")
    assert rs.batch.columns[next(iter(rs.batch.columns))].data.dtype == torch.float64


def test_engine_off_past_tp_host_rows_takes_the_torch_formulation(small):
    """`big1`'s one batch is past TP_HOST_ROWS: Filter and Project run the torch
    formulation on the device in float32, the reference's jnp path."""
    js, ps = small
    sql = "SELECT id, a / 3, f * 3 FROM big1 WHERE id < 3"
    for s in (js, ps):
        s.execute("SET ENABLE_TPU_ENGINE = 0")
    try:
        ref, got = _pair(small, sql)
        rs = ps.execute(sql)
    finally:
        for s in (js, ps):
            s.execute("SET ENABLE_TPU_ENGINE = 1")
    assert ops.bucket_capacity(BIG1_ROWS) > ops.TP_HOST_ROWS
    assert got == ref
    assert got[0] == (1, 0.3333333432674408, 0.30000001192092896)
    assert rs.batch.host is None


# -- the device cache -----------------------------------------------------------------

def _cache_state(inst):
    c = inst.device_cache
    return c.nbytes, c.misses, c.hits


def test_tp_statements_leave_the_device_cache_alone(small):
    _js, ps = small
    inst = ps.instance
    before = _cache_state(inst)
    for sql in ("SELECT a / 3 FROM t WHERE id = 1", TP["join"], TP["group_by"],
                "EXPLAIN ANALYZE SELECT id, g * 3 FROM s WHERE g > 1"):
        ps.execute(sql)
        assert _cache_state(inst) == before, sql
    ps.execute("SELECT SUM(a), COUNT(*) FROM big")  # AP: reads through the cache
    after = _cache_state(inst)
    assert after[1] + after[2] > before[1] + before[2]
    ps.execute("SET ENABLE_TPU_ENGINE = 0")
    try:
        ps.execute("SELECT SUM(a), COUNT(*) FROM big")
        ps.execute("EXPLAIN ANALYZE SELECT SUM(a) FROM big")
        assert _cache_state(inst) == after
    finally:
        ps.execute("SET ENABLE_TPU_ENGINE = 1")


def test_explain_analyze_chooses_the_execution_context(small, monkeypatch):
    """EXPLAIN ANALYZE builds its context where execution does: a TP plan gets no
    device cache, an AP plan the instance's."""
    _js, ps = small
    seen = []
    real = Session._exec_context

    def spy(self, plan, params):
        ctx = real(self, plan, params)
        seen.append((plan.workload, ctx.device_cache))
        return ctx
    monkeypatch.setattr(Session, "_exec_context", spy)
    ps.execute("EXPLAIN ANALYZE SELECT id, g * 3 FROM s WHERE g > 1")
    ps.execute("EXPLAIN ANALYZE SELECT SUM(a) FROM big")
    assert seen == [("TP", None), ("AP", ps.instance.device_cache)]


# -- ENABLE_TPU_ENGINE = 0 on TPC-H ---------------------------------------------------

SF = 0.01
ENGINE_OFF_QUERIES = [1, 3, 6, 13, 18]
WINDOW = "w_one_partition"


@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(SF)
    ji = JaxInstance()
    js = JaxSession(ji)
    pi = Instance(device="cpu")
    ps = Session(pi)
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
    yield js, ps
    js.close()
    ps.close()


def _engine_off_rows(tpch_pair, scope, sql):
    js, ps = tpch_pair
    out = []
    for s in (js, ps):
        s.execute(f"SET {scope} ENABLE_TPU_ENGINE = 0")
        try:
            out.append(s.execute(sql).rows)
        finally:
            s.execute(f"SET {scope} ENABLE_TPU_ENGINE = 1")
    return out


@pytest.mark.parametrize("scope", ["SESSION", "GLOBAL"])
@pytest.mark.parametrize("q", ENGINE_OFF_QUERIES + [WINDOW])
def test_engine_off_tpch_equals_the_reference(tpch_pair, scope, q):
    sql = WINDOW_QUERIES[q] if q == WINDOW else QUERIES[q]
    ref, got = _engine_off_rows(tpch_pair, scope, sql)
    assert len(ref) > 0
    assert got == ref


def test_engine_off_reads_no_device_cache(tpch_pair):
    _js, ps = tpch_pair
    inst = ps.instance
    before = _cache_state(inst)
    _engine_off_rows(tpch_pair, "SESSION", QUERIES[1])
    assert _cache_state(inst) == before
    # Q1 is AP at SF 0.01: its scan fills the cache (the fragment cache, which
    # would replay the engine-off run's aggregate, is off)
    ps.execute("/*+TDDL:FRAGMENT_CACHE(OFF)*/ " + QUERIES[1])
    assert _cache_state(inst)[0] > before[0]


# -- the C++ host runtime -------------------------------------------------------------

INF = table_store.INFINITY_TS
TXN = 7_000_000_000_000_000_123
SNAP = 7_000_000_000_000_000_500


def _stamps(rng, n):
    """Committed, deleted before / after SNAP, provisional insert and delete of TXN,
    another transaction's provisional rows, and rolled back (INFINITY / 0)."""
    begin = rng.integers(SNAP - 1000, SNAP + 1000, n)
    end = np.full(n, INF, np.int64)
    cls = rng.integers(0, 7, n)
    end[cls == 1] = SNAP - 5
    end[cls == 2] = SNAP + 50
    begin[cls == 3] = -TXN
    end[cls == 4] = -TXN
    begin[cls == 5] = -(TXN + 1)
    begin[cls == 6], end[cls == 6] = INF, 0
    return begin.astype(np.int64), end


@pytest.mark.parametrize("snap", [SNAP, 0, None])
@pytest.mark.parametrize("txn_id", [0, TXN])
def test_visible_mask_equals_numpy_and_the_reference(snap, txn_id):
    rng = np.random.default_rng(11 + (txn_id % 7))
    begin, end = _stamps(rng, 5000)
    assert native.AVAILABLE and jax_native.AVAILABLE
    got = native.visible_mask(begin, end, snap, txn_id)
    plain = native.visible_mask_plain(begin, end, snap, txn_id)
    ref = jax_native.visible_mask(begin, end, snap, txn_id)
    assert got.dtype == plain.dtype == ref.dtype == np.bool_
    assert np.array_equal(got, plain) and np.array_equal(got, ref)
    # the store's own path (`Partition.visible_mask`) is the same function
    assert np.array_equal(table_store.visible_rows(begin, end, snap, txn_id), ref)


@pytest.mark.parametrize("nparts", [1, 3, 8, 61])
def test_hash_partition_equals_numpy_and_the_reference(nparts):
    rng = np.random.default_rng(nparts)
    keys = np.concatenate([rng.integers(-2**63, 2**63 - 1, 4000, dtype=np.int64),
                           np.array([0, -1, INF, -INF - 1], dtype=np.int64)])
    got = native.hash_partition(keys, nparts)
    assert got.dtype == np.int32
    assert np.array_equal(got, native.hash_partition_plain(keys, nparts))
    assert np.array_equal(got, jax_native.hash_partition(keys, nparts))


@pytest.mark.parametrize("n", [0, 1, 700, 20000])
def test_bloom_build_equals_numpy_and_the_reference(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    nwords = 1 << max(6, int(max(n, 1) * 2 // 8).bit_length())
    got = native.bloom_build(keys, nwords)
    assert got.dtype == np.uint64
    assert np.array_equal(got, native.bloom_build_plain(keys, nwords))
    assert np.array_equal(got, jax_native.bloom_build(keys, nwords))


def test_eight_threads_build_the_library_once(tmp_path):
    """A fresh interpreter with an empty build directory: eight threads import and
    call `native` at once, and g++ builds the library once."""
    script = textwrap.dedent(f"""
        import json, subprocess, sys, threading
        sys.path.insert(0, {ROOT!r})
        from galaxysql_tpu_torch.kernels import cuda_build
        cuda_build.BUILD_DIR = {str(tmp_path)!r}
        builds = []
        real_run = subprocess.run

        def counting_run(cmd, *a, **k):
            if "-o" in cmd:
                builds.append(cmd)
            return real_run(cmd, *a, **k)
        subprocess.run = counting_run
        import numpy as np
        start = threading.Barrier(8)
        out = []

        def worker():
            start.wait()
            from galaxysql_tpu_torch import native
            out.append(native.hash_partition(np.arange(100), 7).tolist())
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        from galaxysql_tpu_torch import native
        print(json.dumps({{"builds": len(builds), "available": native.AVAILABLE,
                          "same": all(o == out[0] for o in out), "n": len(out)}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"builds": 1, "available": True, "same": True, "n": 8}
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path) if ".tmp" in f]
