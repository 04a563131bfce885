"""TPC-H's refresh functions inside a transaction: the port against the JAX package.

TPC-H at SF 0.01 is loaded into the JAX package's Session and carried into the port
(`storage.transfer`).  A writer session W of each engine runs BEGIN, RF1 (SF x 1,500
new orders and their lineitems, a few multi-row INSERTs) and RF2 (SF x 1,500 orders
and their lineitems deleted with `IN` lists), made by `storage/tpch_refresh.py`.
Inside W, Q1, Q3 and Q18 see W's own writes; a second session R sees the snapshot
from before the refresh.  After COMMIT all 22 queries must return the same rows in
both engines, with and without ANALYZE; the MVCC stamps the scans read now hold
deleted and newly committed rows.

The last test holds the three visibility implementations against each other on
every stamp class: the port's host `Partition.visible_mask`, its device
`_device_visibility` on CPU tensors, and the reference's `native.visible_mask`.
"""

import numpy as np
import pytest
import torch

from galaxysql_tpu import native
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch.plan.physical import _device_visibility
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import tpch_refresh, transfer
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS, Partition

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

SF = 0.01
INSIDE = (1, 3, 18)


def _engine_pair(data):
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
    return ji, js, pi, ps


def _refresh_statements(pi):
    keys = np.concatenate([p.lanes["o_orderkey"]
                           for p in pi.store("tpch", "orders").partitions])
    rows = tpch_refresh.rf1_rows(SF, int(keys.max()))
    rf1 = tpch_refresh.rf1_statements(rows, rows_per_statement=20)
    rf2 = tpch_refresh.rf2_statements(tpch_refresh.rf2_keys(SF, keys))
    return rows, rf1, rf2


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF)


@pytest.fixture(scope="module")
def refreshed(data):
    """The pair after BEGIN; RF1; RF2; (queries inside and outside); COMMIT."""
    ji, js, pi, ps = _engine_pair(data)
    jr, pr = JaxSession(ji), Session(pi)
    jr.execute("USE tpch")
    pr.execute("USE tpch")
    before = {q: js.execute(QUERIES[q]).rows for q in INSIDE}
    rows, rf1, rf2 = _refresh_statements(pi)
    affected = []
    for sql in ["BEGIN"] + rf1 + rf2:
        want, got = js.execute(sql), ps.execute(sql)
        affected.append((got.affected, want.affected))
    inside = {q: (ps.execute(QUERIES[q]).rows, js.execute(QUERIES[q]).rows)
              for q in INSIDE}
    outside = {q: (pr.execute(QUERIES[q]).rows, jr.execute(QUERIES[q]).rows)
               for q in INSIDE}
    js.execute("COMMIT")
    ps.execute("COMMIT")
    yield {"ji": ji, "js": js, "pi": pi, "ps": ps, "before": before, "rows": rows,
           "rf1": rf1, "rf2": rf2, "affected": affected, "inside": inside,
           "outside": outside}
    for s in (js, ps, jr, pr):
        s.close()


def test_refresh_sizes_and_affected_counts(refreshed):
    n = tpch_refresh.refresh_orders(SF)
    rows = refreshed["rows"]
    assert n == 15 and len(rows["orders"]["o_orderkey"]) == n
    assert n <= len(rows["lineitem"]["l_orderkey"]) <= 7 * n
    assert len(refreshed["rf1"]) > 2  # a few multi-row INSERTs
    got = [g for g, _ in refreshed["affected"]]
    assert got == [w for _, w in refreshed["affected"]]
    li_deleted, o_deleted = got[-2:]
    assert o_deleted == n and n <= li_deleted <= 7 * n
    assert sum(got[1:-2]) == n + len(rows["lineitem"]["l_orderkey"])


@pytest.mark.parametrize("q", INSIDE)
def test_writer_sees_its_own_refresh(refreshed, q):
    got, want = refreshed["inside"][q]
    assert got == want
    if q == 1:  # RF1's lineitems ship before Q1's cutoff date
        assert got != refreshed["before"][q]


@pytest.mark.parametrize("q", INSIDE)
def test_other_session_sees_the_snapshot_before_the_refresh(refreshed, q):
    got, want = refreshed["outside"][q]
    assert got == want == refreshed["before"][q]


@pytest.mark.parametrize("table", ["orders", "lineitem"])
def test_committed_stores_equal_the_reference(refreshed, table):
    jparts, jdicts = transfer.arrays_of(refreshed["ji"].store("tpch", table))
    pparts, pdicts = transfer.arrays_of(refreshed["pi"].store("tpch", table))
    assert pdicts == jdicts
    for jp, pp in zip(jparts, pparts):
        for col, lane in jp["lanes"].items():
            assert pp["lanes"][col].tobytes() == lane.tobytes(), col
            assert np.array_equal(pp["valid"][col], jp["valid"][col]), col
        # no provisional stamp is left, and the same rows are live, dead or new
        for key in ("begin_ts", "end_ts"):
            assert (pp[key] >= 0).all() and (jp[key] >= 0).all()
        assert np.array_equal(pp["end_ts"] == INFINITY_TS, jp["end_ts"] == INFINITY_TS)
        assert np.array_equal(pp["begin_ts"] == pp["begin_ts"].max(),
                              jp["begin_ts"] == jp["begin_ts"].max())
    assert refreshed["pi"].store("tpch", table).row_count() == \
        refreshed["ji"].store("tpch", table).row_count()


@pytest.mark.parametrize("q", range(1, 23))
def test_queries_after_refresh_equal_the_reference(refreshed, q):
    ref = refreshed["js"].execute(QUERIES[q])
    got = refreshed["ps"].execute(QUERIES[q])
    assert got.names == ref.names
    assert got.rows == ref.rows


@pytest.fixture(scope="module")
def analyzed_after_refresh(refreshed):
    js, ps = refreshed["js"], refreshed["ps"]
    tables = ", ".join(tpch.TABLE_ORDER)
    js.execute(f"ANALYZE TABLE {tables}")
    ps.execute(f"ANALYZE TABLE {tables}")
    return js, ps


@pytest.mark.parametrize("q", range(1, 23))
def test_analyzed_queries_after_refresh_equal_the_reference(analyzed_after_refresh, q):
    js, ps = analyzed_after_refresh
    assert ps.instance.catalog.table("tpch", "lineitem").stats.row_count == \
        js.instance.catalog.table("tpch", "lineitem").stats.row_count
    ref = js.execute(QUERIES[q])
    got = ps.execute(QUERIES[q])
    assert got.names == ref.names
    assert got.rows == ref.rows


def test_visibility_classes_agree_host_device_reference():
    """Every stamp class against snapshots around it, with and without an owning
    transaction: committed before/after the snapshot, live (end INFINITY),
    deleted before/after, provisional insert and delete of the reader's own
    transaction and of another, a rolled-back insert (begin INFINITY, end 0), an
    own insert-then-delete, and a fused pad row (begin 0, end -1).  TSO-sized
    values (phys_ms << 22) check that nothing passes through float."""
    base = 1_734_000_000_000 << 22
    own, other = base + 7, base + 9
    t1, t2, t3 = base + 3, base + 8, base + 12
    classes = [
        (t1, INFINITY_TS), (t2, INFINITY_TS), (t3, INFINITY_TS),
        (t1, t2), (t1, t3), (t1, t1), (t1, t1 + 1),
        (-own, INFINITY_TS), (-other, INFINITY_TS),
        (t1, -own), (t1, -other), (-own, -own), (-other, -other),
        (INFINITY_TS, 0), (0, -1), (0, INFINITY_TS),
    ]
    begin = np.array([b for b, _ in classes], dtype=np.int64)
    end = np.array([e for _, e in classes], dtype=np.int64)
    p = Partition.__new__(Partition)
    p.begin_ts, p.end_ts = begin, end
    seen = set()
    for ts in (None, t1 - 1, t1, t2 - 1, t2, t2 + 1, t3, INFINITY_TS - 1):
        for txn_id in (0, own, other):
            host = p.visible_mask(ts, txn_id)
            ref = native.visible_mask(begin, end, ts, txn_id)
            dev = _device_visibility(torch.from_numpy(begin), torch.from_numpy(end),
                                     ts, txn_id).numpy()
            assert host.dtype == np.bool_ and dev.dtype == np.bool_
            assert np.array_equal(host, ref), (ts, txn_id)
            assert np.array_equal(dev, ref), (ts, txn_id)
            seen.add(tuple(host.tolist()))
    assert len(seen) > 10  # the snapshots and owners really tell the classes apart
