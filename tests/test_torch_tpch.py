"""The slice as a whole: TPC-H at SF 0.01 loaded into the JAX package's Session on the
CPU, carried into the port through `storage.transfer.store_from_arrays`, and queried
through both engines.  The port's scans must read the very lanes the reference holds,
and Q1, Q3, Q5 and Q6 must return identical rows (all four are decimal, integer, date
or string valued, so the comparison is exact)."""

import numpy as np
import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)

SF = 0.01


@pytest.fixture(scope="module")
def engines():
    data = tpch.generate(SF)
    ji = JaxInstance()
    js = JaxSession(ji)
    js.execute("CREATE DATABASE tpch")
    js.execute("USE tpch")
    pi = Instance(device="cpu")
    ps = Session(pi)
    ps.execute("CREATE DATABASE tpch")
    ps.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        js.execute(tpch.TPCH_DDL[t])
        ji.store("tpch", t).insert_pylists(data[t], ji.tso.next_timestamp())
        ps.execute(tpch.TPCH_DDL[t])
        parts, dicts = transfer.arrays_of(ji.store("tpch", t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table("tpch", t),
                                                    parts, dicts))
    yield ji, js, pi, ps
    js.close()
    ps.close()


def test_port_runs_on_the_requested_device(engines):
    _ji, _js, pi, ps = engines
    assert pi.device == torch.device("cpu")
    rs = ps.execute("select count(*) as n from region")
    assert rs.rows == [(5,)]
    assert rs.batch.columns[next(iter(rs.batch.columns))].data.device.type == "cpu"


@pytest.mark.parametrize("table", tpch.TABLE_ORDER)
def test_store_transfer_keeps_partitions_codes_and_stamps(engines, table):
    ji, _js, pi, _ps = engines
    jparts, jdicts = transfer.arrays_of(ji.store("tpch", table))
    pparts, pdicts = transfer.arrays_of(pi.store("tpch", table))
    assert jdicts == pdicts
    assert len(jparts) == len(pparts)
    for jp, pp in zip(jparts, pparts):
        for key in ("begin_ts", "end_ts"):
            assert np.array_equal(jp[key], pp[key])
        for col, lane in jp["lanes"].items():
            assert pp["lanes"][col].dtype == lane.dtype
            assert np.array_equal(pp["lanes"][col], lane)
            assert np.array_equal(pp["valid"][col], jp["valid"][col])


def test_scanned_lanes_are_identical(engines):
    _ji, js, _pi, ps = engines
    sql = ("select l_orderkey, l_extendedprice, l_discount, l_shipdate, l_returnflag "
           "from lineitem")
    ref = js.execute(sql).batch
    got = ps.execute(sql).batch
    assert ref.capacity == got.capacity > 0
    for name in ref.names():
        assert np.array_equal(ref.columns[name].np_data(), got.columns[name].np_data())


@pytest.mark.parametrize("q", [1, 3, 5, 6])
def test_tpch_query_rows_identical(engines, q):
    _ji, js, _pi, ps = engines
    ref = js.execute(QUERIES[q])
    got = ps.execute(QUERIES[q])
    assert got.names == ref.names
    assert len(got.rows) > 0
    assert got.rows == ref.rows


# The other TPC-H queries the slice's operators already cover: they add the left,
# semi and anti join paths (Q13, Q4/Q21/Q16/Q20), DISTINCT aggregates and deeper join
# trees.  Q11, Q15 and Q22 need the cross join of a scalar subquery, not ported yet.
@pytest.mark.parametrize("q", [2, 4, 7, 8, 9, 10, 12, 13, 14, 16, 17, 18, 19, 20, 21])
def test_more_tpch_queries_match(engines, q):
    _ji, js, _pi, ps = engines
    ref = js.execute(QUERIES[q])
    got = ps.execute(QUERIES[q])
    assert got.names == ref.names
    assert got.rows == ref.rows
