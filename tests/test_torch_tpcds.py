"""TPC-DS, cross joins, UNION and VALUES: the port against the JAX package on the CPU.

TPC-DS at the reference suite's SF 0.003 (`tests/test_tpcds.py`) is loaded into each
engine by its own `insert_pylists` from the same generated Python lists: the scanned
lanes, codes and dictionaries must be identical.  After ANALYZE on both, the 10
queries of the subset (star joins, ROLLUP as a UNION ALL of grouping sets, CASE
aggregates) must return equal rows; the comparison is exact, since the port computes
the same float32 and scaled-integer values in the same order as the reference.

Then the statement shapes this slice adds, on small tables carried into the port
with `storage/transfer.py`: a scalar subquery of more than one row raises the
reference's error, an empty one gives NULL, UNION ALL / UNION DISTINCT of string
columns from tables with different dictionaries decode to the reference's rows, and
SELECT without FROM (a VALUES row) returns the reference's row."""

import numpy as np
import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpcds as jax_tpcds
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import tpcds, transfer
from galaxysql_tpu_torch.utils import errors as port_errors

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)

SF = 0.003


@pytest.fixture(scope="module")
def tpcds_engines():
    data = tpcds.generate(SF)
    ji = JaxInstance()
    js = JaxSession(ji)
    js.execute("CREATE DATABASE tpcds; USE tpcds")
    pi = Instance(device="cpu")
    ps = Session(pi)
    ps.execute("CREATE DATABASE tpcds")
    ps.execute("USE tpcds")
    for t in tpcds.TABLE_ORDER:
        js.execute(tpcds.TPCDS_DDL[t])
        ji.store("tpcds", t).insert_pylists(data[t], ji.tso.next_timestamp())
        ps.execute(tpcds.TPCDS_DDL[t])
        pi.store("tpcds", t).insert_pylists(data[t], pi.tso.next_timestamp())
    tables = ", ".join(tpcds.TABLE_ORDER)
    js.execute(f"ANALYZE TABLE {tables}")
    ps.execute(f"ANALYZE TABLE {tables}")
    yield ji, js, pi, ps
    js.close()
    ps.close()


def test_generator_is_the_reference_generator():
    assert tpcds.generate(SF) == jax_tpcds.generate(SF)


@pytest.mark.parametrize("table", tpcds.TABLE_ORDER)
def test_insert_pylists_gives_the_reference_lanes_and_codes(tpcds_engines, table):
    ji, _js, pi, _ps = tpcds_engines
    jparts, jdicts = transfer.arrays_of(ji.store("tpcds", table))
    pparts, pdicts = transfer.arrays_of(pi.store("tpcds", table))
    assert pdicts == jdicts
    assert len(pparts) == len(jparts)
    for jp, pp in zip(jparts, pparts):
        assert pp["lanes"].keys() == jp["lanes"].keys()
        for col, lane in jp["lanes"].items():
            assert pp["lanes"][col].dtype == lane.dtype
            assert np.array_equal(pp["lanes"][col], lane)
            assert np.array_equal(pp["valid"][col], jp["valid"][col])
    assert pi.catalog.table("tpcds", table).stats.row_count == \
        ji.catalog.table("tpcds", table).stats.row_count


def test_scanned_store_sales_lanes_are_identical(tpcds_engines):
    _ji, js, _pi, ps = tpcds_engines
    sql = ("select ss_item_sk, ss_sold_date_sk, ss_list_price, ss_coupon_amt "
           "from store_sales")
    ref = js.execute(sql).batch
    got = ps.execute(sql).batch
    assert ref.capacity == got.capacity > 0
    for name in ref.names():
        assert np.array_equal(ref.columns[name].np_data(), got.columns[name].np_data())


@pytest.mark.parametrize("name", list(tpcds.QUERIES))
def test_tpcds_query_rows_equal(tpcds_engines, name):
    _ji, js, _pi, ps = tpcds_engines
    ref = js.execute(tpcds.QUERIES[name])
    got = ps.execute(tpcds.QUERIES[name])
    assert got.names == ref.names
    assert len(got.rows) > 0
    assert got.rows == ref.rows


def test_insert_pylists_nulls_defaults_and_first_appearance_codes():
    """NULLs, a missing column (its default), decimals on a rounding tie, dates given
    as strings and strings seen again: lanes, validity and codes as the reference's."""
    ddl = ("CREATE TABLE t (k INT NOT NULL, s VARCHAR(8), d DECIMAL(7,2), "
           "dt DATE, f DOUBLE, z INT DEFAULT 7)")
    data = {"k": [3, 1, 2, 5], "s": ["b", None, "a", "b"],
            "d": [0.125, None, 2.675, -1.005], "dt": ["1998-01-02", None,
                                                      "2001-12-31", "1970-01-01"],
            "f": [0.1, 2.5, None, -3.25]}
    ji = JaxInstance()
    js = JaxSession(ji)
    js.execute("CREATE DATABASE p; USE p")
    js.execute(ddl)
    ji.store("p", "t").insert_pylists(data, 1)
    pi = Instance(device="cpu")
    ps = Session(pi)
    ps.execute("CREATE DATABASE p")
    ps.execute("USE p")
    ps.execute(ddl)
    pi.store("p", "t").insert_pylists(data, 1)
    jparts, jdicts = transfer.arrays_of(ji.store("p", "t"))
    pparts, pdicts = transfer.arrays_of(pi.store("p", "t"))
    assert pdicts == jdicts == {"s": ["b", "a"]}
    for jp, pp in zip(jparts, pparts):
        for col, lane in jp["lanes"].items():
            assert pp["lanes"][col].dtype == lane.dtype, col
            assert np.array_equal(pp["lanes"][col], lane), col
            assert np.array_equal(pp["valid"][col], jp["valid"][col]), col
    with pytest.raises(port_errors.TddlError, match="cannot be null"):
        pi.store("p", "t").insert_pylists({"k": [None]}, 2)


# -- cross join, UNION, VALUES -------------------------------------------------------

TABLES = {
    "a": ("CREATE TABLE a (id INT, name VARCHAR(10), v BIGINT)",
          "INSERT INTO a VALUES (1, 'x', 10), (2, 'y', 20), (3, 'z', NULL), "
          "(4, 'y', 40)"),
    "b": ("CREATE TABLE b (id INT, label VARCHAR(10), w BIGINT)",
          "INSERT INTO b VALUES (7, 'y', 5), (8, 'q', 6), (9, 'x', 7), (10, NULL, 8)"),
    "one": ("CREATE TABLE one (c BIGINT)", "INSERT INTO one VALUES (42)"),
}


@pytest.fixture(scope="module")
def small():
    ji = JaxInstance()
    js = JaxSession(ji)
    js.execute("CREATE DATABASE s; USE s")
    pi = Instance(device="cpu")
    ps = Session(pi)
    ps.execute("CREATE DATABASE s")
    ps.execute("USE s")
    for t, (ddl, ins) in TABLES.items():
        js.execute(ddl)
        js.execute(ins)
        ps.execute(ddl)
        parts, dicts = transfer.arrays_of(ji.store("s", t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table("s", t), parts,
                                                    dicts))
    yield js, ps
    js.close()
    ps.close()


def test_scalar_subquery_of_more_than_one_row_raises(small):
    js, ps = small
    q = "SELECT id, (SELECT w FROM b) AS w FROM a"
    with pytest.raises(jax_errors.TddlError) as ref:
        js.execute(q)
    with pytest.raises(port_errors.TddlError) as got:
        ps.execute(q)
    assert str(got.value) == str(ref.value) == "Subquery returns more than 1 row"


def test_empty_scalar_subquery_gives_null(small):
    _js, ps = small
    rows = ps.execute("SELECT id, (SELECT w FROM b WHERE w > 100) AS w FROM a "
                      "ORDER BY id").rows
    assert rows == [(1, None), (2, None), (3, None), (4, None)]


@pytest.mark.parametrize("q", [
    # empty scalar side: NULL, every outer row kept
    "SELECT id, (SELECT w FROM b WHERE w > 100) AS w FROM a ORDER BY id",
    "SELECT id FROM a WHERE v > (SELECT max(w) FROM b WHERE w > 100) ORDER BY id",
    # one-row scalar side broadcast into the outer rows
    "SELECT id, v - (SELECT c FROM one) AS d FROM a ORDER BY id",
    "SELECT id, name FROM a WHERE v > (SELECT avg(w) * 2 FROM b) ORDER BY id",
    # the TPC-H Q22 shape: a scalar aggregate compared inside a filter
    "SELECT count(*) AS n, sum(v) AS s FROM a WHERE v > (SELECT min(w) FROM b)",
])
def test_cross_join_of_a_scalar_subquery_rows_equal(small, q):
    js, ps = small
    ref = js.execute(q)
    got = ps.execute(q)
    assert got.names == ref.names
    assert got.rows == ref.rows


@pytest.mark.parametrize("q", [
    "SELECT name FROM a UNION ALL SELECT label FROM b",
    "SELECT name FROM a UNION SELECT label FROM b ORDER BY name",
    "SELECT label FROM b UNION DISTINCT SELECT name FROM a ORDER BY label",
    "SELECT name, v FROM a UNION ALL SELECT label, w FROM b ORDER BY v",
    "SELECT name FROM a UNION SELECT label FROM b UNION ALL SELECT name FROM a",
    "SELECT count(*) AS n FROM (SELECT name FROM a UNION SELECT label FROM b) u",
])
def test_union_of_string_columns_with_different_dictionaries(small, q):
    js, ps = small
    ref = js.execute(q)
    got = ps.execute(q)
    assert got.names == ref.names
    if "ORDER BY" in q:
        assert got.rows == ref.rows
    else:  # UNION without ORDER BY: the order of rows is unspecified
        assert sorted(got.rows, key=repr) == sorted(ref.rows, key=repr)
    assert len(got.rows) > 0


@pytest.mark.parametrize("q", [
    "SELECT 1 AS a, NULL AS c, 2.5 AS d",
    "SELECT 1 + 2 AS s, 10 / 4 AS q, -7 AS m",
    "SELECT 1 AS a UNION ALL SELECT 2 UNION ALL SELECT 1",
    "SELECT 1 AS a UNION SELECT 2 UNION SELECT 1 ORDER BY a",
    "SELECT name, NULL AS z, 7 AS k FROM a ORDER BY id",
])
def test_values_and_constant_rows_equal(small, q):
    js, ps = small
    ref = js.execute(q)
    got = ps.execute(q)
    assert got.names == ref.names
    if "ORDER BY" in q or "UNION" not in q:
        assert got.rows == ref.rows
    else:
        assert sorted(got.rows, key=repr) == sorted(ref.rows, key=repr)
