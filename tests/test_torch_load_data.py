"""LOAD DATA INFILE: the port against the JAX package on the CPU.

The same files are loaded through both engines' sessions (`test_torch_dml.Pair`),
and after every statement the two must agree on the affected count and info text,
the rows of a SELECT, every partition's lanes, validity and dictionaries bit for bit
(GSI tables included) and the MVCC stamps by class and rank.  LOAD DATA writes no
binlog event in either engine.

Covered: the reference's `TestLoadData` case (`tests/test_priv_load.py`); the tab
default, `|` with a trailing separator (TPC-H's `.tbl` files), an enclosure, `\\N`,
a column list in another order, short rows; DML_BATCH_SIZE smaller than the file;
a load inside a transaction, committed and rolled back; a table with a covering
GSI; the missing-file error; the privilege check.
"""

import pytest
import torch

from test_torch_dml import Pair

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

TABLE = """CREATE TABLE t (
    id BIGINT NOT NULL PRIMARY KEY,
    name VARCHAR(20),
    amount DECIMAL(12,2),
    d DATE,
    v DOUBLE
) PARTITION BY HASH(id) PARTITIONS 4"""
SELECT_ALL = "SELECT id, name, amount, d, v FROM t ORDER BY id"

# name -> (file text, the clauses after INTO TABLE t)
FORMATS = {
    "tab_default": ("1\tann\t3.50\t2024-01-01\t1.5\n"
                    "2\tbob\t-4.25\t2023-12-31\t-0.25\n"
                    "3\t\t\t\t\n", ""),
    "pipe_trailing_separator": ("1|ann|3.50|2024-01-01|1.5|\n"
                                "2|bob|4.25|2024-02-29|2.0|\n"
                                "3|carol|0.01|2020-07-04|1e10|\n",
                                "FIELDS TERMINATED BY '|'"),
    "enclosure": ('1,"ann, the first",3.50,2024-01-01,1.5\n'
                  '2,"bob ""b""",4.25,2024-06-15,2.0\n',
                  "FIELDS TERMINATED BY ',' ENCLOSED BY '\"'"),
    "backslash_n_nulls": ("1,\\N,3.50,\\N,1.5\n2,bob,\\N,2024-06-15,\\N\n",
                          "FIELDS TERMINATED BY ','"),
    "column_list_reordered": ("ann,1,2024-01-01\nbob,2,2023-01-02\n,3,\n",
                              "FIELDS TERMINATED BY ',' (name, id, d)"),
    "short_rows": ("1,ann,3.50\n2\n3,carol,1.00,2024-01-01,7.5\n",
                   "FIELDS TERMINATED BY ','"),
    "ignore_lines": ("id,name\n# comment\n1,ann\n2,bob\n",
                     "FIELDS TERMINATED BY ',' IGNORE 2 LINES (id, name)"),
}


def _load(path, clauses, table="t"):
    return f"LOAD DATA INFILE '{path}' INTO TABLE {table} {clauses}"


def _events(pair):
    return (len(pair.ji.cdc.events()), len(pair.pi.cdc.events()))


def test_reference_csv_ingestion(tmp_path):
    """The reference's `TestLoadData.test_csv_ingestion`, through both engines."""
    pair = Pair("l")
    pair.run("W", "CREATE TABLE t (id BIGINT, name VARCHAR(20), amt DECIMAL(10,2)) "
                  "PARTITION BY HASH(id) PARTITIONS 4")
    p = tmp_path / "data.csv"
    p.write_text("id,name,amt\n1,ann,3.50\n2,bob,4.25\n3,,\n")
    rs = pair.run("W", f"LOAD DATA INFILE '{p}' INTO TABLE t "
                       "FIELDS TERMINATED BY ',' IGNORE 1 LINES (id, name, amt)")
    assert rs.affected == 3 and rs.info == "Records: 3"
    rows = pair.run("W", "SELECT id, name, amt FROM t ORDER BY id").rows
    assert rows == [(1, "ann", 3.5), (2, "bob", 4.25), (3, None, None)]
    pair.assert_same_state()


@pytest.mark.parametrize("name", list(FORMATS))
def test_format_matches_reference(name, tmp_path):
    text, clauses = FORMATS[name]
    p = tmp_path / f"{name}.txt"
    p.write_text(text)
    pair = Pair()
    pair.run("W", TABLE)
    pair.run("W", "INSERT INTO t (id, name) VALUES (100, 'zed')")
    events = _events(pair)
    rs = pair.run("W", _load(p, clauses))
    assert rs.affected > 0
    assert _events(pair) == events  # LOAD DATA logs nothing, in both engines
    pair.assert_same_state()
    pair.run("W", SELECT_ALL)
    # the loaded rows join the dictionaries and the planner's view of the table
    pair.run("W", "SELECT name, count(*), sum(amount) FROM t GROUP BY name")
    pair.run("W", "SELECT id FROM t WHERE name = 'bob'")


def test_batches_smaller_than_the_file(tmp_path):
    p = tmp_path / "many.txt"
    p.write_text("".join(f"{i}|n{i % 7}|{i}.25|2024-01-{1 + i % 28:02d}|{i / 4}|\n"
                         for i in range(1, 101)))
    pair = Pair()
    pair.run("W", TABLE)
    pair.run("W", "SET DML_BATCH_SIZE = 7")
    rs = pair.run("W", _load(p, "FIELDS TERMINATED BY '|'"))
    assert rs.affected == 100
    pair.assert_same_state()
    pair.run("W", SELECT_ALL)


@pytest.mark.parametrize("end", ["COMMIT", "ROLLBACK"])
def test_load_inside_a_transaction(end, tmp_path):
    p = tmp_path / "txn.txt"
    p.write_text("1|ann|1.00|2024-01-01|1.0|\n2|bob|2.00|2024-01-02|2.0|\n"
                 "3|carol|3.00|2024-01-03|3.0|\n")
    pair = Pair()
    pair.run("W", TABLE)
    pair.run("R", "SELECT count(*) FROM t")
    events = _events(pair)
    pair.run("W", "BEGIN")
    pair.run("W", _load(p, "FIELDS TERMINATED BY '|'"))
    pair.assert_same_state()  # provisional stamps
    assert pair.run("W", "SELECT count(*) FROM t").rows == [(3,)]  # own writes
    assert pair.run("R", "SELECT count(*) FROM t").rows == [(0,)]  # not yet
    pair.run("W", end)
    pair.assert_same_state()
    want = [(3,)] if end == "COMMIT" else [(0,)]
    assert pair.run("R", "SELECT count(*) FROM t").rows == want
    pair.run("W", SELECT_ALL)
    assert _events(pair) == events


def test_load_into_a_table_with_a_covering_gsi(tmp_path):
    p = tmp_path / "gsi.txt"
    p.write_text("".join(f"{i},{i % 5},c{i % 3}\n" for i in range(1, 41)))
    pair = Pair()
    pair.run("W", "CREATE TABLE sb (id BIGINT NOT NULL PRIMARY KEY, k INT, c VARCHAR(8))"
                  " PARTITION BY HASH(id) PARTITIONS 4")
    pair.run("W", "INSERT INTO sb VALUES (1000, 3, 'x')")
    pair.run("W", "CREATE GLOBAL INDEX g_k ON sb (k) COVERING (c)")
    events = _events(pair)
    rs = pair.run("W", _load(p, "FIELDS TERMINATED BY ','", table="sb"))
    assert rs.affected == 40
    assert "sb$g_k" in pair.tables()
    pair.assert_same_state()  # the GSI's table took the rows too
    pair.run("W", "SELECT c FROM sb WHERE k = 3 ORDER BY c")
    pair.run("W", "SELECT k, count(*) FROM sb$g_k GROUP BY k ORDER BY k")
    assert _events(pair) == events


def test_missing_file_raises_the_reference_error(tmp_path):
    pair = Pair()
    pair.run("W", TABLE)
    sql = _load(tmp_path / "absent.csv", "FIELDS TERMINATED BY ','")
    messages = []
    for s in pair.session("W"):
        with pytest.raises(Exception) as e:
            s.execute(sql)
        messages.append((type(e.value).__name__, str(e.value)))
    assert messages[0] == messages[1]
    assert "Can't read file" in messages[1][1]
    pair.assert_same_state()


def test_load_needs_the_insert_privilege(tmp_path):
    p = tmp_path / "priv.txt"
    p.write_text("1|ann|1.00|2024-01-01|1.0|\n")
    pair = Pair()
    pair.run("W", TABLE)
    pair.run("W", "CREATE USER 'reader'")
    pair.run("W", "GRANT SELECT ON test.* TO 'reader'")
    pair.run("W", "CREATE USER 'loader'")
    pair.run("W", "GRANT INSERT ON test.t TO 'loader'")
    for s in pair.session("U"):
        s.user = "reader"
    assert pair.run("U", _load(p, "FIELDS TERMINATED BY '|'")).__name__ == \
        "AccessDeniedError"
    for s in pair.session("U"):
        s.user = "loader"
    assert pair.run("U", _load(p, "FIELDS TERMINATED BY '|'")).affected == 1
    pair.assert_same_state()
