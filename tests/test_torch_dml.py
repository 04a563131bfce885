"""Writes and transactions: the port against the JAX package on the CPU.

The same statements go through `galaxysql_tpu.server.session.Session` and the port's
`Session(Instance(device="cpu"))`, in the same order, from one or two sessions of
each engine.  After every statement the two must agree on:

- the affected row count, or the error type;
- a SELECT's rows (as multisets where the statement has no ORDER BY: an UPDATE
  moves the new row versions to the end of their partition in both engines, but a
  hash-partitioned scan gives no order);
- every partition's lanes, validity masks and string dictionaries, bit for bit;
- every partition's MVCC stamps, mapped to their class (committed, INFINITY,
  provisional -txn_id, dead 0) and, within the committed and provisional classes,
  to their rank among the engine's timestamps: the two engines draw different TSO
  values, in the same order.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from galaxysql_tpu.plan import planner as jax_planner
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.plan import planner as port_planner
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


class Pair:
    """One engine pair with named sessions ("W", "R", ...) on each side."""

    def __init__(self, schema="test"):
        self.ji = JaxInstance()
        self.pi = Instance(device="cpu")
        self.schema = schema
        self.sessions = {}
        self.run("W", f"CREATE DATABASE {schema}")
        self.run("W", f"USE {schema}")

    def session(self, name):
        if name not in self.sessions:
            js, ps = JaxSession(self.ji), Session(self.pi)
            if self.sessions:
                js.execute(f"USE {self.schema}")
                ps.execute(f"USE {self.schema}")
            self.sessions[name] = (js, ps)
        return self.sessions[name]

    def run(self, name, sql):
        """Runs `sql` in session `name` of both engines; both must give the same
        result or raise the same error type.  Returns the port's result (or the
        error type)."""
        js, ps = self.session(name)
        want = got = None
        try:
            want = js.execute(sql)
        except jax_errors.TddlError as e:
            want = e
        try:
            got = ps.execute(sql)
        except errors.TddlError as e:
            got = e
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert type(got).__name__ == type(want).__name__, (sql, want, got)
            return type(got)
        assert got.affected == want.affected, sql
        assert got.names == want.names, sql
        if "order by" in sql.lower():
            assert got.rows == want.rows, sql
        else:
            assert _multiset(got.rows) == _multiset(want.rows), sql
        return got

    def tables(self):
        return [t.name for t in self.pi.catalog.schema(self.schema).tables.values()]

    def assert_same_state(self):
        jstamps, pstamps = _stamp_ranks(self.ji), _stamp_ranks(self.pi)
        for t in self.tables():
            jstore, pstore = self.ji.store(self.schema, t), self.pi.store(self.schema, t)
            jparts, jdicts = transfer.arrays_of(jstore)
            pparts, pdicts = transfer.arrays_of(pstore)
            assert pdicts == jdicts, t
            assert len(pparts) == len(jparts)
            for pid, (jp, pp) in enumerate(zip(jparts, pparts)):
                for col, lane in jp["lanes"].items():
                    assert pp["lanes"][col].dtype == lane.dtype, (t, col)
                    assert pp["lanes"][col].tobytes() == lane.tobytes(), (t, pid, col)
                    assert np.array_equal(pp["valid"][col], jp["valid"][col]), (t, col)
                for key in ("begin_ts", "end_ts"):
                    assert _classes(pp[key], pstamps) == _classes(jp[key], jstamps), \
                        (t, pid, key)
            assert pstore.row_count() == jstore.row_count()
            assert self.pi.catalog.table(self.schema, t).auto_increment_next == \
                self.ji.catalog.table(self.schema, t).auto_increment_next


def _multiset(rows):
    return sorted(rows, key=repr)


def _stamp_ranks(inst):
    """Rank of every timestamp an engine's stamps hold (commit stamps and, for
    provisional stamps, the transaction ids), over all of its tables."""
    values = set()
    for store in inst.stores.values():
        for p in store.partitions:
            for a in (p.begin_ts, p.end_ts):
                a = np.asarray(a)
                a = np.abs(a[(a != 0) & (a != INFINITY_TS)])
                values.update(a.tolist())
    return {v: i for i, v in enumerate(sorted(values))}


def _classes(stamps, ranks):
    out = []
    for v in np.asarray(stamps).tolist():
        if v == INFINITY_TS:
            out.append("inf")
        elif v == 0:
            out.append("dead")
        elif v < 0:
            out.append(("provisional", ranks[-v]))
        else:
            out.append(("committed", ranks[v]))
    return out


TYPED_TABLE = """CREATE TABLE t (
    id BIGINT NOT NULL PRIMARY KEY,
    name VARCHAR(20),
    amount DECIMAL(12,2),
    d DATE,
    v DOUBLE
) PARTITION BY HASH(id) PARTITIONS 4"""
TYPED_ROWS = ("INSERT INTO t (id, name, amount, d, v) VALUES "
              "(1, 'alice', 10.50, '2024-01-01', 1.5), "
              "(2, 'bob', 20.25, '2024-06-15', 2.25), "
              "(3, NULL, NULL, NULL, NULL), "
              "(4, 'carol', -3.33, '2023-12-31', -0.1), "
              "(5, 'dave', 0.01, '2024-02-29', 1e10), "
              "(6, 'erin', 99999.99, '2020-07-04', 0.3), "
              "(7, 'bob', 7.77, NULL, 7.0)")
SELECT_ALL = "SELECT id, name, amount, d, v FROM t ORDER BY id"

# each script: (session, SQL) steps run through both engines in order
SCRIPTS = {
    "update_delete_typed_columns": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS), ("W", SELECT_ALL),
        ("W", "UPDATE t SET v = v * 1.1"),
        ("W", "UPDATE t SET amount = amount * 2 + 0.05 WHERE d < '2024-03-01'"),
        ("W", "UPDATE t SET d = DATE '2025-01-01', name = 'frank' WHERE amount IS NULL"),
        ("W", "UPDATE t SET name = NULL, v = NULL WHERE id = 7"),
        ("W", "UPDATE t SET amount = amount / 3, v = v + amount WHERE id IN (1, 2, 4)"),
        ("W", SELECT_ALL),
        ("W", "SELECT name, count(*), sum(amount), min(d) FROM t GROUP BY name"),
        ("W", "DELETE FROM t WHERE v IS NULL"),
        ("W", "DELETE FROM t WHERE name LIKE 'a%' OR d >= '2025-01-01'"),
        ("W", SELECT_ALL),
        ("W", "UPDATE t SET name = 'zoe' WHERE id > 100"),
        ("W", "DELETE FROM t WHERE id > 100"),
        ("W", "SELECT name FROM t ORDER BY name"),
        ("W", "SELECT sum(amount), avg(v), count(d) FROM t"),
    ],
    # a join without ORDER BY returns its rows in an engine's own order, so each
    # INSERT ... SELECT orders them: the appended lanes are then the same
    "insert_select_with_join": [
        ("W", "CREATE TABLE c (id BIGINT, name VARCHAR(10)) "
              "PARTITION BY HASH(id) PARTITIONS 2"),
        ("W", "CREATE TABLE o (cid BIGINT, total DECIMAL(10,2))"),
        ("W", "CREATE TABLE r (name VARCHAR(10), total DECIMAL(10,2), n BIGINT)"),
        ("W", "INSERT INTO c VALUES (1, 'x'), (2, 'y'), (3, 'z'), (4, NULL)"),
        ("W", "INSERT INTO o VALUES (1, 100.5), (1, 200), (2, 50.25), (4, 1), (9, 9)"),
        ("W", "INSERT INTO r (name, total, n) SELECT c.name, sum(o.total), count(*) "
              "FROM c JOIN o ON c.id = o.cid GROUP BY c.name ORDER BY c.name"),
        ("W", "SELECT name, total, n FROM r ORDER BY n, name"),
        ("W", "INSERT INTO r SELECT c.name, o.total, o.cid FROM c, o "
              "WHERE c.id = o.cid AND o.total > 60 ORDER BY o.total"),
        ("W", "UPDATE o SET total = total + 1 WHERE cid = 1"),
        ("W", "INSERT INTO r SELECT name, 0, id FROM c WHERE id NOT IN "
              "(SELECT cid FROM o) ORDER BY id"),
        ("W", "SELECT name, total, n FROM r"),
    ],
    "auto_increment_and_truncate": [
        ("W", "CREATE TABLE src (v BIGINT)"),
        ("W", "INSERT INTO src VALUES (5), (6), (7)"),
        ("W", "CREATE TABLE dst (id BIGINT AUTO_INCREMENT PRIMARY KEY, v BIGINT) "
              "PARTITION BY HASH(id) PARTITIONS 2"),
        ("W", "INSERT INTO dst (v) SELECT v FROM src"),
        ("W", "INSERT INTO dst (v) VALUES (10), (11)"),
        ("W", "SELECT id, v FROM dst ORDER BY id"),
        ("W", "TRUNCATE TABLE dst"),
        ("W", "SELECT count(*) FROM dst"),
        ("W", "INSERT INTO dst (v) VALUES (12)"),
        ("W", "SELECT id, v FROM dst ORDER BY id"),
        ("W", "DELETE FROM dst"),
        ("W", "INSERT INTO dst (v) SELECT v * 2 FROM src WHERE v > 5"),
        ("W", "SELECT id, v FROM dst ORDER BY id"),
    ],
    "two_sessions_commit": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS),
        ("W", "BEGIN"),
        ("W", "INSERT INTO t (id, name, amount) VALUES (10, 'new', 1.00)"),
        ("W", "UPDATE t SET amount = amount + 1 WHERE id <= 2"),
        ("W", "DELETE FROM t WHERE id = 3"),
        ("W", SELECT_ALL),                           # own writes visible
        ("R", SELECT_ALL),                           # not W's provisional writes
        ("R", "SELECT count(*), sum(amount) FROM t"),
        ("W", "COMMIT"),
        ("R", SELECT_ALL),
        ("W", "SELECT count(*), sum(amount) FROM t"),
    ],
    "two_sessions_rollback": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS),
        ("R", "BEGIN"),
        ("R", SELECT_ALL),
        ("W", "BEGIN"),
        ("W", "UPDATE t SET name = 'tmp', v = v * 2 WHERE id > 3"),
        ("W", "INSERT INTO t (id, name) VALUES (11, 'gone')"),
        ("W", SELECT_ALL),
        ("R", SELECT_ALL),
        ("W", "ROLLBACK"),
        ("W", SELECT_ALL),
        ("R", "COMMIT"),
        ("W", "INSERT INTO t (id, name) VALUES (12, 'kept')"),
        ("R", "BEGIN"),                              # a snapshot after the insert
        ("W", "DELETE FROM t WHERE id = 12"),
        ("R", SELECT_ALL),                           # still sees id 12
        ("R", "COMMIT"),
        ("R", SELECT_ALL),
    ],
    "insert_then_delete_rollback": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS),
        ("W", "BEGIN"),
        ("W", "INSERT INTO t (id, name, v) VALUES (20, 'a', 1), (21, 'b', 2), "
              "(22, 'c', 3)"),
        ("W", "DELETE FROM t WHERE id >= 21"),
        ("W", "UPDATE t SET v = 9 WHERE id = 20"),
        ("W", SELECT_ALL),
        ("W", "ROLLBACK"),
        ("W", SELECT_ALL),
        ("W", "BEGIN"),
        ("W", "INSERT INTO t (id, name) VALUES (30, 'x')"),
        ("W", "UPDATE t SET name = 'y' WHERE id = 30"),
        ("W", "DELETE FROM t WHERE id = 1"),
        ("W", "COMMIT"),
        ("W", SELECT_ALL),
    ],
    "write_conflict": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS),
        ("W", "BEGIN"),
        ("W", "UPDATE t SET amount = 1 WHERE id = 1"),
        ("R", "UPDATE t SET amount = 2 WHERE id = 1"),      # TransactionError
        ("R", "BEGIN"),
        ("R", "DELETE FROM t WHERE id <= 2"),               # TransactionError
        ("R", "UPDATE t SET amount = 3 WHERE id = 2"),      # another row: fine
        ("R", "ROLLBACK"),
        ("W", "COMMIT"),
        ("R", "UPDATE t SET amount = 2 WHERE id = 1"),      # the retry succeeds
        ("R", SELECT_ALL),
        # a row a later committer deleted cannot be written from an older snapshot
        ("W", "BEGIN"),
        ("R", "DELETE FROM t WHERE id = 5"),
        ("W", "UPDATE t SET v = 0 WHERE id = 5"),           # TransactionError
        ("W", "ROLLBACK"),
        ("W", SELECT_ALL),
    ],
    # the reference's autocommit UPDATE stamps partition by partition, so a conflict
    # met in a later partition raises after earlier partitions were written; the
    # port does the same (id 1 lies in partition 0, id 7 in partition 1)
    "autocommit_conflict_midway": [
        ("W", TYPED_TABLE), ("W", TYPED_ROWS),
        ("W", "BEGIN"),
        ("W", "UPDATE t SET v = 1 WHERE id = 7"),
        ("R", "UPDATE t SET v = 0"),                        # TransactionError
        ("R", SELECT_ALL),
        ("W", "COMMIT"),
        ("R", SELECT_ALL),
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_matches_reference(name):
    pair = Pair()
    results = []
    for who, sql in SCRIPTS[name]:
        results.append(pair.run(who, sql))
        pair.assert_same_state()
    if name == "write_conflict":
        assert results[4] is errors.TransactionError
        assert results[6] is errors.TransactionError
        assert results[10] is not errors.TransactionError
        assert results[14] is errors.TransactionError
    if name == "autocommit_conflict_midway":
        assert results[4] is errors.TransactionError
        assert [r[4] for r in results[5].rows][:2] == [0.0, 2.25]


# INSERT values a lane cannot hold: the reference assigns value by value and raises
# (OverflowError) before anything is appended; a mixed int/float BIGINT column keeps
# its large integer exact and truncates the float
OUT_OF_RANGE = [
    ("TINYINT", "(1, 300)"), ("TINYINT", "(1, -129)"), ("INT", "(1, 3000000000)"),
    ("BIGINT", "(1, 9223372036854775808)"), ("BIGINT UNSIGNED", "(1, -1)"),
    ("DECIMAL(20,2)", "(1, 100000000000000000)"),
    ("BIGINT", "(1, 4611686018427387905), (2, 1.5)"),
]


@pytest.mark.parametrize("typ,rows", OUT_OF_RANGE)
def test_insert_out_of_range_values_match_reference(typ, rows):
    """The lanes the reference stores, or its exception with both stores unchanged.
    `Pair.run` compares only `TddlError`s, so the raw exception is caught here."""
    pair = Pair()
    pair.run("W", f"CREATE TABLE t (id BIGINT, v {typ}) PARTITION BY HASH(id) "
                  "PARTITIONS 2")
    pair.run("W", "INSERT INTO t VALUES (7, 7)")
    js, ps = pair.session("W")
    sql = f"INSERT INTO t VALUES {rows}"
    want = got = None
    try:
        js.execute(sql)
    except Exception as e:
        want = e
    try:
        ps.execute(sql)
    except Exception as e:
        got = e
    assert type(got) is type(want), (sql, want, got)
    pair.assert_same_state()
    assert pair.pi.store("test", "t").row_count() == (1 if want else 1 + rows.count("("))


def test_double_update_stores_the_reference_float64_bits():
    """`SET v = v * 1.1` computes in float64 on the host, as the reference does, and
    stores the result rounded to the DOUBLE lane's float32; computing in float32 (the
    device compiler's float type) would store other bits for most of these rows."""
    pair = Pair()
    pair.run("W", TYPED_TABLE)
    pair.run("W", TYPED_ROWS)

    def current_v():
        out = {}
        for p in pair.pi.store("test", "t").partitions:
            live = p.visible_mask(None) & p.valid["v"]
            out.update(zip(p.lanes["id"][live].tolist(), p.lanes["v"][live]))
        return out

    before = current_v()
    pair.run("W", "UPDATE t SET v = v * 1.1")
    after = current_v()
    assert set(after) == set(before) == {1, 2, 4, 5, 6, 7}
    f64 = {i: np.float32(np.float64(v) * 1.1) for i, v in before.items()}
    f32 = {i: np.float32(v * np.float32(1.1)) for i, v in before.items()}
    assert all(after[i].dtype == np.float32 for i in after)
    assert {i: after[i].tobytes() for i in after} == {i: f64[i].tobytes() for i in f64}
    assert sum(f64[i] != f32[i] for i in f64) >= 3
    pair.assert_same_state()


def test_close_rolls_back_an_open_transaction():
    pair = Pair()
    pair.run("W", TYPED_TABLE)
    pair.run("W", TYPED_ROWS)
    pair.run("X", "BEGIN")
    pair.run("X", "INSERT INTO t (id, name) VALUES (40, 'open')")
    pair.run("X", "DELETE FROM t WHERE id = 2")
    js, ps = pair.sessions.pop("X")
    js.close()
    ps.close()
    assert ps.txn is None and ps.conn_id not in pair.pi.sessions
    pair.assert_same_state()
    rs = pair.run("W", SELECT_ALL)
    assert [r[0] for r in rs.rows] == [1, 2, 3, 4, 5, 6, 7]
    # nothing provisional is left: the next writer of row 2 meets no conflict
    assert pair.run("W", "DELETE FROM t WHERE id = 2").affected == 1


def test_participants_prepare_only_their_own_provisional_rows():
    """`StoreParticipant.prepare` (the structural XA PREPARE) holds while every
    provisional stamp of the transaction is still its own, and fails once another
    writer's stamp replaced one."""
    from galaxysql_tpu_torch.txn.xa import participants_of
    pair = Pair()
    pair.run("W", TYPED_TABLE)
    pair.run("W", TYPED_ROWS)
    pair.run("W", "CREATE TABLE u (a BIGINT)")
    pair.run("W", "BEGIN")
    pair.run("W", "INSERT INTO u VALUES (1), (2)")
    pair.run("W", "UPDATE t SET v = 0 WHERE id <= 3")
    _js, ps = pair.sessions["W"]
    parts = participants_of(ps.txn)
    assert sorted(sp.store.table.name for sp in parts) == ["t", "u"]
    assert all(sp.prepare() for sp in parts)
    t_part = next(sp for sp in parts if sp.store.table.name == "t")
    pid, ids, _old = t_part.deleted[0]
    p = t_part.store.partitions[pid]
    p.end_ts[ids[0]] = -(ps.txn.txn_id + 1)  # another transaction's stamp
    assert not t_part.prepare()


def test_statements_the_port_takes_now():
    _ji = Instance(device="cpu")
    s = Session(_ji)
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    s.execute("CREATE TABLE t (a BIGINT)")
    for sql in ("INSERT INTO t VALUES (1)", "UPDATE t SET a = 2", "DELETE FROM t",
                "TRUNCATE TABLE t", "BEGIN", "COMMIT", "BEGIN", "ROLLBACK",
                "ALTER TABLE t ADD COLUMN b INT DEFAULT 1, ADD INDEX i_b (b)",
                "CREATE GLOBAL INDEX g_a ON t (a) COVERING (b)", "DROP INDEX g_a ON t",
                "CREATE UNIQUE INDEX u_b ON t (b)", "ALTER TABLE t DROP INDEX u_b",
                "ALTER TABLE t RENAME TO t2", "ALTER TABLE t2 RENAME TO t",
                "ALTER TABLE t DROP COLUMN b", "CREATE VIEW v AS SELECT a FROM t",
                "CREATE OR REPLACE VIEW v AS SELECT a + 1 AS b FROM t", "DROP VIEW v",
                "ADVISE INDEX SELECT a FROM t WHERE a = 1", "DROP TABLE t",
                "SHOW RECYCLEBIN", "FLASHBACK TABLE t TO BEFORE DROP", "DROP TABLE t",
                "PURGE RECYCLEBIN", "CREATE DATABASE e", "DROP DATABASE e"):
        s.execute(sql)
    with pytest.raises(errors.NotSupportedError):
        s.execute("INSERT INTO t VALUES (1) ON DUPLICATE KEY UPDATE a = 3")
    with pytest.raises(errors.NotSupportedError):
        s.execute("DELETE FROM t ORDER BY a LIMIT 1")


def test_transfer_gives_the_port_store_its_own_arrays():
    """A port store built from a JAX store must not share the source's arrays:
    stamping a row in place in the port leaves the source's `end_ts` as it was."""
    ji = JaxInstance()
    js = JaxSession(ji)
    js.execute("CREATE DATABASE test")
    js.execute("USE test")
    js.execute(TYPED_TABLE)
    js.execute(TYPED_ROWS)
    pi = Instance(device="cpu")
    ps = Session(pi)
    ps.execute("CREATE DATABASE test")
    ps.execute("USE test")
    ps.execute(TYPED_TABLE)
    parts, dicts = transfer.arrays_of(ji.store("test", "t"))
    pi.install_store(transfer.store_from_arrays(pi.catalog.table("test", "t"),
                                                parts, dicts))
    before = [(p.end_ts.copy(), p.begin_ts.copy(), p.lanes["v"].copy())
              for p in ji.store("test", "t").partitions]
    assert ps.execute("DELETE FROM t WHERE id <= 3").affected == 3
    assert ps.execute("UPDATE t SET v = 0").affected == 4
    for p, (end, begin, v) in zip(ji.store("test", "t").partitions, before):
        assert np.array_equal(p.end_ts, end)
        assert np.array_equal(p.begin_ts, begin)
        assert np.array_equal(p.lanes["v"], v)
    assert js.execute("SELECT count(*) FROM t").rows == [(7,)]
    assert ps.execute("SELECT count(*) FROM t").rows == [(4,)]
    # and two port stores carried from one source stay apart too
    pi2 = Instance(device="cpu")
    ps2 = Session(pi2)
    ps2.execute("CREATE DATABASE test")
    ps2.execute("USE test")
    ps2.execute(TYPED_TABLE)
    parts, dicts = transfer.arrays_of(pi.store("test", "t"))
    pi2.install_store(transfer.store_from_arrays(pi2.catalog.table("test", "t"),
                                                 parts, dicts))
    ps2.execute("DELETE FROM t")
    assert ps.execute("SELECT count(*) FROM t").rows == [(4,)]


def ap_plans(monkeypatch):
    """Every plan AP in both packages, so the reads of a test's small tables take
    the device-cache path the test is about: below AP_ROW_THRESHOLD scanned rows
    both packages run a statement on the host engine, without the cache."""
    for planner in (jax_planner, port_planner):
        monkeypatch.setattr(planner, "AP_ROW_THRESHOLD", 0)


def test_reads_miss_every_cache_after_writes_commit_and_rollback(monkeypatch):
    """After each write, COMMIT and ROLLBACK the table version moves, so the scan
    metadata and the device-cache lanes of the old stamps are not served again."""
    ap_plans(monkeypatch)
    pair = Pair()
    pair.run("W", TYPED_TABLE)
    pair.run("W", TYPED_ROWS)
    tm = pair.pi.catalog.table("test", "t")
    cache = pair.pi.device_cache
    q = "SELECT count(*), sum(amount) FROM t"
    for sql in ("BEGIN", "UPDATE t SET amount = 0 WHERE id = 1", "COMMIT",
                "BEGIN", "DELETE FROM t WHERE id = 2", "ROLLBACK",
                "INSERT INTO t (id) VALUES (50)", "TRUNCATE TABLE t"):
        pair.run("W", q)
        version, misses = tm.version, cache.misses
        pair.run("W", sql)
        if sql != "BEGIN":
            assert tm.version > version, sql
        pair.run("W", q)
        if sql != "BEGIN" and sql != "TRUNCATE TABLE t":
            assert cache.misses > misses, sql


# -- seeded random statement sequences ------------------------------------------------

RANDOM_TABLE = """CREATE TABLE h (
    id BIGINT NOT NULL AUTO_INCREMENT PRIMARY KEY,
    k INT,
    s VARCHAR(8),
    m DECIMAL(10,2),
    f DOUBLE
) PARTITION BY HASH(id) PARTITIONS 3"""

_ints = st.integers(-50, 50)
_value = {
    "k": st.one_of(st.none(), _ints.map(str)),
    "s": st.one_of(st.none(), st.sampled_from(["'a'", "'b'", "'cc'", "'zz'", "''"])),
    "m": st.one_of(st.none(), st.integers(-9999, 9999).map(lambda v: f"{v / 100:.2f}")),
    "f": st.one_of(st.none(), st.sampled_from(["0.5", "-1.25", "3", "1e3", "0.1"])),
}
_cond = st.one_of(
    st.builds(lambda v: f"k > {v}", _ints),
    st.builds(lambda v: f"id % 3 = {v}", st.integers(0, 2)),
    st.sampled_from(["s = 'a'", "s IS NULL", "m < 0", "f IS NOT NULL", "k IS NULL",
                     "s IN ('b', 'cc')"]),
)
_set = st.sampled_from(["k = k + 1", "s = 'new'", "s = 'b'", "m = m * 2",
                        "f = f * 1.1", "k = NULL", "m = m + 0.01, f = k",
                        "s = NULL, k = 7"])


def _insert(rows):
    return ("INSERT INTO h (k, s, m, f) VALUES " +
            ", ".join("(" + ", ".join("NULL" if v is None else v for v in r) + ")"
                      for r in rows))


_row = st.tuples(_value["k"], _value["s"], _value["m"], _value["f"])
_statement = st.tuples(
    st.sampled_from(["W", "R"]),
    st.one_of(
        st.lists(_row, min_size=1, max_size=4).map(_insert),
        st.builds(lambda s, c: f"UPDATE h SET {s} WHERE {c}", _set, _cond),
        st.builds(lambda c: f"DELETE FROM h WHERE {c}", _cond),
        st.sampled_from(["BEGIN", "COMMIT", "ROLLBACK",
                         "SELECT id, k, s, m, f FROM h ORDER BY id",
                         "SELECT s, count(*), sum(m), sum(k) FROM h GROUP BY s"]),
    ))


@settings(max_examples=6, derandomize=True, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_statement, min_size=1, max_size=20))
def test_random_statement_sequences_match_reference(steps):
    pair = Pair()
    pair.run("W", RANDOM_TABLE)
    pair.run("W", _insert([("1", "'a'", "1.00", "0.5"), (None, None, None, None),
                           ("-3", "'b'", "-2.50", "1e3")]))
    for who, sql in steps:
        pair.run(who, sql)
        pair.assert_same_state()
    pair.run("W", "SELECT id, k, s, m, f FROM h ORDER BY id")
