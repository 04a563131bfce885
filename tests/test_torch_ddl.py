"""DDL: the port against the JAX package on the CPU.

The same statements go through `galaxysql_tpu.server.session.Session` and the port's
`Session(Instance(device="cpu"))`, in the same order (`test_torch_dml.Pair`).  After
every statement the two must agree on the result (rows, affected count or error
type), on the catalog (columns, primary key, partitioning, indexes with their status,
views) and on every partition's lanes, validity, dictionaries and stamp classes,
GSI tables included.  Recycle-bin names hold the drop time in milliseconds and a
process-wide counter, so they are compared as `__recycle__<table>`; `{bin:t}` in a
statement stands for each engine's own bin name of `t`.

Then what only the port is asked here: the failpoints of the job engine (a crash
before a task and `recover()`, a backfill paused and resumed), the metadata locks
(`meta/mdl.py` semantics, an ALTER waiting for a running query, the reference's
concurrency stress on the port), the point fast path and the batch scheduler after
column DDL, and `DeviceCache.evict_store`.
"""

import re
import threading

import numpy as np
import pytest
import torch

from galaxysql_tpu.ddl import jobs as jax_jobs
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu.utils.failpoint import FAIL_POINTS as JAX_FAIL_POINTS
from galaxysql_tpu.utils.failpoint import FailPointError as JaxFailPointError
from galaxysql_tpu_torch.ddl import jobs
from galaxysql_tpu_torch.meta.mdl import MdlManager
from galaxysql_tpu_torch.server import session as port_session
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FailPointError
from test_torch_dml import Pair, _classes, _multiset, _stamp_ranks, ap_plans

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

_BIN_RE = re.compile(r"(__recycle__\w+?)_\d+_\d+")
THREAD_SECONDS = 120  # every thread of a concurrency test must end within this


def _norm(v):
    return _BIN_RE.sub(r"\1", v) if isinstance(v, str) else v


def _bin_name(inst, table):
    return next(r[0] for r in reversed(inst.recycle.rows()) if r[1] == table)


class DdlPair(Pair):
    """`Pair` with recycle-bin names normalised and the catalog compared too."""

    def run(self, name, sql):
        js, ps = self.session(name)
        jsql = re.sub(r"\{bin:(\w+)\}", lambda m: _bin_name(self.ji, m.group(1)), sql)
        psql = re.sub(r"\{bin:(\w+)\}", lambda m: _bin_name(self.pi, m.group(1)), sql)
        want = got = None
        try:
            want = js.execute(jsql)
        except jax_errors.TddlError as e:
            want = e
        try:
            got = ps.execute(psql)
        except errors.TddlError as e:
            got = e
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert type(got).__name__ == type(want).__name__, (sql, want, got)
            return type(got)
        assert got.affected == want.affected, sql
        assert got.names == want.names, sql
        assert [t.sql_name() for t in got.types] == [t.sql_name() for t in want.types]

        def rows(rs):
            out = [tuple(_norm(v) for v in r) for r in rs.rows]
            if sql.upper().startswith("SHOW RECYCLEBIN"):
                out = [r[:3] for r in out]  # DROP_TIME is each engine's clock
            return out
        if "order by" in sql.lower():
            assert rows(got) == rows(want), sql
        else:
            assert _multiset(rows(got)) == _multiset(rows(want)), sql
        return got

    def assert_same_state(self):
        assert _catalog(self.pi) == _catalog(self.ji)
        jstamps, pstamps = _stamp_ranks(self.ji), _stamp_ranks(self.pi)
        jtables = {_norm(t.name): t for s in self.ji.catalog.schemas.values()
                   for t in s.tables.values() if s.name != "information_schema"}
        for s in self.pi.catalog.schemas.values():
            if s.name == "information_schema":
                continue
            for t in s.tables.values():
                jt = jtables[_norm(t.name)]
                jstore = self.ji.store(jt.schema, jt.name)
                pstore = self.pi.store(t.schema, t.name)
                jparts, jdicts = transfer.arrays_of(jstore)
                pparts, pdicts = transfer.arrays_of(pstore)
                assert pdicts == jdicts, t.name
                assert len(pparts) == len(jparts)
                for pid, (jp, pp) in enumerate(zip(jparts, pparts)):
                    assert sorted(pp["lanes"]) == sorted(jp["lanes"]), t.name
                    for col, lane in jp["lanes"].items():
                        assert pp["lanes"][col].dtype == lane.dtype, (t.name, col)
                        assert pp["lanes"][col].tobytes() == lane.tobytes(), \
                            (t.name, pid, col)
                        assert np.array_equal(pp["valid"][col], jp["valid"][col])
                    for key in ("begin_ts", "end_ts"):
                        assert _classes(pp[key], pstamps) == \
                            _classes(jp[key], jstamps), (t.name, pid, key)
                assert pstore.row_count() == jstore.row_count(), t.name
        # the stores the instances hold are the catalog's tables, no more
        assert sorted(_norm(k) for k in self.pi.stores) == \
            sorted(_norm(k) for k in self.ji.stores)


def _catalog(inst):
    """Every user table's columns, key, partitioning and indexes, and the views."""
    out = {}
    for s in inst.catalog.schemas.values():
        if s.name == "information_schema":
            continue
        for t in s.tables.values():
            p = t.partition
            out[(s.name, _norm(t.name))] = (
                [(c.name, c.dtype.sql_name(), c.nullable, c.default)
                 for c in t.columns],
                list(t.primary_key), (p.method, list(p.columns), p.count),
                [(i.name, list(i.columns), i.unique, i.global_index,
                  list(i.covering), i.status) for i in t.indexes])
        for v in getattr(s, "views", {}).values():
            out[(s.name, "view", v.name)] = (v.columns, v.sql)
    return out


GSI_TABLE = ("CREATE TABLE o (id BIGINT PRIMARY KEY, cust BIGINT, amount BIGINT, "
             "note VARCHAR(8)) PARTITION BY HASH(id) PARTITIONS 4")
GSI_ROWS = "INSERT INTO o VALUES " + ", ".join(
    f"({i}, {i % 7}, {i * 10}, {'NULL' if i % 5 == 0 else repr('n' + str(i % 3))})"
    for i in range(40))
BIN_TABLE = ("CREATE TABLE t (id BIGINT PRIMARY KEY, v VARCHAR(10), n INT) "
             "PARTITION BY HASH(id) PARTITIONS 4")
BIN_ROWS = "INSERT INTO t VALUES (1, 'a', 10), (2, 'b', 20), (3, 'c', 30)"

SCRIPTS = {
    "add_drop_column": [
        ("W", "CREATE TABLE t (a BIGINT, b VARCHAR(10), d DECIMAL(8,2)) "
              "PARTITION BY HASH(a) PARTITIONS 3"),
        ("W", "INSERT INTO t VALUES (1, 'x', 1.5), (2, 'y', NULL), (3, NULL, -2.25), "
              "(4, 'x', 0)"),
        ("W", "ALTER TABLE t ADD COLUMN c BIGINT DEFAULT 7"),
        ("W", "SELECT a, c FROM t ORDER BY a"),
        ("W", "ALTER TABLE t ADD COLUMN f VARCHAR(8) DEFAULT 'dflt' FIRST"),
        ("W", "ALTER TABLE t ADD COLUMN g DECIMAL(10,3) DEFAULT 1.25 AFTER a, "
              "ADD COLUMN h INT, ADD COLUMN i DATE DEFAULT '2024-02-29'"),
        ("W", "SELECT * FROM t ORDER BY a"),
        ("W", "DESCRIBE t"),
        ("W", "INSERT INTO t (a, b, c) VALUES (5, 'z', 9)"),
        ("W", "INSERT INTO t VALUES ('q', 6, 2.5, 'w', 3.5, 8, 1, '2020-01-01')"),
        ("W", "UPDATE t SET f = 'new', h = a * 2 WHERE a > 2"),
        ("W", "SELECT f, count(*), sum(g), max(i) FROM t GROUP BY f ORDER BY f"),
        ("W", "ALTER TABLE t DROP COLUMN b"),
        ("W", "SELECT b FROM t"),
        ("W", "ALTER TABLE t DROP COLUMN f, DROP COLUMN h"),
        ("W", "SELECT * FROM t ORDER BY a"),
        ("W", "ALTER TABLE t ADD COLUMN c BIGINT"),  # idempotent: already there
        ("W", "ALTER TABLE t MODIFY COLUMN c INT"),
        ("W", "SHOW CREATE TABLE t"),
    ],
    "rename": [
        ("W", "CREATE TABLE r1 (a BIGINT, s VARCHAR(4))"),
        ("W", "INSERT INTO r1 VALUES (5, 'p'), (6, 'q')"),
        ("W", "SELECT a FROM r1 WHERE a = 5"),
        ("W", "ALTER TABLE r1 RENAME TO r2"),
        ("W", "SELECT a, s FROM r2 ORDER BY a"),
        ("W", "SELECT * FROM r1"),
        ("W", "INSERT INTO r2 VALUES (7, 'p')"),
        ("W", "ALTER TABLE r2 RENAME TO r1"),
        ("W", "SELECT s, count(*) FROM r1 GROUP BY s ORDER BY s"),
        ("W", "SHOW TABLES"),
    ],
    "refused_drops_roll_back": [
        ("W", "CREATE TABLE pt (a BIGINT, b BIGINT, PRIMARY KEY (b)) "
              "PARTITION BY HASH(a) PARTITIONS 4"),
        ("W", "INSERT INTO pt VALUES (1, 2), (3, 4)"),
        ("W", "ALTER TABLE pt ADD COLUMN c BIGINT DEFAULT 1, DROP COLUMN a"),
        ("W", "SELECT c FROM pt"),
        ("W", "ALTER TABLE pt ADD COLUMN c BIGINT DEFAULT 1, DROP COLUMN b"),
        ("W", "SELECT a, b FROM pt ORDER BY a"),
        ("W", "ALTER TABLE nope ADD COLUMN c INT"),
        ("W", "SHOW DDL"),
        ("W", "SELECT job_id, schema_name, ddl_sql, state FROM "
              "information_schema.ddl_jobs ORDER BY job_id"),
    ],
    "gsi_build_and_maintenance": [
        ("W", GSI_TABLE), ("W", GSI_ROWS),
        ("W", "CREATE GLOBAL INDEX g_cust ON o (cust) COVERING (amount, note)"),
        ("W", "SHOW INDEX FROM o"),
        ("W", "SELECT id, amount FROM o WHERE cust = 3 ORDER BY id"),
        ("W", "INSERT INTO o VALUES (100, 3, 1000, 'new'), (101, 4, NULL, NULL)"),
        ("W", "UPDATE o SET cust = 3, note = 'moved' WHERE id IN (1, 2, 101)"),
        ("W", "DELETE FROM o WHERE id = 10 OR amount > 350"),
        ("W", "SELECT id, amount, note FROM o WHERE cust = 3 ORDER BY id"),
        ("W", "BEGIN"),
        ("W", "INSERT INTO o VALUES (200, 5, 2000, 'tx')"),
        ("W", "UPDATE o SET cust = 6 WHERE id = 5"),
        ("W", "DELETE FROM o WHERE id = 12"),
        ("W", "SELECT id FROM o WHERE cust = 5 ORDER BY id"),
        ("R", "SELECT id FROM o WHERE cust = 5 ORDER BY id"),
        ("W", "COMMIT"),
        ("R", "SELECT id FROM o WHERE cust = 5 ORDER BY id"),
        ("W", "BEGIN"),
        ("W", "INSERT INTO o VALUES (300, 6, 1, 'rb')"),
        ("W", "UPDATE o SET amount = 0 WHERE cust = 6"),
        ("W", "DELETE FROM o WHERE cust = 0"),
        ("W", "ROLLBACK"),
        ("W", "SELECT id, amount FROM o WHERE cust = 6 ORDER BY id"),
        ("W", "CREATE INDEX i_amt ON o (amount)"),
        ("W", "CREATE UNIQUE INDEX u_note ON o (note)"),
        ("W", "ALTER TABLE o ADD GLOBAL INDEX g_amt (amount), DROP INDEX i_amt"),
        ("W", "SHOW INDEX FROM o"),
        ("W", "DROP INDEX g_cust ON o"),
        ("W", "SELECT id FROM o WHERE cust = 3 ORDER BY id"),
        ("W", "DROP INDEX nope ON o"),
        ("W", "SHOW TABLES"),
    ],
    "gsi_composite_key": [
        ("W", "CREATE TABLE cp (a BIGINT, b BIGINT, v BIGINT, PRIMARY KEY (a, b)) "
              "PARTITION BY HASH(a) PARTITIONS 2"),
        ("W", "INSERT INTO cp VALUES (1,2,0), (3,4,0), (1,4,0), (3,2,0)"),
        ("W", "CREATE GLOBAL INDEX gv ON cp (v)"),
        ("W", "DELETE FROM cp WHERE a = 1 AND b = 2"),
        ("W", "UPDATE cp SET v = 9 WHERE a = 3 AND b = 4"),
        ("W", "SELECT a, b FROM cp WHERE v = 0 ORDER BY a, b"),
    ],
    "covering_gsi_route": [
        ("W", "CREATE TABLE t (id BIGINT PRIMARY KEY, k INT, v VARCHAR(4), "
              "amt DECIMAL(10,2)) PARTITION BY HASH(id) PARTITIONS 4"),
        ("W", "INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i % 9}, 'v{i % 4}', {i}.25)" for i in range(1, 120))),
        ("W", "CREATE GLOBAL INDEX g_k ON t (k) COVERING (amt)"),
        ("W", "EXPLAIN SELECT amt FROM t WHERE k = 5"),
        ("W", "EXPLAIN SELECT v FROM t WHERE k = 5"),
        ("W", "SELECT amt FROM t WHERE k = 5"),
        ("W", "SELECT amt FROM t WHERE k = 5"),
        ("W", "SELECT amt FROM t WHERE k = 7"),
        ("W", "SELECT amt, id FROM t WHERE k = 5 ORDER BY amt"),
        ("W", "INSERT INTO t VALUES (500, 5, 'n', 1.5)"),
        ("W", "SELECT amt FROM t WHERE k = 5"),
        ("W", "DELETE FROM t WHERE id = 500"),
        ("W", "SELECT amt FROM t WHERE k = 5"),
    ],
    "recycle_bin": [
        ("W", BIN_TABLE), ("W", BIN_ROWS),
        ("W", "SELECT v FROM t WHERE id = 2"), ("W", "SELECT v FROM t WHERE id = 2"),
        ("W", "DROP TABLE t"),
        ("W", "SHOW TABLES"),
        ("W", "SELECT * FROM t"),
        ("W", "SELECT v FROM t WHERE id = 2"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "SELECT table_name FROM information_schema.tables "
              "WHERE table_schema = 'test'"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP"),
        ("W", "SELECT id, v FROM t ORDER BY id"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "DROP TABLE t"),
        ("W", "CREATE TABLE t (id BIGINT)"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP RENAME TO t_old"),
        ("W", "SELECT v FROM t_old ORDER BY v"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP"),
        ("W", "DROP TABLE t_old"),
        ("W", "DROP TABLE t"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "PURGE TABLE {bin:t}"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP"),
        ("W", "PURGE TABLE nope"),
        ("W", "CREATE TABLE p2 (id BIGINT)"),
        ("W", "DROP TABLE p2"),
        ("W", "PURGE RECYCLEBIN"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "DROP TABLE IF EXISTS nope"),
        ("W", "DROP TABLE nope"),
    ],
    "recycle_bin_gsi_and_off": [
        ("W", "CREATE TABLE g (id BIGINT PRIMARY KEY, k INT) "
              "PARTITION BY HASH(id) PARTITIONS 2"),
        ("W", "INSERT INTO g VALUES (1, 5), (2, 6)"),
        ("W", "CREATE GLOBAL INDEX gk ON g (k)"),
        ("W", "DROP TABLE g"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "SHOW TABLES"),
        ("W", BIN_TABLE), ("W", BIN_ROWS),
        ("W", "SET ENABLE_RECYCLEBIN = false"),
        ("W", "DROP TABLE t"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "FLASHBACK TABLE t TO BEFORE DROP"),
    ],
    "views": [
        ("W", BIN_TABLE), ("W", BIN_ROWS),
        ("W", "CREATE VIEW v1 AS SELECT id, v FROM t WHERE n > 10"),
        ("W", "SELECT * FROM v1 ORDER BY id"),
        ("W", "CREATE VIEW v2 (x, y) AS SELECT v, sum(n) FROM t GROUP BY v"),
        ("W", "SELECT x, y FROM v2 WHERE y > 10 ORDER BY x LIMIT 5"),
        ("W", "SELECT v1.v, v2.y FROM v1 JOIN v2 ON v1.v = v2.x ORDER BY v1.v"),
        ("W", "CREATE VIEW v1 AS SELECT id FROM t"),
        ("W", "CREATE OR REPLACE VIEW v1 AS SELECT id FROM t WHERE id < 3"),
        ("W", "SELECT * FROM v1 ORDER BY id"),
        ("W", "CREATE VIEW bad (a, b) AS SELECT v FROM t"),
        ("W", "CREATE VIEW bad AS SELECT nope FROM t"),
        ("W", "CREATE VIEW cyc AS SELECT v FROM t WHERE n < 25"),
        ("W", "CREATE OR REPLACE VIEW cyc AS SELECT v FROM cyc"),
        ("W", "SELECT * FROM cyc"),
        ("W", "DROP VIEW cyc, v2"),
        ("W", "DROP VIEW v2"),
        ("W", "DROP VIEW IF EXISTS v2"),
        ("R", "CREATE DATABASE other"),
        ("R", "USE other"),
        ("R", "CREATE VIEW test.dview AS SELECT v FROM t WHERE n < 25"),
        ("R", "SELECT count(*) FROM test.dview"),
        ("R", "DROP VIEW test.dview"),
        ("W", "SHOW TABLES"),
    ],
    "drop_database": [
        ("W", BIN_TABLE), ("W", BIN_ROWS),
        ("W", GSI_TABLE), ("W", GSI_ROWS),
        ("W", "CREATE GLOBAL INDEX g_cust ON o (cust) COVERING (amount)"),
        ("W", "CREATE VIEW vv AS SELECT id FROM t"),
        ("W", "CREATE TABLE gone (a BIGINT)"),
        ("W", "DROP TABLE gone"),
        ("W", "SHOW RECYCLEBIN"),
        ("R", "CREATE DATABASE keep"),
        ("R", "USE keep"),
        ("R", "CREATE TABLE k (a BIGINT)"),
        ("R", "INSERT INTO k VALUES (1)"),
        ("W", "DROP DATABASE test"),
        ("W", "SHOW RECYCLEBIN"),
        ("W", "SELECT * FROM t"),
        ("W", "SHOW DATABASES"),
        ("R", "SELECT a FROM k"),
        ("W", "DROP DATABASE test"),
        ("W", "DROP DATABASE IF EXISTS test"),
        ("W", "CREATE DATABASE test"),
        ("W", "USE test"),
        ("W", "SHOW TABLES"),
    ],
    "advise_index": [
        ("W", BIN_TABLE), ("W", BIN_ROWS),
        ("W", "CREATE TABLE u (uid BIGINT, name VARCHAR(8))"),
        ("W", "ADVISE INDEX SELECT v FROM t WHERE n = 20"),
        ("W", "ADVISE INDEX SELECT v FROM t WHERE id = 1"),
        ("W", "ADVISE INDEX SELECT t.v, u.name FROM t JOIN u ON t.n = u.uid "
              "WHERE u.name IN ('a', 'b')"),
        ("W", "CREATE GLOBAL INDEX g_n ON t (n) COVERING (v)"),
        ("W", "EXPLAIN SELECT v FROM t WHERE n = 20"),
        ("W", "SELECT v FROM t WHERE n = 20"),
        ("W", "ADVISE INDEX SELECT v FROM t WHERE n = 20"),
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_matches_reference(script):
    pair = DdlPair()
    try:
        for name, sql in SCRIPTS[script]:
            pair.run(name, sql)
            pair.assert_same_state()
        # point selects (through a covering GSI too) took the fast path as often
        assert pair.pi.counters["point_plan_queries"] == \
            pair.ji.counters["point_plan_queries"]
    finally:
        JAX_FAIL_POINTS.clear()
        FAIL_POINTS.clear()


def _crash(pair, sql):
    """`sql` through both engines, each of which must stop at its armed
    failpoint."""
    js, ps = pair.session("W")
    with pytest.raises(JaxFailPointError):
        js.execute(sql)
    with pytest.raises(FailPointError):
        ps.execute(sql)


def _pair_with(n_rows):
    pair = DdlPair()
    pair.run("W", GSI_TABLE)
    pair.run("W", "INSERT INTO o VALUES " + ", ".join(
        f"({i}, {i % 50}, {i * 10}, 'n{i % 3}')" for i in range(n_rows)))
    return pair


def test_crash_before_a_task_then_recover():
    pair = _pair_with(20)
    try:
        for fp in (JAX_FAIL_POINTS, FAIL_POINTS):
            fp.arm("FP_BEFORE_DDL_TASK", 1)
        _crash(pair, "ALTER TABLE o ADD COLUMN c BIGINT DEFAULT 5")
        for fp in (JAX_FAIL_POINTS, FAIL_POINTS):
            fp.clear()
        pair.run("W", "SHOW DDL")
        assert pair.pi.ddl_engine.recover() == pair.ji.ddl_engine.recover() == [1]
        pair.run("W", "SELECT id, c FROM o ORDER BY id")
        pair.run("W", "SHOW DDL")
        pair.assert_same_state()
    finally:
        JAX_FAIL_POINTS.clear()
        FAIL_POINTS.clear()


def test_backfill_paused_then_resumed(monkeypatch):
    """FP_BACKFILL_PAUSE on the 4th chunk of 256 rows: the job stays RUNNING with
    its position checkpointed; `recover()` finishes it with every row once."""
    pair = _pair_with(3000)
    monkeypatch.setattr(jobs.GsiBackfillTask, "CHUNK", 256)
    monkeypatch.setattr(jax_jobs.GsiBackfillTask, "CHUNK", 256)
    try:
        for fp in (JAX_FAIL_POINTS, FAIL_POINTS):
            fp.arm("FP_BACKFILL_PAUSE", 4)
        _crash(pair, "CREATE GLOBAL INDEX g3 ON o (cust)")
        for fp in (JAX_FAIL_POINTS, FAIL_POINTS):
            fp.clear()
        gstore = pair.pi.store("test", "o$g3")
        assert 0 < gstore.row_count() < 3000
        pair.assert_same_state()
        assert pair.pi.ddl_engine.recover() == pair.ji.ddl_engine.recover()
        assert gstore.row_count() == 3000
        pair.run("W", "SHOW INDEX FROM o")
        pair.run("W", "SELECT id FROM o WHERE cust = 7 ORDER BY id")
        pair.assert_same_state()
    finally:
        JAX_FAIL_POINTS.clear()
        FAIL_POINTS.clear()


# -- statements that wait for later items -------------------------------------------

WAITING = [
    ("CHECK TABLE t", "item 16"),
    ("REBALANCE TABLE t", "item 16"),
    ("ALTER TABLE t PARTITION BY HASH(id) PARTITIONS 2", "item 16"),
    ("ALTER TABLE t SPLIT PARTITION p1 INTO 2", "item 16"),
    ("ALTER TABLE t MERGE PARTITIONS p0, p1", "item 16"),
    ("ALTER TABLE t MOVE PARTITION p0 TO 'cold'", "item 16"),
    ("CREATE CCL_RULE r WITH MAX_CONCURRENCY = 1", "item 16"),
    ("DROP CCL_RULE r", "item 16"),
    ("CREATE SLO g WITH TARGET_P99_MS = 100", "item 16"),
    ("DROP SLO g", "item 16"),
    ("BASELINE DELETE 1", "item 16"),
]


# the statements of the list above, all of which the port now serves (the operations
# plane's and the placement slice's): each runs through both engines, and the port
# must answer as the reference does
SERVED = {sql for sql, _item in WAITING}


def _served_outcome(session_cls, inst, errs, sql):
    """(outcome of `sql` alone, outcome after CREATE of the same object, the SHOW
    rows of its surface) in a fresh session of `inst`."""
    s = session_cls(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(BIN_TABLE)

    def run(q):
        try:
            rs = s.execute(q)
            return ("ok", rs.affected, [tuple(r) for r in rs.rows])
        except errs.TddlError as e:
            return (type(e).__name__, str(e))
    first = run(sql)
    if "CCL_RULE" in sql:
        again = (run("CREATE CCL_RULE r WITH MAX_CONCURRENCY = 1, KEYWORD = 'zz_none'"),
                 run(sql), run("DROP CCL_RULE IF EXISTS r"))
        show = [r[:4] for r in s.execute("SHOW CCL_RULES").rows]
    elif "SLO" in sql:
        again = (run("CREATE SLO g WITH TARGET_P99_MS = 100"), run(sql))
        show = [(r[0], r[1], r[4], r[8], r[10]) for r in s.execute("SHOW SLO").rows]
    elif "BASELINE" not in sql:
        # a placement statement: over rows, then again; the table's rows and map,
        # and the rebalance jobs without their lag (a wall time) and router epoch
        # (a process-wide counter)
        s.execute(BIN_ROWS)
        again = (run(sql), run("SELECT id, v, n FROM t ORDER BY id"))
        tm = inst.catalog.table("d", "t")
        show = ([r[:9] + r[10:11] for r in s.execute("SHOW REBALANCE").rows],
                tm.partition.num_partitions, list(tm.partition.columns),
                [tm.partition.group_of(i) for i in range(tm.partition.num_partitions)])
    else:
        again = (run(sql),)
        show = [tuple(r) for r in s.execute("SHOW BASELINE").rows]
    return first, again, show


@pytest.mark.parametrize("sql,item", WAITING)
def test_unported_statements_name_their_item(sql, item):
    if sql in SERVED:  # every statement of the list
        from galaxysql_tpu.server.instance import Instance as JaxInstance
        from galaxysql_tpu.server.session import Session as JaxSession
        from galaxysql_tpu.utils.ccl import GLOBAL_CCL as JAX_GLOBAL_CCL
        from galaxysql_tpu_torch.utils.ccl import GLOBAL_CCL
        try:
            port = _served_outcome(Session, Instance(device="cpu"), errors, sql)
            ref = _served_outcome(JaxSession, JaxInstance(), jax_errors, sql)
        finally:
            GLOBAL_CCL.drop_rule("r")
            JAX_GLOBAL_CCL.drop_rule("r")
        assert port == ref
        return
    s = Session(Instance(device="cpu"))
    s.execute("CREATE DATABASE d; USE d")
    s.execute(BIN_TABLE)
    with pytest.raises(errors.NotSupportedError, match=f"ROADMAP Queue 1 {item}"):
        s.execute(sql)


# -- metadata locks --------------------------------------------------------------------

def _thread(fn):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # carried to the asserting thread
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def test_mdl_exclusive_waits_for_open_shared():
    m = MdlManager()
    assert m.acquire_shared("d.t")
    t, box = _thread(lambda: m.acquire_exclusive("d.t", timeout=THREAD_SECONDS))
    t.join(0.2)
    assert t.is_alive()  # waiting for the reader
    m.release_shared("d.t")
    t.join(THREAD_SECONDS)
    assert not t.is_alive() and box["value"] is True
    m.release_exclusive("d.t")


def test_mdl_queued_exclusive_blocks_new_shared():
    m = MdlManager()
    assert m.acquire_shared("d.t")
    writer, wbox = _thread(lambda: m.acquire_exclusive("d.t", timeout=THREAD_SECONDS))
    while m._lock("d.t").writers_waiting == 0:
        writer.join(0.01)
    reader, rbox = _thread(lambda: m.acquire_shared("d.t", timeout=THREAD_SECONDS))
    reader.join(0.2)
    assert reader.is_alive()  # writer preference: behind the queued exclusive
    assert m.acquire_shared("d.u", timeout=0)  # other tables are not held back
    m.release_shared("d.t")
    writer.join(THREAD_SECONDS)
    assert wbox["value"] is True and reader.is_alive()
    m.release_exclusive("d.t")
    reader.join(THREAD_SECONDS)
    assert rbox["value"] is True


def test_mdl_timeouts_raise_tddl_error():
    m = MdlManager()
    assert m.acquire_shared("d.t")
    with pytest.raises(errors.TddlError, match="exclusive wait timeout"):
        with m.exclusive("d.t", timeout=0.05):
            pass
    m.release_shared("d.t")
    assert m.acquire_exclusive("d.t")
    with pytest.raises(errors.TddlError, match="MDL wait timeout"):
        with m.shared(["d.t"], timeout=0.05):
            pass
    m.release_exclusive("d.t")
    with m.shared(["d.t", "d.u"], timeout=0.05):
        assert m._lock("d.t").readers == 1


def _held_query(monkeypatch):
    """Make the next query pause inside its execution (under its shared MDL)
    until `release` is set."""
    entered, release = threading.Event(), threading.Event()
    real = port_session.run_to_batch

    def paused(op):
        if not entered.is_set():
            entered.set()
            assert release.wait(THREAD_SECONDS)
        return real(op)
    monkeypatch.setattr(port_session, "run_to_batch", paused)
    return entered, release


def test_alter_waits_for_a_running_query(monkeypatch):
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(GSI_TABLE)
    s.execute(GSI_ROWS)
    q = "SELECT cust, sum(amount) FROM o GROUP BY cust ORDER BY cust"
    before = s.execute(q).rows
    entered, release = _held_query(monkeypatch)
    query, qbox = _thread(lambda: Session(inst, "d").execute(q).rows)
    assert entered.wait(THREAD_SECONDS)
    alter, abox = _thread(lambda: Session(inst, "d").execute(
        "ALTER TABLE o ADD COLUMN x INT DEFAULT 1"))
    lock = inst.mdl._lock("d.o")
    while lock.writers_waiting == 0:
        alter.join(0.01)
    alter.join(0.2)
    assert alter.is_alive() and lock.readers == 1 and not inst.catalog.table(
        "d", "o").has_column("x")
    release.set()
    query.join(THREAD_SECONDS)
    alter.join(THREAD_SECONDS)
    assert "error" not in qbox and "error" not in abox
    assert qbox["value"] == before
    assert s.execute("SELECT count(*) FROM o WHERE x = 1").rows == [(40,)]


def test_point_and_dml_hold_the_shared_lock(monkeypatch):
    """The sequential point lookup and a DML statement take the shared MDL: with an
    exclusive lock held they wait (and time out typed)."""
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(GSI_TABLE)
    s.execute(GSI_ROWS)
    for _ in range(2):
        assert s.execute("SELECT amount FROM o WHERE id = 3").rows == [(30,)]
    taken = []
    real = inst.mdl.shared

    def spy(keys, timeout=30.0):
        taken.append(sorted(keys))
        return real(keys, timeout=0.05)
    monkeypatch.setattr(inst.mdl, "shared", spy)
    assert inst.mdl.acquire_exclusive("d.o")
    try:
        for sql in ("SELECT amount FROM o WHERE id = 3", "DELETE FROM o WHERE id = 3",
                    "SELECT count(*) FROM o", "EXPLAIN ANALYZE SELECT count(*) FROM o"):
            with pytest.raises(errors.TddlError, match="MDL wait timeout"):
                s.execute(sql)
    finally:
        inst.mdl.release_exclusive("d.o")
    assert taken == [["d.o"]] * 4
    assert inst.counters["point_plan_queries"] == 1
    assert s.execute("SELECT amount FROM o WHERE id = 3").rows == [(30,)]


def test_batch_flush_holds_the_shared_lock(monkeypatch):
    """A batch scheduler flush reads its partitions under the table's shared MDL:
    with an exclusive lock held it waits (and times out typed); released, it
    answers."""
    from galaxysql_tpu_torch.server.batch_scheduler import BatchRequest
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(GSI_TABLE)
    s.execute(GSI_ROWS)
    for _ in range(2):
        s.execute("SELECT amount FROM o WHERE id = 3")
    pp = next(iter(inst.point_plans.values()))
    real = inst.mdl.shared
    monkeypatch.setattr(inst.mdl, "shared",
                        lambda keys, timeout=30.0: real(keys, timeout=0.05))
    assert inst.mdl.acquire_exclusive("d.o")
    try:
        with pytest.raises(errors.TddlError, match="MDL wait timeout on 'd.o'"):
            inst.batch_scheduler._execute(None, pp, None, [BatchRequest(3, 0.0)])
    finally:
        inst.mdl.release_exclusive("d.o")
    reqs = [BatchRequest(3, 0.0), BatchRequest(4, 0.0)]
    inst.batch_scheduler._execute(None, pp, None, reqs)
    assert [r.rows for r in reqs] == [[(30,)], [(40,)]]


def test_insert_select_from_its_own_table_takes_one_lock():
    """INSERT ... SELECT from the table it writes holds one shared lock, so a
    queued exclusive request does not leave it waiting for itself."""
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute("CREATE TABLE a (x BIGINT)")
    s.execute("INSERT INTO a VALUES (1), (2)")
    readers = []
    real = inst.mdl.acquire_shared

    def spy(key, timeout=None):
        readers.append(key)
        return real(key, timeout)
    inst.mdl.acquire_shared = spy
    assert s.execute("INSERT INTO a SELECT x + 10 FROM a").affected == 2
    assert readers == ["d.a"]


def test_scan_fields_survive_concurrent_drop_column():
    """The reference's `test_concurrency_stress.py` replay on the port: a scan's
    bind-time column snapshot keeps the plan consistent after a DROP COLUMN."""
    from galaxysql_tpu_torch.plan import logical as L
    inst = _stress_instance()
    s = Session(inst, schema="cs")
    s.execute("ALTER TABLE t ADD COLUMN x1 BIGINT DEFAULT 7")
    tm = inst.catalog.table("cs", "t")
    metas = list(tm.columns)
    scan = L.Scan(tm, "t", [(f"t.{c.name}", c.name) for c in metas],
                  col_meta={c.name: c for c in metas})
    s.execute("ALTER TABLE t DROP COLUMN x1")
    assert "t.x1" in [f[0] for f in scan.fields()]


def _stress_instance():
    i = Instance(device="cpu")
    s = Session(i)
    s.execute("CREATE DATABASE cs")
    s.execute("USE cs")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, w BIGINT) "
              "PARTITION BY HASH(id) PARTITIONS 4")
    s.close()
    return i


def test_dml_rollback_ddl_query_storm():
    """The reference's storm, shortened: 3 DML threads (40 statements each, half in
    transactions, a third of those rolled back) beside a thread adding and dropping
    columns and one running queries.  Every committed write is visible, nothing
    rolled back is, and no thread fails."""
    import random
    inst = _stress_instance()
    oracle, failures = {}, []
    stop = threading.Event()

    def dml(tid):
        rng = random.Random(tid)
        s = Session(inst, schema="cs")
        mine, next_id = {}, 0
        try:
            for _op in range(40):
                kind = rng.random()
                in_txn = rng.random() < 0.5
                rollback = in_txn and rng.random() < 0.3
                if in_txn:
                    s.execute("BEGIN")
                staged = dict(mine)
                try:
                    if kind < 0.5 or not mine:
                        rid = tid * 1_000_000 + next_id
                        next_id += 1
                        v = rng.randrange(1000)
                        s.execute(f"INSERT INTO t VALUES ({rid}, {v}, {tid})")
                        staged[rid] = v
                    elif kind < 0.8:
                        rid = rng.choice(list(mine))
                        v = rng.randrange(1000)
                        s.execute(f"UPDATE t SET v = {v} WHERE id = {rid}")
                        staged[rid] = v
                    else:
                        rid = rng.choice(list(mine))
                        s.execute(f"DELETE FROM t WHERE id = {rid}")
                        staged.pop(rid)
                except errors.TddlError:
                    if in_txn:
                        s.execute("ROLLBACK")
                    continue
                if in_txn:
                    s.execute("ROLLBACK" if rollback else "COMMIT")
                    if rollback:
                        continue
                mine = staged
            oracle[tid] = mine
        except Exception as e:  # noqa: BLE001 - asserted in the main thread
            failures.append((tid, repr(e)))
        finally:
            s.close()

    def ddl():
        s = Session(inst, schema="cs")
        i = 0
        try:
            while not stop.is_set():
                i += 1
                try:
                    s.execute(f"ALTER TABLE t ADD COLUMN x{i} BIGINT DEFAULT 7")
                    s.execute("ANALYZE TABLE t")
                    s.execute(f"ALTER TABLE t DROP COLUMN x{i}")
                except errors.TddlError:
                    pass
        except Exception as e:  # noqa: BLE001
            failures.append(("ddl", repr(e)))
        finally:
            s.close()

    def query():
        s = Session(inst, schema="cs")
        try:
            while not stop.is_set():
                r = s.execute("SELECT count(*), sum(v) FROM t")
                assert r.rows and r.rows[0][0] >= 0
                s.execute("SELECT id, v FROM t WHERE id >= 0 ORDER BY id LIMIT 5")
        except Exception as e:  # noqa: BLE001
            failures.append(("query", repr(e)))
        finally:
            s.close()

    workers = [threading.Thread(target=dml, args=(tid,), daemon=True)
               for tid in range(3)]
    aux = [threading.Thread(target=ddl, daemon=True),
           threading.Thread(target=query, daemon=True)]
    for t in workers + aux:
        t.start()
    for t in workers:
        t.join(THREAD_SECONDS)
    stop.set()
    for t in aux:
        t.join(THREAD_SECONDS)
    assert not any(t.is_alive() for t in workers + aux), "a storm thread hung"
    assert not failures, failures
    assert len(oracle) == 3
    want = {}
    for mine in oracle.values():
        want.update(mine)
    s = Session(inst, schema="cs")
    assert dict(s.execute("SELECT id, v FROM t").rows) == want


# -- the point path and the batch scheduler after column DDL -------------------------

def test_point_paths_answer_from_fresh_lanes_after_column_ddl():
    """ADD and DROP COLUMN start a new `lane_gen` in every partition; the
    sequential fast path and the batch scheduler then answer from the new lanes,
    as the reference does."""
    pair = _pair_with(200)
    tpl = "SELECT amount, note FROM o WHERE id = %d"
    for k in (3, 3, 4):
        pair.run("W", tpl % k)
    store = pair.pi.store("test", "o")
    gens = [p.lane_gen for p in store.partitions]
    pair.run("W", "UPDATE o SET note = 'u' WHERE id < 50")
    pair.run("W", "ALTER TABLE o ADD COLUMN z INT DEFAULT 4 AFTER id")
    assert all(p.lane_gen > g for p, g in zip(store.partitions, gens))
    tpl2 = "SELECT z, amount, note FROM o WHERE id = %d"
    n0 = pair.pi.counters["point_plan_queries"]
    for k in (3, 3, 4, 49, 50):
        pair.run("W", tpl2 % k)
        pair.run("W", tpl % k)
    assert pair.pi.counters["point_plan_queries"] > n0
    gens = [p.lane_gen for p in store.partitions]
    pair.run("W", "ALTER TABLE o DROP COLUMN note")
    assert all(p.lane_gen > g for p, g in zip(store.partitions, gens))
    tpl3 = "SELECT z, amount FROM o WHERE id = %d"
    for sql in (tpl % 3, tpl2 % 3, tpl3 % 3, tpl3 % 3):
        pair.run("W", sql)
    pair.assert_same_state()

    inst = pair.pi
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    inst.config.set_instance("BATCH_WINDOW_US", 3000)
    js, _ps = pair.session("W")
    keys = list(range(0, 200, 3))
    expected = {k: js.execute(tpl3 % k).rows for k in keys}
    batched0 = inst.batch_scheduler.counts["batched_queries"]
    failures = []
    barrier = threading.Barrier(24)

    def worker(i):
        try:
            sx = Session(inst, schema="test")
            barrier.wait(THREAD_SECONDS)
            for j in range(8):
                k = keys[(i * 5 + j * 11) % len(keys)]
                assert sx.execute(tpl3 % k).rows == expected[k], k
            sx.close()
        except Exception as e:  # noqa: BLE001
            failures.append(e)
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_SECONDS)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:3]
    assert inst.batch_scheduler.counts["batched_queries"] > batched0


# -- the device cache ------------------------------------------------------------------

def _store_bytes(inst, store):
    cache = inst.device_cache
    with cache._lock:
        return sum(v.numel() * v.element_size() for k, v in cache._map.items()
                   if k[0] == store.uid)


def test_device_cache_evicts_stores_that_leave_for_good(monkeypatch):
    ap_plans(monkeypatch)
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    for name in ("a", "b", "c"):
        s.execute(BIN_TABLE.replace("TABLE t", f"TABLE {name}"))
        s.execute(BIN_ROWS.replace("INTO t", f"INTO {name}"))
        s.execute(f"SELECT v, sum(n) FROM {name} GROUP BY v")
    cache = inst.device_cache
    a, b, c = (inst.store("d", x) for x in "abc")
    assert all(_store_bytes(inst, x) > 0 for x in (a, b, c))

    # the bin keeps the store: its entries survive, FLASHBACK runs warm
    total, misses = cache.nbytes, cache.misses
    s.execute("DROP TABLE a")
    assert cache.nbytes == total
    s.execute("FLASHBACK TABLE a TO BEFORE DROP")
    assert inst.store("d", "a") is a
    s.execute("SELECT v, sum(n) FROM a GROUP BY v")
    assert cache.misses == misses and _store_bytes(inst, a) > 0

    # PURGE, a drop without the bin and DROP DATABASE free the store's bytes
    freed = _store_bytes(inst, a)
    s.execute("DROP TABLE a")
    s.execute("PURGE RECYCLEBIN")
    assert _store_bytes(inst, a) == 0 and cache.nbytes == total - freed
    s.execute("SET ENABLE_RECYCLEBIN = 0")
    total, freed = cache.nbytes, _store_bytes(inst, b)
    s.execute("DROP TABLE b")
    assert cache.nbytes == total - freed and _store_bytes(inst, b) == 0
    assert cache.nbytes == _store_bytes(inst, c) > 0
    s.execute("DROP DATABASE d")
    assert cache.nbytes == 0
    assert all(k.startswith("information_schema.") for k in inst.stores)


def test_device_cache_evicts_a_dropped_gsi(monkeypatch):
    ap_plans(monkeypatch)
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(GSI_TABLE)
    s.execute(GSI_ROWS)
    s.execute("CREATE GLOBAL INDEX g_cust ON o (cust) COVERING (amount)")
    g = inst.store("d", "o$g_cust")
    s.execute("SELECT cust, count(*) FROM o GROUP BY cust")
    s.execute("SELECT cust, amount FROM o$g_cust WHERE amount > 5")
    assert _store_bytes(inst, g) > 0
    freed = inst.device_cache.evict_store(g.uid)
    assert freed > 0 and _store_bytes(inst, g) == 0
    s.execute("SELECT cust, amount FROM o$g_cust WHERE amount > 5")
    before = inst.device_cache.nbytes
    inst.drop_store("d", "o$g_cust")
    assert inst.device_cache.nbytes == before - freed


def test_rename_keeps_the_stores_device_cache_entries(monkeypatch):
    """RENAME keeps the same store under the new name, so the rename task itself
    leaves its lanes in the device cache (the job's last task clears the cache)."""
    ap_plans(monkeypatch)
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE d; USE d")
    s.execute(BIN_TABLE)
    s.execute(BIN_ROWS)
    s.execute("SELECT v, sum(n) FROM t GROUP BY v")
    store = inst.store("d", "t")
    held = _store_bytes(inst, store)
    assert held > 0
    jobs.RenameTableTask({"table": "t", "new_name": "u"}).run(jobs.DdlContext(inst, "d"))
    assert inst.store("d", "u") is store and "d.t" not in inst.stores
    assert _store_bytes(inst, store) == held
    rows = inst.metadb.query("SELECT table_name FROM tables WHERE schema_name='d'")
    assert [r[0] for r in rows] == ["u"]
    assert s.execute("SELECT v, sum(n) FROM u GROUP BY v ORDER BY v").rows == \
        [("a", 10), ("b", 20), ("c", 30)]
