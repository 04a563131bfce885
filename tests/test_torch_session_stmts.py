"""Session statements: SET, SHOW, DESCRIBE, information_schema, EXPLAIN [ANALYZE] and
the privilege statements, through the JAX package's `Session` and the port's
`Session(Instance(device="cpu"))` on the CPU.  The same statements go through both
engines in the same order; the results must agree on column names, column types
(as SQL names) and rows, or both must raise the same error type."""

import re

import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

SETUP = [
    "CREATE DATABASE s",
    "USE s",
    "CREATE TABLE h (id BIGINT NOT NULL AUTO_INCREMENT PRIMARY KEY, "
    "name VARCHAR(20), amt DECIMAL(10,2), d DATE, INDEX i_name (name)) "
    "PARTITION BY HASH(id) PARTITIONS 4",
    "CREATE TABLE one (k INT PRIMARY KEY, v DOUBLE) SINGLE",
    "CREATE TABLE b (code CHAR(2) NOT NULL, label VARCHAR(30), "
    "UNIQUE KEY u_code (code)) BROADCAST",
    "INSERT INTO h (name, amt, d) VALUES ('ann', 1.50, '2024-01-05'), "
    "('bob', 20.25, NULL), (NULL, NULL, '2023-02-01'), ('cy', -3.10, '2024-07-07')",
    "INSERT INTO one VALUES (1, 0.5), (2, 1e3)",
    "INSERT INTO b VALUES ('cn', 'China'), ('de', 'Germany')",
    "ANALYZE TABLE h, one, b",
    "SELECT name, sum(amt) FROM h GROUP BY name ORDER BY name",
]


def _types(rs):
    return [t.sql_name() for t in rs.types]


class Twin:
    """The two engines with named sessions on each side, set up by SETUP."""

    def __init__(self):
        self.ji = JaxInstance()
        self.pi = Instance(device="cpu")
        self.sessions = {}
        for sql in SETUP:
            self.run(sql)

    def session(self, name="root"):
        if name not in self.sessions:
            js, ps = JaxSession(self.ji), Session(self.pi)
            if self.sessions:
                js.execute("USE s")
                ps.execute("USE s")
            self.sessions[name] = (js, ps)
        return self.sessions[name]

    def run(self, sql, name="root", ordered=True):
        """Runs `sql` in both engines' session `name`; both give the same result or
        raise the same error type (returned then)."""
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
        assert got.names == want.names, sql
        assert _types(got) == _types(want), sql
        if ordered:
            assert got.rows == want.rows, sql
        else:
            assert sorted(got.rows, key=repr) == sorted(want.rows, key=repr), sql
        assert got.affected == want.affected, sql
        return got


@pytest.fixture(scope="module")
def twin():
    return Twin()


def test_set_scopes_then_show_variables():
    t = Twin()
    t.run("SET MAX_EXECUTION_TIME = 2500")
    t.run("SET @answer = 42")
    t.run("SET session my_knob = 'on'")
    t.run("SET GLOBAL ENABLE_BATCH_SCHEDULER = 0")
    for sql in ("SHOW VARIABLES", "SHOW VARIABLES LIKE 'max_exec%'",
                "SHOW VARIABLES LIKE 'enable_batch%'", "SHOW VARIABLES LIKE 'my%'"):
        t.run(sql)
    js, ps = t.session()
    assert ps.vars == js.vars == {"MAX_EXECUTION_TIME": 2500, "my_knob": "on"}
    assert ps.user_vars == js.user_vars == {"answer": 42}
    assert t.pi.config.get("ENABLE_BATCH_SCHEDULER") == \
        t.ji.config.get("ENABLE_BATCH_SCHEDULER")
    assert not t.pi.batch_scheduler.enabled()
    # SET GLOBAL lands in the metadb, whose listener reloads it
    assert t.pi.metadb.kv_get("config.param.ENABLE_BATCH_SCHEDULER") == \
        t.ji.metadb.kv_get("config.param.ENABLE_BATCH_SCHEDULER")
    t.pi.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    # (CREATE TABLE notifies its table's data id, as in the reference)
    assert sorted(t.pi.config_listener.poll()) == \
        ["config.params", "table.s.b", "table.s.h", "table.s.one"]
    assert t.pi.config.get("ENABLE_BATCH_SCHEDULER") in (0, False)
    # a second session sees the global value, not the first one's session value
    t.run("SHOW VARIABLES LIKE 'max_exec%'", name="other")
    t.run("SHOW VARIABLES LIKE 'enable_batch%'", name="other")


SHOWS = [
    "SHOW DATABASES", "SHOW DATABASES LIKE 's%'", "SHOW SCHEMAS",
    "SHOW TABLES", "SHOW TABLES LIKE 'o%'", "SHOW TABLES FROM s", "SHOW FULL TABLES",
    "SHOW COLUMNS FROM h", "SHOW FIELDS FROM b", "SHOW CREATE TABLE h",
    "SHOW INDEX FROM h", "SHOW INDEXES FROM b", "SHOW KEYS FROM one",
    "SHOW PROCESSLIST", "SHOW FULL PROCESSLIST", "SHOW WARNINGS", "SHOW STATUS",
    "SHOW ENGINES", "SHOW CHARSET", "SHOW COLLATION", "SHOW COLLATION LIKE 'utf8mb4%'",
    "SHOW TABLES FROM nowhere", "SHOW CREATE TABLE nope",
    "SHOW RECYCLEBIN", "SHOW DDL",
]


@pytest.mark.parametrize("sql", SHOWS)
def test_show_kind(twin, sql):
    twin.run(sql)


def test_show_batch_stats(twin):
    """The point scheduler's rows, then the DML batcher's and the async applier's,
    with the reference's names in its order; values equal but for the DML group-size
    and wait quantiles, which the reference keeps in its process-wide metrics
    registry (ROADMAP Queue 1 item 16)."""
    js, ps = twin.session()
    want, got = js.execute("SHOW BATCH STATS"), ps.execute("SHOW BATCH STATS")
    assert got.names == want.names and _types(got) == _types(want)
    assert [r[0] for r in got.rows] == \
        [n for n, _v in twin.ji.batch_scheduler.stats_rows()] + \
        [n for n, _v in twin.ji.dml_batch_scheduler.stats_rows()]
    assert _comparable(got.rows) == _comparable(want.rows)


def _comparable(rows):
    return [r for r in rows if not r[0].startswith(("dml_group_size", "dml_wait_ms"))]


def test_show_binlog_events(twin):
    """SHOW BINLOG EVENTS after the same writes: equal columns, types, kinds, tables
    and payloads; commit timestamps and seqs compare by their order."""
    t = Twin()
    t.run("INSERT INTO one VALUES (3, 2.5)")
    t.run("UPDATE h SET amt = 9.99 WHERE name = 'bob'")
    t.run("DELETE FROM b WHERE code = 'de'")
    js, ps = t.session()
    want, got = js.execute("SHOW BINLOG EVENTS"), ps.execute("SHOW BINLOG EVENTS")
    assert got.names == want.names and _types(got) == _types(want)

    def norm(rows):
        seqs = {v: i for i, v in enumerate(sorted({r[0] for r in rows}))}
        tss = {v: i for i, v in enumerate(sorted({r[1] for r in rows}))}
        return [(seqs[r[0]], tss[r[1]]) + tuple(r[2:]) for r in rows]
    assert norm(got.rows) == norm(want.rows) and len(got.rows) == len(want.rows) > 3


def test_show_trace_of_a_point_select(twin):
    """SHOW TRACE lists the last query's trace tags.  After a fast-path point select
    they are the PointPlan's in both engines, up to the measured time; the reference
    puts its trace id first and its span tree after (both wait for
    `utils/tracing.py`)."""
    js, ps = twin.session()
    for _ in range(2):  # the first run registers the PointPlan
        twin.run("SELECT v FROM one WHERE k = 2")
    want, got = js.execute("SHOW TRACE"), ps.execute("SHOW TRACE")
    assert got.names == want.names and _types(got) == _types(want)

    def tags(rs):
        return [re.sub(r"elapsed=[0-9.]+s", "elapsed=?s", r[0]) for r in rs.rows
                if not r[0].startswith("trace-id ")]
    assert tags(got) == tags(want) == ["point-plan one.k", "elapsed=?s workload=TP"]


# the SHOW kinds the port once refused, each now answered as the reference answers
FORMERLY_WAITING_SHOWS = ["coordinators", "rebalance"]


@pytest.mark.parametrize("kind", FORMERLY_WAITING_SHOWS)
def test_unported_show_kinds_raise(twin, kind):
    """SHOW COORDINATORS and SHOW REBALANCE, which waited for the placement slice:
    the same columns and types as the reference's, SHOW REBALANCE the same rows, and
    SHOW COORDINATORS this node's row alone (no peer attached), with the node id
    (random) left out."""
    js, ps = twin.session()
    sql = f"SHOW {kind.upper()}"
    want, got = js.execute(sql), ps.execute(sql)
    assert got.names == want.names and _types(got) == _types(want)
    if kind == "coordinators":
        assert [r[1:] for r in got.rows] == [r[1:] for r in want.rows]
        assert [r[0] for r in got.rows] == [twin.pi.node_id]
    else:
        assert got.rows == want.rows


def test_show_fragment_cache(twin):
    """SHOW FRAGMENT CACHE and information_schema.fragment_cache after the same
    queries: the same columns and types, the same entry kinds over the same tables
    with the same hits, MRU first (row counts and bytes follow each engine's own
    batch capacities and lane widths)."""
    js, ps = twin.session()
    for sql in ("SELECT h.name, b.label FROM h JOIN b ON h.name = b.code",
                "SELECT name, count(*) FROM h GROUP BY name ORDER BY name",
                "SELECT name, count(*) FROM h GROUP BY name ORDER BY name"):
        twin.run(sql, ordered=False)
    want, got = js.execute("SHOW FRAGMENT CACHE"), ps.execute("SHOW FRAGMENT CACHE")
    assert got.names == want.names == ["Kind", "Tables", "Rows", "Bytes", "Hits"]
    assert _types(got) == _types(want)

    def entries(rows):
        return [(k, t, h) for k, t, _r, _b, h in rows]
    assert entries(got.rows) == entries(want.rows)
    assert any(h for _k, _t, h in entries(got.rows))
    sql = ("SELECT entry_kind, tables, hits FROM information_schema.fragment_cache "
           "ORDER BY entry_kind, tables, hits")
    want, got = js.execute(sql), ps.execute(sql)
    assert got.rows == want.rows and got.rows


@pytest.mark.parametrize("table", ["h", "one", "b"])
def test_describe_and_show_create(twin, table):
    twin.run(f"DESCRIBE {table}")
    twin.run(f"DESC s.{table}")
    twin.run(f"SHOW CREATE TABLE {table}")


VIEWS = ["schemata", "tables", "columns", "statistics", "partitions", "processlist",
         "engines", "global_variables", "session_variables", "plan_cache", "ddl_jobs"]


@pytest.mark.parametrize("view", VIEWS)
def test_information_schema_view(twin, view):
    twin.run(f"SELECT * FROM information_schema.{view}", ordered=False)


def test_information_schema_queries(twin):
    twin.run("SELECT table_name, table_rows FROM information_schema.tables "
             "WHERE table_schema = 's' ORDER BY table_name")
    twin.run("SELECT table_name, count(*) AS n FROM information_schema.columns "
             "WHERE table_schema = 's' GROUP BY table_name ORDER BY table_name")
    twin.run("SELECT t.table_name, p.partition_name, p.table_rows FROM "
             "information_schema.tables t JOIN information_schema.partitions p "
             "ON t.table_name = p.table_name WHERE t.table_schema = 's' "
             "ORDER BY t.table_name, p.partition_name")
    twin.run("SELECT variable_value FROM information_schema.session_variables "
             "WHERE variable_name = 'enable_batch_scheduler'")


def test_information_schema_batch_stats(twin):
    """The point scheduler's and the DML batcher's rows, as SHOW BATCH STATS gives
    them."""
    js, ps = twin.session()
    sql = "SELECT stat_name, value FROM information_schema.batch_stats"
    want, got = js.execute(sql), ps.execute(sql)
    assert _comparable(got.rows) == _comparable(want.rows) and got.rows
    assert [r[0] for r in got.rows] == [r[0] for r in want.rows]


# the views the port once refused, each now filled as the reference fills it
FORMERLY_WAITING_VIEWS = ["coordinators", "rebalance_jobs"]


@pytest.mark.parametrize("view", FORMERLY_WAITING_VIEWS)
def test_unported_views_raise(twin, view):
    """information_schema.coordinators and .rebalance_jobs, which waited for the
    placement slice: the reference's columns and types, and its rows (the node id,
    random, left out)."""
    js, ps = twin.session()
    sql = f"SELECT * FROM information_schema.{view}"
    want, got = js.execute(sql), ps.execute(sql)
    assert got.names == want.names and _types(got) == _types(want)
    if view == "coordinators":
        assert [r[1:] for r in got.rows] == [r[1:] for r in want.rows]
        assert [r[0] for r in got.rows] == [twin.pi.node_id]
    else:
        assert got.rows == want.rows


def test_users_grants_and_refusals():
    t = Twin()
    t.run("SELECT v FROM one WHERE k = 1")  # registers the PointPlan as root
    t.run("SELECT v FROM one WHERE k = 2")
    t.run("CREATE USER 'alice' IDENTIFIED BY 'pw'")
    t.run("CREATE USER 'alice'")                      # exists: TddlError
    t.run("CREATE USER IF NOT EXISTS 'alice'")
    js, ps = t.session("alice")
    js.user = ps.user = "alice"
    denied = errors.AccessDeniedError
    for sql in ("SELECT v FROM one WHERE k = 1",       # the point fast path
                "SELECT count(*) FROM h", "INSERT INTO one VALUES (3, 1)",
                "CREATE USER 'bob'", "GRANT SELECT ON s.* TO 'alice'"):
        assert t.run(sql, name="alice") is denied, sql
    t.run("GRANT SELECT ON s.one TO 'alice'")
    assert t.run("SELECT v FROM one WHERE k = 1", name="alice").rows == [(0.5,)]
    assert ps.last_trace[0].startswith("trace-id ")
    assert ps.last_trace[1] == "point-plan one.k"
    assert t.run("SELECT count(*) FROM h", name="alice") is denied
    t.run("GRANT SELECT, INSERT ON s.* TO 'alice'")
    t.run("INSERT INTO one VALUES (3, 1)", name="alice")
    t.run("SELECT count(*) FROM h", name="alice")
    t.run("REVOKE SELECT ON s.* FROM 'alice'")
    t.run("REVOKE SELECT ON s.one FROM 'alice'")
    assert t.run("SELECT v FROM one WHERE k = 2", name="alice") is denied
    assert t.run("SELECT count(*) FROM h", name="alice") is denied
    t.run("SELECT count(*) FROM information_schema.tables", name="alice")
    t.run("DROP USER 'alice'")
    t.run("DROP USER 'alice'")                        # gone: TddlError
    t.run("DROP USER IF EXISTS 'alice'")
    assert t.pi.privileges.password_hash("alice") is None
    assert t.pi.privileges.is_super("root")


# -- EXPLAIN of TPC-H, over the lanes of one load ---------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(0.01)
    ji, pi = JaxInstance(), Instance(device="cpu")
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
    return js, ps


@pytest.mark.parametrize("q", range(1, 23))
def test_explain_tpch_plans_line_for_line(tpch_pair, q):
    js, ps = tpch_pair
    want, got = js.execute("EXPLAIN " + QUERIES[q]), ps.execute("EXPLAIN " + QUERIES[q])
    assert got.names == want.names == ["plan"]
    assert got.rows == want.rows


# lines only the reference prints: its skew-aware splits come from MPP execution
# (ROADMAP Queue 1 item 15)
_REFERENCE_ONLY = ("HotKeys(", "Salted(")
_RF_LINE = "RuntimeFilter("
_ACTUAL = re.compile(r"^(.*?)  \(actual rows=(\d+) ")


def _nodes(rs):
    """(node line without its `(actual ...)` suffix, actual rows) per plan node."""
    out = []
    for (line,) in rs.rows:
        if line.startswith("--") or line.strip().startswith(_REFERENCE_ONLY + (_RF_LINE,)):
            continue
        m = _ACTUAL.match(line)
        assert m, line
        out.append((m.group(1), int(m.group(2))))
    return out


def _rf_lines(rs):
    """The `RuntimeFilter(column, kinds, pruned=n)` lines, in plan order."""
    return [line for (line,) in rs.rows if line.strip().startswith(_RF_LINE)]


# Q5 without the fragment cache; Q3 and Q5 also with NO_BLOOM, which turns off the
# runtime filters, and at the defaults, where the runtime filters prune probe rows
# (the filter above them counts the rows the filter left) and each engine prints one
# `RuntimeFilter(...)` line per masked scan.  EXPLAIN ANALYZE replays no aggregate and
# no build subtree; the defaults run first in the module, so no join build is cached.
@pytest.mark.parametrize("q,hint", [(3, ""), (5, ""),
                                    (5, "FRAGMENT_CACHE(OFF)"),
                                    (3, "NO_BLOOM FRAGMENT_CACHE(OFF)"),
                                    (5, "NO_BLOOM FRAGMENT_CACHE(OFF)")])
def test_explain_analyze_rows_per_node(tpch_pair, q, hint):
    js, ps = tpch_pair
    head = f"/*+TDDL:{hint}*/ " if hint else ""
    sql = f"EXPLAIN ANALYZE {head}{QUERIES[q]}"
    want, got = js.execute(sql), ps.execute(sql)
    nodes = _nodes(got)
    assert nodes == _nodes(want)
    assert len(nodes) > 5
    assert _rf_lines(got) == _rf_lines(want)
    assert bool(_rf_lines(got)) == ("NO_BLOOM" not in hint)
    lines = [r[0] for r in got.rows]
    rows = next(ln for ln in lines if ln.startswith("-- rows: "))
    assert rows == next(r[0] for r in want.rows if r[0].startswith("-- rows: "))
    assert any(ln.startswith("-- transfer: h2d_bytes=") for ln in lines)
    assert lines[-1] == want.rows[-1][0] == "-- workload: AP"
    ops = [ln for ln in lines if ln.startswith("-- op ")]
    assert len(ops) == len(nodes)
