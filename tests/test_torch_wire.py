"""The MySQL wire front end: the JAX package's `MySQLServer` and the port's, each
serving its own engine on the CPU from a thread loop on an ephemeral port, are driven
by the same client code, once through the reference `MiniClient` and once through
the port's copy.  Each scenario must give the same answers (rows, column names, error
numbers and SQL states) from all four pairings of server and client.

Every socket has a timeout and every test an alarm (`_deadline`), so a server that
stops answering fails the test instead of hanging the suite."""

import asyncio
import signal
import struct
import threading

import pytest
import torch

from galaxysql_tpu.net import client as jax_client
from galaxysql_tpu.net.server import MySQLServer as JaxServer
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu_torch.net import client as port_client
from galaxysql_tpu_torch.net import packets as P
from galaxysql_tpu_torch.net.server import MySQLServer
from galaxysql_tpu_torch.server.instance import Instance

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

SOCKET_TIMEOUT = 20.0
TEST_SECONDS = 90
USERS = {"root": "", "alice": "secret"}
CLIENTS = {"ref_client": jax_client, "port_client": port_client}


class _Served:
    """A server on a thread loop of its own."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30)
        self.port = server.port

    def stop(self):
        async def _stop():
            await self.server.stop()
        asyncio.run_coroutine_threadsafe(_stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def servers():
    ref = _Served(JaxServer(JaxInstance(), port=0, users=USERS))
    port_inst = Instance(device="cpu")
    port = _Served(MySQLServer(port_inst, port=0, users=USERS, pool_size=32))
    yield {"ref_server": ref, "port_server": port}
    ref.stop()
    port.stop()


@pytest.fixture(autouse=True)
def _deadline():
    """SIGALRM after TEST_SECONDS: it interrupts a blocked socket read in the test's
    thread (signals reach only the main thread, where pytest runs tests)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(_signum, _frame):
        raise TimeoutError(f"wire test ran past {TEST_SECONDS} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_SECONDS)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _connect(mod, served, **kw):
    return mod.MiniClient("127.0.0.1", served.port, timeout=SOCKET_TIMEOUT, **kw)


def _all_pairings(servers, scenario):
    """`scenario(client_module, served, tag)` for each server and client; all four
    results must be equal.  `tag` names the pairing, for objects it creates."""
    out = {}
    for sname, served in servers.items():
        for cname, mod in CLIENTS.items():
            out[(sname, cname)] = scenario(mod, served, f"{sname[:3]}_{cname[:3]}")
    first = next(iter(out.values()))
    for key, got in out.items():
        assert got == first, (key, got, first)
    return first


def _error(fn):
    """(errno, sqlstate) of the MySQLError `fn` raises (from either client)."""
    try:
        fn()
    except (jax_client.MySQLError, port_client.MySQLError) as e:
        return e.errno, e.sqlstate
    raise AssertionError("no error packet")


def test_handshake_and_password_auth(servers):
    def scenario(mod, served, _tag):
        c = _connect(mod, served)
        out = [c.server_version[:3], c.ping()]
        c.close()
        a = _connect(mod, served, user="alice", password="secret")
        out.append(a.ping())
        a.close()
        out.append(_error(lambda: _connect(mod, served, user="alice", password="bad")))
        out.append(_error(lambda: _connect(mod, served, user="nobody")))
        return out
    assert _all_pairings(servers, scenario)[-2] == (1045, "28000")


def test_query_round_trip_and_error_packets(servers):
    def scenario(mod, served, tag):
        c = _connect(mod, served)
        db = f"rt_{tag}"
        c.query(f"CREATE DATABASE {db}")
        c.query(f"USE {db}")
        c.query("CREATE TABLE t (id BIGINT PRIMARY KEY, name VARCHAR(20), "
                "amount DECIMAL(10,2), d DATE, v DOUBLE)")
        c.query("INSERT INTO t VALUES (1,'ann',3.50,'2024-01-05',0.25),"
                "(2,NULL,NULL,NULL,NULL),(3,'bo',-7.01,'1999-12-31',1e3)")
        out = [c.query("SELECT id, name, amount, d, v FROM t ORDER BY id"),
               c.query("SELECT name, sum(amount) AS s FROM t GROUP BY name "
                       "ORDER BY name"),
               _error(lambda: c.query("SELECT * FROM does_not_exist")),
               _error(lambda: c.query("SELECT nope FROM t")),
               _error(lambda: c.query("SELEC 1")),
               _error(lambda: c.query("CREATE DATABASE " + db)),
               c.query("SELECT 1 AS x")]  # the connection stays usable
        c.close()
        return out
    got = _all_pairings(servers, scenario)
    assert got[0][1][0] == ("1", "ann", "3.5", "2024-01-05", "0.25")
    assert got[2] == (1146, "42S02")


def test_multi_statements(servers):
    def scenario(mod, served, tag):
        c = _connect(mod, served)
        results = c.query_all(f"CREATE DATABASE ms_{tag}; USE ms_{tag}; "
                              "CREATE TABLE m (a BIGINT); INSERT INTO m VALUES (7), (8);"
                              " SELECT a FROM m ORDER BY a")
        last = c.query("SELECT 1; SELECT 2")
        c.close()
        return results, last
    results, last = _all_pairings(servers, scenario)
    assert len(results) == 5 and results[-1][1] == [("7",), ("8",)]
    assert last[1] == [("2",)]


def test_connect_with_database(servers):
    def scenario(mod, served, tag):
        c0 = _connect(mod, served)
        c0.query(f"CREATE DATABASE withdb_{tag}")
        c0.close()
        c = _connect(mod, served, database=f"withdb_{tag}")
        out = c.query("SELECT database() AS d")[1] == [(f"withdb_{tag}",)]
        c.close()
        return [out, _error(lambda: _connect(mod, served, database="no_such_db"))]
    assert _all_pairings(servers, scenario)[0] is True


def test_prepared_statements_binary_protocol(servers):
    def scenario(mod, served, tag):
        c = _connect(mod, served)
        c.query_all(f"CREATE DATABASE ps_{tag}; USE ps_{tag}")
        c.query("CREATE TABLE p (id BIGINT PRIMARY KEY, v DOUBLE, s VARCHAR(10), "
                "amt DECIMAL(8,2), d DATE)")
        ins = c.prepare("INSERT INTO p VALUES (?, ?, ?, ?, ?)")
        c.execute(ins, [1, 2.5, "xy", "1.25", "2024-02-29"])
        c.execute(ins, [2, None, None, None, None])
        c.execute(ins, [3, -1.0, "who?", "-3.5", "2000-01-01"])
        sel = c.prepare("SELECT id, v, s, amt, d FROM p WHERE id >= ? ORDER BY id")
        out = [c.execute(sel, [1]), c.execute(sel, [3])]
        pt = c.prepare("SELECT s FROM p WHERE id = ?")
        out.append(c.execute(pt, [1]))
        # a second execute without types: the server reuses the cached ones
        payload = (bytes([P.COM_STMT_EXECUTE]) + struct.pack("<IBI", pt, 0, 1) +
                   b"\x00" + b"\x00" + struct.pack("<q", 3))
        c._command(payload)
        out.append(c._read_result(binary=True))
        out.append(_error(lambda: c.prepare("SELEC ?")))
        c._command(bytes([P.COM_STMT_EXECUTE]) + struct.pack("<IBI", 999, 0, 1))
        out.append(_error(lambda: c._read_result(binary=True)))
        c._command(bytes([P.COM_STMT_CLOSE]) + struct.pack("<I", pt))
        out.append(c.ping())
        c.close()
        return out
    got = _all_pairings(servers, scenario)
    assert got[0][1][0] == (1, 2.5, "xy", "1.25", "2024-02-29")
    assert got[3][1] == [("who?",)]


def _field_list(c, table):
    """COM_FIELD_LIST: the column definitions up to EOF, as (name, type) pairs."""
    c._command(bytes([P.COM_FIELD_LIST]) + table.encode() + b"\0")
    out = []
    while True:
        pkt = c._read_packet()
        if pkt[0] == 0xFF:
            raise c._err(pkt)
        if pkt[0] == 0xFE and len(pkt) < 9:
            return out
        pos = 0
        for _ in range(4):
            _v, pos = P.read_lenenc_str(pkt, pos)
        name, pos = P.read_lenenc_str(pkt, pos)
        _v, pos = P.read_lenenc_str(pkt, pos)
        out.append((name.decode(), pkt[pos + 1 + 2 + 4]))


def test_field_list_show_and_init_db(servers):
    def scenario(mod, served, tag):
        c = _connect(mod, served)
        c.query_all(f"CREATE DATABASE fl_{tag}; USE fl_{tag}")
        c.query("CREATE TABLE f (id BIGINT PRIMARY KEY, name VARCHAR(5), d DATE) "
                "PARTITION BY HASH(id) PARTITIONS 2")
        out = [_field_list(c, "f"), _error(lambda: _field_list(c, "nope")),
               c.query("SHOW TABLES"), c.query("SHOW COLUMNS FROM f"),
               c.query("SHOW CREATE TABLE f"), c.query("DESCRIBE f"),
               c.query("SHOW INDEX FROM f"), c.query(f"SHOW DATABASES LIKE 'fl_{tag}'"),
               c.query("SHOW VARIABLES LIKE 'enable_batch%'"),
               c.query("SELECT table_name, table_rows FROM information_schema.tables "
                       f"WHERE table_schema = 'fl_{tag}'")]
        c._command(bytes([P.COM_INIT_DB]) + b"information_schema")
        out.append(c._read_packet()[0])
        out.append(c.query("SELECT count(*) FROM schemata WHERE schema_name "
                           f"= 'fl_{tag}'"))
        c.close()
        # the database names differ by pairing: compare them with the tag taken out
        return repr(out).replace(tag, "TAG")
    got = _all_pairings(servers, scenario)
    assert "('id', 253)" in got and "Tables_in_fl_TAG" in got


def test_compressed_round_trip(servers):
    def scenario(mod, served, tag):
        c = _connect(mod, served, compress=True)
        c.query_all(f"CREATE DATABASE zc_{tag}; USE zc_{tag}")
        c.query("CREATE TABLE t (a BIGINT, s VARCHAR(64))")
        big = "x" * 60
        c.query("INSERT INTO t VALUES " +
                ",".join(f"({i}, '{big}')" for i in range(500)))
        rows = c.query("SELECT a, s FROM t ORDER BY a")
        plain = _connect(mod, served, database=f"zc_{tag}")
        out = [rows, plain.query("SELECT count(*), max(a) FROM t"),
               _error(lambda: c.query("SELECT * FROM missing"))]
        c.close()
        plain.close()
        return out
    got = _all_pairings(servers, scenario)
    assert len(got[0][1]) == 500 and got[1][1] == [("500", "499")]


def test_transaction_rollback_over_the_wire(servers):
    def scenario(mod, served, tag):
        w = _connect(mod, served)
        w.query_all(f"CREATE DATABASE tx_{tag}; USE tx_{tag}")
        w.query("CREATE TABLE a (id BIGINT PRIMARY KEY, bal BIGINT)")
        w.query("INSERT INTO a VALUES (1, 100), (2, 50)")
        r = _connect(mod, served, database=f"tx_{tag}")
        q = "SELECT id, bal FROM a ORDER BY id"
        w.query("BEGIN")
        w.query("UPDATE a SET bal = bal - 30 WHERE id = 1")
        w.query("UPDATE a SET bal = bal + 30 WHERE id = 2")
        out = [w.query(q), r.query(q)]          # own writes / the old snapshot
        w.query("ROLLBACK")
        out += [w.query(q), r.query(q)]
        w.query("BEGIN")
        w.query("DELETE FROM a WHERE id = 2")
        out.append(_error(lambda: r.query("UPDATE a SET bal = 0 WHERE id = 2")))
        w.query("COMMIT")
        out += [w.query(q), r.query(q)]
        w.close()
        r.close()
        return out
    got = _all_pairings(servers, scenario)
    assert got[0][1] == [("1", "70"), ("2", "80")] and got[1][1] == got[2][1]
    assert got[-1][1] == [("1", "100")]


def test_binlog_dump_streams_the_change_log(servers):
    """COM_BINLOG_DUMP from 0 and from the last seq seen, in every pairing: the
    events of the scenario's own schema, their kinds, tables and payloads, equal;
    seqs and commit timestamps by their order.  The connection stays usable."""
    def scenario(mod, served, tag):
        c = _connect(mod, served)
        db = f"bl_{tag}"
        c.query_all(f"CREATE DATABASE {db}; USE {db}")
        c.query("CREATE TABLE ev (id INT PRIMARY KEY, v VARCHAR(10), "
                "amt DECIMAL(8,2), d DATE) PARTITION BY HASH(id) PARTITIONS 2")
        c.query("INSERT INTO ev VALUES (1, 'a', 1.50, '2024-01-05'), "
                "(2, NULL, NULL, NULL), (3, 'c', -2.25, '1999-12-31')")
        c.query("UPDATE ev SET v = 'u' WHERE id = 3")
        c.query("DELETE FROM ev WHERE id = 1")
        events = c.binlog_dump(0)
        mine = [e for e in events if e["schema"] == db]
        last = max(e["seq"] for e in events)
        after = c.binlog_dump(last)
        c.query("INSERT INTO ev VALUES (4, 'd', 0.01, NULL)")
        tail = [(e["table"], e["kind"], e["payload"]) for e in c.binlog_dump(last)]
        assert c.ping()
        c.close()
        seqs = {s: i for i, s in enumerate(sorted(e["seq"] for e in mine))}
        tss = {t: i for i, t in enumerate(sorted({e["commit_ts"] for e in mine}))}
        return ([(seqs[e["seq"]], tss[e["commit_ts"]], e["table"], e["kind"],
                  e["payload"]) for e in mine], after, tail)
    events, after, tail = _all_pairings(servers, scenario)
    assert [e[3] for e in events] == ["insert", "insert", "delete", "insert", "delete"]
    assert after == [] and len(tail) == 1


def test_point_selects_from_16_connections_with_batching(servers):
    """16 connections, each a thread of this process, run prepared and text point
    selects with the batch scheduler on; every answer equals the table's row, in
    every pairing."""
    n_rows, per_conn = 400, 24

    def scenario(mod, served, tag):
        c = _connect(mod, served)
        db = f"pt_{tag}"
        c.query_all(f"CREATE DATABASE {db}; USE {db}")
        c.query("CREATE TABLE sb (id BIGINT PRIMARY KEY, k BIGINT, c VARCHAR(20)) "
                "PARTITION BY HASH(id) PARTITIONS 4")
        c.query("INSERT INTO sb VALUES " +
                ",".join(f"({i}, {i % 7}, 'c-{i}')" for i in range(1, n_rows + 1)))
        c.query("SET GLOBAL ENABLE_BATCH_SCHEDULER = 1")
        c.query("SELECT c FROM sb WHERE id=1")  # registers the PointPlan
        answers = {}
        errors = []
        start = threading.Barrier(16)

        def run(i):
            try:
                s = _connect(mod, served, database=db)
                sid = s.prepare("SELECT c FROM sb WHERE id=?")
                start.wait(timeout=SOCKET_TIMEOUT)
                for j in range(per_conn):
                    key = (i * 37 + j * 11) % n_rows + 1
                    if j % 2:
                        rows = s.execute(sid, [key])[1]
                    else:
                        rows = s.query(f"SELECT c FROM sb WHERE id={key}")[1]
                    answers[(i, j)] = (key, rows)
                s.close()
            except BaseException as e:  # carried to the test's thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TEST_SECONDS)
        c.close()
        assert not errors, errors[0]
        assert len(answers) == 16 * per_conn
        for key, rows in answers.values():
            assert rows == [(f"c-{key}",)], (key, rows)
        return sorted(answers.items())
    _all_pairings(servers, scenario)
    port_inst = servers["port_server"].server.instance
    assert port_inst.counters["point_plan_queries"] + \
        port_inst.batch_scheduler.counts["batched_queries"] > 0
