"""The change log (`txn/cdc.py`): the port against the JAX package on the CPU.

Each scenario runs the same statements through the JAX package's `Instance()` and the
port's `Instance(device="cpu")` and returns what a binlog consumer observes: the
events' kinds, tables and payloads (byte for byte), their commit timestamps and
sequence numbers only by order and equality (the engines draw different TSO values),
table rows after a replay, and the transaction log's states.  The two engines'
observations must be equal.

Covered: the reference's six CDC cases (`tests/test_cdc.py`); the binlog under
`TRANSACTION_POLICY = 'XA'`, including a commit whose participant fails after the
commit point (`TransactionError` with `commit_ts`); COM_BINLOG_DUMP against the
port's server through both packages' clients (`tests/test_protocol.py`
`TestBinlogDump`); replay across the packages both ways (a TPC-H SF 0.01 refresh
pair, and DECIMAL, DATE, VARCHAR and NULL values); and the port's key-index matching
in `_replay_delete` against the reference's loop on the same targets and events.
"""

import asyncio
import json
import threading
import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.chunk.batch import Column as JaxColumn
from galaxysql_tpu.net import client as jax_client
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.txn import cdc as jax_cdc
from galaxysql_tpu.txn import xa as jax_xa
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.chunk.batch import Column
from galaxysql_tpu_torch.net import client as port_client
from galaxysql_tpu_torch.net.server import MySQLServer
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import tpch_refresh, transfer
from galaxysql_tpu_torch.txn import cdc, xa
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

DDL = ("CREATE TABLE t (id BIGINT PRIMARY KEY, grp BIGINT, val VARCHAR(16)) "
       "PARTITION BY HASH(id) PARTITIONS 4")

JAX = types.SimpleNamespace(name="jax", instance=JaxInstance, Session=JaxSession,
                            cdc=jax_cdc, xa=jax_xa, errors=jax_errors)
PORT = types.SimpleNamespace(name="port", instance=lambda: Instance(device="cpu"),
                             Session=Session, cdc=cdc, xa=xa, errors=errors)


def _both(scenario):
    """`scenario(engine)` through both engines; their observations must be equal.
    Returns the port's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


def _norm(events):
    """Events with seq and commit_ts replaced by their ranks in the list."""
    seqs = {s: i for i, s in enumerate(sorted({e[0] for e in events}))}
    tss = {t: i for i, t in enumerate(sorted({e[1] for e in events}))}
    return [(seqs[e[0]], tss[e[1]]) + tuple(e[2:]) for e in events]


def _session(eng, ddl=DDL, schema="c"):
    inst = eng.instance()
    s = eng.Session(inst)
    s.execute(f"CREATE DATABASE {schema}")
    s.execute(f"USE {schema}")
    s.execute(ddl)
    return inst, s


def _state(s, table="t", order="id"):
    return s.execute(f"SELECT * FROM {table} ORDER BY {order}").rows


def _visible(inst, schema, table):
    """Every visible row of a store, decoded by its own package's `Column`, sorted."""
    tm = inst.catalog.table(schema, table)
    column = JaxColumn if isinstance(inst, JaxInstance) else Column
    rows = []
    for p in inst.store(schema, table).partitions:
        ids = np.nonzero(p.visible_mask(None))[0]
        cols = [column(np.asarray(p.lanes[c.name])[ids],
                       np.asarray(p.valid[c.name])[ids], c.dtype,
                       tm.dictionaries.get(c.name.lower())).to_pylist()
                for c in tm.columns]
        rows.extend(zip(*cols))
    return sorted(rows, key=repr)


# -- the reference's six cases (tests/test_cdc.py) --------------------------------

def test_events_ordered_by_commit_tso():
    def scenario(eng):
        _inst, s = _session(eng)
        s.execute("INSERT INTO t VALUES (1, 1, 'a'), (2, 2, 'b')")
        s.execute("UPDATE t SET val = 'u' WHERE id = 1")
        s.execute("DELETE FROM t WHERE id = 2")
        rs = s.execute("SHOW BINLOG EVENTS")
        kinds = [r[4] for r in rs.rows]
        assert kinds[-3:] == ["delete", "insert", "delete"]
        assert set(kinds[:-3]) == {"insert"}
        tsos = [r[1] for r in rs.rows]
        assert tsos == sorted(tsos)
        return rs.names, [t.sql_name() for t in rs.types], _norm(rs.rows)
    _both(scenario)


def test_txn_events_flush_at_commit_with_one_tso():
    def scenario(eng):
        _inst, s = _session(eng)
        s.execute("BEGIN")
        s.execute("INSERT INTO t VALUES (10, 1, 'x')")
        s.execute("INSERT INTO t VALUES (11, 1, 'y')")
        assert s.execute("SHOW BINLOG EVENTS").rows == []  # nothing before COMMIT
        s.execute("COMMIT")
        rows = s.execute("SHOW BINLOG EVENTS").rows
        assert len(rows) == 2 and rows[0][1] == rows[1][1]  # one commit TSO
        return _norm(rows)
    _both(scenario)


def test_rollback_publishes_nothing():
    def scenario(eng):
        _inst, s = _session(eng)
        s.execute("BEGIN")
        s.execute("INSERT INTO t VALUES (20, 1, 'gone')")
        s.execute("UPDATE t SET val = 'x' WHERE id = 20")
        s.execute("ROLLBACK")
        return s.execute("SHOW BINLOG EVENTS").rows
    assert _both(scenario) == []


def test_replay_reproduces_state():
    def scenario(eng):
        inst, s = _session(eng)
        s.execute("INSERT INTO t VALUES (1,1,'a'), (2,2,'b'), (3,3,'c')")
        s.execute("BEGIN")
        s.execute("UPDATE t SET val = 'upd' WHERE id = 2")
        s.execute("INSERT INTO t VALUES (4, 4, 'd')")
        s.execute("COMMIT")
        s.execute("DELETE FROM t WHERE id = 1")
        want = _state(s)
        target, ts = _session(eng)
        assert eng.cdc.replay(inst.cdc.events(), target) > 0
        assert _state(ts) == want
        return want, _norm(inst.cdc.events())
    _both(scenario)


def test_replay_crash_midstream_resumes_idempotently():
    def scenario(eng):
        inst, s = _session(eng)
        s.execute("INSERT INTO t VALUES (1,1,'a'), (2,2,'b'), (3,3,'c')")
        s.execute("UPDATE t SET val = 'u2' WHERE id = 2")
        s.execute("DELETE FROM t WHERE id = 3")
        want = _state(s)
        events = inst.cdc.events()
        target, ts = _session(eng)
        applied = [eng.cdc.replay(events, target, stop_after=2)]  # a consumer crash
        applied.append(eng.cdc.replay(events, target))  # the stream redelivered
        assert applied == [2, len(events) - 2]
        assert _state(ts) == want
        applied.append(eng.cdc.replay(events, target))  # a third time: a no-op
        assert applied[-1] == 0 and _state(ts) == want
        return applied, want, target.metadb.kv_get("cdc.applied_watermark") == \
            str(events[-1][0])
    _both(scenario)


def test_disable_via_config():
    def scenario(eng):
        _inst, s = _session(eng)
        s.execute("SET GLOBAL ENABLE_CDC = 0")
        s.execute("INSERT INTO t VALUES (30, 1, 'q')")
        assert s.execute("SHOW BINLOG EVENTS").rows == []
        s.execute("SET GLOBAL ENABLE_CDC = 1")
        s.execute("INSERT INTO t VALUES (31, 1, 'r')")
        return _norm(s.execute("SHOW BINLOG EVENTS").rows)
    assert len(_both(scenario)) == 1


def test_truncate_logs_nothing():
    def scenario(eng):
        _inst, s = _session(eng)
        s.execute("INSERT INTO t VALUES (1, 1, 'a')")
        n = len(s.execute("SHOW BINLOG EVENTS").rows)
        s.execute("TRUNCATE TABLE t")
        return n, len(s.execute("SHOW BINLOG EVENTS").rows)
    assert _both(scenario) == (1, 1)


# -- XA ------------------------------------------------------------------------------

XA_DDL2 = "CREATE TABLE u (k BIGINT PRIMARY KEY, v VARCHAR(8)) SINGLE"


def test_binlog_under_xa():
    """BEGIN/INSERT/UPDATE/DELETE/COMMIT over two tables under XA: one commit TSO
    for the transaction's events, the tx log DONE at it; a rolled-back XA
    transaction logs nothing."""
    def scenario(eng):
        inst, s = _session(eng)
        s.execute(XA_DDL2)
        s.execute("INSERT INTO t VALUES (1, 1, 'a'), (2, 2, 'b'), (3, 3, 'c')")
        s.execute("SET TRANSACTION_POLICY = 'XA'")
        s.execute("BEGIN")
        txn_id = s.txn.txn_id
        s.execute("INSERT INTO u VALUES (7, 'seven')")
        s.execute("UPDATE t SET val = 'x' WHERE id = 2")
        s.execute("DELETE FROM t WHERE id = 3")
        s.execute("COMMIT")
        state = inst.metadb.tx_log_get(txn_id)
        s.execute("BEGIN")
        s.execute("INSERT INTO u VALUES (8, 'gone')")
        s.execute("ROLLBACK")
        events = inst.cdc.events()
        commit_ts = {e[1] for e in events[-4:]}
        assert commit_ts == {state[1]} and state[0] == "DONE"
        return _norm(events), state[0]
    _both(scenario)


def test_xa_commit_with_a_failed_participant_still_logs(monkeypatch):
    """A participant that fails after the commit point: COMMIT raises
    `TransactionError` carrying `commit_ts`, and the binlog records the
    transaction at that timestamp all the same."""
    def scenario(eng):
        inst, s = _session(eng)
        s.execute(XA_DDL2)
        s.execute("SET TRANSACTION_POLICY = 'XA'")
        s.execute("BEGIN")
        txn_id = s.txn.txn_id
        s.execute("INSERT INTO t VALUES (5, 5, 'e')")
        s.execute("INSERT INTO u VALUES (9, 'nine')")
        real = eng.xa.StoreParticipant.commit

        def commit(sp, commit_ts):
            if sp.store.table.name == "u":
                raise RuntimeError("participant lost")
            return real(sp, commit_ts)
        monkeypatch.setattr(eng.xa.StoreParticipant, "commit", commit)
        try:
            with pytest.raises(eng.errors.TransactionError) as ei:
                s.execute("COMMIT")
        finally:
            monkeypatch.setattr(eng.xa.StoreParticipant, "commit", real)
        cts = ei.value.commit_ts
        events = inst.cdc.events()
        assert [e[1] for e in events] == [cts, cts]
        return _norm(events), inst.metadb.tx_log_get(txn_id) == ("COMMITTED", cts)
    assert _both(scenario)[1]


# -- COM_BINLOG_DUMP ----------------------------------------------------------------

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
def port_server():
    served = _Served(MySQLServer(Instance(device="cpu"), port=0,
                                 users={"root": ""}, pool_size=8))
    yield served
    served.stop()


@pytest.mark.parametrize("client", [jax_client, port_client],
                         ids=["ref_client", "port_client"])
def test_binlog_dump_streams_changes(port_server, client):
    """`TestBinlogDump.test_stream_changes` against the port's server."""
    c = client.MiniClient("127.0.0.1", port_server.port, timeout=20.0)
    try:
        db = f"bl_{client.__name__.split('.')[0]}"
        c.query(f"CREATE DATABASE IF NOT EXISTS {db}")
        c.query(f"USE {db}")
        c.query("CREATE TABLE ev (id INT, v VARCHAR(10))")
        c.query("INSERT INTO ev VALUES (1, 'a'), (2, 'b')")
        c.query("DELETE FROM ev WHERE id = 1")
        events = c.binlog_dump(0)
        mine = [e for e in events if e["schema"] == db and e["table"] == "ev"]
        assert [e["kind"] for e in mine] == ["insert", "delete"]
        assert json.loads(mine[1]["payload"]) == {"columns": ["id", "v"],
                                                   "rows": [[1, "a"]]}
        last = max(e["seq"] for e in events)
        assert c.binlog_dump(last) == []  # resumed at the watermark: nothing new
        c.query("INSERT INTO ev VALUES (3, 'c')")
        tail = c.binlog_dump(last)
        assert [(e["table"], e["kind"]) for e in tail] == [("ev", "insert")]
        # the stream is the log: the same events as the instance's reader
        inst = port_server.server.instance
        assert [tuple(e[k] for k in ("seq", "commit_ts", "schema", "table", "kind",
                                     "payload")) for e in c.binlog_dump(0)] == \
            [tuple(r) for r in inst.cdc.events_after_seq(0)]
    finally:
        c.close()


# -- replay across the packages ------------------------------------------------------

TYPES_DDL = ("CREATE TABLE ty (id BIGINT PRIMARY KEY, amt DECIMAL(12,2), d DATE, "
             "name VARCHAR(20), note VARCHAR(30)) PARTITION BY HASH(id) PARTITIONS 3")
TYPES_SCRIPT = [
    "INSERT INTO ty VALUES (1, 12.50, '2024-01-05', 'ann', NULL), "
    "(2, -3.10, NULL, NULL, 'x'), (3, 0.00, '1995-03-15', 'cy', 'y'), "
    "(4, 99999.99, '2000-02-29', 'dee', NULL)",
    "UPDATE ty SET amt = 7.25, d = DATE '2025-12-31' WHERE id = 2",
    "UPDATE ty SET name = 'new', note = NULL WHERE id = 3",
    "DELETE FROM ty WHERE id = 1",
    "BEGIN",
    "INSERT INTO ty VALUES (5, NULL, '1970-01-01', 'eve', 'z')",
    "UPDATE ty SET amt = amt + 1 WHERE id = 4",
    "COMMIT",
    "INSERT INTO ty VALUES (6, 1.01, NULL, 'fay', NULL)",
    "DELETE FROM ty WHERE id = 6",
]


def test_payloads_equal_and_cross_replay_of_types():
    """DECIMAL, DATE, VARCHAR and NULL: the two engines' binlogs are equal byte for
    byte, and each replays onto the other package's instance to the source's
    rows."""
    sources = {}
    for eng in (JAX, PORT):
        inst, s = _session(eng, TYPES_DDL, "tyd")
        for sql in TYPES_SCRIPT:
            s.execute(sql)
        sources[eng.name] = inst
    jevents, pevents = sources["jax"].cdc.events(), sources["port"].cdc.events()
    assert _norm(pevents) == _norm(jevents)
    for events, src, eng in ((jevents, sources["jax"], PORT),
                             (pevents, sources["port"], JAX)):
        target, _ts = _session(eng, TYPES_DDL, "tyd")
        assert eng.cdc.replay(events, target) == len(events)
        assert _visible(target, "tyd", "ty") == _visible(src, "tyd", "ty")


@pytest.fixture(scope="module")
def tpch_data():
    return tpch.generate(0.01)


def _tpch_pair(data):
    """A JAX instance loaded with `data` and a port instance with its lanes."""
    ji, pi = JaxInstance(), Instance(device="cpu")
    js, ps = JaxSession(ji), Session(pi)
    for s in (js, ps):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    for t in ("orders", "lineitem"):
        js.execute(tpch.TPCH_DDL[t])
        ji.store("tpch", t).insert_pylists(data[t], ji.tso.next_timestamp())
        ps.execute(tpch.TPCH_DDL[t])
        parts, dicts = transfer.arrays_of(ji.store("tpch", t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table("tpch", t),
                                                    parts, dicts))
    return ji, js, pi, ps


def test_tpch_refresh_pair_replays_across_packages(tpch_data):
    """RF1 (autocommit multi-row INSERTs) and RF2 (a transaction of DELETE ... IN)
    at SF 0.01 on each engine; each engine's binlog replays onto a copy of the
    other package's instance from before the refresh and gives the source's rows.
    orders matches on its key index in the port, lineitem (composite key) by the
    loop."""
    ji, js, pi, ps = _tpch_pair(tpch_data)
    keys = np.concatenate([p.lanes["o_orderkey"]
                           for p in pi.store("tpch", "orders").partitions])
    rf1 = tpch_refresh.rf1_statements(
        tpch_refresh.rf1_rows(0.01, int(keys.max())), rows_per_statement=20)
    rf2 = tpch_refresh.rf2_statements(tpch_refresh.rf2_keys(0.01, keys))
    jt, _s, pt, _s2 = _tpch_pair(tpch_data)  # the replicas, from before the refresh
    for s in (js, ps):
        for sql in rf1:
            s.execute(sql)
        s.execute("BEGIN")
        for sql in rf2:
            s.execute(sql)
        s.execute("COMMIT")
    jevents, pevents = ji.cdc.events(), pi.cdc.events()
    assert _norm(pevents) == _norm(jevents)
    assert cdc.replay(jevents, pt) == len(jevents)
    assert jax_cdc.replay(pevents, jt) == len(pevents)
    for t in ("orders", "lineitem"):
        want = _visible(ji, "tpch", t)
        assert _visible(pi, "tpch", t) == want
        assert _visible(pt, "tpch", t) == want
        assert _visible(jt, "tpch", t) == want


# -- _replay_delete: the key index against the reference's loop -------------------------

# (DDL, a row's VALUES, the event's columns, a row image, the rows deleted first)
PK_CASES = {
    "int_pk": ("CREATE TABLE r (id BIGINT PRIMARY KEY, v VARCHAR(8)) "
               "PARTITION BY HASH(id) PARTITIONS 4",
               lambda i: f"({i}, 'v{i % 5}')", ["id", "v"], lambda i: [i, f"v{i % 5}"],
               "id >= 50"),
    "string_pk": ("CREATE TABLE r (code VARCHAR(12) PRIMARY KEY, n BIGINT) "
                  "PARTITION BY HASH(code) PARTITIONS 4",
                  lambda i: f"('k{i}', {i})", ["code", "n"], lambda i: [f"k{i}", i],
                  "n >= 50"),
    "decimal_pk": ("CREATE TABLE r (amt DECIMAL(10,2) PRIMARY KEY, n BIGINT) SINGLE",
                   lambda i: f"({i}.25, {i})", ["amt", "n"], lambda i: [i + 0.25, i],
                   "n >= 50"),
    "composite_pk": ("CREATE TABLE r (a BIGINT, b BIGINT, n BIGINT, "
                     "PRIMARY KEY (a, b)) PARTITION BY HASH(a) PARTITIONS 2",
                     lambda i: f"({i % 7}, {i}, {i})", ["a", "b", "n"],
                     lambda i: [i % 7, i, i], "n >= 50"),
    "no_pk": ("CREATE TABLE r (a BIGINT, v VARCHAR(8)) "
              "PARTITION BY HASH(a) PARTITIONS 2",
              lambda i: f"({i % 9}, 'v{i % 4}')", ["a", "v"],
              lambda i: [i % 9, f"v{i % 4}"], "a = 8"),
}


@pytest.mark.parametrize("case", sorted(PK_CASES))
def test_replay_delete_matches_the_reference_loop(case, monkeypatch):
    """The same target (rows, deleted rows, rows inserted after the event's commit
    timestamp, keys absent from it) and the same delete event: the port's
    `_replay_delete` stamps exactly the rows the reference's stamps.  The single-key
    cases take the key index; the composite and key-less ones the loop."""
    ddl, row_sql, cols, image, gone = PK_CASES[case]
    taken = []
    real = cdc._delete_by_key_index
    monkeypatch.setattr(cdc, "_delete_by_key_index",
                        lambda *a: taken.append(real(*a)) or taken[-1])

    def scenario(eng):
        inst, s = _session(eng, ddl, "rd")
        s.execute("INSERT INTO r VALUES " + ", ".join(row_sql(i) for i in range(60)))
        s.execute(f"DELETE FROM r WHERE {gone}")
        commit_ts = inst.tso.next_timestamp()
        s.execute("INSERT INTO r VALUES " + ", ".join(row_sql(i)
                                                      for i in range(100, 110)))
        tm, store = inst.catalog.table("rd", "r"), inst.store("rd", "r")
        wanted = [image(i) for i in (0, 3, 17, 33, 49, 55, 104, 500)]
        eng.cdc._replay_delete(tm, store, {"columns": cols, "rows": wanted},
                               commit_ts)
        return [sorted(np.nonzero(np.asarray(p.end_ts) == commit_ts)[0].tolist())
                for p in store.partitions]
    deleted = _both(scenario)
    assert sum(map(len, deleted)) > 0
    assert taken == ([True] if case in ("int_pk", "string_pk", "decimal_pk") else [])
