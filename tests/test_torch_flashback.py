"""Flashback reads (`SELECT ... FROM t AS OF TSO n`) through the JAX package and the
port on the CPU: the reference's `tests/test_flashback_locks.py::TestFlashback`,
each case run through both packages, whose rows must be equal.  An AS OF scan reads at
n with no transaction's provisional rows (also inside a transaction with its own
writes), on the fused batch and on the streamed per-partition batches past
`FUSE_MAX_ROWS`; the binder refuses AS OF on a view or a CTE."""

import types

import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.plan import physical
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.utils import errors
from test_torch_dml import ap_plans

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", new=JaxInstance, Session=JaxSession,
                            errors=jax_errors)
PORT = types.SimpleNamespace(name="port", new=lambda: Instance(device="cpu"),
                             Session=Session, errors=errors)


def _same(scenario):
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


def _session(pkg):
    s = pkg.Session(pkg.new())
    s.execute("CREATE DATABASE f")
    s.execute("USE f")
    return s


def test_as_of_returns_old_snapshot():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
        ts1 = s.instance.tso.next_timestamp()
        s.execute("UPDATE t SET v = 99 WHERE id = 1")
        s.execute("DELETE FROM t WHERE id = 2")
        s.execute("INSERT INTO t VALUES (3, 30)")
        now = s.execute("SELECT id, v FROM t ORDER BY id").rows
        old = s.execute(f"SELECT id, v FROM t AS OF TSO {ts1} ORDER BY id").rows
        assert now == [(1, 99), (3, 30)] and old == [(1, 10), (2, 20)]
        agg = s.execute(f"SELECT count(*), sum(v) FROM t AS OF TSO {ts1}").rows
        both = s.execute(f"SELECT a.id, a.v, b.v FROM t AS OF TSO {ts1} a "
                         "JOIN t b ON a.id = b.id ORDER BY a.id").rows
        return now, old, agg, both
    _same(scenario)


def test_as_of_with_alias_and_filter():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("CREATE TABLE u (id BIGINT, v VARCHAR(8))")
        s.execute("INSERT INTO u VALUES (1, 'old')")
        ts1 = s.instance.tso.next_timestamp()
        s.execute("UPDATE u SET v = 'new' WHERE id = 1")
        old = s.execute(f"SELECT x.v FROM u AS OF TSO {ts1} x WHERE x.id = 1").rows
        assert old == [("old",)]
        assert s.execute("SELECT v FROM u").rows == [("new",)]
        return old
    _same(scenario)


def test_as_of_ignores_own_txn_writes():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("CREATE TABLE w (id BIGINT PRIMARY KEY)")
        s.execute("INSERT INTO w VALUES (1), (5)")
        ts1 = s.instance.tso.next_timestamp()
        s.execute("BEGIN")
        s.execute("INSERT INTO w VALUES (2)")
        s.execute("DELETE FROM w WHERE id = 5")
        own = sorted(s.execute("SELECT id FROM w").rows)
        old = sorted(s.execute(f"SELECT id FROM w AS OF TSO {ts1}").rows)
        point = s.execute(f"SELECT id FROM w AS OF TSO {ts1} WHERE id = 5").rows
        assert own == [(1,), (2,)] and old == [(1,), (5,)] and point == [(5,)]
        s.execute("ROLLBACK")
        return own, old, point
    _same(scenario)


def test_as_of_on_view_or_cte_refuses():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("CREATE TABLE vt (id BIGINT)")
        s.execute("CREATE VIEW vv AS SELECT id FROM vt")
        out = []
        for sql in ("SELECT * FROM vv AS OF TSO 5",
                    "WITH c AS (SELECT id FROM vt) SELECT * FROM c AS OF TSO 5"):
            with pytest.raises(pkg.errors.NotSupportedError) as e:
                s.execute(sql)
            out.append(str(e.value))
        return out
    _same(scenario)


def test_as_of_on_streamed_partitions(monkeypatch):
    """Past FUSE_MAX_ROWS a full scan streams one batch a partition; each honours
    the AS OF snapshot as the fused batch does."""
    monkeypatch.setattr(physical, "FUSE_MAX_ROWS", 10)
    ap_plans(monkeypatch)

    def scenario(pkg):
        s = _session(pkg)
        s.execute("CREATE TABLE big (id BIGINT PRIMARY KEY, v BIGINT) "
                  "PARTITION BY HASH(id) PARTITIONS 4")
        s.execute("INSERT INTO big VALUES " + ",".join(f"({i}, {i})" for i in range(60)))
        ts1 = s.instance.tso.next_timestamp()
        s.execute("DELETE FROM big WHERE id < 20")
        s.execute("UPDATE big SET v = -v WHERE id >= 50")
        s.execute("BEGIN")
        s.execute("INSERT INTO big VALUES (100, 100)")
        q = f"SELECT count(*), sum(v), min(id) FROM big AS OF TSO {ts1}"
        old = s.execute(q).rows
        now = s.execute("SELECT count(*), sum(v), min(id) FROM big").rows
        trace = s.last_trace if pkg is PORT else None
        s.execute("ROLLBACK")
        assert old == [(60, 1770, 0)] and now == [(41, 590, 20)]
        if trace is not None:
            assert any("streamed batches=4" in t for t in trace)
        return old, now
    _same(scenario)
