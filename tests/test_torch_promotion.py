"""Integer promotion, BIGINT UNSIGNED and the session-scoped batch-scheduler switch,
through the JAX package's `Session` and the port's `Session(Instance(device="cpu"))`.

The same statements run in both engines over a table whose TINYINT, SMALLINT and INT
columns sit at their limits and whose BIGINT UNSIGNED column holds values above 2**63.
Rows must be equal, or both engines must raise the same error class.

- Narrow integer columns against out-of-range literals compute in the common type, as
  numpy promotion does in the reference (a 0-dim torch literal would otherwise lose to
  the column's lane and wrap).  Column-against-column arithmetic still wraps at the
  lane width, in both packages.
- BIGINT UNSIGNED lanes compute on their int64 bits in the port: comparisons (exact
  against signed values too), MIN/MAX in unsigned order, `+ - *` with wrapping between
  unsigned operands and float64 against signed ones, CAST, GROUP BY, DISTINCT, IN and
  equi-joins; ORDER BY and AVG treat the bits as the reference does.
- `SET ENABLE_BATCH_SCHEDULER = 0` in one session keeps that session's point selects
  off the cross-session scheduler, and only that session's."""

import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

SETUP = [
    "CREATE DATABASE d", "USE d",
    "CREATE TABLE t (id BIGINT PRIMARY KEY, a INT, u TINYINT, sm SMALLINT, "
    "ub BIGINT UNSIGNED) PARTITION BY HASH(id) PARTITIONS 2",
    "INSERT INTO t VALUES (1, 2000000000, 127, 30000, 18446744073709551000), "
    "(2, 2, -128, -32768, 9223372036854775808), (3, -5, 0, 7, 100), "
    "(4, -2147483648, 5, 32767, 0), (5, 2147483647, -1, 1, 18446744073709551615)",
    "CREATE TABLE w (k BIGINT UNSIGNED, tag VARCHAR(8))",
    "INSERT INTO w VALUES (18446744073709551000, 'hi'), (100, 'lo'), "
    "(9223372036854775808, 'mid'), (7, 'none')",
]

# ROADMAP Queue 3 item 7: narrow integer columns against literals
PROMOTION = [
    "SELECT id, a * 10 FROM t ORDER BY id",
    "SELECT id, sm + 30000 FROM t ORDER BY id",
    "SELECT id, u + 1 FROM t ORDER BY id",
    "SELECT id FROM t WHERE a > 3000000000 ORDER BY id",
    "SELECT id FROM t WHERE a = 4294967298 ORDER BY id",
    "SELECT id FROM t WHERE a < -3000000000 ORDER BY id",
    "SELECT id FROM t WHERE u < 300 ORDER BY id",
    "SELECT id FROM t WHERE sm >= 40000 ORDER BY id",
    "SELECT id, GREATEST(u, 1000), LEAST(sm, -40000) FROM t ORDER BY id",
    "SELECT id, CASE WHEN u > 0 THEN u + 1 ELSE 1000 END FROM t ORDER BY id",
    "SELECT id, CASE WHEN u > 0 THEN u ELSE 1000 END FROM t ORDER BY id",
    "SELECT id, COALESCE(u, 1000), IF(u > 0, sm, 100000) FROM t ORDER BY id",
    "SELECT u + 1 AS x, count(*) FROM t GROUP BY u + 1 ORDER BY x",
    "SELECT sum(u + 1), max(a * 2), min(sm - 40000) FROM t",
    "SELECT id, a * 10 - a FROM t WHERE a * 10 > 5 ORDER BY id",
    "SELECT id, u * sm, a + a, -u FROM t ORDER BY id",
    "SELECT id, a % 7, u % 3, sm % 1000 FROM t ORDER BY id",
    "SELECT id, u % 1000, sm % 70000, a % -3000000000 FROM t ORDER BY id",
    "SELECT id, (a + a) * a, (a + a) + 1, (u + u) * 3 FROM t ORDER BY id",
    "SELECT id, CASE WHEN id > 2 THEN a + a ELSE u END, LEAST(u, sm), "
    "COALESCE(u, sm) FROM t ORDER BY id",
]

# ROADMAP Queue 3 item 8: BIGINT UNSIGNED
UNSIGNED = [
    "SELECT id, ub FROM t ORDER BY id",
    "SELECT id FROM t WHERE ub > 100 ORDER BY id",
    "SELECT id FROM t WHERE ub > 9223372036854775807 ORDER BY id",
    "SELECT id FROM t WHERE ub >= 18446744073709551000 ORDER BY id",
    "SELECT id FROM t WHERE ub < -1 OR -1 < ub ORDER BY id",
    "SELECT id FROM t WHERE ub BETWEEN 50 AND 9223372036854775808 ORDER BY id",
    "SELECT id FROM t WHERE ub IN (100, 18446744073709551000, 0) ORDER BY id",
    "SELECT id FROM t WHERE ub > a ORDER BY id",
    "SELECT id FROM t ORDER BY ub, id",
    "SELECT id FROM t ORDER BY ub DESC, id",
    "SELECT max(ub), min(ub), sum(ub), count(ub) FROM t",
    "SELECT avg(ub) FROM t WHERE id < 4",
    "SELECT u > 0 AS pos, max(ub), min(ub) FROM t GROUP BY u > 0 ORDER BY pos",
    "SELECT id, ub + 1, ub - 200, ub * 2 FROM t ORDER BY id",
    "SELECT id, ub + ub, ub % 7, ub % CAST(7 AS UNSIGNED), ub / 2 FROM t ORDER BY id",
    "SELECT id, CAST(a AS UNSIGNED), CAST(-1 AS UNSIGNED), CAST(ub AS SIGNED) "
    "FROM t ORDER BY id",
    "SELECT id, CAST(ub AS DOUBLE), ABS(ub) FROM t ORDER BY id",
    "SELECT id, GREATEST(ub, 5), LEAST(ub, CAST(7 AS UNSIGNED)), COALESCE(ub, 5) "
    "FROM t ORDER BY id",
    "SELECT id, CASE WHEN id > 1 THEN ub ELSE 7 END FROM t ORDER BY id",
    "SELECT ub, count(*) FROM t GROUP BY ub ORDER BY ub",
    "SELECT DISTINCT ub FROM t ORDER BY ub",
    "SELECT t.id, w.tag FROM t JOIN w ON t.ub = w.k ORDER BY t.id",
    "SELECT id, max(ub) OVER (ORDER BY id), min(ub) OVER (ORDER BY id) FROM t "
    "ORDER BY id",
    "SELECT max(ub + 1) FROM t",
]


def _run(session, sql, err_mod):
    try:
        return session.execute(sql).rows
    except err_mod.TddlError as e:
        return type(e).__name__
    except (NotImplementedError, RuntimeError, KeyError, ValueError) as e:
        return f"raised {type(e).__name__}"


@pytest.fixture(scope="module")
def engines():
    js, ps = JaxSession(JaxInstance()), Session(Instance(device="cpu"))
    for sql in SETUP:
        js.execute(sql)
        ps.execute(sql)
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("sql", PROMOTION)
def test_integer_promotion_against_literals(engines, sql):
    js, ps = engines
    want = _run(js, sql, jax_errors)
    assert not isinstance(want, str), want
    assert _run(ps, sql, errors) == want


@pytest.mark.parametrize("sql", UNSIGNED)
def test_bigint_unsigned(engines, sql):
    js, ps = engines
    want = _run(js, sql, jax_errors)
    assert not isinstance(want, str), want
    assert _run(ps, sql, errors) == want


def test_the_re_anchor_table_gives_the_reference_answers(engines):
    """The rows of ROADMAP Queue 3 items 7 and 8 that raised or differed."""
    js, ps = engines
    for sql, want in [
            ("SELECT a * 10 FROM t WHERE id = 1", [(20000000000,)]),
            ("SELECT u + 1 FROM t WHERE id = 1", [(128,)]),
            ("SELECT id FROM t WHERE a > 3000000000", []),
            ("SELECT GREATEST(u, 1000) FROM t WHERE id = 1", [(1000,)]),
            ("SELECT id FROM t WHERE ub > 100 ORDER BY id", [(1,), (2,), (5,)]),
            ("SELECT max(ub), min(ub) FROM t", [(18446744073709551615, 0)]),
            ("SELECT CAST(a AS UNSIGNED) FROM t WHERE id = 1", [(2000000000,)]),
            ("SELECT id FROM t AS OF TSO 1", [])]:
        assert js.execute(sql).rows == want
        assert ps.execute(sql).rows == want


@pytest.mark.parametrize("route", ["sequential", "device"])
def test_unsigned_point_keys(route):
    """A BIGINT UNSIGNED key above 2**63 through the point path: the host key-get
    and the batched lookup's torch program (its sorted keys in signed order)."""
    import numpy as np

    from galaxysql_tpu_torch.exec.device_cache import DeviceCache
    from galaxysql_tpu_torch.exec.operators import batched_point_lookup
    inst = Instance(device="cpu")
    s = Session(inst)
    for sql in ("CREATE DATABASE d", "USE d",
                "CREATE TABLE k (id BIGINT UNSIGNED PRIMARY KEY, v INT)",
                "INSERT INTO k VALUES (18446744073709551000, 1), (5, 2), "
                "(9223372036854775808, 3), (9223372036854775807, 4)"):
        s.execute(sql)
    keys = [18446744073709551000, 9223372036854775808, 5, 42]
    if route == "sequential":
        for _ in range(2):  # the first run registers the PointPlan
            got = [s.execute(f"SELECT v FROM k WHERE id = {key}").rows for key in keys]
        assert got == [[(1,)], [(3,)], [(2,)], []]
        assert inst.counters["point_plan_queries"] >= len(keys)
        return
    store = inst.store("d", "k")
    cache = DeviceCache("cpu")
    snap = inst.tso.next_timestamp()
    found = {}
    for pid, part in enumerate(store.partitions):
        lane_vals = np.array(keys, dtype=np.uint64)
        ids, off = batched_point_lookup(store, pid, part, "id", store.table.version,
                                        lane_vals, snap, 0, device_cache=cache,
                                        force_device=True)
        for i, key in enumerate(keys):
            rows = ids[off[i]:off[i + 1]]
            found.setdefault(key, []).extend(part.lanes["v"][rows].tolist())
    assert found == {18446744073709551000: [1], 9223372036854775808: [3], 5: [2],
                     42: []}


def test_session_scoped_batch_scheduler_switch(monkeypatch):
    """ROADMAP Queue 3 item 9: after `SET ENABLE_BATCH_SCHEDULER = 0` in one session
    its point selects never reach the scheduler; another session's still do."""
    calls = {}
    for name, inst, Sess in (("ref", JaxInstance(), JaxSession),
                             ("port", Instance(device="cpu"), Session)):
        seen = []

        def submit(*args, _seen=seen, **kwargs):
            _seen.append(args[2])  # the key value
            return None  # the sequential path serves the statement

        monkeypatch.setattr(inst.batch_scheduler, "submit", submit)
        a, b = Sess(inst), Sess(inst)
        for sql in ("CREATE DATABASE d", "USE d",
                    "CREATE TABLE p (id BIGINT PRIMARY KEY, v INT)",
                    "INSERT INTO p VALUES (1, 10), (2, 20), (3, 30)"):
            a.execute(sql)
        b.execute("USE d")
        a.execute("SELECT v FROM p WHERE id = 1")  # registers the PointPlan
        a.execute("SET ENABLE_BATCH_SCHEDULER = 0")
        rows = [a.execute("SELECT v FROM p WHERE id = 2").rows,
                b.execute("SELECT v FROM p WHERE id = 3").rows,
                a.execute("SELECT v FROM p WHERE id = 1").rows]
        calls[name] = (rows, list(seen))
    assert calls["port"] == calls["ref"]
    assert calls["port"] == ([[(20,)], [(30,)], [(10,)]], [3])
