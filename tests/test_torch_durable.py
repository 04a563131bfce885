"""Durable state and two-phase commit: the port against the JAX package on the CPU.

Every scenario runs the same statements through the JAX package's
`Instance(data_dir=...)` and the port's `Instance(data_dir=..., device="cpu")`, each in
a directory of its own under `tmp_path`, and returns what a user or an operator can
observe: result rows, the transaction log's states, recovery outcomes and every
partition's lanes, validity, dictionaries and stamp classes (a commit timestamp as
its rank among the schema's stamps; the engines draw different TSO values).  The two
engines' observations must be equal.  The JAX package boots with its compile cache
off (`ENABLE_COMPILE_CACHE`), which only decides whether it keeps compiled XLA
programs under the directory.

The scenarios: the reference's own tests of rollback stamping, boot recovery, XA, a
restart, a DDL job resumed across a boot, views and plan baselines across a boot; the
store's files; a TPC-H SF 0.01 data directory written by each package and booted by
the other, with a view, a covering GSI, a recycle-bin entry and transactions in doubt
of both kinds; the group-commit gate under concurrent committers and with its batch
write failing; and cached device lanes after an in-process recovery.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.txn import xa as jax_xa
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu.utils.failpoint import FAIL_POINTS as JAX_FAIL_POINTS
from galaxysql_tpu.utils.failpoint import FailPointError as JaxFailPointError
from galaxysql_tpu_torch.net.client import MiniClient
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import tpch_refresh, transfer
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.txn import xa
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_BEFORE_COMMIT,
                                                 FailPointError)
from test_torch_ddl import _catalog, _norm
from test_torch_dml import ap_plans

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREAD_SECONDS = 60  # every committer thread must end within this


def _jax_instance(data_dir=None):
    ji = JaxInstance(data_dir=data_dir, boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


JAX = types.SimpleNamespace(
    name="jax", instance=_jax_instance, Session=JaxSession, xa=jax_xa,
    fail_points=JAX_FAIL_POINTS, FailPointError=JaxFailPointError, errors=jax_errors)
PORT = types.SimpleNamespace(
    name="port", instance=lambda d=None: Instance(data_dir=d, device="cpu"),
    Session=Session, xa=xa, fail_points=FAIL_POINTS, FailPointError=FailPointError,
    errors=errors)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    FAIL_POINTS.clear()
    JAX_FAIL_POINTS.clear()


def _both(scenario, tmp_path):
    """`scenario(engine, directory)` through both engines; their observations must
    be equal.  Returns the port's."""
    want = scenario(JAX, str(tmp_path / "jax"))
    got = scenario(PORT, str(tmp_path / "port"))
    assert got == want
    return got


def _ranks(inst, schema):
    values = set()
    for key, store in inst.stores.items():
        if key.startswith(schema + "."):
            for p in store.partitions:
                for a in (p.begin_ts, p.end_ts):
                    a = np.abs(np.asarray(a))
                    values.update(a[(a != 0) & (a != INFINITY_TS)].tolist())
    return {v: i for i, v in enumerate(sorted(values))}


def _stamp(v, ranks):
    if v == INFINITY_TS:
        return "inf"
    if v == 0:
        return "dead"
    return ("provisional" if v < 0 else "committed", ranks[abs(v)])


def _state(inst, schema):
    """Every store of `schema`: dictionaries, and per partition its lanes and validity
    (bytes) and stamp classes."""
    ranks = _ranks(inst, schema)
    out = {}
    for key, store in sorted(inst.stores.items()):
        if not key.startswith(schema + "."):
            continue
        parts, dicts = transfer.arrays_of(store)
        out[_norm(key)] = (dicts, [
            ({c: (a.dtype.str, a.tobytes()) for c, a in p["lanes"].items()},
             {c: a.tobytes() for c, a in p["valid"].items()},
             [_stamp(v, ranks) for v in p["begin_ts"].tolist()],
             [_stamp(v, ranks) for v in p["end_ts"].tolist()]) for p in parts])
    return out


def _tx_state(inst, txn_id, schema):
    """A transaction's tx-log state, its commit timestamp as a stamp class."""
    got = inst.metadb.tx_log_get(txn_id)
    if got is None:
        return None
    return got[0], (_stamp(got[1], _ranks(inst, schema)) if got[1] else 0)


def _session(eng, inst, schema=None):
    s = eng.Session(inst)
    if schema:
        s.execute(f"USE {schema}")
    return s


# -- the reference's tests/test_txn_recovery.py TestRollbackStamping -------------------

def _table_t(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE x; USE x")
    s.execute("CREATE TABLE t (id BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 1")
    return inst, s


def _rollback_preserves_concurrent_committed_insert(eng, d):
    inst, a = _table_t(eng, d)
    b = _session(eng, inst, "x")
    a.execute("BEGIN")
    a.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    b.execute("INSERT INTO t VALUES (3, 30)")
    a.execute("ROLLBACK")
    rows = b.execute("SELECT id, v FROM t").rows
    assert rows == [(3, 30)]
    p = inst.store("x", "t").partitions[0]
    assert p.num_rows == 3 and not p.visible_mask(None)[:2].any()
    return rows, _state(inst, "x")


def _rollback_then_xa_commit_of_survivor(eng, d):
    inst, a = _table_t(eng, d)
    b = _session(eng, inst, "x")
    b.execute("SET TRANSACTION_POLICY = 'XA'")
    a.execute("BEGIN")
    a.execute("INSERT INTO t VALUES (1, 10)")
    b.execute("BEGIN")
    b.execute("INSERT INTO t VALUES (2, 20)")
    txn_id = b.txn.txn_id
    a.execute("ROLLBACK")
    b.execute("COMMIT")
    rows = sorted(a.execute("SELECT id FROM t").rows)
    assert rows == [(2,)]
    return rows, _tx_state(inst, txn_id, "x"), _state(inst, "x")


def _insert_then_delete_rollback_invisible_everywhere(eng, d):
    inst, a = _table_t(eng, d)
    a.execute("BEGIN")
    a.execute("INSERT INTO t VALUES (7, 70)")
    a.execute("DELETE FROM t WHERE id = 7")
    a.execute("ROLLBACK")
    assert not inst.store("x", "t").partitions[0].visible_mask(None).any()
    return a.execute("SELECT count(*) FROM t").rows, _state(inst, "x")


@pytest.mark.parametrize("scenario", [
    _rollback_preserves_concurrent_committed_insert,
    _rollback_then_xa_commit_of_survivor,
    _insert_then_delete_rollback_invisible_everywhere,
], ids=lambda f: f.__name__.strip("_"))
def test_rollback_stamping(scenario, tmp_path):
    _both(scenario, tmp_path)


# -- the reference's tests/test_txn_recovery.py TestBootRecovery -----------------------

def _no_log(inst, txn_id):
    return None


def _logged_commit_point(inst, txn_id):
    # the coordinator logged the commit point and crashed before stamping
    commit_ts = inst.tso.next_timestamp()
    inst.metadb.tx_log_put(txn_id, "COMMITTED", commit_ts)
    return commit_ts


def _prepared_only(inst, txn_id):
    inst.metadb.tx_log_put(txn_id, "PREPARED")


def _boot_cycle(mutate):
    def scenario(eng, d):
        ia, s = _table_t(eng, d)
        s.execute("INSERT INTO t VALUES (1, 10)")
        s.execute("BEGIN")
        s.execute("INSERT INTO t VALUES (2, 20)")
        txn_id = s.txn.txn_id
        commit_ts = mutate(ia, txn_id)
        ia.save()  # the crash: partitions persisted with the provisional stamps
        s.txn = None
        ib = eng.instance(d)
        s = _session(eng, ib, "x")
        rows = sorted(s.execute("SELECT id FROM t").rows)
        state = ib.metadb.tx_log_get(txn_id)
        if commit_ts is None:
            assert rows == [(1,)]
        else:
            assert rows == [(1,), (2,)] and state == ("DONE", commit_ts)
        p = ib.store("x", "t").partitions[0]
        assert not (p.begin_ts < 0).any() and not (p.end_ts < 0).any()
        return rows, _tx_state(ib, txn_id, "x"), _state(ib, "x")
    return scenario


@pytest.mark.parametrize("mutate", [_no_log, _logged_commit_point, _prepared_only],
                         ids=["orphaned_uncommitted_stamps_roll_back",
                              "logged_commit_point_reapplies_on_boot",
                              "prepared_without_commit_point_rolls_back"])
def test_boot_recovery(mutate, tmp_path):
    got = _both(_boot_cycle(mutate), tmp_path)
    assert got[1][0] == ("ABORTED" if mutate is not _logged_commit_point else "DONE")


# -- the reference's tests/test_xa.py --------------------------------------------------

def _xa_tables(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE x; USE x")
    s.execute("SET TRANSACTION_POLICY = 'XA'")
    s.execute("CREATE TABLE a (id BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 2")
    s.execute("CREATE TABLE b (id BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 2")
    s.execute("INSERT INTO a VALUES (1, 10); INSERT INTO b VALUES (1, 100)")
    return inst, s


def _xa_two_store_commit(eng, d):
    inst, s = _xa_tables(eng, d)
    s.execute("BEGIN")
    s.execute("UPDATE a SET v = 11 WHERE id = 1")
    s.execute("INSERT INTO b VALUES (2, 200)")
    txn_id = s.txn.txn_id
    s.execute("COMMIT")
    s2 = _session(eng, inst, "x")
    rows = [s2.execute("SELECT v FROM a WHERE id = 1").rows,
            s2.execute("SELECT count(*) FROM b").rows]
    assert rows == [[(11,)], [(2,)]]
    assert inst.metadb.tx_log_get(txn_id) == ("DONE", s._last_commit_ts)
    return rows, _tx_state(inst, txn_id, "x"), _state(inst, "x")


def _xa_crash_before_commit_point_rolls_back(eng, d):
    inst, s = _xa_tables(eng, d)
    s.execute("BEGIN")
    s.execute("INSERT INTO a VALUES (5, 50)")
    s.execute("DELETE FROM b WHERE id = 1")
    txn_id = s.txn.txn_id
    eng.fail_points.arm(FP_BEFORE_COMMIT)
    with pytest.raises(eng.FailPointError):
        s.execute("COMMIT")
    eng.fail_points.clear()
    in_doubt = _tx_state(inst, txn_id, "x")
    resolved = inst.xa_coordinator.recover()
    assert list(resolved.values()) == ["rolled_back"]
    s2 = _session(eng, inst, "x")
    rows = [s2.execute("SELECT count(*) FROM a").rows,
            s2.execute("SELECT count(*) FROM b").rows]
    assert rows == [[(1,)], [(1,)]]
    return in_doubt, resolved == {txn_id: "rolled_back"}, rows, \
        _tx_state(inst, txn_id, "x"), _state(inst, "x")


def _xa_recovery_after_commit_point_commits(eng, d):
    inst, s = _xa_tables(eng, d)
    s.execute("BEGIN")
    s.execute("INSERT INTO a VALUES (7, 70)")
    txn = s.txn
    parts = eng.xa.participants_of(txn)
    assert all(sp.prepare() for sp in parts)
    inst.metadb.tx_log_put(txn.txn_id, "PREPARED")
    inst.metadb.tx_log_put(txn.txn_id, "COMMITTED", inst.tso.next_timestamp())
    # the coordinator dies here: the session forgets, recovery owns the outcome
    inst.xa_coordinator._in_doubt[txn.txn_id] = parts
    s.txn = None
    resolved = inst.xa_coordinator.recover()
    assert resolved == {txn.txn_id: "committed"}
    s2 = _session(eng, inst, "x")
    rows = s2.execute("SELECT count(*) FROM a").rows
    assert rows == [(2,)]
    return rows, _tx_state(inst, txn.txn_id, "x"), _state(inst, "x")


@pytest.mark.parametrize("scenario", [
    _xa_two_store_commit, _xa_crash_before_commit_point_rolls_back,
    _xa_recovery_after_commit_point_commits,
], ids=lambda f: f.__name__.strip("_"))
def test_xa(scenario, tmp_path):
    _both(scenario, tmp_path)


# -- restarts: the reference's test_ddl_engine.py, test_sql_surface.py, test_spm.py ----

def _restart_reloads_catalog_and_data(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE p")
    s.execute("USE p")
    s.execute("CREATE TABLE t (a BIGINT, s VARCHAR(8)) PARTITION BY HASH(a) PARTITIONS 2")
    s.execute("INSERT INTO t VALUES (1, 'x'), (2, 'y'), (3, NULL)")
    inst.save()
    inst2 = eng.instance(d)
    rows = _session(eng, inst2, "p").execute("SELECT a, s FROM t ORDER BY a").rows
    assert rows == [(1, "x"), (2, "y"), (3, None)]
    tm = inst2.catalog.table("p", "t")
    assert tm.partition.count == 2
    # tm.version is left out: it counts writes, and the engines bump it differently
    return rows, tm.auto_increment_next, _state(inst2, "p")


def _crash_before_first_task_recovers_across_boot(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE x; USE x")
    s.execute("CREATE TABLE bt (a BIGINT, b BIGINT)")
    s.execute("INSERT INTO bt VALUES (1, 2)")
    eng.fail_points.arm("FP_BEFORE_DDL_TASK", 1)
    with pytest.raises(eng.FailPointError):
        s.execute("ALTER TABLE bt ADD COLUMN c BIGINT DEFAULT 5")
    eng.fail_points.clear()
    inst.save()
    jobs = inst.metadb.query("SELECT job_id, state FROM ddl_engine")
    inst2 = eng.instance(d)  # boot resumes the job
    s2 = _session(eng, inst2, "x")
    rows = s2.execute("SELECT a, c FROM bt").rows
    assert rows == [(1, 5)]
    return jobs, rows, inst2.metadb.query("SELECT job_id, state FROM ddl_engine"), \
        _state(inst2, "x")


def _view_persists_across_boot(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE vd; USE vd")
    s.execute("CREATE TABLE b (x BIGINT)")
    inst.store("vd", "b").insert_arrays({"x": np.arange(10)}, inst.tso.next_timestamp())
    s.execute("CREATE VIEW evens AS SELECT x FROM b WHERE x % 2 = 0")
    inst.save()
    rows = _session(eng, eng.instance(d), "vd").execute("SELECT count(*) FROM evens").rows
    assert rows == [(5,)]
    return rows


def _baselines_persist_across_restart(eng, d):
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE sp")
    s.execute("USE sp")
    s.execute("CREATE TABLE a (id BIGINT, k BIGINT)")
    s.execute("CREATE TABLE b (id BIGINT, k BIGINT)")
    for name in ("a", "b"):
        inst.store("sp", name).insert_pylists({"id": [1, 2], "k": [1, 2]},
                                              inst.tso.next_timestamp())
    s.execute("select count(*) from a, b where a.k = b.k")
    before = [r[1:4] for r in inst.planner.spm.rows()]
    assert len(before) == 1
    inst.save()
    after = [r[1:4] for r in eng.instance(d).planner.spm.rows()]
    assert after == before
    return after


def _node_info_after_boot(eng, d):
    """Each boot registers its node: both instances' rows, node ids by boot order."""
    inst = eng.instance(d)
    inst.save()
    inst2 = eng.instance(d)
    rows = _session(eng, inst2, "information_schema").execute(
        "SELECT node_id, role, host, port FROM node_info").rows
    names = {inst.node_id: "first", inst2.node_id: "booted"}
    assert len(rows) == 2 and {r[0] for r in rows} == set(names)
    return sorted((names[r[0]],) + tuple(r[1:]) for r in rows)


@pytest.mark.parametrize("scenario", [
    _restart_reloads_catalog_and_data, _crash_before_first_task_recovers_across_boot,
    _view_persists_across_boot, _baselines_persist_across_restart, _node_info_after_boot,
], ids=lambda f: f.__name__.strip("_"))
def test_restart(scenario, tmp_path):
    _both(scenario, tmp_path)


def test_data_dir_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the instance would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Instance(data_dir=str(tmp_path))


# -- the store's files -----------------------------------------------------------------

def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_store_files_equal_the_reference(tmp_path):
    """The same table saved by both packages: each array of each `p{pid}.npz` equals
    the reference's key by key, and `dictionaries.json` is equal."""
    ji, pi = _jax_instance(), PORT.instance()
    for inst, sess in ((ji, JaxSession(ji)), (pi, Session(pi))):
        sess.execute("CREATE DATABASE f; USE f")
        sess.execute("CREATE TABLE t (id BIGINT, s VARCHAR(8), d DECIMAL(10,2), "
                     "dt DATE, x DOUBLE) PARTITION BY HASH(id) PARTITIONS 3")
        sess.execute("INSERT INTO t VALUES (1, 'b', 1.25, '2024-01-02', 0.5), "
                     "(2, NULL, NULL, NULL, NULL), (3, 'a', -3.5, '1999-12-31', 2.0), "
                     "(4, 'b', 7.00, '2000-02-29', -1.0)")
        sess.execute("BEGIN")
        sess.execute("UPDATE t SET s = 'c' WHERE id = 3")  # provisional stamps saved
        sess.execute("DELETE FROM t WHERE id = 4")
        inst.store("f", "t").save(str(tmp_path / type(inst).__module__))
    jdir, pdir = (str(tmp_path / type(i).__module__) for i in (ji, pi))
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "dictionaries.json", "p0.npz", "p1.npz", "p2.npz"]
    with open(os.path.join(pdir, "dictionaries.json")) as f, \
            open(os.path.join(jdir, "dictionaries.json")) as g:
        assert f.read() == g.read()
    ranks_p, ranks_j = _ranks(pi, "f"), _ranks(ji, "f")
    for name in ("p0.npz", "p1.npz", "p2.npz"):
        got, want = _npz(os.path.join(pdir, name)), _npz(os.path.join(jdir, name))
        assert sorted(got) == sorted(want)
        for k, a in want.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, (name, k)
            if k in ("begin_ts", "end_ts"):
                assert [_stamp(v, ranks_p) for v in got[k].tolist()] == \
                    [_stamp(v, ranks_j) for v in a.tolist()], (name, k)
            else:
                assert got[k].tobytes() == a.tobytes(), (name, k)


def test_save_cost_writes_the_same_files_both_ways(capsys):
    """`tools/save_cost.py` on the CPU: the pooled and the one-by-one checkpoints of
    a small TPC-H instance hold the same arrays."""
    from galaxysql_tpu_torch.tools import save_cost
    assert save_cost.main(["--sf", "0.002", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["same_files"] and len(out["seconds"]["serial"]) == 2
    assert set(out["bytes_on_disk"]) == {f"tpch.{t}" for t in tpch.TABLE_ORDER}


# -- cross-boot at TPC-H SF 0.01 -------------------------------------------------------

SF = 0.01
GSI = "CREATE GLOBAL INDEX g_cust ON orders (o_custkey) COVERING (o_totalprice)"
VIEW = ("CREATE VIEW rev AS SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) "
        "AS revenue FROM orders, lineitem WHERE l_orderkey = o_orderkey "
        "AND o_orderdate < date '1995-03-15' GROUP BY l_orderkey")
VIEW_QUERY = ("SELECT l_orderkey, revenue FROM rev ORDER BY revenue DESC, l_orderkey "
              "LIMIT 10")
CROSS_QUERIES = [QUERIES[q] for q in (1, 3, 5, 6, 18)] + [VIEW_QUERY]


def _write_data_dir(eng, d, data):
    """A TPC-H SF 0.01 data directory with a view, a covering GSI, a parked table,
    SET GLOBAL values, a user with grants, and two transactions in doubt: A under
    XA stopped before its commit point (RF1), B with its commit point logged and its
    stamps not applied (RF2).  Returns (A's txn id, B's txn id, B's commit ts)."""
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        inst.store("tpch", t).insert_pylists(data[t], inst.tso.next_timestamp())
    s.execute(GSI)
    s.execute(VIEW)
    s.execute("CREATE TABLE scratch (id BIGINT PRIMARY KEY, v VARCHAR(4)) "
              "PARTITION BY HASH(id) PARTITIONS 2")
    s.execute("INSERT INTO scratch VALUES (1, 'a'), (2, 'b'), (3, NULL)")
    s.execute("DROP TABLE scratch")
    s.execute("SET GLOBAL ENABLE_BATCH_SCHEDULER = 0")
    s.execute("CREATE USER 'ro' IDENTIFIED BY 'pw'")
    s.execute("GRANT SELECT ON tpch.* TO 'ro'")
    keys = np.concatenate([np.asarray(p.lanes["o_orderkey"])
                           for p in inst.store("tpch", "orders").partitions])
    a = _session(eng, inst, "tpch")
    a.execute("SET TRANSACTION_POLICY = 'XA'")
    a.execute("BEGIN")
    for sql in tpch_refresh.rf1_statements(tpch_refresh.rf1_rows(SF, int(keys.max()))):
        a.execute(sql)
    txn_a = a.txn.txn_id
    eng.fail_points.arm(FP_BEFORE_COMMIT)
    with pytest.raises(eng.FailPointError):
        a.execute("COMMIT")
    eng.fail_points.clear()
    b = _session(eng, inst, "tpch")
    b.execute("BEGIN")
    for sql in tpch_refresh.rf2_statements(tpch_refresh.rf2_keys(SF, keys)):
        b.execute(sql)
    txn_b = b.txn.txn_id
    assert all(sp.prepare() for sp in eng.xa.participants_of(b.txn))
    inst.metadb.tx_log_put(txn_b, "PREPARED")
    commit_b = inst.tso.next_timestamp()
    inst.metadb.tx_log_put(txn_b, "COMMITTED", commit_b)
    b.txn = None
    inst.save()
    return txn_a, txn_b, commit_b


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    data = tpch.generate(SF)
    root = tmp_path_factory.mktemp("durable")
    out = {}
    for eng in (JAX, PORT):
        d = str(root / eng.name)
        out[eng.name] = (d, _write_data_dir(eng, d, data))
    # the two directories hold the same tables, lanes and stamp classes
    return out


def _copy(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _observe_booted(eng, inst, ids):
    txn_a, txn_b, commit_b = ids
    s = _session(eng, inst, "tpch")
    assert inst.metadb.tx_log_get(txn_a) == ("ABORTED", 0)
    assert inst.metadb.tx_log_get(txn_b) == ("DONE", commit_b)
    rows = [s.execute(q).rows for q in CROSS_QUERIES]
    for st in inst.stores.values():
        for p in st.partitions:
            assert not (p.begin_ts < 0).any() and not (p.end_ts < 0).any()
    return rows, _state(inst, "tpch")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_boot(direction, data_dirs, tmp_path):
    """A directory written by one package boots in the other: the booted instance
    equals the writer's own boot of the same directory (rows of Q1, Q3, Q5, Q6, Q18
    and the view's query, the recovery outcomes in the tx log, every lane and stamp
    class), A rolled back and B committed at its logged timestamp."""
    writer, reader = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    src, ids = data_dirs[writer.name]
    own = writer.instance(_copy(src, tmp_path, "own"))
    cross = reader.instance(_copy(src, tmp_path, "cross"))
    assert _observe_booted(reader, cross, ids) == _observe_booted(writer, own, ids)


def test_both_packages_write_the_same_directory(data_dirs, tmp_path):
    """The port boots the reference's directory and its own to the same state: the
    two packages checkpointed the same tables, lanes and stamps, and logged the same
    transaction states."""
    booted = []
    for name in ("jax", "port"):
        d, ids = data_dirs[name]
        inst = PORT.instance(_copy(d, tmp_path, name))
        booted.append((_state(inst, "tpch"),
                       [_tx_state(inst, t, "tpch") for t in ids[:2]],
                       _catalog(inst)))
    assert booted[0] == booted[1]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_after_cross_boot(direction, data_dirs, tmp_path):
    """After a cross boot both packages' instances take the same writes: an UPDATE
    maintains the covering GSI and point selects through it agree; the parked table
    flashes back; SET GLOBAL values and grants survive."""
    writer, reader = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    src, _ids = data_dirs[writer.name]
    own = writer.instance(_copy(src, tmp_path, "own"))
    cross = reader.instance(_copy(src, tmp_path, "cross"))

    def observe(eng, inst):
        s = _session(eng, inst, "tpch")
        pm = inst.privileges
        out = [inst.config.get("ENABLE_BATCH_SCHEDULER"),
               pm.has_privilege("ro", "SELECT", "tpch", "orders"),
               pm.has_privilege("ro", "INSERT", "tpch", "orders"),
               pm.grants_for("ro"), pm.password_hash("ro")]
        custs = [int(c) for c in s.execute(
            "SELECT o_custkey FROM orders ORDER BY o_orderkey LIMIT 3").rows[0]]
        out.append(s.execute("UPDATE orders SET o_totalprice = o_totalprice + 1 "
                             f"WHERE o_custkey = {custs[0]}").affected)
        for c in custs:
            out.append(sorted(s.execute(f"SELECT o_totalprice FROM orders WHERE "
                                        f"o_custkey = {c}").rows))
        gsi = [t for t in inst.stores if t.startswith("tpch.orders$")]
        out.append([_norm(t) for t in gsi])
        bins = [r for r in s.execute("SHOW RECYCLEBIN").rows]
        out.append([(_norm(r[0]),) + tuple(r[1:3]) for r in bins])
        s.execute("FLASHBACK TABLE scratch TO BEFORE DROP")
        out.append(s.execute("SELECT id, v FROM scratch ORDER BY id").rows)
        return out, _state(inst, "tpch")

    assert observe(reader, cross) == observe(writer, own)


# -- the group-commit gate -------------------------------------------------------------

THREADS, PER_THREAD = 8, 50


def _gate_counts(eng, inst):
    m = inst.metrics  # registry counters in both packages
    return (m.counter("group_commit_batches", "").value,
            m.counter("group_committed_txns", "").value)


def _gate_storm(eng, d):
    """THREADS sessions commit PER_THREAD single-row transactions each, at once."""
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE g; USE g")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, w BIGINT) "
              "PARTITION BY HASH(id) PARTITIONS 4")
    commits, failures = {}, []
    start = threading.Barrier(THREADS)

    def worker(w):
        se = _session(eng, inst, "g")
        try:
            start.wait(timeout=THREAD_SECONDS)
            for i in range(PER_THREAD):
                se.execute("BEGIN")
                se.execute(f"INSERT INTO t VALUES ({w * PER_THREAD + i}, {w})")
                txn_id = se.txn.txn_id
                se.execute("COMMIT")
                commits[txn_id] = inst.metadb.tx_log_get(txn_id)
        except Exception as e:  # the assertion below names it
            failures.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(THREAD_SECONDS)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not failures, failures
    assert len(commits) == THREADS * PER_THREAD
    assert all(state == "DONE" for state, _ in commits.values())
    tss = [ts for _, ts in commits.values()]
    assert len(set(tss)) == len(tss)  # every commit timestamp is unique
    batches, txns = _gate_counts(eng, inst)
    # each transaction logs COMMITTED and DONE through the gate
    assert 0 < batches <= txns == 2 * THREADS * PER_THREAD
    rows = s.execute("SELECT w, count(*) FROM t GROUP BY w ORDER BY w").rows
    assert rows == [(w, PER_THREAD) for w in range(THREADS)]
    return rows


def test_group_commit_gate_storm(tmp_path):
    _both(_gate_storm, tmp_path)


def _gate_flush_fails(eng, d):
    """The batch write raises: every member falls back to its own solo write and
    still commits."""
    inst = eng.instance(d)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE g; USE g")
    s.execute("CREATE TABLE t (id BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 2")

    def broken(entries):
        raise RuntimeError("metadb batch write failed")

    inst.metadb.tx_log_put_many = broken
    out = []
    for policy in ("TSO", "XA"):
        s.execute(f"SET TRANSACTION_POLICY = '{policy}'")
        s.execute("BEGIN")
        s.execute(f"INSERT INTO t VALUES ({len(out)}, 1)")
        txn_id = s.txn.txn_id
        s.execute("COMMIT")
        out.append(_tx_state(inst, txn_id, "g"))
    assert [st[0] for st in out] == ["DONE", "DONE"]
    assert _gate_counts(eng, inst) == (0, 0)
    return out, s.execute("SELECT id, v FROM t ORDER BY id").rows, _state(inst, "g")


def test_group_commit_gate_falls_back_to_solo_writes(tmp_path):
    _both(_gate_flush_fails, tmp_path)


# -- cached lanes after an in-process recovery -----------------------------------------

def test_cached_lanes_miss_after_recovery(tmp_path, monkeypatch):
    """A port instance caches a table's lanes; an XA transaction stops before its
    commit point and `xa_coordinator.recover()` rolls it back in place.  The next
    query misses the cache and equals the reference's."""
    ap_plans(monkeypatch)
    def scenario(eng, d):
        inst, s = _xa_tables(eng, d)
        q = "SELECT id, v FROM a ORDER BY id"
        before = s.execute(q).rows
        s.execute("BEGIN")
        s.execute("INSERT INTO a VALUES (9, 90)")
        s.execute("UPDATE a SET v = 12 WHERE id = 1")
        eng.fail_points.arm(FP_BEFORE_COMMIT)
        with pytest.raises(eng.FailPointError):
            s.execute("COMMIT")
        eng.fail_points.clear()
        assert s.execute(q).rows == before  # the writes bumped the version: caches
        if eng is PORT:
            misses = inst.device_cache.misses
            assert s.execute(q).rows == before
            assert inst.device_cache.misses == misses  # warm before the recovery
        assert list(inst.xa_coordinator.recover().values()) == ["rolled_back"]
        if eng is PORT:
            misses = inst.device_cache.misses
        after = s.execute(q).rows
        if eng is PORT:
            assert inst.device_cache.misses > misses
        assert after == before
        return after, _state(inst, "x")
    _both(scenario, tmp_path)


# -- the wire server's --data-dir ------------------------------------------------------

def test_server_boots_from_data_dir(tmp_path):
    """`python -m galaxysql_tpu_torch.net.server --data-dir D` serves what the last
    `save()` to D wrote."""
    d = str(tmp_path / "d")
    inst = PORT.instance(d)
    s = Session(inst)
    s.execute("CREATE DATABASE w; USE w")
    s.execute("CREATE TABLE t (id BIGINT, s VARCHAR(4)) "
              "PARTITION BY HASH(id) PARTITIONS 2")
    s.execute("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
    inst.save()
    proc = subprocess.Popen(
        [sys.executable, "-m", "galaxysql_tpu_torch.net.server", "--port", "0",
         "--device", "cpu", "--data-dir", d, "--announce"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVER_READY"), line
        port = int(line.split()[1])
        c = MiniClient("127.0.0.1", port, user="root", password="", database="w")
        try:
            names, rows = c.query("SELECT id, s FROM t ORDER BY id")
        finally:
            c.close()
        assert [tuple(r) for r in rows] == [("1", "a"), ("2", "b")]
    finally:
        proc.kill()
        proc.wait(timeout=30)

