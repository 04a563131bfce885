"""Fault tolerance of the port's worker plane, on the CPU, over real worker
subprocesses (`python -m galaxysql_tpu_torch.net.worker --device cpu`).

The port's counterparts of the reference's `tests/test_worker_process.py`
(`TestCrashRecovery`, `TestReplicaAndMove` without the move, `TestHaActs`),
`tests/test_chaos.py` (framing caps, retry classification, the SyncBus, the circuit
breaker, exactly-once DML on a dropped reply, deadlines, sync-epoch healing, the XA
crash between prepare and commit, replica failover and stale exclusion),
`tests/test_dml_batch.py`'s async replica legs and `tests/test_multi_coordinator.py`'s
fragment-cache epochs across two coordinators and one worker.

Every case over real workers runs the same fault schedule twice: a JAX coordinator
with JAX workers (`python -m galaxysql_tpu.net.worker --platform cpu`), then a port
coordinator with port workers.  The two outcomes (rows, affected counts, error
classes, recovery outcomes, replica and fence states, counters that moved) must be
equal, and equal to what the reference's case asserts.  The unit layer (framing,
retry classification, the SyncBus, the breaker) tests `net/dn.py`, which
`tests/test_torch_copies.py` holds byte for byte to the reference's.  Every run is
wall-clock bounded and every worker subprocess is killed in `finally`.
"""

import contextlib
import importlib
import json
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

from torch_worker_harness import PACKAGES, WorkerProc, coordinator, start_all

from galaxysql_tpu_torch.net import dn
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_APPLY_DELAY_MS,
                                                 FP_RPC_DELAY_MS, FP_RPC_DROP,
                                                 FP_RPC_FAIL_N, FP_WORKER_CRASH)
from galaxysql_tpu_torch.utils.metrics import SYNC_FAILURES

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and the coordinators' small
# CPU computations must not take cores from the other workers' tests
torch.set_num_threads(1)

RUN_BOUND_S = 120.0  # a call past this bound is a hang, a failure

KV_INIT = ("CREATE DATABASE w; USE w; "
           "CREATE TABLE kv (k BIGINT PRIMARY KEY, v BIGINT); "
           "INSERT INTO kv VALUES (1, 10), (2, 20), (3, 30); "
           "CREATE TABLE dim (k BIGINT PRIMARY KEY, label VARCHAR(16), "
           "price DECIMAL(10,2)); "
           "INSERT INTO dim VALUES (1,'alpha',1.50), (2,'beta',2.25), "
           "(3,'gamma',0.75), (4,'delta',9.99), (5, NULL, 5.00)")


def bounded(fn, timeout_s: float = RUN_BOUND_S):
    """Run fn on a daemon thread; raise if it neither returns nor raises within
    the bound."""
    result: dict = {}

    def run():
        try:
            result["v"] = fn()
        except BaseException as exc:  # noqa: BLE001 - raised again below
            result["e"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise AssertionError(f"hang: call exceeded {timeout_s}s bound")
    if "e" in result:
        raise result["e"]
    return result.get("v")


def per_package(case, *args):
    """case(pkg, *args) for the JAX package, then for the port, each within the
    bound: the two outcomes, by package."""
    return {pkg: bounded(lambda pkg=pkg: case(pkg, *args)) for pkg in PACKAGES}


def _pkg(pkg):
    """The modules a case arms, reads and calls, of package `pkg`."""
    root = "galaxysql_tpu" if pkg == "jax" else "galaxysql_tpu_torch"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(errors=mod("utils.errors"),
                                 fp=mod("utils.failpoint").FAIL_POINTS,
                                 metrics=mod("utils.metrics"), dn=mod("net.dn"),
                                 xa=mod("txn.xa"))


def _raised(fn):
    """The class name of what fn() raised, or None: the form two packages'
    failures are compared in."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is the outcome
        return type(e).__name__
    return None


def _typed(name, base="TddlError"):
    """Is `name` one of the port's error classes, a subclass of `base`?"""
    cls = getattr(errors, name or "", None)
    return isinstance(cls, type) and issubclass(cls, getattr(errors, base))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    for pkg in PACKAGES:
        _pkg(pkg).fp.clear()
    yield
    for pkg in PACKAGES:
        _pkg(pkg).fp.clear()


@pytest.fixture(scope="module")
def primaries():
    """One long-lived worker of each package holding w.kv and w.dim, started at
    first use."""
    ws = {}
    try:
        yield ws
    finally:
        for w in ws.values():
            w.close()


def _primary(primaries, pkg):
    if pkg not in primaries:
        primaries[pkg] = WorkerProc(pkg, KV_INIT)
    return primaries[pkg]


@contextlib.contextmanager
def _env(primaries, pkg, tables=("kv", "dim")):
    """A fresh coordinator of package `pkg` with its primary's `tables` attached
    (breaker and fence state never leak across cases): (session, instance,
    worker, the package's modules)."""
    w = _primary(primaries, pkg)
    m = _pkg(pkg)
    inst, s = coordinator(pkg)
    try:
        s.execute("CREATE DATABASE w")
        s.execute("USE w")
        for t in tables:
            inst.attach_remote_table("w", t, *w.addr)
        yield s, inst, w, m
    finally:
        m.fp.clear()
        s.close()


def _count(s, where):
    return s.execute(f"SELECT count(*) FROM kv WHERE {where}").rows[0][0]


def _equal(got, want=None):
    """The port's outcome equals the reference's, and the reference's case's
    assertion where one is given."""
    assert got["torch"] == got["jax"], got
    if want is not None:
        assert got["torch"] == want, got


# -- unit layer: framing, retry policy, the SyncBus, the breaker -------------------


class TestFraming:
    def _corrupt(self, payload: bytes):
        a, b = socket.socketpair()
        try:
            a.sendall(payload)
            with pytest.raises(errors.ProtocolError):
                dn.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_header_length_capped(self):
        self._corrupt(struct.pack(">I", (1 << 31) - 1) + b"x" * 64)

    def test_array_count_capped(self):
        hb = json.dumps({"n_arrays": 1 << 30}).encode()
        self._corrupt(struct.pack(">I", len(hb)) + hb)

    def test_array_name_length_capped(self):
        hb = json.dumps({"n_arrays": 1}).encode()
        self._corrupt(struct.pack(">I", len(hb)) + hb +
                      struct.pack(">I", 1 << 24) + b"y" * 64)

    def test_clean_roundtrip_still_works(self):
        a, b = socket.socketpair()
        try:
            dn.send_msg(a, {"op": "x"}, {"d": np.arange(4)})
            hdr, arrs = dn.recv_msg(b)
            assert hdr["op"] == "x" and list(arrs["d"]) == [0, 1, 2, 3]
        finally:
            a.close()
            b.close()


class TestRetryPolicy:
    def test_classification(self):
        rs = dn._retry_safe
        assert rs({"op": "ping"})
        assert rs({"op": "exec_plan", "fragment": {}})
        assert rs({"op": "sync", "action": "x"})
        assert rs({"op": "xa_commit", "xid": "g1"})
        assert rs({"op": "exec_sql", "sql": "SELECT 1"})
        assert rs({"op": "exec_sql", "sql": "  /* hint */ select k from t"})
        assert not rs({"op": "exec_sql", "sql": "INSERT INTO t VALUES (1)"})
        assert rs({"op": "exec_sql", "sql": "INSERT INTO t VALUES (1)",
                   "uid": "cn:1"})
        assert rs({"op": "exec_sql", "sql": "CREATE TABLE IF NOT EXISTS t",
                   "idem": True})
        assert not rs({"op": "dml", "sql": "UPDATE t SET v = 1"})
        assert rs({"op": "dml", "sql": "UPDATE t SET v = 1", "uid": "cn:2"})

    def test_rpc_spec_op_scoping_and_budget(self):
        FAIL_POINTS.arm(FP_RPC_DROP, {"op": "dml", "leg": "reply", "n": 2})
        assert FAIL_POINTS.rpc_spec(FP_RPC_DROP, "exec_plan") is None
        assert FAIL_POINTS.rpc_spec(FP_RPC_DROP, "dml")["leg"] == "reply"
        assert FAIL_POINTS.rpc_spec(FP_RPC_DROP, "dml")["leg"] == "reply"
        assert FAIL_POINTS.rpc_spec(FP_RPC_DROP, "dml") is None  # exhausted
        FAIL_POINTS.clear()
        FAIL_POINTS.arm(FP_RPC_FAIL_N, "exec_sql")  # the bare-op form
        assert FAIL_POINTS.rpc_spec(FP_RPC_FAIL_N, "exec_sql") == {}
        assert FAIL_POINTS.rpc_spec(FP_RPC_FAIL_N, "dml") is None


class _StubWorker:
    def __init__(self, delay_s=0.0, fail=False):
        self.delay_s = delay_s
        self.fail = fail

    def sync_action(self, action, payload):
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise ConnectionError("stub down")
        return {"ok": True}


class TestSyncBusBroadcast:
    def test_parallel_fanout_and_failure_isolation(self):
        bus = dn.SyncBus(origin="cn-test")
        for w in [_StubWorker(delay_s=0.25) for _ in range(3)] + \
                [_StubWorker(fail=True)]:
            bus.attach(w)
        f0 = SYNC_FAILURES.value
        t0 = time.perf_counter()
        out = bus.broadcast("invalidate_plan_cache", {})
        wall = time.perf_counter() - t0
        assert len(out) == 4
        assert sum(1 for r in out if r.get("ok")) == 3
        assert SYNC_FAILURES.value == f0 + 1
        assert wall < 0.6, f"broadcast not parallel: {wall:.3f}s"
        assert bus.epoch == 1

    def test_epoch_monotonic(self):
        bus = dn.SyncBus(origin="cn-test")
        for _ in range(3):
            bus.broadcast("invalidate_plan_cache", {})
        assert bus.epoch == 3


class TestBreakerUnit:
    def test_open_fastfail_and_reopen_on_failed_probe(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        c = dn.WorkerClient("127.0.0.1", port, timeout=0.5, max_retries=2,
                            retry_backoff_ms=5, failure_threshold=3,
                            cooldown_ms=250)
        with pytest.raises(errors.WorkerUnavailableError):
            c.request({"op": "ping"})
        assert c.breaker_state() == "open"
        t0 = time.perf_counter()
        with pytest.raises(errors.WorkerUnavailableError):
            c.request({"op": "ping"})
        assert time.perf_counter() - t0 < 0.2  # fast-fail, no socket touched
        time.sleep(0.3)  # the cooldown passes: a half-open probe, which fails
        with pytest.raises(errors.WorkerUnavailableError):
            c.request({"op": "ping"})
        assert c.breaker_state() == "open"
        snap = c.breaker_snapshot()
        assert snap["opens"] >= 1 and snap["failures"] >= 3


# -- a real worker under faults: each package's pair on the same schedule -----------


class TestRetriesAndDedupe:
    def test_transparent_retry_on_transient_failures(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                r0 = m.metrics.RPC_RETRIES.value
                m.fp.arm(FP_RPC_FAIL_N, {"op": "exec_plan", "n": 2})
                rows = s.execute("SELECT k, v FROM kv ORDER BY k").rows
                return rows, m.metrics.RPC_RETRIES.value >= r0 + 2
        _equal(per_package(case), ([(1, 10), (2, 20), (3, 30)], True))

    def test_exhausted_retries_fail_typed_not_hang(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                m.fp.arm(FP_RPC_FAIL_N, {"op": "exec_plan", "n": 50})
                name = _raised(lambda: s.execute("SELECT k FROM kv"))
                m.fp.clear()
                inst.ha.fence_worker(w.addr, False)
                return name
        got = per_package(case)
        _equal(got)
        assert _typed(got["torch"]), got

    @staticmethod
    def _reply_drop(s, inst, w, fp):
        """The reply leg of a dml drops after the worker executed it: the retry
        re-sends the same uid and the dedupe window replays the result."""
        client = inst.workers[w.addr]
        st0 = client.sync_action("worker_stats", {})
        fp.arm(FP_RPC_DROP, {"op": "dml", "leg": "reply", "n": 1})
        rs = s.execute("INSERT INTO kv VALUES (777, 7)")
        fp.clear()
        try:
            hits = client.sync_action("worker_stats", {})["dedupe_hits"] - \
                st0["dedupe_hits"]
            return rs.affected, _count(s, "k = 777"), hits >= 1
        finally:
            s.execute("DELETE FROM kv WHERE k = 777")

    @staticmethod
    def _ambiguous(s, inst, w, fp):
        """Every reply of the primary dml lost after the send: the explicit
        transaction rolls back, and so does the branch the worker applied."""
        s.execute("BEGIN")
        fp.arm(FP_RPC_DROP, {"op": "dml", "leg": "reply", "n": 50})
        raised = _raised(lambda: s.execute("INSERT INTO kv VALUES (666, 6)"))
        fp.clear()
        txn_gone = s.txn is None
        s.execute("COMMIT")
        alive = inst.workers[w.addr].ping()
        return raised, txn_gone, alive, _count(s, "k = 666")

    @staticmethod
    def _presend(s, inst, w, fp):
        """Nothing reached the wire: a statement-scoped error, the transaction
        survives and commits cleanly without the phantom branch."""
        s.execute("BEGIN")
        fp.arm(FP_RPC_FAIL_N, {"op": "dml", "n": 50})
        raised = _raised(lambda: s.execute("INSERT INTO kv VALUES (667, 6)"))
        fp.clear()
        txn_alive = s.txn is not None
        alive = inst.workers[w.addr].ping()
        s.execute("INSERT INTO kv VALUES (668, 8)")
        s.execute("COMMIT")
        try:
            return (raised, txn_alive, alive, _count(s, "k IN (667, 668)"),
                    s.execute("SELECT v FROM kv WHERE k = 668").rows)
        finally:
            s.execute("DELETE FROM kv WHERE k = 668")

    @pytest.mark.parametrize("case", ["reply_drop", "ambiguous", "presend"])
    def test_dml_fault_outcomes_equal_the_reference(self, primaries, case):
        def run(pkg):
            with _env(primaries, pkg, ("kv",)) as (s, inst, w, m):
                return getattr(self, f"_{case}")(s, inst, w, m.fp)
        want = {"reply_drop": (1, 1, True),
                "ambiguous": ("TransactionError", True, True, 0),
                "presend": ("TddlError", True, True, 1, [(8,)])}[case]
        _equal(per_package(run), want)

    def test_worker_reported_error_keeps_txn_alive(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                s.execute("BEGIN")
                s.execute("INSERT INTO kv VALUES (901, 1)")
                name = _raised(lambda: s.execute("INSERT INTO kv VALUES (902)"))
                alive = s.txn is not None  # a statement error keeps the txn
                s.execute("ROLLBACK")
                return name, alive, _count(s, "k = 901")
        got = per_package(case)
        _equal(got)
        assert _typed(got["torch"][0]) and got["torch"][1:] == (True, 0), got

    def test_dml_without_faults_unaffected(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                s.execute("INSERT INTO kv VALUES (888, 8)")
                try:
                    return s.execute("SELECT v FROM kv WHERE k = 888").rows
                finally:
                    s.execute("DELETE FROM kv WHERE k = 888")
        _equal(per_package(case), [(8,)])


class TestDeadlines:
    def test_worker_aborts_past_deadline_fragment(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                return _raised(lambda: inst.workers[w.addr].request(
                    {"op": "exec_plan", "fragment": {"schema": "w", "table": "kv",
                                                     "columns": ["k"]},
                     "deadline_ms": 0}))
        _equal(per_package(case), "QueryTimeoutError")

    def test_deadline_during_rpc_dies_typed(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                s.execute("SET MAX_EXECUTION_TIME = 60")
                m.fp.arm(FP_RPC_DELAY_MS, {"op": "exec_plan", "ms": 200})
                name = _raised(lambda: s.execute("SELECT k FROM kv"))
                m.fp.clear()
                s.execute("SET MAX_EXECUTION_TIME = 0")
                return name, inst.metrics.counter("query_timeouts").value >= 1
        _equal(per_package(case), ("QueryTimeoutError", True))

    def test_dml_hint_deadline(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                m.fp.arm(FP_RPC_DELAY_MS, {"op": "dml", "ms": 200})
                name = _raised(lambda: s.execute(
                    "/*+TDDL: MAX_EXECUTION_TIME(50)*/ INSERT INTO kv VALUES (555, 5)"))
                m.fp.clear()
                return name, _count(s, "k = 555")
        _equal(per_package(case), ("QueryTimeoutError", 0))

    def test_breaker_hatch_applies_to_attached_workers(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                client = inst.workers[w.addr]
                out = [(client.failure_threshold, client.max_retries)]
                s.execute("SET GLOBAL BREAKER_FAILURE_THRESHOLD = 7")
                s.execute("SET GLOBAL RPC_MAX_RETRIES = 5")
                try:
                    out.append((client.failure_threshold, client.max_retries))
                finally:
                    s.execute("SET GLOBAL BREAKER_FAILURE_THRESHOLD = 3")
                    s.execute("SET GLOBAL RPC_MAX_RETRIES = 2")
                return out
        _equal(per_package(case), [(3, 2), (7, 5)])

    def test_hint_overrides_session_param(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                m.fp.arm(FP_RPC_DELAY_MS, {"op": "exec_plan", "ms": 200})
                name = _raised(lambda: s.execute(
                    "/*+TDDL: MAX_EXECUTION_TIME(50)*/ SELECT k FROM kv"))
                m.fp.clear()
                m.fp.arm(FP_RPC_DELAY_MS, {"op": "exec_plan", "ms": 60, "n": 1})
                return name, len(s.execute("SELECT k FROM kv").rows)
        _equal(per_package(case), ("QueryTimeoutError", 3))


class TestBreakerIntegration:
    @staticmethod
    def _case(pkg):
        """A worker killed: the breaker opens and fast-fails, a restart closes it
        and SHOW WORKERS counts the opening."""
        h = WorkerProc(pkg, "CREATE DATABASE w; USE w; "
                            "CREATE TABLE t (a BIGINT PRIMARY KEY)")
        inst, s = coordinator(pkg)
        try:
            s.execute("CREATE DATABASE w")
            s.execute("USE w")
            inst.attach_remote_table("w", "t", *h.addr)
            client = inst.workers[h.addr]
            client.timeout = 2.0
            out = [s.execute("SELECT a FROM t").rows]
            h.kill()
            out.append(_raised(lambda: s.execute("SELECT a FROM t")))
            out.append(client.breaker_state())
            t0 = time.perf_counter()
            out.append(_raised(lambda: client.request(
                {"op": "exec_plan", "fragment": {}})))
            out.append(time.perf_counter() - t0 < 0.2)  # fast-fail, no socket
            h.restart()
            time.sleep(client.cooldown_s + 0.05)
            inst.ha.fence_worker(h.addr, False)
            out.append(s.execute("SELECT a FROM t").rows)
            out.append(client.breaker_state())
            row = [r for r in s.execute("SHOW WORKERS").rows if r[1] == h.addr[1]][0]
            out.append((row[2], row[7] >= 1))  # breaker state, breaker_opens
            return out
        finally:
            s.close()
            h.close()

    def test_breaker_trips_fastfails_and_recovers(self):
        got = per_package(self._case)
        _equal(got)
        rows0, err, state, fast_err, fast, rows1, closed, show = got["torch"]
        assert _typed(err) and state == "open"
        assert fast_err == "WorkerUnavailableError" and fast
        assert rows0 == rows1 == [] and closed == "closed"
        assert show == ("closed", True)


class TestSyncEpochHealing:
    def test_missed_broadcast_heals_at_next_contact(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                client = inst.workers[w.addr]
                inst.sync_bus.broadcast("invalidate_plan_cache", {})
                st0 = client.sync_action("worker_stats", {})
                m.fp.arm(FP_RPC_DROP, {"op": "sync", "leg": "request", "n": 10})
                out = inst.sync_bus.broadcast("invalidate_fragment_cache",
                                              {"schema": "w", "table": "kv"})
                missed = not out[0].get("ok")
                m.fp.clear()
                alive = client.ping()
                n = len(s.execute("SELECT k FROM kv").rows)
                st1 = client.sync_action("worker_stats", {})
                return (missed, alive, n, st1["heals"] >= st0["heals"] + 1,
                        st1["sync_epochs"][inst.node_id] == inst.sync_bus.epoch)
        _equal(per_package(case), (True, True, 3, True, True))


class TestHaActs:
    def test_fenced_worker_refuses_fast(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                # fencing a live worker heals itself: the next read's revival ping
                inst.ha.fence_worker(w.addr, True)
                out = [len(s.execute("SELECT k FROM dim").rows),
                       inst.ha.worker_fenced(w.addr)]
                # a fenced dead endpoint refuses fast and typed
                dead_addr = ("127.0.0.1", 1)
                tm = inst.catalog.table("w", "dim")
                old_remote = dict(tm.remote)
                inst.workers[dead_addr] = m.dn.WorkerClient("127.0.0.1", 1,
                                                            timeout=0.5)
                inst.ha.fence_worker(dead_addr, True)
                tm.remote = {"host": dead_addr[0], "port": dead_addr[1]}
                try:
                    t0 = time.time()
                    try:
                        s.execute("SELECT k FROM dim")
                        out.append(None)
                    except m.errors.TddlError as e:
                        out.append((type(e).__name__, "fenced" in str(e)))
                    out.append(time.time() - t0 < 2.0)
                finally:
                    tm.remote = old_remote
                    del inst.workers[dead_addr]
                    inst.ha.fence_worker(dead_addr, False)
                out.append(len(s.execute("SELECT k FROM dim").rows))
                return out
        got = per_package(case)
        _equal(got)
        n0, fenced, (name, says_fenced), fast, n1 = got["torch"]
        assert (n0, fenced, says_fenced, fast, n1) == (5, False, True, True, 5)
        assert _typed(name), got

    def test_probe_fences_dead_worker_and_recovers(self, primaries):
        def case(pkg):
            with _env(primaries, pkg) as (s, inst, w, m):
                out = [inst.ha.probe_workers().get(w.addr)]
                inst.workers[("127.0.0.1", 1)] = m.dn.WorkerClient("127.0.0.1", 1)
                try:
                    fenced = inst.ha.probe_workers()
                    out += [fenced[("127.0.0.1", 1)], fenced[w.addr]]
                finally:
                    del inst.workers[("127.0.0.1", 1)]
                return out
        _equal(per_package(case), [False, True, False])


# -- crashes and replicas: workers of their own ---------------------------------


def _crash_case(pkg, tmp_path):
    """TestCrashRecovery of the reference on one worker: a branch PREPARED, the
    worker SIGKILLed, the commit point logged, a restart from its data dir (which
    must still hold the branch in doubt) and a re-attach: recovery commits the
    branch; then a second branch with no commit point is rolled back.  Returns
    the observable outcomes."""
    m = _pkg(pkg)
    h = WorkerProc(pkg, "CREATE DATABASE cw; USE cw; "
                        "CREATE TABLE acct (id BIGINT PRIMARY KEY, bal BIGINT); "
                        "INSERT INTO acct VALUES (1, 100)",
                   data_dir=str(tmp_path / f"wdata-{pkg}"))
    inst, s = coordinator(pkg)
    out = []
    try:
        s.execute("CREATE DATABASE cw")
        s.execute("USE cw")
        inst.attach_remote_table("cw", "acct", *h.addr)
        for sql, commit in (("INSERT INTO acct VALUES (2, 555)", True),
                            ("INSERT INTO acct VALUES (3, 777)", False)):
            s.execute("BEGIN")
            s.execute(sql)
            txn = s.txn
            parts = m.xa.remote_participants_of(inst, txn)
            out.append((len(parts), parts[0].prepare()))
            h.kill()
            if commit:
                inst.metadb.tx_log_put(txn.txn_id, "COMMITTED",
                                       inst.tso.next_timestamp())
            s.txn = None  # recovery resolves the session's txn
            h.restart()
            # the restarted worker holds the prepared branch until it is decided
            resp, _ = inst.workers[h.addr].request({"op": "xa_recover"})
            out.append(len(resp["xids"]))
            # re-attaching resolves the in-doubt branch; a later call finds none
            inst.attach_remote_table("cw", "acct", *h.addr)
            out.append(inst.xa_coordinator.recover_remote())
            out.append(s.execute("SELECT id, bal FROM acct ORDER BY id").rows)
        return out
    finally:
        s.close()
        h.close()


def test_crash_after_prepare_recovers_as_the_reference(tmp_path):
    # the reference's TestCrashRecovery outcomes: the commit point wins, no commit
    # point presumes abort, nothing is left in doubt after re-attaching
    _equal(per_package(_crash_case, tmp_path),
           [(1, True), 1, {}, [(1, 100), (2, 555)],
            (1, True), 1, {}, [(1, 100), (2, 555)]])


class TestXaCrashRecovery:
    @staticmethod
    def _case(pkg, tmp_path):
        """The worker exits hard when xa_commit arrives: prepared durably, the
        commit point logged, the commit never applied; a restart and
        recover_remote commit the branch exactly once."""
        m = _pkg(pkg)
        h = WorkerProc(pkg, "CREATE DATABASE w; USE w; "
                            "CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT)",
                       data_dir=str(tmp_path / f"wdata-{pkg}"))
        inst, s = coordinator(pkg)
        try:
            s.execute("CREATE DATABASE w")
            s.execute("USE w")
            inst.attach_remote_table("w", "t", *h.addr)
            client = inst.workers[h.addr]
            client.timeout = 5.0
            s.execute("BEGIN")
            s.execute("INSERT INTO t VALUES (1, 100)")
            client.sync_action("failpoint", {"key": FP_WORKER_CRASH,
                                             "value": {"op": "xa_commit"}})
            try:
                s.execute("COMMIT")
                commit = None
            except m.errors.TddlError as e:
                commit = (type(e).__name__, bool(getattr(e, "commit_ts", None))
                          or "in doubt" in str(e))
            h.wait_dead()
            h.restart()
            time.sleep(client.cooldown_s + 0.05)
            first = sorted(inst.xa_coordinator.recover_remote().values())
            inst.ha.fence_worker(h.addr, False)
            return (commit, first, s.execute("SELECT count(*), sum(b) FROM t").rows,
                    inst.xa_coordinator.recover_remote())
        finally:
            s.close()
            h.close()

    def test_worker_crash_between_prepare_and_commit_resolves_once(self, tmp_path):
        _equal(per_package(self._case, tmp_path),
               (("TransactionError", True), ["committed"], [(1, 100)], {}))


def _stale_by_endpoint(tm, order):
    """The replicas' stale flags in the order of the endpoints `order`."""
    flags = {(r["host"], r["port"]): r.get("stale") for r in tm.replicas}
    return [flags.get(addr) for addr in order]


def _async_applies(pkg, inst):
    """Replica legs the async applier applied: both packages count them in the
    metrics registry (`txn/async_apply.py`)."""
    return inst.metrics.counter("replica_async_applies").value


class TestReplicas:
    @staticmethod
    def _failover_case(pkg, primaries):
        m = _pkg(pkg)
        prim = _primary(primaries, pkg)
        rep = WorkerProc(pkg)
        inst, s = coordinator(pkg)
        out = {}
        try:
            s.execute("CREATE DATABASE w")
            s.execute("USE w")
            inst.attach_remote_table("w", "kv", *prim.addr)
            # a huge weight routes reads to the replica
            inst.attach_replica("w", "kv", *rep.addr, weight=10 ** 6)
            _c0, _t, rdata, _v = inst.workers[rep.addr].execute(
                "SELECT count(*) FROM kv", "w")
            out["backfilled"] = int(next(iter(rdata.values()))[0])
            rep.kill()
            inst.workers[rep.addr].timeout = 2.0
            f0 = m.metrics.WORKER_FAILOVERS.value
            out["failover_rows"] = s.execute("SELECT k, v FROM kv ORDER BY k").rows
            out["failed_over"] = m.metrics.WORKER_FAILOVERS.value >= f0 + 1
            out["fenced"] = inst.ha.worker_fenced(rep.addr)
            s.execute("INSERT INTO kv VALUES (40, 400)")
            tm = inst.catalog.table("w", "kv")
            out["stale_after_write"] = _stale_by_endpoint(tm, [rep.addr])
            out["reattach_stale"] = _raised(
                lambda: inst.attach_replica("w", "kv", *rep.addr))
            rep.restart()
            inst.ha.fence_worker(rep.addr, False)
            inst.workers[rep.addr].ping()  # close the breaker
            inst.attach_replica("w", "kv", *rep.addr, weight=10 ** 6, backfill=True)
            out["stale_after_rebuild"] = _stale_by_endpoint(tm, [rep.addr])
            out["rows"] = s.execute("SELECT k, v FROM kv ORDER BY k").rows
            _c, _t2, rdata, _v2 = inst.workers[rep.addr].execute(
                "SELECT count(*) FROM kv", "w")
            out["replica_rows"] = int(next(iter(rdata.values()))[0])
            s.execute("DELETE FROM kv WHERE k = 40")
            return out
        finally:
            s.close()
            rep.close()

    def test_replica_failover_stale_exclusion_and_rebuild(self, primaries):
        """Reads fail over within the statement when the replica dies, a write
        marks the fenced replica stale, a stale replica refuses re-attach without
        a rebuild, and backfill=True rebuilds it."""
        got = per_package(self._failover_case, primaries)
        _equal(got)
        out = dict(got["torch"])
        assert _typed(out.pop("reattach_stale")), got
        assert out == {"backfilled": 3, "failover_rows": [(1, 10), (2, 20), (3, 30)],
                       "failed_over": True, "fenced": True,
                       "stale_after_write": [True], "stale_after_rebuild": [False],
                       "rows": [(1, 10), (2, 20), (3, 30), (40, 400)],
                       "replica_rows": 4}

    @staticmethod
    def _primary_death_case(pkg, tmp_path):
        m = _pkg(pkg)
        init = ("CREATE DATABASE rp; USE rp; "
                "CREATE TABLE inv (id BIGINT PRIMARY KEY, qty BIGINT); "
                "INSERT INTO inv VALUES (1, 5), (2, 7)")
        p1, p2, p3 = start_all((pkg, init, str(tmp_path / f"w1-{pkg}")),
                               (pkg, "", str(tmp_path / f"w2-{pkg}")),  # empty
                               (pkg, "", None))
        inst, s = coordinator(pkg)
        out = {}
        try:
            s.execute("CREATE DATABASE rp")
            s.execute("USE rp")
            inst.attach_remote_table("rp", "inv", *p1.addr)
            inst.attach_replica("rp", "inv", *p2.addr)  # backfilled: it is empty
            rep_client = inst.workers[p2.addr]
            st0 = rep_client.sync_action("worker_stats", {})
            # the applier sleeps first: the reply drop armed after the primary's
            # synchronous leg hits the async replica leg
            m.fp.arm(FP_APPLY_DELAY_MS, 500)
            rs = s.execute("INSERT INTO inv VALUES (3, 9)")
            m.fp.arm(FP_RPC_DROP, {"op": "dml", "leg": "reply", "n": 1})
            out["affected"] = rs.affected
            # read-your-writes: the next statement waits for the replica leg
            out["rows"] = sorted(s.execute("SELECT id, qty FROM inv").rows)
            m.fp.clear()
            out["drained"] = inst.applier.drain(30.0)
            _c, _t, data, _v = rep_client.execute("SELECT count(*) FROM inv", "rp")
            out["replica_rows"] = int(next(iter(data.values()))[0])
            out["replayed"] = rep_client.sync_action(
                "worker_stats", {})["dedupe_hits"] >= st0["dedupe_hits"] + 1
            out["async_applied"] = _async_applies(pkg, inst) >= 1
            tm = inst.catalog.table("rp", "inv")
            out["stale"] = _stale_by_endpoint(tm, [p2.addr])
            # a second replica dies before its async leg applies: it goes stale
            inst.attach_replica("rp", "inv", *p3.addr)
            m.fp.arm(FP_APPLY_DELAY_MS, 200)
            p3.kill()
            out["affected_2"] = s.execute("INSERT INTO inv VALUES (7, 70)").affected
            m.fp.clear()
            inst.applier.drain(60.0)
            out["stale_2"] = _stale_by_endpoint(tm, [p2.addr, p3.addr])
            # the primary dies: the probe fences it and reads fail over to p2
            p1.kill()
            out["primary_fenced"] = inst.ha.probe_workers()[p1.addr]
            out["reads"] = [sorted(s.execute("SELECT id, qty FROM inv").rows)
                            for _ in range(3)]
            return out
        finally:
            m.fp.clear()
            s.close()
            for p in (p1, p2, p3):
                p.close()

    def test_primary_death_keeps_reads_serving_and_async_legs(self, tmp_path):
        """Writes reach every endpoint (an autocommit write's replica legs through
        the async applier, a dropped reply replayed exactly once); a replica that
        dies before its async leg goes stale; with the primary killed, the probe
        fences it and reads serve from the live replica."""
        want = [(1, 5), (2, 7), (3, 9), (7, 70)]
        _equal(per_package(self._primary_death_case, tmp_path),
               {"affected": 1, "rows": [(1, 5), (2, 7), (3, 9)], "drained": True,
                "replica_rows": 3, "replayed": True, "async_applied": True,
                "stale": [False], "affected_2": 1, "stale_2": [False, True],
                "primary_fenced": True, "reads": [want] * 3})


# -- two coordinators over one worker: the fragment-cache epochs --------------------


class TestFragmentCacheAcrossCoordinators:
    """A peer's write to a remote table reaches the other coordinator only through
    the `invalidate_fragment_cache` broadcast: remote tables have no version here,
    their fingerprints ride an epoch."""

    JOIN = ("SELECT d.label, sum(f.v) FROM fact f JOIN dim d ON f.k = d.k "
            "GROUP BY d.label ORDER BY d.label")

    @pytest.fixture(scope="class")
    def two_cns(self):
        """For each package, a worker holding w.dim and two coordinators over it
        joined on each other's sync bus: {pkg: (session a, session b)}."""
        ws = start_all(*[(pkg, "CREATE DATABASE w; USE w; "
                               "CREATE TABLE dim (k BIGINT PRIMARY KEY, "
                               "label VARCHAR(16)); INSERT INTO dim VALUES "
                               "(1,'alpha'), (2,'beta'), (3,'gamma')", None)
                         for pkg in PACKAGES])
        nodes = {}
        try:
            for pkg, w in zip(PACKAGES, ws):
                pair = []
                for _ in range(2):
                    inst, s = coordinator(pkg)
                    pair.append(s)
                    s.execute("CREATE DATABASE w")
                    s.execute("USE w")
                    s.execute("CREATE TABLE fact (k BIGINT, v BIGINT)")
                    s.execute("INSERT INTO fact VALUES (1,10),(2,20),(3,30),(1,40)")
                    inst.attach_remote_table("w", "dim", *w.addr)
                nodes[pkg] = pair
                a, b = pair[0].instance, pair[1].instance
                a.sync_bus.attach(b.sync_peer())
                b.sync_bus.attach(a.sync_peer())
            yield nodes
        finally:
            for pair in nodes.values():
                for s in pair:
                    s.close()
            for w in ws:
                w.close()

    @staticmethod
    def _labels(rs):
        return [tuple(r) for r in rs.rows]

    def test_peer_dml_invalidates_remote_fragment(self, two_cns):
        def case(pkg):
            sa, sb = two_cns[pkg]
            a = sa.instance
            a.frag_cache.clear()
            cold = self._labels(sa.execute(self.JOIN))
            h0 = a.frag_cache.hits
            warm = self._labels(sa.execute(self.JOIN))
            reused = a.frag_cache.hits > h0  # the remote build artifact
            sb.execute("INSERT INTO dim VALUES (9, 'omega')")
            sb.execute("INSERT INTO fact VALUES (9, 900)")
            sa.execute("INSERT INTO fact VALUES (9, 1)")
            return cold, warm == cold, reused, self._labels(sa.execute(self.JOIN))
        got = per_package(case)
        _equal(got)
        _cold, same, reused, after = got["torch"]
        assert same and reused and ("omega", 1) in after

    def test_txn_commit_rebumps_epoch(self, two_cns):
        def case(pkg):
            sa, sb = two_cns[pkg]
            sa.execute(self.JOIN)
            sb.execute("BEGIN")
            sb.execute("INSERT INTO dim VALUES (8, 'theta')")
            sa.execute("INSERT INTO fact VALUES (8, 5)")
            pre = self._labels(sa.execute(self.JOIN))
            sa.execute(self.JOIN)  # warm on the pre-commit view
            sb.execute("COMMIT")
            return pre, self._labels(sa.execute(self.JOIN))
        got = per_package(case)
        _equal(got)
        pre, post = got["torch"]
        assert not any(r[0] == "theta" for r in pre) and ("theta", 5) in post

    def test_sync_action_bumps_epoch_directly(self, two_cns):
        def case(pkg):
            sa, sb = two_cns[pkg]
            a, b = sa.instance, sb.instance
            e0 = a.frag_cache.epoch("w.dim")
            acks = b.sync_bus.broadcast("invalidate_fragment_cache",
                                        {"schema": "w", "table": "dim"})
            return any(ack.get("ok") for ack in acks), a.frag_cache.epoch("w.dim") - e0
        _equal(per_package(case), (True, 1))

    def test_privilege_change_reaches_the_peer(self, two_cns):
        def case(pkg):
            sa, sb = two_cns[pkg]
            b = sb.instance
            calls = []
            orig = b.privileges.invalidate_cache
            b.privileges.invalidate_cache = lambda: (calls.append(1), orig())[1]
            try:
                sa.execute("CREATE USER peer_u IDENTIFIED BY 'x'")
                sa.execute("DROP USER peer_u")
            finally:
                b.privileges.invalidate_cache = orig
            return len(calls) >= 2
        _equal(per_package(case), True)


def test_coordinator_sync_listener_serves_a_peer():
    """The wire form of `sync_peer()`: a peer's WorkerClient pings the listener and
    its sync actions apply to the listening instance, as the reference's do, and
    its `health` pull answers with the reference's keys."""
    def case(pkg):
        server = importlib.import_module(
            ("galaxysql_tpu" if pkg == "jax" else "galaxysql_tpu_torch") + ".net.server")
        m = _pkg(pkg)
        inst, s = coordinator(pkg)
        lis = server.CoordinatorSyncListener(inst)
        client = m.dn.WorkerClient("127.0.0.1", lis.start(), timeout=5.0)
        try:
            alive = client.ping()
            e0 = inst.frag_cache.epoch("w.t")
            ok = client.sync_action("invalidate_fragment_cache",
                                    {"schema": "w", "table": "t"})["ok"]
            health = client.sync_action("health", {})
            out = (alive, ok, inst.frag_cache.epoch("w.t") - e0,
                   health["ok"], health["node"] == inst.node_id, health["mem_tier"],
                   health["samples"] >= 1, sorted(health))
            return out
        finally:
            client.close()
            lis.stop()
            s.close()
    got = per_package(case)
    _equal(got, got["jax"])
    assert got["jax"][:7] == (True, True, 1, True, True, 0, True)
