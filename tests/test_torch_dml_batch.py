"""Batched point writes (`server/dml_batch.py`), the async GSI applier
(`txn/async_apply.py`) and their change log: the port against the JAX package on the
CPU.  The counterparts of `tests/test_dml_batch.py`.

Each scenario runs the same statements through the JAX package's `Instance()` and the
port's `Instance(device="cpu")` and returns what users observe: affected counts,
errors by type, rows, GSI rows, binlog contents and the batchers' counters.  The two
engines' observations must be equal.

Grouping is made deterministic rather than left to timing: where a test needs its
members in one group, it starts them at a `threading.Barrier` under a fixed
DML_BATCH_WINDOW_US of 10 s and a BATCH_MAX_GROUP equal to the number of members, so
the group seals when the last member joins (`_storm`).  Workloads whose sessions run
many statements assert only what holds however the statements grouped (the final
rows, which each session's disjoint keys make order-free).  The group-commit test
slows the transaction log's batch write so concurrent committers queue behind it.

Left out, with the reason: `test_statement_summary_and_admission_attribution` (the
statement summary and admission wait for ROADMAP Queue 1 item 16);
`test_steady_state_retrace_and_dispatch_guard` (XLA retraces have no counterpart in
the port).  `TestReplicaAsyncApply`'s cases run over real worker processes in
`tests/test_torch_worker_faults.py`.
"""

import functools
import json
import threading
import types

import pytest
import torch

from galaxysql_tpu.server import dml_batch as jax_dml_batch
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage.table_store import INFINITY_TS as JAX_INFINITY_TS
from galaxysql_tpu.txn import cdc as jax_cdc
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu.utils.failpoint import FAIL_POINTS as JAX_FAIL_POINTS
from galaxysql_tpu_torch.server import dml_batch
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
from galaxysql_tpu_torch.txn import cdc
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_APPLY_DELAY_MS,
                                                 FP_DML_POISON_KEY)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

DDL = """
    CREATE TABLE t (
        id BIGINT NOT NULL PRIMARY KEY,
        k  INT NOT NULL,
        v  VARCHAR(20),
        amt DECIMAL(12,2)
    ) PARTITION BY HASH(id) PARTITIONS 4
"""
GSI = "CREATE GLOBAL INDEX g_k ON t (k) COVERING (amt)"

INS = "INSERT INTO t (id, k, v, amt) VALUES (%d, %d, '%s', %d.25)"
UPD = "UPDATE t SET amt = %d.99, v = '%s' WHERE id = %d"
DEL = "DELETE FROM t WHERE id = %d"

GROUP_WINDOW_US = 10_000_000  # a group waits this long at most for its last member
THREAD_SECONDS = 60


def _jax_counter(inst, name):
    return inst.metrics.counter(name).value


def _port_counter(inst, name):
    if name.startswith("dml_"):
        return inst.dml_batch_scheduler.counts[name]
    if name in ("gsi_async_applies", "group_commit_batches", "group_committed_txns"):
        return inst.metrics.counter(name).value  # registry counters, as the reference
    return inst.counters[name]


JAX = types.SimpleNamespace(
    name="jax", instance=JaxInstance, Session=JaxSession, cdc=jax_cdc,
    errors=jax_errors, fail_points=JAX_FAIL_POINTS, counter=_jax_counter,
    dml_batch=jax_dml_batch, INFINITY_TS=JAX_INFINITY_TS)
PORT = types.SimpleNamespace(
    name="port", instance=lambda: Instance(device="cpu"), Session=Session, cdc=cdc,
    errors=errors, fail_points=FAIL_POINTS, counter=_port_counter,
    dml_batch=dml_batch, INFINITY_TS=INFINITY_TS)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    FAIL_POINTS.clear()
    JAX_FAIL_POINTS.clear()
    yield
    FAIL_POINTS.clear()
    JAX_FAIL_POINTS.clear()


def _both(scenario):
    """`scenario(engine)` through both engines; their observations must be equal.
    Returns the port's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


def fresh(eng, gsi=False):
    """An instance with `dbx.t` (and its GSI), the three batch plans registered by
    one sequential run each (after the GSI DDL, which bumps schema_version)."""
    inst = eng.instance()
    # the storms here would trip the reference's overload plane; this suite tests
    # the batcher, not the shedder (`tests/test_overload.py`)
    inst.config.set_instance("ENABLE_ADMISSION_CONTROL", 0)
    s = eng.Session(inst)
    s.execute("CREATE DATABASE dbx")
    s.execute("USE dbx")
    s.execute(DDL)
    if gsi:
        s.execute(GSI)
    s.execute(INS % (1, 1, "seed", 1))
    s.execute(UPD % (1, "seed", 1))
    s.execute(DEL % 1)
    return inst, s


def _run_threads(n, fn):
    errs = []
    barrier = threading.Barrier(n)

    def runner(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:  # pragma: no cover - assertion carrier
            errs.append(e)

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_SECONDS)
    assert not any(t.is_alive() for t in threads), "a session thread hung"
    return errs


def _storm(inst, members, fn, n=None):
    """`fn(i)` from `n` threads started together, with the DML window pinned long
    and the group cap at `members`: the statements that reach the batcher form one
    group of exactly `members`."""
    inst.config.set_instance("DML_BATCH_WINDOW_US", GROUP_WINDOW_US)
    inst.config.set_instance("BATCH_MAX_GROUP", members)
    try:
        return _run_threads(n or members, fn)
    finally:
        inst.config.set_instance("DML_BATCH_WINDOW_US", 0)
        inst.config.set_instance("BATCH_MAX_GROUP", 1024)


def _table_state(s):
    return s.execute("SELECT id, k, v, amt FROM t ORDER BY id").rows


def _gsi_state(s):
    return s.execute("SELECT id, k, amt FROM t$g_k ORDER BY id").rows


def _counters(eng, inst, *names):
    return {n: eng.counter(inst, n) for n in names}


def _workload(eng, inst, n_sessions, per):
    """Each session owns a disjoint key range (insert -> update -> insert+delete),
    so the final table does not depend on the interleaving."""
    def worker(i):
        sx = eng.Session(inst, schema="dbx")
        base = 1000 + i * 100
        for j in range(per):
            k = base + j
            sx.execute(INS % (k, k % 41, f"v{k % 13}", k % 500))
            if j % 2 == 0:
                sx.execute(UPD % (k % 300, f"u{k % 7}", k))
            if j % 3 == 0:
                sx.execute(INS % (k + 50, k % 41, "tmp", 9))
                sx.execute(DEL % (k + 50))
        sx.close()
    return _run_threads(n_sessions, worker)


def test_batched_bit_identical_100_sessions():
    """104 sessions: first one grouped INSERT each (one group of 104), then a mixed
    workload.  The batched engine's rows equal the sequential engine's and the
    reference's, and the binlog replays to them."""
    def scenario(eng):
        inst, s = fresh(eng)
        errs = _storm(inst, 104, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (50_000 + i, i % 41, "g", i)))
        assert not errs, errs[:3]
        grouped = _counters(eng, inst, "dml_batched_queries", "dml_batch_flushes")
        assert grouped == {"dml_batched_queries": 104, "dml_batch_flushes": 1}
        inst.config.set_instance("DML_BATCH_WINDOW_US", 3000)
        errs = _workload(eng, inst, 104, 6)
        assert not errs, errs[:3]
        rows = _table_state(s)
        target, ts = fresh(eng)
        eng.cdc.replay(inst.cdc.events(), target)
        assert _table_state(ts) == rows
        return rows

    rows = _both(scenario)
    inst, s = fresh(PORT)
    inst.config.set_instance("ENABLE_DML_BATCHING", 0)
    for i in range(104):
        s.execute(INS % (50_000 + i, i % 41, "g", i))
    assert not _workload(PORT, inst, 104, 6)
    assert PORT.counter(inst, "dml_batched_queries") == 0
    assert _table_state(s) == rows


def test_affected_counts_and_missing_keys():
    def scenario(eng):
        inst, s = fresh(eng)
        s.execute(INS % (10, 1, "a", 10))
        out = [s.execute(UPD % (5, "x", 10)).affected,
               s.execute(UPD % (5, "x", 999999)).affected,
               s.execute(DEL % 999999).affected, s.execute(DEL % 10).affected]
        got = {}

        def worker(i):
            got[i] = eng.Session(inst, schema="dbx").execute(
                UPD % (7, "y", 5000 + i)).affected
        assert not _storm(inst, 16, worker)
        return out, got, _counters(eng, inst, "dml_batched_queries")
    out, got, counts = _both(scenario)
    assert out == [1, 0, 0, 1] and set(got.values()) == {0}
    assert counts == {"dml_batched_queries": 16}


def test_poison_key_isolation():
    """A poisoned key (the duplicate-key stand-in) fails only its own session; the
    rest of the group lands."""
    def scenario(eng):
        inst, s = fresh(eng)
        eng.fail_points.arm(FP_DML_POISON_KEY, 6666)
        hit = []

        def worker(i):
            k = 6666 if i == 7 else 2000 + i
            try:
                eng.Session(inst, schema="dbx").execute(INS % (k, i, "p", i))
            except eng.errors.TddlError:
                raise
            except Exception as e:
                hit.append((k, type(e).__name__))
        assert not _storm(inst, 24, worker)
        eng.fail_points.clear()
        return hit, _table_state(s)
    hit, rows = _both(scenario)
    assert hit == [(6666, "FailPointError")] and len(rows) == 23


def test_not_null_violation_isolated():
    """A NOT NULL violation fails its own statement only, as the sequential
    store-level check does."""
    def scenario(eng):
        inst, s = fresh(eng)
        tpl = "INSERT INTO t (id, k, v, amt) VALUES (%s, %s, 'n', 3.25)"
        s.execute(tpl % (300, 3))
        bad = []

        def worker(i):
            try:
                eng.Session(inst, schema="dbx").execute(
                    tpl % (400 + i, "NULL" if i == 3 else i))
            except eng.errors.TddlError as e:
                bad.append(str(e))
        # the NULL member's text parameterizes apart and runs sequentially: seven
        # members reach the batcher
        assert not _storm(inst, 7, worker, n=8)
        return bad, _table_state(s), _counters(eng, inst, "dml_batched_queries")
    bad, rows, counts = _both(scenario)
    assert len(bad) == 1 and "cannot be null" in bad[0]
    assert len(rows) == 8 and counts == {"dml_batched_queries": 7}


def test_own_txn_bypass():
    """A transaction's writes bypass the batcher and keep BEGIN/ROLLBACK
    semantics."""
    def scenario(eng):
        inst, s = fresh(eng)
        before = eng.counter(inst, "dml_batched_queries")
        s.execute("BEGIN")
        s.execute(INS % (77, 7, "txn", 7))
        out = [s.execute("SELECT v FROM t WHERE id = 77").rows]
        s.execute("ROLLBACK")
        out.append(s.execute("SELECT count(*) FROM t WHERE id = 77").rows)
        s.execute("BEGIN")
        s.execute(INS % (78, 7, "txn2", 7))
        s.execute("COMMIT")
        out.append(s.execute("SELECT v FROM t WHERE id = 78").rows)
        return out, eng.counter(inst, "dml_batched_queries") - before
    out, batched = _both(scenario)
    assert out == [[("txn",)], [(0,)], [("txn2",)]] and batched == 0


def test_duplicate_key_members_fall_back():
    """Two members writing the same key depend on their order: both fall back and
    serialize on the sequential path."""
    def scenario(eng):
        inst, s = fresh(eng)
        s.execute(INS % (900, 9, "dup", 1))
        f0 = eng.counter(inst, "dml_batch_fallbacks")
        results = []

        def worker(i):
            results.append(eng.Session(inst, schema="dbx").execute(
                UPD % (10 + i, f"w{i}", 900)).affected)
        assert not _storm(inst, 2, worker)
        v = s.execute("SELECT v FROM t WHERE id = 900").rows[0][0]
        assert v in ("w0", "w1")
        return results, eng.counter(inst, "dml_batch_fallbacks") - f0
    assert _both(scenario) == ([1, 1], 2)


def test_write_conflict_isolated_per_key():
    """A row already end-stamped by a later committer conflicts for its member only;
    the co-batched member lands."""
    def scenario(eng):
        inst, s = fresh(eng)
        s.execute(INS % (910, 9, "c1", 1))
        s.execute(INS % (911, 9, "c2", 1))
        future = inst.tso.next_timestamp() + (1 << 40)
        for p in inst.store("dbx", "t").partitions:
            ids = p.key_candidates("id", 910)
            live = ids[p.end_ts[ids] == eng.INFINITY_TS]
            if live.size:
                p.end_ts[live] = future
        got = {}

        def worker(i):
            key = 910 if i == 0 else 911
            try:
                got[key] = eng.Session(inst, schema="dbx").execute(
                    UPD % (50 + i, f"z{i}", key)).affected
            except eng.errors.TransactionError as e:
                got[key] = type(e).__name__
        assert not _storm(inst, 2, worker)
        return got, s.execute("SELECT v FROM t WHERE id = 911").rows
    assert _both(scenario) == ({910: "TransactionError", 911: 1}, [("z1",)])


class TestAsyncApply:
    def test_read_your_writes_after_async_gsi_apply(self):
        """With the applier held back, a session's batched insert is visible to its
        own next read through the GSI (the fence), and the GSI converges to the
        base table."""
        def scenario(eng):
            inst, s = fresh(eng, gsi=True)
            eng.fail_points.arm(FP_APPLY_DELAY_MS, 300)
            seen = {}

            def worker(i):
                sx = eng.Session(inst, schema="dbx")
                sx.execute(INS % (3000 + i, 700 + i, "g", 100 + i))
                seen[i] = sx.execute("SELECT amt FROM t WHERE k = %d" % (700 + i)).rows
            assert not _storm(inst, 12, worker)
            eng.fail_points.clear()
            assert eng.counter(inst, "gsi_async_applies") > 0
            assert inst.applier.drain(30.0)
            return seen, _gsi_state(s), [r[:2] + r[3:] for r in _table_state(s)]
        seen, gsi, base = _both(scenario)
        assert seen == {i: [(100 + i + 0.25,)] for i in range(12)}
        assert gsi == base

    def test_update_delete_gsi_convergence(self):
        """Batched UPDATE and DELETE on a GSI-bearing table: the async delete and
        insert tasks apply in order and the index converges."""
        def scenario(eng):
            inst, s = fresh(eng, gsi=True)
            for i in range(16):
                s.execute(INS % (4000 + i, 800 + i, "u", i))

            def worker(i):
                sx = eng.Session(inst, schema="dbx")
                if i % 2 == 0:
                    sx.execute(UPD % (77, "uu", 4000 + i))
                else:
                    sx.execute(DEL % (4000 + i))
            # two statements, two groups of 8
            assert not _storm(inst, 8, worker, n=16)
            assert inst.applier.drain(30.0)
            return (_gsi_state(s), s.execute("SELECT amt FROM t WHERE k = 800").rows,
                    _counters(eng, inst, "dml_batch_flushes"))
        gsi, rows, flushes = _both(scenario)
        assert len(gsi) == 8 and rows == [(77.99,)]
        assert flushes == {"dml_batch_flushes": 2}

    def test_sync_apply_when_disabled(self):
        """ENABLE_ASYNC_APPLY = 0: GSI maintenance stays inside the flush."""
        def scenario(eng):
            inst, s = fresh(eng, gsi=True)
            inst.config.set_instance("ENABLE_ASYNC_APPLY", 0)
            a0 = eng.counter(inst, "gsi_async_applies")
            assert not _storm(inst, 8, lambda i: eng.Session(inst, schema="dbx").execute(
                INS % (5000 + i, 900 + i, "s", i)))
            return eng.counter(inst, "gsi_async_applies") - a0, _gsi_state(s)
        applied, gsi = _both(scenario)
        assert applied == 0 and len(gsi) == 8


def test_group_commit_amortizes_commit_points():
    """64 concurrent explicit transactions: every commit point and DONE row goes
    through the gate, in fewer batch writes than rows.  The gate's batch write is
    slowed (200 ms, a slow disk) so the committers queue behind it."""
    def scenario(eng):
        inst, s = fresh(eng)
        b0 = eng.counter(inst, "group_commit_batches")
        t0 = eng.counter(inst, "group_committed_txns")
        seq0 = max(r[0] for r in inst.cdc.events())
        put_many = inst.metadb.tx_log_put_many

        def slow_put_many(entries):
            threading.Event().wait(0.2)
            return put_many(entries)
        inst.metadb.tx_log_put_many = slow_put_many

        def worker(i):
            sx = eng.Session(inst, schema="dbx")
            sx.execute("BEGIN")
            sx.execute(INS % (8000 + i, i, "gc", i))
            sx.execute("COMMIT")
        assert not _run_threads(64, worker)
        txns = eng.counter(inst, "group_committed_txns") - t0
        batches = eng.counter(inst, "group_commit_batches") - b0
        assert txns == 128 and batches < txns / 4, (batches, txns)
        return s.execute("SELECT count(*) FROM t WHERE id >= 8000").rows, \
            len({e[1] for e in inst.cdc.events() if e[0] > seq0})
    assert _both(scenario) == ([(64,)], 64)


def test_cdc_coalesced_and_replays_identically():
    """One group of 32 inserts: one binlog insert event per partition it touched,
    written at one timestamp, and the log replays onto a fresh instance to the same
    rows.  The members' order inside a group is their arrival order, so the events'
    rows compare as sets."""
    def scenario(eng):
        inst, s = fresh(eng)
        seq0 = max(r[0] for r in inst.cdc.events(0))
        assert not _storm(inst, 32, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (9000 + i, i % 5, f"c{i}", i)))
        evs = [e for e in inst.cdc.events(0) if e[0] > seq0]
        target, ts = fresh(eng)
        eng.cdc.replay(inst.cdc.events(0), target)
        assert _table_state(ts) == _table_state(s)
        return (len({e[1] for e in evs}),
                sorted((e[2], e[3], e[4], sorted(map(tuple, json.loads(e[5])["rows"])))
                       for e in evs))
    n_ts, evs = _both(scenario)
    assert n_ts == 1 and [e[2] for e in evs] == ["insert"] * 4
    assert sum(len(e[3]) for e in evs) == 32


class TestHatches:
    def test_param_hatch(self):
        def scenario(eng):
            inst, s = fresh(eng)
            inst.config.set_instance("ENABLE_DML_BATCHING", 0)
            before = eng.counter(inst, "dml_batched_queries")
            assert not _run_threads(12, lambda i: eng.Session(inst, schema="dbx").execute(
                INS % (10000 + i, i, "h", i)))
            return eng.counter(inst, "dml_batched_queries") - before, \
                s.execute("SELECT count(*) FROM t WHERE id >= 10000").rows
        assert _both(scenario) == (0, [(12,)])

    def test_env_hatch(self, monkeypatch):
        def scenario(eng):
            monkeypatch.setattr(eng.dml_batch, "ENABLED", False)
            inst, s = fresh(eng)
            before = eng.counter(inst, "dml_batched_queries")
            assert not _storm(inst, 8, lambda i: eng.Session(inst, schema="dbx").execute(
                INS % (10100 + i, i, "e", i)))
            return eng.counter(inst, "dml_batched_queries") - before, len(inst.dml_plans)
        assert _both(scenario) == (0, 0)

    def test_hint_hatch(self):
        """A hinted DML statement neither registers nor batches."""
        def scenario(eng):
            inst, s = fresh(eng)
            tpl = ("/*+TDDL: DML_BATCH(OFF)*/ INSERT INTO t (id, k, v, amt) "
                   "VALUES (%d, %d, 'hint', 1.25)")
            s.execute(tpl % (10200, 1))
            key_count = len(inst.dml_plans)
            before = eng.counter(inst, "dml_batched_queries")
            assert not _storm(inst, 8, lambda i: eng.Session(inst, schema="dbx").execute(
                tpl % (10201 + i, i)))
            return len(inst.dml_plans) - key_count, \
                eng.counter(inst, "dml_batched_queries") - before
        assert _both(scenario) == (0, 0)


def test_singleton_falls_back_sequential():
    """A lone writer under a pinned window forms a group of one, which runs the
    sequential path."""
    def scenario(eng):
        inst, s = fresh(eng)
        inst.config.set_instance("DML_BATCH_WINDOW_US", 2000)
        s0 = eng.counter(inst, "dml_batch_singletons")
        s.execute(INS % (13000, 1, "solo", 1))
        return s.execute("SELECT v FROM t WHERE id = 13000").rows, \
            eng.counter(inst, "dml_batch_singletons") - s0
    assert _both(scenario) == ([("solo",)], 1)


def test_show_batch_stats_and_info_schema_rows():
    """SHOW BATCH STATS and `information_schema.batch_stats` carry the DML
    batcher's rows and the applier's backlog and lag after the read batcher's, with
    the reference's names and counter values."""
    counted = ("dml_batched_queries", "dml_batch_flushes", "dml_batch_fallbacks",
               "dml_batch_singletons", "dml_open_groups", "gsi_apply_backlog")

    def scenario(eng):
        inst, s = fresh(eng)
        assert not _storm(inst, 12, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (14000 + i, i, "st", i)))
        rows = s.execute("SHOW BATCH STATS").rows
        names = [n for n, _v in rows if n.startswith(("dml_", "gsi_"))]
        irows = dict(s.execute(
            "SELECT stat_name, value FROM information_schema.batch_stats").rows)
        return names, {n: v for n, v in rows if n in counted}, \
            {n: irows[n] for n in counted}
    names, shown, info = _both(scenario)
    assert shown == info and shown["dml_batched_queries"] == 12
    assert names[-2:] == ["gsi_apply_backlog", "gsi_apply_lag_ms"]


def test_gsi_scan_after_autocommit_write_is_fresh():
    """A scan of the GSI's table after sequential autocommit writes shows them: the
    GSI's version moves with every write, so no cached lane of it is served."""
    def scenario(eng):
        inst, s = fresh(eng, gsi=True)
        s.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i % 5}, 'v', {i}.5)" for i in range(100, 140)))
        q = "SELECT count(*), sum(k), sum(amt) FROM t$g_k"
        out = [s.execute(q).rows]
        for sql in (INS % (200, 4, "n", 2), UPD % (3, "x", 101), DEL % 102):
            s.execute("/*+TDDL: DML_BATCH(OFF)*/ " + sql)
            out.append(s.execute(q).rows)
        return out
    out = _both(scenario)
    assert len({tuple(r) for r in map(tuple, out)}) == 4


def test_cached_gsi_scan_not_served_half_applied():
    """While an apply is held (FP_APPLY_DELAY_MS), another session's cached scan of
    the GSI keeps serving the state from before the flush (the GSI's version has
    not moved); once the apply lands the version moves once and the scan shows
    every row.  A sequential write to the GSI-bearing table waits for the pending
    applies first (the global barrier)."""
    q = "SELECT count(*), sum(k) FROM t$g_k"

    def scenario(eng):
        inst, s = fresh(eng, gsi=True)
        s.execute("INSERT INTO t VALUES (10, 1, 'a', 1.25), (11, 2, 'b', 2.25)")
        reader = eng.Session(inst, schema="dbx")
        gtm = inst.catalog.table("dbx", "t$g_k")
        before = reader.execute(q).rows
        eng.fail_points.arm(FP_APPLY_DELAY_MS, 3000)
        assert not _storm(inst, 6, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (7000 + i, 70 + i, "h", i)))
        v0 = gtm.version
        misses = getattr(getattr(inst, "device_cache", None), "misses", None)
        held = reader.execute(q).rows
        if eng is PORT:  # the held scan was served from the cached lanes
            assert inst.device_cache.misses == misses
        assert inst.applier.pending()
        eng.fail_points.clear()
        s.execute("/*+TDDL: DML_BATCH(OFF)*/ " + DEL % 7000)  # waits for the applies
        assert not inst.applier.pending()
        after = reader.execute(q).rows
        return before, held, after, gtm.version - v0
    before, held, after, bumps = _both(scenario)
    assert held == before == [(2, 3)] and after == [(7, 3 + sum(range(71, 76)))]
    assert bumps == 2  # the drained apply batch, then the sequential DELETE


def test_flush_lookup_runs_on_the_instance_device_cache(monkeypatch):
    """The batched UPDATE/DELETE resolves its keys through `batched_point_lookup` on
    the instance's device cache (on a CUDA instance, the torch program on the card;
    the card's run is `chip_smoke.py`'s `cdc` phase)."""
    inst, s = fresh(PORT)
    for i in range(8):
        s.execute(INS % (20 + i, i, "d", i))
    calls = []
    real = dml_batch.batched_point_lookup

    def spy(*args, **kw):
        calls.append(kw.get("device_cache"))
        return real(*args, **kw)
    monkeypatch.setattr(dml_batch, "batched_point_lookup", spy)
    assert not _storm(inst, 8, lambda i: Session(inst, schema="dbx").execute(
        UPD % (i, "dc", 20 + i)))
    assert calls and all(c is inst.device_cache for c in calls)
    assert s.execute("SELECT count(*) FROM t WHERE v = 'dc'").rows == [(8,)]


# -- the checkpoint drains the applier --------------------------------------------------

def _durable(eng, data_dir):
    if eng is JAX:
        inst = JaxInstance(data_dir=data_dir, boot=False)
        inst.config.set_instance("ENABLE_COMPILE_CACHE", False)
        inst.boot()
        return inst
    return Instance(data_dir=data_dir, device="cpu")


def test_save_waits_for_a_delayed_applier(tmp_path):
    """`save()` with GSI applies held back: the checkpoint waits for them, and the
    instance booted from it holds every GSI row."""
    def scenario(eng):
        d = str(tmp_path / eng.name)
        inst = _durable(eng, d)
        inst.config.set_instance("ENABLE_ADMISSION_CONTROL", 0)
        s = eng.Session(inst)
        for sql in ("CREATE DATABASE dbx", "USE dbx", DDL, GSI, INS % (1, 1, "s", 1)):
            s.execute(sql)
        eng.fail_points.arm(FP_APPLY_DELAY_MS, 500)
        assert not _storm(inst, 10, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (100 + i, i, "d", i)))
        assert inst.applier.pending()
        inst.save()
        assert not inst.applier.pending()
        eng.fail_points.clear()
        booted = _durable(eng, d)
        bs = eng.Session(booted, "dbx")
        return _gsi_state(bs), [r[:2] + r[3:] for r in _table_state(bs)]
    gsi, base = _both(scenario)
    assert gsi == base and len(gsi) == 11


def test_save_raises_on_a_wedged_applier(tmp_path):
    """An applier that does not drain fails the checkpoint with `TddlError` (the
    drain's backstop shortened to 0.1 s here); once it drains, `save()` succeeds."""
    def scenario(eng):
        inst = _durable(eng, str(tmp_path / eng.name))
        inst.config.set_instance("ENABLE_ADMISSION_CONTROL", 0)
        s = eng.Session(inst)
        for sql in ("CREATE DATABASE dbx", "USE dbx", DDL, GSI, INS % (1, 1, "s", 1)):
            s.execute(sql)
        eng.fail_points.arm(FP_APPLY_DELAY_MS, 1500)
        assert not _storm(inst, 4, lambda i: eng.Session(inst, schema="dbx").execute(
            INS % (100 + i, i, "d", i)))
        applier = inst.applier
        applier.drain = functools.partial(type(applier).drain, applier, 0.1)
        with pytest.raises(eng.errors.TddlError, match="checkpoint aborted"):
            inst.save()
        eng.fail_points.clear()
        del applier.drain
        inst.save()
        return len(_gsi_state(s))
    assert _both(scenario) == 5
