"""The TP point-query path: the port against the JAX package on the CPU.

Three layers, each held to the reference exactly (no tolerance anywhere):

- the append-aware sorted key index (`Partition.key_index` / `key_candidates`) over
  the same lanes, stamps and appends;
- the batched point lookup's CSR `(ids, offsets)`: the port's torch program on CPU
  tensors (`force_device=True`, with and without a device cache) and its numpy
  sweep (`_host_batched_point`) against the reference's jitted program and its
  numpy sweep, over the key-bucket ladder, missing keys, more than `BATCH_MAXDUP`
  versions of a key, provisional `-txn_id` stamps, deleted and rolled-back rows and
  an appended tail;
- the session: the sequential fast path (registered PointPlans), the point scan of
  planned statements and the cross-session batch scheduler under many threads,
  each result equal to the sequential one and to the JAX engine's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from galaxysql_tpu.exec import operators as jax_ops
from galaxysql_tpu.meta import catalog as jax_catalog
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import table_store as jax_table_store
from galaxysql_tpu.types import datatype as jax_dt
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.meta import catalog
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import sysbench, table_store
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_BATCH_POISON_KEY,
                                                 FailPointError)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

INF = table_store.INFINITY_TS
TXN = 7_000_000_000_000_000_123   # a TSO-sized transaction id
SNAP = 7_000_000_000_000_000_500  # a TSO-sized snapshot after every commit below


# -- twin partitions ------------------------------------------------------------------

def _twins(key_type: str):
    """A one-partition table (k <key_type>, v INT) in each engine."""
    out = []
    for cat, dtm, store_mod in ((jax_catalog, jax_dt, jax_table_store),
                                (catalog, dt, table_store)):
        typ = dtm.from_sql_name(key_type, None, None)
        tm = cat.TableMeta("s", "t", [cat.ColumnMeta("k", typ),
                                      cat.ColumnMeta("v", dtm.from_sql_name("INT",
                                                                            None, None))])
        store = store_mod.TableStore(tm)
        out.append((store, store.partitions[0]))
    return out


def _append(parts, keys, valid, begin, end=None):
    """Appends the same rows to both twins, then stamps their end_ts."""
    n = len(keys)
    lanes = {"k": np.asarray(keys), "v": np.arange(n, dtype=np.int32)}
    valids = {"k": np.asarray(valid, np.bool_), "v": np.ones(n, np.bool_)}
    for _store, p in parts:
        start = p.num_rows
        p.append({c: a.astype(p.lanes[c].dtype) for c, a in lanes.items()}, valids, 0)
        p.begin_ts[start:] = np.asarray(begin, np.int64)
        if end is not None:
            p.end_ts[start:] = np.asarray(end, np.int64)


def _stamped(rng, n, provisional=True):
    """Stamps of every class: committed, deleted before / after SNAP, provisional
    insert and delete of TXN, rolled back (INFINITY / 0)."""
    begin = rng.integers(SNAP - 1000, SNAP - 10, n)
    end = np.full(n, INF, np.int64)
    cls = rng.integers(0, 6 if provisional else 3, n)
    end[cls == 1] = SNAP - 5                      # deleted before the snapshot
    end[cls == 2] = SNAP + 50                     # deleted after it
    begin[cls == 3] = -TXN                        # own provisional insert
    end[cls == 4] = -TXN                          # own provisional delete
    begin[cls == 5], end[cls == 5] = INF, 0       # rolled back
    return begin, end


KEY_CASES = {
    "int duplicates": ("BIGINT", lambda rng, n: rng.integers(-50, 50, n)),
    "float keys": ("DOUBLE", lambda rng, n: rng.choice(
        [-1.5, -0.0, 0.0, 0.25, 3.0, 1e30, -7.125], n)),
    "int32 keys": ("INT", lambda rng, n: rng.integers(0, 40, n)),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
@pytest.mark.parametrize("tail", [0, 37, table_store.Partition._INDEX_TAIL + 5])
def test_key_index_and_candidates_equal_reference(case, tail):
    """`key_index` and `key_candidates` equal the reference's over duplicates, NULL
    keys, float lanes, an appended tail, and a rebuild once the tail passes
    `_INDEX_TAIL`."""
    key_type, gen = KEY_CASES[case]
    rng = np.random.default_rng(sorted(KEY_CASES).index(case) * 100_000 + tail)
    twins = _twins(key_type)
    n = 3000
    keys = gen(rng, n)
    _append(twins, keys, rng.random(n) > 0.1, np.full(n, 5))
    ref_p, port_p = twins[0][1], twins[1][1]
    for p in (ref_p, port_p):
        with p.lock:
            p.key_index("k")  # built over the first n rows
    if tail:
        _append(twins, gen(rng, tail), np.ones(tail, np.bool_), np.full(tail, 6))
    with ref_p.lock, port_p.lock:
        r, g = ref_p.key_index("k"), port_p.key_index("k")
    assert r[0] == g[0] == (n + tail if tail > port_p._INDEX_TAIL else n)
    np.testing.assert_array_equal(g[1], r[1])
    np.testing.assert_array_equal(g[2], r[2])
    assert g[2].dtype == r[2].dtype
    for v in list(np.unique(keys)[:12]) + [keys[0], 12345]:
        np.testing.assert_array_equal(port_p.key_candidates("k", v),
                                      ref_p.key_candidates("k", v))


def test_truncate_and_transfer_start_a_new_index_generation():
    """Replacing lanes wholesale (TRUNCATE, `storage/transfer`) bumps `lane_gen`, so
    no sorted artifact of the old lanes is reused."""
    from galaxysql_tpu_torch.storage import transfer
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE g")
    s.execute("USE g")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    s.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    store = inst.store("g", "t")
    p = store.partitions[0]
    assert p.key_candidates("id", 2).tolist() == [1]
    gen = p.lane_gen
    s.execute("TRUNCATE TABLE t")
    assert store.partitions[0].lane_gen > gen
    s.execute("INSERT INTO t VALUES (2, 30), (1, 40)")
    assert store.partitions[0].key_candidates("id", 2).tolist() == [0]
    parts, dicts = transfer.arrays_of(store)
    moved = transfer.store_from_arrays(store.table, parts, dicts)
    assert moved.partitions[0].lane_gen == 1
    assert moved.partitions[0].key_candidates("id", 1).tolist() == [1]


# -- the batched point lookup -----------------------------------------------------------

def _lookup_state(rng, n_keys_domain=400, n=4000, tail=300):
    """Twin partitions holding every stamp class, one id with 10 versions (past
    BATCH_MAXDUP) and an appended tail past the index's n0."""
    twins = _twins("BIGINT")
    keys = rng.integers(0, n_keys_domain, n)
    keys[:10] = 77  # ten physical versions of id 77
    begin, end = _stamped(rng, n)
    valid = rng.random(n) > 0.05  # NULL keys
    _append(twins, keys, valid, begin, end)
    for _s, p in twins:
        with p.lock:
            p.key_index("k")
    tk = rng.integers(0, n_keys_domain + 50, tail)
    tk[:3] = 77
    tb, te = _stamped(rng, tail)
    _append(twins, tk, np.ones(tail, np.bool_), tb, te)
    return twins


@pytest.mark.parametrize("nkeys", [1, 4, 16, 64, 256, 1024])
@pytest.mark.parametrize("txn_id", [0, TXN])
def test_batched_point_lookup_equals_reference(nkeys, txn_id):
    """The port's CSR equals the reference's, bit for bit, on every route: the torch
    program on CPU tensors (with and without a device cache), the numpy sweep, the
    reference's jitted program and its numpy sweep."""
    rng = np.random.default_rng(nkeys * 7 + (txn_id % 97))
    (rs, rp), (ps, pp) = _lookup_state(rng)
    vals = [int(v) for v in rng.integers(0, 460, nkeys)]  # some keys missing
    vals[0] = 77
    if nkeys > 2:
        vals[1] = 10_000  # a key no row has
    want_ids, want_offs = jax_ops.batched_point_lookup(
        rs, 0, rp, "k", rs.table.version, vals, SNAP, txn_id, force_device=True)
    with rp.lock:
        host_ids, host_offs = jax_ops._host_batched_point(rp, "k", vals, SNAP, txn_id)
    np.testing.assert_array_equal(host_ids, want_ids)
    np.testing.assert_array_equal(host_offs, want_offs)
    cache = DeviceCache("cpu")
    routes = {
        "torch program": lambda: ops.batched_point_lookup(
            ps, 0, pp, "k", ps.table.version, vals, SNAP, txn_id, force_device=True),
        "torch program, cached": lambda: ops.batched_point_lookup(
            ps, 0, pp, "k", ps.table.version, vals, SNAP, txn_id,
            device_cache=cache, force_device=True),
        "numpy sweep": lambda: ops.batched_point_lookup(
            ps, 0, pp, "k", ps.table.version, vals, SNAP, txn_id, device_cache=cache),
    }
    for name, run in routes.items():
        for _ in range(2):  # the second cached run hits the device cache
            ids, offs = run()
            assert ids.dtype == want_ids.dtype and offs.dtype == want_offs.dtype, name
            np.testing.assert_array_equal(ids, want_ids, err_msg=name)
            np.testing.assert_array_equal(offs, want_offs, err_msg=name)
    assert cache.hits >= 3
    # key 77 has more than BATCH_MAXDUP candidates: the overflow path resolved it
    with pp.lock:
        assert pp.key_candidates("k", 77).size > ops.BATCH_MAXDUP
    # and the CSR is the sequential key-get's, key by key
    for j, v in enumerate(vals):
        cand = pp.key_candidates("k", v)
        keep = pp.valid["k"][cand] & table_store.visible_rows(
            pp.begin_ts[cand], pp.end_ts[cand], SNAP, txn_id)
        assert want_ids[want_offs[j]:want_offs[j + 1]].tolist() == cand[keep].tolist()


def test_batched_point_program_reads_the_rebuilt_index():
    """A tail grown past `_INDEX_TAIL` within one table version rebuilds the index
    with a larger n0; the cached sorted artifacts are keyed by (lane_gen, n0), so
    the next flush maps positions through the new permutation."""
    rng = np.random.default_rng(3)
    (rs, rp), (ps, pp) = _lookup_state(rng, tail=10)
    cache = DeviceCache("cpu")
    vals = [77, 5, 9]
    for _ in range(2):
        got = ops.batched_point_lookup(ps, 0, pp, "k", 1, vals, SNAP, 0,
                                       device_cache=cache, force_device=True)
        want = jax_ops.batched_point_lookup(rs, 0, rp, "k", 1, vals, SNAP, 0,
                                            force_device=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        m = table_store.Partition._INDEX_TAIL + 100
        b_, e_ = _stamped(rng, m, provisional=False)
        _append([(rs, rp), (ps, pp)], rng.integers(0, 400, m), np.ones(m, np.bool_),
                b_, e_)


# -- sessions -----------------------------------------------------------------------

DDL = """
    CREATE TABLE t (
        id BIGINT NOT NULL PRIMARY KEY,
        k  INT NOT NULL,
        v  VARCHAR(20),
        amt DECIMAL(12,2){index}
    ) PARTITION BY HASH(id) PARTITIONS 4
"""
ROWS = ", ".join(f"({i}, {i % 41}, 'v{i % 13}', {i}.25)" for i in range(1, 2001))


def _engines(index=""):
    """The same table in a port instance on the CPU and in the JAX engine."""
    ddl = DDL.format(index=index)
    inst = Instance(device="cpu")
    s = Session(inst)
    ji = JaxInstance()
    js = JaxSession(ji)
    for x in (s, js):
        x.execute("CREATE DATABASE bsx")
        x.execute("USE bsx")
        x.execute(ddl)
        x.execute(f"INSERT INTO t (id, k, v, amt) VALUES {ROWS}")
    return inst, s, js


@pytest.fixture()
def sess():
    inst, s, js = _engines()
    return inst, s, js


def _register(s, sql_tpl, key):
    """Two executions register the PointPlan for the template."""
    s.execute(sql_tpl % key)
    s.execute(sql_tpl % key)


def _run_threads(n, fn):
    errors = []
    barrier = threading.Barrier(n)

    def runner(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:  # pragma: no cover - assertion carrier
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a session thread did not finish"
    return errors


def _batched(inst):
    return inst.batch_scheduler.counts["batched_queries"]


def _execute_as_client(sx, sql, attempts=200):
    """Run `sql` as a client of an admission-controlled server runs it: a typed
    shed (`ServerOverloadError`, the reference's overload answer when a thread
    storm drives the TP class past its AIMD target) is retried after its
    `retry_after_ms`; any other error, or a shed that outlasts `attempts`,
    raises.  A shed statement never reached the point path, so it is counted
    once, when it runs."""
    for _ in range(attempts - 1):
        try:
            return sx.execute(sql)
        except errors.ServerOverloadError as e:
            time.sleep(e.retry_after_ms / 1000.0)
    return sx.execute(sql)


def test_batched_equal_sequential_and_reference_104_sessions(sess):
    """104 concurrent sessions: every batched result equals the sequential
    (batching-off) execution of the same statement and the JAX engine's, and
    groups actually formed."""
    inst, s, js = sess
    tpl = "SELECT v, amt FROM t WHERE id = %d"
    _register(s, tpl, 1)
    keys = list(range(1, 2001, 7)) + [999999, 1000001]
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 0)
    expected = {k: s.execute(tpl % k).rows for k in keys}
    assert expected == {k: js.execute(tpl % k).rows for k in keys}
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    inst.config.set_instance("BATCH_WINDOW_US", 3000)

    def worker(i):
        sx = Session(inst, schema="bsx")
        for j in range(8):
            k = keys[(i * 13 + j * 29) % len(keys)]
            got = _execute_as_client(sx, tpl % k).rows
            assert got == expected[k], (k, got, expected[k])
        sx.close()

    failures = _run_threads(104, worker)
    assert not failures, failures[:3]
    assert _batched(inst) > 0
    assert inst.batch_scheduler.counts["batch_flushes"] > 0
    assert inst.counters["batched_point_queries"] == _batched(inst)
    stats = dict(inst.batch_scheduler.stats_rows())
    assert stats["batch_flushes"] > 0 and stats["group_size_p50"] >= 1
    assert 0.0 <= stats["hit_ratio"] <= 1.0


@pytest.mark.parametrize("window_us", [0, 500])
def test_every_point_select_counted_once_under_thread_switching(sess, window_us):
    """More threads than cores with a shortened switch interval, the scheduler's
    window adaptive or pinned: every point select is counted exactly once, as a
    sequential fast-path query or as a batched one, and every row is right."""
    import sys
    inst, s, _js = sess
    tpl = "SELECT amt FROM t WHERE id = %d"
    _register(s, tpl, 1)
    inst.config.set_instance("BATCH_WINDOW_US", window_us)
    before = dict(inst.counters)
    batched = _batched(inst)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            sx = Session(inst, schema="bsx")
            for j in range(10):
                k = 1 + (i * 37 + j * 11) % 2000
                assert _execute_as_client(sx, tpl % k).rows == [(k + 0.25,)]
            sx.close()

        failures = _run_threads(48, worker)
    finally:
        sys.setswitchinterval(old)
    assert not failures, failures[:3]
    # the two path counters (the registry's engine_* map also holds the
    # per-engine query counters of the metrics, `engine_exec_<engine>`)
    counted = sum(inst.counters[k] - before.get(k, 0)
                  for k in ("point_plan_queries", "batched_point_queries"))
    assert counted == 480
    assert inst.counters["batched_point_queries"] - \
        before.get("batched_point_queries", 0) == _batched(inst) - batched


def test_multi_row_non_unique_key_row_order():
    """A non-unique indexed key (an inline INDEX) returns several rows; the batched
    gather reproduces the sequential path's row ORDER (partition order, then
    ascending row ids) and the JAX engine's."""
    inst, s, js = _engines(index=",\n        INDEX i_k (k)")
    s.execute("ANALYZE TABLE t")
    js.execute("ANALYZE TABLE t")
    tpl = "SELECT id, amt FROM t WHERE k = %d"
    _register(s, tpl, 5)
    assert inst.point_plans
    keys = list(range(41))
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 0)
    expected = {k: s.execute(tpl % k).rows for k in keys}
    assert any(len(r) > 10 for r in expected.values())
    assert expected == {k: js.execute(tpl % k).rows for k in keys}
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    inst.config.set_instance("BATCH_WINDOW_US", 3000)

    def worker(i):
        sx = Session(inst, schema="bsx")
        for j in range(4):
            k = keys[(i * 7 + j) % len(keys)]
            got = sx.execute(tpl % k).rows
            assert got == expected[k], (k, len(got), len(expected[k]))
        sx.close()

    errors = _run_threads(24, worker)
    assert not errors, errors[:3]
    assert _batched(inst) > 0


def test_error_isolation_poisoned_key(sess):
    """A poisoned key inside a group fails ONLY its own session; every other member
    of the same flush gets its correct rows."""
    inst, s, _js = sess
    tpl = "SELECT amt FROM t WHERE id = %d"
    _register(s, tpl, 1)
    inst.config.set_instance("BATCH_WINDOW_US", 20000)
    poisoned_key = 777
    FAIL_POINTS.arm(FP_BATCH_POISON_KEY, poisoned_key)
    outcomes = {}
    lock = threading.Lock()
    try:
        def worker(i):
            sx = Session(inst, schema="bsx")
            key = poisoned_key if i == 3 else 100 + i
            try:
                rows = sx.execute(tpl % key).rows
                with lock:
                    outcomes[i] = rows
            except FailPointError:
                with lock:
                    outcomes[i] = "poisoned"
            finally:
                sx.close()

        errors = _run_threads(8, worker)
        assert not errors, errors[:3]
    finally:
        FAIL_POINTS.disarm(FP_BATCH_POISON_KEY)
    assert outcomes[3] == "poisoned"
    for i in range(8):
        if i != 3:
            assert outcomes[i] == [(100 + i + 0.25,)], (i, outcomes[i])


def test_txn_write_bypass_and_snapshot_semantics(sess):
    """Sessions inside a writing transaction bypass batching (own provisional stamps
    stay own-visible); read-only transactions keep their pinned snapshot; autocommit
    sessions see committed writes through the batched path.  The JAX engine runs
    the same statements and agrees."""
    inst, s, js = sess
    tpl = "SELECT amt FROM t WHERE id = %d"
    _register(s, tpl, 42)
    _register(js, tpl, 42)
    inst.config.set_instance("BATCH_WINDOW_US", 2000)
    js2 = JaxSession(js.instance)
    js2.execute("USE bsx")
    js3 = JaxSession(js.instance)
    js3.execute("USE bsx")

    def both(px, jx, sql):
        got, want = px.execute(sql).rows, jx.execute(sql).rows
        assert got == want, (sql, got, want)
        return got

    # writing txn: sees its own uncommitted write, bypassing the group path
    both(s, js, "BEGIN")
    both(s, js, "UPDATE t SET amt = 777.77 WHERE id = 42")
    before = _batched(inst)
    assert both(s, js, tpl % 42) == [(777.77,)]
    # the reference's trace layout: the trace id first, then the path's lines
    assert s.last_trace[0].startswith("trace-id ")
    assert s.last_trace[1] == "point-plan t.id"
    # a concurrent autocommit session must NOT see it
    s2 = Session(inst, schema="bsx")
    assert both(s2, js2, tpl % 42) == [(42.25,)]
    both(s, js, "COMMIT")
    # read-only txn pinned BEFORE an update commits keeps the old snapshot
    s3 = Session(inst, schema="bsx")
    both(s3, js3, "BEGIN")
    assert both(s3, js3, tpl % 42) == [(777.77,)]
    both(s2, js2, "UPDATE t SET amt = 888.88 WHERE id = 42")
    assert both(s3, js3, tpl % 42) == [(777.77,)]
    assert _batched(inst) == before

    # a read-only transaction groups with sessions pinned to its snapshot only
    results = {}
    lock = threading.Lock()

    def pinned_worker(i):
        sx = Session(inst, schema="bsx")
        if i % 2:
            sx.txn = s3.txn  # pinned to s3's snapshot (read only)
        rows = sx.execute(tpl % 42).rows
        with lock:
            results[i] = rows
        sx.txn = None
        sx.close()

    errors = _run_threads(8, pinned_worker)
    assert not errors, errors[:3]
    for i, rows in results.items():
        assert rows == ([(777.77,)] if i % 2 else [(888.88,)]), (i, rows)
    both(s3, js3, "ROLLBACK")

    # autocommit group sees the committed value: a real batched group
    results.clear()

    def worker(i):
        sx = Session(inst, schema="bsx")
        with lock:
            results[i] = sx.execute(tpl % 42).rows
        sx.close()

    errors = _run_threads(8, worker)
    assert not errors, errors[:3]
    for i, rows in results.items():
        assert rows == [(888.88,)], (i, rows)
    assert _batched(inst) > before
    assert js.execute(tpl % 42).rows == [(888.88,)]


def test_append_tail_visible_in_batched_lookup(sess):
    """Rows appended after the sorted index was built (the unsorted tail) surface
    through the batched path's host-side tail probe."""
    inst, s, js = sess
    tpl = "SELECT amt FROM t WHERE id = %d"
    _register(s, tpl, 1)
    store = inst.store("bsx", "t")
    for p in store.partitions:
        with p.lock:
            p.key_index("id")  # the sorted index of every partition, before the insert
    for x in (s, js):
        x.execute("INSERT INTO t (id, k, v, amt) VALUES (5001, 1, 'x', 9.99)")
    inst.config.set_instance("BATCH_WINDOW_US", 3000)
    results = {}
    lock = threading.Lock()

    def worker(i):
        sx = Session(inst, schema="bsx")
        key = 5001 if i % 2 == 0 else 1 + i
        with lock:
            results[i] = (key, sx.execute(tpl % key).rows)
        sx.close()

    errors = _run_threads(8, worker)
    assert not errors, errors[:3]
    for i, (key, rows) in results.items():
        want = [(9.99,)] if key == 5001 else [(key + 0.25,)]
        assert rows == want == js.execute(tpl % key).rows, (key, rows)
    tails = []
    for p in store.partitions:
        with p.lock:
            tails.append(p.num_rows - p.key_index("id")[0])
    assert sorted(tails) == [0, 0, 0, 1]


def test_escape_hatches(sess):
    """ENABLE_BATCH_SCHEDULER=0 keeps every query on the sequential path; a
    BATCH(OFF)-hinted statement registers no PointPlan and stays correct on the
    planned path."""
    inst, s, _js = sess
    tpl = "SELECT amt FROM t WHERE id = %d"
    _register(s, tpl, 7)
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 0)
    inst.config.set_instance("BATCH_WINDOW_US", 3000)
    before = _batched(inst)
    point_before = inst.counters["point_plan_queries"]

    def worker(i):
        sx = Session(inst, schema="bsx")
        assert sx.execute(tpl % (10 + i)).rows == [(10 + i + 0.25,)]
        sx.close()

    errors = _run_threads(8, worker)
    assert not errors, errors[:3]
    assert _batched(inst) == before
    assert inst.counters["point_plan_queries"] == point_before + 8
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    from galaxysql_tpu_torch.sql.hints import parse_hints
    assert parse_hints("/*+TDDL: BATCH(OFF)*/")["batch"] == "off"
    plans = dict(inst.point_plans)
    r = s.execute("/*+TDDL: BATCH(OFF)*/ SELECT amt FROM t WHERE id = 7")
    assert r.rows == [(7.25,)]
    assert inst.point_plans == plans
    assert any(line.startswith("point-get t p") for line in s.last_trace)


# -- the sequential fast path and the point scan --------------------------------------

POINT_SQL = [
    "SELECT v, amt FROM t WHERE id = {}",
    "SELECT * FROM t WHERE id = {}",
    "SELECT amt, id FROM t WHERE {} = id",
]


def test_sequential_fast_path_equals_planned_and_reference(sess):
    """The fast path's rows equal the planned path's and the JAX engine's, for
    present, missing and NULL keys, before and after a table change that bumps
    `schema_version` (the PointPlan is dropped and registered again) and after a
    TRUNCATE and reload (new partitions, a new index generation)."""
    inst, s, js = sess
    keys = [1, 2, 1999, 2000, 0, 123456]

    def check(phase):
        for tpl in POINT_SQL:
            for k in keys:
                sql = tpl.format(k)
                planned = s.execute(sql)
                fast = s.execute(sql)
                assert fast.rows == planned.rows == js.execute(sql).rows, (phase, sql)
                assert fast.names == planned.names
                assert [t.clazz for t in fast.types] == [t.clazz for t in planned.types]
                assert s.last_trace[1].startswith("point-plan"), (phase, sql)
            inst.point_plans.clear()
        for sql in ("SELECT amt FROM t WHERE id = NULL",
                    "SELECT amt FROM t WHERE id = -3"):  # `-?` is no point plan
            assert s.execute(sql).rows == [] == js.execute(sql).rows

    check("loaded")
    assert inst.counters["point_plan_queries"] >= len(POINT_SQL) * len(keys)
    s.execute(POINT_SQL[0].format(5))
    s.execute(POINT_SQL[0].format(5))
    assert inst.point_plans
    version = inst.catalog.schema_version
    for x in (s, js):
        x.execute("CREATE TABLE other (a INT PRIMARY KEY)")
    assert inst.catalog.schema_version > version
    rs = s.execute(POINT_SQL[0].format(6))  # the stale plan is dropped, planned again
    assert any(t.startswith(("scan", "point-get")) for t in s.last_trace)
    assert not any(t.startswith("point-plan") for t in s.last_trace)
    assert rs.rows == js.execute(POINT_SQL[0].format(6)).rows
    check("after CREATE TABLE")
    for x in (s, js):
        x.execute("TRUNCATE TABLE t")
        x.execute("INSERT INTO t (id, k, v, amt) VALUES (2, 3, 'b', 4.5), "
                  "(1, 9, NULL, 0.75), (123456, 1, 'c', 1.0)")
    check("after TRUNCATE")


@pytest.mark.parametrize("sql", [
    "SELECT id, v FROM t WHERE id = 17 AND k = 17",
    "SELECT id, v FROM t WHERE id = 17 AND k = 16",
    "SELECT COUNT(*), SUM(amt) FROM t WHERE id = 123456",
    "SELECT COUNT(*), SUM(amt) FROM t WHERE id = 40",
    "SELECT v FROM t WHERE id = 40 OR id = 41 ORDER BY v",
    "SELECT t.v, u.amt FROM t JOIN t u ON t.k = u.k WHERE t.id = 5 ORDER BY u.amt",
])
def test_point_scan_equals_reference(sess, sql):
    """Planned statements with a point predicate read index candidates (the scan's
    `point_eq`), across a transaction's own writes too; rows equal the JAX
    engine's."""
    inst, s, js = sess
    assert s.execute(sql).rows == js.execute(sql).rows
    for x in (s, js):
        x.execute("BEGIN")
        x.execute("UPDATE t SET amt = amt + 1 WHERE id IN (5, 17, 40)")
        x.execute("DELETE FROM t WHERE id = 41")
    assert s.execute(sql).rows == js.execute(sql).rows
    for x in (s, js):
        x.execute("ROLLBACK")
    assert s.execute(sql).rows == js.execute(sql).rows


def test_sysbench_point_select_statements():
    """`sysbench.point_select` gives `oltp_point_select`'s statement, which the port
    serves through a registered PointPlan with the JAX engine's rows."""
    rows = 3000
    data = sysbench.generate(rows, seed=5)
    inst = Instance(device="cpu")
    s = Session(inst)
    ji = JaxInstance()
    js = JaxSession(ji)
    for x, i in ((s, inst), (js, ji)):
        x.execute("CREATE DATABASE sb")
        x.execute("USE sb")
        x.execute(sysbench.ddl())
        i.store("sb", "sbtest1").insert_arrays(data, i.tso.next_timestamp())
    stmts = sysbench.point_select(np.random.default_rng(1), rows, 40)
    assert all(q.startswith("SELECT c FROM sbtest1 WHERE id=") for q in stmts)
    for q in stmts:
        assert s.execute(q).rows == js.execute(q).rows
    assert inst.counters["point_plan_queries"] >= 38
