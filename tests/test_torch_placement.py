"""The placement slice in the port against the JAX package on the CPU: SPLIT / MERGE /
MOVE PARTITION (`ddl/rebalance.py`), the online repartition (`ddl/repartition.py`),
the heat-driven balancer (`server/balancer.py`), CHECK TABLE with FastChecker
(`utils/fastchecker.py`), SHOW REBALANCE and `information_schema.rebalance_jobs`,
sequences (`meta/sequence.py`) and moving a worker-resident table
(`Instance.move_remote_table`).  The counterparts of `tests/test_rebalance.py`,
`tests/test_repartition.py`, `tests/test_aux.py::TestSequences` and
`tests/test_worker_process.py::...::test_move_table_between_workers`.

Every scenario runs once through a JAX `Instance` and once through a port
`Instance(device="cpu")` (`torch_plane_harness.both`) and returns what the two must
agree on: rows, partition counts and groups, progress rows (the catchup lag, a wall
time, and the router epoch, a process-wide counter, left out), FastChecker
checksums, proposals, error types and messages, and events.  Where a scenario races
threads, each package is held to its own invariants (no acknowledged write lost,
none duplicated) and the outcomes are those invariants."""

import importlib
import threading
import time

import numpy as np
import pytest

from torch_plane_harness import both

pytestmark = pytest.mark.torch_port


def mod(pkg, rel: str):
    root = "galaxysql_tpu" if pkg.name == "jax" else "galaxysql_tpu_torch"
    return importlib.import_module(f"{root}.{rel}")


def fresh(pkg, schema="rb"):
    inst = pkg.Instance()
    s = pkg.Session(inst)
    s.execute(f"CREATE DATABASE {schema}")
    s.execute(f"USE {schema}")
    return inst, s


def load(s, n=2000, parts=4, table="t", schema="rb"):
    s.execute(f"CREATE TABLE {table} (id BIGINT PRIMARY KEY, grp BIGINT, "
              f"val VARCHAR(16)) PARTITION BY HASH(id) PARTITIONS {parts}")
    store = s.instance.store(schema, table)
    store.insert_pylists(
        {"id": list(range(n)), "grp": [i % 37 for i in range(n)],
         "val": [f"v{i % 11}" for i in range(n)]}, s.instance.tso.next_timestamp())
    return store


def snapshot(s, table="t"):
    return s.execute(f"SELECT id, grp, val FROM {table} ORDER BY id").rows


def routed_home(store) -> bool:
    """Every physical row lives where the live router places it."""
    tm = store.table
    cols = [tm.column(c).name for c in tm.partition.columns]
    return all(bool((store.router.route_rows([p.lanes[c] for c in cols]) == pid).all())
               for pid, p in enumerate(store.partitions) if p.num_rows)


def progress(s):
    """SHOW REBALANCE without the lag (a wall time) and with the router epoch (a
    process-wide counter) as whether one was recorded."""
    return [r[:9] + (r[10], r[11] > 0) for r in s.execute("SHOW REBALANCE").rows]


def checksum(pkg, inst, schema, table):
    fc = mod(pkg, "utils.fastchecker")
    tm = inst.catalog.table(schema, table)
    return fc.table_checksum(inst.store(schema, table), tm.column_names(), None)


def err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and message are the outcome
        return type(e).__name__, str(e)
    return None


def rebalance_events(pkg):
    return [(e.kind, e.detail) for e in pkg.EVENTS.entries(kind="rebalance")]


def left_kv(inst):
    return [k for k, _ in inst.metadb.kv_scan("rebal.") if ".hist." not in k]


# -- SPLIT / MERGE / MOVE -------------------------------------------------------------


def test_bucket_conversion_is_routing_identical():
    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=10, parts=4)
        cat, rb = mod(pkg, "meta.catalog"), mod(pkg, "ddl.rebalance")
        tm = inst.catalog.table("rb", "t")
        keys = [np.arange(200_000, dtype=np.int64)]
        before = cat.PartitionRouter(tm).route_rows(keys)
        info2 = cat.PartitionInfo("hash", ["id"], 4, [],
                                  [b % 4 for b in range(4 * rb.BUCKETS_PER)])
        after = cat.PartitionRouter(tm, info2).route_rows(keys)
        return bool((before == after).all()), before.tolist()[:64]
    assert both(scenario)[0]


MOVES = {
    "split": "ALTER TABLE t SPLIT PARTITION p1 INTO 3",
    "merge": "ALTER TABLE t MERGE PARTITIONS p0, p2",
    "move": "ALTER TABLE t MOVE PARTITION p2 TO 'g1'",
    "repartition": "ALTER TABLE t PARTITION BY HASH(grp) PARTITIONS 8",
}


@pytest.mark.parametrize("kind", sorted(MOVES))
def test_move_keeps_rows_and_caches_fresh(kind):
    """Each placement change end to end, with the table's lanes warm in the device
    cache and the fragment cache before it: the same queries after the cutover
    (a scan, a join, a group-by, a point select of every key) give the rows they
    gave before, in both packages; new writes route by the new map; the job's
    state is cleaned up."""
    queries = ["SELECT id, grp, val FROM t ORDER BY id",
               "SELECT grp, count(*), max(val) FROM t GROUP BY grp ORDER BY grp",
               "SELECT t.grp, count(*) FROM t, t u WHERE t.id = u.grp GROUP BY t.grp "
               "ORDER BY t.grp"]

    def scenario(pkg):
        inst, s = fresh(pkg)
        store = load(s, n=2000, parts=4)
        s.execute("DELETE FROM t WHERE id % 10 = 3")
        before = [s.execute(q).rows for q in queries]
        points0 = [s.execute(f"SELECT val FROM t WHERE id = {k}").rows
                   for k in range(0, 2000, 7)]
        physical = [p.num_rows for p in store.partitions]
        s.execute(MOVES[kind])
        tm = inst.catalog.table("rb", "t")
        after = [s.execute(q).rows for q in queries]
        points = [s.execute(f"SELECT val FROM t WHERE id = {k}").rows
                  for k in range(0, 2000, 7)]
        s.execute("INSERT INTO t VALUES (777777, 3, 'nv')")
        s.execute("DELETE FROM t WHERE id = 8")
        tail = (s.execute("SELECT grp FROM t WHERE id = 777777").rows,
                s.execute("SELECT count(*) FROM t").rows)
        return (after == before, points == points0, after, tail,
                tm.partition.num_partitions, list(tm.partition.columns),
                [tm.partition.group_of(i) for i in range(tm.partition.num_partitions)],
                physical, [p.num_rows for p in store.partitions],
                routed_home(store), not inst.rebalance_shadows, left_kv(inst),
                progress(s), checksum(pkg, inst, "rb", "t"), rebalance_events(pkg))
    out = both(scenario)
    assert out[0] and out[1] and out[9] and out[10] and out[11] == []
    assert out[3] == ([(3,)], [(1800,)])
    assert out[4] == {"split": 6, "merge": 3, "move": 4, "repartition": 8}[kind]
    if kind == "move":
        assert out[6][2] == "g1" and out[6][1] != "g1"
        assert out[8][2] < out[7][2]  # the rebuilt partition dropped dead versions


def test_point_selects_of_every_key_after_a_split_sequential_and_batched():
    """After a split (the hash table converted to the bucket map) every key is
    found by the sequential point path and, in the port, by the cross-session
    batch scheduler, with the reference's rows."""
    keys = list(range(0, 3000, 3))
    tpl = "SELECT grp, val FROM t WHERE id = %d"

    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=3000, parts=4)
        for _ in range(2):
            s.execute(tpl % 1)  # registers the point plan
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 4")
        s.execute("ALTER TABLE t SPLIT PARTITION p5 INTO 2")
        inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 0)
        seq = {k: s.execute(tpl % k).rows for k in keys}
        batched_ok = None
        if pkg.name == "port":
            inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
            inst.config.set_instance("BATCH_WINDOW_US", 3000)
            bad = []

            def worker(i):
                sx = pkg.Session(inst, schema="rb")
                for k in keys[i::16]:
                    for _ in range(50):
                        try:
                            got = sx.execute(tpl % k).rows
                            break
                        except pkg.errors.ServerOverloadError as e:
                            time.sleep(e.retry_after_ms / 1000.0)
                    if got != seq[k]:
                        bad.append(k)
                sx.close()
            ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            batched_ok = (not bad, inst.batch_scheduler.counts["batched_queries"] > 0)
        return seq, inst.catalog.table("rb", "t").partition.num_partitions, batched_ok
    got = {}

    def run(pkg):
        seq, n, batched = scenario(pkg)
        got[pkg.name] = batched
        return seq, n
    seq, n = both(run)
    assert n == 8 and all(len(seq[k]) == 1 for k in keys)
    assert got["port"] == (True, True)


def test_range_split_at_and_merge():
    def scenario(pkg):
        inst, s = fresh(pkg)
        s.execute("CREATE TABLE r (id BIGINT PRIMARY KEY, d BIGINT) "
                  "PARTITION BY RANGE(d) (PARTITION r0 VALUES LESS THAN (100), "
                  "PARTITION r1 VALUES LESS THAN (MAXVALUE))")
        store = inst.store("rb", "r")
        store.insert_pylists({"id": list(range(600)), "d": [i % 200 for i in range(600)]},
                             inst.tso.next_timestamp())
        before = s.execute("SELECT id, d FROM r ORDER BY id").rows
        s.execute("ALTER TABLE r SPLIT PARTITION p0 AT (50)")
        tm = inst.catalog.table("rb", "r")
        out = [tm.partition.num_partitions, [b[1][0] for b in tm.partition.boundaries],
               s.execute("SELECT id, d FROM r ORDER BY id").rows == before,
               [p.num_rows for p in store.partitions]]
        s.execute("ALTER TABLE r MERGE PARTITIONS p1, p2")
        out += [inst.catalog.table("rb", "r").partition.num_partitions,
                s.execute("SELECT id, d FROM r ORDER BY id").rows == before,
                s.execute("SELECT count(*) FROM r WHERE d < 50").rows]
        return out
    out = both(scenario)
    assert out[:3] == [3, [50, 100, None], True] and out[4:6] == [2, True]


def test_split_keeps_gsi_consistent_and_check_table_ok():
    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=1200, parts=4)
        s.execute("CREATE GLOBAL INDEX g_grp ON t (grp) COVERING (val)")
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
        res = mod(pkg, "utils.fastchecker").check_gsi(inst, "rb", "t", "g_grp")
        return (res, s.execute("SELECT count(*) FROM t WHERE grp = 5").rows,
                s.execute("CHECK TABLE t").rows)
    res, count, check = both(scenario)
    assert res["consistent"] and count[0][0] > 0 and check == [("rb.t", "check", "status",
                                                                "OK")]


def test_unsupported_shapes_and_arguments_are_typed():
    def scenario(pkg):
        inst, s = fresh(pkg)
        s.execute("CREATE TABLE s1 (id BIGINT PRIMARY KEY) SINGLE")
        s.execute("CREATE TABLE nk (id BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 2")
        load(s, n=10, parts=2, table="cdcoff")
        load(s, n=200, parts=2)
        s.execute("CREATE TABLE rv (id BIGINT PRIMARY KEY, d BIGINT) "
                  "PARTITION BY RANGE(d) (PARTITION r0 VALUES LESS THAN (100), "
                  "PARTITION r1 VALUES LESS THAN (MAXVALUE))")
        out = [err(lambda: s.execute("ALTER TABLE s1 MOVE PARTITION p0 TO 'g1'")),
               err(lambda: s.execute("ALTER TABLE nk SPLIT PARTITION p0")),
               err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 0")),
               err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 1")),
               err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 AT (5)")),
               err(lambda: s.execute("ALTER TABLE rv SPLIT PARTITION p0 AT (50) INTO 3")),
               err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p9")),
               err(lambda: s.execute("ALTER TABLE t ADD COLUMN x BIGINT, "
                                     "PARTITION BY HASH(id) PARTITIONS 4"))]
        s.execute("SET GLOBAL ENABLE_CDC = 0")
        out.append(err(lambda: s.execute("ALTER TABLE cdcoff SPLIT PARTITION p0")))
        s.execute("SET GLOBAL ENABLE_CDC = 1")
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
        out += [len(inst.store("rb", "t").partitions), routed_home(inst.store("rb", "t")),
                s.execute("SELECT job_id, state FROM information_schema.ddl_jobs "
                          "ORDER BY job_id").rows]
        return out
    out = both(scenario)
    assert all(e is not None for e in out[:9]) and out[9:11] == [3, True]


# -- crash-resume at each failpoint ---------------------------------------------------


def test_crash_mid_backfill_resumes_from_checkpoint():
    def scenario(pkg):
        inst, s = fresh(pkg)
        rb = mod(pkg, "ddl.rebalance")
        store = load(s, n=3000, parts=2)
        before = snapshot(s)
        old = rb.RebalanceBackfillTask.CHUNK
        rb.RebalanceBackfillTask.CHUNK = 128
        try:
            pkg.FAIL_POINTS.arm(pkg.fp.FP_REBALANCE_CHUNK, 4)
            crash = err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2"))
            parked = bool(inst.rebalance_shadows)
            live = [r for r in progress(s) if r[3] == "RUNNING"]
            serving = snapshot(s) == before
            s.execute("INSERT INTO t VALUES (888888, 1, 'mid')")
            pkg.FAIL_POINTS.clear()
            resumed = inst.ddl_engine.recover()
        finally:
            rb.RebalanceBackfillTask.CHUNK = old
        return (crash[0], parked, live, serving, bool(resumed),
                inst.catalog.table("rb", "t").partition.num_partitions,
                snapshot(s) == sorted(before + [(888888, 1, "mid")]), routed_home(store),
                progress(s))
    out = both(scenario)
    assert out[0] == "FailPointError" and out[1] and out[2][0][4] == "backfill"
    assert out[3:8] == (True, True, 3, True, True)


def test_crash_mid_catchup_is_idempotent():
    def scenario(pkg):
        inst, s = fresh(pkg)
        store = load(s, n=1000, parts=2)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_REBALANCE_CHUNK, 1)
        first = err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2"))
        pkg.FAIL_POINTS.clear()
        s.execute("UPDATE t SET val = 'x' WHERE id < 50")
        s.execute("DELETE FROM t WHERE id BETWEEN 100 AND 120")
        s.execute("INSERT INTO t VALUES (555555, 5, 'late')")
        before = snapshot(s)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_REBALANCE_CATCHUP, 1)
        second = err(inst.ddl_engine.recover)
        pkg.FAIL_POINTS.clear()
        resumed = bool(inst.ddl_engine.recover())
        return (first[0], second[0], resumed,
                inst.catalog.table("rb", "t").partition.num_partitions,
                snapshot(s) == before, routed_home(store), progress(s),
                checksum(pkg, inst, "rb", "t"))
    assert both(scenario)[:6] == ("FailPointError", "FailPointError", True, 3, True, True)


@pytest.mark.parametrize("where", ["before", "after"])
def test_crash_at_the_swap(where):
    """FP_REBALANCE_BEFORE_SWAP leaves the old map serving and the resume swaps;
    FP_REBALANCE_AFTER_SWAP has swapped durably and the resume publishes without
    swapping again."""
    def scenario(pkg):
        inst, s = fresh(pkg)
        store = load(s, n=800, parts=2)
        before = snapshot(s)
        fp = pkg.fp.FP_REBALANCE_BEFORE_SWAP if where == "before" else \
            pkg.fp.FP_REBALANCE_AFTER_SWAP
        sql = "ALTER TABLE t MERGE PARTITIONS p0, p1" if where == "before" else \
            "ALTER TABLE t SPLIT PARTITION p1 INTO 2"
        pkg.FAIL_POINTS.arm(fp, True)
        crash = err(lambda: s.execute(sql))
        mid = (len(store.partitions), snapshot(s) == before)
        pkg.FAIL_POINTS.clear()
        parts = store.partitions
        resumed = bool(inst.ddl_engine.recover())
        return (crash[0], mid, resumed, len(store.partitions),
                store.partitions is parts, snapshot(s) == before, routed_home(store),
                left_kv(inst), progress(s))
    out = both(scenario)
    assert out[0] == "FailPointError" and out[2] and out[5] and out[6] and out[7] == []
    assert out[1] == ((2, True) if where == "before" else (3, True))
    assert out[4] == (where == "after")


def test_verify_mismatch_rolls_back_source_byte_identical():
    def scenario(pkg):
        inst, s = fresh(pkg)
        fc = mod(pkg, "utils.fastchecker")
        store = load(s, n=1000, parts=2)
        tm = inst.catalog.table("rb", "t")
        cols = tm.column_names()
        ts0 = inst.tso.next_timestamp()
        chk0 = fc.partitions_checksum(store.partitions, cols, ts0)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_REBALANCE_VERIFY_MISMATCH, True)
        e = err(lambda: s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2"))
        pkg.FAIL_POINTS.clear()
        out = (e[0], "verify failed" in e[1],
               fc.partitions_checksum(store.partitions, cols, ts0) == chk0, chk0,
               tm.partition.num_partitions, not inst.rebalance_shadows, left_kv(inst),
               progress(s))
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
        return out + (tm.partition.num_partitions,)
    out = both(scenario)
    assert out[:3] == ("TddlError", True, True) and out[4:7] == (2, True, [])
    assert out[-1] == 3


@pytest.mark.parametrize("midflight", [False, True])
def test_cutover_drains_open_transactions(midflight):
    """An open transaction holding rows of the table, and (midflight) a commit whose
    session already cleared its transaction but whose provisional stamps still sit
    in the moved partition: the cutover waits, then fails typed and leaves the
    source serving; once the commit lands the move goes through."""
    def scenario(pkg):
        inst, s = fresh(pkg)
        store = load(s, n=400, parts=2)
        wid = next(i for i in range(999002, 999400)
                   if int(store.router.route_rows(
                       [np.asarray([i], dtype=np.int64)])[0]) == 0)
        s2 = pkg.Session(inst, "rb")
        try:
            s2.execute("BEGIN")
            s2.execute(f"INSERT INTO t VALUES ({wid}, 1, 'txn')")
            txn = s2.txn
            if midflight:
                s2.txn = None
            inst.config.set_instance("REBALANCE_DRAIN_TIMEOUT_S", 0.3)
            e = err(lambda: s.execute("ALTER TABLE t MOVE PARTITION p0 TO 'g1'"))
            s2.txn = txn
            s2.execute("COMMIT")
            inst.config.set_instance("REBALANCE_DRAIN_TIMEOUT_S", 30.0)
            s.execute("ALTER TABLE t MOVE PARTITION p0 TO 'g1'")
            return (e, inst.catalog.table("rb", "t").partition.group_of(0),
                    s.execute("SELECT count(*) FROM t").rows,
                    s.execute(f"SELECT val FROM t WHERE id = {wid}").rows)
        finally:
            s2.close()
    e, group, count, row = both(scenario)
    assert e[0] == "TddlError" and "pin the table" in e[1]
    assert (group, count, row) == ("g1", [(401,)], [("txn",)])


def test_rebalance_writes_no_binlog_events():
    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=500, parts=2)
        n0 = len(inst.cdc.events(0, limit=100000))
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
        s.execute("ALTER TABLE t PARTITION BY HASH(grp) PARTITIONS 3")
        return n0, len(inst.cdc.events(0, limit=100000))
    n0, n1 = both(scenario)
    assert n0 == n1


def test_split_under_concurrent_writes_loses_nothing():
    def scenario(pkg):
        inst, s = fresh(pkg)
        rb = mod(pkg, "ddl.rebalance")
        store = load(s, n=4000, parts=2)
        old = rb.RebalanceBackfillTask.CHUNK
        rb.RebalanceBackfillTask.CHUNK = 256
        acked = {"ins": [], "del": [], "errs": []}
        stop = threading.Event()

        def writer(base):
            sx = pkg.Session(inst, "rb")
            try:
                i = 0
                while not stop.is_set() and i < 150:
                    wid = base + i
                    try:
                        sx.execute(f"INSERT INTO t VALUES ({wid}, {wid % 37}, 'w')")
                        acked["ins"].append(wid)
                        if i % 7 == 3:
                            sx.execute(f"DELETE FROM t WHERE id = {wid}")
                            acked["del"].append(wid)
                    except pkg.errors.TddlError as e:
                        acked["errs"].append(str(e))
                    i += 1
            finally:
                sx.close()
        ts = [threading.Thread(target=writer, args=(1_000_000 * (k + 1),))
              for k in range(3)]
        for t in ts:
            t.start()
        try:
            s.execute("ALTER TABLE t SPLIT PARTITION p1 INTO 3")
        finally:
            stop.set()
            for t in ts:
                t.join()
            rb.RebalanceBackfillTask.CHUNK = old
        got = [r[0] for r in s.execute("SELECT id FROM t WHERE id >= 1000000").rows]
        return (sorted(got) == sorted(set(acked["ins"]) - set(acked["del"])),
                len(got) == len(set(got)),
                s.execute("SELECT count(*) FROM t WHERE id < 1000000").rows,
                routed_home(store), len(store.partitions))
    assert both(scenario) == (True, True, [(4000,)], True, 4)


# -- the balancer ---------------------------------------------------------------------


def _hot_table(pkg, s, hot_rows=6000, cold_rows=200):
    inst = s.instance
    s.execute("CREATE TABLE h (id BIGINT PRIMARY KEY, k BIGINT, v BIGINT) "
              "PARTITION BY HASH(k) PARTITIONS 4")
    store = inst.store("rb", "h")
    keys_by_pid = {}
    for k in range(200):
        pid = int(store.router.route_rows([np.asarray([k], dtype=np.int64)])[0])
        keys_by_pid.setdefault(pid, k)
        if len(keys_by_pid) == 4:
            break
    ks = [keys_by_pid[0]] * hot_rows + sum(
        ([keys_by_pid[p]] * cold_rows for p in (1, 2, 3)), [])
    store.insert_pylists({"id": list(range(len(ks))), "k": ks, "v": [1] * len(ks)},
                         inst.tso.next_timestamp())
    s.execute("ANALYZE TABLE h")
    return store, inst.catalog.table("rb", "h")


def test_balancer_proposes_applies_and_damps():
    def scenario(pkg):
        inst, s = fresh(pkg)
        store, tm = _hot_table(pkg, s)
        props = inst.balancer.propose("rb", "h")
        dry = s.execute("REBALANCE TABLE h DRY RUN").rows
        rows = s.execute("REBALANCE TABLE h").rows
        n = tm.partition.num_partitions
        damped = inst.balancer.propose("rb", "h")
        inst.balancer._split_outcome["rb.h"] = (9, 1.0, 0)
        unparked = inst.balancer.propose("rb", "h")
        return (props, dry, rows, n, damped, unparked, routed_home(store),
                s.execute("SELECT count(*), sum(v) FROM h").rows, progress(s),
                rebalance_events(pkg))
    out = both(scenario)
    assert out[0][0]["op"] == "split" and out[0][0]["pids"] == [0]
    assert out[1][0][5] == "proposed" and out[2][0][1:2] == ("split",)
    assert out[2][0][5] == "applied" and out[3] == 5
    assert not any(p["op"] == "split" for p in out[4])
    assert any(p["op"] == "split" for p in out[5]) and out[6]


def test_balancer_merge_move_and_traffic():
    def scenario(pkg):
        inst, s = fresh(pkg)
        s.execute("CREATE TABLE c (id BIGINT PRIMARY KEY, v BIGINT) "
                  "PARTITION BY HASH(id) PARTITIONS 6")
        store = inst.store("rb", "c")
        pids = store.router.route_rows([np.arange(20000, dtype=np.int64)])
        ids = [i for i in range(20000) if int(pids[i]) not in (2, 5)]
        store.insert_pylists({"id": ids, "v": [0] * len(ids)}, inst.tso.next_timestamp())
        merge = inst.balancer.propose("rb", "c")
        load(s, n=3000, parts=4)
        inst.config.set_instance("REBALANCE_GROUPS", "g0,g1")
        inst.config.set_instance("REBALANCE_SPLIT_FACTOR", 100.0)
        inst.config.set_instance("REBALANCE_MERGE_FACTOR", 0.0)
        move = inst.balancer.propose("rb", "t")
        for k, v in (("REBALANCE_GROUPS", ""), ("REBALANCE_SPLIT_FACTOR", 2.0),
                     ("REBALANCE_MERGE_FACTOR", 0.25)):
            inst.config.set_instance(k, v)
        base = inst.balancer.table_traffic().get("rb.t", 0.0)
        for _ in range(5):
            s.execute("SELECT count(*) FROM c")
        traffic = inst.balancer.table_traffic()
        return (merge, move, traffic.get("rb.t", 0.0) == base,
                traffic.get("rb.c", 0.0) > 0)
    merge, move, bounded, seen = both(scenario)
    assert merge[0]["op"] == "merge" and merge[0]["pids"] == [2, 5]
    assert move[0]["op"] == "move" and move[0]["group"] == "g1" and bounded and seen


def test_balancer_gates_and_the_maintain_loop():
    def scenario(pkg):
        inst, s = fresh(pkg)
        _hot_table(pkg, s)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "critical")
        pressured = inst.balancer.run_once("rb", "h")
        pkg.FAIL_POINTS.clear()
        inst.config.set_instance("ENABLE_REBALANCE", False)
        hatched = inst.balancer.run_once("rb", "h")
        inst.config.set_instance("ENABLE_REBALANCE", True)
        inst.config.set_instance("REBALANCE_MIN_TRAFFIC_MS", 1e12)
        cold = inst.balancer.propose("rb", "h")
        for _ in range(3):
            s.execute("SELECT count(*) FROM h WHERE k = 1")
        inst.config.set_instance("REBALANCE_MIN_TRAFFIC_MS", 1e-6)
        warm = inst.balancer.propose("rb", "h")
        inst.config.set_instance("REBALANCE_MIN_TRAFFIC_MS", 0.0)
        inst.scheduler.register("auto_rb", "rebalance", "rb", "h", {"apply": False},
                                interval_s=0.0)
        fired = inst.scheduler.run_due()
        hist = [h[2:] for h in inst.scheduler.history("auto_rb")]
        return pressured, hatched, cold, warm, fired, hist
    pressured, hatched, cold, warm, fired, hist = both(scenario)
    assert pressured == [] and hatched == [] and cold == [] and warm
    assert "auto_rb" in fired and hist[-1][0] == "SUCCESS" and "proposal" in hist[-1][1]


# -- the surfaces ---------------------------------------------------------------------


def test_show_rebalance_equals_information_schema_and_counters():
    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=1500, parts=2)
        c0 = inst.counters["rebalance_jobs"]
        s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
        s.execute("ALTER TABLE t MERGE PARTITIONS p0, p1")
        show = s.execute("SHOW REBALANCE")
        info = s.execute("SELECT job_id, table_name, kind, state, phase, src_partitions, "
                         "targets, rows_copied, events_applied, last_checkpoint, "
                         "router_epoch FROM information_schema.rebalance_jobs "
                         "ORDER BY job_id").rows
        same = [r[:9] + r[10:] for r in show.rows] == info
        return (show.names, progress(s), same, inst.counters["rebalance_jobs"] - c0,
                inst.counters["rebalance_events_applied"])
    names, rows, same, jobs, _ev = both(scenario)
    assert same and jobs == 2 and [r[2:5] for r in rows] == [("split", "DONE", "cutover"),
                                                             ("merge", "DONE", "cutover")]
    assert rows[0][7] > 0 and names[0] == "JOB_ID"


# -- the online repartition -----------------------------------------------------------


def test_repartition_crash_mid_backfill_resumes_with_late_writes():
    def scenario(pkg):
        inst, s = fresh(pkg, "rp")
        rp = mod(pkg, "ddl.repartition")
        store = load(s, n=2000, parts=2, schema="rp")
        old = rp.RepartitionBackfillTask.CHUNK
        rp.RepartitionBackfillTask.CHUNK = 128
        try:
            pkg.FAIL_POINTS.arm(rp.FP_REPART_PAUSE, 5)
            crash = err(lambda: s.execute("ALTER TABLE t PARTITION BY HASH(grp) "
                                          "PARTITIONS 5"))
            pkg.FAIL_POINTS.clear()
            shadow_hidden = s.execute("SELECT count(*) FROM t").rows
            s.execute("INSERT INTO t VALUES (9001, 1, 'late')")
            s.execute("DELETE FROM t WHERE id = 7")
            s.execute("UPDATE t SET val = 'upd' WHERE id = 11")
            resumed = bool(inst.ddl_engine.recover())
        finally:
            rp.RepartitionBackfillTask.CHUNK = old
        tm = inst.catalog.table("rp", "t")
        hp = mod(pkg, "meta.catalog").hash_partition_of
        homes = all(bool((hp(p.lanes["grp"], 5) == pid).all())
                    for pid, p in enumerate(store.partitions) if p.num_rows)
        return (crash[0], shadow_hidden, resumed, tm.partition.num_partitions,
                list(tm.partition.columns), snapshot(s), homes,
                err(lambda: inst.catalog.table("rp", "t$repart")),
                checksum(pkg, inst, "rp", "t"), s.execute("CHECK TABLE t").rows)
    out = both(scenario)
    assert out[:5] == ("FailPointError", [(2000,)], True, 5, ["grp"]) and out[6]
    assert out[7][0] == "UnknownTableError" and len(out[5]) == 2000


def test_repartition_cutover_waits_for_an_open_reader():
    def scenario(pkg):
        inst, s = fresh(pkg, "rp")
        load(s, n=300, parts=2, schema="rp")
        mdl = inst.mdl
        done, acquired = threading.Event(), threading.Event()

        def reader():
            with mdl.shared(["rp.t"]):
                acquired.set()
                time.sleep(0.6)
            done.set()
        thr = threading.Thread(target=reader)
        thr.start()
        acquired.wait(5)
        t0 = time.time()
        s.execute("ALTER TABLE t PARTITION BY HASH(id) PARTITIONS 4")
        waited = time.time() - t0 >= 0.3
        thr.join()
        assert mdl.acquire_exclusive("rp.t", 1)
        try:
            blocked = err(lambda: mdl.shared(["rp.t"], timeout=0.2).__enter__())
        finally:
            mdl.release_exclusive("rp.t")
        return (done.is_set(), waited, inst.catalog.table("rp", "t").partition.num_partitions,
                blocked[0], s.execute("SELECT count(*) FROM t").rows)
    assert both(scenario) == (True, True, 4, "TddlError", [(300,)])


# -- CHECK TABLE, sequences -----------------------------------------------------------


def test_check_table_rows_and_refusals():
    def scenario(pkg):
        inst, s = fresh(pkg)
        load(s, n=300, parts=2)
        s.execute("CREATE TABLE u (id BIGINT PRIMARY KEY, g BIGINT)")
        s.execute("INSERT INTO u VALUES (1, 2), (2, 3)")
        s.execute("CREATE GLOBAL INDEX g_g ON u (g)")
        ok = s.execute("CHECK TABLE t, u")
        gsi = inst.store("rb", "u$g_g")
        for gp in gsi.partitions:
            gp.end_ts[:] = 0  # the index loses its rows
        broken = s.execute("CHECK TABLE u").rows
        missing = err(lambda: s.execute("CHECK TABLE nope"))
        return ok.names, ok.rows, broken, missing
    names, ok, broken, missing = both(scenario)
    assert ok == [("rb.t", "check", "status", "OK"), ("rb.u", "check", "status", "OK")]
    assert broken[0][2] == "Error" and missing[0] == "UnknownTableError"


def test_nextval_matches_the_reference(tmp_path):
    """SELECT NEXTVAL over the metadb's ranges: 1, 2 and an independent sequence
    from 1; a second instance over the same metadb takes a new range, never a value
    the first served."""
    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        inst = pkg.Instance(data_dir=d)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE sq")
        s.execute("USE sq")
        vals = [s.execute("SELECT NEXTVAL('s1') AS v").rows[0][0],
                s.execute("SELECT NEXTVAL('s1') AS v").rows[0][0],
                s.execute("SELECT NEXTVAL('s2') AS v").rows[0][0]]
        s.close()
        inst2 = pkg.Instance(data_dir=d)
        s2 = pkg.Session(inst2, "sq")
        vals.append(s2.execute("SELECT NEXTVAL('s1')").rows[0][0])
        s2.close()
        return vals
    assert both(scenario) == [1, 2, 1, 1001]


def test_nextval_unique_under_concurrent_sessions():
    def scenario(pkg):
        inst, s = fresh(pkg, "sq")
        got = []

        def worker(i):
            sx = pkg.Session(inst, "sq")
            for _ in range(20):
                got.append(sx.execute("SELECT NEXTVAL('c')").rows[0][0])
            sx.close()
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        return sorted(got)
    assert both(scenario) == list(range(1, 321))


# -- a worker-resident table moved between workers ------------------------------------


def test_move_remote_table_between_workers():
    """`Instance.move_remote_table` over two real worker processes a package: the
    snapshot copy, a write and a delete before the cutover, the endpoint swap; the
    moved table serves with the old worker dead and takes writes on the new one.
    A table that is not remote is refused typed, and CHECK TABLE refuses a
    worker-resident table."""
    from torch_worker_harness import coordinator, start_all
    init = ("CREATE DATABASE mv; USE mv; "
            "CREATE TABLE t (id BIGINT PRIMARY KEY, v VARCHAR(12), amt DECIMAL(10,2)); "
            "INSERT INTO t VALUES (1,'a',1.25), (2,'b',2.50), (3,NULL,0.75)")
    procs = start_all(("jax", init, None), ("jax", "", None),
                      ("torch", init, None), ("torch", "", None))
    try:
        out = {}
        for pkg, (p1, p2) in (("jax", procs[:2]), ("torch", procs[2:])):
            inst, s = coordinator(pkg)
            s.execute("CREATE DATABASE mv")
            s.execute("USE mv")
            s.execute("CREATE TABLE loc (id BIGINT PRIMARY KEY)")
            inst.attach_remote_table("mv", "t", "127.0.0.1", p1.port)
            s.execute("INSERT INTO t VALUES (4, 'd', 4.00)")
            s.execute("DELETE FROM t WHERE id = 2")
            check = err(lambda: s.execute("CHECK TABLE t"))
            local = err(lambda: inst.move_remote_table("mv", "loc", "127.0.0.1", p2.port))
            moves0 = inst.counters["table_moves"]
            inst.move_remote_table("mv", "t", "127.0.0.1", p2.port)
            tm = inst.catalog.table("mv", "t")
            moved = tm.remote["port"] == p2.port
            rows = sorted(s.execute("SELECT id, v, amt FROM t").rows)
            p1.kill()
            rows_dead = sorted(s.execute("SELECT id, v, amt FROM t").rows)
            s.execute("INSERT INTO t VALUES (9, 'z', 9.99)")
            out[pkg] = (check, local, moved, rows, rows_dead,
                        s.execute("SELECT v FROM t WHERE id = 9").rows,
                        inst.counters["table_moves"] - moves0)
            s.close()
        assert out["torch"] == out["jax"], out
        got = out["torch"]
        assert got[0][0] == "NotSupportedError" and got[1][0] == "NotSupportedError"
        assert got[2] and got[3] == [(1, "a", 1.25), (3, None, 0.75), (4, "d", 4.0)]
        assert got[4] == got[3] and got[5] == [("z",)] and got[6] == 1
    finally:
        for p in procs:
            p.close()
