"""The cross-query fragment cache (`exec/fragment_cache.py`, a verbatim copy) wired
into the port's join builds, aggregate replays and build-subtree replays, against the
JAX package on the CPU.

Each case is one of the reference's own (`tests/test_fragment_cache.py`), run as a
scenario through both packages in turn: the scenario asserts the reference's
invariants and returns what it saw (rows, hit and miss deltas, trace markers,
fingerprint decisions), which must be equal between the packages.  Added here:
invalidation after every write path the port has (autocommit DML, a transaction's own
writes, a batched point-write flush, an async GSI apply, DDL, AS OF), the read-only
rule for cached tensors (one query repeated with a write and other queries between,
every run against the reference), and the reference's fragment-cache generation test
of the columnar replica (`tests/test_columnar.py`).  Left out: the MPP and SSB cases
(ROADMAP Queue 1 item 15, and the port has no SSB generator) and SHOW METRICS (item
16)."""

import threading
import time
import types

import pytest
import torch

from galaxysql_tpu.exec import fragment_cache as jax_fc
from galaxysql_tpu.plan import logical as JaxL
from galaxysql_tpu.plan import physical as jax_physical
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch.chunk.batch import batch_from_pydict
from galaxysql_tpu_torch.exec import fragment_cache as fc
from galaxysql_tpu_torch.exec.operators import SourceOp
from galaxysql_tpu_torch.plan import logical as PortL
from galaxysql_tpu_torch.plan import physical as port_physical
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.types import datatype as dt

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def _jax_instance():
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


def _jax_ctx(inst, plan, snap):
    return jax_physical.ExecContext(inst.stores, snap, [], archive=inst.archive,
                                    archive_instance=inst,
                                    hints=getattr(plan, "hints", None))


def _port_ctx(inst, plan, snap):
    return port_physical.ExecContext(inst.stores, snap, inst.device, inst.device_cache,
                                     archive=inst.archive, archive_instance=inst,
                                     hints=getattr(plan, "hints", None))


JAX = types.SimpleNamespace(name="jax", new=_jax_instance, Session=JaxSession,
                            fc=jax_fc, L=JaxL, ctx=_jax_ctx)
PORT = types.SimpleNamespace(name="port", new=lambda: Instance(device="cpu"),
                             Session=Session, fc=fc, L=PortL, ctx=_port_ctx)


def _same(scenario):
    """`scenario(pkg)` through both packages; the observations must be equal."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


JOIN_Q = ("SELECT d.name, sum(f.v) FROM fact f JOIN dim d ON f.id = d.id "
          "GROUP BY d.name ORDER BY d.name")
OFF = "/*+TDDL:FRAGMENT_CACHE(OFF)*/ "
SELECTIVE_Q = ("SELECT d.name, sum(f.v) FROM fact f JOIN dim d ON f.id = d.id "
               "WHERE d.name = 'a' GROUP BY d.name")


def joined(pkg):
    """The reference's `joined_session`: a 3-row dimension and a 400-row fact."""
    s = pkg.Session(pkg.new())
    s.execute("CREATE DATABASE f; USE f")
    s.execute("CREATE TABLE dim (id BIGINT PRIMARY KEY, name VARCHAR(16))")
    s.execute("CREATE TABLE fact (id BIGINT, v BIGINT)")
    s.execute("INSERT INTO dim VALUES (1,'a'),(2,'b'),(3,'c')")
    s.execute("INSERT INTO fact VALUES " +
              ",".join(f"({i % 3 + 1},{i})" for i in range(400)))
    return s


def _plan_ctx(pkg, s, sql):
    inst = s.instance
    plan = inst.planner.plan_select(sql, s.schema)
    return plan, pkg.ctx(inst, plan, inst.tso.next_timestamp())


def _counts(s):
    c = s.instance.frag_cache
    return c.hits, c.misses


def _delta(s, before):
    h, m = _counts(s)
    return h - before[0], m - before[1]


# -- cache mechanics (the port's copy of the module) -----------------------------------

def test_lru_byte_budget_and_evictions():
    c = fc.FragmentCache(budget_bytes=1000)
    for i in range(5):
        assert c.put(("k", i), object(), 300, frozenset({"d.t"}), kind="subplan")
    assert c.bytes <= 1000 and c.evictions >= 2
    assert c.get(("k", 0)) is None and c.get(("k", 4)) is not None
    c.close()


def test_entry_above_cap_rejected():
    c = fc.FragmentCache(budget_bytes=1000)
    assert not c.put(("big",), object(), fc.SUBPLAN_MAX_BYTES + 1, frozenset(),
                     kind="subplan")
    assert c.admission_rejects == 1 and len(c) == 0
    c.close()


def test_invalidate_table_and_epoch_bump():
    c = fc.FragmentCache()
    c.put(("a",), object(), 10, frozenset({"d.t"}), kind="subplan")
    c.put(("b",), object(), 10, frozenset({"d.u"}), kind="subplan")
    assert c.invalidate_table("d.t") == 1 and c.bytes == 10
    e0 = c.epoch("d.u")
    c.bump_epoch("d.u")
    assert c.epoch("d.u") == e0 + 1 and len(c) == 0
    c.close()


def test_cached_subplan_op_streams_and_caches():
    """A cached subplan replays the very batches it saw; the second pull never
    reaches the wrapped operator."""
    b = batch_from_pydict({"k": [1, 2, 3]}, {"k": dt.BIGINT})
    c = fc.FragmentCache()
    fkey = fc.FragKey(("frag", "x"), frozenset({"d.t"}))
    pulls = []

    class Counting(SourceOp):
        def batches(self):
            pulls.append(1)
            yield from super().batches()

    op = fc.CachedSubplanOp(Counting([b]), c, fkey)
    first = list(op.batches())
    second = list(op.batches())
    assert len(pulls) == 1 and c.hits == 1
    assert second[0] is first[0] is b
    c.close()


def test_tensor_nbytes_count_as_the_reference_counts_arrays():
    b = batch_from_pydict({"k": list(range(100)), "s": ["x"] * 100},
                          {"k": dt.BIGINT, "s": dt.VARCHAR})
    assert fc._nbytes_of(b) == 100 * 8 + 100 * 4


# -- fingerprints ----------------------------------------------------------------------

def test_version_bump_changes_key():
    def scenario(pkg):
        s = joined(pkg)
        plan, ctx = _plan_ctx(pkg, s, "SELECT id, name FROM dim")
        f1 = pkg.fc.fingerprint(plan.rel, ctx)
        s.execute("INSERT INTO dim VALUES (4,'d')")
        plan2, ctx2 = _plan_ctx(pkg, s, "SELECT id, name FROM dim")
        f2 = pkg.fc.fingerprint(plan2.rel, ctx2)
        return sorted(f1.tables), f2 is not None and f2.key != f1.key
    assert _same(scenario) == (["f.dim"], True)


@pytest.mark.parametrize("case", ["literals", "as_of", "txn_write_set", "old_snapshot",
                                  "outside_rf_target", "information_schema"])
def test_fingerprint_bypass_rules(case):
    """Each bypass rule of `_fp_scan` / `fingerprint` decides the same in both
    packages (the module is a verbatim copy; the contexts are each engine's own)."""
    def scenario(pkg):
        s = joined(pkg)
        if case == "literals":
            p1, c1 = _plan_ctx(pkg, s, "SELECT id FROM dim WHERE id > 1")
            p2, c2 = _plan_ctx(pkg, s, "SELECT id FROM dim WHERE id > 2")
            return pkg.fc.fingerprint(p1.rel, c1).key != \
                pkg.fc.fingerprint(p2.rel, c2).key
        if case == "as_of":
            ts = s.instance.tso.next_timestamp()
            plan, ctx = _plan_ctx(pkg, s, f"SELECT id FROM dim AS OF TSO {ts}")
            return pkg.fc.fingerprint(plan.rel, ctx) is None
        if case == "txn_write_set":
            plan, ctx = _plan_ctx(pkg, s, "SELECT id, name FROM dim")
            ctx.txn_id = 77
            out = []
            for uids in (frozenset({s.instance.store("f", "dim").uid}), frozenset(),
                         None):
                ctx.txn_write_uids = uids
                out.append(pkg.fc.fingerprint(plan.rel, ctx) is None)
            return out
        if case == "old_snapshot":
            old = s.instance.tso.next_timestamp()
            s.execute("INSERT INTO dim VALUES (9,'i')")
            plan, ctx = _plan_ctx(pkg, s, "SELECT id, name FROM dim")
            now = pkg.fc.fingerprint(plan.rel, ctx) is None
            ctx.snapshot_ts = old
            return now, pkg.fc.fingerprint(plan.rel, ctx) is None
        if case == "outside_rf_target":
            for bit in range(5):
                s.execute(f"INSERT INTO fact SELECT id, v + {1000 << bit} FROM fact")
            s.execute("ANALYZE TABLE fact, dim")
            plan, ctx = _plan_ctx(pkg, s, SELECTIVE_Q)
            scans = [n for n in pkg.L.walk(plan.rel)
                     if isinstance(n, pkg.L.Scan) and n.rf_targets]
            assert scans, "the rules planted a runtime filter on fact"
            return (pkg.fc.fingerprint(scans[0], ctx) is None,
                    pkg.fc.fingerprint(plan.rel, ctx) is None)
        s.execute("SELECT table_name FROM information_schema.tables")
        plan, ctx = _plan_ctx(pkg, s, "SELECT table_name FROM information_schema.tables")
        return pkg.fc.fingerprint(plan.rel, ctx) is None
    got = _same(scenario)
    assert got == {"literals": True, "as_of": True,
                   "txn_write_set": [True, False, True],
                   "old_snapshot": (False, True), "outside_rf_target": (True, False),
                   "information_schema": True}[case]


# -- end to end ------------------------------------------------------------------------

def test_warm_join_hits_and_matches():
    """Cold run, warm replay of the whole aggregate, FRAGMENT_CACHE(OFF), then the
    join-build artifact lane once the replay entries are dropped."""
    def scenario(pkg):
        s = joined(pkg)
        c = s.instance.frag_cache
        cold = s.execute(JOIN_Q).rows
        entries = sorted((k, t) for k, t, _r, _b, _h in c.rows())
        b0 = _counts(s)
        warm = s.execute(JOIN_Q).rows
        replay = (_delta(s, b0), any("frag-subplan hit" in t for t in s.last_trace))
        off = s.execute(OFF + JOIN_Q).rows
        c.drop_kind("subplan")
        again = s.execute(JOIN_Q).rows
        build_hit = any("frag-cache build hit" in t for t in s.last_trace)
        assert cold == warm == off == again
        return cold, entries, replay, build_hit
    got = _same(scenario)
    assert got[2][1] and got[3]


@pytest.mark.parametrize("write", [
    "INSERT INTO dim VALUES (7,'g')",
    "INSERT INTO fact VALUES (1, 100000)",
    "UPDATE dim SET name = 'zz' WHERE id = 1",
    "DELETE FROM dim WHERE id = 2",
    "DELETE FROM fact WHERE v < 100",
    "TRUNCATE TABLE fact",
    "ALTER TABLE dim ADD COLUMN extra BIGINT",
    "CREATE INDEX i_v ON fact (v)",
])
def test_autocommit_write_and_ddl_invalidate(write):
    """A warm query after a write or DDL on one of its tables misses and returns the
    new rows; FRAGMENT_CACHE(OFF) agrees.  A write to the probe side (fact) leaves
    the dimension's build artifact valid: it may hit, as in the reference."""
    def scenario(pkg):
        s = joined(pkg)
        s.execute(JOIN_Q)
        s.execute(JOIN_Q)  # warm
        s.execute(write)
        b0 = _counts(s)
        got = s.execute(JOIN_Q).rows
        hits, misses = _delta(s, b0)
        assert misses > 0 and not any("frag-subplan hit" in t for t in s.last_trace)
        assert got == s.execute(OFF + JOIN_Q).rows
        return got, hits, misses
    _same(scenario)


def test_txn_local_writes_bypass():
    def scenario(pkg):
        s = joined(pkg)
        s.execute(JOIN_Q)
        s.execute(JOIN_Q)  # warm
        s.execute("BEGIN")
        s.execute("INSERT INTO dim VALUES (8,'h')")
        s.execute("INSERT INTO fact VALUES (8, 500)")
        own = s.execute(JOIN_Q).rows  # the txn sees its own rows despite the cache
        assert ("h", 500) in [tuple(r) for r in own]
        other = pkg.Session(s.instance, schema="f")
        others = other.execute(JOIN_Q).rows  # never the txn-local view
        s.execute("ROLLBACK")
        after = s.execute(JOIN_Q).rows
        assert others == after and not any(r[0] == "h" for r in after)
        return own, after
    _same(scenario)


def test_txn_committed_writes_are_seen():
    def scenario(pkg):
        s = joined(pkg)
        s.execute(JOIN_Q)
        s.execute("BEGIN")
        s.execute("UPDATE fact SET v = v + 1 WHERE id = 3")
        own = s.execute(JOIN_Q).rows
        s.execute("COMMIT")
        after = s.execute(JOIN_Q).rows
        assert after == own == s.execute(OFF + JOIN_Q).rows
        return after
    _same(scenario)


def test_flashback_bypasses():
    def scenario(pkg):
        s = joined(pkg)
        ts1 = s.instance.tso.next_timestamp()
        s.execute("INSERT INTO dim VALUES (6,'f')")
        s.execute("INSERT INTO fact VALUES (6, 99)")
        s.execute(JOIN_Q)
        s.execute(JOIN_Q)  # warm at the current snapshot
        q = ("SELECT d.name, sum(f2.v) FROM fact AS OF TSO %d f2 "
             "JOIN dim AS OF TSO %d d ON f2.id = d.id "
             "GROUP BY d.name ORDER BY d.name" % (ts1, ts1))
        old = s.execute(q).rows
        assert not any(r[0] == "f" for r in old)
        return old, s.execute(q).rows
    _same(scenario)


def test_env_and_config_escape_hatches(monkeypatch):
    def scenario(pkg):
        s = joined(pkg)
        c = s.instance.frag_cache
        out = []
        monkeypatch.setattr(pkg.fc, "ENABLED", False)
        c.clear()
        s.execute(JOIN_Q)
        out.append(len(c))
        monkeypatch.setattr(pkg.fc, "ENABLED", True)
        s.execute("SET GLOBAL ENABLE_FRAGMENT_CACHE = 0")
        s.execute(JOIN_Q)
        out.append(len(c))
        s.execute(OFF + JOIN_Q)
        out.append(len(c))
        s.execute("SET GLOBAL ENABLE_FRAGMENT_CACHE = 1")
        s.execute(JOIN_Q)
        out.append(len(c) > 0)
        return out
    assert _same(scenario) == [0, 0, 0, True]


def test_observability_surfaces():
    def scenario(pkg):
        s = joined(pkg)
        s.execute(JOIN_Q)
        s.execute(JOIN_Q)
        rows = s.execute("SHOW FRAGMENT CACHE").rows
        isr = s.execute("SELECT entry_kind, tables, hits FROM "
                        "information_schema.fragment_cache").rows
        assert any("f.dim" in r[1] for r in rows)
        return [(k, t, h) for k, t, _r, _b, h in rows], sorted(isr)
    _same(scenario)


def test_explain_analyze_cached_build_tag():
    def scenario(pkg):
        s = joined(pkg)
        s.execute(JOIN_Q)  # warms the artifact
        lines = [r[0] for r in s.execute("EXPLAIN ANALYZE " + JOIN_Q).rows]
        tagged = [ln.split("  (actual")[0] for ln in lines if "[cached build]" in ln]
        assert tagged
        return tagged
    _same(scenario)


# -- the port's write paths ------------------------------------------------------------

def _dml_batched(pkg):
    """`dbx.t` with a covering GSI and the INSERT batch plan registered by one
    sequential run (after the GSI DDL, which bumps schema_version)."""
    inst = pkg.new()
    inst.config.set_instance("ENABLE_ADMISSION_CONTROL", 0)
    s = pkg.Session(inst)
    s.execute("CREATE DATABASE dbx")
    s.execute("USE dbx")
    s.execute("CREATE TABLE t (id BIGINT NOT NULL PRIMARY KEY, k INT NOT NULL, "
              "amt DECIMAL(12,2)) PARTITION BY HASH(id) PARTITIONS 4")
    s.execute("CREATE GLOBAL INDEX g_k ON t (k) COVERING (amt)")
    s.execute("INSERT INTO t (id, k, amt) VALUES " +
              ",".join(f"({i}, {i % 5}, {i}.25)" for i in range(2, 60)))
    s.execute("INSERT INTO t (id, k, amt) VALUES (1, 1, 1.25)")
    return s, inst


@pytest.mark.parametrize("apply", ["async", "sync"])
def test_batched_flush_and_async_apply_invalidate(apply):
    """Batched point writes flush through `server/dml_batch.py` (the GSI rows applied
    by the async applier, or inside the flush); the queries over the base table and
    over its GSI table that were warm before the flush miss after it and return the
    new rows."""
    q_base = "SELECT k, count(*), sum(amt) FROM t GROUP BY k ORDER BY k"
    q_gsi = "SELECT k, count(*), sum(amt) FROM t$g_k GROUP BY k ORDER BY k"
    members = 4

    def scenario(pkg):
        s, inst = _dml_batched(pkg)
        inst.config.set_instance("ENABLE_ASYNC_APPLY", 1 if apply == "async" else 0)
        for q in (q_base, q_gsi):
            s.execute(q)
            s.execute(q)  # warm
        inst.config.set_instance("DML_BATCH_WINDOW_US", 10_000_000)
        inst.config.set_instance("BATCH_MAX_GROUP", members)
        sessions = [pkg.Session(inst, schema="dbx") for _ in range(members)]
        gate = threading.Barrier(members)
        errs = []

        def write(i):
            try:
                gate.wait(timeout=30)
                sessions[i].execute(
                    f"INSERT INTO t (id, k, amt) VALUES ({2000 + i}, {i % 5}, 7.25)")
            except Exception as e:  # asserted below
                errs.append(e)
        threads = [threading.Thread(target=write, args=(i,), daemon=True)
                   for i in range(members)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs and not any(t.is_alive() for t in threads)
        inst.config.set_instance("DML_BATCH_WINDOW_US", 0)
        assert inst.applier.drain(30.0)
        out = []
        for q in (q_base, q_gsi):
            b0 = _counts(s)
            rows = s.execute(q).rows
            hits, misses = _delta(s, b0)
            assert hits == 0 and misses > 0, q
            assert rows == s.execute(OFF + q).rows
            out.append(rows)
        assert out[0] == out[1]
        return out
    _same(scenario)


def test_read_only_cached_tensors():
    """Cached build batches, slot CSRs and replayed aggregates are handed to later
    queries as they are: no operator may write into them.  One query runs three
    times, with a write to another table and a different query over the same tables
    between the runs; every run equals the reference's."""
    q = QUERIES[3]
    other = QUERIES[10]
    data = tpch.generate(0.005)

    def engine(pkg):
        s = pkg.Session(pkg.new())
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
        for t in tpch.TABLE_ORDER:
            s.execute(tpch.TPCH_DDL[t])
            s.instance.store("tpch", t).insert_pylists(
                data[t], s.instance.tso.next_timestamp())
        return s

    def scenario(pkg):
        s = engine(pkg)
        out = [s.execute(q).rows]
        s.execute("INSERT INTO region VALUES (9, 'NOWHERE', 'none')")
        out.append(s.execute(other).rows)
        out.append(s.execute(q).rows)
        s.instance.frag_cache.drop_kind("subplan")  # the join-build artifacts serve
        out.append(s.execute(other).rows)
        out.append(s.execute(q).rows)
        assert out[0] == out[2] == out[4]
        return out
    _same(scenario)


# -- the columnar replica's generation key (the reference's tests/test_columnar.py) ----

def test_generation_key_caches_idle_and_recomputes_on_dml():
    """Replica scans fingerprint by (seed_ts, applied_events), not the watermark: idle
    watermark advances keep fragments warm; applied DML moves the generation, so
    results are recomputed."""
    margin = 0.005
    hint = "/*+TDDL:COLUMNAR(ON)*/ "
    q = "SELECT grp, count(*), sum(id) FROM t GROUP BY grp ORDER BY grp"

    def advance(inst):
        time.sleep(margin)
        return inst.columnar.tail_once()

    def scenario(pkg):
        inst = pkg.new()
        inst.config.set_instance("COLUMNAR_POLL_MS", 0)
        inst.columnar.shutdown()
        inst.config.set_instance("COLUMNAR_WATERMARK_LAG_MS", 1)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, grp BIGINT, val VARCHAR(16)) "
                  "PARTITION BY HASH(id) PARTITIONS 4")
        s.execute("INSERT INTO t VALUES " +
                  ",".join(f"({i},{i % 7},'v{i % 5}')" for i in range(200)))
        time.sleep(margin)
        rep = inst.columnar.ensure_ready("c", "t")
        sr = pkg.Session(inst, schema="c")
        r1 = sr.execute(hint + q).rows
        w1 = rep.watermark
        advance(inst)  # idle cycle: the watermark moves, the generation does not
        assert rep.watermark > w1
        b0 = _counts(sr)
        assert sr.execute(hint + q).rows == r1
        idle = _delta(sr, b0)
        ev = rep.applied_events
        s.execute("UPDATE t SET grp = 99 WHERE id < 10")
        advance(inst)
        assert rep.applied_events > ev and rep.max_applied_ts > w1
        r2 = sr.execute(hint + q).rows
        off = sr.execute("/*+TDDL:COLUMNAR(OFF)*/ " + q).rows
        assert r2 == off and r2 != r1
        assert idle[0] > 0 and idle[1] == 0
        return r1, r2, idle
    _same(scenario)


# -- TPC-H: warm equals cold equals off ------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(0.01)
    ji, pi = _jax_instance(), Instance(device="cpu")
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
    for s in (js, ps):
        s.execute("ANALYZE TABLE " + ", ".join(tpch.TABLE_ORDER))
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("q", [3, 5, 9, 18])
def test_tpch_cold_warm_join_warm_and_off(tpch_pair, q):
    """Cold, warm (aggregate replay), warm at the join level (replays dropped: the
    build artifacts and their cached filters serve) and FRAGMENT_CACHE(OFF): the same
    rows, equal to the reference's; the join-level warm run reuses as many artifacts
    and filters as the reference's."""
    from galaxysql_tpu.exec import runtime_filter as jax_rf
    from galaxysql_tpu_torch.exec import runtime_filter as port_rf
    out = []
    for s, rf in zip(tpch_pair, (jax_rf, port_rf)):
        s.instance.frag_cache.clear()
        runs = [s.execute(QUERIES[q]).rows, s.execute(QUERIES[q]).rows]
        s.instance.frag_cache.drop_kind("subplan")
        rf.reset_rf_stats(enabled=True)
        runs.append(s.execute(QUERIES[q]).rows)
        cached = (rf.RF_STATS["filters_cached"], rf.RF_STATS["filters_built"],
                  sum("frag-cache build hit" in t for t in s.last_trace))
        rf.reset_rf_stats()
        runs.append(s.execute(OFF + QUERIES[q]).rows)
        assert runs[0] == runs[1] == runs[2] == runs[3]
        out.append((runs[0], cached))
    assert out[1] == out[0]
    assert out[1][1][2] > 0
