"""The columnar HTAP replica (`storage/columnar.py`) and zone maps, through the JAX
package and the port on the CPU.

Each case is one of the reference's own (`tests/test_columnar.py`), run as a scenario
through both packages in turn: the scenario asserts the reference's invariants (a
replica read routed at watermark W equals a row-store read at W, through DML,
compaction racing in-flight views, DDL mid-tail reseeds and a restart from the
persisted watermark; the routing gates; zone-map pruning; the clustered seed) and
returns what it saw, rows and routing decisions, which must be equal between the
packages.  The tailer runs synchronously (COLUMNAR_POLL_MS = 0, `tail_once()` driven
here) with a 1 ms watermark margin.

Left out: the reference's `test_steady_state_retraces_zero` (XLA retraces) and its
`information_schema.metrics` check (ROADMAP Queue 1 item 16); its fragment-cache
generation test runs in `tests/test_torch_fragment_cache.py`.  The port has no statement summary
(item 16), so its size signal is the planner's estimate alone; the routing cases here
use a hint or cold digests, where the reference takes the same branch."""

import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import columnar as jax_col
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import columnar as col

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

MARGIN_S = 0.005  # now - margin passes every prior commit's TSO
DDL = ("CREATE TABLE t (id BIGINT PRIMARY KEY, grp BIGINT, val VARCHAR(16)) "
       "PARTITION BY HASH(id) PARTITIONS 4")
Q_AGG = "SELECT grp, count(*), sum(id) FROM t GROUP BY grp ORDER BY grp"
Q_ALL = "SELECT id, grp, val FROM t ORDER BY id"
HINT = "/*+TDDL:COLUMNAR(ON)*/ "
OFF = "/*+TDDL:COLUMNAR(OFF)*/ "


def _jax_instance(data_dir=None):
    ji = JaxInstance(data_dir=data_dir, boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


def _jax_live(view, tm, inst):
    return sum(int(b.num_live()) for b in jax_col.scan_view(view, tm, ["id"]))


def _port_live(view, tm, inst):
    return sum(int(b.num_live()) for b in col.scan_view(
        view, tm, ["id"], manager=inst.columnar, device_cache=inst.device_cache))


JAX = types.SimpleNamespace(name="jax", new=_jax_instance, Session=JaxSession,
                            col=jax_col, live=_jax_live)
PORT = types.SimpleNamespace(name="port",
                             new=lambda d=None: Instance(data_dir=d, device="cpu"),
                             Session=Session, col=col, live=_port_live)


def make_instance(pkg, data_dir=None, **params):
    inst = pkg.new(data_dir)
    inst.config.set_instance("COLUMNAR_POLL_MS", 0)  # synchronous tailer
    inst.columnar.shutdown()  # a boot that loaded replicas started the poll thread
    inst.config.set_instance("COLUMNAR_WATERMARK_LAG_MS", 1)
    for k, v in params.items():
        inst.config.set_instance(k, v)
    return inst


def advance(inst):
    """Let the margin elapse, then run one tail cycle."""
    time.sleep(MARGIN_S)
    return inst.columnar.tail_once()


def fresh(pkg, **params):
    inst = make_instance(pkg, **params)
    s = pkg.Session(inst)
    s.execute("CREATE DATABASE c; USE c")
    s.execute(DDL)
    s.execute("INSERT INTO t VALUES " +
              ",".join(f"({i},{i % 7},'v{i % 5}')" for i in range(200)))
    return s


def both(s, q):
    """(columnar rows, row-store rows, routed?) for one query."""
    r0 = s.instance.columnar.routed.value
    on = s.execute(HINT + q).rows
    off = s.execute(OFF + q).rows
    return on, off, s.instance.columnar.routed.value > r0


def _same(scenario):
    """`scenario(pkg)` through both packages; the observations must be equal."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


# -- bit identity ---------------------------------------------------------------

def test_seeded_scan_identical_and_routed():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        assert rep.state == pkg.col.READY and rep.watermark > 0
        out = []
        for q in (Q_ALL, Q_AGG, "SELECT count(*) FROM t WHERE grp = 3"):
            on, off, routed = both(s, q)
            assert routed and on == off
            out.append(on)
        return out
    _same(scenario)


def test_identity_through_dml_stream():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        out = []
        for rnd in range(3):
            base = 1000 * (rnd + 1)
            s.execute("INSERT INTO t VALUES " + ",".join(
                f"({base + i},{i % 7},'n{rnd}')" for i in range(40)))
            s.execute(f"DELETE FROM t WHERE id < {20 * (rnd + 1)}")
            s.execute(f"UPDATE t SET grp = grp + 1 WHERE id >= {base + 30}")
            advance(s.instance)
            assert rep.state == pkg.col.READY  # no reseed: deltas applied cleanly
            on, off, routed = both(s, Q_ALL)
            assert routed and on == off
            on2, off2, _ = both(s, Q_AGG)
            assert on2 == off2
            out.append((on, on2))
        assert rep.applied_events > 0 and rep.applied_rows > 0
        return out, rep.applied_events, rep.applied_rows
    _same(scenario)


def test_old_view_matches_flashback_at_its_watermark():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        v1 = rep.view()
        s.execute("DELETE FROM t WHERE id < 100")
        s.execute("INSERT INTO t VALUES (5000, 1, 'late')")
        advance(s.instance)
        tm = s.instance.catalog.table("c", "t")
        live = pkg.live(v1, tm, s.instance)
        flashback = s.execute(f"SELECT count(*) FROM t AS OF TSO {v1.watermark}").rows
        assert [(live,)] == flashback
        return live
    _same(scenario)


# a stream of writes on the refresh tables: new orders and their lines, a price
# change, cancelled orders
STREAM = [
    "INSERT INTO orders SELECT o_orderkey + 10000000, o_custkey, o_orderstatus, "
    "o_totalprice, o_orderdate, o_orderpriority, o_clerk, o_shippriority, o_comment "
    "FROM orders WHERE o_orderkey < 2000",
    "INSERT INTO lineitem SELECT l_orderkey + 10000000, l_partkey, l_suppkey, "
    "l_linenumber, l_quantity, l_extendedprice + 1, l_discount, l_tax, l_returnflag, "
    "l_linestatus, l_shipdate, l_commitdate, l_receiptdate, l_shipinstruct, "
    "l_shipmode, l_comment FROM lineitem WHERE l_orderkey < 2000",
    "UPDATE lineitem SET l_discount = l_discount + 0.01 WHERE l_orderkey < 600",
    "DELETE FROM lineitem WHERE l_orderkey >= 3000 AND l_orderkey < 4000",
    "DELETE FROM orders WHERE o_orderkey >= 3000 AND o_orderkey < 4000",
]
TPCH_QIDS = (1, 3, 5)


def _routed_rows(s, qid):
    r0 = s.instance.columnar.routed.value
    on = s.execute(HINT + QUERIES[qid]).rows
    assert s.instance.columnar.routed.value > r0
    assert on == s.execute(OFF + QUERIES[qid]).rows
    return on


@pytest.fixture(scope="module")
def tpch_pair():
    """TPC-H SF 0.01 in both packages with READY replicas of all eight tables; the
    routed rows of Q1, Q3 and Q5 on the seeded replicas, then the write stream
    applied once and drained by `tail_once`."""
    data = tpch.generate(0.01)
    sessions, before = {}, {}
    for pkg in (JAX, PORT):
        inst = make_instance(pkg)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE tpch; USE tpch")
        for t in tpch.TABLE_ORDER:
            s.execute(tpch.TPCH_DDL[t])
            inst.store("tpch", t).insert_arrays(data[t], inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE " + ", ".join(tpch.TABLE_ORDER))
        time.sleep(MARGIN_S)
        for t in tpch.TABLE_ORDER:
            inst.columnar.ensure_ready("tpch", t)
        before[pkg.name] = {qid: _routed_rows(s, qid) for qid in TPCH_QIDS}
        for sql in STREAM:
            s.execute(sql)
        advance(inst)
        assert all(r.state == pkg.col.READY for r in inst.columnar.replicas.values())
        assert inst.columnar.replica("tpch", "lineitem").applied_events > 0
        sessions[pkg.name] = s
    yield sessions, before
    for s in sessions.values():
        s.close()


@pytest.mark.parametrize("qid", TPCH_QIDS)
def test_tpch_on_vs_off_before_and_after_a_dml_stream(tpch_pair, qid):
    """Routed TPC-H Q1, Q3 and Q5 equal the row store and the reference, on the
    seeded replicas and after INSERT, UPDATE and DELETE drained by `tail_once`."""
    sessions, before = tpch_pair
    after = {name: _routed_rows(s, qid) for name, s in sessions.items()}
    assert before["port"][qid] == before["jax"][qid]
    assert after["port"] == after["jax"]
    assert after["port"] != before["port"][qid]  # the stream moved the answer


# -- the tailer -----------------------------------------------------------------

def test_crash_restart_resumes_from_persisted_watermark(tmp_path):
    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        inst = make_instance(pkg, data_dir=d)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute(DDL)
        s.execute("INSERT INTO t VALUES " +
                  ",".join(f"({i},{i % 3},'a')" for i in range(100)))
        time.sleep(MARGIN_S)
        rep = inst.columnar.ensure_ready("c", "t")
        s.execute("DELETE FROM t WHERE id < 10")
        advance(inst)
        saved_seq, saved_wm = rep.seq, rep.watermark
        inst.save()
        s.close()
        inst2 = make_instance(pkg, data_dir=d)
        s2 = pkg.Session(inst2, "c")
        rep2 = inst2.columnar.replica("c", "t")
        assert rep2 is not None and rep2.state == pkg.col.READY
        assert rep2.seq == saved_seq and rep2.watermark == saved_wm
        assert rep2.reseeds == 0  # resumed, not rebuilt
        s2.execute("INSERT INTO t VALUES (900, 1, 'post'), (901, 2, 'post')")
        advance(inst2)
        on, off, routed = both(s2, Q_ALL)
        assert routed and on == off
        return on, saved_seq
    _same(scenario)


def test_compaction_races_writes_and_inflight_views():
    def scenario(pkg):
        s = fresh(pkg)
        s.instance.config.set_instance("COLUMNAR_COMPACT_ROWS", 32)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        views, out = [], []
        for rnd in range(4):
            base = 2000 + 100 * rnd
            s.execute("INSERT INTO t VALUES " + ",".join(
                f"({base + i},{i % 5},'c{rnd}')" for i in range(40)))
            s.execute(f"DELETE FROM t WHERE id >= {base} AND id < {base + 10}")
            advance(s.instance)
            views.append(rep.view())
            on, off, _ = both(s, Q_AGG)
            assert on == off
            out.append(on)
        assert rep.compactions >= 1
        tm = s.instance.catalog.table("c", "t")
        for v in views:
            live = pkg.live(v, tm, s.instance)
            assert [(live,)] == s.execute(
                f"SELECT count(*) FROM t AS OF TSO {v.watermark}").rows
            out.append(live)
        return out, rep.compactions
    _same(scenario)


@pytest.mark.parametrize("ddl", ["ALTER TABLE t ADD COLUMN extra BIGINT",
                                 "ALTER TABLE t DROP COLUMN val"])
def test_ddl_mid_tail_reseeds(ddl):
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        s.execute("INSERT INTO t VALUES (3000, 1, 'pre')")
        s.execute(ddl)
        s.execute("DELETE FROM t WHERE id = 3000")
        advance(s.instance)  # detects the signature change -> RESEED
        advance(s.instance)  # reseeds against the new schema
        assert rep.state == pkg.col.READY and rep.reseeds >= 1
        assert rep.sig == tuple(s.instance.catalog.table("c", "t").column_names())
        on, off, routed = both(s, "SELECT * FROM t ORDER BY id")
        assert routed and on == off
        return on, rep.sig
    _same(scenario)


def test_unmatched_delete_image_self_heals():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "t")
        rep.tier = ((), ())  # simulate divergence: the replica lost its rows
        rep.pk = None
        s.execute("DELETE FROM t WHERE id = 7")
        advance(s.instance)
        assert rep.state == pkg.col.RESEED  # the delete image had no live match
        advance(s.instance)
        assert rep.state == pkg.col.READY and rep.reseeds >= 1
        on, off, _ = both(s, Q_ALL)
        assert on == off
        return on
    _same(scenario)


def test_tailer_failure_is_kept_and_retried():
    """The poll thread survives a failing cycle (the reference publishes it as an
    event, the port keeps it in `tail_errors`) and stops on `Instance.shutdown()`."""
    s = fresh(PORT)
    inst = s.instance
    inst.config.set_instance("COLUMNAR_POLL_MS", 5)
    mgr = inst.columnar
    orig = mgr.tail_once
    mgr.tail_once = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    try:
        mgr._start_thread()
        deadline = time.time() + 5
        while time.time() < deadline and not mgr.tail_errors:
            time.sleep(0.01)
        assert mgr.tail_errors and "boom" in mgr.tail_errors[-1]
        assert mgr._thread.is_alive()
    finally:
        mgr.tail_once = orig
        inst.shutdown()
        inst.config.set_instance("COLUMNAR_POLL_MS", 0)
    assert not mgr._thread.is_alive()


# -- routing --------------------------------------------------------------------

def test_hatch_trio_structurally_off_path(monkeypatch):
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        time.sleep(MARGIN_S)
        mgr.ensure_ready("c", "t")
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", True)
        s.instance.config.set_instance("COLUMNAR_MIN_SCAN_ROWS", 1)
        r0 = mgr.routed.value
        off = s.execute(OFF + Q_AGG).rows  # leg 1: the hint wins over the param
        assert mgr.routed.value == r0
        assert s.execute(Q_AGG).rows == off  # param on, cold digest: routes
        assert mgr.routed.value > r0
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", False)
        r1 = mgr.routed.value
        s.execute(Q_AGG)  # leg 2: param off never routes without the hint
        assert mgr.routed.value == r1
        monkeypatch.setattr(pkg.col, "ENABLED", False)  # leg 3: the env switch
        r2 = mgr.routed.value
        assert s.execute(HINT + Q_AGG).rows == off
        assert mgr.routed.value == r2
        assert mgr.tail_once() == 0  # the tailer is dead too
        monkeypatch.setattr(pkg.col, "ENABLED", True)
        return off, mgr.routed.value
    _same(scenario)


def test_size_signal_enrolls_async_then_routes():
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", True)
        s.instance.config.set_instance("COLUMNAR_MIN_SCAN_ROWS", 1)
        s.execute("ANALYZE TABLE t")
        assert mgr.replica("c", "t") is None
        r0 = mgr.routed.value
        rows = s.execute(Q_AGG).rows  # the signal fires: enroll, stay on the row store
        assert mgr.routed.value == r0
        rep = mgr.replica("c", "t")
        assert rep is not None and rep.state == pkg.col.SEEDING
        time.sleep(MARGIN_S)
        advance(s.instance)
        assert rep.state == pkg.col.READY
        assert s.execute(Q_AGG).rows == rows
        assert mgr.routed.value > r0
        return rows
    _same(scenario)


def test_small_estimates_stay_on_the_row_store():
    """Below COLUMNAR_MIN_SCAN_ROWS the estimate keeps a query on the row store and
    enrolls nothing (the cold-digest branch of the reference's signal)."""
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", True)
        s.execute("ANALYZE TABLE t")
        rows = s.execute(Q_AGG).rows  # 200 rows < the default 50,000
        assert mgr.replica("c", "t") is None and mgr.routed.value == 0
        return rows
    _same(scenario)


def test_point_and_txn_reads_stay_on_row_store():
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        time.sleep(MARGIN_S)
        mgr.ensure_ready("c", "t")
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", True)
        s.instance.config.set_instance("COLUMNAR_MIN_SCAN_ROWS", 1)
        r0 = mgr.routed.value
        a = s.execute("SELECT val FROM t WHERE id = 7").rows  # the key-Get path
        assert mgr.routed.value == r0
        s.execute("BEGIN")
        s.execute("INSERT INTO t VALUES (7000, 1, 'txn')")
        b = s.execute(HINT + Q_AGG).rows  # txn reads see provisional rows: no route
        s.execute("ROLLBACK")
        assert mgr.routed.value == r0
        return a, b
    _same(scenario)


def test_read_your_writes_fence():
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        time.sleep(MARGIN_S)
        mgr.ensure_ready("c", "t")
        s.execute("INSERT INTO t VALUES (4000, 1, 'mine')")
        r0 = mgr.routed.value
        rows = s.execute(HINT + Q_ALL).rows  # the watermark predates the write
        assert mgr.routed.value == r0  # fence held: the row store served it
        assert (4000, 1, "mine") in rows
        other = pkg.Session(s.instance, "c")
        assert other.execute(HINT + Q_ALL).rows != rows  # no fence elsewhere
        assert mgr.routed.value > r0
        advance(s.instance)  # the watermark passes the write: the fence opens
        r1 = mgr.routed.value
        assert s.execute(HINT + Q_ALL).rows == rows
        assert mgr.routed.value > r1
        return rows
    _same(scenario)


def test_freshness_slo_blocks_stale_replica():
    def scenario(pkg):
        s = fresh(pkg)
        mgr = s.instance.columnar
        time.sleep(MARGIN_S)
        mgr.ensure_ready("c", "t")
        advance(s.instance)
        s.instance.config.set_instance("ENABLE_COLUMNAR_REPLICA", True)
        s.instance.config.set_instance("COLUMNAR_MIN_SCAN_ROWS", 1)
        s.execute(Q_AGG)
        s.instance.config.set_instance("COLUMNAR_MAX_LAG_MS", 1)
        time.sleep(0.05)  # the replica goes stale past the 1 ms SLA
        r0 = mgr.routed.value
        rows = s.execute(Q_AGG).rows
        assert mgr.routed.value == r0  # SLA blown: the row store
        assert s.execute(HINT + Q_AGG).rows == rows  # the hint overrides the SLA
        assert mgr.routed.value > r0
        return rows
    _same(scenario)


def test_zone_maps_prune_stripes():
    def scenario(pkg):
        s = fresh(pkg)
        s.instance.config.set_instance("COLUMNAR_COMPACT_ROWS", 10)
        s.execute("CREATE TABLE zp (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO zp VALUES " + ",".join(f"({i},{i})" for i in range(64)))
        time.sleep(MARGIN_S)
        rep = s.instance.columnar.ensure_ready("c", "zp")
        s.execute("INSERT INTO zp VALUES " +
                  ",".join(f"({i},{i})" for i in range(100000, 100064)))
        advance(s.instance)  # compacts the high-id delta into its own stripe
        assert len(rep.tier[0]) >= 2
        p0 = rep.pruned_stripes
        on, off, routed = both(s, "SELECT count(*), sum(v) FROM zp WHERE id < 50")
        assert routed and on == off
        assert rep.pruned_stripes > p0  # the 100000+ stripe was never scanned
        out = (on, len(rep.tier[0]), rep.pruned_stripes - p0)
        if pkg is PORT:
            # the same statement again, not replayed from the fragment cache
            s.execute("/*+TDDL:COLUMNAR(ON) FRAGMENT_CACHE(OFF)*/ "
                      "SELECT count(*), sum(v) FROM zp WHERE id < 50")
            assert any("pruned_stripes=" in ln for ln in s.last_trace)
        return out
    _same(scenario)


# -- surfaces -------------------------------------------------------------------

def test_show_and_information_schema_parity():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        s.instance.columnar.ensure_ready("c", "t")
        rs = s.execute("SHOW COLUMNAR REPLICA")
        show = rs.rows
        assert len(show) == 1 and show[0][0] == "c.t"
        assert show[0][1] == "READY" and show[0][5] > 0  # base stripes
        info = s.execute("SELECT table_name, state, base_stripes, delta_rows "
                         "FROM information_schema.columnar_replica").rows
        assert info == [(r[0], r[1], r[5], r[4]) for r in show]
        cols = s.execute("SELECT * FROM information_schema.columnar_replica").names
        # every column but the watermark and the lag, which are clocks
        stable = [r[:2] + r[4:] for r in show]
        return rs.names, [t.sql_name() for t in rs.types], cols, stable, info
    _same(scenario)


def test_explain_shows_freshness_and_route():
    def scenario(pkg):
        s = fresh(pkg)
        time.sleep(MARGIN_S)
        s.instance.columnar.ensure_ready("c", "t")
        plain = [r[0] for r in s.execute("EXPLAIN " + HINT + Q_AGG).rows]
        line = [ln for ln in plain if ln.startswith("-- columnar: c.t")]
        assert line and "freshness_lag_ms=" in line[0] and "watermark=" in line[0]
        analyzed = [r[0] for r in s.execute("EXPLAIN ANALYZE " + HINT + Q_AGG).rows]
        assert any("scan-columnar t" in ln for ln in analyzed)
        off = [r[0] for r in s.execute("EXPLAIN ANALYZE " + OFF + Q_AGG).rows]
        assert not any("columnar" in ln for ln in off)
        return line[0].split(" watermark=")[0], line[0].split(" stripes=")[1]
    _same(scenario)


def test_default_instance_has_no_columnar_footprint():
    def scenario(pkg):
        inst = make_instance(pkg)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute(DDL)
        s.execute("INSERT INTO t VALUES (1, 1, 'a')")
        rows = s.execute(Q_AGG).rows
        assert inst.columnar.replicas == {}
        assert inst.columnar.routed.value == 0
        assert inst.columnar._thread is None
        return rows
    _same(scenario)


# -- clustering and views --------------------------------------------------------

def test_clustered_seed_prunes_and_stays_identical():
    def scenario(pkg):
        s = fresh(pkg, COLUMNAR_CLUSTER_BY="t:grp", COLUMNAR_COMPACT_ROWS=64)
        inst = s.instance
        time.sleep(MARGIN_S)
        rep = inst.columnar.ensure_ready("c", "t")
        stripes = rep.tier[0]
        assert len(stripes) == 4  # 200 rows / a 64-row threshold
        ranges = [st.zmap["grp"] for st in stripes]
        assert ranges == sorted(ranges)
        for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
            assert lo >= hi - 1
        p0 = inst.columnar.pruned.value
        on, off, routed = both(s, "SELECT count(*), sum(id) FROM t WHERE grp >= 5")
        assert routed and on == off
        assert inst.columnar.pruned.value > p0
        out = [on, ranges, inst.columnar.pruned.value - p0]
        for q in (Q_ALL, Q_AGG):
            on, off, _ = both(s, q)
            assert on == off
            out.append(on)
        return out
    _same(scenario)


def test_cluster_spec_unknown_column_is_ignored():
    def scenario(pkg):
        inst = make_instance(pkg, COLUMNAR_CLUSTER_BY="t:nope,other:grp")
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute(DDL)
        s.execute("INSERT INTO t VALUES (1, 1, 'a'), (2, 2, 'b')")
        time.sleep(MARGIN_S)
        rep = inst.columnar.ensure_ready("c", "t")
        on, off, _ = both(s, Q_ALL)
        assert rep.state == pkg.col.READY and on == off
        return on
    _same(scenario)


def test_view_snapshot_is_consistent_tuple():
    def scenario(pkg):
        s = fresh(pkg)
        inst = s.instance
        time.sleep(MARGIN_S)
        rep = inst.columnar.ensure_ready("c", "t")
        v = rep.view()
        assert (v.stripes, v.delta) == rep.tier
        assert v.events == rep.applied_events
        assert v.max_applied_ts == rep.max_applied_ts
        inst.config.set_instance("COLUMNAR_COMPACT_ROWS", 1)
        ev = rep.applied_events
        s.execute("INSERT INTO t VALUES (1000, 1, 'x')")
        advance(inst)
        assert rep.compactions >= 1
        v2 = rep.view()
        assert v2.events == rep.applied_events > ev
        assert v2.delta == ()  # the compacted tier republished
        return rep.compactions, v2.events
    _same(scenario)


def test_stripe_lanes_stay_in_the_device_cache():
    """A stripe's lanes go to the device once: a second routed query ships only the
    visibility masks (none here) and hits the cache for every lane.  The queries run
    without the fragment cache, which would replay the second one whole."""
    s = fresh(PORT)
    inst = s.instance
    time.sleep(MARGIN_S)
    inst.columnar.ensure_ready("c", "t")
    hint = "/*+TDDL:COLUMNAR(ON) FRAGMENT_CACHE(OFF)*/ "
    s.execute(hint + Q_AGG)
    m0, h0 = inst.device_cache.misses, inst.device_cache.hits
    s.execute(hint + Q_AGG)
    assert inst.device_cache.misses == m0 and inst.device_cache.hits > h0


# -- a checkpoint booted across the packages --------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_replica_and_archive_boot_in_the_other_package(tmp_path, direction):
    """A replica and an archive saved by one package boot in the other with equal
    rows: the replica's `.npz` stripes and metadb record, the archive's manifest and
    Parquet files."""
    pytest.importorskip("pyarrow")
    from galaxysql_tpu.types import temporal
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    d = str(tmp_path / "data")
    inst = make_instance(src, data_dir=d)
    s = src.Session(inst)
    s.execute("CREATE DATABASE c; USE c")
    s.execute(DDL)
    s.execute("INSERT INTO t VALUES " +
              ",".join(f"({i},{i % 7},'v{i % 5}')" for i in range(200)))
    s.execute("CREATE TABLE ev (id BIGINT, d DATE, tag VARCHAR(8))")
    base = temporal.parse_date("2020-01-01")
    inst.store("c", "ev").insert_arrays(
        {"id": np.arange(100), "d": base + np.arange(100),
         "tag": ["a" if i % 2 else "b" for i in range(100)]},
        inst.tso.next_timestamp())
    assert inst.archive.archive_older_than(inst, "c", "ev", "d", base + 40) == 40
    time.sleep(MARGIN_S)
    rep = inst.columnar.ensure_ready("c", "t")
    s.execute("DELETE FROM t WHERE id < 30")
    s.execute("INSERT INTO t VALUES (900, 1, 'post')")
    advance(inst)
    want = (both(s, Q_ALL)[0], s.execute(Q_AGG).rows,
            s.execute("SELECT count(*), min(id), max(id) FROM ev").rows,
            s.execute("SELECT tag, count(*) FROM ev GROUP BY tag ORDER BY tag").rows)
    saved = (rep.seq, rep.watermark, len(rep.tier[0]), rep.delta_rows)
    inst.save()
    s.close()
    inst2 = make_instance(dst, data_dir=d)
    rep2 = inst2.columnar.replica("c", "t")
    assert rep2 is not None and rep2.state == dst.col.READY
    assert (rep2.seq, rep2.watermark, len(rep2.tier[0]), rep2.delta_rows) == saved
    assert inst2.archive.files_for("c.ev")
    s2 = dst.Session(inst2, "c")
    on, off, routed = both(s2, Q_ALL)
    assert routed and on == off
    got = (on, s2.execute(Q_AGG).rows,
           s2.execute("SELECT count(*), min(id), max(id) FROM ev").rows,
           s2.execute("SELECT tag, count(*) FROM ev GROUP BY tag ORDER BY tag").rows)
    assert got == want
    s2.close()
    shutil.rmtree(d, ignore_errors=True)
    assert not os.path.exists(d)
