"""Query profiles, SHOW and `information_schema` surfaces, the span tree, the web
console over HTTP, GET_LOCK / RELEASE_LOCK and the dispatch accounting in the port
against the JAX package (`tests/test_observability.py`, `tests/test_tracing.py`,
`tests/test_web_console.py`, `tests/test_flashback_locks.py`).

Every test runs one script through a JAX `Instance` and a port
`Instance(device="cpu")` and asserts equal outcomes (`torch_plane_harness.both`).
Trace ids, node ids, wall times and the three COMPILE_STATS counters are left out
of every comparison.  The span trees are compared by the names and kinds of their
spans with their parents' names: the root, the operator spans, the fused segments
and the host-to-device transfer events; the reference's per-operator `compile`
events are left out (XLA programs, which the port has no counterpart of)."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_plane_harness import both, mk

pytestmark = pytest.mark.torch_port


def _obs(pkg, schema="obs"):
    inst, s = mk(pkg, schema)
    s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT)")
    inst.store(schema, "t").insert_pylists(
        {"a": list(range(4000)), "b": [i % 11 for i in range(4000)]},
        inst.tso.next_timestamp())
    return inst, s


# -- query profiles -------------------------------------------------------------------


def test_default_path_records_lightweight_profile():
    def scenario(pkg):
        inst, s = _obs(pkg)
        r = s.execute("SELECT count(*) FROM t WHERE a < 100")
        p = inst.profiles.entries()[-1]
        out = (p.sql, p.profiled, p.op_stats, len(p.segments), p.rows, len(r.rows),
               p.elapsed_ms > 0, p.workload, p.engine)
        s.execute("SELECT count(*) FROM t")
        newer = inst.profiles.entries()[-1].trace_id > p.trace_id
        linked = f"trace-id {inst.profiles.entries()[-1].trace_id}" in s.last_trace
        return out, newer, linked
    out, newer, linked = both(scenario)
    assert out[1] is False and out[4] == 1 and newer and linked


def test_profiling_collects_operators_and_segments():
    def scenario(pkg):
        inst, s = _obs(pkg)
        s.execute("SET ENABLE_QUERY_PROFILING = 1")
        r = s.execute("SELECT a, b * 2 FROM t WHERE a < 500")
        s.execute("SET ENABLE_QUERY_PROFILING = 0")
        p = inst.profiles.entries()[-1]
        by_op = {st["operator"]: (st["rows_out"], bool(st.get("fused")))
                 for st in p.op_stats}
        return (p.profiled, by_op, [sp.chain for sp in p.segments],
                [(sp.rows_in, sp.rows_out) for sp in p.segments], p.rows, len(r.rows))
    out = both(scenario)
    assert out[0] and out[1]["Filter"] == (500, True) and out[2] == ["filter>project"]
    assert out[3] == [(4000, 500)] and out[4] == 500


def test_point_path_profiles_and_slow_links():
    def scenario(pkg):
        inst, s = _obs(pkg)
        s.execute("SET SLOW_SQL_MS = 0")
        s.execute("SELECT b FROM t WHERE a = 7")
        s.execute("SELECT b FROM t WHERE a = 7")
        s.execute("SET SLOW_SQL_MS = -1")
        p = inst.profiles.entries()[-1]
        rows = s.execute("SHOW SLOW").rows
        return (p.engine, p.workload, p.rows,
                any(r[3] == p.trace_id and r[4] == "TP" for r in rows),
                [(r[2], r[4], r[5]) for r in rows])
    out = both(scenario)
    assert out[:4] == ("point", "TP", 1, True)


def test_explain_analyze_records_a_profile_and_attribution():
    def scenario(pkg):
        inst, s = _obs(pkg)
        lines = [r[0] for r in s.execute(
            "EXPLAIN ANALYZE SELECT b, count(*) FROM t GROUP BY b").rows]
        p = inst.profiles.entries()[-1]
        keys = sorted(ln.split(":")[0] for ln in lines
                      if ln.startswith(("-- trace_id", "-- rows", "-- compile",
                                        "-- transfer", "-- elapsed")))
        return keys, p.sql, p.profiled, p.rows, \
            f"-- trace_id: {p.trace_id}" in lines
    keys, sql, profiled, rows, linked = both(scenario)
    assert keys == ["-- compile", "-- elapsed", "-- rows", "-- trace_id",
                    "-- transfer"]
    assert sql == "<explain analyze>" and profiled and rows == 11 and linked


# -- SQL surfaces ---------------------------------------------------------------------


def test_show_full_stats_stats_and_query_stats():
    def scenario(pkg):
        inst, s = _obs(pkg, "surf")
        s.execute("SELECT count(*) FROM t")
        full = s.execute("SHOW FULL STATS")
        newest = full.rows[0][0] == inst.profiles.entries()[-1].trace_id
        plain = s.execute("SHOW STATS")
        s.execute("SELECT count(*) FROM t WHERE a > 5")
        qs = s.execute("SELECT trace_id, workload, engine, rows_returned FROM "
                       "information_schema.query_stats").rows
        ids = [r[0] for r in qs]
        return (full.names, newest, plain.names, sorted(n for n, _v in plain.rows),
                ids == sorted(ids), [r[1:] for r in qs])
    out = both(scenario)
    assert out[0][0] == "Trace_id" and "Max_shard_rows" in out[0] and out[1]
    assert out[2] == ["Name", "Value"] and out[4]


def test_metrics_roundtrip_counter_bump():
    def scenario(pkg):
        inst, s = _obs(pkg, "mr")
        inst.counters["obs_test_bumps"] += 3
        r = s.execute("SELECT metric_kind, value FROM information_schema.metrics "
                      "WHERE metric_name = 'engine_obs_test_bumps'").rows
        show = {row[0]: row[2] for row in s.execute("SHOW METRICS").rows}
        return r, show["engine_obs_test_bumps"]
    assert both(scenario) == ([("counter", 3.0)], 3.0)


def test_metric_names_and_kinds_equal_after_a_script():
    """After the same script the registries hold the same metric names and kinds,
    the `device_cache_*` gauges and the group-commit counters among them, and the
    same counts of queries by workload and engine.  The gauges' values are compared
    with the instance's own cache in the port only: the reference's cache is one for
    the whole process, the port's one for each instance, so their counts differ by
    what earlier instances of the process cached."""
    def scenario(pkg):
        inst, s = _obs(pkg, "mn")
        s.execute("SELECT b FROM t WHERE a = 1")
        s.execute("SELECT b FROM t WHERE a = 2")
        s.execute("SELECT b, count(*) FROM t GROUP BY b")
        s.execute("INSERT INTO t VALUES (5000, 1)")
        s.execute("BEGIN")
        s.execute("INSERT INTO t VALUES (5001, 2)")
        s.execute("COMMIT")
        rows = inst.metrics.rows()
        kinds = sorted((n, k) for n, k, _v, _h in rows
                       if not n.startswith(("compile_cache", "pallas", "kernel")))
        counts = {n: v for n, k, v, _h in rows
                  if n.startswith(("queries_", "engine_exec_", "group_commit"))}
        show = {r[0]: r[1] for r in s.execute("SHOW METRICS").rows}
        listed = sorted(n for n in show if n.startswith(("device_cache", "group_comm")))
        own = None
        if pkg.name == "port":
            g = {n: v for n, _k, v, _h in rows if n.startswith("device_cache_")}
            c = inst.device_cache
            own = (g["device_cache_misses"] == c.misses,
                   g["device_cache_bytes"] == c.nbytes,
                   g["device_cache_entries"] == len(c._map),
                   g["device_cache_hits"] <= c.hits)
        return kinds, counts, listed, own
    kinds, counts, listed, _own = both_port_checked(scenario)
    assert counts["queries_total"] == 3 and counts["engine_exec_point"] == 1
    assert counts["group_commit_batches"] >= 1 and counts["group_committed_txns"] >= 2
    assert listed == ["device_cache_bytes", "device_cache_entries", "device_cache_hits",
                      "device_cache_misses", "group_commit_batches",
                      "group_committed_txns"]
    assert ("device_cache_hits", "gauge") in kinds


def both_port_checked(scenario):
    """`both` for a scenario whose last element only the port fills (its own
    checks, all true)."""
    got = {}

    def run(pkg):
        *same, own = scenario(pkg)
        got[pkg.name] = own
        return tuple(same)
    out = both(run)
    assert got["jax"] is None and got["port"] is not None and all(got["port"]), got
    return (*out, got["port"])


def _span_names(spans, skip=("compile",)):
    """(kind, name, parent's name) of every span but those of the `skip` kinds,
    sorted."""
    by_id = {sp.span_id: sp for sp in spans}
    return sorted((sp.kind, sp.name, by_id[sp.parent_id].name
                   if sp.parent_id in by_id else None)
                  for sp in spans if sp.kind not in skip)


@pytest.fixture(scope="module")
def tpch_arrays():
    from galaxysql_tpu.storage import tpch
    return tpch.generate(0.01)


def test_traced_query_builds_a_span_tree_and_show_trace(tpch_arrays):
    """A traced query's tree: the root, one operator span a plan node under its
    parent's, the fused segments and the transfers under the operator that ran
    them, and `segment_wall_ms` observed once a timed segment run.  TPC-H SF 0.01
    Q3 uncached, then a small two-table join and a GROUP BY.  The small queries'
    transfer events are left out: the reference scans a table this small as a
    host numpy batch, past its device cache (ROADMAP, "Allowed by rule 2")."""
    from galaxysql_tpu.storage import tpch
    from galaxysql_tpu.storage.tpch_queries import QUERIES

    def scenario(pkg):
        inst, s = _obs(pkg, "tr")
        for t in tpch.TABLE_ORDER:
            s.execute(tpch.TPCH_DDL[t])
            inst.store("tr", t).insert_pylists(tpch_arrays[t], inst.tso.next_timestamp())
        s.execute("SET ENABLE_QUERY_TRACING = 1")
        seg = inst.metrics.histogram("segment_wall_ms")
        trees = []
        for sql, skip in (
                ("/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + QUERIES[3], ("compile",)),
                ("SELECT count(*) FROM t t1, nation n WHERE t1.b = n.n_nationkey",
                 ("compile", "transfer")),
                ("SELECT b, count(*) FROM t WHERE a < 100 GROUP BY b",
                 ("compile", "transfer"))):
            c0 = seg.count
            rows = s.execute(sql).rows
            trees.append((_span_names(s.last_spans, skip), seg.count - c0,
                          sorted(rows)))
        spans = s.last_spans
        root = spans[0]
        phases = sorted(k for k in root.attrs.get("phases", {})
                        if k not in ("compile", "fence_wait"))
        tree = [r[0] for r in s.execute("SHOW TRACE").rows]
        q = s.execute("SELECT span_name, kind FROM information_schema.query_spans "
                      "WHERE kind = 'query'").rows
        trace_id = inst.profiles.entries()[-1].trace_id
        return (root.name, root.kind, root.parent_id, phases,
                tree[0].startswith("trace-id"), any("query" in ln for ln in tree),
                sorted(set(q)), trace_id > 0, trees)
    out = both(scenario)
    assert out[0:3] == ("query", "query", 0) and "execute" in out[3]
    q3, join, _agg = out[8]
    kinds = [k for k, _n, _p in q3[0]]
    assert kinds.count("operator") == 9 and kinds.count("transfer") >= 10
    assert ("segment", "segment:rf", "Scan") in q3[0] and q3[1] >= 1
    assert [k for k, _n, _p in join[0]].count("operator") >= 4


def test_error_spans_and_slow_log():
    def scenario(pkg):
        inst, s = _obs(pkg, "er")
        s.execute("SET ENABLE_QUERY_TRACING = 1")
        s.execute("SET SLOW_SQL_MS = 0")
        try:
            s.execute("SELECT nope FROM t")
        except pkg.errors.TddlError as e:
            err = type(e).__name__
        kinds = [sp.kind for sp in s.last_spans]
        slow = [(r[5], r[2]) for r in s.execute("SHOW SLOW").rows if r[5]]
        errs = inst.metrics.counter("query_errors").value
        return err, kinds.count("error"), slow, errs, s.last_trace[1][:5]
    assert both(scenario) == ("UnknownColumnError", 1,
                              [("UnknownColumnError", "SELECT nope FROM t")], 1,
                              "error")


def test_tracing_off_keeps_results_and_dispatches():
    def scenario(pkg):
        inst, s = _obs(pkg, "to")
        q = "SELECT b, sum(a) FROM t WHERE a < 3000 GROUP BY b ORDER BY b"
        s.execute(q)
        pkg.ops.reset_dispatch_stats()
        on = s.execute(q).rows
        d_on = pkg.ops.DISPATCH_STATS["dispatches"]
        inst.config.set_instance("ENABLE_QUERY_TRACING", False)
        pkg.ops.reset_dispatch_stats()
        off = s.execute(q).rows
        return on == off, d_on, pkg.ops.DISPATCH_STATS["dispatches"], s.last_spans
    same, d_on, d_off, spans = both(scenario)
    assert same and d_on == d_off > 0 and spans == []


@pytest.mark.parametrize("sql", [
    "SELECT a, b * 3 FROM t WHERE a < 1500",
    "SELECT b, count(*), sum(a) FROM t GROUP BY b ORDER BY b",
    "SELECT count(*) FROM t t1, t t2 WHERE t1.a = t2.a AND t1.b < 3",
    "SELECT b FROM t WHERE a = 17",
])
def test_dispatches_equal_the_reference(sql):
    """`DISPATCH_STATS["dispatches"]` counts at the reference's program boundaries:
    the same script counts the same on the CPU in both packages."""
    def scenario(pkg):
        _inst, s = _obs(pkg, "dp")
        s.execute(sql)
        pkg.ops.reset_dispatch_stats()
        rows = s.execute(sql).rows
        return pkg.ops.DISPATCH_STATS["dispatches"], sorted(rows)
    d, _rows = both(scenario)
    assert d >= 0


# -- the web console over HTTP --------------------------------------------------------


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        body = r.read()
        return r.headers.get("Content-Type"), body


def test_web_routes_over_http():
    """Every route of the console, started on 127.0.0.1:0 and read over HTTP:
    each JSON route parses, `/metrics` is Prometheus text, an unknown resource is
    a 404, and the bodies agree between the packages and with the SHOW surfaces
    read at the same moment."""
    def scenario(pkg):
        inst, s = _obs(pkg, "wc")
        s.execute("SET GLOBAL SLOW_SQL_MS = 0")
        s.execute("SELECT count(*) FROM t")
        s.execute("SELECT t.a, count(*) FROM t, t t2 WHERE t.a = t2.b GROUP BY t.a")
        for k in range(1, 4):
            assert inst.slo_tick(now=1_700_000_000.0 + 5 * k, force=True)
        web = pkg.WebConsole(inst)
        port = web.start()
        try:
            out = {}
            for path in ("/status", "/queries", "/cluster", "/plan-cache",
                         "/baselines", "/scheduler", "/query-stats", "/statements",
                         "/traces", "/incidents", "/health",
                         "/timeseries/queries_total", "/events", "/events?kind=ddl"):
                ctype, body = _fetch(port, path)
                out[path] = (ctype, json.loads(body))
            trace_id = inst.profiles.entries()[-1].trace_id
            _c, q = _fetch(port, f"/query/{trace_id}")
            mtype, mtext = _fetch(port, "/metrics")
            try:
                _fetch(port, "/nope")
                missing = None
            except urllib.error.HTTPError as e:
                missing = e.code
            show_stmts = s.execute("SHOW STATEMENT SUMMARY").rows
            show_events = s.execute("SHOW EVENTS").rows
            show_health = s.execute("SHOW CLUSTER HEALTH").rows
            show_ts = {r[0]: r for r in s.execute(
                "SHOW METRIC HISTORY LIKE 'queries_total'").rows}
        finally:
            web.stop()
        st = out["/status"][1]
        health = out["/health"][1]
        ts = out["/timeseries/queries_total"][1]
        agree = (
            st["node_id"] == inst.node_id,
            sorted((x["digest"], x["execs"]) for x in out["/statements"][1]["statements"])
            == sorted((r[0], r[4]) for r in show_stmts),
            [e["seq"] for e in out["/events"][1]["events"]] == [r[0] for r in show_events],
            health["status"] == ("degraded" if show_health[0][3] == "BURNING" else "ok"),
            health["history"]["samples"] == show_health[0][11],
            len(ts["points"]) == show_ts["queries_total"][1],
            ts["points"][-1][1] == show_ts["queries_total"][2])
        shape = {p: (c, sorted(b) if isinstance(b, dict) else type(b).__name__)
                 for p, (c, b) in out.items()}
        return (shape, agree, sorted(json.loads(q)), mtype, "galaxysql_queries_total" in
                mtext.decode(), missing, st["counters"].get("point_plan_queries"),
                [e["kind"] for e in out["/events?kind=ddl"][1]["events"]],
                len(out["/queries"][1]["slow_queries"]) > 0,
                out["/cluster"][1]["nodes"].get(inst.node_id),
                out["/plan-cache"][1]["size"] >= 1,
                len(out["/baselines"][1]["baselines"]))
    out = both(scenario)
    assert all(out[1]) and out[5] == 404 and out[3].startswith("text/plain")
    assert out[4] and out[9] == "ALIVE" and out[10]


# -- GET_LOCK and RELEASE_LOCK --------------------------------------------------------


def test_get_lock_family():
    def scenario(pkg):
        _inst, s = mk(pkg, "lk")
        q = lambda sess, sql: sess.execute(sql).rows[0][0]  # noqa: E731
        out = [q(s, "SELECT GET_LOCK('m', 0)"), q(s, "SELECT IS_FREE_LOCK('m')"),
               q(s, "SELECT IS_USED_LOCK('m')") == s.conn_id,
               q(s, "SELECT RELEASE_LOCK('m')"), q(s, "SELECT IS_FREE_LOCK('m')"),
               q(s, "SELECT RELEASE_LOCK('m')")]
        out += [q(s, "SELECT GET_LOCK('r', 0)"), q(s, "SELECT GET_LOCK('r', 0)"),
                q(s, "SELECT RELEASE_LOCK('r')"), q(s, "SELECT IS_FREE_LOCK('r')"),
                q(s, "SELECT RELEASE_LOCK('r')"), q(s, "SELECT IS_FREE_LOCK('r')")]
        return out
    assert both(scenario) == [1, 0, True, 1, 1, None, 1, 1, 1, 0, 1, 1]


def test_get_lock_blocks_across_sessions_and_close_releases():
    def scenario(pkg):
        inst, s = mk(pkg, "lb")
        s2 = pkg.Session(inst, schema="lb")
        q = lambda sess, sql: sess.execute(sql).rows[0][0]  # noqa: E731
        out = [q(s, "SELECT GET_LOCK('b', 0)"), q(s2, "SELECT GET_LOCK('b', 0)"),
               q(s2, "SELECT GET_LOCK('b', 0.05)"), q(s2, "SELECT RELEASE_LOCK('b')")]
        got = []
        waiter = threading.Thread(
            target=lambda: got.append(q(s2, "SELECT GET_LOCK('b', 10)")))
        waiter.start()
        time.sleep(0.05)  # one poll: the waiter is (or is about to be) blocked
        out.append(list(got))  # it cannot acquire while the first session holds it
        q(s, "SELECT RELEASE_LOCK('b')")
        waiter.join(10)
        out.append(list(got))
        s3 = pkg.Session(inst, schema="lb")
        out.append(q(s3, "SELECT GET_LOCK('c', 0)"))
        out.append(q(s, "SELECT GET_LOCK('c', 0)"))
        s3.close()
        out.append(q(s, "SELECT GET_LOCK('c', 0)"))
        s2.close()
        return out
    assert both(scenario) == [1, 0, 0, 0, [], [1], 1, 0, 1]
