"""The SLO plane, the metric history, the flight recorder, the scheduler and the
cluster-health view in the port against the JAX package (`tests/test_slo.py`,
`tests/test_flight_recorder.py`).

Every test runs one script through a JAX `Instance` and a port
`Instance(device="cpu")` and asserts equal outcomes (`torch_plane_harness.both`).
Time is synthetic: `slo_tick(now=t0 + 5 k, force=True)` with stamps 5 s apart, and
latency storms come from `FP_SLO_LATENCY_MS`, which pads each observed latency.
The burn ratios and every measured latency are left out of the comparisons (they
hold the few measured milliseconds under the pad); states, event kinds, counts and
the counters' replayed values are compared.  `cluster_health` runs over a port
worker and over a JAX worker (`tests/torch_worker_harness.py`)."""

import json
import os
import time

import numpy as np
import pytest

from torch_plane_harness import both
from torch_worker_harness import WorkerProc

pytestmark = pytest.mark.torch_port


def _mk(pkg, schema, rows=200, data_dir=None):
    inst = pkg.Instance(data_dir=data_dir)
    s = pkg.Session(inst)
    s.execute(f"CREATE DATABASE IF NOT EXISTS {schema}")
    s.execute(f"USE {schema}")
    if rows:
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT)")
        inst.store(schema, "t").insert_arrays(
            {"a": np.arange(rows), "b": np.arange(rows) % 17},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE t")
    return inst, s


class _Ticker:
    """Synthetic 5 s-spaced ticks; each must land (a swallowed sampler fault
    returns False and fails here)."""

    def __init__(self, inst, t0=1_700_000_000.0):
        self.inst, self.t0, self.n = inst, t0, 0

    def __call__(self, k=1):
        for _ in range(k):
            self.n += 1
            assert self.inst.slo_tick(now=self.t0 + 5.0 * self.n, force=True)


def _states(inst):
    return {r[0]: r[8] for r in inst.slo.rows()}


def _kinds(pkg, kind=None):
    return [(e.kind, e.severity, e.attrs.get("slo") or e.attrs.get("metric"))
            for e in pkg.EVENTS.entries() if kind is None or e.kind == kind]


def _run(s, n, mod=200):
    for i in range(n):
        s.execute(f"SELECT b FROM t WHERE a = {i % mod}")


# -- the metric history ---------------------------------------------------------------


def test_sample_replay_rate():
    def scenario(pkg):
        inst, _s = _mk(pkg, "mh1")
        T = _Ticker(inst)
        c = inst.metrics.counter("mh_probe", "test probe")
        for _ in range(5):
            c.inc(10)
            T()
        mh = inst.metric_history
        return ([v for _t, v in mh.series("mh_probe")], mh.rate("mh_probe"),
                mh.latest("mh_probe"),
                [round(dv, 6) for _t, dv in mh.derivative("mh_probe")],
                "mh_probe" in mh.counter_names())
    assert both(scenario) == ([10.0, 20.0, 30.0, 40.0, 50.0], 2.0, 50.0,
                              [2.0] * 4, True)


def test_eviction_folds_into_base_replay_exact():
    def scenario(pkg):
        inst, _s = _mk(pkg, "mh2", rows=0)
        inst.config.set_instance("METRIC_HISTORY_SAMPLES", 4)
        T = _Ticker(inst)
        c = inst.metrics.counter("evict_probe", "test probe")
        for _ in range(10):
            c.inc()
            T()
        mh = inst.metric_history
        return (mh.samples_count, [v for _t, v in mh.series("evict_probe")],
                mh.latest("evict_probe"), mh.mean("evict_probe"))
    assert both(scenario) == (4, [7.0, 8.0, 9.0, 10.0], 10.0, 8.5)


def test_hatch_off_no_samples():
    def scenario(pkg):
        inst, _s = _mk(pkg, "mh3", rows=0)
        inst.config.set_instance("ENABLE_METRIC_HISTORY", 0)
        return (inst.metric_history.sample(), inst.slo_tick(force=True),
                inst.metric_history.samples_count)
    assert both(scenario) == (None, False, 0)


def test_every_registry_histogram_lands_in_a_sample():
    def scenario(pkg):
        inst, s = _mk(pkg, "mh4")
        s.execute("SELECT b FROM t WHERE a = 7")
        vals = inst.metric_history.sample()
        histos = sorted({n for n, k, _v, _h in inst.metrics.rows()
                         if k == "histogram" and n.endswith("_p99")})
        return histos, [n for n in histos if n not in vals]
    histos, missing = both(scenario)
    assert "query_latency_ms_p99" in histos and not missing


def test_sample_costs_zero_dispatches_and_history_on_off_identical():
    def scenario(pkg):
        inst, s = _mk(pkg, "hp1", rows=3000)
        q = "SELECT a, b * 3 FROM t WHERE a < 1500"
        s.execute(q)
        pkg.ops.reset_dispatch_stats()
        for _ in range(5):
            assert inst.metric_history.sample() is not None
            inst.slo.evaluate()
        sampler = pkg.ops.DISPATCH_STATS["dispatches"]
        pkg.ops.reset_dispatch_stats()
        on = s.execute(q).rows
        inst.slo_tick(force=True)
        d_on = pkg.ops.DISPATCH_STATS["dispatches"]
        inst.config.set_instance("ENABLE_METRIC_HISTORY", 0)
        pkg.ops.reset_dispatch_stats()
        off = s.execute(q).rows
        inst.slo_tick(force=True)
        return sampler, d_on, pkg.ops.DISPATCH_STATS["dispatches"], on == off
    sampler, d_on, d_off, same = both(scenario)
    assert sampler == 0 and d_on == d_off and same


# -- burn and recovery ----------------------------------------------------------------


def test_injected_latency_trips_fast_window_then_recovers():
    def scenario(pkg):
        inst, s = _mk(pkg, "burn")
        inst.config.set_instance("SLO_FAST_WINDOW_SAMPLES", 2)
        inst.config.set_instance("SLO_SLOW_WINDOW_SAMPLES", 4)
        T = _Ticker(inst)
        out = []
        _run(s, 10)
        T(4)
        out.append((_states(inst), inst.slo.burning_names()))
        pkg.FAIL_POINTS.arm(pkg.fp.FP_SLO_LATENCY_MS, {"ms": 10000, "workload": "TP"})
        _run(s, 20)
        T(3)
        burn = pkg.EVENTS.entries(kind="slo_burn")
        reg = {n: v for n, _k, v, _h in inst.metrics.rows()}
        h = pkg.WebConsole(inst).resource("/health")
        out.append((_states(inst), inst.slo.burning_names(),
                    [(e.severity, e.attrs["slo"], float(e.attrs["fast_burn"]) >= 2.0)
                     for e in burn], reg["slo_burn_active"],
                    (h["status"], h["ready"], h["burning_slos"])))
        pkg.FAIL_POINTS.disarm(pkg.fp.FP_SLO_LATENCY_MS)
        _run(s, 140)
        T(3)
        rec = pkg.EVENTS.entries(kind="slo_recovered")
        h = pkg.WebConsole(inst).resource("/health")
        out.append((_states(inst), [(e.severity, e.attrs["slo"]) for e in rec],
                    (h["status"], h["ready"])))
        return out
    steady, burning, recovered = both(scenario)
    assert steady[0]["tp_latency_p99"] == "OK" and steady[1] == []
    assert burning[0]["tp_latency_p99"] == "BURNING"
    assert burning[2][-1] == ("critical", "tp_latency_p99", True)
    assert burning[4] == ("degraded", False, ["tp_latency_p99"])
    assert recovered[0]["tp_latency_p99"] == "OK"
    assert recovered[1][-1] == ("info", "tp_latency_p99") and recovered[2] == ("ok", True)


def test_scoped_slo_burns_only_its_tenant():
    def scenario(pkg):
        inst, s = _mk(pkg, "ten_a")
        s2 = pkg.Session(inst)
        s2.execute("CREATE DATABASE ten_b")
        s2.execute("USE ten_b")
        s2.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT)")
        inst.store("ten_b", "t").insert_arrays(
            {"a": np.arange(50), "b": np.arange(50)}, inst.tso.next_timestamp())
        inst.config.set_instance("SLO_FAST_WINDOW_SAMPLES", 2)
        inst.config.set_instance("SLO_SLOW_WINDOW_SAMPLES", 4)
        s.execute("CREATE SLO tenant_a_p99 WITH TARGET_P99_MS = 250, "
                  "SCHEMA = 'ten_a', CLASS = 'TP'")
        T = _Ticker(inst)
        out = []
        for i in range(10):
            s.execute(f"SELECT b FROM t WHERE a = {i}")
            s2.execute(f"SELECT b FROM t WHERE a = {i}")
        T(4)
        out.append(_states(inst)["tenant_a_p99"])
        pkg.FAIL_POINTS.arm(pkg.fp.FP_SLO_LATENCY_MS,
                            {"ms": 10000, "workload": "TP", "schema": "ten_b"})
        _run(s2, 20, 50)
        T(3)
        out.append(_states(inst)["tenant_a_p99"])
        pkg.FAIL_POINTS.arm(pkg.fp.FP_SLO_LATENCY_MS,
                            {"ms": 10000, "workload": "TP", "schema": "ten_a"})
        _run(s, 20)
        T(3)
        out.append(_states(inst)["tenant_a_p99"])
        return out
    assert both(scenario) == ["OK", "OK", "BURNING"]


def test_retrace_storm_fires_metric_anomaly():
    def scenario(pkg):
        inst, s = _mk(pkg, "anom")
        T = _Ticker(inst)
        before = pkg.ops.COMPILE_STATS["retraces"]
        try:
            for i in range(6):
                s.execute(f"SELECT b FROM t WHERE a = {i}")
                T()
            quiet = _kinds(pkg, "metric_anomaly")
            pkg.ops.COMPILE_STATS["retraces"] += 5000
            T()
            hit = [e for e in pkg.EVENTS.entries(kind="metric_anomaly")
                   if e.attrs.get("metric") == "compile_retraces"]
            first = [(e.severity, float(e.attrs["rate"]) > float(e.attrs["baseline"]))
                     for e in hit]
            pkg.ops.COMPILE_STATS["retraces"] += 5000
            T()
            again = len([e for e in pkg.EVENTS.entries(kind="metric_anomaly")
                         if e.attrs.get("metric") == "compile_retraces"])
        finally:
            pkg.ops.COMPILE_STATS["retraces"] = before
        return quiet, first, again
    quiet, first, again = both(scenario)
    assert not quiet and first == [("warn", True)] and again == 1


# -- CREATE / DROP SLO ----------------------------------------------------------------


def test_create_show_drop_round_trip():
    def scenario(pkg):
        _inst, s = _mk(pkg, "sql1", rows=0)

        def run(q):
            try:
                s.execute(q)
                return "ok"
            except pkg.errors.TddlError as e:
                return type(e).__name__, str(e)
        out = [run("CREATE SLO gold_tp WITH TARGET_P99_MS = 100, SCHEMA = 'sql1', "
                   "CLASS = 'TP'")]
        out.append(sorted(r[:5] + (r[8], r[10]) for r in s.execute("SHOW SLO").rows))
        out += [run("CREATE SLO gold_tp WITH TARGET_P99_MS = 50"),
                run("CREATE SLO IF NOT EXISTS gold_tp WITH TARGET_P99_MS = 50"),
                run("CREATE SLO bad WITH TARGET_P99_MS = 1, ERROR_RATIO = 0.1"),
                run("CREATE SLO bad WITH ERROR_RATIO = -1"),
                run("DROP SLO gold_tp"), run("DROP SLO gold_tp"),
                run("DROP SLO IF EXISTS gold_tp")]
        out.append(sorted(r[0] for r in s.execute("SHOW SLO").rows))
        return out
    out = both(scenario)
    assert out[0] == "ok" and ("gold_tp", "latency_p99", "sql1", "TP", 100.0, "OK",
                               "sql") in out[1]
    assert out[2][0] == "TddlError" and out[3] == "ok" and out[6] == "ok"
    assert out[7][0] == "TddlError" and "gold_tp" not in out[-1]


def test_slo_persists_across_restart(tmp_path):
    def scenario(pkg):
        d = str(tmp_path / f"slokv-{pkg.name}")
        _inst, s = _mk(pkg, "sql2", rows=0, data_dir=d)
        s.execute("CREATE SLO durable_err WITH ERROR_RATIO = 0.05, SCHEMA = 'sql2'")
        s.close()
        inst2 = pkg.Instance(data_dir=d)
        names = {x.name: (x.kind, x.target, x.schema) for x in inst2.slo.defs()}
        pkg.Session(inst2).execute("DROP SLO durable_err")
        inst3 = pkg.Instance(data_dir=d)
        return names.get("durable_err"), sorted(x.name for x in inst3.slo.defs())
    got, left = both(scenario)
    assert got == ("error_ratio", 0.05, "sql2") and "durable_err" not in left


# -- surfaces -------------------------------------------------------------------------


def test_show_metric_history_and_information_schema():
    def scenario(pkg):
        inst, s = _mk(pkg, "surf1")
        s.execute("SELECT b FROM t WHERE a = 1")
        _Ticker(inst)(2)
        like = s.execute("SHOW METRIC HISTORY LIKE 'queries%'").rows
        q = {r[0]: (r[1], r[2]) for r in like}
        names = sorted(r[0] for r in s.execute("SHOW METRIC HISTORY").rows)
        slo = sorted(s.execute("SELECT slo_name, state FROM "
                               "information_schema.slo_status").rows)
        mh = s.execute("SELECT metric_name, points FROM information_schema."
                       "metric_history WHERE metric_name = 'queries_total'").rows
        ch = s.execute("SELECT role, state FROM information_schema."
                       "cluster_health").rows
        return (all(r[0].startswith("queries") for r in like), q["queries_total"],
                "stmt_class_tp_recent_p99_ms" in names, "admission_tp_limit" in names,
                slo, mh, ch)
    out = both(scenario)
    assert out[0] and out[1] == (2, 1.0) and out[2] and out[3]
    assert out[5] == [("queries_total", 2)] and ("coordinator", "OK") in out[6]


def test_show_cluster_health_with_unreachable_and_piggyback_workers():
    def scenario(pkg):
        inst, s = _mk(pkg, "surf2")
        s.execute("SELECT b FROM t WHERE a = 1")
        _Ticker(inst)(2)
        rows = s.execute("SHOW CLUSTER HEALTH").rows
        local = [(r[1], r[2], r[3], r[4], r[11]) for r in rows]

        class _DeadClient:
            def sync_action(self, *a, **kw):
                raise ConnectionError("down")
        inst.workers[("127.0.0.1", 1)] = _DeadClient()
        dead = [tuple(r) for r in s.execute("SHOW CLUSTER HEALTH").rows
                if r[1] == "worker"]

        class _IdleClient:
            load_q, load_tier, load_up, load_samples = 3, 1, 42.0, 7
        inst.workers[("127.0.0.1", 1)] = _IdleClient()
        idle = [r for r in inst.cluster_health(pull=False) if r[1] == "worker"]
        return local, dead, idle
    local, dead, idle = both(scenario)
    assert local == [("coordinator", "local", "OK", 1, 2)]
    assert dead[0][3] == "UNREACHABLE" and idle[0][3] == "OK" and idle[0][11] == 7


def test_web_timeseries_and_events():
    def scenario(pkg):
        inst, s = _mk(pkg, "surf4")
        s.execute("SELECT b FROM t WHERE a = 1")
        _Ticker(inst)(3)
        web = pkg.WebConsole(inst)
        ts = web.resource("/timeseries/queries_total")
        pkg.EVENTS.clear()
        pkg.EVENTS.publish("slo_burn", detail="drill", severity="critical")
        pkg.EVENTS.publish("ddl", detail="drill")
        return ([v for _t, v in ts["points"]], ts["rate_per_s"],
                web.resource("/timeseries/no_such_metric"),
                [e["kind"] for e in web.resource("/events?kind=slo_burn")["events"]],
                [e["severity"] for e in
                 web.resource("/events?severity=critical")["events"]],
                [e["kind"] for e in web.resource("/events?like=slo%")["events"]])
    out = both(scenario)
    assert out[0] == [1.0, 1.0, 1.0] and out[2] is None and out[3] == ["slo_burn"]


def test_show_events_severity_and_like():
    def scenario(pkg):
        _inst, s = _mk(pkg, "surf5", rows=0)
        pkg.EVENTS.clear()
        pkg.EVENTS.publish("slo_burn", detail="d1", severity="critical")
        pkg.EVENTS.publish("slo_recovered", detail="d2")
        pkg.EVENTS.publish("breaker_open", detail="d3")
        out = [sorted({r[2] for r in s.execute(q).rows}) for q in (
            "SHOW EVENTS", "SHOW EVENTS CRITICAL", "SHOW EVENTS LIKE 'slo%'",
            "SHOW EVENTS INFO LIKE 'slo%'")]
        try:
            s.execute("SHOW EVENTS LOUD")
        except pkg.errors.NotSupportedError as e:
            out.append(str(e))
        return out
    out = both(scenario)
    assert out[1] == ["slo_burn"] and out[3] == ["slo_recovered"] and len(out) == 5


# -- the flight recorder --------------------------------------------------------------


def test_tail_retention_at_rate_zero():
    def scenario(pkg):
        inst, s = _mk(pkg, "tr2")
        store = inst.trace_store
        store.configure(rate=0.0)
        store.clear()
        s.execute("SELECT b FROM t WHERE a = 5")
        dropped = store.stats()["count"]
        inst.config.set_instance("SLOW_SQL_MS", 0)
        s.execute("SELECT b FROM t WHERE a = 6")
        slow = [(e.reason, "execute" in e.phases) for e in store.entries()]
        inst.config.set_instance("SLOW_SQL_MS", 10 ** 9)
        try:
            s.execute("SELECT nope FROM t")
        except pkg.errors.TddlError:
            pass
        err = [(e.reason, "UnknownColumnError" in e.error, "admission" in e.phases)
               for e in store.entries() if e.reason == "error"]
        inst.config.set_instance("ADMISSION_AP_LIMIT", 1)
        inst.config.set_instance("ADMISSION_QUEUE_SIZE", 0)
        inst.admission._limit.clear()
        inst.admission._tokens["AP"].append(None)
        try:
            s.execute("SELECT b, count(*) FROM t GROUP BY b")
        except pkg.errors.ServerOverloadError:
            pass
        finally:
            inst.admission._tokens["AP"].pop()
        shed = [(e.reason, "admission" in e.phases) for e in store.entries()
                if e.reason == "shed"]
        return dropped, slow, err, shed
    assert both(scenario) == (0, [("slow", True)], [("error", True, True)],
                              [("shed", True)])


def test_full_phase_breakdown_and_budget():
    def scenario(pkg):
        inst, s = _mk(pkg, "tr3")
        store = inst.trace_store
        # warm (the reference's first run compiles), and no slow retention
        s.execute("SELECT b, count(*) FROM t GROUP BY b")
        inst.config.set_instance("SLOW_SQL_MS", 10 ** 9)
        store.configure(rate=1.0)
        store.clear()
        s.execute("SELECT b, count(*) FROM t GROUP BY b")
        ent = store.entries()[-1]
        # the compile phase is a COMPILE_STATS delta: left out
        phases = sorted(k for k in ent.phases if k not in ("fence_wait", "compile"))
        root = ent.spans[0]["attrs"].get("phases") == ent.phases
        store.configure(rate=1.0, budget_bytes=4096)
        store.clear()
        for i in range(40):
            s.execute(f"SELECT b FROM t WHERE a = {i}")
        st = store.stats()
        ids = [e.trace_id for e in store.entries()]
        inst.config.set_instance("ENABLE_QUERY_TRACING", False)
        store.clear()
        inst.config.set_instance("SLOW_SQL_MS", 0)
        s.execute("SELECT b FROM t WHERE a = 8")
        return (ent.reason, phases, root, st["bytes"] <= 4096, st["evicted"] > 0,
                ids == sorted(ids, reverse=True), store.stats()["count"])
    out = both(scenario)
    assert out[0] == "sampled" and {"admission", "queue", "plan", "execute",
                                    "serialize"} <= set(out[1])
    assert out[2:] == (True, True, True, True, 0)


def test_injected_burn_yields_one_complete_bundle():
    def scenario(pkg):
        inst, s = _mk(pkg, "burnb")
        inst.config.set_instance("SLO_FAST_WINDOW_SAMPLES", 2)
        inst.config.set_instance("SLO_SLOW_WINDOW_SAMPLES", 4)
        T = _Ticker(inst)
        _run(s, 10)
        T(4)
        before = inst.recorder.bundles()
        pkg.FAIL_POINTS.arm(pkg.fp.FP_SLO_LATENCY_MS, {"ms": 10000, "workload": "TP"})
        _run(s, 20)
        T(3)
        bundles = [b for b in inst.recorder.bundles() if b.kind == "slo_burn"]
        b = bundles[0]
        tr = b.traces[0]
        shape = (b.severity, b.episode, len(b.digests), tr["digest"] == b.digests[0],
                 tr["reason"], "execute" in tr["phases"], bool(tr["spans"]),
                 bool(b.metric_window), bool(b.admission),
                 sorted(k for k in ("mem_tier", "burning") if k in b.state),
                 b.state["burning"], any(e["kind"] == "slo_burn" for e in b.events),
                 any(str(r[0]) == b.digests[0] for r in b.summary_rows))
        _run(s, 10)
        T(2)
        again = len([x for x in inst.recorder.bundles() if x.kind == "slo_burn"])
        row = next(r for r in s.execute("SHOW INCIDENTS").rows if r[0] == b.incident_id)
        seq = b.incident_id.split("-")[1]
        fields = {r[0]: r[1] for r in s.execute(f"SHOW INCIDENTS {seq}").rows}
        try:
            s.execute("SHOW INCIDENTS 9999")
            unknown = None
        except pkg.errors.TddlError as e:
            unknown = type(e).__name__
        info = [tuple(r) for r in s.execute(
            "SELECT kind, digests FROM information_schema.incidents").rows]
        w = pkg.WebConsole(inst)
        idx = w.resource("/incidents")
        detail = w.resource(f"/incidents/{b.incident_id}")
        ct = w.resource(f"/trace/{tr['trace_id']}")
        pkg.FAIL_POINTS.clear()
        return (before, len(bundles), shape, again, row[2], b.digests[0] in row[6],
                fields["kind"], fields["digests"] == ",".join(b.digests),
                any(k.startswith("metric:") for k in fields),
                any(k.startswith("trace:") for k in fields), unknown,
                ("slo_burn", ",".join(b.digests)) in info, idx["captured"],
                detail["kind"], bool(detail["traces"]), bool(ct["traceEvents"]))
    out = both(scenario)
    assert out[0] == [] and out[1] == 1 and out[3] == 1
    assert out[2][:2] == ("critical", "slo_burn:tp_latency_p99")
    assert out[4:] == ("slo_burn", True, "slo_burn", True, True, True, "TddlError",
                       True, 1, "slo_burn", True, True)


def test_reject_storm_captures_one_bundle():
    def scenario(pkg):
        inst, s = _mk(pkg, "storm")
        T = _Ticker(inst)
        T(1)
        inst.config.set_instance("INCIDENT_REJECT_STORM", 5)
        inst.config.set_instance("ADMISSION_AP_LIMIT", 1)
        inst.config.set_instance("ADMISSION_QUEUE_SIZE", 0)
        inst.admission._limit.clear()
        inst.admission._tokens["AP"].append(None)
        out = []
        try:
            for n in (2, 6):
                for _ in range(n):
                    try:
                        s.execute("SELECT b, count(*) FROM t GROUP BY b")
                    except pkg.errors.ServerOverloadError:
                        pass
                T(1)
                out.append([(b.kind, "storm" in b.detail,
                             any(t["reason"] == "shed" for t in b.traces))
                            for b in inst.recorder.bundles()
                            if b.kind == "admission_reject"])
        finally:
            inst.admission._tokens["AP"].pop()
        return out
    assert both(scenario) == [[], [("admission_reject", True, True)]]


def test_cooldown_dedupes_per_episode():
    def scenario(pkg):
        inst, _s = _mk(pkg, "cool", rows=0)
        T = _Ticker(inst)
        rec = inst.recorder
        out = []
        pkg.EVENTS.publish("plan_regression", "digest d1 regressed", severity="warn",
                           digest="d1")
        T(1)
        out.append(len(rec.bundles()))
        pkg.EVENTS.publish("plan_regression", "digest d1 regressed again",
                           severity="warn", digest="d1")
        T(1)
        out += [len(rec.bundles()), rec.suppressed >= 1]
        pkg.EVENTS.publish("plan_regression", "digest d2 regressed", severity="warn",
                           digest="d2")
        T(1)
        out.append(sorted({b.episode for b in rec.bundles()}))
        inst.config.set_instance("INCIDENT_COOLDOWN_S", 1.0)
        pkg.EVENTS.publish("plan_regression", "digest d1 regressed later",
                           severity="warn", digest="d1")
        T(1)
        out.append(len([b for b in rec.bundles()
                        if b.episode == "plan_regression:d1"]))
        return out
    assert both(scenario) == [1, 1, True, ["plan_regression:d1",
                                           "plan_regression:d2"], 2]


def test_bundles_persist_and_reload_and_hatch(tmp_path):
    def scenario(pkg):
        d = str(tmp_path / f"n1-{pkg.name}")
        inst, _s = _mk(pkg, "disk", rows=0, data_dir=d)
        T = _Ticker(inst)
        pkg.EVENTS.publish("plan_regression", "digest px regressed", severity="warn",
                           digest="px")
        T(1)
        b = inst.recorder.bundles()[0]
        path = os.path.join(d, "incidents", f"{b.incident_id}.json")
        with open(path) as f:
            raw = json.load(f)
        inst.recorder.clear()
        got = inst.recorder.get(b.incident_id.split("-")[1])
        inst.config.set_instance("ENABLE_FLIGHT_RECORDER", False)
        pkg.EVENTS.publish("plan_regression", "digest hx regressed", severity="warn",
                           digest="hx")
        T(1)
        return raw["episode"], got.episode, inst.recorder.bundles()
    assert both(scenario) == ("plan_regression:px", "plan_regression:px", [])


# -- the scheduler --------------------------------------------------------------------


def test_scheduler_fires_at_most_once_per_interval():
    def scenario(pkg):
        inst, s = _mk(pkg, "sch", rows=50)
        sch = inst.scheduler
        sch.register("an", "analyze", "sch", "t", {}, interval_s=60.0)
        sch.register("pg", "purge_tx_log", "sch", "", {"keep_seconds": 0},
                     interval_s=60.0)
        now = 1_700_000_000.0
        fired = [sorted(sch.run_due(now=now)), sorted(sch.run_due(now=now + 30)),
                 sorted(sch.run_due(now=now + 61))]
        hist = [(n, st) for n, _at, st, _d in sch.history()]
        jobs = [(n, k, sc, t, i, e) for n, k, sc, t, i, e, _lf in sch.jobs()]
        try:
            sch.register("bad", "no_such_kind", "sch", "t", {}, 1.0)
            unknown = None
        except pkg.errors.TddlError as e:
            unknown = str(e)
        return fired, jobs, unknown, hist
    fired, jobs, unknown, hist = both(scenario)
    assert fired == [["an", "pg"], [], ["an", "pg"]] and "unknown job kind" in unknown
    assert ("an", "SUCCESS") in hist and ("pg", "SUCCESS") in hist


def test_scheduler_rebalance_job_is_a_typed_failed_fire():
    """The `rebalance` job, which the port once recorded as a FAILED fire while it
    waited for the placement slice, now runs the balancer as the reference does:
    the maintain loop records the same status and detail in both packages (a
    10-row table is below REBALANCE_MIN_ROWS: no proposal)."""
    def scenario(pkg):
        inst, _s = _mk(pkg, "schp", rows=10)
        inst.scheduler.register("rb", "rebalance", "schp", "t", {}, interval_s=1.0)
        fired = inst.scheduler.run_due(now=1_700_000_000.0)
        (_n, _at, status, detail), = inst.scheduler.history("rb")
        return fired, status, detail
    assert both(scenario) == (["rb"], "SUCCESS", "balanced (no proposals)")


def test_maintain_loop_drives_slo_tick():
    def scenario(pkg):
        inst, s = _mk(pkg, "loop", rows=10)
        inst.config.set_instance("METRIC_HISTORY_INTERVAL_S", 0.01)
        inst.scheduler.start(poll_interval_s=0.02)
        try:
            deadline = time.time() + 20
            while inst.metric_history.samples_count < 2 and time.time() < deadline:
                time.sleep(0.02)
        finally:
            inst.scheduler.stop()
        return inst.metric_history.samples_count >= 2
    assert both(scenario)


# -- cluster health over real workers -------------------------------------------------


@pytest.mark.parametrize("worker_pkg", ["torch", "jax"])
def test_cluster_health_over_a_worker(worker_pkg):
    """A port coordinator and a JAX coordinator pull `health` from the same kind of
    worker (a port worker, then a JAX worker): the worker's row reads OK with the
    reference's fields, the piggybacked load renders without a pull, and a killed
    worker turns UNREACHABLE."""
    w = WorkerProc(worker_pkg, "CREATE DATABASE w; USE w; CREATE TABLE kv "
                               "(k BIGINT PRIMARY KEY, v BIGINT); "
                               "INSERT INTO kv VALUES (1, 10), (2, 20)")
    try:
        def scenario(pkg):
            inst, s = _mk(pkg, "w", rows=0)
            inst.attach_remote_table("w", "kv", *w.addr)
            rows = s.execute("SELECT v FROM kv WHERE k = 2").rows
            pulled = [r for r in s.execute("SHOW CLUSTER HEALTH").rows
                      if r[1] == "worker"]
            piggy = [r for r in inst.cluster_health(pull=False) if r[1] == "worker"]
            client = inst.workers[w.addr]
            return (rows, [(r[2], r[3], r[4], r[9], r[10], r[11] >= 1) for r in pulled],
                    [(r[3], r[9]) for r in piggy], client.load_at > 0)
        out = both(scenario)
        assert out[1] == [(f"{w.addr[0]}:{w.addr[1]}", "OK", 0, 0, "", True)]
        w.close()
        def dead(pkg):
            inst, s = _mk(pkg, "w2", rows=0)
            inst.worker_client(*w.addr)
            return [(r[1], r[3]) for r in s.execute("SHOW CLUSTER HEALTH").rows]
        assert both(dead) == [("coordinator", "OK"), ("worker", "UNREACHABLE")]
    finally:
        w.close()


def test_slow_drain_piggyback_from_a_port_worker():
    """A browned-out port worker (slow drain) piggybacks its load in every reply;
    the coordinator records it and its breaker stays closed."""
    w = WorkerProc("torch", "CREATE DATABASE w; USE w; CREATE TABLE kv "
                            "(k BIGINT PRIMARY KEY, v BIGINT); "
                            "INSERT INTO kv VALUES (1, 10), (2, 20), (3, 30)")
    try:
        def scenario(pkg):
            inst, s = _mk(pkg, "w", rows=0)
            inst.attach_remote_table("w", "kv", *w.addr)
            client = inst.workers[w.addr]
            client.sync_action("failpoint", {"key": pkg.fp.FP_WORKER_SLOW_DRAIN,
                                             "value": {"ms": 40}})
            t0 = time.perf_counter()
            rows = s.execute("SELECT v FROM kv WHERE k = 2").rows
            slow = time.perf_counter() - t0 >= 0.04
            client.sync_action("failpoint", {"clear": True})
            return rows, slow, client.load_at > 0, client.breaker_state()
        assert both(scenario) == ([(20,)], True, True, "closed")
    finally:
        w.close()
