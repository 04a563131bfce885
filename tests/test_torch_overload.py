"""Admission control, memory-pressure governance and the CCL queue in the port
against the JAX package (`tests/test_overload.py`).

Every test runs one script through a JAX `Instance` and a port
`Instance(device="cpu")` and asserts equal outcomes (`torch_plane_harness.both`):
classification, AIMD limits fed with synthetic latencies through the controller's
own `_aimd`, deadline and queue sheds, the typed refusals with `retry_after_ms`,
the memory tiers through `FP_MEM_PRESSURE`, the governed spill scale with equal
spill counters, revoke-largest, CCL rules, SHOW ADMISSION and
`information_schema.admission_stats`.  Measured latencies are never compared: the
admission rows' `*_latency_ewma_ms` and `memory_usage_frac` (the process-wide
pool's live bytes) are left out."""

import threading
import time

import numpy as np
import pytest

from torch_plane_harness import both, mk, threads

pytestmark = pytest.mark.torch_port

AP_Q = "SELECT b, sum(c) FROM t GROUP BY b"


def _adm_rows(s):
    """SHOW ADMISSION without the measured rows."""
    return [(n, v) for n, v in s.execute("SHOW ADMISSION").rows
            if not n.endswith("latency_ewma_ms") and n != "memory_usage_frac"]


def _shed(pkg, fn):
    """(error class, errno, retry_after_ms > 0) of a typed refusal."""
    try:
        fn()
    except (pkg.errors.ServerOverloadError, pkg.errors.CclRejectError) as e:
        return type(e).__name__, e.errno, getattr(e, "retry_after_ms", 1) > 0
    return None


# -- classification -------------------------------------------------------------------


def test_heuristic_and_digest_truth():
    def scenario(pkg):
        inst, s = mk(pkg, "ov", rows=100)
        ctl = inst.admission
        out = [ctl.classify(s, "SELECT b FROM t WHERE a = 5")[0],
               ctl.classify(s, AP_Q)[0]]
        s.execute("SELECT count(*) FROM t")
        cls, ms, dig = ctl.classify(s, "SELECT count(*) FROM t")
        out += [cls, ms is not None and ms > 0, dig, dig in ctl._digest_cost]
        out.append(ctl.classify(s, "SELECT * FROM information_schema.metrics")[0])
        return out
    out = both(scenario)
    assert out[:2] == ["TP", "AP"] and out[5] and out[6] == "TP"


# -- limits, queueing, shedding -------------------------------------------------------


def test_queue_full_sheds_typed_with_event():
    def scenario(pkg):
        inst, s = mk(pkg, "ovq", rows=200)
        inst.config.set_instance("ADMISSION_AP_LIMIT", 1)
        inst.config.set_instance("ADMISSION_QUEUE_SIZE", 0)
        inst.admission._limit.clear()
        inst.admission._tokens["AP"].append(None)  # hold the only AP slot
        try:
            shed = _shed(pkg, lambda: s.execute(AP_Q))
        finally:
            inst.admission._tokens["AP"].pop()
        kinds = sorted({e.kind for e in pkg.EVENTS.entries()})
        return (shed, inst.metrics.counter("admission_shed_total").value, kinds,
                inst.admission.shed_queue_full, sorted(s.execute(AP_Q).rows))
    shed, n, kinds, full, _rows = both(scenario)
    assert shed == ("ServerOverloadError", 9003, True) and n >= 1 and full == 1
    assert "admission_reject" in kinds


def test_wait_timeout_sheds_typed():
    def scenario(pkg):
        inst, s = mk(pkg, "ovt", rows=200)
        inst.config.set_instance("ADMISSION_AP_LIMIT", 1)
        inst.config.set_instance("ADMISSION_QUEUE_SIZE", 4)
        inst.config.set_instance("ADMISSION_WAIT_MS", 50)
        inst.admission._limit.clear()
        inst.admission._tokens["AP"].append(None)
        try:
            t0 = time.perf_counter()
            shed = _shed(pkg, lambda: s.execute(AP_Q))
            bounded = time.perf_counter() - t0 < 5.0
        finally:
            inst.admission._tokens["AP"].pop()
        return shed, bounded, inst.admission.shed_timeout
    assert both(scenario) == (("ServerOverloadError", 9003, True), True, 1)


def test_waiter_admitted_when_slot_frees():
    def scenario(pkg):
        inst, s = mk(pkg, "ovw", rows=200)
        inst.config.set_instance("ADMISSION_AP_LIMIT", 1)
        inst.config.set_instance("ADMISSION_WAIT_MS", 5000)
        inst.admission._limit.clear()
        inst.admission._tokens["AP"].append(None)
        got = []

        def waiter():
            s2 = pkg.Session(inst, schema="ovw")
            got.append(sorted(s2.execute(AP_Q).rows))
            s2.close()
        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        deadline = time.time() + 10
        while inst.admission._nwait["AP"] == 0 and time.time() < deadline:
            time.sleep(0.005)  # poll: the waiter has queued
        queued = inst.admission._nwait["AP"]
        inst.admission._tokens["AP"].pop()
        with inst.admission._cond:
            inst.admission._cond.notify_all()
        t.join(20.0)
        return queued, t.is_alive(), got, inst.admission.admitted["AP"]
    queued, alive, got, admitted = both(scenario)
    assert queued == 1 and not alive and got and got[0]


def test_aimd_decrease_and_increase():
    """Synthetic latencies through the controller's own `_aimd`: a blown AP target
    shrinks the limit multiplicatively, healthy binding traffic grows it
    additively."""
    def scenario(pkg):
        inst, _s = mk(pkg, "ova")
        ctl = inst.admission
        lim0 = ctl.limit("AP")
        for _ in range(ctl.AIMD_SAMPLE):
            ctl._aimd("AP", 60_000.0)
        shrunk = ctl.limit("AP")
        ctl._ewma["AP"] = 1.0
        for _ in range(int(shrunk)):
            ctl._tokens["AP"].append(None)
        try:
            for _ in range(ctl.AIMD_SAMPLE):
                ctl._aimd("AP", 1.0)
        finally:
            ctl._tokens["AP"].clear()
        return lim0, shrunk, ctl.limit("AP"), ctl.effective_limit("AP")
    lim0, shrunk, grown, _eff = both(scenario)
    assert shrunk < lim0 and grown > shrunk


def test_predicted_service_time_vs_deadline():
    def scenario(pkg):
        inst, s = mk(pkg, "ovd", rows=100)
        ctl = inst.admission
        s.execute(AP_Q)
        ctl._digest_cost[s._digest_of(AP_Q)] = ("AP", 60_000.0)  # predicted 60 s
        s.execute("SET MAX_EXECUTION_TIME = 200")
        return _shed(pkg, lambda: s.execute(AP_Q)), ctl.shed_deadline
    assert both(scenario) == (("ServerOverloadError", 9003, True), 1)


# -- memory-pressure governance -------------------------------------------------------


def test_tiers_and_frag_budget():
    def scenario(pkg):
        inst, _s = mk(pkg, "ovm")
        gov = inst.admission.governor
        base = inst.frag_cache.budget
        out = [(gov.tier(), gov.spill_scale())]
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "elevated")
        out.append((gov.tier(), gov.spill_scale(), inst.frag_cache.budget == base // 2))
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "critical")
        out.append((gov.tier(), gov.spill_scale()))
        pkg.FAIL_POINTS.disarm(pkg.fp.FP_MEM_PRESSURE)
        out.append((gov.tier(), inst.frag_cache.budget == base))
        out.append(sorted((e.kind, e.severity) for e in pkg.EVENTS.entries()))
        return out
    out = both(scenario)
    assert out[1] == (1, 0.25, True) and out[3] == (0, True)
    assert ("mem_pressure", "warn") in out[4] or any(k == "mem_pressure"
                                                     for k, _s in out[4])


def test_critical_refuses_ap_keeps_tp():
    def scenario(pkg):
        inst, s = mk(pkg, "ovc", rows=200)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "critical")
        shed = _shed(pkg, lambda: s.execute(AP_Q))
        tp = s.execute("SELECT b FROM t WHERE a = 5").rows
        return shed, tp, inst.admission.shed_memory
    assert both(scenario) == (("ServerOverloadError", 9003, True), [(5,)], 1)


def test_critical_revokes_largest_query():
    def scenario(pkg):
        inst, _s = mk(pkg, "ovr")
        mem = pkg.memory
        pool = mem.query_pool(999_001, limit=1 << 20)
        charge = mem.PoolCharge(pool)
        try:
            reserved = charge.to(512 << 10)
            revoked = inst.admission.governor.revoke_largest_query()
            squeezed = charge.squeeze
        finally:
            charge.close()
            pool.close()
        return reserved, revoked, squeezed, pool in mem.GLOBAL_POOL.children
    assert both(scenario) == (True, 512 << 10, True, False)


def _capture_ops(monkeypatch, pkg):
    """The root operator of each query the session builds, in order."""
    import importlib
    mod = importlib.import_module(
        ("galaxysql_tpu" if pkg.name == "jax" else "galaxysql_tpu_torch")
        + ".server.session")
    roots = []
    orig = mod.build_operator

    def capture(rel, ctx):
        op = orig(rel, ctx)
        roots.append(op)
        return op
    monkeypatch.setattr(mod, "build_operator", capture)
    return roots


def _spill_counters(pkg, op, out=None):
    """(kind, counter) of every spilling operator of a tree, in pre-order."""
    out = [] if out is None else out
    name = type(op).__name__
    if name == "HashJoinOp":
        out.append(("join", op.grace_partitions))
    elif name == "SortOp":
        out.append(("sort", op.spilled_runs))
    elif name in ("HashAggOp", "DistinctOp"):
        out.append(("agg", op.spilled_partials))
    for attr in ("inner", "child", "build", "probe", "left", "right"):
        c = getattr(op, attr, None)
        if c is not None and hasattr(c, "batches") and c is not op:
            _spill_counters(pkg, c, out)
    for c in getattr(op, "children_ops", ()):
        _spill_counters(pkg, c, out)
    return out


def test_elevated_tier_scales_spill_thresholds(monkeypatch):
    """JOIN_SPILL_BYTES at which the join does not spill unscaled: under
    ELEVATED (scale 0.25) the same query grace-joins with the same rows and the
    same grace partition count in both packages; a hinted ADMISSION(OFF) run is
    not governed and does not spill."""
    def scenario(pkg):
        inst, s = mk(pkg, "ovg", rows=60_000)
        s.execute("CREATE TABLE d (id BIGINT PRIMARY KEY, w BIGINT, x BIGINT)")
        n = 20_000
        inst.store("ovg", "d").insert_arrays(
            {"id": np.arange(n), "w": np.arange(n) % 13, "x": np.arange(n) * 7},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE d")
        s.execute("SET JOIN_SPILL_BYTES = 1048576")
        q = ("/*+TDDL: FRAGMENT_CACHE(OFF)*/ SELECT d.w, count(*), sum(t.c + d.x) "
             "FROM t, d WHERE t.a = d.id GROUP BY d.w ORDER BY d.w")
        roots = _capture_ops(monkeypatch, pkg)
        out = []
        for tier in (None, "elevated"):
            if tier:
                pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, tier)
            rows = s.execute(q).rows
            out.append((rows, _spill_counters(pkg, roots[-1])))
        pkg.FAIL_POINTS.clear()
        monkeypatch.undo()
        return out
    (rows0, c0), (rows1, c1) = both(scenario)
    assert rows0 == rows1
    assert all(v == 0 for _k, v in c0) and any(k == "join" and v > 0 for k, v in c1)


def test_pool_exhaustion_spills_not_oom():
    """A tiny per-query pool forces the sort to spill with the same answer, and
    the summary attributes the spill bytes to the digest."""
    def scenario(pkg):
        _inst, s = mk(pkg, "ovs", rows=20_000)
        q = "SELECT a, c FROM t ORDER BY c DESC LIMIT 7"
        expect = s.execute(q).rows
        spilled0 = s.execute("SELECT count(*) FROM information_schema.statement_summary "
                             "WHERE spill_bytes > 0").rows
        s.execute("SET QUERY_MEM_BYTES = 4096")
        got = s.execute(q).rows
        spilled1 = s.execute("SELECT count(*) FROM information_schema.statement_summary "
                             "WHERE spill_bytes > 0").rows
        return expect, got == expect, spilled0, spilled1
    _e, same, n0, n1 = both(scenario)
    assert same and n0 == [(0,)] and n1 == [(1,)]


# -- hatches --------------------------------------------------------------------------


def test_param_env_and_hint_off(monkeypatch):
    def scenario(pkg):
        inst, s = mk(pkg, "ovh", rows=50)
        s.execute("SET ENABLE_ADMISSION_CONTROL = 0")
        off_param = inst.admission.admit(s, "SELECT sum(a) FROM t GROUP BY a").ctl
        s.execute("SET ENABLE_ADMISSION_CONTROL = 1")
        monkeypatch.setattr(pkg.adm, "ENABLED", False)
        off_env = inst.admission.admit(s, "SELECT sum(a) FROM t GROUP BY a").ctl
        monkeypatch.setattr(pkg.adm, "ENABLED", True)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "critical")
        hinted = s.execute("/*+TDDL: ADMISSION(OFF)*/ " + AP_Q).rows
        return off_param is None, off_env is None, sorted(hinted)
    off_param, off_env, rows = both(scenario)
    assert off_param and off_env and rows


def test_results_and_dispatches_identical_on_vs_off(monkeypatch):
    """Admission adds no device work: the same rows and the same dispatches with
    the gate on and off, and the port's count equals the reference's."""
    def scenario(pkg):
        _inst, s = mk(pkg, "ovh5", rows=2000)
        q = "SELECT b, sum(c) FROM t GROUP BY b ORDER BY b LIMIT 13"
        s.execute(q)

        def count(n=3):
            d0 = pkg.ops.DISPATCH_STATS["dispatches"]
            rows = [s.execute(q).rows for _ in range(n)]
            return pkg.ops.DISPATCH_STATS["dispatches"] - d0, rows
        on = count()
        monkeypatch.setattr(pkg.adm, "ENABLED", False)
        off = count()
        monkeypatch.setattr(pkg.adm, "ENABLED", True)
        return on, off
    on, off = both(scenario)
    assert on == off


# -- SQL surfaces ---------------------------------------------------------------------


def test_ccl_rule_ddl_round_trip():
    def scenario(pkg):
        _inst, s = mk(pkg, "ovsql", rows=10)
        out = []
        s.execute("CREATE CCL_RULE throttle_t WITH MAX_CONCURRENCY = 2, "
                  "KEYWORD = 'slowq', WAIT_QUEUE_SIZE = 3, WAIT_TIMEOUT = 500")
        out.append(s.execute("SHOW CCL_RULES").rows)
        out.append(s.execute("SELECT rule_name, max_concurrency FROM "
                             "information_schema.ccl_rules").rows)
        s.execute("CREATE CCL_RULE IF NOT EXISTS throttle_t WITH MAX_CONCURRENCY = 9")
        out.append(pkg.ccl.GLOBAL_CCL.rules()[0].rule.max_concurrency)
        s.execute("SELECT b FROM t WHERE a = 1 /* slowq */")
        out.append(s.execute("SHOW CCL_RULES").rows)
        s.execute("DROP CCL_RULE throttle_t")
        out.append(s.execute("SHOW CCL_RULES").rows)
        try:
            s.execute("DROP CCL_RULE throttle_t")
        except pkg.errors.TddlError as e:
            out.append(str(e))
        s.execute("DROP CCL_RULE IF EXISTS throttle_t")
        return out
    out = both(scenario)
    assert out[0] == [("throttle_t", 2, "slowq", "", 0, 0, 0, 0)] and out[2] == 2
    assert out[4] == [] and "unknown CCL rule" in out[5]


def test_ccl_reject_publishes_event():
    def scenario(pkg):
        _inst, s = mk(pkg, "ovev", rows=10)
        s.execute("CREATE CCL_RULE block WITH MAX_CONCURRENCY = 1, KEYWORD = 't', "
                  "WAIT_QUEUE_SIZE = 0")
        st = pkg.ccl.GLOBAL_CCL.rules()[0]
        st.sem.acquire()
        try:
            shed = _shed(pkg, lambda: s.execute("SELECT b FROM t WHERE a = 1"))
        finally:
            st.sem.release()
        return shed, sorted({e.kind for e in pkg.EVENTS.entries()}), \
            s.execute("SHOW CCL_RULES").rows
    shed, kinds, _rows = both(scenario)
    assert shed[0] == "CclRejectError" and "ccl_reject" in kinds


def test_show_admission_and_info_schema():
    def scenario(pkg):
        inst, s = mk(pkg, "ovsh", rows=50)
        s.execute("SELECT b FROM t WHERE a = 1")
        rows = _adm_rows(s)
        info = s.execute("SELECT stat_name, value FROM information_schema."
                         "admission_stats WHERE stat_name = 'tp_admitted'").rows
        names = {n for n, *_ in s.execute("SHOW METRICS").rows}
        return rows, info, {"memory_pressure_tier", "admission_queue_depth_tp",
                            "admission_queue_depth_ap",
                            "retry_budget_remaining"} <= names
    rows, info, gauges = both(scenario)
    d = dict(rows)
    assert d["enabled"] == 1.0 and d["memory_pressure_tier"] == 0.0
    assert info and info[0][1] >= 1 and gauges


def test_spill_metrics_in_registry():
    def scenario(pkg):
        inst, s = mk(pkg, "ovsp", rows=30_000)
        s.execute("SET SORT_SPILL_BYTES = 65536")
        rows = s.execute("SELECT a, c FROM t ORDER BY c LIMIT 5").rows
        vals = {n: v for n, _k, v, _h in inst.metrics.rows()}
        return (rows, vals.get("spill_bytes_total", 0) > 0,
                vals.get("spill_files_total", 0) > 0,
                "spill_bytes_total" in inst.metrics.prometheus_text())
    assert both(scenario)[1:] == (True, True, True)


def test_routing_deprioritizes_pressured_endpoint():
    """read_endpoint weights down an endpoint that reported a deep queue and an
    elevated memory tier, without excluding it."""
    import random
    import types

    def scenario(pkg):
        import importlib
        dn = importlib.import_module(("galaxysql_tpu" if pkg.name == "jax"
                                      else "galaxysql_tpu_torch") + ".net.dn")
        inst = pkg.Instance()
        calm = dn.WorkerClient("127.0.0.1", 7001)
        busy = dn.WorkerClient("127.0.0.1", 7002)
        busy.load_q, busy.load_tier, busy.load_at = 8, 1, time.time()
        inst.workers[("127.0.0.1", 7001)] = calm
        inst.workers[("127.0.0.1", 7002)] = busy
        tm = types.SimpleNamespace(
            name="kv", remote={"host": "127.0.0.1", "port": 7001},
            replicas=[{"host": "127.0.0.1", "port": 7002, "weight": 1}])
        random.seed(11)
        picks = [inst.read_endpoint(tm)[0][1] for _ in range(400)]
        return picks.count(7001), picks.count(7002)
    calm, busy = both(scenario)
    assert busy > 0 and calm > 3 * busy


# -- the end-to-end flood -------------------------------------------------------------


def test_tp_survives_ap_flood_with_pressure():
    """AP flood under ELEVATED pressure with a tight AP limit: every outcome is the
    idle run's rows or a typed shed, TP keeps full goodput, and SHOW ADMISSION's
    counts equal the clients' counts.  Equal in both packages: the outcome
    classes and the count identities (how many shed depends on timing)."""
    def scenario(pkg):
        inst, s = mk(pkg, "ovf", rows=60_000)
        inst.config.set_instance("ADMISSION_AP_LIMIT", 2)
        inst.config.set_instance("ADMISSION_QUEUE_SIZE", 1)
        inst.config.set_instance("ADMISSION_WAIT_MS", 100)
        inst.admission._limit.clear()
        ap_q = ("SELECT b, sum(c), count(*) FROM t "
                "GROUP BY b ORDER BY 2 DESC LIMIT 5")
        tp_q = "SELECT b FROM t WHERE a = %d"
        idle_ap = s.execute(ap_q).rows
        idle_tp = {k: s.execute(tp_q % k).rows for k in (3, 77, 991)}
        adm0 = dict(s.execute("SHOW ADMISSION").rows)
        pkg.FAIL_POINTS.arm(pkg.fp.FP_MEM_PRESSURE, "elevated")
        stop = threading.Event()
        lock = threading.Lock()
        tally = {"ap_ok": 0, "ap_shed": 0, "tp_ok": 0, "bad": []}

        def ap_flood(_i):
            sx = pkg.Session(inst, schema="ovf")
            while not stop.is_set():
                try:
                    rows = sx.execute(ap_q).rows
                    with lock:
                        tally["ap_ok"] += 1
                        if rows != idle_ap:
                            tally["bad"].append("AP drift")
                except (pkg.errors.ServerOverloadError, pkg.errors.CclRejectError):
                    with lock:
                        tally["ap_shed"] += 1
                    time.sleep(0.002)
            sx.close()

        def tp_loop(_i):
            sx = pkg.Session(inst, schema="ovf")
            for j in range(30):
                k = (3, 77, 991)[j % 3]
                rows = sx.execute(tp_q % k).rows
                with lock:
                    tally["tp_ok"] += 1
                    if rows != idle_tp[k]:
                        tally["bad"].append("TP drift")
            sx.close()
        floods = [threading.Thread(target=ap_flood, args=(i,), daemon=True)
                  for i in range(6)]
        for t in floods:
            t.start()
        time.sleep(0.2)
        errs = threads(4, tp_loop)
        stop.set()
        for t in floods:
            t.join(60)
        pkg.FAIL_POINTS.clear()
        adm = dict(s.execute("SHOW ADMISSION").rows)
        shed = sum(adm[k] - adm0[k] for k in ("shed_queue_full", "shed_timeout",
                                              "shed_deadline", "shed_memory"))
        return (errs, tally["bad"], tally["tp_ok"], tally["ap_ok"] > 0,
                tally["ap_shed"] > 0,
                adm["ap_admitted"] - adm0["ap_admitted"] == tally["ap_ok"],
                shed == tally["ap_shed"],
                adm["tp_admitted"] - adm0["tp_admitted"] >= tally["tp_ok"])
    out = both(scenario)
    assert out == ([], [], 120, True, True, True, True, True)
