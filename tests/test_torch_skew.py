"""Skew-aware MPP execution in the port (`parallel/mpp.py` with the copied
`exec/skew.py`): the reference's `tests/test_skew.py` cases at its sizes (N = 57,344
fact rows, K = 800 keys), on a mesh of 8 shards on the CPU with every join forced to
the shuffle shape, as the reference's run on its 8 virtual devices.

Each hybrid join and salted aggregation must give rows bit-identical to the same SQL
under `/*+TDDL: SKEW(OFF)*/`, and engage exactly where the reference's test expects.
Held to the JAX package: the rows of the hot-key join and GROUP BY (its local
engine), the events activation and stats drift publish (`utils/events.py`, kind,
detail, dedupe key and fields), and EXPLAIN ANALYZE of a hybrid join under a salted
aggregate, node for node with its `HotKeys(...)` and `Salted(...)` lines (its MPP on
the 8 virtual devices).  The reference's dispatch-count and retrace guards count XLA
programs and have no counterpart; SHOW PROFILES waits for ROADMAP Queue 1 item 16.
"""

import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.exec import skew as jax_skew
from galaxysql_tpu.plan import logical as JaxL
from galaxysql_tpu.plan import physical as jax_physical
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.utils import events as jax_events
from galaxysql_tpu_torch.exec import fragment_cache as fc
from galaxysql_tpu_torch.exec import skew as sk
from galaxysql_tpu_torch.meta.statistics import HeavyHitterSketch
from galaxysql_tpu_torch.parallel import mpp as M
from galaxysql_tpu_torch.parallel.mesh import make_mesh
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.physical import ExecContext
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.utils import events

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

N = 57344           # rows per fact table (>= exec/skew.MIN_SKEW_ROWS)
K = 800             # key domain
MID = 16384         # mid-size dim: big enough that the build does NOT flip


def zipf_keys(rng, theta: float, n: int = N, k: int = K) -> np.ndarray:
    if theta <= 0:
        return rng.integers(0, k, size=n)
    p = np.arange(1, k + 1, dtype=np.float64) ** -theta
    p /= p.sum()
    return rng.choice(k, size=n, p=p)


def _tables():
    """The reference's tables, from its seed: (name, DDL, arrays) in load order."""
    rng = np.random.default_rng(13)
    fact = ("CREATE TABLE {} (id BIGINT PRIMARY KEY, k BIGINT, v BIGINT) "
            "PARTITION BY HASH(id) PARTITIONS 8")
    out = []
    for name, theta in (("fact_t0", 0.0), ("fact_t08", 0.8), ("fact_t12", 1.2)):
        keys = zipf_keys(rng, theta)
        out.append((name, fact.format(name),
                    {"id": np.arange(N, dtype=np.int64), "k": keys.astype(np.int64),
                     "v": rng.integers(0, 1000, size=N).astype(np.int64)}))
    # one dominant key (35 %): the production hot-key shape
    p = np.full(K, 0.65 / (K - 1))
    p[5] = 0.35
    out.append(("fact_hot", fact.format("fact_hot"),
                {"id": np.arange(N, dtype=np.int64),
                 "k": rng.choice(K, size=N, p=p).astype(np.int64),
                 "v": rng.integers(0, 1000, size=N).astype(np.int64)}))
    # dim: one row per key, partitioned by an unrelated column
    out.append(("dim", "CREATE TABLE dim (did BIGINT PRIMARY KEY, k BIGINT, attr BIGINT) "
                "PARTITION BY HASH(did) PARTITIONS 8",
                {"did": (np.arange(K, dtype=np.int64) * 7919) % (1 << 30),
                 "k": np.arange(K, dtype=np.int64),
                 "attr": np.arange(K, dtype=np.int64) % 7}))
    # mid: many rows per key, sized so the skewed fact stays the BUILD side
    out.append(("mid", "CREATE TABLE mid (mid BIGINT PRIMARY KEY, k BIGINT, w BIGINT) "
                "PARTITION BY HASH(mid) PARTITIONS 8",
                {"mid": np.arange(MID, dtype=np.int64),
                 "k": (np.arange(MID, dtype=np.int64) * 31) % K,
                 "w": np.arange(MID, dtype=np.int64) % 13}))
    return out


@pytest.fixture(scope="module")
def env():
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    inst = Instance(device="cpu")
    inst._mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    js, s = JaxSession(ji), Session(inst)
    for x in (js, s):
        x.execute("CREATE DATABASE sk; USE sk")
    tables = _tables()
    for name, ddl, arrays in tables:
        js.execute(ddl)
        s.execute(ddl)
        ji.store("sk", name).insert_arrays(arrays, ji.tso.next_timestamp())
        parts, dicts = transfer.arrays_of(ji.store("sk", name))
        inst.install_store(transfer.store_from_arrays(inst.catalog.table("sk", name),
                                                      parts, dicts))
    names = ", ".join(n for n, _d, _a in tables)
    js.execute("ANALYZE TABLE " + names)
    s.execute("ANALYZE TABLE " + names)
    mesh = inst.mesh()
    old = M.BROADCAST_BUILD_LIMIT
    M.BROADCAST_BUILD_LIMIT = 0  # force the shuffle shape for every join
    yield inst, s, mesh, js
    M.BROADCAST_BUILD_LIMIT = old
    s.close()
    js.close()


def run_mpp(inst, mesh, sql, collect=False):
    plan = inst.planner.plan_select(sql, "sk")
    ctx = ExecContext(inst.stores, inst.tso.next_timestamp(), inst.device,
                      inst.device_cache, archive=inst.archive, archive_instance=inst,
                      hints=plan.hints)
    ctx.collect_stats = collect
    out = M.MppExecutor(ctx, mesh).execute(plan.rel)
    return sorted(out.to_pylist()), ctx


def on_vs_off(inst, mesh, sql):
    rows_on, ctx_on = run_mpp(inst, mesh, sql)
    rows_off, ctx_off = run_mpp(inst, mesh, "/*+TDDL: SKEW(OFF)*/ " + sql)
    assert rows_on == rows_off
    return ctx_on, ctx_off


def hybrid_engaged(ctx):
    return any("mpp-hybrid-join" in t for t in ctx.trace)


def salted(ctx):
    return any("mpp-salted-agg" in t for t in ctx.trace)


class TestHybridJoin:
    @pytest.mark.parametrize("fact,want_hybrid", [
        ("fact_t0", False), ("fact_t08", None), ("fact_t12", True),
        ("fact_hot", True)])
    def test_theta_sweep_bit_identical(self, env, fact, want_hybrid):
        inst, _s, mesh, _js = env
        sql = (f"SELECT d.attr, COUNT(*), SUM(f.v) FROM {fact} f, dim d "
               "WHERE f.k = d.k GROUP BY d.attr")
        ctx_on, ctx_off = on_vs_off(inst, mesh, sql)
        if want_hybrid is not None:  # theta=0.8 sits on the hot threshold
            assert hybrid_engaged(ctx_on) == want_hybrid
        assert not hybrid_engaged(ctx_off)

    def test_build_orientation(self, env):
        inst, _s, mesh, _js = env
        # mid is big enough that the engine keeps the skewed fact as BUILD
        sql = ("SELECT COUNT(*), SUM(m.w) FROM mid m, fact_hot f "
               "WHERE m.k = f.k")
        ctx_on, _ = on_vs_off(inst, mesh, sql)
        assert any("skew=build" in t for t in ctx_on.trace), ctx_on.trace

    def test_left_and_semi(self, env):
        inst, _s, mesh, _js = env
        # left join keeps unmatched probe rows (restrict dim: half the keys)
        left = ("SELECT COUNT(*), SUM(f.v), COUNT(d.attr) FROM fact_hot f "
                "LEFT JOIN dim d ON f.k = d.k AND d.k < 400")
        ctx_on, _ = on_vs_off(inst, mesh, left)
        assert hybrid_engaged(ctx_on)
        semi = ("SELECT COUNT(*), SUM(v) FROM fact_hot WHERE k IN "
                "(SELECT k FROM dim WHERE attr < 3)")
        on_vs_off(inst, mesh, semi)

    def test_null_keys_and_empty_build(self, env):
        inst, s, mesh, _js = env
        s.execute("CREATE TABLE fnull (id BIGINT PRIMARY KEY, k BIGINT, "
                  "v BIGINT) PARTITION BY HASH(id) PARTITIONS 8")
        rng = np.random.default_rng(3)
        keys = zipf_keys(rng, 1.2).astype(object)
        keys[::17] = None  # ~6% NULL join keys
        inst.store("sk", "fnull").insert_pylists(
            {"id": list(range(N)), "k": list(keys),
             "v": [int(x) for x in rng.integers(0, 100, N)]},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE fnull")
        ctx, _ = on_vs_off(inst, mesh, "SELECT COUNT(*), SUM(f.v) FROM fnull f, dim d "
                           "WHERE f.k = d.k")
        assert hybrid_engaged(ctx)
        on_vs_off(inst, mesh, "SELECT COUNT(*), SUM(f.v), COUNT(d.attr) FROM fnull f "
                  "LEFT JOIN dim d ON f.k = d.k")
        # empty build side: no dim rows survive the filter
        on_vs_off(inst, mesh, "SELECT COUNT(*), SUM(f.v) FROM fnull f, dim d "
                  "WHERE f.k = d.k AND d.k < 0")


class TestSaltedAgg:
    @pytest.mark.parametrize("fact,want_salt", [
        ("fact_t0", False), ("fact_t08", False), ("fact_t12", True),
        ("fact_hot", True)])
    def test_theta_sweep_bit_identical(self, env, fact, want_salt):
        inst, _s, mesh, _js = env
        sql = (f"SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) FROM {fact} "
               "GROUP BY k")
        ctx_on, ctx_off = on_vs_off(inst, mesh, sql)
        assert salted(ctx_on) == want_salt
        assert not salted(ctx_off)

    def test_salted_with_filter_prelude(self, env):
        inst, _s, mesh, _js = env
        on_vs_off(inst, mesh, "SELECT k, COUNT(*), SUM(v) FROM fact_hot "
                  "WHERE v < 500 GROUP BY k")


@pytest.mark.parametrize("sql", [
    "SELECT d.attr, COUNT(*), SUM(f.v) FROM fact_hot f, dim d WHERE f.k = d.k "
    "GROUP BY d.attr",
    "SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) FROM fact_hot GROUP BY k"])
def test_skewed_rows_equal_the_reference(env, sql):
    """The hybrid join and the salted aggregation against the JAX local engine."""
    inst, _s, mesh, js = env
    rows, ctx = run_mpp(inst, mesh, "/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + sql)
    assert hybrid_engaged(ctx) or salted(ctx)
    assert rows == sorted(js.execute(sql).rows)


# -- activation, drift and the events they publish ---------------------------------------

JOIN_SQL = "SELECT COUNT(*), SUM(f.v) FROM fact_hot f, dim d WHERE f.k = d.k"
AGG_SQL = "SELECT k, COUNT(*) FROM fact_hot GROUP BY k"


def test_activation_and_drift_publish_the_reference_events(env, monkeypatch):
    """`active_join_skew` and `active_salt` on the planted plans of both packages,
    with the hot key live, then with the probe table's row count drifted past
    DRIFT_RATIO: the same activations, trace lines and events."""
    inst, _s, _mesh, js = env

    def scenario(skew_mod, events_mod, pinst, Lmod, make_ctx):
        got = []
        monkeypatch.setattr(events_mod, "publish",
                            lambda kind, detail="", **kw: got.append((kind, detail, kw)))
        plan = pinst.planner.plan_select(JOIN_SQL, "sk")
        join = next(n for n in Lmod.walk(plan.rel) if getattr(n, "skew_plans", None))
        agg_plan = pinst.planner.plan_select(AGG_SQL, "sk")
        agg = next(n for n in Lmod.walk(agg_plan.rel)
                   if getattr(n, "salt_plan", None) is not None)
        out = []
        for drift in (False, True):
            ctx = make_ctx(pinst, plan)
            if drift:
                ctx.stores = dict(ctx.stores)
                for p in join.skew_plans + [agg.salt_plan]:
                    ctx.stores[p.table] = types.SimpleNamespace(
                        row_count=lambda _t=p.total: 3 * _t)
            side = join.skew_plans[0].target_side
            act = skew_mod.active_join_skew(join, ctx, side, 8)
            factor = skew_mod.active_salt(agg, ctx, 8)
            out.append((None if act is None else (act.values, act.orientation,
                                                  act.hot_hashes().tolist()),
                        factor, list(ctx.trace)))
        return out, got

    def jax_ctx(ji, plan):
        return jax_physical.ExecContext(ji.stores, ji.tso.next_timestamp(), [],
                                        archive=ji.archive, archive_instance=ji,
                                        hints=plan.hints)

    def port_ctx(pi, plan):
        return ExecContext(pi.stores, pi.tso.next_timestamp(), pi.device,
                           pi.device_cache, archive=pi.archive, archive_instance=pi,
                           hints=plan.hints)

    want = scenario(jax_skew, jax_events, js.instance, JaxL, jax_ctx)
    got = scenario(sk, events, inst, L, port_ctx)
    assert got == want
    (active, inactive), evs = got
    assert active[0] is not None and active[1] is not None
    assert inactive[0] is None and inactive[1] is None
    kinds = [k for k, _d, _kw in evs]
    assert kinds == ["skew_activate", "skew_activate", "skew_deactivate",
                     "skew_deactivate"]
    assert all("dedupe" in kw for _k, _d, kw in evs)


def test_mpp_run_lands_events_in_the_journal(env):
    inst, _s, mesh, _js = env
    before = events.EVENTS.counts().get("skew_activate", 0)
    _rows, ctx = run_mpp(inst, mesh, JOIN_SQL)
    assert hybrid_engaged(ctx)
    assert events.EVENTS.counts()["skew_activate"] == before + 1
    assert any(e.attrs.get("table") == "sk.fact_hot"
               for e in events.EVENTS.entries(kind="skew_activate"))


class TestDeactivation:
    def test_stats_drift_deactivates(self, env):
        inst, s, mesh, _js = env
        s.execute("CREATE TABLE fdrift (id BIGINT PRIMARY KEY, k BIGINT, "
                  "v BIGINT) PARTITION BY HASH(id) PARTITIONS 8")
        rng = np.random.default_rng(5)
        p = np.full(K, 0.6 / (K - 1))
        p[0] = 0.4
        inst.store("sk", "fdrift").insert_arrays(
            {"id": np.arange(N, dtype=np.int64),
             "k": rng.choice(K, size=N, p=p).astype(np.int64),
             "v": np.ones(N, dtype=np.int64)},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE fdrift")
        sql = ("SELECT COUNT(*), SUM(f.v) FROM fdrift f, dim d "
               "WHERE f.k = d.k")
        _rows, ctx = run_mpp(inst, mesh, sql)
        assert hybrid_engaged(ctx)
        before = events.EVENTS.counts().get("skew_deactivate", 0)
        # a bulk load doubles the table WITHOUT re-ANALYZE: the runtime re-check
        # must deactivate the stale plan, not execute it
        inst.store("sk", "fdrift").insert_arrays(
            {"id": np.arange(N, 3 * N, dtype=np.int64),
             "k": rng.integers(0, K, size=2 * N).astype(np.int64),
             "v": np.ones(2 * N, dtype=np.int64)},
            inst.tso.next_timestamp())
        inst.catalog.table("sk", "fdrift").bump_version()
        rows2, ctx2 = run_mpp(inst, mesh, sql)
        assert not hybrid_engaged(ctx2)
        assert any("skew-deactivated" in t for t in ctx2.trace)
        assert events.EVENTS.counts()["skew_deactivate"] == before + 1
        assert rows2 == [(3 * N, 3 * N)]  # every key has its dim row; v is 1

    def test_runtime_refresh_from_build_side(self, env):
        inst, s, _mesh, _js = env
        tm = inst.catalog.table("sk", "mid")
        tm.stats.heavy_rt.pop("k", None)
        # local-engine join: mid (>= 4096 live rows) is the build side, so its key
        # lane refreshes the runtime sketch as it materializes
        s.execute("SELECT COUNT(*) FROM fact_t0 f, mid m WHERE f.k = m.k")
        hh = tm.stats.heavy_rt.get("k")
        assert hh is not None and hh.total >= 4096


class TestFragmentCacheInvalidation:
    def test_hot_key_set_change_rekeys_fingerprint(self, env):
        inst, _s, _mesh, _js = env

        def ctx_of(hints=None):
            return ExecContext(inst.stores, inst.tso.next_timestamp(), inst.device,
                               inst.device_cache, archive=inst.archive,
                               archive_instance=inst, hints=hints)
        plan = inst.planner.plan_select(AGG_SQL, "sk")
        agg = next(n for n in L.walk(plan.rel) if isinstance(n, L.Aggregate))
        key1 = fc.fingerprint(agg, ctx_of()).key
        # the hot-key candidate set changed (a re-ANALYZE after data shifted)
        tm = inst.catalog.table("sk", "fact_hot")
        old = tm.stats.heavy["k"]
        try:
            tm.stats.heavy["k"] = HeavyHitterSketch({11: 30000}, old.total)
            inst.planner.cache.invalidate_all()
            plan2 = inst.planner.plan_select(AGG_SQL, "sk")
            agg2 = next(n for n in L.walk(plan2.rel) if isinstance(n, L.Aggregate))
            key2 = fc.fingerprint(agg2, ctx_of()).key
            assert key1 != key2
            # disabled skew execution separates the cached shapes too
            key3 = fc.fingerprint(agg2, ctx_of({"skew": "off"})).key
            assert key3 != key2
        finally:
            tm.stats.heavy["k"] = old
            inst.planner.cache.invalidate_all()


class TestHatches:
    def test_hint_structurally_unplants(self, env):
        inst, _s, _mesh, _js = env
        sql = "SELECT COUNT(*) FROM fact_hot f, dim d WHERE f.k = d.k"
        plan = inst.planner.plan_select("/*+TDDL: SKEW(OFF)*/ " + sql, "sk")
        assert all(not getattr(n, "skew_plans", None) for n in L.walk(plan.rel))
        plan2 = inst.planner.plan_select(sql, "sk")
        assert any(getattr(n, "skew_plans", None) for n in L.walk(plan2.rel))

    def test_hint_join_agg_split(self, env):
        inst, _s, mesh, _js = env
        sql = ("SELECT f.k, COUNT(*) FROM fact_hot f, dim d "
               "WHERE f.k = d.k GROUP BY f.k")
        rows_j, ctx_j = run_mpp(inst, mesh, "/*+TDDL: SKEW(JOIN)*/ " + sql)
        assert hybrid_engaged(ctx_j) and not salted(ctx_j)
        rows_a, ctx_a = run_mpp(inst, mesh, "/*+TDDL: SKEW(AGG)*/ " + sql)
        assert not hybrid_engaged(ctx_a) and salted(ctx_a)
        assert rows_j == rows_a

    def test_param_gates_execution(self, env):
        inst, _s, mesh, _js = env
        sql = "SELECT COUNT(*) FROM fact_hot f, dim d WHERE f.k = d.k"
        inst.config.set_instance("ENABLE_SKEW_EXECUTION", False)
        try:
            _, ctx = run_mpp(inst, mesh, sql)
            assert not hybrid_engaged(ctx)
        finally:
            inst.config.set_instance("ENABLE_SKEW_EXECUTION", True)
        _, ctx2 = run_mpp(inst, mesh, sql)
        assert hybrid_engaged(ctx2)

    def test_session_set_gates_execution(self, env):
        inst, _s, _mesh, _js = env
        s2 = Session(inst)
        s2.execute("USE sk")
        inst.config.set_instance("MPP_MIN_AP_ROWS", 1)
        sql = "SELECT COUNT(*) FROM fact_hot f, dim d WHERE f.k = d.k"
        try:
            s2.execute("SET ENABLE_SKEW_EXECUTION = 0")
            inst.frag_cache.clear()  # a warm mpp agg would skip the join
            s2.execute(sql)
            trace = "\n".join(t[0] for t in s2.execute("SHOW TRACE").rows)
            assert "mpp-scan" in trace and "mpp-hybrid-join" not in trace, trace
            s2.execute("SET ENABLE_SKEW_EXECUTION = 1")
            inst.frag_cache.clear()
            s2.execute(sql)
            trace = "\n".join(t[0] for t in s2.execute("SHOW TRACE").rows)
            assert "mpp-hybrid-join" in trace, trace
        finally:
            inst.config.set_instance("MPP_MIN_AP_ROWS", 1 << 22)
            s2.close()

    def test_env_kill_switch(self, env, monkeypatch):
        inst, _s, _mesh, _js = env
        monkeypatch.setattr(sk, "ENABLED", False)
        inst.planner.cache.invalidate_all()
        sql = "SELECT COUNT(*) FROM fact_hot f, dim d WHERE f.k = d.k"
        try:
            plan = inst.planner.plan_select(sql, "sk")
            assert all(not getattr(n, "skew_plans", None) for n in L.walk(plan.rel))
        finally:
            # drop the unplanted plan so later tests re-plan with skew on
            inst.planner.cache.invalidate_all()


class TestObservability:
    def test_shard_skew_stats_and_gauge(self, env):
        inst, _s, mesh, _js = env
        _, ctx = run_mpp(inst, mesh, JOIN_SQL, collect=True)
        skews = [st.get("shard_skew") for st in ctx.op_stats if st.get("shard_skew")]
        assert skews, ctx.op_stats
        assert all(x >= 1.0 for x in skews)
        vals = {n: v for n, _k, v, _h in inst.metrics.rows()}
        assert vals.get("mpp_shard_skew", 0) >= 1.0
        assert any(i.get("kind") == "join" for i in ctx.skew_stats.values())

    def test_explain_analyze_annotations_match_reference(self, env, monkeypatch):
        """EXPLAIN ANALYZE through both sessions under MPP: the same nodes with the
        same actual rows, and the same HotKeys/Salted lines."""
        from galaxysql_tpu.parallel import mpp as jax_mpp
        inst, _s, _mesh, js = env
        monkeypatch.setattr(jax_mpp, "BROADCAST_BUILD_LIMIT", 0)
        # the port's instance ran this join before: no cached build may stand in
        sql = ("EXPLAIN ANALYZE /*+TDDL: FRAGMENT_CACHE(OFF)*/ SELECT f.k, COUNT(*), "
               "SUM(f.v) FROM fact_hot f, dim d WHERE f.k = d.k GROUP BY f.k")

        def nodes(rs):
            out = []
            for (line,) in rs.rows:
                if line.startswith("--"):
                    continue
                out.append(line.split("  (actual rows=")[0] +
                           (" rows=" + line.split("(actual rows=")[1].split()[0]
                            if "(actual rows=" in line else ""))
            return out
        got = []
        for x in (js, Session(inst)):
            x.execute("USE sk")
            x.execute("SET ENABLE_MPP = 1")
            x.instance.config.set_instance("MPP_MIN_AP_ROWS", 1)
            try:
                got.append(nodes(x.execute(sql)))
            finally:
                x.instance.config.set_instance("MPP_MIN_AP_ROWS", 1 << 22)
        want, port = got
        assert port == want
        text = "\n".join(port)
        assert "HotKeys(" in text and "Salted(" in text, text


def test_unsigned_hot_key_above_2_63_fails_alike():
    """A shared fault, pinned: a BIGINT UNSIGNED join key whose hot value is 2^63 or
    more.  The copied `skew.hot_hash_lane` casts the sketch's values through int64,
    which a Python int past 2^63 - 1 does not fit, so the hybrid join raises
    `OverflowError` in both packages (ROADMAP Queue 3)."""
    from galaxysql_tpu.parallel import mpp as jax_mpp
    from galaxysql_tpu.parallel.mesh import make_mesh as jax_make_mesh

    def scenario(new, run):
        inst = new()
        s = (JaxSession if isinstance(inst, JaxInstance) else Session)(inst)
        s.execute("CREATE DATABASE u; USE u")
        s.execute("CREATE TABLE f (id BIGINT, k BIGINT UNSIGNED, v BIGINT) "
                  "PARTITION BY HASH(id) PARTITIONS 8")
        s.execute("CREATE TABLE d (k BIGINT UNSIGNED, a BIGINT)")
        n = 40000
        rng = np.random.default_rng(0)
        base = np.uint64(1 << 63)
        k = rng.integers(0, 800, n).astype(np.uint64) + base
        k[rng.random(n) < 0.4] = base + np.uint64(5)
        inst.store("u", "f").insert_arrays(
            {"id": np.arange(n), "k": k, "v": np.ones(n, np.int64)},
            inst.tso.next_timestamp())
        inst.store("u", "d").insert_arrays(
            {"k": np.arange(800).astype(np.uint64) + base, "a": np.arange(800) % 7},
            inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE f, d")
        plan = inst.planner.plan_select(
            "SELECT d.a, count(*) FROM f, d WHERE f.k = d.k GROUP BY d.a", "u")
        with pytest.raises(OverflowError) as e:
            run(inst, plan)
        s.close()
        return str(e.value)

    def run_jax(ji, plan):
        ctx = jax_physical.ExecContext(ji.stores, ji.tso.next_timestamp(), [],
                                       archive=ji.archive, archive_instance=ji,
                                       hints=plan.hints)
        jax_mpp.MppExecutor(ctx, jax_make_mesh(8)).execute(plan.rel)

    def run_port(pi, plan):
        ctx = ExecContext(pi.stores, pi.tso.next_timestamp(), pi.device, pi.device_cache,
                          archive=pi.archive, archive_instance=pi, hints=plan.hints)
        M.MppExecutor(ctx, make_mesh(devices=[torch.device("cpu")] * 8)).execute(plan.rel)

    def jax_new():
        ji = JaxInstance(boot=False)
        ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
        ji.boot()
        return ji
    old_j, old_p = jax_mpp.BROADCAST_BUILD_LIMIT, M.BROADCAST_BUILD_LIMIT
    jax_mpp.BROADCAST_BUILD_LIMIT = M.BROADCAST_BUILD_LIMIT = 0
    try:
        want = scenario(jax_new, run_jax)
        got = scenario(lambda: Instance(device="cpu"), run_port)
    finally:
        jax_mpp.BROADCAST_BUILD_LIMIT, M.BROADCAST_BUILD_LIMIT = old_j, old_p
    assert got == want
