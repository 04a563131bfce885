"""The serving tier in the port against the JAX package on the CPU: the front router
(`server/router.py`: the digest ring, session affinity, failover, gossip), the
cluster-wide admission it carries, placement bindings (`server/placement.py`, and
`Instance.read_endpoint`'s boost of the bound endpoint), the peer registry with SHOW
COORDINATORS, `information_schema.coordinators` and the CLUSTER forms of SHOW
STATEMENT SUMMARY and SHOW METRICS, the hatches, and the peer side of routed
tracing (the session's `/*trace:id:parent:node:sampled*/` hint).  The counterparts
of `tests/test_router.py` and `tests/test_flight_recorder.py::TestRouterTraceGraft`.

Every scenario builds the same tier in each package, a JAX one and a port one on the
CPU (`torch_plane_harness.both`), and returns what both must agree on.  Node ids are
random, so a digest's ring owner differs between the packages: outcomes name a node
by its role in the tier (local, peer 0, peer 1), and routing is compared by its
counts and by whether each statement landed on its ring owner."""

import importlib
import os
import random
import subprocess
import sys
import time

import pytest

from torch_plane_harness import both

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(pkg, rel: str):
    root = "galaxysql_tpu" if pkg.name == "jax" else "galaxysql_tpu_torch"
    return importlib.import_module(f"{root}.{rel}")


def seed(pkg, inst, tables=("t",)):
    s = pkg.Session(inst)
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    for t in tables:
        s.execute(f"CREATE TABLE {t} (k BIGINT PRIMARY KEY, v BIGINT)")
        s.execute(f"INSERT INTO {t} VALUES (1, 10), (2, 20), (3, 30)")
    return s


class Tier:
    """A 3-peer in-process serving tier: the local coordinator and two peers."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.r = mod(pkg, "server.router")
        self.a = pkg.Instance()
        self.sa = seed(pkg, self.a)
        self.router = self.r.FrontRouter(self.a)
        self.peers = []
        for _ in range(2):
            b = pkg.Instance()
            seed(pkg, b).close()
            p = self.r.InprocPeer(b)
            self.router.add_peer(p)
            self.peers.append(p)

    def role(self, node):
        if node == self.a.node_id:
            return "local"
        for i, p in enumerate(self.peers):
            if node == p.node_id:
                return f"peer{i}"
        return node

    def session(self):
        return self.r.RouterSession(self.router, schema="d")

    def close(self):
        self.router.close()
        self.sa.close()


def tiered(body):
    """`both` over a scenario body(tier), the tier closed after it."""
    def scenario(pkg):
        tier = Tier(pkg)
        try:
            return body(tier)
        finally:
            tier.close()
    return both(scenario)


# -- the ring -------------------------------------------------------------------------


def test_digest_routing_is_stable_spreads_and_follows_the_ring():
    def body(t):
        owners = {f"digest-{i}": t.router.ring_owner(f"digest-{i}") for i in range(64)}
        stable = all(t.router.ring_owner(d) == o for d, o in owners.items())
        s = t.session()
        for q in ["select 1", "select 2", "select 1 + 1", "select 9"]:
            s.execute(q)
        r = t.router
        out = (stable, len(set(owners.values())), r.m_routed.value, r.m_hits.value,
               r.m_misses.value, sum(r.affinity_of(n)[0] for n in r.peers))
        s.close()
        return out
    assert tiered(body) == (True, 3, 4, 4, 0, 4)


def test_a_down_peer_is_skipped_within_the_statement():
    def body(t):
        s = t.session()
        t.router._gossip_at = float("inf")  # the statement must find the death
        t.peers[0].down = True
        r = t.router
        h0, m0, f0 = r.m_hits.value, r.m_misses.value, r.m_failovers.value
        rows = [s.execute(f"select {i} * 3 as c{i}").rows for i in range(24)]
        out = (rows, r.m_failovers.value > f0, r.m_misses.value > m0,
               r.m_hits.value + r.m_misses.value - h0 - m0,
               r.affinity_of(t.peers[0].node_id)[0])
        s.close()
        return out
    rows, failed_over, missed, routed, dead_routed = tiered(body)
    assert failed_over and missed and routed == 24 and dead_routed == 0
    assert rows == [[(i * 3,)] for i in range(24)]


def test_a_statement_lands_on_its_ring_owner():
    """Every routed digest runs on the peer its ring owner names (the statement
    summary of that peer counts it), and the same digest keeps that peer."""
    def body(t):
        s = t.session()
        sql = [f"select v from t where k = {1 + i % 3}" if i % 2 else
               f"select k, v + {i} as x{i} from t order by k" for i in range(12)]
        ssm = mod(t.pkg, "meta.statement_summary")
        pz = mod(t.pkg, "sql.parameterize")
        ok = []
        for q in sql:
            digest = ssm.digest_key("d", pz.parameterize(q).cache_key)
            owner = t.router.ring_owner(digest)
            before = t.router.affinity_of(owner)[0]
            s.execute(q)
            ok.append(t.router.affinity_of(owner)[0] == before + 1)
        s.close()
        return ok
    assert all(tiered(body))


# -- session affinity -----------------------------------------------------------------


def test_session_affinity_pins_and_fails_typed_once():
    def body(t):
        s = t.session()
        s.execute("begin")
        pinned = s.pinned
        s.execute("select k from t where k = 1")
        s.execute("commit")
        kept = s.pinned == pinned
        s2 = t.session()
        s2.execute("select 1")
        free = s2.pinned is None
        s2.execute("SET GLOBAL SLOW_SQL_MS = 1234")
        global_free = s2.pinned is None
        s2.execute("SET autocommit = 1")
        session_pinned = s2.pinned is not None
        s3 = t.session()
        s3.execute("begin")
        peer = t.router.peers[s3.pinned]
        peer.down = True
        try:
            s3.execute("select k from t where k = 1")
            e = None
        except t.pkg.errors.CoordinatorUnavailableError as x:
            e = (type(x).__name__, x.errno)
        unpinned = s3.pinned is None
        again = s3.execute("select k from t where k = 2").rows
        peer.down = False
        for x in (s, s2, s3):
            x.close()
        return (pinned is not None, kept, free, global_free, session_pinned, e,
                unpinned, again)
    assert tiered(body) == (True, True, True, True, True,
                            ("CoordinatorUnavailableError", 9004), True, [(2,)])


# -- cluster admission ----------------------------------------------------------------


def test_gossip_clamp_detach_and_hatch():
    def body(t):
        a, router, peers = t.a, t.router, t.peers
        router.gossip_tick()
        nodes = {n for n, _s, _a in a.admission.peer_gossip_rows()}
        gossiped = {p.node_id for p in peers} <= nodes
        snap = peers[0].instance.admission.cluster_snapshot()
        snap["tp"]["limit"] = 4.0
        a.admission.note_peer(peers[0].node_id, snap)
        clamped = (a.admission.effective_limit("TP"), a.admission.limit("TP") > 4.0)
        a.admission._peer_snaps[peers[0].node_id] = (snap, time.time() - 3600.0)
        a.admission._cluster_expire = 0.0
        expired = a.admission.effective_limit("TP") == a.admission.limit("TP")
        snap["tp"]["limit"] = 2.0
        a.admission.note_peer(peers[0].node_id, snap)
        a.config.set_instance("ENABLE_CLUSTER_ADMISSION", 0)
        hatched = a.admission.effective_limit("TP") == a.admission.limit("TP")
        a.config.set_instance("ENABLE_CLUSTER_ADMISSION", 1)
        reclamped = a.admission.effective_limit("TP")
        node = peers[1].node_id
        router.remove_peer(node)
        forgot = not any(n == node for n, _s, _a in a.admission.peer_gossip_rows())
        return (gossiped, clamped, expired, hatched, reclamped, forgot,
                node not in router.peers, node not in a.coordinators,
                len(a.sync_bus.workers))
    assert tiered(body) == (True, (4.0, True), True, True, 2.0, True, True, True, 1)


def test_gossip_failure_marks_a_peer_down_and_the_next_tick_revives_it():
    def body(t):
        peer = t.peers[0]
        orig = peer.sync_action
        state = {"fail": True}

        def flaky(action, payload):
            if state["fail"]:
                raise ConnectionError("injected drop")
            return orig(action, payload)
        peer.sync_action = flaky
        try:
            t.router.gossip_tick()
            down = peer.down_until > time.time()
            state["fail"] = False
            t.router.gossip_tick()
            return down, peer.down_until, t.router.staleness_ms() >= 0.0
        finally:
            peer.sync_action = orig
    assert tiered(body) == (True, 0.0, True)


# -- placement ------------------------------------------------------------------------


def test_placement_bindings_and_the_bound_coordinator():
    def body(t):
        a, router, peers = t.a, t.router, t.peers
        a.placement.bind("g0", endpoint="127.0.0.1:9999")
        a.placement.bind("g0", coordinator=peers[0].node_id)
        ent = dict(a.placement.binding("g0"))
        rows = [(g, e, t.role(c), dv) for g, e, c, dv in a.placement.rows()]
        a.placement.unbind("g0")
        gone = a.placement.binding("g0")
        sql = "select v from t where k = 1"
        a.placement.bind("g0", coordinator=peers[1].node_id)
        a.placement._cache_at = 0.0
        target = t.role(router.targets_for("any-digest", sql, "d")[0].node_id)
        s = t.session()
        h0 = router.m_hits.value
        rows2 = s.execute(sql).rows
        hit = router.m_hits.value == h0 + 1
        on_peer1 = router.affinity_of(peers[1].node_id)[0]
        a.placement.unbind("g0")
        tm = a.catalog.table("d", "t")
        a.placement.bind("g0", endpoint="10.0.0.7:4406")
        parsed = a.placement.preferred_endpoint(tm)
        a.placement.bind("g0", endpoint="bogus")
        a.placement._cache_at = 0.0
        bogus = a.placement.preferred_endpoint(tm)
        a.placement.unbind("g0")
        s.close()
        return (ent["endpoint"], t.role(ent["coordinator"]), rows, gone, target, rows2,
                hit, on_peer1, parsed, bogus, a.placement.dominant_group(tm))
    assert tiered(body) == ("127.0.0.1:9999", "peer0",
                            [("g0", "127.0.0.1:9999", "peer0", "")], None, "peer1",
                            [(10,)], True, 1, ("10.0.0.7", 4406), None, "g0")


def test_read_endpoint_boosts_the_bound_endpoint():
    """`read_endpoint` over a primary and a replica of equal weight: with the
    table's dominant group bound to the replica's endpoint, the replica takes four
    times the primary's reads.  Seeded, so both packages pick alike."""
    class _Client:
        load_at = 0.0

        def breaker_blocked(self):
            return False

    def scenario(pkg):
        inst = pkg.Instance()
        s = seed(pkg, inst)
        tm = inst.catalog.table("d", "t")
        tm.remote = {"host": "10.0.0.1", "port": 1}
        tm.replicas = [{"host": "10.0.0.2", "port": 2}]
        inst.workers[("10.0.0.1", 1)] = _Client()
        inst.workers[("10.0.0.2", 2)] = _Client()
        picks = {}
        for bound in (False, True):
            if bound:
                inst.placement.bind(inst.placement.dominant_group(tm),
                                    endpoint="10.0.0.2:2")
            random.seed(11)
            got = [inst.read_endpoint(tm)[0][1] for _ in range(2000)]
            picks[bound] = (got.count(1), got.count(2))
        inst.workers.clear()
        tm.remote = None
        tm.replicas = []
        s.close()
        return picks
    picks = both(scenario)
    assert abs(picks[False][0] - 1000) < 150
    assert 3.0 < picks[True][1] / picks[True][0] < 5.5


# -- SHOW surfaces and events ---------------------------------------------------------


def test_show_coordinators_and_information_schema():
    def body(t):
        s = t.pkg.Session(t.a, schema="d")
        rs = s.execute("SHOW COORDINATORS")
        rows = sorted((t.role(r[0]), r[1], r[2], r[8]) for r in rs.rows)
        t.peers[0].down = True
        dead = sorted((t.role(r[0]), r[2]) for r in s.execute("SHOW COORDINATORS").rows)
        t.peers[0].down = False
        t.router.gossip_tick()
        info = sorted((t.role(r[0]), r[1], r[2]) for r in s.execute(
            "SELECT node_id, role, state FROM information_schema.coordinators").rows)
        s.close()
        return rs.names, rows, dead, info
    names, rows, dead, info = tiered(body)
    assert names[0] == "Node" and rows[0][:3] == ("local", "local", "OK")
    assert ("peer0", "UNREACHABLE") in dead
    assert [r[0] for r in info] == ["local", "peer0", "peer1"]


def test_show_cluster_forms_merge_the_peers():
    def body(t):
        rs_ = t.session()
        for q in ["select k from t where k = 1", "select v from t", "select 41 + 1"]:
            rs_.execute(q)
        s = t.pkg.Session(t.a, schema="d")
        summary = s.execute("SHOW CLUSTER STATEMENT SUMMARY")
        nodes = sorted({t.role(r[0]) for r in summary.rows})
        metrics = {(t.role(r[0]), r[1]) for r in s.execute("SHOW CLUSTER METRICS").rows}
        router_rows = sorted(n for role, n in metrics if role == "local" and n in (
            "router_routed_queries", "affinity_hits", "affinity_misses",
            "gossip_staleness_ms", "router_failovers"))
        t.peers[0].down = True
        dead_m = [r[1] for r in s.execute("SHOW CLUSTER METRICS").rows
                  if t.role(r[0]) == "peer0"]
        dead_s = [r[1] for r in s.execute("SHOW CLUSTER STATEMENT SUMMARY").rows
                  if t.role(r[0]) == "peer0"]
        t.peers[0].down = False
        s.close()
        rs_.close()
        return summary.names[0], len(nodes) >= 2, router_rows, dead_m, dead_s
    assert tiered(body) == ("Node", True,
                            ["affinity_hits", "affinity_misses", "gossip_staleness_ms",
                             "router_failovers", "router_routed_queries"],
                            ["UNREACHABLE"], ["UNREACHABLE"])


def test_join_and_leave_events():
    def body(t):
        joined = [(e.kind, t.role(e.attrs.get("peer"))) for e in
                  t.pkg.EVENTS.entries(kind="coordinator_joined")]
        t.router.remove_peer(t.peers[1].node_id, reason="test detach")
        left = [(e.kind, t.role(e.attrs.get("peer")), e.attrs.get("reason")) for e in
                t.pkg.EVENTS.entries(kind="coordinator_left")]
        return joined, left
    joined, left = tiered(body)
    assert joined == [("coordinator_joined", "peer0"), ("coordinator_joined", "peer1")]
    assert left == [("coordinator_left", "peer1", "test detach")]


# -- the hatches ----------------------------------------------------------------------


def test_router_hatches_are_structurally_off_path(monkeypatch):
    def body(t):
        a, router = t.a, t.router
        plain = t.pkg.Session(a, schema="d")
        a.config.set_instance("ENABLE_ROUTER", 0)
        routed0 = router.m_routed.value
        s = t.session()
        same = [s.execute(q).rows == plain.execute(q).rows
                for q in ["select k, v from t order by k", "select v from t where k = 2"]]
        a.config.set_instance("ENABLE_ROUTER", 1)
        param_off = router.m_routed.value == routed0
        monkeypatch.setattr(t.r, "ENABLED", False)
        env_rows = s.execute("select k from t where k = 3").rows
        env_off = router.m_routed.value == routed0
        monkeypatch.setattr(t.r, "ENABLED", True)
        s.close()
        plain.close()
        return same, param_off, env_rows, env_off
    assert tiered(body) == ([True, True], True, [(3,)], True)


@pytest.mark.parametrize("package", ["galaxysql_tpu", "galaxysql_tpu_torch"])
def test_env_hatch_reads_the_environment(package):
    out = subprocess.run(
        [sys.executable, "-c", f"from {package}.server import router; print(router.ENABLED)"],
        env=dict(os.environ, GALAXYSQL_ROUTER="0", JAX_PLATFORMS="cpu"), cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False"


# -- routed tracing -------------------------------------------------------------------


def test_session_adopts_and_strips_the_trace_hint():
    """A statement prefixed with the router's hint: the hint is stripped before the
    digest (one statement-summary row for the hinted and the plain text), the traced
    query takes the hinted trace id, and a sampled hint makes the trace store keep
    it (reason `remote`); the next statement carries no hint."""
    def scenario(pkg):
        inst = pkg.Instance()
        s = seed(pkg, inst)
        s.execute("SET ENABLE_QUERY_TRACING = 1")
        plain = s.execute("select v from t where k = 2").rows
        hinted = s.execute("/*trace:987654321:42:cn-router:1*/select v from t "
                           "where k = 3").rows
        prof = inst.profiles.entries()[-1]
        rt = inst.trace_store.get(987654321)
        after = s.execute("select v from t where k = 1").rows
        nxt = inst.profiles.entries()[-1].trace_id
        rows = [r for r in s.execute("SHOW STATEMENT SUMMARY").rows if "where k" in r[-1]]
        digests = (len({r[0] for r in rows}), sum(r[4] for r in rows),
                   sorted({r[-1] for r in rows}))
        s.close()
        return (plain, hinted, after, prof.trace_id, rt is not None and rt.reason,
                nxt != 987654321, digests, s._trace_hint)
    assert both(scenario) == ([(20,)], [(30,)], [(10,)], 987654321, "remote", True,
                              (1, 3, ["select v from t where k = 2"]), None)


def test_inproc_peer_hop_grafts_one_trace():
    def scenario(pkg):
        r = mod(pkg, "server.router")
        a = pkg.Instance()
        sa = seed(pkg, a)
        router = r.FrontRouter(a)
        router.local.down_until = float("inf")  # the hub routes, never serves
        b = pkg.Instance()
        seed(pkg, b).close()
        router.add_peer(r.InprocPeer(b))
        try:
            a.trace_store.configure(rate=1.0)
            rsess = r.RouterSession(router, schema="d")
            rows = rsess.execute("select v from t where k = 2").rows
            spans = rsess.last_spans
            role = {a.node_id: "router", b.node_id: "peer"}
            tree = sorted((role.get(sp.node), sp.kind, sp.name) for sp in spans)
            kids = [sp.name for sp in spans if sp.node == b.node_id and
                    sp.parent_id == spans[0].span_id]
            rt = a.trace_store.get(rsess.last_trace_id)
            prt = b.trace_store.get(rsess.last_trace_id)
            show = [ln for ln in (x[0] for x in rsess.execute("SHOW TRACE").rows)]
            out = (rows, spans[0].name, tree, kids, sorted(rt.phases) if rt else None,
                   sorted({role[x["node"]] for x in rt.spans}), prt.reason,
                   show[0] == f"trace-id {rsess.last_trace_id}",
                   any(b.node_id in ln for ln in show))
            a.trace_store.configure(rate=0.0)
            try:
                rsess.execute("select nope from t")
                e = None
            except pkg.errors.TddlError as x:
                e = type(x).__name__
            rt2 = a.trace_store.get(rsess.last_trace_id)
            rsess.close()
            return out + (e, rt2.reason, "UnknownColumnError" in rt2.error)
        finally:
            router.close()
            sa.close()
    out = both(scenario)
    assert out[0] == [(20,)] and out[1] == "route" and out[3] == ["query"]
    assert out[5] == ["peer", "router"] and out[6] == "remote" and out[7] and out[8]
    assert out[9:] == ("UnknownColumnError", "error", True)


def _spawn_coordinator(package, data_dir):
    flag = ["--platform", "cpu"] if package == "galaxysql_tpu" else ["--device", "cpu"]
    p = subprocess.Popen(
        [sys.executable, "-m", f"{package}.net.server", "--port", "0", "--sync-port",
         "0", "--data-dir", data_dir, "--announce"] + flag,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"), text=True)
    line = p.stdout.readline()
    if not line.startswith("SERVER_READY"):
        p.kill()
        p.wait()
        raise AssertionError(f"{package} coordinator failed to start: {line!r}")
    _, mysql_port, sync_port = line.split()
    return p, int(mysql_port), int(sync_port)


def test_remote_peer_over_real_wires(tmp_path):
    """A coordinator process of each package behind a hub of the same package:
    statements over the MySQL wire with the trace hint, the peer's trace pulled
    back over the sync wire and grafted, SHOW COORDINATORS pulling the peer, and a
    killed peer failing the pinned session typed once."""
    def scenario(pkg):
        root = "galaxysql_tpu" if pkg.name == "jax" else "galaxysql_tpu_torch"
        d = str(tmp_path / pkg.name)
        inst = pkg.Instance(data_dir=d)
        seed(pkg, inst).close()
        inst.save()
        p, mp, sp = _spawn_coordinator(root, d)
        r = mod(pkg, "server.router")
        hub = pkg.Instance()
        router = r.FrontRouter(hub)
        router.local.down_until = float("inf")
        try:
            peer = router.add_remote("127.0.0.1", mp, sp)
            hub.trace_store.configure(rate=1.0)
            rsess = r.RouterSession(router, schema="d")
            rows = [tuple(map(int, x)) for x in
                    rsess.execute("select v from t where k = 2").rows]
            rt = hub.trace_store.get(rsess.last_trace_id)
            kids = [x["name"] for x in rt.spans
                    if x["parent_id"] == rt.spans[0]["span_id"]]
            nodes = len({x["node"] for x in rt.spans})
            s = pkg.Session(hub)
            coords = sorted((x[1], x[2]) for x in s.execute("SHOW COORDINATORS").rows)
            pin = r.RouterSession(router, schema="d")
            pin.execute("begin")
            p.kill()
            p.wait()
            try:
                pin.execute("select k from t where k = 1")
                e = None
            except pkg.errors.CoordinatorUnavailableError as x:
                e = x.errno
            after = pin.pinned
            dead = sorted((x[1], x[2]) for x in s.execute("SHOW COORDINATORS").rows)
            s.close()
            return (rows, rt.spans[0]["name"], kids, nodes, "execute" in rt.phases,
                    coords, e, after, dead, peer.kind)
        finally:
            router.close()
            if p.poll() is None:
                p.kill()
                p.wait()
    assert both(scenario) == ([(20,)], "route", ["query"], 2, True,
                              [("local", "OK"), ("peer", "OK")], 9004, None,
                              [("local", "OK"), ("peer", "UNREACHABLE")], "remote")
