"""The port's worker plane against the JAX package's, on the CPU.

A JAX worker (`python -m galaxysql_tpu.net.worker --platform cpu`) and a port worker
(`python -m galaxysql_tpu_torch.net.worker --device cpu`) start as real subprocesses
with the same `--init-sql`.  A JAX coordinator (`Instance()`) attached to the JAX
worker and a port coordinator (`Instance(device="cpu")`) attached to the port worker
run the same script, and every step must give the same outcome: remote scans with
column pruning, SARGs, point keys and runtime-filter pushdown (the fragments each
coordinator ships are recorded and compared, and so are the workers' query logs),
joins of remote tables with local ones, GROUP BY, autocommit remote DML,
read-your-own-writes in a transaction, COMMIT and ROLLBACK over a local and a remote
table, SHOW WORKERS and information_schema.workers.  The coordinator's decode of
every wire type (`physical.remote_column`) and the worker's encode
(`Worker._wire_lane`) are held to the reference's, dictionary codes included.  Each
coordinator also runs against the other package's worker: the wire is the
reference's.
"""

import contextlib

import numpy as np
import pytest
import torch

from torch_worker_harness import PACKAGES, coordinator, outcome, start_all

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and the coordinators' small
# CPU computations must not take cores from the other workers' tests
torch.set_num_threads(1)

INIT_SQL = (
    "CREATE DATABASE w; USE w; "
    "CREATE TABLE dim (k BIGINT PRIMARY KEY, label VARCHAR(16), price DECIMAL(10,2), "
    "d DATE, ts DATETIME, x DOUBLE, u BIGINT UNSIGNED); "
    "INSERT INTO dim VALUES "
    "(1,'alpha',1.50,'1995-03-15','1995-03-15 10:20:30',0.5,5), "
    "(2,'beta',2.25,'1996-01-01','1996-01-01 00:00:00',-1.75,9223372036854775807), "
    "(3,'gamma',0.75,'1994-12-31','1994-12-31 23:59:59',2.0,0), "
    "(4,'delta',9.99,'1998-08-02','1998-08-02 12:00:00',1e10,42), "
    "(5,NULL,NULL,NULL,NULL,NULL,NULL), "
    "(6,'alpha',0.01,'1995-03-15','1995-03-15 10:20:31',-0.0,1); "
    "CREATE TABLE big (k BIGINT PRIMARY KEY, u BIGINT UNSIGNED); "
    "INSERT INTO big VALUES (1, 9223372036854775807), (2, 9223372036854775808), "
    "(3, 18446744073709551615)")

# the coordinator's own tables: `fact` joins the remote `dim`
LOCAL_SQL = (
    "CREATE DATABASE w; USE w; "
    "CREATE TABLE fact (id BIGINT PRIMARY KEY, k BIGINT, qty BIGINT); "
    "INSERT INTO fact VALUES " +
    ", ".join(f"({i}, {(i % 6) + 1}, {i})" for i in range(60)) + "; "
    "CREATE TABLE localtab (id BIGINT PRIMARY KEY, v BIGINT); "
    "CREATE TABLE probe (id BIGINT PRIMARY KEY, k BIGINT); "
    "INSERT INTO probe VALUES (1, 2), (2, 4)")

DIM_ROW = "(9, 'iota', 1.10, '2000-01-01', '2000-01-01 00:00:00', 1.25, 7)"

# (session, statement): "s" the script's session, "s2" a second session
SCRIPT = [
    ("s", "SELECT k, label, price, d, ts, x, u FROM dim ORDER BY k"),
    ("s", "SELECT k FROM dim ORDER BY k"),                          # pruned columns
    ("s", "SELECT k, label FROM dim WHERE k >= 3 ORDER BY k"),      # SARG
    ("s", "SELECT label, x FROM dim WHERE k = 2"),                  # point key
    ("s", "SELECT k, price FROM dim WHERE d < DATE '1996-01-01' ORDER BY k"),
    ("s", "SELECT k, u FROM dim WHERE u > 6 ORDER BY k"),
    ("s", "SELECT dim.label, sum(fact.qty) FROM fact, dim WHERE fact.k = dim.k "
          "AND dim.k <= 2 GROUP BY dim.label ORDER BY dim.label"),
    ("s", "SELECT p.id, d.label, d.price FROM probe p JOIN dim d ON p.k = d.k "
          "ORDER BY p.id"),                                         # runtime filter
    ("s", "SELECT label, count(*), sum(price), min(d), max(ts) FROM dim "
          "GROUP BY label ORDER BY label"),
    ("s", "SELECT d.label, count(*) FROM fact f JOIN dim d ON f.k = d.k "
          "WHERE f.qty < 30 GROUP BY d.label ORDER BY d.label"),
    ("s", f"INSERT INTO dim VALUES {DIM_ROW}"),
    ("s", "SELECT label, price, d, ts, x, u FROM dim WHERE k = 9"),
    ("s", "UPDATE dim SET price = 2.20, label = 'iota2' WHERE k = 9"),
    ("s", "SELECT label, price FROM dim WHERE k = 9"),
    ("s", "DELETE FROM dim WHERE k = 9"),
    ("s", "SELECT count(*) FROM dim WHERE k = 9"),
    ("s", "BEGIN"),
    ("s", "INSERT INTO dim VALUES (31, 'rw', 3.33, '2001-02-03', NULL, NULL, 3)"),
    ("s", "SELECT label, price FROM dim WHERE k = 31"),             # own write
    ("s", "SELECT k, label FROM dim WHERE k >= 6 ORDER BY k"),
    ("s2", "SELECT label FROM dim WHERE k = 31"),                   # not visible
    ("s", "ROLLBACK"),
    ("s", "SELECT label FROM dim WHERE k = 31"),
    ("s", "BEGIN"),
    ("s", "INSERT INTO localtab VALUES (1, 10)"),
    ("s", "INSERT INTO dim VALUES (21, 'txn', 0.10, NULL, NULL, NULL, NULL)"),
    ("s2", "SELECT v FROM localtab"),
    ("s2", "SELECT label FROM dim WHERE k = 21"),
    ("s", "COMMIT"),
    ("s2", "SELECT v FROM localtab"),
    ("s2", "SELECT label, price FROM dim WHERE k = 21"),
    ("s", "BEGIN"),
    ("s", "INSERT INTO localtab VALUES (2, 20)"),
    ("s", "INSERT INTO dim VALUES (22, 'gone', 0.20, NULL, NULL, NULL, NULL)"),
    ("s", "UPDATE dim SET label = 'changed' WHERE k = 21"),
    ("s", "ROLLBACK"),
    ("s2", "SELECT id, v FROM localtab ORDER BY id"),
    ("s2", "SELECT k, label FROM dim WHERE k >= 21 ORDER BY k"),
    ("s", "DELETE FROM dim WHERE k = 21"),
    ("s", "SELECT k, u FROM big WHERE k = 1"),
    ("s", "SELECT k, u FROM big ORDER BY k"),   # past 2^63: OverflowError in both
    ("s", "SELECT k, label FROM dim ORDER BY k"),
]


@pytest.fixture(scope="module")
def workers():
    ws = dict(zip(PACKAGES, start_all(*[(pkg, INIT_SQL, None) for pkg in PACKAGES])))
    try:
        yield ws
    finally:
        for w in ws.values():
            w.close()


def _attach(pkg, worker):
    inst, s = coordinator(pkg)
    s.execute(LOCAL_SQL)
    inst.attach_remote_table("w", "dim", *worker.addr)
    inst.attach_remote_table("w", "big", *worker.addr)
    # the coordinator keeps no statistics of a remote table: an estimate of a large
    # one puts it on the probe side of its joins, where runtime filters reach it
    inst.catalog.table("w", "dim").stats.row_count = 100_000
    return inst, s


@contextlib.contextmanager
def _recorded_fragments():
    """Record every fragment either package's WorkerClient ships (the branch xid's
    value, a txn id each engine draws itself, kept as present or not)."""
    from galaxysql_tpu.net import dn as jdn
    from galaxysql_tpu_torch.net import dn as pdn
    log = {"jax": [], "torch": []}
    saved = {}
    for pkg, mod in (("jax", jdn), ("torch", pdn)):
        orig = mod.WorkerClient.exec_plan
        saved[mod] = orig

        def rec(self, fragment, deadline=None, _orig=orig, _log=log[pkg]):
            f = dict(fragment)
            if "xid" in f:
                f["xid"] = "xid"
            _log.append(f)
            return _orig(self, fragment, deadline=deadline)
        mod.WorkerClient.exec_plan = rec
    try:
        yield log
    finally:
        for mod, orig in saved.items():
            mod.WorkerClient.exec_plan = orig


def _norm_workers(rows):
    return [("host", "port") + tuple(r[2:]) for r in rows]


def test_same_script_same_results(workers):
    sides = {pkg: _attach(pkg, workers[pkg]) for pkg in PACKAGES}
    second = {pkg: type(s)(inst, schema="w") for pkg, (inst, s) in sides.items()}
    log0 = {pkg: len(sides[pkg][0].workers[workers[pkg].addr].sync_action(
        "query_log", {})["queries"]) for pkg in PACKAGES}
    with _recorded_fragments() as frags:
        for i, (who, sql) in enumerate(SCRIPT):
            marks = {pkg: len(frags[pkg]) for pkg in PACKAGES}
            got = {}
            for pkg in PACKAGES:
                s = sides[pkg][1] if who == "s" else second[pkg]
                got[pkg] = outcome(lambda: s.execute(sql))
            assert got["torch"] == got["jax"], (i, sql, got)
            assert frags["torch"][marks["torch"]:] == frags["jax"][marks["jax"]:], \
                (i, sql)
        # the script exercised each pushdown: pruned columns, SARGs, a point key, a
        # runtime filter and a branch xid
        shipped = frags["torch"]
        assert any(f["columns"] == ["k"] for f in shipped)
        assert any(f.get("sargs") for f in shipped)
        assert any("point" in f for f in shipped)
        assert any(f.get("rf_in") for f in shipped)
        assert any(f.get("xid") for f in shipped)
    # the same fragments and statements reached each worker
    logs = {pkg: sides[pkg][0].workers[workers[pkg].addr].sync_action(
        "query_log", {})["queries"][log0[pkg]:] for pkg in PACKAGES}
    assert logs["torch"] == logs["jax"]
    assert any(q.startswith("PLAN:w.dim:") for q in logs["torch"])
    # the remote tables' dictionaries hold the same strings in the same code order
    for table in ("dim",):
        dicts = {pkg: {k: list(d.values) for k, d in
                       sides[pkg][0].catalog.table("w", table).dictionaries.items()}
                 for pkg in PACKAGES}
        assert dicts["torch"] == dicts["jax"]
    for stmt in ("SHOW WORKERS", "SELECT * FROM information_schema.workers"):
        got = {pkg: sides[pkg][1].execute(stmt) for pkg in PACKAGES}
        assert got["torch"].names == got["jax"].names
        assert _norm_workers(got["torch"].rows) == _norm_workers(got["jax"].rows)
        assert got["torch"].rows[0][:2] == ("127.0.0.1", workers["torch"].port)
    for pkg in PACKAGES:
        second[pkg].close()
        sides[pkg][1].close()


CROSS = [
    "SELECT k, label, price, d, ts, x, u FROM dim ORDER BY k",
    "SELECT k, label FROM dim WHERE k >= 3 ORDER BY k",
    "SELECT label FROM dim WHERE k = 4",
    "SELECT dim.label, sum(fact.qty) FROM fact, dim WHERE fact.k = dim.k "
    "GROUP BY dim.label ORDER BY dim.label",
    "SELECT p.id, d.label FROM probe p JOIN dim d ON p.k = d.k ORDER BY p.id",
    f"INSERT INTO dim VALUES {DIM_ROW}",
    "SELECT label, price, d, ts, x, u FROM dim WHERE k = 9",
    "BEGIN",
    "INSERT INTO localtab VALUES (7, 70)",
    "UPDATE dim SET price = 3.30 WHERE k = 9",
    "SELECT price FROM dim WHERE k = 9",
    "COMMIT",
    "SELECT l.v, d.price FROM localtab l, dim d WHERE l.id = 7 AND d.k = 9",
    "DELETE FROM dim WHERE k = 9",
    "SELECT count(*) FROM dim",
]


@pytest.mark.parametrize("coord,worker", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-coordinator-jax-worker",
                              "jax-coordinator-port-worker"])
def test_cross_package_pairs_give_equal_rows(workers, coord, worker):
    """Each coordinator runs the same statements against the other package's
    worker and against its own: the rows, counts and outcomes are equal."""
    got = {}
    for pkg in (coord, worker):
        inst, s = _attach(coord, workers[pkg])
        got[pkg] = [outcome(lambda: s.execute(sql)) for sql in CROSS]
        s.close()
    assert got[worker] == got[coord]
    assert got[worker][0][0] == "ok" and len(got[worker][0][1]) == 6


# -- the wire encode and decode, value by value against the reference -------------

def _typed(pkg, sql_name):
    if pkg == "jax":
        from galaxysql_tpu.types import datatype as dt
    else:
        from galaxysql_tpu_torch.types import datatype as dt
    return dt.from_sql_name(*sql_name)


def _wire_arrays(seed=20241018, n=400):
    """Wire arrays as a worker ships them: text for strings and dates, scaled int64
    or float64 for DECIMAL, float64 for DOUBLE, int64 bits for integers."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(40)] + ["", "ünï", "x" * 30])
    valid = rng.random(n) > 0.2
    days = rng.integers(-800, 20000, n)
    from galaxysql_tpu_torch.types import temporal
    dates = np.array([temporal.format_date(int(x)) for x in days], dtype=object).astype(str)
    us = rng.integers(-10**12, 10**15, n)
    stamps = np.array([temporal.format_datetime(int(x)) for x in us],
                      dtype=object).astype(str)
    return valid, {
        ("VARCHAR", 0, 0): words[rng.integers(0, words.size, n)],
        ("DATE", 0, 0): dates,
        ("DATETIME", 0, 0): stamps,
        ("DECIMAL", 15, 2): rng.integers(-10**13, 10**13, n).astype(np.int64),
        ("DOUBLE", 0, 0): rng.standard_normal(n) * 1e6,
        ("BIGINT", 0, 0): rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        ("BIGINT UNSIGNED", 0, 0): rng.integers(0, 2**63 - 1, n, dtype=np.int64),
    }


@pytest.mark.parametrize("with_nulls", [False, True], ids=["all-valid", "nulls"])
def test_decode_matches_the_reference_value_by_value(with_nulls):
    """`remote_column` on whole arrays gives the lanes, validity and dictionary
    codes (first-seen order, into a dictionary that already holds some of the
    strings) of the reference's per-value `column_from_pylist`."""
    from galaxysql_tpu.chunk.batch import Dictionary as JaxDictionary
    from galaxysql_tpu.chunk.batch import column_from_pylist
    from galaxysql_tpu_torch.chunk.batch import Dictionary
    from galaxysql_tpu_torch.plan.physical import remote_column
    valid, arrays = _wire_arrays()
    if not with_nulls:
        valid = np.ones_like(valid)
    seen = ["w007", "w003", "", "zzz"]
    for sql_name, arr in arrays.items():
        for scaled in ((False, True) if sql_name[0] == "DECIMAL" else (False,)):
            wire = arr if scaled or sql_name[0] != "DECIMAL" else arr / 100.0
            typ_p, typ_j = _typed("torch", sql_name), _typed("jax", sql_name)
            vals = wire.tolist()
            vals = [x if ok else None for x, ok in zip(vals, valid.tolist())]
            jd = JaxDictionary(seen) if typ_j.is_string else None
            pd_ = Dictionary(seen) if typ_p.is_string else None
            v = None if valid.all() else valid
            lane, pv, pdict = remote_column(wire, v, typ_p, pd_, scaled)
            if scaled:
                # the reference adopts a scaled lane as it is
                want_lane, want_valid = wire.astype(typ_j.lane), v
            else:
                ref = column_from_pylist(vals, typ_j, jd)
                want_lane = np.asarray(ref.data)
                want_valid = None if ref.valid is None else np.asarray(ref.valid)
            assert lane.dtype == want_lane.dtype, sql_name
            assert np.array_equal(lane, want_lane), sql_name
            assert (pv is None) == (want_valid is None), sql_name
            if pv is not None:
                assert np.array_equal(pv, want_valid), sql_name
            if typ_p.is_string:
                assert pdict.values == jd.values


def test_decode_of_bigint_unsigned_past_2_63_raises_as_the_reference():
    """Values past 2^63 arrive as negative int64 bits: the reference's decode raises
    OverflowError on the first one, and so does the port's (ROADMAP Queue 3)."""
    from galaxysql_tpu.chunk.batch import column_from_pylist
    from galaxysql_tpu_torch.plan.physical import remote_column
    wire = np.array([5, 2**63 - 1, -2**63, -1], dtype=np.int64)
    valid = np.array([True, True, False, True])
    with pytest.raises(OverflowError) as want:
        column_from_pylist([5, 2**63 - 1, None, -1], _typed("jax", ("BIGINT UNSIGNED",
                                                                    0, 0)))
    with pytest.raises(OverflowError) as got:
        remote_column(wire, valid, _typed("torch", ("BIGINT UNSIGNED", 0, 0)), None,
                      False)
    assert str(got.value) == str(want.value)


def test_wire_encode_matches_the_reference():
    """`Worker._wire_lane` (distinct values formatted once) ships the arrays,
    dtypes and type tags the reference's per-value encoder ships."""
    from galaxysql_tpu.meta.catalog import ColumnMeta as JCol
    from galaxysql_tpu.meta.catalog import TableMeta as JMeta
    from galaxysql_tpu.net.worker import Worker as JaxWorker
    from galaxysql_tpu_torch.meta.catalog import ColumnMeta, TableMeta
    from galaxysql_tpu_torch.net.worker import Worker
    rng = np.random.default_rng(7)
    n = 300
    specs = [("s", ("VARCHAR", 0, 0)), ("d", ("DATE", 0, 0)),
             ("t", ("DATETIME", 0, 0)), ("m", ("DECIMAL", 15, 2)),
             ("x", ("DOUBLE", 0, 0)), ("i", ("INT", 0, 0)),
             ("u", ("BIGINT UNSIGNED", 0, 0))]
    pm = TableMeta("w", "t", [ColumnMeta(c, _typed("torch", t)) for c, t in specs])
    jm = JMeta("w", "t", [JCol(c, _typed("jax", t)) for c, t in specs])
    for m in (pm, jm):
        for v in ("b", "a", "ccc", ""):
            m.dictionaries["s"].encode_one(v)
    lanes = {"s": rng.integers(-1, 6, n).astype(np.int32),
             "d": rng.integers(-1000, 30000, n).astype(np.int32),
             "t": rng.integers(-10**12, 10**15, n),
             "m": rng.integers(-10**9, 10**9, n),
             "x": rng.standard_normal(n),
             "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
             "u": rng.integers(0, 2**64 - 1, n, dtype=np.uint64)}
    for c, _t in specs:
        for lane in (lanes[c], lanes[c][:0]):
            got, gtag = Worker._wire_lane(pm, c, lane)
            want, wtag = JaxWorker._wire_lane(jm, c, lane)
            assert gtag == wtag and got.dtype == want.dtype, c
            assert np.array_equal(got, want), c


def test_fragment_execution_matches_the_reference():
    """Both packages' in-process workers run the same shipped fragments (the
    reference's `TestWorkerPushdown` cases and more: min/max SARGs, runtime-filter
    IN-lists, an empty IN-list, a point key, a delta read with deleted keys) and
    answer with the same headers and arrays."""
    from galaxysql_tpu.net.worker import Worker as JaxWorker
    from galaxysql_tpu.server.session import Session as JaxSession
    from galaxysql_tpu_torch.net.worker import Worker
    from galaxysql_tpu_torch.server.session import Session
    workers = {"jax": JaxWorker(), "torch": Worker(device="cpu")}
    sessions = {"jax": JaxSession, "torch": Session}
    marks = {}
    for pkg, w in workers.items():
        s = sessions[pkg](w.instance)
        s.execute("CREATE DATABASE d; USE d")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, k BIGINT, "
                  "tag VARCHAR(8), day DATE) PARTITION BY HASH(id) PARTITIONS 4")
        w.instance.store("d", "t").insert_pylists(
            {"id": list(range(1000)), "k": [i % 50 for i in range(1000)],
             "tag": [None if i % 7 == 0 else f"t{i % 13}" for i in range(1000)],
             "day": [f"1995-0{1 + i % 9}-1{i % 10}" for i in range(1000)]},
            w.instance.tso.next_timestamp())
        marks[pkg] = w.instance.tso.next_timestamp()
        s.execute("DELETE FROM t WHERE id < 20")
        s.execute("INSERT INTO t VALUES (2000, 7, 'new', '1996-01-01')")
        s.close()
    frags = [
        {"columns": ["id", "k"], "sargs": [["k", "ge", 10], ["k", "le", 12]]},
        {"columns": ["id"], "sargs": [], "rf_in": [["k", [3, 7]]]},
        {"columns": ["id"], "sargs": [], "rf_in": [["k", []]]},
        {"columns": ["id", "tag", "day"], "point": ["id", 500]},
        {"columns": ["id", "tag", "day"], "sargs": [["day", "lt", 9200]]},
        {"columns": ["id", "k", "tag"], "since": "MARK", "deleted_since_of": "id"},
    ]
    for f in frags:
        got = {}
        for pkg, w in workers.items():
            frag = dict(f, schema="d", table="t")
            if frag.get("since") == "MARK":
                frag["since"] = marks[pkg]
            hdr, arrays = w._exec_plan({"fragment": frag})
            hdr = {k: v for k, v in hdr.items() if k != "snapshot"}
            got[pkg] = (hdr, {k: (a.dtype.str, a.tolist()) for k, a in arrays.items()})
        assert got["torch"] == got["jax"], f
    assert got["torch"][0]["rows"] == 1  # the delta read: the one new row



def test_backfill_literals_match_the_reference():
    """The SQL literals a replica backfill renders from shipped wire values equal
    the reference's, its fault included: under NumPy 2 a DOUBLE value renders as
    `np.float64(0.5)`, so backfilling a table with a DOUBLE column fails with a
    syntax error in both packages (ROADMAP Queue 3)."""
    from galaxysql_tpu.server.instance import Instance as JaxInstance
    from galaxysql_tpu_torch.server.instance import Instance
    cases = [("DECIMAL(15,2)#scaled", np.int64(-5), True),
             ("DECIMAL(15,2)#scaled", np.int64(123456), True),
             ("DECIMAL(10,0)#scaled", np.int64(42), True),
             ("BIGINT", np.int64(-7), True), ("BIGINT", 7, True),
             ("DOUBLE", np.float64(0.5), True), ("DOUBLE", 0.5, True),
             ("VARCHAR", np.str_("it's \\ x"), True), ("DATE", np.str_("1995-01-02"), True),
             ("BIGINT", np.int64(1), False)]
    for typ, v, ok in cases:
        assert Instance._sql_literal(typ, v, ok) == JaxInstance._sql_literal(typ, v, ok)
    assert Instance._sql_literal("DOUBLE", np.float64(0.5), True) == "np.float64(0.5)"
