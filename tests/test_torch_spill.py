"""Disk spill and streamed scans: the port against the JAX package on the CPU.

Operator level: the same numpy-seeded batches go through both packages' `SortOp`
(the external sort: ASC/DESC, NULLs, LIMIT/OFFSET, floats, strings ranked through
an unsorted dictionary), `HashJoinOp` (the grace join: inner, left, semi, anti, a
residual, string keys from two dictionaries) and `HashAggOp`/`DistinctOp` (partial
spill with merge waves).  Rows and the spill counters `spilled_runs`,
`grace_partitions` and `spilled_partials` must be equal.

SQL level: TPC-H at SF 0.01 with `SET SORT_SPILL_BYTES` / `JOIN_SPILL_BYTES`
lowered in both engines; the port's streamed scan (its fused-row limit lowered so
every full-table scan yields one batch a partition) against the reference's fused
scan; an ORDER BY under a collation over several sorted runs.

Every case also holds the spill directory empty afterwards, and after a query that
raises mid-stream.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galaxysql_tpu.chunk import batch as jb
from galaxysql_tpu.exec import operators as jops
from galaxysql_tpu.expr import ir as jir
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.types import datatype as jdt
from galaxysql_tpu_torch.chunk import batch as pb
from galaxysql_tpu_torch.exec import operators as pops
from galaxysql_tpu_torch.exec import spill as pspill
from galaxysql_tpu_torch.expr import ir as pir
from galaxysql_tpu_torch.plan import physical
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.types import datatype as pdt
from galaxysql_tpu_torch.utils import metrics
from test_torch_dml import ap_plans

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

# the two packages' modules an operator test needs, by engine
ENGINES = {
    "jax": dict(batch=jb, ops=jops, ir=jir, dt=jdt,
                arr=lambda a: jnp.asarray(a)),
    "port": dict(batch=pb, ops=pops, ir=pir, dt=pdt,
                 arr=lambda a: torch.from_numpy(np.ascontiguousarray(a))),
}


def _type(m, typ):
    return m["dt"].varchar() if typ == "VARCHAR" else getattr(m["dt"], typ)


def _batches(eng, columns, n_rows, size, dicts=None, dead_every=0):
    """Seeded numpy columns {name: (type name, data, valid-or-None)} cut into batches
    of `size` rows for engine `eng` (a VARCHAR column's codes index the engine's
    dictionary in `dicts`); every `dead_every`-th row of a batch is dead."""
    m = ENGINES[eng]
    dicts = dicts or {}
    out = []
    for lo in range(0, n_rows, size):
        hi = min(lo + size, n_rows)
        cols = {}
        for name, (typ, data, valid) in columns.items():
            cols[name] = m["batch"].Column(
                m["arr"](data[lo:hi]), None if valid is None else m["arr"](valid[lo:hi]),
                _type(m, typ), dicts.get(name))
        live = np.ones(hi - lo, dtype=bool)
        if dead_every:
            live[::dead_every] = False
        out.append(m["batch"].ColumnBatch(cols, m["arr"](live)))
    return out


def _col(eng, name, typ="BIGINT", dictionary=None):
    m = ENGINES[eng]
    return m["ir"].ColRef(name, _type(m, typ), dictionary)


def _rows(op, names):
    """Live rows of every output batch in order, NULLs as None."""
    out = []
    for b in op.batches():
        live = b.np_live()
        cols = []
        for n in names:
            c = b.columns[n]
            d = c.np_data()[live].tolist()
            v = c.np_valid()[live].tolist()
            cols.append([x if ok else None for x, ok in zip(d, v)])
        out += list(zip(*cols))
    return out


def _spill_dir_empty():
    d = pspill.SPILL_MANAGER.directory
    return os.listdir(d) == [] and pspill.SPILL_MANAGER.used == 0


# -- external sort ------------------------------------------------------------------

def _sort_columns(kind, n, rng):
    """Key and row-id columns, and the words of the key's dictionary (strings only:
    assignment-ordered, not sorted, so the sort runs on ranks)."""
    x = ("BIGINT", np.arange(n), None)
    if kind == "int":
        return {"t.k": ("BIGINT", rng.integers(-10**9, 10**9, n), None), "t.x": x}, None
    if kind == "nulls":
        return {"t.k": ("BIGINT", rng.integers(0, 1000, n), rng.random(n) > 0.1),
                "t.x": x}, None
    if kind == "float":
        return {"t.k": ("DOUBLE", rng.normal(size=n).astype(np.float32),
                        rng.random(n) > 0.05), "t.x": x}, None
    words = [f"w{i:03d}"[::-1] for i in range(300)]
    return {"t.k": ("VARCHAR", rng.integers(0, 300, n).astype(np.int32),
                    rng.random(n) > 0.1), "t.x": x}, words


SORT_CASES = {
    # name: (kind, rows, desc, limit, offset, threshold)
    "asc_many_runs": ("int", 100_000, False, None, 0, 1 << 16),
    "desc": ("int", 50_000, True, None, 0, 1 << 16),
    "limit_offset": ("int", 60_000, False, 100, 7, 1 << 16),
    "nulls_first_asc": ("nulls", 40_000, False, None, 0, 1 << 15),
    "nulls_last_desc": ("nulls", 40_000, True, 500, 3, 1 << 15),
    "float_desc": ("float", 30_000, True, None, 0, 1 << 15),
    "strings_ranked": ("string", 30_000, False, None, 0, 1 << 15),
    "in_memory": ("int", 20_000, False, None, 0, 1 << 30),
}


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_external_sort_matches_reference(name):
    kind, n, desc, limit, offset, threshold = SORT_CASES[name]
    columns, words = _sort_columns(kind, n, np.random.default_rng(0))
    got = {}
    for eng, m in ENGINES.items():
        d = m["batch"].Dictionary(words) if words is not None else None
        batches = _batches(eng, columns, n, 8192, {"t.k": d}, dead_every=97)
        key = _col(eng, "t.k", columns["t.k"][0], d)
        # the row id breaks ties, so both engines' orders are total
        op = m["ops"].SortOp(m["ops"].SourceOp(batches),
                             [(key, desc), (_col(eng, "t.x"), False)],
                             limit=limit, offset=offset, spill_threshold=threshold)
        got[eng] = (_rows(op, ["t.k", "t.x"]), op.spilled_runs)
        assert _spill_dir_empty()
    assert got["port"] == got["jax"]
    rows, runs = got["port"]
    assert (runs == 0) == (threshold == 1 << 30)
    if name == "asc_many_runs":
        assert runs >= 4
    live = n - sum(len(range(0, min(8192, n - lo), 97)) for lo in range(0, n, 8192))
    assert len(rows) == (max(live - offset, 0) if limit is None else limit)


# -- grace hash join ----------------------------------------------------------------

def _join_sides(nb, npr, rng, dups=4):
    bkeys = np.repeat(np.arange(nb // dups), dups)
    rng.shuffle(bkeys)
    pkeys = rng.integers(0, nb // dups * 2, npr)  # about half match
    build = {"b.k": ("BIGINT", bkeys, rng.random(nb) > 0.02),
             "b.x": ("BIGINT", bkeys + 1, None)}
    probe = {"p.k": ("BIGINT", pkeys, rng.random(npr) > 0.02),
             "p.x": ("BIGINT", pkeys % 5, None)}
    return build, probe


JOIN_CASES = ["inner", "left", "semi", "anti", "inner_residual", "left_residual",
              "anti_residual"]


@pytest.mark.parametrize("case", JOIN_CASES)
def test_grace_join_matches_reference(case):
    kind = case.split("_")[0]
    build, probe = _join_sides(40_000, 30_000, np.random.default_rng(2))
    names = ["p.k", "p.x"] if kind in ("semi", "anti") else ["p.k", "p.x", "b.k", "b.x"]
    got = {}
    for eng, m in ENGINES.items():
        bschema = {"b.k": (m["dt"].BIGINT, None), "b.x": (m["dt"].BIGINT, None)}
        residual = None
        if case.endswith("residual"):
            residual = m["ir"].Call("lt", [_col(eng, "p.x"),
                                           m["ir"].Literal(3, m["dt"].BIGINT)],
                                    m["dt"].BOOL)
        out = []
        for threshold in (1 << 17, 256 << 20):
            op = m["ops"].HashJoinOp(
                m["ops"].SourceOp(_batches(eng, build, 40_000, 8192, dead_every=13)),
                m["ops"].SourceOp(_batches(eng, probe, 30_000, 8192, dead_every=11)),
                [_col(eng, "b.k")], [_col(eng, "p.k")], kind, residual=residual,
                build_schema=bschema, spill_threshold=threshold)
            out.append((sorted(_rows(op, names), key=repr), op.grace_partitions))
            assert _spill_dir_empty()
        assert out[0][0] == out[1][0]  # grace equals in memory, within the engine
        got[eng] = out
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == 16 and got["port"][1][1] == 0


def test_grace_join_translates_string_keys_across_dictionaries():
    rng = np.random.default_rng(5)
    words = [f"s{i}" for i in range(200)]
    build = {"b.s": ("VARCHAR", rng.integers(0, 200, 5000).astype(np.int32), None),
             "b.x": ("BIGINT", np.arange(5000), None)}
    # the probe's dictionary holds the words in another order, and one more
    probe = {"p.s": ("VARCHAR", rng.integers(0, 201, 7000).astype(np.int32), None)}
    got = {}
    for eng, m in ENGINES.items():
        db = m["batch"].Dictionary(words)
        dp = m["batch"].Dictionary(words[::-1] + ["only-probe"])
        op = m["ops"].HashJoinOp(
            m["ops"].SourceOp(_batches(eng, build, 5000, 1024, {"b.s": db})),
            m["ops"].SourceOp(_batches(eng, probe, 7000, 1024, {"p.s": dp})),
            [_col(eng, "b.s", "VARCHAR", db)], [_col(eng, "p.s", "VARCHAR", dp)],
            "inner", spill_threshold=1 << 12)
        got[eng] = (sorted(_rows(op, ["b.x", "p.s"])), op.grace_partitions)
        assert _spill_dir_empty()
    assert got["port"] == got["jax"]
    assert got["port"][1] == 16 and got["port"][0]


# -- aggregation partial spill ----------------------------------------------------------

AGG_CASES = {
    # name: (threshold, distinct)
    "spill_every_partial": (1, False),
    "merge_waves": (300_000, False),
    "in_memory": (256 << 20, False),
    "distinct_spill": (1, True),
    "distinct_waves": (300_000, True),
}


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_agg_spill_matches_reference(name):
    threshold, distinct = AGG_CASES[name]
    rng = np.random.default_rng(0)
    n = 12_000
    words = [f"v{i}"[::-1] for i in range(40)]
    columns = {"g": ("BIGINT", rng.integers(0, 500, n), rng.random(n) > 0.03),
               "h": ("BIGINT", rng.integers(0, 3, n), None),
               "v": ("BIGINT", rng.integers(-100, 100, n), rng.random(n) > 0.1),
               "s": ("VARCHAR", rng.integers(0, 40, n).astype(np.int32), None)}
    got = {}
    for eng, m in ENGINES.items():
        d = m["batch"].Dictionary(words)
        batches = _batches(eng, columns, n, 2000, {"s": d}, dead_every=17)
        g, h, v = _col(eng, "g"), _col(eng, "h"), _col(eng, "v")
        s = _col(eng, "s", "VARCHAR", d)
        if distinct:
            op = m["ops"].DistinctOp(m["ops"].SourceOp(batches), [("g", g), ("h", h)])
            op.spill_threshold = threshold
            names = ["g", "h"]
        else:
            A = m["ops"].AggCall
            aggs = [A("sum", v, "sv"), A("count_star", None, "c"), A("count", v, "cv"),
                    A("min", v, "mn"), A("max", s, "ms"), A("avg", v, "av")]
            op = m["ops"].HashAggOp(m["ops"].SourceOp(batches), [("g", g), ("h", h)],
                                    aggs, spill_threshold=threshold)
            names = ["g", "h", "sv", "c", "cv", "mn", "ms", "av"]
        got[eng] = (sorted(_rows(op, names), key=repr), op.spilled_partials)
        assert _spill_dir_empty()
    assert got["port"] == got["jax"]
    assert (got["port"][1] == 0) == (threshold == 256 << 20)
    if threshold == 1:
        assert got["port"][1] == 6


# -- a query that raises mid-stream leaves no spill file ------------------------------

class _Raising(pops.Operator):
    def __init__(self, batches, after):
        self._batches, self.after = batches, after

    def batches(self):
        for i, b in enumerate(self._batches):
            if i == self.after:
                raise RuntimeError("the input failed mid-stream")
            yield b


def test_error_mid_stream_leaves_no_spill_file():
    rng = np.random.default_rng(3)
    cols = {"t.k": ("BIGINT", rng.integers(0, 1000, 40_000), None),
            "t.x": ("BIGINT", np.arange(40_000), None)}
    batches = _batches("port", cols, 40_000, 4096)
    k = _col("port", "t.k")
    sort = pops.SortOp(_Raising(batches, 6), [(k, False)], spill_threshold=1 << 15)
    agg = pops.HashAggOp(_Raising(batches, 6), [("t.k", k)],
                         [pops.AggCall("count_star", None, "c")], spill_threshold=1)
    build = pops.HashJoinOp(_Raising(batches, 6), pops.SourceOp(batches), [k], [k],
                            spill_threshold=1 << 12)
    probe = pops.HashJoinOp(pops.SourceOp(batches), _Raising(batches, 6), [k], [k],
                            spill_threshold=1 << 12)
    for op in (sort, agg, build, probe):
        with pytest.raises(RuntimeError, match="mid-stream"):
            list(op.batches())
        assert _spill_dir_empty()
    assert sort.spilled_runs > 0 and agg.spilled_partials > 0
    assert build.grace_partitions == 16 and probe.grace_partitions == 16


# -- SQL: TPC-H at SF 0.01 --------------------------------------------------------------

SF = 0.01
SQL_QUERIES = (1, 3, 4, 5, 6, 10, 13, 16, 18, 21, 22)


@pytest.fixture(scope="module")
def engines():
    data = tpch.generate(SF)
    ji = JaxInstance()
    js = JaxSession(ji)
    pi = Instance(device="cpu")
    ps = Session(pi)
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
    want = {q: js.execute(QUERIES[q]).rows for q in SQL_QUERIES}
    yield js, ps, want
    js.close()
    ps.close()


def _same_rows(got, want, sql):
    if "order by" in sql.lower():
        assert got == want
    else:
        assert sorted(got, key=repr) == sorted(want, key=repr)


@pytest.mark.parametrize("q", SQL_QUERIES)
def test_tpch_with_lowered_spill_thresholds_matches_reference(q, engines):
    js, ps, want = engines
    sets = ("SET SORT_SPILL_BYTES = 65536", "SET JOIN_SPILL_BYTES = 65536")
    files0 = metrics.SPILL_FILES.value
    try:
        for s in (js, ps):
            for sql in sets:
                s.execute(sql)
        spilled_ref = js.execute(QUERIES[q]).rows
        got = ps.execute(QUERIES[q]).rows
    finally:
        for s in (js, ps):
            s.execute("SET SORT_SPILL_BYTES = 268435456")
            s.execute("SET JOIN_SPILL_BYTES = 268435456")
    _same_rows(spilled_ref, want[q], QUERIES[q])
    _same_rows(got, want[q], QUERIES[q])
    assert _spill_dir_empty()
    if q in (3, 5, 10, 13, 18, 21):  # a join build or a sort past 64 KB
        assert metrics.SPILL_FILES.value > files0
    # the setting is the session's: another session does not spill
    other = Session(ps.instance, "tpch")
    files1 = metrics.SPILL_FILES.value
    _same_rows(other.execute(QUERIES[q]).rows, want[q], QUERIES[q])
    assert metrics.SPILL_FILES.value == files1
    other.close()


@pytest.mark.parametrize("q", (1, 3, 5, 6, 13, 18))
def test_streamed_scan_matches_the_reference_fused_scan(q, engines, monkeypatch):
    js, ps, want = engines
    monkeypatch.setattr(physical, "FUSE_MAX_ROWS", 1000)
    ap_plans(monkeypatch)  # Q13 scans under 50,000 rows: TP, and no device cache
    # without the fragment cache, which would replay what earlier tests ran
    got = ps.execute("/*+TDDL:FRAGMENT_CACHE(OFF)*/ " + QUERIES[q]).rows
    _same_rows(got, want[q], QUERIES[q])
    streamed = [t for t in ps.last_trace if "streamed batches=" in t]
    assert streamed  # every table past 1,000 rows streamed a batch a partition
    lineitem = ps.instance.store("tpch", "lineitem")
    if q in (1, 6):
        assert streamed == [f"scan lineitem streamed batches="
                            f"{sum(p.num_rows > 0 for p in lineitem.partitions)}"]


def test_streamed_scan_spills_sorted_runs_under_a_collation(engines, monkeypatch):
    """ORDER BY a string under a collation, past the sort threshold, over a streamed
    scan: one sorted run a partition, merged; the reference's rows."""
    js, ps, _want = engines
    monkeypatch.setattr(physical, "FUSE_MAX_ROWS", 1000)
    sql = ("SELECT c_name, c_mktsegment, c_custkey FROM customer "
           "ORDER BY c_mktsegment COLLATE utf8mb4_general_ci DESC, c_name "
           "LIMIT 200 OFFSET 5")
    want = js.execute(sql).rows
    runs = metrics.SPILL_FILES.value
    ps.execute("SET SORT_SPILL_BYTES = 4096")
    try:
        got = ps.execute(sql).rows
    finally:
        ps.execute("SET SORT_SPILL_BYTES = 268435456")
    assert got == want
    assert metrics.SPILL_FILES.value - runs >= 2
    assert _spill_dir_empty()
