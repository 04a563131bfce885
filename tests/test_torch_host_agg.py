"""The reference's host aggregate output: the port against the JAX package on the CPU.

The reference finalizes every aggregate on the host (`HashAggOp._finalize` builds
numpy lanes), so its output is a host batch, and a HAVING or a projection above an
aggregate of at most `TP_HOST_ROWS` groups runs the numpy backend in float64; a
larger output, and the input of every other operator, goes back onto the device.
The port's `_finalize` returns the same host batch (CPU tensors, `ColumnBatch.host`
naming the device they came from).  Held here:

- the two statements that showed the fault, against the reference's values;
- a corpus mixing exact and float work over aggregates (HAVING over float SUM and
  AVG, `SUM / 3`, `AVG * 3`, global aggregates, DISTINCT, an aggregate feeding a join
  build, UNION of aggregates, a GROUP BY past `TP_HOST_ROWS` groups) in four modes:
  as is; under `formulation_scope("sort")`, against the reference's TPU branch run
  in a fresh process (`prefer_scatter` patched there), for the statements whose
  aggregates are exact there (a float SUM of `sort_groupby` is a difference of
  running sums, held within a bound by `tests/test_torch_formulations.py`); under
  `ENGINE(MPP)` on an 8-shard mesh, where the reference's stage programs take the
  finalize's lanes into jnp (float32) and the port's onto the shard device; and with
  the aggregation spill threshold at 64 KiB, where the aggregation must spill.
  Rows are equal, floats bit for bit;
- the host-ness audit: each operator of a statement's tree, in both packages, with
  every batch it yields recorded as (host batch?, capacity: the port's nominal
  capacity, `ColumnBatch.nominal`, where a join's buffer is tighter) and, for
  Filter, Project and fused segments, whether they ran numpy.  The sequences are equal, operator by
  operator, over the corpus and the 22 TPC-H queries at SF 0.01.  The reference's
  CPU-backend native hash join (not ported: ROADMAP "Not queued") yields numpy
  batches on the CPU only, where its accelerator path yields device batches; the
  audit runs the reference with its native library off, so its joins take the
  accelerator path the port models;
- Queue 3 item 10, shared with the reference: integer lanes wrap and a join on a
  pure inequality raises, in both packages.
"""

import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np
import pytest
import torch

from galaxysql_tpu import native as jax_native
from galaxysql_tpu.exec import operators as jax_ops
from galaxysql_tpu.plan import physical as jax_physical
from galaxysql_tpu.server import session as jax_session_mod
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu_torch.chunk.batch import HOST_TIER_STATS
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.kernels import relational as K
from galaxysql_tpu_torch.parallel.mesh import make_mesh
from galaxysql_tpu_torch.plan import physical as port_physical
from galaxysql_tpu_torch.server import session as port_session_mod
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDE_ROWS = 70_000  # distinct keys: the GROUP BY's output is past TP_HOST_ROWS

SETUP = [
    "CREATE DATABASE d", "USE d",
    "CREATE TABLE t (id INT PRIMARY KEY, a INT, f DOUBLE)",
    "INSERT INTO t VALUES (1, 10, 0.1), (2, 7, 0.2)",
    "CREATE TABLE s (id INT PRIMARY KEY, a INT, g DOUBLE, q DECIMAL(12,2), "
    "name VARCHAR(8)) PARTITION BY HASH(id) PARTITIONS 3",
    "INSERT INTO s VALUES " + ", ".join(
        f"({i}, {i % 7}, {(i % 11) / 10}, {i * 1.25}, '{'xyz'[i % 3]}{i % 5}')"
        for i in range(1, 61)),
    "INSERT INTO s VALUES (61, NULL, NULL, NULL, NULL)",
    "CREATE TABLE wide (k INT PRIMARY KEY, f DOUBLE)",
]


def setup_session(s):
    """The corpus's tables through one session of either package."""
    for sql in SETUP:
        s.execute(sql)
    k = np.arange(1, WIDE_ROWS + 1)
    inst = s.instance
    inst.store("d", "wide").insert_arrays({"k": k, "f": (k % 10) / 10.0},
                                          inst.tso.next_timestamp())


# The fault's statements and the reference's answers (ROADMAP Queue 3 item 18)
ITEM18 = {
    "sum_div": ("SELECT SUM(f) / 3 FROM t", [(0.10000000397364299,)]),
    "having": ("SELECT a, COUNT(*) FROM t GROUP BY a HAVING SUM(f) > 0.1",
               [(7, 1), (10, 1)]),
}

# Statements with a float SUM or AVG: equal bit for bit on the scatter branch only
FLOAT_CASES = {
    "item18_sum_div": ITEM18["sum_div"][0],
    "item18_having": ITEM18["having"][0] + " ORDER BY a",
    "having_float_sum": "SELECT a, COUNT(*) FROM s GROUP BY a HAVING SUM(g) > 2.1 "
                        "ORDER BY a",
    "having_float_avg": "SELECT a, AVG(g) FROM s GROUP BY a HAVING AVG(g) <= 0.5 "
                        "ORDER BY a",
    "sum_div_avg_mul": "SELECT a, SUM(g) / 3, AVG(g) * 3 FROM s GROUP BY a ORDER BY a",
    "global_float": "SELECT SUM(g) / 3, AVG(g) * 3, COUNT(*) * 0.1 FROM s",
    "union_of_aggregates": "SELECT x * 3 FROM (SELECT SUM(g) AS x FROM s WHERE a < 3 "
                           "UNION ALL SELECT AVG(f) FROM t) v ORDER BY 1",
    "aggregate_feeds_join_build": "SELECT s.id, v.x FROM s JOIN (SELECT a, SUM(g) / 3 "
                                  "AS x FROM s GROUP BY a HAVING SUM(g) > 2) v "
                                  "ON s.a = v.a WHERE s.id < 15 ORDER BY s.id",
    # the join's buffer counts the probe rows after the WHERE, the reference's before:
    # the GROUP BY's slots, and with them numpy or device above, are the reference's
    "join_under_where_feeds_group_by": "SELECT a.k, SUM(a.f) / 3 FROM wide a JOIN "
                                       "wide c ON a.k = c.k WHERE a.f < 0.15 AND "
                                       "c.f > 0.05 GROUP BY a.k HAVING SUM(a.f) > 0.05 "
                                       "ORDER BY a.k LIMIT 12",
    "past_tp_host_rows": "SELECT k, SUM(f) / 3 FROM wide GROUP BY k "
                         "HAVING SUM(f) > 0.85 ORDER BY k LIMIT 10",
    "grouped_wide_float": "SELECT k % 1000 AS b, SUM(f) / 3 FROM wide GROUP BY k % 1000 "
                          "HAVING SUM(f) > 62 ORDER BY b LIMIT 12",
}

# Statements whose aggregates are exact in every formulation
EXACT_CASES = {
    "having_int_avg": "SELECT a, AVG(id) * 3 FROM s GROUP BY a HAVING AVG(id) > 30.5 "
                      "ORDER BY a",
    "decimal_avg": "SELECT a, AVG(q), SUM(q) / 7 FROM s GROUP BY a ORDER BY a",
    "minmax_float": "SELECT a, MAX(g) / 3, MIN(g) * 3 FROM s GROUP BY a "
                    "HAVING MAX(g) > 0.5 ORDER BY a",
    "global_exact": "SELECT COUNT(*) / 7, SUM(id) / 3, MAX(g) * 3 FROM s",
    "global_empty": "SELECT COUNT(*), SUM(id) / 3, MAX(g) FROM s WHERE id > 1000",
    "distinct_then_float": "SELECT x / 3 FROM (SELECT DISTINCT g AS x FROM s) v "
                           "ORDER BY 1",
    "select_distinct": "SELECT DISTINCT a * 0.1 FROM s ORDER BY 1",
    "union_distinct_of_aggregates": "SELECT a, m / 3 FROM (SELECT a, MAX(g) AS m FROM s "
                                    "GROUP BY a UNION SELECT a, MAX(f) FROM t "
                                    "GROUP BY a) v ORDER BY a, 2",
    "aggregate_feeds_join_build_exact": "SELECT s.id, v.m FROM s JOIN (SELECT a, "
                                        "MAX(g) / 3 AS m FROM s GROUP BY a) v "
                                        "ON s.a = v.a WHERE s.id < 12 ORDER BY s.id",
    "past_tp_host_rows_exact": "SELECT k, MAX(f) / 3 FROM wide GROUP BY k "
                               "HAVING MAX(f) > 0.85 ORDER BY k LIMIT 10",
    "grouped_wide_exact": "SELECT k % 1000 AS b, MAX(f) / 3, COUNT(*) * 0.5 FROM wide "
                          "GROUP BY k % 1000 HAVING COUNT(*) > 69 ORDER BY b LIMIT 12",
    "string_minmax": "SELECT a, MIN(name), MAX(name) FROM s GROUP BY a ORDER BY a",
    # the audit's other boundaries: a float conjunct beside a scalar subquery stays
    # above the scalar cross, whose output is a device batch; over a plain cross that
    # the port makes an equi join (TPC-H Q15's shape), it runs above that join, on the
    # device too; an anti join with an empty build passes a host probe batch through
    "float_conjunct_below_scalar_cross": "SELECT id FROM s WHERE g * 3 > 0.3 AND "
                                         "a >= (SELECT MIN(a) FROM t) - 4 ORDER BY id",
    "float_conjunct_over_equi_cross": "SELECT s.id, s.g * 3 FROM s, t WHERE "
                                      "s.a + 3 = t.a AND s.g * 3 > 0.3 AND t.f >= "
                                      "(SELECT MIN(f) FROM t) ORDER BY s.id",
    "anti_join_empty_build": "SELECT id, g * 3 FROM s WHERE id NOT IN "
                             "(SELECT id FROM t WHERE id > 100) ORDER BY id",
}

CASES = {**FLOAT_CASES, **EXACT_CASES}
NO_CACHE = "/*+TDDL:FRAGMENT_CACHE(OFF)*/ "  # every run executes its operators
MPP = "/*+TDDL:FRAGMENT_CACHE(OFF) ENGINE(MPP)*/ "
SPILL_BYTES = 64 << 10
# the statements whose aggregation spills at SPILL_BYTES (its partials pass it)
SPILL_CASES = ["past_tp_host_rows", "grouped_wide_float", "past_tp_host_rows_exact",
               "grouped_wide_exact"]


# -- the host-ness audit --------------------------------------------------------------

def _children(op) -> List:
    out = []
    for name in sorted(vars(op)):
        v = vars(op)[name]
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if callable(getattr(x, "batches", None)):
                out.append(x)
    return out


def _walk(op, out):
    out.append(op)
    for c in _children(op):
        _walk(c, out)
    return out


NUMPY_OPS = ("FilterOp", "ProjectOp", "FusedPipelineOp")


class Audit:
    """Wraps every operator of each tree a session builds: each batch an operator
    yields is recorded as (host batch?, capacity), and for Filter, Project and fused
    segments the output's host-ness says whether they ran numpy (their numpy branch
    keeps the mark, the device branch drops it)."""

    def __init__(self, monkeypatch, session_mod, is_host, capacity):
        self.trees = []
        self.is_host = is_host
        self.capacity = capacity
        real = session_mod.build_operator

        def build(node, ctx):
            root = real(node, ctx)
            self.trees.append([self._wrap(op) for op in _walk(root, [])])
            return root
        monkeypatch.setattr(session_mod, "build_operator", build)

    def _wrap(self, op):
        rec = {"op": type(op).__name__, "batches": [], "obj": op}
        inner = op.batches

        def batches():
            for b in inner():
                rec["batches"].append((bool(self.is_host(b)), int(self.capacity(b))))
                yield b
        op.batches = batches
        return rec

    def sequence(self):
        """One entry an operator, pre-order: (name, batches, ran numpy or None).  The
        span-tracing wrapper, which the flight recorder puts around the first run of
        a digest, passes its batches through and is left out."""
        out = []
        for tree in self.trees:
            for r in tree:
                if r["op"] == "TraceOp":
                    continue
                numpy_ran = tuple(h for h, _c in r["batches"]) \
                    if r["op"] in NUMPY_OPS else None
                out.append((r["op"], tuple(r["batches"]), numpy_ran))
        return out

    def spilled(self):
        return [getattr(r["obj"], "spilled_partials", 0) for tree in self.trees
                for r in tree if r["op"] in ("HashAggOp", "DistinctOp")]


def jax_audit(monkeypatch):
    return Audit(monkeypatch, jax_session_mod, jax_ops._is_host_batch,
                 lambda b: b.capacity)


def port_audit(monkeypatch):
    """The port's batches with their nominal capacity: a join's pair buffer is sized
    from the probe rows after its prelude, and stands for the reference's."""
    return Audit(monkeypatch, port_session_mod, lambda b: b.host is not None,
                 lambda b: b.nominal_capacity)


def spill_contexts(monkeypatch, threshold=SPILL_BYTES):
    """Both packages' execution contexts with the aggregation spill threshold at
    `threshold` (a context field, no SET)."""
    for cls in (jax_physical.ExecContext, port_physical.ExecContext):
        real = cls.__init__

        def init(self, *a, _real=real, **kw):
            _real(self, *a, **kw)
            self.agg_spill_bytes = threshold
        monkeypatch.setattr(cls, "__init__", init)


# -- fixtures ---------------------------------------------------------------------------

def _jax_instance():
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


@pytest.fixture(scope="module")
def pair():
    js = JaxSession(_jax_instance())
    pi = Instance(device="cpu")
    pi._mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    ps = Session(pi)
    for s in (js, ps):
        setup_session(s)
    yield js, ps
    js.close()
    ps.close()


def _rows(s, sql):
    r = s.execute(sql)
    return r.rows


# -- the fault's statements ----------------------------------------------------------

@pytest.mark.parametrize("case", sorted(ITEM18))
def test_item18_statements_give_the_reference_values(pair, case):
    js, ps = pair
    sql, want = ITEM18[case]
    assert _rows(js, sql) == want
    assert _rows(ps, sql) == want


@pytest.fixture(scope="module")
def chip_pair():
    """`chip_smoke.py`'s host_agg tables through both packages on the CPU."""
    import chip_smoke
    js, ps = JaxSession(_jax_instance()), Session(Instance(device="cpu"))
    for s in (js, ps):
        for sql in chip_smoke.HOST_AGG_SETUP:
            s.execute(sql)
    yield chip_smoke, js, ps
    js.close()
    ps.close()


def test_chip_smoke_literals_are_the_reference(chip_pair):
    """The host_agg phase holds the card to literals: the reference gives them, and
    the port gives the reference's rows for every statement of the phase."""
    chip_smoke, js, ps = chip_pair
    for sql, want in chip_smoke.HOST_AGG_STATEMENTS.items():
        assert _rows(js, sql) == want, sql
        assert _rows(ps, sql) == want, sql
    for sql in chip_smoke.HOST_AGG_CPU_HELD:
        assert _rows(ps, sql) == _rows(js, sql), sql


def test_aggregate_output_is_a_host_batch(pair):
    _js, ps = pair
    rs = ps.execute("SELECT SUM(f) / 3 FROM t")
    assert rs.batch.host == torch.device("cpu")
    col = rs.batch.columns[next(iter(rs.batch.columns))]
    assert col.data.dtype == torch.float64


# -- the corpus --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_corpus_equals_the_reference(pair, case):
    js, ps = pair
    sql = NO_CACHE + CASES[case]
    want = _rows(js, sql)
    assert want
    assert _rows(ps, sql) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_corpus_under_mpp_equals_the_reference(pair, case):
    """Under ENGINE(MPP) the reference's stage programs take the finalize's numpy
    lanes into jnp: nothing above an MPP aggregate computes with numpy, and the port's
    stages run on the shard device."""
    js, ps = pair
    sql = MPP + CASES[case]
    want = _rows(js, sql)
    runs = HOST_TIER_STATS["numpy_runs"]
    got = _rows(ps, sql)
    assert got == want
    assert [t for t in ps.last_trace if t.startswith("mpp-fallback")] == \
        [t for t in js.last_trace if t.startswith("mpp-fallback")]
    if not any(t.startswith("mpp-fallback") for t in ps.last_trace):
        assert HOST_TIER_STATS["numpy_runs"] == runs


@pytest.mark.parametrize("case", sorted(SPILL_CASES))
def test_corpus_with_agg_spill_equals_the_reference(pair, case, monkeypatch):
    js, ps = pair
    spill_contexts(monkeypatch)
    ja, pa = jax_audit(monkeypatch), port_audit(monkeypatch)
    sql = NO_CACHE + CASES[case]
    want = _rows(js, sql)
    assert _rows(ps, sql) == want
    assert any(ja.spilled()) and any(pa.spilled())
    assert pa.sequence() == ja.sequence()


def _audit_pair(pair, monkeypatch, sql):
    """Rows and audit sequences of `sql` in both packages: the reference's joins on
    its accelerator path (native library off), the port's filters over a cross join
    as planned (its `_through_cross` rewrite, TPC-H Q15's workaround, off: the
    reference has no such operators)."""
    js, ps = pair
    monkeypatch.setattr(jax_native, "AVAILABLE", False)
    monkeypatch.setattr(port_physical, "_through_cross", lambda node: None)
    ja, pa = jax_audit(monkeypatch), port_audit(monkeypatch)
    want = _rows(js, sql)
    got = _rows(ps, sql)
    return want, got, ja.sequence(), pa.sequence()


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_ness_audit_over_the_corpus(pair, case, monkeypatch):
    want, got, jseq, pseq = _audit_pair(pair, monkeypatch, NO_CACHE + CASES[case])
    assert got == want
    assert pseq == jseq


def test_join_buffer_counts_the_rows_after_the_prelude(pair, monkeypatch):
    """The join's pairs fill a buffer sized from the probe rows its prelude keeps;
    the batch stands for the reference's larger one through its nominal capacity."""
    js, ps = pair
    seen = []
    real = ops.HashJoinOp.batches

    def batches(self):
        for b in real(self):
            seen.append((b.capacity, b.nominal_capacity))
            yield b
    monkeypatch.setattr(ops.HashJoinOp, "batches", batches)
    sql = NO_CACHE + CASES["join_under_where_feeds_group_by"]
    assert _rows(ps, sql) == _rows(js, sql)
    assert seen and all(c <= n for c, n in seen)
    assert any(c < n for c, n in seen)


def test_equi_cross_rewrite_keeps_the_reference_numpy_runs(pair, monkeypatch):
    """With the port's rewrite of a filter over a scalar and a plain cross (TPC-H
    Q15's shape) on, the float conjunct runs above the equi join on the device, and
    the statement takes the numpy branch as often as the reference's does."""
    js, ps = pair
    sql = NO_CACHE + CASES["float_conjunct_over_equi_cross"]
    real = port_physical._through_cross
    fired = []

    def through_cross(node):
        out = real(node)
        fired.append(out is not None)
        return out
    monkeypatch.setattr(port_physical, "_through_cross", through_cross)
    ja = jax_audit(monkeypatch)
    want = _rows(js, sql)
    runs = HOST_TIER_STATS["numpy_runs"]
    assert _rows(ps, sql) == want
    assert any(fired)
    ref_runs = sum(sum(ran) for _op, _b, ran in ja.sequence() if ran is not None)
    assert HOST_TIER_STATS["numpy_runs"] - runs == ref_runs


def test_host_tier_counters(pair):
    """The finalize's pull, the return of an output past TP_HOST_ROWS to the device
    and the numpy runs above a small output are counted."""
    _js, ps = pair

    def delta(sql):
        before = dict(HOST_TIER_STATS)
        ps.execute(NO_CACHE + sql)
        return {k: HOST_TIER_STATS[k] - before[k] for k in before}
    past = delta(CASES["past_tp_host_rows"])
    # 131,072 slots of the key (int32, no validity: a primary key), the SUM (float32
    # and its validity) and the live mask
    assert past["pull_bytes"] == 131_072 * (4 + 4 + 1 + 1)
    assert past["push_bytes"] > 0 and past["numpy_runs"] == 0
    small = delta(CASES["item18_having"])
    assert small["pull_bytes"] > 0 and small["numpy_runs"] == 1


# -- the sort branch -----------------------------------------------------------------

_JAX_TPU_BRANCH = r"""
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import pytest
from galaxysql_tpu.kernels import relational as R
R.prefer_scatter = lambda: False  # the reference's TPU branch, in this process only
import test_torch_host_agg as H
js = H.JaxSession(H._jax_instance())
H.setup_session(js)
out = {}
for case, sql in H.EXACT_CASES.items():
    with pytest.MonkeyPatch.context() as mp:
        audit = H.jax_audit(mp)
        rows = js.execute(H.NO_CACHE + sql).rows
        out[case] = {"rows": rows, "seq": audit.sequence()}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_tpu_branch(tmp_path_factory):
    """The exact corpus through the reference's TPU branch, in a fresh process (no
    jit cache built under one branch answers for the other)."""
    path = str(tmp_path_factory.mktemp("jax_tpu_branch") / "out.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _JAX_TPU_BRANCH, ROOT, path], check=True,
                   env=env, timeout=600, cwd=ROOT)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_sort_branch_equals_the_reference_tpu_branch(pair, case, jax_tpu_branch,
                                                     monkeypatch):
    _js, ps = pair
    monkeypatch.setattr(port_physical, "_through_cross", lambda node: None)
    pa = port_audit(monkeypatch)
    with K.formulation_scope("sort"):
        got = _rows(ps, NO_CACHE + EXACT_CASES[case])
    want = jax_tpu_branch[case]
    assert got == [tuple(r) for r in want["rows"]]
    assert json.loads(json.dumps(pa.sequence())) == want["seq"]


# -- the 22 TPC-H queries --------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(0.01)
    ji = _jax_instance()
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
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("q", range(1, 23))
def test_host_ness_audit_over_tpch(tpch_pair, q, monkeypatch):
    want, got, jseq, pseq = _audit_pair(tpch_pair, monkeypatch, NO_CACHE + QUERIES[q])
    assert got == want
    assert pseq == jseq
    assert any(r[0] == "HashAggOp" for r in pseq)


# -- Queue 3 item 10, shared with the reference -------------------------------------------

ITEM10_SETUP = [
    "CREATE DATABASE i10", "USE i10",
    "CREATE TABLE w (id INT PRIMARY KEY, a INT, u TINYINT)",
    "INSERT INTO w VALUES (1, 2000000000, -128)",
    "CREATE TABLE l (id INT PRIMARY KEY, k INT)",
    "CREATE TABLE r (id INT PRIMARY KEY, k INT)",
    "INSERT INTO l VALUES (1, 1), (2, 5), (4, 9)",
    "INSERT INTO r VALUES (1, 3), (2, 7)",
]

# name: (statement, the answer of both, or the exception each package raises)
ITEM10 = {
    "int_sum_wraps": ("SELECT a + a FROM w", [(-294967296,)]),
    "tinyint_negation_wraps": ("SELECT -u FROM w", [(-128,)]),
    "inequality_join_raises": ("SELECT l.id, r.id FROM l JOIN r ON l.k < r.k",
                               (AttributeError, IndexError)),
    "or_join_raises": ("SELECT l.id, r.id FROM l JOIN r ON l.k = r.k OR l.id = 4",
                       (AttributeError, IndexError)),
}


@pytest.fixture(scope="module")
def item10_pair():
    js, ps = JaxSession(_jax_instance()), Session(Instance(device="cpu"))
    for s in (js, ps):
        for sql in ITEM10_SETUP:
            s.execute(sql)
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("case", sorted(ITEM10))
def test_item10_behaves_as_the_reference(item10_pair, case):
    """Integer arithmetic between columns wraps at the lane width, and a join with no
    equi key raises: the reference in `native/__init__.py`, the port in
    `kernels/cuda_join.py` (ROADMAP Queue 3 item 10; neither behaviour changed)."""
    js, ps = item10_pair
    sql, want = ITEM10[case]
    if isinstance(want, list):
        assert _rows(js, sql) == want
        assert _rows(ps, sql) == want
        return
    ref_exc, port_exc = want
    with pytest.raises(ref_exc):
        js.execute(sql)
    with pytest.raises(port_exc):
        ps.execute(sql)
