"""Pipeline segment fusion (`exec/fusion.py`) in the port, against the JAX package on
the CPU.

The reference's own cases (`tests/test_fusion.py`) on numpy-seeded batches: a fused
filter/project chain, an aggregation prelude and a join-probe prelude (device and
grace-spill paths) give the rows of the port's operators run one by one and the rows
of the reference's fused operators; passthrough columns are the input's own tensors;
segment spans record the chain and its rows.  Then SQL: TPC-H at SF 0.01 fused equals
the port under NO_FUSE equals the reference (fused), and streamed scans past a lowered
`FUSE_MAX_ROWS` run every partition's batch through the segment and its runtime
filter.

Left out, because a port segment is an eager composition of closures with nothing
compiled: the reference's `global_jit` LRU and built-flag cases, its lifted-literal
"one program for every value" case (a port segment's key bakes literal values in, as
the operators' `closure_cache` keys do), its dispatch counters, and the MPP, SSB and
TPC-DS fused-vs-unfused classes (MPP is ROADMAP Queue 1 item 15; the TPC-DS subset runs
fused at the defaults in `tests/test_torch_tpcds.py`)."""

import numpy as np
import pytest
import torch

from galaxysql_tpu.chunk import batch as jax_batch
from galaxysql_tpu.exec import fusion as jax_fusion
from galaxysql_tpu.exec import operators as jax_ops
from galaxysql_tpu.expr import ir as jax_ir
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import tpch
from galaxysql_tpu.storage.tpch_queries import QUERIES
from galaxysql_tpu.types import datatype as jax_dt
from galaxysql_tpu_torch.chunk import batch as port_batch
from galaxysql_tpu_torch.exec import fusion
from galaxysql_tpu_torch.exec import operators as ops
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan import physical
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.types import datatype as dt

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

N = 400


def _data(n=N, seed=3):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 1000, n).tolist(),
            "b": np.round(rng.normal(0, 50, n), 2).tolist(),
            "s": [("x", "y", "z")[i] for i in rng.integers(0, 3, n)]}


def _batches(data):
    """The same rows as a reference batch and a port batch."""
    jb = jax_batch.batch_from_pydict(
        data, {"a": jax_dt.BIGINT, "b": jax_dt.DOUBLE, "s": jax_dt.VARCHAR})
    pb = port_batch.batch_from_pydict(data, {"a": dt.BIGINT, "b": dt.DOUBLE,
                                             "s": dt.VARCHAR})
    return jb, pb


def _stages(irm, dtm, b, lim=600):
    """WHERE a < lim, then SELECT b * 2 AS c, a, s (the reference's
    `seg_filter_project`)."""
    def col(name):
        c = b.columns[name]
        return irm.ColRef(name, c.dtype, c.dictionary)
    pred = irm.call("lt", col("a"), irm.lit(lim))
    projs = [("c", irm.call("mul", col("b"), irm.lit(2.0))), ("a", col("a")),
             ("s", col("s"))]
    return pred, projs


def _rows(batch):
    return sorted(batch.compact().to_pylist(), key=repr)


def test_fused_matches_unfused_chain_and_the_reference():
    jb, pb = _batches(_data())
    pred, projs = _stages(ir, dt, pb)
    unfused = ops.run_to_batch(ops.ProjectOp(ops.FilterOp(ops.SourceOp([pb]), pred),
                                             projs))
    fused = ops.run_to_batch(fusion.FusedPipelineOp(
        ops.SourceOp([pb]), fusion.FusedSegment([("filter", pred),
                                                 ("project", projs)])))
    jpred, jprojs = _stages(jax_ir, jax_dt, jb)
    ref = jax_ops.run_to_batch(jax_fusion.FusedPipelineOp(
        jax_ops.SourceOp([jb]), jax_fusion.FusedSegment([("filter", jpred),
                                                         ("project", jprojs)])))
    assert _rows(fused) == _rows(unfused) == sorted(ref.compact().to_pylist(), key=repr)
    assert fused.num_live() == sum(a < 600 for a in _data()["a"])


def test_passthrough_columns_zero_copy():
    _jb, pb = _batches(_data())
    pred, projs = _stages(ir, dt, pb)
    seg = fusion.FusedSegment([("filter", pred), ("project", projs)])
    out = seg.run_batch(pb)
    assert out.columns["a"].data is pb.columns["a"].data
    assert out.columns["s"].data is pb.columns["s"].data
    assert seg.computed == ["c"]


def test_filter_only_segment_returns_mask_only():
    _jb, pb = _batches({"a": list(range(200)), "b": [0.5] * 200, "s": ["x"] * 200})
    seg = fusion.FusedSegment([("filter", ir.call("lt", ir.ColRef("a", dt.BIGINT, None),
                                                  ir.lit(42)))])
    out = seg.run_batch(pb)
    assert out.num_live() == 42
    for name in pb.columns:
        assert out.columns[name].data is pb.columns[name].data


def test_rename_chain_stays_passthrough():
    _jb, pb = _batches(_data(100))
    st1 = ("project", [("x", ir.ColRef("a", dt.BIGINT, None)),
                       ("b", ir.ColRef("b", dt.DOUBLE, None))])
    st2 = ("project", [("y", ir.ColRef("x", dt.BIGINT, None)),
                       ("z", ir.call("add", ir.ColRef("x", dt.BIGINT, None), ir.lit(1)))])
    seg = fusion.FusedSegment([st1, st2])
    assert seg.alias["y"] == "a" and seg.alias["z"] is None
    out = seg.run_batch(pb)
    assert out.columns["y"].data is pb.columns["a"].data
    assert np.array_equal(out.columns["z"].np_data(), np.asarray(_data(100)["a"]) + 1)


def test_segment_key_is_structural_and_bakes_literals():
    """Equal chains share one composed closure; another literal value is another
    key (nothing is lifted: nothing is compiled)."""
    _jb, pb = _batches(_data())
    keys = {fusion.FusedSegment([("filter", _stages(ir, dt, pb, lim)[0])]).key()
            for lim in (10, 10, 50)}
    assert len(keys) == 2


@pytest.mark.parametrize("fuse", [False, True])
def test_agg_prelude_matches_stacked_operators_and_the_reference(fuse):
    jb, pb = _batches(_data())
    pred, projs = _stages(ir, dt, pb, lim=700)
    groups = [("s", ir.ColRef("s", dt.VARCHAR, pb.columns["s"].dictionary))]
    aggs = [ops.AggCall("sum", ir.ColRef("c", dt.DOUBLE, None), "sc"),
            ops.AggCall("count_star", None, "n"),
            ops.AggCall("max", ir.ColRef("a", dt.BIGINT, None), "ma")]
    if fuse:
        seg = fusion.FusedSegment([("filter", pred), ("project", projs)])
        got = ops.run_to_batch(ops.HashAggOp(ops.SourceOp([pb]), groups, aggs,
                                             prelude=seg))
    else:
        got = ops.run_to_batch(ops.HashAggOp(
            ops.ProjectOp(ops.FilterOp(ops.SourceOp([pb]), pred), projs), groups, aggs))
    jpred, jprojs = _stages(jax_ir, jax_dt, jb, lim=700)
    jgroups = [("s", jax_ir.ColRef("s", jax_dt.VARCHAR, jb.columns["s"].dictionary))]
    jaggs = [jax_ops.AggCall("sum", jax_ir.ColRef("c", jax_dt.DOUBLE, None), "sc"),
             jax_ops.AggCall("count_star", None, "n"),
             jax_ops.AggCall("max", jax_ir.ColRef("a", jax_dt.BIGINT, None), "ma")]
    ref = jax_ops.run_to_batch(jax_ops.HashAggOp(
        jax_ops.SourceOp([jb]), jgroups, jaggs,
        prelude=jax_fusion.FusedSegment([("filter", jpred), ("project", jprojs)])))
    want = sorted(ref.compact().to_pylist())
    have = sorted(got.compact().to_pylist())
    assert [(r[0], r[2], r[3]) for r in have] == [(r[0], r[2], r[3]) for r in want]
    # float32 sums of the same rows; the order of the additions is each engine's own
    np.testing.assert_allclose([r[1] for r in have], [r[1] for r in want], rtol=1e-5)


def test_collapse_streaming_chain_and_the_cross_stop():
    scan = L.Values([], [])
    pred = ir.call("lt", ir.ColRef("a", dt.BIGINT, None), ir.lit(5))
    node = L.Project(L.Filter(scan, pred), [("a", ir.ColRef("a", dt.BIGINT, None))])
    stages, base = fusion.collapse_streaming_chain(node)
    assert [k for k, _ in stages] == ["filter", "project"] and base is scan
    assert fusion.chain_nodes(node) == [node.child, node]
    stages, base = fusion.collapse_streaming_chain(
        node, stop=lambda n: isinstance(n, L.Filter))
    assert [k for k, _ in stages] == ["project"] and base is node.child


# -- the join-probe prelude ------------------------------------------------------------

def _join_sides(data):
    jb, pb = _batches(data)
    bdata = {"k": [i * 3 for i in range(60)], "v": [float(i) for i in range(60)]}
    jbuild = jax_batch.batch_from_pydict(bdata, {"k": jax_dt.BIGINT, "v": jax_dt.DOUBLE})
    pbuild = port_batch.batch_from_pydict(bdata, {"k": dt.BIGINT, "v": dt.DOUBLE})
    return (jbuild, jb), (pbuild, pb)


@pytest.mark.parametrize("path", ["device", "grace_spill"])
def test_probe_prelude_matches_filter_and_the_reference(path):
    spill = 1 if path == "grace_spill" else 1 << 62
    data = {"a": list(range(N)), "b": [0.25 * i for i in range(N)],
            "s": ["x" if i % 2 else "y" for i in range(N)]}
    (jbuild, jprobe), (build, probe) = _join_sides(data)
    pred = ir.call("lt", ir.ColRef("a", dt.BIGINT, None), ir.lit(200))
    bk, pk = [ir.ColRef("k", dt.BIGINT, None)], [ir.ColRef("a", dt.BIGINT, None)]
    unfused = ops.run_to_batch(ops.HashJoinOp(
        ops.SourceOp([build]), ops.FilterOp(ops.SourceOp([probe]), pred), bk, pk,
        "inner", spill_threshold=spill))
    op = ops.HashJoinOp(ops.SourceOp([build]), ops.SourceOp([probe]), bk, pk, "inner",
                        spill_threshold=spill,
                        probe_prelude=fusion.FusedSegment([("filter", pred)]))
    fused = ops.run_to_batch(op)
    assert (op.grace_partitions > 0) == (path == "grace_spill")
    jpred = jax_ir.call("lt", jax_ir.ColRef("a", jax_dt.BIGINT, None), jax_ir.lit(200))
    ref = jax_ops.run_to_batch(jax_ops.HashJoinOp(
        jax_ops.SourceOp([jbuild]), jax_ops.SourceOp([jprobe]),
        [jax_ir.ColRef("k", jax_dt.BIGINT, None)],
        [jax_ir.ColRef("a", jax_dt.BIGINT, None)], "inner", spill_threshold=spill,
        probe_prelude=jax_fusion.FusedSegment([("filter", jpred)])))
    names = sorted(fused.columns)

    def rows(b):
        c = b.compact()
        return sorted(zip(*[c.columns[n].to_pylist() for n in names]))
    assert rows(fused) == rows(unfused) == rows(ref)
    assert fused.num_live() == 60  # build keys 0, 3, ..., 177, all below 200


def test_non_inner_joins_reject_prelude():
    _j, (build, probe) = _join_sides(_data(10))
    pred = ir.call("lt", ir.ColRef("a", dt.BIGINT, None), ir.lit(5))
    with pytest.raises(AssertionError):
        ops.HashJoinOp(ops.SourceOp([build]), ops.SourceOp([probe]),
                       [ir.ColRef("k", dt.BIGINT, None)], [ir.ColRef("a", dt.BIGINT, None)],
                       "left", probe_prelude=fusion.FusedSegment([("filter", pred)]))


def test_segment_spans_record_chain_and_rows():
    from galaxysql_tpu_torch.utils.tracing import SEGMENT_TRACER
    _jb, pb = _batches({"a": list(range(200)), "b": [1.0] * 200, "s": ["x"] * 200})
    pred, projs = _stages(ir, dt, pb, lim=77)
    seg = fusion.FusedSegment([("filter", pred), ("project", projs)])
    SEGMENT_TRACER.clear()
    SEGMENT_TRACER.enabled = True
    try:
        seg.run_batch(pb)
        seg.run_batch(pb)
    finally:
        SEGMENT_TRACER.enabled = False
    spans = SEGMENT_TRACER.spans()
    assert [(s.chain, s.segment_id, s.rows_in, s.rows_out) for s in spans] == \
        [("filter>project", seg.segment_id, 200, 77)] * 2
    assert all(s.wall_ms >= 0 for s in spans)


# -- SQL: TPC-H at SF 0.01 -------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = tpch.generate(0.01)
    ji = JaxInstance(boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    pi = Instance(device="cpu")
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


# without the fragment cache, which would replay the first run for the second
OFF = "/*+TDDL:FRAGMENT_CACHE(OFF)*/ "
NO_FUSE = "/*+TDDL:NO_FUSE FRAGMENT_CACHE(OFF)*/ "


@pytest.mark.parametrize("q", [1, 3, 5, 9, 10, 18])
def test_tpch_fused_equals_no_fuse_and_the_reference(tpch_pair, q):
    js, ps = tpch_pair
    want = js.execute(QUERIES[q]).rows
    fused = ps.execute(OFF + QUERIES[q]).rows
    fused_trace = list(ps.last_trace)
    unfused = ps.execute(NO_FUSE + QUERIES[q]).rows
    assert fused == unfused == want
    assert any(t.startswith("fuse-") for t in fused_trace)
    assert not any(t.startswith("fuse-") for t in ps.last_trace)


def test_fusion_engages_and_no_fuse_hint_disables(tpch_pair):
    _js, ps = tpch_pair
    q = ("select l_returnflag, sum(l_quantity) from lineitem "
         "where l_shipdate <= date '1998-09-02' group by l_returnflag")
    ps.execute(OFF + q)
    assert "fuse-agg-prelude filter" in ps.last_trace
    ps.execute(NO_FUSE + q)
    assert not any("fuse" in t for t in ps.last_trace)


@pytest.mark.parametrize("q", [3, 5, 9])
def test_streamed_scans_run_every_batch_through_segment_and_filter(tpch_pair,
                                                                    monkeypatch, q):
    """Past a lowered FUSE_MAX_ROWS each partition's batch passes the fused segment
    and the scan's runtime filters; the rows are the reference's."""
    js, ps = tpch_pair
    want = js.execute(QUERIES[q]).rows
    monkeypatch.setattr(physical, "FUSE_MAX_ROWS", 1000)
    got = ps.execute(OFF + QUERIES[q]).rows
    assert got == want
    assert any("streamed batches=" in t for t in ps.last_trace)
    assert any(t.startswith(("rf-scan", "fuse-")) for t in ps.last_trace)
