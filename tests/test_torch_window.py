"""Window functions of the port against the JAX package on the CPU.

`_segmented_scan` and `window_eval` of `galaxysql_tpu_torch.kernels.relational` are
held against `galaxysql_tpu.kernels.relational` on seeded numpy inputs (NULL lanes,
INT64 extreme values, one partition, every row dead, ties in the order keys, every
`WindowSpec` kind and frame): permutation, live mask and every output lane equal bit
for bit, except a float sum, which is compared with a stated tolerance because
float32 cumulative sums may add in another order.  Then the reference's own window
suite (`tests/test_window.py`) runs through both Sessions on the same data, carried
into the port with `storage/transfer.py`, and its two rejections raise the same error
class in the port."""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from galaxysql_tpu.kernels import relational as R
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu_torch.kernels import relational as TR
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import transfer
from galaxysql_tpu_torch.utils import errors as port_errors
from test_window import QUERIES as WINDOW_SUITE

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)

I64 = np.iinfo(np.int64)
# float32 window sums: cumulative sums whose order of addition may differ
FLOAT_SUM_RTOL = 1e-5
FLOAT_SUM_ATOL = 1e-4


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _seed(*key):
    return zlib.crc32(repr(key).encode())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- _segmented_scan ----------------------------------------------------------------

def _scan_values(dtype, rng, n):
    if dtype == "int64_extremes":
        x = rng.integers(-1000, 1000, n).astype(np.int64)
        x[rng.random(n) < 0.2] = I64.min
        x[rng.random(n) < 0.2] = I64.max
        return x
    if dtype == "int32":
        return rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    if dtype == "int8":
        return rng.integers(-128, 127, n).astype(np.int8)
    if dtype == "float32_inf":
        x = rng.normal(size=n).astype(np.float32)
        x[rng.random(n) < 0.1] = np.inf
        x[rng.random(n) < 0.1] = -np.inf
        return x
    raise ValueError(dtype)


def _resets(kind, rng, n):
    r = np.zeros(n, np.bool_)
    if kind == "first_only":
        r[0] = True
    elif kind == "random":
        r = rng.random(n) < 0.1
    elif kind == "every_row":
        r[:] = True
    elif kind == "none":
        pass
    else:
        raise ValueError(kind)
    return r


# the reference's scan under one jit: one compiled program per shape, not one per op
_REF_SCAN = jax.jit(R._segmented_scan, static_argnums=2)


@pytest.mark.parametrize("n", [1, 2, 7, 130, 1025])
@pytest.mark.parametrize("reset", ["first_only", "random", "every_row", "none"])
@pytest.mark.parametrize("dtype", ["int64_extremes", "int32", "int8", "float32_inf"])
@pytest.mark.parametrize("is_min", [True, False])
def test_segmented_scan_matches_reference(n, reset, dtype, is_min):
    rng = np.random.default_rng(_seed(n, reset, dtype, is_min))
    x = _scan_values(dtype, rng, n)
    r = _resets(reset, rng, n)
    ref = np.asarray(_REF_SCAN(_j(x), _j(r), is_min))
    got = _np(TR._segmented_scan(_t(x), _t(r), is_min))
    assert got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def test_segmented_max_of_int64_min_keeps_the_neutral():
    """max is its own combiner: a NULL-only group's neutral INT64_MIN survives, which
    -scan_min(-x) would wrap to INT64_MIN's negation (itself) and then poison."""
    x = np.array([I64.min, I64.min, 5, I64.min], np.int64)
    r = np.array([True, False, True, False])
    got = _np(TR._segmented_scan(_t(x), _t(r), False))
    assert got.tolist() == [I64.min, I64.min, 5, 5]


# -- window_eval --------------------------------------------------------------------

KINDS = [("row_number", -1, 0), ("rank", -1, 0), ("dense_rank", -1, 0),
         ("sum", 0, 0), ("count", 0, 0), ("min", 0, 0), ("max", 0, 0),
         ("min", 1, 0), ("max", 1, 0), ("lag", 0, 1), ("lead", 0, 2),
         ("first_value", 0, 0), ("last_value", 0, 0), ("sum", 2, 0)]
FRAMES = ["running", "range", "whole"]
SPECS = tuple(R.WindowSpec(k, a, o, f) for k, a, o in KINDS for f in FRAMES)


def _window_inputs(case, rng, n):
    live = rng.random(n) > 0.15
    if case == "dead":
        live[:] = False
    # partition keys: NULL lanes, except in "one_partition" (no PARTITION BY)
    if case == "one_partition":
        part = []
    else:
        part = [(rng.integers(0, 6, n).astype(np.int64), rng.random(n) > 0.2)]
        if case == "two_part_keys":
            part.append((rng.integers(-3, 3, n).astype(np.int32), None))
    # order keys with many ties (few distinct values), one with NULLs, desc and asc
    order = [(rng.integers(0, 4, n).astype(np.int32), rng.random(n) > 0.1, False, True),
             (rng.integers(0, 3, n).astype(np.int64), None, True, False)]
    if case == "no_order":
        order = []
    big = rng.integers(-1000, 1000, n).astype(np.int64)
    big[rng.random(n) < 0.15] = I64.min
    big[rng.random(n) < 0.15] = I64.max
    inputs = [(rng.integers(-500, 500, n).astype(np.int64), rng.random(n) > 0.25),
              (big, rng.random(n) > 0.1),
              (rng.random(n).astype(np.float32), rng.random(n) > 0.1)]
    return part, order, inputs, live


@pytest.mark.parametrize("n", [1, 5, 257])
@pytest.mark.parametrize("case", ["nulls", "one_partition", "two_part_keys",
                                  "no_order", "dead"])
def test_window_eval_matches_reference(case, n):
    rng = np.random.default_rng(_seed(case, n))
    part, order, inputs, live = _window_inputs(case, rng, n)
    flags = [(desc, nf) for _d, _v, desc, nf in order]

    def ref_eval(part_, order_, inputs_, live_):
        # one jitted program (the order flags and specs are static)
        ok = [(d, v, desc, nf) for (d, v), (desc, nf) in zip(order_, flags)]
        return R.window_eval(part_, ok, inputs_, SPECS, live_)

    ref_order, ref_live, ref_out = jax.jit(ref_eval)(
        [(_j(d), _j(v)) for d, v in part], [(_j(d), _j(v)) for d, v, _a, _b in order],
        [(_j(d), _j(v)) for d, v in inputs], _j(live))
    specs = tuple(TR.WindowSpec(*s) for s in SPECS)
    got_order, got_live, got_out = TR.window_eval(
        [(_t(d), _t(v)) for d, v in part],
        [(_t(d), _t(v), desc, nf) for d, v, desc, nf in order],
        [(_t(d), _t(v)) for d, v in inputs], specs, _t(live))
    assert np.array_equal(_np(got_order), np.asarray(ref_order))
    assert np.array_equal(_np(got_live), np.asarray(ref_live))
    assert len(got_out) == len(ref_out) == len(SPECS)
    for spec, (rd, rv), (gd, gv) in zip(SPECS, ref_out, got_out):
        assert (rv is None) == (gv is None), spec
        rd, gd = np.asarray(rd), _np(gd)
        if rv is not None:
            assert np.array_equal(_np(gv), np.asarray(rv)), spec
        mask = np.ones(n, np.bool_) if rv is None else np.asarray(rv)
        if rd.dtype.kind == "f" and spec.kind == "sum":
            np.testing.assert_allclose(gd[mask], rd[mask], rtol=FLOAT_SUM_RTOL,
                                       atol=FLOAT_SUM_ATOL, err_msg=str(spec))
        else:
            assert gd.dtype == rd.dtype, spec
            assert np.array_equal(gd[mask], rd[mask]), spec


def test_window_eval_partition_spanning_all_rows():
    """One partition holding every row (no PARTITION BY), a long run of ties: the
    range frame's run end and the whole frame's partition end are the last live row."""
    n = 1024
    live = np.ones(n, np.bool_)
    live[1000:] = False
    order = [(np.repeat(np.arange(8, dtype=np.int32), 128), None, False, True)]
    x = np.arange(n, dtype=np.int64)
    specs = (TR.WindowSpec("sum", 0, 0, "range"), TR.WindowSpec("max", 0, 0, "whole"),
             TR.WindowSpec("last_value", 0, 0, "whole"))
    _o, _l, out = TR.window_eval([], [(_t(d), v, a, b) for d, v, a, b in order],
                                 [(_t(x), None)], specs, _t(live))
    ends = np.minimum((np.arange(n) // 128 + 1) * 128 - 1, 999)
    csum = np.cumsum(np.where(live, x, 0))
    assert np.array_equal(_np(out[0][0])[:1000], csum[ends][:1000])
    assert set(_np(out[1][0])[:1000].tolist()) == {999}
    assert set(_np(out[2][0])[:1000].tolist()) == {999}


# -- the reference's window suite through both Sessions --------------------------

SALES = [("east", 1, 100), ("east", 2, 200), ("east", 3, 200), ("east", 1, 50),
         ("west", 4, 300), ("west", 5, 100), ("west", 4, 100), ("north", 6, 10)]


@pytest.fixture(scope="module")
def sessions():
    ji = JaxInstance()
    js = JaxSession(ji)
    pi = Instance(device="cpu")
    ps = Session(pi)
    js.execute("CREATE DATABASE w; USE w")
    ps.execute("CREATE DATABASE w")
    ps.execute("USE w")
    ddl = {"sales": "CREATE TABLE sales (region VARCHAR(10), emp BIGINT, amount BIGINT)",
           "np": "CREATE TABLE np (g BIGINT, v BIGINT)"}
    js.execute(ddl["sales"])
    js.execute("INSERT INTO sales VALUES " +
               ", ".join(f"('{r}', {e}, {a})" for r, e, a in SALES))
    js.execute(ddl["np"])
    js.execute("INSERT INTO np VALUES (NULL, 7), (NULL, 9), (1, 1)")
    for t in ("sales", "np"):
        ps.execute(ddl[t])
        parts, dicts = transfer.arrays_of(ji.store("w", t))
        pi.install_store(transfer.store_from_arrays(pi.catalog.table("w", t), parts,
                                                    dicts))
    yield js, ps
    js.close()
    ps.close()


@pytest.mark.parametrize("q", WINDOW_SUITE)
def test_reference_window_suite_rows_equal(sessions, q):
    js, ps = sessions
    ref = js.execute(q)
    got = ps.execute(q)
    assert got.names == ref.names
    assert len(got.rows) == len(SALES)
    assert got.rows == ref.rows


@pytest.mark.parametrize("q", [
    "SELECT region, amount, sum(amount) OVER (PARTITION BY region ORDER BY amount) "
    "AS r FROM sales WHERE region = 'east'",
    "SELECT region, amount, last_value(amount) OVER (PARTITION BY region ORDER BY "
    "amount ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS lv FROM sales",
    "SELECT g, count(v) OVER (PARTITION BY g) c FROM np",
    "SELECT region, amount, avg(amount) OVER (PARTITION BY region ORDER BY amount) "
    "AS a FROM sales",
    "SELECT region, amount, last_value(amount) OVER (PARTITION BY region ORDER BY "
    "amount) AS lv FROM sales",
])
def test_reference_window_regressions_rows_equal(sessions, q):
    js, ps = sessions
    ref = js.execute(q)
    got = ps.execute(q)
    assert got.names == ref.names
    assert got.rows == ref.rows


def test_empty_window_input_gives_no_rows(sessions):
    js, ps = sessions
    q = ("SELECT region, row_number() OVER (ORDER BY amount) AS rn FROM sales "
         "WHERE amount < 0")
    assert ps.execute(q).rows == js.execute(q).rows == []


@pytest.mark.parametrize("q", [
    "SELECT sum(amount) OVER (ORDER BY amount ROWS BETWEEN CURRENT ROW AND UNBOUNDED "
    "FOLLOWING) FROM sales",
    "SELECT sum(DISTINCT amount) OVER (PARTITION BY region) FROM sales",
])
def test_rejections_raise_the_same_error_class(sessions, q):
    js, ps = sessions
    from galaxysql_tpu.utils.errors import NotSupportedError
    with pytest.raises(NotSupportedError):
        js.execute(q)
    with pytest.raises(port_errors.NotSupportedError):
        ps.execute(q)
