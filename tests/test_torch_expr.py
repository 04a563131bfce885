"""The port's expression compiler (torch backend, `TorchXP`) against the JAX package's
`jnp` backend, on the IR ops TPC-H Q1/Q3/Q5/Q6 compile, over seeded lanes with NULLs.
Exact lanes (decimals as scaled int64, dates, booleans, codes) must be identical;
float32 lanes agree to rtol=1e-6 (the reference computes floats in float32 on device)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galaxysql_tpu.chunk import batch as jbatch
from galaxysql_tpu.expr import ir as jir
from galaxysql_tpu.expr.compiler import ExprCompiler as JCompiler
from galaxysql_tpu.types import datatype as jdt
from galaxysql_tpu_torch.chunk import batch as tbatch
from galaxysql_tpu_torch.expr import ir as tir
from galaxysql_tpu_torch.expr.compiler import ExprCompiler as TCompiler, TorchXP
from galaxysql_tpu_torch.types import datatype as tdt

pytestmark = pytest.mark.torch_port

# one torch thread: the suite runs in parallel workers, and these small CPU
# computations must not take cores from the other workers' tests
torch.set_num_threads(1)

N = 1000
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]


def _lanes():
    rng = np.random.default_rng(31)
    return {
        "price": (rng.integers(90_000, 10_500_000, N).astype(np.int64), rng.random(N) > 0.1),
        "disc": (rng.integers(0, 11, N).astype(np.int64), rng.random(N) > 0.1),
        "tax": (rng.integers(0, 9, N).astype(np.int64), None),
        "qty": (rng.integers(100, 5100, N).astype(np.int64), rng.random(N) > 0.05),
        "ship": (rng.integers(8036, 10500, N).astype(np.int32), rng.random(N) > 0.1),
        "odate": (rng.integers(8036, 10400, N).astype(np.int32), None),
        "seg": (rng.integers(0, 5, N).astype(np.int32), rng.random(N) > 0.1),
        "k1": (rng.integers(-50, 50, N).astype(np.int32), rng.random(N) > 0.1),
        "k2": (rng.integers(-50, 50, N).astype(np.int32), None),
        "f": (rng.normal(0, 100, N).astype(np.float32), rng.random(N) > 0.1),
    }


def _exprs(ir, dt, dictionary):
    dec = dt.decimal(15, 2)
    c = {
        "price": ir.ColRef("price", dec), "disc": ir.ColRef("disc", dec),
        "tax": ir.ColRef("tax", dec), "qty": ir.ColRef("qty", dec),
        "ship": ir.ColRef("ship", dt.DATE), "odate": ir.ColRef("odate", dt.DATE),
        "seg": ir.ColRef("seg", dt.VARCHAR, dictionary),
        "k1": ir.ColRef("k1", dt.INT), "k2": ir.ColRef("k2", dt.INT),
        "f": ir.ColRef("f", dt.DOUBLE),
    }
    one = ir.lit(1)
    disc_price = ir.call("mul", c["price"], ir.call("sub", one, c["disc"]))
    return {
        "q1_disc_price": disc_price,
        "q1_charge": ir.call("mul", disc_price, ir.call("add", one, c["tax"])),
        "q6_revenue": ir.call("mul", c["price"], c["disc"]),
        "q1_ship_le": ir.call("le", c["ship"], ir.call(
            "date_sub_days", ir.date_lit("1998-12-01"), ir.lit(90))),
        "q5_year_window": ir.and_(
            ir.call("ge", c["odate"], ir.date_lit("1994-01-01")),
            ir.call("lt", c["odate"], ir.call("date_add_months",
                                              ir.date_lit("1994-01-01"), ir.lit(12)))),
        "q6_between": ir.call("between", c["disc"], ir.call("sub", ir.lit(0.06, dec),
                                                            ir.lit(0.01, dec)),
                              ir.call("add", ir.lit(0.06, dec), ir.lit(0.01, dec))),
        "q6_qty_lt": ir.call("lt", c["qty"], ir.lit(24)),
        "q3_seg_eq": ir.call("eq", c["seg"], ir.lit("BUILDING")),
        "q3_ship_gt": ir.call("gt", c["ship"], ir.date_lit("1995-03-15")),
        "join_key_eq": ir.call("eq", c["k1"], c["k2"]),
        "kleene_or": ir.or_(ir.call("lt", c["k1"], ir.lit(0)),
                            ir.call("ne", c["seg"], ir.lit("ASIA"))),
        "not_null": ir.call("not", ir.call("is_null", c["price"])),
        "year": ir.call("year", c["ship"]),
        "float_mul": ir.call("mul", c["f"], ir.lit(2.5)),
        "decimal_to_float": ir.call("add", c["f"], c["price"]),
    }


def _run_jax(name, lanes):
    d = jbatch.Dictionary(SEGMENTS)
    e = _exprs(jir, jdt, d)[name]
    env = {k: (jnp.asarray(a), None if v is None else jnp.asarray(v))
           for k, (a, v) in lanes.items()}
    data, valid = JCompiler(jnp).compile(e)(env)
    data = np.broadcast_to(np.asarray(data), (N,))
    valid = np.ones(N, bool) if valid is None else np.broadcast_to(np.asarray(valid), (N,))
    return data, valid


def _run_torch(name, lanes):
    d = tbatch.Dictionary(SEGMENTS)
    e = _exprs(tir, tdt, d)[name]
    env = {k: (torch.from_numpy(a), None if v is None else torch.from_numpy(v))
           for k, (a, v) in lanes.items()}
    data, valid = TCompiler(TorchXP("cpu")).compile(e)(env)
    data = np.broadcast_to(data.numpy(), (N,))
    valid = np.ones(N, bool) if valid is None else np.broadcast_to(valid.numpy(), (N,))
    return data, valid


NAMES = list(_exprs(tir, tdt, tbatch.Dictionary(SEGMENTS)))


@pytest.mark.parametrize("name", NAMES)
def test_torch_backend_matches_jnp(name):
    lanes = _lanes()
    jd, jv = _run_jax(name, lanes)
    td, tv = _run_torch(name, lanes)
    assert np.array_equal(jv, tv)
    assert jd.dtype == td.dtype or (jd.dtype.kind == td.dtype.kind)
    if jd.dtype.kind == "f":
        assert td.dtype == np.float32  # device float semantics
        np.testing.assert_allclose(td[tv], jd[jv], rtol=1e-6)
    else:
        assert np.array_equal(jd[jv], td[tv])


def test_numpy_golden_backend_kept():
    lanes = _lanes()
    e = _exprs(tir, tdt, tbatch.Dictionary(SEGMENTS))["q1_charge"]
    env = {k: (a, v) for k, (a, v) in lanes.items()}
    nd, nv = TCompiler(np).compile(e)(env)
    td, tv = _run_torch("q1_charge", lanes)
    assert np.array_equal(nv, tv)
    assert np.array_equal(np.asarray(nd)[nv], td[tv])
