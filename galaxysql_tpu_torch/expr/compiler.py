"""Expression compiler: typed IR tree -> one array function.

Counterpart of `galaxysql_tpu/expr/compiler.py`.  A single lowering serves two array
backends:

- `TorchXP(device)` — the device path: a thin numpy-style shim over torch, so the
  lowering below reads the same as the reference's `xp` code.  Floats compute in
  float32, the reference's device semantics (`_to_float`).
- `numpy`           — the golden reference evaluator used by tests.

Values flow as `(data, valid)` pairs; `valid=None` means all-valid (saves mask traffic for
the common non-null case, like the reference's mayHaveNull fast paths).  NULL semantics are
MySQL's: strict functions propagate NULL; AND/OR are Kleene; comparisons with NULL are NULL;
division by zero yields NULL.

Strings are dictionary codes.  LIKE / IN / ordering on strings are resolved against the
host-side Dictionary at *compile* time into device-side code-set membership / rank gathers
(SURVEY.md §7.1 stance; the dictionary is static plan metadata).
"""

from __future__ import annotations

import re
from functools import reduce
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import Dictionary, as_tensor, torch_dtype
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal

Value = Tuple[Any, Optional[Any]]  # (data, valid-or-None)
Env = Dict[str, Value]
Compiled = Callable[[Env], Value]


class TorchXP:
    """The slice of the numpy namespace the lowering uses, over torch tensors on one
    device.  Constants (`asarray`) land on that device; dtype arguments may be numpy
    dtypes (a type's `lane`) or torch dtypes."""

    bool_ = torch.bool
    int32 = torch.int32
    int64 = torch.int64
    float32 = torch.float32
    float64 = torch.float64

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, a):
        if isinstance(a, torch.Tensor):
            return a
        return as_tensor(np.asarray(a), self.device)

    def astype(self, x, dtype):
        return self.asarray(x).to(torch_dtype(dtype))

    def where(self, cond, a, b):
        if not isinstance(cond, torch.Tensor):
            return a if bool(cond) else b
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = torch.as_tensor(a, device=cond.device)
        return torch.where(cond, a, b)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=torch_dtype(dtype or np.float64),
                           device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=torch_dtype(dtype or np.float64),
                          device=self.device)

    def zeros_like(self, x):
        return torch.zeros_like(x)

    def ones_like(self, x):
        return torch.ones_like(x)

    def searchsorted(self, table, values):
        return torch.searchsorted(table, values)

    def clip(self, x, lo, hi):
        return torch.clamp(x, lo, hi)

    def abs(self, x):
        return torch.abs(x)

    def floor_divide(self, a, b):
        return torch.div(self.asarray(a), b, rounding_mode="floor")

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def fmod(self, a, b):
        return torch.fmod(a, b)

    def broadcast_to(self, x, shape):
        return self.asarray(x).expand(shape)


def _astype(xp, x, dtype):
    if xp is np:
        return x.astype(dtype)
    return xp.astype(x, dtype)


def _is_array(x) -> bool:
    return isinstance(x, torch.Tensor) or hasattr(x, "astype")


def _is_floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return np.issubdtype(x.dtype, np.floating)


def _and_valid(xp, *valids):
    vs = [v for v in valids if v is not None]
    if not vs:
        return None
    return reduce(lambda a, b: a & b, vs)


def _to_float(xp, data, typ: dt.DataType):
    f = xp.float64 if xp is np else xp.float32
    if typ.clazz == dt.TypeClass.DECIMAL:
        return _astype(xp, data, f) / (10.0 ** typ.scale)
    return _astype(xp, data, f)


def _pow10(d: int) -> int:
    return 10 ** d


def _signed_div_round(xp, num, den):
    """round-half-away-from-zero integer division (MySQL decimal rounding)."""
    num_neg = num < 0
    den_neg = den < 0
    anum = xp.where(num_neg, -num, num)
    aden = xp.where(den_neg, -den, den)
    aden_safe = xp.where(aden == 0, 1, aden)
    q = (anum + aden_safe // 2) // aden_safe
    return xp.where(num_neg != den_neg, -q, q)


def _rescale(xp, data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * _pow10(to_scale - from_scale)
    return _signed_div_round(xp, data, _pow10(from_scale - to_scale))


# -- device civil-calendar math (vectorized Hinnant) ------------------------

def _civil_from_days(xp, z):
    z = _astype(xp, z, xp.int32) + 719468
    era = xp.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + xp.where(mp < 10, 3, -9)
    return y + _astype(xp, m <= 2, xp.int32), m, d


def _days_from_civil(xp, y, m, d):
    y = y - _astype(xp, m <= 2, xp.int32)
    era = xp.floor_divide(y, 400)
    yoe = y - era * 400
    doy = (153 * (m + xp.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _temporal_days(xp, data, typ: dt.DataType):
    if typ.clazz == dt.TypeClass.DATETIME:
        return _astype(xp, xp.floor_divide(data, temporal.MICROS_PER_DAY), xp.int32)
    return data


def _encode_literal_value(value, typ: dt.DataType):
    """Python literal -> lane-domain scalar."""
    if typ.clazz == dt.TypeClass.DECIMAL:
        return int(round(float(value) * _pow10(typ.scale)))
    if typ.clazz == dt.TypeClass.DATE:
        return temporal.parse_date(value) if isinstance(value, str) else int(value)
    if typ.clazz == dt.TypeClass.DATETIME:
        return temporal.parse_datetime(value) if isinstance(value, str) else int(value)
    if typ.clazz == dt.TypeClass.FLOAT:
        return float(value)
    if typ.is_string:
        return value  # encoded lazily against the peer dictionary
    return int(value)


class ExprCompiler:
    """Compiles bound IR against a fixed backend (`numpy` or a `TorchXP`)."""

    def __init__(self, xp):
        self.xp = xp

    # -- public -----------------------------------------------------------

    def compile(self, e: ir.Expr) -> Compiled:
        return self._compile(e)

    def compile_predicate(self, e: ir.Expr) -> Callable[[Env], Any]:
        """Predicate closure: NULL -> False (SQL WHERE semantics)."""
        f = self._compile(e)
        xp = self.xp

        def pred(env: Env):
            data, valid = f(env)
            data = _astype(xp, data, xp.bool_)
            return data if valid is None else data & valid
        return pred

    # -- dispatch ----------------------------------------------------------

    def _compile(self, e: ir.Expr) -> Compiled:
        if isinstance(e, ir.ColRef):
            name = e.name
            return lambda env: env[name]
        if isinstance(e, ir.Literal):
            return self._literal(e)
        if isinstance(e, ir.Cast):
            return self._cast(e)
        if isinstance(e, ir.InList):
            return self._in_list(e)
        if isinstance(e, ir.Case):
            return self._case(e)
        if isinstance(e, ir.Call):
            return self._call(e)
        raise TypeError(f"cannot compile {e!r}")

    # -- leaves ------------------------------------------------------------

    def _encode_scalar(self, value, typ: dt.DataType):
        """Python literal -> lane-domain scalar."""
        if value is None:
            return None
        return _encode_literal_value(value, typ)

    def _literal(self, e: ir.Literal) -> Compiled:
        xp = self.xp
        if e.value is None:
            zero = np.zeros((), dtype=e.dtype.lane)
            return lambda env: (xp.asarray(zero), xp.zeros((), dtype=xp.bool_))
        v = self._encode_scalar(e.value, e.dtype)
        if isinstance(v, str):
            raise ValueError(
                f"string literal {v!r} reached lowering without dictionary resolution")
        arr = np.asarray(v, dtype=e.dtype.lane if e.dtype.clazz != dt.TypeClass.FLOAT
                         else np.float32)
        return lambda env: (xp.asarray(arr), None)

    # -- cast ----------------------------------------------------------------

    def _cast(self, e: ir.Cast) -> Compiled:
        xp = self.xp
        src = self._compile(e.arg)
        ft, tt = e.arg.dtype, e.dtype

        def run(env: Env) -> Value:
            data, valid = src(env)
            out = self._convert(data, ft, tt)
            return out, valid
        return run

    def _convert(self, data, ft: dt.DataType, tt: dt.DataType):
        xp = self.xp
        if ft.clazz == tt.clazz and ft.scale == tt.scale:
            return _astype(xp, data, tt.lane) if _is_array(data) else data
        if tt.clazz == dt.TypeClass.FLOAT:
            return _to_float(xp, data, ft)
        if tt.clazz == dt.TypeClass.DECIMAL:
            if ft.clazz == dt.TypeClass.DECIMAL:
                return _rescale(xp, data, ft.scale, tt.scale)
            if ft.clazz == dt.TypeClass.FLOAT:
                scaled = data * float(_pow10(tt.scale))
                return _astype(xp, xp.where(scaled >= 0, scaled + 0.5, scaled - 0.5),
                               xp.int64)
            return _astype(xp, data, xp.int64) * _pow10(tt.scale)
        if tt.is_integer:
            if ft.clazz == dt.TypeClass.DECIMAL:
                return _astype(xp, _signed_div_round(self.xp, data, _pow10(ft.scale)),
                               tt.lane)
            if ft.clazz == dt.TypeClass.FLOAT:
                # MySQL rounds half away from zero on float->int cast
                return _astype(xp, xp.where(data >= 0, data + 0.5, data - 0.5), tt.lane)
            return _astype(xp, data, tt.lane)
        if tt.clazz == dt.TypeClass.DATETIME and ft.clazz == dt.TypeClass.DATE:
            return _astype(xp, data, xp.int64) * temporal.MICROS_PER_DAY
        if tt.clazz == dt.TypeClass.DATE and ft.clazz == dt.TypeClass.DATETIME:
            return _astype(xp, xp.floor_divide(data, temporal.MICROS_PER_DAY), xp.int32)
        raise ValueError(f"unsupported cast {ft.sql_name()} -> {tt.sql_name()}")

    # -- IN list -------------------------------------------------------------

    def _in_list(self, e: ir.InList) -> Compiled:
        xp = self.xp
        arg = self._compile(e.arg)
        at = e.arg.dtype
        # MySQL: a NULL in the list makes non-matching rows evaluate to NULL
        has_null = any(v is None for v in e.values)
        values = [v for v in e.values if v is not None]
        if at.is_string:
            d = _find_dictionary(e.arg)
            if d is None:
                raise ValueError("IN on string column without dictionary")
            table = np.array(sorted(c for c in (d.encode_one(v, add=False)
                                                for v in values) if c >= 0),
                             dtype=np.int32)
        else:
            table = np.array(sorted(self._encode_scalar(v, at) for v in values),
                             dtype=at.lane)
        neg = e.negated

        def run(env: Env) -> Value:
            data, valid = arg(env)
            if table.size == 0:
                hit = xp.zeros(data.shape, dtype=xp.bool_)
            else:
                t = xp.asarray(table)
                pos = xp.searchsorted(t, data)
                pos = xp.clip(pos, 0, t.shape[0] - 1)
                hit = t[pos] == data
            if has_null:
                valid = hit if valid is None else (valid & hit)
            return (~hit if neg else hit), valid
        return run

    # -- CASE ----------------------------------------------------------------

    def _case(self, e: ir.Case) -> Compiled:
        xp = self.xp
        conds = [self.compile_predicate(c) for c, _ in e.whens]
        vals = [self._compile_coerced(v, e.dtype) for _, v in e.whens]
        default = (self._compile_coerced(e.default, e.dtype)
                   if e.default is not None else None)

        def run(env: Env) -> Value:
            out_d, out_v = None, None
            if default is not None:
                out_d, out_v = default(env)
            else:
                d0, _ = vals[0](env)
                out_d = xp.zeros_like(d0)
                out_v = xp.zeros(out_d.shape, dtype=xp.bool_) if hasattr(out_d, "shape") else False
            # apply WHENs in reverse so earlier branches win
            for c, v in zip(reversed(conds), reversed(vals)):
                m = c(env)
                d, vd = v(env)
                out_d = xp.where(m, d, out_d)
                vv = vd if vd is not None else True
                ov = out_v if out_v is not None else True
                if vv is True and ov is True:
                    out_v = None
                else:
                    vv_arr = vv if vv is not True else xp.ones(m.shape, dtype=xp.bool_)
                    ov_arr = ov if ov is not True else xp.ones(m.shape, dtype=xp.bool_)
                    out_v = xp.where(m, vv_arr, ov_arr)
            return out_d, out_v
        return run

    def _compile_coerced(self, e: ir.Expr, target: dt.DataType) -> Compiled:
        if (e.dtype.clazz == target.clazz and e.dtype.scale == target.scale) or \
           e.dtype.clazz == dt.TypeClass.NULL:
            return self._compile(e)
        return self._cast(ir.Cast(e, target))

    # -- calls ---------------------------------------------------------------

    def _call(self, e: ir.Call) -> Compiled:
        op = e.op
        if op in ("and", "or"):
            return self._kleene(e)
        if op == "not":
            f = self._compile(e.args[0])
            xp = self.xp
            return lambda env: (lambda dv: (~_astype(xp, dv[0], xp.bool_), dv[1]))(f(env))
        if op in ("is_null", "is_not_null"):
            return self._is_null(e)
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._compare(e)
        if op in ("add", "sub", "mul", "div", "mod"):
            return self._arith(e)
        if op == "neg":
            f = self._compile(e.args[0])
            return lambda env: (lambda dv: (-dv[0], dv[1]))(f(env))
        if op == "abs":
            f = self._compile(e.args[0])
            xp = self.xp
            return lambda env: (lambda dv: (xp.abs(dv[0]), dv[1]))(f(env))
        if op in ("like", "not_like"):
            return self._like(e)
        if op in ("year", "month", "dayofmonth", "quarter", "extract_year_month"):
            return self._date_part(e)
        if op in ("date_add_days", "date_sub_days", "date_add_months"):
            return self._date_add(e)
        if op == "datediff":
            return self._datediff(e)
        if op == "between":
            lo = ir.call("ge", e.args[0], e.args[1])
            hi = ir.call("le", e.args[0], e.args[2])
            return self._compile(ir.call("and", lo, hi))
        if op in ("coalesce", "ifnull"):
            return self._coalesce(e)
        if op == "if":
            c = ir.Case([(e.args[0], e.args[1])], e.args[2], e.dtype)
            return self._compile(c)
        if op in ("least", "greatest"):
            return self._least_greatest(e)
        if op == "dict_transform":
            # string->string function precomputed on the host dictionary at bind time;
            # on device it is a single code-translation gather (SURVEY.md §7.1 stance)
            f = self._compile(e.args[0])
            trans = e.meta[0]
            xp = self.xp

            def run_dt(env: Env) -> Value:
                d, v = f(env)
                return xp.asarray(trans)[d], v
            return run_dt
        raise ValueError(f"no lowering for op {op!r}")

    def _kleene(self, e: ir.Call) -> Compiled:
        xp = self.xp
        fa, fb = self._compile(e.args[0]), self._compile(e.args[1])
        is_and = e.op == "and"

        def run(env: Env) -> Value:
            ad, av = fa(env)
            bd, bv = fb(env)
            ad = _astype(xp, ad, xp.bool_)
            bd = _astype(xp, bd, xp.bool_)
            data = (ad & bd) if is_and else (ad | bd)
            if av is None and bv is None:
                return data, None
            av_ = av if av is not None else xp.ones_like(ad)
            bv_ = bv if bv is not None else xp.ones_like(bd)
            if is_and:
                valid = (av_ & bv_) | (av_ & ~ad) | (bv_ & ~bd)
            else:
                valid = (av_ & bv_) | (av_ & ad) | (bv_ & bd)
            return data, valid
        return run

    def _is_null(self, e: ir.Call) -> Compiled:
        xp = self.xp
        f = self._compile(e.args[0])
        want_null = e.op == "is_null"

        def run(env: Env) -> Value:
            d, v = f(env)
            if v is None:
                shape = d.shape if hasattr(d, "shape") else ()
                out = xp.zeros(shape, xp.bool_) if want_null else xp.ones(shape, xp.bool_)
                return out, None
            return (~v if want_null else v), None
        return run

    def _binary_operands(self, e: ir.Call):
        """Compile two operands coerced to a common comparable/arith domain."""
        a, b = e.args[0], e.args[1]
        at, bt = a.dtype, b.dtype
        # string domain: dictionary codes
        if at.is_string or bt.is_string:
            return self._string_operands(e)
        target = dt.common_type(at, bt)
        if target.clazz == dt.TypeClass.DECIMAL:
            fa = self._decimal_operand(a, target.scale)
            fb = self._decimal_operand(b, target.scale)
            return fa, fb, target
        if target.clazz == dt.TypeClass.FLOAT:
            xp = self.xp
            ca, cb = self._compile(a), self._compile(b)

            def wrap(f, t):
                return lambda env: (lambda dv: (_to_float(xp, dv[0], t), dv[1]))(f(env))
            return wrap(ca, at), wrap(cb, bt), target
        if target.is_temporal:
            # normalize DATE vs DATETIME to the wider unit
            xp = self.xp
            ca, cb = self._compile(a), self._compile(b)

            def wrapt(f, t):
                if target.clazz == dt.TypeClass.DATETIME and t.clazz == dt.TypeClass.DATE:
                    return lambda env: (lambda dv: (
                        _astype(xp, dv[0], xp.int64) * temporal.MICROS_PER_DAY,
                        dv[1]))(f(env))
                return f
            return wrapt(ca, at), wrapt(cb, bt), target
        return self._compile(a), self._compile(b), target

    def _decimal_operand(self, e: ir.Expr, scale: int) -> Compiled:
        xp = self.xp
        f = self._compile(e)
        t = e.dtype
        from_scale = t.scale if t.clazz == dt.TypeClass.DECIMAL else 0

        def run(env: Env) -> Value:
            d, v = f(env)
            d = _astype(xp, d, xp.int64)
            return _rescale(xp, d, from_scale, scale), v
        return run

    def _string_operands(self, e: ir.Call):
        """String comparison: resolve to dictionary-code domain."""
        a, b = e.args[0], e.args[1]
        da, db_ = _find_dictionary(a), _find_dictionary(b)
        xp = self.xp
        if isinstance(b, ir.Literal) or isinstance(a, ir.Literal):
            colexpr, litexpr = (a, b) if isinstance(b, ir.Literal) else (b, a)
            d = _find_dictionary(colexpr)
            if d is None:
                raise ValueError("string comparison without dictionary")
            if e.op in ("eq", "ne"):
                code = d.encode_one(str(litexpr.value), add=False)
                cf = self._compile(colexpr)
                arr = np.asarray(code, dtype=np.int32)

                def runlit(env: Env) -> Value:
                    dd, vv = cf(env)
                    return dd, vv
                lf = lambda env: (xp.asarray(arr), None)
            else:
                # ordering against literal: compare ranks.  The literal may be absent from
                # the dictionary, so its effective rank depends on the operator (half-open
                # boundary): lt/ge compare against bisect_left, le/gt against
                # bisect_right - 1.  The operator itself may be flipped below when the
                # literal is the left operand.  Under a COLLATE the ranks are
                # the collation's class ranks and the literal bisects over the
                # sorted distinct folds (collation ordering, not binary).
                from galaxysql_tpu_torch.types import collation as _coll
                _cname = _coll.collation_of_expr(colexpr)
                effective_op = e.op
                if colexpr is not a:  # literal on the left: lit OP col == col FLIP(OP) lit
                    effective_op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(
                        e.op, e.op)
                if _cname is not None:
                    rank = _coll.rank_under(d, _cname)[0]
                    side = "left" if effective_op in ("lt", "ge") else "right"
                    lrank = _coll.class_bound(d, _cname, str(litexpr.value),
                                              side)
                    if side == "right":
                        lrank -= 1
                else:
                    rank = d.rank_array()
                    import bisect
                    svals = sorted(d.values)
                    if effective_op in ("lt", "ge"):
                        lrank = bisect.bisect_left(svals, str(litexpr.value))
                    else:
                        lrank = bisect.bisect_right(svals, str(litexpr.value)) - 1
                cf0 = self._compile(colexpr)
                rank_np = rank

                def runlit(env: Env) -> Value:
                    dd, vv = cf0(env)
                    return xp.asarray(rank_np)[dd], vv
                arr = np.asarray(lrank, dtype=np.int32)
                lf = lambda env: (xp.asarray(arr), None)
            if colexpr is a:
                return runlit, lf, dt.VARCHAR
            return lf, runlit, dt.VARCHAR
        # column vs column
        if da is None or db_ is None:
            raise ValueError("string comparison without dictionary")
        ca, cb = self._compile(a), self._compile(b)
        if da is db_:
            if e.op in ("eq", "ne"):
                return ca, cb, dt.VARCHAR
            from galaxysql_tpu_torch.types import collation as _coll2
            _cn = _coll2.collation_of_expr(a) or _coll2.collation_of_expr(b)
            ranks = _coll2.rank_under(da, _cn)[0] if _cn is not None \
                else da.rank_array()

            def wrapr(f):
                return lambda env: (lambda dv: (xp.asarray(ranks)[dv[0]], dv[1]))(f(env))
            return wrapr(ca), wrapr(cb), dt.VARCHAR
        # different dictionaries: translate b's codes into a's code space
        from galaxysql_tpu_torch.chunk.batch import dictionary_translation
        trans = dictionary_translation(da, db_)

        def wrapb(f):
            return lambda env: (lambda dv: (xp.asarray(trans)[dv[0]], dv[1]))(f(env))
        if e.op in ("eq", "ne"):
            return ca, wrapb(cb), dt.VARCHAR
        ranks = da.rank_array()
        rank_t = np.where(trans >= 0, ranks[np.clip(trans, 0, max(len(ranks) - 1, 0))], -1)

        def wrapa(f):
            return lambda env: (lambda dv: (xp.asarray(ranks)[dv[0]], dv[1]))(f(env))

        def wrapbr(f):
            return lambda env: (lambda dv: (xp.asarray(rank_t)[dv[0]], dv[1]))(f(env))
        return wrapa(ca), wrapbr(cb), dt.VARCHAR

    def _compare(self, e: ir.Call) -> Compiled:
        xp = self.xp
        fa, fb, _ = self._binary_operands(e)
        op = e.op

        def run(env: Env) -> Value:
            (ad, av), (bd, bv) = fa(env), fb(env)
            if op == "eq":
                data = ad == bd
            elif op == "ne":
                data = ad != bd
            elif op == "lt":
                data = ad < bd
            elif op == "le":
                data = ad <= bd
            elif op == "gt":
                data = ad > bd
            else:
                data = ad >= bd
            return data, _and_valid(xp, av, bv)
        return run

    def _arith(self, e: ir.Call) -> Compiled:
        xp = self.xp
        op = e.op
        rt = e.dtype
        a, b = e.args[0], e.args[1]
        # temporal +/- interval-literal days
        if rt.is_temporal and op in ("add", "sub"):
            return self._date_add(ir.Call("date_add_days" if op == "add" else "date_sub_days",
                                          [a, b], rt))
        if rt.clazz == dt.TypeClass.DECIMAL:
            sa = a.dtype.scale if a.dtype.clazz == dt.TypeClass.DECIMAL else 0
            sb = b.dtype.scale if b.dtype.clazz == dt.TypeClass.DECIMAL else 0
            if op in ("add", "sub"):
                fa = self._decimal_operand(a, rt.scale)
                fb = self._decimal_operand(b, rt.scale)

                def run_as(env: Env) -> Value:
                    (ad, av), (bd, bv) = fa(env), fb(env)
                    return (ad + bd if op == "add" else ad - bd), _and_valid(xp, av, bv)
                return run_as
            if op == "mul":
                fa = self._decimal_operand(a, sa)
                fb = self._decimal_operand(b, sb)
                drop = sa + sb - rt.scale

                def run_m(env: Env) -> Value:
                    (ad, av), (bd, bv) = fa(env), fb(env)
                    raw = ad * bd
                    if drop > 0:
                        raw = _signed_div_round(xp, raw, _pow10(drop))
                    elif drop < 0:
                        raw = raw * _pow10(-drop)
                    return raw, _and_valid(xp, av, bv)
                return run_m
            if op == "div":
                fa = self._decimal_operand(a, sa)
                fb = self._decimal_operand(b, sb)
                shift = rt.scale + sb - sa

                def run_d(env: Env) -> Value:
                    (ad, av), (bd, bv) = fa(env), fb(env)
                    if shift < 0:
                        ad = _signed_div_round(xp, ad, _pow10(-shift))
                    safe = xp.where(bd == 0, 1, bd)
                    if shift > 0:
                        # long division keeps intermediates <= |b| * 10^shift instead
                        # of |a| * 10^shift (a is often a large aggregate)
                        P = _pow10(shift)
                        an = ad < 0
                        bn = bd < 0
                        aa = xp.where(an, -ad, ad)
                        ab = xp.where(bn, -safe, safe)
                        qi = aa // ab
                        rem = aa - qi * ab
                        frac = (rem * P + ab // 2) // ab
                        q = qi * P + frac
                        q = xp.where(an != bn, -q, q)
                    else:
                        q = _signed_div_round(xp, ad, safe)
                    valid = _and_valid(xp, av, bv)
                    nz = bd != 0
                    valid = nz if valid is None else (valid & nz)
                    return q, valid
                return run_d
            if op == "mod":
                fa = self._decimal_operand(a, rt.scale)
                fb = self._decimal_operand(b, rt.scale)

                def run_mod(env: Env) -> Value:
                    (ad, av), (bd, bv) = fa(env), fb(env)
                    safe = xp.where(bd == 0, 1, bd)
                    # MySQL MOD truncates: result takes the dividend's sign
                    r = xp.where(ad < 0, -(xp.abs(ad) % xp.abs(safe)),
                                 xp.abs(ad) % xp.abs(safe))
                    valid = _and_valid(xp, av, bv)
                    nz = bd != 0
                    valid = nz if valid is None else (valid & nz)
                    return r, valid
                return run_mod
        fa, fb, common = self._binary_operands(e)
        # _binary_operands already lowered both sides to float lanes when the common type
        # is FLOAT; only convert here when the result is float but operands are still in
        # an integer/decimal lane (e.g. int/int division)
        as_float = rt.clazz == dt.TypeClass.FLOAT and common.clazz != dt.TypeClass.FLOAT

        def run(env: Env) -> Value:
            (ad, av), (bd, bv) = fa(env), fb(env)
            if as_float:
                ad = _to_float(xp, ad, common)
                bd = _to_float(xp, bd, common)
            valid = _and_valid(xp, av, bv)
            if op == "add":
                return ad + bd, valid
            if op == "sub":
                return ad - bd, valid
            if op == "mul":
                return ad * bd, valid
            if op == "div":
                nz = bd != 0
                valid = nz if valid is None else (valid & nz)
                return ad / xp.where(nz, bd, 1), valid
            # mod — MySQL truncation semantics (sign of the dividend)
            nz = bd != 0
            valid = nz if valid is None else (valid & nz)
            safe = xp.where(nz, bd, 1)
            if _is_floating(ad):
                return xp.fmod(ad, safe), valid
            am = xp.abs(ad) % xp.abs(safe)
            return _astype(xp, xp.where(ad < 0, -am, am), ad.dtype), valid
        return run

    # -- strings: LIKE ------------------------------------------------------

    def _like(self, e: ir.Call) -> Compiled:
        xp = self.xp
        col, pat = e.args[0], e.args[1]
        if not isinstance(pat, ir.Literal):
            raise ValueError("LIKE pattern must be a literal")
        d = _find_dictionary(col)
        if d is None:
            raise ValueError("LIKE on column without dictionary")
        rx = re.compile(like_to_regex(str(pat.value)), re.DOTALL)
        codes = d.codes_matching(lambda s: rx.fullmatch(s) is not None)
        f = self._compile(col)
        table = np.sort(codes)
        neg = e.op == "not_like"

        def run(env: Env) -> Value:
            data, valid = f(env)
            if table.size == 0:
                hit = xp.zeros(data.shape, dtype=xp.bool_)
            else:
                t = xp.asarray(table)
                pos = xp.clip(xp.searchsorted(t, data), 0, t.shape[0] - 1)
                hit = t[pos] == data
            return (~hit if neg else hit), valid
        return run

    # -- temporal ------------------------------------------------------------

    def _date_part(self, e: ir.Call) -> Compiled:
        xp = self.xp
        f = self._compile(e.args[0])
        t = e.args[0].dtype
        op = e.op

        def run(env: Env) -> Value:
            data, valid = f(env)
            days = _temporal_days(xp, data, t)
            y, m, d = _civil_from_days(xp, days)
            if op == "year":
                return _astype(xp, y, xp.int32), valid
            if op == "month":
                return _astype(xp, m, xp.int32), valid
            if op == "dayofmonth":
                return _astype(xp, d, xp.int32), valid
            if op == "quarter":
                return _astype(xp, (m + 2) // 3, xp.int32), valid
            return _astype(xp, y * 100 + m, xp.int32), valid  # extract_year_month
        return run

    def _date_add(self, e: ir.Call) -> Compiled:
        xp = self.xp
        f = self._compile(e.args[0])
        t = e.args[0].dtype
        nf = self._compile(e.args[1])
        op = e.op

        def run(env: Env) -> Value:
            data, valid = f(env)
            n, nv = nf(env)
            if op == "date_sub_days":
                n = -n
            if op == "date_add_months":
                days = _temporal_days(xp, data, t)
                y, m, d = _civil_from_days(xp, days)
                tot = y * 12 + (m - 1) + n
                y2 = xp.floor_divide(tot, 12)
                m2 = tot - y2 * 12 + 1
                start = _days_from_civil(xp, y2, m2, 1)
                nxt = _days_from_civil(xp, y2 + _astype(xp, m2 == 12, xp.int32),
                                       xp.where(m2 == 12, 1, m2 + 1), 1)
                dim = nxt - start
                out_days = _days_from_civil(xp, y2, m2, xp.minimum(d, dim))
                if t.clazz == dt.TypeClass.DATETIME:
                    # preserve time-of-day
                    tod = data - _astype(xp, days, xp.int64) * temporal.MICROS_PER_DAY
                    return _astype(xp, out_days, xp.int64) * temporal.MICROS_PER_DAY + tod, \
                        _and_valid(xp, valid, nv)
            else:
                days_delta = n
                if t.clazz == dt.TypeClass.DATETIME:
                    out = data + _astype(xp, days_delta, xp.int64) * temporal.MICROS_PER_DAY \
                        if _is_array(days_delta) else \
                        data + int(days_delta) * temporal.MICROS_PER_DAY
                    return out, _and_valid(xp, valid, nv)
                out_days = data + days_delta
            if t.clazz == dt.TypeClass.DATETIME:
                return _astype(xp, out_days, xp.int64) * temporal.MICROS_PER_DAY, \
                    _and_valid(xp, valid, nv)
            return _astype(xp, out_days, xp.int32), _and_valid(xp, valid, nv)
        return run

    def _datediff(self, e: ir.Call) -> Compiled:
        xp = self.xp
        fa, fb = self._compile(e.args[0]), self._compile(e.args[1])
        ta, tb = e.args[0].dtype, e.args[1].dtype

        def run(env: Env) -> Value:
            (ad, av), (bd, bv) = fa(env), fb(env)
            da = _temporal_days(xp, ad, ta)
            db = _temporal_days(xp, bd, tb)
            return _astype(xp, da - db, xp.int64), _and_valid(xp, av, bv)
        return run

    # -- null handling -------------------------------------------------------

    def _coalesce(self, e: ir.Call) -> Compiled:
        xp = self.xp
        fs = [self._compile_coerced(a, e.dtype) for a in e.args]

        def run(env: Env) -> Value:
            out_d, out_v = fs[-1](env)
            # right-to-left accumulation: each earlier (higher-priority) argument
            # overwrites the accumulated result where it is non-null
            for f in reversed(fs[:-1]):
                d, v = f(env)
                if v is None:
                    out_d, out_v = d, None
                    continue
                out_d = xp.where(v, d, out_d)
                ov = out_v if out_v is not None else xp.ones_like(v)
                out_v = v | ov
            return out_d, out_v
        return run

    def _least_greatest(self, e: ir.Call) -> Compiled:
        xp = self.xp
        fs = [self._compile_coerced(a, e.dtype) for a in e.args]
        pick = xp.minimum if e.op == "least" else xp.maximum

        def run(env: Env) -> Value:
            d, v = fs[0](env)
            for f in fs[1:]:
                d2, v2 = f(env)
                d = pick(d, d2)
                v = _and_valid(xp, v, v2)
            return d, v
        return run


def _find_dictionary(e: ir.Expr) -> Optional[Dictionary]:
    """Dictionary governing a string-typed expression's code lane.

    A string-producing Call (substr/upper/...) owns a derived dictionary; otherwise the
    nearest ColRef's dictionary governs.  Only string-typed subtrees are considered, so a
    numeric expression over string inputs (e.g. LENGTH) reports none."""
    if isinstance(e, ir.Call) and e.dictionary is not None:
        return e.dictionary
    if isinstance(e, ir.ColRef):
        return e.dictionary
    if isinstance(e, ir.Literal) and e.dictionary is not None:
        return e.dictionary
    for c in e.children():
        if c.dtype.is_string:
            d = _find_dictionary(c)
            if d is not None:
                return d
    return None


def like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


def batch_env(batch) -> Env:
    """ColumnBatch -> compiler environment."""
    return {name: (c.data, c.valid) for name, c in batch.columns.items()}
