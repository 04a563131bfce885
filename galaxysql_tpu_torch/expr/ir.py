"""Typed scalar-expression IR (the Rex analog).

Reference analog: the vectorized expression engine seam — `executor/vectorized/
VectorizedExpression.java:22` + `Rex2VectorizedExpressionVisitor` (SURVEY.md §2.6).  Nodes are
bound (typed) at construction; `expr/compiler.py` lowers a tree to a single traced function over
column lanes, with one code path serving both the JAX device backend and the numpy golden
backend (the reference keeps dual row/vector engines for the same cross-check role).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from galaxysql_tpu_torch.chunk.batch import Dictionary
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal


class Expr:
    dtype: dt.DataType

    def children(self) -> Sequence["Expr"]:
        return ()

    def key(self) -> Tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Expr) and self.key() == other.key()


@dataclasses.dataclass(eq=False)
class ColRef(Expr):
    """Reference to an input column by name."""

    name: str
    dtype: dt.DataType
    dictionary: Optional[Dictionary] = None

    def key(self):
        # the type is part of the identity: generated ids (agg outputs, derived
        # columns) repeat across plans with different types, and compiled closures
        # bake type-dependent behavior (decimal scales, output Column dtypes)
        return ("col", self.name, self.dtype.sql_name())

    def __repr__(self):
        return f"${self.name}"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    value: Any  # python-domain value (Decimal scaled NOT applied; raw int/float/str/None)
    dtype: dt.DataType
    # typed NULL group-key slots (grouping-sets expansion) carry the column's
    # dictionary so the unioned output decodes sibling branches' codes
    dictionary: Optional[Dictionary] = None

    def key(self):
        if self.dictionary is None:
            return ("lit", self.value, self.dtype.sql_name())
        return ("lit", self.value, self.dtype.sql_name(),
                self.dictionary.uid, len(self.dictionary))

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(eq=False)
class Call(Expr):
    op: str
    args: List[Expr]
    dtype: dt.DataType
    # string-producing calls (substr/upper/...) carry a derived host dictionary; the
    # device lowering is then a code-translation gather (see compiler._dict_transform)
    dictionary: Optional[Dictionary] = None
    # host-side metadata for the dict transform (e.g. translation table)
    meta: Optional[Tuple] = None

    def children(self):
        return self.args

    def key(self):
        base = ("call", self.op) + tuple(a.key() for a in self.args)
        if self.meta is None and self.dictionary is None:
            return base
        # dict_transform semantics live in the translation table + derived dictionary,
        # not the op name: UPPER(c) and SUBSTR(c,1,2) must not compare equal
        meta_digest = None
        if self.meta is not None:
            meta_digest = tuple(hash(m.tobytes()) if hasattr(m, "tobytes") else m
                                for m in self.meta)
        dict_uid = (self.dictionary.uid, len(self.dictionary)) \
            if self.dictionary is not None else None
        return base + (meta_digest, dict_uid)

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    arg: Expr
    dtype: dt.DataType

    def children(self):
        return [self.arg]

    def key(self):
        return ("cast", self.dtype.sql_name(), self.arg.key())

    def __repr__(self):
        return f"CAST({self.arg!r} AS {self.dtype.sql_name()})"


@dataclasses.dataclass(eq=False)
class InList(Expr):
    """expr IN (literals).  String lists resolve to dictionary-code sets at compile time."""

    arg: Expr
    values: Tuple[Any, ...]
    negated: bool
    dtype: dt.DataType = dt.BOOL

    def children(self):
        return [self.arg]

    def key(self):
        return ("in", self.negated, self.values, self.arg.key())


@dataclasses.dataclass(eq=False)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END (searched form)."""

    whens: List[Tuple[Expr, Expr]]
    default: Optional[Expr]
    dtype: dt.DataType

    def children(self):
        out: List[Expr] = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return out

    def key(self):
        return ("case", tuple((c.key(), v.key()) for c, v in self.whens),
                self.default.key() if self.default is not None else None)


# ---------------------------------------------------------------------------
# Builder helpers with MySQL-ish type inference
# ---------------------------------------------------------------------------

_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}
_LOGIC = {"and", "or", "not"}


def lit(value: Any, dtype: Optional[dt.DataType] = None) -> Literal:
    return Literal(value, dtype or dt.literal_type(value))


def date_lit(s: str) -> Literal:
    return Literal(temporal.parse_date(s), dt.DATE)


def _coerce_temporal_literal(a: Expr, b: Expr) -> Tuple[Expr, Expr]:
    """If one side is temporal and the other a string literal, parse the literal."""
    def conv(e: Expr, target: dt.DataType) -> Expr:
        if isinstance(e, Literal) and isinstance(e.value, str):
            if target.clazz == dt.TypeClass.DATE:
                return Literal(temporal.parse_date(e.value), dt.DATE)
            if target.clazz == dt.TypeClass.DATETIME:
                return Literal(temporal.parse_datetime(e.value), dt.DATETIME)
        return e
    if a.dtype.is_temporal:
        b = conv(b, a.dtype)
    elif b.dtype.is_temporal:
        a = conv(a, b.dtype)
    return a, b


def call(op: str, *args: Expr) -> Expr:
    """Typed Call constructor: infers result type (MySQL coercion rules)."""
    args = list(args)
    if op in _CMP:
        a, b = _coerce_temporal_literal(args[0], args[1])
        args = [a, b]
        return Call(op, args, dt.BOOL)
    if op in _LOGIC or op in ("is_null", "is_not_null", "like", "not_like", "is_true",
                              "is_false", "between"):
        return Call(op, args, dt.BOOL)
    if op == "add" or op == "sub":
        a, b = _coerce_temporal_literal(args[0], args[1])
        if op == "add" and b.dtype.is_temporal and not a.dtype.is_temporal:
            a, b = b, a  # N + date == date + N; keeps the temporal operand first
        if a.dtype.is_temporal and not b.dtype.is_temporal:
            return Call(op, [a, b], a.dtype)  # date +/- interval
        if op == "sub" and a.dtype.is_temporal and b.dtype.is_temporal:
            return Call("datediff", [a, b], dt.BIGINT)
        if op == "sub" and b.dtype.is_temporal:
            raise ValueError("numeric - temporal is not supported")
        return Call(op, [a, b], dt.add_result_type(a.dtype, b.dtype))
    if op == "mul":
        return Call(op, args, dt.mul_result_type(args[0].dtype, args[1].dtype))
    if op == "div":
        return Call(op, args, dt.div_result_type(args[0].dtype, args[1].dtype))
    if op == "mod":
        return Call(op, args, dt.common_type(args[0].dtype, args[1].dtype))
    if op == "neg":
        return Call(op, args, args[0].dtype)
    if op in ("year", "month", "dayofmonth", "quarter"):
        return Call(op, args, dt.INT)
    if op in ("coalesce", "ifnull"):
        t = args[0].dtype
        for a in args[1:]:
            t = dt.common_type(t, a.dtype)
        return Call(op, args, t)
    if op == "if":
        return Call(op, args, dt.common_type(args[1].dtype, args[2].dtype))
    if op in ("abs",):
        return Call(op, args, args[0].dtype)
    if op in ("least", "greatest"):
        t = args[0].dtype
        for a in args[1:]:
            t = dt.common_type(t, a.dtype)
        return Call(op, args, t)
    if op in ("date_add_days", "date_sub_days", "date_add_months"):
        return Call(op, args, args[0].dtype)
    if op in ("extract_year_month",):
        return Call(op, args, dt.INT)
    raise ValueError(f"unknown scalar op: {op}")


def and_(*args: Expr) -> Expr:
    args = [a for a in args if not (isinstance(a, Literal) and a.value is True)]
    if not args:
        return lit(True, dt.BOOL)
    e = args[0]
    for a in args[1:]:
        e = call("and", e, a)
    return e


def or_(*args: Expr) -> Expr:
    e = args[0]
    for a in args[1:]:
        e = call("or", e, a)
    return e


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def referenced_columns(e: Expr) -> List[str]:
    seen, out = set(), []
    for n in walk(e):
        if isinstance(n, ColRef) and n.name not in seen:
            seen.add(n.name)
            out.append(n.name)
    return out
