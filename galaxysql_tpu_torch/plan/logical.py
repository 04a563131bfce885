"""Logical relational algebra.

Reference analog: the Calcite logical rel layer (SURVEY.md §2.4) — but deliberately small:
a closed set of nodes, each knowing its output schema as [(column_id, DataType, Dictionary)].
Column identity is by unique string id assigned at bind time ("alias.column" for base
columns, generated names for derived), which stands in for Calcite's field indexes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from galaxysql_tpu_torch.chunk.batch import Dictionary
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.meta.catalog import TableMeta
from galaxysql_tpu_torch.types import datatype as dt

# (column_id, type, dictionary)
Field = Tuple[str, dt.DataType, Optional[Dictionary]]


@dataclasses.dataclass
class AggSpec:
    kind: str                    # sum | count | avg | min | max | count_star
    arg: Optional[ir.Expr]
    out_id: str
    distinct: bool = False

    @property
    def dtype(self) -> dt.DataType:
        from galaxysql_tpu_torch.exec.operators import AggCall
        return AggCall(self.kind, self.arg, self.out_id).dtype


def clone_tree(n: "RelNode") -> "RelNode":
    """Structural copy of a plan subtree: fresh RelNodes and fresh list attrs
    (optimizer rules mutate Scan.columns / Project.exprs in place), while ir
    expressions, TableMetas and dictionaries stay shared (immutable identities).
    Needed wherever one bound subtree feeds several parents (grouping sets)."""
    import copy
    c = copy.copy(n)
    for attr, v in vars(c).items():
        if attr != "children" and isinstance(v, list):
            setattr(c, attr, list(v))
    c.children = [clone_tree(ch) for ch in n.children]
    return c


class RelNode:
    children: List["RelNode"]

    def fields(self) -> List[Field]:
        raise NotImplementedError

    def field_ids(self) -> List[str]:
        return [f[0] for f in self.fields()]

    def explain_lines(self, depth: int = 0) -> List[str]:
        line = "  " * depth + self.label()
        out = [line]
        for c in self.children:
            out += c.explain_lines(depth + 1)
        return out

    def label(self) -> str:
        return type(self).__name__


class Scan(RelNode):
    def __init__(self, table: TableMeta, alias: str,
                 columns: Sequence[Tuple[str, str]],  # (out_id, table_column)
                 col_meta: Optional[Dict[str, Any]] = None):
        self.table = table
        self.alias = alias
        self.columns = list(columns)
        # bind-time ColumnMeta snapshot: planning holds no MDL, so a
        # concurrent DROP COLUMN can remove a name from the live catalog
        # between Scan construction and a later fields() call — resolving
        # through the snapshot keeps the plan self-consistent (pruning will
        # drop the unreferenced lane anyway)
        self._col_meta: Dict[str, Any] = dict(col_meta or {})
        self.children = []
        # filled by the pruning pass; None = all partitions
        self.partitions: Optional[List[int]] = None
        self.as_of: Optional[int] = None  # flashback snapshot TSO (AS OF TSO)
        # advisory column-vs-literal conjuncts in LANE domain, extracted by the
        # pruning pass: (table_column, op, lane_value); archive scans use them
        # for parquet min-max file pruning (SARG analog); the Filter above the
        # scan still applies, so sargs are never load-bearing for correctness
        self.sargs: List[Tuple[str, str, Any]] = []
        # index access path (DirectShardingKeyTableOperation / XPlan key-Get
        # analog, Planner.java:914): (table_column, lane_value) equality on an
        # indexed column — the physical scan reads index candidates instead of
        # full lanes.  Advisory like sargs: the Filter above re-verifies.
        self.point_eq: Optional[Tuple[str, Any]] = None
        # runtime-filter consumer edges (exec/runtime_filter.RuntimeFilterTarget)
        # planted by plan_runtime_filters: probe-side join filters applied at
        # the scan (the join above re-verifies, so these prune, never decide)
        self.rf_targets: List[Any] = []

    def column_meta(self, col: str):
        """ColumnMeta for a scan column — the bind-time snapshot when one was
        taken, the live catalog otherwise (rule-built scans)."""
        cm = self._col_meta.get(col)
        if cm is None:
            cm = self.table.column(col)
            self._col_meta[col] = cm
        return cm

    def fields(self) -> List[Field]:
        out = []
        for out_id, col in self.columns:
            cm = self.column_meta(col)
            out.append((out_id, cm.dtype, self.table.dictionaries.get(col.lower())))
        return out

    def label(self):
        p = f" partitions={self.partitions}" if self.partitions is not None else ""
        cols = ",".join(c for _, c in self.columns)
        return f"Scan({self.table.name} as {self.alias}, [{cols}]{p})"


class Filter(RelNode):
    def __init__(self, child: RelNode, cond: ir.Expr):
        self.children = [child]
        self.cond = cond

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        return self.child.fields()

    def label(self):
        return f"Filter({self.cond!r})"


class Project(RelNode):
    def __init__(self, child: RelNode, exprs: Sequence[Tuple[str, ir.Expr]]):
        self.children = [child]
        self.exprs = list(exprs)

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        from galaxysql_tpu_torch.expr.compiler import _find_dictionary
        return [(name, e.dtype, _find_dictionary(e)) for name, e in self.exprs]

    def label(self):
        return f"Project({', '.join(n for n, _ in self.exprs)})"


class Aggregate(RelNode):
    def __init__(self, child: RelNode, groups: Sequence[Tuple[str, ir.Expr]],
                 aggs: Sequence[AggSpec]):
        self.children = [child]
        self.groups = list(groups)
        self.aggs = list(aggs)
        # skew-aware salted repartition plan (exec/skew.SaltAggPlan), planted
        # by plan/rules.plan_skew when a group key's heavy-hitter stats say a
        # plain key-hash repartition would hot-spot one shard
        self.salt_plan: Optional[Any] = None

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        from galaxysql_tpu_torch.expr.compiler import _find_dictionary
        out: List[Field] = [(n, e.dtype, _find_dictionary(e)) for n, e in self.groups]
        for a in self.aggs:
            d = _find_dictionary(a.arg) if (a.arg is not None and a.arg.dtype.is_string
                                            and a.kind in ("min", "max")) else None
            out.append((a.out_id, a.dtype, d))
        return out

    def label(self):
        gs = ",".join(n for n, _ in self.groups)
        as_ = ",".join(f"{a.kind}({'' if a.arg is None else a.arg!r})" for a in self.aggs)
        return f"Aggregate(by=[{gs}], aggs=[{as_}])"


class Join(RelNode):
    """Equi-join with optional residual.  kind: inner|left|semi|anti|cross.

    For semi/anti, output fields are the LEFT side only (left = probe/outer side)."""

    def __init__(self, left: RelNode, right: RelNode, kind: str,
                 equi: Sequence[Tuple[ir.Expr, ir.Expr]],
                 residual: Optional[ir.Expr] = None):
        self.children = [left, right]
        self.kind = kind
        self.equi = list(equi)
        self.residual = residual
        # scalar cross join (uncorrelated scalar subquery): exactly-one-row build
        self.scalar = False
        # runtime-filter producer edges (exec/runtime_filter.RuntimeFilterPlan):
        # equi pairs whose build side publishes a bloom/min-max filter
        self.rf_plans: List[Any] = []
        # skew-aware hybrid-join plans (exec/skew.SkewJoinPlan), one per probe
        # direction whose key column has heavy hitters; the executor activates
        # only the direction matching its actual probe side (rf_plans stance)
        self.skew_plans: List[Any] = []

    @property
    def left(self) -> RelNode:
        return self.children[0]

    @property
    def right(self) -> RelNode:
        return self.children[1]

    def fields(self) -> List[Field]:
        if self.kind in ("semi", "anti"):
            return self.left.fields()
        right = self.right.fields()
        if self.kind == "left":
            right = [(n, t.with_nullable(True), d) for n, t, d in right]
        return self.left.fields() + right

    def label(self):
        eq = ", ".join(f"{l!r}={r!r}" for l, r in self.equi)
        res = f" residual={self.residual!r}" if self.residual is not None else ""
        return f"Join({self.kind}, [{eq}]{res})"


@dataclasses.dataclass
class WindowCall:
    kind: str                  # row_number|rank|dense_rank|sum|count|avg|min|max|
                               # lag|lead|first_value|last_value
    arg: Optional[ir.Expr]
    out_id: str
    offset: int = 1            # lag/lead
    frame: str = "range"       # running | range | whole

    @property
    def dtype(self) -> dt.DataType:
        if self.kind in ("row_number", "rank", "dense_rank", "count"):
            return dt.BIGINT
        from galaxysql_tpu_torch.exec.operators import AggCall
        if self.kind in ("sum", "avg", "min", "max"):
            return AggCall(self.kind, self.arg, self.out_id).dtype
        return self.arg.dtype  # lag/lead/first/last


class Window(RelNode):
    """Window functions over sorted partitions (OverWindowFramesExec analog, §2.6)."""

    def __init__(self, child: RelNode, partitions: Sequence[ir.Expr],
                 orders: Sequence[Tuple[ir.Expr, bool]],
                 calls: Sequence[WindowCall]):
        self.children = [child]
        self.partitions = list(partitions)
        self.orders = list(orders)
        self.calls = list(calls)

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        from galaxysql_tpu_torch.expr.compiler import _find_dictionary
        out = list(self.child.fields())
        for c in self.calls:
            d = _find_dictionary(c.arg) if (c.arg is not None and
                                            c.arg.dtype.is_string) else None
            out.append((c.out_id, c.dtype, d))
        return out

    def label(self):
        ps = ",".join(repr(p) for p in self.partitions)
        cs = ",".join(c.kind for c in self.calls)
        return f"Window(by=[{ps}], calls=[{cs}])"


class Sort(RelNode):
    def __init__(self, child: RelNode, keys: Sequence[Tuple[ir.Expr, bool]],
                 limit: Optional[int] = None, offset: int = 0):
        self.children = [child]
        self.keys = list(keys)
        self.limit = limit
        self.offset = offset

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        return self.child.fields()

    def label(self):
        ks = ", ".join(f"{e!r}{' desc' if d else ''}" for e, d in self.keys)
        lim = f" limit={self.limit}" if self.limit is not None else ""
        return f"Sort([{ks}]{lim})"


class Limit(RelNode):
    def __init__(self, child: RelNode, limit: int, offset: int = 0):
        self.children = [child]
        self.limit = limit
        self.offset = offset

    @property
    def child(self) -> RelNode:
        return self.children[0]

    def fields(self) -> List[Field]:
        return self.child.fields()

    def label(self):
        return f"Limit({self.limit} offset {self.offset})"


class Union(RelNode):
    def __init__(self, children: Sequence[RelNode], all_: bool):
        self.children = list(children)
        self.all = all_

    def fields(self) -> List[Field]:
        return self.children[0].fields()

    def label(self):
        return f"Union(all={self.all})"


class Values(RelNode):
    """Literal rows (INSERT ... VALUES, SELECT without FROM)."""

    def __init__(self, schema: Sequence[Field], rows: List[List[Any]]):
        self.children = []
        self.schema = list(schema)
        self.rows = rows

    def fields(self) -> List[Field]:
        return self.schema

    def label(self):
        return f"Values({len(self.rows)} rows)"


def walk(node: RelNode):
    yield node
    for c in node.children:
        yield from walk(c)


def explain(node: RelNode) -> str:
    return "\n".join(node.explain_lines())
