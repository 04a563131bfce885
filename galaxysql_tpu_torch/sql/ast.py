"""Parse-level AST (unbound, untyped).

Reference analog: the Druid AST produced by `MySqlStatementParser` (SURVEY.md §2.3).  The
binder (`plan/binder.py`) resolves this against the catalog into the typed expression IR +
logical plan, playing the role of the reference's FastsqlParser→Calcite SqlNode conversion +
validator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union


class Node:
    pass


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

class ExprNode(Node):
    pass


@dataclasses.dataclass
class Name(ExprNode):
    parts: List[str]             # [col] | [table, col] | [db, table, col]

    @property
    def simple(self) -> str:
        return self.parts[-1]

    def __str__(self):
        return ".".join(self.parts)


@dataclasses.dataclass
class Star(ExprNode):
    qualifier: Optional[List[str]] = None   # t.* has qualifier [t]


@dataclasses.dataclass
class NumberLit(ExprNode):
    text: str

    @property
    def value(self) -> Union[int, float]:
        t = self.text
        if "." in t or "e" in t.lower():
            return float(t)
        return int(t)


@dataclasses.dataclass
class StringLit(ExprNode):
    value: str


@dataclasses.dataclass
class NullLit(ExprNode):
    pass


@dataclasses.dataclass
class BoolLit(ExprNode):
    value: bool


@dataclasses.dataclass
class ParamRef(ExprNode):
    index: int                   # 0-based placeholder position


@dataclasses.dataclass
class IntervalLit(ExprNode):
    value: ExprNode
    unit: str                    # DAY | MONTH | YEAR | HOUR | MINUTE | SECOND | WEEK


@dataclasses.dataclass
class DateLit(ExprNode):
    """DATE 'yyyy-mm-dd' / TIMESTAMP '...' keyword literals (TPC-H style)."""
    value: str
    kind: str                    # date | timestamp | time


@dataclasses.dataclass
class Unary(ExprNode):
    op: str                      # - | ~ | ! | not
    arg: ExprNode


@dataclasses.dataclass
class Binary(ExprNode):
    op: str                      # + - * / % div mod = != <> < <= > >= and or xor || & | ^ << >>
    left: ExprNode
    right: ExprNode


@dataclasses.dataclass
class Func(ExprNode):
    name: str
    args: List[ExprNode]
    distinct: bool = False
    star: bool = False           # COUNT(*)


@dataclasses.dataclass
class CaseExpr(ExprNode):
    operand: Optional[ExprNode]
    whens: List[Tuple[ExprNode, ExprNode]]
    else_: Optional[ExprNode]


@dataclasses.dataclass
class CastExpr(ExprNode):
    arg: ExprNode
    type_name: str
    precision: int = 0
    scale: int = 0


@dataclasses.dataclass
class SubqueryExpr(ExprNode):
    select: "Select"


@dataclasses.dataclass
class ExistsExpr(ExprNode):
    select: "Select"
    negated: bool = False


@dataclasses.dataclass
class InExpr(ExprNode):
    arg: ExprNode
    items: Optional[List[ExprNode]]       # literal list …
    select: Optional["Select"] = None     # … or subquery
    negated: bool = False


@dataclasses.dataclass
class BetweenExpr(ExprNode):
    arg: ExprNode
    low: ExprNode
    high: ExprNode
    negated: bool = False


@dataclasses.dataclass
class Collate(ExprNode):
    """expr COLLATE name: comparison/grouping under an explicit collation."""
    arg: "ExprNode"
    name: str


@dataclasses.dataclass
class LikeExpr(ExprNode):
    arg: ExprNode
    pattern: ExprNode
    negated: bool = False


@dataclasses.dataclass
class IsNullExpr(ExprNode):
    arg: ExprNode
    negated: bool = False


@dataclasses.dataclass
class WindowExpr(ExprNode):
    func: "Func"
    partition_by: List[ExprNode]
    order_by: List[Tuple[ExprNode, bool]]
    # (unit 'rows'|'range', start 'unbounded', end 'current'|'unbounded_following')
    frame: Optional[Tuple[str, str, str]] = None


@dataclasses.dataclass
class ExtractExpr(ExprNode):
    unit: str
    arg: ExprNode


# ---------------------------------------------------------------------------
# relations
# ---------------------------------------------------------------------------

class TableExpr(Node):
    pass


@dataclasses.dataclass
class TableName(TableExpr):
    parts: List[str]             # [table] | [db, table]
    alias: Optional[str] = None
    as_of: Optional[int] = None  # flashback: AS OF TSO <n> snapshot read

    @property
    def table(self) -> str:
        return self.parts[-1]

    @property
    def schema(self) -> Optional[str]:
        return self.parts[-2] if len(self.parts) > 1 else None


@dataclasses.dataclass
class SubqueryRef(TableExpr):
    select: "Select"
    alias: str


@dataclasses.dataclass
class Join(TableExpr):
    kind: str                    # inner | left | right | full | cross
    left: TableExpr
    right: TableExpr
    on: Optional[ExprNode] = None
    using: Optional[List[str]] = None


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------

class Statement(Node):
    # head hint comment text (/*+TDDL: ... */), parsed lazily by sql/hints.py
    hints: "Optional[str]" = None


@dataclasses.dataclass
class SelectItem(Node):
    expr: ExprNode
    alias: Optional[str] = None


@dataclasses.dataclass
class Cte(Node):
    """One WITH item: name [(columns)] AS (select)."""
    name: str
    columns: Optional[List[str]]
    select: "Statement"


@dataclasses.dataclass
class Select(Statement):
    items: List[SelectItem]
    from_: Optional[TableExpr] = None
    where: Optional[ExprNode] = None
    group_by: List[ExprNode] = dataclasses.field(default_factory=list)
    having: Optional[ExprNode] = None
    order_by: List[Tuple[ExprNode, bool]] = dataclasses.field(default_factory=list)  # (e, desc)
    limit: Optional[ExprNode] = None
    offset: Optional[ExprNode] = None
    distinct: bool = False
    for_update: bool = False
    ctes: List[Cte] = dataclasses.field(default_factory=list)
    group_modifier: Optional[str] = None       # 'rollup' | 'cube'
    grouping_sets: Optional[List[List[ExprNode]]] = None


@dataclasses.dataclass
class SetOpSelect(Statement):
    """UNION [ALL] chains."""
    op: str                      # union | union_all
    left: Statement
    right: Statement
    order_by: List[Tuple[ExprNode, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[ExprNode] = None
    offset: Optional[ExprNode] = None
    ctes: List[Cte] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Insert(Statement):
    table: TableName
    columns: Optional[List[str]]
    rows: Optional[List[List[ExprNode]]] = None
    select: Optional[Select] = None
    ignore: bool = False
    on_dup_update: Optional[List[Tuple[Name, ExprNode]]] = None
    replace: bool = False


@dataclasses.dataclass
class Update(Statement):
    table: TableExpr
    sets: List[Tuple[Name, ExprNode]]
    where: Optional[ExprNode] = None
    order_by: List[Tuple[ExprNode, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[ExprNode] = None


@dataclasses.dataclass
class Delete(Statement):
    table: TableName
    where: Optional[ExprNode] = None
    order_by: List[Tuple[ExprNode, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[ExprNode] = None


@dataclasses.dataclass
class ColumnDef(Node):
    name: str
    type_name: str
    precision: int = 0
    scale: int = 0
    unsigned: bool = False
    nullable: bool = True
    default: Optional[ExprNode] = None
    auto_increment: bool = False
    primary_key: bool = False
    comment: Optional[str] = None


@dataclasses.dataclass
class IndexDef(Node):
    name: Optional[str]
    columns: List[str]
    unique: bool = False
    global_index: bool = False   # GSI (PolarDB-X GLOBAL INDEX extension)
    covering: List[str] = dataclasses.field(default_factory=list)
    partition: Optional["PartitionDef"] = None


@dataclasses.dataclass
class PartitionDef(Node):
    method: str                  # hash | key | range | range_columns | list | list_columns
    exprs: List[ExprNode]
    count: int = 0               # PARTITIONS n (hash/key)
    # range/list boundaries: [(name, values)]
    boundaries: List[Tuple[str, List[ExprNode]]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CreateTable(Statement):
    name: TableName
    columns: List[ColumnDef]
    primary_key: List[str] = dataclasses.field(default_factory=list)
    indexes: List[IndexDef] = dataclasses.field(default_factory=list)
    if_not_exists: bool = False
    partition: Optional[PartitionDef] = None
    single: bool = False         # PolarDB-X: unpartitioned, one shard
    broadcast: bool = False      # PolarDB-X: replicated to every shard
    comment: Optional[str] = None
    like: Optional[TableName] = None


@dataclasses.dataclass
class AlterTable(Statement):
    table: TableName
    # actions: ("add_column", ColumnDef, after|None) | ("drop_column", name)
    #        | ("add_index", IndexDef) | ("drop_index", name) | ("rename", new_name)
    #        | ("modify_column", ColumnDef)
    #        | ("split_partition", pid, at_literal|None, into)
    #        | ("merge_partitions", pid_a, pid_b)
    #        | ("move_partition", pid, group)
    actions: List[Tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Rebalance(Statement):
    """REBALANCE TABLE t | REBALANCE DATABASE [s]: run the heat-driven
    balancer synchronously and return its decisions (server/balancer.py)."""
    schema: Optional[str] = None
    table: Optional[str] = None
    dry_run: bool = False


@dataclasses.dataclass
class DropTable(Statement):
    names: List[TableName]
    if_exists: bool = False


@dataclasses.dataclass
class TruncateTable(Statement):
    name: TableName


@dataclasses.dataclass
class CreateView(Statement):
    name: TableName
    columns: Optional[List[str]]
    select: Statement
    select_sql: str              # original SELECT text, persisted in the metadb
    or_replace: bool = False


@dataclasses.dataclass
class DropView(Statement):
    names: List[TableName]
    if_exists: bool = False


@dataclasses.dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclasses.dataclass
class DropDatabase(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class UseDb(Statement):
    name: str


@dataclasses.dataclass
class SetStmt(Statement):
    # (scope 'session'|'global'|'user', name, value-expr)
    assignments: List[Tuple[str, str, ExprNode]]


@dataclasses.dataclass
class Show(Statement):
    kind: str                    # databases | tables | columns | variables | create_table | ...
    target: Optional[str] = None
    like: Optional[str] = None
    where: Optional[ExprNode] = None
    full: bool = False
    # SHOW CLUSTER <X>: merge per-peer rollups via the health sync action
    # (statement_summary / metrics handlers; cluster_health is always cluster)
    cluster: bool = False


@dataclasses.dataclass
class Explain(Statement):
    stmt: Statement
    analyze: bool = False


@dataclasses.dataclass
class BaselineStmt(Statement):
    """SPM DAL: BASELINE EVOLVE | BASELINE DELETE <id> (PlanManager DAL)."""
    action: str                       # evolve | delete
    baseline_id: Optional[int] = None


@dataclasses.dataclass
class Describe(Statement):
    table: TableName


@dataclasses.dataclass
class Begin(Statement):
    pass


@dataclasses.dataclass
class Commit(Statement):
    pass


@dataclasses.dataclass
class Rollback(Statement):
    pass


@dataclasses.dataclass
class AnalyzeTable(Statement):
    names: List[TableName]


@dataclasses.dataclass
class CheckTable(Statement):
    """CHECK TABLE t1[, t2]: store integrity + base<->GSI consistency
    (executor/corrector/Checker.java analog)."""
    names: List[TableName]


@dataclasses.dataclass
class FlashbackTable(Statement):
    """FLASHBACK TABLE t TO BEFORE DROP [RENAME TO x] (recycle-bin restore)."""
    name: TableName
    rename_to: Optional[str] = None


@dataclasses.dataclass
class PurgeRecycleBin(Statement):
    """PURGE RECYCLEBIN (all) or PURGE TABLE <recycle-name> (one)."""
    name: Optional[str] = None


@dataclasses.dataclass
class AdviseIndex(Statement):
    """ADVISE INDEX <select>: suggest GSIs for the statement's predicates
    (optimizer/index advisor analog)."""
    select: Statement


@dataclasses.dataclass
class CreateIndex(Statement):
    index: IndexDef
    table: TableName


@dataclasses.dataclass
class DropIndex(Statement):
    name: str
    table: TableName


@dataclasses.dataclass
class LoadData(Statement):
    path: str
    table: TableName
    local: bool = False
    columns: Optional[List[str]] = None
    field_terminator: str = "\t"
    enclosed_by: Optional[str] = None
    line_terminator: str = "\n"
    ignore_lines: int = 0


@dataclasses.dataclass
class CreateUser(Statement):
    user: str
    password: str = ""
    if_not_exists: bool = False


@dataclasses.dataclass
class DropUser(Statement):
    user: str
    if_exists: bool = False


@dataclasses.dataclass
class GrantStmt(Statement):
    privileges: List[str]        # ["ALL"] or ["SELECT", "INSERT", ...]
    schema: str                  # "*" for global
    table: str                   # "*" for schema-wide
    user: str


@dataclasses.dataclass
class RevokeStmt(Statement):
    privileges: List[str]
    schema: str
    table: str
    user: str


@dataclasses.dataclass
class CreateCclRule(Statement):
    """CREATE CCL_RULE name WITH MAX_CONCURRENCY = n [, KEYWORD = 's']
    [, USER = 'u'] [, WAIT_QUEUE_SIZE = n] [, WAIT_TIMEOUT = ms] —
    SQL-managed concurrency-control rules (utils/ccl.py GLOBAL_CCL)."""
    name: str
    max_concurrency: int
    keyword: Optional[str] = None
    user: Optional[str] = None
    wait_queue_size: int = 64
    wait_timeout_ms: int = 10_000
    if_not_exists: bool = False


@dataclasses.dataclass
class DropCclRule(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateSlo(Statement):
    """CREATE SLO name WITH TARGET_P99_MS = n | ERROR_RATIO = r
    [, SCHEMA = 's'] [, CLASS = 'TP'|'AP'] — declarative service
    objectives judged by the burn-rate engine (server/slo.py)."""
    name: str
    p99_ms: Optional[float] = None
    error_ratio: Optional[float] = None
    schema: Optional[str] = None
    workload: Optional[str] = None
    if_not_exists: bool = False


@dataclasses.dataclass
class DropSlo(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class KillStmt(Statement):
    conn_id: int
    query_only: bool = False
