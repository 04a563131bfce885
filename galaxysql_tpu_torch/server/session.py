"""Session: statement dispatch (trimmed port of `galaxysql_tpu/server/session.py`).

Handles CREATE DATABASE, USE, CREATE TABLE and SELECT.  A SELECT goes parse -> bind ->
optimise -> plan on the host (the planner and its plan cache), then through the
operator tree on the instance's device; the compacted result batch comes back as
rows.  Every query runs on the instance's device: the reference's pinning of point
queries to the host CPU is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from galaxysql_tpu_torch.exec.operators import run_to_batch
from galaxysql_tpu_torch.meta.catalog import (ColumnMeta, IndexMeta, PartitionInfo,
                                              SINGLE, TableMeta)
from galaxysql_tpu_torch.plan.physical import ExecContext, build_operator
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.lexer import split_statements
from galaxysql_tpu_torch.sql.parser import parse
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors


@dataclasses.dataclass
class ResultSet:
    names: List[str]
    types: List[dt.DataType]
    rows: List[Tuple]
    affected: int = 0
    last_insert_id: int = 0
    info: str = ""
    # compacted result ColumnBatch (queries only), lanes on the instance's device
    batch: Any = None

    @property
    def is_query(self) -> bool:
        return bool(self.names)


def ok(affected: int = 0, info: str = "") -> ResultSet:
    return ResultSet([], [], [], affected, 0, info)


class Session:
    _SELECT_RE = __import__("re").compile(
        r"^\s*(?:/\*.*?\*/\s*)*select\b", __import__("re").I | __import__("re").S)

    def __init__(self, instance: Instance, schema: Optional[str] = None):
        self.instance = instance
        self.conn_id = instance.allocate_conn_id()
        self.schema = schema
        self.last_trace: List[str] = []
        instance.sessions[self.conn_id] = self

    def execute(self, sql: str, params: Optional[list] = None) -> ResultSet:
        """Run statement(s); returns the LAST result."""
        results = self.execute_all(sql, params)
        return results[-1] if results else ok()

    def execute_all(self, sql: str, params: Optional[list] = None) -> List[ResultSet]:
        if ";" not in sql:
            return [self._execute_one(sql, params)] if sql.strip() else [ok()]
        stmts = split_statements(sql)
        return [self._execute_one(s, params) for s in stmts] if stmts else [ok()]

    def close(self):
        self.instance.sessions.pop(self.conn_id, None)

    def _lock_fn(self, name: str, vals: list):
        raise errors.NotSupportedError(f"{name.upper()} is not supported by this engine")

    def _execute_one(self, sql: str, params: Optional[list]) -> ResultSet:
        if self._SELECT_RE.match(sql):
            # the plan cache keys on the parameterized text and carries the AST
            return self._run_query(None, sql, params)
        return self.execute_statement(parse(sql), sql, params)

    def execute_statement(self, stmt: ast.Statement, sql: str = "",
                          params: Optional[list] = None) -> ResultSet:
        if isinstance(stmt, (ast.Select, ast.SetOpSelect)):
            return self._run_query(stmt, sql, params)
        if isinstance(stmt, ast.CreateTable):
            return self._run_create_table(stmt)
        if isinstance(stmt, ast.CreateDatabase):
            self.instance.catalog.create_schema(stmt.name, stmt.if_not_exists)
            return ok()
        if isinstance(stmt, ast.UseDb):
            self.instance.catalog.schema(stmt.name)  # validates
            self.schema = stmt.name
            return ok()
        raise errors.NotSupportedError(f"statement {type(stmt).__name__}")

    def _require_schema(self) -> str:
        if not self.schema:
            raise errors.TddlError("No database selected")
        return self.schema

    def _run_query(self, stmt, sql: str, params: Optional[list]) -> ResultSet:
        schema = self._require_schema()
        planner = self.instance.planner
        if sql:
            plan = planner.plan_select(sql, schema, params, self)
        else:
            plan = planner.bind_statement(stmt, schema, params or [], self)
        ctx = ExecContext(self.instance.stores, self.instance.tso.next_timestamp(),
                          self.instance.device, self.instance.device_cache,
                          params=params or [], hints=getattr(plan, "hints", None))
        batch = run_to_batch(build_operator(plan.rel, ctx)).compact()
        rows = batch.to_pylist()
        self.last_trace = ctx.trace
        return ResultSet(plan.display_names, [t for _, t, _ in plan.fields()], rows,
                         batch=batch)

    def _run_create_table(self, stmt: ast.CreateTable) -> ResultSet:
        schema = stmt.name.schema or self._require_schema()
        if stmt.like is not None:
            src = self.instance.catalog.table(stmt.like.schema or schema,
                                              stmt.like.table)
            tm = TableMeta(schema, stmt.name.table, src.columns, src.primary_key,
                           src.partition, src.indexes)
        else:
            cols = []
            pk = list(stmt.primary_key)
            for cd in stmt.columns:
                typ = dt.from_sql_name(
                    cd.type_name + (" UNSIGNED" if cd.unsigned else ""),
                    cd.precision, cd.scale)
                default = None
                if cd.default is not None and not isinstance(cd.default, ast.NullLit):
                    default = _ast_literal_value(cd.default)
                cols.append(ColumnMeta(cd.name, typ, cd.nullable and not cd.primary_key,
                                       default, cd.auto_increment, cd.comment))
                if cd.primary_key:
                    pk.append(cd.name)
            part = _partition_info(stmt, cols)
            indexes = [IndexMeta(i.name or f"i_{k}", i.columns, i.unique,
                                 i.global_index, i.covering)
                       for k, i in enumerate(stmt.indexes) if i.columns]
            tm = TableMeta(schema, stmt.name.table, cols, pk, part, indexes,
                           stmt.comment)
        if self.instance.catalog.add_table(tm, stmt.if_not_exists):
            self.instance.register_table(tm)
        return ok()


def _partition_info(stmt: ast.CreateTable, cols: List[ColumnMeta]) -> PartitionInfo:
    if stmt.broadcast:
        return PartitionInfo("broadcast")
    if stmt.single or stmt.partition is None:
        return SINGLE
    p = stmt.partition
    colnames = []
    for e in p.exprs:
        if isinstance(e, ast.Name):
            colnames.append(e.simple)
        else:
            raise errors.NotSupportedError("partition expressions must be columns")
    boundaries = []
    by_name = {c.name.lower(): c for c in cols}
    for pname, vals in p.boundaries:
        enc = []
        for v in vals:
            if isinstance(v, ast.Name) and v.simple.upper() == "MAXVALUE":
                enc.append(None)
            else:
                lit = _ast_literal_value(v)
                cm = by_name.get(colnames[0].lower())
                from galaxysql_tpu_torch.meta.catalog import encode_partition_value
                enc.append(encode_partition_value(lit, cm.dtype) if cm else lit)
        boundaries.append((pname, enc))
    count = p.count or (len(boundaries) if boundaries else 8)
    return PartitionInfo(p.method, colnames, count, boundaries)


def _ast_literal_value(e: ast.ExprNode):
    if isinstance(e, ast.NumberLit):
        return e.value
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.BoolLit):
        return 1 if e.value else 0
    if isinstance(e, ast.Unary) and e.op == "-":
        return -_ast_literal_value(e.arg)
    if isinstance(e, ast.Func):
        return str(e.name)
    if isinstance(e, ast.DateLit):
        return e.value
    raise errors.NotSupportedError("expected literal value")
