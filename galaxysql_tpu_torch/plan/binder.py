"""Binder: parse AST -> typed logical plan.

Reference analog: validation + SqlNode->RelNode conversion (`TddlSqlToRelConverter`,
SURVEY.md §2.5) including the subquery transformations the reference gets from Calcite
rules.  Subqueries are decorrelated at bind time:

- `x IN (SELECT ...)`            -> semi join        (`NOT IN` -> anti join)
- `EXISTS (SELECT ... WHERE corr)` -> semi join on the correlated equalities, remaining
                                       correlated predicates become the join residual
- `expr CMP (SELECT agg ... WHERE corr)` -> inner join against the subquery re-grouped by
                                       its correlation keys (Q2/Q17/Q20 pattern)
- uncorrelated scalar subquery   -> cross join with the 1-row aggregate (Q11/Q15/Q22)

Column identity: every base column gets the id "<alias>.<column>"; derived/aggregate
outputs get their output names (qualified by the derived alias).  All ir.ColRef names in
the plan use these ids.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Dictionary
from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.expr.compiler import _find_dictionary
from galaxysql_tpu_torch.meta.catalog import Catalog, TableMeta
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.rules import conjuncts as _conjuncts
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal
from galaxysql_tpu_torch.utils import errors

_AGG_FUNCS = {"sum", "count", "avg", "min", "max"}

_SCALAR_FUNC_OPS = {
    "year": "year", "month": "month", "dayofmonth": "dayofmonth", "day": "dayofmonth",
    "quarter": "quarter", "abs": "abs", "coalesce": "coalesce", "ifnull": "ifnull",
    "if": "if", "least": "least", "greatest": "greatest", "datediff": "datediff",
    "mod": "mod",
}


class Scope:
    """Name-resolution scope: an ordered set of (alias -> fields), with an optional
    parent scope for correlated subqueries."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.entries: List[Tuple[str, List[L.Field]]] = []
        self.parent = parent
        # correlated references collected while binding a subquery: (outer ColRef)
        self.correlated: List[ir.ColRef] = []

    def add(self, alias: str, fields: List[L.Field]):
        if any(a == alias.lower() for a, _ in self.entries):
            raise errors.TddlError(f"Not unique table/alias: '{alias}'")
        self.entries.append((alias.lower(), fields))

    def all_fields(self) -> List[L.Field]:
        return [f for _, fs in self.entries for f in fs]

    def resolve(self, parts: List[str]) -> Optional[ir.ColRef]:
        if len(parts) == 1:
            col = parts[0].lower()
            hits = []
            for alias, fs in self.entries:
                for fid, typ, d in fs:
                    base = fid.split(".")[-1].lower()
                    if base == col:
                        hits.append(ir.ColRef(fid, typ, d))
            if len(hits) > 1:
                # identical id means same physical column via different paths
                if len({h.name for h in hits}) > 1:
                    raise errors.AmbiguousColumnError(
                        f"Column '{parts[0]}' in field list is ambiguous")
            if hits:
                return hits[0]
            return None
        alias = parts[-2].lower()
        col = parts[-1].lower()
        for a, fs in self.entries:
            if a != alias:
                continue
            for fid, typ, d in fs:
                if fid.split(".")[-1].lower() == col:
                    return ir.ColRef(fid, typ, d)
            return None
        return None

    def resolve_or_correlate(self, parts: List[str]) -> ir.ColRef:
        r = self.resolve(parts)
        if r is not None:
            return r
        if self.parent is not None:
            outer = self.parent.resolve_or_correlate(parts)
            self.correlated.append(outer)
            return outer
        raise errors.UnknownColumnError(f"Unknown column '{'.'.join(parts)}'")


class Binder:
    def __init__(self, catalog: Catalog, default_schema: str,
                 params: Optional[List] = None):
        self.catalog = catalog
        self.default_schema = default_schema
        self.params = params or []
        self._ids = itertools.count()
        # session hooks (sequences, connection id) — set by the caller when available
        self.sequence_hook = None
        self.connection_id = None
        self.lock_fn_hook = None  # (fn_name, args) -> int|None (GET_LOCK family)
        # CTE scopes: a stack of {name: ast.Cte}; bodies re-bind per reference
        # (fresh column ids per occurrence, like the reference's view expansion)
        self._ctes: List[Dict[str, ast.Cte]] = []
        self._cte_in_progress: set = set()
        self._views_in_progress: set = set()

    def fresh(self, prefix: str) -> str:
        return f"{prefix}${next(self._ids)}"

    # --------------------------------------------------------------- queries

    def bind_query(self, stmt: ast.Statement,
                   scope_parent: Optional[Scope] = None
                   ) -> Tuple[L.RelNode, List[str]]:
        """Bind a SELECT or a UNION chain (the statement-level entry point)."""
        if isinstance(stmt, ast.Select):
            rel, names, _ = self.bind_select(stmt, scope_parent)
            return rel, names
        assert isinstance(stmt, ast.SetOpSelect)
        pushed = bool(stmt.ctes)
        if pushed:
            self._ctes.append({c.name.lower(): c for c in stmt.ctes})
        try:
            parts: List[Tuple[L.RelNode, List[str]]] = []

            def flatten(s):
                if isinstance(s, ast.SetOpSelect) and not s.ctes and \
                        s.op == stmt.op:
                    flatten(s.left)
                    flatten(s.right)
                else:
                    parts.append(self.bind_query(s, scope_parent))
            flatten(stmt.left)
            flatten(stmt.right)
            rels = [r for r, _ in parts]
            names = parts[0][1]
            node: L.RelNode = L.Union(rels, stmt.op == "union_all")
            if stmt.order_by:
                node = self._bind_union_order(node, stmt, names)
            if stmt.limit is not None:
                off = self._limit_value(stmt.offset) if stmt.offset else 0
                if isinstance(node, L.Sort):
                    node.limit = self._limit_value(stmt.limit)
                    node.offset = off
                else:
                    node = L.Limit(node, self._limit_value(stmt.limit), off)
            return node, names
        finally:
            if pushed:
                self._ctes.pop()

    def _bind_union_order(self, node: L.RelNode, stmt: ast.SetOpSelect,
                          names: List[str]) -> L.RelNode:
        """Trailing ORDER BY of a union chain: output aliases or ordinals only."""
        fields = node.fields()
        keys = []
        for e, desc in stmt.order_by:
            ref = None
            if isinstance(e, ast.NumberLit):
                ix = int(e.value) - 1
                if not (0 <= ix < len(fields)):
                    raise errors.TddlError(f"ORDER BY position {ix + 1} invalid")
                ref = fields[ix]
            elif isinstance(e, ast.Name):
                nm = e.simple.lower()
                for n, f in zip(names, fields):
                    if n.lower() == nm:
                        ref = f
                        break
            if ref is None:
                raise errors.NotSupportedError(
                    "UNION ORDER BY supports output aliases and ordinals only")
            fid, typ, d = ref
            keys.append((ir.ColRef(fid, typ, d), desc))
        return L.Sort(node, keys)

    # ------------------------------------------------------------------ SELECT

    def bind_select(self, sel: ast.Select, scope_parent: Optional[Scope] = None
                    ) -> Tuple[L.RelNode, List[str], Scope]:
        """Returns (plan, output display names, the FROM scope used)."""
        if sel.ctes:
            self._ctes.append({c.name.lower(): c for c in sel.ctes})
            try:
                return self._bind_select_body(sel, scope_parent)
            finally:
                self._ctes.pop()
        return self._bind_select_body(sel, scope_parent)

    def _bind_select_body(self, sel: ast.Select,
                          scope_parent: Optional[Scope] = None
                          ) -> Tuple[L.RelNode, List[str], Scope]:
        scope = Scope(scope_parent)
        if sel.from_ is None:
            # SELECT without FROM: one anonymous row
            node: L.RelNode = L.Values([], [[]])
        else:
            node = self._bind_from(sel.from_, scope)

        if sel.where is not None:
            node = self._apply_where(node, sel.where, scope)

        # aggregate analysis
        agg_calls: List[Tuple[ast.Func, L.AggSpec]] = []
        has_agg = bool(sel.group_by) or self._contains_agg(sel)

        display_names: List[str] = []
        out_exprs: List[Tuple[str, ir.Expr]] = []

        # window functions (over the filtered FROM result; not combinable with
        # GROUP BY in this round)
        win_rep: Dict[int, ir.Expr] = {}
        if any(isinstance(n, ast.WindowExpr)
               for i in sel.items for n in _ast_walk(i.expr)):
            if has_agg:
                raise errors.NotSupportedError(
                    "window functions combined with GROUP BY not supported yet")
            node, win_rep = self._bind_windows(node, sel, scope)

        if has_agg:
            node, out_exprs, display_names = self._bind_aggregate(node, sel, scope)
        else:
            # plain select list (scalar subqueries attach as joins, like WHERE)
            items = self._expand_stars(sel.items, scope)
            for item in items:
                if self._has_scalar_subquery(item.expr):
                    node, e = self._bind_with_scalar_subquery(
                        node, item.expr, scope, seed_rep=win_rep)
                else:
                    e = self._bind_expr(item.expr, scope, dict(win_rep))
                name = item.alias or self._display_name(item.expr)
                out_id = name if "." not in name else name.split(".")[-1]
                out_exprs.append((self.fresh(out_id), e))
                display_names.append(out_id)

            if sel.distinct:
                groups = [(oid, e) for oid, e in out_exprs]
                node = L.Aggregate(node, groups, [])
                out_exprs = [(oid, ir.ColRef(oid, e.dtype, _find_dictionary(e)))
                             for oid, e in groups]
            # ORDER BY for non-agg query binds against select aliases then scope
            if sel.order_by:
                node = self._bind_order(node, sel, scope, out_exprs, display_names,
                                        project_first=True)
                out_exprs = [(oid, ir.ColRef(oid, e.dtype, _find_dictionary(e)))
                             for oid, e in out_exprs]
            else:
                node = L.Project(node, out_exprs)
                out_exprs = [(oid, ir.ColRef(oid, e.dtype, _find_dictionary(e)))
                             for oid, e in out_exprs]
            node = self._apply_limit(node, sel)
            return node, display_names, scope

        # aggregate path: out_exprs reference agg/group outputs
        if sel.order_by:
            node = self._bind_order_agg(node, sel, out_exprs, display_names)
        else:
            node = L.Project(node, out_exprs)
        node = self._apply_limit(node, sel)
        return node, display_names, scope

    # -- FROM ----------------------------------------------------------------

    def _bind_from(self, t: ast.TableExpr, scope: Scope) -> L.RelNode:
        if isinstance(t, ast.TableName):
            if t.schema is None:
                cte = self._lookup_cte(t.table)
                if cte is not None:
                    if t.as_of is not None:
                        # silent wrong-snapshot results are worse than refusal
                        raise errors.NotSupportedError(
                            "AS OF TSO on a CTE reference")
                    return self._bind_cte_ref(cte, t, scope)
            schema = t.schema or self.default_schema
            view = self.catalog.view(schema, t.table)
            if view is not None:
                if t.as_of is not None:
                    raise errors.NotSupportedError("AS OF TSO on a view")
                return self._bind_view_ref(view, t, scope)
            tm = self.catalog.table(schema, t.table)
            alias = (t.alias or t.table).lower()
            # ONE read of the live column list; the metas ride the scan so
            # fields() never re-resolves names a concurrent DDL may drop
            metas = list(tm.columns)
            cols = [(f"{alias}.{c.name}", c.name) for c in metas]
            scan = L.Scan(tm, alias, cols,
                          col_meta={c.name: c for c in metas})
            as_of = t.as_of
            if isinstance(as_of, ast.ParamRef):
                as_of = int(self.params[as_of.index])
            scan.as_of = as_of
            scope.add(alias, scan.fields())
            return scan
        if isinstance(t, ast.SubqueryRef):
            sub, names = self.bind_query(t.select, scope.parent)
            alias = t.alias.lower()
            # re-expose subquery outputs under the derived alias
            fields = sub.fields()
            renames = [(f"{alias}.{n}", ir.ColRef(fid, typ, d))
                       for n, (fid, typ, d) in zip(names, fields)]
            proj = L.Project(sub, renames)
            scope.add(alias, proj.fields())
            return proj
        if isinstance(t, ast.Join):
            left = self._bind_from(t.left, scope)
            right = self._bind_from(t.right, scope)
            return self._bind_join_expr(t, left, right, scope)
        raise errors.NotSupportedError(f"FROM item {type(t).__name__}")

    def _lookup_cte(self, name: str) -> Optional[ast.Cte]:
        key = name.lower()
        for frame in reversed(self._ctes):
            c = frame.get(key)
            if c is not None:
                return c
        return None

    def _bind_cte_ref(self, cte: ast.Cte, t: ast.TableName,
                      scope: Scope) -> L.RelNode:
        """Expand a CTE reference: the body re-binds per occurrence (fresh ids),
        exposed under the reference alias like a derived table."""
        key = id(cte)
        if key in self._cte_in_progress:
            raise errors.NotSupportedError(
                f"CTE '{cte.name}' references itself (recursion unsupported)")
        self._cte_in_progress.add(key)
        try:
            sub, names = self.bind_query(cte.select, scope.parent)
        finally:
            self._cte_in_progress.discard(key)
        if cte.columns:
            if len(cte.columns) != len(names):
                raise errors.TddlError(
                    f"CTE '{cte.name}' column list length mismatch")
            names = cte.columns
        alias = (t.alias or cte.name).lower()
        fields = sub.fields()
        renames = [(f"{alias}.{n}", ir.ColRef(fid, typ, d))
                   for n, (fid, typ, d) in zip(names, fields)]
        proj = L.Project(sub, renames)
        scope.add(alias, proj.fields())
        return proj

    def _bind_view_ref(self, view, t: ast.TableName, scope: Scope) -> L.RelNode:
        """Expand a view reference (DrdsViewExpander analog,
        `optimizer/view/DrdsViewExpander.java`): parse the stored SELECT and bind
        it as a derived table under the reference alias.  The body binds in the
        VIEW's schema (unqualified names resolve where the view was defined),
        with a cycle guard — OR REPLACE can create self/mutual references."""
        from galaxysql_tpu_torch.sql.parser import parse
        vkey = (view.schema.lower(), view.name.lower())
        if vkey in self._views_in_progress:
            raise errors.TddlError(
                f"View '{view.schema}.{view.name}' references itself "
                "(directly or through another view)")
        stmt = parse(view.sql)
        saved_schema = self.default_schema
        self._views_in_progress.add(vkey)
        self.default_schema = view.schema
        try:
            sub, names = self.bind_query(stmt)
        finally:
            self.default_schema = saved_schema
            self._views_in_progress.discard(vkey)
        if view.columns:
            if len(view.columns) != len(names):
                raise errors.TddlError(
                    f"View '{view.name}' column list length mismatch")
            names = list(view.columns)
        alias = (t.alias or view.name).lower()
        fields = sub.fields()
        renames = [(f"{alias}.{n}", ir.ColRef(fid, typ, d))
                   for n, (fid, typ, d) in zip(names, fields)]
        proj = L.Project(sub, renames)
        scope.add(alias, proj.fields())
        return proj

    def _bind_join_expr(self, t: ast.Join, left: L.RelNode, right: L.RelNode,
                        scope: Scope) -> L.RelNode:
        if t.kind == "cross":
            # comma joins: conditions live in WHERE; bind as unconditional cross,
            # the rewriter turns cross+filter into equi joins
            return L.Join(left, right, "cross", [])
        cond = None
        if t.using:
            eqs = []
            for c in t.using:
                le = self._resolve_in(left, c, scope)
                re = self._resolve_in(right, c, scope)
                eqs.append(ir.call("eq", le, re))
            cond = ir.and_(*eqs)
        elif t.on is not None:
            cond = self._bind_expr(t.on, scope)
        if t.kind == "right":
            left, right = right, left
            kind = "left"
        else:
            kind = t.kind
        if kind == "full":
            raise errors.NotSupportedError("FULL OUTER JOIN not supported")
        equi, residual, leftover = self._split_join_condition(cond, left, right)
        node = L.Join(left, right, kind, equi, residual)
        if leftover is not None:
            if kind == "left":
                raise errors.NotSupportedError(
                    "LEFT JOIN ON condition too complex to decompose")
            node = L.Filter(node, leftover)
        return node

    def _resolve_in(self, node: L.RelNode, col: str, scope: Scope) -> ir.ColRef:
        for fid, typ, d in node.fields():
            if fid.split(".")[-1].lower() == col.lower():
                return ir.ColRef(fid, typ, d)
        raise errors.UnknownColumnError(f"Unknown column '{col}' in USING")

    def _split_join_condition(self, cond: Optional[ir.Expr], left: L.RelNode,
                              right: L.RelNode):
        """Split an ON condition into (equi pairs, one-side/residual predicate, leftover).

        - a.x = b.y with sides on opposite inputs -> equi pair
        - predicates referencing only the right side -> pushed below (returned as part of
          residual for outer joins; callers may instead push into the right child)
        - anything else -> residual (inner) / leftover (needs a Filter above)
        """
        if cond is None:
            return [], None, None
        left_ids = set(left.field_ids())
        right_ids = set(right.field_ids())
        equi: List[Tuple[ir.Expr, ir.Expr]] = []
        residuals: List[ir.Expr] = []
        for c in _conjuncts(cond):
            if isinstance(c, ir.Call) and c.op == "eq":
                a, b = c.args
                ra = set(ir.referenced_columns(a))
                rb = set(ir.referenced_columns(b))
                if ra and rb and ra <= left_ids and rb <= right_ids:
                    equi.append((a, b))
                    continue
                if ra and rb and ra <= right_ids and rb <= left_ids:
                    equi.append((b, a))
                    continue
            residuals.append(c)
        residual = ir.and_(*residuals) if residuals else None
        return equi, residual, None

    # -- WHERE (incl. subquery unnesting) --------------------------------------

    def _apply_where(self, node: L.RelNode, where: ast.ExprNode, scope: Scope
                     ) -> L.RelNode:
        plain: List[ir.Expr] = []
        for conj in _ast_conjuncts(where):
            if isinstance(conj, ast.ExistsExpr):
                node = self._bind_exists(node, conj.select, conj.negated, scope)
            elif isinstance(conj, ast.Unary) and conj.op == "not" and \
                    isinstance(conj.arg, ast.ExistsExpr):
                node = self._bind_exists(node, conj.arg.select, True, scope)
            elif isinstance(conj, ast.InExpr) and conj.select is not None:
                node = self._bind_in_subquery(node, conj, scope)
            elif self._has_scalar_subquery(conj):
                node, e = self._bind_with_scalar_subquery(node, conj, scope)
                plain.append(e)
            else:
                plain.append(self._bind_expr(conj, scope))
        if plain:
            node = L.Filter(node, ir.and_(*plain))
        return node

    def _bind_exists(self, node: L.RelNode, sub: ast.Statement, negated: bool,
                     scope: Scope) -> L.RelNode:
        if not isinstance(sub, ast.Select):
            raise errors.NotSupportedError("EXISTS over a UNION is not supported")
        subscope = Scope(scope)
        # bind the subquery's FROM + WHERE only (EXISTS ignores the select list)
        inner = self._bind_from(sub.from_, subscope)
        equi: List[Tuple[ir.Expr, ir.Expr]] = []
        residuals: List[ir.Expr] = []
        filters: List[ir.Expr] = []
        outer_ids = set(node.field_ids())
        inner_ids = set(inner.field_ids())
        if sub.where is not None:
            for conj in _ast_conjuncts(sub.where):
                e = self._bind_expr(conj, subscope)
                refs = set(ir.referenced_columns(e))
                if refs <= inner_ids:
                    filters.append(e)
                    continue
                # correlated conjunct
                if isinstance(e, ir.Call) and e.op == "eq":
                    a, b = e.args
                    ra, rb = set(ir.referenced_columns(a)), set(ir.referenced_columns(b))
                    if ra <= outer_ids and rb <= inner_ids:
                        equi.append((a, b))
                        continue
                    if rb <= outer_ids and ra <= inner_ids:
                        equi.append((b, a))
                        continue
                residuals.append(e)
        if filters:
            inner = L.Filter(inner, ir.and_(*filters))
        if not equi:
            raise errors.NotSupportedError(
                "EXISTS subquery requires at least one correlated equality")
        return L.Join(node, inner, "anti" if negated else "semi", equi,
                      ir.and_(*residuals) if residuals else None)

    def _bind_in_subquery(self, node: L.RelNode, e: ast.InExpr, scope: Scope
                          ) -> L.RelNode:
        arg = self._bind_expr(e.arg, scope)
        # bind_query handles both plain SELECT and UNION chains
        sub, _names = self.bind_query(e.select, scope)
        fields = sub.fields()
        if len(fields) != 1:
            raise errors.TddlError("Operand should contain 1 column")
        fid, typ, d = fields[0]
        # NOT IN with NULLs on either side has three-valued semantics; the anti join
        # treats NULL as non-matching (documented divergence for nullable inputs)
        return L.Join(node, sub, "anti" if e.negated else "semi",
                      [(arg, ir.ColRef(fid, typ, d))], None)

    # -- scalar subqueries ------------------------------------------------------

    def _has_scalar_subquery(self, e: ast.ExprNode) -> bool:
        found = False
        for n in _ast_walk(e):
            if isinstance(n, ast.SubqueryExpr):
                found = True
        return found

    def _bind_with_scalar_subquery(self, node: L.RelNode, conj: ast.ExprNode,
                                   scope: Scope,
                                   seed_rep: Optional[Dict[int, ir.Expr]] = None
                                   ) -> Tuple[L.RelNode, ir.Expr]:
        """Rewrite an expression containing scalar subqueries into joins + plain
        expr (shared by the WHERE and SELECT-list paths)."""
        replacements: Dict[int, ir.Expr] = dict(seed_rep or {})
        for n in _ast_walk(conj):
            if isinstance(n, ast.SubqueryExpr):
                node, ref = self._attach_scalar_subquery(node, n.select, scope)
                replacements[id(n)] = ref
        e = self._bind_expr(conj, scope, replacements)
        return node, e

    def _attach_scalar_subquery(self, node: L.RelNode, sub: ast.Statement,
                                scope: Scope) -> Tuple[L.RelNode, ir.Expr]:
        if not isinstance(sub, ast.Select):
            raise errors.NotSupportedError(
                "scalar subquery over a UNION is not supported")
        plan, names, used_scope = self.bind_select(sub, scope)
        correlated = used_scope.correlated
        fields = plan.fields()
        if len(fields) != 1:
            raise errors.TddlError("Scalar subquery must return one column")
        fid, typ, d = fields[0]
        if not correlated:
            # uncorrelated: scalar cross join — exactly-one-row semantics (empty
            # result NULL-extends, >1 rows is an error at execution)
            j = L.Join(node, plan, "cross", [])
            j.scalar = True
            return j, ir.ColRef(fid, typ.with_nullable(True), d)
        # correlated scalar aggregate: re-group by correlation keys and LEFT join
        # (outer rows with no group must survive with NULL, not vanish)
        plan2, out_ref, equi = self._bind_correlated_agg(sub, scope)
        return L.Join(node, plan2, "left", equi), \
            ir.ColRef(out_ref.name, out_ref.dtype.with_nullable(True),
                      _find_dictionary(out_ref))

    def _bind_correlated_agg(self, sub: ast.Select, scope: Scope):
        """Q2/Q17/Q20 pattern: SELECT agg(expr) FROM ... WHERE corr-eqs AND local-preds."""
        if sub.group_by or sub.having or len(sub.items) != 1:
            raise errors.NotSupportedError("unsupported correlated scalar subquery shape")
        subscope = Scope(scope)
        inner = self._bind_from(sub.from_, subscope)
        inner_ids = set(inner.field_ids())
        equi_outer: List[ir.Expr] = []
        group_inner: List[ir.Expr] = []
        filters: List[ir.Expr] = []
        if sub.where is not None:
            for conj in _ast_conjuncts(sub.where):
                e = self._bind_expr(conj, subscope)
                refs = set(ir.referenced_columns(e))
                if refs <= inner_ids:
                    filters.append(e)
                    continue
                if isinstance(e, ir.Call) and e.op == "eq":
                    a, b = e.args
                    ra, rb = set(ir.referenced_columns(a)), set(ir.referenced_columns(b))
                    if ra <= inner_ids and not (rb & inner_ids):
                        group_inner.append(a)
                        equi_outer.append(b)
                        continue
                    if rb <= inner_ids and not (ra & inner_ids):
                        group_inner.append(b)
                        equi_outer.append(a)
                        continue
                raise errors.NotSupportedError(
                    "correlated subquery predicate too complex")
        if filters:
            inner = L.Filter(inner, ir.and_(*filters))
        # the single select item must be an aggregate expression
        item = sub.items[0].expr
        aggs: List[L.AggSpec] = []
        rep: Dict[int, ir.Expr] = {}
        for n in _ast_walk(item):
            if isinstance(n, ast.Func) and n.name in _AGG_FUNCS:
                arg = None if n.star else self._bind_expr(n.args[0], subscope)
                kind = "count_star" if (n.name == "count" and n.star) else n.name
                out_id = self.fresh(kind)
                spec = L.AggSpec(kind, arg, out_id)
                aggs.append(spec)
                rep[id(n)] = ir.ColRef(out_id, spec.dtype, None)
        if not aggs:
            raise errors.NotSupportedError(
                "correlated scalar subquery must be an aggregate")
        groups = [(self.fresh("ck"), g) for g in group_inner]
        agg_node = L.Aggregate(inner, groups, aggs)
        # value expression over agg outputs (e.g. 0.2 * avg(...))
        val = self._bind_expr(item, subscope, rep)
        val_id = self.fresh("sq")
        group_refs = [(gid, ir.ColRef(gid, g.dtype, _find_dictionary(g)))
                      for (gid, g) in groups]
        proj = L.Project(agg_node, group_refs + [(val_id, val)])
        equi = [(outer, ir.ColRef(gid, g.dtype, _find_dictionary(g)))
                for outer, (gid, g) in zip(equi_outer, groups)]
        return proj, ir.ColRef(val_id, val.dtype, _find_dictionary(val)), equi

    # -- window functions ---------------------------------------------------------

    _WINDOW_KINDS = {"row_number", "rank", "dense_rank", "sum", "count", "avg",
                     "min", "max", "lag", "lead", "first_value", "last_value"}

    def _bind_windows(self, node: L.RelNode, sel: ast.Select, scope: Scope):
        """One L.Window node per distinct (PARTITION BY, ORDER BY) spec; window
        expressions in the select list are replaced by output column refs."""
        groups: Dict[Tuple, Tuple[List, List, List[L.WindowCall]]] = {}
        rep: Dict[int, ir.Expr] = {}
        for item in sel.items:
            for n in _ast_walk(item.expr):
                if not isinstance(n, ast.WindowExpr):
                    continue
                fname = n.func.name
                if fname not in self._WINDOW_KINDS:
                    raise errors.NotSupportedError(f"window function {fname}()")
                parts = [self._bind_expr(p, scope) for p in n.partition_by]
                orders = [(self._bind_expr(e, scope), desc)
                          for e, desc in n.order_by]
                key = (tuple(p.key() for p in parts),
                       tuple((e.key(), d) for e, d in orders))
                if key not in groups:
                    groups[key] = (parts, orders, [])
                calls = groups[key][2]
                if n.func.distinct:
                    raise errors.NotSupportedError(
                        "DISTINCT in window aggregates is not supported")
                if n.frame is not None and n.frame[1] == "current":
                    raise errors.NotSupportedError(
                        "frames starting at CURRENT ROW are not supported yet")
                # frame semantics: SQL default with ORDER BY is RANGE ..CURRENT
                if n.frame is None:
                    frame = "range" if n.order_by else "whole"
                elif n.frame[2] == "unbounded_following":
                    frame = "whole"
                else:
                    frame = "running" if n.frame[0] == "rows" else "range"
                offset = 1
                arg = None
                if fname in ("row_number", "rank", "dense_rank"):
                    if not n.order_by:
                        raise errors.TddlError(f"{fname}() requires ORDER BY")
                elif fname == "count" and (n.func.star or not n.func.args):
                    arg = ir.lit(1)
                else:
                    if not n.func.args:
                        raise errors.TddlError(f"{fname}() needs an argument")
                    arg = self._bind_expr(n.func.args[0], scope)
                    if fname in ("lag", "lead") and len(n.func.args) > 1:
                        off = self._bind_expr(n.func.args[1], scope)
                        if not isinstance(off, ir.Literal):
                            raise errors.NotSupportedError(
                                "lag/lead offset must be a literal")
                        offset = int(off.value)
                out_id = self.fresh(fname)
                call = L.WindowCall(fname, arg, out_id, offset, frame)
                calls.append(call)
                rep[id(n)] = ir.ColRef(out_id, call.dtype,
                                       _find_dictionary(arg) if arg is not None and
                                       arg.dtype.is_string else None)
        for parts, orders, calls in groups.values():
            node = L.Window(node, parts, orders, calls)
        # window outputs become visible to ORDER BY via the select aliases only
        return node, rep

    # -- aggregation -------------------------------------------------------------

    def _contains_agg(self, sel: ast.Select) -> bool:
        exprs = [i.expr for i in sel.items]
        if sel.having is not None:
            exprs.append(sel.having)
        for e in exprs:
            # sum(x) OVER (...) is a window call, not a grouping aggregate
            win_funcs = {id(n.func) for n in _ast_walk(e)
                         if isinstance(n, ast.WindowExpr)}
            for n in _ast_walk(e):
                if isinstance(n, ast.Func) and n.name in _AGG_FUNCS and \
                        id(n) not in win_funcs:
                    return True
        return False

    def _expand_grouping_sets(self, node: L.RelNode, sel: ast.Select,
                              groups, aggs) -> L.RelNode:
        """ROLLUP/CUBE/GROUPING SETS as a UNION ALL of one Aggregate per grouping
        set over the shared child — absent keys project as typed NULLs carrying
        the column's dictionary (the extra-lexsort-pass-per-set strategy; MySQL
        WITH ROLLUP semantics: subtotal rows have NULL in rolled-up columns)."""
        n = len(groups)
        if sel.grouping_sets is not None:
            sets = self._gs_membership
        elif sel.group_modifier == "rollup":
            sets = [list(range(k)) for k in range(n, -1, -1)]
        else:  # cube
            sets = []
            for size in range(n, -1, -1):
                for comb in itertools.combinations(range(n), size):
                    sets.append(list(comb))
        branches = []
        for s in sets:
            member = set(s)
            # clone the shared child per branch: optimizer rules mutate subtrees
            # in place (column pruning), and branches prune differently
            agg_b = L.Aggregate(L.clone_tree(node), [groups[i] for i in s],
                                list(aggs))
            proj = []
            for i, (gid, ge) in enumerate(groups):
                if i in member:
                    proj.append((gid, ir.ColRef(gid, ge.dtype,
                                                _find_dictionary(ge))))
                else:
                    proj.append((gid, ir.Literal(
                        None, ge.dtype.with_nullable(True),
                        _find_dictionary(ge))))
            for a in aggs:
                d = _find_dictionary(a.arg) if (
                    a.arg is not None and a.arg.dtype.is_string and
                    a.kind in ("min", "max")) else None
                proj.append((a.out_id, ir.ColRef(a.out_id, a.dtype, d)))
            branches.append(L.Project(agg_b, proj))
        return L.Union(branches, True)

    def _bind_aggregate(self, node: L.RelNode, sel: ast.Select, scope: Scope):
        # 1. bind group keys
        groups: List[Tuple[str, ir.Expr]] = []
        group_map: Dict[Tuple, ir.ColRef] = {}
        alias_map = {i.alias.lower(): i.expr for i in sel.items if i.alias}

        def bind_group_expr(g: ast.ExprNode) -> ir.Expr:
            gexpr = g
            if isinstance(g, ast.NumberLit):
                ix = int(g.value) - 1
                if not 0 <= ix < len(sel.items):
                    raise errors.TddlError("GROUP BY ordinal out of range")
                gexpr = sel.items[ix].expr
            elif isinstance(g, ast.Name) and len(g.parts) == 1 and \
                    g.parts[0].lower() in alias_map and scope.resolve(g.parts) is None:
                gexpr = alias_map[g.parts[0].lower()]
            return self._bind_expr(gexpr, scope)

        def add_group(e: ir.Expr) -> int:
            k = e.key()
            ref = group_map.get(k)
            if ref is not None:
                return next(i for i, (gid, _) in enumerate(groups)
                            if gid == ref.name)
            gid = self.fresh("g")
            groups.append((gid, e))
            group_map[k] = ir.ColRef(gid, e.dtype, _find_dictionary(e))
            return len(groups) - 1

        self._gs_membership = None
        if sel.grouping_sets is not None:
            # GROUP BY GROUPING SETS: groups = ordered union of all set exprs;
            # remember each set's membership for the union expansion
            self._gs_membership = [
                sorted({add_group(bind_group_expr(g)) for g in s_ast})
                for s_ast in sel.grouping_sets]
        else:
            for g in sel.group_by:
                add_group(bind_group_expr(g))

        # 2. collect aggregate calls from select list + having + order by
        aggs: List[L.AggSpec] = []
        agg_map: Dict[Tuple, ir.ColRef] = {}

        def collect(e: ast.ExprNode):
            for n in _ast_walk(e):
                if isinstance(n, ast.Func) and n.name in _AGG_FUNCS:
                    arg = None if n.star else self._bind_expr(n.args[0], scope)
                    kind = "count_star" if (n.name == "count" and n.star) else n.name
                    key = (kind, arg.key() if arg is not None else None, n.distinct)
                    if key in agg_map:
                        continue
                    out_id = self.fresh(kind)
                    spec = L.AggSpec(kind, arg, out_id, n.distinct)
                    aggs.append(spec)
                    agg_map[key] = ir.ColRef(out_id, spec.dtype,
                                             _find_dictionary(arg) if arg is not None and
                                             arg.dtype.is_string else None)

        for i in sel.items:
            collect(i.expr)
        if sel.having is not None:
            # HAVING may contain uncorrelated scalar subqueries (Q11): binds later
            for conj in _ast_conjuncts(sel.having):
                if not self._has_scalar_subquery(conj):
                    collect(conj)
                else:
                    for n in _ast_walk(conj):
                        if not isinstance(n, ast.SubqueryExpr):
                            continue
                    collect(conj)
        for e, _ in sel.order_by:
            collect(e)

        # 3. DISTINCT aggregates: rewrite through a pre-aggregate on
        # (groups + distinct arg).  min/max(DISTINCT) == min/max, so their flag
        # drops.  Plain aggregates ride through the pre-aggregate as partials and
        # re-aggregate in the final pass (sum of sums / sum of counts / min of
        # mins), so ANY mix of one DISTINCT argument with plain aggregates works
        # — the reference's two-phase distinct-agg expansion without a join.
        aggs = [dataclasses.replace(a, distinct=False)
                if a.distinct and a.kind in ("min", "max") else a for a in aggs]
        distinct_aggs = [a for a in aggs if a.distinct]
        if distinct_aggs:
            bad = [a for a in distinct_aggs if a.kind not in ("count", "sum")]
            if bad:
                raise errors.NotSupportedError(
                    f"{bad[0].kind}(DISTINCT) not supported yet")
            if len({a.arg.key() for a in distinct_aggs}) > 1:
                raise errors.NotSupportedError(
                    "multiple different DISTINCT arguments in one aggregate")
            darg = distinct_aggs[0].arg
            did = self.fresh("d")
            pre_groups = list(groups) + [(did, darg)]
            pre_aggs: List[L.AggSpec] = []
            final_aggs: List[L.AggSpec] = []
            dref = ir.ColRef(did, darg.dtype, _find_dictionary(darg))
            merge_kind = {"sum": "sum", "count": "sum", "count_star": "sum",
                          "min": "min", "max": "max"}
            for a in aggs:
                if a.distinct:
                    # each pre-group holds one distinct (group, value): counting/
                    # summing the pre-group keys IS the distinct aggregate
                    final_aggs.append(L.AggSpec(a.kind, dref, a.out_id))
                    continue
                if a.kind == "avg":
                    raise errors.NotSupportedError(
                        "AVG mixed with DISTINCT aggregates not supported yet")
                pid = self.fresh(a.kind)
                pre_aggs.append(L.AggSpec(a.kind, a.arg, pid))
                pref = ir.ColRef(pid, pre_aggs[-1].dtype, None)
                final_aggs.append(L.AggSpec(merge_kind[a.kind], pref, a.out_id))
            pre = L.Aggregate(node, pre_groups, pre_aggs)
            regrouped = [(gid, ir.ColRef(gid, e.dtype, _find_dictionary(e)))
                         for gid, e in groups]
            node = L.Aggregate(pre, regrouped, final_aggs)
            groups = regrouped
            # group_map keeps the ORIGINAL group-expression keys: select items still
            # reference the source expressions, which map to the re-grouped ids
            if sel.group_modifier or sel.grouping_sets:
                raise errors.NotSupportedError(
                    "DISTINCT aggregates with ROLLUP/CUBE/GROUPING SETS")
        elif sel.group_modifier or sel.grouping_sets:
            node = self._expand_grouping_sets(node, sel, groups, aggs)
        else:
            node = L.Aggregate(node, groups, aggs)

        # helper: bind an expression in post-aggregate space
        def bind_post(e: ast.ExprNode) -> ir.Expr:
            rep: Dict[int, ir.Expr] = {}
            for n in _ast_walk(e):
                if isinstance(n, ast.Func) and n.name in _AGG_FUNCS:
                    arg = None if n.star else self._bind_expr(n.args[0], scope)
                    kind = "count_star" if (n.name == "count" and n.star) else n.name
                    key = (kind, arg.key() if arg is not None else None, n.distinct)
                    rep[id(n)] = agg_map[key]
            bound = self._bind_expr(e, scope, rep)
            return _substitute(bound, group_map)

        # 4. HAVING
        if sel.having is not None:
            having_parts = []
            for conj in _ast_conjuncts(sel.having):
                if self._has_scalar_subquery(conj):
                    node, e = self._bind_having_subquery(node, conj, scope, bind_post)
                    having_parts.append(e)
                else:
                    having_parts.append(bind_post(conj))
            node = L.Filter(node, ir.and_(*having_parts))

        # 5. select list
        out_exprs: List[Tuple[str, ir.Expr]] = []
        display_names: List[str] = []
        for item in sel.items:
            e = bind_post(item.expr)
            self._check_agg_refs(e, node)
            name = item.alias or self._display_name(item.expr)
            out_exprs.append((self.fresh(name.split(".")[-1]), e))
            display_names.append(name.split(".")[-1])
        return node, out_exprs, display_names

    def _bind_having_subquery(self, node: L.RelNode, conj: ast.ExprNode, scope: Scope,
                              bind_post) -> Tuple[L.RelNode, ir.Expr]:
        replacements: Dict[int, ir.Expr] = {}
        for n in _ast_walk(conj):
            if isinstance(n, ast.SubqueryExpr):
                if not isinstance(n.select, ast.Select):
                    raise errors.NotSupportedError(
                        "UNION subquery in HAVING not supported")
                plan, names, used = self.bind_select(n.select, scope)
                if used.correlated:
                    raise errors.NotSupportedError(
                        "correlated subquery in HAVING not supported")
                fields = plan.fields()
                fid, typ, d = fields[0]
                node = L.Join(node, plan, "cross", [])
                replacements[id(n)] = ir.ColRef(fid, typ, d)
        # rebuild the HAVING conjunct with agg refs and subquery refs
        rep2 = dict(replacements)
        for n in _ast_walk(conj):
            if isinstance(n, ast.Func) and n.name in _AGG_FUNCS and id(n) not in rep2:
                pass
        # bind via bind_post but inject subquery replacements
        e = self._bind_post_with_rep(conj, scope, bind_post, replacements)
        return node, e

    def _bind_post_with_rep(self, e: ast.ExprNode, scope: Scope, bind_post, rep):
        # bind_post handles agg substitution; wrap to also substitute subqueries
        marker: Dict[int, ir.Expr] = rep

        orig_bind_expr = self._bind_expr

        def patched(expr, sc, extra=None):
            merged = dict(marker)
            if extra:
                merged.update(extra)
            return orig_bind_expr(expr, sc, merged)

        self._bind_expr = patched  # type: ignore
        try:
            return bind_post(e)
        finally:
            self._bind_expr = orig_bind_expr  # type: ignore

    def _check_agg_refs(self, e: ir.Expr, node: L.RelNode):
        ids = set(node.field_ids())
        for n in ir.walk(e):
            if isinstance(n, ir.ColRef) and n.name not in ids:
                raise errors.TddlError(
                    f"column '{n.name}' must appear in GROUP BY or an aggregate")

    # -- ORDER BY ----------------------------------------------------------------

    def _bind_order(self, node: L.RelNode, sel: ast.Select, scope: Scope,
                    out_exprs, display_names, project_first: bool) -> L.RelNode:
        """Non-aggregate ORDER BY: project select outputs first, sort over them
        (underlying columns still available pre-projection)."""
        # bind sort keys against select aliases, ordinals, then scope
        alias_to_ref = {}
        for (oid, e), disp in zip(out_exprs, display_names):
            alias_to_ref[disp.lower()] = ir.ColRef(oid, e.dtype, _find_dictionary(e))
        keys: List[Tuple[ir.Expr, bool]] = []
        extra: List[Tuple[str, ir.Expr]] = []
        for oexpr, desc in sel.order_by:
            if isinstance(oexpr, ast.NumberLit):
                ix = int(oexpr.value) - 1
                oid, e = out_exprs[ix]
                keys.append((ir.ColRef(oid, e.dtype, _find_dictionary(e)), desc))
            elif isinstance(oexpr, ast.Name) and len(oexpr.parts) == 1 and \
                    oexpr.parts[0].lower() in alias_to_ref:
                keys.append((alias_to_ref[oexpr.parts[0].lower()], desc))
            else:
                e = self._bind_expr(oexpr, scope)
                kid = self.fresh("sk")
                extra.append((kid, e))
                ref = ir.ColRef(kid, e.dtype, _find_dictionary(e))
                from galaxysql_tpu_torch.types import collation as _coll
                if _coll.collation_of_expr(e) is not None:
                    # the hidden sort column holds fold-class representative
                    # codes; the SORT must rank them under the collation, so
                    # the collation tag rides the key reference
                    ref.meta = e.meta
                keys.append((ref, desc))
        node = L.Project(node, out_exprs + extra)
        node = L.Sort(node, keys, sel.limit and self._limit_value(sel.limit),
                      self._limit_value(sel.offset) if sel.offset else 0)
        if extra:
            node = L.Project(node, [(oid, ir.ColRef(oid, e.dtype, _find_dictionary(e)))
                                    for oid, e in out_exprs])
        return node

    def _bind_order_agg(self, node: L.RelNode, sel: ast.Select, out_exprs,
                        display_names) -> L.RelNode:
        agg_ids = {fid: (typ, d) for fid, typ, d in node.fields()}
        alias_to_ref = {}
        for (oid, e), disp in zip(out_exprs, display_names):
            alias_to_ref[disp.lower()] = (oid, e)
        keys: List[Tuple[ir.Expr, bool]] = []
        proj = L.Project(node, out_exprs)
        for oexpr, desc in sel.order_by:
            if isinstance(oexpr, ast.NumberLit):
                ix = int(oexpr.value) - 1
                oid, e = out_exprs[ix]
                keys.append((ir.ColRef(oid, e.dtype, _find_dictionary(e)), desc))
            elif isinstance(oexpr, ast.Name) and len(oexpr.parts) == 1 and \
                    oexpr.parts[0].lower() in alias_to_ref:
                oid, e = alias_to_ref[oexpr.parts[0].lower()]
                keys.append((ir.ColRef(oid, e.dtype, _find_dictionary(e)), desc))
            else:
                # expression over group keys: match by re-binding through out_exprs
                matched = None
                for (oid, e), disp in zip(out_exprs, display_names):
                    if isinstance(oexpr, ast.Name) and \
                            disp.lower() == oexpr.parts[-1].lower():
                        matched = ir.ColRef(oid, e.dtype, _find_dictionary(e))
                        break
                if matched is None:
                    raise errors.NotSupportedError(
                        "ORDER BY expression must reference select outputs "
                        "in aggregate queries")
                keys.append((matched, desc))
        return L.Sort(proj, keys, sel.limit and self._limit_value(sel.limit),
                      self._limit_value(sel.offset) if sel.offset else 0)

    def _apply_limit(self, node: L.RelNode, sel: ast.Select) -> L.RelNode:
        if sel.limit is None:
            return node
        if isinstance(node, L.Sort) and node.limit is not None:
            return node  # limit already fused into sort
        if isinstance(node, L.Sort):
            node.limit = self._limit_value(sel.limit)
            node.offset = self._limit_value(sel.offset) if sel.offset else 0
            return node
        return L.Limit(node, self._limit_value(sel.limit),
                       self._limit_value(sel.offset) if sel.offset else 0)

    def _limit_value(self, e) -> int:
        if isinstance(e, ast.NumberLit):
            return int(e.value)
        if isinstance(e, ast.ParamRef):
            return int(self.params[e.index])
        if isinstance(e, int):
            return e
        raise errors.TddlError("LIMIT must be a literal")

    # -- star expansion -------------------------------------------------------

    def _expand_stars(self, items: Sequence[ast.SelectItem], scope: Scope
                      ) -> List[ast.SelectItem]:
        out: List[ast.SelectItem] = []
        for item in items:
            if isinstance(item.expr, ast.Star):
                q = item.expr.qualifier
                for alias, fs in scope.entries:
                    if q and alias != q[-1].lower():
                        continue
                    for fid, typ, d in fs:
                        out.append(ast.SelectItem(
                            ast.Name(fid.split(".")), None))
                if q and not any(a == q[-1].lower() for a, _ in scope.entries):
                    raise errors.UnknownTableError(f"Unknown table '{q[-1]}'")
            else:
                out.append(item)
        return out

    def _display_name(self, e: ast.ExprNode) -> str:
        if isinstance(e, ast.Name):
            return e.parts[-1]
        if isinstance(e, ast.Func):
            return e.name
        return "expr"

    # ------------------------------------------------------------------ expressions

    def _bind_expr(self, e: ast.ExprNode, scope: Scope,
                   replacements: Optional[Dict[int, ir.Expr]] = None) -> ir.Expr:
        rep = replacements or {}
        if id(e) in rep:
            return rep[id(e)]
        if isinstance(e, ast.Name):
            return scope.resolve_or_correlate(e.parts)
        if isinstance(e, ast.NumberLit):
            # MySQL semantics: a dotted numeric literal is an exact DECIMAL, not a
            # double — 0.06 - 0.01 must be exactly 0.05 (textual scale preserved)
            t = e.text
            if "." in t and "e" not in t.lower():
                scale = min(len(t.split(".")[1]), 8)
                return ir.Literal(float(t), dt.decimal(18, scale))
            return ir.lit(e.value)
        if isinstance(e, ast.StringLit):
            return ir.lit(e.value)
        if isinstance(e, ast.NullLit):
            return ir.lit(None, dt.NULLTYPE)
        if isinstance(e, ast.BoolLit):
            return ir.lit(e.value, dt.BOOL)
        if isinstance(e, ast.ParamRef):
            if e.index >= len(self.params):
                raise errors.TddlError("not enough parameters bound")
            v = self.params[e.index]
            from galaxysql_tpu_torch.sql.parameterize import DecimalParam
            if isinstance(v, DecimalParam):
                return ir.Literal(v.value, dt.decimal(18, v.scale))
            return ir.lit(v)
        if isinstance(e, ast.DateLit):
            if e.kind == "date":
                return ir.Literal(temporal.parse_date(e.value), dt.DATE)
            return ir.Literal(temporal.parse_datetime(e.value), dt.DATETIME)
        if isinstance(e, ast.Unary):
            arg = self._bind_expr(e.arg, scope, rep)
            if e.op == "-":
                if isinstance(arg, ir.Literal) and arg.value is not None and \
                        not arg.dtype.is_temporal:
                    return ir.Literal(-arg.value, arg.dtype)
                return ir.call("neg", arg)
            if e.op == "not":
                return ir.call("not", arg)
            raise errors.NotSupportedError(f"unary {e.op}")
        if isinstance(e, ast.Collate):
            return self._bind_collate(e, scope, rep)
        if isinstance(e, ast.Binary):
            return self._bind_binary(e, scope, rep)
        if isinstance(e, ast.BetweenExpr):
            arg = self._bind_expr(e.arg, scope, rep)
            lo = self._bind_expr(e.low, scope, rep)
            hi = self._bind_expr(e.high, scope, rep)
            b = ir.call("between", arg, lo, hi)
            return ir.call("not", b) if e.negated else b
        if isinstance(e, ast.LikeExpr):
            arg = self._bind_expr(e.arg, scope, rep)
            pat = self._bind_expr(e.pattern, scope, rep)
            return ir.Call("not_like" if e.negated else "like", [arg, pat], dt.BOOL)
        if isinstance(e, ast.IsNullExpr):
            arg = self._bind_expr(e.arg, scope, rep)
            return ir.call("is_not_null" if e.negated else "is_null", arg)
        if isinstance(e, ast.InExpr):
            if e.select is not None:
                raise errors.NotSupportedError(
                    "IN subquery only supported as a top-level WHERE conjunct")
            arg = self._bind_expr(e.arg, scope, rep)
            values = []
            for item in e.items:
                v = self._bind_expr(item, scope, rep)
                if not isinstance(v, ir.Literal):
                    raise errors.NotSupportedError("IN list must be literals")
                if v.dtype.is_temporal or arg.dtype.is_temporal:
                    values.append(v.value)
                else:
                    values.append(v.value)
            return ir.InList(arg, tuple(values), e.negated)
        if isinstance(e, ast.CaseExpr):
            return self._bind_case(e, scope, rep)
        if isinstance(e, ast.CastExpr):
            arg = self._bind_expr(e.arg, scope, rep)
            target = dt.from_sql_name({"SIGNED": "BIGINT", "UNSIGNED": "BIGINT UNSIGNED",
                                       "CHAR": "VARCHAR"}.get(e.type_name, e.type_name),
                                      e.precision, e.scale)
            return ir.Cast(arg, target)
        if isinstance(e, ast.ExtractExpr):
            arg = self._bind_expr(e.arg, scope, rep)
            unit = e.unit.lower()
            if unit == "year":
                return ir.call("year", arg)
            if unit == "month":
                return ir.call("month", arg)
            if unit == "day":
                return ir.call("dayofmonth", arg)
            if unit == "quarter":
                return ir.call("quarter", arg)
            if unit == "year_month":
                return ir.call("extract_year_month", arg)
            raise errors.NotSupportedError(f"EXTRACT({e.unit})")
        if isinstance(e, ast.Func):
            return self._bind_func(e, scope, rep)
        if isinstance(e, ast.SubqueryExpr):
            raise errors.NotSupportedError(
                "scalar subquery not supported in this position")
        if isinstance(e, ast.ExistsExpr):
            raise errors.NotSupportedError(
                "EXISTS only supported as a top-level WHERE conjunct")
        if isinstance(e, ast.IntervalLit):
            raise errors.TddlError("INTERVAL literal outside date arithmetic")
        raise errors.NotSupportedError(f"expression {type(e).__name__}")

    def _bind_collate(self, e: ast.Collate, scope, rep) -> ir.Expr:
        """expr COLLATE name: lower to a fold-class representative-code
        translation (one device gather), so equality/grouping under the
        collation is integer equality of translated codes (common/collation/*
        analog).  The node is tagged so comparisons fold the literal side to
        its class representative too."""
        from galaxysql_tpu_torch.types import collation as coll
        inner = self._bind_expr(e.arg, scope, rep)
        if not inner.dtype.is_string:
            raise errors.NotSupportedError("COLLATE on a non-string expression")
        coll.fold_fn(e.name)  # validate the collation name eagerly
        if isinstance(inner, ir.Literal):
            # 'lit' COLLATE ci: the collation governs the COMPARISON; carry a
            # marker the comparison binder resolves against the column side
            m = ir.Call("collate_lit", [inner], inner.dtype)
            m.meta = (None, "collate", e.name.lower())
            return m
        d = _find_dictionary(inner)
        if d is None:
            raise errors.NotSupportedError(
                "COLLATE needs a dictionary-backed string")
        table = coll.rep_table(d, e.name)
        c = ir.Call("dict_transform", [inner], inner.dtype, dictionary=d)
        c.meta = (table, "collate", e.name.lower())
        return c

    @staticmethod
    def _collation_of(x: ir.Expr):
        if isinstance(x, ir.Call) and x.op in ("dict_transform", "collate_lit") \
                and x.meta is not None and len(x.meta) >= 3 \
                and x.meta[1] == "collate":
            return x.meta[2]
        return None

    def _bind_binary(self, e: ast.Binary, scope, rep) -> ir.Expr:
        op_map = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge",
                  "and": "and", "or": "or", "+": "add", "-": "sub", "*": "mul",
                  "/": "div", "%": "mod", "div": "div", "xor": "ne"}
        # interval arithmetic: date +/- INTERVAL n unit
        if e.op in ("+", "-") and isinstance(e.right, ast.IntervalLit):
            base = self._bind_expr(e.left, scope, rep)
            return self._bind_interval_add(base, e.right, e.op == "-", scope, rep)
        if e.op == "+" and isinstance(e.left, ast.IntervalLit):
            base = self._bind_expr(e.right, scope, rep)
            return self._bind_interval_add(base, e.left, False, scope, rep)
        op = op_map.get(e.op)
        if op is None:
            raise errors.NotSupportedError(f"operator {e.op}")
        a = self._bind_expr(e.left, scope, rep)
        b = self._bind_expr(e.right, scope, rep)
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            cname = self._collation_of(a) or self._collation_of(b)
            if cname is not None:
                from galaxysql_tpu_torch.types import collation as coll
                # unwrap literal-side markers; translate the column side to
                # fold-class representative codes; fold the literal to its
                # class representative so codes compare consistently
                if isinstance(a, ir.Call) and a.op == "collate_lit":
                    a = a.args[0]
                if isinstance(b, ir.Call) and b.op == "collate_lit":
                    b = b.args[0]

                def colled(x):
                    if self._collation_of(x) is not None:
                        return x
                    d = _find_dictionary(x)
                    if d is None or isinstance(x, ir.Literal):
                        return x
                    t = coll.rep_table(d, cname)
                    c = ir.Call("dict_transform", [x], x.dtype, dictionary=d)
                    c.meta = (t, "collate", cname)
                    return c
                a, b = colled(a), colled(b)
                for side, other in ((a, b), (b, a)):
                    if isinstance(other, ir.Literal) and \
                            isinstance(other.value, str):
                        d = _find_dictionary(side)
                        if d is not None:
                            other.value = coll.rep_text(d, cname, other.value)
        if op == "div" and e.op == "div":
            return ir.Cast(ir.call("div", a, b), dt.BIGINT)
        return ir.call(op, a, b)

    def _bind_interval_add(self, base: ir.Expr, iv: ast.IntervalLit, negate: bool,
                           scope, rep) -> ir.Expr:
        n_e = self._bind_expr(iv.value, scope, rep)
        if isinstance(n_e, ir.Literal):
            n = int(n_e.value)
        else:
            raise errors.NotSupportedError("INTERVAL value must be a literal")
        if negate:
            n = -n
        unit = iv.unit
        if unit == "DAY":
            return ir.call("date_add_days", base, ir.lit(n))
        if unit == "WEEK":
            return ir.call("date_add_days", base, ir.lit(n * 7))
        if unit == "MONTH":
            return ir.call("date_add_months", base, ir.lit(n))
        if unit == "QUARTER":
            return ir.call("date_add_months", base, ir.lit(n * 3))
        if unit == "YEAR":
            return ir.call("date_add_months", base, ir.lit(n * 12))
        raise errors.NotSupportedError(f"INTERVAL {unit}")

    def _bind_case(self, e: ast.CaseExpr, scope, rep) -> ir.Expr:
        whens = []
        for c, v in e.whens:
            if e.operand is not None:
                cond = ir.call("eq", self._bind_expr(e.operand, scope, rep),
                               self._bind_expr(c, scope, rep))
            else:
                cond = self._bind_expr(c, scope, rep)
            whens.append((cond, self._bind_expr(v, scope, rep)))
        default = self._bind_expr(e.else_, scope, rep) if e.else_ is not None else None
        # result type: common type over branch values
        t = whens[0][1].dtype
        for _, v in whens[1:]:
            t = dt.common_type(t, v.dtype)
        if default is not None:
            t = dt.common_type(t, default.dtype)
        return ir.Case(whens, default, t)

    def _bind_func(self, e: ast.Func, scope, rep) -> ir.Expr:
        name = e.name
        if name in _AGG_FUNCS:
            raise errors.TddlError(f"misplaced aggregate function {name}()")
        args = [self._bind_expr(a, scope, rep) for a in e.args]
        if name in _SCALAR_FUNC_OPS:
            return ir.call(_SCALAR_FUNC_OPS[name], *args)
        if name in ("date_add", "adddate"):
            raise errors.NotSupportedError("use + INTERVAL syntax")
        if name in ("substring", "substr", "left", "upper", "lower", "ltrim", "rtrim",
                    "trim", "reverse"):
            return self._bind_string_func(name, args, e)
        if name == "concat":
            return self._bind_concat(args)
        if name == "nullif":
            cond = ir.call("eq", args[0], args[1])
            return ir.Case([(cond, ir.lit(None, args[0].dtype))], args[0],
                           args[0].dtype)
        if name == "round":
            if len(args) == 1 or (isinstance(args[1], ir.Literal)
                                  and int(args[1].value) == 0):
                return ir.Cast(args[0], dt.BIGINT) if args[0].dtype.clazz != \
                    dt.TypeClass.DECIMAL else ir.Cast(args[0], dt.decimal(18, 0))
            d = int(args[1].value)
            return ir.Cast(args[0], dt.decimal(18, max(d, 0)))
        if name in ("now", "current_timestamp", "current_date", "curdate"):
            import time
            us = int(time.time() * 1_000_000)
            if name in ("current_date", "curdate"):
                return ir.Literal(us // temporal.MICROS_PER_DAY, dt.DATE)
            return ir.Literal(us, dt.DATETIME)
        if name == "database":
            return _const_str(self.default_schema)
        if name == "version":
            return _const_str("8.0.3-galaxysql-tpu")
        if name in ("nextval", "seq_nextval"):
            if not args or not isinstance(args[0], ir.Literal):
                raise errors.TddlError("NEXTVAL requires a sequence name literal")
            seq_name = str(args[0].value)
            v = self.sequence_hook(seq_name) if self.sequence_hook else 0
            return ir.lit(int(v))
        if name == "connection_id":
            return ir.lit(int(self.connection_id or 0))
        if name in ("get_lock", "release_lock", "is_free_lock", "is_used_lock"):
            # user-level advisory locks (LockingFunctionManager.java): evaluated
            # at bind with session identity; never plan-cached (side effects)
            if self.lock_fn_hook is None:
                raise errors.NotSupportedError(f"{name.upper()} outside a session")
            vals = []
            for a in args:
                if not isinstance(a, ir.Literal):
                    raise errors.TddlError(f"{name.upper()} requires literal args")
                vals.append(a.value)
            r = self.lock_fn_hook(name, vals)
            return ir.lit(None, dt.NULLTYPE) if r is None else ir.lit(int(r))
        if name == "@@":
            raise errors.NotSupportedError("system variable in expression")
        if name == "length" or name == "char_length":
            arg = args[0]
            d = _find_dictionary(arg)
            if d is None:
                raise errors.NotSupportedError("LENGTH on non-string")
            table = np.array([len(v) for v in d.values] or [0], dtype=np.int64)
            c = ir.Call("dict_transform", [arg], dt.BIGINT)
            c.meta = (table,)
            return c
        raise errors.NotSupportedError(f"function {name}()")

    def _bind_string_func(self, name: str, args: List[ir.Expr], e: ast.Func) -> ir.Expr:
        arg = args[0]
        d = _find_dictionary(arg)
        if d is None or not arg.dtype.is_string:
            raise errors.NotSupportedError(f"{name}() requires a string column")

        def fn(s: str) -> str:
            if name in ("substring", "substr"):
                start = int(args[1].value)
                ln = int(args[2].value) if len(args) > 2 else None
                if start > 0:
                    base = start - 1
                elif start < 0:
                    base = len(s) + start
                else:
                    return ""
                return s[base:base + ln] if ln is not None else s[base:]
            if name == "left":
                return s[:int(args[1].value)]
            if name == "upper":
                return s.upper()
            if name == "lower":
                return s.lower()
            if name == "ltrim":
                return s.lstrip()
            if name == "rtrim":
                return s.rstrip()
            if name == "trim":
                return s.strip()
            if name == "reverse":
                return s[::-1]
            raise AssertionError(name)

        derived = Dictionary()
        trans = np.array([derived.encode_one(fn(v)) for v in d.values] or [0],
                         dtype=np.int32)
        c = ir.Call("dict_transform", [arg], dt.VARCHAR)
        c.dictionary = derived
        c.meta = (trans,)
        return c

    def _bind_concat(self, args: List[ir.Expr]) -> ir.Expr:
        # concat over one dict column + literals: host dictionary transform
        col_args = [a for a in args if not isinstance(a, ir.Literal)]
        if len(col_args) != 1:
            raise errors.NotSupportedError(
                "CONCAT supports one column plus literals for now")
        col = col_args[0]
        d = _find_dictionary(col)
        if d is None:
            raise errors.NotSupportedError("CONCAT requires a string column")
        derived = Dictionary()
        trans = np.zeros(max(len(d), 1), dtype=np.int32)
        for code, v in enumerate(d.values):
            parts = []
            for a in args:
                parts.append(str(a.value) if isinstance(a, ir.Literal) else v)
            trans[code] = derived.encode_one("".join(parts))
        c = ir.Call("dict_transform", [col], dt.VARCHAR)
        c.dictionary = derived
        c.meta = (trans,)
        return c


def _const_str(s: str) -> ir.Expr:
    """A constant string expression carrying its own single-entry dictionary."""
    c = ir.Call("dict_transform", [ir.lit(0, dt.INT)], dt.VARCHAR)
    c.dictionary = Dictionary([s])
    c.meta = (np.zeros(1, dtype=np.int32),)
    return c


# ---------------------------------------------------------------------------
# AST / IR walking helpers
# ---------------------------------------------------------------------------

def _ast_conjuncts(e: ast.ExprNode):
    if isinstance(e, ast.Binary) and e.op == "and":
        yield from _ast_conjuncts(e.left)
        yield from _ast_conjuncts(e.right)
    else:
        yield e


def _ast_walk(e):
    yield e
    if isinstance(e, ast.ExprNode):
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, ast.ExprNode):
                yield from _ast_walk(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, ast.ExprNode):
                        yield from _ast_walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.ExprNode):
                                yield from _ast_walk(y)


def _substitute(e: ir.Expr, mapping: Dict[Tuple, ir.Expr]) -> ir.Expr:
    if e.key() in mapping:
        return mapping[e.key()]
    if isinstance(e, ir.Call):
        new_args = [_substitute(a, mapping) for a in e.args]
        c = ir.Call(e.op, new_args, e.dtype, e.dictionary, e.meta)
        return c
    if isinstance(e, ir.Cast):
        return ir.Cast(_substitute(e.arg, mapping), e.dtype)
    if isinstance(e, ir.InList):
        return ir.InList(_substitute(e.arg, mapping), e.values, e.negated, e.dtype)
    if isinstance(e, ir.Case):
        whens = [(_substitute(c, mapping), _substitute(v, mapping)) for c, v in e.whens]
        default = _substitute(e.default, mapping) if e.default is not None else None
        return ir.Case(whens, default, e.dtype)
    return e
