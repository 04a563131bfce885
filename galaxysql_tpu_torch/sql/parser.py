"""Recursive-descent MySQL-dialect parser.

Reference analog: `MySqlStatementParser`/`MySqlExprParser` (SURVEY.md §2.3).  Covers the
surface the framework executes: SELECT (joins, subqueries, UNION), DML, DDL with PolarDB-X
partitioning extensions (PARTITION BY / SINGLE / BROADCAST / GLOBAL INDEX), SET/SHOW/EXPLAIN/
transaction control.  Expressions use Pratt precedence climbing with MySQL's operator table.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.lexer import T, Token, tokenize
from galaxysql_tpu_torch.utils.errors import SqlSyntaxError

_INTERVAL_UNITS = {"MICROSECOND", "SECOND", "MINUTE", "HOUR", "DAY", "WEEK", "MONTH",
                   "QUARTER", "YEAR"}

# binding powers (left) for infix operators — MySQL precedence, low to high
_CMP_OPS = {"=", "<=>", "<>", "!=", "<", "<=", ">", ">="}


MAX_EXPR_DEPTH = 64


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        self.depth = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != T.EOF:
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        return self.peek().is_kw(*words)

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> Token:
        t = self.peek()
        if not t.is_kw(word):
            raise SqlSyntaxError(f"expected {word}", self.sql, t.start)
        return self.next()

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == T.OP and t.text == op

    def accept_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not (t.kind == T.OP and t.text == op):
            raise SqlSyntaxError(f"expected '{op}'", self.sql, t.start)
        return self.next()

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind != T.IDENT:
            raise SqlSyntaxError("expected identifier", self.sql, t.start)
        return self.next().text

    def error(self, msg: str) -> SqlSyntaxError:
        return SqlSyntaxError(msg, self.sql, self.peek().start)

    # -- entry --------------------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        # allow trailing semicolon
        self.accept_op(";")
        t = self.peek()
        if t.kind != T.EOF:
            raise self.error("unexpected trailing input")
        return stmt

    def _statement(self) -> ast.Statement:
        t = self.peek()
        hint_text = None
        if t.kind == T.OP and t.text.startswith("/*"):
            hint_text = self.next().text  # hint comment at statement head
            t = self.peek()
        stmt = self._statement_inner(t)
        if hint_text is not None:
            stmt.hints = hint_text
        return stmt

    def _statement_inner(self, t) -> ast.Statement:
        if t.is_kw("SELECT") or t.is_kw("WITH") or self.at_op("("):
            return self._select_with_setops()
        if t.is_kw("INSERT", "REPLACE"):
            return self._insert()
        if t.is_kw("UPDATE"):
            return self._update()
        if t.is_kw("DELETE"):
            return self._delete()
        if t.is_kw("CREATE"):
            return self._create()
        if t.is_kw("ALTER"):
            return self._alter()
        if t.is_kw("DROP"):
            return self._drop()
        if t.is_kw("TRUNCATE"):
            self.next()
            self.accept_kw("TABLE")
            return ast.TruncateTable(self._table_name())
        if t.is_kw("CHECK"):
            self.next()
            self.expect_kw("TABLE")
            names = [self._table_name()]
            while self.accept_op(","):
                names.append(self._table_name())
            return ast.CheckTable(names)
        if t.is_kw("FLASHBACK"):
            self.next()
            self.expect_kw("TABLE")
            name = self._table_name()
            self.expect_kw("TO")
            self.expect_kw("BEFORE")
            self.expect_kw("DROP")
            rename_to = None
            if self.accept_kw("RENAME"):
                self.expect_kw("TO")
                rename_to = self.expect_ident()
            return ast.FlashbackTable(name, rename_to)
        if t.is_kw("PURGE"):
            self.next()
            if self.accept_kw("RECYCLEBIN"):
                return ast.PurgeRecycleBin()
            self.expect_kw("TABLE")
            return ast.PurgeRecycleBin(self.expect_ident())
        if t.is_kw("ADVISE"):
            self.next()
            self.expect_kw("INDEX")
            return ast.AdviseIndex(self._select_with_setops())
        if t.is_kw("USE"):
            self.next()
            return ast.UseDb(self.expect_ident())
        if t.is_kw("SET"):
            return self._set()
        if t.is_kw("SHOW"):
            return self._show()
        if t.is_kw("BASELINE"):
            self.next()
            if self.accept_kw("EVOLVE"):
                return ast.BaselineStmt("evolve")
            if self.accept_kw("DELETE"):
                return ast.BaselineStmt("delete", int(self.next().text))
            raise self.error("expected EVOLVE or DELETE after BASELINE")
        if t.is_kw("EXPLAIN"):
            self.next()
            analyze = self.accept_kw("ANALYZE")
            return ast.Explain(self._statement(), analyze)
        if t.is_kw("DESC", "DESCRIBE"):
            self.next()
            return ast.Describe(self._table_name())
        if t.is_kw("BEGIN"):
            self.next()
            return ast.Begin()
        if t.is_kw("START"):
            self.next()
            self.expect_kw("TRANSACTION")
            self.accept_kw("READ")
            self.accept_kw("ONLY")
            return ast.Begin()
        if t.is_kw("COMMIT"):
            self.next()
            return ast.Commit()
        if t.is_kw("ROLLBACK"):
            self.next()
            return ast.Rollback()
        if t.is_kw("ANALYZE"):
            self.next()
            self.expect_kw("TABLE")
            names = [self._table_name()]
            while self.accept_op(","):
                names.append(self._table_name())
            return ast.AnalyzeTable(names)
        if t.is_kw("LOAD"):
            return self._load_data()
        if t.is_kw("GRANT"):
            return self._grant(revoke=False)
        if t.is_kw("REVOKE"):
            return self._grant(revoke=True)
        if t.is_kw("REBALANCE"):
            # REBALANCE TABLE t | REBALANCE DATABASE [s]  [DRY RUN]
            self.next()
            if self.accept_kw("DATABASE"):
                sch = self.next().text if self.peek().kind == T.IDENT and \
                    not self.at_kw("DRY") else None
                stmt = ast.Rebalance(schema=sch)
            else:
                self.expect_kw("TABLE")
                tn = self._table_name()
                stmt = ast.Rebalance(schema=tn.schema, table=tn.table)
            if self.accept_kw("DRY"):
                self.expect_kw("RUN")
                stmt.dry_run = True
            return stmt
        if t.is_kw("KILL"):
            self.next()
            query_only = self.accept_kw("QUERY")
            ct = self.next()
            if ct.kind != T.NUMBER:
                raise self.error("expected connection id")
            return ast.KillStmt(int(ct.text), query_only)
        raise self.error(f"unsupported statement start: {t.text!r}")

    # -- SELECT -------------------------------------------------------------

    def _select_with_setops(self) -> ast.Statement:
        ctes: list = []
        if self.accept_kw("WITH"):
            if self.accept_kw("RECURSIVE"):
                raise self.error("recursive CTEs are not supported")
            ctes.append(self._cte_item())
            while self.accept_op(","):
                ctes.append(self._cte_item())
        left = self._select_core_or_paren()
        while self.at_kw("UNION"):
            self.next()
            all_ = self.accept_kw("ALL")
            if not all_:
                self.accept_kw("DISTINCT")
            # an unparenthesized arm must NOT swallow the trailing ORDER BY/LIMIT:
            # in MySQL they bind to the whole union chain
            right = self._select_core_or_paren(no_tail=True)
            left = ast.SetOpSelect("union_all" if all_ else "union", left, right)
        # trailing ORDER BY / LIMIT of a union chain
        if isinstance(left, ast.SetOpSelect):
            if self.accept_kw("ORDER"):
                self.expect_kw("BY")
                left.order_by = self._order_list()
            if self.accept_kw("LIMIT"):
                left.limit, left.offset = self._limit_clause()
        if ctes:
            # CTEs scope over the WHOLE union chain: attach to the top statement
            left.ctes = list(ctes) + list(getattr(left, "ctes", []))
        return left

    def _cte_item(self) -> ast.Cte:
        name = self.expect_ident()
        cols = None
        if self.accept_op("("):
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
        self.expect_kw("AS")
        self.expect_op("(")
        sel = self._select_with_setops()
        self.expect_op(")")
        return ast.Cte(name, cols, sel)

    def _select_core_or_paren(self, no_tail: bool = False) -> ast.Statement:
        if self.accept_op("("):
            s = self._select_with_setops()
            self.expect_op(")")
            return s
        return self._select_core(no_tail=no_tail)

    def _select_core(self, no_tail: bool = False) -> ast.Select:
        self.expect_kw("SELECT")
        while self.peek().kind == T.OP and self.peek().text.startswith("/*"):
            self.next()
        distinct = False
        if self.accept_kw("DISTINCT"):
            distinct = True
        else:
            self.accept_kw("ALL")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        sel = ast.Select(items, distinct=distinct)
        if self.accept_kw("FROM"):
            sel.from_ = self._table_refs()
        if self.accept_kw("WHERE"):
            sel.where = self._expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            if self.at_kw("ROLLUP", "CUBE") and self.peek(1).text == "(":
                sel.group_modifier = self.next().text.lower()
                self.expect_op("(")
                sel.group_by.append(self._expr())
                while self.accept_op(","):
                    sel.group_by.append(self._expr())
                self.expect_op(")")
            elif self.at_kw("GROUPING"):
                self.next()
                self.expect_kw("SETS")
                self.expect_op("(")
                sel.grouping_sets = [self._grouping_set()]
                while self.accept_op(","):
                    sel.grouping_sets.append(self._grouping_set())
                self.expect_op(")")
            else:
                sel.group_by.append(self._expr())
                while self.accept_op(","):
                    sel.group_by.append(self._expr())
                self.accept_kw("ASC")  # tolerated legacy syntax
                if self.accept_kw("WITH"):
                    self.expect_kw("ROLLUP")
                    sel.group_modifier = "rollup"
        if self.accept_kw("HAVING"):
            sel.having = self._expr()
        if no_tail:
            return sel
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            sel.order_by = self._order_list()
        if self.accept_kw("LIMIT"):
            sel.limit, sel.offset = self._limit_clause()
        if self.accept_kw("FOR"):
            self.expect_kw("UPDATE")
            sel.for_update = True
        if self.accept_kw("LOCK"):  # LOCK IN SHARE MODE
            self.expect_kw("IN")
            self.expect_kw("SHARE")
            self.expect_kw("MODE")
        return sel

    def _grouping_set(self) -> list:
        """One GROUPING SETS element: (a, b) | (a) | a | () — () is the total."""
        if self.accept_op("("):
            if self.accept_op(")"):
                return []
            out = [self._expr()]
            while self.accept_op(","):
                out.append(self._expr())
            self.expect_op(")")
            return out
        return [self._expr()]

    def _select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        e = self._expr()
        alias = None
        if self.accept_kw("AS"):
            t = self.next()
            if t.kind not in (T.IDENT, T.STRING):
                raise self.error("expected alias")
            alias = t.text
        elif self.peek().kind == T.IDENT and not self._is_clause_kw(self.peek()):
            alias = self.next().text
        return ast.SelectItem(e, alias)

    _CLAUSE_KWS = {"FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "ON",
                   "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "AS", "USING", "SET",
                   "VALUES", "FOR", "LOCK", "INTO", "STRAIGHT_JOIN", "OFFSET", "ASC",
                   "DESC", "AND", "OR", "XOR", "NOT", "BETWEEN", "LIKE", "IN", "IS",
                   "DIV", "MOD", "REGEXP", "RLIKE", "WHEN", "THEN", "ELSE", "END",
                   "PARTITION", "EXISTS", "INTERVAL", "COLLATE"}

    def _is_clause_kw(self, t: Token) -> bool:
        return not t.quoted and t.upper in self._CLAUSE_KWS

    def _order_list(self) -> List[Tuple[ast.ExprNode, bool]]:
        out = []
        while True:
            e = self._expr()
            desc = False
            if self.accept_kw("DESC"):
                desc = True
            else:
                self.accept_kw("ASC")
            out.append((e, desc))
            if not self.accept_op(","):
                return out

    def _limit_clause(self):
        first = self._expr()
        if self.accept_op(","):
            second = self._expr()
            return second, first        # LIMIT offset, count
        if self.accept_kw("OFFSET"):
            return first, self._expr()  # LIMIT count OFFSET offset
        return first, None

    # -- FROM / joins --------------------------------------------------------

    def _table_refs(self) -> ast.TableExpr:
        left = self._table_ref()
        while True:
            if self.accept_op(","):
                right = self._table_ref()
                left = ast.Join("cross", left, right)
                continue
            kind = None
            if self.at_kw("JOIN", "INNER", "STRAIGHT_JOIN"):
                if self.accept_kw("INNER"):
                    self.expect_kw("JOIN")
                else:
                    self.next()
                kind = "inner"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                kind = self.next().text.lower()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.at_kw("CROSS"):
                self.next()
                self.expect_kw("JOIN")
                kind = "cross"
            else:
                return left
            right = self._table_ref()
            on = None
            using = None
            if self.accept_kw("ON"):
                on = self._expr()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                using = [self.expect_ident()]
                while self.accept_op(","):
                    using.append(self.expect_ident())
                self.expect_op(")")
            left = ast.Join(kind, left, right, on, using)

    def _table_ref(self) -> ast.TableExpr:
        if self.accept_op("("):
            # subquery or parenthesized join
            if self.at_kw("SELECT"):
                s = self._select_with_setops()
                self.expect_op(")")
                alias = self._alias(required=True)
                return ast.SubqueryRef(s, alias)
            inner = self._table_refs()
            self.expect_op(")")
            return inner
        name = self._table_name()
        if self.at_kw("AS") and self.peek(1).is_kw("OF"):
            # flashback snapshot read: t AS OF TSO <n> (planner/flashback analog)
            self.next()
            self.next()
            self.expect_kw("TSO")
            t = self.next()
            if t.kind == T.NUMBER:
                name.as_of = int(t.text)
            elif t.kind == T.PARAM:
                # the plan-cache path parameterizes literals before parsing
                idx = sum(1 for k in self.toks[:self.i - 1] if k.kind == T.PARAM)
                name.as_of = ast.ParamRef(idx)
            else:
                raise self.error("expected a TSO value after AS OF TSO")
        name.alias = self._alias()
        return name

    def _alias(self, required: bool = False) -> Optional[str]:
        if self.accept_kw("AS"):
            return self.expect_ident()
        t = self.peek()
        if t.kind == T.IDENT and not self._is_clause_kw(t):
            return self.next().text
        if required:
            raise self.error("expected alias for derived table")
        return None

    def _table_name(self) -> ast.TableName:
        parts = [self.expect_ident()]
        while self.accept_op("."):
            parts.append(self.expect_ident())
        return ast.TableName(parts)

    # -- expressions (Pratt) --------------------------------------------------

    def _expr(self) -> ast.ExprNode:
        # bounded nesting: a hostile deeply-parenthesized input must fail with a clean
        # syntax error, not a RecursionError that kills the session thread
        self.depth += 1
        try:
            if self.depth > MAX_EXPR_DEPTH:
                raise self.error("expression nesting too deep")
            return self._or_expr()
        finally:
            self.depth -= 1

    def _or_expr(self) -> ast.ExprNode:
        e = self._xor_expr()
        while self.at_kw("OR") or self.at_op("||"):
            self.next()
            e = ast.Binary("or", e, self._xor_expr())
        return e

    def _xor_expr(self) -> ast.ExprNode:
        e = self._and_expr()
        while self.at_kw("XOR"):
            self.next()
            e = ast.Binary("xor", e, self._and_expr())
        return e

    def _and_expr(self) -> ast.ExprNode:
        e = self._not_expr()
        while self.at_kw("AND") or self.at_op("&&"):
            self.next()
            e = ast.Binary("and", e, self._not_expr())
        return e

    def _not_expr(self) -> ast.ExprNode:
        if self.accept_kw("NOT") or self.accept_op("!"):
            return ast.Unary("not", self._not_expr())
        return self._predicate()

    def _predicate(self) -> ast.ExprNode:
        e = self._bit_expr()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT"):
                    s = self._select_with_setops()
                    self.expect_op(")")
                    e = ast.InExpr(e, None, s, negated)
                else:
                    items = [self._expr()]
                    while self.accept_op(","):
                        items.append(self._expr())
                    self.expect_op(")")
                    e = ast.InExpr(e, items, None, negated)
                continue
            if self.accept_kw("BETWEEN"):
                lo = self._bit_expr()
                self.expect_kw("AND")
                hi = self._bit_expr()
                e = ast.BetweenExpr(e, lo, hi, negated)
                continue
            if self.accept_kw("LIKE"):
                e = ast.LikeExpr(e, self._bit_expr(), negated)
                continue
            if negated:
                self.i = save  # NOT belonged to something else
                break
            if self.accept_kw("IS"):
                neg = self.accept_kw("NOT")
                if self.accept_kw("NULL"):
                    e = ast.IsNullExpr(e, neg)
                elif self.accept_kw("TRUE"):
                    cmp_ = ast.Binary("=", e, ast.BoolLit(True))
                    e = ast.Unary("not", cmp_) if neg else cmp_
                elif self.accept_kw("FALSE"):
                    cmp_ = ast.Binary("=", e, ast.BoolLit(False))
                    e = ast.Unary("not", cmp_) if neg else cmp_
                else:
                    raise self.error("expected NULL/TRUE/FALSE after IS")
                continue
            t = self.peek()
            if t.kind == T.OP and t.text in _CMP_OPS:
                op = self.next().text
                # comparison subquery: = (SELECT ...) / > ALL|ANY (...)
                if self.at_kw("ALL", "ANY", "SOME"):
                    quant = self.next().upper
                    self.expect_op("(")
                    s = self._select_with_setops()
                    self.expect_op(")")
                    e = ast.Func(f"{'all' if quant == 'ALL' else 'any'}_cmp_{op}",
                                 [e, ast.SubqueryExpr(s)])
                    continue
                rhs = self._bit_expr()
                e = ast.Binary("<>" if op == "!=" else op, e, rhs)
                continue
            break
        return e

    def _bit_expr(self) -> ast.ExprNode:
        e = self._shift_expr()
        while self.at_op("|") or self.at_op("&") or self.at_op("^"):
            op = self.next().text
            e = ast.Binary(op, e, self._shift_expr())
        return e

    def _shift_expr(self) -> ast.ExprNode:
        e = self._add_expr()
        while self.at_op("<<") or self.at_op(">>"):
            op = self.next().text
            e = ast.Binary(op, e, self._add_expr())
        return e

    def _add_expr(self) -> ast.ExprNode:
        e = self._mul_expr()
        while self.at_op("+") or self.at_op("-"):
            op = self.next().text
            rhs = self._mul_expr()
            e = ast.Binary(op, e, rhs)
        return e

    def _mul_expr(self) -> ast.ExprNode:
        e = self._unary_expr()
        while True:
            if self.at_op("*") or self.at_op("/") or self.at_op("%"):
                op = self.next().text
                e = ast.Binary(op, e, self._unary_expr())
            elif self.at_kw("DIV"):
                self.next()
                e = ast.Binary("div", e, self._unary_expr())
            elif self.at_kw("MOD"):
                self.next()
                e = ast.Binary("%", e, self._unary_expr())
            else:
                return e

    def _unary_expr(self) -> ast.ExprNode:
        if self.accept_op("-"):
            return ast.Unary("-", self._unary_expr())
        if self.accept_op("+"):
            return self._unary_expr()
        if self.accept_op("~"):
            return ast.Unary("~", self._unary_expr())
        e = self._primary()
        while self.accept_kw("COLLATE"):  # MySQL: binds tighter than comparison
            e = ast.Collate(e, self.expect_ident())
        return e

    def _primary(self) -> ast.ExprNode:
        t = self.peek()
        if t.kind == T.NUMBER:
            self.next()
            return ast.NumberLit(t.text)
        if t.kind == T.STRING:
            self.next()
            return ast.StringLit(t.text)
        if t.kind == T.HEX:
            self.next()
            return ast.NumberLit(str(int(t.text, 16)))
        if t.kind == T.PARAM:
            self.next()
            idx = sum(1 for k in self.toks[:self.i - 1] if k.kind == T.PARAM)
            return ast.ParamRef(idx)
        if t.kind == T.SYSVAR:
            self.next()
            return ast.Func("@@", [ast.StringLit(t.text)])
        if t.kind == T.USERVAR:
            self.next()
            return ast.Func("@", [ast.StringLit(t.text)])
        if self.at_op("("):
            self.next()
            if self.at_kw("SELECT"):
                s = self._select_with_setops()
                self.expect_op(")")
                return ast.SubqueryExpr(s)
            e = self._expr()
            if self.at_op(","):
                # row constructor (a, b, ...) — only supported in IN for now
                items = [e]
                while self.accept_op(","):
                    items.append(self._expr())
                self.expect_op(")")
                return ast.Func("row", items)
            self.expect_op(")")
            return e
        if t.kind != T.IDENT:
            raise self.error(f"unexpected token {t.text!r}")

        up = t.upper
        # keyword literals / constructs
        if not t.quoted:
            if up == "NULL":
                self.next()
                return ast.NullLit()
            if up == "TRUE":
                self.next()
                return ast.BoolLit(True)
            if up == "FALSE":
                self.next()
                return ast.BoolLit(False)
            if up in ("DATE", "TIMESTAMP", "TIME") and self.peek(1).kind == T.STRING:
                self.next()
                lit = self.next()
                return ast.DateLit(lit.text, up.lower())
            if up == "INTERVAL":
                self.next()
                v = self._expr()
                unit_t = self.peek()
                if unit_t.kind == T.IDENT and unit_t.upper in _INTERVAL_UNITS:
                    self.next()
                    return ast.IntervalLit(v, unit_t.upper)
                raise self.error("expected interval unit")
            if up == "CASE":
                return self._case()
            if up == "CAST" and self.peek(1).kind == T.OP and self.peek(1).text == "(":
                self.next()
                self.next()
                arg = self._expr()
                self.expect_kw("AS")
                tn, p, s = self._type_spec()
                self.expect_op(")")
                return ast.CastExpr(arg, tn, p, s)
            if up == "EXISTS" and self.peek(1).kind == T.OP and self.peek(1).text == "(":
                self.next()
                self.next()
                s = self._select_with_setops()
                self.expect_op(")")
                return ast.ExistsExpr(s)
            if up == "EXTRACT" and self.peek(1).kind == T.OP and self.peek(1).text == "(":
                self.next()
                self.next()
                unit = self.expect_ident().upper()
                self.expect_kw("FROM")
                arg = self._expr()
                self.expect_op(")")
                return ast.ExtractExpr(unit, arg)
            if up == "NOT":
                self.next()
                return ast.Unary("not", self._not_expr())
            if up == "BINARY":  # BINARY expr — treat as no-op cast
                self.next()
                return self._unary_expr()

        # function call?
        if self.peek(1).kind == T.OP and self.peek(1).text == "(" and \
                not self._is_clause_kw(t):
            name = self.next().text
            self.next()  # (
            if self.accept_op(")"):
                return self._maybe_over(ast.Func(name.lower(), []))
            if self.at_op("*"):
                self.next()
                self.expect_op(")")
                return self._maybe_over(ast.Func(name.lower(), [], star=True))
            distinct = self.accept_kw("DISTINCT")
            args = [self._expr()]
            while self.accept_op(","):
                args.append(self._expr())
            # SUBSTRING(x FROM a FOR b)
            if self.accept_kw("FROM"):
                args.append(self._expr())
                if self.accept_kw("FOR"):
                    args.append(self._expr())
            self.expect_op(")")
            f = ast.Func(name.lower(), args, distinct=distinct)
            return self._maybe_over(f)

        # plain (possibly qualified) name
        if self._is_clause_kw(t):
            raise self.error(f"unexpected keyword {t.text!r}")
        parts = [self.next().text]
        while self.at_op(".") and self.peek(1).kind in (T.IDENT,) or \
                (self.at_op(".") and self.peek(1).kind == T.OP and self.peek(1).text == "*"):
            self.next()
            if self.at_op("*"):
                self.next()
                return ast.Star(parts)
            parts.append(self.expect_ident())
        return ast.Name(parts)

    def _maybe_over(self, f: ast.Func) -> ast.ExprNode:
        if not self.at_kw("OVER"):
            return f
        self.next()
        self.expect_op("(")
        partition_by = []
        order_by = []
        frame = None
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self._expr())
            while self.accept_op(","):
                partition_by.append(self._expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self._order_list()
        if self.at_kw("ROWS", "RANGE"):
            unit = self.next().upper.lower()
            self.expect_kw("BETWEEN")
            if self.accept_kw("UNBOUNDED"):
                self.expect_kw("PRECEDING")
                start = "unbounded"
            else:
                self.expect_kw("CURRENT")
                self.expect_kw("ROW")
                start = "current"
            self.expect_kw("AND")
            if self.accept_kw("UNBOUNDED"):
                self.expect_kw("FOLLOWING")
                frame = (unit, start, "unbounded_following")
            else:
                self.expect_kw("CURRENT")
                self.expect_kw("ROW")
                frame = (unit, start, "current")
        self.expect_op(")")
        return ast.WindowExpr(f, partition_by, order_by, frame)

    def _case(self) -> ast.ExprNode:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self._expr()
        whens = []
        while self.accept_kw("WHEN"):
            c = self._expr()
            self.expect_kw("THEN")
            v = self._expr()
            whens.append((c, v))
        else_ = None
        if self.accept_kw("ELSE"):
            else_ = self._expr()
        self.expect_kw("END")
        return ast.CaseExpr(operand, whens, else_)

    def _type_spec(self) -> Tuple[str, int, int]:
        name = self.expect_ident().upper()
        if name in ("DOUBLE", "CHARACTER") and self.at_kw("PRECISION", "VARYING"):
            self.next()
        p = s = 0
        if self.accept_op("("):
            t = self.next()
            if t.kind != T.NUMBER:
                raise self.error("expected precision")
            p = int(t.text)
            if self.accept_op(","):
                t = self.next()
                s = int(t.text)
            self.expect_op(")")
        if self.accept_kw("UNSIGNED"):
            name += " UNSIGNED"
        self.accept_kw("SIGNED")
        return name, p, s

    # -- DML ------------------------------------------------------------------

    def _insert(self) -> ast.Insert:
        replace = self.peek().is_kw("REPLACE")
        self.next()
        ignore = self.accept_kw("IGNORE")
        self.accept_kw("INTO")
        table = self._table_name()
        columns = None
        if self.at_op("(") and not self.peek(1).is_kw("SELECT"):
            self.next()
            columns = [self.expect_ident()]
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        stmt = ast.Insert(table, columns, replace=replace, ignore=ignore)
        if self.accept_kw("VALUES") or self.accept_kw("VALUE"):
            rows = []
            while True:
                self.expect_op("(")
                row = [self._expr()]
                while self.accept_op(","):
                    row.append(self._expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            stmt.rows = rows
        elif self.at_kw("SELECT") or self.at_op("("):
            sel = self._select_with_setops()
            if not isinstance(sel, ast.Select):
                raise self.error("INSERT ... UNION not supported")
            stmt.select = sel
        elif self.accept_kw("SET"):
            columns, rows = [], [[]]
            while True:
                columns.append(self.expect_ident())
                self.expect_op("=")
                rows[0].append(self._expr())
                if not self.accept_op(","):
                    break
            stmt.columns = columns
            stmt.rows = rows
        else:
            raise self.error("expected VALUES or SELECT")
        if self.accept_kw("ON"):
            self.expect_kw("DUPLICATE")
            self.expect_kw("KEY")
            self.expect_kw("UPDATE")
            sets = []
            while True:
                name = ast.Name([self.expect_ident()])
                self.expect_op("=")
                sets.append((name, self._expr()))
                if not self.accept_op(","):
                    break
            stmt.on_dup_update = sets
        return stmt

    def _update(self) -> ast.Update:
        self.expect_kw("UPDATE")
        table = self._table_refs()
        self.expect_kw("SET")
        sets = []
        while True:
            parts = [self.expect_ident()]
            while self.accept_op("."):
                parts.append(self.expect_ident())
            self.expect_op("=")
            sets.append((ast.Name(parts), self._expr()))
            if not self.accept_op(","):
                break
        stmt = ast.Update(table, sets)
        if self.accept_kw("WHERE"):
            stmt.where = self._expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self._order_list()
        if self.accept_kw("LIMIT"):
            stmt.limit, _ = self._limit_clause()
        return stmt

    def _delete(self) -> ast.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self._table_name()
        table.alias = self._alias()
        stmt = ast.Delete(table)
        if self.accept_kw("WHERE"):
            stmt.where = self._expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self._order_list()
        if self.accept_kw("LIMIT"):
            stmt.limit, _ = self._limit_clause()
        return stmt

    # -- DDL ------------------------------------------------------------------

    def _create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ine = self._if_not_exists()
            return ast.CreateDatabase(self.expect_ident(), ine)
        if self.accept_kw("CCL_RULE"):
            return self._create_ccl_rule()
        if self.accept_kw("SLO"):
            return self._create_slo()
        if self.accept_kw("USER"):
            ine = self._if_not_exists()
            user = self._user_name()
            password = ""
            if self.accept_kw("IDENTIFIED"):
                self.expect_kw("BY")
                password = self.next().text
            return ast.CreateUser(user, password, ine)
        or_replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        if self.accept_kw("VIEW"):
            name = self._table_name()
            cols = None
            if self.accept_op("("):
                cols = [self.expect_ident()]
                while self.accept_op(","):
                    cols.append(self.expect_ident())
                self.expect_op(")")
            self.expect_kw("AS")
            start = self.peek().start
            sel = self._select_with_setops()
            end = self.toks[self.i - 1].end
            return ast.CreateView(name, cols, sel, self.sql[start:end].strip(),
                                  or_replace)
        if or_replace:
            raise self.error("OR REPLACE is only supported for CREATE VIEW")
        unique = self.accept_kw("UNIQUE")
        global_ = self.accept_kw("GLOBAL")
        if self.accept_kw("INDEX"):
            iname = self.expect_ident()
            self.expect_kw("ON")
            table = self._table_name()
            cols, covering, part = self._index_body()
            return ast.CreateIndex(
                ast.IndexDef(iname, cols, unique, global_, covering, part), table)
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        name = self._table_name()
        if self.accept_kw("LIKE"):
            return ast.CreateTable(name, [], if_not_exists=ine, like=self._table_name())
        stmt = ast.CreateTable(name, [], if_not_exists=ine)
        self.expect_op("(")
        while True:
            if self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                self.expect_op("(")
                stmt.primary_key = [self.expect_ident()]
                while self.accept_op(","):
                    stmt.primary_key.append(self.expect_ident())
                self.expect_op(")")
            elif self.at_kw("UNIQUE", "KEY", "INDEX", "GLOBAL", "CONSTRAINT", "FOREIGN"):
                stmt.indexes.append(self._table_index_def())
            else:
                stmt.columns.append(self._column_def())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        # table options + partitioning
        while True:
            if self.accept_kw("ENGINE"):
                self.accept_op("=")
                self.next()
            elif self.accept_kw("DEFAULT"):
                continue
            elif self.accept_kw("CHARSET") or self.accept_kw("CHARACTER"):
                self.accept_kw("SET")
                self.accept_op("=")
                self.next()
            elif self.accept_kw("COLLATE"):
                self.accept_op("=")
                self.next()
            elif self.accept_kw("AUTO_INCREMENT"):
                self.accept_op("=")
                self.next()
            elif self.accept_kw("COMMENT"):
                self.accept_op("=")
                t = self.next()
                stmt.comment = t.text
            elif self.accept_kw("SINGLE"):
                stmt.single = True
            elif self.accept_kw("BROADCAST"):
                stmt.broadcast = True
            elif self.at_kw("PARTITION", "DBPARTITION"):
                stmt.partition = self._partition_def()
            else:
                break
        return stmt

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _column_def(self) -> ast.ColumnDef:
        name = self.expect_ident()
        tn, p, s = self._type_spec()
        unsigned = "UNSIGNED" in tn
        cd = ast.ColumnDef(name, tn.replace(" UNSIGNED", ""), p, s, unsigned)
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                cd.nullable = False
            elif self.accept_kw("NULL"):
                cd.nullable = True
            elif self.accept_kw("DEFAULT"):
                if self.accept_kw("NULL"):
                    cd.default = ast.NullLit()
                else:
                    cd.default = self._unary_expr()
            elif self.accept_kw("AUTO_INCREMENT"):
                cd.auto_increment = True
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                cd.primary_key = True
            elif self.accept_kw("UNIQUE"):
                self.accept_kw("KEY")
            elif self.accept_kw("KEY"):
                pass
            elif self.accept_kw("COMMENT"):
                cd.comment = self.next().text
            elif self.accept_kw("COLLATE") or self.accept_kw("CHARACTER"):
                self.accept_kw("SET")
                self.next()
            elif self.accept_kw("ON"):  # ON UPDATE CURRENT_TIMESTAMP
                self.expect_kw("UPDATE")
                self._unary_expr()
            else:
                return cd

    def _table_index_def(self) -> ast.IndexDef:
        unique = self.accept_kw("UNIQUE")
        global_ = self.accept_kw("GLOBAL")
        if self.accept_kw("CONSTRAINT"):
            self.expect_ident()
            unique = self.accept_kw("UNIQUE")
        if self.accept_kw("FOREIGN"):
            # parse and discard foreign keys (reference doesn't enforce them either)
            self.expect_kw("KEY")
            depth = 0
            while not (depth == 0 and (self.at_op(",") or self.at_op(")"))):
                if self.at_op("("):
                    depth += 1
                elif self.at_op(")"):
                    depth -= 1
                self.next()
            return ast.IndexDef(None, [])
        self.accept_kw("KEY") or self.accept_kw("INDEX")
        name = None
        if self.peek().kind == T.IDENT and not self.at_op("("):
            name = self.expect_ident()
        cols, covering, part = self._index_body()
        return ast.IndexDef(name, cols, unique, global_, covering, part)

    def _index_body(self):
        self.expect_op("(")
        cols = [self.expect_ident()]
        self.accept_op("(") and (self.next(), self.expect_op(")"))  # prefix length
        while self.accept_op(","):
            cols.append(self.expect_ident())
            if self.accept_op("("):
                self.next()
                self.expect_op(")")
        self.expect_op(")")
        covering: List[str] = []
        if self.accept_kw("COVERING"):
            self.expect_op("(")
            covering = [self.expect_ident()]
            while self.accept_op(","):
                covering.append(self.expect_ident())
            self.expect_op(")")
        part = None
        if self.at_kw("PARTITION", "DBPARTITION"):
            part = self._partition_def()
        return cols, covering, part

    def _partition_def(self) -> ast.PartitionDef:
        # PARTITION BY HASH(expr) PARTITIONS n | KEY(cols) | RANGE [COLUMNS](...) (...)
        # legacy: DBPARTITION BY HASH(col) [TBPARTITION ...] — normalized to hash
        first = self.next().upper  # PARTITION | DBPARTITION
        self.expect_kw("BY")
        method_t = self.expect_ident().upper()
        method = method_t.lower()
        if method in ("range", "list") and self.accept_kw("COLUMNS"):
            method += "_columns"
        self.expect_op("(")
        exprs = [self._expr()]
        while self.accept_op(","):
            exprs.append(self._expr())
        self.expect_op(")")
        pd = ast.PartitionDef(method, exprs)
        if self.accept_kw("PARTITIONS"):
            t = self.next()
            pd.count = int(t.text)
        if self.accept_kw("TBPARTITION"):
            self.expect_kw("BY")
            self.expect_ident()
            self.expect_op("(")
            self._expr()
            self.expect_op(")")
            if self.accept_kw("TBPARTITIONS"):
                pd.count = max(pd.count, int(self.next().text))
        if self.at_op("("):
            # explicit partition list: (PARTITION p0 VALUES LESS THAN (...) , ...)
            self.next()
            while True:
                self.expect_kw("PARTITION")
                pname = self.expect_ident()
                self.expect_kw("VALUES")
                if self.accept_kw("LESS"):
                    self.expect_kw("THAN")
                    if self.accept_kw("MAXVALUE"):
                        vals: List[ast.ExprNode] = [ast.Name(["MAXVALUE"])]
                    else:
                        self.expect_op("(")
                        if self.accept_kw("MAXVALUE"):
                            vals = [ast.Name(["MAXVALUE"])]
                        else:
                            vals = [self._expr()]
                            while self.accept_op(","):
                                vals.append(self._expr())
                        self.expect_op(")")
                else:
                    self.expect_kw("IN")
                    self.expect_op("(")
                    vals = [self._expr()]
                    while self.accept_op(","):
                        vals.append(self._expr())
                    self.expect_op(")")
                pd.boundaries.append((pname, vals))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return pd

    def _load_data(self) -> ast.Statement:
        self.expect_kw("LOAD")
        self.expect_kw("DATA")
        local = self.accept_kw("LOCAL")
        self.expect_kw("INFILE")
        t = self.next()
        if t.kind != T.STRING:
            raise self.error("expected file path string")
        path = t.text
        self.accept_kw("REPLACE") or self.accept_kw("IGNORE")
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        table = self._table_name()
        stmt = ast.LoadData(path, table, local)
        if self.accept_kw("FIELDS") or self.accept_kw("COLUMNS"):
            if self.accept_kw("TERMINATED"):
                self.expect_kw("BY")
                stmt.field_terminator = self.next().text
            if self.accept_kw("OPTIONALLY"):
                pass
            if self.accept_kw("ENCLOSED"):
                self.expect_kw("BY")
                stmt.enclosed_by = self.next().text
        if self.accept_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            stmt.line_terminator = self.next().text
        if self.accept_kw("IGNORE"):
            stmt.ignore_lines = int(self.next().text)
            self.expect_kw("LINES")
        if self.at_op("("):
            self.next()
            stmt.columns = [self.expect_ident()]
            while self.accept_op(","):
                stmt.columns.append(self.expect_ident())
            self.expect_op(")")
        return stmt

    _PRIVS = {"SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALTER",
              "INDEX", "ALL"}

    def _grant(self, revoke: bool) -> ast.Statement:
        self.next()  # GRANT | REVOKE
        privs = []
        while True:
            w = self.next().upper
            if w == "ALL":
                self.accept_kw("PRIVILEGES")
                privs = ["ALL"]
            elif w in self._PRIVS:
                privs.append(w)
            else:
                raise self.error(f"unknown privilege {w}")
            if not self.accept_op(","):
                break
        self.expect_kw("ON")
        schema = "*"
        table = "*"
        if self.at_op("*"):
            self.next()
            if self.accept_op("."):
                self.expect_op("*")
        else:
            name = self.expect_ident()
            if self.accept_op("."):
                schema = name
                if self.at_op("*"):
                    self.next()
                else:
                    table = self.expect_ident()
            else:
                # MySQL: a bare name is a TABLE in the current database; the
                # session resolves "" to its schema at execution
                schema = ""
                table = name
        if revoke:
            self.expect_kw("FROM")
        else:
            self.expect_kw("TO")
        user = self._user_name()
        if self.accept_kw("IDENTIFIED"):
            self.expect_kw("BY")
            self.next()
        cls = ast.RevokeStmt if revoke else ast.GrantStmt
        return cls(privs, schema, table, user)

    def _user_name(self) -> str:
        t = self.next()
        if t.kind not in (T.IDENT, T.STRING):
            raise self.error("expected user name")
        user = t.text
        # 'u'@'host' / u@host: the lexer yields the @-part as USERVAR (possibly
        # empty when the host is quoted); the host is ignored — single-host
        # authentication domain
        if self.peek().kind == T.USERVAR:
            hv = self.next()
            if hv.text == "" and self.peek().kind in (T.STRING, T.IDENT):
                self.next()
        return user

    def _alter(self) -> ast.Statement:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        table = self._table_name()
        stmt = ast.AlterTable(table)
        while True:
            if self.accept_kw("ADD"):
                if self.at_kw("COLUMN"):
                    self.next()
                    cd = self._column_def()
                    after = None
                    if self.accept_kw("AFTER"):
                        after = self.expect_ident()
                    elif self.accept_kw("FIRST"):
                        after = ""  # sentinel: place first
                    stmt.actions.append(("add_column", cd, after))
                elif self.at_kw("INDEX", "KEY", "UNIQUE", "GLOBAL"):
                    idx = self._table_index_def()
                    stmt.actions.append(("add_index", idx))
                elif self.accept_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    self.expect_op("(")
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                    stmt.actions.append(("add_primary", cols))
                else:
                    cd = self._column_def()
                    after = None
                    if self.accept_kw("AFTER"):
                        after = self.expect_ident()
                    elif self.accept_kw("FIRST"):
                        after = ""
                    stmt.actions.append(("add_column", cd, after))
            elif self.accept_kw("DROP"):
                if self.at_kw("COLUMN"):
                    self.next()
                    stmt.actions.append(("drop_column", self.expect_ident()))
                elif self.at_kw("INDEX", "KEY"):
                    self.next()
                    stmt.actions.append(("drop_index", self.expect_ident()))
                elif self.accept_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    stmt.actions.append(("drop_primary",))
                else:
                    stmt.actions.append(("drop_column", self.expect_ident()))
            elif self.accept_kw("MODIFY"):
                self.accept_kw("COLUMN")
                stmt.actions.append(("modify_column", self._column_def()))
            elif self.accept_kw("RENAME"):
                self.accept_kw("TO")
                stmt.actions.append(("rename", self._table_name().table))
            elif self.accept_kw("SPLIT"):
                # online elastic split: ALTER TABLE t SPLIT PARTITION p1
                #   [AT (literal)] [INTO n]       (ddl/rebalance.py)
                self.expect_kw("PARTITION")
                pid = self._partition_ref()
                at = None
                into = 2
                if self.accept_kw("AT"):
                    self.expect_op("(")
                    at = self._partition_literal()
                    self.expect_op(")")
                if self.accept_kw("INTO"):
                    nt = self.next()
                    if nt.kind != T.NUMBER:
                        raise self.error("expected partition count after INTO")
                    into = int(nt.text)
                stmt.actions.append(("split_partition", pid, at, into))
            elif self.accept_kw("MERGE"):
                # ALTER TABLE t MERGE PARTITIONS p0, p1
                self.expect_kw("PARTITIONS")
                a = self._partition_ref()
                self.expect_op(",")
                b = self._partition_ref()
                stmt.actions.append(("merge_partitions", a, b))
            elif self.accept_kw("MOVE"):
                # ALTER TABLE t MOVE PARTITION p0 TO 'group'
                self.expect_kw("PARTITION")
                pid = self._partition_ref()
                self.expect_kw("TO")
                gt = self.next()
                if gt.kind not in (T.IDENT, T.STRING):
                    raise self.error("expected placement group after TO")
                stmt.actions.append(("move_partition", pid, gt.text))
            elif self.at_kw("PARTITION", "DBPARTITION"):
                # online repartition: ALTER TABLE t PARTITION BY HASH(c) PARTITIONS n
                stmt.actions.append(("repartition", self._partition_def()))
            else:
                raise self.error("unsupported ALTER TABLE action")
            if not self.accept_op(","):
                break
        return stmt

    def _partition_ref(self) -> int:
        """A partition id: `p3` (the information_schema naming) or bare `3`."""
        t = self.next()
        if t.kind == T.NUMBER:
            return int(t.text)
        txt = t.text.lower()
        if t.kind == T.IDENT and txt.startswith("p") and txt[1:].isdigit():
            return int(txt[1:])
        raise self.error("expected a partition (pN or N)")

    def _partition_literal(self):
        """The AT (...) split point: a number or string literal."""
        neg = self.accept_op("-")
        t = self.next()
        if t.kind == T.NUMBER:
            v = float(t.text) if "." in t.text else int(t.text)
            return -v if neg else v
        if t.kind == T.STRING and not neg:
            return t.text
        raise self.error("expected a literal split point")

    def _create_ccl_rule(self) -> ast.CreateCclRule:
        """CREATE CCL_RULE [IF NOT EXISTS] name WITH opt = val [, ...] —
        the SQL surface over utils/ccl.py (SHOW CCL_RULES reads it back)."""
        ine = self._if_not_exists()
        name = self.expect_ident()
        stmt = ast.CreateCclRule(name, 1, if_not_exists=ine)
        self.expect_kw("WITH")
        saw_conc = False
        while True:
            opt = self.expect_ident().upper()
            self.expect_op("=")
            t = self.next()
            if opt in ("MAX_CONCURRENCY", "WAIT_QUEUE_SIZE", "WAIT_TIMEOUT",
                       "WAIT_TIMEOUT_MS"):
                try:
                    val = int(t.text)
                except ValueError:
                    raise self.error(f"CCL_RULE {opt} expects an integer")
                if opt == "MAX_CONCURRENCY":
                    stmt.max_concurrency = val
                    saw_conc = True
                elif opt == "WAIT_QUEUE_SIZE":
                    stmt.wait_queue_size = val
                else:
                    stmt.wait_timeout_ms = val
            elif opt == "KEYWORD":
                stmt.keyword = t.text
            elif opt == "USER":
                stmt.user = t.text
            else:
                raise self.error(f"unknown CCL_RULE option {opt}")
            if not self.accept_op(","):
                break
        if not saw_conc:
            raise self.error("CCL_RULE requires MAX_CONCURRENCY")
        return stmt

    def _create_slo(self) -> ast.CreateSlo:
        """CREATE SLO [IF NOT EXISTS] name WITH opt = val [, ...] — the
        SQL surface over server/slo.py (SHOW SLO reads it back).  Exactly
        one of TARGET_P99_MS / ERROR_RATIO is required (picks the kind);
        SCHEMA and CLASS scope the objective to a tenant / digest class."""
        ine = self._if_not_exists()
        name = self.expect_ident()
        stmt = ast.CreateSlo(name, if_not_exists=ine)
        self.expect_kw("WITH")
        while True:
            opt = self.expect_ident().upper()
            self.expect_op("=")
            t = self.next()
            if opt in ("TARGET_P99_MS", "ERROR_RATIO"):
                try:
                    val = float(t.text)
                except ValueError:
                    raise self.error(f"SLO {opt} expects a number")
                if opt == "TARGET_P99_MS":
                    stmt.p99_ms = val
                else:
                    stmt.error_ratio = val
            elif opt == "SCHEMA":
                stmt.schema = t.text
            elif opt in ("CLASS", "WORKLOAD"):
                stmt.workload = t.text
            else:
                raise self.error(f"unknown SLO option {opt}")
            if not self.accept_op(","):
                break
        if (stmt.p99_ms is None) == (stmt.error_ratio is None):
            raise self.error(
                "SLO requires exactly one of TARGET_P99_MS or ERROR_RATIO")
        return stmt

    def _drop(self) -> ast.Statement:
        self.expect_kw("DROP")
        if self.accept_kw("SLO"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return ast.DropSlo(self.expect_ident(), ie)
        if self.accept_kw("CCL_RULE"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return ast.DropCclRule(self.expect_ident(), ie)
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return ast.DropDatabase(self.expect_ident(), ie)
        if self.accept_kw("USER"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return ast.DropUser(self._user_name(), ie)
        if self.accept_kw("INDEX"):
            iname = self.expect_ident()
            self.expect_kw("ON")
            return ast.DropIndex(iname, self._table_name())
        if self.accept_kw("VIEW"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            names = [self._table_name()]
            while self.accept_op(","):
                names.append(self._table_name())
            return ast.DropView(names, ie)
        self.expect_kw("TABLE")
        ie = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            ie = True
        names = [self._table_name()]
        while self.accept_op(","):
            names.append(self._table_name())
        return ast.DropTable(names, ie)

    # -- SET / SHOW -----------------------------------------------------------

    def _set(self) -> ast.Statement:
        self.expect_kw("SET")
        if self.accept_kw("NAMES"):
            t = self.next()
            return ast.SetStmt([("session", "names", ast.StringLit(t.text))])
        if self.at_kw("TRANSACTION"):
            self.next()
            self.expect_kw("ISOLATION")
            self.expect_kw("LEVEL")
            words = [self.next().text]
            while self.peek().kind == T.IDENT and not self.at_op(","):
                words.append(self.next().text)
            return ast.SetStmt([("session", "transaction_isolation",
                                 ast.StringLit(" ".join(words)))])
        assignments = []
        while True:
            scope = "session"
            t = self.peek()
            if t.kind == T.SYSVAR:
                self.next()
                name = t.text
                if name.lower().startswith("global."):
                    scope, name = "global", name[7:]
                elif name.lower().startswith("session."):
                    name = name[8:]
            elif t.kind == T.USERVAR:
                self.next()
                scope, name = "user", t.text
            else:
                if self.accept_kw("GLOBAL"):
                    scope = "global"
                else:
                    self.accept_kw("SESSION") or self.accept_kw("LOCAL")
                name = self.expect_ident()
            if not (self.accept_op("=") or self.accept_op(":=")):
                raise self.error("expected '=' in SET")
            if self.peek().is_kw("ON", "OFF") and self.peek(1).kind in (T.EOF,) or \
                    (self.peek().is_kw("ON", "OFF") and
                     (self.peek(1).kind == T.OP and self.peek(1).text in (",", ";"))):
                v: ast.ExprNode = ast.StringLit(self.next().text)
            else:
                v = self._expr()
            assignments.append((scope, name, v))
            if not self.accept_op(","):
                break
        return ast.SetStmt(assignments)

    def _show(self) -> ast.Show:
        self.expect_kw("SHOW")
        full = self.accept_kw("FULL")
        t = self.next()
        kind = t.upper
        stmt = ast.Show(kind.lower(), full=full)
        if kind == "DATABASES" or kind == "SCHEMAS":
            stmt.kind = "databases"
        elif kind == "TABLES":
            if self.accept_kw("FROM") or self.accept_kw("IN"):
                stmt.target = self.expect_ident()
        elif kind in ("COLUMNS", "FIELDS"):
            stmt.kind = "columns"
            self.expect_kw("FROM")
            stmt.target = str(self._table_name().table)
        elif kind == "CREATE":
            self.expect_kw("TABLE")
            stmt.kind = "create_table"
            stmt.target = self._table_name().table
        elif kind == "STATEMENT":
            # SHOW STATEMENT SUMMARY [HISTORY] (statement-digest store)
            self.expect_kw("SUMMARY")
            stmt.kind = "statement_summary"
            if self.accept_kw("HISTORY"):
                stmt.target = "history"
        elif kind == "METRIC":
            # SHOW METRIC HISTORY [LIKE pattern] (utils/metric_history.py)
            self.expect_kw("HISTORY")
            stmt.kind = "metric_history"
        elif kind == "INCIDENTS":
            # SHOW INCIDENTS [<seq>] — flight-recorder bundles
            # (server/flight_recorder.py); a trailing seq (bare number)
            # renders one bundle's full evidence detail
            if self.peek().kind == T.NUMBER:
                stmt.target = self.next().text
        elif kind == "COLUMNAR":
            # SHOW COLUMNAR REPLICA — per-table tailer state, watermark
            # freshness, and tier shape (storage/columnar.py)
            self.expect_kw("REPLICA")
            stmt.kind = "columnar_replica"
        elif kind == "CLUSTER":
            # SHOW CLUSTER HEALTH (coordinator + per-worker snapshots) |
            # SHOW CLUSTER STATEMENT SUMMARY | SHOW CLUSTER METRICS —
            # the latter two merge peer-coordinator rollups via the health
            # pull (unreachable peers render as rows, never errors)
            if self.accept_kw("STATEMENT"):
                self.expect_kw("SUMMARY")
                stmt.kind = "statement_summary"
                stmt.cluster = True
            elif self.accept_kw("METRICS"):
                stmt.kind = "metrics"
                stmt.cluster = True
            else:
                self.expect_kw("HEALTH")
                stmt.kind = "cluster_health"
        elif kind in ("VARIABLES", "STATUS", "WARNINGS", "PROCESSLIST", "COLLATION",
                      "ENGINES", "CHARSET", "TRACE", "INDEX", "INDEXES", "KEYS"):
            if kind in ("INDEX", "INDEXES", "KEYS"):
                stmt.kind = "index"
                if self.accept_kw("FROM") or self.accept_kw("IN"):
                    stmt.target = self._table_name().table
            if self.accept_kw("GLOBAL"):
                pass
        else:
            stmt.kind = kind.lower()
            # permissive: slurp one optional ident (e.g. SHOW GRANTS ...)
            if self.peek().kind == T.IDENT and not self.at_kw("LIKE", "WHERE"):
                stmt.target = self.next().text
        if self.accept_kw("LIKE"):
            t2 = self.next()
            stmt.like = t2.text
        elif self.accept_kw("WHERE"):
            stmt.where = self._expr()
        return stmt


def parse(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()
