"""Literal parameterization for plan-cache keying.

Reference analog: `SqlParameterized` (SURVEY.md §2.3) — literals become `?` so that
`SELECT ... WHERE a = 5` and `... a = 7` share one cached plan (`PlanCache.java:80`, keyed at
`Planner.java:255,270`).  Works at token level: no parse needed on the cache-hit path, which
is exactly why the reference does it this way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from galaxysql_tpu_torch.sql.lexer import T, Token, tokenize


@dataclasses.dataclass(frozen=True)
class DecimalParam:
    """A dotted numeric literal with its textual scale preserved.

    MySQL treats 0.06 as an exact DECIMAL(_,2); losing that to a float64 param would
    change comparison semantics (see the Q6/Q14 decimal-literal findings)."""
    value: float
    scale: int

    def __repr__(self):
        return f"{self.value:.{self.scale}f}"


@dataclasses.dataclass
class ParameterizedSql:
    sql: str                 # original SQL
    parameterized: str       # literals replaced by ?
    params: List[Any]        # extracted literal values (str | int | float)
    # slot plan for EVERY ? in `parameterized`, in order:
    #   ("lit", value)  — a literal this pass extracted
    #   ("client", k)   — the k-th placeholder the client sent in the original SQL
    slots: List[Tuple[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def cache_key(self) -> str:
        return self.parameterized

    def resolve(self, client_params: List[Any]) -> List[Any]:
        """Bind values for all ?s: extracted literals + client-protocol params."""
        from galaxysql_tpu_torch.utils.errors import TddlError
        out: List[Any] = []
        for kind, v in self.slots:
            if kind == "lit":
                out.append(v)
            else:
                if v >= len(client_params):
                    raise TddlError("not enough parameters bound")
                out.append(client_params[v])
        return out


# keywords after which a literal is structural, not a data value (don't parameterize).
# DATE/TIMESTAMP/TIME keyword literals stay inline so the parser can type them.
_KEEP_BEFORE = {"LIMIT", "OFFSET", "PARTITIONS", "TBPARTITIONS", "INTERVAL", "TOP",
                "DATE", "TIMESTAMP", "TIME"}
_KEEP_STMT_PREFIX = {"CREATE", "ALTER", "DROP", "SET", "SHOW", "USE", "KILL", "ANALYZE",
                     "TRUNCATE", "DESC", "DESCRIBE", "EXPLAIN", "BEGIN", "COMMIT",
                     "ROLLBACK", "START", "GRANT", "REVOKE"}


def parameterize(sql: str) -> ParameterizedSql:
    """Memoized by exact SQL text: OLTP traffic repeats statements (and the
    batch scheduler's whole premise is plan-cache-identical repetition), so
    the token sweep runs once per distinct text.  Safe because
    ParameterizedSql is never mutated after construction — resolve() returns
    a fresh list."""
    hit = _PARAM_CACHE.get(sql)
    if hit is not None:
        return hit
    p = _parameterize(sql)
    if len(sql) <= _PARAM_CACHE_MAX_SQL:
        # don't retain bulk-load texts: a distinct multi-megabyte INSERT is
        # held ~3x per entry (key + raw + parameterized) and never repeats —
        # the repeated-statement win lives entirely in short OLTP texts
        if len(_PARAM_CACHE) >= _PARAM_CACHE_CAP:
            _PARAM_CACHE.clear()  # epoch reset: bounded, no LRU bookkeeping
        _PARAM_CACHE[sql] = p
    return p


_PARAM_CACHE: dict = {}
_PARAM_CACHE_CAP = 8192
_PARAM_CACHE_MAX_SQL = 4096


def _parameterize(sql: str) -> ParameterizedSql:
    toks = tokenize(sql)
    first = next((t for t in toks if t.kind != T.OP or not t.text.startswith("/*")), toks[-1])
    if first.kind == T.IDENT and first.upper in _KEEP_STMT_PREFIX:
        # DDL/utility statements aren't plan-cached; EXPLAIN shares the inner statement's
        # literals but is cheap enough to skip too.
        return ParameterizedSql(sql, sql, [])

    out: List[str] = []
    params: List[Any] = []
    slots: List[Tuple[str, Any]] = []
    client_ix = 0
    pos = 0
    prev_sig: Token | None = None
    # GROUP BY / ORDER BY ordinal tracking: a bare integer that IS a whole by-list item
    # is a column ordinal, structural for the plan — never parameterize it
    _BY_HEADS = {"GROUP", "ORDER"}
    _BY_ENDERS = {"HAVING", "ORDER", "LIMIT", "WHERE", "GROUP", "UNION", "FOR",
                  "LOCK", "OFFSET"}
    in_by_list = False
    for i, t in enumerate(toks):
        if t.kind == T.IDENT and not t.quoted:
            if t.upper == "BY" and prev_sig is not None and \
                    prev_sig.kind == T.IDENT and prev_sig.upper in _BY_HEADS:
                in_by_list = True
            elif t.upper in _BY_ENDERS:
                in_by_list = False
        elif t.kind == T.OP and t.text in ("(", ")"):
            # parens close the by-list scope (a subquery ending at ')' must not leak
            # its ordinal context into the outer query's literals)
            in_by_list = False
        if t.kind == T.PARAM:
            slots.append(("client", client_ix))
            client_ix += 1
            prev_sig = t
            continue
        if t.kind not in (T.NUMBER, T.STRING, T.HEX):
            if t.kind != T.EOF:
                prev_sig = t
            continue
        if in_by_list and t.kind == T.NUMBER and prev_sig is not None and \
                ((prev_sig.kind == T.OP and prev_sig.text == ",") or
                 prev_sig.is_kw("BY")):
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            if nxt is None or nxt.kind == T.EOF or \
                    (nxt.kind == T.OP and nxt.text in (",", ";", ")")) or \
                    nxt.is_kw("ASC", "DESC", *(_BY_ENDERS)):
                prev_sig = t
                continue  # ordinal, keep inline
        if prev_sig is not None:
            if prev_sig.kind == T.IDENT and not prev_sig.quoted and \
                    prev_sig.upper in _KEEP_BEFORE:
                prev_sig = t
                continue
        # LIMIT 10, 20 — second literal after comma still under LIMIT
        if prev_sig is not None and prev_sig.kind == T.OP and prev_sig.text == "," and i >= 2:
            # find the significant token before the comma's left operand
            k = i - 2
            while k >= 0 and toks[k].kind in (T.NUMBER, T.STRING, T.HEX):
                k -= 1
                break
            if k >= 0 and toks[k].kind == T.IDENT and toks[k].upper in _KEEP_BEFORE:
                prev_sig = t
                continue
        out.append(sql[pos:t.start])
        out.append("?")
        pos = t.end
        if t.kind == T.NUMBER:
            if "." in t.text and "e" not in t.text.lower():
                v = DecimalParam(float(t.text), min(len(t.text.split(".")[1]), 8))
            elif "e" in t.text.lower():
                v = float(t.text)
            else:
                v = int(t.text)
        elif t.kind == T.HEX:
            v = int(t.text, 16)
        else:
            v = t.text
        params.append(v)
        slots.append(("lit", v))
        prev_sig = t
    out.append(sql[pos:])
    return ParameterizedSql(sql, "".join(out), params, slots)
