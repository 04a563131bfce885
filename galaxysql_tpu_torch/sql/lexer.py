"""MySQL-dialect SQL lexer.

Reference analog: the fastsql fork's zero-copy lexer (`polardbx-parser/.../MySqlLexer.java`,
SURVEY.md §2.3).  Python strings are already cheap slices, so this is a straightforward
single-pass tokenizer; what it preserves from the reference is the token taxonomy needed for
literal parameterization (`SqlParameterized`): every literal token knows its span so the
parameterizer can splice `?` placeholders without re-parsing.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from galaxysql_tpu_torch.utils.errors import SqlSyntaxError


class T(enum.Enum):
    IDENT = "ident"            # bare or `quoted` identifier
    NUMBER = "number"
    STRING = "string"          # '...' or "..." literal
    HEX = "hex"
    PARAM = "param"            # ?
    OP = "op"                  # punctuation / operators
    SYSVAR = "sysvar"          # @@var
    USERVAR = "uservar"        # @var
    EOF = "eof"


@dataclasses.dataclass
class Token:
    kind: T
    text: str          # normalized text (identifiers unquoted, strings unescaped)
    start: int         # span in the original SQL
    end: int
    quoted: bool = False

    @property
    def upper(self) -> str:
        return self.text.upper()

    def is_kw(self, *words: str) -> bool:
        return self.kind == T.IDENT and not self.quoted and self.upper in words

    def __repr__(self):
        return f"<{self.kind.value}:{self.text}>"


_OPERATORS = [
    "<=>", "<<", ">>", "<>", "!=", ">=", "<=", ":=", "||", "&&",
    "(", ")", ",", ".", ";", "+", "-", "*", "/", "%", "=", ">", "<",
    "!", "~", "^", "&", "|",
]


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        # comments
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "#":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlSyntaxError("unterminated comment", sql, i)
            # MySQL hint comments /*+ ... */ are preserved as a pseudo token
            body = sql[i + 2:j]
            if body.startswith("+") or body.startswith("!"):
                toks.append(Token(T.OP, "/*" + body + "*/", i, j + 2))
            i = j + 2
            continue
        start = i
        # string literals
        if c in ("'", '"'):
            quote = c
            i += 1
            buf = []
            while i < n:
                ch = sql[i]
                if ch == "\\" and i + 1 < n:
                    esc = sql[i + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                                "b": "\b", "Z": "\x1a"}.get(esc, esc))
                    i += 2
                    continue
                if ch == quote:
                    if i + 1 < n and sql[i + 1] == quote:  # doubled quote
                        buf.append(quote)
                        i += 2
                        continue
                    i += 1
                    break
                buf.append(ch)
                i += 1
            else:
                raise SqlSyntaxError("unterminated string", sql, start)
            toks.append(Token(T.STRING, "".join(buf), start, i))
            continue
        # quoted identifier
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise SqlSyntaxError("unterminated identifier", sql, i)
            toks.append(Token(T.IDENT, sql[i + 1:j], i, j + 1, quoted=True))
            i = j + 1
            continue
        # numbers (including leading-dot decimals and scientific notation)
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            if c == "0" and i + 1 < n and sql[i + 1] in "xX":
                j = i + 2
                while j < n and sql[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(Token(T.HEX, sql[i:j], i, j))
                i = j
                continue
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and \
                        (sql[j + 1].isdigit() or (sql[j + 1] in "+-" and j + 2 < n
                                                  and sql[j + 2].isdigit())):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token(T.NUMBER, sql[i:j], i, j))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_" or c == "$":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            toks.append(Token(T.IDENT, sql[i:j], i, j))
            i = j
            continue
        # variables
        if c == "@":
            if sql.startswith("@@", i):
                j = i + 2
                # optional scope prefix global./session.
                while j < n and (sql[j].isalnum() or sql[j] in "._"):
                    j += 1
                toks.append(Token(T.SYSVAR, sql[i + 2:j], i, j))
                i = j
                continue
            j = i + 1
            while j < n and (sql[j].isalnum() or sql[j] in "._$"):
                j += 1
            toks.append(Token(T.USERVAR, sql[i + 1:j], i, j))
            i = j
            continue
        if c == "?":
            toks.append(Token(T.PARAM, "?", i, i + 1))
            i += 1
            continue
        # operators
        for op in _OPERATORS:
            if sql.startswith(op, i):
                toks.append(Token(T.OP, op, i, i + len(op)))
                i += len(op)
                break
        else:
            raise SqlSyntaxError(f"unexpected character {c!r}", sql, i)
    toks.append(Token(T.EOF, "", n, n))
    return toks


def split_statements(sql: str) -> List[str]:
    """Split a multi-statement string on top-level ';' (MultiStatementSplitter analog,
    `polardbx-server/.../MultiStatementSplitter.java`)."""
    toks = tokenize(sql)
    out: List[str] = []
    seg_start = 0
    for t in toks:
        if t.kind == T.OP and t.text == ";":
            part = sql[seg_start:t.start].strip()
            if part:
                out.append(part)
            seg_start = t.end
    tail = sql[seg_start:].strip()
    if tail:
        out.append(tail)
    return out
