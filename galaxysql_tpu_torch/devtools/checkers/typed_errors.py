"""swallow / untyped-raise: the typed-error wire contract.

The engine's error taxonomy (`utils/errors`, PR 8/12) guarantees that every
failure a client or operator sees is TYPED — carries (errno, sqlstate),
survives the wire, rides error spans, counts in metrics.  Two ways code
quietly breaks that contract on the wire/exec ramps (net/, server/, txn/):

- **swallow**: an `except Exception` (or bare `except:`) whose handler does
  NOTHING — only pass/continue/constant-return/constant-assign, never
  referencing the caught exception, no re-raise, no journal event, no typed
  translation.  The failure evaporates: no event, no counter, no trace.
- **untyped-raise**: `raise Exception/ValueError/RuntimeError(...)` where
  the `utils/errors` taxonomy is the contract — the wire layer renders
  errno 1105 "unknown error" and the client learns nothing.

Handlers that DO something (fall back with a recorded value, publish an
event, translate, re-raise) are not findings.  Deliberate silent drops
(close-path socket errors) and intra-module control-flow raises (the group
fallback RuntimeErrors the flush catches) carry pragmas with justification.
"""

from __future__ import annotations

import ast
from typing import List

from galaxysql_tpu_torch.devtools.lint import Checker, Module

RAMP_PREFIXES = ("galaxysql_tpu_torch/net/", "galaxysql_tpu_torch/server/",
                 "galaxysql_tpu_torch/txn/")

UNTYPED = {"Exception", "ValueError", "RuntimeError", "TypeError",
           "KeyError", "OSError", "IOError"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name):
        return t.id in ("Exception", "BaseException")
    return False


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_trivial_stmt(stmt: ast.stmt, exc_name: str) -> bool:
    """True when the statement neither records, translates, re-raises nor
    even references the caught exception."""
    if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
        return True
    if isinstance(stmt, ast.Return):
        v = stmt.value
        if v is None or isinstance(v, ast.Constant):
            return True
        if isinstance(v, (ast.List, ast.Tuple, ast.Dict)) and \
                not any(isinstance(x, ast.Call) for x in ast.walk(v)) and \
                (not exc_name or exc_name not in _names_in(v)):
            return True
        return False
    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        val = getattr(stmt, "value", None)
        if val is None:
            return True
        if any(isinstance(x, ast.Call) for x in ast.walk(val)):
            return False
        if exc_name and exc_name in _names_in(val):
            return False
        return True
    return False


class TypedErrorChecker(Checker):
    rules = ("swallow", "untyped-raise")
    description = ("silent except-Exception swallows and untyped raises on "
                   "the wire/exec ramps (utils/errors is the contract)")

    def check(self, mod: Module):
        if not mod.relpath.startswith(RAMP_PREFIXES):
            return []
        findings: List[ast.AST] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and _is_broad(node):
                exc_name = node.name or ""
                if all(_is_trivial_stmt(s, exc_name) for s in node.body):
                    findings.append(self.finding(
                        mod, node.lineno,
                        "except Exception swallows silently: no re-raise, "
                        "no journal event, no typed translation — the "
                        "failure leaves no trace anywhere",
                        rule="swallow"))
            elif isinstance(node, ast.Raise):
                exc = node.exc
                if isinstance(exc, ast.Call) and \
                        isinstance(exc.func, ast.Name) and \
                        exc.func.id in UNTYPED:
                    findings.append(self.finding(
                        mod, node.lineno,
                        f"raise {exc.func.id} on a wire/exec ramp: the "
                        f"utils/errors taxonomy is the contract (clients "
                        f"see errno 1105 'unknown error' otherwise)",
                        rule="untyped-raise"))
        return findings
