"""lock-order / lock-blocking: the static half of the lockdep story.

Extracts the lock-nesting graph from `with <lock>:` blocks across the
concurrency-bearing layers (storage/, server/, txn/, exec/, meta/) with one
level of call-graph propagation (a call made while holding L, to a
same-module function that itself acquires M, contributes the edge L -> M),
then checks:

- **lock-order**: edges that invert the canonical rank order
  `append_lock/columnar (0) -> partition (1) -> store/metadb (2)`, or nest
  two locks of the same unordered class (two partition locks held together
  have no declared intra-class order).  The columnar tailer lock
  (ColumnarReplicaManager._lock) ranks with append_lock: seeding snapshots
  partitions and persistence writes metadb while holding it, never the
  reverse — the query path reads tier snapshots lock-free.
- **lock-blocking**: blocking operations — worker RPC (`.request`), metadb
  IO, `time.sleep`, device syncs (`.block_until_ready()`, `.item()`) —
  executed while a HOT lock (append_lock, partition) is held.  Hot locks sit
  on the DML flush path; anything slow under them convoys every writer.

Lock classes are inferred from the `with` expression: the attribute name and
its receiver (`store.append_lock` -> append_lock, `p.lock` / `self.lock`
inside class Partition -> partition, MetaDb's `self._lock` -> metadb).
Unrecognized `*lock*` attributes become class-scoped nodes (`Owner._lock`) —
they participate in the graph but carry no rank.  Condition variables are
excluded: `wait()` releases, so nesting proves nothing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from galaxysql_tpu_torch.devtools.lint import Checker, Finding, Module

SCOPE_PREFIXES = ("galaxysql_tpu_torch/storage/", "galaxysql_tpu_torch/server/",
                  "galaxysql_tpu_torch/txn/", "galaxysql_tpu_torch/exec/",
                  "galaxysql_tpu_torch/meta/")

RANKS = {"append_lock": 0, "columnar": 0, "partition": 1, "store": 2,
         "metadb": 2}
HOT = ("append_lock", "partition")

_PARTITION_RECVS = {"p", "part", "partition", "pt"}
_METADB_RECVS = {"metadb", "db"}


def _recv_chain(expr: ast.AST) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _recv_chain(expr.value)
        return f"{base}.{expr.attr}" if base else expr.attr
    if isinstance(expr, ast.Call):
        return _recv_chain(expr.func)
    return ""


def lock_name(expr: ast.AST, class_name: str) -> Optional[str]:
    """Canonical lock class for a with-item expression, or None when the
    expression is not a lock (spans, errstate, device contexts...)."""
    if isinstance(expr, ast.Attribute):
        attr = expr.attr
        recv = _recv_chain(expr.value)
    elif isinstance(expr, ast.Name):
        attr, recv = expr.id, ""
    else:
        return None
    low = attr.lower()
    if "cond" in low:
        return None  # condition vars: wait() releases, nesting proves nothing
    if "lock" not in low and low not in ("_mu", "mu", "_bk_lock"):
        return None
    if attr == "append_lock":
        return "append_lock"
    base = recv.split(".")[-1] if recv else ""
    if attr == "lock":
        if base in _PARTITION_RECVS:
            return "partition"
        if base == "self" and class_name == "Partition":
            return "partition"
        if base in ("instance", "inst") or (base == "self"
                                            and class_name == "Instance"):
            return "instance"
        if base in ("store", "gstore", "tstore"):
            return "store"
    if attr in ("lock", "_lock"):
        if base in _METADB_RECVS or (base == "self" and class_name == "MetaDb"):
            return "metadb"
        if base == "self" and class_name == "ColumnarReplicaManager":
            return "columnar"
    owner = base if base not in ("self", "") else (class_name or "module")
    return f"{owner}.{attr}"


def _blocking_op(call: ast.Call) -> Optional[str]:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    recv = _recv_chain(f.value)
    base = recv.split(".")[-1] if recv else ""
    if attr == "sleep" and base in ("time", "_time", "_t"):
        return "time.sleep"
    if attr == "request" and base not in ("self",):
        return "worker RPC (.request)"
    if attr == "block_until_ready":
        return "device sync (block_until_ready)"
    if "metadb" in recv and attr in (
            "execute", "executemany", "executescript", "commit", "tx_log_put",
            "tx_log_put_many", "kv_put", "write_events", "put", "delete"):
        return f"metadb IO ({attr})"
    return None


class _Edge:
    __slots__ = ("a", "b", "line", "via", "same_expr")

    def __init__(self, a, b, line, via="", same_expr=False):
        self.a, self.b, self.line, self.via = a, b, line, via
        self.same_expr = same_expr


class LockOrderChecker(Checker):
    rules = ("lock-order", "lock-blocking")
    description = ("static lock-nesting graph vs the canonical "
                   "append_lock -> partition -> store/metadb order, plus "
                   "blocking ops under hot locks")

    def check(self, mod: Module):
        if not mod.relpath.startswith(SCOPE_PREFIXES):
            return []
        findings: List[Finding] = []
        # pass 1: per top-level function — lexical edges, blocking ops,
        # call sites under held locks, and each function's own acquisitions
        func_acquires: Dict[str, Set[str]] = {}
        call_sites: List[Tuple[List[str], str, int]] = []
        edges: List[_Edge] = []

        def scan(node: ast.AST, held: List[Tuple[str, str]], class_name: str,
                 acquires: Set[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.With):
                    names: List[Tuple[str, str]] = []
                    for item in child.items:
                        nm = lock_name(item.context_expr, class_name)
                        if nm is None:
                            continue
                        expr_text = ast.dump(item.context_expr)
                        for prev_nm, prev_expr in held + names:
                            edges.append(_Edge(
                                prev_nm, nm, child.lineno,
                                same_expr=(prev_expr == expr_text)))
                        names.append((nm, expr_text))
                        acquires.add(nm)
                    scan(child, held + names, class_name, acquires)
                    continue
                if isinstance(child, ast.Call):
                    if held:
                        op = _blocking_op(child)
                        hot = [h for h, _ in held if h in HOT]
                        if op is not None and hot:
                            findings.append(self.finding(
                                mod, child.lineno,
                                f"{op} under hot lock "
                                f"'{hot[-1]}' — blocking work on the write "
                                f"hot path convoys every writer",
                                rule="lock-blocking", severity="warn"))
                        callee = ""
                        if isinstance(child.func, ast.Name):
                            callee = child.func.id
                        elif isinstance(child.func, ast.Attribute) and \
                                isinstance(child.func.value, ast.Name) and \
                                child.func.value.id == "self":
                            callee = child.func.attr
                        if callee:
                            call_sites.append(
                                ([h for h, _ in held], callee, child.lineno))
                    scan(child, held, class_name, acquires)
                    continue
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # nested defs run later, not under the current holds
                    sub: Set[str] = set()
                    scan(child, [], class_name, sub)
                    func_acquires.setdefault(child.name, set()).update(sub)
                    acquires.update(sub)  # conservative: builder runs inline
                    continue
                scan(child, held, class_name, acquires)

        def top(node: ast.AST, class_name: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    top(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    acq: Set[str] = set()
                    scan(child, [], class_name, acq)
                    func_acquires.setdefault(child.name, set()).update(acq)

        top(mod.tree, "")

        # pass 2: one level of call-graph propagation (same module only)
        for held, callee, line in call_sites:
            for m in func_acquires.get(callee, ()):
                for h in held:
                    if h != m:
                        edges.append(_Edge(h, m, line, via=callee))

        # pass 3: judge the edges
        seen: Set[Tuple[str, str, int]] = set()
        for e in edges:
            key = (e.a, e.b, e.line)
            if key in seen:
                continue
            seen.add(key)
            via = f" (via call to {e.via}())" if e.via else ""
            if e.a == e.b:
                if e.same_expr or e.via:
                    continue  # re-entrant same instance (RLock) — legal
                findings.append(self.finding(
                    mod, e.line,
                    f"two '{e.a}' locks held together{via} — no intra-class "
                    f"order is declared for this lock class",
                    rule="lock-order"))
                continue
            ra, rb = RANKS.get(e.a), RANKS.get(e.b)
            if ra is not None and rb is not None and ra > rb:
                findings.append(self.finding(
                    mod, e.line,
                    f"lock-order inversion: '{e.b}' (rank {rb}) acquired "
                    f"while holding '{e.a}' (rank {ra}){via}; canonical "
                    f"order is append_lock -> partition -> store/metadb",
                    rule="lock-order"))
        return findings
