"""Drift test: every module the port keeps as a verbatim copy of a JAX-package module
must equal its source once import statements are set aside (the copies differ only in
the package their imports name).  A change to either side fails here until the other
side follows."""

import ast
import os

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "types/datatype.py", "types/temporal.py", "types/collation.py", "utils/errors.py",
    "sql/lexer.py", "sql/ast.py", "sql/parser.py", "sql/parameterize.py", "sql/hints.py",
    "meta/tso.py", "meta/catalog.py", "meta/statistics.py", "storage/tpch.py",
    "storage/tpch_queries.py", "storage/tpcds.py",
    "exec/runtime_filter.py", "exec/skew.py", "expr/ir.py",
    "plan/logical.py", "plan/rules.py", "plan/binder.py", "plan/planner.py", "plan/spm.py",
    "config/params.py", "utils/failpoint.py",
]


class _DropImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _body(path: str) -> str:
    with open(path) as f:
        tree = ast.parse(f.read())
    return ast.dump(_DropImports().visit(tree))


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_source(rel):
    src = os.path.join(ROOT, "galaxysql_tpu", rel)
    dst = os.path.join(ROOT, "galaxysql_tpu_torch", rel)
    assert _body(src) == _body(dst), f"{rel} drifted from galaxysql_tpu/{rel}"
    # and the copy's imports name the port, never the JAX package
    for mod in _imports(dst):
        assert mod != "galaxysql_tpu" and not mod.startswith("galaxysql_tpu.")
        assert mod != "jax" and not mod.startswith("jax.")
