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
    "utils/lockdep.py", "meta/gms.py", "meta/privileges.py", "net/packets.py",
    "net/client.py", "net/dn.py", "meta/ha.py", "meta/mdl.py", "exec/spill.py",
    "exec/memory.py",
    "utils/metrics.py", "storage/zonemap.py", "utils/tracing.py",
    "exec/fragment_cache.py", "utils/events.py", "storage/ssb.py",
    "meta/statement_summary.py", "utils/metric_history.py", "utils/ccl.py",
    "server/admission.py", "server/slo.py", "server/flight_recorder.py",
    "server/web.py", "utils/locks.py", "server/scheduler.py",
    "meta/sequence.py", "utils/fastchecker.py", "server/placement.py",
    "server/balancer.py", "server/router.py", "ddl/rebalance.py", "ddl/repartition.py",
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


# galaxylint's jax-free modules: copies whose package path strings (the hot, scope
# and ramp prefixes, the tree walked, the fixture path) name the port
DEVTOOLS_COPIES = ["devtools/lint.py", "devtools/checkers/__init__.py",
                   "devtools/checkers/hygiene.py", "devtools/checkers/lock_order.py",
                   "devtools/checkers/typed_errors.py"]


def _renamed_body(path: str) -> str:
    with open(path) as f:
        tree = ast.parse(f.read().replace("galaxysql_tpu_torch", "galaxysql_tpu"))
    return ast.dump(_DropImports().visit(tree))


@pytest.mark.parametrize("rel", DEVTOOLS_COPIES)
def test_devtools_copy_matches_source_with_the_package_renamed(rel):
    src = os.path.join(ROOT, "galaxysql_tpu", rel)
    dst = os.path.join(ROOT, "galaxysql_tpu_torch", rel)
    assert _body(src) == _renamed_body(dst), f"{rel} drifted from galaxysql_tpu/{rel}"
    for mod in _imports(dst):
        assert mod != "galaxysql_tpu" and not mod.startswith("galaxysql_tpu.")
        assert mod != "jax" and not mod.startswith("jax.")


def test_native_source_is_verbatim():
    """The C++ host runtime the port builds (`galaxysql_tpu_torch/native`) is the
    reference's source, byte for byte."""
    with open(os.path.join(ROOT, "galaxysql_tpu", "native", "galaxystore.cpp"), "rb") as f:
        src = f.read()
    with open(os.path.join(ROOT, "galaxysql_tpu_torch", "native", "galaxystore.cpp"),
              "rb") as f:
        assert f.read() == src
