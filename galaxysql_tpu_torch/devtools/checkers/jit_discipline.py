"""jit-raw / pallas-raw / jit-device-sync: the program-cache discipline, on the port.

The JAX package's checker of the same name guards `global_jit`, `pl.pallas_call`
and device syncs.  Eager PyTorch compiles no program, and the port's kernels are
CUDA C++, so each rule keeps its name and its intent on the port's counterpart:

- **jit-raw**: an expression closure compiled for a device, `ExprCompiler(...)` with
  any backend but numpy (`ExprCompiler(TorchXP(device))`), OUTSIDE a builder passed
  to `closure_cache`, the port's `global_jit`.  A closure compiled per execution
  escapes the process-wide closure LRU, so a repeated query rebuilds its
  expression tree every time, as a `jax.jit` outside `global_jit` retraces.  The
  compile is legal only inside a function whose name is passed to `closure_cache`
  in the same module (the `def build(): ... ExprCompiler(xp) ...` idiom) or in a
  lambda written directly into a `closure_cache(...)` argument.  `ExprCompiler(np)`
  is the host engine's compiler and no device program.
- **pallas-raw**: a call into a kernel library of `kernels/cuda_build.py`
  (`cuda_build.function(...)` or `cuda_build.library(...)`, the port's
  `pl.pallas_call`) outside the `kernels/cuda_*.py` wrappers, or inside one in a
  function that does not count the launch (`LAUNCHES[...] += 1`).  Every kernel
  launch goes through a wrapper that counts it: that is how `chip_smoke.py` shows
  the main path went through each kernel (ROADMAP rule 3).
- **jit-device-sync**: `.item()` and `torch.cuda.synchronize()` in the hot-path
  layers (exec/, kernels/, parallel/, chunk/, server/, storage/) force a
  host<->device sync per call, unless the enclosing scope is profiling, EXPLAIN,
  stats or tracing machinery (the reference's allowlist of qualname patterns),
  where the sync is the point.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from galaxysql_tpu_torch.devtools.lint import Checker, Module

HOT_PREFIXES = ("galaxysql_tpu_torch/exec/", "galaxysql_tpu_torch/kernels/",
                "galaxysql_tpu_torch/parallel/", "galaxysql_tpu_torch/chunk/",
                "galaxysql_tpu_torch/server/", "galaxysql_tpu_torch/storage/")

# the kernel wrappers: the only modules that may call into a kernel library
WRAPPER = re.compile(r"^galaxysql_tpu_torch/kernels/cuda_(?!build\.py$)\w+\.py$")

# scopes where a device sync is the feature, not a leak: profiling, EXPLAIN
# ANALYZE, benchmarks, tracing/telemetry observation hooks
ALLOW_QUAL = re.compile(
    r"explain|profil|bench|analyz|stats|trace|observe|debug|telemetry",
    re.IGNORECASE)


def _is_device_compile(call: ast.Call) -> bool:
    """`ExprCompiler(<backend>)` with a backend other than numpy."""
    f = call.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    if name != "ExprCompiler" or not call.args:
        return False
    a = call.args[0]
    return not (isinstance(a, ast.Name) and a.id in ("np", "numpy"))


def _is_closure_cache(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id == "closure_cache"
    return isinstance(f, ast.Attribute) and f.attr == "closure_cache"


def _build_aliases(tree: ast.AST) -> Set[str]:
    """The names this module binds to `kernels/cuda_build`."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("kernels"):
            out.update(a.asname or a.name for a in node.names
                       if a.name == "cuda_build")
        elif isinstance(node, ast.Import):
            out.update(a.asname for a in node.names
                       if a.name.endswith("kernels.cuda_build") and a.asname)
    return out


def _counts_launch(fn: ast.AST) -> bool:
    """True when the function adds to a `LAUNCHES[...]` entry."""
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript) \
                and isinstance(node.target.value, ast.Name) \
                and node.target.value.id == "LAUNCHES":
            return True
    return False


class JitDisciplineChecker(Checker):
    rules = ("jit-raw", "pallas-raw", "jit-device-sync")
    description = ("device expression compiles outside a closure_cache builder; "
                   "kernel-library calls outside the launch-counting "
                   "kernels/cuda_*.py wrappers; device-sync primitives on the hot "
                   "path outside profiling/EXPLAIN/stats/tracing scopes")

    def check(self, mod: Module):
        findings = []
        findings.extend(self._check_raw_compile(mod))
        findings.extend(self._check_raw_kernel(mod))
        if mod.relpath.startswith(HOT_PREFIXES):
            findings.extend(self._check_device_sync(mod))
        return findings

    # -- jit-raw -------------------------------------------------------------------

    def _check_raw_compile(self, mod: Module):
        builder_names: Set[str] = set()
        allowed_lambdas: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _is_closure_cache(node):
                args = list(node.args) + [kw.value for kw in node.keywords]
                for a in args:
                    if isinstance(a, ast.Name):
                        builder_names.add(a.id)
                for a in args:
                    for sub in ast.walk(a):
                        if isinstance(sub, ast.Lambda):
                            allowed_lambdas.add(id(sub))

        findings = []

        def in_builder(stack: List[ast.AST]) -> bool:
            for s in stack:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                        s.name in builder_names:
                    return True
                if isinstance(s, ast.Lambda) and id(s) in allowed_lambdas:
                    return True
            return False

        def walk(node: ast.AST, stack: List[ast.AST]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Call) and _is_device_compile(child) \
                        and not in_builder(stack):
                    findings.append(self.finding(
                        mod, child.lineno,
                        "device expression compile outside a closure_cache "
                        "builder: the closure escapes the process-wide LRU and "
                        "is rebuilt at every execution",
                        rule="jit-raw"))
                walk(child, stack + [child])

        walk(mod.tree, [])
        return findings

    # -- pallas-raw ----------------------------------------------------------------

    def _check_raw_kernel(self, mod: Module):
        aliases = _build_aliases(mod.tree)
        if not aliases:
            return []
        wrapper = bool(WRAPPER.match(mod.relpath))
        findings = []

        def walk(node: ast.AST, fn):
            for child in ast.iter_child_nodes(node):
                inner = child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
                if isinstance(child, ast.Call) and \
                        isinstance(child.func, ast.Attribute) and \
                        child.func.attr in ("function", "library") and \
                        isinstance(child.func.value, ast.Name) and \
                        child.func.value.id in aliases and \
                        not (wrapper and fn is not None and _counts_launch(fn)):
                    findings.append(self.finding(
                        mod, child.lineno,
                        f"kernel library call {child.func.value.id}."
                        f"{child.func.attr}() outside a launch-counting "
                        f"kernels/cuda_*.py wrapper: the launch is invisible to "
                        f"the LAUNCHES counts that show a path ran its kernels",
                        rule="pallas-raw"))
                walk(child, inner)

        walk(mod.tree, None)
        return findings

    # -- jit-device-sync -----------------------------------------------------------

    def _check_device_sync(self, mod: Module):
        findings = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == "item" and not node.args:
                what = ".item()"
            elif f.attr == "synchronize" and isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "cuda" and isinstance(f.value.value, ast.Name) and \
                    f.value.value.id == "torch":
                what = "torch.cuda.synchronize()"
            else:
                continue
            qual = mod.qualname_at(node.lineno)
            if ALLOW_QUAL.search(qual or ""):
                continue
            findings.append(self.finding(
                mod, node.lineno,
                f"{what} forces a host<->device sync; on the default query path "
                f"every call stalls the launch queue (profiling/EXPLAIN/stats/"
                f"tracing scopes are allowlisted by name)",
                rule="jit-device-sync", severity="warn"))
        return findings
