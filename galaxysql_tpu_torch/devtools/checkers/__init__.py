"""Checker registry: the four repo-specific galaxylint passes.

Adding a pass = subclass `devtools.lint.Checker`, implement `check`
(per-file) and/or `finalize` (cross-file), list it here.
"""

from galaxysql_tpu_torch.devtools.checkers.lock_order import LockOrderChecker
from galaxysql_tpu_torch.devtools.checkers.jit_discipline import JitDisciplineChecker
from galaxysql_tpu_torch.devtools.checkers.typed_errors import TypedErrorChecker
from galaxysql_tpu_torch.devtools.checkers.hygiene import HygieneChecker

ALL_CHECKERS = [
    LockOrderChecker(),
    JitDisciplineChecker(),
    TypedErrorChecker(),
    HygieneChecker(),
]
