"""galaxylint for the port: repo-specific static analysis of `galaxysql_tpu_torch`.

The JAX package's `devtools/` mechanizes the engine's hand-enforced invariants (the
append_lock-before-partition-lock ordering, the typed-error wire contract,
failpoint/metrics hygiene, the program-cache discipline) as AST passes.  The port
keeps the lint framework and three of its four checkers as copies with only the
package paths changed (`lint.py`, `checkers/lock_order.py`, `typed_errors.py`,
`hygiene.py`); `checkers/jit_discipline.py` keeps the fourth checker's rules on the
port's counterparts of `jax.jit`, `pl.pallas_call` and device syncs.

Entry point: `python -m galaxysql_tpu_torch.devtools.lint` (exit 0 on a clean tree).
The runtime half is `utils/lockdep.py`.
"""
