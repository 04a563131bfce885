"""Shared harness of the operations-plane parity tests (`tests/test_torch_*.py` of
the statement summary, overload, SLO and observability surfaces).

`JAX` and `PORT` name each package's entry points and process-wide objects under
one set of attribute names, so a scenario written once as `scenario(pkg)` runs
through the JAX `Instance` and the port's `Instance(device="cpu")`; `both` runs it
through each and asserts equal outcomes.  A scenario returns only what both
packages must agree on: measured latencies, trace ids, node ids and the three
`COMPILE_STATS` counters (XLA programs in the reference, kernel builds in the
port) are left out of every outcome by the scenarios themselves.
"""

import threading
import types

from galaxysql_tpu.exec import memory as jax_memory
from galaxysql_tpu.exec import operators as jax_ops
from galaxysql_tpu.meta import statement_summary as jax_ssm
from galaxysql_tpu.plan import spm as jax_spm
from galaxysql_tpu.server import admission as jax_admission
from galaxysql_tpu.server import flight_recorder as jax_recorder
from galaxysql_tpu.server import scheduler as jax_scheduler
from galaxysql_tpu.server import slo as jax_slo
from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.server.web import WebConsole as JaxWebConsole
from galaxysql_tpu.utils import ccl as jax_ccl
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu.utils import failpoint as jax_failpoint
from galaxysql_tpu.utils import locks as jax_locks
from galaxysql_tpu.utils import metric_history as jax_mh
from galaxysql_tpu.utils import tracing as jax_tracing
from galaxysql_tpu.utils.events import EVENTS as JAX_EVENTS
from galaxysql_tpu_torch.exec import memory as port_memory
from galaxysql_tpu_torch.exec import operators as port_ops
from galaxysql_tpu_torch.meta import statement_summary as port_ssm
from galaxysql_tpu_torch.plan import spm as port_spm
from galaxysql_tpu_torch.server import admission as port_admission
from galaxysql_tpu_torch.server import flight_recorder as port_recorder
from galaxysql_tpu_torch.server import scheduler as port_scheduler
from galaxysql_tpu_torch.server import slo as port_slo
from galaxysql_tpu_torch.server.instance import Instance as PortInstance
from galaxysql_tpu_torch.server.session import Session as PortSession
from galaxysql_tpu_torch.server.web import WebConsole as PortWebConsole
from galaxysql_tpu_torch.utils import ccl as port_ccl
from galaxysql_tpu_torch.utils import errors as port_errors
from galaxysql_tpu_torch.utils import failpoint as port_failpoint
from galaxysql_tpu_torch.utils import locks as port_locks
from galaxysql_tpu_torch.utils import metric_history as port_mh
from galaxysql_tpu_torch.utils import tracing as port_tracing
from galaxysql_tpu_torch.utils.events import EVENTS as PORT_EVENTS


def _pkg(name, instance, session, **mods):
    return types.SimpleNamespace(name=name, Instance=instance, Session=session, **mods)


JAX = _pkg("jax", lambda **kw: JaxInstance(**kw), JaxSession,
           ops=jax_ops, ssm=jax_ssm, spm=jax_spm, adm=jax_admission,
           recorder=jax_recorder, scheduler=jax_scheduler, slo=jax_slo,
           WebConsole=JaxWebConsole, ccl=jax_ccl, errors=jax_errors,
           fp=jax_failpoint, FAIL_POINTS=jax_failpoint.FAIL_POINTS, locks=jax_locks,
           mh=jax_mh, tracing=jax_tracing, EVENTS=JAX_EVENTS, memory=jax_memory)
PORT = _pkg("port", lambda **kw: PortInstance(device="cpu", **kw), PortSession,
            ops=port_ops, ssm=port_ssm, spm=port_spm, adm=port_admission,
            recorder=port_recorder, scheduler=port_scheduler, slo=port_slo,
            WebConsole=PortWebConsole, ccl=port_ccl, errors=port_errors,
            fp=port_failpoint, FAIL_POINTS=port_failpoint.FAIL_POINTS,
            locks=port_locks, mh=port_mh, tracing=port_tracing, EVENTS=PORT_EVENTS,
            memory=port_memory)
PKGS = (JAX, PORT)


def clean(pkg):
    """Reset a package's process-wide plane state between scenarios."""
    pkg.FAIL_POINTS.clear()
    pkg.EVENTS.clear()
    pkg.tracing.SLOW_LOG.clear()
    for st in list(pkg.ccl.GLOBAL_CCL.rules()):
        pkg.ccl.GLOBAL_CCL.drop_rule(st.rule.name)


def both(scenario):
    """Run `scenario(pkg)` through the JAX package, then the port; assert the
    outcomes are equal and return the port's."""
    out = []
    for pkg in PKGS:
        clean(pkg)
        try:
            out.append(scenario(pkg))
        finally:
            clean(pkg)
    assert out[1] == out[0], {"jax": out[0], "port": out[1]}
    return out[1]


def mk(pkg, schema, rows=0, **kw):
    """An instance and a session in `schema`; with `rows`, a 4-partition table
    t(a, b, c) of that many rows, ANALYZEd (real statistics drive the AP
    classifier)."""
    import numpy as np
    inst = pkg.Instance(**kw)
    s = pkg.Session(inst)
    s.execute(f"CREATE DATABASE {schema}")
    s.execute(f"USE {schema}")
    if rows:
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT, c BIGINT) "
                  "PARTITION BY HASH(a) PARTITIONS 4")
        inst.store(schema, "t").insert_arrays(
            {"a": np.arange(rows), "b": np.arange(rows) % 97,
             "c": np.arange(rows) * 3}, inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE t")
    return inst, s


def summary(s, contains=None, cols=(0, 1, 2, 3, 4, 5, 9, 10, 12, 13, 14, 15, 16, 18,
                                    19, 20)):
    """SHOW STATEMENT SUMMARY rows, sorted, without the time columns (avg, p95,
    p99), the retraces column (a COMPILE_STATS counter) and peak_rss_kb."""
    rows = s.execute("SHOW STATEMENT SUMMARY").rows
    if contains is not None:
        rows = [r for r in rows if contains in r[-1]]
    return sorted(tuple(r[i] for i in cols) for r in rows)


def threads(n, fn):
    """Run fn(i) on n threads; the exceptions they raised."""
    errs = []

    def run(i):
        try:
            fn(i)
        except Exception as e:  # surfaced to the caller
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    return errs
