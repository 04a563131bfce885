"""Optimizer/executor hints: /*+TDDL: ... */ directives.

Reference analog: `polardbx-optimizer/.../optimizer/parse/hint` +
`optimizer/hint/*` — the reference's hint system steers pushdown, join order,
and execution mode.  This engine honors the directives with a real decision
behind them:

- JOIN_ORDER(t1, t2, ...)  force the join order (same machinery as SPM
  accepted plans; names resolve against the default schema)
- ENGINE(MPP|LOCAL|TP)     force cluster-MPP, local device engine, or the
  TP host path regardless of the workload classifier
- NO_BLOOM                 disable ALL runtime filters for the statement —
  the join-local bloom AND the planned scan-pushdown filters
- RUNTIME_FILTER(OFF|BLOOM|MINMAX|ON)   per-statement control of planned
  runtime-filter pushdown (exec/runtime_filter.py): OFF disables the
  planning pass, BLOOM/MINMAX restrict the filter kinds.  `=` syntax is
  accepted too (RUNTIME_FILTER=OFF).
- NO_FUSE                  disable pipeline segment fusion for the statement
- FRAGMENT_CACHE(OFF|ON)   per-statement control of the cross-query fragment
  cache (exec/fragment_cache.py): OFF bypasses build/subplan/filter reuse
- BATCH(OFF|ON)            per-statement control of cross-session point-query
  batching (server/batch_scheduler.py).  Hinted statements never register
  PointPlans, so BATCH(OFF) structurally pins the statement to the planned
  (unbatched) path; the directive still parses so tools can round-trip it.
- DML_BATCH(OFF|ON)        per-statement control of cross-session DML
  batching (server/dml_batch.py).  Hinted DML statements never register
  batch plans and never take the batched write path (a hint comment
  structurally pins the statement to the sequential path), so DML_BATCH(OFF)
  is honored by construction; the directive still parses for round-tripping.
- ADMISSION(OFF|ON)        per-statement control of the workload-class
  admission gate (server/admission.py): OFF bypasses classification,
  limits, queuing and shedding for this statement
- MAX_EXECUTION_TIME(ms)   per-statement deadline (MySQL's optimizer-hint
  spelling): overrides the MAX_EXECUTION_TIME session param for this query;
  past-deadline execution dies with a typed QueryTimeoutError.
- SKEW(OFF|JOIN|AGG|ON)    per-statement control of skew-aware execution
  (exec/skew.py): OFF skips the planning pass entirely — no node carries a
  skew plan, so the hybrid/salted paths are structurally unreachable;
  JOIN/AGG restrict planting to that feature.  `=` syntax accepted.
- KERNEL(OFF|PALLAS|ON)    per-statement control of the kernel-tier selector
  (kernels/relational.py): OFF pins the reference join/agg formulations,
  PALLAS forces the Pallas kernels below the auto row floor, ON restores
  auto selection under a disabling ENABLE_PALLAS_KERNELS.  `=` accepted.
- COLUMNAR(OFF|ON)         per-statement control of columnar-replica routing
  (storage/columnar.py): OFF pins the statement to the row store, ON forces
  the replica (enrolling + seeding the scanned tables synchronously) even
  under a disabling ENABLE_COLUMNAR_REPLICA.  `=` accepted.
- BASELINE_OFF             bypass SPM for the statement (plan as costed)

Unknown directives are ignored (hints must never break a query), matching the
reference's permissive hint parsing.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

_HINT_RE = re.compile(r"/\*\+\s*TDDL:\s*(.*?)\s*\*/", re.S | re.I)
_DIRECTIVE_RE = re.compile(r"([A-Z_]+)\s*(?:\(([^)]*)\)|=\s*([A-Z_]+))?", re.I)


def parse_hints(comment: Optional[str]) -> Dict[str, object]:
    """Hint comment text -> directive dict (empty for None/no TDDL hints)."""
    out: Dict[str, object] = {}
    if not comment:
        return out
    m = _HINT_RE.search(comment)
    if not m:
        return out
    for name, pargs, eargs in _DIRECTIVE_RE.findall(m.group(1)):
        name = name.upper()
        args = pargs or eargs
        arglist = [a.strip().strip("`").lower()
                   for a in (args or "").split(",") if a.strip()]
        if name == "JOIN_ORDER" and arglist:
            out["join_order"] = arglist
        elif name == "ENGINE" and arglist:
            eng = arglist[0].upper()
            if eng in ("MPP", "LOCAL", "TP"):
                out["engine"] = eng
        elif name == "NO_BLOOM":
            out["no_bloom"] = True
        elif name == "RUNTIME_FILTER" and arglist:
            mode = arglist[0].lower()
            if mode in ("off", "bloom", "minmax", "on"):
                out["runtime_filter"] = mode
        elif name == "NO_FUSE":
            out["no_fuse"] = True
        elif name == "FRAGMENT_CACHE" and arglist:
            mode = arglist[0].lower()
            if mode in ("off", "on"):
                out["fragment_cache"] = mode
        elif name == "BATCH" and arglist:
            mode = arglist[0].lower()
            if mode in ("off", "on"):
                out["batch"] = mode
        elif name == "DML_BATCH" and arglist:
            mode = arglist[0].lower()
            if mode in ("off", "on"):
                out["dml_batch"] = mode
        elif name == "ADMISSION" and arglist:
            # per-statement admission-control bypass (server/admission.py):
            # OFF skips the gate entirely — the query neither classifies nor
            # takes a class token (the maintenance-query escape hatch)
            mode = arglist[0].lower()
            if mode in ("off", "on"):
                out["admission"] = mode
        elif name == "SKEW" and arglist:
            mode = arglist[0].lower()
            if mode in ("off", "join", "agg", "on"):
                out["skew"] = mode
        elif name == "KERNEL" and arglist:
            # kernel-tier selector (kernels/relational.py): OFF pins the
            # reference formulation, PALLAS forces the Pallas tier below the
            # auto row floor, ON restores auto under a disabling param
            mode = arglist[0].lower()
            if mode in ("off", "pallas", "on"):
                out["kernel"] = mode
        elif name == "COLUMNAR" and arglist:
            # columnar-replica routing (storage/columnar.py): OFF pins the
            # row store, ON forces the replica (synchronous enroll+seed)
            mode = arglist[0].lower()
            if mode in ("off", "on"):
                out["columnar"] = mode
        elif name == "MAX_EXECUTION_TIME" and arglist:
            try:
                ms = int(arglist[0])
            except ValueError:
                continue  # malformed hints must never break a query
            if ms > 0:
                out["max_execution_time"] = ms
        elif name == "BASELINE_OFF":
            out["baseline_off"] = True
    return out


def qualified_order(names: List[str], default_schema: str) -> List[str]:
    """Hint table names -> the schema-qualified labels build_join_tree uses."""
    out = []
    for n in names:
        out.append(n if "." in n else f"{default_schema.lower()}.{n}")
    return out
