"""Zone-map / SARG refutation shared by every columnar tier.

One evaluation rule for "can min-max stats prove NO row here satisfies these
conjunctive sargs?" — used by the TTL parquet archive (`storage/archive.py`
file skip, the reference's OSSTableScanExec SARG path) and the HTAP columnar
replica's base stripes (`storage/columnar.py`).  Keeping it in one place is
the point: the two tiers must agree on the semantics (missing stats never
prune; NULLs are excluded from min/max so conjuncts on an all-NULL column
never refute) or a scan routed to one tier could silently see fewer rows.

Sargs are `(column, op, value)` conjuncts with `op` in
{eq, lt, le, gt, ge} and `value` already in lane domain (dictionary code for
encoded strings, epoch days for dates) — the same shape `plan/physical.py`
pushes into `ScanSource` nodes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

MinMax = Tuple[float, float]


def sargs_refuted(stats: Dict[str, MinMax], sargs) -> bool:
    """True when the per-column (min, max) stats prove the conjunction can
    match nothing.  Advisory: a column missing from `stats` contributes
    nothing (never prunes), so stale or partial stats only cost speed."""
    if not sargs:
        return False
    for cname, op, v in sargs:
        mm = stats.get(cname)
        if mm is None:
            continue
        lo, hi = mm
        if (op == "eq" and (v < lo or v > hi)) or \
                (op == "lt" and lo >= v) or \
                (op == "le" and lo > v) or \
                (op == "gt" and hi <= v) or \
                (op == "ge" and hi < v):
            return True
    return False


def lane_minmax(lane, valid) -> Optional[MinMax]:
    """(min, max) of a numeric lane over its valid rows, or None when no
    valid row exists (an all-NULL zone has no zone map — it never prunes
    via sargs_refuted's missing-stats rule, matching SQL tri-state)."""
    if valid is not None:
        lane = lane[valid]
    if lane.size == 0:
        return None
    # float()/int() over np scalars, not .item(): lanes here are host numpy
    # (stripe builders run on the tailer thread), never device buffers
    return (float(lane.min()), float(lane.max()))
