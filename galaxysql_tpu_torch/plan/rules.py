"""Rule-based rewrites + greedy cost-guided join ordering.

Reference analog: the RBO push-down rule set + CBO join reorder of `core/planner/rule`
(SURVEY.md §2.5).  Kept deliberately small: the four rewrites below shape all of TPC-H.

1. factor_or_conjuncts — Q19 pattern: (A and X) or (B and X) -> X and (A or B), so the
   shared equi predicate becomes a join key.
2. build_join_tree — flatten cross-join forests + the WHERE conjunction into a join
   graph; greedily order joins smallest-estimated-first (broadcast/filtered dimensions
   join early), emitting equi joins with residuals.
3. push_filters / prune_columns — classic pushdown; scans read only referenced columns.
4. prune_partitions — point/range predicates on partition columns shrink scanned shards
   (`PartitionPruner` analog).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from galaxysql_tpu_torch.expr import ir
from galaxysql_tpu_torch.meta.catalog import PartitionRouter
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.types import datatype as dt

# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------


def conjuncts(e: Optional[ir.Expr]) -> List[ir.Expr]:
    if e is None:
        return []
    if isinstance(e, ir.Call) and e.op == "and":
        return conjuncts(e.args[0]) + conjuncts(e.args[1])
    return [e]


def disjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Call) and e.op == "or":
        return disjuncts(e.args[0]) + disjuncts(e.args[1])
    return [e]


def factor_or_conjuncts(e: ir.Expr) -> ir.Expr:
    """(A ∧ X ∧ ...) ∨ (B ∧ X ∧ ...) -> X ∧ ((A ∧ ...) ∨ (B ∧ ...))."""
    ds = disjuncts(e)
    if len(ds) < 2:
        return e
    sets = [{c.key(): c for c in conjuncts(d)} for d in ds]
    common_keys = set(sets[0])
    for s in sets[1:]:
        common_keys &= set(s)
    if not common_keys:
        return e
    common = [sets[0][k] for k in common_keys]
    rest = []
    for d, s in zip(ds, sets):
        remaining = [c for c in conjuncts(d) if c.key() not in common_keys]
        rest.append(ir.and_(*remaining) if remaining else ir.lit(True, dt.BOOL))
    return ir.and_(*(common + [ir.or_(*rest)]))


# ---------------------------------------------------------------------------
# join tree construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Rel:
    node: L.RelNode
    ids: Set[str]
    est_rows: float


def estimate_rows(node: L.RelNode) -> float:
    """Cheap cardinality estimate for ordering decisions (stats-backed at scans)."""
    if isinstance(node, L.Scan):
        return max(float(node.table.stats.row_count), 1.0)
    if isinstance(node, L.Filter):
        sel = 1.0
        resolver = _stats_resolver(node.child)
        for c in conjuncts(node.cond):
            sel *= _selectivity(c, resolver)
        return max(estimate_rows(node.child) * sel, 1.0)
    if isinstance(node, L.Project):
        return estimate_rows(node.child)
    if isinstance(node, L.Aggregate):
        base = estimate_rows(node.child)
        if not node.groups:
            return 1.0
        return max(base ** 0.7, 1.0)
    if isinstance(node, L.Join):
        l = estimate_rows(node.left)
        r = estimate_rows(node.right)
        if node.kind == "cross":
            return l * r
        if node.kind in ("semi", "anti"):
            return l * 0.5
        return max(l, r)  # FK-join heuristic
    if isinstance(node, L.Sort):
        n = estimate_rows(node.child)
        return min(n, node.limit) if node.limit else n
    if isinstance(node, L.Limit):
        return float(node.limit)
    if isinstance(node, L.Union):
        return sum(estimate_rows(c) for c in node.children)
    if isinstance(node, L.Values):
        return float(len(node.rows))
    return 1000.0


def _stats_resolver(node: L.RelNode):
    """field_id -> (TableMeta, column_name) over every Scan under `node`."""
    out: Dict[str, Tuple] = {}
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, L.Scan):
            for out_id, col in n.columns:
                out[out_id] = (n.table, col)
        else:
            stack.extend(n.children)
    return out


def _lit_lane_value(e: ir.Literal, col_dtype) -> Optional[float]:
    """Literal -> lane-domain float comparable against histogram bounds."""
    from galaxysql_tpu_torch.expr.compiler import _encode_literal_value
    try:
        v = _encode_literal_value(e.value, col_dtype)
    except (TypeError, ValueError):
        return None
    return float(v) if not isinstance(v, str) else None


def _col_lit_cmp(c: ir.Call):
    """(colref, literal, flipped) for a simple column-vs-literal comparison."""
    a, b = c.args[0], c.args[1]
    if isinstance(a, ir.ColRef) and isinstance(b, ir.Literal) and \
            b.value is not None:
        return a, b, False
    if isinstance(b, ir.ColRef) and isinstance(a, ir.Literal) and \
            a.value is not None:
        return b, a, True
    return None


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def _selectivity(c: ir.Expr, resolver=None) -> float:
    """Predicate selectivity: histogram/NDV-backed when ANALYZE has run
    (Histogram.java / statistic/ndv analog), fixed guesses otherwise."""
    if isinstance(c, ir.Call):
        stats = None
        if resolver is not None and c.op in ("eq", "ne", "lt", "le", "gt", "ge") \
                and len(c.args) == 2:
            cl = _col_lit_cmp(c)
            if cl is not None:
                col, lit, flipped = cl
                tmcol = resolver.get(col.name)
                if tmcol is not None:
                    tm, cname = tmcol
                    cm = tm.column(cname)
                    hist = tm.stats.histograms.get(cm.name)
                    ndv = tm.stats.ndv.get(cm.name, 0)
                    op = _FLIP.get(c.op, c.op) if flipped else c.op
                    if op in ("eq", "ne") and ndv > 0:
                        f = 1.0 / ndv
                        return max(min(f if op == "eq" else 1.0 - f, 1.0), 1e-9)
                    if hist is not None and op in ("lt", "le", "gt", "ge"):
                        v = _lit_lane_value(lit, cm.dtype)
                        if v is not None:
                            le = hist.frac_le(v)
                            eq = hist.frac_eq(v)
                            if op == "le":
                                f = le
                            elif op == "lt":
                                f = le - eq
                            elif op == "gt":
                                f = 1.0 - le
                            else:
                                f = 1.0 - le + eq
                            return max(min(f, 1.0), 1e-9)
        if c.op == "eq":
            return 0.05
        if c.op in ("lt", "le", "gt", "ge"):
            return 0.3
        if c.op == "between":
            return 0.25
        if c.op in ("like",):
            return 0.1
        if c.op == "or":
            return min(sum(_selectivity(d, resolver) for d in disjuncts(c)), 1.0)
        if c.op == "and":
            s = 1.0
            for d in conjuncts(c):
                s *= _selectivity(d, resolver)
            return s
        if c.op == "ne":
            return 0.9
    if isinstance(c, ir.InList):
        return min(0.05 * max(len(c.values), 1), 1.0)
    return 0.5


def _rel_label(node: L.RelNode) -> str:
    """Stable identity of a join-forest member for SPM baselines: the scanned
    table when the member bottoms out in one, else a field-id digest."""
    n = node
    while isinstance(n, (L.Filter, L.Project)):
        n = n.children[0]
    if isinstance(n, L.Scan):
        return f"{n.table.schema.lower()}.{n.table.name.lower()}"
    return "rel:" + ",".join(sorted(node.field_ids())[:4])


def build_join_tree(node: L.RelNode, spm=None) -> L.RelNode:
    """Rewrite Filter-over-cross-join forests into ordered equi-join trees.

    `spm` (plan/spm.py SpmContext) makes the join order externally pinnable:
    the chosen member order of every forest is reported out, and a forced
    order — an accepted SPM baseline — overrides the greedy cost choice when
    its labels still match the forest (PlanManager.java:92 accepted plans)."""
    node = _rewrite_children(node, lambda c: build_join_tree(c, spm))
    preds: List[ir.Expr] = []
    base = node
    if isinstance(node, L.Filter):
        preds = [factor_or_conjuncts(c) for c in conjuncts(node.cond)]
        # factoring may expose new conjuncts
        preds = [c2 for p in preds for c2 in conjuncts(p)]
        base = node.child
    rels = _flatten_crosses(base)
    if len(rels) <= 1 and not isinstance(base, L.Join):
        return L.Filter(base, ir.and_(*preds)) if preds else base
    if not any(isinstance(r, L.Join) and r.kind == "cross" for r in [base]) and \
            len(rels) == 1:
        return L.Filter(base, ir.and_(*preds)) if preds else base

    relinfos = [_Rel(r, set(r.field_ids()), 0.0) for r in rels]

    # split predicates: single-rel -> push down; two-rel equi -> join edges; rest -> later
    edges: List[Tuple[int, int, ir.Expr, ir.Expr]] = []
    residual_preds: List[ir.Expr] = []
    local: Dict[int, List[ir.Expr]] = {i: [] for i in range(len(relinfos))}
    for p in preds:
        refs = set(ir.referenced_columns(p))
        owners = [i for i, ri in enumerate(relinfos) if refs & ri.ids]
        if len(owners) == 0:
            residual_preds.append(p)  # constant predicate
        elif len(owners) == 1:
            local[owners[0]].append(p)
        elif len(owners) == 2 and isinstance(p, ir.Call) and p.op == "eq":
            a, b = p.args
            ra, rb = set(ir.referenced_columns(a)), set(ir.referenced_columns(b))
            i, j = owners
            if ra <= relinfos[i].ids and rb <= relinfos[j].ids:
                edges.append((i, j, a, b))
            elif ra <= relinfos[j].ids and rb <= relinfos[i].ids:
                edges.append((j, i, a, b))
            else:
                residual_preds.append(p)
        else:
            residual_preds.append(p)

    for i, ps in local.items():
        if ps:
            relinfos[i] = _Rel(L.Filter(relinfos[i].node, ir.and_(*ps)),
                               relinfos[i].ids, 0.0)
    for ri in relinfos:
        ri.est_rows = estimate_rows(ri.node)

    # greedy: start at the smallest relation, repeatedly join the connected relation
    # with the smallest estimate; unconnected relations fall back to cross joins last.
    # An applicable SPM forced order replaces every greedy choice verbatim.
    labels = [_rel_label(r) for r in rels]
    forced_seq = None
    # SPM only engages on forests with equi-join edges: predicate-free inner
    # cross levels are re-flattened and re-ordered by the enclosing call, and
    # recording them would misalign the per-forest force/capture sequence
    spm_active = spm is not None and bool(edges)
    if spm_active:
        f = spm.next_forced()
        if f is not None and sorted(f) == sorted(labels):
            forced_seq = list(f)

    by_label: Dict[str, List[int]] = {}
    for i, lab in enumerate(labels):
        by_label.setdefault(lab, []).append(i)

    # field id -> (TableMeta, column) for NDV-backed join cardinalities
    resolver: Dict[str, Tuple] = {}
    for r in rels:
        resolver.update(_stats_resolver(r))

    def _ndv_of(e: ir.Expr, side_est: float) -> float:
        if isinstance(e, ir.ColRef):
            tmcol = resolver.get(e.name)
            if tmcol is not None:
                ndv = tmcol[0].stats.ndv.get(tmcol[1]) or \
                    tmcol[0].stats.ndv.get(tmcol[0].column(tmcol[1]).name, 0)
                if ndv:
                    return float(ndv)
        return side_est  # no stats: V(R, a) ~ |R| (FK assumption)

    def join_est(ca: "_Rel", cb: "_Rel", pair_edges) -> float:
        """System-R cardinality: |A||B| / prod(max(V(A,a), V(B,b))) — the
        formula that makes a many-to-many low-NDV edge (s_nationkey =
        c_nationkey: 25 distinct values) cost its real blowup instead of the
        FK max(l, r) guess (reference: the CBO's mq.getRowCount join logic)."""
        est = ca.est_rows * cb.est_rows
        for ea, eb in pair_edges:
            est /= max(_ndv_of(ea, ca.est_rows), _ndv_of(eb, cb.est_rows), 1.0)
        return max(est, 1.0)

    used_edges: Set[int] = set()
    chosen: List[str] = []

    def merge(ca: "_Rel", cb: "_Rel", a_members: Set[int],
              b_members: Set[int]) -> "_Rel":
        eq_pairs: List[Tuple[ir.Expr, ir.Expr]] = []
        for k, (a, b, ea, eb) in enumerate(edges):
            if k in used_edges:
                continue
            if a in a_members and b in b_members:
                eq_pairs.append((ea, eb))
                used_edges.add(k)
            elif b in a_members and a in b_members:
                eq_pairs.append((eb, ea))
                used_edges.add(k)
        if not eq_pairs:
            return _Rel(L.Join(ca.node, cb.node, "cross", []),
                        ca.ids | cb.ids, ca.est_rows * cb.est_rows)
        return _Rel(L.Join(ca.node, cb.node, "inner", eq_pairs),
                    ca.ids | cb.ids, join_est(ca, cb, eq_pairs))

    def goo_plan() -> Tuple[List[Tuple[Set[int], Set[int]]], Tuple[str, ...]]:
        """Greedy operator ordering (GOO): repeatedly merge the component PAIR
        with the smallest estimated join output.  Unlike left-deep growth from
        the smallest relation, this does not trap dimension chains into m:n
        edges (TPC-H Q5's nation-keyed supplier x customer).

        Pure planning over estimate floats and a SCRATCH edge set — returns
        the merge steps (as member-set pairs, smaller-est side first) plus the
        label order.  The tree build replays the steps; drift detection uses
        just the labels — one selection loop serves both."""
        sim_used: Set[int] = set()
        comps = [(relinfos[i].est_rows, {i}, [labels[i]])
                 for i in range(len(relinfos))]
        steps: List[Tuple[Set[int], Set[int]]] = []
        while len(comps) > 1:
            best = None
            for x in range(len(comps)):
                for y in range(x + 1, len(comps)):
                    pe = []
                    for k, (a, b, ea, eb) in enumerate(edges):
                        if k in sim_used:
                            continue
                        if (a in comps[x][1] and b in comps[y][1]) or \
                                (b in comps[x][1] and a in comps[y][1]):
                            pe.append((ea, eb) if a in comps[x][1]
                                      else (eb, ea))
                    if not pe:
                        continue
                    est = comps[x][0] * comps[y][0]
                    for ea, eb in pe:
                        est /= max(_ndv_of(ea, comps[x][0]),
                                   _ndv_of(eb, comps[y][0]), 1.0)
                    if best is None or est < best[0]:
                        best = (max(est, 1.0), x, y)
            if best is None:
                # no joinable pair left: cross the two smallest components
                order = sorted(range(len(comps)), key=lambda i: comps[i][0])
                x, y = min(order[0], order[1]), max(order[0], order[1])
                best = (comps[x][0] * comps[y][0], x, y)
            est, x, y = best
            for k, (a, b, _ea, _eb) in enumerate(edges):
                if k in sim_used:
                    continue
                if (a in comps[x][1] and b in comps[y][1]) or \
                        (b in comps[x][1] and a in comps[y][1]):
                    sim_used.add(k)
            if comps[y][0] < comps[x][0]:
                x, y = y, x  # smaller side leads (label-order convention)
            _e, ma, la = comps[x]
            _e2, mb, lb = comps[y]
            steps.append((set(ma), set(mb)))
            comps = [c for i, c in enumerate(comps) if i not in (x, y)]
            comps.append((est, ma | mb, la + lb))
        # the reported label order is the MERGE order (first merged pair
        # first, later-joined relations appended), NOT the lead-concat
        # display order: an SPM baseline replays its order as a left-deep
        # chain, and only the merge sequence makes that replay reproduce the
        # join tree GOO actually built — concat order can turn a healthy
        # bushy plan into an m:n-first blowup on replay.  (Plan fingerprints
        # ARE order-sensitive within a forest, so persisted pre-merge-order
        # baselines are dropped by the SPM kv-format version bump.)  Within
        # a step, members connected by an edge to the already-placed prefix
        # go first: a bushy-bushy merge flattened naively could put an
        # edge-less member next and hand the replay a cross join the
        # original never ran.
        def _connected(i: int, group: Set[int]) -> bool:
            return any((a == i and bb in group) or (bb == i and a in group)
                       for a, bb, _ea, _eb in edges)

        seq: List[str] = []
        placed: Set[int] = set()
        for ma, mb in steps:
            fresh = sorted(ma - placed) + sorted(mb - placed)
            while fresh:
                nxt = next((i for i in fresh if placed and
                            _connected(i, placed)), fresh[0])
                seq.append(labels[nxt])
                placed.add(nxt)
                fresh.remove(nxt)
        for i in range(len(relinfos)):
            if i not in placed:  # defensive: unmerged singleton
                seq.append(labels[i])
        return steps, tuple(seq)

    if forced_seq is not None:
        # SPM baseline: replay the pinned order verbatim as a left-deep chain
        # (the accepted plan's identity is its member order)
        remaining = set(range(len(relinfos)))

        def take(lab: str) -> int:
            for i in by_label[lab]:
                if i in remaining:
                    return i
            raise KeyError(lab)

        start = take(forced_seq[0])
        current = relinfos[start]
        remaining.discard(start)
        members = {start}
        chosen.append(labels[start])
        while remaining:
            nxt = take(forced_seq[len(chosen)])
            chosen.append(labels[nxt])
            current = merge(current, relinfos[nxt], members, {nxt})
            members.add(nxt)
            remaining.discard(nxt)
        cost_pref = goo_plan()[1]
    else:
        steps, order = goo_plan()
        nodes: Dict[frozenset, "_Rel"] = {
            frozenset({i}): relinfos[i] for i in range(len(relinfos))}
        for ma, mb in steps:
            ca = nodes.pop(frozenset(ma))
            cb = nodes.pop(frozenset(mb))
            # merge() consumes real used_edges in the same sequence the
            # planning pass simulated, so edge bookkeeping stays in lockstep
            nodes[frozenset(ma | mb)] = merge(ca, cb, ma, mb)
        current = next(iter(nodes.values()))
        chosen = list(order)
        cost_pref = order
    if spm_active:
        spm.chosen.append(tuple(chosen))
        spm.cost_preferred.append(cost_pref)

    # any edges between already-joined members that were not consumed become filters
    for k, (a, b, ea, eb) in enumerate(edges):
        if k not in used_edges:
            residual_preds.append(ir.call("eq", ea, eb))
    out = current.node
    if residual_preds:
        out = L.Filter(out, ir.and_(*residual_preds))
    return out


def _flatten_crosses(node: L.RelNode) -> List[L.RelNode]:
    if isinstance(node, L.Join) and node.kind == "cross" and not node.equi and \
            not getattr(node, "scalar", False):
        # scalar crosses (uncorrelated scalar subqueries) carry exactly-one-row
        # semantics and must survive join-tree reconstruction intact
        return _flatten_crosses(node.left) + _flatten_crosses(node.right)
    return [node]


def _rewrite_children(node: L.RelNode, fn) -> L.RelNode:
    node.children = [fn(c) for c in node.children]
    return node


# ---------------------------------------------------------------------------
# filter pushdown (through Project / into Join sides)
# ---------------------------------------------------------------------------

def push_filters(node: L.RelNode) -> L.RelNode:
    node = _rewrite_children(node, push_filters)
    if not isinstance(node, L.Filter):
        return node
    child = node.child
    if isinstance(child, L.Filter):
        merged = L.Filter(child.child, ir.and_(child.cond, node.cond))
        return push_filters(merged)
    if isinstance(child, L.Join) and child.kind in ("inner", "semi", "anti", "left"):
        left_ids = set(child.left.field_ids())
        right_ids = set(child.right.field_ids())
        keep: List[ir.Expr] = []
        lpush: List[ir.Expr] = []
        rpush: List[ir.Expr] = []
        for c in conjuncts(node.cond):
            refs = set(ir.referenced_columns(c))
            if refs <= left_ids:
                lpush.append(c)
            elif refs <= right_ids and child.kind == "inner":
                rpush.append(c)
            else:
                keep.append(c)
        if lpush:
            child.children[0] = push_filters(L.Filter(child.left, ir.and_(*lpush)))
        if rpush:
            child.children[1] = push_filters(L.Filter(child.right, ir.and_(*rpush)))
        if keep:
            return L.Filter(child, ir.and_(*keep))
        return child
    return node


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------

def prune_columns(node: L.RelNode, required: Optional[Set[str]] = None) -> L.RelNode:
    """Drop unreferenced columns from scans and projections (top-down)."""
    if required is None:
        required = set(node.field_ids())

    if isinstance(node, L.Scan):
        cols = [(oid, c) for oid, c in node.columns if oid in required]
        if not cols:
            cols = node.columns[:1]  # keep at least one lane for row existence
        node.columns = cols
        return node
    if isinstance(node, L.Project):
        node.exprs = [(n, e) for n, e in node.exprs if n in required] or node.exprs[:1]
        need = set()
        for _, e in node.exprs:
            need.update(ir.referenced_columns(e))
        node.children = [prune_columns(node.child, need)]
        return node
    if isinstance(node, L.Filter):
        need = set(required) | set(ir.referenced_columns(node.cond))
        node.children = [prune_columns(node.child, need)]
        return node
    if isinstance(node, L.Aggregate):
        need = set()
        for _, e in node.groups:
            need.update(ir.referenced_columns(e))
        for a in node.aggs:
            if a.arg is not None:
                need.update(ir.referenced_columns(a.arg))
        node.children = [prune_columns(node.child, need)]
        return node
    if isinstance(node, L.Join):
        need = set(required)
        for a, b in node.equi:
            need.update(ir.referenced_columns(a))
            need.update(ir.referenced_columns(b))
        if node.residual is not None:
            need.update(ir.referenced_columns(node.residual))
        left_ids = set(node.left.field_ids())
        right_ids = set(node.right.field_ids())
        node.children = [prune_columns(node.left, need & left_ids),
                         prune_columns(node.right, need & right_ids)]
        return node
    if isinstance(node, L.Sort):
        need = set(required)
        for e, _ in node.keys:
            need.update(ir.referenced_columns(e))
        node.children = [prune_columns(node.child, need)]
        return node
    if isinstance(node, L.Window):
        need = set(required)
        for p in node.partitions:
            need.update(ir.referenced_columns(p))
        for e, _ in node.orders:
            need.update(ir.referenced_columns(e))
        for c in node.calls:
            if c.arg is not None:
                need.update(ir.referenced_columns(c.arg))
        need -= {c.out_id for c in node.calls}
        node.children = [prune_columns(node.child, need)]
        return node
    if isinstance(node, (L.Limit,)):
        node.children = [prune_columns(node.child, set(required))]
        return node
    if isinstance(node, L.Union):
        node.children = [prune_columns(c, set(c.field_ids())) for c in node.children]
        return node
    return node


# ---------------------------------------------------------------------------
# runtime-filter planning
# ---------------------------------------------------------------------------

def plan_runtime_filters(node: L.RelNode, hints=None) -> L.RelNode:
    """Annotate inner/semi hash joins with runtime-filter edges.

    Reference analog: `rule/mpp/runtimefilter` (`JoinToRuntimeFilterJoinRule`,
    `PushBloomFilterRule`, SURVEY.md §2.5): for each equi pair whose probe key
    is a bare column traceable — through projections/renames, filters, group
    keys, and row-preserving join sides — to a base-table scan column, the
    join gains a producer edge (`L.Join.rf_plans`) and the scan a consumer
    edge (`L.Scan.rf_targets`).  Filtering a scan to rows whose key can match
    the build side is sound anywhere on that path: a filtered-out row could
    only ever produce join rows the upper inner/semi join discards anyway.

    Cost-gated on stats: no filter when the probe is already cheap
    (broadcast-small shapes) or when build-key NDV says the filter would pass
    nearly everything.  `NO_BLOOM` / `RUNTIME_FILTER(OFF)` hints disable the
    pass; `RUNTIME_FILTER(BLOOM|MINMAX)` restricts the filter kinds."""
    import itertools
    h = hints or {}
    mode = str(h.get("runtime_filter") or "").lower()
    if h.get("no_bloom") or mode == "off":
        return node
    _rf_walk(node, itertools.count(1), mode)
    return node


def _rf_resolve_scan(node: L.RelNode, col_id: str):
    """(scan, out_id) the plan column `col_id` is a bare rename-chain of, or
    None.  Descends only row-preserving edges (see plan_runtime_filters)."""
    if isinstance(node, L.Scan):
        for oid, _c in node.columns:
            if oid == col_id:
                return node, oid
        return None
    if isinstance(node, L.Filter):
        return _rf_resolve_scan(node.child, col_id)
    if isinstance(node, L.Project):
        for name, e in node.exprs:
            if name == col_id:
                return _rf_resolve_scan(node.child, e.name) \
                    if isinstance(e, ir.ColRef) else None
        return None
    if isinstance(node, L.Aggregate):
        # sound only through GROUP KEYS: pruning rows of a group whose key the
        # filter refutes removes exactly the groups the upper join discards
        for name, e in node.groups:
            if name == col_id:
                return _rf_resolve_scan(node.child, e.name) \
                    if isinstance(e, ir.ColRef) else None
        return None
    if isinstance(node, L.Join):
        if node.kind == "cross":
            return None
        sides = [node.left] if node.kind in ("semi", "anti", "left") \
            else [node.left, node.right]
        for s in sides:
            if col_id in set(s.field_ids()):
                return _rf_resolve_scan(s, col_id)
        return None
    return None


def _rf_walk(node: L.RelNode, ctr, mode: str):
    for c in node.children:
        _rf_walk(c, ctr, mode)
    if not isinstance(node, L.Join) or node.kind not in ("inner", "semi") or \
            not node.equi:
        return
    l_est = estimate_rows(node.left)
    r_est = estimate_rows(node.right)
    # Plant edges for EVERY probe direction that passes the cost gates, not
    # just the build side the local engine would pick: engines differ (MPP
    # flips the build only below a 4x estimate ratio), and the executor
    # activates only the direction matching its actual probe side — an edge
    # for the other direction simply never publishes.  Semi joins fix the
    # probe to the preserved left side.
    if node.kind == "semi":
        directions = [("left", node.left, node.right, r_est, l_est)]
    else:
        directions = [("left", node.left, node.right, r_est, l_est),
                      ("right", node.right, node.left, l_est, r_est)]
    for direction in directions:
        _rf_plan_direction(node, direction, ctr, mode)


def _rf_plan_direction(node: L.Join, direction, ctr, mode: str):
    from galaxysql_tpu_torch.exec.runtime_filter import (
        RF_BLOOM_MAX_BUILD, RF_MAX_SELECTIVITY, RF_MIN_PROBE_ROWS,
        RuntimeFilterPlan, RuntimeFilterTarget)
    target_side, probe_node, build_node, build_est, probe_est = direction
    if probe_est < RF_MIN_PROBE_ROWS:
        return  # broadcast-small shape: the probe is already cheap
    build_resolver = _stats_resolver(build_node)
    for i, (le, re_) in enumerate(node.equi):
        pk = le if target_side == "left" else re_
        bk = re_ if target_side == "left" else le
        if not isinstance(pk, ir.ColRef):
            continue
        if pk.dtype.is_string != bk.dtype.is_string:
            continue
        got = _rf_resolve_scan(probe_node, pk.name)
        if got is None:
            continue
        scan, out_id = got
        colname = dict(scan.columns).get(out_id)
        if colname is None:
            continue
        # selectivity gate: distinct build keys vs distinct probe values
        tm = scan.table
        ndv_p = tm.stats.ndv.get(colname) or \
            tm.stats.ndv.get(tm.column(colname).name, 0)
        b_card = build_est
        if isinstance(bk, ir.ColRef):
            tmcol = build_resolver.get(bk.name)
            if tmcol is not None:
                bndv = tmcol[0].stats.ndv.get(tmcol[1]) or \
                    tmcol[0].stats.ndv.get(tmcol[0].column(tmcol[1]).name, 0)
                if bndv:
                    b_card = min(b_card, float(bndv))
        sel = b_card / ndv_p if ndv_p else build_est / max(probe_est, 1.0)
        if sel > RF_MAX_SELECTIVITY:
            continue
        kinds = set()
        if not pk.dtype.is_string:
            kinds.add("minmax")  # codes are assignment-ordered: numeric only
        if build_est <= RF_BLOOM_MAX_BUILD:
            kinds.add("bloom")
        if mode == "bloom":
            kinds &= {"bloom"}
        elif mode == "minmax":
            kinds &= {"minmax"}
        if not kinds:
            continue
        fid = next(ctr)
        scan.rf_targets.append(
            RuntimeFilterTarget(fid, out_id, colname, frozenset(kinds)))
        node.rf_plans.append(
            RuntimeFilterPlan(fid, i, target_side, frozenset(kinds)))


# ---------------------------------------------------------------------------
# skew planning (heavy-hitter hybrid joins + salted aggregation)
# ---------------------------------------------------------------------------

def plan_skew(node: L.RelNode, hints=None) -> L.RelNode:
    """Annotate joins/aggregates whose repartition key column has heavy
    hitters (exec/skew.py policy; detection from ANALYZE's Space-Saving
    sketches in meta/statistics.py).

    Joins: for each probe direction of a single-pair equi join whose probe
    key is a bare integer column traceable to a base-table scan
    (`_rf_resolve_scan`, the runtime-filter lineage walk), plant a
    `SkewJoinPlan` carrying the column's heavy-hitter candidates — the MPP
    executor thresholds them by its actual mesh size and splits the shuffle
    into a broadcast (hot) and a hash (cold) lane.  Aggregates: a skewed
    group-key column plants a `SaltAggPlan`; the executor repartitions on a
    salted key hash and adds a final merge stage.  The SKEW(OFF|JOIN|AGG)
    hint and the GALAXYSQL_SKEW env switch gate the pass STRUCTURALLY: a
    disabled mode plants nothing, so the hybrid path cannot engage."""
    from galaxysql_tpu_torch.exec import skew as sk
    modes = sk.plan_modes(hints)
    if not modes:
        return node
    for n in L.walk(node):
        if isinstance(n, L.Join) and "join" in modes:
            _skew_plan_join(n, sk)
        elif isinstance(n, L.Aggregate) and "agg" in modes:
            _skew_plan_agg(n, sk)
    return node


def _skew_candidates(probe_node: L.RelNode, key: ir.Expr, sk):
    """(SkewPlan fields) for a bare-column repartition key with heavy
    hitters, or None.  Integer lanes only: hot-key classification hashes the
    host-side candidate values with the device hash's exact cast semantics,
    which float lanes do not share."""
    if not isinstance(key, ir.ColRef):
        return None
    got = _rf_resolve_scan(probe_node, key.name)
    if got is None:
        return None
    scan, out_id = got
    tm = scan.table
    if getattr(tm, "remote", None) is not None:
        return None
    colname = dict(scan.columns).get(out_id)
    if colname is None:
        return None
    cm = tm.column(colname)
    if not np.issubdtype(np.dtype(cm.dtype.lane), np.integer):
        return None
    hh = tm.stats.heavy.get(cm.name)
    if hh is None:
        return None
    cands = tuple((v, round(f, 6)) for v, f in
                  hh.candidates(sk.MIN_CANDIDATE_FRAC))
    if not cands:
        return None
    return cands, f"{tm.schema.lower()}.{tm.name.lower()}", cm.name, \
        hh.total, tm


def _skew_plan_join(node: L.Join, sk):
    if node.kind not in ("inner", "left", "semi", "anti") or \
            len(node.equi) != 1:
        return
    le, re_ = node.equi[0]
    # probe directions mirror _rf_walk: inner joins may flip sides at
    # execution, so plant both and let the executor pick its actual probe
    directions = [("left", node.left, le)]
    if node.kind == "inner":
        directions.append(("right", node.right, re_))
    for side, probe_node, pk in directions:
        if pk.dtype.is_string:
            # hybrid classification hashes host-side hot values; string codes
            # may be dictionary-TRANSLATED before the device hash, so the
            # host twin cannot reproduce it.  Salted aggregation (no value
            # hashing) still covers skewed string keys.
            continue
        if estimate_rows(probe_node) < sk.MIN_SKEW_ROWS:
            continue
        got = _skew_candidates(probe_node, pk, sk)
        if got is None:
            continue
        cands, table, column, total, tm = got
        node.skew_plans.append(sk.SkewJoinPlan(
            0, side, cands, table, column, total, tm))


def _skew_plan_agg(node: L.Aggregate, sk):
    # single group key only: the repartition hashes the COMBINED key, and a
    # hot value in one column of a composite key says nothing about the
    # composite's distribution (GROUP BY region, customer_id is uniform even
    # when region has a dominant value) — salting there is pure overhead
    if len(node.groups) != 1:
        return
    if estimate_rows(node.child) < sk.MIN_SKEW_ROWS:
        return
    got = _skew_candidates(node.child, node.groups[0][1], sk)
    if got is not None:
        cands, table, column, total, tm = got
        node.salt_plan = sk.SaltAggPlan(cands, table, column, total, tm)


# ---------------------------------------------------------------------------
# partition pruning
# ---------------------------------------------------------------------------

def prune_partitions(node: L.RelNode) -> L.RelNode:
    node = _rewrite_children(node, prune_partitions)
    if not isinstance(node, L.Filter) or not isinstance(node.child, L.Scan):
        return node
    scan = node.child
    _extract_sargs(node.cond, scan)
    _choose_point_eq(node.cond, scan)
    info = scan.table.partition
    if info.method in ("single", "broadcast") or info.num_partitions <= 1:
        return node
    router = PartitionRouter(scan.table)
    id_to_col = {oid: col for oid, col in scan.columns}
    parts: Optional[Set[int]] = None
    for c in conjuncts(node.cond):
        got = _prune_one(c, router, id_to_col, scan.table)
        if got is not None:
            parts = set(got) if parts is None else (parts & set(got))
    if parts is not None:
        scan.partitions = sorted(parts)
    return node


def _lane_encode(tm, col: str, value):
    """Literal -> lane-domain value for routing (hash routing keys off LANE
    values: dictionary codes for strings, scaled ints for decimals, day
    numbers for dates).  Returns None when unencodable; a string absent from
    the dictionary encodes to -1 (matches no stored row)."""
    cm = tm.column(col)
    if cm.dtype.is_string:
        d = tm.dictionaries.get(col.lower())
        return None if d is None else d.encode_one(str(value), add=False)
    from galaxysql_tpu_torch.expr.compiler import _encode_literal_value
    try:
        v = _encode_literal_value(value, cm.dtype)
    except (TypeError, ValueError):
        return None
    return None if isinstance(v, str) else v


def _extract_sargs(cond: ir.Expr, scan: L.Scan):
    """Collect simple col-vs-literal conjuncts as lane-domain SARGs on the
    scan — the archive layer prunes parquet files by min-max stats against
    them (OSSTableScanExec.java:45-61 analog)."""
    id_to_col = {oid: col for oid, col in scan.columns}
    for c in conjuncts(cond):
        if not (isinstance(c, ir.Call) and
                c.op in ("eq", "lt", "le", "gt", "ge") and len(c.args) == 2):
            continue
        cl = _col_lit_cmp(c)
        if cl is None:
            continue
        col, lit, flipped = cl
        if col.name not in id_to_col:
            continue
        cm = scan.table.column(id_to_col[col.name])
        if cm.dtype.is_string:
            continue  # codes are assignment-ordered; min-max means nothing
        v = _lit_lane_value(lit, cm.dtype)
        if v is None:
            continue
        op = _FLIP.get(c.op, c.op) if flipped else c.op
        scan.sargs.append((cm.name, op, v))


def _choose_point_eq(cond: ir.Expr, scan: L.Scan):
    """Access-path choice: equality on an indexed column marks the scan for
    index-candidate reads (DirectShardingKeyTableOperation / XPlan key-Get,
    reference Planner.java:914, RelToXPlanConverter.java:41).

    Candidate columns, best first: primary-key lead, partition-key lead (the
    shard key — also how a routed GSI table is read), any PUBLIC local index
    lead.  The value is stored in LANE domain; the physical scan serves
    candidate rows through the partition's sorted key index and the Filter
    above re-verifies, so this is advisory like sargs."""
    tm = scan.table
    id_to_col = {oid: col for oid, col in scan.columns}
    eqs: Dict[str, ir.Literal] = {}
    for c in conjuncts(cond):
        if not (isinstance(c, ir.Call) and c.op == "eq" and len(c.args) == 2):
            continue
        cl = _col_lit_cmp(c)
        if cl is None:
            continue
        col, lit, _ = cl
        if col.name in id_to_col:
            eqs[id_to_col[col.name].lower()] = lit
    if not eqs:
        return
    cands: List[str] = []
    if tm.primary_key:
        cands.append(tm.primary_key[0])
    if tm.partition.columns:
        cands.append(tm.partition.columns[0])
    for i in tm.indexes:
        if i.status == "PUBLIC" and not i.global_index and i.columns:
            cands.append(i.columns[0])
    for cname in cands:
        lit = eqs.get(cname.lower())
        if lit is None:
            continue
        cm = tm.column(cname)
        # access-path cost check: a low-cardinality index lead (status flags
        # etc.) would return huge candidate sets through the host index path —
        # worse than the device full scan.  NDV comes from ANALYZE.
        ndv = tm.stats.ndv.get(cm.name, 0)
        if ndv and tm.stats.row_count and \
                tm.stats.row_count / ndv > 65536:
            continue
        v = _lane_encode(tm, cm.name, lit.value)
        if v is None:
            continue
        if cm.dtype.is_string:
            v = np.int32(v)
        scan.point_eq = (cm.name, v)
        return


def route_covering_gsi(node: L.RelNode, catalog) -> L.RelNode:
    """Rewrite a filtered base-table scan onto a covering GSI backing table.

    Reference analog: CBO index selection over global secondary indexes
    (SURVEY.md App.D; `polardbx-optimizer/.../index`): when a predicate has an
    equality on a PUBLIC GSI's leading column and the GSI's backing table
    carries every referenced column (index + covering + PK), the scan reads
    the GSI table instead — partition pruning then routes on the GSI's
    partition key and the point-eq path serves it as an index lookup.  Skipped
    when the predicate already pins the base table's own point key."""
    node.children = [route_covering_gsi(c, catalog) for c in node.children]
    if not isinstance(node, L.Filter) or not isinstance(node.child, L.Scan):
        return node
    scan = node.child
    tm = scan.table
    if getattr(tm, "remote", None) is not None or "$" in tm.name:
        return node
    id_to_col = {oid: col.lower() for oid, col in scan.columns}
    eq_cols = set()
    for c in conjuncts(node.cond):
        if isinstance(c, ir.Call) and c.op == "eq" and len(c.args) == 2:
            cl = _col_lit_cmp(c)
            if cl is not None and cl[0].name in id_to_col:
                eq_cols.add(id_to_col[cl[0].name])
    if not eq_cols:
        return node
    if tm.primary_key and tm.primary_key[0].lower() in eq_cols:
        return node  # base point read is already optimal
    if tm.partition.columns and tm.partition.columns[0].lower() in eq_cols:
        return node  # already routable to one shard of the base table
    referenced = {col.lower() for _, col in scan.columns}
    for i in tm.indexes:
        if not (i.global_index and i.status == "PUBLIC" and i.columns):
            continue
        if i.columns[0].lower() not in eq_cols:
            continue
        try:
            gtm = catalog.table(tm.schema, f"{tm.name}${i.name}")
        except Exception:
            continue
        if not referenced <= {c.name.lower() for c in gtm.columns}:
            continue  # not covering: would need a back-lookup join
        scan.table = gtm
        scan.partitions = None
        scan.sargs = []
        return node
    return node


def _prune_one(c: ir.Expr, router: PartitionRouter, id_to_col,
               tm) -> Optional[List[int]]:
    if isinstance(c, ir.Call) and c.op == "eq":
        col, lit = _col_lit(c.args[0], c.args[1], id_to_col)
        if col is not None:
            v = _lane_encode(tm, col, lit)
            if v is None:
                return None
            return router.prune_eq(col, v)
    if isinstance(c, ir.InList) and not c.negated:
        if isinstance(c.arg, ir.ColRef) and c.arg.name in id_to_col:
            out: List[int] = []
            for v in c.values:
                lv = _lane_encode(tm, id_to_col[c.arg.name], v)
                if lv is None:
                    return None
                got = router.prune_eq(id_to_col[c.arg.name], lv)
                if got is None:
                    return None
                out.extend(got)
            return sorted(set(out))
    return None


def _col_lit(a: ir.Expr, b: ir.Expr, id_to_col):
    if isinstance(a, ir.ColRef) and isinstance(b, ir.Literal) and a.name in id_to_col:
        return id_to_col[a.name], b.value
    if isinstance(b, ir.ColRef) and isinstance(a, ir.Literal) and b.name in id_to_col:
        return id_to_col[b.name], a.value
    return None, None


def optimize(node: L.RelNode, spm=None, catalog=None, hints=None) -> L.RelNode:
    """The full RBO pipeline.

    push_filters runs BEFORE join-tree construction: subquery unnesting wraps the
    cross-join forest in semi/anti joins, and the WHERE conjuncts above them must reach
    the forest first or the forest would be ordered without its predicates.

    `spm` (SpmContext) pins/reports join orders — see build_join_tree.
    `catalog` (when given) enables GSI access-path routing.
    `hints` gate the runtime-filter pass (NO_BLOOM / RUNTIME_FILTER)."""
    node = push_filters(node)
    node = build_join_tree(node, spm)
    node = push_filters(node)
    node = prune_columns(node)
    if catalog is not None:
        # after column pruning: covering is judged on the columns actually
        # referenced, not the table's full column list
        node = route_covering_gsi(node, catalog)
    node = prune_partitions(node)
    # LAST: filter edges bind scan identities, which GSI routing just settled
    node = plan_runtime_filters(node, hints)
    # skew plans bind the same scan identities (and reuse the rf lineage walk)
    node = plan_skew(node, hints)
    return node
