"""Planner driver + plan cache.

Reference analog: `Planner.plan(sql, ec) -> ExecutionPlan` (SURVEY.md §2.5):
parameterize -> plan-cache probe -> parse -> bind/validate -> RBO -> (physical at
execution).  The cache key is (schema, parameterized SQL); entries are invalidated by
catalog version, mirroring `PlanCache.java:80`'s metadata-version keying.

Workload classification (TP vs AP) follows `WorkloadUtil.determineWorkloadType`
(§2.5): estimated scanned rows under threshold -> TP; over -> AP.  The executor uses
this to pick the engine (host path for latency-bound point queries, device kernels for
scans), mirroring `ExecutorHelper.selectExecutorMode`.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from galaxysql_tpu_torch.meta.catalog import Catalog
from galaxysql_tpu_torch.plan import logical as L
from galaxysql_tpu_torch.plan.binder import Binder
from galaxysql_tpu_torch.plan.rules import estimate_rows, optimize
from galaxysql_tpu_torch.sql import ast
from galaxysql_tpu_torch.sql.parameterize import parameterize
from galaxysql_tpu_torch.sql.parser import parse


class ExecutionPlan:
    def __init__(self, rel: L.RelNode, display_names: List[str],
                 statement: ast.Statement, catalog_version: int,
                 param_count: int):
        self.rel = rel
        self.display_names = display_names
        self.statement = statement
        self.catalog_version = catalog_version
        self.param_count = param_count
        self.scanned_rows = scanned_rows_estimate(rel)
        self.workload = "AP" if self.scanned_rows >= AP_ROW_THRESHOLD else "TP"
        self.spm_key = None          # set when planned through the cache path
        self.join_orders: List[Tuple[str, ...]] = []
        self.hints: Dict[str, object] = {}
        self.heal_pin = ""           # fragment-cache salt while healing

    def fields(self) -> List[L.Field]:
        return self.rel.fields()

    def explain(self) -> str:
        return L.explain(self.rel)


AP_ROW_THRESHOLD = 50_000


def scanned_rows_estimate(rel: L.RelNode) -> float:
    total = 0.0
    for n in L.walk(rel):
        if isinstance(n, L.Scan):
            if n.point_eq is not None:
                # index access path: the scan touches ~rows/NDV candidates,
                # not the table (DirectShardingKeyTableOperation analog);
                # ANALYZE stats keep the TP/AP classification honest for
                # non-unique index leads
                ndv = n.table.stats.ndv.get(n.point_eq[0], 0)
                est = (n.table.stats.row_count / ndv) if ndv else 2.0
                total += max(est, 2.0)
                continue
            frac = 1.0
            if n.partitions is not None and n.table.partition.num_partitions > 0:
                frac = len(n.partitions) / n.table.partition.num_partitions
            total += n.table.stats.row_count * frac
    return total


def classify_workload(rel: L.RelNode) -> str:
    """TP = small row footprint (host engine); AP = large (device engine)."""
    return "AP" if scanned_rows_estimate(rel) >= AP_ROW_THRESHOLD else "TP"


class PlanCache:
    """Guava-cache analog: bounded LRU keyed by (schema, parameterized SQL)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._map: "collections.OrderedDict[Tuple[str, str], ExecutionPlan]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple[str, str], catalog_version: int) -> Optional[ExecutionPlan]:
        with self._lock:
            plan = self._map.get(key)
            if plan is None or plan.catalog_version != catalog_version:
                if plan is not None:
                    del self._map[key]
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return plan

    def put(self, key: Tuple[str, str], plan: ExecutionPlan):
        with self._lock:
            self._map[key] = plan
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def invalidate(self, key: Tuple[str, str]):
        """Drop ONE digest's cached plan (the self-heal loop retires a
        regressed or probation plan without a fleet-wide replan storm)."""
        with self._lock:
            self._map.pop(key, None)

    def invalidate_all(self):
        with self._lock:
            self._map.clear()


class Planner:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self.cache = PlanCache()
        from galaxysql_tpu_torch.plan.spm import PlanManager
        self.spm = PlanManager()

    def plan_select(self, sql: str, schema: str,
                    params: Optional[list] = None, session=None) -> ExecutionPlan:
        """Plan a SELECT (or EXPLAIN-able) statement with caching.

        The PARAMETERIZED text is what gets parsed, so the cached AST carries `?`
        placeholders; executions with new values re-bind from that AST (skipping the
        parse — the reference's PlanCache + per-execution PostPlanner split).  Literal
        values and client-protocol params resolve through the slot plan in order.
        """
        p = parameterize(sql)
        key = (schema.lower(), p.cache_key)
        bind_values = p.resolve(params or [])
        low = sql.lower()
        if "nextval" in low or "connection_id" in low or "_lock" in low:
            # per-execution values (sequences, session identity): never cache; bind
            # the PARAMETERIZED text so client '?' indexes stay aligned
            return self.bind_statement(parse(p.parameterized), schema, bind_values,
                                       session)
        cached = self.cache.get(key, self.catalog.version)
        if cached is not None and cached.param_count == len(bind_values):
            if cached.bound_params == bind_values:
                return cached
            plan = self.bind_statement(cached.statement, schema, bind_values, session,
                                       spm_key=key)
            self.cache.put(key, plan)
            return plan
        stmt = parse(p.parameterized)
        plan = self.bind_statement(stmt, schema, bind_values, session, spm_key=key)
        self.cache.put(key, plan)
        return plan

    def bind_statement(self, stmt: ast.Statement, schema: str,
                       params: list, session=None,
                       spm_key: Optional[Tuple[str, str]] = None,
                       forced_orders: Optional[list] = None) -> ExecutionPlan:
        binder = Binder(self.catalog, schema, params)
        if session is not None:
            binder.sequence_hook = \
                lambda nm: session.instance.sequences.next_value(schema, nm)
            binder.connection_id = session.conn_id
            binder.lock_fn_hook = session._lock_fn
        if isinstance(stmt, (ast.Select, ast.SetOpSelect)):
            rel, names = binder.bind_query(stmt)
        else:
            raise ValueError(f"not a plannable statement: {type(stmt).__name__}")
        # hints outrank SPM; SPM accepted baselines outrank the cost model
        from galaxysql_tpu_torch.sql.hints import parse_hints, qualified_order
        hints = parse_hints(getattr(stmt, "hints", None))
        from galaxysql_tpu_torch.plan.spm import SpmContext
        forced = forced_orders
        if forced is None and hints.get("join_order"):
            forced = [tuple(qualified_order(hints["join_order"], schema))]
        hinted = forced_orders is None and (bool(hints.get("join_order")) or
                                            hints.get("baseline_off"))
        if forced is None and spm_key is not None and not hinted:
            forced = self.spm.choose(spm_key, self.catalog.schema_version)
        spm_ctx = SpmContext(forced)
        rel = optimize(rel, spm_ctx, catalog=self.catalog, hints=hints)
        if forced_orders is None and not hinted and spm_key is not None and \
                spm_ctx.chosen:
            self.spm.capture(spm_key, spm_ctx.chosen, self.catalog.schema_version,
                             followed_baseline=forced is not None,
                             cost_preferred=spm_ctx.cost_preferred)
        plan = ExecutionPlan(rel, names, stmt, self.catalog.version, len(params))
        plan.bound_params = list(params)
        plan.spm_key = None if hinted else spm_key
        plan.join_orders = list(spm_ctx.chosen)
        plan.hints = hints
        # self-heal salt: plans bound while this digest's heal episode is live
        # carry a pin that re-keys fragment-cache fingerprints, so probation
        # and regressed artifacts never cross (zero-episode path: one compare)
        plan.heal_pin = self.spm.heal_pin(spm_key) \
            if plan.spm_key is not None else ""
        return plan



