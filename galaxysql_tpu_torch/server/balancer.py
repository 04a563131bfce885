"""Heat-driven Balancer: proposes partition SPLIT/MERGE/MOVE from observed
runtime truth, and executes them through the ddl/rebalance.py job family.

Reference analog: `executor/balancer/Balancer.java` (SURVEY.md §2.6) — the
policy half of scale-out.  The signals are the PR 9/10 substrate:

- per-partition HEAT = visible row share plus the hot-key mass the
  heavy-hitter sketches (`TableStats.heavy[_rt]` on the partition column)
  route to each partition — a skewed hot key shows up as heat long before
  row counts diverge;
- statement-summary TRAFFIC gates which tables are worth touching at all
  (a cold table never rebalances, however lopsided its rows);
- the admission plane gates WHEN: under memory pressure or a saturated
  admission queue the balancer proposes nothing — rebalance yields to
  serving (PR 12 graceful degradation), and the backfill task additionally
  paces its chunks under pressure.

`run_once` is the maintain-loop entry (`@job_kind("rebalance")`,
server/scheduler.py); `REBALANCE TABLE t` runs the same pipeline
synchronously and returns the decisions as rows.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.utils import errors


class Balancer:
    def __init__(self, instance):
        self.instance = instance
        # last proposals per table key (SHOW REBALANCE-adjacent operator aid)
        self.last_proposals: List[dict] = []
        self.last_run_at: float = 0.0
        # no-progress damping: table key -> (n_parts, hot/mean ratio, pid)
        # recorded at each split proposal; see propose_table
        self._split_outcome: Dict[str, Tuple[int, float, int]] = {}

    # -- config knobs --------------------------------------------------------

    def _cfg(self, name: str, default):
        v = self.instance.config.get(name)
        return default if v is None else v

    # -- signals -------------------------------------------------------------

    def table_traffic(self) -> Dict[str, float]:
        """total statement-summary time (ms) attributed per table name (by
        digest-text match — digests don't carry a table list, but the
        parameterized text does)."""
        store = getattr(self.instance, "stmt_summary", None)
        if store is None:
            return {}
        out: Dict[str, float] = {}
        for r in store.rows():
            schema, text = (r[1] or "").lower(), (r[-1] or "").lower()
            total_ms = float(r[6]) * max(int(r[4]), 1)
            s = self.instance.catalog.schemas.get(schema)
            if s is None:
                continue
            for tname in s.tables:
                if tname.startswith("__recycle__") or "$" in tname:
                    continue
                # word-boundary match: a table named `t` must not collect
                # the traffic of every statement containing the letter t
                if re.search(r"\b%s\b" % re.escape(tname), text):
                    key = f"{schema}.{tname}"
                    out[key] = out.get(key, 0.0) + total_ms
        return out

    def partition_heat(self, tm, store) -> List[float]:
        """heat[pid] = visible rows + HOT_WEIGHT x sketch-estimated hot-key
        occurrences routed to pid (lane domain -> router, the exact mapping
        writes use)."""
        heat = [float(p.num_rows) for p in store.partitions]
        info = tm.partition
        if not info.columns:
            return heat
        try:
            col = tm.column(info.columns[0]).name  # stats key on exact name
        except errors.TddlError:
            return heat
        sketch = tm.stats.heavy_rt.get(col) or tm.stats.heavy.get(col)
        if sketch is None or not sketch.counts:
            return heat
        hot_w = float(self._cfg("REBALANCE_HOT_WEIGHT", 4.0))
        vals = np.asarray(list(sketch.counts.keys()))
        freqs = list(sketch.counts.values())
        try:
            pids = store.router.route_rows([vals])
        except Exception:
            return heat
        for pid, f in zip(pids.tolist(), freqs):
            if 0 <= pid < len(heat):
                heat[pid] += hot_w * float(f)
        return heat

    # -- proposal policy -----------------------------------------------------

    def propose_table(self, tm, store) -> List[dict]:
        info = tm.partition
        if info.method in ("single", "broadcast") or "$" in tm.name or \
                getattr(tm, "remote", None) is not None or \
                not tm.primary_key:
            return []
        n = info.num_partitions
        if n != len(store.partitions):
            return []  # mid-cutover snapshot; skip
        heat = self.partition_heat(tm, store)
        total = sum(heat)
        min_rows = int(self._cfg("REBALANCE_MIN_ROWS", 1000))
        if total < min_rows:
            return []
        mean = total / max(n, 1)
        out: List[dict] = []
        split_f = float(self._cfg("REBALANCE_SPLIT_FACTOR", 2.0))
        merge_f = float(self._cfg("REBALANCE_MERGE_FACTOR", 0.25))
        max_parts = int(self._cfg("REBALANCE_MAX_PARTITIONS", 64))
        key = f"{tm.schema.lower()}.{tm.name.lower()}"
        hot = int(np.argmax(heat))
        # split proposals are hash/key-only: a range split needs an explicit
        # AT (value) boundary the balancer cannot synthesize faithfully in
        # literal domain (operators split range tables manually)
        if heat[hot] > split_f * mean and n < max_parts and \
                info.method in ("hash", "key"):
            # no-progress damping: a split moves whole buckets, so one
            # dominant key's mass lands intact on a single target and
            # re-trips the trigger next tick — without this check one hot
            # key drives a full backfill+cutover per maintain tick all the
            # way to max_parts.  Park further splits of the same table once
            # a landed split (n grew) left the same partition's imbalance
            # essentially unchanged; un-park when the ratio improves, the
            # hot spot moves, or a merge shrinks the table back.
            ratio = heat[hot] / max(mean, 1.0)
            prev = self._split_outcome.get(key)
            if prev is not None and n > prev[0] and hot in \
                    (prev[2], prev[0]) and ratio >= 0.9 * prev[1]:
                pass  # previous split bought nothing; stop chasing the key
            else:
                out.append({"table": key, "op": "split", "pids": [hot],
                            "why": f"heat {heat[hot]:.0f} > {split_f:.1f}x "
                                   f"mean {mean:.0f}"})
                self._split_outcome[key] = (n, ratio, hot)
        elif n > 1 and info.method in ("hash", "key"):
            order = np.argsort(heat)
            a, b = int(order[0]), int(order[1])
            if heat[a] + heat[b] < merge_f * mean:
                out.append({"table": key, "op": "merge",
                            "pids": sorted((a, b)),
                            "why": f"cold pair {heat[a] + heat[b]:.0f} < "
                                   f"{merge_f:.2f}x mean {mean:.0f}"})
        # cross-group placement: move the hottest partition of the most
        # loaded group to the least loaded one (groups opt-in via the
        # REBALANCE_GROUPS csv param)
        groups = [g.strip() for g in
                  str(self._cfg("REBALANCE_GROUPS", "") or "").split(",")
                  if g.strip()]
        if len(groups) > 1 and not out:
            load = {g: 0.0 for g in groups}
            for pid, h in enumerate(heat):
                load[info.group_of(pid)] = \
                    load.get(info.group_of(pid), 0.0) + h
            src_g = max(load, key=load.get)
            dst_g = min(load, key=load.get)
            if load[src_g] > 2.0 * max(load[dst_g], 1.0):
                cands = [(h, pid) for pid, h in enumerate(heat)
                         if info.group_of(pid) == src_g]
                if cands:
                    _, pid = max(cands)
                    out.append({"table": key, "op": "move", "pids": [pid],
                                "group": dst_g,
                                "why": f"group {src_g} load "
                                       f"{load[src_g]:.0f} > 2x {dst_g} "
                                       f"{load[dst_g]:.0f}"})
        return out

    def propose(self, schema: Optional[str] = None,
                table: Optional[str] = None) -> List[dict]:
        traffic = self.table_traffic()
        min_ms = float(self._cfg("REBALANCE_MIN_TRAFFIC_MS", 0.0))
        out: List[dict] = []
        for s in list(self.instance.catalog.schemas.values()):
            if s.name == "information_schema":
                continue
            if schema and s.name.lower() != schema.lower():
                continue
            for tm in list(s.tables.values()):
                if table and tm.name.lower() != table.lower():
                    continue
                if tm.name.startswith("__recycle__") or "$" in tm.name:
                    continue
                key = f"{tm.schema.lower()}.{tm.name.lower()}"
                if min_ms > 0 and traffic.get(key, 0.0) < min_ms:
                    continue  # cold table: not worth moving bytes for
                store = self.instance.stores.get(key)
                if store is None:
                    continue
                out.extend(self.propose_table(tm, store))
        self.last_proposals = out
        return out

    # -- execution -----------------------------------------------------------

    def overloaded(self) -> bool:
        """Rebalance yields to serving: propose/execute nothing while the
        memory governor reports pressure."""
        adm = getattr(self.instance, "admission", None)
        gov = getattr(adm, "governor", None)
        return gov is not None and gov.tier() > 0

    def execute(self, prop: dict) -> int:
        from galaxysql_tpu_torch.ddl import rebalance as rb
        schema, tname = prop["table"].split(".", 1)
        op = prop["op"]
        sql = f"/* balancer */ rebalance {op} {prop['table']} {prop['pids']}"
        if op == "split":
            job = rb.split_partition_job(schema, sql, tname, prop["pids"][0],
                                         int(prop.get("into", 2)),
                                         prop.get("at"))
        elif op == "merge":
            job = rb.merge_partitions_job(schema, sql, tname,
                                          prop["pids"][0], prop["pids"][1])
        elif op == "move":
            job = rb.move_partition_job(schema, sql, tname, prop["pids"][0],
                                        prop["group"])
        else:
            raise errors.TddlError(f"unknown balancer op {op!r}")
        self.instance.ddl_engine.submit_and_run(job)
        return job.job_id or 0

    def run_once(self, schema: Optional[str] = None,
                 table: Optional[str] = None, apply: bool = True
                 ) -> List[dict]:
        """One maintain-loop tick: propose, and (optionally) execute the
        first proposal — one data movement per tick keeps the blast radius
        and the serving impact bounded."""
        self.last_run_at = time.time()
        if not bool(self._cfg("ENABLE_REBALANCE", True)):
            return []
        if self.overloaded():
            return []
        props = self.propose(schema, table)
        if apply and props:
            first = props[0]
            try:
                first["job_id"] = self.execute(first)
                first["applied"] = True
            except errors.TddlError as e:
                first["applied"] = False
                first["error"] = str(e)
        return props
