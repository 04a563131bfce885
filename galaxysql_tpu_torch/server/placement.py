"""Physical placement bindings: group labels -> real endpoints.

Reference analog: the LocalityManager/`LOCALITY=` clause lineage — the
reference binds storage groups to DN instances so MOVE PARTITION changes
which box actually serves the rows.  Before this module, placement groups
(`PartitionInfo.placement`, REBALANCE_GROUPS) were pure labels: the
balancer proposed MOVEs between them but nothing physical changed.

A binding maps one group label to where that group's data *lives*:

- ``endpoint`` — a worker ``host:port``: `Instance.read_endpoint` boosts
  the bound endpoint for tables whose dominant group is bound, so a MOVE
  PARTITION into a bound group shifts which worker serves the reads.
- ``coordinator`` — a peer coordinator node id: the front router
  (server/router.py) prefers that peer for statements touching the table,
  keeping the coordinator co-located with its partitions.
- ``device`` — an accelerator mesh label (advisory; surfaced for EXPLAIN
  and the mesh planner, not enforced here).

Bindings persist in the shared metadb kv space (``placement.group.<g>``)
so every coordinator over one GMS sees the same physical map — exactly the
property the serving tier needs: peer A's MOVE changes peer B's routing.
Reads go through a short TTL cache; the hot path (router/locality checks)
is a dict lookup, not a metadb query.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional, Tuple

PREFIX = "placement.group."


class PlacementBinding:
    """Group-label -> physical binding map over the shared metadb."""

    TTL_S = 1.0  # metadb re-read cadence; cross-coordinator visibility bound

    def __init__(self, instance):
        self.instance = instance
        self._cache: Dict[str, dict] = {}
        self._cache_at = 0.0
        # dominant-group memo per table, invalidated on catalog version bump
        # (MOVE PARTITION bumps it at cutover) — one pass over `placement`
        # per table per DDL generation, not per routed statement
        self._dominant: Dict[Tuple[str, str], str] = {}
        self._dominant_ver = -1

    # -- writes ---------------------------------------------------------------

    def bind(self, group: str, endpoint: Optional[str] = None,
             coordinator: Optional[str] = None,
             device: Optional[str] = None) -> dict:
        """Persist a binding (merge semantics: unset fields keep their old
        value so `bind(g, coordinator=...)` doesn't erase the endpoint)."""
        group = group.lower()
        entry = dict(self.binding(group) or {})
        if endpoint is not None:
            entry["endpoint"] = endpoint
        if coordinator is not None:
            entry["coordinator"] = coordinator
        if device is not None:
            entry["device"] = device
        self.instance.metadb.kv_put(PREFIX + group, json.dumps(entry))
        self._cache_at = 0.0  # local cache: next read refreshes
        return entry

    def unbind(self, group: str):
        self.instance.metadb.kv_delete(PREFIX + group.lower())
        self._cache_at = 0.0

    # -- reads ----------------------------------------------------------------

    def _load(self) -> Dict[str, dict]:
        now = time.time()
        if now - self._cache_at > self.TTL_S:
            fresh: Dict[str, dict] = {}
            for k, v in self.instance.metadb.kv_scan(PREFIX):
                try:
                    fresh[k[len(PREFIX):]] = json.loads(v)
                except Exception:  # galaxylint: disable=swallow -- a corrupt binding must not poison routing; unbound is the safe default
                    continue
            self._cache = fresh
            self._cache_at = now
        return self._cache

    def binding(self, group: str) -> Optional[dict]:
        return self._load().get(group.lower())

    def rows(self):
        """(group, endpoint, coordinator, device) for tests/observability."""
        return [(g, e.get("endpoint", ""), e.get("coordinator", ""),
                 e.get("device", ""))
                for g, e in sorted(self._load().items())]

    # -- locality -------------------------------------------------------------

    def dominant_group(self, tm) -> str:
        """The group label holding the most of `tm`'s partitions — the
        table's physical home for routing purposes.  MOVE PARTITION rewrites
        `placement` and bumps the catalog version, which invalidates this
        memo: locality preference genuinely follows the move."""
        cat_ver = self.instance.catalog.version
        if cat_ver != self._dominant_ver:
            self._dominant.clear()
            self._dominant_ver = cat_ver
        key = (tm.schema.lower(), tm.name.lower())
        g = self._dominant.get(key)
        if g is None:
            p = tm.partition
            counts: Dict[str, int] = {}
            for pid in range(p.num_partitions):
                lbl = p.group_of(pid)
                counts[lbl] = counts.get(lbl, 0) + 1
            g = max(counts, key=counts.get) if counts else p.DEFAULT_GROUP
            self._dominant[key] = g
        return g

    def preferred_endpoint(self, tm) -> Optional[Tuple[str, int]]:
        """The worker endpoint bound to `tm`'s dominant group, as an
        (host, port) addr — read routing boosts it (never exclusively:
        a mis-bound group must not black-hole reads)."""
        ent = self.binding(self.dominant_group(tm))
        ep = ent.get("endpoint") if ent else None
        if not ep or ":" not in ep:
            return None
        host, _, port = ep.rpartition(":")
        try:
            return host, int(port)
        except ValueError:
            return None

    def preferred_coordinator(self, schema: str, table: str) -> Optional[str]:
        """The peer coordinator node id bound to the table's dominant group
        (router locality preference), or None when unbound/unknown."""
        try:
            tm = self.instance.catalog.table(schema, table)
        except Exception:  # galaxylint: disable=swallow -- unknown table: no locality preference, the ring decides
            return None
        ent = self.binding(self.dominant_group(tm))
        return (ent or {}).get("coordinator") or None
