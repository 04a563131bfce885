"""Catalog: schemas, tables, columns, partitioning metadata.

Reference analog: `TableMeta`/`PartitionInfo(Manager)` (`optimizer/config/table`,
`optimizer/partition`, SURVEY.md §2.5 L9) plus the GMS-backed schema registry (§2.8).
In-memory here; `meta/gms.py` persists/reloads it and bumps versions for plan-cache
invalidation (the reference's metadata-version mechanism, `PlanCache.java:80`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Dictionary
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal
from galaxysql_tpu_torch.utils import errors


@dataclasses.dataclass
class ColumnMeta:
    name: str
    dtype: dt.DataType
    nullable: bool = True
    default: Any = None
    auto_increment: bool = False
    comment: Optional[str] = None


@dataclasses.dataclass
class PartitionInfo:
    """Table partitioning scheme.

    method: hash | key | range | range_columns | list | list_columns | single | broadcast
    `columns` are the partitioning columns; `count` the shard count for hash/key;
    `boundaries` the ordered upper bounds (range) or value lists (list), lane-encoded.
    """

    method: str
    columns: List[str] = dataclasses.field(default_factory=list)
    count: int = 1
    boundaries: List[Tuple[str, List[Any]]] = dataclasses.field(default_factory=list)
    # partition-granular elasticity (ddl/rebalance.py): when set, hash/key
    # routing goes value -> bucket (mix % len(bucket_map)) -> partition
    # bucket_map[bucket].  The bucket space is a fixed multiple of the count
    # the table had when it was converted, and the initial assignment
    # b -> b % count is routing-identical to the plain modulo (x % (n*K)) % n
    # == x % n), so conversion is metadata-only; SPLIT/MERGE then reassign
    # only the affected partition's buckets.
    bucket_map: Optional[List[int]] = None
    # per-partition placement group labels (parallel to partition ids;
    # padded with DEFAULT_GROUP).  The balancer proposes MOVEs across groups;
    # MOVE PARTITION rewrites one entry at cutover.
    placement: List[str] = dataclasses.field(default_factory=list)

    DEFAULT_GROUP = "g0"

    def group_of(self, pid: int) -> str:
        return self.placement[pid] if pid < len(self.placement) \
            else self.DEFAULT_GROUP

    @property
    def num_partitions(self) -> int:
        if self.method in ("single", "broadcast"):
            return 1
        if self.method in ("hash", "key"):
            return self.count
        return len(self.boundaries)

    @property
    def is_broadcast(self) -> bool:
        return self.method == "broadcast"


SINGLE = PartitionInfo("single")


@dataclasses.dataclass
class IndexMeta:
    name: str
    columns: List[str]
    unique: bool = False
    global_index: bool = False
    covering: List[str] = dataclasses.field(default_factory=list)
    partition: Optional[PartitionInfo] = None
    # state machine for online GSI builds (CREATING -> ... -> PUBLIC, SURVEY.md App.D)
    status: str = "PUBLIC"


@dataclasses.dataclass
class TableStats:
    row_count: int = 0
    ndv: Dict[str, int] = dataclasses.field(default_factory=dict)
    min_max: Dict[str, Tuple[Any, Any]] = dataclasses.field(default_factory=dict)
    version: int = 0
    # equi-depth histograms + HLL sketches (meta/statistics.py), built by ANALYZE
    histograms: Dict[str, Any] = dataclasses.field(default_factory=dict)
    sketches: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # heavy-hitter (Space-Saving) sketches: ANALYZE truth + the runtime twin
    # refreshed from hash-join build sides (meta/statistics.observe_build_keys)
    heavy: Dict[str, Any] = dataclasses.field(default_factory=dict)
    heavy_rt: Dict[str, Any] = dataclasses.field(default_factory=dict)


class TableMeta:
    def __init__(self, schema: str, name: str, columns: Sequence[ColumnMeta],
                 primary_key: Sequence[str] = (),
                 partition: PartitionInfo = SINGLE,
                 indexes: Sequence[IndexMeta] = (),
                 comment: Optional[str] = None):
        self.schema = schema
        self.name = name
        self.columns = list(columns)
        self.primary_key = list(primary_key)
        self.partition = partition
        self.indexes = list(indexes)
        self.comment = comment
        # CN->worker plane: non-None marks a remote table served by a worker
        # process via shipped SQL ({"host":..., "port":...}; net/dn.py)
        self.remote: Optional[Dict[str, Any]] = None
        # read replicas of a remote table: [{"host","port","weight","stale"}]
        # — weighted read routing with fence-triggered failover
        # (TGroupDataSource analog, polardbx-executor group/*)
        self.replicas: List[Dict[str, Any]] = []
        self.by_name: Dict[str, ColumnMeta] = {c.name.lower(): c for c in self.columns}
        # one shared host dictionary per string column (codes stable table-wide)
        self.dictionaries: Dict[str, Dictionary] = {
            c.name.lower(): Dictionary() for c in self.columns if c.dtype.is_string}
        self.stats = TableStats()
        self.version = 1
        self.auto_increment_next = 1

    def column(self, name: str) -> ColumnMeta:
        c = self.by_name.get(name.lower())
        if c is None:
            raise errors.UnknownColumnError(
                f"Unknown column '{name}' in table '{self.name}'")
        return c

    def has_column(self, name: str) -> bool:
        return name.lower() in self.by_name

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def schema_dict(self) -> Dict[str, dt.DataType]:
        return {c.name: c.dtype for c in self.columns}

    def bump_version(self):
        self.version += 1
        self.stats.version += 1


@dataclasses.dataclass
class ViewDef:
    """A stored view: name + optional explicit column names + the SELECT text.

    Expanded at bind time like the reference's `DrdsViewExpander` — the stored
    SQL re-parses and re-binds per reference, so views always reflect current
    base-table metadata."""
    schema: str
    name: str
    columns: Optional[List[str]]
    sql: str


class SchemaMeta:
    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, TableMeta] = {}
        self.views: Dict[str, ViewDef] = {}

    def table(self, name: str) -> TableMeta:
        t = self.tables.get(name.lower())
        if t is None:
            raise errors.UnknownTableError(f"Table '{self.name}.{name}' doesn't exist")
        return t


class Catalog:
    """All schemas in the instance; versioned for plan-cache invalidation."""

    def __init__(self):
        self.schemas: Dict[str, SchemaMeta] = {}
        self.version = 0
        # schema-only counter: bumped by DDL (create/drop/alter of tables, views,
        # schemas) but NOT by DML commits.  SPM baselines key on this — a write
        # must not invalidate plan baselines (PlanManager invalidates on schema
        # change only; `version` also moves on data changes for scan caches).
        self.schema_version = 0
        # statistics epoch: bumped by ANALYZE, DDL, and heal-loop stats
        # repair — but NOT by DML (`version` moves on every commit).  The
        # HEAL_FAILED park re-arm keys on this: "re-arm only on ANALYZE/DDL"
        # must not be defeated by an unrelated INSERT.
        self.stats_version = 0

    def bump_schema(self):
        self.version += 1
        self.schema_version += 1
        self.stats_version += 1

    def create_schema(self, name: str, if_not_exists: bool = False) -> SchemaMeta:
        key = name.lower()
        if key in self.schemas:
            if if_not_exists:
                return self.schemas[key]
            raise errors.TddlError(f"Can't create database '{name}'; database exists")
        s = SchemaMeta(name)
        self.schemas[key] = s
        self.bump_schema()
        return s

    def drop_schema(self, name: str, if_exists: bool = False):
        key = name.lower()
        if key not in self.schemas:
            if if_exists:
                return
            raise errors.UnknownDatabaseError(f"Can't drop database '{name}'")
        del self.schemas[key]
        self.bump_schema()

    def schema(self, name: str) -> SchemaMeta:
        s = self.schemas.get(name.lower())
        if s is None:
            raise errors.UnknownDatabaseError(f"Unknown database '{name}'")
        return s

    def table(self, schema: str, name: str) -> TableMeta:
        return self.schema(schema).table(name)

    def view(self, schema: str, name: str) -> Optional[ViewDef]:
        s = self.schemas.get(schema.lower())
        return s.views.get(name.lower()) if s is not None else None

    def add_view(self, v: ViewDef, or_replace: bool = False) -> None:
        s = self.schema(v.schema)
        key = v.name.lower()
        if key in s.views and not or_replace:
            raise errors.TableExistsError(f"View '{v.name}' already exists")
        if key in s.tables:
            raise errors.TableExistsError(f"'{v.name}' is a base table")
        s.views[key] = v
        self.bump_schema()

    def drop_view(self, schema: str, name: str, if_exists: bool = False) -> bool:
        s = self.schema(schema)
        key = name.lower()
        if key not in s.views:
            if if_exists:
                return False
            raise errors.UnknownTableError(f"Unknown view '{schema}.{name}'")
        del s.views[key]
        self.bump_schema()
        return True

    def add_table(self, tm: TableMeta, if_not_exists: bool = False) -> bool:
        s = self.schema(tm.schema)
        key = tm.name.lower()
        if key in s.tables:
            if if_not_exists:
                return False
            raise errors.TableExistsError(f"Table '{tm.name}' already exists")
        s.tables[key] = tm
        self.bump_schema()
        return True

    def drop_table(self, schema: str, name: str, if_exists: bool = False) -> bool:
        s = self.schema(schema)
        key = name.lower()
        if key not in s.tables:
            if if_exists:
                return False
            raise errors.UnknownTableError(f"Unknown table '{schema}.{name}'")
        del s.tables[key]
        self.bump_schema()
        return True


# ---------------------------------------------------------------------------
# partition routing & pruning
# ---------------------------------------------------------------------------

_HASH_M1 = np.uint64(0xff51afd7ed558ccd)
_HASH_M2 = np.uint64(0xc4ceb9fe1a85ec53)


def _mix64_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * _HASH_M1
    h = h ^ (h >> np.uint64(33))
    h = h * _HASH_M2
    h = h ^ (h >> np.uint64(33))
    return h


def hash_partition_of(values: np.ndarray, count: int) -> np.ndarray:
    """Shard id per value — the same mix the device kernels use, so shard-local data
    stays consistent with device-side repartitioning.  Routed through the native
    runtime (libgalaxystore) when available."""
    from galaxysql_tpu_torch import native
    return native.hash_partition(np.asarray(values).astype(np.int64), count)


def encode_partition_value(v: Any, typ: dt.DataType) -> Any:
    """Literal -> lane domain for range/list boundary comparison."""
    if v is None:
        return None
    if typ.clazz == dt.TypeClass.DECIMAL:
        return int(round(float(v) * 10 ** typ.scale))
    if typ.clazz == dt.TypeClass.DATE and isinstance(v, str):
        return temporal.parse_date(v)
    if typ.clazz == dt.TypeClass.DATETIME and isinstance(v, str):
        return temporal.parse_datetime(v)
    if isinstance(v, str):
        return v
    return int(v) if not isinstance(v, float) else v


class PartitionRouter:
    """Routes rows/literals to partition ids; prunes partition lists for predicates.

    Reference analog: `PartitionPruner.java:39` building `PartitionPruneStep` (§2.5).
    """

    # monotonic mint for router identities: every swap installs a router
    # with a fresh epoch so caches/tests can prove they re-keyed
    _epoch_mint = itertools.count(1)

    def __init__(self, table: TableMeta, info: Optional[PartitionInfo] = None):
        """`info` overrides the table's live partitioning: the rebalance
        backfill routes rows by the TARGET map while the table still serves
        from the old one."""
        self.table = table
        self.info = info if info is not None else table.partition
        self.epoch = next(PartitionRouter._epoch_mint)
        # bucket indirection cached as a lane for vectorized routing
        self._bucket_arr = (np.asarray(self.info.bucket_map, dtype=np.int32)
                            if self.info.bucket_map is not None else None)

    def route_rows(self, key_arrays: List[np.ndarray]) -> np.ndarray:
        info = self.info
        n = key_arrays[0].shape[0] if key_arrays else 0
        if info.method in ("single", "broadcast"):
            return np.zeros(n, dtype=np.int32)
        if info.method in ("hash", "key"):
            h = key_arrays[0].astype(np.int64)
            for k in key_arrays[1:]:
                with np.errstate(over="ignore"):
                    h = (h * 31 + k.astype(np.int64))
            if self._bucket_arr is not None:
                return self._bucket_arr[
                    hash_partition_of(h, self._bucket_arr.shape[0])]
            return hash_partition_of(h, info.count)
        if info.method in ("range", "range_columns"):
            bounds = [b[1][0] for b in info.boundaries]
            # MAXVALUE encoded as None -> +inf
            enc = [np.inf if b is None else b for b in bounds]
            return np.searchsorted(np.asarray(enc, dtype=np.float64),
                                   key_arrays[0].astype(np.float64),
                                   side="right").astype(np.int32)
        if info.method in ("list", "list_columns"):
            out = np.full(n, -1, dtype=np.int32)
            for pid, (_, vals) in enumerate(info.boundaries):
                out = np.where(np.isin(key_arrays[0], np.asarray(vals)), pid, out)
            if (out < 0).any():
                raise errors.TddlError("row has no matching LIST partition")
            return out
        raise errors.TddlError(f"unknown partition method {info.method}")

    def route_literal(self, values: List[Any]) -> int:
        arrays = [np.asarray([v]) for v in values]
        return int(self.route_rows(arrays)[0])

    def prune_eq(self, column: str, value: Any) -> Optional[List[int]]:
        """Partitions that can contain column = value (None -> no pruning possible)."""
        info = self.info
        if info.method in ("single", "broadcast"):
            return [0]
        if column.lower() != (info.columns[0].lower() if info.columns else None):
            return None
        if info.method in ("hash", "key"):
            if len(info.columns) > 1:
                return None  # composite key needs all columns
            return [self.route_literal([value])]
        return [self.route_literal([value])]

    def prune_range(self, column: str, low: Any, high: Any) -> Optional[List[int]]:
        """Partitions possibly containing low <= column <= high (range methods only)."""
        info = self.info
        if info.method not in ("range", "range_columns") or not info.columns:
            return None
        if column.lower() != info.columns[0].lower():
            return None
        bounds = [b[1][0] for b in info.boundaries]
        enc = np.asarray([np.inf if b is None else b for b in bounds], dtype=np.float64)
        lo_p = 0 if low is None else int(np.searchsorted(enc, float(low), side="right"))
        hi_p = len(bounds) - 1 if high is None else \
            int(np.searchsorted(enc, float(high), side="right"))
        hi_p = min(hi_p, len(bounds) - 1)
        return list(range(lo_p, hi_p + 1))
