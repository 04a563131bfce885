"""Engine instance (trimmed port of `galaxysql_tpu/server/instance.py`).

Owns the catalog, table stores, planner, TSO and the device cache, and carries the
torch device every query of the instance runs on.  `Instance()` means the CUDA
device and raises where CUDA is absent; `Instance(device="cpu")` runs the same
operators on the CPU, where each kernel call site takes its plain version.

Durable state is the reference's.  `Instance(data_dir=d)` keeps its metadb
(`meta/gms.py`) in `d/metadb.sqlite`: the catalog, views, SET GLOBAL values, users
and grants, plan baselines, DDL jobs, the recycle bin, the node registry and the
global transaction log, each committed to sqlite as it changes.  `save()` is the
checkpoint: every store's partitions and dictionaries under
`d/<schema>/<table>/` in the reference's file format, the table metadata and the
catalog counters.  `boot()`, run by the constructor, attaches the plan baselines,
reloads the SET GLOBAL values, the catalog and the stores, resolves the provisional
stamps of transactions in doubt against the transaction log
(`txn/xa.recover_persisted`), registers the node (`node_info`) and resumes
interrupted DDL jobs.  So a boot brings back what the last `save()` wrote, plus the
outcomes the transaction log decides for the provisional stamps in it.  Without a
`data_dir` the metadb is in memory and `save()` does nothing.  Left out of boot and
save: the compile cache (not queued: the CUDA build cache is keyed by source hash).
`save()` first drains the async applier and raises `TddlError` when it does not drain:
a checkpoint must never hold a base table whose GSI rows are still queued.

Cold and columnar tiers, as in the reference: `archive` (the TTL Parquet archive,
`storage/archive.py`, under `data_dir/archive`) and `columnar` (the CDC-fed columnar
replica, `storage/columnar.py`).  `boot()` attaches the archive's manifest and then
loads the replicas after the stores and dictionaries; `save()` checkpoints the
replicas.  `metrics` is the reference's typed registry (`utils/metrics.py`), which
holds the replica's counters and gauges and the fragment cache's `frag_cache_*`;
`shutdown()` stops the replica's tailer.

`frag_cache` is the reference's cross-query fragment cache
(`exec/fragment_cache.py`): cached join builds with their runtime filters and
replayed aggregate and build-subtree outputs, keyed by table versions, on while
`ENABLE_FRAGMENT_CACHE` is.  `invalidate_fragment_cache` is the local half of the
reference's sync action of that name (its broadcast to peer coordinators waits for
ROADMAP Queue 1 item 15b).

It also holds the configuration (`config`, the reference's `ConfigParams`) with its
`config_listener`, the `privileges` over the metadb, the registered point plans of
the sequential fast path (`point_plans`, cleared past 512 entries as in the
reference), the cross-session `batch_scheduler`, the commit coordinator
(`xa_coordinator`, `txn/xa.py`, with the group-commit gate) and `counters`
(`point_plan_queries`, `batched_point_queries`, `group_commit_batches`,
`group_committed_txns`, `gsi_async_applies`, `async_apply_failures`, `mpp_queries`,
`mpp_fallback_local`; `count` adds to them; `information_schema.engine_counters`
lists them).  `mesh()` is the MPP device mesh (`parallel/mesh.py`): one shard a CUDA
device when there are several, else None, as in the reference.  The write side: `cdc` (the binlog, `txn/cdc.py`), the registered DML batch
plans (`dml_plans`) and their `dml_batch_scheduler` (`server/dml_batch.py`), and the
`applier` of async GSI maintenance (`txn/async_apply.py`).

DDL: `mdl` (statement-scope metadata locks, `meta/mdl.py`), `ddl_engine` (the
job engine over the metadb's `ddl_engine` tables, `ddl/jobs.py`) and `recycle` (the
recycle bin, `server/maintain.py`).  `register_table` saves the new table to the
metadb; `drop_store` removes a table's store, its metadb row and its lanes in the
device cache.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from typing import Dict, Optional

import torch

from galaxysql_tpu_torch.config.params import ConfigParams
from galaxysql_tpu_torch.ddl.jobs import DdlEngine
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.exec.fragment_cache import FragmentCache
from galaxysql_tpu_torch.meta.catalog import Catalog, TableMeta
from galaxysql_tpu_torch.meta.gms import ConfigListener, MetaDb
from galaxysql_tpu_torch.meta.mdl import MdlManager
from galaxysql_tpu_torch.meta.privileges import PrivilegeManager
from galaxysql_tpu_torch.meta.tso import TimestampOracle
from galaxysql_tpu_torch.plan.planner import Planner
from galaxysql_tpu_torch.server.batch_scheduler import BatchScheduler
from galaxysql_tpu_torch.server.dml_batch import DmlBatchScheduler
from galaxysql_tpu_torch.server.maintain import RecycleBin
from galaxysql_tpu_torch.storage.archive import ArchiveManager
from galaxysql_tpu_torch.storage.columnar import ColumnarReplicaManager
from galaxysql_tpu_torch.storage.table_store import TableStore
from galaxysql_tpu_torch.txn.async_apply import AsyncApplier
from galaxysql_tpu_torch.txn.cdc import CdcManager
from galaxysql_tpu_torch.txn.xa import TwoPhaseCoordinator, recover_persisted
from galaxysql_tpu_torch.utils import errors
from galaxysql_tpu_torch.utils.metrics import MetricsRegistry


class Instance:
    def __init__(self, data_dir: Optional[str] = None, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Instance on a CUDA device, but CUDA is not available "
                               "(pass device='cpu' to run on the CPU)")
        self.device = device
        self.catalog = Catalog()
        self.stores: Dict[str, TableStore] = {}
        self.planner = Planner(self.catalog)
        self.tso = TimestampOracle()
        self.device_cache = DeviceCache(device)
        self.sessions: Dict[int, object] = {}
        self._conn_ids = itertools.count(1)
        self._lock = threading.Lock()
        self.config = ConfigParams()
        self.metrics = MetricsRegistry()
        # cross-query fragment cache; frag_cache_* metrics ride this registry
        self.frag_cache = FragmentCache(metrics=self.metrics)
        self.data_dir = data_dir
        self.metadb = MetaDb(os.path.join(data_dir, "metadb.sqlite")
                             if data_dir else None)
        self.config_listener = ConfigListener(self.metadb)
        self.privileges = PrivilegeManager(self.metadb)
        # the change log lives in the metadb beside the transaction log
        self.cdc = CdcManager(self)
        self.archive = ArchiveManager(
            os.path.join(data_dir, "archive") if data_dir else None)
        self.node_id = f"cn-{uuid.uuid4().hex[:8]}"
        self.catalog.create_schema("information_schema", if_not_exists=True)
        # (schema, parameterized SQL) -> PointPlan dict (`Session._register_point_plan`)
        self.point_plans: Dict[tuple, dict] = {}
        self.counters: Dict[str, int] = {"point_plan_queries": 0,
                                         "batched_point_queries": 0,
                                         "group_commit_batches": 0,
                                         "group_committed_txns": 0,
                                         "gsi_async_applies": 0,
                                         "async_apply_failures": 0,
                                         "mpp_queries": 0,
                                         "mpp_fallback_local": 0}
        self.batch_scheduler = BatchScheduler(self)
        # (schema, parameterized SQL) -> DML batch plan (`dml_batch.try_register`)
        self.dml_plans: Dict[tuple, dict] = {}
        self.dml_batch_scheduler = DmlBatchScheduler(self)
        self.applier = AsyncApplier(self)
        self.columnar = ColumnarReplicaManager(self)
        self.xa_coordinator = TwoPhaseCoordinator(self)
        self.mdl = MdlManager()
        self.ddl_engine = DdlEngine(self)
        self.recycle = RecycleBin(self)
        self.boot()

    def _reload_global_config(self, *_):
        """Pull the SET GLOBAL values persisted in the metadb (the config
        listener's handler, as in the reference)."""
        for k, v in self.metadb.kv_scan("config.param."):
            try:
                self.config.set_instance(k[len("config.param."):], json.loads(v))
            except Exception:
                continue  # an unknown or stale parameter must not poison the reload

    def boot(self):
        """Load the persisted metadata and data, resolve the transactions a crash
        left in doubt, then resume interrupted DDL jobs."""
        self.planner.spm.attach(self.metadb)
        self.config_listener.bind("config.params", self._reload_global_config)
        self._reload_global_config()
        for tm in self.metadb.load_catalog(self.catalog):
            store = self.register_table(tm, persist=False)
            if self.data_dir:
                d = os.path.join(self.data_dir, tm.schema.lower(), tm.name.lower())
                if os.path.isdir(d):
                    store.load(d)
        # the checkpointed catalog counters: replaying the schema loads derives
        # schema_version differently than the live history did, which would
        # invalidate every persisted plan baseline; max() so they never run back
        v = self.metadb.kv_get("catalog.versions")
        if v:
            try:
                parts = json.loads(v)
                self.catalog.version = max(self.catalog.version, int(parts[0]))
                self.catalog.schema_version = max(self.catalog.schema_version,
                                                  int(parts[1]))
                if len(parts) > 2:
                    self.catalog.stats_version = max(self.catalog.stats_version,
                                                     int(parts[2]))
            except (ValueError, TypeError, IndexError):
                pass  # a corrupt counter record must not poison boot
        self.archive.attach(self.metadb)
        # replicas restore AFTER the stores and dictionaries (persisted stripe
        # lanes hold dictionary codes) and resume tailing from the checkpointed
        # binlog seq
        self.columnar.load()
        # provisional stamps a crash left resolve against the transaction log
        # BEFORE anything reads the loaded partitions
        recover_persisted(self)
        self.metadb.heartbeat(self.node_id, "coordinator", "127.0.0.1", 0)
        self.ddl_engine.recover()

    def save(self):
        """Checkpoint every store's data and metadata to `data_dir` (nothing
        without one)."""
        if not self.data_dir:
            return
        # pending async GSI applies land before the snapshot: a checkpoint taken
        # mid-apply would persist a base table whose GSI rows exist only in the
        # in-memory queue, which has no redo source
        if not self.applier.drain():
            raise errors.TddlError(
                "checkpoint aborted: async GSI/replica applies did not "
                "drain (backlog wedged); retry after the applier recovers")
        # taken BEFORE the store snapshots: a transaction committing while save()
        # runs may leave provisional stamps in an already-written file
        t0 = time.time()
        for key, store in list(self.stores.items()):
            store.save(os.path.join(self.data_dir, key.replace(".", os.sep)))
            self.metadb.save_table(store.table)
        self.metadb.kv_put("last_checkpoint_at", repr(t0))
        # the replica checkpoint rides the same save: stripe lanes hold dictionary
        # codes, persisted beside the stores' own dictionaries.json
        self.columnar.save()
        # the catalog counters ride the checkpoint so a booted instance keeps its
        # persisted plan baselines valid (see boot())
        self.metadb.kv_put("catalog.versions", json.dumps(
            [self.catalog.version, self.catalog.schema_version,
             self.catalog.stats_version]))

    def shutdown(self):
        """Stop the background threads the instance started (the replica's
        tailer)."""
        self.columnar.shutdown()

    def store_key(self, schema: str, table: str) -> str:
        return f"{schema.lower()}.{table.lower()}"

    def register_table(self, tm: TableMeta, persist: bool = True) -> TableStore:
        store = TableStore(tm)
        self.stores[self.store_key(tm.schema, tm.name)] = store
        if persist:
            self.metadb.save_table(tm)
        return store

    def drop_store(self, schema: str, table: str):
        """The table leaves for good: its store, its metadb row and the lanes the
        device cache holds for it."""
        store = self.stores.pop(self.store_key(schema, table), None)
        self.metadb.drop_table(schema, table)
        self.frag_cache.invalidate_table(self.store_key(schema, table))
        if store is not None:
            self.device_cache.evict_store(store.uid)

    def install_store(self, store: TableStore):
        """Replace a table's store (e.g. one built by `storage.transfer`)."""
        tm = store.table
        if self.catalog.table(tm.schema, tm.name) is not tm:
            raise ValueError(f"store of {tm.schema}.{tm.name} is not for this catalog")
        self.stores[self.store_key(tm.schema, tm.name)] = store
        self.frag_cache.invalidate_table(self.store_key(tm.schema, tm.name))

    def invalidate_fragment_cache(self, schema: str, table: str):
        """Drop every cached fragment that read the table and bump its epoch."""
        self.frag_cache.bump_epoch(self.store_key(schema, table))

    def store(self, schema: str, table: str) -> TableStore:
        return self.stores[self.store_key(schema, table)]

    def allocate_conn_id(self) -> int:
        with self._lock:
            return next(self._conn_ids)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def mesh(self):
        """The instance's device mesh for MPP execution: one shard on each CUDA
        device when the instance runs on CUDA and more than one device exists, else
        None (the reference's rule: no MPP on a single device).  Cached in `_mesh`;
        a caller may install a mesh there (the tests' 8 shards on the CPU, the chip
        smoke's 8 shards on one card)."""
        if not hasattr(self, "_mesh"):
            self._mesh = None
            if self.device.type == "cuda" and torch.cuda.device_count() > 1:
                from galaxysql_tpu_torch.parallel.mesh import make_mesh
                self._mesh = make_mesh()
        return self._mesh
