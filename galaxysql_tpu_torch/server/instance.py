"""Engine instance (trimmed port of `galaxysql_tpu/server/instance.py`).

Owns the catalog, table stores, planner, TSO and the device cache, and carries the
torch device every query of the instance runs on.  `Instance()` means the CUDA
device and raises where CUDA is absent; `Instance(device="cpu")` runs the same
operators on the CPU, where each kernel call site takes its plain version.

It also holds the configuration (`config`, the reference's `ConfigParams`), the
in-memory metadb (`metadb`, the reference's `MetaDb(None)`: SET GLOBAL values,
users and grants) with its `config_listener` and the `privileges` over it, the
registered point plans of the sequential fast path (`point_plans`, cleared past 512
entries as in the reference), the cross-session `batch_scheduler` and `counters`
(`point_plan_queries`, `batched_point_queries`; `count` adds to them).

DDL: `mdl` (statement-scope metadata locks, `meta/mdl.py`), `ddl_engine` (the
job engine over the metadb's `ddl_engine` tables, `ddl/jobs.py`) and `recycle` (the
recycle bin, `server/maintain.py`).  `register_table` saves the new table to the
metadb; `drop_store` removes a table's store, its metadb row and its lanes in the
device cache.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Dict

import torch

from galaxysql_tpu_torch.config.params import ConfigParams
from galaxysql_tpu_torch.ddl.jobs import DdlEngine
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.meta.catalog import Catalog, TableMeta
from galaxysql_tpu_torch.meta.gms import ConfigListener, MetaDb
from galaxysql_tpu_torch.meta.mdl import MdlManager
from galaxysql_tpu_torch.meta.privileges import PrivilegeManager
from galaxysql_tpu_torch.meta.tso import TimestampOracle
from galaxysql_tpu_torch.plan.planner import Planner
from galaxysql_tpu_torch.server.batch_scheduler import BatchScheduler
from galaxysql_tpu_torch.server.maintain import RecycleBin
from galaxysql_tpu_torch.storage.table_store import TableStore


class Instance:
    def __init__(self, device=None):
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
        self.metadb = MetaDb(None)
        self.config_listener = ConfigListener(self.metadb)
        self.config_listener.bind("config.params", self._reload_global_config)
        self.privileges = PrivilegeManager(self.metadb)
        self.catalog.create_schema("information_schema", if_not_exists=True)
        # (schema, parameterized SQL) -> PointPlan dict (`Session._register_point_plan`)
        self.point_plans: Dict[tuple, dict] = {}
        self.counters: Dict[str, int] = {"point_plan_queries": 0,
                                         "batched_point_queries": 0}
        self.batch_scheduler = BatchScheduler(self)
        self.mdl = MdlManager()
        self.ddl_engine = DdlEngine(self)
        self.recycle = RecycleBin(self)

    def _reload_global_config(self, *_):
        """Pull the SET GLOBAL values persisted in the metadb (the config
        listener's handler, as in the reference)."""
        for k, v in self.metadb.kv_scan("config.param."):
            try:
                self.config.set_instance(k[len("config.param."):], json.loads(v))
            except Exception:
                continue  # an unknown or stale parameter must not poison the reload

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
        if store is not None:
            self.device_cache.evict_store(store.uid)

    def install_store(self, store: TableStore):
        """Replace a table's store (e.g. one built by `storage.transfer`)."""
        tm = store.table
        if self.catalog.table(tm.schema, tm.name) is not tm:
            raise ValueError(f"store of {tm.schema}.{tm.name} is not for this catalog")
        self.stores[self.store_key(tm.schema, tm.name)] = store

    def store(self, schema: str, table: str) -> TableStore:
        return self.stores[self.store_key(schema, table)]

    def allocate_conn_id(self) -> int:
        with self._lock:
            return next(self._conn_ids)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
