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
replayed aggregate and build-subtree outputs, keyed by table versions (remote tables
by an epoch), on while `ENABLE_FRAGMENT_CACHE` is; `invalidate_fragment_cache` drops a
table's entries on this instance and bumps its epoch (DDL calls it; peers hear of a
write to a remote table through the sync action of that name).

The worker plane, as in the reference: `workers` (one `net/dn.WorkerClient` an
attached worker endpoint, made by `worker_client`), the `sync_bus` that broadcasts
cache invalidations to every attached worker and peer coordinator, and `ha`
(`meta/ha.py`: worker fencing, probing, the leader election).  `attach_remote_table`
registers a table a worker process holds (`net/worker.py`): its scans ship as plan
fragments (`plan/physical.py`), its DML as branches of a distributed transaction
(`server/session.py`, `txn/xa.py`).  `attach_replica` adds a read replica on another
worker, backfilled from the primary when it is empty; reads pick an endpoint by
weight (`read_endpoint`), skipping fenced, stale and breaker-blocked ones.
`apply_sync_action` receives a peer's broadcasts (`sync_peer()`, attached to the
peer's `sync_bus`, in process, or `net/server.CoordinatorSyncListener` over the wire).
Its `health` action answers with this node's metric-history sample, admission
snapshot and burning SLOs (the reference's), and `cluster_health` pulls every
attached worker's.

Placement, the reference's: `rebalance_shadows` (the shadow partitions of running
SPLIT / MERGE / MOVE PARTITION jobs, `ddl/rebalance.py`), `balancer` (the heat-driven
`server/balancer.py`), `placement` (group bindings to workers, coordinators and
devices, `server/placement.py`; `read_endpoint` gives the endpoint bound to a table's
dominant group four times its weight), `sequences` (`meta/sequence.py`, NEXTVAL) and
the serving tier's peer registry: `coordinators`, `attach_coordinator` /
`detach_coordinator` (which forgets the peer's admission gossip) and
`coordinator_rows` (SHOW COORDINATORS), read by `server/router.FrontRouter`, which
sets `router`.  `move_remote_table` moves a worker-resident table to another worker
online: a snapshot copy under the shared MDL, then the delta and the endpoint swap
under the exclusive one.

The operations plane, the reference's: `profiles` (the last-N QueryProfiles),
`trace_store` (tail-sampled span trees), `stmt_summary`
(`meta/statement_summary.py`: per digest and plan windows, the regression sentinel
and its self-heal), `admission` (`server/admission.py`: the workload-class gate and
the memory governor over `exec/memory.GLOBAL_POOL`), `metric_history`, `slo` and
`recorder` (the SLO plane and the flight recorder, sampled by `slo_tick`),
`scheduler` (`server/scheduler.py`, whose maintain loop drives `slo_tick`) and
`locks` (GET_LOCK).  `finish_handles` binds the query metrics once per (workload,
engine).

It also holds the configuration (`config`, the reference's `ConfigParams`) with its
`config_listener`, the `privileges` over the metadb, the registered point plans of
the sequential fast path (`point_plans`, cleared past 512 entries as in the
reference), the cross-session `batch_scheduler`, the commit coordinator
(`xa_coordinator`, `txn/xa.py`, with the group-commit gate) and `counters`, the
reference's dict-like view over the registry's `engine_*` counters
(`point_plan_queries`, `batched_point_queries`, `mpp_queries`, `mpp_fallback_local`,
and the per-engine query counts `exec_<engine>`; `count` adds atomically;
`information_schema.engine_counters` lists them).  The async applier's, the batchers'
and the group-commit gate's counters and histograms are registry metrics under the
reference's names (`gsi_async_applies`, `group_commit_batches`,
`dml_batched_queries`, `batch_group_size`, ...).  `mesh()` is the MPP device mesh (`parallel/mesh.py`): one shard a CUDA
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

from galaxysql_tpu_torch import native
from galaxysql_tpu_torch.config.params import ConfigParams
from galaxysql_tpu_torch.ddl.jobs import DdlEngine
from galaxysql_tpu_torch.exec.device_cache import DeviceCache
from galaxysql_tpu_torch.exec.fragment_cache import FragmentCache
from galaxysql_tpu_torch.meta.catalog import Catalog, TableMeta
from galaxysql_tpu_torch.meta.gms import ConfigListener, MetaDb
from galaxysql_tpu_torch.meta.ha import HaManager
from galaxysql_tpu_torch.meta.mdl import MdlManager
from galaxysql_tpu_torch.meta.privileges import PrivilegeManager
from galaxysql_tpu_torch.meta.sequence import SequenceManager
from galaxysql_tpu_torch.meta.tso import LOGICAL_BITS, TimestampOracle
from galaxysql_tpu_torch.net.dn import SyncBus, WorkerClient
from galaxysql_tpu_torch.plan.planner import Planner
from galaxysql_tpu_torch.server.balancer import Balancer
from galaxysql_tpu_torch.server.batch_scheduler import BatchScheduler
from galaxysql_tpu_torch.server.dml_batch import DmlBatchScheduler
from galaxysql_tpu_torch.server.maintain import RecycleBin
from galaxysql_tpu_torch.server.placement import PlacementBinding
from galaxysql_tpu_torch.storage.archive import ArchiveManager
from galaxysql_tpu_torch.storage.columnar import ColumnarReplicaManager
from galaxysql_tpu_torch.storage.table_store import TableStore
from galaxysql_tpu_torch.txn.async_apply import AsyncApplier
from galaxysql_tpu_torch.txn.cdc import CdcManager
from galaxysql_tpu_torch.txn.xa import TwoPhaseCoordinator, recover_persisted
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors, events
from galaxysql_tpu_torch.exec.operators import COMPILE_STATS
from galaxysql_tpu_torch.meta.statement_summary import StatementSummaryStore
from galaxysql_tpu_torch.server.admission import AdmissionController
from galaxysql_tpu_torch.server.flight_recorder import FlightRecorder
from galaxysql_tpu_torch.server.scheduler import ScheduledJobManager
from galaxysql_tpu_torch.server.slo import SloEngine
from galaxysql_tpu_torch.utils.locks import LockingFunctionManager
from galaxysql_tpu_torch.utils.metric_history import MetricHistory
from galaxysql_tpu_torch.utils.metrics import (BATCH_GROUP_SIZE, BATCH_WAIT_MS,
                                               BREAKER_OPENS, DML_GROUP_SIZE,
                                               DML_WAIT_MS, QUERY_TIMEOUTS,
                                               RETRY_BUDGET_EXHAUSTED, RPC_FAILURES,
                                               RPC_RETRIES, RPC_RTT_MS,
                                               SEGMENT_WALL_MS, SPILL_BYTES,
                                               SPILL_FILES, SYNC_FAILURES, SYNC_HEALS,
                                               WORKER_FAILOVERS, MetricsRegistry)
from galaxysql_tpu_torch.utils.tracing import ProfileRing, TraceIdAllocator, TraceStore


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
        # the C++ host runtime (visibility, routing, blooms) builds or loads here,
        # not inside the first statement that calls it
        native.load()
        self.sessions: Dict[int, object] = {}
        self._conn_ids = itertools.count(1)
        self._lock = threading.Lock()
        self.config = ConfigParams()
        self.metrics = MetricsRegistry()
        # the device_cache_* gauges ride this registry
        self.device_cache.bind_metrics(self.metrics)
        # cross-query fragment cache; frag_cache_* metrics ride this registry
        self.frag_cache = FragmentCache(metrics=self.metrics)
        self.data_dir = data_dir
        self.metadb = MetaDb(os.path.join(data_dir, "metadb.sqlite")
                             if data_dir else None)
        self.config_listener = ConfigListener(self.metadb)
        self.sequences = SequenceManager(self.metadb)
        self.privileges = PrivilegeManager(self.metadb)
        # the change log lives in the metadb beside the transaction log
        self.cdc = CdcManager(self)
        self.archive = ArchiveManager(
            os.path.join(data_dir, "archive") if data_dir else None)
        self.node_id = f"cn-{uuid.uuid4().hex[:8]}"
        self.started_at = time.time()
        # node-prefixed ids: statement uids of shipped writes must never collide
        # across coordinators
        self.trace_ids = TraceIdAllocator(self.node_id)
        self.workers: Dict[tuple, object] = {}  # (host, port) -> WorkerClient
        # the origin rides every RPC with the bus epoch: workers key their
        # last-applied sync epoch per coordinator (`net/worker.py` healing)
        self.sync_bus = SyncBus(origin=self.node_id)
        self.ha = HaManager(self)
        # the fault-tolerance plane's process-wide counters and the RPC
        # round-trip histogram, surfaced through this instance's registry
        for m in (SEGMENT_WALL_MS, RPC_RTT_MS, BATCH_GROUP_SIZE, BATCH_WAIT_MS,
                  DML_GROUP_SIZE, DML_WAIT_MS, RPC_RETRIES, RPC_FAILURES,
                  BREAKER_OPENS, WORKER_FAILOVERS, SYNC_FAILURES, SYNC_HEALS,
                  QUERY_TIMEOUTS, RETRY_BUDGET_EXHAUSTED, SPILL_BYTES, SPILL_FILES):
            self.metrics.adopt(m)
        self.metrics.histogram("query_latency_ms", "end-to-end query latency (ms)")
        self.catalog.create_schema("information_schema", if_not_exists=True)
        # (schema, parameterized SQL) -> PointPlan dict (`Session._register_point_plan`)
        self.point_plans: Dict[tuple, dict] = {}
        # dict-like view over the registry's `engine_*` counters
        # (information_schema.engine_counters); `count` adds atomically
        self.counters = self.metrics.counter_map("engine")
        # (workload, engine) -> bound metric handles for `Session._finish_query`
        self.finish_metrics: Dict[tuple, tuple] = {}
        # last-N per-query runtime profiles (information_schema.query_stats, SHOW
        # PROFILES, web /query/<trace_id>)
        self.profiles = ProfileRing()
        # tail-sampled trace retention: the finish ramps offer slow, shed, errored
        # and sampled span trees into this byte-budgeted ring
        self.trace_store = TraceStore(
            budget_bytes=int(self.config.get("TRACE_STORE_BUDGET_BYTES") or (4 << 20)),
            rate=float(self.config.get("TRACE_SAMPLE_RATE") or 0.0),
            node=self.node_id)
        # the statement-digest summary and the plan-regression sentinel, fed by
        # `Session._finish_query`
        self.stmt_summary = StatementSummaryStore(self)
        self.locks = LockingFunctionManager()
        self.batch_scheduler = BatchScheduler(self)
        # (schema, parameterized SQL) -> DML batch plan (`dml_batch.try_register`)
        self.dml_plans: Dict[tuple, dict] = {}
        self.dml_batch_scheduler = DmlBatchScheduler(self)
        self.applier = AsyncApplier(self)
        self.columnar = ColumnarReplicaManager(self)
        # the overload plane: the workload-class admission gate and the memory
        # governor over exec/memory.GLOBAL_POOL
        self.admission = AdmissionController(self)
        # the SLO plane: the metric history, the burn-rate and anomaly engine, and
        # the flight recorder, sampled by `slo_tick`
        self.metric_history = MetricHistory(self)
        self.slo = SloEngine(self)
        self.recorder = FlightRecorder(self)
        self.xa_coordinator = TwoPhaseCoordinator(self)
        self.mdl = MdlManager()
        self.ddl_engine = DdlEngine(self)
        self.scheduler = ScheduledJobManager(self)
        self.recycle = RecycleBin(self)
        # elastic rebalancing: the running jobs' shadow partitions, outside every
        # store until their cutover
        self.rebalance_shadows: Dict[str, object] = {}
        self.balancer = Balancer(self)
        # group label -> worker endpoint / coordinator / device, in the metadb
        self.placement = PlacementBinding(self)
        # node id -> peer coordinator's sync endpoint (`attach_coordinator`)
        self.coordinators: Dict[str, object] = {}
        self.boot()

    def finish_handles(self, workload: str, engine: str) -> tuple:
        """(latency histogram, total / workload / engine counters) bound once per
        (workload, engine): shared by `Session._finish_query` and the batch
        schedulers' bulk group finish."""
        handles = self.finish_metrics.get((workload, engine))
        if handles is None:
            m = self.metrics
            handles = (m.histogram("query_latency_ms", "end-to-end query latency (ms)"),
                       m.counter("queries_total", "queries executed"),
                       m.counter(f"queries_{workload.lower()}",
                                 f"{workload} workload queries"),
                       m.counter(f"engine_exec_{engine}",
                                 f"queries served by the {engine} engine"))
            self.finish_metrics[(workload, engine)] = handles
        return handles

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
        tailer and the scheduler's maintain loop)."""
        self.columnar.shutdown()
        self.scheduler.stop()

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
        self.counters.inc(name, n)

    # -- the SLO plane ---------------------------------------------------------------

    def slo_tick(self, now: Optional[float] = None, force: bool = False) -> bool:
        """One SLO-plane tick: take a history sample (interval-gated unless
        `force`) and, when one lands, burn-rate every objective, rate-anomaly every
        counter and let the flight recorder scan the journal.  Driven by the
        scheduler's maintain loop and by tests with synthetic `now` stamps.
        Advisory: never raises (the reference's)."""
        try:
            mh = self.metric_history
            sampled = mh.sample(now=now) if force else mh.maybe_sample(now=now)
            if sampled is None:
                return False
            self.slo.evaluate(now=now)
            self.recorder.tick(now=now)
            return True
        except Exception:  # galaxylint: disable=swallow -- advisory plane: a sampler fault must never affect serving
            return False

    def cluster_health(self, pull: bool = True):
        """Cluster-wide health rows: this coordinator first, then one row per
        attached worker.  `pull=True` issues the `health` sync action (an
        unreachable worker gets an UNREACHABLE row, never an exception);
        `pull=False` renders from the replies' piggybacked load only.  Peer
        coordinators are not rows here, as in the reference: SHOW COORDINATORS
        lists them (`coordinator_rows`)."""
        mh = self.metric_history
        burning = self.slo.burning_names()
        rows = [(self.node_id, "coordinator", "local",
                 "BURNING" if burning else "OK",
                 1 if self.ha.is_leader() else 0,
                 round(time.time() - self.started_at, 3),
                 float(len(self.sessions)),
                 round(mh.rate("queries_total"), 3),
                 round(mh.rate("query_errors"), 6),
                 int(self.admission.governor.tier()),
                 ",".join(burning), int(mh.summary()["samples"]))]
        for (host, port), client in sorted(self.workers.items()):
            addr = f"{host}:{port}"
            fenced = self.ha.worker_fenced((host, port))
            if pull:
                try:
                    resp = client.sync_action("health", {})
                except Exception:  # galaxylint: disable=swallow -- the UNREACHABLE row below IS the failure report; the sync client journals breaker state
                    resp = None
                if not (isinstance(resp, dict) and resp.get("ok")):
                    rows.append((addr, "worker", addr, "UNREACHABLE",
                                 0, 0.0, 0.0, 0.0, 0.0, 0, "", 0))
                    continue
                rows.append((resp.get("node", addr), "worker", addr,
                             "FENCED" if fenced else "OK", 0,
                             round(float(resp.get("uptime_s", 0.0)), 3),
                             float(resp.get("active", 0)),
                             round(float(resp.get("qps", 0.0)), 3),
                             round(float(resp.get("error_rate", 0.0)), 6),
                             int(resp.get("mem_tier", 0)), "",
                             int(resp.get("samples", 0))))
            else:
                rows.append((addr, "worker", addr,
                             "FENCED" if fenced else "OK", 0,
                             round(float(getattr(client, "load_up", 0.0)), 3),
                             float(getattr(client, "load_q", 0) or 0),
                             0.0, 0.0,
                             int(getattr(client, "load_tier", 0) or 0), "",
                             int(getattr(client, "load_samples", 0) or 0)))
        return rows

    # -- the worker plane ----------------------------------------------------------

    def worker_client(self, host: str, port: int):
        """Get or create the WorkerClient of an endpoint, bound to the live config
        (SET GLOBAL RPC_* / BREAKER_* retune attached workers too) and wired into
        the sync bus: the one constructor of coordinator -> worker connections."""
        key = (host, port)
        client = self.workers.get(key)
        if client is None:
            client = WorkerClient(host, port, config=self.config)
            self.workers[key] = client
            self.sync_bus.attach(client)
        return client

    def worker_rows(self):
        """SHOW WORKERS / information_schema.workers: one row an attached worker,
        with its fence and circuit-breaker state and lifetime retry and failure
        counts."""
        rows = []
        for (host, port), client in sorted(self.workers.items()):
            bk = client.breaker_snapshot() if hasattr(client, "breaker_snapshot") \
                else {"state": "closed", "consec_failures": 0, "opens": 0,
                      "retries": 0, "failures": 0, "last_error": ""}
            budget = getattr(client, "retry_budget", None)
            rows.append((host, port, bk["state"],
                         1 if self.ha.worker_fenced((host, port)) else 0,
                         bk["consec_failures"], bk["retries"], bk["failures"],
                         bk["opens"], bk["last_error"],
                         int(budget.remaining()) if budget is not None else 0))
        return rows

    def attach_remote_table(self, schema: str, name: str, host: str, port: int):
        """Register a table a worker process holds: its scans ship as plan
        fragments, its writes as branches of a distributed transaction.  The
        worker joins the sync bus and the HA prober; attaching again (a worker
        restarted on another port) repoints the table."""
        from galaxysql_tpu_torch.meta.catalog import SINGLE, ColumnMeta
        client = self.worker_client(host, port)
        resp = client.sync_action("table_meta", {"schema": schema, "table": name})
        # (re)attachment is the reconnect point: resolve the XA branches this
        # worker holds in doubt against our commit-point log
        try:
            self.xa_coordinator.recover_remote()
        except Exception:  # galaxylint: disable=swallow -- recovery retries at the next attach or probe; attaching must not fail on it
            pass
        cols = [ColumnMeta(n, dt.from_sql_name(t, p or 0, s_ or 0), nullable)
                for n, t, p, s_, nullable in resp["columns"]]
        tm = TableMeta(schema, name, cols, resp.get("primary_key") or [], SINGLE)
        tm.remote = {"host": host, "port": port}
        self.catalog.create_schema(schema, if_not_exists=True)
        if not self.catalog.add_table(tm, if_not_exists=True):
            tm = self.catalog.table(schema, name)
            tm.remote = {"host": host, "port": port}
        return tm

    def attach_replica(self, schema: str, name: str, host: str, port: int,
                       weight: int = 1, backfill: Optional[bool] = None):
        """Register a read replica of a remote table.  Writes go to every live
        endpoint as branches of the same distributed transaction (an autocommit
        write's replica legs through the async applier); reads pick a
        weighted-random unfenced endpoint.  `backfill=None` copies from the
        primary when the replica's table is missing or empty, True always copies
        (rebuilding a stale replica needs it), False trusts the caller."""
        key = (host, port)
        client = self.worker_client(host, port)
        tm = self.catalog.table(schema, name)
        if getattr(tm, "remote", None) is None:
            raise errors.NotSupportedError(f"{schema}.{name} is not a remote table")
        entry = next((r for r in tm.replicas if (r["host"], r["port"]) == key), None)
        if entry is not None and entry.get("stale") and backfill is not True:
            raise errors.TddlError(
                f"replica {key} is stale (missed writes); re-attach with "
                f"backfill=True to rebuild it")
        if backfill is None:
            backfill = self._replica_needs_backfill(client, schema, name)
        # the copy and the registration under one exclusive MDL: a write between
        # them would reach the primary only
        with self.mdl.exclusive(self.store_key(schema, name)):
            if backfill:
                self._backfill_replica(client, schema, name)
            if entry is not None:
                entry["weight"] = weight
                entry["stale"] = False
                return tm
            tm.replicas.append({"host": host, "port": port, "weight": weight,
                                "stale": False})
        return tm

    def _replica_needs_backfill(self, client, schema: str, name: str) -> bool:
        try:
            _cols, _types, data, _valid = client.execute(
                f"SELECT count(*) FROM {name}", schema)
            lane = next(iter(data.values())) if data else None
            return lane is None or lane.size == 0 or int(lane[0]) == 0
        except Exception:  # galaxylint: disable=swallow -- the table (or schema) is missing on the replica: it needs the copy
            return True

    def _backfill_replica(self, client, schema: str, name: str):
        """Snapshot copy primary -> replica (the caller holds the exclusive MDL)."""
        tm = self.catalog.table(schema, name)
        src = self.workers[(tm.remote["host"], tm.remote["port"])]
        cols_sql = ", ".join(
            f"{c.name} {c.dtype.sql_name()}" + ("" if c.nullable else " NOT NULL")
            for c in tm.columns)
        pk_sql = (f", PRIMARY KEY ({', '.join(tm.primary_key)})"
                  if tm.primary_key else "")
        # IF NOT EXISTS makes these textually idempotent, so retry-safe
        client.execute(f"CREATE DATABASE IF NOT EXISTS {schema}", "", idem=True)
        client.execute(f"CREATE TABLE IF NOT EXISTS {name} ({cols_sql}{pk_sql})",
                       schema, idem=True)
        names, types, data, valid = src.exec_plan(
            {"schema": schema, "table": name, "columns": tm.column_names()})
        self._bulk_insert_remote(client, schema, name, names, types, data, valid)

    @staticmethod
    def _sql_literal(typ: str, v, valid: bool) -> str:
        if not valid:
            return "NULL"
        if typ.endswith("#scaled"):
            import re
            m = re.search(r"DECIMAL\(\d+,\s*(\d+)\)", typ)
            scale = int(m.group(1)) if m else 0
            s = str(int(v))
            neg = s.startswith("-")
            s = s.lstrip("-").rjust(scale + 1, "0")
            val = (s[:-scale] + "." + s[-scale:]) if scale else s
            return ("-" if neg else "") + val
        if isinstance(v, (int, float)):
            return repr(v)
        return "'" + str(v).replace("\\", "\\\\").replace("'", "''") + "'"

    def _bulk_insert_remote(self, client, schema, table, names, types, data, valid,
                            batch: int = 1000):
        n = len(next(iter(data.values()))) if data else 0
        for off in range(0, n, batch):
            hi = min(off + batch, n)
            rows = []
            for i in range(off, hi):
                vals = []
                for c, ty in zip(names, types):
                    ok_ = bool(valid[c][i]) if c in valid else True
                    vals.append(self._sql_literal(ty, data[c][i], ok_))
                rows.append("(" + ", ".join(vals) + ")")
            # uid-stamped: a reconnect retry of a batch replays the recorded
            # result (the worker's dedupe window) instead of inserting twice
            client.execute(f"INSERT INTO {table} ({', '.join(names)}) "
                           f"VALUES {', '.join(rows)}", schema,
                           uid=f"{self.node_id}:{self.trace_ids.next()}")

    def move_remote_table(self, schema: str, name: str, host: str, port: int):
        """Move a worker-resident table to another worker online, as the reference
        does: (1) a snapshot copy under the shared MDL, so writes keep reaching the
        source; (2) under the exclusive MDL, once no open transaction holds a
        branch on the source worker, the rows inserted and deleted since the
        snapshot (less a 10-minute margin: a commit may draw its timestamp before
        the snapshot and stamp after the copy read) are replayed onto the target,
        delete-by-key before insert, and the table's primary endpoint swaps."""
        tm = self.catalog.table(schema, name)
        if getattr(tm, "remote", None) is None:
            raise errors.NotSupportedError(f"{schema}.{name} is not a remote table")
        src = self.workers[(tm.remote["host"], tm.remote["port"])]
        dst = self.worker_client(host, port)
        cols_sql = ", ".join(
            f"{c.name} {c.dtype.sql_name()}" + ("" if c.nullable else " NOT NULL")
            for c in tm.columns)
        pk_sql = (f", PRIMARY KEY ({', '.join(tm.primary_key)})"
                  if tm.primary_key else "")
        dst.execute(f"CREATE DATABASE IF NOT EXISTS {schema}", "", idem=True)
        dst.execute(f"CREATE TABLE IF NOT EXISTS {name} ({cols_sql}{pk_sql})",
                    schema, idem=True)
        cols = tm.column_names()
        mdl_key = self.store_key(schema, name)
        pk = tm.primary_key[0] if tm.primary_key else cols[0]
        with self.mdl.shared({mdl_key}):
            s0 = self.tso.next_timestamp()
            names, types, data, valid = src.exec_plan(
                {"schema": schema, "table": name, "columns": cols})
            self._bulk_insert_remote(dst, schema, name, names, types, data, valid)
        with self.mdl.exclusive(mdl_key):
            # an open transaction's branch on the source commits past the MDL
            # (statement scope) and would land on the old primary
            src_addr = (src.addr[0], src.addr[1])
            deadline = time.time() + 30.0

            def _pinned():
                for sess in list(self.sessions.values()):
                    txn = getattr(sess, "txn", None)
                    if txn is not None and src_addr in getattr(txn, "remote", {}):
                        return True
                with self.xa_coordinator._lock:
                    for parts in self.xa_coordinator._in_doubt.values():
                        for sp in parts:
                            if getattr(sp, "addr", None) == src_addr:
                                return True
                return False
            while _pinned():
                if time.time() > deadline:
                    raise errors.TddlError(
                        f"move {schema}.{name}: open transactions pin the "
                        f"source worker {src_addr}; retry later")
                time.sleep(0.05)
            margin = 600_000 << LOGICAL_BITS  # 10 minutes of physical TSO
            resp, arrs = src.request(
                {"op": "exec_plan",
                 "fragment": {"schema": schema, "table": name, "columns": cols,
                              "since": max(s0 - margin, 0),
                              "deleted_since_of": pk}})
            ddata = {c: arrs[f"d::{c}"] for c in cols}
            dvalid = {c: arrs[f"v::{c}"] for c in cols if f"v::{c}" in arrs}
            gone = arrs.get("deleted::keys")
            new_keys = list(ddata[pk].tolist()) if cols else []
            drop = set(new_keys) | set(gone.tolist() if gone is not None else [])
            if drop:
                # the key's literals in its wire type, as the backfill's INSERTs
                pk_type = dict(zip(resp["columns"], resp["types"]))[pk]
                in_list = ", ".join(self._sql_literal(pk_type, k, True) for k in drop)
                dst.execute(f"DELETE FROM {name} WHERE {pk} IN ({in_list})",
                            schema, idem=True)
            self._bulk_insert_remote(dst, schema, name, resp["columns"],
                                     resp["types"], ddata, dvalid)
            tm.remote = {"host": host, "port": port}
            self.catalog.bump_schema()
        self.counters.inc("table_moves")
        return tm

    def try_revive_worker(self, addr) -> bool:
        """Lazy fence revival: one ping decides whether a fenced endpoint came
        back (no background prober runs).  True when it is now unfenced."""
        client = self.workers.get(addr)
        if client is None or not self.ha.worker_fenced(addr):
            return False
        if client.ping(timeout=2.0):
            self.ha.fence_worker(addr, False)
            return True
        return False

    def read_endpoint(self, tm):
        """The endpoint to serve a read of `tm`: weighted random over the primary
        and the non-stale replicas, skipping fenced and breaker-blocked workers
        and lowering the weight of those that reported a deep queue or memory
        pressure in the last 5 s.  Returns (addr, client); raises
        WorkerUnavailableError when every endpoint is down."""
        import random
        cands = [((tm.remote["host"], tm.remote["port"]),
                  tm.remote.get("weight", 1))]
        for r in tm.replicas:
            if not r.get("stale"):
                cands.append(((r["host"], r["port"]), r.get("weight", 1)))
        live = [(a, w) for a, w in cands
                if a in self.workers and not self.ha.worker_fenced(a) and
                not getattr(self.workers[a], "breaker_blocked", lambda: False)()]
        if not live:
            # before refusing, ping each fenced candidate once
            for a, w in cands:
                if self.try_revive_worker(a):
                    live.append((a, w))
        if not live:
            raise errors.WorkerUnavailableError(
                f"remote table {tm.name}: every endpoint is fenced/unattached")
        now = time.time()
        # placement locality: the endpoint bound to the table's dominant group
        # gets four times its weight (a boost, never a filter: a mis-bound group
        # must not black-hole reads)
        preferred = None
        if len(live) > 1:
            try:
                preferred = self.placement.preferred_endpoint(tm)
            except Exception:  # galaxylint: disable=swallow -- locality is advisory: a placement fault must never fail a read
                preferred = None

        def _load_weight(a, w):
            c = self.workers.get(a)
            if a == preferred:
                w = w * 4.0
            if c is None or now - getattr(c, "load_at", 0.0) > 5.0:
                return float(w)
            penalty = 1.0 + getattr(c, "load_q", 0) + 4.0 * getattr(c, "load_tier", 0)
            return float(w) / penalty

        live = [(a, _load_weight(a, w)) for a, w in live]
        pick = random.random() * sum(w for _, w in live)
        for a, w in live:
            pick -= w
            if pick <= 0:
                return a, self.workers[a]
        return live[-1][0], self.workers[live[-1][0]]

    # -- the coordinator sync plane -----------------------------------------------

    def apply_sync_action(self, action: str, payload: dict) -> dict:
        """The coordinator side of the sync bus (the twin of the worker's sync
        op): a peer's broadcasts invalidate this instance's caches."""
        payload = payload or {}
        if action == "invalidate_fragment_cache":
            key = payload.get("table_key") or \
                f"{payload.get('schema', '').lower()}.{payload.get('table', '').lower()}"
            self.frag_cache.bump_epoch(key)
            return {"ok": True, "action": action, "node": self.node_id}
        if action == "invalidate_plan_cache":
            self.planner.cache.invalidate_all()
            return {"ok": True, "action": action, "node": self.node_id}
        if action == "invalidate_privilege_cache":
            self.privileges.invalidate_cache()
            return {"ok": True, "action": action, "node": self.node_id}
        if action == "health":
            # peer coordinators answer the health pull workers answer; inbound
            # `peer_admission` gossip is ingested and the reply carries this
            # node's admission snapshot, sync epoch, groups and retrace count, and
            # on request (`want`) statement-summary, metrics and trace rollups
            mh = self.metric_history
            mh.maybe_sample()
            for node, snap in (payload.get("peer_admission") or {}).items():
                self.admission.note_peer(node, snap)
            reply = {"ok": True, "action": action, "node": self.node_id,
                     "uptime_s": round(time.time() - self.started_at, 3),
                     "active": float(len(self.sessions)),
                     "qps": round(mh.rate("queries_total"), 3),
                     "error_rate": round(mh.rate("query_errors"), 6),
                     "mem_tier": int(self.admission.governor.tier()),
                     "samples": int(mh.summary()["samples"]),
                     "burning": self.slo.burning_names(),
                     "epoch": int(self.sync_bus.epoch),
                     "admission": self.admission.cluster_snapshot(),
                     "groups": [g.strip().lower() for g in
                                str(self.config.get("COORDINATOR_GROUPS")
                                    or "").split(",") if g.strip()],
                     "retraces": int(COMPILE_STATS.get("retraces", 0))}
            want = payload.get("want") or []
            if "statement_summary" in want:
                reply["statement_summary"] = \
                    [list(r) for r in self.stmt_summary.rows()[:256]]
            if "metrics" in want:
                reply["metrics"] = [[n, k, float(v), h] for n, k, v, h
                                    in self.metrics.rows()[:512]]
            if "traces" in want:
                reply["traces"] = [rt.to_dict() for rt in
                                   self.trace_store.entries(limit=64)]
            tid = payload.get("trace_id")
            if tid is not None:
                rt = self.trace_store.get(tid)
                reply["trace"] = rt.to_dict() if rt is not None else None
            return reply
        return {"ok": False, "error": f"unknown sync action {action!r}"}

    # -- the serving tier (peer coordinators) -------------------------------------

    def attach_coordinator(self, node_id: str, peer) -> None:
        """Register a peer coordinator (`peer`: a `sync_peer()` object in process
        or a dn-wire client of the peer's sync listener): it joins this instance's
        sync bus, and the admission gossip and the CLUSTER views see it."""
        self.coordinators[node_id] = peer
        self.sync_bus.attach(peer)
        events.publish("coordinator_joined",
                       f"peer coordinator {node_id} joined the serving tier",
                       node=self.node_id, peer=node_id)

    def detach_coordinator(self, node_id: str, reason: str = "detach") -> None:
        peer = self.coordinators.pop(node_id, None)
        if peer is None:
            return
        with self.sync_bus._lock:
            if peer in self.sync_bus.workers:
                self.sync_bus.workers.remove(peer)
        self.admission.forget_peer(node_id)
        events.publish("coordinator_left",
                       f"peer coordinator {node_id} left the serving tier "
                       f"({reason})", node=self.node_id, peer=node_id,
                       reason=reason)

    def coordinator_rows(self, pull: bool = True):
        """SHOW COORDINATORS / information_schema.coordinators rows: this node,
        then every registered peer.  `pull=True` asks each peer's `health` afresh
        (an UNREACHABLE row, never an error); `pull=False` renders from the last
        gossip snapshots."""
        router = getattr(self, "router", None)
        adm = self.admission
        gossip_age = {n: age for n, _s, age in adm.peer_gossip_rows()}

        def _aff(node):
            if router is None:
                return 0, 0, 0.0
            return router.affinity_of(node)

        routed, hits, ratio = _aff(self.node_id)
        rows = [(self.node_id, "local", "OK", int(self.sync_bus.epoch),
                 round(adm.effective_limit("TP"), 1),
                 round(adm.effective_limit("AP"), 1),
                 float(len(adm._tokens["TP"])), float(len(adm._tokens["AP"])),
                 routed, round(ratio, 4), -1.0)]
        for node_id, peer in sorted(self.coordinators.items()):
            routed, hits, ratio = _aff(node_id)
            age = round(gossip_age.get(node_id, -1.0), 3)
            resp = None
            if pull:
                try:
                    resp = peer.sync_action("health", {})
                except Exception:  # galaxylint: disable=swallow -- the UNREACHABLE row below IS the failure report
                    resp = None
            else:
                snap = next((s for n, s, _a in adm.peer_gossip_rows()
                             if n == node_id), None)
                if snap is not None:
                    resp = {"ok": True, "admission": snap, "epoch": -1}
            if not (isinstance(resp, dict) and resp.get("ok")):
                rows.append((node_id, "peer", "UNREACHABLE", -1,
                             0.0, 0.0, 0.0, 0.0, routed, round(ratio, 4), age))
                continue
            snap = resp.get("admission") or {}
            tp, ap = snap.get("tp") or {}, snap.get("ap") or {}
            rows.append((resp.get("node", node_id), "peer", "OK",
                         int(resp.get("epoch", -1)),
                         float(tp.get("limit", 0.0)), float(ap.get("limit", 0.0)),
                         float(tp.get("inflight", 0)), float(ap.get("inflight", 0)),
                         routed, round(ratio, 4), age))
        return rows

    def sync_peer(self):
        """An in-process sync-bus endpoint of this instance: attached to a peer
        coordinator's `sync_bus`, that peer's broadcasts apply here."""
        inst = self

        class _Peer:
            def sync_action(self, action: str, payload: dict) -> dict:
                return inst.apply_sync_action(action, payload)

            def ping(self, timeout: float = 5.0) -> bool:
                return True

        return _Peer()

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
