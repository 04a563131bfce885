"""Typed configuration parameters.

Reference analog: `ConnectionParams` — 456 typed params with instance/schema/session
scopes funneled through `ParamManager` (SURVEY.md §5.6).  Same three-scope resolution:
session value > instance value > default.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ParamDef:
    name: str
    default: Any
    kind: type
    doc: str = ""


_REGISTRY: Dict[str, ParamDef] = {}


def _p(name: str, default: Any, doc: str = "") -> ParamDef:
    d = ParamDef(name, default, type(default), doc)
    _REGISTRY[name.upper()] = d
    return d


# --- engine -----------------------------------------------------------------
ENABLE_TPU_ENGINE = _p("ENABLE_TPU_ENGINE", True, "use device kernels for AP queries")
AP_ROW_THRESHOLD = _p("AP_ROW_THRESHOLD", 50_000,
                      "scanned-row estimate above which a query is AP workload")
BATCH_ROWS = _p("BATCH_ROWS", 1 << 20, "scan batch size (rows)")
MAX_GROUPS = _p("MAX_GROUPS", 1 << 22, "hash-agg output capacity ceiling")
JOIN_OUTPUT_FACTOR = _p("JOIN_OUTPUT_FACTOR", 2, "initial join output capacity factor")
SORT_SPILL_BYTES = _p("SORT_SPILL_BYTES", 256 << 20,
                      "ORDER BY input bytes above which sorted runs spill to disk")
JOIN_SPILL_BYTES = _p("JOIN_SPILL_BYTES", 256 << 20,
                      "join build bytes above which the grace hash spill engages")
PARALLELISM = _p("PARALLELISM", 0, "local parallel drivers (0 = auto)")
ENABLE_FRAGMENT_CACHE = _p("ENABLE_FRAGMENT_CACHE", True,
                           "cross-query fragment cache: hash-join build "
                           "reuse, deterministic subplan results, cached "
                           "runtime filters")
ENABLE_BATCH_SCHEDULER = _p("ENABLE_BATCH_SCHEDULER", True,
                            "coalesce plan-cache-identical point reads from "
                            "concurrent sessions into one vectorized batch "
                            "dispatch (server/batch_scheduler.py)")
BATCH_WINDOW_US = _p("BATCH_WINDOW_US", 0,
                     "fixed batch collection window in microseconds "
                     "(0 = adaptive 100-500us, gated on live point-query "
                     "concurrency; sequential traffic pays nothing)")
BATCH_MAX_GROUP = _p("BATCH_MAX_GROUP", 1024,
                     "max point queries coalesced per batch group "
                     "(clamped to the static key-bucket ladder cap)")

# --- plan cache / optimizer --------------------------------------------------
PLAN_CACHE = _p("PLAN_CACHE", True, "enable parameterized plan cache")
PLAN_CACHE_SIZE = _p("PLAN_CACHE_SIZE", 4096, "plan cache entries")
ENABLE_JOIN_REORDER = _p("ENABLE_JOIN_REORDER", True, "greedy join ordering")
ENABLE_PARTITION_PRUNING = _p("ENABLE_PARTITION_PRUNING", True, "")

# --- transactions -------------------------------------------------------------
TRANSACTION_POLICY = _p("TRANSACTION_POLICY", "TSO", "TSO | XA | AUTO_COMMIT")
SHARE_READ_VIEW = _p("SHARE_READ_VIEW", True, "")
GET_TSO_TIMEOUT = _p("GET_TSO_TIMEOUT", 5000, "ms")
DEADLOCK_DETECT_INTERVAL = _p("DEADLOCK_DETECT_INTERVAL", 1000, "ms")

# --- DML ----------------------------------------------------------------------
DML_BATCH_SIZE = _p("DML_BATCH_SIZE", 10_000, "insert batch size")
ENABLE_DML_BATCHING = _p(
    "ENABLE_DML_BATCHING", True,
    "coalesce plan-identical autocommit point DMLs (single-row INSERT "
    "VALUES, point UPDATE/DELETE) from concurrent sessions into one "
    "vectorized flush per partition with a shared flush-time TSO, coalesced "
    "CDC/version bumps, and per-session error isolation "
    "(server/dml_batch.py) — the write-path mirror of the read batcher")
DML_BATCH_WINDOW_US = _p(
    "DML_BATCH_WINDOW_US", 0,
    "fixed DML batch collection window in microseconds (0 = adaptive, "
    "gated on live DML concurrency like the read batcher's window; "
    "sequential write traffic pays nothing)")
ENABLE_ASYNC_APPLY = _p(
    "ENABLE_ASYNC_APPLY", True,
    "pipeline GSI maintenance and replica DML legs of BATCHED autocommit "
    "writes through the background applier (txn/async_apply.py) instead of "
    "per-statement synchronous work; a session's own subsequent reads fence "
    "on its apply watermark (read-your-writes), cross-session GSI/replica "
    "freshness is eventual within the apply lag")
APPLY_WAIT_MS = _p(
    "APPLY_WAIT_MS", 10_000,
    "max milliseconds a session's read will wait on its own async-apply "
    "watermark (read-your-writes fence) before proceeding")
ENABLE_RECYCLEBIN = _p("ENABLE_RECYCLEBIN", True,
                       "DROP TABLE parks tables for FLASHBACK ... BEFORE DROP")

# --- MPP ----------------------------------------------------------------------
ENABLE_MPP = _p("ENABLE_MPP", True, "SPMD mesh execution for AP queries")
MPP_PARALLELISM = _p("MPP_PARALLELISM", 8, "devices per query")
MPP_MIN_AP_ROWS = _p("MPP_MIN_AP_ROWS", 1 << 22, "rows before cluster MPP kicks in")

ENABLE_SKEW_EXECUTION = _p(
    "ENABLE_SKEW_EXECUTION", True,
    "skew-aware distributed execution (exec/skew.py): heavy-hitter hybrid "
    "broadcast/shuffle joins and salted aggregation on the MPP mesh; "
    "planted skew plans go inert when off (cached plans stay valid)")

# --- kernel tier / compile cache ----------------------------------------------
ENABLE_PALLAS_KERNELS = _p(
    "ENABLE_PALLAS_KERNELS", True,
    "Pallas join/agg kernel tier (kernels/pallas_join.py, pallas_agg.py): "
    "auto-selected on TPU above the stats row floor; the reference "
    "formulations remain the CPU path and correctness oracle.  Per-statement "
    "override via KERNEL(OFF|PALLAS|ON) hint; GALAXYSQL_PALLAS=0 env kills "
    "the tier process-wide")
ENABLE_COMPILE_CACHE = _p(
    "ENABLE_COMPILE_CACHE", True,
    "persistent AOT compile cache under data_dir (exec/compile_cache.py): "
    "Instance.save serializes compiled steady-state programs, a restarted "
    "coordinator replays them instead of recompiling (corruption-tolerant: "
    "a bad entry recompiles, never errors)")
COMPILE_CACHE_BYTES = _p(
    "COMPILE_CACHE_BYTES", 256 << 20,
    "on-disk byte budget for the persistent compile cache (LRU by mtime)")

# --- CCL ----------------------------------------------------------------------
CCL_MAX_CONCURRENCY = _p("CCL_MAX_CONCURRENCY", 0, "0 = unlimited")
CCL_WAIT_QUEUE_SIZE = _p("CCL_WAIT_QUEUE_SIZE", 64, "")
CCL_WAIT_TIMEOUT = _p("CCL_WAIT_TIMEOUT", 10_000, "ms")

# --- admission control / resource governance (server/admission.py) -------------
ENABLE_ADMISSION_CONTROL = _p(
    "ENABLE_ADMISSION_CONTROL", True,
    "workload-class admission gate in front of every query: adaptive (AIMD) "
    "per-class TP/AP concurrency limits, deadline-aware shedding, and "
    "memory-pressure-driven AP refusal; refusals are typed "
    "ServerOverloadError with retry-after — never a hang.  The idle fast "
    "path is lock-free (token-list reads only)")
ADMISSION_TP_LIMIT = _p(
    "ADMISSION_TP_LIMIT", 256,
    "initial concurrent-TP admission limit (AIMD adjusts between "
    "ADMISSION_MIN_LIMIT and this starting point x4)")
ADMISSION_AP_LIMIT = _p(
    "ADMISSION_AP_LIMIT", 8,
    "initial concurrent-AP admission limit (AIMD-adjusted; AP work is the "
    "load that starves TP under flood, so its limit starts low)")
ADMISSION_MIN_LIMIT = _p(
    "ADMISSION_MIN_LIMIT", 1,
    "floor for AIMD multiplicative decrease — goodput never reaches zero")
ADMISSION_TARGET_TP_MS = _p(
    "ADMISSION_TARGET_TP_MS", 100,
    "per-class latency target: TP EWMA above this drives multiplicative "
    "decrease of the TP admission limit")
ADMISSION_TARGET_AP_MS = _p(
    "ADMISSION_TARGET_AP_MS", 5_000,
    "per-class latency target for the AP admission limit (AIMD)")
ADMISSION_QUEUE_SIZE = _p(
    "ADMISSION_QUEUE_SIZE", 64,
    "bounded per-class wait queue in front of a full admission limit; "
    "overflow sheds typed (ServerOverloadError) instead of queuing unbounded")
ADMISSION_WAIT_MS = _p(
    "ADMISSION_WAIT_MS", 1_000,
    "max wait for an admission slot before the query is shed typed")
MEM_ELEVATED_PCT = _p(
    "MEM_ELEVATED_PCT", 70,
    "root-pool usage percent at which the memory governor enters ELEVATED "
    "(fragment-cache budget halves, spill thresholds drop 4x)")
MEM_CRITICAL_PCT = _p(
    "MEM_CRITICAL_PCT", 90,
    "root-pool usage percent at which the governor enters CRITICAL: new AP "
    "admissions refuse typed and the largest revocable query is revoked "
    "(spilled) rather than dying on OOM")
QUERY_MEM_BYTES = _p(
    "QUERY_MEM_BYTES", 4 << 30,
    "per-query memory-pool limit: hash-join build / agg partial / sort slab "
    "reservations charge a child pool of the global pool; exhaustion spills "
    "first and fails typed (MemoryLimitExceeded) only when spilling cannot "
    "cover it")

# --- fault tolerance ----------------------------------------------------------
MAX_EXECUTION_TIME = _p(
    "MAX_EXECUTION_TIME", 0,
    "per-query deadline in ms (0 = unlimited): checked at operator drain / "
    "fused-segment / MPP-stage boundaries, propagated in worker RPC headers; "
    "past-deadline queries die with a typed QueryTimeoutError")
RPC_MAX_RETRIES = _p(
    "RPC_MAX_RETRIES", 2,
    "extra attempts after a transport failure on retry-safe worker RPCs "
    "(reads, idempotent control ops, uid-stamped DML)")
RPC_RETRY_BACKOFF_MS = _p(
    "RPC_RETRY_BACKOFF_MS", 20,
    "base for the capped exponential retry backoff (full jitter; the first "
    "retry reconnects immediately — the worker may simply have restarted)")
BREAKER_FAILURE_THRESHOLD = _p(
    "BREAKER_FAILURE_THRESHOLD", 3,
    "consecutive transport failures before a worker's circuit breaker opens")
BREAKER_COOLDOWN_MS = _p(
    "BREAKER_COOLDOWN_MS", 1000,
    "open-state hold before the breaker half-opens (one ping probe decides "
    "closed vs re-open); while open, requests fast-fail typed")
RPC_RETRY_BUDGET = _p(
    "RPC_RETRY_BUDGET", 64,
    "per-worker retry token bucket capacity: each retry attempt takes one "
    "token; an empty bucket fails the RPC typed instead of retrying — under "
    "saturation retries must not amplify load into a metastable storm")
RPC_RETRY_REFILL_PER_S = _p(
    "RPC_RETRY_REFILL_PER_S", 8,
    "retry-budget token refill rate per second per worker endpoint")

# --- workload insight (meta/statement_summary.py) ------------------------------
ENABLE_STATEMENT_SUMMARY = _p(
    "ENABLE_STATEMENT_SUMMARY", True,
    "aggregate every finished query per statement digest x plan fingerprint "
    "into time-bucketed windows (SHOW STATEMENT SUMMARY [HISTORY]); "
    "host-side adds only — zero device syncs")
STMT_SUMMARY_WINDOW_S = _p(
    "STMT_SUMMARY_WINDOW_S", 60,
    "statement-summary time-bucket width in seconds")
STMT_SUMMARY_HISTORY = _p(
    "STMT_SUMMARY_HISTORY", 16,
    "window buckets retained per digest x plan (bounded history)")
STMT_SUMMARY_MAX_DIGESTS = _p(
    "STMT_SUMMARY_MAX_DIGESTS", 512,
    "distinct statement digests retained (least-recently-updated evicted)")
STMT_SUMMARY_PROM_TOPK = _p(
    "STMT_SUMMARY_PROM_TOPK", 5,
    "digests exported to Prometheus with a `digest` label (top-K by total "
    "time — bounded label cardinality)")
PLAN_REGRESSION_FACTOR = _p(
    "PLAN_REGRESSION_FACTOR", 1.5,
    "sentinel threshold: a digest's windowed MEDIAN latency above factor x "
    "its frozen baseline median flags a plan regression (medians, so one "
    "compile-heavy outlier can neither fake nor hide a regression)")
PLAN_REGRESSION_MIN_EXECS = _p(
    "PLAN_REGRESSION_MIN_EXECS", 5,
    "successful executions needed to freeze a digest's latency baseline "
    "(median of them), and per window before the sentinel will judge it")

# --- elastic rebalancing (ddl/rebalance.py + server/balancer.py) ---------------
ENABLE_REBALANCE = _p(
    "ENABLE_REBALANCE", True,
    "heat-driven balancer: propose + execute partition split/merge/move "
    "from observed per-partition heat (manual ALTER ... SPLIT/MERGE/MOVE "
    "PARTITION jobs run regardless)")
REBALANCE_THROTTLE_MS = _p(
    "REBALANCE_THROTTLE_MS", 20,
    "backfill pacing sleep per chunk while the memory governor reports "
    "pressure (rebalance yields to serving); 0 disables pacing")
REBALANCE_DRAIN_TIMEOUT_S = _p(
    "REBALANCE_DRAIN_TIMEOUT_S", 30.0,
    "cutover bound on waiting for open transactions that hold provisional "
    "rows in the table's store; expiry aborts the job typed (source keeps "
    "serving)")
REBALANCE_VERIFY_LAG_MS = _p(
    "REBALANCE_VERIFY_LAG_MS", 5000,
    "the ONLINE verify gate checksums source vs shadow this far in the "
    "past: binlog writes trail row visibility, so rows younger than the "
    "margin may have unapplied events on the shadow (the cutover re-checks "
    "exactly at the fence with writes drained)")
REBALANCE_SPLIT_FACTOR = _p(
    "REBALANCE_SPLIT_FACTOR", 2.0,
    "balancer: split the hottest partition when its heat exceeds factor x "
    "the table's mean partition heat")
REBALANCE_MERGE_FACTOR = _p(
    "REBALANCE_MERGE_FACTOR", 0.25,
    "balancer: merge the two coldest partitions when their combined heat "
    "is below factor x the mean")
REBALANCE_HOT_WEIGHT = _p(
    "REBALANCE_HOT_WEIGHT", 4.0,
    "rows-equivalent weight of one sketch-observed hot-key occurrence in "
    "partition heat (traffic counts more than resident bytes)")
REBALANCE_MIN_ROWS = _p(
    "REBALANCE_MIN_ROWS", 1000,
    "tables with less total heat than this never rebalance (moving tiny "
    "tables costs more than it saves)")
REBALANCE_MAX_PARTITIONS = _p(
    "REBALANCE_MAX_PARTITIONS", 64,
    "balancer stops proposing splits at this partition count")
REBALANCE_MIN_TRAFFIC_MS = _p(
    "REBALANCE_MIN_TRAFFIC_MS", 0.0,
    "statement-summary gate: tables whose digests consumed less total time "
    "are skipped by the balancer (0 = consider every table)")
REBALANCE_GROUPS = _p(
    "REBALANCE_GROUPS", "",
    "csv of placement group labels the balancer may MOVE partitions "
    "across (empty = no cross-group move proposals)")

# --- SLO plane (utils/metric_history.py + server/slo.py) -----------------------
ENABLE_METRIC_HISTORY = _p(
    "ENABLE_METRIC_HISTORY", True,
    "sample every registry counter/gauge/histogram plus admission and "
    "statement-summary class aggregates into a bounded delta-encoded ring "
    "each maintain tick; host-side reads only — zero device syncs, never "
    "on the query path (env hatch: GALAXYSQL_METRIC_HISTORY=0)")
METRIC_HISTORY_INTERVAL_S = _p(
    "METRIC_HISTORY_INTERVAL_S", 5.0,
    "seconds between history samples (the maintain loop's poll gates on "
    "this; SLO burn windows are counted in samples, so they scale with it)")
METRIC_HISTORY_SAMPLES = _p(
    "METRIC_HISTORY_SAMPLES", 360,
    "samples retained in the ring (delta-encoded; 360 x 5s = 30 min); "
    "evicted deltas fold into the base snapshot so replay stays exact")
SLO_TP_P99_MS = _p(
    "SLO_TP_P99_MS", 250.0,
    "built-in tp_latency_p99 objective: recent-window TP p99 target (ms)")
SLO_AP_P99_MS = _p(
    "SLO_AP_P99_MS", 4000.0,
    "built-in ap_latency_p99 objective: recent-window AP p99 target (ms)")
SLO_ERROR_RATIO = _p(
    "SLO_ERROR_RATIO", 0.01,
    "built-in typed_error_ratio objective: errored / executed over the "
    "burn window")
SLO_FAST_WINDOW_SAMPLES = _p(
    "SLO_FAST_WINDOW_SAMPLES", 3,
    "fast burn window in history samples (catches the page)")
SLO_SLOW_WINDOW_SAMPLES = _p(
    "SLO_SLOW_WINDOW_SAMPLES", 12,
    "slow burn window in history samples (suppresses blips: both windows "
    "must burn before an slo_burn event fires)")
SLO_BURN_FAST = _p(
    "SLO_BURN_FAST", 2.0,
    "fast-window burn-rate threshold (measured/target; >= 2x its value "
    "escalates event severity to critical)")
SLO_BURN_SLOW = _p(
    "SLO_BURN_SLOW", 1.0,
    "slow-window burn-rate threshold (measured/target)")
ANOMALY_EWMA_ALPHA = _p(
    "ANOMALY_EWMA_ALPHA", 0.3,
    "EWMA smoothing for the counter-rate anomaly detector's per-metric "
    "baseline mean and mean-absolute-deviation")
ANOMALY_SIGMA = _p(
    "ANOMALY_SIGMA", 8.0,
    "metric_anomaly fires when a counter's per-tick rate exceeds "
    "baseline mean + sigma x deviation (robust-EWMA, detection only)")
ANOMALY_MIN_RATE = _p(
    "ANOMALY_MIN_RATE", 10.0,
    "absolute floor (events/s) below which the anomaly detector never "
    "fires — quiet counters twitching from 0 to 1 are not storms")
SLO_COLUMNAR_LAG_MS = _p(
    "SLO_COLUMNAR_LAG_MS", 10_000.0,
    "built-in columnar_freshness objective: replica apply lag target (ms) "
    "over the burn window — PR 19's freshness gauge joins the burn engine")

# --- incident flight recorder (server/flight_recorder.py) ----------------------
ENABLE_FLIGHT_RECORDER = _p(
    "ENABLE_FLIGHT_RECORDER", True,
    "snapshot a correlated incident bundle (retained traces + summary rows "
    "+ metric-history window + admission/memory/heal/columnar state) when a "
    "trigger event fires (slo_burn, plan_regression, breaker_open, "
    "admission_reject storms, columnar_tail_failed, metric_anomaly); "
    "advisory — runs on the slo_tick maintenance path, never a query path")
INCIDENT_COOLDOWN_S = _p(
    "INCIDENT_COOLDOWN_S", 60.0,
    "per-episode dedupe: minimum seconds between bundles for the same "
    "trigger kind + correlation key (one bundle per burn, breaker-style)")
INCIDENT_RING = _p(
    "INCIDENT_RING", 64,
    "incident bundles retained in memory and under data_dir/incidents/ "
    "(oldest files reaped past the bound)")
INCIDENT_REJECT_STORM = _p(
    "INCIDENT_REJECT_STORM", 20,
    "admission_reject lifetime-count delta since the last recorder tick "
    "that qualifies as a shed storm (single rejects are routine backpressure)")

# --- self-healing plan management (plan/spm.py quarantine machine) -------------
ENABLE_PLAN_AUTOHEAL = _p(
    "ENABLE_PLAN_AUTOHEAL", True,
    "act on sentinel-flagged plan regressions: quarantine the digest, roll "
    "back to the frozen baseline plan (or repair drifted statistics), "
    "verify over PLAN_HEAL_VERIFY_EXECS executions, then promote / evolve / "
    "park; off = PR-9 detect-only behavior (annotate, never act)")
PLAN_HEAL_VERIFY_EXECS = _p(
    "PLAN_HEAL_VERIFY_EXECS", 5,
    "probation length: executions whose median is judged against the frozen "
    "latency baseline before a heal episode promotes or fails")
PLAN_HEAL_MAX_ROLLBACKS = _p(
    "PLAN_HEAL_MAX_ROLLBACKS", 3,
    "flap damping: heal episodes a digest may burn before it parks in "
    "HEAL_FAILED (breaker-style; ANALYZE/DDL re-arms with a fresh budget)")
PLAN_HEAL_COOLDOWN_S = _p(
    "PLAN_HEAL_COOLDOWN_S", 300,
    "flap damping: minimum seconds between heal episodes of one digest; "
    "regressions inside the window stay detect-only")

# --- serving tier (server/router.py, multi-coordinator scale-out) ------------
ENABLE_ROUTER = _p(
    "ENABLE_ROUTER", True,
    "front-router statement dispatch across peer coordinators (session + "
    "digest affinity); OFF routes everything to the local instance — the "
    "single-coordinator path never touches the router either way")
ROUTER_VNODES = _p(
    "ROUTER_VNODES", 64,
    "virtual nodes per peer on the consistent-hash ring (digest affinity); "
    "more vnodes = smoother spread, slower ring rebuilds")
ROUTER_GOSSIP_INTERVAL_S = _p(
    "ROUTER_GOSSIP_INTERVAL_S", 1.0,
    "seconds between router gossip rounds (health + admission snapshots "
    "pulled from every peer; interval-gated on the serving path)")
GOSSIP_FRESH_S = _p(
    "GOSSIP_FRESH_S", 5.0,
    "peer gossip snapshots older than this are ignored: stale admission "
    "limits must not throttle a healthy peer forever")
ENABLE_CLUSTER_ADMISSION = _p(
    "ENABLE_CLUSTER_ADMISSION", True,
    "clamp local per-class admission limits to the min of fresh peer "
    "limits (gossiped over the health sync action): a flood shed on peer "
    "A is not re-admitted by peer B")
COORDINATOR_GROUPS = _p(
    "COORDINATOR_GROUPS", "",
    "csv of placement-group labels this coordinator serves locally; the "
    "router prefers the peer co-located with a statement's dominant "
    "partition group (server/placement.py)")

# --- columnar HTAP replica (storage/columnar.py) -------------------------------
ENABLE_COLUMNAR_REPLICA = _p(
    "ENABLE_COLUMNAR_REPLICA", False,
    "route large scans to the CDC-fed columnar replica tier; override via "
    "COLUMNAR(OFF|ON) hint; GALAXYSQL_COLUMNAR=0 env kills the plane")
COLUMNAR_MIN_SCAN_ROWS = _p(
    "COLUMNAR_MIN_SCAN_ROWS", 50_000,
    "scans below this estimated/observed row count stay on the row store "
    "(TP point reads must never pay replica freshness checks)")
COLUMNAR_MAX_LAG_MS = _p(
    "COLUMNAR_MAX_LAG_MS", 10_000,
    "freshness SLA: a replica whose watermark lags further than this serves "
    "nothing — the query falls back to the row store")
COLUMNAR_COMPACT_ROWS = _p(
    "COLUMNAR_COMPACT_ROWS", 65_536,
    "delta rows that trigger compaction into an encoded base stripe")
COLUMNAR_WATERMARK_LAG_MS = _p(
    "COLUMNAR_WATERMARK_LAG_MS", 100,
    "watermark trails the TSO head by this margin: binlog writes follow "
    "commit stamping, and the margin absorbs that window (the "
    "REBALANCE_VERIFY_LAG_MS assumption)")
COLUMNAR_POLL_MS = _p(
    "COLUMNAR_POLL_MS", 50,
    "tailer poll interval; <=0 disables the background thread (tests drive "
    "tail_once() synchronously)")
COLUMNAR_CLUSTER_BY = _p(
    "COLUMNAR_CLUSTER_BY", "",
    "'table:column[,table:column]' — seed each listed table's replica "
    "globally sorted on the column so consecutive base stripes cover "
    "disjoint key ranges and zone maps prune range scans whole-stripe; "
    "empty = preserve row-store partition order")

# --- misc ---------------------------------------------------------------------
SQL_SELECT_LIMIT = _p("SQL_SELECT_LIMIT", -1, "-1 = unlimited")
SLOW_SQL_MS = _p("SLOW_SQL_MS", 1000, "slow query log threshold")
ENABLE_TRACE = _p("ENABLE_TRACE", False, "SQL TRACE recording")
ENABLE_QUERY_PROFILING = _p(
    "ENABLE_QUERY_PROFILING", False,
    "collect per-operator rows/time + segment spans into QueryProfile "
    "(forces device syncs; the default hot path pays nothing)")
ENABLE_QUERY_TRACING = _p(
    "ENABLE_QUERY_TRACING", True,
    "record a hierarchical span tree per query (operators, fused segments, "
    "MPP shards, worker fragments, compile/transfer telemetry) for "
    "SHOW TRACE / information_schema.query_spans / web /trace/<id>; "
    "collection is host-side ramp timestamps only — no device syncs, no "
    "extra dispatches; GALAXYSQL_TRACING=0 env kills it process-wide")
TRACE_SAMPLE_RATE = _p(
    "TRACE_SAMPLE_RATE", 0.01,
    "head-sampling rate for HEALTHY traces into the per-node TraceStore "
    "(per-digest 1-in-N, first occurrence always kept); slow / errored / "
    "shed traces bypass this and are always retained (tail retention). "
    "0 disables head sampling — tail retention still fires")
TRACE_STORE_BUDGET_BYTES = _p(
    "TRACE_STORE_BUDGET_BYTES", 4 << 20,
    "byte budget of the per-node retained-trace ring (TraceStore); "
    "oldest-first eviction once the estimated resident size exceeds it")
FAILPOINT_ENABLE = _p("FAILPOINT_ENABLE", False, "fail-point injection master switch")


class ConfigParams:
    """Instance-scope values + per-session overlays."""

    def __init__(self):
        self._instance: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.version = 0

    @staticmethod
    def registry() -> Dict[str, ParamDef]:
        return dict(_REGISTRY)

    def set_instance(self, name: str, value: Any):
        d = _REGISTRY.get(name.upper())
        with self._lock:
            self._instance[name.upper()] = _coerce(d, value)
            self.version += 1

    def get(self, name: str, session_overlay: Optional[Dict[str, Any]] = None) -> Any:
        key = name.upper()
        if session_overlay and key in session_overlay:
            return session_overlay[key]
        if key in self._instance:
            return self._instance[key]
        d = _REGISTRY.get(key)
        return d.default if d else None


def _coerce(d: Optional[ParamDef], value: Any) -> Any:
    if d is None:
        return value
    if d.kind is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "on", "yes")
        return bool(value)
    if d.kind is int:
        return int(value)
    return value
