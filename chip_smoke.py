#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`galaxysql_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0]

Phases, one line each on standard output:

1. the card: `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
2. build: compile the CUDA kernels from `galaxysql_tpu_torch/kernels/csrc/` with nvcc;
3. main path: load TPC-H at `--sf` (default 1), run Q1, Q3, Q5 and Q6 twice each
   through `Instance(device="cuda")` and `Session`, time the second run; every kernel
   launch counter is set to 0 just before the timed runs and read just after, and
   each kernel must have launched; then each query again WARM_REPEATS times, for the
   spread of warm times within the call.  The instance runs with `SET GLOBAL
   JOIN_SPILL_BYTES = MAIN_JOIN_SPILL_BYTES`, and so do the workers phase's
   coordinators: no phase runs a join at the default 256 MiB (the spill phase's
   grace joins run at lowered thresholds, SPILL_SQL);
4. kernels: each kernel's wrapper against its plain PyTorch version on the same CUDA
   tensors — the inputs the main path gave it, plus seeded edge cases (NULL lanes,
   duplicates, negative keys, dead rows, empty input, an overflowing round limit, a
   long collision chain, a hot probe row, leading and trailing empty probe rows, a
   pair capacity equal to the pair count or cutting a segment) —
   each kernel run CHECK_REPEATS times against one plain result, compared bit for
   bit, and timed with CUDA events;
5. kernel scaling: the two kernels redesigned for the card (`expand_offsets`,
   `hash_place`) at a large shape, bit-checked against their plain versions and timed;
6. reference: Q1, Q3 and Q6 through the port on the CPU (where every kernel call
   site takes its plain version) over the same lanes; rows must be equal.  The main
   path's Q5 (14.7 s on the CPU without statistics) is held instead to analyzed_tpch's
   Q5 on the same lanes, which the CPU twin gives there.

Then ANALYZE, all of TPC-H, TPC-DS and window functions, each phase on instances of its
own, its launch counters set to 0 just before its timed runs and read just after:

7. analyzed_tpch: `ANALYZE TABLE` on the eight TPC-H tables, then all 22 queries twice
   each (the second run timed), with each query's launches, join order and, where the
   default thresholds made it spill, its spill bytes and files; rows must equal the
   port on the CPU over the same lanes with the same statistics (the CPU twin takes
   the card's, `_take_statistics`; ANALYZED_CPU_SKIP's rows are held to numpy in
   the dml phase, before its refresh, on copies of the same lanes, and
   ANALYZED_CARD_ONLY's are not compared at SF 1); with each query's host-tier
   traffic in its timed run (`chunk.batch.HOST_TIER_STATS`, every phase of
   `run_phase`): the bytes and card ms of the aggregate finalize's pull to the host,
   of host batches returning to the card, and the Filter, Project and fused-segment
   runs on numpy (in these AP runs every host batch descends from an aggregate);
8. tpcds: `tpcds.generate(--sf * TPCDS_SF_SCALE)` loaded with `insert_pylists`, ANALYZEd (the CPU twin
   takes the card's statistics), the 10 queries twice each; rows must equal the port
   on the CPU;
9. window: window queries over `orders` and `lineitem` (every `WindowSpec` kind and
   frame, NULL partition keys, one partition spanning every row), compared with the
   port on the CPU through an outer aggregate.

Every phase runs fusion and runtime filters at their defaults (on) and, but for the
next one, its instances with ENABLE_FRAGMENT_CACHE = 0, so warm runs measure
execution and not a replay (each phase's line says `enable_fragment_cache`).  Then
the execution hub with the fragment cache on, on analyzed_tpch's instances (their
statistics keep the CPU side short) and the main path's card instance with phase 6's
CPU twin; no data is loaded:

9a. exec_hub: (a) EXEC_HUB_QUERIES (Q3, Q5, Q9, Q10, Q18, Q21) each at the defaults
    with the cache cold, again at the defaults (a replay: hits, no kernel launch),
    under RUNTIME_FILTER(OFF) FRAGMENT_CACHE(OFF) (the probe rows reaching the joins
    without filters), under NO_FUSE NO_BLOOM FRAGMENT_CACHE(OFF), and
    EXEC_HUB_FUSE_REPEATS times each under FRAGMENT_CACHE(OFF) (fused) and NO_FUSE
    FRAGMENT_CACHE(OFF) (unfused), alternated; the rows of every run must equal
    analyzed_tpch's rows of the query, which the CPU twin gave on the same lanes
    (Q18's: the dml phase holds them to numpy); per query the first, warm and off ms,
    the fused and unfused medians, fragment-cache hits, misses and bytes, filters
    built, probe rows with and without filters, and each kernel's launches.  (b) Staleness on the main
    path's pair: Q3 warm from the cache, then an autocommit INSERT into orders, the
    same INSERT shape from HUB_MEMBERS sessions batched into one `server/dml_batch.py`
    flush (sequential on the CPU twin), and `ALTER TABLE customer ADD COLUMN`: after
    each the next Q3 must miss, move where the write adds a row it reads, and equal
    the CPU twin's; every write is undone at the end.  (c) Both caches emptied, Q3,
    Q5 and Q3 again at the defaults on both: the rows must be equal, and SHOW
    FRAGMENT CACHE and information_schema.fragment_cache must list the same entries
    on both.  Launch counters are set to 0 at the phase's
    start and read at its end; all four kernels must have launched.

9b. mpp: the MPP engine (`parallel/`) on analyzed_tpch's card instance, a mesh of
    MPP_SHARDS shards on cuda:0 installed on it (one card has no mesh of its own;
    ENABLE_MPP is 0 during the phase, so the ENGINE(MPP) hint alone runs on the
    mesh), the fragment cache off but in (b), no TPC-H data loaded: (a) the 22
    queries under ENGINE(MPP), MPP_WARM_QUERIES twice (the second run timed) and the
    others once, rows equal to analyzed_tpch's (floats
    within max(|y|*1e-6, 1e-6), `tests/test_mpp.py`'s), `mpp_queries` grown by the
    distributed runs, the fallback set equal to MPP_FALLBACK_QUERIES with its
    reasons; per query first and warm ms beside the local warm ms, launches, the
    `MeshDataCache` bytes and the bytes the exchanges moved.  (b) Q3 and Q5 twice
    with the fragment cache on: the repeat replays the MPP aggregate.  (c) Q3, Q5,
    Q9 and Q18 at BROADCAST_BUILD_LIMIT = 0 (every join hash-shuffled).  (d) on an
    instance of its own, `fact_hot` (SKEW_FACT_ROWS rows, one key SKEW_HOT_SHARE of
    them), `dim` and `mid` in 8 HASH partitions, ANALYZEd, every join shuffled: a
    hybrid join with the skew on its probe side, one with it on its build side and a
    salted GROUP BY, each with its trace tag, rows bit-identical to SKEW(OFF) and to
    numpy; the probe-skewed join's rows per shard (EXPLAIN ANALYZE's stats) and ms
    with skew plans on and off, and its `HotKeys(...)` line.  (e) EXPLAIN ANALYZE of
    Q5 under MPP: node for node the local run's rows (a scan masked by a runtime
    filter counts its rows after the filter under MPP, as in the reference: its rows
    plus the filter's pruned rows), with rows per shard.  Launch counters are set to 0 at the phase's start and read at
    its end; all four kernels must have launched.

9c. workers: a second process.  (a) A card instance holding analyzed_tpch's
    WORKER_TABLES (orders, customer, supplier, nation; the same host lanes) is saved into a
    worker data dir and freed, and a port worker (`python -m
    galaxysql_tpu_torch.net.worker --device cuda --data-dir ...`, started by exec)
    boots from it on cuda:0.  (b) A card coordinator holding the other four tables
    (the same lanes and statistics) attaches the four as remote tables: Q3, Q5 and
    Q18 twice each (the second run timed), rows equal to analyzed_tpch's (floats
    within 1e-6), first and warm ms beside analyzed_tpch's local warm ms, the rows
    each remote scan shipped and the trace's remote-plan / remote-scan lines; a CPU
    coordinator attached to the same worker gives the same rows on
    WORKER_CPU_QUERIES.  (c) On the card coordinator: a transaction inserts a new
    order on the remote orders and its lineitems locally, reads its own remote row
    through the branch xid, COMMITs (two phases with one remote branch; its ms beside
    a local-only COMMIT's); a second one ROLLs BACK and leaves neither row; an
    autocommit UPDATE of a remote row.  (d) A branch brought to PREPARED, the worker
    SIGKILLed, the commit point logged, the worker restarted from its data dir and the
    tables attached again: `recover_remote` commits the branch and the row reads back
    (restart and re-attach seconds).  (e) A second worker on cuda:0 attached as
    nation's replica and backfilled; an autocommit write reaches both endpoints;
    the replica killed, reads keep serving (a failover), a write marks it stale; it is
    restarted and attached again with backfill=True, its rows then equal to the
    primary's; SHOW WORKERS.  (f) While both workers run, SHOW CLUSTER HEALTH pulls
    their `health`: each row reads OK with samples > 0; right after the replica's
    kill its row reads UNREACHABLE.  Launch counters are set to 0 before (b) and read
    at the phase's end, on the coordinator: all four kernels must have launched there
    (the workers' own launches are not visible to it).  Every worker is killed at the
    phase's end.
9d. ops: the operations plane (admission, per-query memory pools, the statement
    summary, the metric history, SLOs, the flight recorder, the web console, the
    locks), on by default in every phase, here on analyzed_tpch's card instance
    (which keeps its metadb and the recorder's bundles in a data dir of the run's).
    (a) oltp_point_select on orders from OPS_COST_SESSIONS sessions for
    OPS_COST_SECONDS, with the plane and with ENABLE_ADMISSION_CONTROL,
    ENABLE_STATEMENT_SUMMARY and ENABLE_METRIC_HISTORY at 0: QPS and p50 both ways
    (printed, not gated).  (b) Q1, Q3, Q5 and Q18 OPS_SUMMARY_RUNS times each from
    OPS_SUMMARY_SESSIONS sessions: the summary's executions and rows sent grow by
    exactly the executions and analyzed_tpch's rows, under the plan fingerprint the
    CPU twin plans for the same SQL; COMPILE_STATS and dispatches printed.  (c)
    OPS_AP_SESSIONS sessions cycling Q3, Q5, Q10 and Q18 and OPS_TP_SESSIONS point
    sessions for OPS_FLOOD_SECONDS: every outcome is analyzed_tpch's rows or a typed
    ServerOverloadError with retry_after_ms, and SHOW ADMISSION's admitted and shed
    counts equal the clients'.  (d) Under FP_MEM_PRESSURE: OPS_PRESSURE_QUERIES at
    the JOIN_SPILL_BYTES at which they do not spill (the rung above the first
    spilling one on OPS_SPILL_LADDER) spill under ELEVATED (a quarter of it), and the
    last of them under a QUERY_MEM_BYTES of half of it, rows equal (Q5 alone since a
    cut for time: Q18's three spilled runs took 17.5 s); the fragment cache's budget halves and
    restores; SHOW EVENTS lists mem_pressure; under CRITICAL an AP query is refused
    typed while a point select serves; each tier prints the pool's reserved peak
    beside the card allocator's bytes.  (e) CREATE SLO with a 1 ms AP target, then
    synthetic 5 s-spaced `slo_tick(force=True)` samples, each of which must land:
    SHOW SLO reads BURNING, the flight recorder's bundle is on disk and in SHOW
    INCIDENTS, and SHOW METRIC HISTORY's queries_total rate equals the phase's count
    of OPS_HISTORY_QUERIES point selects over the samples.  (f) WebConsole on
    127.0.0.1:0: /status, /statements, /health, /events and
    /timeseries/queries_total agree with the SHOW surfaces.  (g) GET_LOCK blocks a
    second session's GET_LOCK(name, 0) until RELEASE_LOCK or the holder's close.  All
    four kernels must launch; each is held against its plain version on the phase's
    largest input (the kernels line's `ops` entries).  The script's client loops
    retry a typed shed after its retry_after_ms (`_execute_as_client`), as a client
    does, and count it.
9e. placement: on analyzed_tpch's card instance and its CPU twin, no data loaded.
    (f) first: both device caches emptied, `/*+TDDL: FRAGMENT_CACHE(OFF)*/` Q3 traced
    on both: the operator, segment and transfer spans (names and their parents')
    must be equal, `segment_wall_ms` must grow, and the card's `device_cache_*`
    gauges must equal its cache's counts.  (a) On orders, on the card and then the
    twin: SPLIT PARTITION p1 INTO 2 (the hash table turned into a bucket map), MERGE
    PARTITIONS p1 and the new one back, MOVE PARTITION p0 TO 'g1', and a repartition
    to orders' own spec (HASH(o_orderkey), its 8 partitions: the phases after this
    one read orders as loaded, the order of rows inside a partition aside).  After
    each: the job's ms on both, its rows copied and catchup events (SHOW REBALANCE;
    the repartition keeps no progress row and copies every visible row), CHECK TABLE
    orders OK on both, FastChecker's (rows, checksum) equal on both, Q3, Q5 and Q18
    on the card equal analyzed_tpch's rows, and PLACEMENT_POINT_SELECTS point selects
    of orders keys equal their answers from before, which the twin gives too
    (at the phase's end the twin's Q3 and Q5 equal the card's; Q18 is held to
    analyzed_tpch's card rows, as there).  (b)
    With REBALANCE_GROUPS = PLACEMENT_GROUPS on both: REBALANCE TABLE orders DRY RUN,
    then applied (a MOVE into the empty group), proposals equal on both, the checks
    of (a), and SHOW REBALANCE equal to information_schema.rebalance_jobs.  (c) CHECK
    TABLE of the eight tables, OK and equal on both.  (d) A `server/router.FrontRouter`
    over the card instance and two peer coordinators on cuda:0 holding copies of
    PLACEMENT_PEER_TABLES (`_copy_instance`, the same lanes, the same statistics):
    Q1, Q3, Q5, Q18 and PLACEMENT_ROUTED_POINTS point selects through a
    `RouterSession`, rows equal to the local ones, each on its ring owner; orders'
    dominant group bound to a peer moves Q3 there; SHOW COORDINATORS; a traced routed
    Q3 whose tree holds the peer's grafted operator spans; a peer detached and its
    admission gossip forgotten.  (e) PLACEMENT_SEQ_SESSIONS sessions drawing NEXTVAL
    at once: every value unique, together 1..n.  Launch counters are set to 0 at the phase's start and read at its
    end: all four kernels must launch; each is held against its plain version on the
    phase's largest input (the kernels line's `placement` entries).

9f. formulations: the reference's accelerator branch of the relational layer
    (`kernels/relational.formulation_scope("sort")`: `sort_groupby`,
    `matmul_groupby`, the sorted hash join and the host-built bloom) on
    analyzed_tpch's card instance, no data loaded.  (a) The 22 queries under the
    scope, cold (the branch's first run) and warm, then warm on the default scatter
    branch, each timed; every run's rows equal analyzed_tpch's, and the four kernels
    launch 0 times under the scope.  (b) FORMULATION_MPP_QUERIES under ENGINE(MPP) on
    a mesh of MPP_SHARDS shards on cuda:0, twice under the scope and once on the
    scatter branch: rows equal to analyzed_tpch's, no launch under the scope outside
    a hybrid join's probe (which keeps the CSR, as in the reference).  (c) Each of
    `sort_groupby`, `matmul_groupby` and `_hash_join_pairs_sorted` on the largest
    input (a) gave it: equal to its own run on the CPU over the same inputs (integers
    and flags bit for bit, float sums within 4 * n * 2^-24 * sum(|x|)), equal to its
    scatter twin (`hash_groupby`, `scatter_groupby`, the CSR join) after a canonical
    ordering, and timed beside the twin as the kernels are.  The launches under the
    scope are the kernels line's `formulations` entries.

9g. tp_host: the reference's TP host engine (a statement gets the device cache only
    when its plan is AP and ENABLE_TPU_ENGINE holds; otherwise its scans yield host
    batches that Filter, Project and fused segments run with numpy).  (a) The C++
    host runtime (`galaxysql_tpu_torch/native`) is live.  (b) TP_HOST_STATEMENTS on
    small tables of a fresh card instance equal a fresh CPU instance's bit for bit
    (the first three gave float32 answers before the host engine), each planned TP.
    (c) `torch.profiler` with CUDA activity sees no CUDA kernel and no copy while
    TP_HOST_PROFILED runs (a host scan under Filter and Project, off the point-plan
    fast path) and some while TP_HOST_AP_CONTROL runs on the main path's instance.
    (d) TP_HOST_QUERIES (Q1, Q6) at --sf on the main path's instance with
    ENABLE_TPU_ENGINE = 1 and = 0 in its session, once and TP_HOST_WARM times each:
    the engine-off rows equal the engine-on rows (floats within 1e-6).  (e) The p50
    and p99 of TP_HOST_PROFILED over TP_HOST_P50_RUNS runs.  Its launches are the
    kernels line's `tp_host` entries.
9h. host_agg: the reference's host aggregate output (ROADMAP Queue 3 item 18).
    HOST_AGG_STATEMENTS on small tables of a fresh card instance: each aggregate's
    output pulled to the host and the HAVING or projection above it run with numpy,
    the rows equal bit for bit to a fresh CPU instance and to the reference's answers,
    held here as literals (the script imports nothing of the JAX package); the
    finalize's pull bytes and ms.

Then writes and transactions, on a card instance and a CPU instance of their own
holding copies of the main path's lanes; every statement runs on both, in the same
order, and every result must be equal (the queries before the refresh run on the card
alone; of the 22 queries after the refresh, the DML_CPU_QUERIES; Q1 and Q3 are held to
W's rows inside the refresh, which the CPU gave for the same rows, and Q18
(DML_CARD_ONLY) to W's rows on the card):

10. dml: (a) TPC-H's refresh functions in a transaction, with analyzed_tpch's
    statistics (both copies take them instead of running ANALYZE again): session W
    runs BEGIN, RF1 (SF x DML_RF_SF x 1,500 new orders and their lineitems,
    `storage/tpch_refresh.py`) as a few multi-row INSERTs and RF2 (as many orders
    and their lineitems deleted); Q1, Q3 and Q18 in W see its writes (Q18 on the
    card alone), in a second
    session R the snapshot from before (R's rows held to its rows from before the
    refresh, which the card alone gives: Q1 and Q3 equal analyzed_tpch's rows, which
    the CPU gave, and Q18 equals `q18_numpy`); COMMIT; then all 22 queries twice each (the
    second run timed), DML_CPU_QUERIES of them also on the CPU and Q1, Q3 and Q18
    held to W's rows inside the refresh.  (b) A rollback, on the card alone: an
    UPDATE of lineitem and a DELETE of orders (each with the ms of its binlog
    capture), Q4 and Q6 inside, ROLLBACK, and Q4 and Q6 equal their rows from
    before, which the CPU gave; the binlog holds nothing of it.  (c) A write conflict: W updates an order
    in a transaction, R's update of the same row raises `TransactionError`, W
    commits and R's retry succeeds.  (d) The sysbench `oltp_read_write` mix
    (`storage/sysbench.py`) on one DML_OLTP_ROWS-row table, OLTP_TRANSACTIONS
    transactions.  Launch counters are set to 0 at the phase's start and read at
    its end.

Then the TP point-query path, on card and CPU instances of their own (a 1,000,000-row
`sbtest1` in 8 partitions from `storage/sysbench.py`, the dml phase's seed, and copies
of the main path's `orders` lanes); every answer on the card must equal the CPU
instance's:

11. point: (a) POINT_STATEMENTS sysbench `oltp_point_select` statements from one
    session (the first planned, registering its PointPlan, the rest on the sequential
    fast path) and a quarter as many `select o_totalprice from orders where
    o_orderkey = %d`, with `point_plan_queries`; (b) closed loops of POINT_SESSIONS
    Python threads, one `Session` each, POINT_PER_SESSION[n] statements a session, with
    the batch scheduler on (adaptive window) and off: QPS, p50/p99 ms, the
    scheduler's counters and group sizes, every row equal to the CPU instance's
    sequential answer for its key, and at least one flush at the largest count; (c)
    `batched_point_lookup` against one `sbtest1` partition at FLUSH_KEYS keys,
    including an id with 10 versions (past `BATCH_MAXDUP`), appended tail rows and
    missing ids: its CSR identical to `_host_batched_point`'s, the whole call and the
    card's time for the device program; (d) after an UPDATE of c, a DELETE and
    re-INSERT and inside an open transaction with its own UPDATE, sequential and
    batched point selects equal on the card and the CPU.  No kernel is on this
    path: each kernel's `new_phases.launches.point` is expected to be 0.

Then the MySQL front end, on the instances already loaded (no new data): the port's
`MySQLServer` (WIRE_POOL statement threads) serves the main path's card instance and
the point phase's card `sbtest1` on loopback ports, from an asyncio loop in a thread
of this script:

12. wire: (a) Q1, Q3, Q5 and Q6 through `net.client.MiniClient` in the text protocol
    and as prepared statements, WIRE_REPEATS timed warm runs each after one untimed
    run, beside as many in-process runs on the same instance; every answer, converted
    back to Python values, must equal the in-process rows.  (b) EXPLAIN ANALYZE of
    WIRE_EXPLAIN_QUERY over the wire: its node lines and `actual rows` per node must
    equal the same statement on the CPU instance of phase 6.  (c) SHOW TABLES, DESCRIBE lineitem and
    an `information_schema.tables` query over the wire, equal to the CPU instance's.
    (d) sysbench `oltp_point_select` from WIRE_PROCESSES client processes
    (`galaxysql_tpu_torch/tools/wire_clients.py`) of WIRE_CONNECTIONS connections
    each, after an untimed ramp of WIRE_RAMP_STATEMENTS a connection and
    WIRE_SERIAL_STATEMENTS from one connection alone (batching off), WIRE_STATEMENTS
    prepared executions a connection, once after `SET GLOBAL
    ENABLE_BATCH_SCHEDULER = 1` and once after `= 0`, both sent over the wire: QPS,
    p50/p99, the scheduler's counters and group sizes; every `c` must equal the CPU
    instance's row for its id.  Launch counters are set to 0 at the phase's start and
    read at its end; all four kernels must have launched.

Then DDL, last, on the same instances (the main path's card instance and phase 6's
CPU instance, the point phase's card and CPU `sbtest1`); every statement runs on the
card's and the CPU's instance in the same order and every result must be equal:

13. ddl: (a) `ALTER TABLE orders ADD COLUMN` (an INT and a VARCHAR with defaults,
    every partition's `lane_gen` must move), an UPDATE of the new columns, a join of
    orders and lineitem grouped by them (cold after the ALTER dropped the device
    cache, then warm), `DROP COLUMN` and Q3, `RENAME TO` of nation and back; (b)
    `CREATE GLOBAL INDEX g_k ON sbtest1 (k) COVERING (c)` (timed: the backfill),
    EXPLAIN of `SELECT c FROM sbtest1 WHERE k = ?` scanning `sbtest1$g_k` on both,
    POINT_STATEMENTS / 4 such selects on the fast path, a transaction of INSERT,
    UPDATE of k and DELETE committed and one rolled back, the GSI's visible rows equal
    to sbtest1's projection on both instances, then `DROP INDEX` (the GSI's cached
    lanes must leave the device cache); (c) `CREATE VIEW` of a Q3-shaped join and
    group-by, a query on it with ORDER BY and LIMIT, `DROP VIEW`; (e) Q18 on the card
    in one thread while a second runs `ALTER TABLE lineitem ADD COLUMN l_x INT`: the
    ALTER must wait for the query's shared metadata lock, both succeed and Q18's rows
    equal its rows from before (an attempt whose ALTER did not overlap the query is
    undone with DROP COLUMN and retried, at most three in all, and the CPU twin runs
    that ADD and DROP too); (d) `DROP TABLE customer` into the recycle bin (SHOW
    RECYCLEBIN, Q3 raising the same error on both), `FLASHBACK TABLE` (Q3 equal to its
    rows from before, the store's cached lanes kept), `DROP TABLE` and `PURGE
    RECYCLEBIN` (the device-cache bytes fall by exactly the store's), a scratch
    database created, filled and dropped; (f) SHOW DDL and `information_schema.ddl_jobs`
    equal on both.  One `ddl_step` line per step with its ms.  Launch counters are
    set to 0 at the phase's start and read at its end; all four kernels must have
    launched.

Then durable state, last.  The main path's card instance has kept its metadb on disk,
in a temporary directory, since the load (the CPU twin's is in memory):

14. durable: (0) `customer`, which the ddl phase purged, is created again on both
    from its lanes as loaded.  (a) DURABLE_SESSIONS sessions commit DURABLE_TXNS
    transactions each of `UPDATE orders SET o_comment = ... WHERE o_orderkey = ...`
    on keys of their own, under `TRANSACTION_POLICY = 'TSO'` and then `'XA'`, and one
    session DURABLE_SEQUENTIAL more one after another: COMMIT p50/p99, transactions a
    second, the group-commit gate's rows a flush; every acknowledged transaction's
    tx-log row must read DONE at its commit timestamp.  (b) Left unresolved on the
    card: txn A (XA, RF1 at DURABLE_RF1_SF, stopped by FP_BEFORE_COMMIT with PREPARED
    logged), txn B (RF2 of other orders, prepared, COMMITTED logged at a fresh TSO,
    its stamps not applied) and `ALTER TABLE supplier ADD COLUMN s_flag BIGINT DEFAULT 7` stopped by
    FP_BEFORE_DDL_TASK; the CPU twin rolls A back, commits B and completes the
    ALTER.  (c) `Instance.save()`, timed, and the bytes on disk by table.  (d)
    `Instance(data_dir=...)` on the card, its boot split into the catalog, the store
    loads, `recover_persisted` (which must return A rolled back and B committed) and
    `ddl_engine.recover`; the tx log must read ABORTED for A and DONE at B's commit
    timestamp, no stamp may be negative, `ddl_jobs` must show the ALTER done and
    `node_info` the booted node.  (e) On the booted instance Q1, Q3, Q5 and Q6, first
    run (every lane shipped again) and warm, equal to the CPU twin; every write of
    (a) read back with its comment; `s_flag` 7 on both.  One `durable_step` line per
    step with its ms.  Launch counters are set to 0 at the phase's start and read at
    its end; all four kernels must have launched.  The booted instance's Q5 is not
    run on the CPU twin (7-9 s without statistics): every visible row of the
    columns Q5 reads must equal the twin's instead (`_same_visible`).  One
    session's COMMIT carries the ms of its binlog write (`flush_txn`).

Then the binlog, batched point writes and the async GSI applier, on the booted
instance B and its CPU twin and on the point phase's `sbtest1` instances:

15. cdc: (a) `g_k ON sbtest1 (k) COVERING (c)` again (the ddl phase dropped it);
    CDC_SESSIONS sessions of CDC_PER_SESSION autocommit writes each, sysbench's
    oltp_update_non_index (`SET c`), oltp_insert and oltp_delete on ids of their
    own, once with ENABLE_DML_BATCHING = 1 and once with 0 on fresh ids: QPS,
    p50/p99, members a flush, fallbacks and singletons, the applier's peak backlog
    and lag; after its last write each session reads each of its keys through
    `g_k` (EXPLAIN must scan `sbtest1$g_k`) and sees its writes; after the drain
    `g_k`'s rows equal sbtest1's, and every touched id, count(*) and sum(k) equal
    the CPU twin's (which runs the same sessions, batched).  (b) B's binlog after
    `head` (its max seq): a replica R of lineitem, orders and customer made at
    `head`; CDC_SESSIONS sessions × CDC_ORDERS_PER_SESSION batched writes on orders
    (UPDATE of o_comment, a quarter matching Q13's '%special%requests%'; INSERT of
    new orders; DELETE) and one transaction of CDC_TXN_UPDATES UPDATEs (one
    commit timestamp); SHOW BINLOG EVENTS, `cdc.events_after_seq(head)` and
    COM_BINLOG_DUMP through the port's `MySQLServer` in front of B must give the
    same events; `cdc.replay` onto R stops after half of them, then the whole
    stream applies the rest and a third call applies none; Q1, Q3 and Q13 on R
    (first run, every lane shipped, and warm) equal B's; B's rows of every touched
    key equal the CPU twin's.  One `cdc_step` line per step with its ms; launch
    counters set to 0 at the phase's start and read at its end; all four kernels
    must have launched.  (The checkpoint's drain of the applier is not run here: B
    holds no GSI; `tests/test_torch_dml_batch.py` holds it on the CPU.)  The
    directory is removed at the end of the script.

Then bulk load, disk spill and streamed scans, last, on analyzed_tpch's card instance
(kept for these two phases), the point phase's card `sbtest1` and an instance of
their own:

16. load_data: (a) the LOAD_ORDERS_ROWS orders of the lowest keys written as a
    dbgen `.tbl` file ('|' after every field) and `LOAD DATA INFILE ... INTO TABLE
    orders_l FIELDS TERMINATED BY '|'` into an empty table shaped like orders:
    orders_l must equal those orders row for row (visible rows sorted by key, strings
    decoded), and TPC-H Q13 over customer and orders_l must equal Q13 over a view of
    the same orders; (b) LOAD_SB_ROWS sysbench rows loaded into `sbtest1` while
    its covering GSI `g_k` exists: `g_k` must equal sbtest1's projection after the
    load, and LOAD_POINT_SELECTS point selects of loaded ids must read their rows on
    the fast path; (c) LOAD_TXN_ROWS rows loaded inside BEGIN ... ROLLBACK leave
    nothing behind.  No load may write a binlog event.  Each load's ms, rows a second,
    file bytes, its host split and the device-cache bytes before and after.
17. spill: (a) TPC-H queries with SORT_SPILL_BYTES / JOIN_SPILL_BYTES lowered
    (SPILL_SQL) on analyzed_tpch's instance, their rows equal to its unspilled rows
    from analyzed_tpch; together they spill a grace join of every join type the 22
    queries use and a sort (operator counters, ms spilled and unspilled, spill bytes
    and files).  (b) `li23`, a lineitem-shaped table of LI23_ROWS rows (TPC-H SF 23's
    lineitem) in 16 HASH partitions on `l_orderkey`, values from the seed on TPC-H's
    domains, loaded with `insert_arrays`, and `supplier23`: TPC-H Q6, a GROUP BY
    l_suppkey whose partials spill at the default threshold, and a join with
    supplier23, each first and warm, every scan of li23 streaming 16 batches, every
    answer equal to numpy over the generated values.  (c) `SortOp` over
    SORT_BATCH_ROWS-row card batches of the first quarter of lineitem's lanes at
    SORT_SPILL_BYTES: at least 4 sorted runs, ASC and DESC, a NULL lane, LIMIT/OFFSET,
    equal to the in-memory `SortOp` on the same batches; then a sort whose input
    raises mid-stream.  The spill
    directory must be empty after every query, the failing one included.  Launch
    counters are set to 0 at each phase's start and read at its end; all four kernels
    must have launched in each.

Then the columnar replica, last, on instances of its own: a card instance and a CPU
twin holding analyzed_tpch's lanes of the orders of the lower COLUMNAR_ORDER_SHARE of
its order keys and their lineitems, with its statistics:

18. columnar: ENABLE_COLUMNAR_REPLICA = 1, COLUMNAR_POLL_MS = 0 (the phase drives
    `tail_once`), COLUMNAR_CLUSTER_BY = 'lineitem:l_shipdate'.  (a) Both replicas
    seeded on both instances, each seed timed.  (b) TPC-H Q1, Q6, Q4 and Q12 with
    `/*+TDDL:COLUMNAR(ON)*/`, first and warm, and with COLUMNAR(OFF), first and warm,
    on the card: the routed rows must equal the row store read AS OF TSO W (W the
    replicas' watermark) on the card and the CPU twin's routed rows; Q6 must prune at
    least one lineitem stripe by its zone map.  (c) RF1 and RF2
    (`storage/tpch_refresh.py`, at COLUMNAR_RF_SF of the scale factor) on both
    instances, drained from the binlog by `tail_once` on the card (delta rows,
    compactions, the apply's ms; the first delete builds the match-key map over every
    live row) and seeded again on the CPU twin, then (b) again.  (d) Q6 AS OF TSO the
    watermark from before the refresh equals Q6's rows from before it.  (e) `lu`,
    LU_ROWS of lineitem's order keys with BIGINT UNSIGNED values above 2**63 derived
    from their suppliers, and `su`, one row a supplier: a routed GROUP BY, MIN/MAX and
    a join on the unsigned column, held to numpy and to the CPU twin.  (g) `dates`, one
    row a day from 1992-01-01 to 1998-12-31 (2,557 rows, ANALYZEd), a month of it
    joined with the lineitem replica on l_shipdate = d_date (RF_STAR_SQL), routed
    with runtime filters on and under RUNTIME_FILTER(OFF): the stripes each pruned,
    rows equal to the row store's and the CPU twin's (the line says where the rules
    planted no filter).  (f) The archive: where
    `pyarrow` imports, orders older than 1993-01-01 archived on the card and the union
    scan held to the rows from before, then RF_ARCHIVE_SQL (a month of `dates` after
    every archived order joined with orders) with filters on, which must skip
    archived files, and off, rows equal to the CPU twin's; where it does not,
    `archive_older_than` must raise the reference's NotSupportedError (a
    `columnar_archive` line says which).
    Peak device bytes.  Launch counters are set to 0 at the phase's start and read at
    its end; all four kernels must have launched.

Floats in 7-10, 9a, 13, 14, 15, 17 and 18 compare as `tests/test_tpcds.py` compares
them (relative and absolute 1e-6); every other value must be equal.  The largest input
the phases 7-9 gave each kernel, and apart from it the largest input each of the
exec_hub, mpp, workers, ops, placement, dml, ddl, durable, cdc, spill and columnar
phases gave it, are then held against the kernel's plain version CHECK_REPEATS times
and timed, beside the main path's, in the kernel's `new_phases` entry
(`exec_hub_input`, `mpp_input`, `workers_input`, `ops_input`, `placement_input`,
`dml_input`, `ddl_input`, `durable_input`, `cdc_input`, `spill_input`,
`columnar_input`).

It prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.  Any failure
exits non-zero without that line; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12       # non-tensor 32-bit rate of an H100 SXM, used for int ops
SPIN_CYCLES = 50_000_000    # ~25 ms of the card's clock: longer than enqueueing 10 calls
CHECK_REPEATS = 10          # kernel runs held against one plain result, per input
WARM_REPEATS = 7            # extra warm runs of each query after the main path
QUERIES = (1, 3, 5, 6)
# JOIN_SPILL_BYTES of the main path's instances (SET GLOBAL, so the booted instance of
# the durable phase keeps it): Q5 without statistics builds a join side of more than
# 1 GiB and grace-joins it at the default 256 MiB and at 1 GiB (13.5-16.6 s against
# 85 ms in memory on an H100), which the phases that repeat Q5 would pay some 25 times;
# 8 GiB is above the main path's peak device bytes (7.49 GB), so its joins stay in
# memory.
MAIN_JOIN_SPILL_BYTES = 8 << 30
OLTP_ROWS = 1_000_000       # rows of the sysbench table of the point phase
DML_OLTP_ROWS = 250_000     # rows of the dml phase's sysbench table (a cut for time)
OLTP_TRANSACTIONS = 10      # oltp_read_write transactions in the dml phase
POINT_STATEMENTS = 1000     # sequential oltp_point_select statements in the point phase
POINT_SESSIONS = (64, 256)  # closed-loop session counts of the point phase
# statements each session runs in a closed loop, by session count (16 and 16, then 16
# and 8, then 8 and 4, before cuts for time: with the admission plane the 256-session
# loops shed and retry, 4.9-8.7 s a loop on the H100's host)
POINT_PER_SESSION = {64: 4, 256: 2}
FLUSH_KEYS = (1, 64, 1024)  # keys of the timed batched_point_lookup calls
WIRE_REPEATS = 3            # timed runs of each TPC-H query over the wire, per protocol
WIRE_PROCESSES = 4          # oltp_point_select client processes in the wire phase
WIRE_CONNECTIONS = 16       # connections of each client process
WIRE_STATEMENTS = 20        # point selects each connection runs, per setting (40
# before a cut for time)
WIRE_RAMP_STATEMENTS = 8    # untimed point selects a connection runs before them
WIRE_SERIAL_STATEMENTS = 400  # point selects of one connection alone, batching off
WIRE_POOL = 80              # the wire server's statement threads (>= every connection)
# the query whose EXPLAIN ANALYZE the wire phase holds to the CPU: Q3 (three joins, a
# GROUP BY, ORDER BY/LIMIT), not Q5, whose CPU twin takes 12-14 s
WIRE_EXPLAIN_QUERY = 3
# the queries after the refresh that are also run on the CPU and compared: all 22
# put the script past 600 s on the card's machine, so the CPU side is cut to these
# (Q1 and Q3 are held to W's rows inside the refresh, which the CPU gave)
DML_CPU_QUERIES = (4, 5, 6, 10, 12, 21)
# queries run inside the refresh on the card alone (for time: the CPU's Q18 is
# 30-50 s); their rows after COMMIT are held to the card's rows inside it
DML_CARD_ONLY = (18,)
# analyzed_tpch queries not compared on the CPU at SF 1 (for time: Q20's CPU
# twin takes 29-38 s, Q16's and Q17's 5.9 s each, Q21's 4.8 s, Q7's 3.5 s, Q15's
# 3.3 s, Q13's 2.4 s, and, cut to make room for the tp_host phase, Q9's 2.0 s, Q8's
# 1.4 s, Q2's 1.3 s and Q10's 1.2 s); tests/test_torch_tpch.py holds them to the
# reference at SF 0.01, and the formulations phase holds their card rows on two
# formulation branches
ANALYZED_CARD_ONLY = (2, 7, 8, 9, 10, 13, 15, 16, 17, 20, 21)
# window queries not compared on the CPU at SF 1 (for time: the CPU twin's
# w_one_partition takes 7.3 s); tests/test_torch_window.py holds it to the reference
WINDOW_CARD_ONLY = ("w_one_partition",)
TPCDS_SF_SCALE = 0.25       # the tpcds phase's scale, a fraction of --sf (a cut for time)
# analyzed_tpch queries held to numpy by the dml phase instead (`q18_numpy`), before
# its refresh, on copies of the same lanes (Q18's CPU twin alone is 30-50 s)
ANALYZED_CPU_SKIP = (18,)
# analyzed_tpch's card rows the dml phase holds its own to before its refresh: Q1 and Q3
# (which analyzed_tpch held to the CPU) and ANALYZED_CPU_SKIP's
DML_HELD = (1, 3) + ANALYZED_CPU_SKIP
DML_RF_SF = 0.25            # the scale of the dml phase's RF1/RF2, a fraction of sf (a
# cut for time: SF x 1,500 orders before)
DURABLE_SESSIONS = 16       # concurrent committing sessions in the durable phase (64,
# then 32, before cuts for time)
DURABLE_TXNS = 1            # transactions each of them commits, per policy (2 before a
# cut for time)
DURABLE_SEQUENTIAL = 32     # transactions one session commits one after another
DURABLE_RF1_SF = 0.1        # the scale of txn A's RF1, a fraction of sf (a cut for time)
DURABLE_QUERIES = (1, 3, 5, 6)
CDC_SESSIONS = 16           # concurrent writing sessions in the cdc phase (64, then
# 32, before cuts for time)
CDC_PER_SESSION = 3         # sbtest1 writes each of them runs, per pass: one of each
# kind (8, then 4, before cuts for time)
# orders writes each of them runs (8 before a cut for time: with the admission plane
# the batched writes shed and retry, 512 writes took 7.4 s on the H100's host)
CDC_ORDERS_PER_SESSION = 4
CDC_TXN_UPDATES = 16        # UPDATEs of the one explicit transaction on orders
CDC_REPLICA_TABLES = ("lineitem", "orders", "customer")  # what Q1, Q3 and Q13 read
CDC_QUERIES = (1, 3, 13)
LOAD_ORDERS_ROWS = 250_000  # orders rows of the .tbl file (a sixth of SF 1, for time;
# a third before a cut)
LOAD_SB_ROWS = 100_000      # sysbench-shaped rows LOAD DATA appends to sbtest1
LOAD_POINT_SELECTS = 200    # point selects of loaded sbtest1 ids on the fast path
LOAD_TXN_ROWS = 10_000      # orders rows of the load rolled back
SPILL_BYTES = 32 << 20      # SORT_SPILL_BYTES and JOIN_SPILL_BYTES of the spill phase
# TPC-H queries the spill phase runs, by (SORT_SPILL_BYTES, JOIN_SPILL_BYTES): at
# SPILL_BYTES, Q4, Q18 and Q21 spill a semi, an inner and an anti grace join; no
# left-join build (Q13's is ~25 MB) and no sort input of the 22 queries reaches 32 MiB
# at SF 1, so Q13 runs its joins at 8 MiB (a left grace join) and Q10 its sort at
# 1 MiB (a spilled sort)
SPILL_SQL = (((SPILL_BYTES, SPILL_BYTES), (4, 18, 21)),
             ((SPILL_BYTES, 8 << 20), (13,)),
             ((1 << 20, SPILL_BYTES), (10,)))
SPILL_QUERIES = tuple(q for _b, qs in SPILL_SQL for q in qs)
# statement heads of the spill phase's queries: Q18's inner build (customer joined with
# orders) passes 32 MiB only without the runtime filters, which prune orders to the
# few hundred orders of its IN subquery
SPILL_HEADS = {18: "/*+TDDL:RUNTIME_FILTER(OFF)*/ "}
# a quarter of TPC-H SF 23's lineitem (a cut for time: SF 23 is the first whole SF past
# the default FUSE_MAX_ROWS, 2^27 rows); li23 is scanned under LI23_FUSE_MAX_ROWS
LI23_ROWS = 23 * 6_000_000 // 4
LI23_FUSE_MAX_ROWS = 1 << 25
LI23_SUPPLIERS = 23 * 10_000
LI23_PARTS = 23 * 200_000
LI23_PARTITIONS = 16
SORT_BATCH_ROWS = 1 << 18   # rows of each batch of the operator-level external sort
# the external sort's threshold: it sorts the first quarter of lineitem (a cut for
# time) in quarter batches, each past a quarter of the phase's threshold, so each is
# one sorted run: six, as all of lineitem gave in 2^20-row batches at SPILL_BYTES
SORT_SPILL_BYTES = SPILL_BYTES // 4
KERNELS = {
    "build_slots": ("galaxysql_tpu_torch/kernels/csrc/join_slots.cu",
                    "galaxysql_tpu/kernels/pallas_join.py:123"),
    "hash_slots": ("galaxysql_tpu_torch/kernels/csrc/join_slots.cu",
                   "galaxysql_tpu/kernels/pallas_join.py:129"),
    "expand_offsets": ("galaxysql_tpu_torch/kernels/csrc/expand_offsets.cu",
                       "galaxysql_tpu/kernels/pallas_join.py:161"),
    "hash_place": ("galaxysql_tpu_torch/kernels/csrc/hash_place.cu",
                   "galaxysql_tpu/kernels/pallas_agg.py:131"),
}


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T_START, 3),
                      **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- main path ------------------------------------------------------------------

def load_tpch(sf: float, device="cuda", data_dir=None):
    """TPC-H at `sf` in an instance on `device`, its metadb and checkpoints in
    `data_dir` (in memory without one)."""
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch
    data = tpch.generate(sf)
    inst = _frag_off(Instance(data_dir=data_dir, device=device))
    s = Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        inst.store("tpch", t).insert_arrays(data[t], inst.tso.next_timestamp())
    return inst, s, {t: len(next(iter(data[t].values()))) for t in tpch.TABLE_ORDER}


def _on_cuda(args) -> bool:
    """Whether the first tensor among a kernel wrapper's arguments is on the card."""
    import torch
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.is_cuda
        if isinstance(a, (tuple, list)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    return x.is_cuda
                if isinstance(x, (tuple, list)) and isinstance(x[0], torch.Tensor):
                    return x[0].is_cuda
    return False


def kernel_capture():
    """A `Capture` of the four kernel wrappers."""
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    return Capture([
        (cuda_join, "build_slots", lambda keys, live, M: keys[0][0].numel()),
        (cuda_join, "hash_slots", lambda keys, M: keys[0][0].numel()),
        (cuda_join, "expand_offsets", lambda counts, starts, cap: cap),
        (cuda_agg, "hash_place", lambda ident, live, s0, step, M, r: live.numel()),
    ])


class Capture:
    """Wraps the kernel wrappers during the main path: keeps the largest call's
    arguments per kernel (the inputs the kernel phase replays)."""

    def __init__(self, modules):
        self.calls = {}
        self.shapes = {}
        self._saved = []
        for mod, name, size_of in modules:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn, size_of))

    def _wrap(self, name, fn, size_of):
        def wrapped(*args):
            if _on_cuda(args):  # a CPU comparison's plain calls are not captured
                size = size_of(*args)
                self.shapes.setdefault(name, []).append(size)
                if name not in self.calls or size >= self.calls[name][0]:
                    self.calls[name] = (size, args)
            return fn(*args)
        return wrapped

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def run_main_path(s, capture):
    import torch
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    first, first_ms, spilled = {}, {}, {}
    for q in QUERIES:
        t0 = time.perf_counter()
        first[q] = s.execute(SQL[q]).rows
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t0) * 1000.0
    cuda_join.reset_launches()
    cuda_agg.reset_launches()
    timed, per_query, rows = {}, {}, {}
    for q in QUERIES:
        before = {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}
        spill0 = _spill_totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = s.execute(SQL[q])
        torch.cuda.synchronize()
        timed[q] = (time.perf_counter() - t0) * 1000.0
        after = {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}
        per_query[q] = {k: after[k] - before[k] for k in after}
        spill1 = _spill_totals()
        if spill1 != spill0:
            spilled[q] = {k: spill1[k] - spill0[k] for k in spill1}
        rows[q] = rs.rows
        if rs.rows != first[q]:
            raise AssertionError(f"Q{q}: second run returned other rows than the first")
    launches = {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return rows, timed, first_ms, per_query, launches, spilled


def warm_repeats(s, rows):
    """Each query WARM_REPEATS more times, the four interleaved, after the main path:
    the spread of warm times within one call, with the gen-2 garbage collections
    that fell inside each run.  Rows must equal the main path's."""
    import gc
    import torch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    times = {q: [] for q in QUERIES}
    gen2 = {q: [] for q in QUERIES}
    for _ in range(WARM_REPEATS):
        for q in QUERIES:
            g0 = gc.get_stats()[2]["collections"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = s.execute(SQL[q])
            torch.cuda.synchronize()
            times[q].append((time.perf_counter() - t0) * 1000.0)
            gen2[q].append(gc.get_stats()[2]["collections"] - g0)
            if rs.rows != rows[q]:
                raise AssertionError(f"Q{q}: a warm repeat returned other rows")
    return times, gen2


# -- kernels vs plain -----------------------------------------------------------

def _time(fn, reps: int = 10) -> float:
    """Median of `reps` single calls, each between its own CUDA events: what a caller
    waits for, including the host's enqueue work whenever the card waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, reps: int = 10) -> float:
    """The card's time for one call's device work: CUDA events around `reps` calls
    queued behind a spin of the card (`torch.cuda._sleep`), so every call is enqueued
    before the first starts and the host's work per call never leaves the card
    idle.  For a kernel wrapper that work is the kernel launch alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _same(x, y) -> bool:
    import torch
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x.shape == y.shape and x.dtype == y.dtype and bool(torch.equal(x, y))


def _max_abs_err(x, y) -> float:
    if isinstance(x, (tuple, list)):
        return max((_max_abs_err(a, b) for a, b in zip(x, y)), default=0.0)
    if x.numel() == 0:
        return 0.0
    return float((x.to(float) - y.to(float)).abs().max())


def _held(kernel, want):
    """Runs `kernel` CHECK_REPEATS times against one plain result `want`: whether every
    run is bit-identical, and the largest absolute error.  A race in a kernel (the
    grid barriers of `hash_place`) would show as a run that differs."""
    import torch
    same, err = True, 0.0
    for _ in range(CHECK_REPEATS):
        got = kernel()
        torch.cuda.synchronize()
        same = same and _same(got, want)
        err = max(err, _max_abs_err(got, want))
    return same, err


def _lane_bytes(keys) -> int:
    total = 0
    for d, v in keys:
        total += d.numel() * d.element_size()
        if v is not None:
            total += v.numel()
    return total


def edge_cases(device):
    """Seeded inputs covering NULL lanes, duplicates, negative keys, multi-lane keys,
    dead rows, empty input, an overflowing round limit, a long collision chain, a hot
    probe row, runs of empty probe rows and pair capacities that equal or cut the
    pair count."""
    import numpy as np
    import torch
    rng = np.random.default_rng(20240917)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = 100_000
    k32 = t(rng.integers(-500, 500, n).astype(np.int32))          # negative, duplicates
    k64 = t(rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64))
    v32 = t(rng.random(n) > 0.1)                                   # NULL lanes
    live = t(rng.random(n) > 0.2)                                   # dead rows
    empty32 = t(np.zeros(0, np.int32))
    empty_b = t(np.zeros(0, np.bool_))
    slot_keys = [
        ("1 lane int32 negative dup", [(k32, None)], live),
        ("2 lanes with NULLs", [(k32, v32), (k64, None)], live),
        ("3 lanes int64", [(k64, v32), (k32, None), (k64, None)], live),
        ("empty", [(empty32, None)], empty_b),
    ]
    counts = rng.integers(0, 4, n).astype(np.int64)
    counts[rng.random(n) < 0.3] = 0

    def segments(c, cap_of_total):
        # starts = exclusive prefix sum of counts, as the join's probe builds them
        offs = np.cumsum(c)
        return t(c), t(offs - c), cap_of_total(int(offs[-1]) if c.size else 0)

    hot = counts.copy()
    hot[4321] = 100_000
    lead = counts.copy()
    lead[:30_000] = 0
    trail = counts.copy()
    trail[-30_000:] = 0
    straddle = counts.copy()
    straddle[50_000] = 7
    cut = int(np.cumsum(straddle)[50_000]) - 4  # the cap cuts that segment after 3 pairs
    expand = [
        ("ragged", *segments(counts, lambda total: total + 1024)),
        ("overflow cap", *segments(counts, lambda total: total // 2)),
        ("empty", *segments(np.zeros(0, np.int64), lambda total: 1024)),
        ("hot row", *segments(hot, lambda total: total + 1024)),
        ("leading empty rows", *segments(lead, lambda total: total + 1024)),
        ("trailing empty rows", *segments(trail, lambda total: total + 1024)),
        ("total == cap", *segments(counts, lambda total: total)),
        ("segment straddles cap", *segments(straddle, lambda total: cut)),
    ]
    # a long chain: 2,000 distinct keys, 3 rows each, all on one probe walk, so round r
    # places key r only -- 2,000 rounds to place them all, 1,500 leave 500 unplaced
    chain_n = 6000
    chain = ([(t(np.arange(chain_n, dtype=np.int64) // 3), None)], t(np.ones(chain_n, np.bool_)),
             t(np.full(chain_n, 5, np.int64)), t(np.full(chain_n, 35, np.int64)), 4096)
    place = [
        ("1 lane dup", _place_inputs([(k32, None)], live), 64),
        ("2 lanes NULLs", _place_inputs([(k32, v32), (k64, None)], live), 64),
        ("overflow rounds", _place_inputs([(k64, v32)], live), 2),
        ("empty", _place_inputs([(empty32, None)], empty_b), 64),
        ("long collision chain", chain, 2048),
        ("long collision chain, overflow", chain, 1500),
    ]
    return slot_keys, expand, place


def _place_inputs(ident, live, M=None):
    """`hash_place`'s `(ident, live, s0, step, M)` for identity lanes, as the GROUP BY
    builds them; M defaults to the smallest power of two at or above twice the rows,
    the rows clamped to [16, 65,536]."""
    from galaxysql_tpu_torch.kernels.hashing import hash_columns, lsr
    from galaxysql_tpu_torch.kernels.relational import _ident_lanes
    if M is None:
        M = 1 << int(max(16, min(1 << 16, live.numel())) * 2 - 1).bit_length()
    ident = _ident_lanes(ident)
    h = hash_columns(ident)
    return ident, live, (h & (M - 1)).contiguous(), ((lsr(h, 32) << 1) | 1).contiguous(), M


def _kernel_fns(name, args):
    """One captured call of kernel `name`: (kernel call, plain call, bytes it must
    move, operations, shape, one-call library function or None)."""
    import torch
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    if name == "build_slots":
        keys, live, M = args
        n = keys[0][0].numel()
        return (lambda: cuda_join.build_slots(keys, live, M),
                lambda: cuda_join.build_slots_plain(keys, live, M),
                _lane_bytes(keys) + live.numel() + 4 * live.numel(),
                n * (24 * len(keys) + 2),
                f"n={n} live={int(live.sum())} lanes={len(keys)} M={M}", None)
    if name == "hash_slots":
        keys, M = args
        n = keys[0][0].numel()
        return (lambda: cuda_join.hash_slots(keys, M),
                lambda: cuda_join.hash_slots_plain(keys, M),
                _lane_bytes(keys) + 4 * n, n * (24 * len(keys) + 2),
                f"n={n} lanes={len(keys)} M={M}", None)
    if name == "expand_offsets":
        counts, starts, cap = args
        if not torch.equal(starts, torch.cumsum(counts, 0) - counts):
            raise AssertionError("expand_offsets: a captured call passed starts that are "
                                 "not the exclusive prefix sum of counts")
        npr = counts.numel()
        total = int(counts.sum())
        arange = torch.arange(npr, dtype=torch.int32, device=counts.device)
        # the nearest one-call library function: covers [0, total) only (no tail, no cap)
        return (lambda: cuda_join.expand_offsets(counts, starts, cap),
                lambda: cuda_join.expand_offsets_plain(counts, starts, cap),
                _expand_bytes(npr, cap), 4 * npr + 3 * cap,
                f"npr={npr} cap={cap} total={total}",
                lambda: torch.repeat_interleave(arange, counts, output_size=total))
    ident, live, s0, step, M, rounds = args
    n = live.numel()
    return (lambda: cuda_agg.hash_place(ident, live, s0, step, M, rounds),
            lambda: cuda_agg.hash_place_plain(ident, live, s0, step, M, rounds),
            _place_bytes(ident, live, M), int(live.sum()) * (12 + 4 * len(ident)) + M,
            f"n={n} live={int(live.sum())} lanes={len(ident)} M={M} max_rounds={rounds}",
            None)


def check_kernels(capture, launches, device="cuda"):
    """Every kernel against its plain version, bit for bit; times and bounds."""
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    slot_cases, expand_cases, place_cases = edge_cases(device)
    failures = []
    errs = {name: 0.0 for name in KERNELS}

    def compare(name, label, kernel, plain):
        same, err = _held(kernel, plain())
        if not same:
            failures.append(f"{name} [{label}]")
        errs[name] = max(errs[name], err)

    for label, keys, live in slot_cases:
        M = 1 << max(4, int(max(keys[0][0].shape[0], 1) * 4 - 1).bit_length())
        compare("build_slots", label, lambda: cuda_join.build_slots(keys, live, M),
                lambda: cuda_join.build_slots_plain(keys, live, M))
        compare("hash_slots", label, lambda: cuda_join.hash_slots(keys, M),
                lambda: cuda_join.hash_slots_plain(keys, M))
    for label, counts, starts, cap in expand_cases:
        compare("expand_offsets", label,
                lambda: cuda_join.expand_offsets(counts, starts, cap),
                lambda: cuda_join.expand_offsets_plain(counts, starts, cap))
    for label, (ident, live_, s0, step, M), rounds in place_cases:
        compare("hash_place", label,
                lambda: cuda_agg.hash_place(ident, live_, s0, step, M, rounds),
                lambda: cuda_agg.hash_place_plain(ident, live_, s0, step, M, rounds))
    results = []
    for name in KERNELS:
        kern, plain, nbytes, ops, shape, library = _kernel_fns(name,
                                                               capture.calls[name][1])
        compare(name, "main path input", kern, plain)
        results.append(_entry(name, launches[name], errs[name], kern, plain, nbytes, ops,
                              shape=shape, library=library))
    if failures:
        raise AssertionError(f"kernel differs from its plain version: {failures}")
    return results


def check_new_phase_inputs(capture, launches_by_phase):
    """Each kernel on the largest input the new phases gave it: held against its plain
    version CHECK_REPEATS times and timed as the main path's input is."""
    out = {}
    failures = []
    for name in KERNELS:
        if name not in capture.calls:
            raise AssertionError(f"{name}: the new phases never launched it")
        kern, plain, nbytes, ops, shape, library = _kernel_fns(name,
                                                               capture.calls[name][1])
        same, err = _held(kern, plain())
        if not same:
            failures.append(name)
        e = _entry(name, {ph: n.get(name, 0) for ph, n in launches_by_phase.items()},
                   err, kern, plain, nbytes, ops, shape=shape, library=library)
        out[name] = {k: v for k, v in e.items()
                     if k not in ("name", "route", "source", "replaces")}
    if failures:
        raise AssertionError(f"kernel differs from its plain version on the new phases' "
                             f"inputs: {failures}")
    return out


def _expand_bytes(npr, cap) -> int:
    # what the function needs under its precondition: `starts` (8 B a probe row), the
    # last row's count (the pair total) and the owner map written (4 B a slot); a
    # row's count is the next row's start minus its own
    return 8 * npr + 8 + 4 * cap


def _place_bytes(ident, live, M) -> int:
    # the live byte of every row; s0/step (16 B) and the identity lanes of the live rows
    # only, since the kernel reads nothing else of a dead row; rep (4 B a slot),
    # resolved (1 B a row) and gid (4 B a row) written
    n = live.numel()
    n_live = int(live.sum())
    return int(n + n_live * (16 + _lane_bytes(ident) / max(n, 1)) + 4 * M + n + 4 * n)


def _bound(nbytes) -> dict:
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def kernel_scaling(inst, device="cuda"):
    """The two kernels redesigned for the card at a large shape, each bit-checked
    against its plain version and timed (median of 10 CUDA-event runs): `hash_place`
    over lineitem's `l_orderkey` lane as loaded (the GROUP BY l_orderkey of TPC-H Q18),
    and `expand_offsets` with one probe row holding 2^20 pairs."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    lanes = [np.asarray(p.lanes["l_orderkey"])
             for p in inst.store("tpch", "lineitem").partitions]
    key = torch.from_numpy(np.concatenate(lanes)).to(device)
    n = key.numel()
    M, rounds = 1 << 22, 64
    ident, live, s0, step, M = _place_inputs(
        [(key, None)], torch.ones(n, dtype=torch.bool, device=device), M)
    place = lambda: cuda_agg.hash_place(ident, live, s0, step, M, rounds)  # noqa: E731
    want = cuda_agg.hash_place_plain(ident, live, s0, step, M, rounds)
    same, err = _held(place, want)
    if not same:
        raise AssertionError("hash_place differs from its plain version at the large shape")
    out = [{"name": "hash_place", "shape": f"n={n} lanes=1 M={M} max_rounds={rounds}",
            "distinct_keys": int(torch.unique(key).numel()),
            "groups": int((want[0] != n).sum()), "unresolved": int((~want[1]).sum()),
            "max_abs_err": err,
            "ms": _device_ms(place), "call_ms": _time(place),
            **_bound(_place_bytes(ident, live, M))}]

    rng = np.random.default_rng(20241017)
    npr = 1 << 24
    c = rng.integers(0, 3, npr).astype(np.int64)
    c[rng.random(npr) < 0.4] = 0
    c[npr // 3] = 1 << 20  # one hot probe row
    offs = np.cumsum(c)
    cap = int(offs[-1]) + 1024
    counts = torch.from_numpy(c).to(device)
    starts = torch.from_numpy(offs - c).to(device)
    expand = lambda: cuda_join.expand_offsets(counts, starts, cap)  # noqa: E731
    same, err = _held(expand, cuda_join.expand_offsets_plain(counts, starts, cap))
    if not same:
        raise AssertionError("expand_offsets differs from its plain version at the large "
                             "shape")
    out.append({"name": "expand_offsets", "shape": f"npr={npr} cap={cap} hot_row=2^20",
                "max_abs_err": err,
                "ms": _device_ms(expand), "call_ms": _time(expand),
                **_bound(_expand_bytes(npr, cap))})
    return out


def _entry(name, launches, err, kern, plain, nbytes, ops, shape, library=None):
    """One kernel's record: `kern`, `plain` and `library` (one PyTorch call computing
    the same function, or None) are timed here.  `ms` is the card's time for the
    kernel alone; `call_ms`, `plain_ms` and `library_ms` are whole calls."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    source, replaces = KERNELS[name]
    ms = _device_ms(kern)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "tolerance": 0.0, "ok": err == 0.0,  # bit-identical, every output
            "ms": ms, "kernel_ms": ms, "call_ms": _time(kern),
            "plain_ms": _time(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if library is None else _time(library),
            "bytes": nbytes, "shape": shape}


# -- reference: the port on the CPU ---------------------------------------------------

def cpu_reference(gpu_inst, rows_gpu):
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch, transfer
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    inst = _frag_off(Instance(device="cpu"))
    s = Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    s.execute(f"SET GLOBAL JOIN_SPILL_BYTES = {MAIN_JOIN_SPILL_BYTES}")
    s.execute(f"SET GLOBAL QUERY_MEM_BYTES = {MAIN_JOIN_SPILL_BYTES}")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        parts, dicts = transfer.arrays_of(gpu_inst.store("tpch", t))
        inst.install_store(transfer.store_from_arrays(inst.catalog.table("tpch", t),
                                                      parts, dicts))
    times = {}
    for q in QUERIES:
        if q == 5:  # held to analyzed_tpch's Q5 instead (a cut for time)
            continue
        t0 = time.perf_counter()
        rows = s.execute(SQL[q]).rows
        times[q] = (time.perf_counter() - t0) * 1000.0
        if rows != rows_gpu[q]:
            raise AssertionError(f"Q{q}: rows on the card differ from the port on the CPU:"
                                 f"\n  cuda {rows_gpu[q][:3]}\n  cpu  {rows[:3]}")
    return times, inst


# -- ANALYZE, all of TPC-H, TPC-DS, window functions ---------------------------------

def _spill_totals():
    """The process's spill counters (`utils/metrics.py`): bytes and files written."""
    from galaxysql_tpu_torch.utils import metrics
    return {"spill_bytes": metrics.SPILL_BYTES.value,
            "spill_files": metrics.SPILL_FILES.value}


def _launch_counts():
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    return {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}


def _reset_launches():
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    cuda_join.reset_launches()
    cuda_agg.reset_launches()


def _rows_match(got, want):
    """(equal, float cells compared, largest relative float difference): floats as
    `tests/test_tpcds.py` compares them, every other value exactly."""
    if len(got) != len(want):
        return False, 0, 0.0
    floats, worst = 0, 0.0
    for a, b in zip(got, want):
        if len(a) != len(b):
            return False, floats, worst
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None:
                    if not (x is None and y is None):
                        return False, floats, worst
                    continue
                floats += 1
                worst = max(worst, abs(x - y) / max(abs(y), 1e-300) if x != y else 0.0)
                if not math.isclose(float(x), float(y), rel_tol=1e-6, abs_tol=1e-6):
                    return False, floats, worst
            elif x != y:
                return False, floats, worst
    return True, floats, worst


def _copy_instance(src_inst, schema, tables, ddl, device, data_dir=None, keep=None):
    """A fresh instance on `device` holding `src_inst`'s tables of `schema` (the same
    host lanes, carried through `storage.transfer`); no plan has run on it.  Its
    metadb and checkpoints go to `data_dir` (in memory without one).  `keep` maps a
    table to (column, bound): only its rows whose lane is at most the bound."""
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import transfer
    inst = _frag_off(Instance(data_dir=data_dir, device=device))
    s = Session(inst)
    s.execute(f"CREATE DATABASE {schema}")
    s.execute(f"USE {schema}")
    for t in tables:
        s.execute(ddl[t])
        parts, dicts = transfer.arrays_of(src_inst.store(schema, t))
        if keep and t in keep:
            col, bound = keep[t]
            for p in parts:
                m = p["lanes"][col] <= bound
                p["lanes"] = {k: v[m] for k, v in p["lanes"].items()}
                p["valid"] = {k: v[m] for k, v in p["valid"].items()}
                p["begin_ts"], p["end_ts"] = p["begin_ts"][m], p["end_ts"][m]
        inst.install_store(transfer.store_from_arrays(inst.catalog.table(schema, t),
                                                      parts, dicts))
    return inst, s


def _analyze(s, tables) -> float:
    t0 = time.perf_counter()
    s.execute("ANALYZE TABLE " + ", ".join(tables))
    return (time.perf_counter() - t0) * 1000.0


def _take_statistics(src_inst, dst_inst, schema, tables) -> float:
    """What `ANALYZE TABLE` leaves on `dst_inst`'s tables, copied from `src_inst`'s,
    which hold the same lanes; returns its ms.  A cut for time: ANALYZE itself runs
    on the card in analyzed_tpch and tpcds, and gives equal statistics on equal
    lanes (tests/test_torch_tpch.py)."""
    import copy
    t0 = time.perf_counter()
    for t in tables:
        dst_inst.catalog.table(schema, t).stats = copy.deepcopy(
            src_inst.catalog.table(schema, t).stats)
    dst_inst.catalog.version += 1
    dst_inst.catalog.stats_version += 1
    return (time.perf_counter() - t0) * 1000.0


def join_order(rel) -> str:
    """The join tree of a logical plan: scans by table name, joins by kind."""
    from galaxysql_tpu_torch.plan import logical as L
    if isinstance(rel, L.Scan):
        return rel.table.name
    kids = [join_order(c) for c in rel.children]
    if isinstance(rel, L.Join):
        return f"({kids[0]} {rel.kind} {kids[1]})"
    kids = [k for k in kids if k]
    return kids[0] if len(kids) == 1 else ("[" + ", ".join(kids) + "]" if kids else "")


def run_phase(s_gpu, s_cpu, schema, queries, reset=True, cpu_queries=None, held=None,
              keep_rows=()):
    """Each query twice on the card (the second run timed, launch counters set to 0
    just before the timed runs and read just after), once on the CPU; rows compared.
    With `reset=False` neither the launch counters nor the peak memory are set back:
    they then count from the caller's own start.  `cpu_queries` names the queries
    compared on the CPU (default: all); `held` maps queries to rows they must equal
    instead, rows the CPU gave for the same data earlier.  The card's rows of the
    `keep_rows` queries come back under "rows"."""
    import torch
    from galaxysql_tpu_torch.chunk.batch import HOST_TIER_STATS
    first, timed, per_query, rows_n, plans, spilled = {}, {}, {}, {}, {}, {}
    rows, host_tier = {}, {}
    for name, sql in queries.items():
        t0 = time.perf_counter()
        rows[name] = s_gpu.execute(sql).rows
        torch.cuda.synchronize()
        first[name] = (time.perf_counter() - t0) * 1000.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
    for name, sql in queries.items():
        before = _launch_counts()
        spill0 = _spill_totals()
        tier0 = dict(HOST_TIER_STATS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = s_gpu.execute(sql)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t0) * 1000.0
        host_tier[name] = {k: HOST_TIER_STATS[k] - tier0[k] for k in tier0}
        after = _launch_counts()
        per_query[name] = {k: after[k] - before[k] for k in after}
        spill1 = _spill_totals()
        if spill1 != spill0:  # the default thresholds spilled: says where time went
            spilled[name] = {k: spill1[k] - spill0[k] for k in spill1}
        if rs.rows != rows[name]:
            raise AssertionError(f"{name}: second run returned other rows than the first")
        rows_n[name] = len(rs.rows)
    launches = _launch_counts()
    peak = int(torch.cuda.max_memory_allocated())
    cpu_ms, floats, worst = {}, 0, 0.0
    for name, sql in queries.items():
        plans[name] = join_order(s_gpu.instance.planner.plan_select(
            sql, schema, [], s_gpu).rel)
        if held and name in held:
            want = held[name]
        elif cpu_queries is not None and name not in cpu_queries:
            continue
        else:
            t0 = time.perf_counter()
            want = s_cpu.execute(sql).rows
            cpu_ms[name] = (time.perf_counter() - t0) * 1000.0
        ok, f, w = _rows_match(rows[name], want)
        if not ok:
            raise AssertionError(f"{name}: rows on the card differ from the port on the "
                                 f"CPU:\n  cuda {rows[name][:3]}\n  cpu  {want[:3]}")
        floats += f
        worst = max(worst, w)
    return {"query_ms": timed, "first_run_ms": first, "launches": launches,
            "launches_per_query": per_query, "join_order": plans,
            "peak_device_bytes": peak, "result_rows": rows_n, "cpu_ms": cpu_ms,
            "spilled_per_query": spilled, "host_tier_per_query": host_tier,
            "host_tier": {k: sum(v[k] for v in host_tier.values())
                          for k in HOST_TIER_STATS},
            "float_cells": floats, "max_float_rel_diff": worst, "equal": True,
            "rows": {name: rows[name] for name in keep_rows}}


def analyzed_tpch(inst, data_dir=None):
    """Fresh card and CPU instances over the main path's TPC-H lanes, both ANALYZEd
    before any query (so no plan baseline predates the statistics; the CPU twin takes
    the card's statistics).  The rows of the ANALYZED_CPU_SKIP queries are returned
    for the dml phase to hold to the CPU; the card's rows of the SPILL_QUERIES stay
    in the line's "rows" for the spill phase."""
    from galaxysql_tpu_torch.plan import logical as L
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi, gs = _copy_instance(inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cuda",
                            data_dir=data_dir)
    ci, cs = _copy_instance(inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cpu")
    analyze_ms = _analyze(gs, tpch.TABLE_ORDER)
    _take_statistics(gi, ci, "tpch", tpch.TABLE_ORDER)
    line = run_phase(gs, cs, "tpch", {f"Q{q}": SQL[q] for q in range(1, 23)},
                     cpu_queries={f"Q{q}" for q in range(1, 23)
                                  if q not in ANALYZED_CPU_SKIP + ANALYZED_CARD_ONLY},
                     keep_rows=[f"Q{q}" for q in range(1, 23)])
    line["analyze_ms"] = analyze_ms
    line["q5_plan_analyzed"] = L.explain(
        gi.planner.plan_select(SQL[5], "tpch", [], gs).rel).splitlines()
    held = {q: gs.execute(SQL[q]).rows for q in DML_HELD}
    return line, (gi, gs, ci, cs), held


def _lanes_of(inst, table, columns):
    """The visible rows' host lanes of `columns` over every partition of `table`."""
    import numpy as np
    from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
    parts = inst.store("tpch", table).partitions
    masks = [p.end_ts[:p.num_rows] == INFINITY_TS for p in parts]
    return {c: np.concatenate([p.lanes[c][:p.num_rows][m] for p, m in zip(parts, masks)])
            for c in columns}


def q18_numpy(inst):
    """TPC-H Q18's rows from `inst`'s host lanes in numpy (DECIMAL lanes are cents, so
    the sums are exact): the orders whose lines sum past 300 in quantity, with their
    customer, by o_totalprice descending and o_orderdate, the first 100."""
    import numpy as np
    from galaxysql_tpu_torch.types import temporal
    li = _lanes_of(inst, "lineitem", ("l_orderkey", "l_quantity"))
    od = _lanes_of(inst, "orders", ("o_orderkey", "o_custkey", "o_orderdate",
                                    "o_totalprice"))
    cu = _lanes_of(inst, "customer", ("c_custkey", "c_name"))
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    qty = np.bincount(inv, weights=li["l_quantity"]).astype(np.int64)
    big = qty > 300 * 100
    at = np.searchsorted(keys, od["o_orderkey"]).clip(0, keys.shape[0] - 1)
    sel = np.nonzero((keys[at] == od["o_orderkey"]) & big[at])[0]
    cpos = {int(k): i for i, k in enumerate(cu["c_custkey"].tolist())}
    names = inst.catalog.table("tpch", "customer").dictionaries["c_name"].values
    rows = []
    for i in sel.tolist():
        ck = int(od["o_custkey"][i])
        if ck not in cpos:
            continue
        rows.append((names[int(cu["c_name"][cpos[ck]])], ck, int(od["o_orderkey"][i]),
                     temporal.format_date(int(od["o_orderdate"][i])),
                     int(od["o_totalprice"][i]) / 100, int(qty[at[i]]) / 100))
    rows.sort(key=lambda r: (-r[4], r[3]))
    return rows[:100]


def tpcds_phase(sf):
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpcds
    t0 = time.perf_counter()
    data = tpcds.generate(sf)
    gen_ms = (time.perf_counter() - t0) * 1000.0
    gi = _frag_off(Instance(device="cuda"))
    gs = Session(gi)
    gs.execute("CREATE DATABASE tpcds")
    gs.execute("USE tpcds")
    t0 = time.perf_counter()
    for t in tpcds.TABLE_ORDER:
        gs.execute(tpcds.TPCDS_DDL[t])
        gi.store("tpcds", t).insert_pylists(data[t], gi.tso.next_timestamp())
    load_ms = (time.perf_counter() - t0) * 1000.0
    ci, cs = _copy_instance(gi, "tpcds", tpcds.TABLE_ORDER, tpcds.TPCDS_DDL, "cpu")
    analyze_ms = _analyze(gs, tpcds.TABLE_ORDER)
    _take_statistics(gi, ci, "tpcds", tpcds.TABLE_ORDER)
    line = run_phase(gs, cs, "tpcds", tpcds.QUERIES)
    line.update(sf=sf, generate_ms=gen_ms, load_ms=load_ms, analyze_ms=analyze_ms,
                rows={t: gi.store("tpcds", t).row_count() for t in tpcds.TABLE_ORDER})
    return line


# -- the execution hub: fusion, runtime filters, the fragment cache -------------------

EXEC_HUB_QUERIES = (3, 5, 9, 10, 18, 21)
EXEC_HUB_OFF = "/*+TDDL:NO_FUSE NO_BLOOM FRAGMENT_CACHE(OFF)*/ "
# the probe rows reaching the joins without runtime filters, fusion as at the defaults
EXEC_HUB_NO_RF = "/*+TDDL:RUNTIME_FILTER(OFF) FRAGMENT_CACHE(OFF)*/ "
# fused against unfused executions (runtime filters on, no replay), alternated
EXEC_HUB_FUSED = "/*+TDDL:FRAGMENT_CACHE(OFF)*/ "
EXEC_HUB_UNFUSED = "/*+TDDL:NO_FUSE FRAGMENT_CACHE(OFF)*/ "
EXEC_HUB_FUSE_REPEATS = 1
HUB_MEMBERS = 4             # sessions of the batched point-write flush of exec_hub (b)


def _frag_off(inst):
    """The settings of every instance the script makes: ENABLE_FRAGMENT_CACHE = 0
    (the phases before and beside exec_hub: their warm runs measure execution, not a
    replay of the first run), and ENABLE_PLAN_AUTOHEAL = 0, which keeps the
    statement summary's regression sentinel detect-only.  The phases run one digest
    under deliberately different conditions (a cached replay, then a real
    execution; data written between runs; the main path without statistics), which
    the sentinel reads as regressions; its heal loop would then ANALYZE the main
    path's tables (a statistics repair) or pin a rolled-back plan, and change the
    plans the later phases hold to."""
    inst.config.set_instance("ENABLE_FRAGMENT_CACHE", 0)
    inst.config.set_instance("ENABLE_PLAN_AUTOHEAL", 0)
    return inst


def _frag_state(inst):
    c = inst.frag_cache
    return c.hits, c.misses, c.bytes


def _frag_delta(inst, since):
    h, m, b = _frag_state(inst)
    return {"hits": h - since[0], "misses": m - since[1], "bytes": b}


def _hub_query(gs, q, want):
    """One query at the defaults (fragment cache cold), again at the defaults, without
    runtime filters, with every hub feature off, and EXEC_HUB_FUSE_REPEATS times each
    fused and unfused (NO_FUSE) without the cache, alternated, on the card; every run's rows
    must equal `want`: analyzed_tpch's rows of the query, which the CPU twin gave on
    the same lanes (Q18's: the dml phase holds them to the CPU).  A cut for time:
    the CPU twin runs the hub's queries at the defaults in (c) alone."""
    from galaxysql_tpu_torch.exec import runtime_filter as rf
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    sql = SQL[q]
    before, c0 = _launch_counts(), _frag_state(gi)
    rf.reset_rf_stats(enabled=True)
    first, first_ms = _timed(gs, sql)
    rf_on = dict(rf.RF_STATS)
    after = _launch_counts()
    cache_first = _frag_delta(gi, c0)
    c1 = _frag_state(gi)
    warm, warm_ms = _timed(gs, sql)
    warm_launches = sum(_launch_counts().values()) - sum(after.values())
    cache_warm = _frag_delta(gi, c1)
    rf.reset_rf_stats(enabled=True)
    no_rf, _ms = _timed(gs, EXEC_HUB_NO_RF + sql)
    rf_off = dict(rf.RF_STATS)
    rf.reset_rf_stats()
    off, off_ms = _timed(gs, EXEC_HUB_OFF + sql)
    fused_ms, unfused_ms = [], []
    for _ in range(EXEC_HUB_FUSE_REPEATS):
        fused, ms = _timed(gs, EXEC_HUB_FUSED + sql)
        fused_ms.append(ms)
        unfused, ms = _timed(gs, EXEC_HUB_UNFUSED + sql)
        unfused_ms.append(ms)
    for what, rows in (("the repeat", warm.rows), ("RUNTIME_FILTER(OFF)", no_rf.rows),
                       ("every feature off", off.rows), ("analyzed_tpch", want),
                       ("FRAGMENT_CACHE(OFF)", fused.rows), ("NO_FUSE", unfused.rows)):
        if not _rows_match(first.rows, rows)[0]:
            raise AssertionError(f"exec_hub Q{q}: rows at the defaults differ from "
                                 f"{what}:\n  defaults {first.rows[:3]}\n  other "
                                 f"{rows[:3]}")
    if cache_first["misses"] == 0 or cache_warm["hits"] == 0:
        raise AssertionError(f"exec_hub Q{q}: no miss on the cold run or no hit on the "
                             f"repeat: {cache_first} {cache_warm}")
    return {"first_ms": first_ms, "warm_ms": warm_ms, "off_ms": off_ms,
            "fused_ms": statistics.median(fused_ms),
            "unfused_ms": statistics.median(unfused_ms),
            "fused_runs_ms": fused_ms, "unfused_runs_ms": unfused_ms,
            "rows": len(first.rows), "frag_first": cache_first, "frag_warm": cache_warm,
            "filters_built": rf_on["filters_built"],
            "probe_rows": rf_on["probe_rows"], "probe_rows_off": rf_off["probe_rows"],
            "probe_rows_pruned": rf_off["probe_rows"] - rf_on["probe_rows"],
            "launches": {k: after[k] - before[k] for k in after},
            "warm_launches": warm_launches,
            "trace": [t for t in gs.last_trace if t.startswith(("frag", "rf-", "fuse"))]}


def _hub_staleness(s_gpu, s_cpu, out):
    """Q3 warm from the fragment cache, then a write or DDL on one of its tables on
    both instances: the next Q3 must miss and return the CPU twin's rows, moved by the
    write where it adds a row Q3 reads.  (1) an autocommit INSERT into orders, (2) the
    same shape through batched point writes (one `server/dml_batch.py` flush of
    HUB_MEMBERS sessions on the card, sequential on the CPU), (3) `ALTER TABLE
    customer ADD COLUMN` (customer is a build side of Q3).  Every write is undone at
    the end on both, and Q3 is back to its rows from before."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = s_gpu.instance
    q3 = SQL[3]
    cust = s_gpu.execute("SELECT min(c_custkey) FROM customer "
                         "WHERE c_mktsegment = 'BUILDING'").rows[0][0]
    base = s_gpu.execute("SELECT max(o_orderkey) FROM orders").rows[0][0] + 1000
    keys = [base + i for i in range(1 + HUB_MEMBERS)]

    def order(k, i):
        return (f"INSERT INTO orders VALUES ({k}, {cust}, 'O', {1000 + i}.25, "
                f"'1995-03-0{1 + i % 9}', '1-URGENT', 'Clerk#000000001', 0, 'hub')")
    # lineitems of the new orders first: Q3 reads none of them until their order lands
    items = ", ".join(f"({k}, 1, 1, 1, 1.00, {900000 + 1000 * i}.00, 0.00, 0.00, 'N', "
                      f"'O', '1995-03-20', '1995-03-20', '1995-03-21', 'NONE', 'MAIL', "
                      f"'hub')" for i, k in enumerate(keys))
    _both(s_gpu, s_cpu, f"INSERT INTO lineitem VALUES {items}", "exec_hub lineitems")
    original = _both(s_gpu, s_cpu, q3, "exec_hub Q3 before")[0].rows
    s_gpu.execute(q3)  # warm

    def step(name, write):
        c0 = _frag_state(gi)
        s_gpu.execute(q3)
        warm = _frag_delta(gi, c0)
        t0 = time.perf_counter()
        write()
        write_ms = (time.perf_counter() - t0) * 1000.0
        c1 = _frag_state(gi)
        got, ms = _both(s_gpu, s_cpu, q3, f"exec_hub Q3 after {name}")
        cache = _frag_delta(gi, c1)
        if warm["hits"] == 0 or cache["misses"] == 0 or \
                any("frag-subplan hit" in t for t in s_gpu.last_trace):
            raise AssertionError(f"exec_hub {name}: Q3 not warm before ({warm}) or "
                                 f"replayed after ({cache})")
        out[name] = {"write_ms": write_ms, "q3_ms": ms, "frag_before": warm,
                     "frag_after": cache, "moved": got.rows != original}
        say("exec_hub_step", step=name, **out[name])
        return got.rows

    step("insert", lambda: _both(s_gpu, s_cpu, order(keys[0], 0), "exec_hub insert"))
    flushes = gi.dml_batch_scheduler.counts.get("dml_batch_flushes", 0)

    def batched():
        gi.config.set_instance("DML_BATCH_WINDOW_US", 10_000_000)
        gi.config.set_instance("BATCH_MAX_GROUP", HUB_MEMBERS)
        try:
            _storm(gi, "tpch", [[order(k, i + 1)] for i, k in enumerate(keys[1:])])
        finally:
            gi.config.set_instance("DML_BATCH_WINDOW_US", 0)
            gi.config.set_instance("BATCH_MAX_GROUP", 1024)
        for i, k in enumerate(keys[1:]):
            s_cpu.execute(order(k, i + 1))
    step("batched_insert", batched)
    out["batched_insert"]["flushes"] = \
        gi.dml_batch_scheduler.counts.get("dml_batch_flushes", 0) - flushes
    if out["batched_insert"]["flushes"] < 1:
        raise AssertionError("exec_hub: the batched inserts did not flush as a group")
    step("alter", lambda: _both(s_gpu, s_cpu, "ALTER TABLE customer ADD COLUMN "
                                "c_hub INT DEFAULT 7", "exec_hub alter"))
    if not (out["insert"]["moved"] and out["batched_insert"]["moved"]):
        raise AssertionError("exec_hub: an inserted order did not reach Q3")
    inlist = ", ".join(str(k) for k in keys)
    for sql in (f"DELETE FROM orders WHERE o_orderkey IN ({inlist})",
                f"DELETE FROM lineitem WHERE l_orderkey IN ({inlist})",
                "ALTER TABLE customer DROP COLUMN c_hub"):
        _both(s_gpu, s_cpu, sql, "exec_hub undo")
    if _both(s_gpu, s_cpu, q3, "exec_hub Q3 undone")[0].rows != original:
        raise AssertionError("exec_hub: Q3 after the undo differs from before")


def _hub_cache_surfaces(gs, cs):
    """Both caches emptied, Q3, Q5 and Q3 again at the defaults on both instances: the
    rows must be equal, and SHOW FRAGMENT CACHE and information_schema.fragment_cache
    must list the same entry kinds over the same tables, with the same hits."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    out = {"cpu_ms": {}}
    for s in (gs, cs):
        s.instance.frag_cache.clear()
    for i, q in enumerate((3, 5, 3)):
        got = gs.execute(SQL[q]).rows
        t0 = time.perf_counter()
        want = cs.execute(SQL[q]).rows
        out["cpu_ms"][f"Q{q}" + ("_repeat" if i == 2 else "")] = \
            (time.perf_counter() - t0) * 1000.0
        if not _rows_match(got, want)[0]:
            raise AssertionError(f"exec_hub Q{q}: the card and the CPU twin differ at "
                                 f"the defaults:\n  cuda {got[:3]}\n  cpu  {want[:3]}")
    show = [[(k, t, h) for k, t, _r, _b, h in s.execute("SHOW FRAGMENT CACHE").rows]
            for s in (gs, cs)]
    info = [sorted(s.execute("SELECT entry_kind, tables, hits FROM "
                             "information_schema.fragment_cache").rows)
            for s in (gs, cs)]
    if show[0] != show[1] or info[0] != info[1] or not show[0]:
        raise AssertionError(f"exec_hub: fragment cache entries differ:\n  cuda "
                             f"{show[0][:4]}\n  cpu  {show[1][:4]}")
    out["entries"] = len(show[0])
    out["kinds"] = sorted({k for k, _t, _h in show[0]})
    out["card_bytes"] = gs.instance.frag_cache.bytes
    out["cpu_bytes"] = cs.instance.frag_cache.bytes
    return out


def exec_hub_phase(gs, cs, analyzed_rows, s_main, s_main_cpu):
    """The reference's default single-device execution on the card: fusion, runtime
    filters and the fragment cache at their defaults, on analyzed_tpch's instances
    (the fragment cache turned on for the phase) and, for the staleness steps, the
    main path's card instance and phase 6's CPU twin."""
    import torch
    t_phase = time.perf_counter()
    pairs = ((gs, cs), (s_main, s_main_cpu))
    for a, b in pairs:
        for s in (a, b):
            s.instance.config.set_instance("ENABLE_FRAGMENT_CACHE", 1)
            s.instance.frag_cache.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = {"queries": {}}
    try:
        for q in EXEC_HUB_QUERIES:
            out["queries"][f"Q{q}"] = line = _hub_query(gs, q, analyzed_rows[q])
            say("exec_hub_query", query=f"Q{q}",
                **{k: v for k, v in line.items() if k != "trace"})
        out["staleness"] = {}
        _hub_staleness(s_main, s_main_cpu, out["staleness"])
        out["surfaces"] = _hub_cache_surfaces(gs, cs)
    finally:
        for a, b in pairs:
            for s in (a, b):
                _frag_off(s.instance)
                s.instance.frag_cache.clear()
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in exec_hub: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- MPP: the mesh, the exchange plane, skew-aware execution -------------------------

MPP_SHARDS = 8              # shards of the phase's mesh, all on cuda:0
MPP_HINT = "/*+TDDL: ENGINE(MPP)*/ "
# TPC-H queries the MPP engine refuses at SF 1, each with the start of its
# `mpp-fallback` reason (the reference's NotSupportedError message): supplier x
# revenue0 is a plain cross product of 2,048 x 10,000 cells a shard, past the
# reference's 2^22 guard (tests/test_torch_mpp.py holds the guard's fallback to the
# reference's; at SF 0.01 no query falls back)
MPP_FALLBACK_QUERIES = {15: "MPP cross product too large"}
MPP_CACHE_QUERIES = (3, 5)                # (b) the fragment cache replays MPP artifacts
# (a) the queries run a second, timed time under MPP; the others run once (cuts for
# time: the second pass of all 21 distributed queries took 2.8-3.2 s, and Q9, Q16 and
# Q21 were in it before a later cut)
MPP_WARM_QUERIES = (1, 3, 5, 18)
MPP_SHUFFLE_QUERIES = (3, 5, 9, 18)       # (c) at BROADCAST_BUILD_LIMIT = 0
# `tests/test_mpp.py`'s: True = the result is ordered (compared in order)
MPP_ORDERED = {6: False, 14: False, 17: False, 19: False}
SKEW_FACT_ROWS = 1 << 22    # (d) fact_hot (2^24, then 2^23, before cuts for time)
SKEW_KEYS = 100_000         # fact_hot's key domain; dim holds one row a key
SKEW_HOT_SHARE = 0.35       # the one hot key's share of fact_hot
# mid: one row a key over [0, SKEW_MID_ROWS); at a quarter of fact_hot's rows the
# engine keeps fact_hot as the join's build side, the reference's skewed-build shape
# (test_skew.py's mid is 16,384 rows beside 57,344: above a quarter too)
SKEW_MID_ROWS = SKEW_FACT_ROWS // 4
SKEW_SQL = {
    "hybrid_probe": ("SELECT d.attr, COUNT(*), SUM(f.v) FROM fact_hot f, dim d "
                     "WHERE f.k = d.k GROUP BY d.attr"),
    "hybrid_build": "SELECT COUNT(*), SUM(m.w) FROM mid m, fact_hot f WHERE m.k = f.k",
    "salted_agg": "SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) FROM fact_hot GROUP BY k",
}


def _mpp_rows_equal(got, want, ordered=True) -> bool:
    """`tests/test_mpp.py:assert_same`: floats within max(|y|*1e-6, 1e-6), every other
    value equal; unordered results compared sorted."""
    if not ordered:
        got = sorted(got, key=lambda r: tuple(str(x) for x in r))
        want = sorted(want, key=lambda r: tuple(str(x) for x in r))
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                if abs(x - y) > max(abs(y) * 1e-6, 1e-6):
                    return False
            elif x != y:
                return False
    return True


def _fallback_reason(s):
    got = [t[len("mpp-fallback "):] for t in s.last_trace if t.startswith("mpp-fallback")]
    return got[0] if got else None


def _mpp_tpch(gs, analyzed_rows, local_ms, sf):
    """(a) the 22 queries twice each under ENGINE(MPP), held to analyzed_tpch's rows;
    the fallback set held to MPP_FALLBACK_QUERIES at SF 1."""
    from galaxysql_tpu_torch.parallel import exchange
    from galaxysql_tpu_torch.parallel.mesh import GLOBAL_MESH_CACHE
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    out, rows, fallbacks = {}, {}, {}
    mpp0 = gi.counters["mpp_queries"]
    for q in range(1, 23):
        sql = MPP_HINT + SQL[q]
        before, x0 = _launch_counts(), exchange.EXCHANGE_STATS["bytes"]
        first, first_ms = _timed(gs, sql)
        reason = _fallback_reason(gs)
        warm, warm_ms = first, None
        if q in MPP_WARM_QUERIES:
            before, x0 = _launch_counts(), exchange.EXCHANGE_STATS["bytes"]
            warm, warm_ms = _timed(gs, sql)
        after = _launch_counts()
        if reason is not None:
            fallbacks[q] = reason
        for what, got in (("first", first.rows), ("warm", warm.rows)):
            if not _mpp_rows_equal(got, analyzed_rows[q], MPP_ORDERED.get(q, True)):
                raise AssertionError(f"mpp Q{q} ({what} run): rows differ from "
                                     f"analyzed_tpch's:\n  mpp   {got[:3]}\n  local "
                                     f"{analyzed_rows[q][:3]}")
        rows[q] = warm.rows
        out[f"Q{q}"] = line = {
            "first_ms": first_ms, "warm_ms": warm_ms,
            "local_warm_ms": local_ms.get(f"Q{q}"), "fallback": reason,
            "launches": {k: after[k] - before[k] for k in after},
            "mesh_cache_bytes": GLOBAL_MESH_CACHE.nbytes,
            "exchange_bytes": exchange.EXCHANGE_STATS["bytes"] - x0,
            "rows": len(warm.rows)}
        say("mpp_query", query=f"Q{q}", **line)
    ran = sum(2 if q in MPP_WARM_QUERIES else 1 for q in range(1, 23)
              if q not in fallbacks)
    if gi.counters["mpp_queries"] - mpp0 != ran:
        raise AssertionError(f"mpp: mpp_queries grew by "
                             f"{gi.counters['mpp_queries'] - mpp0}, {ran} expected")
    if sf == 1.0:
        want = MPP_FALLBACK_QUERIES
        if sorted(fallbacks) != sorted(want) or any(
                not fallbacks[q].startswith(want[q]) for q in want):
            raise AssertionError(f"mpp: fallbacks {fallbacks}, expected {want}")
    return out, rows, fallbacks


def _mpp_cache(gs, rows):
    """(b) the fragment cache on: the repeat replays the MPP aggregate."""
    gi = gs.instance
    gi.config.set_instance("ENABLE_FRAGMENT_CACHE", 1)
    gi.frag_cache.clear()
    out = {}
    try:
        from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
        for q in MPP_CACHE_QUERIES:
            c0 = _frag_state(gi)
            first, first_ms = _timed(gs, MPP_HINT + SQL[q])
            replay, replay_ms = _timed(gs, MPP_HINT + SQL[q])
            hits = [t for t in gs.last_trace if t.startswith("frag-cache mpp")]
            if not hits:
                raise AssertionError(f"mpp Q{q}: the repeat replayed no MPP artifact: "
                                     f"{gs.last_trace}")
            for got in (first.rows, replay.rows):
                if not _mpp_rows_equal(got, rows[q]):
                    raise AssertionError(f"mpp Q{q}: rows with the fragment cache on "
                                         f"differ from (a)'s")
            out[f"Q{q}"] = {"first_ms": first_ms, "replay_ms": replay_ms,
                            "frag": _frag_delta(gi, c0), "trace": hits}
    finally:
        _frag_off(gi)
        gi.frag_cache.clear()
    return out


def _mpp_shuffle(gs, rows):
    """(c) every join hash-shuffled (BROADCAST_BUILD_LIMIT = 0)."""
    from galaxysql_tpu_torch.parallel import exchange
    from galaxysql_tpu_torch.parallel import mpp as M
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    old, M.BROADCAST_BUILD_LIMIT = M.BROADCAST_BUILD_LIMIT, 0
    out = {}
    try:
        for q in MPP_SHUFFLE_QUERIES:
            x0 = exchange.EXCHANGE_STATS["repartitions"]
            rs, ms = _timed(gs, MPP_HINT + SQL[q])
            if _fallback_reason(gs) is not None or \
                    not _mpp_rows_equal(rs.rows, rows[q], MPP_ORDERED.get(q, True)):
                raise AssertionError(f"mpp Q{q} shuffled: fell back or rows differ "
                                     f"from (a)'s: {gs.last_trace}")
            out[f"Q{q}"] = {"ms": ms,
                            "repartitions": exchange.EXCHANGE_STATS["repartitions"] - x0}
    finally:
        M.BROADCAST_BUILD_LIMIT = old
    return out


def skew_data(seed=20241017):
    """(d)'s tables as numpy arrays: fact_hot (one key SKEW_HOT_SHARE of the rows, the
    rest uniform over SKEW_KEYS keys), dim and mid."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = SKEW_FACT_ROWS
    k = rng.integers(0, SKEW_KEYS - 1, size=n, dtype=np.int64)
    k = np.where(k >= 5, k + 1, k)          # uniform over every key but 5
    k[rng.random(n) < SKEW_HOT_SHARE] = 5    # the hot key
    keys = np.arange(SKEW_KEYS, dtype=np.int64)
    return {
        "fact_hot": {"id": np.arange(n, dtype=np.int64), "k": k,
                     "v": rng.integers(0, 1000, size=n, dtype=np.int64)},
        "dim": {"did": (keys * 7919) % (1 << 30), "k": keys, "attr": keys % 7},
        "mid": {"mid": np.arange(SKEW_MID_ROWS, dtype=np.int64),
                "k": np.arange(SKEW_MID_ROWS, dtype=np.int64),
                "w": np.arange(SKEW_MID_ROWS, dtype=np.int64) % 13}}


def _skew_numpy(data):
    """numpy's answers to SKEW_SQL on the same lanes, as sorted rows."""
    import numpy as np
    k, v = data["fact_hot"]["k"], data["fact_hot"]["v"]
    attr = k % 7
    cnt = np.bincount(attr, minlength=7)
    tot = np.bincount(attr, weights=v.astype(np.float64), minlength=7)
    probe = sorted((a, int(cnt[a]), int(tot[a])) for a in range(7) if cnt[a])
    build = [(int(k.shape[0]), int((k % 13).sum()))]   # every fact key is a mid key
    order = np.argsort(k, kind="stable")
    ks, vs = k[order], v[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(ks)) + 1])
    ends = np.concatenate([starts[1:], [ks.shape[0]]])
    salted = list(zip(ks[starts].tolist(), (ends - starts).tolist(),
                      np.add.reduceat(vs, starts).tolist(),
                      np.minimum.reduceat(vs, starts).tolist(),
                      np.maximum.reduceat(vs, starts).tolist()))
    return {"hybrid_probe": probe, "hybrid_build": build, "salted_agg": salted}


def _shard_balance(op_stats, operator):
    """(max/mean live rows per shard, rows per shard) of the first MPP stage of
    `operator` in EXPLAIN ANALYZE's stats."""
    for st in op_stats:
        if st.get("operator") == operator and st.get("rows_per_shard"):
            per = st["rows_per_shard"]
            mean = sum(per) / len(per)
            return (max(per) / mean if mean else None), per
    return None, None


def _mpp_skew(mesh):
    """(d) hybrid joins and the salted aggregation at SKEW_FACT_ROWS rows, on an
    instance of their own."""
    import torch
    from galaxysql_tpu_torch.parallel import mpp as M
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    t0 = time.perf_counter()
    data = skew_data()
    si = _frag_off(Instance(device="cuda"))
    si._mesh = mesh
    ss = Session(si)
    ss.execute("CREATE DATABASE sk")
    ss.execute("USE sk")
    ddl = {"fact_hot": "(id BIGINT PRIMARY KEY, k BIGINT, v BIGINT) "
                       "PARTITION BY HASH(id) PARTITIONS 8",
           "dim": "(did BIGINT PRIMARY KEY, k BIGINT, attr BIGINT) "
                  "PARTITION BY HASH(did) PARTITIONS 8",
           "mid": "(mid BIGINT PRIMARY KEY, k BIGINT, w BIGINT) "
                  "PARTITION BY HASH(mid) PARTITIONS 8"}
    for t, cols in ddl.items():
        ss.execute(f"CREATE TABLE {t} {cols}")
        si.store("sk", t).insert_arrays(data[t], si.tso.next_timestamp())
    load_ms = (time.perf_counter() - t0) * 1000.0
    analyze_ms = _analyze(ss, list(ddl))
    want = _skew_numpy(data)
    del data
    old, M.BROADCAST_BUILD_LIMIT = M.BROADCAST_BUILD_LIMIT, 0  # the shuffle shape
    out = {"load_ms": load_ms, "analyze_ms": analyze_ms, "queries": {}}
    try:
        for name, sql in SKEW_SQL.items():
            first, first_ms = _timed(ss, MPP_HINT + sql)
            on, on_ms = _timed(ss, MPP_HINT + sql)
            trace = [t for t in ss.last_trace if t.startswith(("mpp-hybrid", "mpp-salted"))]
            off, off_ms = _timed(ss, "/*+TDDL: ENGINE(MPP) SKEW(OFF)*/ " + sql)
            off_trace = [t for t in ss.last_trace
                         if t.startswith(("mpp-hybrid", "mpp-salted"))]
            tag = "mpp-salted-agg factor=" if name == "salted_agg" else "mpp-hybrid-join"
            if not any(t.startswith(tag) for t in trace) or off_trace:
                raise AssertionError(f"mpp skew {name}: trace {trace}, SKEW(OFF) trace "
                                     f"{off_trace}")
            if name == "hybrid_build" and not any("skew=build" in t for t in trace):
                raise AssertionError(f"mpp skew {name}: not the build orientation: {trace}")
            got, got_off = sorted(on.rows), sorted(off.rows)
            if got != got_off or sorted(first.rows) != got or got != want[name]:
                raise AssertionError(f"mpp skew {name}: rows differ: on {got[:3]} off "
                                     f"{got_off[:3]} numpy {want[name][:3]}")
            line = {"first_ms": first_ms, "on_ms": on_ms, "off_ms": off_ms,
                    "rows": len(got), "trace": trace}
            if name == "hybrid_probe":
                for mode, hint in (("on", "ENGINE(MPP)"), ("off", "ENGINE(MPP) SKEW(OFF)")):
                    rs = ss.execute(f"EXPLAIN ANALYZE /*+TDDL: {hint}*/ {sql}")
                    lines = [r[0] for r in rs.rows]
                    ratio, per = _shard_balance(ss.last_op_stats, "Join")
                    line[f"join_rows_per_shard_{mode}"] = per
                    line[f"join_max_over_mean_{mode}"] = ratio
                    if mode == "on":
                        line["hotkeys_line"] = [x.strip() for x in lines
                                                if x.strip().startswith("HotKeys(")]
                        if not line["hotkeys_line"]:
                            raise AssertionError("mpp skew: EXPLAIN ANALYZE of the hybrid "
                                                 "join has no HotKeys(...) line")
            out["queries"][name] = line
            say("mpp_skew_query", query=name, **line)
    finally:
        M.BROADCAST_BUILD_LIMIT = old
        si._mesh = None
        ss.close()
    del si, ss
    torch.cuda.empty_cache()
    return out


def _mpp_explain(gs):
    """(e) EXPLAIN ANALYZE of Q5 under MPP against the local run on the card."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    mpp = gs.execute("EXPLAIN ANALYZE " + MPP_HINT + SQL[5])
    stats = gs.last_op_stats
    local = gs.execute("EXPLAIN ANALYZE " + SQL[5])

    def nodes(rs):
        """(node line, actual rows, rows its runtime filters pruned) per node."""
        import re
        out = []
        for (line,) in rs.rows:
            text = line.strip()
            if line.startswith("--") or text.startswith(("HotKeys(", "Salted(")):
                continue
            if text.startswith("RuntimeFilter("):
                node, rows, pruned = out[-1]
                out[-1] = (node, rows, pruned + int(text.split("pruned=")[1][:-1]))
                continue
            m = re.match(r"^(.*?)  \(actual rows=(\d+) ", line)
            out.append((m.group(1), int(m.group(2)), 0) if m else (line, None, 0))
        return out
    got, want = nodes(mpp), nodes(local)
    # an MPP scan counts its rows after the runtime filters that mask it (the
    # reference's MPP scan applies them inside the scan), the local scan before them;
    # the engines may also build a join from different sides (the local engine's
    # build is the smaller input, MPP's the right one unless the left is 4x smaller),
    # so another scan can carry the filter: a scan's rows plus what its filters
    # pruned under MPP are the local scan's rows
    same = len(got) == len(want) and all(
        g[0] == w[0] and g[1] is not None and w[1] is not None and g[1] + g[2] == w[1]
        for g, w in zip(got, want))
    if not same:
        raise AssertionError(f"mpp EXPLAIN ANALYZE Q5: node rows differ from the local "
                             f"run:\n  mpp   {got}\n  local {want}")
    if not any(r[0].startswith("-- mpp-scan") for r in mpp.rows):
        raise AssertionError("mpp EXPLAIN ANALYZE Q5 did not run on the mesh")
    per_shard = {st["operator"] + f"#{i}": st["rows_per_shard"]
                 for i, st in enumerate(stats) if st.get("rows_per_shard")}
    if not per_shard:
        raise AssertionError("mpp EXPLAIN ANALYZE Q5 carries no rows_per_shard")
    return {"nodes": len(got), "pruned_mpp": [g[2] for g in got if g[2]],
            "pruned_local": [w[2] for w in want if w[2]], "rows_per_shard": per_shard,
            "shard_skew": [st.get("shard_skew") for st in stats if st.get("shard_skew")]}


def mpp_phase(gs, analyzed_rows, local_ms, sf):
    """The MPP engine on analyzed_tpch's card instance, a mesh of MPP_SHARDS shards on
    cuda:0 installed on it (one card has no mesh of its own): (a)-(c) and (e) on its
    TPC-H lanes, (d) on an instance of its own.  ENABLE_MPP is 0 during the phase,
    so only the ENGINE(MPP) hint runs on the mesh and an un-hinted query is the local
    run (e) compares with."""
    import torch
    from galaxysql_tpu_torch.parallel import exchange
    from galaxysql_tpu_torch.parallel.mesh import GLOBAL_MESH_CACHE, make_mesh
    t_phase = time.perf_counter()
    gi = gs.instance
    mesh = make_mesh(devices=[torch.device(gi.device.type, gi.device.index or 0)] *
                     MPP_SHARDS)
    enable_mpp = gi.config.get("ENABLE_MPP")
    gi._mesh = mesh
    gi.config.set_instance("ENABLE_MPP", 0)
    GLOBAL_MESH_CACHE.clear()
    exchange.reset_exchange_stats()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = {"mesh": {"shards": mesh.size, "devices": mesh.key(), "cards": mesh.cards()}}
    say("mpp_mesh", **out["mesh"])
    try:
        out["tpch"], rows, out["fallbacks"] = _mpp_tpch(gs, analyzed_rows, local_ms, sf)
        out["mesh_cache_bytes"] = GLOBAL_MESH_CACHE.nbytes
        out["cache"] = _mpp_cache(gs, rows)
        out["shuffle"] = _mpp_shuffle(gs, rows)
        out["explain_q5"] = _mpp_explain(gs)
        GLOBAL_MESH_CACHE.clear()
        out["skew"] = _mpp_skew(mesh)
    finally:
        gi._mesh = None
        gi.config.set_instance("ENABLE_MPP", enable_mpp)
        GLOBAL_MESH_CACHE.clear()
    out["exchange"] = dict(exchange.EXCHANGE_STATS)
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in mpp: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- workers: a second process holding tables ------------------------------------------

# held by the worker process; nation is (e)'s replica table (supplier's 10,000 rows
# were, until a cut for time: its backfill and rebuild took 5.7-6.0 s each)
WORKER_TABLES = ("orders", "customer", "supplier", "nation")
WORKER_LOCAL = ("lineitem", "region", "part", "partsupp")
# (Q10, 1.1M orders and customer's strings shipped, was cut for time: 4.2 s on the
# card coordinator and 2.6 s on the CPU one)
WORKER_QUERIES = (3, 5, 18)
WORKER_CPU_QUERIES = (3,)   # also run by a CPU coordinator attached to the worker
WORKER_BOOT_S = 300.0          # a worker printing no WORKER_READY by then failed
WORKER_NEW_ORDER = 6_000_001   # past every SF 1 order key (the phase's own orders)


class _Worker:
    """A port worker process (`python -m galaxysql_tpu_torch.net.worker`) on cuda:0.
    Started by exec, never a fork: CUDA is initialised in this process.  `start()`
    reads its WORKER_READY line within WORKER_BOOT_S and keeps the port across
    restarts, so attached clients reconnect; the caller kills it in `finally`."""

    def __init__(self, work_dir, name, data_dir=None):
        self.data_dir = data_dir
        self.port = 0
        self.proc = None
        self.log = os.path.join(work_dir, f"{name}.log")
        self.boot_s = None

    def start(self):
        """Launch and wait for WORKER_READY; returns the boot seconds."""
        self.launch()
        return self.wait_ready()

    def launch(self):
        root = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "galaxysql_tpu_torch.net.worker",
               "--port", str(self.port), "--device", "cuda"]
        if self.data_dir:
            cmd += ["--data-dir", self.data_dir]
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self._t0 = time.perf_counter()
        with open(self.log, "a") as err:
            self.proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                         stderr=err, env=env, text=True)

    def wait_ready(self):
        import select
        ready, _, _ = select.select([self.proc.stdout], [], [], WORKER_BOOT_S)
        line = self.proc.stdout.readline() if ready else ""
        if not line.startswith("WORKER_READY"):
            self.kill()
            with open(self.log) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"worker failed to start: {line!r}\n{tail}")
        self.port = int(line.split()[1])
        self.boot_s = time.perf_counter() - self._t0
        return self.boot_s

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    @property
    def addr(self):
        return ("127.0.0.1", self.port)


def _worker_coordinator(gi, device):
    """A coordinator on `device` holding analyzed_tpch's WORKER_LOCAL tables (the
    same lanes, its statistics); the worker's WORKER_TABLES are attached later."""
    from galaxysql_tpu_torch.storage import tpch
    inst, s = _copy_instance(gi, "tpch", WORKER_LOCAL, tpch.TPCH_DDL, device)
    # the main path's threshold: without statistics of the remote tables Q5's join
    # order builds past the default 256 MiB, and a grace join is not this phase's path
    inst.config.set_instance("JOIN_SPILL_BYTES", MAIN_JOIN_SPILL_BYTES)
    inst.config.set_instance("QUERY_MEM_BYTES", MAIN_JOIN_SPILL_BYTES)
    _take_statistics(gi, inst, "tpch", WORKER_LOCAL)
    return inst, s


def _order_row(key, comment):
    return (f"({key}, 1, 'O', 1234.56, DATE '1996-01-02', '1-URGENT', "
            f"'Clerk#000000001', 0, '{comment}')")


def _lineitem_rows(key):
    return ", ".join(
        f"({key}, {ln}, {ln + 1}, {ln}, 1.00, 1000.00, 0.05, 0.01, 'N', 'O', "
        f"DATE '1996-02-01', DATE '1996-02-10', DATE '1996-02-20', 'NONE', 'AIR', "
        f"'workers phase')" for ln in (1, 2))


def _worker_queries(gs, cs_cpu, analyzed_rows, local_ms):
    """(b) WORKER_QUERIES (Q3, Q5 and Q18) over the remote tables, twice each on the
    card coordinator (the second run timed), WORKER_CPU_QUERIES once on the CPU
    one."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    out = {}
    for q in WORKER_QUERIES:
        first, first_ms = _timed(gs, SQL[q])
        # "remote-plan <table> -> <host>:<port> rows=<rows shipped>"
        trace = [t for t in gs.last_trace if t.startswith(("remote-plan", "remote-scan"))]
        shipped = [(t.split()[1], int(t.rsplit("rows=", 1)[1])) for t in trace]
        before = _launch_counts()
        warm, warm_ms = _timed(gs, SQL[q])
        after = _launch_counts()
        want = analyzed_rows[f"Q{q}"]
        for label, got in (("first", first.rows), ("warm", warm.rows)):
            ok, floats, worst = _rows_match(got, want)
            if not ok:
                raise AssertionError(f"workers Q{q} ({label}): rows over the remote "
                                     f"tables differ from analyzed_tpch's:\n  "
                                     f"{got[:3]}\n  {want[:3]}")
        line = {"first_ms": first_ms, "warm_ms": warm_ms,
                "local_warm_ms": local_ms[f"Q{q}"], "rows": len(warm.rows),
                "shipped_rows": shipped, "trace": trace,
                "launches": {k: after[k] - before[k] for k in after},
                "max_float_rel_diff": worst}
        if q in WORKER_CPU_QUERIES:
            t0 = time.perf_counter()
            cpu = cs_cpu.execute(SQL[q]).rows
            line["cpu_ms"] = (time.perf_counter() - t0) * 1000.0
            ok, _f, w = _rows_match(warm.rows, cpu)
            if not ok:
                raise AssertionError(f"workers Q{q}: the CPU coordinator's rows differ "
                                     f"from the card's:\n  {cpu[:3]}\n  "
                                     f"{warm.rows[:3]}")
            line["cpu_max_float_rel_diff"] = w
        if not any(t.startswith("remote-plan") for t in trace):
            raise AssertionError(f"workers Q{q}: no remote-plan in the trace: {trace}")
        out[f"Q{q}"] = line
        say("workers_query", query=f"Q{q}", **line)
    return out


def _one(s, sql):
    rows = s.execute(sql).rows
    return rows[0][0] if rows else None


def _worker_writes(gi, gs):
    """(c) 2PC with one remote branch, a rollback and an autocommit UPDATE."""
    import torch
    from galaxysql_tpu_torch.server.session import Session
    k1, k2 = WORKER_NEW_ORDER, WORKER_NEW_ORDER + 1
    other = Session(gi, "tpch")
    out = {}
    try:
        gs.execute("BEGIN")
        gs.execute(f"INSERT INTO orders VALUES {_order_row(k1, 'committed')}")
        gs.execute(f"INSERT INTO lineitem VALUES {_lineitem_rows(k1)}")
        own = gs.execute(f"SELECT o_totalprice, count(*) FROM orders, lineitem "
                         f"WHERE o_orderkey = l_orderkey AND o_orderkey = {k1} "
                         f"GROUP BY o_totalprice").rows
        if own != [(1234.56, 2)]:
            raise AssertionError(f"workers (c): the transaction's own rows {own}")
        if gs.last_trace and not any(t.startswith("remote-") for t in gs.last_trace):
            raise AssertionError("workers (c): the read did not reach the worker")
        if _one(other, f"SELECT count(*) FROM orders WHERE o_orderkey = {k1}") != 0:
            raise AssertionError("workers (c): another session sees the uncommitted row")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs.execute("COMMIT")
        out["commit_remote_ms"] = (time.perf_counter() - t0) * 1000.0
        got = other.execute(f"SELECT o_comment, count(*) FROM orders, lineitem WHERE "
                            f"o_orderkey = l_orderkey AND o_orderkey = {k1} "
                            f"GROUP BY o_comment").rows
        if got != [("committed", 2)]:
            raise AssertionError(f"workers (c): after COMMIT {got}")
        # a local-only COMMIT beside it
        gs.execute("BEGIN")
        gs.execute(f"UPDATE lineitem SET l_comment = 'local only' WHERE l_orderkey = {k1}")
        t0 = time.perf_counter()
        gs.execute("COMMIT")
        out["commit_local_ms"] = (time.perf_counter() - t0) * 1000.0
        # a rollback leaves neither row
        gs.execute("BEGIN")
        gs.execute(f"INSERT INTO orders VALUES {_order_row(k2, 'rolled back')}")
        gs.execute(f"INSERT INTO lineitem VALUES {_lineitem_rows(k2)}")
        t0 = time.perf_counter()
        gs.execute("ROLLBACK")
        out["rollback_remote_ms"] = (time.perf_counter() - t0) * 1000.0
        left = (_one(gs, f"SELECT count(*) FROM orders WHERE o_orderkey = {k2}"),
                _one(gs, f"SELECT count(*) FROM lineitem WHERE l_orderkey = {k2}"))
        if left != (0, 0):
            raise AssertionError(f"workers (c): ROLLBACK left {left}")
        # an autocommit UPDATE of a remote row
        t0 = time.perf_counter()
        rs = gs.execute("UPDATE orders SET o_comment = 'updated remotely' "
                        "WHERE o_orderkey = 1")
        out["autocommit_update_ms"] = (time.perf_counter() - t0) * 1000.0
        got = _one(other, "SELECT o_comment FROM orders WHERE o_orderkey = 1")
        if rs.affected != 1 or got != "updated remotely":
            raise AssertionError(f"workers (c): autocommit UPDATE {rs.affected} {got}")
    finally:
        other.close()
    return out


def _worker_crash(gi, gs, w1):
    """(d) A branch PREPARED, the worker SIGKILLed, the commit point logged, a restart
    from its data dir and a re-attach: recover_remote commits the branch."""
    from galaxysql_tpu_torch.txn.xa import remote_participants_of
    k3 = WORKER_NEW_ORDER + 2
    gs.execute("BEGIN")
    gs.execute(f"INSERT INTO orders VALUES {_order_row(k3, 'in doubt')}")
    txn = gs.txn
    parts = remote_participants_of(gi, txn)
    t0 = time.perf_counter()
    if len(parts) != 1 or not parts[0].prepare():
        raise AssertionError("workers (d): the branch did not prepare")
    out = {"prepare_ms": (time.perf_counter() - t0) * 1000.0}
    w1.kill()
    cts = gi.tso.next_timestamp()
    gi.metadb.tx_log_put(txn.txn_id, "COMMITTED", cts)  # the commit point
    gs.txn = None  # recovery resolves the session's transaction
    out["commit_point"] = cts
    out["restart_s"] = w1.start()
    t0 = time.perf_counter()
    out["recover_remote"] = gi.xa_coordinator.recover_remote()
    for t in WORKER_TABLES:
        gi.attach_remote_table("tpch", t, *w1.addr)
    out["reattach_s"] = time.perf_counter() - t0
    if list(out["recover_remote"].values()) != ["committed"]:
        raise AssertionError(f"workers (d): recover_remote {out['recover_remote']}")
    got = gs.execute(f"SELECT o_comment FROM orders WHERE o_orderkey = {k3}").rows
    if got != [("in doubt",)]:
        raise AssertionError(f"workers (d): the recovered row reads {got}")
    if gi.xa_coordinator.recover_remote() != {}:
        raise AssertionError("workers (d): a branch is still in doubt")
    return out


REPLICA_COLUMNS = ("n_nationkey", "n_name", "n_regionkey", "n_comment")


def _replica_table_of(client):
    """(e)'s replica table (nation) as `client`'s worker holds it, in key order."""
    import numpy as np
    names, _types, data, _valid = client.exec_plan(
        {"schema": "tpch", "table": "nation", "columns": list(REPLICA_COLUMNS)})
    order = np.argsort(data["n_nationkey"], kind="stable")
    return {c: data[c][order] for c in names}


def _worker_replica_down(gi, gs, w2):
    """(e), first half: a second worker (launched at the phase's start) as a replica
    of nation: backfilled, written through, killed (reads fail over, a write marks
    it stale); its restart is launched and boots while (d) runs."""
    from galaxysql_tpu_torch.utils.metrics import WORKER_FAILOVERS
    out = {"replica_boot_s": w2.boot_s}
    t0 = time.perf_counter()
    # a huge weight routes reads to the replica
    gi.attach_replica("tpch", "nation", *w2.addr, weight=10 ** 6)
    out["backfill_ms"] = (time.perf_counter() - t0) * 1000.0
    remote = gi.catalog.table("tpch", "nation").remote
    prim = gi.workers[(remote["host"], remote["port"])]
    rep = gi.workers[w2.addr]
    rs = gs.execute("UPDATE nation SET n_comment = 'replicated' WHERE n_nationkey = 1")
    gi.applier.drain(60.0)
    probe = "SELECT n_comment FROM nation WHERE n_nationkey = 1"
    both = [str(next(iter(c.execute(probe, "tpch")[2].values()))[0])
            for c in (prim, rep)]
    if rs.affected != 1 or both != ["replicated", "replicated"]:
        raise AssertionError(f"workers (e): the write reached {both}")
    before = gs.execute("SELECT count(*), sum(n_regionkey) FROM nation").rows
    # (f) while both card workers run, SHOW CLUSTER HEALTH pulls their `health`
    out["health_live"] = _cluster_health(gs, (w2.addr,), "OK")
    w2.kill()
    f0 = WORKER_FAILOVERS.value
    t0 = time.perf_counter()
    after = gs.execute("SELECT count(*), sum(n_regionkey) FROM nation").rows
    out["failover_read_ms"] = (time.perf_counter() - t0) * 1000.0
    out["failovers"] = WORKER_FAILOVERS.value - f0
    if after != before or out["failovers"] < 1 or not gi.ha.worker_fenced(w2.addr):
        raise AssertionError(f"workers (e): reads after the replica died {after} "
                             f"{before}, failovers {out['failovers']}")
    # (f) the killed replica's row turns UNREACHABLE, before its restart launches
    out["health_killed"] = _cluster_health(gs, (w2.addr,), "UNREACHABLE")
    # the fenced replica is not contacted again: it may boot during the write
    w2.launch()
    gs.execute("UPDATE nation SET n_comment = 'while stale' WHERE n_nationkey = 2")
    entry = [r for r in gi.catalog.table("tpch", "nation").replicas
             if (r["host"], r["port"]) == w2.addr][0]
    if entry.get("stale") is not True:
        raise AssertionError("workers (e): a write did not mark the dead replica stale")
    return out


def _cluster_health(gs, addrs, state):
    """(f) SHOW CLUSTER HEALTH: the rows of the workers at `addrs` must read `state`,
    every other worker's OK with samples > 0 (its `health` pull sampled).  Returns
    the rows and the statement's ms."""
    t0 = time.perf_counter()
    rows = gs.execute("SHOW CLUSTER HEALTH").rows
    ms = (time.perf_counter() - t0) * 1000.0
    want = {f"{h}:{p}" for h, p in addrs}
    workers = [r for r in rows if r[1] == "worker"]
    bad = [r for r in workers
           if (r[2] in want and r[3] != state) or
           (r[2] not in want and (r[3] != "OK" or r[11] < 1))]
    if state == "OK":
        bad += [r for r in workers if r[2] in want and r[11] < 1]
    if bad or len(workers) < 2 or rows[0][1] != "coordinator":
        raise AssertionError(f"workers (f): SHOW CLUSTER HEALTH {rows}")
    return {"ms": ms, "rows": [[r[1], r[2], r[3], r[9], r[11]] for r in rows]}


def _worker_replica_rebuild(gi, gs, w2, out):
    """(e), second half: the restarted replica attached again with backfill=True; its
    rows must equal the primary's."""
    import numpy as np
    remote = gi.catalog.table("tpch", "nation").remote
    prim = gi.workers[(remote["host"], remote["port"])]
    rep = gi.workers[w2.addr]
    entry = [r for r in gi.catalog.table("tpch", "nation").replicas
             if (r["host"], r["port"]) == w2.addr][0]
    out["replica_restart_s"] = w2.wait_ready()
    gi.ha.fence_worker(w2.addr, False)
    rep.ping()  # closes the breaker
    t0 = time.perf_counter()
    gi.attach_replica("tpch", "nation", *w2.addr, weight=10 ** 6, backfill=True)
    out["rebuild_ms"] = (time.perf_counter() - t0) * 1000.0
    a, b = _replica_table_of(prim), _replica_table_of(rep)
    if entry.get("stale") or set(a) != set(b) or \
            not all(np.array_equal(a[c], b[c]) for c in a):
        raise AssertionError("workers (e): the rebuilt replica differs from the primary")
    out["replica_rows"] = int(a["n_nationkey"].shape[0])
    got = gs.execute("SELECT n_comment FROM nation WHERE n_nationkey = 2").rows
    if got != [("while stale",)]:
        raise AssertionError(f"workers (e): the rebuilt replica reads {got}")
    out["show_workers"] = [list(r) for r in gs.execute("SHOW WORKERS").rows]
    return out


def workers_phase(gi, analyzed_rows, local_ms, work_dir):
    """(a) a worker process on cuda:0 booted from a data dir holding analyzed_tpch's
    orders, customer, supplier and nation; (b) Q3, Q5 and Q18 on a card coordinator
    holding the other four tables, and Q3 on a CPU one, both attached to it;
    (c) 2PC, a rollback and an autocommit UPDATE across the seam; (d) a worker crash
    after PREPARE, recovered; (e) a second worker as a replica of nation.  The
    worker's own kernel launches are not visible here: the launches are the
    coordinator's."""
    import torch
    from galaxysql_tpu_torch.storage import tpch
    t_phase = time.perf_counter()
    os.makedirs(work_dir, exist_ok=True)
    wdir = os.path.join(work_dir, "w1")
    t0 = time.perf_counter()
    src, src_s = _copy_instance(gi, "tpch", WORKER_TABLES, tpch.TPCH_DDL, "cuda",
                                data_dir=wdir)
    src.save()
    src_s.close()
    src.shutdown()
    del src, src_s
    torch.cuda.empty_cache()
    out = {"worker_dir_ms": (time.perf_counter() - t0) * 1000.0,
           "worker_tables": list(WORKER_TABLES), "coordinator_tables": list(WORKER_LOCAL),
           "launches_note": "the coordinator's launches; the workers' own launches "
                            "are not visible to the coordinator"}
    w1 = _Worker(work_dir, "w1", data_dir=wdir)
    w2 = _Worker(work_dir, "w2")
    try:
        # both boot side by side (the second is (e)'s replica) while the
        # coordinators' local tables are copied
        w1.launch()
        w2.launch()
        t0 = time.perf_counter()
        ci, cs = _worker_coordinator(gi, "cuda")
        pi, ps = _worker_coordinator(gi, "cpu")
        out["coordinators_ms"] = (time.perf_counter() - t0) * 1000.0
        out["worker_boot_s"] = w1.wait_ready()
        w2.wait_ready()
        say("workers_boot", seconds=out["worker_boot_s"], dir_ms=out["worker_dir_ms"])
        for inst in (ci, pi):
            for t in WORKER_TABLES:
                inst.attach_remote_table("tpch", t, *w1.addr)
        _reset_launches()
        out["queries"] = _worker_queries(cs, ps, analyzed_rows, local_ms)
        ps.close()
        del pi, ps
        out["writes"] = _worker_writes(ci, cs)
        say("workers_writes", **out["writes"])
        # (e)'s replica dies first, so that its restart boots beside (d)'s
        out["replica"] = _worker_replica_down(ci, cs, w2)
        out["crash"] = _worker_crash(ci, cs, w1)
        say("workers_crash", **out["crash"])
        _worker_replica_rebuild(ci, cs, w2, out["replica"])
        say("workers_replica", **{k: v for k, v in out["replica"].items()
                                  if k != "show_workers"})
        out["launches"] = _launch_counts()
        cs.close()
        ci.shutdown()
        del ci, cs
    finally:
        w1.kill()
        w2.kill()
        shutil.rmtree(wdir, ignore_errors=True)
    torch.cuda.empty_cache()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in workers: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the operations plane -------------------------------------------------------------

OPS_COST_SESSIONS = 64      # (a): oltp_point_select sessions, with the plane and without
OPS_COST_SECONDS = 1.5      # (a): seconds of each closed loop
OPS_SUMMARY_QUERIES = (1, 3, 5, 18)
OPS_SUMMARY_SESSIONS = 4    # (b): sessions, each running every query OPS_SUMMARY_RUNS times
OPS_SUMMARY_RUNS = 2        # (b): 3 before a cut for time
OPS_AP_QUERIES = (3, 5, 10, 18)
OPS_AP_SESSIONS = 24        # (c): AP sessions cycling OPS_AP_QUERIES
OPS_TP_SESSIONS = 64        # (c): point sessions
OPS_FLOOD_SECONDS = 2.0
OPS_PRESSURE_QUERIES = (5,)   # (d): Q18 too before a cut for time (17.5 s more)
# (d): the JOIN_SPILL_BYTES ladder a query climbs down until it spills; the rung above
# the first spilling one is the threshold at which it does not spill unscaled
OPS_SPILL_LADDER = tuple(1 << k for k in range(30, 21, -1))   # 1 GiB .. 4 MiB
OPS_HISTORY_QUERIES = 100   # (e): point selects between two history samples
OPS_TICK_S = 5.0            # (e): the synthetic spacing of slo_tick's samples


def _ops_point_sql(key):
    return f"SELECT o_custkey, o_totalprice FROM orders WHERE o_orderkey = {key}"


def _ops_point_keys(gi, n, seed):
    import numpy as np
    keys = _lanes_of(gi, "orders", ["o_orderkey"])["o_orderkey"]
    return [int(k) for k in np.random.default_rng(seed).choice(keys, n, replace=False)]


def _ops_flood(gi, sessions, seconds, work):
    """`sessions` threads, one Session each, running `work(i, session, n)` in a
    closed loop until `seconds` pass; returns each thread's outcomes and the wall
    seconds.  `work` returns one outcome per call."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    conns = [Session(gi, "tpch") for _ in range(sessions)]
    outs = [[] for _ in range(sessions)]
    failures = []
    start = threading.Barrier(sessions + 1)
    stop = [0.0]

    def run(i):
        try:
            start.wait(timeout=120)
            n = 0
            while time.perf_counter() < stop[0]:
                outs[i].append(work(i, conns[i], n))
                n += 1
        except BaseException as e:  # carried to the main thread
            failures.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(sessions)]
    for t in threads:
        t.start()
    stop[0] = time.perf_counter() + seconds + 3600.0
    start.wait(timeout=120)
    t0 = time.perf_counter()
    stop[0] = t0 + seconds
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for c in conns:
        c.close()
    if failures:
        raise failures[0]
    return outs, wall


def _ops_cost(gi, rows_of):
    """(a) oltp_point_select on orders from OPS_COST_SESSIONS sessions for
    OPS_COST_SECONDS, with the plane on (the defaults) and with admission, the
    statement summary and the metric history at 0: QPS and p50 both ways (printed,
    not gated).  Sheds are retried as a client retries them and counted."""
    keys = _ops_point_keys(gi, 4096, 15)
    want = {k: rows_of(k) for k in keys[:8]}

    def work(i, s, n):
        k = keys[(i * 131 + n) % len(keys)]
        t0 = time.perf_counter()
        rows = _execute_as_client(s, _ops_point_sql(k)).rows
        ms = (time.perf_counter() - t0) * 1000.0
        if k in want and rows != want[k]:
            raise AssertionError(f"ops (a): order {k} gave {rows}, {want[k]} expected")
        return ms
    out = {}
    knobs = ("ENABLE_ADMISSION_CONTROL", "ENABLE_STATEMENT_SUMMARY",
             "ENABLE_METRIC_HISTORY")
    _ops_flood(gi, OPS_COST_SESSIONS, 0.5, work)  # ramp: PointPlan and device lanes
    for plane in (1, 0):
        for k in knobs:
            gi.config.set_instance(k, plane)
        sheds0 = CLIENT_SHEDS["count"]
        outs, wall = _ops_flood(gi, OPS_COST_SESSIONS, OPS_COST_SECONDS, work)
        lat = [x for o in outs for x in o]
        out["plane_on" if plane else "plane_off"] = {
            "statements": len(lat), "qps": len(lat) / wall, "p50_ms": _pct(lat, 50),
            "p99_ms": _pct(lat, 99), "sheds_retried": CLIENT_SHEDS["count"] - sheds0}
    for k in knobs:
        gi.config.set_instance(k, 1)
    out["qps_ratio_on_off"] = out["plane_on"]["qps"] / out["plane_off"]["qps"]
    return out


def _ops_summary_rows(gi, digest):
    return [r for r in gi.stmt_summary.rows() if r[0] == digest]


def _ops_summary(gi, ci, analyzed_rows):
    """(b) Q1, Q3, Q5 and Q18, OPS_SUMMARY_RUNS times each from OPS_SUMMARY_SESSIONS
    sessions: SHOW STATEMENT SUMMARY's executions and rows sent of each digest grow by
    exactly the executions and analyzed_tpch's rows, under the plan fingerprint the
    CPU twin plans for the same SQL (planned only: the twin's Q18 is 30-50 s)."""
    import threading
    from galaxysql_tpu_torch.exec.operators import COMPILE_STATS, DISPATCH_STATS
    from galaxysql_tpu_torch.meta import statement_summary as ss
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.sql.parameterize import parameterize
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    digests = {q: ss.digest_key("tpch", parameterize(SQL[q]).parameterized)
               for q in OPS_SUMMARY_QUERIES}
    before = {q: {r[2]: (r[4], r[9]) for r in _ops_summary_rows(gi, d)}
              for q, d in digests.items()}
    c0, d0 = dict(COMPILE_STATS), DISPATCH_STATS["dispatches"]
    failures = []

    ms = {f"Q{q}": [] for q in OPS_SUMMARY_QUERIES}

    def run(i):
        s = Session(gi, "tpch")
        try:
            for _ in range(OPS_SUMMARY_RUNS):
                for q in OPS_SUMMARY_QUERIES:
                    t0 = time.perf_counter()
                    rows = _execute_as_client(s, SQL[q]).rows
                    ms[f"Q{q}"].append((time.perf_counter() - t0) * 1000.0)
                    if not _rows_match(rows, analyzed_rows[f"Q{q}"])[0]:
                        raise AssertionError(f"ops (b): Q{q} rows differ from "
                                             f"analyzed_tpch's")
        except BaseException as e:  # carried to the main thread
            failures.append(e)
        finally:
            s.close()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(OPS_SUMMARY_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    out = {"seconds": time.perf_counter() - t0, "digests": {},
           "query_ms": {q: sorted(v) for q, v in ms.items()}}
    cpu_s = Session(ci, "tpch")
    try:
        for q, d in digests.items():
            grown = {}
            for r in _ops_summary_rows(gi, d):
                e0, n0 = before[q].get(r[2], (0, 0))
                if r[4] > e0:
                    grown[r[2]] = (r[4] - e0, r[9] - n0)
            execs = sum(e for e, _n in grown.values())
            sent = sum(n for _e, n in grown.values())
            want_execs = OPS_SUMMARY_SESSIONS * OPS_SUMMARY_RUNS
            want_sent = want_execs * len(analyzed_rows[f"Q{q}"])
            cpu_fp = ss.plan_fingerprint(ci.planner.plan_select(SQL[q], "tpch", [],
                                                                cpu_s))
            if execs != want_execs or sent != want_sent:
                raise AssertionError(f"ops (b): Q{q} summary grew by {execs} executions "
                                     f"and {sent} rows, {want_execs} and {want_sent} "
                                     f"expected")
            if set(grown) != {cpu_fp}:
                raise AssertionError(f"ops (b): Q{q} ran under plans {sorted(grown)}, "
                                     f"the CPU twin plans {cpu_fp}")
            out["digests"][f"Q{q}"] = {"digest": d, "plan": cpu_fp, "execs": execs,
                                       "rows_sent": sent}
    finally:
        cpu_s.close()
    out["compile_stats_delta"] = {k: COMPILE_STATS[k] - c0[k] for k in COMPILE_STATS}
    out["compile_stats"] = dict(COMPILE_STATS)
    out["dispatches"] = DISPATCH_STATS["dispatches"] - d0
    return out


def _ops_admission(s):
    return {n: v for n, v in s.execute("SHOW ADMISSION").rows}


def _ops_flood_check(gi, s, analyzed_rows, rows_of):
    """(c) OPS_AP_SESSIONS sessions cycling Q3, Q5, Q10 and Q18 and OPS_TP_SESSIONS
    point sessions for OPS_FLOOD_SECONDS: every outcome is analyzed_tpch's rows or a
    typed ServerOverloadError carrying retry_after_ms (retried after it, as a client
    does); SHOW ADMISSION's admitted counts per class and its shed count equal the
    clients' counts."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.utils import errors
    keys = _ops_point_keys(gi, 2048, 16)
    want_tp = {k: rows_of(k) for k in keys[:16]}
    n_ap = OPS_AP_SESSIONS

    def work(i, sess, n):
        if i < n_ap:
            q = OPS_AP_QUERIES[(i + n) % len(OPS_AP_QUERIES)]
            sql, want, cls = SQL[q], analyzed_rows[f"Q{q}"], "AP"
        else:
            k = keys[(i * 37 + n) % len(keys)]
            sql, want, cls = _ops_point_sql(k), want_tp.get(k), "TP"
        try:
            rows = sess.execute(sql).rows
        except errors.ServerOverloadError as e:
            if not e.retry_after_ms > 0:
                raise AssertionError(f"ops (c): a shed without retry_after_ms: {e}")
            time.sleep(e.retry_after_ms / 1000.0)
            return cls, "shed"
        if want is not None and not _rows_match(rows, want)[0]:
            raise AssertionError(f"ops (c): {sql[:60]} rows differ")
        return cls, "ok"
    a0 = _ops_admission(s)
    outs, wall = _ops_flood(gi, n_ap + OPS_TP_SESSIONS, OPS_FLOOD_SECONDS, work)
    a1 = _ops_admission(s)
    flat = [x for o in outs for x in o]
    count = {f"{c}_{o}": sum(1 for x in flat if x == (c, o))
             for c in ("AP", "TP") for o in ("ok", "shed")}
    shed_keys = ("shed_queue_full", "shed_timeout", "shed_deadline", "shed_memory")
    show = {"ap_admitted": a1["ap_admitted"] - a0["ap_admitted"],
            "tp_admitted": a1["tp_admitted"] - a0["tp_admitted"],
            "shed": sum(a1[k] - a0[k] for k in shed_keys),
            **{k: a1[k] - a0[k] for k in shed_keys}}
    if (show["ap_admitted"], show["tp_admitted"], show["shed"]) != \
            (count["AP_ok"], count["TP_ok"], count["AP_shed"] + count["TP_shed"]):
        raise AssertionError(f"ops (c): SHOW ADMISSION {show} against the clients' "
                             f"{count}")
    if not count["AP_ok"] or not count["TP_ok"]:
        raise AssertionError(f"ops (c): a class served nothing: {count}")
    return {"seconds": wall, "clients": count, "show_admission": show,
            "ap_limit": a1["ap_limit"], "tp_limit": a1["tp_limit"],
            "memory_pressure_tier": a1["memory_pressure_tier"],
            "memory_usage_frac": a1["memory_usage_frac"]}


def _ops_spills():
    return _spill_totals()["spill_files"]


def _pool_sampler():
    """A thread sampling exec/memory.GLOBAL_POOL.reserved every 5 ms (a host int):
    `stop()` returns the largest value seen."""
    import threading
    from galaxysql_tpu_torch.exec.memory import GLOBAL_POOL
    peak = [GLOBAL_POOL.reserved]
    done = threading.Event()

    def run():
        while not done.wait(0.005):
            peak[0] = max(peak[0], GLOBAL_POOL.reserved)
    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join()
        return peak[0]
    return stop


def _ops_tier_line(stop_sampler):
    import torch
    return {"pool_reserved_peak_bytes": stop_sampler(),
            "cuda_max_memory_allocated": int(torch.cuda.max_memory_allocated()),
            "cuda_memory_allocated": int(torch.cuda.memory_allocated()),
            "cuda_memory_reserved": int(torch.cuda.memory_reserved())}


def _ops_pressure(gi, s, analyzed_rows):
    """(d) Memory pressure through FP_MEM_PRESSURE: under ELEVATED,
    OPS_PRESSURE_QUERIES at the JOIN_SPILL_BYTES at which they do not spill unscaled
    (found on OPS_SPILL_LADDER) grace-join at a quarter of it with analyzed_tpch's
    rows; the fragment cache's budget halves and restores, and a mem_pressure event is
    journaled; under CRITICAL a new AP query is refused typed while point selects
    serve; with QUERY_MEM_BYTES below the last query's build the pool itself forces
    the spill.  Each tier prints the pool's reserved bytes beside the card
    allocator's."""
    import torch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.utils import errors
    from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_MEM_PRESSURE
    out = {"queries": {}}
    gov = gi.admission.governor
    budget0 = gi.frag_cache.budget

    def run(q, what):
        f0 = _ops_spills()
        t0 = time.perf_counter()
        rows = s.execute(SQL[q]).rows
        ms = (time.perf_counter() - t0) * 1000.0
        if not _rows_match(rows, analyzed_rows[f"Q{q}"])[0]:
            raise AssertionError(f"ops (d) {what}: Q{q} rows differ from analyzed_tpch's")
        return _ops_spills() - f0, ms
    try:
        for q in OPS_PRESSURE_QUERIES:
            line = {}
            last_clean = None
            for rung in OPS_SPILL_LADDER:
                s.execute(f"SET JOIN_SPILL_BYTES = {rung}")
                files, _ms = run(q, f"ladder {rung}")
                if files:
                    break
                last_clean = rung
            if last_clean is None or last_clean == OPS_SPILL_LADDER[-1]:
                raise AssertionError(f"ops (d): Q{q} spilled at every rung or none")
            line["join_spill_bytes"] = last_clean
            s.execute(f"SET JOIN_SPILL_BYTES = {last_clean}")
            files, line["normal_ms"] = run(q, "normal")
            if files:
                raise AssertionError(f"ops (d): Q{q} spilled unscaled at {last_clean}")
            torch.cuda.reset_peak_memory_stats()
            stop = _pool_sampler()
            FAIL_POINTS.arm(FP_MEM_PRESSURE, "elevated")
            line["elevated_tier"] = gov.tier()
            line["elevated_spill_scale"] = gov.spill_scale()
            files, line["elevated_ms"] = run(q, "elevated")
            FAIL_POINTS.disarm(FP_MEM_PRESSURE)
            line["elevated_memory"] = _ops_tier_line(stop)
            if line["elevated_tier"] != 1 or not files:
                raise AssertionError(f"ops (d): Q{q} under ELEVATED: tier "
                                     f"{line['elevated_tier']}, spill files {files}")
            line["elevated_spill_files"] = files
            out["queries"][f"Q{q}"] = line
            if q != OPS_PRESSURE_QUERIES[-1]:
                continue
            # the pool forces the spill: QUERY_MEM_BYTES under the build, which
            # passed half of last_clean (it spilled at the rung below)
            torch.cuda.reset_peak_memory_stats()
            stop = _pool_sampler()
            s.execute(f"SET QUERY_MEM_BYTES = {last_clean // 2}")
            files, line["pool_ms"] = run(q, "pool")
            s.execute(f"SET QUERY_MEM_BYTES = {MAIN_JOIN_SPILL_BYTES}")
            line["pool_memory"] = _ops_tier_line(stop)
            if not files:
                raise AssertionError(f"ops (d): Q{q} did not spill under "
                                     f"QUERY_MEM_BYTES {last_clean // 2}")
            line["pool_spill_files"] = files
        # the fragment cache's budget: halved under ELEVATED, restored after
        before = {"cuda_memory_allocated": int(torch.cuda.memory_allocated()),
                  "cuda_memory_reserved": int(torch.cuda.memory_reserved())}
        FAIL_POINTS.arm(FP_MEM_PRESSURE, "elevated")
        gov.tier()
        halved = gi.frag_cache.budget
        FAIL_POINTS.disarm(FP_MEM_PRESSURE)
        gov.tier()
        restored = gi.frag_cache.budget
        if halved != budget0 // 2 or restored != budget0:
            raise AssertionError(f"ops (d): fragment cache budget {budget0} -> {halved} "
                                 f"-> {restored}")
        out["frag_cache_budget"] = {"normal": budget0, "elevated": halved,
                                    "restored": restored, "before": before,
                                    "after": {"cuda_memory_allocated":
                                              int(torch.cuda.memory_allocated()),
                                              "cuda_memory_reserved":
                                              int(torch.cuda.memory_reserved())}}
        events = [r for r in s.execute("SHOW EVENTS LIKE 'mem_pressure'").rows]
        if not events:
            raise AssertionError("ops (d): no mem_pressure event in SHOW EVENTS")
        out["mem_pressure_events"] = len(events)
        # CRITICAL: a new AP query is refused typed, a point select serves
        stop = _pool_sampler()
        FAIL_POINTS.arm(FP_MEM_PRESSURE, "critical")
        try:
            s.execute(SQL[3])
            refused = None
        except errors.ServerOverloadError as e:
            refused = {"errno": e.errno, "retry_after_ms": e.retry_after_ms}
        key = _ops_point_keys(gi, 1, 17)[0]
        point = s.execute(_ops_point_sql(key)).rows
        FAIL_POINTS.disarm(FP_MEM_PRESSURE)
        gov.tier()
        out["critical_memory"] = _ops_tier_line(stop)
        if refused is None or not refused["retry_after_ms"] or len(point) != 1:
            raise AssertionError(f"ops (d): under CRITICAL the AP query gave {refused}, "
                                 f"the point select {point}")
        out["critical"] = {"ap_refused": refused, "point_rows": len(point)}
    finally:
        FAIL_POINTS.disarm(FP_MEM_PRESSURE)
        gov.tier()
        s.execute(f"SET JOIN_SPILL_BYTES = {MAIN_JOIN_SPILL_BYTES}")
        s.execute(f"SET QUERY_MEM_BYTES = {MAIN_JOIN_SPILL_BYTES}")
    return out


def _ops_slo(gi, s, rows_of):
    """(e) CREATE SLO with a latency target (c)'s AP latencies break, then
    synthetic 5 s-spaced `slo_tick(force=True)` samples, each of which must land:
    SHOW SLO reads BURNING, the flight recorder writes an incident bundle into the
    instance's data dir that SHOW INCIDENTS lists, and SHOW METRIC HISTORY's
    queries_total rate equals the phase's own count of the point selects run
    between two samples."""
    gi.config.set_instance("SLO_FAST_WINDOW_SAMPLES", 2)
    gi.config.set_instance("SLO_SLOW_WINDOW_SAMPLES", 4)
    s.execute("CREATE SLO ops_ap_p99 WITH TARGET_P99_MS = 1, SCHEMA = 'tpch', "
              "CLASS = 'AP'")
    t0 = time.time()
    ticks = 0

    def tick():
        nonlocal ticks
        ticks += 1
        if gi.slo_tick(now=t0 + OPS_TICK_S * ticks, force=True) is not True:
            raise AssertionError(f"ops (e): slo_tick {ticks} did not sample")
    for _ in range(4):
        tick()
    keys = _ops_point_keys(gi, OPS_HISTORY_QUERIES, 18)
    for k in keys:
        s.execute(_ops_point_sql(k))
    tick()
    slo = {r[0]: r for r in s.execute("SHOW SLO").rows}
    state = slo["ops_ap_p99"][8]
    hist = {r[0]: r for r in s.execute("SHOW METRIC HISTORY LIKE 'queries_total'").rows}
    rate = hist["queries_total"][5]
    want_rate = OPS_HISTORY_QUERIES / (OPS_TICK_S * (ticks - 1))
    incidents = s.execute("SHOW INCIDENTS").rows
    burn = [r for r in incidents if r[2] == "slo_burn" and "ops_ap_p99" in r[4]]
    files = os.listdir(os.path.join(gi.data_dir, "incidents")) \
        if os.path.isdir(os.path.join(gi.data_dir, "incidents")) else []
    if state != "BURNING":
        raise AssertionError(f"ops (e): SHOW SLO reads {state} for ops_ap_p99")
    if not burn or f"{burn[0][0]}.json" not in files:
        raise AssertionError(f"ops (e): no incident bundle of the burn: {incidents}, "
                             f"files {files}")
    if not math.isclose(rate, want_rate, rel_tol=1e-9):
        raise AssertionError(f"ops (e): queries_total rate {rate}, {want_rate} expected")
    return {"slo_state": state, "measured_p99_ms": slo["ops_ap_p99"][5],
            "fast_burn": slo["ops_ap_p99"][6], "ticks": ticks,
            "incident": burn[0][0], "incident_file": f"{burn[0][0]}.json",
            "queries_total_rate": rate, "queries_counted": OPS_HISTORY_QUERIES}


def _ops_web(gi, s):
    """(f) WebConsole on 127.0.0.1:0: /status, /statements, /health, /events and
    /timeseries/queries_total over HTTP, each parsed as JSON and held to the SHOW
    surfaces read at the same moment."""
    import urllib.request
    from galaxysql_tpu_torch.server.web import WebConsole
    web = WebConsole(gi, "127.0.0.1", 0)
    port = web.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return json.loads(r.read())
    try:
        t0 = time.perf_counter()
        body = {p: get(p) for p in ("/status", "/statements", "/health", "/events",
                                    "/timeseries/queries_total")}
        ms = (time.perf_counter() - t0) * 1000.0
        stmts = s.execute("SHOW STATEMENT SUMMARY").rows
        events = s.execute("SHOW EVENTS").rows
        slo = s.execute("SHOW SLO").rows
        hist = {r[0]: r for r in s.execute(
            "SHOW METRIC HISTORY LIKE 'queries_total'").rows}
    finally:
        web.stop()
    burning = sorted(r[0] for r in slo if r[8] == "BURNING")
    checks = {
        "status": body["/status"]["node_id"] == gi.node_id,
        "statements": sorted((x["digest"], x["plan"], x["execs"])
                             for x in body["/statements"]["statements"]) ==
        sorted((r[0], r[2], r[4]) for r in stmts),
        "health": sorted(body["/health"]["burning_slos"]) == burning and
        body["/health"]["status"] == ("degraded" if burning else "ok"),
        "events": [e["seq"] for e in body["/events"]["events"]] ==
        [r[0] for r in events],
        "timeseries": len(body["/timeseries/queries_total"]["points"]) ==
        hist["queries_total"][1] and
        body["/timeseries/queries_total"]["points"][-1][1] == hist["queries_total"][2]}
    if not all(checks.values()):
        raise AssertionError(f"ops (f): the web console disagrees with SHOW: {checks}")
    return {"port": port, "get_ms": ms, "checks": checks,
            "statements": len(body["/statements"]["statements"]),
            "events": len(body["/events"]["events"])}


def _ops_locks(gi):
    """(g) GET_LOCK in one session makes a second session's GET_LOCK(name, 0) return
    0; RELEASE_LOCK, and closing the holding session, let it return 1."""
    from galaxysql_tpu_torch.server.session import Session
    a, b = Session(gi, "tpch"), Session(gi, "tpch")
    try:
        got = [_one(a, "SELECT GET_LOCK('ops_lock', 0)"),
               _one(b, "SELECT GET_LOCK('ops_lock', 0)"),
               _one(a, "SELECT RELEASE_LOCK('ops_lock')"),
               _one(b, "SELECT GET_LOCK('ops_lock', 0)")]
        c = Session(gi, "tpch")
        got += [_one(a, "SELECT GET_LOCK('ops_lock2', 0)"),
                _one(c, "SELECT GET_LOCK('ops_lock2', 0)")]
        a.close()
        got.append(_one(c, "SELECT GET_LOCK('ops_lock2', 0)"))
        c.close()
    finally:
        b.close()
    if got != [1, 0, 1, 1, 1, 0, 1]:
        raise AssertionError(f"ops (g): GET_LOCK / RELEASE_LOCK gave {got}")
    return {"outcomes": got}


def _ops_state(gi, s=None, analyzed_rows=None):
    """The process's state between two steps: live threads, the card allocator's and
    the pool's bytes, the memory tier, the spill files so far, and with `s`, Q1, Q3,
    Q5 and Q18 run once each alone (ms: a step must leave no lasting slowdown)."""
    import threading
    import torch
    from galaxysql_tpu_torch.exec.memory import GLOBAL_POOL
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    out = {"threads": sorted(t.name for t in threading.enumerate()),
           "cuda_memory_allocated": int(torch.cuda.memory_allocated()),
           "cuda_memory_reserved": int(torch.cuda.memory_reserved()),
           "pool_reserved": GLOBAL_POOL.reserved, "tier": gi.admission.governor.tier(),
           "spill_files": _ops_spills()}
    if s is not None:
        out["alone_ms"] = {}
        for q in OPS_SUMMARY_QUERIES:
            t0 = time.perf_counter()
            rows = s.execute(SQL[q]).rows
            out["alone_ms"][f"Q{q}"] = (time.perf_counter() - t0) * 1000.0
            if not _rows_match(rows, analyzed_rows[f"Q{q}"])[0]:
                raise AssertionError(f"ops: Q{q} rows differ from analyzed_tpch's")
    return out


def ops_phase(gi, ci, analyzed_rows):
    """The operations plane on analyzed_tpch's card instance `gi` (its CPU twin `ci`
    plans the fingerprints of (b)): (a) the plane's cost on oltp_point_select, (b) the
    statement summary, (c) admission under an AP and point flood, (d) memory
    pressure, (e) SLO, history and incidents, (f) the web console, (g) GET_LOCK.
    Kernel launches are counted over the whole phase."""
    from galaxysql_tpu_torch.server.session import Session
    t_phase = time.perf_counter()
    s = Session(gi, "tpch")
    sheds0 = CLIENT_SHEDS["count"]
    out = {}
    point_rows = {}

    def rows_of(k):
        if k not in point_rows:
            point_rows[k] = s.execute(_ops_point_sql(k)).rows
        return point_rows[k]
    try:
        s.execute(f"SET QUERY_MEM_BYTES = {MAIN_JOIN_SPILL_BYTES}")
        _reset_launches()
        say("ops_start", **_ops_state(gi, s, analyzed_rows))
        steps = (("cost", lambda: _ops_cost(gi, rows_of)),
                 ("summary", lambda: _ops_summary(gi, ci, analyzed_rows)),
                 ("admission", lambda: _ops_flood_check(gi, s, analyzed_rows,
                                                        rows_of)),
                 ("pressure", lambda: _ops_pressure(gi, s, analyzed_rows)),
                 ("slo", lambda: _ops_slo(gi, s, rows_of)),
                 ("web", lambda: _ops_web(gi, s)),
                 ("locks", lambda: _ops_locks(gi)))
        for name, fn in steps:
            t0, c0 = time.perf_counter(), time.process_time()
            out[name] = fn()
            out[name]["step_s"] = time.perf_counter() - t0
            out[name]["process_cpu_s"] = time.process_time() - c0
            out[name]["state"] = _ops_state(gi)
            say("ops_step", step=name, **out[name])
        out["launches"] = _launch_counts()
        say("ops_end", **_ops_state(gi, s, analyzed_rows))
    finally:
        s.close()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in ops: {missing}")
    out["sheds_retried"] = CLIENT_SHEDS["count"] - sheds0
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- placement ---------------------------------------------------------------------------

PLACEMENT_QUERIES = (3, 5, 18)
PLACEMENT_CPU_QUERIES = (3, 5)     # of them, the ones the CPU twin runs after the moves
PLACEMENT_POINT_SELECTS = 1000
PLACEMENT_ROUTED_QUERIES = (1, 3, 5, 18)
PLACEMENT_ROUTED_POINTS = 30        # (d): routed point selects of orders keys
PLACEMENT_PEER_TABLES = ("lineitem", "orders", "customer", "supplier", "nation",
                         "region")  # what the routed queries read
PLACEMENT_SEQ_SESSIONS = 64         # (e): sessions drawing NEXTVAL at once
PLACEMENT_SEQ_PER_SESSION = 16
PLACEMENT_GROUPS = "g0,g1"          # (b): REBALANCE_GROUPS: the balancer proposes a MOVE


def _span_names(spans, skip=("compile",)):
    """(kind, name, parent's name) of every span but those of the `skip` kinds."""
    by_id = {sp.span_id: sp for sp in spans}
    return sorted((sp.kind, sp.name, by_id[sp.parent_id].name
                   if sp.parent_id in by_id else None)
                  for sp in spans if sp.kind not in skip)


def _placement_trace(gi, ci, gs, cs):
    """(f) A traced, uncached Q3 with both device caches cold: its operator, segment
    and transfer spans (names and parents) on the card must equal the CPU twin's,
    `segment_wall_ms` must grow, and the `device_cache_*` gauges must equal the card
    cache's own counts (hits: at its last push, every 64th hit)."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    sql = "/*+TDDL: FRAGMENT_CACHE(OFF)*/ " + SQL[3]
    trees, seg = [], []
    for inst, s in ((gi, gs), (ci, cs)):
        inst.device_cache.clear()
        s.execute("SET ENABLE_QUERY_TRACING = 1")
        h = inst.metrics.histogram("segment_wall_ms")
        c0 = h.count
        s.execute(sql)
        seg.append(h.count - c0)
        trees.append(_span_names(s.last_spans))
        s.execute("SET ENABLE_QUERY_TRACING = 0")
    if trees[0] != trees[1]:
        raise AssertionError(f"placement (f): traced Q3's spans differ:\n  cuda "
                             f"{trees[0]}\n  cpu  {trees[1]}")
    kinds = [k for k, _n, _p in trees[0]]
    if kinds.count("operator") < 5 or kinds.count("transfer") < 5 or not seg[0]:
        raise AssertionError(f"placement (f): traced Q3 lacks spans: {trees[0]}")
    c = gi.device_cache
    g = {n: v for n, _k, v, _h in gi.metrics.rows() if n.startswith("device_cache_")}
    own = {"device_cache_misses": c.misses, "device_cache_bytes": c.nbytes,
           "device_cache_entries": len(c._map)}
    if any(g[k] != v for k, v in own.items()) or g["device_cache_hits"] > c.hits:
        raise AssertionError(f"placement (f): gauges {g} against the cache's {own}, "
                             f"hits {c.hits}")
    return {"spans": len(trees[0]), "operator_spans": kinds.count("operator"),
            "segment_spans": kinds.count("segment"),
            "transfer_spans": kinds.count("transfer"), "segment_wall_ms_count": seg,
            "gauges": g, "cache": dict(own, device_cache_hits=c.hits)}


def _placement_check(gi, ci, gs, cs, label, before, points, point_want):
    """After a move: CHECK TABLE orders OK on both, FastChecker's (rows, checksum)
    equal on both, Q3, Q5 and Q18 on the card equal their rows from before, and the
    point selects equal their answers from before on the card and the CPU twin."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.utils import fastchecker
    out = {}
    checks = [s.execute("CHECK TABLE orders").rows for s in (gs, cs)]
    if checks[0] != checks[1] or checks[0] != [("tpch.orders", "check", "status", "OK")]:
        raise AssertionError(f"placement {label}: CHECK TABLE {checks}")
    cols = gi.catalog.table("tpch", "orders").column_names()
    t0 = time.perf_counter()
    sums = [fastchecker.table_checksum(inst.store("tpch", "orders"), cols, None)
            for inst in (gi, ci)]
    out["checksum_ms"] = (time.perf_counter() - t0) * 1000.0
    if sums[0] != sums[1]:
        raise AssertionError(f"placement {label}: FastChecker {sums}")
    out["rows"], out["checksum"] = sums[0]
    out["query_ms"] = {}
    for q in PLACEMENT_QUERIES:
        t0 = time.perf_counter()
        rows = gs.execute(SQL[q]).rows
        out["query_ms"][f"Q{q}"] = (time.perf_counter() - t0) * 1000.0
        if not _rows_match(rows, before[f"Q{q}"])[0]:
            raise AssertionError(f"placement {label}: Q{q} rows differ from before")
    t0 = time.perf_counter()
    got = [gs.execute(_ops_point_sql(k)).rows for k in points]
    out["point_ms"] = (time.perf_counter() - t0) * 1000.0
    if got != point_want:
        bad = next(k for k, a, b in zip(points, got, point_want) if a != b)
        raise AssertionError(f"placement {label}: point select of {bad} differs")
    tm = gi.catalog.table("tpch", "orders")
    out["partitions"] = tm.partition.num_partitions
    out["bucket_map"] = tm.partition.bucket_map is not None
    out["groups"] = sorted({tm.partition.group_of(i)
                            for i in range(tm.partition.num_partitions)})
    return out


def _placement_moves(gi, ci, gs, cs, before, points, point_want):
    """(a) SPLIT, MERGE back, MOVE into a group, then a repartition of orders to its
    own spec (HASH(o_orderkey), its partition count: later phases read orders as
    loaded), each on the card and on the CPU twin, each checked."""
    n = gi.catalog.table("tpch", "orders").partition.num_partitions
    spec = gi.catalog.table("tpch", "orders").partition.columns[0]
    steps = (("split", "ALTER TABLE orders SPLIT PARTITION p1 INTO 2"),
             ("merge", f"ALTER TABLE orders MERGE PARTITIONS p1, p{n}"),
             ("move", "ALTER TABLE orders MOVE PARTITION p0 TO 'g1'"),
             ("repartition", f"ALTER TABLE orders PARTITION BY HASH({spec}) "
                             f"PARTITIONS {n}"))
    out = {}
    for label, sql in steps:
        jobs0 = len(gs.execute("SHOW REBALANCE").rows)
        t0 = time.perf_counter()
        gs.execute(sql)
        card_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        cs.execute(sql)
        cpu_ms = (time.perf_counter() - t0) * 1000.0
        step = {"sql": sql, "job_ms": card_ms, "cpu_twin_job_ms": cpu_ms}
        jobs = gs.execute("SHOW REBALANCE").rows
        if label == "repartition":
            # the repartition job keeps no progress row: its backfill copies every
            # visible row, and no write ran during it
            step["progress"] = "none kept by the repartition job"
        else:
            if len(jobs) != jobs0 + 1 or jobs[-1][3:5] != ("DONE", "cutover"):
                raise AssertionError(f"placement {label}: SHOW REBALANCE {jobs[-1:]}")
            step["rows_copied"], step["catchup_events"] = jobs[-1][7], jobs[-1][8]
            step["progress"] = list(jobs[-1])
        step.update(_placement_check(gi, ci, gs, cs, label, before, points,
                                     point_want))
        if label == "repartition":
            step["rows_copied"], step["catchup_events"] = step["rows"], 0
        say("placement_step", step=label, **step)
        out[label] = step
    if out["repartition"]["partitions"] != n or out["repartition"]["bucket_map"]:
        raise AssertionError("placement: the repartition did not restore orders' spec")
    return out


def _placement_balancer(gi, ci, gs, cs, before, points, point_want):
    """(b) With REBALANCE_GROUPS = PLACEMENT_GROUPS on both: REBALANCE TABLE orders
    DRY RUN, then applied; the proposals (job ids aside) equal the CPU twin's, and
    SHOW REBALANCE equals information_schema.rebalance_jobs."""
    out = {}
    for inst in (gi, ci):
        inst.config.set_instance("REBALANCE_GROUPS", PLACEMENT_GROUPS)
    try:
        for label, sql in (("dry_run", "REBALANCE TABLE orders DRY RUN"),
                           ("apply", "REBALANCE TABLE orders")):
            t0 = time.perf_counter()
            card = gs.execute(sql).rows
            ms = (time.perf_counter() - t0) * 1000.0
            cpu = cs.execute(sql).rows
            if [r[:6] for r in card] != [r[:6] for r in cpu] or not card:
                raise AssertionError(f"placement (b) {label}: {card} against {cpu}")
            out[label] = {"ms": ms, "proposals": [list(r) for r in card]}
    finally:
        for inst in (gi, ci):
            inst.config.set_instance("REBALANCE_GROUPS", "")
    if out["apply"]["proposals"][0][5] != "applied":
        raise AssertionError(f"placement (b): not applied: {out['apply']}")
    out["check"] = _placement_check(gi, ci, gs, cs, "balancer", before, points,
                                    point_want)
    show = [r[:9] + r[10:] for r in gs.execute("SHOW REBALANCE").rows]
    info = gs.execute("SELECT job_id, table_name, kind, state, phase, src_partitions, "
                      "targets, rows_copied, events_applied, last_checkpoint, "
                      "router_epoch FROM information_schema.rebalance_jobs "
                      "ORDER BY job_id").rows
    if show != info:
        raise AssertionError(f"placement (b): SHOW REBALANCE {show} against "
                             f"information_schema {info}")
    out["jobs"] = len(show)
    return out


def _placement_router(gi, before, points, point_want):
    """(d) A FrontRouter over the card instance and two peer coordinators on cuda:0
    holding copies of PLACEMENT_PEER_TABLES (the same lanes, `_copy_instance`, and
    statistics): routed Q1, Q3, Q5, Q18 and point selects equal the local rows, each
    on its ring owner; orders' dominant group bound to a peer moves Q3 there; SHOW
    COORDINATORS; a traced routed Q3 holds the peer's grafted operator spans; a
    detached peer's admission gossip is forgotten."""
    import gc
    from galaxysql_tpu_torch.meta.statement_summary import digest_key
    from galaxysql_tpu_torch.server import router as R
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.sql.parameterize import parameterize
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    out = {}
    t0 = time.perf_counter()
    peers = []
    for _ in range(2):
        pi, ps = _copy_instance(gi, "tpch", PLACEMENT_PEER_TABLES, tpch.TPCH_DDL, "cuda")
        _take_statistics(gi, pi, "tpch", PLACEMENT_PEER_TABLES)
        ps.close()
        peers.append(R.InprocPeer(pi))
    out["peer_copy_s"] = time.perf_counter() - t0
    router = R.FrontRouter(gi)
    try:
        for p in peers:
            router.add_peer(p)
        role = {gi.node_id: "local", peers[0].node_id: "peer0",
                peers[1].node_id: "peer1"}
        rs = R.RouterSession(router, schema="tpch")
        stmts = [(f"Q{q}", SQL[q], before[f"Q{q}"]) for q in PLACEMENT_ROUTED_QUERIES]
        stmts += [(f"point{k}", _ops_point_sql(k), want) for k, want in
                  list(zip(points, point_want))[:PLACEMENT_ROUTED_POINTS]]
        landed, routed_ms = {}, {}
        for name, sql, want in stmts:
            owner = router.ring_owner(digest_key("tpch", parameterize(sql).cache_key))
            n0 = router.affinity_of(owner)[0]
            t1 = time.perf_counter()
            rows = rs.execute(sql).rows
            routed_ms[name] = (time.perf_counter() - t1) * 1000.0
            if not _rows_match(rows, want)[0]:
                raise AssertionError(f"placement (d): routed {name} differs from local")
            if router.affinity_of(owner)[0] != n0 + 1:
                raise AssertionError(f"placement (d): {name} missed its ring owner")
            landed.setdefault(role[owner], []).append(name)
        out["landed"] = landed
        out["routed_ms"] = {k: v for k, v in routed_ms.items() if k.startswith("Q")}
        out["routed_point_ms_sum"] = sum(v for k, v in routed_ms.items()
                                         if k.startswith("point"))
        tm = gi.catalog.table("tpch", "orders")
        group = gi.placement.dominant_group(tm)
        gi.placement.bind(group, coordinator=peers[1].node_id)
        gi.placement._cache_at = 0.0
        digest = digest_key("tpch", parameterize(SQL[3]).cache_key)
        target = router.targets_for(digest, SQL[3], "tpch")[0]
        n0 = router.affinity_of(peers[1].node_id)[0]
        rows = rs.execute(SQL[3]).rows
        if target is not peers[1] or router.affinity_of(peers[1].node_id)[0] != n0 + 1 \
                or not _rows_match(rows, before["Q3"])[0]:
            raise AssertionError("placement (d): the bound peer did not serve Q3")
        out["bound"] = {"group": group, "q3_on": role[target.node_id]}
        s = Session(gi, "tpch")
        coords = sorted((role.get(r[0], r[0]), r[1], r[2])
                        for r in s.execute("SHOW COORDINATORS").rows)
        if coords != [("local", "local", "OK"), ("peer0", "peer", "OK"),
                      ("peer1", "peer", "OK")]:
            raise AssertionError(f"placement (d): SHOW COORDINATORS {coords}")
        out["coordinators"] = coords
        rate = gi.trace_store.sampler.rate
        gi.trace_store.configure(rate=1.0)
        try:
            rows = rs.execute(SQL[3]).rows
        finally:
            gi.trace_store.configure(rate=rate)
        grafted = [sp for sp in rs.last_spans
                   if sp.node == peers[1].node_id and sp.kind == "operator"]
        if rs.last_spans[0].name != "route" or len(grafted) < 5 or \
                not _rows_match(rows, before["Q3"])[0]:
            raise AssertionError("placement (d): the traced routed Q3 holds no grafted "
                                 "operator spans")
        out["traced"] = {"spans": len(rs.last_spans), "grafted_operator_spans":
                         len(grafted), "trace_id": rs.last_trace_id}
        gi.placement.unbind(group)
        router.gossip_tick()
        node = peers[0].node_id
        seen = any(n == node for n, _s, _a in gi.admission.peer_gossip_rows())
        router.remove_peer(node)
        gone = not any(n == node for n, _s, _a in gi.admission.peer_gossip_rows())
        if not (seen and gone and node not in gi.coordinators):
            raise AssertionError("placement (d): the detached peer's admission state "
                                 "was not forgotten")
        out["detached"] = {"gossiped_before": seen, "forgotten": gone}
        s.close()
        rs.close()
    finally:
        router.close()
        gi.__dict__.pop("router", None)
        del peers
        gc.collect()
    return out


def _placement_sequences(gi):
    """(e) PLACEMENT_SEQ_SESSIONS sessions drawing NEXTVAL('placement_seq') at once,
    as clients (a typed shed is retried, `_execute_as_client`; admission refuses a
    statement before it draws a value): every value unique, together 1..n."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    got, errs = [], []
    lock = threading.Lock()

    def worker():
        s = Session(gi, "tpch")
        try:
            vals = [_execute_as_client(s, "SELECT NEXTVAL('placement_seq')").rows[0][0]
                    for _ in range(PLACEMENT_SEQ_PER_SESSION)]
            with lock:
                got.extend(vals)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(repr(e))
        finally:
            s.close()
    t0, sheds0 = time.perf_counter(), CLIENT_SHEDS["count"]
    ts = [threading.Thread(target=worker) for _ in range(PLACEMENT_SEQ_SESSIONS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    n = PLACEMENT_SEQ_SESSIONS * PLACEMENT_SEQ_PER_SESSION
    if errs or sorted(got) != list(range(1, n + 1)):
        raise AssertionError(f"placement (e): NEXTVAL {errs[:3]} {len(got)} values, "
                             f"{len(set(got))} unique")
    return {"values": n, "unique": len(set(got)), "ms": (time.perf_counter() - t0) * 1e3,
            "sheds_retried": CLIENT_SHEDS["count"] - sheds0}


def placement_phase(gi, ci, analyzed_rows):
    """The placement slice on analyzed_tpch's card instance `gi` and its CPU twin `ci`
    at the run's scale: (f) the span tree and the device-cache gauges, (a) SPLIT,
    MERGE, MOVE and a repartition of orders, (b) the balancer, (c) CHECK TABLE of the
    eight tables, (d) the front router over two peer coordinators, (e) NEXTVAL from
    many sessions.  Kernel launches are counted over the whole phase."""
    from galaxysql_tpu_torch.server.session import Session
    t_phase = time.perf_counter()
    gs, cs = Session(gi, "tpch"), Session(ci, "tpch")
    out = {}
    try:
        _reset_launches()
        before = {f"Q{q}": analyzed_rows[f"Q{q}"]
                  for q in set(PLACEMENT_QUERIES + PLACEMENT_ROUTED_QUERIES)}
        points = _ops_point_keys(gi, PLACEMENT_POINT_SELECTS, seed=20241018)
        point_want = [gs.execute(_ops_point_sql(k)).rows for k in points]
        if point_want != [cs.execute(_ops_point_sql(k)).rows for k in points]:
            raise AssertionError("placement: point selects differ on the CPU twin")
        steps = (("trace", lambda: _placement_trace(gi, ci, gs, cs)),
                 ("moves", lambda: _placement_moves(gi, ci, gs, cs, before, points,
                                                    point_want)),
                 ("balancer", lambda: _placement_balancer(gi, ci, gs, cs, before,
                                                          points, point_want)),
                 ("check_table", lambda: _placement_check_tables(gs, cs)),
                 ("router", lambda: _placement_router(gi, before, points, point_want)),
                 ("sequences", lambda: _placement_sequences(gi)))
        for name, fn in steps:
            t0 = time.perf_counter()
            out[name] = fn()
            out[name + "_s"] = time.perf_counter() - t0
            if name != "moves":
                say("placement_step", step=name, seconds=out[name + "_s"],
                    **out[name])
        # the CPU twin's Q3 and Q5 after every move, against the card's (Q18, 26 s
        # on the twin, is held to analyzed_tpch's card rows, as there: a cut for time)
        from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
        t0 = time.perf_counter()
        for q in PLACEMENT_CPU_QUERIES:
            if not _rows_match(cs.execute(SQL[q]).rows, before[f"Q{q}"])[0]:
                raise AssertionError(f"placement: the CPU twin's Q{q} differs")
        out["cpu_twin_queries_s"] = time.perf_counter() - t0
        out["launches"] = _launch_counts()
    finally:
        gs.close()
        cs.close()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in placement: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _placement_check_tables(gs, cs):
    """(c) CHECK TABLE of the eight TPC-H tables: every row OK, equal on both."""
    from galaxysql_tpu_torch.storage import tpch
    sql = "CHECK TABLE " + ", ".join(tpch.TABLE_ORDER)
    t0 = time.perf_counter()
    card = gs.execute(sql).rows
    ms = (time.perf_counter() - t0) * 1000.0
    want = [(f"tpch.{t}", "check", "status", "OK") for t in tpch.TABLE_ORDER]
    if card != want or cs.execute(sql).rows != want:
        raise AssertionError(f"placement (c): CHECK TABLE {card}")
    return {"tables": len(card), "ms": ms}


# -- formulations: the reference's accelerator branch on the card ---------------------

FORMULATION_MPP_QUERIES = (1, 3, 5, 18)   # (b): MPP under the sort branch
F32_EPS = 2.0 ** -24


def _formulation_capture():
    """A `Capture` of the sort branch's three formulations: the largest card call's
    arguments of each, by rows times key and aggregate lanes for a group-by (so Q1's
    lineitem aggregation outweighs a global one over the same batch), by build plus
    probe rows for a join."""
    from galaxysql_tpu_torch.kernels import relational as K

    def work(keys, inputs, specs, live, _cap):
        return live.numel() * (len(keys) + len(specs))
    return Capture([
        (K, "sort_groupby", work),
        (K, "matmul_groupby", work),
        (K, "_hash_join_pairs_sorted", lambda bk, pk, bl, pl, cap: bl.numel() + pl.numel()),
    ])


def _moved(x, device):
    """Tensors inside nested lists and tuples moved to `device` (specs kept)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_moved(a, device) for a in x)
    return x


def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(a) for a in x)
    return 0


def _equal(a, b, float_tol=0.0) -> bool:
    """Nested results equal: every tensor bit for bit, float lanes within `float_tol`
    where it is given (NaN equal to NaN); flags as bools."""
    import torch
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y, float_tol) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return bool(a) == bool(b)
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        if float_tol > 0:
            near = (a.double() - b.double()).abs() <= float_tol
            return bool((near | (torch.isnan(a) & torch.isnan(b))).all())
        bits = torch.int32 if a.element_size() == 4 else torch.int64
        return bool(torch.equal(a.view(bits), b.view(bits)))
    return bool(torch.equal(a, b))


def _groupby_equal(a, b, float_tol) -> bool:
    return (_equal(a.keys, b.keys) and _equal(a.aggs, b.aggs, float_tol) and
            _equal(a.live, b.live) and _equal(a.num_groups, b.num_groups) and
            bool(a.overflow) == bool(b.overflow))


def _float_sum_tol(inputs, specs, live) -> float:
    """4 * n * 2^-24 * sum(|x|) over each float SUM input: twice the bound on a running
    float32 sum's error, for the two running sums a group's sum differences (or the
    atomic adds of the scatter twin, in any order)."""
    tol = 0.0
    for s in specs:
        if s.kind == "sum" and s.arg >= 0:
            d, v = inputs[s.arg]
            if d.dtype.is_floating_point:
                m = live if v is None else (live & v)
                tol = max(tol, 4 * d.numel() * F32_EPS * float(d[m].double().abs().sum()))
    return tol


def _canonical_groups(r):
    """A GroupByResult's live groups in key order, every lane gathered to it; key data
    under a NULL key and aggregate data under an invalid flag zeroed (unspecified)."""
    import torch
    from galaxysql_tpu_torch.kernels import relational as K
    idx = torch.nonzero(r.live).flatten()

    def clean(d, v):
        d = d[idx]
        if v is None:
            return d, None
        v = v[idx]
        return torch.where(v, d, torch.zeros_like(d)), v
    keys = [clean(d, v) for d, v in r.keys]
    aggs = [clean(d, v) for d, v in r.aggs]
    lanes = []
    for d, v in keys:
        if v is not None:
            lanes.append((~v).to(torch.int8))
        lanes.append(K._sort_lane(d))
    order = K.lexsort_major_first(lanes) if lanes else \
        torch.arange(idx.numel(), device=idx.device)

    def pick(p):
        return p[0][order], None if p[1] is None else p[1][order]
    return [pick(p) for p in keys], [pick(p) for p in aggs]


def _canonical_pairs(p):
    """The verified (probe row, build row) pairs of a JoinPairs, in that order."""
    import torch
    from galaxysql_tpu_torch.kernels import relational as K
    b, q = p.build_idx[p.live], p.probe_idx[p.live]
    order = K.lexsort_major_first([q, b])
    return torch.stack([q[order], b[order]])


def _formulation_check(name, args, source_query):
    """(c): one formulation on its largest input from (a): on the card against its own
    run on the CPU over the same inputs, and against its scatter-branch twin after a
    canonical ordering (groups by key, pairs by probe and build row); each of the two
    timed as the kernels are (`_device_ms`, `_time`)."""
    import torch
    from galaxysql_tpu_torch.kernels import relational as K
    fn = getattr(K, name)
    if name == "sort_groupby":
        keys, inputs, specs, live, mg = args
        twin_name = "hash_groupby"
        twin = lambda: K.hash_groupby(keys, inputs, specs, live, mg)  # noqa: E731
        tol = _float_sum_tol(inputs, specs, live)
        shape = {"n": live.numel(), "keys": len(keys), "max_groups": mg}
    elif name == "matmul_groupby":
        keys, inputs, specs, live, domains = args
        twin_name = "scatter_groupby"
        twin = lambda: K.scatter_groupby(keys, inputs, specs, live, domains)  # noqa: E731
        tol = 0.0
        shape = {"n": live.numel(), "domains": list(domains)}
    else:
        bk, pk, bl, pl, cap = args
        twin_name = "_hash_join_pairs_table"
        twin = lambda: K._hash_join_pairs_table(bk, pk, bl, pl, cap)  # noqa: E731
        tol = 0.0
        shape = {"nb": bl.numel(), "npr": pl.numel(), "cap": cap}
    run = lambda: fn(*args)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = fn(*_moved(args, "cpu"))
    cpu_s = time.perf_counter() - t0
    want_twin = twin()
    if name == "_hash_join_pairs_sorted":
        same_cpu = _equal(tuple(got), tuple(cpu))
        same_twin = _equal(_canonical_pairs(got), _canonical_pairs(want_twin)) and \
            _equal(got.probe_matched, want_twin.probe_matched)
        shape["pairs"] = int(got.live.sum())
    else:
        same_cpu = _groupby_equal(got, cpu, tol)
        same_twin = _equal(_canonical_groups(got), _canonical_groups(want_twin), tol)
        shape["groups"] = int(got.num_groups)
    if not (same_cpu and same_twin):
        raise AssertionError(f"formulations (c): {name} on Q{source_query}'s input: "
                             f"equal to its CPU run {same_cpu}, to {twin_name} "
                             f"{same_twin}")
    nbytes = _nbytes(args) + _nbytes(tuple(got))
    return {"name": name, "input_of": f"Q{source_query}", "shape": shape,
            "float_tol": tol, "equal_cpu": True, "equal_twin": True,
            "cpu_s": cpu_s, "ms": _device_ms(run), "call_ms": _time(run),
            "twin": twin_name, "twin_ms": _device_ms(twin), "twin_call_ms": _time(twin),
            **_bound(nbytes)}


def formulations_phase(gi, analyzed_rows, sf):
    """The reference's accelerator branch (`formulation_scope("sort")`) on
    analyzed_tpch's card instance `gi`, no data loaded: (a) the 22 queries under the
    scope, cold (this branch's first run) and warm, each timed, then warm on the
    default scatter branch beside it; rows equal to analyzed_tpch's, and no launch of
    the four kernels; (b) FORMULATION_MPP_QUERIES under ENGINE(MPP) on a mesh of
    MPP_SHARDS shards on cuda:0, twice under the scope and once on the scatter branch,
    rows equal to analyzed_tpch's, and no launch outside a hybrid join's probe; (c)
    `sort_groupby`, `matmul_groupby` and `_hash_join_pairs_sorted` on the largest
    input (a) gave each: against their own CPU run and their scatter twins, timed."""
    import torch
    from galaxysql_tpu_torch.kernels import relational as K
    from galaxysql_tpu_torch.parallel.mesh import GLOBAL_MESH_CACHE, make_mesh
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    t_phase = time.perf_counter()
    s = Session(gi, "tpch")
    out = {"queries": {}, "mpp": {}}
    capture = _formulation_capture()
    source = {}
    _reset_launches()

    def timed(sql, branch):
        with K.formulation_scope(branch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = s.execute(sql)
            torch.cuda.synchronize()
        return rs, (time.perf_counter() - t0) * 1000.0

    try:
        for q in range(1, 23):
            want = analyzed_rows[f"Q{q}"]
            before = _launch_counts()
            seen = {k: v[1] for k, v in capture.calls.items()}
            cold, cold_ms = timed(SQL[q], "sort")
            warm, warm_ms = timed(SQL[q], "sort")
            after = _launch_counts()
            for k, v in capture.calls.items():
                if seen.get(k) is not v[1]:
                    source[k] = q
            scatter, scatter_ms = timed(SQL[q], "scatter")
            launches = {k: after[k] - before[k] for k in after}
            for what, rows in (("cold", cold.rows), ("warm", warm.rows),
                               ("scatter", scatter.rows)):
                if not _rows_match(rows, want)[0]:
                    raise AssertionError(f"formulations Q{q} ({what}): rows differ from "
                                         f"analyzed_tpch's:\n  got  {rows[:3]}\n  want "
                                         f"{want[:3]}")
            if any(launches.values()):
                raise AssertionError(f"formulations Q{q}: kernels launched on the sort "
                                     f"branch: {launches}")
            out["queries"][f"Q{q}"] = line = {
                "sort_cold_ms": cold_ms, "sort_warm_ms": warm_ms,
                "scatter_warm_ms": scatter_ms, "launches": launches,
                "rows": len(warm.rows)}
            say("formulations_query", query=f"Q{q}", **line)
        out["sum_sort_warm_ms"] = sum(v["sort_warm_ms"] for v in out["queries"].values())
        out["sum_scatter_warm_ms"] = sum(v["scatter_warm_ms"]
                                         for v in out["queries"].values())
        out["formulation_calls"] = {k: len(v) for k, v in capture.shapes.items()}
    finally:
        capture.restore()
    missing = [k for k in ("sort_groupby", "matmul_groupby", "_hash_join_pairs_sorted")
               if k not in capture.calls]
    if missing:
        raise AssertionError(f"formulations (a): never reached {missing}")

    # (b) MPP under the sort branch on the phase's own mesh
    mesh = make_mesh(devices=[torch.device(gi.device.type, gi.device.index or 0)] *
                     MPP_SHARDS)
    enable_mpp = gi.config.get("ENABLE_MPP")
    gi._mesh = mesh
    gi.config.set_instance("ENABLE_MPP", 0)
    GLOBAL_MESH_CACHE.clear()
    try:
        for q in FORMULATION_MPP_QUERIES:
            sql = MPP_HINT + SQL[q]
            before = _launch_counts()
            first, first_ms = timed(sql, "sort")
            warm, warm_ms = timed(sql, "sort")
            after = _launch_counts()
            hybrid = any("mpp-hybrid-join" in t for t in s.last_trace)
            scatter, scatter_ms = timed(sql, "scatter")
            launches = {k: after[k] - before[k] for k in after}
            for what, rows in (("first", first.rows), ("warm", warm.rows),
                               ("scatter", scatter.rows)):
                if not _mpp_rows_equal(rows, analyzed_rows[f"Q{q}"],
                                       MPP_ORDERED.get(q, True)):
                    raise AssertionError(f"formulations mpp Q{q} ({what}): rows differ "
                                         f"from analyzed_tpch's")
            if launches["hash_place"] or (not hybrid and any(launches.values())):
                raise AssertionError(f"formulations mpp Q{q}: kernels launched on the "
                                     f"sort branch outside a hybrid probe: {launches}")
            out["mpp"][f"Q{q}"] = line = {
                "sort_first_ms": first_ms, "sort_warm_ms": warm_ms,
                "scatter_warm_ms": scatter_ms, "hybrid_join": hybrid,
                "launches": launches, "rows": len(warm.rows)}
            say("formulations_mpp", query=f"Q{q}", **line)
    finally:
        gi._mesh = None
        gi.config.set_instance("ENABLE_MPP", enable_mpp)
        GLOBAL_MESH_CACHE.clear()
        s.close()
    # the sort branch's launches of the four kernels over (a) and (b)
    out["launches"] = {k: sum(line["launches"][k] for part in ("queries", "mpp")
                              for line in out[part].values()) for k in KERNELS}

    # (c) each formulation on its largest input from (a)
    out["checks"] = []
    for name, (_size, args) in capture.calls.items():
        entry = _formulation_check(name, args, source[name])
        out["checks"].append(entry)
        say("formulations_check", **entry)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the TP host engine -------------------------------------------------------------

TP_HOST_SETUP = (
    "CREATE DATABASE tp", "USE tp",
    "CREATE TABLE t (id INT PRIMARY KEY, a INT, f DOUBLE)",
    "INSERT INTO t VALUES (1, 10, 0.1), (2, 7, 0.2)",
    "CREATE TABLE s (id INT PRIMARY KEY, a INT, g DOUBLE, name VARCHAR(8)) "
    "PARTITION BY HASH(id) PARTITIONS 3",
    "INSERT INTO s VALUES " + ", ".join(
        f"({i}, {i % 7}, {(i % 11) / 4}, '{'xyz'[i % 3]}{i % 5}')" for i in range(1, 41)),
    "INSERT INTO s VALUES (41, NULL, NULL, NULL)",
    "CREATE TABLE u (tid INT, b VARCHAR(8))",
    "INSERT INTO u VALUES (1, 'one'), (2, 'two'), (2, 'deux'), (9, 'nine')",
)
# TP statements over the small tables, held to the port on the CPU bit for bit; the
# first three gave float32 answers before the host engine (ROADMAP Queue 3 item 17)
TP_HOST_STATEMENTS = (
    "SELECT a / 3 FROM t WHERE id = 1",
    "SELECT a / 3, f * 3 FROM t ORDER BY id",
    "SELECT id FROM t WHERE f = 0.1",
    "SELECT id, a / 4, g * 3, g > 0.5 FROM s WHERE g < 2.25",
    "SELECT a, COUNT(*), SUM(id), MIN(name), MAX(g) FROM s WHERE g < 2 GROUP BY a "
    "ORDER BY a",
    "SELECT name, SUM(g * 3), AVG(a / 2) FROM s GROUP BY name ORDER BY name",
    "SELECT s.id, u.b FROM s JOIN u ON s.id = u.tid WHERE s.g * 3 > 0.1 "
    "ORDER BY s.id, u.b",
    "SELECT id FROM s WHERE a > (SELECT AVG(a) FROM t) ORDER BY id",
    "SELECT DISTINCT g * 3 FROM s WHERE id < 12 ORDER BY 1",
    "SELECT a / 3 FROM t UNION ALL SELECT g * 3 FROM s WHERE id < 4",
    "SELECT id, ROW_NUMBER() OVER (PARTITION BY a ORDER BY id), "
    "SUM(g) OVER (PARTITION BY a ORDER BY id) FROM s ORDER BY id",
    "SELECT 1 / 3, 2.5 * 3, 0.1 + 0.2",
)
# a host scan under Filter and Project, outside the point-plan fast path
TP_HOST_PROFILED = "SELECT id, a / 3, g * 3 FROM s WHERE g > 1"
TP_HOST_AP_CONTROL = "SELECT SUM(l_quantity), COUNT(*) FROM lineitem WHERE l_discount > 0.05"
TP_HOST_QUERIES = (1, 6)    # at --sf with ENABLE_TPU_ENGINE = 0 and = 1
TP_HOST_WARM = 2            # warm runs of each, each way
TP_HOST_P50_RUNS = 200      # runs of TP_HOST_PROFILED for its p50


def _cuda_activity(fn):
    """(CUDA kernels, CUDA memory copies, their names) that `torch.profiler` saw
    while `fn` ran, with CUDA activity traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.name.lower().startswith("memcpy") or
              e.name.lower().startswith("memset")]
    kernels = [e for e in events if e not in copies]
    return len(kernels), len(copies), sorted({e.name[:60] for e in events})[:6]


def tp_host_phase(inst, sf):
    """The reference's TP host engine on the card: (a) the C++ host runtime is live;
    (b) TP_HOST_STATEMENTS over small tables on a card instance equal the port on the
    CPU bit for bit; (c) `torch.profiler` sees no CUDA kernel while
    TP_HOST_PROFILED runs and some while TP_HOST_AP_CONTROL runs on the main path's
    instance `inst`; (d) TP_HOST_QUERIES at `sf` with ENABLE_TPU_ENGINE = 0 equal
    their engine-on rows (floats within 1e-6), warm ms both ways; (e) the p50 of
    TP_HOST_PROFILED on the card."""
    import torch
    from galaxysql_tpu_torch import native
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    t_phase = time.perf_counter()
    out = {"native_available": native.AVAILABLE, "native_build_error": native.BUILD_ERROR}
    if not out["native_available"]:
        raise AssertionError(f"tp_host: the C++ host runtime is not live: "
                             f"{native.BUILD_ERROR}")
    launches0 = _launch_counts()
    steps = {}
    t_step = time.perf_counter()

    def step(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now
    gs = Session(_frag_off(Instance(device="cuda")))
    cs = Session(_frag_off(Instance(device="cpu")))
    try:
        for sql in TP_HOST_SETUP:
            gs.execute(sql)
            cs.execute(sql)
        # (b) bit for bit against the CPU
        for sql in TP_HOST_STATEMENTS:
            got, want = gs.execute(sql), cs.execute(sql)
            if got.rows != want.rows:
                raise AssertionError(f"tp_host: {sql}: card {got.rows[:3]} != CPU "
                                     f"{want.rows[:3]}")
            if gs.last_trace[-1].split("workload=")[-1] != "TP":
                raise AssertionError(f"tp_host: {sql} did not plan TP")
        out["statements"] = len(TP_HOST_STATEMENTS)
        step("statements_s")
        rs = gs.execute(TP_HOST_PROFILED)
        if rs.batch.host is None:
            raise AssertionError("tp_host: the profiled statement's result left the host")
        # (c) no CUDA kernel for a host-run TP statement; some for an AP one
        kernels, copies, names = _cuda_activity(lambda: gs.execute(TP_HOST_PROFILED))
        out["tp_profile"] = {"cuda_kernels": kernels, "cuda_copies": copies,
                             "names": names}
        if kernels or copies:
            raise AssertionError(f"tp_host: {TP_HOST_PROFILED} ran on the card: "
                                 f"{out['tp_profile']}")
        ms = Session(inst, "tpch")
        kernels, copies, names = _cuda_activity(lambda: ms.execute(TP_HOST_AP_CONTROL))
        out["ap_profile"] = {"cuda_kernels": kernels, "cuda_copies": copies,
                             "names": names}
        if kernels == 0:
            raise AssertionError("tp_host: the profiler saw no CUDA kernel of the AP "
                                 "control statement")
        step("profiles_s")
        # (d) the engine off at --sf
        out["queries"] = {}
        for q in TP_HOST_QUERIES:
            line = {}
            rows = {}
            for label, flag in (("engine_on", 1), ("engine_off", 0)):
                ms.execute(f"SET ENABLE_TPU_ENGINE = {flag}")
                times = []
                for _ in range(1 + TP_HOST_WARM):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rs = ms.execute(SQL[q])
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1000.0)
                rows[label] = rs.rows
                line[f"{label}_first_ms"] = times[0]
                line[f"{label}_warm_ms"] = times[1:]
            ms.execute("SET ENABLE_TPU_ENGINE = 1")
            ok, floats, worst = _rows_match(rows["engine_off"], rows["engine_on"])
            if not ok:
                raise AssertionError(f"tp_host Q{q}: engine-off rows differ from "
                                     f"engine-on rows: {rows['engine_off'][:2]} vs "
                                     f"{rows['engine_on'][:2]}")
            line.update(rows=len(rows["engine_on"]), float_cells=floats,
                        worst_rel_diff=worst)
            out["queries"][f"Q{q}"] = line
        ms.close()
        step("engine_off_queries_s")
        # (e) the p50 of the host-run TP statement on the card
        times = []
        for _ in range(TP_HOST_P50_RUNS):
            t0 = time.perf_counter()
            gs.execute(TP_HOST_PROFILED)
            times.append((time.perf_counter() - t0) * 1000.0)
        out["tp_p50_ms"] = statistics.median(times)
        out["tp_p99_ms"] = sorted(times)[int(0.99 * len(times)) - 1]
        step("p50_s")
    finally:
        gs.close()
        cs.close()
    after = _launch_counts()
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    out["step_s"] = steps
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the host aggregate output -----------------------------------------------------

HOST_AGG_SETUP = (
    "CREATE DATABASE ha", "USE ha",
    "CREATE TABLE t (id INT PRIMARY KEY, a INT, f DOUBLE)",
    "INSERT INTO t VALUES (1, 10, 0.1), (2, 7, 0.2)",
    "CREATE TABLE s (id INT PRIMARY KEY, a INT, g DOUBLE) PARTITION BY HASH(id) "
    "PARTITIONS 3",
    "INSERT INTO s VALUES " + ", ".join(
        f"({i}, {i % 7}, {(i % 11) / 4})" for i in range(1, 41)),
)
# statement: the reference's rows (ROADMAP Queue 3 item 18 for the first two; the
# JAX package on the CPU gives all four, `tests/test_torch_host_agg.py`)
HOST_AGG_STATEMENTS = {
    "SELECT SUM(f) / 3 FROM t": [(0.10000000397364299,)],
    "SELECT a, COUNT(*) FROM t GROUP BY a HAVING SUM(f) > 0.1": [(7, 1), (10, 1)],
    "SELECT AVG(f) * 3 FROM t": [(0.45000001788139343,)],
    "SELECT a, COUNT(*) FROM t GROUP BY a HAVING AVG(f) * 3 > 0.3 ORDER BY a":
        [(7, 1), (10, 1)],
}
# statements without literals: equal to the CPU instance bit for bit
HOST_AGG_CPU_HELD = (
    "SELECT a, SUM(g) / 3, AVG(g) * 3, MAX(g) / 7 FROM s GROUP BY a ORDER BY a",
    "SELECT a, COUNT(*) FROM s GROUP BY a HAVING SUM(g) > 6.25 ORDER BY a",
    "SELECT x * 3 FROM (SELECT SUM(g) AS x FROM s WHERE a < 3 UNION ALL "
    "SELECT AVG(f) FROM t) v ORDER BY 1",
)


def host_agg_phase():
    """HOST_AGG_STATEMENTS and HOST_AGG_CPU_HELD on a fresh card instance: each
    aggregate's output pulled to the host and the work above it run with numpy, the
    rows equal to a fresh CPU instance's bit for bit and to the reference's
    literals; the finalize's pull on the card."""
    from galaxysql_tpu_torch.chunk.batch import HOST_TIER_STATS
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    t_phase = time.perf_counter()
    launches0 = _launch_counts()
    gs = Session(_frag_off(Instance(device="cuda")))
    cs = Session(_frag_off(Instance(device="cpu")))
    out = {"statements": {}}
    try:
        for sql in HOST_AGG_SETUP:
            gs.execute(sql)
            cs.execute(sql)
        for sql in list(HOST_AGG_STATEMENTS) + list(HOST_AGG_CPU_HELD):
            tier0 = dict(HOST_TIER_STATS)
            got = gs.execute(sql)
            tier = {k: HOST_TIER_STATS[k] - tier0[k] for k in tier0}
            want = cs.execute(sql).rows
            if got.rows != want:
                raise AssertionError(f"host_agg: {sql}: card {got.rows} != CPU {want}")
            ref = HOST_AGG_STATEMENTS.get(sql)
            if ref is not None and got.rows != ref:
                raise AssertionError(f"host_agg: {sql}: card {got.rows} != the "
                                     f"reference's {ref}")
            if tier["pull_bytes"] == 0 or tier["numpy_runs"] == 0:
                raise AssertionError(f"host_agg: {sql}: no aggregate output came to the "
                                     f"host, or nothing above it ran numpy ({tier})")
            out["statements"][sql] = {"rows": got.rows, "reference": ref is not None,
                                      **tier}
    finally:
        gs.close()
        cs.close()
    after = _launch_counts()
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- writes and transactions -----------------------------------------------------------

def _both(s_gpu, s_cpu, sql, what):
    """`sql` on the card's session, then on the CPU's; the results must be equal.
    Returns (the card's result, its ms on the host clock ending in a sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = s_gpu.execute(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    want = s_cpu.execute(sql)
    ok, _f, _w = _rows_match(got.rows, want.rows)
    if not ok or got.affected != want.affected:
        raise AssertionError(f"{what}: the card and the CPU differ (affected "
                             f"{got.affected} / {want.affected}):\n  cuda "
                             f"{got.rows[:3]}\n  cpu  {want.rows[:3]}")
    return got, ms


def _conflicts(s, sql) -> bool:
    from galaxysql_tpu_torch.utils import errors
    try:
        s.execute(sql)
    except errors.TransactionError:
        return True
    return False


def _cache_line(inst, since):
    c = inst.device_cache
    return {"device_cache_bytes": c.nbytes, "device_cache_misses": c.misses - since[0],
            "device_cache_hits": c.hits - since[1]}


def dml_tpch(src_inst, sf, held, analyzed):
    """(a) refresh in a transaction, (b) rollback, (c) conflict, on fresh copies that
    take the statistics of `analyzed` (analyzed_tpch's card instance, the same
    lanes)."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch, tpch_refresh
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi, gw = _copy_instance(src_inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cuda")
    ci, cw = _copy_instance(src_inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cpu")
    gr, cr = Session(gi, "tpch"), Session(ci, "tpch")
    # statistics first, as a deployment has them: the plans are analyzed_tpch's
    line = {"statistics_ms": _take_statistics(analyzed, gi, "tpch", tpch.TABLE_ORDER)}
    _take_statistics(analyzed, ci, "tpch", tpch.TABLE_ORDER)
    say("dml_step", step="copies")
    inside_q = (1, 3, 18)
    # a cut for time: before the refresh the card alone runs them, held to
    # analyzed_tpch's rows on the same lanes (Q1 and Q3 held to the CPU there) and
    # Q18 to numpy
    before = {q: gr.execute(SQL[q]).rows for q in inside_q}
    want18 = q18_numpy(gi)
    if not _rows_match(before[18], want18)[0] or len(want18) == 0:
        raise AssertionError(f"Q18 differs from numpy before the refresh:\n  cuda "
                             f"{before[18][:3]}\n  numpy {want18[:3]}")
    line["q18_numpy_rows"] = len(want18)
    say("dml_step", step="before_refresh")
    for q, rows in held.items():  # analyzed_tpch's card rows, on the same lanes
        if not _rows_match(rows, before[q])[0]:
            raise AssertionError(f"Q{q}: analyzed_tpch's rows differ from the dml "
                                 "phase's before its refresh")
    since = (gi.device_cache.misses, gi.device_cache.hits)

    keys = np.concatenate([p.lanes["o_orderkey"]
                           for p in gi.store("tpch", "orders").partitions])
    rows = tpch_refresh.rf1_rows(sf * DML_RF_SF, int(keys.max()))
    rf1 = tpch_refresh.rf1_statements(rows)
    rf2 = tpch_refresh.rf2_statements(tpch_refresh.rf2_keys(sf * DML_RF_SF, keys))
    _both(gw, cw, "BEGIN", "BEGIN")
    rf1_ms, rf2_ms, affected = [], [], []
    for sql in rf1:
        rs, ms = _both(gw, cw, sql, "RF1")
        rf1_ms.append(ms)
        affected.append(rs.affected)
    for sql in rf2:
        rs, ms = _both(gw, cw, sql, "RF2")
        rf2_ms.append(ms)
        affected.append(rs.affected)
    n_orders = tpch_refresh.refresh_orders(sf * DML_RF_SF)
    n_lines = len(rows["lineitem"]["l_orderkey"])
    if sum(affected[:len(rf1)]) != n_orders + n_lines or affected[-1] != n_orders:
        raise AssertionError(f"refresh affected {affected}")
    inside, inside_ms, outside_ms = {}, {}, {}
    for q in inside_q:
        if q in DML_CARD_ONLY:
            rs, inside_ms[f"Q{q}"] = _timed(gw, SQL[q])
        else:
            rs, inside_ms[f"Q{q}"] = _both(gw, cw, SQL[q], f"Q{q} inside the refresh")
        inside[f"Q{q}"] = rs.rows  # after COMMIT the card's rows are held to these
        if q == 1 and rs.rows == before[q]:
            raise AssertionError("Q1 inside the refresh does not see its writes")
        # held to its rows from before the refresh, which the CPU gave too
        rs, outside_ms[f"Q{q}"] = _timed(gr, SQL[q])
        if rs.rows != before[q]:
            raise AssertionError(f"Q{q} in the other session does not see the snapshot "
                                 "from before the refresh")
    _rs, commit_ms = _both(gw, cw, "COMMIT", "COMMIT")
    line.update(rf1_statements=len(rf1), rf1_rows={"orders": n_orders,
                                                   "lineitem": n_lines},
                rf1_ms=rf1_ms, rf2_ms=rf2_ms, rf2_rows_deleted=affected[len(rf1):],
                inside_ms=inside_ms, other_session_ms=outside_ms, commit_ms=commit_ms)
    say("dml_step", step="refresh")
    after = run_phase(gw, cw, "tpch", {f"Q{q}": SQL[q] for q in range(1, 23)},
                      reset=False, cpu_queries={f"Q{q}" for q in DML_CPU_QUERIES},
                      held=inside)
    line["after_commit"] = {k: after[k] for k in (
        "query_ms", "first_run_ms", "launches_per_query", "result_rows", "cpu_ms",
        "spilled_per_query", "float_cells", "max_float_rel_diff", "equal")}
    line["after_commit"]["query_ms_sum"] = sum(after["query_ms"].values())
    line["after_commit"]["first_run_ms_sum"] = sum(after["first_run_ms"].values())
    line.update(_cache_line(gi, since))
    say("dml_step", step="after_commit")

    # (b) rollback, on the card alone: its rows after ROLLBACK are held to its rows
    # from before, which the CPU gave; the twin, which never ran it, holds the same
    # state again after the ROLLBACK.  The binlog capture of each statement (its
    # row images, buffered on the transaction and dropped by ROLLBACK) is timed.
    rb_q = (4, 6)
    before = {q: _both(gw, cw, SQL[q], f"Q{q} before the rollback")[0].rows
              for q in rb_q}
    rb = {}
    logged = gi.metadb.query("SELECT count(*) FROM binlog_events")[0][0]
    with _Timer(gi.cdc, "capture_rows") as capture:
        for sql in ("BEGIN",
                    "UPDATE lineitem SET l_discount = l_discount + 0.01 "
                    "WHERE l_shipdate < DATE '1992-04-01'",
                    "DELETE FROM orders WHERE o_orderdate < DATE '1992-03-01'"):
            c0 = capture.line()
            rs, ms = _timed(gw, sql)
            c1 = capture.line()
            rb[sql.split()[0].lower()] = {
                "ms": ms, "affected": rs.affected,
                "capture_ms": c1["ms"] - c0["ms"],
                "capture_events": c1["calls"] - c0["calls"],
                "capture_payload_bytes": c1["payload_bytes"] - c0["payload_bytes"]}
    for q in rb_q:
        _rs, rb[f"Q{q}_inside_ms"] = _timed(gw, SQL[q])
    _rs, rb["rollback_ms"] = _timed(gw, "ROLLBACK")
    for q in rb_q:
        rs, rb[f"Q{q}_after_ms"] = _timed(gw, SQL[q])
        if rs.rows != before[q]:
            raise AssertionError(f"Q{q} after ROLLBACK differs from before the "
                                 "transaction")
    if gi.metadb.query("SELECT count(*) FROM binlog_events")[0][0] != logged:
        raise AssertionError("the rolled-back transaction reached the binlog")
    line["rollback"] = rb
    say("dml_step", step="rollback")

    # (c) conflict: first writer wins
    key = int(keys[len(keys) // 2])
    upd = f"UPDATE orders SET o_comment = 'conflict' WHERE o_orderkey = {key}"
    _both(gw, cw, "BEGIN", "BEGIN")
    _both(gw, cw, f"UPDATE orders SET o_comment = 'writer' WHERE o_orderkey = {key}",
          "the writer's update")
    if not (_conflicts(gr, upd) and _conflicts(cr, upd)):
        raise AssertionError("the second writer's update did not raise TransactionError")
    _both(gw, cw, "COMMIT", "COMMIT")
    rs, _ms = _both(gr, cr, upd, "the retry")
    if rs.affected != 1:
        raise AssertionError("the retry after COMMIT did not update the row")
    line["conflict"] = {"raised": "TransactionError", "retry_affected": rs.affected}
    line["tpch_peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    return line


def dml_oltp(seed=20241017):
    """(d) The sysbench oltp_read_write mix on one table of DML_OLTP_ROWS rows."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import sysbench
    gi = _frag_off(Instance(device="cuda"))
    gs = Session(gi)
    gs.execute("CREATE DATABASE sbtest")
    gs.execute("USE sbtest")
    gs.execute(sysbench.ddl())
    t0 = time.perf_counter()
    gi.store("sbtest", "sbtest1").insert_arrays(sysbench.generate(DML_OLTP_ROWS, seed),
                                                gi.tso.next_timestamp())
    load_ms = (time.perf_counter() - t0) * 1000.0
    _ci, cs = _copy_instance(gi, "sbtest", ["sbtest1"], {"sbtest1": sysbench.ddl()},
                             "cpu")
    since = (gi.device_cache.misses, gi.device_cache.hits)
    rng = np.random.default_rng(seed)
    kinds, txn_ms = {}, []
    for _ in range(OLTP_TRANSACTIONS):
        total = 0.0
        for kind, sql in sysbench.transaction(rng, DML_OLTP_ROWS):
            rs, ms = _both(gs, cs, sql, f"oltp {kind}")
            if kind in ("index_update", "non_index_update", "delete", "insert") \
                    and rs.affected != 1:
                raise AssertionError(f"oltp {kind} affected {rs.affected} rows")
            kinds.setdefault(kind, []).append(ms)
            total += ms
        txn_ms.append(total)
    line = {"rows": DML_OLTP_ROWS, "transactions": OLTP_TRANSACTIONS, "load_ms": load_ms,
            "statement_ms_median": {k: statistics.median(v) for k, v in kinds.items()},
            "statement_ms_max": {k: max(v) for k, v in kinds.items()},
            "statements": {k: len(v) for k, v in kinds.items()},
            "transaction_ms": txn_ms,
            "transaction_ms_median": statistics.median(txn_ms),
            "dictionary_c_values": len(gi.catalog.table("sbtest", "sbtest1")
                                       .dictionaries["c"]),
            "peak_device_bytes": int(torch.cuda.max_memory_allocated())}
    line.update(_cache_line(gi, since))
    return line


def dml_phase(inst, sf, held, analyzed):
    import torch
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    line = dml_tpch(inst, sf, held, analyzed)
    say("dml_step", step="conflict")
    line["oltp"] = dml_oltp()
    line["launches"] = _launch_counts()
    line["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    line["seconds"] = time.perf_counter() - t0
    missing = [k for k in KERNELS if line["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in dml: {missing}")
    return line


# -- the TP point-query path ------------------------------------------------------------

def _pct(values, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _sequential(s_gpu, s_cpu, stmts):
    """Statements one after another from one session of each instance: the first
    is planned (and registers the PointPlan), the rest take the fast path.  Rows
    must be equal on the card and the CPU."""
    import torch
    ms = []
    for sql in stmts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = s_gpu.execute(sql).rows
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
        want = s_cpu.execute(sql).rows
        if got != want:
            raise AssertionError(f"{sql}: the card and the CPU differ: {got} / {want}")
    if not any(t.startswith("point-plan") for t in s_gpu.last_trace[:2]):
        raise AssertionError(f"the fast path did not serve {stmts[-1]}: "
                             f"{s_gpu.last_trace}")
    return {"statements": len(stmts), "first_run_ms": ms[0],
            "fast_p50_ms": _pct(ms[1:], 50), "fast_p99_ms": _pct(ms[1:], 99),
            "fast_max_ms": max(ms[1:])}


def _closed_loop(inst, schema, stmt, n_sessions, per_session, expected):
    """`n_sessions` sessions each running `per_session` statements `stmt(i, j)` back
    to back (`_storm`); every row must equal `expected[sql]`.  Returns the QPS and
    per-statement latencies."""
    scripts = [[(sql, lambda rows, want=expected[sql]: rows == want)
                for sql in (stmt(i, j) for j in range(per_session))]
               for i in range(n_sessions)]
    sheds0 = CLIENT_SHEDS["count"]
    flat, wall = _storm(inst, schema, scripts)
    return {"qps": len(flat) / wall, "p50_ms": _pct(flat, 50), "p99_ms": _pct(flat, 99),
            "seconds": wall, "sheds_retried": CLIENT_SHEDS["count"] - sheds0}


def _concurrent(gi, schema, stmt, expected, sessions, per_session):
    """The closed loop with the batch scheduler on (adaptive window) and off, after
    one short untimed loop with it on, and the scheduler's counters and group sizes
    of each timed run."""
    import statistics as st
    sched = gi.batch_scheduler
    out = {}
    # ramp, not timed: the first flush of each partition builds its sorted device
    # lanes, as every first flush after a write does
    gi.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    _closed_loop(gi, schema, stmt, sessions, 2, expected)
    for on in (1, 0):
        gi.config.set_instance("ENABLE_BATCH_SCHEDULER", on)
        before = dict(sched.counts)
        n_groups = len(sched.group_sizes)
        line = _closed_loop(gi, schema, stmt, sessions, per_session, expected)
        line.update({k: sched.counts[k] - before[k] for k in sched.counts})
        groups = list(sched.group_sizes)[n_groups:]
        line["group_size_mean"] = st.mean(groups) if groups else 0.0
        line["group_size_p50"] = st.median(groups) if groups else 0.0
        out["batching_on" if on else "batching_off"] = line
    gi.config.set_instance("ENABLE_BATCH_SCHEDULER", 1)
    if out["batching_on"]["batch_fallbacks"]:
        raise AssertionError(f"{out['batching_on']['batch_fallbacks']} batch members fell "
                             f"back to the sequential path: {list(sched.trace)[-3:]}")
    return out


def _flush(gi, pid, vals):
    """`batched_point_lookup` of `vals` against partition `pid` of the card's
    sbtest1: its CSR must be identical to `_host_batched_point` on the same
    partition.  Whole-call ms (host clock, median of 20) and the card's time for
    the device program alone (`_device_ms`)."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.chunk.batch import as_tensor
    from galaxysql_tpu_torch.exec import operators as ops
    store = gi.store("sbtest", "sbtest1")
    tm = store.table
    part = store.partitions[pid]
    snap = gi.tso.next_timestamp()

    def call():
        return ops.batched_point_lookup(store, pid, part, "id", tm.version, vals, snap,
                                        0, device_cache=gi.device_cache)

    ids, offs = call()
    with part.lock:
        want_ids, want_offs = ops._host_batched_point(part, "id", vals, snap, 0)
        n0 = part.key_index("id")[0]
    if not (np.array_equal(ids, want_ids) and np.array_equal(offs, want_offs)):
        raise AssertionError(f"batched_point_lookup at B={len(vals)} differs from "
                             "_host_batched_point")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1000.0)
    cap = ops.bucket_capacity(max(n0, 1))
    sig = f"id::{part.lane_gen}.{n0}"

    def not_cached():
        raise AssertionError(f"the flush's sorted lanes of partition {pid} are not in "
                             "the device cache")

    # the device program's inputs, as the calls above cached them
    lanes = [gi.device_cache.get_lane_built(store, pid, f"{name}::{sig}", tm.version,
                                            cap, not_cached)
             for name in ("bp_keys", "bp_begin", "bp_end")]
    B = ops.batch_key_bucket(len(vals))
    keys = np.full(B, ops._lane_pad_value(part.lanes["id"].dtype),
                   dtype=part.lanes["id"].dtype)
    keys[:len(vals)] = vals
    kt = as_tensor(keys, gi.device)
    device = _device_ms(lambda: ops._batched_point_program(*lanes, kt, snap, 0))
    torch.cuda.synchronize()
    per_key = np.diff(offs)
    return {"keys": len(vals), "bucket": B, "partition_rows": part.num_rows,
            "index_n0": n0, "tail_rows": part.num_rows - n0, "rows_found": int(ids.size),
            "overflow_keys": int(sum(part.key_candidates("id", v).size > ops.BATCH_MAXDUP
                                     for v in vals)),
            "missing_keys": int((per_key == 0).sum()),
            "call_ms": statistics.median(times), "device_ms": device, "csr_equal": True}


def point_phase(tpch_inst, seed=20241017, device="cuda"):
    """(a) sequential oltp_point_select and orders point selects, (b) closed loops of
    POINT_SESSIONS threads with the scheduler on and off, (c) flushes at
    FLUSH_KEYS keys, (d) point selects after writes and in an open transaction."""
    import numpy as np
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import sysbench, tpch
    t0 = time.perf_counter()
    gi = _frag_off(Instance(device=device))
    gs = Session(gi)
    gs.execute("CREATE DATABASE sbtest")
    gs.execute("USE sbtest")
    gs.execute(sysbench.ddl())
    gi.store("sbtest", "sbtest1").insert_arrays(sysbench.generate(OLTP_ROWS, seed),
                                                gi.tso.next_timestamp())
    ci, cs = _copy_instance(gi, "sbtest", ["sbtest1"], {"sbtest1": sysbench.ddl()}, "cpu")
    go, gos = _copy_instance(tpch_inst, "tpch", ["orders"], tpch.TPCH_DDL, device)
    co, cos = _copy_instance(tpch_inst, "tpch", ["orders"], tpch.TPCH_DDL, "cpu")
    line = {"setup_s": time.perf_counter() - t0}
    rng = np.random.default_rng(seed)

    # (a) sequential
    line["sequential"] = {"sbtest1": _sequential(
        gs, cs, sysbench.point_select(rng, OLTP_ROWS, POINT_STATEMENTS))}
    okeys = np.concatenate([p.lanes["o_orderkey"]
                            for p in go.store("tpch", "orders").partitions])
    okeys = np.sort(okeys)[::max(1, okeys.size // 4096)]
    otpl = "select o_totalprice from orders where o_orderkey = %d"
    line["sequential"]["orders"] = _sequential(
        gos, cos, [otpl % int(k) for k in rng.choice(okeys, POINT_STATEMENTS // 4)])
    line["sequential"]["point_plan_queries"] = {
        "sbtest1": gi.counters["point_plan_queries"],
        "orders": go.counters["point_plan_queries"]}
    if not all(line["sequential"]["point_plan_queries"].values()):
        raise AssertionError("no point select was served by the fast path")

    # (b) concurrent: each statement's rows from the CPU instance, sequentially
    per = max(POINT_PER_SESSION.values())
    ids = rng.integers(1, OLTP_ROWS + 1, max(POINT_SESSIONS) * per)
    sb_stmt = {n: (lambda i, j: f"SELECT c FROM sbtest1 WHERE id="
                                f"{int(ids[(i * per + j) % ids.size])}")
               for n in POINT_SESSIONS}
    o_stmt = lambda i, j: otpl % int(okeys[(i * 31 + j * 7) % okeys.size])  # noqa: E731
    expected = {}
    for n in POINT_SESSIONS:
        for i in range(n):
            for j in range(POINT_PER_SESSION[n]):
                for sql, sess in ((sb_stmt[n](i, j), cs), (o_stmt(i, j), cos)):
                    if sql not in expected:
                        expected[sql] = sess.execute(sql).rows
    line["concurrent"] = {}
    for n in POINT_SESSIONS:
        line["concurrent"][f"sbtest1_{n}"] = _concurrent(gi, "sbtest", sb_stmt[n],
                                                         expected, n,
                                                         POINT_PER_SESSION[n])
        line["concurrent"][f"orders_{n}"] = _concurrent(go, "tpch", o_stmt, expected, n,
                                                        POINT_PER_SESSION[n])
    top = max(POINT_SESSIONS)
    for table in ("sbtest1", "orders"):
        if line["concurrent"][f"{table}_{top}"]["batching_on"]["batch_flushes"] == 0:
            raise AssertionError(f"no batch flush at {top} sessions on {table}")

    # (c) flushes: an id with 10 versions inside the sorted index, then a tail
    store = gi.store("sbtest", "sbtest1")
    hot = int(ids[0])
    pid = next(i for i, p in enumerate(store.partitions) if (p.lanes["id"] == hot).any())
    for k in range(9):
        _both(gs, cs, f"UPDATE sbtest1 SET k=k+1 WHERE id={hot}", "an UPDATE of k")
    for inst in (gi, ci):
        p = inst.store("sbtest", "sbtest1").partitions[pid]
        with p.lock:
            p.invalidate_indexes()  # the index is rebuilt over the 10 versions
            p.key_index("id")
    new_ids = list(range(OLTP_ROWS + 1, OLTP_ROWS + 401))
    values = ", ".join(f"({i}, {i % 1000}, 'tail-{i}', 'pad')" for i in new_ids)
    _both(gs, cs, f"INSERT INTO sbtest1 (id, k, c, pad) VALUES {values}", "the tail")
    part = store.partitions[pid]
    in_pid = [int(v) for v in np.unique(part.lanes["id"])]
    tail = sorted(set(new_ids) & set(in_pid))
    flush_keys = [hot] + tail[:8] + [OLTP_ROWS + 10_000 + i for i in range(8)]
    pool = [int(v) for v in rng.choice(in_pid, max(FLUSH_KEYS))]
    line["flush"] = []
    for B in FLUSH_KEYS:
        vals = (flush_keys + pool)[:B]
        line["flush"].append(_flush(gi, pid, vals))
    if not (line["flush"][-1]["overflow_keys"] and line["flush"][-1]["tail_rows"]):
        raise AssertionError("the flush inputs hold no overflowing id or no tail")

    # (d) after writes: an UPDATE of c, a DELETE and re-INSERT, an open transaction
    upd, victim, own = (int(v) for v in ids[1:4])
    _both(gs, cs, f"UPDATE sbtest1 SET c='after-{upd}' WHERE id={upd}", "UPDATE c")
    _both(gs, cs, f"DELETE FROM sbtest1 WHERE id={victim}", "DELETE")
    _both(gs, cs, f"INSERT INTO sbtest1 (id, k, c, pad) VALUES ({victim}, 1, "
                  f"'again-{victim}', 'pad')", "re-INSERT")
    gw, cw = Session(gi, "sbtest"), Session(ci, "sbtest")
    _both(gw, cw, "BEGIN", "BEGIN")
    _both(gw, cw, f"UPDATE sbtest1 SET c='own-{own}' WHERE id={own}", "the own UPDATE")
    pt = "SELECT c FROM sbtest1 WHERE id=%d"
    rs, _ms = _both(gw, cw, pt % own, "own write")
    if rs.rows != [(f"own-{own}",)] or \
            not any(t.startswith("point-plan") for t in gw.last_trace[:2]):
        raise AssertionError(f"the writer does not see its own write: {rs.rows}")
    watch = [upd, victim, own, hot] + tail[:8] + new_ids[-8:]
    expected = {pt % k: cs.execute(pt % k).rows for k in watch}
    other = gs.execute(pt % own).rows
    if other != expected[pt % own] or other == [(f"own-{own}",)]:
        raise AssertionError(f"another session sees the open transaction's write: "
                             f"{other}")
    for k in (upd, victim):
        if expected[pt % k] != [((f"after-{k}" if k == upd else f"again-{k}"),)]:
            raise AssertionError(f"id {k} after writes: {expected[pt % k]}")
    before = gi.batch_scheduler.counts["batched_queries"]
    after = _concurrent(gi, "sbtest", lambda i, j: pt % watch[(i + j) % len(watch)],
                        expected, 64, 4)
    if gi.batch_scheduler.counts["batched_queries"] == before:
        raise AssertionError("no batched point select after the writes")
    for k in watch:
        _both(gs, cs, pt % k, "a sequential point select after writes")
    _both(gw, cw, "COMMIT", "COMMIT")
    rs, _ms = _both(gs, cs, pt % own, "after COMMIT")
    if rs.rows != [(f"own-{own}",)]:
        raise AssertionError("the committed write is not seen")
    line["after_writes"] = {"watched_ids": len(watch), **after}
    line["scheduler"] = dict(gi.batch_scheduler.stats_rows())
    line["counters"] = {"sbtest1": dict(gi.counters), "orders": dict(go.counters)}
    line["seconds"] = time.perf_counter() - t0
    return line, (gi, ci)


# -- the MySQL wire front end ----------------------------------------------------------

class _Served:
    """The port's `MySQLServer`s on one asyncio loop in a thread of this script."""

    def __init__(self, servers):
        import asyncio
        import threading
        self.servers = servers
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        failed = []

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                for srv in servers:
                    self.loop.run_until_complete(srv.start())
            except BaseException as e:  # carried to the caller
                failed.append(e)
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(60) or failed:
            self.stop()
            raise RuntimeError(f"the wire server did not start: {failed}")

    def stop(self):
        import asyncio

        async def _stop():
            for srv in self.servers:
                await srv.stop()
        if self.loop.is_running():
            asyncio.run_coroutine_threadsafe(_stop(), self.loop).result(30)
            self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


def _from_wire(value, typ):
    """A value as the client decoded it, back to the engine's Python value: the
    text protocol carries `repr` of floats and `str` of the rest, the binary
    protocol integers and doubles as themselves, decimals as text."""
    from galaxysql_tpu_torch.types import datatype as dt
    if value is None or not isinstance(value, str):
        return value
    if typ.clazz in (dt.TypeClass.INT, dt.TypeClass.UINT):
        return int(value)
    if typ.clazz in (dt.TypeClass.DECIMAL, dt.TypeClass.FLOAT):
        return float(value)
    return value


def _node_rows(lines):
    """(plan line without its `(actual ...)` suffix, actual rows) per plan node of an
    EXPLAIN ANALYZE, and each `RuntimeFilter(column, kinds, pruned=n)` line as it
    is (None for its rows)."""
    import re
    out = []
    for line in lines:
        if line.startswith("--"):
            continue
        if line.strip().startswith("RuntimeFilter("):
            out.append((line.strip(), None))
            continue
        m = re.match(r"^(.*?)  \(actual rows=(\d+) ", line)
        if m is None:
            raise AssertionError(f"an EXPLAIN ANALYZE node without counts: {line}")
        out.append((m.group(1), int(m.group(2))))
    return out


def _wire_queries(port, s_gpu):
    """Q1, Q3, Q5 and Q6 over the wire, in the text protocol and as prepared
    statements, WIRE_REPEATS times each after one untimed run: every answer converted
    back must equal the in-process rows of the same instance, timed the same way."""
    import torch
    from galaxysql_tpu_torch.net.client import MiniClient
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    c = MiniClient("127.0.0.1", port, database="tpch", timeout=300)
    out = {}
    try:
        for q in QUERIES:
            rs = s_gpu.execute(SQL[q])
            want, types = rs.rows, rs.types
            sid = c.prepare(SQL[q])
            runs = {"text": lambda: c.query(SQL[q]), "prepared": lambda: c.execute(sid, [])}
            times = {"in_process": []}
            for mode, fn in runs.items():
                times[mode] = []
                for k in range(WIRE_REPEATS + 1):
                    t0 = time.perf_counter()
                    names, rows = fn()
                    ms = (time.perf_counter() - t0) * 1000.0
                    got = [tuple(_from_wire(v, t) for v, t in zip(r, types)) for r in rows]
                    if names != rs.names or got != want:
                        raise AssertionError(f"Q{q} over the wire ({mode}) differs from "
                                             f"the in-process rows: {got[:2]} / {want[:2]}")
                    if k:
                        times[mode].append(ms)
            for _ in range(WIRE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if s_gpu.execute(SQL[q]).rows != want:
                    raise AssertionError(f"Q{q}: a warm in-process run gave other rows")
                torch.cuda.synchronize()
                times["in_process"].append((time.perf_counter() - t0) * 1000.0)
            out[f"Q{q}"] = {"rows": len(want),
                            **{f"{m}_ms": statistics.median(v) for m, v in times.items()},
                            "runs_ms": times}
    finally:
        c.close()
    return out


def _wire_catalog(port, s_cpu):
    """EXPLAIN ANALYZE of WIRE_EXPLAIN_QUERY, SHOW TABLES, DESCRIBE lineitem and an
    information_schema query over the wire on the card; each must equal the same
    statement on the port's CPU instance over the same lanes (EXPLAIN ANALYZE: the
    node lines and `actual rows` per node)."""
    from galaxysql_tpu_torch.net.client import MiniClient
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    c = MiniClient("127.0.0.1", port, database="tpch", timeout=300)
    out = {}
    try:
        q = WIRE_EXPLAIN_QUERY
        t0 = time.perf_counter()
        _names, lines = c.query("EXPLAIN ANALYZE " + SQL[q])
        out[f"explain_analyze_q{q}_ms"] = (time.perf_counter() - t0) * 1000.0
        lines = [r[0] for r in lines]
        want = [r[0] for r in s_cpu.execute("EXPLAIN ANALYZE " + SQL[q]).rows]
        nodes = _node_rows(lines)
        if nodes != _node_rows(want):
            raise AssertionError(f"EXPLAIN ANALYZE of Q{q} on the card differs from the "
                                 f"CPU:\n{lines}\n{want}")
        out[f"explain_analyze_q{q}"] = lines
        out["explain_analyze_nodes"] = len(nodes)
        info = ("SELECT table_name, table_rows FROM information_schema.tables "
                "WHERE table_schema = 'tpch' ORDER BY table_name")
        for name, sql in (("show_tables", "SHOW TABLES"),
                          ("describe_lineitem", "DESCRIBE lineitem"),
                          ("information_schema_tables", info)):
            rs = s_cpu.execute(sql)
            names, rows = c.query(sql)
            got = [tuple(_from_wire(v, t) for v, t in zip(r, rs.types)) for r in rows]
            if names != rs.names or got != rs.rows:
                raise AssertionError(f"{sql} over the wire on the card differs from the "
                                     f"CPU: {got[:3]} / {rs.rows[:3]}")
            out[name] = rows
    finally:
        c.close()
    return out


def _point_select_clients(port, setting_sql, seed, statements,
                          processes=WIRE_PROCESSES, connections=WIRE_CONNECTIONS):
    """`processes` client processes (`tools/wire_clients.py`) of `connections`
    connections each, all connected and prepared before one start signal; returns
    their JSON lines.  Every process is ended before returning."""
    from galaxysql_tpu_torch.net.client import MiniClient
    c = MiniClient("127.0.0.1", port, database="sbtest", timeout=60)
    c.query(setting_sql)
    c.close()
    procs = []
    try:
        for i in range(processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "galaxysql_tpu_torch.tools.wire_clients",
                 "--port", str(port), "--database", "sbtest",
                 "--connections", str(connections),
                 "--statements", str(statements), "--max-id", str(OLTP_ROWS),
                 "--seed", str(seed * 100 + i)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for p in procs:
            if p.stdout.readline().strip() != "READY":
                raise AssertionError("a wire client did not connect")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        lines = []
        for p in procs:
            out, _ = p.communicate(timeout=300)
            line = json.loads(out.strip().splitlines()[-1])
            if p.returncode or line["errors"]:
                raise AssertionError(f"a wire client failed: {line['errors'][:3]}")
            lines.append(line)
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wire_point_select(gi, port, s_cpu):
    """sysbench `oltp_point_select` over the wire from WIRE_PROCESSES x
    WIRE_CONNECTIONS connections, with `SET GLOBAL ENABLE_BATCH_SCHEDULER` 1 and
    then 0 sent over the wire: QPS, p50/p99, the scheduler's counters and group
    sizes; every `c` must equal the CPU instance's row for its id."""
    import statistics as st
    sched = gi.batch_scheduler
    expected = {}

    def check(results):
        for key, c, _ms in results:
            if key not in expected:
                rows = s_cpu.execute(f"SELECT c FROM sbtest1 WHERE id={key}").rows
                expected[key] = rows[0][0] if rows else None
            if c != expected[key]:
                raise AssertionError(f"id {key} over the wire: {c!r} / {expected[key]!r}")

    # ramp, not timed: the first flush of each partition after the point phase's
    # writes builds its sorted device lanes again (as in that phase's ramp)
    ramp = _point_select_clients(port, "SET GLOBAL ENABLE_BATCH_SCHEDULER = 1",
                                 20241016, WIRE_RAMP_STATEMENTS)
    check([r for line in ramp for r in line["results"]])
    # one connection alone: the wire's own cost per statement, without contention
    one = _point_select_clients(port, "SET GLOBAL ENABLE_BATCH_SCHEDULER = 0", 20241015,
                                WIRE_SERIAL_STATEMENTS, processes=1, connections=1)
    results = one[0]["results"]
    check(results)
    lat = [ms for _k, _c, ms in results]
    out = {"one_connection": {"statements": len(results),
                              "qps": len(results) / (one[0]["end"] - one[0]["start"]),
                              "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99)}}
    for k, on in enumerate((1, 0)):
        before, n_groups = dict(sched.counts), len(sched.group_sizes)
        fast0 = gi.counters["point_plan_queries"]
        lines = _point_select_clients(
            port, f"SET GLOBAL ENABLE_BATCH_SCHEDULER = {on}", 20241017 + k,
            WIRE_STATEMENTS)
        if bool(gi.config.get("ENABLE_BATCH_SCHEDULER")) != bool(on):
            raise AssertionError("SET GLOBAL over the wire did not reach the scheduler")
        results = [r for line in lines for r in line["results"]]
        check(results)
        lat = [ms for _k, _c, ms in results]
        wall = max(ln["end"] for ln in lines) - min(ln["start"] for ln in lines)
        groups = list(sched.group_sizes)[n_groups:]
        served = {name: sched.counts[name] - before[name] for name in sched.counts}
        served["point_plan_queries"] = gi.counters["point_plan_queries"] - fast0
        if served["point_plan_queries"] + served["batched_queries"] != len(results):
            raise AssertionError(f"not every point select took the point path: {served}")
        out["batching_on" if on else "batching_off"] = {
            "statements": len(results), "seconds": wall, "qps": len(results) / wall,
            "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99), "max_ms": max(lat),
            "sheds_retried": sum(ln.get("sheds", 0) for ln in lines),
            **served, "group_size_mean": st.mean(groups) if groups else 0.0,
            "group_size_p50": st.median(groups) if groups else 0.0}
    if out["batching_on"]["batch_flushes"] == 0:
        raise AssertionError("no batch flush over the wire with the scheduler on")
    return out


def wire_phase(tpch_gpu, tpch_cpu, sb_gpu, sb_cpu):
    """The port's MySQL server in front of the main path's card instance and the
    point phase's sbtest1 instance (no new data): TPC-H over the wire, EXPLAIN
    ANALYZE and the catalog statements, then oltp_point_select from client
    processes.  Launch counters are read at the phase's end."""
    from galaxysql_tpu_torch.net.server import MySQLServer
    from galaxysql_tpu_torch.server.session import Session
    t0 = time.perf_counter()
    servers = [MySQLServer(tpch_gpu, port=0, users={"root": ""}, pool_size=WIRE_POOL),
               MySQLServer(sb_gpu, port=0, users={"root": ""}, pool_size=WIRE_POOL)]
    served = _Served(servers)
    s_gpu, s_cpu = Session(tpch_gpu, "tpch"), Session(tpch_cpu, "tpch")
    sb_s_cpu = Session(sb_cpu, "sbtest")
    try:
        line = {"pool_size": WIRE_POOL, "clients": {"processes": WIRE_PROCESSES,
                                                    "connections": WIRE_CONNECTIONS,
                                                    "statements": WIRE_STATEMENTS}}
        line["tpch"] = _wire_queries(servers[0].port, s_gpu)
        line.update(_wire_catalog(servers[0].port, s_cpu))
        line["oltp_point_select"] = _wire_point_select(sb_gpu, servers[1].port,
                                                       sb_s_cpu)
        line["scheduler"] = dict(sb_gpu.batch_scheduler.stats_rows())
    finally:
        for x in (s_gpu, s_cpu, sb_s_cpu):
            x.close()
        served.stop()
    line["launches"] = _launch_counts()
    missing = [k for k in KERNELS if line["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the wire phase: {missing}")
    line["seconds"] = time.perf_counter() - t0
    return line


# -- DDL ----------------------------------------------------------------------------

DDL_JOIN = ("SELECT o_band, o_tag, o_orderstatus, count(*), sum(l_extendedprice) "
            "FROM orders, lineitem WHERE o_orderkey = l_orderkey "
            "GROUP BY o_band, o_tag, o_orderstatus ORDER BY o_band, o_tag, o_orderstatus")
DDL_VIEW = ("CREATE VIEW rev AS SELECT l_orderkey, o_orderdate, o_shippriority, "
            "sum(l_extendedprice * (1 - l_discount)) AS revenue "
            "FROM customer, orders, lineitem "
            "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
            "AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15' "
            "AND l_shipdate > date '1995-03-15' "
            "GROUP BY l_orderkey, o_orderdate, o_shippriority")
DDL_VIEW_QUERY = ("SELECT l_orderkey, revenue, o_orderdate FROM rev "
                  "WHERE o_shippriority = 0 AND revenue > 1000 "
                  "ORDER BY revenue DESC, o_orderdate, l_orderkey LIMIT 20")


def _timed(s, sql):
    """`sql` on one session; (result, ms on the host clock ending in a sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = s.execute(sql)
    torch.cuda.synchronize()
    return rs, (time.perf_counter() - t0) * 1000.0


def _both_raise(s_gpu, s_cpu, sql, what) -> str:
    """`sql` must raise the same error type on the card's and the CPU's session."""
    from galaxysql_tpu_torch.utils import errors
    kinds = []
    for s in (s_gpu, s_cpu):
        try:
            s.execute(sql)
            kinds.append(None)
        except errors.TddlError as e:
            kinds.append(type(e).__name__)
    if kinds[0] is None or kinds[0] != kinds[1]:
        raise AssertionError(f"{what}: expected the same error on both, got {kinds}")
    return kinds[0]


def _recyclebin(s) -> list:
    """SHOW RECYCLEBIN without the parts that hold a clock (the bin name's
    millisecond and counter suffix, the drop time)."""
    import re
    return [(re.sub(r"_\d+_\d+$", "", r[0]), r[1], r[2])
            for r in s.execute("SHOW RECYCLEBIN").rows]


def _store_bytes(inst, store) -> int:
    c = inst.device_cache
    with c._lock:
        return sum(v.numel() * v.element_size() for k, v in c._map.items()
                   if k[0] == store.uid)


def _gsi_rows(inst, schema, table, cols):
    """The visible rows of `cols` in a store, as one sorted int64 array."""
    import numpy as np
    ts = inst.tso.next_timestamp()
    parts = []
    for p in inst.store(schema, table).partitions:
        with p.lock:
            vis = p.visible_mask(ts)
            parts.append(np.stack([p.lanes[c][vis].astype(np.int64) for c in cols], 1))
    a = np.concatenate(parts)
    return a[np.lexsort(a.T[::-1])]


def _ddl_alter(gs, cs, out):
    """(a) ADD COLUMN on orders, an UPDATE of the new columns, a join grouped by
    them (cold, then warm), DROP COLUMN and Q3, RENAME there and back."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    gens = [p.lane_gen for p in gi.store("tpch", "orders").partitions]
    _r, out["add_columns_ms"] = _both(
        gs, cs, "ALTER TABLE orders ADD COLUMN o_band INT DEFAULT 3, "
        "ADD COLUMN o_tag VARCHAR(8) DEFAULT 'x'", "ALTER TABLE ADD COLUMN")
    if not all(p.lane_gen > g for p, g in
               zip(gi.store("tpch", "orders").partitions, gens)):
        raise AssertionError("ADD COLUMN left a partition's lane_gen as it was")
    out["device_cache_bytes_after_alter"] = gi.device_cache.nbytes
    r, out["update_ms"] = _both(gs, cs, "UPDATE orders SET o_band = 5, o_tag = 'y' "
                                "WHERE o_orderkey < 600000", "UPDATE of the new columns")
    out["updated_rows"] = r.affected
    before = _launch_counts()
    r, out["join_first_run_ms"] = _both(gs, cs, DDL_JOIN, "join grouped by new columns")
    _r, out["join_warm_ms"] = _timed(gs, DDL_JOIN)
    if _r.rows != r.rows:
        raise AssertionError("the warm run of the grouped join gave other rows")
    after = _launch_counts()
    out["join_launches"] = {k: after[k] - before[k] for k in after}
    out["join_rows"] = r.rows
    _r, out["drop_column_ms"] = _both(gs, cs, "ALTER TABLE orders DROP COLUMN o_tag",
                                      "ALTER TABLE DROP COLUMN")
    _r, out["q3_after_drop_ms"] = _both(gs, cs, SQL[3], "Q3 after DROP COLUMN")
    _r, out["rename_ms"] = _both(gs, cs, "ALTER TABLE nation RENAME TO nation_x",
                                 "RENAME")
    _both_raise(gs, cs, "SELECT count(*) FROM nation", "nation after RENAME")
    _both(gs, cs, "SELECT count(*) FROM nation_x", "the renamed table")
    _both(gs, cs, "ALTER TABLE nation_x RENAME TO nation", "RENAME back")


def _ddl_gsi(sb_gs, sb_cs, out):
    """(b) a covering GSI on sbtest1: its build, the route, point selects through
    it, DML kept in it under COMMIT and ROLLBACK, its content, DROP INDEX."""
    import numpy as np
    import torch
    gi, ci = sb_gs.instance, sb_cs.instance
    _r, out["create_gsi_ms"] = _timed(
        sb_gs, "CREATE GLOBAL INDEX g_k ON sbtest1 (k) COVERING (c)")
    t0 = time.perf_counter()
    sb_cs.execute("CREATE GLOBAL INDEX g_k ON sbtest1 (k) COVERING (c)")
    out["create_gsi_cpu_ms"] = (time.perf_counter() - t0) * 1000.0
    out["gsi_rows"] = gi.store("sbtest", "sbtest1$g_k").row_count()
    for s in (sb_gs, sb_cs):
        plan = "\n".join(r[0] for r in s.execute(
            "EXPLAIN SELECT c FROM sbtest1 WHERE k = 17").rows)
        if "sbtest1$g_k" not in plan:
            raise AssertionError(f"the point select does not scan the GSI:\n{plan}")
    out["explain"] = plan.splitlines()
    rng = np.random.default_rng(7)
    ks = [int(k) for k in rng.integers(1, OLTP_ROWS + 1, POINT_STATEMENTS // 4)]
    n0 = gi.counters["point_plan_queries"]
    out["gsi_point_select"] = _sequential(
        sb_gs, sb_cs, [f"SELECT c FROM sbtest1 WHERE k = {k}" for k in ks])
    out["gsi_point_select"]["point_plan_queries"] = gi.counters["point_plan_queries"] - n0
    # one transaction committed, one rolled back: INSERT, an UPDATE of k, DELETE
    for j, end in enumerate(("COMMIT", "ROLLBACK")):
        for sql in ("BEGIN",
                    f"INSERT INTO sbtest1 (id, k, c, pad) VALUES "
                    f"({OLTP_ROWS + 5000 + j}, 17, 'gsi-{end}', 'p')",
                    f"UPDATE sbtest1 SET k = 17 WHERE id = {ks[2 * j] % OLTP_ROWS + 1}",
                    f"DELETE FROM sbtest1 WHERE id = {ks[2 * j + 1] % OLTP_ROWS + 1}",
                    "SELECT c FROM sbtest1 WHERE k = 17 ORDER BY c", end,
                    "SELECT c FROM sbtest1 WHERE k = 17 ORDER BY c"):
            _r, ms = _both(sb_gs, sb_cs, sql, f"GSI maintenance ({end})")
            out.setdefault(f"txn_{end.lower()}_ms", []).append(ms)
    for inst, name in ((gi, "card"), (ci, "cpu")):
        if not np.array_equal(_gsi_rows(inst, "sbtest", "sbtest1", ["k", "c", "id"]),
                              _gsi_rows(inst, "sbtest", "sbtest1$g_k",
                                        ["k", "c", "id"])):
            raise AssertionError(f"the GSI's rows differ from sbtest1's ({name})")
    out["gsi_equals_base"] = True
    # a full scan of the GSI table puts its lanes in the device cache
    _both(sb_gs, sb_cs, "SELECT count(*), sum(k) FROM sbtest1$g_k", "GSI table scan")
    gstore = gi.store("sbtest", "sbtest1$g_k")
    out["gsi_cache_bytes"] = _store_bytes(gi, gstore)
    bytes0 = gi.device_cache.nbytes
    _r, out["drop_index_ms"] = _both(sb_gs, sb_cs, "DROP INDEX g_k ON sbtest1",
                                     "DROP INDEX")
    torch.cuda.synchronize()
    out["device_cache_bytes_drop_index"] = [bytes0, gi.device_cache.nbytes]
    if not out["gsi_cache_bytes"] or gi.device_cache.nbytes >= bytes0 or \
            _store_bytes(gi, gstore):
        raise AssertionError(f"DROP INDEX left the GSI's lanes in the device cache: "
                             f"{out['device_cache_bytes_drop_index']}")
    for s in (sb_gs, sb_cs):
        if ("sbtest1$g_k",) in s.execute("SHOW TABLES").rows or \
                "sbtest1$g_k" in "".join(r[0] for r in s.execute(
                    "EXPLAIN SELECT c FROM sbtest1 WHERE k = 17").rows):
            raise AssertionError("sbtest1$g_k survived DROP INDEX")


def _ddl_views(gs, cs, out):
    """(c) CREATE VIEW over a Q3-shaped join and group-by, a query on it, DROP."""
    _r, out["create_view_ms"] = _both(gs, cs, DDL_VIEW, "CREATE VIEW")
    r, out["view_query_first_ms"] = _both(gs, cs, DDL_VIEW_QUERY, "SELECT from the view")
    _r, out["view_query_warm_ms"] = _timed(gs, DDL_VIEW_QUERY)
    out["view_rows"] = len(r.rows)
    _both(gs, cs, "DROP VIEW rev", "DROP VIEW")
    _both_raise(gs, cs, DDL_VIEW_QUERY, "the dropped view")


def _ddl_mdl(gs, cs, out):
    """(e) Q18 on the card in one thread, ALTER TABLE lineitem ADD COLUMN in a
    second: the ALTER waits for the query's shared MDL; both succeed."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    want, out["q18_before_ms"] = _timed(gs, SQL[18])
    lock = gi.mdl._lock("tpch.lineitem")
    box = {}

    def run(key, fn):
        try:
            box[key] = fn()
        except BaseException as e:  # carried to the main thread
            box[key] = e
    for attempt in range(3):
        q_sess, a_sess = Session(gi, "tpch"), Session(gi, "tpch")
        box.clear()
        query = threading.Thread(target=run, args=(
            "query", lambda: (q_sess.execute(SQL[18]).rows, time.perf_counter())))
        query.start()
        while lock.readers == 0 and query.is_alive():
            time.sleep(0.0002)
        t_submit = time.perf_counter()
        alter = threading.Thread(target=run, args=(
            "alter", lambda: (a_sess.execute(
                "ALTER TABLE lineitem ADD COLUMN l_x INT"), time.perf_counter())))
        alter.start()
        waited = False
        while alter.is_alive():
            waited = waited or (lock.writers_waiting > 0 and lock.readers > 0)
            time.sleep(0.0002)
        query.join()
        for k in ("query", "alter"):
            if isinstance(box[k], BaseException):
                raise box[k]
        q_sess.close()
        a_sess.close()
        if waited:
            break
        gs.execute("ALTER TABLE lineitem DROP COLUMN l_x")
        # the twin runs the attempt's ALTERs too, so the job records stay equal
        cs.execute("ALTER TABLE lineitem ADD COLUMN l_x INT")
        cs.execute("ALTER TABLE lineitem DROP COLUMN l_x")
    else:
        raise AssertionError("the ALTER never overlapped the running Q18")
    if box["query"][0] != want.rows:
        raise AssertionError("Q18 beside the ALTER gave other rows than before")
    out["mdl"] = {"alter_waited": True, "attempts": attempt + 1,
                  "query_end_after_submit_ms": (box["query"][1] - t_submit) * 1000.0,
                  "alter_end_after_submit_ms": (box["alter"][1] - t_submit) * 1000.0}
    cs.execute("ALTER TABLE lineitem ADD COLUMN l_x INT")
    _both(gs, cs, "SELECT count(*), sum(l_x) FROM lineitem WHERE l_x IS NULL",
          "the added column")
    _both(gs, cs, "ALTER TABLE lineitem DROP COLUMN l_x", "DROP COLUMN l_x")


def _ddl_recycle(gs, cs, out):
    """(d) DROP TABLE into the bin, FLASHBACK, DROP and PURGE; a scratch database
    created, filled and dropped."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    want, _ms = _both(gs, cs, SQL[3], "Q3 before DROP TABLE")
    cust = gi.store("tpch", "customer")
    cust_bytes = _store_bytes(gi, cust)
    _r, out["drop_table_ms"] = _both(gs, cs, "DROP TABLE customer", "DROP TABLE")
    bins = [_recyclebin(s) for s in (gs, cs)]
    if bins[0] != bins[1] or bins[0] != [("__recycle__customer", "customer", "tpch")]:
        raise AssertionError(f"SHOW RECYCLEBIN: {bins}")
    out["recyclebin"] = bins[0]
    out["q3_dropped_error"] = _both_raise(gs, cs, SQL[3], "Q3 after DROP TABLE")
    _r, out["flashback_ms"] = _both(gs, cs, "FLASHBACK TABLE customer TO BEFORE DROP",
                                    "FLASHBACK")
    misses = gi.device_cache.misses
    r, out["q3_after_flashback_ms"] = _both(gs, cs, SQL[3], "Q3 after FLASHBACK")
    if r.rows != want.rows:
        raise AssertionError("Q3 after FLASHBACK differs from Q3 before DROP TABLE")
    out["flashback_device_cache"] = {
        "store_bytes_before_drop": cust_bytes,
        "store_bytes_after_flashback": _store_bytes(gi, gi.store("tpch", "customer")),
        "q3_misses": gi.device_cache.misses - misses}
    if gi.store("tpch", "customer") is not cust or \
            _store_bytes(gi, cust) < cust_bytes or not cust_bytes:
        raise AssertionError(f"FLASHBACK lost the store's cached lanes: "
                             f"{out['flashback_device_cache']}")
    cust_bytes = _store_bytes(gi, cust)
    _both(gs, cs, "DROP TABLE customer", "DROP TABLE again")
    bytes0 = gi.device_cache.nbytes
    _r, out["purge_ms"] = _both(gs, cs, "PURGE RECYCLEBIN", "PURGE RECYCLEBIN")
    out["device_cache_bytes_purge"] = [bytes0, gi.device_cache.nbytes, cust_bytes]
    if gi.device_cache.nbytes != bytes0 - cust_bytes:
        raise AssertionError(f"PURGE did not free the store's device-cache bytes: "
                             f"{out['device_cache_bytes_purge']}")
    if _recyclebin(gs) or _recyclebin(cs):
        raise AssertionError("the bin is not empty after PURGE RECYCLEBIN")
    t0 = time.perf_counter()
    for sql in ("CREATE DATABASE ddl_scratch",
                "CREATE TABLE ddl_scratch.t (a BIGINT, b VARCHAR(4)) "
                "PARTITION BY HASH(a) PARTITIONS 4",
                "INSERT INTO ddl_scratch.t VALUES (1, 'a'), (2, 'b'), (3, NULL)",
                "SELECT count(*), max(a) FROM ddl_scratch.t",
                "DROP DATABASE ddl_scratch"):
        _both(gs, cs, sql, sql)
    out["scratch_database_ms"] = (time.perf_counter() - t0) * 1000.0
    _both_raise(gs, cs, "SELECT * FROM ddl_scratch.t", "the dropped database")


def ddl_phase(tpch_gpu, tpch_cpu, sb_gpu, sb_cpu):
    """ALTER, GSI, views, MDL and the recycle bin on the instances already loaded;
    every statement on the card and on the CPU, every result equal.  Launch counters
    are read at the phase's end."""
    from galaxysql_tpu_torch.server.session import Session
    t0 = time.perf_counter()
    gs, cs = Session(tpch_gpu, "tpch"), Session(tpch_cpu, "tpch")
    sb_gs, sb_cs = Session(sb_gpu, "sbtest"), Session(sb_cpu, "sbtest")
    out = {}
    steps = (("alter", lambda: _ddl_alter(gs, cs, out)),
             ("gsi", lambda: _ddl_gsi(sb_gs, sb_cs, out)),
             ("views", lambda: _ddl_views(gs, cs, out)),
             ("mdl", lambda: _ddl_mdl(gs, cs, out)),
             ("recycle_bin", lambda: _ddl_recycle(gs, cs, out)))
    try:
        for name, fn in steps:
            s0 = time.perf_counter()
            fn()
            out.setdefault("step_ms", {})[name] = (time.perf_counter() - s0) * 1000.0
            say("ddl_step", step=name, ms=out["step_ms"][name])
        # (f) the job records agree
        for card, cpu in ((gs, cs), (sb_gs, sb_cs)):
            for sql in ("SHOW DDL", "SELECT job_id, schema_name, ddl_sql, state FROM "
                        "information_schema.ddl_jobs ORDER BY job_id"):
                _both(card, cpu, sql, sql)
        out["ddl_jobs"] = [list(r) for r in gs.execute(
            "SELECT job_id, state, ddl_sql FROM information_schema.ddl_jobs "
            "ORDER BY job_id").rows] + [list(r) for r in sb_gs.execute(
                "SELECT job_id, state, ddl_sql FROM information_schema.ddl_jobs "
                "ORDER BY job_id").rows]
    finally:
        for x in (gs, cs, sb_gs, sb_cs):
            x.close()
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the ddl phase: {missing}")
    out["seconds"] = time.perf_counter() - t0
    return out


# -- durable state: a checkpoint and a boot on the card -----------------------------------

def _commit_storm(gi, keys, policy):
    """DURABLE_SESSIONS threads on instance `gi`, one `Session` each under
    TRANSACTION_POLICY `policy`, each committing DURABLE_TXNS transactions of one
    UPDATE of `o_comment` on an order of its own (sessions and threads are made
    before the clock starts).  Returns the COMMIT latencies, (key, comment, txn id,
    acknowledged commit ts) of every transaction and the wall seconds."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    conns = [Session(gi, "tpch") for _ in range(DURABLE_SESSIONS)]
    for c in conns:
        c.execute(f"SET TRANSACTION_POLICY = '{policy}'")
    lat = [[] for _ in conns]
    done = [[] for _ in conns]
    failures = []
    start = threading.Barrier(len(conns) + 1)

    def run(i):
        try:
            start.wait(timeout=120)
            for j in range(DURABLE_TXNS):
                key = int(keys[i * DURABLE_TXNS + j])
                comment = f"durable-{policy.lower()}-{key}"
                conns[i].execute("BEGIN")
                rs = _execute_as_client(
                    conns[i], f"UPDATE orders SET o_comment = '{comment}' "
                              f"WHERE o_orderkey = {key}")
                if rs.affected != 1:
                    raise AssertionError(f"UPDATE of order {key} affected {rs.affected}")
                txn_id = conns[i].txn.txn_id
                t0 = time.perf_counter()
                conns[i].execute("COMMIT")
                lat[i].append((time.perf_counter() - t0) * 1000.0)
                done[i].append((key, comment, txn_id, conns[i]._last_commit_ts))
        except BaseException as e:  # carried to the main thread
            failures.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(conns))]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for c in conns:
        c.close()
    if failures:
        raise failures[0]
    return [x for row in lat for x in row], [x for row in done for x in row], wall


def _check_logged(gi, txn_id, cts):
    got = gi.metadb.tx_log_get(txn_id)
    if got != ("DONE", cts):
        raise AssertionError(f"txn {txn_id} was acknowledged at {cts}; its tx-log row "
                             f"is {got}")


def _durable_writes(gs, cs, keys, out):
    """(a) Acknowledged writes: DURABLE_SESSIONS sessions commit DURABLE_TXNS
    transactions each, under the TSO policy and then under XA, and one session
    DURABLE_SEQUENTIAL transactions one after another (TSO).  Each transaction's
    tx-log row must read DONE at the commit timestamp its session acknowledged.  The
    CPU twin runs the same transactions the same way, after the card.  Returns {key:
    comment} of every acknowledged write."""
    gi = gs.instance
    acked = {}
    n = DURABLE_SESSIONS * DURABLE_TXNS
    for i, policy in enumerate(("TSO", "XA")):
        batches0 = gi.metrics.counter("group_commit_batches").value
        rows0 = gi.metrics.counter("group_committed_txns").value
        part = keys[i * n:(i + 1) * n]
        lat, done, wall = _commit_storm(gi, part, policy)
        batches = gi.metrics.counter("group_commit_batches").value - batches0
        rows = gi.metrics.counter("group_committed_txns").value - rows0
        out[f"concurrent_{policy.lower()}"] = {
            "sessions": DURABLE_SESSIONS, "transactions": len(done),
            "commit_p50_ms": _pct(lat, 50), "commit_p99_ms": _pct(lat, 99),
            "transactions_per_s": len(done) / wall, "seconds": wall,
            # each transaction logs COMMITTED and DONE through the gate
            "group_commit_batches": batches, "group_committed_rows": rows,
            "rows_per_batch": rows / max(batches, 1)}
        for key, comment, txn_id, cts in done:
            _check_logged(gi, txn_id, cts)
            acked[key] = comment
        t0 = time.perf_counter()
        _commit_storm(cs.instance, part, policy)
        out[f"concurrent_{policy.lower()}"]["cpu_twin_seconds"] = time.perf_counter() - t0
    lat = []
    # the binlog write of each COMMIT (`cdc.flush_txn`, one more sqlite commit) is
    # timed inside it
    with _Timer(gi.cdc, "flush_txn") as flush:
        for key in keys[2 * n:2 * n + DURABLE_SEQUENTIAL]:
            key, comment = int(key), f"durable-seq-{int(key)}"
            for s in (gs, cs):
                s.execute("BEGIN")
                if s.execute(f"UPDATE orders SET o_comment = '{comment}' "
                             f"WHERE o_orderkey = {key}").affected != 1:
                    raise AssertionError(f"UPDATE of order {key} missed")
                txn_id = s.txn.txn_id
                t0 = time.perf_counter()
                s.execute("COMMIT")
                if s is gs:
                    lat.append((time.perf_counter() - t0) * 1000.0)
                    _check_logged(gi, txn_id, s._last_commit_ts)
            acked[key] = comment
    out["sequential_tso"] = {"transactions": len(lat), "commit_p50_ms": _pct(lat, 50),
                             "commit_p99_ms": _pct(lat, 99),
                             "commit_mean_ms": statistics.mean(lat),
                             "flush_txn_mean_ms": flush.ms / max(flush.calls, 1)}
    return acked


def _crashes(fn, *args) -> bool:
    from galaxysql_tpu_torch.utils.failpoint import FailPointError
    try:
        fn(*args)
    except FailPointError:
        return True
    return False


def _durable_crash_state(gs, cs, sf, rf2, out):
    """(b) Left in place, unresolved, for the checkpoint: txn A (XA: RF1 at
    DURABLE_RF1_SF x sf, stopped by FP_BEFORE_COMMIT with PREPARED logged), txn B
    (RF2, prepared, COMMITTED logged at a fresh TSO, its stamps not applied) and an
    ALTER job stopped by FP_BEFORE_DDL_TASK before its first task.  The CPU twin ends them as recovery
    must: A rolled back, B committed, the ALTER done.  Returns (A's txn id, B's txn
    id, B's commit ts)."""
    import numpy as np
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch_refresh
    from galaxysql_tpu_torch.txn.xa import participants_of
    from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_BEFORE_COMMIT,
                                                     FP_BEFORE_DDL_TASK)
    gi = gs.instance
    sa, ca = Session(gi, "tpch"), Session(cs.instance, "tpch")
    sb, cb = Session(gi, "tpch"), Session(cs.instance, "tpch")
    for s in (sa, ca):
        s.execute("SET TRANSACTION_POLICY = 'XA'")
    max_key = int(max(np.max(p.lanes["o_orderkey"])
                      for p in gi.store("tpch", "orders").partitions if p.num_rows))
    t0 = time.perf_counter()
    _both(sa, ca, "BEGIN", "BEGIN")
    for sql in tpch_refresh.rf1_statements(tpch_refresh.rf1_rows(sf * DURABLE_RF1_SF,
                                                                 max_key)):
        _both(sa, ca, sql, "RF1 in txn A")
    txn_a = sa.txn.txn_id
    FAIL_POINTS.arm(FP_BEFORE_COMMIT)
    try:
        if not _crashes(sa.execute, "COMMIT"):
            raise AssertionError("txn A's COMMIT passed FP_BEFORE_COMMIT")
    finally:
        FAIL_POINTS.clear()
    ca.execute("ROLLBACK")
    if gi.metadb.tx_log_get(txn_a) != ("PREPARED", 0):
        raise AssertionError(f"txn A logged {gi.metadb.tx_log_get(txn_a)}")
    out["txn_a_ms"] = (time.perf_counter() - t0) * 1000.0

    t0 = time.perf_counter()
    _both(sb, cb, "BEGIN", "BEGIN")
    for sql in tpch_refresh.rf2_statements(rf2):
        _both(sb, cb, sql, "RF2 in txn B")
    txn_b = sb.txn.txn_id
    if not all(sp.prepare() for sp in participants_of(sb.txn)):
        raise AssertionError("txn B's participants did not prepare")
    gi.metadb.tx_log_put(txn_b, "PREPARED")
    commit_b = gi.tso.next_timestamp()
    gi.metadb.tx_log_put(txn_b, "COMMITTED", commit_b)
    sb.txn = None  # the coordinator dies after its commit point, before stamping
    cb.execute("COMMIT")
    out["txn_b_ms"] = (time.perf_counter() - t0) * 1000.0

    alter = "ALTER TABLE supplier ADD COLUMN s_flag BIGINT DEFAULT 7"
    FAIL_POINTS.arm(FP_BEFORE_DDL_TASK, 1)
    try:
        if not _crashes(gs.execute, alter):
            raise AssertionError("the ALTER passed FP_BEFORE_DDL_TASK")
    finally:
        FAIL_POINTS.clear()
    cs.execute(alter)
    out["ddl_jobs_running"] = [list(r) for r in gi.metadb.query(
        "SELECT job_id, ddl_sql FROM ddl_engine WHERE state = 'RUNNING'")]
    if [r[1] for r in out["ddl_jobs_running"]] != [alter]:
        raise AssertionError(f"running DDL jobs: {out['ddl_jobs_running']}")
    for s in (sa, ca, sb, cb):
        s.close()
    out["in_doubt"] = {"a": txn_a, "b": txn_b, "b_commit_ts": commit_b}
    return txn_a, txn_b, commit_b


def _disk_bytes(data_dir):
    """Bytes on disk under `data_dir`, by table directory, and the metadb."""
    out = {}
    for root, _dirs, files in os.walk(data_dir):
        rel = os.path.relpath(root, data_dir)
        for f in files:
            key = f if rel == "." else rel.replace(os.sep, ".")
            out[key] = out.get(key, 0) + os.path.getsize(os.path.join(root, f))
    return out


def _timed_boot(data_dir, device):
    """`Instance(data_dir=..., device=...)`, with its boot split into the catalog, the
    store loads, `recover_persisted` and `ddl_engine.recover` (each wrapped for the
    call).  Returns (instance, whole ms, ms by part, each part's last result)."""
    from galaxysql_tpu_torch.ddl.jobs import DdlEngine
    from galaxysql_tpu_torch.meta.gms import MetaDb
    from galaxysql_tpu_torch.server import instance as instance_mod
    from galaxysql_tpu_torch.storage.table_store import TableStore
    parts = {"catalog": (MetaDb, "load_catalog"), "store_loads": (TableStore, "load"),
             "recover_persisted": (instance_mod, "recover_persisted"),
             "ddl_recover": (DdlEngine, "recover")}
    ms = {k: 0.0 for k in parts}
    results = {}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                results[name] = fn(*args, **kwargs)
                return results[name]
            finally:
                ms[name] += (time.perf_counter() - t0) * 1000.0
        return wrapped

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in parts.values()]
    for name, (owner, attr) in parts.items():
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        t0 = time.perf_counter()
        inst = _frag_off(instance_mod.Instance(data_dir=data_dir, device=device))
        whole = (time.perf_counter() - t0) * 1000.0
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return inst, whole, ms, results


Q5_COLUMNS = {"customer": ("c_custkey", "c_nationkey"),
              "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
              "lineitem": ("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"),
              "supplier": ("s_suppkey", "s_nationkey"),
              "nation": ("n_nationkey", "n_name", "n_regionkey"),
              "region": ("r_regionkey", "r_name")}


def _same_visible(a, b, columns):
    """The visible rows of `columns` (table -> column names) in instance `a` equal
    those in `b`, partition by partition: in row order where the two wrote their
    partitions in the same order, else as sorted rows (concurrent sessions append
    new versions in their own order).  String columns compare by value."""
    import numpy as np
    for table, cols in columns.items():
        ta, tb = a.catalog.table("tpch", table), b.catalog.table("tpch", table)
        for pa, pb in zip(a.store("tpch", table).partitions,
                          b.store("tpch", table).partitions):
            sides = []
            for t, p in ((ta, pa), (tb, pb)):
                with p.lock:
                    vis = p.visible_mask(None)
                    arrs = []
                    for c in cols:
                        lane = p.lanes[c][vis]
                        if t.column(c).dtype.is_string:
                            lane = np.asarray(t.dictionaries[c].values, dtype=object)[lane]
                        arrs.append(np.where(p.valid[c][vis], lane, None)
                                    if not p.valid[c][vis].all() else lane)
                sides.append(arrs)
            same = all(np.array_equal(x, y) for x, y in zip(*sides))
            if not same and all(x.dtype != object for x in sides[0]):
                same = all(np.array_equal(x, y) for x, y in zip(
                    *[[col[np.lexsort(arrs[::-1])] for col in arrs] for arrs in sides]))
            if not same:
                raise AssertionError(f"{table} partition {pa.pid}: the visible rows of "
                                     f"{cols} differ between the card and the CPU")


def durable_phase(tpch_gpu, tpch_cpu, customer, sf):
    """(0) customer again, (a) acknowledged writes, (b) the crash state, (c) the
    checkpoint, (d) a boot on the card, (e) the main path on the booted instance."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch, tpch_refresh, transfer
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gs, cs = Session(tpch_gpu, "tpch"), Session(tpch_cpu, "tpch")
    out = {"data_dir_before": _disk_bytes(tpch_gpu.data_dir)}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        out.setdefault("step_ms", {})[name] = (time.perf_counter() - t0) * 1000.0
        say("durable_step", step=name, ms=out["step_ms"][name])
        return r

    def restore_customer():
        # the ddl phase purged customer; Q3 and Q5 read it
        parts, dicts = customer
        for s in (gs, cs):
            s.execute(tpch.TPCH_DDL["customer"])
            s.instance.install_store(transfer.store_from_arrays(
                s.instance.catalog.table("tpch", "customer"), parts, dicts))
    step("customer", restore_customer)

    orders = tpch_gpu.store("tpch", "orders")
    live = np.concatenate([p.lanes["o_orderkey"][p.visible_mask(None)]
                           for p in orders.partitions])
    rf2 = tpch_refresh.rf2_keys(sf, live)
    keys = np.random.default_rng(20241017).choice(
        np.setdiff1d(live, rf2), 2 * DURABLE_SESSIONS * DURABLE_TXNS + DURABLE_SEQUENTIAL,
        replace=False)
    acked = step("acknowledged_writes", lambda: _durable_writes(gs, cs, keys, out))
    txn_a, txn_b, commit_b = step("crash_state",
                                  lambda: _durable_crash_state(gs, cs, sf, rf2, out))

    def checkpoint():
        t0 = time.perf_counter()
        tpch_gpu.save()
        out["save_ms"] = (time.perf_counter() - t0) * 1000.0
        out["bytes_on_disk"] = _disk_bytes(tpch_gpu.data_dir)
    step("checkpoint", checkpoint)
    out["device_bytes_before_boot"] = int(torch.cuda.memory_allocated())

    gi, boot_ms, parts_ms, results = step(
        "boot", lambda: _timed_boot(tpch_gpu.data_dir, tpch_gpu.device))
    out.update(boot_ms=boot_ms, boot_parts_ms=parts_ms, node_id=gi.node_id)
    recovered = results["recover_persisted"]
    out["recover_persisted"] = {str(k): v for k, v in recovered.items()}
    if recovered != {txn_a: "rolled_back", txn_b: "committed"}:
        raise AssertionError(f"recover_persisted returned {recovered}")
    logged = (gi.metadb.tx_log_get(txn_a), gi.metadb.tx_log_get(txn_b))
    out["tx_log_after_boot"] = [list(x) for x in logged]
    if logged != (("ABORTED", 0), ("DONE", commit_b)):
        raise AssertionError(f"tx log after the boot: {logged}")
    negative = [k for k, st in gi.stores.items()
                if any((p.begin_ts < 0).any() or (p.end_ts < 0).any()
                       for p in st.partitions)]
    if negative:
        raise AssertionError(f"negative stamps left in {negative}")
    out["ddl_resumed"] = results["ddl_recover"]
    if results["ddl_recover"] != [r[0] for r in out["ddl_jobs_running"]]:
        raise AssertionError(f"ddl_engine.recover resumed {results['ddl_recover']}")
    g2 = Session(gi, "tpch")
    cpu_ms = out["after_boot_cpu_ms"] = {}

    def both(sql, what):
        t0 = time.perf_counter()
        rs, ms = _both(g2, cs, sql, what)
        cpu_ms[what] = (time.perf_counter() - t0) * 1000.0 - ms
        return rs, ms
    try:
        def after_boot():
            jobs, out["ddl_jobs_ms"] = both(
                "SELECT job_id, schema_name, ddl_sql, state FROM "
                "information_schema.ddl_jobs ORDER BY job_id", "ddl_jobs")
            if jobs.rows[-1][2:] != (out["ddl_jobs_running"][0][1], "DONE"):
                raise AssertionError(f"the resumed ALTER: {jobs.rows[-1]}")
            nodes = g2.execute("SELECT node_id, role FROM information_schema.node_info")
            if (gi.node_id, "coordinator") not in nodes.rows:
                raise AssertionError(f"node_info lacks this node: {nodes.rows}")
            out["node_info"] = [list(r) for r in nodes.rows]
            misses = gi.device_cache.misses
            for q in DURABLE_QUERIES:
                if q == 5:
                    # the CPU twin's Q5 (no statistics, 7-9 s) is cut: every row
                    # Q5 reads equals the twin's instead (the card's Q5 path is held
                    # to the CPU on the main path, in analyzed_tpch and in dml)
                    t0 = time.perf_counter()
                    _same_visible(gi, tpch_cpu, Q5_COLUMNS)
                    out["q5_inputs_equal_ms"] = (time.perf_counter() - t0) * 1000.0
                    rs, first = _timed(g2, SQL[q])
                else:
                    rs, first = both(SQL[q], f"Q{q} after the boot")
                warm, ms = _timed(g2, SQL[q])
                if warm.rows != rs.rows:
                    raise AssertionError(f"Q{q}'s warm run after the boot differs")
                out.setdefault("first_run_ms", {})[f"Q{q}"] = first
                out.setdefault("query_ms", {})[f"Q{q}"] = ms
            out["first_run_device_cache_misses"] = gi.device_cache.misses - misses
            back, out["read_back_ms"] = both(
                "SELECT o_orderkey, o_comment FROM orders WHERE o_comment "
                "LIKE 'durable-%' ORDER BY o_orderkey", "acknowledged writes")
            if dict(back.rows) != acked or len(back.rows) != len(acked):
                raise AssertionError(f"{len(back.rows)} acknowledged writes read back "
                                     f"of {len(acked)}, or with other comments")
            out["acknowledged_writes"] = len(acked)
            flag, _ms = both("SELECT count(*), min(s_flag), max(s_flag) "
                             "FROM supplier", "s_flag")
            out["s_flag"] = list(flag.rows[0])
            if flag.rows[0][1:] != (7, 7) or \
                    flag.rows[0][0] != tpch_gpu.store("tpch", "supplier").row_count():
                raise AssertionError(f"s_flag after the boot: {flag.rows}")
        step("after_boot", after_boot)
    finally:
        for s in (gs, cs, g2):
            s.close()
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the durable phase: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out, gi


# -- the binlog, batched point writes and async GSI apply --------------------------------

class _Timer:
    """Wraps `owner.attr` (a function or method) for the life of a `with` block and
    sums the ms of its calls; for `cdc.capture_rows` also the payload bytes of the
    events a call left on its transaction (its seventh argument) or its sink."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.ms, self.calls, self.bytes = 0.0, 0, 0

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.attr)
        self.raw = vars(self.owner).get(self.attr)  # as stored: a staticmethod stays one
        self.had = self.raw is not None

        def timed(*args, **kwargs):
            sink = kwargs.get("sink")
            txn = kwargs.get("txn", args[6] if len(args) > 6 else None)
            box = sink if sink is not None else getattr(txn, "cdc_events", None)
            n0 = len(box) if box is not None else 0
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms += (time.perf_counter() - t0) * 1000.0
                self.calls += 1
                if box is not None:
                    self.bytes += sum(len(ev[3]) for ev in box[n0:])
        setattr(self.owner, self.attr,
                staticmethod(timed) if isinstance(self.raw, staticmethod) else timed)
        return self

    def __exit__(self, *exc):
        if self.had:
            setattr(self.owner, self.attr, self.raw)
        else:
            delattr(self.owner, self.attr)  # the instance attribute set above

    def line(self):
        return {"ms": self.ms, "calls": self.calls, "payload_bytes": self.bytes}


# typed admission sheds (`ServerOverloadError`) the script's client loops retried
# after their `retry_after_ms`, as a client of the server does; each phase's line
# reports its own count
CLIENT_SHEDS = {"count": 0}
_SHED_LOCK = None


CLIENT_RETRY_S = 300.0   # how long a client retries a statement after typed sheds


def _backoff_s(retry_after_ms: int, sheds: int) -> float:
    """A client's wait before retrying a shed statement: the server's retry_after_ms
    doubled for each earlier shed of the statement, capped at 1 s, with +-50 %
    jitter (retrying at once from every client would keep the server overloaded)."""
    import random
    ms = min(max(retry_after_ms, 1) * (2 ** min(sheds, 10)), 1000)
    return max(ms, retry_after_ms) * random.uniform(0.5, 1.5) / 1000.0


def _execute_as_client(session, sql):
    """`session.execute(sql)` as a client runs it against an admission-controlled
    server: a typed shed is counted in CLIENT_SHEDS and retried after `_backoff_s`,
    for at most CLIENT_RETRY_S; any other error raises."""
    import threading
    from galaxysql_tpu_torch.utils import errors
    global _SHED_LOCK
    if _SHED_LOCK is None:
        _SHED_LOCK = threading.Lock()
    deadline = time.perf_counter() + CLIENT_RETRY_S
    sheds = 0
    while True:
        try:
            return session.execute(sql)
        except errors.ServerOverloadError as e:
            if time.perf_counter() > deadline:
                raise
            with _SHED_LOCK:
                CLIENT_SHEDS["count"] += 1
            time.sleep(_backoff_s(e.retry_after_ms, sheds))
            sheds += 1


def _storm(inst, schema, scripts, reads=None):
    """One thread and one `Session` per script, started together (sessions and
    threads are made before the clock starts): each runs its statements back to back,
    timed, each a SQL string or a `(sql, check)` pair where `check(rows)` must hold,
    then its untimed `reads`, `(sql, check)` pairs.  A typed admission shed is
    retried as a client retries it (`_execute_as_client`; the timed latency includes
    the retry).  Returns the timed statements' latencies and the wall seconds until
    the last of them ended."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    reads = reads or [[] for _ in scripts]
    conns = [Session(inst, schema) for _ in scripts]
    lat = [[] for _ in scripts]
    ends = [0.0] * len(scripts)
    failures = []
    start = threading.Barrier(len(scripts) + 1)

    def run(i):
        try:
            start.wait(timeout=120)
            for item in scripts[i]:
                sql, check = (item, None) if isinstance(item, str) else item
                t0 = time.perf_counter()
                rows = _execute_as_client(conns[i], sql).rows
                lat[i].append((time.perf_counter() - t0) * 1000.0)
                if check is not None and not check(rows):
                    raise AssertionError(f"session {i}: {sql} gave {rows[:4]}")
            ends[i] = time.perf_counter()
            for sql, check in reads[i]:
                rows = _execute_as_client(conns[i], sql).rows
                if not check(rows):
                    raise AssertionError(f"session {i}: {sql} gave {rows[:4]}")
        except BaseException as e:  # carried to the main thread
            failures.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(scripts))]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    for c in conns:
        c.close()
    if failures:
        raise failures[0]
    return [x for row in lat for x in row], max(ends) - t0


def _sbtest_traffic(gi, rng, live, next_id, tag):
    """CDC_SESSIONS sessions of CDC_PER_SESSION autocommit writes each on keys of
    their own: sysbench's oltp_update_non_index (`SET c`, a column `g_k` covers),
    oltp_insert (ids above the table's) and oltp_delete, in turn.  Returns the
    scripts, each session's reads through `g_k` with their checks, and the ids
    touched."""
    import numpy as np
    per = CDC_PER_SESSION
    n_upd = len(range(0, per, 3))
    n_del = len(range(2, per, 3))
    own = rng.choice(live, CDC_SESSIONS * (n_upd + n_del), replace=False)
    store = gi.store("sbtest", "sbtest1")
    k_of = {}
    for p in store.partitions:
        with p.lock:
            vis = p.visible_mask(None)
            ids = p.lanes["id"][vis]
            sel = np.isin(ids, own)
            k_of.update(zip(ids[sel].tolist(), p.lanes["k"][vis][sel].tolist()))
    scripts, reads, touched = [], [], []
    for i in range(CDC_SESSIONS):
        keys = iter(own[i * (n_upd + n_del):(i + 1) * (n_upd + n_del)].tolist())
        script, checks = [], []
        for j in range(per):
            if j % 3 == 0:
                rid, c = next(keys), f"cdc-{tag}-{i}-{j}"
                script.append(f"UPDATE sbtest1 SET c = '{c}' WHERE id = {rid}")
                checks.append((f"SELECT id, c FROM sbtest1 WHERE k = {k_of[rid]}",
                               lambda rows, r=(rid, c): r in rows))
            elif j % 3 == 1:
                rid, k, c = next_id + i * per + j, 3_000_000 + next_id + i * per + j, \
                    f"cdc-new-{tag}-{i}-{j}"
                script.append(f"INSERT INTO sbtest1 (id, k, c, pad) VALUES "
                              f"({rid}, {k}, '{c}', 'cdc')")
                checks.append((f"SELECT id, c FROM sbtest1 WHERE k = {k}",
                               lambda rows, r=(rid, c): rows == [r]))
            else:
                rid = next(keys)
                script.append(f"DELETE FROM sbtest1 WHERE id = {rid}")
                checks.append((f"SELECT id, c FROM sbtest1 WHERE k = {k_of[rid]}",
                               lambda rows, r=rid: r not in [x[0] for x in rows]))
            touched.append(rid)
        scripts.append(script)
        reads.append(checks)
    return scripts, reads, touched


def _dml_pass(gi, scripts, reads):
    """One storm on `gi`'s sbtest1 with the DML batcher's and the applier's
    numbers of that run."""
    import statistics as st
    from galaxysql_tpu_torch.exec.device_cache import TRANSFER_STATS
    sched, applier = gi.dml_batch_scheduler, gi.applier
    before = dict(sched.counts)
    applies0 = gi.metrics.counter("gsi_async_applies").value
    n_groups = len(sched.group_sizes)
    applier.peak_backlog, applier.peak_lag_ms = 0, 0.0
    x0, misses0 = dict(TRANSFER_STATS), gi.device_cache.misses
    lat, wall = _storm(gi, "sbtest", scripts, reads)
    groups = list(sched.group_sizes)[n_groups:]
    line = {"statements": len(lat), "qps": len(lat) / wall, "p50_ms": _pct(lat, 50),
            "p99_ms": _pct(lat, 99), "seconds": wall,
            **{k: sched.counts[k] - before[k] for k in sched.counts},
            "members_per_flush_mean": st.mean(groups) if groups else 0.0,
            "members_per_flush_p50": st.median(groups) if groups else 0.0,
            "gsi_async_applies": gi.metrics.counter("gsi_async_applies").value - applies0,
            # the flushes' key lookups re-ship each touched partition's sorted lanes
            # after every write (version-keyed device cache)
            "device_cache_misses": gi.device_cache.misses - misses0,
            "h2d_bytes": TRANSFER_STATS["bytes"] - x0["bytes"]}
    if not applier.drain():
        raise AssertionError("the async applier did not drain")
    line.update(peak_gsi_apply_backlog=applier.peak_backlog,
                peak_gsi_apply_lag_ms=applier.peak_lag_ms)
    return line


def _cdc_sbtest(sb_gpu, sb_cpu, out):
    """(a) batched point writes with async GSI apply on sbtest1, batching on and
    off, the card against its CPU twin."""
    import numpy as np
    from galaxysql_tpu_torch.server.session import Session
    gs, cs = Session(sb_gpu, "sbtest"), Session(sb_cpu, "sbtest")
    try:
        for s in (gs, cs):
            if not any(i.name == "g_k" for i in
                       s.instance.catalog.table("sbtest", "sbtest1").indexes):
                s.execute("CREATE GLOBAL INDEX g_k ON sbtest1 (k) COVERING (c)")
            plan = "\n".join(r[0] for r in s.execute(
                "EXPLAIN SELECT id, c FROM sbtest1 WHERE k = 17").rows)
            if "sbtest1$g_k" not in plan:
                raise AssertionError(f"the read does not scan the GSI:\n{plan}")
        out["explain"] = plan.splitlines()
        store = sb_gpu.store("sbtest", "sbtest1")
        live = np.concatenate([p.lanes["id"][p.visible_mask(None)]
                               for p in store.partitions])
        next_id = int(max(int(p.lanes["id"].max()) for p in store.partitions)) + 100_000
        # one sequential run of each shape registers its DML batch plan
        for sql in (f"UPDATE sbtest1 SET c = 'cdc-plan' WHERE id = {int(live[0])}",
                    f"INSERT INTO sbtest1 (id, k, c, pad) VALUES ({next_id - 1}, "
                    f"{3_000_000 + next_id - 1}, 'cdc-plan', 'cdc')",
                    f"DELETE FROM sbtest1 WHERE id = {next_id - 1}"):
            _both(gs, cs, sql, "a DML batch plan's first run")
        live = live[1:]
        rng = np.random.default_rng(20241017)
        touched = []
        for tag, on in (("on", 1), ("off", 0)):
            scripts, reads, ids = _sbtest_traffic(sb_gpu, rng, live, next_id, tag)
            live = np.setdiff1d(live, ids)
            next_id += CDC_SESSIONS * CDC_PER_SESSION
            touched += ids
            sb_gpu.config.set_instance("ENABLE_DML_BATCHING", on)
            try:
                out[f"batching_{tag}"] = _dml_pass(sb_gpu, scripts, reads)
            finally:
                sb_gpu.config.set_instance("ENABLE_DML_BATCHING", 1)
            # the twin's end state does not depend on the order: batched, from as
            # many threads
            t0 = time.perf_counter()
            _dml_pass(sb_cpu, scripts, reads)
            out[f"batching_{tag}"]["cpu_twin_seconds"] = time.perf_counter() - t0
        if out["batching_on"]["dml_batch_flushes"] == 0 or \
                out["batching_off"]["dml_batched_queries"]:
            raise AssertionError(f"batching on / off did not hold: "
                                 f"{out['batching_on']} / {out['batching_off']}")
        for inst, name in ((sb_gpu, "card"), (sb_cpu, "cpu")):
            if not np.array_equal(_gsi_rows(inst, "sbtest", "sbtest1", ["k", "c", "id"]),
                                  _gsi_rows(inst, "sbtest", "sbtest1$g_k",
                                            ["k", "c", "id"])):
                raise AssertionError(f"g_k's rows differ from sbtest1's ({name})")
        out["gsi_equals_base"] = True
        inlist = ", ".join(str(int(k)) for k in sorted(touched))
        _both(gs, cs, f"SELECT id, k, c, pad FROM sbtest1 WHERE id IN ({inlist}) "
              "ORDER BY id", "the touched ids")
        rs, _ms = _both(gs, cs, "SELECT count(*), sum(k) FROM sbtest1", "count and sum")
        out["touched_ids"] = len(touched)
        out["count_sum_k"] = list(rs.rows[0])
    finally:
        gs.close()
        cs.close()


def _order_insert(key, cust, i, j):
    """A new order's INSERT (the nine TPC-H columns; a column an ALTER added takes
    its default)."""
    return ("INSERT INTO orders (o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
            "o_orderdate, o_orderpriority, o_clerk, o_shippriority, o_comment) "
            f"VALUES ({key}, {cust}, 'O', {1000 + i * 100 + j}.25, "
            f"'1996-0{1 + j % 9}-1{i % 10}', '{1 + j % 5}-URGENT', "
            f"'Clerk#0000000{i % 100:02d}', 0, "
            f"'cdc new {i}-{j}{' special requests' if j % 4 == 1 else ''}')")


def _cdc_orders_traffic(b_inst, rng):
    """CDC_SESSIONS sessions of CDC_ORDERS_PER_SESSION autocommit writes each on
    orders, on keys of their own: UPDATE of o_comment (a quarter matching Q13's
    '%special%requests%'), INSERT of a new order of an existing customer, DELETE."""
    import numpy as np
    store = b_inst.store("tpch", "orders")
    live = np.concatenate([p.lanes["o_orderkey"][p.visible_mask(None)]
                           for p in store.partitions])
    top = int(max(int(p.lanes["o_orderkey"].max()) for p in store.partitions))
    custs = np.concatenate([p.lanes["c_custkey"][p.visible_mask(None)]
                            for p in b_inst.store("tpch", "customer").partitions])
    per = CDC_ORDERS_PER_SESSION
    n_upd, n_del = len(range(0, per, 3)), len(range(2, per, 3))
    own = rng.choice(live, CDC_SESSIONS * (n_upd + n_del) + CDC_TXN_UPDATES + 3,
                     replace=False).tolist()
    spare, own = own[:CDC_TXN_UPDATES + 3], own[CDC_TXN_UPDATES + 3:]
    scripts, touched = [], list(spare)
    for i in range(CDC_SESSIONS):
        keys = iter(own[i * (n_upd + n_del):(i + 1) * (n_upd + n_del)])
        script = []
        for j in range(per):
            if j % 3 == 0:
                key = next(keys)
                words = "special packages requests" if (i + j) % 4 == 0 else "plain"
                script.append(f"UPDATE orders SET o_comment = 'cdc {i}-{j} {words}' "
                              f"WHERE o_orderkey = {key}")
            elif j % 3 == 1:
                key = top + 1 + i * per + j
                script.append(_order_insert(key, int(custs[(i * per + j) % custs.size]),
                                            i, j))
            else:
                key = next(keys)
                script.append(f"DELETE FROM orders WHERE o_orderkey = {key}")
            touched.append(key)
        scripts.append(script)
    return scripts, spare, top + CDC_SESSIONS * per + 1, int(custs[0]), touched


def _cdc_replica(b_inst, b_cpu, out):
    """(b) the binlog of B (the booted TPC-H instance, its metadb on disk) after
    `head`, read three ways and replayed onto a replica R made at `head`."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.net.client import MiniClient
    from galaxysql_tpu_torch.net.server import MySQLServer
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import transfer
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.txn import cdc
    bs, cs = Session(b_inst, "tpch"), Session(b_cpu, "tpch")
    rs_ = None
    served = None
    try:
        head = b_inst.metadb.query("SELECT max(seq) FROM binlog_events")[0][0] or 0
        # R: a replica of B's lineitem, orders and customer at `head`, as SHOW CREATE
        # TABLE describes them on B (the ddl phase added o_band to orders)
        t0 = time.perf_counter()
        r_inst = _frag_off(Instance(device=b_inst.device))
        rs_ = Session(r_inst)
        rs_.execute("CREATE DATABASE tpch")
        rs_.execute("USE tpch")
        for t in CDC_REPLICA_TABLES:
            rs_.execute(bs.execute(f"SHOW CREATE TABLE {t}").rows[0][1])
            parts, dicts = transfer.arrays_of(b_inst.store("tpch", t))
            r_inst.install_store(transfer.store_from_arrays(
                r_inst.catalog.table("tpch", t), parts, dicts))
        out["replica_copy_ms"] = (time.perf_counter() - t0) * 1000.0
        out["head_seq"] = head

        rng = np.random.default_rng(20241018)
        scripts, spare, new_key, cust, touched = _cdc_orders_traffic(b_inst, rng)
        # one sequential run of each shape registers its DML batch plan
        for sql in (f"UPDATE orders SET o_comment = 'cdc plan' WHERE o_orderkey = "
                    f"{spare.pop()}", _order_insert(new_key, cust, 99, 1),
                    f"DELETE FROM orders WHERE o_orderkey = {new_key}"):
            _both(bs, cs, sql, "an orders batch plan's first run")
        touched.append(new_key)
        flushes0 = b_inst.dml_batch_scheduler.counts["dml_batch_flushes"]
        lat, wall = _storm(b_inst, "tpch", scripts)
        out["orders_writes"] = {
            "statements": len(lat), "qps": len(lat) / wall, "p50_ms": _pct(lat, 50),
            "p99_ms": _pct(lat, 99),
            "flushes": b_inst.dml_batch_scheduler.counts["dml_batch_flushes"] - flushes0}
        t0 = time.perf_counter()
        _storm(b_cpu, "tpch", scripts)
        out["orders_writes"]["cpu_twin_seconds"] = time.perf_counter() - t0
        if out["orders_writes"]["flushes"] == 0:
            raise AssertionError("no orders write was batched")
        _both(bs, cs, "BEGIN", "BEGIN")
        for j, key in enumerate(spare[:CDC_TXN_UPDATES]):
            _both(bs, cs, f"UPDATE orders SET o_comment = 'cdc txn {j} special "
                  f"requests' WHERE o_orderkey = {key}", "the transaction's UPDATE")
        _rs, out["txn_commit_ms"] = _both(bs, cs, "COMMIT", "COMMIT")

        # the log after head, three ways
        events = b_inst.cdc.events_after_seq(head, 1 << 30)
        shown = [tuple(r) for r in bs.execute("SHOW BINLOG EVENTS").rows if r[0] > head]
        if shown != [tuple(e) for e in events]:
            raise AssertionError(f"SHOW BINLOG EVENTS after head: {len(shown)} events, "
                                 f"events_after_seq: {len(events)}")
        txn_ts = {e[1] for e in events[-2 * CDC_TXN_UPDATES:]}
        if len(txn_ts) != 1:
            raise AssertionError(f"the transaction's events carry {len(txn_ts)} "
                                 "commit timestamps")
        served = _Served([MySQLServer(b_inst, port=0, users={"root": ""}, pool_size=4)])
        c = MiniClient("127.0.0.1", served.servers[0].port, timeout=120.0)
        t0 = time.perf_counter()
        dumped = c.binlog_dump(head)
        out["binlog_dump_ms"] = (time.perf_counter() - t0) * 1000.0
        c.close()
        if [(e["seq"], e["commit_ts"], e["schema"], e["table"], e["kind"], e["payload"])
                for e in dumped] != [tuple(e) for e in events]:
            raise AssertionError("COM_BINLOG_DUMP from head differs from "
                                 "events_after_seq")
        kinds = {}
        for e in events:
            kinds[e[4]] = kinds.get(e[4], 0) + 1
        out["events"] = {"count": len(events), "by_kind": kinds,
                         "payload_bytes": sum(len(e[5]) for e in events),
                         "commit_timestamps": len({e[1] for e in events})}

        # replay onto R: a consumer crash halfway, the stream redelivered, again
        with contextlib.ExitStack() as stack:
            deletes = stack.enter_context(_Timer(cdc, "_replay_delete"))
            inserts = [stack.enter_context(_Timer(r_inst.store("tpch", t),
                                                  "insert_pylists"))
                       for t in CDC_REPLICA_TABLES]
            t0 = time.perf_counter()
            half = len(events) // 2
            applied = [cdc.replay(events, r_inst, stop_after=half),
                       cdc.replay(events, r_inst), cdc.replay(events, r_inst)]
            replay_ms = (time.perf_counter() - t0) * 1000.0
        if applied != [half, len(events) - half, 0]:
            raise AssertionError(f"replay applied {applied} of {len(events)} events")
        out["replay"] = {"applied": applied, "ms": replay_ms,
                         "insert_ms": sum(t.ms for t in inserts),
                         "delete_ms": deletes.ms}

        # Q1, Q3 and Q13 on R (every lane shipped) against B
        out["queries"] = {}
        for q in CDC_QUERIES:
            want, b_first = _timed(bs, SQL[q])
            _w, b_warm = _timed(bs, SQL[q])
            got, r_first = _timed(rs_, SQL[q])
            _g, r_warm = _timed(rs_, SQL[q])
            if not (_rows_match(got.rows, want.rows)[0] and
                    _rows_match(_g.rows, want.rows)[0] and _w.rows == want.rows):
                raise AssertionError(f"Q{q} on the replica differs from the source")
            out["queries"][f"Q{q}"] = {"replica_first_ms": r_first,
                                       "replica_warm_ms": r_warm,
                                       "source_first_ms": b_first,
                                       "source_warm_ms": b_warm,
                                       "rows": len(want.rows)}
        torch.cuda.synchronize()
        # B against its CPU twin on every touched key
        inlist = ", ".join(str(int(k)) for k in sorted(set(touched)))
        _both(bs, cs, f"SELECT * FROM orders WHERE o_orderkey IN ({inlist}) "
              "ORDER BY o_orderkey", "the touched orders")
        out["touched_keys"] = len(set(touched))
    finally:
        if served is not None:
            served.stop()
        for x in (bs, cs, rs_):
            if x is not None:
                x.close()


def cdc_phase(b_inst, b_cpu, sb_gpu, sb_cpu):
    """(a) batched point writes with async GSI apply on sbtest1, (b) the binlog and
    a replica at SF 1, each step on the card and its CPU twin."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"sbtest": {}, "replica": {}}
    for name, fn in (("sbtest_writes", lambda: _cdc_sbtest(sb_gpu, sb_cpu,
                                                           out["sbtest"])),
                     ("binlog_replica", lambda: _cdc_replica(b_inst, b_cpu,
                                                             out["replica"]))):
        t0 = time.perf_counter()
        fn()
        out.setdefault("step_ms", {})[name] = (time.perf_counter() - t0) * 1000.0
        say("cdc_step", step=name, ms=out["step_ms"][name])
    out["checkpoint_drain"] = ("not run on the card: the durable instance holds no "
                               "GSI; tests/test_torch_dml_batch.py holds save() "
                               "draining a delayed applier on the CPU")
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the cdc phase: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- LOAD DATA ---------------------------------------------------------------------------

def _tbl_text(inst, schema, table, at_most=None) -> str:
    """A table's visible rows in dbgen's `.tbl` format: the fields in column order,
    each followed by '|'; with `at_most` = (column, value) only the rows whose column
    is at most the value."""
    import numpy as np
    from galaxysql_tpu_torch.chunk.batch import Column
    tm = inst.catalog.table(schema, table)
    store = inst.store(schema, table)
    vis = [p.visible_mask(None) for p in store.partitions]
    if at_most is not None:
        vis = [m & (p.lanes[at_most[0]] <= at_most[1])
               for p, m in zip(store.partitions, vis)]
    fields = []
    for c in tm.columns:
        lane = np.concatenate([p.lanes[c.name][m] for p, m in zip(store.partitions, vis)])
        valid = np.concatenate([p.valid[c.name][m] for p, m in zip(store.partitions, vis)])
        vals = Column(lane, valid, c.dtype, tm.dictionaries.get(c.name.lower())).to_pylist()
        fields.append(["\\N" if v is None else str(v) for v in vals])
    return "".join("|".join(r) + "|\n" for r in zip(*fields))


def _rows_by_key(inst, schema, table, key):
    """A table's visible rows as {column: (values, validity)} sorted by `key`; string
    columns decoded (two tables' dictionaries assign their own codes)."""
    import numpy as np
    tm = inst.catalog.table(schema, table)
    store = inst.store(schema, table)
    vis = [p.visible_mask(None) for p in store.partitions]

    def lane(name, arrays):
        return np.concatenate([getattr(p, arrays)[name][m]
                               for p, m in zip(store.partitions, vis)])
    order = np.argsort(lane(key, "lanes"), kind="stable")
    out = {}
    for c in tm.columns:
        d = lane(c.name, "lanes")[order]
        if c.dtype.is_string:
            d = np.asarray(tm.dictionaries[c.name.lower()].values, dtype=object)[d]
        out[c.name] = (d, lane(c.name, "valid")[order])
    return out


def _load_statement(s, path, table, clauses):
    """LOAD DATA of `path` into `table`: (result, ms on the host clock ending in a
    sync)."""
    return _timed(s, f"LOAD DATA INFILE '{path}' INTO TABLE {table} {clauses}")


def _load_orders(gi, gs, work_dir, out):
    """(a) The LOAD_ORDERS_ROWS orders of the lowest keys as a `.tbl` file into an
    empty table shaped like orders."""
    import re
    import numpy as np
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    keys = np.sort(np.concatenate([p.lanes["o_orderkey"][p.visible_mask(None)]
                                   for p in gi.store("tpch", "orders").partitions]))
    kmax = int(keys[min(LOAD_ORDERS_ROWS, keys.size) - 1])
    out["key_max"] = kmax
    t0 = time.perf_counter()
    path = os.path.join(work_dir, "orders.tbl")
    with open(path, "w") as f:
        f.write(_tbl_text(gi, "tpch", "orders", ("o_orderkey", kmax)))
    out["write_file_ms"] = (time.perf_counter() - t0) * 1000.0
    out["file_bytes"] = os.path.getsize(path)
    gs.execute(tpch.TPCH_DDL["orders"].replace("orders (", "orders_l (", 1))
    store = gi.store("tpch", "orders_l")
    events = len(gi.cdc.events())
    cache0 = gi.device_cache.nbytes
    with _Timer(store, "insert_pylists") as enc:
        rs, ms = _load_statement(gs, path, "orders_l", "FIELDS TERMINATED BY '|'")
    n = int((keys <= kmax).sum())
    if rs.affected != n or rs.info != f"Records: {n}":
        raise AssertionError(f"LOAD DATA of orders affected {rs.affected} of {n} rows")
    out.update(rows=rs.affected, ms=ms, rows_per_s=rs.affected / (ms / 1000.0),
               encode_append_ms=enc.ms, batches=enc.calls,
               read_parse_ms=ms - enc.ms)
    t0 = time.perf_counter()
    want = _rows_by_key(gi, "tpch", "orders", "o_orderkey")
    head = want["o_orderkey"][0] <= kmax
    want = {col: (d[head], v[head]) for col, (d, v) in want.items()}
    got = _rows_by_key(gi, "tpch", "orders_l", "o_orderkey")
    for col, (d, v) in want.items():
        if not (np.array_equal(got[col][1], v) and np.array_equal(got[col][0][v], d[v])):
            raise AssertionError(f"orders_l.{col} differs from orders after LOAD DATA")
    out["compare_ms"] = (time.perf_counter() - t0) * 1000.0
    q13 = SQL[13]
    gs.execute(f"CREATE VIEW orders_k AS SELECT * FROM orders WHERE o_orderkey <= {kmax}")
    rs_l, out["q13_orders_l_ms"] = _timed(gs, re.sub(r"\borders\b", "orders_l", q13))
    rs_o, out["q13_orders_ms"] = _timed(gs, re.sub(r"\borders\b", "orders_k", q13))
    gs.execute("DROP VIEW orders_k")
    if rs_l.rows != rs_o.rows or not rs_l.rows:
        raise AssertionError("Q13 over orders_l differs from Q13 over the same orders")
    out["q13_rows"] = len(rs_l.rows)
    out["device_cache_bytes"] = {"before": cache0, "after": gi.device_cache.nbytes}
    if len(gi.cdc.events()) != events:
        raise AssertionError("LOAD DATA wrote binlog events")
    return path


def _load_sbtest(sb_gpu, work_dir, out, seed):
    """(b) sysbench-shaped rows into sbtest1 while its covering GSI g_k exists."""
    import numpy as np
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import sysbench
    s = Session(sb_gpu, "sbtest")
    try:
        tm = sb_gpu.catalog.table("sbtest", "sbtest1")
        if not any(i.name == "g_k" and i.global_index for i in tm.indexes):
            raise AssertionError("sbtest1 lost g_k before load_data")
        store = sb_gpu.store("sbtest", "sbtest1")
        first = int(max(int(p.lanes["id"].max()) for p in store.partitions)) + 1
        rows = sysbench.generate(LOAD_SB_ROWS, seed)
        ids = rows["id"].astype(np.int64) + first - 1
        path = os.path.join(work_dir, "sbtest1.csv")
        with open(path, "w") as f:
            f.write("".join(f"{i},{k},{c},{p}\n" for i, k, c, p in zip(
                ids.tolist(), rows["k"].tolist(), rows["c"].tolist(),
                rows["pad"].tolist())))
        out["file_bytes"] = os.path.getsize(path)
        events = len(sb_gpu.cdc.events())
        cache0 = sb_gpu.device_cache.nbytes
        rs, ms = _load_statement(s, path, "sbtest1", "FIELDS TERMINATED BY ','")
        if rs.affected != LOAD_SB_ROWS:
            raise AssertionError(f"LOAD DATA into sbtest1 affected {rs.affected}")
        out.update(rows=rs.affected, ms=ms, rows_per_s=rs.affected / (ms / 1000.0),
                   device_cache_bytes={"before": cache0,
                                       "after": sb_gpu.device_cache.nbytes})
        if not np.array_equal(_gsi_rows(sb_gpu, "sbtest", "sbtest1", ["k", "c", "id"]),
                              _gsi_rows(sb_gpu, "sbtest", "sbtest1$g_k",
                                        ["k", "c", "id"])):
            raise AssertionError("g_k's rows differ from sbtest1's after LOAD DATA")
        if len(sb_gpu.cdc.events()) != events:
            raise AssertionError("LOAD DATA wrote binlog events")
        # point selects of loaded ids on the fast path
        pick = np.random.default_rng(seed).choice(LOAD_SB_ROWS, LOAD_POINT_SELECTS,
                                                  replace=False)
        fast0 = sb_gpu.counters["point_plan_queries"]
        t0 = time.perf_counter()
        for i in pick.tolist():
            got = s.execute(f"SELECT c FROM sbtest1 WHERE id={int(ids[i])}").rows
            if got != [(str(rows["c"][i]),)]:
                raise AssertionError(f"loaded id {int(ids[i])} reads {got}")
        out["point_select_ms_mean"] = (time.perf_counter() - t0) * 1000.0 / len(pick)
        out["point_plan_queries"] = sb_gpu.counters["point_plan_queries"] - fast0
        if out["point_plan_queries"] < len(pick) - 1:
            raise AssertionError("the loaded ids' point selects missed the fast path")
    finally:
        s.close()


def _load_rollback(gi, gs, orders_path, work_dir, out):
    """(c) LOAD DATA inside BEGIN ... ROLLBACK leaves nothing behind."""
    import numpy as np
    path = os.path.join(work_dir, "orders_head.tbl")
    with open(orders_path) as src, open(path, "w") as dst:
        for _ in range(LOAD_TXN_ROWS):
            dst.write(src.readline())
    before = gs.execute("SELECT count(*), sum(o_totalprice) FROM orders_l").rows
    visible = _gsi_rows(gi, "tpch", "orders_l", ["o_orderkey", "o_custkey"])
    gs.execute("BEGIN")
    rs, out["ms"] = _load_statement(gs, path, "orders_l", "FIELDS TERMINATED BY '|'")
    inside = gs.execute("SELECT count(*) FROM orders_l").rows[0][0]
    _rs, out["rollback_ms"] = _timed(gs, "ROLLBACK")
    if rs.affected != LOAD_TXN_ROWS or inside != before[0][0] + LOAD_TXN_ROWS:
        raise AssertionError(f"the load in a transaction affected {rs.affected}, saw "
                             f"{inside} rows")
    after = gs.execute("SELECT count(*), sum(o_totalprice) FROM orders_l").rows
    if after != before or not np.array_equal(
            visible, _gsi_rows(gi, "tpch", "orders_l", ["o_orderkey", "o_custkey"])):
        raise AssertionError("ROLLBACK left rows of the load behind")
    out.update(rows=rs.affected, rows_inside=inside)


def load_data_phase(analyzed, sb_gpu, work_dir, seed=20241017):
    """(a) orders from a `.tbl` file, (b) sysbench rows under a covering GSI, (c) a
    load rolled back."""
    import torch
    from galaxysql_tpu_torch.server.session import Session
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(work_dir, exist_ok=True)
    gs = Session(analyzed, "tpch")
    out = {"orders": {}, "sbtest1": {}, "rollback": {}}
    try:
        for name, fn in (
                ("orders", lambda: _load_orders(analyzed, gs, work_dir, out["orders"])),
                ("sbtest1", lambda: _load_sbtest(sb_gpu, work_dir, out["sbtest1"], seed)),
                ("rollback", lambda: _load_rollback(
                    analyzed, gs, os.path.join(work_dir, "orders.tbl"), work_dir,
                    out["rollback"]))):
            t0 = time.perf_counter()
            fn()
            out.setdefault("step_ms", {})[name] = (time.perf_counter() - t0) * 1000.0
            say("load_data_step", step=name, ms=out["step_ms"][name])
    finally:
        gs.close()
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in load_data: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- spill and streamed scans --------------------------------------------------------

def _op_counters(op, out=None):
    """The spill counters of every operator in a tree, in pre-order."""
    from galaxysql_tpu_torch.exec import operators as ops
    out = [] if out is None else out
    if isinstance(op, ops.HashJoinOp):
        out.append({"op": f"join_{op.join_type}", "grace_partitions": op.grace_partitions})
    elif isinstance(op, ops.SortOp):
        out.append({"op": "sort", "spilled_runs": op.spilled_runs})
    elif isinstance(op, ops.HashAggOp):
        out.append({"op": "agg", "spilled_partials": op.spilled_partials})
    for attr in ("inner", "child", "build", "probe"):
        c = getattr(op, attr, None)
        if isinstance(c, ops.Operator):
            _op_counters(c, out)
    for c in getattr(op, "children_ops", ()):
        _op_counters(c, out)
    return out


def _spill_dir_files() -> list:
    from galaxysql_tpu_torch.exec import spill
    return os.listdir(spill.SPILL_MANAGER.directory)


def _run_counted(s, sql):
    """`sql` the way `Session` runs a SELECT (plan, context, operator tree, rows),
    keeping the operator tree for its spill counters: (rows, ms, counters, the
    execution's trace).  No spill file may be left behind."""
    import torch
    from galaxysql_tpu_torch.exec.operators import run_to_batch
    from galaxysql_tpu_torch.plan.physical import build_operator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = s.instance.planner.plan_select(sql, s.schema, [], s)
    ctx = s._exec_context(plan, [])
    op = build_operator(plan.rel, ctx)
    rows = run_to_batch(op).compact().to_pylist()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    if _spill_dir_files():
        raise AssertionError(f"spill files left behind: {_spill_dir_files()}")
    return rows, ms, _op_counters(op), ctx.trace


def _spill_sql(gi, unspilled, unspilled_ms, out):
    """(a) TPC-H with SORT_SPILL_BYTES and JOIN_SPILL_BYTES lowered (SPILL_SQL), held
    to the same instance's unspilled rows."""
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    s = Session(gi, "tpch")
    try:
        kinds = set()
        for (sort_bytes, join_bytes), q in ((b, q) for b, qs in SPILL_SQL for q in qs):
            s.execute(f"SET SORT_SPILL_BYTES = {sort_bytes}")
            s.execute(f"SET JOIN_SPILL_BYTES = {join_bytes}")
            spill0 = _spill_totals()
            rows, ms, counters, _trace = _run_counted(s, SPILL_HEADS.get(q, "") + SQL[q])
            ok, _f, worst = _rows_match(rows, unspilled[f"Q{q}"])
            if not ok:
                raise AssertionError(f"Q{q} spilled differs from Q{q} unspilled")
            spill1 = _spill_totals()
            out[f"Q{q}"] = {"sort_spill_bytes": sort_bytes,
                            "join_spill_bytes": join_bytes, "ms_spilled": ms,
                            "ms_unspilled": unspilled_ms[f"Q{q}"],
                            "counters": [c for c in counters if
                                         any(v for k, v in c.items() if k != "op")],
                            "max_float_rel_diff": worst,
                            **{k: spill1[k] - spill0[k] for k in spill1}}
            kinds |= {c["op"] for c in out[f"Q{q}"]["counters"]}
            say("spill_query", query=f"Q{q}", **out[f"Q{q}"])
        want = {"join_inner", "join_left", "join_semi", "join_anti", "sort"}
        if not want <= kinds:
            raise AssertionError(f"no spill of {sorted(want - kinds)} in {SPILL_SQL}")
    finally:
        s.close()


def li23_data(rows, suppliers, parts, seed, threads=8):
    """A lineitem-shaped table on TPC-H's domains: order keys in dbgen's sparse
    numbering (four lines an order), part and supplier keys uniform, quantity 1-50,
    the extended price from the part's retail price, discount 0.00-0.10, ship date
    1992-01-02 .. 1998-12-01, and a supplier table's nation keys.  Made in `threads`
    row ranges at once, each from its own generator seeded by (`seed`, range), which
    also sums its share of the three queries' answers over its integer lanes (cents;
    cents x discount for Q6), so the answers are exact.  Returns (li23's columns for
    `insert_arrays`, the suppliers' nation keys, the answers)."""
    import concurrent.futures
    import numpy as np
    from galaxysql_tpu_torch.types import temporal
    nation = np.random.default_rng([seed, threads]).integers(0, 25, suppliers)
    columns = {"l_orderkey": np.empty(rows, np.int64), "l_partkey": np.empty(rows, np.int32),
               "l_suppkey": np.empty(rows, np.int32),
               "l_quantity": np.empty(rows, np.float64),
               "l_extendedprice": np.empty(rows, np.float64),
               "l_discount": np.empty(rows, np.float64),
               "l_shipdate": np.empty(rows, np.int32)}
    first, last = temporal.parse_date("1992-01-02"), temporal.parse_date("1998-12-01")
    q6_lo, q6_hi = temporal.parse_date("1994-01-01"), temporal.parse_date("1995-01-01")

    def fill(i):
        lo, hi = rows * i // threads, rows * (i + 1) // threads
        n = hi - lo
        rng = np.random.default_rng([seed, i])
        idx = np.arange(lo, hi, dtype=np.int64) // 4
        columns["l_orderkey"][lo:hi] = (idx // 8) * 32 + idx % 8 + 1
        pk = rng.integers(1, parts + 1, n, dtype=np.int64)
        columns["l_partkey"][lo:hi] = pk
        supp = rng.integers(1, suppliers + 1, n)
        columns["l_suppkey"][lo:hi] = supp
        qty = rng.integers(1, 51, n, dtype=np.int64)
        # the part's retail price in cents, as dbgen computes it
        ext = qty * (90000 + (pk // 10) % 20001 + 100 * (pk % 1000))
        disc = rng.integers(0, 11, n)
        ship = rng.integers(first, last + 1, n)
        columns["l_shipdate"][lo:hi] = ship
        for name, cents in (("l_quantity", qty * 100), ("l_extendedprice", ext),
                            ("l_discount", disc)):
            np.divide(cents, 100.0, out=columns[name][lo:hi])
        m = (ship >= q6_lo) & (ship < q6_hi) & (disc >= 5) & (disc <= 7) & (qty < 24)
        # float64 sums of integers below 2^53 are exact
        return (int((ext[m] * disc[m]).sum()),
                np.bincount(supp, minlength=suppliers + 1),
                np.bincount(supp, weights=qty * 100, minlength=suppliers + 1),
                np.bincount(supp, weights=ext, minlength=suppliers + 1),
                np.bincount(nation[supp - 1], weights=ext, minlength=25))

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        parts_ = list(pool.map(fill, range(threads)))
    answers = {"q6": sum(p[0] for p in parts_),
               "count": sum(p[1] for p in parts_),
               "qty": sum(p[2] for p in parts_).astype(np.int64),
               "ext": sum(p[3] for p in parts_).astype(np.int64),
               "by_nation": sum(p[4] for p in parts_).astype(np.int64)}
    return columns, nation, answers


def _spill_streamed(out, seed):
    """(b) the streamed scan past FUSE_MAX_ROWS (lowered to LI23_FUSE_MAX_ROWS for the
    step): li23 and supplier23, three queries first and warm, answers held to numpy."""
    from galaxysql_tpu_torch.plan import physical
    fuse_max = physical.FUSE_MAX_ROWS
    physical.FUSE_MAX_ROWS = LI23_FUSE_MAX_ROWS
    try:
        _li23_queries(out, seed)
    finally:
        physical.FUSE_MAX_ROWS = fuse_max


def _li23_queries(out, seed):
    import gc
    import numpy as np
    import torch
    from galaxysql_tpu_torch.plan import physical
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    if LI23_ROWS <= physical.FUSE_MAX_ROWS:
        raise AssertionError("li23 would fuse: it must pass FUSE_MAX_ROWS")
    t0 = time.perf_counter()
    columns, nation, answers = li23_data(LI23_ROWS, LI23_SUPPLIERS, LI23_PARTS, seed)
    q6, count, qty, ext, by_nation = (answers[k] for k in
                                      ("q6", "count", "qty", "ext", "by_nation"))
    out["generate_ms"] = (time.perf_counter() - t0) * 1000.0
    inst = _frag_off(Instance(device="cuda"))
    s = Session(inst)
    s.execute("CREATE DATABASE big")
    s.execute("USE big")
    s.execute("CREATE TABLE li23 (l_orderkey BIGINT NOT NULL, l_partkey INT NOT NULL, "
              "l_suppkey INT NOT NULL, l_quantity DECIMAL(15,2) NOT NULL, "
              "l_extendedprice DECIMAL(15,2) NOT NULL, l_discount DECIMAL(15,2) NOT NULL,"
              " l_shipdate DATE NOT NULL) PARTITION BY HASH(l_orderkey) PARTITIONS "
              f"{LI23_PARTITIONS}")
    s.execute("CREATE TABLE supplier23 (s_suppkey INT NOT NULL PRIMARY KEY, "
              "s_nationkey INT NOT NULL) PARTITION BY HASH(s_suppkey) PARTITIONS 4")
    t0 = time.perf_counter()
    inst.store("big", "li23").insert_arrays(columns, inst.tso.next_timestamp())
    del columns
    gc.collect()
    inst.store("big", "supplier23").insert_arrays(
        {"s_suppkey": np.arange(1, LI23_SUPPLIERS + 1, dtype=np.int32),
         "s_nationkey": nation.astype(np.int32)}, inst.tso.next_timestamp())
    out["load_ms"] = (time.perf_counter() - t0) * 1000.0
    li = inst.store("big", "li23")
    out["rows"] = li.row_count()
    out["partition_rows"] = [p.num_rows for p in li.partitions]
    torch.cuda.reset_peak_memory_stats()
    queries = {
        "q6": SQL[6].replace("lineitem", "li23"),
        "group_by_suppkey": "SELECT l_suppkey, count(*), sum(l_quantity), "
                            "sum(l_extendedprice) FROM li23 GROUP BY l_suppkey "
                            "ORDER BY 4 DESC LIMIT 100",
        "join_supplier": "SELECT s_nationkey, sum(l_extendedprice) FROM li23 JOIN "
                         "supplier23 ON l_suppkey = s_suppkey GROUP BY s_nationkey"}
    top = np.argsort(-ext, kind="stable")[:100]
    try:
        for name, sql in queries.items():
            res = {}
            for run in ("first", "warm"):
                spill0 = _spill_totals()
                rows, ms, counters, trace = _run_counted(s, sql)
                spill1 = _spill_totals()
                res[run] = {"ms": ms, "counters": counters,
                            **{k: spill1[k] - spill0[k] for k in spill1}}
                # every scan of li23 (one per GROUP BY retry) streamed 16 batches
                streamed = [t for t in trace if t.startswith("scan li23 streamed")]
                if not streamed or set(streamed) != {
                        f"scan li23 streamed batches={LI23_PARTITIONS}"}:
                    raise AssertionError(f"{name}: li23 did not stream "
                                         f"{LI23_PARTITIONS} batches: {trace}")
                if name == "q6":
                    ok = rows == [(q6 / 10_000,)]
                elif name == "group_by_suppkey":
                    # ties in sum(l_extendedprice) may come in either order
                    ok = [r[3] for r in rows] == [int(ext[k]) / 100 for k in top] and all(
                        r == (k, int(count[k]), int(qty[k]) / 100, int(ext[k]) / 100)
                        for r in rows for k in (r[0],))
                else:
                    ok = sorted(rows) == [(n, int(v) / 100)
                                          for n, v in enumerate(by_nation.tolist())]
                if not ok:
                    raise AssertionError(f"{name} on li23 differs from numpy: {rows[:3]}")
            res["streamed_trace"] = streamed
            say("spill_step", step=f"li23_{name}", ms=res["warm"]["ms"])
            out[name] = res
        out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
        out["device_cache_bytes"] = inst.device_cache.nbytes
        if out["group_by_suppkey"]["warm"]["spill_files"] == 0:
            raise AssertionError("the GROUP BY l_suppkey partials did not spill")
    finally:
        s.close()
        inst.device_cache.clear()
        del inst
        gc.collect()


def _sort_batches(inst, rows, seed):
    """lineitem's lanes cut into SORT_BATCH_ROWS-row batches on the card: seven
    columns, a NULL lane on l_shipdate (seeded, one row in ten) and a few dead rows
    in every batch."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch
    tm = inst.catalog.table("tpch", "lineitem")
    store = inst.store("tpch", "lineitem")
    names = ("l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
             "l_extendedprice", "l_discount", "l_shipdate")
    host = {c: np.concatenate([p.lanes[c] for p in store.partitions])[:rows]
            for c in names}
    rng = np.random.default_rng(seed)
    valid = rng.random(host["l_orderkey"].shape[0]) > 0.1
    batches = []
    for lo in range(0, host["l_orderkey"].shape[0], SORT_BATCH_ROWS):
        hi = min(lo + SORT_BATCH_ROWS, host["l_orderkey"].shape[0])
        cols = {}
        for c in names:
            v = torch.from_numpy(valid[lo:hi]).cuda() if c == "l_shipdate" else None
            cols[c] = Column(torch.from_numpy(host[c][lo:hi]).cuda(), v,
                             tm.column(c).dtype)
        live = torch.from_numpy(rng.random(hi - lo) > 0.001).cuda()
        batches.append(ColumnBatch(cols, live))
    return batches, tm


class _RaisingSource:
    """Yields some batches, then raises: a query that fails mid-stream."""

    def __init__(self, batches, after):
        self._batches, self.after = batches, after

    def batches(self):
        for i, b in enumerate(self._batches):
            if i == self.after:
                raise RuntimeError("the input failed mid-stream")
            yield b


def _spill_sort(inst, out, seed):
    """(c) `SortOp` over a quarter of lineitem's rows in batches on the card at
    SORT_SPILL_BYTES: several sorted runs, merged, equal to the in-memory `SortOp` on
    the same batches; then a sort whose input raises mid-stream leaves no spill
    file."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.exec import operators as ops
    from galaxysql_tpu_torch.expr import ir
    batches, tm = _sort_batches(inst, inst.store("tpch", "lineitem").row_count() // 4,
                                seed)

    def ref(c):
        return ir.ColRef(c, tm.column(c).dtype)
    cases = {
        "asc_nulls_first": ([(ref("l_shipdate"), False), (ref("l_extendedprice"), True),
                             (ref("l_orderkey"), False), (ref("l_linenumber"), False)],
                            None, 0),
        "desc_nulls_last_limit": ([(ref("l_shipdate"), True), (ref("l_orderkey"), False),
                                   (ref("l_linenumber"), False)], 1000, 37),
    }

    def drain(op):
        b = ops.run_to_batch(op)
        return {n: (c.np_data(), c.np_valid()) for n, c in b.columns.items()}
    for name, (keys, limit, offset) in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spilled = ops.SortOp(ops.SourceOp(batches), keys, limit, offset,
                             spill_threshold=SORT_SPILL_BYTES)
        with _Timer(spilled, "_key_codes") as codes, \
                _Timer(spilled, "_spill_run") as runs:
            got = drain(spilled)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        mem = ops.SortOp(ops.SourceOp(batches), keys, limit, offset,
                         spill_threshold=1 << 62)
        want = drain(mem)
        torch.cuda.synchronize()
        mem_ms = (time.perf_counter() - t0) * 1000.0
        if spilled.spilled_runs < 4 or mem.spilled_runs:
            raise AssertionError(f"sort {name}: {spilled.spilled_runs} runs")
        for c, (d, v) in want.items():
            if not (np.array_equal(got[c][1], v) and np.array_equal(got[c][0][v], d[v])):
                raise AssertionError(f"sort {name}: the spilled sort's {c} differs from "
                                     "the in-memory sort's")
        if _spill_dir_files():
            raise AssertionError(f"spill files left behind: {_spill_dir_files()}")
        out[name] = {"ms_spilled": ms, "ms_in_memory": mem_ms,
                     "spilled_runs": spilled.spilled_runs,
                     "rows_out": int(want["l_orderkey"][0].shape[0]),
                     "key_codes_ms": codes.ms, "spill_run_ms": runs.ms}
    out["batches"] = len(batches)
    out["batch_rows"] = SORT_BATCH_ROWS
    failing = ops.SortOp(_RaisingSource(batches, len(batches) - 1),
                         cases["asc_nulls_first"][0], spill_threshold=SORT_SPILL_BYTES)
    try:
        ops.run_to_batch(failing)
        raise AssertionError("the failing input did not raise")
    except RuntimeError as e:
        if "mid-stream" not in str(e):
            raise
    if failing.spilled_runs == 0 or _spill_dir_files():
        raise AssertionError("the failed sort spilled nothing or left files behind")
    out["failed_mid_stream"] = {"spilled_runs": failing.spilled_runs,
                                "files_left": 0}


def spill_phase(analyzed, unspilled, unspilled_ms, seed=20241017):
    """(a) TPC-H with lowered spill thresholds, (b) the streamed scan of li23,
    (c) a multi-run external sort on the card."""
    import torch
    from galaxysql_tpu_torch.exec import operators as ops
    from galaxysql_tpu_torch.exec import spill
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"sql": {}, "streamed": {}, "sort": {}, "spill_dir": spill.SPILL_MANAGER.directory}
    spill0 = _spill_totals()
    timers = [_Timer(ops.HashJoinOp, "_np_bucket"), _Timer(ops.HashJoinOp, "_spill_split"),
              _Timer(spill.Spiller, "spill"), _Timer(spill.Spiller, "spill_mmap")]
    with contextlib.ExitStack() as stack:
        for t in timers:
            stack.enter_context(t)
        for name, fn in (
                ("sql", lambda: _spill_sql(analyzed, unspilled, unspilled_ms,
                                           out["sql"])),
                ("streamed", lambda: _spill_streamed(out["streamed"], seed)),
                ("sort", lambda: _spill_sort(analyzed, out["sort"], seed))):
            t0 = time.perf_counter()
            fn()
            out.setdefault("step_ms", {})[name] = (time.perf_counter() - t0) * 1000.0
            say("spill_step", step=name, ms=out["step_ms"][name])
    out["host_ms"] = {"np_bucket": timers[0].ms, "spill_split": timers[1].ms,
                      "npz_writes": timers[2].ms, "npz_files": timers[2].calls,
                      "mmap_run_writes": timers[3].ms, "mmap_runs": timers[3].calls}
    spill1 = _spill_totals()
    out.update({k: spill1[k] - spill0[k] for k in spill1})
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the spill phase: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the columnar replica, AS OF and the archive ------------------------------------

COLUMNAR_TABLES = ("lineitem", "orders")
COLUMNAR_ORDER_SHARE = 0.25  # the orders the phase holds, by key, with their lineitems
# (a cut for time: every order before; the first replica delete's match-key map is
# built over every live row)
COLUMNAR_QUERIES = (1, 6, 4, 12)
COLUMNAR_HINT = "/*+TDDL:COLUMNAR(ON)*/ "
COLUMNAR_OFF = "/*+TDDL:COLUMNAR(OFF)*/ "
COLUMNAR_CONFIG = {"ENABLE_COLUMNAR_REPLICA": 1, "COLUMNAR_POLL_MS": 0,
                   "COLUMNAR_CLUSTER_BY": "lineitem:l_shipdate"}
U64_BASE = 1 << 63          # every BIGINT UNSIGNED value of `lu` lies above it
U64_STEP = 1_000_003        # ub = U64_BASE + l_suppkey * U64_STEP
LU_ROWS = 1 << 20           # lineitem rows `lu` takes (a cut for time)
COLUMNAR_RF_SF = 0.25       # the scale of the phase's RF1/RF2 (a cut for time)


def _as_of(sql: str, ts: int) -> str:
    """A TPC-H query over lineitem and orders read AS OF TSO `ts`."""
    import re
    return re.sub(r"\b(lineitem|orders)\b", rf"\1 AS OF TSO {ts}", sql)


def _advance(*insts):
    """One tail cycle on each instance once the watermark margin has passed."""
    margin = max(int(i.config.get("COLUMNAR_WATERMARK_LAG_MS") or 100) for i in insts)
    time.sleep(margin / 1000.0 + 0.01)
    return [i.columnar.tail_once() for i in insts]


def _replica_line(inst):
    out = {}
    for key, rep in inst.columnar.replicas.items():
        stripes, delta = rep.tier
        out[key] = {"state": rep.state, "stripes": len(stripes),
                    "stripe_rows": sum(st.num_rows for st in stripes),
                    "delta_chunks": len(delta), "delta_rows": rep.delta_rows,
                    "compactions": rep.compactions, "reseeds": rep.reseeds,
                    "applied_events": rep.applied_events,
                    "applied_rows": rep.applied_rows,
                    "pruned_stripes": rep.pruned_stripes, "watermark": rep.watermark}
    return out


def _routed_round(gs, cs, label, out):
    """COLUMNAR_QUERIES routed (first and warm) and on the row store (first and warm)
    on the card; the routed rows must equal the row store read AS OF TSO W, W the
    replicas' watermark, and the CPU twin's routed rows.  Returns the rows."""
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi = gs.instance
    w = min(gi.columnar.replica("tpch", t).watermark for t in COLUMNAR_TABLES)
    rows, line = {}, {"watermark": w}
    for q in COLUMNAR_QUERIES:
        lineitem = gi.columnar.replica("tpch", "lineitem")
        r0, p0 = gi.columnar.routed.value, lineitem.pruned_stripes
        first, first_ms = _timed(gs, COLUMNAR_HINT + SQL[q])
        warm, warm_ms = _timed(gs, COLUMNAR_HINT + SQL[q])
        pruned = (lineitem.pruned_stripes - p0) // 2
        if gi.columnar.routed.value - r0 != 2:
            raise AssertionError(f"Q{q} ({label}): COLUMNAR(ON) did not route")
        trace = [t for t in gs.last_trace if "columnar" in t]
        _off_first, off_first_ms = _timed(gs, COLUMNAR_OFF + SQL[q])
        off, off_ms = _timed(gs, COLUMNAR_OFF + SQL[q])
        as_of, as_of_ms = _timed(gs, _as_of(SQL[q], w))
        cpu = cs.execute(COLUMNAR_HINT + SQL[q]).rows
        for what, want in (("the second routed run", first.rows),
                           (f"the row store AS OF TSO {w}", as_of.rows),
                           ("the CPU twin's routed rows", cpu)):
            if not _rows_match(warm.rows, want)[0]:
                raise AssertionError(f"Q{q} ({label}): routed rows differ from {what}:"
                                     f"\n  routed {warm.rows[:3]}\n  want   {want[:3]}")
        if not _rows_match(off.rows, warm.rows)[0]:
            raise AssertionError(f"Q{q} ({label}): COLUMNAR(OFF) differs from ON")
        rows[q] = warm.rows
        line[f"Q{q}"] = {"routed_first_ms": first_ms, "routed_ms": warm_ms,
                         "row_store_first_ms": off_first_ms, "row_store_ms": off_ms,
                         "as_of_ms": as_of_ms, "pruned_stripes": pruned,
                         "rows": len(warm.rows), "trace": trace}
    out[label] = line
    return rows


def _unsigned_query(gi, ci, out):
    """Fault 8 on the card: `lu`, LU_ROWS of lineitem's order keys with BIGINT
    UNSIGNED values above 2**63 derived from their suppliers, and `su`, one row a
    supplier; a routed GROUP BY, MIN/MAX and
    comparisons on `ub` and a join on it, held to numpy and to the CPU twin."""
    import numpy as np
    from galaxysql_tpu_torch.server.session import Session
    li = gi.store("tpch", "lineitem")
    supp = np.concatenate([p.lanes["l_suppkey"] for p in li.partitions])[:LU_ROWS]
    supp = supp.astype(np.uint64)
    okey = np.concatenate([p.lanes["l_orderkey"] for p in li.partitions])[:LU_ROWS]
    ub = np.uint64(U64_BASE) + supp * np.uint64(U64_STEP)
    ukeys = np.unique(ub)
    flag = (np.arange(ukeys.size) % 3 == 0).astype(np.int64)
    lo = ukeys[ukeys.size // 2]  # half the suppliers lie above it
    results = []
    for inst in (gi, ci):
        s = Session(inst, "tpch")
        s.execute("CREATE TABLE lu (l_orderkey BIGINT NOT NULL, ub BIGINT UNSIGNED "
                  "NOT NULL) PARTITION BY HASH(l_orderkey) PARTITIONS 8")
        s.execute("CREATE TABLE su (ub BIGINT UNSIGNED NOT NULL PRIMARY KEY, "
                  "flag BIGINT NOT NULL)")
        inst.store("tpch", "lu").insert_arrays({"l_orderkey": okey, "ub": ub},
                                               inst.tso.next_timestamp())
        inst.store("tpch", "su").insert_arrays({"ub": ukeys, "flag": flag},
                                               inst.tso.next_timestamp())
        s.execute("ANALYZE TABLE lu, su")
        results.append(s)
    gs, cs = results
    sqls = {
        "group_by": COLUMNAR_HINT + f"SELECT ub, count(*), min(l_orderkey) FROM lu "
                    f"WHERE ub > {int(lo)} GROUP BY ub ORDER BY ub",
        "min_max": COLUMNAR_HINT + "SELECT min(ub), max(ub), count(*) FROM lu "
                   f"WHERE ub >= {U64_BASE} AND ub < 18446744073709551615",
        "join": COLUMNAR_HINT + "SELECT count(*), sum(lu.l_orderkey) FROM lu JOIN su "
                "ON lu.ub = su.ub WHERE su.flag = 1",
    }
    sel = ub > lo
    keys_sel, counts = np.unique(ub[sel], return_counts=True)
    mins = [int(okey[sel][ub[sel] == k].min()) for k in keys_sel[:3]]
    want = {
        "min_max": [(int(ub.min()), int(ub.max()), int(ub.size))],
        "join": [(int(np.isin(ub, ukeys[flag == 1]).sum()),
                  int(okey[np.isin(ub, ukeys[flag == 1])].sum()))],
    }
    for name, sql in sqls.items():
        for inst in (gi, ci):
            inst.columnar.ensure_ready("tpch", "lu")
            inst.columnar.ensure_ready("tpch", "su")
        got, ms = _both(gs, cs, sql, f"BIGINT UNSIGNED {name}")
        if name == "group_by":
            head = [(int(k), int(c), m) for k, c, m in
                    zip(keys_sel[:3], counts[:3], mins)]
            if len(got.rows) != keys_sel.size or got.rows[:3] != head:
                raise AssertionError(f"BIGINT UNSIGNED group_by: {got.rows[:3]} != {head}")
        elif got.rows != want[name]:
            raise AssertionError(f"BIGINT UNSIGNED {name}: {got.rows} != {want[name]}")
        out[name] = {"ms": ms, "rows": len(got.rows), "first": list(got.rows[0])}
    for s in (gs, cs):
        s.close()


DATES_FIRST, DATES_DAYS = "1992-01-01", 2557  # the date dimension: 1992-01-01 .. 1998-12-31
RF_STAR_SQL = ("SELECT count(*), sum(l_extendedprice), min(l_shipdate), max(l_shipdate) "
               "FROM lineitem JOIN dates ON l_shipdate = d_date "
               "WHERE d_year = 1995 AND d_month = 6")
# a month after every archived order (the archive holds orders before 1993): the
# build's min/max range refutes every archived file
RF_ARCHIVE_SQL = ("SELECT count(*), sum(o_totalprice) FROM orders JOIN dates "
                  "ON o_orderdate = d_date WHERE d_year = 1995 AND d_month = 6")
RF_OFF = "RUNTIME_FILTER(OFF)"


def _dates_table(gi, ci, gs, cs):
    """`dates` on both instances: one row a day, DATES_DAYS days from DATES_FIRST,
    with its year and month; ANALYZEd on the card, the CPU twin taking its
    statistics."""
    import numpy as np
    from galaxysql_tpu_torch.types import temporal
    days = temporal.parse_date(DATES_FIRST) + np.arange(DATES_DAYS, dtype=np.int32)
    text = [temporal.format_date(int(d)) for d in days]
    cols = {"d_date": days, "d_year": np.array([int(t[:4]) for t in text]),
            "d_month": np.array([int(t[5:7]) for t in text])}
    for inst, s in ((gi, gs), (ci, cs)):
        s.execute("CREATE TABLE dates (d_date DATE NOT NULL, d_year INT NOT NULL, "
                  "d_month INT NOT NULL)")
        inst.store("tpch", "dates").insert_arrays(cols, inst.tso.next_timestamp())
    _analyze(gs, ["dates"])
    _take_statistics(gi, ci, "tpch", ["dates"])


def _rf_star(gs, cs, out):
    """exec_hub (d): a month of `dates` joined with the lineitem replica, clustered on
    l_shipdate, on l_shipdate = d_date (the star-schema shape runtime filters exist
    for): the stripes the join's runtime filter prunes, with filters on and under
    RUNTIME_FILTER(OFF); rows equal to the row store's and the CPU twin's."""
    gi, ci = gs.instance, cs.instance
    _advance(gi, ci)
    for inst in (gi, ci):
        inst.columnar.ensure_ready("tpch", "dates")
    lineitem = gi.columnar.replica("tpch", "lineitem")
    runs = {}
    for label, hint in (("filters_on", "COLUMNAR(ON)"),
                        ("filters_off", f"COLUMNAR(ON) {RF_OFF}")):
        p0 = lineitem.pruned_stripes
        rs, ms = _timed(gs, f"/*+TDDL:{hint}*/ " + RF_STAR_SQL)
        runs[label] = {"ms": ms, "pruned_stripes": lineitem.pruned_stripes - p0,
                       "rf_publish": [t for t in gs.last_trace if t.startswith("rf-")],
                       "rows": rs.rows}
    row_store, row_ms = _timed(gs, COLUMNAR_OFF + RF_STAR_SQL)
    cpu = cs.execute(COLUMNAR_HINT + RF_STAR_SQL).rows
    for label, r in runs.items():
        for what, want in (("the row store", row_store.rows), ("the CPU twin", cpu)):
            if not _rows_match(r["rows"], want)[0]:
                raise AssertionError(f"rf star ({label}): rows differ from {what}:"
                                     f"\n  got  {r['rows']}\n  want {want}")
    planted = bool(runs["filters_on"]["rf_publish"])
    out.update({label: {k: v for k, v in r.items() if k != "rows"}
                for label, r in runs.items()})
    out.update(row_store_ms=row_ms, rows=[list(r) for r in cpu], rf_planted=planted,
               stripes=len(lineitem.tier[0]))
    if planted and runs["filters_off"]["pruned_stripes"] >= \
            runs["filters_on"]["pruned_stripes"]:
        raise AssertionError(f"rf star: the runtime filter pruned no stripe: {out}")
    say("columnar_step", step="rf_star", **{k: v for k, v in out.items() if k != "rows"},
        note=None if planted else "the copied rules planted no runtime filter on this "
                                  "join")


def _archive_check(gi, gs, out, cs=None):
    """Where `pyarrow` imports: archive orders older than 1993-01-01 on the card and
    hold the union of the archived and the hot rows to the rows from before.  Where it
    does not: the reference's NotSupportedError from `archive_older_than`."""
    from galaxysql_tpu_torch.storage import archive
    from galaxysql_tpu_torch.types import temporal
    from galaxysql_tpu_torch.utils import errors
    cutoff = temporal.parse_date("1993-01-01")
    sql = (COLUMNAR_OFF + "SELECT o_orderpriority, count(*), sum(o_totalprice), "
           "min(o_orderdate) FROM orders GROUP BY o_orderpriority ORDER BY o_orderpriority")
    out["pyarrow"] = archive.PARQUET_AVAILABLE
    if not archive.PARQUET_AVAILABLE:
        say("columnar_archive", pyarrow=False,
            note="pyarrow does not import on this host: archive_older_than must raise "
                 "NotSupportedError, as in the reference")
        try:
            gi.archive.archive_older_than(gi, "tpch", "orders", "o_orderdate", cutoff)
        except errors.NotSupportedError as e:
            out["not_supported"] = str(e)
            return
        raise AssertionError("archive_older_than ran without pyarrow")
    gi.archive.directory = tempfile.mkdtemp(prefix="chip_smoke_archive_")
    try:
        before = gs.execute(sql).rows
        t0 = time.perf_counter()
        n = gi.archive.archive_older_than(gi, "tpch", "orders", "o_orderdate", cutoff)
        out["archive_ms"] = (time.perf_counter() - t0) * 1000.0
        after, ms = _timed(gs, sql)
        if n == 0 or not _rows_match(after.rows, before)[0]:
            raise AssertionError(f"archive: {n} rows archived; union rows differ")
        if not any("scan-archive" in t for t in gs.last_trace):
            raise AssertionError("archive: the union scan read no archived batch")
        out.update({"archived_rows": n, "union_ms": ms,
                    "files": len(gi.archive.files_for("tpch.orders"))})
        out["rf_join"] = _archive_rf_join(gi, gs, cs)
    finally:
        shutil.rmtree(gi.archive.directory, ignore_errors=True)


def _archive_rf_join(gi, gs, cs):
    """exec_hub (d) on the archive: a month of `dates` after every archived order
    joined with orders on o_orderdate: with filters on, the build's min/max refutes
    every archived file, which the scan then skips; under RUNTIME_FILTER(OFF) none is
    skipped.  Rows equal the CPU twin's (which holds every order in its row store)."""
    want = cs.execute(COLUMNAR_OFF + RF_ARCHIVE_SQL).rows
    out = {}
    for label, hint in (("filters_on", "COLUMNAR(OFF)"),
                        ("filters_off", f"COLUMNAR(OFF) {RF_OFF}")):
        f0 = gi.archive.rf_pruned_files
        rs, ms = _timed(gs, f"/*+TDDL:{hint}*/ " + RF_ARCHIVE_SQL)
        if not _rows_match(rs.rows, want)[0]:
            raise AssertionError(f"archive rf join ({label}): {rs.rows} != {want}")
        out[label] = {"ms": ms, "files_skipped": gi.archive.rf_pruned_files - f0,
                      "rf_publish": [t for t in gs.last_trace if t.startswith("rf-")]}
    out["rows"] = [list(r) for r in want]
    out["rf_planted"] = bool(out["filters_on"]["rf_publish"])
    if out["rf_planted"] and out["filters_on"]["files_skipped"] == 0:
        raise AssertionError(f"archive rf join: no archived file skipped: {out}")
    say("columnar_step", step="archive_rf_join", **out,
        note=None if out["rf_planted"] else "the copied rules planted no runtime "
                                            "filter on this join")
    return out


def columnar_phase(analyzed, sf, seed=20241017):
    """The columnar replica of lineitem and orders on instances of its own (a card
    instance and a CPU twin over analyzed_tpch's lanes and statistics): the seed, the
    routed queries before and after the refresh functions, AS OF TSO, the BIGINT
    UNSIGNED query and the archive."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch, tpch_refresh
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    t_phase = time.perf_counter()
    bound = int(np.quantile(_lanes_of(analyzed, "orders", ["o_orderkey"])["o_orderkey"],
                            COLUMNAR_ORDER_SHARE))
    keep = {"orders": ("o_orderkey", bound), "lineitem": ("l_orderkey", bound)}
    gi, gs = _copy_instance(analyzed, "tpch", COLUMNAR_TABLES, tpch.TPCH_DDL, "cuda",
                            keep=keep)
    ci, cs = _copy_instance(analyzed, "tpch", COLUMNAR_TABLES, tpch.TPCH_DDL, "cpu",
                            keep=keep)
    _take_statistics(analyzed, gi, "tpch", COLUMNAR_TABLES)
    _take_statistics(analyzed, ci, "tpch", COLUMNAR_TABLES)
    for inst in (gi, ci):
        for k, v in COLUMNAR_CONFIG.items():
            inst.config.set_instance(k, v)
    torch.cuda.reset_peak_memory_stats()
    out = {"config": COLUMNAR_CONFIG, "seed_ms": {}, "cpu_seed_ms": {}}
    _advance(gi, ci)  # the margin passes the loaded rows' stamps
    for t in COLUMNAR_TABLES:
        for inst, key in ((gi, "seed_ms"), (ci, "cpu_seed_ms")):
            t0 = time.perf_counter()
            inst.columnar.ensure_ready("tpch", t)
            out[key][t] = (time.perf_counter() - t0) * 1000.0
    out["replicas_seeded"] = _replica_line(gi)
    say("columnar_step", step="seed", ms=out["seed_ms"], cpu_ms=out["cpu_seed_ms"])

    cache0 = gi.device_cache.nbytes
    before = _routed_round(gs, cs, "seeded", out)
    out["stripe_cache_bytes"] = gi.device_cache.nbytes - cache0
    if out["seeded"]["Q6"]["pruned_stripes"] <= 0:
        raise AssertionError("Q6 pruned no lineitem stripe by zone map")
    say("columnar_step", step="routed", q6_pruned=out["seeded"]["Q6"]["pruned_stripes"])
    w0 = out["seeded"]["watermark"]

    # the refresh functions through the binlog, drained by tail_once
    keys = np.concatenate([p.lanes["o_orderkey"] for p in gi.store("tpch", "orders").partitions])
    rf = tpch_refresh.rf1_rows(sf * COLUMNAR_RF_SF, int(keys.max()))
    stmts = tpch_refresh.rf1_statements(rf) + tpch_refresh.rf2_statements(
        tpch_refresh.rf2_keys(sf * COLUMNAR_RF_SF, keys))
    t0 = time.perf_counter()
    for sql in stmts:
        _both(gs, cs, sql, "refresh")
    out["refresh_ms"] = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    time.sleep(int(gi.config.get("COLUMNAR_WATERMARK_LAG_MS") or 100) / 1000.0 + 0.01)
    out["events_applied"] = gi.columnar.tail_once()
    out["delta_apply_ms"] = (time.perf_counter() - t0) * 1000.0
    # the CPU twin's replicas are seeded again over its refreshed row store, not
    # tailed: the tail is host numpy, which the card's instance runs, and the card's
    # tailed replicas are held to the twin's fresh seeds
    t0 = time.perf_counter()
    for t in COLUMNAR_TABLES:
        ci.columnar.drop("tpch", t)
    _advance(ci)
    for t in COLUMNAR_TABLES:
        ci.columnar.ensure_ready("tpch", t)
    out["cpu_reseed_ms"] = (time.perf_counter() - t0) * 1000.0
    out["replicas_refreshed"] = _replica_line(gi)
    li = out["replicas_refreshed"]["tpch.lineitem"]
    say("columnar_step", step="refresh", events=out["events_applied"],
        delta_apply_ms=out["delta_apply_ms"],
        cpu_reseed_ms=out["cpu_reseed_ms"], delta_rows=li["delta_rows"],
        compactions=li["compactions"])
    if any(r["state"] != "READY" or r["reseeds"]
           for r in out["replicas_refreshed"].values()):
        raise AssertionError(f"a replica left READY: {out['replicas_refreshed']}")
    after = _routed_round(gs, cs, "refreshed", out)
    if after == before:
        raise AssertionError("the refresh moved no routed answer")

    # a flashback read from before the refresh
    as_of, ms = _timed(gs, _as_of(SQL[6], w0))
    if not _rows_match(as_of.rows, before[6])[0]:
        raise AssertionError(f"Q6 AS OF TSO {w0}: {as_of.rows} != {before[6]}")
    out["as_of_before_refresh"] = {"ts": w0, "ms": ms, "rows": as_of.rows}

    out["unsigned"] = {}
    _unsigned_query(gi, ci, out["unsigned"])
    say("columnar_step", step="unsigned", **{k: v["ms"] for k, v in out["unsigned"].items()})
    _dates_table(gi, ci, gs, cs)
    out["rf_star"] = {}
    _rf_star(gs, cs, out["rf_star"])
    out["archive"] = {}
    _archive_check(gi, gs, out["archive"], cs)
    out["metrics"] = {"routed": gi.columnar.routed.value,
                      "pruned": gi.columnar.pruned.value,
                      "events_applied": gi.columnar.events_applied.value,
                      "rows_applied": gi.columnar.rows_applied.value}
    out["launches"] = _launch_counts()
    missing = [k for k in KERNELS if out["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the columnar phase: {missing}")
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    out["device_cache_bytes"] = gi.device_cache.nbytes
    for inst in (gi, ci):
        inst.shutdown()
    gs.close()
    cs.close()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.exec import spill
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(args, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(spill.SPILL_MANAGER.directory, ignore_errors=True)


T_START = time.perf_counter()


def run(args, data_dir) -> int:
    import torch
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_build, cuda_join
    from galaxysql_tpu_torch.storage import transfer

    card = card_line()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    cuda_build.build()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        sources=list(cuda_build.SOURCES))

    t0 = time.perf_counter()
    inst, s, table_rows = load_tpch(args.sf, data_dir=data_dir)
    s.execute(f"SET GLOBAL JOIN_SPILL_BYTES = {MAIN_JOIN_SPILL_BYTES}")
    # the per-query memory pool of the admission plane beside it: a build past the
    # default 4 GiB QUERY_MEM_BYTES would spill through the pool instead
    s.execute(f"SET GLOBAL QUERY_MEM_BYTES = {MAIN_JOIN_SPILL_BYTES}")
    say("load", sf=args.sf, seconds=round(time.perf_counter() - t0, 3), rows=table_rows)

    capture = kernel_capture()
    try:
        torch.cuda.reset_peak_memory_stats()
        rows, timed, first, per_query, launches, spilled = run_main_path(s, capture)
    finally:
        capture.restore()
    say("main_path", enable_fragment_cache=0, sf=args.sf, query_ms=timed,
        first_run_ms=first, launches=launches, launches_per_query=per_query, spilled_per_query=spilled,
        join_spill_bytes=MAIN_JOIN_SPILL_BYTES,
        kernel_shapes={k: sorted(set(v)) for k, v in capture.shapes.items()},
        peak_device_bytes=int(torch.cuda.max_memory_allocated()),
        device_cache_bytes=inst.device_cache.nbytes,
        result_rows={q: len(r) for q, r in rows.items()})

    repeat_ms, gen2 = warm_repeats(s, rows)
    say("warm_repeats", query_ms=repeat_ms,
        median_ms={q: statistics.median(v) for q, v in repeat_ms.items()},
        gen2_collections=gen2)

    kernels = check_kernels(capture, launches)
    say("kernels", cases="main-path inputs + edge cases", repeats=CHECK_REPEATS, ok=True)
    say("kernel_scaling", kernels=kernel_scaling(inst))

    cpu_ms, cpu_inst = cpu_reference(inst, rows)
    say("reference", device="cpu", query_ms=cpu_ms, equal=True,
        held_to_analyzed_tpch=[5])

    from galaxysql_tpu_torch.plan import logical as L
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.storage.window_queries import WINDOW_QUERIES
    q5_no_stats = L.explain(inst.planner.plan_select(SQL[5], "tpch", [], s).rel)
    phase_capture = kernel_capture()
    launches_by_phase = {}
    try:
        line, (analyzed, gs, _ci, cs), held = analyzed_tpch(
            inst, data_dir=os.path.join(data_dir, "analyzed"))
        line["q5_plan_no_stats"] = q5_no_stats.splitlines()
        launches_by_phase["analyzed_tpch"] = line["launches"]
        unspilled, unspilled_ms = line.pop("rows"), line["query_ms"]
        if not _rows_match(rows[5], unspilled["Q5"])[0]:
            raise AssertionError("Q5: the main path's rows differ from analyzed_tpch's")
        say("analyzed_tpch", enable_fragment_cache=0, sf=args.sf, **line)
        line = run_phase(gs, cs, "tpch", WINDOW_QUERIES,
                         cpu_queries=set(WINDOW_QUERIES) - set(WINDOW_CARD_ONLY))
        launches_by_phase["window"] = line["launches"]
        say("window", enable_fragment_cache=0, sf=args.sf, **line)
        line = tpcds_phase(args.sf * TPCDS_SF_SCALE)
        launches_by_phase["tpcds"] = line["launches"]
        say("tpcds", enable_fragment_cache=0, **line)
    finally:
        phase_capture.restore()
    for phase in ("analyzed_tpch", "tpcds"):
        missing = [k for k in KERNELS if launches_by_phase[phase].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {phase}: {missing}")
    new_inputs = check_new_phase_inputs(phase_capture, launches_by_phase)

    from galaxysql_tpu_torch.server.session import Session
    hub_capture = kernel_capture()
    try:
        hub = exec_hub_phase(gs, cs, {q: unspilled[f"Q{q}"] for q in EXEC_HUB_QUERIES},
                             s, Session(cpu_inst, "tpch"))
    finally:
        hub_capture.restore()
    print(card, flush=True)
    say("exec_hub", nvidia_smi=card, enable_fragment_cache=1, **hub)
    hub_inputs = check_new_phase_inputs(hub_capture, {"exec_hub": hub["launches"]})

    mpp_capture = kernel_capture()
    try:
        mpp = mpp_phase(gs, {q: unspilled[f"Q{q}"] for q in range(1, 23)},
                        unspilled_ms, args.sf)
    finally:
        mpp_capture.restore()
    print(card, flush=True)
    say("mpp", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf, **mpp)
    mpp_inputs = check_new_phase_inputs(mpp_capture, {"mpp": mpp["launches"]})

    workers_capture = kernel_capture()
    try:
        workers = workers_phase(analyzed, {f"Q{q}": unspilled[f"Q{q}"]
                                           for q in WORKER_QUERIES},
                                unspilled_ms, os.path.join(data_dir, "workers"))
    finally:
        workers_capture.restore()
    print(card, flush=True)
    show = workers["replica"].pop("show_workers")
    say("workers", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf, **workers)
    say("workers_show", show_workers=show)
    workers_inputs = check_new_phase_inputs(workers_capture,
                                            {"workers": workers["launches"]})

    ops_capture = kernel_capture()
    try:
        ops = ops_phase(analyzed, _ci,
                        {f"Q{q}": unspilled[f"Q{q}"] for q in
                         set(OPS_SUMMARY_QUERIES + OPS_AP_QUERIES + OPS_PRESSURE_QUERIES)})
    finally:
        ops_capture.restore()
    print(card, flush=True)
    say("ops", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf,
        seconds=ops["seconds"], launches=ops["launches"],
        sheds_retried=ops["sheds_retried"],
        step_s={k: v["step_s"] for k, v in ops.items() if isinstance(v, dict)
                and "step_s" in v})
    ops_inputs = check_new_phase_inputs(ops_capture, {"ops": ops["launches"]})

    placement_capture = kernel_capture()
    try:
        placement = placement_phase(analyzed, _ci,
                                    {f"Q{q}": unspilled[f"Q{q}"] for q in
                                     set(PLACEMENT_QUERIES + PLACEMENT_ROUTED_QUERIES)})
    finally:
        placement_capture.restore()
    print(card, flush=True)
    say("placement", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf,
        seconds=placement["seconds"], launches=placement["launches"],
        step_s={k[:-2]: v for k, v in placement.items() if k.endswith("_s")})
    placement_inputs = check_new_phase_inputs(placement_capture,
                                              {"placement": placement["launches"]})

    formulations = formulations_phase(analyzed, unspilled, args.sf)
    print(card, flush=True)
    say("formulations", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf,
        **{k: v for k, v in formulations.items() if k != "queries"})
    tp_host = tp_host_phase(inst, args.sf)
    print(card, flush=True)
    say("tp_host", nvidia_smi=card, enable_fragment_cache=0, sf=args.sf, **tp_host)
    host_agg = host_agg_phase()
    say("host_agg", nvidia_smi=card, enable_fragment_cache=0, **host_agg)
    unspilled = {k: v for k, v in unspilled.items()
                 if k in {f"Q{q}" for q in SPILL_QUERIES}}
    gs.close()
    del gs, _ci, cs, line

    dml_capture = kernel_capture()
    try:
        line = dml_phase(inst, args.sf, held, analyzed)
    finally:
        dml_capture.restore()
    print(card, flush=True)
    say("dml", enable_fragment_cache=0, sf=args.sf, nvidia_smi=card, **line)
    dml_inputs = check_new_phase_inputs(dml_capture, {"dml": line["launches"]})
    for entry in kernels:
        entry["new_phases"] = new_inputs[entry["name"]]
        entry["new_phases"]["launches"]["exec_hub"] = hub["launches"][entry["name"]]
        entry["new_phases"]["exec_hub_input"] = hub_inputs[entry["name"]]
        entry["new_phases"]["launches"]["mpp"] = mpp["launches"][entry["name"]]
        entry["new_phases"]["mpp_input"] = mpp_inputs[entry["name"]]
        entry["new_phases"]["launches"]["workers"] = workers["launches"][entry["name"]]
        entry["new_phases"]["workers_input"] = workers_inputs[entry["name"]]
        entry["new_phases"]["launches"]["ops"] = ops["launches"][entry["name"]]
        entry["new_phases"]["ops_input"] = ops_inputs[entry["name"]]
        entry["new_phases"]["launches"]["placement"] = \
            placement["launches"][entry["name"]]
        entry["new_phases"]["placement_input"] = placement_inputs[entry["name"]]
        entry["new_phases"]["launches"]["formulations"] = \
            formulations["launches"][entry["name"]]
        entry["new_phases"]["launches"]["tp_host"] = tp_host["launches"][entry["name"]]
        entry["new_phases"]["launches"]["host_agg"] = host_agg["launches"][entry["name"]]
        entry["new_phases"]["launches"]["dml"] = line["launches"][entry["name"]]
        entry["new_phases"]["dml_input"] = dml_inputs[entry["name"]]

    _reset_launches()
    line, (sb_gpu, sb_cpu) = point_phase(inst)
    line["launches"] = _launch_counts()
    print(card, flush=True)
    say("point", enable_fragment_cache=0, nvidia_smi=card, **line)
    for entry in kernels:
        entry["new_phases"]["launches"]["point"] = line["launches"][entry["name"]]

    _reset_launches()
    line = wire_phase(inst, cpu_inst, sb_gpu, sb_cpu)
    print(card, flush=True)
    say("wire", enable_fragment_cache=0, nvidia_smi=card, **line)
    for entry in kernels:
        entry["new_phases"]["launches"]["wire"] = line["launches"][entry["name"]]

    customer = transfer.arrays_of(inst.store("tpch", "customer"))  # ddl purges it
    _reset_launches()
    ddl_capture = kernel_capture()
    try:
        line = ddl_phase(inst, cpu_inst, sb_gpu, sb_cpu)
    finally:
        ddl_capture.restore()
    print(card, flush=True)
    say("ddl", enable_fragment_cache=0, nvidia_smi=card, **line)
    ddl_inputs = check_new_phase_inputs(ddl_capture, {"ddl": line["launches"]})
    for entry in kernels:
        entry["new_phases"]["launches"]["ddl"] = line["launches"][entry["name"]]
        entry["new_phases"]["ddl_input"] = ddl_inputs[entry["name"]]

    _reset_launches()
    durable_capture = kernel_capture()
    try:
        line, booted = durable_phase(inst, cpu_inst, customer, args.sf)
    finally:
        durable_capture.restore()
    print(card, flush=True)
    say("durable", enable_fragment_cache=0, nvidia_smi=card, **line)
    durable_inputs = check_new_phase_inputs(durable_capture,
                                            {"durable": line["launches"]})
    for entry in kernels:
        entry["new_phases"]["launches"]["durable"] = line["launches"][entry["name"]]
        entry["new_phases"]["durable_input"] = durable_inputs[entry["name"]]

    _reset_launches()
    cdc_capture = kernel_capture()
    try:
        line = cdc_phase(booted, cpu_inst, sb_gpu, sb_cpu)
    finally:
        cdc_capture.restore()
    print(card, flush=True)
    say("cdc", enable_fragment_cache=0, nvidia_smi=card, **line)
    cdc_inputs = check_new_phase_inputs(cdc_capture, {"cdc": line["launches"]})
    for entry in kernels:
        entry["new_phases"]["launches"]["cdc"] = line["launches"][entry["name"]]
        entry["new_phases"]["cdc_input"] = cdc_inputs[entry["name"]]

    _reset_launches()
    line = load_data_phase(analyzed, sb_gpu, os.path.join(data_dir, "load"))
    print(card, flush=True)
    say("load_data", enable_fragment_cache=0, nvidia_smi=card, **line)
    for entry in kernels:
        entry["new_phases"]["launches"]["load_data"] = line["launches"][entry["name"]]

    _reset_launches()
    spill_capture = kernel_capture()
    try:
        line = spill_phase(analyzed, unspilled, unspilled_ms)
    finally:
        spill_capture.restore()
    print(card, flush=True)
    say("spill", enable_fragment_cache=0, nvidia_smi=card, **line)
    spill_inputs = check_new_phase_inputs(spill_capture, {"spill": line["launches"]})
    for entry in kernels:
        entry["new_phases"]["launches"]["spill"] = line["launches"][entry["name"]]
        entry["new_phases"]["spill_input"] = spill_inputs[entry["name"]]

    _reset_launches()
    columnar_capture = kernel_capture()
    try:
        line = columnar_phase(analyzed, args.sf)
    finally:
        columnar_capture.restore()
    print(card, flush=True)
    say("columnar", enable_fragment_cache=0, nvidia_smi=card, **line)
    columnar_inputs = check_new_phase_inputs(columnar_capture,
                                             {"columnar": line["launches"]})
    for entry in kernels:
        entry["new_phases"]["launches"]["columnar"] = line["launches"][entry["name"]]
        entry["new_phases"]["columnar_input"] = columnar_inputs[entry["name"]]
    say("script", seconds=time.perf_counter() - T_START)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
