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
   spread of warm times within the call;
4. kernels: each kernel's wrapper against its plain PyTorch version on the same CUDA
   tensors — the inputs the main path gave it, plus seeded edge cases (NULL lanes,
   duplicates, negative keys, dead rows, empty input, an overflowing round limit, a
   long collision chain, a hot probe row, leading and trailing empty probe rows, a
   pair capacity equal to the pair count or cutting a segment) —
   each kernel run CHECK_REPEATS times against one plain result, compared bit for
   bit, and timed with CUDA events;
5. kernel scaling: the two kernels redesigned for the card (`expand_offsets`,
   `hash_place`) at a large shape, bit-checked against their plain versions and timed;
6. reference: the same four queries through the port on the CPU (where every kernel
   call site takes its plain version) over the same lanes; rows must be equal.

Then ANALYZE, all of TPC-H, TPC-DS and window functions, each phase on instances of its
own, its launch counters set to 0 just before its timed runs and read just after:

7. analyzed_tpch: `ANALYZE TABLE` on the eight TPC-H tables, then all 22 queries twice
   each (the second run timed), with each query's launches and join order; rows must
   equal the port on the CPU over the same lanes, also ANALYZEd;
8. tpcds: `tpcds.generate(--sf)` loaded with `insert_pylists`, ANALYZEd, the 10
   queries twice each; rows must equal the port on the CPU;
9. window: window queries over `orders` and `lineitem` (every `WindowSpec` kind and
   frame, NULL partition keys, one partition spanning every row), compared with the
   port on the CPU through an outer aggregate.

Then writes and transactions, on a card instance and a CPU instance of their own
holding copies of the main path's lanes; every statement runs on both, in the same
order, and every result must be equal (of the 22 queries after the refresh, the
DML_CPU_QUERIES):

10. dml: (a) TPC-H's refresh functions in a transaction, after ANALYZE: session W
    runs BEGIN, RF1 (SF x 1,500 new orders and their lineitems,
    `storage/tpch_refresh.py`) as a few multi-row INSERTs and RF2 (SF x 1,500 orders
    and their lineitems deleted); Q1, Q3 and Q18 in W see its writes, in a second
    session R the snapshot from before; COMMIT; then all 22 queries twice each (the
    second run timed), DML_CPU_QUERIES of them also on the CPU.  (b) A rollback: an
    UPDATE of lineitem and a DELETE of orders, Q4 and Q6 inside, ROLLBACK, and Q4
    and Q6 equal their rows from before.  (c) A write conflict: W updates an order
    in a transaction, R's update of the same row raises `TransactionError`, W
    commits and R's retry succeeds.  (d) The sysbench `oltp_read_write` mix
    (`storage/sysbench.py`) on one 1,000,000-row table, OLTP_TRANSACTIONS
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
    Python threads, one `Session` each, POINT_PER_SESSION statements a session, with
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

Floats in 7-10 compare as `tests/test_tpcds.py` compares them (relative and absolute
1e-6); every other value must be equal.  The largest input the phases 7-9 gave each
kernel, and apart from it the largest input the dml phase gave it, are then held
against the kernel's plain version CHECK_REPEATS times and timed, beside the main
path's, in the kernel's `new_phases` entry.

It prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.  Any failure
exits non-zero without that line; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12       # non-tensor 32-bit rate of an H100 SXM, used for int ops
SPIN_CYCLES = 50_000_000    # ~25 ms of the card's clock: longer than enqueueing 10 calls
CHECK_REPEATS = 20          # kernel runs held against one plain result, per input
WARM_REPEATS = 7            # extra warm runs of each query after the main path
QUERIES = (1, 3, 5, 6)
OLTP_ROWS = 1_000_000       # rows of the sysbench table in the dml phase
OLTP_TRANSACTIONS = 20      # oltp_read_write transactions in the dml phase
POINT_STATEMENTS = 1000     # sequential oltp_point_select statements in the point phase
POINT_SESSIONS = (64, 256)  # closed-loop session counts of the point phase
POINT_PER_SESSION = 16      # statements each session runs in a closed loop
FLUSH_KEYS = (1, 64, 1024)  # keys of the timed batched_point_lookup calls
# the queries after the refresh that are also run on the CPU and compared: all 22
# put the script past 600 s on the card's machine, so the CPU side is cut to these
DML_CPU_QUERIES = (1, 3, 4, 5, 6, 10, 12, 18, 21)
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
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- main path ------------------------------------------------------------------

def load_tpch(sf: float, device="cuda"):
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch
    data = tpch.generate(sf)
    inst = Instance(device=device)
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
    first, first_ms = {}, {}
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = s.execute(SQL[q])
        torch.cuda.synchronize()
        timed[q] = (time.perf_counter() - t0) * 1000.0
        after = {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}
        per_query[q] = {k: after[k] - before[k] for k in after}
        rows[q] = rs.rows
        if rs.rows != first[q]:
            raise AssertionError(f"Q{q}: second run returned other rows than the first")
    launches = {**cuda_join.LAUNCHES, **cuda_agg.LAUNCHES}
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return rows, timed, first_ms, per_query, launches


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
    inst = Instance(device="cpu")
    s = Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        parts, dicts = transfer.arrays_of(gpu_inst.store("tpch", t))
        inst.install_store(transfer.store_from_arrays(inst.catalog.table("tpch", t),
                                                      parts, dicts))
    times = {}
    for q in QUERIES:
        t0 = time.perf_counter()
        rows = s.execute(SQL[q]).rows
        times[q] = (time.perf_counter() - t0) * 1000.0
        if rows != rows_gpu[q]:
            raise AssertionError(f"Q{q}: rows on the card differ from the port on the CPU:"
                                 f"\n  cuda {rows_gpu[q][:3]}\n  cpu  {rows[:3]}")
    return times


# -- ANALYZE, all of TPC-H, TPC-DS, window functions ---------------------------------

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


def _copy_instance(src_inst, schema, tables, ddl, device):
    """A fresh instance on `device` holding `src_inst`'s tables of `schema` (the same
    host lanes, carried through `storage.transfer`); no plan has run on it."""
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import transfer
    inst = Instance(device=device)
    s = Session(inst)
    s.execute(f"CREATE DATABASE {schema}")
    s.execute(f"USE {schema}")
    for t in tables:
        s.execute(ddl[t])
        parts, dicts = transfer.arrays_of(src_inst.store(schema, t))
        inst.install_store(transfer.store_from_arrays(inst.catalog.table(schema, t),
                                                      parts, dicts))
    return inst, s


def _analyze(s, tables) -> float:
    t0 = time.perf_counter()
    s.execute("ANALYZE TABLE " + ", ".join(tables))
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


def run_phase(s_gpu, s_cpu, schema, queries, reset=True, cpu_queries=None):
    """Each query twice on the card (the second run timed, launch counters set to 0
    just before the timed runs and read just after), once on the CPU; rows compared.
    With `reset=False` neither the launch counters nor the peak memory are set back:
    they then count from the caller's own start.  `cpu_queries` names the queries
    compared on the CPU (default: all)."""
    import torch
    first, timed, per_query, rows_n, plans = {}, {}, {}, {}, {}
    rows = {}
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = s_gpu.execute(sql)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t0) * 1000.0
        after = _launch_counts()
        per_query[name] = {k: after[k] - before[k] for k in after}
        if rs.rows != rows[name]:
            raise AssertionError(f"{name}: second run returned other rows than the first")
        rows_n[name] = len(rs.rows)
    launches = _launch_counts()
    peak = int(torch.cuda.max_memory_allocated())
    cpu_ms, floats, worst = {}, 0, 0.0
    for name, sql in queries.items():
        plans[name] = join_order(s_gpu.instance.planner.plan_select(
            sql, schema, [], s_gpu).rel)
        if cpu_queries is not None and name not in cpu_queries:
            continue
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
            "float_cells": floats, "max_float_rel_diff": worst, "equal": True}


def analyzed_tpch(inst):
    """Fresh card and CPU instances over the main path's TPC-H lanes, both ANALYZEd
    before any query (so no plan baseline predates the statistics)."""
    from galaxysql_tpu_torch.plan import logical as L
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi, gs = _copy_instance(inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cuda")
    ci, cs = _copy_instance(inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cpu")
    analyze_ms = _analyze(gs, tpch.TABLE_ORDER)
    _analyze(cs, tpch.TABLE_ORDER)
    line = run_phase(gs, cs, "tpch", {f"Q{q}": SQL[q] for q in range(1, 23)})
    line["analyze_ms"] = analyze_ms
    line["q5_plan_analyzed"] = L.explain(
        gi.planner.plan_select(SQL[5], "tpch", [], gs).rel).splitlines()
    return line, (gi, gs, ci, cs)


def tpcds_phase(sf):
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpcds
    t0 = time.perf_counter()
    data = tpcds.generate(sf)
    gen_ms = (time.perf_counter() - t0) * 1000.0
    gi = Instance(device="cuda")
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
    _analyze(cs, tpcds.TABLE_ORDER)
    line = run_phase(gs, cs, "tpcds", tpcds.QUERIES)
    line.update(sf=sf, generate_ms=gen_ms, load_ms=load_ms, analyze_ms=analyze_ms,
                rows={t: gi.store("tpcds", t).row_count() for t in tpcds.TABLE_ORDER})
    return line


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


def dml_tpch(src_inst, sf):
    """(a) refresh in a transaction, (b) rollback, (c) conflict, on fresh copies."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch, tpch_refresh
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    gi, gw = _copy_instance(src_inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cuda")
    ci, cw = _copy_instance(src_inst, "tpch", tpch.TABLE_ORDER, tpch.TPCH_DDL, "cpu")
    gr, cr = Session(gi, "tpch"), Session(ci, "tpch")
    # statistics first, as a deployment has them: the plans are analyzed_tpch's
    line = {"analyze_ms": _analyze(gw, tpch.TABLE_ORDER)}
    _analyze(cw, tpch.TABLE_ORDER)
    inside_q = (1, 3, 18)
    before = {q: _both(gr, cr, SQL[q], f"Q{q} before the refresh")[0].rows
              for q in inside_q}
    since = (gi.device_cache.misses, gi.device_cache.hits)

    keys = np.concatenate([p.lanes["o_orderkey"]
                           for p in gi.store("tpch", "orders").partitions])
    rows = tpch_refresh.rf1_rows(sf, int(keys.max()))
    rf1 = tpch_refresh.rf1_statements(rows)
    rf2 = tpch_refresh.rf2_statements(tpch_refresh.rf2_keys(sf, keys))
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
    n_orders = tpch_refresh.refresh_orders(sf)
    n_lines = len(rows["lineitem"]["l_orderkey"])
    if sum(affected[:len(rf1)]) != n_orders + n_lines or affected[-1] != n_orders:
        raise AssertionError(f"refresh affected {affected}")
    inside_ms, outside_ms = {}, {}
    for q in inside_q:
        rs, inside_ms[f"Q{q}"] = _both(gw, cw, SQL[q], f"Q{q} inside the refresh")
        if q == 1 and rs.rows == before[q]:
            raise AssertionError("Q1 inside the refresh does not see its writes")
        rs, outside_ms[f"Q{q}"] = _both(gr, cr, SQL[q], f"Q{q} in the other session")
        if rs.rows != before[q]:
            raise AssertionError(f"Q{q} in the other session does not see the snapshot "
                                 "from before the refresh")
    _rs, commit_ms = _both(gw, cw, "COMMIT", "COMMIT")
    line.update(rf1_statements=len(rf1), rf1_rows={"orders": n_orders,
                                                   "lineitem": n_lines},
                rf1_ms=rf1_ms, rf2_ms=rf2_ms, rf2_rows_deleted=affected[len(rf1):],
                inside_ms=inside_ms, other_session_ms=outside_ms, commit_ms=commit_ms)
    after = run_phase(gw, cw, "tpch", {f"Q{q}": SQL[q] for q in range(1, 23)},
                      reset=False, cpu_queries={f"Q{q}" for q in DML_CPU_QUERIES})
    line["after_commit"] = {k: after[k] for k in (
        "query_ms", "first_run_ms", "launches_per_query", "result_rows", "cpu_ms",
        "float_cells", "max_float_rel_diff", "equal")}
    line["after_commit"]["query_ms_sum"] = sum(after["query_ms"].values())
    line["after_commit"]["first_run_ms_sum"] = sum(after["first_run_ms"].values())
    line.update(_cache_line(gi, since))

    # (b) rollback
    rb_q = (4, 6)
    before = {q: _both(gw, cw, SQL[q], f"Q{q} before the rollback")[0].rows
              for q in rb_q}
    rb = {}
    for sql in ("BEGIN",
                "UPDATE lineitem SET l_discount = l_discount + 0.01 "
                "WHERE l_shipdate < DATE '1993-01-01'",
                "DELETE FROM orders WHERE o_orderdate < DATE '1992-03-01'"):
        rs, ms = _both(gw, cw, sql, sql[:30])
        rb[sql.split()[0].lower()] = {"ms": ms, "affected": rs.affected}
    for q in rb_q:
        _rs, rb[f"Q{q}_inside_ms"] = _both(gw, cw, SQL[q], f"Q{q} inside the rollback")
    _rs, rb["rollback_ms"] = _both(gw, cw, "ROLLBACK", "ROLLBACK")
    for q in rb_q:
        rs, rb[f"Q{q}_after_ms"] = _both(gw, cw, SQL[q], f"Q{q} after the rollback")
        if rs.rows != before[q]:
            raise AssertionError(f"Q{q} after ROLLBACK differs from before the "
                                 "transaction")
    line["rollback"] = rb

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
    """(d) The sysbench oltp_read_write mix on one table of OLTP_ROWS rows."""
    import numpy as np
    import torch
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import sysbench
    gi = Instance(device="cuda")
    gs = Session(gi)
    gs.execute("CREATE DATABASE sbtest")
    gs.execute("USE sbtest")
    gs.execute(sysbench.ddl())
    t0 = time.perf_counter()
    gi.store("sbtest", "sbtest1").insert_arrays(sysbench.generate(OLTP_ROWS, seed),
                                                gi.tso.next_timestamp())
    load_ms = (time.perf_counter() - t0) * 1000.0
    _ci, cs = _copy_instance(gi, "sbtest", ["sbtest1"], {"sbtest1": sysbench.ddl()},
                             "cpu")
    since = (gi.device_cache.misses, gi.device_cache.hits)
    rng = np.random.default_rng(seed)
    kinds, txn_ms = {}, []
    for _ in range(OLTP_TRANSACTIONS):
        total = 0.0
        for kind, sql in sysbench.transaction(rng, OLTP_ROWS):
            rs, ms = _both(gs, cs, sql, f"oltp {kind}")
            if kind in ("index_update", "non_index_update", "delete", "insert") \
                    and rs.affected != 1:
                raise AssertionError(f"oltp {kind} affected {rs.affected} rows")
            kinds.setdefault(kind, []).append(ms)
            total += ms
        txn_ms.append(total)
    line = {"rows": OLTP_ROWS, "transactions": OLTP_TRANSACTIONS, "load_ms": load_ms,
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


def dml_phase(inst, sf):
    import torch
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    line = dml_tpch(inst, sf)
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
    if not s_gpu.last_trace or not s_gpu.last_trace[0].startswith("point-plan"):
        raise AssertionError(f"the fast path did not serve {stmts[-1]}: "
                             f"{s_gpu.last_trace}")
    return {"statements": len(stmts), "first_run_ms": ms[0],
            "fast_p50_ms": _pct(ms[1:], 50), "fast_p99_ms": _pct(ms[1:], 99),
            "fast_max_ms": max(ms[1:])}


def _closed_loop(inst, schema, stmt, n_sessions, per_session, expected):
    """`n_sessions` Python threads, one `Session` each, each running
    `per_session` statements `stmt(i, j)` back to back (sessions and threads are
    made before the clock starts).  Every row must equal `expected[sql]`.  Returns
    the QPS and per-statement latencies."""
    import threading
    from galaxysql_tpu_torch.server.session import Session
    sessions = [Session(inst, schema) for _ in range(n_sessions)]
    lat = [[] for _ in range(n_sessions)]
    errors = []
    start = threading.Barrier(n_sessions + 1)

    def run(i):
        try:
            start.wait(timeout=120)
            for j in range(per_session):
                sql = stmt(i, j)
                t0 = time.perf_counter()
                rows = sessions[i].execute(sql).rows
                lat[i].append((time.perf_counter() - t0) * 1000.0)
                if rows != expected[sql]:
                    raise AssertionError(f"{sql}: {rows} / {expected[sql]}")
        except BaseException as e:  # carried to the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_sessions)]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for sx in sessions:
        sx.close()
    if errors:
        raise errors[0]
    flat = [x for row in lat for x in row]
    return {"qps": len(flat) / wall, "p50_ms": _pct(flat, 50), "p99_ms": _pct(flat, 99),
            "seconds": wall}


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
    gi = Instance(device=device)
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
    ids = rng.integers(1, OLTP_ROWS + 1, max(POINT_SESSIONS) * POINT_PER_SESSION)
    sb_stmt = {n: (lambda i, j: f"SELECT c FROM sbtest1 WHERE id="
                                f"{int(ids[(i * POINT_PER_SESSION + j) % ids.size])}")
               for n in POINT_SESSIONS}
    o_stmt = lambda i, j: otpl % int(okeys[(i * 31 + j * 7) % okeys.size])  # noqa: E731
    expected = {}
    for n in POINT_SESSIONS:
        for i in range(n):
            for j in range(POINT_PER_SESSION):
                for sql, sess in ((sb_stmt[n](i, j), cs), (o_stmt(i, j), cos)):
                    if sql not in expected:
                        expected[sql] = sess.execute(sql).rows
    line["concurrent"] = {}
    for n in POINT_SESSIONS:
        line["concurrent"][f"sbtest1_{n}"] = _concurrent(gi, "sbtest", sb_stmt[n],
                                                         expected, n, POINT_PER_SESSION)
        line["concurrent"][f"orders_{n}"] = _concurrent(go, "tpch", o_stmt, expected, n,
                                                        POINT_PER_SESSION)
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
    if rs.rows != [(f"own-{own}",)] or not gw.last_trace[0].startswith("point-plan"):
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
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_build, cuda_join

    card = card_line()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    cuda_build.build()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        sources=list(cuda_build.SOURCES))

    t0 = time.perf_counter()
    inst, s, table_rows = load_tpch(args.sf)
    say("load", sf=args.sf, seconds=round(time.perf_counter() - t0, 3), rows=table_rows)

    capture = kernel_capture()
    try:
        torch.cuda.reset_peak_memory_stats()
        rows, timed, first, per_query, launches = run_main_path(s, capture)
    finally:
        capture.restore()
    say("main_path", sf=args.sf, query_ms=timed, first_run_ms=first,
        launches=launches, launches_per_query=per_query,
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

    cpu_ms = cpu_reference(inst, rows)
    say("reference", device="cpu", query_ms=cpu_ms, equal=True)

    from galaxysql_tpu_torch.plan import logical as L
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.storage.window_queries import WINDOW_QUERIES
    q5_no_stats = L.explain(inst.planner.plan_select(SQL[5], "tpch", [], s).rel)
    phase_capture = kernel_capture()
    launches_by_phase = {}
    try:
        line, (_gi, gs, _ci, cs) = analyzed_tpch(inst)
        line["q5_plan_no_stats"] = q5_no_stats.splitlines()
        launches_by_phase["analyzed_tpch"] = line["launches"]
        say("analyzed_tpch", sf=args.sf, **line)
        line = run_phase(gs, cs, "tpch", WINDOW_QUERIES)
        launches_by_phase["window"] = line["launches"]
        say("window", sf=args.sf, **line)
        line = tpcds_phase(args.sf)
        launches_by_phase["tpcds"] = line["launches"]
        say("tpcds", **line)
    finally:
        phase_capture.restore()
    for phase in ("analyzed_tpch", "tpcds"):
        missing = [k for k in KERNELS if launches_by_phase[phase].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {phase}: {missing}")
    new_inputs = check_new_phase_inputs(phase_capture, launches_by_phase)
    del _gi, gs, _ci, cs, line

    dml_capture = kernel_capture()
    try:
        line = dml_phase(inst, args.sf)
    finally:
        dml_capture.restore()
    print(card, flush=True)
    say("dml", sf=args.sf, nvidia_smi=card, **line)
    dml_inputs = check_new_phase_inputs(dml_capture, {"dml": line["launches"]})
    for entry in kernels:
        entry["new_phases"] = new_inputs[entry["name"]]
        entry["new_phases"]["launches"]["dml"] = line["launches"][entry["name"]]
        entry["new_phases"]["dml_input"] = dml_inputs[entry["name"]]

    _reset_launches()
    line = point_phase(inst)
    line["launches"] = _launch_counts()
    print(card, flush=True)
    say("point", nvidia_smi=card, **line)
    for entry in kernels:
        entry["new_phases"]["launches"]["point"] = line["launches"][entry["name"]]

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
