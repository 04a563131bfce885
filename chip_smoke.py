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

It prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.  Any failure
exits non-zero without that line; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
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


def check_kernels(capture, launches, device="cuda"):
    """Every kernel against its plain version, bit for bit; times and bounds."""
    import torch
    from galaxysql_tpu_torch.kernels import cuda_agg, cuda_join
    slot_cases, expand_cases, place_cases = edge_cases(device)
    failures = []
    results = []

    def compare(name, label, kernel, plain):
        same, err = _held(kernel, plain())
        if not same:
            failures.append(f"{name} [{label}]")
        return err

    # build_slots / hash_slots
    for name in ("build_slots", "hash_slots"):
        err = 0.0
        for label, keys, live in slot_cases:
            M = 1 << max(4, int(max(keys[0][0].shape[0], 1) * 4 - 1).bit_length())
            if name == "build_slots":
                err = max(err, compare(name, label,
                                       lambda: cuda_join.build_slots(keys, live, M),
                                       lambda: cuda_join.build_slots_plain(keys, live, M)))
            else:
                err = max(err, compare(name, label, lambda: cuda_join.hash_slots(keys, M),
                                       lambda: cuda_join.hash_slots_plain(keys, M)))
        args = capture.calls[name][1]
        if name == "build_slots":
            keys, live, M = args
            kern = lambda: cuda_join.build_slots(keys, live, M)  # noqa: E731
            plain = lambda: cuda_join.build_slots_plain(keys, live, M)  # noqa: E731
            nbytes = _lane_bytes(keys) + live.numel() + 4 * live.numel()
        else:
            keys, M = args
            kern = lambda: cuda_join.hash_slots(keys, M)  # noqa: E731
            plain = lambda: cuda_join.hash_slots_plain(keys, M)  # noqa: E731
            nbytes = _lane_bytes(keys) + 4 * keys[0][0].numel()
        n = keys[0][0].numel()
        err = max(err, compare(name, "main path input", kern, plain))
        ops = n * (24 * len(keys) + 2)
        results.append(_entry(name, launches, err, kern, plain, nbytes, ops,
                              shape=f"n={n} lanes={len(keys)} M={M}"))

    # expand_offsets
    err = 0.0
    for label, counts, starts, cap in expand_cases:
        err = max(err, compare("expand_offsets", label,
                               lambda: cuda_join.expand_offsets(counts, starts, cap),
                               lambda: cuda_join.expand_offsets_plain(counts, starts, cap)))
    counts, starts, cap = capture.calls["expand_offsets"][1]
    if not torch.equal(starts, torch.cumsum(counts, 0) - counts):
        raise AssertionError("expand_offsets: the main path passed starts that are not the "
                             "exclusive prefix sum of counts")
    kern = lambda: cuda_join.expand_offsets(counts, starts, cap)  # noqa: E731
    plain = lambda: cuda_join.expand_offsets_plain(counts, starts, cap)  # noqa: E731
    err = max(err, compare("expand_offsets", "main path input", kern, plain))
    npr = counts.numel()
    total = int(counts.sum())
    arange = torch.arange(npr, dtype=torch.int32, device=counts.device)
    # the nearest one-call library function: covers [0, total) only (no tail, no cap)
    library = lambda: torch.repeat_interleave(arange, counts, output_size=total)  # noqa: E731
    results.append(_entry("expand_offsets", launches, err, kern, plain,
                          _expand_bytes(npr, cap), 4 * npr + 3 * cap,
                          shape=f"npr={npr} cap={cap} total={total}",
                          library=library))

    # hash_place
    err = 0.0
    for label, (ident, live_, s0, step, M), rounds in place_cases:
        err = max(err, compare(
            "hash_place", label,
            lambda: cuda_agg.hash_place(ident, live_, s0, step, M, rounds),
            lambda: cuda_agg.hash_place_plain(ident, live_, s0, step, M, rounds)))
    ident, live, s0, step, M, rounds = capture.calls["hash_place"][1]
    kern = lambda: cuda_agg.hash_place(ident, live, s0, step, M, rounds)  # noqa: E731
    plain = lambda: cuda_agg.hash_place_plain(ident, live, s0, step, M, rounds)  # noqa: E731
    err = max(err, compare("hash_place", "main path input", kern, plain))
    n = live.numel()
    nbytes = _place_bytes(ident, n, M)
    results.append(_entry("hash_place", launches, err, kern, plain, nbytes,
                          n * (12 + 4 * len(ident)) + M,
                          shape=f"n={n} lanes={len(ident)} M={M} max_rounds={rounds}"))
    if failures:
        raise AssertionError(f"kernel differs from its plain version: {failures}")
    return results


def _expand_bytes(npr, cap) -> int:
    # what the function needs under its precondition: `starts` (8 B a probe row), the
    # last row's count (the pair total) and the owner map written (4 B a slot); a
    # row's count is the next row's start minus its own
    return 8 * npr + 8 + 4 * cap


def _place_bytes(ident, n, M) -> int:
    # live, s0/step and identity lanes read; rep, resolved and gid written
    return n + 16 * n + _lane_bytes(ident) + 4 * M + n + 4 * n


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
            **_bound(_place_bytes(ident, n, M))}]

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
            "launches": launches[name], "max_abs_err": err,
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

    capture = Capture([
        (cuda_join, "build_slots", lambda keys, live, M: keys[0][0].numel()),
        (cuda_join, "hash_slots", lambda keys, M: keys[0][0].numel()),
        (cuda_join, "expand_offsets", lambda counts, starts, cap: cap),
        (cuda_agg, "hash_place", lambda ident, live, s0, step, M, r: live.numel()),
    ])
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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
