"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 -m galaxysql_tpu_torch.tools.profile_slice [--sf 1.0] [--out chiprun_out/profile]
        [--queries 1,3,5,6] [--analyze] [--warm N [--mpp 1,3,5,18]]

Loads TPC-H at `--sf` into the port on the card (with `--analyze`, then runs ANALYZE
TABLE on its eight tables; joins stay in memory, as on `chip_smoke.py`'s main path),
runs the queries twice to warm the device cache, then once more each under
`torch.profiler` (CPU and CUDA activities).  With `--warm N` it profiles nothing and
times each query N more times instead (host clock around the statement and a device
sync), then the `--mpp` queries under ENGINE(MPP) on a mesh of 8 shards of the card
(one first run, then N), and prints one JSON line of every time and the sums of the
per-query medians.  To time another checkout's package with this file, put that
checkout first on the path: `PYTHONPATH=<checkout> python3 <this file> --warm 3`.  `--queries` names TPC-H
query numbers and the window queries of `storage/window_queries.py`.  For each query it prints one JSON line: the wall time, the device-busy
time (sum of device kernel and memcpy/memset times; one stream, so they do not
overlap), the device's idle share of the wall time, the number of device operations,
the number of host reads of a device scalar (`aten::_local_scalar_dense`, each a
host-device synchronisation) and of `aten::nonzero` calls (which synchronise too),
the device operations that took the most time, and each `hash_place` call's shape
(rows, live rows, key lanes, slots, round limit, rows left unplaced: an unplaced row
makes the GROUP BY retry with twice the slots).  One Chrome trace per query goes
under `--out`.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

JOIN_SPILL_BYTES = 8 << 30  # every join of TPC-H SF 1 stays in memory
MPP_HINT = "/*+TDDL: ENGINE(MPP)*/ "


def _device_ms(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return v / 1000.0
    return 0.0


def load_tpch(sf: float):
    """TPC-H at `sf` in a CUDA `Instance`; returns a Session on it."""
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch
    data = tpch.generate(sf)
    inst = Instance(device="cuda")
    # the profiled run executes its operators: no fragment-cache replay
    inst.config.set_instance("ENABLE_FRAGMENT_CACHE", 0)
    s = Session(inst)
    s.execute(f"SET GLOBAL JOIN_SPILL_BYTES = {JOIN_SPILL_BYTES}")
    s.execute(f"SET GLOBAL QUERY_MEM_BYTES = {JOIN_SPILL_BYTES}")
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        inst.store("tpch", t).insert_arrays(data[t], inst.tso.next_timestamp())
    return s


def profile_query(s, sql: str, trace_path: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from galaxysql_tpu_torch.kernels import cuda_agg
    place = cuda_agg.hash_place
    calls = []

    def recorded(ident, live, s0, step, M, max_rounds):
        out = place(ident, live, s0, step, M, max_rounds)
        calls.append((live, len(ident), M, max_rounds, out[1]))  # read after the run
        return out

    torch.cuda.synchronize()
    cuda_agg.hash_place = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
    finally:
        cuda_agg.hash_place = place
    prof.export_chrome_trace(trace_path)
    device_ops, busy_ms, scalar_reads, nonzeros = [], 0.0, 0, 0
    for avg in prof.key_averages():
        if avg.key == "aten::_local_scalar_dense":
            scalar_reads += avg.count
        elif avg.key == "aten::nonzero":
            nonzeros += avg.count
        if getattr(avg, "device_type", None) == DeviceType.CUDA:
            ms = _device_ms(avg)
            device_ops.append((avg.key, ms, avg.count))
            busy_ms += ms
    device_ops.sort(key=lambda x: -x[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms) if wall_ms else None,
            "device_ops": sum(c for _, _, c in device_ops),
            "scalar_reads": scalar_reads, "nonzero_calls": nonzeros,
            "top_device_ops": [[k[:120], round(ms, 4), c] for k, ms, c in device_ops[:8]],
            "hash_place_calls": [{"rows": live.numel(), "live": int(live.sum()),
                                  "lanes": lanes, "slots": M, "max_rounds": r,
                                  "unplaced": int((live & ~resolved).sum())}
                                 for live, lanes, M, r, resolved in calls]}


def _timed(s, sql: str, n: int) -> list:
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1000.0)
    return out


def time_warm(s, queries: dict, n: int, mpp: list) -> dict:
    """Each query's `n` warm times, then each `mpp` query's first and `n` warm times
    under ENGINE(MPP) on 8 shards of the card; sums of the per-query medians."""
    import statistics

    import torch
    from galaxysql_tpu_torch.parallel.mesh import make_mesh
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    local = {q: _timed(s, sql, n) for q, sql in queries.items()}
    inst = s.instance
    inst._mesh = make_mesh(devices=[torch.device("cuda", 0)] * 8)
    inst.config.set_instance("ENABLE_MPP", 0)  # the hint alone runs on the mesh
    dist = {}
    for q in mpp:
        first = _timed(s, MPP_HINT + SQL[q], 1)[0]
        dist[q] = {"first": first, "warm": _timed(s, MPP_HINT + SQL[q], n)}
    return {"local_ms": local,
            "local_sum_ms": sum(statistics.median(v) for v in local.values()),
            "mpp_ms": dist,
            "mpp_sum_ms": sum(statistics.median(v["warm"]) for v in dist.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile"),
                    help="directory for the Chrome traces")
    ap.add_argument("--queries", default="1,3,5,6",
                    help="comma-separated TPC-H query numbers and window query names")
    ap.add_argument("--analyze", action="store_true",
                    help="ANALYZE TABLE the eight tables before the runs")
    ap.add_argument("--warm", type=int, default=0,
                    help="time each query this many times instead of profiling it")
    ap.add_argument("--mpp", default="",
                    help="with --warm: comma-separated TPC-H queries timed under MPP")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available; this tool runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL
    from galaxysql_tpu_torch.storage.window_queries import WINDOW_QUERIES
    queries = {q: SQL[int(q)] if q.isdigit() else WINDOW_QUERIES[q]
               for q in args.queries.split(",")}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    card_name = card.stdout.strip().splitlines()[0]
    print(card_name, flush=True)
    s = load_tpch(args.sf)
    if args.analyze:
        s.execute("ANALYZE TABLE " + ", ".join(tpch.TABLE_ORDER))
    for _ in range(2):
        for sql in queries.values():
            s.execute(sql)
    if args.warm:
        mpp = [int(q) for q in args.mpp.split(",") if q]
        print(json.dumps({"sf": args.sf, "analyzed": args.analyze, "card": card_name,
                          **time_warm(s, queries, args.warm, mpp)}), flush=True)
        return 0
    os.makedirs(args.out, exist_ok=True)
    for q, sql in queries.items():
        trace = os.path.join(args.out, f"{'q' if q.isdigit() else ''}{q}_trace.json")
        out = profile_query(s, sql, trace)
        print(json.dumps({"query": int(q) if q.isdigit() else q, "sf": args.sf,
                          "analyzed": args.analyze, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
