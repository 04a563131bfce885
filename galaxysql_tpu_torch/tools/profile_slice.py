"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 -m galaxysql_tpu_torch.tools.profile_slice [--sf 1.0] [--out chiprun_out/profile]

Loads TPC-H at `--sf` into the port on the card, runs Q1, Q3, Q5 and Q6 twice to warm
the device cache, then once more each under `torch.profiler` (CPU and CUDA
activities).  For each query it prints one JSON line: the wall time, the device-busy
time (sum of device kernel and memcpy/memset times; one stream, so they do not
overlap), the device's idle share of the wall time, the number of device operations,
the number of host reads of a device scalar (`aten::_local_scalar_dense`, each a
host-device synchronisation) and of `aten::nonzero` calls (which synchronise too),
and the device operations that took the most time.  One Chrome trace per query goes
under `--out`.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

QUERIES = (1, 3, 5, 6)


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
    s = Session(inst)
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
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
            "top_device_ops": [[k[:120], round(ms, 4), c] for k, ms, c in device_ops[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile"),
                    help="directory for the Chrome traces")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available; this tool runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES as SQL

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    s = load_tpch(args.sf)
    for _ in range(2):
        for q in QUERIES:
            s.execute(SQL[q])
    os.makedirs(args.out, exist_ok=True)
    for q in QUERIES:
        out = profile_query(s, SQL[q], os.path.join(args.out, f"q{q}_trace.json"))
        print(json.dumps({"query": q, "sf": args.sf, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
