"""What building runtime filters costs a query, on the card against on the host.

    python3 -m galaxysql_tpu_torch.tools.rf_cost [--sf 1.0] [--device cuda] [--repeats 5]

Loads TPC-H at `--sf` into an instance on `--device` with the fragment cache off and
runs each query in three modes, the same plan every time:

- `device`: the defaults; a join build publishes its filters from its own device
  (`exec/fusion.publish_on_device`);
- `host`: `publish_on_device` swapped for the copied `runtime_filter.publish_from_batch`
  (the build keys copied to the host, the bloom built in numpy, the flags copied back
  by the probe-side segment);
- `off`: `/*+TDDL:RUNTIME_FILTER(OFF)*/`, no filter at all.

First Q3 before ANALYZE (the main path's plan), then all 22 queries after ANALYZE
TABLE.  Each query runs once in every mode untimed, then `--repeats` rounds, the
modes' order rotated each round; a run is timed on the host clock between two
`torch.cuda.synchronize()`.  Every mode's rows must equal the others' (floats within
1e-9 relative).  It prints the card's name and power limit, then one JSON line: each
query's median ms by mode and each mode's sum.  Without a CUDA device it exits
non-zero, unless `--device cpu` asks for the CPU (a check of the tool at a small
`--sf`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

MODES = ("device", "host", "off")
OFF_HINT = "/*+TDDL:RUNTIME_FILTER(OFF)*/ "


@contextlib.contextmanager
def _mode(name):
    """Within the block, join builds publish as `name` says."""
    from galaxysql_tpu_torch.exec import fusion
    from galaxysql_tpu_torch.exec import runtime_filter as rf
    saved = fusion.publish_on_device
    if name == "host":
        fusion.publish_on_device = rf.publish_from_batch
    try:
        yield
    finally:
        fusion.publish_on_device = saved


def _same(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-9):
                    return False
            elif x != y:
                return False
    return True


def _run(s, sql, mode, sync):
    with _mode(mode):
        sync()
        t0 = time.perf_counter()
        rows = s.execute((OFF_HINT if mode == "off" else "") + sql).rows
        sync()
    return rows, (time.perf_counter() - t0) * 1000.0


def _measure(s, name, sql, repeats, sync) -> dict:
    want = None
    for mode in MODES:
        rows, _ms = _run(s, sql, mode, sync)
        if want is None:
            want = rows
        elif not _same(rows, want):
            raise AssertionError(f"{name}: mode {mode} gives other rows than device")
    ms = {m: [] for m in MODES}
    for r in range(repeats):
        for mode in MODES[r % 3:] + MODES[:r % 3]:
            _rows, t = _run(s, sql, mode, sync)
            ms[mode].append(t)
    return {m: statistics.median(v) for m, v in ms.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--repeats", type=int, default=5, help="timed rounds of the modes")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rf_cost: CUDA is not available; this tool runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch
    from galaxysql_tpu_torch.storage.tpch_queries import QUERIES

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    card = None
    if args.device == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        card = out.stdout.strip().splitlines()[0]
        print(card, flush=True)
    data = tpch.generate(args.sf)
    inst = Instance(device=args.device)
    inst.config.set_instance("ENABLE_FRAGMENT_CACHE", 0)
    s = Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        inst.store("tpch", t).insert_arrays(data[t], inst.tso.next_timestamp())
    del data

    result = {"tool": "rf_cost", "device": args.device, "card": card, "sf": args.sf,
              "repeats": args.repeats, "modes": MODES}
    result["q3_no_statistics"] = _measure(s, "Q3", QUERIES[3], args.repeats, sync)
    s.execute("ANALYZE TABLE " + ", ".join(tpch.TABLE_ORDER))
    analyzed = {f"Q{q}": _measure(s, f"Q{q}", QUERIES[q], args.repeats, sync)
                for q in range(1, 23)}
    result["analyzed_ms"] = analyzed
    result["analyzed_sum_ms"] = {m: sum(v[m] for v in analyzed.values()) for m in MODES}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
