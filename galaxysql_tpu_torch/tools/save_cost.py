"""What a checkpoint's partition writes cost, one by one and from a thread pool.

    python3 -m galaxysql_tpu_torch.tools.save_cost [--sf 1.0] [--device cuda]

Loads TPC-H at `--sf` into an instance on `--device` and checkpoints every table
four times, in turns pooled, serial, serial, pooled, each into a fresh temporary
directory: pooled is `TableStore.save` (the partitions written from a thread pool),
serial the reference's order, one partition after another
(`TableStore.write_partition` in a loop, then `write_dictionaries`).  Every table's
files from the two orders must hold the same arrays, key for key, and the same
`dictionaries.json`.  It prints the card's name and power limit, then one JSON line:
each run's seconds, the bytes on disk by table and the host's CPU count.  Without a
CUDA device it exits non-zero, unless `--device cpu` asks for the CPU (a check of the
tool at a small `--sf`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _write(inst, root, serial: bool) -> float:
    t0 = time.perf_counter()
    for key, store in inst.stores.items():
        d = os.path.join(root, key.replace(".", os.sep))
        if serial:
            os.makedirs(d, exist_ok=True)
            for p in store.partitions:
                store.write_partition(d, p)
            store.write_dictionaries(d)
        else:
            store.save(d)
    return time.perf_counter() - t0


def _same_files(a, b):
    """Every file under `a` holds what the same file under `b` does."""
    for dirpath, _dirs, files in os.walk(a):
        for name in files:
            pa = os.path.join(dirpath, name)
            pb = os.path.join(b, os.path.relpath(pa, a))
            if name.endswith(".npz"):
                with np.load(pa, allow_pickle=False) as za, \
                        np.load(pb, allow_pickle=False) as zb:
                    if sorted(za.files) != sorted(zb.files) or any(
                            za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k])
                            for k in za.files):
                        raise AssertionError(f"{pa} and {pb} differ")
            else:
                with open(pa, "rb") as fa, open(pb, "rb") as fb:
                    if fa.read() != fb.read():
                        raise AssertionError(f"{pa} and {pb} differ")


def _bytes_by_table(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        if files:
            key = os.path.relpath(dirpath, root).replace(os.sep, ".")
            out[key] = sum(os.path.getsize(os.path.join(dirpath, f)) for f in files)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("save_cost: CUDA is not available; this tool runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import tpch

    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True)
        print(card.stdout.strip().splitlines()[0], flush=True)
    data = tpch.generate(args.sf)
    inst = Instance(device=args.device)
    s = Session(inst)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for t in tpch.TABLE_ORDER:
        s.execute(tpch.TPCH_DDL[t])
        inst.store("tpch", t).insert_arrays(data[t], inst.tso.next_timestamp())
    del data

    order = ["pooled", "serial", "serial", "pooled"]
    runs = {"pooled": [], "serial": []}
    root = tempfile.mkdtemp(prefix="save_cost_")
    try:
        dirs = []
        for i, mode in enumerate(order):
            d = os.path.join(root, f"run{i}")
            runs[mode].append(_write(inst, d, mode == "serial"))
            dirs.append(d)
        _same_files(dirs[0], dirs[1])
        _same_files(dirs[1], dirs[0])
        sizes = _bytes_by_table(dirs[0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"tool": "save_cost", "device": args.device, "sf": args.sf,
                      "cpu_count": os.cpu_count(), "order": order, "seconds": runs,
                      "bytes_on_disk": sizes, "bytes_total": sum(sizes.values()),
                      "same_files": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
