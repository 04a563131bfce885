"""What the statement-scope shared metadata lock costs the point path, on one GPU.

    python3 -m galaxysql_tpu_torch.tools.mdl_cost [--rows 1000000] [--statements 1000]
        [--sessions 64] [--per-session 16] [--wire-statements 400] [--seed 20241017]
        [--device cuda]

Loads sysbench `sbtest1` (`--rows` rows in 8 hash partitions, from `--seed`) into an
instance on the card and serves it on a loopback port (`net/server.py`).  Then it runs
sysbench `oltp_point_select` with the session's shared MDL (`Session._mdl_shared`) and
with a no-op in its place, in turns on, off, off, on in this one process, batching off:
`--statements` sequential statements from one session (p50/p99 ms), a closed loop of
`--sessions` threads of one `Session` each, `--per-session` statements a session (QPS,
p50), and `--wire-statements` prepared executions from one wire connection
(`tools/wire_clients.py`; QPS, p50).  Every in-process row must equal the first run's,
every `c` over the wire the in-process row for its id.  It prints the card's name and
power limit, then one JSON line.  Without a CUDA device it exits non-zero, unless
`--device cpu` asks for the CPU (a check of the tool at a small `--rows`).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import subprocess
import sys
import threading
import time

import numpy as np


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _closed_loop(inst, stmts, sessions, per_session, expected) -> dict:
    """`sessions` threads, one `Session` each, `per_session` statements back to back,
    all started by one barrier."""
    from galaxysql_tpu_torch.server.session import Session
    ss = [Session(inst, "sbtest") for _ in range(sessions)]
    lat = [[] for _ in range(sessions)]
    failed = []
    start = threading.Barrier(sessions + 1)

    def run(i):
        try:
            start.wait(timeout=120)
            for j in range(per_session):
                sql = stmts[(i * per_session + j) % len(stmts)]
                t0 = time.perf_counter()
                rows = ss[i].execute(sql).rows
                lat[i].append((time.perf_counter() - t0) * 1000.0)
                if rows != expected[sql]:
                    raise AssertionError(f"{sql}: {rows} / {expected[sql]}")
        except BaseException as e:  # carried to the main thread
            failed.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(sessions)]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for s in ss:
        s.close()
    if failed:
        raise failed[0]
    flat = [x for row in lat for x in row]
    return {"qps": len(flat) / wall, "p50_ms": _pct(flat, 50)}


def _wire_one(port, statements, rows, seed) -> dict:
    """One wire connection of `tools/wire_clients.py`: its JSON line."""
    p = subprocess.Popen(
        [sys.executable, "-m", "galaxysql_tpu_torch.tools.wire_clients", "--port",
         str(port), "--database", "sbtest", "--connections", "1", "--statements",
         str(statements), "--max-id", str(rows), "--seed", str(seed)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if p.stdout.readline().strip() != "READY":
            raise AssertionError("the wire client did not connect")
        out, _ = p.communicate("go\n", timeout=300)
        line = json.loads(out.strip().splitlines()[-1])
        if p.returncode or line["errors"]:
            raise AssertionError(f"the wire client failed: {line['errors'][:3]}")
        return line
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000, help="rows of sbtest1")
    ap.add_argument("--statements", type=int, default=1000,
                    help="sequential point selects a run")
    ap.add_argument("--sessions", type=int, default=64, help="closed-loop sessions")
    ap.add_argument("--per-session", type=int, default=16,
                    help="statements each closed-loop session runs")
    ap.add_argument("--wire-statements", type=int, default=400,
                    help="point selects of the one wire connection a run")
    ap.add_argument("--seed", type=int, default=20241017)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mdl_cost: CUDA is not available; this tool runs only on a GPU",
              file=sys.stderr)
        return 2
    from galaxysql_tpu_torch.net.server import MySQLServer
    from galaxysql_tpu_torch.server.instance import Instance
    from galaxysql_tpu_torch.server.session import Session
    from galaxysql_tpu_torch.storage import sysbench

    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True)
        print(card.stdout.strip().splitlines()[0], flush=True)
    inst = Instance(device=args.device)
    s = Session(inst)
    s.execute("CREATE DATABASE sbtest")
    s.execute("USE sbtest")
    s.execute(sysbench.ddl())
    inst.store("sbtest", "sbtest1").insert_arrays(sysbench.generate(args.rows, args.seed),
                                                  inst.tso.next_timestamp())
    inst.config.set_instance("ENABLE_BATCH_SCHEDULER", 0)
    ids = np.random.default_rng(args.seed).integers(1, args.rows + 1, args.statements)
    stmts = [f"SELECT c FROM sbtest1 WHERE id={int(i)}" for i in ids]
    expected = {sql: s.execute(sql).rows for sql in stmts}

    loop = asyncio.new_event_loop()
    server = MySQLServer(inst, port=0, users={"root": ""}, pool_size=4)
    loop.run_until_complete(server.start())
    served = threading.Thread(target=loop.run_forever, daemon=True)
    served.start()
    real = Session._mdl_shared
    runs = {"on": [], "off": []}
    try:
        for mode in ("on", "off", "off", "on"):
            Session._mdl_shared = real if mode == "on" else \
                (lambda self, keys: contextlib.nullcontext())
            ms = []
            for sql in stmts:
                t0 = time.perf_counter()
                rows = s.execute(sql).rows
                ms.append((time.perf_counter() - t0) * 1000.0)
                if rows != expected[sql]:
                    raise AssertionError(f"{sql}: {rows} / {expected[sql]}")
            closed = _closed_loop(inst, stmts, args.sessions, args.per_session, expected)
            one = _wire_one(server.port, args.wire_statements, args.rows, args.seed)
            for key, c, _ms in one["results"]:
                want = s.execute(f"SELECT c FROM sbtest1 WHERE id={key}").rows
                if c != (want[0][0] if want else None):
                    raise AssertionError(f"id {key} over the wire: {c!r} / {want}")
            wire_ms = [x for _k, _c, x in one["results"]]
            runs[mode].append({
                "fast_p50_ms": _pct(ms[1:], 50), "fast_p99_ms": _pct(ms[1:], 99),
                f"qps_{args.sessions}": closed["qps"],
                f"p50_{args.sessions}_ms": closed["p50_ms"],
                "wire_one_qps": len(wire_ms) / (one["end"] - one["start"]),
                "wire_one_p50_ms": _pct(wire_ms, 50)})
    finally:
        Session._mdl_shared = real
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        served.join(30)
    print(json.dumps({"tool": "mdl_cost", "device": args.device, "rows": args.rows,
                      "batching": "off",
                      "order": ["on", "off", "off", "on"], "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
