"""Closed-loop sysbench `oltp_point_select` clients over the MySQL wire.

    python -m galaxysql_tpu_torch.tools.wire_clients --port P --database sbtest \\
        --connections 16 --statements 40 --max-id 1000000 --seed 1

Opens `--connections` connections (one thread each) to a server on 127.0.0.1,
prepares `SELECT c FROM sbtest1 WHERE id=?` on each (COM_STMT_PREPARE), prints
`READY` and waits for one line on standard input.  Then every connection runs
`--statements` executions back to back, each with an id drawn from [1, max-id]
(numpy, seeded by `--seed` and the connection's number), and the process prints one
JSON line: `start` and `end` (host clock, seconds), per statement `[id, c, ms]`, and
`sheds`: the typed admission refusals (errno 9003, `ServerOverloadError`) the
connections retried after the server's "retry after N ms", as a client does (the
statement's ms includes its retries).
Only the client modules are imported (no torch, no engine), so several such
processes can drive one server, as sysbench's client threads do.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import sys
import threading
import time

import numpy as np

from galaxysql_tpu_torch.net.client import MiniClient, MySQLError

POINT_SELECT = "SELECT c FROM sbtest1 WHERE id=?"
SOCKET_TIMEOUT = 120.0  # seconds a connection waits for the server's answer
SHED_ERRNO = 9003       # ServerOverloadError: the admission gate refused the statement
RETRY_S = 300.0         # how long a statement is retried after typed refusals
_RETRY_AFTER = re.compile(r"retry after (\d+)ms")


def _execute(conn, stmt, params, sheds):
    """One execution, retried after each typed admission refusal for at most
    RETRY_S: after the server's "retry after N ms" doubled for each earlier refusal
    of the statement, capped at 1 s, with +-50 % jitter; `sheds[0]` counts the
    refusals."""
    deadline = time.perf_counter() + RETRY_S
    n = 0
    while True:
        try:
            return conn.execute(stmt, params)
        except MySQLError as e:
            if e.errno != SHED_ERRNO or time.perf_counter() > deadline:
                raise
            sheds[0] += 1
            m = _RETRY_AFTER.search(str(e))
            after = int(m.group(1)) if m else 100
            ms = min(max(after, 1) * (2 ** min(n, 10)), 1000)
            time.sleep(max(ms, after) * random.uniform(0.5, 1.5) / 1000.0)
            n += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--database", default="sbtest")
    ap.add_argument("--connections", type=int, default=16)
    ap.add_argument("--statements", type=int, default=40)
    ap.add_argument("--max-id", type=int, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    conns, stmts = [], []
    for _ in range(args.connections):
        c = MiniClient(args.host, args.port, database=args.database,
                       timeout=SOCKET_TIMEOUT)
        conns.append(c)
        stmts.append(c.prepare(POINT_SELECT))
    ids = [np.random.default_rng([args.seed, i]).integers(1, args.max_id + 1,
                                                          args.statements).tolist()
           for i in range(args.connections)]
    results = [[] for _ in conns]
    sheds = [[0] for _ in conns]
    errors = []
    go = threading.Event()

    def run(i):
        try:
            go.wait()
            for key in ids[i]:
                t0 = time.perf_counter()
                _names, rows = _execute(conns[i], stmts[i], [key], sheds[i])
                ms = (time.perf_counter() - t0) * 1000.0
                results[i].append([key, rows[0][0] if rows else None, ms])
        except BaseException as e:  # reported in the JSON line
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(conns))]
    for t in threads:
        t.start()
    print("READY", flush=True)
    sys.stdin.readline()
    start = time.time()
    go.set()
    for t in threads:
        t.join()
    end = time.time()
    for c in conns:
        c.close()
    print(json.dumps({"start": start, "end": end, "errors": errors,
                      "sheds": sum(n[0] for n in sheds),
                      "results": [r for rs in results for r in rs]}), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
