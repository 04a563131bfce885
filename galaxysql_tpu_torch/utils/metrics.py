"""Typed metrics registry: named counters and gauges with one SQL/HTTP surface.

Reference analog: SURVEY.md §5.5 — `MatrixStatistics` instance counters plus the
MPP coordinator's JSON stats resources.  The reference scatters counters across
ad-hoc fields; here every metric registers in one typed registry so
`information_schema.metrics`, `SHOW METRICS`, and the web console's Prometheus
`/metrics` endpoint all render the same set without per-counter wiring.

All operations are host-side integer/float updates under a registry lock —
nothing here may touch device state (the metrics layer must be free on the
query hot path).
"""

from __future__ import annotations

import random
import re
import threading
from typing import Dict, Iterator, List, Tuple


class Counter:
    """Monotonic named counter (Prometheus `counter`)."""

    __slots__ = ("name", "help", "_value", "_lock")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _set(self, v):
        # CounterMap compatibility (`counters[k] += 1` does get-then-set);
        # not part of the public counter API — counters stay monotonic there
        # because += only grows.
        with self._lock:
            self._value = v


class Gauge:
    """Settable instantaneous value (Prometheus `gauge`)."""

    __slots__ = ("name", "help", "_value", "_lock")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value


class Histogram:
    """Quantile summary over a bounded reservoir (Prometheus `summary`).

    Algorithm R reservoir sampling: the first `reservoir` observations are
    kept verbatim, later ones replace a uniformly random slot with probability
    reservoir/count — every observation ever made has equal survival odds, so
    p50/p95/p99 stay unbiased without unbounded memory.  All host-side float
    work under the lock; nothing here may touch device state."""

    __slots__ = ("name", "help", "_buf", "_cap", "_count", "_sum", "_lock")

    kind = "histogram"
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", reservoir: int = 1024):
        self.name = name
        self.help = help
        self._buf: List[float] = []
        self._cap = reservoir
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def _observe_locked(self, v: float):
        self._count += 1
        self._sum += v
        if len(self._buf) < self._cap:
            self._buf.append(v)
        else:
            j = random.randrange(self._count)
            if j < self._cap:
                self._buf[j] = v

    def observe(self, v: float):
        with self._lock:
            self._observe_locked(float(v))

    def reset(self):
        """Clear count/sum/reservoir — scopes quantiles to a measurement
        window (the serving bench resets per level so each level's group-size
        p50 isn't blended with warmup and earlier levels)."""
        with self._lock:
            self._buf = []
            self._count = 0
            self._sum = 0.0

    def observe_many(self, vals):
        """One lock acquisition for a whole batch of observations (the batch
        scheduler records per-member waits once per flush — at group sizes in
        the hundreds, per-observation locking would tax the flush path)."""
        with self._lock:
            for v in vals:
                self._observe_locked(float(v))

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._buf:
                return 0.0
            s = sorted(self._buf)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def quantiles(self) -> Dict[float, float]:
        with self._lock:
            if not self._buf:
                return {q: 0.0 for q in self.QUANTILES}
            s = sorted(self._buf)
        return {q: s[min(int(q * len(s)), len(s) - 1)]
                for q in self.QUANTILES}

    @property
    def value(self) -> float:
        """Scalar view (p50) for generic metric listings."""
        return self.quantile(0.5)


# process-shared histograms: observed from code that has no Instance handle
# (fused-segment dispatches, worker RPC clients); every Instance adopts them
# into its registry so SHOW METRICS / /metrics export the quantiles.
SEGMENT_WALL_MS = Histogram(
    "segment_wall_ms", "fused-segment dispatch wall time (ms)")
RPC_RTT_MS = Histogram(
    "rpc_rtt_ms", "coordinator->worker RPC round-trip (ms)")
# batched TP serving (server/batch_scheduler.py): coalesced group sizes per
# vectorized flush and per-request collection-window wait
BATCH_GROUP_SIZE = Histogram(
    "batch_group_size", "coalesced point-query group size (requests/flush)")
BATCH_WAIT_MS = Histogram(
    "batch_wait_ms", "batched point-query collection wait (ms)")
# batched write path (server/dml_batch.py): coalesced DML group sizes per
# vectorized flush and per-statement collection wait
DML_GROUP_SIZE = Histogram(
    "dml_group_size", "coalesced point-DML group size (statements/flush)")
DML_WAIT_MS = Histogram(
    "dml_wait_ms", "batched DML collection wait (ms)")

# fault-tolerance plane (net/dn.py retry/breaker, SyncBus, deadline kills):
# process-shared like the histograms above — WorkerClient instances have no
# Instance handle; every Instance adopts these into its registry.
RPC_RETRIES = Counter(
    "rpc_retries", "worker RPC attempts retried after a transport failure")
RPC_FAILURES = Counter(
    "rpc_failures", "worker RPCs failed after exhausting the retry budget")
BREAKER_OPENS = Counter(
    "breaker_opens", "worker circuit breakers tripped open")
WORKER_FAILOVERS = Counter(
    "worker_failovers",
    "replica-read requests re-routed to another endpoint mid-statement")
SYNC_FAILURES = Counter(
    "sync_failures", "sync-bus broadcast deliveries that failed")
SYNC_HEALS = Counter(
    "sync_heals",
    "wholesale cache invalidations from a detected sync-epoch gap")
QUERY_TIMEOUTS = Counter(
    "query_timeouts", "queries killed by a MAX_EXECUTION_TIME deadline")
RETRY_BUDGET_EXHAUSTED = Counter(
    "retry_budget_exhausted",
    "worker RPCs failed fast because the per-endpoint retry token bucket "
    "was empty (anti-retry-storm backstop)")
# spill observability (exec/spill.py Spiller): promoted out of per-operator
# attributes so SHOW METRICS / Prometheus / statement-summary deltas see
# WHERE memory pressure went — process-shared, adopted per instance.
SPILL_BYTES = Counter(
    "spill_bytes_total", "bytes written to spill files (agg/join/sort)")
SPILL_FILES = Counter(
    "spill_files_total", "spill files/runs written")


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


class MetricsRegistry:
    """get-or-create registry of typed metrics.

    A name registers as exactly one kind; asking for the same name with the
    other kind raises (a counter silently readable as a gauge would hide a
    wiring bug forever).
    """

    def __init__(self, namespace: str = "galaxysql"):
        self.namespace = _sanitize(namespace)
        self._metrics: "Dict[str, object]" = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, help: str):
        name = _sanitize(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, help)

    def adopt(self, metric) -> None:
        """Register an EXISTING metric object (the process-shared histograms)
        under its own name; same kind-conflict rule as get-or-create."""
        name = _sanitize(metric.name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                self._metrics[name] = metric
            elif m is not metric and not isinstance(metric, type(m)):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")

    def counter_map(self, prefix: str) -> "CounterMap":
        return CounterMap(self, prefix)

    def rows(self) -> List[Tuple[str, str, float, str]]:
        """(name, kind, value, help) per metric, name-sorted — the
        information_schema.metrics / SHOW METRICS row shape.  Histograms
        expand into one row per quantile plus _count/_sum so SQL surfaces see
        scalars."""
        with self._lock:
            ms = sorted(self._metrics.items())
        out: List[Tuple[str, str, float, str]] = []
        for n, m in ms:
            if m.kind == "histogram":
                qs = m.quantiles()
                for q, v in sorted(qs.items()):
                    out.append((f"{n}_p{int(q * 100)}", "histogram",
                                float(v), m.help))
                out.append((f"{n}_count", "histogram", float(m.count), m.help))
                out.append((f"{n}_sum", "histogram", float(m.sum), m.help))
            else:
                out.append((n, m.kind, m.value, m.help))
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one block per metric;
        histograms render as summaries with quantile labels)."""
        out = []
        with self._lock:
            ms = sorted(self._metrics.items())
        for name, m in ms:
            full = f"{self.namespace}_{name}"
            if m.help:
                out.append(f"# HELP {full} {m.help}")
            if m.kind == "histogram":
                out.append(f"# TYPE {full} summary")
                for q, v in sorted(m.quantiles().items()):
                    out.append(f'{full}{{quantile="{q}"}} {v}')
                out.append(f"{full}_sum {m.sum}")
                out.append(f"{full}_count {m.count}")
                continue
            out.append(f"# TYPE {full} {m.kind}")
            value = m.value
            if isinstance(value, float) and not value.is_integer():
                out.append(f"{full} {value}")
            else:
                out.append(f"{full} {int(value)}")
        return "\n".join(out) + "\n"


class CounterMap:
    """dict-like adapter over registry counters (the `instance.counters`
    surface: `counters["mpp_queries"] += 1`, `dict(counters)`, `.items()`).
    Every entry is a real typed Counter named `<prefix>_<key>`, so ad-hoc
    engine counters surface through /metrics and information_schema.metrics
    with zero extra wiring."""

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self._registry = registry
        self._prefix = _sanitize(prefix)

    def _counter(self, key: str) -> Counter:
        return self._registry.counter(f"{self._prefix}_{_sanitize(key)}")

    def __getitem__(self, key: str) -> int:
        return self._counter(key).value

    def __setitem__(self, key: str, value: int):
        # NOTE: `counters[k] += 1` decomposes into get-then-set and can lose
        # concurrent increments; hot counter bumps use inc() (atomic).
        self._counter(key)._set(value)

    def inc(self, key: str, n: int = 1):
        """Atomic increment (the locked Counter.inc) — use this on paths that
        can race, not `counters[k] += 1`."""
        self._counter(key).inc(n)

    def get(self, key: str, default: int = 0) -> int:
        name = f"{self._prefix}_{_sanitize(key)}"
        with self._registry._lock:
            m = self._registry._metrics.get(name)
        return m.value if m is not None else default

    def keys(self) -> List[str]:
        pre = self._prefix + "_"
        with self._registry._lock:
            names = list(self._registry._metrics)
        return [n[len(pre):] for n in sorted(names) if n.startswith(pre)]

    def items(self) -> List[Tuple[str, int]]:
        return [(k, self[k]) for k in self.keys()]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self.keys()
