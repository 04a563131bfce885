"""Tracing / profiling: slow-SQL recorder, per-query runtime statistics, and
the hierarchical span-tracing subsystem.

Reference analog: SURVEY.md §5.1 — `SQLRecorder` (slow-SQL ring), `SQLTracer`
(SHOW TRACE, held per session as `last_trace`), and `RuntimeStatistics` counters
surfaced via EXPLAIN ANALYZE and SHOW FULL STATS.  The span layer goes past the
coordinator boundary the reference stops at: one `TraceContext` per traced
query collects a span TREE — coordinator operators, fused-segment dispatches,
MPP per-shard stages, device-cache transfers, XLA compile events, and
worker-process child spans grafted back over the wire with clock-offset
correction — exported as Chrome-trace/Perfetto JSON from `/trace/<trace_id>`.

Span COLLECTION is always-on (every query builds a lightweight host-side span
tree — ramp timestamps only, no device syncs); RETENTION is tail-sampled: a
per-digest head sampler keeps 1-in-N healthy traces, and traces that end slow,
shed, or errored are always kept, into the byte-budgeted per-node `TraceStore`
ring.  `GALAXYSQL_TRACING=0` (read once at import) or
`ENABLE_QUERY_TRACING=false` restores the old fully-opt-in behaviour: with
collection off, `current()` returns None and no code path allocates a span,
times a dispatch, or syncs a device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
import zlib
from typing import Any, Deque, Dict, List, Optional, Tuple

# Emergency hatch (same trio convention as GALAXYSQL_PALLAS / _COLUMNAR):
# env kills always-on collection process-wide, read once at import so the
# per-query check is one attribute load.
ALWAYS_ON = os.environ.get("GALAXYSQL_TRACING", "1") != "0"

# -- node-prefixed trace ids ---------------------------------------------------
#
# Trace ids stay BIGINT-shaped (every surface — SHOW SLOW, query_stats,
# /query/<id> — stores them as int64), but the high bits carry a per-instance
# node hash: two coordinators (Instance.sync_peer topologies) mint from their
# own allocators and can never collide the way the old process-monotonic
# counter did when each process restarted its count at 1.

_NODE_BITS = 40  # low bits: per-node monotonic counter (~10^12 queries)


class TraceIdAllocator:
    """Per-instance trace-id mint: `(crc32(node_id) << 40) | counter`.

    Monotonic within a node; globally unique across nodes up to the 22-bit
    node-hash birthday bound (id collisions across coordinators were certain
    before — two nodes both counting 1, 2, 3…)."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._prefix = (zlib.crc32(node_id.encode()) & 0x3FFFFF) << _NODE_BITS
        self._count = itertools.count(1)

    def next(self) -> int:
        # itertools.count.__next__ is a single C call (GIL-atomic): every
        # query mints an id, and a lock here is a measurable convoy at
        # batched-TP serving rates
        return self._prefix | next(self._count)


def trace_node_hash(trace_id: int) -> int:
    """The minting node's 22-bit hash embedded in a trace id."""
    return (int(trace_id) >> _NODE_BITS) & 0x3FFFFF


@dataclasses.dataclass
class SlowEntry:
    sql: str
    elapsed_s: float
    conn_id: int
    at: float
    trace_id: int = 0     # links SHOW SLOW rows to information_schema.query_stats
    workload: str = ""    # TP | AP
    error: str = ""       # non-empty: the query FAILED after elapsed_s
    digest: str = ""      # statement digest: jumps to SHOW STATEMENT SUMMARY


class SlowLog:
    """Bounded ring of slow queries (SQLRecorder analog)."""

    def __init__(self, capacity: int = 256):
        self._ring: Deque[SlowEntry] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, sql: str, elapsed_s: float, conn_id: int,
               trace_id: int = 0, workload: str = "", error: str = "",
               digest: str = ""):
        with self._lock:
            self._ring.append(SlowEntry(sql[:512], elapsed_s, conn_id,
                                        time.time(), trace_id, workload,
                                        error, digest))

    def entries(self) -> List[SlowEntry]:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


SLOW_LOG = SlowLog()


@dataclasses.dataclass
class SegmentSpan:
    """One fused-pipeline-segment dispatch (exec/fusion.py)."""
    segment_id: int   # stable per FusedSegment instance
    chain: str        # op chain, e.g. "filter>project"
    rows_in: int      # live rows entering the segment
    rows_out: int     # live rows surviving it
    compiled: bool    # True: this dispatch paid a fresh trace+compile
    wall_ms: float


class SegmentTracer:
    """Per-segment span recorder — fused pipelines collapse several operators
    into one program, so EXPLAIN-style per-operator stats can't see inside
    them; these spans keep them observable.

    Off by default: rows in/out force a device sync per batch, which the hot
    path must never pay.  Two ways to enable:

    - `scoped(sink)` (preferred): a context manager binding a per-query sink on
      the calling thread, so spans from concurrent sessions land in their own
      QueryProfile instead of interleaving in one shared ring.
    - `enabled = True`: the legacy module-level ring fallback (spans from every
      thread without an active scope share `_ring`)."""

    def __init__(self, capacity: int = 1024):
        self._ring: Deque[SegmentSpan] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.enabled = False

    def _sink(self) -> Optional[list]:
        return getattr(self._local, "sink", None)

    @property
    def active(self) -> bool:
        """True when spans should be recorded on this thread (a scoped sink is
        bound, or the global ring is enabled)."""
        return self.enabled or self._sink() is not None

    @contextlib.contextmanager
    def scoped(self, sink: Optional[list] = None):
        """Route this thread's spans into `sink` (a plain list) for the
        duration — the query-scoped collector.  Nests: the previous sink is
        restored on exit."""
        if sink is None:
            sink = []
        prev = self._sink()
        self._local.sink = sink
        try:
            yield sink
        finally:
            self._local.sink = prev

    def record(self, span: SegmentSpan):
        sink = self._sink()
        if sink is not None:
            sink.append(span)
            return
        with self._lock:
            self._ring.append(span)

    def spans(self) -> List[SegmentSpan]:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


SEGMENT_TRACER = SegmentTracer()


# -- hierarchical span tracing -------------------------------------------------


def now_us() -> int:
    """Wall-clock microseconds — the shared timebase span timestamps use so
    worker-process spans can be offset-corrected against the coordinator's."""
    return int(time.time() * 1e6)


@dataclasses.dataclass
class Span:
    """One node of a query's span tree.  `parent_id == 0` marks the root.
    Mutable on purpose: operator spans are opened at plan-build time and their
    timing filled in as execution drains them."""

    span_id: int
    parent_id: int
    name: str
    kind: str                  # query|operator|segment|stage|shard|rpc|worker|
    #                            compile|transfer|cache|error
    node: str = ""             # node_id of the process that recorded it
    start_us: int = 0
    dur_us: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def span_from_dict(d: Dict[str, Any]) -> Span:
    return Span(int(d.get("span_id", 0)), int(d.get("parent_id", 0)),
                str(d.get("name", "")), str(d.get("kind", "")),
                str(d.get("node", "")), int(d.get("start_us", 0)),
                float(d.get("dur_us", 0.0)), dict(d.get("attrs") or {}))


class TraceContext:
    """Per-query span collector.

    A query executes on ONE host thread (MPP stages are host-dispatched from
    it; worker spans arrive on it via the RPC reply), so parenting uses a plain
    `cursor` — the span id runtime recorders should attach under.  Structural
    code (operator build, stage recursion, RPC round-trips) moves the cursor
    with begin/end or the `span()` context manager; leaf recorders (segment
    dispatches, compile events, cache transfers) just read it."""

    def __init__(self, trace_id: int, node: str = ""):
        self.trace_id = trace_id
        self.node = node
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.cursor = 0  # current parent span id (0 = attach to root/none)

    # -- span construction ---------------------------------------------------

    def add(self, name: str, kind: str, parent: Optional[int] = None,
            start_us: Optional[int] = None, dur_us: float = 0.0,
            **attrs) -> Span:
        """Append a span (explicit or cursor parent); returns it for later
        timing fill-in."""
        with self._lock:
            sid = next(self._ids)
            sp = Span(sid, self.cursor if parent is None else parent,
                      name, kind, self.node,
                      now_us() if start_us is None else start_us,
                      dur_us, attrs)
            self.spans.append(sp)
        return sp

    def event(self, name: str, kind: str = "event", **attrs) -> Span:
        """Instantaneous (zero-duration) span under the cursor — compile
        events, cache hits, transfer markers."""
        return self.add(name, kind, **attrs)

    def begin(self, name: str, kind: str, **attrs) -> Span:
        """Open a span and move the cursor under it (manual form; pair with
        `end`)."""
        sp = self.add(name, kind, **attrs)
        sp._t0 = time.perf_counter()
        sp._prev_cursor = self.cursor
        self.cursor = sp.span_id
        return sp

    def end(self, sp: Span):
        sp.dur_us = round((time.perf_counter() - sp._t0) * 1e6, 1)
        self.cursor = sp._prev_cursor

    @contextlib.contextmanager
    def span(self, name: str, kind: str, **attrs):
        sp = self.begin(name, kind, **attrs)
        try:
            yield sp
        except BaseException as e:
            sp.attrs["error"] = f"{type(e).__name__}: {e}"[:256]
            raise
        finally:
            self.end(sp)

    @property
    def root_id(self) -> int:
        return self.spans[0].span_id if self.spans else 0

    # -- cross-process grafting ----------------------------------------------

    def graft(self, span_dicts: List[Dict[str, Any]], parent: int,
              offset_us: int = 0) -> List[Span]:
        """Adopt spans recorded by another process: remint span ids into this
        context's id space (the worker's counter collides with ours), hang
        orphans under `parent`, and shift their wall clocks by `offset_us`
        (the NTP-style offset the RPC layer measured)."""
        remap: Dict[int, int] = {}
        out: List[Span] = []
        with self._lock:
            for d in span_dicts:
                sp = span_from_dict(d)
                new_id = next(self._ids)
                remap[sp.span_id] = new_id
                sp.span_id = new_id
                sp.parent_id = remap.get(sp.parent_id, parent)
                sp.start_us += offset_us
                self.spans.append(sp)
                out.append(sp)
        return out

    # -- rendering -----------------------------------------------------------

    def tree_lines(self) -> List[str]:
        return span_tree_lines(self.spans)

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.trace_id, self.spans)


def span_tree_lines(spans: List[Span]) -> List[str]:
    """The span tree as indented text (the SHOW TRACE rendering)."""
    children: Dict[int, List[Span]] = {}
    by_id = {s.span_id: s for s in spans}
    roots: List[Span] = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    lines: List[str] = []

    def walk(sp: Span, depth: int):
        extra = " ".join(f"{k}={v}" for k, v in sorted(sp.attrs.items()))
        node = f" @{sp.node}" if sp.node else ""
        lines.append(f"{'  ' * depth}{sp.name} [{sp.kind}] "
                     f"{sp.dur_us / 1000:.3f}ms{node}"
                     f"{(' ' + extra) if extra else ''}")
        for c in children.get(sp.span_id, []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return lines


def chrome_trace(trace_id: int, spans: List[Span]) -> Dict[str, Any]:
    """Chrome-trace / Perfetto JSON (`chrome://tracing` 'JSON Array' dialect
    wrapped in an object): complete `X` events, one pid per recording node,
    one tid row per shard/worker lane so mesh skew is visible at a glance."""
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for sp in spans:
        pid = pids.setdefault(sp.node or "local", len(pids) + 1)
        tid = int(sp.attrs.get("shard", 0)) + 1 if "shard" in sp.attrs else 0
        events.append({"name": sp.name, "cat": sp.kind or "span", "ph": "X",
                       "ts": sp.start_us, "dur": max(sp.dur_us, 1.0),
                       "pid": pid, "tid": tid,
                       "args": {"span_id": sp.span_id,
                                "parent_id": sp.parent_id, **sp.attrs}})
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": node}} for node, pid in pids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": str(trace_id)}}


# thread-local active TraceContext: leaf recorders everywhere (fusion
# dispatches, global_jit compiles, device-cache transfers, RPC clients) read
# it; only the session (or the worker RPC handler) ever sets it.

_ACTIVE = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_ACTIVE, "trace", None)


@contextlib.contextmanager
def activate(tc: Optional[TraceContext]):
    prev = current()
    _ACTIVE.trace = tc
    try:
        yield tc
    finally:
        _ACTIVE.trace = prev


def swap_active(tc: Optional[TraceContext]) -> Optional[TraceContext]:
    """Set the thread's active context, returning the previous one.  The
    always-on query ramp uses this instead of `activate` — two thread-local
    ops, no generator frame (the context-manager overhead is measurable at
    point-serving rates)."""
    prev = getattr(_ACTIVE, "trace", None)
    _ACTIVE.trace = tc
    return prev


# -- per-query runtime statistics ---------------------------------------------


@dataclasses.dataclass
class QueryProfile:
    """One query's runtime statistics (RuntimeStatistics / MPP QueryStats
    analog, §5.1): identity + totals always (host-side, zero device syncs),
    per-operator rows/time and segment spans only when profiling was enabled
    for the execution (`profiled`)."""

    trace_id: int
    sql: str
    schema: str
    conn_id: int
    started_at: float = 0.0
    workload: str = ""            # TP | AP
    engine: str = "local"         # local | mpp | point
    elapsed_ms: float = 0.0
    rows: int = 0                 # result cardinality (free: host rows exist)
    peak_rss_kb: int = 0          # process high-water host memory at finish
    profiled: bool = False        # per-operator stats were collected
    op_stats: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    segments: List[SegmentSpan] = dataclasses.field(default_factory=list)
    trace: List[str] = dataclasses.field(default_factory=list)
    # span tree (TraceContext.spans alias) when the query ran traced; includes
    # grafted worker-side spans and compile/transfer telemetry events
    spans: List[Span] = dataclasses.field(default_factory=list)
    error: str = ""               # non-empty: the query FAILED mid-execution
    # phase breakdown (ms) stamped at the session ramps: fence_wait,
    # admission, queue, plan, compile, execute, serialize.  Shed/failed
    # queries keep whatever phases completed before the raise — partial
    # attribution is the point (a shed storm shows WHERE the wait went).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # head-sampling state stamped at query entry (ISSUE 20): `traced` means
    # collection was enabled for this query (the tail ramps may retain it
    # even without spans); `sampled` is the head sampler's one-probe verdict
    # (or the router hint's propagated flag), decided EXACTLY ONCE per query
    # — the sampler keeps per-digest cadence counters, so the finish ramps
    # must reuse this bit instead of re-asking
    traced: bool = False
    sampled: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # op_stats node ids are process addresses — meaningless outside
        for st in d["op_stats"]:
            st.pop("node_id", None)
        return d


class ProfileRing:
    """Bounded ring of the last-N QueryProfiles (per engine instance), indexed
    by trace id for the web console's /query/<trace_id> resource."""

    def __init__(self, capacity: int = 256):
        self._ring: Deque[QueryProfile] = collections.deque(maxlen=capacity)

    def record(self, profile: QueryProfile):
        # deque(maxlen).append is one C call (GIL-atomic); EVERY query lands
        # here, and a lock convoys at batched-TP serving rates.  Readers
        # snapshot with list(ring) — also a single C call — and iterate the
        # snapshot, so they never see a deque mutating under them.
        self._ring.append(profile)

    def record_many(self, profiles):
        """Bulk append (one C call) — the batch scheduler records a whole
        group's profiles at scatter time."""
        self._ring.extend(profiles)

    def entries(self) -> List[QueryProfile]:
        return list(self._ring)

    def get(self, trace_id) -> Optional[QueryProfile]:
        """Exact-id lookup.  Ids are node-prefixed (TraceIdAllocator), so a
        ring shared between peer-coordinator tests can never serve node A's
        profile for node B's id; numeric strings (the web console's raw path
        segment) are accepted."""
        try:
            tid = int(trace_id)
        except (TypeError, ValueError):
            return None
        for p in list(self._ring):
            if p.trace_id == tid:
                return p
        return None

    def clear(self):
        self._ring.clear()


# -- tail-sampled trace retention ---------------------------------------------


@dataclasses.dataclass
class RetainedTrace:
    """One retained query trace: the span tree in wire/persistable (dict)
    form plus the identity needed to correlate it with statement-summary
    rows, events, and incident bundles."""

    trace_id: int
    digest: str
    sql: str
    schema: str
    workload: str
    elapsed_ms: float
    error: str
    reason: str                  # sampled | slow | error | shed | remote
    node: str
    at: float
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    approx_bytes: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TraceSampler:
    """Per-digest head sampler: the per-query decision is one dict probe plus
    one compare (the hot-path budget ISSUE 20 sets).  Keeps every Nth
    occurrence of a digest where N = round(1/rate) — the FIRST occurrence
    always retains, so new digests are never invisible.  rate <= 0 disables
    head sampling entirely (tail retention still fires)."""

    MAX_DIGESTS = 8192

    def __init__(self, rate: float = 0.01):
        self.configure(rate)

    def configure(self, rate: float):
        self.rate = max(0.0, float(rate))
        self._period = int(round(1.0 / self.rate)) if self.rate > 0 else 0
        self._counts: Dict[str, int] = {}

    def decide(self, digest: str) -> bool:
        if not self._period:
            return False
        n = self._counts.get(digest, 0)
        if len(self._counts) > self.MAX_DIGESTS:
            self._counts.clear()  # epoch reset, bounded (admission idiom)
        self._counts[digest] = n + 1
        return n % self._period == 0


class TraceStore:
    """Byte-budgeted per-node ring of retained traces, digest-indexed.

    Healthy traces land via the head sampler; slow/errored/shed traces are
    ALWAYS retained (tail-based retention — the trace you need is the one
    the anomaly already marked).  Eviction is oldest-first until the byte
    budget holds; the estimate is a cheap host-side sum computed only for
    traces that retain, never on the per-query hot path."""

    def __init__(self, budget_bytes: int = 4 << 20, rate: float = 0.01,
                 node: str = ""):
        self.node = node
        self.sampler = TraceSampler(rate)
        self._budget = max(1, int(budget_bytes))
        self._entries: "collections.OrderedDict[int, RetainedTrace]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.retained = 0
        self.evicted = 0

    def configure(self, rate: Optional[float] = None,
                  budget_bytes: Optional[int] = None):
        if rate is not None and rate != self.sampler.rate:
            self.sampler.configure(rate)
        if budget_bytes is not None:
            self._budget = max(1, int(budget_bytes))

    @staticmethod
    def _estimate(rt: RetainedTrace) -> int:
        n = 256 + len(rt.sql) + 24 * len(rt.phases)
        for d in rt.spans:
            n += 96 + len(d.get("name", ""))
            n += sum(len(str(k)) + len(str(v)) + 16
                     for k, v in (d.get("attrs") or {}).items())
        return n

    def offer(self, prof: "QueryProfile", digest: str,
              slow: bool = False, shed: bool = False,
              forced: bool = False) -> Optional[RetainedTrace]:
        """Retention decision for a finished (or aborted) query.  Tail
        conditions (error/slow/shed) always retain; `forced` marks an
        upstream router's propagated sampling decision (the trace hint's
        sampled flag — the router will pull this id back by exact match);
        otherwise `prof.sampled` — the head verdict stamped ONCE at query
        entry (the sampler keeps cadence counters; re-asking here would
        double-count the digest).  Returns the retained entry or None."""
        if prof.error or shed:
            reason = "shed" if shed else "error"
        elif slow:
            reason = "slow"
        elif forced:
            reason = "remote"
        elif prof.sampled:
            reason = "sampled"
        else:
            return None
        if prof.spans:
            spans = [s.to_dict() for s in prof.spans]
            if not spans[0].get("dur_us"):
                # the root span is still open at the finish ramp (it closes
                # when the ramp unwinds); stamp the observed elapsed so
                # retained trees render a closed root
                spans[0]["dur_us"] = prof.elapsed_ms * 1000.0
        else:
            # unsampled query that tail-retained: the hot path skipped the
            # span machinery, so synthesize the root from the profile — the
            # phase breakdown is the evidence, the tree is a formality
            attrs: Dict[str, Any] = {"sql": prof.sql[:128],
                                     "conn": prof.conn_id,
                                     "schema": prof.schema,
                                     "synthesized": True}
            if prof.phases:
                attrs["phases"] = dict(prof.phases)
            if prof.error:
                attrs["error"] = prof.error[:256]
            spans = [{"span_id": 1, "parent_id": 0, "name": "query",
                      "kind": "query", "node": self.node,
                      "start_us": int(prof.started_at * 1e6),
                      "dur_us": round(prof.elapsed_ms * 1000.0, 1),
                      "attrs": attrs}]
        rt = RetainedTrace(
            trace_id=prof.trace_id, digest=digest, sql=prof.sql[:512],
            schema=prof.schema, workload=prof.workload,
            elapsed_ms=round(prof.elapsed_ms, 3), error=prof.error[:256],
            reason=reason, node=self.node, at=time.time(),
            phases=dict(prof.phases), spans=spans)
        return self.put(rt)

    def put(self, rt: RetainedTrace) -> RetainedTrace:
        """Insert an already-assembled trace under the byte budget — the
        router retains its grafted cluster-path trees through here, and
        offer() lands its retention decisions here too."""
        rt.approx_bytes = self._estimate(rt)
        with self._lock:
            # re-retention of the same id (leader + member finish ramps,
            # or a router re-grafting a pulled peer trace)
            prev = self._entries.pop(rt.trace_id, None)
            if prev is not None:
                self._bytes -= prev.approx_bytes
            self._entries[rt.trace_id] = rt
            self._bytes += rt.approx_bytes
            self.retained += 1
            while self._bytes > self._budget and len(self._entries) > 1:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.approx_bytes
                self.evicted += 1
        return rt

    def get(self, trace_id) -> Optional[RetainedTrace]:
        try:
            tid = int(trace_id)
        except (TypeError, ValueError):
            return None
        with self._lock:
            return self._entries.get(tid)

    def for_digest(self, digest: str, limit: int = 4) -> List[RetainedTrace]:
        """Most-recent-first retained traces for one statement digest — the
        flight recorder's evidence query."""
        with self._lock:
            out = [rt for rt in reversed(self._entries.values())
                   if rt.digest == digest]
        return out[:limit]

    def entries(self, limit: int = 0) -> List[RetainedTrace]:
        with self._lock:
            out = list(reversed(self._entries.values()))
        return out[:limit] if limit else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": len(self._entries), "bytes": self._bytes,
                    "budget": self._budget, "retained": self.retained,
                    "evicted": self.evicted, "rate": self.sampler.rate}

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class MatrixStatistics:
    """Instance-level counters (SHOW @@stats analog, §5.5)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.queries = 0
        self.dml = 0
        self.errors = 0
        self.slow = 0
        self.active_connections = 0

    def bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> List[Tuple[str, int]]:
        with self._lock:
            return [("queries", self.queries), ("dml", self.dml),
                    ("errors", self.errors), ("slow", self.slow),
                    ("active_connections", self.active_connections)]


GLOBAL_STATS = MatrixStatistics()
