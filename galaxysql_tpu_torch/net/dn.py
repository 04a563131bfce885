"""The CN<->worker RPC plane: plan shipping to a second process.

Reference analog: the CN->DN seam — `repo/mysql/spi/MyJdbcHandler.java:691`
(physical SQL shipped to the shard's storage node and executed there) plus the
inter-CN sync-action bus (`executor/sync/SyncManagerHelper.java:36`).  A worker
(`galaxysql_tpu.net.worker`) is a real second OS process hosting its own
engine Instance; the coordinator attaches its tables as *remote tables* whose
scans compile to shipped SQL (filters/column pruning pushed down), so one
query's fragments genuinely span two processes.

Wire format: length-prefixed JSON header + raw npy column payloads over a
localhost TCP socket.  JSON (not pickle) on purpose: the socket is an internal
trust boundary and must not be an arbitrary-code-execution vector.  Frame
lengths are CAPPED (`_MAX_*`): a corrupt/hostile length prefix raises a typed
ProtocolError instead of allocating arbitrary memory.

Fault tolerance (the FailPoint-proven layer the reference's SyncManager/HA
machinery implies):

- **Per-op retry policy.**  Transport failures retry ONLY retry-safe requests:
  reads (exec_plan, read-only exec_sql), idempotent control ops (ping/sync/
  xa_*), and uid-stamped writes — the worker keeps a bounded dedupe window
  keyed on the uid and replays the recorded result, so a reconnect retry can
  never double-apply DML.  Retries use capped exponential backoff with full
  jitter (first retry reconnects immediately: the worker may simply have
  restarted between queries).
- **Deadlines.**  A caller-supplied absolute deadline rides the header as the
  remaining budget (`deadline_ms`); the worker aborts past-deadline fragments
  and this side fails typed (QueryTimeoutError) instead of hanging.
- **Circuit breaker.**  Consecutive transport failures open the breaker:
  requests fast-fail typed (WorkerUnavailableError) without touching the dead
  socket; after a cooldown the breaker half-opens, one ping probe decides
  closed vs re-open.
- **Sync epochs.**  Every SyncBus broadcast bumps a monotonic epoch carried on
  ALL requests; a worker that detects a gap (it was down/unreachable during a
  broadcast) wholesale-invalidates its caches — a missed invalidation heals at
  first contact instead of serving stale caches forever.
"""

from __future__ import annotations

import io
import json
import random
import re
import socket
import struct
import threading
import time
from time import perf_counter as _perf
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.utils.failpoint import (FAIL_POINTS, FP_RPC_DELAY_MS,
                                           FP_RPC_DROP, FP_RPC_FAIL_N)

_HDR = struct.Struct(">I")

# framing caps: the 4-byte length prefixes arrive from the wire and must not
# be trusted unbounded (satellite: a corrupt frame must fail typed, not OOM)
_MAX_HEADER_BYTES = 16 << 20      # JSON header
_MAX_NAME_BYTES = 4 << 10         # array name
_MAX_ARRAY_BYTES = (2 << 30) - 1  # one npy payload
_MAX_ARRAYS = 4096                # arrays per message


def encode_msg(header: dict,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Validate + encode one frame (no IO).  Caps are enforced on BOTH
    sides: a payload the receiver would reject as corrupt must fail typed
    here, BEFORE any byte ships, naming the real cause (oversized result)
    instead of dying mid-transfer as 'corrupt frame' on a healthy
    connection.  Separated from the send so callers can distinguish
    pre-wire validation failures from transmission failures."""
    arrays = arrays or {}
    header = dict(header)
    header["n_arrays"] = _checked_len(len(arrays), _MAX_ARRAYS,
                                      "outbound array count")
    hb = json.dumps(header).encode()
    _checked_len(len(hb), _MAX_HEADER_BYTES, "outbound header")
    out = [_HDR.pack(len(hb)), hb]
    for name, arr in arrays.items():
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
        nb = name.encode()
        _checked_len(len(nb), _MAX_NAME_BYTES, "outbound array name")
        _checked_len(buf.getbuffer().nbytes, _MAX_ARRAY_BYTES,
                     f"outbound array {name!r} (result too large)")
        out += [_HDR.pack(len(nb)), nb, _HDR.pack(buf.getbuffer().nbytes),
                buf.getvalue()]
    return b"".join(out)


def send_msg(sock: socket.socket, header: dict,
             arrays: Optional[Dict[str, np.ndarray]] = None):
    """[u32 jsonlen][json][per-array: u32 namelen][name][u32 npylen][npy]"""
    sock.sendall(encode_msg(header, arrays))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _checked_len(n: int, cap: int, what: str) -> int:
    if n > cap:
        from galaxysql_tpu_torch.utils import errors
        raise errors.ProtocolError(
            f"corrupt frame: {what} length {n} exceeds cap {cap}")
    return n


def recv_msg(sock: socket.socket) -> Tuple[dict, Dict[str, np.ndarray]]:
    try:
        (hlen,) = _HDR.unpack(_recv_exact(sock, 4))
        header = json.loads(_recv_exact(
            sock, _checked_len(hlen, _MAX_HEADER_BYTES, "header")))
        arrays: Dict[str, np.ndarray] = {}
        n_arrays = int(header.get("n_arrays", 0))
        _checked_len(n_arrays, _MAX_ARRAYS, "array count")
        for _ in range(n_arrays):
            (nlen,) = _HDR.unpack(_recv_exact(sock, 4))
            name = _recv_exact(
                sock,
                _checked_len(nlen, _MAX_NAME_BYTES, "array name")).decode()
            (alen,) = _HDR.unpack(_recv_exact(sock, 4))
            arrays[name] = np.load(
                io.BytesIO(_recv_exact(
                    sock, _checked_len(alen, _MAX_ARRAY_BYTES, "array"))),
                allow_pickle=False)
        return header, arrays
    except (ValueError, EOFError, UnicodeDecodeError, AttributeError) as e:
        # decode failure (bad JSON, corrupt npy, mangled name) is the SAME
        # desynchronized-stream condition as a blown length cap: it must
        # surface typed so the retry/ambiguity machinery engages, never as
        # a raw ValueError that bypasses every handler
        from galaxysql_tpu_torch.utils import errors
        raise errors.ProtocolError(
            f"corrupt frame: {type(e).__name__}: {e}") from e


# ops whose handler is idempotent by construction: control-plane chatter plus
# the XA verbs (the worker's prepare/commit/rollback all tolerate replay — the
# "already" paths) and pure-read fragments
_IDEMPOTENT_OPS = frozenset({"ping", "sync", "exec_plan", "xa_prepare",
                             "xa_commit", "xa_rollback", "xa_recover"})
_READONLY_SQL_RE = re.compile(
    r"^\s*(?:/\*.*?\*/\s*)*(?:select|show|explain|describe|desc)\b",
    re.I | re.S)


def _retry_safe(header: dict) -> bool:
    """May this request be re-sent after a transport failure?  Reads and
    idempotent control ops always; writes ONLY when uid-stamped (the worker's
    dedupe window makes the replay exactly-once) or explicitly flagged
    idempotent by the caller (`idem`, e.g. CREATE ... IF NOT EXISTS)."""
    op = header.get("op")
    if op in _IDEMPOTENT_OPS:
        return True
    if header.get("uid") or header.get("idem"):
        return True
    if op == "exec_sql":
        return bool(_READONLY_SQL_RE.match(header.get("sql") or ""))
    return False


class RetryBudget:
    """Token bucket bounding retry attempts per worker endpoint.

    Under saturation every retry is ADDED load on a box already failing to
    keep up — unbounded retries turn one slow worker into a metastable storm
    (the whole fleet re-sending the same work).  Each retry attempt takes one
    token; tokens refill at a steady rate, so a brief blip retries freely
    while a sustained failure quickly degrades to fail-fast typed errors.
    Locked, but only touched on the failure path — never on a healthy RPC."""

    def __init__(self, capacity: int = 64, refill_per_s: float = 8.0):
        self.capacity = max(0, int(capacity))
        self.refill_per_s = max(0.0, float(refill_per_s))
        self._tokens = float(self.capacity)
        self._at = time.monotonic()
        self._lock = threading.Lock()
        self.exhausted = 0  # lifetime fail-fast count (SHOW WORKERS)

    def _refill_locked(self, now: float):
        self._tokens = min(float(self.capacity),
                           self._tokens + (now - self._at) * self.refill_per_s)
        self._at = now

    def configure(self, capacity: int, refill_per_s: float):
        with self._lock:
            self._refill_locked(time.monotonic())
            self.capacity = max(0, int(capacity))
            self.refill_per_s = max(0.0, float(refill_per_s))
            self._tokens = min(self._tokens, float(self.capacity))

    def try_take(self) -> bool:
        with self._lock:
            self._refill_locked(time.monotonic())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.exhausted += 1
            return False

    def remaining(self) -> float:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._tokens


class WorkerClient:
    """Coordinator-side connection to one worker process (one socket, locked:
    the protocol is strictly request/response)."""

    def __init__(self, host: str, port: int, timeout: float = 180.0,
                 max_retries: int = 2, retry_backoff_ms: int = 20,
                 failure_threshold: int = 3, cooldown_ms: int = 1000,
                 config=None):
        # generous default: the worker's FIRST query on a cold process pays
        # XLA compiles; ping() overrides with a short probe timeout
        self.timeout = timeout
        self.addr = (host, port)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # retry/breaker knobs: with a ConfigParams bound (Instance-created
        # clients) the values read LIVE, so SET GLOBAL BREAKER_* /
        # RPC_MAX_RETRIES apply to already-attached workers too; the
        # constructor kwargs are the standalone/test fallbacks
        self._cfg = config
        self._max_retries = max(0, int(max_retries))
        self._retry_backoff_ms = max(1, int(retry_backoff_ms))
        # circuit breaker: closed -> (threshold consecutive transport
        # failures) -> open -> (cooldown) -> half-open (ping probe) ->
        # closed | open.  State reads on the hot path are lock-free.
        self._failure_threshold = max(1, int(failure_threshold))
        self._cooldown_ms = max(1, int(cooldown_ms))
        self._bk_lock = threading.Lock()
        self._bk_state = "closed"
        self._bk_fails = 0          # consecutive transport failures
        self._bk_opened_at = 0.0
        # lifetime stats for SHOW WORKERS / information_schema.workers
        self.stat_retries = 0
        self.stat_failures = 0
        self.stat_opens = 0
        self.last_error = ""
        # retry budget (token bucket): each retry attempt takes one token;
        # empty bucket -> fail typed instead of retrying (no retry storms).
        # Live-config clients re-read the knobs on each take.
        self.retry_budget = RetryBudget(
            int(self._param("RPC_RETRY_BUDGET", 64)),
            float(self._param("RPC_RETRY_REFILL_PER_S", 8)))
        # worker-piggybacked load (queue depth + memory tier from RPC
        # replies): routing deprioritizes pressured endpoints
        self.load_q = 0
        self.load_tier = 0
        self.load_at = 0.0
        # SLO-plane piggyback twin: worker uptime + history sample count
        # feed the pull-free cluster-health view
        self.load_up = 0.0
        self.load_samples = 0
        # sync-epoch plane: bound by SyncBus.attach; adds {se, origin} to
        # every request so the worker can detect missed broadcasts
        self._sync_bus = None
        # set when a broadcast delivery to THIS worker failed: the next
        # successful request carries a heal directive (wholesale cache
        # invalidation), closing the missed-invalidation hole exactly —
        # epoch comparison alone can miss an out-of-order-completed gap.
        # The generation counter guards the clear: a miss flagged WHILE a
        # heal-carrying request was in flight must survive that request's
        # success (its heal predates the new miss).
        self.needs_heal = False
        self._heal_gen = 0

    def mark_needs_heal(self):
        with self._bk_lock:
            self._heal_gen += 1
            self.needs_heal = True

    def bind_sync_bus(self, bus):
        self._sync_bus = bus

    def _param(self, name: str, fallback):
        if self._cfg is not None:
            v = self._cfg.get(name)
            if v is not None:
                return v
        return fallback

    @property
    def max_retries(self) -> int:
        return max(0, int(self._param("RPC_MAX_RETRIES", self._max_retries)))

    @property
    def retry_backoff_ms(self) -> int:
        return max(1, int(self._param("RPC_RETRY_BACKOFF_MS",
                                      self._retry_backoff_ms)))

    @property
    def failure_threshold(self) -> int:
        return max(1, int(self._param("BREAKER_FAILURE_THRESHOLD",
                                      self._failure_threshold)))

    @property
    def cooldown_s(self) -> float:
        return max(0.001, int(self._param("BREAKER_COOLDOWN_MS",
                                          self._cooldown_ms)) / 1000.0)

    def _connect(self, timeout: Optional[float] = None):
        if self._sock is None:
            s = socket.create_connection(self.addr,
                                         timeout=timeout or self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s

    # -- circuit breaker -----------------------------------------------------

    def breaker_state(self) -> str:
        return self._bk_state

    def breaker_blocked(self) -> bool:
        """True while requests would fast-fail: breaker open AND still inside
        the cooldown, or half-open with a probe already in flight.  Routing
        skips blocked endpoints; a cooled-down open breaker stays routable so
        the next request runs the half-open probe."""
        if self._bk_state == "half-open":
            return True
        return self._bk_state == "open" and \
            time.time() - self._bk_opened_at < self.cooldown_s

    def breaker_snapshot(self) -> dict:
        with self._bk_lock:
            return {"state": self._bk_state, "consec_failures": self._bk_fails,
                    "opens": self.stat_opens, "retries": self.stat_retries,
                    "failures": self.stat_failures,
                    "last_error": self.last_error}

    def _breaker_ok(self):
        if self._bk_fails or self._bk_state != "closed":
            with self._bk_lock:
                reopened = self._bk_state != "closed"
                self._bk_fails = 0
                self._bk_state = "closed"
            if reopened:
                from galaxysql_tpu_torch.utils import events
                events.publish("breaker_close",
                               f"worker {self.addr[0]}:{self.addr[1]}: "
                               "circuit breaker closed (probe succeeded)",
                               worker=f"{self.addr[0]}:{self.addr[1]}")

    def _breaker_fail(self, exc: BaseException):
        from galaxysql_tpu_torch.utils.metrics import BREAKER_OPENS
        with self._bk_lock:
            self._bk_fails += 1
            self.stat_failures += 1
            self.last_error = f"{type(exc).__name__}: {exc}"[:160]
            if self._bk_fails >= self.failure_threshold and \
                    self._bk_state != "open":
                self._bk_state = "open"
                self._bk_opened_at = time.time()
                self.stat_opens += 1
                BREAKER_OPENS.inc()
                from galaxysql_tpu_torch.utils import events, tracing
                tc = tracing.current()
                events.publish("breaker_open",
                               f"worker {self.addr[0]}:{self.addr[1]}: "
                               f"breaker opened after {self._bk_fails} "
                               f"failures ({self.last_error})",
                               worker=f"{self.addr[0]}:{self.addr[1]}",
                               consec_failures=self._bk_fails,
                               trace_id=tc.trace_id if tc is not None else 0)

    def _breaker_gate(self):
        """Fast-fail while open; after the cooldown, half-open and let ONE
        ping probe decide — concurrent callers fast-fail typed instead of
        piling blocking probes onto a possibly-dead worker.  The hot path
        (closed) is a single attribute read."""
        if self._bk_state == "closed":
            return
        from galaxysql_tpu_torch.utils import errors
        with self._bk_lock:
            if self._bk_state == "closed":
                return
            if self._bk_state == "half-open":
                # another caller owns the in-flight probe
                raise errors.WorkerUnavailableError(
                    f"worker {self.addr[0]}:{self.addr[1]}: circuit breaker "
                    f"half-open (probe in flight)", sent=False)
            if time.time() - self._bk_opened_at < self.cooldown_s:
                raise errors.WorkerUnavailableError(
                    f"worker {self.addr[0]}:{self.addr[1]}: circuit breaker "
                    f"open ({self._bk_fails} consecutive failures: "
                    f"{self.last_error})", sent=False)
            self._bk_state = "half-open"  # this caller owns the probe
        # probe outside the breaker lock (socket IO); ping() resets the
        # breaker on success, so a passing probe closes it — ping never
        # raises, so the half-open claim cannot leak
        if not self.ping(timeout=min(2.0, self.cooldown_s * 2)):
            from galaxysql_tpu_torch.utils.metrics import BREAKER_OPENS
            with self._bk_lock:
                self._bk_state = "open"
                self._bk_opened_at = time.time()
                # a re-open IS an open transition: SHOW WORKERS and the
                # breaker_opens counter must show a flapping endpoint
                self.stat_opens += 1
            BREAKER_OPENS.inc()
            from galaxysql_tpu_torch.utils import events, tracing
            tc = tracing.current()
            events.publish("breaker_open",
                           f"worker {self.addr[0]}:{self.addr[1]}: "
                           "half-open probe failed; breaker re-opened",
                           worker=f"{self.addr[0]}:{self.addr[1]}",
                           trace_id=tc.trace_id if tc is not None else 0)
            raise errors.WorkerUnavailableError(
                f"worker {self.addr[0]}:{self.addr[1]}: half-open probe "
                f"failed; breaker re-opened", sent=False)

    # ops whose worker-side execution is worth a span subtree; control-plane
    # chatter (ping, sync, xa_*) stays untraced
    _TRACED_OPS = frozenset({"exec_plan", "exec_sql", "dml"})

    def _fault_plan(self, op: str):
        """Armed network failpoints for this attempt: (fail_now, delay_ms,
        drop_leg).  One locked lookup per armed key; nothing when idle.
        FAIL_N preempts the attempt entirely, so it must not consume the
        budgets of co-armed delay/drop keys (they fire on later attempts)."""
        if not FAIL_POINTS.active:
            return False, 0.0, None
        if FAIL_POINTS.rpc_spec(FP_RPC_FAIL_N, op) is not None:
            return True, 0.0, None
        d = FAIL_POINTS.rpc_spec(FP_RPC_DELAY_MS, op)
        delay = float(d.get("ms", 25.0)) if d is not None else 0.0
        drop = FAIL_POINTS.rpc_spec(FP_RPC_DROP, op)
        leg = (drop.get("leg", "request") if drop is not None else None)
        return False, delay, leg

    def _exchange(self, header: dict, arrays, op: str,
                  deadline: Optional[float]):
        """One locked wire round-trip: connect, inject armed faults, stamp
        the remaining deadline budget, send, receive.  On ANY failure the
        socket is closed while still holding the lock — a deferred close
        would race a concurrent request's freshly-connected socket on this
        shared client.  Returns (resp, arrs, t_send, t_recv, rtt_ms).

        Transport exceptions are annotated with `_gx_sent`: whether bytes may
        have reached the worker (True once send began) — write callers use it
        to tell provably-unapplied failures from ambiguous ones."""
        from galaxysql_tpu_torch.utils import errors
        from galaxysql_tpu_torch.utils import tracing
        sent = False
        with self._lock:
            try:
                if deadline is not None:
                    # the deadline must bound the CONNECT too: a blackholed
                    # endpoint would otherwise hold this client's lock for
                    # the 180s default while the caller promised a bound
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise errors.QueryTimeoutError(
                            f"deadline exceeded before rpc:{op} to "
                            f"{self.addr[0]}:{self.addr[1]}", sent=False)
                    self._connect(timeout=min(self.timeout,
                                              max(0.05, remaining) + 1.0))
                else:
                    self._connect()
                fail_now, delay_ms, drop_leg = self._fault_plan(op)
                if delay_ms:
                    time.sleep(delay_ms / 1000.0)
                if fail_now:
                    raise ConnectionError("FP_RPC_FAIL_N armed")
                if drop_leg == "request":
                    raise ConnectionError("FP_RPC_DROP request leg")
                if deadline is not None:
                    # the shipped budget is computed at the LAST moment
                    # (after lock-wait and injected delays): an expired
                    # deadline dies typed here, a live one also bounds the
                    # socket wait — a silent peer cannot hang a
                    # deadline-carrying request
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise errors.QueryTimeoutError(
                            f"deadline exceeded before rpc:{op} to "
                            f"{self.addr[0]}:{self.addr[1]}", sent=False)
                    header["deadline_ms"] = int(remaining * 1000)
                    self._sock.settimeout(max(0.05, remaining) + 1.0)
                try:
                    # encode (and cap-validate) BEFORE the wire: a frame
                    # rejected here provably never reached the worker
                    payload = encode_msg(header, arrays)
                    t_send, t0 = tracing.now_us(), _perf()
                    sent = True  # from here, bytes may have hit the wire
                    self._sock.sendall(payload)
                    if drop_leg == "reply":
                        # the worker HAS the request (it will execute it);
                        # this side loses the reply — the double-apply trap
                        # the dedupe window covers
                        raise ConnectionError("FP_RPC_DROP reply leg")
                    resp, arrs = recv_msg(self._sock)
                finally:
                    if deadline is not None and self._sock is not None:
                        self._sock.settimeout(self.timeout)
            except errors.QueryTimeoutError:
                raise  # pre-send: nothing on the wire, socket stays aligned
            except Exception as e:
                # transport failure or corrupt frame: the stream must not be
                # reused (ProtocolError mid-frame is desynchronized too)
                e._gx_sent = sent
                self.close()
                if deadline is not None and isinstance(e, TimeoutError) \
                        and time.time() >= deadline:
                    # the deadline-bounded socket wait tripped: this is the
                    # QUERY dying, not the worker — typed timeout, no
                    # breaker accounting against a live-but-slow endpoint,
                    # and the sent flag survives (a connect timeout provably
                    # put nothing on the wire)
                    stage = "awaiting reply from" if sent else "connecting to"
                    raise errors.QueryTimeoutError(
                        f"deadline exceeded {stage} rpc:{op} "
                        f"{self.addr[0]}:{self.addr[1]}", sent=sent) from e
                raise
            rtt_ms = (_perf() - t0) * 1000.0
            t_recv = tracing.now_us()
        return resp, arrs, t_send, t_recv, rtt_ms

    def request(self, header: dict,
                arrays: Optional[Dict[str, np.ndarray]] = None,
                deadline: Optional[float] = None
                ) -> Tuple[dict, Dict[str, np.ndarray]]:
        from galaxysql_tpu_torch.utils import errors
        from galaxysql_tpu_torch.utils import tracing
        from galaxysql_tpu_torch.utils.metrics import (RPC_FAILURES, RPC_RETRIES,
                                                 RPC_RTT_MS)
        self._breaker_gate()
        op = header.get("op")
        header = dict(header)
        if self._sync_bus is not None and self._sync_bus.origin:
            # sync-epoch plane: data requests carry the SETTLED epoch (all
            # broadcasts through it have completed delivery), never the live
            # counter — stamping a mid-flight epoch would race the delivery
            # threads and trigger spurious wholesale heals on the worker
            header["se"] = self._sync_bus.settled
            header["origin"] = self._sync_bus.origin
        heal_gen = None
        if self.needs_heal:
            # this worker missed a broadcast: ask it to wholesale-invalidate
            header["heal"] = 1
            with self._bk_lock:
                heal_gen = self._heal_gen
        tc = tracing.current()
        rpc_span = None
        if tc is not None and op in self._TRACED_OPS:
            # inject trace context into the fragment RPC: the worker opens
            # child spans under `parent` and ships them back in the response
            header["trace"] = {"trace_id": tc.trace_id,
                               "parent": tc.cursor, "node": tc.node}
            rpc_span = tc.begin(f"rpc:{op}", kind="rpc",
                                worker=f"{self.addr[0]}:{self.addr[1]}")
        retryable = _retry_safe(header)
        any_sent = False  # did any attempt put bytes on the wire?
        attempts = 1 + (self.max_retries if retryable else 0)
        # timestamps bracket the ACTUAL wire round-trip (captured inside the
        # lock, re-captured on each retry): lock-wait and retry time must skew
        # neither the NTP-style clock offset nor rpc_rtt_ms
        t_send = t_recv = 0
        rtt_ms = 0.0
        resp: dict = {}
        arrs: Dict[str, np.ndarray] = {}
        try:
            for attempt in range(attempts):
                try:
                    resp, arrs, t_send, t_recv, rtt_ms = \
                        self._exchange(header, arrays, op, deadline)
                    self._breaker_ok()
                    break
                except errors.QueryTimeoutError as e:
                    # a deadline kill is never retried — but a PRE-send kill
                    # on a RETRY attempt must not erase the evidence that an
                    # EARLIER attempt already put this statement on the wire
                    if any_sent:
                        e.sent = True
                    raise
                except (ConnectionError, OSError) as e:
                    # transport failure: the worker may have restarted between
                    # queries (first retry reconnects immediately) or be down
                    # (_exchange already closed the socket, under the lock)
                    any_sent |= getattr(e, "_gx_sent", True)
                    self._breaker_fail(e)
                    if not retryable or attempt == attempts - 1:
                        RPC_FAILURES.inc()
                        raise errors.WorkerUnavailableError(
                            f"worker {self.addr[0]}:{self.addr[1]} rpc:{op} "
                            f"failed after {attempt + 1} attempt(s): "
                            f"{type(e).__name__}: {e}",
                            sent=any_sent) from e
                    if self._cfg is not None:
                        # live knobs: SET GLOBAL RPC_RETRY_BUDGET applies to
                        # attached workers (failure path only — never paid
                        # on a healthy RPC)
                        self.retry_budget.configure(
                            int(self._param("RPC_RETRY_BUDGET", 64)),
                            float(self._param("RPC_RETRY_REFILL_PER_S", 8)))
                    if not self.retry_budget.try_take():
                        # budget empty: retrying now only amplifies the
                        # overload — fail typed instead (no retry storm)
                        from galaxysql_tpu_torch.utils.metrics import \
                            RETRY_BUDGET_EXHAUSTED
                        RETRY_BUDGET_EXHAUSTED.inc()
                        RPC_FAILURES.inc()
                        from galaxysql_tpu_torch.utils import events
                        events.publish(
                            "retry_budget_exhausted",
                            f"worker {self.addr[0]}:{self.addr[1]}: retry "
                            f"budget exhausted; rpc:{op} fails without "
                            f"retry",
                            dedupe=f"rb-{self.addr[0]}:{self.addr[1]}",
                            worker=f"{self.addr[0]}:{self.addr[1]}")
                        raise errors.WorkerUnavailableError(
                            f"worker {self.addr[0]}:{self.addr[1]} rpc:{op} "
                            f"retry budget exhausted after {attempt + 1} "
                            f"attempt(s): {type(e).__name__}: {e}",
                            sent=any_sent) from e
                    with self._bk_lock:
                        self.stat_retries += 1
                    RPC_RETRIES.inc()
                    if rpc_span is not None:
                        rpc_span.attrs["retries"] = attempt + 1
                    if attempt > 0:
                        # capped exponential backoff with full jitter; the
                        # immediate first retry keeps the worker-restarted
                        # fast path as cheap as the old blind reconnect
                        cap = self.retry_backoff_ms * (2 ** (attempt - 1))
                        time.sleep(random.uniform(0, cap) / 1000.0)
        finally:
            if rpc_span is not None:
                tc.end(rpc_span)
        RPC_RTT_MS.observe(rtt_ms)
        wl = resp.pop("wl", None)
        if wl is not None:
            # worker-piggybacked backpressure: queue depth + memory tier ride
            # every reply, so routing deprioritizes pressured endpoints
            # without any extra probe RPC (plain attribute writes — readers
            # tolerate benign races)
            try:
                self.load_q = int(wl.get("q", 0))
                self.load_tier = int(wl.get("mt", 0))
                self.load_up = float(wl.get("up", 0.0))
                self.load_samples = int(wl.get("ns", 0))
                self.load_at = time.time()
            except (TypeError, ValueError, AttributeError):
                pass  # malformed piggyback must never fail a data request
        if rpc_span is not None:
            self._graft_trace(tc, rpc_span, resp, t_send, t_recv)
        if resp.get("error"):
            if int(resp.get("errno") or 0) == errors.QueryTimeoutError.errno:
                # `unapplied` marks the worker's PRE-work rejection: nothing
                # executed, so write callers may keep statement-scoped
                # semantics (sent=False), unlike a mid-execution timeout
                raise errors.QueryTimeoutError(
                    f"worker {self.addr}: {resp['error']}",
                    sent=not resp.get("unapplied"))
            if resp.get("ambiguous"):
                # the worker could not prove the outcome (e.g. a duplicate
                # replay timed out waiting on the still-executing original):
                # write callers must take the unknown-outcome path
                raise errors.WorkerUnavailableError(
                    f"worker {self.addr}: {resp['error']}", sent=True)
            raise errors.TddlError(f"worker {self.addr}: {resp['error']}")
        if heal_gen is not None:
            # the request SUCCEEDED app-level, so the worker really healed
            # (a failed heal raises worker-side and lands above as an error
            # response — the flag must survive it).  Clear only if no NEW
            # miss was flagged while this request was in flight.
            with self._bk_lock:
                if heal_gen == self._heal_gen:
                    self.needs_heal = False
        return resp, arrs

    @staticmethod
    def _graft_trace(tc, rpc_span, resp: dict, t_send: int, t_recv: int):
        """Adopt the worker's span subtree under the RPC span, correcting its
        wall clock: the NTP-style offset `((t_send+t_recv) - (w_recv+w_send))
        / 2` maps the worker's timestamps onto the coordinator's timeline
        (symmetric-latency assumption — localhost sockets here, where the
        residual error is microseconds)."""
        wt = resp.pop("trace", None)
        if not wt:
            return
        try:
            w_recv = int(wt.get("w_recv_us", 0))
            w_send = int(wt.get("w_send_us", 0))
            offset = ((t_send + t_recv) - (w_recv + w_send)) // 2 \
                if w_recv and w_send else 0
            spans = tc.graft(wt.get("spans") or [], parent=rpc_span.span_id,
                             offset_us=offset)
            rpc_span.attrs["worker_spans"] = len(spans)
            rpc_span.attrs["clock_offset_us"] = offset
        except Exception:  # galaxylint: disable=swallow -- malformed trace payload must not fail the data request; span records worker_spans=-1
            # a malformed trace payload must never fail the data request
            rpc_span.attrs["worker_spans"] = -1

    def execute(self, sql: str, schema: str = "",
                xid: Optional[str] = None, uid: Optional[str] = None,
                idem: bool = False,
                deadline: Optional[float] = None
                ) -> Tuple[List[str], List[str],
                           Dict[str, np.ndarray],
                           Dict[str, np.ndarray]]:
        """Ship SQL; returns (columns, sql_types, data arrays, valid arrays).
        With `xid`, the worker runs it in that txn branch's session (reads see
        the branch's uncommitted writes).  Writes should stamp a `uid`
        (exactly-once via the worker's dedupe window) or declare themselves
        `idem` (textually idempotent, e.g. CREATE ... IF NOT EXISTS) to be
        retry-safe across reconnects."""
        hdr: Dict[str, Any] = {"op": "exec_sql", "sql": sql, "schema": schema}
        if xid is not None:
            hdr["xid"] = xid
        if uid is not None:
            hdr["uid"] = uid
        if idem:
            hdr["idem"] = True
        resp, arrs = self.request(hdr, deadline=deadline)
        cols = resp["columns"]
        data = {c: arrs[f"d::{c}"] for c in cols}
        valid = {c: arrs[f"v::{c}"] for c in cols if f"v::{c}" in arrs}
        return cols, resp["types"], data, valid

    def exec_plan(self, fragment: dict, deadline: Optional[float] = None
                  ) -> Tuple[List[str], List[str],
                             Dict[str, np.ndarray],
                             Dict[str, np.ndarray]]:
        """Ship a serialized physical fragment (XPlan analog,
        `RelToXPlanConverter.java:41` / `XPlanTemplate.java:86`): the worker
        executes it straight against its store — no re-parse, no re-plan.
        Raises on an unsupported fragment; the caller degrades to exec_sql."""
        resp, arrs = self.request({"op": "exec_plan", "fragment": fragment},
                                  deadline=deadline)
        cols = resp["columns"]
        data = {c: arrs[f"d::{c}"] for c in cols}
        valid = {c: arrs[f"v::{c}"] for c in cols if f"v::{c}" in arrs}
        return cols, resp["types"], data, valid

    def sync_action(self, action: str, payload: dict) -> dict:
        """Inter-node sync bus (SyncManagerHelper analog): cache invalidation,
        config changes, baseline ops."""
        resp, _ = self.request({"op": "sync", "action": action,
                                "payload": payload})
        return resp

    def sync_broadcast(self, action: str, payload: dict, epoch: int,
                       deadline: Optional[float] = None) -> dict:
        """A BROADCAST delivery (SyncBus.broadcast fan-out): carries the
        broadcast's own epoch so the worker can advance its last-applied mark
        — direct sync_action calls (table_meta, worker_stats, ...) must NOT
        look like broadcast deliveries or they would mask a missed one.  The
        deadline bounds the SOCKET wait: a hung (not dead) worker must not
        park the delivery thread — which holds this client's lock — for the
        full default timeout."""
        resp, _ = self.request({"op": "sync", "action": action,
                                "payload": payload, "bcast_epoch": int(epoch)},
                               deadline=deadline)
        return resp

    def ping(self, timeout: float = 5.0) -> bool:
        try:
            with self._lock:
                try:
                    self._connect()
                    self._sock.settimeout(timeout)
                    try:
                        send_msg(self._sock, {"op": "ping"})
                        resp, _ = recv_msg(self._sock)
                    finally:
                        self._sock.settimeout(self.timeout)
                except Exception:
                    # close INSIDE the lock: a deferred close would race a
                    # concurrent request's freshly-connected socket
                    self.close()
                    raise
            ok = resp.get("ok", False)
            if ok:
                # a live worker closes the breaker (HA probe / half-open path)
                self._breaker_ok()
            return ok
        except Exception:  # galaxylint: disable=swallow -- ping() is a boolean probe: False IS the failure report
            return False

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class SyncBus:
    """Coordinator-side broadcast of sync actions to every attached worker
    (`SyncManagerHelper.sync(...)` analog): parallel fan-out, collects acks.

    Every broadcast bumps a monotonic `epoch` and each delivery carries the
    broadcast's OWN epoch; ordinary requests carry the `settled` epoch (all
    broadcasts through it have completed delivery — stamping the live counter
    would race in-flight delivery threads into spurious heals).  A worker
    that missed a broadcast detects the epoch gap at its next contact — and,
    belt-and-braces, a failed delivery marks the client `needs_heal`, so the
    next successful request to that exact worker forces the wholesale
    invalidation even when epoch arithmetic alone couldn't prove the gap
    (out-of-order completion of concurrent broadcasts)."""

    # a dead worker must cost one bounded join, not a full connect timeout
    # serially added to every broadcast
    BROADCAST_JOIN_S = 20.0

    def __init__(self, origin: Optional[str] = None):
        self.workers: List[WorkerClient] = []
        self.origin = origin
        self.epoch = 0
        self.settled = 0
        self._inflight: set = set()
        self._lock = threading.Lock()

    def attach(self, client):
        with self._lock:
            if client not in self.workers:
                self.workers.append(client)
        if hasattr(client, "bind_sync_bus"):
            client.bind_sync_bus(self)

    def _settle(self, e: int):
        with self._lock:
            self._inflight.discard(e)
            self.settled = (min(self._inflight) - 1) if self._inflight \
                else self.epoch

    def broadcast(self, action: str, payload: dict) -> List[dict]:
        from galaxysql_tpu_torch.utils.metrics import SYNC_FAILURES
        with self._lock:
            self.epoch += 1
            e = self.epoch
            self._inflight.add(e)
            targets = list(self.workers)
        try:
            if not targets:
                return []
            out: List[Optional[dict]] = [None] * len(targets)

            # delivery deadline ≈ the join bound: a hung worker releases the
            # client lock when the bounded socket wait trips, instead of
            # pinning it (and the next data request) for the 180s default
            dl = time.time() + self.BROADCAST_JOIN_S

            def _one(i: int, w):
                # broadcast-flavored delivery for real WorkerClients (carries
                # the epoch); plain sync_action for peer/in-process endpoints
                try:
                    fn = getattr(w, "sync_broadcast", None)
                    out[i] = fn(action, payload, e, deadline=dl) \
                        if fn is not None else w.sync_action(action, payload)
                except Exception as ex:  # a dead worker must not block others
                    out[i] = {"ok": False, "error": str(ex)}

            # per-broadcast daemon threads (not a pool): non-daemon pool
            # threads stuck on a dead worker would block process exit, and a
            # pooled queue would let one hung delivery delay later
            # broadcasts.  Even a SINGLE target goes through the thread so
            # the bounded join holds — a hung (not dead) worker must cost at
            # most BROADCAST_JOIN_S, never a full socket-timeout stall on
            # the issuing session.
            threads = [threading.Thread(target=_one, args=(i, w),
                                        daemon=True)
                       for i, w in enumerate(targets)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(max(0.0, dl - time.time()))
            # failure accounting happens HERE, once per slot, on a SNAPSHOT
            # of each slot — a delivery completing after the join timeout
            # must neither double-count nor flip an already-accounted result
            results: List[dict] = []
            for i, w in enumerate(targets):
                r = out[i]
                if r is None:
                    r = {"ok": False, "error": "sync broadcast timed out"}
                if not r.get("ok"):
                    SYNC_FAILURES.inc()
                    from galaxysql_tpu_torch.utils import events
                    events.publish("sync_failure",
                                   f"sync '{action}' delivery failed: "
                                   f"{r.get('error', '')}"[:200],
                                   node=self.origin or "", action=action)
                    if hasattr(w, "mark_needs_heal"):
                        w.mark_needs_heal()
                results.append(r)
            return results
        finally:
            self._settle(e)
