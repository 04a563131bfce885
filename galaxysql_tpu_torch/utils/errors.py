"""Error taxonomy with MySQL error codes.

Reference analog: `polardbx-common/.../exception/code` (SURVEY.md §2.8).  Frontend-visible
errors carry (mysql_errno, sqlstate) so the wire layer can emit proper ERR packets.
"""

from __future__ import annotations


class TddlError(Exception):
    """Base framework error (named after the reference's TddlRuntimeException lineage)."""

    errno = 1105          # ER_UNKNOWN_ERROR
    sqlstate = "HY000"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class SqlSyntaxError(TddlError):
    errno = 1064          # ER_PARSE_ERROR
    sqlstate = "42000"

    def __init__(self, message: str, sql: str = "", pos: int = -1):
        if pos >= 0:
            line = sql.count("\n", 0, pos) + 1
            near = sql[pos:pos + 32]
            message = f"{message} near '{near}' at line {line}"
        super().__init__(message)
        self.sql = sql
        self.pos = pos


class UnknownDatabaseError(TddlError):
    errno = 1049
    sqlstate = "42000"


class UnknownTableError(TddlError):
    errno = 1146
    sqlstate = "42S02"


class UnknownColumnError(TddlError):
    errno = 1054
    sqlstate = "42S22"


class TableExistsError(TddlError):
    errno = 1050
    sqlstate = "42S01"


class AmbiguousColumnError(TddlError):
    errno = 1052
    sqlstate = "23000"


class NotSupportedError(TddlError):
    errno = 1235          # ER_NOT_SUPPORTED_YET
    sqlstate = "42000"


class DuplicateKeyError(TddlError):
    errno = 1062
    sqlstate = "23000"


class TransactionError(TddlError):
    errno = 1205
    sqlstate = "HY000"


class DeadlockError(TddlError):
    errno = 1213
    sqlstate = "40001"


class AccessDeniedError(TddlError):
    errno = 1045
    sqlstate = "28000"


class CclRejectError(TddlError):
    """Query rejected/queued-timeout by concurrency control (CCL analog)."""
    errno = 3168
    sqlstate = "HY000"


class ServerOverloadError(TddlError):
    """Admission control shed this query: the server is saturated (per-class
    concurrency limit + full wait queue, CRITICAL memory pressure, or a
    deadline that cannot cover the digest's predicted service time).

    Carries `retry_after_ms` — the client-visible backoff suggestion — so a
    well-behaved driver retries later instead of amplifying the overload.
    Typed (never a hang, never a raw queue error): the overload harness
    asserts every refusal under flood is this class or CclRejectError."""
    errno = 9003
    sqlstate = "HY000"

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class QueryTimeoutError(TddlError):
    """Query exceeded its MAX_EXECUTION_TIME deadline (ER_QUERY_TIMEOUT).

    Raised at operator drain / fused-segment / MPP-stage boundaries and by
    workers that receive a fragment whose propagated deadline already passed —
    a deadline-killed query dies TYPED everywhere, never as a hang.

    `sent` mirrors WorkerUnavailableError: False means the deadline expired
    BEFORE any bytes hit the wire (provably nothing applied remotely); True
    (default) means a remote side may have executed work."""
    errno = 3024
    sqlstate = "HY000"
    sent = True

    def __init__(self, message: str, sent: bool = True):
        super().__init__(message)
        self.sent = sent


class WorkerUnavailableError(TddlError):
    """A worker endpoint is unreachable: retry budget exhausted or the
    circuit breaker is open (fast-fail).  Callers with an alternate endpoint
    (replica reads) fail over; callers without one surface this typed.

    `sent` tells write callers whether the request may have REACHED the
    worker: False means nothing ever hit the wire (breaker fast-fail,
    connect refused) — the outcome is provably "nothing applied" and an
    explicit transaction can survive with statement-scoped semantics; True
    (the conservative default) means the outcome is ambiguous."""
    errno = 9002
    sqlstate = "HY000"
    sent = True

    def __init__(self, message: str, sent: bool = True):
        super().__init__(message)
        self.sent = sent


class CoordinatorUnavailableError(TddlError):
    """A peer coordinator in the serving tier is unreachable (router
    transport failure, fence, or a dead process found mid-statement).

    Sticky (session-pinned) statements surface this typed EXACTLY ONCE —
    the pinned peer's session state (txn, temp tables, session vars) died
    with it and cannot be transparently replayed; the session then unpins
    and the next statement re-routes.  Stateless statements never see it:
    the router fails over within the statement."""
    errno = 9004
    sqlstate = "HY000"


class ProtocolError(TddlError):
    """Corrupt/overlong RPC frame on the CN<->worker wire (ER_NET_READ_ERROR).

    Raised instead of trusting an attacker-or-corruption-controlled length
    prefix: the framing layer caps header/name/array sizes and kills the
    connection rather than allocating arbitrary memory."""
    errno = 1158
    sqlstate = "08S01"


def span_attrs(exc: BaseException) -> dict:
    """Error attributes for span tracing: the (errno, sqlstate) taxonomy above
    rides error spans so SHOW TRACE / the Chrome-trace export explain a failed
    query the same way the wire's ERR packet would."""
    return {
        "exception": type(exc).__name__,
        "errno": int(getattr(exc, "errno", 1105) or 1105),
        "sqlstate": str(getattr(exc, "sqlstate", "HY000") or "HY000"),
        "message": str(exc)[:256],
    }
