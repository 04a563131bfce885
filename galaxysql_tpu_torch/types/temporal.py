"""Temporal conversions with MySQL semantics.

Host-side parsing/formatting (str <-> epoch ints) plus vectorizable civil-calendar math used by
both the numpy golden evaluator and the JAX device compiler (EXTRACT/YEAR()/date arithmetic).
The civil algorithms are the classic Hinnant days-from-civil / civil-from-days integer forms,
which map to pure elementwise integer ops — ideal for the VPU.

Reference analog: `polardbx-optimizer/.../core/datatype` temporal types + time functions in
`core/function` (SURVEY.md §2.5).
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Tuple

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC

_DATE_RE = re.compile(r"^(\d{4})-(\d{1,2})-(\d{1,2})$")
_DATETIME_RE = re.compile(
    r"^(\d{4})-(\d{1,2})-(\d{1,2})[ T](\d{1,2}):(\d{1,2}):(\d{1,2})(?:\.(\d{1,6}))?$")


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 from a civil date.  Pure integer math.

    Python's floor division makes the C++ truncation fix-ups unnecessary.
    """
    y = y - (1 if m <= 2 else 0)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z: int) -> Tuple[int, int, int]:
    z = z + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


def parse_date(s: str) -> int:
    """'YYYY-MM-DD' -> epoch days (int32 lane)."""
    m = _DATE_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid DATE literal: {s!r}")
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    return days_from_civil(y, mo, d)


def parse_datetime(s: str) -> int:
    """'YYYY-MM-DD[ T]HH:MM:SS[.ffffff]' -> epoch microseconds (int64 lane)."""
    s = s.strip()
    dm = _DATE_RE.match(s)
    if dm:
        return parse_date(s) * MICROS_PER_DAY
    m = _DATETIME_RE.match(s)
    if not m:
        raise ValueError(f"invalid DATETIME literal: {s!r}")
    y, mo, d, h, mi, sec = (int(m.group(i)) for i in range(1, 7))
    frac = m.group(7)
    us = int(frac.ljust(6, "0")) if frac else 0
    return (days_from_civil(y, mo, d) * 86_400 + h * 3600 + mi * 60 + sec) * MICROS_PER_SEC + us


def format_date(days: int) -> str:
    y, m, d = civil_from_days(int(days))
    return f"{y:04d}-{m:02d}-{d:02d}"


def format_datetime(us: int) -> str:
    us = int(us)
    days, rem = divmod(us, MICROS_PER_DAY)
    y, m, d = civil_from_days(days)
    secs, frac = divmod(rem, MICROS_PER_SEC)
    h, rs = divmod(secs, 3600)
    mi, s = divmod(rs, 60)
    base = f"{y:04d}-{m:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d}"
    return base + (f".{frac:06d}" if frac else "")


def date_to_pydate(days: int) -> _dt.date:
    return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))


def add_interval_days(days: int, n: int) -> int:
    return days + n


def add_interval_months(days: int, n: int) -> int:
    """MySQL DATE_ADD(..., INTERVAL n MONTH): clamp day-of-month to month length."""
    y, m, d = civil_from_days(int(days))
    t = (y * 12 + (m - 1)) + int(n)
    y2, m2 = divmod(t, 12)
    m2 += 1
    # clamp day
    next_month_start = days_from_civil(y2 + (m2 == 12), (m2 % 12) + 1, 1)
    this_month_start = days_from_civil(y2, m2, 1)
    dim = next_month_start - this_month_start
    return days_from_civil(y2, m2, min(d, dim))
