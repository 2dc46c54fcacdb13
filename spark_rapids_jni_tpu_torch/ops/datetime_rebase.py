"""Proleptic-Gregorian ⇄ hybrid-Julian calendar rebase for days/micros.

Counterpart of ``spark_rapids_jni_tpu/ops/datetime_rebase.py``.  Matches
Spark's ``localRebaseGregorianToJulianDays`` /
``rebaseGregorianToJulianMicros`` (UTC) family as implemented by the
reference ``datetime_rebase.cu``:

* A date >= 1582-10-15 (Gregorian adoption) is identical in both
  calendars.
* Dates in the adoption gap (1582-10-05 .. 1582-10-14, which never
  existed in the hybrid calendar) collapse to 1582-10-15 → day -141427.
* Older dates: reinterpret the local y/m/d in the other calendar and
  recompute days-since-epoch.  Civil-date math follows Howard Hinnant's
  ``days_from_civil``/``civil_from_days`` algorithms (as the reference
  does, datetime_rebase.cu:40-52,110-126): pure integer arithmetic with
  floor division, elementwise over the column in its own dtype.

Micros variants split into (days, time-of-day) with floor/pmod semantics
(``get_time_components``, datetime_rebase.cu:198-222) and reuse the day
rebase on the date part; time-of-day passes through unchanged.
"""

from __future__ import annotations

import torch

from ..columnar import types as T
from ..columnar.column import Column

_GREGORIAN_START_DAYS = -141427  # 1582-10-15
_JULIAN_END_DAYS = -141438  # 1582-10-04 in proleptic Gregorian days
_CUTOVER_MICROS = -12219292800000000  # 1582-10-15T00:00:00Z
_MICROS_PER_DAY = 86400 * 1000000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _mon(cond, a, b, like):
    return torch.where(cond, torch.full_like(like, a), torch.full_like(like, b))


def _civil_from_days(z):
    """Gregorian days-since-epoch -> (y, m, d)."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + _mon(mp < 10, 3, -9, mp)
    return y + (m <= 2).to(y.dtype), m, d


def _days_from_civil(y, m, d):
    """(y, m, d) Gregorian -> days-since-epoch."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + _mon(m > 2, -3, 9, m)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_from_julian(y, m, d):
    """(y, m, d) Julian calendar -> days-since-epoch (reference
    days_from_julian, datetime_rebase.cu:40)."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 4)
    yoe = y - era * 4
    doy = _fdiv(153 * (m + _mon(m > 2, -3, 9, m)) + 2, 5) + d - 1
    doe = yoe * 365 + doy
    return era * 1461 + doe - 719470


def _julian_from_days(z):
    """days-since-epoch -> (y, m, d) in the Julian calendar (reference
    julian_from_days, datetime_rebase.cu:110)."""
    z = z + 719470
    era = _fdiv(z, 1461)
    doe = z - era * 1461
    yoe = _fdiv(doe - _fdiv(doe, 1460), 365)
    y = yoe + era * 4
    doy = doe - 365 * yoe
    mp = _fdiv(5 * doy + 2, 153)
    m = mp + _mon(mp < 10, 3, -9, mp)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    return y + (m <= 2).to(y.dtype), m, d


def _rebase_days_g2j(days):
    y, m, d = _civil_from_days(days)
    julian = _days_from_julian(y, m, d)
    out = torch.where(days > _JULIAN_END_DAYS,
                      torch.full_like(julian, _GREGORIAN_START_DAYS), julian)
    return torch.where(days >= _GREGORIAN_START_DAYS, days,
                       out).to(days.dtype)


def _rebase_days_j2g(days):
    y, m, d = _julian_from_days(days)
    greg = _days_from_civil(y, m, d)
    return torch.where(days >= _GREGORIAN_START_DAYS, days,
                       greg).to(days.dtype)


def _rebase_micros(micros, day_fn):
    days = _fdiv(micros, _MICROS_PER_DAY)
    tod = micros - days * _MICROS_PER_DAY  # [0, day): floor/pmod semantics
    out = day_fn(days) * _MICROS_PER_DAY + tod
    return torch.where(micros >= _CUTOVER_MICROS, micros, out)


def rebase_gregorian_to_julian(col: Column) -> Column:
    """DATE/TIMESTAMP rebase (reference rebase_gregorian_to_julian,
    datetime_rebase.cu:346)."""
    if col.dtype.kind is T.Kind.DATE:
        return Column(_rebase_days_g2j(col.data), col.validity, col.dtype)
    if col.dtype.kind is T.Kind.TIMESTAMP:
        return Column(_rebase_micros(col.data, _rebase_days_g2j),
                      col.validity, col.dtype)
    raise TypeError(f"rebase expects DATE or TIMESTAMP, got {col.dtype!r}")


def rebase_julian_to_gregorian(col: Column) -> Column:
    """Inverse rebase (reference rebase_julian_to_gregorian,
    datetime_rebase.cu:361)."""
    if col.dtype.kind is T.Kind.DATE:
        return Column(_rebase_days_j2g(col.data), col.validity, col.dtype)
    if col.dtype.kind is T.Kind.TIMESTAMP:
        return Column(_rebase_micros(col.data, _rebase_days_j2g),
                      col.validity, col.dtype)
    raise TypeError(f"rebase expects DATE or TIMESTAMP, got {col.dtype!r}")
