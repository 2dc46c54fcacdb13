"""Pure-Python oracles of two Spark expressions, standard library and
numpy only, so that both the CPU tests and ``chip_smoke.py`` on the card
can hold the port against them:

* :func:`format_number` — Spark ``format_number(x, d)`` over a float:
  the value's shortest round-trip digits (``repr``; numpy's unique
  float32 form), rounded half-even to ``d`` places by ``decimal`` and
  grouped by thousands;
* :func:`zone_offset_micros` — a time zone's UTC offset at an instant,
  from ``zoneinfo``, with the instant's seconds truncated toward zero as
  the reference's ``timezones.cu:74`` truncates them.
"""

from datetime import datetime, timezone
from decimal import ROUND_HALF_EVEN, Decimal, localcontext
from zoneinfo import ZoneInfo

import numpy as np


def format_number(x, d: int, f32: bool) -> str:
    if x != x:
        return "�"
    if np.isinf(x):
        return ("-" if x < 0 else "") + "∞"
    if x == 0:
        return ("-" if np.signbit(x) else "") + ("0." + "0" * d if d
                                                  else "0")
    s = (np.format_float_positional(np.float32(x), unique=True, trim="-")
         if f32 else repr(float(x)))
    with localcontext() as ctx:
        ctx.prec = 400
        q = Decimal(s).quantize(Decimal(1).scaleb(-d),
                                rounding=ROUND_HALF_EVEN)
        out = f"{q:,.{d}f}"
    return out if out.startswith("-") or x > 0 else "-" + out


def zone_offset_micros(zone_id: str, utc_micros: int) -> int:
    """``UTC``, ``(+|-)hh:mm`` or an IANA zone's offset in force at the
    instant (``utcoffset`` of a bare UTC datetime would read its fields
    as local wall time)."""
    if zone_id == "UTC":
        return 0
    if zone_id.startswith(("+", "-")):
        sign = 1 if zone_id[0] == "+" else -1
        hh, mm = zone_id[1:].split(":")
        return sign * (int(hh) * 3600 + int(mm) * 60) * 10**6
    secs = -(-utc_micros // 10**6) if utc_micros < 0 else utc_micros // 10**6
    dt = datetime.fromtimestamp(secs, tz=timezone.utc).astimezone(
        ZoneInfo(zone_id))
    return int(dt.utcoffset().total_seconds()) * 10**6
