"""UTC ⇄ local timestamp conversion via a transitions table on the device.

Counterpart of ``spark_rapids_jni_tpu/ops/timezones.py``.  The reference
splits this across two pieces: the Java ``GpuTimeZoneDB`` builds a
``LIST<STRUCT<utcInstant, tzInstant, utcOffset>>`` table from the JVM tz
database (GpuTimeZoneDB.java:261-330) and ``timezones.cu`` binary-searches
it per row.  Here the loader parses the IANA TZif binaries on the host
with numpy (the same data the JVM reads), the tables are copied once to a
device, and the lookup is ``torch.searchsorted`` over the zone's
transitions on the column's device.

Semantics replicated exactly:

* Only fixed-offset zones and zones with no *recurring* DST rules are
  supported (``isSupportedTimeZone``, GpuTimeZoneDB.java:237-247): a TZif
  footer naming a DST rule marks the zone unsupported.
* Sentinel first row at ``INT64_MIN`` carries the pre-transition offset.
* Gap transitions key the local-time breakpoint at ``instant +
  offsetAfter``; overlaps at ``instant + offsetBefore`` (Spark's choice
  of which side of an ambiguous/skipped local time wins); the applied
  offset is always ``offsetAfter`` (GpuTimeZoneDB.java:300-320).
* The row timestamp is reduced to seconds with C++ ``duration_cast``
  truncation-toward-zero before the search (timezones.cu:74-75), then
  the full-resolution value is shifted by the found offset.

Fixed-offset zones (``UTC``, ``+08:00``, ...) need no tz database.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..columnar import types as T
from ..columnar.column import Column
from ..device import resolve_device

_INT64_MIN = -(2**63)


# ---------------------------------------------------------------------------
# TZif parsing (RFC 8536)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ZoneData:
    utc_instants: np.ndarray  # int64 seconds, first row INT64_MIN
    tz_instants: np.ndarray   # int64 seconds (local breakpoints)
    offsets: np.ndarray       # int32 seconds (offset AFTER each transition)


def _parse_tzif(path: str) -> Optional[_ZoneData]:
    """Parse a TZif file into the Spark transition-table form.

    Returns None for zones with recurring DST rules (unsupported, matching
    the reference's isSupportedTimeZone filter).
    """
    with open(path, "rb") as f:
        data = f.read()

    def read_header(off):
        magic, ver, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = (
            struct.unpack(">4s c 15x 6I", data[off: off + 44]))
        if magic != b"TZif":
            raise ValueError(f"{path}: not a TZif file")
        return ver, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt

    ver, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = \
        read_header(0)
    v1_size = 44 + timecnt * 5 + typecnt * 6 + charcnt + leapcnt * 8 \
        + isstdcnt + isutcnt
    if ver in (b"2", b"3", b"4"):
        off = v1_size
        _, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = \
            read_header(off)
        off += 44
        tsize = 8
    else:
        # v1 files carry no footer TZ string, so recurring-DST rules can't
        # be ruled out — treat as unsupported (modern tzdata is all v2+)
        return None

    times = np.frombuffer(data, dtype=f">i{tsize}", count=timecnt,
                          offset=off).astype(np.int64)
    off += timecnt * tsize
    type_idx = np.frombuffer(data, dtype=np.uint8, count=timecnt, offset=off)
    off += timecnt
    ttinfo = [struct.unpack(">i?B", data[off + 6 * i: off + 6 * i + 6])
              for i in range(typecnt)]
    off += typecnt * 6 + charcnt + leapcnt * (tsize + 4) + isstdcnt + isutcnt

    if tsize == 8:  # footer: "\nTZ-string\n"
        footer = data[off:].decode("ascii", "replace").strip("\n")
        # Recurring DST -> unsupported, like the reference's
        # isSupportedTimeZone.  A fixed-offset TZ string is exactly one
        # abbreviation plus an optional offset ("CST-8", "<+07>-7");
        # anything more (dst abbreviation "EST5EDT", comma rule section)
        # names a recurring rule.
        if footer and not re.match(
                r"^(<[^>]+>|[A-Za-z]+)([+-]?\d+(:\d+(:\d+)?)?)?$", footer):
            return None

    utoffs = np.array([t[0] for t in ttinfo], dtype=np.int64)

    # offset before any transition: first non-DST type, else type 0
    first_type = 0
    for i, (_, isdst, _) in enumerate(ttinfo):
        if not isdst:
            first_type = i
            break
    base_off = int(utoffs[first_type]) if typecnt else 0

    utc_instants = [_INT64_MIN]
    tz_instants = [_INT64_MIN]
    offsets = [base_off]
    prev_off = base_off
    for t, idx in zip(times.tolist(), type_idx.tolist()):
        off_after = int(utoffs[idx])
        if off_after > prev_off:  # gap: local breakpoint uses offsetAfter
            tz_instants.append(t + off_after)
        else:  # overlap (or no-op): uses offsetBefore
            tz_instants.append(t + prev_off)
        utc_instants.append(t)
        offsets.append(off_after)
        prev_off = off_after

    return _ZoneData(np.array(utc_instants, np.int64),
                     np.array(tz_instants, np.int64),
                     np.array(offsets, np.int32))


_FIXED_RE = re.compile(r"^([+-])(\d{2}):(\d{2})(?::(\d{2}))?$")


def _normalize_zone_id(zone_id: str) -> str:
    """Spark's pre-3.0 (+|-)h:mm and (+|-)hh:m forms (getZoneId)."""
    zone_id = re.sub(r"^([+-])(\d):", r"\g<1>0\g<2>:", zone_id)
    zone_id = re.sub(r"^([+-])(\d\d):(\d)$", r"\g<1>\g<2>:0\g<3>", zone_id)
    return zone_id


def _fixed_offset_zone(zone_id: str) -> Optional[_ZoneData]:
    if zone_id in ("UTC", "Z", "GMT"):
        secs = 0
    else:
        m = _FIXED_RE.match(_normalize_zone_id(zone_id))
        if not m:
            return None
        sign = 1 if m.group(1) == "+" else -1
        secs = sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60
                       + int(m.group(4) or 0))
    return _ZoneData(np.array([_INT64_MIN], np.int64),
                     np.array([_INT64_MIN], np.int64),
                     np.array([secs], np.int32))


class TimeZoneDB:
    """Lazily-loaded transitions tables (GpuTimeZoneDB equivalent).

    Zones parse on first use (host, numpy) and their tables are copied
    once to each device that asks for them: the column's device in the
    conversions, ``device`` (None means the GPU) in
    :meth:`device_tables`.
    """

    def __init__(self, tzpath: str = "/usr/share/zoneinfo", device=None):
        self._tzpath = tzpath
        self._device = device
        self._zones: Dict[str, Optional[_ZoneData]] = {}
        self._tables: Dict[tuple, tuple] = {}

    _ZONE_ID_RE = re.compile(
        r"^[A-Za-z][A-Za-z0-9_+\-]*(/[A-Za-z0-9_+\-]+)*$")

    def zone(self, zone_id: str) -> _ZoneData:
        z = self._zones.get(zone_id)
        if z is None and zone_id not in self._zones:
            z = _fixed_offset_zone(zone_id)
            if z is None and self._ZONE_ID_RE.match(zone_id):
                # the id grammar forbids '.' components, so the join below
                # cannot escape tzpath
                path = os.path.join(self._tzpath, *zone_id.split("/"))
                if os.path.isfile(path):
                    try:
                        z = _parse_tzif(path)
                    except (struct.error, ValueError, OSError):
                        z = None
            self._zones[zone_id] = z
        if z is None:
            raise ValueError(f"unsupported time zone: {zone_id!r}")
        return z

    def is_supported(self, zone_id: str) -> bool:
        try:
            self.zone(zone_id)
            return True
        except ValueError:
            return False

    def device_tables(self, zone_id: str, device=None):
        """``(utc_instants, tz_instants, offsets)`` of the zone as tensors
        on ``device`` (the DB's own device when None)."""
        dev = resolve_device(self._device if device is None else device)
        key = (zone_id, str(dev))
        t = self._tables.get(key)
        if t is None:
            z = self.zone(zone_id)
            t = tuple(torch.from_numpy(a).to(dev) for a in (
                z.utc_instants, z.tz_instants, z.offsets))
            self._tables[key] = t
        return t


_default_db: Optional[TimeZoneDB] = None


def default_db() -> TimeZoneDB:
    global _default_db
    if _default_db is None:
        _default_db = TimeZoneDB()
    return _default_db


def _convert(col: Column, zone_id: str, to_utc: bool,
             db: Optional[TimeZoneDB]):
    if col.dtype.kind is not T.Kind.TIMESTAMP:
        raise TypeError(f"expected TIMESTAMP, got {col.dtype!r}")
    utc, tz, offsets = (db or default_db()).device_tables(zone_id,
                                                          col.data.device)
    micros = col.data
    # duration_cast truncation toward zero (timezones.cu:74)
    neg = micros < 0
    seconds = torch.where(neg, -torch.div(-micros, 1000000,
                                          rounding_mode="floor"),
                          torch.div(micros, 1000000, rounding_mode="floor"))
    keys = tz if to_utc else utc
    idx = torch.searchsorted(keys, seconds, right=True) - 1
    offset = offsets[idx].to(torch.int64) * 1000000
    out = micros - offset if to_utc else micros + offset
    return Column(out, col.validity, col.dtype)


def convert_timestamp_to_utc(col: Column, zone_id: str,
                             db: Optional[TimeZoneDB] = None) -> Column:
    """Local wall-clock micros -> UTC micros (reference timezones.hpp:42)."""
    return _convert(col, zone_id, to_utc=True, db=db)


def convert_utc_to_timezone(col: Column, zone_id: str,
                            db: Optional[TimeZoneDB] = None) -> Column:
    """UTC micros -> local wall-clock micros (reference timezones.hpp:55)."""
    return _convert(col, zone_id, to_utc=False, db=db)
