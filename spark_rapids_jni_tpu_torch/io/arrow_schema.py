"""The footer's ``ARROW:schema`` value, decoded without pyarrow.

pyarrow stores the Arrow schema a file was written from under the footer's
``ARROW:schema`` key and, on read, lays it over the schema it infers from
the Parquet types (parquet-cpp's ``ApplyOriginalMetadata``): a timestamp
the file marks UTC-adjusted gets its original time zone back, an ``int64``
written from a ``duration`` reads as a duration again, a string written
from a dictionary array reads as a dictionary, a list written from a
``fixed_size_list`` reads as one.  The reference sees those restored types;
the port reads the same key here so its types agree.

The value is base64 text holding one Arrow IPC message: an optional
``0xFFFFFFFF`` continuation marker, an int32 length, then a flatbuffer
``Message`` whose header is a ``Schema``.  :func:`decode` walks the
flatbuffer (``Message`` -> ``Schema`` -> ``Field``: name, nullable, the type
union's id and table, children, dictionary) with every offset checked, and
returns :class:`ArrowField` trees.  A malformed value raises ``ValueError``.
"""

from __future__ import annotations

import base64
import binascii
import struct
from typing import List, Optional

KEY = "ARROW:schema"

# Schema.fbs ``Type`` union ids
TYPE_NAMES = {
    0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary",
    5: "Utf8", 6: "Bool", 7: "Decimal", 8: "Date", 9: "Time",
    10: "Timestamp", 11: "Interval", 12: "List", 13: "Struct", 14: "Union",
    15: "FixedSizeBinary", 16: "FixedSizeList", 17: "Map", 18: "Duration",
    19: "LargeBinary", 20: "LargeUtf8", 21: "LargeList",
    22: "RunEndEncoded", 23: "BinaryView", 24: "Utf8View", 25: "ListView",
    26: "LargeListView"}
_SCHEMA_HEADER = 1  # MessageHeader union: Schema
_UNITS = ("s", "ms", "us", "ns")


class ArrowField:
    """One field of the Arrow schema: ``name``, ``nullable``, ``type``
    (a :data:`TYPE_NAMES` value), ``tz`` and ``unit`` (Timestamp,
    Duration), ``dictionary`` (the field was written from a dictionary
    array) and ``children``."""

    def __init__(self, name: str, nullable: bool, type_: str,
                 children: List["ArrowField"], dictionary: bool,
                 tz: str = "", unit: str = ""):
        self.name, self.nullable, self.type = name, nullable, type_
        self.children, self.dictionary = children, dictionary
        self.tz, self.unit = tz, unit


class _Flat:
    """Bounds-checked reads of one flatbuffer."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def _unpack(self, fmt: str, pos: int):
        if pos < 0 or pos + struct.calcsize(fmt) > len(self.buf):
            raise ValueError("corrupt ARROW:schema: a read past its "
                             "flatbuffer")
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def deref(self, pos: int) -> int:
        """The position a uoffset at ``pos`` points to."""
        return pos + self._unpack("<I", pos)

    def field(self, table: int, slot: int) -> Optional[int]:
        """The position of field ``slot`` of the table at ``table``, or
        None where the vtable leaves it out."""
        vtable = table - self._unpack("<i", table)
        size = self._unpack("<H", vtable)
        at = 4 + 2 * slot
        if at + 2 > size:
            return None
        off = self._unpack("<H", vtable + at)
        return table + off if off else None

    def scalar(self, table: int, slot: int, fmt: str, default):
        pos = self.field(table, slot)
        return default if pos is None else self._unpack(fmt, pos)

    def table(self, table: int, slot: int) -> Optional[int]:
        pos = self.field(table, slot)
        return None if pos is None else self.deref(pos)

    def string(self, table: int, slot: int) -> str:
        pos = self.table(table, slot)
        if pos is None:
            return ""
        n = self._unpack("<I", pos)
        if pos + 4 + n > len(self.buf):
            raise ValueError("corrupt ARROW:schema: a string runs past its "
                             "flatbuffer")
        return self.buf[pos + 4:pos + 4 + n].decode("utf-8", "replace")

    def tables(self, table: int, slot: int) -> List[int]:
        pos = self.table(table, slot)
        if pos is None:
            return []
        n = self._unpack("<I", pos)
        if pos + 4 + 4 * n > len(self.buf):
            raise ValueError("corrupt ARROW:schema: a vector runs past its "
                             "flatbuffer")
        return [self.deref(pos + 4 + 4 * i) for i in range(n)]


def _field(fb: _Flat, t: int, depth: int) -> ArrowField:
    if depth > 64:
        raise ValueError("corrupt ARROW:schema: fields nested too deep")
    type_id = fb.scalar(t, 2, "<B", 0)
    type_ = TYPE_NAMES.get(type_id, f"type {type_id}")
    tz = unit = ""
    body = fb.table(t, 3)
    if body is not None and type_ in ("Timestamp", "Duration"):
        # Timestamp: unit (default SECOND), timezone; Duration: unit
        # (default MILLISECOND)
        u = fb.scalar(body, 0, "<h", 0 if type_ == "Timestamp" else 1)
        unit = _UNITS[u] if 0 <= u < 4 else f"unit {u}"
        if type_ == "Timestamp":
            tz = fb.string(body, 1)
    return ArrowField(
        name=fb.string(t, 0), nullable=bool(fb.scalar(t, 1, "<B", 0)),
        type_=type_, dictionary=fb.table(t, 4) is not None,
        children=[_field(fb, c, depth + 1) for c in fb.tables(t, 5)],
        tz=tz, unit=unit)


def decode(value) -> List[ArrowField]:
    """The top-level fields of an ``ARROW:schema`` value (base64 text)."""
    try:
        raw = base64.b64decode(value, validate=False)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"corrupt ARROW:schema: {e}") from None
    pos = 0
    if raw[:4] == b"\xff\xff\xff\xff":
        pos = 4
    if len(raw) < pos + 4:
        raise ValueError("corrupt ARROW:schema: no message length")
    n = struct.unpack_from("<i", raw, pos)[0]
    pos += 4
    if n < 0 or pos + n > len(raw):
        raise ValueError("corrupt ARROW:schema: the message runs past the "
                         "value")
    fb = _Flat(raw[pos:pos + n])
    message = fb.deref(0)
    if fb.scalar(message, 1, "<B", 0) != _SCHEMA_HEADER:
        raise ValueError("corrupt ARROW:schema: the message is not a "
                         "schema")
    schema = fb.table(message, 2)
    if schema is None:
        raise ValueError("corrupt ARROW:schema: the message has no header")
    return [_field(fb, f, 0) for f in fb.tables(schema, 1)]
