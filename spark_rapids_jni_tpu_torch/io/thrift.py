"""Thrift compact-protocol reader for Parquet's footer and page headers.

The reference reads thrift through pyarrow; the card's machine has none,
so the port parses the few structs a scan needs itself: ``FileMetaData``
with its ``SchemaElement``, ``KeyValue`` metadata, ``RowGroup``,
``ColumnChunk`` / ``ColumnMetaData`` and ``Statistics``, and the
``PageHeader`` of data
pages v1 and v2 and of dictionary pages.  Each struct becomes a plain
Python object whose attributes are named as in ``parquet.thrift``; a field
the file does not set is None.  Fields this module does not name are read
and dropped (the footer library's generic ``Reader`` in
``native/parquet_footer.cpp`` keeps them, since it re-serializes; a scan
needs only these).  A truncated or malformed buffer raises
:class:`ThriftError` (a ``ValueError``).
"""

from __future__ import annotations

import struct as _struct
from typing import Tuple

T_STOP, T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64 = 0, 1, 2, 3, 4, 5, 6
T_DOUBLE, T_BINARY, T_LIST, T_SET, T_MAP, T_STRUCT = 7, 8, 9, 10, 11, 12
_MAX_DEPTH = 64


class ThriftError(ValueError):
    """A thrift buffer that is truncated or not compact protocol."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("thrift buffer truncated inside a varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ThriftError("thrift varint longer than 64 bits")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _value(buf: bytes, pos: int, t: int, in_container: bool, depth: int):
    if t in (T_TRUE, T_FALSE):
        if not in_container:  # a field's bool lives in its header nibble
            return t == T_TRUE, pos
        if pos >= len(buf):
            raise ThriftError("thrift buffer truncated inside a bool")
        return buf[pos] == 1, pos + 1
    if t == T_BYTE:
        if pos >= len(buf):
            raise ThriftError("thrift buffer truncated inside a byte")
        b = buf[pos]
        return b - 256 if b > 127 else b, pos + 1
    if t in (T_I16, T_I32, T_I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if t == T_DOUBLE:
        if pos + 8 > len(buf):
            raise ThriftError("thrift buffer truncated inside a double")
        return _struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t == T_BINARY:
        n, pos = _varint(buf, pos)
        if n > len(buf) - pos:
            raise ThriftError("thrift binary runs past the buffer")
        return bytes(buf[pos:pos + n]), pos + n
    if t in (T_LIST, T_SET):
        if pos >= len(buf):
            raise ThriftError("thrift buffer truncated inside a list")
        head = buf[pos]
        pos += 1
        size, et = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        # every element takes at least one byte
        if size > len(buf) - pos:
            raise ThriftError("thrift list size exceeds the buffer")
        out = []
        for _ in range(size):
            v, pos = _value(buf, pos, et, True, depth + 1)
            out.append(v)
        return out, pos
    if t == T_MAP:
        size, pos = _varint(buf, pos)
        if size > len(buf) - pos:
            raise ThriftError("thrift map size exceeds the buffer")
        out = {}
        if size:
            kv = buf[pos]
            pos += 1
            for _ in range(size):
                k, pos = _value(buf, pos, kv >> 4, True, depth + 1)
                v, pos = _value(buf, pos, kv & 0x0F, True, depth + 1)
                if isinstance(k, (dict, list)):
                    raise ThriftError("thrift map with a container key")
                out[k] = v
        return out, pos
    if t == T_STRUCT:
        return read_struct(buf, pos, depth + 1)
    raise ThriftError(f"unknown thrift compact type {t}")


def read_struct(buf: bytes, pos: int = 0, depth: int = 0
                ) -> Tuple[dict, int]:
    """One struct at ``buf[pos:]`` as ``{field id: value}`` and the
    position after its stop byte.  Structs nest as dicts, lists as lists,
    binaries as bytes."""
    if depth > _MAX_DEPTH:
        raise ThriftError("thrift structs nested too deep")
    out = {}
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("thrift buffer truncated inside a struct")
        head = buf[pos]
        pos += 1
        if head == T_STOP:
            return out, pos
        delta, t = head >> 4, head & 0x0F
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        last = fid
        out[fid], pos = _value(buf, pos, t, False, depth)


class Struct:
    """A thrift struct bound to names: ``FIELDS`` maps a field id to its
    attribute name and its kind: ``int``, ``bool``, ``bytes``, ``str``
    (UTF-8 bytes), a :class:`Struct` subclass, or a one-element list of
    one of these for a list.  A value of another kind is a malformed
    buffer and raises :class:`ThriftError`."""

    FIELDS: dict = {}

    def __init__(self, raw: dict):
        for fid, (name, kind) in self.FIELDS.items():
            v = raw.get(fid)
            setattr(self, name, None if v is None else _bind(kind, v, name))

    def __repr__(self):
        set_ = {n: getattr(self, n) for n, _ in self.FIELDS.values()
                if getattr(self, n) is not None}
        return f"{type(self).__name__}({set_})"


def _bind(kind, v, name: str):
    if isinstance(kind, list):
        if isinstance(v, list):
            return [_bind(kind[0], x, name) for x in v]
    elif isinstance(kind, type) and issubclass(kind, Struct):
        if isinstance(v, dict):
            return kind(v)
    elif kind is str:
        if isinstance(v, bytes):
            return v.decode("utf-8", "replace")
    elif kind is int:
        if isinstance(v, int) and not isinstance(v, bool):
            return v
    elif isinstance(v, kind):
        return v
    raise ThriftError(f"thrift field {name!r}: {type(v).__name__} where "
                      f"{getattr(kind, '__name__', kind)} belongs")


def _struct_type(name: str, fields: dict):
    return type(name, (Struct,), {"FIELDS": fields})


Statistics = _struct_type("Statistics", {
    1: ("max", bytes), 2: ("min", bytes), 3: ("null_count", int),
    5: ("max_value", bytes), 6: ("min_value", bytes)})
_Empty = _struct_type("Empty", {})
DecimalType = _struct_type("DecimalType", {1: ("scale", int),
                                           2: ("precision", int)})
TimeUnit = _struct_type("TimeUnit", {1: ("MILLIS", _Empty),
                                     2: ("MICROS", _Empty),
                                     3: ("NANOS", _Empty)})
TimestampType = _struct_type("TimestampType", {
    1: ("isAdjustedToUTC", bool), 2: ("unit", TimeUnit)})
IntType = _struct_type("IntType", {1: ("bitWidth", int),
                                   2: ("isSigned", bool)})
LogicalType = _struct_type("LogicalType", {
    1: ("STRING", _Empty), 2: ("MAP", _Empty), 3: ("LIST", _Empty),
    4: ("ENUM", _Empty), 5: ("DECIMAL", DecimalType), 6: ("DATE", _Empty),
    7: ("TIME", TimestampType), 8: ("TIMESTAMP", TimestampType),
    10: ("INTEGER", IntType), 11: ("UNKNOWN", _Empty), 12: ("JSON", _Empty),
    13: ("BSON", _Empty), 14: ("UUID", _Empty), 15: ("FLOAT16", _Empty)})
SchemaElement = _struct_type("SchemaElement", {
    1: ("type", int), 2: ("type_length", int), 3: ("repetition_type", int),
    4: ("name", str), 5: ("num_children", int), 6: ("converted_type", int),
    7: ("scale", int), 8: ("precision", int),
    10: ("logicalType", LogicalType)})
ColumnMetaData = _struct_type("ColumnMetaData", {
    1: ("type", int), 3: ("path_in_schema", [str]), 4: ("codec", int),
    5: ("num_values", int), 7: ("total_compressed_size", int),
    9: ("data_page_offset", int), 10: ("index_page_offset", int),
    11: ("dictionary_page_offset", int), 12: ("statistics", Statistics)})
ColumnChunk = _struct_type("ColumnChunk", {3: ("meta_data", ColumnMetaData)})
RowGroup = _struct_type("RowGroup", {
    1: ("columns", [ColumnChunk]), 3: ("num_rows", int)})
ColumnOrder = _struct_type("ColumnOrder", {1: ("TYPE_ORDER", _Empty)})
KeyValue = _struct_type("KeyValue", {1: ("key", str), 2: ("value", str)})
FileMetaData = _struct_type("FileMetaData", {
    1: ("version", int), 2: ("schema", [SchemaElement]),
    3: ("num_rows", int), 4: ("row_groups", [RowGroup]),
    5: ("key_value_metadata", [KeyValue]),
    7: ("column_orders", [ColumnOrder])})
DataPageHeader = _struct_type("DataPageHeader", {
    1: ("num_values", int), 2: ("encoding", int),
    3: ("definition_level_encoding", int),
    4: ("repetition_level_encoding", int), 5: ("statistics", Statistics)})
DictionaryPageHeader = _struct_type("DictionaryPageHeader", {
    1: ("num_values", int), 2: ("encoding", int), 3: ("is_sorted", bool)})
DataPageHeaderV2 = _struct_type("DataPageHeaderV2", {
    1: ("num_values", int), 2: ("num_nulls", int), 3: ("num_rows", int),
    4: ("encoding", int), 5: ("definition_levels_byte_length", int),
    6: ("repetition_levels_byte_length", int),
    7: ("is_compressed", bool), 8: ("statistics", Statistics)})
PageHeader = _struct_type("PageHeader", {
    1: ("type", int), 2: ("uncompressed_page_size", int),
    3: ("compressed_page_size", int), 4: ("crc", int),
    5: ("data_page_header", DataPageHeader),
    7: ("dictionary_page_header", DictionaryPageHeader),
    8: ("data_page_header_v2", DataPageHeaderV2)})


def file_metadata(buf: bytes) -> FileMetaData:
    """The footer's thrift bytes as a :class:`FileMetaData`."""
    raw, _ = read_struct(buf)
    return FileMetaData(raw)


def page_header(buf: bytes, pos: int) -> Tuple[PageHeader, int]:
    """The page header at ``buf[pos:]`` and the position of its body."""
    raw, end = read_struct(buf, pos)
    return PageHeader(raw), end
