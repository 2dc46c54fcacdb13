"""A minimal numpy Parquet writer: test tooling, not part of the package.

Machines without pyarrow (the GPU machine ``chip_smoke.py`` runs on) still
need Parquet files to drive the port's scan, so this writes them with
numpy alone (``chip_smoke.py`` loads it through ``tests_module``):

* flat columns of int32, int64, double and UTF-8 strings, each REQUIRED,
  or OPTIONAL with definition levels when it has a validity mask;
* data pages v1 of ``page_rows`` rows each, PLAIN, or RLE_DICTIONARY
  after a dictionary page, with a PLAIN fallback after a given number of
  rows of each row group (as pyarrow falls back once a dictionary passes
  its size limit);
* UNCOMPRESSED or SNAPPY pages (a SNAPPY stream of literals only, which
  every SNAPPY decoder reads);
* ``min_value``/``max_value`` and ``null_count`` statistics, with the
  footer's type-defined column order.

Index and definition-level runs are written bit-packed.  The thrift
compact encoder below writes only what the footer and page headers need.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

# parquet.thrift enums
INT32, INT64, DOUBLE, BYTE_ARRAY = 1, 2, 5, 6
REQUIRED, OPTIONAL = 0, 1
PLAIN, RLE, RLE_DICTIONARY = 0, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, DICTIONARY_PAGE = 0, 2
CT_UTF8 = 0

# thrift compact types
_I16, _I32, _I64, _BIN, _LIST, _STRUCT = 4, 5, 6, 8, 9, 12
_TRUE, _FALSE = 1, 2


# ---- thrift compact encoding ---------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _zz(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _value(t: int, v) -> bytes:
    if t in (_I16, _I32, _I64):
        return _varint(_zz(int(v)))
    if t == _BIN:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _varint(len(b)) + b
    if t == _STRUCT:
        return _struct(v)
    if t == _LIST:
        et, items = v
        head = (bytes([(len(items) << 4) | et]) if len(items) < 15
                else bytes([0xF0 | et]) + _varint(len(items)))
        return head + b"".join(_value(et, x) for x in items)
    raise ValueError(f"thrift type {t}")


def _struct(fields) -> bytes:
    """``[(field id, type, value), ...]`` (None values skipped) as a
    compact struct; a bool's type is ``_TRUE``/``_FALSE`` and no value."""
    out = bytearray()
    last = 0
    for fid, t, v in sorted(f for f in fields if f[2] is not None
                            or f[1] in (_TRUE, _FALSE)):
        delta = fid - last
        out += (bytes([(delta << 4) | t]) if 0 < delta <= 15
                else bytes([t]) + _varint(_zz(fid)))
        if t not in (_TRUE, _FALSE):
            out += _value(t, v)
        last = fid
    out.append(0)
    return bytes(out)


# ---- page bodies -----------------------------------------------------------

def snappy_literals(data: bytes) -> bytes:
    """A SNAPPY raw block holding ``data`` as literals only."""
    out = bytearray(_varint(len(data)))
    for at in range(0, len(data), 1 << 16):
        piece = data[at:at + (1 << 16)]
        n = len(piece) - 1
        if n < 60:
            out.append(n << 2)
        elif n < 256:
            out += bytes([60 << 2, n])
        else:
            out += bytes([61 << 2]) + struct.pack("<H", n)
        out += piece
    return bytes(out)


def bit_packed(values: np.ndarray, width: int) -> bytes:
    """The RLE/bit-packed hybrid of ``values`` as one bit-packed run."""
    n = values.shape[0]
    groups = -(-n // 8)
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    if width == 0:
        return _varint((groups << 1) | 1)
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) & 1)
    packed = np.packbits(bits.astype(np.uint8).reshape(-1),
                         bitorder="little")
    return _varint((groups << 1) | 1) + packed.tobytes()


def _plain(kind: int, values) -> bytes:
    if kind == BYTE_ARRAY:
        return b"".join(struct.pack("<I", len(b)) + b for b in values)
    return np.ascontiguousarray(values).tobytes()


def _stat_bytes(kind: int, v) -> bytes:
    if kind == BYTE_ARRAY:
        return v
    return np.asarray([v], {INT32: "<i4", INT64: "<i8",
                            DOUBLE: "<f8"}[kind]).tobytes()


# ---- the writer ------------------------------------------------------------

class _Col:
    def __init__(self, name, values, valid):
        self.name = name
        if isinstance(values, np.ndarray) and values.dtype != object:
            self.kind = {np.dtype(np.int32): INT32,
                         np.dtype(np.int64): INT64,
                         np.dtype(np.float64): DOUBLE}[values.dtype]
            self.values = values
        else:
            self.kind = BYTE_ARRAY
            self.values = np.array(
                [b"" if v is None else
                 (v.encode() if isinstance(v, str) else bytes(v))
                 for v in values], dtype=object)
        self.valid = None if valid is None else np.asarray(valid, bool)


def _page(kind: int, codec: int, body: bytes, header: list) -> bytes:
    data = snappy_literals(body) if codec == SNAPPY else body
    hdr = _struct([(1, _I32, kind), (2, _I32, len(body)),
                   (3, _I32, len(data))] + header)
    return hdr + data


def write_parquet(path: str, columns: Dict[str, tuple], row_group_rows: int,
                  page_rows: int = 1 << 16, codec: str = "snappy",
                  dictionary: Optional[Dict[str, Optional[int]]] = None
                  ) -> None:
    """Write ``columns`` (``{name: (values, validity or None)}``; values a
    numpy int32/int64/float64 array or a list of str/bytes) to ``path``.

    ``dictionary`` maps a column to None (dictionary-encode every page)
    or to a row count: each row group's first that many rows are
    dictionary-encoded and the rest fall back to PLAIN.  Other columns
    are PLAIN.  ``codec`` is ``'snappy'`` or ``'none'``."""
    codec_id = {"snappy": SNAPPY, "none": UNCOMPRESSED}[codec]
    dictionary = dictionary or {}
    cols = [_Col(n, *v) for n, v in columns.items()]
    n = len(cols[0].values)
    out = bytearray(b"PAR1")
    row_groups = []
    for lo in range(0, max(n, 1), row_group_rows):
        hi = min(n, lo + row_group_rows)
        chunks, rg_bytes = [], 0
        for c in cols:
            meta, at, raw_size = _chunk(out, c, lo, hi, page_rows,
                                        codec_id, c.name in dictionary,
                                        dictionary.get(c.name))
            chunks.append((meta, at))
            rg_bytes += raw_size
        start = chunks[0][1]
        row_groups.append([
            (1, _LIST, (_STRUCT, [m for m, _ in chunks])),
            (2, _I64, rg_bytes), (3, _I64, hi - lo), (5, _I64, start),
            (6, _I64, len(out) - start)])
    schema = [[(4, _BIN, "schema"), (5, _I32, len(cols))]]
    for c in cols:
        el = [(1, _I32, c.kind),
              (3, _I32, REQUIRED if c.valid is None else OPTIONAL),
              (4, _BIN, c.name)]
        if c.kind == BYTE_ARRAY:
            el += [(6, _I32, CT_UTF8), (10, _STRUCT, [(1, _STRUCT, [])])]
        schema.append(el)
    footer = _struct([
        (1, _I32, 1), (2, _LIST, (_STRUCT, schema)), (3, _I64, n),
        (4, _LIST, (_STRUCT, row_groups)),
        (6, _BIN, "tests/parquet_writer.py"),
        (7, _LIST, (_STRUCT, [[(1, _STRUCT, [])] for _ in cols]))])
    out += footer + struct.pack("<I", len(footer)) + b"PAR1"
    with open(path, "wb") as f:
        f.write(out)


def _dictionary(kind: int, head):
    """A dictionary's entries in first-appearance order, and the function
    that maps values to their indices."""
    if kind == BYTE_ARRAY:
        seen = {}
        for v in head:
            seen.setdefault(v, len(seen))
        return list(seen), lambda pv: np.array([seen[v] for v in pv],
                                               np.uint64)
    if head.dtype.kind == "i" and head.size:
        lo = int(head.min())
        span = int(head.max()) - lo + 1
        if span <= 1 << 22:  # a small domain: first appearances in O(n)
            first = np.full(span, head.size, np.int64)
            np.minimum.at(first, head - lo, np.arange(head.size))
            live = np.flatnonzero(first < head.size)
            live = live[np.argsort(first[live], kind="stable")]
            rank = np.zeros(span, np.uint64)
            rank[live] = np.arange(live.size, dtype=np.uint64)
            return (live + lo).astype(head.dtype), lambda pv: rank[pv - lo]
    uniq, first = np.unique(head, return_index=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(uniq.size, np.uint64)
    rank[order] = np.arange(uniq.size, dtype=np.uint64)
    return uniq[order], lambda pv: rank[np.searchsorted(uniq, pv)]


def _chunk(out: bytearray, c: _Col, lo: int, hi: int, page_rows: int,
           codec: int, use_dict: bool, dict_rows: Optional[int]):
    """Append one column chunk; returns its ColumnChunk struct, its start
    and its uncompressed size."""
    vals = c.values[lo:hi]
    valid = None if c.valid is None else c.valid[lo:hi]
    rows = hi - lo
    live = vals if valid is None else vals[valid]
    start = len(out)
    raw_size = 0
    dict_off = None
    encodings = {PLAIN, RLE}
    cut = rows if dict_rows is None else min(dict_rows, rows)
    if use_dict:
        # dictionary of the dictionary-encoded rows, in first-appearance
        # order (as pyarrow builds it)
        head = vals[:cut] if valid is None else vals[:cut][valid[:cut]]
        entries, index = _dictionary(c.kind, head)
        body = _plain(c.kind, entries)
        dict_off = len(out)
        out += _page(DICTIONARY_PAGE, codec, body,
                     [(7, _STRUCT, [(1, _I32, len(entries)),
                                    (2, _I32, PLAIN)])])
        raw_size += len(body)
        encodings.add(RLE_DICTIONARY)
        width = max(int(len(entries) - 1).bit_length(), 1)
    data_off = len(out)
    for a in range(0, max(rows, 1), page_rows):
        b = min(rows, a + page_rows)
        pv = vals[a:b]
        body = b""
        if valid is not None:
            levels = bit_packed(valid[a:b].astype(np.uint64), 1)
            body += struct.pack("<I", len(levels)) + levels
            pv = pv[valid[a:b]]
        if use_dict and a < cut:
            if b > cut:
                raise ValueError("a dictionary fallback must fall on a "
                                 "page boundary")
            idx = index(pv)
            body += bytes([width]) + bit_packed(idx, width)
            enc = RLE_DICTIONARY
        else:
            body += _plain(c.kind, pv)
            enc = PLAIN
        out += _page(DATA_PAGE, codec, body,
                     [(5, _STRUCT, [(1, _I32, b - a), (2, _I32, enc),
                                    (3, _I32, RLE), (4, _I32, RLE)])])
        raw_size += len(body)
    stats = [(3, _I64, 0 if valid is None else int((~valid).sum()))]
    if len(live):
        if c.kind == BYTE_ARRAY:
            lo_v, hi_v = min(live), max(live)
        else:
            lo_v, hi_v = live.min(), live.max()
        stats += [(5, _BIN, _stat_bytes(c.kind, hi_v)),
                  (6, _BIN, _stat_bytes(c.kind, lo_v))]
    meta = [(1, _I32, c.kind), (2, _LIST, (_I32, sorted(encodings))),
            (3, _LIST, (_BIN, [c.name])), (4, _I32, codec),
            (5, _I64, rows), (6, _I64, raw_size),
            (7, _I64, len(out) - start), (9, _I64, data_off),
            (11, _I64, dict_off), (12, _STRUCT, stats)]
    return [(2, _I64, start), (3, _STRUCT, meta)], start, raw_size
