"""A minimal numpy Parquet writer: test tooling, not part of the package.

Machines without pyarrow (the GPU machine ``chip_smoke.py`` runs on) still
need Parquet files to drive the port's scan, so this writes them with
numpy alone (``chip_smoke.py`` loads it through ``tests_module``):

* leaf columns of int32, int64, double, UTF-8 strings and BYTE_ARRAY
  decimals (:class:`Decimal`), each REQUIRED, or OPTIONAL with
  definition levels when it has a validity mask;
* OPTIONAL or REQUIRED struct columns (:class:`Struct`) and list columns
  (:class:`List`) around them, at any depth, with repetition and
  definition levels; a list is written in the 3-level ``list``/``element``
  form, the legacy 2-level form (a repeated ``array`` field under the
  LIST group) or as a bare repeated field;
* data pages v1 or v2 of ``page_rows`` rows each, PLAIN,
  DELTA_BINARY_PACKED (int32, int64: blocks of 128 values in four
  miniblocks, one bit width for every miniblock of a page),
  BYTE_STREAM_SPLIT (int32, int64, double), or RLE_DICTIONARY after a
  dictionary page, with a PLAIN fallback after a given number of rows of
  each row group (as pyarrow falls back once a dictionary passes its size
  limit);
* UNCOMPRESSED, SNAPPY (a stream of literals only, which every SNAPPY
  decoder reads), ZSTD (``ZSTD_compress`` at level 3 through ``libzstd``
  where the system has it, else frames of raw blocks) or LZ4 in the
  Hadoop framing (``LZ4_compress_default`` through ``liblz4`` where the
  system has it, else literal-only blocks) pages;
* ``min_value``/``max_value`` and ``null_count`` statistics of flat
  columns, with the footer's type-defined column order.

Index and level runs are written bit-packed.  The thrift compact encoder
below writes only what the footer and page headers need.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Dict, Optional

import numpy as np

# parquet.thrift enums
INT32, INT64, DOUBLE, BYTE_ARRAY = 1, 2, 5, 6
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
PLAIN, RLE, RLE_DICTIONARY = 0, 3, 8
DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT = 5, 9
UNCOMPRESSED, SNAPPY, LZ4, ZSTD = 0, 1, 5, 6
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
CT_UTF8, CT_LIST, CT_DECIMAL = 0, 3, 5
CODECS = {"none": UNCOMPRESSED, "snappy": SNAPPY, "zstd": ZSTD,
          "lz4_hadoop": LZ4}
ENCODINGS = {"plain": PLAIN, "delta": DELTA_BINARY_PACKED,
             "bss": BYTE_STREAM_SPLIT}

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


# ---- codecs ----------------------------------------------------------------

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


def _system_lib(name: str, soname: str):
    found = ctypes.util.find_library(name)
    try:
        return ctypes.CDLL(found or soname)
    except OSError:
        return None


_LIBS = {}


def _lib(name: str, soname: str):
    if name not in _LIBS:
        _LIBS[name] = _system_lib(name, soname)
    return _LIBS[name]


def zstd_frames(data: bytes, level: Optional[int] = 3) -> bytes:
    """``data`` as ZSTD: ``ZSTD_compress`` at ``level`` where the system
    has ``libzstd`` (and ``level`` is not None), else one frame of raw
    blocks of at most 128 KiB."""
    lib = _lib("zstd", "libzstd.so.1") if level is not None else None
    if lib is not None:
        sz = ctypes.c_size_t
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compress.restype = sz
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, sz, ctypes.c_char_p,
                                      sz, ctypes.c_int]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [sz]
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        got = lib.ZSTD_compress(out, cap, data, len(data), level)
        if lib.ZSTD_isError(got):
            raise RuntimeError("ZSTD_compress failed")
        return out.raw[:got]
    # magic, a frame header of no flags and a 128 KiB window, raw blocks
    out = bytearray(struct.pack("<I", 0xFD2FB528) + bytes([0x00, 0x38]))
    step = 1 << 17
    starts = list(range(0, len(data), step)) or [0]
    for i, at in enumerate(starts):
        piece = data[at:at + step]
        head = (len(piece) << 3) | (i == len(starts) - 1)
        out += struct.pack("<I", head)[:3] + piece
    return bytes(out)


def lz4_block(data: bytes) -> bytes:
    """``data`` as one LZ4 block: ``LZ4_compress_default`` where the system
    has ``liblz4``, else one sequence of literals."""
    lib = _lib("lz4", "liblz4.so.1")
    if lib is not None and data:
        lib.LZ4_compressBound.restype = ctypes.c_int
        lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_compress_default.argtypes = [ctypes.c_char_p,
                                             ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int]
        cap = lib.LZ4_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        got = lib.LZ4_compress_default(data, out, len(data), cap)
        if got <= 0:
            raise RuntimeError("LZ4_compress_default failed")
        return out.raw[:got]
    n = len(data)
    token = bytearray([min(n, 15) << 4])
    if n >= 15:
        rest = n - 15
        token += b"\xff" * (rest // 255) + bytes([rest % 255])
    return bytes(token) + data


def lz4_hadoop(data: bytes) -> bytes:
    """``data`` in the Hadoop LZ4 framing: frames of a big-endian
    decompressed size, a big-endian compressed size and one LZ4 block."""
    out = bytearray()
    step = 1 << 18
    for at in range(0, len(data), step):
        block = lz4_block(data[at:at + step])
        out += struct.pack(">II", len(data[at:at + step]), len(block)) + block
    return bytes(out)


def _compress(codec: int, body: bytes, zstd_level: Optional[int]) -> bytes:
    if codec == SNAPPY:
        return snappy_literals(body)
    if codec == ZSTD:
        return zstd_frames(body, zstd_level)
    if codec == LZ4:
        return lz4_hadoop(body)
    return body


# ---- page bodies -----------------------------------------------------------

def bit_packed(values: np.ndarray, width: int) -> bytes:
    """The RLE/bit-packed hybrid of ``values`` as one bit-packed run."""
    n = values.shape[0]
    groups = -(-n // 8)
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    if width == 0:
        return _varint((groups << 1) | 1)
    return _varint((groups << 1) | 1) + _pack_bits(v, width)


def _pack_bits(v: np.ndarray, width: int) -> bytes:
    """``v`` (uint64) at ``width`` bits each, LSB first."""
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) & 1)
    return np.packbits(bits.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


def delta_binary_packed(values: np.ndarray) -> bytes:
    """DELTA_BINARY_PACKED of int32 or int64 ``values``: blocks of 128
    deltas in four miniblocks of 32, each block its own minimum delta,
    every miniblock of the page one bit width.  Deltas wrap in the
    column's width, as parquet-cpp computes them."""
    bits = values.dtype.itemsize * 8
    u = values.view(np.uint32 if bits == 32 else np.uint64)
    signed = np.int32 if bits == 32 else np.int64
    n = values.shape[0]
    out = bytearray(_varint(128) + _varint(4) + _varint(n))
    out += _varint(_zz(int(values[0])) if n else 0)
    if n <= 1:
        return bytes(out)
    d = (u[1:] - u[:-1]).view(signed)
    nd = d.shape[0]
    blocks = -(-nd // 128)
    pad = np.zeros(blocks * 128, signed)
    pad[:nd] = d
    live = np.arange(blocks * 128) < nd
    big = np.iinfo(signed).max
    mins = np.where(live, pad, big).reshape(blocks, 128).min(1)
    adj = (pad.reshape(blocks, 128) - mins[:, None]).view(
        np.uint32 if bits == 32 else np.uint64).astype(np.uint64)
    adj[~live.reshape(blocks, 128)] = 0
    width = int(adj.max()).bit_length()
    packed = _pack_bits(adj.reshape(-1), width) if width else b""
    mini = 4 * width  # bytes of 32 values
    for b in range(blocks):
        used = min(128, nd - 128 * b)
        minis = -(-used // 32)
        out += _varint(_zz(int(mins[b]))) + bytes([width] * minis
                                                  + [0] * (4 - minis))
        out += packed[b * 4 * mini:b * 4 * mini + minis * mini]
    return bytes(out)


def byte_stream_split(values: np.ndarray) -> bytes:
    w = values.dtype.itemsize
    return np.ascontiguousarray(
        values.view(np.uint8).reshape(-1, w).T).tobytes()


def _plain(kind: int, values) -> bytes:
    if kind == BYTE_ARRAY:
        return b"".join(struct.pack("<I", len(b)) + b for b in values)
    return np.ascontiguousarray(values).tobytes()


def _stat_bytes(kind: int, v) -> bytes:
    if kind == BYTE_ARRAY:
        return v
    return np.asarray([v], {INT32: "<i4", INT64: "<i8",
                            DOUBLE: "<f8"}[kind]).tobytes()


def _be_decimal(v: int) -> bytes:
    """The shortest big-endian two's complement of ``v``."""
    n = max(1, (v.bit_length() + 8) // 8) if v >= 0 else \
        max(1, ((~v).bit_length() + 8) // 8)
    return v.to_bytes(n, "big", signed=True)


# ---- columns ---------------------------------------------------------------

class Decimal:
    """A decimal leaf stored as BYTE_ARRAY: ``unscaled`` Python ints."""

    def __init__(self, unscaled, precision: int, scale: int, valid=None):
        self.values = [0 if v is None else int(v) for v in unscaled]
        self.precision, self.scale = precision, scale
        self.valid = None if valid is None else np.asarray(valid, bool)


class Struct:
    """A struct column: ``fields`` maps names to column specs (a ``(values,
    validity)`` pair, :class:`Decimal`, :class:`Struct` or :class:`List`);
    ``valid`` None makes it REQUIRED."""

    def __init__(self, fields: dict, valid=None):
        self.fields = fields
        self.valid = None if valid is None else np.asarray(valid, bool)


class List:
    """A list column: ``offsets`` (int, rows + 1) into ``child`` (a column
    spec over the flattened elements); ``valid`` None makes it REQUIRED.
    ``layout`` is ``"3-level"``, ``"2-level"`` (a repeated ``array``
    field; its element must be REQUIRED) or ``"repeated"`` (a bare
    repeated field: the list REQUIRED, its element REQUIRED)."""

    def __init__(self, offsets, child, valid=None, layout="3-level"):
        self.offsets = np.asarray(offsets, np.int64)
        self.child = child
        self.valid = None if valid is None else np.asarray(valid, bool)
        self.layout = layout


class _Leaf:
    def __init__(self, name, path, values, valid):
        self.name, self.path = name, path
        if isinstance(values, Decimal):
            self.kind = BYTE_ARRAY
            self.decimal = (values.precision, values.scale)
            self.values = np.array([_be_decimal(v) for v in values.values],
                                   dtype=object)
            valid = values.valid
        elif isinstance(values, np.ndarray) and values.dtype != object:
            self.decimal = None
            self.kind = {np.dtype(np.int32): INT32,
                         np.dtype(np.int64): INT64,
                         np.dtype(np.float64): DOUBLE}[values.dtype]
            self.values = values
        else:
            self.decimal = None
            self.kind = BYTE_ARRAY
            self.values = np.array(
                [b"" if v is None else
                 (v.encode() if isinstance(v, str) else bytes(v))
                 for v in values], dtype=object)
        self.valid = None if valid is None else np.asarray(valid, bool)
        self.max_def = self.max_rep = 0
        self.levels = None  # (reps, defs, value slots) of a nested leaf

    @property
    def dotted(self) -> str:
        return ".".join(self.path)


def _schema(name, spec, path, leaves, def_, rep, repetition=None):
    """Schema elements of column ``spec`` (depth first); appends its leaves
    with their maximum levels."""
    if isinstance(spec, Struct):
        rt = REQUIRED if spec.valid is None else OPTIONAL
        rt = rt if repetition is None else repetition
        def_ += rt != REQUIRED
        rep += rt == REPEATED
        out = [[(3, _I32, rt), (4, _BIN, name),
                (5, _I32, len(spec.fields))]]
        for f, child in spec.fields.items():
            out += _schema(f, child, path + [f], leaves, def_, rep)
        return out
    if isinstance(spec, List):
        if spec.layout == "repeated":
            return _schema(name, spec.child, path, leaves, def_, rep,
                           REPEATED)
        rt = REQUIRED if spec.valid is None else OPTIONAL
        def_ += rt == OPTIONAL
        out = [[(3, _I32, rt), (4, _BIN, name), (5, _I32, 1),
                (6, _I32, CT_LIST), (10, _STRUCT, [(3, _STRUCT, [])])]]
        if spec.layout == "2-level":
            return out + _schema("array", spec.child, path + ["array"],
                                 leaves, def_, rep, REPEATED)
        out.append([(3, _I32, REPEATED), (4, _BIN, "list"), (5, _I32, 1)])
        return out + _schema("element", spec.child,
                             path + ["list", "element"], leaves, def_ + 1,
                             rep + 1)
    values, valid = (spec, spec.valid) if isinstance(spec, Decimal) \
        else spec
    if repetition == REPEATED and valid is not None:
        raise ValueError(f"the repeated field {name!r} cannot be null")
    leaf = _Leaf(name, path, values, valid)
    rt = REQUIRED if leaf.valid is None else OPTIONAL
    rt = rt if repetition is None else repetition
    leaf.max_def = def_ + (rt != REQUIRED)
    leaf.max_rep = rep + (rt == REPEATED)
    leaves.append(leaf)
    el = [(1, _I32, leaf.kind), (3, _I32, rt), (4, _BIN, name)]
    if leaf.decimal is not None:
        p, s = leaf.decimal
        el += [(6, _I32, CT_DECIMAL), (7, _I32, s), (8, _I32, p),
               (10, _STRUCT, [(5, _STRUCT, [(1, _I32, s), (2, _I32, p)])])]
    elif leaf.kind == BYTE_ARRAY:
        el += [(6, _I32, CT_UTF8), (10, _STRUCT, [(1, _STRUCT, [])])]
    return [el]


def _present(valid, defs, slots):
    """Entries whose slot is present under ``valid`` go one definition
    level up; the others end there (slot -1)."""
    if valid is None:
        return defs, slots
    live = slots >= 0
    ok = live.copy()
    ok[live] = np.asarray(valid, bool)[slots[live]]
    return defs + ok, np.where(ok, slots, -1)


def _shred(spec, reps, defs, slots, rep, leaves):
    """Dremel shredding: the entries ``(reps, defs, slots)`` reaching
    ``spec`` at repetition level ``rep`` (``slots`` -1 where a null or
    empty level above ended the entry) -> each leaf's levels and value
    slots, in ``leaves`` order."""
    if isinstance(spec, List):
        if spec.layout != "repeated":
            defs, slots = _present(spec.valid, defs, slots)
        # each live entry becomes its list's elements (an empty list and
        # an ended entry stay one entry, one level below the element)
        live = slots >= 0
        lens = np.zeros(slots.shape[0], np.int64)
        starts = np.zeros(slots.shape[0], np.int64)
        starts[live] = spec.offsets[slots[live]]
        lens[live] = spec.offsets[slots[live] + 1] - starts[live]
        each = np.maximum(lens, 1)
        idx = np.repeat(np.arange(slots.shape[0]), each)
        k = np.arange(idx.shape[0]) - np.repeat(np.cumsum(each) - each, each)
        has = np.repeat(lens > 0, each)
        return _shred(spec.child,
                      np.where(k == 0, reps[idx], rep + 1).astype(np.int32),
                      defs[idx] + has, np.where(has, starts[idx] + k, -1),
                      rep + 1, leaves)
    if isinstance(spec, Struct):
        defs, slots = _present(spec.valid, defs, slots)
        for child in spec.fields.values():
            _shred(child, reps, defs, slots, rep, leaves)
        return
    leaf = leaves.pop(0)
    valid = spec.valid if isinstance(spec, Decimal) else spec[1]
    defs, slots = _present(valid, defs, slots)
    leaf.levels = (reps, defs.astype(np.int32), slots)


def _page(kind: int, codec: int, body: bytes, header: list,
          zstd_level) -> bytes:
    data = _compress(codec, body, zstd_level)
    hdr = _struct([(1, _I32, kind), (2, _I32, len(body)),
                   (3, _I32, len(data))] + header)
    return hdr + data


def write_parquet(path: str, columns: Dict[str, object],
                  row_group_rows: int, page_rows: int = 1 << 16,
                  codec: str = "snappy",
                  dictionary: Optional[Dict[str, Optional[int]]] = None,
                  encoding: Optional[Dict[str, str]] = None,
                  page_version: int = 1,
                  zstd_level: Optional[int] = 3) -> None:
    """Write ``columns`` to ``path``: ``{name: spec}``, a spec a ``(values,
    validity or None)`` pair (values a numpy int32/int64/float64 array or
    a list of str/bytes), a :class:`Decimal`, a :class:`Struct` or a
    :class:`List`.

    ``dictionary`` maps a flat column to None (dictionary-encode every
    page) or to a row count: each row group's first that many rows are
    dictionary-encoded and the rest fall back to PLAIN.  ``encoding`` maps
    a leaf's dotted path (a flat column's name) to ``"delta"`` or
    ``"bss"``.  Other leaves are PLAIN.  ``codec`` is one of
    :data:`CODECS`; ``page_version`` 1 or 2."""
    codec_id = CODECS[codec]
    dictionary = dictionary or {}
    encoding = encoding or {}
    leaves = []
    schema_cols = []
    n = None
    for name, spec in columns.items():
        before = len(leaves)
        schema_cols += _schema(name, spec, [name], leaves, 0, 0)
        rows = _rows(spec)
        n = rows if n is None else n
        if rows != n:
            raise ValueError(f"column {name!r} has {rows} rows, not {n}")
        mine = leaves[before:]
        if _nested(spec):
            _shred(spec, np.zeros(n, np.int32), np.zeros(n, np.int64),
                   np.arange(n), 0, list(mine))
    out = bytearray(b"PAR1")
    row_groups = []
    for lo in range(0, max(n, 1), row_group_rows):
        hi = min(n, lo + row_group_rows)
        chunks, rg_bytes = [], 0
        for leaf in leaves:
            meta, at, raw_size = _chunk(
                out, leaf, lo, hi, page_rows, codec_id,
                leaf.dotted in dictionary, dictionary.get(leaf.dotted),
                ENCODINGS[encoding.get(leaf.dotted, "plain")], page_version,
                zstd_level)
            chunks.append((meta, at))
            rg_bytes += raw_size
        start = chunks[0][1]
        row_groups.append([
            (1, _LIST, (_STRUCT, [m for m, _ in chunks])),
            (2, _I64, rg_bytes), (3, _I64, hi - lo), (5, _I64, start),
            (6, _I64, len(out) - start)])
    schema = [[(4, _BIN, "schema"), (5, _I32, len(columns))]] + schema_cols
    footer = _struct([
        (1, _I32, 1), (2, _LIST, (_STRUCT, schema)), (3, _I64, n),
        (4, _LIST, (_STRUCT, row_groups)),
        (6, _BIN, "tests/parquet_writer.py"),
        (7, _LIST, (_STRUCT, [[(1, _STRUCT, [])] for _ in leaves]))])
    out += footer + struct.pack("<I", len(footer)) + b"PAR1"
    with open(path, "wb") as f:
        f.write(out)


def _nested(spec) -> bool:
    return isinstance(spec, (Struct, List))


def _rows(spec) -> int:
    if isinstance(spec, Struct):
        return _rows(next(iter(spec.fields.values())))
    if isinstance(spec, List):
        return spec.offsets.shape[0] - 1
    if isinstance(spec, Decimal):
        return len(spec.values)
    return len(spec[0])


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


def _encode_values(kind: int, enc: int, pv) -> bytes:
    if enc == DELTA_BINARY_PACKED:
        if kind not in (INT32, INT64):
            raise ValueError("DELTA_BINARY_PACKED takes int32 and int64")
        return delta_binary_packed(pv)
    if enc == BYTE_STREAM_SPLIT:
        if kind == BYTE_ARRAY:
            raise ValueError("BYTE_STREAM_SPLIT takes fixed-width values")
        return byte_stream_split(np.ascontiguousarray(pv))
    return _plain(kind, pv)


def _chunk(out: bytearray, c: _Leaf, lo: int, hi: int, page_rows: int,
           codec: int, use_dict: bool, dict_rows: Optional[int], enc: int,
           page_version: int, zstd_level):
    """Append one column chunk; returns its ColumnChunk struct, its start
    and its uncompressed size."""
    rows = hi - lo
    if c.levels is not None:
        return _nested_chunk(out, c, lo, hi, page_rows, codec, enc,
                             page_version, zstd_level)
    vals = c.values[lo:hi]
    valid = None if c.valid is None else c.valid[lo:hi]
    live = vals if valid is None else vals[valid]
    start = len(out)
    raw_size = 0
    dict_off = None
    encodings = {PLAIN, RLE, enc}
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
                                    (2, _I32, PLAIN)])], zstd_level)
        raw_size += len(body)
        encodings.add(RLE_DICTIONARY)
        width = max(int(len(entries) - 1).bit_length(), 1)
    data_off = len(out)
    for a in range(0, max(rows, 1), page_rows):
        b = min(rows, a + page_rows)
        pv = vals[a:b]
        levels = b""
        if valid is not None:
            levels = bit_packed(valid[a:b].astype(np.uint64), 1)
            pv = pv[valid[a:b]]
        if use_dict and a < cut:
            if b > cut:
                raise ValueError("a dictionary fallback must fall on a "
                                 "page boundary")
            values = bytes([width]) + bit_packed(index(pv), width)
            page_enc = RLE_DICTIONARY
        else:
            values = _encode_values(c.kind, enc, pv)
            page_enc = enc
        nulls = 0 if valid is None else int((~valid[a:b]).sum())
        page, size = _data_page(codec, page_version, b"", levels, values,
                                b - a, b - a, nulls, page_enc, zstd_level)
        out += page
        raw_size += size
    stats = [(3, _I64, 0 if valid is None else int((~valid).sum()))]
    if len(live) and c.decimal is None:
        if c.kind == BYTE_ARRAY:
            lo_v, hi_v = min(live), max(live)
        else:
            lo_v, hi_v = live.min(), live.max()
        stats += [(5, _BIN, _stat_bytes(c.kind, hi_v)),
                  (6, _BIN, _stat_bytes(c.kind, lo_v))]
    return _chunk_meta(c, encodings, codec, rows, raw_size, out, start,
                       data_off, dict_off, stats)


def _chunk_meta(c, encodings, codec, values, raw_size, out, start, data_off,
                dict_off, stats):
    meta = [(1, _I32, c.kind), (2, _LIST, (_I32, sorted(encodings))),
            (3, _LIST, (_BIN, list(c.path))), (4, _I32, codec),
            (5, _I64, values), (6, _I64, raw_size),
            (7, _I64, len(out) - start), (9, _I64, data_off),
            (11, _I64, dict_off), (12, _STRUCT, stats)]
    return [(2, _I64, start), (3, _STRUCT, meta)], start, raw_size


def _data_page(codec, version, reps: bytes, defs: bytes, values: bytes,
               count: int, rows: int, nulls: int, enc: int, zstd_level):
    """One data page (v1: length-prefixed levels, then the values, all
    compressed; v2: raw levels, then the compressed values) and its
    uncompressed size."""
    if version == 1:
        body = b"".join(struct.pack("<I", len(x)) + x
                        for x in (reps, defs) if x) + values
        return _page(DATA_PAGE, codec, body,
                     [(5, _STRUCT, [(1, _I32, count), (2, _I32, enc),
                                    (3, _I32, RLE), (4, _I32, RLE)])],
                     zstd_level), len(body)
    data = _compress(codec, values, zstd_level)
    size = len(reps) + len(defs) + len(values)
    hdr = _struct([(1, _I32, DATA_PAGE_V2), (2, _I32, size),
                   (3, _I32, len(reps) + len(defs) + len(data)),
                   (8, _STRUCT, [(1, _I32, count), (2, _I32, nulls),
                                 (3, _I32, rows), (4, _I32, enc),
                                 (5, _I32, len(defs)), (6, _I32, len(reps)),
                                 (7, _TRUE if codec != UNCOMPRESSED
                                  else _FALSE, None)])])
    return hdr + reps + defs + data, size


def _nested_chunk(out, c: _Leaf, lo, hi, page_rows, codec, enc, version,
                  zstd_level):
    """One nested leaf's chunk: its levels between rows ``lo`` and ``hi``,
    in pages that start at a row."""
    reps, defs, slots = c.levels
    row_starts = np.flatnonzero(reps == 0)
    first = row_starts[lo]
    end = row_starts[hi] if hi < row_starts.shape[0] else reps.shape[0]
    start = data_off = len(out)
    raw_size = 0
    for a in range(lo, max(hi, lo + 1), page_rows):
        b = min(hi, a + page_rows)
        ea = row_starts[a] if a < row_starts.shape[0] else reps.shape[0]
        eb = row_starts[b] if b < row_starts.shape[0] else reps.shape[0]
        r, d, s = reps[ea:eb], defs[ea:eb], slots[ea:eb]
        present = d == c.max_def
        pv = c.values[s[present]]
        rl = bit_packed(r.astype(np.uint64), c.max_rep.bit_length()) \
            if c.max_rep else b""
        dl = bit_packed(d.astype(np.uint64), c.max_def.bit_length()) \
            if c.max_def else b""
        values = _encode_values(c.kind, enc, pv)
        page, size = _data_page(codec, version, rl, dl, values, eb - ea,
                                b - a, int((~present).sum()), enc,
                                zstd_level)
        out += page
        raw_size += size
    return _chunk_meta(c, {PLAIN, RLE, enc}, codec, int(end - first),
                       raw_size, out, start, data_off, None, [])
