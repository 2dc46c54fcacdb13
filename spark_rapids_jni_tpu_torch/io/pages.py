"""Decode Parquet column chunks on the host into ``batch_from_numpy``'s
forms.

The reference decodes pages with pyarrow (``io/parquet.py``) and carries
the Arrow arrays into columns (``columnar/arrow.py:65-177``).  The card's
machine has no pyarrow, so the port decodes pages itself: the loops numpy
cannot vectorize run in ``native/parquet_pages.cpp`` (g++, built at first
use; SNAPPY, LZ4, the RLE/bit-packed hybrid, DELTA_BINARY_PACKED, the
BYTE_ARRAY splitters, BYTE_STREAM_SPLIT, PLAIN BOOLEAN unpacking, the
level assembly of nested columns and BYTE_ARRAY decimals), everything
else is numpy.  The result is the host form
:func:`~..columnar.column.batch_from_numpy` takes, so the columns upload
once and nothing else builds them.

* Pages: ``PageHeader`` by :mod:`.thrift`; data pages v1 and v2 and
  dictionary pages.  v1 bodies carry repetition levels, then definition
  levels, each RLE with a 4-byte length (or the deprecated BIT_PACKED);
  v2 levels are never compressed, their sizes are in the header, and
  ``is_compressed`` applies to the values only.  Levels decode at any
  bit width.
* Codecs: UNCOMPRESSED, SNAPPY and LZ4_RAW (native), LZ4 (the Hadoop
  framing first, then one raw block, as parquet-cpp tries them), GZIP
  (``zlib``), ZSTD and BROTLI through the system's ``libzstd`` and
  ``libbrotlidec`` (found with ``ctypes.util.find_library`` and bound
  with ctypes; a missing library raises an ``OSError`` naming it, and
  nothing falls back).  LZO raises ``NotImplementedError``, as pyarrow
  has no LZO either.
* Encodings: PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE (booleans),
  DELTA_BINARY_PACKED (INT32, INT64), DELTA_LENGTH_BYTE_ARRAY,
  DELTA_BYTE_ARRAY (BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY) and
  BYTE_STREAM_SPLIT (FLOAT, DOUBLE, INT32, INT64, FIXED_LEN_BYTE_ARRAY).
  A chunk may fall back from its dictionary to any of the others
  mid-chunk (pyarrow does once the dictionary passes 1 MiB).
* Values as the reference's ``from_arrow`` holds them: null slots of
  fixed-width data are zero; strings pad into the ``[n, max_len]`` char
  matrix (``max_len`` the longest valid row rounded up to a multiple of
  8) with length 0 under nulls; decimals are little-endian ``uint64[n,
  2]`` limbs sign-extended from INT32, INT64 or big-endian
  FIXED_LEN_BYTE_ARRAY or BYTE_ARRAY; timestamps are micros (MILLIS
  times 1000; NANOS and INT96 truncated toward zero, as Arrow's unsafe
  cast to ``us``).
* A string column read as a dictionary is the dictionary form
  of :mod:`..columnar.encoded`, built from the dictionary pages and the
  indices without decoding rows.  Its dictionary is the one pyarrow's
  ``read_dictionary`` read followed by ``combine_chunks`` gives: every
  dictionary page's entries and every non-dictionary value (PLAIN or
  DELTA), in order of first appearance across the row groups read.
* A nested leaf keeps its pages' repetition and definition levels;
  :func:`assemble_levels` turns them into the offsets and validity of
  every level above it.
* A page that runs past its buffer, or holds an encoding its physical
  type cannot have, raises ``ValueError``.

``STATS`` accumulates the seconds spent reading footers, decoding (file
reads and decompression included), decompressing and uploading (all but
decompression counted in :mod:`.parquet`), the pages, the file bytes read
and the row-group decodes (one per row group per read, so
a morsel stream's replays show as decodes per row group).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import itertools
import os
import threading
import time
import zlib
from typing import List, Optional

import numpy as np

from ..columnar import types as T
from . import metadata as M
from . import thrift

LIB_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native", "parquet_pages.cpp")

DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, RLE_DICTIONARY = 0, 2, 3, 4, 8
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY = 5, 6, 7
BYTE_STREAM_SPLIT = 9
UNCOMPRESSED, SNAPPY, GZIP, LZO, BROTLI, LZ4, ZSTD, LZ4_RAW = range(8)
_JULIAN_EPOCH_DAY = 2440588
_NANOS_PER_DAY = 86_400_000_000_000
_NP_DTYPES = {T.Kind.BOOLEAN: np.bool_, T.Kind.INT8: np.int8,
              T.Kind.INT16: np.int16, T.Kind.INT32: np.int32,
              T.Kind.INT64: np.int64, T.Kind.FLOAT32: np.float32,
              T.Kind.FLOAT64: np.float64, T.Kind.DATE: np.int32,
              T.Kind.TIMESTAMP: np.int64}
_PLAIN_DTYPES = {M.INT32: "<i4", M.INT64: "<i8", M.FLOAT: "<f4",
                 M.DOUBLE: "<f8"}
_ERRORS = {-1: "runs past its buffer", -2: "overflows its output",
           -3: "copies from before its start", -4: "holds a value past "
           "its dictionary (or its level bound)", -5: "has a bad width or "
           "count", -6: "holds levels that do not nest"}
# (library, its soname) of the codecs the system's libraries decode
CODEC_LIBRARIES = {ZSTD: ("zstd", "libzstd.so.1"),
                   BROTLI: ("brotlidec", "libbrotlidec.so.1")}
# host-form tokens of the dictionary columns a read builds: each read's
# column gets a fresh one, as the reference's dictionary_from_arrays mints
_TOKENS = itertools.count(1 << 48)

STATS = {"footer_s": 0.0, "decompress_s": 0.0, "decode_s": 0.0,
         "upload_s": 0.0, "pages": 0, "file_bytes": 0,
         "row_group_decodes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("_s") else 0


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> ctypes.CDLL:
    """Build (once per source hash) and bind the page library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops import _build

        lib = _build.load_host(LIB_SOURCE)
        p, n = ctypes.c_void_p, ctypes.c_long
        i = ctypes.c_int
        for fn, args in (("pqp_snappy_length", [p, n]),
                         ("pqp_snappy_decompress", [p, n, p, n]),
                         ("pqp_rle_decode", [p, n, i, p, n, n]),
                         ("pqp_byte_array_split", [p, n, n, p, p, n]),
                         ("pqp_unpack_bools", [p, n, p, n]),
                         ("pqp_delta_count", [p, n]),
                         ("pqp_delta_binary_packed", [p, n, p, n]),
                         ("pqp_delta_byte_array", [p, p, n, p, n, p, p, n]),
                         ("pqp_byte_stream_split", [p, n, i, n, p]),
                         ("pqp_lz4_raw", [p, n, p, n]),
                         ("pqp_lz4_hadoop", [p, n, p, n]),
                         ("pqp_assemble_levels", [p, p, n, i, p, p, p, p,
                                                  p, p, p]),
                         ("pqp_be_decimal_limbs", [p, p, n, n, p])):
            g = getattr(lib, fn)
            g.restype = n
            g.argtypes = args
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _ok(rc: int, what: str) -> int:
    if rc < 0:
        raise ValueError(f"corrupt Parquet page: {what} "
                         f"{_ERRORS.get(rc, f'failed ({rc})')}")
    return rc


# ---- the native loops --------------------------------------------------

def snappy_decompress(src: np.ndarray) -> np.ndarray:
    """One SNAPPY raw block."""
    lib = _load_lib()
    size = _ok(lib.pqp_snappy_length(_ptr(src), src.size),
               "the snappy length")
    out = np.empty(size, np.uint8)
    _ok(lib.pqp_snappy_decompress(_ptr(src), src.size, _ptr(out), size),
        "the snappy block")
    return out


def rle_decode(src: np.ndarray, bit_width: int, count: int,
               bound: int = 0):
    """``count`` values of the RLE/bit-packed hybrid (each below
    ``bound`` when it is positive) and the bytes they took."""
    out = np.empty(count, np.int32)
    used = _ok(_load_lib().pqp_rle_decode(_ptr(src), src.size, bit_width,
                                          _ptr(out), count, bound),
               "the RLE/bit-packed run")
    return out, used


def split_byte_array(src: np.ndarray, count: int):
    """``count`` PLAIN BYTE_ARRAY values: ``(offsets int64[count + 1],
    data uint8)`` and the bytes they took."""
    offsets = np.empty(count + 1, np.int64)
    data = np.empty(max(src.size - 4 * count, 0), np.uint8)
    used = _ok(_load_lib().pqp_byte_array_split(
        _ptr(src), src.size, count, _ptr(offsets), _ptr(data), data.size),
        "the BYTE_ARRAY values")
    return offsets, data[:offsets[-1]], used


def unpack_bools(src: np.ndarray, count: int):
    """``count`` PLAIN BOOLEAN values and the bytes they took."""
    out = np.empty(count, np.uint8)
    used = _ok(_load_lib().pqp_unpack_bools(_ptr(src), src.size,
                                            _ptr(out), count),
               "the BOOLEAN values")
    return out.view(np.bool_), used


def delta_binary_packed(src: np.ndarray, count: int):
    """``count`` DELTA_BINARY_PACKED values as int64 (an INT32 column
    keeps their low 32 bits) and the bytes the header's values take."""
    lib = _load_lib()
    total = _ok(lib.pqp_delta_count(_ptr(src), src.size),
                "the DELTA_BINARY_PACKED header")
    if total < count:
        raise ValueError(f"corrupt Parquet page: DELTA_BINARY_PACKED holds "
                         f"{total} values, the page needs {count}")
    out = np.empty(count, np.int64)
    used = _ok(lib.pqp_delta_binary_packed(_ptr(src), src.size, _ptr(out),
                                           count),
               "the DELTA_BINARY_PACKED values")
    return out, used


def _lengths(src: np.ndarray, count: int, what: str):
    lens, used = delta_binary_packed(src, count)
    lens = lens.astype(np.int32).astype(np.int64)
    if lens.size and int(lens.min()) < 0:
        raise ValueError(f"corrupt Parquet page: a negative {what}")
    return lens, used


def delta_length_byte_array(src: np.ndarray, count: int):
    """``count`` DELTA_LENGTH_BYTE_ARRAY values: ``(offsets int64[count +
    1], data uint8)`` and the bytes they took."""
    lens, used = _lengths(src, count, "DELTA_LENGTH_BYTE_ARRAY length")
    offsets = np.zeros(count + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    end = used + int(offsets[-1])
    if end > src.size:
        raise ValueError("corrupt Parquet page: DELTA_LENGTH_BYTE_ARRAY "
                         "values run past their buffer")
    return offsets, src[used:end], end


def delta_byte_array(src: np.ndarray, count: int):
    """``count`` DELTA_BYTE_ARRAY values (prefix lengths, then suffixes as
    DELTA_LENGTH_BYTE_ARRAY): ``(offsets, data)`` and the bytes taken."""
    prefix, used = _lengths(src, count, "DELTA_BYTE_ARRAY prefix length")
    rest = src[used:]
    slens, sused = _lengths(rest, count, "DELTA_BYTE_ARRAY suffix length")
    suffixes = rest[sused:]
    size = int(prefix.sum()) + int(slens.sum())
    offsets = np.empty(count + 1, np.int64)
    data = np.empty(size, np.uint8)
    _ok(_load_lib().pqp_delta_byte_array(
        _ptr(prefix), _ptr(slens), count, _ptr(suffixes), suffixes.size,
        _ptr(offsets), _ptr(data), size), "the DELTA_BYTE_ARRAY values")
    return offsets, data, used + sused + int(slens.sum())


def byte_stream_split(src: np.ndarray, width: int, count: int) -> np.ndarray:
    """``count`` BYTE_STREAM_SPLIT values of ``width`` bytes, as
    ``uint8[count, width]``."""
    out = np.empty((count, width), np.uint8)
    _ok(_load_lib().pqp_byte_stream_split(_ptr(src), src.size, width, count,
                                          _ptr(out)),
        "the BYTE_STREAM_SPLIT streams")
    return out


def assemble_levels(reps: Optional[np.ndarray], defs: Optional[np.ndarray],
                    n: int, path: list):
    """One leaf's ``n`` levels (int32; None for all zero) along ``path``
    (``(kind, space, def_level, elem_def)`` per node, top first; kind 0
    leaf, 1 struct, 2 list) -> each node's ``(present bool[slots],
    offsets int32[slots + 1] or None)``."""
    k = len(path)
    cols = np.array(path, np.int32).reshape(k, 4)
    kind, space, def_level, elem_def = (np.ascontiguousarray(cols[:, i])
                                        for i in range(4))
    present = [np.empty(n, np.uint8) for _ in range(k)]
    offs = [np.empty(n + 1, np.int32) if kind[j] == 2 else None
            for j in range(k)]
    pp = (ctypes.c_void_p * k)(*[v.ctypes.data for v in present])
    op = (ctypes.c_void_p * k)(*[None if o is None else o.ctypes.data
                                 for o in offs])
    counts = np.zeros(k, np.int64)
    null = ctypes.c_void_p(None)
    _ok(_load_lib().pqp_assemble_levels(
        null if reps is None else _ptr(reps),
        null if defs is None else _ptr(defs), n, k, _ptr(kind), _ptr(space),
        _ptr(def_level), _ptr(elem_def), pp, op, _ptr(counts)),
        "the repetition and definition levels")
    return [(present[j][:counts[j]].view(np.bool_),
             None if offs[j] is None else offs[j][:counts[j] + 1])
            for j in range(k)]


def be_decimal_limbs(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Big-endian two's-complement BYTE_ARRAY decimals -> ``uint64[n, 2]``
    limbs."""
    n = offsets.shape[0] - 1
    out = np.empty((n, 2), np.uint64)
    _ok(_load_lib().pqp_be_decimal_limbs(_ptr(offsets), _ptr(data),
                                         data.size, n, _ptr(out)),
        "the BYTE_ARRAY decimal")
    return out


_codec_lock = threading.Lock()
_codec_libs = {}


def codec_library(codec: int) -> ctypes.CDLL:
    """The system library of a ZSTD or BROTLI codec, found with
    ``ctypes.util.find_library`` (or by its soname) and bound once;
    ``OSError`` naming it when the system has none."""
    with _codec_lock:
        if codec in _codec_libs:
            return _codec_libs[codec]
        name, soname = CODEC_LIBRARIES[codec]
        found = ctypes.util.find_library(name)
        try:
            lib = ctypes.CDLL(found or soname)
        except OSError as e:
            raise OSError(f"the Parquet codec {M.CODEC_NAMES[codec]} needs "
                          f"lib{name} (find_library({name!r}) found "
                          f"{found!r}; loading {soname} failed: {e})"
                          ) from None
        sz, p = ctypes.c_size_t, ctypes.c_void_p
        if codec == ZSTD:
            lib.ZSTD_decompress.restype = sz
            lib.ZSTD_decompress.argtypes = [p, sz, p, sz]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [sz]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [sz]
        else:
            lib.BrotliDecoderDecompress.restype = ctypes.c_int
            lib.BrotliDecoderDecompress.argtypes = [
                sz, p, ctypes.POINTER(sz), p]
        _codec_libs[codec] = lib
        return lib


def codec_libraries() -> dict:
    """What ``ctypes.util.find_library`` finds for each codec library."""
    return {name: ctypes.util.find_library(name)
            for name, _ in CODEC_LIBRARIES.values()}


def _zstd(body: np.ndarray, size: int) -> np.ndarray:
    lib = codec_library(ZSTD)
    out = np.empty(size, np.uint8)
    got = lib.ZSTD_decompress(_ptr(out), size, _ptr(body), body.size)
    if lib.ZSTD_isError(got):
        raise ValueError(f"corrupt Parquet page: zstd: "
                         f"{lib.ZSTD_getErrorName(got).decode()}")
    return out[:got]


def _brotli(body: np.ndarray, size: int) -> np.ndarray:
    lib = codec_library(BROTLI)
    out = np.empty(size, np.uint8)
    got = ctypes.c_size_t(size)
    if lib.BrotliDecoderDecompress(body.size, _ptr(body), ctypes.byref(got),
                                   _ptr(out)) != 1:
        raise ValueError("corrupt Parquet page: the brotli stream does not "
                         f"decode to the {size} bytes its header says")
    return out[:got.value]


def _lz4(codec: int, body: np.ndarray, size: int) -> np.ndarray:
    lib = _load_lib()
    out = np.empty(size, np.uint8)
    got = -1
    if codec == LZ4:
        got = lib.pqp_lz4_hadoop(_ptr(body), body.size, _ptr(out), size)
    if got < 0:
        got = _ok(lib.pqp_lz4_raw(_ptr(body), body.size, _ptr(out), size),
                  "the LZ4 block")
    return out[:got]


def decompress(codec: int, body: np.ndarray, size: int) -> np.ndarray:
    """A page body (or a v2 page's values) in the clear."""
    t0 = time.perf_counter()
    if size < 0:
        raise ValueError(f"corrupt Parquet page: {size} bytes in the clear")
    if codec == UNCOMPRESSED:
        out = body
    elif codec == SNAPPY:
        out = snappy_decompress(body)
    elif codec == GZIP:
        try:
            out = np.frombuffer(zlib.decompress(body.tobytes(), 47),
                                np.uint8)
        except zlib.error as e:
            raise ValueError(f"corrupt Parquet page: gzip: {e}") from None
    elif codec in (LZ4, LZ4_RAW):
        out = _lz4(codec, body, size)
    elif codec == ZSTD:
        out = _zstd(body, size)
    elif codec == BROTLI:
        out = _brotli(body, size)
    elif codec == LZO:
        raise NotImplementedError("Parquet codec LZO is not supported (nor "
                                  "is it in pyarrow)")
    else:
        raise ValueError(f"corrupt Parquet chunk: codec {codec}")
    if out.size != size:
        raise ValueError(f"corrupt Parquet page: {out.size} bytes in the "
                         f"clear, the header says {size}")
    STATS["decompress_s"] += time.perf_counter() - t0
    return out


# ---- values -------------------------------------------------------------

def _trunc_div(v: np.ndarray, d: int) -> np.ndarray:
    """Integer division toward zero (Arrow's cast), not numpy's floor."""
    q = v // d
    return q + ((v < 0) & (q * d != v))


def _decimal_limbs(phys: int, vals) -> np.ndarray:
    """Sign-extended little-endian 128-bit limbs ``uint64[n, 2]``."""
    if phys == M.BYTE_ARRAY:
        return be_decimal_limbs(*vals)
    n = vals.shape[0]
    if phys in (M.INT32, M.INT64):
        lo = vals.astype(np.int64)
        out = np.empty((n, 2), np.int64)
        out[:, 0] = lo
        out[:, 1] = lo >> 63
        return out.view(np.uint64)
    width = vals.shape[1]
    if width > 16:
        raise NotImplementedError(f"a {width}-byte decimal does not fit "
                                  "128 bits")
    be = np.empty((n, 16), np.uint8)
    neg = (vals[:, 0] >= 0x80) if width else np.zeros(n, bool)
    be[:, :16 - width] = np.where(neg, 0xFF, 0)[:, None]
    be[:, 16 - width:] = vals
    return np.ascontiguousarray(be[:, ::-1]).view(np.uint64)


def _convert(leaf: M.Leaf, st: T.SparkType, vals: np.ndarray) -> np.ndarray:
    """Physical values -> the port's host values of type ``st``."""
    phys = leaf.physical
    if st.kind is T.Kind.DECIMAL:
        return _decimal_limbs(phys, vals)
    if st.kind is T.Kind.TIMESTAMP:
        if phys == M.INT96:
            nanos = np.ascontiguousarray(vals[:, :8]).view("<i8")[:, 0]
            days = np.ascontiguousarray(vals[:, 8:]).view("<i4")[:, 0]
            with np.errstate(over="ignore"):
                ns = ((days.astype(np.int64) - _JULIAN_EPOCH_DAY)
                      * _NANOS_PER_DAY + nanos)
            return _trunc_div(ns, 1000)
        unit = leaf.logical()[1][0]
        v = vals.astype(np.int64)
        if unit == "MILLIS":
            with np.errstate(over="ignore"):
                return v * 1000
        if unit == "NANOS":
            return _trunc_div(v, 1000)
        return v
    return vals.astype(_NP_DTYPES[st.kind], copy=False)


def _plain(leaf: M.Leaf, buf: np.ndarray, count: int):
    """``count`` PLAIN values: an array, or ``(offsets, data)`` for
    BYTE_ARRAY."""
    phys = leaf.physical
    if phys == M.BOOLEAN:
        return unpack_bools(buf, count)[0]
    if phys == M.BYTE_ARRAY:
        offsets, data, _ = split_byte_array(buf, count)
        return offsets, data
    width = {M.INT96: 12, M.FLBA: leaf.type_length or 0}.get(phys)
    if width is None:
        dt = np.dtype(_PLAIN_DTYPES[phys])
        if buf.size < count * dt.itemsize:
            raise ValueError("corrupt Parquet page: PLAIN values run past "
                             "their buffer")
        return buf[:count * dt.itemsize].view(dt)
    if buf.size < count * width:
        raise ValueError("corrupt Parquet page: PLAIN values run past "
                         "their buffer")
    return buf[:count * width].reshape(count, width)


def _encoding_error(enc: int, leaf: M.Leaf) -> ValueError:
    return ValueError(f"corrupt Parquet page: encoding "
                      f"{M.ENCODING_NAMES.get(enc, enc)} is not valid for "
                      f"{M.PHYSICAL_NAMES[leaf.physical]} (column "
                      f"{leaf.dotted!r})")


class _Page:
    """One data page's rows: validity (a flat column's) or repetition
    and definition levels (a nested leaf's), and its non-null values,
    either ``plain`` (an array, or ``(offsets, data)`` for byte arrays)
    or dictionary ``indices`` into ``dictionary``."""

    __slots__ = ("valid", "reps", "defs", "plain", "indices", "dictionary")

    def __init__(self, valid, plain=None, indices=None, dictionary=None):
        self.valid, self.plain = valid, plain
        self.indices, self.dictionary = indices, dictionary
        self.reps = self.defs = None


def _levels(buf: np.ndarray, count: int, max_level: int,
            encoding: int = RLE) -> np.ndarray:
    """``count`` levels of at most ``max_level`` as int32: the RLE /
    bit-packed hybrid, or the deprecated BIT_PACKED (MSB first)."""
    width = max_level.bit_length()
    if encoding == RLE:
        levels, _ = rle_decode(buf, width, count, bound=max_level + 1)
        return levels
    if encoding != BIT_PACKED:
        raise ValueError(f"corrupt Parquet page: level encoding "
                         f"{M.ENCODING_NAMES.get(encoding, encoding)}")
    need = (count * width + 7) // 8
    if need > buf.size:
        raise ValueError("corrupt Parquet page: BIT_PACKED levels run past "
                         "their buffer")
    bits = np.unpackbits(buf[:need])[:count * width].reshape(count, width)
    levels = (bits.astype(np.int32)
              << np.arange(width - 1, -1, -1, dtype=np.int32)).sum(1)
    if count and int(levels.max()) > max_level:
        raise ValueError("corrupt Parquet page: a level past its maximum")
    return levels.astype(np.int32)


def _prefixed(buf: np.ndarray, what: str):
    """A v1 page's 4-byte-length-prefixed run and what follows it."""
    if buf.size < 4:
        raise ValueError(f"corrupt Parquet page: {what} without their "
                         "length")
    n = int(buf[:4].view("<u4")[0])
    if n > buf.size - 4:
        raise ValueError(f"corrupt Parquet page: {what} run past their "
                         "buffer")
    return buf[4:4 + n], buf[4 + n:]


def _v1_levels(buf: np.ndarray, count: int, max_level: int, encoding,
               what: str):
    """A v1 page's levels (RLE behind a 4-byte length, or the deprecated
    BIT_PACKED) and the bytes after them."""
    if encoding == BIT_PACKED:
        return (_levels(buf, count, max_level, BIT_PACKED),
                buf[(count * max_level.bit_length() + 7) // 8:])
    run, rest = _prefixed(buf, what)
    return _levels(run, count, max_level, encoding), rest


def _values(leaf: M.Leaf, enc: int, buf: np.ndarray, count: int,
            dictionary) -> _Page:
    phys = leaf.physical
    if enc == PLAIN:
        return _Page(None, plain=_plain(leaf, buf, count))
    if enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise ValueError(f"corrupt Parquet chunk {leaf.dotted!r}: a "
                             "dictionary-encoded page before any "
                             "dictionary page")
        if buf.size < 1:
            raise ValueError("corrupt Parquet page: no index bit width")
        size = (dictionary[0].size - 1 if isinstance(dictionary, tuple)
                else dictionary.shape[0])
        idx, _ = rle_decode(buf[1:], int(buf[0]), count, bound=max(size, 1))
        if count and size == 0:
            raise ValueError("corrupt Parquet page: indices into an empty "
                             "dictionary")
        return _Page(None, indices=idx, dictionary=dictionary)
    if enc == RLE and phys == M.BOOLEAN:
        run, _ = _prefixed(buf, "RLE booleans")
        vals, _ = rle_decode(run, 1, count, bound=2)
        return _Page(None, plain=vals.astype(np.bool_))
    if enc == DELTA_BINARY_PACKED and phys in (M.INT32, M.INT64):
        vals, _ = delta_binary_packed(buf, count)
        return _Page(None, plain=vals.astype(np.int32) if phys == M.INT32
                     else vals)
    if enc == DELTA_LENGTH_BYTE_ARRAY and phys == M.BYTE_ARRAY:
        offsets, data, _ = delta_length_byte_array(buf, count)
        return _Page(None, plain=(offsets, data))
    if enc == DELTA_BYTE_ARRAY and phys in (M.BYTE_ARRAY, M.FLBA):
        offsets, data, _ = delta_byte_array(buf, count)
        if phys == M.BYTE_ARRAY:
            return _Page(None, plain=(offsets, data))
        width = leaf.type_length or 0
        if data.size != count * width or (np.diff(offsets) != width).any():
            raise ValueError("corrupt Parquet page: DELTA_BYTE_ARRAY values "
                             f"of other than {width} bytes")
        return _Page(None, plain=data.reshape(count, width))
    if enc == BYTE_STREAM_SPLIT and phys in (M.FLOAT, M.DOUBLE, M.INT32,
                                             M.INT64, M.FLBA):
        width = (leaf.type_length or 0 if phys == M.FLBA
                 else np.dtype(_PLAIN_DTYPES[phys]).itemsize)
        vals = byte_stream_split(buf, width, count)
        return _Page(None, plain=vals if phys == M.FLBA else
                     vals.reshape(-1).view(_PLAIN_DTYPES[phys]))
    raise _encoding_error(enc, leaf)


def read_chunk_pages(raw: bytes, col: M.ColumnChunkMetaData,
                     leaf: M.Leaf, levels: bool = False) -> List[_Page]:
    """Every data page of one column chunk's bytes, decoded.  With
    ``levels`` (a nested leaf) each page keeps its repetition and
    definition levels; otherwise its validity."""
    arr = np.frombuffer(raw, np.uint8)
    codec = col.compression
    want = col.num_values or 0
    pos = seen = 0
    dictionary = None
    pages = []
    while seen < want:
        if pos >= len(raw):
            raise ValueError(f"corrupt Parquet chunk {leaf.dotted!r}: it "
                             f"ends after {seen} of {want} values")
        hdr, body = thrift.page_header(raw, pos)
        size = hdr.compressed_page_size
        if size is None or size < 0 or body + size > len(raw):
            raise ValueError(f"corrupt Parquet chunk {leaf.dotted!r}: a "
                             "page runs past the chunk")
        data = arr[body:body + size]
        pos = body + size
        STATS["pages"] += 1
        usize = hdr.uncompressed_page_size or 0
        if hdr.type == DICTIONARY_PAGE:
            dh = hdr.dictionary_page_header
            if dh is None or dh.encoding not in (PLAIN, PLAIN_DICTIONARY):
                raise _encoding_error(getattr(dh, "encoding", -1), leaf)
            dictionary = _plain(leaf, decompress(codec, data, usize),
                                dh.num_values or 0)
            if isinstance(dictionary, np.ndarray):
                dictionary = np.array(dictionary)  # own its memory
            continue
        if hdr.type in (DATA_PAGE, DATA_PAGE_V2):
            dp = (hdr.data_page_header if hdr.type == DATA_PAGE
                  else hdr.data_page_header_v2)
            if dp is None:
                raise ValueError("corrupt Parquet page: a data page "
                                 "without its header")
            count = dp.num_values or 0
        reps = defs = None
        if hdr.type == DATA_PAGE:
            buf = decompress(codec, data, usize)
            if leaf.max_rep:
                reps, buf = _v1_levels(buf, count, leaf.max_rep,
                                       dp.repetition_level_encoding,
                                       "repetition levels")
            if leaf.max_def:
                defs, buf = _v1_levels(buf, count, leaf.max_def,
                                       dp.definition_level_encoding,
                                       "definition levels")
            enc = dp.encoding
        elif hdr.type == DATA_PAGE_V2:
            rl = dp.repetition_levels_byte_length or 0
            dl = dp.definition_levels_byte_length or 0
            if rl < 0 or dl < 0 or rl + dl > data.size:
                raise ValueError("corrupt Parquet page: v2 levels run past "
                                 "the page")
            if leaf.max_rep:
                reps = _levels(data[:rl], count, leaf.max_rep)
            if leaf.max_def:
                defs = _levels(data[rl:rl + dl], count, leaf.max_def)
            buf = data[rl + dl:]
            if dp.is_compressed is not False:
                buf = decompress(codec, buf, usize - rl - dl)
            enc = dp.encoding
        else:
            continue  # index pages carry no rows
        if defs is None:
            nn = count
        else:
            nn = int(np.count_nonzero(defs == leaf.max_def))
        page = _values(leaf, enc, buf, nn, dictionary)
        if levels:
            page.reps, page.defs = reps, defs
        elif defs is not None:
            page.valid = defs.astype(np.bool_)
        pages.append(page)
        seen += count
    return pages


def levels_of(pages: List[_Page]):
    """A nested leaf's pages' repetition and definition levels, each
    concatenated (None where the leaf has none), and their count."""
    out = []
    for attr in ("reps", "defs"):
        parts = [getattr(p, attr) for p in pages]
        out.append(None if not parts or parts[0] is None
                   else np.concatenate(parts))
    n = sum(_page_levels(p) for p in pages)
    return out[0], out[1], n


def _page_levels(p: _Page) -> int:
    if p.defs is not None:
        return p.defs.shape[0]
    if p.reps is not None:
        return p.reps.shape[0]
    return _page_values(p)


# ---- chunks -> host columns ------------------------------------------------

def _page_rows(p: _Page) -> int:
    return p.valid.shape[0] if p.valid is not None else _page_values(p)


def _validity(pages: List[_Page], n: int) -> np.ndarray:
    if all(p.valid is None for p in pages):
        return np.ones(n, np.bool_)
    return np.concatenate([np.ones(_page_rows(p), np.bool_)
                           if p.valid is None else p.valid for p in pages])


def _page_values(p: _Page) -> int:
    if p.indices is not None:
        return p.indices.shape[0]
    return (p.plain[0].shape[0] - 1 if isinstance(p.plain, tuple)
            else p.plain.shape[0])


def fixed_values(leaf: M.Leaf, st: T.SparkType, pages: List[_Page],
                 valid: np.ndarray) -> np.ndarray:
    """A fixed-width or decimal chunk's values, zero under nulls."""
    if st.kind is T.Kind.DECIMAL:
        dtype, tail = np.uint64, (2,)
    else:
        dtype, tail = _NP_DTYPES[st.kind], ()
    vals = np.empty((sum(_page_values(p) for p in pages),) + tail, dtype)
    conv = {}
    at = 0
    for p in pages:
        k = _page_values(p)
        if p.indices is not None:
            key = id(p.dictionary)
            if key not in conv:
                conv[key] = _convert(leaf, st, p.dictionary)
            # the indices were bounded by the dictionary when decoded
            np.take(conv[key], p.indices, axis=0, out=vals[at:at + k],
                    mode="clip")
        else:
            vals[at:at + k] = _convert(leaf, st, p.plain)
        at += k
    if vals.shape[0] == valid.shape[0]:
        return vals
    out = np.zeros((valid.shape[0],) + tail, dtype)
    out[valid] = vals
    return out


class StringChunks:
    """String values of several chunks, kept as (offset, length) into
    one flat byte buffer until the char matrix is built."""

    def __init__(self):
        self.flats, self.starts, self.lens = [], [], []
        self.base = 0

    def _add_flat(self, data: np.ndarray) -> int:
        at = self.base
        self.flats.append(data)
        self.base += data.size
        return at

    def add(self, pages: List[_Page]) -> None:
        seen = {}
        for p in pages:
            if p.indices is not None:
                key = id(p.dictionary)
                if key not in seen:
                    offs, data = p.dictionary
                    seen[key] = (self._add_flat(data) + offs[:-1],
                                 np.diff(offs))
                at, ln = seen[key]
                self.starts.append(at[p.indices])
                self.lens.append(ln[p.indices])
            else:
                offs, data = p.plain
                self.starts.append(self._add_flat(data) + offs[:-1])
                self.lens.append(np.diff(offs))

    def matrix(self, valid: np.ndarray):
        """``(chars uint8[n, max_len], lengths int32[n])`` as the
        reference's ``_string_array_to_column`` pads them."""
        n = valid.shape[0]
        flat = (np.concatenate(self.flats) if self.flats
                else np.zeros(0, np.uint8))
        starts = (np.concatenate(self.starts) if self.starts
                  else np.zeros(0, np.int64))
        lens = (np.concatenate(self.lens).astype(np.int32) if self.lens
                else np.zeros(0, np.int32))
        lengths = np.zeros(n, np.int32)
        lengths[valid] = lens
        max_len = int(lengths.max()) if n else 0
        max_len = max(1, -(-max(max_len, 1) // 8) * 8)
        chars = np.zeros((n, max_len), np.uint8)
        if lens.size and flat.size:
            rows = np.flatnonzero(valid)
            row_idx = np.repeat(rows, lens)
            within = (np.arange(row_idx.size)
                      - np.repeat(np.cumsum(lens) - lens, lens))
            chars[row_idx, within] = flat[np.repeat(starts, lens) + within]
        return chars, lengths


class StringDictionary:
    """Codes and one dictionary for a string column's chunks, as pyarrow's
    ``read_dictionary`` read then ``combine_chunks`` unify them: entries
    in order of first appearance over every dictionary page's entries and
    every PLAIN-fallback value."""

    def __init__(self):
        self.memo = {}
        self.codes = []

    def _insert(self, offs: np.ndarray, data: np.ndarray) -> np.ndarray:
        b = data.tobytes()
        memo = self.memo
        out = np.empty(offs.size - 1, np.int64)
        for i in range(offs.size - 1):
            out[i] = memo.setdefault(b[offs[i]:offs[i + 1]], len(memo))
        return out

    def add(self, pages: List[_Page]) -> None:
        remap = {}
        for p in pages:
            if p.indices is not None:
                key = id(p.dictionary)
                if key not in remap:
                    remap[key] = self._insert(*p.dictionary)
                self.codes.append(remap[key][p.indices])
            else:
                self.codes.append(self._insert(*p.plain))

    def host_form(self, valid: np.ndarray):
        """``batch_from_numpy``'s dictionary form, or None when the
        dictionary is empty (the reference then decodes)."""
        if not self.memo:
            return None
        codes = np.zeros(valid.shape[0], np.uint32)
        if self.codes:
            codes[valid] = np.concatenate(self.codes)
        entries = list(self.memo)
        lens = np.fromiter((len(e) for e in entries), np.int64,
                           len(entries))
        offs = np.concatenate([[0], np.cumsum(lens)])
        sc = StringChunks()
        sc.flats.append(np.frombuffer(b"".join(entries), np.uint8))
        sc.starts.append(offs[:-1])
        sc.lens.append(lens)
        ones = np.ones(len(entries), np.bool_)
        return {"encoding": "dictionary", "codes": codes, "canon": None,
                "dictionary": (sc.matrix(ones), ones, "string"),
                "token": next(_TOKENS)}


def empty_host_column(st: T.SparkType):
    """A zero-row column of type ``st`` in host form."""
    if st.kind is T.Kind.LIST:
        data = (np.zeros(1, np.int32), empty_host_column(st.children[0]))
    elif st.kind is T.Kind.STRUCT:
        data = {f: empty_host_column(c)
                for f, c in zip(st.field_names, st.children)}
    elif st.kind is T.Kind.STRING:
        data = (np.zeros((0, 8), np.uint8), np.zeros(0, np.int32))
    elif st.kind is T.Kind.DECIMAL:
        data = np.zeros((0, 2), np.uint64)
    else:
        data = np.zeros(0, _NP_DTYPES[st.kind])
    return data, np.zeros(0, np.bool_), st
