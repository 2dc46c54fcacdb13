"""Parquet footer parse / filter / rewrite (host facade).

Counterpart of ``spark_rapids_jni_tpu/io/parquet_footer.py``.  Mirrors the
reference's Java surface (``ParquetFooter.java:140-241``: ``readAndFilter``
with a depth-first flattened schema request using tags {0=value,
1=struct, 2=list, 3=map}, then ``getNumRows`` / ``getNumColumns`` /
``serializeThriftFile``) over the port's own copy of the native engine,
``native/parquet_footer.cpp`` (role of ``NativeParquetJni.cpp:109-670``),
built with ``g++`` at first use into ``_kernels_build/``
(:func:`..ops._build.load_host`); a failed build raises with the
compiler's output.

The schema request here is a friendlier nested dict::

    {"a": None,                  # leaf column
     "b": {"x": None},           # struct, keeping only field x
     "l": [None],                # list of leaves (one-element list spec)
     "m": (None, {"y": None})}   # map: (key spec, value spec)

which flattens to the same depth-first (names, num_children, tags) wire
triple the Java side builds.
"""

from __future__ import annotations

import ctypes
import os
import struct as _struct
import threading
from typing import Optional, Sequence, Union

LIB_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native", "parquet_footer.cpp")

TAG_VALUE, TAG_STRUCT, TAG_LIST, TAG_MAP = 0, 1, 2, 3

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> ctypes.CDLL:
    """Build (once per source hash) and bind the footer library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops import _build

        lib = _build.load_host(LIB_SOURCE)
        lib.pqf_read_and_filter.restype = ctypes.c_void_p
        lib.pqf_read_and_filter.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.pqf_error.restype = ctypes.c_char_p
        lib.pqf_error.argtypes = [ctypes.c_void_p]
        lib.pqf_free.argtypes = [ctypes.c_void_p]
        for fn in ("pqf_num_rows", "pqf_num_columns", "pqf_num_row_groups"):
            g = getattr(lib, fn)
            g.restype = ctypes.c_long
            g.argtypes = [ctypes.c_void_p]
        lib.pqf_serialize.restype = ctypes.c_long
        lib.pqf_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_long]
        _lib = lib
        return lib


def _flatten_schema(spec) -> tuple:
    """Nested request -> depth-first (names, num_children, tags)."""
    names, counts, tags = [], [], []

    def spec_tag(v):
        if v is None:
            return TAG_VALUE
        if isinstance(v, dict):
            return TAG_STRUCT
        if isinstance(v, (list,)):
            return TAG_LIST
        if isinstance(v, tuple):
            return TAG_MAP
        raise TypeError(f"bad schema spec entry {v!r}")

    def emit(name, v):
        tag = spec_tag(v)
        names.append(name)
        tags.append(tag)
        at = len(counts)
        counts.append(0)
        if tag == TAG_STRUCT:
            counts[at] = len(v)
            for k, sub in v.items():
                emit(k, sub)
        elif tag == TAG_LIST:
            if len(v) != 1:
                raise ValueError("list spec must have exactly one element")
            counts[at] = 1
            emit("element", v[0])
        elif tag == TAG_MAP:
            if len(v) != 2:
                raise ValueError("map spec must be (key, value)")
            counts[at] = 2
            emit("key", v[0])
            emit("value", v[1])

    if not isinstance(spec, dict):
        raise TypeError("top-level schema spec must be a dict of columns")
    for k, v in spec.items():
        emit(k, v)
    return names, counts, tags, len(spec)


def read_footer_bytes(path: str) -> bytes:
    """Extract the raw thrift footer bytes from a .parquet file."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise ValueError("not a parquet file (too small)")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != b"PAR1":
            raise ValueError("not a parquet file (bad magic)")
        (flen,) = _struct.unpack("<I", tail[:4])
        f.seek(size - 8 - flen)
        return f.read(flen)


def predicate_prune_spans(path: str, predicate,
                          ignore_case: bool = False) -> list:
    """Byte windows covering the predicate-surviving row groups.

    The native facade prunes by ONE ``[part_offset, part_offset +
    part_length)`` split window (midpoint rule), so an arbitrary
    stats-pruned subset is expressed as its maximal runs of consecutive
    surviving groups: each returned ``(part_offset, part_length)``
    window contains exactly one run's midpoints and no pruned group's
    midpoint (row groups are laid out sequentially, so neighbouring
    groups' midpoints fall outside the run's byte span).  Feed each
    window to :meth:`ParquetFooter.read_and_filter`; their footers
    union to exactly the stats-surviving groups.

    Stats logic is shared with the scan path
    (:func:`~spark_rapids_jni_tpu_torch.io.parquet.prune_row_groups`),
    over the port's own footer view (:mod:`.metadata`), so the Python
    rule and the native facade cannot drift apart.
    """
    from .metadata import read_metadata
    from .parquet import _row_group_span, prune_row_groups

    meta = read_metadata(path)
    keep, _ = prune_row_groups(meta, range(meta.num_row_groups),
                               predicate, ignore_case)
    spans = []
    run = []
    for i in keep:
        if run and i != run[-1] + 1:
            spans.append(run)
            run = []
        run.append(i)
    if run:
        spans.append(run)
    out = []
    for run in spans:
        start, _ = _row_group_span(meta.row_group(run[0]))
        _, end = _row_group_span(meta.row_group(run[-1]))
        out.append((start, end - start))
    return out


class ParquetFooter:
    """A parsed, filtered footer (reference ParquetFooter.java surface)."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @staticmethod
    def read_and_filter(
        footer: Union[bytes, str],
        part_offset: int = 0,
        part_length: int = 1 << 62,
        schema: Optional[dict] = None,
        ignore_case: bool = False,
    ) -> "ParquetFooter":
        """Parse + prune. ``footer`` is raw thrift bytes or a .parquet path.

        Row groups whose midpoint falls outside
        ``[part_offset, part_offset+part_length)`` are dropped; columns not
        named by ``schema`` (nested dict; None keeps everything) are pruned
        from both the schema tree and every row group's chunks.
        """
        if isinstance(footer, str):
            footer = read_footer_bytes(footer)
        lib = _load_lib()
        if schema is None:
            names, counts, tags, n_top = [], [], [], 0
        else:
            names, counts, tags, n_top = _flatten_schema(schema)
        n = len(names)
        c_names = (ctypes.c_char_p * max(n, 1))(
            *[nm.encode() for nm in names] or [b""])
        c_counts = (ctypes.c_int * max(n, 1))(*(counts or [0]))
        c_tags = (ctypes.c_int * max(n, 1))(*(tags or [0]))
        h = lib.pqf_read_and_filter(
            footer, len(footer), part_offset, part_length, c_names, c_counts,
            c_tags, n, n_top, int(ignore_case), int(schema is not None))
        err = lib.pqf_error(h)
        if err:
            msg = err.decode()
            lib.pqf_free(h)
            raise ValueError(f"parquet footer: {msg}")
        return ParquetFooter(h, lib)

    def close(self):
        if self._h:
            self._lib.pqf_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def num_rows(self) -> int:
        return self._lib.pqf_num_rows(self._h)

    @property
    def num_columns(self) -> int:
        return self._lib.pqf_num_columns(self._h)

    @property
    def num_row_groups(self) -> int:
        return self._lib.pqf_num_row_groups(self._h)

    def serialize(self) -> bytes:
        """PAR1-framed footer file (serializeThriftFile equivalent)."""
        size = self._lib.pqf_serialize(self._h, None, 0)
        buf = ctypes.create_string_buffer(size)
        wrote = self._lib.pqf_serialize(self._h, buf, size)
        if wrote != size:
            raise RuntimeError("footer serialization size mismatch")
        return buf.raw
