"""The data plane's Arrow IPC codec, without pyarrow.

Counterpart of the reference's ``columnar/arrow.py`` data-plane codec
(``batch_to_ipc`` / ``ipc_to_batch`` / ``schema_fingerprint``), written
against the Arrow IPC format itself so the serving fleet runs where no
pyarrow is installed.  One batch crosses as one Arrow IPC stream: the
schema message, a dictionary batch per dictionary column, one record
batch and the end-of-stream marker.  The flatbuffers are built by hand
(:class:`_Builder` lays them out as the flatbuffers C++ builder does, so
a schema message is byte for byte pyarrow's); body buffers are 8-byte
aligned.

The round trip is bit-exact because the primary buffers never lean on
Arrow nulls:

* every column ships all-valid beside a ``<name>;v`` bool field holding
  the row validity (null rows keep their data bytes: borrowed codes,
  NaN payloads, -0.0);
* a dictionary column crosses as int32 indices plus a dictionary batch
  (string dictionaries as ``binary``, plain or decimal values), never
  decoded; a run-length column as a run-end-encoded array (int64 run
  ends), never expanded, unless it has rows but no runs, which run-end
  encoding cannot say: it then ships decoded;
* strings ship as ``binary``, decimals as ``decimal128`` (null rows 0),
  dates as ``date32``, timestamps as ``timestamp[us]`` with their zone;
  bit- and frame-packed columns are decoded first;
* lists and structs ship as Arrow arrays with Arrow nulls (no
  companion field).

Field metadata ``sptpu.enc`` records each field's branch and
``sptpu.vkind`` a dictionary's value kind.  :func:`schema_fingerprint` is
the sha256 prefix of the schema message, so a descriptor that names
another schema is refused before any buffer is read.  The reader checks
every flatbuffer offset, buffer extent, offset array, run end and
dictionary index, and raises ``ValueError`` on a truncated or malformed
stream.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io.arrow_schema import _Flat
from . import types as T
from .column import (Column, ColumnBatch, Decimal128Column, ListColumn,
                     StringColumn, StructColumn)

_ENC_META = b"sptpu.enc"
_VKIND_META = b"sptpu.vkind"
_VALIDITY_SUFFIX = ";v"
_CONTINUATION = b"\xff\xff\xff\xff"
_EOS = _CONTINUATION + b"\x00\x00\x00\x00"
_V5 = 4  # MetadataVersion.V5

# MessageHeader union ids
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
# Type union ids (Schema.fbs)
_T_INT, _T_FLOAT, _T_BINARY, _T_UTF8, _T_BOOL, _T_DECIMAL = 2, 3, 4, 5, 6, 7
_T_DATE, _T_TIMESTAMP, _T_LIST, _T_STRUCT, _T_REE = 8, 10, 12, 13, 22
_UNITS = {"s": 0, "ms": 1, "us": 2, "ns": 3}
_MAX_DEPTH = 64


class IpcBuffer(bytes):
    """The stream's bytes; ``to_pybytes`` as pyarrow's buffer has it."""

    def to_pybytes(self) -> bytes:
        return bytes(self)


# ---------------------------------------------------------------------------
# flatbuffer building
# ---------------------------------------------------------------------------

class _Builder:
    """A flatbuffer built back to front, as the flatbuffers C++ builder
    builds one: the same alignment, the same vtable sharing, the same
    omission of default scalars.  Positions are distances from the end."""

    def __init__(self):
        self.buf = bytearray()
        self.minalign = 1
        self.vtables: List[int] = []
        self.fields: List[Tuple[int, int]] = []
        self.max_voffset = 0

    def size(self) -> int:
        return len(self.buf)

    def _prepend(self, b: bytes):
        self.buf[0:0] = b

    def align(self, a: int):
        self.minalign = max(self.minalign, a)
        self._prepend(bytes(-len(self.buf) & (a - 1)))

    def prealign(self, n: int, a: int):
        if n == 0:
            return
        self.minalign = max(self.minalign, a)
        self._prepend(bytes(-(len(self.buf) + n) & (a - 1)))

    def push(self, fmt: str, v) -> int:
        self.align(struct.calcsize(fmt))
        self._prepend(struct.pack(fmt, v))
        return self.size()

    def _refer(self, off: int) -> int:
        self.align(4)
        return self.size() - off + 4

    def _track(self, slot: int, off: int):
        vo = 4 + 2 * slot
        self.fields.append((vo, off))
        self.max_voffset = max(self.max_voffset, vo)

    def scalar(self, slot: int, fmt: str, v, default):
        if v != default:
            self._track(slot, self.push(fmt, v))

    def offset(self, slot: int, off: int):
        if off:
            self._track(slot, self.push("<I", self._refer(off)))

    def start(self) -> int:
        return self.size()

    def end(self, start: int) -> int:
        loc = self.push("<i", 0)
        self.max_voffset = max(self.max_voffset + 2, 4)
        vt = bytearray(self.max_voffset)
        struct.pack_into("<HH", vt, 0, self.max_voffset, loc - start)
        for vo, off in self.fields:
            struct.pack_into("<H", vt, vo, loc - off)
        self.fields, self.max_voffset = [], 0
        self._prepend(bytes(vt))
        use = self.size()
        for old in self.vtables:
            at = len(self.buf) - old
            if self.buf[at:at + len(vt)] == vt:
                use = old
                del self.buf[0:self.size() - loc]
                break
        if use == self.size():
            self.vtables.append(use)
        struct.pack_into("<i", self.buf, len(self.buf) - loc, use - loc)
        return loc

    def string(self, s: bytes) -> int:
        self.prealign(len(s) + 1, 4)
        self._prepend(s + b"\0")
        return self.push("<I", len(s))

    def vector(self, offsets: List[int]) -> int:
        self.prealign(4 * len(offsets), 4)
        for off in reversed(offsets):
            self.push("<I", self._refer(off))
        return self.push("<I", len(offsets))

    def structs(self, raw: bytes, n: int) -> int:
        """A vector of ``n`` 16-byte, 8-aligned structs."""
        self.prealign(len(raw), 4)
        self.prealign(len(raw), 8)
        self._prepend(raw)
        return self.push("<I", n)

    def finish(self, root: int) -> bytes:
        self.prealign(4, self.minalign)
        self.push("<I", self._refer(root))
        return bytes(self.buf)


def _encapsulate(flatbuffer: bytes) -> bytes:
    """Continuation marker, padded length, flatbuffer, padding to 8."""
    pad = -(len(flatbuffer) + 8) & 7
    return (_CONTINUATION + struct.pack("<i", len(flatbuffer) + pad)
            + flatbuffer + bytes(pad))


# ---------------------------------------------------------------------------
# the Arrow types and fields this codec speaks
# ---------------------------------------------------------------------------

class _Type:
    """An Arrow type: ``kind`` one of int, float, bool, binary, utf8,
    date32, timestamp, decimal, list, struct, ree; ``bits`` (int, float),
    ``tz`` and ``unit`` (timestamp), ``precision``/``scale`` (decimal),
    ``children`` (list, struct, ree: :class:`_Field`)."""

    def __init__(self, kind: str, bits: int = 0, tz: str = "",
                 unit: str = "us", precision: int = 0, scale: int = 0,
                 children=()):
        self.kind, self.bits, self.tz, self.unit = kind, bits, tz, unit
        self.precision, self.scale = precision, scale
        self.children = list(children)


class _Field:
    """An Arrow field; ``dict_id`` is set on a dictionary field (int32
    indices over values of ``type``)."""

    def __init__(self, name: str, type_: _Type, nullable: bool = True,
                 metadata=(), dict_id: Optional[int] = None):
        self.name, self.type, self.nullable = name, type_, nullable
        self.metadata = list(metadata)
        self.dict_id = dict_id


def _build_type(b: _Builder, t: _Type) -> Tuple[int, int, List[int]]:
    """The type table: ``(union id, offset, child field offsets)``."""
    children = [_build_field(b, c) for c in t.children]
    if t.kind == "timestamp":
        tz = b.string(t.tz.encode()) if t.tz else 0
        s = b.start()
        b.offset(1, tz)
        b.scalar(0, "<h", _UNITS[t.unit], 0)
        return _T_TIMESTAMP, b.end(s), children
    s = b.start()
    if t.kind == "int":
        b.scalar(0, "<i", t.bits, 0)
        b.scalar(1, "<B", 1, 0)
        tid = _T_INT
    elif t.kind == "float":
        b.scalar(0, "<h", {16: 0, 32: 1, 64: 2}[t.bits], 0)
        tid = _T_FLOAT
    elif t.kind == "decimal":
        b.scalar(1, "<i", t.scale, 0)
        b.scalar(0, "<i", t.precision, 0)
        tid = _T_DECIMAL
    elif t.kind == "date32":
        b.scalar(0, "<h", 0, 1)
        tid = _T_DATE
    else:
        tid = {"bool": _T_BOOL, "binary": _T_BINARY, "utf8": _T_UTF8,
               "list": _T_LIST, "struct": _T_STRUCT, "ree": _T_REE}[t.kind]
    return tid, b.end(s), children


def _build_field(b: _Builder, f: _Field) -> int:
    # pyarrow's order: type (children first), dictionary encoding,
    # metadata, name, children vector, the field table
    tid, toff, children = _build_type(b, f.type)
    dic = 0
    if f.dict_id is not None:
        s = b.start()
        b.scalar(0, "<i", 32, 0)
        b.scalar(1, "<B", 1, 0)
        index = b.end(s)
        s = b.start()
        b.scalar(0, "<q", f.dict_id, 0)
        b.offset(1, index)
        dic = b.end(s)
    kvs = []
    for k, v in f.metadata:
        ko, vo = b.string(k), b.string(v)
        s = b.start()
        b.offset(1, vo)
        b.offset(0, ko)
        kvs.append(b.end(s))
    meta = b.vector(kvs) if kvs else 0
    name = b.string(f.name.encode())
    kids = b.vector(children)
    s = b.start()
    b.offset(6, meta)
    b.offset(5, kids)
    b.offset(4, dic)
    b.offset(3, toff)
    b.offset(0, name)
    b.scalar(2, "<B", tid, 0)
    b.scalar(1, "<B", int(f.nullable), 0)
    return b.end(s)


def _message(b: _Builder, header_type: int, header: int,
             body_length: int) -> bytes:
    s = b.start()
    b.scalar(3, "<q", body_length, 0)
    b.offset(2, header)
    b.scalar(0, "<h", _V5, 0)
    b.scalar(1, "<B", header_type, 0)
    return _encapsulate(b.finish(b.end(s)))


def _schema_message(fields: List[_Field]) -> bytes:
    b = _Builder()
    offs = [_build_field(b, f) for f in fields]
    vec = b.vector(offs)
    s = b.start()
    b.offset(1, vec)
    return _message(b, _SCHEMA, b.end(s), 0)


def schema_fingerprint(schema_message: bytes) -> str:
    """Hex fingerprint of an IPC schema message (fields + metadata): the
    sha256 prefix of its encapsulated bytes."""
    return hashlib.sha256(schema_message).hexdigest()[:16]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class _Arr:
    """An Arrow array about to be written: one field node, its buffers
    (``None`` for an absent validity bitmap) and its children."""

    def __init__(self, length: int, null_count: int, buffers, children=()):
        self.length, self.null_count = length, null_count
        self.buffers, self.children = list(buffers), list(children)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _bits(valid: np.ndarray) -> bytes:
    return np.packbits(valid.astype(np.uint8), bitorder="little").tobytes()


def _validity(valid: Optional[np.ndarray]) -> Tuple[int, Optional[bytes]]:
    """``(null count, bitmap or None)`` of an optional row validity."""
    if valid is None:
        return 0, None
    nulls = int(valid.size - np.count_nonzero(valid))
    return nulls, (_bits(valid) if nulls else None)


def _fixed_type(dtype: T.SparkType) -> _Type:
    k = dtype.kind
    if k is T.Kind.BOOLEAN:
        return _Type("bool")
    if k is T.Kind.DATE:
        return _Type("date32")
    if k is T.Kind.TIMESTAMP:
        return _Type("timestamp", tz=dtype.tz or "")
    if k in (T.Kind.FLOAT32, T.Kind.FLOAT64):
        return _Type("float", bits=32 if k is T.Kind.FLOAT32 else 64)
    bits = {T.Kind.INT8: 8, T.Kind.INT16: 16, T.Kind.INT32: 32,
            T.Kind.INT64: 64}.get(k)
    if bits is None:
        raise TypeError(f"cannot export {dtype!r} on the data plane")
    return _Type("int", bits=bits)


def _fixed_array(data: np.ndarray, dtype: T.SparkType,
                 valid: Optional[np.ndarray] = None) -> _Arr:
    nulls, bitmap = _validity(valid)
    if dtype.kind is T.Kind.BOOLEAN:
        values = _bits(data.astype(np.bool_))
    else:
        values = np.ascontiguousarray(data).tobytes()
    return _Arr(len(data), nulls, [bitmap, values])


def _binary_array(rows: List[bytes],
                  valid: Optional[np.ndarray] = None) -> _Arr:
    nulls, bitmap = _validity(valid)
    lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return _Arr(len(rows), nulls, [bitmap, offsets.tobytes(),
                                   b"".join(rows)])


def _binary_rows(col: StringColumn) -> List[bytes]:
    chars, lens = _np(col.chars), _np(col.lengths)
    return [chars[i, :lens[i]].tobytes() for i in range(len(lens))]


def _decimal_array(col: Decimal128Column, valid: np.ndarray,
                   with_nulls: bool) -> Tuple[_Type, _Arr]:
    """Null rows ship 0; ``with_nulls`` also marks them Arrow-null."""
    limbs = _np(col.limbs).astype(np.int64).reshape(-1, 2).copy()
    limbs[~valid] = 0
    nulls, bitmap = _validity(valid) if with_nulls else (0, None)
    return (_Type("decimal", precision=col.precision, scale=col.scale),
            _Arr(len(limbs), nulls, [bitmap, limbs.tobytes()]))


def _nested(col) -> Tuple[_Type, _Arr]:
    """A column as an Arrow array with Arrow nulls at every level (the
    reference's ``to_arrow`` representation)."""
    from .encoded import materialize_column

    col = materialize_column(col)
    valid = _np(col.validity).astype(np.bool_)
    nulls, bitmap = _validity(valid)
    if isinstance(col, ListColumn):
        ct, child = _nested(col.child)
        offsets = _np(col.offsets).astype(np.int32)
        return (_Type("list", children=[_Field("item", ct)]),
                _Arr(len(valid), nulls, [bitmap, offsets.tobytes()],
                     [child]))
    if isinstance(col, StructColumn):
        kids = [_nested(c) for c in col.children]
        return (_Type("struct", children=[
            _Field(n, t) for n, (t, _) in zip(col.field_names, kids)]),
            _Arr(len(valid), nulls, [bitmap], [a for _, a in kids]))
    if isinstance(col, StringColumn):
        # the reference's to_arrow decodes the rows as UTF-8 text
        rows = [b"" if s is None else s.encode()
                for s in col.to_pylist()]
        return _Type("utf8"), _binary_array(rows, valid)
    if isinstance(col, Decimal128Column):
        return _decimal_array(col, valid, with_nulls=True)
    return _fixed_type(col.dtype), _fixed_array(_np(col.data), col.dtype,
                                                valid)


def _export_column(name: str, col, dict_ids):
    """One column -> ``[(field, array, dictionary or None), ...]``."""
    from .encoded import PACKED_COLUMNS, DictionaryColumn, RunLengthColumn

    if isinstance(col, PACKED_COLUMNS):
        col = col.decode()  # lanes have no Arrow form

    def meta(enc: bytes, vkind: Optional[bytes] = None):
        m = [(_ENC_META, enc)]
        return m + [(_VKIND_META, vkind)] if vkind else m

    def companion(valid: torch.Tensor):
        v = _np(valid).astype(np.bool_)
        return (_Field(f"{name}{_VALIDITY_SUFFIX}", _Type("bool"),
                       metadata=meta(b"validity")),
                _fixed_array(v, T.BOOLEAN), None)

    if isinstance(col, DictionaryColumn):
        d = col.dictionary
        if isinstance(d, StringColumn):
            vt, values, vkind = (_Type("binary"),
                                 _binary_array(_binary_rows(d)), b"string")
        elif isinstance(d, Decimal128Column):
            vt, values = _decimal_array(d, _np(d.validity).astype(np.bool_),
                                        with_nulls=True)
            vkind = b"decimal"
        else:
            vt, values, vkind = (_fixed_type(d.dtype),
                                 _fixed_array(_np(d.data), d.dtype),
                                 b"plain")
        codes = _np(col.codes).astype(np.int32)
        f = _Field(name, vt, metadata=meta(b"dict", vkind),
                   dict_id=next(dict_ids))
        return [(f, _Arr(len(codes), 0, [None, codes.tobytes()]), values),
                companion(col.validity)]
    if isinstance(col, RunLengthColumn):
        lengths = _np(col.run_lengths).astype(np.int64)
        if lengths.size == 0 and col.num_rows:
            return _export_column(name, col.decode(), dict_ids)
        run_ends = np.cumsum(lengths).astype(np.int64)
        values = _fixed_array(_np(col.run_values), col.dtype)
        t = _Type("ree", children=[
            _Field("run_ends", _Type("int", bits=64), nullable=False),
            _Field("values", _fixed_type(col.dtype))])
        arr = _Arr(int(run_ends[-1]) if run_ends.size else 0, 0, [],
                   [_Arr(len(run_ends), 0, [None, run_ends.tobytes()]),
                    values])
        return [(_Field(name, t, metadata=meta(b"rle")), arr, None),
                companion(col.validity)]
    if isinstance(col, StringColumn):
        return [(_Field(name, _Type("binary"), metadata=meta(b"string")),
                 _binary_array(_binary_rows(col)), None),
                companion(col.validity)]
    if isinstance(col, Decimal128Column):
        t, arr = _decimal_array(col, _np(col.validity).astype(np.bool_),
                                with_nulls=False)
        return [(_Field(name, t, metadata=meta(b"decimal")), arr, None),
                companion(col.validity)]
    if isinstance(col, Column):
        return [(_Field(name, _fixed_type(col.dtype),
                        metadata=meta(b"plain")),
                 _fixed_array(_np(col.data), col.dtype), None),
                companion(col.validity)]
    if isinstance(col, (ListColumn, StructColumn)):
        t, arr = _nested(col)
        return [(_Field(name, t, metadata=meta(b"arrow")), arr, None)]
    raise TypeError(f"cannot export {type(col).__name__} on the data plane")


def _record_batch(length: int, arrays: List[_Arr]):
    """One record batch message and its body (8-byte aligned buffers)."""
    nodes, buffers, body, at = [], [], [], 0

    def walk(a: _Arr):
        nonlocal at
        nodes.append(struct.pack("<qq", a.length, a.null_count))
        for buf in a.buffers:
            n = 0 if buf is None else len(buf)
            buffers.append(struct.pack("<qq", at, n))
            if n:
                body.append(buf)
                pad = -n & 7
                if pad:
                    body.append(bytes(pad))
                at += n + pad
        for c in a.children:
            walk(c)

    for a in arrays:
        walk(a)
    b = _Builder()
    nv = b.structs(b"".join(nodes), len(nodes))
    bv = b.structs(b"".join(buffers), len(buffers))
    s = b.start()
    b.scalar(0, "<q", length, 0)
    b.offset(2, bv)
    b.offset(1, nv)
    return b.end(s), b, at, body


def _batch_message(length: int, arrays: List[_Arr]) -> bytes:
    rb, b, body_len, body = _record_batch(length, arrays)
    return _message(b, _RECORD_BATCH, rb, body_len) + b"".join(body)


def _dictionary_message(dict_id: int, values: _Arr) -> bytes:
    rb, b, body_len, body = _record_batch(values.length, [values])
    s = b.start()
    b.scalar(0, "<q", dict_id, 0)
    b.offset(1, rb)
    return (_message(b, _DICTIONARY_BATCH, b.end(s), body_len)
            + b"".join(body))


def batch_to_ipc(batch: ColumnBatch) -> Tuple[IpcBuffer, str]:
    """A batch -> ``(one IPC stream, schema fingerprint)``; encoded
    columns cross as codes and dictionary, or runs."""
    dict_ids = iter(range(1 << 31))
    fields, arrays, dicts = [], [], []
    for name in batch.names:
        if name.endswith(_VALIDITY_SUFFIX):
            raise ValueError(
                f"column name {name!r} collides with the data plane's "
                f"validity-companion suffix {_VALIDITY_SUFFIX!r}")
        for f, a, d in _export_column(name, batch[name], dict_ids):
            fields.append(f)
            arrays.append(a)
            if d is not None:
                dicts.append((f.dict_id, d))
    schema = _schema_message(fields)
    parts = [schema]
    parts += [_dictionary_message(i, d) for i, d in dicts]
    parts += [_batch_message(batch.num_rows if batch.names else 0, arrays),
              _EOS]
    return IpcBuffer(b"".join(parts)), schema_fingerprint(schema)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _In:
    """A decoded Arrow array: ``valid`` (None: no nulls), ``values``
    (fixed width, bool unpacked), ``offsets`` + ``data`` (binary, list
    offsets), ``children``."""

    def __init__(self, t: _Type, length: int, valid, values=None,
                 offsets=None, data=None, children=()):
        self.type, self.length, self.valid = t, length, valid
        self.values, self.offsets, self.data = values, offsets, data
        self.children = list(children)


def _bad(what: str) -> ValueError:
    return ValueError(f"malformed Arrow IPC stream: {what}")


def _read_type(fb: _Flat, ft: int, depth: int) -> _Type:
    tid = fb.scalar(ft, 2, "<B", 0)
    body = fb.table(ft, 3)
    children = [_read_field(fb, c, depth + 1) for c in fb.tables(ft, 5)]
    if tid == _T_INT:
        bits = fb.scalar(body, 0, "<i", 0) if body else 0
        signed = bool(fb.scalar(body, 1, "<B", 0)) if body else False
        if not signed or bits not in (8, 16, 32, 64):
            raise NotImplementedError(
                f"arrow type {'u' if not signed else ''}int{bits} not "
                "supported yet")
        return _Type("int", bits=bits)
    if tid == _T_FLOAT:
        p = fb.scalar(body, 0, "<h", 0) if body else 0
        if p not in (1, 2):
            raise NotImplementedError("arrow type halffloat not supported "
                                      "yet")
        return _Type("float", bits=32 if p == 1 else 64)
    if tid == _T_BOOL:
        return _Type("bool")
    if tid in (_T_BINARY, _T_UTF8):
        return _Type("binary" if tid == _T_BINARY else "utf8")
    if tid == _T_DATE:
        if body is None or fb.scalar(body, 0, "<h", 1) != 0:
            raise NotImplementedError("arrow type date64 not supported yet")
        return _Type("date32")
    if tid == _T_TIMESTAMP:
        u = fb.scalar(body, 0, "<h", 0) if body else 0
        if not 0 <= u < 4:
            raise _bad(f"timestamp unit {u}")
        return _Type("timestamp", unit=("s", "ms", "us", "ns")[u],
                     tz=fb.string(body, 1) if body else "")
    if tid == _T_DECIMAL:
        if body is None or fb.scalar(body, 2, "<i", 128) != 128:
            raise NotImplementedError("arrow decimal256 not supported yet")
        return _Type("decimal", precision=fb.scalar(body, 0, "<i", 0),
                     scale=fb.scalar(body, 1, "<i", 0))
    if tid == _T_LIST and len(children) == 1:
        return _Type("list", children=children)
    if tid == _T_STRUCT:
        return _Type("struct", children=children)
    if tid == _T_REE and len(children) == 2:
        return _Type("ree", children=children)
    raise NotImplementedError(f"arrow type id {tid} not supported yet")


def _read_field(fb: _Flat, ft: int, depth: int) -> _Field:
    if depth > _MAX_DEPTH:
        raise _bad("fields nested too deep")
    meta = []
    for kv in fb.tables(ft, 6):
        meta.append((fb.raw_string(kv, 0), fb.raw_string(kv, 1)))
    dict_id = None
    enc = fb.table(ft, 4)
    if enc is not None:
        dict_id = fb.scalar(enc, 0, "<q", 0)
        index = fb.table(enc, 1)
        if index is None or fb.scalar(index, 0, "<i", 0) != 32 \
                or not fb.scalar(index, 1, "<B", 0):
            raise NotImplementedError("dictionary indices other than int32 "
                                      "not supported yet")
    return _Field(fb.string(ft, 0), _read_type(fb, ft, depth),
                  nullable=bool(fb.scalar(ft, 1, "<B", 0)), metadata=meta,
                  dict_id=dict_id)


class _Body:
    """A record batch's nodes and buffers over its body, each extent
    checked, consumed in field order."""

    def __init__(self, fb: _Flat, rb: int, body: memoryview):
        self.fb, self.body = fb, body
        if fb.table(rb, 3) is not None:
            raise NotImplementedError("compressed IPC bodies are not "
                                      "supported")
        self.nodes, self.n_nodes = fb.vector(rb, 1, 16)
        self.bufs, self.n_bufs = fb.vector(rb, 2, 16)
        self.node_i = self.buf_i = 0

    def node(self) -> Tuple[int, int]:
        if self.node_i >= self.n_nodes:
            raise _bad("fewer field nodes than fields")
        at = self.nodes + 16 * self.node_i
        self.node_i += 1
        length = self.fb._unpack("<q", at)
        nulls = self.fb._unpack("<q", at + 8)
        if length < 0 or not 0 <= nulls <= length:
            raise _bad("a field node's length or null count")
        return length, nulls

    def buffer(self) -> memoryview:
        if self.buf_i >= self.n_bufs:
            raise _bad("fewer buffers than the fields need")
        at = self.bufs + 16 * self.buf_i
        self.buf_i += 1
        off = self.fb._unpack("<q", at)
        n = self.fb._unpack("<q", at + 8)
        if off < 0 or n < 0 or off + n > len(self.body):
            raise _bad("a buffer runs past the message body")
        return self.body[off:off + n]


def _need(buf: memoryview, n: int, what: str) -> memoryview:
    if len(buf) < n:
        raise _bad(f"{what} buffer too short")
    return buf[:n]


def _unbits(buf: memoryview, n: int, what: str) -> np.ndarray:
    raw = np.frombuffer(_need(buf, (n + 7) // 8, what), np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n].astype(np.bool_)


_FIXED_NP = {("int", 8): np.int8, ("int", 16): np.int16,
             ("int", 32): np.int32, ("int", 64): np.int64,
             ("float", 32): np.float32, ("float", 64): np.float64}


def _read_array(body: _Body, t: _Type, depth: int = 0) -> _In:
    if depth > _MAX_DEPTH:
        raise _bad("arrays nested too deep")
    n, nulls = body.node()
    if t.kind == "ree":
        if nulls:
            raise _bad("a run-end encoded array with nulls")
        return _In(t, n, None, children=[
            _read_array(body, c.type, depth + 1) for c in t.children])
    vbuf = body.buffer()
    valid = _unbits(vbuf, n, "validity") if nulls else None
    if valid is not None and int(n - np.count_nonzero(valid)) != nulls:
        raise _bad("a null count that disagrees with its bitmap")
    if t.kind == "bool":
        return _In(t, n, valid, values=_unbits(body.buffer(), n, "bool"))
    if t.kind in ("int", "float", "date32", "timestamp", "decimal"):
        dt = (np.int32 if t.kind == "date32"
              else np.int64 if t.kind in ("timestamp", "decimal")
              else _FIXED_NP[(t.kind, t.bits)])
        width = 2 if t.kind == "decimal" else 1
        raw = _need(body.buffer(), n * width * np.dtype(dt).itemsize,
                    t.kind)
        values = np.frombuffer(raw, dt)
        return _In(t, n, valid, values=values.reshape(-1, 2)
                   if width == 2 else values)
    if t.kind in ("binary", "utf8", "list"):
        offsets = np.frombuffer(_need(body.buffer(), 4 * (n + 1),
                                      "offsets"), np.int32)
        if n and (offsets[0] < 0 or np.any(np.diff(offsets) < 0)):
            raise _bad("offsets that decrease")
        if t.kind == "list":
            child = _read_array(body, t.children[0].type, depth + 1)
            if n and offsets[-1] > child.length:
                raise _bad("list offsets past the child's length")
            return _In(t, n, valid, offsets=offsets, children=[child])
        data = body.buffer()
        if n and offsets[-1] > len(data):
            raise _bad("offsets past the data buffer")
        return _In(t, n, valid, offsets=offsets,
                   data=np.frombuffer(data, np.uint8))
    if t.kind == "struct":
        kids = [_read_array(body, c.type, depth + 1) for c in t.children]
        if any(k.length < n for k in kids):
            raise _bad("a struct child shorter than its parent")
        return _In(t, n, valid, children=kids)
    raise _bad(f"type {t.kind}")


def _empty(t: _Type) -> _In:
    """A zero-row array of type ``t``."""
    if t.kind in ("struct", "ree"):
        return _In(t, 0, None, children=[_empty(c.type) for c in t.children])
    if t.kind in ("binary", "utf8", "list"):
        return _In(t, 0, None, offsets=np.zeros(1, np.int32),
                   data=np.zeros(0, np.uint8),
                   children=[_empty(c.type) for c in t.children])
    dt = (np.bool_ if t.kind == "bool" else np.int32 if t.kind == "date32"
          else np.int64 if t.kind in ("timestamp", "decimal")
          else _FIXED_NP[(t.kind, t.bits)])
    values = np.zeros((0, 2) if t.kind == "decimal" else (0,), dt)
    return _In(t, 0, None, values=values)


def _take(a: _In, idx: np.ndarray) -> _In:
    """Rows ``idx`` of a decoded array (the null-extent repack of a list)."""
    valid = None if a.valid is None else a.valid[idx]
    if a.values is not None:
        return _In(a.type, len(idx), valid, values=a.values[idx])
    if a.type.kind == "struct":
        return _In(a.type, len(idx), valid,
                   children=[_take(c, idx) for c in a.children])
    lens = (a.offsets[1:] - a.offsets[:-1])[idx].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    flat = _segment_gather(a.offsets[:-1][idx].astype(np.int64), lens)
    if a.type.kind == "list":
        return _In(a.type, len(idx), valid, offsets=offsets,
                   children=[_take(a.children[0], flat)])
    return _In(a.type, len(idx), valid, offsets=offsets, data=a.data[flat])


def _segment_gather(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    total = int(lens.sum())
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(starts, lens) + within


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


def _ones(n: int) -> np.ndarray:
    return np.ones((n,), np.bool_)


def _string_column(a: _In, dev, pad_to_multiple: int = 8) -> StringColumn:
    n = a.length
    valid = _ones(n) if a.valid is None else a.valid
    offsets = a.offsets[:n + 1].astype(np.int64)
    lengths = np.where(valid, offsets[1:] - offsets[:-1], 0).astype(np.int32)
    max_len = int(lengths.max()) if n else 0
    max_len = max(1, -(-max(max_len, 1) // pad_to_multiple)
                  * pad_to_multiple)
    chars = np.zeros((n, max_len), dtype=np.uint8)
    if a.data.size:
        rows = np.repeat(np.arange(n), lengths)
        flat = _segment_gather(offsets[:-1], lengths.astype(np.int64))
        within = flat - np.repeat(offsets[:-1], lengths)
        chars[rows, within] = a.data[flat]
    return StringColumn(_t(chars, dev), _t(lengths, dev), _t(valid, dev))


def _to_column(a: _In, dev):
    """A decoded array -> a column, as the reference's ``array_to_column``
    turns the same Arrow array into one."""
    t, n = a.type, a.length
    valid = _ones(n) if a.valid is None else a.valid
    if t.kind == "list":
        offsets64 = a.offsets[:n + 1].astype(np.int64)
        base = int(offsets64[0]) if n else 0
        end = int(offsets64[-1]) if n else 0
        child = _take(a.children[0], np.arange(base, end))
        offsets = (offsets64 - base).astype(np.int32) if n \
            else np.zeros(1, np.int32)
        lens = np.diff(offsets)
        if np.any(~valid & (lens > 0)):
            # a null row spans no elements in a ListColumn: repack
            keep = np.where(valid, lens, 0).astype(np.int64)
            child = _take(child, _segment_gather(
                offsets[:-1].astype(np.int64), keep))
            offsets = np.concatenate([[0], np.cumsum(keep)]).astype(np.int32)
        return ListColumn(_t(offsets, dev), _to_column(child, dev),
                          _t(valid, dev))
    if t.kind == "struct":
        return StructColumn(
            {f.name: _to_column(_take(c, np.arange(n)) if c.length != n
                                else c, dev)
             for f, c in zip(t.children, a.children)}, _t(valid, dev))
    if t.kind in ("binary", "utf8"):
        return _string_column(a, dev)
    if t.kind == "decimal":
        return Decimal128Column(_t(a.values, dev), _t(valid, dev),
                                T.SparkType.decimal(t.precision, t.scale))
    if t.kind == "timestamp":
        v = a.values
        if t.unit in ("s", "ms"):
            v = v * (1_000_000 if t.unit == "s" else 1000)
        elif t.unit == "ns":
            # Spark timestamps are micros: nanoseconds truncate to zero
            v = np.where(v >= 0, v // 1000, -(-v // 1000))
        return Column(_t(v, dev), _t(valid, dev),
                      T.SparkType(T.Kind.TIMESTAMP, tz=t.tz))
    if t.kind == "bool":
        return Column(_t(a.values, dev), _t(valid, dev), T.BOOLEAN)
    if t.kind == "date32":
        return Column(_t(a.values, dev), _t(valid, dev), T.DATE)
    if t.kind == "ree":
        raise NotImplementedError("a run-end encoded field without the "
                                  "codec's rle marker")
    kind = {("int", 8): T.INT8, ("int", 16): T.INT16, ("int", 32): T.INT32,
            ("int", 64): T.INT64, ("float", 32): T.FLOAT32,
            ("float", 64): T.FLOAT64}[(t.kind, t.bits)]
    return Column(_t(a.values, dev), _t(valid, dev), kind)


def _messages(buf: memoryview):
    """Yield ``(flatbuffer, header type, header table, body, raw message
    bytes)`` for each message up to the end marker."""
    pos = 0
    while True:
        if pos + 4 > len(buf):
            raise _bad("the stream ends without its end marker")
        start = pos
        n = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        if n == -1:
            if pos + 4 > len(buf):
                raise _bad("the stream ends inside a message prefix")
            n = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        if n == 0:
            return
        if n < 0 or pos + n > len(buf):
            raise _bad("a message runs past the stream")
        fb = _Flat(bytes(buf[pos:pos + n]), what="Arrow IPC message")
        pos += n
        msg = fb.deref(0)
        body_len = fb.scalar(msg, 3, "<q", 0)
        if body_len < 0 or pos + body_len > len(buf):
            raise _bad("a message body runs past the stream")
        header = fb.table(msg, 2)
        if header is None:
            raise _bad("a message without a header")
        yield (fb, fb.scalar(msg, 1, "<B", 0), header,
               buf[pos:pos + body_len], bytes(buf[start:pos]))
        pos += body_len


def _read_stream(buf):
    """``(fields, schema message, {dict id: decoded values}, [decoded
    arrays], length)`` of one stream."""
    view = memoryview(buf).cast("B")
    fields = schema = None
    dicts: Dict[int, _In] = {}
    arrays, length = None, 0
    for fb, htype, header, body, raw in _messages(view):
        if fields is None:
            if htype != _SCHEMA:
                raise _bad("the first message is not a schema")
            fields = [_read_field(fb, f, 0) for f in fb.tables(header, 1)]
            schema = raw
            by_id = {f.dict_id: f for f in fields if f.dict_id is not None}
            continue
        if htype == _DICTIONARY_BATCH:
            did = fb.scalar(header, 0, "<q", 0)
            rb = fb.table(header, 1)
            if did not in by_id or rb is None or did in dicts \
                    or fb.scalar(header, 2, "<B", 0):
                raise _bad(f"dictionary batch {did}")
            dicts[did] = _read_array(_Body(fb, rb, body), by_id[did].type)
        elif htype == _RECORD_BATCH:
            if arrays is not None:
                raise _bad("more than one record batch")
            length = fb.scalar(header, 0, "<q", 0)
            b = _Body(fb, header, body)
            # a dictionary field's column is its int32 indices
            arrays = [_read_array(b, _Type("int", bits=32)
                                  if f.dict_id is not None else f.type)
                      for f in fields]
        else:
            raise _bad(f"message type {htype}")
    if fields is None:
        raise _bad("no schema message")
    if arrays is None:
        # pyarrow writes an empty table as its schema alone
        if dicts:
            raise _bad("dictionary batches without a record batch")
        arrays = [_empty(_Type("int", bits=32) if f.dict_id is not None
                         else f.type) for f in fields]
        dicts = {i: _empty(f.type) for i, f in by_id.items()}
    if set(dicts) != set(by_id):
        raise _bad("a dictionary field without its dictionary batch")
    if any(a.length != length for a in arrays):
        raise _bad("a column whose length is not the batch's")
    return fields, schema, dicts, arrays


def ipc_to_batch(buf, expect_fingerprint: Optional[str] = None,
                 device=None) -> ColumnBatch:
    """The bit-exact inverse of :func:`batch_to_ipc`, on ``device`` (the
    GPU by default); ``expect_fingerprint`` checks the schema before any
    buffer is read."""
    from .encoded import RunLengthColumn, dictionary_from_arrays

    dev = resolve_device(device)
    fields, schema, dicts, arrays = _read_stream(buf)
    fp = schema_fingerprint(schema)
    if expect_fingerprint is not None and fp != expect_fingerprint:
        raise ValueError(
            f"IPC schema fingerprint {fp} does not match descriptor "
            f"{expect_fingerprint}")
    by_name = {f.name: (f, a) for f, a in zip(fields, arrays)}
    out = {}
    for f, a in zip(fields, arrays):
        meta = dict(f.metadata)
        enc = (meta.get(_ENC_META) or b"arrow").decode()
        if enc == "validity":
            continue
        comp = by_name.get(f"{f.name}{_VALIDITY_SUFFIX}")
        valid = None
        if comp is not None:
            if comp[1].type.kind != "bool":
                raise _bad(f"validity field of {f.name!r} is not bool")
            valid = _t(comp[1].values, dev)
        if f.dict_id is not None:
            if enc != "dict":
                raise NotImplementedError(
                    f"dictionary field {f.name!r} without the codec's "
                    "dict marker")
            values = dicts[f.dict_id]
            codes = a.values.astype(np.int64)
            if codes.size and (codes.min() < 0
                               or codes.max() >= values.length):
                raise _bad(f"dictionary indices of {f.name!r} out of range")
            vkind = (meta.get(_VKIND_META) or b"plain").decode()
            col = (_string_column(values, dev) if vkind == "string"
                   else _to_column(values, dev))
            out[f.name] = dictionary_from_arrays(codes, valid, col)
        elif enc == "rle":
            if f.type.kind != "ree":
                raise _bad(f"rle field {f.name!r} is not run-end encoded")
            ends_a, vals_a = a.children
            if ends_a.type.kind != "int" or ends_a.type.bits not in (32, 64) \
                    or ends_a.valid is not None:
                raise _bad(f"run ends of {f.name!r}")
            ends = ends_a.values.astype(np.int64)
            lengths = np.diff(np.concatenate([[0], ends]))
            if np.any(lengths <= 0) or (ends.size and ends[-1] != a.length) \
                    or (not ends.size and a.length) \
                    or vals_a.length < ends.size:
                raise _bad(f"run ends of {f.name!r}")
            vals = _to_column(_take(vals_a, np.arange(ends.size))
                              if vals_a.length != ends.size else vals_a, dev)
            out[f.name] = RunLengthColumn(
                vals.data, _t(lengths.astype(np.int32), dev), valid,
                vals.dtype)
        elif enc == "string":
            s = _string_column(a, dev)
            out[f.name] = StringColumn(s.chars, s.lengths, valid)
        elif enc == "decimal":
            d = _to_column(a, dev)
            out[f.name] = Decimal128Column(d.limbs, valid, d.dtype)
        elif enc == "plain":
            c = _to_column(a, dev)
            out[f.name] = Column(c.data, valid, c.dtype)
        else:  # lists and structs: validity rides Arrow nulls
            out[f.name] = _to_column(a, dev)
    return ColumnBatch(out)
