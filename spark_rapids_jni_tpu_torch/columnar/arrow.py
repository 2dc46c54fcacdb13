"""Host-boundary interop: Arrow <-> ColumnBatch, and the data plane's
Arrow IPC codec.

Counterpart of ``spark_rapids_jni_tpu/columnar/arrow.py`` over pyarrow.
Arrow validity bitmasks expand to ``bool[n]`` tensors; ragged string
buffers pad into the char matrix (:class:`~.column.StringColumn`); an
Arrow dictionary array becomes a :class:`~.encoded.DictionaryColumn`
(codes stay codes) when the ``encoded_execution`` knob resolves on for
the target device.  :func:`batch_to_ipc` / :func:`ipc_to_batch` are a
bit-exact round trip (every column ships all-valid beside a ``<name>;v``
validity field, a dictionary column crosses as a dictionary and a
run-length column run-end encoded, never decoded); they are
:mod:`.arrow_ipc`'s, which needs no pyarrow.

This module imports pyarrow; nothing on the GPU path imports it
(``columnar`` loads it on first use of ``from_arrow`` / ``to_arrow`` /
``array_to_column``).
"""

from __future__ import annotations

import decimal as _d
from typing import Optional

import numpy as np
import pyarrow as pa
import torch

from ..device import resolve_device
from . import types as T
# the data plane's IPC codec, which needs no pyarrow
from .arrow_ipc import batch_to_ipc, ipc_to_batch  # noqa: F401
from .column import (Column, ColumnBatch, Decimal128Column, ListColumn,
                     StringColumn, StructColumn)

_ARROW_TO_SPARK = {
    pa.bool_(): T.BOOLEAN,
    pa.int8(): T.INT8,
    pa.int16(): T.INT16,
    pa.int32(): T.INT32,
    pa.int64(): T.INT64,
    pa.float32(): T.FLOAT32,
    pa.float64(): T.FLOAT64,
    pa.date32(): T.DATE,
    pa.timestamp("us"): T.TIMESTAMP,
    pa.timestamp("us", tz="UTC"): T.TIMESTAMP,
}

_NP_DTYPES = {T.Kind.BOOLEAN: np.bool_, T.Kind.INT8: np.int8,
              T.Kind.INT16: np.int16, T.Kind.INT32: np.int32,
              T.Kind.INT64: np.int64, T.Kind.FLOAT32: np.float32,
              T.Kind.FLOAT64: np.float64, T.Kind.DATE: np.int32,
              T.Kind.TIMESTAMP: np.int64}

# decimal128 needs more than the default 28-digit context
_DEC_CTX = _d.Context(prec=40)


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def unpack_bitmask(buf: Optional[pa.Buffer], offset: int, n: int
                   ) -> np.ndarray:
    """Arrow LSB-first validity bitmask -> bool[n]."""
    if buf is None:
        return np.ones((n,), dtype=np.bool_)
    bits = np.frombuffer(buf, dtype=np.uint8)
    expanded = np.unpackbits(bits, bitorder="little")
    return expanded[offset:offset + n].astype(np.bool_)


def segment_positions(lens: np.ndarray):
    """Flat ``(row_idx, within)`` indices of ragged segments."""
    lens = np.asarray(lens)
    total = int(lens.sum())
    row_idx = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return row_idx, within


def pack_bitmask(valid: np.ndarray) -> bytes:
    """bool[n] -> Arrow LSB-first packed bitmask bytes."""
    return np.packbits(valid.astype(np.uint8), bitorder="little").tobytes()


def _string_array_to_column(arr: pa.Array, dev,
                            pad_to_multiple: int = 8) -> StringColumn:
    if pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.string())
    elif pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.binary())
    n = len(arr)
    buffers = arr.buffers()
    valid = unpack_bitmask(buffers[0], arr.offset, n)
    offsets = np.frombuffer(buffers[1], dtype=np.int32)[
        arr.offset:arr.offset + n + 1]
    chars_flat = (np.frombuffer(buffers[2], dtype=np.uint8)
                  if buffers[2] is not None else np.zeros(0, np.uint8))
    lengths = np.where(valid, offsets[1:] - offsets[:-1], 0).astype(np.int32)
    max_len = int(lengths.max()) if n else 0
    max_len = max(1, -(-max(max_len, 1) // pad_to_multiple)
                  * pad_to_multiple)
    chars = np.zeros((n, max_len), dtype=np.uint8)
    if chars_flat.size:
        row_idx, within = segment_positions(lengths)
        chars[row_idx, within] = chars_flat[
            np.repeat(offsets[:-1], lengths) + within]
    return StringColumn(_t(chars, dev), _t(lengths, dev), _t(valid, dev))


def _decimal_array_to_column(arr: pa.Array, dev) -> Decimal128Column:
    t = arr.type
    n = len(arr)
    buffers = arr.buffers()
    valid = unpack_bitmask(buffers[0], arr.offset, n)
    raw = np.frombuffer(buffers[1], dtype=np.int64).reshape(-1, 2)
    return Decimal128Column(_t(raw[arr.offset:arr.offset + n], dev),
                            _t(valid, dev),
                            T.SparkType.decimal(t.precision, t.scale))


def _dictionary_array_to_column(arr: pa.Array, dev):
    """An Arrow dictionary array -> DictionaryColumn when encoded
    execution resolves on (else, or for an empty dictionary or one with
    nulls in it, the decoded column)."""
    from .encoded import dictionary_from_arrays, resolve_encoded_execution

    t = arr.type
    if (not resolve_encoded_execution(dev) or len(arr.dictionary) == 0
            or arr.dictionary.null_count):
        return array_to_column(arr.cast(t.value_type), dev)
    valid = np.asarray(arr.is_valid())
    codes = np.asarray(arr.indices.fill_null(0)).astype(np.int64)
    values = array_to_column(arr.dictionary, dev)
    return dictionary_from_arrays(codes, _t(valid, dev), values)


def array_to_column(arr, device=None):
    """One Arrow array or chunked array -> a column on ``device`` (the
    GPU by default)."""
    dev = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pa.types.is_dictionary(t):
        return _dictionary_array_to_column(arr, dev)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        n = len(arr)
        valid = unpack_bitmask(arr.buffers()[0], arr.offset, n)
        offsets64 = np.asarray(arr.offsets)[:n + 1].astype(np.int64)
        base = offsets64[0]
        child = arr.values.slice(base, offsets64[-1] - base)
        offsets = (offsets64 - base).astype(np.int32)
        lens = np.diff(offsets)
        if np.any(~valid & (lens > 0)):
            # a null row spans no elements in a ListColumn: repack
            keep_lens = np.where(valid, lens, 0)
            _, within = segment_positions(keep_lens)
            child = child.take(pa.array(
                np.repeat(offsets[:-1].astype(np.int64), keep_lens)
                + within))
            offsets = np.concatenate(
                [[0], np.cumsum(keep_lens)]).astype(np.int32)
        return ListColumn(_t(offsets, dev), array_to_column(child, dev),
                          _t(valid, dev))
    if pa.types.is_struct(t):
        n = len(arr)
        valid = unpack_bitmask(arr.buffers()[0], arr.offset, n)
        fields = {t.field(i).name: array_to_column(arr.field(i), dev)
                  for i in range(t.num_fields)}
        return StructColumn(fields, _t(valid, dev))
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return _string_array_to_column(arr, dev)
    if pa.types.is_decimal128(t) or pa.types.is_decimal(t):
        return _decimal_array_to_column(arr, dev)
    if pa.types.is_timestamp(t):
        if t.unit != "us":
            # Spark timestamps are micros: finer units truncate
            arr = arr.cast(pa.timestamp("us", tz=t.tz), safe=False)
        spark_t = T.SparkType(T.Kind.TIMESTAMP, tz=t.tz or "")
    else:
        spark_t = _ARROW_TO_SPARK.get(t)
    if spark_t is None:
        raise NotImplementedError(f"arrow type {t} not supported yet")
    n = len(arr)
    buffers = arr.buffers()
    valid = unpack_bitmask(buffers[0], arr.offset, n)
    if pa.types.is_boolean(t):
        data = unpack_bitmask(buffers[1], arr.offset, n)
    else:
        data = np.frombuffer(buffers[1], dtype=_NP_DTYPES[spark_t.kind])[
            arr.offset:arr.offset + n]
    return Column(_t(data, dev), _t(valid, dev), spark_t)


def from_arrow(table: pa.Table, device=None) -> ColumnBatch:
    """An Arrow table -> a batch on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    return ColumnBatch({name: array_to_column(table.column(name), dev)
                        for name in table.column_names})


def _decimal_values(col: Decimal128Column, vals) -> pa.Array:
    return pa.array(
        [None if v is None else _d.Decimal(v).scaleb(-col.scale, _DEC_CTX)
         for v in vals], type=pa.decimal128(col.precision, col.scale))


def _column_to_array(col) -> pa.Array:
    from .encoded import materialize_column

    col = materialize_column(col)  # an output boundary
    if isinstance(col, ListColumn):
        return pa.ListArray.from_arrays(
            pa.array(_np(col.offsets).astype(np.int32), type=pa.int32()),
            _column_to_array(col.child), mask=pa.array(~_np(col.validity)))
    if isinstance(col, StructColumn):
        return pa.StructArray.from_arrays(
            [_column_to_array(c) for c in col.children],
            names=list(col.field_names), mask=pa.array(~_np(col.validity)))
    if isinstance(col, StringColumn):
        return pa.array(col.to_pylist(), type=pa.string())
    if isinstance(col, Decimal128Column):
        return _decimal_values(col, col.to_pylist())
    data, mask = _np(col.data), ~_np(col.validity)
    if col.dtype.kind is T.Kind.DATE:
        return pa.array(data, type=pa.date32(), mask=mask)
    if col.dtype.kind is T.Kind.TIMESTAMP:
        return pa.array(data, type=pa.timestamp("us", tz=col.dtype.tz
                                                 or None), mask=mask)
    return pa.array(data, mask=mask)


def to_arrow(batch: ColumnBatch) -> pa.Table:
    """A batch -> an Arrow table (encoded columns materialize)."""
    return pa.table({name: _column_to_array(batch[name])
                     for name in batch.names})
