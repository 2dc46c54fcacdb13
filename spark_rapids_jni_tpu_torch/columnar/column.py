"""Columns and column batches as torch tensors.

Counterpart of ``spark_rapids_jni_tpu/columnar/column.py``:

* :class:`Column` — a fixed-width column: ``data`` is a tensor of the
  type's torch dtype and ``validity`` a ``bool`` tensor, one lane per row;
* :class:`StringColumn` — a padded string column: ``chars uint8[n,
  max_len]`` (bytes past each row's length are zero), ``lengths
  int32[n]`` and ``validity``, the reference's bucketed-padding layout;
* :class:`Decimal128Column` — ``limbs int64[n, 2]``, the little-endian
  two's-complement 128-bit unscaled value bit for bit (the reference's
  ``uint64[n, 2]`` in the port's int64 carrier: torch's uint64 lacks
  most CUDA ops), with precision and scale on ``dtype``;
* :class:`ListColumn` — ``offsets int32[n + 1]`` into a child column;
  :class:`StructColumn` — named child columns and a struct validity.

Like the reference, operators keep static shapes where it matters to
them: filters and joins return padded batches plus a live-row count.

:func:`batch_from_numpy` carries a batch across from host arrays — the
form a reference ``ColumnBatch`` takes after ``np.asarray`` on each
buffer — so the same data can be fed to both packages.
:func:`string_arrays` builds a string column's host arrays from a small
table of distinct values and a code per row, without a Python string
per row.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import types as T


@dataclasses.dataclass
class Column:
    """Fixed-width column: ``data [n]`` + ``validity bool[n]``."""

    data: torch.Tensor
    validity: torch.Tensor
    dtype: T.SparkType

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self):
        return f"Column({self.dtype!r}, n={self.num_rows}, {self.data.device})"


@dataclasses.dataclass
class StringColumn:
    """Padded string column: ``chars uint8[n, max_len]`` (zero past each
    row's length), ``lengths int32[n]``, ``validity bool[n]``."""

    chars: torch.Tensor
    lengths: torch.Tensor
    validity: torch.Tensor
    dtype: T.SparkType = T.STRING

    @property
    def num_rows(self) -> int:
        return self.lengths.shape[0]

    @property
    def max_len(self) -> int:
        return self.chars.shape[1]

    @property
    def device(self) -> torch.device:
        return self.chars.device

    @staticmethod
    def from_pylist(values: Sequence[Optional[str]],
                    max_len: Optional[int] = None, pad_to_multiple: int = 1,
                    device=None) -> "StringColumn":
        """Build from host strings (UTF-8); ``None`` becomes a null.  The
        width rules are the reference's: ``max_len`` defaults to the
        longest value, rounds up to ``pad_to_multiple`` and is at least
        1.  ``device=None`` means the GPU."""
        encoded = [v.encode("utf-8") if v is not None else b""
                   for v in values]
        need = max((len(b) for b in encoded), default=0)
        if max_len is None:
            max_len = need
        if pad_to_multiple > 1:
            max_len = -(-max(max_len, 1) // pad_to_multiple) * pad_to_multiple
        max_len = max(max_len, 1)
        if need > max_len:
            raise ValueError(f"string of {need} bytes exceeds "
                             f"max_len={max_len}")
        chars = np.zeros((len(encoded), max_len), dtype=np.uint8)
        lengths = np.zeros((len(encoded),), dtype=np.int32)
        for i, b in enumerate(encoded):
            chars[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        return _string_column(chars, lengths, valid, resolve_device(device))

    def to_pylist(self) -> list:
        chars = self.chars.cpu().numpy()
        lengths = self.lengths.cpu().numpy()
        valid = self.validity.cpu().numpy()
        return [bytes(chars[i, :lengths[i]]).decode("utf-8", "replace")
                if valid[i] else None for i in range(lengths.shape[0])]

    def __repr__(self):
        return (f"StringColumn(n={self.num_rows}, max_len={self.max_len}, "
                f"{self.chars.device})")


@dataclasses.dataclass
class Decimal128Column:
    """Decimal column: ``limbs int64[n, 2]`` (``[:, 0]`` the low, ``[:,
    1]`` the high 64 bits of the two's-complement unscaled value) and
    ``validity bool[n]``; precision and scale ride on ``dtype``."""

    limbs: torch.Tensor
    validity: torch.Tensor
    dtype: T.SparkType

    @property
    def num_rows(self) -> int:
        return self.limbs.shape[0]

    @property
    def scale(self) -> int:
        return self.dtype.scale

    @property
    def precision(self) -> int:
        return self.dtype.precision

    @property
    def device(self) -> torch.device:
        return self.limbs.device

    @staticmethod
    def from_unscaled(unscaled: Sequence[Optional[int]], precision: int,
                      scale: int, device=None) -> "Decimal128Column":
        """Build from host Python ints (the unscaled values; ``None`` is
        a null).  ``device=None`` means the GPU."""
        limbs = np.zeros((len(unscaled), 2), dtype=np.uint64)
        valid = np.zeros((len(unscaled),), dtype=np.bool_)
        for i, v in enumerate(unscaled):
            if v is None:
                continue
            valid[i] = True
            u = v & ((1 << 128) - 1)
            limbs[i, 0] = u & ((1 << 64) - 1)
            limbs[i, 1] = u >> 64
        dev = resolve_device(device)
        return Decimal128Column(
            torch.from_numpy(limbs.view(np.int64)).to(dev),
            torch.from_numpy(valid).to(dev),
            T.SparkType.decimal(precision, scale))

    def to_pylist(self) -> list:
        """Unscaled Python ints, ``None`` for nulls."""
        limbs = self.limbs.cpu().numpy().view(np.uint64)
        valid = self.validity.cpu().numpy()
        out = []
        for i in range(limbs.shape[0]):
            if not valid[i]:
                out.append(None)
                continue
            u = (int(limbs[i, 1]) << 64) | int(limbs[i, 0])
            out.append(u - (1 << 128) if u >= 1 << 127 else u)
        return out

    def __repr__(self):
        return (f"Decimal128Column({self.dtype!r}, n={self.num_rows}, "
                f"{self.limbs.device})")


@dataclasses.dataclass
class ListColumn:
    """LIST column: ``offsets int32[n + 1]`` into ``child`` (row i's
    elements are ``child[offsets[i]:offsets[i + 1]]``; a null row is
    empty) and ``validity bool[n]``."""

    offsets: torch.Tensor
    child: object
    validity: torch.Tensor
    dtype: T.SparkType = None

    def __post_init__(self):
        if self.dtype is None:
            self.dtype = T.SparkType.list_of(self.child.dtype)

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def __repr__(self):
        return f"ListColumn({self.dtype!r}, n={self.num_rows})"


class StructColumn:
    """STRUCT column: named child columns of one length and a
    struct-level ``validity``."""

    def __init__(self, fields: Mapping[str, object], validity,
                 dtype: Optional[T.SparkType] = None):
        self._names = tuple(fields.keys())
        self._children = tuple(fields.values())
        self.validity = validity
        self.dtype = dtype or T.SparkType.struct_of(
            {k: v.dtype for k, v in fields.items()})

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def field_names(self):
        return self._names

    @property
    def children(self):
        return self._children

    def field(self, name: str):
        return self._children[self._names.index(name)]

    def __repr__(self):
        return f"StructColumn({self.dtype!r}, n={self.num_rows})"


AnyColumn = Union[Column, StringColumn, Decimal128Column, ListColumn,
                  StructColumn]


def _string_column(chars, lengths, valid, dev) -> StringColumn:
    return StringColumn(torch.from_numpy(chars).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        torch.from_numpy(valid).to(dev))


def string_arrays(values: Sequence[str], codes: np.ndarray,
                  max_len: Optional[int] = None):
    """Host ``(chars uint8[n, max_len], lengths int32[n])`` of the strings
    ``values[codes[i]]``: the small table is encoded once and rows take
    its rows by code, so n rows cost one numpy gather, not n Python
    strings.  The bytes are :meth:`StringColumn.from_pylist`'s for the
    same strings and ``max_len``."""
    enc = [v.encode("utf-8") for v in values]
    need = max((len(b) for b in enc), default=0)
    width = max(need if max_len is None else int(max_len), 1)
    if need > width:
        raise ValueError(f"string of {need} bytes exceeds max_len={width}")
    table = np.zeros((len(enc), width), dtype=np.uint8)
    tlen = np.zeros((len(enc),), dtype=np.int32)
    for i, b in enumerate(enc):
        table[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        tlen[i] = len(b)
    codes = np.asarray(codes)
    return table[codes], tlen[codes]


class ColumnBatch:
    """An ordered, named collection of equal-length columns."""

    def __init__(self, columns: Mapping[str, AnyColumn]):
        names = tuple(columns.keys())
        cols = tuple(columns.values())
        if cols:
            n = cols[0].num_rows
            for name, c in zip(names, cols):
                if c.num_rows != n:
                    raise ValueError(
                        f"column {name!r} has {c.num_rows} rows, expected {n}")
        self._names = names
        self._cols = cols

    @property
    def names(self):
        return self._names

    @property
    def columns(self):
        return self._cols

    @property
    def num_rows(self) -> int:
        return self._cols[0].num_rows if self._cols else 0

    def __getitem__(self, name: str) -> AnyColumn:
        try:
            return self._cols[self._names.index(name)]
        except ValueError:
            raise KeyError(name) from None

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({n: self[n] for n in names})

    def with_column(self, name: str, col: AnyColumn) -> "ColumnBatch":
        """This batch with ``name`` set to ``col`` (appended when new)."""
        d = dict(zip(self._names, self._cols))
        d[name] = col
        return ColumnBatch(d)

    def spillable(self, ctx=None, name: Optional[str] = None):
        """Register this batch with the spill store: a
        :class:`~..mem.spill.SpillableHandle` that can be demoted device
        -> host -> disk under pressure, charged to ``ctx`` when given.
        Drop the batch after this: the handle's ``get()`` is the live
        reference, and a spill frees the device memory only when nothing
        else holds the tensors."""
        from ..mem.spill import SpillableHandle

        return SpillableHandle(self, ctx=ctx, name=name)

    def __repr__(self):
        return f"ColumnBatch({list(self._names)}, n={self.num_rows})"


HostColumn = Tuple[object, np.ndarray, Union[str, T.SparkType]]


def _column_from_numpy(name, data, validity, typ, dev):
    st = typ if isinstance(typ, T.SparkType) else T.from_name(str(typ))
    # copies: the source may be a read-only view (a reference array)
    v = np.array(validity, dtype=np.bool_, order="C")
    if isinstance(data, dict) and "encoding" in data:
        from .encoded import encoded_from_host

        return encoded_from_host(name, data, torch.from_numpy(v).to(dev),
                                 st, dev, _column_from_numpy)
    if st.kind is T.Kind.STRING:
        chars, lengths = data
        c = np.array(chars, dtype=np.uint8, order="C")
        ln = np.array(lengths, dtype=np.int32, order="C")
        if c.ndim != 2 or ln.shape != v.shape or c.shape[0] != v.shape[0]:
            raise ValueError(f"column {name!r}: chars {c.shape}, lengths "
                             f"{ln.shape} and validity {v.shape} disagree")
        return _string_column(c, ln, v, dev)
    if st.kind is T.Kind.DECIMAL:
        limbs = np.array(data, order="C")
        if limbs.shape != v.shape + (2,) or limbs.itemsize != 8:
            raise ValueError(f"column {name!r}: limbs {limbs.shape} must "
                             f"be 64-bit [n, 2] beside validity {v.shape}")
        return Decimal128Column(
            torch.from_numpy(limbs.view(np.int64)).to(dev),
            torch.from_numpy(v).to(dev), st)
    if st.kind is T.Kind.LIST:
        offsets, child = data
        offs = np.array(offsets, dtype=np.int32, order="C")
        if offs.shape != (v.shape[0] + 1,):
            raise ValueError(f"column {name!r}: offsets {offs.shape} for "
                             f"{v.shape[0]} rows")
        return ListColumn(torch.from_numpy(offs).to(dev),
                          _column_from_numpy(name, *child, dev),
                          torch.from_numpy(v).to(dev), st)
    if st.kind is T.Kind.STRUCT:
        fields = {f: _column_from_numpy(f"{name}.{f}", *data[f], dev)
                  for f in st.field_names}
        return StructColumn(fields, torch.from_numpy(v).to(dev), st)
    d = np.array(data, order="C")
    if d.ndim != 1 or v.shape != d.shape:
        raise ValueError(f"column {name!r}: data {d.shape} and validity "
                         f"{v.shape} must be equal 1-D shapes")
    return Column(torch.from_numpy(d).to(device=dev, dtype=st.torch_dtype),
                  torch.from_numpy(v).to(dev), st)


def batch_from_numpy(cols: Mapping[str, HostColumn],
                     device: Optional[Union[str, torch.device]] = None
                     ) -> ColumnBatch:
    """Build a :class:`ColumnBatch` from ``{name: (data, validity, type)}``.

    ``type`` is a :class:`types.SparkType` or its name (``'int32'``,
    ``'string'``, ``'decimal(38,2)'``, ``'list<int64>'``, ... — the
    reference type's ``repr``).  ``data`` is the reference's host form,
    carried bit for bit: a fixed-width column's 1-D array; a string
    column's ``(chars uint8[n, max_len], lengths int32[n])``; a decimal
    column's ``uint64[n, 2]`` limbs; a list column's ``(offsets
    int32[n + 1], child)`` and a struct column's ``{field: child}``, each
    child a ``(data, validity, type)`` triple.  An encoded column's data
    is a dict naming its ``encoding`` (:mod:`.encoded`): ``dictionary``
    with ``codes`` (uint32[n]), ``canon`` (uint32[d] or None),
    ``dictionary`` (its own triple, or None) and ``token`` (equal tokens
    give equal port tokens); ``rle`` with ``run_values`` and
    ``run_lengths``; ``bitpacked`` with ``lanes`` (uint32), ``width``,
    ``reference`` and ``zone``; ``for`` with ``refs``, ``lanes``,
    ``width``, ``block`` and ``zone`` (a zone is None or a dict of
    ``mins``, ``maxs``, ``block``, ``rows``, ``crc`` and ``column``,
    carried as it is).  ``device=None`` means the GPU; without one this
    raises unless ``device='cpu'`` is passed.
    """
    dev = resolve_device(device)
    return ColumnBatch({name: _column_from_numpy(name, data, validity, typ,
                                                 dev)
                        for name, (data, validity, typ) in cols.items()})


def _column_to_numpy(c):
    from .encoded import encoded_to_host, is_encoded

    if is_encoded(c):
        return encoded_to_host(c, _column_to_numpy), c.validity.cpu().numpy()
    if isinstance(c, StringColumn):
        data = (c.chars.cpu().numpy(), c.lengths.cpu().numpy())
    elif isinstance(c, Decimal128Column):
        data = c.limbs.cpu().numpy().view(np.uint64)
    elif isinstance(c, ListColumn):
        data = (c.offsets.cpu().numpy(), _column_to_numpy(c.child))
    elif isinstance(c, StructColumn):
        data = {f: _column_to_numpy(ch)
                for f, ch in zip(c.field_names, c.children)}
    else:
        data = c.data.cpu().numpy()
    return data, c.validity.cpu().numpy()


def batch_to_numpy(batch: ColumnBatch) -> dict:
    """``{name: (data, validity)}`` host arrays in
    :func:`batch_from_numpy`'s forms (a list's child and a struct's
    fields as ``(data, validity)`` pairs)."""
    return {n: _column_to_numpy(c)
            for n, c in zip(batch.names, batch.columns)}
