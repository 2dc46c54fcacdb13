"""JCUDF row ⇄ columnar transpose.

Counterpart of ``spark_rapids_jni_tpu/ops/row_conversion.py``.  The row
format (documented in reference ``RowConversion.java:57-116``, and
produced by ``row_conversion.cu``):

* columns laid out in order, each aligned to its own byte width (padding
  in front); little-endian values.
* a string column occupies an 8-byte ``(offset int32, length int32)`` slot
  in the fixed-width area (``row_conversion.cu:1337``); its bytes live in
  a variable region after the validity bytes, packed in column order.
* validity bytes right after the last fixed slot (no alignment gap): one
  byte per 8 columns, bit ``c % 8`` of byte ``c // 8`` (set = non-null).
* each row padded to an 8-byte boundary.

The row image is a ``uint8[n, row_width]`` matrix.  A fixed-width
column's little-endian bytes are its tensor's own bytes (a ``view`` as
``uint8``: CPUs and CUDA devices are little-endian), copied into their
slot as one strided write; reading back is the inverse view, which also
sign-extends.  The string region is assembled *gather-wise*: for each
string column the destination is a per-row offset, so for every byte
position of the variable region we compute which source byte lands there
(a gather per string column + masked select).  The reference's 2GB batch
splitting is :func:`convert_to_rows_batched`; one call of
:func:`convert_to_rows` produces one batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..columnar import types as T
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)

_WIDTH = {
    T.Kind.BOOLEAN: 1,
    T.Kind.INT8: 1,
    T.Kind.INT16: 2,
    T.Kind.INT32: 4,
    T.Kind.DATE: 4,
    T.Kind.FLOAT32: 4,
    T.Kind.INT64: 8,
    T.Kind.TIMESTAMP: 8,
    T.Kind.FLOAT64: 8,
}
# the signed carrier a slot of each width is read back through
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _col_width(col) -> int:
    if isinstance(col, StringColumn):
        return 8  # (offset, length) pair
    if isinstance(col, Decimal128Column):
        if col.dtype.decimal_storage_bits == 128:
            return 16
        return col.dtype.decimal_storage_bits // 8
    return _WIDTH[col.dtype.kind]


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def layout_from_widths(widths: Sequence[int]
                       ) -> Tuple[List[int], int, int, int]:
    """(per-column offsets, validity offset, fixed end, #validity bytes) —
    the single source of the JCUDF alignment rule."""
    off = 0
    offsets = []
    for w in widths:
        off = _align(off, min(w, 8))
        offsets.append(off)
        off += w
    validity_off = off
    nv = -(-len(widths) // 8)
    return offsets, validity_off, validity_off + nv, nv


def row_layout(cols: Sequence) -> Tuple[List[int], int, int, int]:
    return layout_from_widths([_col_width(c) for c in cols])


def _le_bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-D (or [n, k]) tensor's little-endian bytes as ``uint8[n, w]``."""
    n = t.shape[0]
    t = t.contiguous()
    if t.numel() and t.stride(-1) != 1:  # a one-row slice of a wider row
        t = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return t.view(torch.uint8).reshape(n, -1)


def _fixed_bytes(col, w: int) -> torch.Tensor:
    """The ``w`` little-endian bytes a fixed-width column stores."""
    if isinstance(col, Decimal128Column):
        if w == 16:
            return _le_bytes(col.limbs)
        return _le_bytes(col.limbs[:, 0])[:, :w]  # the low limb's bytes
    if col.dtype.kind is T.Kind.BOOLEAN:
        return col.data.to(torch.uint8)[:, None]
    return _le_bytes(col.data)


def convert_to_rows(batch: ColumnBatch, row_valid=None) -> StringColumn:
    """Table -> JCUDF rows as a binary column (reference
    ``convert_to_rows``, row_conversion.cu:1990)."""
    cols = batch.columns
    n = batch.num_rows
    dev = cols[0].validity.device
    i32 = torch.int32
    offsets, validity_off, fixed_end, nv = row_layout(cols)

    string_cols = [c for c in cols if isinstance(c, StringColumn)]
    var_cap = sum(c.max_len for c in string_cols)
    width = _align(fixed_end + var_cap, 8)

    out = torch.zeros((n, width), dtype=torch.uint8, device=dev)

    # --- per-row string placement (lengths of nulls count as 0) ----------
    str_lens = [torch.where(c.validity, c.lengths.to(i32),
                            torch.zeros((), dtype=i32, device=dev))
                for c in string_cols]
    starts = []
    cur = torch.full((n,), fixed_end, dtype=i32, device=dev)
    for ln in str_lens:
        starts.append(cur)
        cur = cur + ln
    row_len = (cur + 7) // 8 * 8

    # --- fixed-width slots ----------------------------------------------
    si = 0
    for c, off in zip(cols, offsets):
        if isinstance(c, StringColumn):
            pair = torch.stack([starts[si], str_lens[si]], dim=1)
            out[:, off: off + 8] = _le_bytes(pair)
            si += 1
        else:
            w = _col_width(c)
            out[:, off: off + w] = _fixed_bytes(c, w)

    # --- validity bytes --------------------------------------------------
    for b in range(nv):
        byte = torch.zeros((n,), dtype=torch.uint8, device=dev)
        for c_idx in range(8 * b, min(8 * b + 8, len(cols))):
            byte = byte | (cols[c_idx].validity.to(torch.uint8)
                           << (c_idx % 8))
        out[:, validity_off + b] = byte

    # --- string bytes (gather formulation, over the variable region) ----
    if string_cols and width > fixed_end:
        j = torch.arange(fixed_end, width, dtype=i32, device=dev)[None, :]
        acc = torch.zeros((n, width - fixed_end), dtype=torch.uint8,
                          device=dev)
        for c, st, ln in zip(string_cols, starts, str_lens):
            src = j - st[:, None]  # position within this column's string
            inside = (src >= 0) & (src < ln[:, None])
            gathered = torch.gather(
                c.chars, 1, src.clamp(0, max(c.max_len - 1, 0)).long())
            acc = torch.where(inside, gathered, acc)
        out[:, fixed_end:] = acc

    if row_valid is None:
        return StringColumn(out, row_len,
                            torch.ones((n,), dtype=torch.bool, device=dev))
    return StringColumn(out, torch.where(row_valid, row_len,
                                         torch.zeros_like(row_len)),
                        row_valid)


def _read_int(rows: torch.Tensor, off: int, width: int) -> torch.Tensor:
    """The signed little-endian ``width``-byte value at a static offset,
    sign-extended to int64."""
    n = rows.shape[0]
    raw = rows[:, off: off + width].contiguous().view(
        _INT_OF_WIDTH[width]).reshape(n)
    return raw.to(torch.int64)


def _read_kind(rows, off: int, dtype: T.SparkType, width: int):
    n = rows.shape[0]
    kind = dtype.kind
    if kind is T.Kind.BOOLEAN:
        return (rows[:, off] & 1).to(torch.bool)
    raw = rows[:, off: off + width].contiguous()
    if kind in (T.Kind.FLOAT32, T.Kind.FLOAT64):
        return raw.view(dtype.torch_dtype).reshape(n)
    return raw.view(_INT_OF_WIDTH[width]).reshape(n).to(dtype.torch_dtype)


def _schema_width(dtype: T.SparkType) -> int:
    if dtype.kind is T.Kind.STRING:
        return 8
    if dtype.kind is T.Kind.DECIMAL:
        return (16 if dtype.decimal_storage_bits == 128
                else dtype.decimal_storage_bits // 8)
    return _WIDTH[dtype.kind]


def convert_from_rows(rows: StringColumn, schema: dict) -> ColumnBatch:
    """JCUDF rows -> table (reference ``convert_from_rows``,
    row_conversion.cu:2145).  ``schema``: name -> SparkType (+ for
    strings, use ``(SparkType, max_len)`` to bound the padded width)."""
    data = rows.chars
    dev = data.device
    descs = []
    for name, spec in schema.items():
        dtype, ml = spec if isinstance(spec, tuple) else (spec, 0)
        descs.append((name, dtype, ml))

    offsets, validity_off, _, _ = layout_from_widths(
        [_schema_width(dtype) for _, dtype, _ in descs])

    out = {}
    for i, ((name, dtype, max_len), coff) in enumerate(zip(descs, offsets)):
        vbyte = data[:, validity_off + i // 8]
        valid = ((vbyte >> (i % 8)) & 1).to(torch.bool)
        if dtype.kind is T.Kind.STRING:
            pair = data[:, coff: coff + 8].contiguous().view(
                torch.int32).reshape(-1, 2)
            s_off, s_len = pair[:, 0], pair[:, 1]
            ml = max(max_len, 1)
            cols = torch.arange(ml, dtype=torch.int32, device=dev)[None, :]
            idx = (s_off[:, None] + cols).clamp(0, data.shape[1] - 1)
            chars = torch.gather(data, 1, idx.long())
            chars = torch.where(cols < s_len[:, None], chars,
                                torch.zeros_like(chars))
            out[name] = StringColumn(chars, s_len * valid, valid)
        elif dtype.kind is T.Kind.DECIMAL:
            w = _schema_width(dtype)
            if w == 16:
                limbs = data[:, coff: coff + 16].contiguous().view(
                    torch.int64).reshape(-1, 2)
            else:  # sign-extend the 4/8-byte slot into two limbs
                lo = _read_int(data, coff, w)
                limbs = torch.stack([lo, lo >> 63], dim=1)
            out[name] = Decimal128Column(limbs, valid, dtype)
        else:
            w = _schema_width(dtype)
            out[name] = Column(_read_kind(data, coff, dtype, w), valid, dtype)
    return ColumnBatch(out)


# ---------------------------------------------------------------------------
# batching + the fixed-width-optimized entry (reference RowConversion.java)
# ---------------------------------------------------------------------------

MAX_BATCH_BYTES = (1 << 31) - 8  # one output batch stays under 2GB
FIXED_OPT_MAX_COLS = 100         # RowConversion.java:32-33
FIXED_OPT_MAX_ROW_BYTES = 1024   # RowConversion.java:115-116


def _slice_col(col, lo: int, hi: int):
    if isinstance(col, StringColumn):
        return StringColumn(col.chars[lo:hi], col.lengths[lo:hi],
                            col.validity[lo:hi], col.dtype)
    if isinstance(col, Decimal128Column):
        return Decimal128Column(col.limbs[lo:hi], col.validity[lo:hi],
                                col.dtype)
    return dataclasses.replace(col, data=col.data[lo:hi],
                               validity=col.validity[lo:hi])


def convert_to_rows_fixed_width_optimized(batch: ColumnBatch,
                                          row_valid=None) -> StringColumn:
    """The <100-column, <=1KB-row fast-path entry.

    Mirrors the reference's separate optimized kernel contract
    (``convert_to_rows_fixed_width_optimized``, ``row_conversion.cu:2053``;
    limits from ``RowConversion.java:32-33,115-116``).  A string-free
    layout is already a set of aligned byte copies here, so this entry
    enforces the contract and runs :func:`convert_to_rows`.
    """
    cols = batch.columns
    if len(cols) >= FIXED_OPT_MAX_COLS:
        raise ValueError(
            f"fixed-width-optimized path requires <{FIXED_OPT_MAX_COLS} "
            f"columns, got {len(cols)}")
    for name, col in zip(batch.names, cols):
        if isinstance(col, StringColumn):
            raise ValueError(
                f"fixed-width-optimized path cannot handle string column "
                f"{name!r}")
    _, _, fixed_end, _ = row_layout(cols)
    row_bytes = _align(fixed_end, 8)
    if row_bytes > FIXED_OPT_MAX_ROW_BYTES:
        raise ValueError(
            f"fixed-width-optimized path caps rows at "
            f"{FIXED_OPT_MAX_ROW_BYTES}B, layout needs {row_bytes}B")
    return convert_to_rows(batch, row_valid=row_valid)


def convert_to_rows_batched(batch: ColumnBatch,
                            max_batch_bytes: int = MAX_BATCH_BYTES) -> list:
    """Split the input so each output row image stays under the byte cap.

    The reference's ``build_batches`` (``row_conversion.cu:1458``): one
    cudf LIST<INT8> column is capped at 2GB of child data, so conversions
    of big tables must emit multiple batches.  Splitting happens on the
    input row axis with a worst-case per-row byte bound (fixed layout +
    each string column's max_len).
    """
    n = batch.num_rows
    cols = batch.columns
    _, _, fixed_end, _ = row_layout(cols)
    # the actual row image width: fixed area + worst-case string bytes,
    # padded to 8 as convert_to_rows does
    worst_row = _align(fixed_end + sum(c.max_len for c in cols
                                       if isinstance(c, StringColumn)), 8)
    worst_row = max(worst_row, 1)
    rows_per_batch = max(1, int(max_batch_bytes // worst_row))
    out = []
    for lo in range(0, max(n, 1), rows_per_batch):
        hi = min(lo + rows_per_batch, n)
        piece = ColumnBatch({name: _slice_col(col, lo, hi)
                             for name, col in zip(batch.names, cols)})
        out.append(convert_to_rows(piece))
    return out


def convert_from_rows_batched(row_batches: list, schema) -> ColumnBatch:
    """Inverse of :func:`convert_to_rows_batched`: concatenate batches."""
    parts = [convert_from_rows(rb, schema) for rb in row_batches]
    if len(parts) == 1:
        return parts[0]
    out = {}
    for name in parts[0].names:
        cols = [p[name] for p in parts]
        c0 = cols[0]
        if isinstance(c0, StringColumn):
            width = max(c.max_len for c in cols)
            chars = torch.cat([torch.nn.functional.pad(
                c.chars, (0, width - c.max_len)) for c in cols])
            out[name] = StringColumn(
                chars, torch.cat([c.lengths for c in cols]),
                torch.cat([c.validity for c in cols]), c0.dtype)
        elif isinstance(c0, Decimal128Column):
            out[name] = Decimal128Column(
                torch.cat([c.limbs for c in cols]),
                torch.cat([c.validity for c in cols]), c0.dtype)
        else:
            out[name] = dataclasses.replace(
                c0, data=torch.cat([c.data for c in cols]),
                validity=torch.cat([c.validity for c in cols]))
    return ColumnBatch(out)
