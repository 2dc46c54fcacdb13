"""Data-clustering indexes: DeltaLake ``interleave_bits`` and Hilbert index.

Counterpart of ``spark_rapids_jni_tpu/ops/zorder.py``.  Semantics from the
reference ``zorder.cu``:

* ``interleave_bits`` (zorder.cu:137): C same-type fixed-width columns ->
  per-row binary of ``C * sizeof(T)`` bytes.  Output bit k (MSB-first
  across the whole row) comes from column ``k % C`` (column 0 most
  significant), bit ``k // C`` of the value read big-endian.  Null values
  read as 0.
* ``hilbert_index`` (zorder.cu:224): C int32 columns,
  ``num_bits_per_entry`` bits each (``bits*C <= 64``) -> int64 Hilbert
  distance, Skilling's transpose algorithm (same lineage as the
  davidmoten/hilbert-curve library the reference tests compare
  against).  Null values read as 0.

Every loop bound (bit counts, dimensions) is static, so the loops unroll
into elementwise ops on [n] lanes: u32 values in int64 carriers
(:mod:`.._u32`), a value's raw bits in an int64 of its width.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .._u32 import M32
from ..columnar import types as T
from ..columnar.column import Column, StringColumn

_WIDTH = {T.Kind.BOOLEAN: 1, T.Kind.INT8: 1, T.Kind.INT16: 2,
          T.Kind.INT32: 4, T.Kind.DATE: 4, T.Kind.FLOAT32: 4,
          T.Kind.INT64: 8, T.Kind.TIMESTAMP: 8, T.Kind.FLOAT64: 8}


def _value_bits(col: Column):
    """(bits uint8[n, w*8] MSB-first, byte width) for a fixed-width
    column."""
    kind = col.dtype.kind
    if kind not in _WIDTH:
        raise NotImplementedError(f"interleave_bits over {col.dtype!r}")
    w = _WIDTH[kind]
    d = col.data
    if kind is T.Kind.FLOAT32:
        u = d.contiguous().view(torch.int32).to(torch.int64)
    elif kind is T.Kind.FLOAT64:
        u = d.contiguous().view(torch.int64)
    else:
        u = d.to(torch.int64)
    if w < 8:
        u = u & ((1 << (8 * w)) - 1)
    u = torch.where(col.validity, u, torch.zeros_like(u))
    nbits = 8 * w
    shifts = torch.arange(nbits - 1, -1, -1, dtype=torch.int64,
                          device=u.device)
    bits = ((u[:, None] >> shifts[None, :]) & 1).to(torch.uint8)
    return bits, w


def interleave_bits(columns: Sequence[Column]) -> StringColumn:
    """Byte-interleaved z-order key as a binary column (reference
    zorder.cu:137)."""
    if not columns:
        raise ValueError("interleave_bits requires at least one column")
    kinds = {c.dtype.kind for c in columns}
    if len(kinds) > 1:
        raise ValueError("all columns must share one type")
    per_col = [_value_bits(c) for c in columns]
    width = per_col[0][1]
    C = len(columns)
    n = columns[0].num_rows
    dev = columns[0].data.device
    # [n, C, nbits] -> [n, nbits, C] -> flat bit stream, column 0 first
    stacked = torch.stack([b for b, _ in per_col], dim=1)
    stream = stacked.transpose(1, 2).reshape(n, width * C, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    out_bytes = (stream.to(torch.int32) * weights).sum(dim=2).to(
        torch.uint8)
    lengths = torch.full((n,), width * C, dtype=torch.int32, device=dev)
    return StringColumn(out_bytes, lengths,
                        torch.ones((n,), dtype=torch.bool, device=dev))


def hilbert_index(num_bits_per_entry: int,
                  columns: Sequence[Column]) -> Column:
    """Hilbert distance of int32 points (reference zorder.cu:224).

    Skilling's algorithm on C u32 lanes: inverse-undo from the top bit
    down, gray encode, then bit-interleave the transposed index.
    """
    if not (0 < num_bits_per_entry <= 32):
        raise ValueError("num_bits_per_entry must be in (0, 32]")
    C = len(columns)
    if C * num_bits_per_entry > 64:
        raise ValueError("only up to 64 output bits supported")
    if C == 0:
        raise ValueError("at least one column is required")
    for c in columns:
        if c.dtype.kind is not T.Kind.INT32:
            raise ValueError("all columns must be INT32")
    n = columns[0].num_rows
    dev = columns[0].data.device
    mask_entry = (1 << num_bits_per_entry) - 1
    x = [torch.where(c.validity, c.data.to(torch.int64) & M32,
                     torch.zeros((), dtype=torch.int64, device=dev))
         & mask_entry for c in columns]

    M = 1 << (num_bits_per_entry - 1)
    q = M
    while q > 1:  # inverse undo (hilbert_transposed_index, zorder.cu:94)
        p = q - 1
        for i in range(C):
            hi = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0_new = torch.where(hi, x[0] ^ p, x[0] ^ t)
            xi_new = torch.where(hi, x[i], x[i] ^ t)
            # i == 0: the else-branch t is 0, both branches only touch x[0]
            x[0] = x0_new
            if i != 0:
                x[i] = xi_new
        q >>= 1

    for i in range(1, C):  # gray encode
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros((n,), dtype=torch.int64, device=dev)
    q = M
    while q > 1:
        t = torch.where((x[C - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x = [xi ^ t for xi in x]

    # to_hilbert_index (zorder.cu:75): interleave MSB-first, column 0
    # first
    b = torch.zeros((n,), dtype=torch.int64, device=dev)
    b_index = num_bits_per_entry * C - 1
    for i in range(num_bits_per_entry):
        mask = 1 << (num_bits_per_entry - 1 - i)
        for j in range(C):
            bit = ((x[j] & mask) != 0).to(torch.int64)
            b = b | (bit << b_index)
            b_index -= 1
    return Column(b, torch.ones((n,), dtype=torch.bool, device=dev),
                  T.INT64)
