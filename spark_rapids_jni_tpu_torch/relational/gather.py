"""Row gather for plain, string, decimal and encoded columns.

Counterpart of ``spark_rapids_jni_tpu/relational/gather.py``: one index
vector applied to each column's buffers (a string column's whole padded
char rows, a decimal column's limb pairs); rows where ``valid`` is False
become nulls (padded filter and join outputs), and a null string row's
length is zeroed as the reference does.  A dictionary column gathers its
codes and keeps its dictionary and token; a bit-packed column stays
packed (its reference survives any permutation); run-length and
frame-of-reference columns decode first (runs and blocks do not).
"""

from __future__ import annotations

import dataclasses

import torch

from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)
from ..columnar.encoded import (BitPackedColumn, DictionaryColumn,
                                FrameOfReferenceColumn, RunLengthColumn,
                                gather_bitpacked, pack_bits)


def gather_column(col, idx: torch.Tensor, valid=None):
    """Take rows ``idx`` (clipped into range)."""
    if isinstance(col, (RunLengthColumn, FrameOfReferenceColumn)):
        col = col.decode()
    if not isinstance(col, (Column, StringColumn, Decimal128Column,
                            DictionaryColumn, BitPackedColumn)):
        raise TypeError(f"gather of {type(col).__name__}")
    n = col.num_rows
    dev = col.device
    idx = idx.to(torch.int64).clamp(0, max(n - 1, 0))
    m = idx.shape[0]
    if n == 0:
        # nothing to take from: every output row is a null
        none = torch.zeros((m,), dtype=torch.bool, device=dev)
        zeros = torch.zeros((m,), dtype=torch.int64, device=dev)
        if isinstance(col, DictionaryColumn):
            return dataclasses.replace(col, codes=zeros.to(torch.int32),
                                       validity=none)
        if isinstance(col, BitPackedColumn):
            return dataclasses.replace(col, lanes=pack_bits(zeros, col.width),
                                       validity=none, zone=None)
        if isinstance(col, StringColumn):
            return StringColumn(
                torch.zeros((m, col.max_len), dtype=torch.uint8,
                            device=dev),
                torch.zeros((m,), dtype=torch.int32, device=dev), none,
                col.dtype)
        if isinstance(col, Decimal128Column):
            return Decimal128Column(
                torch.zeros((m, 2), dtype=torch.int64, device=dev), none,
                col.dtype)
        return Column(torch.zeros((m,), dtype=col.data.dtype, device=dev),
                      none, col.dtype)
    if isinstance(col, BitPackedColumn):
        return gather_bitpacked(col, idx, valid)
    v = col.validity[idx]
    if valid is not None:
        v = v & valid
    if isinstance(col, DictionaryColumn):
        return dataclasses.replace(col, codes=col.codes[idx], validity=v)
    if isinstance(col, StringColumn):
        return StringColumn(col.chars[idx], col.lengths[idx] * v, v,
                            col.dtype)
    if isinstance(col, Decimal128Column):
        return Decimal128Column(gather_limbs(col.limbs, idx), v, col.dtype)
    return Column(col.data[idx], v, col.dtype)


def gather_limbs(limbs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``limbs[idx]`` for decimal limbs int64[n, 2], as one gather per
    limb column: torch's gather of whole 16-byte rows took 10.1 ms for
    2^24 rows on the H100, the two column gathers about 1 ms (PERF.md
    §5, ``trace_port.py --only decimal``)."""
    return torch.stack([limbs[:, 0][idx], limbs[:, 1][idx]], dim=1)


def gather_batch(batch: ColumnBatch, idx: torch.Tensor,
                 valid=None) -> ColumnBatch:
    return ColumnBatch({name: gather_column(col, idx, valid)
                        for name, col in zip(batch.names, batch.columns)})
