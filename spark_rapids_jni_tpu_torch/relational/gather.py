"""Row gather for plain columns.

Counterpart of ``spark_rapids_jni_tpu/relational/gather.py``: one index
vector applied to each column's buffers; rows where ``valid`` is False
become nulls (padded filter and join outputs).  Encoded columns come
with ROADMAP.md queue 1, item 12.
"""

from __future__ import annotations

import torch

from .._roadmap import not_ported
from ..columnar.column import Column, ColumnBatch


def gather_column(col: Column, idx: torch.Tensor, valid=None) -> Column:
    """Take rows ``idx`` (clipped into range)."""
    if not isinstance(col, Column):
        raise not_ported(f"gather of {type(col).__name__}", 12)
    n = col.num_rows
    idx = idx.to(torch.int64).clamp(0, max(n - 1, 0))
    if n == 0:
        # nothing to take from: every output row is a null
        m = idx.shape[0]
        return Column(torch.zeros((m,), dtype=col.data.dtype,
                                  device=col.data.device),
                      torch.zeros((m,), dtype=torch.bool,
                                  device=col.data.device), col.dtype)
    v = col.validity[idx]
    if valid is not None:
        v = v & valid
    return Column(col.data[idx], v, col.dtype)


def gather_batch(batch: ColumnBatch, idx: torch.Tensor,
                 valid=None) -> ColumnBatch:
    return ColumnBatch({name: gather_column(col, idx, valid)
                        for name, col in zip(batch.names, batch.columns)})
