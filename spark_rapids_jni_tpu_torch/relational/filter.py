"""Filter: boolean-mask row selection with static-shape compaction.

Counterpart of ``spark_rapids_jni_tpu/relational/filter.py``: ``compact``
keeps the input length and returns ``(batch, count)`` with the selected
rows moved, stably, to the front and the tail nulled out;
``apply_mask`` nulls the unselected rows in place of moving them.
The encoded filters are part of this API: ``predicate_mask`` evaluates
a predicate over a dictionary's entries once and maps it to rows by
code, and ``packed_filter_mask`` compares bit-packed residuals against
the once-transformed literal without decoding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..columnar.column import ColumnBatch
from ..columnar.encoded import packed_filter_mask, predicate_mask
from .gather import gather_batch

__all__ = ["apply_mask", "compact", "packed_filter_mask", "predicate_mask",
           "selection_indices"]


def selection_indices(mask: torch.Tensor):
    """``(idx int64[n], count int64[])``: stable front-compaction of True
    rows; ``idx[:count]`` are the True rows' positions in order, the rest
    the False rows' positions in order."""
    n = mask.shape[0]
    mask = mask.to(torch.bool)
    count = mask.sum()
    sel_pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    unsel_pos = count + torch.cumsum((~mask).to(torch.int64), 0) - 1
    pos = torch.where(mask, sel_pos, unsel_pos)
    idx = torch.empty((n,), dtype=torch.int64, device=mask.device)
    idx[pos] = torch.arange(n, dtype=torch.int64, device=mask.device)
    return idx, count


def compact(batch: ColumnBatch, mask: torch.Tensor) -> tuple:
    """Move rows where ``mask`` is True to the front; null out the tail."""
    idx, count = selection_indices(mask)
    valid = torch.arange(idx.shape[0], device=idx.device) < count
    return gather_batch(batch, idx, valid), count


def apply_mask(batch: ColumnBatch, mask: torch.Tensor) -> ColumnBatch:
    """Null out rows where ``mask`` is False, moving nothing: shapes and
    row positions stay, so it costs one AND a column."""
    mask = mask.to(torch.bool)
    return ColumnBatch({
        name: dataclasses.replace(col, validity=col.validity & mask)
        for name, col in zip(batch.names, batch.columns)})
