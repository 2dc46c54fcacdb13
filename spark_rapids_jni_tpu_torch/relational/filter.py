"""Filter: boolean-mask row selection with static-shape compaction.

Counterpart of ``spark_rapids_jni_tpu/relational/filter.py``: ``compact``
keeps the input length and returns ``(batch, count)`` with the selected
rows moved, stably, to the front and the tail nulled out.
"""

from __future__ import annotations

import torch

from ..columnar.column import ColumnBatch
from .gather import gather_batch


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

