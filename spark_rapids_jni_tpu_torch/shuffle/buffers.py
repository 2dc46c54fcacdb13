"""Partition buffers of the exchange: map output and round chunks.

Counterpart of ``spark_rapids_jni_tpu/shuffle/buffers.py`` as RESIDENT
holders: a buffer keeps its tree of tensors on the device until it is
closed.  The reference registers each buffer with its spill store so
arena pressure demotes it device -> host -> disk, charges it to a task
context, and rebuilds a lost copy from map lineage; spill registration,
``ctx=`` charging, ``recompute=`` lineage and store adoption are
ROADMAP.md queue 1, item 13.
"""

from __future__ import annotations

from typing import Optional

import torch


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested tuple/list of tensors and
    batches."""
    from ..columnar.column import ColumnBatch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, ColumnBatch):
        return sum(tree_nbytes((c.data, c.validity)) for c in tree.columns)
    return sum(tree_nbytes(x) for x in tree)


class PartitionBuffer:
    """One resident tree (a map output, or a received round chunk)."""

    def __init__(self, tree, name: Optional[str] = None):
        self.name = name
        self._tree = tree
        self.nbytes = tree_nbytes(tree)

    def get(self):
        if self._tree is None:
            raise RuntimeError(f"buffer {self.name!r} is closed")
        return self._tree

    def close(self) -> None:
        self._tree = None


class MorselBuffer(PartitionBuffer):
    """One mapped morsel in flight: its regrouped rows and ``[P, P]``
    count matrix, alive only between the map step and the scatter into
    its round chunks."""


class RoundChunk(PartitionBuffer):
    """The send-side state of ONE streaming round: ``P * P * capacity``
    slot rows (sender-major, then destination-major) plus their
    occupancy, written in place scatter by scatter as morsels arrive."""
