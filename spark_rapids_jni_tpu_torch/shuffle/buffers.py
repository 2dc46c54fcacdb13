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

import dataclasses

import torch

from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)
from ..columnar.encoded import DictionaryColumn


def column_leaves(col) -> list:
    """A column's fixed leaf list, the tensors the exchange moves row by
    row: ``[data, validity]``; a string column's ``[chars, lengths,
    validity]``; a decimal column's ``[limbs, validity]``; a dictionary
    column's ``[codes, validity]`` (its dictionary crosses once, beside
    the rounds).  Run-length and packed columns decode before they
    cross.  A list's offsets do not shard by row, so nested columns do
    not cross (the reference's row gather has no nested branch
    either)."""
    if isinstance(col, StringColumn):
        return [col.chars, col.lengths, col.validity]
    if isinstance(col, Decimal128Column):
        return [col.limbs, col.validity]
    if isinstance(col, DictionaryColumn):
        return [col.codes, col.validity]
    if isinstance(col, Column):
        return [col.data, col.validity]
    if getattr(col, "dtype", None) is not None and col.dtype.is_nested:
        raise NotImplementedError(
            f"exchanging a {col.dtype!r} column: a list's offsets do not "
            "shard by row")
    raise TypeError(f"exchanging a {type(col).__name__}")


def batch_leaves(batch: ColumnBatch) -> list:
    """Every column's :func:`column_leaves`, in column order."""
    return [t for c in batch.columns for t in column_leaves(c)]


def rebatch(like: ColumnBatch, leaves) -> ColumnBatch:
    """A batch of ``like``'s schema over :func:`batch_leaves`-ordered
    ``leaves``."""
    out, at = {}, 0
    for name, c in zip(like.names, like.columns):
        if isinstance(c, StringColumn):
            out[name] = StringColumn(*leaves[at:at + 3], c.dtype)
            at += 3
        elif isinstance(c, Decimal128Column):
            out[name] = Decimal128Column(*leaves[at:at + 2], c.dtype)
            at += 2
        elif isinstance(c, DictionaryColumn):
            out[name] = dataclasses.replace(c, codes=leaves[at],
                                            validity=leaves[at + 1])
            at += 2
        else:
            out[name] = Column(*leaves[at:at + 2], c.dtype)
            at += 2
    return ColumnBatch(out)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested tuple/list of tensors and
    batches."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, ColumnBatch):
        return tree_nbytes(batch_leaves(tree))
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
