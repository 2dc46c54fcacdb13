"""Spillable partition buffers of the exchange: map output and round
chunks that demote instead of running out of memory.

Counterpart of ``spark_rapids_jni_tpu/shuffle/buffers.py``: each buffer
wraps one :class:`~..mem.spill.SpillableHandle` registered with the spill
store, so an exchange whose buffers exceed the device arena degrades the
reference's way (idle buffers walk device -> host -> disk under the
store's cross-task LRU order), and both the creation charge (to the
``ctx`` task) and the read-back run under
:func:`~..mem.executor.run_with_retry`: a ``RetryOOM`` evicts OTHER
buffers (earlier round chunks, the map output) instead of failing the
exchange.  ``recompute=`` is a buffer's lineage: when its spilled copy
is lost or fails its checksum the handle rebuilds it, through
:func:`store_recompute` first from the persistent store (:mod:`.store`)
and else by re-running the map or the round that made it.
"""

from __future__ import annotations

from typing import Callable, Optional

import dataclasses

import torch

from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)
from ..columnar.encoded import DictionaryColumn
from ..mem.executor import run_with_retry
from ..mem.spill import SpillableHandle


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


def store_recompute(adopt: Optional[Callable], rebuild: Callable,
                    on_adopt: Optional[Callable] = None,
                    on_rebuild: Optional[Callable] = None) -> Callable:
    """A ``recompute=`` closure that tries store ADOPTION before the
    lineage re-run.

    ``adopt`` asks the persistent shuffle store for a committed,
    CRC-verified copy of the buffer's tree; only when it answers None (no
    store, no committed attempt, or every attempt quarantined) does
    ``rebuild`` re-run.  A store FAILURE is treated as a miss: the
    durable tier speeds recovery up and is never a new way to lose a
    query.  ``on_adopt`` / ``on_rebuild`` are the accounting hooks
    (``ShuffleMetrics.record_adopted`` / ``record_lineage_rebuild``)."""
    def _recompute():
        tree = None
        if adopt is not None:
            try:
                tree = adopt()
            except Exception:  # noqa: BLE001 - a failed store is a miss
                tree = None
        if tree is not None:
            if on_adopt is not None:
                on_adopt()
            return tree
        if on_rebuild is not None:
            on_rebuild()
        return rebuild()

    return _recompute


class PartitionBuffer:
    """One spillable tree (a map output, or a received round chunk) with
    its creation and read-back under the retry ladder.  With no spill
    framework the handle still round-trips device <-> host on demand;
    with no ``ctx`` the arena is not charged.  ``nbytes`` is the tree's
    size for the exchange's byte accounting.  ``recompute=`` is the
    buffer's lineage, run by the handle when its spilled copy is lost or
    corrupt, so one damaged partition costs a partial re-map instead of
    the shuffle."""

    def __init__(self, tree, ctx=None, name: Optional[str] = None,
                 recompute=None):
        self.name = name
        self._ctx = ctx
        self.nbytes = tree_nbytes(tree)
        # the creation charge is the retryable unit: under pressure the
        # default make_spillable evicts idle handles and charges again
        self._handle = run_with_retry(
            lambda: SpillableHandle(tree, ctx=ctx, name=name,
                                    recompute=recompute))

    def get(self):
        """The device tree, promoted (and charged again) under the retry
        ladder if it was evicted."""
        return run_with_retry(self._handle.get)

    def pinned(self):
        return self._handle.pinned()

    def close(self) -> None:
        self._handle.close()


class MorselBuffer(PartitionBuffer):
    """One mapped morsel in flight: its rows and partition ids, alive
    only between the map step and the scatter into its round chunks
    (pinned throughout: it only charges the arena).  ``recompute=`` is
    its replay lineage: decode the source morsel and map it again."""


class RoundChunk(PartitionBuffer):
    """The send-side state of ONE streaming round: ``P * P * capacity``
    slot rows (sender-major, then destination-major) plus their
    occupancy, written in place scatter by scatter as morsels arrive.
    Between scatters it is an idle buffer the store may demote; a
    scatter pins it and writes into its promoted tensors.  Its lineage
    re-scatters every morsel contribution recorded so far into a fresh
    chunk, so a half-received round whose spilled copy is lost rebuilds
    exactly.  It stays open after its drain, to back the received
    chunk's re-drive, until the exchange closes it."""

    def update(self, tree, recompute=None) -> None:
        """Swap in a new tree under a fresh creation charge (the stale
        handle is closed first, so the arena never holds both)."""
        self._handle.close()
        self.nbytes = tree_nbytes(tree)
        self._handle = run_with_retry(
            lambda: SpillableHandle(tree, ctx=self._ctx, name=self.name,
                                    recompute=recompute))
