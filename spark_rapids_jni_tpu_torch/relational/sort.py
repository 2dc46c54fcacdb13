"""Multi-key stable sort over order-preserving radix keys.

Counterpart of ``spark_rapids_jni_tpu/relational/sort.py``: per-key
ascending/descending and nulls first/last, Spark's order.  Each key
lowers to its null flag and data words (:mod:`keys`, ordering domain:
``-0.0 < 0.0``, one NaN, greatest); null rows' data words are zeroed so
nulls keep their input order; a descending key complements every word,
its null flag included.  The permutation is the stable lexicographic
one (:func:`keys.lexsort_u32`, chained stable ``torch.sort`` passes),
as the reference's ``lax.sort(..., is_stable=True)`` gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .._u32 import M32
from ..columnar.column import ColumnBatch
from . import keys as K
from .gather import gather_batch


@dataclasses.dataclass(frozen=True)
class SortKey:
    name: str
    ascending: bool = True
    nulls_first: bool = True


def sort_words(batch: ColumnBatch, sort_keys: Sequence[SortKey]) -> list:
    """The u32 words whose lexicographic order is the sort's."""
    ops = []
    for sk in sort_keys:
        col = batch[sk.name]
        # a descending key complements its flag too, so place the flag
        # for the ascending order
        flag_first = sk.nulls_first if sk.ascending else not sk.nulls_first
        arrays = [K.null_flag(col, flag_first)] + [
            torch.where(col.validity, k, torch.zeros_like(k))
            for k in K.column_radix_keys(col, equality=False)]
        if not sk.ascending:
            arrays = [a ^ M32 for a in arrays]
        ops.extend(arrays)
    return ops


def sort_permutation(batch: ColumnBatch,
                     sort_keys: Sequence[SortKey]) -> torch.Tensor:
    """int64[n] stable permutation ordering the batch by ``sort_keys``."""
    return K.lexsort_u32(sort_words(batch, sort_keys))


def sort_by(batch: ColumnBatch, sort_keys: Sequence[SortKey]) -> ColumnBatch:
    return gather_batch(batch, sort_permutation(batch, sort_keys))
