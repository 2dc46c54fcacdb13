"""Relational operators on the port's column batches: radix keys, gather,
filter, sort, the slot hash table, group-by, joins and windows."""

from .aggregate import AggSpec, group_by, group_by_domain_or_sort
from .filter import apply_mask, compact
from .gather import gather_batch, gather_column
from .join import (SpillableBuildTable, hash_join, join_dense_or_hash,
                   spillable_build_table)
from .sort import SortKey, sort_by
from .window import WindowSpec, window

__all__ = ["AggSpec", "group_by", "group_by_domain_or_sort", "apply_mask",
           "compact", "gather_batch", "gather_column",
           "spillable_build_table", "SpillableBuildTable", "hash_join", "join_dense_or_hash", "SortKey", "sort_by",
           "WindowSpec", "window"]
