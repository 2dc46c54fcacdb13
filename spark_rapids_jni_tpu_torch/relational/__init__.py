"""Relational operators on the port's column batches: radix keys, gather,
filter, the slot hash table, group-by and joins."""

from .aggregate import AggSpec, group_by, group_by_domain_or_sort
from .filter import compact
from .gather import gather_batch, gather_column
from .join import hash_join, join_dense_or_hash

__all__ = ["AggSpec", "group_by", "group_by_domain_or_sort", "compact",
           "gather_batch", "gather_column", "hash_join",
           "join_dense_or_hash"]
