"""Spark-exact shuffle partition assignment and the local regroup.

Counterpart of ``spark_rapids_jni_tpu/parallel/partition.py``: Spark's
``HashPartitioning`` is ``Pmod(Murmur3Hash(keys, 42), P)`` over any key
column the row hash takes (plain and string columns), and the local leg
of an exchange orders rows by partition id with a stable sort.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar.column import ColumnBatch
from ..ops.hashing import murmur_hash3_32
from ..relational.gather import gather_column
from ..relational.keys import lexsort


def spark_partition_id(key_columns: Sequence, num_partitions: int,
                       row_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """int32[n] partition ids in ``[0, P)``; rows where ``row_valid`` is
    False get ``P`` (the pseudo-partition an exchange drops or sends
    last)."""
    h = murmur_hash3_32(key_columns, seed=42).data.to(torch.int64)
    # Spark's pmod: torch.remainder takes the divisor's sign, as jnp's % does
    pid = torch.remainder(h, int(num_partitions))
    if row_valid is not None:
        pid = torch.where(row_valid, pid,
                          torch.full_like(pid, int(num_partitions)))
    return pid.to(torch.int32)


def regroup_order(pid: torch.Tensor, num_slots: int,
                  secondary: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Stable permutation ordering rows by partition id (then by the
    ``secondary`` key words, when given) — ``argsort(pid, stable=True)``.

    ``pid`` must lie in ``[0, num_slots)``.  The reference's counting-sort
    engine is not a bijection for pids outside that range; the port
    rejects them instead (one host read of the range check).
    """
    pid = pid.to(torch.int64)
    if pid.numel():
        lo, hi = int(pid.min().item()), int(pid.max().item())
        if lo < 0 or hi >= int(num_slots):
            raise ValueError(f"partition ids must lie in [0, {num_slots}); "
                             f"got [{lo}, {hi}]")
    if secondary:
        return lexsort([pid] + list(secondary))
    return torch.sort(pid, stable=True).indices


def exchange_local(b: ColumnBatch, key: str, live: torch.Tensor,
                   partitions: int, secondary=None) -> ColumnBatch:
    """The local leg of a shuffle (the reference's ``_exchange_local`` in
    ``__graft_entry__.py`` and ``plan/compile.py``): Spark-exact
    partition ids, then a stable regroup by pid.  Dead rows get the
    pseudo-partition P and go last, so live rows stay compacted in front
    and an ``arange < count`` mask stays valid after the regroup."""
    pid = spark_partition_id([b[key]], partitions, live)
    order = regroup_order(pid, partitions + 1, secondary=secondary)
    return ColumnBatch({name: gather_column(col, order)
                        for name, col in zip(b.names, b.columns)})
