"""Open-addressing slot table over radix key words.

Counterpart of ``spark_rapids_jni_tpu/relational/hashtable.py``.  The hash
group-by and the hash join need a "which distinct key is this row"
primitive that does not sort:

* :func:`build_slot_table` — rows hash their u32 key words
  (:func:`fold_hash`) and linear-probe in synchronous rounds; each round
  EMPTY slots elect the minimum proposing row id, and rows whose
  candidate slot's owner has equal words retire.  Equal keys share a
  probe sequence, hence a slot; the owner is the first occurrence of the
  key in row order, the representative row the sort engine exposes.
* :func:`probe_slot_table` — the read-only walk: a probe row follows its
  chain until the owner's words match or an empty slot proves the key
  absent.

Both run through the kernels of :mod:`..ops.kernels` (the ``"kernel"``
engine; plain versions on CPU tensors), bit-identical to the reference's
``(owner, slot, overflow)`` and ``(found, slot)``.
"""

from __future__ import annotations

import torch

from ..ops import kernels as _K
from ..ops.kernels import fold_hash

__all__ = ["next_pow2", "fold_hash", "build_slot_table", "probe_slot_table",
           "chain_bound"]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def _engine(engine: str) -> None:
    if engine != "kernel":
        raise ValueError(f"unknown slot-table engine {engine!r} (the port "
                         "has one: 'kernel')")


def build_slot_table(words, live, num_slots: int, max_rounds=None,
                     engine: str = "kernel"):
    """Insert rows keyed by ``words`` into a ``num_slots`` table.

    Returns ``(owner int32[S], slot int32[n], overflow bool[])``; see
    :func:`..ops.kernels.slot_table_build`.
    """
    _engine(engine)
    return _K.slot_table_build(words, live, num_slots, max_rounds)


def probe_slot_table(owner, build_words, probe_words, live, max_rounds=None,
                     engine: str = "kernel"):
    """Look probe rows up in a built table; returns ``(found, slot)``
    (slot ``S`` for misses and dead rows)."""
    _engine(engine)
    return _K.slot_table_probe(owner, build_words, probe_words, live,
                               max_rounds)


def chain_bound(owner: torch.Tensor, n_build: int) -> int:
    """Exact probe-round bound of a built table: the longest circular run
    of occupied slots plus the empty slot that ends the walk, in
    ``[1, S]`` (``S`` when no slot is empty).  Any probe — hit or miss —
    ends within it, so it is result-identical to the full-table bound."""
    S = owner.shape[0]
    occ = owner != n_build
    occ2 = torch.cat([occ, occ])
    idx = torch.arange(2 * S, dtype=torch.int64, device=owner.device)
    last_empty = torch.cummax(torch.where(occ2, torch.full_like(idx, -1),
                                          idx), 0).values
    run = torch.where(occ2, idx - last_empty, torch.zeros_like(idx))
    longest = min(int(run.max().item()), S)
    return max(1, min(longest + 1, S))
