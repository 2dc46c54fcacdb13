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
  absent.  A table probed more than once keeps its slot records
  (:func:`slot_records`: owner and words per slot, and the chain bound,
  built once) and probes them with :func:`probe_slot_records`.

They run through the kernels of :mod:`..ops.kernels` (the ``"kernel"``
engine; plain versions on CPU tensors), bit-identical to the reference's
``(owner, slot, overflow)`` and ``(found, slot)``.
"""

from __future__ import annotations

from ..ops import kernels as _K
from ..ops.kernels import SlotRecords, chain_bound, fold_hash

__all__ = ["next_pow2", "fold_hash", "build_slot_table", "probe_slot_table",
           "slot_records", "probe_slot_records", "SlotRecords",
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


def slot_records(owner, build_words, engine: str = "kernel") -> SlotRecords:
    """A built table's slot records and chain bound, to keep with the
    table; see :func:`..ops.kernels.slot_table_records`."""
    _engine(engine)
    return _K.slot_table_records(owner, build_words)


def probe_slot_records(records: SlotRecords, probe_words, live,
                       max_rounds=None, engine: str = "kernel"):
    """:func:`probe_slot_table` over kept records: ``(found, slot)``, the
    walk bounded by ``max_rounds`` and the records' chain bound."""
    _engine(engine)
    return _K.slot_table_probe_records(records, probe_words, live,
                                       max_rounds)
