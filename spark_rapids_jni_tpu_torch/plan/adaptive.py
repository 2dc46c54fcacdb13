"""Adaptive round bounds for the slot table.

Counterpart of the two functions of ``spark_rapids_jni_tpu/plan/adaptive.py``
the ported path reads (the rest of the plan layer is ROADMAP.md queue 1,
item 8).  Both gate on the ``adaptive_execution`` knob; off means the
historical constants.
"""

from __future__ import annotations

from typing import Optional

from .. import config


def _enabled() -> bool:
    return bool(config.get("adaptive_execution"))


def bound_build_rounds(rows: int, num_slots: int) -> int:
    """Slot-table build round bound from the load factor ``rows / S``.

    Linear probing's expected chain grows like ``1 / (1 - load)``; the
    constants are generous so a healthy table never reaches the bound, and
    a truncated build only reports ``overflow``, after which the caller's
    sort fallback gives the same bits.  Off: ``min(S, 128)``.
    """
    cap = min(int(num_slots), 128)
    if not _enabled():
        return cap
    load = min(float(rows) / float(max(int(num_slots), 1)), 0.99)
    return max(1, min(cap, 16 + int(32.0 / max(1.0 - load, 1.0 / 32.0))))


def bound_probe_rounds(owner, n_build: int) -> Optional[int]:
    """Probe round bound: the built table's exact ``chain_bound`` when
    adaptive execution is on, else ``None`` (the full-table bound)."""
    if not _enabled():
        return None
    from ..relational.hashtable import chain_bound

    return chain_bound(owner, n_build)
