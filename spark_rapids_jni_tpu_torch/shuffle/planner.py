"""Skew-aware round planning: one cheap counts pass decides the shape.

Counterpart of ``spark_rapids_jni_tpu/shuffle/planner.py`` (copied:
``RoundPlan``, ``plan_rounds``, ``plan_stream_capacity``).  The map
step's per-(sender, destination) count matrix comes back to the host
once, and :func:`plan_rounds` turns it into a static execution shape —
how many rounds, at what per-bucket slot capacity — that is lossless
(``rounds * capacity >= max bucket``) without sizing the slot grid for
the worst case.  The two-hop hierarchical plan comes with ROADMAP.md
queue 1, item 11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class RoundPlan:
    """Static shape for one multi-round exchange."""

    rounds: int          # all_to_all rounds to drain every bucket
    capacity: int        # slot rows per (sender, destination) per round
    max_bucket: int      # largest (sender, destination) count observed
    total_rows: int      # rows routed to real partitions (excludes padding)
    skew_ratio: float    # max_bucket / mean nonzero-grid bucket

    @property
    def lossless(self) -> bool:
        return self.rounds * self.capacity >= self.max_bucket


def _round_up(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def plan_rounds(
    counts,
    round_rows: Optional[int] = None,
    bucket: Optional[int] = None,
    max_rounds: Optional[int] = None,
) -> RoundPlan:
    """Turn a ``[P, P]`` (sender, destination) count matrix into a
    :class:`RoundPlan`.

    * fits one round (``max bucket <= round_rows``): a single exchange at
      the bucket-rounded max — identical shape to the legacy
      ``plan_exchange_capacity`` path, so compiled programs are shared.
    * bigger: capacity is the bucket-rounded ``round_rows`` budget and the
      round count is whatever drains the biggest bucket.  ``max_rounds``
      caps the loop by RAISING capacity (never by dropping rows): the
      plan is lossless by construction.

    Defaults come from the config registry: ``shuffle_round_rows``,
    ``shuffle_capacity_bucket``, ``shuffle_max_rounds``.
    """
    from .. import config

    if round_rows is None:
        round_rows = int(config.get("shuffle_round_rows"))
    if bucket is None:
        bucket = int(config.get("shuffle_capacity_bucket"))
    if max_rounds is None:
        max_rounds = int(config.get("shuffle_max_rounds"))
    if round_rows <= 0 or bucket <= 0 or max_rounds <= 0:
        raise ValueError("round_rows, bucket, max_rounds must be positive")

    c = np.asarray(counts)
    cmax = int(c.max()) if c.size else 0
    total = int(c.sum()) if c.size else 0
    # mean over the WHOLE grid: all rows hashing to one destination reads
    # as skew P even though each nonzero bucket is the same size
    mean = total / c.size if c.size else 0.0
    skew = cmax / mean if mean > 0 else 0.0

    if cmax == 0:
        return RoundPlan(1, bucket, 0, 0, 0.0)
    if cmax <= round_rows:
        return RoundPlan(1, _round_up(cmax, bucket), cmax, total, skew)
    cap = _round_up(round_rows, bucket)
    rounds = -(-cmax // cap)
    if rounds > max_rounds:
        cap = _round_up(-(-cmax // max_rounds), bucket)
        rounds = -(-cmax // cap)
    return RoundPlan(rounds, cap, cmax, total, skew)


def plan_stream_capacity(round_rows: Optional[int] = None,
                         bucket: Optional[int] = None) -> int:
    """Slot capacity for ONE streaming round chunk.

    The streaming path must fix its capacity before any counts exist (the
    scatter/drain programs compile against it and are reused for every
    round), so it is always the bucket-rounded ``round_rows`` budget —
    the same shape the materialized planner picks whenever an exchange
    actually goes multi-round, which is what keeps the two paths
    bit-identical on delivered rows.
    """
    from .. import config

    if round_rows is None:
        round_rows = int(config.get("shuffle_round_rows"))
    if bucket is None:
        bucket = int(config.get("shuffle_capacity_bucket"))
    if round_rows <= 0 or bucket <= 0:
        raise ValueError("round_rows and bucket must be positive")
    return _round_up(round_rows, bucket)
