"""Skew-aware round planning: one cheap counts pass decides the shape.

Counterpart of ``spark_rapids_jni_tpu/shuffle/planner.py`` (copied:
``RoundPlan``, ``plan_rounds``, ``plan_stream_capacity``,
``HierarchicalPlan``, ``plan_hierarchical``).  The map
step's per-(sender, destination) count matrix comes back to the host
once, and :func:`plan_rounds` turns it into a static execution shape —
how many rounds, at what per-bucket slot capacity — that is lossless
(``rounds * capacity >= max bucket``) without sizing the slot grid for
the worst case; :func:`plan_hierarchical` sizes each hop of the two-hop
exchange (``parallel/shuffle.py`` ``exchange_hierarchical``) from the
same matrix.
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


@dataclass(frozen=True)
class HierarchicalPlan:
    """Per-hop capacities for one two-hop (hosts x chips) exchange."""

    capacity_dcn: int    # slot rows per (sender shard, destination host)
    capacity_ici: int    # slot rows per (sender shard, destination chip)
    max_bucket_dcn: int  # largest hop-one bucket observed
    max_bucket_ici: int  # largest hop-two bucket observed
    total_rows: int
    skew_dcn: float      # max hop-one bucket / mean grid bucket
    skew_ici: float

    @property
    def lossless(self) -> bool:
        return (self.capacity_dcn >= self.max_bucket_dcn
                and self.capacity_ici >= self.max_bucket_ici)


def plan_hierarchical(counts, n_hosts: int, n_chips: int,
                      bucket: Optional[int] = None) -> HierarchicalPlan:
    """Turn a ``[P, P]`` (sender shard, destination partition) count
    matrix into per-hop capacities for ``exchange_hierarchical`` (``P =
    n_hosts * n_chips``; partition ``p`` lives on host ``p // n_chips``,
    chip ``p % n_chips``).

    * **hop one** moves sender ``(h, d)``'s rows to host ``p // n_chips``
      without changing the chip index, so its bucket for ``(sender,
      destination host)`` is the row sum over that host's partitions.
    * **hop two** moves the rows shard ``(h', d)`` collected (from every
      sender with chip index ``d``) to their final chip, so its bucket for
      ``(collector, destination partition)`` sums the column over the
      senders sharing that chip index.

    The ``shuffle_capacity_dcn`` / ``shuffle_capacity_ici`` knobs (> 0)
    override the planned values.  Both planned capacities are lossless
    for THESE counts by construction.
    """
    from .. import config

    if bucket is None:
        bucket = int(config.get("shuffle_capacity_bucket"))
    H, D = int(n_hosts), int(n_chips)
    P = H * D
    c = np.asarray(counts, dtype=np.int64).reshape(P, P)
    total = int(c.sum())

    hop_a = c.reshape(P, H, D).sum(axis=2)         # [P senders, H hosts]
    amax = int(hop_a.max()) if hop_a.size else 0
    amean = hop_a.sum() / hop_a.size if hop_a.size else 0.0
    hop_b = c.reshape(H, D, H, D).sum(axis=0)      # [d, h', D] per chip
    bmax = int(hop_b.max()) if hop_b.size else 0
    bmean = hop_b.sum() / hop_b.size if hop_b.size else 0.0

    cap_a = int(config.get("shuffle_capacity_dcn"))
    cap_b = int(config.get("shuffle_capacity_ici"))
    if cap_a <= 0:
        cap_a = _round_up(max(amax, 1), bucket)
    if cap_b <= 0:
        cap_b = _round_up(max(bmax, 1), bucket)
    return HierarchicalPlan(
        capacity_dcn=cap_a, capacity_ici=cap_b,
        max_bucket_dcn=amax, max_bucket_ici=bmax, total_rows=total,
        skew_dcn=amax / amean if amean > 0 else 0.0,
        skew_ici=bmax / bmean if bmean > 0 else 0.0)
