"""Adaptive plan-time decisions from stats the system already collects.

Counterpart of ``spark_rapids_jni_tpu/plan/adaptive.py``.  The decisions
are pure functions over a ``stats`` dict with optional keys::

    {"shuffle":   ShuffleMetrics snapshot (shuffle/registry.py),
     "counts":    per-partition/bucket row counts (the planner pass),
     "stages_ms": {"exch1": .., "join1": .., "agg": ..},
     "key_range": (lo, hi) of an exchange key}

Each returns the reference's decision for the same inputs and stats;
only engine names map to the port's tiers (the reference's ``hash``,
``scatter`` and ``pallas`` engines are the port's ``kernel``).
Everything gates on the ``adaptive_execution`` knob: off means the
static defaults (shuffled joins, knob-resolved engines, the historical
slot-table round bounds).
"""

from __future__ import annotations

from typing import Optional

from .. import config
from ..columnar.encoded import choose_pack_width
from . import ir

# past this max/mean per-partition ratio the hash group-by's slot table
# degenerates on the hot key: pick the sort engine up front
SKEW_SORT_RATIO = 4.0


def _enabled() -> bool:
    return bool(config.get("adaptive_execution"))


def choose_join_strategy(build_rows: int,
                         threshold: Optional[int] = None) -> str:
    """``'broadcast'`` when the observed build side fits under the
    ``broadcast_threshold_rows`` knob, else ``'shuffled'``.  Adaptive off
    = always shuffled."""
    if not _enabled():
        return "shuffled"
    if threshold is None:
        threshold = int(config.get("broadcast_threshold_rows"))
    return "broadcast" if int(build_rows) <= threshold else "shuffled"


def choose_join_engine() -> str:
    """The engine a broadcast build table is pinned to (the knob,
    resolved as ``hash_join`` resolves it)."""
    from ..relational.join import _resolve_join_engine

    return _resolve_join_engine(None)


def choose_groupby_engine(counts=None,
                          stages_ms: Optional[dict] = None) -> Optional[str]:
    """Engine hint for a general (domainless) aggregation, or ``None``
    to defer to the ``groupby_engine`` knob.  A skewed counts pass
    (max/mean >= ``SKEW_SORT_RATIO``) forces the sort engine; a
    ``stages_ms`` note whose aggregation stage is over half the total
    records the knob's engine explicitly."""
    if not _enabled():
        return None
    if counts is not None:
        vals = [int(c) for c in counts]
        if vals and max(vals) > 0:
            mean = sum(vals) / len(vals)
            if mean > 0 and max(vals) / mean >= SKEW_SORT_RATIO:
                return "sort"
    if stages_ms:
        total = sum(float(v) for v in stages_ms.values())
        agg = float(stages_ms.get("agg", 0.0))
        if total > 0 and agg > 0.5 * total:
            from ..relational.aggregate import _resolve_groupby_engine

            return _resolve_groupby_engine(None)
    return None


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


def choose_exchange_capacity(counts=None, metrics: Optional[dict] = None,
                             partitions: int = 8):
    """Per-exchange round plan via the skew planner: exactly
    :func:`~..shuffle.planner.plan_rounds` over a counts pass, or over an
    estimate from a ``ShuffleMetrics`` snapshot (rows_moved / (shuffles *
    partitions) inflated by the recorded skew peak); ``None`` with no
    signal."""
    from ..shuffle.planner import plan_rounds

    if not _enabled():
        return None
    if counts is not None:
        return plan_rounds([int(c) for c in counts])
    if metrics:
        shuffles = int(metrics.get("shuffles", 0))
        rows = int(metrics.get("rows_moved", 0))
        if shuffles > 0 and rows > 0:
            mean = rows // (shuffles * max(partitions, 1))
            peak = max(float(metrics.get(
                "max_skew", metrics.get("max_skew_ratio", 1.0))), 1.0)
            est = max(int(mean * peak), 1)
            return plan_rounds([est] * max(partitions, 1))
    return None


def choose_shuffle_compress(key_range=None,
                            metrics: Optional[dict] = None) -> Optional[str]:
    """Wire-compression mode for an Exchange, or ``None`` to defer to the
    ``shuffle_compress`` knob: ``'pack'`` when an observed key range packs
    narrower than 64 bits (or earlier exchanges saved bytes packing),
    ``'off'`` for full-range keys (the widths of
    :func:`~..columnar.encoded.choose_pack_width`, which the exchange's
    wire packer uses too)."""
    if not _enabled():
        return None
    if key_range is not None:
        lo, hi = key_range
        w = choose_pack_width(min(int(lo), 0), max(int(hi), 0))
        return "pack" if w is not None and w < 64 else "off"
    if metrics and int(metrics.get("compressed_bytes_saved", 0)) > 0:
        return "pack"
    return None


def plan_decisions(plan: ir.PlanNode, inputs: dict,
                   stats: Optional[dict] = None) -> dict:
    """Walk ``plan`` and record every adaptive decision the compiler
    will consume — keyed ``join<i>:<left_on>`` / ``exchange<i>:<key>`` /
    ``aggregate<i>:<keys>`` (ordinals in walk order) — plus the resolved
    strategy of each ``strategy='auto'`` join from the observed build row
    count."""
    stats = stats or {}
    decisions: dict = {"adaptive": _enabled()}
    ji = xi = ai = 0
    for node in plan.walk():
        if isinstance(node, ir.Join):
            strategy = node.strategy
            build_rows = None
            if isinstance(node.right, ir.Scan) and node.right.name in inputs:
                build_rows = int(inputs[node.right.name].num_rows)
            if strategy == "auto":
                strategy = (choose_join_strategy(build_rows)
                            if build_rows is not None else "shuffled")
            d = {"strategy": strategy, "build_rows": build_rows}
            if strategy == "broadcast":
                d["engine"] = choose_join_engine()
            decisions[f"join{ji}:{node.left_on}"] = d
            ji += 1
        elif isinstance(node, ir.Exchange):
            rp = choose_exchange_capacity(
                counts=stats.get("counts"), metrics=stats.get("shuffle"),
                partitions=node.partitions)
            compress = choose_shuffle_compress(
                key_range=stats.get("key_range"),
                metrics=stats.get("shuffle"))
            if rp is not None or compress is not None:
                d = {}
                if rp is not None:
                    d.update(capacity=rp.capacity, rounds=rp.rounds,
                             skew_ratio=round(rp.skew_ratio, 3))
                if compress is not None:
                    d["compress"] = compress
                decisions[f"exchange{xi}:{node.key}"] = d
            xi += 1
        elif isinstance(node, ir.Aggregate):
            hint = choose_groupby_engine(counts=stats.get("counts"),
                                         stages_ms=stats.get("stages_ms"))
            if hint is not None:
                decisions[f"aggregate{ai}:{','.join(node.keys)}"] = {
                    "engine": hint}
            ai += 1
    return decisions
