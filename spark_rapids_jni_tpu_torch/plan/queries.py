"""The flagship queries as DATA: pure IR, no hand-written lowering.

Counterpart of ``spark_rapids_jni_tpu/plan/queries.py``.  ``q6_plan`` and
``q95_plan`` are the IR spellings of the port's hand-fused
:func:`~spark_rapids_jni_tpu_torch.pipelines.q6_step` and
:func:`~spark_rapids_jni_tpu_torch.pipelines.q95_step`; ``q9_plan`` (a
multi-join plus a conditional aggregate) exists only as IR.
"""

from __future__ import annotations

from ..pipelines import Q9_V_THRESHOLD, Q95_SEG
from .ir import Agg, Aggregate, Exchange, Filter, Join, Scan

__all__ = ["Q9_V_THRESHOLD", "q6_plan", "q95_plan", "q9_plan"]


def q6_plan() -> Aggregate:
    """q6: filter (price < 50) -> group by k: sum(v), count(*),
    avg(price).  The domain/onehot hints engage only for a plain int
    key."""
    return Aggregate(
        Filter(Scan("batch"), "price", "<", 50.0),
        keys=("k",),
        aggs=(Agg("sum", "v", "sum_v"),
              Agg("count", None, "cnt"),
              Agg("mean", "price", "avg_price")),
        domain=100, onehot=True)


def q95_plan() -> Aggregate:
    """q95: exchange -> join dim1 -> exchange -> join dim2 -> exchange
    -> group by seg.  The compiler fuses the trailing Exchange+Aggregate
    pair (sort engine: secondary sort operands; otherwise elision)."""
    j1 = Join(Exchange(Scan("fact"), "k"), Scan("dim1"), "k", "k",
              dense_domain="build")
    j2 = Join(Exchange(j1, "wh"), Scan("dim2"), "wh", "wh",
              dense_domain="build")
    return Aggregate(
        Exchange(j2, "seg"),
        keys=("seg",),
        aggs=(Agg("count", None, "orders"), Agg("sum", "v", "net")),
        domain=Q95_SEG)


def q9_plan() -> Aggregate:
    """q9 shape, IR-only: fact joins both dims (adaptive strategy: a dim
    at or under ``broadcast_threshold_rows`` goes broadcast), then a
    conditional aggregate (only orders with v >= threshold count)
    grouped by segment."""
    j1 = Join(Scan("fact"), Scan("dim1"), "k", "k",
              dense_domain="build", strategy="auto")
    j2 = Join(j1, Scan("dim2"), "wh", "wh",
              dense_domain="build", strategy="auto")
    return Aggregate(
        Filter(j2, "v", ">=", Q9_V_THRESHOLD),
        keys=("seg",),
        aggs=(Agg("sum", "v", "net_hi"),
              Agg("count", None, "orders_hi"),
              Agg("mean", "v", "avg_hi")),
        domain=Q95_SEG)
