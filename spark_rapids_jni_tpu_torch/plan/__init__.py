"""Logical plan IR, adaptive decisions, plan cache and compiler.

Counterpart of ``spark_rapids_jni_tpu/plan/``: :mod:`.ir` (the logical
nodes), :mod:`.queries` (q6, q95 and q9 as IR), :mod:`.adaptive`
(plan-time decisions from observed stats), :mod:`.cache` (the LRU plan
cache) and :mod:`.compile` (the lowering onto the port's operators and
:func:`execute`, which the serving layer, the JNI dispatch and the
benches run queries through).
"""

from . import queries
from .adaptive import (choose_exchange_capacity, choose_groupby_engine,
                       choose_join_engine, choose_join_strategy,
                       choose_shuffle_compress, plan_decisions)
from .cache import get_plan_cache, plan_cache_metrics, reset_plan_cache
from .compile import CompiledPlan, compile_plan, execute, trace_count
from .ir import (Agg, Aggregate, Exchange, Filter, Join, Project, Scan,
                 Sort)

__all__ = [
    "Scan", "Filter", "Project", "Join", "Aggregate", "Agg", "Exchange",
    "Sort",
    "CompiledPlan", "compile_plan", "execute", "trace_count",
    "get_plan_cache", "plan_cache_metrics", "reset_plan_cache",
    "choose_join_strategy", "choose_join_engine", "choose_groupby_engine",
    "choose_exchange_capacity", "choose_shuffle_compress",
    "plan_decisions", "queries",
]
