"""The exchange: planner, registry, resident buffers, morsel sources
and the :class:`ShuffleService` (``exchange`` over either mesh kind,
``exchange_stream`` over the one-card shard mesh)."""

from .buffers import MorselBuffer, PartitionBuffer, RoundChunk
from .morsel import MorselSource, snapshot_for_batch
from .planner import HierarchicalPlan, RoundPlan, plan_hierarchical, \
    plan_rounds, plan_stream_capacity
from .registry import ShuffleInfo, ShuffleMetrics, ShuffleRegistry, \
    get_registry
from .service import ShuffleError, ShuffleResult, ShuffleService

__all__ = ["HierarchicalPlan", "MorselBuffer", "MorselSource",
           "PartitionBuffer", "RoundChunk", "RoundPlan", "ShuffleError",
           "ShuffleInfo", "ShuffleMetrics", "ShuffleRegistry",
           "ShuffleResult", "ShuffleService", "get_registry",
           "plan_hierarchical", "plan_rounds", "plan_stream_capacity",
           "snapshot_for_batch"]
