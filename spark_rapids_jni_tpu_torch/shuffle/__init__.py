"""The exchange: planner, registry, spillable buffers with their lineage,
morsel sources, the persistent shuffle store and the
:class:`ShuffleService` (``exchange`` and ``exchange_stream`` over either
mesh kind)."""

from .buffers import MorselBuffer, PartitionBuffer, RoundChunk, \
    store_recompute
from .morsel import MorselSource, snapshot_for_batch
from .planner import HierarchicalPlan, RoundPlan, plan_hierarchical, \
    plan_rounds, plan_stream_capacity
from .registry import ShuffleInfo, ShuffleMetrics, ShuffleRegistry, \
    get_registry
from .service import ShuffleError, ShuffleResult, ShuffleService
from .store import ShuffleStore, get_store, install, shutdown_store

__all__ = ["HierarchicalPlan", "MorselBuffer", "MorselSource",
           "PartitionBuffer", "RoundChunk", "RoundPlan", "ShuffleError",
           "ShuffleInfo", "ShuffleMetrics", "ShuffleRegistry",
           "ShuffleResult", "ShuffleService", "ShuffleStore",
           "get_registry", "get_store", "install",
           "plan_hierarchical", "plan_rounds", "plan_stream_capacity",
           "shutdown_store", "snapshot_for_batch", "store_recompute"]
