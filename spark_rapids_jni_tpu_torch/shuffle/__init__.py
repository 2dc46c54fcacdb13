"""The exchange on one card: planner, registry, resident buffers,
morsel sources and the :class:`ShuffleService` (``exchange`` and
``exchange_stream``)."""

from .buffers import MorselBuffer, PartitionBuffer, RoundChunk
from .morsel import MorselSource, snapshot_for_batch
from .planner import RoundPlan, plan_rounds, plan_stream_capacity
from .registry import ShuffleInfo, ShuffleMetrics, ShuffleRegistry, \
    get_registry
from .service import ShuffleError, ShuffleResult, ShuffleService

__all__ = ["MorselBuffer", "MorselSource", "PartitionBuffer", "RoundChunk",
           "RoundPlan", "ShuffleError", "ShuffleInfo", "ShuffleMetrics",
           "ShuffleRegistry", "ShuffleResult", "ShuffleService",
           "get_registry", "plan_rounds", "plan_stream_capacity",
           "snapshot_for_batch"]
