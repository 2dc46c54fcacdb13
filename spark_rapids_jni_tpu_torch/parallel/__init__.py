"""Multi-device parallelism: Spark-exact partitioning, the exchange over
a mesh and the distributed operators.

Counterpart of ``spark_rapids_jni_tpu/parallel``: partition ids and the
local regroup (:mod:`.partition`); the port's meshes — P shards of one
tensor on one card or one shard per ``torch.distributed`` rank — and the
two-level mesh (:mod:`.mesh`); their collectives (:mod:`.collectives`);
the fixed-grid and two-hop exchanges (:mod:`.shuffle`); the distributed
group-bys, joins and sorts (:mod:`.distributed`); and the rank launcher
(:mod:`.launch`).  Exports the reference's ``__all__`` and the port's
mesh kinds.
"""

from .distributed import (
    broadcast_build_handle,
    collect_groups,
    distributed_broadcast_join,
    distributed_group_by,
    distributed_group_by_2d,
    distributed_group_by_domain,
    distributed_group_by_onehot,
    distributed_hash_join,
    distributed_hash_join_2d,
    distributed_sort,
    distributed_sort_2d,
    plan_exchange_capacity,
)
from .mesh import (HierMesh, ProcessMesh, ShardMesh, data_mesh,
                   hierarchical_mesh, shard_batch)
from .partition import regroup_order, spark_partition_id
from .shuffle import exchange, exchange_hierarchical, plan_capacity

__all__ = [
    "broadcast_build_handle",
    "regroup_order",
    "spark_partition_id",
    "exchange",
    "exchange_hierarchical",
    "data_mesh",
    "hierarchical_mesh",
    "distributed_group_by",
    "distributed_group_by_2d",
    "distributed_group_by_domain",
    "distributed_broadcast_join",
    "distributed_hash_join",
    "distributed_hash_join_2d",
    "distributed_sort",
    "distributed_sort_2d",
    "shard_batch",
    # the port's own
    "HierMesh",
    "ProcessMesh",
    "ShardMesh",
    "collect_groups",
    "distributed_group_by_onehot",
    "plan_capacity",
    "plan_exchange_capacity",
]
