"""Shards on one card: the port's form of the reference's 1-D device mesh.

Counterpart of ``data_mesh`` and ``shard_batch``
(``spark_rapids_jni_tpu/parallel/distributed.py``): a batch on the
mesh's card whose row count divides by P is row-sharded as it stands.
The reference row-shards a batch over the P devices of a mesh; here a
:class:`ShardMesh` cuts ONE tensor on one card into P equal row shards:
shard ``s`` is rows ``[s*R, (s+1)*R)``, the global order of the
reference's row-sharded arrays.  Per-device bodies (the shuffle's map,
scatter and drain steps) run over all shards at once as batched tensor
ops, and the reference's ``lax.all_to_all`` (split and concat on axis 0)
becomes a transpose of ``[P_s, P_d, C, ...]`` to ``[P_d, P_s, C, ...]``.
So an exchange's delivered arrays are bit-identical, in global order,
to the reference's on its P-device mesh.

Mapping shards onto ``torch.distributed`` ranks, one card each, is
ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``size`` equal row shards of one tensor on ``device``.

    ``device=None`` means the GPU (raises without one); pass
    ``device='cpu'`` to run on the CPU.
    """

    size: int
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if int(self.size) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{self.size}")
        object.__setattr__(self, "size", int(self.size))
        object.__setattr__(self, "device", resolve_device(self.device))

    def shard_rows(self, num_rows: int) -> int:
        """Rows per shard; ``num_rows`` must divide evenly."""
        if num_rows % self.size:
            raise ValueError(f"batch rows {num_rows} not divisible by mesh "
                             f"size {self.size}")
        return num_rows // self.size

