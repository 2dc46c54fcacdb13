"""Out-of-range partition ids of an exchange.

Counterpart of ``route_out_of_range`` in
``spark_rapids_jni_tpu/parallel/shuffle.py``; the static-shape
``exchange`` there runs inside ``shard_map`` across devices and comes
with ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import torch


def route_out_of_range(pid: torch.Tensor, num_partitions: int):
    """Route ids outside ``[0, P]`` to the null partition P; return
    ``(pid int32, n_oob int64[])``.  A negative id is never delivered to
    partition 0 and an id past P is counted, not silently absorbed into
    the padding slot."""
    pid = pid.to(torch.int32)
    P = int(num_partitions)
    oob = (pid < 0) | (pid > P)
    return torch.where(oob, torch.full_like(pid, P), pid), oob.sum()
