"""The fixed-capacity all-to-all row exchange over a mesh.

Counterpart of ``spark_rapids_jni_tpu/parallel/shuffle.py``: every shard
holds R local rows and a partition id per row; after :func:`exchange`
shard p holds the rows whose id names it.  Per shard:

1. route out-of-range ids (``< 0`` or ``> P``) to the null partition P
   and count them (:func:`route_out_of_range`),
2. regroup the rows destination-major with one stable sort,
3. fill a ``[P, C]`` slot grid (C slots per destination; rows past C
   are dropped and counted), and
4. send the grids through the mesh's all-to-all
   (:func:`.collectives.send_rows`): shard d receives ``[P * C]`` slots,
   senders in order, plus their occupancy.

The shards of a :class:`~.mesh.ShardMesh` run these steps together as
batched tensor ops; a rank of a :class:`~.mesh.ProcessMesh` runs them on
its own rows.  :func:`exchange_hierarchical` is the two-hop form over a
:class:`~.mesh.HierMesh`.  For a lossless exchange of any skew use
:class:`~..shuffle.ShuffleService`.
"""

from __future__ import annotations

import torch

from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from .collectives import send_rows


def route_out_of_range(pid: torch.Tensor, num_partitions: int):
    """Route ids outside ``[0, P]`` to the null partition P; return
    ``(pid int32, n_oob int64[])``.  A negative id is never delivered to
    partition 0 and an id past P is counted, not silently absorbed into
    the padding slot."""
    pid = pid.to(torch.int32)
    P = int(num_partitions)
    oob = (pid < 0) | (pid > P)
    return torch.where(oob, torch.full_like(pid, P), pid), oob.sum()


def _oob_per_shard(pid: torch.Tensor, P: int, L: int) -> torch.Tensor:
    """int64[L]: each local shard's out-of-range ids."""
    pid = pid.to(torch.int64)
    return ((pid < 0) | (pid > P)).reshape(L, -1).sum(1)


def bucket_counts(pid: torch.Tensor, P: int, L: int):
    """``(key, counts int64[L, P])`` of routed ids over ``L`` local
    shards, ``key = shard * (P + 1) + pid`` (the regroup's sort key)."""
    n = pid.shape[0]
    R = n // L
    shard = torch.arange(n, dtype=torch.int64, device=pid.device) \
        // max(R, 1)
    key = shard * (P + 1) + pid.to(torch.int64)
    counts = torch.bincount(key, minlength=L * (P + 1))
    return key, counts.reshape(L, P + 1)[:, :P]


def exchange(batch: ColumnBatch, pid: torch.Tensor, mesh,
             capacity: int | None = None):
    """All-to-all ``batch``'s rows by partition id over ``mesh`` (a flat
    mesh or one level of a :class:`~.mesh.HierMesh`; P = its size).

    ``pid`` is int32 per local row in ``[0, P]``; P routes nowhere.
    Returns ``(out_batch, occupancy, dropped)``: each local shard's ``[P *
    C]`` received slots (C = ``capacity``, default the shard's row count
    R, which is lossless), their occupancy, and int64 ``[local_shards]``
    rows lost to slot overflow plus out-of-range ids (never delivered).
    """
    P = mesh.size
    L = mesh.local_shards
    R = mesh.shard_rows(batch.num_rows)
    C = R if capacity is None else int(capacity)
    n_oob = _oob_per_shard(pid, P, L)
    pid, _ = route_out_of_range(pid, P)
    key, counts = bucket_counts(pid, P, L)
    perm = torch.sort(key, stable=True).indices
    dev = pid.device
    offsets = torch.cumsum(counts, 1) - counts
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    occ = slot < counts[:, :, None]                       # [L, P, C]
    base = (torch.arange(L, dtype=torch.int64, device=dev) * R)[:, None,
                                                                 None]
    src = (offsets[:, :, None] + slot).clamp(0, max(R - 1, 0)) + base
    out, occupancy = send_rows(mesh, batch, perm[src.reshape(-1)],
                               occ.reshape(-1))
    dropped = (counts - C).clamp(min=0).sum(1) + n_oob
    return out, occupancy, dropped


def plan_capacity(pid: torch.Tensor, mesh) -> torch.Tensor:
    """The largest (sender, destination) bucket over the whole mesh, a
    0-d int64 every shard agrees on: the lossless-capacity planning pass
    of :func:`exchange` (a max all-reduce)."""
    P = mesh.size
    L = mesh.local_shards
    pid, _ = route_out_of_range(pid, P)
    _, counts = bucket_counts(pid, P, L)
    return mesh.all_reduce(counts.amax(1), "max")


def exchange_hierarchical(batch: ColumnBatch, pid: torch.Tensor, mesh,
                          capacity_dcn: int | None = None,
                          capacity_ici: int | None = None):
    """Two-hop all-to-all over a :class:`~.mesh.HierMesh`: rows cross
    the host level once (to the destination host, same chip index), then
    the chip level once (to the destination chip).  The global id ``p =
    host * chips + chip`` is the Spark-exact one, so the rows each shard
    ends with are the flat exchange's.  The id rides hop one as the
    reserved ``__pid__`` column.

    Returns ``(out_batch, occupancy, dropped)`` like :func:`exchange`;
    ``dropped`` sums both hops and counts out-of-range ids once.
    """
    if "__pid__" in batch.names:
        raise ValueError("'__pid__' is reserved by exchange_hierarchical")
    H, D = mesh.n_hosts, mesh.chips
    P = H * D
    dcn, ici = mesh.axis("dcn"), mesh.axis("ici")
    n_oob = _oob_per_shard(pid, P, dcn.local_shards)
    pid, _ = route_out_of_range(pid, P)
    carried = batch.with_column("__pid__", Column(pid, pid < P, T.INT32))
    host_dst = torch.where(pid < P, pid // D, torch.full_like(pid, H))
    out_a, occ_a, drop_a = exchange(carried, host_dst, dcn, capacity_dcn)
    # the routing column has done its job after hop one
    pid_a = out_a["__pid__"].data
    chip_dst = torch.where(occ_a, pid_a % D, torch.full_like(pid_a, D))
    out_b, occ_b, drop_b = exchange(out_a.select(list(batch.names)),
                                    chip_dst, ici, capacity_ici)
    return out_b, occ_b, drop_a + drop_b + n_oob
