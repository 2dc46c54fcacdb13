"""The collectives of the port's meshes, one set for each mesh kind.

The reference's per-device programs run inside ``shard_map`` and talk
through ``lax.all_to_all``, ``psum``/``pmax`` and the replicated outputs
of ``shard_map``.  The port holds a mesh's shards in one of two ways
(:mod:`.mesh`):

* a :class:`~.mesh.ShardMesh` holds every shard in one tensor (shard
  ``s`` is its ``s``-th row block), so its all-to-all is a transpose of
  the send grids (:func:`shard_all_to_all`), a reduction is a sum or max
  over the stacked per-shard values and an all-gather is the identity;
* a :class:`~.mesh.ProcessMesh` holds one shard per ``torch.distributed``
  rank, and its collectives are ``all_to_all_single``, ``all_reduce`` and
  ``all_gather`` over the group (:func:`process_all_to_all`, ...).

Every collective takes per-local-shard values stacked on axis 0 (``P``
of them on a shard mesh, one on a rank).  Bool tensors travel as uint8
views (NCCL carries no bool); every leaf takes one collective of its own.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# a list turns on the all-to-all timer: :func:`send_rows` appends a
# (start, end) pair of CUDA events around each of its calls (off: None)
a2a_events = None


def shard_all_to_all(x: torch.Tensor, shape: Sequence[int],
                     axis: int = 0) -> torch.Tensor:
    """The all-to-all along mesh axis ``axis`` of a mesh of ``shape``
    whose shards all lie in ``x`` (row blocks in row-major mesh order).
    Each shard's block is its ``[G * C, ...]`` send grid, destination
    ``g`` of the axis at slots ``[g*C, (g+1)*C)``; each shard receives
    its ``[G * C, ...]`` grid with the axis's senders in order — what
    ``lax.all_to_all(split_axis=0, concat_axis=0)`` delivers."""
    shape = tuple(int(s) for s in shape)
    rest = tuple(x.shape[1:])
    grid = x.reshape(shape + (shape[axis], -1) + rest)
    return grid.transpose(axis, len(shape)).reshape((-1,) + rest)


def _a2a(x: torch.Tensor, P: int) -> torch.Tensor:
    """The all-to-all of one ``[P_s * P_d * C, ...]`` leaf of a 1-D shard
    mesh: sender s's slots for destination d land in destination d's
    shard, senders in order — ``[P_d * P_s * C, ...]``."""
    return shard_all_to_all(x, (P,), 0)


def shard_all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """Sum or max over the stacked shards of a shard mesh.  Float sums
    add in shard order, one shard at a time, so a rank mesh (which
    gathers and adds the same way) gets the same bits."""
    if op == "sum" and x.is_floating_point():
        acc = x[0].clone()
        for i in range(1, x.shape[0]):
            acc += x[i]
        return acc
    if op == "sum":
        return x.sum(0)
    if op == "max":
        return x.amax(0)
    raise ValueError(f"unknown reduction {op!r} (use 'sum' or 'max')")


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.view(torch.bool) if like.dtype == torch.bool else y


def process_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` of this rank's ``[G * C, ...]`` send grid:
    equal splits, so rank g gets slots ``[g*C, (g+1)*C)`` and this rank
    receives the group's grids in rank order."""
    src = _wire(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _unwire(out, x)


def process_all_reduce(x: torch.Tensor, op: str, group=None
                       ) -> torch.Tensor:
    """The group's sum or max of this rank's (stacked) values.  A float
    sum is an all-gather and an add in rank order (bit-identical to a
    shard mesh's); the rest is one ``all_reduce``."""
    y = shard_all_reduce(x, op)
    if op == "sum" and y.is_floating_point():
        return shard_all_reduce(process_all_gather(y[None], group), op)
    was_bool = y.dtype == torch.bool
    y = (y.to(torch.int32) if was_bool else y).contiguous().clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(torch.bool) if was_bool else y


def process_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's equal-shaped ``x`` concatenated on axis 0, in rank
    order."""
    src = _wire(x)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return _unwire(torch.cat(parts), x)


def process_all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's row blocks of any length, concatenated in rank order:
    the lengths cross first, then every block padded to the longest."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    lens = process_all_gather(n, group).tolist()
    top = max(lens)
    pad = torch.zeros((top - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    full = process_all_gather(torch.cat([x, pad]), group)
    return torch.cat([full[i * top:i * top + m]
                      for i, m in enumerate(lens)])


def send_rows(mesh, batch, idx: torch.Tensor, occ: torch.Tensor):
    """Send rows of ``batch`` through ``mesh``'s all-to-all.

    ``idx`` and ``occ`` are every local shard's ``[G * C]`` send grid,
    destination-major: row ``idx`` (a local row index) fills the slot,
    ``occ`` marks the slots that hold a row.  Returns ``(received batch,
    received occupancy)``, each local shard's ``[G * C]`` receive grid
    with its senders in order.  A mesh that holds every shard moves the
    index grid and gathers once straight into the receive order; a rank
    gathers its send grid and moves each column leaf."""
    from ..relational.gather import gather_batch
    from ..shuffle.buffers import batch_leaves, rebatch

    timed = a2a_events is not None
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    if mesh.holds_all:
        rocc = mesh.all_to_all(occ)
        out = gather_batch(batch, mesh.all_to_all(idx), valid=rocc)
    else:
        sent = gather_batch(batch, idx, valid=occ)
        out = rebatch(sent, [mesh.all_to_all(x)
                             for x in batch_leaves(sent)])
        rocc = mesh.all_to_all(occ)
    if timed:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        a2a_events.append((start, end))
    return out, rocc
