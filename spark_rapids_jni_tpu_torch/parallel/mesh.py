"""The port's meshes: shards on one card, or ``torch.distributed`` ranks.

Counterparts of ``data_mesh``, ``shard_batch`` and ``hierarchical_mesh``
(``spark_rapids_jni_tpu/parallel/distributed.py``).  The reference
row-shards a batch over the P devices of a mesh and runs one program per
device.  The port has two mesh kinds behind one interface, so each
distributed operator is written once:

* :class:`ShardMesh` cuts ONE tensor on one card into P equal row
  shards: shard ``s`` is rows ``[s*R, (s+1)*R)``, the global order of the
  reference's row-sharded arrays.  Every shard is local.
* :class:`ProcessMesh` is a ``torch.distributed`` group: rank ``r`` holds
  shard ``r``'s R rows on its own device (NCCL on cards, gloo on CPUs).

What shard ``r`` of a :class:`ShardMesh` holds, rank ``r`` of a
:class:`ProcessMesh` holds, and so does device ``r`` of the reference's
``data_mesh(P)``.  The interface:

* ``size`` (P), ``local_shards`` (the shards this process holds: P, or
  1 on a rank), ``first_shard``, ``device``, ``holds_all`` (every
  shard's rows in one local tensor: a shard mesh, never a rank);
* :meth:`shard_rows`, :meth:`split` and :meth:`join` cut a local batch
  into its shards and put per-shard results back together;
* ``all_to_all``, ``all_reduce`` (``'sum'``/``'max'``), ``all_gather`` and
  ``all_gather_rows`` (:mod:`.collectives`), each over per-local-shard
  values stacked on axis 0.

:class:`HierMesh` is the two-level (hosts x chips) mesh of the two-hop
exchange over either kind; its :meth:`HierMesh.axis` views run the
all-to-all along one level.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import collectives as CL


class _Rows:
    """Row-block helpers every mesh kind shares (``local_shards`` row
    blocks per local tensor)."""

    @property
    def holds_all(self) -> bool:
        return self.local_shards == self.size

    def shard_rows(self, num_rows: int) -> int:
        """Rows per shard of a local batch; they must divide evenly."""
        if num_rows % self.local_shards:
            raise ValueError(f"batch rows {num_rows} not divisible by "
                             f"{self.local_shards} local shards")
        return num_rows // self.local_shards

    def split(self, x) -> list:
        """A local batch or row tensor as its ``local_shards`` row blocks
        (views); ``None`` stays ``None`` for every shard."""
        L = self.local_shards
        if x is None:
            return [None] * L
        if L == 1:
            return [x]
        n = x.num_rows if not isinstance(x, torch.Tensor) else x.shape[0]
        R = self.shard_rows(n)
        return [slice_rows(x, i * R, (i + 1) * R) for i in range(L)]

    def join(self, parts):
        """Per-shard results back into one local value: batches and row
        tensors concatenate, 0-d tensors stack to ``[local_shards]``."""
        first = parts[0]
        if isinstance(first, torch.Tensor):
            if first.dim() == 0:
                return torch.stack(list(parts))
            return first if len(parts) == 1 else torch.cat(list(parts))
        if len(parts) == 1:
            return first
        from ..shuffle.buffers import batch_leaves, rebatch

        cols = [batch_leaves(p) for p in parts]
        return rebatch(first, [torch.cat(list(ls)) for ls in zip(*cols)])


def slice_rows(x, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a batch or a row tensor (views)."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi]
    from ..shuffle.buffers import batch_leaves, rebatch

    return rebatch(x, [t[lo:hi] for t in batch_leaves(x)])


@dataclasses.dataclass(frozen=True)
class ShardMesh(_Rows):
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

    @property
    def local_shards(self) -> int:
        return self.size

    @property
    def first_shard(self) -> int:
        return 0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return CL.shard_all_to_all(x, (self.size,), 0)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return CL.shard_all_reduce(x, op)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ProcessMesh(_Rows):
    """The ranks of a ``torch.distributed`` group, one shard each.

    ``group=None`` is the default group.  ``device=None`` is
    ``cuda:{LOCAL_RANK}`` (the global rank modulo the visible cards when
    ``LOCAL_RANK`` is unset) and raises without CUDA; the CPU tests pass
    ``device='cpu'`` over gloo.  Under NCCL the rank's card becomes the
    current device before the first collective.
    """

    def __init__(self, group=None, device=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: a ProcessMesh runs on the rank's GPU "
                    "by default; pass device='cpu' to run over gloo")
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
            device = f"cuda:{local}"
        self.device = resolve_device(device)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)

    local_shards = 1
    # a rank sends its rows' leaves through the collective even at world
    # size 1, so one card runs the code path of many
    holds_all = False

    @property
    def first_shard(self) -> int:
        return self.rank

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return CL.process_all_to_all(x, self.group)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return CL.process_all_reduce(x, op, self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return CL.process_all_gather(x, self.group)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return CL.process_all_gather_rows(x, self.group)

    def __repr__(self):
        return (f"ProcessMesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


@dataclasses.dataclass(frozen=True)
class _ShardAxis(_Rows):
    """One level of a :class:`HierMesh` over a :class:`ShardMesh`: the
    all-to-all along axis ``axis`` of the ``shape`` mesh, every shard
    local."""

    shape: tuple
    axis: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[self.axis]

    @property
    def local_shards(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def holds_all(self) -> bool:
        return True

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return CL.shard_all_to_all(x, self.shape, self.axis)


class HierMesh:
    """A (hosts x chips) mesh, host-major: shard ``h * chips + d`` is chip
    ``d`` of host ``h``, over a flat mesh of ``n_hosts * chips`` shards
    (default: a :class:`ShardMesh` on ``device``).  :meth:`axis` gives the
    ``'dcn'`` level (the hosts of one chip index) and the ``'ici'`` level
    (the chips of one host).  Over a :class:`ProcessMesh` each level is a
    ``dist.new_group`` subgroup; every rank creates every subgroup, in the
    same order."""

    def __init__(self, n_hosts: int, chips: int, mesh=None, device=None):
        H, D = int(n_hosts), int(chips)
        if H < 1 or D < 1:
            raise ValueError(f"need at least one host and one chip, got "
                             f"{H} x {D}")
        self.n_hosts, self.chips = H, D
        self.flat = ShardMesh(H * D, device) if mesh is None else mesh
        if self.flat.size != H * D:
            raise ValueError(f"a {H} x {D} mesh needs {H * D} shards, the "
                             f"flat mesh has {self.flat.size}")
        if isinstance(self.flat, ProcessMesh):
            self._axes = self._subgroups()
        else:
            dev = self.flat.device
            self._axes = {"dcn": _ShardAxis((H, D), 0, dev),
                          "ici": _ShardAxis((H, D), 1, dev)}

    def _subgroups(self) -> dict:
        H, D, flat = self.n_hosts, self.chips, self.flat

        def glob(r):
            return (r if flat.group is None
                    else dist.get_global_rank(flat.group, r))

        axes = {}
        for name, groups in (
                ("dcn", [[hh * D + dd for hh in range(H)]
                         for dd in range(D)]),
                ("ici", [[hh * D + dd for dd in range(D)]
                         for hh in range(H)])):
            for ranks in groups:
                g = dist.new_group([glob(r) for r in ranks])
                if flat.rank in ranks:
                    axes[name] = ProcessMesh(g, flat.device)
        return axes

    @property
    def size(self) -> int:
        return self.flat.size

    @property
    def device(self):
        return self.flat.device

    def axis(self, name: str):
        """The mesh level ``'dcn'`` (size ``n_hosts``) or ``'ici'`` (size
        ``chips``)."""
        try:
            return self._axes[name]
        except KeyError:
            raise ValueError(f"unknown mesh axis {name!r} (use 'dcn' or "
                             "'ici')") from None

    def __repr__(self):
        return f"HierMesh({self.n_hosts} x {self.chips}, {self.flat!r})"


def data_mesh(num_devices: Optional[int] = None, device=None):
    """The 1-D mesh: a :class:`ProcessMesh` over the default group when a
    process group is up (``num_devices`` must then be its size or
    ``None``), else a :class:`ShardMesh` of ``num_devices`` shards on
    ``device`` (the GPU by default)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if num_devices not in (None, world):
            raise ValueError(f"a process group of {world} ranks cannot "
                             f"carry a {num_devices}-device mesh")
        return ProcessMesh(device=device)
    if num_devices is None:
        raise ValueError("a shard mesh needs num_devices (no process "
                         "group is initialized)")
    return ShardMesh(num_devices, device)


def hierarchical_mesh(n_hosts: int, chips_per_host: int, mesh=None,
                      device=None) -> HierMesh:
    """``(hosts, chips)`` mesh, host-major (:class:`HierMesh`)."""
    return HierMesh(n_hosts, chips_per_host, mesh, device)


def shard_batch(batch, mesh):
    """Place a batch row-sharded over ``mesh`` (rows % shards == 0).

    A :class:`ShardMesh` takes the whole batch to its device as it stands;
    a :class:`ProcessMesh` (or a :class:`HierMesh` over one) takes this
    rank's row block of the global batch.  Every column must be one the
    exchange carries (``shuffle/buffers.py`` ``column_leaves``; encoded
    columns are ROADMAP.md queue 1, item 12)."""
    from ..shuffle.buffers import batch_leaves, rebatch

    flat = mesh.flat if isinstance(mesh, HierMesh) else mesh
    leaves = batch_leaves(batch)
    n = batch.num_rows
    if n % flat.size:
        raise ValueError(f"batch rows {n} not divisible by mesh size "
                         f"{flat.size}")
    R = n // flat.size
    lo, hi = flat.first_shard * R, (flat.first_shard + flat.local_shards) * R
    return rebatch(batch, [t[lo:hi].to(flat.device) for t in leaves])
