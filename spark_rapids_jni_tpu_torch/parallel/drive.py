"""Run distributed operators on host data over any mesh.

:func:`run_ops` is a rank body for :func:`.launch.spawn` and runs the
same way on a :class:`~.mesh.ShardMesh`: each op names an operator of
:mod:`spark_rapids_jni_tpu_torch.parallel` (or one of :data:`EXTRA`)
with its arguments, where :class:`Sharded` host data is row-sharded onto
the mesh (a rank takes its own row block), :class:`Whole` host data is
put whole on the mesh's device, :data:`MESH` is the mesh and
:class:`Hier` a :class:`~.mesh.HierMesh` over it.  Results come back as
numpy, one entry per local shard (so rank r's entry is shard r's of a
shard mesh), or whole for ops marked replicated.  Host batches are
:func:`~..columnar.column.batch_from_numpy` dicts.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from .. import config, pipelines
from ..columnar.column import ColumnBatch, batch_from_numpy, batch_to_numpy
from .distributed import _sample_splitters, distributed_sort
from .mesh import HierMesh, shard_batch

MESH = "__mesh__"


@dataclasses.dataclass
class Sharded:
    """Host data (a batch dict or a row array) row-sharded onto the
    mesh."""
    value: Any


@dataclasses.dataclass
class Whole:
    """A host batch dict whole on the mesh's device."""
    value: Any


@dataclasses.dataclass
class Hier:
    """The ``n_hosts x chips`` :class:`~.mesh.HierMesh` over the mesh."""
    n_hosts: int
    chips: int


@dataclasses.dataclass
class Op:
    """One operator call; ``replicated`` results are not split by
    shard."""
    name: str
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    replicated: bool = False


def _service_exchange(batch, mesh, **kw):
    from ..shuffle import ShuffleRegistry, ShuffleService

    res = ShuffleService(mesh, registry=ShuffleRegistry()).exchange(batch,
                                                                    **kw)
    return {"batch": res.batch, "occupancy": res.occupancy,
            "stats": [res.rounds, res.capacity, res.rows_moved,
                      res.bytes_moved, res.oob_rows]}


@dataclasses.dataclass
class Same:
    """A replicated part of an op's per-shard result: every shard gets
    it whole."""
    value: Any


def _q95(n_rows, mesh):
    """q95's distributed operators and the sort on the q95 recipe of
    ``n_rows`` fact rows, made from its seed on the mesh's device."""
    fact, dim1, dim2 = pipelines.q95_batches(n_rows, device=mesh.device)
    fact, dim1 = shard_batch(fact, mesh), shard_batch(dim1, mesh)
    out = pipelines.q95_distributed(fact, dim1, dim2, mesh)
    out["domain"] = Same(out["domain"])
    out["sort"] = distributed_sort(fact, ["k", "v"], mesh)
    return out


# ops beyond the package's exports, each ``fn(*args, **kwargs)``
EXTRA = {"set_knob": config.set,
         "service_exchange": _service_exchange,
         "sample_splitters": _sample_splitters,
         "q95_distributed": _q95,
         "dryrun_multichip": pipelines.dryrun_multichip}


def _place(x, mesh, hiers):
    if isinstance(x, str) and x == MESH:
        return mesh
    if isinstance(x, Hier):
        key = (x.n_hosts, x.chips)
        if key not in hiers:  # every rank creates the same subgroups once
            hiers[key] = HierMesh(x.n_hosts, x.chips, mesh)
        return hiers[key]
    if isinstance(x, Whole):
        return batch_from_numpy(x.value, device=mesh.device)
    if isinstance(x, Sharded):
        v = x.value
        if isinstance(v, dict):
            return shard_batch(batch_from_numpy(v, device="cpu"), mesh)
        t = torch.as_tensor(np.asarray(v))
        R = t.shape[0] // mesh.size
        lo = mesh.first_shard * R
        return t[lo:lo + mesh.local_shards * R].to(mesh.device)
    if isinstance(x, (list, tuple)):
        return type(x)(_place(v, mesh, hiers) for v in x)
    return x


def to_host(x):
    """Tensors and batches (nested in tuples, lists, dicts) as numpy."""
    if isinstance(x, ColumnBatch):
        return batch_to_numpy(x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def _by_shard(x, mesh) -> list:
    """``x`` cut into its local shards: batches and row tensors by rows,
    0-d tensors and plain values whole."""
    L = mesh.local_shards
    if isinstance(x, Same):
        return [x.value] * L
    if isinstance(x, ColumnBatch) or (isinstance(x, torch.Tensor)
                                      and x.dim() > 0):
        return mesh.split(x)
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        cols = [_by_shard(v, mesh) for v in x]
        return [type(x)(c[i] for c in cols) for i in range(L)]
    if isinstance(x, dict):
        cols = {k: _by_shard(v, mesh) for k, v in x.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(L)]
    return [x] * L


def run_ops(mesh, ops) -> list:
    """Run each :class:`Op` on ``mesh``; returns per op its numpy result,
    a list over the local shards unless the op is replicated."""
    from .. import parallel

    hiers = {}
    out = []
    for op in ops:
        fn = EXTRA.get(op.name) or getattr(parallel, op.name)
        res = fn(*_place(op.args, mesh, hiers),
                 **{k: _place(v, mesh, hiers) for k, v in op.kwargs.items()})
        out.append(to_host(res) if op.replicated
                   else [to_host(s) for s in _by_shard(res, mesh)])
    return out


def _digest(x, h) -> None:
    if isinstance(x, np.ndarray):
        h.update(str((x.dtype, x.shape)).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(str(k).encode())
            _digest(x[k], h)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _digest(v, h)
    else:
        h.update(repr(x).encode())


def digest(x) -> str:
    """sha256 over a :func:`run_ops` result (arrays byte for byte)."""
    h = hashlib.sha256()
    _digest(x, h)
    return h.hexdigest()


def digest_ops(mesh, ops) -> list:
    """:func:`run_ops`, each result as its :func:`digest` (per shard
    unless replicated): what ranks send back when the rows are big."""
    return [digest(r) if op.replicated else [digest(s) for s in r]
            for op, r in zip(ops, run_ops(mesh, ops))]
