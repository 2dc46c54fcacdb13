"""Morsels: replayable fixed-shape slices feeding the streaming exchange.

Counterpart of ``spark_rapids_jni_tpu/shuffle/morsel.py``.  A *morsel* is
the streaming exchange's unit of work: a fixed ``scan_morsel_rows``-per-
shard slice of the scan, mapped and scattered into round chunks while
earlier rounds drain (:meth:`ShuffleService.exchange_stream`).  Each is
delivered as a zero-argument *replay* callable returning
``(batch, row_valid)``; calling it again reproduces the morsel.

:meth:`MorselSource.from_batch` slices a row-sharded batch per SHARD (a
global row range would interleave senders and break bit-identity with the
materialized exchange): each shard is padded with invalid rows to a whole
number of morsels, and morsel ``j`` is rows ``[j*M, (j+1)*M)`` of every
shard.  Zone-map morsel skipping (``predicate=``, ``zone_map=``) is
ROADMAP.md queue 1, item 12; ``from_parquet`` is item 14.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .._roadmap import not_ported
from ..columnar.column import Column, ColumnBatch


def batch_digest(batch: ColumnBatch) -> str:
    """Digest of a batch's VALUES: per column its name, validity bytes,
    type name and data bytes with null slots zeroed — the reference's
    ``serve/data_plane.py`` ``batch_digest`` for plain columns, so the
    same contents give the same digest in both packages."""
    h = hashlib.sha256()
    for name, col in zip(batch.names, batch.columns):
        if not isinstance(col, Column):
            raise TypeError(f"cannot digest {type(col).__name__}")
        h.update(name.encode())
        valid = col.validity.cpu().numpy().astype(bool)
        h.update(valid.astype(np.uint8).tobytes())
        data = col.data.cpu().numpy()
        h.update(str(col.dtype).encode())
        h.update(np.where(valid, data, np.zeros((), data.dtype)).tobytes())
    return h.hexdigest()


def snapshot_for_batch(batch: ColumnBatch) -> str:
    """Content snapshot id of an in-memory batch (the reference's
    ``serve/result_cache.py`` ``snapshot_for_batch``)."""
    return "mem:" + batch_digest(batch)


class MorselSource:
    """An ordered sequence of replayable morsels with one fixed shape.

    Iterating yields the replay callables (what ``exchange_stream``
    consumes); ``len`` is the morsel count.  ``snapshot_id`` is the
    source's content id, computed on first read (it hashes the whole
    batch on the host).
    """

    def __init__(self, replays: List[Callable], morsel_rows: int,
                 rows: int, mesh=None,
                 snapshot_of: Optional[ColumnBatch] = None):
        self._replays = list(replays)
        self.morsel_rows = int(morsel_rows)
        self.rows = int(rows)
        self.mesh = mesh
        self._snapshot_id = None
        self._snapshot_of = snapshot_of

    @property
    def snapshot_id(self) -> Optional[str]:
        if self._snapshot_id is None and self._snapshot_of is not None:
            self._snapshot_id = snapshot_for_batch(self._snapshot_of)
            self._snapshot_of = None
        return self._snapshot_id

    def __iter__(self):
        return iter(self._replays)

    def __len__(self) -> int:
        return len(self._replays)

    @classmethod
    def from_batch(cls, batch: ColumnBatch, mesh,
                   morsel_rows: Optional[int] = None, row_valid=None,
                   predicate=None, zone_map=None) -> "MorselSource":
        """Slice a row-sharded batch (a :class:`~..parallel.mesh.ShardMesh`
        of ``mesh.size`` shards) into per-shard morsels; concatenating the
        valid rows of every morsel reproduces each shard in row order."""
        from .. import config

        if predicate is not None or zone_map is not None:
            raise not_ported("zone-map morsel skipping (predicate=, "
                             "zone_map=)", 12)
        if morsel_rows is None:
            morsel_rows = int(config.get("scan_morsel_rows"))
        M = int(morsel_rows)
        if M <= 0:
            raise ValueError("morsel_rows must be positive")
        P = mesh.size
        per_dev = mesh.shard_rows(batch.num_rows)
        k = max(1, math.ceil(per_dev / M))
        pad = k * M - per_dev
        dev = batch.columns[0].data.device if batch.columns else mesh.device
        if row_valid is None:
            row_valid = torch.ones((batch.num_rows,), dtype=torch.bool,
                                   device=dev)

        def shards(x):
            # [P * per_dev, ...] -> [P, k * M, ...], invalid zero padding
            v = x.reshape((P, per_dev) + tuple(x.shape[1:]))
            if pad:
                z = torch.zeros((P, pad) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
                v = torch.cat([v, z], dim=1)
            return v

        cols = {name: (shards(c.data), shards(c.validity), c.dtype)
                for name, c in zip(batch.names, batch.columns)}
        valid = shards(row_valid.to(torch.bool))

        def take(v, j):
            sl = v[:, j * M:(j + 1) * M]
            return sl.reshape((P * M,) + tuple(sl.shape[2:]))

        def make(j):
            def replay():
                return (ColumnBatch({
                    name: Column(take(d, j), take(vv, j), t)
                    for name, (d, vv, t) in cols.items()}),
                    take(valid, j))
            return replay

        return cls([make(j) for j in range(k)], M, batch.num_rows,
                   mesh=mesh, snapshot_of=batch)

    @classmethod
    def from_parquet(cls, path, mesh, *args, **kwargs):
        raise not_ported("MorselSource.from_parquet", 14)
