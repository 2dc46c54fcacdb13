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
shard.  With a ``predicate=`` the caller filters on anyway, a packed
column's zone map (or an explicit ``zone_map=``) lets it skip every
morsel whose blocks provably hold no match (``blocks_skipped`` /
``blocks_scanned``, folded into ``ShuffleMetrics`` by the stream).

:meth:`MorselSource.from_parquet` cuts each Parquet row group into
``P * morsel_rows``-row morsels; each replay re-decodes its row group from
the file (:func:`~..io.parquet.row_group_readers`), and a ``predicate=``
prunes the row groups whose footer statistics prove it false before any
replay is built (``row_groups_pruned`` / ``row_groups_scanned``).
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import config
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               ListColumn, StringColumn, StructColumn)
from ..columnar.encoded import (is_encoded, materialize_batch,
                                materialize_column)
from .buffers import batch_leaves, rebatch

_ZONE_OPS = ("<", "<=", "==", "!=", ">=", ">")


def _zone_keep(batch: ColumnBatch, predicate, zone_map, P: int, L: int,
               per_dev: int, k: int, M: int):
    """Per-morsel keep decisions from the filter column's zone map:
    ``(keep bool[k], blocks_skipped, blocks_scanned)``.

    Morsel ``j`` covers, per shard ``p``, global rows ``[p*per_dev +
    j*M, p*per_dev + (j+1)*M)``, the order the sidecar was built over;
    it is skipped only when EVERY zone block overlapping any of them
    provably holds no match.  The decision covers all ``P`` shards, so
    every rank of a process mesh makes the same one (``batch`` holds
    ``L`` of the shards; the sidecar covers all P).  A block
    straddling two morsels counts for each.  At least one morsel always
    stays: the stream takes its schema from one.
    """
    all_kept = ([True] * k, 0, 0)
    column, op, value = predicate
    if not bool(config.get("zone_maps")):
        return all_kept
    if (op not in _ZONE_OPS or not isinstance(value, (int, np.integer))
            or isinstance(value, bool)):
        return all_kept
    zm = zone_map
    if zm is None and column in batch.names and L == P:
        zm = getattr(batch[column], "zone", None)
    if zm is None or zm.rows != P * per_dev or (
            zm.column is not None and zm.column != column):
        # no sidecar, or one of another row count or another column:
        # not skipping is always safe
        return all_kept
    zm.verify()
    hit = zm.block_may_match(op, value)
    nb = zm.num_blocks
    covered = []
    for j in range(k):
        blocks = set()
        for p in range(P):
            lo = p * per_dev + j * M
            hi = min(lo + M, (p + 1) * per_dev)
            if hi > lo:
                blocks.update(range(lo // zm.block, (hi - 1) // zm.block + 1))
        covered.append({b for b in blocks if b < nb})
    keep = [bool(any(hit[b] for b in blocks)) for blocks in covered]
    if not any(keep):
        keep[0] = True
    skipped = sum(len(c) for c, kj in zip(covered, keep) if not kj)
    scanned = sum(len(c) for c, kj in zip(covered, keep) if kj)
    return keep, skipped, scanned


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _string_digest_bytes(col: StringColumn, valid: np.ndarray) -> bytes:
    """The reference's per-row string digest in one pass: a valid row
    gives its int32 length then its chars, a null row one ``0xff``."""
    chars, lens = _host(col.chars), _host(col.lengths).astype(np.int32)
    n, L = chars.shape
    rows = np.zeros((n, 4 + L), np.uint8)
    rows[:, :4] = lens.view(np.uint8).reshape(n, 4)
    rows[:, 4:] = chars
    rows[~valid, 0] = 0xFF
    j = np.arange(4 + L)[None, :]
    keep = np.where(valid[:, None], j < 4 + lens[:, None], j == 0)
    return rows[keep].tobytes()


def batch_digest(batch: ColumnBatch) -> str:
    """Digest of a batch's VALUES, byte for byte the reference's
    ``serve/data_plane.py`` ``batch_digest``: per column its name, then
    its validity bytes and its kind's values with null slots neutral
    (a plain or decimal column's type name and data with null slots
    zeroed; a string's length and chars per valid row, ``0xff`` per null
    one; a list's offsets then its child; a struct's field names and
    fields; an encoded column's decoded values).  The same contents give
    the same digest in both packages."""
    h = hashlib.sha256()

    def eat_col(col):
        valid = _host(col.validity).astype(bool)
        h.update(valid.astype(np.uint8).tobytes())
        if isinstance(col, StringColumn):
            h.update(_string_digest_bytes(col, valid))
        elif isinstance(col, Decimal128Column):
            h.update(str(col.dtype).encode())
            limbs = _host(col.limbs).view(np.uint64) * valid[:, None]
            h.update(limbs.tobytes())
        elif isinstance(col, ListColumn):
            h.update(_host(col.offsets).tobytes())
            eat_col(col.child)
        elif isinstance(col, StructColumn):
            for fname, child in zip(col.field_names, col.children):
                h.update(fname.encode())
                eat_col(child)
        elif isinstance(col, Column):
            data = _host(col.data)
            h.update(str(col.dtype).encode())
            h.update(np.where(valid, data, np.zeros((), data.dtype))
                     .tobytes())
        else:
            raise TypeError(f"cannot digest {type(col).__name__}")

    for name, col in zip(batch.names, batch.columns):
        h.update(name.encode())
        eat_col(materialize_column(col))
    return h.hexdigest()


def snapshot_for_batch(batch: ColumnBatch) -> str:
    """Content snapshot id of an in-memory batch (the reference's
    ``serve/result_cache.py`` ``snapshot_for_batch``)."""
    return "mem:" + batch_digest(batch)


def snapshot_for_path(path: str) -> str:
    """Snapshot id of a file input (the reference's
    ``serve/result_cache.py`` ``snapshot_for_path``): path + mtime_ns +
    size fingerprint.  Any rewrite of the file (even same-size) bumps
    mtime and therefore the id; a missing file raises rather than
    guessing."""
    st = os.stat(path)
    h = hashlib.sha256()
    h.update(os.path.abspath(path).encode())
    h.update(f":{st.st_mtime_ns}:{st.st_size}".encode())
    return "file:" + h.hexdigest()[:24]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    z = torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    return torch.cat([x, z])


class MorselSource:
    """An ordered sequence of replayable morsels with one fixed shape.

    Iterating yields the replay callables (what ``exchange_stream``
    consumes); ``len`` is the morsel count.  ``snapshot_id`` is the
    source's content id, computed on first read (it hashes the whole
    batch on the host) or given (a file's).
    """

    def __init__(self, replays: List[Callable], morsel_rows: int,
                 rows: int, mesh=None,
                 snapshot_of: Optional[ColumnBatch] = None,
                 snapshot_id: Optional[str] = None):
        self._replays = list(replays)
        self.morsel_rows = int(morsel_rows)
        self.rows = int(rows)
        self.mesh = mesh
        self._snapshot_id = snapshot_id
        self._snapshot_of = snapshot_of
        # the zone-map skip of the constructor, folded into the metrics
        # by the first exchange that streams this source
        self.blocks_skipped = 0
        self.blocks_scanned = 0
        self._zone_counts_recorded = False

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
        """Slice a row-sharded batch (the local shards of ``mesh``: all
        P of a :class:`~..parallel.mesh.ShardMesh`, a rank's own of a
        :class:`~..parallel.mesh.ProcessMesh`) into per-shard morsels;
        concatenating the valid rows of every morsel reproduces each
        shard in row order.  Encoded columns decode here (the stream
        decodes them anyway).

        ``predicate`` is an optional ``(column, op, value)`` filter the
        consumer applies downstream anyway: when the column carries a
        zone map (``zone_maps`` knob) or ``zone_map`` supplies one (it
        must cover all ``P * per_shard`` rows in global order), morsels
        whose every block provably fails the filter are never built, so
        the filtered stream equals the filtered full stream.  A sidecar
        is CRC-checked before it skips anything
        (:class:`~..columnar.encoded.ZoneMapCorruptionError`), and one
        tagged with another column never skips."""
        if morsel_rows is None:
            morsel_rows = int(config.get("scan_morsel_rows"))
        M = int(morsel_rows)
        if M <= 0:
            raise ValueError("morsel_rows must be positive")
        L = mesh.local_shards
        per_dev = mesh.shard_rows(batch.num_rows)
        k = max(1, math.ceil(per_dev / M))
        keep, skipped, scanned = [True] * k, 0, 0
        if predicate is not None:
            keep, skipped, scanned = _zone_keep(
                batch, predicate, zone_map, mesh.size, L, per_dev, k, M)
        if any(is_encoded(c) for c in batch.columns):
            batch = materialize_batch(batch)
        pad = k * M - per_dev
        dev = batch.columns[0].device if batch.columns else mesh.device
        if row_valid is None:
            row_valid = torch.ones((batch.num_rows,), dtype=torch.bool,
                                   device=dev)

        def shards(x):
            # [L * per_dev, ...] -> [L, k * M, ...], invalid zero padding
            v = x.reshape((L, per_dev) + tuple(x.shape[1:]))
            if pad:
                z = torch.zeros((L, pad) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
                v = torch.cat([v, z], dim=1)
            return v

        leaves = [shards(x) for x in batch_leaves(batch)]
        valid = shards(row_valid.to(torch.bool))

        def take(v, j):
            sl = v[:, j * M:(j + 1) * M]
            return sl.reshape((L * M,) + tuple(sl.shape[2:]))

        def make(j):
            def replay():
                return (rebatch(batch, [take(x, j) for x in leaves]),
                        take(valid, j))
            return replay

        src = cls([make(j) for j in range(k) if keep[j]], M,
                  batch.num_rows, mesh=mesh, snapshot_of=batch)
        src.blocks_skipped, src.blocks_scanned = skipped, scanned
        return src

    @classmethod
    def from_parquet(cls, path, mesh, columns=None,
                     morsel_rows: Optional[int] = None,
                     ignore_case: bool = False,
                     predicate=None) -> "MorselSource":
        """One morsel per ``P * morsel_rows``-row slice of each Parquet
        row group: the replay re-reads its row group from the file (the
        natural lineage — a damaged buffer costs one decode, not a
        cached copy), pads to the fixed shape and row-shards it (shard
        ``p`` holds the slice's rows ``[p * M, (p + 1) * M)``; a rank of a
        process mesh builds only its own).

        ``predicate`` (``(column, op, value)``) pushes the scan filter
        into the footer (``scan_pruning`` knob): row groups whose
        column min/max statistics cannot satisfy it are pruned before
        any replay is built, so cold groups never decode a page.
        """
        from ..io.parquet import row_group_readers

        if morsel_rows is None:
            morsel_rows = int(config.get("scan_morsel_rows"))
        M = int(morsel_rows)
        if M <= 0:
            raise ValueError("morsel_rows must be positive")
        L, first = mesh.local_shards, mesh.first_shard
        gm = mesh.size * M
        prune_counts = {}
        readers = row_group_readers(path, columns=columns,
                                    ignore_case=ignore_case,
                                    predicate=predicate,
                                    counters=prune_counts,
                                    device=mesh.device)

        def make(read, lo, n):
            # this process's shards of the slice [lo, lo + n)
            a, b = min(n, first * M), min(n, (first + L) * M)

            def replay():
                rg = read()
                leaves = [_pad_rows(x[lo + a:lo + b], L * M - (b - a))
                          for x in batch_leaves(rg)]
                rv = torch.arange(L * M, device=mesh.device) < (b - a)
                return rebatch(rg, leaves), rv
            return replay

        replays = []
        total = 0
        for read, rg_rows in readers:
            total += rg_rows
            for lo in range(0, max(rg_rows, 1), gm):
                n = min(gm, rg_rows - lo) if rg_rows else 0
                replays.append(make(read, lo, max(n, 0)))
        src = cls(replays, M, total, mesh=mesh,
                  snapshot_id=snapshot_for_path(path))
        src.row_groups_pruned = int(prune_counts.get("pruned", 0))
        src.row_groups_scanned = int(prune_counts.get("scanned", 0))
        return src
