"""Distributed relational operators: exchange, then the local operator.

Counterpart of ``spark_rapids_jni_tpu/parallel/distributed.py``.  The
reference runs each operator as one ``shard_map`` program: map-side
partition, the all-to-all, and the reduce-side operator per device.  The
port writes each operator once over a mesh (:mod:`.mesh`):

* the exchange runs over the mesh (:func:`.shuffle.exchange`, the
  lossless :class:`~..shuffle.ShuffleService`, or the two-hop
  :func:`.shuffle.exchange_hierarchical`);
* the per-device body runs once per local shard: each of the P row
  slices of a :class:`~.mesh.ShardMesh` in turn (so each shard's kernels
  launch on their own, as on P cards), or the rank's own rows on a
  :class:`~.mesh.ProcessMesh`;
* collectives (sum and max all-reduce, all-gather) go through the mesh.

Per-device outputs come back row-sharded like the reference's: a shard
mesh returns every shard's rows and ``[P]`` per-shard vectors, a rank its
own rows and ``[1]``.  Replicated results (the domain group-by) are whole
on every rank.  Counts are int64 (the reference's per-device int32 join
count wraps past 2^31).  The reference's ``axis_name`` arguments have no
counterpart: a mesh here has one axis, a :class:`~.mesh.HierMesh` two
named levels.  Task-context charging (``ctx=``) and spill-registered
broadcast builds are ROADMAP.md queue 1, item 13.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._roadmap import not_ported
from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from ..relational.aggregate import AggSpec, group_by
from .mesh import HierMesh
from .partition import spark_partition_id
from .shuffle import (bucket_counts, exchange, exchange_hierarchical,
                      plan_capacity, route_out_of_range)


def _no_ctx(ctx, what: str) -> None:
    if ctx is not None:
        raise not_ported(f"charging {what} to a task context (ctx=)", 13)


def _ones(batch: ColumnBatch) -> torch.Tensor:
    return torch.ones((batch.num_rows,), dtype=torch.bool,
                      device=batch.columns[0].device)


def _key_pid(batch, key_names, P: int, row_valid=None) -> torch.Tensor:
    rv = _ones(batch) if row_valid is None else row_valid.to(torch.bool)
    return spark_partition_id([batch[k] for k in key_names], P, rv)


def _zeros(mesh, device, *shape) -> torch.Tensor:
    return torch.zeros((mesh.local_shards,) + shape, dtype=torch.int64,
                       device=device)


def _per_shard(mesh, fn, *args):
    """Run ``fn`` on each local shard's row slices of ``args``; returns
    its per-shard results joined back (:meth:`join`), one output per
    element of ``fn``'s result tuple."""
    outs = [fn(*parts) for parts in zip(*[mesh.split(a) for a in args])]
    return tuple(mesh.join(list(col)) for col in zip(*outs))


def _service_exchange(mesh, batch, **kw):
    from ..shuffle import ShuffleService

    res = ShuffleService(mesh).exchange(batch, **kw)
    return res.batch, res.occupancy


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------

def distributed_group_by(batch: ColumnBatch, key_names: Sequence[str],
                         aggs: Sequence[AggSpec], mesh, row_valid=None,
                         capacity: Optional[int] = None, ctx=None):
    """Exchange rows by key hash, then group each shard's rows locally.

    Spark semantics hold globally because the exchange is complete: all
    rows of one key meet on one shard (the Spark-exact partition id), so
    the shards' groups are disjoint.  Returns ``(result, num_groups,
    dropped)``: ``result`` is row-sharded with each shard's groups in
    front of its rows, ``num_groups`` int64 per shard, ``dropped`` int64
    per shard (zero on the default path: with ``capacity`` unset the
    exchange is the lossless :class:`~..shuffle.ShuffleService`; an
    explicit ``capacity`` runs the single-round fixed-grid exchange).
    The local group-by is :func:`~..relational.aggregate.group_by` on the
    ``groupby_engine`` knob's engine (the slot-table build kernel by
    default).
    """
    _no_ctx(ctx, "a distributed group-by")
    dev = batch.columns[0].device
    if capacity is None:
        shuffled, occ = _service_exchange(mesh, batch, key_names=key_names,
                                          row_valid=row_valid)
        dropped = _zeros(mesh, dev)
    else:
        pid = _key_pid(batch, key_names, mesh.size, row_valid)
        shuffled, occ, dropped = exchange(batch, pid, mesh, capacity)
    result, ng = _per_shard(
        mesh, lambda b, o: group_by(b, key_names, aggs, row_valid=o),
        shuffled, occ)
    return result, ng, dropped


def plan_exchange_capacity(batch: ColumnBatch, key_names, mesh,
                           row_valid=None, bucket: Optional[int] = None
                           ) -> int:
    """The exact global max bucket of a key exchange, rounded up to
    ``bucket`` (default: the ``shuffle_capacity_bucket`` knob)."""
    if bucket is None:
        from .. import config

        bucket = int(config.get("shuffle_capacity_bucket"))
    pid = _key_pid(batch, key_names, mesh.size, row_valid)
    cmax = int(plan_capacity(pid, mesh).item())
    return max(bucket, -(-cmax // bucket) * bucket)


def _pylist(col) -> list:
    if hasattr(col, "to_pylist"):
        return col.to_pylist()
    data, valid = col.data.cpu().tolist(), col.validity.cpu().tolist()
    return [d if v else None for d, v in zip(data, valid)]


def collect_groups(result: ColumnBatch, num_groups, mesh=None) -> dict:
    """Host-side: every shard's live group rows, concatenated in shard
    order, as ``{column: pylist}``.  On a :class:`~.mesh.ProcessMesh`
    the ranks' rows cross in one all-gather per leaf, so every rank gets
    the whole table; otherwise (``mesh=None``) every shard is local."""
    from ..relational.gather import gather_batch
    from ..shuffle.buffers import batch_leaves, rebatch

    ng = torch.as_tensor(num_groups).reshape(-1).cpu().tolist()
    L = len(ng)
    per = result.num_rows // L
    dev = result.columns[0].device
    idx = torch.as_tensor(
        np.concatenate([d * per + np.arange(int(ng[d]))
                        for d in range(L)]).astype(np.int64), device=dev)
    live = gather_batch(result, idx)
    if mesh is not None and not mesh.holds_all:
        live = rebatch(live, [mesh.all_gather_rows(x)
                              for x in batch_leaves(live)])
    return {name: _pylist(col) for name, col in zip(live.names,
                                                    live.columns)}


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def distributed_hash_join(left: ColumnBatch, right: ColumnBatch,
                          left_on: Sequence[str], right_on: Sequence[str],
                          how: str, mesh, capacity: Optional[int] = None,
                          out_capacity: Optional[int] = None, ctx=None):
    """Exchange both sides by key hash, then join each shard locally.

    Matching keys land on one shard (identical murmur3 partition ids on
    both sides).  Returns ``(result, counts int64 per shard, dropped int64
    [shards, 2])``; each shard's matches are in front of its rows.  The
    local join is :func:`~..relational.join.hash_join` (the slot-table
    build, record and probe kernels by default).  With ``capacity`` unset
    both sides go through the lossless service (``dropped`` is zeros); an
    explicit ``capacity`` runs the fixed-grid exchange.
    """
    from ..relational.join import hash_join

    _no_ctx(ctx, "a distributed hash join")
    dev = left.columns[0].device
    if capacity is None:
        ls, locc = _service_exchange(mesh, left, key_names=left_on)
        rs, rocc = _service_exchange(mesh, right, key_names=right_on)
        dropped = _zeros(mesh, dev, 2)
    else:
        P = mesh.size
        ls, locc, ldrop = exchange(left, _key_pid(left, left_on, P), mesh,
                                   capacity)
        rs, rocc, rdrop = exchange(right, _key_pid(right, right_on, P),
                                   mesh, capacity)
        dropped = torch.stack([ldrop, rdrop], 1)

    def body(lb, lo, rb, ro):
        return hash_join(lb, rb, list(left_on), list(right_on), how,
                         capacity=out_capacity, left_valid=lo,
                         right_valid=ro)

    out, counts = _per_shard(mesh, body, ls, locc, rs, rocc)
    return out, counts, dropped


def broadcast_build_handle(right: ColumnBatch, ctx=None,
                           name: Optional[str] = None):
    """A spill-registered broadcast build: ROADMAP.md queue 1, item 13."""
    raise not_ported("a spill-registered broadcast build "
                     "(broadcast_build_handle)", 13)


def distributed_broadcast_join(left: ColumnBatch,
                               right: Optional[ColumnBatch],
                               left_on: Sequence[str],
                               right_on: Sequence[str], how: str, mesh,
                               dense_domain: Optional[int] = None,
                               out_capacity: Optional[int] = None,
                               build=None, ctx=None):
    """Broadcast-hash join: the whole build side is on every shard and
    the sharded probe side never moves — no exchange.

    With ``dense_domain`` set and one key per side each shard takes the
    dense rowid path (:func:`~..relational.join.join_dense_or_hash`),
    otherwise :func:`~..relational.join.hash_join`.  Join types inner,
    left, semi and anti compose across shards; ``right``/``full`` would
    emit an unmatched build row once per shard, so they raise (use
    :func:`distributed_hash_join`).  Returns ``(result, counts int64 per
    shard)``.  On a :class:`~.mesh.ProcessMesh` every rank passes the
    whole ``right``.
    """
    from ..relational.join import hash_join, join_dense_or_hash

    if how in ("right", "full"):
        raise ValueError(
            f"broadcast join cannot run {how!r}: unmatched build rows "
            "are per-shard facts on a replicated build side (each shard "
            "would emit its own copy) — use distributed_hash_join")
    if len(left_on) != len(right_on):
        raise ValueError("left_on/right_on length mismatch")
    if build is not None:
        raise not_ported("a spill-registered broadcast build (build=)", 13)
    _no_ctx(ctx, "a broadcast build")
    if right is None:
        raise ValueError("need the right batch")
    right = _to_device(right, mesh.device)

    def body(lb):
        if dense_domain is not None and len(left_on) == 1:
            return join_dense_or_hash(lb, right, left_on[0], right_on[0],
                                      int(dense_domain), how,
                                      capacity=out_capacity)
        return hash_join(lb, right, list(left_on), list(right_on), how,
                         capacity=out_capacity)

    return _per_shard(mesh, body, left)


def _to_device(batch: ColumnBatch, device) -> ColumnBatch:
    from ..shuffle.buffers import batch_leaves, rebatch

    return rebatch(batch, [t.to(device) for t in batch_leaves(batch)])


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def _sample_splitters(batch: ColumnBatch, key_names, mesh) -> torch.Tensor:
    """The sample-sort splitter plan: the global batch's rows at a fixed
    stride, their radix key words sorted, P - 1 picks.  Each shard takes
    its rows whose GLOBAL index is a multiple of the stride and an
    all-gather in shard order rebuilds the reference's exact sample, so
    every rank computes the same splitters.  Returns int64 ``[P - 1,
    words]``."""
    from ..relational import keys as K

    P, L = mesh.size, mesh.local_shards
    karr = K.batch_radix_keys([batch[k] for k in key_names],
                              equality=False, nulls_first=True)
    n_local = karr[0].shape[0]
    n = n_local // L * P
    sample_n = min(n, max(P * 64, 1024))
    stride = max(n // max(sample_n, 1), 1)
    g0 = mesh.first_shard * (n_local // L)
    idx = torch.arange((-g0) % stride, n_local, stride,
                       device=karr[0].device)
    words = mesh.all_gather_rows(torch.stack([a[idx] for a in karr], 1))
    words = words.cpu().numpy()
    order = np.lexsort(words[:, ::-1].T)
    picks = order[np.linspace(0, words.shape[0] - 1,
                              P + 1).astype(np.int64)[1:-1]]
    return torch.as_tensor(words[picks], device=karr[0].device)


def _range_pid(batch: ColumnBatch, key_names, splitters: torch.Tensor,
               P: int) -> torch.Tensor:
    """int32 range partition per row: how many splitters the row's key
    words exceed (lexicographically)."""
    from ..relational import keys as K

    karr = K.batch_radix_keys([batch[k] for k in key_names],
                              equality=False, nulls_first=True)
    R = karr[0].shape[0]
    dev = karr[0].device
    pid = torch.zeros((R,), dtype=torch.int32, device=dev)
    for s in range(P - 1):
        gt = torch.zeros((R,), dtype=torch.bool, device=dev)
        lt = torch.zeros((R,), dtype=torch.bool, device=dev)
        for w, a in enumerate(karr):
            sw = splitters[s, w]
            gt = gt | (~lt & (a > sw))
            lt = lt | (~gt & (a < sw))
        pid = pid + gt.to(torch.int32)
    return pid


def _local_sort_with_occ(shuffled: ColumnBatch, occ: torch.Tensor,
                         key_names):
    """Local sort with dead exchange slots last (the shared epilogue)."""
    from ..relational.sort import SortKey, sort_by

    occ32 = occ.to(torch.int32)
    aug = shuffled.with_column(
        "__occ", Column(occ32, torch.ones_like(occ), T.INT32))
    out = sort_by(aug, [SortKey("__occ", ascending=False)]
                  + [SortKey(k) for k in key_names])
    occ_sorted = out["__occ"].data == 1
    return out.select([n for n in out.names if n != "__occ"]), occ_sorted


def distributed_sort(batch: ColumnBatch, key_names: Sequence[str], mesh,
                     capacity: Optional[int] = None, ctx=None):
    """Global sort: range-partition by sampled splitters, then sort each
    shard.  Returns ``(result, occupancy, dropped)``: shard d holds the
    d-th global key range in sorted order, its live rows first.  With
    ``capacity`` unset the range exchange is the lossless service;
    an explicit ``capacity`` runs the fixed-grid exchange."""
    _no_ctx(ctx, "a distributed sort")
    P = mesh.size
    splitters = _sample_splitters(batch, key_names, mesh)
    pid = _range_pid(batch, key_names, splitters, P)
    if capacity is None:
        shuffled, occ = _service_exchange(mesh, batch, pid=pid)
        dropped = _zeros(mesh, pid.device)
    else:
        shuffled, occ, dropped = exchange(batch, pid, mesh, capacity)
    out, occ_sorted = _per_shard(
        mesh, lambda b, o: _local_sort_with_occ(b, o, key_names),
        shuffled, occ)
    return out, occ_sorted, dropped


# ---------------------------------------------------------------------------
# two-level (hosts x chips) mesh
# ---------------------------------------------------------------------------

def _hier_count_matrix(pid: torch.Tensor, mesh) -> np.ndarray:
    """The host ``[P senders, P destinations]`` count matrix of a
    row-sharded pid array: each shard counts its row, one all-gather."""
    P = mesh.size
    _, counts = bucket_counts(route_out_of_range(pid, P)[0], P,
                              mesh.local_shards)
    return mesh.all_gather(counts).cpu().numpy()


def _plan_2d_capacities(pid, mesh: HierMesh, capacity_dcn, capacity_ici):
    """Per-hop capacities: explicit values stay, the rest come from the
    observed count matrix (:func:`~..shuffle.plan_hierarchical`)."""
    from ..shuffle.planner import plan_hierarchical

    if capacity_dcn is not None and capacity_ici is not None:
        return capacity_dcn, capacity_ici
    hplan = plan_hierarchical(_hier_count_matrix(pid, mesh.flat),
                              mesh.n_hosts, mesh.chips)
    if capacity_dcn is None:
        capacity_dcn = hplan.capacity_dcn
        if capacity_ici is None:
            capacity_ici = hplan.capacity_ici
    if capacity_ici is None:
        # an explicit hop-one value without a hop-two one keeps the
        # always-lossless coupling
        capacity_ici = mesh.n_hosts * capacity_dcn
    return capacity_dcn, capacity_ici


def distributed_group_by_2d(batch: ColumnBatch, key_names: Sequence[str],
                            aggs: Sequence[AggSpec], mesh: HierMesh,
                            capacity_dcn: Optional[int] = None,
                            capacity_ici: Optional[int] = None):
    """Group-by over a :class:`~.mesh.HierMesh` through the two-hop
    exchange (rows cross each level once).  Unset capacities are planned
    from one pid pass (:func:`~..shuffle.plan_hierarchical`).  Returns
    ``(result, num_groups, dropped)`` like :func:`distributed_group_by`."""
    P = mesh.size
    pid = _key_pid(batch, key_names, P)
    capacity_dcn, capacity_ici = _plan_2d_capacities(
        pid, mesh, capacity_dcn, capacity_ici)
    shuffled, occ, dropped = exchange_hierarchical(
        batch, pid, mesh, capacity_dcn, capacity_ici)
    result, ng = _per_shard(
        mesh.flat, lambda b, o: group_by(b, key_names, aggs, row_valid=o),
        shuffled, occ)
    return result, ng, dropped


def distributed_hash_join_2d(left: ColumnBatch, right: ColumnBatch,
                             left_on: Sequence[str],
                             right_on: Sequence[str], how: str,
                             mesh: HierMesh,
                             capacity_dcn: Optional[int] = None,
                             out_capacity: Optional[int] = None):
    """Hash join over a :class:`~.mesh.HierMesh` through the two-hop
    exchange; with ``capacity_dcn`` unset both sides' count matrices are
    planned and each hop takes the larger side's capacity."""
    from ..relational.join import hash_join

    P = mesh.size
    lpid = _key_pid(left, left_on, P)
    rpid = _key_pid(right, right_on, P)
    if capacity_dcn is None:
        lc = _plan_2d_capacities(lpid, mesh, None, None)
        rc = _plan_2d_capacities(rpid, mesh, None, None)
        capacity_dcn, capacity_ici = max(lc[0], rc[0]), max(lc[1], rc[1])
    else:
        capacity_ici = mesh.n_hosts * capacity_dcn
    ls, locc, ldrop = exchange_hierarchical(left, lpid, mesh, capacity_dcn,
                                            capacity_ici)
    rs, rocc, rdrop = exchange_hierarchical(right, rpid, mesh,
                                            capacity_dcn, capacity_ici)

    def body(lb, lo, rb, ro):
        return hash_join(lb, rb, list(left_on), list(right_on), how,
                         capacity=out_capacity, left_valid=lo,
                         right_valid=ro)

    out, counts = _per_shard(mesh.flat, body, ls, locc, rs, rocc)
    return out, counts, torch.stack([ldrop, rdrop], 1)


def distributed_sort_2d(batch: ColumnBatch, key_names: Sequence[str],
                        mesh: HierMesh,
                        capacity_dcn: Optional[int] = None):
    """Global sample-sort over a :class:`~.mesh.HierMesh`: the splitter
    plan of :func:`distributed_sort` with P = hosts * chips ranges,
    routed through the two-hop exchange.  Shard ``(h, d)`` holds range
    ``h * chips + d`` in sorted order."""
    P = mesh.size
    splitters = _sample_splitters(batch, key_names, mesh.flat)
    pid = _range_pid(batch, key_names, splitters, P)
    if capacity_dcn is None:
        capacity_dcn, capacity_ici = _plan_2d_capacities(pid, mesh, None,
                                                         None)
    else:
        capacity_ici = mesh.n_hosts * capacity_dcn
    shuffled, occ, dropped = exchange_hierarchical(
        batch, pid, mesh, capacity_dcn, capacity_ici)
    out, occ_sorted = _per_shard(
        mesh.flat, lambda b, o: _local_sort_with_occ(b, o, key_names),
        shuffled, occ)
    return out, occ_sorted, dropped


# ---------------------------------------------------------------------------
# small-domain keys: map-side combine and the one-hot group-by
# ---------------------------------------------------------------------------

def _flat_partials(parts: dict):
    """A partials dict's tensors in a fixed order, with its layout."""
    out = []
    for name in ("star", "cnt", "isum", "fsum", "d64"):
        v = parts[name]
        if isinstance(v, dict):
            out.extend((name, c, v[c]) for c in sorted(v))
        else:
            out.append((name, None, v))
    return out


def distributed_group_by_domain(batch: ColumnBatch, key_name: str,
                                aggs: Sequence[AggSpec], domain: int,
                                mesh, row_valid=None, engine: str = "auto",
                                float_mode: str = "f32x3"):
    """Map-side combine: no row exchange for a small-domain key.

    Each shard reduces its rows into additive ``[K+1]``-bucket partials
    through the one-hot group-by kernel
    (:func:`~..relational.aggregate._domain_partials`), ONE sum
    all-reduce per dtype merges them (counts, int sums, float sums and the
    decimal lanes), and every shard finalizes the same table.  sum, count
    and mean over int, float (the kernel's f32x3 sums, rel 1e-5) and
    decimal columns.  Returns ``(result, num_groups, overflow)``, all
    replicated; ``overflow`` is True when a key fell outside ``[0,
    domain)`` on any shard.
    """
    from ..relational.aggregate import _domain_partials, _finalize_domain

    shards = mesh.split(batch)
    rvs = mesh.split(row_valid)
    got = [_domain_partials(b, key_name, list(aggs), int(domain),
                            row_valid=rv, engine=engine,
                            float_mode=float_mode)
           for b, rv in zip(shards, rvs)]
    layouts = [_flat_partials(p) for p, _ in got]
    merged = {}
    for dtype in sorted({t.dtype for _, _, t in layouts[0]}, key=str):
        picks = [i for i, (_, _, t) in enumerate(layouts[0])
                 if t.dtype == dtype]
        stacked = torch.stack([
            torch.cat([lay[i][2].reshape(-1) for i in picks])
            for lay in layouts])
        total = mesh.all_reduce(stacked, "sum")
        at = 0
        for i in picks:
            name, col, t = layouts[0][i]
            piece = total[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
            if col is None:
                merged[name] = piece
            else:
                merged.setdefault(name, {})[col] = piece
    for name in ("cnt", "isum", "fsum", "d64"):
        merged.setdefault(name, {})
    ovf = mesh.all_reduce(torch.stack([o.to(torch.int32)
                                       for _, o in got]), "max") > 0
    res, ng = _finalize_domain(shards[0], key_name, int(domain), list(aggs),
                               merged)
    return res, ng, ovf


def distributed_group_by_onehot(batch: ColumnBatch, key_name: str,
                                aggs: Sequence[AggSpec], domain: int, mesh,
                                capacity: Optional[int] = None):
    """Exchange by key hash (fixed grid, planned capacity by default),
    then the one-hot group-by per shard
    (:func:`~..relational.aggregate.group_by_onehot`).  Returns
    ``(result, num_groups, dropped, overflow)``, per shard; ``overflow``
    marks a shard where a key fell outside ``[0, domain)``."""
    from ..relational.aggregate import group_by_onehot

    if capacity is None:
        capacity = plan_exchange_capacity(batch, [key_name], mesh)
    pid = _key_pid(batch, [key_name], mesh.size)
    shuffled, occ, dropped = exchange(batch, pid, mesh, capacity)
    res, ng, ovf = _per_shard(
        mesh, lambda b, o: group_by_onehot(b, key_name, list(aggs),
                                           int(domain), row_valid=o),
        shuffled, occ)
    return res, ng, dropped, ovf
