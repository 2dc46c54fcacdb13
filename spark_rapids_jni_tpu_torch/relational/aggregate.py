"""Group-by aggregation with Spark hash-aggregate semantics.

Counterpart of ``spark_rapids_jni_tpu/relational/aggregate.py`` for the
pieces the q6 and q95 pipelines run:

* :func:`group_by`, the general engine pair picked by the
  ``groupby_engine`` knob: **sort** (one stable lexicographic sort over
  the radix key words, then segment sums) and **kernel** (the slot-table
  hash engine: rows map to key groups through
  :func:`hashtable.build_slot_table`, aggregates are segment sums over
  slots, and only the S-slot table is sorted so groups come out in the
  sort engine's order).  A slot table that overflows falls back to the
  sort engine — a choice between results, not a way around the kernel.
* :func:`group_by_onehot`, the domain engine for one integer key in a
  small static domain ``[0, domain)`` (the q6 shape): one launch of the
  one-hot group-by kernel reads the key, the row mask and the referenced
  columns once and sums count(*), the non-null counts, the int sums (mod
  2^64, Spark's non-ANSI wraparound, the reference's byte-limb bits) and
  the float sums (three exact Dekker f32 limbs) per bucket.
* :func:`group_by_domain_or_sort`, the domain engine when every live key
  fits the domain and the general engine otherwise.

Spark semantics (as in the reference): null keys form their own group;
sum ignores nulls and an all-null group sums to null; count(col) counts
non-nulls, count(*) rows; sum(int) is int64 wrapping mod 2^64, sum(float)
and avg are float64.  Output batches are padded to the input row count
with a ``num_groups`` count; groups are in key order, nulls first (the
domain engine: key order, null group last).

min/max aggregates and decimal and string columns are ROADMAP.md queue 1,
item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import config
from .._roadmap import not_ported
from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from . import keys as K
from .gather import gather_column

_OPS = ("sum", "count", "min", "max", "mean")
_DEFAULT_GROUP_SLOTS = 4096


@dataclasses.dataclass(frozen=True)
class AggSpec:
    op: str           # sum | count | min | max | mean
    column: Optional[str]  # None only for count(*)
    out_name: str

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown agg op {self.op!r}")
        if self.column is None and self.op != "count":
            raise ValueError("only count supports column=None (count(*))")


def _sum_dtype(dtype: T.SparkType) -> T.SparkType:
    if dtype.kind in (T.Kind.BOOLEAN, T.Kind.INT32, T.Kind.INT64):
        return T.INT64
    if dtype.kind in T.FLOAT_KINDS:
        return T.FLOAT64
    raise NotImplementedError(f"sum of {dtype!r}")


def _check_aggs(batch: ColumnBatch, aggs: Sequence[AggSpec]) -> None:
    for spec in aggs:
        if spec.op in ("min", "max"):
            raise not_ported(f"{spec.op} aggregation", 10)
        if spec.column is not None:
            col = batch[spec.column]
            if not isinstance(col, Column):
                raise not_ported(f"aggregation over {type(col).__name__}",
                                 10)
            if spec.op in ("sum", "mean"):
                _sum_dtype(col.dtype)


def _resolve_groupby_engine(engine):
    """``None`` reads the ``groupby_engine`` knob; ``auto`` is the kernel
    tier on every device."""
    if engine is None:
        engine = config.get("groupby_engine")
    if engine == "auto":
        return "kernel"
    if engine not in ("sort", "kernel"):
        raise ValueError(f"unknown groupby engine {engine!r} "
                         "(use 'auto', 'sort' or 'kernel')")
    return engine


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _fit_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad the leading dim of ``a`` to ``n`` rows."""
    if a.shape[0] >= n:
        return a[:n]
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad])


def _segment_aggs(batch, aggs, row_live, seg, num_segments, per_group,
                  out_valid):
    """Every sum/count/mean in ``aggs`` as segment sums of rows into
    ``num_segments`` bins (``seg`` per row; dead rows go to a discard
    bin), mapped to group order by ``per_group``."""
    def seg_sum(vals):
        acc = torch.zeros((num_segments,), dtype=vals.dtype,
                          device=vals.device)
        return per_group(acc.index_add_(0, seg, vals))

    out = {}
    for spec in aggs:
        if spec.op == "count":
            ones = row_live if spec.column is None else (
                batch[spec.column].validity & row_live)
            out[spec.out_name] = Column(seg_sum(ones.to(torch.int64)),
                                        out_valid, T.INT64)
            continue
        col = batch[spec.column]
        valid = col.validity & row_live
        nn = seg_sum(valid.to(torch.int64))
        if spec.op == "sum":
            out_t = _sum_dtype(col.dtype)
        else:
            out_t = T.FLOAT64
        acc = col.data.to(out_t.torch_dtype if spec.op == "sum"
                          else torch.float64)
        s = seg_sum(torch.where(valid, acc, torch.zeros_like(acc)))
        if spec.op == "mean":
            s = s / nn.clamp(min=1).to(torch.float64)
        out[spec.out_name] = Column(s, out_valid & (nn > 0), out_t)
    return out


def group_by(batch: ColumnBatch, key_names: Sequence[str],
             aggs: Sequence[AggSpec], row_valid=None, *, engine=None,
             num_slots=None, assume_grouped: bool = False) -> tuple:
    """Group ``batch`` by ``key_names``; returns ``(result, num_groups)``.

    The result has the key columns (key order, nulls first) then one
    column per :class:`AggSpec`, padded to the input row count with null
    rows past ``num_groups``.  ``row_valid`` marks rows that exist.

    ``engine``: ``'sort' | 'kernel' | 'auto'`` (default: the
    ``groupby_engine`` knob).  The kernel engine's table holds
    ``num_slots`` keys (power of two, default 4096, clamped to 2n); more
    distinct keys fall back to the sort engine.  ``assume_grouped``: the
    caller guarantees equal keys are adjacent and dead rows trail; the
    sort is skipped and groups come out in first-appearance order.
    """
    _check_aggs(batch, aggs)
    eng = _resolve_groupby_engine(engine)
    if not assume_grouped and eng == "kernel":
        return _group_by_hash(batch, key_names, aggs, row_valid, num_slots)
    return _group_by_sortscan(batch, key_names, aggs, row_valid,
                              assume_grouped)


def _group_by_sortscan(batch, key_names, aggs, row_valid, assume_grouped):
    """The sort engine: one stable lexicographic sort, then segment sums."""
    n = batch.num_rows
    dev = batch[key_names[0]].data.device
    karr = K.batch_radix_keys([batch[k] for k in key_names], equality=True,
                              nulls_first=True)
    have_rv = row_valid is not None
    if have_rv:
        occ = row_valid.to(torch.bool)
        karr = [(~occ).to(torch.int64)] + [
            torch.where(occ, k, torch.zeros_like(k)) for k in karr]
    sperm = _arange(n, dev) if assume_grouped else K.lexsort(karr)
    skeys = [k[sperm] for k in karr]
    boundary = ~K.rows_equal_adjacent(skeys)
    sorted_occ = (skeys[0] == 0) if have_rv else torch.ones(
        (n,), dtype=torch.bool, device=dev)
    starts = boundary & sorted_occ
    num_groups = starts.sum()
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    seg = torch.where(sorted_occ, gid, torch.full_like(gid, n))
    out_valid = _arange(n, dev) < num_groups

    rows0 = torch.zeros((n,), dtype=torch.int64, device=dev)
    rows0[gid[starts]] = sperm[starts]
    out = {name: gather_column(batch[name], rows0, out_valid)
           for name in key_names}
    sbatch = ColumnBatch({
        spec.column: gather_column(batch[spec.column], sperm)
        for spec in aggs if spec.column is not None})
    out.update(_segment_aggs(sbatch, aggs, sorted_occ, seg, n + 1,
                             lambda a: a[:n], out_valid))
    return ColumnBatch(out), num_groups


def _group_by_hash(batch, key_names, aggs, row_valid, num_slots):
    """The kernel engine: slot-table key mapping + segment sums; falls
    back to the sort engine when the table overflows."""
    from . import hashtable as H
    from ..plan import adaptive as _adaptive

    n = batch.num_rows
    dev = batch[key_names[0]].data.device
    karr = K.batch_radix_keys([batch[k] for k in key_names], equality=True,
                              nulls_first=True)
    row_live = (torch.ones((n,), dtype=torch.bool, device=dev)
                if row_valid is None else row_valid.to(torch.bool))
    S = H.next_pow2(_DEFAULT_GROUP_SLOTS if num_slots is None
                    else int(num_slots))
    S = min(S, H.next_pow2(2 * n))
    owner, slot, overflow = H.build_slot_table(
        karr, row_live, S, max_rounds=_adaptive.bound_build_rounds(n, S))
    if bool(overflow.item()):
        return _group_by_sortscan(batch, key_names, aggs, row_valid, False)
    return _scatter_groups(batch, key_names, aggs, karr, row_live, owner,
                           slot, S)


def _scatter_groups(batch, key_names, aggs, karr, row_live, owner, slot, S):
    """Segment sums over a resolved slot table; the S slots then sort by
    their owner's key words (a table-sized sort) so groups come out in the
    sort engine's order with the same representative row."""
    n = batch.num_rows
    dev = owner.device
    dead_slot = owner == n
    oc = owner.to(torch.int64).clamp(0, max(n - 1, 0))
    ops = [dead_slot.to(torch.int64)] + [
        torch.where(dead_slot, torch.zeros_like(oc), k[oc] if n else oc)
        for k in karr]
    rank2slot = K.lexsort(ops)
    num_groups = (~dead_slot).sum()
    out_valid = _arange(n, dev) < num_groups

    def per_group(per_slot):
        return _fit_rows(per_slot[:S][rank2slot], n)

    rows0 = per_group(oc)
    out = {name: gather_column(batch[name], rows0, out_valid)
           for name in key_names}
    out.update(_segment_aggs(batch, aggs, row_live, slot.to(torch.int64),
                             S + 1, per_group, out_valid))
    return ColumnBatch(out), num_groups


# ---------------------------------------------------------------------------
# domain engine: one-hot group-by over a small static key domain
# ---------------------------------------------------------------------------

def group_by_onehot(batch: ColumnBatch, key_name: str,
                    aggs: Sequence[AggSpec], domain: int, row_valid=None,
                    float_mode: str = "f32x3", engine: str = "kernel"):
    """Hash-aggregate over one integer key with a static domain
    ``[0, domain)`` through the one-hot group-by kernel.

    sum/count/mean only.  Returns ``(result, num_groups, overflow)``;
    ``overflow`` is a device bool, True when a non-null live key falls
    outside the domain (the result is then invalid and callers fall
    back).  Float sums use the f32x3 Dekker split (the kernel has no f64
    contraction): within rel 1e-5 of an f64 sum, order-nondeterministic
    like Spark's own float sums.
    """
    parts, overflow = _domain_partials(batch, key_name, aggs, domain,
                                       row_valid, engine, float_mode)
    res, ng = _finalize_domain(batch, key_name, int(domain), aggs, parts)
    return res, ng, overflow


def _domain_partials(batch, key_name, aggs, domain, row_valid=None,
                     engine="auto", float_mode="f32x3"):
    """Additive per-bucket partials over buckets ``[0, K]`` (bucket K =
    null keys): ``star`` count(*) rows, ``cnt`` non-null counts, ``isum``
    int sums and ``fsum`` float sums per referenced column."""
    _check_aggs(batch, aggs)
    if engine == "auto":
        engine = "kernel"
    if engine != "kernel":
        raise ValueError(f"unknown domain engine {engine!r} "
                         "(use 'auto' or 'kernel')")
    return _domain_partials_onehot(batch, key_name, aggs, domain, row_valid,
                                   float_mode)


def _domain_bucket_overflow(col: Column, live: torch.Tensor, K: int):
    """Bucket id per row (null/dead keys -> K) and the out-of-domain flag,
    checked at int64 width."""
    k = col.data.to(torch.int64)
    overflow = (live & ((k < 0) | (k >= K))).any()
    bucket = torch.where(live, k.clamp(0, K - 1), torch.full_like(k, K))
    return bucket.to(torch.int32), overflow


def _domain_partials_onehot(batch, key_name, aggs, domain, row_valid,
                            float_mode):
    """The partials in one launch of the one-hot group-by kernel over the
    raw columns (:func:`..ops.kernels.onehot_groupby_columns`)."""
    from ..ops.kernels import onehot_groupby_columns

    col = batch[key_name]
    if col.dtype.kind not in (T.Kind.INT32, T.Kind.INT64):
        raise TypeError("group_by_onehot needs an integer key column")
    names, int_cols, float_cols = [], [], []
    for spec in aggs:
        if spec.column is None:
            continue
        c = spec.column
        if c not in names:
            names.append(c)
        if spec.op in ("sum", "mean"):
            target = (float_cols if batch[c].dtype.kind in T.FLOAT_KINDS
                      else int_cols)
            if c not in target:
                target.append(c)
    if float_cols and float_mode != "f32x3":
        raise ValueError(
            "the one-hot group-by kernel computes float sums with the "
            "f32x3 Dekker split only; pass float_mode='f32x3'")
    ints, floats, overflow = onehot_groupby_columns(
        col.data, col.validity,
        None if row_valid is None else row_valid.to(torch.bool),
        [(batch[c].data, batch[c].validity) for c in names],
        [names.index(c) for c in int_cols],
        [names.index(c) for c in float_cols], int(domain))
    nc = len(names)
    parts = {"star": ints[:, 0],
             "cnt": {c: ints[:, 1 + j] for j, c in enumerate(names)},
             "isum": {c: ints[:, 1 + nc + j]
                      for j, c in enumerate(int_cols)},
             "fsum": {c: floats[:, 3 * j] + floats[:, 3 * j + 1]
                      + floats[:, 3 * j + 2]
                      for j, c in enumerate(float_cols)}}
    return parts, overflow


def _finalize_domain(batch, key_name, K, aggs, parts):
    """Turn :func:`_domain_partials` into the group-by result."""
    return _assemble_domain_result(batch, key_name, K, aggs, parts["star"],
                                   parts["cnt"], parts["isum"],
                                   parts["fsum"])


def _assemble_domain_result(batch, key_name, K, aggs, counts_star, cnt_of,
                            isum_of, fsum_of):
    """Per-bucket reductions -> result batch with live groups compacted
    to the front in key order (null-key bucket K last among live)."""
    col = batch[key_name]
    dev = counts_star.device
    out_cols = {}
    key_valid = _arange(K + 1, dev) < K
    out_cols[key_name] = Column(
        torch.arange(K + 1, dtype=col.dtype.torch_dtype, device=dev),
        key_valid & (counts_star > 0), col.dtype)
    for spec in aggs:
        if spec.op == "count":
            cnt = counts_star if spec.column is None else cnt_of[spec.column]
            out_cols[spec.out_name] = Column(cnt, cnt >= 0, T.INT64)
            continue
        cnt_v = cnt_of[spec.column]
        den = cnt_v.clamp(min=1).to(torch.float64)
        if spec.column in fsum_of:
            fsum = fsum_of[spec.column]
            res = fsum / den if spec.op == "mean" else fsum
            out_cols[spec.out_name] = Column(res, cnt_v > 0, T.FLOAT64)
        elif spec.op == "mean":
            out_cols[spec.out_name] = Column(
                isum_of[spec.column].to(torch.float64) / den, cnt_v > 0,
                T.FLOAT64)
        else:
            out_cols[spec.out_name] = Column(isum_of[spec.column],
                                             cnt_v > 0, T.INT64)

    live_group = counts_star > 0
    order = torch.sort((~live_group).to(torch.int32), stable=True).indices
    compacted = ColumnBatch({name: gather_column(c, order)
                             for name, c in out_cols.items()})
    return compacted, live_group.sum()


def _pad_rows(col: Column, pad_to: int) -> Column:
    """Pad a result column with null rows up to ``pad_to`` rows."""
    extra = pad_to - col.num_rows
    if extra <= 0:
        return col
    return Column(_fit_rows(col.data, pad_to), _fit_rows(col.validity,
                                                         pad_to), col.dtype)


def group_by_domain_or_sort(batch: ColumnBatch, key_name: str,
                            aggs: Sequence[AggSpec], domain: int,
                            row_valid=None, engine: str = "auto",
                            float_mode: str = "f32x3"):
    """The domain engine when every live key fits ``[0, domain)``, the
    general :func:`group_by` otherwise (one host read of the bounds
    check picks).  Output rows are padded to ``max(num_rows, domain + 1)``;
    group order differs by branch (domain: key order, null group last;
    general: key order, nulls first) — Spark defines none.  Returns
    ``(result, num_groups)``."""
    n = batch.num_rows
    K = int(domain)
    pad_to = max(n, K + 1)
    col = batch[key_name]
    if not isinstance(col, Column):
        raise not_ported(f"domain group-by over {type(col).__name__}", 12)
    row_live = (torch.ones((n,), dtype=torch.bool, device=col.data.device)
                if row_valid is None else row_valid.to(torch.bool))
    _, overflow = _domain_bucket_overflow(col, col.validity & row_live, K)
    if bool(overflow.item()):
        res, ng = group_by(batch, [key_name], list(aggs),
                           row_valid=row_valid)
    else:
        parts, _ = _domain_partials(batch, key_name, aggs, domain,
                                    row_valid, engine, float_mode)
        res, ng = _finalize_domain(batch, key_name, K, list(aggs), parts)
    return (ColumnBatch({name: _pad_rows(c, pad_to)
                         for name, c in zip(res.names, res.columns)}), ng)
