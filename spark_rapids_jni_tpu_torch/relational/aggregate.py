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
  2^64, Spark's non-ANSI wraparound, the reference's byte-limb bits),
  the float sums (three exact Dekker f32 limbs) and the decimal sums
  (four u32 lanes and a negative count, rebuilt exactly) per bucket.
* :func:`group_by_domain_or_sort`, the domain engine when every live key
  fits the domain and the general engine otherwise.

Spark semantics (as in the reference): null keys form their own group;
sum, min and max ignore nulls and an all-null group gives null;
count(col) counts non-nulls, count(*) rows; sum(int) is int64 wrapping
mod 2^64, sum(float) and avg are float64; min skips NaN unless a group
holds nothing else, max takes it (one NaN, greatest).  A decimal(p, s)
sum is exact (256-bit, from u32 lanes summed per segment) and has type
decimal(min(38, p + 10), s), null where it reaches 10^precision; its
avg is Spark's bounded decimal(p + 4, s + 4), HALF_UP; min/max compare
signed 128-bit values.  Keys may be any mix of plain, string and decimal
columns: the general engines key on their radix words (a string key: a
null flag, its char words and its length word).  A dictionary key column
keys on its one canon word (within one batch every dictionary column's
``canon[codes]`` orders and equates as its full words) and its output
keys stay encoded; other encoded keys lower to their value words.
Encoded aggregate VALUE columns materialize where they are summed, and
the domain engine materializes its inputs (its point of need).
Output batches are padded to the input row count with a ``num_groups``
count; groups are in key order, nulls first (the domain engine: key
order, null group last).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import config
from .._u32 import M32
from ..columnar import types as T
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)
from ..columnar.encoded import (DictionaryColumn, canon_key_column,
                                is_encoded, materialize_column)
from ..ops import decimal as D
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
    if dtype.kind is T.Kind.BOOLEAN or dtype.kind in T.INT_KINDS:
        return T.INT64
    if dtype.kind in T.FLOAT_KINDS:
        return T.FLOAT64
    if dtype.kind is T.Kind.DECIMAL:
        return T.SparkType.decimal(min(38, dtype.precision + 10),
                                   dtype.scale)
    raise NotImplementedError(f"sum of {dtype!r}")


def _check_aggs(batch: ColumnBatch, aggs: Sequence[AggSpec]) -> None:
    for spec in aggs:
        if spec.column is not None:
            col = batch[spec.column]
            if (isinstance(col, StringColumn) or col.dtype.is_nested
                    or col.dtype.kind is T.Kind.STRING):
                raise NotImplementedError(
                    f"{spec.op} over {col.dtype!r} groups (the reference "
                    "has none either)")
            if not isinstance(col, (Column, Decimal128Column)) \
                    and not is_encoded(col):
                raise TypeError(f"aggregation over {type(col).__name__}")
            if spec.op in ("sum", "mean"):
                _sum_dtype(col.dtype)


def _canon_keys(key_cols) -> list:
    """Each dictionary key column's one canon word in place of its full
    words (one batch, so one dictionary a column); the output keys
    still gather from the encoded columns."""
    return [canon_key_column(c) if isinstance(c, DictionaryColumn) else c
            for c in key_cols]


def _materialize(batch: ColumnBatch, names) -> ColumnBatch:
    """``batch`` with its encoded columns among ``names`` decoded: the
    columns an engine computes on, at their point of need (the general
    engines' key columns stay encoded to the output gather)."""
    names = {c for c in names if c is not None and is_encoded(batch[c])}
    if not names:
        return batch
    return ColumnBatch({n: materialize_column(col) if n in names else col
                        for n, col in zip(batch.names, batch.columns)})


def _average_decimal_type(p: int, s: int):
    """Spark ``Average`` over decimal(p, s): ``DecimalType.bounded(p + 4,
    s + 4)``, a plain clamp of both to 38."""
    return min(p + 4, 38), min(s + 4, 38)


def decimal_lanes_to_limbs(lanes: torch.Tensor, negatives: torch.Tensor
                           ) -> torch.Tensor:
    """The one-hot kernel's decimal partials -> the 256-bit sum: four u64
    lane sums of the values' u32 limbs (``[G, 4]``, each below 2^63) and
    the count of negative values ``[G]`` give ``sum_j lane_j 2^(32 j) -
    2^128 negatives`` as ``[8, G]`` u32 limbs (:mod:`..ops.decimal`'s
    layout), exactly."""
    g = lanes.shape[0]
    s = torch.zeros((8, g), dtype=torch.int64, device=lanes.device)
    s[:4] = lanes.t()
    sub = torch.zeros_like(s)
    sub[4] = negatives
    return D._sub_u(D._carry(s), sub)


def _decimal_sum_result(s256, has_any, dtype: T.SparkType):
    """A 256-bit group sum as Spark's decimal sum: null where it reaches
    10^precision of the sum type."""
    out_t = _sum_dtype(dtype)
    over = ~D._lt_u(D._abs(s256)[0], D._const(10 ** out_t.precision, s256))
    return Decimal128Column(D._to_i128(s256), has_any & ~over, out_t)


def _decimal_avg(s256, cnt, has_any, dtype: T.SparkType):
    """Group average from exact 256-bit sums: rescale to the result
    scale, divide by the count (below 2^32) with HALF_UP; null where it
    reaches 10^precision."""
    p_res, s_res = _average_decimal_type(dtype.precision, dtype.scale)
    d = s_res - dtype.scale
    scaled = D._mul_const(s256, 10 ** d) if d else s256
    mag, neg = D._abs(scaled)
    den = cnt.clamp(min=1).to(torch.int64)
    q, rem = D._divmod_small(mag, den)
    q = D._add_small(q, (rem * 2 >= den).to(torch.int64))
    ok = D._lt_u(q, D._const(10 ** p_res, q))
    signed = torch.where(neg, D._neg(q), q)
    return Decimal128Column(D._to_i128(signed), has_any & ok,
                            T.SparkType.decimal(p_res, s_res))


def _decimal_minmax(limbs, valid, seg, num_segments, op, per_group):
    """Signed 128-bit min or max per segment in two passes: the extreme
    high limb (signed), then the extreme low limb (unsigned, compared
    with its sign bit flipped) among the rows holding it."""
    sign = -(1 << 63)
    if op == "min":
        fill_hi, fill_lo, red = (1 << 63) - 1, (1 << 63) - 1, "amin"
    else:
        fill_hi, fill_lo, red = sign, sign, "amax"
    hi = torch.where(valid, limbs[:, 1], torch.full_like(limbs[:, 1],
                                                         fill_hi))
    lo = torch.where(valid, limbs[:, 0] ^ sign,
                     torch.full_like(limbs[:, 0], fill_lo))
    m_hi = torch.full((num_segments,), fill_hi, dtype=torch.int64,
                      device=limbs.device).scatter_reduce_(0, seg, hi, red)
    at_best = valid & (hi == m_hi[seg])
    m_lo = torch.full((num_segments,), fill_lo, dtype=torch.int64,
                      device=limbs.device).scatter_reduce_(
        0, seg, torch.where(at_best, lo, torch.full_like(lo, fill_lo)), red)
    return torch.stack([per_group(m_lo) ^ sign, per_group(m_hi)], dim=1)


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
        acc = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        return per_group(acc.index_add_(0, seg, vals))

    lanes_of, groups = {}, []

    def decimal_sum(name, valid):
        """A decimal column's exact 256-bit sums over the live groups, as
        the one-hot kernel forms them: its four u32 lanes (an int32 view
        of the limbs) summed in int64 (n < 2^31 rows of < 2^32 each) and
        its negative values counted, once per column.  The 256-bit work
        runs on the live groups only, not on the padded output rows: one
        host read of their count."""
        if not groups:
            groups.append(int(out_valid.sum().item()))
        g = groups[0]
        if name not in lanes_of:
            limbs = torch.where(valid[:, None], batch[name].limbs, 0)
            lanes = limbs.view(torch.int32).to(torch.int64) & M32
            lanes_of[name] = decimal_lanes_to_limbs(
                seg_sum(lanes)[:g],
                seg_sum((limbs[:, 1] < 0).to(torch.int64))[:g])
        return lanes_of[name], g

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
        if isinstance(col, Decimal128Column):
            has_any = out_valid & (nn > 0)
            if spec.op in ("min", "max"):
                out[spec.out_name] = Decimal128Column(
                    _decimal_minmax(col.limbs, valid, seg, num_segments,
                                    spec.op, per_group), has_any,
                    col.dtype)
                continue
            s256, g = decimal_sum(spec.column, valid)
            res = (_decimal_avg(s256, nn[:g], has_any[:g], col.dtype)
                   if spec.op == "mean"
                   else _decimal_sum_result(s256, has_any[:g], col.dtype))
            out[spec.out_name] = _pad_rows(res, out_valid.shape[0])
            continue
        if spec.op in ("min", "max"):
            out[spec.out_name] = Column(
                _segment_minmax(col.data, valid, seg, num_segments,
                                spec.op, per_group, seg_sum),
                out_valid & (nn > 0), col.dtype)
            continue
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


def _segment_minmax(data, valid, seg, num_segments, op, per_group,
                    seg_sum):
    """Per-segment min or max of the valid rows with Spark's float rules:
    NaNs are set aside, then max is NaN where a group holds one and min
    only where it holds nothing else; bools as 0/1."""
    was_bool = data.dtype == torch.bool
    if was_bool:
        data = data.to(torch.int64)
    is_float = data.is_floating_point()
    valid_num = valid & ~torch.isnan(data) if is_float else valid
    if is_float:
        fill = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.max if op == "min" else info.min
    masked = torch.where(valid_num, data, torch.full_like(data, fill))
    acc = torch.full((num_segments,), fill, dtype=data.dtype,
                     device=data.device)
    r = per_group(acc.scatter_reduce_(0, seg, masked,
                                      reduce="amin" if op == "min"
                                      else "amax"))
    if is_float:
        seg_nan = seg_sum((valid & torch.isnan(data)).to(torch.int64)) > 0
        seg_num = seg_sum(valid_num.to(torch.int64)) > 0
        nan = torch.full_like(r, float("nan"))
        r = torch.where(seg_nan if op == "max" else seg_nan & ~seg_num,
                        nan, r)
    return r.to(torch.bool) if was_bool else r


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
    dev = batch[key_names[0]].device
    batch = _materialize(batch, [spec.column for spec in aggs])
    karr = K.batch_radix_keys(_canon_keys([batch[k] for k in key_names]),
                              equality=True, nulls_first=True)
    have_rv = row_valid is not None
    if have_rv:
        occ = row_valid.to(torch.bool)
        karr = [(~occ).to(torch.int64)] + [
            torch.where(occ, k, torch.zeros_like(k)) for k in karr]
    sperm = _arange(n, dev) if assume_grouped else K.lexsort_u32(karr)
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
    dev = batch[key_names[0]].device
    batch = _materialize(batch, [spec.column for spec in aggs])
    karr = K.batch_radix_keys(_canon_keys([batch[k] for k in key_names]),
                              equality=True, nulls_first=True)
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
    rank2slot = K.lexsort_u32(ops)
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

    sum/count/mean only (decimal sums exact, through the kernel's decimal
    lanes).  Returns ``(result, num_groups, overflow)``;
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
    int sums, ``fsum`` float sums and ``d64`` decimal sums (the 256-bit
    two's-complement sum as ``[K + 1, 8]`` u32 limbs in int64, the
    reference's layout, so lanes added across shards re-fold without
    carrying out) per referenced
    column.  min/max are no additive partials: they stay on the general
    engines."""
    _check_aggs(batch, aggs)
    if any(spec.op in ("min", "max") for spec in aggs):
        raise ValueError("the domain engine computes sum/count/mean only; "
                         "min/max run on the general group_by")
    # the domain engine works on raw buffers: the key and the summed
    # columns materialize here, their late point of need
    batch = _materialize(batch, [key_name] + [s.column for s in aggs])
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


def _kernel_sum_dtype(data: torch.Tensor) -> torch.Tensor:
    """A column as the one-hot kernel sums it: int8/int16 widened to
    int32, float32 to float64 (exact; the sums are the same)."""
    if data.dtype in (torch.int8, torch.int16):
        return data.to(torch.int32)
    if data.dtype == torch.float32:
        return data.to(torch.float64)
    return data


def _column_buffer(col) -> torch.Tensor:
    return col.limbs if isinstance(col, Decimal128Column) else \
        _kernel_sum_dtype(col.data)


def _domain_partials_onehot(batch, key_name, aggs, domain, row_valid,
                            float_mode):
    """The partials in one launch of the one-hot group-by kernel over the
    raw columns (:func:`..ops.kernels.onehot_groupby_columns`)."""
    from ..ops.kernels import onehot_groupby_columns

    col = batch[key_name]
    if col.dtype.kind not in (T.Kind.INT32, T.Kind.INT64):
        raise TypeError("group_by_onehot needs an integer key column")
    names, int_cols, float_cols, dec_cols = [], [], [], []
    for spec in aggs:
        if spec.column is None:
            continue
        c = spec.column
        if c not in names:
            names.append(c)
        if spec.op in ("sum", "mean"):
            if isinstance(batch[c], Decimal128Column):
                target = dec_cols
            elif batch[c].dtype.kind in T.FLOAT_KINDS:
                target = float_cols
            else:
                target = int_cols
            if c not in target:
                target.append(c)
    if float_cols and float_mode != "f32x3":
        raise ValueError(
            "the one-hot group-by kernel computes float sums with the "
            "f32x3 Dekker split only; pass float_mode='f32x3'")
    ints, floats, overflow = onehot_groupby_columns(
        col.data, col.validity,
        None if row_valid is None else row_valid.to(torch.bool),
        [(_column_buffer(batch[c]), batch[c].validity) for c in names],
        [names.index(c) for c in int_cols],
        [names.index(c) for c in float_cols], int(domain),
        [names.index(c) for c in dec_cols])
    nc, ni = len(names), len(int_cols)
    d0 = 1 + nc + ni
    parts = {"star": ints[:, 0],
             "cnt": {c: ints[:, 1 + j] for j, c in enumerate(names)},
             "isum": {c: ints[:, 1 + nc + j]
                      for j, c in enumerate(int_cols)},
             "fsum": {c: floats[:, 3 * j] + floats[:, 3 * j + 1]
                      + floats[:, 3 * j + 2]
                      for j, c in enumerate(float_cols)},
             "d64": {c: decimal_lanes_to_limbs(
                 ints[:, d0 + 5 * j:d0 + 5 * j + 4],
                 ints[:, d0 + 5 * j + 4]).t()
                 for j, c in enumerate(dec_cols)}}
    return parts, overflow


def _finalize_domain(batch, key_name, K, aggs, parts):
    """Turn :func:`_domain_partials` into the group-by result; decimal
    limbs re-fold their carries first (partials added across shards)."""
    return _assemble_domain_result(
        batch, key_name, K, aggs, parts["star"], parts["cnt"],
        parts["isum"], parts["fsum"],
        {c: D._carry(d64.t()) for c, d64 in parts["d64"].items()})


def _assemble_domain_result(batch, key_name, K, aggs, counts_star, cnt_of,
                            isum_of, fsum_of, dsum_of):
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
        if spec.column in dsum_of:
            dtype = batch[spec.column].dtype
            s256 = dsum_of[spec.column]
            out_cols[spec.out_name] = (
                _decimal_avg(s256, cnt_v, cnt_v > 0, dtype)
                if spec.op == "mean"
                else _decimal_sum_result(s256, cnt_v > 0, dtype))
        elif spec.column in fsum_of:
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


def _pad_rows(col, pad_to: int):
    """Pad a result column with null rows up to ``pad_to`` rows."""
    if pad_to <= col.num_rows:
        return col
    if isinstance(col, Decimal128Column):
        return Decimal128Column(_fit_rows(col.limbs, pad_to),
                                _fit_rows(col.validity, pad_to), col.dtype)
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
    col = materialize_column(batch[key_name])
    if not isinstance(col, Column):
        raise TypeError(f"the domain engine needs an integer key column, "
                        f"not {type(col).__name__}")
    row_live = (torch.ones((n,), dtype=torch.bool, device=col.device)
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
