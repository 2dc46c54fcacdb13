"""Window functions over sorted partitions (the TPC-DS q67 shape).

Counterpart of ``spark_rapids_jni_tpu/relational/window.py``: one stable
sort by (partition keys, order keys), then every window primitive is a
segmented scan or boundary arithmetic over the sorted rows:

* row_number, rank and dense_rank from the partition and peer starts
  (a cumsum of the boundaries and one scatter of their positions);
* running count and integer sums as ``cumsum`` minus the partition
  start's offset (exact mod 2^64, as the reference's scan);
* running float sums and min/max as a log-step segmented scan (each
  step combines a row with the one ``2^k`` before it inside its
  partition);
* lag/lead as gathers masked at the partition edges.

Results come back in the sorted row order with ``sorted_row``, the
permutation, as the reference returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .._u32 import M32
from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from . import keys as K
from .gather import gather_batch, gather_column

_WINDOW_OPS = ("row_number", "rank", "dense_rank", "sum", "min", "max",
               "count", "avg", "lag", "lead")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    op: str                    # row_number | rank | dense_rank | sum | ...
    column: Optional[str]      # None for row_number/rank/dense_rank/count(*)
    out_name: str
    offset: int = 1            # lag/lead only

    def __post_init__(self):
        if self.op not in _WINDOW_OPS:
            raise ValueError(f"unknown window op {self.op!r}")
        if self.column is None and self.op in ("sum", "min", "max", "avg",
                                               "lag", "lead"):
            raise ValueError(f"{self.op} needs a value column")
        if self.op in ("lag", "lead") and self.offset < 0:
            raise ValueError("lag/lead offset must be >= 0")


def _segments(boundary: torch.Tensor, iota: torch.Tensor):
    """``(seg, first)``: each row's segment number and each segment's
    first row (``first[:num_segments]``), ``boundary[0]`` being True.
    One cumsum and one collision-free scatter: boundary rows write their
    position at their segment's slot, the others at a slot of their own
    past ``n`` (``torch.cummax`` of the positions took 49 ms at 2^24 rows
    on an H100, 700 W)."""
    n = iota.shape[0]
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    dst = torch.where(boundary, seg, iota + n)
    first = torch.empty((2 * n,), dtype=torch.int64, device=iota.device)
    return seg, first.scatter_(0, dst, iota)


def _starts(boundary: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """Per row, the position of the last boundary at or before it."""
    seg, first = _segments(boundary, iota)
    return first[seg]


def _seg_cumsum(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum restarting at each segment start."""
    cs = torch.cumsum(x, 0)
    return cs - cs[start] + x[start]


def _seg_scan(vals: torch.Tensor, start: torch.Tensor, iota, op):
    """Inclusive segmented scan of an associative, commutative ``op`` in
    log2(n) steps: after step k a row holds ``op`` over the ``2^k`` rows
    ending at it, clipped at its segment's start."""
    out = vals
    n = vals.shape[0]
    d = 1
    while d < n:
        prev = torch.cat([out[:d], out[:-d]])
        out = torch.where(iota - d >= start, op(out, prev), out)
        d <<= 1
    return out


def _fill(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def window(batch: ColumnBatch, partition_by: Sequence[str],
           order_by: Sequence[str], specs: Sequence[WindowSpec],
           descending: Sequence[bool] = ()) -> ColumnBatch:
    """Evaluate window functions; the running frame is UNBOUNDED
    PRECEDING..CURRENT ROW (Spark's default with ORDER BY).

    Returns the input columns in sorted order, ``sorted_row`` (the
    permutation, int32) and one column per spec.  Order keys sort
    ascending with nulls first, or (``descending``) descending with nulls
    last, Spark's defaults.
    """
    n = batch.num_rows
    desc = list(descending) if descending else [False] * len(order_by)
    if len(desc) != len(order_by):
        raise ValueError(
            f"descending has {len(desc)} entries for {len(order_by)} "
            "order-by columns")
    karr = K.batch_radix_keys([batch[k] for k in partition_by],
                              equality=True, nulls_first=True)
    np_part = len(karr)
    for name, d in zip(order_by, desc):
        col = batch[name]
        # only the data words invert for descending: the flag already
        # places the nulls
        karr.append(K.null_flag(col, nulls_first=not d))
        karr.extend((w ^ M32) if d else w for w in (
            torch.where(col.validity, w, torch.zeros_like(w))
            for w in K.column_radix_keys(col, equality=False)))

    dev = batch.columns[0].device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    perm = K.lexsort_u32(karr) if karr else iota
    skeys = [k[perm] for k in karr]
    sorted_batch = gather_batch(batch, perm)

    first = iota == 0
    part_boundary = (~K.rows_equal_adjacent(skeys[:np_part]) if np_part
                     else first)
    full_boundary = (~K.rows_equal_adjacent(skeys) if skeys else first)
    ps = _starts(part_boundary, iota)
    rn = iota - ps + 1
    order_change = full_boundary & ~part_boundary
    dr = _seg_cumsum(order_change.to(torch.int64), ps) + 1
    rank = rn[_starts(part_boundary | order_change, iota)]

    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    out = dict(zip(sorted_batch.names, sorted_batch.columns))
    out["sorted_row"] = Column(perm.to(torch.int32), ones, T.INT32)
    ranks = {"row_number": rn, "rank": rank, "dense_rank": dr}
    for spec in specs:
        if spec.op in ranks:
            out[spec.out_name] = Column(ranks[spec.op], ones, T.INT64)
            continue
        if spec.op == "count" and spec.column is None:
            out[spec.out_name] = Column(rn, ones, T.INT64)
            continue
        col = sorted_batch[spec.column]
        if spec.op in ("lag", "lead"):
            k = spec.offset
            if spec.op == "lag":
                src = iota - k
                ok = src >= ps
            else:
                # a partition ends one row before the next one starts
                seg, first = _segments(part_boundary, iota)
                nxt = (seg + 1).clamp(max=n - 1)
                pe = torch.where(seg < seg[-1:], first[nxt] - 1,
                                 torch.full_like(iota, n - 1))
                src = iota + k
                ok = src <= pe
            out[spec.out_name] = gather_column(col, src.clamp(0, n - 1), ok)
            continue
        valid = col.validity
        nn = _seg_cumsum(valid.to(torch.int64), ps)
        if spec.op == "count":
            out[spec.out_name] = Column(nn, ones, T.INT64)
            continue
        data = col.data
        if spec.op in ("sum", "avg"):
            from .aggregate import _sum_dtype

            out_t = T.FLOAT64 if spec.op == "avg" else _sum_dtype(col.dtype)
            acc = data.to(out_t.torch_dtype)
            acc = torch.where(valid, acc, torch.zeros_like(acc))
            if acc.is_floating_point():
                s = _seg_scan(acc, ps, iota, torch.add)
            else:
                s = _seg_cumsum(acc, ps)  # exact mod 2^64
            if spec.op == "avg":
                s = s / nn.clamp(min=1).to(torch.float64)
            out[spec.out_name] = Column(s, nn > 0, out_t)
            continue
        # min / max: nulls take the op's identity; NaN propagates as
        # jnp.minimum / jnp.maximum do in the reference's scan
        was_bool = data.dtype == torch.bool
        if was_bool:
            data = data.to(torch.int64)
        masked = torch.where(valid, data, torch.full_like(
            data, _fill(data.dtype, spec.op)))
        f = torch.minimum if spec.op == "min" else torch.maximum
        r = _seg_scan(masked, ps, iota, f)
        if was_bool:
            r = r.to(torch.bool)
        out[spec.out_name] = Column(r, nn > 0, col.dtype)
    return ColumnBatch(out)
