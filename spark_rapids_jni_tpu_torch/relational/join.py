"""Inner equality joins with static-shape outputs.

Counterpart of ``spark_rapids_jni_tpu/relational/join.py`` for the q95
path:

* :func:`hash_join` with ``how="inner"`` on the hash engine: the build
  side's radix words go into a slot table (slot-table build kernel),
  build rows are grouped by slot with one stable sort, the table's slot
  records are built once (slot-record kernel), and each probe row walks
  its chain over them (slot-table probe kernel); matches expand through the
  offsets/searchsorted expansion, padded to a static ``capacity``.
  Matches enumerate in original right-row order, bit-identical to the
  reference's engines.
* :func:`build_table`: a resident prebuilt build table for
  ``hash_join(prebuilt=)`` (the plan compiler's broadcast joins).
* :func:`join_dense_or_hash`: when the build side's keys are unique ints
  in ``[0, domain)`` (dense surrogate keys, every TPC-DS dimension) the
  join is a rowid table plus gathers; otherwise the general
  :func:`hash_join`.  One host read of the density check picks.

Spark semantics: a null key matches nothing; dead (padding) rows of
either side never match.  Other join kinds (left, right, full, semi,
anti) and the sort engine are ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import config
from .._roadmap import not_ported
from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from . import keys as K
from .gather import gather_batch

_HOWS = ("inner", "left", "right", "full", "semi", "anti")


def _resolve_join_engine(engine):
    """``None`` reads the ``join_engine`` knob; ``auto`` is the kernel
    tier on every device."""
    if engine is None:
        engine = config.get("join_engine")
    if engine == "auto":
        return "kernel"
    if engine == "sort":
        raise not_ported("the sort join engine", 10)
    if engine != "kernel":
        raise ValueError(f"unknown join engine {engine!r} "
                         "(use 'auto' or 'kernel')")
    return engine


def _hash_build(rkeys, nr: int):
    """Hash-engine build product over the build side's radix words: the
    tuple ``(owner, rslot, rperm, counts_slot, off_slot, records)`` that
    :func:`hash_join` takes as ``prebuilt``.

    S is 2x the build rows rounded up to a power of two (load <= 1/2, so
    insertion always terminates); ``rperm`` groups build rows by slot in
    original order within a slot (one stable sort), which is the order
    the reference's sort engine yields within a key group; ``records``
    are the table's slot records and chain bound (one launch), which
    every probe of the table walks.
    """
    from . import hashtable as H

    dev = rkeys[0].device
    S = H.next_pow2(2 * nr)
    owner, rslot, _ = H.build_slot_table(
        rkeys, torch.ones((nr,), dtype=torch.bool, device=dev), S)
    rslot64 = rslot.to(torch.int64)
    counts_slot = torch.zeros((S + 1,), dtype=torch.int64, device=dev)
    counts_slot.index_add_(0, rslot64, torch.ones_like(rslot64))
    off_slot = torch.cumsum(counts_slot, 0) - counts_slot
    rperm = torch.sort(rslot64, stable=True).indices
    records = H.slot_records(owner, rkeys)
    return owner, rslot, rperm, counts_slot, off_slot, records


def _one_null_row_like(batch: ColumnBatch) -> ColumnBatch:
    """A 1-row all-null batch with the same schema (empty-side pad)."""
    out = {}
    for name, col in zip(batch.names, batch.columns):
        dev = col.data.device
        out[name] = Column(torch.zeros((1,), dtype=col.data.dtype,
                                       device=dev),
                           torch.zeros((1,), dtype=torch.bool, device=dev),
                           col.dtype)
    return ColumnBatch(out)


def _require_plain(cols: Sequence, what: str) -> None:
    for c in cols:
        if not isinstance(c, Column):
            raise not_ported(f"{what} over {type(c).__name__}", 10)


def hash_join(left: ColumnBatch, right: ColumnBatch,
              left_on: Sequence[str], right_on: Sequence[str],
              how: str = "inner", capacity: Optional[int] = None,
              suffixes: tuple = ("", "_r"), left_valid=None,
              right_valid=None, prebuilt=None, engine=None) -> tuple:
    """Inner equality join; returns ``(result_batch, count)``.

    ``capacity`` is the static output row budget (default
    ``left.num_rows``, exact for a key-unique build side); ``count`` is
    the true match total, and ``count > capacity`` signals truncation.
    ``left_valid`` / ``right_valid`` mark live rows.  The output keeps
    the left columns, then the right side's non-key columns.

    ``prebuilt`` skips the build: a :class:`BuildTable` from
    :func:`build_table`, or its raw product (:func:`_hash_build`'s
    tuple).  It must have been built from the same ``right`` /
    ``right_on`` / ``right_valid``; nothing re-validates that.
    """
    if how not in _HOWS:
        raise ValueError(f"unknown join type {how!r}")
    if how != "inner":
        raise not_ported(f"how={how!r} joins", 10)
    if len(left_on) != len(right_on):
        raise ValueError("left_on/right_on length mismatch")
    if isinstance(prebuilt, BuildTable):
        return hash_join(left, right, left_on, right_on, how,
                         capacity=capacity, suffixes=suffixes,
                         left_valid=left_valid, right_valid=right_valid,
                         prebuilt=prebuilt.get(), engine=prebuilt.engine)
    _resolve_join_engine(engine)
    nl, nr = left.num_rows, right.num_rows
    if nr == 0 and prebuilt is not None:
        raise ValueError("prebuilt build table for an empty build side")
    if nr == 0:
        # one unmatchable null row keeps every gather in bounds
        right = _one_null_row_like(right)
        nr = 1
    if nl == 0:
        left = _one_null_row_like(left)
        nl = 1
        left_valid = torch.zeros((1,), dtype=torch.bool,
                                 device=left[left_on[0]].data.device)
    lcols = [left[k] for k in left_on]
    rcols = [right[k] for k in right_on]
    _require_plain(lcols + rcols, "hash_join keys")
    if right_valid is not None:
        rcols = [Column(c.data, c.validity & right_valid, c.dtype)
                 for c in rcols]
    dev = lcols[0].data.device

    lkeys = K.batch_radix_keys(lcols, equality=True, nulls_first=False)
    l_null = torch.zeros((nl,), dtype=torch.bool, device=dev)
    for c in lcols:
        l_null = l_null | ~c.validity
    l_live = (torch.ones((nl,), dtype=torch.bool, device=dev)
              if left_valid is None else left_valid.to(torch.bool))

    from . import hashtable as H

    # null build keys sit in their own slot, which no valid probe's words
    # equal; null and dead probe rows are masked.  The walk is bounded by
    # the records' chain bound (result-identical to the full table), so
    # the probe reads nothing back to the host.
    if prebuilt is None:
        rkeys = K.batch_radix_keys(rcols, equality=True, nulls_first=False)
        prebuilt = _hash_build(rkeys, nr)
    _owner, _rslot, rperm, counts_slot, off_slot, records = prebuilt
    found, lslot = H.probe_slot_records(records, lkeys, ~l_null & l_live)
    lslot = lslot.to(torch.int64)
    counts = torch.where(found, counts_slot[lslot],
                         torch.zeros_like(lslot))
    lo = off_slot[lslot]

    cum = torch.cumsum(counts, 0)  # inclusive
    total = cum[-1]
    offsets = cum - counts
    cap = nl if capacity is None else int(capacity)
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    li = torch.searchsorted(cum, j, right=True).clamp(0, nl - 1)
    k = j - offsets[li]
    pos = (lo[li] + k).clamp(0, nr - 1)
    ri = rperm[pos]
    out_valid = j < total
    lpart = gather_batch(left, li, out_valid)
    right_names = [n for n in right.names if n not in right_on]
    rpart = gather_batch(right.select(right_names), ri, out_valid)
    return _merge_parts(lpart, rpart, suffixes), total


def join_dense_or_hash(left: ColumnBatch, right: ColumnBatch, left_on: str,
                       right_on: str, domain: int, how: str = "inner",
                       capacity: Optional[int] = None,
                       suffixes: tuple = ("", "_r"), left_valid=None,
                       right_valid=None) -> tuple:
    """Inner join for the dimension-table shape: a rowid table when the
    build keys are unique ints in ``[0, domain)``, else :func:`hash_join`.
    Same output contract either way: matches compacted in left-row order,
    ``(result, count)``."""
    lcol, rcol = left[left_on], right[right_on]
    ints = (T.Kind.INT32, T.Kind.INT64, T.Kind.DATE)
    eligible = (how == "inner" and domain > 0
                and isinstance(lcol, Column) and isinstance(rcol, Column)
                and lcol.dtype.kind in ints and rcol.dtype.kind in ints
                and right.num_rows > 0)
    if not eligible:
        return hash_join(left, right, [left_on], [right_on], how,
                         capacity=capacity, suffixes=suffixes,
                         left_valid=left_valid, right_valid=right_valid)

    nl, nr = left.num_rows, right.num_rows
    K1 = int(domain)
    cap = nl if capacity is None else int(capacity)
    dev = lcol.data.device
    rv = (torch.ones((nr,), dtype=torch.bool, device=dev)
          if right_valid is None else right_valid.to(torch.bool))
    lv = (torch.ones((nl,), dtype=torch.bool, device=dev)
          if left_valid is None else left_valid.to(torch.bool))
    r_live = rcol.validity & rv
    rk = rcol.data.to(torch.int64)
    in_dom = r_live & (rk >= 0) & (rk < K1)
    slot = torch.where(in_dom, rk, torch.full_like(rk, K1))  # K1 = discard
    cnt = torch.zeros((K1 + 1,), dtype=torch.int64, device=dev)
    cnt.index_add_(0, slot, torch.ones_like(slot))
    # keys wider than 32 bits must survive the reference's int32 cast on
    # both sides, else a key >= 2^32 could wrap into the domain
    lk = lcol.data.to(torch.int64)
    no_wrap = (((rk.to(torch.int32).to(torch.int64) == rk) | ~r_live).all()
               & ((lk.to(torch.int32).to(torch.int64) == lk)
                  | ~(lcol.validity & lv)).all())
    dense_ok = (in_dom | ~r_live).all() & (cnt[:K1] <= 1).all() & no_wrap
    if not bool(dense_ok.item()):
        return hash_join(left, right, [left_on], [right_on], "inner",
                         capacity=cap, suffixes=suffixes,
                         left_valid=left_valid, right_valid=right_valid)

    from ..parallel.partition import regroup_order

    rowid = torch.zeros((K1 + 1,), dtype=torch.int64, device=dev)
    rowid[slot] = torch.arange(nr, dtype=torch.int64, device=dev)
    present = cnt[:K1] > 0
    lk_ok = lcol.validity & lv & (lk >= 0) & (lk < K1)
    lk_safe = torch.where(lk_ok, lk, torch.zeros_like(lk))
    match = lk_ok & present[lk_safe]
    total = match.sum()
    order = regroup_order((~match).to(torch.int32), 2)  # matches first
    li = order[:cap] if cap <= nl else torch.cat(
        [order, torch.zeros((cap - nl,), dtype=order.dtype, device=dev)])
    out_valid = torch.arange(cap, device=dev) < total
    ri = rowid[lk_safe[li].clamp(0, K1)]
    lpart = gather_batch(left, li, out_valid)
    right_names = [n for n in right.names if n != right_on]
    rpart = gather_batch(right.select(right_names), ri, out_valid)
    return _merge_parts(lpart, rpart, suffixes), total


def _merge_parts(lpart: ColumnBatch, rpart: ColumnBatch,
                 suffixes: tuple) -> ColumnBatch:
    """Suffix-disambiguating column merge shared by the join engines."""
    collisions = set(lpart.names) & set(rpart.names)
    merged = {}
    for part, suffix in ((lpart, suffixes[0]), (rpart, suffixes[1])):
        for name, col in zip(part.names, part.columns):
            out = name + suffix if name in collisions else name
            if out in merged:
                raise ValueError(f"join output name collision: {out!r} "
                                 f"(suffixes={suffixes!r})")
            merged[out] = col
    return ColumnBatch(merged)


# ---------------------------------------------------------------------------
# resident build tables (the broadcast join's prebuilt side)
# ---------------------------------------------------------------------------

class BuildTable:
    """A join build table over ``right[right_on]``, resident on the
    device until closed: the counterpart of the reference's
    ``SpillableBuildTable`` without spill (a spill-registered table that
    is dropped under pressure and rebuilt on read is ROADMAP.md queue 1,
    item 13).  ``engine`` is pinned at construction.

    ``source`` is the batch the table was built from;
    :meth:`for_batch` rebuilds it when handed a different batch, so a
    plan reused over new build-side data never probes a stale table.
    """

    def __init__(self, right: ColumnBatch, right_on: Sequence[str],
                 right_valid=None, name: Optional[str] = None,
                 engine=None):
        if right.num_rows == 0:
            raise ValueError("cannot pre-build an empty build side")
        self.name = name
        self.right_on = tuple(right_on)
        self.engine = _resolve_join_engine(engine)
        self._right_valid = right_valid
        self._tree = None
        self.for_batch(right)

    def for_batch(self, right: ColumnBatch) -> "BuildTable":
        """The table for ``right``: this one when it was built from
        ``right``, else rebuilt from it."""
        if self._tree is not None and right is self.source:
            return self
        if right.num_rows == 0:
            raise ValueError("cannot pre-build an empty build side")
        rcols = [right[k] for k in self.right_on]
        _require_plain(rcols, "build table keys")
        if self._right_valid is not None:
            rcols = [Column(c.data, c.validity & self._right_valid, c.dtype)
                     for c in rcols]
        rkeys = K.batch_radix_keys(rcols, equality=True, nulls_first=False)
        self._tree = _hash_build(rkeys, right.num_rows)
        self.source = right
        return self

    def get(self) -> tuple:
        if self._tree is None:
            raise RuntimeError(f"build table {self.name!r} is closed")
        return self._tree

    def close(self) -> None:
        self._tree = None
        self.source = None


def build_table(right: ColumnBatch, right_on: Sequence[str],
                right_valid=None, ctx=None, name: Optional[str] = None,
                engine=None) -> BuildTable:
    """Build a :class:`BuildTable` to pass as ``hash_join(prebuilt=)``
    (the reference's ``spillable_build_table``); ``ctx`` charging is
    ROADMAP.md queue 1, item 13."""
    if ctx is not None:
        raise not_ported("charging a build table to a task context (ctx=)",
                         13)
    return BuildTable(right, right_on, right_valid=right_valid, name=name,
                      engine=engine)
