"""Equality joins with static-shape outputs, two engines.

Counterpart of ``spark_rapids_jni_tpu/relational/join.py``:

* :func:`hash_join`, every join kind (inner, left, right, full, semi,
  anti) over any mix of plain, string, decimal and encoded key columns
  (string widths aligned across the sides) and payloads of the same
  kinds, on two engines picked by the ``join_engine`` knob.  Key pairs
  over ONE dictionary (equal tokens) key on the one canon word; every
  other encoded key lowers to its value words:

  - **kernel** (``auto``): the build side's radix words go into a slot
    table (slot-table build kernel), build rows are grouped by slot with
    one stable sort, the table's slot records are built once
    (slot-record kernel) and each probe row walks its chain over them
    (slot-table probe kernel);
  - **sort**: the build side sorted by its words
    (:func:`keys.lexsort_u32`) and a vectorized lexicographic bisection
    per probe row (:func:`keys.equal_range`).

  Matches enumerate in original right-row order and expand through the
  offsets/searchsorted expansion, padded to a static ``capacity``: the
  live rows are bit-identical to the reference's engines.
* :func:`spillable_build_table`: a prebuilt build table for
  ``hash_join(prebuilt=)`` (the plan compiler's broadcast joins),
  registered with the spill store: eviction drops it and the next
  ``get()`` rebuilds it.
* :func:`join_dense_or_hash`: when the build side's keys are unique ints
  in ``[0, domain)`` (dense surrogate keys, every TPC-DS dimension; plain
  int columns only) an inner join is a rowid table plus gathers;
  otherwise the general
  :func:`hash_join`.  One host read of the density check picks.

Spark semantics: a null key matches nothing (inner and semi drop
null-keyed left rows, left and full keep them with a null right side,
anti keeps them); dead (padding) rows of either side never match and
produce no output.  ``right`` is the swapped left join (the right
side's columns first); ``full`` keeps every right column, keys included,
and appends the unmatched right rows after the left-join region (output
capacity ``capacity + right.num_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import config
from ..columnar import types as T
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               StringColumn)
from ..columnar.encoded import (BitPackedColumn, DictionaryColumn,
                                FrameOfReferenceColumn, RunLengthColumn,
                                align_encoded_key_columns, is_encoded,
                                materialize_column, pack_bits)
from ..mem.executor import batch_nbytes, run_with_retry
from ..mem.spill import SpillableHandle
from . import keys as K
from .filter import compact
from .gather import gather_batch

_HOWS = ("inner", "left", "right", "full", "semi", "anti")


def _resolve_join_engine(engine):
    """``None`` reads the ``join_engine`` knob; ``auto`` is the kernel
    tier on every device."""
    if engine is None:
        engine = config.get("join_engine")
    if engine == "auto":
        return "kernel"
    if engine not in ("kernel", "sort"):
        raise ValueError(f"unknown join engine {engine!r} "
                         "(use 'auto', 'kernel' or 'sort')")
    return engine


def _hash_build(rkeys, nr: int):
    """Kernel-engine build product over the build side's radix words: the
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


def _sort_build(rkeys) -> tuple:
    """Sort-engine build product: ``(*sorted_rkeys, rperm)``."""
    rperm = K.lexsort_u32(rkeys)
    return tuple(k[rperm] for k in rkeys) + (rperm,)


def _build(rkeys, nr: int, engine: str) -> tuple:
    return _hash_build(rkeys, nr) if engine == "kernel" else \
        _sort_build(rkeys)


def _one_null_row_like(batch: ColumnBatch) -> ColumnBatch:
    """A 1-row all-null batch with the same schema (empty-side pad)."""
    out = {}
    for name, col in zip(batch.names, batch.columns):
        dev = col.device
        none = torch.zeros((1,), dtype=torch.bool, device=dev)
        if isinstance(col, DictionaryColumn):
            # the dictionary and token stay: one null row of it
            out[name] = dataclasses.replace(
                col, codes=torch.zeros((1,), dtype=torch.int32, device=dev),
                validity=none)
        elif isinstance(col, (RunLengthColumn, FrameOfReferenceColumn)):
            out[name] = Column(torch.zeros((1,), dtype=col.dtype.torch_dtype,
                                           device=dev), none, col.dtype)
        elif isinstance(col, BitPackedColumn):
            # the packed layout stays: one zero residual
            out[name] = dataclasses.replace(
                col, lanes=pack_bits(torch.zeros((1,), dtype=torch.int64,
                                                 device=dev), col.width),
                validity=none, zone=None)
        elif isinstance(col, StringColumn):
            out[name] = StringColumn(
                torch.zeros((1, col.max_len), dtype=torch.uint8,
                            device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev), none,
                col.dtype)
        elif isinstance(col, Decimal128Column):
            out[name] = Decimal128Column(
                torch.zeros((1, 2), dtype=torch.int64, device=dev), none,
                col.dtype)
        else:
            out[name] = Column(torch.zeros((1,), dtype=col.data.dtype,
                                           device=dev), none, col.dtype)
    return ColumnBatch(out)


def _require_keys(cols: Sequence, what: str) -> None:
    for c in cols:
        if getattr(c, "dtype", None) is not None and c.dtype.is_nested:
            raise NotImplementedError(f"{what} over {c.dtype!r}")
        if not isinstance(c, (Column, StringColumn, Decimal128Column)) \
                and not is_encoded(c):
            raise TypeError(f"{what} over {type(c).__name__}")


def _with_validity(cols, valid):
    return [dataclasses.replace(c, validity=c.validity & valid)
            for c in cols]


def hash_join(left: ColumnBatch, right: ColumnBatch,
              left_on: Sequence[str], right_on: Sequence[str],
              how: str = "inner", capacity: Optional[int] = None,
              suffixes: tuple = ("", "_r"), left_valid=None,
              right_valid=None, prebuilt=None, engine=None) -> tuple:
    """Equality join; returns ``(result_batch, count)``.

    ``capacity`` is the static output row budget of the inner/left-join
    region (default ``left.num_rows``, exact for a key-unique build
    side); ``count`` is the true match total, and ``count > capacity``
    signals truncation (a full join's count is then ``capacity +
    right.num_rows + 1``).  semi/anti return the filtered left rows
    compacted to the front, like ``compact``.  ``left_valid`` /
    ``right_valid`` mark live rows.  The output keeps the left columns,
    then the right side's non-key columns (``full``: every right
    column); colliding names take ``suffixes``.

    ``engine``: ``'kernel' | 'sort' | 'auto'`` (default: the
    ``join_engine`` knob).  ``prebuilt`` skips the build: a
    :class:`SpillableBuildTable` from :func:`spillable_build_table`
    (fetched pinned through the retry ladder, rebuilt if it was dropped,
    and probed under the engine of its latest build), or a raw build
    product of the engine
    this call resolves to (:func:`_hash_build`'s tuple, or
    ``(*sorted_rkeys, rperm)``).  It must have been built from the same
    ``right`` / ``right_on`` / ``right_valid``; nothing re-validates
    that.
    """
    if how not in _HOWS:
        raise ValueError(f"unknown join type {how!r}")
    if len(left_on) != len(right_on):
        raise ValueError("left_on/right_on length mismatch")
    if how == "right":
        if prebuilt is not None:
            # the swap makes the left input the build side
            raise ValueError("prebuilt build tables are not supported for "
                             "how='right' (the swap changes the build side)")
        return hash_join(right, left, right_on, left_on, "left",
                         capacity=capacity,
                         suffixes=(suffixes[1], suffixes[0]),
                         left_valid=right_valid, right_valid=left_valid,
                         engine=engine)
    if isinstance(prebuilt, SpillableBuildTable):
        # pinned across the probe: an evictor may not drop the table
        # (releasing its charge) while it is in use
        with prebuilt.pinned():
            built = run_with_retry(prebuilt.get)
            return hash_join(left, right, left_on, right_on, how,
                             capacity=capacity, suffixes=suffixes,
                             left_valid=left_valid, right_valid=right_valid,
                             prebuilt=built, engine=prebuilt.engine)
    engine = _resolve_join_engine(engine)
    nl, nr = left.num_rows, right.num_rows
    padded_right = nr == 0
    if nr == 0:
        if prebuilt is not None:
            raise ValueError("prebuilt build table for an empty build side")
        # one unmatchable null row keeps every gather in bounds
        right = _one_null_row_like(right)
        nr = 1
    if nl == 0:
        # one dead row: no output except a full join's appended rows
        left = _one_null_row_like(left)
        nl = 1
        left_valid = torch.zeros((1,), dtype=torch.bool,
                                 device=left[left_on[0]].device)
    lkcols = [left[k] for k in left_on]
    rkcols = [right[k] for k in right_on]
    _require_keys(lkcols + rkcols, "hash_join keys")
    if prebuilt is None:
        # one dictionary on both sides: one canon word a key column (a
        # prebuilt table's keys are value words, so it keeps them)
        lkcols, rkcols = align_encoded_key_columns(lkcols, rkcols)
    lcols, rcols = K.align_string_key_columns(lkcols, rkcols)
    if right_valid is not None:
        rcols = _with_validity(rcols, right_valid)
    dev = lcols[0].device

    lkeys = K.batch_radix_keys(lcols, equality=True, nulls_first=False)
    l_null = torch.zeros((nl,), dtype=torch.bool, device=dev)
    for c in lcols:
        l_null = l_null | ~c.validity
    l_live = (torch.ones((nl,), dtype=torch.bool, device=dev)
              if left_valid is None else left_valid.to(torch.bool))

    # null build keys never match: under the kernel engine they sit in
    # their own slot, which no valid probe's words equal; under the sort
    # engine their flag word differs from every valid probe's.  Null and
    # dead probe rows are masked.  Either way a probe row's matches are
    # rperm[lo .. lo + counts), in original right-row order.
    rkeys = None
    if prebuilt is None:
        rkeys = K.batch_radix_keys(rcols, equality=True, nulls_first=False)
        prebuilt = _build(rkeys, nr, engine)
    if engine == "kernel":
        from . import hashtable as H

        # the walk is bounded by the records' chain bound (result-
        # identical to the full table), so the probe reads nothing back
        owner, rslot, rperm, counts_slot, off_slot, records = prebuilt
        found, lslot = H.probe_slot_records(records, lkeys,
                                            ~l_null & l_live)
        lslot = lslot.to(torch.int64)
        counts = torch.where(found, counts_slot[lslot],
                             torch.zeros_like(lslot))
        lo = off_slot[lslot]
    else:
        sorted_rkeys, rperm = list(prebuilt[:-1]), prebuilt[-1]
        lo, hi = K.equal_range(sorted_rkeys, lkeys)
        counts = torch.where(l_null | ~l_live, torch.zeros_like(lo),
                             hi - lo)

    if how == "semi":
        return compact(left, (counts > 0) & l_live)
    if how == "anti":
        return compact(left, (counts == 0) & l_live)

    outer = how in ("left", "full")
    counts_out = (torch.where(l_live, counts.clamp(min=1),
                              torch.zeros_like(counts))
                  if outer else counts)
    cum = torch.cumsum(counts_out, 0)  # inclusive
    total = cum[-1]
    offsets = cum - counts_out
    cap = nl if capacity is None else int(capacity)
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    li = torch.searchsorted(cum, j, right=True).clamp(0, nl - 1)
    k = j - offsets[li]
    pos = (lo[li] + k).clamp(0, nr - 1)
    ri = rperm[pos]
    out_valid = j < total
    matched = (counts[li] > 0) & out_valid
    lpart = gather_batch(left, li, out_valid)
    right_names = (list(right.names) if how == "full"
                   else [n for n in right.names if n not in right_on])
    rpart = gather_batch(right.select(right_names), ri,
                         matched if outer else out_valid)
    if how == "full":
        r_live = (torch.ones((nr,), dtype=torch.bool, device=dev)
                  if right_valid is None else right_valid.to(torch.bool))
        if padded_right:  # the empty build side's pad row is no right row
            unmatched = torch.zeros_like(r_live)
        elif engine == "kernel":
            # a right row is matched iff a live non-null probe row found
            # its slot (misses and dead probes carry slot S)
            hit = torch.zeros((owner.shape[0] + 1,), dtype=torch.bool,
                              device=dev)
            hit[lslot[found]] = True
            unmatched = ~hit[rslot.to(torch.int64)] & r_live
        else:
            unmatched = _unmatched_by_search(lkeys, lcols, rcols, rkeys,
                                             l_live, left_valid, r_live)
        lpart, rpart, total = _append_rows(
            left, right.select(right_names), lpart, rpart, total, cap,
            unmatched)
    return _merge_parts(lpart, rpart, suffixes), total


def _unmatched_by_search(lkeys, lcols, rcols, rkeys, l_live, left_valid,
                         r_live):
    """The sort engine's unmatched right rows: the live right rows with a
    null key or a key no live left row carries, found by probing the
    sorted left keys with the right keys (dead left rows re-key as
    nulls, which match nothing)."""
    if left_valid is not None:
        lkeys = K.batch_radix_keys(_with_validity(lcols, l_live),
                                   equality=True, nulls_first=False)
    if rkeys is None:  # a prebuilt table carries only the sorted keys
        rkeys = K.batch_radix_keys(rcols, equality=True, nulls_first=False)
    lperm = K.lexsort_u32(lkeys)
    rlo, rhi = K.equal_range([k[lperm] for k in lkeys], rkeys)
    r_null = torch.zeros_like(r_live)
    for c in rcols:
        r_null = r_null | ~c.validity
    return r_live & (r_null | (rhi == rlo))


def _append_rows(left, rsel, lpart, rpart, total, cap, unmatched):
    """A full join's tail: the ``unmatched`` right rows (of ``rsel``, the
    right columns the output keeps) appended after the left-join region
    with a null left side, and pulled up against its live rows.  When
    that region overflowed its budget the count becomes ``cap + nr + 1``,
    which exceeds any output."""
    nr = rsel.num_rows
    dev = unmatched.device
    n_un = unmatched.sum()
    order = torch.sort((~unmatched).to(torch.int8), stable=True).indices
    rpart = _concat_batches(rpart, gather_batch(
        rsel, order, torch.arange(nr, device=dev) < n_un))
    lpart = _concat_batches(lpart, gather_batch(
        left, torch.zeros((nr,), dtype=torch.int64, device=dev),
        torch.zeros((nr,), dtype=torch.bool, device=dev)))
    emitted = total.clamp(max=cap)
    total = torch.where(total > cap, torch.full_like(total, cap + nr + 1),
                        total + n_un)
    idx = torch.arange(cap + nr, dtype=torch.int64, device=dev)
    src = torch.where(idx < emitted, idx, cap + idx - emitted).clamp(
        0, cap + nr - 1)
    live = idx < emitted + n_un
    return (gather_batch(lpart, src, live), gather_batch(rpart, src, live),
            total)


def join_dense_or_hash(left: ColumnBatch, right: ColumnBatch, left_on: str,
                       right_on: str, domain: int, how: str = "inner",
                       capacity: Optional[int] = None,
                       suffixes: tuple = ("", "_r"), left_valid=None,
                       right_valid=None) -> tuple:
    """Inner join for the dimension-table shape: a rowid table when the
    build keys are unique ints in ``[0, domain)``, else :func:`hash_join`.
    Same output contract either way: matches compacted in left-row order,
    ``(result, count)``.  Encoded keys take :func:`hash_join`."""
    lcol, rcol = left[left_on], right[right_on]
    ints = T.INT_KINDS + (T.Kind.DATE, T.Kind.TIMESTAMP)
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
    dev = lcol.device
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


def _concat_col(a, b):
    if isinstance(a, DictionaryColumn) and isinstance(b, DictionaryColumn) \
            and a.dict_token == b.dict_token and a.dict_token > 0:
        # one dictionary: the codes concatenate, the column stays encoded
        return dataclasses.replace(a, codes=torch.cat([a.codes, b.codes]),
                                   validity=torch.cat([a.validity,
                                                       b.validity]))
    # packed lanes and mixed dictionaries do not concatenate: the full
    # join's append is an output boundary, so they materialize
    a, b = materialize_column(a), materialize_column(b)
    if isinstance(a, StringColumn):
        (a,), (b,) = K.align_string_key_columns([a], [b])
        return StringColumn(torch.cat([a.chars, b.chars]),
                            torch.cat([a.lengths, b.lengths]),
                            torch.cat([a.validity, b.validity]), a.dtype)
    if isinstance(a, Decimal128Column):
        return Decimal128Column(torch.cat([a.limbs, b.limbs]),
                                torch.cat([a.validity, b.validity]), a.dtype)
    return Column(torch.cat([a.data, b.data]),
                  torch.cat([a.validity, b.validity]), a.dtype)


def _concat_batches(a: ColumnBatch, b: ColumnBatch) -> ColumnBatch:
    return ColumnBatch({n: _concat_col(a[n], b[n]) for n in a.names})


# ---------------------------------------------------------------------------
# spillable build tables: eviction drops, read-back rebuilds
# ---------------------------------------------------------------------------

class SpillableBuildTable(SpillableHandle):
    """A join build table over ``right[right_on]`` (over any number of
    plain key columns: its slot records carry all their words),
    registered with the spill store as a handle whose payload is
    recomputed rather than copied: ``spill()`` drops the device table and
    releases its charge (tier ``"dropped"``, no host or disk copy), and
    ``get()`` rebuilds it through the ``recompute=`` lineage path,
    counting ``rebuilds``.  The build side's key columns stay with the
    table, as the source they are rebuilt from.

    ``engine=None`` reads the ``join_engine`` knob at every (re)build;
    ``engine`` records the engine of the latest build, which the probe
    follows.  An explicit engine pins it across rebuilds (the plan
    compiler pins what it decided).  :meth:`for_batch` rebuilds the table
    over a different batch, so a plan reused over new build-side data
    never probes a stale table.
    """

    def __init__(self, right: ColumnBatch, right_on: Sequence[str],
                 right_valid=None, ctx=None, name: Optional[str] = None,
                 engine=None):
        self.right_on = tuple(right_on)
        self._right_valid = right_valid
        self._engine_pin = engine
        self._rcols = self._key_columns(right)
        self.source = right
        super().__init__(self._build(), ctx=ctx,
                         name=name or f"build-table-{id(self):x}",
                         recompute=self._build)

    def _key_columns(self, right: ColumnBatch) -> list:
        if right.num_rows == 0:
            raise ValueError("cannot pre-build an empty build side")
        rcols = [right[k] for k in self.right_on]
        _require_keys(rcols, "build table keys")
        if any(K.string_key_width(c) is not None for c in rcols):
            raise ValueError(
                "string join keys cannot be pre-built: their key width "
                "depends on the probe side (align_string_key_columns)")
        if self._right_valid is not None:
            rcols = _with_validity(rcols, self._right_valid)
        return rcols

    def _build(self) -> tuple:
        self.engine = _resolve_join_engine(self._engine_pin)
        rkeys = K.batch_radix_keys(self._rcols, equality=True,
                                   nulls_first=False)
        return _build(rkeys, self._rcols[0].num_rows, self.engine)

    @property
    def rebuilds(self) -> int:
        return self.lineage_rebuilds

    def for_batch(self, right: ColumnBatch) -> "SpillableBuildTable":
        """This table for ``right``: as it is when it was built from
        ``right``, else rebuilt from it and charged anew."""
        with self._lock:
            if self._closed:
                raise ValueError(f"{self.name} is closed")
            if right is self.source:
                return self
            self._rcols = self._key_columns(right)
            self._tree = None
            if self._ctx is not None and self._device_charged:
                self._ctx.release(self._device_charged)
                self._device_charged = 0
            tree = self._build()
            self._lineage_nbytes = batch_nbytes(tree)
            if self._ctx is not None:
                self._device_charged = self._ctx.charge(self._lineage_nbytes)
            self._tree = tree
            self.source = right
            return self

    def spill(self) -> int:
        if not self._lock.acquire(blocking=False):
            return 0  # busy in another thread's get(): treat as pinned
        try:
            if self._closed or self._tree is None or self._pins > 0:
                return 0
            self._tree = None
            freed = self._device_charged
            if self._ctx is not None and self._device_charged:
                self._ctx.release(self._device_charged)
                self._device_charged = 0
            if self._fw is not None:
                # dropping is this handle's device -> host transition for
                # the accounting: zero bytes moved, one eviction
                self._fw.metrics.record("device_to_host", 0, self.task_id)
            return freed
        finally:
            self._lock.release()

    spill_host = spill  # no host tier to demote; keep the interface

    def close(self):
        super().close()
        self._rcols = None
        self.source = None


def spillable_build_table(right: ColumnBatch, right_on: Sequence[str],
                          right_valid=None, ctx=None,
                          name: Optional[str] = None,
                          engine=None) -> SpillableBuildTable:
    """Build a :class:`SpillableBuildTable` to pass as
    ``hash_join(prebuilt=)``, charged to ``ctx`` when given.  Raises for
    string join keys (their key width follows the probe side) and for an
    empty build side.  Close it when done."""
    return SpillableBuildTable(right, right_on, right_valid=right_valid,
                               ctx=ctx, name=name, engine=engine)

