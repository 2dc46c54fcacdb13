"""Length-bucketed string storage.

Counterpart of ``spark_rapids_jni_tpu/columnar/bucketed.py``.  A flat
:class:`~.column.StringColumn` pads every row to the column's longest
value; a :class:`BucketedStringColumn` splits rows by length into a few
geometric width buckets, so memory follows the real char mass and a
per-bucket kernel runs at its bucket's width.  Each bucket is an
ordinary :class:`~.column.StringColumn` plus the int64 row ids of its
rows in the original order; per-bucket results merge back with one
scatter per bucket.

:func:`plan_widths` is also the width rule of a string dictionary
(:mod:`.encoded`): a dictionary of short strings takes the ladder's
smallest width that holds its longest entry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .column import Column, StringColumn

DEFAULT_WIDTH_LADDER = (32, 128, 512, 2048, 8192, 32768)


def plan_widths(lengths, ladder: Sequence[int] = DEFAULT_WIDTH_LADDER
                ) -> List[int]:
    """The subset of the width ladder ``lengths`` needs (at least one
    bucket; the last width covers the true maximum)."""
    need = int(max(lengths, default=0))
    widths = [w for w in ladder if w < need]
    cap = next((w for w in ladder if w >= need), None)
    widths.append(cap if cap is not None else max(need, 1))
    return widths


def _ids(sel: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(sel.astype(np.int64)).to(dev)


@dataclasses.dataclass
class BucketedStringColumn:
    """Strings split into width buckets; ``row_ids[b][i]`` is the
    original row of bucket ``b``'s row ``i``."""

    buckets: List[StringColumn]
    row_ids: List[torch.Tensor]  # int64 per bucket
    num_rows: int

    @property
    def widths(self) -> List[int]:
        return [b.max_len for b in self.buckets]

    @property
    def total_char_capacity(self) -> int:
        return sum(b.chars.shape[0] * b.max_len for b in self.buckets)

    @property
    def device(self) -> torch.device:
        return self.buckets[0].device

    # ---- host constructors -------------------------------------------
    @staticmethod
    def from_pylist(values: Sequence[Optional[str]],
                    ladder: Sequence[int] = DEFAULT_WIDTH_LADDER,
                    device=None) -> "BucketedStringColumn":
        """Bucket host strings (``None`` is a null); ``device=None``
        means the GPU."""
        dev = resolve_device(device)
        encoded = [v.encode("utf-8") if v is not None else b""
                   for v in values]
        lens = np.asarray([len(b) for b in encoded], np.int64)
        widths = plan_widths(lens.tolist(), ladder)
        which = np.searchsorted(np.asarray(widths), lens, side="left")
        buckets, row_ids = [], []
        for b, w in enumerate(widths):
            sel = np.nonzero(which == b)[0]
            if sel.size == 0:
                continue
            buckets.append(StringColumn.from_pylist(
                [values[i] for i in sel], max_len=w, device=dev))
            row_ids.append(_ids(sel, dev))
        if not buckets:  # an empty column keeps one empty bucket
            buckets = [StringColumn.from_pylist([], max_len=widths[0],
                                                device=dev)]
            row_ids = [torch.zeros((0,), dtype=torch.int64, device=dev)]
        return BucketedStringColumn(buckets, row_ids, len(values))

    @staticmethod
    def from_string_column(col: StringColumn,
                           ladder: Sequence[int] = DEFAULT_WIDTH_LADDER
                           ) -> "BucketedStringColumn":
        """Re-bucket a flat column (one host read of its buffers)."""
        dev = col.device
        lens = col.lengths.cpu().numpy()
        chars = col.chars.cpu().numpy()
        valid = col.validity.cpu().numpy()
        widths = plan_widths(lens.tolist(), ladder)
        buckets, row_ids = [], []
        lo = -1
        for w in widths:
            sel = np.nonzero((lens > lo) & (lens <= w))[0]
            lo = w
            if sel.size == 0:
                continue
            sub = np.zeros((sel.size, w), np.uint8)
            take = min(w, chars.shape[1])
            sub[:, :take] = chars[sel, :take]
            buckets.append(StringColumn(
                torch.from_numpy(sub).to(dev),
                torch.from_numpy(lens[sel].astype(np.int32)).to(dev),
                torch.from_numpy(valid[sel].copy()).to(dev)))
            row_ids.append(_ids(sel, dev))
        if not buckets:
            buckets = [StringColumn.from_pylist([], max_len=widths[0],
                                                device=dev)]
            row_ids = [torch.zeros((0,), dtype=torch.int64, device=dev)]
        return BucketedStringColumn(buckets, row_ids, col.num_rows)

    # ---- per-bucket execution ----------------------------------------
    def apply(self, fn: Callable[[StringColumn], StringColumn]
              ) -> "BucketedStringColumn":
        """Run a StringColumn -> StringColumn function per bucket, each at
        its own width; the result stays bucketed."""
        return BucketedStringColumn([fn(b) for b in self.buckets],
                                    list(self.row_ids), self.num_rows)

    def apply_column(self, fn) -> Column:
        """Run a StringColumn -> Column function per bucket and merge the
        results into one row-ordered column (one scatter a bucket)."""
        outs = [(fn(b), ids) for b, ids in zip(self.buckets, self.row_ids)]
        first = outs[0][0]
        dev = first.data.device
        data = torch.zeros((self.num_rows,) + tuple(first.data.shape[1:]),
                           dtype=first.data.dtype, device=dev)
        valid = torch.zeros((self.num_rows,), dtype=torch.bool, device=dev)
        for col, ids in outs:
            if col.data.shape[0] == 0:
                continue
            data[ids] = col.data
            valid[ids] = col.validity
        return Column(data, valid, first.dtype)

    def merge(self) -> StringColumn:
        """Scatter the buckets back into one row-ordered StringColumn as
        wide as the widest bucket."""
        width = max((b.max_len for b in self.buckets), default=1)
        n = self.num_rows
        dev = self.device
        chars = torch.zeros((n, width), dtype=torch.uint8, device=dev)
        lengths = torch.zeros((n,), dtype=torch.int32, device=dev)
        valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        for b, ids in zip(self.buckets, self.row_ids):
            if b.chars.shape[0] == 0:
                continue
            chars[ids, :b.max_len] = b.chars
            lengths[ids] = b.lengths
            valid[ids] = b.validity
        return StringColumn(chars, lengths, valid)

    def to_pylist(self) -> list:
        out = [None] * self.num_rows
        for b, ids in zip(self.buckets, self.row_ids):
            for val, row in zip(b.to_pylist(), ids.cpu().tolist()):
                out[row] = val
        return out
