"""Spark ``percentile`` over (value, frequency) histograms.

Counterpart of ``spark_rapids_jni_tpu/ops/histogram.py``.  Reference:
``histogram.cu`` — ``create_histogram_if_valid`` (:283) validates
frequencies (negative -> error) and nulls out entries with freq <= 0;
``percentile_from_histogram`` (:429) segment-sorts each histogram's
elements, computes inclusive cumulative frequencies, and linearly
interpolates ``position = (total_freq - 1) * percentage`` between the two
straddling elements (``fill_percentile_fn``, :50).

A batch of H histograms is (values Column, freqs int64 Column, offsets
int32[H+1]) — the flattened LIST layout.  The sort is one stable
lexicographic sort keyed (segment, validity, value) through
:mod:`..relational.keys`; cumulative counts are a segmented cumsum
(global cumsum minus per-segment base); the per-(histogram, percentage)
rank search is the reference's binary search as a fixed count of masked
halving steps over the cumulative array restricted to each segment, so
its results are the reference's to the element.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..columnar import types as T
from ..columnar.column import Column
from ..relational import keys as K


def create_histogram_if_valid(values: Column, frequencies: Column
                              ) -> Tuple[Column, Column]:
    """Validate and pack (value, freq) pairs (reference histogram.cu:283).

    Negative frequencies raise; entries with freq <= 0 or null value
    become null elements.  Returns the masked (values, frequencies).
    """
    if frequencies.dtype.kind is not T.Kind.INT64:
        raise TypeError("frequencies must be INT64")
    if values.num_rows != frequencies.num_rows:
        raise ValueError("values and frequencies must have the same size")
    # mask null-frequency rows: their buffer lanes may hold residual values
    freq = torch.where(frequencies.validity, frequencies.data,
                       torch.zeros_like(frequencies.data))
    if bool((freq < 0).any()):  # one host read, as the reference's check
        raise ValueError(
            "The input frequencies must not contain negative values.")
    valid = values.validity & (freq > 0)
    return (Column(values.data, valid, values.dtype),
            Column(freq, frequencies.validity, frequencies.dtype))


def percentile_from_histogram(values: Column, frequencies: Column, offsets,
                              percentages: Sequence[float]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact percentiles per histogram (reference histogram.cu:429).

    ``offsets``: int32[H+1] flattened-list boundaries (a tensor or host
    array; it joins the values' device).  Returns ``(out float64[H, P],
    histogram_valid bool[H])`` on the values' device; all-null
    histograms yield invalid rows.
    """
    if any(not (0.0 <= p <= 1.0) for p in percentages):
        raise ValueError("percentages must be in [0, 1]")
    dev = values.data.device
    offsets = torch.as_tensor(np.asarray(offsets, np.int32) if not
                              isinstance(offsets, torch.Tensor) else offsets
                              ).to(device=dev, dtype=torch.int32)
    H = offsets.shape[0] - 1
    n = values.num_rows
    pct = torch.tensor(list(map(float, percentages)), dtype=torch.float64,
                       device=dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    seg = (torch.searchsorted(offsets, rows, right=True) - 1).to(torch.int32)
    invalid = ~values.validity

    words = [seg.to(torch.int64), invalid.to(torch.int64)] + [
        torch.where(values.validity, k, torch.zeros_like(k))
        for k in K.column_radix_keys(values, equality=False)]
    perm = K.lexsort_u32(words)

    s_vals = values.data[perm].to(torch.float64)
    s_valid = values.validity[perm]
    s_freq = frequencies.data[perm] * s_valid.to(torch.int64)

    total = torch.cumsum(s_freq, 0)
    starts = offsets[:H]
    base = torch.where(starts > 0, total[(starts - 1).clamp(min=0).long()],
                       torch.zeros_like(total[:1]))
    acc = total - base[seg.clamp(0, max(H - 1, 0)).long()]

    in_seg = (seg >= 0) & (seg < H)
    valid_counts = torch.zeros((H,), dtype=torch.int64, device=dev)
    valid_counts.index_add_(0, seg.clamp(0, max(H - 1, 0)).long(),
                            (s_valid & in_seg).to(torch.int64))
    valid_counts = valid_counts.to(torch.int32)
    ends = starts + valid_counts  # nulls sorted to each segment's tail
    hist_valid = valid_counts > 0

    total_freq = torch.where(hist_valid, acc[(ends - 1).clamp(min=0).long()],
                             torch.ones_like(acc[:1]))
    max_positions = (total_freq - 1).to(torch.float64)

    # per (h, p) rank positions
    position = max_positions[:, None] * pct[None, :]  # [H, P]
    lower = torch.floor(position).to(torch.int64)
    higher = torch.ceil(position).to(torch.int64)
    last = max(n - 1, 0)

    def search(rank):  # first idx in [start, end) with acc[idx] >= rank
        lo = starts[:, None].expand(rank.shape)
        hi = ends[:, None].expand(rank.shape)
        for _ in range(max(1, int(n).bit_length() + 1)):
            active = lo < hi
            mid = (lo + hi) >> 1
            adv = acc[mid.clamp(0, last).long()] < rank
            lo = torch.where(active & adv, mid + 1, lo)
            hi = torch.where(active & ~adv, mid, hi)
        return lo

    idx_lo = search(lower + 1)
    idx_hi = search(higher + 1)
    el_lo = s_vals[idx_lo.clamp(0, last).long()]
    el_hi = s_vals[idx_hi.clamp(0, last).long()]

    same = (higher == lower) | (el_hi == el_lo)
    lower_part = (higher.to(torch.float64) - position) * el_lo
    higher_part = (position - lower.to(torch.float64)) * el_hi
    out = torch.where(same, el_lo, lower_part + higher_part)
    return out, hist_valid
