"""Order-preserving radix keys for group-by and join.

Counterpart of ``spark_rapids_jni_tpu/relational/keys.py`` for plain
fixed-width columns.  Each key column lowers to u32 words (int64
carrier, :mod:`.._u32`) whose unsigned lexicographic order is Spark's
SQL order:

* signed ints and dates: sign bit flipped;
* floats: IEEE-754 total order (negatives flip every bit, others the sign
  bit); every NaN is the canonical quiet NaN, and in the equality domain
  (group-by, join) ``-0.0`` is ``0.0`` (Spark's NormalizeFloatingNumbers);
* 64-bit values: a (hi, lo) word pair;
* validity: one leading flag word placing nulls first or last.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .._roadmap import not_ported
from .._u32 import M32, SIGN32
from ..columnar import types as T
from ..columnar.column import Column

_F32_QNAN = 0x7FC00000
_F64_QNAN = 0x7FF8000000000000
_SIGN64 = -(1 << 63)  # int64 with only bit 63 set


def _split64(u: torch.Tensor):
    """int64 bit pattern -> (hi, lo) u32 words."""
    return (u >> 32) & M32, u & M32


def _f64_total_order(d: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    if normalize_zero:
        d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype,
                                               device=d.device), d)
    bits = d.contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(d), torch.full_like(bits, _F64_QNAN),
                       bits)
    return torch.where(bits < 0, ~bits, bits ^ _SIGN64)


def column_radix_keys(col: Column, *, equality: bool = False) -> list:
    """One column -> its list of u32 key words (nulls not encoded).

    ``equality=True`` applies the equality-domain float normalization
    (``-0.0 -> 0.0``); NaNs canonicalize in both domains.
    """
    if not isinstance(col, Column):
        raise not_ported(f"radix keys of {type(col).__name__}", 10)
    kind = col.dtype.kind
    d = col.data
    if kind is T.Kind.BOOLEAN:
        return [d.to(torch.int64)]
    if kind in (T.Kind.INT32, T.Kind.DATE):
        return [(d.to(torch.int64) & M32) ^ SIGN32]
    if kind is T.Kind.INT64:
        return list(_split64(d.to(torch.int64) ^ _SIGN64))
    if kind is T.Kind.FLOAT64:
        return list(_split64(_f64_total_order(d, normalize_zero=equality)))
    raise not_ported(f"radix keys for {col.dtype!r}", 10)


def null_flag(col: Column, nulls_first: bool) -> torch.Tensor:
    """Leading key word encoding null placement (0 sorts before 1)."""
    v = col.validity.to(torch.int64)
    return v if nulls_first else 1 - v


def batch_radix_keys(cols: Sequence[Column], *, equality: bool,
                     nulls_first: bool = True) -> list:
    """Key words for a composite key, null flags included.

    Data words of null rows are zeroed so every null row carries identical
    keys (Spark groups all nulls as one group).
    """
    out = []
    for c in cols:
        out.append(null_flag(c, nulls_first))
        v = c.validity
        out.extend(torch.where(v, k, torch.zeros_like(k))
                   for k in column_radix_keys(c, equality=equality))
    return out


def rows_equal_adjacent(key_arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool[n]: row i has identical keys to row i-1 (row 0 -> False)."""
    n = key_arrays[0].shape[0]
    eq = torch.ones((n,), dtype=torch.bool, device=key_arrays[0].device)
    for k in key_arrays:
        eq = eq & (k == torch.roll(k, 1))
    if n:
        eq[0] = False
    return eq


def lexsort(key_arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``key_arrays`` lexicographically
    (first array most significant) — ``lax.sort(..., is_stable=True)``'s
    order.  torch has no lexsort, so stable sorts chain from the last key
    to the first."""
    n = key_arrays[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=key_arrays[0].device)
    for k in reversed(list(key_arrays)):
        idx = torch.sort(k[perm], stable=True).indices
        perm = perm[idx]
    return perm
