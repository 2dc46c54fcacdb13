"""Order-preserving radix keys for sort, group-by and join.

Counterpart of ``spark_rapids_jni_tpu/relational/keys.py``.  Each key
column lowers to u32 words (int64 carrier, :mod:`.._u32`) whose unsigned
lexicographic order is Spark's SQL order:

* signed ints and dates (int8 and int16 widened to 32 bits): sign bit
  flipped; int64 and timestamps: a (hi, lo) word pair of the flipped
  value;
* floats: IEEE-754 total order (negatives flip every bit, others the sign
  bit); every NaN is the canonical quiet NaN (one NaN, greatest), and in
  the equality domain (group-by, join) ``-0.0`` is ``0.0`` (Spark's
  NormalizeFloatingNumbers); the ordering domain (sort) keeps
  ``-0.0 < 0.0``;
* strings: big-endian 4-byte words of the zero-padded chars, then the
  length as a trailing word (padding is zero, so the length tells
  ``'a'`` from ``'a\\x00'``);
* decimals (one column shares one scale, so unscaled order is value
  order): under 128 bits of storage the sign-flipped low limb as a
  (hi, lo) pair; at 128 bits the sign-flipped high limb's pair, then
  the low limb's;
* validity: one leading flag word placing nulls first or last;
* encoded columns lower to their VALUE words, so they key against plain
  columns and other dictionaries alike: a dictionary's own words
  gathered by code, a run column's by run, and packed and
  frame-of-reference ints through reference + residual arithmetic,
  never through ``decode()``.  The one-word canon path of a dictionary
  is substituted by callers under a token match
  (:func:`~..columnar.encoded.align_encoded_key_columns`).

The same words feed the stable sorts (:func:`lexsort_u32`), segment
boundaries and the lexicographic binary search of the sort join engine
(:func:`equal_range`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .._u32 import M32, SIGN32
from ..columnar import types as T
from ..columnar.column import (Column, Decimal128Column, ListColumn,
                               StringColumn, StructColumn)
from ..columnar.encoded import (BitPackedColumn, DictionaryColumn,
                                FrameOfReferenceColumn, RunLengthColumn)

_F32_QNAN = 0x7FC00000
_F64_QNAN = 0x7FF8000000000000
_SIGN64 = -(1 << 63)  # int64 with only bit 63 set


def _split64(u: torch.Tensor):
    """int64 bit pattern -> (hi, lo) u32 words."""
    return (u >> 32) & M32, u & M32


def _f32_total_order(d: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    if normalize_zero:
        d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype,
                                               device=d.device), d)
    bits = d.contiguous().view(torch.int32).to(torch.int64) & M32
    bits = torch.where(torch.isnan(d), torch.full_like(bits, _F32_QNAN),
                       bits)
    return torch.where(bits >= SIGN32, bits ^ M32, bits ^ SIGN32)


def _f64_total_order(d: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    if normalize_zero:
        d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype,
                                               device=d.device), d)
    bits = d.contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(d), torch.full_like(bits, _F64_QNAN),
                       bits)
    return torch.where(bits < 0, ~bits, bits ^ _SIGN64)


def _bswap32(u: torch.Tensor) -> torch.Tensor:
    return (((u & 0xFF) << 24) | (((u >> 8) & 0xFF) << 16)
            | (((u >> 16) & 0xFF) << 8) | ((u >> 24) & 0xFF))


def string_words(col: StringColumn) -> list:
    """A string column's data words: ``ceil(max_len / 4)`` big-endian
    words of the padded chars, then the length word."""
    chars = col.chars
    n, L = chars.shape
    nwords = max(1, -(-L // 4))
    if nwords * 4 != L:
        chars = torch.cat([chars, torch.zeros(
            (n, nwords * 4 - L), dtype=chars.dtype, device=chars.device)],
            1)
    # little-endian int32 view of each 4 bytes, byte-swapped to big-endian
    le = chars.contiguous().view(torch.int32).to(torch.int64) & M32
    words = _bswap32(le).t().contiguous()
    return list(words.unbind(0)) + [col.lengths.to(torch.int64) & M32]


def column_radix_keys(col, *, equality: bool = False) -> list:
    """One column -> its list of u32 key words (nulls not encoded).

    ``equality=True`` applies the equality-domain float normalization
    (``-0.0 -> 0.0``); NaNs canonicalize in both domains.
    """
    if isinstance(col, DictionaryColumn):
        # words of the d entries once, then one gather per word by code
        idx = col.codes.to(torch.int64)
        return [w[idx] for w in
                column_radix_keys(col.dictionary, equality=equality)]
    if isinstance(col, RunLengthColumn):
        run = col.row_to_run()
        values = Column(col.run_values, torch.ones(
            (col.num_runs,), dtype=torch.bool, device=col.device), col.dtype)
        return [w[run] for w in column_radix_keys(values, equality=equality)]
    if isinstance(col, BitPackedColumn):
        return _int_value_words(col.residuals() + int(col.reference),
                                col.dtype)
    if isinstance(col, FrameOfReferenceColumn):
        return _int_value_words(col.values64(), col.dtype)
    if isinstance(col, StringColumn):
        return string_words(col)
    if isinstance(col, Decimal128Column):
        if col.dtype.decimal_storage_bits < 128:
            return list(_split64(col.limbs[:, 0] ^ _SIGN64))
        return (list(_split64(col.limbs[:, 1] ^ _SIGN64))
                + list(_split64(col.limbs[:, 0])))
    if isinstance(col, (ListColumn, StructColumn)):
        raise NotImplementedError(f"radix keys for {col.dtype!r}")
    kind = col.dtype.kind
    d = col.data
    if kind is T.Kind.BOOLEAN:
        return [d.to(torch.int64)]
    if kind in (T.Kind.INT8, T.Kind.INT16, T.Kind.INT32, T.Kind.DATE):
        return [(d.to(torch.int64) & M32) ^ SIGN32]
    if kind in (T.Kind.INT64, T.Kind.TIMESTAMP):
        return list(_split64(d.to(torch.int64) ^ _SIGN64))
    if kind is T.Kind.FLOAT32:
        return [_f32_total_order(d, normalize_zero=equality)]
    if kind is T.Kind.FLOAT64:
        return list(_split64(_f64_total_order(d, normalize_zero=equality)))
    raise NotImplementedError(f"radix keys for {col.dtype!r}")


def _int_value_words(vals64: torch.Tensor, dtype) -> list:
    """int64[n] decoded values -> the kind's order-preserving words (the
    packed lowerings)."""
    kind = dtype.kind
    if kind in (T.Kind.INT8, T.Kind.INT16, T.Kind.INT32, T.Kind.DATE):
        return [(vals64.to(torch.int32).to(torch.int64) & M32) ^ SIGN32]
    if kind in (T.Kind.INT64, T.Kind.TIMESTAMP):
        return list(_split64(vals64 ^ _SIGN64))
    raise NotImplementedError(f"packed radix keys for {dtype!r}")


def null_flag(col, nulls_first: bool) -> torch.Tensor:
    """Leading key word encoding null placement (0 sorts before 1)."""
    v = col.validity.to(torch.int64)
    return v if nulls_first else 1 - v


def batch_radix_keys(cols: Sequence, *, equality: bool,
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


def pack_u32_pairs(words: Sequence[torch.Tensor]) -> list:
    """u32 words -> int64 keys with the same lexicographic order, two
    words a key: ``(a - 2^31) * 2^32 + b`` is a signed int64 ordered as
    the unsigned pair ``(a, b)``, without overflow.  An odd last word
    stays as it is."""
    ws = list(words)
    out = [(ws[i] - SIGN32) * (1 << 32) + ws[i + 1]
           for i in range(0, len(ws) - 1, 2)]
    if len(ws) % 2:
        out.append(ws[-1])
    return out


def lexsort_u32(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`lexsort` of u32 words (values in ``[0, 2^32)``), two words
    a stable sort pass: the same permutation in half the passes."""
    return lexsort(pack_u32_pairs(words))


def _lex_less(a_keys, b_keys, or_equal: bool) -> torch.Tensor:
    """Elementwise lexicographic ``a < b`` (or ``a <= b``)."""
    res = torch.full(a_keys[0].shape, or_equal, dtype=torch.bool,
                     device=a_keys[0].device)
    for a, b in zip(reversed(list(a_keys)), reversed(list(b_keys))):
        res = torch.where(a == b, res, a < b)
    return res


def _check_arity(sorted_keys, query_keys) -> None:
    if len(sorted_keys) != len(query_keys):
        raise ValueError(
            f"composite key arity mismatch: {len(sorted_keys)} sorted vs "
            f"{len(query_keys)} query arrays (string key columns must be "
            "width-aligned first — see align_string_key_columns)")


def _bisect(sorted_keys, query_keys, lower: bool) -> torch.Tensor:
    n = sorted_keys[0].shape[0]
    m = query_keys[0].shape[0]
    dev = query_keys[0].device
    lo = torch.zeros((m,), dtype=torch.int64, device=dev)
    if n == 0:
        return lo
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    for _ in range(n.bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        midc = mid.clamp(max=n - 1)
        adv = _lex_less([k[midc] for k in sorted_keys], query_keys,
                        or_equal=not lower)
        lo = torch.where(active & adv, mid + 1, lo)
        hi = torch.where(active & ~adv, mid, hi)
    return lo


def lower_bound(sorted_keys, query_keys) -> torch.Tensor:
    """First index whose composite key is >= the query's (u32 words of
    both sides; ``sorted_keys`` in lexicographic order)."""
    _check_arity(sorted_keys, query_keys)
    return _bisect(pack_u32_pairs(sorted_keys), pack_u32_pairs(query_keys),
                   lower=True)


def upper_bound(sorted_keys, query_keys) -> torch.Tensor:
    """First index whose composite key is > the query's."""
    _check_arity(sorted_keys, query_keys)
    return _bisect(pack_u32_pairs(sorted_keys), pack_u32_pairs(query_keys),
                   lower=False)


def equal_range(sorted_keys, query_keys):
    """``(lower_bound, upper_bound)`` of every query row: a vectorized
    bisection over the word pairs, ``bit_length(n) + 1`` rounds each."""
    _check_arity(sorted_keys, query_keys)
    sk, qk = pack_u32_pairs(sorted_keys), pack_u32_pairs(query_keys)
    return _bisect(sk, qk, lower=True), _bisect(sk, qk, lower=False)


def string_key_width(c):
    """The char width of a column that lowers to string words (a string
    column or a dictionary of strings), else None."""
    if isinstance(c, StringColumn):
        return c.max_len
    if isinstance(c, DictionaryColumn) and isinstance(c.dictionary,
                                                      StringColumn):
        return c.dictionary.max_len
    return None


def align_string_key_columns(lcols: Sequence, rcols: Sequence):
    """Pad paired string key columns (a dictionary of strings pads its
    dictionary) to a common char width, so both sides of a join lower to
    the same number of words."""
    def pad_chars(c, width):
        if c.max_len == width:
            return c
        chars = torch.cat([c.chars, torch.zeros(
            (c.num_rows, width - c.max_len), dtype=c.chars.dtype,
            device=c.chars.device)], 1)
        return dataclasses.replace(c, chars=chars)

    def pad_to(c, width):
        if isinstance(c, DictionaryColumn):
            return dataclasses.replace(
                c, dictionary=pad_chars(c.dictionary, width))
        return pad_chars(c, width)

    lout, rout = [], []
    for lc, rc in zip(lcols, rcols):
        lw, rw = string_key_width(lc), string_key_width(rc)
        if (lw is None) != (rw is None):
            raise TypeError(f"join key type mismatch: {lc.dtype!r} vs "
                            f"{rc.dtype!r}")
        if lw is not None and lw != rw:
            width = max(lw, rw)
            lc, rc = pad_to(lc, width), pad_to(rc, width)
        lout.append(lc)
        rout.append(rc)
    return lout, rout
