"""Spark-exact row hashes: Murmur3_32 and XXHash64.

Counterpart of ``spark_rapids_jni_tpu/ops/hashing.py``:

* the row hash folds over columns, each column's hash seeding the next;
  a null element returns its seed unchanged;
* Murmur3_32 is Spark's variant: bool, int8, int16, int32 and date
  values widen to one 4-byte block, int64, timestamp and double values
  are two little-endian 4-byte blocks, float a 4-byte block; floats
  canonicalize NaN but keep ``-0.0`` (Java ``doubleToLongBits``);
  strings hash their 4-byte little-endian blocks, then each tail byte
  sign-extended through a full mix round (:func:`murmur3_bytes`);
* XXHash64 is standard XXH64 over the same widened values, but floats
  normalize both NaN and ``-0.0`` (:func:`xxhash64`);
* decimals of precision up to 18 hash their unscaled value as 8 bytes;
  wider ones hash the minimal big-endian two's-complement bytes of the
  unscaled value (Java ``BigInteger.toByteArray``) as a string;
* a struct hashes as its leaves in order (a null struct nulls them); a
  list folds its elements into the running hash, each element's hash
  seeding the next, nulls skipped (Murmur3 only, as in the reference);
* an encoded column hashes its decoded values (one gather), so a
  dictionary key partitions as its plain column does.

Murmur3 lanes are u32 in the int64 carrier (:mod:`.._u32`).  XXHash64
lanes are int64 holding the 64-bit pattern: adds, multiplies and left
shifts wrap mod 2^64 as the u64 arithmetic does, and right shifts mask
off the sign bits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .._u32 import M32, mul32, rotl32, to_i32
from ..columnar import types as T
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               ListColumn, StringColumn, StructColumn)
from ..columnar.encoded import is_encoded, materialize_column

DEFAULT_XXHASH64_SEED = 42

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_C3 = 0xE6546B64
_F32_QNAN = 0x7FC00000
_F64_QNAN = 0x7FF8000000000000


# ---------------------------------------------------------------------------
# Murmur3_32
# ---------------------------------------------------------------------------

def _mix(h: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """One full Murmur3 round: mix block ``k1`` into ``h``."""
    k1 = mul32(k1, _C1)
    k1 = rotl32(k1, 15)
    k1 = mul32(k1, _C2)
    h = rotl32(h ^ k1, 13)
    return (mul32(h, 5) + _C3) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_u32(vals: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash 4-byte values (u32 lanes) with per-row seeds."""
    return _fmix32(_mix(seed, vals) ^ 4)


def murmur3_u64(vals: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash 8-byte values (int64 bit patterns) as two little-endian blocks."""
    h = _mix(seed, vals & M32)
    h = _mix(h, (vals >> 32) & M32)
    return _fmix32(h ^ 8)


def _byte_at(chars: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``chars[i, pos[i]]`` as int64, 0 where ``pos`` is out of range."""
    L = chars.shape[1]
    c = torch.gather(chars, 1, pos.clamp(0, L - 1)[:, None])[:, 0]
    return torch.where((pos >= 0) & (pos < L), c.to(torch.int64),
                       torch.zeros_like(pos))


def _le_words(chars: torch.Tensor, width: int) -> torch.Tensor:
    """Little-endian ``width``-byte words of the padded chars (int64 bit
    patterns), zero-padding the last; shape ``[n, ceil(L / width)]``."""
    n, L = chars.shape
    nw = -(-L // width)
    if nw * width != L:
        chars = torch.cat([chars, torch.zeros(
            (n, nw * width - L), dtype=chars.dtype, device=chars.device)], 1)
    b = chars.to(torch.int64).reshape(n, nw, width)
    out = b[:, :, 0]
    for j in range(1, width):
        out = out | (b[:, :, j] << (8 * j))
    return out


def murmur3_bytes(chars: torch.Tensor, lengths: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """Hash per-row byte strings (``chars uint8[n, L]`` padded,
    ``lengths``) with per-row seeds: 4-byte little-endian blocks, then
    Spark's per-byte sign-extended tail, then the length."""
    L = chars.shape[1]
    lengths = lengths.to(torch.int64)
    nblocks = lengths // 4
    h = seed
    if L >= 4:
        words = _le_words(chars[:, :L // 4 * 4], 4)
        for j in range(L // 4):
            h = torch.where(j < nblocks, _mix(h, words[:, j]), h)
    tail = nblocks * 4
    for t in range(min(3, L)):
        pos = tail + t
        b = _byte_at(chars, pos)
        k1 = torch.where(b >= 128, b + 0xFFFFFF00, b)  # Java byte -> int
        h = torch.where(pos < lengths, _mix(h, k1), h)
    return _fmix32(h ^ (lengths & M32))


# ---------------------------------------------------------------------------
# XXHash64 (int64 lanes holding u64 bit patterns)
# ---------------------------------------------------------------------------

def _s64(u: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of a u64 bit pattern."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _xxh_finalize(h):
    h = h ^ _shr(h, 33)
    h = h * _P2
    h = h ^ _shr(h, 29)
    h = h * _P3
    return h ^ _shr(h, 32)


def _xxh_round(acc, k):
    return _rotl64(acc + k * _P2, 31) * _P1


def _xxh_merge_round(h, v):
    return (h ^ _xxh_round(torch.zeros_like(v), v)) * _P1 + _P4


def _xxh_mix8(h, k):
    return _rotl64(h ^ _xxh_round(torch.zeros_like(k), k), 27) * _P1 + _P4


def _xxh_mix4(h, k_u32):
    return _rotl64(h ^ (k_u32 * _P1), 23) * _P2 + _P3


def _xxh_mix1(h, byte):
    return _rotl64(h ^ (byte * _P5), 11) * _P1


def xxhash64_u32(vals: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash each value widened to a 4-byte block (u32 lanes)."""
    return _xxh_finalize(_xxh_mix4(seed + _P5 + 4, vals))


def xxhash64_u64(vals: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash each 8-byte value (int64 bit patterns)."""
    return _xxh_finalize(_xxh_mix8(seed + _P5 + 8, vals))


def xxhash64_bytes(chars: torch.Tensor, lengths: torch.Tensor,
                   seed: torch.Tensor) -> torch.Tensor:
    """Hash per-row byte strings (``chars uint8[n, L]`` padded,
    ``lengths``): 32-byte stripes, then 8-byte, 4-byte and 1-byte tails."""
    n, L = chars.shape
    lengths = lengths.to(torch.int64)
    nstripes = lengths // 32
    v1 = seed + _s64((_P1 + _P2) & ((1 << 64) - 1))
    v2 = seed + _P2
    v3 = seed
    v4 = seed - _P1
    if L >= 32:
        w8 = _le_words(chars[:, :L // 32 * 32], 8)
        for s in range(L // 32):
            m = s < nstripes
            v1 = torch.where(m, _xxh_round(v1, w8[:, 4 * s]), v1)
            v2 = torch.where(m, _xxh_round(v2, w8[:, 4 * s + 1]), v2)
            v3 = torch.where(m, _xxh_round(v3, w8[:, 4 * s + 2]), v3)
            v4 = torch.where(m, _xxh_round(v4, w8[:, 4 * s + 3]), v4)
    h_long = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
              + _rotl64(v4, 18))
    for v in (v1, v2, v3, v4):
        h_long = _xxh_merge_round(h_long, v)
    h = torch.where(lengths >= 32, h_long, seed + _P5) + lengths

    def gather_le(off, width):
        out = torch.zeros_like(off)
        for b in range(width):
            out = out | (_byte_at(chars, off + b) << (8 * b))
        return out

    rem = nstripes * 32
    n8 = (lengths % 32) // 8
    if L >= 8:
        for j in range(min(3, L // 8)):
            h = torch.where(j < n8, _xxh_mix8(h, gather_le(rem + 8 * j, 8)),
                            h)
    off4 = rem + 8 * n8
    has4 = (lengths % 8) >= 4
    if L >= 4:
        h = torch.where(has4, _xxh_mix4(h, gather_le(off4, 4)), h)
    offb = off4 + torch.where(has4, 4, 0)
    for t in range(min(3, L)):
        pos = offb + t
        h = torch.where(pos < lengths, _xxh_mix1(h, _byte_at(chars, pos)), h)
    return _xxh_finalize(h)


# ---------------------------------------------------------------------------
# value widening and the row folds
# ---------------------------------------------------------------------------

def _widen(col: Column, normalize_zeros: bool):
    """``('u32' | 'u64', lanes)``: the value as its hashed block(s)."""
    kind = col.dtype.kind
    d = col.data
    if kind in (T.Kind.BOOLEAN, T.Kind.INT8, T.Kind.INT16, T.Kind.INT32,
                T.Kind.DATE):
        return "u32", d.to(torch.int64) & M32
    if kind in (T.Kind.INT64, T.Kind.TIMESTAMP):
        return "u64", d.to(torch.int64)
    if kind in T.FLOAT_KINDS:
        if normalize_zeros:
            d = torch.where(d == 0.0, torch.zeros_like(d), d)
        if kind is T.Kind.FLOAT32:
            bits = d.contiguous().view(torch.int32).to(torch.int64) & M32
            qnan = _F32_QNAN
        else:
            bits = d.contiguous().view(torch.int64)
            qnan = _F64_QNAN
        bits = torch.where(torch.isnan(d), torch.full_like(bits, qnan), bits)
        return ("u32" if kind is T.Kind.FLOAT32 else "u64"), bits
    raise NotImplementedError(f"hash of {col.dtype!r}")


def decimal128_java_bytes(col: Decimal128Column):
    """Minimal big-endian two's-complement bytes of each unscaled value
    (``BigInteger.toByteArray``): ``(bytes uint8[n, 16]`` left-justified,
    ``lengths int32[n])``."""
    limbs = col.limbs
    n = limbs.shape[0]
    dev = limbs.device
    k = torch.arange(16, device=dev)
    le = (limbs[:, k // 8] >> (8 * (k % 8))) & 0xFF          # [n, 16]
    negative = limbs[:, 1] < 0
    sign_byte = torch.where(negative, 0xFF, 0)
    eq = le.flip(1) == sign_byte[:, None]
    lead = torch.cumprod(eq.to(torch.int64), 1).sum(1)
    length = (16 - lead).clamp(min=1)
    top_byte = torch.gather(le, 1, (length - 1)[:, None])[:, 0]
    need_pad = (length < 16) & (negative ^ (top_byte >= 0x80))
    length = length + need_pad.to(torch.int64)
    j = k[None, :]
    src = (length[:, None] - 1 - j).clamp(0, 15)
    be = torch.where(j < length[:, None], torch.gather(le, 1, src), 0)
    return be.to(torch.uint8), length.to(torch.int32)


def _element_murmur3(col, seed):
    if isinstance(col, StringColumn):
        return murmur3_bytes(col.chars, col.lengths, seed)
    if isinstance(col, Decimal128Column):
        if col.dtype.decimal_storage_bits < 128:
            return murmur3_u64(col.limbs[:, 0], seed)
        return murmur3_bytes(*decimal128_java_bytes(col), seed)
    width, vals = _widen(col, normalize_zeros=False)
    return murmur3_u32(vals, seed) if width == "u32" else \
        murmur3_u64(vals, seed)


def _element_xxhash64(col, seed):
    if isinstance(col, StringColumn):
        return xxhash64_bytes(col.chars, col.lengths, seed)
    if isinstance(col, Decimal128Column):
        if col.dtype.decimal_storage_bits < 128:
            return xxhash64_u64(col.limbs[:, 0], seed)
        return xxhash64_bytes(*decimal128_java_bytes(col), seed)
    width, vals = _widen(col, normalize_zeros=True)
    return xxhash64_u32(vals, seed) if width == "u32" else \
        xxhash64_u64(vals, seed)


def _columns(columns) -> list:
    """The hashed columns in order: structs expand into their fields (a
    null struct row nulls its fields, so the fold skips them), as the
    reference's JNI layer decomposes them."""
    cols = list(columns.columns if isinstance(columns, ColumnBatch)
                else columns)
    if not cols:
        raise ValueError("hashing requires at least 1 column of input")
    out = []

    def expand(c, parent_valid=None):
        if is_encoded(c):
            # hash VALUES, not codes: the fold carries each row's hash
            # through every column, so a per-entry hash does not
            # separate; one gather materializes the column here
            c = materialize_column(c)
        if isinstance(c, StructColumn):
            v = c.validity if parent_valid is None else \
                c.validity & parent_valid
            for child in c.children:
                expand(child, v)
            return
        if not isinstance(c, (Column, StringColumn, Decimal128Column,
                              ListColumn)):
            raise TypeError(f"hash of {type(c).__name__}")
        if parent_valid is not None:
            c = dataclasses.replace(c, validity=c.validity & parent_valid)
        out.append(c)

    for c in cols:
        expand(c)
    n = out[0].num_rows
    for c in out:
        if c.num_rows != n:
            raise ValueError(f"row count mismatch: {c.num_rows} vs {n}; "
                             "all columns must be the same size")
    return out


def _drill_list(col: ListColumn):
    """The leaf column and each row's ``[start, end)`` leaf range: LIST
    levels compose their offsets, a one-field STRUCT level passes to its
    field (the reference kernel's drill, murmur_hash.cu:122-131)."""
    start = col.offsets[:-1].to(torch.int64)
    end = col.offsets[1:].to(torch.int64)
    cur = col.child
    while isinstance(cur, (ListColumn, StructColumn)):
        if isinstance(cur, StructColumn):
            if len(cur.children) != 1:
                raise NotImplementedError(
                    "hash of a multi-field STRUCT inside a LIST (the "
                    "reference kernel assumes decomposed single-child "
                    "structs, murmur_hash.cu:128)")
            cur = cur.children[0]
        else:
            offs = cur.offsets.to(torch.int64)
            start = offs[start.clamp(0, cur.num_rows)]
            end = offs[end.clamp(0, cur.num_rows)]
            cur = cur.child
    return cur, start, end


def _list_fold(col: ListColumn, h, element_fn):
    """``h = hash(element, seed=h)`` over each row's elements in order,
    null elements passing the seed through; as many steps as the longest
    row (one host read)."""
    from ..relational.gather import gather_column

    leaf, start, end = _drill_list(col)
    if leaf.num_rows == 0:
        return h
    steps = int((end - start).max().clamp(min=0).item()) if \
        start.numel() else 0
    for k in range(steps):
        idx = start + k
        g = gather_column(leaf, idx.clamp(0, leaf.num_rows - 1))
        h = torch.where((idx < end) & g.validity, element_fn(g, h), h)
    return h


def murmur_hash3_32(columns: Sequence, seed: int = 42) -> Column:
    """Spark Murmur3_32 row hash across columns -> an int32 column."""
    cols = _columns(columns)
    n = cols[0].num_rows
    dev = cols[0].device
    h = torch.full((n,), seed & M32, dtype=torch.int64, device=dev)
    for c in cols:
        e = (_list_fold(c, h, _element_murmur3) if isinstance(c, ListColumn)
             else _element_murmur3(c, h))
        h = torch.where(c.validity, e, h)
    return Column(to_i32(h), torch.ones((n,), dtype=torch.bool, device=dev),
                  T.INT32)


def xxhash64(columns: Sequence, seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark XXHash64 row hash across columns -> an int64 column."""
    cols = _columns(columns)
    n = cols[0].num_rows
    dev = cols[0].device
    h = torch.full((n,), _s64(seed & ((1 << 64) - 1)), dtype=torch.int64,
                   device=dev)
    for c in cols:
        if isinstance(c, ListColumn):
            raise NotImplementedError(
                "xxhash64 over LIST columns (unsupported in the reference)")
        h = torch.where(c.validity, _element_xxhash64(c, h), h)
    return Column(h, torch.ones((n,), dtype=torch.bool, device=dev),
                  T.INT64)
