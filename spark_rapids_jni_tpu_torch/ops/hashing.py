"""Spark-exact Murmur3_32 row hash over int32, date and int64 columns.

Counterpart of the part of ``spark_rapids_jni_tpu/ops/hashing.py`` that
``spark_partition_id`` needs (Spark's ``Murmur3Hash(keys, 42)``):

* the row hash folds over columns, each column's hash seeding the next;
  a null element returns its seed unchanged;
* int32/date values are one 4-byte block, int64 values two little-endian
  4-byte blocks.

All lanes are u32 in the int64 carrier (:mod:`.._u32`).  Other column
types and xxhash64 are ROADMAP.md queue 1, item 10 and later.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .._roadmap import not_ported
from .._u32 import M32, mul32, rotl32, to_i32
from ..columnar import types as T
from ..columnar.column import Column

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_C3 = 0xE6546B64


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


def murmur_hash3_32(columns: Sequence[Column], seed: int = 42) -> Column:
    """Spark Murmur3_32 row hash across columns -> an int32 column."""
    cols = list(columns)
    if not cols:
        raise ValueError("hashing requires at least 1 column of input")
    n = cols[0].num_rows
    dev = cols[0].data.device
    h = torch.full((n,), seed & M32, dtype=torch.int64, device=dev)
    for c in cols:
        if c.num_rows != n:
            raise ValueError(f"row count mismatch: {c.num_rows} vs {n}")
        kind = c.dtype.kind
        if kind in (T.Kind.INT32, T.Kind.DATE):
            e = murmur3_u32(c.data.to(torch.int64) & M32, h)
        elif kind is T.Kind.INT64:
            e = murmur3_u64(c.data.to(torch.int64), h)
        else:
            raise not_ported(f"murmur3 of {c.dtype!r}", 10)
        h = torch.where(c.validity, e, h)
    return Column(to_i32(h), torch.ones((n,), dtype=torch.bool, device=dev),
                  T.INT32)
