"""Spark ``BloomFilterImpl``-bit-compatible bloom filter.

Counterpart of ``spark_rapids_jni_tpu/ops/bloom_filter.py``.  Reference:
``bloom_filter.cu``.  The serialized form is Spark's: a big-endian header
{version=1, num_hashes, num_longs} followed by the bit array as
big-endian longs — interchangeable with Spark CPU (``bloom_filter.cu:
46-60`` derives a word/byte swizzle so its little-endian device words
dump to that exact byte stream).

The filter lives as ``bool[num_longs * 64]`` on the device — one lane
per bit, indexed in the reference's swizzled order, so "set" is a plain
index write of True (idempotent, so duplicate positions need no atomics)
and "probe" is a gather.  Packing to the serialized bytes happens only at
host boundaries.

Hashing (``gpu_bloom_filter_put``, bloom_filter.cu:63-87): h1 =
murmur3(long, seed=0), h2 = murmur3(long, seed=h1); bit k of probe i uses
``combined = h1 + i*h2`` (int32 wrap), flipped if negative, mod num_bits.
The murmur3 is :func:`.hashing.murmur3_u64` (u32 lanes in int64
carriers, the long's bit pattern as int64).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Sequence

import numpy as np
import torch

from .._u32 import M32
from ..columnar import types as T
from ..columnar.column import Column
from ..device import resolve_device
from .hashing import murmur3_u64

SPARK_BLOOM_FILTER_VERSION = 1


@dataclasses.dataclass
class BloomFilter:
    """num_longs*64 bits in serialized-buffer bit order (see module doc)."""

    bits: torch.Tensor  # bool[num_longs * 64]
    num_hashes: int
    num_longs: int


def bloom_filter_create(num_hashes: int, num_longs: int,
                        device=None) -> BloomFilter:
    """Empty filter (reference bloom_filter_create, bloom_filter.cu:225);
    ``device=None`` means the GPU."""
    if num_hashes <= 0 or num_longs <= 0:
        raise ValueError("num_hashes and num_longs must be positive")
    return BloomFilter(torch.zeros((num_longs * 64,), dtype=torch.bool,
                                   device=resolve_device(device)),
                       num_hashes, num_longs)


def _probe_positions(col: Column, num_hashes: int, num_longs: int):
    """Swizzled bit positions [n, num_hashes]; invalid rows out-of-range."""
    if col.dtype.kind is not T.Kind.INT64:
        raise TypeError("bloom filter input must be INT64")
    nbits = num_longs * 64
    el = col.data.to(torch.int64)
    h1 = murmur3_u64(el, torch.zeros_like(el))
    h2 = murmur3_u64(el, h1)
    pos = []
    for i in range(1, num_hashes + 1):
        combined = (h1 + i * h2) & M32  # int32 wraparound semantics
        neg = (combined >> 31) != 0
        iv = torch.where(neg, combined ^ M32, combined)
        index = iv % (nbits & M32)
        word = (index >> 5) ^ 1  # 64-bit-long word swizzle
        bit = (index & 31) ^ 0x18  # byte swizzle
        pos.append((word << 5) | bit)
    out = torch.stack(pos, dim=1)
    return torch.where(col.validity[:, None], out,
                       torch.full_like(out, nbits))


def bloom_filter_put(bf: BloomFilter, col: Column) -> BloomFilter:
    """Insert non-null longs (reference gpu_bloom_filter_put); functional —
    returns the updated filter."""
    nbits = bf.num_longs * 64
    pos = _probe_positions(col, bf.num_hashes, bf.num_longs).reshape(-1)
    # one spare lane takes the null rows' out-of-range positions
    bits = torch.cat([bf.bits, torch.zeros((1,), dtype=torch.bool,
                                           device=bf.bits.device)])
    bits[pos.clamp(0, nbits)] = True
    return BloomFilter(bits[:nbits], bf.num_hashes, bf.num_longs)


def bloom_filter_build(num_hashes: int, num_longs: int,
                       col: Column) -> BloomFilter:
    return bloom_filter_put(
        bloom_filter_create(num_hashes, num_longs, col.data.device), col)


def bloom_filter_merge(filters: Sequence[BloomFilter]) -> BloomFilter:
    """Bitwise OR (reference bloom_filter_merge, bloom_filter.cu:277)."""
    filters = list(filters)
    if not filters:
        raise ValueError("bloom_filter_merge requires at least one filter")
    first = filters[0]
    for f in filters[1:]:
        if (f.num_hashes, f.num_longs) != (first.num_hashes, first.num_longs):
            raise ValueError("mismatched bloom filter parameters")
    bits = first.bits
    for f in filters[1:]:
        bits = bits | f.bits
    return BloomFilter(bits, first.num_hashes, first.num_longs)


def bloom_filter_probe(bf: BloomFilter, col: Column) -> Column:
    """Membership test per row (reference bloom_filter_probe,
    bloom_filter.cu:339); null rows stay null."""
    pos = _probe_positions(col, bf.num_hashes, bf.num_longs)
    hit = bf.bits[pos.clamp(0, bf.num_longs * 64 - 1)]
    return Column(hit.all(dim=1), col.validity, T.BOOLEAN)


# ---------------------------------------------------------------------------
# host (de)serialization — Spark interchange format
# ---------------------------------------------------------------------------


def bloom_filter_serialize(bf: BloomFilter) -> bytes:
    """Header + bit array, byte-compatible with Spark's BloomFilterImpl."""
    header = struct.pack(">iii", SPARK_BLOOM_FILTER_VERSION, bf.num_hashes,
                         bf.num_longs)
    # position p = word*32 + bit; device words are little-endian uint32s
    # dumped in order, so byte b of the payload holds bits 8*(b%4)..+7 of
    # word b//4, LSB-first: pack on the device, copy the bytes once
    by = bf.bits.reshape(bf.num_longs * 8, 8).to(torch.int32)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32,
                           device=by.device)
    payload = (by * weights[None, :]).sum(dim=1).to(torch.uint8)
    return header + payload.cpu().numpy().tobytes()


def bloom_filter_deserialize(buf: bytes, device=None) -> BloomFilter:
    """A filter from Spark's serialized bytes, on ``device`` (None means
    the GPU)."""
    if len(buf) < 12:
        raise ValueError("bloom filter buffer too short for header")
    version, num_hashes, num_longs = struct.unpack(">iii", buf[:12])
    if version != SPARK_BLOOM_FILTER_VERSION:
        raise ValueError(f"unsupported bloom filter version {version}")
    if num_hashes <= 0 or num_longs <= 0:
        raise ValueError(
            f"corrupt bloom filter header: num_hashes={num_hashes} "
            f"num_longs={num_longs}")
    if len(buf) < 12 + num_longs * 8:
        raise ValueError(
            f"bloom filter buffer truncated: header claims {num_longs} longs")
    payload = np.frombuffer(buf[12: 12 + num_longs * 8], dtype=np.uint8)
    bits = (payload[:, None] >> np.arange(8)[None, :]) & 1
    return BloomFilter(
        torch.from_numpy(bits.reshape(-1).astype(np.bool_)).to(
            resolve_device(device)), num_hashes, num_longs)
