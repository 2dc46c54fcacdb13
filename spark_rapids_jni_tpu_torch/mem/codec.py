"""Framed block codecs for spilled/stored leaves (host-side, numpy only).

The spill tiers and the durable shuffle store move raw ``np.save`` bytes;
"GPU Acceleration of SQL Analytics on Compressed Data" (PAPERS.md) argues
the bytes crossing every tier boundary should stay compressed.  This
module is the host half of that story: a self-describing frame around two
numpy-implemented codecs, picked per leaf with a guaranteed-lossless raw
fallback.

* ``pack``  — frame-of-reference bit-packing for integer/bool leaves:
  subtract the leaf minimum, store residuals at ``ceil(log2(range+1))``
  bits in u32 lanes.  The lane math mirrors the device-side
  ``columnar.encoded.pack_bits`` exactly, so a leaf packed here and a
  column packed in-trace round-trip through the same bit layout.
* ``block`` — lz4-style framing of a byte-level RLE over independent
  64 KiB blocks: each block compresses (or stores raw) on its own, so a
  long incompressible stretch cannot poison the whole leaf.

Every frame starts with a magic + header describing dtype/shape/codec;
``decode_block`` validates all of it and raises :class:`CodecError` on
any inconsistency — a flipped bit in a pack header is a LOUD decode
failure, never a silently wrong array.  CRC policy stays with the
callers (spill keeps a dual CRC: stored payload bytes AND decoded leaf).

A copy of the JAX package's ``mem/codec.py``: frames are byte-identical
in both directions, so a leaf one package writes the other reads.  Host
numpy only; nothing here touches a device.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"SRCK"
VERSION = 1

CODEC_RAW = 0
CODEC_PACK = 1
CODEC_BLOCK = 2

_CODEC_IDS = {"raw": CODEC_RAW, "pack": CODEC_PACK, "block": CODEC_BLOCK}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}

_BLOCK_BYTES = 64 * 1024
_MAX_RUN = 0xFFFF


class CodecError(ValueError):
    """A frame failed to decode (bad magic/header/body) — loud, never a
    silent wrong array."""


# ---- bit-pack lane math (numpy mirror of columnar.encoded.pack_bits) -------

def np_pack_bits(words: np.ndarray, width: int) -> np.ndarray:
    """uint32[n] residuals -> uint32[ceil(n*width/32)] packed lanes.

    Word ``i`` occupies bits ``[i*width, (i+1)*width)`` of the lane
    stream (little-endian within each u32 lane) — the same layout as the
    device-side ``pack_bits``.
    """
    width = int(width)
    if not 1 <= width <= 32:
        raise ValueError(f"pack width must be in [1, 32], got {width}")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n = words.shape[0]
    if width == 32:
        return words.copy()
    nlanes = max(1, (n * width + 31) // 32)
    if n == 0:
        return np.zeros((nlanes,), np.uint32)
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    lane = (pos >> np.uint64(5)).astype(np.int64)
    off = pos & np.uint64(31)
    # accumulate into a 64-bit window per lane: each word's bits land in
    # [off, off+width) < 64, contributions are disjoint, so add == OR
    acc = np.zeros((nlanes,), np.uint64)
    np.add.at(acc, lane, words.astype(np.uint64) << off)
    out = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[1:] |= (acc[:-1] >> np.uint64(32)).astype(np.uint32)
    return out


def np_unpack_bits(lanes: np.ndarray, width: int, n: int) -> np.ndarray:
    """Inverse of :func:`np_pack_bits`: lanes -> uint32[n] residuals."""
    width = int(width)
    if not 1 <= width <= 32:
        raise ValueError(f"pack width must be in [1, 32], got {width}")
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    if width == 32:
        return lanes[:n].copy()
    if n == 0:
        return np.zeros((0,), np.uint32)
    need = (n * width + 31) // 32
    if lanes.shape[0] < need:
        raise CodecError(
            f"packed stream too short: {lanes.shape[0]} lanes < {need} "
            f"needed for {n} x {width}-bit words")
    acc = lanes.astype(np.uint64)
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    lane = (pos >> np.uint64(5)).astype(np.int64)
    off = pos & np.uint64(31)
    lo = acc[lane] >> off
    spill = off + np.uint64(width) > np.uint64(32)
    nxt = np.minimum(lane + 1, lanes.shape[0] - 1)
    hi = np.where(spill, acc[nxt] << (np.uint64(32) - off), np.uint64(0))
    mask = np.uint64((1 << width) - 1)
    return ((lo | hi) & mask).astype(np.uint32)


# ---- frame header -----------------------------------------------------------

# MAGIC | u8 version | u8 codec | u8 len(dtype.str) | dtype.str | u8 ndim
# | u64 shape[ndim] | u64 orig_nbytes | body
def _frame(codec_id: int, arr: np.ndarray, body: bytes) -> np.ndarray:
    dt = arr.dtype.str.encode("ascii")
    head = (MAGIC + struct.pack("<BBB", VERSION, codec_id, len(dt)) + dt
            + struct.pack("<B", arr.ndim)
            + struct.pack(f"<{arr.ndim}Q", *arr.shape)
            + struct.pack("<Q", arr.nbytes))
    return np.frombuffer(head + body, dtype=np.uint8).copy()


def _parse_frame(payload: np.ndarray):
    buf = np.ascontiguousarray(payload, dtype=np.uint8).tobytes()
    try:
        if buf[:4] != MAGIC:
            raise CodecError(f"bad codec magic {buf[:4]!r}")
        version, codec_id, dlen = struct.unpack_from("<BBB", buf, 4)
        if version != VERSION:
            raise CodecError(f"unknown codec frame version {version}")
        if codec_id not in _CODEC_NAMES:
            raise CodecError(f"unknown codec id {codec_id}")
        o = 7
        dt = np.dtype(buf[o:o + dlen].decode("ascii"))
        o += dlen
        (ndim,) = struct.unpack_from("<B", buf, o)
        o += 1
        if ndim > 8:
            raise CodecError(f"implausible ndim {ndim}")
        shape = struct.unpack_from(f"<{ndim}Q", buf, o)
        o += 8 * ndim
        (orig_nbytes,) = struct.unpack_from("<Q", buf, o)
        o += 8
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        if count * dt.itemsize != orig_nbytes:
            raise CodecError(
                f"frame header inconsistent: shape {shape} x {dt} != "
                f"{orig_nbytes} bytes")
        return codec_id, dt, tuple(int(s) for s in shape), orig_nbytes, buf[o:]
    except (struct.error, UnicodeDecodeError, TypeError) as exc:
        raise CodecError(f"corrupt codec frame header: {exc}") from exc


# ---- pack codec (frame-of-reference bit-pack) -------------------------------

_PACK_DTYPES = (np.int8, np.int16, np.int32, np.int64,
                np.uint8, np.uint16, np.uint32, np.bool_)


def _pack_body(arr: np.ndarray):
    """FoR bit-pack body, or None when the leaf is not pack-eligible."""
    if arr.dtype.type not in _PACK_DTYPES or arr.size == 0:
        return None
    flat = arr.ravel()
    vals = flat.astype(np.int64)
    ref = int(vals.min())
    rng = int(vals.max()) - ref
    if rng >= 1 << 32:
        return None
    width = max(1, rng.bit_length())
    lanes = np_pack_bits((vals - ref).astype(np.uint64).astype(np.uint32),
                         width)
    return struct.pack("<qB", ref, width) + lanes.tobytes()


def _unpack_body(body: bytes, dt: np.dtype, shape, orig_nbytes: int):
    if len(body) < 9:
        raise CodecError("pack body truncated before its header")
    ref, width = struct.unpack_from("<qB", body, 0)
    if not 1 <= width <= 32:
        raise CodecError(f"corrupt pack header: width {width}")
    n = orig_nbytes // dt.itemsize
    lanes_bytes = body[9:]
    if len(lanes_bytes) % 4:
        raise CodecError("pack lane stream not u32-aligned")
    lanes = np.frombuffer(lanes_bytes, dtype=np.uint32)
    if lanes.shape[0] != max(1, (n * width + 31) // 32) and n > 0:
        raise CodecError(
            f"pack lane count {lanes.shape[0]} disagrees with header "
            f"({n} x {width}-bit words)")
    res = np_unpack_bits(lanes, width, n).astype(np.int64)
    vals = res + ref
    if dt.type is np.bool_:
        out = vals.astype(np.bool_)
    else:
        out = vals.astype(dt)
        if not np.array_equal(out.astype(np.int64), vals):
            raise CodecError("corrupt pack header: reference out of range")
    return out.reshape(shape)


# ---- block codec (byte-RLE over independent 64 KiB blocks) ------------------

def _rle_encode_block(block: np.ndarray):
    """One block -> (values u8[r], lengths u16[r]) or None when RLE loses."""
    n = block.shape[0]
    change = np.flatnonzero(block[1:] != block[:-1]) + 1
    starts = np.concatenate([[0], change])
    lengths = np.diff(np.append(starts, n))
    values = block[starts]
    # split runs longer than the u16 length field
    k = (lengths + (_MAX_RUN - 1)) // _MAX_RUN
    if int(k.sum()) * 3 + 4 >= n:
        return None
    values = np.repeat(values, k)
    lens = np.full(int(k.sum()), _MAX_RUN, np.uint16)
    ends = np.cumsum(k) - 1
    lens[ends] = (lengths - (k - 1) * _MAX_RUN).astype(np.uint16)
    return values, lens


def _block_body(arr: np.ndarray):
    raw = np.frombuffer(arr.tobytes(), dtype=np.uint8)
    parts = [struct.pack("<Q", raw.shape[0])]
    for start in range(0, raw.shape[0], _BLOCK_BYTES):
        block = raw[start:start + _BLOCK_BYTES]
        enc = _rle_encode_block(block)
        if enc is None:
            parts.append(struct.pack("<BI", 0, block.shape[0]))
            parts.append(block.tobytes())
        else:
            values, lens = enc
            parts.append(struct.pack("<BI", 1, values.shape[0]))
            parts.append(values.tobytes())
            parts.append(lens.tobytes())
    return b"".join(parts)


def _unblock_body(body: bytes, dt: np.dtype, shape, orig_nbytes: int):
    if len(body) < 8:
        raise CodecError("block body truncated before its length")
    (total,) = struct.unpack_from("<Q", body, 0)
    if total != orig_nbytes:
        raise CodecError(
            f"block stream claims {total} bytes, frame says {orig_nbytes}")
    o = 8
    out = np.empty((total,), np.uint8)
    filled = 0
    while filled < total:
        if o + 5 > len(body):
            raise CodecError("block stream truncated mid-header")
        flag, count = struct.unpack_from("<BI", body, o)
        o += 5
        if flag == 0:
            if o + count > len(body) or filled + count > total:
                raise CodecError("raw block overruns the stream")
            out[filled:filled + count] = np.frombuffer(
                body, np.uint8, count, o)
            o += count
            filled += count
        elif flag == 1:
            if o + 3 * count > len(body):
                raise CodecError("rle block overruns the stream")
            values = np.frombuffer(body, np.uint8, count, o)
            lens = np.frombuffer(body, np.uint16, count, o + count)
            o += 3 * count
            span = int(lens.sum())
            if filled + span > total:
                raise CodecError("rle block decodes past the leaf size")
            out[filled:filled + span] = np.repeat(values, lens)
            filled += span
        else:
            raise CodecError(f"unknown block flag {flag}")
    if filled != total or o != len(body):
        raise CodecError("block stream did not decode to the leaf size")
    return np.frombuffer(out.tobytes(), dtype=dt).reshape(shape)


# ---- public API -------------------------------------------------------------

def encode_block(arr: np.ndarray, codec: str) -> np.ndarray:
    """Encode one host leaf under ``codec`` ('pack' | 'block' | 'raw').

    Returns a self-describing uint8 frame.  Falls back to a raw frame
    whenever the requested codec does not apply (float leaf under
    'pack', wide value range) or would not shrink the payload — callers
    get a uniform read path and a guaranteed-lossless store.
    """
    arr = np.ascontiguousarray(arr)
    if codec not in _CODEC_IDS:
        raise ValueError(f"spill codec must be raw/pack/block, got {codec!r}")
    body = None
    codec_id = CODEC_RAW
    if codec == "pack":
        body = _pack_body(arr)
        codec_id = CODEC_PACK
    elif codec == "block":
        body = _block_body(arr)
        codec_id = CODEC_BLOCK
    if body is None or len(body) >= max(arr.nbytes, 1):
        body = arr.tobytes()
        codec_id = CODEC_RAW
    return _frame(codec_id, arr, body)


def decode_block(payload: np.ndarray) -> np.ndarray:
    """Decode a frame back to the original array, bit-exactly.

    Raises :class:`CodecError` on any header/body inconsistency."""
    codec_id, dt, shape, orig_nbytes, body = _parse_frame(payload)
    if codec_id == CODEC_RAW:
        if len(body) != orig_nbytes:
            raise CodecError(
                f"raw body is {len(body)} bytes, frame says {orig_nbytes}")
        return np.frombuffer(body, dtype=dt).reshape(shape)
    if codec_id == CODEC_PACK:
        return _unpack_body(body, dt, shape, orig_nbytes)
    return _unblock_body(body, dt, shape, orig_nbytes)


def codec_name(payload: np.ndarray) -> str:
    """Which codec a frame actually used (after fallbacks) — raw frames
    under a 'pack' request report 'raw'."""
    return _CODEC_NAMES[_parse_frame(payload)[0]]
