"""Encoded columns: dictionary codes, run-length runs, bit-packed and
frame-of-reference lanes.

Counterpart of ``spark_rapids_jni_tpu/columnar/encoded.py``.  Filters,
joins and group-bys run on the encoded form and materialize late:

* :class:`DictionaryColumn` holds ``codes int32[n]`` into a small
  ``dictionary`` column of ``d`` entries.  The dictionary is
  **bit-distinct** (entries unique over raw bytes, so ``-0.0``/``0.0``
  and NaN payloads stay apart and :meth:`~DictionaryColumn.decode` is
  exact); ``canon int32[d]`` ranks each entry's equality class in key
  word order, so the one word ``canon[codes]`` keys a group-by or a
  join like the full key words, within one dictionary.  ``dict_token``
  names the dictionary: equal tokens mean comparable codes, and
  ``dataclasses.replace(col, codes=...)`` keeps it.
* :class:`RunLengthColumn` holds ``run_values`` and ``run_lengths
  int32[r]`` with a row-level validity.
* :class:`BitPackedColumn` packs ``width``-bit residuals against one
  ``reference`` minimum into 32-bit lanes (:func:`pack_bits`).
* :class:`FrameOfReferenceColumn` subtracts a per-block minimum
  (``refs int64[nblocks]``) before packing.

The reference's uint32 buffers keep their bits here: codes and canon
are int32 (a dictionary has fewer than 2^31 entries), and a lane is an
int32 holding the lane's 32 bits (arithmetic on them runs in int64,
masked to 32 bits: :mod:`.._u32`).  So a reference column carries across
bit for bit (:func:`~.column.batch_from_numpy`), and an exchange moves
the same bytes.

:meth:`decode` and the ``materialize_*`` helpers are the only places an
encoded column becomes a plain one; :func:`packed_decode_count` counts
the packed pair's decodes.  Encoding is a host step (numpy).
"""

from __future__ import annotations

import dataclasses
import itertools
import operator
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from .._u32 import M32, to_i32
from . import types as T
from .bucketed import plan_widths
from .column import Column, ColumnBatch, Decimal128Column, StringColumn

# equal tokens <=> the same dictionary
_TOKENS = itertools.count(1)

# the packed pair's decode() count: the packed-predicate path must not
# materialize, and its tests read this
_PACKED_DECODES = [0]


def packed_decode_count() -> int:
    """How many times a packed column materialized through ``decode()``."""
    return _PACKED_DECODES[0]


def reset_packed_decode_count() -> None:
    _PACKED_DECODES[0] = 0


class ZoneMapCorruptionError(OSError):
    """A zone-map sidecar no longer describes its column (CRC mismatch)."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _bitview_rows(col) -> np.ndarray:
    """uint8[n, k] raw-byte rows of a column's values (host side):
    uniqueness over them is uniqueness over bit patterns."""
    if isinstance(col, StringColumn):
        chars = np.ascontiguousarray(_host(col.chars), dtype=np.uint8)
        lens = np.ascontiguousarray(_host(col.lengths).astype(np.int32))
        return np.hstack([chars, lens.view(np.uint8).reshape(len(lens), 4)])
    if isinstance(col, Decimal128Column):
        limbs = np.ascontiguousarray(_host(col.limbs))
        return limbs.view(np.uint8).reshape(limbs.shape[0], 16)
    data = np.ascontiguousarray(_host(col.data))
    n = data.shape[0]
    return data.view(np.uint8).reshape(n, -1) if n else np.zeros(
        (0, max(data.dtype.itemsize, 1)), np.uint8)


def _unique_rows(rows: np.ndarray):
    """``np.unique(rows, axis=0, return_index=True, return_inverse=True)``
    (lexicographic byte order, first occurrences), fast for rows of 1,
    2, 4 or 8 bytes: read big-endian, each row is one unsigned integer
    whose numeric order is the rows' byte order."""
    n, k = rows.shape
    if k in (1, 2, 4, 8) and n:
        key = np.ascontiguousarray(rows).view(f">u{k}").reshape(n)
        _, uidx, inv = np.unique(key, return_index=True, return_inverse=True)
        return uidx, inv.reshape(n)
    _, uidx, inv = np.unique(rows, axis=0, return_index=True,
                             return_inverse=True)
    return uidx, inv.reshape(n)


def _build_canon(dictionary) -> torch.Tensor:
    """int32[d]: each entry's equality-class rank in key word order
    (first word most significant, ``np.unique(axis=0)``'s order)."""
    from ..relational import keys as K

    dev = dictionary.device
    if dictionary.num_rows == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    words = K.column_radix_keys(dictionary, equality=True)
    mat = np.stack([_host(w).astype(np.uint32) for w in words], axis=1)
    _, inv = np.unique(mat, axis=0, return_inverse=True)
    return torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(dev)


def _plain_pylist(col) -> list:
    if isinstance(col, (StringColumn, Decimal128Column)):
        return col.to_pylist()
    vals = _host(col.data).tolist()
    ok = _host(col.validity).tolist()
    return [v if k else None for v, k in zip(vals, ok)]


@dataclasses.dataclass
class DictionaryColumn:
    """``codes int32[n]`` into ``dictionary`` (a plain column of ``d``
    all-valid, bit-distinct entries); ``canon int32[d]`` ranks each
    entry's equality class.  ``canon`` and ``dictionary`` are ``None``
    while detached for an exchange."""

    codes: torch.Tensor
    validity: torch.Tensor
    canon: Optional[torch.Tensor]
    dictionary: object
    dtype: T.SparkType
    dict_token: int = 0

    @property
    def num_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def num_entries(self) -> int:
        return self.dictionary.num_rows

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def decode(self):
        """The plain column (a late-materialization point)."""
        d = self.dictionary
        idx = self.codes.to(torch.int64)
        v = self.validity
        if isinstance(d, StringColumn):
            return StringColumn(d.chars[idx], d.lengths[idx] * v, v, d.dtype)
        if isinstance(d, Decimal128Column):
            return Decimal128Column(
                torch.stack([d.limbs[:, 0][idx], d.limbs[:, 1][idx]], 1), v,
                self.dtype)
        return Column(d.data[idx], v, self.dtype)

    def to_pylist(self) -> list:
        vals = _plain_pylist(self.dictionary)
        codes = _host(self.codes).tolist()
        valid = _host(self.validity).tolist()
        return [vals[c] if ok else None for c, ok in zip(codes, valid)]

    def __repr__(self):
        d = self.dictionary.num_rows if self.dictionary is not None else "?"
        return (f"DictionaryColumn({self.dtype!r}, n={self.num_rows}, d={d}, "
                f"token={self.dict_token})")


@dataclasses.dataclass
class RunLengthColumn:
    """``run_values[r]`` + ``run_lengths int32[r]`` (summing to ``n``);
    validity stays a row-level ``bool[n]``."""

    run_values: torch.Tensor
    run_lengths: torch.Tensor
    validity: torch.Tensor
    dtype: T.SparkType

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def num_runs(self) -> int:
        return self.run_values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def row_to_run(self) -> torch.Tensor:
        """int64[n]: the run of each row."""
        n = self.num_rows
        dev = self.device
        if self.num_runs == 0:
            return torch.zeros((n,), dtype=torch.int64, device=dev)
        ends = torch.cumsum(self.run_lengths.to(torch.int64), 0)
        row = torch.arange(n, dtype=torch.int64, device=dev)
        run = torch.searchsorted(ends, row, right=True)
        return run.clamp(0, self.num_runs - 1)

    def decode(self) -> Column:
        """The plain column (a late-materialization point)."""
        if self.num_runs == 0:
            data = torch.zeros((self.num_rows,), dtype=self.dtype.torch_dtype,
                               device=self.device)
            return Column(data, self.validity, self.dtype)
        return Column(self.run_values[self.row_to_run()], self.validity,
                      self.dtype)

    def to_pylist(self) -> list:
        return _plain_pylist(self.decode())

    def __repr__(self):
        return (f"RunLengthColumn({self.dtype!r}, n={self.num_rows}, "
                f"runs={self.num_runs})")


# ---- bit-pack lane math ------------------------------------------------

def _pack_mask(width: int) -> int:
    return (1 << width) - 1 if width < 32 else M32


def _check_width(width: int) -> int:
    width = int(width)
    if not 1 <= width <= 32:
        raise ValueError(f"pack width must be in [1, 32], got {width}")
    return width


def _pack_rows(words: torch.Tensor, width: int) -> torch.Tensor:
    """``[R, n]`` residual words (int64 carriers) -> ``[R, nlanes]`` int32
    lanes, one packed stream a row."""
    R, n = words.shape
    dev = words.device
    if width == 32:
        return to_i32(words.to(torch.int64) & M32)
    nl = max(1, (n * width + 31) // 32)
    out = torch.zeros((R * nl,), dtype=torch.int64, device=dev)
    if n == 0 or R == 0:
        return to_i32(out).reshape(R, nl)
    pos = torch.arange(n, dtype=torch.int64, device=dev) * width
    lane = pos >> 5
    off = pos & 31
    w = words.to(torch.int64) & _pack_mask(width)
    base = torch.arange(R, dtype=torch.int64, device=dev)[:, None] * nl
    # contributions to one lane cover disjoint bits: adds compose as ORs;
    # a word that straddles puts its high part into the next lane
    out.index_add_(0, (base + lane).reshape(-1),
                   ((w << off) & M32).reshape(-1))
    straddle = off + width > 32
    if bool(straddle.any()):
        hi = torch.where(straddle, w >> torch.where(straddle, 32 - off, 31),
                         torch.zeros_like(w))
        nxt = (lane + 1).clamp(max=nl - 1)
        out.index_add_(0, (base + nxt).reshape(-1), hi.reshape(-1))
    return to_i32(out).reshape(R, nl)


def _unpack_rows(lanes: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_rows`: ``[R, nlanes]`` -> ``[R, n]`` int64
    residual words."""
    R, nl = lanes.shape
    dev = lanes.device
    l64 = lanes.to(torch.int64) & M32
    if width == 32:
        return l64[:, :n]
    if n == 0:
        return torch.zeros((R, 0), dtype=torch.int64, device=dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev) * width
    lane = pos >> 5
    off = pos & 31
    lo = l64[:, lane] >> off
    straddle = off + width > 32
    hi_shift = torch.where(straddle, 32 - off, torch.full_like(off, 31))
    nxt = l64[:, (lane + 1).clamp(max=nl - 1)]
    hi = torch.where(straddle, (nxt << hi_shift) & M32,
                     torch.zeros_like(lo))
    return (lo | hi) & _pack_mask(width)


def pack_bits(words: torch.Tensor, width: int) -> torch.Tensor:
    """Residual words (values in ``[0, 2^32)``) -> int32 lanes holding
    ``ceil(n * width / 32)`` u32 lanes: word ``i`` occupies bits ``[i *
    width, (i + 1) * width)`` little-endian, the reference's layout lane
    for lane."""
    width = _check_width(width)
    return _pack_rows(words.reshape(1, -1), width)[0]


def unpack_bits(lanes: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: lanes -> int64[n] residual words."""
    width = _check_width(width)
    return _unpack_rows(lanes.reshape(1, -1), width, int(n))[0]


def pack_bits_rows(words: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row pack of a ``[P, n]`` buffer (one packed stream per
    partition row, so an all-to-all still splits axis 0)."""
    return _pack_rows(words, _check_width(width))


def unpack_bits_rows(lanes: torch.Tensor, width: int, n: int
                     ) -> torch.Tensor:
    """Inverse of :func:`pack_bits_rows` for ``[P, nlanes]`` buffers."""
    return _unpack_rows(lanes, _check_width(width), int(n))


# the widths the wire packer rounds up to: a few buckets, at most 3 bits
# given up against the tightest width
_PACK_WIDTH_BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)


def choose_pack_width(lo: int, hi: int) -> Optional[int]:
    """Bucketed lane width for values observed in ``[lo, hi]`` (after
    subtracting ``lo``), or None past 32 bits.  The shuffle's wire packer
    and the adaptive planner share it."""
    rng = int(hi) - int(lo)
    if rng < 0 or rng >= 1 << 32:
        return None
    w = max(1, rng.bit_length())
    for b in _PACK_WIDTH_BUCKETS:
        if w <= b:
            return b
    return None


# ---- zone maps (host-side sidecar) ----------------------------------------

# zone block of the global-reference encoding (frame-of-reference zones
# reuse the column's own blocks)
_ZONE_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class ZoneMap:
    """Per-block min/max of a packed column's DECODED values, CRC32'd.

    A host sidecar: a gather or an exchange drops it.  Stats cover every
    row (``decode()`` ignores validity), so a skip is exactly as
    conservative as the decode-then-compare mask.  :meth:`verify`
    recomputes the stamp and raises :class:`ZoneMapCorruptionError` on a
    mismatch.  ``column`` names the source column when known; it is in
    the stamp, and a skip refuses a sidecar of another column.
    """

    mins: np.ndarray   # int64 [nblocks]
    maxs: np.ndarray   # int64 [nblocks]
    block: int
    rows: int
    crc: int
    column: Optional[str] = None

    @staticmethod
    def _stamp(mins, maxs, block: int, rows: int,
               column: Optional[str] = None) -> int:
        h = zlib.crc32(np.ascontiguousarray(mins, np.int64).tobytes())
        h = zlib.crc32(np.ascontiguousarray(maxs, np.int64).tobytes(), h)
        h = zlib.crc32(np.array([block, rows], np.int64).tobytes(), h)
        return zlib.crc32((column or "").encode("utf-8"), h)

    @classmethod
    def build(cls, values: np.ndarray, block: int,
              column: Optional[str] = None) -> "ZoneMap":
        """Stats over ``values`` (int64[n] decoded, no padding)."""
        block = max(int(block), 1)
        values = np.ascontiguousarray(values, np.int64)
        n = values.shape[0]
        if n:
            starts = np.arange(0, n, block)
            mins = np.minimum.reduceat(values, starts)
            maxs = np.maximum.reduceat(values, starts)
        else:
            mins = np.zeros((0,), np.int64)
            maxs = np.zeros((0,), np.int64)
        return cls(mins, maxs, block, n,
                   cls._stamp(mins, maxs, block, n, column), column)

    @property
    def num_blocks(self) -> int:
        return self.mins.shape[0]

    def verify(self) -> None:
        """The CRC check: raises :class:`ZoneMapCorruptionError`."""
        if self._stamp(self.mins, self.maxs, self.block, self.rows,
                       self.column) != self.crc:
            raise ZoneMapCorruptionError(
                f"zone map CRC mismatch over {self.num_blocks} blocks "
                f"({self.rows} rows, block={self.block}): the sidecar "
                f"no longer describes its column — refusing to skip")

    def block_may_match(self, op: str, value) -> np.ndarray:
        """bool[nblocks]: may any row of the block satisfy ``row <op>
        value``?  False blocks are provably cold."""
        v = int(value)
        info = np.iinfo(np.int64)
        if v > info.max:
            return np.full((self.num_blocks,), op in ("<", "<=", "!="), bool)
        if v < info.min:
            return np.full((self.num_blocks,), op in (">", ">=", "!="), bool)
        v = np.int64(v)
        m, M = self.mins, self.maxs
        if op == "<":
            return m < v
        if op == "<=":
            return m <= v
        if op == ">":
            return M > v
        if op == ">=":
            return M >= v
        if op == "==":
            return (m <= v) & (M >= v)
        if op == "!=":
            return ~((m == v) & (M == v))
        raise ValueError(f"unsupported zone-map op {op!r}")


@dataclasses.dataclass
class BitPackedColumn:
    """``width``-bit residuals against one ``reference`` minimum in int32
    lanes (u32 bits).  Null rows pack a zero residual; ``zone`` is the
    host sidecar (dropped by a gather)."""

    lanes: torch.Tensor
    validity: torch.Tensor
    reference: int
    width: int
    dtype: T.SparkType
    zone: Optional[ZoneMap] = None

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def residuals(self) -> torch.Tensor:
        """int64[n] packed residuals (value = reference + residual)."""
        return unpack_bits(self.lanes, self.width, self.num_rows)

    def decode(self) -> Column:
        """The plain column (a late-materialization point)."""
        _PACKED_DECODES[0] += 1
        vals = self.residuals() + int(self.reference)
        return Column(vals.to(self.dtype.torch_dtype), self.validity,
                      self.dtype)

    def to_pylist(self) -> list:
        return _plain_pylist(self.decode())

    def __repr__(self):
        return (f"BitPackedColumn({self.dtype!r}, n={self.num_rows}, "
                f"width={self.width}, ref={self.reference})")


@dataclasses.dataclass
class FrameOfReferenceColumn:
    """Per-block minima ``refs int64[nblocks]`` subtracted, residuals
    packed at one ``width``; ``zone`` as in :class:`BitPackedColumn`."""

    refs: torch.Tensor
    lanes: torch.Tensor
    validity: torch.Tensor
    width: int
    block: int
    dtype: T.SparkType
    zone: Optional[ZoneMap] = None

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.refs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def residuals(self) -> torch.Tensor:
        return unpack_bits(self.lanes, self.width, self.num_rows)

    def _row_blocks(self) -> torch.Tensor:
        return torch.arange(self.num_rows, dtype=torch.int64,
                            device=self.device) // max(self.block, 1)

    def values64(self) -> torch.Tensor:
        """int64[n] decoded values (reference + residual arithmetic, the
        key lowering's entry point)."""
        return self.refs[self._row_blocks()] + self.residuals()

    def decode(self) -> Column:
        """The plain column (a late-materialization point)."""
        _PACKED_DECODES[0] += 1
        return Column(self.values64().to(self.dtype.torch_dtype),
                      self.validity, self.dtype)

    def to_pylist(self) -> list:
        return _plain_pylist(self.decode())

    def __repr__(self):
        return (f"FrameOfReferenceColumn({self.dtype!r}, n={self.num_rows}, "
                f"width={self.width}, block={self.block}, "
                f"blocks={self.num_blocks})")


ENCODED_COLUMNS = (DictionaryColumn, RunLengthColumn, BitPackedColumn,
                   FrameOfReferenceColumn)

# the packed pair
PACKED_COLUMNS = (BitPackedColumn, FrameOfReferenceColumn)


def is_encoded(col) -> bool:
    return isinstance(col, ENCODED_COLUMNS)


# ---- encode (host boundary) ------------------------------------------------

def _i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)


def _dictionary_rows(col):
    """``(entry source rows, code per row)`` of a plain column: null rows
    borrow the first valid row's entry, so the dictionary covers live
    values only."""
    rows = _bitview_rows(col)
    valid = _host(col.validity).astype(bool)
    n = rows.shape[0]
    src = np.arange(n)
    if n and not valid.all():
        src[~valid] = int(valid.argmax()) if valid.any() else 0
        rows = rows[src]
    uidx, inv = _unique_rows(rows)
    return src[uidx], inv


def _dictionary_column(col, entries, inv, ladder=None) -> DictionaryColumn:
    dictionary = _take_dictionary(col, entries, ladder)
    return DictionaryColumn(_i32(inv, col.device), col.validity,
                            _build_canon(dictionary), dictionary, col.dtype,
                            next(_TOKENS))


def encode_column(col, ladder=None) -> DictionaryColumn:
    """Dictionary-encode one column (host step).  Null rows borrow the
    first valid row's entry, so the dictionary covers live values only;
    a string dictionary takes its width from :func:`~.bucketed.plan_widths`."""
    if is_encoded(col):
        return col if isinstance(col, DictionaryColumn) else \
            encode_column(col.decode(), ladder)
    return _dictionary_column(col, *_dictionary_rows(col), ladder)


def _take_dictionary(col, uidx: np.ndarray, ladder=None):
    """The all-valid dictionary column of rows ``uidx``."""
    d = uidx.shape[0]
    dev = col.device
    ones = torch.ones((d,), dtype=torch.bool, device=dev)
    if isinstance(col, StringColumn):
        chars = _host(col.chars)
        sel = _host(col.lengths)[uidx]
        w = (plan_widths(sel.tolist(), ladder) if ladder
             else plan_widths(sel.tolist()))[-1]
        sub = np.zeros((d, w), np.uint8)
        take = min(w, chars.shape[1])
        sub[:, :take] = chars[uidx, :take]
        return StringColumn(torch.from_numpy(sub).to(dev),
                            _i32(sel, dev), ones)
    if isinstance(col, Decimal128Column):
        return Decimal128Column(
            torch.from_numpy(np.ascontiguousarray(_host(col.limbs)[uidx]))
            .to(dev), ones, col.dtype)
    return Column(
        torch.from_numpy(np.ascontiguousarray(_host(col.data)[uidx])).to(dev),
        ones, col.dtype)


def dictionary_from_arrays(codes, validity, dictionary,
                           dtype=None) -> DictionaryColumn:
    """Wrap pre-split buffers (codes, row validity, a dictionary column)
    as a column: computes ``canon`` and mints a fresh token."""
    dev = dictionary.device
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(
            np.ascontiguousarray(np.asarray(codes).astype(np.int64)))
    codes = codes.reshape(-1).to(device=dev, dtype=torch.int32)
    return DictionaryColumn(codes, validity.to(dev),
                            _build_canon(dictionary), dictionary,
                            dtype or dictionary.dtype, next(_TOKENS))


def encode_rle(col) -> RunLengthColumn:
    """Run-length-encode a fixed-width column (host step); runs split on
    raw-byte inequality, so ``decode()`` is exact."""
    if isinstance(col, RunLengthColumn):
        return col
    if is_encoded(col):
        col = col.decode()
    if not isinstance(col, Column):
        raise TypeError(f"RLE supports fixed-width columns, not {col!r}")
    dev = col.device
    rows = _bitview_rows(col)
    n = rows.shape[0]
    if n == 0:
        return RunLengthColumn(
            torch.zeros((0,), dtype=col.dtype.torch_dtype, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), col.validity,
            col.dtype)
    change = np.any(rows[1:] != rows[:-1], axis=1)
    starts = np.flatnonzero(np.concatenate([[True], change]))
    lengths = np.diff(np.append(starts, n))
    data = _host(col.data)
    return RunLengthColumn(
        torch.from_numpy(np.ascontiguousarray(data[starts])).to(dev),
        _i32(lengths, dev), col.validity, col.dtype)


_PACKABLE_KINDS = (T.Kind.INT8, T.Kind.INT16, T.Kind.INT32, T.Kind.INT64,
                   T.Kind.DATE, T.Kind.TIMESTAMP)


def _pack_stats(col):
    """``(data int64, valid, ref, range)`` over VALID rows (host)."""
    data = _host(col.data).astype(np.int64)
    valid = _host(col.validity).astype(bool)
    if valid.any():
        ref = int(data[valid].min())
        rng = int(data[valid].max()) - ref
    else:
        ref, rng = 0, 0
    return data, valid, ref, rng


def _i64(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int64, order="C")).to(dev)


def encode_bitpacked(col, column: Optional[str] = None):
    """Bit-pack an int column (host step) against the minimum over valid
    rows; null rows pack a zero residual.  A range past 32 bits returns
    the column unchanged.  ``column`` tags the zone sidecar."""
    if isinstance(col, BitPackedColumn):
        return col
    if is_encoded(col):
        col = col.decode()
    if not isinstance(col, Column) or col.dtype.kind not in _PACKABLE_KINDS:
        return col
    data, valid, ref, rng = _pack_stats(col)
    if rng >= 1 << 32:
        return col
    width = max(1, rng.bit_length())
    res = np.where(valid, data - ref, 0).astype(np.uint64).astype(np.int64)
    zone = None
    if bool(config.get("zone_maps")):
        # stats over the decoded value of EVERY row (decode() ignores
        # validity), so a skip is as conservative as the raw compare
        zone = ZoneMap.build(ref + res, _ZONE_BLOCK, column)
    return BitPackedColumn(pack_bits(_i64(res, col.device), width),
                           col.validity, ref, width, col.dtype, zone=zone)


def encode_for(col, block: int = 1024, column: Optional[str] = None):
    """Frame-of-reference encode an int column (host step): per-``block``
    minima over valid rows (dead blocks reference 0), one global residual
    width.  A block range past 32 bits returns the column unchanged."""
    if isinstance(col, FrameOfReferenceColumn):
        return col
    if is_encoded(col):
        col = col.decode()
    if not isinstance(col, Column) or col.dtype.kind not in _PACKABLE_KINDS:
        return col
    block = max(int(block), 1)
    data, valid, _, _ = _pack_stats(col)
    n = data.shape[0]
    nblocks = max(1, -(-n // block))
    pad = nblocks * block - n
    d2 = np.pad(data, (0, pad)).reshape(nblocks, block)
    v2 = np.pad(valid, (0, pad)).reshape(nblocks, block)
    big = np.where(v2, d2, np.iinfo(np.int64).max)
    refs = np.where(v2.any(axis=1), big.min(axis=1), 0)
    res2 = np.where(v2, d2 - refs[:, None], 0)
    rng = int(res2.max()) if n else 0
    if rng >= 1 << 32:
        return col
    width = max(1, rng.bit_length())
    res = res2.reshape(-1)[:n]
    zone = None
    if bool(config.get("zone_maps")):
        # decoded values of the real rows only: padding never counts
        zone = ZoneMap.build((refs[:, None] + res2).reshape(-1)[:n], block,
                             column)
    dev = col.device
    return FrameOfReferenceColumn(_i64(refs, dev),
                                  pack_bits(_i64(res, dev), width),
                                  col.validity, width, block, col.dtype,
                                  zone=zone)


def gather_bitpacked(col: BitPackedColumn, idx: torch.Tensor, valid=None):
    """A row gather that STAYS packed (extract, take, repack): the global
    reference survives any permutation; the zone sidecar does not."""
    v = col.validity[idx]
    if valid is not None:
        v = v & valid
    return dataclasses.replace(col, lanes=pack_bits(col.residuals()[idx],
                                                    col.width),
                               validity=v, zone=None)


def encode_batch(batch: ColumnBatch,
                 dictionary: Optional[Sequence[str]] = None,
                 rle: Sequence[str] = (), max_card_frac: float = 0.5,
                 bitpack: Sequence[str] = (),
                 frame_of_reference: Sequence[str] = ()) -> ColumnBatch:
    """Encode a batch's columns (host step).  ``dictionary=None``
    dictionary-encodes every string column and each fixed-width column
    whose distinct values are at most ``max_card_frac`` of its rows;
    ``rle``, ``bitpack`` and ``frame_of_reference`` name columns for the
    other encodings."""
    out = {}
    for name, col in zip(batch.names, batch.columns):
        if name in rle:
            out[name] = encode_rle(col)
        elif name in bitpack:
            out[name] = encode_bitpacked(col, column=name)
        elif name in frame_of_reference:
            out[name] = encode_for(col, column=name)
        elif dictionary is not None:
            out[name] = encode_column(col) if name in dictionary else col
        elif isinstance(col, StringColumn):
            out[name] = encode_column(col)
        elif isinstance(col, Column) and col.num_rows:
            # count the entries before building the dictionary and canon
            entries, inv = _dictionary_rows(col)
            keep = len(entries) <= max(1, int(col.num_rows * max_card_frac))
            out[name] = (_dictionary_column(col, entries, inv) if keep
                         else col)
        else:
            out[name] = col
    return ColumnBatch(out)


# ---- materialize (late) ----------------------------------------------------

def materialize_column(col):
    """Decode an encoded column; any other column as it is."""
    return col.decode() if is_encoded(col) else col


def materialize_batch(batch: ColumnBatch) -> ColumnBatch:
    return ColumnBatch({n: materialize_column(c)
                        for n, c in zip(batch.names, batch.columns)})


decode_batch = materialize_batch


# ---- encoded-domain operators ----------------------------------------------

def predicate_mask(col: DictionaryColumn, pred) -> torch.Tensor:
    """bool[n] filter mask: ``pred`` evaluated over the ``d`` dictionary
    entries once, then mapped to rows with one gather."""
    hits = pred(col.dictionary)
    if not isinstance(hits, torch.Tensor) and hasattr(hits, "data"):
        hits = hits.data
    return hits.to(torch.bool)[col.codes.to(torch.int64)] & col.validity


_PACKED_FILTER_OPS = {
    "<": operator.lt, "<=": operator.le, ">": operator.gt,
    ">=": operator.ge, "==": operator.eq, "!=": operator.ne,
}
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _const_mask(n: int, hit: bool, dev) -> torch.Tensor:
    return torch.full((n,), bool(hit), dtype=torch.bool, device=dev)


def _bitpacked_filter_mask(col: BitPackedColumn, op: str, value
                           ) -> torch.Tensor:
    """Residuals against the literal less the reference: an
    out-of-domain literal folds to a constant mask."""
    n = col.num_rows
    t = int(value) - int(col.reference)
    if t < 0:
        return _const_mask(n, op in (">", ">=", "!="), col.device)
    if t > (1 << col.width) - 1:
        return _const_mask(n, op in ("<", "<=", "!="), col.device)
    return _PACKED_FILTER_OPS[op](col.residuals(), t)


def _for_filter_mask(col: FrameOfReferenceColumn, op: str, value
                     ) -> torch.Tensor:
    """Per-block literal transform: a block whose reference puts the
    literal below 0 or above the width's top resolves to a constant,
    the rest compare residuals with ``value - ref``.  Every difference
    is formed within int64 (the literal is clamped to the block's
    domain first), so no lane wraps at the ends of the int64 range."""
    hi = (1 << col.width) - 1
    v = int(value)
    refs = col.refs.to(torch.int64)
    below = refs > v                    # value - ref < 0
    vh = v - hi
    above = (refs < vh) if vh >= _I64_MIN else torch.zeros_like(below)
    in_lo = max(vh, _I64_MIN)
    t = v - refs.clamp(min=in_lo, max=v)  # in [0, hi] on every block
    blk = col._row_blocks()
    r = col.residuals()
    tb, lo_b, hi_b = t[blk], below[blk], above[blk]
    base = _PACKED_FILTER_OPS[op](r, tb)
    if op == "==":
        return base & ~(lo_b | hi_b)
    if op == "!=":
        return base | lo_b | hi_b
    if op in ("<", "<="):
        return torch.where(lo_b, False, hi_b | base)
    return torch.where(lo_b, True, ~hi_b & base)


def packed_filter_mask(col, op: str, value) -> torch.Tensor:
    """bool[n] mask of ``col <op> value`` in the packed domain, equal to
    ``op(col.decode().data, value)`` (null rows included: they decode to
    the frame reference) without decoding.  Decodes then compares when
    the ``packed_predicates`` knob is off or the literal is not an int
    in the int64 range."""
    if op not in _PACKED_FILTER_OPS:
        raise ValueError(f"unsupported packed filter op {op!r}")
    if not isinstance(col, PACKED_COLUMNS):
        raise TypeError(f"packed_filter_mask needs a packed column, "
                        f"got {col!r}")
    pushable = (bool(config.get("packed_predicates"))
                and isinstance(value, (int, np.integer))
                and not isinstance(value, bool)
                and _I64_MIN <= int(value) <= _I64_MAX)
    if not pushable:
        return _PACKED_FILTER_OPS[op](col.decode().data, value)
    if isinstance(col, BitPackedColumn):
        return _bitpacked_filter_mask(col, op, value)
    return _for_filter_mask(col, op, value)


def canon_key_column(col: DictionaryColumn) -> Column:
    """The one-word key ``canon[codes]`` as an int32 column: equal and
    ordered as the column's full key words, against keys of the SAME
    dictionary only (callers check tokens)."""
    return Column(col.canon[col.codes.to(torch.int64)], col.validity,
                  T.INT32)


def align_encoded_key_columns(lcols, rcols):
    """Join keys: where both sides are dictionary columns of one
    dictionary (equal tokens), each takes its canon word; every other
    pair passes through to the value-word lowering, which is correct
    across dictionaries."""
    lout, rout = [], []
    for lc, rc in zip(lcols, rcols):
        if (isinstance(lc, DictionaryColumn)
                and isinstance(rc, DictionaryColumn)
                and lc.dict_token == rc.dict_token and lc.dict_token > 0):
            lout.append(canon_key_column(lc))
            rout.append(canon_key_column(rc))
        else:
            lout.append(lc)
            rout.append(rc)
    return lout, rout


def reconcile_dictionaries(a: DictionaryColumn, b: DictionaryColumn):
    """Re-encode two columns over ONE merged dictionary (host step, never
    touching row data beyond a code remap), so joins between them take
    the canon path."""
    da, db = a.dictionary, b.dictionary
    if type(da) is not type(db):
        raise TypeError(f"dictionary type mismatch: {da!r} vs {db!r}")
    if isinstance(da, StringColumn):
        w = max(da.max_len, db.max_len)

        def widen(c):
            if c.max_len == w:
                return c
            pad = torch.zeros((c.num_rows, w - c.max_len), dtype=torch.uint8,
                              device=c.device)
            return StringColumn(torch.cat([c.chars, pad], 1), c.lengths,
                                c.validity, c.dtype)

        da, db = widen(da), widen(db)
        merged = StringColumn(torch.cat([da.chars, db.chars]),
                              torch.cat([da.lengths, db.lengths]),
                              torch.cat([da.validity, db.validity]))
    elif isinstance(da, Decimal128Column):
        merged = Decimal128Column(torch.cat([da.limbs, db.limbs]),
                                  torch.cat([da.validity, db.validity]),
                                  da.dtype)
    else:
        merged = Column(torch.cat([da.data, db.data]),
                        torch.cat([da.validity, db.validity]), da.dtype)
    uidx, inv = _unique_rows(_bitview_rows(merged))
    dictionary = _take_dictionary(merged, uidx)
    canon = _build_canon(dictionary)
    token = next(_TOKENS)
    remap = _i32(inv, merged.device)
    na = a.dictionary.num_rows

    def rewrap(col, r):
        return DictionaryColumn(r[col.codes.to(torch.int64)], col.validity,
                                canon, dictionary, col.dtype, token)

    return rewrap(a, remap[:na]), rewrap(b, remap[na:])


# ---- exchange detach/reattach ----------------------------------------------

def detach_dictionaries(batch: ColumnBatch):
    """Strip each dictionary and canon so an exchange moves CODES only.
    Returns ``(stripped, dicts)``, ``dicts`` mapping a column name to
    ``(canon, dictionary, dtype, token)``."""
    dicts, cols = {}, {}
    for name, col in zip(batch.names, batch.columns):
        if isinstance(col, DictionaryColumn) and col.dictionary is not None:
            dicts[name] = (col.canon, col.dictionary, col.dtype,
                           col.dict_token)
            cols[name] = dataclasses.replace(col, canon=None, dictionary=None)
        else:
            cols[name] = col
    return ColumnBatch(cols), dicts


def reattach_dictionaries(batch: ColumnBatch, dicts) -> ColumnBatch:
    """Rebind the detached dictionaries onto an exchange's output."""
    if not dicts:
        return batch
    cols = {}
    for name, col in zip(batch.names, batch.columns):
        if name in dicts and isinstance(col, DictionaryColumn):
            canon, dictionary, dtype, token = dicts[name]
            cols[name] = DictionaryColumn(col.codes, col.validity, canon,
                                          dictionary, dtype, token)
        else:
            cols[name] = col
    return ColumnBatch(cols)


# ---- knob ------------------------------------------------------------------

# what 'auto' means on the GPU, set from the q6str / q6str_enc pair that
# chip_smoke.py times on the H100 (PERF.md §6: 44.2 ms encoded against
# 60.2 plain, NVIDIA H100 80GB HBM3 at 700 W)
AUTO_ON_CUDA = True


def resolve_encoded_execution(device=None) -> bool:
    """Resolve the ``encoded_execution`` knob (auto/on/off) for a device
    (``None``: the GPU, the port's default).  ``auto`` is on for the CPU
    (as in the reference) and :data:`AUTO_ON_CUDA` on the GPU."""
    mode = config.get("encoded_execution")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"encoded_execution must be auto/on/off, got "
                         f"{mode!r}")
    if mode == "auto":
        dev = torch.device("cuda" if device is None else device)
        return dev.type == "cpu" or AUTO_ON_CUDA
    return mode == "on"


# ---- host form (batch_from_numpy / batch_to_numpy) -------------------------

# a carried column's token -> the port's token for it: equal tokens in
# host forms give equal port tokens, so columns of one dictionary keep
# the canon path after crossing
_CARRIED_TOKENS: dict = {}


def _carried_token(token) -> int:
    token = int(token or 0)
    if token == 0:
        return 0
    if token not in _CARRIED_TOKENS:
        _CARRIED_TOKENS[token] = next(_TOKENS)
    return _CARRIED_TOKENS[token]


def _u32_as_i32(a, dev) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.itemsize != 4:
        a = a.astype(np.int64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(dev)


def _zone_from_host(z) -> Optional[ZoneMap]:
    if z is None:
        return None
    return ZoneMap(np.array(z["mins"], np.int64), np.array(z["maxs"],
                                                           np.int64),
                   int(z["block"]), int(z["rows"]), int(z["crc"]),
                   z.get("column"))


def _zone_to_host(z: Optional[ZoneMap]):
    if z is None:
        return None
    return {"mins": z.mins, "maxs": z.maxs, "block": z.block,
            "rows": z.rows, "crc": z.crc, "column": z.column}


def encoded_from_host(name, data: dict, validity: torch.Tensor,
                      st: T.SparkType, dev, plain_from_host):
    """An encoded column from its host form (``data['encoding']`` one of
    ``dictionary``, ``rle``, ``bitpacked``, ``for``); ``plain_from_host``
    builds a dictionary's own column."""
    kind = data.get("encoding")
    if kind == "dictionary":
        codes = _u32_as_i32(data["codes"], dev)
        if codes.shape != validity.shape:
            raise ValueError(f"column {name!r}: codes {tuple(codes.shape)} "
                             f"beside validity {tuple(validity.shape)}")
        d = data.get("dictionary")
        dictionary = None if d is None else plain_from_host(
            f"{name}.dictionary", *d, dev)
        canon = data.get("canon")
        if canon is not None:
            canon = _u32_as_i32(canon, dev)
        elif dictionary is not None:
            canon = _build_canon(dictionary)
        return DictionaryColumn(codes, validity, canon, dictionary, st,
                                _carried_token(data.get("token")))
    if kind == "rle":
        vals = np.ascontiguousarray(np.asarray(data["run_values"]))
        return RunLengthColumn(
            torch.from_numpy(vals.copy()).to(device=dev,
                                             dtype=st.torch_dtype),
            _i32(np.asarray(data["run_lengths"]), dev), validity, st)
    if kind == "bitpacked":
        return BitPackedColumn(_u32_as_i32(data["lanes"], dev), validity,
                               int(data["reference"]), int(data["width"]),
                               st, zone=_zone_from_host(data.get("zone")))
    if kind == "for":
        return FrameOfReferenceColumn(
            _i64(np.asarray(data["refs"]), dev),
            _u32_as_i32(data["lanes"], dev), validity, int(data["width"]),
            int(data["block"]), st, zone=_zone_from_host(data.get("zone")))
    raise ValueError(f"column {name!r}: unknown encoding {kind!r}")


def encoded_to_host(col, plain_to_host) -> dict:
    """:func:`encoded_from_host`'s form of an encoded column (u32 buffers
    as uint32)."""
    def u32(t):
        return _host(t).astype(np.int32).view(np.uint32)

    if isinstance(col, DictionaryColumn):
        d = col.dictionary
        return {"encoding": "dictionary", "codes": u32(col.codes),
                "canon": None if col.canon is None else u32(col.canon),
                "dictionary": None if d is None else
                plain_to_host(d) + (repr(d.dtype),),
                "token": col.dict_token}
    if isinstance(col, RunLengthColumn):
        return {"encoding": "rle", "run_values": _host(col.run_values),
                "run_lengths": _host(col.run_lengths)}
    if isinstance(col, BitPackedColumn):
        return {"encoding": "bitpacked", "lanes": u32(col.lanes),
                "width": col.width, "reference": col.reference,
                "zone": _zone_to_host(col.zone)}
    return {"encoding": "for", "refs": _host(col.refs),
            "lanes": u32(col.lanes), "width": col.width,
            "block": col.block, "zone": _zone_to_host(col.zone)}
