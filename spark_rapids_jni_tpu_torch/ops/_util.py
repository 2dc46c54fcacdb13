"""Shared per-row char helpers for the string ops.

Counterpart of ``spark_rapids_jni_tpu/ops/_util.py``, plus the few
tensor idioms the string modules share (a first-true index, a column
shift with zero fill, a row gather with clamped positions, and running
sums and maxima along short rows), and the host constant tables the
string ops index on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gather_cols(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[i, idx[i]]`` with ``idx`` clamped to ``[0, L)``."""
    L = mat.shape[1]
    return torch.gather(mat, 1, idx.clamp(0, L - 1).long()[:, None])[:, 0]


def char_at(chars: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """chars[i, pos[i]] with clamped gather; 0 where pos is out of range."""
    L = chars.shape[1]
    c = gather_cols(chars, pos)
    return torch.where((pos >= 0) & (pos < L), c, torch.zeros_like(c))


def first_true(mask: torch.Tensor, fill: int = None) -> torch.Tensor:
    """Index (int32) of the first True per row of ``mask [n, L]``;
    ``fill`` (default ``L``) where a row has none."""
    L = mask.shape[1]
    fill = L if fill is None else fill
    pos = torch.arange(L, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, pos[None, :], L).amin(dim=1)
    return torch.where(first >= L, torch.full_like(first, fill), first)


def shift_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x[:, j + k]`` at column ``j``, zero (False) past the end."""
    if k == 0:
        return x
    n, L = x.shape[:2]
    out = torch.zeros_like(x)
    if k < L:
        out[:, :L - k] = x[:, k:]
    return out


WINDOW_CHUNK = 1 << 20     # windows per gather: bounds the index tensor


def char_window(chars: torch.Tensor, s: torch.Tensor, length: torch.Tensor,
                W: int, row: torch.Tensor = None) -> torch.Tensor:
    """``chars[row[i], s[i]:s[i] + length[i]]`` as a zero-padded ``[m, W]``
    matrix (``row`` defaults to ``i``, ``length`` is already in ``[0,
    W]``).  Each row of ``chars`` is padded by ``W`` zero bytes, so a
    window never leaves its row."""
    n, L = chars.shape
    dev = chars.device
    m = s.shape[0]
    if row is None:
        row = torch.arange(m, dtype=torch.int64, device=dev)
    flat = torch.cat([chars, torch.zeros((n, W), dtype=chars.dtype,
                                         device=dev)], dim=1).reshape(-1)
    base = row.to(torch.int64) * (L + W) + s.clamp(0, L).to(torch.int64)
    cols = torch.arange(W, dtype=torch.int64, device=dev)
    win = torch.empty((m, W), dtype=chars.dtype, device=dev)
    for lo in range(0, m, WINDOW_CHUNK):
        hi = min(lo + WINDOW_CHUNK, m)
        g = flat[base[lo:hi, None] + cols[None, :]]
        win[lo:hi] = torch.where(cols[None, :] < length[lo:hi, None], g,
                                 torch.zeros_like(g))
    return win


def is_ws(c: torch.Tensor) -> torch.Tensor:
    """Whitespace or C0 control code (reference cast_string.cu:46-56)."""
    return c <= 0x20


def is_digit(c: torch.Tensor) -> torch.Tensor:
    return (c >= ord("0")) & (c <= ord("9"))


def strip_and_sign(chars: torch.Tensor, lengths: torch.Tensor, strip: bool):
    """Locate the value start: optional stripped whitespace then one sign.

    Returns (start, has_sign, negative) where ``start`` indexes the first
    content char after whitespace and sign.  All three casts share this
    preamble (reference cast_string.cu:184-198, cast_string_to_float.cu:99-102).
    """
    n, L = chars.shape
    idx = torch.arange(L, device=chars.device)[None, :]
    in_range = idx < lengths[:, None]
    if strip:
        nonws = in_range & ~is_ws(chars)
        s0 = first_true(nonws, L)
        s0 = torch.where(s0 >= L, lengths.to(torch.int32), s0)
    else:
        s0 = torch.zeros((n,), dtype=torch.int32, device=chars.device)
    sc = char_at(chars, s0)
    has_sign = (sc == ord("+")) | (sc == ord("-"))
    negative = sc == ord("-")
    return s0 + has_sign.to(torch.int32), has_sign, negative


# At and past this many elements a running scan along short rows takes
# the doubling form: on the H100, torch's scan kernel along a 64-wide
# innermost dim ran at ~85 GB/s (cumsum) and its cummax at ~10 ms a
# 2^20 x 64 int32 call (chip_smoke.py's qstr profile), where log2(L)
# shifted maxima or sums are a few plain passes each.
_DOUBLING_MIN_NUMEL = 1 << 22
_DOUBLING_MAX_WIDTH = 128


def _doubling(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan along dim 1 by doubling: after the step of shift
    ``s``, column ``j`` holds ``op`` over ``[j - 2s + 1, j]``."""
    L = x.shape[1]
    s = 1
    while s < L:
        y = torch.empty_like(x)
        y[:, :s] = x[:, :s]
        op(x[:, s:], x[:, :L - s], out=y[:, s:])
        x = y
        s *= 2
    return x


def _use_doubling(x: torch.Tensor) -> bool:
    return (x.numel() >= _DOUBLING_MIN_NUMEL
            and 1 < x.shape[1] <= _DOUBLING_MAX_WIDTH)


def row_cummax(x: torch.Tensor) -> torch.Tensor:
    """Running maximum along dim 1 (``torch.cummax(x, 1).values``)."""
    if _use_doubling(x):
        return _doubling(x, torch.maximum)
    return torch.cummax(x, dim=1).values


def row_cumsum(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Running sum of an integer or bool tensor along dim 1, in
    ``dtype`` (exact: integer adds in any order)."""
    if _use_doubling(x):
        return _doubling(x.to(dtype), torch.add)
    return torch.cumsum(x, dim=1, dtype=dtype)


_HOST_TABLES = {}


def host_table(key: str, arr: np.ndarray) -> None:
    """Name a host constant table (u64 tables move as int64 bits)."""
    _HOST_TABLES[key] = arr


@functools.lru_cache(maxsize=None)
def _device_table(key: str, device: torch.device) -> torch.Tensor:
    arr = _HOST_TABLES[key]
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def device_table(key: str, device) -> torch.Tensor:
    """The named table on ``device``, copied there once."""
    return _device_table(key, torch.device(device))
