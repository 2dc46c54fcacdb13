"""u64 arithmetic on int64 tensors that hold the 64-bit pattern.

torch's ``uint64`` has almost no CUDA ops, so the port carries u64 values
as int64 bit patterns (as ``ops/hashing.py`` does for XXHash64).
Addition, subtraction, the low half of a product and left shifts wrap
alike in both types.  What does not: right shifts (logical here),
comparisons, division and remainder, and the conversion to float64; the
helpers below give the unsigned versions.
"""

from __future__ import annotations

from typing import Union

import torch

MIN64 = -(1 << 63)
Shift = Union[int, torch.Tensor]


def s64(u: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


def lsr(x: torch.Tensor, s: Shift) -> torch.Tensor:
    """Logical right shift.  A tensor ``s`` is read as u64, as the
    reference's shifts read theirs: past 63 (negative included) gives 0."""
    if isinstance(s, int):
        if s == 0:
            return x
        if s >= 64:
            return torch.zeros_like(x)
        return (x >> s) & ((1 << (64 - s)) - 1)
    s = s.to(torch.int64)
    sc = s.clamp(1, 63)
    mask = (torch.ones_like(sc) << (64 - sc)) - 1
    out = torch.where(s == 0, x, (x >> sc) & mask)
    return torch.where((s < 0) | (s >= 64), torch.zeros_like(x), out)


def shl(x: torch.Tensor, s: Shift) -> torch.Tensor:
    """Left shift; past 63 (a negative tensor ``s`` included) gives 0."""
    if isinstance(s, int):
        return torch.zeros_like(x) if s >= 64 else x << s
    s = s.to(torch.int64)
    out = x << s.clamp(0, 63)
    return torch.where((s < 0) | (s >= 64), torch.zeros_like(x), out)


def _flip(x):
    return x ^ MIN64


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b`` (``b`` a tensor or a u64 Python int)."""
    b = s64(b) if isinstance(b, int) else b
    return _flip(a) < (_flip(b) if isinstance(b, torch.Tensor) else b ^ MIN64)


def uge(a: torch.Tensor, b) -> torch.Tensor:
    return ~ult(a, b)


def ugt(a: torch.Tensor, b) -> torch.Tensor:
    b = s64(b) if isinstance(b, int) else b
    return _flip(a) > (_flip(b) if isinstance(b, torch.Tensor) else b ^ MIN64)


def udivmod(x: torch.Tensor, d: int):
    """Unsigned ``(x // d, x % d)`` for a constant ``d`` in ``[1, 2**64)``."""
    if d >= 1 << 63:
        q = uge(x, d).to(torch.int64)
        return q, x - q * s64(d)
    h = lsr(x, 1)
    q = (h // d) << 1
    r = x - q * d
    fix = uge(r, d)
    return q + fix.to(torch.int64), torch.where(fix, r - d, r)


def udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return udivmod(x, d)[0]


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    return udivmod(x, d)[1]


def to_f64(x: torch.Tensor) -> torch.Tensor:
    """u64 -> float64, rounded to nearest even as a u64 conversion is
    (halve with a sticky low bit, convert, double)."""
    half = lsr(x, 1) | (x & 1)
    return torch.where(x >= 0, x.to(torch.float64),
                       half.to(torch.float64) * 2.0)
