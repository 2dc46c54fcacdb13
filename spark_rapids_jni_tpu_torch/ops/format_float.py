"""Spark ``format_number``-style float formatting (#,###,###.##).

Counterpart of ``spark_rapids_jni_tpu/ops/format_float.py``.  Reference:
``format_float.cu`` + ``ftos_converter.cuh:1247-1476``.  The value's
*shortest* decimal digits (the Ryu core of :mod:`.float_to_string`) are
rounded half-even to ``digits`` decimal places and grouped with
thousands separators.  Specials: NaN -> U+FFFD (replacement char), ±Inf
-> [-]U+221E, ±0 -> [-]0.000…

All three layout branches of the reference's ``to_formatted_chars`` are
computed for every row and selected by mask; the integer part is carried
as a digit *vector* (values up to 1e308 overflow any integer lane type)
and the comma grouping is a pure position-arithmetic gather.  u64 values
ride in int64 tensors (:mod:`.._u64`); the mantissas (at most 17 digits)
and the powers of ten a selected lane divides by (at most 10^17) stay
below 2^63, so their division and remainder are the signed ones.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u64 as U
from ..columnar import types as T
from ..columnar.column import Column, StringColumn
from ._util import device_table, host_table
from .float_to_string import _M32, _d2d, _digit_count, _f2d

_MAX_INT_DIGITS = 310  # 1.8e308

host_table("format_float/pow10",
           np.array([10**k for k in range(20)], dtype=np.uint64))


def _pow10_u64(e):
    """10**e for e int32[n] in [0, 19] (u64 bits; a gather from a
    table)."""
    table = device_table("format_float/pow10", e.device)
    return table[e.clamp(0, 19).long()]


def _round_half_even(mant, olength, keep):
    """Round the olength-digit integer to its leading ``keep`` digits
    (reference round_half_even, ftos_converter.cuh:1247)."""
    drop = olength - keep
    no_round = drop <= 0
    div = _pow10_u64(drop.clamp(min=0))
    mod = torch.remainder(mant, div)
    num = torch.div(mant, div, rounding_mode="floor")
    half = div // 2
    inc = (mod > half) | ((mod == half) & (num % 2 == 1) & (mod != 0))
    return torch.where(no_round, mant, num + inc.to(torch.int64))


def _digits_lsb(x, count):
    """The ``count`` low decimal digits of u64 ``x``, least significant
    first, as int32 ``[n, count]``."""
    digs = []
    for _ in range(count):
        x, r = U.udivmod(x, 10)
        digs.append(r.to(torch.int32))
    return torch.stack(digs, dim=1)


def _take(mat, idx):
    return torch.gather(mat, 1, idx.long())


def _literal(s: bytes, width: int, dev):
    buf = np.zeros((width,), np.uint8)
    buf[: len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(buf).to(dev)[None, :], len(s)


def format_float(col: Column, digits: int) -> StringColumn:
    """Format with ``digits`` decimal places (reference
    format_float.cu:112)."""
    if digits < 0:
        raise ValueError("digits must be >= 0")
    kind = col.dtype.kind
    if kind is T.Kind.FLOAT64:
        bits = col.data.contiguous().view(torch.int64)
        negative = bits < 0
        exp_f = U.lsr(bits, 52) & 0x7FF
        mant_f = bits & ((1 << 52) - 1)
        is_nan = (exp_f == 0x7FF) & (mant_f != 0)
        is_inf = (exp_f == 0x7FF) & (mant_f == 0)
        is_zero = (exp_f == 0) & (mant_f == 0)
        mant, e10 = _d2d(bits & ((1 << 63) - 1))
    elif kind is T.Kind.FLOAT32:
        bits = col.data.contiguous().view(torch.int32).to(torch.int64) \
            & _M32
        negative = (bits >> 31) != 0
        exp_f = (bits >> 23) & 0xFF
        mant_f = bits & ((1 << 23) - 1)
        is_nan = (exp_f == 0xFF) & (mant_f != 0)
        is_inf = (exp_f == 0xFF) & (mant_f == 0)
        is_zero = (exp_f == 0) & (mant_f == 0)
        mant, e10 = _f2d(bits & 0x7FFFFFFF)
    else:
        raise TypeError(f"format_float expects FLOAT32/64, got {col.dtype!r}")

    n = col.num_rows
    dev = col.data.device
    i32 = torch.int32
    olength = _digit_count(mant)
    exp = e10 + olength - 1

    dig_rev = _digits_lsb(mant, 17)  # LSB-first

    d = digits

    # ---------- branch A: exp < 0 ----------
    zeros_cnt = (-exp - 1).clamp(0, d)  # leading fractional zeros
    actual_round = d - zeros_cnt
    a_olength = torch.minimum(olength, actual_round)
    a_rounded = _round_half_even(mant, olength, actual_round)
    a_carry = a_rounded >= _pow10_u64(a_olength)
    a_rounded = torch.where(a_carry, a_rounded - _pow10_u64(a_olength),
                            a_rounded)
    # carry only propagates when the zeros run reaches the digits
    a_has_carry = a_carry & ((-exp - 1) <= d)

    # ---------- branch C: 0 <= exp < olength-1 ----------
    temp_d = torch.minimum(torch.full_like(olength, d), olength - exp - 1)
    c_rounded = _round_half_even(mant, olength, exp + temp_d + 1)
    c_pow = _pow10_u64(temp_d)
    c_integer = torch.div(c_rounded, c_pow, rounding_mode="floor")
    c_decimal = torch.remainder(c_rounded, c_pow)

    branch_a = exp < 0
    branch_b = (~branch_a) & (exp + 1 >= olength)

    # ---------- integer part as digit vector [n, MAXI], MSB-first --------
    # A: "0" or "1" (carry with no leading zeros); B: mantissa digits +
    # zero padding; C: digits of c_integer
    c_ilen = _digit_count(c_integer)
    int_len = torch.where(branch_a, torch.ones_like(olength),
                          torch.where(branch_b, exp + 1, c_ilen))
    j_int = torch.arange(_MAX_INT_DIGITS, dtype=i32, device=dev)[None, :]
    zero = torch.zeros((), dtype=i32, device=dev)
    b_dig = torch.where(
        j_int < olength[:, None],
        _take(dig_rev, (olength[:, None] - 1 - j_int).clamp(0, 16)), zero)
    c_rev = _digits_lsb(c_integer, 18)
    c_dig = _take(c_rev, (c_ilen[:, None] - 1 - j_int).clamp(0, 17))
    a_int0 = (a_has_carry & (zeros_cnt == 0)).to(i32)
    int_dig = torch.where(
        branch_a[:, None],
        torch.where(j_int == 0, a_int0[:, None], zero),
        torch.where(branch_b[:, None], b_dig, c_dig))

    # ---------- fractional part [n, d] -----------------------------------
    if d > 0:
        j_f = torch.arange(d, dtype=i32, device=dev)[None, :]
        # A: zeros_cnt zeros (last may carry to 1), then a_olength rounded
        # digits, then zeros
        a_rev = _digits_lsb(a_rounded, 18)
        a_pos = j_f - zeros_cnt[:, None]
        a_frac = torch.where(
            (a_pos >= 0) & (a_pos < a_olength[:, None]),
            _take(a_rev, (a_olength[:, None] - 1 - a_pos).clamp(0, 17)),
            zero)
        a_frac = torch.where(
            (j_f == zeros_cnt[:, None] - 1) & a_has_carry[:, None],
            torch.ones_like(a_frac), a_frac)
        # C: c_decimal zero-padded to temp_d, then tailing zeros
        d_rev = _digits_lsb(c_decimal, 18)
        c_frac = torch.where(
            j_f < temp_d[:, None],
            _take(d_rev, (temp_d[:, None] - 1 - j_f).clamp(0, 17)), zero)
        frac = torch.where(branch_a[:, None], a_frac,
                           torch.where(branch_b[:, None], zero, c_frac))
    else:
        frac = torch.zeros((n, 0), dtype=i32, device=dev)

    # ---------- assemble: sign + grouped integer + '.' + frac ------------
    fmt_int_len = int_len + torch.div(int_len - 1, 3, rounding_mode="floor")
    sign_len = negative.to(i32)
    width = 1 + _MAX_INT_DIGITS + (_MAX_INT_DIGITS - 1) // 3 + 1 + d
    j = torch.arange(width, dtype=i32, device=dev)[None, :]
    p = j - sign_len[:, None]

    # grouped integer: reverse position r from the right end of the group
    r = fmt_int_len[:, None] - 1 - p
    in_int = (p >= 0) & (r >= 0)
    is_comma = torch.remainder(r, 4) == 3
    dr = r - torch.div(r, 4, rounding_mode="floor")  # digit from the right
    int_char = torch.where(
        is_comma, torch.full_like(r, ord(",")),
        ord("0") + _take(int_dig, (int_len[:, None] - 1 - dr).clamp(
            0, _MAX_INT_DIGITS - 1)))
    out = torch.where(in_int, int_char, torch.full_like(r, ord(" ")))
    out = torch.where((j == 0) & negative[:, None],
                      torch.full_like(out, ord("-")), out)

    if d > 0:
        dot_pos = fmt_int_len[:, None]
        out = torch.where(p == dot_pos, torch.full_like(out, ord(".")), out)
        fpos = p - dot_pos - 1
        m_frac = (fpos >= 0) & (fpos < d)
        fchar = ord("0") + _take(
            torch.cat([frac, torch.zeros((n, 1), dtype=i32, device=dev)], 1),
            fpos.clamp(0, d - 1))
        out = torch.where(m_frac, fchar, out)
        length = sign_len + fmt_int_len + 1 + d
    else:
        length = sign_len + fmt_int_len

    chars = out.to(torch.uint8)

    # ---------- specials --------------------------------------------------
    zero_str = b"0." + b"0" * d if d > 0 else b"0"
    for mask, s in (
        (is_zero & ~negative, zero_str),
        (is_zero & negative, b"-" + zero_str),
        (is_inf & ~negative, b"\xe2\x88\x9e"),
        (is_inf & negative, b"-\xe2\x88\x9e"),
        (is_nan, b"\xef\xbf\xbd"),
    ):
        c, ln = _literal(s, width, dev)
        chars = torch.where(mask[:, None], c, chars)
        length = torch.where(mask, torch.full_like(length, ln), length)

    chars = torch.where(j < length[:, None], chars, torch.zeros_like(chars))
    length = length.to(i32)
    return StringColumn(chars, length * col.validity, col.validity)
