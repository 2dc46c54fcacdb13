"""Spark DECIMAL128 arithmetic with 256-bit intermediates, vectorized.

Counterpart of ``spark_rapids_jni_tpu/ops/decimal.py`` (itself derived
from spark-rapids-jni's ``decimal_utils.cu``): every operation computes
in a 256-bit integer domain, rescales with HALF_UP rounding and reports
per-row overflow as ``|result| >= 10^38``.  Scales are Spark scales
(digits right of the point).  Each public op returns ``(overflow Column,
result)`` exactly as the reference does — the result's validity is both
inputs' — and :func:`null_on_overflow` applies Spark's non-ANSI rule
(an overflowing row, divide by zero included, becomes null).

The reference's quirks carry over: ``multiply`` with
``cast_interim_result`` first rounds the raw product to 38 digits;
``integer_divide`` judges overflow on the wide quotient; ``remainder``
takes the dividend's sign; divide by zero reports overflow with a zero
result.

Layout: a 256-bit value is ``int64[8, n]`` holding u32 limbs,
little-endian, limb-major (the port's u32 carrier, :mod:`.._u32`): each
limb is one contiguous row, so every limb-by-limb step (a carry, a
product) is a contiguous elementwise op.  A product of two
limbs wraps mod 2^64 in int64 but is below 2^64, so its low and high
halves are exact after masking.  Division is schoolbook in base 2^16
with a static number of steps, every row in lockstep: by a divisor
below 2^32 (a power of ten up to 10^9, a row count) exactly in int64; by
a decimal divisor with each digit estimated in float64 and corrected
(:func:`_divmod_u`).  Quotients and remainders are the reference's
bit-serial loop's, bit for bit.  Plain torch ops throughout: the
reference computes this in jnp that XLA fuses, outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .._u32 import M32, SIGN32
from ..columnar import types as T
from ..columnar.column import Column, Decimal128Column

_POW10 = [10 ** e for e in range(77)]
_LIMB_WEIGHTS = [1 << i for i in range(8)]
_tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_consts: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _limbs_of(v: int) -> list:
    v &= (1 << 256) - 1
    return [(v >> (32 * i)) & M32 for i in range(8)]


def _table(name: str, dev: torch.device) -> torch.Tensor:
    """Small constant tables, made once per device: ``pow10`` (10^0 ..
    10^76 as ``[8, 77]`` limbs), ``pow10_small`` (10^0 .. 10^9),
    ``weights`` (2^0 .. 2^7) and ``float_weights`` (each limb's 2^(32 i))
    as ``[8, 1]`` columns."""
    key = (name, dev)
    t = _tables.get(key)
    if t is None:
        if name == "float_weights":
            t = torch.tensor([[2.0 ** (32 * i)] for i in range(8)],
                             dtype=torch.float64, device=dev)
        elif name == "pow10":
            t = torch.tensor([_limbs_of(v) for v in _POW10],
                             dtype=torch.int64, device=dev).t().contiguous()
        else:
            rows = {"pow10_small": _POW10[:10],
                    "weights": [[w] for w in _LIMB_WEIGHTS]}[name]
            t = torch.tensor(rows, dtype=torch.int64, device=dev)
        _tables[key] = t
    return t


def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    """A constant as ``[8, 1]`` limbs broadcastable against ``like``,
    made once per device (a host-to-device copy each call would wait for
    the stream)."""
    key = (v, like.device)
    t = _consts.get(key)
    if t is None:
        t = torch.tensor([[x] for x in _limbs_of(v)], dtype=torch.int64,
                         device=like.device)
        _consts[key] = t
    return t


# ---------------------------------------------------------------------------
# int64[8, n] u32-limb primitives
# ---------------------------------------------------------------------------

def _from_i128(limbs64: torch.Tensor) -> torch.Tensor:
    """Decimal128 limbs (int64[n, 2]) -> sign-extended 256-bit limbs: the
    four u32 words of the int32 view, transposed, then the sign."""
    words = limbs64.contiguous().view(torch.int32).t().contiguous()
    low = words.to(torch.int64) & M32
    ext = torch.where(low[3] >= SIGN32, M32, 0)
    return torch.cat([low, ext.expand(4, -1)])


def _to_i128(u: torch.Tensor) -> torch.Tensor:
    """Truncate to the low 128 bits as int64[n, 2] limbs."""
    return torch.stack([u[0] | (u[1] << 32), u[2] | (u[3] << 32)], dim=1)


def _carry(s: torch.Tensor) -> torch.Tensor:
    """Limb sums (each nonnegative, below 2^62) -> u32 limbs mod 2^(32
    width)."""
    out = torch.empty_like(s)
    carry = None
    for i in range(s.shape[0]):
        t = s[i] if carry is None else s[i] + carry
        out[i] = t & M32
        carry = t >> 32
    return out


def _sign_neg(u: torch.Tensor) -> torch.Tensor:
    return u[-1] >= SIGN32


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b)


def _add_small(a: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """``a + inc`` with ``inc`` int64[n] in {-1, 0, 1}."""
    ext = torch.where(inc < 0, M32, 0)
    b = torch.stack([inc & M32] + [ext] * 7)
    return _carry(a + b)


def _neg(a: torch.Tensor) -> torch.Tensor:
    s = a ^ M32
    s[0] += 1
    return _carry(s)


def _abs(a: torch.Tensor):
    neg = _sign_neg(a)
    return torch.where(neg, _neg(a), a), neg


def _lt_u(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b``: the highest differing limb decides, so the
    limbs where ``a`` is smaller, weighted 2^i, outweigh those where it
    is larger."""
    w = _table("weights", a.device)[:a.shape[0]]
    return ((a < b).to(torch.int64) * w).sum(0) > \
        ((a > b).to(torch.int64) * w).sum(0)


def _shl1(a: torch.Tensor) -> torch.Tensor:
    out = (a << 1) & M32
    out[1:] |= a[:-1] >> 31
    return out


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 256 bits of ``a * b`` (reference ``multiply``,
    decimal_utils.cu:127); ``b`` may be ``[8, 1]``."""
    acc = [torch.zeros_like(a[0]) for _ in range(8)]
    for j in range(8):
        bj = b[j]
        for i in range(8 - j):
            t = a[i] * bj  # < 2^64: exact halves after the wrap
            acc[i + j] = acc[i + j] + (t & M32)
            if i + j < 7:
                acc[i + j + 1] = acc[i + j + 1] + ((t >> 32) & M32)
    return _carry(torch.stack(acc))


def _mul_const(a: torch.Tensor, v: int) -> torch.Tensor:
    """``a * v`` for a nonnegative Python int ``v``, skipping its zero
    limbs (a power of ten below 2^32 costs 8 limb products, not 36)."""
    vl = _limbs_of(v)
    acc = [torch.zeros_like(a[0]) for _ in range(8)]
    for j in range(8):
        if vl[j] == 0:
            continue
        for i in range(8 - j):
            t = a[i] * vl[j]
            acc[i + j] = acc[i + j] + (t & M32)
            if i + j < 7:
                acc[i + j + 1] = acc[i + j + 1] + ((t >> 32) & M32)
    return _carry(torch.stack(acc))


def _sub_u(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` mod 2^256."""
    s = a + (b ^ M32)
    s[0] += 1
    return _carry(s)


def _divmod_u(num: torch.Tensor, den: torch.Tensor):
    """Unsigned 256-bit ``num`` divided by ``0 < den < 2^128`` (every
    decimal divisor: a 128-bit magnitude) -> ``(quotient, remainder)``.

    Schoolbook in base 2^16 from the top: 16 steps, each bringing one
    digit into the running remainder ``r < den * 2^16`` and estimating the
    quotient digit as ``floor(float(r) / float(den))``.  The two float64
    values are within 2^-50 of exact, so the estimate of a digit below
    2^16 is off by at most one either way; one correction each way makes
    it exact.  The same quotient and remainder as the reference's
    bit-serial loop, in 16 steps in place of 256, with no data-dependent
    control flow.  ``r`` and ``den * digit`` stay below 2^144, so the
    loop works on five limbs, not eight (a negative step result wraps
    mod 2^160 and shows in limb 4's top bit).
    """
    den = den.expand_as(num)[:5]
    w = _table("float_weights", num.device)[:5]
    den_f = (den.to(torch.float64) * w).sum(0)
    r = torch.zeros_like(num[:5])
    digits = [None] * 16
    for k in range(15, -1, -1):
        d = (num[k // 2] >> (16 * (k % 2))) & 0xFFFF
        shifted = (r << 16) & M32
        shifted[1:] |= r[:4] >> 16
        shifted[0] |= d
        r = shifted
        est = torch.floor((r.to(torch.float64) * w).sum(0) / den_f)
        q = est.clamp(0, 0xFFFF).to(torch.int64)
        r = _sub_u(r, _carry(den * q))
        under = _sign_neg(r)  # the estimate was one too high
        r = torch.where(under, _carry(r + den), r)
        q = q - under.to(torch.int64)
        over = ~_lt_u(r, den)  # one too low
        r = torch.where(over, _sub_u(r, den), r)
        digits[k] = q + over.to(torch.int64)
    quot = torch.stack([digits[2 * i] | (digits[2 * i + 1] << 16)
                        for i in range(8)])
    return quot, torch.cat([r, torch.zeros_like(r[:3])])


def _divmod_small(u: torch.Tensor, den):
    """Unsigned 256-bit ``u`` divided by ``0 < den < 2^32`` (int64[n] or
    a Python int) -> ``(quotient, remainder int64[n])``: schoolbook in
    base 2^16 from the top, so every partial stays below 2^48."""
    rem = torch.zeros_like(u[0])
    halves = [None] * 16
    for i in range(15, -1, -1):
        h = (u[i // 2] >> (16 * (i % 2))) & 0xFFFF
        cur = rem * 65536 + h
        halves[i] = torch.div(cur, den, rounding_mode="floor")
        rem = cur - halves[i] * den
    q = torch.stack([halves[2 * k] | (halves[2 * k + 1] << 16)
                     for k in range(8)])
    return q, rem


def _pow10_rows(e_rows: torch.Tensor) -> torch.Tensor:
    """Per-row 10^e (e in [0, 76]) as ``[8, n]`` limbs."""
    return _table("pow10", e_rows.device)[:, e_rows.clamp(0, 76)]


def _divmod_pow10(u: torch.Tensor, e, e_max: int):
    """Unsigned ``u`` divided by 10^e -> ``(quotient, remainder)``, for a
    static ``e`` (int) or per-row ``e`` (int64[n], each at most the
    static ``e_max``): nine digits a step, since floor(floor(u / a) / b)
    is floor(u / (a b)); the remainder is ``u - q * 10^e``."""
    if isinstance(e, int):
        q = u
        left = e
        while left > 0:
            step = min(left, 9)
            q = _divmod_small(q, _POW10[step])[0]
            left -= step
        return q, _sub_u(u, _mul_const(q, _POW10[e]))
    small = _table("pow10_small", u.device)
    q = u
    for c in range(-(-e_max // 9)):
        q = _divmod_small(q, small[(e - 9 * c).clamp(0, 9)])[0]
    return q, _sub_u(u, _mul(q, _pow10_rows(e)))


def _precision10(u_abs: torch.Tensor) -> torch.Tensor:
    """Smallest i with 10^i >= |value| (0 where none of 10^0..10^76 is),
    by a 7-step bisection over the power table."""
    table = _table("pow10", u_abs.device)
    n = u_abs.shape[1]
    lo = torch.zeros((n,), dtype=torch.int64, device=u_abs.device)
    hi = torch.full((n,), 77, dtype=torch.int64, device=u_abs.device)
    for _ in range(7):
        mid = (lo + hi) >> 1
        ge = ~_lt_u(table[:, mid.clamp(max=76)], u_abs)
        active = lo < hi
        hi = torch.where(active & ge, mid, hi)
        lo = torch.where(active & ~ge, mid + 1, lo)
    return torch.where(lo == 77, torch.zeros_like(lo), lo)


def _overflow_38(u: torch.Tensor) -> torch.Tensor:
    return ~_lt_u(_abs(u)[0], _const(_POW10[38], u))


def _is_zero(u: torch.Tensor) -> torch.Tensor:
    return (u == 0).all(dim=0)


def _one_like(u: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(u)
    one[0] = 1
    return one


# ---------------------------------------------------------------------------
# signed division and rounding (the reference's divide machinery)
# ---------------------------------------------------------------------------

def _divide_signed(n_limbs, d_limbs):
    """(signed quotient, |remainder|, n_neg, d_neg); zero divisors divide
    by a masked 1 (callers overwrite those rows)."""
    abs_n, n_neg = _abs(n_limbs)
    abs_d, d_neg = _abs(d_limbs)
    safe_d = torch.where(_is_zero(abs_d), _one_like(abs_d), abs_d)
    q, r = _divmod_u(abs_n, safe_d)
    q = torch.where(n_neg ^ d_neg, _neg(q), q)
    return q, r, n_neg, d_neg


def _round_half_up(q_signed, r_abs, d_abs, round_down):
    """Bump |q| by one where ``2|r| >= |d|``."""
    need_inc = ~_lt_u(_shl1(r_abs), d_abs)
    inc = torch.where(need_inc, torch.where(round_down, -1, 1), 0)
    return _add_small(q_signed, inc.to(torch.int64))


def _divide_and_round(n_limbs, d_limbs):
    q, r, n_neg, d_neg = _divide_signed(n_limbs, d_limbs)
    return _round_half_up(q, r, _abs(d_limbs)[0], n_neg ^ d_neg)


def _integer_divide(n_limbs, d_limbs):
    return _divide_signed(n_limbs, d_limbs)[0]


def _div_round_pow10(u, e, e_max: int = 0):
    """Signed ``u / 10^e`` with HALF_UP (``e`` static or per row)."""
    abs_u, neg = _abs(u)
    q, r = _divmod_pow10(abs_u, e, e_max)
    d = (_const(_POW10[e], u) if isinstance(e, int) else _pow10_rows(e))
    return _round_half_up(torch.where(neg, _neg(q), q), r, d, neg)


def _set_scale_and_round(u, from_scale: int, to_scale: int):
    """Rescale between static scales, HALF_UP on a scale decrease."""
    if to_scale == from_scale:
        return u
    if to_scale > from_scale:
        return _mul_const(u, _POW10[to_scale - from_scale])
    return _div_round_pow10(u, from_scale - to_scale)


# ---------------------------------------------------------------------------
# public ops: each returns (overflow Column<bool>, result)
# ---------------------------------------------------------------------------

def _result(u, valid, scale: int) -> Decimal128Column:
    return Decimal128Column(_to_i128(u), valid, T.SparkType.decimal(38, scale))


def _overflow_col(overflow, valid) -> Column:
    return Column(overflow, valid, T.BOOLEAN)


def null_on_overflow(overflow: Column, result):
    """Spark's non-ANSI rule: ``result`` with its overflowing rows null."""
    return dataclasses.replace(result,
                               validity=result.validity & ~overflow.data)


def _add_sub(a, b, result_scale: int, is_sub: bool):
    inter = max(a.scale, b.scale)
    ua = _set_scale_and_round(_from_i128(a.limbs), a.scale, inter)
    ub = _set_scale_and_round(_from_i128(b.limbs), b.scale, inter)
    if is_sub:
        ub = _neg(ub)
    s = _set_scale_and_round(_add(ua, ub), inter, result_scale)
    valid = a.validity & b.validity
    return _overflow_col(_overflow_38(s), valid), _result(s, valid,
                                                          result_scale)


def add_decimal128(a: Decimal128Column, b: Decimal128Column,
                   result_scale: int):
    """``a + b`` at ``result_scale`` (reference add_decimal128)."""
    return _add_sub(a, b, result_scale, is_sub=False)


def sub_decimal128(a: Decimal128Column, b: Decimal128Column,
                   result_scale: int):
    """``a - b`` at ``result_scale`` (reference sub_decimal128)."""
    return _add_sub(a, b, result_scale, is_sub=True)


def multiply_decimal128(a: Decimal128Column, b: Decimal128Column,
                        product_scale: int,
                        cast_interim_result: bool = True):
    """``a * b`` at ``product_scale`` (reference dec128_multiplier).

    ``cast_interim_result`` keeps Spark's double rounding before 3.4.2:
    a product past 38 digits is rounded to 38 first, then to the target
    scale.  Such a product needs two factors near 10^19 or more, so one
    host read of whether any row has one lets every other call rescale
    by a static power of ten (the same bits as the per-row path).
    """
    product = _mul(_from_i128(a.limbs), _from_i128(b.limbs))
    base = a.scale + b.scale
    shed = None
    if cast_interim_result:
        mag = _abs(product)[0]
        # precision10 > 38, and precision10 defined (|p| <= 10^76)
        past = (_lt_u(_const(_POW10[38], mag), mag)
                & ~_lt_u(_const(_POW10[76], mag), mag))
        if bool(past.any()):
            fdp = _precision10(mag) - 38
            shed = torch.where(past, fdp, 0)
            product = torch.where(past, _div_round_pow10(product, shed, 39),
                                  product)
    if shed is None:
        exponent = base - product_scale
        up_overflow = torch.zeros_like(a.validity)
        if exponent > 0:
            product = _div_round_pow10(product, exponent)
        elif exponent < 0:
            up_overflow = _precision10(_abs(product)[0]) - exponent > 38
            product = _mul_const(product, _POW10[-exponent])
    else:
        exponent = base - shed - product_scale
        up_overflow = (exponent < 0) & (
            _precision10(_abs(product)[0]) - exponent > 38)
        scaled_down = _div_round_pow10(
            product, torch.where(exponent > 0, exponent, 0),
            max(base - product_scale, 0))
        scaled_up = _mul(product, _pow10_rows(torch.where(exponent < 0,
                                                          -exponent, 0)))
        product = torch.where(exponent > 0, scaled_down,
                              torch.where(exponent < 0, scaled_up, product))
    valid = a.validity & b.validity
    return (_overflow_col(up_overflow | _overflow_38(product), valid),
            _result(product, valid, product_scale))


def _div_prepare(a, b, quotient_scale: int):
    n_limbs = _from_i128(a.limbs)
    d_limbs = _from_i128(b.limbs)
    div0 = _is_zero(_abs(d_limbs)[0])
    return n_limbs, d_limbs, quotient_scale - (a.scale - b.scale), div0


def _two_stage(n_limbs, d_limbs, shift: int):
    """The reference's scale-up past 10^38: multiply by 10^38, divide,
    then scale quotient and remainder by the rest and divide the
    remainder again, so no intermediate passes 256 bits."""
    q1, r1, n_neg, d_neg = _divide_signed(_mul_const(n_limbs, _POW10[38]),
                                          d_limbs)
    r1_signed = torch.where(n_neg, _neg(r1), r1)
    rest = _POW10[shift - 38]
    q2, r2, _, _ = _divide_signed(_mul_const(r1_signed, rest), d_limbs)
    return _add(_mul_const(q1, rest), q2), r2, n_neg, d_neg


def divide_decimal128(a: Decimal128Column, b: Decimal128Column,
                      quotient_scale: int):
    """``a / b`` at ``quotient_scale``, HALF_UP (reference
    dec128_divider)."""
    n_limbs, d_limbs, shift, div0 = _div_prepare(a, b, quotient_scale)
    if shift < 0:
        res = _div_round_pow10(_integer_divide(n_limbs, d_limbs), -shift)
    elif shift > 38:
        res, r2, n_neg, d_neg = _two_stage(n_limbs, d_limbs, shift)
        res = _round_half_up(res, r2, _abs(d_limbs)[0], n_neg ^ d_neg)
    else:
        res = _divide_and_round(_mul_const(n_limbs, _POW10[shift]),
                                d_limbs)
    res = torch.where(div0, torch.zeros_like(res), res)
    valid = a.validity & b.validity
    return (_overflow_col(div0 | _overflow_38(res), valid),
            _result(res, valid, quotient_scale))


def integer_divide_decimal128(a: Decimal128Column, b: Decimal128Column):
    """``a div b`` -> int64 (reference dec128_divider<uint64_t, true>):
    overflow is judged on the wide quotient, not the int64 narrowing."""
    n_limbs, d_limbs, shift, div0 = _div_prepare(a, b, 0)
    if shift < 0:
        q1 = _integer_divide(n_limbs, d_limbs)
        abs_q, neg = _abs(q1)
        q = _divmod_pow10(abs_q, -shift, 0)[0]
        res = torch.where(neg, _neg(q), q)
    elif shift > 38:
        res = _two_stage(n_limbs, d_limbs, shift)[0]
    else:
        res = _integer_divide(_mul_const(n_limbs, _POW10[shift]), d_limbs)
    res = torch.where(div0, torch.zeros_like(res), res)
    valid = a.validity & b.validity
    return (_overflow_col(div0 | _overflow_38(res), valid),
            Column(res[0] | (res[1] << 32), valid, T.INT64))


def remainder_decimal128(a: Decimal128Column, b: Decimal128Column,
                         remainder_scale: int):
    """``a % b`` at ``remainder_scale``, the dividend's sign (reference
    dec128_remainder)."""
    n_limbs = _from_i128(a.limbs)
    d_limbs = _from_i128(b.limbs)
    div0 = _is_zero(_abs(d_limbs)[0])
    abs_n, n_neg = _abs(n_limbs)
    abs_d, _ = _abs(d_limbs)
    d_shift = remainder_scale - b.scale
    n_shift = remainder_scale - a.scale
    if d_shift < 0:
        abs_d = _div_round_pow10(abs_d, -d_shift)
    else:
        n_shift -= d_shift
    safe_d = torch.where(_is_zero(abs_d), _one_like(abs_d), abs_d)
    if n_shift < 0:
        q1, _ = _divmod_u(abs_n, safe_d)
        int_div = _divmod_pow10(q1, -n_shift, 0)[0]
    else:
        if n_shift > 0:
            abs_n = _mul_const(abs_n, _POW10[n_shift])
        int_div, _ = _divmod_u(abs_n, safe_d)
    less_n = _mul(int_div, abs_d)
    if d_shift > 0:
        less_n = _mul_const(less_n, _POW10[d_shift])
    res = _sub_u(abs_n, less_n)
    res = torch.where(n_neg, _neg(res), res)
    res = torch.where(div0, torch.zeros_like(res), res)
    valid = a.validity & b.validity
    return (_overflow_col(div0 | _overflow_38(res), valid),
            _result(res, valid, remainder_scale))
