"""Float/double -> string matching Java ``Double.toString`` semantics.

Counterpart of ``spark_rapids_jni_tpu/ops/float_to_string.py``.  The
reference ports Ryu (shortest round-trip decimal) to CUDA
(``ftos_converter.cuh``: ``floating_decimal_64/32``, d2s tables) and
formats per Java rules (``cast_float_to_string.cu:110``): plain decimal
for 1e-3 <= |v| < 1e7, otherwise ``d.dddE±x``; always at least one
fractional digit; NaN -> "NaN", infinities -> "[-]Infinity", zeros ->
"[-]0.0".

The published Ryu algorithm (Ulf Adams, "Ryū: fast float-to-string
conversion", PLDI 2018), vectorized over rows:

* the 125-bit power-of-five tables are computed at import from Python
  ints, one u64 pair per entry;
* u64 values ride in int64 tensors (:mod:`.._u64`): adds and the low half
  of products wrap alike, while right shifts are logical, comparisons,
  division and remainder unsigned, and the 64x64->128 product keeps its
  32-bit limbs unsigned;
* Ryu's variable-length digit-removal loops become one fixed-trip masked
  loop (<= 20 iterations, the most removable digits for binary64).

String assembly builds a ``uint8[n, 26]`` char matrix from the digit
array with positional ``where`` cascades.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u64 as U
from ..columnar import types as T
from ..columnar.column import Column, StringColumn
from ._util import device_table, host_table

# ---------------------------------------------------------------------------
# tables (computed, 125-bit double / 59-61-bit float splits)
# ---------------------------------------------------------------------------

_DOUBLE_POW5_INV_BITCOUNT = 125
_DOUBLE_POW5_BITCOUNT = 125
_FLOAT_POW5_INV_BITCOUNT = 59
_FLOAT_POW5_BITCOUNT = 61
_M32 = 0xFFFFFFFF


def _pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def _build_double_tables():
    inv = np.zeros((342, 2), np.uint64)
    for q in range(342):
        inv_val = (1 << (_pow5bits(q) - 1 + _DOUBLE_POW5_INV_BITCOUNT)) \
            // 5**q + 1
        inv[q, 0] = inv_val & 0xFFFFFFFFFFFFFFFF
        inv[q, 1] = inv_val >> 64
    split = np.zeros((326, 2), np.uint64)
    for i in range(326):
        s = _pow5bits(i) - _DOUBLE_POW5_BITCOUNT
        val = 5**i >> s if s > 0 else 5**i << -s  # normalize to 125 bits
        split[i, 0] = val & 0xFFFFFFFFFFFFFFFF
        split[i, 1] = val >> 64
    return inv, split


def _build_float_tables():
    inv = np.zeros((31,), np.uint64)
    for q in range(31):
        inv[q] = (1 << (_pow5bits(q) - 1 + _FLOAT_POW5_INV_BITCOUNT)) \
            // 5**q + 1
    split = np.zeros((48,), np.uint64)
    for i in range(48):
        s = _pow5bits(i) - _FLOAT_POW5_BITCOUNT
        split[i] = 5**i >> s if s > 0 else 5**i << -s
    return inv, split


_D_INV, _D_SPLIT = _build_double_tables()
_F_INV, _F_SPLIT = _build_float_tables()
host_table("d_inv", _D_INV)
host_table("d_split", _D_SPLIT)
host_table("f_inv", _F_INV)
host_table("f_split", _F_SPLIT)


def _log10pow2(e):
    return (e * 78913) >> 18  # floor(e * log10(2)), e in [0, 1650]


def _log10pow5(e):
    return (e * 732923) >> 20  # floor(e * log10(5))


def _pow5bits_arr(e):
    return ((e * 1217359) >> 19) + 1


def _umul64_128(a, b):
    """u64 * u64 -> (hi, lo) via unsigned 32-bit limb products."""
    a_lo = a & _M32
    a_hi = U.lsr(a, 32)
    b_lo = b & _M32
    b_hi = U.lsr(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = U.lsr(ll, 32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    hi = hh + U.lsr(lh, 32) + U.lsr(hl, 32) + U.lsr(mid, 32)
    return hi, lo


def _shr128(hi, lo, s):
    """(hi:lo) >> s for per-row s in [1, 127] with result < 2**64."""
    s = s.to(torch.int64)
    lt64 = (s >= 0) & (s < 64)  # s is read as u64
    zero = torch.zeros_like(s)
    s_lo = torch.where(lt64, s, zero)
    s_hi = torch.where(lt64, zero, s - 64)
    lo_part = U.lsr(lo, s_lo) | torch.where(s_lo > 0, U.shl(hi, 64 - s_lo),
                                            torch.zeros_like(hi))
    return torch.where(lt64, lo_part, U.lsr(hi, s_hi))


def _mul_shift_64(m, mul_lo, mul_hi, j):
    """(m * (mul_hi:mul_lo)) >> j, j in (64, 191), result < 2**64."""
    hi1, lo1 = _umul64_128(m, mul_lo)
    hi2, lo2 = _umul64_128(m, mul_hi)
    # sum = (hi2:lo2) << 64 + (hi1:lo1); only bits >= 64 matter after >> j
    mid = hi1 + lo2
    carry = U.ult(mid, hi1).to(torch.int64)
    top = hi2 + carry
    return _shr128(top, mid, j - 64)


def _pow5_factor_ge(value, p, max_iter):
    """value divisible by 5**p (p <= max_iter)?  Fixed-trip factor count."""
    count = torch.zeros(value.shape, dtype=torch.int32, device=value.device)
    v = value
    for _ in range(max_iter):
        q, r = U.udivmod(v, 5)
        div = r == 0
        v = torch.where(div, q, v)
        count = count + div.to(torch.int32)
    return count >= p


def _remove_digits(vr, vp, vm, vr_tz, vm_tz, last_removed, trips):
    """Ryu's digit-removal loops as one fixed-trip masked loop."""
    removed = torch.zeros(vr.shape, dtype=torch.int32, device=vr.device)
    for _ in range(trips):
        vp10, _ = U.udivmod(vp, 10)
        vm10, vm_mod = U.udivmod(vm, 10)
        vr10, lr_new = U.udivmod(vr, 10)
        cond_main = U.ugt(vp10, vm10)
        cond_extra = ~cond_main & vm_tz & (vm_mod == 0)
        active = cond_main | cond_extra
        vm_tz_new = vm_tz & (vm_mod == 0)
        vr_tz_new = vr_tz & (last_removed == 0)
        vr = torch.where(active, vr10, vr)
        vp = torch.where(active, vp10, vp)
        vm = torch.where(active, vm10, vm)
        vr_tz = torch.where(active, vr_tz_new, vr_tz)
        vm_tz = torch.where(active, vm_tz_new, vm_tz)
        removed = removed + active.to(torch.int32)
        last_removed = torch.where(active, lr_new, last_removed)
    return vr, vm, vr_tz, vm_tz, removed, last_removed


def _round_output(vr, vm, vr_tz, vm_tz, accept, last_removed):
    last_removed = torch.where(
        vr_tz & (last_removed == 5) & (U.umod(vr, 2) == 0),
        torch.full_like(last_removed, 4), last_removed)
    round_up = ((vr == vm) & (~accept | ~vm_tz)) | U.uge(last_removed, 5)
    return vr + round_up.to(torch.int64)


def _d2d(bits):
    """Core Ryu shortest-decimal for binary64 (vectorized).

    bits: u64 bits in int64 [n] (finite, nonzero).  Returns (digits u64,
    exp10 int32).
    """
    dev = bits.device
    m = bits & ((1 << 52) - 1)
    e = (U.lsr(bits, 52) & 0x7FF).to(torch.int64)

    is_sub = e == 0
    e2 = torch.where(is_sub, torch.ones_like(e), e) - 1075 - 2
    m2 = torch.where(is_sub, m, m | (1 << 52))

    even = (m2 & 1) == 0
    accept = even
    mv = m2 * 4
    mm_shift = ((m != 0) | (e <= 1)).to(torch.int64)

    pos = e2 >= 0
    zero = torch.zeros_like(e2)
    # ---- e2 >= 0 branch ------------------------------------------------
    e2p = e2.clamp(min=0)
    q_p = (_log10pow2(e2p) - (e2 > 3).to(torch.int64)).clamp(min=0)
    k_p = _DOUBLE_POW5_INV_BITCOUNT + _pow5bits_arr(q_p) - 1
    i_p = -e2 + q_p + k_p
    inv = device_table("d_inv", dev)
    qi = q_p.clamp(0, 341)
    mul_lo_p, mul_hi_p = inv[qi, 0], inv[qi, 1]
    # ---- e2 < 0 branch -------------------------------------------------
    ne2 = (-e2).clamp(min=0)
    q_n = (_log10pow5(ne2) - (ne2 > 1).to(torch.int64)).clamp(min=0)
    i_n = ne2 - q_n
    k_n = _pow5bits_arr(i_n) - _DOUBLE_POW5_BITCOUNT
    j_n = q_n - k_n
    spl = device_table("d_split", dev)
    ii = i_n.clamp(0, 325)
    mul_lo_n, mul_hi_n = spl[ii, 0], spl[ii, 1]

    e10 = torch.where(pos, q_p, q_n + e2)
    mul_lo = torch.where(pos, mul_lo_p, mul_lo_n)
    mul_hi = torch.where(pos, mul_hi_p, mul_hi_n)
    j = torch.where(pos, i_p, j_n)

    vr = _mul_shift_64(mv, mul_lo, mul_hi, j)
    vp = _mul_shift_64(mv + 2, mul_lo, mul_hi, j)
    vm = _mul_shift_64(mv - 1 - mm_shift, mul_lo, mul_hi, j)

    # trailing-zero tracking
    q = torch.where(pos, q_p, q_n)
    vr_tz = torch.zeros_like(even)
    vm_tz = torch.zeros_like(even)
    # e2 >= 0, q <= 21 cases
    c_p = pos & (q_p <= 21)
    mv_mod5 = U.umod(mv, 5) == 0
    vr_tz = torch.where(c_p & mv_mod5, _pow5_factor_ge(mv, q_p, 22), vr_tz)
    vm_tz = torch.where(c_p & ~mv_mod5 & accept,
                        _pow5_factor_ge(mv - 1 - mm_shift, q_p, 22), vm_tz)
    vp = torch.where(
        c_p & ~mv_mod5 & ~accept,
        vp - _pow5_factor_ge(mv + 2, q_p, 22).to(torch.int64), vp)
    # e2 < 0, q <= 1: vr trailing; vm trailing iff mm_shift == 1
    c_n1 = ~pos & (q_n <= 1)
    vr_tz = torch.where(c_n1, torch.ones_like(vr_tz), vr_tz)
    vm_tz = torch.where(c_n1 & accept, mm_shift == 1, vm_tz)
    vp = torch.where(c_n1 & ~accept, vp - 1, vp)
    # e2 < 0, q < 63: vr_tz = multipleOfPowerOf2(mv, q)
    c_n2 = ~pos & (q_n > 1) & (q_n < 63)
    mask_q = U.shl(torch.ones_like(q), q.clamp(0, 64)) - 1
    vr_tz = torch.where(c_n2, (mv & mask_q) == 0, vr_tz)

    last_removed = torch.zeros_like(bits)
    vr, vm, vr_tz, vm_tz, removed, last_removed = _remove_digits(
        vr, vp, vm, vr_tz, vm_tz, last_removed, 20)
    output = _round_output(vr, vm, vr_tz, vm_tz, accept, last_removed)
    return output, (e10 + removed).to(torch.int32)


def _f2d(bits32):
    """Core Ryu for binary32 (vectorized; 64-bit arithmetic suffices).

    bits32: the float's 32 bits in an int64 tensor (sign cleared)."""
    dev = bits32.device
    bits = bits32 & _M32
    m = bits & ((1 << 23) - 1)
    e = (bits >> 23) & 0xFF

    is_sub = e == 0
    e2 = torch.where(is_sub, torch.ones_like(e), e) - 150 - 2
    m2 = torch.where(is_sub, m, m | (1 << 23))

    even = (m2 & 1) == 0
    accept = even
    mv = m2 * 4
    mm_shift = ((m != 0) | (e <= 1)).to(torch.int64)

    def mul_shift_32(mx, factor, shift):
        # (mx * factor) >> shift; mx < 2**26, factor < 2**64, shift > 32
        f_lo = factor & _M32
        f_hi = U.lsr(factor, 32)
        lo = mx * f_lo
        hi = mx * f_hi
        sum_ = U.lsr(lo, 32) + hi
        return U.lsr(sum_, shift.to(torch.int64) - 32)

    pos = e2 >= 0
    q_p = _log10pow2(e2.clamp(min=0))
    k_p = _FLOAT_POW5_INV_BITCOUNT + _pow5bits_arr(q_p) - 1
    i_p = -e2 + q_p + k_p
    inv = device_table("f_inv", dev)
    fac_p = inv[q_p.clamp(0, 30)]

    ne2 = (-e2).clamp(min=0)
    q_n = _log10pow5(ne2)
    i_n = ne2 - q_n
    k_n = _pow5bits_arr(i_n) - _FLOAT_POW5_BITCOUNT
    j_n = q_n - k_n
    spl = device_table("f_split", dev)
    fac_n = spl[i_n.clamp(0, 47)]

    e10 = torch.where(pos, q_p, q_n + e2)
    factor = torch.where(pos, fac_p, fac_n)
    j = torch.where(pos, i_p, j_n)

    vr = mul_shift_32(mv, factor, j)
    vp = mul_shift_32(mv + 2, factor, j)
    vm = mul_shift_32(mv - 1 - mm_shift, factor, j)

    q = torch.where(pos, q_p, q_n)
    vr_tz = torch.zeros_like(even)
    vm_tz = torch.zeros_like(even)

    # f2s pre-step: when the loop below may remove no digit, the rounding
    # digit comes from one extra decimal of precision (f2s.c q != 0 case)
    c_pre = (q != 0) & ~U.ugt(U.udiv(vp - 1, 10), U.udiv(vm, 10))
    # pos: mulPow5InvDivPow2(mv, q-1, -e2 + (q-1) + l), l from q-1
    qm1 = (q_p - 1).clamp(min=0)
    l_p = _FLOAT_POW5_INV_BITCOUNT + _pow5bits_arr(qm1) - 1
    fac_pre_p = inv[qm1.clamp(0, 30)]
    j_pre_p = -e2 + qm1 + l_p
    lr_p = U.umod(mul_shift_32(mv, fac_pre_p, j_pre_p.clamp(min=33)), 10)
    # neg: mulPow5divPow2(mv, i+1, q - 1 - (pow5bits(i+1) - BITCOUNT))
    i1 = i_n + 1
    fac_pre_n = spl[i1.clamp(0, 47)]
    j_pre_n = q_n - 1 - (_pow5bits_arr(i1) - _FLOAT_POW5_BITCOUNT)
    lr_n = U.umod(mul_shift_32(mv, fac_pre_n, j_pre_n.clamp(min=33)), 10)
    last_removed = torch.where(c_pre, torch.where(pos, lr_p, lr_n),
                               torch.zeros_like(lr_p))

    c_p = pos & (q_p <= 9)
    mv_mod5 = U.umod(mv, 5) == 0
    vr_tz = torch.where(c_p & mv_mod5, _pow5_factor_ge(mv, q_p, 11), vr_tz)
    vm_tz = torch.where(c_p & ~mv_mod5 & accept,
                        _pow5_factor_ge(mv - 1 - mm_shift, q_p, 11), vm_tz)
    vp = torch.where(
        c_p & ~mv_mod5 & ~accept,
        vp - _pow5_factor_ge(mv + 2, q_p, 11).to(torch.int64), vp)
    c_n1 = ~pos & (q_n <= 1)
    vr_tz = torch.where(c_n1, torch.ones_like(vr_tz), vr_tz)
    vm_tz = torch.where(c_n1 & accept, mm_shift == 1, vm_tz)
    vp = torch.where(c_n1 & ~accept, vp - 1, vp)
    c_n2 = ~pos & (q_n > 1) & (q_n < 31)
    mask_q = U.shl(torch.ones_like(q), (q - 1).clamp(0, 64)) - 1
    vr_tz = torch.where(c_n2, (mv & mask_q) == 0, vr_tz)

    vr, vm, vr_tz, vm_tz, removed, last_removed = _remove_digits(
        vr, vp, vm, vr_tz, vm_tz, last_removed, 11)
    output = _round_output(vr, vm, vr_tz, vm_tz, accept, last_removed)
    return output, (e10 + removed).to(torch.int32)


# ---------------------------------------------------------------------------
# Java-style formatting
# ---------------------------------------------------------------------------

_MAX_CHARS = 26

# fixed output width of double_to_json_string: _format's 26-char layout
# ("-2.2250738585072014E-308") + 2 pad columns for the quoted specials.
DOUBLE_JSON_W = 28


def _digit_count(v):
    count = torch.ones(v.shape, dtype=torch.int32, device=v.device)
    x = v
    for _ in range(19):
        x = U.udiv(x, 10)
        count = count + (x != 0).to(torch.int32)
    return count


def _register_literal(s: str, width: int) -> None:
    buf = np.zeros((width,), np.uint8)
    raw = s.encode()
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    host_table(f"{s}/{width}", buf)


for _s in ("0.0", "-0.0", "Infinity", "-Infinity", "NaN"):
    _register_literal(_s, _MAX_CHARS)
for _s in ('"Infinity"', '"-Infinity"', '"NaN"'):
    _register_literal(_s, DOUBLE_JSON_W)


def _literal(s: str, width: int, dev) -> torch.Tensor:
    """The special value ``s`` as a zero-padded ``[1, width]`` row."""
    return device_table(f"{s}/{width}", dev)[None, :]


def _format(digits, exp10, negative, is_nan, is_inf, is_zero):
    """Assemble Java toString chars: digits u64[n], exp10 = power of the
    LAST digit; value = digits * 10^exp10."""
    n = digits.shape[0]
    dev = digits.device
    olength = _digit_count(digits)
    # E = exponent of the leading digit
    E = exp10 + olength - 1
    plain = (E >= -3) & (E < 7)

    # digit characters MSB-first: dig[k] = k-th most significant digit
    digs = []
    x = digits
    for _ in range(17):
        x, r = U.udivmod(x, 10)
        digs.append(r)
    dig_rev = torch.stack(digs, dim=1)  # [n, 17] LSB-first
    kk = torch.arange(17, device=dev)[None, :]
    msb_idx = olength[:, None] - 1 - kk  # index into dig_rev, MSB-first
    dig = torch.gather(dig_rev, 1, msb_idx.clamp(0, 16).long())
    dig = torch.where(kk < olength[:, None], dig,
                      torch.zeros_like(dig)).to(torch.int32)

    def take(p):
        return torch.gather(dig, 1, p.clamp(0, 16).long())

    j = torch.arange(_MAX_CHARS, device=dev)[None, :]
    sign_len = negative.to(torch.int32)[:, None]
    out = torch.full((n, _MAX_CHARS), ord(" "), dtype=torch.int32,
                     device=dev)

    def put(out, pos_mask, ch):
        if isinstance(ch, torch.Tensor):
            ch = ch.to(torch.int32)
        return torch.where(pos_mask, ch, out)

    out = put(out, (j == 0) & negative[:, None], ord("-"))
    p = j - sign_len  # position net of sign
    Ec = E[:, None]
    olc = olength[:, None]

    # ---------- plain, E >= 0: digits[0..E] '.' frac ----------
    ip_len = Ec + 1  # integer digits
    has_frac = olc > ip_len
    frac_len = (olc - ip_len).clamp(min=1)
    pos_e = plain[:, None] & (Ec >= 0)
    m_int = pos_e & (p >= 0) & (p < ip_len)
    out = put(out, m_int, ord("0") + take(p))
    out = put(out, pos_e & (p == ip_len), ord("."))
    fpos = p - ip_len - 1
    m_frac = pos_e & (fpos >= 0) & (fpos < frac_len)
    fdig = torch.where(has_frac, take(ip_len + fpos),
                       torch.zeros((), dtype=torch.int32, device=dev))
    out = put(out, m_frac, ord("0") + fdig)
    len_plain_pos = sign_len + ip_len + 1 + frac_len

    # ---------- plain, E < 0: "0." zeros digits ----------
    zeros = -Ec - 1
    m0 = plain[:, None] & (Ec < 0)
    out = put(out, m0 & (p == 0), ord("0"))
    out = put(out, m0 & (p == 1), ord("."))
    out = put(out, m0 & (p >= 2) & (p < 2 + zeros), ord("0"))
    dpos = p - 2 - zeros
    m_d = m0 & (dpos >= 0) & (dpos < olc)
    out = put(out, m_d, ord("0") + take(dpos))
    len_plain_neg = sign_len + 2 + zeros + olc

    # ---------- scientific: d '.' frac 'E' [-] expdigits ----------
    msci = (~plain)[:, None]
    out = put(out, msci & (p == 0), ord("0") + dig[:, 0:1])
    out = put(out, msci & (p == 1), ord("."))
    sfrac_len = (olc - 1).clamp(min=1)
    spos = p - 2
    sdig = torch.where(olc > 1, take(1 + spos),
                       torch.zeros((), dtype=torch.int32, device=dev))
    out = put(out, msci & (spos >= 0) & (spos < sfrac_len), ord("0") + sdig)
    epos0 = 2 + sfrac_len
    out = put(out, msci & (p == epos0), ord("E"))
    eneg = Ec < 0
    out = put(out, msci & eneg & (p == epos0 + 1), ord("-"))
    absE = Ec.abs()
    e_len = 1 + (absE >= 10).to(torch.int32) + (absE >= 100).to(torch.int32)
    e_start = epos0 + 1 + eneg.to(torch.int32)
    ep = p - e_start
    e_digs = torch.cat([absE // 100 % 10, absE // 10 % 10, absE % 10],
                       dim=1)  # [n,3] MSB-first (padded)
    e_idx = 3 - e_len + ep
    m_e = msci & (ep >= 0) & (ep < e_len)
    out = put(out, m_e, ord("0") + torch.gather(
        e_digs, 1, e_idx.clamp(0, 2).long()))
    len_sci = sign_len + 2 + sfrac_len + 1 + eneg.to(torch.int32) + e_len

    length = torch.where(pos_e, len_plain_pos,
                         torch.where(plain[:, None], len_plain_neg,
                                     len_sci))[:, 0]

    # ---------- specials ----------
    chars = out.to(torch.uint8)
    length = length.to(torch.int32)
    for mask, s in ((is_zero & ~negative, "0.0"),
                    (is_zero & negative, "-0.0"),
                    (is_inf & ~negative, "Infinity"),
                    (is_inf & negative, "-Infinity"),
                    (is_nan, "NaN")):
        chars = torch.where(mask[:, None], _literal(s, _MAX_CHARS, dev),
                            chars)
        length = torch.where(mask, torch.full_like(length, len(s)), length)

    idx = torch.arange(_MAX_CHARS, device=dev)[None, :]
    chars = torch.where(idx < length[:, None], chars,
                        torch.zeros_like(chars))
    return chars, length


def _double_parts(data: torch.Tensor):
    bits = data.to(torch.float64).contiguous().view(torch.int64)
    negative = bits < 0
    exp_field = U.lsr(bits, 52) & 0x7FF
    mant = bits & ((1 << 52) - 1)
    is_nan = (exp_field == 0x7FF) & (mant != 0)
    is_inf = (exp_field == 0x7FF) & (mant == 0)
    is_zero = (exp_field == 0) & (mant == 0)
    digits, exp10 = _d2d(bits & ((1 << 63) - 1))
    return digits, exp10, negative, is_nan, is_inf, is_zero


def float_to_string(col: Column) -> StringColumn:
    """Java Float/Double.toString per row (reference
    ``cast_float_to_string.cu:110``)."""
    kind = col.dtype.kind
    if kind is T.Kind.FLOAT64:
        parts = _double_parts(col.data)
    elif kind is T.Kind.FLOAT32:
        bits = col.data.contiguous().view(torch.int32).to(torch.int64) \
            & _M32
        negative = (bits >> 31) != 0
        exp_field = (bits >> 23) & 0xFF
        mant = bits & ((1 << 23) - 1)
        is_nan = (exp_field == 0xFF) & (mant != 0)
        is_inf = (exp_field == 0xFF) & (mant == 0)
        is_zero = (exp_field == 0) & (mant == 0)
        digits, exp10 = _f2d(bits & 0x7FFFFFFF)
        parts = (digits, exp10, negative, is_nan, is_inf, is_zero)
    else:
        raise TypeError(
            f"float_to_string expects FLOAT32/64, got {col.dtype!r}")

    chars, length = _format(*parts)
    return StringColumn(chars, length * col.validity, col.validity)


def double_to_json_string(data: torch.Tensor):
    """Java Double.toString with the JSON tweaks of the reference's
    ``ftos_converter.cuh:1154-1200``: ±Infinity and NaN come back QUOTED
    (bare Infinity is not valid JSON), ±0.0 as "0.0"/"-0.0".

    Takes a raw float64 tensor; returns (chars uint8[n, 28], lengths
    int32).  Used by get_json_object's number normalization.
    """
    digits, exp10, negative, is_nan, is_inf, is_zero = _double_parts(data)
    chars, length = _format(digits, exp10, negative, is_nan, is_inf,
                            is_zero)

    # quote the non-JSON specials
    n = chars.shape[0]
    dev = chars.device
    chars = torch.cat([chars, torch.zeros((n, 2), dtype=torch.uint8,
                                          device=dev)], dim=1)
    for mask, s in ((is_inf & ~negative, "Infinity"),
                    (is_inf & negative, "-Infinity"),
                    (is_nan, "NaN")):
        q = '"' + s + '"'
        chars = torch.where(mask[:, None], _literal(q, DOUBLE_JSON_W, dev),
                            chars)
        length = torch.where(mask, torch.full_like(length, len(q)), length)
    return chars, length.to(torch.int32)
