"""decimal -> string, Java ``BigDecimal.toString`` rules (non-ANSI).

Counterpart of ``spark_rapids_jni_tpu/ops/decimal_to_string.py``.
Reference: ``cast_decimal_to_string.cu:211``
(``decimal_to_non_ansi_string``).  With Spark scale s and digit count D,
adjusted exponent a = D - 1 - s:

* s == 0: plain integer.
* s > 0 and a >= -6: ``[-]integer.fraction`` (fraction zero-padded to s).
* otherwise (negative scale or a < -6): scientific ``d[.frac]E±a``.

128-bit digit extraction: base-2^32 schoolbook division by 10^9 (each
step's dividend stays below 2^62, so int64 lane math is exact), five
passes -> base-1e9 groups -> per-group digit unpack.  The limbs are the
port's int64 carriers of the reference's u64 bits (:mod:`.._u64`).
"""

from __future__ import annotations

import torch

from .. import _u64 as U
from ..columnar.column import Decimal128Column, StringColumn

_M32 = 0xFFFFFFFF
_BILLION = 10**9
_MAX_DIGITS = 45  # 5 groups of 9 (2^128 has 39 decimal digits)
_WIDTH = 88


def _u128_digits(lo, hi):
    """|value| digit matrix [n, 45] MSB-first + digit count (>= 1)."""
    limbs = [lo & _M32, U.lsr(lo, 32), hi & _M32, U.lsr(hi, 32)]
    groups = []
    for _ in range(5):
        rem = torch.zeros_like(lo)
        new = [None] * 4
        for i in range(3, -1, -1):
            cur = (rem << 32) | limbs[i]
            new[i] = cur // _BILLION
            rem = cur % _BILLION
        groups.append(rem)  # least-significant group first
        limbs = new
    digs = []
    for g in groups:
        x = g
        for _ in range(9):
            digs.append((x % 10).to(torch.int32))
            x = x // 10
    dig_lsb = torch.stack(digs, dim=1)  # [n, 45] least-significant first
    k = torch.arange(_MAX_DIGITS, dtype=torch.int32,
                     device=lo.device)[None, :]
    ndigits = torch.where(dig_lsb != 0, k + 1, torch.zeros_like(k)).amax(
        dim=1).clamp(min=1).to(torch.int32)
    # MSB-first view
    idx = ndigits[:, None] - 1 - k
    dig = torch.where(
        k < ndigits[:, None],
        torch.gather(dig_lsb, 1, idx.clamp(0, _MAX_DIGITS - 1).long()),
        torch.zeros_like(dig_lsb))
    return dig, ndigits


def decimal_to_string(col: Decimal128Column) -> StringColumn:
    """Spark CAST(decimal AS STRING), non-ANSI (reference
    cast_decimal_to_string.cu:211)."""
    s = col.scale
    limbs = col.limbs
    dev = limbs.device
    i32 = torch.int32
    lo0, hi0 = limbs[:, 0], limbs[:, 1]
    neg = hi0 < 0
    # two's-complement abs: ~x + 1, carry into hi exactly when lo was 0
    lo = torch.where(neg, ~lo0 + 1, lo0)
    hi = torch.where(neg, ~hi0 + (lo0 == 0).to(torch.int64), hi0)

    dig, nd = _u128_digits(lo, hi)
    n = limbs.shape[0]
    adjusted = nd - 1 - s

    j = torch.arange(_WIDTH, dtype=i32, device=dev)[None, :]
    sign_len = neg.to(i32)[:, None]
    p = j - sign_len
    out = torch.full((n, _WIDTH), ord(" "), dtype=i32, device=dev)
    out = torch.where((j == 0) & neg[:, None], torch.full_like(out, ord("-")),
                      out)

    def dig_at(q):
        return torch.gather(dig, 1, q.clamp(0, _MAX_DIGITS - 1).long())

    def put(mask, val, out):
        if not isinstance(val, torch.Tensor):
            val = torch.full_like(out, val)
        return torch.where(mask, val, out)

    def finish(out, length):
        chars = out.to(torch.uint8)
        chars = torch.where(j < length[:, None], chars,
                            torch.zeros_like(chars))
        length = length.to(i32)
        return StringColumn(chars, length * col.validity, col.validity)

    plain = (s >= 0) & (adjusted >= -6)
    if s == 0:
        m = (p >= 0) & (p < nd[:, None])
        out = put(m, ord("0") + dig_at(p), out)
        return finish(out, sign_len[:, 0] + nd)

    plain_m = plain[:, None]
    if s > 0:
        # ---- plain layout: int part (nd - s digits, or "0") . frac ------
        ip_digits = (nd - s).clamp(min=0)
        ip_len = ip_digits.clamp(min=1)  # "0" when value < 1
        m_int = plain_m & (p >= 0) & (p < ip_len[:, None])
        int_char = torch.where(ip_digits[:, None] == 0,
                               torch.full_like(p, ord("0")),
                               ord("0") + dig_at(p))
        out = put(m_int, int_char, out)
        out = put(plain_m & (p == ip_len[:, None]), ord("."), out)
        # fraction: s chars = zero padding (when nd < s) then trailing
        # digits
        fpos = p - ip_len[:, None] - 1
        pad = (s - nd.clamp(max=s))[:, None]
        fchar = torch.where(fpos < pad, torch.full_like(fpos, ord("0")),
                            ord("0") + dig_at(ip_digits[:, None] + fpos
                                              - pad))
        m_frac = plain_m & (fpos >= 0) & (fpos < s)
        out = put(m_frac, fchar, out)
        len_plain = sign_len[:, 0] + ip_len + 1 + s
    else:
        len_plain = torch.zeros((n,), dtype=i32, device=dev)

    # ---- scientific: d[.frac]E±adj --------------------------------------
    msci = ~plain_m
    has_frac = nd > 1
    out = put(msci & (p == 0), ord("0") + dig[:, 0:1], out)
    out = put(msci & has_frac[:, None] & (p == 1), ord("."), out)
    spos = p - 2
    m_sf = msci & has_frac[:, None] & (spos >= 0) & (spos < (nd - 1)[:, None])
    out = put(m_sf, ord("0") + dig_at(1 + spos), out)
    e_at = torch.where(has_frac, nd + 1, torch.ones_like(nd))[:, None]
    out = put(msci & (p == e_at), ord("E"), out)
    out = put(msci & (p == e_at + 1),
              torch.where((adjusted < 0)[:, None],
                          torch.full_like(out, ord("-")),
                          torch.full_like(out, ord("+"))), out)
    absA = adjusted.abs()[:, None]
    a_len = 1 + (absA >= 10).to(i32)  # |adjusted| < 45 + 38 < 100
    a_digs = torch.cat([absA // 10 % 10, absA % 10], dim=1)
    ap = p - e_at - 2
    m_a = msci & (ap >= 0) & (ap < a_len)
    out = put(m_a, ord("0") + torch.gather(
        a_digs, 1, (2 - a_len + ap).clamp(0, 1).long()), out)
    len_sci = (sign_len[:, 0] + torch.where(has_frac, nd + 1,
                                            torch.ones_like(nd))
               + 2 + a_len[:, 0])

    return finish(out, torch.where(plain, len_plain, len_sci))
