"""Spark-exact string -> numeric casts, and integers to strings in a base.

Counterpart of ``spark_rapids_jni_tpu/ops/cast_string.py``; the behavioral
contract is the reference kernels' (``cast_string.cu:159-246``
string->int, ``cast_string_to_float.cu:58-658`` string->float,
``cast_string.cu:247-582`` string->decimal, ``CastStringJni.cpp:159-259``
``conv()``), quirks included:

* whitespace = C0 control codes (<= 0x1F) plus space (``is_whitespace``);
* string->int truncates at a decimal point in non-ANSI mode but still
  validates the characters after it ("20.5" -> 20, "7.8.3" -> null), and a
  bare "." parses as 0;
* string->float keeps at most 19 significant digits (further digits become
  trailing zeros of the exponent), loses values whose first 19 counted
  digits are all zeros ("0.0000000000000000000123" -> 0.0), accepts one
  trailing f/F/d/D after a nonzero number but NOT after a zero ("1f" -> 1.0
  but "0f" -> null), treats "nan" with junk as an ANSI error but "inf" with
  junk as a plain null, and rejects "-nan";
* the final float value is assembled in float64 arithmetic (digits * 10^exp)
  as the reference does, so last-ulp behavior matches the GPU path rather
  than a correctly-rounded strtod.

The reference's per-character ``fori_loop`` state machines are Python
loops over the padded width here, each step a handful of vector ops over
the rows; the float cast is positional (masks and cumulative sums over
the char axis).  u64 values ride in int64 tensors (:mod:`.._u64`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u64 as U
from ..columnar import types as T
from ..columnar.column import Column, Decimal128Column, StringColumn
from ._util import char_at as _char_at
from ._util import first_true as _first_true
from ._util import is_digit as _is_digit
from ._util import is_ws as _is_ws
from ._util import device_table, host_table, row_cumsum
from ._util import strip_and_sign


class CastException(RuntimeError):
    """ANSI-mode cast failure; carries the first offending row.

    Mirrors the reference ``CastException`` (cast_string.hpp:28-58), which
    reports the first invalid string and its row index.
    """

    def __init__(self, string_with_error: str, row_with_error: int):
        super().__init__(
            f"Error casting data on row {row_with_error}: {string_with_error}"
        )
        self.string_with_error = string_with_error
        self.row_with_error = row_with_error


_INT_BOUNDS = {
    T.Kind.INT8: (-(2**7), 2**7 - 1),
    T.Kind.INT16: (-(2**15), 2**15 - 1),
    T.Kind.INT32: (-(2**31), 2**31 - 1),
    T.Kind.INT64: (-(2**63), 2**63 - 1),
}


def _digit64(c: torch.Tensor) -> torch.Tensor:
    """``c - '0'`` as the reference forms it: u8 wrap, then int64."""
    return ((c.to(torch.int64) - ord("0")) & 0xFF)


def string_to_integer(col: StringColumn, dtype: T.SparkType,
                      ansi_mode: bool = False, strip: bool = True) -> Column:
    """Spark-exact string -> int8/16/32/64 (reference cast_string.cu:159).

    Scans characters left to right with the reference's exact state
    machine: optional stripped whitespace, one optional sign, digits with
    incremental overflow checks (accumulating negatively for '-', so MIN
    values parse), '.'-truncation in non-ANSI mode, trailing whitespace
    (strip only), everything else invalid.
    """
    kind = dtype.kind
    if kind not in _INT_BOUNDS:
        raise TypeError(f"not an integer type: {dtype!r}")
    tmin, tmax = _INT_BOUNDS[kind]

    chars, lengths = col.chars, col.lengths
    n, L = chars.shape
    dev = chars.device

    start, has_sign, negative = strip_and_sign(chars, lengths, strip)
    valid0 = col.validity & (lengths > 0) & (start < lengths)

    min_div10 = int(tmin / 10)  # C truncation toward zero
    max_div10 = tmax // 10

    val = torch.zeros((n,), dtype=torch.int64, device=dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    truncating = torch.zeros((n,), dtype=torch.bool, device=dev)
    trailing_ws = torch.zeros_like(truncating)
    seen = torch.zeros_like(truncating)
    for j in range(L):
        c = chars[:, j]
        active = valid0 & valid & (j >= start) & (j < lengths)
        is_d = _is_digit(c)
        ws = _is_ws(c)

        # ordered rules from the reference scan loop
        kill_after_ws = trailing_ws & ~ws
        to_truncate = (~truncating & (c == ord(".")) & (not ansi_mode)
                       & ~kill_after_ws)
        plain = ~kill_after_ws & ~to_truncate
        allowed_ws = ws & (start != j) & strip
        to_trailing = plain & ~is_d & allowed_ws
        invalid_char = plain & ~is_d & ~allowed_ws

        digit = _digit64(c)
        first = ~seen
        # accumulate toward -inf for negatives so MIN parses (reference
        # process_value: adding=sign>0)
        mul_ovf = ~first & torch.where(negative, val < min_div10,
                                       val > max_div10)
        val10 = torch.where(first, val, val * 10)
        add_ovf = torch.where(negative, val10 < tmin + digit,
                              val10 > tmax - digit)
        ovf = mul_ovf | add_ovf
        newval = torch.where(negative, val10 - digit, val10 + digit)

        do_digit = active & plain & is_d & ~truncating & ~trailing_ws
        val = torch.where(do_digit & ~ovf, newval, val)
        seen = seen | do_digit
        valid = valid & ~(active & (kill_after_ws | invalid_char
                                    | (do_digit & ovf)))
        truncating = truncating | (active & to_truncate)
        trailing_ws = trailing_ws | (active & to_trailing)
    valid = valid0 & valid

    out = Column(val.to(dtype.torch_dtype), valid, dtype)
    if ansi_mode:
        _raise_on_invalid(col, col.validity & ~valid)
    return out


def _raise_on_invalid(col: StringColumn, bad: torch.Tensor):
    """ANSI mode: surface the first failed row as a CastException (one
    host read).  ``bad`` holds only rows that were non-null on input: a
    null input row stays null, it is not an error (reference
    CastStringJni ANSI handling)."""
    bad = bad.cpu().numpy()
    if bad.any():
        row = int(np.argmax(bad))
        n = int(col.lengths[row])
        s = bytes(col.chars[row, :n].cpu().numpy()).decode("utf-8",
                                                           "replace")
        raise CastException(s, row)


# ---------------------------------------------------------------------------
# string -> float
# ---------------------------------------------------------------------------

# correctly-rounded signed powers of ten: 1e-340 .. 1e309 (inf past the top,
# 0.0 past the bottom), indexed by e + _POW10_OFF
_POW10_OFF = 340
host_table("pow10_f64", np.asarray(
    [float(f"1e{k}") for k in range(-_POW10_OFF, 310)], dtype=np.float64))
host_table("pow10_u64", np.asarray([10**k for k in range(0, 19)],
                                   dtype=np.uint64))
host_table("pow10_i32_4", np.asarray([1, 10, 100, 1000], dtype=np.int32))
host_table("pow10_i64", np.asarray([10**k for k in range(19)],
                                   dtype=np.int64))
# exact float64 powers 1e0 .. 1e19 for the digit count of a float value
_POW10_EXACT = tuple(float(10**k) for k in range(1, 20))


def _pow10f(e: torch.Tensor) -> torch.Tensor:
    """10.0**e in float64 (the reference computes exp10() in double)."""
    tab = device_table("pow10_f64", e.device)
    return tab[(e + _POW10_OFF).clamp(0, _POW10_OFF + 309).long()]


def _all_ws_from(chars, lengths, pos):
    """True where every char in [pos, len) is whitespace."""
    idx = torch.arange(chars.shape[1], device=chars.device)[None, :]
    region = (idx >= pos[:, None]) & (idx < lengths[:, None])
    return ~(region & ~_is_ws(chars)).any(dim=1)


def _run_from(ok: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``run[j]``: every position in ``[start, j]`` is ``ok`` (positions
    before ``start`` count as ok), the reference's ``cumprod``."""
    idx = torch.arange(ok.shape[1], device=ok.device)[None, :]
    bad = (idx >= start[:, None]) & ~ok
    return row_cumsum(bad) == 0


def _float_digits10(f: torch.Tensor) -> torch.Tensor:
    """``floor(log10(f)) + 1`` for a float64 ``f`` in ``[1, 2**64)``,
    exactly, by comparisons with the exact float64 powers of ten."""
    nd = torch.ones(f.shape, dtype=torch.int32, device=f.device)
    for p in _POW10_EXACT:
        nd = nd + (f >= p).to(torch.int32)
    return nd


def string_to_float(col: StringColumn, dtype: T.SparkType,
                    ansi_mode: bool = False) -> Column:
    """Spark-exact string -> float32/float64 (reference cast_string_to_float.cu).

    Fully positional: leading/trailing regions, the digit+dot run, the
    19-significant-digit budget, and the optional exponent are all derived
    with masks and cumulative sums over the padded char axis.
    """
    if dtype.kind not in (T.Kind.FLOAT32, T.Kind.FLOAT64):
        raise TypeError(f"not a float type: {dtype!r}")

    chars, lengths = col.chars, col.lengths
    n, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, device=dev)[None, :]
    in_range = idx < lengths[:, None]

    s, has_sign, negative = strip_and_sign(chars, lengths, strip=True)
    one = torch.ones((n,), dtype=torch.float64, device=dev)
    sign = torch.where(negative, -one, one)

    base_valid = col.validity & (lengths > 0)

    def lc_at(pos):
        return _char_at(chars, pos) | 0x20

    def match(pos, word):
        m = torch.ones((n,), dtype=torch.bool, device=dev)
        for k, ch in enumerate(word):
            m = m & (lc_at(pos + k) == ord(ch))
        return m

    # ---- nan ----------------------------------------------------------
    is_nan_word = match(s, "nan") & (s + 3 <= lengths)
    nan_clean = _all_ws_from(chars, lengths, s + 3)
    nan_ok = is_nan_word & nan_clean & ~negative
    nan_bad = is_nan_word & ~(nan_clean & ~negative)  # ANSI error (ref :239-266)

    # ---- inf / infinity ----------------------------------------------
    is_inf3 = match(s, "inf") & (s + 3 <= lengths) & ~is_nan_word
    is_inf8 = is_inf3 & match(s + 3, "inity") & (s + 8 <= lengths)
    inf_end = torch.where(is_inf8, s + 8, s + 3)
    inf_clean = _all_ws_from(chars, lengths, inf_end)
    inf_ok = is_inf3 & inf_clean
    # a bad inf (is_inf3 & ~inf_clean) is a plain null, NOT an ANSI error
    # (ref :286-327)

    word_path = is_nan_word | is_inf3

    # ---- digit run [s, q) --------------------------------------------
    digit = _is_digit(chars)
    dot = chars == ord(".")
    ok = (digit | dot) & in_range
    run = _run_from(ok, s) & (idx >= s[:, None])
    run_len = run.sum(dim=1).to(torch.int32)
    q = s + run_len

    ndots = (dot & run).sum(dim=1)
    multi_dot = ndots > 1
    has_dot = ndots == 1
    dot_pos = torch.where(has_dot, _first_true(dot & run), q)

    digit_in_run = digit & run
    any_digit = digit_in_run.any(dim=1)

    # counted digits: post-dot digits always count; pre-dot digits count
    # from the first nonzero on (leading-zero strip, ref :345-361)
    nz_pre = digit_in_run & (chars != ord("0")) & (idx < dot_pos[:, None])
    any_nz_pre = nz_pre.any(dim=1)
    first_nz_pre = torch.where(any_nz_pre, _first_true(nz_pre), q)
    counted = digit_in_run & ((idx > dot_pos[:, None])
                              | (idx >= first_nz_pre[:, None]))
    total_counted = counted.sum(dim=1).to(torch.int32)
    real = total_counted.clamp(max=19)
    truncated = total_counted - real

    # value of the first 19 counted digits (u64 bits), by per-digit rank
    rank = row_cumsum(counted)  # 1-based at digits
    contrib_mask = counted & (rank <= 19)
    exp_k = (real[:, None] - rank).clamp(0, 18)
    p10 = device_table("pow10_u64", dev)[exp_k.long()]
    digits = torch.where(contrib_mask, _digit64(chars) * p10,
                         torch.zeros_like(p10)).sum(dim=1)

    decimal_pos_counted = (counted & (idx < dot_pos[:, None])).sum(
        dim=1).to(torch.int32)
    exp_base = truncated - torch.where(
        has_dot, total_counted - decimal_pos_counted,
        torch.zeros_like(total_counted))

    # ---- manual exponent ---------------------------------------------
    has_e = (lc_at(q) == ord("e")) & (q < lengths)
    esc = _char_at(chars, q + 1)
    has_esign = has_e & ((esc == ord("+")) | (esc == ord("-")))
    eneg = has_esign & (esc == ord("-"))
    ed_start = q + 1 + has_esign.to(torch.int32)
    # leading digit run after the exponent marker, capped at 4 digits read
    ed_ok = _run_from(digit & in_range, ed_start)
    ed_run_len = (ed_ok & (idx >= ed_start[:, None])).sum(dim=1).to(
        torch.int32)
    ed_count = ed_run_len.clamp(max=4)
    e_digit_mask = ((idx >= ed_start[:, None])
                    & (idx < (ed_start + ed_count)[:, None]))
    e_rank = row_cumsum(e_digit_mask)
    e_pow = device_table("pow10_i32_4", dev)
    e_val = torch.where(
        e_digit_mask,
        _digit64(chars).to(torch.int32)
        * e_pow[(ed_count[:, None] - e_rank).clamp(0, 3).long()],
        torch.zeros((), dtype=torch.int32, device=dev)).sum(dim=1)
    zero_i = torch.zeros_like(e_val)
    manual_exp = torch.where(has_e, torch.where(eneg, -e_val, e_val), zero_i)
    exp_bad = has_e & (ed_count == 0)  # "1e" / "1e+" -> ANSI error (:533)
    after_exp = torch.where(has_e, ed_start + ed_count, q)

    # ---- zero-value quirk path ---------------------------------------
    is_zero = digits == 0
    zero_clean = _all_ws_from(chars, lengths, after_exp)  # no f/d allowed
    # ---- nonzero trailing: one optional f/F/d/D then whitespace ------
    tc = lc_at(after_exp)
    has_fd = ((tc == ord("f")) | (tc == ord("d"))) & (after_exp < lengths)
    after_fd = after_exp + has_fd.to(torch.int32)
    tail_clean = _all_ws_from(chars, lengths, after_fd)

    num_invalid = (multi_dot | ~any_digit | exp_bad
                   | (is_zero & ~zero_clean) | (~is_zero & ~tail_clean))
    num_ok = ~word_path & ~num_invalid

    # ---- final value (float64 arithmetic, reference :154-197) --------
    digits_f = U.to_f64(digits)
    digitsf = sign * digits_f
    exp_ten = (exp_base + manual_exp).to(torch.int32)
    # subnormal pre-scaling (reference :181-189)
    sub_shift = -307 - exp_ten
    num_digits10 = torch.where(is_zero, torch.ones_like(exp_ten),
                               _float_digits10(digits_f))
    sub_digitsf = digitsf / _pow10f(num_digits10 - 1 + sub_shift)
    sub_exp = exp_ten + num_digits10 - 1
    sub_val = sub_digitsf * _pow10f(sub_exp + sub_shift)
    plain_pow = _pow10f(exp_ten.abs())
    plain_val = torch.where(exp_ten < 0, digitsf / plain_pow,
                            digitsf * plain_pow)
    number = torch.where(exp_ten > 308, sign * float("inf"),
                         torch.where(sub_shift > 0, sub_val, plain_val))
    number = torch.where(is_zero, sign * 0.0, number)

    value = torch.where(nan_ok, torch.full_like(number, float("nan")),
                        torch.where(inf_ok, sign * float("inf"), number))
    valid = base_valid & (nan_ok | inf_ok | num_ok)
    out = Column(value.to(dtype.torch_dtype), valid, dtype)
    if ansi_mode:
        # digit-path errors (including empty/all-whitespace strings, which
        # fail the seen-valid-digit check, ref :400-405) and nan-with-junk
        # raise; a bad inf is a plain null without an exception
        _raise_on_invalid(col, col.validity
                          & (nan_bad | (~word_path & num_invalid)))
    return out


# ---------------------------------------------------------------------------
# string -> decimal
# ---------------------------------------------------------------------------

def string_to_decimal(col: StringColumn, precision: int, scale: int,
                      ansi_mode: bool = False,
                      strip: bool = True) -> Decimal128Column:
    """Spark-exact string -> decimal (reference cast_string.cu:247-582).

    ``scale`` follows the cudf/JNI convention of the reference API: negative
    scale means fraction digits (``string_to_decimal(precision=3, scale=-1)``
    of "9.23" gives unscaled 92).  The returned column's SparkType carries
    the Spark-style scale (``-scale``); the unscaled value is sign-extended
    into the port's 128-bit limbs.

    Semantics replicated from the two-phase reference kernel:

    * phase A validates (optional stripped whitespace, sign, digits, one
      '.', exponent with sign) and finds the virtual decimal location =
      (digit count before '.'|'e'|ws) + exponent.  Quirks preserved: a bare
      trailing "e" or "e+" is VALID with exponent 0, "1e5 " is invalid
      (nothing may follow exponent digits), "." parses as 0.
    * phase B walks digits accumulating into the storage type, rounding
      half-up (away from zero) at the first digit beyond ``precision`` or
      beyond ``decimal_location - scale``, tracking whether rounding added
      a digit (999 -> 1000), then zero-pads up to the decimal location and
      down to the scale, failing on overflow or when more integer digits
      are required than ``precision + scale`` allows.

    Only precision <= 18 (decimal32/64 storage) is supported, as in the
    reference.
    """
    if precision > 18:
        raise NotImplementedError(
            "string_to_decimal with precision > 18 needs decimal128 limb math"
        )
    if precision <= 9:
        tmin, tmax = -(2**31), 2**31 - 1
    else:
        tmin, tmax = -(2**63), 2**63 - 1

    chars, lengths = col.chars, col.lengths
    n, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, device=dev)[None, :]
    in_range = idx < lengths[:, None]
    i64 = dict(dtype=torch.int64, device=dev)

    first_digit, has_sign, _neg = strip_and_sign(chars, lengths, strip)
    positive = ~_neg
    base_valid = col.validity & (lengths > 0) & (first_digit < lengths)

    # state machine over [first_digit, len): states as in the reference
    (ST_DIGITS, ST_EXP_OR_SIGN, ST_EXP_SIGN, ST_EXP, ST_TRAIL_WS,
     ST_INVALID) = range(6)
    min_div10 = int(tmin / 10)
    max_div10 = tmax // 10

    def const(v, like):
        return torch.full_like(like, v)

    state = torch.full((n,), ST_DIGITS, dtype=torch.int32, device=dev)
    dot_rel = torch.full((n,), -1, dtype=torch.int32, device=dev)
    exp_val = torch.zeros((n,), **i64)
    exp_pos = torch.ones((n,), dtype=torch.bool, device=dev)
    last_digit = torch.full((n,), -1, dtype=torch.int32, device=dev)
    seen_exp_digit = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(L):
        c = chars[:, j]
        active = base_valid & (j >= first_digit) & (j < lengths)
        rel = j - first_digit  # chr_idx in the reference
        is_d = _is_digit(c)
        ws = _is_ws(c)
        allowed_ws = ws & (rel != 0) & strip

        in_digits = state == ST_DIGITS
        to_decimal = in_digits & (c == ord(".")) & (dot_rel < 0)
        to_exp_or_sign = in_digits & ((c == ord("e")) | (c == ord("E")))
        to_trail_from_digits = (in_digits & ~is_d & ~to_decimal
                                & ~to_exp_or_sign & allowed_ws)
        digits_invalid = (in_digits & ~is_d & ~to_decimal & ~to_exp_or_sign
                          & ~allowed_ws)

        in_eos = state == ST_EXP_OR_SIGN
        eos_sign = in_eos & ((c == ord("+")) | (c == ord("-")))
        eos_trail = in_eos & ~eos_sign & allowed_ws
        eos_digit = in_eos & ~eos_sign & ~eos_trail & is_d
        eos_invalid = in_eos & ~eos_sign & ~eos_trail & ~is_d

        in_exp = (state == ST_EXP) | (state == ST_EXP_SIGN)
        exp_digit = in_exp & is_d
        exp_invalid = in_exp & ~is_d

        trail_invalid = (state == ST_TRAIL_WS) & ~ws

        new_state = torch.where(
            to_decimal | (in_digits & is_d), const(ST_DIGITS, state),
            torch.where(
                to_exp_or_sign, const(ST_EXP_OR_SIGN, state),
                torch.where(
                    eos_sign, const(ST_EXP_SIGN, state),
                    torch.where(
                        eos_digit | exp_digit, const(ST_EXP, state),
                        torch.where(to_trail_from_digits | eos_trail,
                                    const(ST_TRAIL_WS, state), state)))))
        invalid_now = digits_invalid | eos_invalid | exp_invalid \
            | trail_invalid
        new_state = torch.where(invalid_now, const(ST_INVALID, state),
                                new_state)
        # decimal location: index (relative) of the '.'
        dot_rel = torch.where(active & to_decimal, rel, dot_rel)
        # leaving DIGITS (state was digits, new is exp-or-sign or
        # trailing): record the end of the digit run (reference :353-356)
        leaving = in_digits & (to_exp_or_sign | to_trail_from_digits)
        last_digit = torch.where(active & leaving, const(j, last_digit),
                                 last_digit)
        exp_pos = torch.where(active & eos_sign & (c == ord("-")),
                              torch.zeros_like(exp_pos), exp_pos)

        # exponent accumulation with the same overflow rules as digits
        d = _digit64(c)
        is_exp_dig = active & (eos_digit | exp_digit)
        first = ~seen_exp_digit
        mul_ovf = ~first & torch.where(exp_pos, exp_val > max_div10,
                                       exp_val < min_div10)
        e10 = torch.where(first, exp_val, exp_val * 10)
        add_ovf = torch.where(exp_pos, e10 > tmax - d, e10 < tmin + d)
        newexp = torch.where(exp_pos, e10 + d, e10 - d)
        new_state = torch.where(is_exp_dig & (mul_ovf | add_ovf),
                                const(ST_INVALID, state), new_state)
        exp_val = torch.where(is_exp_dig & ~(mul_ovf | add_ovf), newexp,
                              exp_val)
        seen_exp_digit = seen_exp_digit | is_exp_dig

        state = torch.where(active, new_state, state)

    a_valid = base_valid & (state != ST_INVALID)
    last_digit_abs = torch.where(last_digit < 0, lengths.to(torch.int32),
                                 last_digit)
    dec_loc = torch.where(dot_rel >= 0, dot_rel.to(torch.int64),
                          (last_digit_abs - first_digit).to(torch.int64))
    dec_loc = dec_loc + exp_val

    # ---- significant digits before the decimal location (ref :425-441)
    digit = _is_digit(chars)
    after_first = (idx >= first_digit[:, None]) & in_range
    # stop at e/E
    is_e = (chars == ord("e")) | (chars == ord("E"))
    before_e = row_cumsum(is_e & after_first) == 0
    scan_region = after_first & before_e
    digits_found = row_cumsum(digit & scan_region, torch.int64)
    # digit qualifies if its ordinal <= dec_loc
    qualifying = digit & scan_region & (digits_found <= dec_loc[:, None])
    # significant = from first nonzero qualifying digit on
    nz_qual = qualifying & (chars != ord("0"))
    first_nzq = _first_true(nz_qual)
    sig_before_in_string = (qualifying & (idx >= first_nzq[:, None])).sum(
        dim=1).to(torch.int64)

    # ---- phase B: build the value with rounding ----------------------
    last_digit_cnt = dec_loc - scale  # digits to keep (reference :452)
    pow10_i64 = device_table("pow10_i64", dev)

    def count_digits(v):
        return torch.searchsorted(pow10_i64, v.abs(), right=True).to(
            torch.int32)

    val = torch.zeros((n,), **i64)
    total = torch.zeros((n,), **i64)
    precise = torch.zeros((n,), **i64)
    found_sig = torch.zeros((n,), dtype=torch.bool, device=dev)
    rounding = torch.zeros((n,), **i64)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    bvalid = torch.ones((n,), dtype=torch.bool, device=dev)
    dloc = dec_loc
    for j in range(L):
        c = chars[:, j]
        active = (a_valid & bvalid & ~done & (j >= first_digit)
                  & (j < lengths) & (last_digit_cnt >= 0))
        is_dot = c == ord(".")
        is_d = _is_digit(c)
        brk = active & ~is_dot & ~is_d
        done = done | brk
        process = active & is_d & ~brk

        d = _digit64(c)
        need_round = (precise + 1 > precision) | (total + 1 > last_digit_cnt)

        # rounding path (reference :474-512)
        inc_ovf = torch.where(positive, val > tmax - 1, val < tmin + 1)
        rounded = torch.where(positive, val + 1, val - 1)
        adds_digit = (val != 0) & (count_digits(rounded) > count_digits(val))
        do_round = process & need_round & (d >= 5)
        round_fail = do_round & inc_ovf
        val = torch.where(do_round & ~inc_ovf, rounded, val)
        grow = (do_round & ~inc_ovf & adds_digit).to(torch.int64)
        total = total + grow
        precise = precise + grow
        dloc = dloc + grow
        rounding = rounding + grow
        done = done | (process & need_round)
        bvalid = bvalid & ~round_fail

        # normal digit accumulation
        acc = process & ~need_round
        total = total + acc.to(torch.int64)
        newly_sig = found_sig | (total > dloc) | (d != 0)
        first = first_digit == j
        mul_ovf = ~first & torch.where(positive, val > max_div10,
                                       val < min_div10)
        v10 = torch.where(first, val, val * 10)
        add_ovf = torch.where(positive, v10 > tmax - d, v10 < tmin + d)
        ovf = acc & (mul_ovf | add_ovf)
        val = torch.where(acc & ~ovf, torch.where(positive, v10 + d, v10 - d),
                          val)
        precise = precise + (acc & newly_sig).to(torch.int64)
        found_sig = torch.where(acc, newly_sig, found_sig)
        bvalid = bvalid & ~ovf
        done = done | ovf

    # ---- padding & precision checks (reference :531-573) --------------
    zero = torch.zeros((n,), **i64)
    sig_preceding_zeros = torch.maximum(zero, -dloc)
    zeros_to_decimal = torch.maximum(
        zero, dloc - total - scale if scale > 0 else dloc - total)
    sig_before = sig_before_in_string + zeros_to_decimal + rounding
    fits = (precision + scale) >= sig_before

    # pad up to the decimal location: val *= 10 zeros_to_decimal times
    max_pad = int(precision + abs(scale) + 2)
    pad_ok = torch.ones((n,), dtype=torch.bool, device=dev)
    for k in range(max_pad):
        do = (k < zeros_to_decimal) & pad_ok
        ovf = torch.where(positive, val > max_div10, val < min_div10)
        val = torch.where(do & ~ovf, val * 10, val)
        precise = precise + (do & ~ovf).to(torch.int64)
        pad_ok = pad_ok & ~(do & ovf)

    digits_after = precise - sig_before + sig_preceding_zeros
    needed_after = torch.clamp(precision - sig_before, max=-scale)

    pad2_ok = torch.ones((n,), dtype=torch.bool, device=dev)
    for k in range(max_pad):
        do = ((digits_after + k) < needed_after) & pad2_ok
        ovf = torch.where(positive, val > max_div10, val < min_div10)
        val = torch.where(do & ~ovf, val * 10, val)
        pad2_ok = pad2_ok & ~(do & ovf)

    valid = a_valid & bvalid & fits & pad_ok & pad2_ok
    dtype = T.SparkType.decimal(precision, -scale)
    if precision <= 9:
        val = val.to(torch.int32).to(torch.int64)  # the decimal32 storage
    limbs = torch.stack([val, val >> 63], dim=1)
    out = Decimal128Column(limbs, valid, dtype)
    if ansi_mode:
        _raise_on_invalid(col, col.validity & ~valid)
    return out


# ---------------------------------------------------------------------------
# string <-> integer with base (Spark ``conv()``; reference
# CastStringJni.cpp:159-259 toIntegersWithBase / fromIntegersWithBase)
# ---------------------------------------------------------------------------

# the reference validity regexes use \s — cudf's [ \t\n\r\f\v]
_CONV_WS = (0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B)


def string_to_integer_with_base(col: StringColumn, dtype: T.SparkType,
                                base: int = 10,
                                ansi_mode: bool = False) -> Column:
    """Parse ``^\\s*(-?[digits]+).*`` per row; Spark ``conv()`` semantics.

    Mirrors reference ``CastStringJni.cpp:159-228``: rows are matched
    against the prefix regex; non-matching rows yield **0** (not null);
    all-whitespace/empty rows and input nulls yield null; a leading ``-``
    negates with wraparound in the unsigned bit pattern (``-510`` as
    UINT64 -> 18446744073709551106).  Junk after the digit run is ignored.
    The result column stores the unsigned bit pattern (the type system is
    signed; the JNI surface's UINT64 is the same 64 bits).  ``ansi_mode``
    is accepted for signature parity — the reference native code never
    reads it.
    """
    del ansi_mode
    if base not in (10, 16):
        raise ValueError(f"Bases supported 10, 16; Actual: {base}")
    chars, lengths = col.chars, col.lengths
    n, L = chars.shape
    dev = chars.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_str = pos < lengths[:, None]

    ws = torch.zeros_like(chars, dtype=torch.bool)
    for w in _CONV_WS:
        ws = ws | (chars == w)
    ws = ws & in_str
    # run of leading whitespace
    nws = (row_cumsum(~ws) == 0).sum(dim=1).to(
        torch.int32)

    start = torch.minimum(nws, lengths.clamp(min=1) - 1)
    first = torch.gather(chars, 1, start.long()[:, None])[:, 0]
    has_minus = (first == ord("-")) & (nws < lengths)
    dstart = nws + has_minus.to(torch.int32)

    lower = chars | 0x20
    is_dig = (chars >= ord("0")) & (chars <= ord("9"))
    dval = _digit64(chars)
    if base == 16:
        is_hex = (lower >= ord("a")) & (lower <= ord("f"))
        dval = torch.where(is_hex, lower.to(torch.int64) - ord("a") + 10,
                           dval)
        is_dig = is_dig | is_hex

    after = pos >= dstart[:, None]
    digit_mask = _run_from(is_dig & in_str, dstart) & after & in_str
    matched = digit_mask.any(dim=1)

    # u64 accumulation: the product's low half and the sum wrap alike in
    # the int64 carrier
    val = torch.zeros((n,), dtype=torch.int64, device=dev)
    for j in range(L):
        val = torch.where(digit_mask[:, j], val * base + dval[:, j], val)
    val = torch.where(has_minus & matched, -val, val)
    val = torch.where(matched, val, torch.zeros_like(val))

    all_ws = nws >= lengths  # includes empty strings
    valid = col.validity & ~all_ws
    return Column(val.to(dtype.torch_dtype), valid, dtype)


host_table("hex_digits", np.frombuffer(b"0123456789ABCDEF",
                                             dtype=np.uint8).copy())


def integer_to_string_with_base(col: Column, base: int = 10) -> StringColumn:
    """Format the unsigned bit pattern in base 10 or 16 (reference
    ``CastStringJni.cpp:229-259``).

    Base 16 emits minimal uppercase hex digits (cudf ``integers_to_hex``
    followed by the reference's leading-zero strip); base 10 emits the
    unsigned decimal of the stored bits (``strings::from_integers`` over
    the UINT64 column the paired cast produces).  Nulls propagate.
    """
    if base not in (10, 16):
        raise ValueError(f"Bases supported 10, 16; Actual: {base}")
    width_bytes = torch.empty((), dtype=col.dtype.torch_dtype).element_size()
    u = col.data.to(torch.int64)
    if width_bytes < 8:
        u = u & ((1 << (8 * width_bytes)) - 1)
    dev = u.device

    if base == 16:
        max_out = 2 * width_bytes
        shifted = torch.stack([(u >> (4 * k)) & 0xF for k in range(max_out)],
                              dim=1)
        kpos = torch.arange(max_out, dtype=torch.int32, device=dev)[None, :]
        ndig = ((shifted != 0).to(torch.int32) * (kpos + 1)).amax(dim=1)
        ndig = ndig.clamp(min=1)
        src = ndig[:, None] - 1 - kpos  # nibble index, msd first
        digit = torch.gather(shifted, 1, src.clamp(0, max_out - 1).long())
        hexd = device_table("hex_digits", dev)[digit]
        out = torch.where(kpos < ndig[:, None], hexd, torch.zeros_like(hexd))
        return StringColumn(out, ndig, col.validity)

    max_out = 20  # 2^64-1 has 20 decimal digits
    digs = torch.stack([U.umod(U.udiv(u, 10**k), 10) for k in range(max_out)],
                       dim=1)
    j = torch.arange(max_out, dtype=torch.int32, device=dev)[None, :]
    ndig = ((digs != 0).to(torch.int32) * (j + 1)).amax(dim=1).clamp(min=1)
    src = ndig[:, None] - 1 - j
    digit = torch.gather(digs, 1, src.clamp(0, max_out - 1).long())
    out = torch.where(j < ndig[:, None], (digit + ord("0")).to(torch.uint8),
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return StringColumn(out, ndig, col.validity)
