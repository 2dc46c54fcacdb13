"""Regex fast-path: ``literal[start-end]{len,}`` containment check.

Counterpart of ``spark_rapids_jni_tpu/ops/regex_rewrite.py`` (reference:
``regex_rewrite_utils.cu:65-121``, ``literal_range_pattern``).  The
plugin rewrites regexes of this shape into a direct scan instead of a
regex engine: does any position hold ``literal`` followed by at least
``len`` characters whose code points lie in ``[start, end]``?

Vectorized over (row, byte position): the literal match is ``m`` shifted
byte comparisons; the character-range run walks ``len`` steps of
per-position UTF-8 char-length gathers (characters, not bytes, as the
reference's ``utf8_to_codepoint`` counts them).
"""

from __future__ import annotations

import torch

from ..columnar import types as T
from ..columnar.column import Column, StringColumn
from ._util import shift_cols


def _decode_utf8(chars: torch.Tensor):
    """Per byte position: (codepoint, char byte length, is_char_start).

    Values at continuation-byte positions are garbage; ``is_start`` masks
    them.  Truncated sequences at the padded tail decode from zero pad
    bytes (harmless: the in-range check fails or the length mask cuts
    them).
    """
    b0, b1, b2, b3 = (shift_cols(chars, k).to(torch.int32)
                      for k in range(4))
    is1 = b0 < 0x80
    is2 = (b0 >= 0xC0) & (b0 < 0xE0)
    is3 = (b0 >= 0xE0) & (b0 < 0xF0)
    is4 = b0 >= 0xF0
    cp = torch.where(
        is1, b0,
        torch.where(
            is2, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
            torch.where(
                is3,
                ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))
    one = torch.ones_like(b0)
    clen = torch.where(is1, one, torch.where(is2, one * 2,
                                             torch.where(is3, one * 3,
                                                         one * 4)))
    is_start = is1 | is2 | is3 | is4
    return cp, clen, is_start


def utf8_starts(chars: torch.Tensor) -> torch.Tensor:
    """Per byte: does a UTF-8 character start here (:func:`_decode_utf8`'s
    ``is_start`` from the byte alone: not a ``10xxxxxx`` continuation)."""
    return (chars < 0x80) | (chars >= 0xC0)


def _char_len(chars: torch.Tensor) -> torch.Tensor:
    """:func:`_decode_utf8`'s ``clen`` from the byte alone (4 at a
    continuation byte, as there)."""
    b = chars
    return torch.where(
        b < 0x80, 1, torch.where((b >= 0xC0) & (b < 0xE0), 2, torch.where(
            (b >= 0xE0) & (b < 0xF0), 3, 4))).to(torch.uint8)


def literal_range_pattern(col: StringColumn, literal: str, range_len: int,
                          start: int, end: int) -> Column:
    """bool per row; nulls stay null (reference regex_rewrite_utils.cu:121).

    An ASCII range (``end < 0x80``) needs no decode: only a one-byte
    character's code point can fall in it, and that is the byte."""
    lit = literal.encode("utf-8")
    m = len(lit)
    chars, lengths = col.chars, col.lengths
    n, L = chars.shape
    pos = torch.arange(L, dtype=torch.int32, device=chars.device)[None, :]
    in_str = pos < lengths[:, None]

    if end < 0x80:
        ok_char = (chars >= start) & (chars <= end) & in_str
        clen = _char_len(chars)
    else:
        cp, clen, is_start = _decode_utf8(chars)
        ok_char = is_start & (cp >= start) & (cp <= end) & in_str

    # literal byte match at each starting byte position
    lit_match = utf8_starts(chars) & ((pos + m) <= lengths[:, None])
    for j, byte in enumerate(lit):
        lit_match = lit_match & (shift_cols(chars, j) == byte)

    # range run of `range_len` characters starting right after the
    # literal; the first step's cursor is every position plus m, a shift
    run_ok = torch.ones((n, L), dtype=torch.bool, device=chars.device)
    cursor = None
    for _ in range(range_len):
        if cursor is None:
            run_ok = run_ok & shift_cols(ok_char, m)
            # past the row's end the cursor stays >= L either way
            cursor = pos + m + shift_cols(clen, m).to(torch.int32)
            continue
        cur_clip = cursor.clamp(0, L - 1).long()
        ok_here = torch.gather(ok_char, 1, cur_clip) & (cursor < L)
        run_ok = run_ok & ok_here
        cursor = cursor + torch.gather(clen, 1, cur_clip).to(torch.int32)

    found = (lit_match & run_ok).any(dim=1)
    return Column(found & col.validity, col.validity, T.BOOLEAN)
