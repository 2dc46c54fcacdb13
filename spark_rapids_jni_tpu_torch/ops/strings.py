"""String expressions of the string-heavy flagship (BASELINE.md #4).

Counterpart of ``spark_rapids_jni_tpu/ops/strings.py``.  Semantics follow
Spark's ``UTF8String.substringSQL`` (character-based, 1-based positions,
negative position counts from the end, window clamped to the string):

    substring('abc',  -5, 3) -> 'a'    (window [-2, 1) clamps to [0, 1))
    substring('abcd', -2, 3) -> 'cd'
    substring('abc',   0, 2) -> 'ab'   (pos 0 behaves like 1)
"""

from __future__ import annotations

import torch

from ..columnar.column import StringColumn
from ._util import row_cumsum
from .regex_rewrite import utf8_starts

# what ``engine='auto'`` means on a CUDA tensor: the engine that won the
# H100 measurement of qstr's substring at 2^20 rows x 404 bytes
# (chip_smoke.py's qstr phase times both in turns; PERF.md records it:
# the segmented sort beat the scatter's int64 index passes).  On the
# CPU 'auto' is 'scatter' (linear, where a per-row stable sort is not).
AUTO_ON_CUDA = "sort"


def resolve_engine(engine: str, device: torch.device) -> str:
    if engine == "auto":
        engine = AUTO_ON_CUDA if device.type == "cuda" else "scatter"
    if engine not in ("scatter", "sort"):
        raise ValueError(f"unknown compaction engine {engine!r}")
    return engine


def left_compact_rows(mat: torch.Tensor, keep: torch.Tensor,
                      engine: str = "auto"):
    """Stable left-compaction of kept cells per row; returns
    ``(compacted, counts)`` with the tail beyond each row's count zeroed.

    ``'scatter'``: rank the kept cells with one masked cumsum and invert
    the destination map with one scatter (column ``L`` takes the
    discarded cells).  ``'sort'``: a stable per-row argsort of the drop
    flags.  Both give the same bytes.
    """
    engine = resolve_engine(engine, mat.device)
    n, L = mat.shape
    counts = keep.sum(dim=1).to(torch.int32)
    if engine == "scatter":
        ki = keep.to(torch.int64)
        within = torch.cumsum(ki, dim=1) - ki          # rank among kept
        dest = torch.where(keep, within, torch.full_like(within, L))
        cols = torch.arange(L, dtype=torch.int64,
                            device=mat.device).expand(n, L)
        src = torch.full((n, L + 1), L, dtype=torch.int64,
                         device=mat.device).scatter_(1, dest, cols)[:, :L]
        padded = torch.cat(
            [mat, torch.zeros((n, 1), dtype=mat.dtype, device=mat.device)],
            dim=1)                                     # col L reads as 0
        out = torch.gather(padded, 1, src)
    else:
        order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
        out = torch.gather(mat, 1, order)
    pos = torch.arange(L, dtype=torch.int32, device=mat.device)[None, :]
    out = torch.where(pos < counts[:, None], out, torch.zeros_like(out))
    return out, counts


def substring(col: StringColumn, pos: int, length: int = -1,
              engine: str = "auto") -> StringColumn:
    """Character-based Spark substring; ``length < 0`` means "to the end".

    Works on the padded byte matrix: UTF-8 start bytes give each byte a
    character index (continuation bytes inherit their start byte's
    index), the [start, end) character window selects bytes, and
    :func:`left_compact_rows` left-compacts the survivors.  The result
    keeps the input's width.
    """
    from ..columnar.bucketed import BucketedStringColumn

    if isinstance(col, BucketedStringColumn):
        return col.apply(lambda b: substring(b, pos, length, engine))
    chars, lengths, validity = col.chars, col.lengths, col.validity
    n, L = chars.shape
    dev = chars.device
    posax = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_str = posax < lengths[:, None]

    is_start = utf8_starts(chars) & in_str
    # 0-based character index per byte (continuation bytes inherit)
    char_idx = row_cumsum(is_start) - 1
    nchars = is_start.sum(dim=1).to(torch.int32)

    if pos > 0:
        s0 = torch.full((n,), pos - 1, dtype=torch.int32, device=dev)
    elif pos < 0:
        s0 = nchars + pos
    else:
        s0 = torch.zeros((n,), dtype=torch.int32, device=dev)
    if length < 0:
        e0 = torch.full((n,), 2**31 - 1, dtype=torch.int32, device=dev)
    else:
        # window end BEFORE clamping the start (Spark: the negative-start
        # window loses the part hanging off the front of the string), in
        # int64: Spark's UTF8String.substringSQL clamps start + length to
        # the int range instead of wrapping, so substring(s, 5, 2**31 - 1)
        # runs to the end of s
        e0 = s0.to(torch.int64) + length
    lo = s0.clamp(min=0)

    keep = in_str & (char_idx >= lo[:, None]) & (char_idx < e0[:, None])
    out, out_len = left_compact_rows(chars, keep, engine)
    return StringColumn(out, torch.where(validity, out_len,
                                         torch.zeros_like(out_len)),
                        validity)
