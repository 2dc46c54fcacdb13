"""PyTorch port: ``ops/strings.py`` (``substring``, ``left_compact_rows``)
and ``ops/regex_rewrite.py`` (``literal_range_pattern``, the UTF-8
decode) against the JAX package on the same numpy-seeded strings.
Bytes, lengths and validity must be bit-identical, on both compaction
engines of each package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops import regex_rewrite as JR
from spark_rapids_jni_tpu.ops import strings as JS

from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops import regex_rewrite as TR
from spark_rapids_jni_tpu_torch.ops import strings as TS

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

POOL = ["", "a", "abc", "amya123", "été", "a9b8", "ß-utf8-ä", "xa0ya",
        "日本語テキスト", "a" * 40, "0123456789", "𝄞a1", "aa11aa", "Z"]


def _values(seed, n=96, null=0.1):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < null else
            POOL[rng.integers(0, len(POOL))] for _ in range(n)]


def _pair(values, pad=8):
    return (JString.from_pylist(values, pad_to_multiple=pad),
            StringColumn.from_pylist(values, pad_to_multiple=pad,
                                     device="cpu"))


def _same(j, t):
    np.testing.assert_array_equal(t.chars.numpy(), np.asarray(j.chars))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))


@pytest.fixture(scope="module")
def cols():
    return _pair(_values(3))


def test_decode_utf8_matches(cols):
    jc, tc = cols
    for a, b in zip(JR._decode_utf8(jc.chars), TR._decode_utf8(tc.chars)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("pos,length", [(1, 3), (4, 8), (0, 2), (-2, 3),
                                        (-5, 3), (2, -1), (-1, -1),
                                        (10, 5), (3, 0)])
@pytest.mark.parametrize("engine", ["scatter", "sort"])
def test_substring_bit_for_bit(cols, pos, length, engine):
    jc, tc = cols
    _same(JS.substring(jc, pos, length), TS.substring(tc, pos, length,
                                                      engine))


# Windows whose end start + length passes 2**31 - 1: Spark's
# UTF8String.substringSQL clamps the end, and so does the port. The
# reference computes the end in int32 and wraps to an empty result
# (ROADMAP queue 3, item 8), so these hold the port against the reference
# test file's Spark oracle instead of the reference.
@pytest.mark.parametrize("s,pos,length,want", [
    ("abcdefgh", 5, 2**31 - 1, "efgh"), ("abcdefgh", -3, 2**31 - 1, "fgh"),
    ("日本語テキスト", 2, 2**31 - 2, "本語テキスト"),
    ("abc", -5, 2**31 - 1, "abc")])
@pytest.mark.parametrize("engine", ["scatter", "sort"])
def test_substring_window_end_past_int32(s, pos, length, want, engine):
    from test_strings import oracle

    assert oracle(s, pos, length) == want
    col = StringColumn.from_pylist([s, None], pad_to_multiple=8,
                                   device="cpu")
    assert TS.substring(col, pos, length, engine).to_pylist() == [want, None]


@pytest.mark.parametrize("literal,rlen,lo,hi", [
    ("a", 1, ord("0"), ord("9")), ("a", 2, ord("0"), ord("9")),
    ("ya", 1, ord("a"), ord("z")), ("é", 1, 0, 0x10FFFF),
    ("", 3, ord("0"), ord("9")), ("aa", 2, ord("1"), ord("1")),
    ("-", 4, ord("a"), ord("z"))])
def test_literal_range_pattern_bit_for_bit(cols, literal, rlen, lo, hi):
    jc, tc = cols
    j = JR.literal_range_pattern(jc, literal, rlen, lo, hi)
    t = TR.literal_range_pattern(tc, literal, rlen, lo, hi)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))


@pytest.mark.parametrize("seed,L,p", [(0, 1, 0.5), (1, 7, 0.3),
                                      (2, 64, 0.9), (3, 33, 0.0),
                                      (4, 16, 1.0)])
def test_left_compact_rows_engines_agree(seed, L, p):
    rng = np.random.default_rng(seed)
    n = 50
    mat = rng.integers(1, 256, (n, L)).astype(np.uint8)
    keep = rng.random((n, L)) < p
    want = [JS.left_compact_rows(jnp.asarray(mat), jnp.asarray(keep), e)
            for e in ("scatter", "sort")]
    np.testing.assert_array_equal(np.asarray(want[0][0]),
                                  np.asarray(want[1][0]))
    for e in ("scatter", "sort", "auto"):
        out, cnt = TS.left_compact_rows(torch.from_numpy(mat),
                                        torch.from_numpy(keep), e)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want[0][0]))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[0][1]))


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        TS.left_compact_rows(torch.zeros((1, 2), dtype=torch.uint8),
                             torch.ones((1, 2), dtype=torch.bool), "magic")


def test_auto_is_scatter_on_the_cpu():
    assert TS.resolve_engine("auto", torch.device("cpu")) == "scatter"
    assert TS.resolve_engine("auto", torch.device("cuda")) == \
        TS.AUTO_ON_CUDA


@pytest.mark.parametrize("L", [1, 2, 3, 7, 64, 100, 129])
def test_row_scans_doubling_equals_torch(monkeypatch, L):
    from spark_rapids_jni_tpu_torch.ops import _util

    monkeypatch.setattr(_util, "_DOUBLING_MIN_NUMEL", 1)
    g = torch.Generator().manual_seed(L)
    x = torch.randint(-5, 50, (9, L), generator=g, dtype=torch.int32)
    b = torch.rand((9, L), generator=g) < 0.5
    assert torch.equal(_util.row_cummax(x), torch.cummax(x, 1).values)
    assert torch.equal(_util.row_cumsum(b),
                       torch.cumsum(b, 1, dtype=torch.int32))
    assert torch.equal(_util.row_cumsum(x, torch.int64),
                       torch.cumsum(x, 1, dtype=torch.int64))
