"""PyTorch port: ``ops/cast_string.py`` against the JAX package on the
same numpy-seeded strings: string -> int8..int64 (ANSI and not, strip and
not), -> float64/float32, -> decimal (onto the port's 128-bit limbs), and
``conv()``'s base-10/16 parse and format.  Values and validity must be
bit-identical, and ANSI mode must raise on the same row.

One deliberate difference: XLA on the CPU flushes subnormal float64 and
float32 results to zero, and the port (IEEE on the CPU and on CUDA, as
the reference's CUDA kernel is) keeps them.  The float checks compare the
port's result with its subnormals flushed against the JAX package bit
for bit, and hold the subnormals themselves against Python's parse."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops import cast_string as JC

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops import cast_string as TC

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

EDGE = ["12", " -34 ", "20.5", "7.8.3", ".", "9223372036854775807",
        "-9223372036854775808", "9223372036854775808",
        "-9223372036854775809", "1 2", "+5", "-", "", "   ", "127", "128",
        "-128", "-129", "32767", "2147483648", "\t42\n", "0x1F", "00012",
        "1e5", "1e", "1e+", "1e5 ", "1.5e-3", ".5", "5.", "-0", "+0.0",
        "nan", "NaN", "-nan", "nanx", "inf", "-Infinity", "infinity ",
        "infx", "1f", "0f", "1.5D", "1d ", "0.0000000000000000000123",
        "12345678901234567890123", "123456789012345678901234567890e-10",
        "1e309", "1e-400", "4.9e-324", "1e-320", "2.2250738585072014e-308",
        "1e-40", "3.4028235e38", "3.5e38", "9007199254740993",
        "1000000000000000e-330", "9.23", "-9.25", "999.995", "99999999.99",
        "0.000001", "  3.14159  ", "-0.5", "abc", "1_000", "١٢", "\x00",
        "1\x002", " \x1f7\x1f", "18446744073709551615", "ff", "FFx", "-510"]


def _strings(seed, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.integers(0, 6)
        if k == 0:
            out.append(None)
        elif k == 1:
            out.append(str(int(rng.integers(-10**18, 10**18))))
        elif k == 2:
            out.append(repr(float(rng.random() * 10.0 ** rng.integers(-30,
                                                                     30))))
        elif k == 3:
            out.append("%.*f" % (int(rng.integers(0, 6)),
                                 rng.normal() * 10.0 ** rng.integers(0, 9)))
        else:
            out.append(EDGE[rng.integers(0, len(EDGE))])
    return EDGE + [None] + out


@pytest.fixture(scope="module")
def cols():
    vals = _strings(7)
    return (JString.from_pylist(vals), StringColumn.from_pylist(
        vals, device="cpu"), vals)


def _same_col(j, t):
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


INT_TYPES = [(JT.INT8, TT.INT8), (JT.INT16, TT.INT16), (JT.INT32, TT.INT32),
             (JT.INT64, TT.INT64)]


@pytest.mark.parametrize("jt,tt", INT_TYPES, ids=lambda t: repr(t))
@pytest.mark.parametrize("strip", [True, False])
def test_string_to_integer_bit_for_bit(cols, jt, tt, strip):
    jc, tc, _ = cols
    _same_col(JC.string_to_integer(jc, jt, strip=strip),
              TC.string_to_integer(tc, tt, strip=strip))


def test_ansi_raises_on_the_same_row():
    vals = ["1", "2", None, " 3 ", "x4", "5"]
    with pytest.raises(JC.CastException) as je:
        JC.string_to_integer(JString.from_pylist(vals), JT.INT32,
                             ansi_mode=True)
    with pytest.raises(TC.CastException) as te:
        TC.string_to_integer(StringColumn.from_pylist(vals, device="cpu"),
                             TT.INT32, ansi_mode=True)
    assert (te.value.row_with_error, te.value.string_with_error) == (
        je.value.row_with_error, je.value.string_with_error)
    ok = ["1", None, "7.5", " -2"]
    _same_col(JC.string_to_integer(JString.from_pylist(ok), JT.INT64),
              TC.string_to_integer(StringColumn.from_pylist(ok,
                                                            device="cpu"),
                                   TT.INT64, ansi_mode=False))
    for bad in (["1.5", "nanx"], ["inf", " 1e"]):
        with pytest.raises(JC.CastException) as je:
            JC.string_to_float(JString.from_pylist(bad), JT.FLOAT64,
                               ansi_mode=True)
        with pytest.raises(TC.CastException) as te:
            TC.string_to_float(StringColumn.from_pylist(bad, device="cpu"),
                               TT.FLOAT64, ansi_mode=True)
        assert te.value.row_with_error == je.value.row_with_error


def _ftz(x: np.ndarray) -> np.ndarray:
    """Flush subnormals to signed zero, as XLA on the CPU does."""
    tiny = np.finfo(x.dtype).tiny
    sub = (x != 0) & (np.abs(x) < tiny)
    return np.where(sub, np.copysign(np.zeros_like(x), x), x)


@pytest.mark.parametrize("jt,tt,ity", [(JT.FLOAT64, TT.FLOAT64, np.int64),
                                       (JT.FLOAT32, TT.FLOAT32, np.int32)])
def test_string_to_float_bit_for_bit(cols, jt, tt, ity):
    jc, tc, vals = cols
    j = JC.string_to_float(jc, jt)
    t = TC.string_to_float(tc, tt)
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))
    got = t.data.numpy()
    np.testing.assert_array_equal(_ftz(got).view(ity),
                                  np.asarray(j.data).view(ity))
    # the subnormals the port keeps are the parse's own values
    tiny = np.finfo(got.dtype).tiny
    sub = np.nonzero((got != 0) & (np.abs(got) < tiny))[0]
    assert sub.size > 0
    for i in sub:
        assert got[i] == got.dtype.type(float(vals[i].strip())), vals[i]


@pytest.mark.parametrize("precision,scale", [(3, -1), (5, 2), (9, 0),
                                             (10, -2), (18, -4), (18, 3),
                                             (1, 0), (7, -7)])
def test_string_to_decimal_bit_for_bit(cols, precision, scale):
    jc, tc, _ = cols
    j = JC.string_to_decimal(jc, precision, scale)
    t = TC.string_to_decimal(tc, precision, scale)
    assert t.dtype.precision == precision and t.dtype.scale == -scale
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))
    lo = np.asarray(j.data).astype(np.int64)
    np.testing.assert_array_equal(t.limbs[:, 0].numpy(), lo)
    np.testing.assert_array_equal(t.limbs[:, 1].numpy(), lo >> 63)


def test_string_to_decimal_wide_precision_raises(cols):
    with pytest.raises(NotImplementedError):
        TC.string_to_decimal(cols[1], 20, 0)


@pytest.mark.parametrize("base", [10, 16])
@pytest.mark.parametrize("jt,tt", [(JT.INT64, TT.INT64),
                                   (JT.INT32, TT.INT32),
                                   (JT.INT8, TT.INT8)], ids=repr)
def test_conv_parse_and_format_bit_for_bit(cols, base, jt, tt):
    jc, tc, _ = cols
    j = JC.string_to_integer_with_base(jc, jt, base)
    t = TC.string_to_integer_with_base(tc, tt, base)
    _same_col(j, t)
    js = JC.integer_to_string_with_base(j, base)
    ts = TC.integer_to_string_with_base(t, base)
    np.testing.assert_array_equal(ts.chars.numpy(), np.asarray(js.chars))
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    np.testing.assert_array_equal(ts.validity.numpy(),
                                  np.asarray(js.validity))


def test_bad_inputs_raise():
    c = StringColumn.from_pylist(["1"], device="cpu")
    with pytest.raises(TypeError):
        TC.string_to_integer(c, TT.FLOAT64)
    with pytest.raises(TypeError):
        TC.string_to_float(c, TT.INT32)
    with pytest.raises(ValueError):
        TC.string_to_integer_with_base(c, TT.INT64, 8)
