"""PyTorch port: ``ops/decimal_to_string.py`` (Spark CAST(decimal AS
STRING), Java ``BigDecimal.toString``) against the JAX package, bit for
bit, and against Python's ``Decimal``.

One seeded set of unscaled values (every digit count up to 38, both
signs, nulls, 0, ±1, ±(10^38 - 1) and -2^127, the full 128-bit range)
goes through both packages at each scale of the reference's test, plus a
negative scale; the JAX package's first call compiles for seconds, the
later ones at the same shape are quick.  The goldens of the reference's
test run on the port."""

from decimal import Decimal, localcontext

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops.decimal_to_string import \
    decimal_to_string as jdts

from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column
from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
    decimal_to_string

import torch_parity as TP
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SCALES = [0, 1, 2, 6, 10, 37, 38, -3]
SPECIALS = [0, 1, -1, 5, 12, 123, 10**38 - 1, -(10**38 - 1), -(2**127),
            10**6, 10**7, 10**10]
VALUES = TP.unscaled(np.random.default_rng(41), 600, 38,
                     specials=SPECIALS)


def oracle(unscaled: int, scale: int) -> str:
    """Java BigDecimal(unscaled, scale).toString()."""
    with localcontext() as ctx:
        ctx.prec = 80
        return str(Decimal(unscaled).scaleb(-scale))


def col(vals, scale, precision=38):
    return Decimal128Column.from_unscaled(vals, precision, scale,
                                          device="cpu")


@pytest.fixture(scope="module")
def refs():
    return {s: jdts(TP.jdecimal(VALUES, 38, s)) for s in SCALES}


@pytest.mark.parametrize("scale", SCALES)
def test_bit_for_bit(refs, scale):
    ref = refs[scale]
    got = decimal_to_string(TP.port_col(TP.jdecimal(VALUES, 38, scale)))
    np.testing.assert_array_equal(got.chars.numpy(), np.asarray(ref.chars))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(ref.validity))


@pytest.mark.parametrize("scale", SCALES)
def test_against_python_decimal(scale):
    got = decimal_to_string(col(VALUES, scale)).to_pylist()
    for g, v in zip(got, VALUES):
        assert g == (None if v is None else oracle(v, scale)), (v, scale)


@pytest.mark.parametrize("precision,scale", [(18, 2), (9, 4), (38, 10)])
def test_narrow_precisions(precision, scale):
    vals = TP.unscaled(np.random.default_rng(precision), 200, precision)
    got = decimal_to_string(col(vals, scale, precision)).to_pylist()
    assert got == [None if v is None else oracle(v, scale) for v in vals]


def test_goldens():
    def one(v, s):
        return decimal_to_string(col([v], s)).to_pylist()[0]

    assert one(123456, 2) == "1234.56"
    assert one(-123456, 2) == "-1234.56"
    assert one(5, 3) == "0.005"
    assert one(0, 2) == "0.00"
    assert one(7, 0) == "7"
    # adjusted exponent < -6 -> scientific
    assert one(1, 8) == "1E-8"
    assert one(12, 9) == "1.2E-8"
    assert one(123, 10) == "1.23E-8"
    # boundary: adjusted == -6 stays plain
    assert one(1, 6) == "0.000001"
    assert one(1, 7) == "1E-7"
    v = 12345678901234567890123456789012345678
    assert one(v, 10) == "1234567890123456789012345678.9012345678"
    assert one(-v, 0) == "-12345678901234567890123456789012345678"
    assert decimal_to_string(col([123, None], 1)).to_pylist() == ["12.3",
                                                                  None]
