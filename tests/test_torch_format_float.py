"""PyTorch port: ``ops/format_float.py`` (Spark ``format_number``) against
the JAX package, bit for bit, and against a Python oracle.

The JAX package runs once per float width at one shape and 5 digits
(module fixtures: its first call at a shape compiles for seconds): the
seeded values are random bit patterns (subnormals, NaNs and infinities
among them), magnitudes from 1e-10 to 1e20 of both signs, rounding ties
and carries, and the reference's goldens.  Subnormals compare exactly:
the function reads the float's bits, so the JAX package's CPU backend
flushes none of them.  The sweep over ``digits`` holds the port against
``tests/expr_oracle.py``'s ``format_number``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops.format_float import format_float as jformat

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops.format_float import format_float

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from expr_oracle import format_number as oracle

GOLD64 = [100.0, 654321.25, -12761.125, 1.123456789123456789,
          0.000000000000000000123456789123456789, 0.0, 5.0, -4.0,
          float("nan"), 839542223232.794248339, 3232.794248339,
          11234000000.0, -0.0]
GOLD64_OUT = ["100.00000", "654,321.25000", "-12,761.12500", "1.12346",
              "0.00000", "0.00000", "5.00000", "-4.00000", "�",
              "839,542,223,232.79420", "3,232.79425",
              "11,234,000,000.00000", "-0.00000"]
GOLD32 = [100.0, 654321.25, -12761.125, 0.0, 5.0, -4.0, float("nan"),
          123456789012.34, -0.0]
GOLD32_OUT = ["100.00000", "654,321.25000", "-12,761.12500", "0.00000",
              "5.00000", "-4.00000", "�", "123,456,790,000.00000",
              "-0.00000"]
EDGES = [0.95, 0.009, 9.999, 0.0005, 1234.5, 0.5, 1.5, 2.5, 0.045, 99.995,
         5e-324, -5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
         float("inf"), float("-inf"), 1e16, 123456789012345678.0]
N = 3000


def _values(kind, seed):
    rng = np.random.default_rng(seed)
    mags = rng.random(N) * 10.0 ** rng.integers(-10, 20, N)
    if kind == "f64":
        bits = rng.integers(0, 2**63, N, dtype=np.int64)
        bits = np.where(rng.random(N) < 0.5, bits, bits | np.int64(-2**63))
        return np.concatenate([np.asarray(GOLD64 + EDGES), bits.view(
            np.float64), mags, -mags])
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        return np.concatenate([np.asarray(GOLD32 + EDGES, np.float32),
                               bits.view(np.float32),
                               mags.astype(np.float32),
                               -mags.astype(np.float32)])


def _valid(n, seed=9):
    return np.random.default_rng(seed).random(n) > 0.05


@pytest.fixture(scope="module", params=["f64", "f32"])
def case(request):
    kind = request.param
    vals = _values(kind, 21 if kind == "f64" else 22)
    valid = _valid(vals.shape[0])
    jt, tt = (JT.FLOAT64, TT.FLOAT64) if kind == "f64" else (JT.FLOAT32,
                                                            TT.FLOAT32)
    ref = jformat(JColumn(jnp.asarray(vals), jnp.asarray(valid), jt), 5)
    col = Column(torch.from_numpy(vals), torch.from_numpy(valid), tt)
    return kind, vals, valid, col, ref


def test_bit_for_bit_at_5_digits(case):
    _, _, valid, col, ref = case
    got = format_float(col, 5)
    np.testing.assert_array_equal(got.chars.numpy(), np.asarray(ref.chars))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.validity.numpy(), valid)


def test_reference_goldens(case):
    kind, _, _, col, _ = case
    gold, want = (GOLD64, GOLD64_OUT) if kind == "f64" else (GOLD32,
                                                            GOLD32_OUT)
    head = Column(col.data[:len(gold)], torch.ones(len(gold),
                                                   dtype=torch.bool),
                  col.dtype)
    assert format_float(head, 5).to_pylist() == want


@pytest.mark.parametrize("digits", [0, 1, 2, 3, 8, 12])
def test_digits_sweep_against_python(case, digits):
    kind, vals, valid, col, _ = case
    got = format_float(col, digits).to_pylist()
    f32 = kind == "f32"
    bad = [(float(v), g) for v, ok, g in zip(vals, valid, got)
           if (g != oracle(v, digits, f32) if ok else g is not None)]
    assert not bad, bad[:5]


def test_rounding_carry_and_infinity():
    col = Column(torch.tensor([0.95, 0.009, 9.999, 0.0005,
                               float("inf"), float("-inf"), 1234.5],
                              dtype=torch.float64),
                 torch.ones(7, dtype=torch.bool), TT.FLOAT64)
    assert format_float(col, 1).to_pylist()[:4] == ["1.0", "0.0", "10.0",
                                                    "0.0"]
    assert format_float(col, 2).to_pylist()[:4] == ["0.95", "0.01",
                                                    "10.00", "0.00"]
    assert format_float(col, 0).to_pylist()[4:] == ["∞", "-∞",
                                                    "1,234"]


def test_nulls_and_errors():
    col = Column(torch.tensor([1.5, 7.0], dtype=torch.float64),
                 torch.tensor([True, False]), TT.FLOAT64)
    assert format_float(col, 2).to_pylist() == ["1.50", None]
    with pytest.raises(ValueError):
        format_float(col, -1)
    with pytest.raises(TypeError):
        format_float(Column(torch.tensor([1]), torch.tensor([True]),
                            TT.INT64), 2)
