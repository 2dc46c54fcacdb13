"""PyTorch port: ``ops/float_to_string.py`` (Ryu, Java ``Double.toString``)
against the JAX package, bit for bit, for float64 and float32, plus the
u64-in-int64 helpers (``_u64.py``) that carry its arithmetic, against
numpy's ``uint64`` on the values where signed and unsigned part ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import float_to_string as JF

from spark_rapids_jni_tpu_torch import _u64 as U
from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import float_to_string as TF

import json_oracle
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

EDGES64 = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324,
           2.2250738585072014e-308, 2.225073858507201e-308,
           float(2**53 - 1), float(2**53 + 1), float(2**53), float(2**63),
           float(2**64), 1e7, 9999999.999999998, 1e-3, 0.0009999999999999998,
           9.999999999999999e22, 1e23, 1.7976931348623157e308, 0.1, 0.3,
           1e21, 1e-7, 123456.789, 4.35, 2.0**-1074 * 3] + [
               10.0 ** k for k in range(-25, 25)]
EDGES32 = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, 1.1754944e-38,
           3.4028235e38, 16777216.0, 16777217.0, 0.1, 1e7, 1e-3, 9.999999e6,
           8.589973e9, 1.0000001]


def _f64(seed, n=3000):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**63, n, dtype=np.int64)
    bits = np.where(rng.random(n) < 0.5, bits, bits | np.int64(-2**63))
    mags = rng.random(n) * 10.0 ** rng.integers(-30, 30, n)
    ints = rng.integers(-10**17, 10**17, n).astype(np.float64)
    return np.concatenate([np.asarray(EDGES64), bits.view(np.float64), mags,
                           ints])


def _f32(seed, n=3000):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([np.asarray(EDGES32, np.float32),
                           bits.view(np.float32),
                           (rng.random(n) * 1e6).astype(np.float32)])


def _valid(n, seed=9):
    return np.random.default_rng(seed).random(n) > 0.05


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_float_to_string_bit_for_bit(kind):
    vals = _f64(11) if kind == "f64" else _f32(12)
    jt, tt = (JT.FLOAT64, TT.FLOAT64) if kind == "f64" else (JT.FLOAT32,
                                                            TT.FLOAT32)
    valid = _valid(vals.shape[0])
    j = JF.float_to_string(JColumn(jnp.asarray(vals), jnp.asarray(valid),
                                   jt))
    t = TF.float_to_string(Column(torch.from_numpy(vals),
                                  torch.from_numpy(valid), tt))
    np.testing.assert_array_equal(t.chars.numpy(), np.asarray(j.chars))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(t.validity.numpy(), valid)


def test_double_to_json_string_bit_for_bit():
    vals = _f64(13, 1000)
    jc, jl = JF.double_to_json_string(jnp.asarray(vals))
    tc, tl = TF.double_to_json_string(torch.from_numpy(vals))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_float_to_string_is_java_double_to_string():
    vals = _f64(14, 500)
    t = TF.float_to_string(Column(torch.from_numpy(vals),
                                  torch.ones(vals.shape[0],
                                             dtype=torch.bool), TT.FLOAT64))
    assert t.to_pylist() == [json_oracle.java_double_to_string(float(v))
                             for v in vals]


def test_float_to_string_rejects_ints():
    with pytest.raises(TypeError):
        TF.float_to_string(Column(torch.zeros(2, dtype=torch.int64),
                                  torch.ones(2, dtype=torch.bool),
                                  TT.INT64))


# ---------------------------------------------------------------------------
# the u64 helpers
# ---------------------------------------------------------------------------

U64_EDGES = [0, 1, 2, 4, 5, 9, 10, 11, 2**31, 2**32 - 1, 2**32, 2**53 - 1,
             2**53 + 1, 2**62, 2**63 - 1, 2**63, 2**63 + 1, 10**18, 10**19 - 1,
             10**19, 10**19 + 1, 2**64 - 10, 2**64 - 2, 2**64 - 1]


def _u64s(seed=21, n=400):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 2**63, n, dtype=np.int64).view(np.uint64)
    r = r | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63))
    return np.concatenate([np.asarray(U64_EDGES, np.uint64), r])


def _t(u):
    return torch.from_numpy(u.view(np.int64).copy())


def _np(t):
    return t.numpy().view(np.uint64)


def test_u64_compare_and_shift():
    a = _u64s(1)
    b = np.roll(a, 7)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(U.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(U.ugt(ta, tb).numpy(), a > b)
    np.testing.assert_array_equal(U.uge(ta, tb).numpy(), a >= b)
    for c in (0, 5, 2**63, 10**19, 2**64 - 1):
        np.testing.assert_array_equal(U.ult(ta, c).numpy(),
                                      a < np.uint64(c))
    for s in (0, 1, 31, 32, 52, 63, 64):
        want = a >> np.uint64(s) if s < 64 else np.zeros_like(a)
        np.testing.assert_array_equal(_np(U.lsr(ta, s)), want)
        np.testing.assert_array_equal(
            _np(U.lsr(ta, torch.full_like(ta, s))), want)
        wl = a << np.uint64(s) if s < 64 else np.zeros_like(a)
        np.testing.assert_array_equal(_np(U.shl(ta, torch.full_like(ta, s))),
                                      wl)
    # a negative tensor shift reads as a huge u64 shift: zero
    assert not U.lsr(ta, torch.full_like(ta, -3)).any()


@pytest.mark.parametrize("d", [1, 2, 5, 10, 10**9, 10**18, 2**63 - 1,
                               2**63, 10**19, 2**64 - 1])
def test_u64_divmod(d):
    a = _u64s(2)
    q, r = U.udivmod(_t(a), d)
    np.testing.assert_array_equal(_np(q), a // np.uint64(d))
    np.testing.assert_array_equal(_np(r), a % np.uint64(d))


def test_u64_to_f64_rounds_as_a_u64_conversion():
    a = _u64s(3)
    np.testing.assert_array_equal(U.to_f64(_t(a)).numpy(),
                                  a.astype(np.float64))


def test_u64_product_high_half():
    a, b = _u64s(4), _u64s(5)
    hi, lo = TF._umul64_128(_t(a), _t(b))
    want = [(int(x) * int(y)) for x, y in zip(a, b)]
    assert [int(v) for v in _np(hi)] == [w >> 64 for w in want]
    assert [int(v) for v in _np(lo)] == [w & (2**64 - 1) for w in want]
