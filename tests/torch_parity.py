"""Helpers the PyTorch port's parity tests share: reference columns carried
into the port through ``batch_from_numpy`` (plain, string, decimal, list
and struct, at any depth), seeded decimal values, and bit-for-bit column
comparisons."""

import numpy as np

from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import \
    Decimal128Column as JDecimal
from spark_rapids_jni_tpu.columnar.column import ListColumn as JList
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.columnar.column import StructColumn as JStruct

from spark_rapids_jni_tpu_torch.columnar.column import (Decimal128Column,
                                                        StringColumn,
                                                        batch_from_numpy)

MAX38 = 10 ** 38 - 1


def host_form(c):
    """A reference column as ``batch_from_numpy``'s ``(data, validity,
    type)`` triple."""
    if isinstance(c, JString):
        data = (np.asarray(c.chars), np.asarray(c.lengths))
    elif isinstance(c, JDecimal):
        data = np.asarray(c.limbs)
    elif isinstance(c, JList):
        data = (np.asarray(c.offsets), host_form(c.child))
    elif isinstance(c, JStruct):
        data = {f: host_form(ch) for f, ch in zip(c.field_names,
                                                 c.children)}
    else:
        data = np.asarray(c.data)
    return data, np.asarray(c.validity), repr(c.dtype)


def to_port(jb):
    return batch_from_numpy({n: host_form(c)
                             for n, c in zip(jb.names, jb.columns)},
                            device="cpu")


def port_col(jc):
    return to_port(JBatch({"c": jc}))["c"]


def below_pow10(rng, digits: int) -> int:
    v = 0
    while digits > 0:
        k = min(digits, 9)
        v = v * 10 ** k + int(rng.integers(0, 10 ** k))
        digits -= k
    return v


def unscaled(rng, n, precision, nulls=0.05, specials=()):
    """``n`` unscaled values of up to ``precision`` digits (digit counts
    spread evenly, signs mixed, ``nulls`` of them None), then
    ``specials``."""
    out = []
    for _ in range(n):
        if rng.random() < nulls:
            out.append(None)
            continue
        v = below_pow10(rng, int(rng.integers(1, precision + 1)))
        out.append(-v if rng.random() < 0.5 else v)
    return out + list(specials)


def jdecimal(values, precision, scale):
    return JDecimal.from_unscaled(values, precision, scale)


def assert_col_equal(jc, tc, rows=None, msg=""):
    """Validity equal, and every buffer equal bit for bit on valid rows
    (on the first ``rows`` rows when given)."""
    sl = slice(None) if rows is None else slice(0, rows)
    jv = np.asarray(jc.validity)[sl]
    np.testing.assert_array_equal(tc.validity[sl].numpy(), jv,
                                  err_msg=f"{msg} validity")
    if isinstance(tc, Decimal128Column):
        np.testing.assert_array_equal(
            tc.limbs[sl].numpy().view(np.uint64)[jv],
            np.asarray(jc.limbs)[sl][jv], err_msg=f"{msg} limbs")
        assert repr(tc.dtype) == repr(jc.dtype), msg
    elif isinstance(tc, StringColumn):
        assert tc.to_pylist()[sl] == jc.to_pylist()[sl], msg
    else:
        np.testing.assert_array_equal(
            tc.data[sl].numpy()[jv].view(np.uint8),
            np.asarray(jc.data)[sl][jv].view(np.uint8), err_msg=msg)
