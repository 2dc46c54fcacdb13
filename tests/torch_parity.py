"""Helpers the PyTorch port's parity tests share: reference columns carried
into the port through ``batch_from_numpy`` (plain, string, decimal, list
and struct, at any depth, and the four encoded kinds: dictionary, RLE,
bit-packed and frame-of-reference with their zone sidecars), seeded
decimal values, bit-for-bit column comparisons, and a module fixture that
runs the port's CPU ops on one thread."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import \
    Decimal128Column as JDecimal
from spark_rapids_jni_tpu.columnar.column import ListColumn as JList
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.columnar.column import StructColumn as JStruct
from spark_rapids_jni_tpu.columnar.encoded import BitPackedColumn as JPacked
from spark_rapids_jni_tpu.columnar.encoded import DictionaryColumn as JDict
from spark_rapids_jni_tpu.columnar.encoded import \
    FrameOfReferenceColumn as JFor
from spark_rapids_jni_tpu.columnar.encoded import RunLengthColumn as JRle

from spark_rapids_jni_tpu_torch.columnar.column import (Decimal128Column,
                                                        StringColumn,
                                                        batch_from_numpy)

MAX38 = 10 ** 38 - 1


def zone_form(z):
    """A reference zone sidecar in ``batch_from_numpy``'s form."""
    if z is None:
        return None
    return {"mins": z.mins, "maxs": z.maxs, "block": z.block,
            "rows": z.rows, "crc": z.crc, "column": z.column}


def host_form(c):
    """A reference column as ``batch_from_numpy``'s ``(data, validity,
    type)`` triple."""
    if isinstance(c, JDict):
        data = {"encoding": "dictionary", "codes": np.asarray(c.codes),
                "canon": None if c.canon is None else np.asarray(c.canon),
                "dictionary": None if c.dictionary is None
                else host_form(c.dictionary), "token": c.dict_token}
    elif isinstance(c, JRle):
        data = {"encoding": "rle", "run_values": np.asarray(c.run_values),
                "run_lengths": np.asarray(c.run_lengths)}
    elif isinstance(c, JPacked):
        data = {"encoding": "bitpacked", "lanes": np.asarray(c.lanes),
                "width": c.width, "reference": c.reference,
                "zone": zone_form(c.zone)}
    elif isinstance(c, JFor):
        data = {"encoding": "for", "refs": np.asarray(c.refs),
                "lanes": np.asarray(c.lanes), "width": c.width,
                "block": c.block, "zone": zone_form(c.zone)}
    elif isinstance(c, JString):
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


def u32(t):
    """A port int32 carrier of u32 bits (codes, canon, lanes) as uint32."""
    return t.numpy().astype(np.int32).view(np.uint32)


def assert_encoded_equal(jc, tc, msg=""):
    """An encoded port column holds the reference's buffers bit for bit
    (codes, canon and dictionary; runs; lanes, width and reference;
    refs and block) and the same validity."""
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity), f"{msg} validity")
    if isinstance(jc, JDict):
        np.testing.assert_array_equal(u32(tc.codes), np.asarray(jc.codes),
                                      f"{msg} codes")
        np.testing.assert_array_equal(u32(tc.canon), np.asarray(jc.canon),
                                      f"{msg} canon")
        assert_col_equal(jc.dictionary, tc.dictionary, msg=f"{msg} dict")
        if isinstance(jc.dictionary, JString):
            assert tc.dictionary.max_len == jc.dictionary.max_len, msg
    elif isinstance(jc, JRle):
        np.testing.assert_array_equal(tc.run_values.numpy(),
                                      np.asarray(jc.run_values), msg)
        np.testing.assert_array_equal(tc.run_lengths.numpy(),
                                      np.asarray(jc.run_lengths), msg)
    else:
        np.testing.assert_array_equal(u32(tc.lanes), np.asarray(jc.lanes),
                                      f"{msg} lanes")
        assert tc.width == jc.width, msg
        if isinstance(jc, JPacked):
            assert tc.reference == jc.reference, msg
        else:
            np.testing.assert_array_equal(tc.refs.numpy(),
                                          np.asarray(jc.refs), msg)
            assert tc.block == jc.block, msg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's port ops on one intra-op thread, restored after.

    The port's CPU runs are thousands of small ops; with the suite's six
    xdist workers each spreading them over every core, the threads wait
    on each other (``test_torch_parse_uri.py`` took 184 s of worker time
    that way against 15 s on one thread).  Results are the same on any
    thread count.  A test module imports this name to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
