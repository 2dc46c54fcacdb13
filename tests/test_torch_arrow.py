"""PyTorch port: Arrow interop (``columnar/arrow.py``) against the JAX
package's: tables carried in (dictionary arrays as dictionary columns),
out, and through the data plane's bit-exact IPC codec.  Needs pyarrow,
which the GPU machine does not have: there the file skips."""

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from spark_rapids_jni_tpu import config as jconfig  # noqa: E402
from spark_rapids_jni_tpu.columnar import arrow as JA  # noqa: E402
from spark_rapids_jni_tpu.columnar import encoded as JE  # noqa: E402

from spark_rapids_jni_tpu_torch import config as tconfig  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import arrow as A  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import encoded as E  # noqa: E402

from torch_parity import assert_col_equal, assert_encoded_equal, \
    to_port  # noqa: E402
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _reset():
    yield
    jconfig.reset()
    tconfig.reset()


def _table():
    rng = np.random.default_rng(3)
    n = 200
    words = ["alpha", "beta", "gamma", None, "delta"]
    return pa.table({
        "i": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
        "f": pa.array(rng.random(n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5),
        "s": pa.array([words[i] for i in rng.integers(0, 5, n)]),
        "d": pa.array([None if i % 7 == 0 else i for i in range(n)],
                      pa.int32()).cast(pa.date32()),
        "ts": pa.array(rng.integers(0, 10 ** 12, n), pa.timestamp("ns")),
        "dec": pa.array([None if i % 5 == 0 else i * 10 ** 15
                         for i in range(n)], pa.decimal128(38, 2)),
        "dict": pa.array([words[i] for i in rng.integers(0, 5, n)])
        .dictionary_encode(),
        "ldict": pa.array(rng.integers(0, 4, n)).dictionary_encode(),
        "lst": pa.array([[1, 2], None, [], [3]] * (n // 4),
                        pa.list_(pa.int64())),
    })


def test_from_arrow_matches_the_reference():
    jconfig.set("encoded_execution", "on")
    t = _table()
    jb = JA.from_arrow(t)
    tb = A.from_arrow(t, device="cpu")
    assert list(tb.names) == list(jb.names)
    for name in ("i", "f", "b", "s", "d", "ts", "dec"):
        assert_col_equal(jb[name], tb[name], msg=name)
    for name in ("dict", "ldict"):
        assert isinstance(tb[name], E.DictionaryColumn)
        assert_encoded_equal(jb[name], tb[name], name)
    lst = tb["lst"]
    np.testing.assert_array_equal(lst.offsets.numpy(),
                                  np.asarray(jb["lst"].offsets))


def test_dictionary_arrays_decode_when_encoded_execution_is_off():
    tconfig.set("encoded_execution", "off")
    tb = A.from_arrow(_table(), device="cpu")
    assert not E.is_encoded(tb["dict"])
    assert tb["dict"].to_pylist() == _table()["dict"].to_pylist()


def test_to_arrow_materializes_like_the_reference():
    jconfig.set("encoded_execution", "on")
    t = _table()
    jb = JA.from_arrow(t)
    got = A.to_arrow(to_port(jb))
    want = JA.to_arrow(jb)
    for name in want.column_names:
        assert got[name].to_pylist() == want[name].to_pylist(), name


def test_ipc_round_trip_is_bit_exact_and_keeps_encodings():
    rng = np.random.default_rng(9)
    n = 120
    jb = JE.encode_batch(JA.from_arrow(pa.table({
        "s": pa.array([f"k{i % 6}" for i in range(n)]),
        "r": pa.array(np.sort(rng.integers(0, 4, n))),
        "v": pa.array(rng.standard_normal(n)),
        "p": pa.array(rng.integers(0, 300, n)),
    })), dictionary=["s"], rle=["r"], bitpack=["p"])
    tb = to_port(jb)
    buf, fp = A.batch_to_ipc(tb)
    jbuf, jfp = JA.batch_to_ipc(jb)
    assert fp == jfp
    back = A.ipc_to_batch(buf, fp, device="cpu")
    jround = JA.ipc_to_batch(jbuf.to_pybytes(), jfp)
    assert isinstance(back["s"], E.DictionaryColumn)
    assert isinstance(back["r"], E.RunLengthColumn)
    # values cross exactly; a string dictionary comes back at Arrow
    # ingest's 8-byte padding in both packages
    assert back["s"].to_pylist() == JE.materialize_column(
        jb["s"]).to_pylist()
    assert_encoded_equal(jround["s"], back["s"], "s")
    assert_encoded_equal(jb["r"], back["r"], "r")
    assert_col_equal(jb["v"], back["v"], msg="v")
    assert back["p"].data.tolist() == JE.materialize_column(
        jb["p"]).to_pylist()
    # the reference reads the port's stream and the port the reference's
    jback = JA.ipc_to_batch(buf.to_pybytes(), fp)
    assert_encoded_equal(jback["s"], back["s"], "cross s")
    again = A.ipc_to_batch(jbuf.to_pybytes(), jfp, device="cpu")
    assert_encoded_equal(jb["r"], again["r"], "cross r")
    with pytest.raises(ValueError, match="fingerprint"):
        A.ipc_to_batch(buf, "0" * 16, device="cpu")
