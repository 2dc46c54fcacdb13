"""PyTorch port: the data plane's Arrow IPC codec (``columnar/arrow_ipc.py``),
which needs no pyarrow, against the reference's pyarrow codec
(``spark_rapids_jni_tpu/columnar/arrow.py`` ``batch_to_ipc`` /
``ipc_to_batch``).

For every branch of the codec (plain fixed-width columns with their
validity companion, dates, zoned timestamps, binary strings, decimals,
dictionaries over string / plain / decimal values, run-end encoded runs
and the zero-run decode, packed columns, lists and structs with Arrow
nulls) the same numpy input, made from a seed, becomes a reference batch
and a port batch.  Then, all exact (tolerance 0, bit patterns compared):

* the port's schema message is pyarrow's, byte for byte, so the two
  fingerprints agree;
* the port's stream read by the reference's reader gives what the
  reference's own stream gives it;
* the reference's stream read by the port's reader gives what the
  port's own stream gives it, every buffer compared by raw bytes, null
  rows, NaN payloads and -0.0 included, and both equal the reference's
  read.

Truncation at any point, a buffer offset past the body, decreasing
string offsets, an out-of-range dictionary index and a wrong fingerprint
each raise; a process with pyarrow blocked imports the codec and
round-trips a batch.
"""

import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from spark_rapids_jni_tpu.columnar import arrow as JA  # noqa: E402
from spark_rapids_jni_tpu.columnar import encoded as JE  # noqa: E402
from spark_rapids_jni_tpu.columnar import types as JT  # noqa: E402
from spark_rapids_jni_tpu.columnar.column import (  # noqa: E402
    Column as JColumn, ColumnBatch as JBatch, ListColumn as JList,
    StringColumn as JString, StructColumn as JStruct)
from spark_rapids_jni_tpu.serve.worker import make_result_batch  # noqa: E402

from spark_rapids_jni_tpu_torch.columnar import arrow_ipc as I  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import encoded as E  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import types as T  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar.column import (  # noqa: E402
    Column, ColumnBatch)

from torch_parity import jdecimal, port_form, ref_form, to_port, \
    unscaled  # noqa: E402
from torch_parity import one_torch_thread  # noqa: F401,E402 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 97


def _rng(seed):
    return np.random.default_rng(seed)


def _valid(rng, n, p=0.2):
    return rng.random(n) >= p


def _plain(seed, dtype_np, jtype, n=N):
    rng = _rng(seed)
    if np.issubdtype(dtype_np, np.floating):
        data = rng.standard_normal(n).astype(dtype_np)
        data[::7] = np.nan
        data[3::11] = -0.0
        data[5::13] = np.inf
    elif dtype_np == np.bool_:
        data = rng.random(n) < 0.5
    else:
        info = np.iinfo(dtype_np)
        data = rng.integers(info.min, info.max, n, dtype=dtype_np,
                            endpoint=True)
    return JColumn(jnp.asarray(data), jnp.asarray(_valid(rng, n)), jtype)


def _strings(seed, n=N, bad_utf8=True):
    rng = _rng(seed)
    words = [b"", b"a", b"beta", b"gamma-long-word", "ép".encode()]
    if bad_utf8:
        words.append(b"\xff\xfe")
    rows = [words[i] for i in rng.integers(0, len(words), n)]
    w = max(8, -(-max(len(r) for r in rows) // 8) * 8)
    chars = np.zeros((n, w), np.uint8)
    lens = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        chars[i, :len(r)] = np.frombuffer(r, np.uint8)
    return JString(jnp.asarray(chars), jnp.asarray(lens),
                   jnp.asarray(_valid(rng, n)))


def _decimal(seed, n=N, precision=38, scale=10):
    return jdecimal(unscaled(_rng(seed), n, precision, nulls=0.2),
                    precision, scale)


def _list_of(child, seed, n=N):
    rng = _rng(seed)
    valid = _valid(rng, n, 0.25)
    lens = np.where(valid, rng.integers(0, 4, n), 0)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return JList(jnp.asarray(offsets), child(int(offsets[-1])),
                 jnp.asarray(valid))


def _struct(seed, n):
    rng = _rng(seed)
    return JStruct({"a": _plain(seed + 1, np.int64, JT.INT64, n),
                    "b": _strings(seed + 2, n, bad_utf8=False),
                    "c": _decimal(seed + 3, n, 18, 2)},
                   jnp.asarray(_valid(rng, n, 0.3)))


def _zero_run_rle():
    return JE.RunLengthColumn(jnp.zeros((0,), jnp.int32),
                              jnp.zeros((0,), jnp.int32),
                              jnp.asarray(_valid(_rng(9), 6)), JT.INT32)


def _branches():
    ts_utc = JT.SparkType(JT.Kind.TIMESTAMP, tz="UTC")
    ts_ny = JT.SparkType(JT.Kind.TIMESTAMP, tz="America/New_York")
    sorted_ints = JColumn(jnp.asarray(np.sort(_rng(5).integers(0, 5, N))
                                      .astype(np.int32)),
                          jnp.asarray(_valid(_rng(6), N)), JT.INT32)
    return {
        "int8": lambda: {"x": _plain(1, np.int8, JT.INT8)},
        "int16": lambda: {"x": _plain(2, np.int16, JT.INT16)},
        "int32": lambda: {"x": _plain(3, np.int32, JT.INT32)},
        "int64": lambda: {"x": _plain(4, np.int64, JT.INT64)},
        "float32": lambda: {"x": _plain(5, np.float32, JT.FLOAT32)},
        "float64": lambda: {"x": _plain(6, np.float64, JT.FLOAT64)},
        "bool": lambda: {"x": _plain(7, np.bool_, JT.BOOLEAN)},
        "date32": lambda: {"x": _plain(8, np.int32, JT.DATE)},
        "timestamps": lambda: {
            "plain": _plain(9, np.int64, JT.TIMESTAMP),
            "utc": JColumn(_plain(10, np.int64, JT.INT64).data,
                           _plain(10, np.int64, JT.INT64).validity, ts_utc),
            "ny": JColumn(_plain(11, np.int64, JT.INT64).data,
                          _plain(11, np.int64, JT.INT64).validity, ts_ny)},
        "string": lambda: {"s": _strings(12)},
        "decimal": lambda: {"d": _decimal(13), "d2": _decimal(14, N, 9, 3)},
        "dict_string": lambda: {"s": JE.encode_column(
            _strings(15, bad_utf8=False))},
        "dict_plain": lambda: {
            "i": JE.encode_column(JColumn(
                jnp.asarray(_rng(16).integers(0, 6, N)),
                jnp.asarray(_valid(_rng(17), N)), JT.INT64)),
            "f": JE.encode_column(JColumn(
                jnp.asarray(_rng(18).integers(0, 4, N).astype(np.float64)
                            * 0.5), jnp.asarray(_valid(_rng(19), N)),
                JT.FLOAT64))},
        "dict_decimal": lambda: {"d": JE.encode_column(jdecimal(
            [None if i % 9 == 0 else (i % 5) * 10 ** 20 - 7
             for i in range(N)], 38, 4))},
        "rle": lambda: {"r": JE.encode_rle(sorted_ints)},
        "rle_zero_runs": lambda: {"r": _zero_run_rle()},
        "packed": lambda: {
            "p": JE.encode_bitpacked(JColumn(
                jnp.asarray(_rng(20).integers(0, 300, N)),
                jnp.asarray(_valid(_rng(21), N)), JT.INT64)),
            "q": JE.encode_for(JColumn(
                jnp.asarray(_rng(22).integers(10 ** 9, 10 ** 9 + 500, N)),
                jnp.asarray(_valid(_rng(23), N)), JT.INT64), block=16)},
        "list": lambda: {"l": _list_of(
            lambda m: _plain(24, np.int64, JT.INT64, m), 25)},
        "struct": lambda: {"st": _struct(26, N)},
        "list_of_struct": lambda: {"ls": _list_of(
            lambda m: _struct(27, m), 28)},
        "list_of_strings": lambda: {"lt": _list_of(
            lambda m: _strings(29, m, bad_utf8=False), 30)},
        "result_batch": lambda: dict(zip(*(lambda b: (b.names, b.columns))(
            make_result_batch(N, 3)))),
        "empty_rows": lambda: dict(zip(*(lambda b: (b.names, b.columns))(
            make_result_batch(0, 1)))),
        "no_columns": lambda: {},
    }


BRANCHES = sorted(_branches())


def _schema_msg(stream):
    return I._read_stream(stream)[1]


def _port(jb):
    """The reference batch in port columns, time zones carried over
    (``to_port`` rebuilds types from their repr, which has no zone)."""
    tb = to_port(jb)
    cols = {}
    for n, jc, tc in zip(jb.names, jb.columns, tb.columns):
        if isinstance(tc, Column) and jc.dtype.kind is JT.Kind.TIMESTAMP:
            tc = Column(tc.data, tc.validity,
                        T.SparkType(T.Kind.TIMESTAMP, tz=jc.dtype.tz))
        cols[n] = tc
    return ColumnBatch(cols)


@pytest.fixture(scope="module")
def streams():
    """Per branch: the reference batch, the port batch, both streams."""
    out = {}
    for name, make in _branches().items():
        jb = JBatch(make())
        tb = _port(jb)
        jbuf, jfp = JA.batch_to_ipc(jb)
        buf, fp = I.batch_to_ipc(tb)
        out[name] = (jb, tb, jbuf.to_pybytes(), jfp, bytes(buf), fp)
    return out


@pytest.mark.parametrize("branch", BRANCHES)
def test_schema_message_is_pyarrows(streams, branch):
    """Tolerance 0: the schema message, byte for byte, and so the
    fingerprint."""
    _jb, _tb, jbuf, jfp, buf, fp = streams[branch]
    assert _schema_msg(buf) == _schema_msg(jbuf)
    assert fp == jfp


@pytest.mark.parametrize("branch", BRANCHES)
def test_reference_reads_port_stream_as_its_own(streams, branch):
    """Tolerance 0: the reference's reader gives the same buffers from
    the port's stream as from its own."""
    _jb, _tb, jbuf, jfp, buf, fp = streams[branch]
    mine = JA.ipc_to_batch(buf, expect_fingerprint=fp)
    theirs = JA.ipc_to_batch(jbuf, expect_fingerprint=jfp)
    assert mine.names == theirs.names
    for n in theirs.names:
        assert ref_form(mine[n]) == ref_form(theirs[n]), n


@pytest.mark.parametrize("branch", BRANCHES)
def test_port_reads_reference_stream_as_its_own(streams, branch):
    """Tolerance 0: the port's reader gives the same buffers from the
    reference's stream as from its own, and the reference's reader's
    buffers too."""
    _jb, _tb, jbuf, jfp, buf, fp = streams[branch]
    mine = I.ipc_to_batch(buf, expect_fingerprint=fp, device="cpu")
    theirs = I.ipc_to_batch(jbuf, expect_fingerprint=jfp, device="cpu")
    ref = JA.ipc_to_batch(jbuf, expect_fingerprint=jfp)
    assert mine.names == theirs.names == ref.names
    for n in ref.names:
        assert port_form(mine[n]) == port_form(theirs[n]), n
        assert port_form(mine[n]) == ref_form(ref[n]), n
        # a type's repr leaves out the time zone
        assert getattr(mine[n].dtype, "tz", None) == \
            getattr(theirs[n].dtype, "tz", None) == \
            getattr(ref[n].dtype, "tz", None), n


def test_round_trip_keeps_the_port_batch(streams):
    """Tolerance 0 on every row: values, null-row codes, NaN payloads and
    -0.0 of the port batch come back, encodings kept."""
    _jb, tb, _jbuf, _jfp, buf, fp = streams["result_batch"]
    back = I.ipc_to_batch(buf, expect_fingerprint=fp, device="cpu")
    assert isinstance(back["tag"], E.DictionaryColumn)
    assert isinstance(back["r"], E.RunLengthColumn)
    for n in ("v", "f", "r"):
        assert port_form(back[n]) == port_form(tb[n]), n
    assert back["tag"].codes.numpy().tobytes() == \
        tb["tag"].codes.numpy().tobytes()
    assert back["tag"].dictionary.to_pylist() == \
        tb["tag"].dictionary.to_pylist()


def _corrupt_buffer_offset(buf: bytes) -> bytes:
    """The record batch's last buffer pushed past the body."""
    view = memoryview(buf)
    for fb, htype, header, body, raw in I._messages(view):
        if htype != I._RECORD_BATCH:
            continue
        pos, n = fb.vector(header, 2, 16)
        # the flatbuffer starts after the marker and the length
        at = buf.index(raw) + 8 + pos + 16 * (n - 1)
        out = bytearray(buf)
        struct.pack_into("<q", out, at, len(body) + 8)
        return bytes(out)
    raise AssertionError("no record batch")


class TestMalformed:
    def _stream(self):
        return bytes(I.batch_to_ipc(to_port(make_result_batch(64, 2)))[0])

    def test_every_truncation_raises(self):
        buf = self._stream()
        for cut in sorted({0, 3, 4, 7, 8, 9, 100, len(buf) // 3,
                           len(buf) // 2, len(buf) - 9, len(buf) - 8,
                           len(buf) - 4, len(buf) - 1}):
            with pytest.raises(ValueError):
                I.ipc_to_batch(buf[:cut], device="cpu")

    def test_buffer_past_body_raises(self):
        bad = _corrupt_buffer_offset(self._stream())
        with pytest.raises(ValueError, match="past the message body"):
            I.ipc_to_batch(bad, device="cpu")

    def test_decreasing_offsets_raise(self):
        jb = JBatch({"s": _strings(40, 16, bad_utf8=False)})
        buf = bytearray(I.batch_to_ipc(to_port(jb))[0])
        ends = np.cumsum(np.asarray(jb["s"].lengths)).astype(np.int32)
        needle = np.concatenate([[0], ends]).astype(np.int32).tobytes()
        at = bytes(buf).index(needle)
        struct.pack_into("<i", buf, at + 8, 10 ** 6)
        with pytest.raises(ValueError, match="offsets"):
            I.ipc_to_batch(bytes(buf), device="cpu")

    def test_dictionary_index_out_of_range_raises(self):
        jb = JBatch({"s": JE.encode_column(_strings(41, 16,
                                                    bad_utf8=False))})
        tb = to_port(jb)
        buf = bytearray(I.batch_to_ipc(tb)[0])
        codes = tb["s"].codes.numpy().astype(np.int32).tobytes()
        at = bytes(buf).rindex(codes)
        struct.pack_into("<i", buf, at, 1000)
        with pytest.raises(ValueError, match="out of range"):
            I.ipc_to_batch(bytes(buf), device="cpu")

    def test_wrong_fingerprint_raises(self):
        with pytest.raises(ValueError, match="fingerprint"):
            I.ipc_to_batch(self._stream(), expect_fingerprint="0" * 16,
                           device="cpu")

    def test_garbage_raises(self):
        rng = _rng(42)
        for _ in range(20):
            junk = rng.integers(0, 256, int(rng.integers(1, 400)),
                                dtype=np.uint8).tobytes()
            with pytest.raises((ValueError, NotImplementedError)):
                I.ipc_to_batch(b"\xff\xff\xff\xff" + junk, device="cpu")


def test_codec_imports_and_round_trips_without_pyarrow():
    """In a process where ``import pyarrow`` fails, the codec imports and
    a batch round-trips with its digest kept."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np, torch\n"
        "from spark_rapids_jni_tpu_torch.columnar import arrow_ipc as I\n"
        "from spark_rapids_jni_tpu_torch.columnar import encoded as E\n"
        "from spark_rapids_jni_tpu_torch.columnar import types as T\n"
        "from spark_rapids_jni_tpu_torch.columnar.column import Column,"
        " ColumnBatch\n"
        "from spark_rapids_jni_tpu_torch.serve.data_plane import"
        " batch_digest\n"
        "v = torch.arange(50, dtype=torch.int64)\n"
        "ok = torch.arange(50) % 3 != 0\n"
        "b = ColumnBatch({'v': Column(v, ok, T.INT64),\n"
        "  'r': E.encode_rle(Column((v // 10).to(torch.int32), ok,"
        " T.INT32))})\n"
        "buf, fp = I.batch_to_ipc(b)\n"
        "back = I.ipc_to_batch(buf, fp, device='cpu')\n"
        "assert batch_digest(back) == batch_digest(b)\n"
        "assert 'pyarrow' not in {m.split('.')[0] for m, x in"
        " sys.modules.items() if x is not None}\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
