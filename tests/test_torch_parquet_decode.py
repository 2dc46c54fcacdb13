"""PyTorch port: the Parquet page decoder (``io/pages.py``,
``io/native/parquet_pages.cpp``, ``io/thrift.py``, ``io/metadata.py``) and
the scan (``io/parquet.py``) against the JAX package's pyarrow scan.

One parametrised matrix writes the same table (every supported type with
nulls, three row groups, pages of at most 512 bytes) with pyarrow under
each codec (none, snappy, gzip), dictionary setting (on, off, and a 256-byte
``dictionary_pagesize_limit`` that makes the wide columns fall back to
PLAIN mid-chunk) and data page version (1.0, 2.0); every split and column
selection of the footer tests then reads bit for bit what the reference's
``read_parquet`` reads, with ``encoded_execution`` off and on (string
columns as dictionary columns: codes, canon and dictionary equal to what
pyarrow's ``read_dictionary`` plus ``combine_chunks`` give).  Beside it:
the committed pyarrow fixtures (``tests/data``, written by
:func:`fixture_table` with the options in ``FIXTURES``) decode to their
committed digest in both packages; q6 from Parquet equals the reference's
jitted ``_q6_step``; the numpy harness writer (``tests/parquet_writer.py``)
writes files pyarrow reads back; every unsupported encoding, codec and
nested column raises ``not_ported``; a corrupt page raises; pre-1970
nanoseconds truncate toward zero; and the port's ``io`` imports and reads
with pyarrow and jax blocked.
"""

import decimal
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.io import parquet as jparquet

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.columnar.encoded import is_encoded
from spark_rapids_jni_tpu_torch.io import pages as PG
from spark_rapids_jni_tpu_torch.io import parquet as tparquet
from spark_rapids_jni_tpu_torch.shuffle.morsel import batch_digest

import parquet_writer as PW
from torch_parity import (assert_col_equal, assert_encoded_equal,
                          one_torch_thread, to_port)  # noqa: F401

CPU = "cpu"
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = {
    "fixture_v1.parquet": dict(
        row_group_size=400, data_page_size=1024,
        dictionary_pagesize_limit=1024, compression="snappy",
        data_page_version="1.0", store_decimal_as_integer=True,
        write_batch_size=64),
    "fixture_v2_int96.parquet": dict(
        row_group_size=400, data_page_size=1024, compression="snappy",
        data_page_version="2.0", use_deprecated_int96_timestamps=True,
        write_batch_size=64),
}
FIXTURE_ROWS, FIXTURE_SEED = 1000, 15


def fixture_table(n: int, seed: int) -> pa.Table:
    """Every type the port reads, with nulls: bool, int8-64, float32/64,
    date, timestamps in ms/us/ns (pre-1970 nanos that are not whole
    micros among them), a repetitive string column (SNAPPY copies, a small
    dictionary), an all-distinct one (dictionary fallback) and decimals
    of precision 9, 18 and 38."""
    rng = np.random.default_rng(seed)

    def arr(values, typ, p=0.1):
        return pa.array(values, typ, mask=rng.random(n) < p)

    words = [f"w{i:03d}-" + "ab" * (i % 9) for i in range(300)]
    ns = rng.integers(-(10 ** 18), 10 ** 18, n)
    ns[:16] = [-1, -999, -1000, -1001, -1500, -999999, 1, 999, 1000, 1500,
               -86_400_000_000_001, -(10 ** 18) + 7, 0, -2, 2, -3]
    d9 = rng.integers(-10 ** 9 + 1, 10 ** 9, n)
    d18 = rng.integers(-10 ** 18 + 1, 10 ** 18, n)
    d38 = [int(a) * 10 ** 20 + int(b) for a, b in
           zip(rng.integers(-10 ** 17, 10 ** 17, n),
               rng.integers(0, 10 ** 18, n))]
    return pa.table({
        "b": arr(rng.random(n) < 0.5, pa.bool_()),
        "i8": arr(rng.integers(-128, 128, n), pa.int8()),
        "i16": arr(rng.integers(-2 ** 15, 2 ** 15, n), pa.int16()),
        "i32": arr(rng.integers(-2 ** 31, 2 ** 31, n), pa.int32(), 0.0),
        "i64": arr(np.arange(n) * 7 - 1000, pa.int64()),
        "f32": arr(rng.standard_normal(n).astype(np.float32), pa.float32()),
        "f64": arr(rng.standard_normal(n) * 1e6, pa.float64()),
        "d": arr(rng.integers(-40000, 40000, n).astype(np.int32),
                 pa.date32()),
        "ts_ms": arr(rng.integers(-10 ** 13, 10 ** 13, n),
                     pa.timestamp("ms")),
        "ts_us": arr(rng.integers(-10 ** 16, 10 ** 16, n),
                     pa.timestamp("us")),
        "ts_ns": arr(ns, pa.timestamp("ns")),
        "s": arr([words[i] for i in rng.integers(0, 300, n)], pa.string()),
        "u": arr([f"u{i}-" + "xyz" * int(rng.integers(0, 5))
                  for i in range(n)], pa.string(), 0.05),
        "dec9": arr([decimal.Decimal(int(x)).scaleb(-2) for x in d9],
                    pa.decimal128(9, 2)),
        "dec18": arr([decimal.Decimal(int(x)).scaleb(-4) for x in d18],
                     pa.decimal128(18, 4)),
        "dec38": arr([decimal.Decimal(x).scaleb(-10) for x in d38],
                     pa.decimal128(38, 10)),
    })


@pytest.fixture(autouse=True)
def _reset():
    yield
    config.reset()
    jconfig.reset()


def _modes(mode):
    config.set("encoded_execution", mode)
    jconfig.set("encoded_execution", mode)


def assert_batches_identical(jb, tb, msg=""):
    """The port's batch holds the reference's bit for bit: names, types,
    validity, values on valid rows (zero under nulls in the port), string
    char matrices and lengths whole, dictionary columns buffer for
    buffer."""
    assert list(tb.names) == list(jb.names), msg
    carried = to_port(jb)
    for name, jc, tc in zip(jb.names, jb.columns, tb.columns):
        m = f"{msg} {name}"
        assert is_encoded(tc) == is_encoded(carried[name]), m
        if is_encoded(tc):
            assert_encoded_equal(jc, tc, m)
            continue
        assert repr(tc.dtype) == repr(carried[name].dtype), m
        assert_col_equal(jc, tc, msg=m)
        if isinstance(tc, StringColumn):
            np.testing.assert_array_equal(tc.chars.numpy(),
                                          np.asarray(jc.chars), m)
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(jc.lengths), m)
        else:
            data = (tc.limbs if hasattr(tc, "limbs") else tc.data).numpy()
            assert not data[~tc.validity.numpy()].any(), f"{m} null slots"


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

MATRIX_ROWS = 600
CODECS = ("none", "snappy", "gzip")
DICTIONARY = {"on": {}, "off": {"use_dictionary": False},
              "fallback": {"dictionary_pagesize_limit": 256}}
PAGE_VERSIONS = ("1.0", "2.0")


@pytest.fixture(scope="module")
def matrix_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq_matrix")
    table = fixture_table(MATRIX_ROWS, 3)
    for codec in CODECS:
        for dk, dkw in DICTIONARY.items():
            for ver in PAGE_VERSIONS:
                pq.write_table(table, str(d / f"{codec}-{dk}-{ver}.parquet"),
                               row_group_size=200, data_page_size=512,
                               compression=codec, data_page_version=ver,
                               store_decimal_as_integer=ver == "2.0",
                               write_batch_size=64, **dkw)
    return d


@pytest.mark.parametrize("version", PAGE_VERSIONS)
@pytest.mark.parametrize("dictionary", list(DICTIONARY))
@pytest.mark.parametrize("codec", CODECS)
def test_decode_matrix(matrix_dir, codec, dictionary, version):
    path = str(matrix_dir / f"{codec}-{dictionary}-{version}.parquet")
    size = os.path.getsize(path)
    splits = [(0, size), (0, size // 2), (size // 2, size), (0, 1),
              (size // 3, size // 3)]
    cut = int(pq.ParquetFile(path).metadata.row_group(1).column(4)
              .statistics.min)
    reads = [dict(part_offset=o, part_length=ln) for o, ln in splits] + [
        dict(columns=["S", "i64", "DEC38"], ignore_case=True),
        dict(columns=["u"]),
        dict(columns=["i64", "s"], predicate=("i64", "<", cut))]
    for mode in ("off", "on"):
        _modes(mode)
        for kw in reads:
            jb = jparquet.read_parquet(path, **kw)
            tb = tparquet.read_parquet(path, device=CPU, **kw)
            assert tb.num_rows == jb.num_rows, (mode, kw)
            assert_batches_identical(jb, tb, f"{mode} {kw}")


def _plain_data_pages(path, rg, ci):
    """How many data pages of one column chunk are PLAIN-encoded."""
    from spark_rapids_jni_tpu_torch.io import thrift

    col = tparquet.read_metadata(path).row_group(rg).column(ci)
    raw = open(path, "rb").read()
    pos, end = col.chunk_start, col.chunk_start + col.total_compressed_size
    plain = 0
    while pos < end:
        hdr, body = thrift.page_header(raw, pos)
        dp = hdr.data_page_header or hdr.data_page_header_v2
        plain += dp is not None and dp.encoding == PG.PLAIN
        pos = body + hdr.compressed_page_size
    return plain


def test_dictionary_codes_one_and_several_row_groups(matrix_dir):
    """pyarrow unifies the row groups' dictionaries in combine_chunks: the
    port's codes and dictionary equal the reference's for one row group
    and for all three, with and without a PLAIN fallback mid-chunk."""
    _modes("on")
    for dk in ("on", "fallback"):
        path = str(matrix_dir / f"snappy-{dk}-1.0.parquet")
        meta = tparquet.read_metadata(path)
        assert (_plain_data_pages(path, 0, 12) > 0) == (dk == "fallback")
        _, end0 = tparquet._row_group_span(meta.row_group(0))
        for length in (end0, 1 << 62):
            kw = dict(columns=["s", "u"], part_length=length)
            jb = jparquet.read_parquet(path, **kw)
            tb = tparquet.read_parquet(path, device=CPU, **kw)
            assert tb.num_rows == (200 if length == end0 else MATRIX_ROWS)
            assert all(is_encoded(c) for c in tb.columns)
            assert_batches_identical(jb, tb, f"{dk} {length}")


EDGE_TABLES = {
    "all_null": lambda: pa.table({
        "s": pa.array([None] * 10, pa.string()),
        "i": pa.array([None] * 10, pa.int64()),
        "b": pa.array([None] * 10, pa.bool_())}),
    "no_rows": lambda: pa.table({"s": pa.array([], pa.string()),
                                 "i": pa.array([], pa.int64())}),
    "bools": lambda: pa.table({"b": pa.array([True, False, None] * 300)}),
    "empty_strings": lambda: pa.table({"s": pa.array(["", None, "", "a"]
                                                     * 50)}),
    "utf8": lambda: pa.table({"s": pa.array(["h\u00e9llo", "\u65e5\u672c",
                                             None, "\U0001f600"] * 50)}),
    "decimal_38_0": lambda: pa.table({"d": pa.array(
        [10 ** 37, -10 ** 37, None, 1], pa.decimal128(38, 0))}),
    "timestamp_utc": lambda: pa.table({"t": pa.array(
        [1, -1, None], pa.timestamp("us", tz="UTC"))}),
    "timestamp_zone": lambda: pa.table({"t": pa.array(
        [1, -1, None], pa.timestamp("ms", tz="America/New_York"))}),
}


@pytest.mark.parametrize("name", sorted(EDGE_TABLES))
def test_edge_tables(tmp_path, name):
    """All-null columns (an empty string dictionary decodes), no rows,
    booleans, empty and multi-byte strings, 38-digit decimals and
    zoned timestamps, under v1 dictionary pages and v2 PLAIN pages."""
    path = str(tmp_path / f"{name}.parquet")
    for kw in ({}, {"use_dictionary": False, "data_page_version": "2.0"}):
        pq.write_table(EDGE_TABLES[name](), path, **kw)
        for mode in ("off", "on"):
            _modes(mode)
            assert_batches_identical(jparquet.read_parquet(path),
                                     tparquet.read_parquet(path, device=CPU),
                                     f"{kw} {mode}")


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def _digests():
    with open(os.path.join(DATA, "parquet_fixtures.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_digest_both_packages(name):
    """The committed pyarrow file holds its recipe's table, decodes in the
    port to the committed digest (what ``chip_smoke.py`` checks on the
    card), and the reference's read carries over to the same digest."""
    path = os.path.join(DATA, name)
    want = fixture_table(FIXTURE_ROWS, FIXTURE_SEED)
    got = pq.read_table(path)
    for col in want.column_names:
        if col.startswith("ts_") and name.endswith("int96.parquet"):
            continue  # INT96 reads back as ns: compared through the digest
        assert got.column(col).equals(want.column(col)), col
    digest = _digests()[name]
    for mode in ("off", "on"):
        _modes(mode)
        tb = tparquet.read_parquet(path, device=CPU)
        jb = jparquet.read_parquet(path)
        assert batch_digest(tb) == digest, mode
        assert batch_digest(to_port(jb)) == digest, mode
        assert_batches_identical(jb, tb, f"{name} {mode}")


def test_fixtures_cover_copies_fallback_and_v2():
    """The fixtures hold real SNAPPY copies (a chunk smaller than its
    literals could be), a dictionary that falls back to PLAIN, data
    pages v2 and INT96."""
    v1 = pq.ParquetFile(os.path.join(DATA, "fixture_v1.parquet")).metadata
    s = v1.row_group(0).column(11)
    assert s.compression == "SNAPPY"
    assert s.total_compressed_size < s.total_uncompressed_size // 2
    u = v1.row_group(0).column(12)
    assert {"PLAIN", "RLE_DICTIONARY"} <= set(u.encodings)
    assert _plain_data_pages(os.path.join(DATA, "fixture_v1.parquet"), 0,
                             12) > 0
    v2 = pq.ParquetFile(os.path.join(DATA, "fixture_v2_int96.parquet"))
    assert v2.metadata.row_group(0).column(8).physical_type == "INT96"
    raw = open(os.path.join(DATA, "fixture_v2_int96.parquet"), "rb").read()
    from spark_rapids_jni_tpu_torch.io import thrift

    col = v2.metadata.row_group(0).column(1)
    hdr, _ = thrift.page_header(raw, col.dictionary_page_offset
                                or col.data_page_offset)
    hdr2, _ = thrift.page_header(raw, col.data_page_offset)
    assert hdr.type == PG.DICTIONARY_PAGE
    assert hdr2.type == PG.DATA_PAGE_V2


# ---------------------------------------------------------------------------
# q6 from Parquet, the harness writer, timestamps
# ---------------------------------------------------------------------------

def test_q6_from_parquet_matches_reference_step(tmp_path):
    """q6 over a Parquet file read by each package: the port's step equals
    the reference's jitted ``_q6_step`` (keys, sums and counts exact,
    avg(price) rel 1e-5), written by pyarrow and by the harness writer
    (dictionary k and v, price falling back to PLAIN)."""
    import jax

    import __graft_entry__ as ge
    from spark_rapids_jni_tpu_torch import pipelines as PL

    n = 5000
    k, v, price = PL.example_arrays(n, seed=8)
    a = str(tmp_path / "q6_pyarrow.parquet")
    pq.write_table(pa.table({"k": k, "v": v, "price": price}), a,
                   row_group_size=512)
    b = str(tmp_path / "q6_harness.parquet")
    PW.write_parquet(b, {"k": (k, None), "v": (v, None),
                         "price": (price, None)}, row_group_rows=1024,
                     page_rows=256,
                     dictionary={"k": None, "v": None, "price": 256})
    step = jax.jit(ge._q6_step)
    jres, jng = step(jparquet.read_parquet(a))
    want = {}
    for i in range(int(jng)):
        want[int(jres["k"].data[i])] = (int(jres["sum_v"].data[i]),
                                       int(jres["cnt"].data[i]),
                                       float(jres["avg_price"].data[i]))
    for path in (a, b):
        tb = tparquet.read_parquet(path, device=CPU)
        got = PL.result_groups(*PL.q6_step(tb), "k")
        assert sorted(got) == sorted(want)
        for key, (s, c, avg) in want.items():
            assert got[key]["sum_v"] == s and got[key]["cnt"] == c
            assert abs(got[key]["avg_price"] - avg) <= 1e-5 * abs(avg)


def test_harness_writer_reads_back_in_pyarrow_and_port(tmp_path):
    rng = np.random.default_rng(4)
    n = 3000
    cols = {"a": (rng.integers(-5, 5, n).astype(np.int32), None),
            "b": (rng.integers(0, 1 << 40, n), rng.random(n) > 0.2),
            "c": (rng.random(n), rng.random(n) > 0.1),
            "s": ([f"k{i % 17}" for i in range(n)], rng.random(n) > 0.3)}
    for codec in ("none", "snappy"):
        path = str(tmp_path / f"h-{codec}.parquet")
        PW.write_parquet(path, cols, row_group_rows=1000, page_rows=250,
                         codec=codec,
                         dictionary={"a": None, "s": 500, "c": 250})
        t = pq.read_table(path)
        for name, (vals, valid) in cols.items():
            want = pa.array(vals, mask=None if valid is None else ~valid)
            if name == "s":
                want = want.cast(pa.string())
            assert t.column(name).combine_chunks().equals(want), name
        md = pq.ParquetFile(path).metadata
        st = md.row_group(0).column(1).statistics
        live = cols["b"][0][:1000][cols["b"][1][:1000]]
        assert (st.min, st.max, st.null_count) == (
            int(live.min()), int(live.max()), int((~cols["b"][1][:1000])
                                                   .sum()))
        _modes("off")
        assert_batches_identical(jparquet.read_parquet(path),
                                 tparquet.read_parquet(path, device=CPU),
                                 codec)


def test_pre_1970_nanos_truncate_toward_zero(tmp_path):
    ns = np.array([-1, -999, -1000, -1001, -1500, 1500, -86_400_000_000_001],
                  np.int64)
    path = str(tmp_path / "ns.parquet")
    pq.write_table(pa.table({"t": pa.array(ns, pa.timestamp("ns"))}), path)
    got = tparquet.read_parquet(path, device=CPU)["t"].data.numpy()
    np.testing.assert_array_equal(
        got, [0, 0, -1, -1, -1, 1, -86_400_000_000])
    jb = jparquet.read_parquet(path)
    np.testing.assert_array_equal(got, np.asarray(jb["t"].data))


def test_row_group_readers_replay_bit_identically(matrix_dir):
    path = str(matrix_dir / "gzip-fallback-2.0.parquet")
    PG.reset_stats()
    readers = tparquet.row_group_readers(path, device=CPU)
    jreaders = jparquet.row_group_readers(path)
    assert [r for _, r in readers] == [r for _, r in jreaders]
    for (read, _), (jread, _) in zip(readers, jreaders):
        first, again = read(), read()
        assert batch_digest(first) == batch_digest(again)
        assert_batches_identical(jread(), first)
    assert PG.STATS["row_group_decodes"] == 2 * len(readers)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def _write(tmp_path, name, table, **kw):
    path = str(tmp_path / name)
    pq.write_table(table, path, **kw)
    return path


@pytest.mark.parametrize("what,kw", [
    ("DELTA_BINARY_PACKED", dict(column_encoding={"x": "DELTA_BINARY_PACKED"},
                                 use_dictionary=False)),
    ("BYTE_STREAM_SPLIT", dict(column_encoding={"x": "BYTE_STREAM_SPLIT"},
                               use_dictionary=False)),
    ("ZSTD", dict(compression="zstd")),
    ("LZ4", dict(compression="lz4")),
    ("BROTLI", dict(compression="brotli")),
])
def test_unsupported_encoding_or_codec_raises(tmp_path, what, kw):
    t = pa.table({"x": pa.array(np.arange(100, dtype=np.int64))})
    path = _write(tmp_path, f"{what}.parquet", t, **kw)
    with pytest.raises(NotImplementedError, match="14b") as e:
        tparquet.read_parquet(path, device=CPU)
    assert what in str(e.value)


@pytest.mark.parametrize("col", [
    pa.array([{"a": 1}, None, {"a": 3}]),
    pa.array([[1, 2], None, [3]], pa.list_(pa.int32()))])
def test_nested_column_raises(tmp_path, col):
    path = _write(tmp_path, "nested.parquet",
                  pa.table({"n": col, "flat": [1, 2, 3]}))
    with pytest.raises(NotImplementedError, match="14b.*nested|nested.*14b"):
        tparquet.read_parquet(path, device=CPU)
    # a flat column beside it reads
    assert tparquet.read_parquet(path, columns=["flat"],
                                 device=CPU).num_rows == 3


@pytest.mark.parametrize("typ", [pa.uint8(), pa.uint32(), pa.uint64(),
                                 pa.time64("us"), pa.binary(), pa.float16(),
                                 pa.json_(pa.string())])
def test_types_the_reference_rejects_raise(tmp_path, typ):
    vals = {pa.binary(): [b"ab", None], pa.float16(): [1.5, None],
            pa.json_(pa.string()): ['{"a": 1}', None]}.get(typ, [1, None])
    path = _write(tmp_path, "t.parquet", pa.table({"x": pa.array(vals, typ)}))
    with pytest.raises(NotImplementedError):
        jparquet.read_parquet(path)
    with pytest.raises(NotImplementedError):
        tparquet.read_parquet(path, device=CPU)


def test_corrupt_pages_raise(tmp_path):
    from spark_rapids_jni_tpu_torch.io import thrift

    path = str(tmp_path / "c.parquet")
    PW.write_parquet(path, {"k": (np.arange(4096, dtype=np.int32) % 50,
                                  None)}, row_group_rows=4096,
                     page_rows=4096, codec="snappy", dictionary={"k": None})
    raw = open(path, "rb").read()
    data_off = tparquet.read_metadata(path).row_group(0).column(0) \
        .data_page_offset
    _, body = thrift.page_header(raw, data_off)
    # a torn page header, and a snappy block whose length disagrees
    for at in (data_off, body):
        bad = bytearray(raw)
        bad[at] ^= 0xFF if at == data_off else 0x01
        p = str(tmp_path / "bad.parquet")
        open(p, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match="corrupt|thrift"):
            tparquet.read_parquet(p, device=CPU)
    # a snappy copy from before the start of the output is refused
    with pytest.raises(ValueError, match="before its start"):
        PG.snappy_decompress(np.frombuffer(b"\x08\x01\x05", np.uint8))
    # dictionary indices past the dictionary are refused
    with pytest.raises(ValueError, match="past its dictionary"):
        PG.rle_decode(np.frombuffer(b"\x10\xff", np.uint8), 8, 8, bound=10)
    # a run that needs more bytes than the page holds is refused
    with pytest.raises(ValueError, match="runs past"):
        PG.rle_decode(np.frombuffer(b"\x05\x01", np.uint8), 8, 16)


@pytest.mark.parametrize("region", ["pages", "footer"])
def test_mutated_fixture_decodes_or_raises_cleanly(tmp_path, region):
    """A seeded sweep of byte mutations of the committed fixture, in its
    pages or in its footer: every read decodes or raises ValueError (a
    corrupt page or footer) or ``not_ported`` (a mutated encoding or
    codec id); none fails any other way or reads past a buffer."""
    src = open(os.path.join(DATA, "fixture_v2_int96.parquet"), "rb").read()
    footer_at = len(src) - 8 - int.from_bytes(src[-8:-4], "little")
    lo, hi = (4, footer_at) if region == "pages" else (footer_at,
                                                        len(src) - 8)
    rng = np.random.default_rng(21)
    path = str(tmp_path / "m.parquet")
    outcomes = set()
    for _ in range(100):
        bad = bytearray(src)
        for at in rng.integers(lo, hi, int(rng.integers(1, 4))):
            bad[int(at)] = int(rng.integers(0, 256))
        with open(path, "wb") as f:
            f.write(bytes(bad))
        try:
            tparquet.read_parquet(path, device=CPU)
            outcomes.add("read")
        except (ValueError, NotImplementedError) as e:
            outcomes.add(type(e).__name__)
    assert "ValueError" in outcomes or "ThriftError" in outcomes


def test_snappy_copies_at_every_offset_width():
    """Literal, then copies with 1-, 2- and 4-byte offsets (one of them
    overlapping its own output), against the expected bytes."""
    lit = bytes(range(40)) * 10  # 400 bytes
    # tag 0b01: len 4..11, 11-bit offset; 0b10: len 1..64, 16-bit;
    # 0b11: len 1..64, 32-bit
    body = bytearray([61 << 2]) + (len(lit) - 1).to_bytes(2, "little") + lit
    body += bytes([(1 << 5) | (3 << 2) | 1, 44])          # len 7, off 300
    body += bytes([(9 << 2) | 2]) + (3).to_bytes(2, "little")   # len 10, off 3
    body += bytes([(19 << 2) | 3]) + (400).to_bytes(4, "little")  # len 20
    want = bytearray(lit)
    for ln, off in ((7, 300), (10, 3), (20, 400)):
        for _ in range(ln):
            want.append(want[-off])
    block = bytes([len(want)]) if len(want) < 128 else (
        bytes([len(want) & 0x7F | 0x80, len(want) >> 7]))
    got = PG.snappy_decompress(np.frombuffer(block + bytes(body), np.uint8))
    assert got.tobytes() == bytes(want)


def test_io_imports_and_reads_without_pyarrow_or_jax():
    """The port's io imports nothing of pyarrow, jax or the reference: a
    fresh interpreter with all three blocked imports it and reads the
    committed fixture to its digest."""
    repo = os.path.dirname(DATA.rstrip("/"))
    repo = os.path.dirname(repo)
    code = (
        "import sys\n"
        "for m in ('pyarrow', 'pyarrow.parquet', 'jax', "
        "'spark_rapids_jni_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from spark_rapids_jni_tpu_torch import io\n"
        "from spark_rapids_jni_tpu_torch.shuffle.morsel import "
        "batch_digest\n"
        f"b = io.read_parquet({os.path.join(DATA, 'fixture_v1.parquet')!r},"
        " device='cpu')\n"
        "print(batch_digest(b))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == _digests()["fixture_v1.parquet"]
