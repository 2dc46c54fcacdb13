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
committed digest in both packages (the DELTA/BYTE_STREAM_SPLIT v2 file,
one file per codec, a nested ZSTD file and the harness writer's
Hadoop-framed LZ4 file among them); each DELTA and BYTE_STREAM_SPLIT
encoding under each page version, and the LZ4, ZSTD and BROTLI codecs,
read as the reference reads them; a missing codec library raises; q6
from Parquet equals the reference's jitted ``_q6_step``; the numpy
harness writer (``tests/parquet_writer.py``) writes files pyarrow reads
back, BYTE_ARRAY decimals among them; a corrupt page raises; pre-1970
nanoseconds truncate toward zero; and the port's ``io`` imports and reads
with pyarrow and jax blocked.  Nested columns and the Arrow schema are in
``test_torch_parquet_nested.py``.
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
from spark_rapids_jni_tpu_torch.columnar.column import (ListColumn,
                                                        StringColumn,
                                                        StructColumn)
from spark_rapids_jni_tpu_torch.columnar.encoded import is_encoded
from spark_rapids_jni_tpu_torch.io import pages as PG
from spark_rapids_jni_tpu_torch.io import parquet as tparquet
from spark_rapids_jni_tpu_torch.shuffle.morsel import batch_digest

import parquet_writer as PW
from parquet_tables import harness_columns, nested_table
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
    # the v2 writer's layout: DELTA_BINARY_PACKED ints, DELTA strings,
    # BYTE_STREAM_SPLIT floats and FLBA decimals
    "fixture_delta_v2.parquet": dict(
        row_group_size=200, data_page_size=1024, compression="snappy",
        data_page_version="2.0", store_decimal_as_integer=True,
        write_batch_size=64, use_dictionary=["b", "i8"],
        column_encoding={
            "i16": "DELTA_BINARY_PACKED", "i32": "DELTA_BINARY_PACKED",
            "i64": "DELTA_BINARY_PACKED", "d": "DELTA_BINARY_PACKED",
            "ts_ms": "DELTA_BINARY_PACKED", "ts_us": "BYTE_STREAM_SPLIT",
            "ts_ns": "DELTA_BINARY_PACKED", "dec9": "DELTA_BINARY_PACKED",
            "dec18": "BYTE_STREAM_SPLIT", "f32": "BYTE_STREAM_SPLIT",
            "f64": "BYTE_STREAM_SPLIT", "s": "DELTA_BYTE_ARRAY",
            "u": "DELTA_LENGTH_BYTE_ARRAY", "dec38": "DELTA_BYTE_ARRAY"}),
    "fixture_zstd.parquet": dict(
        row_group_size=200, data_page_size=1024, compression="zstd",
        data_page_version="1.0", write_batch_size=64),
    "fixture_lz4.parquet": dict(
        row_group_size=200, data_page_size=1024, compression="lz4",
        data_page_version="2.0", write_batch_size=64),
    "fixture_brotli.parquet": dict(
        row_group_size=200, data_page_size=1024, compression="brotli",
        data_page_version="1.0", write_batch_size=64),
    "fixture_nested.parquet": dict(
        row_group_size=100, data_page_size=512, compression="zstd",
        data_page_version="2.0", write_batch_size=32),
    # the harness writer's: Hadoop-framed LZ4, v1 pages
    "fixture_lz4_hadoop.parquet": dict(
        row_group_rows=150, page_rows=50, codec="lz4_hadoop",
        encoding={"k": "delta", "price": "bss", "s.a": "bss",
                  "tags.list.element": "delta"}),
}
FIXTURE_ROWS, FIXTURE_SEED = 1000, 15
# fixtures of another table or size: (table, rows, seed)
FIXTURE_TABLES = {
    "fixture_delta_v2.parquet": ("flat", 400, 16),
    "fixture_zstd.parquet": ("flat", 300, 17),
    "fixture_lz4.parquet": ("flat", 300, 18),
    "fixture_brotli.parquet": ("flat", 300, 19),
    "fixture_nested.parquet": ("nested", 300, 20),
    "fixture_lz4_hadoop.parquet": ("harness", 450, 21),
}


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


def _zones(t):
    """The time zones of a type tree, in order."""
    return (t.tz,) + tuple(z for c in t.children for z in _zones(c))


def assert_columns_identical(jc, tc, carried, msg="", live=None):
    """One port column holds the reference's bit for bit: ``repr`` of its
    type and every time zone in it, validity, a list's offsets and a
    struct's field names (then their children), string char matrices and
    lengths whole, values on valid rows and zero under nulls, dictionary
    columns buffer for buffer.  ``live`` marks the rows whose structs
    above are present: a REQUIRED field under a null struct is valid in
    both, and pyarrow leaves its value undefined there (the port's is
    zero), so only live rows' values compare."""
    assert is_encoded(tc) == is_encoded(carried), msg
    if is_encoded(tc):
        assert_encoded_equal(jc, tc, msg)
        return
    assert repr(tc.dtype) == repr(jc.dtype), msg
    assert _zones(tc.dtype) == _zones(jc.dtype), msg
    valid = tc.validity.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jc.validity),
                                  f"{msg} validity")
    if isinstance(tc, ListColumn):
        np.testing.assert_array_equal(tc.offsets.numpy(),
                                      np.asarray(jc.offsets), f"{msg} offs")
        assert_columns_identical(jc.child, tc.child, carried.child,
                                 f"{msg}.element")
        return
    if isinstance(tc, StructColumn):
        assert list(tc.field_names) == list(jc.field_names), msg
        here = valid if live is None else valid & live
        for f, a, b, c in zip(jc.field_names, jc.children, tc.children,
                              carried.children):
            assert_columns_identical(a, b, c, f"{msg}.{f}", here)
        return
    if isinstance(tc, StringColumn):
        assert_col_equal(jc, tc, msg=msg)
        np.testing.assert_array_equal(tc.chars.numpy(),
                                      np.asarray(jc.chars), msg)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths), msg)
        return
    data = (tc.limbs if hasattr(tc, "limbs") else tc.data).numpy()
    want = np.asarray(jc.limbs if hasattr(jc, "limbs") else jc.data)
    rows = valid if live is None else valid & live
    np.testing.assert_array_equal(data.view(want.dtype)[rows], want[rows],
                                  msg)
    assert not data[~rows].any(), f"{msg} null slots"


def assert_batches_identical(jb, tb, msg=""):
    """The port's batch holds the reference's bit for bit, column by
    column (:func:`assert_columns_identical`)."""
    assert list(tb.names) == list(jb.names), msg
    carried = to_port(jb)
    for name, jc, tc in zip(jb.names, jb.columns, tb.columns):
        assert_columns_identical(jc, tc, carried[name], f"{msg} {name}")


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


def write_fixture(name: str, path: str) -> None:
    """Write fixture ``name`` from its recipe (``FIXTURES``,
    ``FIXTURE_TABLES``): how ``tests/data`` was made."""
    kind, rows, seed = FIXTURE_TABLES.get(name, ("flat", FIXTURE_ROWS,
                                                 FIXTURE_SEED))
    if kind == "harness":
        PW.write_parquet(path, harness_columns(rows, seed), **FIXTURES[name])
        return
    table = (fixture_table if kind == "flat" else nested_table)(rows, seed)
    pq.write_table(table, path, **FIXTURES[name])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_digest_both_packages(tmp_path, name):
    """The committed file holds its recipe's table, decodes in the port
    to the committed digest (what ``chip_smoke.py`` checks on the card),
    and the reference's read carries over to the same digest."""
    path = os.path.join(DATA, name)
    fresh = str(tmp_path / name)
    write_fixture(name, fresh)
    want, got = pq.read_table(fresh), pq.read_table(path)
    assert got.column_names == want.column_names
    for col in want.column_names:
        if col.startswith("ts_") and name.endswith("int96.parquet"):
            continue  # INT96 reads back as ns: compared through the digest
        assert got.column(col).equals(want.column(col)), col
    digest = _digests()[name]
    for mode in ("off", "on"):
        _modes(mode)
        tb = tparquet.read_parquet(path, device=CPU)
        assert batch_digest(tb) == digest, mode
        if name == "fixture_delta_v2.parquet" and mode == "on":
            continue  # the reference refuses DELTA strings here
        jb = jparquet.read_parquet(path)
        assert batch_digest(to_port(jb)) == digest, mode
        assert_batches_identical(jb, tb, f"{name} {mode}")


def test_fixtures_cover_encodings_and_codecs():
    """The new fixtures hold what they are for: each codec, the DELTA and
    BYTE_STREAM_SPLIT encodings in v2 pages, nested levels."""
    def meta(name):
        return pq.ParquetFile(os.path.join(DATA, name)).metadata

    for name, codec in (("fixture_zstd.parquet", "ZSTD"),
                        ("fixture_brotli.parquet", "BROTLI"),
                        ("fixture_nested.parquet", "ZSTD")):
        assert meta(name).row_group(0).column(0).compression == codec
    ids = {name: tparquet.read_metadata(os.path.join(DATA, name))
           .row_group(0).column(0).compression
           for name in ("fixture_lz4.parquet", "fixture_lz4_hadoop.parquet")}
    assert ids == {"fixture_lz4.parquet": PG.LZ4_RAW,
                   "fixture_lz4_hadoop.parquet": PG.LZ4}
    rg = meta("fixture_delta_v2.parquet").row_group(0)
    encs = {rg.column(i).path_in_schema: set(rg.column(i).encodings)
            for i in range(rg.num_columns)}
    for col, enc in FIXTURES["fixture_delta_v2.parquet"][
            "column_encoding"].items():
        assert enc in encs[col], col
    nested = tparquet.read_metadata(os.path.join(DATA,
                                                 "fixture_nested.parquet"))
    assert max(lf.max_rep for lf in nested.leaves) == 2
    sizes = [os.path.getsize(os.path.join(DATA, n)) for n in FIXTURES]
    assert max(sizes) <= 150 << 10 and sum(sizes) <= 600 << 10


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


# ---------------------------------------------------------------------------
# the DELTA and BYTE_STREAM_SPLIT encodings, the LZ4, ZSTD and BROTLI codecs
# ---------------------------------------------------------------------------

ENCODED_COLUMNS = {
    "DELTA_BINARY_PACKED": ("i8", "i16", "i32", "i64", "d", "ts_ms",
                            "ts_us", "ts_ns", "dec9", "dec18",
                            "l.list.element"),
    "DELTA_LENGTH_BYTE_ARRAY": ("s", "u", "ls.list.element"),
    "DELTA_BYTE_ARRAY": ("s", "u", "dec38", "ls.list.element"),
    "BYTE_STREAM_SPLIT": ("f32", "f64", "i32", "i64", "dec9", "dec38",
                          "l.list.element"),
}


def encodings_table(n: int, seed: int) -> pa.Table:
    """``fixture_table`` plus a list of int64 and a list of strings."""
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(0, 4, n)
    offs = pa.array(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    m = int(lens.sum())
    null = pa.array(rng.random(n) < 0.1)
    ints = pa.array(rng.integers(-2 ** 62, 2 ** 62, m), pa.int64(),
                    mask=rng.random(m) < 0.1)
    strs = pa.array([f"pre-{i % 7}-{i}" for i in range(m)],
                    mask=rng.random(m) < 0.1)
    t = fixture_table(n, seed)
    t = t.append_column("l", pa.ListArray.from_arrays(offs, ints, mask=null))
    return t.append_column("ls", pa.ListArray.from_arrays(offs, strs,
                                                          mask=null))


def _reference(path, mode, strings_refused: bool, **kw):
    """The reference's batch.  pyarrow's ``read_dictionary`` refuses
    DELTA string pages (``OSError``); there the reference's own
    ``from_arrow`` of the plain read with its top-level strings
    dictionary-encoded in order of first appearance stands in for it."""
    from spark_rapids_jni_tpu.columnar.arrow import from_arrow

    if not (mode == "on" and strings_refused):
        return jparquet.read_parquet(path, **kw)
    with pytest.raises(OSError, match="DictAccumulator"):
        jparquet.read_parquet(path, **kw)
    names = tparquet._match_columns(pq.ParquetFile(path).schema_arrow.names,
                                    kw.get("columns"),
                                    kw.get("ignore_case", False))
    t = pq.read_table(path, columns=names)
    for i, name in enumerate(t.column_names):
        if pa.types.is_string(t.schema.field(name).type):
            t = t.set_column(i, name, t.column(name).combine_chunks()
                             .dictionary_encode())
    return from_arrow(t)


@pytest.mark.parametrize("version", PAGE_VERSIONS)
@pytest.mark.parametrize("encoding", sorted(ENCODED_COLUMNS))
def test_encoding_parity(tmp_path, encoding, version):
    """Each new encoding (on flat and nested leaves, beside dictionary
    columns) under each page version reads as the reference reads it,
    ``encoded_execution`` off and on.  Under on, a DELTA string chunk
    joins the column's dictionary in first-appearance order, where the
    reference raises."""
    cols = ENCODED_COLUMNS[encoding]
    table = encodings_table(500, 23)
    path = str(tmp_path / "enc.parquet")
    pq.write_table(table, path, row_group_size=200, data_page_size=700,
                   data_page_version=version, write_batch_size=64,
                   store_decimal_as_integer=encoding == "DELTA_BINARY_PACKED",
                   use_dictionary=[c for c in table.column_names
                                   if c not in cols and c not in ("l", "ls")],
                   column_encoding={c: encoding for c in cols})
    rg = pq.ParquetFile(path).metadata.row_group(0)
    used = {rg.column(i).path_in_schema for i in range(rg.num_columns)
            if encoding in rg.column(i).encodings}
    assert used == set(cols)
    refused = encoding.startswith("DELTA_") and encoding.endswith("ARRAY")
    for mode in ("off", "on"):
        _modes(mode)
        for kw in ({}, {"columns": ["S", "i64", "l"], "ignore_case": True}):
            tb = tparquet.read_parquet(path, device=CPU, **kw)
            jb = _reference(path, mode, refused, **kw)
            assert_batches_identical(jb, tb, f"{mode} {kw}")


CODEC_CASES = ("lz4", "zstd", "brotli")


@pytest.mark.parametrize("version", PAGE_VERSIONS)
@pytest.mark.parametrize("codec", CODEC_CASES)
def test_codec_parity(tmp_path, codec, version):
    """LZ4 (pyarrow writes LZ4_RAW), ZSTD and BROTLI pages, flat and
    nested, with dictionaries and a PLAIN fallback, read as the reference
    reads them, ``encoded_execution`` off and on, whole and split."""
    table = encodings_table(400, 29)
    path = str(tmp_path / f"{codec}.parquet")
    pq.write_table(table, path, row_group_size=150, data_page_size=600,
                   compression=codec, data_page_version=version,
                   dictionary_pagesize_limit=256, write_batch_size=64)
    size = os.path.getsize(path)
    for mode in ("off", "on"):
        _modes(mode)
        for kw in ({}, {"part_offset": 0, "part_length": size // 2}):
            assert_batches_identical(jparquet.read_parquet(path, **kw),
                                     tparquet.read_parquet(path, device=CPU,
                                                           **kw),
                                     f"{mode} {kw}")


def test_missing_codec_library_raises(tmp_path, monkeypatch):
    """A ZSTD or BROTLI page on a system without the library raises an
    ``OSError`` that names it: nothing falls back."""
    import ctypes
    import ctypes.util

    path = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"x": np.arange(50)}), path, compression="zstd")
    monkeypatch.setattr(PG, "_codec_libs", {})
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libzstd"):
        tparquet.read_parquet(path, device=CPU)
    with pytest.raises(OSError, match="libbrotlidec"):
        PG.decompress(PG.BROTLI, np.zeros(4, np.uint8), 4)
    assert PG.codec_libraries() == {"zstd": None, "brotlidec": None}


def test_lzo_raises_as_pyarrow_does():
    with pytest.raises(NotImplementedError, match="LZO"):
        PG.decompress(PG.LZO, np.zeros(4, np.uint8), 4)


def test_byte_array_decimals_from_the_harness_writer(tmp_path):
    """BYTE_ARRAY decimals (the shortest big-endian two's complement,
    precision 1 to 38, with nulls, flat and in a struct) read as the
    reference reads them; precision 38's extremes included."""
    rng = np.random.default_rng(31)
    n = 600
    cols = {}
    for p in (1, 9, 18, 19, 38):
        vals = [int(x) % (10 ** p) * (1 if i % 2 else -1)
                for i, x in enumerate(rng.integers(0, 2 ** 62, n))]
        vals[:2] = [10 ** p - 1, -(10 ** p - 1)]
        cols[f"d{p}"] = PW.Decimal(vals, p, min(p, 4) if p > 4 else 0,
                                   rng.random(n) > 0.1)
    cols["s"] = PW.Struct({"d": cols["d38"]}, rng.random(n) > 0.1)
    path = str(tmp_path / "dec.parquet")
    PW.write_parquet(path, cols, row_group_rows=250, page_rows=100,
                     codec="snappy", page_version=2)
    t = pq.read_table(path)
    assert t.column("d38").type == pa.decimal128(38, 4)
    for mode in ("off", "on"):
        _modes(mode)
        assert_batches_identical(jparquet.read_parquet(path),
                                 tparquet.read_parquet(path, device=CPU),
                                 mode)
    bad = np.frombuffer(bytes(17), np.uint8)
    with pytest.raises(ValueError, match="width or count"):
        PG.be_decimal_limbs(np.array([0, 17], np.int64), bad)


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
    corrupt page or footer, a mutated encoding or codec id) or
    NotImplementedError (a type the reference rejects, LZO); none fails
    any other way or reads past a buffer."""
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
    committed flat fixture and the nested ZSTD one to their digests."""
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
        "for name in ('fixture_v1.parquet', 'fixture_nested.parquet'):\n"
        f"    b = io.read_parquet({DATA!r} + '/' + name, device='cpu')\n"
        "    print(batch_digest(b))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [_digests()["fixture_v1.parquet"],
                                  _digests()["fixture_nested.parquet"]]
