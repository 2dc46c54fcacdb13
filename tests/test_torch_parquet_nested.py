"""PyTorch port: the rest of Parquet against the JAX package's pyarrow scan.

Nested columns: every shape the reference reads (lists of ints, strings,
structs, lists, decimals, bools and zoned timestamps; structs of lists and
of dictionary strings; large lists; empty and all-null lists; a nullable
struct with a REQUIRED field) written by pyarrow with small pages and row
groups, so lists cross page and row-group boundaries, under page versions
1.0 and 2.0, dictionaries on and off and ``encoded_execution`` off and on,
read bit for bit as the reference's ``read_parquet`` reads them (names,
types with their time zones, validity, offsets, chars and lengths, limbs,
dictionary buffers).  The legacy list forms (a 2-level repeated ``array``,
a bare repeated field, a one-field ``array`` group read as a struct) come
from the harness writer (``tests/parquet_writer.py``), whose v2 pages,
DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, ZSTD and Hadoop-LZ4 pages and
BYTE_ARRAY decimals pyarrow reads back.  The footer's ``ARROW:schema``:
time zones on ms/us/ns timestamps, durations, fixed-size lists, list and
string views and maps raising in both packages, a dictionary-typed int
and a date64 reading as their plain types.  Corrupt DELTA, LZ4 and ZSTD
pages raise ``ValueError``.
"""

import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.io import parquet as jparquet

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.io import arrow_schema
from spark_rapids_jni_tpu_torch.io import pages as PG
from spark_rapids_jni_tpu_torch.io import parquet as tparquet
from spark_rapids_jni_tpu_torch.io.metadata import read_metadata

import parquet_writer as PW
from parquet_tables import (dictionary_string_table, harness_columns,
                            nested_table)
from test_torch_parquet_decode import assert_batches_identical
from torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
NESTED_ROWS, NESTED_SEED = 360, 16


SHAPES = [c for c in nested_table(4, 0).column_names if c != "flat"]
VERSIONS = ("1.0", "2.0")


@pytest.fixture(autouse=True)
def _reset():
    yield
    config.reset()
    jconfig.reset()


def _modes(mode):
    config.set("encoded_execution", mode)
    jconfig.set("encoded_execution", mode)


@pytest.fixture(scope="module")
def nested_dir(tmp_path_factory):
    """The nested table under each page version, dictionary on and off:
    row groups of 100 rows and 256-byte pages, so lists cross both."""
    d = tmp_path_factory.mktemp("pq_nested")
    table = nested_table(NESTED_ROWS, NESTED_SEED)
    for ver in VERSIONS:
        for dk in ("dict", "plain"):
            pq.write_table(table, str(d / f"{ver}-{dk}.parquet"),
                           row_group_size=100, data_page_size=256,
                           write_batch_size=16, data_page_version=ver,
                           use_dictionary=dk == "dict",
                           compression="zstd" if dk == "dict" else "snappy")
    return d


def _same(path, modes=("off", "on"), **kw):
    for mode in modes:
        _modes(mode)
        jb = jparquet.read_parquet(path, **kw)
        tb = tparquet.read_parquet(path, device=CPU, **kw)
        assert tb.num_rows == jb.num_rows
        assert_batches_identical(jb, tb, f"{mode} {kw}")


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_nested_shape_parity(nested_dir, shape, version):
    """Each shape, dictionary pages and ZSTD under page version 1.0,
    PLAIN and SNAPPY under 2.0 (the split tests read the other
    pairings)."""
    dk = "dict" if version == "1.0" else "plain"
    _same(str(nested_dir / f"{version}-{dk}.parquet"), columns=[shape])


def test_nested_pages_cross_rows_and_row_groups(nested_dir):
    """The files really hold lists across pages and row groups: several
    pages per chunk, several row groups, repetition levels in both page
    versions."""
    for ver in VERSIONS:
        path = str(nested_dir / f"{ver}-plain.parquet")
        md = pq.ParquetFile(path).metadata
        assert md.num_row_groups == 4
        meta = read_metadata(path)
        (li,) = meta.columns["li"].leaf_indices()
        assert meta.leaves[li].max_rep == 1 and meta.leaves[li].max_def == 3
        PG.reset_stats()
        tparquet.read_parquet(path, columns=["ll"], device=CPU)
        assert PG.STATS["pages"] > 2 * md.num_row_groups


@pytest.mark.parametrize("version", VERSIONS)
def test_nested_splits_and_selection(nested_dir, version):
    """Splits, case-insensitive selection and a flat predicate over a file
    of nested columns; statistics on a nested path prune nothing."""
    path = str(nested_dir / f"{version}-dict.parquet")
    size = os.path.getsize(path)
    for kw in (dict(part_offset=0, part_length=size // 2),
               dict(part_offset=size // 2, part_length=size),
               dict(columns=["LST", "flat", "STL"], ignore_case=True),
               dict(columns=["ll", "flat"], predicate=("flat", "<", 200)),
               dict(columns=["st"], predicate=("st.a", ">", 10 ** 9))):
        _same(path, **kw)
    meta = read_metadata(path)
    keep, pruned = tparquet.prune_row_groups(
        meta, range(meta.num_row_groups), ("st.a", ">", 10 ** 9))
    assert pruned == 0 and keep == list(range(meta.num_row_groups))


def test_nested_row_group_readers_and_morsels(nested_dir):
    """``row_group_readers`` and ``MorselSource.from_parquet`` read nested
    columns; an exchange of them raises in both packages, as before."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                    ShuffleRegistry,
                                                    ShuffleService)
    from spark_rapids_jni_tpu_torch.shuffle.morsel import batch_digest

    path = str(nested_dir / "2.0-plain.parquet")
    readers = tparquet.row_group_readers(path, device=CPU)
    jreaders = jparquet.row_group_readers(path)
    assert [r for _, r in readers] == [r for _, r in jreaders]
    for (read, _), (jread, _) in zip(readers, jreaders):
        assert_batches_identical(jread(), read())
    mesh = ShardMesh(2, device=CPU)
    src = MorselSource.from_parquet(path, mesh, columns=["flat", "li"],
                                    morsel_rows=64)
    assert src.rows == NESTED_ROWS and len(src) > 1
    whole = tparquet.read_parquet(path, columns=["flat", "li"], device=CPU)
    assert batch_digest(whole) == batch_digest(
        tparquet.read_parquet(path, columns=["flat", "li"], device=CPU))
    svc = ShuffleService(mesh, registry=ShuffleRegistry())
    with pytest.raises(NotImplementedError, match="list"):
        svc.exchange_stream(src, key_names=["flat"])


@pytest.mark.parametrize("version", VERSIONS)
def test_nested_strings_stay_char_matrices(tmp_path, version):
    """Under ``encoded_execution`` a nested string stays a char matrix,
    padded to 8, unless the Arrow schema says it was written from a
    dictionary: pyarrow restores that type, and the reference carries a
    dictionary column, in ``read_parquet`` and in ``row_group_readers``.
    (One row group: pyarrow cannot read a nested dictionary column into
    chunks.)"""
    from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
    from spark_rapids_jni_tpu_torch.columnar.encoded import is_encoded

    path = str(tmp_path / "dict.parquet")
    pq.write_table(dictionary_string_table(200, 4), path,
                   data_page_version=version, data_page_size=128)
    _same(path)
    _modes("on")
    tb = tparquet.read_parquet(path, device=CPU)
    assert isinstance(tb["ls"].child, StringColumn)
    assert tb["ls"].child.chars.shape[1] % 8 == 0
    assert is_encoded(tb["ldict"].child) and is_encoded(tb["tdict"])
    assert is_encoded(tb["sdict"].children[0])
    for mode in ("off", "on"):
        _modes(mode)
        (read, _), = tparquet.row_group_readers(path, device=CPU)
        (jread, _), = jparquet.row_group_readers(path)
        assert_batches_identical(jread(), read(), mode)


# ---------------------------------------------------------------------------
# the harness writer: legacy lists, v2, DELTA, BYTE_STREAM_SPLIT, ZSTD, LZ4
# ---------------------------------------------------------------------------

HARNESS_ENCODINGS = {"k": "delta", "v": "delta", "price": "bss",
                     "s.a": "bss", "s.b": "delta",
                     "tags.list.element": "delta", "two.array": "bss"}


@pytest.mark.parametrize("codec,version,level", [
    ("zstd", 1, 3), ("zstd", 2, None), ("lz4_hadoop", 1, 3),
    ("lz4_hadoop", 2, 3), ("none", 2, 3), ("snappy", 1, 3)])
def test_harness_writer_nested_encodings_codecs(tmp_path, codec, version,
                                                level):
    """What the harness writer writes, pyarrow reads back as written, and
    the port reads as the reference does (``level`` None: ZSTD frames of
    raw blocks)."""
    n = 1500
    cols = harness_columns(n, 5)
    path = str(tmp_path / "h.parquet")
    PW.write_parquet(path, cols, row_group_rows=500, page_rows=150,
                     codec=codec, encoding=HARNESS_ENCODINGS,
                     page_version=version, zstd_level=level)
    t = pq.read_table(path)
    k, valid = cols["k"][0], cols["v"][1]
    np.testing.assert_array_equal(t.column("k").to_numpy(), k)
    assert t.column("v").to_pylist() == [
        int(x) if ok else None for x, ok in zip(cols["v"][0], valid)]
    offs = cols["tags"].offsets
    tags = cols["tags"].child[0]
    assert t.column("two").to_pylist() == [
        tags[offs[i]:offs[i + 1]].tolist() for i in range(n)]
    assert t.column("bare").to_pylist() == t.column("two").to_pylist()
    assert t.column("dec").type == pa.decimal128(38, 2)
    wide = decimal.Context(prec=60)
    assert t.column("dec").to_pylist()[:50] == [
        decimal.Decimal(x).scaleb(-2, wide) if ok else None
        for x, ok in zip(cols["dec"].values[:50], valid[:50])]
    assert pa.types.is_struct(t.column("arr").type.value_type)
    md = pq.ParquetFile(path).metadata.row_group(0)
    encs = {md.column(i).path_in_schema: md.column(i).encodings
            for i in range(md.num_columns)}
    assert "DELTA_BINARY_PACKED" in encs["k"]
    assert "BYTE_STREAM_SPLIT" in encs["price"]
    assert "DELTA_BINARY_PACKED" in encs["tags.list.element"]
    _same(path)


def test_legacy_list_forms_read_as_the_reference(tmp_path):
    """parquet-cpp's backward-compatibility rules: a repeated primitive
    under LIST is the element; a repeated group named ``array`` (or
    ``*_tuple``) or with several fields is a struct element; a bare
    repeated field is a list of non-null elements."""
    cols = harness_columns(300, 9)
    path = str(tmp_path / "legacy.parquet")
    PW.write_parquet(path, {k: cols[k] for k in ("two", "bare", "arr")},
                     row_group_rows=100, page_rows=40, codec="none")
    meta = read_metadata(path)
    assert [lf.dotted for lf in meta.leaves] == ["two.array", "bare",
                                                 "arr.array.x"]
    assert repr(meta.column_type("two")) == "list<int32>"
    assert repr(meta.column_type("bare")) == "list<int32>"
    assert repr(meta.column_type("arr")) == "list<struct<x:int32>>"
    _same(path, modes=("off",))


# ---------------------------------------------------------------------------
# the Arrow schema
# ---------------------------------------------------------------------------

ARROW_CASES = {
    "ts_us_utc": pa.array([1, None, -5], pa.timestamp("us", tz="UTC")),
    "ts_ns_offset": pa.array([1999, None, -1001],
                             pa.timestamp("ns", tz="+02:00")),
    "ts_ms_zone": pa.array([1, None, -5],
                           pa.timestamp("ms", tz="America/New_York")),
    "ts_naive": pa.array([1, None, -5], pa.timestamp("us")),
    "list_ts": pa.array([[1], None, []],
                        pa.list_(pa.timestamp("us", tz="Asia/Tokyo"))),
    "dict_int": pa.array([1, 2, 1]).dictionary_encode(),
    "dict_str": pa.array(["a", None, "a"]).dictionary_encode(),
    "date64": pa.array([86_400_000, None, 0], pa.date64()),
    "large_string": pa.array(["a", None, "bc"], pa.large_string()),
}
ARROW_REJECTED = {
    "duration": pa.array([1, None, 3], pa.duration("us")),
    "list_duration": pa.array([[1], None, []], pa.list_(pa.duration("ms"))),
    "fixed_size_list": pa.array([[1, 2], [3, 4], [5, 6]],
                                pa.list_(pa.int32(), 2)),
    "list_view": pa.array([[1], None, [2, 3]], pa.list_view(pa.int32())),
    "string_view": pa.array(["a", None, "b"], pa.string_view()),
    "large_binary": pa.array([b"a", None, b"b"], pa.large_binary()),
    "fixed_size_binary": pa.array([b"ab", None, b"cd"], pa.binary(2)),
    "time32": pa.array([1, None, 2], pa.time32("ms")),
    "map": pa.array([[("a", 1)], None, []], pa.map_(pa.string(),
                                                    pa.int32())),
    "struct_of_map": pa.StructArray.from_arrays(
        [pa.array([[("a", 1)], None, []], pa.map_(pa.string(), pa.int32())),
         pa.array([1, 2, 3])], ["m", "i"]),
}


@pytest.mark.parametrize("name", sorted(ARROW_CASES))
def test_arrow_schema_types(tmp_path, name):
    """Zoned timestamps keep their zone (``tz`` on every level); a
    dictionary-typed int and a date64 read as their plain types; with
    and without the ``ARROW:schema`` key."""
    t = pa.table({"x": ARROW_CASES[name], "y": pa.array([1, 2, 3])})
    for store in (True, False):
        path = str(tmp_path / f"{name}-{store}.parquet")
        pq.write_table(t, path, store_schema=store)
        assert (read_metadata(path).arrow_fields is not None) == store
        _same(path)
    if name.startswith("ts_") and name != "ts_naive":
        tb = tparquet.read_parquet(str(tmp_path / f"{name}-True.parquet"),
                                   device=CPU)
        assert tb["x"].dtype.tz == t.schema.field("x").type.tz


@pytest.mark.parametrize("name", sorted(ARROW_REJECTED))
def test_arrow_types_the_reference_rejects_raise(tmp_path, name):
    """A type the reference's ``array_to_column`` rejects raises
    ``NotImplementedError`` in both packages; the column beside it reads."""
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(pa.table({"x": ARROW_REJECTED[name],
                             "y": pa.array([1, 2, 3])}), path)
    with pytest.raises(NotImplementedError):
        jparquet.read_parquet(path)
    with pytest.raises(NotImplementedError):
        tparquet.read_parquet(path, device=CPU)
    with pytest.raises(NotImplementedError):
        tparquet.row_group_readers(path, device=CPU)
    _same(path, columns=["y"])


def test_arrow_schema_decoder():
    """The flatbuffer walk gives pyarrow's own schema back: names,
    nullability, type ids, zones, units, children, dictionaries; a
    corrupt value raises ValueError."""
    schema = pa.schema([
        pa.field("t", pa.timestamp("ns", tz="+05:30"), nullable=False),
        pa.field("l", pa.list_(pa.struct([("a", pa.int8()),
                                           ("d", pa.duration("s"))]))),
        pa.field("s", pa.dictionary(pa.int16(), pa.string()))])
    raw = schema.serialize().to_pybytes()
    import base64

    fields = arrow_schema.decode(base64.b64encode(raw).decode())
    assert [f.name for f in fields] == ["t", "l", "s"]
    assert (fields[0].type, fields[0].unit, fields[0].tz,
            fields[0].nullable) == ("Timestamp", "ns", "+05:30", False)
    inner = fields[1].children[0]
    assert fields[1].type == "List" and inner.type == "Struct"
    assert [(c.name, c.type) for c in inner.children] == [
        ("a", "Int"), ("d", "Duration")]
    assert inner.children[1].unit == "s"
    assert fields[2].dictionary and fields[2].type == "Utf8"
    for bad in (raw[:12], raw[:-40] + b"\xff" * 40, b"\x00" * 8):
        with pytest.raises(ValueError):
            arrow_schema.decode(base64.b64encode(bad).decode())


# ---------------------------------------------------------------------------
# corrupt pages
# ---------------------------------------------------------------------------

def _dbp(values):
    return np.frombuffer(PW.delta_binary_packed(np.asarray(values)),
                         np.uint8)


def test_delta_binary_packed_round_trip_and_corruption():
    """The native decoder reads the harness encoder's blocks (wrap-around
    deltas, widths 0..64, a partial last block) and refuses truncated or
    malformed ones."""
    rng = np.random.default_rng(3)
    for vals in (rng.integers(-2 ** 63, 2 ** 63, 1000, dtype=np.int64),
                 np.full(300, 7, np.int64), np.arange(129, dtype=np.int64),
                 rng.integers(-2 ** 31, 2 ** 31, 777).astype(np.int32),
                 np.array([5], np.int64), np.zeros(0, np.int64)):
        buf = _dbp(vals)
        got, used = PG.delta_binary_packed(buf, vals.shape[0])
        np.testing.assert_array_equal(got.astype(vals.dtype), vals)
        assert used == buf.size
    buf = _dbp(rng.integers(-2 ** 40, 2 ** 40, 1000, dtype=np.int64))
    for bad in (buf[:buf.size // 2], buf[:3]):
        with pytest.raises(ValueError, match="runs past"):
            PG.delta_binary_packed(bad, 1000)
    # a block of 127 values: not a multiple of 128
    flipped = np.frombuffer(PW._varint(127) + buf[2:].tobytes(), np.uint8)
    with pytest.raises(ValueError, match="width or count"):
        PG.delta_binary_packed(flipped, 1000)
    with pytest.raises(ValueError, match="holds"):
        PG.delta_binary_packed(buf, 1001)
    wide = buf.copy()
    wide[6 + len(PW._varint(PW._zz(int(-2 ** 40))))] = 65  # a 65-bit width
    with pytest.raises(ValueError):
        PG.delta_binary_packed(wide, 1000)


def test_lz4_and_zstd_pages_round_trip_and_corruption():
    """LZ4 (raw and Hadoop-framed, liblz4 or literal blocks) and ZSTD
    (libzstd or raw blocks) decode what the harness writes; truncated or
    bit-flipped pages raise ValueError."""
    data = (b"abcdefgh" * 3000 + bytes(range(256)) * 40)
    arr = np.frombuffer(data, np.uint8)
    for codec, body in ((PG.LZ4_RAW, PW.lz4_block(data)),
                        (PG.LZ4, PW.lz4_hadoop(data)),
                        (PG.LZ4, PW.lz4_block(data)),  # an old raw page
                        (PG.ZSTD, PW.zstd_frames(data, 3)),
                        (PG.ZSTD, PW.zstd_frames(data, None))):
        b = np.frombuffer(body, np.uint8)
        assert PG.decompress(codec, b, len(data)).tobytes() == data
        with pytest.raises(ValueError):
            PG.decompress(codec, b[:len(b) // 2], len(data))
        with pytest.raises(ValueError):
            PG.decompress(codec, b, len(data) + 1)
    lit = PW.lz4_block(b"x" * 40 + data[:100])
    # a match offset past the start of the output
    bad = bytes([0x1F, 0x41, 0x05, 0x00, 0x10])
    with pytest.raises(ValueError, match="before its start"):
        PG.decompress(PG.LZ4_RAW, np.frombuffer(bad, np.uint8), 40)
    zs = bytearray(PW.zstd_frames(data, 3))
    zs[0] ^= 0xFF  # the frame's magic
    with pytest.raises(ValueError, match="zstd"):
        PG.decompress(PG.ZSTD, np.frombuffer(bytes(zs), np.uint8),
                      len(data))
    assert PG.decompress(PG.LZ4_RAW, np.frombuffer(lit, np.uint8),
                         140).tobytes() == b"x" * 40 + data[:100]


def test_corrupt_nested_page_raises(tmp_path):
    """A nested leaf whose repetition levels start inside a row, or whose
    levels disagree with its rows, raises ValueError."""
    cols = harness_columns(200, 2)
    path = str(tmp_path / "n.parquet")
    PW.write_parquet(path, {"tags": cols["tags"]}, row_group_rows=200,
                     page_rows=200, codec="none")
    with pytest.raises(ValueError, match="levels"):
        PG.assemble_levels(np.array([1, 0], np.int32),
                           np.array([3, 3], np.int32), 2,
                           [(2, 0, 1, 2), (0, 1, 3, 0)])
    with pytest.raises(ValueError, match="levels"):
        PG.assemble_levels(np.array([0, 1], np.int32),
                           np.array([3, 1], np.int32), 2,
                           [(2, 0, 1, 2), (0, 1, 3, 0)])
    raw = bytearray(open(path, "rb").read())
    meta = read_metadata(path)
    col = meta.row_group(0).column(0)
    from spark_rapids_jni_tpu_torch.io import thrift

    _, body = thrift.page_header(bytes(raw), col.data_page_offset)
    raw[body + 4] ^= 0x01  # the first repetition run's header
    bad = str(tmp_path / "bad.parquet")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError):
        tparquet.read_parquet(bad, device=CPU)


def test_decimal256_field_reads_its_values(tmp_path):
    """An Arrow ``decimal256`` of precision 38 or less is stored as a
    Parquet DECIMAL and restored by pyarrow as decimal256: the reference
    then reads 16-byte limbs out of the 32-byte buffer (a reference
    caveat: every other row comes back 0), the port reads the values."""
    path = str(tmp_path / "d256.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 2, None, -4],
                                           pa.decimal256(10, 2))}), path)
    tb = tparquet.read_parquet(path, device=CPU)
    assert repr(tb["x"].dtype) == "decimal(10,2)"
    assert tb["x"].to_pylist() == [100, 200, None, -400]  # unscaled
    assert jparquet.read_parquet(path)["x"].to_unscaled_pylist() == [
        100, 0, None, 0]


def test_deprecated_bit_packed_levels():
    """v1 levels in the deprecated BIT_PACKED encoding (no length, MSB
    first) decode, and the bytes after them are the values'."""
    lv = np.array([0, 1, 2, 3, 1, 0, 2], np.int32)
    bits = ((lv[:, None] >> np.array([1, 0])) & 1).astype(np.uint8)
    buf = np.concatenate([np.packbits(bits.reshape(-1)), [9, 9]])
    got, rest = PG._v1_levels(buf.astype(np.uint8), 7, 3, PG.BIT_PACKED,
                              "levels")
    np.testing.assert_array_equal(got, lv)
    assert rest.tolist() == [9, 9]
    with pytest.raises(ValueError, match="past its maximum"):
        PG._levels(np.packbits(bits.reshape(-1)), 7, 2, PG.BIT_PACKED)
