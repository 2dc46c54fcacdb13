"""PyTorch port: the Parquet footer engine (``io/parquet_footer.py`` over
its own ``io/native/parquet_footer.cpp``), split and stats pruning
(``io/parquet.py``) and ``MorselSource.from_parquet`` against the JAX
package's.

Each test of the reference's ``tests/test_parquet_footer.py`` runs here on
both packages over the same pyarrow file, with the reference's assertions
(the two ``TestJniWireSchema`` tests wait for the JNI dispatch, ROADMAP
item 17): the serialized footers are byte for byte equal, and row counts,
column counts, kept row groups, pruned counts and read batches agree.
The files are written once per module.
"""

import io
import operator
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.io import ParquetFooter as JFooter
from spark_rapids_jni_tpu.io import parquet as jparquet
from spark_rapids_jni_tpu.io import parquet_footer as jfooter

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.io import ParquetFooter, read_footer_bytes
from spark_rapids_jni_tpu_torch.io import parquet as tparquet
from spark_rapids_jni_tpu_torch.io import parquet_footer as tfooter
from spark_rapids_jni_tpu_torch.io import thrift
from spark_rapids_jni_tpu_torch.io.metadata import read_metadata

from torch_parity import assert_col_equal, one_torch_thread  # noqa: F401

CPU = "cpu"
FOOTERS = (JFooter, ParquetFooter)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq_footer")
    out = {}
    out["flat"] = str(d / "flat.parquet")
    pq.write_table(pa.table({
        "a": pa.array(range(1000), pa.int64()),
        "b": pa.array([f"s{i}" for i in range(1000)]),
        "C": pa.array([float(i) for i in range(1000)])}),
        out["flat"], row_group_size=100)
    out["struct"] = str(d / "s.parquet")
    pq.write_table(pa.table({
        "s": pa.array([{"x": 1, "y": "a", "z": 2.0}] * 10),
        "plain": pa.array(range(10))}), out["struct"])
    out["list"] = str(d / "l.parquet")
    pq.write_table(pa.table({
        "l": pa.array([[1, 2], [3]], pa.list_(pa.int32())),
        "q": pa.array([1, 2])}), out["list"])
    out["map"] = str(d / "m.parquet")
    pq.write_table(pa.table({
        "m": pa.array([[("k", 1)], []], pa.map_(pa.string(), pa.int64())),
        "q": pa.array([1, 2])}), out["map"])
    out["gapped"] = str(d / "gapped.parquet")
    a = np.r_[np.arange(100), np.arange(100) + 1000,
              np.arange(100), np.arange(100) + 1000]
    pq.write_table(pa.table({"a": pa.array(a, pa.int64())}), out["gapped"],
                   row_group_size=100)
    rng = np.random.default_rng(8)
    n = 5000
    out["q6_arrays"] = (rng.integers(0, 50, n).astype(np.int32),
                        rng.integers(-1000, 1000, n), rng.random(n) * 100)
    out["q6"] = str(d / "q6.parquet")
    k, v, price = out["q6_arrays"]
    pq.write_table(pa.table({"k": k, "v": v, "price": price}), out["q6"],
                   row_group_size=512)
    return out


@pytest.fixture(autouse=True)
def _reset():
    yield
    config.reset()
    jconfig.reset()


def reparse(footer_file_bytes):
    """Read a serialized footer back with pyarrow."""
    return pq.read_metadata(io.BytesIO(footer_file_bytes))


def both(path_or_bytes, *args, **kw):
    """The footer through both engines: ``(reference, port)`` results of
    ``fn(footer)`` for each, with the serialized bytes held equal."""
    out = []
    for cls in FOOTERS:
        with cls.read_and_filter(path_or_bytes, *args, **kw) as f:
            out.append((f.num_rows, f.num_columns, f.num_row_groups,
                        f.serialize()))
    assert out[0] == out[1]
    return out[1]


class TestRoundTrip:
    def test_identity(self, files):
        rows, cols, groups, ser = both(files["flat"])
        assert (rows, cols, groups) == (1000, 3, 10)
        md = reparse(ser)
        assert md.num_rows == 1000
        assert md.num_columns == 3
        assert md.num_row_groups == 10
        assert [md.schema.column(i).name for i in range(3)] == ["a", "b", "C"]
        # the port's own thrift reader re-parses the serialized footer to
        # the same row groups
        mine = thrift.file_metadata(ser[4:-8])
        assert [g.num_rows for g in mine.row_groups] == [100] * 10

    def test_column_pruning(self, files):
        _, cols, _, ser = both(files["flat"], schema={"b": None})
        assert cols == 1
        md = reparse(ser)
        assert md.num_columns == 1
        assert md.schema.column(0).name == "b"
        assert md.row_group(0).num_columns == 1
        assert md.row_group(0).column(0).path_in_schema == "b"

    def test_case_insensitive(self, files):
        assert both(files["flat"], schema={"c": None, "A": None},
                    ignore_case=True)[1] == 2
        assert both(files["flat"], schema={"c": None},
                    ignore_case=False)[1] == 0

    def test_row_group_split_pruning(self, files):
        path = files["flat"]
        size = os.path.getsize(path)
        assert both(path, 0, size)[2] == 10
        r1, _, g1, _ = both(path, 0, size // 2)
        r2, _, g2, _ = both(path, size // 2, size - size // 2)
        assert g1 + g2 == 10 and r1 + r2 == 1000
        assert g1 > 0 and g2 > 0
        rows, _, groups, _ = both(path, size, 10)
        assert groups == 0 and rows == 0


class TestNested:
    def test_struct(self, files):
        md = reparse(both(files["struct"], schema={"s": {"y": None}})[3])
        assert md.num_columns == 1
        assert md.row_group(0).column(0).path_in_schema == "s.y"

    def test_list(self, files):
        md = reparse(both(files["list"], schema={"l": [None]})[3])
        assert md.num_columns == 1
        assert "l" in md.row_group(0).column(0).path_in_schema

    def test_map(self, files):
        md = reparse(both(files["map"], schema={"m": (None, None)})[3])
        assert md.num_columns == 2
        paths = {md.row_group(0).column(i).path_in_schema for i in range(2)}
        assert all("m." in p for p in paths)


def test_read_footer_bytes_rejects_garbage(tmp_path, files):
    p = str(tmp_path / "x.bin")
    with open(p, "wb") as f:
        f.write(b"not a parquet file")
    for fn in (jfooter.read_footer_bytes, read_footer_bytes):
        with pytest.raises(ValueError):
            fn(p)
    assert read_footer_bytes(files["flat"]) == \
        jfooter.read_footer_bytes(files["flat"])


def test_bad_thrift_raises():
    for cls in FOOTERS:
        with pytest.raises(ValueError):
            cls.read_and_filter(b"\xff\xff\xff\xff\xff")
    with pytest.raises(ValueError):
        thrift.file_metadata(b"\xff\xff\xff\xff\xff")


def test_empty_schema_prunes_everything(files):
    """schema={} means keep zero columns, unlike schema=None (keep all)."""
    assert both(files["flat"], schema={})[1] == 0


class TestParquetScan:
    def test_split_pruning_matches_native_engine(self, files):
        path = files["flat"]
        raw = read_footer_bytes(path)
        meta = read_metadata(path)
        jmeta = pq.ParquetFile(path).metadata
        size = os.path.getsize(path)
        for off, ln in [(0, size), (0, size // 2), (size // 2, size),
                        (0, 1), (size // 3, size // 3)]:
            native_rows = both(raw, part_offset=off, part_length=ln)[0]
            keep = tparquet.select_row_groups(meta, off, ln)
            assert keep == jparquet.select_row_groups(jmeta, off, ln)
            py_rows = sum(meta.row_group(i).num_rows for i in keep)
            assert py_rows == native_rows, (off, ln)
            batch = tparquet.read_parquet(path, part_offset=off,
                                          part_length=ln, device=CPU)
            assert batch.num_rows == native_rows

    def test_q6_from_parquet_matches_oracle(self, files):
        from spark_rapids_jni_tpu_torch import pipelines as PL
        from torch_parity import to_port

        k, v, price = files["q6_arrays"]
        mask = price < 50.0
        want = {}
        for kk in np.unique(k[mask]):
            sel = mask & (k == kk)
            want[int(kk)] = (int(v[sel].sum()), int(sel.sum()))
        for batch in (tparquet.read_parquet(files["q6"], device=CPU),
                      to_port(jparquet.read_parquet(files["q6"]))):
            got = PL.result_groups(*PL.q6_step(batch), "k")
            assert {g: (r["sum_v"], r["cnt"]) for g, r in got.items()} \
                == want

    def test_column_pruning_case_insensitive(self, files):
        for read in (jparquet.read_parquet,
                     lambda *a, **kw: tparquet.read_parquet(*a, device=CPU,
                                                            **kw)):
            batch = read(files["flat"], columns=["c"], ignore_case=True)
            assert list(batch.names) == ["C"]


class TestPredicatePruning:
    def test_stats_prune_drops_cold_groups(self, files):
        metas = (pq.ParquetFile(files["flat"]).metadata,
                 read_metadata(files["flat"]))
        for pred, want in ((("a", "<", 250), ([0, 1, 2], 7)),
                           (("a", ">=", 950), ([9], 9)),
                           (("a", "==", 437), ([4], 9))):
            for mod, meta in zip((jparquet, tparquet), metas):
                assert mod.prune_row_groups(meta, range(10), pred) == want

    def test_pruned_read_unions_to_exact_result(self, files):
        path = files["flat"]
        full = np.asarray(tparquet.read_parquet(
            path, columns=["a"], device=CPU)["a"].data)
        for pred in (("a", "<", 250), ("a", ">=", 950), ("a", "==", 437),
                     ("a", "!=", 0), ("a", "<=", 99), ("a", ">", 998)):
            col, op, v = pred
            got = tparquet.read_parquet(path, columns=["a"], predicate=pred,
                                        device=CPU)
            ref = jparquet.read_parquet(path, columns=["a"], predicate=pred)
            assert_col_equal(ref["a"], got["a"], msg=str(pred))
            a_got = got["a"].data.numpy()
            fn = {"<": operator.lt, "<=": operator.le, "==": operator.eq,
                  "!=": operator.ne, ">=": operator.ge,
                  ">": operator.gt}[op]
            assert sorted(a_got[fn(a_got, v)].tolist()) == \
                sorted(full[fn(full, v)].tolist()), pred

    def test_all_pruned_keeps_schema_group(self, files):
        for mod, meta in ((jparquet, pq.ParquetFile(files["flat"]).metadata),
                          (tparquet, read_metadata(files["flat"]))):
            assert mod.prune_row_groups(meta, range(10),
                                        ("a", "<", -5)) == ([0], 9)

    def test_unpushable_predicates_keep_everything(self, files):
        for mod, meta in ((jparquet, pq.ParquetFile(files["flat"]).metadata),
                          (tparquet, read_metadata(files["flat"]))):
            # string literal: not a stats-comparable value
            assert mod.prune_row_groups(meta, range(10),
                                        ("a", "<", "zzz"))[1] == 0
            # string stats vs an int literal: the TypeError guard keeps
            assert mod.prune_row_groups(meta, range(10),
                                        ("b", "<", 5))[1] == 0
            # unknown column: nothing to consult
            assert mod.prune_row_groups(meta, range(10),
                                        ("nope", "<", 5))[1] == 0

    def test_knob_off_keeps_everything(self, files):
        config.set("scan_pruning", False)
        jconfig.set("scan_pruning", False)
        for mod, meta in ((jparquet, pq.ParquetFile(files["flat"]).metadata),
                          (tparquet, read_metadata(files["flat"]))):
            assert mod.prune_row_groups(meta, range(10),
                                        ("a", "<", 250))[1] == 0

    def test_prune_spans_union_to_surviving_groups(self, files):
        path = files["gapped"]
        spans = tfooter.predicate_prune_spans(path, ("a", ">=", 900))
        assert spans == jfooter.predicate_prune_spans(path,
                                                      ("a", ">=", 900))
        assert len(spans) == 2  # non-consecutive survivors -> two runs
        groups = rows = 0
        for off, length in spans:
            r, _, g, _ = both(path, off, length)
            groups += g
            rows += r
        assert groups == 2 and rows == 200  # exactly groups 1 and 3

    def test_prune_spans_single_run(self, files):
        spans = tfooter.predicate_prune_spans(files["flat"], ("a", "<", 250))
        assert spans == jfooter.predicate_prune_spans(files["flat"],
                                                      ("a", "<", 250))
        assert len(spans) == 1
        off, length = spans[0]
        rows, _, groups, _ = both(files["flat"], off, length)
        assert groups == 3 and rows == 300

    def test_from_parquet_never_replays_pruned_groups(self, files,
                                                      eight_devices):
        from spark_rapids_jni_tpu.parallel import data_mesh
        from spark_rapids_jni_tpu.shuffle import MorselSource as JSource

        from spark_rapids_jni_tpu_torch.io import pages as PG
        from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        path = files["flat"]
        srcs = {}
        for label, mesh, cls in (("ref", data_mesh(8), JSource),
                                 ("port", ShardMesh(8, device=CPU),
                                  MorselSource)):
            src = cls.from_parquet(path, mesh, columns=["a"],
                                   morsel_rows=16, predicate=("a", "<", 250))
            full = cls.from_parquet(path, mesh, columns=["a"],
                                    morsel_rows=16)
            assert src.row_groups_pruned == 7
            assert src.row_groups_scanned == 3
            assert full.row_groups_pruned == 0
            assert len(src) < len(full)  # pruned groups built NO replays
            assert src.snapshot_id == full.snapshot_id
            assert src.snapshot_id.startswith("file:")
            srcs[label] = (src, full)
        PG.reset_stats()
        for (jsrc, jfull), (tsrc, tfull) in [(srcs["ref"], srcs["port"])]:
            assert (len(jsrc), len(jfull)) == (len(tsrc), len(tfull))
            seen = []
            for jrep, trep in zip(jsrc, tsrc):
                jb, jrv = jrep()
                tb, trv = trep()
                np.testing.assert_array_equal(trv.numpy(), np.asarray(jrv))
                a = tb["a"].data
                np.testing.assert_array_equal(
                    a.numpy()[trv.numpy()],
                    np.asarray(jb["a"].data)[np.asarray(jrv)])
                assert not a[~trv].any()  # padding rows are zero
                seen.extend(a[trv].tolist())
        # every row the filter may keep is present, no cold-group rows
        assert sorted(x for x in seen if x < 250) == list(range(250))
        assert all(x < 300 for x in seen)  # only groups 0..2 decoded
        # each replay decoded its whole row group: one decode a morsel
        assert PG.STATS["row_group_decodes"] == len(tsrc)
        assert isinstance(trv, torch.Tensor) and trv.shape == (8 * 16,)


def test_from_parquet_rank_builds_only_its_shards(files):
    """A rank of a process mesh (one local shard, ``first_shard`` r)
    builds each morsel's shard r and nothing else: the same rows and
    validity as shard r of the shard mesh's morsel."""
    from types import SimpleNamespace

    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource

    M = 16
    full = MorselSource.from_parquet(files["flat"], ShardMesh(8, device=CPU),
                                     columns=["a", "b"], morsel_rows=M)
    for r in (0, 3, 7):
        rank = SimpleNamespace(size=8, local_shards=1, first_shard=r,
                               device=torch.device(CPU))
        src = MorselSource.from_parquet(files["flat"], rank,
                                        columns=["a", "b"], morsel_rows=M)
        assert (len(src), src.rows) == (len(full), full.rows)
        for rep, frep in zip(src, full):
            (b, rv), (fb, frv) = rep(), frep()
            sl = slice(r * M, (r + 1) * M)
            assert torch.equal(rv, frv[sl])
            assert torch.equal(b["a"].data, fb["a"].data[sl])
            assert torch.equal(b["b"].chars, fb["b"].chars[sl])
            assert torch.equal(b["b"].lengths, fb["b"].lengths[sl])
