"""PyTorch port: length-bucketed strings (``columnar/bucketed.py``)
against the JAX package's ``TestBucketing`` (``tests/test_bucketed.py``):
the same widths, the same buckets byte for byte, the same rows back."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import BucketedStringColumn as JBucketed
from spark_rapids_jni_tpu.columnar import StringColumn as JString
from spark_rapids_jni_tpu.columnar.bucketed import plan_widths as jplan

from spark_rapids_jni_tpu_torch.columnar.bucketed import (
    BucketedStringColumn, plan_widths)
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn

from torch_parity import port_col
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def same_buckets(jb, tb):
    assert tb.widths == jb.widths and tb.num_rows == jb.num_rows
    for jc, tc, jids, tids in zip(jb.buckets, tb.buckets, jb.row_ids,
                                  tb.row_ids):
        np.testing.assert_array_equal(tc.chars.numpy(), np.asarray(jc.chars))
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


class TestBucketing:
    def test_round_trip_with_nulls_and_empties(self):
        vals = ["a", None, "", "x" * 100, "hello", None, "y" * 700, "z"]
        b = BucketedStringColumn.from_pylist(vals, device="cpu")
        assert b.to_pylist() == vals and b.num_rows == len(vals)
        same_buckets(JBucketed.from_pylist(vals), b)

    @pytest.mark.parametrize("lens", [[5, 10], [5, 100], [100000], [],
                                      [32], [33], [2048, 1, 0], [40000]])
    def test_plan_widths_covers_max(self, lens):
        assert plan_widths(lens) == jplan(lens)
        assert plan_widths(lens, (4, 8)) == jplan(lens, (4, 8))

    def test_capacity_bound_vs_flat(self):
        vals = ["row-%d" % i for i in range(1000)] + ["X" * 8000]
        b = BucketedStringColumn.from_pylist(vals, device="cpu")
        assert b.total_char_capacity < len(vals) * 8192 / 50
        assert b.total_char_capacity >= sum(len(v) for v in vals)
        assert b.total_char_capacity == \
            JBucketed.from_pylist(vals).total_char_capacity

    def test_from_string_column_round_trip(self):
        vals = ["alpha", None, "beta" * 40, ""]
        jflat = JString.from_pylist(vals)
        b = BucketedStringColumn.from_string_column(port_col(jflat))
        assert b.to_pylist() == vals
        same_buckets(JBucketed.from_string_column(jflat), b)
        merged = b.merge()
        assert merged.to_pylist() == vals
        jm = JBucketed.from_string_column(jflat).merge()
        np.testing.assert_array_equal(merged.chars.numpy(),
                                      np.asarray(jm.chars))

    def test_merge_restores_row_order(self):
        vals = ["bb" * 60, "a", "ccc" * 300, "d"]
        b = BucketedStringColumn.from_pylist(vals, device="cpu")
        assert len(b.buckets) >= 2
        assert b.merge().to_pylist() == vals

    def test_apply_column_merges_per_bucket_results(self):
        from spark_rapids_jni_tpu_torch.columnar import types as T
        from spark_rapids_jni_tpu_torch.columnar.column import Column

        vals = ["bb" * 60, None, "a", "ccc" * 300, "d"]
        b = BucketedStringColumn.from_pylist(vals, device="cpu")
        out = b.apply_column(lambda s: Column(s.lengths, s.validity,
                                              T.INT32))
        assert out.data.tolist() == [120, 0, 1, 900, 1]
        assert out.validity.tolist() == [v is not None for v in vals]
        widened = b.apply(lambda s: s)
        assert isinstance(widened, BucketedStringColumn)
        assert isinstance(widened.merge(), StringColumn)


class TestBucketedJson:
    """The reference's ``TestBucketedJson`` cases on the port: a bucketed
    input evaluates per bucket and returns a bucketed result equal to the
    flat column's (``get_json_object`` also against the JSON oracle;
    ``substring`` also against the JAX package's flat result)."""

    def test_get_json_object_parity_with_flat(self):
        import json_oracle

        from spark_rapids_jni_tpu_torch.ops.get_json_object import \
            get_json_object

        docs = (['{"owner":"amy%d","id":%d}' % (i, i) for i in range(40)]
                + ['{"pad":"%s","owner":"big"}' % ("p" * 600)]  # outlier
                + [None, "not json", '{"owner": null}'])
        flat = StringColumn.from_pylist(docs, pad_to_multiple=32,
                                        device="cpu")
        want = get_json_object(flat, "$.owner").to_pylist()
        assert want == [json_oracle.get_json_object(d, "$.owner")
                        for d in docs]
        b = BucketedStringColumn.from_pylist(docs, device="cpu")
        got = get_json_object(b, "$.owner")
        assert isinstance(got, BucketedStringColumn)
        assert got.to_pylist() == want
        assert got.merge().to_pylist() == want

    def test_substring_parity(self):
        from spark_rapids_jni_tpu.ops.strings import substring as jsubstring

        from spark_rapids_jni_tpu_torch.ops.strings import substring

        uris = ([f"https://h{i}.example.com:80/p{i}?q={i}#f"
                 for i in range(30)]
                + ["https://long.example.com/" + "seg/" * 200, None,
                   "not a uri"])
        want = jsubstring(JString.from_pylist(uris, pad_to_multiple=16),
                          9, 12).to_pylist()
        flat = StringColumn.from_pylist(uris, pad_to_multiple=16,
                                        device="cpu")
        assert substring(flat, 9, 12).to_pylist() == want
        b = BucketedStringColumn.from_pylist(uris, device="cpu")
        got = substring(b, 9, 12)
        assert isinstance(got, BucketedStringColumn)
        assert got.to_pylist() == want
