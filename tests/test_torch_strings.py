"""PyTorch port: string columns and the radix-key breadth (string words,
the f32 total order, narrow ints, timestamps, width alignment and the
lexicographic bisection), against the JAX package on the same numpy
inputs.  Bytes, key words and positions must be bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.relational import filter as JF
from spark_rapids_jni_tpu.relational import gather as JG
from spark_rapids_jni_tpu.relational import keys as JK

from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column, ColumnBatch, StringColumn, batch_from_numpy, batch_to_numpy,
    string_arrays)
from spark_rapids_jni_tpu_torch.relational import filter as TF
from spark_rapids_jni_tpu_torch.relational import gather as TG
from spark_rapids_jni_tpu_torch.relational import keys as TK

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

WORDS = ["", "a", "a\x00", "a\x00\x00", "ab", "abc", "abcd", "abcde", "b",
         "\xff", "zzzzzzzzz", "é", "ß-utf8"]


def _values(rng, n, pool=WORDS, null=0.1):
    return [None if rng.random() < null else pool[rng.integers(0, len(pool))]
            for _ in range(n)]


def _pair(values, max_len=None):
    return (JString.from_pylist(values, max_len=max_len),
            StringColumn.from_pylist(values, max_len=max_len, device="cpu"))


def _same_words(jw, tw):
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


class TestStringColumn:
    @pytest.mark.parametrize("max_len,mult", [(None, 1), (12, 1), (None, 4),
                                              (10, 8)])
    def test_from_pylist_matches_the_reference(self, max_len, mult):
        vals = _values(np.random.default_rng(1), 60)
        j = JString.from_pylist(vals, max_len=max_len, pad_to_multiple=mult)
        t = StringColumn.from_pylist(vals, max_len=max_len,
                                     pad_to_multiple=mult, device="cpu")
        assert t.max_len == j.max_len
        np.testing.assert_array_equal(t.chars.numpy(), np.asarray(j.chars))
        np.testing.assert_array_equal(t.lengths.numpy(),
                                      np.asarray(j.lengths))
        np.testing.assert_array_equal(t.validity.numpy(),
                                      np.asarray(j.validity))
        assert t.to_pylist() == j.to_pylist() == vals

    def test_too_long_and_empty(self):
        with pytest.raises(ValueError, match="exceeds max_len"):
            StringColumn.from_pylist(["abcdef"], max_len=3, device="cpu")
        e = StringColumn.from_pylist([], device="cpu")
        assert e.num_rows == 0 and e.max_len == 1

    def test_vectorised_builder_equals_from_pylist(self):
        rng = np.random.default_rng(2)
        codes = rng.integers(0, len(WORDS), 500)
        chars, lengths = string_arrays(WORDS, codes, 16)
        ref = StringColumn.from_pylist([WORDS[c] for c in codes], max_len=16,
                                       device="cpu")
        np.testing.assert_array_equal(chars, ref.chars.numpy())
        np.testing.assert_array_equal(lengths, ref.lengths.numpy())
        with pytest.raises(ValueError, match="exceeds max_len"):
            string_arrays(WORDS, codes, 4)

    def test_q6str_recipe_bytes_equal_the_reference(self):
        n = 3000
        jb = ge._q6str_batch(n)
        tb = TP.q6str_batch(n, device="cpu")
        for buf in ("chars", "lengths", "validity"):
            np.testing.assert_array_equal(getattr(tb["k"], buf).numpy(),
                                          np.asarray(getattr(jb["k"], buf)))
        for c in ("v", "price"):
            np.testing.assert_array_equal(tb[c].data.numpy(),
                                          np.asarray(jb[c].data))

    def test_batch_round_trip_bit_for_bit(self):
        rng = np.random.default_rng(3)
        j, _ = _pair(_values(rng, 40), max_len=10)
        tb = batch_from_numpy({"s": ((np.asarray(j.chars),
                                      np.asarray(j.lengths)),
                                     np.asarray(j.validity), "string")},
                              device="cpu")
        (chars, lengths), valid = batch_to_numpy(tb)["s"]
        np.testing.assert_array_equal(chars, np.asarray(j.chars))
        np.testing.assert_array_equal(lengths, np.asarray(j.lengths))
        np.testing.assert_array_equal(valid, np.asarray(j.validity))
        with pytest.raises(ValueError, match="disagree"):
            batch_from_numpy({"s": ((np.zeros((3, 4), np.uint8),
                                     np.zeros(2, np.int32)),
                                    np.ones(3, bool), "string")},
                             device="cpu")

    def test_gather_compact_and_apply_mask(self):
        rng = np.random.default_rng(4)
        j, t = _pair(_values(rng, 80), max_len=9)
        jb, tb = JBatch({"s": j}), ColumnBatch({"s": t})
        idx = rng.integers(-3, 90, 120)
        valid = rng.random(120) > 0.2
        jg = JG.gather_column(j, jnp.asarray(idx.astype(np.int32)),
                              jnp.asarray(valid))
        tg = TG.gather_column(t, torch.from_numpy(idx),
                              torch.from_numpy(valid))
        for buf in ("chars", "lengths", "validity"):
            np.testing.assert_array_equal(getattr(tg, buf).numpy(),
                                          np.asarray(getattr(jg, buf)))
        mask = rng.random(80) > 0.5
        jc, jn = JF.compact(jb, jnp.asarray(mask))
        tc, tn = TF.compact(tb, torch.from_numpy(mask))
        assert int(jn) == int(tn)
        assert tc["s"].to_pylist() == jc["s"].to_pylist()
        jm = JF.apply_mask(jb, jnp.asarray(mask))
        tm = TF.apply_mask(tb, torch.from_numpy(mask))
        assert tm["s"].to_pylist() == jm["s"].to_pylist()


class TestKeyWords:
    @pytest.mark.parametrize("width", [1, 3, 4, 5, 9, 24])
    def test_string_words_and_the_length_word(self, width):
        rng = np.random.default_rng(width)
        pool = [w for w in WORDS if len(w.encode()) <= width]
        j, t = _pair(_values(rng, 100, pool), max_len=width)
        for eq in (True, False):
            _same_words(JK.column_radix_keys(j, equality=eq),
                        TK.column_radix_keys(t, equality=eq))
        for nf in (True, False):
            _same_words(JK.batch_radix_keys([j], equality=True,
                                            nulls_first=nf),
                        TK.batch_radix_keys([t], equality=True,
                                            nulls_first=nf))
        words = TK.column_radix_keys(t)
        assert len(words) == max(1, -(-width // 4)) + 1

    @pytest.mark.parametrize("kind,np_dtype", [
        ("FLOAT32", np.float32), ("INT8", np.int8), ("INT16", np.int16),
        ("TIMESTAMP", np.int64)])
    def test_fixed_width_words(self, kind, np_dtype):
        rng = np.random.default_rng(5)
        n = 400
        if np_dtype == np.float32:
            v = (rng.standard_normal(n) * 1e3).astype(np.float32)
            v[:8] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                     np.finfo(np.float32).max, 1.5]
        else:
            info = np.iinfo(np_dtype)
            v = rng.integers(info.min, info.max, n, dtype=np_dtype,
                             endpoint=True)
        valid = rng.random(n) > 0.1
        jc = JColumn(jnp.asarray(v), jnp.asarray(valid), getattr(JT, kind))
        tc = Column(torch.from_numpy(v.copy()), torch.from_numpy(valid),
                    getattr(TT, kind))
        for eq in (True, False):
            _same_words(JK.column_radix_keys(jc, equality=eq),
                        TK.column_radix_keys(tc, equality=eq))

    def test_align_string_key_columns(self):
        rng = np.random.default_rng(6)
        short = [w for w in WORDS if len(w.encode()) <= 6]
        jl, tl = _pair(_values(rng, 30, short), max_len=6)
        jr, tr = _pair(_values(rng, 20), max_len=11)
        ja, jb2 = JK.align_string_key_columns([jl], [jr])
        ta, tb2 = TK.align_string_key_columns([tl], [tr])
        assert ta[0].max_len == tb2[0].max_len == ja[0].max_len == 11
        np.testing.assert_array_equal(ta[0].chars.numpy(),
                                      np.asarray(ja[0].chars))
        i = Column(torch.zeros(30, dtype=torch.int32),
                   torch.ones(30, dtype=torch.bool), TT.INT32)
        with pytest.raises(TypeError, match="key type mismatch"):
            TK.align_string_key_columns([tl], [i])

    def test_pair_packing_keeps_the_order(self):
        rng = np.random.default_rng(7)
        words = [torch.from_numpy(rng.choice(
            np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64), 500))
            for _ in range(5)]
        np.testing.assert_array_equal(TK.lexsort_u32(words).numpy(),
                                      TK.lexsort(words).numpy())


class TestBisection:
    def _sorted_and_queries(self, rng):
        vals = _values(rng, 300, null=0.05)
        j, t = _pair(vals, max_len=10)
        ja = JK.batch_radix_keys([j], equality=True, nulls_first=False)
        ta = TK.batch_radix_keys([t], equality=True, nulls_first=False)
        perm = TK.lexsort_u32(ta)
        js = [jnp.asarray(np.asarray(w)[perm.numpy()]) for w in ja]
        ts = [w[perm] for w in ta]
        qj, qt = _pair(_values(rng, 150, WORDS + ["zz", "a\x01", "0"],
                               null=0.1), max_len=10)
        return (js, ts, JK.batch_radix_keys([qj], equality=True,
                                            nulls_first=False),
                TK.batch_radix_keys([qt], equality=True, nulls_first=False))

    def test_lower_upper_and_equal_range(self):
        js, ts, qj, qt = self._sorted_and_queries(np.random.default_rng(8))
        lo_j = np.asarray(jax.jit(JK.lower_bound)(js, qj))
        hi_j = np.asarray(jax.jit(JK.upper_bound)(js, qj))
        np.testing.assert_array_equal(TK.lower_bound(ts, qt).numpy(), lo_j)
        np.testing.assert_array_equal(TK.upper_bound(ts, qt).numpy(), hi_j)
        lo, hi = TK.equal_range(ts, qt)
        jlo, jhi = jax.jit(JK.equal_range)(js, qj)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        assert (hi.numpy() > lo.numpy()).any()

    def test_arity_and_empty(self):
        js, ts, qj, qt = self._sorted_and_queries(np.random.default_rng(9))
        with pytest.raises(ValueError, match="arity mismatch"):
            TK.equal_range(ts, qt[:-1])
        empty = [w[:0] for w in ts]
        lo, hi = TK.equal_range(empty, qt)
        assert not lo.any() and not hi.any()
