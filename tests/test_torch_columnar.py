"""PyTorch port: columns, radix keys, gather/filter, against the JAX package.

Inputs are built once with numpy from a seed and fed to both packages; the
port runs on the CPU (``device="cpu"``), where every kernel wrapper runs
its plain version.  Radix words must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.relational import filter as JF
from spark_rapids_jni_tpu.relational import gather as JG
from spark_rapids_jni_tpu.relational import keys as JK

from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import (
    batch_from_numpy,
    batch_to_numpy,
)
from spark_rapids_jni_tpu_torch.relational import filter as TF
from spark_rapids_jni_tpu_torch.relational import gather as TG
from spark_rapids_jni_tpu_torch.relational import keys as TK


def to_port(jb):
    """A reference ColumnBatch carried across as host arrays."""
    return batch_from_numpy(
        {n: (np.asarray(c.data), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


def _mixed_batch(rng, n=300):
    f = rng.normal(size=n) * 1e3
    # no subnormals here: XLA's CPU backend treats them as zero in
    # compares (TestSubnormalKeys holds the port to Java's semantics)
    f[:10] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
              2.2250738585072014e-308, 1.0, -1.0, 0.0]
    cols = {
        "b": (rng.random(n) > 0.5, JT.BOOLEAN),
        "i": (rng.integers(-2**31, 2**31, n).astype(np.int32), JT.INT32),
        "l": (rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64), JT.INT64),
        "d": (rng.integers(-40000, 40000, n).astype(np.int32), JT.DATE),
        "f": (f, JT.FLOAT64),
    }
    return JBatch({name: JColumn(jnp.asarray(a),
                                 jnp.asarray(rng.random(n) > 0.15), t)
                   for name, (a, t) in cols.items()})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestBatchFromNumpy:
    def test_reference_batch_round_trips(self):
        jb = _mixed_batch(np.random.default_rng(0))
        tb = to_port(jb)
        assert tb.names == jb.names
        for name, (d, v) in batch_to_numpy(tb).items():
            jc = jb[name]
            np.testing.assert_array_equal(
                d.view(np.uint8), np.asarray(jc.data).view(np.uint8))
            np.testing.assert_array_equal(v, np.asarray(jc.validity))
            assert repr(tb[name].dtype) == repr(jc.dtype)

    def test_types_outside_the_slice_are_not_ported(self):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TT.from_name("decimal(10,2)")

    def test_shape_mismatch_rejected(self):
        with pytest.raises(ValueError):
            batch_from_numpy({"a": (np.zeros(3), np.ones(2, bool),
                                    "float64")}, device="cpu")

    def test_recipes_draw_the_reference_numbers(self):
        import __graft_entry__ as ge

        for a, b in zip(TP.example_arrays(1000, 11),
                        ge._example_arrays(1000, 11)):
            np.testing.assert_array_equal(a, b)
        arrs = TP.q95_arrays(4000, 5)
        jf, jd1, jd2 = ge._q95_batches(4000, 5)
        for part, jb in (("fact", jf), ("dim1", jd1), ("dim2", jd2)):
            assert list(arrs[part]) == list(jb.names)
            for name in jb.names:
                np.testing.assert_array_equal(arrs[part][name],
                                              np.asarray(jb[name].data))


class TestEntryPointsNeedCuda:
    """Without a GPU, entry points raise unless the caller asks for the
    CPU; they never move there on their own."""

    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_default_device_raises(self, no_cuda):
        cols = {"a": (np.zeros(3, np.int32), np.ones(3, bool), "int32")}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch_from_numpy(cols)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.example_batch(16)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.q95_batches(64)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.entry()
        with pytest.raises(RuntimeError):
            batch_from_numpy(cols, device="cuda")

    def test_explicit_cpu_runs(self, no_cuda):
        fn, (batch,) = TP.entry(device="cpu")
        res, ng = fn(batch)
        assert int(ng) == 100 and res["k"].data.device.type == "cpu"


class TestRadixKeys:
    @pytest.mark.parametrize("name", ["b", "i", "l", "d", "f"])
    @pytest.mark.parametrize("equality", [True, False])
    def test_column_words_bit_identical(self, name, equality):
        jb = _mixed_batch(np.random.default_rng(1))
        tb = to_port(jb)
        jw = JK.column_radix_keys(jb[name], equality=equality)
        tw = TK.column_radix_keys(tb[name], equality=equality)
        assert len(jw) == len(tw)
        for a, b in zip(jw, tw):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          _np(b))

    @pytest.mark.parametrize("nulls_first", [True, False])
    def test_batch_words_and_adjacency(self, nulls_first):
        jb = _mixed_batch(np.random.default_rng(2))
        tb = to_port(jb)
        names = ["i", "f", "l"]
        jw = JK.batch_radix_keys([jb[n] for n in names], equality=True,
                                 nulls_first=nulls_first)
        tw = TK.batch_radix_keys([tb[n] for n in names], equality=True,
                                 nulls_first=nulls_first)
        for a, b in zip(jw, tw):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          _np(b))
        # equal-adjacency over sorted words: same boundaries
        perm = TK.lexsort(tw)
        np.testing.assert_array_equal(
            _np(TK.rows_equal_adjacent([w[perm] for w in tw])),
            np.asarray(JK.rows_equal_adjacent(
                [jnp.asarray(np.asarray(w)[_np(perm)]) for w in jw])))

    def test_lexsort_is_the_stable_multi_operand_sort(self):
        import jax

        rng = np.random.default_rng(3)
        n = 500
        k1 = rng.integers(0, 4, n).astype(np.uint32)
        k2 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        k2[::3] = 7  # ties
        ref = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2),
                            jnp.arange(n, dtype=jnp.int32)), num_keys=2,
                           is_stable=True)[-1]
        got = TK.lexsort([torch.from_numpy(k1.astype(np.int64)),
                          torch.from_numpy(k2.astype(np.int64))])
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


class TestSubnormalKeys:
    def test_subnormals_keep_their_own_key(self):
        """Spark (Java ``Double.compare``) normalizes only -0.0 and NaN; a
        subnormal is a value of its own.  The reference on XLA's CPU
        backend compares subnormals as zero, so this is held against the
        Java semantics, not against the reference."""
        d = torch.tensor([1e-310, -1e-310, 5e-324, 0.0, -0.0],
                         dtype=torch.float64)
        from spark_rapids_jni_tpu_torch.columnar.column import Column

        col = Column(d, torch.ones(5, dtype=torch.bool), TT.FLOAT64)
        hi, lo = TK.column_radix_keys(col, equality=True)
        words = list(zip(_np(hi).tolist(), _np(lo).tolist()))
        assert words[3] == words[4]  # -0.0 == 0.0
        assert len(set(words[:4])) == 4
        order = _np(TK.lexsort([hi, lo])).tolist()
        assert order == [1, 3, 4, 2, 0]  # -1e-310 < 0 == -0 < 5e-324 < 1e-310


class TestGatherFilter:
    def test_gather_column_parity(self):
        rng = np.random.default_rng(4)
        jb = _mixed_batch(rng)
        tb = to_port(jb)
        idx = rng.integers(-5, jb.num_rows + 5, 400).astype(np.int32)
        valid = rng.random(400) > 0.3
        for name in jb.names:
            jc = JG.gather_column(jb[name], jnp.asarray(idx),
                                  jnp.asarray(valid))
            tc = TG.gather_column(tb[name], torch.from_numpy(idx),
                                  torch.from_numpy(valid))
            np.testing.assert_array_equal(
                _np(tc.data).view(np.uint8),
                np.asarray(jc.data).view(np.uint8))
            np.testing.assert_array_equal(_np(tc.validity),
                                          np.asarray(jc.validity))

    def test_compact_parity(self):
        rng = np.random.default_rng(5)
        jb = _mixed_batch(rng)
        tb = to_port(jb)
        mask = rng.random(jb.num_rows) > 0.6
        jr, jc = JF.compact(jb, jnp.asarray(mask))
        tr, tc = TF.compact(tb, torch.from_numpy(mask))
        assert int(jc) == int(tc)
        for name in jb.names:
            np.testing.assert_array_equal(
                _np(tr[name].data).view(np.uint8),
                np.asarray(jr[name].data).view(np.uint8))
            np.testing.assert_array_equal(_np(tr[name].validity),
                                          np.asarray(jr[name].validity))
