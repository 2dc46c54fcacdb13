"""PyTorch port: inner hash join and the dense-or-hash join, against the
JAX package's hash engine.  Live output rows and the match count must be
bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.relational import join as JJ

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
from spark_rapids_jni_tpu_torch.relational import join as TJ


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def to_port(jb):
    return batch_from_numpy(
        {n: (np.asarray(c.data), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


def _side(rng, n, keys, key_valid=0.9, key_type=JT.INT64):
    return JBatch({
        "key": JColumn(jnp.asarray(keys), jnp.asarray(rng.random(n)
                                                      < key_valid),
                       key_type),
        "x": JColumn(jnp.asarray(rng.integers(-99, 99, n)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INT64),
        "y": JColumn(jnp.asarray(rng.random(n)), jnp.ones((n,), jnp.bool_),
                     JT.FLOAT64)})


def assert_join_match(jres, jcnt, tres, tcnt):
    c = int(jcnt)
    assert int(tcnt) == c
    assert list(tres.names) == list(jres.names)
    m = min(c, jres.num_rows)
    for name in jres.names:
        np.testing.assert_array_equal(
            tres[name].validity[:m].numpy(),
            np.asarray(jres[name].validity)[:m], err_msg=name)
        np.testing.assert_array_equal(
            tres[name].data[:m].numpy().view(np.uint8),
            np.asarray(jres[name].data)[:m].view(np.uint8), err_msg=name)


class TestHashJoinInner:
    @pytest.mark.parametrize("dup", [False, True])
    def test_parity_with_nulls_and_duplicates(self, dup):
        rng = np.random.default_rng(1)
        nr = 300
        rkeys = (rng.integers(0, 120, nr) if dup
                 else rng.permutation(nr)).astype(np.int64)
        right = _side(rng, nr, rkeys)
        left = _side(rng, 900, rng.integers(-20, 320, 900).astype(np.int64))
        cap = 3000 if dup else None
        jr, jc = jax.jit(lambda a, b: JJ.hash_join(
            a, b, ["key"], ["key"], "inner", capacity=cap,
            engine="hash"))(left, right)
        tr, tc = TJ.hash_join(to_port(left), to_port(right), ["key"],
                              ["key"], "inner", capacity=cap)
        assert_join_match(jr, jc, tr, tc)

    def test_live_masks_and_truncation(self):
        rng = np.random.default_rng(2)
        right = _side(rng, 200, rng.integers(0, 50, 200).astype(np.int64))
        left = _side(rng, 400, rng.integers(0, 60, 400).astype(np.int64))
        lv = rng.random(400) > 0.3
        rv = rng.random(200) > 0.2
        jr, jc = jax.jit(lambda a, b, x, y: JJ.hash_join(
            a, b, ["key"], ["key"], "inner", capacity=500, left_valid=x,
            right_valid=y, engine="hash"))(left, right, jnp.asarray(lv),
                                           jnp.asarray(rv))
        tr, tc = TJ.hash_join(to_port(left), to_port(right), ["key"],
                              ["key"], "inner", capacity=500,
                              left_valid=torch.from_numpy(lv),
                              right_valid=torch.from_numpy(rv))
        assert int(tc) > 500  # truncated: count reports the true total
        assert_join_match(jr, jc, tr, tc)

    def test_float_and_multi_column_keys(self):
        rng = np.random.default_rng(3)
        f = rng.integers(0, 4, 300).astype(np.float64)
        f[:4] = [-0.0, 0.0, np.nan, -np.nan]
        right = _side(rng, 300, f, key_type=JT.FLOAT64)
        right = JBatch(dict(zip(right.names, right.columns),
                            k2=JColumn(jnp.asarray(rng.integers(0, 3, 300)
                                                   .astype(np.int32)),
                                       jnp.ones((300,), jnp.bool_),
                                       JT.INT32)))
        lf = rng.integers(0, 5, 500).astype(np.float64)
        lf[:3] = [0.0, np.nan, -0.0]
        left = _side(rng, 500, lf, key_type=JT.FLOAT64)
        left = JBatch(dict(zip(left.names, left.columns),
                           k2=JColumn(jnp.asarray(rng.integers(0, 3, 500)
                                                  .astype(np.int32)),
                                      jnp.ones((500,), jnp.bool_),
                                      JT.INT32)))
        jr, jc = jax.jit(lambda a, b: JJ.hash_join(
            a, b, ["key", "k2"], ["key", "k2"], capacity=20000,
            engine="hash"))(left, right)
        tr, tc = TJ.hash_join(to_port(left), to_port(right), ["key", "k2"],
                              ["key", "k2"], capacity=20000)
        assert_join_match(jr, jc, tr, tc)

    @pytest.mark.parametrize("nl,nr", [(0, 10), (10, 0)])
    def test_empty_sides(self, nl, nr):
        rng = np.random.default_rng(4)
        left = _side(rng, nl, np.arange(nl, dtype=np.int64))
        right = _side(rng, nr, np.arange(nr, dtype=np.int64))
        jr, jc = jax.jit(lambda a, b: JJ.hash_join(
            a, b, ["key"], ["key"], engine="hash"))(left, right)
        tr, tc = TJ.hash_join(to_port(left), to_port(right), ["key"],
                              ["key"])
        assert int(jc) == int(tc) == 0
        assert tr.num_rows == jr.num_rows

    @pytest.mark.parametrize("how", ["left", "right", "full", "semi",
                                     "anti"])
    def test_other_kinds_not_ported(self, how):
        rng = np.random.default_rng(5)
        b = to_port(_side(rng, 5, np.arange(5, dtype=np.int64)))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TJ.hash_join(b, b, ["key"], ["key"], how)

    def test_sort_engine_not_ported(self):
        tconfig.set("join_engine", "sort")
        rng = np.random.default_rng(6)
        b = to_port(_side(rng, 5, np.arange(5, dtype=np.int64)))
        with pytest.raises(NotImplementedError, match="sort join"):
            TJ.hash_join(b, b, ["key"], ["key"])


class TestDenseOrHash:
    def _dim(self, rng, nd, keys):
        return JBatch({
            "key": JColumn(jnp.asarray(keys.astype(np.int32)),
                           jnp.ones((nd,), jnp.bool_), JT.INT32),
            "d": JColumn(jnp.asarray(rng.integers(0, 9, nd)),
                         jnp.ones((nd,), jnp.bool_), JT.INT64)})

    @pytest.mark.parametrize("dense", [True, False])
    def test_both_branches(self, dense):
        rng = np.random.default_rng(7)
        nd = 64
        keys = np.arange(nd) if dense else rng.integers(0, nd, nd)
        dim = self._dim(rng, nd, keys)
        fact = _side(rng, 500, rng.integers(-3, nd + 3, 500)
                     .astype(np.int32), key_type=JT.INT32)
        lv = rng.random(500) > 0.1
        jr, jc = jax.jit(lambda a, b, x: JJ.join_dense_or_hash(
            a, b, "key", "key", nd, left_valid=x))(fact, dim,
                                                   jnp.asarray(lv))
        tr, tc = TJ.join_dense_or_hash(to_port(fact), to_port(dim), "key",
                                       "key", nd,
                                       left_valid=torch.from_numpy(lv))
        assert_join_match(jr, jc, tr, tc)
