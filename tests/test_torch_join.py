"""PyTorch port: hash_join (every kind, both engines, plain, string and
multi-column keys) and the dense-or-hash join, against the JAX package's
engines.  Live output rows and the match count must be bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.relational import join as JJ

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import (Decimal128Column,
                                                        StringColumn)
from spark_rapids_jni_tpu_torch.relational import join as TJ

from torch_parity import jdecimal, to_port, unscaled
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


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
        if isinstance(tres[name], Decimal128Column):
            np.testing.assert_array_equal(
                tres[name].limbs[:m].numpy().view(np.uint64),
                np.asarray(jres[name].limbs)[:m], err_msg=name)
            continue
        if isinstance(tres[name], StringColumn):
            for buf in ("chars", "lengths"):
                np.testing.assert_array_equal(
                    getattr(tres[name], buf)[:m].numpy(),
                    np.asarray(getattr(jres[name], buf))[:m],
                    err_msg=f"{name}.{buf}")
            continue
        np.testing.assert_array_equal(
            tres[name].data[:m].numpy().view(np.uint8),
            np.asarray(jres[name].data)[:m].view(np.uint8), err_msg=name)


ENGINES = (("hash", "kernel"), ("sort", "sort"))


def _both(left, right, lon, ron, how, jengine, tengine, lv=None, rv=None,
          **kw):
    """One join through both packages; asserts the live rows match."""
    jr, jc = jax.jit(lambda a, b, x, y: JJ.hash_join(
        a, b, lon, ron, how, left_valid=x, right_valid=y, engine=jengine,
        **kw))(left, right, None if lv is None else jnp.asarray(lv),
               None if rv is None else jnp.asarray(rv))
    tr, tc = TJ.hash_join(to_port(left), to_port(right), lon, ron, how,
                          left_valid=None if lv is None
                          else torch.from_numpy(lv),
                          right_valid=None if rv is None
                          else torch.from_numpy(rv),
                          engine=tengine, **kw)
    assert_join_match(jr, jc, tr, tc)
    return tr, tc


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
        """Once item 10's gap, every other kind now matches the
        reference's hash engine."""
        rng = np.random.default_rng(5)
        right = _side(rng, 40, rng.integers(0, 30, 40).astype(np.int64))
        left = _side(rng, 60, rng.integers(-5, 35, 60).astype(np.int64))
        _both(left, right, ["key"], ["key"], how, "hash", "kernel",
              capacity=200)

    def test_sort_engine_not_ported(self):
        """Once item 10's gap, the sort engine now matches the
        reference's (the ``join_engine`` knob picks it)."""
        tconfig.set("join_engine", "sort")
        rng = np.random.default_rng(6)
        right = _side(rng, 40, rng.integers(0, 30, 40).astype(np.int64))
        left = _side(rng, 60, rng.integers(-5, 35, 60).astype(np.int64))
        _both(left, right, ["key"], ["key"], "inner", "sort", None,
              capacity=200)


def _str_side(rng, n, codes, width, valid=0.9):
    vals = [None if not ok else f"s{c:03d}" + "z" * (c % 5)
            for c, ok in zip(codes, rng.random(n) < valid)]
    return JBatch({
        "s": JString.from_pylist(vals, max_len=width),
        "i": JColumn(jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
                     jnp.asarray(rng.random(n) > 0.05), JT.INT32),
        "x": JColumn(jnp.asarray(rng.integers(-99, 99, n)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INT64)})


class TestJoinKinds:
    @pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                     "semi", "anti"])
    @pytest.mark.parametrize("jeng,teng", ENGINES)
    def test_every_kind_with_nulls_duplicates_and_dead_rows(self, how, jeng,
                                                            teng):
        rng = np.random.default_rng(20)
        right = _side(rng, 120, rng.integers(0, 60, 120).astype(np.int64))
        left = _side(rng, 200, rng.integers(-10, 70, 200).astype(np.int64))
        lv = rng.random(200) > 0.15
        rv = rng.random(120) > 0.15
        _both(left, right, ["key"], ["key"], how, jeng, teng, lv, rv,
              capacity=600)

    @pytest.mark.parametrize("how", ["inner", "left", "full", "anti"])
    @pytest.mark.parametrize("jeng,teng", ENGINES)
    def test_multi_key_strings_of_mismatched_widths(self, how, jeng, teng):
        rng = np.random.default_rng(21)
        right = _str_side(rng, 90, rng.integers(0, 40, 90), 12)
        left = _str_side(rng, 150, rng.integers(0, 50, 150), 9)
        tr, _ = _both(left, right, ["s", "i"], ["s", "i"], how, jeng, teng,
                      capacity=400)
        if how in ("inner", "left"):
            assert {"x", "x_r"} <= set(tr.names)

    @pytest.mark.parametrize("jeng,teng", ENGINES)
    def test_suffixes_and_truncated_full_join(self, jeng, teng):
        rng = np.random.default_rng(22)
        right = _side(rng, 80, rng.integers(0, 10, 80).astype(np.int64))
        left = _side(rng, 100, rng.integers(0, 12, 100).astype(np.int64))
        tr, tc = _both(left, right, ["key"], ["key"], "full", jeng, teng,
                       capacity=50, suffixes=("_l", "_r"))
        assert int(tc) == 50 + 80 + 1  # the left-join region overflowed
        assert "key_l" in tr.names and "key_r" in tr.names

    @pytest.mark.parametrize("how", ["left", "full", "anti", "semi"])
    @pytest.mark.parametrize("nl,nr", [(0, 10), (10, 0)])
    def test_empty_sides_every_kind(self, how, nl, nr):
        rng = np.random.default_rng(23)
        left = _side(rng, nl, np.arange(nl, dtype=np.int64))
        right = _side(rng, nr, np.arange(nr, dtype=np.int64))
        for jeng, teng in ENGINES:
            _both(left, right, ["key"], ["key"], how, jeng, teng)

    def test_prebuilt_tables_on_both_engines(self):
        rng = np.random.default_rng(24)
        jright = _side(rng, 50, rng.integers(0, 30, 50).astype(np.int64))
        jright = JBatch(dict(zip(jright.names, jright.columns),
                             k2=JColumn(jnp.asarray(rng.integers(0, 4, 50)),
                                        jnp.ones((50,), jnp.bool_),
                                        JT.INT64)))
        jleft = _side(rng, 90, rng.integers(0, 35, 90).astype(np.int64))
        jleft = JBatch(dict(zip(jleft.names, jleft.columns),
                            k2=JColumn(jnp.asarray(rng.integers(0, 4, 90)),
                                       jnp.ones((90,), jnp.bool_),
                                       JT.INT64)))
        right = to_port(jright)
        for jeng, teng in ENGINES:
            bt = TJ.spillable_build_table(right, ["key", "k2"], engine=teng)
            assert bt.engine == teng
            jr, jc = jax.jit(lambda a, b: JJ.hash_join(
                a, b, ["key", "k2"], ["key", "k2"], "full", capacity=300,
                engine=jeng))(jleft, jright)
            tr, tc = TJ.hash_join(to_port(jleft), right, ["key", "k2"],
                                  ["key", "k2"], "full", capacity=300,
                                  prebuilt=bt)
            assert_join_match(jr, jc, tr, tc)
        with pytest.raises(ValueError, match="how='right'"):
            TJ.hash_join(to_port(jleft), right, ["key"], ["key"], "right",
                         prebuilt=bt)
        srt = to_port(_str_side(rng, 10, np.arange(10), 8))
        with pytest.raises(ValueError, match="string join keys"):
            TJ.spillable_build_table(srt, ["s"])

    def test_key_type_mismatch(self):
        rng = np.random.default_rng(25)
        s = to_port(_str_side(rng, 10, np.arange(10), 8))
        with pytest.raises(TypeError, match="key type mismatch"):
            TJ.hash_join(s, s, ["s"], ["i"])


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


def _dec_side(rng, n, keys, p_key):
    """A decimal(p_key,2) key (10 % null) and decimal(38,4) / decimal(9,2)
    payloads; ``keys`` are unscaled values drawn from a small pool."""
    kn = rng.random(n) < 0.1
    return JBatch({
        "dk": jdecimal([None if z else int(k) for k, z in zip(keys, kn)],
                       p_key, 2),
        "i": JColumn(jnp.asarray(rng.integers(0, 2, n).astype(np.int32)),
                     jnp.ones((n,), jnp.bool_), JT.INT32),
        "dv": jdecimal(unscaled(rng, n, 38, nulls=0.1), 38, 4),
        "dp": jdecimal(unscaled(rng, n, 9, nulls=0.1), 9, 2)})


class TestDecimalJoins:
    @pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                     "semi", "anti"])
    @pytest.mark.parametrize("jeng,teng", ENGINES)
    @pytest.mark.parametrize("p_key", [7, 38])
    def test_every_kind_on_decimal_keys_and_payloads(self, how, jeng, teng,
                                                     p_key):
        """Decimal keys (2 words under 128 bits of storage, 4 at 128),
        a decimal-int composite, decimal payloads through expansion, the
        outer joins' null fill and the full join's append."""
        rng = np.random.default_rng(60 + p_key)
        pool = np.array([-(10 ** (p_key - 1)), -5, 0, 7, 10 ** (p_key - 1),
                         123, 10 ** p_key - 1, -(10 ** p_key - 1)])
        right = _dec_side(rng, 70, pool[rng.integers(0, 6, 70)], p_key)
        left = _dec_side(rng, 110, pool[rng.integers(0, 8, 110)], p_key)
        lv = rng.random(110) > 0.1
        rv = rng.random(70) > 0.1
        _both(left, right, ["dk", "i"], ["dk", "i"], how, jeng, teng, lv,
              rv, capacity=900)

    def test_dense_join_keeps_int_keys_only(self):
        """A decimal key never takes the rowid table: the general hash
        join's result, equal to the reference's."""
        rng = np.random.default_rng(67)
        right = _dec_side(rng, 30, np.arange(30) * 100, 9)
        left = _dec_side(rng, 80, rng.integers(0, 35, 80) * 100, 9)
        jr, jc = jax.jit(lambda a, b: JJ.join_dense_or_hash(
            a, b, "dk", "dk", 30))(left, right)
        tr, tc = TJ.join_dense_or_hash(to_port(left), to_port(right), "dk",
                                       "dk", 30)
        assert_join_match(jr, jc, tr, tc)
