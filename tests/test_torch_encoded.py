"""PyTorch port: dictionary and run-length columns against the JAX
package's ``columnar/encoded.py`` and its encoded operator branches.

Counterpart of ``tests/test_encoded.py`` (``TestRoundTrip``,
``TestPredicateMask``, ``TestJoinParity``, ``TestGroupByParity``,
``TestShuffleEncoded``).  The same seeded host data goes through both
packages: encodings are held bit for bit (codes, canon, dictionaries,
runs), joins and group-bys on encoded inputs equal the reference's on
the same encoded inputs (exact on keys, ints and counts, float sums rel
1e-5), and the exchange of dictionary columns delivers the reference's
arrays and accounting shard for shard.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import Decimal128Column as JDec
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.columnar import encoded as JE
from spark_rapids_jni_tpu.relational import AggSpec as JAggSpec
from spark_rapids_jni_tpu.relational import group_by as jgroup_by
from spark_rapids_jni_tpu.relational import hash_join as jhash_join

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar import encoded as E
from spark_rapids_jni_tpu_torch.columnar.column import (Column, ColumnBatch,
                                                        batch_to_numpy)
from spark_rapids_jni_tpu_torch.relational import AggSpec, group_by, \
    hash_join
from spark_rapids_jni_tpu_torch.relational.filter import (apply_mask,
                                                          predicate_mask)

from torch_parity import assert_encoded_equal, port_col, to_port, u32
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

FLOAT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    yield
    jconfig.reset()
    tconfig.reset()


def jcol(vals, kind, valid=None):
    vals = np.asarray(vals)
    v = np.ones(len(vals), bool) if valid is None else np.asarray(valid)
    return JColumn(jnp.asarray(vals), jnp.asarray(v), kind)


def pylist(col) -> list:
    """Row values of a port column (encoded ones decoded)."""
    col = E.materialize_column(col)
    return E._plain_pylist(col)


def jpylist(col) -> list:
    return JE.materialize_column(col).to_pylist()


def same_value(x, y, approx: bool) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, float) and np.isnan(x):
        return isinstance(y, float) and np.isnan(y)
    if approx:
        return abs(x - y) <= FLOAT_RTOL * max(abs(x), abs(y), 1e-300)
    return x == y


def assert_results_equal(name, jres, jn, tres, tn, approx=()):
    """The live prefixes of a reference and a port result hold the same
    values, column by column (encoded columns decoded)."""
    jn, tn = int(jn), int(tn)
    assert jn == tn, f"{name}: count {jn} != {tn}"
    assert list(jres.names) == list(tres.names), name
    for c in jres.names:
        lj, lt = jpylist(jres[c])[:jn], pylist(tres[c])[:tn]
        for i, (x, y) in enumerate(zip(lj, lt)):
            assert same_value(x, y, c in approx), f"{name}/{c}[{i}]: {x!r} " \
                f"!= {y!r}"


# ---------------------------------------------------------------------------
# encode / decode round trips
# ---------------------------------------------------------------------------

class TestRoundTrip:
    def test_int_with_nulls(self):
        rng = np.random.default_rng(1)
        jc = jcol(rng.integers(0, 20, 200).astype(np.int32), JT.INT32,
                  rng.random(200) > 0.15)
        je, te = JE.encode_column(jc), E.encode_column(port_col(jc))
        assert E.is_encoded(te) and te.num_rows == 200
        assert_encoded_equal(je, te, "int")
        assert te.to_pylist() == je.to_pylist() == jc.to_pylist()

    def test_float_bit_distinct_entries(self):
        vals = np.array([1.5, -0.0, 0.0, np.nan, -0.0, 1.5, np.nan])
        jc = jcol(vals, JT.FLOAT64)
        je, te = JE.encode_column(jc), E.encode_column(port_col(jc))
        assert te.num_entries == je.num_entries == 4
        assert_encoded_equal(je, te, "float")
        dec = te.decode().data.numpy()
        assert dec.view(np.uint8).tobytes() == vals.view(np.uint8).tobytes()
        canon, codes = te.canon.numpy(), te.codes.numpy()
        assert canon[codes[1]] == canon[codes[2]]  # -0.0 == 0.0

    def test_nan_payloads_stay_distinct(self):
        bits = np.array([0x7FF8000000000000, 0x7FF8000000000001,
                         0xFFF8000000000000, 0x0, 0x8000000000000000],
                        np.uint64)
        vals = bits.view(np.float64)
        jc = jcol(vals, JT.FLOAT64)
        je, te = JE.encode_column(jc), E.encode_column(port_col(jc))
        assert te.num_entries == 5
        assert_encoded_equal(je, te, "nan payloads")
        assert te.decode().data.numpy().view(np.uint64).tolist() == \
            bits.tolist()

    def test_string_with_nulls(self):
        vals = ["ab", None, "abcdef", "ab", "", None, "zz"]
        jc = JString.from_pylist(vals, max_len=128)
        je, te = JE.encode_column(jc), E.encode_column(port_col(jc))
        assert te.num_entries == 4
        assert_encoded_equal(je, te, "string")
        assert te.to_pylist() == vals
        assert te.decode().to_pylist() == vals
        # plan_widths' ladder, not the column's 128-byte width
        assert te.dictionary.max_len == je.dictionary.max_len < 128

    def test_decimal(self):
        vals = [10 ** 20, -(10 ** 19), None, 10 ** 20, 0]
        jc = JDec.from_unscaled(vals, 38, 2)
        je, te = JE.encode_column(jc), E.encode_column(port_col(jc))
        assert te.num_entries == 3
        assert_encoded_equal(je, te, "decimal")
        assert te.to_pylist() == vals

    def test_empty(self):
        te = E.encode_column(port_col(jcol(np.zeros(0, np.int32),
                                           JT.INT32)))
        assert te.num_rows == 0 and pylist(te.decode()) == []

    def test_rle_round_trip(self):
        vals = np.repeat([3, 7, 7, 1, 9], [10, 5, 4, 20, 1]).astype(np.int64)
        v = np.ones(40, bool)
        v[::7] = False
        jc = jcol(vals, JT.INT64, v)
        jr, tr = JE.encode_rle(jc), E.encode_rle(port_col(jc))
        assert tr.num_runs == jr.num_runs == 4
        assert_encoded_equal(jr, tr, "rle")
        assert pylist(tr) == jc.to_pylist()
        np.testing.assert_array_equal(tr.row_to_run().numpy(),
                                      np.asarray(jr.row_to_run()))

    def test_rle_rejects_strings(self):
        with pytest.raises(TypeError):
            E.encode_rle(port_col(JString.from_pylist(["a", "b"],
                                                      max_len=4)))

    def test_encode_batch_auto_and_explicit(self):
        rng = np.random.default_rng(2)
        n = 256
        jb = JBatch({
            "s": JString.from_pylist([f"c{i % 5}" for i in range(n)],
                                     max_len=8),
            "low": jcol(rng.integers(0, 4, n).astype(np.int32), JT.INT32),
            "high": jcol(np.arange(n, dtype=np.int32), JT.INT32)})
        tb = to_port(jb)
        for kw in ({}, {"dictionary": ["s"], "rle": ["low"]}):
            ja, ta = JE.encode_batch(jb, **kw), E.encode_batch(tb, **kw)
            for c in jb.names:
                assert type(ta[c]).__name__ == type(ja[c]).__name__, (kw, c)
                if JE.is_encoded(ja[c]):
                    assert_encoded_equal(ja[c], ta[c], f"{kw} {c}")
            dec = E.materialize_batch(ta)
            for c in jb.names:
                assert pylist(dec[c]) == pylist(tb[c]), (kw, c)

    def test_carried_batch_round_trips(self):
        """A reference batch of every encoded kind carries into the port
        bit for bit, and back out through ``batch_to_numpy``; columns of
        one dictionary keep one token."""
        rng = np.random.default_rng(5)
        n = 300
        k = JE.encode_column(JString.from_pylist(
            [f"w{i}" for i in rng.integers(0, 9, n)], max_len=8))
        jb = JBatch({
            "k": k, "k2": dataclasses.replace(
                k, codes=jnp.asarray(rng.integers(0, k.num_entries, n)
                                     .astype(np.uint32))),
            "r": JE.encode_rle(jcol(np.sort(rng.integers(0, 5, n)),
                                    JT.INT64)),
            "p": JE.encode_bitpacked(jcol(rng.integers(-9, 2000, n),
                                          JT.INT64), column="p"),
            "f": JE.encode_for(jcol(np.cumsum(rng.integers(0, 9, n)),
                                    JT.INT64), block=64, column="f")})
        tb = to_port(jb)
        for c in jb.names:
            assert_encoded_equal(jb[c], tb[c], c)
        assert tb["k"].dict_token == tb["k2"].dict_token > 0
        for c in ("p", "f"):
            tb[c].zone.verify()
            assert tb[c].zone.crc == jb[c].zone.crc
        back = batch_to_numpy(tb)
        np.testing.assert_array_equal(back["k"][0]["codes"],
                                      np.asarray(k.codes))
        np.testing.assert_array_equal(back["p"][0]["lanes"],
                                      np.asarray(jb["p"].lanes))

    def test_knob_validation(self):
        tconfig.set("encoded_execution", "on")
        assert E.resolve_encoded_execution("cpu") is True
        tconfig.set("encoded_execution", "off")
        assert E.resolve_encoded_execution("cpu") is False
        tconfig.set("encoded_execution", "auto")
        assert E.resolve_encoded_execution("cpu") is True
        assert E.resolve_encoded_execution() is E.AUTO_ON_CUDA
        tconfig.set("encoded_execution", "bogus")
        with pytest.raises(ValueError, match="encoded_execution"):
            E.resolve_encoded_execution("cpu")


# ---------------------------------------------------------------------------
# code-set filter
# ---------------------------------------------------------------------------

class TestPredicateMask:
    def test_matches_rowwise_mask(self):
        rng = np.random.default_rng(3)
        n = 300
        jc = jcol(rng.integers(0, 30, n).astype(np.int32), JT.INT32,
                  rng.random(n) > 0.1)
        je = JE.encode_column(jc)
        te = port_col(je)
        got = predicate_mask(te, lambda d: d.data < 15).numpy()
        want = np.asarray(JE.predicate_mask(je, lambda d: d.data < 15))
        np.testing.assert_array_equal(got, want)

    def test_filter_keeps_columns_encoded(self):
        vals = [f"g{i % 4}" for i in range(64)]
        jb = JE.encode_batch(JBatch({
            "k": JString.from_pylist(vals, max_len=8),
            "v": jcol(np.arange(64, dtype=np.int32), JT.INT32)}),
            dictionary=["k"])
        tb = to_port(jb)
        out = apply_mask(tb, predicate_mask(tb["k"], lambda d: d.lengths > 0))
        assert isinstance(out["k"], E.DictionaryColumn)
        assert out["k"].to_pylist() == vals


# ---------------------------------------------------------------------------
# joins on encoded keys
# ---------------------------------------------------------------------------

HOWS = ("inner", "left", "right", "full", "semi", "anti")


def _join_sides(nl=120, nr=40, seed=11):
    rng = np.random.default_rng(seed)
    cats = [f"cat-{i:03d}" for i in range(24)]
    lk = [cats[i] for i in rng.integers(0, 24, nl)]
    rk = [cats[i] if i < 24 else f"miss-{i}" for i in rng.integers(0, 32, nr)]
    left = JBatch({
        "k": JString.from_pylist(lk, max_len=12),
        "lpay": jcol(rng.integers(0, 1000, nl).astype(np.int32), JT.INT32,
                     rng.random(nl) > 0.1)})
    right = JBatch({
        "k": JString.from_pylist(rk, max_len=12),
        "rpay": jcol(rng.integers(0, 1000, nr).astype(np.int32), JT.INT32)})
    return left, right


def _both_joins(left, right, how, engine=None, **kw):
    jr, jn = jhash_join(left, right, ["k"], ["k"], how, capacity=6000, **kw)
    tr, tn = hash_join(to_port(left), to_port(right), ["k"], ["k"], how,
                       capacity=6000, engine=engine)
    return jr, jn, tr, tn


class TestJoinParity:
    @pytest.mark.parametrize("how", HOWS)
    def test_cross_dictionary_fallback(self, how):
        """Independently encoded sides (different tokens) lower to value
        words and equal the reference's encoded join and the decoded one."""
        left, right = _join_sides()
        el = JE.encode_batch(left, dictionary=["k"])
        er = JE.encode_batch(right, dictionary=["k"])
        tl, tr_ = to_port(el), to_port(er)
        assert tl["k"].dict_token != tr_["k"].dict_token
        jr, jn, tr, tn = _both_joins(el, er, how)
        assert_results_equal(f"cross/{how}", jr, jn, tr, tn)
        pr, pn = hash_join(to_port(left), to_port(right), ["k"], ["k"], how,
                           capacity=6000)
        assert_results_equal(f"cross-vs-plain/{how}", jr, jn, pr, pn)

    @pytest.mark.parametrize("how", HOWS)
    def test_reconciled_canon_fast_path(self, how):
        left, right = _join_sides(seed=13)
        el = JE.encode_batch(left, dictionary=["k"])
        er = JE.encode_batch(right, dictionary=["k"])
        jlk, jrk = JE.reconcile_dictionaries(el["k"], er["k"])
        tlk, trk = E.reconcile_dictionaries(port_col(el["k"]),
                                            port_col(er["k"]))
        assert tlk.dict_token == trk.dict_token
        assert_encoded_equal(jlk, tlk, "reconciled left")
        assert_encoded_equal(jrk, trk, "reconciled right")
        lout, rout = E.align_encoded_key_columns([tlk], [trk])
        assert isinstance(lout[0], Column) and isinstance(rout[0], Column)
        jl = JBatch({"k": jlk, "lpay": el["lpay"]})
        jr_ = JBatch({"k": jrk, "rpay": er["rpay"]})
        jres, jn = jhash_join(jl, jr_, ["k"], ["k"], how, capacity=6000)
        tl = ColumnBatch({"k": tlk, "lpay": port_col(el["lpay"])})
        tr_ = ColumnBatch({"k": trk, "rpay": port_col(er["rpay"])})
        tres, tn = hash_join(tl, tr_, ["k"], ["k"], how, capacity=6000)
        assert_results_equal(f"canon/{how}", jres, jn, tres, tn)

    @pytest.mark.parametrize("how", ("inner", "left", "full"))
    def test_mixed_encoded_and_plain(self, how):
        left, right = _join_sides(seed=17)
        el = JE.encode_batch(left, dictionary=["k"])
        jr, jn, tr, tn = _both_joins(el, right, how)
        assert_results_equal(f"mixed/{how}", jr, jn, tr, tn)

    def test_align_passthrough_on_token_mismatch(self):
        a = E.encode_column(port_col(jcol(np.array([1, 2, 3], np.int32),
                                          JT.INT32)))
        b = E.encode_column(port_col(jcol(np.array([2, 3, 4], np.int32),
                                          JT.INT32)))
        lout, rout = E.align_encoded_key_columns([a], [b])
        assert lout[0] is a and rout[0] is b

    def test_engine_parity_on_encoded_keys(self):
        left, right = _join_sides(seed=19)
        el = JE.encode_batch(left, dictionary=["k"])
        er = JE.encode_batch(right, dictionary=["k"])
        for how in ("inner", "full", "anti"):
            jr, jn = jhash_join(el, er, ["k"], ["k"], how, capacity=6000)
            for engine in ("sort", "kernel"):
                tr, tn = hash_join(to_port(el), to_port(er), ["k"], ["k"],
                                   how, capacity=6000, engine=engine)
                assert_results_equal(f"engines/{how}/{engine}", jr, jn, tr,
                                     tn)

    def test_empty_build_side_keeps_the_dictionary(self):
        left, right = _join_sides(seed=23)
        el = to_port(JE.encode_batch(left, dictionary=["k"]))
        er = to_port(JE.encode_batch(right, dictionary=["k"]))
        empty = ColumnBatch({n: E.gather_bitpacked(c, torch.zeros(0,
                                                                  dtype=torch.int64))
                             if isinstance(c, E.BitPackedColumn) else
                             dataclasses.replace(
                                 c, codes=c.codes[:0], validity=c.validity[:0])
                             if isinstance(c, E.DictionaryColumn) else
                             Column(c.data[:0], c.validity[:0], c.dtype)
                             for n, c in zip(er.names, er.columns)})
        res, cnt = hash_join(el, empty, ["k"], ["k"], "left")
        assert int(cnt) == el.num_rows
        assert pylist(res["k"]) == pylist(el["k"])
        assert all(v is None for v in pylist(res["rpay"]))


# ---------------------------------------------------------------------------
# group-by on encoded keys and values
# ---------------------------------------------------------------------------

def _aggs(spec):
    return [spec(*a) for a in (
        ("count", None, "cstar"), ("sum", "v", "s"), ("count", "v", "c"),
        ("min", "v", "mn"), ("max", "v", "mx"), ("mean", "v", "avg"),
        ("sum", "f", "fs"), ("mean", "f", "favg"))]


FLOAT_APPROX = ("fs", "favg", "avg")


def _gb_batch(n=400, seed=23):
    rng = np.random.default_rng(seed)
    k = [f"grp-{i:02d}" for i in rng.integers(0, 25, n)]
    return JBatch({
        "k": JString.from_pylist(
            [None if rng.random() < 0.1 else s for s in k], max_len=8),
        "v": jcol(rng.integers(-1000, 1000, n).astype(np.int32), JT.INT32,
                  rng.random(n) > 0.15),
        "f": jcol(rng.choice([1.5, -0.0, 0.0, np.nan, 2.5], n), JT.FLOAT64)})


class TestGroupByParity:
    @pytest.mark.parametrize("engine", ("sort", "kernel"))
    def test_encoded_string_key_all_aggs(self, engine):
        enc = JE.encode_batch(_gb_batch(), dictionary=["k"])
        jr, jn = jgroup_by(enc, ["k"], _aggs(JAggSpec))
        tr, tn = group_by(to_port(enc), ["k"], _aggs(AggSpec), engine=engine)
        assert isinstance(tr["k"], E.DictionaryColumn)  # keys stay codes
        assert_results_equal(f"gb/{engine}", jr, jn, tr, tn,
                             approx=FLOAT_APPROX)

    def test_row_valid(self):
        rng = np.random.default_rng(29)
        enc = JE.encode_batch(_gb_batch(seed=29), dictionary=["k"])
        rv = rng.random(400) > 0.3
        jr, jn = jgroup_by(enc, ["k"], _aggs(JAggSpec),
                           row_valid=jnp.asarray(rv))
        tr, tn = group_by(to_port(enc), ["k"], _aggs(AggSpec),
                          row_valid=torch.from_numpy(rv))
        assert_results_equal("gb/row_valid", jr, jn, tr, tn,
                             approx=FLOAT_APPROX)

    def test_rle_key(self):
        rng = np.random.default_rng(31)
        k = np.sort(rng.integers(0, 12, 300)).astype(np.int32)
        jb = JBatch({"k": JE.encode_rle(jcol(k, JT.INT32)),
                     "v": jcol(rng.integers(0, 100, 300).astype(np.int32),
                               JT.INT32)})
        jr, jn = jgroup_by(jb, ["k"], [JAggSpec("count", None, "c"),
                                       JAggSpec("sum", "v", "s")])
        tr, tn = group_by(to_port(jb), ["k"], [AggSpec("count", None, "c"),
                                               AggSpec("sum", "v", "s")])
        assert_results_equal("gb/rle", jr, jn, tr, tn)

    def test_encoded_value_column_materializes(self):
        rng = np.random.default_rng(37)
        n = 300
        jb = JBatch({"k": jcol(rng.integers(0, 10, n).astype(np.int32),
                               JT.INT32),
                     "v": JE.encode_column(jcol(
                         rng.integers(0, 5, n).astype(np.int32), JT.INT32))})
        specs = (("sum", "v", "s"), ("min", "v", "mn"), ("max", "v", "mx"))
        jr, jn = jgroup_by(jb, ["k"], [JAggSpec(*a) for a in specs])
        tr, tn = group_by(to_port(jb), ["k"], [AggSpec(*a) for a in specs])
        assert_results_equal("gb/encval", jr, jn, tr, tn)

    def test_shared_dictionary_keys_on_one_canon_word(self):
        """Batches over ONE dictionary carry one token, and the group-by
        keys on the canon word: a null flag and one data word (the
        reference's jit traces once across such batches)."""
        from spark_rapids_jni_tpu_torch.relational import aggregate as AGG
        from spark_rapids_jni_tpu_torch.relational import keys as K

        cats = JString.from_pylist([f"g{i}" for i in range(8)], max_len=4)
        tcats = port_col(cats)
        ones = torch.ones((64,), dtype=torch.bool)
        base = E.dictionary_from_arrays(
            np.random.default_rng(41).integers(0, 8, 64), ones, tcats)
        jbase = JE.dictionary_from_arrays(
            np.random.default_rng(41).integers(0, 8, 64).astype(np.uint32),
            jnp.ones((64,), jnp.bool_), cats)
        assert_encoded_equal(jbase, base, "dictionary_from_arrays")
        for seed in (1, 2, 3):
            codes = np.random.default_rng(seed).integers(0, 8, 64)
            k = dataclasses.replace(
                base, codes=torch.from_numpy(codes.astype(np.int32)))
            assert k.dict_token == base.dict_token
            words = K.batch_radix_keys(AGG._canon_keys([k]), equality=True)
            assert len(words) == 2
            tr, tn = group_by(ColumnBatch({"k": k}),
                              ["k"], [AggSpec("count", None, "c")])
            jk = dataclasses.replace(
                jbase, codes=jnp.asarray(codes.astype(np.uint32)))
            jr, jn = jgroup_by(JBatch({"k": jk}), ["k"],
                               [JAggSpec("count", None, "c")])
            assert_results_equal(f"gb/shared/{seed}", jr, jn, tr, tn)

    def test_domain_engine_materializes(self):
        from spark_rapids_jni_tpu.relational import group_by_domain_or_sort \
            as jdomain
        from spark_rapids_jni_tpu_torch.relational import \
            group_by_domain_or_sort

        rng = np.random.default_rng(43)
        n = 512
        k = jcol(rng.integers(0, 6, n).astype(np.int32), JT.INT32)
        jb = JBatch({"k": k, "v": JE.encode_bitpacked(
            jcol(rng.integers(0, 99, n), JT.INT64))})
        specs = (("sum", "v", "s"), ("count", None, "c"))
        jr, jn = jdomain(jb, "k", [JAggSpec(*a) for a in specs], 6)
        tb = to_port(jb)
        tr, tn = group_by_domain_or_sort(tb, "k",
                                         [AggSpec(*a) for a in specs], 6)
        assert_results_equal("gb/domain", jr, jn, tr, tn)
        # a dictionary key materializes there too (the reference's
        # lax.cond cannot return an encoded key from one branch only)
        te = tb.with_column("k", E.encode_column(tb["k"]))
        er, en = group_by_domain_or_sort(te, "k",
                                         [AggSpec(*a) for a in specs], 6)
        assert_results_equal("gb/domain/dict", jr, jn, er, en)


# ---------------------------------------------------------------------------
# the exchange: codes move, dictionaries cross once
# ---------------------------------------------------------------------------

P8 = 8


def _shuffle_batches(n):
    rng = np.random.default_rng(43)
    vals = [f"warehouse-{i:02d}-{'x' * 12}" for i in rng.integers(0, 16, n)]
    plain = JBatch({
        "k": JString.from_pylist(vals, max_len=28),
        "v": jcol(rng.integers(0, 1000, n), JT.INT64)})
    return plain, JE.encode_batch(plain, dictionary=["k"])


class TestShuffleEncoded:
    def _services(self):
        from spark_rapids_jni_tpu.parallel import data_mesh
        from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JReg
        from spark_rapids_jni_tpu.shuffle import ShuffleService as JSvc

        from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
        from spark_rapids_jni_tpu_torch.shuffle import (ShuffleRegistry,
                                                        ShuffleService)

        jm = data_mesh(P8)
        return (jm, JSvc(jm, registry=JReg()),
                ShuffleService(ShardMesh(P8, device="cpu"),
                               registry=ShuffleRegistry()))

    def _same(self, jres, tres):
        np.testing.assert_array_equal(tres.occupancy.numpy(),
                                      np.asarray(jres.occupancy))
        for name in jres.batch.names:
            jc, tc = jres.batch[name], tres.batch[name]
            if isinstance(jc, JE.DictionaryColumn):
                assert_encoded_equal(jc, tc, name)
            else:
                np.testing.assert_array_equal(tc.data.numpy(),
                                              np.asarray(jc.data), name)
                np.testing.assert_array_equal(tc.validity.numpy(),
                                              np.asarray(jc.validity), name)
        for f in ("rounds", "capacity", "rows_moved", "bytes_moved",
                  "compressed_bytes_saved"):
            assert getattr(tres, f) == getattr(jres, f), f

    def test_codes_move_fewer_bytes_lossless(self, eight_devices):
        import jax
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, tsvc = self._services()
        n = P8 * 64
        plain, enc = self._shuffle_batches(n)
        pid = np.arange(n, dtype=np.int32) % P8
        jpid = jax.device_put(jnp.asarray(pid), jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec("data")))
        jp = jsvc.exchange(shard_batch(plain, jm), pid=jpid)
        je = jsvc.exchange(shard_batch(enc, jm), pid=jpid)
        tp = tsvc.exchange(to_port(plain), pid=torch.from_numpy(pid))
        te = tsvc.exchange(to_port(enc), pid=torch.from_numpy(pid))
        assert te.rows_moved == tp.rows_moved == n
        assert te.bytes_moved < tp.bytes_moved
        assert isinstance(te.batch["k"], E.DictionaryColumn)
        self._same(je, te)
        assert tp.bytes_moved == jp.bytes_moved

    def test_keyed_routing_matches_decoded(self, eight_devices):
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, tsvc = self._services()
        n = P8 * 32
        plain, enc = self._shuffle_batches(n)
        je = jsvc.exchange(shard_batch(enc, jm), key_names=["k"])
        te = tsvc.exchange(to_port(enc), key_names=["k"])
        tp = tsvc.exchange(to_port(plain), key_names=["k"])
        self._same(je, te)
        occ_e, occ_p = te.occupancy.numpy(), tp.occupancy.numpy()
        ke, kp = pylist(te.batch["k"]), pylist(tp.batch["k"])
        rows = len(occ_e) // P8
        for d in range(P8):
            sl = slice(d * rows, (d + 1) * rows)
            assert sorted(k for k, ok in zip(ke[sl], occ_e[sl]) if ok) == \
                sorted(k for k, ok in zip(kp[sl], occ_p[sl]) if ok)

    _shuffle_batches = staticmethod(_shuffle_batches)

    def test_shard_batch_replicates_dictionaries(self, eight_devices):
        from spark_rapids_jni_tpu_torch.parallel.mesh import (ShardMesh,
                                                              shard_batch)

        _plain, enc = self._shuffle_batches(P8 * 4)
        tb = to_port(JE.encode_batch(enc, rle=["v"]))
        out = shard_batch(tb, ShardMesh(P8, device="cpu"))
        assert isinstance(out["k"], E.DictionaryColumn)
        assert out["k"].dictionary is not None
        assert isinstance(out["v"], Column)  # runs decode
        assert pylist(out["v"]) == pylist(tb["v"])


def test_hash_partition_of_a_dictionary_key_is_by_value():
    """``spark_partition_id`` over a dictionary key equals the
    reference's over the same column (the exchange routes by values)."""
    from spark_rapids_jni_tpu.parallel.partition import \
        spark_partition_id as jspid
    from spark_rapids_jni_tpu_torch.parallel.partition import \
        spark_partition_id

    _plain, enc = _shuffle_batches(200)
    got = spark_partition_id([port_col(enc["k"])], 8).numpy()
    want = np.asarray(jspid([enc["k"]], 8))
    np.testing.assert_array_equal(got, want)
    assert u32(port_col(enc["k"]).codes).dtype == np.uint32


# ---------------------------------------------------------------------------
# the encoded flagship shapes in both packages
# ---------------------------------------------------------------------------

class TestEncodedFlagships:
    def test_q6str_encoded_variants_share_one_dictionary(self):
        import __graft_entry__ as ge

        from spark_rapids_jni_tpu_torch import pipelines as TP

        n = 4096
        jvars = ge._q6str_encoded_variants(n, (7, 8))
        tvars = TP.q6str_encoded_variants(n, (7, 8), device="cpu")
        assert tvars[0][0]["k"].dict_token == tvars[1][0]["k"].dict_token
        for (jb,), (tb,) in zip(jvars, tvars):
            assert_encoded_equal(jb["k"], tb["k"], "k")
            for c in ("v", "price"):
                np.testing.assert_array_equal(tb[c].data.numpy(),
                                              np.asarray(jb[c].data))
            jr, jn = jax.jit(ge._q6str_step)(jb)
            tr, tn = TP.q6str_step(tb)
            assert isinstance(tr["k"], E.DictionaryColumn)
            assert_results_equal("q6str_enc", jr, jn, tr, tn,
                                 approx=("avg_price",))
        # seed 7's codes are q6str's keys: the same groups as the plain
        # string step
        kidx, _chars, v, price = TP.q6str_arrays(n, 7)
        keys, sums, cnts, _avgs = TP.q6str_oracle(kidx, v, price)
        got = TP.result_groups(*TP.q6str_step(tvars[0][0]), "k")
        assert list(got) == keys
        assert [got[k]["sum_v"] for k in keys] == [int(s) for s in sums]
        assert [got[k]["cnt"] for k in keys] == [int(c) for c in cnts]

    def test_q95_encoded_step_matches_the_reference_and_the_oracle(self):
        import __graft_entry__ as ge

        from spark_rapids_jni_tpu_torch import pipelines as TP

        n = 4096
        jf, jd1, jd2 = ge._q95_encoded_batches(n)
        tf, td1, td2 = TP.q95_encoded_batches(n, device="cpu")
        for c in ("wh", "seg"):
            assert_encoded_equal(jf[c], tf[c], c)
        jr, jn = jax.jit(ge._q95_encoded_step)(jf, jd1, jd2)
        tr, tn = TP.q95_encoded_step(tf, td1, td2)
        assert isinstance(tr["seg"], E.DictionaryColumn)
        assert_results_equal("q95_enc", jr, jn, tr, tn)
        orders, net = TP.q95_oracle(TP.q95_arrays(n))
        got = TP.result_groups(tr, tn, "seg")
        assert [got[s]["orders"] for s in range(TP.Q95_SEG)] == \
            orders.tolist()
        assert [got[s]["net"] for s in range(TP.Q95_SEG)] == \
            [int(x) for x in net]

    def test_q95_encoded_variants_and_the_plan(self):
        import __graft_entry__ as ge

        from spark_rapids_jni_tpu_torch import pipelines as TP
        from spark_rapids_jni_tpu_torch import plan
        from spark_rapids_jni_tpu_torch.plan import queries as Q

        n = 2048
        jv = ge._q95_encoded_variants(n, (19, 20))
        tv = TP.q95_encoded_variants(n, (19, 20), device="cpu")
        assert tv[0][0]["wh"].dict_token == tv[1][0]["wh"].dict_token
        jstep = jax.jit(ge._q95_encoded_step)  # as bench.py runs it
        for (jf, jd1, jd2), (tf, td1, td2) in zip(jv, tv):
            for c in ("wh", "seg"):
                assert_encoded_equal(jf[c], tf[c], c)
            jr, jn = jstep(jf, jd1, jd2)
            tr, tn = TP.q95_encoded_step(tf, td1, td2)
            assert_results_equal("q95_enc_variant", jr, jn, tr, tn)
            pr, pn = plan.execute(Q.q95_plan(),
                                  {"fact": tf, "dim1": td1, "dim2": td2})
            assert TP.result_groups(pr, pn, "seg") == \
                TP.result_groups(tr, tn, "seg")


def test_gpu_path_modules_import_without_pyarrow():
    """The card's machine has no pyarrow: chip_smoke.py and every port
    module but ``columnar.arrow`` import with it missing."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib; sys.modules['pyarrow'] = None\n"
        "import chip_smoke, trace_port, spark_rapids_jni_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    if not m.name.endswith('columnar.arrow'):\n"
        "        importlib.import_module(m.name)\n"
        "import spark_rapids_jni_tpu_torch.columnar as C\n"
        "try:\n"
        "    C.from_arrow\n"
        "except ImportError:\n"
        "    print('lazy')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "lazy"
