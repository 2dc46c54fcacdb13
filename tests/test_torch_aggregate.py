"""PyTorch port: group-by engines, against the JAX package.

Ints, counts and decimals are bit-identical to the reference; float sums
and means are held to the reference's documented f32x3 tolerance, rel 1e-5
(relational/aggregate.py group_by_onehot, float_mode='f32x3').  The port
runs on the CPU, where the one-hot group-by and slot-table wrappers run
their plain versions.
"""

import functools

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
from spark_rapids_jni_tpu.relational import aggregate as JAgg

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops import kernels as TKer
from spark_rapids_jni_tpu_torch.relational import aggregate as TAgg

from torch_parity import (MAX38, assert_col_equal, jdecimal, to_port,
                          unscaled)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5  # the reference's f32x3 float-sum tolerance


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def _batch(rng, n, K, kdtype=np.int32, vlo=-(2**40), vhi=2**40):
    kt = JT.INT32 if kdtype == np.int32 else JT.INT64
    return JBatch({
        "k": JColumn(jnp.asarray(rng.integers(0, K, n).astype(kdtype)),
                     jnp.asarray(rng.random(n) > 0.1), kt),
        "v": JColumn(jnp.asarray(rng.integers(vlo, vhi, n)),
                     jnp.asarray(rng.random(n) > 0.2), JT.INT64),
        "i": JColumn(jnp.asarray(rng.integers(-5, 5, n).astype(np.int32)),
                     jnp.asarray(rng.random(n) > 0.3), JT.INT32),
        "p": JColumn(jnp.asarray(rng.random(n) * 1e6),
                     jnp.asarray(rng.random(n) > 0.05), JT.FLOAT64),
    })


AGGS = [("sum", "v", "sv"), ("count", None, "c"), ("count", "v", "cv"),
        ("mean", "p", "mp"), ("sum", "p", "sp"), ("mean", "i", "mi"),
        ("sum", "i", "si")]
FLOATS = ("mp", "sp", "mi")


def _aggs(mod):
    return [mod.AggSpec(*a) for a in AGGS]


def assert_results_match(jres, jng, tres, tng, floats=FLOATS):
    """Live groups equal: ints and validity exact, floats rel 1e-5."""
    g = int(jng)
    assert int(tng) == g
    assert list(tres.names) == list(jres.names)
    for name in jres.names:
        jv = np.asarray(jres[name].validity)[:g]
        tv = tres[name].validity[:g].numpy()
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        if isinstance(tres[name], StringColumn):
            assert tres[name].to_pylist()[:g] == jres[name].to_pylist()[:g]
            continue
        jd = np.asarray(jres[name].data)[:g]
        td = tres[name].data[:g].numpy()
        if name in floats:
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(td[jv], jd[jv], err_msg=name)


class TestGroupByOnehot:
    def test_wide_domain_nulls_and_dead_rows(self):
        rng = np.random.default_rng(5)
        n, K = 3000, 200  # past one 128-lane block of the Pallas kernel
        jb = _batch(rng, n, K)
        live = rng.random(n) > 0.15
        jr, jng, jovf = jax.jit(lambda b, lv: JAgg.group_by_onehot(
            b, "k", _aggs(JAgg), K, row_valid=lv, float_mode="f32x3",
            engine="pallas"))(jb, jnp.asarray(live))
        tr, tng, tovf = TAgg.group_by_onehot(
            to_port(jb), "k", _aggs(TAgg), K,
            row_valid=torch.from_numpy(live))
        assert bool(jovf) == bool(tovf) is False
        assert_results_match(jr, jng, tr, tng)

    def test_against_the_xla_engine(self):
        rng = np.random.default_rng(6)
        jb = _batch(rng, 2000, 100, kdtype=np.int64)
        jr, jng, _ = jax.jit(lambda b: JAgg.group_by_onehot(
            b, "k", _aggs(JAgg), 100, float_mode="f32x3",
            engine="xla"))(jb)
        tr, tng, _ = TAgg.group_by_onehot(to_port(jb), "k", _aggs(TAgg), 100)
        assert_results_match(jr, jng, tr, tng)

    def test_int64_sum_wraps_like_spark(self):
        """Spark's non-ANSI int64 sum wraps mod 2^64: values near 2^62
        summed over a few hundred rows wrap past 2^63 several times."""
        rng = np.random.default_rng(7)
        n, K = 600, 3
        v = rng.integers(2**62 - 2**40, 2**62, n) * np.where(
            rng.random(n) > 0.1, 1, -1)
        jb = JBatch({
            "k": JColumn(jnp.asarray(rng.integers(0, K, n).astype(np.int32)),
                         jnp.ones((n,), jnp.bool_), JT.INT32),
            "v": JColumn(jnp.asarray(v), jnp.ones((n,), jnp.bool_),
                         JT.INT64)})
        aggs = [("sum", "v", "s"), ("count", None, "c")]
        jr, jng, _ = JAgg.group_by_onehot(
            jb, "k", [JAgg.AggSpec(*a) for a in aggs], K, engine="xla")
        tr, tng, _ = TAgg.group_by_onehot(
            to_port(jb), "k", [TAgg.AggSpec(*a) for a in aggs], K)
        assert_results_match(jr, jng, tr, tng, floats=())
        k = np.asarray(jb["k"].data)
        with np.errstate(over="ignore"):
            want = [np.sum(v[k == g].astype(np.int64)) for g in range(K)]
        assert tr["s"].data[:K].numpy().tolist() == want
        wrapped = [sum(int(x) for x in v[k == g]) for g in range(K)]
        assert any(not -2**63 <= w < 2**63 for w in wrapped)

    def test_out_of_domain_key_flags_overflow(self):
        jb = JBatch({"k": JColumn(jnp.asarray(np.array([1, 2**32],
                                                        np.int64)),
                                  jnp.ones((2,), jnp.bool_), JT.INT64)})
        _, _, ovf = TAgg.group_by_onehot(
            to_port(jb), "k", [TAgg.AggSpec("count", None, "c")], 8)
        assert bool(ovf)

    def test_f64_float_mode_rejected(self):
        jb = _batch(np.random.default_rng(8), 50, 4)
        with pytest.raises(ValueError, match="f32x3"):
            TAgg.group_by_onehot(to_port(jb), "k", _aggs(TAgg), 4,
                                 float_mode="f64")


# cases of the fused one-hot entry: (key dtype, aggs, key range, domain,
# share of dead rows, value range of "v")
_FUSED = {
    "int32_keys_and_values": (np.int32, [("sum", "i", "si"),
                                         ("count", None, "c"),
                                         ("count", "i", "ci"),
                                         ("mean", "p", "mp")], 50, 50, 0.0,
                              None),
    "int64_keys_and_values": (np.int64, [("sum", "v", "sv"),
                                         ("mean", "v", "mv"),
                                         ("count", None, "c")], 30, 30, 0.0,
                              None),
    "null_keys_dead_rows": (np.int32, AGGS, 40, 40, 0.25, None),
    "out_of_domain_flags_overflow": (np.int64, [("sum", "v", "sv"),
                                                ("count", None, "c")],
                                     12, 10, 0.1, None),
    "int64_sums_wrap": (np.int32, [("sum", "v", "sv"), ("count", "v", "cv")],
                        3, 3, 0.0, (2**62 - 2**40, 2**62)),
    "no_float_columns": (np.int64, [("sum", "v", "sv"), ("sum", "i", "si"),
                                    ("count", "p", "cp")], 20, 20, 0.1,
                         None),
    "no_int_columns": (np.int32, [("count", None, "c"), ("sum", "p", "sp"),
                                  ("mean", "p", "mp")], 20, 20, 0.1, None),
}


class TestFusedOnehotEntry:
    """The fused entry (onehot_groupby_columns) — on the CPU its plain
    path, the reference's payload, per-bucket sums and limb rebuild —
    against the reference's group_by_onehot through its Pallas kernel in
    interpret mode."""

    @pytest.mark.parametrize("case", sorted(_FUSED))
    def test_against_the_pallas_kernel(self, case):
        kdtype, aggs, krange, K, dead, vrange = _FUSED[case]
        rng = np.random.default_rng(sorted(_FUSED).index(case))
        n = 900
        jb = _batch(rng, n, krange, kdtype=kdtype)
        if vrange is not None:  # sums that wrap past 2^63
            v = rng.integers(*vrange, n) * np.where(rng.random(n) > 0.1, 1,
                                                    -1)
            jb = JBatch({**dict(zip(jb.names, jb.columns)),
                         "v": JColumn(jnp.asarray(v), jb["v"].validity,
                                      JT.INT64)})
        live = rng.random(n) >= dead
        jr, jng, jovf = jax.jit(lambda b, lv: JAgg.group_by_onehot(
            b, "k", [JAgg.AggSpec(*a) for a in aggs], K, row_valid=lv,
            float_mode="f32x3", engine="pallas"))(jb, jnp.asarray(live))
        tr, tng, tovf = TAgg.group_by_onehot(
            to_port(jb), "k", [TAgg.AggSpec(*a) for a in aggs], K,
            row_valid=torch.from_numpy(live))
        assert bool(tovf) == bool(jovf) == (case == "out_of_domain_flags"
                                            "_overflow")
        floats = [a[2] for a in aggs if a[0] == "mean" or a[1] == "p"]
        assert_results_match(jr, jng, tr, tng, floats=floats)
        if vrange is not None:
            k = np.asarray(jb["k"].data)
            ok = (np.asarray(jb["v"].validity) & live
                  & np.asarray(jb["k"].validity))
            with np.errstate(over="ignore"):
                want = [np.sum(v[(k == g) & ok].astype(np.int64))
                        for g in range(K)]
            assert tr["sv"].data[:K].numpy().tolist() == want

    def test_partials_layout(self):
        """count(*), the non-null counts and the int sums in ints; each
        float column's hi, mid and lo limb sums in floats."""
        key = torch.tensor([0, 1, 1, 5, 2], dtype=torch.int64)
        kv = torch.tensor([True, True, True, True, False])
        live = torch.tensor([True, True, True, True, True])
        v = torch.tensor([-1, 2**63 - 1, 2, 7, 9], dtype=torch.int64)
        p = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5], dtype=torch.float64)
        ones = torch.ones(5, dtype=torch.bool)
        ints, floats, ovf = TKer.onehot_groupby_columns(
            key, kv, live, [(v, ones), (p, ones)], [0], [1], 3)
        assert bool(ovf)  # key 5 is outside [0, 3)
        # buckets: 0 <- row 0; 1 <- rows 1, 2; 2 <- row 3 (clamped); 3 null
        assert ints.tolist() == [[1, 1, 1, -1], [2, 2, 2, -(2**63) + 1],
                                 [1, 1, 1, 7], [1, 1, 1, 9]]
        assert floats.shape == (4, 3)
        assert torch.allclose(floats.sum(1),
                              torch.tensor([0.1, 0.5, 0.4, 0.5],
                                           dtype=torch.float64))


class TestGroupByEngines:
    @pytest.mark.parametrize("engine", ["sort", "kernel"])
    def test_general_group_by(self, engine):
        rng = np.random.default_rng(9)
        jb = _batch(rng, 1500, 60)
        live = rng.random(1500) > 0.2
        jeng = "sort" if engine == "sort" else "scatter"
        jr, jng = jax.jit(lambda b, lv: JAgg.group_by(
            b, ["k"], _aggs(JAgg), row_valid=lv, engine=jeng))(
                jb, jnp.asarray(live))
        tr, tng = TAgg.group_by(to_port(jb), ["k"], _aggs(TAgg),
                                row_valid=torch.from_numpy(live),
                                engine=engine)
        assert_results_match(jr, jng, tr, tng)

    def test_multi_column_float_keys(self):
        rng = np.random.default_rng(10)
        n = 800
        f = rng.integers(0, 5, n).astype(np.float64)
        f[:6] = [-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf]
        jb = JBatch({
            "a": JColumn(jnp.asarray(rng.integers(0, 3, n)),
                         jnp.asarray(rng.random(n) > 0.1), JT.INT64),
            "f": JColumn(jnp.asarray(f), jnp.asarray(rng.random(n) > 0.1),
                         JT.FLOAT64),
            "v": JColumn(jnp.asarray(rng.integers(-9, 9, n)),
                         jnp.ones((n,), jnp.bool_), JT.INT64)})
        aggs = [("sum", "v", "s"), ("count", None, "c")]
        jr, jng = jax.jit(lambda b: JAgg.group_by(
            b, ["a", "f"], [JAgg.AggSpec(*a) for a in aggs],
            engine="scatter"))(jb)
        for engine in ("kernel", "sort"):
            tr, tng = TAgg.group_by(to_port(jb), ["a", "f"],
                                    [TAgg.AggSpec(*a) for a in aggs],
                                    engine=engine)
            assert_results_match(jr, jng, tr, tng, floats=())

    def test_slot_overflow_falls_back_to_sort(self):
        rng = np.random.default_rng(11)
        jb = _batch(rng, 400, 300)  # ~250 keys into a 16-slot table
        jr, jng = jax.jit(lambda b: JAgg.group_by(
            b, ["k"], _aggs(JAgg), engine="scatter", num_slots=16))(jb)
        tr, tng = TAgg.group_by(to_port(jb), ["k"], _aggs(TAgg),
                                engine="kernel", num_slots=16)
        assert_results_match(jr, jng, tr, tng)

    def test_assume_grouped(self):
        rng = np.random.default_rng(12)
        k = np.sort(rng.integers(0, 20, 500)).astype(np.int32)
        jb = JBatch({
            "k": JColumn(jnp.asarray(k), jnp.ones((500,), jnp.bool_),
                         JT.INT32),
            "v": JColumn(jnp.asarray(rng.integers(0, 99, 500)),
                         jnp.ones((500,), jnp.bool_), JT.INT64)})
        live = np.arange(500) < 450
        aggs = [("sum", "v", "s"), ("count", None, "c")]
        jr, jng = jax.jit(lambda b, lv: JAgg.group_by(
            b, ["k"], [JAgg.AggSpec(*a) for a in aggs], row_valid=lv,
            assume_grouped=True))(jb, jnp.asarray(live))
        tr, tng = TAgg.group_by(to_port(jb), ["k"],
                                [TAgg.AggSpec(*a) for a in aggs],
                                row_valid=torch.from_numpy(live),
                                assume_grouped=True)
        assert_results_match(jr, jng, tr, tng, floats=())

    def test_min_max_not_ported(self):
        """Once item 10's gap, min/max now match the reference."""
        jb = _batch(np.random.default_rng(13), 200, 7)
        aggs = [("min", "v", "m"), ("max", "p", "x")]
        jr, jng = jax.jit(lambda b: JAgg.group_by(
            b, ["k"], [JAgg.AggSpec(*a) for a in aggs],
            engine="sort"))(jb)
        tr, tng = TAgg.group_by(to_port(jb), ["k"],
                                [TAgg.AggSpec(*a) for a in aggs])
        assert_results_match(jr, jng, tr, tng, floats=())

    def test_engine_knob(self):
        tconfig.set("groupby_engine", "pallas")
        jb = _batch(np.random.default_rng(14), 10, 3)
        with pytest.raises(ValueError, match="groupby engine"):
            TAgg.group_by(to_port(jb), ["k"], _aggs(TAgg))


class TestDomainOrSort:
    @pytest.mark.parametrize("K", [10, 4])  # domain path / overflow path
    def test_both_branches(self, K):
        rng = np.random.default_rng(15)
        jb = _batch(rng, 700, 10)
        live = rng.random(700) > 0.1
        aggs = [("count", None, "orders"), ("sum", "v", "net"),
                ("mean", "p", "mp")]
        jr, jng = jax.jit(lambda b, lv: JAgg.group_by_domain_or_sort(
            b, "k", [JAgg.AggSpec(*a) for a in aggs], K, row_valid=lv))(
                jb, jnp.asarray(live))
        tr, tng = TAgg.group_by_domain_or_sort(
            to_port(jb), "k", [TAgg.AggSpec(*a) for a in aggs], K,
            row_valid=torch.from_numpy(live))
        assert tr.num_rows == jr.num_rows
        assert_results_match(jr, jng, tr, tng, floats=("mp",))


class TestOnehotKernelWrapper:
    def test_plain_version_sums_without_int8_wrap(self):
        """torch's CPU int8 @ int8 wraps in int8; the plain version adds
        into int64, so 1000 rows of 127 sum exactly."""
        n = 1000
        bucket = torch.zeros(n, dtype=torch.int32)
        bucket[::7] = -1  # dead rows
        pi = torch.full((n, 2), 127, dtype=torch.int8)
        pf = torch.full((n, 1), 0.5, dtype=torch.float32)
        oi, of = TKer.onehot_groupby_parts(bucket, pi, pf, 3)
        live = int((bucket >= 0).sum())
        assert oi.tolist() == [[127 * live] * 2, [0, 0], [0, 0]]
        assert of[0, 0].item() == 0.5 * live

    def test_wrapper_checks_types(self):
        bucket = torch.zeros(4, dtype=torch.int64)
        with pytest.raises(ValueError, match="int32"):
            TKer.onehot_groupby_parts(bucket, torch.zeros((4, 1),
                                                          dtype=torch.int8),
                                      torch.zeros((4, 0)), 2)



def _minmax_batch(rng, n, K):
    f = rng.random(n) * 100 - 50
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    g = (rng.random(n) * 10).astype(np.float32)
    g[rng.random(n) < 0.1] = np.nan
    kf = rng.integers(0, K, n)
    f[kf == 0] = np.nan  # a group whose non-null values are all NaN
    return JBatch({
        "k": JColumn(jnp.asarray(kf.astype(np.int32)),
                     jnp.asarray(rng.random(n) > 0.05), JT.INT32),
        "f": JColumn(jnp.asarray(f), jnp.asarray(rng.random(n) > 0.1),
                     JT.FLOAT64),
        "g": JColumn(jnp.asarray(g), jnp.asarray(rng.random(n) > 0.1),
                     JT.FLOAT32),
        "b": JColumn(jnp.asarray(rng.random(n) > 0.7),
                     jnp.asarray(rng.random(n) > 0.2), JT.BOOLEAN),
        "i8": JColumn(jnp.asarray(rng.integers(-128, 128, n)
                                  .astype(np.int8)),
                      jnp.asarray((rng.random(n) > 0.2) & (kf != 1)),
                      JT.INT8),
        "i16": JColumn(jnp.asarray(rng.integers(-3000, 3000, n)
                                   .astype(np.int16)),
                       jnp.asarray(rng.random(n) > 0.2), JT.INT16),
        "v": JColumn(jnp.asarray(rng.integers(-(2**62), 2**62, n)),
                     jnp.asarray(rng.random(n) > 0.2), JT.INT64),
    })


MINMAX = [("min", "f", "fmin"), ("max", "f", "fmax"), ("min", "g", "gmin"),
          ("max", "g", "gmax"), ("min", "b", "bmin"), ("max", "b", "bmax"),
          ("min", "i8", "i8min"), ("max", "i8", "i8max"),
          ("min", "i16", "i16min"), ("max", "v", "vmax"),
          ("sum", "i8", "i8sum"), ("mean", "g", "gmean"),
          ("count", None, "c")]


def _assert_minmax_match(jr, jng, tr, tng):
    """Floats of min/max compare as values (NaN equal to NaN, -0.0 to
    0.0); everything else as assert_results_match."""
    g = int(jng)
    assert int(tng) == g
    for name in jr.names:
        jv = np.asarray(jr[name].validity)[:g]
        np.testing.assert_array_equal(tr[name].validity[:g].numpy(), jv,
                                      err_msg=name)
        a = tr[name].data[:g].numpy()[jv]
        b = np.asarray(jr[name].data)[:g][jv]
        if name == "gmean":
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


class TestMinMax:
    @pytest.mark.parametrize("engine", ["sort", "kernel"])
    def test_nan_bools_narrow_ints_and_all_null_groups(self, engine):
        rng = np.random.default_rng(31)
        jb = _minmax_batch(rng, 1500, 9)
        live = rng.random(1500) > 0.1
        specs = [JAgg.AggSpec(*a) for a in MINMAX]
        jr, jng = jax.jit(lambda b, lv: JAgg.group_by(
            b, ["k"], specs, row_valid=lv, engine="sort"))(
                jb, jnp.asarray(live))
        tr, tng = TAgg.group_by(to_port(jb), ["k"],
                                [TAgg.AggSpec(*a) for a in MINMAX],
                                row_valid=torch.from_numpy(live),
                                engine=engine)
        _assert_minmax_match(jr, jng, tr, tng)
        # group 0's values are NaN or null: max is NaN, and so is min
        row0 = int(np.flatnonzero(tr["k"].data.numpy()[:int(tng)] == 0)[0])
        assert np.isnan(tr["fmax"].data[row0].item())
        assert np.isnan(tr["fmin"].data[row0].item())
        # group 1's int8 values are all null: the min is null
        row1 = int(np.flatnonzero(tr["k"].data.numpy()[:int(tng)] == 1)[0])
        assert not bool(tr["i8min"].validity[row1])

    def test_against_the_reference_scatter_engine(self):
        rng = np.random.default_rng(32)
        jb = _minmax_batch(rng, 800, 5)
        specs = [JAgg.AggSpec(*a) for a in MINMAX]
        jr, jng = jax.jit(lambda b: JAgg.group_by(
            b, ["k"], specs, engine="scatter"))(jb)
        tr, tng = TAgg.group_by(to_port(jb), ["k"],
                                [TAgg.AggSpec(*a) for a in MINMAX])
        _assert_minmax_match(jr, jng, tr, tng)

    def test_domain_engine_sums_narrow_ints_and_float32(self):
        rng = np.random.default_rng(37)
        jb = _minmax_batch(rng, 900, 6)
        aggs = [("sum", "i8", "s8"), ("mean", "i16", "m16"),
                ("sum", "g", "sg"), ("count", "b", "cb"),
                ("sum", "b", "sb")]
        jr, jng, _ = jax.jit(lambda b: JAgg.group_by_onehot(
            b, "k", [JAgg.AggSpec(*a) for a in aggs], 6,
            float_mode="f32x3", engine="pallas"))(jb)
        tr, tng, _ = TAgg.group_by_onehot(
            to_port(jb), "k", [TAgg.AggSpec(*a) for a in aggs], 6)
        assert_results_match(jr, jng, tr, tng, floats=("m16", "sg"))

    def test_domain_engine_rejects_min_max(self):
        jb = _batch(np.random.default_rng(33), 50, 3)
        with pytest.raises(ValueError, match="min/max"):
            TAgg.group_by_onehot(to_port(jb), "k",
                                 [TAgg.AggSpec("min", "v", "m")], 4)


def _string_key_batch(rng, n, K, width=24):
    cats = [f"cat-{i:02d}-{'x' * 14}" for i in range(K)] + ["", "a",
                                                          "a\x00"]
    kidx = rng.integers(0, len(cats), n)
    vals = [None if rng.random() < 0.05 else cats[i] for i in kidx]
    return JBatch({
        "s": JString.from_pylist(vals, max_len=width),
        "k": JColumn(jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INT32),
        "v": JColumn(jnp.asarray(rng.integers(-1000, 1000, n)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INT64),
        "p": JColumn(jnp.asarray(rng.random(n) * 100.0),
                     jnp.ones((n,), jnp.bool_), JT.FLOAT64),
    })


STR_AGGS = [("sum", "v", "sv"), ("count", None, "c"), ("mean", "p", "mp"),
            ("min", "v", "mn"), ("max", "p", "mx")]


class TestStringKeys:
    @pytest.mark.parametrize("engine", ["sort", "kernel"])
    @pytest.mark.parametrize("keys", [["s"], ["s", "k"], ["k", "s"]])
    def test_string_and_multi_column_keys(self, engine, keys):
        rng = np.random.default_rng(34)
        jb = _string_key_batch(rng, 1200, 30)
        live = rng.random(1200) > 0.2
        jr, jng = jax.jit(lambda b, lv: JAgg.group_by(
            b, keys, [JAgg.AggSpec(*a) for a in STR_AGGS], row_valid=lv,
            engine="sort"))(jb, jnp.asarray(live))
        tr, tng = TAgg.group_by(to_port(jb), keys,
                                [TAgg.AggSpec(*a) for a in STR_AGGS],
                                row_valid=torch.from_numpy(live),
                                engine=engine)
        assert_results_match(jr, jng, tr, tng, floats=("mp",))

    def test_kernel_engine_overflow_falls_back_to_sort(self):
        """100 distinct string keys cannot fit 64 slots: the sort engine's
        result, unchanged."""
        rng = np.random.default_rng(35)
        jb = _string_key_batch(rng, 600, 100)
        jr, jng = jax.jit(lambda b: JAgg.group_by(
            b, ["s"], [JAgg.AggSpec(*a) for a in STR_AGGS],
            engine="sort"))(jb)
        tr, tng = TAgg.group_by(to_port(jb), ["s"],
                                [TAgg.AggSpec(*a) for a in STR_AGGS],
                                engine="kernel", num_slots=64)
        assert_results_match(jr, jng, tr, tng, floats=("mp",))

    def test_string_value_columns_are_refused_as_the_reference_does(self):
        tb = to_port(_string_key_batch(np.random.default_rng(36), 20, 3))
        with pytest.raises(NotImplementedError, match="string"):
            TAgg.group_by(tb, ["k"], [TAgg.AggSpec("max", "s", "m")])


# ---------------------------------------------------------------------------
# decimals: sums, means, min/max and keys on every engine
# ---------------------------------------------------------------------------

def _decimal_batch(rng, n, K, overflow=True):
    """Key ``k`` in [0, K) (10 % null); ``d`` decimal(38,2) of mixed
    magnitudes and signs, where group 0 holds values near +10^38 and group
    1 near -10^38 so their sums pass the decimal(38) range (null) while
    their count and min/max stay defined; ``p`` decimal(7,2) prices."""
    k = rng.integers(0, K, n).astype(np.int32)
    d = unscaled(rng, n, 38, nulls=0.08)
    if overflow:
        for i in np.flatnonzero(k == 0)[:40]:
            d[i] = MAX38 - int(rng.integers(0, 10 ** 6))
        for i in np.flatnonzero(k == 1)[:40]:
            d[i] = -MAX38 + int(rng.integers(0, 10 ** 6))
    return JBatch({
        "k": JColumn(jnp.asarray(k), jnp.asarray(rng.random(n) > 0.1),
                     JT.INT32),
        "d": jdecimal(d, 38, 2),
        "p": jdecimal(unscaled(rng, n, 7, nulls=0.1), 7, 2),
        "v": JColumn(jnp.asarray(rng.integers(-99, 99, n)),
                     jnp.ones((n,), jnp.bool_), JT.INT64)})


DEC_AGGS = [("sum", "d", "sd"), ("mean", "d", "md"), ("count", "d", "cd"),
            ("sum", "p", "sp"), ("mean", "p", "mp"), ("count", None, "c"),
            ("sum", "v", "sv")]
DEC_MINMAX = [("min", "d", "nd"), ("max", "d", "xd"), ("min", "p", "np_"),
              ("max", "p", "xp")]


def _assert_decimal_results(jr, jng, tr, tng):
    g = int(jng)
    assert int(tng) == g
    assert list(tr.names) == list(jr.names)
    for name in jr.names:
        assert_col_equal(jr[name], tr[name], rows=g, msg=name)


@functools.lru_cache(maxsize=None)
def _general_inputs():
    rng = np.random.default_rng(51)
    jb = _decimal_batch(rng, 1500, 9)
    return jb, rng.random(1500) > 0.1


_GENERAL_AGGS = DEC_AGGS + DEC_MINMAX


@functools.lru_cache(maxsize=None)
def _general_reference(jengine):
    """The reference's group-by on one engine, shared by every port
    engine it is held against."""
    jb, live = _general_inputs()
    return jax.jit(lambda b, lv: JAgg.group_by(
        b, ["k"], [JAgg.AggSpec(*a) for a in _GENERAL_AGGS], row_valid=lv,
        engine=jengine))(jb, jnp.asarray(live))


@functools.lru_cache(maxsize=None)
def _general_port(engine):
    jb, live = _general_inputs()
    return TAgg.group_by(to_port(jb), ["k"],
                         [TAgg.AggSpec(*a) for a in _GENERAL_AGGS],
                         row_valid=torch.from_numpy(live), engine=engine)


@functools.lru_cache(maxsize=None)
def _keys_inputs():
    rng = np.random.default_rng(52)
    jb = _decimal_batch(rng, 1200, 5, overflow=False)
    # few distinct prices so groups repeat
    pv = rng.integers(-40, 40, 1200)
    pn = rng.random(1200) < 0.05
    return jb.with_column("p", jdecimal(
        [None if z else int(x) * 25 for x, z in zip(pv, pn)], 7, 2))


_KEYS_AGGS = [("sum", "d", "sd"), ("count", None, "c"), ("min", "d", "nd"),
              ("max", "d", "xd"), ("sum", "v", "sv")]


@functools.lru_cache(maxsize=None)
def _keys_reference(key):
    """The reference's sort-engine group-by on ``key``, shared by every
    port engine it is held against."""
    keys = key.split("+")
    return jax.jit(lambda b: JAgg.group_by(
        b, keys, [JAgg.AggSpec(*a) for a in _KEYS_AGGS],
        engine="sort"))(_keys_inputs())


class TestDecimalAggregates:
    @pytest.mark.parametrize("engine", ["sort", "kernel"])
    @pytest.mark.parametrize("jengine", ["sort", "scatter"])
    def test_general_engines(self, engine, jengine):
        """Exact 256-bit sums (overflowing groups null), Spark's bounded
        average, signed-128 min/max and counts, bit for bit."""
        jr, jng = _general_reference(jengine)
        tr, tng = _general_port(engine)
        _assert_decimal_results(jr, jng, tr, tng)
        sd = tr["sd"]
        keys = tr["k"].data[:int(tng)].tolist()
        kv = tr["k"].validity[:int(tng)].tolist()
        for g in (0, 1):  # the overflowing groups: null sum, defined max
            row = [i for i, (k, v) in enumerate(zip(keys, kv))
                   if v and k == g][0]
            assert not bool(sd.validity[row])
            assert bool(tr["xd"].validity[row])
        assert repr(sd.dtype) == "decimal(38,2)"
        assert repr(tr["sp"].dtype) == "decimal(17,2)"
        assert repr(tr["md"].dtype) == "decimal(38,6)"
        assert repr(tr["mp"].dtype) == "decimal(11,6)"

    @pytest.mark.parametrize("engine", ["sort", "kernel"])
    @pytest.mark.parametrize("key", ["p", "d", "p+k"])
    def test_decimal_keys(self, engine, key):
        """Group by decimal(7,2) (2 key words), decimal(38,2) (4) and a
        decimal-int composite, nulls first."""
        jr, jng = _keys_reference(key)
        tr, tng = TAgg.group_by(to_port(_keys_inputs()), key.split("+"),
                                [TAgg.AggSpec(*a) for a in _KEYS_AGGS],
                                engine=engine)
        _assert_decimal_results(jr, jng, tr, tng)

    @pytest.mark.parametrize("jengine", ["pallas", "scatter"])
    @pytest.mark.parametrize("K", [9, 3000])
    def test_domain_engine_lanes(self, jengine, K):
        """The fused entry's decimal lanes (on the CPU its plain path over
        the reference's 16 byte limbs and negative flag) against the
        reference's Pallas kernel in interpret mode and its scatter
        engine, overflowing groups included; ``d64`` partials equal."""
        rng = np.random.default_rng(53)
        jb = _decimal_batch(rng, 1100, min(K, 40))
        live = rng.random(1100) > 0.1
        specs = [JAgg.AggSpec(*a) for a in DEC_AGGS]
        jr, jng, jovf = jax.jit(lambda b, lv: JAgg.group_by_onehot(
            b, "k", specs, K, row_valid=lv, float_mode="f32x3",
            engine=jengine))(jb, jnp.asarray(live))
        tb = to_port(jb)
        tspecs = [TAgg.AggSpec(*a) for a in DEC_AGGS]
        tr, tng, tovf = TAgg.group_by_onehot(
            tb, "k", tspecs, K, row_valid=torch.from_numpy(live))
        assert bool(jovf) == bool(tovf) is False
        _assert_decimal_results(jr, jng, tr, tng)
        jparts, _ = JAgg._domain_partials(jb, "k", specs, K,
                                          jnp.asarray(live), engine=jengine,
                                          float_mode="f32x3")
        tparts, _ = TAgg._domain_partials(tb, "k", tspecs, K,
                                          torch.from_numpy(live))
        for c in ("d", "p"):
            np.testing.assert_array_equal(
                tparts["d64"][c].numpy().astype(np.uint64),
                np.asarray(jparts["d64"][c]), err_msg=c)

    def test_domain_engine_rejects_decimal_min_max(self):
        jb = _decimal_batch(np.random.default_rng(54), 50, 3)
        with pytest.raises(ValueError, match="min/max"):
            TAgg.group_by_onehot(to_port(jb), "k",
                                 [TAgg.AggSpec("max", "d", "m")], 4)

    def test_nested_value_columns_refused(self):
        from spark_rapids_jni_tpu.columnar.column import ListColumn as JL

        jb = JBatch({"k": JColumn(jnp.zeros((3,), jnp.int32),
                                  jnp.ones((3,), jnp.bool_), JT.INT32),
                     "l": JL.from_pylist([[1], [], None], JT.INT64)})
        with pytest.raises(NotImplementedError, match="list"):
            TAgg.group_by(to_port(jb), ["k"],
                          [TAgg.AggSpec("count", "l", "c")])

