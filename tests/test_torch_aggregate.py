"""PyTorch port: group-by engines, against the JAX package.

Ints and counts are bit-identical to the reference; float sums and means
are held to the reference's documented f32x3 tolerance, rel 1e-5
(relational/aggregate.py group_by_onehot, float_mode='f32x3').  The port
runs on the CPU, where the one-hot group-by and slot-table wrappers run
their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.relational import aggregate as JAgg

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
from spark_rapids_jni_tpu_torch.ops import kernels as TKer
from spark_rapids_jni_tpu_torch.relational import aggregate as TAgg

RTOL = 1e-5  # the reference's f32x3 float-sum tolerance


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def to_port(jb):
    return batch_from_numpy(
        {n: (np.asarray(c.data), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


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
        jd = np.asarray(jres[name].data)[:g]
        jv = np.asarray(jres[name].validity)[:g]
        td = tres[name].data[:g].numpy()
        tv = tres[name].validity[:g].numpy()
        np.testing.assert_array_equal(tv, jv, err_msg=name)
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
        jb = _batch(np.random.default_rng(13), 10, 3)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TAgg.group_by(to_port(jb), ["k"], [TAgg.AggSpec("min", "v", "m")])

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

