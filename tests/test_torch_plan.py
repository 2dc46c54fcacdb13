"""PyTorch port: the plan layer against the JAX package's.

Reference counterparts: ``spark_rapids_jni_tpu/plan/`` (``execute``,
``compile_plan``, the plan cache, ``plan_decisions``, the streaming
lowering) and ``tests/test_plan.py``.  q6, q95 and q9 go through the
port's ``plan.execute`` and the reference's on the same seeded data,
under both engine-knob settings, and the port's plans are also held
bit-identical to its own hand-fused ``pipelines.py`` steps and to the
numpy oracles.  Ints and counts bit-identical; float means rel 1e-5 (the
reference's f32x3 tolerance).  The reference runs its ``auto`` engines on
the CPU (hash/scatter), the port its kernel tier's plain versions.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu import plan as jplan
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.parallel import data_mesh, shard_batch
from spark_rapids_jni_tpu.plan import queries as jq
from spark_rapids_jni_tpu.shuffle import MorselSource as JMorselSource

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch import plan as tplan
from spark_rapids_jni_tpu_torch.columnar.column import (StringColumn,
                                                        batch_from_numpy)
from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
from spark_rapids_jni_tpu_torch.plan import queries as tq
from spark_rapids_jni_tpu_torch.shuffle import MorselSource

RTOL = 1e-5
# the reference's engine names on the CPU -> the port's tier
_ENGINE = {"hash": "kernel", "scatter": "kernel", "pallas": "kernel"}


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh plan caches; every knob a test touches is reset one by one
    (a blanket reference reset would undo conftest's session knobs)."""
    jplan.reset_plan_cache()
    tplan.reset_plan_cache()
    touched = []

    def knob(key, value):
        touched.append(key)
        jconfig.set(key, value)
        tconfig.set(key, value)

    yield knob
    for key in touched:
        jconfig.reset(key)
    tconfig.reset()
    jplan.reset_plan_cache()
    tplan.reset_plan_cache()


def _host(c):
    if isinstance(c, JString):
        return (np.asarray(c.chars), np.asarray(c.lengths))
    return np.asarray(c.data)


def to_port(jb):
    return batch_from_numpy(
        {n: (_host(c), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


def assert_groups_match(jres, jng, tres, tng, floats=()):
    g = int(jng)
    assert int(tng) == g
    assert list(tres.names) == list(jres.names)
    for name in jres.names:
        jv = np.asarray(jres[name].validity)[:g]
        np.testing.assert_array_equal(tres[name].validity[:g].numpy(), jv,
                                      err_msg=name)
        if isinstance(tres[name], StringColumn):
            for buf in ("chars", "lengths"):
                np.testing.assert_array_equal(
                    getattr(tres[name], buf)[:g].numpy(),
                    np.asarray(getattr(jres[name], buf))[:g], err_msg=name)
            continue
        jd = np.asarray(jres[name].data)[:g]
        td = tres[name].data[:g].numpy()
        if name in floats:
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(td[jv], jd[jv], err_msg=name)


def assert_same_batch(a, b):
    """Two port results bit-identical, padding included."""
    (ra, na), (rb, nb) = a, b
    assert int(na) == int(nb)
    assert list(ra.names) == list(rb.names)
    for name in ra.names:
        assert torch.equal(ra[name].data, rb[name].data), name
        assert torch.equal(ra[name].validity, rb[name].validity), name


def _q95_inputs(n, seed):
    jf, jd1, jd2 = ge._q95_batches(n, seed=seed)
    jin = {"fact": jf, "dim1": jd1, "dim2": jd2}
    return jin, {k: to_port(v) for k, v in jin.items()}


# ---------------------------------------------------------------------------
# q6, q95, q9 through execute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,engine", [("onehot", "auto"),
                                         ("sort", "auto"),
                                         ("sort", "sort")])
def test_q6_plan_matches_reference_and_hand_step(_fresh, path, engine):
    _fresh("q6_group_path", path)
    _fresh("groupby_engine", engine)
    jb = ge._example_batch(3000, seed=5)
    tb = to_port(jb)
    jres, jng = jplan.execute(jq.q6_plan(), {"batch": jb})
    got = tplan.execute(tq.q6_plan(), {"batch": tb})
    assert_groups_match(jres, jng, *got, floats=("avg_price",))
    assert_same_batch(got, TP.q6_step(tb))


@pytest.mark.parametrize("engine", ["auto", "sort"])
def test_q95_plan_matches_reference_and_hand_step(_fresh, engine):
    _fresh("groupby_engine", engine)
    jin, tin = _q95_inputs(4096, 23)
    jres, jng = jplan.execute(jq.q95_plan(), jin)
    got = tplan.execute(tq.q95_plan(), tin)
    assert_groups_match(jres, jng, *got)
    assert_same_batch(got, TP.q95_step(tin["fact"], tin["dim1"],
                                       tin["dim2"]))
    orders, net = TP.q95_oracle(TP.q95_arrays(4096, 23))
    groups = TP.result_groups(*got, "seg")
    assert [groups[s]["orders"] for s in range(TP.Q95_SEG)] == \
        orders.tolist()
    assert [groups[s]["net"] for s in range(TP.Q95_SEG)] == net.tolist()


@pytest.mark.parametrize("threshold", [None, 100])
def test_q9_plan_matches_reference_and_oracle(_fresh, threshold):
    """Default threshold: both dims broadcast.  100 rows: dim1 (512 rows)
    goes shuffled through the dense join, dim2 (25 rows) broadcast — the
    full-size path's split."""
    if threshold is not None:
        _fresh("broadcast_threshold_rows", threshold)
    jin, tin = _q95_inputs(4096, 29)
    jcp = jplan.compile_plan(jq.q9_plan(), jin)
    try:
        jres, jng = jcp(jin)
    finally:
        jcp.close()
    cp = tplan.compile_plan(tq.q9_plan(), tin)
    res, ng = cp(tin)
    want = "shuffled" if threshold else "broadcast"
    assert cp.decisions["join0:k"]["strategy"] == want
    assert cp.decisions["join1:wh"]["strategy"] == "broadcast"
    assert len(cp.build_handles) == (1 if threshold else 2)
    assert_groups_match(jres, jng, res, ng, floats=("avg_hi",))
    net, orders = TP.q9_oracle(TP.q95_arrays(4096, 29))
    groups = TP.result_groups(res, ng, "seg")
    for s in range(TP.Q95_SEG):
        assert groups[s]["net_hi"] == int(net[s])
        assert groups[s]["orders_hi"] == int(orders[s])
        assert groups[s]["avg_hi"] == pytest.approx(net[s] / orders[s],
                                                    rel=RTOL)


def test_reused_plan_rebuilds_broadcast_table_for_new_data(_fresh):
    """A cached q9 plan reused over new dim data of the same shape probes
    a table of THAT data, not the one it compiled with."""
    _, tin = _q95_inputs(2048, 31)
    tplan.execute(tq.q9_plan(), tin)
    arrs = TP.q95_arrays(2048, 31)
    arrs["dim2"]["wh"] = arrs["dim2"]["wh"][::-1].copy() + 3  # 3..27
    tin2 = dict(tin)
    tin2["dim2"] = batch_from_numpy(
        {n: (a, np.ones(a.shape, bool), TP._Q95_TYPES[n])
         for n, a in arrs["dim2"].items()}, device="cpu")
    t0 = tplan.trace_count()
    cp = tplan.compile_plan(tq.q9_plan(), tin2)
    assert cp.last_lookup == "hit" and tplan.trace_count() == t0
    res, ng = cp(tin2)
    net, orders = TP.q9_oracle(arrs)
    groups = TP.result_groups(res, ng, "seg")
    assert [groups[s]["orders_hi"] for s in range(TP.Q95_SEG)] == \
        orders.tolist()


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def _q6_input(seed, n):
    return {"batch": TP.example_batch(n, seed=seed, device="cpu")}


def test_repeated_shape_hits_with_no_compile(_fresh):
    r1 = tplan.execute(tq.q6_plan(), _q6_input(0, 1024))
    t0 = tplan.trace_count()
    assert tplan.plan_cache_metrics()["misses"] >= 1
    b2 = _q6_input(1, 1024)
    cp = tplan.compile_plan(tq.q6_plan(), b2)
    assert cp.last_lookup == "hit"
    r2 = cp(b2)
    assert tplan.trace_count() == t0
    assert tplan.plan_cache_metrics()["hits"] >= 1
    assert int(r1[1]) == 100
    assert_same_batch(r2, TP.q6_step(b2["batch"]))


def test_knob_flip_is_a_miss(_fresh):
    b = _q6_input(0, 1024)
    tplan.execute(tq.q6_plan(), b)
    _fresh("groupby_engine", "sort")
    assert tplan.compile_plan(tq.q6_plan(), b).last_lookup == "miss"


def test_shape_change_is_a_miss(_fresh):
    tplan.execute(tq.q6_plan(), _q6_input(0, 1024))
    cp = tplan.compile_plan(tq.q6_plan(), _q6_input(0, 2048))
    assert cp.last_lookup == "miss"


def test_lru_eviction_pins_and_snapshot_invalidation(_fresh):
    _fresh("plan_cache_size", 1)
    b1, b2 = _q6_input(0, 1024), _q6_input(0, 2048)
    tplan.execute(tq.q6_plan(), b1)
    tplan.execute(tq.q6_plan(), b2)  # evicts the first
    m = tplan.plan_cache_metrics()
    assert m["evictions"] >= 1 and m["size"] == 1 and m["capacity"] == 1
    assert tplan.compile_plan(tq.q6_plan(), b1).last_lookup == "miss"
    # a pinned plan survives LRU pressure until unpinned
    cache = tplan.get_plan_cache()
    key1 = tplan.compile_plan(tq.q6_plan(), b1).key
    cache.pin(key1, "tenant-a")
    tplan.execute(tq.q6_plan(), b2)
    assert tplan.compile_plan(tq.q6_plan(), b1).last_lookup == "hit"
    cache.unpin(key1, "tenant-a")
    assert not cache.pinned(key1)
    # plans whose signature embeds a snapshot id drop with it
    from spark_rapids_jni_tpu_torch.plan.ir import bind_snapshots

    bound = bind_snapshots(tq.q6_plan(), {"batch": "mem:x"})
    tplan.execute(bound, b1)
    assert cache.invalidate_snapshot("mem:x") == 1
    assert tplan.compile_plan(bound, b1).last_lookup == "miss"


# ---------------------------------------------------------------------------
# adaptive decisions
# ---------------------------------------------------------------------------

def _mapped(decisions):
    out = {}
    for k, v in decisions.items():
        if isinstance(v, dict) and "engine" in v:
            v = dict(v, engine=_ENGINE.get(v["engine"], v["engine"]))
        out[k] = v
    return out


@pytest.mark.parametrize("stats", [
    None,
    {"counts": [1000, 0, 0, 0]},
    {"counts": [10, 12, 9, 11]},
    {"stages_ms": {"exch1": 1.0, "join1": 1.0, "agg": 6.0}},
    {"shuffle": {"shuffles": 2, "rows_moved": 1 << 16, "max_skew": 4.0,
                 "compressed_bytes_saved": 64}},
    {"key_range": (0, 1000)},
    {"key_range": (-(1 << 62), 1 << 62)},
])
@pytest.mark.parametrize("adaptive", [True, False])
def test_plan_decisions_match_reference(_fresh, stats, adaptive):
    _fresh("adaptive_execution", adaptive)
    jin, tin = _q95_inputs(1024, 3)
    for jp, tp in ((jq.q9_plan(), tq.q9_plan()),
                   (jq.q95_plan(), tq.q95_plan()),
                   (jq.q6_plan(), tq.q6_plan())):
        want = _mapped(jplan.plan_decisions(jp, jin, stats))
        assert tplan.plan_decisions(tp, tin, stats) == want


def test_choices_match_reference(_fresh):
    for rows, thr in ((100, 100), (101, 100), (7, None), (1 << 17, None)):
        assert (tplan.choose_join_strategy(rows, threshold=thr)
                == jplan.choose_join_strategy(rows, threshold=thr))
    assert tplan.choose_join_engine() == "kernel"
    for counts in ([4096, 64, 64, 64], [5, 5, 5, 5]):
        a = tplan.choose_exchange_capacity(counts=counts)
        b = jplan.choose_exchange_capacity(counts=counts)
        assert (a.rounds, a.capacity) == (b.rounds, b.capacity)
    assert tplan.choose_exchange_capacity() is None


# ---------------------------------------------------------------------------
# exchanges through execute, streamed and local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [True, False])
def test_exchange_scan_lowering_matches_reference(_fresh, eight_devices,
                                                  stream):
    from spark_rapids_jni_tpu.plan.ir import Exchange as JExchange
    from spark_rapids_jni_tpu.plan.ir import Scan as JScan

    from spark_rapids_jni_tpu_torch.plan.ir import Exchange, Scan

    _fresh("shuffle_stream", stream)
    _fresh("shuffle_capacity_bucket", 16)
    _fresh("shuffle_round_rows", 32)
    jf, _, _ = ge._q95_batches(8 * 256, seed=37)
    tf = to_port(jf)
    if stream:
        jm, tm = data_mesh(8), ShardMesh(8, device="cpu")
        jin = {"fact": JMorselSource.from_batch(shard_batch(jf, jm), jm,
                                                morsel_rows=64)}
        tin = {"fact": MorselSource.from_batch(tf, tm, morsel_rows=64)}
    else:
        jin, tin = {"fact": jf}, {"fact": tf}
    jout = jplan.execute(JExchange(JScan("fact"), "k"), jin)
    tout = tplan.execute(Exchange(Scan("fact"), "k"), tin)
    if stream:
        (jb, jocc), (tb, tocc) = jout, tout
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
        assert int(tocc.sum()) == jf.num_rows
    else:
        jb, tb = jout, tout
    for name in jb.names:
        np.testing.assert_array_equal(tb[name].data.numpy(),
                                      np.asarray(jb[name].data))
        np.testing.assert_array_equal(tb[name].validity.numpy(),
                                      np.asarray(jb[name].validity))


def test_result_key_needs_snapshots(_fresh):
    from spark_rapids_jni_tpu_torch.plan.compile import result_key
    from spark_rapids_jni_tpu_torch.plan.ir import Exchange, Scan

    tm = ShardMesh(8, device="cpu")
    b = TP.example_batch(8 * 16, seed=2, device="cpu")
    plan = Exchange(Scan("batch"), "k")
    assert result_key(plan, {"batch": b}) is None
    k1 = result_key(plan, {"batch": MorselSource.from_batch(b, tm)})
    k2 = result_key(plan, {"batch": MorselSource.from_batch(b, tm)})
    b3 = TP.example_batch(8 * 16, seed=3, device="cpu")
    k3 = result_key(plan, {"batch": MorselSource.from_batch(b3, tm)})
    assert k1 is not None and k1 == k2 and k1 != k3


def test_sort_is_not_ported(_fresh):
    """Once item 10's gap: a root Sort over a scan now runs, and matches
    the reference's permutation row for row."""
    from spark_rapids_jni_tpu.plan.ir import Scan as JScan
    from spark_rapids_jni_tpu.plan.ir import Sort as JSort
    from spark_rapids_jni_tpu_torch.plan.ir import Scan, Sort

    jb = ge._example_batch(512, seed=4)
    jout = jplan.execute(JSort(JScan("batch"), ("k", "v")), {"batch": jb})
    tout = tplan.execute(Sort(Scan("batch"), ("k", "v")),
                         {"batch": to_port(jb)})
    for name in jout.names:
        np.testing.assert_array_equal(tout[name].data.numpy(),
                                      np.asarray(jout[name].data))


@pytest.mark.parametrize("with_nulls", [False, True])
def test_sort_with_a_live_mask_puts_dead_rows_last(_fresh, with_nulls):
    """``_lower_sort`` under a filter: the live rows sorted by the keys
    form a prefix (``__occ`` trick), equal to the reference's and to
    ``np.lexsort`` of the live rows."""
    from spark_rapids_jni_tpu.columnar.column import Column as JColumn
    from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
    from spark_rapids_jni_tpu.plan.ir import Filter as JFilter
    from spark_rapids_jni_tpu.plan.ir import Scan as JScan
    from spark_rapids_jni_tpu.plan.ir import Sort as JSort
    from spark_rapids_jni_tpu_torch.plan.ir import Filter, Scan, Sort

    n = 700
    jb = ge._example_batch(n, seed=5)
    if with_nulls:
        rng = np.random.default_rng(5)
        k = jb["k"]
        jb = JBatch(dict(zip(jb.names, jb.columns), k=JColumn(
            k.data, np.asarray(rng.random(n) > 0.1), k.dtype)))
    jplan_ = JSort(JFilter(JScan("batch"), "price", "<", 50.0), ("k", "v"))
    tplan_ = Sort(Filter(Scan("batch"), "price", "<", 50.0), ("k", "v"))
    jout, jlive = jplan.execute(jplan_, {"batch": jb})
    tout, tlive = tplan.execute(tplan_, {"batch": to_port(jb)})
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    m = int(tlive.sum())
    assert list(tout.names) == ["k", "v", "price"]
    for name in jout.names:
        np.testing.assert_array_equal(tout[name].data[:m].numpy(),
                                      np.asarray(jout[name].data)[:m])
        np.testing.assert_array_equal(tout[name].validity[:m].numpy(),
                                      np.asarray(jout[name].validity)[:m])
    if not with_nulls:
        k, v, p = (np.asarray(jb[c].data) for c in ("k", "v", "price"))
        live = np.flatnonzero(p < 50.0)
        want = live[np.lexsort((v[live], k[live]))]
        np.testing.assert_array_equal(tout["v"].data[:m].numpy(), v[want])
        np.testing.assert_array_equal(tout["k"].data[:m].numpy(), k[want])


@pytest.mark.parametrize("engine", ["sort", "kernel"])
def test_q6_plan_on_the_string_batch(_fresh, engine):
    """q6_plan over q6str: a string key routes to the general group_by
    on both engines; equal to the reference's plan, to the port's
    q6str_step and to the numpy oracle."""
    _fresh("groupby_engine", "sort")
    tconfig.set("groupby_engine", engine)
    n = 1500
    jb = ge._q6str_batch(n)
    jr, jng = jplan.execute(jq.q6_plan(), {"batch": jb})
    tb = TP.q6str_batch(n, device="cpu")
    tr, tng = tplan.execute(tq.q6_plan(), {"batch": tb})
    assert_groups_match(jr, jng, tr, tng, floats=("avg_price",))
    sr, sng = TP.q6str_step(tb)
    assert TP.result_groups(tr, tng, "k").keys() == \
        TP.result_groups(sr, sng, "k").keys()
    kidx, _, v, price = TP.q6str_arrays(n)
    keys, sums, cnts, _ = TP.q6str_oracle(kidx, v, price)
    got = TP.result_groups(tr, tng, "k")
    assert list(got) == keys
    assert [got[k]["sum_v"] for k in keys] == [int(x) for x in sums]
    assert [got[k]["cnt"] for k in keys] == [int(x) for x in cnts]
