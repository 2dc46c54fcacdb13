"""PyTorch port: the multi-device layer against the JAX package's
``parallel`` on its 8-device CPU mesh.

Reference counterparts: ``spark_rapids_jni_tpu/parallel/shuffle.py``
(``exchange``, ``plan_capacity``) and ``parallel/distributed.py`` (the
distributed group-bys, joins, sorts and their 2-D forms), run as
``tests/test_parallel.py`` runs them: on ``data_mesh(8)`` and
``hierarchical_mesh(2, 4)`` of the virtual devices ``tests/conftest.py``
makes.  The same seeded numpy inputs go through the port on
``ShardMesh(8, device='cpu')`` (and ``HierMesh(2, 4)`` over it).  Shard d
of the port holds rows ``[d*R, (d+1)*R)`` of its global arrays, device d
of the reference the same rows of its own, so comparing the global
arrays compares every shard: validity bit for bit on every row, values
bit for bit on valid rows (floats within rel 1e-5, the f32x3 tolerance),
per-shard group counts and dropped counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu import parallel as J
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.parallel import distributed as JD
from spark_rapids_jni_tpu.parallel import shuffle as JS
from spark_rapids_jni_tpu.relational import AggSpec as JAgg

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch import parallel as TP
from spark_rapids_jni_tpu_torch.columnar.column import batch_to_numpy
from spark_rapids_jni_tpu_torch.parallel import distributed as TD
from spark_rapids_jni_tpu_torch.parallel.mesh import HierMesh, ShardMesh
from spark_rapids_jni_tpu_torch.relational.aggregate import AggSpec

import torch

from torch_parity import host_form, jdecimal, to_port, unscaled
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

P8 = 8
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset("shuffle_capacity_bucket")
    tconfig.reset()


@pytest.fixture
def meshes(eight_devices):
    return J.data_mesh(P8), ShardMesh(P8, device="cpu")


@pytest.fixture
def meshes2d(eight_devices):
    return (J.hierarchical_mesh(2, 4),
            HierMesh(2, 4, ShardMesh(P8, device="cpu")))


def _aggs(specs):
    return ([JAgg(*s) for s in specs], [AggSpec(*s) for s in specs])


def _ints(a, valid=None, t=JT.INT64):
    a = np.asarray(a)
    v = np.ones(a.shape, bool) if valid is None else np.asarray(valid)
    return JColumn(jnp.asarray(a), jnp.asarray(v), t)


def _batch(rng, n, keys=10, kinds=("int",)):
    """A seeded batch: ``k`` int64 keys with nulls, ``v`` int64, ``p``
    float64, and optionally ``s`` strings and ``d`` decimal(20,2)."""
    k = rng.integers(0, keys, n)
    kv = rng.random(n) > 0.1
    cols = {"k": _ints(k, kv), "v": _ints(rng.integers(-1000, 1000, n)),
            "p": JColumn(jnp.asarray(rng.random(n) * 100),
                         jnp.ones((n,), jnp.bool_), JT.FLOAT64)}
    if "str" in kinds:
        cols["s"] = JString.from_pylist(
            [None if not kv[i] else f"key-{k[i]:02d}" for i in range(n)],
            max_len=8)
    if "dec" in kinds:
        cols["d"] = jdecimal(unscaled(rng, n, 18), 20, 2)
    return JBatch(cols)


def _put(jb, mesh):
    return J.shard_batch(jb, mesh)


def _put_rows(x, jmesh, spec=("data",)):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(jmesh, PartitionSpec(*spec)))


def _put2d(jb, jmesh):
    spec = NamedSharding(jmesh, PartitionSpec(("dcn", "ici")))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, spec), jb)


def same_rows(jb, tb, floats=(), msg=""):
    """Global arrays: validity equal on every row, values on valid rows
    (floats within ``RTOL``)."""
    assert list(jb.names) == list(tb.names), msg
    th = batch_to_numpy(tb)
    for name, jc in zip(jb.names, jb.columns):
        jd, jv, _ = host_form(jc)
        td, tv = th[name]
        np.testing.assert_array_equal(tv, jv, err_msg=f"{msg} {name} valid")
        if isinstance(jd, tuple):
            for a, b, part in zip(td, jd, ("chars", "lengths")):
                np.testing.assert_array_equal(
                    a[jv], b[jv], err_msg=f"{msg} {name} {part}")
        elif name in floats:
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL,
                                       err_msg=f"{msg} {name}")
        else:
            np.testing.assert_array_equal(td[jv], jd[jv],
                                          err_msg=f"{msg} {name}")


def same_vec(t, j, msg=""):
    np.testing.assert_array_equal(torch.as_tensor(t).numpy(),
                                  np.asarray(j), err_msg=msg)


# ---------------------------------------------------------------------------
# exchange and plan_capacity
# ---------------------------------------------------------------------------

def _ref_exchange(jb, pid, jmesh, capacity):
    spec = PartitionSpec("data")

    @jax.jit
    @jax.shard_map(mesh=jmesh, in_specs=(spec, spec),
                   out_specs=(spec, spec, spec), check_vma=False)
    def run(b, p):
        out, occ, dropped = JS.exchange(b, p, "data", P8, capacity)
        return out, occ, dropped[None]

    return run(jb, pid)


@pytest.mark.parametrize("case", ["lossless", "overflow", "out_of_range"])
def test_exchange_matches_reference(meshes, case):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(1)
    n = P8 * 16
    jb = _batch(rng, n, kinds=("str", "dec"))
    pid = rng.integers(0, P8 + 1, n).astype(np.int32)
    capacity = None
    if case == "overflow":
        pid = np.where(rng.random(n) < 0.7, 3, pid).astype(np.int32)
        capacity = 2
    if case == "out_of_range":
        pid[::7] = -3
        pid[3::11] = P8 + 5
        capacity = 4
    jout, jocc, jdrop = _ref_exchange(_put(jb, jmesh),
                                      _put_rows(pid, jmesh), jmesh,
                                      capacity)
    tout, tocc, tdrop = TP.exchange(to_port(jb), torch.as_tensor(pid),
                                    tmesh, capacity)
    same_vec(tocc, jocc, "occupancy")
    same_vec(tdrop, jdrop, "dropped")
    assert int(np.asarray(jdrop).sum()) > 0 or case == "lossless"
    same_rows(jout, tout, msg=case)


def test_plan_capacity_matches_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(2)
    n = P8 * 32
    jb = _batch(rng, n)
    live = rng.random(n) > 0.2
    want = JD.plan_exchange_capacity(_put(jb, jmesh), ["k"], jmesh,
                                     row_valid=_put_rows(live, jmesh),
                                     bucket=4)
    got = TD.plan_exchange_capacity(to_port(jb), ["k"], tmesh,
                                    row_valid=torch.as_tensor(live),
                                    bucket=4)
    assert got == want

    pid = rng.integers(-2, P8 + 3, n).astype(np.int32)
    spec = PartitionSpec("data")

    @jax.jit
    @jax.shard_map(mesh=jmesh, in_specs=(spec,), out_specs=spec,
                   check_vma=False)
    def run(p):
        return JS.plan_capacity(p, "data", P8)[None]

    jmax = np.asarray(run(_put_rows(pid, jmesh)))
    assert (jmax == jmax[0]).all()
    assert int(TP.plan_capacity(torch.as_tensor(pid), tmesh)) == jmax[0]


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------

GB_SPECS = {
    "int": (["k"], [("sum", "v", "sv"), ("count", None, "c"),
                    ("mean", "p", "mp"), ("min", "v", "lo"),
                    ("max", "p", "hi")]),
    "str": (["s"], [("sum", "v", "sv"), ("count", "k", "ck")]),
    "dec": (["k"], [("sum", "d", "sd"), ("mean", "d", "md"),
                    ("count", None, "c")]),
}


@pytest.mark.parametrize("kind", sorted(GB_SPECS))
def test_group_by_service_path_matches_reference(meshes, kind):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(3)
    n = P8 * 32
    jb = _batch(rng, n, kinds=(kind,))
    live = rng.random(n) > 0.15
    keys, specs = GB_SPECS[kind]
    jaggs, taggs = _aggs(specs)
    jres, jng, jdrop = J.distributed_group_by(
        _put(jb, jmesh), keys, jaggs, jmesh,
        row_valid=_put_rows(live, jmesh))
    tres, tng, tdrop = TP.distributed_group_by(
        to_port(jb), keys, taggs, tmesh, row_valid=torch.as_tensor(live))
    same_vec(tng, jng, "num_groups")
    same_vec(tdrop, jdrop, "dropped")
    same_rows(jres, tres, floats=("mp", "hi"), msg=kind)


def test_group_by_fixed_grid_drops_like_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(4)
    n = P8 * 32
    jb = _batch(rng, n)
    jaggs, taggs = _aggs([("sum", "v", "sv"), ("count", None, "c")])
    jres, jng, jdrop = J.distributed_group_by(_put(jb, jmesh), ["k"], jaggs,
                                              jmesh, capacity=4)
    tres, tng, tdrop = TP.distributed_group_by(to_port(jb), ["k"], taggs,
                                               tmesh, capacity=4)
    assert int(np.asarray(jdrop).sum()) > 0
    same_vec(tdrop, jdrop, "dropped")
    same_vec(tng, jng, "num_groups")
    same_rows(jres, tres)


def test_domain_group_by_matches_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(5)
    n = P8 * 64
    jb = _batch(rng, n, keys=20, kinds=("dec",))
    live = rng.random(n) > 0.15
    jaggs, taggs = _aggs([("sum", "v", "sv"), ("count", None, "c"),
                          ("mean", "p", "mp"), ("sum", "d", "sd"),
                          ("count", "d", "cd")])
    jres, jng, jovf = J.distributed_group_by_domain(
        _put(jb, jmesh), "k", jaggs, 32, jmesh,
        row_valid=_put_rows(live, jmesh))
    tres, tng, tovf = TP.distributed_group_by_domain(
        to_port(jb), "k", taggs, 32, tmesh, row_valid=torch.as_tensor(live))
    assert bool(tovf) is bool(jovf) is False
    assert int(tng) == int(jng)
    same_rows(jres, tres, floats=("mp",))


def test_domain_group_by_overflow_flag(meshes):
    jmesh, tmesh = meshes
    keys = np.full(P8 * 8, 3)
    keys[-1] = 99  # only on the last shard
    jb = JBatch({"k": _ints(keys, t=JT.INT32)})
    jaggs, taggs = _aggs([("count", None, "c")])
    _, _, jovf = J.distributed_group_by_domain(_put(jb, jmesh), "k", jaggs,
                                               16, jmesh)
    _, _, tovf = TP.distributed_group_by_domain(to_port(jb), "k", taggs, 16,
                                                tmesh)
    assert bool(jovf) and bool(tovf)


def test_onehot_group_by_matches_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(6)
    n = P8 * 32
    k = rng.integers(0, 12, n).astype(np.int32)
    k[::29] = 40  # out of the domain: the overflow flag, per shard
    jb = JBatch({"k": _ints(k, rng.random(n) > 0.1, JT.INT32),
                 "v": _ints(rng.integers(-50, 50, n)),
                 "p": JColumn(jnp.asarray(rng.random(n)),
                              jnp.ones((n,), jnp.bool_), JT.FLOAT64)})
    jaggs, taggs = _aggs([("sum", "v", "sv"), ("count", None, "c"),
                          ("mean", "p", "mp")])
    jres, jng, jdrop, jovf = JD.distributed_group_by_onehot(
        _put(jb, jmesh), "k", jaggs, 16, jmesh)
    tres, tng, tdrop, tovf = TD.distributed_group_by_onehot(
        to_port(jb), "k", taggs, 16, tmesh)
    same_vec(tovf, jovf, "overflow")
    same_vec(tng, jng, "num_groups")
    same_vec(tdrop, jdrop, "dropped")
    same_rows(jres, tres, floats=("mp",))


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _join_sides(rng, n, nr):
    left = JBatch({"k": _ints(rng.integers(0, 40, n), rng.random(n) > 0.05,
                              JT.INT32),
                   "lv": _ints(np.arange(n))})
    rk = np.concatenate([np.arange(30), rng.integers(0, 30, nr - 30)])
    right = JBatch({"k": _ints(rk, rng.random(nr) > 0.05, JT.INT32),
                    "rv": _ints(rng.integers(0, 100, nr))})
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_hash_join_matches_reference(meshes, how):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(7)
    left, right = _join_sides(rng, P8 * 32, P8 * 8)
    jres, jcnt, jdrop = J.distributed_hash_join(
        _put(left, jmesh), _put(right, jmesh), ["k"], ["k"], how, jmesh)
    tres, tcnt, tdrop = TP.distributed_hash_join(
        to_port(left), to_port(right), ["k"], ["k"], how, tmesh)
    same_vec(tcnt, jcnt, "counts")
    same_vec(tdrop, jdrop, "dropped")
    same_rows(jres, tres, msg=how)


def test_hash_join_fixed_grid_matches_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(8)
    left, right = _join_sides(rng, P8 * 32, P8 * 8)
    jres, jcnt, jdrop = J.distributed_hash_join(
        _put(left, jmesh), _put(right, jmesh), ["k"], ["k"], "inner", jmesh,
        capacity=8)
    tres, tcnt, tdrop = TP.distributed_hash_join(
        to_port(left), to_port(right), ["k"], ["k"], "inner", tmesh,
        capacity=8)
    same_vec(tcnt, jcnt, "counts")
    same_vec(tdrop, jdrop, "dropped")
    same_rows(jres, tres)


@pytest.mark.parametrize("how,dense", [("inner", 32), ("inner", None),
                                       ("left", 32), ("semi", 32),
                                       ("anti", None)])
def test_broadcast_join_matches_reference(meshes, how, dense):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(9)
    n = P8 * 16
    fact = JBatch({"k": _ints(rng.integers(0, 40, n), rng.random(n) > 0.05,
                              JT.INT32),
                   "lv": _ints(np.arange(n))})
    dim = JBatch({"k": _ints(np.arange(32), t=JT.INT32),
                  "rv": _ints(np.arange(32) * 100)})
    jres, jcnt = J.distributed_broadcast_join(
        _put(fact, jmesh), dim, ["k"], ["k"], how, jmesh,
        dense_domain=dense)
    tres, tcnt = TP.distributed_broadcast_join(
        to_port(fact), to_port(dim), ["k"], ["k"], how, tmesh,
        dense_domain=dense)
    same_vec(tcnt, jcnt, "counts")
    same_rows(jres, tres, msg=how)


def test_broadcast_join_rejects_build_side_outer(meshes):
    _, tmesh = meshes
    b = to_port(JBatch({"k": _ints(np.arange(8), t=JT.INT32)}))
    for how in ("right", "full"):
        with pytest.raises(ValueError, match="broadcast"):
            TP.distributed_broadcast_join(b, b, ["k"], ["k"], how, tmesh)
    with pytest.raises(ValueError, match="mismatch"):
        TP.distributed_broadcast_join(b, b, ["k"], ["k", "x"], "inner",
                                      tmesh)
    with pytest.raises(ValueError, match="right"):
        TP.distributed_broadcast_join(b, None, ["k"], ["k"], "inner", tmesh)
    h = TP.broadcast_build_handle(b)  # ported: a spill-store handle
    assert h.tier == "device" and h.name == "broadcast-build"
    h.close()


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def test_sort_matches_reference(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(10)
    n = P8 * 301  # past 1024 rows: a strided sample (stride 2)
    jb = _batch(rng, n, keys=1000, kinds=("str",))
    jsplit = JD._sample_splitters(_put(jb, jmesh), ["k", "v"], P8)
    tsplit = TD._sample_splitters(to_port(jb), ["k", "v"], tmesh)
    same_vec(tsplit, np.asarray(jsplit).astype(np.int64), "splitters")
    jres, jocc, jdrop = J.distributed_sort(_put(jb, jmesh), ["k", "v"],
                                           jmesh)
    tres, tocc, tdrop = TP.distributed_sort(to_port(jb), ["k", "v"], tmesh)
    same_vec(tocc, jocc, "occupancy")
    same_vec(tdrop, jdrop, "dropped")
    same_rows(jres, tres)


# ---------------------------------------------------------------------------
# the two-level mesh
# ---------------------------------------------------------------------------

def test_group_by_2d_matches_reference(meshes2d):
    jmesh, tmesh = meshes2d
    rng = np.random.default_rng(11)
    n = P8 * 32
    k = np.where(rng.random(n) < 0.7, 3, rng.integers(0, 40, n))
    jb = JBatch({"k": _ints(k.astype(np.int32), t=JT.INT32),
                 "v": _ints(rng.integers(-1000, 1000, n))})
    jaggs, taggs = _aggs([("sum", "v", "s"), ("count", None, "c")])
    jres, jng, jdrop = J.distributed_group_by_2d(_put2d(jb, jmesh), ["k"],
                                                 jaggs, jmesh)
    tres, tng, tdrop = TP.distributed_group_by_2d(to_port(jb), ["k"], taggs,
                                                  tmesh)
    same_vec(tng, np.asarray(jng).reshape(-1), "num_groups")
    same_vec(tdrop, np.asarray(jdrop).reshape(-1), "dropped")
    same_rows(jres, tres)


def test_hash_join_2d_matches_reference(meshes2d):
    jmesh, tmesh = meshes2d
    rng = np.random.default_rng(12)
    left, right = _join_sides(rng, P8 * 32, P8 * 8)
    jres, jcnt, jdrop = J.distributed_hash_join_2d(
        _put2d(left, jmesh), _put2d(right, jmesh), ["k"], ["k"], "inner",
        jmesh)
    tres, tcnt, tdrop = TP.distributed_hash_join_2d(
        to_port(left), to_port(right), ["k"], ["k"], "inner", tmesh)
    same_vec(tcnt, np.asarray(jcnt).reshape(-1), "counts")
    same_vec(tdrop, np.asarray(jdrop).reshape(P8, 2), "dropped")
    same_rows(jres, tres)


def test_sort_2d_matches_reference(meshes2d):
    jmesh, tmesh = meshes2d
    rng = np.random.default_rng(13)
    n = P8 * 64
    jb = JBatch({"k": _ints(rng.integers(-(10 ** 6), 10 ** 6, n))})
    jres, jocc, jdrop = J.distributed_sort_2d(_put2d(jb, jmesh), ["k"],
                                              jmesh)
    tres, tocc, tdrop = TP.distributed_sort_2d(to_port(jb), ["k"], tmesh)
    same_vec(tocc, jocc, "occupancy")
    same_vec(tdrop, np.asarray(jdrop).reshape(-1), "dropped")
    same_rows(jres, tres)


def test_exchange_hierarchical_reserved_name(meshes2d):
    _, tmesh = meshes2d
    b = to_port(JBatch({"__pid__": _ints(np.arange(P8), t=JT.INT32)}))
    with pytest.raises(ValueError, match="reserved"):
        TP.exchange_hierarchical(b, torch.zeros(P8, dtype=torch.int32),
                                 tmesh)


def test_plan_hierarchical_matches_reference():
    from spark_rapids_jni_tpu.shuffle import planner as JPlanner

    from spark_rapids_jni_tpu_torch.shuffle import planner

    rng = np.random.default_rng(14)
    for H, D in ((2, 4), (4, 2), (1, 8)):
        c = rng.integers(0, 300, (H * D, H * D))
        c[0, 5] = 4000
        for bucket in (None, 16):
            assert planner.plan_hierarchical(c, H, D, bucket) == \
                planner.HierarchicalPlan(
                    *dataclasses_astuple(JPlanner.plan_hierarchical(
                        c, H, D, bucket)))


def dataclasses_astuple(x):
    import dataclasses

    return dataclasses.astuple(x)


def test_exports_cover_the_reference():
    assert set(J.__all__) <= set(TP.__all__)
    for name in TP.__all__:
        assert callable(getattr(TP, name)), name


# ---------------------------------------------------------------------------
# the dry run and q95 over the mesh
# ---------------------------------------------------------------------------

def test_dryrun_multichip_matches_reference(eight_devices, monkeypatch,
                                            capsys):
    import re

    import __graft_entry__ as ge

    from spark_rapids_jni_tpu_torch import pipelines as PL

    monkeypatch.setenv("SRJ_DRYRUN_ROWS", "32")
    ge.dryrun_multichip(P8)
    ref = [ln.strip() for ln in capsys.readouterr().out.splitlines()
           if ln.strip()]
    lines = []
    got = PL.dryrun_multichip(P8, rows_per_device=32,
                              mesh=ShardMesh(P8, device="cpu"),
                              log=lines.append)
    assert [ln.strip() for ln in lines] == ref  # the same figures
    m = re.search(r"(\d+) groups .* join count=(\d+)", ref[-1])
    assert (got["groups"], got["join_count"]) == (int(m[1]), int(m[2]))
    assert got["rows"] == got["sorted_rows"] == P8 * 32


def test_q95_distributed_matches_oracle():
    from spark_rapids_jni_tpu_torch import pipelines as PL

    n = 1 << 12
    arrays = PL.q95_arrays(n)
    fact, dim1, dim2 = PL.q95_batches(n, device="cpu")
    mesh = ShardMesh(P8, device="cpu")
    out = PL.q95_distributed(fact, dim1, dim2, mesh)
    orders, net = PL.q95_oracle(arrays)
    for name, (o, v) in PL.q95_distributed_groups(out, mesh).items():
        np.testing.assert_array_equal(o, orders, err_msg=name)
        np.testing.assert_array_equal(v, net.astype(np.int64), err_msg=name)
    assert not bool(out["domain"][2])
