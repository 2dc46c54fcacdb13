"""PyTorch port: the exchange on one card against the JAX package's
``ShuffleService`` on its 8-device CPU mesh.

Reference counterparts: ``spark_rapids_jni_tpu/shuffle/planner.py``
(``plan_rounds``, ``plan_stream_capacity``), ``shuffle/service.py``
(``ShuffleService.exchange`` and ``exchange_stream``), ``shuffle/
morsel.py`` (``MorselSource.from_batch``) and the streaming cases of
``tests/test_shuffle_service.py`` ``TestStreamingExchange``.  The port's
:class:`ShardMesh` of 8 row shards stands in for the 8 devices, so the
WHOLE global ``(batch, occupancy)`` arrays — delivered rows, padding slots
and their order — must be bit-identical to the reference's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.parallel import data_mesh, shard_batch
from spark_rapids_jni_tpu.shuffle import MorselSource as JMorselSource
from spark_rapids_jni_tpu.shuffle import ShuffleError as JShuffleError
from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JRegistry
from spark_rapids_jni_tpu.shuffle import ShuffleService as JService
from spark_rapids_jni_tpu.shuffle import planner as JPlanner

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import (Column,
                                                        ColumnBatch,
                                                        batch_from_numpy)
from spark_rapids_jni_tpu_torch.ops import kernels as KER
from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
from spark_rapids_jni_tpu_torch.shuffle import (MorselSource, ShuffleError,
                                                ShuffleRegistry,
                                                ShuffleService, planner)
from spark_rapids_jni_tpu_torch.shuffle.buffers import (batch_leaves,
                                                        tree_nbytes)

from torch_parity import jdecimal, to_port, unscaled
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

P8 = 8


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset("shuffle_capacity_bucket")
    jconfig.reset("shuffle_strict_pids")
    tconfig.reset()


@pytest.fixture
def small_buckets():
    """Capacity bucket small enough that modest tests go multi-round."""
    jconfig.set("shuffle_capacity_bucket", 16)
    tconfig.set("shuffle_capacity_bucket", 16)


def _kv(keys, vals, valid=None):
    k = np.asarray(keys, np.int64)
    v = np.asarray(vals, np.int64)
    ok = np.ones(len(k), bool) if valid is None else np.asarray(valid)
    jb = JBatch({"k": JColumn(jnp.asarray(k), jnp.asarray(ok), JT.INT64),
                 "v": JColumn(jnp.asarray(v), jnp.ones(len(v), jnp.bool_),
                              JT.INT64)})
    tb = batch_from_numpy({"k": (k, ok, "int64"),
                           "v": (v, np.ones(len(v), bool), "int64")},
                          device="cpu")
    return jb, tb


def _meshes(eight_devices):
    return data_mesh(P8), ShardMesh(P8, device="cpu")


def assert_same_result(jres, tres):
    """Whole global arrays bit-identical, plus the accounting."""
    np.testing.assert_array_equal(tres.occupancy.numpy(),
                                  np.asarray(jres.occupancy))
    for name in jres.batch.names:
        for part in ("data", "validity"):
            np.testing.assert_array_equal(
                getattr(tres.batch[name], part).numpy(),
                np.asarray(getattr(jres.batch[name], part)),
                err_msg=f"{name}.{part}")
    for f in ("rounds", "capacity", "rows_moved", "bytes_moved",
              "oob_rows", "streamed", "morsels", "rounds_overlapped"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.skew_ratio == pytest.approx(jres.skew_ratio)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_plan_rounds_matches_reference(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 400, (P8, P8))
    if seed % 2:
        c[rng.integers(0, P8), rng.integers(0, P8)] = 5000  # skew
    if seed == 4:
        c[:] = 0
    for kw in ({}, {"round_rows": 100, "bucket": 16},
               {"round_rows": 10, "bucket": 1, "max_rounds": 4}):
        got = planner.plan_rounds(c, **kw)
        want = JPlanner.plan_rounds(c, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.lossless


def test_plan_stream_capacity_matches_reference():
    for kw in ({}, {"round_rows": 100, "bucket": 16},
               {"round_rows": 3, "bucket": 8}):
        assert (planner.plan_stream_capacity(**kw)
                == JPlanner.plan_stream_capacity(**kw))
    with pytest.raises(ValueError):
        planner.plan_stream_capacity(round_rows=0)


# ---------------------------------------------------------------------------
# materialized exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["uniform", "all_to_one", "dead_rows"])
def test_exchange_matches_reference(eight_devices, small_buckets, case):
    jm, tm = _meshes(eight_devices)
    n = P8 * 128
    rng = np.random.default_rng(3)
    keys = (np.full(n, 7) if case == "all_to_one"
            else rng.integers(0, 1 << 20, n))
    valid = rng.random(n) > 0.25 if case == "dead_rows" else None
    jb, tb = _kv(keys, np.arange(n), valid)
    rv = None if valid is None else valid
    jres = JService(jm, registry=JRegistry()).exchange(
        shard_batch(jb, jm), key_names=["k"], round_rows=16,
        row_valid=None if rv is None else jax.device_put(
            jnp.asarray(rv), NamedSharding(jm, PartitionSpec("data"))))
    tres = ShuffleService(tm, registry=ShuffleRegistry()).exchange(
        tb, key_names=["k"], round_rows=16,
        row_valid=None if rv is None else torch.from_numpy(rv))
    assert tres.rounds >= 2
    assert_same_result(jres, tres)


@pytest.mark.parametrize("strict", [False, True])
def test_out_of_range_pids_both_strict_modes(eight_devices, strict):
    jm, tm = _meshes(eight_devices)
    n = P8 * 16
    vals = np.arange(n, dtype=np.int64)
    pid = (vals % P8).astype(np.int32)
    pid[::7] = -3
    pid[3::11] = P8 + 4
    jb, tb = _kv(vals, vals)
    jconfig.set("shuffle_strict_pids", strict)
    tconfig.set("shuffle_strict_pids", strict)
    jpid = jax.device_put(jnp.asarray(pid),
                          NamedSharding(jm, PartitionSpec("data")))
    if strict:
        with pytest.raises(JShuffleError):
            JService(jm, registry=JRegistry()).exchange(
                shard_batch(jb, jm), pid=jpid)
        with pytest.raises(ShuffleError, match="out-of-range"):
            ShuffleService(tm, registry=ShuffleRegistry()).exchange(
                tb, pid=torch.from_numpy(pid))
        return
    jres = JService(jm, registry=JRegistry()).exchange(shard_batch(jb, jm),
                                                       pid=jpid)
    tres = ShuffleService(tm, registry=ShuffleRegistry()).exchange(
        tb, pid=torch.from_numpy(pid))
    bad = int(((pid < 0) | (pid > P8)).sum())
    assert tres.oob_rows == jres.oob_rows == bad
    assert_same_result(jres, tres)


# ---------------------------------------------------------------------------
# streaming exchange (mirrors TestStreamingExchange)
# ---------------------------------------------------------------------------

def _stream_both(eight_devices, keys, vals, round_rows, morsel_rows,
                 extra=None):
    """Reference and port: materialized and streamed over the same rows.
    ``extra``: ``(at, valid_rows_per_shard)`` inserts an all-invalid
    morsel at position ``at`` of both streams."""
    jm, tm = _meshes(eight_devices)
    jb, tb = _kv(keys, vals)
    jb = shard_batch(jb, jm)
    jsvc = JService(jm, registry=JRegistry())
    tsvc = ShuffleService(tm, registry=ShuffleRegistry())
    jmat = jsvc.exchange(jb, key_names=["k"], round_rows=round_rows)
    tmat = tsvc.exchange(tb, key_names=["k"], round_rows=round_rows)
    assert_same_result(jmat, tmat)
    jmor = list(JMorselSource.from_batch(jb, jm, morsel_rows=morsel_rows))
    tmor = list(MorselSource.from_batch(tb, tm, morsel_rows=morsel_rows))
    if extra is not None:
        at, M = extra
        sh = NamedSharding(jm, PartitionSpec("data"))
        z = jax.device_put(jnp.zeros((P8 * M,), jnp.int64), sh)
        o = jax.device_put(jnp.ones((P8 * M,), jnp.bool_), sh)
        jempty = (JBatch({"k": JColumn(z, o, JT.INT64),
                          "v": JColumn(z, o, JT.INT64)}),
                  jax.device_put(jnp.zeros((P8 * M,), jnp.bool_), sh))
        tz = torch.zeros(P8 * M, dtype=torch.int64)
        to = torch.ones(P8 * M, dtype=torch.bool)
        tempty = (ColumnBatch({"k": Column(tz, to, tb["k"].dtype),
                               "v": Column(tz, to, tb["v"].dtype)}),
                  torch.zeros(P8 * M, dtype=torch.bool))
        jmor.insert(at, lambda: jempty)
        tmor.insert(at, lambda: tempty)
    jres = jsvc.exchange_stream(jmor, key_names=["k"], round_rows=round_rows)
    KER.reset_launches()
    tres = tsvc.exchange_stream(tmor, key_names=["k"], round_rows=round_rows)
    assert KER.launches["partition_scatter"] == 0  # CPU: plain version
    assert_same_result(jres, tres)
    return tmat, tres


def test_stream_uniform_multiround_overlaps(eight_devices, small_buckets):
    n = P8 * 512
    keys = np.random.default_rng(5).integers(0, 1 << 20, n)
    mat, res = _stream_both(eight_devices, keys, np.arange(n), 16, 64)
    assert res.streamed and res.morsels == 8
    assert res.rows_moved == n and res.rounds >= 2
    assert res.rounds_overlapped >= 2
    assert res.rounds == mat.rounds and res.capacity == mat.capacity
    assert res.scatters >= res.morsels


def test_stream_all_to_one_skew(eight_devices, small_buckets):
    n = P8 * 256
    mat, res = _stream_both(eight_devices, np.full(n, 7), np.arange(n),
                            64, 64)
    assert res.rows_moved == n and res.rounds >= 2
    assert res.rounds_overlapped == 0  # empty buckets never clear a round


def test_stream_zipf_empty_partitions_and_empty_morsel(eight_devices,
                                                       small_buckets):
    n = P8 * 128
    rng = np.random.default_rng(11)
    keys = (np.minimum(rng.zipf(1.5, n), 1 << 20) % 5).astype(np.int64)
    _, res = _stream_both(eight_devices, keys, np.arange(n), 32, 32,
                          extra=(2, 32))
    assert res.rows_moved == n
    assert res.morsels == 5  # the empty one still counts as mapped
    occ = res.occupancy.numpy().reshape(P8, -1)
    assert (occ.sum(axis=1) == 0).any()  # some shard receives nothing


def test_stream_padded_shards(eight_devices, small_buckets):
    """Shards that are not a whole number of morsels pad with invalid
    rows, which route nowhere."""
    n = P8 * 100
    keys = np.random.default_rng(2).integers(0, 50, n)
    _, res = _stream_both(eight_devices, keys, np.arange(n) * 3, 16, 64)
    assert res.rows_moved == n and res.morsels == 2


def test_snapshot_id_matches_reference(eight_devices):
    jm, tm = _meshes(eight_devices)
    n = P8 * 32
    rng = np.random.default_rng(4)
    valid = rng.random(n) > 0.2
    jb, tb = _kv(rng.integers(0, 99, n), np.arange(n), valid)
    jsrc = JMorselSource.from_batch(shard_batch(jb, jm), jm, morsel_rows=8)
    tsrc = MorselSource.from_batch(tb, tm, morsel_rows=8)
    assert tsrc.snapshot_id == jsrc.snapshot_id
    assert len(tsrc) == len(jsrc) == 4


def test_unported_options_raise(eight_devices):
    _, tm = _meshes(eight_devices)
    _, tb = _kv(np.arange(P8 * 4), np.arange(P8 * 4))
    svc = ShuffleService(tm, registry=ShuffleRegistry())
    # ctx= and store_key= are ported (tests/test_torch_spill.py and the
    # store cases below), and so are shuffle_compress='pack' and a
    # zone-map predicate: the packed exchange delivers the raw one's
    # rows, and a predicate over a column with no sidecar skips nothing
    raw = svc.exchange(tb, key_names=["k"])
    tconfig.set("shuffle_compress", "pack")
    packed = svc.exchange(tb, key_names=["k"])
    tconfig.reset("shuffle_compress")
    assert packed.compressed_bytes_saved > 0
    assert torch.equal(packed.occupancy, raw.occupancy)
    assert torch.equal(packed.batch["k"].data, raw.batch["k"].data)
    src = MorselSource.from_batch(tb, tm, predicate=("k", "<", 3))
    assert (len(src), src.blocks_skipped, src.blocks_scanned) == (1, 0, 0)
    with pytest.raises(ValueError, match="shuffle_compress"):
        tconfig.set("shuffle_compress", "zip")
        svc.exchange(tb, key_names=["k"])
    tconfig.reset("shuffle_compress")
    with pytest.raises(FileNotFoundError):
        MorselSource.from_parquet("x.parquet", tm)
    with pytest.raises(ValueError, match="at least one morsel"):
        svc.exchange_stream([], key_names=["k"])
    with pytest.raises(ValueError, match="divisible"):
        svc.exchange(batch_from_numpy(
            {"k": (np.arange(5), np.ones(5, bool), "int64")}, "cpu"),
            key_names=["k"])


# ---------------------------------------------------------------------------
# every column kind through the exchange
# ---------------------------------------------------------------------------

def _mixed_kinds(rng, n):
    """Int key, a 24-byte string column (10 % null), decimal(38,2) and
    decimal(7,2) columns: the leaves a shuffle of TPC-DS rows carries."""
    cats = [f"store-{i:03d}-{'q' * (i % 9)}" for i in range(40)]
    svals = [None if rng.random() < 0.1 else cats[i]
             for i in rng.integers(0, 40, n)]
    return JBatch({
        "k": JColumn(jnp.asarray(rng.integers(0, 1 << 20, n)),
                     jnp.asarray(rng.random(n) > 0.05), JT.INT64),
        "s": JString.from_pylist(svals, max_len=24),
        "d": jdecimal(unscaled(rng, n, 38, nulls=0.1), 38, 2),
        "p": jdecimal(unscaled(rng, n, 7, nulls=0.1), 7, 2)})


def assert_same_leaves(jres, tres):
    """Every leaf of the whole global batch bit-identical, plus the
    accounting."""
    np.testing.assert_array_equal(tres.occupancy.numpy(),
                                  np.asarray(jres.occupancy))
    jl = jax.tree_util.tree_leaves(jres.batch)
    tl = batch_leaves(tres.batch)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(
            np.ascontiguousarray(b.numpy()).view(np.uint8),
            np.ascontiguousarray(np.asarray(a)).view(np.uint8),
            err_msg=f"leaf {i}")
    for f in ("rounds", "capacity", "rows_moved", "bytes_moved",
              "oob_rows", "streamed", "morsels"):
        assert getattr(tres, f) == getattr(jres, f), f


@pytest.mark.parametrize("key", ["k", "s", "d"])
def test_strings_and_decimals_cross_the_exchange(eight_devices,
                                                 small_buckets, key):
    """Materialized and streamed exchanges of string and decimal columns,
    keyed by an int, a string or a decimal column, equal the reference's
    8-device exchanges leaf for leaf."""
    jm, tm = _meshes(eight_devices)
    n = P8 * 256
    rng = np.random.default_rng(70)
    jb = shard_batch(_mixed_kinds(rng, n), jm)
    tb = to_port(_mixed_kinds(np.random.default_rng(70), n))
    jsvc = JService(jm, registry=JRegistry())
    tsvc = ShuffleService(tm, registry=ShuffleRegistry())
    jres = jsvc.exchange(jb, key_names=[key], round_rows=16)
    tres = tsvc.exchange(tb, key_names=[key], round_rows=16)
    assert tres.rounds >= 2
    assert_same_leaves(jres, tres)
    jmor = JMorselSource.from_batch(jb, jm, morsel_rows=96)
    tmor = MorselSource.from_batch(tb, tm, morsel_rows=96)
    assert tmor.snapshot_id == jmor.snapshot_id
    KER.reset_launches()
    tst = tsvc.exchange_stream(tmor, key_names=[key], round_rows=16)
    jst = jsvc.exchange_stream(jmor, key_names=[key], round_rows=16)
    assert KER.launches["partition_scatter"] == 0  # CPU: plain version
    assert tst.morsels == 3
    assert_same_leaves(jst, tst)
    assert tree_nbytes(tb) == sum(
        np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(jb))


def test_morsel_source_slices_every_kind(eight_devices):
    _, tm = _meshes(eight_devices)
    n = P8 * 40
    tb = to_port(_mixed_kinds(np.random.default_rng(71), n))
    src = MorselSource.from_batch(tb, tm, morsel_rows=16)
    assert len(src) == 3  # 40 rows a shard: 16 + 16 + 8 and 8 padding
    parts = [m() for m in src]
    b0, _ = parts[0]
    assert b0["s"].chars.shape == (P8 * 16, 24)
    assert b0["d"].limbs.shape == (P8 * 16, 2)
    # concatenating each shard's valid rows gives the shard back in order
    rows = torch.cat([torch.cat([b["d"].limbs.reshape(P8, 16, 2)[s]
                                 [v.reshape(P8, 16)[s]] for b, v in parts])
                      for s in range(P8)])
    assert torch.equal(rows, tb["d"].limbs)
    chars = torch.cat([torch.cat([b["s"].chars.reshape(P8, 16, 24)[s]
                                  [v.reshape(P8, 16)[s]] for b, v in parts])
                       for s in range(P8)])
    assert torch.equal(chars, tb["s"].chars)


def test_batch_digest_matches_reference_for_every_kind():
    from spark_rapids_jni_tpu.columnar.column import ListColumn as JL
    from spark_rapids_jni_tpu.columnar.column import StructColumn as JSt
    from spark_rapids_jni_tpu.serve.data_plane import \
        batch_digest as j_digest

    from spark_rapids_jni_tpu_torch.shuffle.morsel import batch_digest

    rng = np.random.default_rng(72)
    n = 6
    base = _mixed_kinds(rng, n)
    jb = JBatch(dict(zip(base.names, base.columns),
                     l=JL.from_pylist([[1, 2], None, [], [3], [None], [4]],
                                      JT.INT64),
                     st=JSt.from_pylist([{"a": 1, "b": "x"}, None,
                                         {"a": None, "b": "yz"}, {"a": 4,
                                                                  "b": ""},
                                         {"a": 5, "b": None},
                                         {"a": 6, "b": "w"}],
                                        {"a": JT.INT32, "b": JT.STRING})))
    assert batch_digest(to_port(jb)) == j_digest(jb)
    for name in jb.names:
        one = JBatch({name: jb[name]})
        assert batch_digest(to_port(one)) == j_digest(one), name


def test_nested_columns_do_not_cross(eight_devices):
    from spark_rapids_jni_tpu.columnar.column import ListColumn as JL

    _, tm = _meshes(eight_devices)
    n = P8 * 2
    jb = JBatch({"k": JColumn(jnp.arange(n), jnp.ones((n,), jnp.bool_),
                              JT.INT64),
                 "l": JL.from_pylist([[i] for i in range(n)], JT.INT64)})
    tb = to_port(jb)
    svc = ShuffleService(tm, registry=ShuffleRegistry())
    # the reference's row gather has no nested branch either
    with pytest.raises(NotImplementedError, match="do not shard by row"):
        svc.exchange(tb, key_names=["k"])
    with pytest.raises(NotImplementedError, match="do not shard by row"):
        MorselSource.from_batch(tb, tm, morsel_rows=2)
    with pytest.raises(NotImplementedError, match="do not shard by row"):
        tree_nbytes(tb)


# ---------------------------------------------------------------------------
# transport faults (TestShuffleIOFaults) and the persistent store
# ---------------------------------------------------------------------------

IO_RULE = {"match": "shuffle_io_round", "fault": "shuffle_io"}


def _io_inputs():
    vals = np.arange(P8 * 8, dtype=np.int64)
    return vals, (vals % P8).astype(np.int32)


@pytest.fixture(scope="module")
def io_reference(eight_devices):
    """The reference's ``TestShuffleIOFaults`` exchange (64 rows over 8
    devices, pid = row % 8), once with one injected round fault and once
    with a fault on every round: its result (or error) and its
    ``io_failures``."""
    from spark_rapids_jni_tpu import faultinj as jfault

    jm = data_mesh(P8)
    vals, pid = _io_inputs()
    jb, _ = _kv(vals, vals)
    jpid = jax.device_put(jnp.asarray(pid),
                          NamedSharding(jm, PartitionSpec("data")))
    out = {}
    for name, extra in (("once", {"count": 1}), ("always", {})):
        reg = JRegistry()
        jfault.configure({"faults": [dict(IO_RULE, **extra)]})
        try:
            out[name] = JService(jm, registry=reg).exchange(
                shard_batch(jb, jm), pid=jpid)
        except jfault.ShuffleIOError as e:
            out[name] = e
        finally:
            jfault.configure({})
        out[name, "io"] = reg.metrics.snapshot()["io_failures"]
    return out


@pytest.mark.parametrize("fault", ["once", "always"])
def test_round_io_faults_match_reference(eight_devices, io_reference,
                                         fault):
    from spark_rapids_jni_tpu_torch import faultinj
    from spark_rapids_jni_tpu_torch.shuffle.service import _IO_RETRIES

    _, tm = _meshes(eight_devices)
    vals, pid = _io_inputs()
    _, tb = _kv(vals, vals)
    reg = ShuffleRegistry()
    rule = dict(IO_RULE, **({"count": 1} if fault == "once" else {}))
    with faultinj.scope({"faults": [rule]}):
        if fault == "always":
            with pytest.raises(faultinj.ShuffleIOError):
                ShuffleService(tm, registry=reg).exchange(
                    tb, pid=torch.from_numpy(pid))
            assert isinstance(io_reference[fault], OSError)
        else:
            tres = ShuffleService(tm, registry=reg).exchange(
                tb, pid=torch.from_numpy(pid))
            # the re-driven round delivers the reference's arrays
            assert_same_result(io_reference[fault], tres)
            occ = tres.occupancy
            assert sorted(tres.batch["v"].data[occ].tolist()) == \
                vals.tolist()
    want = 1 if fault == "once" else _IO_RETRIES + 1
    assert reg.metrics.snapshot()["io_failures"] == \
        io_reference[fault, "io"] == want


def test_store_exchange_adopts_the_map_like_reference(eight_devices,
                                                      tmp_path,
                                                      small_buckets):
    """A ``store_key`` exchange commits its map output and every round
    under the reference's shard names; a second run with a fresh
    registry adopts the map (the map step does not run) and delivers
    the same arrays as the reference's adopting run."""
    from spark_rapids_jni_tpu.shuffle import store as jstore

    from spark_rapids_jni_tpu_torch.shuffle import service as S
    from spark_rapids_jni_tpu_torch.shuffle import store as tstore

    jm, tm = _meshes(eight_devices)
    n = P8 * 256
    keys = np.random.default_rng(8).integers(0, 1 << 20, n)
    jb, tb = _kv(keys, np.arange(n))
    jb = shard_batch(jb, jm)
    jstore.install(str(tmp_path / "ref"), epoch=0)
    tstore.install(str(tmp_path / "port"), epoch=0)
    maps = []
    real_map = S._map_keys
    S._map_keys = lambda *a: maps.append(1) or real_map(*a)
    try:
        got = {}
        for run in range(2):
            jreg, treg = JRegistry(), ShuffleRegistry()
            jres = JService(jm, registry=jreg).exchange(
                jb, key_names=["k"], round_rows=16, store_key="q")
            tres = ShuffleService(tm, registry=treg).exchange(
                tb, key_names=["k"], round_rows=16, store_key="q")
            assert_same_result(jres, tres)
            got[run] = (treg.metrics.snapshot(), jreg.metrics.snapshot())
    finally:
        S._map_keys = real_map
        jstore.shutdown_store()
        tstore.shutdown_store()
    assert len(maps) == 1  # the second run adopted the map output
    for run, adopted in ((0, 0), (1, 1)):
        tsnap, jsnap = got[run]
        for k in ("adopted_shards", "lineage_rebuilds",
                  "recovered_partitions"):
            assert tsnap[k] == jsnap[k], (run, k)
        assert tsnap["adopted_shards"] == adopted
    assert sorted(os.listdir(tmp_path / "port" / "q")) == \
        sorted(os.listdir(tmp_path / "ref" / "q"))
    assert tres.rounds >= 2
