"""PyTorch port: the multi-device layer on 4 ``torch.distributed`` gloo
ranks against the one-card ``ShardMesh(4)`` on the same inputs.

One spawn of 4 CPU ranks (:func:`parallel.launch.spawn`) runs every case
through :func:`parallel.drive.run_ops`; the test process runs the same
ops on ``ShardMesh(4, device='cpu')``.  Rank r's result must equal shard
r's bit for bit (replicated results: every rank's equals the mesh's).
The 2-D cases run on the 2 x 2 ``HierMesh`` over each.  A second spawn
shows that a rank stuck in a collective fails its call within the wall
limit instead of hanging the suite.
"""

import datetime
import os
import tempfile
import time

import numpy as np
import pytest
import torch.distributed as dist

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.parallel import drive, launch
from spark_rapids_jni_tpu_torch.parallel.drive import (MESH, Hier, Op,
                                                       Sharded, Whole)
from spark_rapids_jni_tpu_torch.parallel.mesh import ProcessMesh, ShardMesh
from spark_rapids_jni_tpu_torch.relational.aggregate import AggSpec

WORLD = 4
BODY = "spark_rapids_jni_tpu_torch.parallel.drive:run_ops"


def _cases():
    rng = np.random.default_rng(21)
    n = WORLD * 32
    ones = np.ones(n, bool)
    k = rng.integers(0, 12, n)
    kv = rng.random(n) > 0.1
    names = np.array([f"key-{i:02d}" for i in range(12)])
    chars = np.zeros((n, 8), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        if kv[i]:
            b = names[k[i]].encode()
            chars[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
    limbs = np.stack([rng.integers(0, 1 << 40, n).astype(np.uint64),
                      np.zeros(n, np.uint64)], 1)
    b = {"k": (k, kv, "int64"), "v": (rng.integers(-999, 999, n), ones,
                                      "int64"),
         "p": (rng.random(n) * 100, ones, "float64"),
         "s": ((chars, lens), kv, "string"),
         "d": (limbs, rng.random(n) > 0.05, "decimal(20,2)")}
    k32 = {"k": (k.astype(np.int32), kv, "int32"), "v": b["v"],
           "p": b["p"]}
    nr = WORLD * 8
    right = {"k": (np.concatenate([np.arange(12), rng.integers(0, 12,
                                                               nr - 12)]),
                   rng.random(nr) > 0.05, "int64"),
             "rv": (rng.integers(0, 100, nr), np.ones(nr, bool), "int64")}
    dim = {"k": (np.arange(10, dtype=np.int32), np.ones(10, bool),
                 "int32"),
           "rv": (np.arange(10) * 7, np.ones(10, bool), "int64")}
    pid = rng.integers(-2, WORLD + 3, n).astype(np.int32)
    # past 1024 rows the splitter sample is strided (stride 3 here) and a
    # rank's first sampled row is not its first row (770 % 3 != 0)
    nb = WORLD * 770
    big = {"k": (rng.integers(0, 5000, nb), rng.random(nb) > 0.1, "int64"),
           "v": (rng.integers(-999, 999, nb), np.ones(nb, bool), "int64")}
    live = rng.random(n) > 0.15
    aggs = [AggSpec("sum", "v", "sv"), AggSpec("count", None, "c"),
            AggSpec("mean", "p", "mp"), AggSpec("sum", "d", "sd"),
            AggSpec("max", "v", "hi")]
    dom = [AggSpec("sum", "v", "sv"), AggSpec("count", None, "c"),
           AggSpec("mean", "p", "mp"), AggSpec("sum", "d", "sd")]
    S = Sharded
    return [
        ("knob", Op("set_knob", ("shuffle_capacity_bucket", 4),
                    replicated=True)),
        ("exchange", Op("exchange", (S(b), S(pid), MESH, 3))),
        ("plan_capacity", Op("plan_capacity", (S(pid), MESH),
                             replicated=True)),
        ("service_keys", Op("service_exchange", (S(b), MESH),
                            {"key_names": ["s"], "round_rows": 2,
                             "row_valid": S(live)})),
        ("service_pid", Op("service_exchange", (S(b), MESH),
                           {"pid": S(pid)})),
        ("group_by", Op("distributed_group_by", (S(b), ["k"], aggs, MESH),
                        {"row_valid": S(live)})),
        ("group_by_str", Op("distributed_group_by",
                            (S(b), ["s"], aggs[:2], MESH))),
        ("group_by_grid", Op("distributed_group_by",
                             (S(b), ["k"], aggs[:2], MESH),
                             {"capacity": 4})),
        ("domain", Op("distributed_group_by_domain",
                      (S(k32), "k", dom[:3], 16, MESH),
                      {"row_valid": S(live)}, replicated=True)),
        ("domain_dec", Op("distributed_group_by_domain",
                          (S({**k32, "d": b["d"]}), "k", dom, 16, MESH),
                          replicated=True)),
        ("onehot", Op("distributed_group_by_onehot",
                      (S(k32), "k", dom[:3], 8, MESH))),
        ("hash_join", Op("distributed_hash_join",
                         (S(b), S(right), ["k"], ["k"], "inner", MESH))),
        ("hash_join_full", Op("distributed_hash_join",
                              (S(b), S(right), ["k"], ["k"], "full",
                               MESH))),
        ("broadcast_dense", Op("distributed_broadcast_join",
                               (S(k32), Whole(dim), ["k"], ["k"], "inner",
                                MESH), {"dense_domain": 10})),
        ("broadcast_semi", Op("distributed_broadcast_join",
                              (S(k32), Whole(dim), ["k"], ["k"], "semi",
                               MESH))),
        ("splitters", Op("sample_splitters", (S(big), ["k", "v"], MESH),
                         replicated=True)),
        ("sort", Op("distributed_sort", (S(big), ["k", "v"], MESH))),
        ("sort_str", Op("distributed_sort", (S(b), ["s", "v"], MESH))),
        ("group_by_2d", Op("distributed_group_by_2d",
                           (S(b), ["k"], aggs[:2], Hier(2, 2)))),
        ("hash_join_2d", Op("distributed_hash_join_2d",
                            (S(b), S(right), ["k"], ["k"], "inner",
                             Hier(2, 2)))),
        ("sort_2d", Op("distributed_sort_2d", (S(b), ["k"], Hier(2, 2)))),
        ("dryrun", Op("dryrun_multichip", (WORLD, 32, MESH, None),
                      replicated=True)),
    ]


CASES = _cases()


@pytest.fixture(scope="module")
def results():
    ops = [op for _, op in CASES]
    ranks = launch.spawn(WORLD, BODY, ops, backend="gloo", wall_s=240.0)
    try:
        shards = drive.run_ops(ShardMesh(WORLD, device="cpu"), ops)
    finally:
        tconfig.reset()
    return ranks, shards


def same(a, b, path):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_ranks_match_shard_mesh(results, i):
    ranks, shards = results
    name, op = CASES[i]
    for r in range(WORLD):
        if op.replicated:
            same(ranks[r][i], shards[i], f"{name} rank {r}")
        else:
            same(ranks[r][i], [shards[i][r]], f"{name} rank {r}")


def test_dryrun_on_ranks_reports_its_checks(results):
    ranks, _ = results
    i = [name for name, _ in CASES].index("dryrun")
    out = ranks[0][i]
    assert out["rows"] == WORLD * 32
    assert out["sorted_rows"] == WORLD * 32
    assert out["hier"] == "dcn-x-ici hierarchical shuffle OK"


def test_stuck_collective_fails_within_the_wall_limit():
    # rank 0 waits in an all-reduce rank 1 never joins
    payload = launch.per_rank([[Op("plan_capacity",
                                   (Sharded(np.zeros(4, np.int32)), MESH),
                                   replicated=True)], []])
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.spawn(2, BODY, payload, backend="gloo", wall_s=20.0,
                     pg_timeout_s=60.0)
    assert time.monotonic() - t0 < 45.0


@pytest.fixture
def one_rank_group():
    fd, path = tempfile.mkstemp(prefix="srj_pg1_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield ProcessMesh(device="cpu")
    finally:
        dist.destroy_process_group()
        if os.path.exists(path):
            os.unlink(path)


def test_one_rank_mesh_and_what_it_leaves_to_later(one_rank_group):
    from spark_rapids_jni_tpu_torch.parallel import data_mesh
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource, \
        ShuffleService

    mesh = one_rank_group
    assert (mesh.size, mesh.rank, mesh.local_shards) == (1, 0, 1)
    assert isinstance(data_mesh(device="cpu"), ProcessMesh)
    ops = [op for name, op in CASES
           if name in ("group_by", "hash_join", "sort", "domain")]
    ops = [Op(op.name, tuple(a for a in op.args), op.kwargs,
              op.replicated) for op in ops]
    same(drive.run_ops(mesh, ops),
         drive.run_ops(ShardMesh(1, device="cpu"), ops), "world 1")
    b = drive._place(CASES[1][1].args[0], mesh, {})
    with pytest.raises(NotImplementedError, match="item 11"):
        ShuffleService(mesh).exchange_stream(
            MorselSource.from_batch(b, ShardMesh(1, device="cpu"), 32),
            key_names=["k"])
