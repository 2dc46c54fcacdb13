"""PyTorch port: q95's distributed operators on a ``ShardMesh`` of 8
shards on the card, each shard's slot-table and one-hot kernels
launching on their own.

Needs an NVIDIA GPU (marker ``cuda``) and skips without one.  Imports no
JAX, so it runs on a GPU machine without it (``tests/conftest.py``
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_parallel_cuda.py

Groups must equal the numpy oracle exactly; launch counts are per shard.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import pipelines as PL
from spark_rapids_jni_tpu_torch.ops import kernels as KER
from spark_rapids_jni_tpu_torch.parallel import (ShardMesh, distributed_sort,
                                                 shard_batch)

pytestmark = pytest.mark.cuda
N = 1 << 14
SHARDS = 8


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the distributed operators' "
                    "kernels (slot table, one-hot group-by) have no CPU "
                    "mode (tests/test_torch_parallel.py runs their plain "
                    "versions against the reference)")
    return ShardMesh(SHARDS)


def test_q95_operators_on_shards(mesh):
    arrays = PL.q95_arrays(N)
    fact, dim1, dim2 = PL.q95_batches(N)
    fact, dim1 = shard_batch(fact, mesh), shard_batch(dim1, mesh)
    KER.reset_launches()
    out = PL.q95_distributed(fact, dim1, dim2, mesh)
    torch.cuda.synchronize()
    counts = dict(KER.launches)
    orders, net = PL.q95_oracle(arrays)
    for name, (o, v) in PL.q95_distributed_groups(out, mesh).items():
        np.testing.assert_array_equal(o, orders, err_msg=name)
        np.testing.assert_array_equal(v, net.astype(np.int64), err_msg=name)
    assert counts["slot_table_records"] == SHARDS
    assert counts["slot_table_probe"] == SHARDS
    assert counts["slot_table_build"] == 2 * SHARDS  # join + group-by
    assert counts["onehot_groupby"] == SHARDS
    assert int(out["join1"][2].sum()) == 0


def test_sort_on_shards(mesh):
    fact, _, _ = PL.q95_batches(N)
    res, occ, dropped = distributed_sort(shard_batch(fact, mesh),
                                         ["k", "v"], mesh)
    assert int(dropped.sum()) == 0 and int(occ.sum()) == N
    k = res["k"].data[occ].cpu().numpy().astype(np.int64)
    v = res["v"].data[occ].cpu().numpy()
    key = k * 1000 + v
    assert (np.diff(key) >= 0).all()
    want = PL.q95_arrays(N)["fact"]
    assert sorted(key.tolist()) == sorted(
        (want["k"].astype(np.int64) * 1000 + want["v"]).tolist())
