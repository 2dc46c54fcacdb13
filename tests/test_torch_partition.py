"""PyTorch port: Spark Murmur3_32, partition ids and the local regroup,
bit-identical to the JAX package for partition ids in range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import hashing as JHash
from spark_rapids_jni_tpu.parallel import partition as JP
from spark_rapids_jni_tpu.relational import keys as JK

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_jni_tpu_torch.ops import hashing as THash
from spark_rapids_jni_tpu_torch.parallel import partition as TP
from spark_rapids_jni_tpu_torch.relational import keys as TK

from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _pair(vals, valid, jt, tt):
    return (JColumn(jnp.asarray(vals), jnp.asarray(valid), jt),
            TColumn(torch.from_numpy(np.array(vals)),
                    torch.from_numpy(np.array(valid)), tt))


def _cols(rng, n=2000):
    i = rng.integers(-2**31, 2**31, n).astype(np.int32)
    i[:4] = [0, -1, 2**31 - 1, -2**31]
    li = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    li[:4] = [0, -1, 2**63 - 1, -2**63]
    d = rng.integers(-40000, 40000, n).astype(np.int32)
    return [_pair(i, rng.random(n) > 0.1, JT.INT32, TT.INT32),
            _pair(li, rng.random(n) > 0.1, JT.INT64, TT.INT64),
            _pair(d, rng.random(n) > 0.1, JT.DATE, TT.DATE)]


@pytest.mark.parametrize("which", [[0], [1], [2], [0, 1, 2]])
def test_murmur3_bit_identical(which):
    cols = _cols(np.random.default_rng(0))
    j = JHash.murmur_hash3_32([cols[w][0] for w in which], seed=42)
    t = THash.murmur_hash3_32([cols[w][1] for w in which], seed=42)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert t.data.dtype == torch.int32


def test_murmur3_known_value():
    # Spark: hash(0 :: int) with seed 42 == 933211791
    t = THash.murmur_hash3_32([TColumn(torch.zeros(1, dtype=torch.int32),
                                       torch.ones(1, dtype=torch.bool),
                                       TT.INT32)])
    assert t.data.item() == 933211791


@pytest.mark.parametrize("P", [1, 8, 200])
def test_spark_partition_id(P):
    rng = np.random.default_rng(1)
    cols = _cols(rng)
    live = rng.random(2000) > 0.2
    j = JP.spark_partition_id([c[0] for c in cols[:2]], P,
                              jnp.asarray(live))
    t = TP.spark_partition_id([c[1] for c in cols[:2]], P,
                              torch.from_numpy(live))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("engine", ["sort", "scatter"])
def test_regroup_order_in_range(engine):
    rng = np.random.default_rng(2)
    pid = rng.integers(0, 9, 3000).astype(np.int32)
    j = JP.regroup_order(jnp.asarray(pid), 9, engine=engine)
    t = TP.regroup_order(torch.from_numpy(pid), 9)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_regroup_order_with_secondary_words():
    rng = np.random.default_rng(3)
    n = 1000
    pid = rng.integers(0, 9, n).astype(np.int32)
    seg = rng.integers(0, 10, n).astype(np.int32)
    jc, tc = _pair(seg, rng.random(n) > 0.1, JT.INT32, TT.INT32)
    jsec = JK.batch_radix_keys([jc], equality=True, nulls_first=True)
    tsec = TK.batch_radix_keys([tc], equality=True, nulls_first=True)
    j = JP.regroup_order(jnp.asarray(pid), 9, secondary=jsec)
    t = TP.regroup_order(torch.from_numpy(pid), 9, secondary=tsec)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bad", [-1, 9])
def test_regroup_order_rejects_out_of_range(bad):
    """The reference's counting engine is no bijection for pids outside
    [0, num_slots); the port refuses them."""
    pid = torch.tensor([0, 3, bad, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="partition ids"):
        TP.regroup_order(pid, 9)
