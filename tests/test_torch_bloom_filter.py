"""PyTorch port: ``ops/bloom_filter.py`` (Spark ``BloomFilterImpl``)
against the JAX package, bit for bit, and against the reference test's
pure-Python Spark oracle.

Seeded longs (nulls, 0, -1, the int64 extremes) build filters in both
packages at the reference's shapes and at Spark's runtime-filter size
(131 072 longs, 6 hashes); the filters' bit lanes, their serialized
bytes and the probes of other longs must be identical.  Merge,
incremental puts, the round trip through bytes, the errors and the
device defaults run on the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import bloom_filter as JB

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import bloom_filter as TB

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from tests.test_bloom_filter import oracle_serialized

SHAPES = [(3, 4), (5, 7), (1, 1), (6, 131072)]


def _longs(seed, n=400):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.integers(-(2**62), 2**62, n),
                           [0, -1, 2**63 - 1, -2**63]]).astype(np.int64)
    valid = rng.random(vals.shape[0]) > 0.1
    return vals, valid


def _cols(vals, valid):
    return (JColumn(jnp.asarray(vals), jnp.asarray(valid), JT.INT64),
            Column(torch.from_numpy(vals), torch.from_numpy(valid),
                   TT.INT64))


def _pylist(vals, valid):
    return [int(v) if ok else None for v, ok in zip(vals, valid)]


@pytest.mark.parametrize("num_hashes,num_longs", SHAPES)
def test_build_bit_for_bit(num_hashes, num_longs):
    vals, valid = _longs(num_longs)
    jc, tc = _cols(vals, valid)
    ref = JB.bloom_filter_build(num_hashes, num_longs, jc)
    got = TB.bloom_filter_build(num_hashes, num_longs, tc)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    buf = TB.bloom_filter_serialize(got)
    assert buf == JB.bloom_filter_serialize(ref)
    if num_longs < 1000:
        assert buf == oracle_serialized(_pylist(vals, valid), num_hashes,
                                        num_longs)
    other, ovalid = _longs(num_longs + 1)
    jp, tp = _cols(other, ovalid)
    np.testing.assert_array_equal(
        TB.bloom_filter_probe(got, tp).data.numpy(),
        np.asarray(JB.bloom_filter_probe(ref, jp).data))


def test_probe_hits_misses_and_nulls():
    rng = np.random.default_rng(7)
    vals = rng.integers(-(2**40), 2**40, 100)
    col = Column(torch.from_numpy(vals), torch.ones(100, dtype=torch.bool),
                 TT.INT64)
    bf = TB.bloom_filter_build(3, 16, col)
    assert bool(TB.bloom_filter_probe(bf, col).data.all())
    others = torch.from_numpy(rng.integers(2**50, 2**55, 200))
    miss = TB.bloom_filter_probe(bf, Column(
        others, torch.ones(200, dtype=torch.bool), TT.INT64))
    assert int(miss.data.sum()) < 40  # false-positive rate sanity
    nulls = TB.bloom_filter_probe(bf, Column(
        torch.tensor([0, int(vals[0])]), torch.tensor([False, True]),
        TT.INT64))
    assert nulls.validity.tolist() == [False, True]
    assert nulls.data.tolist()[1] is True


def test_merge_equals_one_build():
    vals, valid = _longs(11)
    half = vals.shape[0] // 2
    cols = [Column(torch.from_numpy(v), torch.from_numpy(m), TT.INT64)
            for v, m in ((vals[:half], valid[:half]),
                         (vals[half:], valid[half:]))]
    merged = TB.bloom_filter_merge([TB.bloom_filter_build(3, 8, c)
                                    for c in cols])
    whole = TB.bloom_filter_build(3, 8, Column(
        torch.from_numpy(vals), torch.from_numpy(valid), TT.INT64))
    assert torch.equal(merged.bits, whole.bits)
    assert TB.bloom_filter_serialize(merged) == oracle_serialized(
        _pylist(vals, valid), 3, 8)


def test_incremental_put_and_round_trip():
    bf = TB.bloom_filter_create(3, 4, device="cpu")
    for part in ([1, 2, 3], [4, 5]):
        bf = TB.bloom_filter_put(bf, Column(
            torch.tensor(part), torch.ones(len(part), dtype=torch.bool),
            TT.INT64))
    buf = TB.bloom_filter_serialize(bf)
    assert buf == oracle_serialized([1, 2, 3, 4, 5], 3, 4)
    back = TB.bloom_filter_deserialize(buf, device="cpu")
    assert (back.num_hashes, back.num_longs) == (3, 4)
    assert back.bits.device.type == "cpu"
    assert TB.bloom_filter_serialize(back) == buf


def test_errors():
    with pytest.raises(ValueError):
        TB.bloom_filter_create(0, 4, device="cpu")
    with pytest.raises(ValueError):
        TB.bloom_filter_deserialize(b"\x00" * 8, device="cpu")
    with pytest.raises(ValueError):
        TB.bloom_filter_deserialize(bytes([0, 0, 0, 2]) + b"\x00" * 20,
                                    device="cpu")
    with pytest.raises(ValueError):
        TB.bloom_filter_merge([])
    with pytest.raises(ValueError):
        TB.bloom_filter_merge([TB.bloom_filter_create(3, 4, device="cpu"),
                               TB.bloom_filter_create(2, 4, device="cpu")])
    with pytest.raises(TypeError):
        TB.bloom_filter_build(3, 4, Column(torch.tensor([1], dtype=torch.int32),
                                           torch.tensor([True]), TT.INT32))


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.bloom_filter_create(3, 4)
