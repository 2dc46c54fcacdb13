"""PyTorch port: ``ops/zorder.py`` (``interleave_bits``,
``hilbert_index``) against the JAX package, bit for bit, and against the
reference test's pure-Python oracles.

Seeded columns of every fixed-width type (random bit patterns, extremes,
nulls) interleave in both packages; int32 points of 1-32 bits in 1-4
dimensions take their Hilbert index in both.  The oracles and the
errors run on the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import zorder as JZ

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import zorder as TZ

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from tests.test_zorder import oracle_hilbert, oracle_interleave

N = 300
TYPES = {"boolean": np.bool_, "int8": np.int8, "int16": np.int16,
         "int32": np.int32, "date": np.int32, "int64": np.int64,
         "timestamp": np.int64, "float32": np.float32,
         "float64": np.float64}


def _column(rng, kind):
    np_t = TYPES[kind]
    if kind == "boolean":
        v = rng.random(N) < 0.5
    elif kind == "float32":
        v = rng.integers(0, 2**32, N, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    elif kind == "float64":
        v = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64).view(
            np.float64)
    else:
        info = np.iinfo(np_t)
        v = rng.integers(info.min, info.max, N, endpoint=True).astype(np_t)
    return v, rng.random(N) > 0.1


def _pair(v, valid, kind):
    jt, tt = getattr(JT, kind.upper()), getattr(TT, kind.upper())
    return (JColumn(jnp.asarray(v), jnp.asarray(valid), jt),
            Column(torch.from_numpy(v), torch.from_numpy(valid), tt))


@pytest.mark.parametrize("kind,C", [("int32", 3), ("int8", 2), ("int16", 3),
                                    ("int64", 1), ("timestamp", 2),
                                    ("date", 2), ("float32", 2),
                                    ("float64", 2), ("boolean", 5)])
def test_interleave_bit_for_bit(kind, C):
    rng = np.random.default_rng(C * 7 + len(kind))
    cols = [_pair(*_column(rng, kind), kind) for _ in range(C)]
    ref = JZ.interleave_bits([j for j, _ in cols])
    got = TZ.interleave_bits([t for _, t in cols])
    np.testing.assert_array_equal(got.chars.numpy(), np.asarray(ref.chars))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert bool(got.validity.all())


@pytest.mark.parametrize("bits,C", [(10, 2), (10, 3), (1, 2), (32, 2),
                                    (21, 3), (16, 4), (3, 1)])
def test_hilbert_bit_for_bit(bits, C):
    rng = np.random.default_rng(bits * 5 + C)
    cols = [_pair(*_column(rng, "int32"), "int32") for _ in range(C)]
    ref = JZ.hilbert_index(bits, [j for j, _ in cols])
    got = TZ.hilbert_index(bits, [t for _, t in cols])
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))


def test_interleave_against_oracle():
    rng = np.random.default_rng(3)
    for kind, width, C in (("int32", 4, 2), ("int16", 2, 3),
                           ("int64", 8, 1)):
        cols = [_column(rng, kind) for _ in range(C)]
        got = TZ.interleave_bits([_pair(v, m, kind)[1] for v, m in cols])
        chars = got.chars.numpy()
        for i in range(N):
            row = [int(v[i]) if m[i] else 0 for v, m in cols]
            assert bytes(chars[i]) == oracle_interleave(row, width), i


def test_hilbert_against_oracle():
    rng = np.random.default_rng(4)
    for bits, C in ((10, 2), (10, 3), (3, 1), (16, 4)):
        pts = rng.integers(0, 1 << bits, (N, C)).astype(np.int32)
        valid = rng.random((N, C)) > 0.1
        out = TZ.hilbert_index(bits, [Column(
            torch.from_numpy(pts[:, j].copy()),
            torch.from_numpy(valid[:, j].copy()), TT.INT32)
            for j in range(C)]).data.tolist()
        for i in range(N):
            p = [int(pts[i, j]) if valid[i, j] else 0 for j in range(C)]
            # a 64-bit index fills the int64's sign bit
            assert out[i] % (1 << 64) == oracle_hilbert(p, bits), (i, p)


def test_anchors_and_errors():
    def ints(vals):
        return Column(torch.tensor(vals, dtype=torch.int32),
                      torch.ones(len(vals), dtype=torch.bool), TT.INT32)

    # 1-bit 2-D curve: (0,0)->0 (0,1)->1 (1,1)->2 (1,0)->3
    assert TZ.hilbert_index(1, [ints([0, 0, 1, 1]),
                                ints([0, 1, 1, 0])]).data.tolist() == \
        [0, 1, 2, 3]
    raw = TZ.interleave_bits([ints([-16777216]), ints([0])])
    assert bytes(raw.chars.numpy()[0]) == bytes([0xAA, 0xAA, 0, 0, 0, 0,
                                                 0, 0])
    with pytest.raises(ValueError):
        TZ.interleave_bits([])
    with pytest.raises(ValueError):
        TZ.interleave_bits([ints([1]), Column(torch.tensor([1]),
                                              torch.tensor([True]),
                                              TT.INT64)])
    with pytest.raises(ValueError):
        TZ.hilbert_index(0, [ints([1])])
    with pytest.raises(ValueError):
        TZ.hilbert_index(32, [ints([1])] * 3)
    with pytest.raises(ValueError):
        TZ.hilbert_index(4, [Column(torch.tensor([1]), torch.tensor([True]),
                                    TT.INT64)])
