"""PyTorch port: ``ops/histogram.py`` (Spark ``percentile`` over
histograms) against the JAX package and against the expanded-array
definition.

Seeded batches of histograms (empty, all-null, null values, zero and
null frequencies, ties) of int64, float64, int32 and float32 values go
through ``create_histogram_if_valid`` and ``percentile_from_histogram``
in both packages at one shape.  The masked columns must be identical and
the percentiles bit-identical: the port's fixed-count halving search
picks the reference's elements and the interpolation runs the same
float64 operations in the same order (the tolerance the port is held to
would be a relative 1e-12; none is needed).  The definition's oracle, the
errors and the goldens run on the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import histogram as JH

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import histogram as TH

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from tests.test_histogram import oracle_percentile

PCTS = [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0]
H = 300
KINDS = ["int64", "float64", "int32", "float32"]


def _batch(kind, seed=81):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 12, H)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(offsets[-1])
    if kind.startswith("int"):
        vals = rng.integers(-50, 50, n).astype(kind)
    else:
        vals = (rng.normal(size=n) * 100).astype(kind)
    vvalid = rng.random(n) > 0.15
    freqs = rng.integers(0, 5, n).astype(np.int64)
    fvalid = rng.random(n) > 0.05
    return offsets, vals, vvalid, freqs, fvalid


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    kind = request.param
    offsets, vals, vvalid, freqs, fvalid = _batch(kind)
    jt, tt = getattr(JT, kind.upper()), getattr(TT, kind.upper())
    jv, jf = JH.create_histogram_if_valid(
        JColumn(jnp.asarray(vals), jnp.asarray(vvalid), jt),
        JColumn(jnp.asarray(freqs), jnp.asarray(fvalid), JT.INT64))
    jout, jok = JH.percentile_from_histogram(jv, jf, offsets, PCTS)
    tv, tf = TH.create_histogram_if_valid(
        Column(torch.from_numpy(vals), torch.from_numpy(vvalid), tt),
        Column(torch.from_numpy(freqs), torch.from_numpy(fvalid), TT.INT64))
    return dict(kind=kind, offsets=offsets, vals=vals, vvalid=vvalid,
                freqs=freqs, fvalid=fvalid, jv=jv, jf=jf, tv=tv, tf=tf,
                jout=np.asarray(jout), jok=np.asarray(jok))


def test_masked_columns_equal(case):
    for j, t in ((case["jv"], case["tv"]), (case["jf"], case["tf"])):
        np.testing.assert_array_equal(t.validity.numpy(),
                                      np.asarray(j.validity))
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_percentiles_bit_for_bit(case):
    out, ok = TH.percentile_from_histogram(case["tv"], case["tf"],
                                           case["offsets"], PCTS)
    assert out.dtype == torch.float64 and out.shape == (H, len(PCTS))
    np.testing.assert_array_equal(ok.numpy(), case["jok"])
    jo = case["jout"][case["jok"]]
    np.testing.assert_array_equal(out.numpy()[case["jok"]].view(np.int64),
                                  jo.view(np.int64))


def test_offsets_as_a_tensor(case):
    a = TH.percentile_from_histogram(case["tv"], case["tf"],
                                     case["offsets"], PCTS)
    b = TH.percentile_from_histogram(case["tv"], case["tf"],
                                     torch.from_numpy(case["offsets"]), PCTS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_against_expanded_definition(case):
    out, ok = TH.percentile_from_histogram(case["tv"], case["tf"],
                                           case["offsets"], PCTS)
    offs = case["offsets"]
    for h in range(H):
        pairs = []
        for i in range(offs[h], offs[h + 1]):
            f = int(case["freqs"][i]) if case["fvalid"][i] else 0
            if case["vvalid"][i] and f > 0:
                pairs.append((case["vals"][i].item(), f))
        for p_i, p in enumerate(PCTS):
            want = oracle_percentile(pairs, p)
            if want is None:
                assert not bool(ok[h])
            else:
                assert bool(ok[h])
                assert float(out[h, p_i]) == pytest.approx(want, rel=1e-12,
                                                           abs=1e-12)


def test_goldens_and_errors():
    v, f = TH.create_histogram_if_valid(
        Column(torch.tensor([1, 2, 3, 1, 5, 9]),
               torch.ones(6, dtype=torch.bool), TT.INT64),
        Column(torch.tensor([2, 1, 1, 0, 2, 2]),
               torch.ones(6, dtype=torch.bool), TT.INT64))
    out, ok = TH.percentile_from_histogram(v, f, [0, 3, 6], [0.0, 0.5, 1.0])
    # expanded: 1 1 2 3 -> median (pos 1.5) = 1.5; the zero freq drops 1
    assert out.tolist() == [[1.0, 1.5, 3.0], [5.0, 7.0, 9.0]]
    assert ok.tolist() == [True, True]
    with pytest.raises(ValueError, match="negative"):
        TH.create_histogram_if_valid(
            Column(torch.tensor([1]), torch.tensor([True]), TT.INT64),
            Column(torch.tensor([-1]), torch.tensor([True]), TT.INT64))
    with pytest.raises(TypeError):
        TH.create_histogram_if_valid(
            Column(torch.tensor([1]), torch.tensor([True]), TT.INT64),
            Column(torch.tensor([1], dtype=torch.int32),
                   torch.tensor([True]), TT.INT32))
    with pytest.raises(ValueError):
        TH.percentile_from_histogram(v, f, [0, 6], [1.5])
