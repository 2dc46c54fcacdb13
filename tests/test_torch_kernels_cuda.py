"""PyTorch port: each CUDA kernel against its plain PyTorch version on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one; the
CPU tests in the other ``test_torch_*`` files hold the plain versions
against the JAX reference.  This file imports no JAX, so it also runs on a
GPU machine without JAX (``tests/conftest.py`` imports it, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Ints, owners, slots and found flags must be bit-identical; float sums
agree within rel 1e-5 of the sum of |x| (the reference's f32x3 tolerance;
the kernel's block partials round in f32).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import kernels as KER
from spark_rapids_jni_tpu_torch.relational import hashtable as H
from spark_rapids_jni_tpu_torch.relational import keys as RK

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(their plain versions run in the other test_torch_* "
                    "files)")
    return torch.device("cuda")


def _words(keys, dev, live=None):
    k = torch.as_tensor(np.asarray(keys, np.int64), device=dev)
    v = (torch.ones(k.shape[0], dtype=torch.bool, device=dev) if live is None
         else torch.as_tensor(np.asarray(live, bool), device=dev))
    return RK.batch_radix_keys([Column(k, v, TT.INT64)], equality=True,
                               nulls_first=True), v


def _same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("domain,mi,mf", [(101, 11, 3), (11, 10, 0),
                                          (5000, 11, 3), (3, 0, 2)])
def test_onehot_groupby_matches_plain(dev, domain, mi, mf):
    g = torch.Generator().manual_seed(domain)
    n = 1 << 20
    b = torch.randint(-1, domain, (n,), generator=g, dtype=torch.int32)
    pi = torch.randint(-128, 128, (n, mi), generator=g, dtype=torch.int8)
    pf = (torch.rand((n, mf), generator=g) - 0.5) * 200
    b, pi, pf = b.to(dev), pi.to(dev), pf.to(dev)
    KER.reset_launches()
    oi, of = KER.onehot_groupby_parts(b, pi, pf, domain)
    assert KER.launches["onehot_groupby"] == 1
    ri, rf = KER.onehot_groupby_parts_plain(b, pi, pf, domain)
    assert torch.equal(oi, ri)
    _, rabs = KER.onehot_groupby_parts_plain(b, pi, pf.abs(), domain)
    assert ((of - rf).abs() <= RTOL * rabs).all()


def test_onehot_groupby_rejects_what_it_cannot_take(dev):
    b = torch.zeros(8, dtype=torch.int32, device=dev)
    pi = torch.zeros((8, 4), dtype=torch.int8, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        KER.onehot_groupby_parts(b, pi, torch.zeros((8, 0), device=dev), 2)
    with pytest.raises(ValueError, match="several devices"):
        KER.onehot_groupby_parts(b, pi.contiguous().cpu(),
                                 torch.zeros((8, 0), device=dev), 2)


@pytest.mark.parametrize("case", ["zipf", "distinct", "overflow", "dead",
                                  "truncated", "empty"])
def test_slot_table_build_matches_plain(dev, case):
    rng = np.random.default_rng(1)
    S, mr, live = 1 << 16, None, None
    if case == "zipf":
        keys = np.clip(rng.zipf(1.3, 200_000), 0, 1 << 20)
    elif case == "distinct":
        keys = rng.permutation(1 << 15)
    elif case == "overflow":
        keys, S = rng.permutation(64), 8
    elif case == "dead":
        keys = rng.integers(0, 1000, 50_000)
        live = rng.random(50_000) > 0.3
    elif case == "truncated":
        keys, S, mr = rng.integers(0, 5000, 50_000), 8192, 3
    else:
        keys = np.zeros(0, np.int64)
    words, lv = _words(keys, dev, live)
    got = KER.slot_table_build(words, lv, S, mr)
    ref = KER.slot_table_build_plain(words, lv, S, S if mr is None else mr)
    _same(got, ref)
    if case == "overflow":
        assert bool(got[2])


def test_slot_table_probe_matches_plain(dev):
    rng = np.random.default_rng(2)
    keys = np.clip(rng.zipf(1.3, 100_000), 0, 1 << 20)
    words, lv = _words(keys, dev)
    S = 1 << 18
    owner = KER.slot_table_build(words, lv, S)[0]
    probe = np.concatenate([keys[:20_000], rng.integers(-9_999, 0, 20_000)])
    plive = rng.random(40_000) > 0.1
    pw, pl = _words(probe, dev, plive)
    cb = H.chain_bound(owner, len(keys))
    for rounds in (None, cb, 1):
        got = KER.slot_table_probe(owner, words, pw, pl, rounds)
        ref = KER.slot_table_probe_plain(owner, words, pw, pl,
                                         S if rounds is None else rounds)
        _same(got, ref)
    found = KER.slot_table_probe(owner, words, pw, pl, cb)[0].cpu().numpy()
    assert found[:20_000][plive[:20_000]].all()
    assert not found[20_000:].any() and not found[~plive].any()


def test_slot_table_probe_empty_build_and_probe_sides(dev):
    words, lv = _words(np.zeros(0, np.int64), dev)
    owner = KER.slot_table_build(words, lv, 16)[0]
    pw, pl = _words(np.arange(5), dev)
    found, slot = KER.slot_table_probe(owner, words, pw, pl)
    assert not found.any() and (slot == 16).all()
    pw, pl = _words(np.zeros(0, np.int64), dev)
    found, slot = KER.slot_table_probe(owner, words, pw, pl)
    assert found.shape == (0,) and slot.shape == (0,)
