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
                                  "truncated", "empty", "hot100",
                                  "one_key", "join_shape"])
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
    elif case == "hot100":  # the q6 group-by build's hot spot
        keys, S = rng.integers(0, 100, 1 << 20), 4096
        live = rng.random(1 << 20) > 0.5
    elif case == "one_key":
        keys, S = np.full(1 << 20, 42), 4096
    elif case == "join_shape":  # distinct dim keys, load 1/2
        keys, S = rng.permutation(1 << 24)[:1 << 21], 1 << 22
    else:
        keys = np.zeros(0, np.int64)
    words, lv = _words(keys, dev, live)
    KER.reset_launches()
    got = KER.slot_table_build(words, lv, S, mr)
    assert KER.launches["slot_table_build"] == (1 if len(keys) else 0)
    ref = KER.slot_table_build_plain(words, lv, S, S if mr is None else mr)
    _same(got, ref)
    if case == "overflow":
        assert bool(got[2])


@pytest.mark.parametrize("S", [4096, 1 << 16])
def test_slot_table_build_every_round_bound(dev, S):
    """Both claim paths (shared-memory prop for small S, warp-aggregated
    global claims otherwise) at max_rounds 1, 2 and S, with enough key
    collisions that the early bounds overflow."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, S // 2, 1 << 18)
    words, lv = _words(keys, dev)
    for mr in (1, 2, S):
        got = KER.slot_table_build(words, lv, S, mr)
        ref = KER.slot_table_build_plain(words, lv, S, mr)
        _same(got, ref)
    assert bool(KER.slot_table_build(words, lv, S, 1)[2])


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


def _scatter_inputs(dev, S, P, C, M, rng, pad_tail=0, empty=False):
    """S shards' destination-major morsels with bases that straddle a
    round boundary; the last ``pad_tail`` rows of each shard are padding
    (beyond sum(cnts)); ``empty`` makes every row padding."""
    cnts = np.zeros((S, P), np.int64)
    for s in range(S):
        if not empty:
            d = np.sort(rng.integers(0, P, M - pad_tail))
            cnts[s] = np.bincount(d, minlength=P)
    base = rng.integers(C - 300, C + 50, (S, P))
    leaves = [rng.integers(0, 1 << 20, S * M).astype(np.int32),
              rng.integers(-(1 << 40), 1 << 40, S * M),
              rng.random(S * M) < 0.5,
              rng.random(S * M)]
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (to(cnts.astype(np.int32)), to(base.astype(np.int32)),
            [to(a) for a in leaves])


@pytest.mark.parametrize("case", ["stream_shape", "padding_tail", "empty",
                                  "wide_leaf"])
def test_partition_scatter_matches_plain(dev, case):
    rng = np.random.default_rng(4)
    S = P = 8
    C, M = 1 << 16, 4096
    cnts, base, mleaves = _scatter_inputs(
        dev, S, P, C, M, rng, pad_tail=1000 if case == "padding_tail" else 0,
        empty=case == "empty")
    if case == "wide_leaf":
        mleaves.append(torch.as_tensor(
            rng.integers(-9, 9, (S * M, 2)), device=dev))
    for rnd in (0, 1):
        outs = []
        for fn in (KER.partition_scatter, KER.partition_scatter_plain):
            chunk = [torch.zeros((S * P * C,) + tuple(m.shape[1:]),
                                 dtype=m.dtype, device=dev) for m in mleaves]
            occ = torch.zeros(S * P * C, dtype=torch.bool, device=dev)
            KER.reset_launches()
            outs.append(fn(chunk, occ, mleaves, cnts, base, rnd, P, C))
        assert KER.launches["partition_scatter"] == 0  # plain ran last
        (gc, go), (rc, ro) = outs
        assert torch.equal(go, ro)
        _same(gc, rc)
        if case == "empty":
            assert not go.any()


def test_partition_scatter_counts_its_launches(dev):
    rng = np.random.default_rng(5)
    cnts, base, mleaves = _scatter_inputs(dev, 2, 4, 64, 100, rng)
    chunk = [torch.zeros(2 * 4 * 64, dtype=m.dtype, device=dev)
             for m in mleaves]
    occ = torch.zeros(2 * 4 * 64, dtype=torch.bool, device=dev)
    KER.reset_launches()
    KER.partition_scatter(chunk, occ, mleaves, cnts, base, 0, 4, 64)
    assert KER.launches["partition_scatter"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([mleaves[1], mleaves[1]], dim=1)[:, 0]
        KER.partition_scatter(chunk, occ, [mleaves[0], strided]
                              + mleaves[2:], cnts, base, 0, 4, 64)


def _mapped_inputs(dev, S, P, C, M, rng, null_share=0.0, empty_shard=None,
                   base_lo=None):
    """A morsel in map order: S shards of M rows with random destinations
    (P = null partition for a ``null_share`` of the rows, and for every
    row of ``empty_shard``), bases from ``base_lo`` (default: straddling
    the round-1 boundary)."""
    pid = rng.integers(0, P, (S, M))
    pid[rng.random((S, M)) < null_share] = P
    if empty_shard is not None:
        pid[empty_shard] = P
    lo = max(C - 300, 0) if base_lo is None else base_lo
    base = rng.integers(lo, lo + 350, (S, P))
    leaves = [rng.integers(0, 1 << 20, S * M).astype(np.int32),
              rng.integers(-(1 << 40), 1 << 40, S * M),
              rng.random(S * M) < 0.5,
              rng.random(S * M),
              rng.integers(-9, 9, (S * M, 2))]
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (to(pid.reshape(-1).astype(np.int32)), to(base.astype(np.int64)),
            [to(a) for a in leaves])


@pytest.mark.parametrize("case", ["stream_shape", "three_rounds", "padding",
                                  "empty_shard", "all_null", "wide_p"])
def test_partition_scatter_mapped_matches_plain(dev, case):
    rng = np.random.default_rng(8)
    S, P, C, M, null, empty, lo = 8, 8, 1 << 16, 4096, 0.0, None, None
    if case == "three_rounds":
        C, M, lo = 64, 512, 0
    elif case == "padding":
        null = 0.25
    elif case == "empty_shard":
        empty = 3
    elif case == "all_null":
        null = 1.0
    elif case == "wide_p":
        S, P, C, M = 2, 2048, 256, 4096
    pid, base, mleaves = _mapped_inputs(dev, S, P, C, M, rng, null, empty,
                                        lo)
    d = pid.long().reshape(S, M)
    ok = d < P
    r_lo, r_hi = 0, 1
    if ok.any():
        bmax = base.max().item() + M
        r_lo, r_hi = base.min().item() // C, bmax // C
    outs = []
    for fn in (KER.partition_scatter_mapped,
               KER.partition_scatter_mapped_plain):
        rounds = {r: ([torch.zeros((S * P * C,) + tuple(m.shape[1:]),
                                   dtype=m.dtype, device=dev)
                       for m in mleaves],
                      torch.zeros(S * P * C, dtype=torch.bool, device=dev))
                  for r in range(r_lo, r_hi + 1)}
        KER.reset_launches()
        outs.append(fn(rounds, mleaves, pid, base, P, C))
        if fn is KER.partition_scatter_mapped:
            assert KER.launches["partition_scatter"] == 1
    got, ref = outs
    placed = 0
    for r in got:
        assert torch.equal(got[r][1], ref[r][1])
        _same(got[r][0], ref[r][0])
        placed += int(got[r][1].sum())
    assert placed == int(ok.sum())
    if case == "three_rounds":
        assert r_hi - r_lo + 1 >= 3
