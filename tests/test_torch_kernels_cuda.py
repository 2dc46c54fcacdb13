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
    assert KER.launches["onehot_groupby_parts"] == 1
    assert KER.launches["onehot_groupby"] == 0
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


def _key_words(kind, keys, dev, live=None):
    """Key words of ``keys`` as an int32 column (W 2), an int64 column
    (W 3) or two int64 columns (W 6)."""
    keys = np.asarray(keys, np.int64)
    v = (torch.ones(len(keys), dtype=torch.bool, device=dev) if live is None
         else torch.as_tensor(np.asarray(live, bool), device=dev))
    if kind == "int32":
        cols = [Column(torch.as_tensor(keys.astype(np.int32), device=dev), v,
                       TT.INT32)]
    else:
        k = torch.as_tensor(keys, device=dev)
        cols = [Column(k, v, TT.INT64)]
        if kind == "two_int64":
            cols.append(Column(k * 7 + 1, v, TT.INT64))
    return RK.batch_radix_keys(cols, equality=True, nulls_first=False), v


def _wrapping(kind, S, rng, count):
    """``count`` distinct keys whose first candidate is one of the last
    two slots: their chains cross slot S - 1."""
    out = []
    while len(out) < count:
        cand = rng.integers(0, 1 << 30, 1 << 14)
        words, _ = _key_words(kind, cand, "cpu")
        c0 = (KER.fold_hash(words) & (S - 1)).numpy()
        out.extend(cand[c0 >= S - 2].tolist())
    return np.unique(np.array(out[:count]))


@pytest.mark.parametrize("kind", ["int32", "int64", "two_int64"])
@pytest.mark.parametrize("S", [64, 4096, 8192])
def test_slot_records_and_walk_match_plain(dev, kind, S):
    """Records and bound against their plain version; the probe against
    the reference formulation at several max_rounds and on chains
    crossing S - 1, with the table on both sides of the shared-memory
    limit (48 KB: S 64 is in, S 4096 of 12-byte records (an int32 key)
    is in and of 16- and 28-byte records out, S 8192 out)."""
    rng = np.random.default_rng(S + len(kind))
    wrap = _wrapping(kind, S, rng, 10)
    fill = rng.integers(1 << 30, 1 << 31, int(S * 0.6))
    keys = np.concatenate([wrap, fill])
    words, lv = _key_words(kind, keys, dev)
    n = len(keys)
    owner, _, ovf = KER.slot_table_build(words, lv, S)
    assert not bool(ovf)
    KER.reset_launches()
    recs = KER.slot_table_records(owner, words)
    assert KER.launches["slot_table_records"] == 1
    ref = KER.slot_table_records_plain(owner, words)
    assert torch.equal(recs.rec, ref.rec) and torch.equal(recs.bound,
                                                          ref.bound)
    occ = (owner != n).cpu().numpy()
    assert occ[-1] and occ[0]  # a run crosses slot S - 1
    cb = int(ref.bound[0]) or S
    probe = np.concatenate([keys[::2], rng.integers(1 << 31, 1 << 32, 3000),
                            _wrapping(kind, S, rng, 30)])
    plive = rng.random(len(probe)) > 0.1
    pw, pl = _key_words(kind, probe, dev, plive)
    for mr in sorted({1, 2, 3, 5, 7, max(cb - 1, 1), cb}) + [None]:
        KER.reset_launches()
        got = KER.slot_table_probe_records(recs, pw, pl, mr)
        assert KER.launches["slot_table_probe"] == 1
        want = KER.slot_table_probe_plain(owner, words, pw, pl,
                                          S if mr is None else mr)
        _same(got, want)
    assert got[0].dtype == torch.bool
    assert got[0].cpu().numpy()[:len(keys[::2])][plive[:len(keys[::2])]] \
        .all()


def _onehot_inputs(dev, rng, n, K, extreme=False, dead=0.2, oob=0.0):
    """Key (int32), row mask and four referenced columns: v int64 and i
    int32 (int sums), p and q f64 (float sums), each with nulls."""
    key = rng.integers(0, K, n)
    if oob:
        bad = rng.random(n) < oob
        key[bad] = rng.choice([-5, K, K + 3], int(bad.sum()))
    if extreme:
        v = rng.choice(np.array([-(2**63), 2**63 - 1, -1, 0, 1,
                                 2**62 + 12345, -(2**62)], np.int64), n)
    else:
        v = rng.integers(-(2**40), 2**40, n)
    i = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    p = (rng.random(n) - 0.3) * 1e6
    q = rng.standard_normal(n) * 1e-3
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    val = lambda s: to(rng.random(n) > s)  # noqa: E731
    cols = [(to(v), val(0.1)), (to(i), val(0.2)), (to(p), val(0.05)),
            (to(q), val(0.3))]
    return (to(key.astype(np.int32)), val(0.1), to(rng.random(n) >= dead),
            cols)


def _onehot_check(key, kv, live, cols, K):
    KER.reset_launches()
    got = KER.onehot_groupby_columns(key, kv, live, cols, [0, 1], [2, 3], K)
    assert KER.launches["onehot_groupby"] == 1
    ref = KER.onehot_groupby_columns_plain(key, kv, live, cols, [0, 1],
                                           [2, 3], K)
    assert torch.equal(got[0], ref[0])
    assert bool(got[2]) == bool(ref[2])
    absc = [(d.abs() if d.is_floating_point() else d, v) for d, v in cols]
    rabs = KER.onehot_groupby_columns_plain(key, kv, live, absc, [0, 1],
                                            [2, 3], K)[1]
    for j in range(2):
        a = got[1][:, 3 * j:3 * j + 3].sum(1)
        b = ref[1][:, 3 * j:3 * j + 3].sum(1)
        scale = rabs[:, 3 * j:3 * j + 3].sum(1)
        assert ((a - b).abs() <= RTOL * scale).all()
    return got


# a block's partials of these columns (2 u64 sums, 1 + 4 u32 counts,
# 2 x 3 f32 limbs) take 60 bytes a bucket, so 48 KB hold 819 buckets:
# K = 819 (820 buckets) needs two tiles over gridDim.y
@pytest.mark.parametrize("K", [1, 100, 48 * 1024 // (8 * 2 + 4 * 5 + 12 * 2)])
def test_onehot_columns_matches_plain(dev, K):
    rng = np.random.default_rng(K)
    key, kv, live, cols = _onehot_inputs(dev, rng, (1 << 20) + 3, K)
    _onehot_check(key, kv, live, cols, K)


@pytest.mark.parametrize("case", ["extreme_int64", "all_dead",
                                  "ragged_n_and_overflow", "int64_key",
                                  "every_row_live"])
def test_onehot_columns_edges(dev, case):
    rng = np.random.default_rng(len(case))
    n, K = 1_000_003, 101
    key, kv, live, cols = _onehot_inputs(
        dev, rng, n, K, extreme=case == "extreme_int64",
        dead=1.0 if case == "all_dead" else 0.2,
        oob=0.01 if case in ("ragged_n_and_overflow", "all_dead") else 0.0)
    if case == "int64_key":
        key = key.to(torch.int64)
    got = _onehot_check(key, kv, None if case == "every_row_live" else live,
                        cols, K)
    if case == "all_dead":
        assert not got[0].any() and not got[1].any() and not bool(got[2])
    if case == "ragged_n_and_overflow":
        assert bool(got[2])


def test_onehot_columns_one_launch_per_group_by_and_no_stack(dev):
    """The q6 one-hot step on the card: one K1 launch, no payload
    build (no aten::stack)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_jni_tpu_torch import config, pipelines as PL

    b = PL.example_batch(1 << 16, device=dev)
    config.set("q6_group_path", "onehot")
    try:
        PL.q6_step(b)
        KER.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            PL.q6_step(b)
    finally:
        config.reset("q6_group_path")
    assert KER.launches["onehot_groupby"] == 1
    assert not any(e.key == "aten::stack" for e in prof.key_averages())
