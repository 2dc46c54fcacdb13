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


def _string_key_words(dev, n, rng, nulls_first, prefix_only=False,
                      null=0.05):
    """Radix words of a 24-byte string key (W = 8: null flag, six char
    words, length word).  ``prefix_only``: every key has the same chars
    and the keys differ only in their length word."""
    from spark_rapids_jni_tpu_torch.columnar.column import (StringColumn,
                                                            string_arrays)

    if prefix_only:
        table = ["cat-00-" + "x" * 14 + "\x00" * j for j in range(4)]
    else:
        table = [f"cat-{i:02d}-{'x' * 14}" for i in range(100)]
    codes = rng.integers(0, len(table), n)
    chars, lengths = string_arrays(table, codes, 24)
    valid = rng.random(n) > null
    col = StringColumn(torch.from_numpy(chars).to(dev),
                       torch.from_numpy(lengths).to(dev),
                       torch.from_numpy(valid).to(dev))
    words = RK.batch_radix_keys([col], equality=True,
                                nulls_first=nulls_first)
    assert len(words) == 8
    return words


@pytest.mark.parametrize("case", ["q6str", "length_word_only", "join_build"])
def test_slot_table_build_at_w8_matches_plain(dev, case):
    rng = np.random.default_rng(11)
    if case == "join_build":  # the string dim's build: S = 2n, all live
        n, S, prefix = 100, 256, False
    else:
        n, S, prefix = 1 << 20, 4096, case == "length_word_only"
    words = _string_key_words(dev, n, rng, case != "join_build", prefix)
    live = torch.as_tensor(rng.random(n) > 0.5, device=dev) \
        if case == "q6str" else torch.ones(n, dtype=torch.bool, device=dev)
    mr = None if case == "join_build" else 64
    KER.reset_launches()
    got = KER.slot_table_build(words, live, S, mr)
    assert KER.launches["slot_table_build"] == 1
    ref = KER.slot_table_build_plain(words, live, S, S if mr is None else mr)
    _same(got, ref)
    assert not bool(got[2])
    if prefix:  # four lengths and the null key: five owners
        assert int((got[0] != n).sum()) == 5


@pytest.mark.parametrize("prefix", [False, True])
def test_slot_records_and_probe_at_w8_match_plain(dev, prefix):
    """The string join's table (a 100-row dim at S 256: 9-word records,
    9 KB, walked from shared memory) and a 2^20-row probe."""
    rng = np.random.default_rng(12)
    bw = _string_key_words(dev, 100, rng, False, prefix, null=0.0)
    S = 256
    owner = KER.slot_table_build(
        bw, torch.ones(100, dtype=torch.bool, device=dev), S)[0]
    KER.reset_launches()
    recs = KER.slot_table_records(owner, bw)
    ref = KER.slot_table_records_plain(owner, bw)
    assert KER.launches["slot_table_records"] == 1
    assert recs.rec.shape == (S, 9) and S * 9 * 4 <= 48 * 1024
    assert torch.equal(recs.rec, ref.rec)
    assert torch.equal(recs.bound, ref.bound)
    m = 1 << 20
    pw = _string_key_words(dev, m, rng, False, prefix)
    pl = torch.as_tensor(rng.random(m) > 0.1, device=dev)
    cb = H.chain_bound(owner, 100)
    for rounds in (None, cb, 1):
        got = KER.slot_table_probe_records(recs, pw, pl, rounds)
        want = KER.slot_table_probe_plain(owner, bw, pw, pl,
                                          S if rounds is None else rounds)
        _same(got, want)
    assert KER.launches["slot_table_probe"] == 3


# ---------------------------------------------------------------------------
# decimal lanes of the one-hot group-by, and K4 over string/decimal leaves
# ---------------------------------------------------------------------------

def _decimal_limbs(rng, n, kind):
    """int64[n, 2] two's-complement limbs: ``small`` (low limb in [0,
    2^50), the reference's group_by_decimal_sum), ``signed`` (the whole
    decimal(38) range, both signs) or ``extreme`` (+-(10^38 - 1), 0, -1,
    +-2^64 and 2^127 - 1 style edges)."""
    if kind == "small":
        lo = rng.integers(0, 1 << 50, n)
        return np.stack([lo, np.zeros(n, np.int64)], 1)
    if kind == "extreme":
        pool = [10 ** 38 - 1, -(10 ** 38 - 1), 0, -1, 1, 2 ** 64,
                -(2 ** 64), 2 ** 127 - 1, -(2 ** 127)]
        vals = [pool[i] for i in rng.integers(0, len(pool), n)]
    else:
        vals = [int(rng.integers(0, 10 ** 18)) * 10 ** 20
                + int(rng.integers(0, 10 ** 18)) for _ in range(n)]
        vals = [-v if s else v for v, s in zip(vals, rng.random(n) < 0.5)]
    u = np.array([v & ((1 << 128) - 1) for v in vals], dtype=object)
    lo = np.array([int(x) & ((1 << 64) - 1) for x in u], np.uint64)
    hi = np.array([int(x) >> 64 for x in u], np.uint64)
    return np.stack([lo, hi], 1).view(np.int64)


def _decimal_onehot(dev, rng, n, K, kind, pattern_rows=None):
    key = rng.integers(0, K, n).astype(np.int32)
    if pattern_rows is not None:  # tile a small pattern up to n rows
        limbs = np.tile(_decimal_limbs(rng, pattern_rows, kind),
                        (-(-n // pattern_rows), 1))[:n]
    else:
        limbs = _decimal_limbs(rng, n, kind)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    val = lambda s: to(rng.random(n) > s)  # noqa: E731
    cols = [(to(np.ascontiguousarray(limbs)), val(0.01)),
            (to(rng.integers(-99, 99, n)), val(0.1))]
    return to(key), val(0.05), to(rng.random(n) > 0.1), cols


# the decimal case's partials (1 u64 int sum + 4 lanes, 1 + 2 + 1 u32
# counts) take 56 bytes a bucket: 48 KB hold 877, so K = 3000 tiles four
# times over gridDim.y
@pytest.mark.parametrize("kind,K,n,pattern", [
    ("small", 100, 1 << 20, None), ("signed", 100, 1 << 20, 4096),
    ("extreme", 11, 1 << 24, 4096), ("signed", 3000, 1 << 20, 4096)])
def test_onehot_decimal_lanes_match_plain(dev, kind, K, n, pattern):
    """Fused entry with decimal lanes bit for bit against its plain path
    (the reference's 16 byte limbs and negative flag), and the contract
    entry over the decimal payload against its plain version."""
    from spark_rapids_jni_tpu_torch.relational.aggregate import \
        decimal_lanes_to_limbs

    rng = np.random.default_rng(K + n)
    key, kv, live, cols = _decimal_onehot(dev, rng, n, K, kind, pattern)
    KER.reset_launches()
    got = KER.onehot_groupby_columns(key, kv, live, cols, [1], [], K, [0])
    assert KER.launches["onehot_groupby"] == 1
    ref = KER.onehot_groupby_columns_plain(key, kv, live, cols, [1], [], K,
                                           [0])
    assert torch.equal(got[0], ref[0])
    assert bool(got[2]) == bool(ref[2])
    s256 = decimal_lanes_to_limbs(got[0][:, 4:8], got[0][:, 8])
    assert s256.shape == (8, K + 1) and bool((s256 < (1 << 32)).all())
    bucket, X8, F, _ = KER.onehot_payload(key, kv, live, cols, [1], [], K,
                                          [0])
    assert X8.shape[1] == 1 + 2 + 8 + 17
    KER.reset_launches()
    oi, _ = KER.onehot_groupby_parts(bucket, X8, F, K + 1)
    assert KER.launches["onehot_groupby_parts"] == 1
    ri, _ = KER.onehot_groupby_parts_plain(bucket, X8, F, K + 1)
    assert torch.equal(oi, ri)


@pytest.mark.parametrize("case", ["stream_shape", "three_rounds"])
def test_partition_scatter_string_and_decimal_leaves(dev, case):
    """K4 moves a uint8 [n, 24] chars leaf and an int64 [n, 2] limbs leaf
    by their row bytes, bit for bit with its plain version."""
    rng = np.random.default_rng(9)
    S, P, C, M, lo = 8, 8, 1 << 16, 4096, None
    if case == "three_rounds":
        C, M, lo = 64, 512, 0
    pid, base, mleaves = _mapped_inputs(dev, S, P, C, M, rng, 0.1, None, lo)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    mleaves = [to(rng.integers(0, 256, (S * M, 24)).astype(np.uint8)),
               to(rng.integers(0, 24, S * M).astype(np.int32)),
               to(_decimal_limbs(rng, S * M, "extreme")),
               to(rng.random(S * M) < 0.9)]
    r_lo = base.min().item() // C
    r_hi = (base.max().item() + M) // C
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
    for r in got:
        assert torch.equal(got[r][1], ref[r][1])
        _same(got[r][0], ref[r][0])


@pytest.mark.parametrize("n,card", [(1 << 22, 100), (1 << 16, 4096),
                                    (1 << 20, 1)])
def test_slot_table_build_over_a_canon_word_matches_plain(dev, n, card):
    """K2 over a dictionary column's canon key: the null flag and ONE
    canon word (two words), as the q6str_enc group-by builds it."""
    from spark_rapids_jni_tpu_torch.columnar import encoded as E
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG

    g = torch.Generator().manual_seed(n + card)
    dict_vals = Column(torch.randperm(10 * card, generator=g)[:card]
                       .to(dev), torch.ones(card, dtype=torch.bool,
                                            device=dev), TT.INT64)
    codes = torch.randint(0, card, (n,), generator=g).to(dev)
    valid = (torch.rand(n, generator=g) > 0.01).to(dev)
    col = E.dictionary_from_arrays(codes, valid, dict_vals)
    words = RK.batch_radix_keys(AGG._canon_keys([col]), equality=True,
                                nulls_first=True)
    assert len(words) == 2
    live = (torch.rand(n, generator=g) > 0.5).to(dev)
    S = 4096 if card <= 1024 else H.next_pow2(2 * card)
    KER.reset_launches()
    got = KER.slot_table_build(words, live, S)
    assert KER.launches["slot_table_build"] == 1
    _same(got, KER.slot_table_build_plain(words, live, S, S))


# ---------------------------------------------------------------------------
# the string path (ops/get_json_object, json_fast, strings, regex_rewrite,
# cast_string, float_to_string): plain torch, no kernel of its own, so on
# CUDA tensors it must give the CPU's bytes exactly
# ---------------------------------------------------------------------------

_JSON_DOCS = [
    '{"owner":"amya1","a":[1,2.5,{"b":-0}],"c":"x\\ny"}', "{'owner': 'q'}",
    '{"owner": null}', '{"a\\u0062c": 1, "owner":"\\u0079o"}',
    '[1, [2, 3], {"a": 1e400}]', '{"owner": 1.50e-3}', "not json", None,
    '{"a": {"b": [true, false, null]}}', '{"owner": "\\t\\"q\\""}',
    '{"a":[{"b":1},{"b":2.0}]}', '  {"owner" : [ 1 , 2 ] }  ',
    '{"owner": -0}', '{"a": [[1,2],[3,4]]}', '{"owner":"é"}']


def _string_cols(values, dev, pad=16):
    from spark_rapids_jni_tpu_torch.columnar.column import StringColumn

    return (StringColumn.from_pylist(values, pad_to_multiple=pad,
                                     device="cpu"),
            StringColumn.from_pylist(values, pad_to_multiple=pad,
                                     device=dev))


def _same_strings(a, b):
    assert torch.equal(a.chars.cpu(), b.chars)
    assert torch.equal(a.lengths.cpu(), b.lengths)
    assert torch.equal(a.validity.cpu(), b.validity)


@pytest.mark.parametrize("path", ["$.owner", "$.a[1]", "$.a[*].b", "$"])
@pytest.mark.parametrize("div", [-1, 0, 2])
def test_get_json_object_on_card_equals_cpu(dev, path, div):
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.ops.get_json_object import \
        get_json_object

    cpu, card = _string_cols(_JSON_DOCS * 3, dev)
    config.set("json_fast_path", div >= 0)
    config.set("json_fallback_div", max(div, 0))
    try:
        _same_strings(get_json_object(card, path),
                      get_json_object(cpu, path))
    finally:
        config.reset("json_fast_path")
        config.reset("json_fallback_div")


@pytest.mark.parametrize("engine", ["scatter", "sort"])
def test_substring_and_pattern_on_card_equal_cpu(dev, engine):
    from spark_rapids_jni_tpu_torch.ops.regex_rewrite import \
        literal_range_pattern
    from spark_rapids_jni_tpu_torch.ops.strings import substring

    vals = ["amya12", "été-a9", "", None, "a", "xa0ya", "b" * 40]
    cpu, card = _string_cols(vals * 5, dev)
    for pos, ln in ((4, 8), (-3, 2), (0, 5), (2, -1)):
        _same_strings(substring(card, pos, ln, engine),
                      substring(cpu, pos, ln, engine))
    a = literal_range_pattern(card, "a", 1, ord("0"), ord("9"))
    b = literal_range_pattern(cpu, "a", 1, ord("0"), ord("9"))
    assert torch.equal(a.data.cpu(), b.data)
    assert torch.equal(a.validity.cpu(), b.validity)


def test_casts_on_card_equal_cpu(dev):
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import float_to_string as FS

    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**63, 4096, dtype=np.int64)
    d = np.concatenate([[0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324,
                         2.0**53 + 1, 1e23], bits.view(np.float64)])
    strs = [repr(x) for x in d[:2048].tolist()] + [
        " 12 ", "-9223372036854775808", "1e-320", "1f", "0f", ".", "7.8.3",
        "123456789012345678901234567890", "nan", "-Infinity", "9.23", None]
    cpu, card = _string_cols(strs, dev, pad=1)
    for dtype in (TT.FLOAT64, TT.FLOAT32):
        a, b = CS.string_to_float(card, dtype), CS.string_to_float(cpu, dtype)
        assert torch.equal(a.data.cpu().view(torch.uint8),
                           b.data.view(torch.uint8))
        assert torch.equal(a.validity.cpu(), b.validity)
    for fn in (lambda c: CS.string_to_integer(c, TT.INT64),
               lambda c: CS.string_to_integer(c, TT.INT8)):
        a, b = fn(card), fn(cpu)
        assert torch.equal(a.data.cpu(), b.data)
        assert torch.equal(a.validity.cpu(), b.validity)
    a, b = CS.string_to_decimal(card, 18, -4), CS.string_to_decimal(cpu, 18,
                                                                    -4)
    assert torch.equal(a.limbs.cpu(), b.limbs)
    assert torch.equal(a.validity.cpu(), b.validity)
    for t, arr in ((TT.FLOAT64, d), (TT.FLOAT32, d.astype(np.float32))):
        ones = torch.ones(arr.shape[0], dtype=torch.bool)
        x = Column(torch.from_numpy(arr), ones, t)
        y = Column(torch.from_numpy(arr).to(dev), ones.to(dev), t)
        _same_strings(FS.float_to_string(y), FS.float_to_string(x))
