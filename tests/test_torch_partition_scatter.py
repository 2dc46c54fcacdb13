"""PyTorch port: the partition scatter (K4) against the JAX package.

Reference counterparts: ``spark_rapids_jni_tpu/ops/pallas_kernels.py``
``partition_scatter`` (run as the reference's own tests run it on the
CPU, in Pallas interpret mode) and its lax formulation
(``tests/test_pallas_kernels.py`` ``TestPartitionScatter._lax_ref``,
repeated here as ``_lax_ref``).  The port's wrapper on CPU tensors runs
its plain version; the CUDA kernel is held against that plain version in
``test_torch_kernels_cuda.py``.  Chunks and occupancy must be
bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import pallas_kernels as PK

from spark_rapids_jni_tpu_torch.ops import kernels as KER

from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _lax_ref(chunk, occv, morsel, cnts, base, r, P, C):
    M = morsel[0].shape[0]
    ends = jnp.cumsum(cnts)
    offs = ends - cnts
    i = jnp.arange(M, dtype=jnp.int32)
    d = jnp.searchsorted(ends, i, side="right").astype(jnp.int32)
    d_c = jnp.minimum(d, P - 1)
    k = jnp.take(base, d_c) + (i - jnp.take(offs, d_c))
    in_round = (d < P) & (k >= r * C) & (k < (r + 1) * C)
    t = jnp.where(in_round, d_c * C + (k - r * C), P * C)
    new_chunk = tuple(acc.at[t].set(x, mode="drop")
                      for acc, x in zip(chunk, morsel))
    return new_chunk, occv.at[t].set(True, mode="drop")


def _case(rng, P, C, M, parts=None):
    """One shard's inputs as numpy: counts from a destination per row
    (P = null-partition rows, which the map sorts last), a base, zero
    chunks and int64/float32/bool morsel leaves."""
    if parts is None:
        parts = rng.integers(0, P + 1, M)
    cnts = np.bincount(parts[parts < P], minlength=P).astype(np.int32)
    base = rng.integers(0, 24, P).astype(np.int32)
    morsel = (rng.integers(0, 1 << 30, M).astype(np.int64),
              rng.random(M).astype(np.float32),
              rng.random(M) < 0.7)
    chunk = (np.zeros(P * C, np.int64), np.zeros(P * C, np.float32),
             np.zeros(P * C, np.bool_))
    return cnts, base, morsel, chunk


def _port(cnts, base, morsel, chunk, r, P, C):
    t = [torch.from_numpy(np.array(a)) for a in chunk]
    occ = torch.zeros(P * C, dtype=torch.bool)
    KER.reset_launches()
    out, occ = KER.partition_scatter(
        t, occ, [torch.from_numpy(np.array(a)) for a in morsel],
        torch.from_numpy(cnts)[None], torch.from_numpy(base)[None], r, P,
        C)
    assert KER.launches["partition_scatter"] == 0  # CPU: plain version
    return [x.numpy() for x in out], occ.numpy()


def _assert_same(port, ref):
    (pc, po), (rc, ro) = port, ref
    np.testing.assert_array_equal(po, np.asarray(ro))
    for a, b in zip(pc, rc):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("rnd", [0, 1, 3])
def test_matches_pallas_and_lax_reference(rnd):
    rng = np.random.default_rng(7 + rnd)
    P, C, M = 8, 16, 96
    cnts, base, morsel, chunk = _case(rng, P, C, M)
    args = ([jnp.asarray(a) for a in chunk], jnp.zeros(P * C, jnp.bool_),
            [jnp.asarray(a) for a in morsel], jnp.asarray(cnts),
            jnp.asarray(base), jnp.int32(rnd), P, C)
    port = _port(cnts, base, morsel, chunk, rnd, P, C)
    _assert_same(port, _lax_ref(*args))
    ref_c, ref_o = PK.partition_scatter(*args)
    _assert_same(port, (ref_c, ref_o))


@pytest.mark.parametrize("case", ["all_to_one", "empty_morsel",
                                  "all_padding_tail"])
def test_skew_and_empty_morsels(case):
    rng = np.random.default_rng(11)
    P, C, M = 8, 16, 96
    if case == "all_to_one":
        parts = np.full(M, 5)
    elif case == "empty_morsel":
        parts = np.full(M, P)  # every row in the null partition
    else:
        parts = np.sort(rng.integers(0, P, M))
        parts[-40:] = P
    cnts, base, morsel, chunk = _case(rng, P, C, M, parts)
    for rnd in (0, 1, 2):
        args = ([jnp.asarray(a) for a in chunk],
                jnp.zeros(P * C, jnp.bool_),
                [jnp.asarray(a) for a in morsel], jnp.asarray(cnts),
                jnp.asarray(base), jnp.int32(rnd), P, C)
        port = _port(cnts, base, morsel, chunk, rnd, P, C)
        _assert_same(port, _lax_ref(*args))
        if case == "empty_morsel":
            assert not port[1].any()


def test_all_shards_in_one_call_equal_per_shard_reference():
    """S shards in one call equal S reference calls, each on its own
    [P * C] region of the chunk; a 2-D leaf moves whole rows."""
    rng = np.random.default_rng(3)
    S, P, C, M, rnd = 3, 8, 16, 64, 1
    cases = [_case(rng, P, C, M) for _ in range(S)]
    cnts = np.stack([c[0] for c in cases])
    base = np.stack([c[1] for c in cases])
    m_leaves = [np.concatenate([c[2][j] for c in cases]) for j in range(3)]
    wide = rng.integers(-9, 9, (S * M, 2)).astype(np.int64)
    chunk = [torch.zeros(S * P * C, dtype=torch.int64),
             torch.zeros(S * P * C, dtype=torch.float32),
             torch.zeros(S * P * C, dtype=torch.bool),
             torch.zeros((S * P * C, 2), dtype=torch.int64)]
    occ = torch.zeros(S * P * C, dtype=torch.bool)
    KER.partition_scatter(chunk, occ,
                          [torch.from_numpy(a) for a in m_leaves]
                          + [torch.from_numpy(wide)],
                          torch.from_numpy(cnts), torch.from_numpy(base),
                          rnd, P, C)
    for s, (c, b, morsel, zeros) in enumerate(cases):
        ref_c, ref_o = _lax_ref(
            [jnp.asarray(a) for a in zeros] + [jnp.zeros((P * C, 2),
                                                         jnp.int64)],
            jnp.zeros(P * C, jnp.bool_),
            [jnp.asarray(a) for a in morsel]
            + [jnp.asarray(wide[s * M:(s + 1) * M])],
            jnp.asarray(c), jnp.asarray(b), jnp.int32(rnd), P, C)
        region = slice(s * P * C, (s + 1) * P * C)
        np.testing.assert_array_equal(occ[region].numpy(),
                                      np.asarray(ref_o))
        for got, want in zip(chunk, ref_c):
            np.testing.assert_array_equal(got[region].numpy(),
                                          np.asarray(want))


def test_rejects_what_the_kernel_cannot_take():
    P, C = 4, 8
    occ = torch.zeros(P * C, dtype=torch.bool)
    leaf = [torch.zeros(P * C, dtype=torch.int64)]
    mo = [torch.zeros(16, dtype=torch.int64)]
    c32 = torch.zeros((1, P), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        KER.partition_scatter(leaf, occ, mo, c32.long(), c32, 0, P, C)
    with pytest.raises(ValueError, match="line up"):
        KER.partition_scatter(leaf, occ, [mo[0].int()], c32, c32, 0, P, C)
    with pytest.raises(ValueError, match="occ"):
        KER.partition_scatter(leaf, occ[:-1], mo, c32, c32, 0, P, C)


# ---------------------------------------------------------------------------
# the map-order form: the morsel as the map leaves it, every round at once
# ---------------------------------------------------------------------------

def _mapped_case(rng, S, P, C, M, null_share=0.0, dead_shard=None,
                 base_hi=24):
    """S shards of M map-order rows: a destination per row (P = the null
    partition: dead, padding or out-of-range rows), a base per (shard,
    destination), and int64/float32/bool leaves."""
    pid = rng.integers(0, P, (S, M))
    pid[rng.random((S, M)) < null_share] = P
    if dead_shard is not None:
        pid[dead_shard] = P
    base = rng.integers(0, base_hi, (S, P)).astype(np.int32)
    leaves = (rng.integers(0, 1 << 30, S * M).astype(np.int64),
              rng.random(S * M).astype(np.float32),
              rng.random(S * M) < 0.7)
    return pid, base, leaves


def _reference_rounds(pid, base, leaves, rounds, P, C):
    """Per shard: the reference's map regroup (a stable argsort of the
    destinations, per-destination counts), then its Pallas
    ``partition_scatter`` once per round.  Returns ``{round: (chunk
    leaves, occ)}`` over all shards, shard-major like the port's."""
    S, M = pid.shape
    out = {}
    for r in rounds:
        chunks = [[] for _ in leaves]
        occs = []
        for s in range(S):
            order = np.argsort(pid[s], kind="stable")
            regrouped = [jnp.asarray(x[s * M:(s + 1) * M][order])
                         for x in leaves]
            live = pid[s][pid[s] < P]
            cnts = np.bincount(live, minlength=P).astype(np.int32)
            zeros = [jnp.zeros(P * C, x.dtype) for x in leaves]
            ch, oc = PK.partition_scatter(
                zeros, jnp.zeros(P * C, jnp.bool_), regrouped,
                jnp.asarray(cnts), jnp.asarray(base[s]), jnp.int32(r), P,
                C)
            for acc, x in zip(chunks, ch):
                acc.append(np.asarray(x))
            occs.append(np.asarray(oc))
        out[r] = ([np.concatenate(c) for c in chunks],
                  np.concatenate(occs))
    return out


def _port_rounds(pid, base, leaves, rounds, P, C):
    S, M = pid.shape
    rr = {r: ([torch.zeros(S * P * C, dtype=torch.from_numpy(x).dtype)
               for x in leaves],
              torch.zeros(S * P * C, dtype=torch.bool)) for r in rounds}
    KER.reset_launches()
    KER.partition_scatter_mapped(
        rr, [torch.from_numpy(x) for x in leaves],
        torch.from_numpy(pid.reshape(-1).astype(np.int32)),
        torch.from_numpy(base.astype(np.int64)), P, C)
    assert KER.launches["partition_scatter"] == 0  # CPU: plain version
    return rr


@pytest.mark.parametrize("case", ["three_rounds", "padding_and_null",
                                  "dead_shard", "one_partition", "wide_p"])
def test_mapped_matches_reference_regroup_then_pallas(case):
    rng = np.random.default_rng(23)
    S, P, C, M, null, dead, base_hi = 2, 4, 64, 512, 0.0, None, 24
    if case == "padding_and_null":
        S, P, M, null = 2, 8, 256, 0.3
    elif case == "dead_shard":
        S, P, M, dead = 3, 8, 128, 1
    elif case == "one_partition":
        S, P, C, M = 2, 1, 64, 160
    elif case == "wide_p":
        S, P, C, M, base_hi = 2, 256, 4, 512, 6
    pid, base, leaves = _mapped_case(rng, S, P, C, M, null, dead, base_hi)
    cnt = np.stack([np.bincount(r[r < P], minlength=P) for r in pid])
    k_hi = int((base + cnt).max())  # one past the largest slot
    rounds = list(range(0, max(k_hi - 1, 0) // C + 1))
    if case == "three_rounds":
        assert len(rounds) >= 3
    port = _port_rounds(pid, base, leaves, rounds, P, C)
    ref = _reference_rounds(pid, base, leaves, rounds, P, C)
    placed = 0
    for r in rounds:
        np.testing.assert_array_equal(port[r][1].numpy(), ref[r][1])
        for a, b in zip(port[r][0], ref[r][0]):
            np.testing.assert_array_equal(a.numpy(), b)
        placed += int(port[r][1].sum())
    assert placed == int((pid < P).sum())
    if case == "dead_shard":
        region = slice(1 * P * C, 2 * P * C)
        assert not any(port[r][1][region].any() for r in rounds)


def test_regrouped_entry_equals_map_order_form():
    """The regrouped entry's route on the card: a regrouped morsel's
    destination per row (the upper-bound search over cumsum(cnts)) and
    the map-order form give the chunk the reference's form gives."""
    rng = np.random.default_rng(29)
    S, P, C, M = 3, 8, 16, 96
    cases = [_case(rng, P, C, M) for _ in range(S)]
    cnts = torch.from_numpy(np.stack([c[0] for c in cases]))
    base = torch.from_numpy(np.stack([c[1] for c in cases]))
    morsel = [torch.from_numpy(np.concatenate([c[2][j] for c in cases]))
              for j in range(3)]
    ends = torch.cumsum(cnts.to(torch.int64), 1)
    i = torch.arange(M, dtype=torch.int64).expand(S, M).contiguous()
    pid = torch.searchsorted(ends, i, right=True).to(torch.int32)
    for rnd in (0, 1, 2):
        want = KER.partition_scatter_plain(
            [torch.zeros(S * P * C, dtype=m.dtype) for m in morsel],
            torch.zeros(S * P * C, dtype=torch.bool), morsel, cnts, base,
            rnd, P, C)
        got = KER.partition_scatter_mapped_plain(
            {rnd: ([torch.zeros(S * P * C, dtype=m.dtype) for m in morsel],
                   torch.zeros(S * P * C, dtype=torch.bool))},
            morsel, pid.reshape(-1), base.to(torch.int64), P, C)[rnd]
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)


def test_mapped_rejects_what_the_kernel_cannot_take():
    P, C, S, M = 4, 8, 2, 8
    like = [torch.zeros(S * M, dtype=torch.int64)]
    sc = KER.PartitionScatter(like, S, P, C)
    sc.open_round(0, [torch.zeros(S * P * C, dtype=torch.int64)],
                  torch.zeros(S * P * C, dtype=torch.bool))
    pid = torch.zeros(S * M, dtype=torch.int32)
    base = torch.zeros((S, P), dtype=torch.int64)
    with pytest.raises(ValueError, match="not all open"):
        sc(like, pid, base, 0, 1)
    with pytest.raises(ValueError, match="base"):
        sc(like, pid, base.int(), 0, 0)
    with pytest.raises(ValueError, match="stream's"):
        sc([like[0].int()], pid, base, 0, 0)
    with pytest.raises(ValueError, match="line up"):
        sc.open_round(1, [torch.zeros(S * P * C, dtype=torch.int32)],
                      torch.zeros(S * P * C, dtype=torch.bool))
    with pytest.raises(ValueError, match="2048"):
        KER.PartitionScatter(like, S, 4096, C)
