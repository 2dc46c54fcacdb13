"""PyTorch port: slot-table build/probe, against the JAX package.

Mirrors tests/test_pallas_kernels.py TestSlotBuildParity, TestSlotProbeParity
and TestFloatKeyWords: the port's ``(owner, slot, overflow)`` and
``(found, slot)`` must be bit-identical to the reference's — its lax
formulation, and its Pallas kernel in interpret mode at small n.  On the
CPU the port's kernel wrappers run their plain versions;
tests/test_torch_kernels_cuda.py holds the kernels themselves against
those plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.plan import adaptive as JA
from spark_rapids_jni_tpu.relational import hashtable as JH
from spark_rapids_jni_tpu.relational import keys as JK

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_jni_tpu_torch.ops import kernels as TKer
from spark_rapids_jni_tpu_torch.plan import adaptive as TA
from spark_rapids_jni_tpu_torch.relational import hashtable as TH
from spark_rapids_jni_tpu_torch.relational import keys as TK

SKEWS = ("zipf", "allequal", "alldistinct")


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def _skew_keys(skew, n, rng):
    if skew == "alldistinct":
        return rng.permutation(n).astype(np.int64)
    if skew == "allequal":
        return np.full(n, 7, np.int64)
    z = rng.zipf(1.3, size=n).astype(np.int64)
    return np.clip(z, 0, 1 << 20)


def _cols(vals, valid, jt, tt):
    valid = (np.ones(len(vals), bool) if valid is None
             else np.asarray(valid, bool))
    return (JColumn(jnp.asarray(vals), jnp.asarray(valid), jt),
            TColumn(torch.from_numpy(np.array(vals)),
                    torch.from_numpy(valid.copy()), tt))


def _words(keys, live=None):
    """Key words of one int64 column in both packages."""
    jc, tc = _cols(np.asarray(keys, np.int64), live, JT.INT64, TT.INT64)
    return (JK.batch_radix_keys([jc], equality=True, nulls_first=True),
            jc.validity,
            TK.batch_radix_keys([tc], equality=True, nulls_first=True),
            tc.validity)


def _assert_same(jout, tout, names):
    for a, b, nm in zip(jout, tout, names):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=nm)


def _build_both(keys, S, live=None, max_rounds=None, engine="lax"):
    jw, jl, tw, tl = _words(keys, live)
    jout = JH.build_slot_table(jw, jl, S, max_rounds=max_rounds,
                               engine=engine)
    tout = TH.build_slot_table(tw, tl, S, max_rounds=max_rounds)
    _assert_same(jout, tout, ("owner", "slot", "overflow"))
    return jout, tout


def test_fold_hash_bit_identical():
    rng = np.random.default_rng(0)
    ws = [rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
          for _ in range(3)]
    j = JH.fold_hash([jnp.asarray(w) for w in ws])
    t = TH.fold_hash([torch.from_numpy(w.astype(np.int64)) for w in ws])
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


class TestSlotBuildParity:
    @pytest.mark.parametrize("skew", SKEWS)
    def test_skews(self, skew, rng):
        jout, _ = _build_both(_skew_keys(skew, 2000, rng), 4096)
        assert not bool(jout[2])

    @pytest.mark.parametrize("skew", SKEWS)
    def test_dead_rows_excluded(self, skew, rng):
        keys = _skew_keys(skew, 500, rng)
        live = rng.random(500) < 0.7
        _, tout = _build_both(keys, 1024, live=live)
        assert (tout[1].numpy()[~live] == 1024).all()

    def test_empty_input(self):
        _, tout = _build_both(np.zeros(0, np.int64), 64)
        assert (tout[0].numpy() == 0).all()

    def test_overflow_reported_identically(self, rng):
        # 64 distinct keys cannot fit an 8-slot table
        jout, tout = _build_both(rng.permutation(64).astype(np.int64), 8)
        assert bool(jout[2]) and bool(tout[2])

    @pytest.mark.parametrize("mr", [0, 1, 4, 64])
    def test_truncated_max_rounds(self, mr, rng):
        _build_both(_skew_keys("zipf", 1000, rng), 256, max_rounds=mr)

    def test_multiword_keys(self, rng):
        n = 600
        k1 = rng.integers(0, 50, n)
        k2 = rng.integers(0, 7, n).astype(np.float64)
        j1, t1 = _cols(k1, None, JT.INT64, TT.INT64)
        j2, t2 = _cols(k2, rng.random(n) > 0.1, JT.FLOAT64, TT.FLOAT64)
        jw = JK.batch_radix_keys([j1, j2], equality=True, nulls_first=True)
        tw = TK.batch_radix_keys([t1, t2], equality=True, nulls_first=True)
        ones = np.ones(n, bool)
        jout = JH.build_slot_table(jw, jnp.asarray(ones), 1024)
        tout = TH.build_slot_table(tw, torch.from_numpy(ones), 1024)
        _assert_same(jout, tout, ("owner", "slot", "overflow"))

    def test_against_the_pallas_kernel_in_interpret_mode(self, rng):
        _build_both(_skew_keys("zipf", 300, rng), 512, engine="pallas")

    def test_table_past_the_reference_vmem_budget(self, rng):
        # the reference's Pallas path bows out past 4 MiB of table; the
        # port has no such cutoff and must agree with the lax build
        _build_both(_skew_keys("zipf", 100, rng), 1 << 19)


class TestSlotProbeParity:
    def _built(self, rng, skew="zipf", n=1500, S=4096):
        keys = _skew_keys(skew, n, rng)
        jw, jl, tw, tl = _words(keys)
        jowner, _, ovf = JH.build_slot_table(jw, jl, S)
        towner, _, _ = TH.build_slot_table(tw, tl, S)
        assert not bool(ovf)
        return keys, jw, jowner, tw, towner

    def _probe_both(self, built, probe, live=None, max_rounds=None,
                    engine="lax"):
        keys, jw, jowner, tw, towner = built
        jpw, jpl, tpw, tpl = _words(probe, live)
        jout = JH.probe_slot_table(jowner, jw, jpw, jpl,
                                   max_rounds=max_rounds, engine=engine)
        tout = TH.probe_slot_table(towner, tw, tpw, tpl,
                                   max_rounds=max_rounds)
        _assert_same(jout, tout, ("found", "slot"))
        return tout

    @pytest.mark.parametrize("skew", SKEWS)
    def test_hit_and_miss_probes(self, skew, rng):
        built = self._built(rng, skew)
        probe = np.concatenate([built[0][:400],
                                np.arange(2 << 20, (2 << 20) + 400)])
        found, _ = self._probe_both(built, probe)
        assert found.numpy()[:400].all() and not found.numpy()[400:].any()

    def test_dead_probe_rows_never_found(self, rng):
        built = self._built(rng)
        plive = rng.random(len(built[0])) < 0.5
        found, _ = self._probe_both(built, built[0], live=plive)
        assert not found.numpy()[~plive].any()

    def test_chain_bound_rounds_result_identical(self, rng):
        built = self._built(rng)
        keys, _, jowner, _, towner = built
        cb = TH.chain_bound(towner, len(keys))
        assert cb == int(JH.chain_bound(jowner, len(keys)))
        full = self._probe_both(built, keys)
        bounded = self._probe_both(built, keys, max_rounds=cb)
        for a, b in zip(full, bounded):
            assert torch.equal(a, b)

    def test_empty_probe_side(self, rng):
        found, slot = self._probe_both(self._built(rng), np.zeros(0,
                                                                  np.int64))
        assert found.shape == (0,) and slot.shape == (0,)

    def test_against_the_pallas_kernel_in_interpret_mode(self, rng):
        built = self._built(rng, n=200, S=512)
        probe = np.concatenate([built[0][:50], np.arange(-60, -10)])
        self._probe_both(built, probe, engine="pallas")


class TestFloatKeyWords:
    def _fcol(self, vals, valid=None):
        return _cols(np.asarray(vals, np.float64), valid, JT.FLOAT64,
                     TT.FLOAT64)

    def test_negzero_nan_null_words(self):
        vals = [-0.0, 0.0, np.nan, -np.nan, 1.5, -1.5, np.inf, -np.inf,
                0.0, np.nan]
        valid = [True] * 8 + [False, False]
        jc, tc = self._fcol(vals, valid)
        jw = JK.batch_radix_keys([jc], equality=True, nulls_first=True)
        tw = TK.batch_radix_keys([tc], equality=True, nulls_first=True)
        live = np.ones(10, bool)
        jout = JH.build_slot_table(jw, jnp.asarray(live), 64)
        tout = TH.build_slot_table(tw, torch.from_numpy(live), 64)
        _assert_same(jout, tout, ("owner", "slot", "overflow"))
        slot = tout[1].numpy()
        assert slot[0] == slot[1] and slot[2] == slot[3]
        assert slot[8] == slot[9]
        assert len({slot[0], slot[2], slot[4], slot[8]}) == 4

    def test_float_probe_parity(self):
        jb, tb = self._fcol([-0.0, np.nan, 2.5, -2.5, np.inf])
        jp, tp = self._fcol([0.0, -np.nan, 2.5, 7.0, np.inf])
        jbw = JK.batch_radix_keys([jb], equality=True, nulls_first=True)
        tbw = TK.batch_radix_keys([tb], equality=True, nulls_first=True)
        jpw = JK.batch_radix_keys([jp], equality=True, nulls_first=True)
        tpw = TK.batch_radix_keys([tp], equality=True, nulls_first=True)
        live = np.ones(5, bool)
        jowner, _, _ = JH.build_slot_table(jbw, jnp.asarray(live), 16)
        towner, _, _ = TH.build_slot_table(tbw, torch.from_numpy(live), 16)
        jout = JH.probe_slot_table(jowner, jbw, jpw, jnp.asarray(live))
        tout = TH.probe_slot_table(towner, tbw, tpw, torch.from_numpy(live))
        _assert_same(jout, tout, ("found", "slot"))
        assert tout[0].numpy().tolist() == [True, True, True, False, True]


class TestAdaptiveBounds:
    @pytest.mark.parametrize("adaptive", [True, False])
    @pytest.mark.parametrize("rows,slots", [(100, 4096), (3000, 4096),
                                            (1 << 24, 4096), (10, 16)])
    def test_build_round_bound(self, adaptive, rows, slots):
        jconfig.set("adaptive_execution", adaptive)
        tconfig.set("adaptive_execution", adaptive)
        assert (TA.bound_build_rounds(rows, slots)
                == JA.bound_build_rounds(rows, slots))

    def test_probe_round_bound_off_is_full_table(self):
        tconfig.set("adaptive_execution", False)
        owner = torch.zeros(8, dtype=torch.int32)
        assert TA.bound_probe_rounds(owner, 3) is None

    def test_chain_bound_wraparound_and_full(self):
        owner = torch.tensor([1, 1, 9, 9, 9, 1, 1, 1], dtype=torch.int32)
        # occupied = owner != 9: run wraps the end (slots 5..7, 0..1) = 5
        assert TH.chain_bound(owner, 9) == 6
        assert TH.chain_bound(torch.zeros(8, dtype=torch.int32), 9) == 8



def _raw_words(W, n, rng, pool=None):
    """W random u32 words per row (``pool`` distinct keys when given), in
    both packages' carriers."""
    if pool is None:
        ws = [rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(W)]
    else:
        keys = [rng.integers(0, 2**32, pool, dtype=np.uint64)
                for _ in range(W)]
        pick = rng.integers(0, pool, n)
        ws = [k[pick] for k in keys]
    return ([jnp.asarray(w.astype(np.uint32)) for w in ws],
            [torch.from_numpy(w.astype(np.int64)) for w in ws])


def _wrapping_keys(S, W, rng, count):
    """``count`` distinct W-word keys whose first candidate slot is one of
    the last two, so their chains run across slot S - 1 into slot 0."""
    got = []
    while len(got) < count:
        ws = [rng.integers(0, 2**32, 4096, dtype=np.uint64)
              for _ in range(W)]
        c0 = TH.fold_hash([torch.from_numpy(w.astype(np.int64))
                           for w in ws]).numpy() & (S - 1)
        got.extend(np.stack(ws, 1)[c0 >= S - 2].tolist())
    arr = np.array(got[:count], np.uint64)
    return [arr[:, j] for j in range(W)]


# the reference's walk, traced once per shape with the bound as data
_jprobe = jax.jit(lambda o, bw, pw, lv, mr: JH.probe_slot_table(
    o, bw, pw, lv, max_rounds=mr))


class TestSlotRecords:
    """The per-table slot records (owner and words per slot, chain bound)
    and the probe over them, against the reference's probe_slot_table."""

    def _case(self, case, W, S, rng):
        n = int(S * 0.45)
        if case == "wrap":
            ws = _wrapping_keys(S, W, rng, 6)
            fill = [rng.integers(0, 2**32, n, dtype=np.uint64)
                    for _ in range(W)]
            bws = [np.concatenate([a, b]) for a, b in zip(ws, fill)]
        elif case == "empty_build":
            bws = [np.zeros(0, np.uint64) for _ in range(W)]
        else:
            bws = [rng.integers(0, 2**32, n // 2, dtype=np.uint64)[
                rng.integers(0, n // 2, n)] for _ in range(W)]
        nb = len(bws[0])
        miss = [rng.integers(0, 2**32, 300, dtype=np.uint64)
                for _ in range(W)]
        if case == "wrap":
            miss = [np.concatenate([m, w]) for m, w in
                    zip(miss, _wrapping_keys(S, W, rng, 40))]
        pws = [np.concatenate([b[rng.integers(0, max(nb, 1),
                                              400 if nb else 0)], m])
               for b, m in zip(bws, miss)]
        m = len(pws[0])
        plive = (rng.random(m) > 0.2 if case == "dead_probes"
                 else np.ones(m, bool))
        j = lambda ws: [jnp.asarray(w.astype(np.uint32)) for w in ws]  # noqa
        t = lambda ws: [torch.from_numpy(w.astype(np.int64))  # noqa: E731
                        for w in ws]
        live = np.ones(nb, bool)
        jowner, _, ovf = JH.build_slot_table(j(bws), jnp.asarray(live), S)
        assert not bool(ovf)
        towner, _, _ = TH.build_slot_table(t(bws), torch.from_numpy(live), S)
        np.testing.assert_array_equal(np.asarray(jowner), towner.numpy())
        return (jowner, j(bws), j(pws), jnp.asarray(plive), towner, t(bws),
                t(pws), torch.from_numpy(plive))

    @pytest.mark.parametrize("case", ["mixed", "wrap", "empty_build",
                                      "dead_probes"])
    @pytest.mark.parametrize("W", [1, 2, 3, 4])
    @pytest.mark.parametrize("S", [64, 1 << 12])
    def test_every_round_bound(self, case, W, S, rng):
        (jowner, jbw, jpw, jpl, towner, tbw, tpw,
         tpl) = self._case(case, W, S, rng)
        nb = tbw[0].shape[0]
        recs = TH.slot_records(towner, tbw)
        cb = int(JH.chain_bound(jowner, nb))
        assert int(recs.bound[0]) == cb == TH.chain_bound(towner, nb)
        assert recs.rec.shape == (S, W + 1)
        assert torch.equal(recs.rec[:, 0], towner)
        if case == "wrap":  # a chain crosses slot S - 1
            occ = towner.numpy() != nb
            assert occ[-1] and occ[0]
        m = tpl.shape[0]
        for mr in list(range(1, cb + 1)) + [None]:
            # the reference cannot gather from an empty build side: there
            # every probe misses at its first, empty slot
            jout = (_jprobe(jowner, jbw, jpw, jpl, jnp.int32(mr or S))
                    if nb else (np.zeros(m, bool), np.full(m, S, np.int32)))
            tout = TH.probe_slot_records(recs, tpw, tpl, max_rounds=mr)
            _assert_same(jout, tout, ("found", "slot"))
        found = tout[0].numpy()
        assert not found[~tpl.numpy()].any()
        if case == "empty_build":
            assert not found.any()

    @pytest.mark.parametrize("W", [1, 4])
    def test_against_the_pallas_kernel_in_interpret_mode(self, W, rng):
        (jowner, jbw, jpw, jpl, towner, tbw, tpw,
         tpl) = self._case("wrap", W, 64, rng)
        recs = TH.slot_records(towner, tbw)
        for mr in (2, None):
            jout = JH.probe_slot_table(jowner, jbw, jpw, jpl, max_rounds=mr,
                                       engine="pallas")
            tout = TH.probe_slot_records(recs, tpw, tpl, max_rounds=mr)
            _assert_same(jout, tout, ("found", "slot"))

    def test_records_of_a_full_table(self, rng):
        """Records are W + 1 packed words a slot; a table with no empty
        slot has bound 0 (read as S) and every walk covers the whole
        table."""
        jw, tw = _raw_words(2, 8, rng)
        live = np.ones(8, bool)
        jowner, _, _ = JH.build_slot_table(jw, jnp.asarray(live), 8)
        towner, _, _ = TH.build_slot_table(tw, torch.from_numpy(live), 8)
        assert (towner.numpy() != 8).all()
        recs = TKer.slot_table_records(towner, tw)
        assert recs.rec.shape == (8, 3) and int(recs.bound[0]) == 0
        pj, pt = _raw_words(2, 30, rng)
        pj = [jnp.concatenate([a, b]) for a, b in zip(jw, pj)]
        pt = [torch.cat([a, b]) for a, b in zip(tw, pt)]
        pl = np.ones(38, bool)
        jout = JH.probe_slot_table(jowner, jw, pj, jnp.asarray(pl))
        tout = TKer.slot_table_probe_records(recs, pt, torch.from_numpy(pl))
        _assert_same(jout, tout, ("found", "slot"))
        assert tout[0].numpy()[:8].all()
