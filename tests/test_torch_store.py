"""PyTorch port: the persistent shuffle store (``shuffle/store.py``) and
the adoption-first lineage combinator (``shuffle/buffers.py``
``store_recompute``) against the JAX package's.

Every test of the reference's ``tests/test_store.py`` runs on the port's
store with the same assertions (crash-safe commits, highest-attempt
adoption, floor and revocation fencing, corruption quarantine with
fallback, tmp reaping, attempt pruning, the process handle).  Two
cross-package cases hold the on-disk format: a tree of INT32, INT64,
FLOAT64, BOOLEAN, STRING and DECIMAL columns in every skeleton container,
committed by one package, is adopted by the other bit for bit (decimal
limbs compared through a uint64 view), and both packages write the same
manifest and the same chunk bytes for it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import faultinj as jfault
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.shuffle.store import ShuffleStore as JStore

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch.columnar import types as T
from spark_rapids_jni_tpu_torch.columnar.column import Column, ColumnBatch
from spark_rapids_jni_tpu_torch.mem.spill import _flatten, _flip_file_bytes
from spark_rapids_jni_tpu_torch.shuffle import store as store_mod
from spark_rapids_jni_tpu_torch.shuffle.buffers import store_recompute
from spark_rapids_jni_tpu_torch.shuffle.store import ShuffleStore

from torch_parity import assert_col_equal, jdecimal, to_port, unscaled
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinj.configure(None)
    jfault.configure(None)
    store_mod.shutdown_store()
    config.reset()


def _batch(seed: int, n: int = 32) -> ColumnBatch:
    vals = (np.arange(n, dtype=np.int64) * (seed + 7)) % 9973
    return ColumnBatch({"v": Column(torch.from_numpy(vals),
                                    torch.ones(n, dtype=torch.bool),
                                    T.INT64)})


def _tree(seed: int):
    # one of each skeleton container plus a batch: the codec's closed set
    return (_batch(seed), {"counts": torch.arange(8, dtype=torch.int32),
                           "tag": f"t{seed}", "none": None},
            [seed, float(seed) / 2, True])


def _leaves(tree) -> list:
    out: list = []
    _flatten(tree, out)
    return out


def _leaves_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _adopt(st, key, shard):
    return st.adopt(key, shard, device=CPU)


# ---------------------------------------------------------------------------
# TestCommitAdopt
# ---------------------------------------------------------------------------

def test_round_trip_bit_exact(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=1)
    tree = _tree(3)
    assert st.put("q1", "map", tree)
    assert st.has_committed("q1", "map")
    got = _adopt(st, "q1", "map")
    assert got is not None and _leaves_equal(tree, got)
    # scalars and structure survive, not just array payloads
    assert got[1]["tag"] == "t3" and got[1]["none"] is None
    assert got[2] == [3, 1.5, True]
    assert got[0]["v"].dtype == T.INT64
    assert all(x.device.type == CPU for x in _leaves(got))
    assert st.snapshot()["commits"] == 1
    assert st.snapshot()["adoptions"] == 1


def test_same_epoch_put_is_idempotent(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=1)
    assert st.put("q", "map", _tree(1))
    assert st.put("q", "map", _tree(1))  # already committed: no-op
    assert st.snapshot()["commits"] == 1


def test_adoption_prefers_highest_attempt(tmp_path):
    ShuffleStore(str(tmp_path), epoch=1).put("q", "map", _tree(1))
    ShuffleStore(str(tmp_path), epoch=4).put("q", "map", _tree(4))
    st = ShuffleStore(str(tmp_path), epoch=0, max_attempts=0)
    assert st.attempts("q", "map") == [4, 1]
    assert _leaves_equal(_adopt(st, "q", "map"), _tree(4))


def test_miss_returns_none(tmp_path):
    st = ShuffleStore(str(tmp_path))
    assert _adopt(st, "nope", "map") is None
    assert not st.has_committed("nope", "map")
    assert st.snapshot()["adoption_misses"] == 1


@pytest.mark.parametrize(
    "tree", [object(), (torch.zeros(4, dtype=torch.bfloat16),)],
    ids=["object", "bfloat16"])
def test_unstorable_tree_fails_softly(tmp_path, tree):
    st = ShuffleStore(str(tmp_path), epoch=1)
    assert not st.put("q", "map", tree)
    assert st.snapshot()["commit_failures"] == 1
    assert not st.has_committed("q", "map")


def test_adopt_defaults_to_the_gpu(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=1)
    assert st.put("q", "map", _tree(1))
    if torch.cuda.is_available():
        assert _leaves(st.adopt("q", "map"))[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            st.adopt("q", "map")


# ---------------------------------------------------------------------------
# TestCrashSafety
# ---------------------------------------------------------------------------

def test_injected_commit_fault_tears_the_write(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=2)
    faultinj.configure({"faults": [
        {"match": "store_commit", "fault": "store_commit", "count": 1}]})
    assert not st.put("q", "map", _tree(1))
    # nothing committed, nothing adoptable: only a tmp remnant
    assert not st.has_committed("q", "map")
    assert _adopt(st, "q", "map") is None
    assert st.snapshot()["commit_failures"] == 1
    # the reaper clears exactly the torn remnant, by epoch
    assert st.reap_uncommitted(epoch=2) >= 1
    assert st.reap_uncommitted(epoch=2) == 0
    # and the retry (fault exhausted) commits cleanly
    assert st.put("q", "map", _tree(1))
    assert _leaves_equal(_adopt(st, "q", "map"), _tree(1))


@pytest.mark.parametrize("codec", ["off", "block"])
def test_injected_corruption_is_caught_by_crc(tmp_path, codec):
    config.set("spill_codec", codec)
    st = ShuffleStore(str(tmp_path), epoch=1)
    faultinj.configure({"faults": [
        {"match": "store_corrupt_file", "fault": "store_corrupt",
         "count": 1}]})
    # the put "succeeds": the damage is post-commit, like a bad disk
    assert st.put("q", "map", _tree(1))
    faultinj.configure(None)
    # adoption's verification quarantines it; no wrong answer
    assert _adopt(st, "q", "map") is None
    assert st.snapshot()["corrupt_quarantined"] == 1
    assert not st.has_committed("q", "map")


def test_corrupt_attempt_falls_back_to_older(tmp_path):
    ShuffleStore(str(tmp_path), epoch=1).put("q", "map", _tree(1))
    ShuffleStore(str(tmp_path), epoch=2).put("q", "map", _tree(2))
    st = ShuffleStore(str(tmp_path), max_attempts=0)
    # flip bytes in the NEWEST attempt's payload
    newest = os.path.join(str(tmp_path), "q", "shard-map",
                          "attempt-00000002")
    chunk = sorted(f for f in os.listdir(newest)
                   if f.startswith("chunk-"))[0]
    _flip_file_bytes(os.path.join(newest, chunk))
    got = _adopt(st, "q", "map")
    # the damaged attempt was quarantined and the older one adopted
    assert _leaves_equal(got, _tree(1))
    assert st.snapshot()["corrupt_quarantined"] == 1
    assert st.attempts("q", "map") == [1]
    left = os.listdir(os.path.join(str(tmp_path), "q", "shard-map"))
    assert any(e.startswith(".quarantine-") for e in left)


# ---------------------------------------------------------------------------
# TestFencing
# ---------------------------------------------------------------------------

def test_floor_stamp_fences_older_generations(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=2)
    st.stamp(5)
    assert st.fence() == 5
    assert st.fenced(2) and not st.fenced(5)
    assert not st.put("q", "map", _tree(1))
    assert st.snapshot()["fenced_commits"] == 1
    assert not st.has_committed("q", "map")


def test_stamp_is_monotonic(tmp_path):
    st = ShuffleStore(str(tmp_path))
    assert st.stamp(5) == 5
    assert st.stamp(3) == 5


def test_revoke_fences_exactly_one_generation(tmp_path):
    zombie = ShuffleStore(str(tmp_path), epoch=2)
    live = ShuffleStore(str(tmp_path), epoch=1)
    zombie.revoke(2)
    # the zombie's late commit can never become visible...
    assert not zombie.put("q", "map", _tree(2))
    assert zombie.snapshot()["fenced_commits"] == 1
    assert not zombie.has_committed("q", "map")
    # ...while a LIVE lower generation still commits (a floor threshold
    # could not express this)
    assert live.put("q", "map", _tree(1))
    assert _leaves_equal(_adopt(live, "q", "map"), _tree(1))
    assert live.revoked() == [2]


def test_fence_handoff_revokes_raises_floor_and_reaps(tmp_path):
    dead = ShuffleStore(str(tmp_path), epoch=3)
    faultinj.configure({"faults": [
        {"match": "store_commit", "fault": "store_commit", "count": 1}]})
    assert not dead.put("q", "map", _tree(3))  # a torn tmp of epoch 3
    faultinj.configure(None)
    sup = ShuffleStore(str(tmp_path), epoch=4)
    got = sup.fence_handoff([3], floor=2)
    assert got == {"revoked": [3], "floor": 2, "reaped_uncommitted": 1}
    assert sup.fenced(3) and sup.fenced(1) and not sup.fenced(2)
    assert not dead.put("q", "map", _tree(3))


# ---------------------------------------------------------------------------
# TestJanitorial
# ---------------------------------------------------------------------------

def test_prune_keeps_newest_attempts(tmp_path):
    for e in (1, 2, 3):
        ShuffleStore(str(tmp_path), epoch=e,
                     max_attempts=2).put("q", "map", _tree(e))
    st = ShuffleStore(str(tmp_path), max_attempts=0)
    assert st.attempts("q", "map") == [3, 2]


def test_max_attempts_knob_drives_prune(tmp_path):
    config.set("shuffle_store_max_attempts", 1)
    for e in (1, 2):
        ShuffleStore(str(tmp_path), epoch=e).put("q", "map", _tree(e))
    st = ShuffleStore(str(tmp_path), max_attempts=0)
    assert st.attempts("q", "map") == [2]


def test_reap_all_epochs(tmp_path):
    st = ShuffleStore(str(tmp_path), epoch=1)
    faultinj.configure({"faults": [
        {"match": "store_commit", "fault": "store_commit", "count": 2}]})
    assert not st.put("q", "a", _tree(1))
    assert not st.put("q", "b", _tree(2))
    faultinj.configure(None)
    assert st.reap_uncommitted() == 2
    assert st.snapshot()["reaped_uncommitted"] == 2


# ---------------------------------------------------------------------------
# TestProcessHandle
# ---------------------------------------------------------------------------

def test_install_requires_a_root():
    config.set("shuffle_store_dir", "")
    with pytest.raises(ValueError):
        store_mod.install()


def test_get_store_lazily_reads_the_knob(tmp_path):
    store_mod.shutdown_store()
    assert store_mod.get_store() is None
    config.set("shuffle_store_dir", str(tmp_path))
    st = store_mod.get_store()
    assert st is not None and st.root == str(tmp_path)
    assert store_mod.get_store() is st
    assert store_mod.install(epoch=3).epoch == 3
    assert store_mod.get_store() is not st


# ---------------------------------------------------------------------------
# TestStoreRecompute
# ---------------------------------------------------------------------------

def test_adopts_before_rebuilding():
    events = []
    fn = store_recompute(lambda: "from-store", lambda: "rebuilt",
                         on_adopt=lambda: events.append("adopt"),
                         on_rebuild=lambda: events.append("rebuild"))
    assert fn() == "from-store"
    assert events == ["adopt"]


def test_miss_and_failure_fall_through_to_lineage():
    events = []

    def boom():
        raise OSError("store offline")

    fn = store_recompute(boom, lambda: "rebuilt",
                         on_rebuild=lambda: events.append("rebuild"))
    # a store FAILURE is swallowed: the durable tier may speed recovery
    # up but must never become a new way to lose a query
    assert fn() == "rebuilt"
    fn2 = store_recompute(lambda: None, lambda: "rebuilt")
    assert fn2() == "rebuilt"
    assert events == ["rebuild"]


# ---------------------------------------------------------------------------
# across the two packages: one format
# ---------------------------------------------------------------------------

def _jtrees(n=24):
    """The same tree in both packages: INT32, INT64, FLOAT64, BOOLEAN,
    STRING and DECIMAL columns in a batch, inside a tuple with a dict
    (a bare leaf, a scalar, None) and a list of scalars."""
    rng = np.random.default_rng(13)
    ok = rng.random(n) > 0.2
    names = [None if not ok[i] else f"s{int(x)}"
             for i, x in enumerate(rng.integers(0, 999, n))]
    jb = JBatch({
        "i32": JColumn(jnp.asarray(rng.integers(-9, 9, n), jnp.int32),
                       jnp.asarray(ok), JT.INT32),
        "i64": JColumn(jnp.asarray(rng.integers(-1 << 40, 1 << 40, n)),
                       jnp.asarray(ok), JT.INT64),
        "f64": JColumn(jnp.asarray(rng.standard_normal(n)),
                       jnp.ones(n, jnp.bool_), JT.FLOAT64),
        "b": JColumn(jnp.asarray(rng.random(n) > 0.5), jnp.asarray(ok),
                     JT.BOOLEAN),
        "s": JString.from_pylist(names, max_len=8),
        "d": jdecimal(unscaled(rng, n, 20), 20, 2)})
    counts = rng.integers(0, 99, (4, 4)).astype(np.int64)
    jtree = (jb, {"counts": jnp.asarray(counts), "tag": "x", "none": None},
             [7, 0.5, False])
    ttree = (to_port(jb), {"counts": torch.from_numpy(counts), "tag": "x",
                           "none": None}, [7, 0.5, False])
    return jtree, ttree


def _same_batch(jb, tb):
    """Every column equal bit for bit; decimal limbs through a view (the
    reference holds uint64, the port int64)."""
    assert list(jb.names) == list(tb.names)
    for name in jb.names:
        jc, tc = jb[name], tb[name]
        assert np.asarray(jc.validity).tobytes() == \
            tc.validity.numpy().tobytes(), name
        if name == "d":
            assert repr(jc.dtype) == repr(tc.dtype)
            assert np.asarray(jc.limbs).view(np.uint64).tobytes() == \
                tc.limbs.numpy().view(np.uint64).tobytes()
        else:
            assert_col_equal(jc, tc, msg=name)


@pytest.fixture(scope="module")
def trees():
    return _jtrees()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_adoption_across_packages(tmp_path, trees, writer):
    jtree, ttree = trees
    if writer == "reference":
        assert JStore(str(tmp_path), epoch=1).put("q", "map", jtree)
        got = ShuffleStore(str(tmp_path)).adopt("q", "map", device=CPU)
        _same_batch(jtree[0], got[0])
        assert got[0]["d"].limbs.dtype == torch.int64
        assert torch.equal(got[1]["counts"], ttree[1]["counts"])
        assert (got[1]["tag"], got[1]["none"], got[2]) == \
            ("x", None, [7, 0.5, False])
    else:
        assert ShuffleStore(str(tmp_path), epoch=1).put("q", "map", ttree)
        got = JStore(str(tmp_path)).adopt("q", "map")
        _same_batch(got[0], ttree[0])
        # the port stores the limbs as it holds them: int64, same bits
        assert np.array_equal(np.asarray(got[0]["d"].limbs).view(np.uint64),
                              np.asarray(jtree[0]["d"].limbs))
        assert np.array_equal(np.asarray(jax.device_get(got[1]["counts"])),
                              ttree[1]["counts"].numpy())
        assert (got[1]["tag"], got[1]["none"], got[2]) == \
            ("x", None, [7, 0.5, False])


def test_both_packages_write_one_format(tmp_path, trees):
    jtree, ttree = trees
    jroot, troot = tmp_path / "ref", tmp_path / "port"
    assert JStore(str(jroot), epoch=3).put("q", "roundp-0", jtree)
    assert ShuffleStore(str(troot), epoch=3).put("q", "roundp-0", ttree)
    for st in (JStore(str(jroot)), ShuffleStore(str(troot))):
        st.stamp(2)
        st.revoke(1)
    entry = os.path.join("q", "shard-roundp-0", "attempt-00000003")
    jdir, tdir = jroot / entry, troot / entry
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    # manifests equal: skeleton, per-chunk (crc32, nbytes), epoch, key
    assert (jdir / "manifest.json").read_text() == \
        (tdir / "manifest.json").read_text()
    assert (jroot / "FENCE").read_text() == (troot / "FENCE").read_text()
    # every chunk file is the same bytes but the decimal limbs' npy
    # header (uint64 in the reference, int64 in the port)
    limbs = 0
    for f in sorted(os.listdir(jdir)):
        if not f.startswith("chunk-"):
            continue
        a, b = np.load(jdir / f), np.load(tdir / f)
        assert a.tobytes() == b.tobytes(), f
        if a.dtype == np.uint64:
            assert b.dtype == np.int64
            limbs += 1
        else:
            assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    assert limbs == 1
