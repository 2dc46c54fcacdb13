"""PyTorch port: the tiered spill store (``mem/spill.py``, ``mem/codec.py``,
``faultinj.py``) and its hooks against the JAX package's.

* Codec frames: byte-identical to the reference's in both directions for
  int, run, bool, float and random-byte leaves under every codec.
* Every scenario of the reference's ``tests/test_spill.py`` on the port;
  the end-to-end oversubscription scenario runs in BOTH packages and
  their ``SpillMetrics`` snapshots must be equal (``eviction_ns`` aside:
  it is a time).
* The codec'd tier walk (``tests/test_compressed.py``), every column kind
  of the port through device -> host -> disk with its ``dict_token``
  (``tests/test_encoded.py`` ``TestSpillEncoded``), a tree with an
  aliased validity whose byte counts equal the reference's, injected
  host and disk corruption with and without lineage, and the fault
  injector against the reference's on one schedule.
* The hooks: spill-registered build tables with joins equal to the
  reference's (``tests/test_shuffle_service.py`` ``TestSpillableBuildTable``),
  the plan's broadcast tables (``tests/test_plan.py``
  ``TestBuildTablePinning``), and both exchanges on ``ShardMesh(8)``
  under an arena smaller than their buffers (``TestOutOfCore``), each
  bit-identical to the same exchange without spill.

Small shapes throughout: the file runs in well under 30 s alone.
"""

import os
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import faultinj as jfault
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.mem import RmmSpark as JRmmSpark
from spark_rapids_jni_tpu.mem import SpillableHandle as JHandle
from spark_rapids_jni_tpu.mem import TaskContext as JTaskContext
from spark_rapids_jni_tpu.mem import ThreadStateRegistry as JTSR
from spark_rapids_jni_tpu.mem import codec as jcodec
from spark_rapids_jni_tpu.mem import run_with_retry as jrun_with_retry
from spark_rapids_jni_tpu.mem import spill as jspill
from spark_rapids_jni_tpu.relational import hash_join as jhash_join
from spark_rapids_jni_tpu.relational import \
    spillable_build_table as jspillable_build_table

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch import plan as tplan
from spark_rapids_jni_tpu_torch.columnar import types as T
from spark_rapids_jni_tpu_torch.columnar.bucketed import BucketedStringColumn
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column, ColumnBatch, Decimal128Column, ListColumn, StringColumn,
    StructColumn, batch_from_numpy)
from spark_rapids_jni_tpu_torch.columnar.encoded import (
    BitPackedColumn, DictionaryColumn, FrameOfReferenceColumn,
    RunLengthColumn, encode_batch)
from spark_rapids_jni_tpu_torch.mem import (
    RetryOOM, RmmSpark, Spillable, SpillableHandle, TaskContext,
    ThreadStateRegistry, batch_nbytes, codec, run_with_retry)
from spark_rapids_jni_tpu_torch.mem import spill as spill_mod
from spark_rapids_jni_tpu_torch.parallel import (broadcast_build_handle,
                                                 distributed_broadcast_join)
from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
from spark_rapids_jni_tpu_torch.plan import queries as tq
from spark_rapids_jni_tpu_torch.relational import (hash_join,
                                                   spillable_build_table)
from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                ShuffleService, get_registry)

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

MB = 1 << 20
KB = 1 << 10
P8 = 8
SPILL_KNOBS = ("spill_codec", "spill_checksum", "join_engine",
               "shuffle_capacity_bucket", "shuffle_max_recoveries")


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with no schedule and default knobs."""
    yield
    faultinj.configure({})
    jfault.configure({})
    for k in SPILL_KNOBS:
        config.reset(k)


@pytest.fixture
def framework(tmp_path):
    fw = spill_mod.install(spill_dir=str(tmp_path / "spill"))
    yield fw
    spill_mod.shutdown()


@pytest.fixture
def adaptor():
    a = RmmSpark.set_event_handler(2 * MB, host_pool_bytes=512 * KB,
                                   poll_ms=10.0)
    yield a
    RmmSpark.clear_event_handler()


def _words(n_words, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 20, n_words,
                                                dtype=np.int32)


def _tree(n_words, seed=0):
    """A tree of n_words int32 (4 * n_words bytes)."""
    return {"x": torch.from_numpy(_words(n_words, seed))}


def _spill_files(fw):
    return [f for f in os.listdir(fw.spill_dir)
            if os.path.isfile(os.path.join(fw.spill_dir, f))]


# ---------------------------------------------------------------------------
# codec frames: byte-identical to the reference's, both directions
# ---------------------------------------------------------------------------

def _leaf(kind):
    rng = np.random.default_rng(17)
    if kind == "int":
        return rng.integers(0, 4096, 5000).astype(np.int64)
    if kind == "runs":
        return np.repeat(rng.integers(-9, 9, 64), 300).astype(np.int32)
    if kind == "bool":
        return rng.random(5000) < 0.3
    if kind == "float":
        return rng.standard_normal(4096)
    return rng.integers(0, 256, 70000, dtype=np.uint8)  # random bytes


@pytest.mark.parametrize("codec_name", ["raw", "pack", "block"])
@pytest.mark.parametrize("kind", ["int", "runs", "bool", "float", "bytes"])
def test_codec_frames_byte_identical(kind, codec_name):
    arr = _leaf(kind)
    port = codec.encode_block(arr, codec_name)
    ref = jcodec.encode_block(arr, codec_name)
    assert port.dtype == np.uint8 and port.tobytes() == ref.tobytes()
    assert codec.codec_name(port) == jcodec.codec_name(ref)
    for dec, frame in ((codec.decode_block, ref),
                       (jcodec.decode_block, port)):
        got = dec(frame)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert got.tobytes() == arr.tobytes()


def test_codec_pack_lanes_match_reference():
    rng = np.random.default_rng(3)
    for width in (1, 3, 7, 13, 31, 32):
        words = rng.integers(0, 1 << width, 777, dtype=np.uint64)
        words = words.astype(np.uint32)
        lanes = codec.np_pack_bits(words, width)
        assert np.array_equal(lanes, jcodec.np_pack_bits(words, width))
        assert np.array_equal(codec.np_unpack_bits(lanes, width, 777),
                              words)


def test_codec_garbage_and_damaged_headers_rejected():
    junk = np.frombuffer(b"not a SRCK frame at all" * 4, np.uint8).copy()
    with pytest.raises(codec.CodecError):
        codec.decode_block(junk)
    frame = codec.encode_block(_leaf("int"), "pack")
    bad = frame.copy()
    bad[4] ^= 0xFF  # the version byte
    with pytest.raises(codec.CodecError):
        codec.decode_block(bad)
    with pytest.raises(codec.CodecError):
        codec.decode_block(frame[:-5])  # truncated lanes


class TestSpillCodecTierWalk:
    def test_invalid_knob_rejected(self, framework):
        config.set("spill_codec", "bogus")
        h = SpillableHandle({"x": torch.arange(64, dtype=torch.int32)},
                            name="bad")
        h.spill()
        with pytest.raises(ValueError, match="spill_codec"):
            h.spill_host()
        h.close()

    @pytest.mark.parametrize("codec_name", ["pack", "block"])
    def test_three_tier_round_trip_shrinks_disk(self, framework,
                                                codec_name):
        config.set("spill_codec", codec_name)
        rng = np.random.default_rng(23)
        want = {"k": np.repeat(rng.integers(0, 16, 512), 16).astype(
                    np.int64),
                "v": rng.integers(0, 200, 4096).astype(np.int64)}
        h = SpillableHandle({n: torch.from_numpy(a.copy())
                             for n, a in want.items()},
                            name=f"codec-{codec_name}")
        h.spill()
        h.spill_host()
        assert h.tier == "disk"
        got = h.get()
        for n, a in want.items():
            assert np.array_equal(got[n].numpy(), a)
        m = framework.metrics.snapshot()
        assert m["precompress_bytes"] > m["compressed_bytes"] > 0
        assert m["codec_ratio"] > 1.0
        h.close()

    def test_disk_damage_detected_before_decode(self, framework):
        config.set("spill_codec", "pack")
        faultinj.configure({"faults": [
            {"match": "spill_corrupt_file", "fault": "spill_corrupt",
             "count": 1}]})
        h = SpillableHandle({"x": torch.arange(4096, dtype=torch.int64)},
                            name="dmg")
        h.spill()
        h.spill_host()
        with pytest.raises(faultinj.SpillCorruptionError):
            h.get()
        h.close()

    def test_damage_recovers_via_lineage(self, framework):
        config.set("spill_codec", "pack")

        def make():
            return {"x": torch.from_numpy(
                np.random.default_rng(29).integers(0, 50, 4096))}

        want = make()["x"]
        faultinj.configure({"faults": [
            {"match": "spill_corrupt_file", "fault": "spill_corrupt",
             "count": 1}]})
        h = SpillableHandle(make(), name="heal", recompute=make)
        h.spill()
        h.spill_host()
        assert torch.equal(h.get()["x"], want)  # detect, discard, rebuild
        assert h.lineage_rebuilds == 1
        h.close()

    def test_codec_off_keeps_raw_disk_bytes(self, framework):
        config.set("spill_codec", "off")
        h = SpillableHandle({"x": torch.arange(1024, dtype=torch.int64)},
                            name="raw")
        h.spill()
        h.spill_host()
        assert np.load(os.path.join(framework.spill_dir, "raw-0.npy"),
                       allow_pickle=False).tolist() == list(range(1024))
        assert torch.equal(h.get()["x"], torch.arange(1024))
        m = framework.metrics.snapshot()
        assert m["compressed_bytes"] == 0 and m["codec_ratio"] == 1.0
        h.close()


# ---------------------------------------------------------------------------
# tests/test_spill.py on the port
# ---------------------------------------------------------------------------

class TestTierWalk:
    def test_device_host_disk_roundtrip_exact_metrics(self, framework):
        h = SpillableHandle(_tree(256), name="walk")
        want = h.get()["x"].clone()
        h.spill()
        assert h.tier == "host"
        h.spill_host()
        assert h.tier == "disk"
        assert len(_spill_files(framework)) == 1
        got = h.get()["x"]
        assert h.tier == "device" and torch.equal(got, want)
        assert got.dtype == torch.int32 and got.device == want.device
        assert _spill_files(framework) == []  # read-back deletes the file
        m = framework.metrics.snapshot()
        for t in ("device_to_host", "host_to_disk", "disk_to_host",
                  "host_to_device"):
            assert m[t + "_bytes"] == 1024 and m[t + "_count"] == 1
        assert m["eviction_ns"] > 0
        h.close()
        assert h.tier == "closed" and len(framework.store) == 0

    def test_close_cleans_disk_files(self, framework):
        h = SpillableHandle(_tree(64), name="cleanup")
        h.spill()
        h.spill_host()
        assert len(_spill_files(framework)) == 1
        h.close()
        assert _spill_files(framework) == []
        with pytest.raises(ValueError):
            h.get()

    def test_spill_is_idempotent(self, framework):
        h = SpillableHandle(_tree(64))
        assert h.spill() == 0  # uncharged (no ctx): moved, freed 0
        assert h.tier == "host"
        assert h.spill() == 0
        assert framework.metrics.snapshot()["device_to_host_count"] == 1
        h.close()

    def test_spill_frees_the_tensors(self, framework):
        """Nothing else holds the tree: the spill frees its tensors (the
        CPU analogue of the card's ``memory_allocated`` check)."""
        t = torch.arange(4096, dtype=torch.int64)
        ref = weakref.ref(t)
        h = SpillableHandle({"x": t}, name="free")
        del t
        assert ref() is not None
        h.spill()
        assert ref() is None
        assert torch.equal(h.get()["x"], torch.arange(4096))
        h.close()

    def test_unsupported_dtype_raises_before_moving(self, framework):
        h = SpillableHandle({"x": torch.zeros(8, dtype=torch.bfloat16)})
        with pytest.raises(TypeError, match="bfloat16"):
            h.spill()
        assert h.tier == "device"
        h.close()

    def test_host_leaves_round_trip_with_reference(self, framework,
                                                   tmp_path):
        """``from_host_leaves``/``read_host`` (the store's entry point)
        hold the same bytes and CRCs as the reference's."""
        leaves = [_words(300, 1), np.arange(10, dtype=np.float64)]
        jfw = jspill.install(spill_dir=str(tmp_path / "ref"))
        try:
            jh = JHandle.from_host_leaves(leaves, name="blob")
            h = SpillableHandle.from_host_leaves(leaves, name="blob",
                                                 device="cpu")
            assert h._host_meta == jh._host_meta
            h.spill_host()
            jh.spill_host()
            assert h.tier == jh.tier == "disk"
            for got, want in zip(h.read_host(), jh.read_host()):
                assert got.tobytes() == np.asarray(want).tobytes()
            assert [t.numpy().tobytes() for t in h.get()] == \
                [a.tobytes() for a in leaves]
            jh.close()
        finally:
            jspill.shutdown()
        assert not jfw.store.handles()


class TestChargedTiers:
    def test_spill_releases_device_charge_get_recharges(self, framework,
                                                        adaptor):
        with TaskContext(1) as ctx:
            h = SpillableHandle(_tree(64 * KB // 4), ctx=ctx)
            nbytes = 64 * KB
            assert adaptor.total_allocated() == nbytes
            assert h.spill() == nbytes
            assert adaptor.total_allocated() == 0
            assert adaptor.host_total_allocated() == nbytes
            h.get()
            assert adaptor.total_allocated() == nbytes
            assert adaptor.host_total_allocated() == 0
            h.close()
            assert adaptor.total_allocated() == 0
        RmmSpark.task_done(1)

    def test_host_pressure_demotes_lru_to_disk(self, framework, adaptor):
        with TaskContext(1) as ctx:
            hs = [SpillableHandle(_tree(n * KB // 4, seed=s), ctx=ctx,
                                  name=f"h{s}")
                  for s, n in ((1, 200), (2, 200), (3, 300))]
            for h in hs:
                h.spill()  # the third pushes the coldest (h1) to disk
            assert [h.tier for h in hs] == ["disk", "host", "host"]
            assert framework.metrics.snapshot()["host_to_disk_bytes"] == \
                200 * KB
            assert adaptor.host_total_allocated() == 500 * KB
            for h, (s, n) in zip(hs, ((1, 200), (2, 200), (3, 300))):
                assert np.array_equal(h.get()["x"].numpy(),
                                      _words(n * KB // 4, s))
                h.close()
        RmmSpark.task_done(1)

    def test_batch_bigger_than_host_pool_goes_straight_to_disk(
            self, framework, adaptor):
        with TaskContext(1) as ctx:
            h = SpillableHandle(_tree(MB // 4), ctx=ctx)  # 1M > 512K
            h.spill()
            assert h.tier == "disk"
            assert adaptor.host_total_allocated() == 0
            m = framework.metrics.snapshot()
            assert m["device_to_host_bytes"] == m["host_to_disk_bytes"] == MB
            h.close()
        RmmSpark.task_done(1)


class TestStorePriority:
    def test_lru_order_and_task_awareness(self, framework):
        hs = []
        for name, task in (("a", 1), ("b", 2), ("c", 2)):
            h = SpillableHandle(_tree(64), name=name)
            h.task_id = task
            hs.append(h)
        hs[0].get()
        assert framework.spill_to_fit(requesting_task_id=1) == 0
        assert all(h.tier == "host" for h in hs)
        for h in hs:
            h.close()

    def test_eviction_order_other_tasks_lru_first(self, framework):
        order, hs = [], []
        for name, task, use in (("own-cold", 1, 1), ("other-new", 2, 3),
                                ("other-old", 2, 2)):
            h = SpillableHandle(_tree(16), name=name)
            h.task_id = task
            h._last_use = use
            orig = h.spill
            h.spill = (lambda o=orig, n=name: (order.append(n), o())[1])
            hs.append(h)
        framework.spill_to_fit(requesting_task_id=1)
        assert order == ["other-old", "other-new", "own-cold"]
        for h in hs:
            h.close()

    def test_task_priority_orders_other_tasks(self, framework):
        order, hs = [], []
        for name, task in (("low", 3), ("high", 2)):
            h = SpillableHandle(_tree(16), name=name)
            h.task_id = task
            orig = h.spill
            h.spill = (lambda o=orig, n=name: (order.append(n), o())[1])
            hs.append(h)
        framework.store.set_task_priority(2, 5.0)
        framework.spill_to_fit(requesting_task_id=1)
        assert order == ["low", "high"]
        framework.store.clear_task_priority(2)
        for h in hs:
            h.close()

    def test_pinned_handles_are_skipped(self, framework):
        h = SpillableHandle(_tree(64), name="pinned")
        with h.pinned():
            framework.spill_to_fit()
            assert h.tier == "device"
        framework.spill_to_fit()
        assert h.tier == "host"
        h.close()

    def test_spill_to_fit_stops_at_nbytes(self, framework, adaptor):
        with TaskContext(1) as ctx:
            h1 = SpillableHandle(_tree(64 * KB // 4), ctx=ctx, name="old")
            h2 = SpillableHandle(_tree(64 * KB // 4), ctx=ctx, name="new")
            h2.get()  # h1 is LRU
            assert framework.spill_to_fit(1) == 64 * KB
            assert h1.tier != "device" and h2.tier == "device"
            h1.close()
            h2.close()
        RmmSpark.task_done(1)


class TestSpillGetRace:
    def test_spill_while_getting_keeps_data_intact(self, framework):
        h = SpillableHandle(_tree(4096, seed=9), name="race")
        want = h.get()["x"].clone()
        stop = threading.Event()
        errors = []

        def evictor():
            while not stop.is_set():
                try:
                    h.spill()
                    h.spill_host()
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)
                    return

        t = threading.Thread(target=evictor, daemon=True)
        t.start()
        try:
            for _ in range(300):
                assert torch.equal(h.get()["x"], want)
        finally:
            stop.set()
            t.join(timeout=10.0)
        assert not errors, errors
        h.close()

    def test_busy_handle_is_skipped_not_deadlocked(self, framework):
        h = SpillableHandle(_tree(64), name="busy")
        held, release = threading.Event(), threading.Event()

        def holder():  # the RLock is reentrant: another thread holds it
            h._lock.acquire()
            held.set()
            release.wait(10.0)
            h._lock.release()

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        assert held.wait(10.0)
        try:
            assert h.spill() == 0 and h.tier == "device"
        finally:
            release.set()
            t.join(timeout=10.0)
        h.spill()
        assert h.tier == "host"
        h.close()


class TestTaskContextIntegration:
    def test_exit_auto_closes_and_unregisters(self, framework, adaptor):
        with TaskContext(5) as ctx:
            SpillableHandle(_tree(64 * KB // 4), ctx=ctx)
            h2 = SpillableHandle(_tree(64 * KB // 4), ctx=ctx)
            h2.spill()
            h2.spill_host()
            assert len(framework.store) == 2
            assert len(_spill_files(framework)) == 1
        assert len(framework.store) == 0
        assert _spill_files(framework) == []
        assert adaptor.total_allocated() == 0
        assert adaptor.host_total_allocated() == 0
        RmmSpark.task_done(5)

    def test_columnbatch_spillable_helper(self, framework, adaptor):
        with TaskContext(6) as ctx:
            batch = TP.example_batch(256, device="cpu")
            h = batch.spillable(ctx)
            assert adaptor.total_allocated() == batch_nbytes(batch)
            h.spill()
            assert adaptor.total_allocated() == 0
            got = h.get()
            assert got.num_rows == 256 and got.names == batch.names
            assert torch.equal(got["v"].data, batch["v"].data)
        RmmSpark.task_done(6)


class TestSpillIOFault:
    def test_disk_write_fault_keeps_host_tier(self, framework, adaptor):
        faultinj.configure({"faults": [
            {"match": "spill_io_write", "fault": "spill_io", "count": 1}]})
        with TaskContext(7) as ctx:
            h = SpillableHandle(_tree(64 * KB // 4, seed=4), ctx=ctx)
            want = h.get()["x"].clone()
            h.spill()
            h.spill_host()  # injected SpillIOError
            assert h.tier == "host"
            assert adaptor.host_total_allocated() == 64 * KB
            assert _spill_files(framework) == []
            m = framework.metrics.snapshot()
            assert m["disk_write_failures"] == 1
            assert m["host_to_disk_count"] == 0
            h.spill_host()  # the injection is spent: now it works
            assert h.tier == "disk"
            assert torch.equal(h.get()["x"], want)
            h.close()
        RmmSpark.task_done(7)

    def test_disk_read_fault_rebuilds_or_raises(self, framework):
        faultinj.configure({"faults": [
            {"match": "spill_io_read", "fault": "spill_io", "count": 2}]})
        for lineage in (True, False):
            h = SpillableHandle(_tree(64, seed=5), name=f"rd{lineage}",
                                recompute=(lambda: _tree(64, seed=5))
                                if lineage else None)
            h.spill()
            h.spill_host()
            if lineage:
                assert np.array_equal(h.get()["x"].numpy(), _words(64, 5))
            else:
                with pytest.raises(faultinj.SpillCorruptionError):
                    h.get()
            h.close()
        assert framework.metrics.snapshot()["corrupt_reads"] == 2

    def test_fault_rules_validate(self):
        faultinj._Rule({"match": "spill_io_*", "fault": "spill_io"})
        with pytest.raises(ValueError):
            faultinj._Rule({"fault": "bogus"})  # graftlint: disable=GL006
        for kind, item in faultinj.UNPORTED_KINDS.items():
            assert kind in jfault.FAULT_KINDS
            with pytest.raises(NotImplementedError, match=f"item {item}"):
                faultinj._Rule({"fault": kind})
        # the exchange's and the shuffle store's kinds fire their own
        # errors, each an OSError as in the reference
        for kind, err in (("shuffle_io", faultinj.ShuffleIOError),
                          ("store_commit", faultinj.StoreCommitError),
                          ("store_corrupt", faultinj.StoreCorruptionError)):
            assert kind not in faultinj.UNPORTED_KINDS
            faultinj._Rule({"match": "p", "fault": kind})
            with faultinj.scope({"faults": [{"match": "p", "fault": kind}]}):
                with pytest.raises(err):
                    faultinj.instrument(lambda: None, "p")()
            assert issubclass(err, OSError)
            assert issubclass(getattr(jfault, err.__name__), OSError)
        assert set(faultinj.FAULT_KINDS) | set(faultinj.UNPORTED_KINDS) \
            == set(jfault.FAULT_KINDS)


class TestMetricsExport:
    def test_rmm_spark_surfaces(self, framework, adaptor):
        with TaskContext(9) as ctx:
            h = SpillableHandle(_tree(64 * KB // 4), ctx=ctx)
            h.spill()
            h.get()
            h.close()
        RmmSpark.task_done(9)
        assert RmmSpark.spill_metrics()["device_to_host_bytes"] == 64 * KB
        t = RmmSpark.get_and_reset_task_spill_metrics(9)
        assert t["device_to_host_bytes"] == t["host_to_device_bytes"] == \
            64 * KB
        assert sum(RmmSpark.get_and_reset_task_spill_metrics(9).values()) \
            == 0

    def test_zeros_without_framework(self):
        assert sum(RmmSpark.spill_metrics().values()) == 0


class TestLegacySpillableDelegates:
    def test_spillable_registers_with_store(self, framework, adaptor):
        with TaskContext(11) as ctx:
            s = Spillable(_tree(64), ctx)
            assert isinstance(s, SpillableHandle)
            assert len(framework.store) == 1
            framework.spill_to_fit(requesting_task_id=99)
            assert s.is_spilled
            s.close()
        RmmSpark.task_done(11)

    def test_retry_ladder_evicts_by_default(self, framework, adaptor):
        """With a framework installed a RetryOOM evicts through the store
        with no make_spillable wiring, and the retry does not park."""
        with TaskContext(12) as ctx:
            h = SpillableHandle(_tree(64), ctx=ctx, name="idle")
            calls = []

            def step():
                calls.append(1)
                if len(calls) == 1:
                    raise RetryOOM("injected")
                return "done"

            assert run_with_retry(step) == "done"
            assert h.tier == "host" and len(calls) == 2
        RmmSpark.task_done(12)


# ---------------------------------------------------------------------------
# the acceptance scenario, in both packages
# ---------------------------------------------------------------------------

NWORDS = 307200  # 1,228,800 bytes of int32

PORT_NS = dict(handle=SpillableHandle, ctx=TaskContext, retry=run_with_retry,
               rmm=RmmSpark, tsr=ThreadStateRegistry, spill=spill_mod,
               tree=lambda s: {"x": torch.from_numpy(_words(NWORDS, s))},
               host=lambda t: t["x"].numpy())
REF_NS = dict(handle=JHandle, ctx=JTaskContext, retry=jrun_with_retry,
              rmm=JRmmSpark, tsr=JTSR, spill=jspill,
              tree=lambda s: {"x": jnp.asarray(_words(NWORDS, s))},
              host=lambda t: np.asarray(t["x"]))


def _two_tasks(ns, spill_dir):
    """Task 1 holds an idle batch; task 2's RetryOOM evicts it device ->
    host -> disk with no make_spillable; task 1 reads it back."""
    rmm = ns["rmm"]
    adaptor = rmm.set_event_handler(2 * MB, host_pool_bytes=512 * KB,
                                    poll_ms=10.0)
    fw = ns["spill"].install(spill_dir=spill_dir)
    ready, done = threading.Event(), threading.Event()
    results, failures = {}, []

    def task_a():
        try:
            with ns["ctx"](1) as ctx:
                h = ns["handle"](ns["tree"](1), ctx=ctx, name="task1-batch")
                want = ns["host"](h.get()).copy()
                ready.set()
                with ns["tsr"].blocked_section():
                    if not done.wait(60.0):
                        raise TimeoutError("task 2 never finished")
                results["tier"] = h.tier
                got = ns["retry"](lambda: ns["host"](h.get()))
                results["a"] = bool((got == want).all())
        except BaseException as e:  # noqa: BLE001 - reported below
            failures.append(("a", e))

    def task_b():
        try:
            if not ready.wait(60.0):
                raise TimeoutError("task 1 never set up")
            with ns["ctx"](2) as ctx:
                def step():
                    h = ns["handle"](ns["tree"](2), ctx=ctx,
                                     name="task2-batch")
                    out = int(ns["host"](h.get()).sum())
                    h.close()
                    return out

                results["b"] = ns["retry"](step)
        except BaseException as e:  # noqa: BLE001 - reported below
            failures.append(("b", e))
        finally:
            done.set()

    try:
        threads = [threading.Thread(target=f, daemon=True)
                   for f in (task_a, task_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90.0)
        assert not any(t.is_alive() for t in threads), "deadlock"
        assert not failures, failures
        out = {"results": results, "snap": fw.metrics.snapshot(),
               "task1": rmm.get_and_reset_task_spill_metrics(1),
               "retries2": adaptor.get_and_reset_num_retry(2),
               "device_left": adaptor.total_allocated(),
               "host_left": adaptor.host_total_allocated(),
               "store_left": len(fw.store), "files": _spill_files(fw)}
        rmm.task_done(1)
        rmm.task_done(2)
        return out
    finally:
        ns["spill"].shutdown()
        rmm.clear_event_handler()


def test_two_tasks_oversubscribed_equal_metrics_in_both_packages(tmp_path):
    port = _two_tasks(PORT_NS, str(tmp_path / "port"))
    ref = _two_tasks(REF_NS, str(tmp_path / "ref"))
    nbytes = NWORDS * 4
    for got in (port, ref):
        assert got["results"]["tier"] == "disk"
        assert got["results"]["a"]
        assert got["results"]["b"] == int(_words(NWORDS, 2).sum())
        m = got["snap"]
        for t in ("device_to_host", "host_to_disk", "disk_to_host",
                  "host_to_device"):
            assert m[t + "_bytes"] == nbytes and m[t + "_count"] == 1
        assert m["disk_write_failures"] == 0
        assert got["task1"]["device_to_host_bytes"] == nbytes
        assert got["retries2"] >= 1
        assert (got["device_left"], got["host_left"], got["store_left"],
                got["files"]) == (0, 0, 0, [])
    drop = ("eviction_ns",)  # a time: the one field that may differ
    assert {k: v for k, v in port["snap"].items() if k not in drop} == \
        {k: v for k, v in ref["snap"].items() if k not in drop}
    assert {k: v for k, v in port["task1"].items() if k not in drop} == \
        {k: v for k, v in ref["task1"].items() if k not in drop}


# ---------------------------------------------------------------------------
# every column kind, aliasing, host corruption
# ---------------------------------------------------------------------------

def _all_kinds(seed=5):
    """One batch of every column kind the port carries; ``a`` and ``b``
    share one validity tensor."""
    rng = np.random.default_rng(seed)
    n = 256
    shared = torch.from_numpy(rng.random(n) > 0.1)
    words = [f"s{i % 9}" for i in rng.integers(0, 9, n)]
    plain = ColumnBatch({
        "s": StringColumn.from_pylist(words, max_len=4, device="cpu"),
        "r": Column(torch.from_numpy(np.sort(rng.integers(0, 6, n))
                                     .astype(np.int32)),
                    torch.ones(n, dtype=torch.bool), T.INT32),
        "p": Column(torch.from_numpy(rng.integers(100, 160, n)),
                    torch.ones(n, dtype=torch.bool), T.INT64),
        "f": Column(torch.from_numpy(rng.integers(0, 1 << 20, n)),
                    torch.ones(n, dtype=torch.bool), T.INT64)})
    enc = encode_batch(plain, dictionary=["s"], rle=["r"], bitpack=["p"],
                       frame_of_reference=["f"])
    limbs = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, (n, 2)))
    child = Column(torch.from_numpy(rng.integers(0, 9, 2 * n)),
                   torch.ones(2 * n, dtype=torch.bool), T.INT64)
    cols = dict(zip(enc.names, enc.columns))
    cols.update({
        "a": Column(torch.from_numpy(rng.integers(0, 99, n)), shared,
                    T.INT64),
        "b": Column(torch.from_numpy(rng.random(n)), shared, T.FLOAT64),
        "d": Decimal128Column(limbs, torch.ones(n, dtype=torch.bool),
                              T.SparkType.decimal(38, 2)),
        "l": ListColumn(torch.arange(0, 2 * n + 1, 2, dtype=torch.int32),
                        child, torch.ones(n, dtype=torch.bool)),
        "st": StructColumn({"x": child_col(rng, n), "y": child_col(rng, n)},
                           torch.ones(n, dtype=torch.bool))})
    bucketed = BucketedStringColumn.from_pylist(
        words + ["a-much-longer-string"], device="cpu")
    return {"batch": ColumnBatch(cols), "bucketed": bucketed,
            "tail": (torch.tensor(3), [shared])}


def child_col(rng, n):
    return Column(torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
                  torch.ones(n, dtype=torch.bool), T.INT32)


def _same_tree(got, want, structure=True):
    """Equal tensors (dtype, device, values) in walk order and, with
    ``structure``, an equal structure (types, tokens, widths, zones)."""
    g, w = [], []
    g_spec, w_spec = spill_mod._flatten(got, g), spill_mod._flatten(want, w)
    if structure:
        assert g_spec == w_spec
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


class TestSpillEncoded:
    def test_every_column_kind_survives_three_tiers(self, framework):
        tree = _all_kinds()
        leaves = []
        spec = spill_mod._flatten(tree, leaves)
        want = spill_mod._unflatten(spec, iter([t.clone() for t in leaves]))
        h = SpillableHandle(tree, name="kinds")
        del tree, leaves
        h.spill()
        h.spill_host()
        assert h.tier == "disk"
        got = h.get()
        _same_tree(got, want)
        gb, wb = got["batch"], want["batch"]
        for name, kind in (("s", DictionaryColumn), ("r", RunLengthColumn),
                           ("p", BitPackedColumn),
                           ("f", FrameOfReferenceColumn)):
            assert isinstance(gb[name], kind), name
            assert gb[name].to_pylist() == wb[name].to_pylist()
        assert gb["s"].dict_token == wb["s"].dict_token > 0
        assert gb["p"].zone == wb["p"].zone
        assert isinstance(got["bucketed"], BucketedStringColumn)
        assert got["bucketed"].widths == want["bucketed"].widths
        # the shared validity comes back as ONE tensor
        assert gb["a"].validity is gb["b"].validity
        assert gb["a"].validity is got["tail"][1][0]
        h.close()

    def test_aliased_validity_counts_like_the_reference(self, framework,
                                                         tmp_path):
        rng = np.random.default_rng(8)
        n = 1000
        vals = [rng.integers(0, 99, n), rng.integers(0, 9, n)]
        valid = rng.random(n) > 0.2
        shared = torch.from_numpy(valid)
        port = ColumnBatch({
            f"c{i}": Column(torch.from_numpy(v), shared, T.INT64)
            for i, v in enumerate(vals)})
        jshared = jnp.asarray(valid)
        ref = JBatch({f"c{i}": JColumn(jnp.asarray(v), jshared, JT.INT64)
                      for i, v in enumerate(vals)})
        assert batch_nbytes(port) == 2 * 8 * n + n
        jfw = jspill.install(spill_dir=str(tmp_path / "ref"))
        try:
            jh = JHandle(ref, name="alias")
            jh.spill()
            jh.spill_host()
            jh.get()
            jsnap = jfw.metrics.snapshot()
            jh.close()
        finally:
            jspill.shutdown()
        h = SpillableHandle(port, name="alias")
        h.spill()
        h.spill_host()
        got = h.get()
        assert got["c0"].validity is got["c1"].validity
        snap = framework.metrics.snapshot()
        for k in snap:
            if k.endswith(("_bytes", "_count")):
                assert snap[k] == jsnap[k], k
        h.close()

    def test_host_corrupt_detected_loudly(self, framework):
        faultinj.configure({"faults": [
            {"match": "host_corrupt_probe", "fault": "host_corrupt",
             "count": 1}]})
        h = SpillableHandle(_all_kinds(), name="hc")
        h.spill()
        assert h.tier == "host"
        with pytest.raises(faultinj.HostCorruptionError):
            h.get()
        assert framework.metrics.snapshot()["corrupt_reads"] == 1
        h.close()

    def test_host_corrupt_recovers_via_lineage(self, framework):
        faultinj.configure({"faults": [
            {"match": "host_corrupt_probe", "fault": "host_corrupt",
             "count": 1}]})
        h = SpillableHandle(_all_kinds(7), name="hcr",
                            recompute=lambda: _all_kinds(7))
        h.spill()
        # the rebuild mints its own dictionary token: data equal
        _same_tree(h.get(), _all_kinds(7), structure=False)
        assert framework.metrics.snapshot()["corrupt_reads"] == 1
        assert h.lineage_rebuilds == 1
        h.close()

    def test_host_corrupt_cascades_to_disk_readback(self, framework):
        faultinj.configure({"faults": [
            {"match": "host_corrupt_probe", "fault": "host_corrupt",
             "count": 1}]})
        h = SpillableHandle(_tree(64, seed=9), name="hcd")
        h.spill()
        h.spill_host()
        assert h.tier == "disk"
        with pytest.raises(faultinj.SpillCorruptionError):
            h.get()
        h.close()

    def test_checksum_off_skips_detection(self, framework):
        config.set("spill_checksum", False)
        faultinj.configure({"faults": [
            {"match": "host_corrupt_probe", "fault": "host_corrupt",
             "count": 1}]})
        h = SpillableHandle({"x": torch.arange(64, dtype=torch.int32)},
                            name="nock")
        h.spill()
        h.get()  # no record: promotion cannot verify
        assert framework.metrics.snapshot()["corrupt_reads"] == 0
        h.close()


def test_injector_matches_the_reference_schedule(tmp_path):
    """One schedule (skip, count, probability, seed) screened over the
    same names: the same firings in the same order, and the scope,
    mirror and env-var surfaces behave as the reference's."""
    sched = {"seed": 42, "faults": [
        {"match": "spill_io_*", "fault": "spill_io", "skip": 2, "count": 2},
        {"match": "q*", "fault": "exception", "probability": 0.5}]}
    names = ["spill_io_write", "q6", "spill_io_read", "q9"] * 6
    logs = []
    for mod in (faultinj, jfault):
        fired = []
        with mod.scope(sched):
            for nm in names:
                try:
                    mod.instrument(lambda: None, nm)()
                except (mod.SpillIOError, mod.InjectedFault) as e:
                    fired.append((nm, type(e).__name__))
            logs.append((fired, mod.fired_log(), mod.check_counts(),
                         mod.fire_counts(), mod.current_config()))
        assert mod.current_config()["faults"] == []
    assert logs[0] == logs[1]
    mirror = tmp_path / "mirror.jsonl"
    cfg = tmp_path / "faults.json"
    cfg.write_text('{"faults": [{"match": "x", "fault": "oom"}]}')
    inj = faultinj._Injector()
    inj._mirror_path = str(mirror)
    os.environ[faultinj.ENV_CONFIG] = str(cfg)
    try:
        inj.configure()
    finally:
        del os.environ[faultinj.ENV_CONFIG]
    with pytest.raises(RetryOOM):
        inj.check("x")
    assert '"name": "x"' in mirror.read_text()


# ---------------------------------------------------------------------------
# spillable build tables and the plan's broadcast tables
# ---------------------------------------------------------------------------

def _sides():
    rng = np.random.default_rng(1)
    lk, rk = rng.integers(0, 40, 160), rng.integers(0, 40, 64)
    lv, rv = np.arange(160), np.arange(64) + 1000

    def port(k, v):
        ones = torch.ones(len(k), dtype=torch.bool)
        return ColumnBatch({"k": Column(torch.from_numpy(k), ones, T.INT64),
                            "v": Column(torch.from_numpy(v), ones,
                                        T.INT64)})

    def ref(k, v):
        ones = jnp.ones((len(k),), jnp.bool_)
        return JBatch({"k": JColumn(jnp.asarray(k), ones, JT.INT64),
                       "v": JColumn(jnp.asarray(v), ones, JT.INT64)})

    return port(lk, lv), port(rk, rv), ref(lk, lv), ref(rk, rv)


def _rows(batch, count):
    m = int(count)
    return sorted(zip(*(np.asarray(batch[c].data)[:m].tolist()
                        for c in ("k", "v", "v_r"))))


class TestSpillableBuildTable:
    def test_eviction_drops_and_get_rebuilds(self, framework, tmp_path):
        left, right, jleft, jright = _sides()
        jfw = jspill.install(spill_dir=str(tmp_path / "ref"))
        try:
            jbt = jspillable_build_table(jright, ["k"])
            jfw.spill_to_fit()
            want = _rows(*jax.jit(lambda a, b: jhash_join(
                a, b, ["k"], ["k"], "inner", capacity=1024,
                prebuilt=jbt))(jleft, jright))
            assert jbt.rebuilds == 1
            jbt.close()
        finally:
            jspill.shutdown()
        bt = spillable_build_table(right, ["k"])
        got = hash_join(left, right, ["k"], ["k"], "inner", capacity=1024,
                        prebuilt=bt)
        assert _rows(*got) == want
        assert bt.tier == "device" and bt.rebuilds == 0
        framework.spill_to_fit()  # pressure: the table is dropped
        assert bt.tier == "dropped"
        assert framework.metrics.snapshot()["device_to_host_bytes"] == 0
        got2 = hash_join(left, right, ["k"], ["k"], "inner", capacity=1024,
                         prebuilt=bt)
        assert _rows(*got2) == want and bt.rebuilds == 1
        bt.close()
        assert bt.tier == "closed"

    def test_charged_to_ctx_and_released_on_drop(self, framework, adaptor):
        _, right, _, _ = _sides()
        with TaskContext(21) as ctx:
            bt = spillable_build_table(right, ["k"], ctx=ctx)
            charged = adaptor.total_allocated()
            assert charged == batch_nbytes(bt.get()) > 0
            assert bt.spill() == charged and adaptor.total_allocated() == 0
            run_with_retry(bt.get)
            assert adaptor.total_allocated() == charged
        assert adaptor.total_allocated() == 0 and bt.tier == "closed"
        RmmSpark.task_done(21)

    def test_prebuilt_full_join_matches(self):
        left, right, jleft, jright = _sides()
        _, jn = jax.jit(lambda a, b: jhash_join(
            a, b, ["k"], ["k"], "full", capacity=1024))(jleft, jright)
        bt = spillable_build_table(right, ["k"])
        _, n = hash_join(left, right, ["k"], ["k"], "full", capacity=1024,
                         prebuilt=bt)
        bt.close()
        assert int(n) == int(jn)

    def test_guard_rails(self):
        left, right, _, _ = _sides()
        empty = ColumnBatch({"k": Column(torch.zeros(0, dtype=torch.int64),
                                         torch.zeros(0, dtype=torch.bool),
                                         T.INT64)})
        with pytest.raises(ValueError, match="empty build side"):
            spillable_build_table(empty, ["k"])
        bt = spillable_build_table(right, ["k"])
        with pytest.raises(ValueError, match="right"):
            hash_join(left, right, ["k"], ["k"], "right", prebuilt=bt)
        bt.close()


class TestBuildTablePinning:
    @staticmethod
    def _right():
        return TP.q95_batches(512, device="cpu")[1]

    def test_pinned_engine_survives_knob_flip(self, framework):
        bt = spillable_build_table(self._right(), ["k"], engine="sort")
        assert bt.engine == "sort" and bt.tier == "device"
        config.set("join_engine", "kernel")
        bt.spill()
        assert bt.tier == "dropped"
        bt.get()
        assert bt.rebuilds == 1 and bt.engine == "sort"
        bt.close()

    def test_unpinned_table_follows_the_knob(self, framework):
        config.set("join_engine", "sort")
        bt = spillable_build_table(self._right(), ["k"])
        assert bt.engine == "sort"
        config.set("join_engine", "kernel")
        bt.spill()
        bt.get()
        assert bt.engine == "kernel"
        bt.close()

    def test_broadcast_build_handle_registers_under_ctx(self, framework):
        right = self._right()
        RmmSpark.set_event_handler(32 << 20, poll_ms=10.0)
        try:
            with TaskContext(31) as ctx:
                h = broadcast_build_handle(right, ctx=ctx)
                assert h.task_id == 31 and len(framework.store) == 1
                h.spill()
                with h.pinned():
                    got = h.get()
                _same_tree(got, right)
                fact = TP.q95_batches(512, device="cpu")[0]
                mesh = ShardMesh(P8, device="cpu")
                want = distributed_broadcast_join(fact, right, ["k"], ["k"],
                                                  "inner", mesh)
                out = distributed_broadcast_join(fact, None, ["k"], ["k"],
                                                 "inner", mesh, build=h)
                _same_tree(out, want)
                out = distributed_broadcast_join(fact, right, ["k"], ["k"],
                                                 "inner", mesh, ctx=ctx)
                _same_tree(out, want)
                h.close()
                assert len(framework.store) == 0
            RmmSpark.task_done(31)
        finally:
            RmmSpark.clear_event_handler()

    def test_compiled_q9_probes_survive_eviction(self, framework):
        tplan.reset_plan_cache()
        fact, dim1, dim2 = TP.q95_batches(2048, device="cpu")
        inputs = {"fact": fact, "dim1": dim1, "dim2": dim2}
        RmmSpark.set_event_handler(64 << 20, poll_ms=10.0)
        try:
            with TaskContext(41) as ctx:
                cp = tplan.compile_plan(tq.q9_plan(), inputs, ctx=ctx)
                res1, ng1 = cp(inputs)
                assert cp.build_handles
                for _name, h in cp.build_handles:
                    assert h.task_id == 41
                    h.spill()
                    assert h.tier == "dropped"
                res2, ng2 = cp(inputs)
                assert all(h.rebuilds == 1 for _n, h in cp.build_handles)
                _same_tree((res1, ng1), (res2, ng2))
            # the context closed the tables: the cached plan compiles again
            assert cp.closed
            assert not tplan.compile_plan(tq.q9_plan(), inputs).closed
            RmmSpark.task_done(41)
        finally:
            RmmSpark.clear_event_handler()
            tplan.reset_plan_cache()
        net, orders = TP.q9_oracle(TP.q95_arrays(2048))
        groups = TP.result_groups(res2, ng2, "seg")
        assert [groups[s]["orders_hi"] for s in range(TP.Q95_SEG)] == \
            orders.tolist()
        assert [groups[s]["net_hi"] for s in range(TP.Q95_SEG)] == \
            net.tolist()


# ---------------------------------------------------------------------------
# out-of-core exchanges on ShardMesh(8)
# ---------------------------------------------------------------------------

def _kv_batch(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 40, n).astype(np.int64)
    ones = np.ones(n, np.bool_)
    return vals, batch_from_numpy({"v": (vals, ones, "int64"),
                                   "k": (np.arange(n), ones, "int64")},
                                  device="cpu")


def _under_arena(tmp_path, run, arena_bytes, task_id):
    spill_mod.install(spill_dir=str(tmp_path / "spill"))
    RmmSpark.set_event_handler(arena_bytes, poll_ms=10.0)
    try:
        with TaskContext(task_id) as ctx:
            res = run(ctx)
            left = len(spill_mod.get_framework().store)
        RmmSpark.task_done(task_id)
        assert RmmSpark._adaptor.total_allocated() == 0
        assert left == 0  # every buffer closed by the exchange
    finally:
        RmmSpark.clear_event_handler()
        spill_mod.shutdown()
    return res


class TestOutOfCore:
    def test_skewed_exchange_spills_and_stays_lossless(self, tmp_path):
        config.set("shuffle_capacity_bucket", 256)
        get_registry().reset()
        mesh = ShardMesh(P8, device="cpu")
        n = P8 * 4096
        vals, batch = _kv_batch(n, 7)
        pid = torch.zeros(n, dtype=torch.int32)  # every row to shard 0
        res = _under_arena(
            tmp_path, lambda ctx: ShuffleService(mesh).exchange(
                batch, pid=pid, ctx=ctx, round_rows=512), 1 << 20, 77)
        occ = res.occupancy
        assert res.rows_moved == n
        assert sorted(res.batch["v"].data[occ].tolist()) == \
            sorted(vals.tolist())
        summary = get_registry().metrics.snapshot()
        assert summary["rounds"] >= 2
        assert summary["spilled_bytes"] == res.spilled_bytes > 0
        assert summary["dropped_rows"] == 0
        assert RmmSpark.shuffle_metrics() == summary
        plain = ShuffleService(mesh).exchange(batch, pid=pid,
                                              round_rows=512)
        assert plain.spilled_bytes == 0
        _same_tree((res.batch, res.occupancy),
                   (plain.batch, plain.occupancy))

    def test_stream_spills_and_stays_lossless(self, tmp_path):
        config.set("shuffle_capacity_bucket", 16)  # capacity = round_rows
        get_registry().reset()
        mesh = ShardMesh(P8, device="cpu")
        n = P8 * 2048
        vals, batch = _kv_batch(n, 9)

        def stream(ctx):
            src = MorselSource.from_batch(batch, mesh, morsel_rows=256)
            return ShuffleService(mesh).exchange_stream(
                src, key_names=["k"], ctx=ctx, round_rows=64)

        # 384 KiB holds a morsel (45 KiB) and the three 76 KiB send
        # chunks one morsel can touch, not the stream's buffers
        res = _under_arena(tmp_path, stream, 384 << 10, 78)
        occ = res.occupancy
        assert res.rows_moved == n and res.rounds >= 2
        assert res.spilled_bytes > 0
        assert sorted(res.batch["v"].data[occ].tolist()) == \
            sorted(vals.tolist())
        plain = stream(None)
        assert plain.spilled_bytes == 0
        _same_tree((res.batch, res.occupancy),
                   (plain.batch, plain.occupancy))


# ---------------------------------------------------------------------------
# partition recovery through lineage (tests/test_chaos.py
# TestShufflePartitionRecovery) and the stream's send-chunk rebuild
# ---------------------------------------------------------------------------

RECOVERY_ROWS = P8 * 1024
CORRUPT = {"match": "spill_corrupt_file", "fault": "spill_corrupt"}


def _recovery_run(ns, spill_dir, task_id, make_exchange, fault=None):
    """The reference's recovery scenario in either package: every row to
    partition 0, capacity bucket 256, 128-row rounds, a 512 KiB device
    and 128 KiB host arena, so round chunks demote to disk.  Returns the
    delivered values, occupancy, result or error, the registry snapshot
    and the bytes left in the arena."""
    rmm, reg = ns["rmm"], ns["registry"]()
    adaptor = rmm.set_event_handler(512 * KB, host_pool_bytes=128 * KB,
                                    poll_ms=10.0)
    ns["spill"].install(spill_dir=spill_dir)
    out = {}
    try:
        with ns["scope"]({"faults": [fault] if fault else []}):
            with ns["ctx"](task_id) as ctx:
                try:
                    res = make_exchange(reg, ctx)
                    out["vals"], out["occ"] = ns["delivered"](res)
                    out["res"] = res
                except ns["shuffle_error"] as e:
                    out["error"] = str(e)
        rmm.task_done(task_id)
        out["snap"] = reg.metrics.snapshot()
        out["left"] = adaptor.total_allocated()
    finally:
        ns["spill"].shutdown()
        rmm.clear_event_handler()
    return out


@pytest.fixture(scope="module")
def recovery_reference(eight_devices, tmp_path_factory):
    """The reference's clean, corrupted (two disk writes) and zero-budget
    runs of the recovery scenario."""
    from spark_rapids_jni_tpu import config as jconfig
    from spark_rapids_jni_tpu.parallel import data_mesh, shard_batch
    from spark_rapids_jni_tpu.shuffle import ShuffleError as JShuffleError
    from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JRegistry
    from spark_rapids_jni_tpu.shuffle import ShuffleService as JService

    vals = (np.arange(RECOVERY_ROWS, dtype=np.int64) * 977) % (1 << 30)
    mesh = data_mesh(P8)
    batch = shard_batch(JBatch({"v": JColumn(
        jnp.asarray(vals), jnp.ones((RECOVERY_ROWS,), jnp.bool_),
        JT.INT64)}), mesh)
    pid = jax.device_put(jnp.zeros((RECOVERY_ROWS,), jnp.int32),
                         jax.sharding.NamedSharding(
                             mesh, jax.sharding.PartitionSpec("data")))
    ns = {"rmm": JRmmSpark, "registry": JRegistry, "spill": jspill,
          "scope": jfault.scope, "ctx": JTaskContext,
          "shuffle_error": JShuffleError,
          "delivered": lambda r: (np.asarray(r.batch["v"].data),
                                  np.asarray(r.occupancy))}

    def ex(reg, ctx):
        return JService(mesh, registry=reg).exchange(
            batch, pid=pid, ctx=ctx, round_rows=128)

    root = tmp_path_factory.mktemp("recovery_ref")
    jconfig.set("shuffle_capacity_bucket", 256)
    try:
        out = {"clean": _recovery_run(ns, str(root / "a"), 31, ex),
               "corrupt": _recovery_run(ns, str(root / "b"), 32, ex,
                                        dict(CORRUPT, count=2))}
        jconfig.set("shuffle_max_recoveries", 0)
        out["budget"] = _recovery_run(ns, str(root / "c"), 33, ex,
                                      dict(CORRUPT, count=1))
    finally:
        jconfig.reset("shuffle_capacity_bucket")
        jconfig.reset("shuffle_max_recoveries")
    return vals, out


@pytest.mark.parametrize("case", ["corrupt", "budget"])
def test_partition_recovery_matches_reference(tmp_path, recovery_reference,
                                              case):
    from spark_rapids_jni_tpu_torch.shuffle import (ShuffleError,
                                                    ShuffleRegistry)

    vals, ref = recovery_reference
    mesh = ShardMesh(P8, device="cpu")
    batch = batch_from_numpy({"v": (vals, np.ones(RECOVERY_ROWS, bool),
                                    "int64")}, device="cpu")
    pid = torch.zeros(RECOVERY_ROWS, dtype=torch.int32)
    ns = {"rmm": RmmSpark, "registry": ShuffleRegistry, "spill": spill_mod,
          "scope": faultinj.scope, "ctx": TaskContext,
          "shuffle_error": ShuffleError,
          "delivered": lambda r: (r.batch["v"].data.numpy(),
                                  r.occupancy.numpy())}

    def ex(reg, ctx):
        return ShuffleService(mesh, registry=reg).exchange(
            batch, pid=pid, ctx=ctx, round_rows=128)

    config.set("shuffle_capacity_bucket", 256)
    if case == "budget":
        config.set("shuffle_max_recoveries", 0)
    got = _recovery_run(ns, str(tmp_path / "spill"), 34, ex,
                        dict(CORRUPT, count=2 if case == "corrupt" else 1))
    want = ref[case]
    assert got["left"] == want["left"] == 0
    if case == "budget":
        assert "recovery budget" in got["error"]
        assert "recovery budget" in want["error"]
        return
    res = got["res"]
    assert res.recovered_partitions > 0
    assert res.recovered_partitions == want["res"].recovered_partitions
    info = get_registry().shuffles().get(res.shuffle_id)
    assert info is None or info.recovered_partitions >= 0
    for k in ("recovered_partitions", "adopted_shards", "lineage_rebuilds",
              "rows_moved", "rounds", "dropped_rows"):
        assert got["snap"][k] == want["snap"][k], k
    # recovery is invisible in the delivered rows: the reference's arrays
    np.testing.assert_array_equal(got["occ"], want["occ"])
    np.testing.assert_array_equal(got["vals"], want["vals"])
    np.testing.assert_array_equal(ref["clean"]["vals"], want["vals"])


def test_stream_send_chunk_rebuilds_through_the_scatter(tmp_path):
    """A stream whose spilled chunks are corrupted on disk rebuilds each
    damaged send chunk by re-scattering its recorded morsels through the
    partition-scatter kernel (its plain version here) and delivers the
    undamaged stream's arrays, with the arena drained."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    config.set("shuffle_capacity_bucket", 16)  # capacity = round_rows
    config.set("shuffle_max_recoveries", 1 << 10)
    mesh = ShardMesh(P8, device="cpu")
    n = P8 * 2048
    vals, batch = _kv_batch(n, 9)
    calls = []
    real = KER.PartitionScatter.__call__

    def counted(self, *a):
        calls.append(tuple(a[3:5]))
        return real(self, *a)

    def stream(ctx):
        src = MorselSource.from_batch(batch, mesh, morsel_rows=256)
        return ShuffleService(mesh).exchange_stream(
            src, key_names=["k"], ctx=ctx, round_rows=64)

    KER.PartitionScatter.__call__ = counted
    try:
        plain = stream(None)
        plain_calls = list(calls)
        del calls[:]
        get_registry().reset()
        # spilled chunks go on to disk (a 128 KiB host arena), where the
        # first disk writes are damaged
        spill_mod.install(spill_dir=str(tmp_path / "spill"))
        adaptor = RmmSpark.set_event_handler(384 << 10,
                                             host_pool_bytes=128 << 10,
                                             poll_ms=10.0)
        try:
            with faultinj.scope({"faults": [dict(CORRUPT, count=8)]}):
                with TaskContext(79) as ctx:
                    res = stream(ctx)
            RmmSpark.task_done(79)
            assert adaptor.total_allocated() == 0
        finally:
            RmmSpark.clear_event_handler()
            spill_mod.shutdown()
    finally:
        KER.PartitionScatter.__call__ = real
    snap = get_registry().metrics.snapshot()
    assert res.recovered_partitions > 0
    assert snap["lineage_rebuilds"] == res.recovered_partitions
    # the stream launches once a morsel; each rebuilt send chunk adds one
    # single-round launch per morsel recorded against it
    assert len(calls) > len(plain_calls)
    assert sum(lo == hi for lo, hi in calls) - \
        sum(lo == hi for lo, hi in plain_calls) == \
        len(calls) - len(plain_calls)
    assert res.rows_moved == n
    _same_tree((res.batch, res.occupancy), (plain.batch, plain.occupancy))


def test_round_chunk_update_swaps_tree_charge_and_lineage(framework,
                                                         adaptor):
    """``RoundChunk.update`` closes the stale handle before charging the
    new tree, and the new handle carries the new lineage: a damaged host
    copy rebuilds from it."""
    from spark_rapids_jni_tpu_torch.shuffle import RoundChunk

    def chunk_tree(n, seed):
        return ([torch.from_numpy(_words(n, seed))],
                torch.ones(n, dtype=torch.bool))

    with TaskContext(80) as ctx:
        chunk = RoundChunk(chunk_tree(64, 1), ctx=ctx, name="round-1")
        assert adaptor.total_allocated() == chunk.nbytes == 64 * 5
        chunk.update(chunk_tree(128, 2),
                     recompute=lambda: chunk_tree(128, 2))
        assert adaptor.total_allocated() == chunk.nbytes == 128 * 5
        with faultinj.scope({"faults": [
                {"match": "host_corrupt_probe", "fault": "host_corrupt",
                 "count": 1}]}):
            chunk._handle.spill()
        leaves, occ = chunk.get()
        assert np.array_equal(leaves[0].numpy(), _words(128, 2))
        assert bool(occ.all()) and chunk._handle.lineage_rebuilds == 1
        chunk.close()
    assert adaptor.total_allocated() == 0
