"""PyTorch port: the data plane (``serve/data_plane.py``) against the
reference's ``tests/test_data_plane.py``: the cases that need no fleet
(codec round trip, descriptor verify, plane resolution, the JSON plane;
the reference's ``TestEndToEnd`` spawns fleet workers, ROADMAP item
16c).  A result batch crosses as one Arrow IPC stream through a memfd
segment and comes back bit-exact, dictionary codes and runs included;
the reader verifies the fence epoch and every chunk CRC first.  Then
parity with the JAX package: the same payload gives the same descriptor
and chunk CRCs in both, each package reads the other's segment, and the
transport digest of a batch is the reference's.
"""

import os

import numpy as np
import pytest

from spark_rapids_jni_tpu.serve import data_plane as jdp
from spark_rapids_jni_tpu.serve.worker import make_result_batch

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch.columnar import arrow as arrow_mod
from spark_rapids_jni_tpu_torch.columnar.encoded import (DictionaryColumn,
                                                         RunLengthColumn)
from spark_rapids_jni_tpu_torch.serve import data_plane as dp
from spark_rapids_jni_tpu_torch.serve import wire

from torch_parity import to_port
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faultinj.configure(None)


def _result_batch(rows, seed):
    """The reference's ``make_result_batch`` (dictionary strings, an RLE
    int column, NaN and -0.0 floats) carried into the port's columns."""
    return to_port(make_result_batch(rows, seed))


def _seg_desc(payload, fp, chunk_bytes=4096, epoch=1, plane="shm",
              seg="seg-w0-g1-0", mod=dp):
    crcs = mod.chunk_crcs(payload, chunk_bytes)
    return mod.build_descriptor(plane, seg, len(payload), fp,
                                chunk_bytes, crcs, epoch)


class TestCodecRoundTrip:
    def test_dict_rle_bit_exact_through_memfd(self):
        """The full shm path: batch -> IPC -> memfd -> mmap verify ->
        IPC -> batch, with every buffer compared by raw bytes."""
        jbatch = make_result_batch(257, seed=5)
        batch = to_port(jbatch)
        payload, fp = arrow_mod.batch_to_ipc(batch)
        desc = _seg_desc(payload, fp)
        fd = dp.make_segment(desc["seg"], payload)
        dp.seal_segment(fd)
        try:
            out = dp.read_segment(fd, desc)
        finally:
            os.close(fd)
        assert out == bytes(memoryview(payload))
        back = arrow_mod.ipc_to_batch(out, expect_fingerprint=fp,
                                      device="cpu")
        assert back.names == batch.names

        # encodings survive the hop — codes cross as codes, runs as runs
        assert isinstance(back["tag"], DictionaryColumn)
        assert isinstance(back["r"], RunLengthColumn)

        for name in batch.names:
            a, b = batch[name], back[name]
            assert a.validity.numpy().tobytes() == \
                b.validity.numpy().tobytes()
        # "f" carries NaN payloads, -0.0, and data under null rows:
        # live slots must match by BIT PATTERN (tobytes, not ==)
        fa, fb = batch["f"].data.numpy(), back["f"].data.numpy()
        va = batch["f"].validity.numpy().astype(bool)
        assert fa[va].tobytes() == fb[va].tobytes()
        assert np.isnan(fa[va]).any() and (np.signbit(fa[va])
                                           & (fa[va] == 0)).any()
        assert batch["v"].data.numpy().tobytes() == \
            back["v"].data.numpy().tobytes()
        ta, tb = batch["tag"], back["tag"]
        assert ta.codes.numpy().tobytes() == tb.codes.numpy().tobytes()
        # the chars matrix may re-pad to a different planned width; the
        # VALUE bytes (each row up to its length) are the contract
        la = ta.dictionary.lengths.numpy()
        lb = tb.dictionary.lengths.numpy()
        assert la.tolist() == lb.tolist()
        ca, cb = ta.dictionary.chars.numpy(), tb.dictionary.chars.numpy()
        for i, n in enumerate(la):
            assert ca[i, :n].tobytes() == cb[i, :n].tobytes()
        ra, rb = batch["r"], back["r"]
        assert ra.run_values.numpy().tobytes() == \
            rb.run_values.numpy().tobytes()
        assert ra.run_lengths.numpy().astype(np.int64).tobytes() == \
            rb.run_lengths.numpy().astype(np.int64).tobytes()
        # and the canonical transport digest agrees, with the
        # reference's digest of its own batch too
        assert dp.batch_digest(batch) == dp.batch_digest(back) == \
            jdp.batch_digest(jbatch)

    def test_empty_batch_round_trip(self):
        batch = _result_batch(0, seed=1)
        payload, fp = arrow_mod.batch_to_ipc(batch)
        back = arrow_mod.ipc_to_batch(payload, expect_fingerprint=fp,
                                      device="cpu")
        assert back.names == batch.names
        assert dp.batch_digest(batch) == dp.batch_digest(back)

    def test_fingerprint_mismatch_rejected(self):
        payload, _fp = arrow_mod.batch_to_ipc(_result_batch(8, seed=1))
        with pytest.raises(ValueError, match="fingerprint"):
            arrow_mod.ipc_to_batch(payload, expect_fingerprint="0" * 16,
                                   device="cpu")


class TestDescriptorVerify:
    def test_torn_chunk_rejected(self):
        """A byte flipped in the segment AFTER the CRC stamps must be
        caught by the chunk verify, naming the torn chunk."""
        batch = _result_batch(64, seed=2)
        payload, fp = arrow_mod.batch_to_ipc(batch)
        desc = _seg_desc(payload, fp, chunk_bytes=512)
        fd = dp.make_segment(desc["seg"], payload)
        try:
            mid = len(memoryview(payload)) // 2
            b = os.pread(fd, 1, mid)
            os.pwrite(fd, bytes([b[0] ^ 0xFF]), mid)
            dp.seal_segment(fd)
            with pytest.raises(dp.DataPlaneCorruption, match="torn"):
                dp.read_segment(fd, desc)
        finally:
            os.close(fd)

    def test_size_mismatch_rejected(self):
        desc = _seg_desc(b"abcdef", "00")
        with pytest.raises(dp.DataPlaneCorruption, match="bytes"):
            dp.verify_chunks(b"abcde", desc)

    def test_chunk_count_mismatch_rejected(self):
        desc = _seg_desc(b"abcdef", "00", chunk_bytes=2)
        desc["crcs"] = desc["crcs"][:-1]
        with pytest.raises(dp.DataPlaneCorruption, match="stamps"):
            dp.verify_chunks(b"abcdef", desc)

    def test_stale_epoch_rejected(self):
        desc = _seg_desc(b"payload", "00", epoch=2)
        dp.verify_epoch(desc, 2)  # live generation passes
        with pytest.raises(dp.DataPlaneStale, match="stale"):
            dp.verify_epoch(desc, 3)

    def test_empty_payload_has_a_stamp(self):
        # zero-size payloads still carry (and verify) one CRC stamp —
        # an empty descriptor is never "trusted by default"
        desc = _seg_desc(b"", "00")
        assert len(desc["crcs"]) == 1
        dp.verify_chunks(b"", desc)
        desc["crcs"] = [desc["crcs"][0] ^ 1]
        with pytest.raises(dp.DataPlaneCorruption):
            dp.verify_chunks(b"", desc)


class TestPlaneResolution:
    def test_auto_picks_shm_on_unix_frames_on_tcp(self):
        assert dp.resolve_plane("auto", "unix") == "shm"
        assert dp.resolve_plane("auto", "tcp") == "frames"

    def test_shm_refused_on_tcp(self):
        with pytest.raises(ValueError, match="fd"):
            dp.resolve_plane("shm", "tcp")

    def test_unknown_setting_refused(self):
        with pytest.raises(ValueError, match="expected"):
            dp.resolve_plane("zerocopy", "unix")

    def test_knob_default_is_auto(self):
        assert config.get("serve_data_plane") == "auto"
        assert dp.resolve_plane(None, "unix") == "shm"

    def test_segment_names_are_epoch_stamped(self):
        # a replacement generation can never alias its predecessor
        assert dp.segment_name(1, 3, 0) != dp.segment_name(1, 4, 0)


class TestJsonPlane:
    def test_round_trip(self):
        raw = os.urandom(1024)
        assert dp.decode_json_payload(dp.encode_json_payload(raw)) == raw

    def test_overflow_raises_wiredesync(self):
        """A payload the control-frame cap cannot carry is refused with
        a WireDesync-class error — loud, never truncated."""
        with pytest.raises(dp.DataPlaneOverflow, match="cap|budget"):
            dp.encode_json_payload(b"x" * 120, cap=100)
        assert issubclass(dp.DataPlaneOverflow, wire.WireDesync)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_bytes", [1, 7, 4096, 1 << 20])
def test_descriptor_and_crcs_are_the_references(chunk_bytes):
    payload = np.random.default_rng(chunk_bytes).integers(
        0, 256, 20_011, dtype=np.uint8).tobytes()
    assert dp.chunk_crcs(payload, chunk_bytes) == \
        jdp.chunk_crcs(payload, chunk_bytes)
    for snapshot in (None, "mem:ab12"):
        crcs = dp.chunk_crcs(payload, chunk_bytes)
        args = ("frames", dp.segment_name(2, 5, 9), len(payload), "fp",
                chunk_bytes, crcs, 5)
        assert dp.build_descriptor(*args, snapshot=snapshot) == \
            jdp.build_descriptor(*args, snapshot=snapshot)
    assert dp.segment_name(2, 5, 9) == jdp.segment_name(2, 5, 9)


def test_planes_resolve_alike():
    for setting in ("auto", "shm", "frames", "json", "zerocopy"):
        for kind in ("unix", "tcp"):
            try:
                want = jdp.resolve_plane(setting, kind)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    dp.resolve_plane(setting, kind)
                assert str(got.value) == str(e)
            else:
                assert dp.resolve_plane(setting, kind) == want


def test_each_package_reads_the_others_segment():
    """A segment either package writes and seals verifies and reads in
    the other; the JSON plane's text is the same in both."""
    jbatch = make_result_batch(300, seed=11)
    payload, fp = arrow_mod.batch_to_ipc(to_port(jbatch))
    payload = bytes(memoryview(payload))
    for writer, reader in ((dp, jdp), (jdp, dp)):
        desc = _seg_desc(payload, fp, chunk_bytes=1000, mod=writer)
        fd = writer.make_segment(desc["seg"], payload)
        writer.seal_segment(fd)
        try:
            reader.verify_epoch(desc, 1)
            assert reader.read_segment(fd, desc) == payload
        finally:
            os.close(fd)
    assert dp.encode_json_payload(payload) == jdp.encode_json_payload(payload)
    back = arrow_mod.ipc_to_batch(payload, expect_fingerprint=fp,
                                  device="cpu")
    assert dp.batch_digest(back) == jdp.batch_digest(jbatch)
