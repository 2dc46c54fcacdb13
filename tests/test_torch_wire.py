"""PyTorch port: the wire protocol (``serve/wire.py``) against the
reference's ``tests/test_wire.py``, case for case: framing + CRC32
trailers, the 16MB frame cap, the mid-frame timeout desync guard, frame
deadlines, Unix/TCP transport parity, the injected network faults and
the binary data frames.  Then parity with the JAX package: for the same
messages the port's frames are byte for byte the reference's, and each
package reads what the other writes."""

import socket
import struct
import threading
import time
import zlib

import pytest

from spark_rapids_jni_tpu.serve import wire as jwire

from spark_rapids_jni_tpu_torch import faultinj
from spark_rapids_jni_tpu_torch.serve import wire


def _raw_frame(payload: bytes) -> bytes:
    """Hand-build a frame the way the wire does: length prefix, payload,
    CRC32 trailer."""
    return (struct.pack("<I", len(payload)) + payload
            + struct.pack("<I", zlib.crc32(payload)))


@pytest.fixture
def pair():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    yield a, b
    a.close()
    b.close()


@pytest.fixture(params=["unix", "tcp"])
def tpair(request):
    """A connected (supervisor, worker) Transport pair over each kind —
    every framing property must hold identically on both."""
    kind = request.param
    if kind == "unix":
        sa, sb = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        sup = wire.wrap(sa, "unix", role="sup")
        wk = wire.wrap(sb, "unix", role="wk")
    else:
        lst, addr = wire.listen("tcp", "127.0.0.1:0")
        wk = wire.connect("tcp", addr, role="wk")
        conn, _ = lst.accept()
        sup = wire.wrap(conn, "tcp", role="sup")
        lst.close()
    yield sup, wk
    sup.close()
    wk.close()


class TestFraming:
    def test_round_trip(self, pair):
        a, b = pair
        lock = threading.Lock()
        wire.send_msg(a, {"op": "ping", "t": 1.5}, lock)
        wire.send_msg(a, {"op": "submit", "params": {"k": [1, 2]}})
        assert wire.recv_msg(b) == {"op": "ping", "t": 1.5}
        assert wire.recv_msg(b) == {"op": "submit", "params": {"k": [1, 2]}}

    def test_peer_closed_mid_frame(self, pair):
        a, b = pair
        # header promises 100 bytes; only 10 arrive before the close
        a.sendall(struct.pack("<I", 100) + b"x" * 10)
        a.close()
        with pytest.raises(wire.WireError, match="mid-frame"):
            wire.recv_msg(b)

    def test_eof_before_any_frame(self, pair):
        a, b = pair
        a.close()
        with pytest.raises(wire.WireError):
            wire.recv_msg(b)


class TestCrcTrailer:
    def test_corrupted_payload_rejected(self, pair):
        a, b = pair
        payload = b'{"op":"pong","t":1}'
        frame = bytearray(_raw_frame(payload))
        frame[6] ^= 0x40  # flip one payload bit; trailer now disagrees
        a.sendall(bytes(frame))
        with pytest.raises(wire.WireDesync, match="CRC"):
            wire.recv_msg(b)

    def test_corrupted_trailer_rejected(self, pair):
        a, b = pair
        payload = b'{"op":"pong","t":1}'
        a.sendall(struct.pack("<I", len(payload)) + payload
                  + struct.pack("<I", zlib.crc32(payload) ^ 1))
        with pytest.raises(wire.WireDesync, match="CRC"):
            wire.recv_msg(b)

    def test_desync_is_a_wire_error(self):
        # callers that catch WireError for "link is dead" must also see
        # desyncs — both end the connection
        assert issubclass(wire.WireDesync, wire.WireError)
        assert issubclass(wire.WireError, ConnectionError)


class TestFrameCap:
    def test_oversized_send_rejected_before_writing(self, pair):
        a, _b = pair
        big = {"op": "result", "value": "v" * (wire.MAX_FRAME + 1)}
        with pytest.raises(wire.WireError, match="exceeds"):
            wire.send_msg(a, big)

    def test_oversized_length_prefix_rejected(self, pair):
        a, b = pair
        # a corrupted (or hostile) length prefix must be refused before
        # any allocation-sized read, not honored
        a.sendall(struct.pack("<I", wire.MAX_FRAME + 1))
        with pytest.raises(wire.WireError, match="exceeds"):
            wire.recv_msg(b)

    def test_max_sized_frame_passes(self, pair):
        a, b = pair
        # just under the cap round-trips: the cap is a guard, not a tax
        msg = {"v": "x" * (1 << 16)}
        wire.send_msg(a, msg)
        assert wire.recv_msg(b) == msg


class TestMidFrameTimeout:
    def test_desync_guard_keeps_reading_mid_frame(self, pair):
        """A poll-timeout socket that times out MID-frame must keep
        reading — surfacing the timeout there would desync the stream
        (the next recv would parse payload bytes as a header)."""
        a, b = pair
        b.settimeout(0.05)
        frame = _raw_frame(b'{"op":"pong","t":9}')

        def slow_send():
            a.sendall(frame[:9])
            time.sleep(0.25)  # several poll ticks mid-frame
            a.sendall(frame[9:])

        t = threading.Thread(target=slow_send)
        t.start()
        try:
            # no socket.timeout surfaces despite the mid-frame stall...
            assert wire.recv_msg(b) == {"op": "pong", "t": 9}
        finally:
            t.join()
        # ...and the stream is still in sync for the next frame
        wire.send_msg(a, {"op": "ping"})
        assert wire.recv_msg(b) == {"op": "ping"}

    def test_timeout_between_frames_surfaces(self, pair):
        _a, b = pair
        b.settimeout(0.05)
        # BETWEEN frames the timeout must reach the poller so the worker
        # loop can keep ticking (checking the wedge flag, etc.)
        with pytest.raises(socket.timeout):
            wire.recv_msg(b)

    def test_mid_frame_stall_past_deadline_is_desync(self, pair):
        """Patience ends: a frame still incomplete after ``deadline_s``
        can never be re-synchronized — the recv must say so instead of
        spinning forever on a wedged peer."""
        a, b = pair
        b.settimeout(0.05)
        a.sendall(struct.pack("<I", 64) + b"y" * 8)  # then silence
        t0 = time.monotonic()
        with pytest.raises(wire.WireDesync, match="incomplete"):
            wire.recv_msg(b, deadline_s=0.3)
        assert time.monotonic() - t0 < 3.0  # bounded, not FRAME_DEADLINE_S


class TestTransportParity:
    """Every framing property must hold identically over Unix-domain
    sockets and TCP — the multi-host fleet gets the same guarantees as
    the single-box default."""

    def test_round_trip_and_hello(self, tpair):
        sup, wk = tpair
        wk.hello(3, 1234, fence_epoch=7, resume_token="3-7-ab")
        sup.settimeout(2.0)
        h = sup.recv()
        assert h == {"op": "hello", "worker_id": 3, "pid": 1234,
                     "fence_epoch": 7, "resume_token": "3-7-ab"}
        sup.send({"op": "ping", "t": 0.5})
        wk.settimeout(2.0)
        assert wk.recv() == {"op": "ping", "t": 0.5}

    def test_frame_cap_enforced(self, tpair):
        sup, _wk = tpair
        with pytest.raises(wire.WireError, match="exceeds"):
            sup.send({"v": "x" * (wire.MAX_FRAME + 1)})

    def test_crc_trailer_reject(self, tpair):
        sup, wk = tpair
        payload = b'{"op":"pong","t":2}'
        frame = bytearray(_raw_frame(payload))
        frame[-1] ^= 0xFF  # corrupt the trailer on the wire
        wk.sock.sendall(bytes(frame))
        sup.settimeout(2.0)
        with pytest.raises(wire.WireDesync, match="CRC"):
            sup.recv()
        assert sup.closed  # desync closes the link

    def test_torn_frame_detected(self, tpair):
        sup, wk = tpair
        frame = _raw_frame(b'{"op":"result","sid":"s1"}')
        wk.sock.sendall(frame[: len(frame) // 2])
        wk.sock.close()
        sup.settimeout(0.05)
        with pytest.raises(wire.WireError, match="mid-frame"):
            sup.recv()
        assert sup.closed

    def test_deadline_expiry_mid_frame(self, tpair):
        sup, wk = tpair
        sup.frame_deadline_s = 0.3
        sup.settimeout(0.05)
        wk.sock.sendall(struct.pack("<I", 128) + b"z" * 16)  # stalls here
        with pytest.raises(wire.WireDesync, match="incomplete"):
            sup.recv()
        assert sup.closed

    def test_boundary_timeout_keeps_link_open(self, tpair):
        sup, _wk = tpair
        sup.settimeout(0.05)
        with pytest.raises(socket.timeout):
            sup.recv()
        assert not sup.closed  # idle tick, not damage


class TestInjectedNetworkFaults:
    """The faultinj net kinds convert into real wire damage at the
    transport probes — one per kind, on the side chaos targets."""

    def test_net_drop_on_send_kills_link(self, tpair):
        sup, _wk = tpair
        cfg = {"faults": [{"match": "net_send_sup", "fault": "net_drop",
                           "count": 1}]}
        with faultinj.scope(cfg):
            with pytest.raises(wire.WireError, match="drop"):
                sup.send({"op": "ping", "t": 1.0})
        assert sup.closed

    def test_net_torn_on_send_detected_by_peer(self, tpair):
        sup, wk = tpair
        wk.frame_deadline_s = 0.3
        wk.settimeout(0.05)
        cfg = {"faults": [{"match": "net_send_sup", "fault": "net_torn",
                           "count": 1}]}
        with faultinj.scope(cfg):
            with pytest.raises(wire.WireError, match="torn"):
                sup.send({"op": "submit", "sid": "s1", "kind": "echo"})
        # the half-frame made it onto the wire; the peer's desync
        # machinery — not trust — rejects it
        with pytest.raises(wire.WireError):
            wk.recv()
        assert wk.closed

    def test_net_stall_on_recv_is_bounded(self, tpair):
        sup, wk = tpair
        wk.stall_s = 0.1
        sup.send({"op": "ping", "t": 2.0})
        wk.settimeout(2.0)
        cfg = {"faults": [{"match": "net_recv_wk", "fault": "net_stall",
                           "count": 1}]}
        t0 = time.monotonic()
        with faultinj.scope(cfg):
            with pytest.raises(wire.WireError, match="stall"):
                wk.recv()
        assert 0.1 <= time.monotonic() - t0 < 2.0
        assert wk.closed

    def test_kinds_are_registered(self):
        for kind in ("net_drop", "net_stall", "net_torn"):
            assert kind in faultinj.FAULT_KINDS


class TestListenConnect:
    def test_tcp_port_zero_reports_bound_port(self):
        lst, addr = wire.listen("tcp", "127.0.0.1:0")
        try:
            host, _, port = addr.rpartition(":")
            assert host == "127.0.0.1" and int(port) > 0
        finally:
            lst.close()

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown transport"):
            wire.listen("carrier-pigeon", "/nowhere")
        with pytest.raises(ValueError, match="unknown transport"):
            wire.wrap(None, "quic", role="sup")


class TestDataFrames:
    """The binary data plane sharing the control socket: MSB-flagged
    frames with their own cap and CRC, interleaving with control
    messages, and SCM_RIGHTS fd-passing on the Unix transport."""

    def test_data_frame_round_trip(self, tpair):
        sup, wk = tpair
        payload = bytes(range(256)) * 7
        wk.send_data(9, 0, payload)
        sup.settimeout(2.0)
        chunk = sup.recv()
        assert isinstance(chunk, wire.DataChunk)
        assert (chunk.sid, chunk.seq, chunk.payload) == (9, 0, payload)

    def test_control_and_data_interleave_in_order(self, tpair):
        sup, wk = tpair
        wk.send_data(3, 0, b"part-a")
        wk.send({"op": "running", "sid": 3})
        wk.send_data(3, 1, b"part-b")
        wk.send({"op": "result", "sid": 3})
        sup.settimeout(2.0)
        got = [sup.recv() for _ in range(4)]
        assert got[0] == wire.DataChunk(3, 0, b"part-a")
        assert got[1] == {"op": "running", "sid": 3}
        assert got[2] == wire.DataChunk(3, 1, b"part-b")
        assert got[3] == {"op": "result", "sid": 3}

    def test_data_frame_crc_reject(self, tpair):
        sup, wk = tpair
        frame = bytearray(wire._data_frame(1, 0, b"payload-bytes"))
        frame[-7] ^= 0xFF  # tear a payload byte after the CRC stamp
        wk.sock.sendall(bytes(frame))
        sup.settimeout(2.0)
        with pytest.raises(wire.WireDesync, match="CRC"):
            sup.recv()
        assert sup.closed

    def test_data_cap_is_larger_than_control_cap(self, tpair):
        sup, wk = tpair
        assert wire.MAX_DATA_FRAME > wire.MAX_FRAME
        big = b"z" * (wire.MAX_FRAME + 1024)  # over the CONTROL cap
        got = []
        sup.settimeout(10.0)
        rx = threading.Thread(target=lambda: got.append(sup.recv()))
        rx.start()  # drain concurrently: the frame outgrows the socket
        try:        # buffer, so an unread send would deadlock
            wk.send_data(1, 0, big)
        finally:
            rx.join(timeout=15.0)
        assert got and got[0].payload == big

    def test_oversized_data_length_prefix_rejected(self, tpair):
        sup, wk = tpair
        wk.sock.sendall(struct.pack(
            "<I", wire.DATA_FLAG | (wire.MAX_DATA_FRAME + 1)))
        sup.settimeout(2.0)
        with pytest.raises(wire.WireError, match="exceeds"):
            sup.recv()

    def test_oversized_data_send_rejected_before_writing(self, tpair):
        _sup, wk = tpair
        with pytest.raises(wire.WireError, match="exceeds"):
            wk.send_data(1, 0, b"z" * (wire.MAX_DATA_FRAME + 1))

    def test_recv_msg_is_control_only(self, pair):
        a, b = pair
        a.sendall(wire._data_frame(1, 0, b"chunk"))
        with pytest.raises(wire.WireError, match="control-only"):
            wire.recv_msg(b)

    def test_fd_passing_unix_only(self):
        sa, sb = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        sup = wire.wrap(sa, "unix", role="sup")
        wk = wire.wrap(sb, "unix", role="wk")
        try:
            import os
            r, w = os.pipe()
            os.write(w, b"via-scm-rights")
            os.close(w)
            wk.send_with_fds({"op": "result", "sid": 1, "fds": 1}, [r])
            os.close(r)  # sender's copy; the dup travels in-flight
            sup.settimeout(2.0)
            msg = sup.recv()
            assert msg["op"] == "result"
            (rfd,) = sup.take_fds(1)
            try:
                assert os.read(rfd, 64) == b"via-scm-rights"
            finally:
                os.close(rfd)
            # claiming more fds than arrived is a protocol error
            with pytest.raises(wire.WireError, match="fd"):
                sup.take_fds(1)
        finally:
            sup.close()
            wk.close()

    def test_fds_refused_on_tcp(self):
        lst, addr = wire.listen("tcp", "127.0.0.1:0")
        wk = wire.connect("tcp", addr, role="wk")
        conn, _ = lst.accept()
        sup = wire.wrap(conn, "tcp", role="sup")
        lst.close()
        try:
            assert not wk.supports_fds
            with pytest.raises(wire.WireError, match="SCM_RIGHTS"):
                wk.send_with_fds({"op": "result"}, [0])
        finally:
            sup.close()
            wk.close()

    def test_shm_fault_kinds_are_registered(self):
        for kind in ("shm_torn", "shm_stale"):
            assert kind in faultinj.FAULT_KINDS


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

MESSAGES = [
    {"op": "ping", "t": 1.5},
    {"op": "submit", "sid": 7, "kind": "q6", "params": {"rows": 4096,
                                                        "seed": 3},
     "tenant": "t-ä", "priority": 2, "est_bytes": 1 << 20,
     "timeout_s": None},
    {"op": "result", "sid": 7, "ok": True, "value": [1, -2.5, "x", None],
     "status": "done"},
    {"op": "bye", "clean": True, "residue": {}, "store_len": 0},
    {},
]


@pytest.mark.parametrize("msg", MESSAGES,
                         ids=["ping", "submit", "result", "bye", "empty"])
def test_control_frames_are_the_references_bytes(msg):
    assert wire._frame(msg) == jwire._frame(msg)


@pytest.mark.parametrize("payload", [b"", b"chunk", bytes(range(256)) * 9])
def test_data_frames_are_the_references_bytes(payload):
    for sid, seq in ((0, 0), (9, 3), (2 ** 32 - 1, 2 ** 31)):
        assert wire._data_frame(sid, seq, payload) == \
            jwire._data_frame(sid, seq, payload)


def test_hello_is_the_references():
    assert wire.hello_msg(3, 1234, 7, "3-7-ab", active_sids=[5, 2]) == \
        jwire.hello_msg(3, 1234, 7, "3-7-ab", active_sids=[5, 2])
    assert (wire.MAX_FRAME, wire.MAX_DATA_FRAME, wire.DATA_FLAG,
            wire.FRAME_DEADLINE_S) == (jwire.MAX_FRAME, jwire.MAX_DATA_FRAME,
                                       jwire.DATA_FLAG,
                                       jwire.FRAME_DEADLINE_S)


@pytest.mark.parametrize("kind", ["unix", "tcp"])
def test_each_package_reads_the_other(kind):
    """A reference endpoint and a port endpoint on one connection:
    control and data frames cross both ways unchanged."""
    if kind == "unix":
        sa, sb = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        ref = jwire.wrap(sa, "unix", role="sup")
        port = wire.wrap(sb, "unix", role="wk")
    else:
        lst, addr = wire.listen("tcp", "127.0.0.1:0")
        port = wire.connect("tcp", addr, role="wk")
        conn, _ = lst.accept()
        ref = jwire.wrap(conn, "tcp", role="sup")
        lst.close()
    try:
        ref.settimeout(2.0)
        port.settimeout(2.0)
        port.hello(3, 1234, fence_epoch=7, resume_token="3-7-ab")
        assert ref.recv() == jwire.hello_msg(3, 1234, 7, "3-7-ab")
        for msg in MESSAGES:
            ref.send(msg)
            assert port.recv() == msg
            port.send(msg)
            assert ref.recv() == msg
        port.send_data(9, 1, b"port-bytes")
        assert tuple(ref.recv()) == (9, 1, b"port-bytes")
        ref.send_data(4, 0, b"ref-bytes")
        assert tuple(port.recv()) == (4, 0, b"ref-bytes")
    finally:
        ref.close()
        port.close()


PORTED_KINDS = ["task_cancel", "net_drop", "net_stall", "net_torn",
                "shm_torn", "shm_stale", "supervisor_crash", "journal_torn"]


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_fault_kinds_raise_the_references_errors(kind):
    """Each kind this slice ports fires an error of the reference's
    class name, bases and message at the same probe."""
    from spark_rapids_jni_tpu import faultinj as jfaultinj

    cfg = {"faults": [{"match": "probe_x", "fault": kind, "count": 1}]}
    raised = []
    for mod in (faultinj, jfaultinj):
        with mod.scope(cfg):
            with pytest.raises(Exception) as e:
                mod.instrument(lambda: None, "probe_x")()
        raised.append(e.value)
    port, ref = raised
    assert type(port).__name__ == type(ref).__name__
    assert str(port) == str(ref)
    assert [b.__name__ for b in type(port).__mro__[1:]] == \
        [b.__name__ for b in type(ref).__mro__[1:]]
    assert kind not in faultinj.UNPORTED_KINDS
