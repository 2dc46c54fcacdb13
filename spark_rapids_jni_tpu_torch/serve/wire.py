"""Length-prefixed JSON frames + the fleet transport abstraction.

Counterpart of ``spark_rapids_jni_tpu/serve/wire.py``; its frames are
byte for byte the reference's.  A fleet's supervisor/worker protocol
rides one stream socket per worker.  Each message is a
little-endian ``u32`` byte length, that many bytes of UTF-8 JSON, and a
little-endian ``u32`` CRC32 trailer over the payload — JSON (not
pickle) on purpose, so a crashed or compromised worker can never make
the supervisor execute anything, and the trailer catches a torn or
bit-flipped frame before it is parsed as a different message.

Two transports share the framing (:class:`Transport`):

* :class:`UnixTransport` — the single-box default: one Unix-domain
  socket under the private fleet directory.
* :class:`TcpTransport` — multi-host placement: workers dial the
  supervisor's ``host:port`` listener (``TCP_NODELAY``; frames are
  control-plane small).

Both enforce the frame cap, verify the CRC trailer, and carry
read/write deadlines: a frame that stays incomplete past
``frame_deadline_s`` is a DESYNC (:class:`WireDesync` — the stream can
no longer be re-synchronized, the connection must close), while a
timeout at a frame boundary is just an idle poll tick
(``socket.timeout`` — retryable).  ``send``/``recv`` retry ``EINTR``.

Connections open with an idempotent ``hello`` carrying
``(worker_id, fence_epoch, resume_token)``: re-sending it after a
reconnect re-attaches the SAME worker incarnation (token + pid match)
to its live sessions instead of spawning state anew — a lost
*connection* is recoverable where a lost *worker* is not.

Network fault domains: every transport send crosses the
``net_send_<role>`` injection probe and every received frame crosses
``net_recv_<role>`` (role ``sup`` on the supervisor side, ``wk`` on the
worker side), so ``tools/chaos.py`` can land ``net_drop`` (link dies),
``net_stall`` (peer stalls past the deadline, then dies) and
``net_torn`` (truncated frame on the wire) on either side of either
direction.  The transport converts each injected fault into its real
wire damage; recovery is the caller's reconnect.

Messages (``op`` discriminates):

======== ============ ====================================================
sender   op           payload
======== ============ ====================================================
worker   ``hello``    ``worker_id``, ``pid``, ``fence_epoch``,
                      ``resume_token`` — sent after every (re)connect;
                      ``active_sids`` (optional) lists the sessions the
                      worker still holds, so an ADOPTING supervisor
                      (the serve/journal.py restart path) can reconcile its
                      replayed placements against reality and cancel
                      sids its journal never committed
super    ``ping``     ``t`` (echo token)
worker   ``pong``     ``t``, ``stall_breaks`` (native stall-breaker
                      epoch), ``live_sessions``, ``queue_depth`` /
                      ``arena_bytes`` / ``pool_bytes`` (load signals for
                      the elastic placement scorer),
                      ``fence_epoch``, ``fired`` (injection trace so
                      far)
super    ``submit``   ``sid``, ``kind``, ``params``, ``tenant``,
                      ``priority``, ``est_bytes``, ``timeout_s``
worker   ``running``  ``sid`` — the session left the admission queue
worker   ``result``   ``sid``, ``ok``, ``value`` | ``error``/``message``,
                      ``status``
super    ``cancel``   ``sid``
super    ``drain``    — retirement order: finish placed sessions,
                      accept nothing new, self-fence the generation,
                      ``bye`` with ``retired=True``, exit
super    ``shutdown`` —
worker   ``bye``      ``clean``, ``residue``, ``store_len``,
                      ``leftovers``, ``retired``, ``fenced_commits``,
                      ``fired``
======== ============ ====================================================

``send_msg`` takes an optional lock so a worker's result watchers and
its main loop can share one socket without interleaving frames.

Data plane: the JSON frames above are the CONTROL plane.  Bulk
result payloads cross either out-of-band (memfd + SCM_RIGHTS on
:class:`UnixTransport` — see serve/data_plane.py) or as binary DATA
frames on this same socket: the length prefix's MSB
(:data:`DATA_FLAG` — safe because ``MAX_FRAME`` < 2^31) marks a frame
whose body is ``<u32 sid, u32 seq>`` + raw payload chunk, CRC-trailered
like every other frame but never JSON-parsed.  Control frames keep the
16MB cap; data frames are bounded by ``MAX_DATA_FRAME`` and chunked at
the ``serve_segment_bytes`` knob so control messages interleave instead
of queueing behind a payload.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import List, NamedTuple, Optional, Tuple

from .. import faultinj

_HDR = struct.Struct("<I")
_CRC = struct.Struct("<I")
# data-frame body header: (sid, seq) routes a payload chunk to its
# session's reassembly stash without touching JSON
_DHDR = struct.Struct("<II")
# a CONTROL frame is metadata, never bulk data; anything bigger is a
# protocol bug or a corrupted length prefix.  DATA frames (flagged by
# the MSB of the length prefix) carry payload chunks and get their own,
# larger cap.
MAX_FRAME = 16 << 20
MAX_DATA_FRAME = 64 << 20
# the length prefix's MSB marks a binary data frame — MAX_FRAME and
# MAX_DATA_FRAME both fit well under 2^31, so the bit is free
DATA_FLAG = 0x8000_0000
# how long one frame may stay incomplete once its first byte arrived
# before the stream is declared desynced
FRAME_DEADLINE_S = 5.0


class DataChunk(NamedTuple):
    """One binary data-plane chunk, reassembled per ``sid`` by the
    receiver; ``seq`` orders chunks within a payload."""

    sid: int
    seq: int
    payload: bytes


class WireError(ConnectionError):
    """The peer closed mid-frame, sent an impossible length, failed the
    CRC trailer, or an injected network fault killed the link."""


class WireDesync(WireError):
    """The stream can no longer be re-synchronized — a frame stayed
    incomplete past its deadline or its trailer failed verification.
    The only recovery is closing the connection; reading on would parse
    payload bytes as headers."""


def _retry_eintr(fn, *args):
    # PEP 475 retries EINTR for us on modern Pythons, but a signal
    # handler installed by embedding code can still surface it — the
    # wire layer must never mistake an interrupted syscall for a fault
    while True:
        try:
            return fn(*args)
        except InterruptedError:
            continue


def _frame(obj: dict) -> bytes:
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(data) > MAX_FRAME:
        raise WireError(f"frame of {len(data)}B exceeds {MAX_FRAME}B")
    return _HDR.pack(len(data)) + data + _CRC.pack(zlib.crc32(data))


def _data_frame(sid: int, seq: int, payload) -> bytes:
    body = _DHDR.pack(sid, seq) + bytes(payload)
    if len(body) > MAX_DATA_FRAME:
        raise WireError(
            f"data frame of {len(body)}B exceeds {MAX_DATA_FRAME}B")
    return (_HDR.pack(DATA_FLAG | len(body)) + body
            + _CRC.pack(zlib.crc32(body)))


def send_msg(sock: socket.socket, obj: dict,
             lock: Optional[threading.Lock] = None):
    frame = _frame(obj)
    if lock is not None:
        with lock:
            _retry_eintr(sock.sendall, frame)
    else:
        _retry_eintr(sock.sendall, frame)


def recv_msg(sock: socket.socket,
             deadline_s: Optional[float] = FRAME_DEADLINE_S) -> dict:
    """Read one CONTROL frame; raises :class:`WireError` on EOF/garbage
    (including an unexpected data frame — control-only contexts), a
    :class:`WireDesync` when a frame stays incomplete past
    ``deadline_s`` or fails its CRC trailer, and lets ``socket.timeout``
    through ONLY at a frame boundary so pollers can keep ticking."""
    got = recv_any(sock, deadline_s=deadline_s)
    if isinstance(got, DataChunk):
        raise WireError(
            f"unexpected data frame (sid={got.sid} seq={got.seq}) on a "
            f"control-only stream")
    return got


def recv_any(sock: socket.socket,
             deadline_s: Optional[float] = FRAME_DEADLINE_S,
             recv=None):
    """Read one frame of either plane: a ``dict`` for JSON control
    frames, a :class:`DataChunk` for binary data frames.  ``recv``
    overrides the raw read callable (the Unix transport threads its
    fd-stashing ``recv_fds`` reader through here)."""
    hdr = _recv_exact(sock, _HDR.size, deadline_s=deadline_s,
                      boundary=True, recv=recv)
    (n,) = _HDR.unpack(hdr)
    if n & DATA_FLAG:
        n &= ~DATA_FLAG
        if n > MAX_DATA_FRAME:
            raise WireError(f"data frame length {n} exceeds "
                            f"{MAX_DATA_FRAME}")
        if n < _DHDR.size:
            raise WireError(f"data frame length {n} below header size")
        body = _recv_exact(sock, n + _CRC.size, deadline_s=deadline_s,
                           recv=recv)
        data, trailer = body[:n], body[n:]
        (crc,) = _CRC.unpack(trailer)
        if crc != zlib.crc32(data):
            raise WireDesync(
                f"data frame CRC mismatch ({crc:#010x} != "
                f"{zlib.crc32(data):#010x}): torn or corrupted chunk")
        sid, seq = _DHDR.unpack_from(data)
        return DataChunk(sid, seq, data[_DHDR.size:])
    if n > MAX_FRAME:
        raise WireError(f"frame length {n} exceeds {MAX_FRAME}")
    body = _recv_exact(sock, n + _CRC.size, deadline_s=deadline_s,
                       recv=recv)
    data, trailer = body[:n], body[n:]
    (crc,) = _CRC.unpack(trailer)
    if crc != zlib.crc32(data):
        raise WireDesync(
            f"frame CRC mismatch ({crc:#010x} != "
            f"{zlib.crc32(data):#010x}): torn or corrupted frame")
    return json.loads(data.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int, *,
                deadline_s: Optional[float] = None,
                boundary: bool = False, recv=None) -> bytes:
    """Read exactly ``n`` bytes.  A timeout with ZERO bytes read at a
    frame ``boundary`` is idle and re-raised for the poller; a timeout
    mid-frame keeps reading only until ``deadline_s`` has elapsed since
    the frame started — past that the stream is desynced for good and
    :class:`WireDesync` says so (the caller must close)."""
    buf = bytearray()
    started: Optional[float] = None
    while len(buf) < n:
        try:
            if recv is not None:
                chunk = recv(n - len(buf))
            else:
                chunk = _retry_eintr(sock.recv, n - len(buf))
        except socket.timeout:
            if boundary and not buf:
                raise  # idle between frames: retryable
            if started is None:
                started = time.monotonic()
            elif deadline_s is not None \
                    and time.monotonic() - started > deadline_s:
                raise WireDesync(
                    f"frame incomplete after {deadline_s}s "
                    f"({len(buf)}/{n}B): peer stalled mid-frame") from None
            continue
        if not chunk:
            raise WireError("peer closed mid-frame")
        if started is None:
            started = time.monotonic()
        buf.extend(chunk)
    return bytes(buf)


def hello_msg(worker_id: int, pid: int, fence_epoch: int,
              resume_token: str,
              active_sids: Optional[List[int]] = None) -> dict:
    """The idempotent connection opener: safe to re-send after every
    reconnect — the supervisor re-attaches on (pid, token) match.
    ``active_sids`` carries the worker's live session ids so a
    restarted supervisor adopting the fleet can reconcile them against
    its journal replay (unknown sids are cancelled, not orphaned)."""
    msg = {"op": "hello", "worker_id": int(worker_id), "pid": int(pid),
           "fence_epoch": int(fence_epoch),
           "resume_token": str(resume_token)}
    if active_sids is not None:
        msg["active_sids"] = sorted(int(s) for s in active_sids)
    return msg


class Transport:
    """One framed connection with deadlines and network fault probes.

    Shared by both concrete transports; ``role`` ("sup" | "wk") names
    which side of the link this endpoint is, so chaos can target the
    supervisor's sends independently of the worker's."""

    kind = "stream"
    supports_fds = False

    def __init__(self, sock: socket.socket, role: str = "peer",
                 frame_deadline_s: float = FRAME_DEADLINE_S,
                 stall_s: float = 0.5):
        self.sock = sock
        self.role = role
        self.frame_deadline_s = float(frame_deadline_s)
        self.stall_s = float(stall_s)
        self._send_lock = threading.Lock()
        self._closed = False
        self._fd_stash: List[int] = []
        self._probe_send = faultinj.instrument(
            lambda: None, f"net_send_{role}")
        self._probe_recv = faultinj.instrument(
            lambda: None, f"net_recv_{role}")

    # -- deadline / lifecycle -------------------------------------------
    def settimeout(self, t: Optional[float]):
        """The poll tick: how often ``recv`` surfaces an idle
        ``socket.timeout`` at a frame boundary."""
        self.sock.settimeout(t)

    def close(self):
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass
        # reap stashed fds nobody claimed (worker lost mid-transfer):
        # the segment dies with its last fd, like a spill dir rmtree
        stash, self._fd_stash = self._fd_stash, []
        for fd in stash:
            try:
                os.close(fd)
            except OSError:
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    # -- framed I/O with injected network faults ------------------------
    def _send_frame(self, frame: bytes, fds: Optional[List[int]] = None):
        """One locked, probed, deadline'd frame write (both planes).
        An injected network fault (or a send blocked past the socket
        timeout) kills the link: the socket closes and
        :class:`WireError` surfaces — a partial frame may be on the
        wire, so no retry on this connection is possible."""
        with self._send_lock:
            try:
                self._probe_send()
            except faultinj.NetDropError as e:
                self.close()
                raise WireError(f"injected link drop on send: {e}") from e
            except faultinj.NetStallError as e:
                # the injected stall MUST wedge the send path — that is
                # the fault being simulated
                time.sleep(self.stall_s)
                self.close()
                raise WireError(f"injected link stall on send: {e}") from e
            except faultinj.NetTornError as e:
                # real wire damage: the header promises a full payload
                # but only half arrives before the close — the peer's
                # CRC/desync machinery must catch it
                torn = frame[:_HDR.size + max(1, (len(frame)
                                                  - _HDR.size) // 2)]
                try:
                    _retry_eintr(self.sock.sendall, torn)
                except OSError:
                    pass
                self.close()
                raise WireError(f"injected torn frame on send: {e}") from e
            try:
                if fds:
                    sent = _retry_eintr(
                        socket.send_fds, self.sock, [frame], fds)
                    if sent < len(frame):
                        _retry_eintr(self.sock.sendall, frame[sent:])
                else:
                    _retry_eintr(self.sock.sendall, frame)
            except socket.timeout:
                self.close()
                raise WireDesync(
                    "send blocked past the write deadline "
                    "(partial frame possibly on the wire)") from None
            except OSError:
                self.close()
                raise

    def send(self, obj: dict):
        """Send one control frame (see :meth:`_send_frame`)."""
        self._send_frame(_frame(obj))

    def send_data(self, sid: int, seq: int, payload):
        """Send one binary data-plane chunk.  Each chunk is its own
        frame under the send lock, so control messages interleave
        between chunks instead of queueing behind the payload."""
        self._send_frame(_data_frame(sid, seq, payload))

    def send_with_fds(self, obj: dict, fds: List[int]):
        """Send a control frame with fds attached via SCM_RIGHTS (shm
        descriptors travel WITH their segment fd, atomically)."""
        if fds and not self.supports_fds:
            raise WireError(
                f"{self.kind!r} transport cannot carry fds "
                f"(SCM_RIGHTS is Unix-domain only)")
        self._send_frame(_frame(obj), fds=fds)

    def take_fds(self, k: int) -> List[int]:
        """Claim ``k`` fds received ahead of (or with) the current
        control frame, in arrival order."""
        if len(self._fd_stash) < k:
            raise WireError(
                f"descriptor claims {k} fd(s) but only "
                f"{len(self._fd_stash)} arrived on this connection")
        out, self._fd_stash = self._fd_stash[:k], self._fd_stash[k:]
        return out

    def _recv_chunk(self, n: int) -> bytes:
        return _retry_eintr(self.sock.recv, n)

    def recv(self):
        """Receive one frame of either plane: a ``dict`` (control) or a
        :class:`DataChunk` (data).  ``socket.timeout`` surfaces only at
        a frame boundary (idle poll tick); any wire damage — including
        an injected fault on this received frame — closes the link and
        raises :class:`WireError`."""
        try:
            msg = recv_any(self.sock, deadline_s=self.frame_deadline_s,
                           recv=self._recv_chunk)
        except socket.timeout:
            raise
        except (WireError, OSError, ValueError):
            self.close()
            raise
        try:
            self._probe_recv()
        except faultinj.NetDropError as e:
            self.close()
            raise WireError(f"injected link drop on recv: {e}") from e
        except faultinj.NetStallError as e:
            time.sleep(self.stall_s)
            self.close()
            raise WireError(f"injected link stall on recv: {e}") from e
        except faultinj.NetTornError as e:
            self.close()
            raise WireDesync(f"injected torn frame on recv: {e}") from e
        return msg

    def hello(self, worker_id: int, pid: int, fence_epoch: int,
              resume_token: str, **extra):
        msg = hello_msg(worker_id, pid, fence_epoch, resume_token)
        msg.update(extra)
        self.send(msg)


class UnixTransport(Transport):
    kind = "unix"
    supports_fds = True

    # ancillary-data budget per recvmsg: a result descriptor carries one
    # segment fd; 32 leaves slack for pipelined results on one tick
    _MAX_FDS = 32

    def _recv_chunk(self, n: int) -> bytes:
        data, fds, _flags, _addr = _retry_eintr(
            socket.recv_fds, self.sock, n, self._MAX_FDS)
        if fds:
            self._fd_stash.extend(fds)
        return data


class TcpTransport(Transport):
    kind = "tcp"

    def __init__(self, sock: socket.socket, role: str = "peer", **kw):
        super().__init__(sock, role=role, **kw)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not fatal: frames are small either way


_TRANSPORTS = {"unix": UnixTransport, "tcp": TcpTransport}


def wrap(sock: socket.socket, kind: str, role: str, **kw) -> Transport:
    """Wrap an accepted/connected socket in the right transport."""
    try:
        cls = _TRANSPORTS[kind]
    except KeyError:
        raise ValueError(
            f"unknown transport {kind!r} (known: "
            f"{sorted(_TRANSPORTS)})") from None
    return cls(sock, role=role, **kw)


def listen(kind: str, where: str, backlog: int = 8
           ) -> Tuple[socket.socket, str]:
    """Bind a listener; returns ``(socket, address)`` where the address
    is what workers dial — the Unix path, or ``host:port`` with the
    kernel-assigned port filled in for ``tcp`` ``host:0`` binds."""
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(where)
        s.listen(backlog)
        return s, where
    if kind == "tcp":
        host, _, port = where.rpartition(":")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host or "127.0.0.1", int(port or 0)))
        s.listen(backlog)
        bound = s.getsockname()
        return s, f"{bound[0]}:{bound[1]}"
    raise ValueError(f"unknown transport {kind!r}")


def connect(kind: str, address: str, role: str,
            timeout_s: float = 5.0, **kw) -> Transport:
    """Dial ``address`` and return the wrapped transport (no hello yet —
    the caller sends it, idempotently, on every (re)connect)."""
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout_s)
        s.connect(address)
    elif kind == "tcp":
        host, _, port = address.rpartition(":")
        s = socket.create_connection((host, int(port)), timeout=timeout_s)
    else:
        raise ValueError(f"unknown transport {kind!r}")
    return wrap(s, kind, role, **kw)
