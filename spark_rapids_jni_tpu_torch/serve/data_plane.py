"""Zero-copy data plane for the serving fleet.

Counterpart of ``spark_rapids_jni_tpu/serve/data_plane.py`` over the
port's columns.  The framed JSON wire (:mod:`.wire`) is a fine CONTROL
plane, but a wall for data: every result batch would cross as
base64-in-JSON under a 16MB frame cap.  So control messages stay on the
CRC-trailered JSON wire, and a result payload (one Arrow IPC stream,
``columnar/arrow.py`` ``batch_to_ipc``, or any bytes) crosses on one of
three planes:

``shm``
    The writer puts the bytes into a ``memfd`` segment, seals it, and
    passes the fd over the Unix socket with SCM_RIGHTS.  The reader maps
    it read-only; payload bytes never touch the JSON serializer or the
    socket buffer.
``frames``
    The same bytes chunked into binary data frames on the existing
    socket (MSB-flagged length prefix, per-frame CRC): the TCP /
    multi-host fallback that still bypasses JSON.
``json``
    Debug fallback: base64 payload inlined in the result message.
    Raises :class:`DataPlaneOverflow` (a ``WireDesync``) when the frame
    would exceed the control-plane cap — loud, never truncated.

Either way the result message carries a JSON *descriptor* — segment
name, fence epoch, size, schema fingerprint, per-chunk CRC32s — and the
reader verifies epoch (stale-generation rejection) and every chunk CRC
(torn-payload rejection) before a single buffer is interpreted.

Segment lifecycle: create (writer memfd, name stamped with the writer's
fence epoch) -> stamp (chunk CRCs into the descriptor) -> map (reader,
read-only) -> reap (unmapped after decode; stashed fds are closed with
the transport when a worker is lost).

This module, like :mod:`.wire` and :mod:`.journal`, needs no pyarrow:
only the encoding of a batch into IPC bytes does.
"""

from __future__ import annotations

import base64
import mmap
import os
import zlib
from typing import List, Optional

from .. import config
from ..columnar.column import ColumnBatch
# the digest of a batch's values, byte for byte the reference's
from ..shuffle.morsel import batch_digest  # noqa: F401
from . import wire

MB = 1 << 20


class DataPlaneOverflow(wire.WireDesync):
    """A ``serve_data_plane=json`` payload would exceed the control-plane
    frame cap — refused loudly instead of truncated silently."""


class DataPlaneCorruption(RuntimeError):
    """A payload chunk failed its descriptor CRC (torn segment/frame)."""


class DataPlaneStale(RuntimeError):
    """A descriptor announced a segment from a dead fence epoch."""


PLANES = ("shm", "frames", "json")


def resolve_plane(setting: Optional[str] = None,
                  transport_kind: str = "unix") -> str:
    """Resolve the ``serve_data_plane`` knob against a transport kind."""
    setting = setting or config.get("serve_data_plane")
    if setting == "auto":
        return "shm" if transport_kind == "unix" else "frames"
    if setting not in PLANES:
        raise ValueError(
            f"serve_data_plane={setting!r}; expected auto|shm|frames|json")
    if setting == "shm" and transport_kind != "unix":
        raise ValueError(
            "serve_data_plane=shm needs SCM_RIGHTS fd-passing; the "
            f"{transport_kind!r} transport cannot carry fds — use "
            "'frames' (or 'auto') for multi-host fleets")
    return setting


def segment_name(worker_id: int, epoch: int, seq: int) -> str:
    """Fence-epoch-stamped segment name: a replacement incarnation can
    never alias a dead generation's segment."""
    return f"seg-w{worker_id}-g{epoch}-{seq}"


def chunk_crcs(payload, chunk_bytes: int) -> List[int]:
    """Per-chunk CRC32 stamps over a bytes-like payload."""
    view = memoryview(payload)
    return [zlib.crc32(view[off: off + chunk_bytes])
            for off in range(0, len(view), chunk_bytes)] or [zlib.crc32(b"")]


def build_descriptor(plane: str, seg: str, size: int, schema_fp: str,
                     chunk_bytes: int, crcs: List[int], epoch: int,
                     snapshot=None) -> dict:
    """The JSON side of a data-plane result: everything the supervisor
    needs to verify and decode the payload, and nothing payload-sized.

    ``snapshot`` (optional) stamps the input snapshot id the result was
    computed FROM — carried by workers when the submit declared one,
    and by a result cache's fresh hit descriptors; verified against
    the requester's snapshot by :func:`verify_snapshot` so a rewound
    entry can never serve a mutated input."""
    desc = {
        "v": 1,
        "plane": plane,
        "seg": seg,
        "size": int(size),
        "offset": 0,
        "schema_fp": schema_fp,
        "chunk_bytes": int(chunk_bytes),
        "crcs": [int(c) for c in crcs],
        "epoch": int(epoch),
    }
    if snapshot is not None:
        desc["snapshot"] = snapshot
    return desc


def verify_chunks(payload, desc: dict) -> None:
    """Re-CRC every chunk against the descriptor stamps.

    Raises :class:`DataPlaneCorruption` naming the first torn chunk —
    the caller must treat the whole payload as garbage (re-place the
    session), never decode past a bad stamp."""
    view = memoryview(payload)
    if len(view) != int(desc["size"]):
        raise DataPlaneCorruption(
            f"segment {desc.get('seg')}: payload is {len(view)} bytes, "
            f"descriptor says {desc['size']}")
    got = chunk_crcs(view, int(desc["chunk_bytes"]))
    want = [int(c) for c in desc["crcs"]]
    if len(got) != len(want):
        raise DataPlaneCorruption(
            f"segment {desc.get('seg')}: {len(got)} chunks vs "
            f"{len(want)} descriptor stamps")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise DataPlaneCorruption(
                f"segment {desc.get('seg')}: chunk {i} CRC "
                f"{g:#010x} != stamped {w:#010x} (torn payload)")


def verify_epoch(desc: dict, expect_epoch: int) -> None:
    """Reject descriptors from any generation but the live one."""
    got = int(desc.get("epoch", -1))
    if got != int(expect_epoch):
        raise DataPlaneStale(
            f"segment {desc.get('seg')}: descriptor epoch {got} != "
            f"worker generation {expect_epoch} (stale segment reuse)")


def verify_snapshot(desc: dict, expect_snapshot) -> None:
    """Reject a descriptor computed from any input contents but the
    requested ones — the result cache's exactness fence.

    ``expect_snapshot`` None means the requester declared no snapshot
    (nothing was cached, nothing to check).  A descriptor MISSING a
    snapshot while one is expected is stale by definition: provenance
    cannot be proven, so the result is recomputed."""
    if expect_snapshot is None:
        return
    got = desc.get("snapshot")
    if got != expect_snapshot:
        raise DataPlaneStale(
            f"segment {desc.get('seg')}: descriptor snapshot {got!r} != "
            f"requested snapshot {expect_snapshot!r} (rewound/mutated "
            f"input — refusing stale serve)")


# ---- shm plane (memfd + SCM_RIGHTS) ---------------------------------------

def make_segment(name: str, payload) -> int:
    """Write a payload into a fresh memfd; returns the fd (unsealed —
    the caller seals via :func:`seal_segment` after its CRC-vs-damage
    window closes)."""
    fd = os.memfd_create(name, os.MFD_CLOEXEC)
    view = memoryview(payload)
    os.truncate(fd, len(view))
    off = 0
    while off < len(view):
        off += os.pwrite(fd, view[off:], off)
    return fd


def seal_segment(fd: int) -> None:
    """Best-effort F_SEAL_* so the mapped segment can never change or
    shrink under the supervisor's read-only mapping."""
    try:
        import fcntl

        fcntl.fcntl(fd, fcntl.F_ADD_SEALS,
                    fcntl.F_SEAL_SHRINK | fcntl.F_SEAL_GROW
                    | fcntl.F_SEAL_WRITE)
    except (ImportError, AttributeError, OSError):
        pass


def read_segment(fd: int, desc: dict) -> bytes:
    """Map a received segment read-only, copy out the payload bytes,
    and verify the copy.  The mapping is dropped BEFORE verification:
    a raised :class:`DataPlaneCorruption` pins its frame locals in the
    traceback, and a memoryview over a live mmap there would make the
    map unclosable (``BufferError: cannot close exported pointers``).
    The caller still owns (and must close) the fd."""
    size = int(desc["size"])
    if size == 0:
        verify_chunks(b"", desc)
        return b""
    m = mmap.mmap(fd, size, prot=mmap.PROT_READ)
    try:
        data = m[:]
    finally:
        m.close()
    verify_chunks(data, desc)
    return data


# ---- json plane ------------------------------------------------------------

def encode_json_payload(payload, cap: Optional[int] = None) -> str:
    """Base64 for the debug ``json`` plane.  Refuses — loudly, as a
    :class:`DataPlaneOverflow` — any payload whose encoding would push
    the result message over the control-frame cap (minus descriptor
    headroom): the JSON wire truncates nothing, ever."""
    if cap is None:
        cap = wire.MAX_FRAME - 4096
    s = base64.b64encode(bytes(payload)).decode("ascii")
    if len(s) > cap:
        raise DataPlaneOverflow(
            f"serve_data_plane=json cannot carry a {len(memoryview(payload))}B "
            f"payload ({len(s)}B base64) under the {cap}B control-frame "
            f"budget — use the shm or frames plane")
    return s


def decode_json_payload(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


# ---- batch plumbing --------------------------------------------------------

def is_batch(value) -> bool:
    """Does this result value ride the data plane?"""
    return isinstance(value, ColumnBatch)
