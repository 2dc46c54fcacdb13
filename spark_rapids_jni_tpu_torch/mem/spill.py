"""Tiered spill store: central registry, cross-task eviction, metrics.

Counterpart of ``spark_rapids_jni_tpu/mem/spill.py`` (the plugin-side
``SpillableDeviceStore``/``SpillableHostStore``/``SpillableDiskStore``):
every spillable batch registers with one process-wide store, and any task
under memory pressure evicts other tasks' idle batches one tier down,
device -> host -> disk, with every transition counted.

* :class:`SpillableHandle`: one batch in exactly one of three tiers.
  DEVICE: the tree of tensors, charged to the device arena through its
  ``TaskContext``.  HOST: numpy copies, charged to the unified host arena
  of :mod:`.rmm_spark`.  DISK: ``.npy`` files (optionally codec-framed,
  :mod:`.codec`) in the framework's spill directory.  A per-handle RLock
  serializes the owner's ``get()`` against another thread's ``spill()``;
  evictors try-lock, so a busy handle is skipped, never waited on.
  ``pin()`` keeps a handle resident while a step uses it.
* :class:`SpillableStore`: ``spill_device_to_fit`` walks handles LRU
  first (by last ``get()``), other tasks' batches before the requesting
  task's own, skipping pinned ones.
* :class:`SpillFramework` (:func:`install`/:func:`shutdown`/
  :func:`get_framework`): the store, the spill directory and
  :class:`SpillMetrics`.  The host tier is bounded: a demotion that does
  not fit the host arena first demotes colder host batches to disk, and
  goes to disk itself when the arena still refuses (``CpuRetryOOM``).
* :func:`~.executor.run_with_retry`, with a framework installed, evicts
  through the store by default on a ``RetryOOM``.

A tree is any nesting of tensors in dicts, lists, tuples, a
:class:`~..columnar.column.ColumnBatch` and the column dataclasses
(plain, string, decimal, list, struct, bucketed, dictionary, run-length,
bit-packed, frame-of-reference).  Everything that is not a tensor (type
tags, ``dict_token``, widths, references, zone maps) is kept as the
tree's structure.  Each distinct tensor is copied once (a validity shared
by two columns is one host buffer and one charge, and comes back as one
tensor) and goes back to the device it came from, with its dtype and
shape.  Tensors of a dtype numpy lacks (``bfloat16``) cannot spill.

Integrity and lineage: with ``spill_checksum`` on, each host buffer's
CRC32 and byte length are recorded at demotion and verified at promotion;
the disk tier inherits that record rather than hashing again, so damage
to either lower tier is caught before anything computes on it.  A handle
built with ``recompute=`` rebuilds from it when its spilled copy is
damaged, truncated or lost (``lineage_rebuilds``); without it the damage
raises :class:`~..faultinj.SpillCorruptionError`.  The disk boundary is
instrumented (``spill_io_write``/``spill_io_read``, fault kind
``spill_io``): a failed write leaves the batch in the host tier and counts
a ``disk_write_failures``.  The probes ``spill_corrupt_file`` and
``host_corrupt_probe`` turn an injected fault into real byte flips in the
file just written or the host copy just made.

Cross-thread eviction: an evicting task's thread copies the victim's
tensors to the host while the owner may still have kernels queued on
them.  That is safe only because every thread launches on the one
default stream and ``Tensor.cpu()`` synchronizes with it: the copy runs
after the owner's queued kernels.  A design that gives each task its own
stream must record an event on the owner's stream and wait on it before
the copy.  The copy is a plain, synchronous ``.cpu()`` into pageable
memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config, faultinj
from ..columnar.column import ColumnBatch, StructColumn
from ..device import resolve_device
from . import codec as _codec
from .rmm_spark import CpuRetryOOM, CpuSplitAndRetryOOM, RmmSpark

# monotonic use-clock for LRU ordering (itertools.count is atomic under
# the GIL)
_use_clock = itertools.count(1)


def _next_use() -> int:
    return next(_use_clock)


# ---------------------------------------------------------------------------
# instrumented disk I/O (the spill_io fault-injection boundary)
# ---------------------------------------------------------------------------

def _write_leaf(path: str, arr: np.ndarray) -> None:
    np.save(path, arr, allow_pickle=False)


def _read_leaf(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=False)


_write_leaf = faultinj.instrument(_write_leaf, "spill_io_write")
_read_leaf = faultinj.instrument(_read_leaf, "spill_io_read")

# fires after a leaf lands on disk: the handler turns the injected
# SpillCorruptionError into byte flips in that file (kind spill_corrupt)
_corrupt_probe = faultinj.instrument(lambda: None, "spill_corrupt_file")

# fires after the device tree is copied to the host: the handler flips
# bytes in the copy just made (kind host_corrupt)
_host_corrupt_probe = faultinj.instrument(lambda: None, "host_corrupt_probe")


def _flip_host_bytes(arr: np.ndarray, n: int = 8) -> np.ndarray:
    """XOR the last ``n`` bytes of a host buffer (returned as a copy)."""
    flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1).copy()
    n = min(n, flat.size)
    if n > 0:
        flat[-n:] ^= 0xFF
    return flat.view(arr.dtype)[: arr.size].reshape(arr.shape)


def _flip_file_bytes(path: str, n: int = 8) -> None:
    """XOR the last ``n`` bytes of ``path``: the npy data region, so the
    file still loads but is wrong (only a checksum catches it)."""
    size = os.path.getsize(path)
    n = min(n, size)
    if n <= 0:
        return
    with open(path, "r+b") as f:
        f.seek(size - n)
        tail = f.read(n)
        f.seek(size - n)
        f.write(bytes(b ^ 0xFF for b in tail))


def _flip_file_head_bytes(path: str, n: int = 8) -> None:
    """XOR the first ``n`` bytes of the npy payload of ``path``: under a
    spill codec, the codec frame's header."""
    with open(path, "r+b") as f:
        head = f.read(12)
        if len(head) < 12 or head[:6] != b"\x93NUMPY":
            start = 0  # not an npy container: damage the very front
        elif head[6] >= 2:
            (hlen,) = struct.unpack_from("<I", head, 8)
            start = 12 + hlen
        else:
            (hlen,) = struct.unpack_from("<H", head, 8)
            start = 10 + hlen
        f.seek(0, os.SEEK_END)
        n = min(n, max(f.tell() - start, 0))
        if n <= 0:
            return
        f.seek(start)
        chunk = f.read(n)
        f.seek(start)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _leaf_meta(arr: np.ndarray) -> Tuple[int, int]:
    """(crc32, nbytes) of a host leaf, hashed in place (no copy of its
    bytes)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8)), int(a.nbytes)


# ---------------------------------------------------------------------------
# trees: flatten to tensors and a structure, and back
# ---------------------------------------------------------------------------

_HOST_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
                torch.int32, torch.int64, torch.float16, torch.float32,
                torch.float64)


def _has_tensor(obj) -> bool:
    from .executor import _tensors

    return next(_tensors(obj), None) is not None


def _flatten(obj, leaves: list):
    """The structure of ``obj``; its tensors are appended to ``leaves``
    in walk order."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("leaf",)
    if isinstance(obj, ColumnBatch):
        return ("batch", obj.names,
                tuple(_flatten(c, leaves) for c in obj.columns))
    if isinstance(obj, StructColumn):
        return ("struct", obj.field_names,
                tuple(_flatten(c, leaves) for c in obj.children),
                _flatten(obj.validity, leaves), obj.dtype)
    if isinstance(obj, dict):
        return ("dict", tuple(obj.keys()),
                tuple(_flatten(v, leaves) for v in obj.values()))
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj), tuple(_flatten(v, leaves) for v in obj))
    if (dataclasses.is_dataclass(obj) and not isinstance(obj, type)
            and _has_tensor(obj)):
        return ("dc", type(obj),
                tuple((f.name, _flatten(getattr(obj, f.name), leaves))
                      for f in dataclasses.fields(obj)))
    return ("const", obj)


def _unflatten(spec, leaves):
    """Inverse of :func:`_flatten` over an iterator of tensors."""
    kind = spec[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "const":
        return spec[1]
    if kind == "batch":
        cols = [_unflatten(s, leaves) for s in spec[2]]
        return ColumnBatch(dict(zip(spec[1], cols)))
    if kind == "struct":
        children = [_unflatten(s, leaves) for s in spec[2]]
        validity = _unflatten(spec[3], leaves)
        return StructColumn(dict(zip(spec[1], children)), validity, spec[4])
    if kind == "dict":
        vals = [_unflatten(s, leaves) for s in spec[2]]
        return dict(zip(spec[1], vals))
    if kind == "seq":
        typ, items = spec[1], [_unflatten(s, leaves) for s in spec[2]]
        if typ in (list, tuple):
            return typ(items)
        return typ(*items)  # a named tuple
    typ, fields = spec[1], spec[2]
    return typ(**{name: _unflatten(s, leaves) for name, s in fields})


def _buffer_key(t: torch.Tensor):
    """Identity of a tensor's bytes: an aliased leaf (one validity in two
    columns) is one buffer."""
    return (t.device, t.data_ptr(), t.nbytes, t.dtype, tuple(t.shape),
            tuple(t.stride()))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no memory with it."""
    h = t.detach()
    if not h.is_contiguous():
        h = h.contiguous()
    h = h.cpu()
    if h.data_ptr() == t.data_ptr():
        h = h.clone()  # a CPU leaf: the host tier owns its bytes
    return h.numpy()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if not a.flags.writeable:
        a = a.copy()  # a decoded frame is a read-only view
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class SpillMetrics:
    """Bytes and counts per tier transition plus eviction time, global
    and per task (keyed by the handle OWNER's task id)."""

    FIELDS = (
        "device_to_host_bytes", "device_to_host_count",
        "host_to_disk_bytes", "host_to_disk_count",
        "disk_to_host_bytes", "disk_to_host_count",      # disk read-back
        "host_to_device_bytes", "host_to_device_count",  # device read-back
        "eviction_ns",
        "disk_write_failures",
        "corrupt_reads",       # read-backs that failed verification/load
        "lineage_rebuilds",    # recoveries via a handle's recompute= hook
        "precompress_bytes",   # original bytes of codec'd disk writes
        "compressed_bytes",    # stored bytes of those writes (post-codec)
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._global = dict.fromkeys(self.FIELDS, 0)
        self._task: Dict[int, Dict[str, int]] = {}

    def _bucket(self, task_id: Optional[int]) -> List[Dict[str, int]]:
        out = [self._global]
        if task_id is not None:
            out.append(self._task.setdefault(
                task_id, dict.fromkeys(self.FIELDS, 0)))
        return out

    def record(self, transition: str, nbytes: int,
               task_id: Optional[int] = None):
        with self._lock:
            for b in self._bucket(task_id):
                b[transition + "_bytes"] += int(nbytes)
                b[transition + "_count"] += 1

    def _add(self, field: str, n: int, task_id: Optional[int]):
        with self._lock:
            for b in self._bucket(task_id):
                b[field] += int(n)

    def add_eviction_ns(self, ns: int, task_id: Optional[int] = None):
        self._add("eviction_ns", ns, task_id)

    def disk_write_failed(self, task_id: Optional[int] = None):
        self._add("disk_write_failures", 1, task_id)

    def corrupt_read(self, task_id: Optional[int] = None):
        self._add("corrupt_reads", 1, task_id)

    def lineage_rebuilt(self, task_id: Optional[int] = None):
        self._add("lineage_rebuilds", 1, task_id)

    def record_compressed(self, orig_bytes: int, stored_bytes: int,
                          task_id: Optional[int] = None):
        with self._lock:
            for b in self._bucket(task_id):
                b["precompress_bytes"] += int(orig_bytes)
                b["compressed_bytes"] += int(stored_bytes)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._global)
        # how much smaller codec'd disk writes were (1.0: codec unused)
        out["codec_ratio"] = (
            out["precompress_bytes"] / out["compressed_bytes"]
            if out["compressed_bytes"] else 1.0)
        return out

    def task_snapshot(self, task_id: int) -> Dict[str, int]:
        with self._lock:
            return dict(self._task.get(task_id)
                        or dict.fromkeys(self.FIELDS, 0))

    def get_and_reset_task(self, task_id: int) -> Dict[str, int]:
        with self._lock:
            return self._task.pop(task_id, None) \
                or dict.fromkeys(self.FIELDS, 0)

    def reset(self):
        with self._lock:
            self._global = dict.fromkeys(self.FIELDS, 0)
            self._task.clear()


# ---------------------------------------------------------------------------
# SpillableHandle: one batch, three tiers
# ---------------------------------------------------------------------------

class SpillableHandle:
    """A device batch that the framework can demote device -> host -> disk.

    Exactly one tier holds the data (``tier``).  With a ``TaskContext``
    the device tier is charged to the device arena (released on demotion,
    charged again on ``get()``); with an installed :class:`SpillFramework`
    the host tier is charged to the unified host arena and the disk tier
    is available.  Without either, spill is an uncharged host round trip.

    ``recompute=`` is lineage: a zero-argument callable returning a fresh
    tree, bit-identical to the original.  When the spilled copy is lost or
    fails verification, ``get()`` discards it and rebuilds through it
    (``lineage_rebuilds``); without it the damage raises
    :class:`~..faultinj.SpillCorruptionError`.
    """

    def __init__(self, tree, ctx=None, name: Optional[str] = None,
                 recompute=None):
        self._lock = threading.RLock()
        self._tree = tree
        self._host: Optional[List[np.ndarray]] = None
        self._host_meta: Optional[List[Tuple[int, int]]] = None
        self._disk: Optional[List[str]] = None
        self._disk_meta: Optional[List[tuple]] = None
        self._recompute = recompute
        self.lineage_rebuilds = 0
        self._treedef = None
        self._leaf_index: Optional[List[int]] = None  # leaf -> host buffer
        self._devices: Optional[List] = None          # per host buffer
        self._ctx = ctx
        self.task_id: Optional[int] = getattr(ctx, "task_id", None)
        self.name = name or f"spillable-{id(self):x}"
        self._device_charged = 0
        self._host_charged = 0
        self._pins = 0
        self._closed = False
        self._last_use = _next_use()
        self._fw = get_framework()
        self._lineage_nbytes = 0
        if ctx is not None or recompute is not None:
            from .executor import batch_nbytes

            nbytes = batch_nbytes(tree)
            if recompute is not None:
                # a deterministic recompute reproduces this tree: its
                # size now is the charge a rebuild needs
                self._lineage_nbytes = nbytes
            if ctx is not None:
                # charge BEFORE registering: a RetryOOM here leaves no
                # half-registered handle behind
                self._device_charged = ctx.charge(nbytes)
        if self._fw is not None:
            self._fw.store.register(self)
        if ctx is not None and hasattr(ctx, "_adopt"):
            ctx._adopt(self)

    @classmethod
    def from_host_leaves(cls, leaves: List[np.ndarray],
                         name: Optional[str] = None,
                         device=None) -> "SpillableHandle":
        """A handle that starts HOST-resident (no device tier, no
        ``TaskContext`` charge) from numpy leaves: registered like any
        other, its CRCs recorded per ``spill_checksum``, the host arena
        charged (straight to disk when the bounded tier refuses).
        ``get()`` brings the leaves up as a list of tensors on ``device``
        (default: the GPU); :meth:`read_host` returns them without
        promotion."""
        h = cls(None, ctx=None, name=name)
        arrs = [np.ascontiguousarray(a) for a in leaves]
        nbytes = int(sum(a.nbytes for a in arrs))
        with h._lock:
            h._host = arrs
            h._leaf_index = list(range(len(arrs)))
            h._devices = [device] * len(arrs)
            h._treedef = ("seq", list, (("leaf",),) * len(arrs))
            if bool(config.get("spill_checksum")):
                h._host_meta = [_leaf_meta(a) for a in arrs]
            fw = h._fw
            if fw is not None:
                h._pins += 1
                try:
                    verdict = fw._charge_host(nbytes)
                finally:
                    h._pins -= 1
                if verdict == "charged":
                    h._host_charged = nbytes
                elif verdict == "full":
                    h._spill_host_locked()
        return h

    def read_host(self) -> List[np.ndarray]:
        """The host-format leaves WITHOUT device promotion, verified by
        whichever lower tier holds them; a disk-resident handle is read
        back, verified and promoted to the host tier.  Damage raises the
        spill corruption errors; a device-resident handle ``ValueError``
        (use :meth:`get`)."""
        with self._lock:
            if self._closed:
                raise ValueError(f"{self.name} is closed")
            self._last_use = _next_use()
            if self._tree is not None:
                raise ValueError(
                    f"{self.name}: read_host on a device-resident handle")
            if self._host is not None:
                self._verify_host_locked(self._host)
                return list(self._host)
            if self._disk is None:
                raise ValueError(f"{self.name} holds no data")
            fw = self._fw
            try:
                host = self._read_disk_verified_locked()
            except (faultinj.SpillCorruptionError, OSError, ValueError):
                if fw is not None:
                    fw.metrics.corrupt_read(self.task_id)
                raise
            nbytes = int(sum(a.nbytes for a in host))
            if fw is not None:
                self._pins += 1
                try:
                    verdict = fw._charge_host(nbytes)
                finally:
                    self._pins -= 1
                if verdict == "full":
                    # the bounded host tier refuses: hand back the
                    # verified copy, leave the entry on disk
                    return host
                if verdict == "charged":
                    self._host_charged = nbytes
                fw.metrics.record("disk_to_host", nbytes, self.task_id)
            self._host = host
            # the host record inherits the disk record's decoded-leaf
            # crc/nbytes, only when every leaf kept a real CRC
            metas = [(m[0], m[1]) for m in (self._disk_meta or [])
                     if m is not None and m[0]]
            self._host_meta = (metas if self._disk_meta is not None
                               and len(metas) == len(self._disk_meta)
                               else None)
            self._remove_disk_files_locked()
            return list(host)

    # -- introspection --------------------------------------------------
    @property
    def tier(self) -> str:
        if self._closed:
            return "closed"
        if self._tree is not None:
            return "device"
        if self._host is not None:
            return "host"
        if self._disk is not None:
            return "disk"
        # no tier holds data: only lineage can bring it back (a dropped
        # build table, or a rebuild interrupted by RetryOOM mid-charge)
        return "dropped"

    @property
    def is_spilled(self) -> bool:
        return self._tree is None and not self._closed

    @property
    def last_use(self) -> int:
        return self._last_use

    # -- pinning --------------------------------------------------------
    def pin(self):
        """Exclude this handle from eviction (nestable)."""
        with self._lock:
            self._pins += 1

    def unpin(self):
        with self._lock:
            self._pins = max(0, self._pins - 1)

    @contextlib.contextmanager
    def pinned(self):
        self.pin()
        try:
            yield self
        finally:
            self.unpin()

    # -- tier transitions ----------------------------------------------
    def spill(self) -> int:
        """Demote device -> host (cascading to disk under host pressure).

        Returns the DEVICE arena bytes released; 0 when there was nothing
        to do (already spilled, pinned, closed, or busy in another
        thread's ``get()``).  Safe to call from any thread.  The device
        memory itself is freed when nothing else holds the tensors."""
        if not self._lock.acquire(blocking=False):
            return 0  # mid-get()/close() elsewhere: treat as pinned
        try:
            if self._closed or self._tree is None or self._pins > 0:
                return 0
            t0 = time.monotonic_ns()
            leaves: list = []
            treedef = _flatten(self._tree, leaves)
            for leaf in leaves:
                if leaf.dtype not in _HOST_DTYPES:
                    raise TypeError(
                        f"{self.name}: a {leaf.dtype} tensor cannot spill "
                        "(numpy has no such dtype)")
            # copy each distinct buffer once and remember leaf -> buffer,
            # so aliasing survives the round trip and the bytes match the
            # deduplicated batch_nbytes charge
            uniq: Dict = {}
            index: List[int] = []
            host: List[np.ndarray] = []
            devices: List = []
            for leaf in leaves:
                key = _buffer_key(leaf)
                if key not in uniq:
                    uniq[key] = len(host)
                    host.append(_to_host(leaf))
                    devices.append(leaf.device)
                index.append(uniq[key])
            if bool(config.get("spill_checksum")):
                # demotion-time CRCs: promotion verifies against them and
                # the disk tier inherits them
                self._host_meta = [_leaf_meta(a) for a in host]
            else:
                self._host_meta = None
            try:
                _host_corrupt_probe()
            except faultinj.HostCorruptionError:
                # injected corruption becomes real byte flips in the host
                # copy just made; detection is promotion's job
                if host:
                    host[-1] = _flip_host_bytes(host[-1])
            nbytes = int(sum(a.nbytes for a in host))
            del leaves, uniq
            self._host = host
            self._leaf_index = index
            self._devices = devices
            self._treedef = treedef
            self._tree = None
            freed = self._device_charged
            if self._ctx is not None and self._device_charged:
                self._ctx.release(self._device_charged)
                self._device_charged = 0
            fw = self._fw
            if fw is not None:
                fw.metrics.record("device_to_host", nbytes, self.task_id)
                # pinned across the charge: _charge_host may walk the host
                # tier to make room, and must not re-enter this handle
                self._pins += 1
                try:
                    verdict = fw._charge_host(nbytes)
                finally:
                    self._pins -= 1
                if verdict == "charged":
                    self._host_charged = nbytes
                elif verdict == "full":
                    # the bounded host tier refused even after demoting
                    # colder host batches: go to disk ourselves
                    self._spill_host_locked()
                # "unbounded": no host arena, host-resident uncharged
                fw.metrics.add_eviction_ns(time.monotonic_ns() - t0,
                                           self.task_id)
            return freed
        finally:
            self._lock.release()

    def spill_host(self) -> int:
        """Demote host -> disk.  Returns the HOST arena bytes released."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            if self._closed or self._host is None or self._pins > 0:
                return 0
            return self._spill_host_locked()
        finally:
            self._lock.release()

    def _spill_host_locked(self) -> int:
        fw = self._fw
        if fw is None:
            return 0  # no framework: no disk tier
        checksum = bool(config.get("spill_checksum"))
        codec = str(config.get("spill_codec") or "off").lower()
        if codec not in ("off", "pack", "block"):
            raise ValueError(
                f"spill_codec must be off/pack/block, got {codec!r}")
        paths: List[str] = []
        meta: List[tuple] = []
        stored_total = 0
        try:
            for i, arr in enumerate(self._host):
                p = os.path.join(fw.spill_dir, f"{self.name}-{i}.npy")
                # the DEMOTION-time record when the host tier kept one:
                # damage done while host-resident lands on disk under the
                # original CRC, and read-back catches it
                if self._host_meta is not None:
                    orig = self._host_meta[i]
                else:
                    orig = (_leaf_meta(arr) if checksum
                            else (0, int(arr.nbytes)))
                if codec == "off":
                    meta.append(orig)
                    _write_leaf(p, arr)
                else:
                    # a codec'd leaf: the STORED crc covers the frame's
                    # bytes, the original crc the decoded leaf
                    payload = _codec.encode_block(arr, codec)
                    stored_crc, stored_nbytes = _leaf_meta(payload)
                    stored_total += stored_nbytes
                    meta.append((orig[0], orig[1],
                                 _codec.codec_name(payload),
                                 stored_crc, stored_nbytes))
                    _write_leaf(p, payload)
                paths.append(p)
                try:
                    _corrupt_probe()
                except faultinj.SpillCorruptionError:
                    # injected corruption becomes real damage in the file
                    # just written; with a codec the head flip also hits
                    # the frame header
                    _flip_file_bytes(p)
                    if codec != "off":
                        _flip_file_head_bytes(p)
        except (faultinj.SpillIOError, OSError):
            # the batch STAYS in the host tier: a broken spill disk costs
            # capacity, not data
            for p in paths:
                with contextlib.suppress(OSError):
                    os.remove(p)
            fw.metrics.disk_write_failed(self.task_id)
            return 0
        nbytes = int(sum(a.nbytes for a in self._host))
        self._disk = paths
        # codec'd metas are load-bearing (the read path must decode);
        # raw ones survive only when a checksum backs them
        self._disk_meta = (meta if codec != "off" or checksum
                           or self._host_meta is not None else None)
        if codec != "off":
            fw.metrics.record_compressed(nbytes, stored_total, self.task_id)
        self._host = None
        self._host_meta = None
        freed = self._host_charged
        if self._host_charged:
            fw._uncharge_host(self._host_charged)
            self._host_charged = 0
        fw.metrics.record("host_to_disk", nbytes, self.task_id)
        return freed

    def get(self):
        """The device tree, promoted disk -> host -> device as needed.

        The device arena is charged BEFORE the upload; a ``RetryOOM``
        from the charge leaves the handle in its current tier and the
        retry ladder re-enters ``get()``.  A failed disk read-back
        (checksum mismatch, truncation, missing file, injected
        ``spill_io``) rebuilds through ``recompute=`` or raises
        ``SpillCorruptionError``."""
        with self._lock:
            if self._closed:
                raise ValueError(f"{self.name} is closed")
            self._last_use = _next_use()
            if self._tree is not None:
                return self._tree
            fw = self._fw
            if self._host is None and self._disk is None:
                # "dropped": only lineage can proceed
                if self._recompute is None:
                    raise ValueError(
                        f"{self.name} holds no data and has no lineage")
                return self._rebuild_locked()
            host = self._host
            if host is None:
                try:
                    host = self._read_disk_verified_locked()
                except (faultinj.SpillCorruptionError, OSError,
                        ValueError) as e:
                    if fw is not None:
                        fw.metrics.corrupt_read(self.task_id)
                    if self._recompute is None:
                        raise faultinj.SpillCorruptionError(
                            f"{self.name}: spilled data lost or corrupt "
                            f"and no recompute= lineage to rebuild from: "
                            f"{e!r}") from e
                    return self._rebuild_locked()
                if fw is not None:
                    fw.metrics.record(
                        "disk_to_host", int(sum(a.nbytes for a in host)),
                        self.task_id)
            else:
                try:
                    self._verify_host_locked(host)
                except faultinj.SpillCorruptionError as e:
                    if fw is not None:
                        fw.metrics.corrupt_read(self.task_id)
                    if self._recompute is None:
                        raise faultinj.HostCorruptionError(
                            f"{self.name}: host-tier copy corrupt and no "
                            f"recompute= lineage to rebuild from: {e!r}"
                        ) from e
                    return self._rebuild_locked()
            nbytes = int(sum(a.nbytes for a in host))
            if self._ctx is not None:
                # may raise RetryOOM: the host copies (or disk files) are
                # still in place, so the retried get() promotes again
                self._device_charged = self._ctx.charge(nbytes)
            try:
                devices = [d if d is not None else resolve_device(None)
                           for d in self._devices]
                bufs = [_to_device(a, d) for a, d in zip(host, devices)]
                # aliased leaves come back as the SAME tensor
                tree = _unflatten(self._treedef,
                                  iter([bufs[i] for i in self._leaf_index]))
            except BaseException:
                if self._ctx is not None and self._device_charged:
                    self._ctx.release(self._device_charged)
                    self._device_charged = 0
                raise
            self._tree = tree
            if self._host_charged and fw is not None:
                fw._uncharge_host(self._host_charged)
            self._host_charged = 0
            self._host = None
            self._host_meta = None
            self._devices = None
            self._remove_disk_files_locked()
            if fw is not None:
                fw.metrics.record("host_to_device", nbytes, self.task_id)
            return tree

    def _verify_host_locked(self, host: List[np.ndarray]) -> None:
        """Verify host-resident leaves against their demotion-time CRC32
        and byte length (recorded when ``spill_checksum`` was on)."""
        if self._host_meta is None:
            return
        for i, (arr, (crc, nbytes)) in enumerate(
                zip(host, self._host_meta)):
            got_crc, got_nbytes = _leaf_meta(arr)
            if got_nbytes != nbytes or got_crc != crc:
                raise faultinj.HostCorruptionError(
                    f"host buffer {i} of {self.name}: demoted {nbytes}B "
                    f"crc={crc:#010x}, resident {got_nbytes}B "
                    f"crc={got_crc:#010x}")

    def _read_disk_verified_locked(self) -> List[np.ndarray]:
        """Load the disk tier, verifying each leaf against its recorded
        CRC32 and byte length where they were recorded."""
        host: List[np.ndarray] = []
        meta = self._disk_meta or [None] * len(self._disk)
        for p, m in zip(self._disk, meta):
            arr = _read_leaf(p)
            if m is not None and len(m) == 5:
                # codec'd leaf: the STORED bytes first (a torn frame never
                # reaches the decoder), then decode (header damage fails
                # loudly), then the decoded leaf against its record
                crc, nbytes, cname, stored_crc, stored_nbytes = m
                got_crc, got_nbytes = _leaf_meta(arr)
                if got_nbytes != stored_nbytes or got_crc != stored_crc:
                    raise faultinj.SpillCorruptionError(
                        f"stored-payload checksum mismatch reading {p} "
                        f"({cname}): wrote {stored_nbytes}B "
                        f"crc={stored_crc:#010x}, read {got_nbytes}B "
                        f"crc={got_crc:#010x}")
                try:
                    arr = _codec.decode_block(arr)
                except _codec.CodecError as e:
                    raise faultinj.SpillCorruptionError(
                        f"corrupt {cname} frame reading {p}: {e}") from e
                got_crc, got_nbytes = _leaf_meta(arr)
                if got_nbytes != nbytes or (crc and got_crc != crc):
                    raise faultinj.SpillCorruptionError(
                        f"decoded-leaf checksum mismatch reading {p}: "
                        f"wrote {nbytes}B crc={crc:#010x}, decoded "
                        f"{got_nbytes}B crc={got_crc:#010x}")
            elif m is not None:
                crc, nbytes = m
                got_crc, got_nbytes = _leaf_meta(arr)
                if got_nbytes != nbytes or got_crc != crc:
                    raise faultinj.SpillCorruptionError(
                        f"checksum mismatch reading {p}: wrote "
                        f"{nbytes}B crc={crc:#010x}, read "
                        f"{got_nbytes}B crc={got_crc:#010x}")
            host.append(arr)
        return host

    def _rebuild_locked(self):
        """Lineage recovery: discard whatever tier was damaged or dropped
        and run ``recompute()`` for a fresh device tree, charging the
        construction-time size first (a ``RetryOOM`` leaves the handle
        "dropped" and the retry ladder re-enters here)."""
        self._remove_disk_files_locked()
        self._host = None
        self._host_meta = None
        self._treedef = None
        self._leaf_index = None
        self._devices = None
        if self._host_charged and self._fw is not None:
            self._fw._uncharge_host(self._host_charged)
        self._host_charged = 0
        if self._ctx is not None:
            self._device_charged = self._ctx.charge(self._lineage_nbytes)
        try:
            tree = self._recompute()
        except BaseException:
            if self._ctx is not None and self._device_charged:
                self._ctx.release(self._device_charged)
                self._device_charged = 0
            raise
        self._tree = tree
        self.lineage_rebuilds += 1
        if self._fw is not None:
            self._fw.metrics.lineage_rebuilt(self.task_id)
        return tree

    def _remove_disk_files_locked(self):
        if self._disk:
            for p in self._disk:
                with contextlib.suppress(OSError):
                    os.remove(p)
        self._disk = None
        self._disk_meta = None

    def close(self):
        """Release every charge, delete spill files, unregister."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._ctx is not None and self._device_charged:
                self._ctx.release(self._device_charged)
                self._device_charged = 0
            if self._host_charged and self._fw is not None:
                self._fw._uncharge_host(self._host_charged)
                self._host_charged = 0
            self._remove_disk_files_locked()
            self._tree = None
            self._host = None
            self._host_meta = None
            self._devices = None
            self._treedef = None
        if self._fw is not None:
            self._fw.store.unregister(self)
        if self._ctx is not None and hasattr(self._ctx, "_forget"):
            self._ctx._forget(self)


# ---------------------------------------------------------------------------
# SpillableStore: the registry + priority walk
# ---------------------------------------------------------------------------

class SpillableStore:
    """Thread-safe registry of live handles with the task-aware LRU
    eviction walk (the SpillableDeviceStore role)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: Dict[int, SpillableHandle] = {}
        # task_id -> eviction priority: higher keeps residency longer,
        # unset tasks sit at 0.0
        self._task_prio: Dict[int, float] = {}

    def register(self, handle: SpillableHandle):
        with self._lock:
            self._handles[id(handle)] = handle

    def unregister(self, handle: SpillableHandle):
        with self._lock:
            self._handles.pop(id(handle), None)

    def set_task_priority(self, task_id: int, priority: float):
        with self._lock:
            self._task_prio[task_id] = float(priority)

    def clear_task_priority(self, task_id: int):
        with self._lock:
            self._task_prio.pop(task_id, None)

    def task_priority(self, task_id) -> float:
        with self._lock:
            return self._task_prio.get(task_id, 0.0)

    def handles(self) -> List[SpillableHandle]:
        with self._lock:
            return list(self._handles.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)

    def spill_device_to_fit(self, nbytes: Optional[int] = None,
                            requesting_task_id: Optional[int] = None) -> int:
        """Evict device-tier handles (LRU by last ``get()``) until
        ``nbytes`` of device arena are released, or every eligible one
        when ``nbytes`` is None.  Other tasks' idle batches go first (lower
        ``set_task_priority`` first, LRU within a priority), the
        requesting task's own unpinned batches last; pinned and busy
        handles are skipped."""
        snap = [h for h in self.handles() if h.tier == "device"]
        snap.sort(key=lambda h: (self.task_priority(h.task_id), h.last_use))
        if requesting_task_id is None:
            ordered = snap
        else:
            ordered = ([h for h in snap if h.task_id != requesting_task_id]
                       + [h for h in snap if h.task_id == requesting_task_id])
        freed = 0
        for h in ordered:
            if nbytes is not None and freed >= nbytes:
                break
            freed += h.spill()
        return freed

    def spill_host_to_fit(self, nbytes: Optional[int] = None) -> int:
        """Demote host-tier handles to disk (LRU) until ``nbytes`` of the
        host arena are released (everything when None)."""
        snap = [h for h in self.handles() if h.tier == "host"]
        snap.sort(key=lambda h: h.last_use)
        freed = 0
        for h in snap:
            if nbytes is not None and freed >= nbytes:
                break
            freed += h.spill_host()
        return freed


# ---------------------------------------------------------------------------
# SpillFramework: process-wide singleton
# ---------------------------------------------------------------------------

class SpillFramework:
    """Owns the store, the spill directory and the metrics; arbitrates
    the bounded host tier against the unified host arena."""

    def __init__(self, spill_dir: Optional[str] = None):
        d = spill_dir or config.get("spill_dir")
        self._own_dir = False
        if not d:
            d = tempfile.mkdtemp(prefix="sptorch_spill_")
            self._own_dir = True
        else:
            os.makedirs(d, exist_ok=True)
        self.spill_dir = d
        self.store = SpillableStore()
        self.metrics = SpillMetrics()

    def spill_to_fit(self, nbytes: Optional[int] = None,
                     requesting_task_id: Optional[int] = None) -> int:
        """Release device arena bytes by evicting idle batches (see
        :meth:`SpillableStore.spill_device_to_fit`)."""
        return self.store.spill_device_to_fit(nbytes, requesting_task_id)

    def host_spill_to_fit(self, nbytes: Optional[int] = None) -> int:
        return self.store.spill_host_to_fit(nbytes)

    # -- host-tier accounting ------------------------------------------
    @staticmethod
    def _host_arena():
        """(pool_bytes, used_bytes) of whichever host arena is installed,
        or (None, None) when the host tier is unbounded."""
        a = RmmSpark._adaptor
        if a is not None and a.host_pool_bytes > 0:
            return a.host_pool_bytes, a.host_total_allocated()
        c = RmmSpark._cpu_adaptor
        if c is not None:
            return c.pool_bytes, c.total_allocated()
        return None, None

    def _charge_host(self, nbytes: int) -> str:
        """Try to charge ``nbytes`` to the host arena: ``"charged"`` (the
        caller owns the charge), ``"unbounded"`` (no host arena, or the
        thread is not registered with it: keep the data uncharged) or
        ``"full"`` (the bounded tier cannot take it even after demoting
        colder host batches: the caller goes to disk)."""
        pool, used = self._host_arena()
        if pool is None:
            return "unbounded"
        if nbytes > pool:
            return "full"  # can never fit: skip the blocking allocate
        if nbytes > pool - used:
            self.host_spill_to_fit(nbytes - (pool - used))
            pool, used = self._host_arena()
            if nbytes > pool - used:
                return "full"
        try:
            RmmSpark.cpu_allocate(nbytes)
            return "charged"
        except (CpuRetryOOM, CpuSplitAndRetryOOM):
            # host pressure raced us: one more demotion round, then disk
            self.host_spill_to_fit(nbytes)
            try:
                RmmSpark.cpu_allocate(nbytes)
                return "charged"
            except (CpuRetryOOM, CpuSplitAndRetryOOM):
                return "full"
        except RuntimeError:
            # the calling thread is not registered with the adaptor (a
            # shutdown path): keep the data, skip the accounting
            return "unbounded"

    def _uncharge_host(self, nbytes: int):
        with contextlib.suppress(RuntimeError):
            RmmSpark.cpu_deallocate(nbytes)

    def close(self):
        """Close every live handle (releasing charges and disk files)."""
        for h in self.store.handles():
            h.close()
        if self._own_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# process-wide install/shutdown
# ---------------------------------------------------------------------------

_fw_lock = threading.Lock()
_framework: Optional[SpillFramework] = None


def install(spill_dir: Optional[str] = None) -> SpillFramework:
    """Install the process-wide framework.  Handles created while it is
    installed register with it."""
    global _framework
    with _fw_lock:
        if _framework is not None:
            raise RuntimeError("spill framework already installed")
        _framework = SpillFramework(spill_dir)
        return _framework


def shutdown():
    """Close every handle and uninstall (idempotent)."""
    global _framework
    with _fw_lock:
        fw, _framework = _framework, None
    if fw is not None:
        fw.close()


def get_framework() -> Optional[SpillFramework]:
    return _framework
