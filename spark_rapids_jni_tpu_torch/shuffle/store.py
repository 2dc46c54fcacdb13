"""Persistent shuffle store: a durable map-output store with crash
adoption and attempt fencing.

Counterpart of ``spark_rapids_jni_tpu/shuffle/store.py``.  Committed map
outputs and drained round chunks are written to a location that outlives
the worker (the ``shuffle_store_dir`` knob), so a replacement worker
ADOPTS finished shards instead of re-running their map.

Layout (metadata apart from payload)::

    <root>/FENCE                                  fence state (floor + revoked)
    <root>/<key>/shard-<name>/attempt-<epoch>/    one committed entry
        manifest.json      skeleton + per-chunk (crc32, nbytes) + epoch
        chunk-0000.npy     one npy payload per tree leaf
    <root>/<key>/shard-<name>/.tmp-e<E>-<pid>-<n>/  in-flight write
    <root>/<key>/shard-<name>/.quarantine-*        corrupt entry, moved aside

Commit protocol (crash-safe at every byte):

1. every chunk and the manifest go into a dot-prefixed tmp dir, each
   file and the dir fsync'd; nothing under a dot prefix is adoptable;
2. the FENCE is checked: an epoch below the stamped floor or in the
   revoked set is rejected here, before the rename, so a late commit from
   a worker already declared dead never becomes visible;
3. ``os.rename`` tmp -> ``attempt-<epoch>`` is the one atomic commit
   point.  A kill before it leaves only a tmp dir (reaped by
   :meth:`ShuffleStore.reap_uncommitted`); a kill after it leaves a
   complete entry.

Adoption reads the highest committed attempt and verifies every chunk
against the manifest's CRC32 and byte length (the spill tiers'
``_leaf_meta``).  A torn or damaged entry (missing manifest, short chunk,
CRC mismatch) is quarantined, counted, and the next attempt, or the
caller's lineage, takes over.

The on-disk format is the reference's letter for letter (node tags,
manifest keys, chunk names, the FENCE JSON): either package adopts what
the other committed.  Where the port differs:

* leaves are tensors on any device (or numpy arrays); :meth:`put` copies
  each to the host, and :meth:`ShuffleStore.adopt` puts every leaf on the
  ``device`` it is given (``None``: the GPU, raising without one, like
  every entry point of the port), never on the CPU by default;
* a leaf is stored in the dtype the port holds it in.
  ``Decimal128Column.limbs`` is int64 in the port and uint64 in the
  reference (the same bits): the port writes int64 and, adopting a
  reference entry, views uint64 limbs as int64;
* a timestamp type's time zone is written as ``tz`` and read back;
* ``bfloat16`` has no npy form: a tree holding one is unstorable, and
  its ``put`` fails softly like any other unstorable tree.

Fault kinds:

* ``store_commit`` fires at the pre-rename probe; the store tears the
  write (drops the manifest, keeps the tmp) and reports failure;
* ``store_corrupt`` fires at the post-commit probe (``store_corrupt_file``);
  the store flips bytes in a chunk it just committed, so adoption's
  verification meets real damage on disk.

The host pieces of a commit and an adoption (device -> host copy, CRC32,
``np.save``, fsync, ``np.load``, host -> device copy) are module-level
helpers, so a caller can time each one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import config, faultinj
from ..columnar import types as T
from ..columnar.column import (Column, ColumnBatch, Decimal128Column,
                               ListColumn, StringColumn, StructColumn)
from ..device import resolve_device
from ..mem import codec as _codec
from ..mem.spill import (_HOST_DTYPES, _flip_file_bytes,
                         _flip_file_head_bytes, _leaf_meta)

# probe names: "store_commit" fires immediately before the atomic
# rename; "store_corrupt_file" immediately after a successful commit
_commit_probe = faultinj.instrument(lambda: None, "store_commit")
_corrupt_probe = faultinj.instrument(lambda: None, "store_corrupt_file")

_FENCE = "FENCE"
_MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# tree <-> (JSON skeleton, npy chunk list) codec
# ---------------------------------------------------------------------------
# A JSON skeleton of the container nesting plus flat npy payloads, no
# pickle anywhere: a corrupt file can fail verification but never run.

def _enc_type(t: T.SparkType) -> dict:
    return {
        "kind": t.kind.value,
        "precision": t.precision,
        "scale": t.scale,
        "tz": t.tz,
        "children": [_enc_type(c) for c in t.children],
        "field_names": list(t.field_names),
    }


def _dec_type(d: dict) -> T.SparkType:
    return T.SparkType(
        T.Kind(d["kind"]),
        precision=int(d.get("precision", 0)),
        scale=int(d.get("scale", 0)),
        children=tuple(_dec_type(c) for c in d.get("children", [])),
        field_names=tuple(d.get("field_names", [])),
        tz=d.get("tz", ""),
    )


def _encode(obj, leaves: list):
    """Encode ``obj`` into a JSON skeleton, appending its tensors and
    arrays (not yet copied to the host) to ``leaves``.  Raises
    ``TypeError`` on anything outside the closed set, which ``put`` turns
    into a failed (skipped) commit, never a wrong entry."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _HOST_DTYPES:
            raise TypeError(f"a {obj.dtype} tensor has no npy form")
        leaves.append(obj)
        return {"t": "leaf", "i": len(leaves) - 1}
    if isinstance(obj, np.ndarray):
        leaves.append(obj)
        return {"t": "leaf", "i": len(leaves) - 1}
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "scalar", "v": obj}
    if isinstance(obj, np.generic):
        return {"t": "scalar", "v": obj.item()}
    if isinstance(obj, tuple):
        return {"t": "tuple", "c": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, list):
        return {"t": "list", "c": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("store skeleton requires str dict keys")
        return {"t": "dict", "k": keys,
                "c": [_encode(obj[k], leaves) for k in keys]}
    if isinstance(obj, ColumnBatch):
        return {"t": "batch", "k": list(obj.names),
                "c": [_encode(c, leaves) for c in obj.columns]}
    if isinstance(obj, Column):
        return {"t": "col", "dtype": _enc_type(obj.dtype),
                "c": [_encode(obj.data, leaves),
                      _encode(obj.validity, leaves)]}
    if isinstance(obj, StringColumn):
        return {"t": "strcol",
                "c": [_encode(obj.chars, leaves),
                      _encode(obj.lengths, leaves),
                      _encode(obj.validity, leaves)]}
    if isinstance(obj, Decimal128Column):
        return {"t": "deccol", "dtype": _enc_type(obj.dtype),
                "c": [_encode(obj.limbs, leaves),
                      _encode(obj.validity, leaves)]}
    if isinstance(obj, ListColumn):
        return {"t": "listcol", "dtype": _enc_type(obj.dtype),
                "c": [_encode(obj.offsets, leaves),
                      _encode(obj.child, leaves),
                      _encode(obj.validity, leaves)]}
    if isinstance(obj, StructColumn):
        return {"t": "structcol", "k": list(obj.field_names),
                "dtype": _enc_type(obj.dtype),
                "c": [_encode(c, leaves) for c in obj.children]
                + [_encode(obj.validity, leaves)]}
    raise TypeError(f"unsupported store tree node: {type(obj).__name__}")


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return leaf
    return leaf.detach().contiguous().cpu().numpy()


def _save(f, payload: np.ndarray) -> None:
    np.save(f, payload, allow_pickle=False)
    f.flush()


def _fsync(f) -> None:
    os.fsync(f.fileno())


def _load(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=False)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()  # a decoded frame is a read-only view
    return torch.from_numpy(arr).to(device)


def _decode(node: dict, leaves: List[torch.Tensor]):
    """Inverse of :func:`_encode` over leaves already on their device."""
    t = node["t"]
    if t == "leaf":
        return leaves[node["i"]]
    if t == "none":
        return None
    if t == "scalar":
        return node["v"]
    if t == "tuple":
        return tuple(_decode(c, leaves) for c in node["c"])
    if t == "list":
        return [_decode(c, leaves) for c in node["c"]]
    if t == "dict":
        return {k: _decode(c, leaves)
                for k, c in zip(node["k"], node["c"])}
    if t == "batch":
        return ColumnBatch({k: _decode(c, leaves)
                            for k, c in zip(node["k"], node["c"])})
    if t == "col":
        data, valid = (_decode(c, leaves) for c in node["c"])
        return Column(data, valid, _dec_type(node["dtype"]))
    if t == "strcol":
        chars, lengths, valid = (_decode(c, leaves) for c in node["c"])
        return StringColumn(chars, lengths, valid)
    if t == "deccol":
        limbs, valid = (_decode(c, leaves) for c in node["c"])
        if limbs.dtype == torch.uint64:
            limbs = limbs.view(torch.int64)  # a reference entry's bits
        return Decimal128Column(limbs, valid, _dec_type(node["dtype"]))
    if t == "listcol":
        offsets, child, valid = (_decode(c, leaves) for c in node["c"])
        return ListColumn(offsets, child, valid, _dec_type(node["dtype"]))
    if t == "structcol":
        *kids, valid = (_decode(c, leaves) for c in node["c"])
        return StructColumn(dict(zip(node["k"], kids)), valid,
                            _dec_type(node["dtype"]))
    raise faultinj.StoreCorruptionError(f"unknown skeleton node {t!r}")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-._" else "_" for c in name)


class ShuffleStore:
    """One process's handle onto the shared durable store.

    ``epoch`` is this process's stamped attempt number; commits are keyed
    by it and fenced against it.  Every method is safe under concurrent
    writers in other processes: the commit point is one ``os.rename``."""

    COUNTERS = ("commits", "commit_failures", "fenced_commits",
                "adoptions", "adoption_misses", "corrupt_quarantined",
                "reaped_uncommitted", "pruned_attempts")

    def __init__(self, root: str, epoch: int = 0,
                 max_attempts: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.epoch = int(epoch)
        self._max_attempts = max_attempts
        self._lock = threading.Lock()
        self._tmp_seq = 0
        self._counts = {k: 0 for k in self.COUNTERS}
        os.makedirs(self.root, exist_ok=True)

    # -- fencing ---------------------------------------------------------
    # Two fence shapes, both checked before the rename: a monotonic FLOOR
    # (``stamp``: fences every generation below it at once) and a REVOKED
    # set (``revoke``: fences exactly one generation, which a floor alone
    # cannot do while a lower generation is still alive and committing).
    # Only the supervisor writes fence state; workers only read it.

    def _fence_state(self) -> dict:
        try:
            with open(os.path.join(self.root, _FENCE)) as f:
                raw = f.read().strip()
        except OSError:
            return {"floor": 0, "revoked": []}
        try:
            st = json.loads(raw or "0")
        except ValueError:
            return {"floor": 0, "revoked": []}
        if isinstance(st, int):  # legacy bare-int floor
            return {"floor": st, "revoked": []}
        if not isinstance(st, dict):
            return {"floor": 0, "revoked": []}
        return {"floor": int(st.get("floor", 0)),
                "revoked": sorted(int(e) for e in st.get("revoked", []))}

    def _write_fence(self, state: dict) -> None:
        tmp = os.path.join(self.root, f".{_FENCE}-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, _FENCE))
        _fsync_dir(self.root)

    def fence(self) -> int:
        """The stamped floor epoch (0 = none)."""
        return self._fence_state()["floor"]

    def fenced(self, epoch: int) -> bool:
        """Would a commit at ``epoch`` be rejected right now?"""
        st = self._fence_state()
        return int(epoch) < st["floor"] or int(epoch) in st["revoked"]

    def revoked(self) -> List[int]:
        """Surgically fenced generations, ascending."""
        return self._fence_state()["revoked"]

    def stamp(self, epoch: int) -> int:
        """Raise the fence floor to ``epoch`` (monotonic; atomic
        replace): every generation strictly below it is fenced."""
        st = self._fence_state()
        if int(epoch) <= st["floor"]:
            return st["floor"]
        st["floor"] = int(epoch)
        self._write_fence(st)
        return st["floor"]

    def revoke(self, epoch: int) -> None:
        """Fence exactly one generation: a worker declared lost (or one
        that fences itself when cut off) can still write tmp entries but
        can never commit them."""
        st = self._fence_state()
        if int(epoch) in st["revoked"]:
            return
        st["revoked"] = sorted(st["revoked"] + [int(epoch)])
        self._write_fence(st)

    def fence_handoff(self, dead_epochs, floor: int) -> dict:
        """Generation handoff: revoke every dead generation, raise the
        floor to ``floor`` (the oldest surviving generation, never past
        it, or the survivors would be fenced out of their own commits)
        and reap each dead generation's uncommitted tmp entries, in one
        fence-state write."""
        st = self._fence_state()
        dead = sorted({int(e) for e in dead_epochs}
                      - set(st["revoked"]))
        if dead:
            st["revoked"] = sorted(st["revoked"] + dead)
        st["floor"] = max(st["floor"], int(floor))
        self._write_fence(st)
        reaped = 0
        for e in dead:
            reaped += self.reap_uncommitted(epoch=e)
        return {"revoked": dead, "floor": st["floor"],
                "reaped_uncommitted": reaped}

    # -- paths -----------------------------------------------------------
    def _shard_dir(self, key: str, shard: str) -> str:
        return os.path.join(self.root, _safe(key), f"shard-{_safe(shard)}")

    def _committed(self, shard_dir: str) -> List[Tuple[int, str]]:
        """Committed attempts, highest epoch first."""
        try:
            entries = os.listdir(shard_dir)
        except OSError:
            return []
        out = []
        for e in entries:
            if not e.startswith("attempt-"):
                continue
            try:
                out.append((int(e.split("-", 1)[1]),
                            os.path.join(shard_dir, e)))
            except ValueError:
                continue
        out.sort(reverse=True)
        return out

    # -- write path ------------------------------------------------------
    def put(self, key: str, shard: str, tree) -> bool:
        """Durably commit ``tree`` as this epoch's attempt for
        ``(key, shard)``.  Returns False (never raises) when the write
        is torn, fenced, or the tree is not storable: callers still hold
        the in-memory copy."""
        shard_dir = self._shard_dir(key, shard)
        final = os.path.join(shard_dir, f"attempt-{self.epoch:08d}")
        if os.path.isdir(final):
            return True
        try:
            leaves: list = []
            skeleton = _encode(tree, leaves)
        except TypeError:
            with self._lock:
                self._counts["commit_failures"] += 1
            return False
        os.makedirs(shard_dir, exist_ok=True)
        with self._lock:
            self._tmp_seq += 1
            seq = self._tmp_seq
        tmp = os.path.join(
            shard_dir, f".tmp-e{self.epoch}-{os.getpid()}-{seq}")
        manifest_path = os.path.join(tmp, _MANIFEST)
        try:
            os.makedirs(tmp)
            codec = str(config.get("spill_codec") or "off").lower()
            metas = []
            for i, leaf in enumerate(leaves):
                arr = _to_host(leaf)
                cpath = os.path.join(tmp, f"chunk-{i:04d}.npy")
                if codec == "off":
                    payload = arr
                    meta = list(_leaf_meta(arr))
                else:
                    # a codec'd chunk's meta is [orig_crc, orig_nbytes,
                    # codec, stored_crc, stored_nbytes]: any later run
                    # adopts it whatever its own knob says
                    payload = _codec.encode_block(arr, codec)
                    meta = (list(_leaf_meta(arr))
                            + [_codec.codec_name(payload)]
                            + list(_leaf_meta(payload)))
                with open(cpath, "wb") as f:
                    _save(f, payload)
                    _fsync(f)
                metas.append(meta)
            with open(manifest_path, "w") as f:
                json.dump({"skeleton": skeleton, "leaves": metas,
                           "epoch": self.epoch, "key": key,
                           "shard": shard}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self._counts["commit_failures"] += 1
            return False
        try:
            # pre-rename boundary: the tmp entry is written, not committed
            _commit_probe()
        except faultinj.StoreCommitError:
            # torn write: drop the manifest so the remnant can never pass
            # for a complete entry; the chunks stay for reap_uncommitted
            try:
                os.unlink(manifest_path)
            except OSError:
                pass
            with self._lock:
                self._counts["commit_failures"] += 1
            return False
        if self.fenced(self.epoch):
            # a fenced generation's late commit: rejected at the rename
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self._counts["fenced_commits"] += 1
            return False
        try:
            os.rename(tmp, final)
        except OSError:
            # lost a same-attempt race: the other writer's entry stands
            shutil.rmtree(tmp, ignore_errors=True)
            return os.path.isdir(final)
        _fsync_dir(shard_dir)
        with self._lock:
            self._counts["commits"] += 1
        try:
            _corrupt_probe()
        except faultinj.StoreCorruptionError:
            # turn the injected fault into real damage in the entry just
            # committed: adoption's CRC pass must catch it
            chunks = sorted(f for f in os.listdir(final)
                            if f.startswith("chunk-"))
            if chunks:
                _flip_file_bytes(os.path.join(final, chunks[0]))
                if str(config.get("spill_codec") or "off").lower() != "off":
                    # the codec frame's header too, so the decode failure
                    # is exercised, not just the CRC
                    _flip_file_head_bytes(os.path.join(final, chunks[0]))
        self._prune(shard_dir)
        return True

    def _prune(self, shard_dir: str) -> None:
        keep = self._max_attempts
        if keep is None:
            keep = int(config.get("shuffle_store_max_attempts"))
        if keep <= 0:
            return
        for _epoch, path in self._committed(shard_dir)[keep:]:
            shutil.rmtree(path, ignore_errors=True)
            with self._lock:
                self._counts["pruned_attempts"] += 1

    # -- read path -------------------------------------------------------
    def has_committed(self, key: str, shard: str) -> bool:
        return bool(self._committed(self._shard_dir(key, shard)))

    def attempts(self, key: str, shard: str) -> List[int]:
        return [e for e, _ in self._committed(self._shard_dir(key, shard))]

    def adopt(self, key: str, shard: str, device=None):
        """The highest committed, CRC-verified attempt for ``(key,
        shard)`` as a live tree with every tensor on ``device`` (None: the
        GPU), or None.  Entries failing verification are quarantined
        (renamed out of the committed namespace) and the next attempt is
        tried."""
        dev = resolve_device(device)
        shard_dir = self._shard_dir(key, shard)
        for _epoch, path in self._committed(shard_dir):
            try:
                tree = self._load_verified(path, dev)
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                self._quarantine(path)
                continue
            with self._lock:
                self._counts["adoptions"] += 1
            return tree
        with self._lock:
            self._counts["adoption_misses"] += 1
        return None

    def _load_verified(self, path: str, device: torch.device):
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        metas = manifest["leaves"]
        host = []
        for i, meta in enumerate(metas):
            arr = _load(os.path.join(path, f"chunk-{i:04d}.npy"))
            got_crc, got_nbytes = _leaf_meta(arr)
            if len(meta) == 5:
                # codec'd chunk: verify the stored frame, decode loudly,
                # then verify the decoded leaf
                crc, nbytes, cname, stored_crc, stored_nbytes = meta
                if got_crc != stored_crc or got_nbytes != stored_nbytes:
                    raise faultinj.StoreCorruptionError(
                        f"store chunk {i} of {path} ({cname}) failed "
                        f"stored-payload verification: crc "
                        f"{got_crc:#x}!={stored_crc:#x} or nbytes "
                        f"{got_nbytes}!={stored_nbytes}")
                try:
                    arr = _codec.decode_block(arr)
                except _codec.CodecError as e:
                    raise faultinj.StoreCorruptionError(
                        f"store chunk {i} of {path}: corrupt {cname} "
                        f"frame: {e}") from e
                got_crc, got_nbytes = _leaf_meta(arr)
                if got_nbytes != nbytes or (crc and got_crc != crc):
                    raise faultinj.StoreCorruptionError(
                        f"store chunk {i} of {path} failed decoded-leaf "
                        f"verification: crc {got_crc:#x}!={crc:#x} or "
                        f"nbytes {got_nbytes}!={nbytes}")
            else:
                crc, nbytes = meta
                if got_crc != crc or got_nbytes != nbytes:
                    raise faultinj.StoreCorruptionError(
                        f"store chunk {i} of {path} failed verification: "
                        f"crc {got_crc:#x}!={crc:#x} or "
                        f"nbytes {got_nbytes}!={nbytes}")
            host.append(arr)
        return _decode(manifest["skeleton"],
                       [_upload(a, device) for a in host])

    def _quarantine(self, path: str) -> None:
        with self._lock:
            self._counts["corrupt_quarantined"] += 1
            self._tmp_seq += 1
            seq = self._tmp_seq
        dst = os.path.join(
            os.path.dirname(path),
            f".quarantine-{os.path.basename(path)}-{os.getpid()}-{seq}")
        try:
            os.rename(path, dst)
        except OSError:
            shutil.rmtree(path, ignore_errors=True)

    # -- janitorial ------------------------------------------------------
    def reap_uncommitted(self, epoch: Optional[int] = None) -> int:
        """Remove in-flight tmp entries (a dead worker's mid-commit
        remnants).  ``epoch`` limits the reap to one generation's tmp
        dirs; None reaps every uncommitted entry.  Committed attempts
        and quarantined entries are never touched."""
        prefix = ".tmp-" if epoch is None else f".tmp-e{int(epoch)}-"
        reaped = 0
        try:
            keys = os.listdir(self.root)
        except OSError:
            return 0
        for key in keys:
            kdir = os.path.join(self.root, key)
            if not os.path.isdir(kdir):
                continue
            for shard in os.listdir(kdir):
                sdir = os.path.join(kdir, shard)
                if not os.path.isdir(sdir):
                    continue
                for e in os.listdir(sdir):
                    if e.startswith(prefix):
                        shutil.rmtree(os.path.join(sdir, e),
                                      ignore_errors=True)
                        reaped += 1
        with self._lock:
            self._counts["reaped_uncommitted"] += reaped
        return reaped

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


# ---------------------------------------------------------------------------
# process-level store handle
# ---------------------------------------------------------------------------
# One store per process, installed explicitly or lazily from the
# ``shuffle_store_dir`` knob; the ShuffleService adopts through whichever
# is live.

_installed: Optional[ShuffleStore] = None
_installed_lock = threading.Lock()


def install(root: Optional[str] = None, epoch: int = 0) -> ShuffleStore:
    """Install the process's store handle (replacing any previous one)."""
    global _installed
    root = root or str(config.get("shuffle_store_dir"))
    if not root:
        raise ValueError("no store root: pass root= or set the "
                         "shuffle_store_dir knob")
    with _installed_lock:
        _installed = ShuffleStore(root, epoch=epoch)
        return _installed


def get_store() -> Optional[ShuffleStore]:
    """The installed store, lazily created from ``shuffle_store_dir``
    when the knob is set; None when no store is configured."""
    global _installed
    with _installed_lock:
        if _installed is None:
            root = str(config.get("shuffle_store_dir"))
            if root:
                _installed = ShuffleStore(root, epoch=0)
        return _installed


def shutdown_store() -> None:
    """Drop the process's store handle (its files stay for their
    owner)."""
    global _installed
    with _installed_lock:
        _installed = None
