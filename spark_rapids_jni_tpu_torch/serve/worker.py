"""Executor worker process: one ``ServeRuntime`` behind a socket.

Counterpart of ``spark_rapids_jni_tpu/serve/worker.py``.  Spawned by
:class:`~.frontdoor.FrontDoor` as ``python -m
spark_rapids_jni_tpu_torch.serve.worker --socket ... --dir ...``.  Each
worker owns the whole single-process stack (its own arena, spill store
rooted under its private directory, plan cache and ``ServeRuntime``), so
a crash or wedge takes down one process's tenants and nothing shared.

``--device`` names where the worker computes: the GPU by default (``cuda``),
``cpu`` where the caller asks for it, as the tests do.  A worker asked for
CUDA on a machine without one raises at start; it never carries on on the
CPU.  The CUDA context is made before the hello, so the first query does
not pay for it.

The worker serves both fleet transports (``--transport unix|tcp``,
:mod:`.wire`): it dials the supervisor, opens with the idempotent
``hello`` carrying ``(worker_id, fence_epoch, resume_token)``, and treats
connection loss as recoverable: a bounded reconnect ladder
(``--reconnect-max`` attempts, exponential backoff, capped by the
partition grace) re-dials and re-hellos; the same resume token re-attaches
this incarnation to its live sessions supervisor-side, and results that
could not be delivered while the link was down are queued and flushed
after reattach, so a dropped link costs no session.

Split-brain safety: a worker that cannot reach the supervisor past
``--partition-grace-ms`` assumes it was declared dead on the other side.
It SELF-FENCES: revokes its own store epoch so none of its in-flight
commits can ever be adopted, writes a ``self-fenced.json`` sentinel the
supervisor reads at loss time, then drains and exits.  The main loop also
re-validates its fence epoch against the store every ~0.5 s: a generation
the supervisor revoked stops serving.  ``--orphan-grace-ms`` bounds how
long a link that looks up may carry nothing at all before the worker
self-fences the same way.

Submissions arrive as ``{"kind": name, "params": {...}}`` and are looked
up in the query-kind registry (:func:`register_query_kind`); the wire
carries only JSON, never code.  Built-in kinds:

* ``echo`` returns ``params["value"]``;
* ``sleep`` waits cooperatively for ``params["seconds"]``;
* ``spill_walk`` walks a seeded batch device -> host -> disk and back
  and returns a sha256 of the promoted bytes;
* ``q6_digest`` runs ``steps`` q6 steps (:func:`..pipelines.q6_step`,
  the one-hot group-by kernel on the GPU) over seeded example batches,
  each under a ``SpillableHandle``, and returns ``[digest, seconds]``;
* ``shuffle_digest`` runs a seeded exchange over a :class:`ShardMesh`
  of 8 shards, keyed by ``params["store_key"]`` through the persistent
  shuffle store (``--store-dir``), and returns the delivered rows' sha256
  plus whether the map ran or a prior attempt's committed shards were
  adopted;
* ``arrow_batch`` returns :func:`make_result_batch`, a batch that rides
  the data plane.

``--setup`` names a module whose ``register_query_kinds(register)`` adds
kinds before serving.

Data plane: a result that is a ``ColumnBatch`` crosses as one Arrow IPC
stream (:mod:`..columnar.arrow_ipc`, encoded columns kept), per
``--data-plane``: a sealed memfd passed with the result descriptor
(``shm``), binary chunk frames ahead of it (``frames``), or inline base64
(``json``, refused loudly past the control-frame cap).  The descriptor
stamps this incarnation's fence epoch and per-chunk CRC32s; the
``data_write_wk`` / ``data_descriptor_wk`` probes let ``shm_torn`` tear
stamped bytes and ``shm_stale`` name a prior generation's segment.

Fault injection: the supervisor exports its live schedule through
``SPARK_RAPIDS_TPU_FAULT_CONFIG`` and points
``SPARK_RAPIDS_TPU_FAULT_MIRROR`` at a per-worker trace, so an injection
survives even this process's SIGKILL.  ``worker_crash`` kills -9 this
process and ``worker_stall`` wedges it (:func:`..faultinj.
set_worker_fault_hooks`); the ``net_*`` kinds fire inside the transport.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

_QUERY_KINDS: Dict[str, Callable] = {}

_WEDGED = threading.Event()

SHUFFLE_SHARDS = 8  # the reference's tests run its exchange on 8 devices

# where this process computes; main() sets it from --device
_DEVICE = [torch.device("cpu")]


def device() -> torch.device:
    """The device this worker computes on."""
    return _DEVICE[0]


def register_query_kind(name: str, fn: Callable):
    """Register ``fn(ctx, params, sess)`` under ``name`` for submissions."""
    _QUERY_KINDS[name] = fn


def _hash_array(dig, a: np.ndarray):
    dig.update(str(a.dtype).encode())
    dig.update(str(a.shape).encode())
    dig.update(np.ascontiguousarray(a).tobytes())


def _qk_echo(ctx, params, sess):
    return params.get("value")


def _qk_sleep(ctx, params, sess):
    end = time.monotonic() + float(params.get("seconds", 0.1))
    while time.monotonic() < end:
        sess._check_cancelled()
        time.sleep(0.01)
    return "slept"


def _qk_spill_walk(ctx, params, sess):
    from ..mem import spill as spill_mod

    seed = int(params.get("seed", 0))
    rows = int(params.get("rows", 8192))
    src = (np.arange(rows, dtype=np.int64) * (seed + 5)) % 7919

    def make():
        return {"x": torch.from_numpy(src.copy()).to(device())}

    h = spill_mod.SpillableHandle(make(), ctx=ctx,
                                  name=f"worker-walk-{seed}",
                                  recompute=make)
    # the full tier walk: device -> host -> disk, then promote and hash
    h.spill()
    h.spill_host()
    out = h.get()["x"].cpu().numpy()
    h.close()
    dig = hashlib.sha256()
    _hash_array(dig, out)
    return dig.hexdigest()


def _qk_shuffle_digest(ctx, params, sess):
    from ..columnar.column import batch_from_numpy
    from ..parallel import ShardMesh, shard_batch
    from ..shuffle import ShuffleService, get_registry
    from ..shuffle import store as store_mod

    seed = int(params.get("seed", 0))
    n = SHUFFLE_SHARDS * int(params.get("rows_per_shard", 64))
    store_key = str(params.get("store_key") or f"shuffle-{seed}-{n}")
    # a pure function of the seed: digests compare bit for bit across
    # attempts, workers, and store-enabled vs store-disabled runs
    vals = (np.arange(n, dtype=np.int64) * (2 * seed + 3)) % 7919
    pid = ((np.arange(n, dtype=np.int64) + seed)
           % SHUFFLE_SHARDS).astype(np.int32)
    mesh = ShardMesh(SHUFFLE_SHARDS, device())
    batch = shard_batch(batch_from_numpy(
        {"v": (vals, np.ones(n, np.bool_), "int64")}, device()), mesh)

    store = store_mod.get_store()
    pre_committed = store is not None \
        and store.has_committed(store_key, "map")
    m0 = get_registry().metrics.snapshot()
    res = ShuffleService(mesh).exchange(
        batch, pid=torch.from_numpy(pid).to(device()), round_rows=16,
        ctx=ctx, store_key=store_key)
    m1 = get_registry().metrics.snapshot()
    adopted = int(m1["adopted_shards"] - m0["adopted_shards"])

    dig = hashlib.sha256()
    for leaf in (res.batch["v"].data, res.occupancy):
        _hash_array(dig, leaf.cpu().numpy())
    return {
        "digest": dig.hexdigest(),
        "adopted": adopted,
        "rebuilt": int(m1["lineage_rebuilds"] - m0["lineage_rebuilds"]),
        # 0 when a prior attempt's committed map output was adopted
        # instead of running the map again
        "map_runs": 0 if (pre_committed and adopted > 0) else 1,
    }


def q6_seed(stream: int, query: int, step: int) -> int:
    """The example batch's seed of one q6 step of one tenant query."""
    return 1000 * stream + 10 * query + step


def digest_q6(dig, res, ng):
    """Feed one q6 step's output into ``dig``: every result column's data
    and validity in name order, then the group count."""
    for col in res.columns:
        _hash_array(dig, col.data.cpu().numpy())
        _hash_array(dig, col.validity.cpu().numpy())
    _hash_array(dig, np.asarray(ng.cpu().numpy() if torch.is_tensor(ng)
                                else ng))


def run_q6(ctx, params, step_out: Callable):
    """``steps`` q6 steps of one tenant query, each input a
    ``SpillableHandle`` charged to the query's task; ``step_out(s, res,
    ng)`` sees each step's output."""
    from .. import mem
    from .. import pipelines as PL

    rows = int(params.get("rows", 1 << 14))
    stream = int(params.get("stream", 0))
    query = int(params.get("query", 0))
    for s in range(int(params.get("steps", 2))):
        b = PL.example_batch(rows, seed=q6_seed(stream, query, s),
                             device=device())
        h = mem.SpillableHandle(b, ctx=ctx,
                                name=f"worker-q6-{stream}-{query}-{s}")
        try:
            res, ng = PL.q6_step(b)
            step_out(s, res, ng)
        finally:
            h.close()


def _qk_q6_digest(ctx, params, sess):
    t0 = time.perf_counter()
    dig = hashlib.sha256()
    run_q6(ctx, params, lambda s, res, ng: digest_q6(dig, res, ng))
    if device().type == "cuda":
        torch.cuda.synchronize(device())
    return [dig.hexdigest(), time.perf_counter() - t0]


def make_result_batch(rows: int, seed: int, device_=None):
    """A deterministic columnar result for the data plane: a pure function
    of ``(rows, seed)``, bit for bit the reference's ``make_result_batch``:
    dictionary strings (null rows borrowing a live code), a run-length
    int column, floats with NaN and -0.0 payloads.  On ``device_`` (this
    worker's device by default)."""
    from ..columnar import types as T
    from ..columnar.column import Column, ColumnBatch, StringColumn
    from ..columnar.encoded import encode_column, encode_rle

    dev = device() if device_ is None else torch.device(device_)
    n = int(rows)
    seed = int(seed)
    idx = np.arange(n, dtype=np.int64)
    v = (idx * (2 * seed + 3)) % 104729
    f = idx.astype(np.float64) * 0.5 - n / 4.0
    f[idx % 97 == 0] = np.nan
    f[idx % 89 == 0] = -0.0
    fv = (idx + seed) % 13 != 0
    tags = [t.encode() for t in
            ("alpha", "beta", "gamma", "delta-longer", "épsilon")]
    w = -(-max(len(t) for t in tags) // 8) * 8
    tmpl = np.zeros((len(tags), w), np.uint8)
    tlens = np.zeros((len(tags),), np.int32)
    for i, t in enumerate(tags):
        tmpl[i, :len(t)] = np.frombuffer(t, np.uint8)
        tlens[i] = len(t)
    tagidx = ((idx * (seed + 1)) % len(tags)).astype(np.int64)
    sv = (idx + 2 * seed) % 11 != 0
    chars = tmpl[tagidx] * sv[:, None].astype(np.uint8)
    lens = (tlens[tagidx] * sv).astype(np.int32)
    base = (np.arange(n // 8 + 1, dtype=np.int64) * (seed + 1)) % 5
    r = np.repeat(base, 8)[:n].astype(np.int32)
    rv = (idx + seed) % 17 != 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ColumnBatch({
        "v": Column(t(v), t(np.ones((n,), np.bool_)), T.INT64),
        "f": Column(t(f), t(fv), T.FLOAT64),
        "tag": encode_column(StringColumn(t(chars), t(lens), t(sv))),
        "r": encode_rle(Column(t(r), t(rv), T.INT32)),
    })


def _qk_arrow_batch(ctx, params, sess):
    return make_result_batch(int(params.get("rows", 1 << 13)),
                             int(params.get("seed", 0)))


register_query_kind("echo", _qk_echo)
register_query_kind("sleep", _qk_sleep)
register_query_kind("spill_walk", _qk_spill_walk)
register_query_kind("shuffle_digest", _qk_shuffle_digest)
register_query_kind("q6_digest", _qk_q6_digest)
register_query_kind("arrow_batch", _qk_arrow_batch)


def _crash_hook(name: str):
    # kill -9: no unwind, no atexit, no spill cleanup; the supervisor's
    # reaper is the only recovery path
    os.kill(os.getpid(), signal.SIGKILL)


def _stall_hook(name: str):
    # a wedge: the main loop stops answering pings (so the supervisor's
    # heartbeat detector must catch it) and the querying thread blocks
    _WEDGED.set()
    while True:
        time.sleep(60.0)


class _SupervisorLink:
    """The worker's side of the supervised connection: one live
    transport, the idempotent hello, the bounded reconnect ladder, and
    the queue of frames that must survive a link outage (``running`` /
    ``result``; the supervisor dedups by sid, so a flush after reattach
    is at-least-once delivery with exactly-once effect)."""

    def __init__(self, wire_mod, kind: str, address: str, worker_id: int,
                 epoch: int, token: str, grace_s: float,
                 reconnect_max: int):
        self._wire = wire_mod
        self.kind = kind
        self.address = address
        self.worker_id = int(worker_id)
        self.epoch = int(epoch)
        self.token = str(token)
        self.grace_s = float(grace_s)
        self.reconnect_max = int(reconnect_max)
        self._lock = threading.Lock()
        self._t = None
        # queued deliveries: (msg, fds, chunks); a data-plane result keeps
        # its segment fd or chunk list alive across the outage
        self._unsent: List[tuple] = []
        self.last_contact = time.monotonic()
        self.reconnects = 0
        # () -> live sids, carried on every (re)hello so a supervisor can
        # reconcile its placements against what this worker holds
        self.active_sids_fn = None

    def down(self) -> bool:
        with self._lock:
            return self._t is None

    def connect(self):
        """Dial and hello; raises on failure (:meth:`reconnect` is the
        retry policy)."""
        t = self._wire.connect(self.kind, self.address, role="wk",
                               timeout_s=2.0)
        extra = {}
        if self.active_sids_fn is not None:
            with contextlib.suppress(Exception):
                extra["active_sids"] = sorted(self.active_sids_fn())
        try:
            t.hello(self.worker_id, os.getpid(), self.epoch, self.token,
                    **extra)
        except (self._wire.WireError, OSError):
            t.close()
            raise
        t.settimeout(0.05)  # the poll tick: lets the wedge flag win
        with self._lock:
            old, self._t = self._t, t
        if old is not None:
            old.close()
        self.last_contact = time.monotonic()

    def reconnect(self) -> bool:
        """Up to ``reconnect_max`` re-dials with exponential backoff,
        never outlasting the partition grace.  True: reattached (queued
        frames flushed); False: partitioned."""
        start = time.monotonic()
        for attempt in range(self.reconnect_max):
            if time.monotonic() - start > self.grace_s:
                return False
            try:
                self.connect()
            except (self._wire.WireError, OSError):
                time.sleep(min(0.03 * (2 ** attempt),
                               max(0.05, self.grace_s / 4.0)))
                continue
            self.reconnects += 1
            self.flush_unsent()
            return True
        return False

    def _drop(self, t):
        with self._lock:
            if self._t is t:
                self._t = None
        t.close()

    def send(self, msg: dict, queue_on_fail: bool = False) -> bool:
        return self.send_payload(msg, None, None,
                                 queue_on_fail=queue_on_fail)

    def send_payload(self, msg: dict, fds: Optional[List[int]],
                     chunks: Optional[List[bytes]],
                     queue_on_fail: bool = False) -> bool:
        """Deliver one message and its data-plane payload: chunk frames
        go first (stream order stashes them supervisor-side before the
        descriptor arrives), an fd rides the descriptor frame itself.  On
        success this process's fd copy closes.  A failed delivery requeues
        the whole job."""
        with self._lock:
            t = self._t
            if t is None:
                if queue_on_fail:
                    self._unsent.append((msg, fds, chunks))
                return False
        try:
            if chunks:
                sid = int(msg["sid"])
                for seq, c in enumerate(chunks):
                    t.send_data(sid, seq, c)
            if fds:
                t.send_with_fds(msg, fds)
            else:
                t.send(msg)
        except (self._wire.WireError, OSError):
            self._drop(t)
            if queue_on_fail:
                with self._lock:
                    self._unsent.append((msg, fds, chunks))
            return False
        for fd in fds or ():
            with contextlib.suppress(OSError):
                os.close(fd)
        return True

    def flush_unsent(self):
        with self._lock:
            pending, self._unsent = self._unsent, []
        for i, job in enumerate(pending):
            if not self.send_payload(*job):
                with self._lock:
                    self._unsent = pending[i:] + self._unsent
                return

    def recv(self) -> dict:
        """One frame from the supervisor; ``socket.timeout`` at a frame
        boundary passes through for the poll loop, anything else drops
        the link (the main loop's ladder takes over)."""
        with self._lock:
            t = self._t
        if t is None:
            raise self._wire.WireError("link down")
        try:
            msg = t.recv()
        except socket.timeout:
            raise
        except (self._wire.WireError, OSError, ValueError):
            self._drop(t)
            raise self._wire.WireError("link lost")
        self.last_contact = time.monotonic()
        return msg

    def close(self):
        with self._lock:
            t, self._t = self._t, None
        if t is not None:
            t.close()


def _open_device(name: str) -> torch.device:
    """The worker's device, with its context made: CUDA must be there
    when asked for (never a silent fall-back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"worker asked for {name} but this machine has no CUDA "
                "device; pass --device cpu to compute on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context, before the hello
    elif dev.type == "cpu":
        # one fleet process of several on the box: one intra-op thread
        torch.set_num_threads(1)
    else:
        raise ValueError(f"unsupported worker device {name!r}")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True,
                    help="supervisor address: Unix path, or host:port "
                         "for --transport tcp")
    ap.add_argument("--transport", default="unix",
                    choices=("unix", "tcp"))
    ap.add_argument("--worker-id", required=True, type=int)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="where queries compute: cuda (the default) or "
                         "cpu; cuda on a machine without it raises")
    ap.add_argument("--host", default="",
                    help="logical placement host (informational: echoed "
                         "in the self-fence sentinel)")
    ap.add_argument("--pool-bytes", type=int, default=64 << 20)
    ap.add_argument("--host-pool-bytes", type=int, default=16 << 20)
    ap.add_argument("--max-concurrent", type=int, default=0)
    ap.add_argument("--task-id-base", type=int, default=10_000)
    ap.add_argument("--store-dir", default=None,
                    help="fleet-shared persistent shuffle store root")
    ap.add_argument("--epoch", type=int, default=0,
                    help="this incarnation's store fencing epoch (the "
                         "supervisor passes the worker generation)")
    ap.add_argument("--resume-token", default="",
                    help="incarnation identity echoed in every hello so "
                         "a reconnect reattaches instead of replacing")
    ap.add_argument("--partition-grace-ms", type=float, default=1500.0)
    ap.add_argument("--orphan-grace-ms", type=float, default=0.0,
                    help="supervisor-silence bound (serve_orphan_grace_ms"
                         "): a link that looks up but has carried nothing "
                         "for this long means the supervisor died "
                         "without closing the socket, and the worker "
                         "self-fences; 0 disables")
    ap.add_argument("--reconnect-max", type=int, default=4)
    ap.add_argument("--data-plane", default="auto",
                    choices=("auto", "shm", "frames", "json"),
                    help="how ColumnBatch results cross back: memfd + "
                         "SCM_RIGHTS, binary chunk frames, or inline "
                         "base64 (resolved against --transport)")
    ap.add_argument("--segment-bytes", type=int, default=1 << 20,
                    help="data-plane chunk granularity (CRC stamp and "
                         "data-frame size; the serve_segment_bytes knob)")
    ap.add_argument("--setup", default=None,
                    help="module whose register_query_kinds(register) "
                         "adds custom kinds before serving")
    args = ap.parse_args(argv)

    _DEVICE[0] = _open_device(args.device)

    from .. import faultinj
    faultinj.configure()  # env: the supervisor's exported schedule
    faultinj.set_worker_fault_hooks(crash=_crash_hook, stall=_stall_hook)

    from ..columnar import arrow_ipc
    from ..mem import spill as spill_mod
    from ..mem.rmm_spark import RmmSpark
    from . import data_plane as dp
    from . import wire
    from .runtime import ServeRuntime

    plane = dp.resolve_plane(args.data_plane, args.transport)

    if args.setup:
        importlib.import_module(args.setup).register_query_kinds(
            register_query_kind)

    spill_dir = os.path.join(args.dir, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    adaptor = RmmSpark.set_event_handler(
        args.pool_bytes, host_pool_bytes=args.host_pool_bytes, poll_ms=20.0)
    fw = spill_mod.install(spill_dir=spill_dir)
    store = None
    if args.store_dir:
        from ..shuffle import store as shuffle_store
        store = shuffle_store.install(args.store_dir, epoch=args.epoch)
    runtime = ServeRuntime(
        max_concurrent=args.max_concurrent or None,
        task_id_base=args.task_id_base,
        store=store, epoch=args.epoch)

    link = _SupervisorLink(
        wire, args.transport, args.socket, args.worker_id, args.epoch,
        args.resume_token, grace_s=args.partition_grace_ms / 1000.0,
        reconnect_max=args.reconnect_max)

    def self_fence(reason: str):
        # revoke our OWN epoch first, so a commit still in flight on a
        # query thread is rejected at the store's rename
        if store is not None:
            with contextlib.suppress(OSError):
                store.revoke(args.epoch)
        info = {"worker_id": args.worker_id, "pid": os.getpid(),
                "epoch": args.epoch, "host": args.host,
                "reason": reason, "reconnects": link.reconnects}
        if store is not None:
            with contextlib.suppress(OSError):
                info["fenced_commits"] = \
                    store.snapshot().get("fenced_commits", 0)
        tmp = os.path.join(args.dir, "self-fenced.json.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(info, f)
            os.replace(tmp, os.path.join(args.dir, "self-fenced.json"))
        except OSError:
            pass

    partitioned = False
    revoked_out = False
    try:
        link.connect()
    except (wire.WireError, OSError):
        if not link.reconnect():
            self_fence("could not reach the supervisor at startup")
            partitioned = True

    sessions: Dict[int, object] = {}
    link.active_sids_fn = lambda: [
        sid for sid, s in sessions.items() if not s.done()]
    watchers: list = []
    # lifecycle points unique to the process boundary: a submission was
    # received (no session yet) and a result is about to be sent
    recv_probe = faultinj.instrument(lambda: None, "worker_recv")
    result_probe = faultinj.instrument(lambda: None, "worker_result")
    # data-plane fault points: after the CRC stamp, and at descriptor
    # build
    data_write_probe = faultinj.instrument(lambda: None, "data_write_wk")
    data_desc_probe = faultinj.instrument(lambda: None,
                                          "data_descriptor_wk")
    # the retirement ladder's fault point
    drain_probe = faultinj.instrument(lambda: None, "worker_drain")
    seg_seq = iter(range(1 << 62))
    # sid -> the input snapshot id the submit declared, echoed on the
    # result descriptor
    sid_snapshots: Dict[int, object] = {}

    def encode_batch_result(sid: int, batch):
        """ColumnBatch -> (descriptor fields, fds, chunk frames) on the
        resolved plane; payload bytes enter the JSON message only on the
        capped ``json`` fallback."""
        payload, fp = arrow_ipc.batch_to_ipc(batch)
        view = memoryview(payload)
        chunk_bytes = max(1, int(args.segment_bytes))
        crcs = dp.chunk_crcs(view, chunk_bytes)
        torn_at: Optional[int] = None
        try:
            data_write_probe()
        except faultinj.ShmTornError:
            # real damage after the stamps: flip a byte in the middle of
            # the payload the CRCs claim to cover
            torn_at = len(view) // 2 if len(view) else None
        name = dp.segment_name(args.worker_id, args.epoch, next(seg_seq))
        desc = dp.build_descriptor(plane, name, len(view), fp,
                                   chunk_bytes, crcs, args.epoch,
                                   snapshot=sid_snapshots.pop(sid, None))
        try:
            data_desc_probe()
        except faultinj.ShmStaleError:
            stale = max(0, args.epoch - 1)
            desc["epoch"] = stale
            desc["seg"] = dp.segment_name(args.worker_id, stale, 0)
        if plane == "shm":
            fd = dp.make_segment(name, view)
            if torn_at is not None:
                b = os.pread(fd, 1, torn_at)
                os.pwrite(fd, bytes([b[0] ^ 0xFF]), torn_at)
            dp.seal_segment(fd)
            desc["fds"] = 1
            return desc, [fd], None
        raw = bytearray(view)
        if torn_at is not None:
            raw[torn_at] ^= 0xFF
        if plane == "frames":
            chunks = [bytes(raw[o:o + chunk_bytes])
                      for o in range(0, len(raw), chunk_bytes)]
            return desc, None, chunks
        # DataPlaneOverflow past the control-frame cap: never truncated
        desc["inline"] = dp.encode_json_payload(raw)
        return desc, None, None

    def watch(sid: int, sess):
        sess._done.wait()
        fds = chunks = None
        try:
            result_probe()  # crash with the result undelivered
            if sess.error is None:
                msg = {"op": "result", "sid": sid, "ok": True,
                       "status": sess.status}
                if dp.is_batch(sess.result_value):
                    msg["data"], fds, chunks = encode_batch_result(
                        sid, sess.result_value)
                else:
                    msg["value"] = sess.result_value
            else:
                msg = {"op": "result", "sid": sid, "ok": False,
                       "status": sess.status,
                       "error": type(sess.error).__name__,
                       "message": str(sess.error)}
        except BaseException as e:  # a non-crash kind fired at the probe
            msg = {"op": "result", "sid": sid, "ok": False,
                   "status": "failed", "error": type(e).__name__,
                   "message": str(e)}
        # queued on a downed link, flushed after reattach
        link.send_payload(msg, fds, chunks, queue_on_fail=True)

    def handle_submit(msg: dict):
        sid = int(msg["sid"])
        if sid in sessions:
            # a duplicate after a reattach: re-ack, never run twice
            if not sessions[sid].done():
                link.send({"op": "running", "sid": sid},
                          queue_on_fail=True)
            return
        kind = _QUERY_KINDS.get(msg.get("kind"))
        if kind is None:
            link.send({
                "op": "result", "sid": sid, "ok": False, "status": "failed",
                "error": "ServeError",
                "message": f"unknown query kind {msg.get('kind')!r}",
            }, queue_on_fail=True)
            return
        params = msg.get("params") or {}
        if msg.get("snapshot") is not None:
            sid_snapshots[sid] = msg["snapshot"]
        announced = threading.Event()

        def query(ctx, sess):
            if not announced.is_set():
                announced.set()
                link.send({"op": "running", "sid": sid},
                          queue_on_fail=True)
            return kind(ctx, params, sess)

        try:
            sess = runtime.submit(
                query, est_bytes=int(msg.get("est_bytes") or 0),
                tenant=msg.get("tenant"), timeout_s=msg.get("timeout_s"),
                priority=int(msg.get("priority") or 0))
        except BaseException as e:
            link.send({
                "op": "result", "sid": sid, "ok": False, "status": "failed",
                "error": type(e).__name__, "message": str(e)},
                queue_on_fail=True)
            return
        sessions[sid] = sess
        t = threading.Thread(target=watch, args=(sid, sess),
                             name=f"worker-watch-{sid}", daemon=True)
        watchers.append(t)
        t.start()

    # -- main loop -------------------------------------------------------
    last_fence_check = time.monotonic()
    orphan_grace_s = max(0.0, args.orphan_grace_ms / 1000.0)
    draining = False
    retired = False
    while not partitioned:
        if draining and all(s.done() for s in sessions.values()):
            # drained: fall through to the retire exit
            retired = True
            break
        if _WEDGED.is_set():
            # a simulated wedge: only the supervisor's SIGKILL ends it
            while True:
                time.sleep(60.0)
        now = time.monotonic()
        # a generation the supervisor revoked has been declared lost:
        # stop serving rather than compute results nobody adopts
        if store is not None and now - last_fence_check >= 0.5:
            last_fence_check = now
            fenced = False
            with contextlib.suppress(OSError):
                fenced = store.fenced(args.epoch)
            if fenced:
                revoked_out = True
                break
        # orphaned: the link looks up but carried nothing past the grace
        if orphan_grace_s > 0.0 and not link.down() \
                and now - link.last_contact > orphan_grace_s:
            self_fence("orphaned: supervisor silent past "
                       "serve_orphan_grace_ms")
            partitioned = True
            break
        if link.down():
            if link.reconnect():
                continue
            self_fence("supervisor unreachable past the partition grace")
            partitioned = True
            break
        try:
            msg = link.recv()
        except socket.timeout:
            continue
        except (wire.WireError, OSError):
            continue  # the loop top runs the reconnect ladder
        op = msg.get("op")
        if op == "ping":
            link.send({
                "op": "pong", "t": msg.get("t"),
                "stall_breaks": RmmSpark.stall_break_count(),
                "live_sessions": sum(
                    1 for s in sessions.values() if not s.done()),
                # load signals for the placement scorer
                "queue_depth": runtime.queue_depth(),
                "arena_bytes": int(adaptor.total_allocated()),
                "pool_bytes": int(args.pool_bytes),
                "fence_epoch": args.epoch,
                "reconnects": link.reconnects,
                "fired": faultinj.fired_log(),
            })
        elif op == "drain":
            # a retirement order: finish placed sessions, accept nothing
            # new, self-fence, exit
            drain_probe()
            draining = True
        elif op == "submit":
            try:
                recv_probe()  # crash before the session exists
            except BaseException as e:
                link.send({
                    "op": "result", "sid": int(msg["sid"]), "ok": False,
                    "status": "failed", "error": type(e).__name__,
                    "message": str(e)}, queue_on_fail=True)
                continue
            handle_submit(msg)
        elif op == "cancel":
            sess = sessions.get(int(msg.get("sid", -1)))
            if sess is not None and not sess.done():
                runtime.cancel(sess)
        elif op == "shutdown":
            break

    # -- graceful drain --------------------------------------------------
    clean = runtime.shutdown()
    for t in watchers:
        t.join(timeout=5.0)
    fenced_commits = 0
    if retired and store is not None:
        # a retired generation fences itself before the bye
        with contextlib.suppress(OSError):
            store.revoke(args.epoch)
            fenced_commits = store.snapshot().get("fenced_commits", 0)
    residue = [adaptor.total_allocated(), adaptor.host_total_allocated()]
    store_len = len(fw.store)
    leftovers = sorted(os.listdir(spill_dir)) if os.path.isdir(
        spill_dir) else []
    spill_mod.shutdown()
    RmmSpark.clear_event_handler()
    link.send({
        "op": "bye", "clean": bool(clean), "residue": residue,
        "store_len": store_len, "leftovers": leftovers,
        "retired": bool(retired), "fenced_commits": int(fenced_commits),
        "fired": faultinj.fired_log(),
    })
    link.close()
    if partitioned:
        return 3  # self-fenced: the sentinel tells the supervisor why
    if revoked_out:
        return 4  # fenced by the supervisor: this gen is already revoked
    return 0 if clean else 1


if __name__ == "__main__":
    # run as the package's module, so a --setup module that imports it
    # shares its state (the device, the kind registry)
    from spark_rapids_jni_tpu_torch.serve import worker as _worker

    sys.exit(_worker.main())
