"""Multi-process serving front door: supervised executor workers.

Counterpart of ``spark_rapids_jni_tpu/serve/frontdoor.py``.  The
one-process :class:`~.runtime.ServeRuntime` keeps every tenant in one
interpreter, so one wedged or killed process takes them all down.  The
front door splits that blast radius along the process boundary:

* **Supervisor** (:class:`FrontDoor`) listens on a Unix-domain socket in
  a private fleet directory (or a ``127.0.0.1`` TCP port with
  ``serve_transport=tcp``, the multi-host placement path) and spawns
  ``serve_workers`` executor processes (``python -m
  spark_rapids_jni_tpu_torch.serve.worker``, launched by
  :mod:`.launcher`), each with its own runtime, arena, spill store and
  plan cache, on ``device`` (the GPU unless the caller asks for the CPU).
* **Placement** (:class:`~.elastic.Placement`) puts each new incarnation
  on a ``serve_hosts`` logical host and each session on a worker; a
  tenant's sessions stick to one worker while it lives (a lost worker's
  tenants are re-pinned by placement, not held for its respawn).
* **Connection supervision is not process supervision**: a lost
  connection parks the slot in ``reconnecting`` while the worker's
  bounded ladder re-attaches the same incarnation by its resume token;
  live sessions survive, queued results flush, nothing re-runs.  Only a
  lost *worker* (crash, wedge, or a link silent past
  ``serve_partition_grace_ms``) runs the loss protocol.  A worker cut off
  past the grace self-fences (revokes its own store epoch, writes a
  ``self-fenced.json`` sentinel, exits), so a partitioned-but-alive
  worker never zombie-commits.
* **Heartbeats**: every ``serve_heartbeat_ms`` the supervisor pings each
  worker; pongs carry the native stall-breaker epoch, the live-session
  count and the placement load signals.  A worker silent past ~3.5
  periods, or whose stall epoch keeps climbing with nothing completing,
  is declared wedged.
* **Loss protocol**: a crashed, wedged or never-connected worker is
  SIGKILLed, its generation fenced in the shuffle store, its directory
  reaped and its fault trace merged into this process's
  :func:`~..faultinj.fired_log`.  Queued or replayable sessions re-place
  through the bounded ``serve_max_readmissions`` / ``serve_backoff_ms``
  ladder; in-flight non-replayable ones fail with :class:`WorkerLost`.
* **Respawn**: lost slots respawn with exponential backoff; a slot
  respawned more than ``serve_respawn_max`` times opens its circuit
  breaker.
* **Degradation**: below ``serve_shed_threshold`` of the configured
  workers alive, pending admissions beyond the surviving capacity are
  shed lowest priority first (:class:`AdmissionShed`); when no worker can
  ever come back, pending sessions fail with :class:`WorkerLost`.
* **Data plane**: result batches cross as one Arrow IPC stream
  (:mod:`..columnar.arrow_ipc`) on the ``serve_data_plane`` plane; the
  supervisor verifies the descriptor's fence epoch and every chunk CRC
  before decoding.  A damaged transfer re-queues the session under a
  fresh sid through the same bounded ladder.
* **Durable shuffle plane**: a fleet-shared
  :mod:`~..shuffle.store` root lives in the fleet directory; each
  generation commits there with its generation as the fencing epoch.  At
  loss the dead generation is fenced (``fence_handoff``) and only its
  uncommitted entries reaped, so a replacement adopts committed shards.
  ``shuffle_store_retain`` keeps the store past :meth:`FrontDoor.
  shutdown`.
* **Journal**: with ``serve_journal`` on, every session transition and
  fleet fact is appended write-ahead to the fleet directory's journal
  (:mod:`.journal`).

ROADMAP item 16d brings the rest of the reference's front door:
autoscaling with its drain and retire, per-tenant quotas, the fleet
result cache (``submit(snapshot=...)``) and recovery from the
supervisor's own crash (``adopt_dir=``).  Each raises ``not_ported``.
The reference's warm plan hand-off to a respawned worker
(``serve_plan_warm``) is 16d too: none of the port's query kinds has a
first-query compile for it to skip.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

from .. import config, faultinj
from .._roadmap import not_ported
from ..shuffle import store as store_mod
from . import data_plane, wire
from . import elastic as elastic_mod
from . import journal as journal_mod
from .launcher import launcher_from_config
from .runtime import QueryCancelled, QueryTimeout, ServeError

_MISS_BUDGET = 3.5       # heartbeat periods of silence before SIGKILL
_STALL_EPOCH_LIMIT = 8   # consecutive no-progress epoch bumps before kill
# max wait for a spawned worker's hello: a worker imports torch and, on
# the GPU, makes its CUDA context first; a loaded test box is slow at both
_STARTUP_GRACE_S = 60.0
_UNIX_PATH_MAX = 107     # sun_path holds 108 bytes with the NUL


class WorkerLost(ServeError):
    """The worker process hosting this session died and the session could
    not be re-placed: it was mid-flight and not replayable, its
    re-placement budget ran out, or no healthy worker can ever come back.
    Carries the dead worker's last injection trace."""

    def __init__(self, message: str, worker_id: Optional[int] = None,
                 fired_log: Optional[List[dict]] = None):
        super().__init__(message)
        self.worker_id = worker_id
        self.fired_log = list(fired_log or [])


class AdmissionShed(ServeError):
    """Degraded-mode load shedding: healthy capacity dropped below
    ``serve_shed_threshold`` and this pending admission was in the
    lowest priority class beyond the surviving capacity."""


class FleetMetrics:
    """Fleet-level counters and per-worker liveness, scraped through
    :func:`fleet_metrics` and ``RmmSpark.fleet_metrics()``.  The fields
    are the reference's; those of ROADMAP item 16d's branches stay 0."""

    FIELDS = ("workers_spawned", "respawns", "crashes", "stalls",
              "replacements", "worker_lost", "sheds", "circuit_open",
              "reconnects", "partitions_detected", "self_fenced_workers",
              "data_batches", "data_payload_bytes", "data_json_bytes",
              "data_plane_errors", "cache_hits", "hit_bytes_served",
              "scale_ups", "scale_downs", "scale_up_failures",
              "quota_rejections", "plan_warm_shipped",
              "recovered_sessions", "adopted_workers",
              "replayed_sessions")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.FIELDS, 0)
        self._liveness: Dict[int, str] = {}

    def bump(self, field: str, n: int = 1):
        with self._lock:
            self._counts[field] += n

    def set_liveness(self, worker_id: int, state: str):
        with self._lock:
            self._liveness[int(worker_id)] = state

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["liveness"] = dict(self._liveness)
            return out


# the last-constructed front door's metrics; zeros before any ran
_last_metrics = FleetMetrics()


def fleet_metrics() -> dict:
    return _last_metrics.snapshot()


class FrontDoorSession:
    """Supervisor-side handle of one submitted query.

    Status walks ``pending -> placed -> running -> done`` on the happy
    path, ending in ``failed`` / ``cancelled`` / ``shed`` otherwise;
    ``replacements`` counts the worker losses it survived.
    ``replayable=False`` declares the query non-idempotent: once seen
    ``running`` it is never re-placed, and a worker loss fails it with
    :class:`WorkerLost`."""

    def __init__(self, door: "FrontDoor", sid: int, kind: str,
                 params: Optional[dict], tenant, priority: int,
                 est_bytes: int, timeout_s: Optional[float],
                 replayable: bool):
        self._door = door
        self.sid = sid
        self.kind = kind
        self.params = dict(params or {})
        self.tenant = tenant
        self.priority = int(priority)
        self.est_bytes = int(est_bytes or 0)
        self.timeout_s = timeout_s
        self.replayable = bool(replayable)
        self.served_from_cache = False
        self.status = "pending"
        self.worker_id: Optional[int] = None
        self.replacements = 0
        # data-plane transfer retries: their own budget, the same bound
        self.data_retries = 0
        self.result_value = None
        self.error: Optional[BaseException] = None
        self._cancel_requested = False
        self._done = threading.Event()
        self.submitted_at = time.monotonic()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"session {self.sid} still {self.status} after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result_value

    def cancel(self):
        self._door.cancel(self)

    def close(self, timeout: Optional[float] = 10.0):
        if not self._done.is_set():
            self._door.cancel(self)
        self._done.wait(timeout)

    def _finish(self, value=None, error: Optional[BaseException] = None,
                status: Optional[str] = None):
        if self._done.is_set():
            return
        if status is not None:
            final = status
        elif error is not None:
            final = "failed"
        else:
            final = "done"
        door = self._door
        if door is not None:
            # write-ahead: the terminal transition is durable before any
            # in-memory state observes it
            secs = 0.0
            if final == "done":
                secs = max(0.0, time.monotonic() - self.submitted_at)
            door._jrec("result", sid=self.sid, status=final,
                       from_cache=False, tenant=str(self.tenant),
                       seconds=round(secs, 6))
        self.result_value = value
        self.error = error
        self.status = final
        self._done.set()


class WorkerHandle:
    """Supervisor-side record of one executor worker process: its launch
    handle, socket, private directory (spill files, fault mirror, log),
    heartbeat state and placed sessions.  ``kill()``/``close()`` release
    the process and the socket."""

    def __init__(self, worker_id: int, gen: int, wdir: str,
                 proc, host: str = "local", token: str = ""):
        self.worker_id = int(worker_id)
        self.gen = int(gen)
        self.dir = wdir
        # a launcher.LaunchedWorker: pid/poll/wait/kill, owns_pid
        self.proc = proc
        self.host = host
        self.token = token  # incarnation identity for hello reattach
        self.link: Optional[wire.Transport] = None
        self.state = "starting"  # starting | healthy | reconnecting | dead
        self.spawned_at = time.monotonic()
        self.last_pong = time.monotonic()
        self.conn_lost_at = 0.0
        self.ever_connected = False
        self.stall_breaks = 0
        self.stall_suspect = 0
        self.results_since_pong = 0
        # load signals from the last pong (placement scoring inputs)
        self.queue_depth = 0
        self.arena_bytes = 0
        self.pool_bytes = 0
        self.fired: List[dict] = []
        self.merged = False
        self.bye: Optional[dict] = None
        self.sessions: Dict[int, FrontDoorSession] = {}
        # frames-plane reassembly: sid -> [(seq, chunk bytes)]; chunks
        # arrive before their result descriptor
        self.data_stash: Dict[int, list] = {}

    def kill(self):
        with contextlib.suppress(OSError):
            self.proc.kill()

    def close(self):
        link, self.link = self.link, None
        if link is not None:
            link.close()


class FrontDoor:
    """The supervisor: ``submit(kind, params)`` -> a session pinned to a
    worker process; ``shutdown()`` drains the fleet and returns a
    per-worker cleanliness report (idempotent).

    ``device`` is where the workers compute (``"cuda"``, the default, or
    ``"cpu"``) and where result batches are decoded."""

    def __init__(self, workers: Optional[int] = None,
                 pool_bytes: int = 64 << 20,
                 host_pool_bytes: int = 16 << 20,
                 max_concurrent: Optional[int] = None,
                 heartbeat_ms: Optional[float] = None,
                 respawn_max: Optional[int] = None,
                 shed_threshold: Optional[float] = None,
                 setup: Optional[str] = None,
                 store: bool = True,
                 store_dir: Optional[str] = None,
                 transport: Optional[str] = None,
                 hosts=None,
                 partition_grace_ms: Optional[float] = None,
                 reconnect_max: Optional[int] = None,
                 data_plane_mode: Optional[str] = None,
                 segment_bytes: Optional[int] = None,
                 launcher=None,
                 placement: Optional[str] = None,
                 autoscale: Optional[bool] = None,
                 tenant_quota_bytes: Optional[int] = None,
                 tenant_quota_s: Optional[float] = None,
                 adopt_dir: Optional[str] = None,
                 result_cache=None,
                 device=None):
        global _last_metrics
        if autoscale:
            raise not_ported("FrontDoor autoscaling (serve_autoscale)",
                             "16d")
        if (tenant_quota_bytes or 0) > 0 or (tenant_quota_s or 0) > 0:
            raise not_ported("FrontDoor per-tenant quotas", "16d")
        if adopt_dir is not None:
            raise not_ported("FrontDoor crash adoption (adopt_dir, "
                             "serve_adopt)", "16d")
        if result_cache is not None:
            raise not_ported("the fleet result cache", "16d")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ServeError(
                "FrontDoor asked for cuda workers but this machine has no "
                "CUDA device; pass device='cpu' to compute on the CPU")
        self._n_workers = int(workers if workers is not None
                              else config.get("serve_workers"))
        hosts_raw = hosts if hosts is not None else config.get("serve_hosts")
        if isinstance(hosts_raw, str):
            host_list = [h.strip() for h in hosts_raw.split(",")
                         if h.strip()]
        else:
            host_list = [str(h) for h in hosts_raw]
        self._hosts: List[str] = host_list or ["local"]
        self._transport = str(transport if transport is not None
                              else config.get("serve_transport"))
        if len(self._hosts) > 1 and self._transport == "unix":
            # a Unix socket cannot span boxes: multi-host placement
            # implies the TCP transport
            self._transport = "tcp"
        if self._transport not in ("unix", "tcp"):
            raise ServeError(
                f"serve_transport must be 'unix' or 'tcp', "
                f"got {self._transport!r}")
        try:
            self._data_plane = data_plane.resolve_plane(
                data_plane_mode if data_plane_mode is not None
                else config.get("serve_data_plane"), self._transport)
        except ValueError as e:
            raise ServeError(str(e)) from None
        self._segment_bytes = max(1, int(
            segment_bytes if segment_bytes is not None
            else config.get("serve_segment_bytes")))
        self._grace_s = float(
            partition_grace_ms if partition_grace_ms is not None
            else config.get("serve_partition_grace_ms")) / 1000.0
        self._reconnect_max = int(
            reconnect_max if reconnect_max is not None
            else config.get("serve_reconnect_max"))
        self._pool_bytes = int(pool_bytes)
        self._host_pool_bytes = int(host_pool_bytes)
        self._max_concurrent = int(
            max_concurrent if max_concurrent is not None
            else config.get("serve_max_concurrent"))
        self._hb_s = float(heartbeat_ms if heartbeat_ms is not None
                           else config.get("serve_heartbeat_ms")) / 1000.0
        self._respawn_max = int(respawn_max if respawn_max is not None
                                else config.get("serve_respawn_max"))
        self._shed_threshold = float(
            shed_threshold if shed_threshold is not None
            else config.get("serve_shed_threshold"))
        self._replace_max = int(config.get("serve_max_readmissions"))
        self._backoff_s = float(config.get("serve_backoff_ms")) / 1000.0
        self._setup = setup
        # how workers come to exist (launcher.py) and where they and
        # their sessions go (elastic.py)
        try:
            self._launcher = launcher_from_config(launcher)
            self._placement = elastic_mod.Placement(
                self._hosts, mode=placement)
        except ValueError as e:
            raise ServeError(str(e)) from None
        self.fleet_dir = tempfile.mkdtemp(prefix="srj_fd_")
        # the durable shuffle plane: fleet-shared, survives any worker;
        # store=False runs on lineage recovery alone
        self.store_dir: Optional[str] = None
        self._store: Optional[store_mod.ShuffleStore] = None
        if store:
            self.store_dir = os.path.abspath(
                store_dir or os.path.join(self.fleet_dir, "shuffle-store"))
            self._store = store_mod.ShuffleStore(self.store_dir)
        self.metrics = FleetMetrics()
        _last_metrics = self.metrics
        self._lock = threading.RLock()
        self._sids = itertools.count(1)
        self._gens = itertools.count(1)
        self._pending: List[list] = []   # [not_before, session]
        self._pins: Dict[object, int] = {}   # tenant -> worker slot
        self._workers: Dict[int, WorkerHandle] = {}
        self._respawn_count = dict.fromkeys(range(self._n_workers), 0)
        self._respawn_at: Dict[int, float] = {}
        self._broken: set = set()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._shutdown_started = False
        self._shutdown_done = threading.Event()
        self._shutdown_result: Optional[dict] = None
        self._self_fenced: List[dict] = []
        # worker spawn -> hello seconds, one per incarnation that attached
        self.hello_seconds: List[float] = []
        where = "127.0.0.1:0"
        if self._transport == "unix":
            where = os.path.join(self.fleet_dir, "frontdoor.sock")
            if len(where.encode()) > _UNIX_PATH_MAX:
                shutil.rmtree(self.fleet_dir, ignore_errors=True)
                raise ServeError(
                    f"the fleet socket path {where!r} is longer than a "
                    f"Unix socket allows ({_UNIX_PATH_MAX} bytes): set "
                    f"TMPDIR to a shorter directory or use "
                    f"serve_transport=tcp")
        try:
            self._listener, self._sock_addr = wire.listen(
                self._transport, where, backlog=self._n_workers * 2)
        except OSError:
            shutil.rmtree(self.fleet_dir, ignore_errors=True)
            raise
        self._listener.settimeout(0.2)
        # the write-ahead journal opens after the listener (its meta
        # record carries the live address)
        self._journal: Optional[journal_mod.SessionJournal] = None
        if bool(config.get("serve_journal")):
            self._journal = journal_mod.SessionJournal(
                journal_mod.journal_path(self.fleet_dir))
        self._jrec("meta", addr=self._sock_addr,
                   transport=self._transport, store_dir=self.store_dir,
                   n_workers=self._n_workers, hosts=list(self._hosts),
                   data_plane=self._data_plane)

        with self._lock:
            for slot in range(self._n_workers):
                self._spawn_locked(slot)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="frontdoor-accept", daemon=True)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="frontdoor-monitor", daemon=True)
        self._accept_thread.start()
        self._monitor_thread.start()

    # -- the write-ahead journal ------------------------------------------
    def _jrec(self, rec: str, **fields):
        """Append one write-ahead record before the matching in-memory
        mutation.  The supervisor-death faults (``supervisor_crash``,
        ``journal_torn``) would make this process a dead supervisor whose
        fleet a successor adopts: that recovery is ROADMAP item 16d.  A
        real journal I/O failure degrades to unjournaled operation."""
        j = self._journal
        if j is None or j.closed:
            return
        try:
            j.append(rec, **fields)
        except (faultinj.SupervisorCrash, faultinj.JournalTornError) as e:
            raise not_ported("FrontDoor crash adoption (a supervisor "
                             "death at the journal)", "16d") from e
        except OSError:
            pass

    def _simulate_crash(self):
        raise not_ported("FrontDoor._simulate_crash (crash adoption)",
                         "16d")

    def recovered(self):
        raise not_ported("FrontDoor.recovered (crash adoption)", "16d")

    # -- public API -----------------------------------------------------
    def submit(self, kind: str, params: Optional[dict] = None, tenant=None,
               priority: int = 0, est_bytes: int = 0,
               timeout_s: Optional[float] = None,
               replayable: bool = True, snapshot=None) -> FrontDoorSession:
        """Queue a query of registered worker-side ``kind`` and return
        its session.  ``params`` must be JSON-serializable; everything
        else matches ``ServeRuntime.submit`` plus ``replayable`` (see
        :class:`FrontDoorSession`).  ``snapshot`` (a result-cache key) is
        ROADMAP item 16d."""
        if snapshot is not None:
            # the cache is 16d: computing here what the reference would
            # have served from it would be a different result
            raise not_ported("FrontDoor.submit(snapshot=...) (the fleet "
                             "result cache)", "16d")
        # monotonic flag, re-checked under the lock by the drain
        if self._shutdown_started:
            raise ServeError("front door is shut down")
        sid = next(self._sids)
        sess = FrontDoorSession(
            self, sid, kind, params,
            tenant if tenant is not None else f"tenant-{sid}",
            priority, est_bytes, timeout_s, replayable)
        now = time.monotonic()
        with self._lock:
            # write-ahead: the admission is durable before it is queued
            self._jrec("submit", sid=sid, kind=kind, params=sess.params,
                       tenant=str(sess.tenant), priority=sess.priority,
                       est_bytes=sess.est_bytes,
                       timeout_s=sess.timeout_s,
                       replayable=sess.replayable,
                       snapshot=None)
            self._pending.append([now, sess])
            self._maybe_shed_locked()
            self._dispatch_locked(now)
        self._wake.set()
        return sess

    def cancel(self, sess: FrontDoorSession):
        """Cancel wherever the session is: pending (finished here),
        placed or running (forwarded to its worker, which unwinds it
        kill-safe and reports ``cancelled``)."""
        link = None
        with self._lock:
            if sess._done.is_set():
                return
            sess._cancel_requested = True
            if sess.worker_id is None:
                self._pending = [e for e in self._pending if e[1] is not sess]
                sess._finish(error=QueryCancelled(
                    f"session {sess.sid} cancelled while pending"),
                    status="cancelled")
                return
            w = self._workers.get(sess.worker_id)
            if w is not None and w.link is not None and w.state == "healthy":
                link = w.link
        # the forward crosses a process boundary: never under the lock
        if link is not None:
            with contextlib.suppress(OSError):
                link.send({"op": "cancel", "sid": sess.sid})

    def sessions(self) -> List[FrontDoorSession]:
        with self._lock:
            out = [e[1] for e in self._pending]
            for w in self._workers.values():
                out.extend(w.sessions.values())
            return out

    def worker_pids(self) -> Dict[int, int]:
        """Slot -> pid of every worker process not yet declared dead."""
        with self._lock:
            return {w.worker_id: w.proc.pid for w in self._workers.values()
                    if w.state != "dead"}

    def shutdown(self, timeout_s: float = 30.0) -> dict:
        """Drain the fleet: ``shutdown`` to every live worker (its runtime
        cancels in-flight sessions kill-safe and reports a ``bye`` with
        residue), SIGKILL for stragglers, reap every worker directory,
        remove the fleet directory.  Returns a report with per-worker
        cleanliness, fleet counters and any orphan spill files found
        before the reap.  Idempotent: later or racing calls wait for the
        first and return its report."""
        with self._lock:
            first = not self._shutdown_started
            self._shutdown_started = True
        if not first:
            self._shutdown_done.wait(timeout_s + 10.0)
            return self._shutdown_result or {"clean": False, "workers": {}}
        self._stop.set()
        self._wake.set()
        self._monitor_thread.join(timeout=10.0)
        with contextlib.suppress(OSError):
            self._listener.close()
        self._accept_thread.join(timeout=10.0)

        report: dict = {"clean": True, "workers": {}, "orphan_spill_files": []}
        with self._lock:
            pending = [e[1] for e in self._pending]
            self._pending = []
            workers = list(self._workers.values())
        for sess in pending:
            sess._finish(error=QueryCancelled(
                f"session {sess.sid} cancelled: front door shutdown",
                reason="shutdown"), status="cancelled")
        for w in workers:
            if w.state != "dead" and w.link is not None:
                with contextlib.suppress(OSError):
                    w.link.send({"op": "shutdown"})
        deadline = time.monotonic() + timeout_s
        for w in workers:
            entry: dict
            if w.state == "dead":
                entry = {"state": "dead", "clean": True}
            else:
                try:
                    w.proc.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    w.kill()
                    with contextlib.suppress(Exception):
                        w.proc.wait(5.0)
                    entry = {"state": "wedged", "clean": False}
                else:
                    # the bye races the exit: give the reader a bounded
                    # beat to drain it before classifying
                    grace = time.monotonic() + 2.0
                    while w.bye is None and time.monotonic() < grace:
                        time.sleep(0.01)
                    bye = w.bye or {}
                    residue = bye.get("residue") or [0, 0]
                    entry = {
                        "state": "ok" if bye else "no-bye",
                        "clean": bool(bye.get("clean")) and not any(residue)
                        and not bye.get("leftovers")
                        and not bye.get("store_len"),
                        "residue": residue,
                        "leftovers": bye.get("leftovers", []),
                    }
                self._merge_fired(w)
                w.state = "dead"
                self.metrics.set_liveness(w.worker_id, "shutdown")
            w.close()
            for sess in list(w.sessions.values()):
                sess._finish(error=QueryCancelled(
                    f"session {sess.sid} cancelled: front door shutdown",
                    reason="shutdown"), status="cancelled")
            w.sessions = {}
            entry["host"] = w.host
            entry["pid"] = w.proc.pid
            report["workers"][w.worker_id] = entry
            report["clean"] = report["clean"] and entry["clean"]
        # the zero-orphan-spill-files invariant, checked before the reap;
        # the store's subtree is excluded: its files outlive workers
        for root, dirs, files in os.walk(self.fleet_dir):
            if self.store_dir is not None:
                dirs[:] = [d for d in dirs
                           if os.path.join(root, d) != self.store_dir]
            for f in files:
                if "spill" in root.split(os.sep)[-1:] or f.endswith(".spill"):
                    report["orphan_spill_files"].append(
                        os.path.join(root, f))
        report["clean"] = report["clean"] and not report["orphan_spill_files"]
        report["fleet"] = self.metrics.snapshot()
        report["transport"] = self._transport
        fleet = report["fleet"]
        report["data_plane"] = {
            "plane": self._data_plane,
            "segment_bytes": self._segment_bytes,
            "batches": fleet["data_batches"],
            "payload_bytes": fleet["data_payload_bytes"],
            "json_bytes": fleet["data_json_bytes"],
            "errors": fleet["data_plane_errors"],
        }
        report["hosts"] = list(self._hosts)
        report["self_fenced"] = list(self._self_fenced)
        report["launcher"] = getattr(self._launcher, "name", "local")
        self._launcher.close()
        report["placement"] = self._placement.mode
        if self._store is not None:
            report["store"] = self._store.snapshot()
        if self._journal is not None:
            report["journal_appends"] = self._journal.appended
            self._journal.close()
        retain = self.store_dir is not None \
            and bool(config.get("shuffle_store_retain"))
        if retain and self.store_dir.startswith(self.fleet_dir + os.sep):
            # retain only the store: reap every other fleet entry
            for entry in os.listdir(self.fleet_dir):
                p = os.path.join(self.fleet_dir, entry)
                if p == self.store_dir:
                    continue
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    with contextlib.suppress(OSError):
                        os.unlink(p)
        else:
            # the store dies with the fleet dir; an external store_dir=
            # is never reaped (the front door does not own it)
            shutil.rmtree(self.fleet_dir, ignore_errors=True)
        self._shutdown_result = report
        self._shutdown_done.set()
        return report

    # -- spawning -------------------------------------------------------
    def _child_fault_config(self) -> Optional[dict]:
        """The live fault schedule, each rule's count less the firings
        already merged from the fleet, so a respawned replacement does
        not re-arm a fault the fleet already absorbed."""
        cfg = faultinj.current_config()
        if not cfg.get("faults"):
            return None
        fired = faultinj.fired_log()
        out = []
        for spec in cfg["faults"]:
            spec = dict(spec)
            cnt = spec.get("count")
            if cnt is not None:
                used = sum(
                    1 for e in fired
                    if e.get("match") == spec.get("match", "*")
                    and e.get("fault") == spec.get("fault", "exception"))
                left = int(cnt) - used
                if left <= 0:
                    continue
                spec["count"] = left
            out.append(spec)
        if not out:
            return None
        return {"seed": cfg.get("seed", 0), "faults": out}

    def _spawn_locked(self, slot: int) -> Optional[WorkerHandle]:
        gen = next(self._gens)
        wdir = os.path.join(self.fleet_dir, f"worker-{slot}-{gen}")
        os.makedirs(wdir, exist_ok=True)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        fault_cfg = self._child_fault_config()
        if fault_cfg is not None:
            cfg_path = os.path.join(wdir, "fault.json")
            with open(cfg_path, "w") as f:
                json.dump(fault_cfg, f)
            env[faultinj.ENV_CONFIG] = cfg_path
        else:
            # the live schedule is authoritative: no stale inherited one
            env.pop(faultinj.ENV_CONFIG, None)
        env[faultinj.ENV_MIRROR] = os.path.join(wdir, "fired.jsonl")
        host = self._placement.host_for_slot(slot, self._workers.values())
        token = f"{slot}-{gen}-{os.urandom(8).hex()}"
        cmd = [sys.executable, "-m", "spark_rapids_jni_tpu_torch.serve.worker",
               "--socket", self._sock_addr,
               "--transport", self._transport,
               "--worker-id", str(slot),
               "--dir", wdir,
               "--device", str(self.device),
               "--host", host,
               "--resume-token", token,
               "--partition-grace-ms", str(self._grace_s * 1000.0),
               "--orphan-grace-ms",
               str(float(config.get("serve_orphan_grace_ms"))),
               "--reconnect-max", str(self._reconnect_max),
               "--pool-bytes", str(self._pool_bytes),
               "--host-pool-bytes", str(self._host_pool_bytes),
               "--max-concurrent", str(self._max_concurrent),
               "--task-id-base", str(10_000 + slot * 1_000),
               "--data-plane", self._data_plane,
               "--segment-bytes", str(self._segment_bytes)]
        # the gen is the store's fencing epoch and the hello's
        # fence_epoch: this incarnation's commits are revocable the moment
        # it is declared lost, and an attach claiming another is refused
        cmd += ["--epoch", str(gen)]
        if self.store_dir is not None:
            cmd += ["--store-dir", self.store_dir]
        if self._setup:
            cmd += ["--setup", self._setup]
        # a launch that dies at the boundary is a capacity loss, not a
        # crash: count it and keep the slot on the respawn ladder
        try:
            proc = self._launcher.launch(
                cmd, cwd=pkg_root, env=env,
                log_path=os.path.join(wdir, "worker.log"))
        except OSError:
            self.metrics.bump("scale_up_failures")
            self.metrics.set_liveness(slot, "spawn-failed")
            shutil.rmtree(wdir, ignore_errors=True)
            self._respawn_count[slot] = \
                self._respawn_count.get(slot, 0) + 1
            if self._respawn_count[slot] > self._respawn_max:
                self._broken.add(slot)
                self.metrics.bump("circuit_open")
                self.metrics.set_liveness(slot, "broken")
            else:
                delay = max(self._backoff_s, 0.05) * (
                    2 ** (self._respawn_count[slot] - 1))
                self._respawn_at[slot] = time.monotonic() + delay
            return None
        w = WorkerHandle(slot, gen, wdir, proc, host=host, token=token)
        w.pool_bytes = self._pool_bytes
        # write-ahead fleet fact: the incarnation exists (pid, resume
        # token, fencing epoch) before the fleet table says so
        self._jrec("spawn", slot=slot, gen=gen,
                   pid=int(getattr(proc, "pid", 0) or 0), token=token,
                   host=host, wdir=wdir)
        self._workers[slot] = w
        self.metrics.bump("workers_spawned")
        self.metrics.set_liveness(slot, "starting")
        return w

    # -- accept/reader threads ------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            link = wire.wrap(conn, self._transport, role="sup")
            try:
                link.settimeout(5.0)
                hello = link.recv()
                slot = int(hello.get("worker_id", -1))
                pid = hello.get("pid")
                token = hello.get("resume_token", "")
                epoch = int(hello.get("fence_epoch", -1))
            except (wire.WireError, socket.timeout, OSError, ValueError):
                link.close()
                continue
            with self._lock:
                w = self._workers.get(slot)
                # pid identity through the launch handle: a local worker
                # presents the child's pid, a remote one has its first
                # hello's pid adopted and held
                if w is None or w.state == "dead" \
                        or not w.proc.owns_pid(pid) \
                        or w.token != token or w.gen != epoch:
                    # a stale incarnation, or a token / epoch that is not
                    # the slot's live generation: only the incarnation
                    # spawned may attach to these sessions
                    link.close()
                    continue
                if w.ever_connected:
                    # the same incarnation re-dialled after a link loss
                    self.metrics.bump("reconnects")
                else:
                    self.hello_seconds.append(
                        time.monotonic() - w.spawned_at)
                w.ever_connected = True
                link.settimeout(0.2)  # the reader's poll tick
                old, w.link = w.link, link
                if old is not None:
                    old.close()
                w.state = "healthy"
                w.last_pong = time.monotonic()
                self.metrics.set_liveness(slot, "healthy")
                # at-least-once re-delivery: re-send every placed-but-
                # unacked session (the worker dedups by sid); payloads
                # captured under the lock, sent after it
                resend = [
                    {"op": "submit", "sid": sess.sid,
                     "kind": sess.kind, "params": sess.params,
                     "tenant": str(sess.tenant),
                     "priority": sess.priority,
                     "est_bytes": sess.est_bytes,
                     "timeout_s": sess.timeout_s,
                     "snapshot": None}
                    for sess in list(w.sessions.values())
                    if sess.status == "placed" and not sess._done.is_set()]
                # a cancel issued while the link was down is re-forwarded
                recancel = [sess.sid for sess in list(w.sessions.values())
                            if sess._cancel_requested
                            and not sess._done.is_set()]
                # sids the worker holds that this supervisor no longer
                # tracks are cancelled worker-side
                stale_sids = [int(s) for s in
                              (hello.get("active_sids") or [])
                              if int(s) not in w.sessions]
                reader_name = f"frontdoor-reader-{slot}-{w.gen}"
            for payload in resend:
                try:
                    link.send(payload)
                except OSError:
                    break  # the link died again: the next reattach retries
            for sid in stale_sids + recancel:
                with contextlib.suppress(OSError):
                    link.send({"op": "cancel", "sid": sid})
            threading.Thread(
                target=self._reader, args=(w, link),
                name=reader_name, daemon=True).start()
            self._wake.set()

    def _reader(self, w: WorkerHandle, link: wire.Transport):
        while True:
            if w.link is not link:
                return  # superseded by a reattached connection
            try:
                msg = link.recv()
            except socket.timeout:
                continue
            except (wire.WireError, OSError, ValueError):
                # the CONNECTION died, not necessarily the worker
                self._on_conn_lost(w, link)
                return
            if isinstance(msg, wire.DataChunk):
                # frames plane: stash the chunk for its descriptor
                with self._lock:
                    w.data_stash.setdefault(msg.sid, []).append(
                        (msg.seq, msg.payload))
                continue
            op = msg.get("op")
            if op == "pong":
                self._on_pong(w, msg)
            elif op == "running":
                with self._lock:
                    sess = w.sessions.get(int(msg.get("sid", -1)))
                    if sess is not None and not sess._done.is_set():
                        self._jrec("running", sid=sess.sid)
                        sess.status = "running"
            elif op == "result":
                self._on_result(w, msg)
            elif op == "bye":
                w.bye = msg
                w.fired = list(msg.get("fired") or [])
                w.last_pong = time.monotonic()

    def _on_conn_lost(self, w: WorkerHandle, link: wire.Transport):
        """The link died but the process may be fine: park the slot in
        ``reconnecting``; only the monitor's partition window escalates
        to the loss protocol."""
        link.close()
        with self._lock:
            if w.link is link:
                w.link = None
                if w.state == "healthy":
                    w.state = "reconnecting"
                    w.conn_lost_at = time.monotonic()
                    self.metrics.set_liveness(w.worker_id, "reconnecting")
        self._wake.set()

    def _on_pong(self, w: WorkerHandle, msg: dict):
        with self._lock:
            w.last_pong = time.monotonic()
            w.fired = list(msg.get("fired") or [])
            w.queue_depth = int(msg.get("queue_depth") or 0)
            w.arena_bytes = int(msg.get("arena_bytes") or 0)
            w.pool_bytes = int(msg.get("pool_bytes") or w.pool_bytes or 0)
            epoch = int(msg.get("stall_breaks") or 0)
            live = int(msg.get("live_sessions") or 0)
            # an epoch that keeps climbing while nothing completes: the
            # breaker fires but the worker does not recover
            if epoch > w.stall_breaks and live > 0 \
                    and w.results_since_pong == 0:
                w.stall_suspect += 1
            else:
                w.stall_suspect = 0
            w.stall_breaks = epoch
            w.results_since_pong = 0

    def _rebuild_error(self, msg: dict) -> BaseException:
        err = msg.get("error") or "ServeError"
        text = msg.get("message") or ""
        if err == "QueryCancelled":
            return QueryCancelled(text)
        if err == "QueryTimeout":
            return QueryTimeout(text)
        for cls in (faultinj.TaskCancelled, faultinj.InjectedFault,
                    faultinj.FatalInjectedFault, faultinj.WorkerCrash,
                    faultinj.WorkerStalled):
            if err == cls.__name__:
                return cls(text)
        if err in ("RetryOOM", "CpuRetryOOM", "SplitAndRetryOOM"):
            from ..mem import RetryOOM
            return RetryOOM(text)
        if err == "DataPlaneOverflow":
            return data_plane.DataPlaneOverflow(text)
        return ServeError(f"{err}: {text}")

    def _decode_data_result(self, w: WorkerHandle, desc: dict,
                            chunks: Optional[list], fds: List[int]):
        """Verify (epoch, then every chunk CRC) and decode one data-plane
        payload onto :attr:`device`.  Raises :class:`~.data_plane.
        DataPlaneStale` / :class:`~.data_plane.DataPlaneCorruption`: the
        transfer failed, not the query."""
        from ..columnar import arrow_ipc

        # epoch before bytes: a stale generation's segment is rejected
        # before anything in it is read
        data_plane.verify_epoch(desc, w.gen)
        plane = desc.get("plane")
        if plane == "shm":
            if not fds:
                raise wire.WireError(
                    f"shm descriptor for segment {desc.get('seg')} "
                    f"arrived without its fd")
            payload = data_plane.read_segment(fds[0], desc)
        elif plane == "frames":
            parts = sorted(chunks or [], key=lambda e: e[0])
            payload = b"".join(p for _seq, p in parts)
            data_plane.verify_chunks(payload, desc)
        elif plane == "json":
            payload = data_plane.decode_json_payload(
                desc.get("inline") or "")
            data_plane.verify_chunks(payload, desc)
        else:
            raise wire.WireError(f"unknown data plane {plane!r} in "
                                 f"result descriptor")
        return arrow_ipc.ipc_to_batch(
            payload, expect_fingerprint=desc.get("schema_fp"),
            device=self.device)

    def _requeue_data_damaged(self, sess: FrontDoorSession, w: WorkerHandle,
                              exc: BaseException):
        """A transfer was damaged (torn payload, stale segment, missing
        fd): the query succeeded, the hop failed.  Re-run it under a
        FRESH sid (the worker dedups by sid) within the same bounded
        budget; a non-replayable query fails loudly."""
        self.metrics.bump("data_plane_errors")
        with self._lock:
            sess.data_retries += 1
            if not sess.replayable or sess.data_retries > self._replace_max:
                sess._finish(error=exc, status="failed")
                return
            new_sid = next(self._sids)
            self._jrec("requeued", sid=sess.sid, new_sid=new_sid)
            sess.sid = new_sid
            sess.status = "pending"
            sess.worker_id = None
            self._pending.append(
                [time.monotonic() + self._backoff_s
                 * (2 ** (sess.data_retries - 1)), sess])
            self._dispatch_locked(time.monotonic())
        self._wake.set()

    def _on_result(self, w: WorkerHandle, msg: dict):
        sid = int(msg.get("sid", -1))
        desc = msg.get("data")
        with self._lock:
            sess = w.sessions.pop(sid, None)
            w.results_since_pong += 1
            w.stall_suspect = 0
            chunks = w.data_stash.pop(sid, None)
        # the fd rides the descriptor frame: claim it even for a
        # deduplicated re-delivery, or the stash misaligns
        fds: List[int] = []
        if desc is not None and desc.get("plane") == "shm":
            link = w.link
            if link is not None:
                with contextlib.suppress(wire.WireError):
                    fds = link.take_fds(int(desc.get("fds", 1)))
        try:
            if sess is None:
                return
            if msg.get("ok"):
                if desc is not None:
                    try:
                        value = self._decode_data_result(w, desc, chunks,
                                                         fds)
                    except (data_plane.DataPlaneStale,
                            data_plane.DataPlaneCorruption,
                            wire.WireError, ValueError, OSError) as e:
                        self._requeue_data_damaged(sess, w, e)
                        return
                    self.metrics.bump("data_batches")
                    self.metrics.bump("data_payload_bytes",
                                      int(desc.get("size") or 0))
                    self.metrics.bump("data_json_bytes", len(json.dumps(
                        msg, separators=(",", ":"))))
                    sess._finish(value=value, status="done")
                else:
                    sess._finish(value=msg.get("value"), status="done")
            else:
                status = msg.get("status") or "failed"
                sess._finish(error=self._rebuild_error(msg),
                             status=status if status in
                             ("cancelled", "timeout", "failed") else "failed")
        finally:
            for fd in fds:
                with contextlib.suppress(OSError):
                    os.close(fd)
        self._wake.set()

    # -- monitor loop ---------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.is_set():
            self._wake.wait(self._hb_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            now = time.monotonic()
            to_ping = []
            with self._lock:
                for w in list(self._workers.values()):
                    if w.state == "dead":
                        continue
                    if w.proc.poll() is not None:
                        self._on_worker_lost_locked(
                            w, f"exited rc={w.proc.returncode}",
                            "crashes", now)
                        continue
                    if w.state == "healthy":
                        if w.link is not None:
                            to_ping.append(w.link)
                        if now - w.last_pong > self._hb_s * _MISS_BUDGET:
                            w.kill()
                            self._on_worker_lost_locked(
                                w, "missed heartbeats", "stalls", now)
                            continue
                        if w.stall_suspect >= _STALL_EPOCH_LIMIT:
                            w.kill()
                            self._on_worker_lost_locked(
                                w, "stall epoch climbing without progress",
                                "stalls", now)
                            continue
                    elif w.state == "reconnecting":
                        # wait out the worker's reconnect ladder; a link
                        # silent past the partition grace IS a partition
                        if now - w.conn_lost_at > \
                                self._grace_s + self._hb_s * _MISS_BUDGET:
                            w.kill()
                            self._on_worker_lost_locked(
                                w, "connection lost past the partition "
                                "grace", "partitions_detected", now)
                    elif now - w.spawned_at > _STARTUP_GRACE_S:
                        w.kill()
                        self._on_worker_lost_locked(
                            w, "never connected", "crashes", now)
                self._maybe_respawn_locked(now)
                self._maybe_shed_locked()
                self._dispatch_locked(now)
            # pings cross process boundaries: sent after the lock drops
            for link in to_ping:
                with contextlib.suppress(OSError):
                    link.send({"op": "ping", "t": now})

    def _merge_fired(self, w: WorkerHandle):
        """Merge the worker's injection trace into this process's log:
        the durable mirror file first (it survives SIGKILL), the last
        pong's copy as the fallback."""
        if w.merged:
            return
        w.merged = True
        entries: List[dict] = []
        mirror = os.path.join(w.dir, "fired.jsonl")
        try:
            with open(mirror) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        with contextlib.suppress(ValueError):
                            entries.append(json.loads(line))
        except OSError:
            entries = list(w.fired)
        if entries:
            faultinj.record_external(
                entries, source=f"worker-{w.worker_id}-{w.gen}")
            w.fired = entries

    def _on_worker_lost_locked(self, w: WorkerHandle, why: str,
                               kind: str, now: float):
        self._jrec("loss", slot=w.worker_id, gen=w.gen, why=why)
        w.state = "dead"
        self.metrics.bump(kind)
        self.metrics.set_liveness(w.worker_id, "dead")
        w.close()
        self._merge_fired(w)
        fired = list(w.fired)
        # a self-fence sentinel: the worker saw the partition from its
        # side and already revoked its own epoch
        sentinel = None
        with contextlib.suppress(OSError, ValueError):
            with open(os.path.join(w.dir, "self-fenced.json")) as f:
                sentinel = json.load(f)
        if sentinel is not None:
            self.metrics.bump("self_fenced_workers")
            self._self_fenced.append(sentinel)
            if kind != "partitions_detected":
                self.metrics.bump("partitions_detected")
        # fence the dead generation FIRST (a zombie can outlive its
        # SIGKILL verdict and must never commit late), then reap only
        # its uncommitted entries: the committed shards are what the
        # replacement adopts
        if self._store is not None:
            self._jrec("revoke", gen=w.gen)
            with contextlib.suppress(OSError):
                self._store.fence_handoff([w.gen], 0)
        shutil.rmtree(w.dir, ignore_errors=True)
        # re-place what never ran (or is replayable) through the bounded
        # backoff ladder; fail the rest
        for sess in list(w.sessions.values()):
            if sess._done.is_set():
                continue
            if sess._cancel_requested:
                sess._finish(error=QueryCancelled(
                    f"session {sess.sid} cancelled (worker "
                    f"{w.worker_id} lost mid-cancel)"), status="cancelled")
            elif (sess.status != "running" or sess.replayable) \
                    and sess.replacements < self._replace_max:
                sess.replacements += 1
                self.metrics.bump("replacements")
                self._jrec("requeued", sid=sess.sid)
                sess.status = "pending"
                sess.worker_id = None
                not_before = now + self._backoff_s * (
                    2 ** (sess.replacements - 1))
                self._pending.append([not_before, sess])
            else:
                self.metrics.bump("worker_lost")
                budget = "" if sess.status != "running" or sess.replayable \
                    else " (in flight, not replayable)"
                sess._finish(error=WorkerLost(
                    f"session {sess.sid} lost with worker {w.worker_id} "
                    f"({why}){budget or ' (re-placement budget exhausted)'}",
                    worker_id=w.worker_id, fired_log=fired))
        w.sessions = {}
        # partial chunk stashes die with the worker; unclaimed segment
        # fds were closed with the transport above
        w.data_stash = {}
        # the pins kept its tenants' spill residency and plans in one
        # process; both died with it, so its tenants (their re-placed
        # sessions first) go wherever placement finds room, not to wait
        # for the respawn
        self._pins = {t: s for t, s in self._pins.items()
                      if s != w.worker_id}
        if w.worker_id in self._broken:
            return
        self._respawn_count[w.worker_id] = \
            self._respawn_count.get(w.worker_id, 0) + 1
        if self._respawn_count[w.worker_id] > self._respawn_max:
            self._broken.add(w.worker_id)
            self.metrics.bump("circuit_open")
            self.metrics.set_liveness(w.worker_id, "broken")
        else:
            delay = max(self._backoff_s, 0.05) * (
                2 ** (self._respawn_count[w.worker_id] - 1))
            self._respawn_at[w.worker_id] = now + delay

    def _maybe_respawn_locked(self, now: float):
        for slot, due in list(self._respawn_at.items()):
            if now < due or self._shutdown_started:
                continue
            del self._respawn_at[slot]
            w = self._workers.get(slot)
            if w is not None and w.state != "dead":
                continue
            self.metrics.bump("respawns")
            self._spawn_locked(slot)

    def _alive_workers(self) -> List[WorkerHandle]:
        return [w for w in self._workers.values()
                if w.state in ("starting", "healthy")]

    def _maybe_shed_locked(self):
        alive = self._alive_workers()
        if self._n_workers <= 0 \
                or len(alive) / self._n_workers >= self._shed_threshold:
            return
        if not alive and not self._respawn_at:
            return  # fleet exhausted: dispatch fails pending WorkerLost
        cap = max(1, len(alive)) * self._max_concurrent
        while len(self._pending) > cap:
            # lowest priority class first; latest arrival within a class
            victim = min(self._pending,
                         key=lambda e: (e[1].priority, -e[1].sid))
            self._pending.remove(victim)
            sess = victim[1]
            self.metrics.bump("sheds")
            sess._finish(error=AdmissionShed(
                f"session {sess.sid} shed: {len(alive)}/{self._n_workers} "
                f"workers alive (< serve_shed_threshold="
                f"{self._shed_threshold:g})"), status="shed")

    def _pick_worker_locked(self, sess: FrontDoorSession
                            ) -> Optional[WorkerHandle]:
        healthy = [w for w in self._workers.values()
                   if w.state == "healthy" and w.link is not None
                   and len(w.sessions) < self._max_concurrent]
        if not healthy:
            return None
        pin = self._pins.get(sess.tenant)
        if pin is not None:
            for w in healthy:
                if w.worker_id == pin:
                    return w
            pinned = self._workers.get(pin)
            if pinned is not None and pinned.state != "dead" \
                    and pin not in self._broken:
                return None  # the pinned worker is alive but full: wait
        w = self._placement.pick(healthy)
        if w is None:
            return None
        self._pins[sess.tenant] = w.worker_id
        return w

    def _dispatch_locked(self, now: float):
        if self._shutdown_started:
            return
        # fleet exhausted?  No alive worker and none ever coming back (a
        # slot in "reconnecting" is a live worker behind a downed link)
        if not self._alive_workers() and not self._respawn_at \
                and not any(w.state == "reconnecting"
                            for w in self._workers.values()):
            for _nb, sess in self._pending:
                self.metrics.bump("worker_lost")
                sess._finish(error=WorkerLost(
                    f"session {sess.sid}: no healthy workers and the "
                    f"respawn circuit breaker is open"))
            self._pending = []
            return
        still: List[list] = []
        for entry in sorted(self._pending,
                            key=lambda e: (-e[1].priority, e[1].sid)):
            not_before, sess = entry
            if sess._done.is_set():
                continue
            if now < not_before:
                still.append(entry)
                continue
            w = self._pick_worker_locked(sess)
            if w is None:
                still.append(entry)
                continue
            # write-ahead: the placement is durable before the send
            self._jrec("placed", sid=sess.sid, slot=w.worker_id,
                       gen=w.gen)
            try:
                w.link.send({
                    "op": "submit", "sid": sess.sid, "kind": sess.kind,
                    "params": sess.params, "tenant": str(sess.tenant),
                    "priority": sess.priority, "est_bytes": sess.est_bytes,
                    "timeout_s": sess.timeout_s,
                    "snapshot": None,
                })
            except OSError:
                # the worker is dying under us: the monitor's loss
                # protocol re-routes the session
                still.append(entry)
                continue
            w.sessions[sess.sid] = sess
            sess.worker_id = w.worker_id
            sess.status = "placed"
        self._pending = still
