"""Fault injection at the port's instrumented boundaries.

Counterpart of ``spark_rapids_jni_tpu/faultinj.py`` (itself the analogue
of the CUPTI injector, ``faultinj/faultinj.cu:84-137``): a JSON schedule
names instrumented call sites by fnmatch pattern and fires a fault kind
at them, with a probability, a count and a skip.

* config: JSON at ``SPARK_RAPIDS_TPU_FAULT_CONFIG`` (or passed directly)::

      {"seed": 42, "dynamic": true,
       "faults": [{"match": "spill_io_*", "count": 1,
                   "fault": "spill_io"},
                  {"match": "*", "count": 2, "skip": 1,
                   "fault": "oom"}]}

  ``match`` is an fnmatch pattern on the instrumented name; ``count``
  limits firings (omit for unlimited); ``probability`` defaults to 1;
  ``skip`` passes over the first N matching occurrences, which pins a
  firing to an exact occurrence.
* kinds: ``"exception"`` raises :class:`InjectedFault`, ``"oom"`` the
  port's :class:`~.mem.RetryOOM`, ``"fatal"`` :class:`FatalInjectedFault`,
  ``"spill_io"`` :class:`SpillIOError` at the spill store's disk
  boundary (``spill_io_write``/``spill_io_read``), ``"spill_corrupt"``
  :class:`SpillCorruptionError` at its post-write probe
  (``spill_corrupt_file``; the store flips bytes in the file it just
  wrote), ``"host_corrupt"`` :class:`HostCorruptionError` at its
  post-demotion probe (``host_corrupt_probe``; the store flips bytes in
  the host copy it just made); ``"shuffle_io"`` :class:`ShuffleIOError`
  at the exchange's per-round probe (``shuffle_io_round``; the round is
  re-driven from its buffers); ``"store_commit"`` :class:`StoreCommitError`
  at the shuffle store's pre-rename probe (``store_commit``; the write
  is torn) and ``"store_corrupt"`` :class:`StoreCorruptionError` at its
  post-commit probe (``store_corrupt_file``; the store flips bytes in a
  chunk it just committed); ``"task_cancel"`` :class:`TaskCancelled`
  at any boundary (the serving runtime unwinds the session as if
  cancelled); ``"net_drop"``/``"net_stall"``/``"net_torn"`` at a
  transport's ``net_send_<role>``/``net_recv_<role>`` probes (the
  transport turns each into real wire damage); ``"shm_torn"`` and
  ``"shm_stale"`` for the data plane; ``"supervisor_crash"`` and
  ``"journal_torn"`` at the session journal's probes.  The reference's
  other kinds belong to paths the port does not carry yet: a rule
  naming one raises ``not_ported`` with the ROADMAP item that brings
  it (:data:`UNPORTED_KINDS`), an unknown kind ``ValueError``.
* ``dynamic: true`` re-reads the file when its mtime changes.

Observability (reset by :func:`configure` / :func:`reset_stats`):
:func:`check_counts` counts every screening per name (the occurrence
clock ``skip`` indexes into), :func:`fire_counts` the injections per
name, :func:`fired_log` the ordered trace ``{"seq", "name", "fault",
"match", "occurrence"}``.  :func:`scope` applies a config for a ``with``
block and restores the previous rules on exit.  :func:`current_config`
returns the live schedule; ``SPARK_RAPIDS_TPU_FAULT_MIRROR`` names a
file every firing is appended to (one JSON line) before its raiser runs.
"""

from __future__ import annotations

import contextlib
import fnmatch
import functools
import json
import os
import random
import threading
from typing import Dict, List, Optional, Union

from ._roadmap import not_ported

ENV_CONFIG = "SPARK_RAPIDS_TPU_FAULT_CONFIG"
ENV_MIRROR = "SPARK_RAPIDS_TPU_FAULT_MIRROR"


class InjectedFault(RuntimeError):
    """Retryable injected failure (the injected-CudfException analogue)."""


class FatalInjectedFault(RuntimeError):
    """Fatal injected failure (the device trap/assert analogue)."""


class SpillIOError(OSError):
    """Injected spill-path disk failure (kind ``"spill_io"``): an
    :class:`OSError`, so the spill store handles injected and real disk
    faults alike (the batch stays in the higher tier)."""


class SpillCorruptionError(OSError):
    """Spilled data came back wrong or not at all (kind
    ``"spill_corrupt"``): raised by the injector at the post-write probe,
    and by the spill store when a read-back fails verification and the
    handle has no ``recompute=`` lineage."""


class HostCorruptionError(SpillCorruptionError):
    """The host-tier copy of a spilled batch was damaged (kind
    ``"host_corrupt"``): raised by the injector at the post-demotion
    probe, and by the store when promotion fails the demotion-time
    CRC32."""


class ShuffleIOError(OSError):
    """Injected shuffle transport failure (kind ``"shuffle_io"``): raised
    at the exchange's per-round probe; the exchange re-drives the round
    from its buffers (nothing was consumed) and counts
    ``io_failures``."""


class StoreCommitError(OSError):
    """The shuffle store's commit failed (kind ``"store_commit"``):
    raised at the store's pre-rename probe, after the tmp entry is fully
    written and fsync'd.  The store tears the write (removes the
    manifest), counts a ``commit_failures`` and reports the put as
    failed; the caller keeps its in-memory copy."""


class StoreCorruptionError(OSError):
    """A committed shuffle-store entry was damaged (kind
    ``"store_corrupt"``): raised by the injector at the store's
    post-commit probe (the store then flips bytes in a chunk it just
    committed), and by the store when adoption finds a manifest missing
    or unreadable or a leaf failing its CRC32/length check; adoption
    quarantines the entry and falls back to the next attempt or to the
    caller's lineage."""


class TaskCancelled(RuntimeError):
    """Injected tenant kill (kind ``"task_cancel"``): the serving runtime
    (``serve/runtime.py``) treats it exactly like an external
    ``ServeRuntime.cancel()`` arriving at that boundary: the session
    unwinds kill-safe (arena drained, spill files deleted, plan-cache
    pins released) and reports itself cancelled."""


class NetDropError(ConnectionError):
    """The link dropped (kind ``"net_drop"``), raised at a transport's
    ``net_send_<role>``/``net_recv_<role>`` probe (serve/wire.py); the
    transport turns it into a real closed socket."""


class NetStallError(OSError):
    """The link stalled (kind ``"net_stall"``): the transport sleeps past
    its frame deadline, then drops the connection like ``net_drop``."""


class NetTornError(ConnectionError):
    """A frame tore on the wire (kind ``"net_torn"``): on send the
    transport writes the header and half the payload and closes; on recv
    the frame already read is discarded and the link closed."""


class ShmTornError(OSError):
    """A data-plane payload tore after its CRC stamp (kind
    ``"shm_torn"``): the writer flips bytes in the already-stamped
    segment, and the reader's per-chunk CRC check must catch it."""


class ShmStaleError(OSError):
    """A prior generation's segment resurfaced (kind ``"shm_stale"``):
    the writer stamps the descriptor with the previous fence epoch, and
    the reader's epoch check must reject it."""


class SupervisorCrash(RuntimeError):
    """The supervisor died abruptly (kind ``"supervisor_crash"``), raised
    at the session journal's ``journal_append``/``journal_replay`` probes
    (serve/journal.py) before the record is written or folded."""


class JournalTornError(OSError):
    """The journal record just appended tore (kind ``"journal_torn"``):
    the journal truncates the tail of the record it just wrote, before
    any fsync, then re-raises, because a torn tail exists only when the
    writer died mid-write."""


def _raise_exception(name: str):
    raise InjectedFault(f"injected exception at {name}")


def _raise_oom(name: str):
    from .mem.rmm_spark import RetryOOM

    raise RetryOOM(f"injected OOM at {name}")


def _raise_fatal(name: str):
    raise FatalInjectedFault(f"injected fatal fault at {name}")


def _raise_spill_io(name: str):
    raise SpillIOError(f"injected spill I/O fault at {name}")


def _raise_spill_corrupt(name: str):
    raise SpillCorruptionError(f"injected spill corruption at {name}")


def _raise_host_corrupt(name: str):
    raise HostCorruptionError(f"injected host-tier corruption at {name}")


def _raise_shuffle_io(name: str):
    raise ShuffleIOError(f"injected shuffle I/O fault at {name}")


def _raise_store_commit(name: str):
    raise StoreCommitError(f"injected store commit fault at {name}")


def _raise_store_corrupt(name: str):
    raise StoreCorruptionError(f"injected store corruption at {name}")


def _raise_task_cancel(name: str):
    raise TaskCancelled(f"injected task cancel at {name}")


def _raise_net_drop(name: str):
    raise NetDropError(f"injected link drop at {name}")


def _raise_net_stall(name: str):
    raise NetStallError(f"injected link stall at {name}")


def _raise_net_torn(name: str):
    raise NetTornError(f"injected torn frame at {name}")


def _raise_shm_torn(name: str):
    raise ShmTornError(f"injected torn shared-memory payload at {name}")


def _raise_shm_stale(name: str):
    raise ShmStaleError(f"injected stale segment descriptor at {name}")


def _raise_supervisor_crash(name: str):
    raise SupervisorCrash(f"injected supervisor crash at {name}")


def _raise_journal_torn(name: str):
    raise JournalTornError(f"injected torn journal record at {name}")


FAULT_KINDS = {
    "exception": _raise_exception,
    "oom": _raise_oom,
    "fatal": _raise_fatal,
    "spill_io": _raise_spill_io,
    "shuffle_io": _raise_shuffle_io,
    "spill_corrupt": _raise_spill_corrupt,
    "host_corrupt": _raise_host_corrupt,
    "store_commit": _raise_store_commit,
    "store_corrupt": _raise_store_corrupt,
    "task_cancel": _raise_task_cancel,
    "net_drop": _raise_net_drop,
    "net_stall": _raise_net_stall,
    "net_torn": _raise_net_torn,
    "shm_torn": _raise_shm_torn,
    "shm_stale": _raise_shm_stale,
    "supervisor_crash": _raise_supervisor_crash,
    "journal_torn": _raise_journal_torn,
}

# the reference's kinds whose paths the port does not carry yet, each
# with the ROADMAP item that brings its path
UNPORTED_KINDS = {
    "worker_crash": 16, "worker_stall": 16, "cache_stale": 16,
    "cache_corrupt": 16, "scale_up_fail": 16, "drain_stuck": 16,
    "zone_map_corrupt": 17,
}


class _Rule:
    def __init__(self, spec: dict):
        # the original spec survives so current_config() can re-export it
        self.spec = dict(spec)
        self.match = spec.get("match", "*")
        self.probability = float(spec.get("probability", 1.0))
        self.count = spec.get("count")  # None = unlimited
        self.skip = int(spec.get("skip", 0))
        if self.skip < 0:
            raise ValueError(f"skip must be >= 0, got {self.skip}")
        self.fault = spec.get("fault", "exception")
        if self.fault in UNPORTED_KINDS:
            raise not_ported(f"fault kind {self.fault}",
                             UNPORTED_KINDS[self.fault])
        if self.fault not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.fault!r}; known: "
                             f"{sorted(FAULT_KINDS)}")
        self.remaining = None if self.count is None else int(self.count)
        self.skip_remaining = self.skip

    def applies(self, name: str) -> bool:
        return fnmatch.fnmatchcase(name, self.match)


class _Injector:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list = []
        self._rng = random.Random(0)
        self._path: Optional[str] = None
        self._mtime: float = 0.0
        self._dynamic = False
        self._seed = 0
        # per-fire mirror, opened lazily O_APPEND: a line is on disk
        # before the raiser runs
        self._mirror_path: Optional[str] = os.environ.get(ENV_MIRROR)
        self._mirror_fd: Optional[int] = None
        self._checks: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._log: List[dict] = []
        self._seq = 0

    def _reset_stats_locked(self):
        self._checks = {}
        self._fired = {}
        self._log = []
        self._seq = 0

    def configure(self, config: Union[None, str, dict] = None):
        """Load config from a dict, a path, or the env var.  Every
        (re)configuration resets the counters and the trace; all state is
        swapped under one lock, so a concurrent ``check()`` sees the old
        schedule or the new one, never a mix."""
        if config is None:
            config = os.environ.get(ENV_CONFIG)
            if config is None:
                with self._lock:
                    self._rules = []
                    self._path = None
                    self._dynamic = False
                    self._seed = 0
                    self._reset_stats_locked()
                return
        if isinstance(config, str):
            path: Optional[str] = config
            with open(path) as f:
                doc = json.load(f)
            mtime = os.path.getmtime(path)
        else:
            doc, path, mtime = config, None, 0.0
        rules = [_Rule(r) for r in doc.get("faults", [])]
        with self._lock:
            self._rules = rules
            self._seed = int(doc.get("seed", 0))
            self._rng = random.Random(self._seed)
            self._dynamic = bool(doc.get("dynamic", False))
            self._path = path
            self._mtime = mtime
            self._reset_stats_locked()

    def _maybe_reload(self):
        with self._lock:
            dynamic, path, known = self._dynamic, self._path, self._mtime
        if not dynamic or path is None:
            return
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if mtime != known:
            self.configure(path)

    def check(self, name: str):
        """Called at each instrumented execution; raises if a rule fires."""
        self._maybe_reload()
        with self._lock:
            self._checks[name] = self._checks.get(name, 0) + 1
            for rule in self._rules:
                if not rule.applies(name):
                    continue
                if rule.remaining is not None and rule.remaining <= 0:
                    continue
                if rule.skip_remaining > 0:
                    # this matching occurrence is consumed whether or not
                    # probability would have fired
                    rule.skip_remaining -= 1
                    continue
                if self._rng.random() >= rule.probability:
                    continue
                if rule.remaining is not None:
                    rule.remaining -= 1
                self._seq += 1
                self._fired[name] = self._fired.get(name, 0) + 1
                entry = {"seq": self._seq, "name": name,
                         "fault": rule.fault, "match": rule.match,
                         # 1-based: replay with skip = occurrence - 1
                         "occurrence": self._checks[name]}
                self._log.append(entry)
                self._mirror_locked(entry)
                kind = rule.fault
                break
            else:
                return
        FAULT_KINDS[kind](name)

    def _mirror_locked(self, entry: dict):
        if not self._mirror_path:
            return
        try:
            if self._mirror_fd is None:
                self._mirror_fd = os.open(
                    self._mirror_path,
                    os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
            os.write(self._mirror_fd,
                     (json.dumps(entry) + "\n").encode("utf-8"))
        except OSError:
            # observability must never take the workload down with it
            self._mirror_fd = None

    def current_config(self) -> dict:
        """The live schedule as a config dict (the original rule specs)."""
        with self._lock:
            return {"seed": self._seed,
                    "faults": [dict(r.spec) for r in self._rules]}

    def check_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._checks)

    def fire_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def fired_log(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._log]

    def reset_stats(self):
        with self._lock:
            self._reset_stats_locked()

    @contextlib.contextmanager
    def scope(self, config: Union[str, dict]):
        """Apply ``config`` for the block and restore the previous
        schedule on exit; the block's stats stay readable after it."""
        with self._lock:
            saved = (self._rules, self._rng, self._dynamic, self._path,
                     self._mtime, self._seed)
        self.configure(config)
        try:
            yield self
        finally:
            with self._lock:
                (self._rules, self._rng, self._dynamic, self._path,
                 self._mtime, self._seed) = saved


_injector = _Injector()
configure = _injector.configure
scope = _injector.scope
check_counts = _injector.check_counts
fire_counts = _injector.fire_counts
fired_log = _injector.fired_log
reset_stats = _injector.reset_stats
current_config = _injector.current_config


def instrument(fn, name: Optional[str] = None):
    """Wrap a callable so the injector screens every invocation."""
    label = name or getattr(fn, "__name__", "anonymous")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _injector.check(label)
        return fn(*args, **kwargs)

    wrapped.__faultinj_name__ = label
    return wrapped
