"""Host facade over the native GPU resource adaptor.

Mirrors the spark-rapids-jni Java API surface (file:line refs into its
``src/main/java/com/nvidia/spark/rapids/jni/``):

* ``RmmSpark.java:59-664``   — static facade: thread-role registration,
  retry-block demarcation, OOM injection, task metrics.
* ``SparkResourceAdaptor.java:35-79`` — handle owner + daemon watchdog
  polling ``checkAndBreakDeadlocks`` every 100ms.
* ``ThreadStateRegistry.java:44-66`` — native→host callback classifying
  threads blocked outside the allocator.
* the ``GpuRetryOOM``/``GpuSplitAndRetryOOM``/… exception family.

The native arena is *logical*: it schedules tasks against a byte budget
(device-memory pressure) while PyTorch's CUDA caching allocator owns the
physical buffers — the role the RMM interposer plays for the plugin
(SURVEY.md §2.2).  Steps charge what they materialize
(:class:`~.executor.TaskContext`), and a real ``torch.OutOfMemoryError``
is translated into the same protocol where it surfaces
(:func:`~.executor.translate_device_oom`).

The state machine is ``native/resource_adaptor.cpp``, host C++17 with a C
ABI, built with ``g++`` at first use (:func:`..ops._build.load_host`) and
called through ``ctypes``, which releases the GIL for every call: a
thread parked inside ``block_thread_until_ready`` must not stall the
other task threads.
"""

from __future__ import annotations

import ctypes
import enum
import os
import threading
from typing import Optional, Sequence

import torch

from .._roadmap import not_ported

LIB_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native", "resource_adaptor.cpp")


# ---------------------------------------------------------------------------
# the OOM exception family (reference: GpuRetryOOM.java etc.)
# ---------------------------------------------------------------------------

class RetryOOM(MemoryError):
    """Roll back to the last checkpoint, make inputs spillable, call
    ``RmmSpark.block_thread_until_ready()``, retry (GpuRetryOOM)."""


class SplitAndRetryOOM(MemoryError):
    """Like :class:`RetryOOM` but the input must also be split — the
    scheduler guarantees this thread is the only one running
    (GpuSplitAndRetryOOM)."""


class CpuRetryOOM(RetryOOM):
    """Host-memory flavor (CpuRetryOOM)."""


class CpuSplitAndRetryOOM(SplitAndRetryOOM):
    """Host-memory flavor (CpuSplitAndRetryOOM)."""


class OOMError(MemoryError):
    """Hard OOM: the retry ladder is exhausted (GpuOOM)."""


class InjectedException(RuntimeError):
    """Test-injected failure (forceCudfException equivalent)."""


class UnknownThreadError(RuntimeError):
    """The calling thread is not (or no longer) registered with the
    adaptor.  The serving runtime relies on this as its kill signal: when
    ``task_done`` releases a task whose threads are still parked in the
    arena, those threads are woken with REMOVE_THROW and their next
    protocol call fails with this error instead of wedging until the
    watchdog ``join`` timeout."""


class ThreadState(enum.IntEnum):
    """Mirror of the native enum (reference RmmSparkThreadState.java)."""

    UNKNOWN = 0
    RUNNING = 1
    ALLOC = 2
    ALLOC_FREE = 3
    BLOCKED = 4
    BUFN_THROW = 5
    BUFN_WAIT = 6
    BUFN = 7
    SPLIT_THROW = 8
    REMOVE_THROW = 9


_OK = 0
_RETRY_OOM = 1
_SPLIT_AND_RETRY_OOM = 2
_OOM = 3
_INJECTED = 4
_UNKNOWN_THREAD = 5


def _raise_for(code: int, cpu: bool = False):
    if code == _OK:
        return
    if code == _RETRY_OOM:
        raise (CpuRetryOOM if cpu else RetryOOM)()
    if code == _SPLIT_AND_RETRY_OOM:
        raise (CpuSplitAndRetryOOM if cpu else SplitAndRetryOOM)()
    if code == _OOM:
        raise OOMError()
    if code == _INJECTED:
        raise InjectedException()
    raise UnknownThreadError(
        f"thread not registered with the resource adaptor "
        f"(native code {code})")


# ---------------------------------------------------------------------------
# native library
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_BLOCKED_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_long)


def _load_lib() -> ctypes.CDLL:
    """Build (once per source hash) and bind the native adaptor."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops import _build

        lib = _build.load_host(LIB_SOURCE)
        lib.tra_create.restype = ctypes.c_void_p
        lib.tra_create.argtypes = [ctypes.c_long, ctypes.c_char_p]
        lib.tra_destroy.argtypes = [ctypes.c_void_p]
        lib.tra_set_blocked_callback.argtypes = [ctypes.c_void_p, _BLOCKED_CB]
        lib.tra_start_dedicated_task_thread.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
        lib.tra_pool_thread_working_on_tasks.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        lib.tra_pool_thread_finished_for_tasks.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        lib.tra_remove_thread_association.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
        lib.tra_task_done.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tra_allocate.restype = ctypes.c_int
        lib.tra_allocate.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                     ctypes.c_long]
        lib.tra_device_alloc_failed.restype = ctypes.c_int
        lib.tra_device_alloc_failed.argtypes = [ctypes.c_void_p,
                                                ctypes.c_long]
        lib.tra_alloc_recovered.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tra_resize_pool.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tra_set_host_pool.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tra_allocate_on.restype = ctypes.c_int
        lib.tra_allocate_on.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_int]
        lib.tra_deallocate_on.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                          ctypes.c_long, ctypes.c_int]
        lib.tra_total_allocated_on.restype = ctypes.c_long
        lib.tra_total_allocated_on.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
        lib.tra_deallocate.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                       ctypes.c_long]
        lib.tra_block_thread_until_ready.restype = ctypes.c_int
        lib.tra_block_thread_until_ready.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_long]
        lib.tra_get_state_of.restype = ctypes.c_int
        lib.tra_get_state_of.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tra_check_and_break_deadlocks.restype = ctypes.c_int
        lib.tra_check_and_break_deadlocks.argtypes = [ctypes.c_void_p]
        lib.tra_break_stalled_cycles.restype = ctypes.c_int
        lib.tra_break_stalled_cycles.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_long]
        for f in ("tra_force_retry_oom", "tra_force_split_retry_oom",
                  "tra_force_cudf_exception"):
            fn = getattr(lib, f)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                           ctypes.c_int]
        lib.tra_get_and_reset_metric.restype = ctypes.c_long
        lib.tra_get_and_reset_metric.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_long, ctypes.c_int]
        lib.tra_total_allocated.restype = ctypes.c_long
        lib.tra_total_allocated.argtypes = [ctypes.c_void_p]
        lib.tra_max_allocated.restype = ctypes.c_long
        lib.tra_max_allocated.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# ThreadStateRegistry: host threads report blocked-ness to the native scan
# ---------------------------------------------------------------------------

class ThreadStateRegistry:
    """Marks threads as blocked in *host* code so the native deadlock scan
    counts them (the JVM inspects Thread.getState(); Python can't, so host
    code brackets its waits with :meth:`blocked_section`)."""

    _lock = threading.Lock()
    _blocked: set = set()

    @classmethod
    def set_blocked(cls, tid: int, blocked: bool):
        with cls._lock:
            (cls._blocked.add if blocked else cls._blocked.discard)(tid)

    @classmethod
    def is_blocked(cls, tid: int) -> bool:
        with cls._lock:
            return tid in cls._blocked

    class blocked_section:
        """``with ThreadStateRegistry.blocked_section(): lock.wait()``"""

        def __enter__(self):
            self.tid = threading.get_ident()
            ThreadStateRegistry.set_blocked(self.tid, True)
            return self

        def __exit__(self, *exc):
            ThreadStateRegistry.set_blocked(self.tid, False)
            return False


@_BLOCKED_CB
def _is_blocked_cb(tid):
    return 1 if ThreadStateRegistry.is_blocked(tid) else 0


# ---------------------------------------------------------------------------
# SparkResourceAdaptor: handle + watchdog
# ---------------------------------------------------------------------------

class SparkResourceAdaptor:
    """Owns one native adaptor; a daemon watchdog breaks deadlocks every
    ``poll_ms`` (reference SparkResourceAdaptor.java:35-79)."""

    def __init__(self, pool_bytes: int, log_path: Optional[str] = None,
                 poll_ms: Optional[float] = None,
                 host_pool_bytes: int = 0):
        if poll_ms is None:
            from .. import config

            poll_ms = config.get("watchdog_poll_ms")
        self._lib = _load_lib()
        self._h = self._lib.tra_create(
            ctypes.c_long(pool_bytes),
            (log_path or "").encode())
        self.pool_bytes = pool_bytes
        self.host_pool_bytes = host_pool_bytes
        if host_pool_bytes > 0:
            # second pool in the SAME state machine: the deadlock scan
            # sees mixed device+host blocking (reference handles mixed
            # GPU+CPU blocking in one machine)
            self._lib.tra_set_host_pool(self._h,
                                        ctypes.c_long(host_pool_bytes))
        self._lib.tra_set_blocked_callback(self._h, _is_blocked_cb)
        self._closed = threading.Event()
        # serving mode: > 0 makes the watchdog ALSO break cycles that are
        # stalled past this bound even while other tenants keep running
        # (the global scan requires every task thread blocked)
        self._stall_break_ms = 0.0
        # cumulative stall-breaker firings — the "stall epoch" a front-door
        # worker reports in its heartbeat pongs: an epoch that keeps
        # climbing while no sessions complete marks the worker as wedged
        self.stall_breaks = 0
        self._watchdog = threading.Thread(
            target=self._watch, args=(poll_ms / 1000.0,),
            name="tra-watchdog", daemon=True)
        self._watchdog.start()

    def _watch(self, period_s: float):
        while not self._closed.wait(period_s):
            try:
                self._lib.tra_check_and_break_deadlocks(self._h)
                stall_ms = self._stall_break_ms
                if stall_ms > 0:
                    self.break_stalled_cycles(stall_ms)
            except Exception:
                return

    def close(self):
        if not self._closed.is_set():
            self._closed.set()
            self._watchdog.join(timeout=10.0)
            if self._watchdog.is_alive():
                # never free the native adaptor under a thread still inside
                # it — leaking one handle beats a use-after-free
                return
            self._lib.tra_destroy(self._h)
            self._h = None

    # -- raw operations (tid defaults to the calling thread) -----------
    @staticmethod
    def _tid(tid: Optional[int]) -> int:
        return threading.get_ident() if tid is None else tid

    def start_dedicated_task_thread(self, task_id: int,
                                    tid: Optional[int] = None):
        self._lib.tra_start_dedicated_task_thread(
            self._h, self._tid(tid), task_id)

    def pool_thread_working_on_tasks(self, is_shuffle: bool,
                                     task_ids: Sequence[int],
                                     tid: Optional[int] = None):
        arr = (ctypes.c_long * len(task_ids))(*task_ids)
        self._lib.tra_pool_thread_working_on_tasks(
            self._h, int(is_shuffle), self._tid(tid), arr, len(task_ids))

    def pool_thread_finished_for_tasks(self, task_ids: Sequence[int],
                                       tid: Optional[int] = None):
        arr = (ctypes.c_long * len(task_ids))(*task_ids)
        self._lib.tra_pool_thread_finished_for_tasks(
            self._h, self._tid(tid), arr, len(task_ids))

    def remove_thread_association(self, task_id: int = -1,
                                  tid: Optional[int] = None):
        self._lib.tra_remove_thread_association(
            self._h, self._tid(tid), task_id)

    def task_done(self, task_id: int):
        self._lib.tra_task_done(self._h, task_id)

    def allocate(self, nbytes: int, tid: Optional[int] = None):
        """Draw ``nbytes`` from the arena; raises the OOM family."""
        _raise_for(self._lib.tra_allocate(self._h, self._tid(tid), nbytes))

    def deallocate(self, nbytes: int, tid: Optional[int] = None):
        self._lib.tra_deallocate(self._h, self._tid(tid), nbytes)

    def device_alloc_failed(self, tid: Optional[int] = None):
        """A REAL device allocation failed: run the alloc-failure protocol
        (block / BUFN-escalate / split) and raise the resulting OOM."""
        _raise_for(self._lib.tra_device_alloc_failed(self._h,
                                                     self._tid(tid)))

    def alloc_recovered(self, tid: Optional[int] = None):
        """A retry ladder resolved: reset the consecutive-failure count
        (real-device-OOM recoveries never pass through allocate())."""
        self._lib.tra_alloc_recovered(self._h, self._tid(tid))

    def host_allocate(self, nbytes: int, tid: Optional[int] = None):
        """Draw from the unified HOST pool; raises the Cpu* OOM flavors."""
        _raise_for(self._lib.tra_allocate_on(self._h, self._tid(tid),
                                             nbytes, 1), cpu=True)

    def host_deallocate(self, nbytes: int, tid: Optional[int] = None):
        self._lib.tra_deallocate_on(self._h, self._tid(tid), nbytes, 1)

    def host_total_allocated(self) -> int:
        return self._lib.tra_total_allocated_on(self._h, 1)

    def resize_pool(self, new_pool_bytes: int):
        """Track the device's reported capacity
        (:meth:`RmmSpark.sync_pool_with_device`)."""
        self._lib.tra_resize_pool(self._h, new_pool_bytes)

    def block_thread_until_ready(self, tid: Optional[int] = None):
        _raise_for(self._lib.tra_block_thread_until_ready(
            self._h, self._tid(tid)))

    def get_state_of(self, tid: Optional[int] = None) -> ThreadState:
        return ThreadState(self._lib.tra_get_state_of(self._h,
                                                      self._tid(tid)))

    def check_and_break_deadlocks(self) -> bool:
        return bool(self._lib.tra_check_and_break_deadlocks(self._h))

    def set_stall_break_ms(self, stall_ms: float):
        """Enable (``> 0``) or disable (``0``) the watchdog's cross-tenant
        stall breaker; see ``break_stalled_cycles``."""
        self._stall_break_ms = float(stall_ms)

    def break_stalled_cycles(self, stall_ms: float) -> bool:
        """Break a deadlock cycle confined to a SUBSET of tenants: among
        threads continuously blocked past ``stall_ms``, roll back the
        lowest-priority BLOCKED one (RetryOOM), or split the
        highest-priority BUFN one when none are plain BLOCKED.  Returns
        True when a thread was broken (also bumping ``stall_breaks``)."""
        broke = bool(self._lib.tra_break_stalled_cycles(
            self._h, ctypes.c_long(int(stall_ms))))
        if broke:
            self.stall_breaks += 1
        return broke

    # -- injection ------------------------------------------------------
    def force_retry_oom(self, tid=None, num_ooms=1, skip_count=0):
        self._lib.tra_force_retry_oom(self._h, self._tid(tid), num_ooms,
                                      skip_count)

    def force_split_and_retry_oom(self, tid=None, num_ooms=1, skip_count=0):
        self._lib.tra_force_split_retry_oom(self._h, self._tid(tid),
                                            num_ooms, skip_count)

    def force_exception(self, tid=None, num_times=1, skip_count=0):
        self._lib.tra_force_cudf_exception(self._h, self._tid(tid),
                                           num_times, skip_count)

    # -- metrics --------------------------------------------------------
    def get_and_reset_num_retry(self, task_id: int) -> int:
        return self._lib.tra_get_and_reset_metric(self._h, task_id, 0)

    def get_and_reset_num_split_retry(self, task_id: int) -> int:
        return self._lib.tra_get_and_reset_metric(self._h, task_id, 1)

    def get_and_reset_block_time_ns(self, task_id: int) -> int:
        return self._lib.tra_get_and_reset_metric(self._h, task_id, 2)

    def get_and_reset_compute_time_lost_ns(self, task_id: int) -> int:
        return self._lib.tra_get_and_reset_metric(self._h, task_id, 3)

    def get_max_memory_allocated(self, task_id: int) -> int:
        return self._lib.tra_get_and_reset_metric(self._h, task_id, 4)

    def total_allocated(self) -> int:
        return self._lib.tra_total_allocated(self._h)

    def max_allocated(self) -> int:
        return self._lib.tra_max_allocated(self._h)


# ---------------------------------------------------------------------------
# RmmSpark: the process-wide static facade (reference RmmSpark.java)
# ---------------------------------------------------------------------------

class RmmSpark:
    """Static facade, one installed device adaptor (plus an optional host
    arena — the reference's CPU-alloc hook mirror,
    ``RmmSpark.java:601-664``) per process."""

    _adaptor: Optional[SparkResourceAdaptor] = None
    _cpu_adaptor: Optional[SparkResourceAdaptor] = None
    _lock = threading.Lock()

    @classmethod
    def set_event_handler(cls, pool_bytes: Optional[int] = None,
                          log_path=None,
                          poll_ms: Optional[float] = None,
                          host_pool_bytes: int = 0
                          ) -> SparkResourceAdaptor:
        """Install the adaptor (reference RmmSpark.setEventHandler).

        ``host_pool_bytes > 0`` enables the UNIFIED host arena: both pools
        share one thread state machine, so the deadlock scan sees a thread
        blocked on host memory while holding device budget (the
        reference's mixed CPU+GPU blocking matrix,
        SparkResourceAdaptorJni.cpp:808-842)."""
        if pool_bytes is None:
            from .. import config

            pool_bytes = config.get("mem_pool_bytes")
            if pool_bytes <= 0:
                raise ValueError(
                    "pool_bytes not given and mem_pool_bytes config unset")
        with cls._lock:
            if cls._adaptor is not None:
                raise RuntimeError("adaptor already installed")
            cls._adaptor = SparkResourceAdaptor(
                pool_bytes, log_path, poll_ms,
                host_pool_bytes=host_pool_bytes)
            return cls._adaptor

    @classmethod
    def set_cpu_event_handler(cls, pool_bytes: int, log_path=None,
                              poll_ms: float = 100.0) -> SparkResourceAdaptor:
        """LEGACY: a host arena as a second independent adaptor (its
        deadlock scan cannot see device-arena blocking).  Prefer
        ``set_event_handler(..., host_pool_bytes=...)``."""
        with cls._lock:
            if cls._cpu_adaptor is not None:
                raise RuntimeError("cpu adaptor already installed")
            cls._cpu_adaptor = SparkResourceAdaptor(pool_bytes, log_path,
                                                    poll_ms)
            return cls._cpu_adaptor

    @classmethod
    def clear_event_handler(cls):
        with cls._lock:
            if cls._adaptor is not None:
                cls._adaptor.close()
                cls._adaptor = None
            if cls._cpu_adaptor is not None:
                cls._cpu_adaptor.close()
                cls._cpu_adaptor = None

    @classmethod
    def _a(cls) -> SparkResourceAdaptor:
        a = cls._adaptor
        if a is None:
            raise RuntimeError("no adaptor installed; call set_event_handler")
        return a

    @classmethod
    def _c(cls) -> SparkResourceAdaptor:
        a = cls._cpu_adaptor
        if a is None:
            raise RuntimeError(
                "no cpu adaptor installed; call set_cpu_event_handler")
        return a

    @classmethod
    def _each(cls):
        return [a for a in (cls._adaptor, cls._cpu_adaptor) if a is not None]

    # thread-role registration (applies to both arenas) -----------------
    @classmethod
    def current_thread_is_dedicated_to_task(cls, task_id: int):
        for a in cls._each():
            a.start_dedicated_task_thread(task_id)

    @classmethod
    def shuffle_thread_working_on_tasks(cls, task_ids: Sequence[int]):
        for a in cls._each():
            a.pool_thread_working_on_tasks(True, task_ids)

    @classmethod
    def pool_thread_working_on_tasks(cls, task_ids: Sequence[int]):
        for a in cls._each():
            a.pool_thread_working_on_tasks(False, task_ids)

    @classmethod
    def pool_thread_finished_for_tasks(cls, task_ids: Sequence[int]):
        for a in cls._each():
            a.pool_thread_finished_for_tasks(task_ids)

    @classmethod
    def remove_current_thread_association(cls):
        for a in cls._each():
            a.remove_thread_association()

    @classmethod
    def task_done(cls, task_id: int):
        for a in cls._each():
            a.task_done(task_id)

    # allocation --------------------------------------------------------
    @classmethod
    def allocate(cls, nbytes: int):
        cls._a().allocate(nbytes)

    @classmethod
    def deallocate(cls, nbytes: int):
        cls._a().deallocate(nbytes)

    @classmethod
    def device_oom_observed(cls):
        """Translate a caught real device OOM (``torch.OutOfMemoryError``)
        into the retry ladder; always raises one of the OOM family."""
        cls._a().device_alloc_failed()
        raise RetryOOM()  # unreachable unless native returned OK

    @classmethod
    def sync_pool_with_device(cls, device=None, fraction: float = 1.0):
        """Resize the logical arena to what the device can actually still
        admit: ``headroom * fraction`` plus the bytes the arena itself
        already accounts (its charges are part of what is in use).  The
        headroom is the card's free memory (``torch.cuda.mem_get_info``)
        plus what the caching allocator holds but has not handed out
        (``memory_reserved - memory_allocated``): the allocator gives that
        back before it fails.  Returns the new pool size, or None on a
        CPU device.  ``device=None`` is the GPU."""
        from ..device import resolve_device

        d = resolve_device(device)
        if d.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(d)
        cached = torch.cuda.memory_reserved(d) - torch.cuda.memory_allocated(d)
        arena = cls._a().total_allocated()
        new_pool = max(int((free + cached) * fraction) + arena, arena)
        cls._a().resize_pool(new_pool)
        return new_pool

    @classmethod
    def _unified_host(cls) -> bool:
        a = cls._adaptor
        return a is not None and a.host_pool_bytes > 0

    @classmethod
    def cpu_allocate(cls, nbytes: int):
        """Host-arena draw; raises the Cpu* OOM flavors."""
        if cls._unified_host():
            cls._a().host_allocate(nbytes)
            return
        try:
            cls._c().allocate(nbytes)
        except SplitAndRetryOOM as e:
            raise CpuSplitAndRetryOOM(*e.args) from None
        except RetryOOM as e:
            raise CpuRetryOOM(*e.args) from None

    @classmethod
    def cpu_deallocate(cls, nbytes: int):
        if cls._unified_host():
            cls._a().host_deallocate(nbytes)
            return
        cls._c().deallocate(nbytes)

    @classmethod
    def cpu_block_thread_until_ready(cls):
        adaptor = cls._a() if cls._unified_host() else cls._c()
        try:
            adaptor.block_thread_until_ready()
        except SplitAndRetryOOM as e:
            raise CpuSplitAndRetryOOM(*e.args) from None
        except RetryOOM as e:
            raise CpuRetryOOM(*e.args) from None

    @classmethod
    def block_thread_until_ready(cls):
        cls._a().block_thread_until_ready()

    @classmethod
    def get_state_of(cls, tid: int) -> ThreadState:
        return cls._a().get_state_of(tid)

    @classmethod
    def set_stall_break_ms(cls, stall_ms: float):
        """Arm the watchdog's cross-tenant stall breaker on every
        installed arena (serving mode; 0 disables)."""
        for a in cls._each():
            a.set_stall_break_ms(stall_ms)

    @classmethod
    def stall_break_count(cls) -> int:
        """Cumulative native stall-breaker firings across installed
        arenas — the stall EPOCH a front-door worker carries in its
        heartbeat pongs (0 with no adaptor installed)."""
        with cls._lock:
            return sum(a.stall_breaks for a in cls._each())

    # spill metrics (tier transitions recorded by the spill store) -------
    @classmethod
    def spill_metrics(cls) -> dict:
        """Global spill counters (zeros when no framework is installed)."""
        from . import spill

        fw = spill.get_framework()
        if fw is None:
            return dict.fromkeys(spill.SpillMetrics.FIELDS, 0)
        return fw.metrics.snapshot()

    @classmethod
    def get_and_reset_task_spill_metrics(cls, task_id: int) -> dict:
        """Per-task spill counters, reset on read (the consume-once shape
        of ``get_and_reset_num_retry``)."""
        from . import spill

        fw = spill.get_framework()
        if fw is None:
            return dict.fromkeys(spill.SpillMetrics.FIELDS, 0)
        return fw.metrics.get_and_reset_task(task_id)

    # shuffle metrics (recorded by the shuffle package's registry) ------
    @classmethod
    def shuffle_metrics(cls) -> dict:
        """Global ShuffleService counters (rounds, rows/bytes moved,
        spilled bytes, OOB/dropped rows, transport retries) — surfaced
        here next to :meth:`spill_metrics` so executor-side telemetry can
        scrape both from one place."""
        from ..shuffle import get_registry

        return get_registry().metrics.snapshot()

    # plan-cache metrics (recorded by the plan compiler's cache) --------
    @classmethod
    def plan_cache_metrics(cls) -> dict:
        """Global plan-cache counters (hits/misses/evictions/size) —
        surfaced here next to :meth:`spill_metrics` and
        :meth:`shuffle_metrics` so executor-side telemetry scrapes the
        whole retrace story from one place (zeros-safe: an import that
        never compiled a plan reports an empty cache)."""
        from ..plan.cache import plan_cache_metrics

        return plan_cache_metrics()

    # fleet metrics (recorded by the multi-process front door) ----------
    @classmethod
    def fleet_metrics(cls) -> dict:
        """Front-door fleet counters: the serving fleet is not ported
        yet."""
        raise not_ported("RmmSpark.fleet_metrics (the front door)", 16)

    # injection ---------------------------------------------------------
    @classmethod
    def force_retry_oom(cls, tid, num_ooms=1, skip_count=0):
        cls._a().force_retry_oom(tid, num_ooms, skip_count)

    @classmethod
    def force_split_and_retry_oom(cls, tid, num_ooms=1, skip_count=0):
        cls._a().force_split_and_retry_oom(tid, num_ooms, skip_count)

    @classmethod
    def force_exception(cls, tid, num_times=1, skip_count=0):
        cls._a().force_exception(tid, num_times, skip_count)
