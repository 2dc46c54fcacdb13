"""Long-running multi-tenant executor service over the unified arena.

Counterpart of ``spark_rapids_jni_tpu/serve/runtime.py`` over the port's
memory layer (:mod:`..mem`), plan cache and exchange.  A deployment runs
many interactive queries over one shared GPU; this runtime stacks that
workload on the existing machinery:

* **Admission**: a submitted query first waits for one of
  ``serve_max_concurrent`` slots, the wait bracketed with
  :class:`~..mem.rmm_spark.ThreadStateRegistry.blocked_section` so the
  native deadlock scan counts queued tenants as blocked.  Waiters are
  granted in ``(priority desc, arrival asc)`` order
  (:class:`_PrioritySlots`).  An admitted query then proves its
  estimated footprint fits by charging it against the arena through
  :func:`~..mem.executor.run_with_retry`: a reservation that cannot fit
  parks in BUFN, spills idle tenants' handles through the spill store's
  LRU, or splits (halving the grant, down to 64 KiB, surfaced as
  ``session.granted_bytes``).  The probe charge is returned once
  admission succeeds; the query's own charges account its residency.
* **Isolation and fairness**: each session runs on its own thread under
  its own :class:`~..mem.executor.TaskContext`; the spill store ranks
  tenants by ``(priority class, admission order)``.  The
  :class:`~..plan.cache.PlanCache` is shared, with per-session pins
  (``session.pin_plan``) released on every exit path.
* **Cross-tenant drain overlap**: the runtime installs a shared drain
  lane (:func:`~..shuffle.service.install_drain_lane`), so one tenant's
  exchange round runs on the lane thread while the tenant's own thread
  wraps the round before it.  Every thread uses the device's default
  stream: the lane's round and the tenants' kernels are ordered on the
  device, and the overlap is on the host.
* **Deadlock breaking across tenants**: the global scan fires only when
  every task thread is blocked, so constructing the runtime arms the
  watchdog's stall breaker (``serve_stall_break_ms``), which rolls back
  the lowest-priority thread blocked past the bound.
* **Kill-safe cancellation**: :meth:`ServeRuntime.cancel` (or a query
  timeout, or an injected ``task_cancel`` fault) is honored at any
  point: queued, mid-ladder, mid-round, or parked in BUFN.  The kill
  releases the task (``RmmSpark.task_done``), which wakes threads parked
  in the arena with REMOVE_THROW, raised as
  :class:`~..mem.rmm_spark.UnknownThreadError`; the session unwinds
  through ``TaskContext.__exit__`` (spill handles closed, their files
  deleted, arena charges drained), drops its plan-cache pins, clears its
  eviction priority and frees its slot.

Timeouts re-admit: a query killed by its own ``timeout_s`` backs off
(``serve_backoff_ms``, doubled per attempt) and is re-admitted up to
``serve_max_readmissions`` times before :class:`QueryTimeout`.  The
backoff waits on the session's kill flag, so a cancel arriving
mid-backoff unwinds at once.  External cancels never re-admit.
``shutdown()`` is idempotent: a second or racing call waits for the
first and returns its result.  No session ever moves to the CPU: a
query runs where its inputs live.
"""

from __future__ import annotations

import heapq
import inspect
import itertools
import threading
import time
from concurrent import futures
from typing import Callable, Optional

from .. import config, faultinj
from ..mem.executor import TaskContext, borrowed_task, run_with_retry
from ..mem import spill as spill_mod
from ..mem.rmm_spark import RmmSpark, ThreadStateRegistry, UnknownThreadError
from ..plan.cache import get_plan_cache
from ..shuffle import service as shuffle_service


class ServeError(RuntimeError):
    """Base class of the serving runtime's failures."""


class QueryCancelled(ServeError):
    """The session was killed (external cancel, shutdown, or timeout
    kill) and has unwound; ``reason`` says which."""

    def __init__(self, message: str, reason: str = "cancelled"):
        super().__init__(message)
        self.reason = reason


class QueryTimeout(ServeError):
    """Admission or execution exceeded its deadline (after bounded
    re-admission for execution timeouts)."""


# instrumented kill boundaries: a `task_cancel` rule lands here (or at any
# other probe the query crosses: spill_io_*, shuffle_io_round)
_admit_probe = faultinj.instrument(lambda: None, "serve_admit")
_step_probe = faultinj.instrument(lambda: None, "serve_step")

_MIN_GRANT = 1 << 16  # reservation split floor: 64 KiB
_ADMIT_TICK_S = 0.05  # cancellation latency while queued

# Process-wide count of admission tickets ever granted (a result cache
# proves a hit bypassed admission by this count not moving).
_tickets_issued = 0
_tickets_lock = threading.Lock()


def admission_tickets_issued() -> int:
    """Process-wide total of :class:`AdmissionTicket` grants."""
    with _tickets_lock:
        return _tickets_issued


class _PrioritySlots:
    """``serve_max_concurrent`` admission slots granted by SLA class.

    A bare semaphore serves strict arrival order; this serves waiters by
    ``(priority desc, arrival seq asc)``: a waiter stays enqueued for its
    whole wait, and a slot freeing up goes to the best-ranked waiter at
    that moment — so a high-priority latecomer overtakes anything not
    yet granted, but never preempts a holder.  The wait ticks every
    ``_ADMIT_TICK_S`` to honor cancellation; the caller brackets it in
    ``blocked_section`` so the deadlock scan still counts queued tenants
    as blocked."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._in_use = 0
        self._cond = threading.Condition()
        self._waiters: list = []  # heap of (-priority, arrival_seq)

    def waiting(self) -> int:
        """How many acquirers are currently enqueued (test introspection)."""
        with self._cond:
            return len(self._waiters)

    def acquire(self, priority: int, arrival_seq: int, deadline: float,
                cancel_check: Callable[[], None]) -> bool:
        key = (-int(priority), int(arrival_seq))
        with self._cond:
            heapq.heappush(self._waiters, key)
            try:
                while True:
                    cancel_check()
                    if self._in_use < self._capacity \
                            and self._waiters[0] == key:
                        self._in_use += 1
                        return True
                    if time.monotonic() >= deadline:
                        return False
                    self._cond.wait(_ADMIT_TICK_S)
            finally:
                # every exit path — grant, timeout, cancel — dequeues,
                # and wakes the rest in case the head just changed
                self._waiters.remove(key)
                heapq.heapify(self._waiters)
                self._cond.notify_all()

    def release(self):
        with self._cond:
            self._in_use = max(0, self._in_use - 1)
            self._cond.notify_all()


class AdmissionTicket:
    """One admission slot, held from admission until the session's
    unwind; released exactly once."""

    def __init__(self, slots: "_PrioritySlots", session: "TenantSession"):
        self._slots = slots
        self.session = session
        self._released = False
        self._lock = threading.Lock()
        global _tickets_issued
        with _tickets_lock:
            _tickets_issued += 1

    def release(self):
        with self._lock:
            if self._released:
                return
            self._released = True
        self._slots.release()

    close = release


class TenantSession:
    """Handle for one submitted query.

    Status walks ``queued → admitted → running → done`` on the happy
    path, ending in ``cancelled`` / ``timeout`` / ``failed`` otherwise.
    ``result()`` blocks for the outcome and re-raises the terminal
    error; ``cancel()`` / ``close()`` kill at any point.
    """

    def __init__(self, runtime: "ServeRuntime", session_id: int,
                 task_id: int, tenant, query_fn: Callable,
                 est_bytes: int, timeout_s: Optional[float],
                 priority: int = 0, store=None, epoch: int = 0):
        self._runtime = runtime
        self.session_id = session_id
        self.task_id = task_id
        self.tenant = tenant if tenant is not None else f"tenant-{session_id}"
        self.query_fn = query_fn
        self.est_bytes = int(est_bytes or 0)
        self.timeout_s = timeout_s
        self.priority = int(priority)
        # the persistent shuffle store (and this process's fencing
        # epoch) the runtime was built with: query kinds reach the
        # durable tier via the session instead of a module global
        self.store = store
        self.epoch = int(epoch)
        self.pin_owner = ("serve", session_id)
        self.status = "queued"
        self.result_value = None
        self.error: Optional[BaseException] = None
        self.granted_bytes: Optional[int] = None
        self.attempts = 0
        self._cancelled = threading.Event()
        self._cancel_reason: Optional[str] = None
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- caller API -----------------------------------------------------
    def cancel(self):
        self._runtime.cancel(self)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"session {self.session_id} still {self.status} "
                f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result_value

    def close(self, timeout: Optional[float] = 10.0):
        """Idempotent terminal release: cancel if still in flight and
        wait for the unwind."""
        if not self._done.is_set():
            self._runtime.cancel(self)
        self._done.wait(timeout)

    def pin_plan(self, key):
        """Pin a shared plan-cache entry for this session's lifetime;
        every exit path (done/cancel/kill) releases the pin."""
        get_plan_cache().pin(key, self.pin_owner)

    # -- worker-side helpers --------------------------------------------
    def _check_cancelled(self):
        if self._cancelled.is_set():
            reason = self._cancel_reason or "cancelled"
            raise QueryCancelled(
                f"session {self.session_id} cancelled ({reason})",
                reason=reason)

    def _rearm(self):
        # fresh Event: a stale timeout-kill racing in after re-admission
        # must not cancel the new attempt
        self._cancelled = threading.Event()
        self._cancel_reason = None


class _DrainLane:
    """The shared shuffle drain thread (one per runtime).  Each round is
    bracketed with :func:`~..mem.executor.borrowed_task` so the lane
    thread's arena charges, and its place in the deadlock scan, belong
    to the tenant that owns the round, at shuffle-thread priority."""

    def __init__(self):
        self._ex = futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-drain")

    def submit(self, task_id, fn):
        def run():
            if task_id is None:
                return fn()
            with borrowed_task(task_id, shuffle=True):
                return fn()
        return self._ex.submit(run)

    def close(self):
        self._ex.shutdown(wait=True, cancel_futures=True)


class ServeRuntime:
    """The long-running executor service: ``submit`` → session handle,
    ``cancel`` at any point, ``shutdown`` to drain everything."""

    def __init__(self, max_concurrent: Optional[int] = None,
                 task_id_base: int = 10_000,
                 store=None, epoch: int = 0):
        if max_concurrent is None:
            max_concurrent = int(config.get("serve_max_concurrent"))
        self._max_concurrent = int(max_concurrent)
        # the durable shuffle tier (a shuffle.store.ShuffleStore), when
        # the owner installed one; ``epoch`` is its fencing stamp,
        # plumbed to every session
        self.store = store
        self.epoch = int(epoch)
        self._slots = _PrioritySlots(self._max_concurrent)
        self._task_id_base = int(task_id_base)
        self._ids = itertools.count(1)
        self._admit_seq = itertools.count(1)
        self._lock = threading.Lock()
        self._sessions: list = []
        self._shutdown = False
        self._shutdown_done = threading.Event()
        self._shutdown_result: Optional[bool] = None
        # arm the watchdog's cross-tenant stall breaker (no-op with no
        # adaptor installed; 0 disables)
        self._stall_ms = float(config.get("serve_stall_break_ms"))
        if self._stall_ms > 0:
            RmmSpark.set_stall_break_ms(self._stall_ms)
        self._lane = _DrainLane()
        shuffle_service.install_drain_lane(self._lane)

    # -- public API -----------------------------------------------------
    def submit(self, query_fn: Callable, est_bytes: int = 0, tenant=None,
               timeout_s: Optional[float] = None,
               priority: int = 0) -> TenantSession:
        """Queue ``query_fn`` for admission and return its session.

        ``query_fn(ctx)`` (or ``query_fn(ctx, session)``) runs on a
        dedicated worker thread inside the session's ``TaskContext``;
        ``est_bytes`` is the footprint admission charges through the
        retry ladder; ``timeout_s`` kills-and-re-admits per the
        ``serve_max_readmissions`` budget; ``priority`` is the SLA
        class — higher classes overtake the admission queue and keep
        spill-store residency longer."""
        # benign race: monotonic flag — a submit that slips past a
        # concurrent shutdown is cancelled by the drain it races
        if self._shutdown:
            raise ServeError("runtime is shut down")
        sid = next(self._ids)
        sess = TenantSession(self, sid, self._task_id_base + sid, tenant,
                             query_fn, est_bytes, timeout_s,
                             priority=priority, store=self.store,
                             epoch=self.epoch)
        with self._lock:
            self._sessions.append(sess)
        t = threading.Thread(target=self._run_session, args=(sess,),
                             name=f"serve-{sess.task_id}", daemon=True)
        sess._thread = t
        t.start()
        return sess

    def cancel(self, sess: TenantSession, reason: str = "cancelled"):
        """Kill-safe cancellation, honored wherever the session is:
        queued (next admission tick), mid-ladder (``cancel_check``),
        parked in BLOCKED/BUFN (``task_done`` wakes the thread with
        REMOVE_THROW → UnknownThreadError), or mid-shuffle-round (the
        lane thread's charges fail the same way)."""
        if sess._cancel_reason is None:
            sess._cancel_reason = reason
        sess._cancelled.set()
        # releasing the task is what reaches threads parked inside the
        # native arena; it also re-runs the deadlock scan for survivors
        RmmSpark.task_done(sess.task_id)

    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions)

    def queue_depth(self) -> int:
        """How many admissions are waiting on a slot right now (the
        load signal a fleet's placement reads)."""
        return self._slots.waiting()

    def shutdown(self, timeout_s: float = 10.0) -> bool:
        """Cancel every live session, drain the lane, disarm the stall
        breaker.  Returns True when every worker unwound in time.

        Idempotent: only the first call does the teardown; a second (or
        racing) call waits for it and returns the first call's result
        instead of re-walking closed sessions."""
        with self._lock:
            first = not self._shutdown
            self._shutdown = True
        if not first:
            self._shutdown_done.wait(timeout_s)
            return bool(self._shutdown_result)
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            if not s._done.is_set():
                self.cancel(s, reason="shutdown")
        deadline = time.monotonic() + timeout_s
        for s in sessions:
            s._done.wait(max(0.0, deadline - time.monotonic()))
        shuffle_service.clear_drain_lane()
        self._lane.close()
        if self._stall_ms > 0:
            RmmSpark.set_stall_break_ms(0.0)
        ok = True
        for s in sessions:
            if s._thread is not None:
                s._thread.join(max(0.0, deadline - time.monotonic()) + 1.0)
                ok = ok and not s._thread.is_alive()
        self._shutdown_result = ok
        self._shutdown_done.set()
        return ok

    # -- worker ---------------------------------------------------------
    def _run_session(self, sess: TenantSession):
        try:
            self._session_loop(sess)
        finally:
            sess._done.set()

    def _session_loop(self, sess: TenantSession):
        max_readmissions = int(config.get("serve_max_readmissions"))
        backoff_s = float(config.get("serve_backoff_ms")) / 1000.0
        readmissions = 0
        while True:
            sess.attempts += 1
            try:
                self._run_once(sess)
                return
            except (QueryCancelled, UnknownThreadError) as e:
                reason = sess._cancel_reason or "cancelled"
                if reason == "timeout" and readmissions < max_readmissions:
                    # bounded re-admission: back off and try again with a
                    # fresh kill flag and a fresh deadline
                    readmissions += 1
                    sess._rearm()
                    sess.status = "queued"
                    # the backoff waits on the FRESH kill flag: an
                    # external cancel arriving mid-backoff unwinds on
                    # the next _run_once's cancel check instead of
                    # sleeping out the remaining backoff first
                    sess._cancelled.wait(backoff_s * (2 ** (readmissions - 1)))
                    continue
                if reason == "timeout":
                    sess.status = "timeout"
                    sess.error = QueryTimeout(
                        f"session {sess.session_id} exceeded "
                        f"{sess.timeout_s}s ({readmissions} re-admissions)")
                else:
                    sess.status = "cancelled"
                    sess.error = (e if isinstance(e, QueryCancelled)
                                  else QueryCancelled(str(e), reason=reason))
                return
            except faultinj.TaskCancelled as e:
                # injected tenant kill: by contract identical to an
                # external cancel landing at that boundary
                sess.status = "cancelled"
                sess.error = e
                return
            except QueryTimeout as e:  # admission queue wait expired
                sess.status = "timeout"
                sess.error = e
                return
            except BaseException as e:
                sess.status = "failed"
                sess.error = e
                return

    def _run_once(self, sess: TenantSession):
        sess._check_cancelled()
        ticket = self._admit(sess)
        fw = spill_mod.get_framework()
        cache = get_plan_cache()
        timer: Optional[threading.Timer] = None
        try:
            if sess.timeout_s:
                timer = threading.Timer(
                    sess.timeout_s, self.cancel, args=(sess,),
                    kwargs={"reason": "timeout"})
                timer.daemon = True
                timer.start()
            with TaskContext(sess.task_id) as ctx:
                if fw is not None:
                    # eviction rank: SLA class dominates (a lower class
                    # always evicts before a higher one), admission
                    # order breaks ties — earlier-admitted tenants in
                    # the same class keep residency longer
                    fw.store.set_task_priority(
                        sess.task_id,
                        float(sess.priority) * 1e6
                        - float(next(self._admit_seq)))
                self._reserve(sess, ctx)
                sess.status = "running"

                def step():
                    _step_probe()
                    sess._check_cancelled()
                    return self._invoke(sess, ctx)

                out = run_with_retry(step,
                                     cancel_check=sess._check_cancelled)
                sess.result_value = out
            sess.status = "done"
        finally:
            # the kill-safe unwind, shared by every exit path: by here
            # TaskContext.__exit__ already closed adopted spill handles
            # (disk files deleted) and drained the arena charges
            if timer is not None:
                timer.cancel()
            cache.release_owner(sess.pin_owner)
            if fw is not None:
                fw.store.clear_task_priority(sess.task_id)
            RmmSpark.task_done(sess.task_id)
            ticket.release()

    @staticmethod
    def _invoke(sess: TenantSession, ctx: TaskContext):
        try:
            n_params = len(inspect.signature(sess.query_fn).parameters)
        except (TypeError, ValueError):
            n_params = 1
        if n_params >= 2:
            return sess.query_fn(ctx, sess)
        return sess.query_fn(ctx)

    def _admit(self, sess: TenantSession) -> AdmissionTicket:
        _admit_probe()  # chaos boundary: a kill while still queued
        timeout_s = float(config.get("serve_admit_timeout_s"))
        deadline = time.monotonic() + timeout_s
        # the queue wait is a HOST-side block: bracket it so the native
        # deadlock scan counts queued tenants as blocked.  The session
        # stays enqueued by (priority, arrival) for the whole wait —
        # re-admissions keep their original arrival rank.
        with ThreadStateRegistry.blocked_section():
            got = self._slots.acquire(sess.priority, sess.session_id,
                                      deadline, sess._check_cancelled)
        if got:
            sess.status = "admitted"
            return AdmissionTicket(self._slots, sess)
        raise QueryTimeout(
            f"session {sess.session_id}: admission queue wait "
            f"exceeded {timeout_s:g}s")

    def _reserve(self, sess: TenantSession, ctx: TaskContext):
        """Prove the estimated footprint fits NOW, through the full
        ladder: park in BUFN, spill idle tenants, or split the
        reservation (halving ``granted_bytes``).  The probe charge is
        returned on success — actual residency is accounted by the
        query's own charges."""
        est = sess.est_bytes
        if est <= 0:
            sess.granted_bytes = 0
            return
        granted = [est]

        def probe():
            return ctx.charge(granted[0])

        def split():
            granted[0] = max(granted[0] // 2, _MIN_GRANT)

        n = run_with_retry(probe, split=split, max_retries=16,
                           cancel_check=sess._check_cancelled)
        ctx.release(n)
        sess.granted_bytes = granted[0]
