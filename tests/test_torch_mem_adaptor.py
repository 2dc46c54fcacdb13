"""PyTorch port: the retry/block/split memory arena (``mem/``) against the
JAX package's (``spark_rapids_jni_tpu/mem``).

* The native state machine: each scenario of the reference's
  ``tests/test_mem_adaptor.py`` (scripted task threads driven through
  BLOCKED/BUFN/split states, with state polling) runs once on each
  package's adaptor; the states, raised exception types and metrics it
  records must be the same step for step, and both must meet the
  reference test's expectations.  The CSV transition logs of one scripted
  sequence must be line for line the same (times and thread ids aside).
* The seeded Monte-Carlo oversubscription fuzz on the port.
* The executor: ``batch_nbytes``, ``TaskContext``, the ``run_with_retry``
  ladder, the translation of a real ``torch.OutOfMemoryError``, and the
  q6 step under injected OOMs against the reference's q6 under the same
  injections.

Each package builds its own library once per process (module fixture);
the port's comes from ``spark_rapids_jni_tpu_torch/mem/native`` into
``_kernels_build/``.
"""

import os
import queue
import random
import threading
import time
import types
import weakref

import jax
import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu.mem import executor as ref_executor
from spark_rapids_jni_tpu.mem import rmm_spark as ref_rmm

from spark_rapids_jni_tpu_torch import pipelines as PL
from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column, ColumnBatch, Decimal128Column, StringColumn, StructColumn)
from spark_rapids_jni_tpu_torch.mem import executor as port_executor
from spark_rapids_jni_tpu_torch.mem import rmm_spark as port_rmm
from spark_rapids_jni_tpu_torch.ops import _build

MB = 1 << 20
FLOAT_RTOL = 1e-5


def _pkg(rmm, executor):
    names = ("SparkResourceAdaptor", "RmmSpark", "RetryOOM",
             "SplitAndRetryOOM", "OOMError", "InjectedException",
             "CpuRetryOOM", "CpuSplitAndRetryOOM", "ThreadState",
             "UnknownThreadError")
    ns = {n: getattr(rmm, n) for n in names}
    for n in ("TaskContext", "run_with_retry", "batch_nbytes"):
        ns[n] = getattr(executor, n)
    return types.SimpleNamespace(**ns)


REF = _pkg(ref_rmm, ref_executor)
PORT = _pkg(port_rmm, port_executor)


@pytest.fixture(scope="module")
def libs():
    """Both native libraries, built (or found built) once per process."""
    return ref_rmm._load_lib(), port_rmm._load_lib()


def poll_for_state(adaptor, tid, want, timeout=5.0):
    """RmmSparkTest.pollForState equivalent."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        s = adaptor.get_state_of(tid)
        if s == want:
            return s
        time.sleep(0.005)
    return adaptor.get_state_of(tid)


class TaskThread(threading.Thread):
    """Scriptable worker: feed it closures, read results (RmmSparkTest's
    TaskThread op-queue pattern, as in the reference's test file)."""

    def __init__(self, adaptor, task_id, dedicated=True, shuffle=False):
        super().__init__(daemon=True)
        self.adaptor = adaptor
        self.task_id = task_id
        self.dedicated = dedicated
        self.shuffle = shuffle
        self.ops = queue.Queue()
        self.results = queue.Queue()
        self.tid = None
        self._ready = threading.Event()
        self.start()
        self._ready.wait(5.0)

    def run(self):
        self.tid = threading.get_ident()
        if self.dedicated:
            self.adaptor.start_dedicated_task_thread(self.task_id)
        else:
            self.adaptor.pool_thread_working_on_tasks(
                self.shuffle, [self.task_id])
        self._ready.set()
        while True:
            fn = self.ops.get()
            if fn is None:
                return
            try:
                self.results.put(("ok", fn()))
            except BaseException as e:  # noqa: BLE001 - test harness
                self.results.put(("exc", e))

    def do(self, fn):
        self.ops.put(fn)

    def expect(self, timeout=10.0):
        """The next result's kind: ``"ok"`` or the exception's type name
        (the same in both packages)."""
        kind, val = self.results.get(timeout=timeout)
        return "ok" if kind == "ok" else type(val).__name__

    def finish(self):
        self.ops.put(None)
        self.join(timeout=5.0)
        assert not self.is_alive()


# ---------------------------------------------------------------------------
# native scenarios: each a script over one package, recording its trace
# ---------------------------------------------------------------------------

def _with_adaptor(script):
    """Run ``script(P, adaptor, rec)`` on a fresh 10 MiB adaptor with a
    20 ms watchdog (the reference test file's ``adaptor`` fixture)."""
    def run(P, rec):
        a = P.SparkResourceAdaptor(10 * MB, poll_ms=20.0)
        try:
            script(P, a, rec)
        finally:
            a.close()
    run.__name__ = script.__name__
    return run


def _rec_expect(rec, label, got, want):
    rec(label, got)
    assert got == want, (label, got, want)


@_with_adaptor
def basics_alloc_dealloc_metrics(P, a, rec):
    t = TaskThread(a, 1)
    t.do(lambda: a.allocate(4 * MB, tid=t.tid))
    _rec_expect(rec, "alloc", t.expect(), "ok")
    _rec_expect(rec, "total", a.total_allocated(), 4 * MB)
    t.do(lambda: a.deallocate(4 * MB, tid=t.tid))
    _rec_expect(rec, "dealloc", t.expect(), "ok")
    _rec_expect(rec, "total", a.total_allocated(), 0)
    _rec_expect(rec, "max", a.get_max_memory_allocated(1), 4 * MB)
    t.finish()


@_with_adaptor
def basics_unregistered_thread_raises(P, a, rec):
    with pytest.raises(RuntimeError) as e:
        a.allocate(MB)  # calling thread never registered
    _rec_expect(rec, "raised", type(e.value).__name__, "UnknownThreadError")


@_with_adaptor
def basics_state_polling(P, a, rec):
    t = TaskThread(a, 1)
    _rec_expect(rec, "state",
                poll_for_state(a, t.tid, P.ThreadState.RUNNING).name,
                "RUNNING")
    t.finish()


@_with_adaptor
def blocking_second_task_blocks_until_free(P, a, rec):
    x, y = TaskThread(a, 1), TaskThread(a, 2)
    x.do(lambda: a.allocate(8 * MB, tid=x.tid))
    _rec_expect(rec, "x alloc", x.expect(), "ok")
    y.do(lambda: a.allocate(4 * MB, tid=y.tid))  # only 2 MiB free
    _rec_expect(rec, "y state",
                poll_for_state(a, y.tid, P.ThreadState.BLOCKED).name,
                "BLOCKED")
    x.do(lambda: a.deallocate(8 * MB, tid=x.tid))
    _rec_expect(rec, "x free", x.expect(), "ok")
    _rec_expect(rec, "y alloc", y.expect(), "ok")
    _rec_expect(rec, "y blocked time > 0",
                a.get_and_reset_block_time_ns(2) > 0, True)
    x.finish()
    y.finish()


@_with_adaptor
def blocking_deadlock_breaks_lowest_priority(P, a, rec):
    x, y = TaskThread(a, 1), TaskThread(a, 2)
    x.do(lambda: a.allocate(5 * MB, tid=x.tid))
    y.do(lambda: a.allocate(5 * MB, tid=y.tid))
    _rec_expect(rec, "x", x.expect(), "ok")
    _rec_expect(rec, "y", y.expect(), "ok")
    x.do(lambda: a.allocate(2 * MB, tid=x.tid))
    y.do(lambda: a.allocate(2 * MB, tid=y.tid))
    # task 2 is younger -> lower priority -> it gets RetryOOM
    _rec_expect(rec, "y over-ask", y.expect(), "RetryOOM")
    y.do(lambda: a.deallocate(5 * MB, tid=y.tid))
    _rec_expect(rec, "y rollback", y.expect(), "ok")
    _rec_expect(rec, "x over-ask", x.expect(), "ok")
    _rec_expect(rec, "retries(2) >= 1", a.get_and_reset_num_retry(2) >= 1,
                True)
    x.finish()
    y.finish()


@_with_adaptor
def blocking_split_and_retry_when_all_bufn(P, a, rec):
    x, y = TaskThread(a, 1), TaskThread(a, 2)
    x.do(lambda: a.allocate(5 * MB, tid=x.tid))
    y.do(lambda: a.allocate(5 * MB, tid=y.tid))
    _rec_expect(rec, "x", x.expect(), "ok")
    _rec_expect(rec, "y", y.expect(), "ok")
    x.do(lambda: a.allocate(2 * MB, tid=x.tid))
    y.do(lambda: a.allocate(2 * MB, tid=y.tid))
    _rec_expect(rec, "y over-ask", y.expect(), "RetryOOM")
    # y parks in BUFN with nothing freed: x is handed a RetryOOM too
    y.do(lambda: a.block_thread_until_ready(tid=y.tid))
    _rec_expect(rec, "x over-ask", x.expect(), "RetryOOM")
    # every task BUFN: the oldest is told to split
    x.do(lambda: a.block_thread_until_ready(tid=x.tid))
    _rec_expect(rec, "x park", x.expect(), "SplitAndRetryOOM")
    _rec_expect(rec, "split(1) >= 1",
                a.get_and_reset_num_split_retry(1) >= 1, True)
    x.do(lambda: a.deallocate(5 * MB, tid=x.tid))
    _rec_expect(rec, "x free", x.expect(), "ok")
    x.do(lambda: a.allocate(1 * MB, tid=x.tid))
    _rec_expect(rec, "x half", x.expect(), "ok")
    _rec_expect(rec, "y rescued", y.expect(), "ok")
    x.finish()
    y.finish()


@_with_adaptor
def blocking_shuffle_thread_outranks_tasks(P, a, rec):
    x = TaskThread(a, 1)
    s = TaskThread(a, 2, dedicated=False, shuffle=True)
    x.do(lambda: a.allocate(9 * MB, tid=x.tid))
    _rec_expect(rec, "x", x.expect(), "ok")
    s.do(lambda: a.allocate(2 * MB, tid=s.tid))
    _rec_expect(rec, "s state",
                poll_for_state(a, s.tid, P.ThreadState.BLOCKED).name,
                "BLOCKED")
    x.do(lambda: a.deallocate(9 * MB, tid=x.tid))
    _rec_expect(rec, "x free", x.expect(), "ok")
    _rec_expect(rec, "s", s.expect(), "ok")
    x.finish()
    s.finish()


@_with_adaptor
def injection_force_retry_oom_count_skip(P, a, rec):
    t = TaskThread(a, 1)
    a.force_retry_oom(t.tid, num_ooms=2, skip_count=1)
    t.do(lambda: a.allocate(MB, tid=t.tid))  # skipped
    _rec_expect(rec, "skipped", t.expect(), "ok")
    for i in range(2):
        t.do(lambda: a.allocate(MB, tid=t.tid))
        _rec_expect(rec, f"inject {i}", t.expect(), "RetryOOM")
        t.do(lambda: a.block_thread_until_ready(tid=t.tid))
        _rec_expect(rec, f"park {i}", t.expect(), "ok")
    t.do(lambda: a.allocate(MB, tid=t.tid))  # injection exhausted
    _rec_expect(rec, "exhausted", t.expect(), "ok")
    _rec_expect(rec, "retries", a.get_and_reset_num_retry(1), 2)
    t.finish()


@_with_adaptor
def injection_force_split_and_exception(P, a, rec):
    t = TaskThread(a, 1)
    a.force_split_and_retry_oom(t.tid, num_ooms=1)
    t.do(lambda: a.allocate(MB, tid=t.tid))
    _rec_expect(rec, "split", t.expect(), "SplitAndRetryOOM")
    a.force_exception(t.tid, num_times=1)
    t.do(lambda: a.allocate(MB, tid=t.tid))
    _rec_expect(rec, "exception", t.expect(), "InjectedException")
    _rec_expect(rec, "splits", a.get_and_reset_num_split_retry(1), 1)
    t.finish()


@_with_adaptor
def retry_cap_oversized_request(P, a, rec):
    """A task asking for more than the pool ends in an OOM, not a hang."""
    t = TaskThread(a, 1)
    t.do(lambda: a.allocate(11 * MB, tid=t.tid))
    got = t.expect(timeout=30.0)
    rec("oversized", got)
    assert got in ("OOMError", "RetryOOM", "SplitAndRetryOOM")
    t.finish()


@_with_adaptor
def task_done_wakes_blocked_thread(P, a, rec):
    runner = TaskThread(a, 1)  # stays RUNNING: no global deadlock scan
    runner.do(lambda: a.allocate(1 * MB, tid=runner.tid))
    _rec_expect(rec, "runner", runner.expect(), "ok")
    victim = TaskThread(a, 2)
    victim.do(lambda: a.allocate(20 * MB, tid=victim.tid))
    _rec_expect(rec, "victim state",
                poll_for_state(a, victim.tid, P.ThreadState.BLOCKED).name,
                "BLOCKED")
    a.task_done(2)  # the external kill path
    _rec_expect(rec, "victim", victim.expect(timeout=5.0),
                "UnknownThreadError")
    _rec_expect(rec, "released", a.get_state_of(victim.tid).name, "UNKNOWN")
    victim.finish()
    runner.do(lambda: a.deallocate(1 * MB, tid=runner.tid))
    _rec_expect(rec, "runner free", runner.expect(), "ok")
    runner.finish()
    _rec_expect(rec, "total", a.total_allocated(), 0)


@_with_adaptor
def task_done_wakes_bufn_parked_thread(P, a, rec):
    x, y = TaskThread(a, 1), TaskThread(a, 2)
    x.do(lambda: a.allocate(8 * MB, tid=x.tid))
    _rec_expect(rec, "x", x.expect(), "ok")
    y.do(lambda: a.allocate(4 * MB, tid=y.tid))
    _rec_expect(rec, "y state",
                poll_for_state(a, y.tid, P.ThreadState.BLOCKED).name,
                "BLOCKED")
    x.do(lambda: a.allocate(4 * MB, tid=x.tid))
    _rec_expect(rec, "y over-ask", y.expect(), "RetryOOM")
    _rec_expect(rec, "x over-ask", x.expect(), "RetryOOM")
    x.do(lambda: a.allocate(1 * MB, tid=x.tid))
    _rec_expect(rec, "x small", x.expect(), "ok")
    y.do(lambda: a.block_thread_until_ready(tid=y.tid))
    _rec_expect(rec, "y parked",
                poll_for_state(a, y.tid, P.ThreadState.BUFN).name, "BUFN")
    a.task_done(2)  # kill while BUFN-parked
    _rec_expect(rec, "y", y.expect(timeout=5.0), "UnknownThreadError")
    _rec_expect(rec, "released", a.get_state_of(y.tid).name, "UNKNOWN")
    y.finish()
    x.do(lambda: a.deallocate(9 * MB, tid=x.tid))
    _rec_expect(rec, "x free", x.expect(), "ok")
    x.finish()
    _rec_expect(rec, "total", a.total_allocated(), 0)


@_with_adaptor
def break_stalled_cycles_subset_stall(P, a, rec):
    runner = TaskThread(a, 1)  # unrelated tenant, keeps running
    runner.do(lambda: a.allocate(1 * MB, tid=runner.tid))
    _rec_expect(rec, "runner", runner.expect(), "ok")
    stuck = TaskThread(a, 2)
    stuck.do(lambda: a.allocate(20 * MB, tid=stuck.tid))
    _rec_expect(rec, "stuck state",
                poll_for_state(a, stuck.tid, P.ThreadState.BLOCKED).name,
                "BLOCKED")
    _rec_expect(rec, "too young", a.break_stalled_cycles(stall_ms=60_000),
                False)
    time.sleep(0.06)  # older than the 50 ms stall bound below
    _rec_expect(rec, "broken", a.break_stalled_cycles(stall_ms=50), True)
    _rec_expect(rec, "stuck", stuck.expect(timeout=5.0), "RetryOOM")
    _rec_expect(rec, "retries(2) >= 1", a.get_and_reset_num_retry(2) >= 1,
                True)
    stuck.finish()
    runner.do(lambda: a.deallocate(1 * MB, tid=runner.tid))
    _rec_expect(rec, "runner free", runner.expect(), "ok")
    runner.finish()


def cpu_arena_flavored_oom(P, rec):
    """The legacy second adaptor for host memory: Cpu* flavors."""
    P.RmmSpark.set_event_handler(8 * MB)
    P.RmmSpark.set_cpu_event_handler(1 * MB)
    try:
        P.RmmSpark.current_thread_is_dedicated_to_task(1)
        P.RmmSpark.cpu_allocate(512 << 10)
        P.RmmSpark.cpu_deallocate(512 << 10)
        P.RmmSpark._c().force_retry_oom(None)
        with pytest.raises(P.CpuRetryOOM) as e:
            P.RmmSpark.cpu_allocate(1)
        _rec_expect(rec, "raised", type(e.value).__name__, "CpuRetryOOM")
        P.RmmSpark.remove_current_thread_association()
    finally:
        P.RmmSpark.clear_event_handler()


def unified_cross_arena_deadlock_is_broken(P, rec):
    """One state machine for both pools: a thread blocked on HOST memory
    while holding DEVICE budget is seen by the deadlock scan."""
    R = P.RmmSpark
    R.set_event_handler(MB, host_pool_bytes=MB)
    try:
        barrier = threading.Barrier(2)
        results = {}

        def t1_fn():  # task 1: holds HOST, blocks on DEVICE
            R.current_thread_is_dedicated_to_task(1)
            R.cpu_allocate(900 << 10)
            barrier.wait()
            R.allocate(900 << 10)  # parks until t2 rolls back
            R.deallocate(900 << 10)
            R.cpu_deallocate(900 << 10)
            results[1] = "ok"
            R.remove_current_thread_association()

        def t2_fn():  # task 2: holds DEVICE, blocks on HOST -> the victim
            R.current_thread_is_dedicated_to_task(2)
            R.allocate(900 << 10)
            barrier.wait()
            try:
                R.cpu_allocate(900 << 10)
                results[2] = "no-escalation"
            except P.CpuRetryOOM:
                results["escalated"] = True
                R.deallocate(900 << 10)  # roll back device
                try:
                    R.cpu_block_thread_until_ready()
                except (P.CpuRetryOOM, P.CpuSplitAndRetryOOM):
                    pass  # the sole runner may be told to split: retry
                R.cpu_allocate(900 << 10)
                R.cpu_deallocate(900 << 10)
                results[2] = "recovered"
            R.remove_current_thread_association()

        t1 = threading.Thread(target=t1_fn, daemon=True)
        t2 = threading.Thread(target=t2_fn, daemon=True)
        t1.start()
        t2.start()
        t1.join(timeout=30)
        t2.join(timeout=30)
        assert not t1.is_alive() and not t2.is_alive(), results
        _rec_expect(rec, "results", sorted(results.items(), key=str),
                    sorted({1: "ok", 2: "recovered",
                            "escalated": True}.items(), key=str))
        R.task_done(1)
        R.task_done(2)
        _rec_expect(rec, "retries(2) >= 1",
                    R._a().get_and_reset_num_retry(2) >= 1, True)
    finally:
        R.clear_event_handler()


def unified_host_pool_flavors(P, rec):
    P.RmmSpark.set_event_handler(1 << 20, host_pool_bytes=1 << 16)
    try:
        with P.TaskContext(3):
            P.RmmSpark.cpu_allocate(1 << 15)
            _rec_expect(rec, "host total",
                        P.RmmSpark._a().host_total_allocated(), 1 << 15)
            with pytest.raises(P.CpuRetryOOM) as e:
                P.RmmSpark.cpu_allocate(1 << 16)  # over the host pool
            _rec_expect(rec, "raised", type(e.value).__name__, "CpuRetryOOM")
            P.RmmSpark.cpu_deallocate(1 << 15)
        P.RmmSpark.task_done(3)
        _rec_expect(rec, "host total", P.RmmSpark._a().host_total_allocated(),
                    0)
    finally:
        P.RmmSpark.clear_event_handler()


SCENARIOS = {
    "TestBasics.test_alloc_dealloc_metrics": basics_alloc_dealloc_metrics,
    "TestBasics.test_unregistered_thread_raises":
        basics_unregistered_thread_raises,
    "TestBasics.test_state_polling": basics_state_polling,
    "TestBlocking.test_second_task_blocks_until_free":
        blocking_second_task_blocks_until_free,
    "TestBlocking.test_deadlock_breaks_lowest_priority":
        blocking_deadlock_breaks_lowest_priority,
    "TestBlocking.test_split_and_retry_when_all_bufn":
        blocking_split_and_retry_when_all_bufn,
    "TestBlocking.test_shuffle_thread_outranks_tasks":
        blocking_shuffle_thread_outranks_tasks,
    "TestInjection.test_force_retry_oom_count_skip":
        injection_force_retry_oom_count_skip,
    "TestInjection.test_force_split_and_exception":
        injection_force_split_and_exception,
    "TestRetryCap.test_oversized_request_hard_ooms":
        retry_cap_oversized_request,
    "TestTaskDoneReleasesParkedThreads.test_task_done_wakes_blocked_thread":
        task_done_wakes_blocked_thread,
    "TestTaskDoneReleasesParkedThreads.test_task_done_wakes_bufn_parked_"
    "thread": task_done_wakes_bufn_parked_thread,
    "TestBreakStalledCycles.test_subset_stall_is_broken":
        break_stalled_cycles_subset_stall,
    "TestCpuArena.test_cpu_flavored_oom": cpu_arena_flavored_oom,
    "TestUnifiedArenaDeadlock.test_cross_arena_deadlock_is_broken":
        unified_cross_arena_deadlock_is_broken,
    "TestUnifiedArenaDeadlock.test_unified_host_pool_flavors":
        unified_host_pool_flavors,
}


def _trace(P, script):
    trace = []
    script(P, lambda label, value: trace.append((label, value)))
    return trace


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_native_scenario_matches_reference(libs, name):
    ref = _trace(REF, SCENARIOS[name])
    port = _trace(PORT, SCENARIOS[name])
    assert port == ref


def _log_lines(path):
    """The CSV log without its time column, thread ids numbered in order
    of appearance."""
    ids = {}
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for ln in lines[1:]:
        _ns, op, tid, *rest = ln.split(",")
        out.append(",".join([op, str(ids.setdefault(tid, len(ids))),
                             *rest]))
    return lines[0], out


def test_transition_log_matches_reference(libs, tmp_path):
    """The CSV transition log (reference :897-933) of one scripted
    sequence: a block and its wake, then an injected retry."""
    logs = {}
    for label, P in (("ref", REF), ("port", PORT)):
        path = str(tmp_path / f"{label}.csv")
        a = P.SparkResourceAdaptor(10 * MB, log_path=path, poll_ms=50.0)
        try:
            x, y = TaskThread(a, 1), TaskThread(a, 2)
            x.do(lambda: a.allocate(8 * MB, tid=x.tid))
            assert x.expect() == "ok"
            y.do(lambda: a.allocate(4 * MB, tid=y.tid))
            assert poll_for_state(a, y.tid, P.ThreadState.BLOCKED) \
                == P.ThreadState.BLOCKED
            x.do(lambda: a.deallocate(8 * MB, tid=x.tid))
            assert x.expect() == "ok"
            assert y.expect() == "ok"
            a.force_retry_oom(x.tid, num_ooms=1)
            x.do(lambda: a.allocate(MB, tid=x.tid))
            assert x.expect() == "RetryOOM"
            x.do(lambda: a.block_thread_until_ready(tid=x.tid))
            assert x.expect() == "ok"
            for t in (x, y):
                t.finish()
        finally:
            a.close()
        logs[label] = _log_lines(path)
    header, lines = logs["port"]
    assert header.startswith("time_ns,op,")
    assert any("alloc_ok" in ln for ln in lines)
    assert any("woken" in ln for ln in lines)
    assert logs["port"] == logs["ref"]


@pytest.mark.parametrize(
    "seed", [int(s) for s in
             os.environ.get("MEM_FUZZ_SEEDS", "11,42").split(",")])
def test_monte_carlo_oversubscribed_tasks_all_complete(libs, seed):
    """The reference's seeded oversubscription fuzz (RmmSparkMonteCarlo
    semantics: task max 2 MiB against a 3 MiB pool, 6 tasks) on the
    port's adaptor: every task completes, nothing deadlocks, the arena
    drains."""
    pool, task_max, n_tasks = 3 * MB, 2 * MB, 6
    adaptor = port_rmm.SparkResourceAdaptor(pool, poll_ms=10.0)
    failures = []
    retries = [0]

    def task_fn(task_id):
        rng = random.Random(seed * 1000 + task_id)
        adaptor.start_dedicated_task_thread(task_id)
        held = []
        try:
            ops = 0
            budget = task_max
            while ops < 40:
                want = rng.randrange(1, max(2, budget // 4))
                try:
                    adaptor.allocate(want)
                    held.append(want)
                    ops += 1
                    if rng.random() < 0.4 and held:
                        adaptor.deallocate(held.pop(rng.randrange(len(held))))
                    if sum(held) > task_max - want:
                        while held:
                            adaptor.deallocate(held.pop())
                except port_rmm.SplitAndRetryOOM:
                    retries[0] += 1
                    while held:
                        adaptor.deallocate(held.pop())
                    budget = max(budget // 2, 4)
                except port_rmm.RetryOOM:
                    retries[0] += 1
                    while held:
                        adaptor.deallocate(held.pop())
                    try:
                        adaptor.block_thread_until_ready()
                    except port_rmm.SplitAndRetryOOM:
                        budget = max(budget // 2, 4)
                    except port_rmm.RetryOOM:
                        pass
            while held:
                adaptor.deallocate(held.pop())
        except BaseException as e:  # noqa: BLE001
            failures.append((task_id, e))
        finally:
            adaptor.task_done(task_id)

    threads = [threading.Thread(target=task_fn, args=(i + 1,), daemon=True)
               for i in range(n_tasks)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120.0  # generous: CI boxes are noisy
    for th in threads:
        th.join(timeout=max(0.1, deadline - time.monotonic()))
    alive = [th for th in threads if th.is_alive()]
    states = [adaptor.get_state_of(tid=th.ident) for th in threads]
    total = adaptor.total_allocated()
    adaptor.close()
    assert not alive, (f"deadlocked/livelocked threads: {len(alive)}, "
                       f"states={states}, retries={retries[0]}")
    assert not failures, failures
    assert total == 0
    assert adaptor._h is None


# ---------------------------------------------------------------------------
# the native build
# ---------------------------------------------------------------------------

def test_library_builds_into_kernels_build(libs):
    path = _build.build_host(port_rmm.LIB_SOURCE)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libresource_adaptor-")
    assert "spark_rapids_jni_tpu_torch" in port_rmm.LIB_SOURCE
    assert port_rmm._load_lib()._name == path


def test_failed_build_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error:"):
        _build.build_host(str(src))
    assert not os.path.exists(_build._host_lib_path(str(src)))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@pytest.fixture
def arena():
    port_rmm.RmmSpark.set_event_handler(64 * MB)
    try:
        yield port_rmm.RmmSpark
    finally:
        port_rmm.RmmSpark.clear_event_handler()


def _port_q6_shared_validity(k, v, price):
    """The port's q6 batch laid out as the reference's ``_example_batch``
    lays it out: one validity buffer shared by the three columns."""
    ones = torch.ones(k.shape[0], dtype=torch.bool)
    return ColumnBatch({
        "k": Column(torch.from_numpy(k), ones, TT.INT32),
        "v": Column(torch.from_numpy(v), ones, TT.INT64),
        "price": Column(torch.from_numpy(price), ones, TT.FLOAT64)})


def test_batch_nbytes_q6_matches_reference():
    n = 2048
    ref = ref_executor.batch_nbytes(ge._example_batch(n))
    assert ref == 21 * n  # k 4 + v 8 + price 8, one shared validity byte
    b = _port_q6_shared_validity(*PL.example_arrays(n))
    assert port_executor.batch_nbytes(b) == ref
    # the port's example_batch gives each column its own validity copy
    # (batch_from_numpy copies its inputs): two more bytes a row
    assert port_executor.batch_nbytes(PL.example_batch(n, device="cpu")) \
        == ref + 2 * n
    # a view is keyed by its own span, not its base's storage: the two
    # halves of a split batch charge half each and the whole together
    halves = [ColumnBatch({name: Column(c.data[sl], c.validity[sl], c.dtype)
                           for name, c in zip(b.names, b.columns)})
              for sl in (slice(0, n // 2), slice(n // 2, n))]
    assert [port_executor.batch_nbytes(h) for h in halves] == [ref // 2] * 2
    assert port_executor.batch_nbytes(halves) == ref


def test_batch_nbytes_string_decimal_struct_columns():
    s = StringColumn.from_pylist(["ab", None, "xyz"], max_len=4,
                                 device="cpu")
    d = Decimal128Column.from_unscaled([1, None, -3], 38, 2, device="cpu")
    st = StructColumn({"s": s, "again": s}, s.validity)
    # chars 3x4 + lengths 3x4 + validity 3; limbs 3x16 + validity 3;
    # the struct's validity and its second field are the string's buffers
    assert port_executor.batch_nbytes(ColumnBatch({"s": s, "d": d,
                                                   "st": st})) \
        == 12 + 12 + 3 + 48 + 3


def test_task_context_charges_and_releases(arena):
    tree = {"a": torch.zeros((1024,), dtype=torch.int32)}
    n = port_executor.batch_nbytes(tree)
    assert n == 4096
    with port_executor.TaskContext(1) as ctx:
        assert port_executor.current_task_id() == 1
        ctx.charge(tree)
        ctx.charge(100)
        assert arena._a().total_allocated() == n + 100
        ctx.release(100)
        assert arena._a().total_allocated() == n
    assert port_executor.current_task_id() is None
    assert arena._a().total_allocated() == 0  # exit released the rest
    arena.task_done(1)


def test_borrowed_task_attributes_pool_thread(arena):
    with port_executor.borrowed_task(5, shuffle=True):
        assert port_executor.current_task_id() == 5
        arena.allocate(1024)
        assert arena._a().get_max_memory_allocated(5) == 1024
        arena.deallocate(1024)
    assert port_executor.current_task_id() is None


def test_run_with_retry_ladder(arena):
    with port_executor.TaskContext(1):
        a = arena._a()
        a.force_retry_oom(None, num_ooms=1)
        a.force_split_and_retry_oom(None, num_ooms=1, skip_count=1)
        spilled, halved = [], []

        def step():
            arena.allocate(1024)
            arena.deallocate(1024)
            return "done"

        out = port_executor.run_with_retry(
            step, make_spillable=lambda: spilled.append(1),
            split=lambda: halved.append(1))
        assert out == "done" and spilled and halved
    arena.task_done(1)


def test_cancel_check_aborts_the_ladder(arena):
    calls = []

    def cancel():
        calls.append(1)
        if len(calls) > 1:
            raise KeyboardInterrupt("killed")

    with port_executor.TaskContext(1):
        arena.force_retry_oom(None, 1, 0)
        with pytest.raises(KeyboardInterrupt):
            port_executor.run_with_retry(lambda: arena.allocate(8),
                                         cancel_check=cancel)
    arena.task_done(1)
    assert len(calls) == 2


class TestRetryLadderInnerOOM:
    """The reference's cases: a RetryOOM raised from
    ``block_thread_until_ready()`` itself loops back through
    ``make_spillable``; an inner split is honoured; the loop is bounded."""

    def test_inner_retryoom_reruns_make_spillable(self, monkeypatch):
        spills, attempts, blocks = [], [], []

        def step():
            attempts.append(1)
            if len(attempts) < 3:
                raise port_rmm.RetryOOM("pressure")
            return "done"

        def make_spillable():
            spills.append(1)
            return 0  # nothing freed: the ladder must park

        def fake_block(*a, **k):
            blocks.append(1)
            if len(blocks) == 1:
                raise port_rmm.RetryOOM("woken for retry")

        monkeypatch.setattr(port_rmm.RmmSpark, "block_thread_until_ready",
                            staticmethod(fake_block))
        assert port_executor.run_with_retry(
            step, make_spillable=make_spillable) == "done"
        assert len(spills) >= 3
        assert len(blocks) >= 2

    def test_inner_split_still_honored(self, monkeypatch):
        attempts, splits = [], []

        def step():
            attempts.append(1)
            if len(attempts) == 1:
                raise port_rmm.RetryOOM("pressure")
            return len(attempts)

        def fake_block(*a, **k):
            raise port_rmm.SplitAndRetryOOM("split instead")

        monkeypatch.setattr(port_rmm.RmmSpark, "block_thread_until_ready",
                            staticmethod(fake_block))
        assert port_executor.run_with_retry(
            step, make_spillable=lambda: 0,
            split=lambda: splits.append(1)) == 2
        assert splits == [1]

    def test_inner_retryoom_bounded(self, monkeypatch):
        def step():
            raise port_rmm.RetryOOM("always")

        def fake_block(*a, **k):
            raise port_rmm.RetryOOM("always woken")

        monkeypatch.setattr(port_rmm.RmmSpark, "block_thread_until_ready",
                            staticmethod(fake_block))
        with pytest.raises(port_rmm.RetryOOM):
            port_executor.run_with_retry(step, make_spillable=lambda: 0,
                                         max_retries=3)


def _cuda_oom():
    """What the CUDA caching allocator raises (constructed: no card)."""
    return torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


class XlaRuntimeError(RuntimeError):
    """The reference's matcher keys on this type name."""


def test_is_device_oom_matcher():
    assert port_executor.is_device_oom(_cuda_oom())
    assert not port_executor.is_device_oom(MemoryError("out of memory"))
    assert not port_executor.is_device_oom(
        RuntimeError("CUDA out of memory"))
    assert not port_executor.is_device_oom(port_rmm.RetryOOM())
    assert not port_executor.is_device_oom(
        XlaRuntimeError("RESOURCE_EXHAUSTED: Out of memory"))


def test_without_adaptor_raw_error_propagates():
    err = _cuda_oom()

    def step():
        raise err

    with pytest.raises(torch.OutOfMemoryError) as got:
        port_executor.run_with_retry(step)
    assert got.value is err


def _real_oom_ladder(P, make_oom):
    """One task whose first attempt hits a real device OOM (each
    package's own kind), under the ladder with a split: the attempts, the
    splits and the native metrics it leaves."""
    P.RmmSpark.set_event_handler(1 << 20)
    try:
        calls = {"step": 0, "splits": 0}
        with P.TaskContext(21):
            def step():
                calls["step"] += 1
                if calls["step"] == 1:
                    raise make_oom()
                return "done"

            def split():
                calls["splits"] += 1

            out = P.run_with_retry(step, split=split)
        P.RmmSpark.task_done(21)
        a = P.RmmSpark._a()
        return (out, calls, a.get_and_reset_num_retry(21),
                a.get_and_reset_num_split_retry(21), a.total_allocated())
    finally:
        P.RmmSpark.clear_event_handler()


def test_real_oom_moves_native_retry_metric(libs):
    """A constructed ``torch.OutOfMemoryError`` goes through
    ``device_oom_observed``: on one thread the native protocol answers
    RetryOOM (the retry metric moves), the park turns into a split, and
    the step re-runs — the same path the reference takes for its XLA
    error."""
    port = _real_oom_ladder(PORT, _cuda_oom)
    ref = _real_oom_ladder(REF, lambda: XlaRuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 16777216 bytes"))
    assert port == ref
    out, calls, retries, splits, total = port
    assert out == "done" and calls == {"step": 2, "splits": 1}
    assert retries >= 1 and splits >= 1 and total == 0


def test_failed_attempt_tensor_is_freed_before_retry(arena):
    """The ladder's last error must not keep the failed attempt's frames
    (and with them its tensors) alive into the retry."""
    refs = []
    seen_alive = []

    def step():
        if refs:
            gc_free = refs[0]() is None
            seen_alive.append(not gc_free)
            return "done"
        scratch = torch.empty(1 << 16)
        refs.append(weakref.ref(scratch))
        raise _cuda_oom()

    with port_executor.TaskContext(9):
        out = port_executor.run_with_retry(step, split=lambda: None)
    arena.task_done(9)
    assert out == "done"
    assert seen_alive == [False]


def test_resize_pool_frees_budget():
    port_rmm.RmmSpark.set_event_handler(1 << 10)
    try:
        with port_executor.TaskContext(22) as ctx:
            ctx.charge(1 << 10)  # arena full
            port_rmm.RmmSpark._a().resize_pool(1 << 12)
            ctx.charge(1 << 11)  # now fits
            with pytest.raises(MemoryError):
                ctx.charge(1 << 12)  # beyond even the resized pool
        port_rmm.RmmSpark.task_done(22)
    finally:
        port_rmm.RmmSpark.clear_event_handler()


def test_sync_pool_with_device_cpu_is_none(arena):
    assert arena.sync_pool_with_device("cpu") is None


def test_metrics_scrapes(arena):
    assert isinstance(arena.shuffle_metrics(), dict)
    assert isinstance(arena.plan_cache_metrics(), dict)
    # no spill framework installed: the spill scrapes read zeros
    for scrape in (arena.spill_metrics,
                   lambda: arena.get_and_reset_task_spill_metrics(1)):
        got = scrape()
        assert got and not any(got.values())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        arena.fleet_metrics()


# ---------------------------------------------------------------------------
# q6 under injected OOMs: the port against the reference
# ---------------------------------------------------------------------------

def _ref_q6(b):
    res, ng = jax.jit(ge._q6_step)(b)
    jax.block_until_ready((res, ng))
    return res, ng


def _ref_groups(out):
    res, ng = out
    n = int(ng)
    cols = {name: res[name].to_pylist()[:n]
            for name in ("k", "sum_v", "cnt", "avg_price")}
    return {k: {c: cols[c][i] for c in ("sum_v", "cnt", "avg_price")}
            for i, k in enumerate(cols["k"])}


def _port_groups(out):
    return PL.result_groups(*out, "k")


def _q6_under_injection(P, make_batch, q6, groups):
    """The reference's ``TestPipelineUnderInjectedOOM`` recipe: one
    injected RetryOOM, then an injected SplitAndRetryOOM.  The split pass
    starts at 4096 rows so that its retry runs at 2048, the one shape the
    reference's q6 compiles."""
    P.RmmSpark.set_event_handler(64 << 20)
    try:
        state = {"rows": 2048, "splits": 0, "spills": 0}
        out = {}
        with P.TaskContext(7) as ctx:
            P.RmmSpark.force_retry_oom(None, 1, 0)

            def step():
                b = make_batch(state["rows"])
                n = ctx.charge(P.batch_nbytes(b))
                try:
                    return q6(b)
                finally:
                    ctx.release(n)

            def make_spillable():
                state["spills"] += 1

            def split():
                state["splits"] += 1
                state["rows"] //= 2

            out["retry_pass"] = groups(P.run_with_retry(step, make_spillable,
                                                        split))
            out["spills"] = state["spills"]
            state["rows"] = 4096
            P.RmmSpark.force_split_and_retry_oom(None, 1, 0)
            out["split_pass"] = groups(P.run_with_retry(step, make_spillable,
                                                        split))
            out["splits"], out["rows"] = state["splits"], state["rows"]
        P.RmmSpark.task_done(7)
        a = P.RmmSpark._a()
        out["num_retry"] = a.get_and_reset_num_retry(7)
        out["num_split_retry"] = a.get_and_reset_num_split_retry(7)
        out["total"] = a.total_allocated()
        return out
    finally:
        P.RmmSpark.clear_event_handler()


def _same_q6_groups(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g["sum_v"] == w["sum_v"] and g["cnt"] == w["cnt"], k
        assert abs(g["avg_price"] - w["avg_price"]) \
            <= FLOAT_RTOL * abs(w["avg_price"]), k


def test_q6_under_injection_matches_reference(libs):
    ref = _q6_under_injection(REF, ge._example_batch, _ref_q6, _ref_groups)
    port = _q6_under_injection(
        PORT, lambda n: PL.example_batch(n, device="cpu"), PL.q6_step,
        _port_groups)
    for p in ("retry_pass", "split_pass"):
        _same_q6_groups(port[p], ref[p])
    # and both equal the numpy oracle of the 2048-row batch
    uniq, sums, cnts, avgs = PL.q6_oracle(*PL.example_arrays(2048))
    want = {int(k): {"sum_v": int(s), "cnt": int(c), "avg_price": float(a)}
            for k, s, c, a in zip(uniq, sums, cnts, avgs)}
    _same_q6_groups(port["retry_pass"], want)
    _same_q6_groups(port["split_pass"], want)
    counts = ("spills", "splits", "rows", "num_retry", "num_split_retry",
              "total")
    assert {c: port[c] for c in counts} == {c: ref[c] for c in counts}
    assert port["spills"] == 1 and port["splits"] == 1
    assert port["num_retry"] >= 1 and port["num_split_retry"] >= 1
    assert port["total"] == 0
