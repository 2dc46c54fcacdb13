"""PyTorch port: the serving runtime (``serve/runtime.py``) against the
reference's ``tests/test_serve.py``, case for case, plus parity with the
JAX package's runtime.

Every case of the reference's file runs here against the port, with the
reference's fast settings (``serve_stall_break_ms`` 200, short
backoffs): admission over the arena, cross-tenant deadlock breaking,
kill-safe cancellation at every lifecycle point, bounded timeout
re-admission, priority admission, idempotent shutdown.  The drain-lane
case holds the port's lane exchange against the reference's
``exchange()`` on the same host data (8 shards, every row to one
partition, two rounds or more).  The slice as a whole: q6, q95 through
the hash join and q9 through ``plan.execute`` submitted to the port's
``ServeRuntime`` and to the reference's, at 2^12 rows, equal (ints and
counts exact, float means rel 1e-5, the reference's f32x3 tolerance).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu import plan as jplan
from spark_rapids_jni_tpu.mem import RmmSpark as JRmmSpark
from spark_rapids_jni_tpu.plan import queries as jq
from spark_rapids_jni_tpu.serve import ServeRuntime as JServeRuntime

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch import plan as tplan
from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
from spark_rapids_jni_tpu_torch.mem import (RetryOOM, RmmSpark,
                                            SplitAndRetryOOM)
from spark_rapids_jni_tpu_torch.plan import queries as tq
from spark_rapids_jni_tpu_torch.serve import (
    QueryCancelled,
    QueryTimeout,
    ServeRuntime,
)

from torch_parity import to_port
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5

MB = 1 << 20


@pytest.fixture
def arena():
    adaptor = RmmSpark.set_event_handler(10 * MB, poll_ms=20.0)
    yield adaptor
    RmmSpark.clear_event_handler()


@pytest.fixture
def runtime(arena):
    # fast stall breaker so cross-tenant cycle tests stay sub-second
    config.set("serve_stall_break_ms", 200.0)
    rt = ServeRuntime()
    yield rt
    rt.shutdown()
    config.reset("serve_stall_break_ms")


def _poll(pred, timeout=5.0, interval=0.005):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _deadlocking_tenant(hold, want, state, lock, barrier):
    """Charge ``hold``, rendezvous, then fight over ``want`` more.

    Exactly one tenant — the deadlock victim — rolls back (releases its
    hold and returns "victim"); any other escalated tenant follows the
    standard retry contract (block until ready, retry) and survives.
    """

    def q(ctx, sess):
        held = ctx.charge(hold)
        barrier.wait(timeout=10)
        for _ in range(50):
            try:
                n = ctx.charge(want)
                ctx.release(n)
                ctx.release(held)
                return "survivor"
            except (RetryOOM, SplitAndRetryOOM):
                with lock:
                    first = state["victim"] is None
                    if first:
                        state["victim"] = sess.tenant
                if first:
                    ctx.release(held)
                    return "victim"
                try:
                    RmmSpark.block_thread_until_ready()
                except (RetryOOM, SplitAndRetryOOM):
                    pass
        raise AssertionError("no progress after 50 retries")

    return q


class TestLifecycle:
    def test_happy_path(self, arena, runtime):
        s = runtime.submit(lambda ctx: "ok", est_bytes=1 * MB,
                           tenant="alpha")
        assert s.result(timeout=10) == "ok"
        assert s.status == "done"
        assert s.attempts == 1
        assert s.tenant == "alpha"
        assert s.granted_bytes == 1 * MB  # fit without splitting
        assert arena.total_allocated() == 0

    def test_reservation_splits_under_pressure(self, arena, runtime):
        gate = threading.Event()

        def holder(ctx):
            n = ctx.charge(6 * MB)
            gate.wait(15)
            ctx.release(n)
            return "held"

        h = runtime.submit(holder)
        assert _poll(lambda: arena.total_allocated() >= 6 * MB)
        # 8 MB cannot fit beside the 6 MB resident tenant: the admission
        # probe walks the ladder (park -> stall-break -> split) and is
        # granted the halved footprint that does fit
        s = runtime.submit(lambda ctx: "fit", est_bytes=8 * MB)
        assert s.result(timeout=20) == "fit"
        assert s.granted_bytes == 4 * MB
        gate.set()
        assert h.result(timeout=10) == "held"
        assert arena.total_allocated() == 0


class TestCrossTenantDeadlock:
    def test_two_tenant_bufn_cycle_broken_by_watchdog(self, arena, runtime):
        """Satellite #3: A<->B both hold 5 MB of the 10 MB arena and both
        demand 4 MB more — a cycle no tenant can resolve.  The watchdog
        hands the victim RetryOOM/SplitAndRetryOOM; it rolls back, the
        survivor completes, and both arenas drain."""
        state = {"victim": None}
        lock = threading.Lock()
        barrier = threading.Barrier(2)
        q = _deadlocking_tenant(5 * MB, 4 * MB, state, lock, barrier)
        a = runtime.submit(q, tenant="A")
        b = runtime.submit(q, tenant="B")
        outcomes = sorted([a.result(timeout=15), b.result(timeout=15)])
        assert outcomes == ["survivor", "victim"]
        assert state["victim"] in ("A", "B")
        assert a.status == "done" and b.status == "done"
        assert runtime.shutdown()
        assert arena.total_allocated() == 0
        assert arena.host_total_allocated() == 0

    def test_cycle_behind_running_tenant_needs_stall_breaker(
            self, arena, runtime):
        """The classic scan only fires when EVERY task thread is
        blocked: with tenant C happily running, an A<->B cycle starves
        until the stall breaker rolls the victim back."""
        stop = threading.Event()

        def busy(ctx):
            while not stop.is_set():
                n = ctx.charge(1024)
                ctx.release(n)
                time.sleep(0.005)
            return "busy-done"

        state = {"victim": None}
        lock = threading.Lock()
        barrier = threading.Barrier(2)
        q = _deadlocking_tenant(4 * MB, 4 * MB, state, lock, barrier)
        c = runtime.submit(busy, tenant="C")
        assert _poll(lambda: c.status == "running")
        a = runtime.submit(q, tenant="A")
        b = runtime.submit(q, tenant="B")
        outcomes = sorted([a.result(timeout=15), b.result(timeout=15)])
        assert outcomes == ["survivor", "victim"]
        assert state["victim"] is not None
        stop.set()
        assert c.result(timeout=10) == "busy-done"
        assert runtime.shutdown()
        assert arena.total_allocated() == 0


class TestKillSafety:
    def test_cancel_unparks_tenant_blocked_in_arena(self, arena, runtime):
        """A tenant parked in native BLOCKED (its demand can never fit,
        and a running peer keeps the global scan idle) must unwind
        promptly on cancel — the task_done kill path wakes it with
        REMOVE_THROW."""
        stop = threading.Event()

        def busy(ctx):
            while not stop.is_set():
                n = ctx.charge(1024)
                ctx.release(n)
                time.sleep(0.005)
            return "busy-done"

        c = runtime.submit(busy)
        assert _poll(lambda: c.status == "running")

        def hog(ctx):
            ctx.charge(100 * MB)  # can never fit: parks forever
            return "unreachable"

        h = runtime.submit(hog)
        assert _poll(lambda: h.status == "running")
        time.sleep(0.1)  # let the charge park in the native arena
        t0 = time.monotonic()
        runtime.cancel(h)
        with pytest.raises(QueryCancelled):
            h.result(timeout=5)
        assert time.monotonic() - t0 < 2.0  # woken, not watchdog-timed-out
        assert h.status == "cancelled"
        stop.set()
        assert c.result(timeout=10) == "busy-done"
        assert runtime.shutdown()
        assert arena.total_allocated() == 0

    def test_cancel_while_queued_for_admission(self, arena):
        rt = ServeRuntime(max_concurrent=1)
        try:
            gate = threading.Event()
            a = rt.submit(lambda ctx: (gate.wait(15), "held")[1])
            assert _poll(lambda: a.status == "running")
            b = rt.submit(lambda ctx: "never")
            assert _poll(lambda: b.status == "queued", timeout=1.0)
            rt.cancel(b)
            with pytest.raises(QueryCancelled):
                b.result(timeout=5)
            assert b.status == "cancelled"
            gate.set()
            assert a.result(timeout=10) == "held"
        finally:
            assert rt.shutdown()

    def test_admission_queue_timeout(self, arena):
        rt = ServeRuntime(max_concurrent=1)
        config.set("serve_admit_timeout_s", 0.3)
        try:
            gate = threading.Event()
            a = rt.submit(lambda ctx: (gate.wait(15), "held")[1])
            assert _poll(lambda: a.status == "running")
            b = rt.submit(lambda ctx: "never")
            with pytest.raises(QueryTimeout):
                b.result(timeout=5)
            assert b.status == "timeout"
            gate.set()
            assert a.result(timeout=10) == "held"
        finally:
            config.reset("serve_admit_timeout_s")
            assert rt.shutdown()

    def test_plan_cache_pin_released_on_kill(self, arena, runtime):
        from spark_rapids_jni_tpu_torch.plan.cache import get_plan_cache

        cache = get_plan_cache()
        key = "serve-test-pinned-plan"

        def q(ctx, sess):
            sess.pin_plan(key)
            while True:
                sess._check_cancelled()
                time.sleep(0.01)

        s = runtime.submit(q)
        assert _poll(lambda: cache.pinned(key))
        runtime.cancel(s)
        with pytest.raises(QueryCancelled):
            s.result(timeout=5)
        assert not cache.pinned(key)  # the kill-safe unwind dropped it

    def test_injected_task_cancel_is_a_kill(self, arena, runtime):
        faultinj.configure({"faults": [{"match": "serve_step", "count": 1,
                                        "fault": "task_cancel"}]})
        try:
            s = runtime.submit(lambda ctx: "nope")
            with pytest.raises(faultinj.TaskCancelled):
                s.result(timeout=10)
            assert s.status == "cancelled"
            assert arena.total_allocated() == 0
        finally:
            faultinj.configure({})


class TestTimeoutReadmission:
    def test_timeout_kills_then_readmits_with_backoff(self, arena, runtime):
        def q(ctx, sess):
            # attempts 1 and 2 out-sleep the deadline; attempt 3 returns
            end = time.monotonic() + (10.0 if sess.attempts <= 2 else 0.0)
            while time.monotonic() < end:
                sess._check_cancelled()
                time.sleep(0.02)
            return "eventually"

        s = runtime.submit(q, timeout_s=0.25)
        assert s.result(timeout=20) == "eventually"
        assert s.status == "done"
        assert s.attempts == 3  # initial + serve_max_readmissions
        assert arena.total_allocated() == 0

    def test_timeout_budget_exhausts_to_query_timeout(self, arena, runtime):
        def q(ctx, sess):
            end = time.monotonic() + 10.0
            while time.monotonic() < end:
                sess._check_cancelled()
                time.sleep(0.02)
            return "never"

        s = runtime.submit(q, timeout_s=0.2)
        with pytest.raises(QueryTimeout):
            s.result(timeout=20)
        assert s.status == "timeout"
        assert s.attempts == 3
        assert arena.total_allocated() == 0


class TestDrainLaneOverlap:
    def test_exchange_rounds_pipeline_through_lane(self, eight_devices,
                                                   arena):
        """With the runtime's drain lane installed, a multi-round
        exchange drains round k+1 on the lane thread while the tenant's
        thread wraps round k, and stays bit-identical to the lane-less
        exchange of both packages on the same host data."""
        import jax.numpy as jnp

        from spark_rapids_jni_tpu.columnar import types as JT
        from spark_rapids_jni_tpu.columnar.column import Column as JColumn
        from spark_rapids_jni_tpu.columnar.column import \
            ColumnBatch as JBatch
        from spark_rapids_jni_tpu.parallel import data_mesh, shard_batch
        from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JReg
        from spark_rapids_jni_tpu.shuffle import ShuffleService as JService

        from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
        from spark_rapids_jni_tpu_torch.shuffle import (ShuffleRegistry,
                                                        ShuffleService)

        P = 8
        n = P * 64
        vals = np.arange(n, dtype=np.int64)
        jmesh = data_mesh(P)
        jbatch = shard_batch(JBatch({
            "v": JColumn(jnp.asarray(vals), jnp.ones((n,), jnp.bool_),
                         JT.INT64)}), jmesh)
        # all rows to one destination: the worst skew, forcing rounds >= 2
        jpid = jax.device_put(
            jnp.zeros((n,), jnp.int32),
            jax.sharding.NamedSharding(jmesh,
                                       jax.sharding.PartitionSpec("data")))
        mesh = ShardMesh(P, device="cpu")
        batch = batch_from_numpy({"v": (vals, np.ones(n, bool), "int64")},
                                 device="cpu")
        pid = torch.zeros(n, dtype=torch.int32)

        def delivered(res):
            return res.batch["v"].data.numpy(), res.occupancy.numpy()

        jconfig.set("shuffle_capacity_bucket", 16)
        config.set("shuffle_capacity_bucket", 16)
        try:
            ref = JService(jmesh, registry=JReg()).exchange(
                jbatch, pid=jpid, round_rows=16)
            ref_v = np.asarray(jax.device_get(ref.batch["v"].data))
            ref_occ = np.asarray(jax.device_get(ref.occupancy))
            solo = ShuffleService(mesh, registry=ShuffleRegistry()).exchange(
                batch, pid=pid, round_rows=16)
            solo_v, solo_occ = delivered(solo)
            assert solo.rounds == ref.rounds >= 2
            assert solo.rounds_overlapped == 0  # no lane installed yet
            assert np.array_equal(solo_v, ref_v)
            assert np.array_equal(solo_occ, ref_occ)

            rt = ServeRuntime()
            try:
                def q(ctx):
                    res = ShuffleService(
                        mesh, registry=ShuffleRegistry()).exchange(
                            batch, pid=pid, round_rows=16, ctx=ctx)
                    return delivered(res) + (res.rounds,
                                             res.rounds_overlapped)

                s = rt.submit(q, tenant="shuffler")
                v, occ, rounds, overlapped = s.result(timeout=120)
                assert rounds == ref.rounds
                assert overlapped >= 1  # the double-buffered drain ran
                # bit-identical to the reference's exchange
                assert np.array_equal(v, ref_v)
                assert np.array_equal(occ, ref_occ)
            finally:
                assert rt.shutdown()
            assert arena.total_allocated() == 0
        finally:
            jconfig.reset("shuffle_capacity_bucket")
            config.reset("shuffle_capacity_bucket")

    def test_bailing_consumer_drops_the_lane_rounds(self, monkeypatch):
        """A failure while round r is wrapped unwinds the exchange: the
        rounds queued on the lane are dropped, a running one finishes
        before the map output closes, and the lane serves the next
        caller."""
        from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
        from spark_rapids_jni_tpu_torch.serve.runtime import _DrainLane
        from spark_rapids_jni_tpu_torch.shuffle import (ShuffleRegistry,
                                                        ShuffleService)
        from spark_rapids_jni_tpu_torch.shuffle import service as svc

        n = 8 * 64
        vals = np.arange(n, dtype=np.int64)
        batch = batch_from_numpy({"v": (vals, np.ones(n, bool), "int64")},
                                 device="cpu")
        pid = torch.zeros(n, dtype=torch.int32)
        made, closed, real = [], [], svc.PartitionBuffer

        class Buffer(real):
            def __init__(self, *a, **k):
                if len(made) == 2:  # the map output, then round 0's chunk
                    raise RuntimeError("wrap failed")
                super().__init__(*a, **k)
                made.append(self)

            def close(self):
                closed.append(self)
                super().close()

        monkeypatch.setattr(svc, "PartitionBuffer", Buffer)
        lane = _DrainLane()
        svc.install_drain_lane(lane)
        config.set("shuffle_capacity_bucket", 16)
        try:
            with pytest.raises(RuntimeError, match="wrap failed"):
                ShuffleService(ShardMesh(8, device="cpu"),
                               registry=ShuffleRegistry()).exchange(
                    batch, pid=pid, round_rows=16)
            assert made and all(b in closed for b in made)
            assert lane.submit(None, lambda: "free").result(timeout=5) \
                == "free"
        finally:
            svc.clear_drain_lane()
            lane.close()
            config.reset("shuffle_capacity_bucket")


class TestPriorityAdmission:
    def test_higher_priority_overtakes_queue(self, arena):
        """Two tenants queued behind a full runtime are granted in
        (priority, arrival) order, not FIFO: the later, higher-priority
        submission runs first."""
        rt = ServeRuntime(max_concurrent=1)
        try:
            gate = threading.Event()
            order = []
            hold = rt.submit(lambda ctx: (gate.wait(15), "held")[1])
            assert _poll(lambda: hold.status == "running")
            lo = rt.submit(lambda ctx: order.append("lo"), priority=0)
            assert _poll(lambda: rt._slots.waiting() == 1, timeout=2.0)
            hi = rt.submit(lambda ctx: order.append("hi"), priority=5)
            assert _poll(lambda: rt._slots.waiting() == 2, timeout=2.0)
            gate.set()
            hi.result(timeout=10)
            lo.result(timeout=10)
            assert order == ["hi", "lo"]
        finally:
            assert rt.shutdown()

    def test_eviction_rank_prefers_low_priority(self, arena):
        """While a session runs, its spill-store eviction rank is
        dominated by its SLA class: a higher-priority tenant's handles
        outrank (evict later than) a lower-priority one's."""
        from spark_rapids_jni_tpu_torch.mem import spill as spill_mod

        fw = spill_mod.install()
        rt = ServeRuntime()
        try:
            ranks = {}

            def q(tag):
                def body(ctx, sess):
                    ranks[tag] = fw.store.task_priority(sess.task_id)
                    return tag
                return body

            rt.submit(q("lo"), priority=0).result(timeout=10)
            rt.submit(q("hi"), priority=3).result(timeout=10)
            # class dominates: 3e6 minus any admission sequence beats 0e6
            assert ranks["hi"] > ranks["lo"]
            assert ranks["hi"] >= 3e6 - 1e6 / 2
        finally:
            assert rt.shutdown()
            spill_mod.shutdown()


class TestShutdownIdempotence:
    def test_second_call_returns_first_result(self, arena):
        rt = ServeRuntime()
        assert rt.submit(lambda ctx: "x").result(timeout=10) == "x"
        first = rt.shutdown()
        second = rt.shutdown()
        assert first is True and second is True

    def test_racing_shutdowns_agree(self, arena):
        rt = ServeRuntime()
        rt.submit(lambda ctx: "x").result(timeout=10)
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(rt.shutdown()))
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert results == [True] * 4

    def test_submit_after_shutdown_raises(self, arena):
        from spark_rapids_jni_tpu_torch.serve import ServeError

        rt = ServeRuntime()
        rt.shutdown()
        with pytest.raises(ServeError):
            rt.submit(lambda ctx: "late").result(timeout=1)


class TestReadmissionBackoff:
    def test_backoff_actually_waits(self, arena):
        """The re-admission ladder really sleeps serve_backoff_ms
        (doubling): with 200ms base and two readmissions the second
        attempt cannot start before ~200ms after the first kill."""
        config.set("serve_backoff_ms", 200.0)
        rt = ServeRuntime()
        try:
            stamps = []

            def q(ctx, sess):
                stamps.append(time.monotonic())
                end = time.monotonic() + (
                    10.0 if sess.attempts == 1 else 0.0)
                while time.monotonic() < end:
                    sess._check_cancelled()
                    time.sleep(0.01)
                return "done"

            s = rt.submit(q, timeout_s=0.15)
            assert s.result(timeout=20) == "done"
            assert len(stamps) == 2
            # attempt 2 started >= backoff after attempt 1 STARTED
            # (timeout fired ~0.15s in, then the 0.2s ladder wait)
            assert stamps[1] - stamps[0] >= 0.15 + 0.2 - 0.02
        finally:
            assert rt.shutdown()
            config.reset("serve_backoff_ms")

    def test_cancel_during_backoff_unwinds_immediately(self, arena):
        """A cancel landing while the session sleeps in the backoff
        ladder must not wait the ladder out: with a 5s base the session
        unwinds in well under a second."""
        config.set("serve_backoff_ms", 5000.0)
        rt = ServeRuntime()
        try:
            killed = threading.Event()

            def q(ctx, sess):
                killed.set()
                end = time.monotonic() + 10.0
                while time.monotonic() < end:
                    sess._check_cancelled()
                    time.sleep(0.01)
                return "never"

            s = rt.submit(q, timeout_s=0.1)
            assert killed.wait(10)
            # let the timeout fire and the backoff sleep begin
            assert _poll(lambda: s.attempts >= 1 and killed.is_set())
            time.sleep(0.3)
            t0 = time.monotonic()
            rt.cancel(s)
            with pytest.raises((QueryCancelled, QueryTimeout)):
                s.result(timeout=10)
            assert time.monotonic() - t0 < 2.0  # not the 5s ladder
        finally:
            assert rt.shutdown()
            config.reset("serve_backoff_ms")


# ---------------------------------------------------------------------------
# the slice as a whole: q6, q95 and q9 through both packages' runtimes
# ---------------------------------------------------------------------------

SLICE_ROWS = 1 << 12


@pytest.fixture(scope="module")
def slice_inputs():
    """One q6 batch and one q95 input set at 2^12 rows, in both packages'
    columns, from the same seeds."""
    jb = ge._example_batch(SLICE_ROWS, seed=3)
    jf, jd1, jd2 = ge._q95_batches(SLICE_ROWS, seed=29)
    jin = {"fact": jf, "dim1": jd1, "dim2": jd2}
    return jb, jin, to_port(jb), {k: to_port(v) for k, v in jin.items()}


def _assert_groups_match(jres, jng, tres, tng, floats=()):
    g = int(jng)
    assert int(tng) == g
    assert list(tres.names) == list(jres.names)
    for name in jres.names:
        jv = np.asarray(jres[name].validity)[:g]
        np.testing.assert_array_equal(tres[name].validity[:g].numpy(), jv,
                                      err_msg=name)
        jd = np.asarray(jres[name].data)[:g]
        td = tres[name].data[:g].numpy()
        if name in floats:
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(td[jv], jd[jv], err_msg=name)


def _serve_wave(runtime, queries, est):
    """Submit every query at once; all must finish ``done``."""
    sessions = {name: runtime.submit(fn, est_bytes=est, tenant=name)
                for name, fn in queries.items()}
    out = {name: s.result(timeout=120) for name, s in sessions.items()}
    assert {s.status for s in sessions.values()} == {"done"}
    return out, sessions


def test_slice_served_equals_reference_runtime(slice_inputs):
    jb, jin, tb, tin = slice_inputs
    est = 1 * MB
    jq6 = jax.jit(ge._q6_step)
    jq95 = jax.jit(ge._q95_encoded_step)
    jplans = []

    def jq9(ctx, sess):
        cp = jplan.compile_plan(jq.q9_plan(), jin)
        jplans.append(cp)
        sess.pin_plan(cp.key)
        return cp(jin)

    def tq9(ctx, sess):
        cp = tplan.compile_plan(tq.q9_plan(), tin)
        sess.pin_plan(cp.key)
        return cp(tin), cp.last_lookup

    jplan.reset_plan_cache()
    tplan.reset_plan_cache()
    jarena = JRmmSpark.set_event_handler(64 * MB, poll_ms=20.0)
    tarena = RmmSpark.set_event_handler(64 * MB, poll_ms=20.0)
    jconfig.set("serve_stall_break_ms", 200.0)
    config.set("serve_stall_break_ms", 200.0)
    try:
        jrt = JServeRuntime()
        try:
            jout, _ = _serve_wave(jrt, {
                "q6": lambda ctx: jq6(jb),
                "q95_hashjoin": lambda ctx: jq95(
                    jin["fact"], jin["dim1"], jin["dim2"]),
                "q9": jq9}, est)
        finally:
            assert jrt.shutdown()
        rt = ServeRuntime()
        try:
            tout, tsess = _serve_wave(rt, {
                "q6": lambda ctx: TP.q6_step(tb),
                "q95_hashjoin": lambda ctx: TP.q95_hashjoin_step(
                    tin["fact"], tin["dim1"], tin["dim2"]),
                "q9": tq9}, est)
            # the tenant's second q9 hits the shared plan cache
            traces = tplan.trace_count()
            again = rt.submit(tq9, est_bytes=est, tenant="q9")
            (res2, ng2), lookup = again.result(timeout=120)
        finally:
            assert rt.shutdown()
        assert jarena.total_allocated() == 0
        assert tarena.total_allocated() == 0
    finally:
        for cp in jplans:
            cp.close()
        jconfig.reset("serve_stall_break_ms")
        config.reset("serve_stall_break_ms")
        JRmmSpark.clear_event_handler()
        RmmSpark.clear_event_handler()
        jplan.reset_plan_cache()
        tplan.reset_plan_cache()
    assert all(s.granted_bytes == est and s.attempts == 1
               for s in tsess.values())
    _assert_groups_match(*jout["q6"], *tout["q6"], floats=("avg_price",))
    _assert_groups_match(*jout["q95_hashjoin"], *tout["q95_hashjoin"])
    (tres9, tng9), first_lookup = tout["q9"]
    assert first_lookup != "hit"
    _assert_groups_match(*jout["q9"], tres9, tng9, floats=("avg_hi",))
    assert lookup == "hit" and tplan.trace_count() == traces
    assert int(ng2) == int(tng9)
    for name in tres9.names:
        assert torch.equal(res2[name].data, tres9[name].data), name


def test_launch_counts_survive_concurrent_tenants():
    """Tenants launch kernels from several threads at once; every launch
    must count (the card's waves check exact counts)."""
    import sys

    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    per, n_threads = 2000, 16  # more threads than cores
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    KER.reset_launches()
    try:
        threads = [threading.Thread(target=lambda: [
            KER._count("partition_scatter") for _ in range(per)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert KER.launches["partition_scatter"] == per * n_threads
    finally:
        sys.setswitchinterval(interval)
        KER.reset_launches()
