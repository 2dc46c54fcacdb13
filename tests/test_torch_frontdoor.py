"""PyTorch port: the serving fleet (``serve/frontdoor.py``,
``serve/worker.py``) with real worker processes on the CPU
(``device="cpu"``), against the reference's fleet tests
(``tests/test_frontdoor.py``) and, where a value is computed, against the
JAX package on the same seeded inputs.

* One shared fleet (2 workers, Unix socket, shm data plane, the
  ``smoke_kinds`` setup module) serves the cases that kill nothing, and
  is shut down before any fault is scheduled (a schedule reaches every
  fleet of the process): echo
  and pinning, a loud unknown kind, ``q6_digest`` at 2^12 rows equal to
  the port's in-process digest (exact), ``q6_result`` group by group
  against the reference's ``_q6_step`` (counts and sums exact, float
  means rel 1e-5, the f32x3 tolerance), ``shuffle_digest`` against the
  reference worker's digest (exact), ``arrow_batch`` over shm bit for bit
  against the reference's ``make_result_batch`` through its own codec,
  the fleet counters, and the ROADMAP 16d branches (each raises
  ``NotImplementedError`` naming 16d).
* Fleets of their own for what kills or wedges a worker: a crash that
  re-places a replayable session onto a respawn that adopts the committed
  shuffle shards, a fenced zombie generation, a non-replayable session
  failing with ``WorkerLost``, the store kept past shutdown by
  ``shuffle_store_retain``, and the fleet's write-ahead journal replayed
  by the reference's ``journal.replay`` to the same state as the port's
  and as the fleet's sessions and workers; a stall; shedding then fleet
  exhaustion.  The transports' cases are in
  ``test_torch_fleet_transport.py``.

Every fleet is shut down in a ``finally``; each test checks that no worker
pid it saw is alive and that the fleet directory is gone (unless
retained).  The fleet directory is ``tempfile.mkdtemp`` with a short
prefix, never under ``tmp_path``, so the socket path stays inside
AF_UNIX's limit.  Nothing is left in ``os.environ``, the fault schedule,
the knobs or the cwd (``torch_fleet.fleet_hygiene``).
"""

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu.columnar import arrow as JA
from spark_rapids_jni_tpu.serve import data_plane as jdp
from spark_rapids_jni_tpu.serve import journal as jjournal
from spark_rapids_jni_tpu.serve import worker as jworker

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch import pipelines as PL
from spark_rapids_jni_tpu_torch.mem import RmmSpark
from spark_rapids_jni_tpu_torch.serve import (AdmissionShed, FrontDoor,
                                              ServeError, WorkerLost,
                                              fleet_metrics)
from spark_rapids_jni_tpu_torch.serve import data_plane as dp
from spark_rapids_jni_tpu_torch.serve import journal
from spark_rapids_jni_tpu_torch.serve import smoke_kinds, worker
from spark_rapids_jni_tpu_torch.shuffle.store import ShuffleStore

from torch_fleet import ROOT, WAIT, Fleet, fd_threads, poll
from torch_fleet import fleet_hygiene  # noqa: F401 (autouse)
from torch_parity import port_form, ref_form, to_port
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SETUP = "spark_rapids_jni_tpu_torch.serve.smoke_kinds"
RTOL = 1e-5  # the f32x3 float-sum tolerance


def _journal_copy(fd) -> bytes:
    """The fleet's write-ahead journal as it stands: every record is
    fsync'd before the mutation it announces, so a copy taken between
    mutations holds the whole history so far."""
    with open(journal.journal_path(fd.fleet_dir), "rb") as f:
        return f.read()


def _replayed_both_ways(wal: bytes):
    """Replay a port fleet's journal with the reference's
    ``journal.replay`` and the port's; the two states must be equal."""
    d = tempfile.mkdtemp(prefix="srj_wal_")
    try:
        path = os.path.join(d, "journal.wal")
        with open(path, "wb") as f:
            f.write(wal)
        ref = jjournal.replay(path, truncate=False)
        port = journal.replay(path, truncate=False)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert not ref.truncated_tail
    assert vars(ref) == vars(port)
    return ref


@pytest.fixture(scope="class")
def fleet():
    f = Fleet(workers=2, setup=SETUP)
    try:
        f.healthy()
        yield f
    finally:
        report = f.close()
    assert report["clean"], report
    assert poll(lambda: not fd_threads(), 10.0)


# ---------------------------------------------------------------------------
# the shared fleet: nothing here kills a worker
# ---------------------------------------------------------------------------

class TestHappyPath:
    def test_echo_roundtrip_and_pinning(self, fleet):
        fd = fleet.fd
        sessions = [fd.submit("echo", {"value": i}, tenant=f"t{i % 2}")
                    for i in range(6)]
        assert [s.result(timeout=WAIT) for s in sessions] == list(range(6))
        # a tenant's sessions stick to one worker
        assert len({s.worker_id for s in sessions[0::2]}) == 1
        assert len({s.worker_id for s in sessions[1::2]}) == 1
        assert all(s.status == "done" and s.replacements == 0
                   for s in sessions)

    def test_unknown_kind_fails_loudly(self, fleet):
        s = fleet.fd.submit("no_such_kind", {}, tenant="t0")
        with pytest.raises(ServeError, match="unknown query kind"):
            s.result(timeout=WAIT)
        assert s.status == "failed"

    def test_q6_digest_is_the_in_process_digest(self, fleet):
        """Exact: the worker's digest of two q6 steps at 2^12 rows is the
        one this process computes over the same seeded batches."""
        params = {"rows": 1 << 12, "stream": 2, "query": 1, "steps": 2}
        got, secs = fleet.fd.submit("q6_digest", params,
                                    tenant="t0").result(timeout=WAIT)
        dig = hashlib.sha256()
        worker.run_q6(None, params, lambda s, r, n: worker.digest_q6(
            dig, r, n))
        assert got == dig.hexdigest()
        assert secs > 0

    def test_q6_result_matches_the_reference(self, fleet):
        """Group by group against the reference's ``_q6_step`` on the
        same seeds: keys, counts and int sums exact, the float mean rel
        1e-5."""
        params = {"rows": 1 << 12, "stream": 1, "query": 0, "steps": 2}
        got = smoke_kinds.step_groups(fleet.fd.submit(
            "q6_result", params, tenant="t1").result(timeout=WAIT))
        assert sorted(got) == [0, 1]
        for s in (0, 1):
            jb = ge._example_batch(1 << 12, seed=worker.q6_seed(1, 0, s))
            jres, jng = ge._q6_step(jb)
            want = PL.result_groups(to_port(jres), int(jng), "k")
            assert sorted(got[s]) == sorted(want), s
            for k, row in want.items():
                mine = got[s][k]
                assert mine["sum_v"] == row["sum_v"], (s, k)
                assert mine["cnt"] == row["cnt"], (s, k)
                assert mine["avg_price"] == pytest.approx(
                    row["avg_price"], rel=RTOL), (s, k)

    def test_shuffle_digest_is_the_reference_workers(self, fleet):
        """Exact: the 8-shard exchange's delivered rows and occupancy
        hash to the reference worker's digest over 8 devices."""
        for seed in (1, 4):
            got = fleet.fd.submit("shuffle_digest", {"seed": seed},
                                  tenant="t0").result(timeout=WAIT)
            want = jworker._qk_shuffle_digest(None, {"seed": seed}, None)
            assert got["digest"] == want["digest"], seed
            assert got["map_runs"] == 1 and got["adopted"] == 0

    def test_arrow_batch_over_shm_is_bit_exact(self, fleet):
        """Every buffer bit for bit what the reference's data plane
        delivers of its ``make_result_batch``: NaN payloads, -0.0, null
        rows' codes, dictionary and runs kept."""
        before = fleet_metrics()["data_batches"]
        for rows, seed in ((1000, 3), (4099, 0)):
            got = fleet.fd.submit("arrow_batch", {"rows": rows,
                                                  "seed": seed},
                                  tenant="t1").result(timeout=WAIT)
            ref = jworker.make_result_batch(rows, seed)
            buf, fp = JA.batch_to_ipc(ref)
            back = JA.ipc_to_batch(buf.to_pybytes(), fp)
            assert got.names == back.names
            for n in back.names:
                assert port_form(got[n]) == ref_form(back[n]), n
            assert dp.batch_digest(got) == jdp.batch_digest(ref)
            assert got["v"].data.device.type == "cpu"
        assert fleet_metrics()["data_batches"] - before == 2

    def test_make_result_batch_is_the_references(self):
        for rows, seed in ((0, 1), (257, 5)):
            mine = worker.make_result_batch(rows, seed, "cpu")
            assert dp.batch_digest(mine) == jdp.batch_digest(
                jworker.make_result_batch(rows, seed))

    def test_16d_submit_and_adoption_api_raise(self, fleet):
        with pytest.raises(NotImplementedError, match="16d"):
            fleet.fd.submit("echo", {"value": 1}, snapshot="mem:1")
        with pytest.raises(NotImplementedError, match="16d"):
            fleet.fd.recovered()
        with pytest.raises(NotImplementedError, match="16d"):
            fleet.fd._simulate_crash()

    def test_fleet_metrics_surface(self, fleet):
        m = RmmSpark.fleet_metrics()
        assert m == fleet_metrics()
        assert m["workers_spawned"] == 2
        assert m["liveness"] == {0: "healthy", 1: "healthy"}
        assert m["crashes"] == m["respawns"] == m["cache_hits"] == 0
        assert len(fleet.fd.hello_seconds) == 2


class TestNotPorted:
    """ROADMAP item 16d: each branch raises, naming it, before any worker
    is spawned."""

    @pytest.mark.parametrize("kw", [
        {"autoscale": True},
        {"tenant_quota_bytes": 1},
        {"tenant_quota_s": 0.5},
        {"adopt_dir": "/nonexistent-fleet"},
        {"result_cache": object()},
    ], ids=["autoscale", "quota_bytes", "quota_s", "adopt", "cache"])
    def test_constructor_branch_raises(self, kw):
        # each raises before any worker exists; a fleet that did come up
        # would be shut down at once
        with pytest.raises(NotImplementedError, match="16d"):
            FrontDoor(workers=1, device="cpu", **kw).shutdown()

    def test_16d_fault_kinds_raise(self):
        for kind in ("cache_stale", "cache_corrupt", "scale_up_fail",
                     "drain_stuck"):
            with pytest.raises(NotImplementedError, match="16d"):
                faultinj.configure({"faults": [{"fault": kind}]})

    def test_cuda_is_never_swapped_for_the_cpu(self, tmp_path):
        """Without a card, a CUDA fleet refuses at construction and a
        CUDA worker raises at start."""
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
        with pytest.raises(ServeError, match="no CUDA"):
            FrontDoor(workers=1).shutdown()
        r = subprocess.run(
            [sys.executable, "-m", "spark_rapids_jni_tpu_torch.serve.worker",
             "--socket", "unused", "--worker-id", "0",
             "--dir", str(tmp_path), "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr


# ---------------------------------------------------------------------------
# fleets of their own
# ---------------------------------------------------------------------------

class TestWorkerLossAndStore:
    def test_crash_replaces_adopts_fences_and_fails_nonreplayable(self):
        """One worker, three incarnations.  Query 1 commits its map;
        query 2's first step crashes gen 1: the session re-places onto
        gen 2, which ADOPTS the committed shard (map_runs 0) with the same
        digest, and gen 1 is fenced (a zombie's commit is rejected).
        Then a non-replayable query's result crash fails it with
        ``WorkerLost``; with ``shuffle_store_retain`` the store outlives
        the shutdown."""
        faultinj.configure({"faults": [
            {"match": "serve_step", "fault": "worker_crash", "skip": 1,
             "count": 1},
            {"match": "worker_result", "fault": "worker_crash", "skip": 1,
             "count": 1}]})
        f = Fleet(workers=1)
        try:
            f.healthy()
            s1 = f.fd.submit("shuffle_digest",
                             {"seed": 3, "store_key": "sd-3"}, tenant="t0")
            r1 = s1.result(timeout=WAIT)
            assert r1["map_runs"] == 1 and r1["adopted"] == 0
            s2 = f.fd.submit("shuffle_digest",
                             {"seed": 3, "store_key": "sd-3"}, tenant="t0")
            r2 = s2.result(timeout=WAIT)
            assert s2.replacements >= 1
            assert r2["digest"] == r1["digest"]
            assert r2["adopted"] >= 1 and r2["map_runs"] == 0
            zombie = ShuffleStore(f.fd.store_dir, epoch=1)
            assert zombie.fenced(1) and not zombie.fenced(2)
            assert not zombie.put("zq", "map", {"x": torch.arange(4)})
            assert zombie.snapshot()["fenced_commits"] == 1
            assert ShuffleStore(f.fd.store_dir).adopt(
                "zq", "map", device="cpu") is None
            f.healthy()
            s3 = f.fd.submit("sleep", {"seconds": 0.2}, tenant="t0",
                             replayable=False)
            with pytest.raises(WorkerLost) as exc:
                s3.result(timeout=WAIT)
            assert exc.value.worker_id == 0
            assert any(e.get("fault") == "worker_crash"
                       for e in exc.value.fired_log)
            f.healthy()
            wal = _journal_copy(f.fd)
            config.set("shuffle_store_retain", True)
        finally:
            report = f.close(retained=config.get("shuffle_store_retain"))
        try:
            assert report["clean"], report
            assert report["fleet"]["crashes"] == 2
            assert report["fleet"]["respawns"] == 2
            assert report["fleet"]["worker_lost"] == 1
            # the warm plan hand-off is ROADMAP item 16d: none shipped
            assert report["fleet"]["plan_warm_shipped"] == 0
            state = _replayed_both_ways(wal)
            assert state.meta["addr"] == f.fd._sock_addr
            assert state.meta["n_workers"] == 1
            assert state.meta["store_dir"] == f.fd.store_dir
            assert state.live_sessions() == {}
            for s in (s1, s2, s3):
                got = state.sessions[s.sid]
                assert (got["status"], got["kind"], got["tenant"],
                        got["replayable"], got["params"]) == \
                    (s.status, s.kind, s.tenant, s.replayable, s.params)
            assert state.all_gens == [1, 2, 3]
            assert sorted(state.revoked) == [1, 2]
            assert state.workers[0]["gen"] == 3
            assert state.workers[0]["state"] == "alive"
            assert state.workers[0]["pid"] == report["workers"][0]["pid"]
            assert ShuffleStore(f.fd.store_dir).has_committed("sd-3", "map")
            assert any(e.get("fault") == "worker_crash"
                       and str(e.get("source", "")).startswith("worker-")
                       for e in faultinj.fired_log())
        finally:
            shutil.rmtree(f.fd.fleet_dir, ignore_errors=True)

    def test_stall_detected_and_session_replaced(self):
        faultinj.configure({"faults": [
            {"match": "serve_step", "fault": "worker_stall", "count": 1}]})
        # a quarter-second beat: the silence detection is what it tests
        f = Fleet(workers=1, heartbeat_ms=250.0)
        try:
            s = f.fd.submit("spill_walk", {"seed": 9}, tenant="t0")
            want = s.result(timeout=WAIT)
            assert s.replacements >= 1
            assert want == f.fd.submit("spill_walk", {"seed": 9},
                                       tenant="t0").result(timeout=WAIT)
            f.healthy()
        finally:
            report = f.close()
        assert report["clean"], report
        assert report["fleet"]["stalls"] == 1


class TestDegradation:
    def test_shed_then_fleet_exhausted(self):
        """Two single-slot workers, no respawns: with one killed, pending
        admissions beyond the surviving capacity are shed lowest priority
        first; with both killed, pending sessions fail with
        ``WorkerLost``."""
        f = Fleet(workers=2, max_concurrent=1, respawn_max=0,
                   shed_threshold=0.6)
        try:
            f.healthy()
            busy = [f.fd.submit("sleep", {"seconds": 3.0}, tenant=f"b{i}")
                    for i in range(2)]
            assert poll(lambda: all(s.worker_id is not None
                                     for s in busy), 30.0)
            hi = f.fd.submit("echo", {"value": "hi"}, tenant="b0",
                             priority=5)
            lo = f.fd.submit("echo", {"value": "lo"}, tenant="b1",
                             priority=0)
            f.kill(1)
            with pytest.raises(AdmissionShed):
                lo.result(timeout=WAIT)
            assert lo.status == "shed"
            assert hi.result(timeout=WAIT) == "hi"
            hold = f.fd.submit("sleep", {"seconds": 5.0}, tenant="b0")
            assert poll(lambda: hold.worker_id is not None, 30.0)
            queued = f.fd.submit("echo", {"value": "q"}, tenant="b0")
            f.kill(0)
            with pytest.raises(WorkerLost):
                queued.result(timeout=WAIT)
        finally:
            report = f.close()
        assert report["fleet"]["sheds"] >= 1
        assert report["fleet"]["circuit_open"] == 2
