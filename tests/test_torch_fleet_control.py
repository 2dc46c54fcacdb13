"""PyTorch port: the fleet's control plane without processes
(``serve/launcher.py``, ``serve/elastic.py``) against the reference's.

The launcher contract: ``LocalLauncher`` owns exactly its child's pid, a
remote handle adopts the first hello's pid and holds it, and
``RemoteLauncher``'s template splices the argv at ``{argv}`` or appends
it.  ``Placement`` and ``AutoScaler`` make the reference's decisions on
the same fake-worker sequences (the reference's ``tests/test_elastic.py``
``_FakeWorker``), every decision compared exactly; the reference reads
the autoscaler's thresholds from its knobs, the port (whose
``serve_autoscale_*`` knobs are ROADMAP item 16d) from the same values
passed to the constructor.
"""

import os
import sys

import numpy as np
import pytest

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.serve import AutoScaler as JAutoScaler
from spark_rapids_jni_tpu.serve import Placement as JPlacement

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.serve import (AutoScaler, LaunchedWorker,
                                              LocalLauncher, Placement,
                                              RemoteLauncher)
from spark_rapids_jni_tpu_torch.serve import elastic
from spark_rapids_jni_tpu_torch.serve.launcher import launcher_from_config

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

REMOTE_TEMPLATE = "sh -c 'exec \"$@\"' launcher-agent {argv}"

_AUTOSCALE_KNOBS = {"high_water": "serve_autoscale_high_water",
                    "low_water": "serve_autoscale_low_water",
                    "min_workers": "serve_autoscale_min",
                    "max_workers": "serve_autoscale_max",
                    "hold_ms": "serve_autoscale_hold_ms",
                    "idle_ms": "serve_autoscale_idle_ms"}


@pytest.fixture(autouse=True)
def _knobs():
    yield
    for knob in list(_AUTOSCALE_KNOBS.values()) + ["serve_placement"]:
        jconfig.reset(knob)
    config.reset("serve_placement")
    config.reset("serve_launcher")


class _FakeWorker:
    """The reference test's stand-in worker handle: just the fields
    Placement and AutoScaler score on."""

    def __init__(self, worker_id, host="local", state="healthy",
                 sessions=0, queue_depth=0, arena_bytes=0,
                 pool_bytes=1 << 20, stall_suspect=False,
                 retiring=False, gen=1):
        self.worker_id = worker_id
        self.host = host
        self.state = state
        self.sessions = {i: object() for i in range(sessions)}
        self.queue_depth = queue_depth
        self.arena_bytes = arena_bytes
        self.pool_bytes = pool_bytes
        self.stall_suspect = stall_suspect
        self.retiring = retiring
        self.gen = gen


def _ids(decision):
    """A decision with the handle replaced by its slot id."""
    if decision is None:
        return None
    action, w = decision
    return action, None if w is None else w.worker_id


class TestLauncherContract:
    def test_local_launcher_owns_exact_pid(self, tmp_path):
        lw = LocalLauncher().launch(
            ["sh", "-c", "exit 0"], cwd=str(tmp_path), env=dict(os.environ),
            log_path=str(tmp_path / "w.log"))
        try:
            assert lw.owns_pid(lw.pid)
            assert not lw.owns_pid(lw.pid + 1)
            assert not lw.owns_pid("not-a-pid")
            assert lw.wait(10.0) == 0
            assert lw.returncode == 0
        finally:
            lw.close()

    def test_local_launch_is_an_exec(self, tmp_path):
        """The child is a fresh interpreter (its own session group), with
        the env it was given, its output in the log."""
        lw = LocalLauncher().launch(
            [sys.executable, "-c",
             "import os; print(os.environ['SRJ_PROBE'], "
             "os.getsid(0) == os.getpid())"],
            cwd=str(tmp_path), env=dict(os.environ, SRJ_PROBE="here"),
            log_path=str(tmp_path / "w.log"))
        try:
            assert lw.wait(60.0) == 0
        finally:
            lw.close()
        assert (tmp_path / "w.log").read_text().split() == ["here", "True"]

    def test_remote_handle_adopts_first_hello_pid(self):
        class _P:
            pid = 12345
            returncode = None

        lw = LaunchedWorker(_P(), remote=True)
        assert lw.pid == 12345
        assert lw.owns_pid(777)
        assert lw.pid == 777
        assert lw.owns_pid(777)
        assert not lw.owns_pid(778)

    def test_remote_template_requires_argv_or_appends(self):
        with RemoteLauncher("agent --host h {argv}") as r:
            assert r._command(["python", "-m", "w"]) == \
                ["agent", "--host", "h", "python", "-m", "w"]
        with RemoteLauncher(["agent", "run"]) as r2:
            assert r2._command(["python"]) == ["agent", "run", "python"]
        with pytest.raises(ValueError):
            with RemoteLauncher(""):
                pass

    def test_remote_launcher_runs_the_argv_through_its_agent(self, tmp_path):
        with RemoteLauncher(REMOTE_TEMPLATE) as r:
            lw = r.launch(["sh", "-c", "echo agent-ran; exit 3"],
                          cwd=str(tmp_path), env=dict(os.environ),
                          log_path=str(tmp_path / "r.log"))
            try:
                assert lw.wait(10.0) == 3
            finally:
                lw.close()
        assert lw.remote
        assert (tmp_path / "r.log").read_text().strip() == "agent-ran"

    def test_launcher_from_config_dispatch(self):
        local = launcher_from_config("local")
        assert isinstance(local, LocalLauncher)
        remote = launcher_from_config(REMOTE_TEMPLATE)
        assert isinstance(remote, RemoteLauncher)
        passthrough = LocalLauncher()
        assert launcher_from_config(passthrough) is passthrough
        assert isinstance(launcher_from_config(), LocalLauncher)
        config.set("serve_launcher", "agent {argv}")
        assert isinstance(launcher_from_config(), RemoteLauncher)


class TestPlacement:
    def test_load_mode_prefers_least_loaded(self):
        p = Placement(["local"])
        idle = _FakeWorker(0)
        busy = _FakeWorker(1, sessions=3, queue_depth=2)
        assert p.pick([busy, idle]) is idle
        stalled = _FakeWorker(2, stall_suspect=True)
        assert p.pick([stalled, idle]) is idle
        hot = _FakeWorker(3, arena_bytes=900 << 10, pool_bytes=1 << 20)
        assert p.pick([hot, idle]) is idle
        assert p.pick([]) is None

    def test_round_robin_mode_rotates(self):
        p = Placement(["local"], mode="round_robin")
        ws = [_FakeWorker(0), _FakeWorker(1, sessions=5, queue_depth=9)]
        assert [p.pick(ws).worker_id for _ in range(4)] == [0, 1, 0, 1]

    def test_host_for_slot_spreads_then_balances(self):
        p = Placement(["hostA", "hostB"])
        assert p.host_for_slot(0, []) == "hostA"
        w0 = _FakeWorker(0, host="hostA")
        assert p.host_for_slot(1, [w0]) == "hostB"
        w1 = _FakeWorker(1, host="hostB", sessions=4)
        assert p.host_for_slot(2, [w0, w1]) == "hostA"

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError):
            Placement(["local"], mode="psychic")
        config.set("serve_placement", "round_robin")
        assert Placement([]).mode == "round_robin"
        assert Placement([]).hosts == ["local"]

    @pytest.mark.parametrize("mode", ["load", "round_robin"])
    @pytest.mark.parametrize("seed", range(6))
    def test_same_decisions_as_the_reference(self, mode, seed):
        """Random fleets over 1-3 hosts: every pick and every host choice
        is the reference's (exact)."""
        rng = np.random.default_rng(seed)
        hosts = [f"h{i}" for i in range(int(rng.integers(1, 4)))]
        mine, ref = Placement(hosts, mode=mode), JPlacement(hosts, mode=mode)
        for _ in range(40):
            ws = [_FakeWorker(
                i, host=hosts[int(rng.integers(0, len(hosts)))],
                state=["healthy", "starting", "dead"][
                    int(rng.integers(0, 3))],
                sessions=int(rng.integers(0, 4)),
                queue_depth=int(rng.integers(0, 3)),
                arena_bytes=int(rng.integers(0, 1 << 20)),
                stall_suspect=bool(rng.random() < 0.2))
                for i in range(int(rng.integers(0, 6)))]
            healthy = [w for w in ws if w.state == "healthy"]
            a, b = mine.pick(healthy), ref.pick(healthy)
            assert (a and a.worker_id) == (b and b.worker_id)
            slot = int(rng.integers(0, 8))
            assert mine.host_for_slot(slot, ws) == ref.host_for_slot(slot, ws)


class TestAutoScaler:
    def test_scales_up_after_sustained_backlog(self):
        a = AutoScaler(base_workers=1, hold_ms=50.0, high_water=2,
                       max_workers=3)
        try:
            ws = [_FakeWorker(0)]
            assert a.decide(0.0, 5, ws) is None  # not held long enough
            assert a.decide(0.2, 5, ws) == ("up", None)
            assert a.decide(0.21, 5, ws) is None  # cooldown
        finally:
            a.stop()
        assert a.decide(5.0, 50, ws) is None  # stopped

    def test_scales_down_idle_highest_id_and_respects_min(self):
        a = AutoScaler(base_workers=1, idle_ms=50.0)
        try:
            ws = [_FakeWorker(0), _FakeWorker(1), _FakeWorker(2)]
            assert a.decide(0.0, 0, ws) is None
            action = a.decide(0.2, 0, ws)
            assert action is not None and action[0] == "down"
            assert action[1].worker_id == 2  # newest retires first
            with AutoScaler(base_workers=1) as a2:
                assert a2.decide(0.2, 0, [_FakeWorker(0)]) is None
        finally:
            a.stop()
        assert a.snapshot()["scale_downs"] == 1

    def test_defaults_are_the_reference_knob_defaults(self):
        ref, mine = JAutoScaler(base_workers=2), AutoScaler(base_workers=2)
        try:
            assert mine.snapshot() == ref.snapshot()
            assert (mine.hold_s, mine.idle_s) == (ref.hold_s, ref.idle_s)
            assert (elastic.HIGH_WATER, elastic.LOW_WATER,
                    elastic.MIN_WORKERS, elastic.MAX_WORKERS,
                    elastic.HOLD_MS, elastic.IDLE_MS) == tuple(
                jconfig.get(k) for k in _AUTOSCALE_KNOBS.values())
        finally:
            ref.stop()
            mine.stop()

    @pytest.mark.parametrize("seed", range(8))
    def test_same_decisions_as_the_reference(self, seed):
        """A random tick sequence (queue depths, fleets that grow, drain,
        go busy and idle, adopt_state restarts): every decision and the
        final counters are the reference's (exact)."""
        rng = np.random.default_rng(100 + seed)
        knobs = {"high_water": int(rng.integers(0, 4)),
                 "low_water": int(rng.integers(0, 2)),
                 "min_workers": int(rng.integers(0, 3)),
                 "max_workers": int(rng.integers(1, 6)),
                 "hold_ms": float(rng.choice([0.0, 30.0, 120.0])),
                 "idle_ms": float(rng.choice([0.0, 40.0, 200.0]))}
        for k, v in knobs.items():
            jconfig.set(_AUTOSCALE_KNOBS[k], v)
        base = int(rng.integers(1, 3))
        ref, mine = JAutoScaler(base_workers=base), \
            AutoScaler(base_workers=base, **knobs)
        try:
            assert mine.snapshot() == ref.snapshot()
            ws = [_FakeWorker(i) for i in range(base)]
            now = 0.0
            for tick in range(120):
                now += float(rng.choice([0.01, 0.05, 0.1, 0.3]))
                depth = int(rng.integers(0, 8))
                for w in ws:
                    if rng.random() < 0.3:
                        w.sessions = {i: object() for i in
                                      range(int(rng.integers(0, 3)))}
                        w.queue_depth = int(rng.integers(0, 2))
                    if rng.random() < 0.05:
                        w.state = "starting"
                    elif w.state == "starting" and rng.random() < 0.5:
                        w.state = "healthy"
                if tick == 60:
                    mine.adopt_state(now, scale_ups=1, scale_downs=1)
                    ref.adopt_state(now, scale_ups=1, scale_downs=1)
                a, b = mine.decide(now, depth, ws), ref.decide(now, depth, ws)
                assert _ids(a) == _ids(b), (tick, a, b)
                if a and a[0] == "up":
                    ws.append(_FakeWorker(len(ws), gen=tick))
                elif a and a[0] == "down":
                    ws = [w for w in ws if w is not a[1]]
            assert mine.snapshot() == ref.snapshot()
        finally:
            ref.stop()
            mine.stop()
