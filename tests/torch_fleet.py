"""Shared pieces of the port's fleet tests (``test_torch_frontdoor.py``,
``test_torch_fleet_transport.py``): a CPU fleet whose worker pids are
recorded and checked dead at close, bounded polling, and the autouse
``fleet_hygiene`` fixture a module imports to hold every case to leaving
nothing behind.  Not a test module."""

import os
import signal
import threading
import time

import pytest

from spark_rapids_jni_tpu_torch import config, faultinj
from spark_rapids_jni_tpu_torch.serve import FrontDoor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120.0


def poll(pred, timeout=60.0, interval=0.02):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


class Fleet:
    """A FrontDoor on the CPU whose every worker pid is recorded, shut
    down by :meth:`close`, which checks no pid survives and the fleet
    directory is gone (``retained``: only the store is left)."""

    def __init__(self, **kw):
        # one second, so 3.5 s of silence declares a worker wedged: on a
        # box loaded by other test processes, a worker or this process
        # (its reader and monitor threads) can be starved for most of a
        # second, and a quarter-second beat then kills healthy workers.
        # The stall case, which tests that detection, sets its own beat
        kw.setdefault("heartbeat_ms", 1000.0)
        kw.setdefault("device", "cpu")
        self.fd = FrontDoor(**kw)
        self.pids = set()
        self.report = None

    def healthy(self, n=None, timeout=90.0):
        n = self.fd._n_workers if n is None else n
        ok = poll(lambda: self._count_healthy() >= n, timeout)
        assert ok, {k: w.state for k, w in self.fd._workers.items()}

    def _count_healthy(self):
        self.pids |= set(self.fd.worker_pids().values())
        with self.fd._lock:
            return sum(1 for w in self.fd._workers.values()
                       if w.state == "healthy")

    def kill(self, slot: int):
        with self.fd._lock:
            pid = self.fd._workers[slot].proc.pid
        self.pids.add(pid)
        os.kill(pid, signal.SIGKILL)

    def close(self, retained=False) -> dict:
        self.pids |= set(self.fd.worker_pids().values())
        self.report = self.fd.shutdown()
        self.pids |= {e["pid"] for e in self.report["workers"].values()}
        assert poll(lambda: not [p for p in self.pids if alive(p)], 30.0), \
            [p for p in self.pids if alive(p)]
        if retained:
            assert os.listdir(self.fd.fleet_dir) == ["shuffle-store"]
        else:
            assert not os.path.exists(self.fd.fleet_dir)
        return self.report


def env_snapshot():
    # pytest itself rewrites PYTEST_CURRENT_TEST around every phase
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


def fd_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("frontdoor-")}


@pytest.fixture(autouse=True)
def fleet_hygiene():
    """Nothing a case does outlives it: env, cwd, knobs, fault rules,
    front-door threads."""
    env, cwd = env_snapshot(), os.getcwd()
    before = fd_threads()  # the shared fleet's, which outlive a case
    config.set("serve_backoff_ms", 40.0)
    yield
    for knob in ("serve_backoff_ms", "shuffle_store_retain"):
        config.reset(knob)
    faultinj.configure({})
    assert poll(lambda: fd_threads() <= before, 10.0), \
        [t.name for t in fd_threads() - before]
    assert env_snapshot() == env
    assert os.getcwd() == cwd
