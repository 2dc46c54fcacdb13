"""The fleet's control plane: load-aware placement and autoscaling.

Counterpart of ``spark_rapids_jni_tpu/serve/elastic.py``.  Two pieces,
both fed by signals that already ride the control plane (a pong is a few
dozen bytes and carries everything placement needs):

* :class:`Placement` replaces slot round-robin with scoring.  At SPAWN
  time it picks the host for a new incarnation: fewest live slots first
  (the fleet spreads across hosts before it stacks), summed pong load as
  the tie-break.  At DISPATCH time it picks the worker for a session from
  the healthy candidates: effective depth (placed sessions + the worker's
  own admission queue from its pong) first, then arena pressure, then
  the stall-suspect count, then slot id for determinism.
  ``serve_placement=round_robin`` keeps a pure rotation as the
  comparison arm.
* :class:`AutoScaler` is a control loop over the supervisor's admission
  queue depth.  Depth above the high-water mark for a full hold dwell
  (a one-tick burst is not pressure) asks for a worker, up to the
  maximum; depth at or below the low-water mark with a worker idle past
  the idle dwell asks to retire one, newest slot first so the base fleet
  keeps its slot ids.  The front door's tick, drain and retire that act
  on these decisions are ROADMAP item 16d, and so are the
  ``serve_autoscale_*`` knobs: until then the thresholds are the
  constructor's arguments, defaulting to the reference's knob defaults.

Neither class owns a lock: every entry point is called by the front door
with its fleet lock held, which is why no method blocks.  ``stop()`` is
the one exception: lock-free, a monotonic flag.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

from .. import config

_MODES = ("load", "round_robin")

# the reference's serve_autoscale_* knob defaults (the knobs are 16d)
HIGH_WATER, LOW_WATER, MIN_WORKERS, MAX_WORKERS = 4, 0, 0, 8
HOLD_MS, IDLE_MS = 250.0, 1000.0


def _worker_load(w) -> Tuple[float, float, int]:
    """(effective queue depth, arena pressure, stall suspicion) for one
    worker handle, from its placed sessions + last pong."""
    depth = len(getattr(w, "sessions", {}) or {}) \
        + int(getattr(w, "queue_depth", 0) or 0)
    pool = float(getattr(w, "pool_bytes", 0) or 0)
    arena = float(getattr(w, "arena_bytes", 0) or 0)
    frac = (arena / pool) if pool > 0 else 0.0
    return float(depth), round(frac, 3), int(getattr(w, "stall_suspect", 0))


class Placement:
    """Where does a new worker go, and which worker gets a session."""

    def __init__(self, hosts: List[str], mode: Optional[str] = None):
        self.hosts = [str(h) for h in hosts] or ["local"]
        self.mode = str(mode if mode is not None
                        else config.get("serve_placement"))
        if self.mode not in _MODES:
            raise ValueError(
                f"serve_placement must be one of {_MODES}, "
                f"got {self.mode!r}")
        self._rr = itertools.count()

    # -- spawn-time: host selection -------------------------------------
    def host_for_slot(self, slot: int, workers) -> str:
        """Host for a new incarnation of ``slot``.  Round-robin mode (or
        a single host) keeps the legacy ``slot % len(hosts)``; load mode
        scores hosts by live-slot count first — so a fleet always
        spreads before it stacks — with summed pong load and host index
        as tie-breaks."""
        if self.mode == "round_robin" or len(self.hosts) == 1:
            return self.hosts[slot % len(self.hosts)]
        live: Dict[str, List] = {h: [] for h in self.hosts}
        for w in workers:
            if getattr(w, "state", "dead") in ("starting", "healthy") \
                    and w.host in live:
                live[w.host].append(w)
        def score(idx_host):
            idx, host = idx_host
            ws = live[host]
            depth = sum(_worker_load(w)[0] for w in ws)
            return (len(ws), depth, idx)
        return min(enumerate(self.hosts), key=score)[1]

    # -- dispatch-time: worker selection --------------------------------
    def pick(self, candidates: List) -> Optional[object]:
        """Pick one worker from healthy-with-capacity ``candidates``."""
        if not candidates:
            return None
        if self.mode == "round_robin":
            ordered = sorted(candidates, key=lambda w: w.worker_id)
            return ordered[next(self._rr) % len(ordered)]
        return min(candidates,
                   key=lambda w: _worker_load(w) + (w.worker_id,))


class AutoScaler:
    """Queue-driven capacity control for the front door.

    ``decide()`` takes the admission-queue depth and the live worker
    handles (under the fleet lock) and returns ``("up", None)``,
    ``("down", handle)`` or ``None``; the front door owns the spawn and
    drain mechanics.  ``stop()`` releases the loop (idempotent)."""

    def __init__(self, base_workers: int,
                 high_water: Optional[int] = None,
                 low_water: Optional[int] = None,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 hold_ms: Optional[float] = None,
                 idle_ms: Optional[float] = None):
        base = max(1, int(base_workers))

        def arg(v, default):
            return default if v is None else v

        self.high_water = int(arg(high_water, HIGH_WATER))
        self.low_water = int(arg(low_water, LOW_WATER))
        cfg_min = int(arg(min_workers, MIN_WORKERS))
        self.min_workers = cfg_min if cfg_min > 0 else base
        self.max_workers = max(self.min_workers,
                               int(arg(max_workers, MAX_WORKERS)))
        self.hold_s = float(arg(hold_ms, HOLD_MS)) / 1000.0
        self.idle_s = float(arg(idle_ms, IDLE_MS)) / 1000.0
        self.scale_ups = 0
        self.scale_downs = 0
        self._above_since: Optional[float] = None
        self._idle_since: Dict[Tuple[int, int], float] = {}
        self._cooldown_until = 0.0
        self._stopped = False

    def stop(self):
        self._stopped = True
        self._idle_since.clear()

    def adopt_state(self, now: Optional[float], scale_ups: int = 0,
                    scale_downs: int = 0):
        """Rebuild loop state from journal facts after a supervisor
        restart: restore the lifetime counters the dead generation had
        accumulated and open a full idle-dwell cooldown (adopted workers
        reattach over seconds, and a fresh loop judging that quiet
        window live would retire capacity the fleet is about to
        need)."""
        if now is None:
            now = time.monotonic()
        self.scale_ups = max(self.scale_ups, int(scale_ups))
        self.scale_downs = max(self.scale_downs, int(scale_downs))
        self._above_since = None
        self._idle_since.clear()
        self._cooldown_until = max(self._cooldown_until,
                                   now + max(self.idle_s, self.hold_s))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def snapshot(self) -> dict:
        return {
            "high_water": self.high_water,
            "low_water": self.low_water,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
        }

    def decide(self, now: Optional[float], queue_depth: int,
               workers: List) -> Optional[Tuple[str, Optional[object]]]:
        if self._stopped:
            return None
        if now is None:
            now = time.monotonic()
        alive = [w for w in workers
                 if getattr(w, "state", "dead") in ("starting", "healthy")
                 and not getattr(w, "retiring", False)]
        n = len(alive)

        # -- scale up: sustained pressure above the high-water mark
        if queue_depth > self.high_water and n < self.max_workers:
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= self.hold_s \
                    and now >= self._cooldown_until:
                self._above_since = None
                self._cooldown_until = now + self.hold_s
                self.scale_ups += 1
                return ("up", None)
            return None
        self._above_since = None

        # -- scale down: slack queue + a worker idle past the dwell
        keys = set()
        candidate = None
        if queue_depth <= self.low_water and n > self.min_workers:
            for w in alive:
                if w.state != "healthy":
                    continue
                depth, _frac, _stall = _worker_load(w)
                key = (w.worker_id, w.gen)
                keys.add(key)
                if depth > 0:
                    self._idle_since.pop(key, None)
                    continue
                since = self._idle_since.setdefault(key, now)
                if now - since < self.idle_s or now < self._cooldown_until:
                    continue
                # newest slot first: the base fleet keeps its slot ids
                if candidate is None \
                        or w.worker_id > candidate.worker_id:
                    candidate = w
        # drop idle entries for workers that are gone or busy again
        for key in list(self._idle_since):
            if key not in keys:
                del self._idle_since[key]
        if candidate is not None:
            self._idle_since.pop((candidate.worker_id, candidate.gen),
                                 None)
            self._cooldown_until = now + self.idle_s
            self.scale_downs += 1
            return ("down", candidate)
        return None
