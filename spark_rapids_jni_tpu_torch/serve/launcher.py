"""How a worker process comes to exist, separated from supervision.

Counterpart of ``spark_rapids_jni_tpu/serve/launcher.py``.  The front
door (:mod:`.frontdoor`) supervises worker *incarnations*: it builds one
argv per generation (``--socket --worker-id --resume-token --epoch
--store-dir --device ...``), waits for the hello that proves the right
incarnation attached, heartbeats it, and runs the loss protocol when it
dies.  None of that cares HOW the process came to exist; this module
owns that:

* :class:`LocalLauncher` execs the argv on this box (``subprocess.Popen``
  with the worker log, the fault-config env and its own session group).
  A worker is always a fresh interpreter, never a fork of the
  supervisor: a parent that has touched CUDA cannot fork a child that
  uses it.
* :class:`RemoteLauncher` runs an agent/ssh-style command template
  locally with the worker argv spliced where ``{argv}`` sits (appended
  when there is none); the agent execs the worker somewhere the fleet
  address is reachable.  The argv is byte-identical to the local
  spawn's, so fencing (``--epoch``) and resume (``--resume-token``
  reattach, self-fence on partition) work unmodified.

Both return a :class:`LaunchedWorker`: a ``Popen``-like surface (``pid``
/ ``poll`` / ``wait`` / ``kill``) plus :meth:`~LaunchedWorker.owns_pid`,
the one contract the hello validation needs.  Locally the worker IS the
child, so the hello's pid must equal the child's; remotely the child is
the agent, so the handle adopts the first pid a hello presents (the
resume token and fence epoch already prove the incarnation) and holds
every later reattach to it.

Every launch crosses the ``launcher_spawn`` fault probe.
"""

from __future__ import annotations

import contextlib
import shlex
import subprocess
from typing import List, Optional

from .. import config, faultinj

# every launch crosses this probe
_launch_probe = faultinj.instrument(lambda: None, "launcher_spawn")


class LaunchedWorker:
    """Handle for one launched worker: the local child process (the
    worker itself, or the agent that carried it somewhere else) plus
    the pid-identity contract the hello validation checks.
    ``close()``/``kill()`` release the child."""

    def __init__(self, proc: subprocess.Popen, remote: bool = False):
        self.proc = proc
        self.remote = bool(remote)
        # remote: the worker pid adopted from its first hello (the
        # agent's local pid proves nothing about the worker)
        self._adopted_pid: Optional[int] = None

    @property
    def pid(self) -> int:
        if self.remote and self._adopted_pid is not None:
            return self._adopted_pid
        return self.proc.pid

    @property
    def returncode(self):
        return self.proc.returncode

    def owns_pid(self, pid) -> bool:
        """Does a hello claiming ``pid`` belong to this launch?  Local:
        the worker is the child, the pids must match.  Remote: adopt the
        first hello's pid (token + epoch already authenticated the
        incarnation), then hold every reattach to it."""
        try:
            pid = int(pid)
        except (TypeError, ValueError):
            return False
        if not self.remote:
            return pid == self.proc.pid
        if self._adopted_pid is None:
            self._adopted_pid = pid
            return True
        return pid == self._adopted_pid

    def poll(self):
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None):
        return self.proc.wait(timeout)

    def kill(self):
        with contextlib.suppress(OSError):
            self.proc.kill()

    def close(self):
        self.kill()


class Launcher:
    """The 'how a worker comes to exist' strategy.  ``launch()`` must
    run the supervisor-built argv somewhere the fleet address is
    reachable and return a :class:`LaunchedWorker`; everything after
    the hello (heartbeats, fencing, loss) is the supervisor's."""

    name = "base"

    def launch(self, argv: List[str], *, cwd: str, env: dict,
               log_path: str) -> LaunchedWorker:
        raise NotImplementedError

    def close(self):
        """Release any launcher-held resources (agent pools etc.)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LocalLauncher(Launcher):
    """Exec the worker argv on this box: a fresh interpreter."""

    name = "local"

    def launch(self, argv: List[str], *, cwd: str, env: dict,
               log_path: str) -> LaunchedWorker:
        _launch_probe()
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                argv, cwd=cwd, env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        finally:
            log.close()
        return LaunchedWorker(proc, remote=False)


class RemoteLauncher(Launcher):
    """Agent/ssh-style launch: run ``template`` locally with the worker
    argv spliced at the ``{argv}`` placeholder (appended when absent).
    The agent inherits the spawn env, so a same-box agent (the test
    shim, a container runner) passes the fault-config/mirror env
    through; a real ssh template is responsible for its own env
    forwarding.  ``kill()`` kills the *agent*: a worker that outlives
    its agent is the partitioned-worker case the self-fence ladder
    already covers."""

    name = "remote"

    def __init__(self, template):
        if isinstance(template, str):
            template = shlex.split(template)
        self.template = [str(t) for t in template]
        if not self.template:
            raise ValueError("RemoteLauncher needs a non-empty command "
                             "template")

    def _command(self, argv: List[str]) -> List[str]:
        if "{argv}" in self.template:
            out: List[str] = []
            for part in self.template:
                if part == "{argv}":
                    out.extend(argv)
                else:
                    out.append(part)
            return out
        return self.template + list(argv)

    def launch(self, argv: List[str], *, cwd: str, env: dict,
               log_path: str) -> LaunchedWorker:
        _launch_probe()
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                self._command(argv), cwd=cwd, env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        finally:
            log.close()
        return LaunchedWorker(proc, remote=True)


def launcher_from_config(spec=None) -> Launcher:
    """Resolve the ``serve_launcher`` knob (or an explicit ``spec``):
    ``"local"`` → :class:`LocalLauncher`; anything else is a shell-style
    command template → :class:`RemoteLauncher`."""
    if spec is None:
        spec = config.get("serve_launcher")
    if isinstance(spec, Launcher):
        return spec
    text = str(spec).strip()
    if not text or text == "local":
        return LocalLauncher()
    return RemoteLauncher(text)
