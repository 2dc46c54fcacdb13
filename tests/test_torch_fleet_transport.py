"""PyTorch port: the serving fleet's transports with real worker
processes on the CPU (``device="cpu"``), against the reference's
``tests/test_frontdoor.py::TestMultiHostTransport``: a two-host TCP fleet
on the frames plane (``arrow_batch`` bit for bit against the reference's
``make_result_batch`` through its own codec), a dropped link that
reattaches without losing its session, a partitioned worker that
self-fences, and a worker whose supervisor goes silent past
``--orphan-grace-ms`` (the orphan self-fence, under a bare listener).

Each case has a fleet of its own, shut down in a ``finally``, and
checks that no worker pid it saw is alive and that the fleet directory
is gone; ``torch_fleet.fleet_hygiene`` holds every case to leaving no
environment entry, fault rule, knob, cwd or front-door thread behind.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from spark_rapids_jni_tpu.columnar import arrow as JA
from spark_rapids_jni_tpu.serve import worker as jworker

from spark_rapids_jni_tpu_torch import faultinj
from spark_rapids_jni_tpu_torch.serve import wire
from spark_rapids_jni_tpu_torch.shuffle.store import ShuffleStore

from torch_fleet import ROOT, WAIT, Fleet, alive, env_snapshot
from torch_fleet import fleet_hygiene  # noqa: F401 (autouse)
from torch_parity import port_form, ref_form
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


class TestTransport:
    def test_two_host_tcp_fleet_with_frames_plane(self):
        """A host list of two forces TCP; each host gets a slot, echo
        round-trips, and ``arrow_batch`` rides the frames plane bit for
        bit."""
        f = Fleet(workers=2, hosts=["hostA", "hostB"])
        try:
            assert f.fd._transport == "tcp"
            assert f.fd._data_plane == "frames"
            f.healthy()
            sessions = [f.fd.submit("echo", {"value": f"v{i}"},
                                    tenant=f"t{i % 2}") for i in range(4)]
            assert [s.result(timeout=WAIT) for s in sessions] == \
                [f"v{i}" for i in range(4)]
            got = f.fd.submit("arrow_batch", {"rows": 3001, "seed": 2},
                              tenant="t0").result(timeout=WAIT)
            ref = jworker.make_result_batch(3001, 2)
            buf, fp = JA.batch_to_ipc(ref)
            back = JA.ipc_to_batch(buf.to_pybytes(), fp)
            for n in back.names:
                assert port_form(got[n]) == ref_form(back[n]), n
        finally:
            report = f.close()
        assert report["clean"], report
        assert report["transport"] == "tcp"
        assert report["data_plane"]["plane"] == "frames"
        assert report["data_plane"]["batches"] == 1
        assert {e["host"] for e in report["workers"].values()} == \
            {"hostA", "hostB"}

    def test_reconnect_reattaches_without_session_loss(self):
        faultinj.configure({"faults": [
            {"match": "net_send_sup", "fault": "net_drop", "count": 1}]})
        f = Fleet(workers=1, partition_grace_ms=8000.0)
        try:
            s = f.fd.submit("sleep", {"seconds": 1.0}, tenant="t0",
                            replayable=True)
            assert s.result(timeout=WAIT) == "slept"
            assert s.replacements == 0  # a link loss is not a worker loss
        finally:
            report = f.close()
        assert report["clean"], report
        assert report["fleet"]["reconnects"] >= 1
        assert report["fleet"]["crashes"] == 0
        assert report["fleet"]["respawns"] == 0
        assert any(e.get("fault") == "net_drop"
                   for e in faultinj.fired_log())

    def test_partitioned_worker_self_fences(self):
        """A worker cut off past the partition grace revokes its own
        epoch, writes the sentinel and exits; the session re-places, and
        the fenced generation can never commit."""
        faultinj.configure({"faults": [
            {"match": "net_send_wk", "fault": "net_drop", "skip": 2,
             "count": 4}]})
        f = Fleet(workers=1, partition_grace_ms=700.0, reconnect_max=3)
        try:
            s = f.fd.submit("sleep", {"seconds": 2.0}, tenant="t0",
                            replayable=True)
            assert s.result(timeout=WAIT) == "slept"
            assert s.replacements >= 1
            assert 1 in f.fd._store.revoked()
            zombie = ShuffleStore(f.fd.store_dir, epoch=1)
            assert not zombie.put("zp", "map", {"x": torch.arange(4)})
            f.healthy()
        finally:
            report = f.close()
        assert report["clean"], report
        assert report["fleet"]["self_fenced_workers"] >= 1
        assert report["fleet"]["partitions_detected"] >= 1
        entry = report["self_fenced"][0]
        assert entry["worker_id"] == 0 and entry["epoch"] == 1
        assert entry["fenced_commits"] == 0

    def test_orphaned_worker_self_fences(self):
        """A worker whose supervisor took its hello and then went silent,
        the link still up, past ``--orphan-grace-ms`` revokes its own
        epoch, writes the sentinel with reason ``orphaned``, says bye
        and exits rc 3: a supervisor that hangs leaks no process and no
        unfenced generation.  The supervisor here is a bare listener."""
        d = tempfile.mkdtemp(prefix="srj_orph_")
        wdir, store_dir = os.path.join(d, "w0"), os.path.join(d, "store")
        os.makedirs(wdir)
        listener, addr = wire.listen("unix", os.path.join(d, "s.sock"))
        listener.settimeout(WAIT)
        env = {k: v for k, v in env_snapshot().items()
               if k not in (faultinj.ENV_CONFIG, faultinj.ENV_MIRROR)}
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_jni_tpu_torch.serve.worker",
             "--socket", addr, "--worker-id", "0", "--dir", wdir,
             "--device", "cpu", "--store-dir", store_dir, "--epoch", "1",
             "--orphan-grace-ms", "500"],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        link = None
        try:
            conn, _ = listener.accept()
            link = wire.wrap(conn, "unix", role="sup")
            link.settimeout(WAIT)
            hello = link.recv()
            assert (hello["op"], hello["worker_id"], hello["pid"],
                    hello["fence_epoch"]) == ("hello", 0, proc.pid, 1)
            assert proc.wait(timeout=WAIT) == 3
            assert link.recv()["op"] == "bye"
            with open(os.path.join(wdir, "self-fenced.json")) as f:
                info = json.load(f)
            assert info["reason"].startswith("orphaned")
            assert (info["epoch"], info["fenced_commits"]) == (1, 0)
            zombie = ShuffleStore(store_dir, epoch=1)
            assert zombie.fenced(1)
            assert not zombie.put("zo", "map", {"x": torch.arange(4)})
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if link is not None:
                link.close()
            listener.close()
            shutil.rmtree(d, ignore_errors=True)
        assert not alive(proc.pid)
