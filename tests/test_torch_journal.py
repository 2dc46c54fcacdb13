"""PyTorch port: the write-ahead session journal (``serve/journal.py``)
against the reference's ``tests/test_journal.py``, case for case: the
record format's per-line CRC trailer, the two damage shapes replay
distinguishes (a torn tail truncates cleanly and replay continues; a
damaged record with intact successors fails loudly), replay idempotence
and the fold semantics.  Then parity with the JAX package: a journal
either package writes replays to the same ``JournalState`` in the
other, torn tail included.
"""

import json
import os
import zlib

import pytest

from spark_rapids_jni_tpu import faultinj as jfaultinj
from spark_rapids_jni_tpu.serve import journal as jjournal

from spark_rapids_jni_tpu_torch import faultinj
from spark_rapids_jni_tpu_torch.serve import journal


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faultinj.configure(None)
    jfaultinj.configure(None)


def _jpath(tmp_path):
    return journal.journal_path(str(tmp_path))


def _write_wave(path, n=3, mod=journal):
    """A tiny but representative lifecycle: meta, one worker, ``n``
    sessions walked pending→placed→running→done."""
    j = mod.SessionJournal(path)
    j.append("meta", listen="sock", transport="unix", hosts=["local"])
    j.append("spawn", slot=0, gen=1, pid=4242, token="tok-1",
             host="local", wdir="/w0")
    for sid in range(1, n + 1):
        j.append("submit", sid=sid, kind="echo", params={"value": sid},
                 tenant=f"t-{sid}", est_bytes=64)
        j.append("placed", sid=sid, slot=0, gen=1)
        j.append("running", sid=sid)
        j.append("result", sid=sid, status="done", from_cache=False,
                 tenant=f"t-{sid}", seconds=0.25)
    j.close()
    return j


class TestRecordFormat:
    def test_line_is_payload_tab_crc_newline(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("meta", listen="x")
        j.close()
        raw = open(path, "rb").read()
        assert raw.endswith(b"\n")
        payload, sep, crc_hex = raw[:-1].rpartition(b"\t")
        assert sep == b"\t"
        assert int(crc_hex, 16) == zlib.crc32(payload)
        entry = json.loads(payload)
        # compact sorted-keys JSON: byte-reproducible, so the CRC is a
        # stable function of the logical record
        assert payload == json.dumps(
            entry, separators=(",", ":"), sort_keys=True).encode()
        assert entry == {"listen": "x", "rec": "meta"}

    def test_append_counts_and_closed_journal_refuses(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("meta")
        j.append("submit", sid=1, kind="echo", tenant="t")
        assert j.appended == 2
        j.close()
        assert j.closed
        with pytest.raises(OSError):
            j.append("meta")

    def test_missing_journal_fails_loud(self, tmp_path):
        # an adoption pointed at a dir that never journaled must not
        # silently adopt nothing
        with pytest.raises(FileNotFoundError):
            journal.replay(_jpath(tmp_path))


class TestDamageShapes:
    def test_torn_tail_truncates_and_replay_continues(self, tmp_path):
        path = _jpath(tmp_path)
        _write_wave(path, n=2)
        intact = len(journal.scan(path))
        # tear the tail exactly the way a writer dying mid-write(2)
        # does: the final record loses its trailing bytes
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 5)
        state = journal.replay(path)
        assert state.truncated_tail
        assert state.records == intact - 1
        # the truncate healed the file: a second replay is clean
        again = journal.replay(path)
        assert not again.truncated_tail
        assert again.records == intact - 1

    def test_torn_tail_scan_without_truncate_leaves_file(self, tmp_path):
        path = _jpath(tmp_path)
        _write_wave(path, n=1)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 3)
        torn_size = os.path.getsize(path)
        journal.scan(path)  # truncate=False: read-only audit pass
        assert os.path.getsize(path) == torn_size
        journal.scan(path, truncate=True)
        assert os.path.getsize(path) < torn_size

    def test_mid_log_corruption_fails_loud(self, tmp_path):
        path = _jpath(tmp_path)
        _write_wave(path, n=2)
        # flip one payload byte in the FIRST record: intact records
        # follow it, so this can never be a torn write
        raw = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(b"X" + raw[1:])
        with pytest.raises(journal.JournalCorruption):
            journal.replay(path)
        # the loud path must not "heal" anything
        assert open(path, "rb").read() == b"X" + raw[1:]
        with pytest.raises(journal.JournalCorruption):
            journal.scan(path)

    def test_injected_supervisor_crash_fires_before_the_write(
            self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("meta")
        faultinj.configure({"faults": [{
            "match": "journal_append", "count": 1,
            "fault": "supervisor_crash"}]})
        with pytest.raises(faultinj.SupervisorCrash):
            j.append("submit", sid=1, kind="echo", tenant="t")
        j.abandon()
        # the probe fires PRE-write: a crash at the probe loses the
        # record entirely — the journal stays clean, nothing torn
        state = journal.replay(path)
        assert state.records == 1 and not state.truncated_tail
        assert state.sessions == {}

    def test_injected_tear_damages_real_bytes_then_raises(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("meta")
        clean_size = os.path.getsize(path)
        faultinj.configure({"faults": [{
            "match": "journal_append", "count": 1,
            "fault": "journal_torn"}]})
        with pytest.raises(faultinj.JournalTornError):
            j.append("submit", sid=1, kind="echo", tenant="t")
        j.abandon()  # the writer is dead — no finalize record
        # the record made it to disk ONLY as a torn tail: longer than
        # the clean journal, shorter than a whole record
        assert os.path.getsize(path) > clean_size
        state = journal.replay(path)
        assert state.truncated_tail
        assert state.records == 1  # just the meta
        assert state.sessions == {}


class TestFoldSemantics:
    def test_lifecycle_walk_and_live_sessions(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("spawn", slot=0, gen=3, pid=1, token="tk", host="local",
                 wdir="/w")
        j.append("submit", sid=7, kind="echo", params={}, tenant="a",
                 est_bytes=128)
        j.append("submit", sid=8, kind="echo", params={}, tenant="b")
        j.append("placed", sid=7, slot=0, gen=3)
        j.append("running", sid=7)
        j.append("result", sid=7, status="done", from_cache=False,
                 tenant="a", seconds=1.5)
        j.close()
        state = journal.replay(path)
        assert state.sessions[7]["status"] == "done"
        assert state.sessions[8]["status"] == "pending"
        assert set(state.live_sessions()) == {8}
        assert state.workers[0]["gen"] == 3
        assert state.tenant_bytes["a"] == 128
        assert state.tenant_seconds["a"] == pytest.approx(1.5)
        assert state.max_sid == 8 and state.max_gen == 3

    def test_requeued_new_sid_kills_the_old_sid(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("submit", sid=1, kind="echo", params={}, tenant="t")
        j.append("placed", sid=1, slot=0, gen=1)
        j.append("requeued", sid=1, new_sid=2)
        j.close()
        state = journal.replay(path)
        # the old sid is DEAD — replay must never resurrect it as a
        # duplicate next to its continuation
        assert 1 not in state.sessions
        assert state.sessions[2]["status"] == "pending"
        assert state.max_sid == 2

    def test_replay_is_idempotent(self, tmp_path):
        path = _jpath(tmp_path)
        _write_wave(path, n=3)
        a = journal.replay(path)
        b = journal.replay(path)
        assert a.sessions == b.sessions
        assert a.workers == b.workers
        assert (a.stamped_floor, a.revoked, a.max_sid, a.max_gen) == \
               (b.stamped_floor, b.revoked, b.max_sid, b.max_gen)
        assert journal.scan(path) == journal.scan(path)

    def test_fencing_facts_fold(self, tmp_path):
        path = _jpath(tmp_path)
        j = journal.SessionJournal(path)
        j.append("spawn", slot=0, gen=1, pid=1, token="a", host="local",
                 wdir="/w")
        j.append("spawn", slot=0, gen=4, pid=2, token="b", host="local",
                 wdir="/w")  # respawn overwrites the slot...
        j.append("revoke", gen=1)
        j.append("stamp", floor=4)
        j.append("stamp", floor=2)  # floors only ratchet up
        j.close()
        state = journal.replay(path)
        assert state.workers[0]["gen"] == 4
        assert sorted(state.all_gens) == [1, 4]  # ...but gen 1 stays
        assert state.revoked == [1]              # fenceable
        assert state.stamped_floor == 4


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

_STATE_FIELDS = ("meta", "sessions", "workers", "stamped_floor", "revoked",
                 "tenant_bytes", "tenant_seconds", "all_gens",
                 "retired_count", "max_sid", "max_gen", "max_slot",
                 "adoptions", "records", "truncated_tail")


def _state(s):
    return {f: getattr(s, f) for f in _STATE_FIELDS}


def _write_fleet(mod, path):
    """Every record kind the fold knows, through ``mod``'s journal."""
    _write_wave(path, n=2, mod=mod)
    j = mod.SessionJournal(path)
    j.append("spawn", slot=1, gen=2, pid=77, token="tok-2", host="h1",
             wdir="/w1")
    j.append("stamp", floor=2)
    j.append("revoke", gen=1)
    j.append("loss", slot=0, gen=1)
    j.append("retired", slot=1, gen=2)
    j.append("submit", sid=9, kind="q6", params={"rows": 4096},
             tenant="t-9", priority=3, est_bytes=1 << 20, timeout_s=2.5,
             snapshot="mem:ab")
    j.append("placed", sid=9, slot=1, gen=2)
    j.append("requeued", sid=9)
    j.append("submit", sid=10, kind="q9", params={}, tenant="t-10")
    j.append("replayed", sid=10, new_sid=11)
    j.append("adopt")
    j.close()


@pytest.mark.parametrize("torn", [False, True], ids=["whole", "torn_tail"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_alike_in_both_packages(tmp_path, writer, torn):
    wmod = journal if writer == "port" else jjournal
    path = _jpath(tmp_path)
    _write_fleet(wmod, path)
    if torn:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4)
    raw = open(path, "rb").read()
    port = journal.replay(path, truncate=False)
    ref = jjournal.replay(path, truncate=False)
    assert _state(port) == _state(ref)
    assert port.live_sessions() == ref.live_sessions()
    assert port.truncated_tail is torn
    assert journal.scan(path) == jjournal.scan(path)
    assert open(path, "rb").read() == raw  # an audit pass heals nothing


def test_both_packages_write_the_same_bytes(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    _write_fleet(journal, _jpath(tmp_path / "p"))
    _write_fleet(jjournal, _jpath(tmp_path / "r"))
    assert open(_jpath(tmp_path / "p"), "rb").read() == \
        open(_jpath(tmp_path / "r"), "rb").read()


def test_mid_log_corruption_is_loud_in_both(tmp_path):
    path = _jpath(tmp_path)
    _write_fleet(jjournal, path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:10] + b"#" + raw[11:])
    for mod in (journal, jjournal):
        with pytest.raises(mod.JournalCorruption):
            mod.replay(path)
