"""Crash-safe write-ahead session journal for a serving fleet.

Counterpart of ``spark_rapids_jni_tpu/serve/journal.py``; a journal
either package writes replays in the other.  A fleet's supervisor
journals every session transition before it exists in memory, so a
restarted supervisor can rebuild its world (coordinator state must be
reconstructible).

Record format — one record per line, crash-safe at every byte::

    <compact JSON payload> \\t <8-hex CRC32 of the payload bytes> \\n

Appends go through ONE sanctioned path (:meth:`SessionJournal.append`):
the line is written with ``O_APPEND`` (a single ``write(2)``, so
concurrent appenders can interleave records but never bytes) and
``fsync``'d before the caller is allowed to mutate in-memory state —
write-ahead, not write-behind.

Replay (:func:`replay`) distinguishes the two damage shapes:

* **Torn tail** — the LAST record is short, unparsable, or fails its
  CRC.  That is exactly what a writer dying mid-``write`` leaves behind
  (O_APPEND + fsync ordering means only the tail can ever be torn), so
  it is truncated cleanly and replay resumes from the last intact
  record; the lost transition re-runs through the adoption ladder.
* **Mid-log corruption** — a record that fails verification but is
  FOLLOWED by an intact one cannot be a torn write; something damaged
  the file.  Replay fails LOUDLY with :class:`JournalCorruption` — a
  journal that lies is worse than no journal.

Record kinds (the reducer in :class:`JournalState` folds them):

========== ==========================================================
``meta``   fleet facts: listen address, transport, store dir, hosts
``spawn``  worker incarnation born: slot, gen, pid, token, host, wdir
``loss``   worker lost (gen dead); ``retired`` = drained on purpose
``stamp``  store fence floor raised; ``revoke`` = one gen fenced
``submit`` session admitted: sid, kind, params, tenant, quota charge
``placed`` session placed on (slot, gen); ``running`` = left the queue
``requeued`` re-placement (same sid) or data-retry (fresh ``new_sid``)
``result`` terminal transition: done/failed/cancelled (+ wall seconds)
``adopt``  a restarted supervisor finished replaying this journal
``replayed`` adoption re-submitted old ``sid`` as ``new_sid``
========== ==========================================================

Fault domains: ``journal_append`` fires inside the sanctioned append
(``journal_torn`` converts to REAL damage — the just-written record's
tail bytes are truncated on disk, then the crash that must accompany a
torn write surfaces); ``journal_replay`` fires per replayed record
(``supervisor_crash`` there kills an ADOPTING supervisor mid-replay,
which is how chaos proves double-restart idempotence).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, List, Optional

from .. import faultinj

_append_probe = faultinj.instrument(lambda: None, "journal_append")
_replay_probe = faultinj.instrument(lambda: None, "journal_replay")

JOURNAL_NAME = "journal.wal"


def journal_path(fleet_dir: str) -> str:
    """Where the fleet's journal lives: one WAL per fleet dir."""
    return os.path.join(fleet_dir, JOURNAL_NAME)


class JournalCorruption(OSError):
    """A non-tail journal record failed verification: the log was
    damaged in place (bit rot, stray write), not torn by a crash.
    Replay refuses to continue — a journal that lies about committed
    transitions could silently re-run or drop sessions."""


class SessionJournal:
    """The sanctioned append-side handle: O_APPEND + CRC trailer +
    fsync per record, one lock so a record's damage conversion can't
    interleave with another append."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fd: Optional[int] = os.open(
            path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        self.appended = 0

    @property
    def closed(self) -> bool:
        return self._fd is None

    def append(self, rec: str, **fields) -> dict:
        """Durably append one record BEFORE the state it describes
        mutates.  Raises :class:`~..faultinj.JournalTornError` after
        converting it into real tail damage (the caller must treat it
        as its own death — a torn record only exists because the writer
        died mid-write), and lets :class:`~..faultinj.SupervisorCrash`
        from the probe propagate untouched."""
        entry = {"rec": str(rec)}
        entry.update(fields)
        payload = json.dumps(entry, separators=(",", ":"),
                             sort_keys=True).encode("utf-8")
        line = payload + b"\t" + (b"%08x" % zlib.crc32(payload)) + b"\n"
        with self._lock:
            fd = self._fd
            if fd is None:
                raise OSError("journal is closed")
            torn: Optional[faultinj.JournalTornError] = None
            try:
                _append_probe()
            except faultinj.JournalTornError as e:
                torn = e
            os.write(fd, line)
            if torn is not None:
                # REAL damage: cut the record mid-bytes, exactly what a
                # crash between write(2) and fsync leaves behind — then
                # die (re-raise), because that is the only way a torn
                # tail ever comes to exist
                end = os.fstat(fd).st_size
                os.ftruncate(fd, max(0, end - max(1, len(line) // 2)))
                raise torn
            os.fsync(fd)
            self.appended += 1
        return entry

    def close(self):
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass

    def abandon(self):
        """Crash-path close: drop the fd with NO finalize record — the
        journal must look exactly like its writer was SIGKILLed."""
        self.close()


class JournalState:
    """The reduction of a replayed journal: everything an adopting
    supervisor needs to rebuild the fleet."""

    def __init__(self):
        self.meta: dict = {}
        # sid -> last-known session fact dict (see _fold)
        self.sessions: Dict[int, dict] = {}
        # slot -> last incarnation fact dict; "state" alive|dead
        self.workers: Dict[int, dict] = {}
        self.stamped_floor = 0
        self.revoked: List[int] = []
        self.tenant_bytes: Dict[str, int] = {}
        self.tenant_seconds: Dict[str, float] = {}
        # every generation ever spawned — a slot's older incarnations
        # are overwritten in ``workers`` but their gens must still be
        # fenceable by the adoption handoff
        self.all_gens: List[int] = []
        self.retired_count = 0
        self.max_sid = 0
        self.max_gen = 0
        self.max_slot = -1
        self.adoptions = 0
        self.records = 0
        self.truncated_tail = False

    def live_sessions(self) -> Dict[int, dict]:
        """Journal-known sessions with no terminal record: what an
        adopting supervisor must recover (re-attach or re-place)."""
        return {sid: s for sid, s in self.sessions.items()
                if s.get("status") not in
                ("done", "failed", "cancelled", "timeout", "shed")}

    def _fold(self, e: dict):
        rec = e.get("rec")
        self.records += 1
        if rec == "meta":
            self.meta = {k: v for k, v in e.items() if k != "rec"}
        elif rec == "spawn":
            slot = int(e.get("slot", -1))
            gen = int(e.get("gen", 0))
            self.workers[slot] = {
                "gen": gen, "pid": int(e.get("pid") or 0),
                "token": str(e.get("token") or ""),
                "host": str(e.get("host") or "local"),
                "wdir": str(e.get("wdir") or ""), "state": "alive"}
            if gen not in self.all_gens:
                self.all_gens.append(gen)
            self.max_gen = max(self.max_gen, gen)
            self.max_slot = max(self.max_slot, slot)
        elif rec in ("loss", "retired"):
            slot = int(e.get("slot", -1))
            w = self.workers.get(slot)
            if w is not None and w["gen"] == int(e.get("gen", w["gen"])):
                w["state"] = "dead"
            if rec == "retired":
                self.retired_count += 1
        elif rec == "stamp":
            self.stamped_floor = max(self.stamped_floor,
                                     int(e.get("floor", 0)))
        elif rec == "revoke":
            gen = int(e.get("gen", 0))
            if gen not in self.revoked:
                self.revoked.append(gen)
        elif rec == "submit":
            sid = int(e.get("sid", 0))
            self.max_sid = max(self.max_sid, sid)
            self.sessions[sid] = {
                "sid": sid, "kind": e.get("kind"),
                "params": e.get("params") or {},
                "tenant": e.get("tenant"),
                "priority": int(e.get("priority") or 0),
                "est_bytes": int(e.get("est_bytes") or 0),
                "timeout_s": e.get("timeout_s"),
                "replayable": bool(e.get("replayable", True)),
                "snapshot": e.get("snapshot"),
                "status": "pending", "slot": None, "gen": None}
            t = str(e.get("tenant"))
            self.tenant_bytes[t] = self.tenant_bytes.get(t, 0) \
                + int(e.get("est_bytes") or 0)
        elif rec == "placed":
            s = self.sessions.get(int(e.get("sid", 0)))
            if s is not None and s["status"] not in ("done", "failed",
                                                     "cancelled"):
                s["status"] = "placed"
                s["slot"] = int(e.get("slot", -1))
                s["gen"] = int(e.get("gen", 0))
        elif rec == "running":
            s = self.sessions.get(int(e.get("sid", 0)))
            if s is not None and s["status"] == "placed":
                s["status"] = "running"
        elif rec in ("requeued", "replayed"):
            sid = int(e.get("sid", 0))
            s = self.sessions.pop(sid, None)
            new_sid = e.get("new_sid")
            if s is None:
                return
            if new_sid is None:
                s["status"], s["slot"], s["gen"] = "pending", None, None
                self.sessions[sid] = s
            else:
                # the session continues under a fresh sid (data-plane
                # retry, or adoption replay): the old sid is DEAD — a
                # later replay must never resurrect it as a duplicate
                s["sid"] = int(new_sid)
                s["status"], s["slot"], s["gen"] = "pending", None, None
                self.sessions[int(new_sid)] = s
                self.max_sid = max(self.max_sid, int(new_sid))
        elif rec == "result":
            sid = int(e.get("sid", 0))
            s = self.sessions.get(sid)
            if s is None:
                s = self.sessions[sid] = {"sid": sid, "status": "pending"}
            s["status"] = str(e.get("status") or "done")
            s["from_cache"] = bool(e.get("from_cache"))
            t = str(e.get("tenant") or s.get("tenant"))
            secs = float(e.get("seconds") or 0.0)
            if secs > 0.0:
                self.tenant_seconds[t] = \
                    self.tenant_seconds.get(t, 0.0) + secs
        elif rec == "adopt":
            self.adoptions += 1


def scan(path: str, truncate: bool = False,
         _tail_out: Optional[List[bool]] = None) -> List[dict]:
    """The journal's intact records, in order, WITHOUT folding them —
    the audit surface (chaos proves "no logical query ran twice" from
    exactly these entries).  Damage semantics match :func:`replay`: a
    damaged final record is a torn tail (skipped; truncated in place
    only when ``truncate``), a damaged record with intact successors
    raises :class:`JournalCorruption`.  Raises ``FileNotFoundError``
    when no journal exists — an adoption pointed at a dir that never
    journaled must fail loudly, not silently adopt nothing."""
    with open(path, "rb") as f:
        raw = f.read()
    entries: List[dict] = []
    bad_at: Optional[int] = None   # offset of the first damaged record
    bad_why = ""
    off = 0
    while off < len(raw):
        nl = raw.find(b"\n", off)
        if nl < 0:
            # no terminator: the writer died mid-write — torn tail
            bad_at, bad_why = off, "record missing its terminator"
            break
        line = raw[off:nl]
        payload, sep, crc_hex = line.rpartition(b"\t")
        ok = bool(sep)
        if ok:
            try:
                ok = int(crc_hex, 16) == zlib.crc32(payload)
            except ValueError:
                ok = False
        entry = None
        if ok:
            try:
                entry = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                ok = False
        if not ok or not isinstance(entry, dict):
            if bad_at is None:
                bad_at = off
                bad_why = "CRC/parse failure"
            # keep scanning: an intact record AFTER this one upgrades
            # a recoverable torn tail into loud corruption
            off = nl + 1
            continue
        if bad_at is not None:
            raise JournalCorruption(
                f"journal {path}: record at byte {bad_at} failed "
                f"verification ({bad_why}) but intact records follow "
                f"it — mid-log corruption, refusing to replay")
        entries.append(entry)
        off = nl + 1
    if bad_at is not None and truncate:
        with open(path, "r+b") as f:
            f.truncate(bad_at)
    if _tail_out is not None:
        _tail_out.append(bad_at is not None)
    return entries


def replay(path: str, truncate: bool = True) -> JournalState:
    """Replay ``path`` into a :class:`JournalState` (see :func:`scan`
    for the damage contract the raw pass applies first)."""
    tail: List[bool] = []
    entries = scan(path, truncate=truncate, _tail_out=tail)
    state = JournalState()
    state.truncated_tail = tail[0]
    for entry in entries:
        # per-record probe: supervisor_crash here kills an ADOPTING
        # supervisor mid-replay — the double-restart path
        _replay_probe()
        state._fold(entry)
    return state
