"""Durable daemon state — pidfile lock + job-stream journal.

Port of ``ompi_tpu/serve/state.py`` (pure logic, unchanged: a pidfile
or journal written by either package is read by the other).  The tpud
control plane's crash-safety substrate: everything the daemon process
holds only in memory — its identity, the job queue, the directive
stream cursor, the worker pids — dies with a SIGKILL, and a daemon
without it orphans every resident worker when that happens.  Two small
on-disk artifacts fix it:

* the **pidfile** (``serve_pidfile``) is a JSON record of the live
  daemon: pid, generation, and the three addresses a worker or
  operator needs to find it (KVS, ops HTTP URL, telemetry ingest).
  Acquisition implements *stale-lock takeover*: a pidfile whose pid is
  dead is reaped and its generation continued; a pidfile whose pid is
  alive refuses the second daemon.  Resident workers that lose their
  daemon poll this file for a higher generation — the re-adoption
  rendezvous;
* the **journal** (``serve_journal``, append-only JSONL next to the
  pidfile) records the job stream: submissions, published directives,
  directive completions, worker spawns/adoptions, clean shutdowns.
  :func:`Journal.replay` folds it back into the state a restarted
  daemon needs — queued jobs to re-admit, in-flight directives to
  re-publish at their ORIGINAL indices (workers dedup by cursor, so a
  replayed directive executes exactly once), the stream cursor, the
  CID-block high-water mark, and the last known pid per rank (the
  liveness test that decides re-adopt vs respawn).

Both are plain files, written atomically (tmp + rename) or
appended+flushed per event; no daemon state outlives a clean
shutdown (the pidfile is removed and a ``shutdown`` event resets the
journal's replay state).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def pid_alive(pid: int) -> bool:
    """Best-effort liveness: signal 0 probes existence (EPERM counts
    as alive — some other user's process holds the pid).  A ZOMBIE is
    dead: a SIGKILLed worker whose reaper is slow still answers
    kill-0, and a launch agent adopting it as 'alive' would hold a
    corpse's rank forever (found by the whole-host-kill soak)."""
    if pid <= 0:
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            # field 3 (after the parenthesized comm, which may itself
            # contain spaces) is the state letter
            state = f.read().rsplit(")", 1)[-1].split()
        if state and state[0] == "Z":
            return False
    except (OSError, IndexError, ValueError):
        pass  # no procfs: keep the kill-0 answer
    return True


def read_pidfile(path: str) -> dict | None:
    """Parse the pidfile; None when absent or corrupt (a torn write is
    treated exactly like a stale lock — reaped on acquire)."""
    try:
        with open(path) as f:
            info = json.loads(f.read() or "{}")
    except (OSError, ValueError):
        return None
    return info if isinstance(info, dict) and "pid" in info else None


def pidfile_ready(info: dict | None) -> bool:
    """True for a FULL pidfile record a peer may re-attach through.
    :func:`acquire_pidfile` publishes a provisional ``O_EXCL`` claim
    (``{pid, claiming, <reaped generation>}``) before the daemon's
    sockets exist; a parked worker/agent polling inside that window
    must keep waiting for the full-record overwrite — the claim has
    no KVS address to dial, and its generation is the DEAD
    predecessor's, so a same-generation worker would mistake the
    restarting daemon for its old one."""
    return (bool(info) and not info.get("claiming")
            and bool(info.get("kvs")))


def write_pidfile(path: str, info: dict) -> None:
    """Atomic publish (tmp + rename): a reader never sees a torn
    record, and the rename is the commit point workers poll for."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(info, sort_keys=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class DaemonAlreadyRunning(RuntimeError):
    """A live daemon owns the pidfile; ``.info`` is its record."""

    def __init__(self, info: dict):
        super().__init__(
            f"tpud already running (pid {info.get('pid')}, ops "
            f"{info.get('url', '?')}) — pidfile {info.get('path', '')!r}")
        self.info = info


def acquire_pidfile(path: str) -> dict | None:
    """Take the pidfile lock.  Returns the STALE record we reaped
    (the restart-recovery cue, generation included) or None for a
    fresh start; raises :class:`DaemonAlreadyRunning` when the
    recorded pid is alive — including the loser of a concurrent
    takeover race: after reaping a stale record, the lock is CLAIMED
    with an ``O_CREAT|O_EXCL`` create (a provisional record carrying
    our live pid), so two simultaneously restarted daemons cannot
    both believe they own it.  The caller overwrites the claim with
    its full record once its sockets exist (addresses are part of the
    record)."""
    info = read_pidfile(path)
    if info is not None and pid_alive(int(info.get("pid", 0))):
        raise DaemonAlreadyRunning(dict(info, path=path))
    if info is not None:
        try:
            os.unlink(path)
        except OSError:
            pass
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        # a racing daemon claimed between our unlink and create
        raise DaemonAlreadyRunning(
            dict(read_pidfile(path) or {"pid": -1}, path=path))
    with os.fdopen(fd, "w") as f:
        f.write(json.dumps({"pid": os.getpid(), "claiming": True,
                            "generation": int((info or {})
                                              .get("generation", 0))}))
        f.flush()
        os.fsync(f.fileno())
    return info


def remove_pidfile(path: str) -> None:
    """Release on clean shutdown — only if we still own it (a newer
    generation may have taken over a lock we wrongly held)."""
    info = read_pidfile(path)
    if info is not None and int(info.get("pid", -1)) != os.getpid():
        return
    try:
        os.unlink(path)
    except OSError:
        pass


class Journal:
    """Append-only JSONL event log of the job stream.

    Events (one JSON object per line, ``ev`` discriminates):

    ``submit``    a job admitted to the queue (full record)
    ``publish``   a directive appended to the stream (full directive,
                  ``idx`` inside)
    ``finish``    a directive completed (``idx``; job directives also
                  carry the final job record)
    ``retry``     a repair-killed job re-enqueued under its retry
                  budget: ONE atomic record closes the failed
                  attempt's directive (``idx``) AND re-queues the job
                  (``job``, ``retries`` bumped) — a daemon crash on
                  either side of this line replays to exactly one
                  re-run (before: attempt still outstanding, closed
                  again after restart by the workers' cached
                  completion records, retry decision re-made once;
                  after: job queued once, attempt closed)
    ``spawn``     a worker process launched or re-adopted
                  (``rank``/``pid``/``incarnation``/``adopted``;
                  ``host`` names the owning launch agent's host index
                  on the multi-host DVM leg — the placement a
                  restarted daemon routes liveness/respawn through) —
                  also un-retires the rank (a /scale restore)
    ``agent``     a per-host launch agent spawned or re-adopted
                  (``host``/``session``; informational — agent
                  liveness is heartbeat-driven, not replayed)
    ``repair_pending``  a rank was respawned and its repair directive
                  is NOT yet finished (``rank``/``incarnation``) — a
                  daemon SIGKILLed between the respawn and the
                  replace() completion finishes the repair after
                  restart instead of stranding the reborn worker;
                  cleared by the repair directive's ``finish``
    ``retire``    ranks scaled down (``ranks``) — a restart must not
                  resurrect an operator's scale-down
    ``drain``     admission stopped — a restart must stay draining
    ``takeover``  a restarted daemon recovered this journal
    ``compact``   the rewrite marker a takeover leaves after
                  :meth:`compact` (carries the cursor/cid/generation
                  floors the dropped events once established)
    ``shutdown``  clean daemon shutdown — replay state resets here

    Repeated SIGKILL→restart cycles must not grow the journal without
    bound: every takeover first **compacts** it — the file is
    rewritten with only live state (queued/running jobs, the last
    spawn per rank, retire/drain marks, pending repairs, done-job
    history), and every FINISHED published directive collapses to a
    constant-size ``noop`` index stub.  The stubs keep the stream's
    index space contiguous — workers consume indices strictly in
    order, so a hole below a still-lagging worker's cursor would
    wedge it; a ``noop`` is consumed and ignored.

    A *long-lived* daemon that never crashes never takes over, so the
    takeover-time compaction alone still grows the file without
    bound.  **Rotation** closes that edge: with ``max_bytes``/
    ``max_age_s`` armed (``serve_journal_max_kb`` /
    ``serve_journal_max_age_s``), :meth:`append` checks the bounds
    after writing and, when crossed, rewrites the journal in place as
    one compacted snapshot (the same ``compact`` fixed point — a
    ``compact`` marker line plus live state) and starts a fresh tail.
    Replay is unchanged: it already reads snapshot + tail, because a
    rotated journal is byte-for-byte what a takeover compaction
    leaves.  Rotation is atomic (tmp+rename) and crash-safe — a
    SIGKILL mid-rotation replays either the old file or the complete
    snapshot, never a half of each.
    """

    def __init__(self, path: str, max_bytes: int = 0,
                 max_age_s: float = 0.0):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_s)
        #: rotation counter (tests / ops introspection)
        self.rotations = 0
        self._birth = time.monotonic()
        # a SIGKILLed writer can leave a torn final line; terminate it
        # before appending, or the first post-takeover event glues to
        # the torn tail and BOTH lines are lost to replay
        try:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (OSError, ValueError):
            torn = False
        self._f = open(path, "a")
        if torn:
            self._f.write("\n")
            self._f.flush()

    def append(self, ev: str, **fields: Any) -> None:
        rec = {"ev": ev, "ts_ns": time.time_ns(), **fields}
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        if self._should_rotate():
            self.rotate()

    def _should_rotate(self) -> bool:
        if self.max_bytes > 0:
            try:
                if self._f.tell() > self.max_bytes:
                    return True
            except (OSError, ValueError):
                return False
        if self.max_age_s > 0:
            return time.monotonic() - self._birth > self.max_age_s
        return False

    def rotate(self) -> None:
        """Compact-in-place: fold the current file through
        :meth:`replay`, rewrite it as the :meth:`compact` snapshot
        (atomic tmp+rename), and reopen a fresh append tail.  The
        size/age clocks reset; the snapshot IS a valid journal, so a
        crash at any point replays cleanly."""
        try:
            self._f.close()
        except OSError:
            pass
        Journal.compact(self.path, Journal.replay(self.path))
        self._f = open(self.path, "a")
        self._birth = time.monotonic()
        self.rotations += 1

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    @staticmethod
    def compact(path: str, replay: dict) -> None:
        """Rewrite the journal with only live state (takeover-time
        dedup): one event per queued job, done-job record, last spawn
        per rank, pending repair, retire/drain mark — and one
        constant-size ``noop`` stub per FINISHED published directive
        (index-space continuity, see the class docstring).  Repeated
        crash→restart cycles re-derive this fixed point instead of
        appending to an ever-growing history.  Atomic (tmp+rename):
        a crash mid-compaction replays the old file."""
        tmp = f"{path}.compact.{os.getpid()}"
        with open(tmp, "w") as f:
            def w(ev: str, **fields: Any) -> None:
                f.write(json.dumps({"ev": ev, "ts_ns": time.time_ns(),
                                    **fields}, sort_keys=True) + "\n")

            w("compact", cursor=int(replay["cursor"]),
              cid_next=replay["cid_next"],
              generation=int(replay["generation"]))
            for job in replay["queued"]:
                w("submit", job=job)
            for job in replay["done"]:
                w("finish", idx=-1, kind="job", job=job)
            for idx in sorted(replay["published"]):
                d = replay["published"][idx]
                if idx in replay["outstanding"]:
                    w("publish", d=d)
                else:
                    w("publish", d={"kind": "noop", "idx": int(idx)})
            for r in sorted(replay["pids"]):
                st = replay["pids"][r]
                w("spawn", rank=int(r), pid=int(st.get("pid", 0)),
                  incarnation=int(st.get("incarnation", 0)),
                  **({"host": int(st["host"])}
                     if st.get("host") is not None else {}))
            for r in sorted(replay.get("repairing", {})):
                w("repair_pending", rank=int(r),
                  incarnation=int(replay["repairing"][r]))
            if replay["retired"]:
                w("retire", ranks=[int(r) for r in replay["retired"]])
            if replay["draining"]:
                w("drain")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def replay(path: str) -> dict:
        """Fold the journal into restart state (empty state when the
        file is absent, unparseable lines skipped — a torn final line
        from the crash instant must not poison recovery):

        ``queued``       job records admitted but never published
        ``running``      job records whose directive is outstanding
        ``done``         finished job records (ops-surface history)
        ``published``    idx → directive, EVERY publish (finished
                         included — the restart must re-create the
                         whole stream: workers consume strictly in
                         order, so a hole below a finished index
                         would wedge any worker still beneath it)
        ``outstanding``  idx → directive, published but not finished
        ``cursor``       next directive index
        ``cid_next``     first CID block not yet handed out
        ``pids``         rank → {pid, incarnation} (last spawn/adopt)
        ``retired``      ranks scaled down and not since restored
        ``draining``     True when admission was stopped pre-crash
        ``generation``   takeover count recorded so far
        ``clean``        True when the tail is a clean shutdown
        """
        jobs: dict[str, dict] = {}
        published: dict[int, dict] = {}
        finished: dict[int, dict] = {}
        #: job ids whose LATEST record came from a ``retry`` event —
        #: their queued state must win over the published-and-finished
        #: done classification below
        retried_ids: set[str] = set()
        pids: dict[int, dict] = {}
        repairing: dict[int, int] = {}
        retired: set[int] = set()
        draining = False
        generation = 0
        cursor_floor = 0
        cid_floor: int | None = None
        clean = True

        def _reset() -> None:
            nonlocal draining, cursor_floor, cid_floor
            jobs.clear()
            published.clear()
            finished.clear()
            retried_ids.clear()
            pids.clear()
            repairing.clear()
            retired.clear()
            draining = False
            cursor_floor = 0
            cid_floor = None

        try:
            f = open(path)
        except OSError:
            return {"queued": [], "running": [], "done": [],
                    "published": {}, "outstanding": {}, "cursor": 0,
                    "cid_next": None, "pids": {}, "repairing": {},
                    "retired": [], "draining": False, "generation": 0,
                    "clean": True, "events": 0}
        events = 0
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail line from the crash instant
                events += 1
                ev = rec.get("ev")
                if ev == "submit":
                    job = rec.get("job") or {}
                    if job.get("id"):
                        jobs[job["id"]] = job
                    clean = False
                elif ev == "publish":
                    d = rec.get("d") or {}
                    if "idx" in d:
                        published[int(d["idx"])] = d
                    clean = False
                elif ev == "finish":
                    idx = int(rec.get("idx", -1))
                    finished[idx] = rec
                    if rec.get("kind") == "repair":
                        repairing.clear()
                    job = rec.get("job")
                    if job and job.get("id"):
                        jobs[job["id"]] = job
                elif ev == "retry":
                    # one atomic record = close the failed attempt's
                    # directive AND re-queue the job (retries bumped):
                    # either the line exists (attempt closed, job
                    # queued once) or it doesn't (attempt still
                    # outstanding — re-published on restart, workers'
                    # cached completion records close it again and the
                    # retry decision re-runs once).  Exactly-once
                    # either way.
                    idx = int(rec.get("idx", -1))
                    finished[idx] = rec
                    job = rec.get("job")
                    if job and job.get("id"):
                        jobs[job["id"]] = job
                        retried_ids.add(job["id"])
                    clean = False
                elif ev == "repair_pending":
                    repairing[int(rec.get("rank", -1))] = int(
                        rec.get("incarnation", 0))
                    clean = False
                elif ev == "compact":
                    cursor_floor = max(cursor_floor,
                                       int(rec.get("cursor", 0)))
                    if rec.get("cid_next") is not None:
                        cid_floor = int(rec["cid_next"])
                    generation = max(generation,
                                     int(rec.get("generation", 0)))
                elif ev == "spawn":
                    rank = int(rec.get("rank", -1))
                    pids[rank] = {
                        "pid": int(rec.get("pid", 0)),
                        "incarnation": int(rec.get("incarnation", 0))}
                    if rec.get("host") is not None:
                        # multi-host placement: the owning launch
                        # agent's host index — a restarted daemon
                        # routes this rank's liveness/respawn through
                        # that agent instead of a local pid probe
                        pids[rank]["host"] = int(rec["host"])
                    retired.discard(rank)  # /scale restore
                    clean = False
                elif ev == "retire":
                    for r in rec.get("ranks", ()):
                        retired.add(int(r))
                        repairing.pop(int(r), None)
                    clean = False
                elif ev == "drain":
                    draining = True
                    clean = False
                elif ev == "takeover":
                    generation = max(generation,
                                     int(rec.get("generation", 0)))
                elif ev == "shutdown":
                    _reset()
                    clean = True
        outstanding = {i: d for i, d in published.items()
                       if i not in finished and d.get("kind") != "noop"}
        # an outstanding job directive with no submit record (a takeover
        # compaction keeps a running job as its publish alone) is that
        # job's one run: its record comes from the directive
        for d in outstanding.values():
            if d.get("kind", "job") == "job" and d.get("id") \
                    and d["id"] not in jobs:
                jobs[d["id"]] = {
                    **{k: d[k] for k in ("id", "tenant", "script", "args",
                                         "env") if k in d},
                    "nprocs": len(d.get("procs") or ()),
                    "state": "running"}
        published_job_ids = {d.get("id") for d in published.values()
                             if d.get("kind", "job") == "job"}
        queued, running, done = [], [], []
        for job in jobs.values():
            if job.get("state") in ("done", "failed"):
                done.append(job)
            elif job["id"] in {d.get("id") for d in outstanding.values()}:
                running.append(job)
            elif (job["id"] in published_job_ids
                    and not (job.get("state") == "queued"
                             and job["id"] in retried_ids)):
                # published AND finished but the finish event lost its
                # job payload — count it done with what we have.  A
                # job whose latest record is a retry re-queue is NOT
                # done: its published history belongs to the closed
                # attempt, and swallowing it here would eat the retry.
                done.append(dict(job, state=job.get("state", "done")))
            else:
                queued.append(job)
        cid_next = cid_floor
        for d in published.values():
            if "cid_base" in d:
                top = int(d["cid_base"]) + int(d.get("cid_span", 0))
                cid_next = top if cid_next is None else max(cid_next, top)
        return {
            "queued": queued, "running": running, "done": done,
            "published": dict(published), "outstanding": outstanding,
            "cursor": max(cursor_floor,
                          (max(published) + 1) if published else 0),
            "cid_next": cid_next, "pids": pids,
            "repairing": dict(repairing),
            "retired": sorted(retired), "draining": draining,
            "generation": generation, "clean": clean,
            "events": events,
        }
