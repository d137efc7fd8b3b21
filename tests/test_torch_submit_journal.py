"""A submitted job reaches the daemon's scheduler only after its ``submit``
record is journaled and its reply is handed out, and the journal replays
each job to one run.

``TpuDaemon._r_submit`` enqueues the job held and journals it under the
daemon's lock; the HTTP route releases it once the reply is written (a
direct call, before it returns).  The monitor thread's ``step()`` can run
at any instant, so each case below runs one tick inside the submit's
window, between the enqueue and the journal record:

* the journal then holds the ``submit`` record before the ``publish``
  record, and the client its reply, over a direct call and over HTTP;
* with ``daemonkill`` armed at the first publish (a daemon process that
  SIGKILLs itself there), the client still has its reply, and after a
  restart the job is published exactly once;
* ``Journal.replay`` gives each job one outcome when the journal ends
  right after a ``submit`` (queued, published once after restart), holds
  a ``publish`` without its ``submit`` (what a takeover compaction writes
  for a running job), or ends right after a ``publish`` (running,
  re-published at its index and not journaled again), and the same after
  a second takeover.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from ompi_tpu_torch.serve import client
from ompi_tpu_torch.serve import state as _state
from ompi_tpu_torch.serve.daemon import K_JOB, TpuDaemon
from ompi_tpu_torch.serve.queue import JobQueue
from ompi_tpu_torch.tools.chaos import _job_events as _events

REPO = Path(__file__).resolve().parents[1]


def _tick_in_the_submit_window(d: TpuDaemon) -> list[threading.Thread]:
    """Run one monitor tick on another thread as the ``submit`` record is
    about to be journaled, and give it time to finish first."""
    journal = d._journal_ev
    ticks = []

    def journal_ev(ev, **fields):
        if ev == "submit":
            t = threading.Thread(target=d.step, daemon=True)
            ticks.append(t)
            t.start()
            t.join(0.3)
        journal(ev, **fields)

    d._journal_ev = journal_ev
    return ticks


def test_a_held_job_is_not_runnable_until_released():
    q = JobQueue(2, max_pending=0)
    a = q.submit("a.py", tenant="t", nprocs=1, held=True)
    b = q.submit("b.py", tenant="t", nprocs=1)
    assert q.next_runnable({0, 1})["id"] == b["id"]
    assert q.next_runnable({1}) is None
    assert [j["id"] for j in q.state()["queued"]] == [a["id"]]
    q.release(a["id"])
    assert q.next_runnable({1})["id"] == a["id"]


@pytest.mark.parametrize("via", ["direct", "http"])
def test_schedule_cannot_publish_an_unjournaled_submit(via, tmp_path):
    d = TpuDaemon(1, mca={"serve_pidfile": str(tmp_path / "tpud.pid")}, spawn=False)
    try:
        ticks = _tick_in_the_submit_window(d)
        if via == "direct":
            job = json.loads(d._r_submit("/submit", json.dumps(
                {"script": "a.py", "tenant": "t", "nprocs": 1}).encode())[2])
        else:
            job = client.submit(d.url, "a.py", tenant="t", nprocs=1)
        for t in ticks:
            t.join(10)
        assert len(ticks) == 1 and not ticks[0].is_alive()
        d.step()
        assert d.server.peek(K_JOB + "0")["id"] == job["id"]
        assert _events(d.journal_path, job["id"]) == ["submit", "publish"]
    finally:
        d.aggregator.close()
        d.server.close()
        d._journal.close()


#: a workerless daemon with ``daemonkill`` armed at the first publish, one
#: monitor tick run inside each submit's window
KILLED_DAEMON = '''
import sys
import threading

from ompi_tpu_torch.serve.daemon import TpuDaemon

d = TpuDaemon(1, spawn=False, mca={
    "serve_pidfile": sys.argv[1], "faultsim_enable": "1", "faultsim_seed": "1",
    "faultsim_plan": "daemonkill:at=1"})
journal = d._journal_ev


def journal_ev(ev, **fields):
    if ev == "submit":
        t = threading.Thread(target=d.step, daemon=True)
        t.start()
        t.join(0.3)
    journal(ev, **fields)


d._journal_ev = journal_ev
sys.exit(d.run())
'''


def test_daemonkill_at_the_first_publish_leaves_a_replied_submit(tmp_path):
    pidfile = str(tmp_path / "tpud.pid")
    script = tmp_path / "killed_daemon.py"
    script.write_text(KILLED_DAEMON)
    env = dict(os.environ, PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, str(script), pidfile], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
    d2 = None
    try:
        url = None
        for line in proc.stdout:
            if "[tpud] ops: " in line:
                url = line.split("[tpud] ops: ", 1)[1].split("/jobs")[0]
                break
        assert url, "the daemon never printed its ops URL"
        job = client.submit(url, "a.py", tenant="t", nprocs=1)
        assert job["state"] == "queued"
        assert proc.wait(timeout=60) == -signal.SIGKILL
        journal = pidfile + ".journal"
        assert _events(journal, job["id"]) == ["submit"]
        d2 = TpuDaemon(1, mca={"serve_pidfile": pidfile}, spawn=False)
        assert d2.generation == 2
        d2.step()  # no worker survived: a cold boot, then the queued job
        d2.step()
        assert d2.server.peek(K_JOB + "0")["id"] == job["id"]
        assert d2.queue.get(job["id"])["state"] == "running"
        assert _events(journal, job["id"]) == ["submit", "publish"]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        if d2 is not None:
            d2.aggregator.close()
            d2.server.close()
            d2._journal.close()


def _journal(path, *recs) -> str:
    with open(path, "w") as f:
        for ev, fields in recs:
            f.write(json.dumps({"ev": ev, "ts_ns": time.time_ns(), **fields}) + "\n")
    return str(path)


JOB = {"id": "j1", "tenant": "t", "script": "a.py", "args": [], "env": {}, "nprocs": 1,
       "state": "queued", "submit_ns": 1}
DIRECTIVE = {"kind": "job", "id": "j1", "tenant": "t", "script": "a.py", "args": [],
             "env": {}, "procs": [0], "cid_base": 4096, "cid_span": 64, "idx": 0}


CUTS = {"after_submit": [("submit", {"job": JOB})],
        "publish_without_submit": [("publish", {"d": DIRECTIVE})],
        "after_publish": [("submit", {"job": JOB}), ("publish", {"d": DIRECTIVE})]}


def _crash(d: TpuDaemon) -> None:
    """A SIGKILL's leftovers: sockets gone, no clean shutdown in the
    journal, the pidfile naming a dead pid."""
    d.aggregator.close()
    d.server.close()
    d._journal.close()
    info = _state.read_pidfile(d.pidfile)
    info["pid"] = 999999999
    _state.write_pidfile(d.pidfile, info)


def _where(journal: str) -> dict:
    replay = _state.Journal.replay(journal)
    return {"jobs": {k: [j["id"] for j in replay[k]] for k in ("queued", "running", "done")},
            "outstanding": sorted(replay["outstanding"]), "cursor": replay["cursor"]}


def test_replay_runs_each_cut_journal_once(tmp_path):
    """Each cut journal replays to one outcome, again after a takeover that
    crashed before its first tick (whose compaction keeps a running job as
    its ``publish`` alone), and the job is published once in all."""
    for cut, recs in CUTS.items():
        pidfile = tmp_path / cut / "tpud.pid"
        pidfile.parent.mkdir()
        journal = _journal(str(pidfile) + ".journal", *recs)
        want = ({"jobs": {"queued": ["j1"], "running": [], "done": []},
                 "outstanding": [], "cursor": 0} if cut == "after_submit"
                else {"jobs": {"queued": [], "running": ["j1"], "done": []},
                      "outstanding": [0], "cursor": 1})
        assert _where(journal) == want, cut
        _crash(TpuDaemon(1, mca={"serve_pidfile": str(pidfile)}, spawn=False))
        assert _where(journal) == want, cut
        d = TpuDaemon(1, mca={"serve_pidfile": str(pidfile)}, spawn=False)
        try:
            assert d.generation == 2
            d.step()  # no worker survived: a cold boot
            d.step()
            assert d.server.peek(K_JOB + "0")["id"] == "j1"
            assert d.server.peek(K_JOB + "1") is None
            rec = d.queue.get("j1")
            if cut == "after_submit":
                assert rec is not None and rec["state"] == "running", (cut, rec)
            else:
                # the run in flight died with the mesh: the queue knows the
                # job and closes it with the cold boot's error
                assert rec is not None and rec["state"] == "failed", (cut, rec)
                assert "mesh lost across daemon restart" in rec["error"]
            assert _events(journal, "j1").count("publish") == 1, cut
        finally:
            d.aggregator.close()
            d.server.close()
            d._journal.close()
