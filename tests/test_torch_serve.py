"""The port's serving plane (tpud) against the reference's.

Mirrors ``tests/test_serve.py`` case by case on ``ompi_tpu_torch.serve``
(same names, same assertions), and adds parity cases that feed the
same inputs through both packages:

* queue/scheduler and admission units — gang scheduling, FIFO +
  per-tenant round-robin fairness, any-fit under
  ``serve_max_concurrent``, quotas, drain, the telemetry-driven
  AdmissionController, the retry budget;
* admission edges over the real ops surface of a workerless daemon
  (``step()``-driven): shed 429 + Retry-After, drain 503, deadline
  revoke typed ``DeadlineExpired``, ``RetryBudgetExhausted``;
* aggregator job scoping, the api job scope (``push_world``/
  ``pop_world``), ``python -m ompi_tpu_torch ctl --selftest``;
* crash safety: pidfile, journal replay/compaction/rotation, worker and
  agent re-attach, the workerless restart drill;
* parity: one numpy-seeded submit/finish/retry sequence through both
  ``JobQueue``s and ``AdmissionController``s, compared by ``state()``;
  one journal event stream replayed by both ``Journal.replay`` (and a
  journal written by either package replayed by the other); both
  ``SERVING_VARS`` tables and both registries' ``serve_*`` rows.
  Tolerance: exact, except the timestamps ``submit_ns``, ``start_ns``
  and ``end_ns``, which are masked;
* end to end on the CPU (``tpud --cpu``): warm reuse across tenants with
  zero re-dials, overlapping disjoint-tenant jobs, a daemon SIGKILL with
  re-adoption, a rank killed mid-job and repaired before the next job,
  2x2 emulated hosts, and a port tpud job's allreduce results bit-equal
  to a reference tpud job's and to the port's single-process plain ring;
  a CPU daemon never initializes ``torch.cuda``.

Every daemon test unlinks the ``/dev/shm`` names its workers leave.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JOB = REPO / "ompi_tpu_torch" / "examples" / "serve_job.py"


# -- queue / scheduler units -------------------------------------------


def test_queue_gang_fifo_and_tenant_fairness():
    from ompi_tpu_torch.serve.queue import JobQueue

    q = JobQueue(4, max_pending=0)
    a1 = q.submit("a1.py", tenant="alice")
    a2 = q.submit("a2.py", tenant="alice")
    b1 = q.submit("b1.py", tenant="bob")
    # alice submitted first → goes first; bob's single job must not
    # wait behind alice's whole burst (round-robin across tenants)
    first = q.next_runnable({0, 1, 2, 3})
    assert first["id"] == a1["id"] and first["procs"] == [0, 1, 2, 3]
    # gang: nothing fits while all procs are busy
    assert q.next_runnable(set()) is None
    q.finish(first["id"], ok=True)
    second = q.next_runnable({0, 1, 2, 3})
    assert second["id"] == b1["id"], "tenant fairness violated"
    q.finish(second["id"], ok=True)
    assert q.next_runnable({0, 1, 2, 3})["id"] == a2["id"]


def test_queue_subset_jobs_gang_on_partial_mesh():
    from ompi_tpu_torch.serve.queue import JobQueue

    q = JobQueue(4, max_pending=0)
    j1 = q.submit("x.py", nprocs=2)
    j2 = q.submit("y.py", nprocs=2)
    r1 = q.next_runnable({0, 1, 2, 3})
    assert r1["procs"] == [0, 1]
    # the second 2-proc job fits on the remaining ranks concurrently
    r2 = q.next_runnable({2, 3})
    assert r2["id"] == j2["id"] and r2["procs"] == [2, 3]
    assert q.next_runnable(set()) is None
    assert {j["id"] for j in q.running()} == {j1["id"], j2["id"]}


def test_queue_admission_quota_and_drain():
    from ompi_tpu_torch.serve.queue import AdmissionError, JobQueue

    q = JobQueue(2, max_pending=2)
    q.submit("1.py", tenant="t")
    q.submit("2.py", tenant="t")
    with pytest.raises(AdmissionError) as ei:
        q.submit("3.py", tenant="t")
    assert ei.value.status == 429
    q.submit("other.py", tenant="u")  # quota is PER tenant
    q.draining = True
    with pytest.raises(AdmissionError) as ei:
        q.submit("4.py", tenant="v")
    assert ei.value.status == 503
    st = q.state()
    assert st["draining"] and st["tenant_depth"]["t"] == 2


def test_queue_anyfit_max_concurrent_and_hwm():
    from ompi_tpu_torch.serve.queue import JobQueue

    q = JobQueue(4, max_pending=0)
    wide = q.submit("wide.py", tenant="t", nprocs=4)
    narrow = q.submit("narrow.py", tenant="t", nprocs=1)
    # any-fit, not head-of-line: the 4-proc job parked at the head
    # cannot start on 2 free procs, but the 1-proc job behind it can
    r = q.next_runnable({2, 3})
    assert r["id"] == narrow["id"] and r["procs"] == [2]
    assert q.next_runnable({3}) is None  # nothing else fits
    q.finish(narrow["id"], ok=True)
    assert q.next_runnable({0, 1, 2, 3})["id"] == wide["id"]
    q.finish(wide["id"], ok=True)
    # hwm is a high-water mark: it survives the drain
    assert q.counters["jobs_concurrent_hwm"] == 1 and q.idle()

    # serve_max_concurrent bounds how many gangs overlap (0 = any fit)
    q2 = JobQueue(4, max_pending=0, max_concurrent=1)
    q2.submit("a.py", nprocs=1)
    q2.submit("b.py", nprocs=1)
    first = q2.next_runnable({0, 1, 2, 3})
    assert first is not None
    assert q2.next_runnable({1, 2, 3}) is None, "cap not enforced"
    q2.finish(first["id"], ok=True)
    assert q2.next_runnable({0, 1, 2, 3}) is not None
    assert q2.counters["jobs_concurrent_hwm"] == 1


def test_queue_retry_budget_and_exhaustion():
    from ompi_tpu_torch.serve.queue import JobQueue

    q = JobQueue(2, max_pending=0, retry_budget=1)
    j = q.submit("r.py", nprocs=2)
    run = q.next_runnable({0, 1})
    # repair-killed: one budget unit re-queues it, attempt state wiped
    back = q.retry(run["id"])
    assert back is not None and back["state"] == "queued"
    assert back["retries"] == 1 and "procs" not in back
    assert q.counters["jobs_retried"] == 1
    run2 = q.next_runnable({0, 1})
    assert run2["id"] == j["id"]
    # budget consumed: the next repair kill is NOT re-queued — the
    # caller finishes it failed with the typed error instead
    assert q.retry(run2["id"]) is None
    assert q.counters["jobs_retried"] == 1
    assert q.retry("j999") is None  # unknown/not-running: no-op


def test_admission_controller_streak_shed_and_restore():
    from ompi_tpu_torch.serve.queue import (AdmissionController, AdmissionError,
                                      JobQueue)

    # disabled (stall_ns=0): never trips, whatever the deltas
    off = AdmissionController(stall_ns=0)
    off.update({0: 10**12})
    assert not off.overloaded() and not off.enabled()

    ctrl = AdmissionController(stall_ns=1000)
    q = JobQueue(2, max_pending=0, admission=ctrl)
    j = q.submit("a.py", tenant="t", nprocs=1)
    # the first sighting of a proc only establishes its delta baseline
    ctrl.update({0: 10_000})
    assert not ctrl.overloaded() and ctrl.state()["state"] == "ok"
    # one over-threshold delta holds dispatch immediately (stalled)...
    ctrl.update({0: 20_000}, cause="ring-stall")
    assert ctrl.overloaded() and not ctrl.shedding()
    assert q.next_runnable({0, 1}) is None, "dispatch not held"
    st = ctrl.state()
    assert st["state"] == "stalled" and st["cause"] == "ring-stall"
    # ...and SUSTAIN consecutive ticks escalate to shedding
    ctrl.update({0: 30_000}, cause="ring-stall")
    ctrl.update({0: 40_000}, cause="ring-stall")
    assert ctrl.shedding() and ctrl.state()["state"] == "shedding"
    # tenants with work already in the system shed 429 + Retry-After
    with pytest.raises(AdmissionError) as ei:
        q.submit("b.py", tenant="t", nprocs=1)
    assert ei.value.status == 429
    assert ei.value.retry_after == ctrl.retry_after_s() == 3
    assert "ring-stall" in str(ei.value)
    assert q.counters["jobs_shed"] == 1
    # ...but an idle tenant still gets one job in (fairness floor)
    fresh = q.submit("c.py", tenant="fresh", nprocs=1)
    with pytest.raises(AdmissionError):
        q.submit("d.py", tenant="fresh", nprocs=1)
    assert q.counters["jobs_shed"] == 2
    # an unhealthy mesh counts as over-threshold even at zero delta
    sick = AdmissionController(stall_ns=1000)
    sick.update({}, healthy=False, cause="detector")
    assert sick.overloaded() and sick.state()["unhealthy"]
    # one clean (zero-delta, healthy) tick restores admission AND
    # dispatch immediately; the held jobs go out
    ctrl.update({0: 40_000})
    assert not ctrl.overloaded() and ctrl.state()["state"] == "ok"
    got = {q.next_runnable({0})["id"], q.next_runnable({1})["id"]}
    assert got == {j["id"], fresh["id"]}


def test_serving_vars_centrally_registered():
    """SERVING_VARS appear in every store's --mca var listing like the
    observability/robustness sets (acceptance criterion)."""
    from ompi_tpu_torch.core.registry import MCAContext
    from ompi_tpu_torch.core.var import SERVING_VARS, full_var_name

    store = MCAContext().store
    names = {v.full_name for v in store.all_vars()}
    for fw, comp, name, _d, _t, _h in SERVING_VARS:
        assert full_var_name(fw, comp, name) in names
    assert store.get("serve_max_pending") == 8
    assert store.get("serve_cid_block") == 4096


# -- aggregator job scoping --------------------------------------------


def test_aggregator_begin_job_baselines_and_labels():
    """Grow-only per-process counters are re-based per
    job (label + baseline), so a second job's scrape starts at zero;
    straggler tables reset IN PLACE (keys survive, spc.py contract)."""
    from ompi_tpu_torch.metrics.live import TelemetryAggregator

    agg = TelemetryAggregator()
    try:
        agg.ingest({"proc": 0, "nprocs": 2,
                    "native": {"delivered": 100, "reconnects": 2},
                    "colls": [["w/allreduce/0", 1000]]})
        agg.ingest({"proc": 1, "nprocs": 2,
                    "native": {"delivered": 90},
                    "colls": [["w/allreduce/0", 5000]]})
        # the joined instance populated the rolling straggler tables
        assert agg.json_state()["straggler"]["per_proc"]["1"]["n"] == 1
        text = agg.prometheus_text()
        assert 'ompi_tpu_dcn_delivered{proc="0"} 100' in text  # no job
        agg.begin_job("j7")
        # reset-in-place: keys survive zeroed
        pp = agg.json_state()["straggler"]["per_proc"]
        assert set(pp) == {"0", "1"}
        assert all(s["n"] == 0 and s["slowest"] == 0
                   for s in pp.values())
        agg.ingest({"proc": 0, "nprocs": 2, "job": "j7",
                    "native": {"delivered": 130, "reconnects": 2}})
        text = agg.prometheus_text()
        assert 'ompi_tpu_dcn_delivered{proc="0",job="j7"} 30' in text
        assert 'ompi_tpu_dcn_reconnects{proc="0",job="j7"} 0' in text
        jobs = agg.jobs_state()["jobs"]
        assert jobs["j7"]["frames"] == 1 and 0 in jobs["j7"]["procs"]
    finally:
        agg.close()


def test_publisher_frame_carries_job_label():
    from ompi_tpu_torch.metrics import live

    live.set_job("jX")
    try:
        assert live.current_job() == "jX"
        pub = live.TelemetryPublisher.__new__(live.TelemetryPublisher)
        pub.proc, pub.nprocs, pub._detector = 0, 1, None
        assert pub.frame()["job"] == "jX"
    finally:
        live.set_job(None)
        assert "job" not in pub.frame()


# -- api job scope ------------------------------------------------------


def test_push_world_job_scope_and_job_finalize():
    import ompi_tpu_torch.api as api

    world = api.init(device="cpu", nranks=2)
    marker = object()
    api.push_world(marker)
    try:
        assert api.in_job_scope()
        assert api.init() is marker      # job scripts see the job world
        assert api.comm_world() is marker
        api.finalize()                    # JOB finalize: pops, re-arms
        assert api.initialized()
        assert api.comm_world() is world
        assert not api.in_job_scope()
        assert api.pop_world() is None    # idempotence guard
    finally:
        while api.in_job_scope():
            api.pop_world()
    assert api.comm_world() is world
    api.finalize()                        # the real finalize tears down
    assert not api.initialized()


def test_serve_current_job_accessor():
    from ompi_tpu_torch import serve

    assert serve.current_job() is None
    serve._set_current({"id": "j1", "tenant": "t"})
    try:
        assert serve.current_job()["id"] == "j1"
    finally:
        serve._set_current(None)
    assert serve.current_job() is None


def test_tpud_ctl_selftest():
    """Control-plane acceptance over real HTTP, through the package's
    own CLI."""
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "ctl",
                          "--selftest"],
                         capture_output=True, timeout=120,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert b"selftest OK" in res.stdout


# -- crash-safe control plane: pidfile + journal units ------------------


def test_pidfile_acquire_stale_reap_and_live_refusal(tmp_path):
    from ompi_tpu_torch.serve import state as _state

    path = str(tmp_path / "tpud.pid")
    # absent: fresh start — the lock is atomically CLAIMED (O_EXCL)
    # with our live pid so a racing second daemon loses the create
    assert _state.acquire_pidfile(path) is None
    claim = _state.read_pidfile(path)
    assert claim["pid"] == os.getpid() and claim["claiming"]
    # ... and the claim itself refuses a concurrent acquirer
    with pytest.raises(_state.DaemonAlreadyRunning):
        _state.acquire_pidfile(path)
    os.unlink(path)
    # stale (dead pid): reaped, record returned for generation carry,
    # replaced by our claim carrying the stale generation
    _state.write_pidfile(path, {"pid": 999999999, "generation": 3,
                                "url": "http://x"})
    stale = _state.acquire_pidfile(path)
    assert stale["generation"] == 3
    assert _state.read_pidfile(path)["pid"] == os.getpid()
    os.unlink(path)
    # live pid: refused with the running daemon's record
    _state.write_pidfile(path, {"pid": os.getpid(), "generation": 4})
    with pytest.raises(_state.DaemonAlreadyRunning) as ei:
        _state.acquire_pidfile(path)
    assert ei.value.info["pid"] == os.getpid()
    assert _state.read_pidfile(path)["generation"] == 4  # never reaped
    # corrupt pidfile reads as absent (torn write == stale lock)
    with open(path, "w") as f:
        f.write("{half a rec")
    assert _state.read_pidfile(path) is None
    # remove only releases our own lock
    _state.write_pidfile(path, {"pid": 999999998})
    _state.remove_pidfile(path)
    assert os.path.exists(path)
    _state.write_pidfile(path, {"pid": os.getpid()})
    _state.remove_pidfile(path)
    assert not os.path.exists(path)


def test_worker_reattach_skips_restart_claim_window(tmp_path):
    """Regression (found by the sigkill-restart soak): a parked worker
    polling the pidfile while a restarting daemon holds only the
    provisional O_EXCL claim ({pid, claiming, REAPED generation} — no
    KVS address yet) must keep waiting for the full-record overwrite.
    Pre-fix the claim matched the ``alive and gen == self.generation``
    arm (its generation IS the dead predecessor's) and the worker died
    on KeyError('kvs'), so the whole warm mesh cold-booted and the
    in-flight job failed instead of surviving the restart."""
    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve import worker as _worker

    pidfile = str(tmp_path / "tpud.pid")
    _state.write_pidfile(pidfile, {"pid": os.getpid(), "generation": 1,
                                   "kvs": "gen1:0"})

    class _KVS:
        def __init__(self):
            self.dials: list[str] = []
            self.puts: dict[str, object] = {}

        def reconnect(self, addr):
            self.dials.append(addr)

        def put(self, key, value):
            self.puts[key] = value

        def get(self, key, wait=True, timeout=30.0):
            return {"pid": os.getpid(), "generation": 2}

    class _Link(_worker.DaemonLink):
        def _orphan_exit(self, reason):
            raise SystemExit(reason)

    ctx = types.SimpleNamespace(
        kvs=_KVS(), proc=0, ns="t.", incarnation=0,
        engine=types.SimpleNamespace(
            transport=types.SimpleNamespace(address="w:1")))
    os.environ[_worker.ENV_SERVE_PIDFILE] = pidfile
    try:
        link = _Link(ctx, wsize=1, poll=0.01, window=0.4)
        assert link.generation == 1
        # the restart claim: OUR live pid, claiming, the reaped
        # record's generation, no kvs — never dialed, never fatal;
        # with no overwrite the park window expires into orphan-exit
        with open(pidfile, "w") as f:
            f.write(json.dumps({"pid": os.getpid(), "claiming": True,
                                "generation": 1}))
        with pytest.raises(SystemExit) as ei:
            link.reattach()
        assert "serve_reattach_timeout" in str(ei.value)
        assert ctx.kvs.dials == []
        # claim overwritten mid-park by the full generation-2 record:
        # the worker adopts it (re-dial + adopt offer + ack)
        link = _Link(ctx, wsize=1, poll=0.01, window=10.0)

        def _publish_full():
            time.sleep(0.25)
            _state.write_pidfile(pidfile, {"pid": os.getpid(),
                                           "generation": 2,
                                           "kvs": "gen2:0"})

        t = threading.Thread(target=_publish_full)
        t.start()
        link.reattach()
        t.join()
        assert link.generation == 2
        assert ctx.kvs.dials == ["gen2:0"]
        offer = ctx.kvs.puts[f"{_worker.K_ADOPT}0"]
        assert offer["pid"] == os.getpid() and offer["generation"] == 2
    finally:
        os.environ.pop(_worker.ENV_SERVE_PIDFILE, None)


def test_agent_reattach_skips_restart_claim_window(tmp_path):
    """The agent's park loop shares the claim-window hazard: its
    same-generation arm dialed ``info['kvs']`` unguarded too."""
    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.agent import LaunchAgent

    pidfile = str(tmp_path / "tpud.pid")

    class _KVS:
        def __init__(self):
            self.dials: list[str] = []

        def reconnect(self, addr):
            self.dials.append(addr)

    class _Agent:
        _reattach = LaunchAgent._reattach
        hid = 0
        pidfile_ = None

    ag = _Agent()
    ag.pidfile = pidfile
    ag.generation = 1
    ag.window = 0.4
    ag.kvs = _KVS()
    # only the claim on disk: no dial, bounded exit at window expiry
    with open(pidfile, "w") as f:
        f.write(json.dumps({"pid": os.getpid(), "claiming": True,
                            "generation": 1}))
    with pytest.raises(SystemExit):
        ag._reattach()
    assert ag.kvs.dials == []
    # full same-generation record: the plain re-dial arm takes it
    _state.write_pidfile(pidfile, {"pid": os.getpid(), "generation": 1,
                                   "kvs": "gen1:0"})
    ag._reattach()
    assert ag.kvs.dials == ["gen1:0"]


def test_journal_replay_reconstructs_queue_cursor_and_cids(tmp_path):
    """The durable-job contract: submissions without a publish replay
    as queued, published-unfinished directives as outstanding (with
    the cursor and CID high-water restored), finished jobs as done —
    and a clean shutdown resets everything."""
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "tpud.journal")
    j = Journal(path)
    j.append("submit", job={"id": "j1", "tenant": "a", "state": "queued",
                            "submit_ns": 1})
    j.append("submit", job={"id": "j2", "tenant": "b", "state": "queued",
                            "submit_ns": 2})
    j.append("publish", d={"idx": 0, "kind": "job", "id": "j1",
                           "procs": [0], "cid_base": 1 << 20,
                           "cid_span": 4096})
    j.append("spawn", rank=0, pid=1234, incarnation=1)
    j.close()
    st = Journal.replay(path)
    assert [q["id"] for q in st["queued"]] == ["j2"]
    assert [r["id"] for r in st["running"]] == ["j1"]
    assert list(st["outstanding"]) == [0]
    assert st["cursor"] == 1 and st["cid_next"] == (1 << 20) + 4096
    assert st["pids"][0] == {"pid": 1234, "incarnation": 1}
    assert not st["clean"]
    # a torn trailing line (the crash instant) must not poison replay
    with open(path, "a") as f:
        f.write('{"ev": "pub')
    assert Journal.replay(path)["cursor"] == 1
    # finish closes the directive; shutdown resets the replay state
    j = Journal(path)
    j.append("finish", idx=0, kind="job",
             job={"id": "j1", "state": "done"})
    st = Journal.replay(path)
    assert not st["outstanding"] and not st["running"]
    assert {d["id"] for d in st["done"]} == {"j1"}
    # finished directives stay in the published map: the restart must
    # re-create the WHOLE stream (a hole below a finished index would
    # wedge any worker whose cursor is still beneath it)
    assert list(st["published"]) == [0] and st["cursor"] == 1
    # an operator's scale-down and drain outlive a crash; a later
    # spawn (the /scale restore) un-retires the rank
    j.append("retire", ranks=[1])
    j.append("drain")
    st = Journal.replay(path)
    assert st["retired"] == [1] and st["draining"]
    j.append("spawn", rank=1, pid=4321, incarnation=1)
    st = Journal.replay(path)
    assert st["retired"] == [] and st["draining"]
    j.append("shutdown", generation=1)
    j.close()
    st = Journal.replay(path)
    assert st["clean"] and not st["queued"] and st["cursor"] == 0


def test_journal_replay_retry_event_exactly_once(tmp_path):
    """The retry-budget hinge: ONE atomic ``retry`` line closes the
    failed attempt's directive AND re-queues the job.  A crash BEFORE
    the line replays the attempt as still outstanding (the retry
    decision re-runs once after restart); a crash AFTER replays the
    job queued exactly once — never misclassified done even though a
    directive for it was both published and finished."""
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "tpud.journal")
    j = Journal(path)
    job = {"id": "j1", "tenant": "t", "state": "queued", "submit_ns": 1}
    j.append("submit", job=job)
    j.append("publish", d={"idx": 0, "kind": "job", "id": "j1",
                           "procs": [0, 1]})
    # crash BEFORE the retry line: attempt outstanding, job running
    st = Journal.replay(path)
    assert [r["id"] for r in st["running"]] == ["j1"]
    assert list(st["outstanding"]) == [0]
    # the atomic retry line: directive closed + job re-queued
    j.append("retry", idx=0, job=dict(job, retries=1))
    st = Journal.replay(path)
    assert not st["outstanding"] and not st["running"] and not st["done"]
    assert [r["id"] for r in st["queued"]] == ["j1"]
    assert st["queued"][0]["retries"] == 1
    # compaction preserves the re-queued classification (the restart
    # fixed point a SIGKILL-after-retry daemon recovers through)
    Journal.compact(path, st)
    st = Journal.replay(path)
    assert [r["id"] for r in st["queued"]] == ["j1"] and not st["done"]
    # the replayed attempt republishes at a new index and finishes
    j = Journal(path)
    j.append("publish", d={"idx": 1, "kind": "job", "id": "j1",
                           "procs": [0, 1]})
    j.append("finish", idx=1, kind="job",
             job=dict(job, state="done", retries=1))
    j.close()
    st = Journal.replay(path)
    assert [d["id"] for d in st["done"]] == ["j1"] and not st["queued"]


def test_daemon_publishes_pidfile_beacon_kvs(tmp_path):
    """Satellite: the daemon mirrors its pidfile record into the KVS
    (``serve.pidfile.<generation>``) so agents on hosts WITHOUT the
    daemon's filesystem can re-attach without reading daemon-local
    disk."""
    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.daemon import K_PIDFILE, TpuDaemon

    pidfile = str(tmp_path / "tpud.pid")
    d = TpuDaemon(2, mca={"serve_pidfile": pidfile}, spawn=False)
    try:
        beacon = d.server.peek(f"{K_PIDFILE}{d.generation}")
        assert beacon == _state.read_pidfile(pidfile), beacon
        assert beacon["pid"] == os.getpid()
        # the three addresses a re-attaching host needs
        assert beacon["kvs"] and beacon["url"] and beacon["ingest"]
    finally:
        d.aggregator.close()
        d.server.close()


def test_agent_mirrors_pidfile_beacon(tmp_path):
    """The agent half of the beacon: ``_mirror_beacon`` copies the KVS
    record to the host-local pidfile path (workers there poll it as
    usual), never rewrites an equal copy (shared filesystem), and
    no-ops when the beacon is absent (older daemon) or no pidfile is
    configured."""
    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.agent import LaunchAgent

    rec = {"pid": 4242, "generation": 3, "url": "http://x", "kvs": "y"}
    store = {"serve.pidfile.3": rec}

    class _KVS:
        def get(self, key, wait=False):
            return store[key]  # raises KeyError when absent

    class _Agent:
        """Just the attributes ``_mirror_beacon`` reads."""

        _beacon_gen = LaunchAgent._beacon_gen
        _mirror_beacon = LaunchAgent._mirror_beacon

        def __init__(self, pidfile, session, hid):
            self.pidfile, self.session, self.hid = pidfile, session, hid
            self.generation = 1
            self.kvs = _KVS()

    local = str(tmp_path / "mirror.pid")
    ag = _Agent(local, "g3s1", 1)
    ag._mirror_beacon()
    assert _state.read_pidfile(local) == rec
    assert ag.generation == 3  # adopts the beacon's generation
    before = os.stat(local).st_mtime_ns
    ag._mirror_beacon()  # equal copy: no rewrite
    assert os.stat(local).st_mtime_ns == before
    store.clear()  # beacon absent: the plain pidfile poll stands
    ag2 = _Agent(str(tmp_path / "none.pid"), "g1s0", 2)
    ag2._mirror_beacon()
    assert not os.path.exists(ag2.pidfile)
    ag3 = _Agent("", "g1s0", 3)
    ag3._mirror_beacon()  # no pidfile configured: no-op


def test_daemon_restart_recovery_and_readoption_in_process(tmp_path):
    """Workerless restart drill, step()-driven: daemon 1 journals two
    submissions and publishes the first; a simulated SIGKILL (sockets
    dropped, pidfile pid rewritten dead) hands over to daemon 2, which
    must restore the queue/cursor, re-publish the in-flight directive
    at its ORIGINAL index, re-adopt workers offering live pids, close
    the in-flight job from re-put completion records, and publish the
    journal-recovered queued job exactly once."""
    import subprocess as sp

    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.daemon import (K_ADOPT, K_ADOPTED, K_DONE, K_JOB,
                                       TpuDaemon)

    pidfile = str(tmp_path / "tpud.pid")
    mca = {"serve_pidfile": pidfile, "serve_reattach_timeout": "10"}
    fake = [sp.Popen(["sleep", "300"]) for _ in range(2)]
    d1 = d2 = None
    try:
        d1 = TpuDaemon(2, mca=mca, spawn=False)
        _, _, body = d1._r_submit("/submit", json.dumps(
            {"script": "a.py", "tenant": "t"}).encode())
        ja = json.loads(body)
        _, _, body = d1._r_submit("/submit", json.dumps(
            {"script": "b.py", "tenant": "t"}).encode())
        jb = json.loads(body)
        for r, f in enumerate(fake):  # the workers d1 "spawned"
            d1._journal_ev("spawn", rank=r, pid=f.pid, incarnation=0)
        d1.step()  # publishes job A over the full rank set
        assert d1.cursor == 1
        assert d1.server.peek(K_JOB + "0")["id"] == ja["id"]
        # A completes BEFORE the crash (finished directive) and B
        # publishes as the in-flight one — the restart must re-create
        # BOTH stream entries: a hole at the finished index 0 would
        # wedge any worker whose cursor is still beneath it
        for r in range(2):
            d1.server.put_local(f"{K_DONE}0.{r}", {"ok": True, "proc": r})
        d1.step()
        assert d1.queue.get(ja["id"])["state"] == "done"
        assert d1.server.peek(K_JOB + "1")["id"] == jb["id"]
        assert d1.cursor == 2
        # simulated SIGKILL: no clean shutdown, no journal reset
        d1.aggregator.close()
        d1.server.close()
        d1._journal.close()
        info = _state.read_pidfile(pidfile)
        info["pid"] = 999999999
        _state.write_pidfile(pidfile, info)

        d2 = TpuDaemon(2, mca=mca, spawn=False)
        assert d2.generation == 2
        assert d2.cursor == 2 and d2._status == ["adopting"] * 2
        # the WHOLE stream re-published at the SAME indices —
        # finished A included (no holes), in-flight B outstanding
        assert d2.server.peek(K_JOB + "0")["id"] == ja["id"]
        assert d2.server.peek(K_JOB + "1")["id"] == jb["id"]
        assert list(d2._outstanding) == [1]
        qs = d2.queue.state()
        assert not qs["queued"]
        assert [r["id"] for r in qs["running"]] == [jb["id"]]
        assert ja["id"] in qs["done"]
        d2.step()  # live pids, no offers yet: keep waiting, no respawn
        assert d2._status == ["adopting"] * 2
        assert not json.loads(d2._r_jobs("/jobs", b"")[2])["healthy"]
        for r, f in enumerate(fake):  # workers re-attach
            d2.server.put_local(K_ADOPT + str(r), {
                "pid": f.pid, "incarnation": 0, "cursor": 2,
                "generation": d2.generation})
        d2.step()
        assert d2._status == ["active"] * 2
        assert d2.server.peek(K_ADOPTED + "0")["pid"] == fake[0].pid
        # re-put completion records close the in-flight job
        for r in range(2):
            d2.server.put_local(f"{K_DONE}1.{r}", {"ok": True, "proc": r})
        d2.step()
        assert d2.queue.get(jb["id"])["state"] == "done"
        # exactly once: at most ONE publish event per job id across
        # BOTH lives (the takeover compaction collapses the FINISHED
        # job A's directive to a constant-size noop index stub; the
        # in-flight job B's directive survives verbatim)
        pubs = [json.loads(line)["d"].get("id")
                for line in open(d2.journal_path)
                if '"publish"' in line]
        assert pubs.count(ja["id"]) <= 1 and pubs.count(jb["id"]) == 1
        kinds = [json.loads(line)["d"].get("kind", "job")
                 for line in open(d2.journal_path)
                 if '"publish"' in line]
        assert "noop" in kinds  # job A's finished directive compacted
        # the /json daemon line shows the restarted state
        top = d2._top_state()["daemon"]
        assert top["generation"] == 2 and top["crash_safe"]
        for f in fake:  # let close() see dead "workers" immediately
            f.kill()
            f.wait()
        d2.close()
        assert not os.path.exists(pidfile)
        # clean shutdown removes the journal (bounded growth); a
        # replay of the missing file is a fresh start
        assert not os.path.exists(d2.journal_path)
        from ompi_tpu_torch.serve.state import Journal

        st = Journal.replay(d2.journal_path)
        assert st["clean"] and not st["outstanding"]
    finally:
        for f in fake:
            if f.poll() is None:
                f.kill()
        for d in (d1, d2):
            if d is not None:
                d.aggregator.close()
                d.server.close()


def test_tpud_ctl_dead_daemon_is_clean(tmp_path, capsys):
    """Satellite bugfix: ctl against a dead daemon is a one-line
    message, never a traceback — `shutdown` twice is a no-op (rc 0),
    `status` fails cleanly (rc 1), and a stale pidfile is reported and
    reaped."""
    from ompi_tpu_torch.serve import ctl

    # a port nothing listens on
    dead_url = "http://127.0.0.1:1"
    assert ctl.main(["--url", dead_url, "shutdown"]) == 0
    out = capsys.readouterr().out
    assert "already down" in out and "no-op" in out
    assert ctl.main(["--url", dead_url, "status"]) == 1
    err = capsys.readouterr().err
    assert "unreachable" in err and "Traceback" not in err
    # stale pidfile: reported, reaped, clean exits
    from ompi_tpu_torch.serve import state as _state

    pidfile = str(tmp_path / "tpud.pid")
    _state.write_pidfile(pidfile, {"pid": 999999999, "generation": 1,
                                   "url": dead_url})
    assert ctl.main(["--pidfile", pidfile, "status"]) == 1
    out = capsys.readouterr().out
    assert "stale pidfile" in out and "reaping" in out
    assert not os.path.exists(pidfile)
    # shutdown against a now-absent pidfile: idempotent no-op
    assert ctl.main(["--pidfile", pidfile, "shutdown"]) == 0
    assert "no-op" in capsys.readouterr().out


# -- admission edges over the real ops surface (workerless daemon) -----


def _pump_directives(d, stop):
    """Resident-worker stand-in for a workerless daemon: per-proc
    completion records for every published directive.  A job with
    ``CHAOS_DIE=1`` dies with ``rank died`` records on EVERY attempt
    (the retry-budget exhaustion path); ``CHAOS_HANG=1`` jobs answer
    only their revoke (the deadline-expiry path)."""
    from ompi_tpu_torch.serve.daemon import K_DONE, K_JOB

    hung: dict[str, tuple[int, list[int]]] = {}
    n = 0
    while not stop.is_set():
        jd = d.server.peek(f"{K_JOB}{n}")
        if jd is None:
            time.sleep(0.005)
            continue
        kind = jd.get("kind", "job")
        env = jd.get("env") or {}
        if kind == "job" and env.get("CHAOS_DIE") == "1":
            for p in jd.get("procs", ()):
                d.server.put_local(f"{K_DONE}{n}.{p}",
                                   {"ok": False, "proc": p,
                                    "error": "rank died (injected)"})
        elif kind == "job" and env.get("CHAOS_HANG") == "1":
            hung[jd["id"]] = (n, list(jd.get("procs", ())))
        elif kind == "revoke":
            for p in jd.get("procs", ()):
                d.server.put_local(f"{K_DONE}{n}.{p}",
                                   {"ok": True, "proc": p,
                                    "revoked": jd.get("id")})
            hn, procs = hung.pop(jd.get("id"), (None, []))
            if hn is not None:
                for p in procs:
                    d.server.put_local(
                        f"{K_DONE}{hn}.{p}",
                        {"ok": False, "proc": p,
                         "error": "comm revoked mid-collective"})
        else:
            for p in jd.get("procs", ()):
                d.server.put_local(f"{K_DONE}{n}.{p}",
                                   {"ok": True, "proc": p})
        n += 1


def _steps_until(d, cond, what, deadline_s=20.0):
    end = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < end:
        d.step()
        time.sleep(0.01)
    assert cond(), f"daemon never converged: {what}"


def test_daemon_shed_429_and_drain_503_in_process():
    """Admission edges over the REAL ops HTTP surface (workerless
    daemon, step()-driven): sustained stall ticks flip admission to
    shedding — a busy tenant's submit is 429 with the Retry-After hint
    surfaced by the client — dispatch is held while overloaded, one
    clean tick restores, and ``/drain`` rejects NEW submits 503 while
    the in-flight job still finishes."""
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve.daemon import K_DONE, K_JOB, TpuDaemon

    d = TpuDaemon(2, mca={"serve_admission_stall_ns": "1000"},
                  spawn=False)
    try:
        ctrl = d.queue.admission
        j = client.submit(d.url, "a.py", tenant="t", nprocs=1)
        # drive the controller the way _admission_update would: one
        # baseline tick, then SUSTAIN over-threshold deltas
        for k in range(4):
            ctrl.update({0: (k + 1) * 10_000}, cause="arrival-skew")
        assert ctrl.shedding()
        with pytest.raises(client.ServeError) as ei:
            client.submit(d.url, "b.py", tenant="t", nprocs=1)
        assert ei.value.status == 429
        assert ei.value.retry_after == 3.0  # real Retry-After header
        assert "arrival-skew" in str(ei.value)
        st = client.status(d.url)
        assert st["admission"]["state"] == "shedding", st["admission"]
        assert st["counters"]["jobs_shed"] == 1
        # dispatch held while overloaded: the queued job stays queued
        d.step()
        assert client.status(d.url, j["id"])["state"] == "queued"
        # one clean tick restores; the held job dispatches
        ctrl.update({0: 40_000})
        assert client.status(d.url)["admission"]["state"] == "ok"
        d.step()
        jd = d.server.peek(K_JOB + "0")
        assert jd["id"] == j["id"]
        # drain while j is in flight: NEW submits refuse 503...
        client.drain(d.url)
        with pytest.raises(client.ServeError) as ei:
            client.submit(d.url, "c.py", tenant="u", nprocs=1)
        assert ei.value.status == 503
        # ...but the in-flight job still runs to completion
        for p in jd["procs"]:
            d.server.put_local(f"{K_DONE}0.{p}", {"ok": True, "proc": p})
        _steps_until(
            d, lambda: client.status(d.url, j["id"])["state"] == "done",
            "in-flight job finishing under drain")
    finally:
        d.aggregator.close()
        d.server.close()


def test_daemon_deadline_revoke_and_retry_exhaustion_in_process():
    """Deadline expiry revokes exactly the slow job — typed
    ``DeadlineExpired`` on /job/<id>, the concurrently running
    bystander job unperturbed — and a job repair-killed past its
    retry budget fails with the typed ``RetryBudgetExhausted`` error
    (never a wedged gang)."""
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve.daemon import TpuDaemon

    d = TpuDaemon(2, mca={"serve_job_deadline_s": "0.3",
                          "serve_retry_budget": "1"}, spawn=False)
    stop = threading.Event()
    threading.Thread(target=_pump_directives, args=(d, stop),
                     daemon=True).start()
    try:
        # blocked-state frames for BOTH procs (whichever the hung job's
        # gang landed on): the deadline path must capture its hang
        # report from these BEFORE publishing the revoke
        t = time.time_ns()
        for p in (0, 1):
            d.aggregator.ingest({
                "proc": p, "nprocs": 2, "ts_ns": t, "native": {},
                "straggler": {}, "colls": [],
                "waits": {"ts_ns": t, "waits": [
                    {"site": "coll_recv", "plane": "host", "peer": 1 - p,
                     "since_ns": t - 500_000_000}]}})
        jh = client.submit(d.url, "h.py", tenant="a", nprocs=1,
                           env={"CHAOS_HANG": "1"})
        jb = client.submit(d.url, "b.py", tenant="b", nprocs=1)
        _steps_until(
            d, lambda: client.status(d.url, jh["id"])["state"] == "failed",
            "deadline expiry")
        rec = client.status(d.url, jh["id"])
        assert rec["error"].startswith("DeadlineExpired"), rec
        assert "serve_job_deadline_s=0.3" in rec["error"], rec
        # the attached hang report names the stalled gang's blocked
        # wait (captured pre-revoke, keyed by this job's id)
        hang = rec.get("hang")
        assert hang, rec
        assert hang["reason"] == f"deadline:{jh['id']}", hang
        (gang_proc,) = [int(p) for p in rec["procs"]]
        (e,) = hang["graph"]["edges"]
        assert e["src"] == gang_proc and e["site"] == "coll_recv", hang
        assert hang["verdict"]["kind"] == "straggler", hang
        # bystander quiet: the disjoint gang finished its job normally
        # — and its record carries NO hang report
        brec = client.status(d.url, jb["id"])
        assert brec["state"] == "done"
        assert "hang" not in brec, brec
        assert client.status(
            d.url)["counters"]["jobs_deadline_expired"] == 1
        # retry exhaustion: the job dies on BOTH attempts — one budget
        # unit replays it, the second kill fails it typed
        jr = client.submit(d.url, "r.py", tenant="a", nprocs=1,
                           env={"CHAOS_DIE": "1"})
        _steps_until(
            d, lambda: client.status(d.url, jr["id"])["state"] == "failed",
            "retry-budget exhaustion")
        rec = client.status(d.url, jr["id"])
        assert rec["error"].startswith("RetryBudgetExhausted"), rec
        assert "rank died" in rec["error"], rec
        assert int(rec.get("retries", 0)) == 1, rec
        c = client.status(d.url)["counters"]
        assert c["jobs_retried"] == 1 and c["jobs_deadline_expired"] == 1
    finally:
        stop.set()
        d.aggregator.close()
        d.server.close()


# -- np=2 daemon acceptance --------------------------------------------


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    return env


class _Tpud:
    """Daemon-under-test: launch, URL discovery, log capture, and the
    ``/dev/shm`` names of every worker it spawned unlinked at close.

    ``pkg="port"``: ``python -m ompi_tpu_torch run --daemon`` (or the
    ``tpud`` command with ``entry="tpud"``), workers on the CPU through
    ``--cpu`` with ``--nranks`` ranks each; ``pkg="ref"``: the
    reference's ``python -m ompi_tpu run --daemon --cpu-devices``."""

    def __init__(self, mca=(), np_=2, extra=(), pkg="port", nranks=1,
                 btl="tcp", entry="run", wrapper=None):
        if pkg == "ref":
            cmd = [sys.executable, "-m", "ompi_tpu", "run", "-np", str(np_),
                   "--daemon", "--cpu-devices", str(nranks)]
        elif entry == "tpud":
            cmd = [sys.executable, "-m", "ompi_tpu_torch", "tpud",
                   "-np", str(np_), "--nranks", str(nranks), "--cpu"]
        else:
            cmd = [sys.executable, "-m", "ompi_tpu_torch", "run",
                   "-np", str(np_), "--daemon", "--nranks", str(nranks),
                   "--cpu"]
        if wrapper is not None:  # run the CLI under a wrapper script
            cmd = [sys.executable, str(wrapper)] + cmd[3:]
        if btl:
            cmd += ["--mca", "btl", btl]
        cmd += list(extra)
        for k, v in mca:
            cmd += ["--mca", k, v]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, env=_env(),
                                     cwd=str(REPO))
        self.lines: list[str] = []
        self.pids: set[int] = set()
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()
        self.url = self._await_url()
        self.track()

    def _read(self):
        for raw in iter(self.proc.stdout.readline, b""):
            self.lines.append(raw.decode(errors="replace"))

    def _await_url(self) -> str:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and self.proc.poll() is None:
            for l in list(self.lines):
                if "[tpud] ops: " in l:
                    return l.split("[tpud] ops: ", 1)[1].split("/jobs")[0]
            time.sleep(0.05)
        raise AssertionError("tpud never printed its ops URL:\n"
                             + self.out())

    def track(self) -> None:
        """Remember the worker pids the daemon reports (respawns
        included, when called again)."""
        try:
            with urllib.request.urlopen(self.url + "/jobs", timeout=5) as r:
                st = json.loads(r.read().decode())
        except (OSError, ValueError):
            return
        self.pids |= {int(p["pid"]) for p in st.get("procs", {}).values()
                      if p.get("pid")}

    def out(self) -> str:
        return "".join(self.lines)

    def close(self):
        if self.proc.poll() is None:
            self.track()
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._t.join(timeout=10)
        _reap_workers(self.pids)


def _reap_workers(pids) -> None:
    """Kill any worker still alive, then unlink the shared-memory names
    the dead ones left (both packages' prefixes embed the creator pid)."""
    from ompi_tpu_torch.boot.tpurun import _unlink_leftovers
    from ompi_tpu_torch.serve import state as _state

    for p in pids:
        if _state.pid_alive(p):
            try:
                os.kill(p, 9)
            except OSError:
                pass
    deadline = time.monotonic() + 10
    while (any(_state.pid_alive(p) for p in pids)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    _unlink_leftovers(list(pids))


def _scrape(url: str, path: str) -> str:
    with urllib.request.urlopen(url + path, timeout=5) as r:
        return r.read().decode()


def test_tpud_np2_two_tenants_warm_reuse_quota_and_drain():
    """THE acceptance run: two sequential jobs from different tenants
    reuse one warm mesh — disjoint CID blocks, clean seq state
    (verified collectives + p2p inside the job script), zero endpoint
    re-dials between jobs (flat reconnects/retry_dials) — plus
    per-tenant quota rejection with a resubmit admitted only after the
    queue drains, job-labeled live metrics, and a clean shutdown."""
    from ompi_tpu_torch.serve import client

    d = _Tpud(mca=[("serve_max_pending", "2")])
    try:
        j1 = client.submit(d.url, str(JOB), tenant="alice")
        r1 = client.wait(d.url, j1["id"], timeout=120)
        assert r1["state"] == "done", r1
        j2 = client.submit(d.url, str(JOB), tenant="bob")
        r2 = client.wait(d.url, j2["id"], timeout=60)
        assert r2["state"] == "done", r2

        # disjoint CID blocks, monotone (tenant isolation in CID space)
        assert r2["ranks"]["0"]["cid_base"] >= (
            r1["ranks"]["0"]["cid_base"] + 4096), (r1, r2)
        for rec in list(r1["ranks"].values()) + list(r2["ranks"].values()):
            assert rec["cid"] == rec["cid_base"], rec

        # warm reuse: ZERO re-dials — flat reconnect/dial counters
        # within each job AND across the two jobs
        for r in (r1, r2):
            for rec in r["ranks"].values():
                assert rec["dials_before"] == rec["dials_after"], rec
        for p in ("0", "1"):
            assert (r1["ranks"][p]["dials_after"]
                    == r2["ranks"][p]["dials_after"]), (r1, r2)

        # per-tenant admission: carol floods her quota with slow jobs;
        # the third submit is rejected, then admitted after the queue
        # drains
        c1 = client.submit(d.url, str(JOB), tenant="carol",
                           env={"SERVE_SLEEP": "1.5"})
        c2 = client.submit(d.url, str(JOB), tenant="carol",
                           env={"SERVE_SLEEP": "0.2"})
        with pytest.raises(client.ServeError) as ei:
            client.submit(d.url, str(JOB), tenant="carol")
        assert ei.value.status == 429
        rc1 = client.wait(d.url, c1["id"], timeout=60)
        rc2 = client.wait(d.url, c2["id"], timeout=60)
        assert rc1["state"] == "done" and rc2["state"] == "done"
        # FIFO per tenant: c2 ran only after c1 finished (gang over the
        # full rank-set serializes them)
        assert rc2["start_ns"] >= rc1["end_ns"] - int(50e6), (rc1, rc2)
        c3 = client.submit(d.url, str(JOB), tenant="carol")
        assert client.wait(d.url, c3["id"], timeout=60)["state"] == "done"

        # live scrape carries the job label (job-scoped aggregator)
        text = _scrape(d.url, "/metrics")
        assert f'job="{c3["id"]}"' in text, text[:2000]
        jobs = client.status(d.url)
        assert jobs["healthy"] and not jobs["running"], jobs
        assert len(jobs["done"]) == 5

        client.shutdown(d.url)
        assert d.proc.wait(timeout=60) == 0, d.out()
    finally:
        d.close()
    out = d.out()
    # every job ran in-process on the two resident workers: 5 jobs × 2
    # ranks of OK lines, and exactly 2 worker boots
    assert len([l for l in out.splitlines()
                if "OK SERVE_JOB" in l]) == 10, out
    assert len([l for l in out.splitlines()
                if "resident worker up" in l]) == 2, out


def test_tpud_np2_disjoint_tenant_jobs_overlap():
    """The concurrency acceptance: two 1-proc jobs from different
    tenants run AT THE SAME TIME on the warm np=2 mesh (any-fit gang
    scheduling + per-job worker threads) — jobs_concurrent_hwm hits 2,
    both complete bit-exact on disjoint ranks with flat dial counters
    (isolation never re-dialed the transport), and /metrics exposes
    the serving counters as ``proc="daemon"`` samples."""
    from ompi_tpu_torch.serve import client

    d = _Tpud()
    try:
        ja = client.submit(d.url, str(JOB), tenant="alice", nprocs=1,
                           env={"SERVE_SLEEP": "1.5"})
        jb = client.submit(d.url, str(JOB), tenant="bob", nprocs=1,
                           env={"SERVE_SLEEP": "1.5"})
        ra = client.wait(d.url, ja["id"], timeout=120)
        rb = client.wait(d.url, jb["id"], timeout=60)
        assert ra["state"] == "done" and rb["state"] == "done", (ra, rb)
        # truly concurrent: disjoint ranks, overlapping run windows,
        # and the high-water mark proves both gangs were live at once
        assert ra["procs"] != rb["procs"], (ra, rb)
        assert (max(ra["start_ns"], rb["start_ns"])
                < min(ra["end_ns"], rb["end_ns"])), (ra, rb)
        st = client.status(d.url)
        assert st["counters"]["jobs_concurrent_hwm"] == 2, st["counters"]
        for r in (ra, rb):
            for rec in r["ranks"].values():
                assert rec["dials_before"] == rec["dials_after"], rec
        text = _scrape(d.url, "/metrics")
        assert "jobs_concurrent_hwm" in text, text[:2000]
        assert 'proc="daemon"' in text, text[:2000]
        client.shutdown(d.url)
        assert d.proc.wait(timeout=60) == 0, d.out()
    finally:
        d.close()
    out = d.out()
    assert len([l for l in out.splitlines()
                if "OK SERVE_JOB" in l]) == 2, out


def test_tpud_np2_sigkill_daemon_restart_readopts_and_recovers(tmp_path):
    """THE crash-safety acceptance: SIGKILL the daemon mid-job with a
    second job queued.  The resident workers must survive the outage
    (the in-flight job keeps running), a restarted daemon must reap
    the stale pidfile, replay the journal, re-adopt BOTH workers
    (incarnation 0 — the warm mesh, endpoints, and CIDs never went
    away; flat reconnect/dial counters prove zero re-dials), collect
    the in-flight job's completion, run the journal-recovered queued
    job exactly once, and a process-table sweep after the final
    shutdown must find zero orphaned workers."""
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.state import Journal

    pidfile = str(tmp_path / "tpud.pid")
    journal = pidfile + ".journal"
    mca = [("serve_pidfile", pidfile), ("serve_reattach_timeout", "30"),
           ("dcn_recv_timeout", "8"), ("dcn_cts_timeout", "8"),
           ("dcn_connect_timeout", "4")]

    def worker_pids():
        return [st["pid"] for st in Journal.replay(journal)["pids"]
                .values() if st.get("pid")]

    d1 = _Tpud(mca=mca)
    d2 = None
    try:
        # job A occupies proc 0 across the crash; job B stays queued
        # behind it in the journal (proc 1 idle: nprocs=1 + tenant
        # FIFO keeps B queued only if it needs A's rank — use the full
        # rank-set for A so B genuinely queues)
        ja = client.submit(d1.url, str(JOB), tenant="alice",
                           env={"SERVE_SLEEP": "8"})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if client.status(d1.url, ja["id"]).get("state") == "running":
                break
            time.sleep(0.1)
        jb = client.submit(d1.url, str(JOB), tenant="bob")
        pids = worker_pids()
        assert len(pids) == 2
        d1.proc.kill()  # SIGKILL: no cleanup, no journal reset
        d1.proc.wait(timeout=30)
        time.sleep(1.0)
        assert all(_state.pid_alive(p) for p in pids), (
            "workers must survive the daemon SIGKILL")

        d2 = _Tpud(mca=mca)
        ra = client.wait(d2.url, ja["id"], timeout=90)
        rb = client.wait(d2.url, jb["id"], timeout=90)
        assert ra["state"] == "done", (ra, d2.out())
        assert rb["state"] == "done", (rb, d2.out())
        # re-adopted, not respawned: same incarnation, flat dials
        out2 = d2.out()
        assert len([l for l in out2.splitlines()
                    if "re-adopted rank" in l]) == 2, out2
        st = client.status(d2.url)
        assert all(st["procs"][str(r)]["incarnation"] == 0
                   and st["procs"][str(r)]["status"] == "active"
                   for r in range(2)), st
        assert st["generation"] == 2, st
        for rec in list(ra["ranks"].values()) + list(rb["ranks"].values()):
            assert rec["dials_before"] == rec["dials_after"], rec
        # warm CID space continues past the pre-crash block (journal
        # high-water restored — no reuse, no reset)
        assert (rb["ranks"]["0"]["cid_base"]
                >= ra["ranks"]["0"]["cid_base"] + 4096), (ra, rb)
        # exactly once: one publish per job id across both daemon lives
        pubs = [json.loads(line)["d"].get("id")
                for line in open(journal) if '"publish"' in line]
        assert pubs.count(ja["id"]) == 1 and pubs.count(jb["id"]) == 1
        client.shutdown(d2.url)
        assert d2.proc.wait(timeout=60) == 0, d2.out()
        time.sleep(0.5)
        # zero orphans: every worker pid this control plane ever
        # spawned or adopted is gone
        assert not [p for p in pids + worker_pids()
                    if _state.pid_alive(p)], d2.out()
    finally:
        for p in worker_pids():
            if _state.pid_alive(p):
                os.kill(p, 9)
        d1.close()
        if d2 is not None:
            d2.close()


def test_tpud_np2_kill_rank_mid_job_respawns_and_next_job_schedules():
    """Elastic acceptance: SIGKILL rank 1 mid-job — the job fails, the
    daemon respawns the rank (incarnation 1), fires the repair
    directive (survivors replace(), the reborn rejoins), and the NEXT
    job schedules and completes on the restored mesh."""
    from ompi_tpu_torch.serve import client

    d = _Tpud(mca=[("dcn_recv_timeout", "8"), ("dcn_cts_timeout", "8"),
                   ("dcn_connect_timeout", "4")])
    try:
        jk = client.submit(d.url, str(JOB), tenant="alice",
                           env={"SERVE_KILL_RANK": "1"})
        rk = client.wait(d.url, jk["id"], timeout=120)
        assert rk["state"] == "failed", rk
        # wait for the daemon-fired repair to complete
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            st = client.status(d.url)
            if (st["healthy"]
                    and st["procs"]["1"]["incarnation"] == 1
                    and st["procs"]["1"]["status"] == "active"):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"mesh never healed: {st}\n{d.out()}")
        dead = set(d.pids)
        d.track()  # the reborn worker's pid
        j2 = client.submit(d.url, str(JOB), tenant="bob")
        r2 = client.wait(d.url, j2["id"], timeout=120)
        assert r2["state"] == "done", (r2, d.out())
        client.shutdown(d.url)
        assert d.proc.wait(timeout=60) == 0, d.out()
        # the daemon unlinked what the SIGKILLed worker (and the two
        # that finalized) left: no /dev/shm name of any incarnation
        from ompi_tpu_torch.boot.tpurun import _SHM_PREFIXES

        names = os.listdir("/dev/shm")
        left = [n for n in names for p in d.pids | dead
                for f in _SHM_PREFIXES if n.startswith(f.format(p))]
        assert not left, left
    finally:
        d.close()
    out = d.out()
    assert "respawning (incarnation 1)" in out, out
    assert "repair complete" in out, out
    assert "rejoined; resuming at directive" in out, out
    assert len([l for l in out.splitlines()
                if "OK SERVE_JOB" in l]) >= 2, out


def test_journal_compaction_bounds_restart_cycles(tmp_path):
    """Repeated SIGKILL→restart cycles must not
    grow the journal without bound.  Five takeover cycles over the
    same live state (one finished job collapsed to a noop stub, one
    in-flight directive, one queued job) — the journal converges to a
    fixed point (identical line count from the second cycle on) and
    every cycle replays the IDENTICAL state."""
    import subprocess as sp

    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.daemon import K_DONE, K_JOB, TpuDaemon

    pidfile = str(tmp_path / "tpud.pid")
    mca = {"serve_pidfile": pidfile, "serve_reattach_timeout": "5"}
    fake = [sp.Popen(["sleep", "300"]) for _ in range(2)]

    def crash(d):
        d.aggregator.close()
        d.server.close()
        d._journal.close()
        info = _state.read_pidfile(pidfile)
        info["pid"] = 999999999
        _state.write_pidfile(pidfile, info)

    def snapshot(replay):
        return {
            "queued": sorted(j["id"] for j in replay["queued"]),
            "running": sorted(j["id"] for j in replay["running"]),
            "done": sorted(j["id"] for j in replay["done"]),
            "outstanding": sorted(replay["outstanding"]),
            "published_idx": sorted(replay["published"]),
            "cursor": replay["cursor"],
            "cid_next": replay["cid_next"],
            "pids": {int(k): v for k, v in replay["pids"].items()},
            "retired": replay["retired"],
            "repairing": replay["repairing"],
            "draining": replay["draining"],
        }

    d = d2 = None
    try:
        d = TpuDaemon(2, mca=mca, spawn=False)
        jobs = []
        for name in ("a.py", "b.py", "c.py"):
            _, _, body = d._r_submit("/submit", json.dumps(
                {"script": name, "tenant": "t"}).encode())
            jobs.append(json.loads(body))
        for r, f in enumerate(fake):
            d._journal_ev("spawn", rank=r, pid=f.pid, incarnation=0)
        d.step()  # publishes job A over the full rank set
        for r in range(2):
            d.server.put_local(f"{K_DONE}0.{r}", {"ok": True, "proc": r})
        d.step()  # A finishes, B publishes (in-flight); C stays queued
        assert d.queue.get(jobs[0]["id"])["state"] == "done"
        assert d.server.peek(K_JOB + "1")["id"] == jobs[1]["id"]
        crash(d)
        sizes, states = [], []
        for cycle in range(5):
            d2 = TpuDaemon(2, mca=mca, spawn=False)
            # the takeover compacted before appending: job A's
            # directive is now a constant-size noop stub, the stream
            # index space stays contiguous, and the re-publication
            # still serves BOTH indices
            assert d2.server.peek(K_JOB + "1")["id"] == jobs[1]["id"]
            assert d2.cursor == 2 and list(d2._outstanding) == [1]
            crash(d2)
            with open(d2.journal_path) as f:
                sizes.append(sum(1 for _ in f))
            states.append(snapshot(_state.Journal.replay(
                d2.journal_path)))
        # bounded: the fixed point is reached immediately — every
        # cycle's journal has the SAME line count, not a growing one
        assert len(set(sizes)) == 1, sizes
        assert all(s == states[0] for s in states[1:]), states
        assert states[0]["queued"] == [jobs[2]["id"]]
        assert states[0]["outstanding"] == [1]
        assert states[0]["done"] == [jobs[0]["id"]]
        assert states[0]["cursor"] == 2
    finally:
        for f in fake:
            f.kill()
            f.wait()


def test_repair_pending_survives_crash_and_compaction(tmp_path):
    """Crash-mid-repair replay: the repair INTENT journaled at respawn
    time survives a SIGKILL (and compaction) so a restarted daemon
    re-enters the repairing state instead of stranding the reborn
    worker; the repair directive's finish clears it."""
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "j")
    j = Journal(path)
    j.append("spawn", rank=0, pid=111, incarnation=0)
    j.append("spawn", rank=1, pid=222, incarnation=1)
    j.append("repair_pending", rank=1, incarnation=1)
    st = Journal.replay(path)
    assert st["repairing"] == {1: 1}
    Journal.compact(path, st)
    st2 = Journal.replay(path)
    assert st2["repairing"] == {1: 1}
    assert st2["pids"][1]["incarnation"] == 1
    # the repair directive publishing and finishing clears the intent
    j2 = Journal(path)
    j2.append("publish", d={"idx": 0, "kind": "repair", "procs": [0],
                            "dead": [1]})
    j2.append("finish", idx=0, kind="repair")
    j2.close()
    st3 = Journal.replay(path)
    assert st3["repairing"] == {} and not st3["outstanding"]


def test_daemon_restart_seeds_repairing_from_journal(tmp_path):
    """The daemon half: a takeover whose journal holds a pending
    repair re-arms the repairing set (the respawn/repair machinery
    finishes the heal the predecessor started)."""
    import subprocess as sp

    from ompi_tpu_torch.serve import state as _state
    from ompi_tpu_torch.serve.daemon import TpuDaemon

    pidfile = str(tmp_path / "tpud.pid")
    mca = {"serve_pidfile": pidfile, "serve_reattach_timeout": "5"}
    fake = sp.Popen(["sleep", "300"])
    d = d2 = None
    try:
        d = TpuDaemon(2, mca=mca, spawn=False)
        d._journal_ev("spawn", rank=0, pid=fake.pid, incarnation=0)
        d._journal_ev("spawn", rank=1, pid=999999998, incarnation=1)
        d._journal_ev("repair_pending", rank=1, incarnation=1)
        d.aggregator.close()
        d.server.close()
        d._journal.close()
        info = _state.read_pidfile(pidfile)
        info["pid"] = 999999999
        _state.write_pidfile(pidfile, info)
        d2 = TpuDaemon(2, mca=mca, spawn=False)
        assert d2._repairing == {1}
        assert d2._incarnation[1] == 1
        assert not d2._repair_published
    finally:
        fake.kill()
        fake.wait()


def test_pipesafe_retarget_reaims_stdio():
    """Adopted-worker stdio re-attach: writes through a broken pipe
    degrade to no-ops; after retarget() they land in the new sink."""
    import io

    from ompi_tpu_torch.serve.worker import _PipeSafe

    class _Broken:
        def write(self, s):
            raise OSError("broken pipe")

        def flush(self):
            raise OSError("broken pipe")

    ps = _PipeSafe(_Broken())
    assert ps.write("lost\n") == len("lost\n")  # swallowed, not raised
    ps.flush()
    sink = io.StringIO()
    ps.retarget(sink)
    ps.write("found\n")
    ps.flush()
    assert sink.getvalue() == "found\n"


def test_agent_reaim_logs_after_daemon_crash(tmp_path):
    """Per-agent log re-aim: an agent whose
    daemon died re-aims its _PipeSafe stdio at the per-agent log file
    named by the restarted daemon's pidfile record — post-adoption
    output is durable instead of swallowed.  An empty/unusable logs
    field keeps swallowing without raising."""
    import sys

    from ompi_tpu_torch.serve.agent import LaunchAgent
    from ompi_tpu_torch.serve.worker import _PipeSafe

    class _Broken:
        def write(self, s):
            raise OSError("broken pipe")

        def flush(self):
            raise OSError("broken pipe")

    ag = LaunchAgent.__new__(LaunchAgent)
    ag.hid = 1
    old_out, old_err = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = _PipeSafe(_Broken()), _PipeSafe(_Broken())
    try:
        print("lost to the dead daemon's pipe")  # swallowed, no raise
        ag._reaim_logs({"logs": str(tmp_path / "logs")})
        print("post-adoption line")
        sys.stdout.flush()
    finally:
        sys.stdout, sys.stderr = old_out, old_err
    path = tmp_path / "logs" / "agent.h1.log"
    assert path.exists()
    content = path.read_text()
    assert "stdio re-aimed" in content
    assert "post-adoption line" in content
    assert "lost to the dead" not in content
    # no logs dir in the pidfile record: stays a silent no-op
    ag2 = LaunchAgent.__new__(LaunchAgent)
    ag2.hid = 2
    sys.stdout = _PipeSafe(_Broken())
    try:
        ag2._reaim_logs({})
        ag2._reaim_logs(None)
    finally:
        sys.stdout = old_out


# -- multi-host DVM (per-host launch agents over the rsh shim) ---------


def test_journal_spawn_host_placement_roundtrip(tmp_path):
    """Multi-host placement survives the journal: spawn events carry
    the owning agent's host index, replay keeps it (the restarted
    daemon's re-adopt-vs-respawn routing), and compaction re-emits
    it."""
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "j")
    j = Journal(path)
    j.append("spawn", rank=0, pid=111, incarnation=0)
    j.append("spawn", rank=2, pid=222, incarnation=1, host=1)
    j.close()
    replay = Journal.replay(path)
    assert "host" not in replay["pids"][0]
    assert replay["pids"][2] == {"pid": 222, "incarnation": 1,
                                 "host": 1}
    Journal.compact(path, replay)
    replay2 = Journal.replay(path)
    assert replay2["pids"][2]["host"] == 1
    assert "host" not in replay2["pids"][0]


def test_tpud_2x2_emulated_hosts_restart_adoption_and_hostkill(tmp_path):
    """The multi-host DVM acceptance, np=2x2 emulated hosts (hermetic
    ``/bin/sh -c {cmd}`` rsh shim + fake hostnames — every rank is
    REMOTE, owned by a per-host launch agent):

    1. agents spawn the workers over the rsh leg and a 4-rank job
       completes on the warm mesh;
    2. daemon SIGKILL mid-job → the restarted daemon re-adopts the
       AGENTS (serve.agent.adopt) and the workers (serve.adopt), the
       in-flight job finishes across the crash, incarnations stay 0,
       dials stay flat (nothing warm was lost);
    3. whole-host kill (host 1's workers AND agent, SIGKILL) → the
       daemon respawns the agent over rsh, the reborn agent reports
       the corpses and spawns incarnation 1, the repair restores the
       mesh, and a full-size job produces exact results while host
       0's workers stay at zero reconnects/retry_dials;
    4. clean shutdown: rc 0, no orphaned worker or agent processes.
    """
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as sstate

    pidfile = str(tmp_path / "tpud.pid")
    mca = (("serve_pidfile", pidfile),
           ("serve_reattach_timeout", "30"),
           ("serve_agent_timeout", "4"),
           ("dcn_recv_timeout", "8"),
           ("dcn_cts_timeout", "8"),
           ("dcn_connect_timeout", "4"))
    extra = ("--host", "fakehostA:2,fakehostB:2",
             "--kvs-host", "127.0.0.1",
             "--launch-agent", "/bin/sh -c {cmd}")

    def _journal_pids(host=None):
        # Journal.replay is the one decoder of the journal format —
        # it already folds spawns to the last {pid, incarnation, host}
        # per rank
        from ompi_tpu_torch.serve.state import Journal

        return {int(r): int(st["pid"])
                for r, st in Journal.replay(
                    pidfile + ".journal")["pids"].items()
                if int(st.get("pid", 0))
                and (host is None or st.get("host") == host)}

    d1 = _Tpud(mca=mca, np_=4, extra=extra)
    d2 = None
    all_pids: set[int] = set()
    try:
        # 1. agents own the spawns; a plain 4-rank job completes
        ja = client.submit(d1.url, str(JOB), tenant="a", nprocs=4)
        ra = client.wait(d1.url, ja["id"], timeout=150)
        assert ra["state"] == "done", ra
        assert "launch agent h0" in d1.out()
        assert "launch agent h1" in d1.out()
        all_pids |= set(_journal_pids().values())

        # 2. SIGKILL the daemon mid-job; restart re-adopts agents AND
        # workers and the in-flight job completes exactly once
        jb = client.submit(d1.url, str(JOB), tenant="a", nprocs=4,
                           env={"SERVE_SLEEP": "6"})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if client.status(d1.url, jb["id"]).get("state") == "running":
                break
            time.sleep(0.1)
        os.kill(d1.proc.pid, 9)
        d1.proc.wait(timeout=30)
        d2 = _Tpud(mca=mca, np_=4, extra=extra)
        rb = client.wait(d2.url, jb["id"], timeout=150)
        assert rb["state"] == "done", rb
        st = client.status(d2.url)
        assert [int(st["procs"][str(r)]["incarnation"])
                for r in range(4)] == [0, 0, 0, 0], st
        assert sum(1 for l in d2.lines
                   if "re-adopted agent" in l) == 2, d2.out()
        assert sum(1 for l in d2.lines
                   if "re-adopted rank" in l) == 4, d2.out()
        assert all(rec["dials_before"] == rec["dials_after"]
                   for rec in (rb.get("ranks") or {}).values()), rb
        # per-agent log re-aim: the dead
        # daemon's rsh pipes are gone — every re-attached agent must
        # have re-aimed its stdio at its per-agent log file in the
        # restarted daemon's logs dir, so adoption output is durable
        deadline = time.monotonic() + 20
        logdir = pidfile + ".logs"
        while time.monotonic() < deadline:
            logs = [f for f in (os.listdir(logdir)
                                if os.path.isdir(logdir) else [])
                    if f.startswith("agent.h")]
            if len(logs) >= 2:
                break
            time.sleep(0.2)
        assert sorted(logs) == ["agent.h0.log", "agent.h1.log"], logs
        for f in logs:
            assert "stdio re-aimed" in open(
                os.path.join(logdir, f)).read()

        # 3. whole-host kill: a 2-rank gang job runs ON host 0 (ranks
        # 0-1); SIGKILL host 0's agent + workers mid-collective — host
        # 1 is a TRUE bystander (not in the gang, not killed)
        jc = client.submit(d2.url, str(JOB), tenant="a", nprocs=2,
                           env={"SERVE_ITERS": "4000"})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if client.status(d2.url, jc["id"]).get("state") == "running":
                break
            time.sleep(0.1)
        time.sleep(1.0)  # land the kill mid-collective
        js = json.loads(_scrape(d2.url, "/json"))
        agent_pid = int(js["daemon"]["agents"]["0"]["pid"])
        victims = _journal_pids(host=0)
        # the hb-derived agent pid reads 0 before the first heartbeat
        # folds — os.kill(0, 9) would SIGKILL this test's process group
        assert agent_pid > 0 and len(victims) == 2, (agent_pid, victims)
        all_pids |= set(_journal_pids().values()) | {agent_pid}
        for p in list(victims.values()) + [agent_pid]:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        client.wait(d2.url, jc["id"], timeout=90)  # gang job fails
        deadline = time.monotonic() + 150
        healed = False
        while time.monotonic() < deadline:
            st = client.status(d2.url)
            procs = st.get("procs") or {}
            healed = bool(st.get("healthy")) and all(
                procs.get(str(r), {}).get("status") == "active"
                for r in range(4))
            if healed:
                break
            time.sleep(0.3)
        assert healed, (st, d2.out()[-3000:])
        assert [int(st["procs"][str(r)]["incarnation"])
                for r in range(4)] == [1, 1, 0, 0], st
        assert any("respawning it" in l for l in d2.lines), d2.out()
        jd = client.submit(d2.url, str(JOB), tenant="a", nprocs=4)
        rd = client.wait(d2.url, jd["id"], timeout=150)
        assert rd["state"] == "done", (rd, d2.out()[-3000:])
        # bystander host 1: zero reconnects/retry_dials, ever — the
        # host kill (and the repair) never perturbed its workers
        for rec in (rd.get("ranks") or {}).values():
            if int(rec.get("proc", -1)) >= 2:
                c = rec.get("counters") or {}
                assert int(c.get("reconnects", 0)) == 0, rec
                assert int(c.get("retry_dials", 0)) == 0, rec
        all_pids |= set(_journal_pids().values())

        # 4. clean shutdown: rc 0, zero orphans
        client.shutdown(d2.url)
        rc = d2.proc.wait(timeout=90)
        assert rc == 0, d2.out()[-2000:]
        time.sleep(0.5)
        orphans = [p for p in all_pids if sstate.pid_alive(p)]
        assert not orphans, orphans
    finally:
        for d in (d1, d2):
            if d is not None:
                d.close()
        all_pids |= set(_journal_pids().values())
        _reap_workers(all_pids)


# -- journal rotation + hb-only agent liveness ---------------------------


def test_journal_rotation_size_bound(tmp_path):
    """A long-lived daemon that never crashes never takes over, so
    takeover-time compaction alone still grows the file without
    bound — the size bound rotates in place: the journal folds to a
    compacted snapshot (a ``compact`` marker + live state) and replay
    after rotation reconstructs exactly what an unrotated journal
    would."""
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "tpud.journal")
    j = Journal(path, max_bytes=4096)
    j.append("submit", job={"id": "j1", "tenant": "a",
                            "state": "queued", "submit_ns": 1})
    j.append("publish", d={"idx": 0, "kind": "job", "id": "j1",
                           "procs": [0], "cid_base": 1 << 20,
                           "cid_span": 4096})
    j.append("submit", job={"id": "j2", "tenant": "a",
                            "state": "queued", "submit_ns": 2})
    # churn well past the byte bound: respawn cycles dominate real
    # long-lived journals, and only the LAST spawn per rank is live
    for inc in range(200):
        j.append("spawn", rank=0, pid=1000 + inc, incarnation=inc)
    assert j.rotations >= 1
    assert os.path.getsize(path) < 8192, "rotation did not bound size"
    with open(path) as f:
        first = json.loads(f.readline())
    assert first["ev"] == "compact"  # snapshot head, then the tail
    st = Journal.replay(path)
    # the compact fixed point: queued jobs keep their records, the
    # in-flight directive survives outstanding (its record rides the
    # directive itself, as on takeover), cursor/CID floors hold, and
    # only the LAST spawn per rank remains
    assert [q["id"] for q in st["queued"]] == ["j2"]
    assert list(st["outstanding"]) == [0]
    assert st["outstanding"][0]["id"] == "j1"
    assert st["cursor"] == 1
    assert st["cid_next"] == (1 << 20) + 4096
    assert st["pids"][0] == {"pid": 1199, "incarnation": 199}
    # the tail keeps appending normally after rotation
    j.append("finish", idx=0, kind="job",
             job={"id": "j1", "state": "done"})
    j.close()
    st = Journal.replay(path)
    assert not st["outstanding"]
    assert {d["id"] for d in st["done"]} == {"j1"}


def test_journal_rotation_age_bound(tmp_path):
    from ompi_tpu_torch.serve.state import Journal

    path = str(tmp_path / "tpud.journal")
    j = Journal(path, max_age_s=0.05)
    j.append("submit", job={"id": "j1", "tenant": "a",
                            "state": "queued", "submit_ns": 1})
    assert j.rotations == 0
    time.sleep(0.06)
    j.append("submit", job={"id": "j2", "tenant": "a",
                            "state": "queued", "submit_ns": 2})
    assert j.rotations == 1
    j.close()
    st = Journal.replay(path)
    assert [q["id"] for q in st["queued"]] == ["j1", "j2"]


def test_journal_rotation_knobs_reach_daemon(tmp_path):
    """``serve_journal_max_kb`` / ``serve_journal_max_age_s`` wire the
    bounds into the daemon's Journal through the central SERVING_VARS
    registration (0 = unbounded, the default)."""
    from ompi_tpu_torch.serve.daemon import TpuDaemon

    mca = {"serve_pidfile": str(tmp_path / "tpud.pid"),
           "serve_journal_max_kb": "64",
           "serve_journal_max_age_s": "30"}
    d = TpuDaemon(1, mca=mca, spawn=False)
    try:
        assert d._journal.max_bytes == 64 * 1024
        assert d._journal.max_age_s == 30.0
    finally:
        d.close()


class _FakeAgentProc:
    def __init__(self, rc):
        self._rc = rc

    def poll(self):
        return self._rc


class _HbOnlyStub:
    """The _poll_agents_locked surface: one active agent whose rsh
    launch process has exited."""

    def __init__(self, hb_age: float, now: float):
        self.shutting_down = False
        self.max_respawns = 3
        self.booted = []
        self._agents = {0: {
            "status": "active", "session": "s0", "cursor": 0,
            "proc": _FakeAgentProc(0),       # launch process exited
            "hb": None, "hb_mono": now - hb_age,
            "spawns": 1, "pending": {}, "worker_pids": {},
        }}
        self.server = types.SimpleNamespace(peek=lambda key: None)

    def _boot_agent(self, hid, adopt=None):
        self.booted.append(hid)

    def _agent_cmd(self, hid, cmd):
        pass


def test_agent_hb_only_liveness(capsys):
    """``serve_agent_hb_only``: a backgrounding agent template's rsh
    wrapper daemonizes and exits immediately, so its launch process
    dying is normal — liveness is judged by heartbeat staleness
    alone.  Default mode still treats the rsh exit as agent death."""
    from ompi_tpu_torch.serve.daemon import TpuDaemon

    now = time.monotonic()
    # default: rsh exit → respawn even with fresh heartbeats
    stub = _HbOnlyStub(hb_age=0.0, now=now)
    TpuDaemon._poll_agents_locked(stub, now, timeout=10.0,
                                  hb_only=False)
    assert stub.booted == [0]
    assert "exited" in capsys.readouterr().out
    # hb-only: same rsh exit, fresh heartbeat → agent stays adopted
    stub = _HbOnlyStub(hb_age=0.0, now=now)
    TpuDaemon._poll_agents_locked(stub, now, timeout=10.0,
                                  hb_only=True)
    assert stub.booted == []
    # hb-only: silence past the timeout is still death
    stub = _HbOnlyStub(hb_age=99.0, now=now)
    TpuDaemon._poll_agents_locked(stub, now, timeout=10.0,
                                  hb_only=True)
    assert stub.booted == [0]
    assert "silent" in capsys.readouterr().out


def test_agent_hb_only_var_registered():
    from ompi_tpu_torch.core.var import SERVING_VARS, full_var_name

    names = {full_var_name(fw, c, n)
             for fw, c, n, _d, _t, _h in SERVING_VARS}
    assert {"serve_agent_hb_only", "serve_journal_max_kb",
            "serve_journal_max_age_s"} <= names


# -- parity: the same inputs through both packages ----------------------

#: timestamps a job record takes from the wall clock (masked in parity
#: comparisons; everything else compares exactly)
_TS_KEYS = ("submit_ns", "start_ns", "end_ns")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<ts>" if k in _TS_KEYS else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _queue_script(seed: int, n_ops: int = 300) -> list[tuple]:
    """A numpy-seeded operation sequence over a 4-proc queue: submits
    from three tenants (some with a width), dispatch on random free
    sets, finishes, repair-kill retries, admission ticks and drain."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = []
    stall = {0: 0, 1: 0, 2: 0, 3: 0}
    for _ in range(n_ops):
        k = int(rng.integers(0, 10))
        if k < 4:
            ops.append(("submit", f"s{int(rng.integers(0, 99))}.py",
                        ["alice", "bob", "carol"][int(rng.integers(0, 3))],
                        [None, 1, 2, 4][int(rng.integers(0, 4))]))
        elif k < 6:
            free = sorted(int(p) for p in np.flatnonzero(rng.random(4) < 0.7))
            ops.append(("next", free))
        elif k == 6:
            ops.append(("finish", int(rng.integers(0, 3)),
                        bool(rng.random() < 0.8)))
        elif k == 7:
            ops.append(("retry", int(rng.integers(0, 3))))
        elif k == 8:
            for p in stall:
                stall[p] += int(rng.integers(0, 3)) * 700
            ops.append(("tick", dict(stall), bool(rng.random() < 0.9),
                        ["", "ring-stall", "arrival-skew"][int(rng.integers(0, 3))]))
        elif rng.random() < 0.05:
            ops.append(("drain",))
    return ops


def _run_queue(pkg: str, ops) -> list:
    """Apply ``ops`` to one package's JobQueue + AdmissionController;
    returns the masked trace (every op's outcome and the state after)."""
    if pkg == "port":
        from ompi_tpu_torch.serve.queue import (AdmissionController,
                                                AdmissionError, JobQueue)
    else:
        from ompi_tpu.serve.queue import (AdmissionController, AdmissionError,
                                          JobQueue)
    ctrl = AdmissionController(stall_ns=1000, policy="shed")
    q = JobQueue(4, max_pending=3, max_concurrent=2, retry_budget=1,
                 admission=ctrl)
    trace = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "submit":
                out = q.submit(op[1], tenant=op[2], nprocs=op[3])
            elif kind == "next":
                out = q.next_runnable(set(op[1]))
            elif kind == "finish":
                run = q.running()
                out = (q.finish(run[op[1] % len(run)]["id"], ok=op[2],
                                error="" if op[2] else "boom")
                       if run else None)
            elif kind == "retry":
                run = q.running()
                out = q.retry(run[op[1] % len(run)]["id"]) if run else None
            elif kind == "tick":
                ctrl.update({int(p): v for p, v in op[1].items()},
                            healthy=op[2], cause=op[3])
                out = ctrl.state()
            else:
                q.draining = True
                out = None
        except AdmissionError as e:
            out = ("rejected", e.status, e.retry_after, str(e))
        trace.append((kind, _mask(out), _mask(q.state())))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_and_admission_state_parity_with_reference(seed):
    """One seeded submit/dispatch/finish/retry/admission sequence through
    both packages' JobQueue + AdmissionController: every outcome and
    every ``state()`` equal (exact; job timestamps masked)."""
    ops = _queue_script(seed)
    port, ref = _run_queue("port", ops), _run_queue("ref", ops)
    assert len(port) == len(ref) == len(ops)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, ops[i], a, b)
    # the sequence really exercised the interesting paths
    kinds = {t[1][0] for t in port if isinstance(t[1], tuple)}
    assert "rejected" in kinds
    assert any(t[2]["counters"]["jobs_retried"] for t in port)


def _journal_events(seed: int) -> list[tuple[str, dict]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    evs: list[tuple[str, dict]] = []
    idx = 0
    open_ = []
    for j in range(12):
        jid = f"j{j}"
        evs.append(("submit", {"job": {"id": jid, "tenant": "t" + str(j % 3),
                                       "state": "queued", "submit_ns": j}}))
        if rng.random() < 0.7:
            evs.append(("publish", {"d": {"idx": idx, "kind": "job", "id": jid,
                                          "procs": [0, 1],
                                          "cid_base": (1 << 20) + 4096 * idx,
                                          "cid_span": 4096}}))
            open_.append((idx, jid))
            idx += 1
        if open_ and rng.random() < 0.5:
            i, done = open_.pop(0)
            if rng.random() < 0.3:
                evs.append(("retry", {"idx": i, "job": {
                    "id": done, "tenant": "t", "state": "queued",
                    "submit_ns": 0, "retries": 1}}))
            else:
                evs.append(("finish", {"idx": i, "kind": "job",
                                       "job": {"id": done, "state": "done"}}))
        r = int(rng.integers(0, 2))
        evs.append(("spawn", {"rank": r, "pid": 1000 + j, "incarnation": j,
                              **({"host": 1} if r else {})}))
        if rng.random() < 0.2:
            evs.append(("repair_pending", {"rank": r, "incarnation": j}))
    evs.append(("retire", {"ranks": [1]}))
    evs.append(("drain", {}))
    return evs


def _journal_mod(pkg: str):
    if pkg == "port":
        from ompi_tpu_torch.serve import state
    else:
        from ompi_tpu.serve import state
    return state


@pytest.mark.parametrize("writer,reader",
                         [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_journal_replay_parity_and_cross_package(tmp_path, writer, reader):
    """The same journal events, written by one package's ``Journal`` and
    replayed by the other's (and both replays of one file compared):
    equal replay states, before and after takeover compaction.  The
    compaction keeps a running job as its ``publish`` alone; the port's
    replay rebuilds it from the directive, the reference's no longer
    counts it, and the rest of the two states stay equal."""
    evs = _journal_events(7)
    path = str(tmp_path / f"{writer}.journal")
    j = _journal_mod(writer).Journal(path)
    for ev, fields in evs:
        j.append(ev, **fields)
    j.close()
    got = _journal_mod(reader).Journal.replay(path)
    want = _journal_mod(writer).Journal.replay(path)
    assert got == want
    assert got["events"] == len(evs) and not got["clean"]
    _journal_mod(reader).Journal.compact(path, got)
    after = {pkg: _journal_mod(pkg).Journal.replay(path) for pkg in ("port", "ref")}
    running = [j["id"] for j in got["running"]]
    assert running and [j["id"] for j in after["port"]["running"]] == running
    assert after["ref"]["running"] == []
    assert ({k: v for k, v in after["port"].items() if k != "running"}
            == {k: v for k, v in after["ref"].items() if k != "running"})


def test_serving_vars_and_registry_rows_equal_reference():
    """Both packages' SERVING_VARS tables (name, default, type; the help
    text is exempt — it names each package's own commands), and the
    ``serve_*`` rows every fresh registry store carries."""
    from ompi_tpu.core import var as ref_var
    from ompi_tpu.core.registry import MCAContext as RefContext
    from ompi_tpu_torch.core import var as port_var
    from ompi_tpu_torch.core.registry import MCAContext as PortContext

    assert ([row[:5] for row in port_var.SERVING_VARS]
            == [row[:5] for row in ref_var.SERVING_VARS])

    def rows(ctx):
        return sorted((v.full_name, repr(v.default), str(v.type))
                      for v in ctx().store.all_vars()
                      if v.full_name.startswith(("serve_", "telemetry_")))

    assert rows(PortContext) == rows(RefContext)
    assert len(rows(PortContext)) == len(port_var.SERVING_VARS) + 5


# -- the port's tpud end to end beside the reference's ----------------

#: the job body both packages' daemons run: numpy-seeded rows, numpy in
#: and numpy out (the han contract), results saved per process
_PARITY_BODY = r'''
import os
import sys

import numpy as np

w = api.init()
out_dir = os.environ["PARITY_OUT"]
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
rng = np.random.default_rng(20261017)
X = rng.standard_normal((n, 5)).astype(np.float32)
BIG = rng.standard_normal((n, 20000)).astype(np.float32)
res = {}
for name, x, op in (("sum", X, SUM), ("prod", X, PROD), ("max", X, MAX),
                    ("big", BIG, SUM)):
    res[name] = np.asarray(w.allreduce(x[lo:lo + ln], op))
if FORCE_RING:
    # the card's path: cuda_ring forced on han's local leg
    store = mca.default_context().store
    store.set("coll_cuda_allreduce_algorithm", 7)
    res["ring_big"] = np.asarray(w.allreduce(BIG[lo:lo + ln], SUM))
    store.set("coll_cuda_allreduce_algorithm", 0)
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
print(f"OK PARITY_JOB proc={p}", flush=True)
api.finalize()
'''

_PARITY_PRELUDE = {
    "port": ("import ompi_tpu_torch.api as api\n"
             "from ompi_tpu_torch.core import mca\n"
             "from ompi_tpu_torch.op import MAX, PROD, SUM\n"
             "FORCE_RING = True\n"),
    "ref": ("import ompi_tpu.api as api\n"
            "from ompi_tpu.op import MAX, PROD, SUM\n"
            "FORCE_RING = False\n"),
}


def _plain_ring_rows(rows, nranks: int):
    """The port's single-process plain ring (enum 2) over one process's
    rank rows."""
    import numpy as np

    import ompi_tpu_torch.api as papi
    from ompi_tpu_torch.core import mca as pmca
    from ompi_tpu_torch.op import SUM

    w = papi.init({"coll_cuda_allreduce_algorithm": "2"}, device="cpu",
                  nranks=nranks)
    try:
        assert pmca.default_context().store.get(
            "coll_cuda_allreduce_algorithm") == 2
        return np.asarray(w.allreduce(rows, SUM))
    finally:
        papi.finalize()


def test_tpud_np2_allreduce_bitequal_to_reference_tpud_and_plain_ring(tmp_path):
    """One seeded job through a port tpud and a reference tpud (2 × 2
    ranks each, reproducible vars on both) gives the same bits; the
    port's job with ``cuda_ring`` forced on han's local leg equals each
    process's single-process plain ring folded across the two
    processes."""
    import numpy as np

    from ompi_tpu_torch.serve import client

    jobs, outs = {}, {}
    for pkg in ("port", "ref"):
        script = tmp_path / f"parity_{pkg}.py"
        script.write_text(_PARITY_PRELUDE[pkg] + _PARITY_BODY)
        outs[pkg] = tmp_path / f"out_{pkg}"
        outs[pkg].mkdir()
        jobs[pkg] = script
    port_mca = [("coll_cuda_reproducible", "1"), ("coll_han_reproducible", "1"),
                ("dcn_device_min_size", "4096")]
    ref_mca = [("coll_xla_reproducible", "1"), ("coll_han_reproducible", "1")]
    dp = _Tpud(mca=port_mca, nranks=2, btl=None, entry="tpud")
    dr = None
    try:
        dr = _Tpud(mca=ref_mca, nranks=2, btl=None, pkg="ref")
        recs = {}
        for pkg, d in (("port", dp), ("ref", dr)):
            j = client.submit(d.url, str(jobs[pkg]), tenant=pkg,
                              env={"PARITY_OUT": str(outs[pkg])})
            recs[pkg] = client.wait(d.url, j["id"], timeout=150)
        for pkg, d in (("port", dp), ("ref", dr)):
            assert recs[pkg]["state"] == "done", (recs[pkg], d.out()[-3000:])
            client.shutdown(d.url)
            assert d.proc.wait(timeout=60) == 0, d.out()[-3000:]
    finally:
        dp.close()
        if dr is not None:
            dr.close()
    got = {pkg: [dict(np.load(outs[pkg] / f"{p}.npz")) for p in range(2)]
           for pkg in outs}
    for p in range(2):
        for name, ref_arr in got["ref"][p].items():
            port_arr = got["port"][p][name]
            assert port_arr.dtype == ref_arr.dtype and port_arr.shape == ref_arr.shape
            assert port_arr.tobytes() == ref_arr.tobytes(), (p, name)
    # the forced cuda_ring leg against the single-process plain ring
    rng = np.random.default_rng(20261017)
    rng.standard_normal((4, 5))
    big = rng.standard_normal((4, 20000)).astype(np.float32)
    partials = [_plain_ring_rows(big[2 * p:2 * p + 2], 2)[0] for p in range(2)]
    want = partials[0] + partials[1]
    for p in range(2):
        ring = got["port"][p]["ring_big"]
        assert ring.shape == (2, 20000)
        for row in ring:
            assert row.tobytes() == want.tobytes(), p


_NO_CUDA_WRAPPER = r'''
import sys

import torch

calls = []


def _refuse(*a, **k):
    calls.append(1)
    raise RuntimeError("the daemon initialized torch.cuda")


torch.cuda._lazy_init = _refuse
from ompi_tpu_torch.__main__ import main

sys.argv = ["ompi_tpu_torch"] + sys.argv[1:]
rc = main()
print(f"DAEMON_CUDA initialized={torch.cuda.is_initialized()} calls={len(calls)}",
      flush=True)
sys.exit(rc)
'''


def test_tpud_cpu_daemon_never_initializes_cuda(tmp_path):
    """A CPU daemon (``tpud --cpu``) boots its workers, schedules a job,
    scrapes and shuts down without ever initializing ``torch.cuda`` in
    the daemon process: its lazy init is replaced by one that raises,
    and ``torch.cuda.is_initialized()`` is still false at exit."""
    from ompi_tpu_torch.serve import client

    wrapper = tmp_path / "no_cuda_daemon.py"
    wrapper.write_text(_NO_CUDA_WRAPPER)
    d = _Tpud(entry="tpud", wrapper=wrapper)
    try:
        j = client.submit(d.url, str(JOB), tenant="a",
                          env={"SERVE_ITERS": "2"})
        assert client.wait(d.url, j["id"], timeout=120)["state"] == "done"
        assert "ompi_tpu_dcn_" in _scrape(d.url, "/metrics")
        client.shutdown(d.url)
        assert d.proc.wait(timeout=60) == 0, d.out()
    finally:
        d.close()
    assert "DAEMON_CUDA initialized=False calls=0" in d.out(), d.out()


def test_resident_worker_boots_on_cuda_or_raises(monkeypatch):
    """The resident worker's ranks run on CUDA unless the daemon handed
    it the CPU switch: without a card and without the switch its boot
    raises — it never falls back to the CPU quietly.  ``--cpu`` is the
    one way a worker gets the switch: one already in the caller's
    environment is not passed on."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.boot.proc import ENV_DEVICE, ENV_PROC
    from ompi_tpu_torch.boot.tpurun import worker_env
    from ompi_tpu_torch.core.errors import MPIInternalError
    from ompi_tpu_torch.serve import worker

    monkeypatch.setenv(ENV_DEVICE, "cpu")
    assert ENV_DEVICE not in worker_env(0, 1, "x:1")
    assert ENV_DEVICE not in worker_env(1, 2, "x:1", mca={"btl": "native"}, nranks=4)
    assert worker_env(0, 1, "x:1", cpu=True)[ENV_DEVICE] == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    monkeypatch.delenv(ENV_DEVICE, raising=False)
    monkeypatch.delenv(ENV_PROC, raising=False)
    out, err = sys.stdout, sys.stderr
    try:
        with pytest.raises(MPIInternalError, match="no CUDA device"):
            worker.main()
    finally:
        sys.stdout, sys.stderr = out, err
    assert not api.initialized()
