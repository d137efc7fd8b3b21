"""The port's tpud hang diagnosis against the reference's.

Mirrors the tpud cases of ``tests/test_waitgraph.py`` on
``ompi_tpu_torch``:

* surfaces — the aggregator's ``GET /waitgraph`` and the per-rank state
  brief in ``/json``, a failed peer's verdict;
* parity — the daemon's pre-revoke hang report, captured by both
  packages' workerless daemons from the same blocked-state frames:
  equal graph and verdict (exact; the report's own timestamps masked);
* np=2 acceptance — a faultsim ``stall:ms=...;proc=1`` plan wedges rank
  1's shm-ring send under a port tpud job deadline (``--cpu`` workers):
  the live ``/waitgraph``, the revoked job's ``/job/<id>`` hang report,
  and the crash export the revoke path flushes (read by the port's
  solver and by the reference's ``tools/trace_report.py --hangs``) all
  name the same (rank 1, p2p_recv, peer 1) root.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from ompi_tpu_torch.metrics import core as mcore
from ompi_tpu_torch.metrics import live
from ompi_tpu_torch.trace import waitgraph as wg

REPO = Path(__file__).resolve().parent.parent
HANG_JOB = REPO / "ompi_tpu_torch" / "examples" / "serve_hang_job.py"
TRACE_REPORT = REPO / "tools" / "trace_report.py"

#: the port's tpud deadline for the stall job.  The reference's test
#: uses 4 s; the port keeps the same value — the deadline runs from the
#: job's publication on warm workers, so the port's slower boot
#: (``import torch``) is not inside it
DEADLINE_S = "4"


@pytest.fixture(autouse=True)
def clean_state():
    wg.reset()
    mcore.reset(full=True)
    yield
    wg.reset()
    mcore.reset(full=True)


def _snap(ts, *waits):
    return {"ts_ns": ts, "waits": list(waits)}


def _w(site, peer, plane="host", since=0, **kw):
    return dict(site=site, peer=peer, plane=plane, since_ns=since, **kw)


def _get(url: str, path: str) -> str:
    with urllib.request.urlopen(url + path, timeout=5) as r:
        return r.read().decode()


# -- surfaces -----------------------------------------------------------


def test_aggregator_waitgraph_endpoint_and_state_brief():
    agg = live.TelemetryAggregator(http_port=0, history=8)
    try:
        t = time.time_ns()
        agg.ingest({"proc": 0, "nprocs": 2, "ts_ns": t,
                    "native": {"delivered": 5}, "straggler": {},
                    "colls": [],
                    "waits": _snap(t, _w("coll_recv", 1, since=t - int(3e9),
                                         cid="4", seq=9))})
        agg.ingest({"proc": 1, "nprocs": 2, "ts_ns": t,
                    "native": {"delivered": 7}, "straggler": {},
                    "colls": []})
        st = json.loads(_get(agg.url, "/waitgraph"))
        assert st["nprocs"] == 2 and st["reporting"] == [0]
        (e,) = st["graph"]["edges"]
        assert (e["src"], e["dst"], e["site"]) == (0, 1, "coll_recv")
        assert e["cid"] == "4" and e["seq"] == 9
        assert e["age_ns"] >= int(2.9e9)
        v = st["verdict"]
        assert v["kind"] == "straggler" and v["root"]["rank"] == 1
        # the /json brief: BLOCKED names the binding site→peer; the
        # fresh active rank shows RUNNING
        assert st["states"]["0"] == "BLOCKED:coll_recv→1"
        assert st["states"]["1"] == "RUNNING"
        js = json.loads(_get(agg.url, "/json"))
        assert js["waitgraph"] == st["states"]
        # a later frame with unchanged counters and no waits → IDLE
        agg.ingest({"proc": 1, "nprocs": 2, "ts_ns": t + int(1e9),
                    "native": {"delivered": 7}, "straggler": {},
                    "colls": []})
        js = json.loads(_get(agg.url, "/json"))
        assert js["waitgraph"]["1"] == "IDLE"
    finally:
        agg.close()


def test_aggregator_failed_set_feeds_failed_peer_verdict():
    agg = live.TelemetryAggregator(http_port=0, history=8)
    try:
        t = time.time_ns()
        agg.ingest({"proc": 0, "nprocs": 2, "ts_ns": t,
                    "native": {}, "straggler": {}, "colls": [],
                    "failed": [1],
                    "waits": _snap(t, _w("p2p_recv", 1, "native",
                                         since=t - int(1e9)))})
        st = json.loads(_get(agg.url, "/waitgraph"))
        assert st["verdict"]["kind"] == "failed-peer"
        assert st["verdict"]["rank"] == 1
    finally:
        agg.close()


def _hang_report(pkg: str, frames: list[dict]) -> dict:
    if pkg == "port":
        from ompi_tpu_torch.serve.daemon import TpuDaemon
    else:
        from ompi_tpu.serve.daemon import TpuDaemon
    d = TpuDaemon(3, spawn=False)
    try:
        for f in frames:
            d.aggregator.ingest(json.loads(json.dumps(f)))
        return d._capture_hang_report("j9", [0, 1, 2])
    finally:
        d.aggregator.close()
        d.server.close()


def test_daemon_hang_report_equal_reference():
    """The deadline path's pre-revoke report, from the same blocked-state
    frames (a three-rank straggler chain ending in a ring stall and a
    failed-peer mark), in both packages' daemons."""
    t = 1_800_000_000_000_000_000
    frames = [
        {"proc": 0, "nprocs": 3, "ts_ns": t, "native": {}, "colls": [],
         "waits": _snap(t, _w("coll_recv", 1, since=t - int(4e9), cid="7",
                              seq=3))},
        {"proc": 1, "nprocs": 3, "ts_ns": t, "native": {}, "colls": [],
         "waits": _snap(t, _w("cts", 2, "tcp", since=t - int(3e9)))},
        {"proc": 2, "nprocs": 3, "ts_ns": t, "native": {}, "colls": [],
         "failed": [],
         "waits": _snap(t, _w("ring", None, "shm", since=t - int(2e9)))},
    ]
    port, ref = _hang_report("port", frames), _hang_report("ref", frames)
    assert port is not None and ref is not None
    assert port["reason"] == ref["reason"] == "deadline:j9"
    assert port["graph"] == ref["graph"]
    assert port["verdict"] == ref["verdict"]
    assert port["verdict"]["kind"] == "straggler"
    assert port["verdict"]["root"]["rank"] == 2


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_guarded_recv_registers_its_blocked_wait(pkg):
    """A cross-process receive that waits a full slice registers a
    ``p2p_recv`` wait naming its peer, and drops it on delivery.  The
    port's Python pml lacked the registration (its tpud stall job showed
    no blocked rank on ``/waitgraph``); both packages now agree."""
    if pkg == "port":
        from ompi_tpu_torch.p2p.pml import RecvRequest, Status
        wgm = wg
    else:
        from ompi_tpu.p2p.pml import RecvRequest, Status
        from ompi_tpu.trace import waitgraph as wgm
    wgm.reset()
    wgm.enable(True)
    try:
        req = RecvRequest()
        req.arm_remote_guard(30.0, lambda: None, lambda t: None)
        req.wait_peer = 1
        th = threading.Thread(target=req.wait, daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        while not wgm.busy() and time.monotonic() < deadline:
            time.sleep(0.02)
        (w,) = wgm.snapshot(stacks=False)["waits"]
        assert (w["site"], w["peer"], w["plane"]) == ("p2p_recv", 1, "host")
        req._deliver(7, Status(source=1, tag=0, count=1))
        th.join(timeout=10)
        assert not th.is_alive() and not wgm.busy()
    finally:
        wgm.reset()


# -- np=2 acceptance ----------------------------------------------------


def _spawn_reader(proc):
    lines: list[str] = []

    def _r():
        for raw in iter(proc.stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))

    t = threading.Thread(target=_r, daemon=True)
    t.start()
    return lines, t


def _await_line(lines, proc, marker, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        for l in list(lines):
            if marker in l:
                return l
        time.sleep(0.05)
    raise AssertionError(f"never saw {marker!r}:\n" + "".join(lines))


def test_tpud_np2_stall_hang_three_surfaces_name_same_root(tmp_path):
    """A faultsim ``stall:ms;proc=1`` plan wedges rank 1's shm-ring send
    past ``serve_job_deadline_s``.  The live ``/waitgraph`` (mid-hang),
    the revoked job's ``/job/<id>`` hang report, and the crash export
    flushed by the revoke path must all name the SAME
    (rank 1, p2p_recv, peer 1) root."""
    from ompi_tpu_torch.boot.tpurun import _unlink_leftovers
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _state

    mout = str(tmp_path / "hangexp")
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "tpud", "-np", "2",
           "--nranks", "1", "--cpu",
           "--mca", "btl", "sm",
           "--mca", "btl_sm_shm_threshold", "4096",
           "--mca", "telemetry_interval_ms", "150",
           "--mca", "serve_job_deadline_s", DEADLINE_S,
           "--mca", "dcn_recv_timeout", "120",
           "--mca", "faultsim_enable", "1",
           "--mca", "faultsim_seed", "7",
           "--mca", "faultsim_plan", "stall:ms=9000;proc=1",
           "--mca", "metrics_enable", "1",
           "--mca", "metrics_output", mout]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env,
                            cwd=str(REPO))
    lines, t = _spawn_reader(proc)
    pids: set[int] = set()
    try:
        l = _await_line(lines, proc, "[tpud] ops: ")
        url = l.split("[tpud] ops: ", 1)[1].split("/jobs")[0]
        pids |= {int(p["pid"]) for p in client.status(url)["procs"].values()}
        j = client.submit(url, str(HANG_JOB), tenant="doc", nprocs=2)
        # surface 1 — LIVE, mid-hang: /waitgraph names the root while
        # the gang is still parked (the deadline clears it)
        live_root = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                st = json.loads(_get(url, "/waitgraph"))
            except OSError:
                time.sleep(0.1)
                continue
            v = st["verdict"]
            if v["kind"] == "straggler":
                live_root = v["root"]
                assert st["states"].get("0", "").startswith(
                    "BLOCKED:p2p_recv"), st["states"]
                break
            time.sleep(0.1)
        assert live_root is not None, "".join(lines)
        # surface 2 — POST-MORTEM FILE: the revoke path flushed rank
        # 0's crash export with the blocked state still registered
        exp = mout + ".0.jsonl"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.path.exists(exp) and "p2p_recv" in open(exp).read():
                break
            time.sleep(0.2)
        snaps = {}
        for line in open(exp):
            rec = json.loads(line)
            if rec.get("proc") is not None and rec.get("waits"):
                snaps[int(rec["proc"])] = {"ts_ns": rec.get("ts_ns", 0),
                                           "waits": rec["waits"]}
        file_root = wg.classify(wg.build_graph(snaps))["root"]
        # the reference's offline reader parses the port's export too
        res = subprocess.run(
            [sys.executable, str(TRACE_REPORT), "--hangs", exp],
            capture_output=True, timeout=60, cwd=str(REPO), env=env)
        out = res.stdout.decode()
        assert res.returncode == 0, res.stderr.decode()
        assert "verdict: straggler — rank 1 holds the mesh" in out, out
        assert "p2p_recv→1" in out, out
        # surface 3 — the job record: DeadlineExpired with the hang
        # report the daemon captured BEFORE publishing the revoke
        rec = client.wait(url, j["id"], timeout=90)
        assert rec["state"] == "failed", rec
        assert rec["error"].startswith("DeadlineExpired"), rec
        hang = rec.get("hang")
        assert hang, rec
        assert hang["reason"] == f"deadline:{j['id']}", hang
        rep_root = hang["verdict"]["root"]
        # all three surfaces agree on (rank, site, peer)
        for root in (live_root, file_root, rep_root):
            assert root["rank"] == 1, (live_root, file_root, rep_root)
            assert root["site"] == "p2p_recv", (live_root, file_root, rep_root)
            assert root["peer"] == 1, (live_root, file_root, rep_root)
        client.shutdown(url)
        assert proc.wait(timeout=60) == 0, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        t.join(timeout=10)
        for p in pids:
            if _state.pid_alive(p):
                os.kill(p, 9)
        time.sleep(0.2)
        _unlink_leftovers(list(pids))
