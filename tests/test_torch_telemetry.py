"""The port's live telemetry plane against the reference's.

Mirrors ``tests/test_telemetry.py`` case by case on
``ompi_tpu_torch.metrics.live`` and the straggler/clock/crash-export
hooks it reads, and adds parity cases:

* straggler profiler, clock alignment and crash-path export units (the
  reference's cases, on the port's modules);
* live plane in-process: publisher → aggregator frames, clock offsets,
  the ``start_publisher`` gate, the five HTTP endpoints;
* parity: the same numpy-seeded frames (native and device-plane
  counters, arrival records, causal records, blocked-state snapshots,
  job scopes) ingested by both packages' ``TelemetryAggregator``s —
  ``json_state()``, ``critical_state()``, ``waitgraph_state()``,
  ``jobs_state()`` and ``prometheus_text()`` equal.  Tolerance: exact,
  except ``first_ts_ns`` (the wall clock at a job's first sighting),
  which is masked; a frame of one package is folded by the other's
  aggregator;
* the np=2 ``python -m ompi_tpu_torch run --cpu`` acceptance: a MID-JOB
  scrape of ``/metrics``, ``/json`` and ``/critical`` names the rank a
  faultsim ``delay:`` plan slowed; with telemetry off no listener is
  opened and no frame is sent.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu_torch import metrics
from ompi_tpu_torch.metrics import core as mcore
from ompi_tpu_torch.metrics import export as mexport
from ompi_tpu_torch.metrics import live, straggler
from ompi_tpu_torch.trace import merge

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def clean_state():
    mcore.reset()
    straggler.reset()
    mexport.reset_crash_latch()
    yield
    mcore.reset()
    straggler.reset()
    mexport.reset_crash_latch()


# -- straggler profiler ------------------------------------------------


def test_straggler_disabled_records_nothing():
    assert not straggler.enabled()
    called = []
    fn = straggler.wrap_call("allreduce", lambda: called.append(1),
                             comm="c")
    fn()  # the wrap records unconditionally; the GATE is at the hook
    assert called == [1]
    # the api hook itself is gated: _lookup never wraps when disabled
    # (asserted structurally by the np=2 disabled-path run); here the
    # module state stays empty after reset
    straggler.reset()
    assert straggler.summary() == {} and straggler.ops() == []


def test_straggler_record_aggregates_and_pvars():
    from ompi_tpu_torch.tool import mpit

    straggler.enable(True)
    fn = straggler.wrap_call("allreduce", lambda: time.sleep(0.002),
                             comm="MPI_COMM_WORLD")
    for _ in range(3):
        fn()
    straggler.note_provider("allreduce", "han")
    summ = straggler.summary()
    assert summ["allreduce"]["count"] == 3
    assert summ["allreduce"]["wait_ns"] >= 3 * 2_000_000
    assert summ["allreduce"]["provider"] == "han"
    # recent records carry (comm, op, seq) keys with SPMD seqs
    recent = straggler.recent()
    assert [r[0] for r in recent] == [
        f"MPI_COMM_WORLD/allreduce/{i}" for i in range(3)]
    assert all(r[2] >= r[1] for r in recent)
    # pvars: grow-only tail, count/wait pair, single-handle reset
    mpit.init_thread()
    try:
        i = mpit.pvar_index("straggler_allreduce_count")
        assert mpit.pvar_read(i) == 3
        w = mpit.pvar_index("straggler_allreduce_wait_ns")
        assert mpit.pvar_read(w) >= 3 * 2_000_000
        assert "straggler" in mpit.pvar_get_info(w).help
        mpit.pvar_reset_one(i)  # count/wait are one aggregate
        assert mpit.pvar_read(i) == 0 and mpit.pvar_read(w) == 0
        assert straggler.ops() == ["allreduce"]  # key survives reset
    finally:
        mpit.finalize()
    # drain hands the records to the publisher exactly once
    assert len(straggler.drain_recent()) == 3
    assert straggler.drain_recent() == []


def test_straggler_reset_op_rebaselines_native_rows():
    """Per-handle MPI_T_pvar_reset must re-baseline the C-fast-path
    rows exactly like the session-wide zero_stats path — only the
    targeted op, and per provider (a respawned engine never inherits
    a dead predecessor's baseline)."""
    straggler.enable(True)

    class Src:
        rows = {"allgather": {"count": 5, "wait_ns": 9000,
                              "max_wait_ns": 4000, "lat_hist": [0, 5]},
                "bcast": {"count": 2, "wait_ns": 100,
                          "max_wait_ns": 60, "lat_hist": [2]}}

        def optimes(self):
            return {op: dict(st) for op, st in self.rows.items()}

    src = Src()
    straggler.register_native(src, src.optimes)
    assert straggler.op_count("allgather") == 5
    straggler.reset_op("allgather")
    assert straggler.op_count("allgather") == 0
    assert straggler.op_wait_ns("allgather") == 0
    assert straggler.op_count("bcast") == 2      # untouched
    # growth after the reset surfaces as the delta
    src.rows["allgather"]["count"] = 7
    src.rows["allgather"]["wait_ns"] = 9500
    assert straggler.op_count("allgather") == 2
    assert straggler.op_wait_ns("allgather") == 500


def test_straggler_skew_join_with_offsets():
    # rank 1's clock runs 10 ms ahead AND it arrives 25 ms late
    base = 1_000_000_000
    rows0 = [[f"c/allreduce/{i}", base + i * 100_000_000,
              base + i * 100_000_000 + 1_000_000] for i in range(4)]
    rows1 = [[f"c/allreduce/{i}",
              base + i * 100_000_000 + 25_000_000 + 10_000_000,
              base + i * 100_000_000 + 27_000_000 + 10_000_000]
             for i in range(4)]
    out = straggler.join_skew({0: rows0, 1: rows1},
                              offsets_ns={1: 10_000_000})
    assert out["instances"] == 4
    assert out["per_proc"][1]["slowest"] == 4
    assert out["per_proc"][0]["slowest"] == 0
    assert out["per_proc"][1]["skew_ns"] == 4 * 25_000_000
    op = out["per_op"]["allreduce"]
    assert op["n"] == 4 and op["slowest"] == {1: 4}
    assert op["max_skew_ns"] == 25_000_000
    # WITHOUT the offset correction the skew is misestimated by 10 ms
    raw = straggler.join_skew({0: rows0, 1: rows1})
    assert raw["per_proc"][1]["skew_ns"] == 4 * 35_000_000
    # incomplete keys (a rank's record rolled off) are skipped
    partial = straggler.join_skew({0: rows0, 1: rows1[:2]},
                                  offsets_ns={1: 10_000_000})
    assert partial["instances"] == 2


# -- clock alignment ---------------------------------------------------


def test_merge_applies_injected_clock_offsets():
    def doc(pid, shift_us):
        return {
            "traceEvents": [
                {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": f"rank {pid}"}},
                {"ph": "X", "name": "allreduce", "cat": "api", "pid": pid,
                 "tid": 0, "ts": 1000.0 + shift_us, "dur": 50.0,
                 "args": {"comm": "c", "seq": 0}},
            ],
            "otherData": {"dropped_events": 0},
        }

    # rank 1's wall clock is 5000 µs ahead: raw timelines disagree
    merged = merge.merge_chrome([doc(0, 0.0), doc(1, 5000.0)],
                                offsets_us={1: 5000.0})
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    ts = {e["pid"]: e["ts"] for e in spans}
    assert ts[0] == ts[1] == 1000.0, ts
    assert merged["otherData"]["clock_offsets_us"] == {"1": 5000.0}
    # both spans carry the same cross-rank key
    keys = {e["args"]["key"] for e in spans}
    assert keys == {"c/allreduce/0"}
    # offsets_from_snapshots: rank 0's clock section, ns → µs
    snaps = [{"proc": 0, "ts_ns": 1,
              "clock": {"1": [5_000_000, 2000]}},
             {"proc": 1, "ts_ns": 2, "clock": {"0": [-1, 1]}}]
    assert merge.offsets_from_snapshots(snaps) == {1: 5000.0}


def test_merge_partial_marker_survives_empty_crash_dump():
    """A rank that crash-dumped before recording any span still shows
    up in ``partial_processes`` — the doc-level pid carries the rank
    identity when ``traceEvents`` is empty."""
    full = {"traceEvents": [{"ph": "X", "name": "a", "cat": "api",
                             "pid": 0, "tid": 0, "ts": 1.0, "dur": 1.0}],
            "otherData": {"pid": 0}}
    empty_partial = {"traceEvents": [],
                     "otherData": {"pid": 1, "partial": True}}
    merged = merge.merge_chrome([full, empty_partial])
    assert merged["otherData"]["partial_processes"] == [1]


def test_clock_sample_formula():
    from ompi_tpu_torch.dcn.tcp import _clock_sample

    # peer stamped rt while our clock went t0 → t1; symmetric path
    off, rtt = _clock_sample(1000, 7_500, 2000)
    assert rtt == 1000
    assert off == 7_500 - 1500  # peer − midpoint
    off, rtt = _clock_sample(1000, None, 1600)  # pre-upgrade peer
    assert off is None and rtt == 600


def test_handshake_populates_clock_offsets_and_snapshot():
    """Engine pair over the real tcp transport: the dial handshake
    measures per-peer offsets, the engine maps them to procs, and the
    metrics snapshot carries the merged view."""
    from ompi_tpu_torch.dcn.collops import DcnCollEngine

    metrics.enable(True)
    a = DcnCollEngine(0, 2)
    b = DcnCollEngine(1, 2)
    try:
        addrs = [a.address, b.address]
        a.set_addresses(addrs)
        b.set_addresses(addrs)
        a._send(1, 7, 0, np.arange(8.0))
        b._recv(0, 7, 0, timeout=30)
        offs = a.transport.clock_offsets
        assert b.address in offs, offs
        off_ns, rtt_ns = offs[b.address]
        assert 0 <= rtt_ns < 5_000_000_000, rtt_ns
        assert abs(off_ns) < 60_000_000_000, off_ns  # same host: sane
        assert 1 in a.clock_offsets(), a.clock_offsets()
        snap = mcore.snapshot(proc=0)
        assert "1" in (snap.get("clock") or {}), snap.get("clock")
    finally:
        a.close()
        b.close()


# -- live plane (in-process) -------------------------------------------


def test_publisher_streams_frames_to_aggregator():
    metrics.enable(True)
    straggler.enable(True)

    class Fake:
        def stats(self):
            d = {k: 0 for k in mcore.NATIVE_COUNTERS}
            d["delivered"] = 42
            return d

    eng = Fake()
    mcore.register_provider(eng, eng.stats)
    straggler.record("c", "bcast", time.time_ns(),
                     time.time_ns() + 1_000_000)
    agg = live.TelemetryAggregator(http_port=0, history=8)
    pub = live.TelemetryPublisher(agg.ingest_address, proc=0, nprocs=1,
                                  interval_ms=40)
    try:
        deadline = time.monotonic() + 10
        while agg.frames < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert agg.frames >= 2, agg.frames
        state = agg.json_state()
        f = state["procs"]["0"]
        assert f["native"]["delivered"] == 42
        assert f["straggler"]["bcast"]["count"] == 1
        prom = agg.prometheus_text()
        assert 'ompi_tpu_dcn_delivered{proc="0"} 42' in prom, prom
        assert 'ompi_tpu_op_calls_total{proc="0",op="bcast"} 1' in prom
    finally:
        pub.stop()
        agg.close()
    # stopped publisher sent a final frame and closed its socket
    assert pub._sock is None


def test_aggregator_clock_offsets_indirect_and_late():
    """Offsets learned from a NON-rank-0 frame (the peer dialed rank 0,
    so it holds the pair's handshake sample) and AFTER records were
    staged still correct the join — arrivals stage raw and align at
    completion time."""
    agg = live.TelemetryAggregator(http_port=0, history=4)
    try:
        base = 1_000_000_000
        # rank 1's clock runs 5 ms ahead; its arrival record lands
        # BEFORE any clock-bearing frame
        agg.ingest({"proc": 1, "nprocs": 2,
                    "colls": [["c/allreduce/0", base + 5_000_000,
                               base + 6_000_000]]})
        # rank 1 measured rank 0: rank0 − rank1 = −5 ms → offset +5 ms
        agg.ingest({"proc": 1, "nprocs": 2, "colls": [],
                    "clock": {"0": [-5_000_000, 1000]}})
        assert agg.json_state()["clock_offsets_ns"] == {"1": 5_000_000}
        # rank 0 completes the instance: corrected arrivals coincide
        agg.ingest({"proc": 0, "nprocs": 2,
                    "colls": [["c/allreduce/0", base, base + 500_000]]})
        st = agg.json_state()["straggler"]
        assert st["per_op"]["allreduce"]["n"] == 1
        assert st["per_op"]["allreduce"]["skew_ns"] == 0, st
        # a DIRECT rank-0 measurement overrides the indirect estimate
        agg.ingest({"proc": 0, "nprocs": 2, "colls": [],
                    "clock": {"1": [4_000_000, 800]}})
        assert agg.json_state()["clock_offsets_ns"]["1"] == 4_000_000
        # ...and a later indirect sample no longer overwrites it
        agg.ingest({"proc": 1, "nprocs": 2, "colls": [],
                    "clock": {"0": [-5_000_000, 900]}})
        assert agg.json_state()["clock_offsets_ns"]["1"] == 4_000_000
    finally:
        agg.close()


def test_start_publisher_requires_flag_and_env():
    class Store(dict):
        def get(self, k, d=None):
            return super().get(k, d)

    os.environ.pop(live.ENV_TELEMETRY, None)
    # flag off → None;  flag on but no launcher aggregator → None
    assert live.start_publisher(object(), Store()) is None
    assert live.start_publisher(
        object(), Store(telemetry_enable=True)) is None
    assert live.publisher() is None


# -- crash-path export -------------------------------------------------


def test_crash_dump_writes_partial_and_latches(tmp_path):
    from ompi_tpu_torch.core import mca

    metrics.enable(True)
    mcore.observe("dcn_p2p_send", 4096, 1000)
    store = mca.default_context().store
    old = store.get("metrics_output", "")
    store.set("metrics_output", str(tmp_path / "m"))
    try:
        paths = mexport.crash_dump("unit")
        assert paths, "crash_dump wrote nothing"
        lines = [json.loads(l) for l in
                 Path(f"{tmp_path}/m.0.jsonl").read_text().splitlines()]
        final = lines[-1]
        assert final["partial"] is True and final["reason"] == "crash"
        # the flight ring recorded why
        reasons = [l.get("reason") for l in lines]
        assert "crash_export" in reasons, reasons
        # Prometheus text came too, with the per-op straggler family
        assert Path(f"{tmp_path}/m.0.prom").exists()
        # once-latch: a second escalation does not rewrite
        assert mexport.crash_dump("again") == []
        mexport.reset_crash_latch()
        assert mexport.crash_dump("rearmed") != []
    finally:
        store.set("metrics_output", old)


def test_prometheus_straggler_family():
    metrics.enable(True)
    straggler.enable(True)
    straggler.record("c", "allreduce", 0, 3_000_000)
    text = mexport.to_prometheus(mcore.snapshot(proc=2))
    assert ('ompi_tpu_coll_wait_ns_total{proc="2",op="allreduce"} '
            "3000000") in text, text


# -- faultsim proc filter (the straggler test's instrument) ------------


def test_faultsim_proc_targeted_rule():
    from ompi_tpu_torch.faultsim import core as fsim

    rules = fsim.parse_plan("delay:ms=5;site=recv;proc=1")
    assert rules[0].proc == 1 and rules[0].site == "recv"
    hit0 = fsim.FaultPlan(rules, seed=9, proc=0)
    hit1 = fsim.FaultPlan(rules, seed=9, proc=1)
    for _ in range(50):
        assert hit0.decide("recv") == ()
    assert all(len(hit1.decide("recv")) == 1 for _ in range(50))
    assert hit0.injected["delay"] == 0
    assert hit1.injected["delay"] == 50


# -- CLI ---------------------------------------------------------------


def test_aggregator_serves_every_endpoint_over_http():
    """The scrape surface that the port's ``top`` reads (its renderer is
    held to the reference's in ``tests/test_torch_tools.py``), checked
    directly — a golden 2-rank frame schedule over real HTTP, every
    endpoint answering with the content its readers parse."""
    agg = live.TelemetryAggregator(http_port=0, history=4)
    try:
        t = time.time_ns()
        for p in (0, 1):
            agg.ingest({"proc": p, "nprocs": 2, "ts_ns": t + p,
                        "native": {"delivered": 10 + p, "device_sends": 3},
                        "straggler": {"allreduce": {"count": 2,
                                                    "wait_ns": 50}},
                        "colls": [["w/allreduce/0", t + p * 1000,
                                   t + 5000]]})
        text = _scrape(agg.url, "/metrics")
        assert 'ompi_tpu_dcn_delivered{proc="1"} 11' in text, text
        assert 'ompi_tpu_dcn_device_sends{proc="0"} 3' in text, text
        assert 'ompi_tpu_op_calls_total{proc="0",op="allreduce"} 2' in text
        js = json.loads(_scrape(agg.url, "/json"))
        assert js["frames"] == 2 and js["straggler"]["per_op"]["allreduce"]["n"] == 1
        hist = _scrape(agg.url, "/history").splitlines()
        assert [json.loads(l)["proc"] for l in hist] == [0, 1]
        assert json.loads(_scrape(agg.url, "/critical"))["instances"] == 0
        wg = json.loads(_scrape(agg.url, "/waitgraph"))
        # no rank reports a blocked wait: nothing to blame but compute
        assert wg["nprocs"] == 2 and wg["verdict"]["kind"] == "compute", wg
        assert json.loads(_scrape(agg.url, "/jobs")) == {"jobs": {},
                                                         "current": {}}
    finally:
        agg.close()


# -- np=2 tpurun acceptance --------------------------------------------

#: the port's counterpart of ``tests/workers/mp_telemetry_worker.py``:
#: collectives until TEL_RUN_SECS of wall clock pass (the allreduce
#: result is the stop vote, so every rank runs the same count); with
#: TEL_EXPECT=off it asserts the disabled path instead
_WORKER = r'''
import os
import sys
import time

import numpy as np

import ompi_tpu_torch.api as api
from ompi_tpu_torch.metrics import live, straggler
from ompi_tpu_torch.op import SUM

RUN_SECS = float(os.environ.get("TEL_RUN_SECS", "8"))
EXPECT = os.environ.get("TEL_EXPECT", "on")

world = api.init()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ompi_tpu")]
assert not bad, bad
assert world.device.type == "cpu", world.device
p = world.proc
n = world.size
assert n == 2 and world.local_size == 1, (n, world.local_size)

if EXPECT == "off":
    assert live.publisher() is None, "publisher started while disabled"
    assert not straggler.enabled(), "straggler armed while disabled"
    world.allreduce(np.ones((1, 4)), SUM)
    assert straggler.summary() == {}, straggler.summary()
    print(f"OK telemetry_disabled proc={p} publisher=None", flush=True)
    api.finalize()
    raise SystemExit(0)

pub = live.publisher()
assert pub is not None, "telemetry_enable did not start the publisher"
assert straggler.enabled(), "telemetry_enable must arm the profiler"

t_end = time.monotonic() + RUN_SECS
iters = 0
while True:
    vote = 1.0 if time.monotonic() < t_end else 0.0
    out = world.allreduce(np.full((1, 4), vote), SUM)
    iters += 1
    if float(np.asarray(out)[0, 0]) < n:  # any rank voted stop
        break

summ = straggler.summary()
assert summ.get("allreduce", {}).get("count", 0) >= iters, summ
deadline = time.monotonic() + 5
while pub.sent == 0 and time.monotonic() < deadline:
    time.sleep(0.05)
assert pub.sent > 0, "no telemetry frame reached the aggregator"
print(f"OK telemetry proc={p} iters={iters} frames={pub.sent}", flush=True)
api.finalize()
assert live.publisher() is None, "finalize left the publisher running"
print(f"OK finalize proc={p}", flush=True)
'''


def _write_worker(tmp_path) -> Path:
    path = tmp_path / "telemetry_worker.py"
    path.write_text(_WORKER)
    return path



def _scrape(url: str, path: str = "/metrics", timeout: float = 3.0) -> str:
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.read().decode()


def _prom_value(text: str, prefix: str) -> int | None:
    for line in text.splitlines():
        if line.startswith(prefix):
            return int(float(line.rsplit(" ", 1)[1]))
    return None


def test_tpurun_np2_live_scrape_and_straggler_attribution(tmp_path):
    """The acceptance run: scrape the aggregator MID-JOB and find
    nonzero, monotone per-rank dcn_* counters plus a straggler table
    whose slowest rank is the one the faultsim ``delay:`` plan (30 ms
    on every inbound frame, rank 1 only) slowed."""
    worker = _write_worker(tmp_path)
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2",
           "--nranks", "1", "--cpu",
           "--mca", "telemetry_enable", "1",
           "--mca", "telemetry_interval_ms", "150",
           "--mca", "btl", "tcp",
           "--mca", "faultsim_enable", "1",
           "--mca", "faultsim_seed", "3",
           "--mca", "faultsim_plan", "delay:ms=30;site=recv;proc=1",
           str(worker)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    env["TEL_RUN_SECS"] = "8"
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env,
                            cwd=str(REPO))
    lines: list[str] = []

    def _reader():
        for raw in iter(proc.stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    try:
        # the launcher prints the endpoint before spawning workers
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            for l in list(lines):
                if "[tpurun] telemetry: " in l:
                    url = (l.split("[tpurun] telemetry: ", 1)[1]
                           .split("/metrics", 1)[0])
                    break
            time.sleep(0.05)
        assert url, "tpurun never printed the telemetry endpoint:\n" \
            + "".join(lines)

        # MID-JOB: wait for both ranks' frames + straggler joins
        first = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                text = _scrape(url)
            except OSError:
                time.sleep(0.2)
                continue
            d0 = _prom_value(text, 'ompi_tpu_dcn_delivered{proc="0"}')
            d1 = _prom_value(text, 'ompi_tpu_dcn_delivered{proc="1"}')
            s1 = _prom_value(
                text, 'ompi_tpu_straggler_slowest_total{proc="1"}')
            if d0 and d1 and s1:
                first = text
                break
            time.sleep(0.2)
        assert first is not None and proc.poll() is None, (
            "no live mid-job scrape with both ranks + straggler data:\n"
            + "".join(lines))

        # monotone counters across two scrapes of the RUNNING job
        time.sleep(0.8)
        second = _scrape(url)
        for p in (0, 1):
            k = f'ompi_tpu_dcn_delivered{{proc="{p}"}}'
            assert _prom_value(second, k) >= _prom_value(first, k) > 0
        # per-op arrival skew names allreduce; rank 1 is the straggler
        assert _prom_value(
            second,
            'ompi_tpu_coll_arrival_skew_ns_total{op="allreduce"}') > 0
        s0 = _prom_value(second,
                         'ompi_tpu_straggler_slowest_total{proc="0"}') or 0
        s1 = _prom_value(second,
                         'ompi_tpu_straggler_slowest_total{proc="1"}')
        assert s1 > s0, (s0, s1, second)
        sc0 = _prom_value(second,
                          'ompi_tpu_straggler_score_ns{proc="0"}') or 0
        sc1 = _prom_value(second,
                          'ompi_tpu_straggler_score_ns{proc="1"}')
        assert sc1 > max(sc0, 5_000_000), (sc0, sc1)  # ≈30 ms EWMA
        # the /json feed agrees
        state = json.loads(_scrape(url, "/json"))
        pp = state["straggler"]["per_proc"]
        assert pp["1"]["slowest"] > pp.get("0", {}).get("slowest", 0)
        # the other live endpoints answer mid-job too: the history ring
        # holds both ranks' frames, /critical and /waitgraph parse
        hist = [json.loads(l) for l in _scrape(url, "/history").splitlines()]
        assert {f["proc"] for f in hist} == {0, 1}
        crit = json.loads(_scrape(url, "/critical"))
        assert set(crit) >= {"instances", "per_rank", "dominant", "jobs"}
        wg = json.loads(_scrape(url, "/waitgraph"))
        assert wg["nprocs"] == 2 and "verdict" in wg

        assert proc.wait(timeout=180) == 0, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        t.join(timeout=10)
    out = "".join(lines)
    assert len([l for l in out.splitlines()
                if "OK telemetry proc=" in l]) == 2, out
    assert len([l for l in out.splitlines()
                if "OK finalize" in l]) == 2, out


def test_tpurun_np2_telemetry_disabled_no_listener_no_frames(tmp_path):
    """Disabled path: no aggregator, no URL line, no publisher object,
    no straggler state — zero sockets, zero frames."""
    worker = _write_worker(tmp_path)
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2",
           "--nranks", "1", "--cpu", "--mca", "btl", "tcp",
           "--mca", "telemetry_port", "0", str(worker)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    env["TEL_EXPECT"] = "off"
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(cmd, capture_output=True, timeout=180, env=env,
                         cwd=str(REPO))
    out = res.stdout.decode()
    assert res.returncode == 0, out + res.stderr.decode()
    assert "[tpurun] telemetry" not in out, out
    assert len([l for l in out.splitlines()
                if "OK telemetry_disabled" in l]) == 2, out


# -- parity: the same frames through both packages' aggregators --------


def _frames(seed: int, nprocs: int = 3, n_inst: int = 24) -> list[dict]:
    """A numpy-seeded frame schedule: per proc, native and device-plane
    counters that grow, straggler aggregates, arrival records and
    causal records for shared collective instances (one proc late by a
    seeded skew), clock samples, a job scope switch, and blocked-state
    snapshots on one proc (a straggler chain)."""
    rng = np.random.default_rng(seed)
    base = 1_700_000_000_000_000_000
    counters = {p: {"delivered": 0, "ring_stall_ns": 0, "cts_wait_ns": 0,
                    "device_sends": 0, "device_bytes_placed": 0,
                    "device_dma_wait_ns": 0, "reconnects": 0}
                for p in range(nprocs)}
    frames = []
    for k in range(n_inst):
        late = int(rng.integers(0, nprocs))
        for p in range(nprocs):
            c = counters[p]
            c["delivered"] += int(rng.integers(1, 50))
            c["ring_stall_ns"] += int(rng.integers(0, 10_000))
            c["device_sends"] += int(rng.integers(0, 3))
            c["device_bytes_placed"] += int(rng.integers(0, 3)) << 20
            c["device_dma_wait_ns"] += int(rng.integers(0, 5_000))
            t0 = base + k * 10_000_000
            arrive = t0 + (int(rng.integers(2, 9)) * 1_000_000
                           if p == late else int(rng.integers(0, 200_000)))
            exit_ = t0 + 9_500_000 + int(rng.integers(0, 100_000))
            key = f"MPI_COMM_WORLD/allreduce/{k}"
            peer = (p + 1) % nprocs
            src = (p - 1) % nprocs
            causal = [key, arrive, exit_, "ring",
                      [[0, arrive + 1000, peer]],
                      [[src, 0, exit_ - 2000, int(rng.integers(0, 1_000_000))]],
                      {"ring": int(rng.integers(0, 50_000)), "cts": 0,
                       "dma": int(rng.integers(0, 20_000))}]
            f = {"proc": p, "nprocs": nprocs, "ts_ns": t0 + 9_900_000 + p,
                 "native": dict(c),
                 "straggler": {"allreduce": {"count": k + 1,
                                             "wait_ns": (k + 1) * 1000,
                                             "max_wait_ns": 900,
                                             "provider": "han"}},
                 "colls": [[key, arrive, exit_]],
                 "causal": [causal]}
            if k == 0 and p:
                f["clock"] = {"0": [int(rng.integers(-50_000, 50_000)), 800]}
            if k >= n_inst // 2:
                f["job"] = "j2"
            if k == n_inst - 1 and p == 0:
                f["waits"] = {"ts_ns": f["ts_ns"], "waits": [
                    {"site": "coll_recv", "plane": "host", "peer": 1,
                     "since_ns": f["ts_ns"] - 3_000_000_000,
                     "cid": "0", "seq": k}]}
                f["failed"] = []
            frames.append(f)
    return frames


def _fold(agg_cls, frames, begin_at: int):
    agg = agg_cls(http_port=0, history=64)
    try:
        for i, f in enumerate(frames):
            if i == begin_at:
                agg.begin_job("j2")
            agg.ingest(json.loads(json.dumps(f)))
        jobs = agg.jobs_state()
        for st in jobs["jobs"].values():
            st["first_ts_ns"] = "<ts>"
        return {"json": agg.json_state(), "critical": agg.critical_state(),
                "waitgraph": agg.waitgraph_state(), "jobs": jobs,
                "prom": agg.prometheus_text()}
    finally:
        agg.close()


@pytest.mark.parametrize("seed", [3, 4])
def test_aggregator_states_equal_reference_on_same_frames(seed):
    """Both aggregators fold the same seeded frames (with a job scope
    begun halfway) into equal /json, /critical, /waitgraph, /jobs and
    /metrics states."""
    from ompi_tpu.metrics import live as ref_live

    frames = _frames(seed)
    begin_at = len(frames) // 2
    port = _fold(live.TelemetryAggregator, frames, begin_at)
    ref = _fold(ref_live.TelemetryAggregator, frames, begin_at)
    for key in ("json", "critical", "waitgraph", "jobs"):
        assert port[key] == ref[key], key
    assert port["prom"] == ref["prom"]
    # the schedule exercised every surface
    assert port["critical"]["instances"] > 0
    assert port["json"]["straggler"]["per_op"]["allreduce"]["n"] > 0
    assert port["waitgraph"]["verdict"]["kind"] == "straggler"
    assert 'job="j2"' in port["prom"] and "device_bytes_placed" in port["prom"]


def test_publisher_frame_folds_in_the_reference_aggregator():
    """A frame the port's publisher builds (native and device-plane
    counters from a provider, straggler records, causal records, the
    job label) is folded by the reference's aggregator exactly as by
    the port's."""
    from ompi_tpu.metrics import live as ref_live
    from ompi_tpu_torch.trace import causal

    metrics.enable(True)
    straggler.enable(True)

    class Fake:
        def stats(self):
            d = {k: 0 for k in mcore.NATIVE_COUNTERS}
            d.update(delivered=42, device_sends=5, device_bytes_placed=1 << 24)
            return d

    eng = Fake()
    mcore.register_provider(eng, eng.stats)
    t = time.time_ns()
    straggler.record("c", "allreduce", t, t + 1_000_000)
    causal.reset()
    causal.enable(True)
    live.set_job("j1")
    try:
        pub = live.TelemetryPublisher.__new__(live.TelemetryPublisher)
        pub.proc, pub.nprocs, pub._detector = 0, 1, None
        frame = pub.frame()
    finally:
        live.set_job(None)
        causal.reset()
    assert frame["job"] == "j1" and frame["native"]["device_sends"] == 5
    assert frame["colls"] and frame["colls"][0][0] == "c/allreduce/0"
    states = []
    for cls in (live.TelemetryAggregator, ref_live.TelemetryAggregator):
        agg = cls(http_port=0, history=4)
        try:
            agg.ingest(json.loads(json.dumps(frame)))
            states.append((agg.json_state(), agg.prometheus_text()))
        finally:
            agg.close()
    assert states[0] == states[1]
    assert 'ompi_tpu_dcn_device_sends{proc="0"} 5' in states[0][1]
