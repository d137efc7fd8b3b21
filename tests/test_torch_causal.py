"""The port's causal tracer, straggler profiler, trace merge and the
native wait-state mirror against the reference's.

* causal tracing on the Python plane: off, coll envelopes carry no
  ``tc`` key and no counter moves; on, every coll frame carries the
  same versioned context as the reference's and both sides record send
  and recv edges;
* on the native plane the context rides the frame's meta JSON (user
  meta survives, ``tc`` is popped) and the C mirror of the field table
  agrees with ``CTX_FIELDS``;
* the solver (critical path, blame, tie preference, carving) gives the
  reference's answers on the same records, including the golden
  fixture; the ``trace_causal_*`` pvars read and reset in place;
* the straggler profiler records, summarizes and joins skew as the
  reference's does, and ``CollTable.lookup`` notes the serving module;
* the trace merge of per-process Chrome files equals the reference's;
* a native engine's blocked coll wait reaches the wait-graph snapshot
  through ``register_native`` as the reference's does;
* a port job with a straggler injected on process 1 (faultsim
  ``delay:ms=30;site=recv;proc=1``) names (rank 1, arrival-skew) in its
  finalize causal export and in the reference's ``trace_report.py
  --critical-path`` over the port's trace files.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu.dcn import collops as rcollops
from ompi_tpu.metrics import straggler as rstrag
from ompi_tpu.op import op as rop
from ompi_tpu.trace import causal as rcausal
from ompi_tpu.trace import merge as rmerge
from ompi_tpu.trace import waitgraph as rwg
from ompi_tpu_torch.dcn import collops as pcollops
from ompi_tpu_torch.metrics import straggler as pstrag
from ompi_tpu_torch.op import op as pop
from ompi_tpu_torch.trace import causal as pcausal
from ompi_tpu_torch.trace import merge as pmerge
from ompi_tpu_torch.trace import waitgraph as pwg
from torch_mp_common import REPO, run_job

PKG = {"ref": (rcollops, rop, rcausal), "port": (pcollops, pop, pcausal)}
MS = 1_000_000


@pytest.fixture(autouse=True)
def _fresh():
    for m in (rcausal, pcausal, rstrag, pstrag, rwg, pwg):
        m.reset()
    yield
    for m in (rcausal, pcausal, rstrag, pstrag, rwg, pwg):
        m.reset()


def _python_pair(pkg):
    engines = [PKG[pkg][0].DcnCollEngine(p, 2) for p in range(2)]
    addrs = [e.address for e in engines]
    for e in engines:
        e.set_addresses(addrs)
    envs = []
    orig = engines[0].transport.send

    def spy(address, envelope, payload):
        envs.append(dict(envelope))
        return orig(address, envelope, payload)

    engines[0].transport.send = spy
    return engines, envs


def _allreduce_in_threads(pkg, engines, cid, traced):
    causal, op = PKG[pkg][2], PKG[pkg][1]

    def run(eng):
        if traced:
            causal.begin_op("W", "allreduce", 0)
        eng.allreduce(np.ones(4), op.SUM, cid=cid)
        if traced:
            causal.end_op()

    t = threading.Thread(target=run, args=(engines[1],))
    t.start()
    run(engines[0])
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("traced", [False, True], ids=["disabled", "enabled"])
def test_causal_wire_context_on_the_python_plane(traced):
    """Off: no ``tc`` key, no counter moves (frames are byte-identical
    to a build without the tracer).  On: every coll frame carries
    ``[v, comm, op, seq, hop]`` and both sides record edges — the same
    envelopes, counters and record shapes as the reference's."""
    got = {}
    for pkg in ("ref", "port"):
        PKG[pkg][2].enable(traced)
        engines, envs = _python_pair(pkg)
        try:
            _allreduce_in_threads(pkg, engines, 12, traced)
        finally:
            for e in engines:
                e.close()
        causal = PKG[pkg][2]
        recs = causal.recent()
        # the two ranks' threads end their ops in either order: compare
        # the records as a sorted list, not in completion order
        got[pkg] = ([sorted(env) for env in envs], [env.get("tc") for env in envs],
                    causal.counters_snapshot(),
                    sorted((r[0], len(r[4]), len(r[5]), [e[:2] for e in r[5]]) for r in recs))
    assert got["port"] == got["ref"]
    keys, tcs, counters, recs = got["port"]
    if traced:
        assert tcs and all(tc[:4] == [pcausal.CTX_VERSION, "W", "allreduce", 0] for tc in tcs)
        assert counters["records"] == 2 and counters["sends"] >= 2 and counters["recvs"] >= 2
    else:
        assert all(set(k) <= {"kind", "cid", "seq", "src", "meta"} for k in keys)
        assert counters == {"records": 0, "sends": 0, "recvs": 0, "dropped": 0} and not recs


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_causal_native_plane_meta_ride_and_c_mirror(pkg):
    """The context rides the native frame's meta JSON end to end; the
    user meta survives, the reserved ``tc`` key does not reach it."""
    from ompi_tpu.dcn import native as rnative
    from ompi_tpu_torch.dcn import native as pnative

    native = {"ref": rnative, "port": pnative}[pkg]
    causal = PKG[pkg][2]
    lib = native.load_library()
    assert lib.tdcn_trace_ctx_version() == causal.CTX_VERSION == pcausal.CTX_VERSION
    assert lib.tdcn_trace_ctx_fields().decode() == ",".join(pcausal.CTX_FIELDS)
    causal.enable(True)
    a, b = native.NativeDcnEngine(0, 2), native.NativeDcnEngine(1, 2)
    addrs = [a.address, b.address]
    a.set_addresses(addrs)
    b.set_addresses(addrs)
    try:
        causal.begin_op("W", "bcast", 3)
        a._send(1, "cx", 0, np.arange(8, dtype=np.float64), meta={"user": 1})
        causal.end_op()
        causal.begin_op("W", "bcast", 3)
        env, payload = b._recv_full(0, "cx", 0, timeout=30)
        causal.end_op()
    finally:
        a.destroy()
        b.destroy()
    assert np.array_equal(payload, np.arange(8.0)) and env.get("meta") == {"user": 1}
    recvs = [r[5] for r in causal.recent() if r[5]]
    assert recvs and recvs[0][0][:2] == [0, 0]


def _solver_cases():
    k = "W/allreduce/0"
    return {
        "near_tie": ([k, 0, 31 * MS, "x", [[0, 31 * MS, 1]], [[1, 0, 30 * MS, 30 * MS]], {}],
                     [k, 30 * MS, 61 * MS, "x", [[0, 30 * MS, 0]],
                      [[0, 0, 61 * MS, 31 * MS]], {}]),
        "transport": ([k, 0, 41 * MS, "x", [[0, 1 * MS, 1]], [], {}],
                      [k, 0, 41 * MS, "x", [], [[0, 0, 41 * MS, 40 * MS]], {}]),
        "dma_carve": ([k, 0, 41 * MS, "x", [[0, 1 * MS, 1]], [], {}],
                      [k, 0, 41 * MS, "x", [], [[0, 0, 41 * MS, 40 * MS]], {"dma": 35 * MS}]),
        "ring_cts_carve": ([k, 0, 50 * MS, "x", [[0, 49 * MS, 1]], [],
                            {"ring": 20 * MS, "cts": 5 * MS}],
                           [k, 0, 50 * MS, "x", [], [[0, 0, 50 * MS, 5 * MS]], {}]),
    }


@pytest.mark.parametrize("case", sorted(_solver_cases()))
def test_causal_solver_matches_reference(case):
    r0, r1 = _solver_cases()[case]
    out = {}
    for pkg in ("ref", "port"):
        causal = PKG[pkg][2]
        inst = causal.instances_from_records({0: [r0], 1: [r1]})
        out[pkg] = (causal.critical_path(inst["W/allreduce/0"]),
                    causal.solve(inst), causal.solve(inst, nprocs=3)["instances"])
    assert json.dumps(out["port"], sort_keys=True) == json.dumps(out["ref"], sort_keys=True)
    if case == "near_tie":
        assert out["port"][0]["dominant"] == {"rank": 1, "cause": "arrival-skew", "ns": 30 * MS}
    assert out["port"][2] == 0  # incomplete under nprocs=3


def test_causal_solver_golden_fixture():
    doc = json.loads((REPO / "tests" / "golden" / "causal_fixture.json").read_text())
    recs = {int(p): rows for p, rows in doc["records_by_proc"].items()}
    port, ref = pcausal.profile_from_records(recs), rcausal.profile_from_records(recs)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    trace = json.loads((REPO / "tests" / "golden" / "trace_fixture.json").read_text())
    assert json.dumps(pcausal.instances_from_chrome(trace), sort_keys=True) == \
        json.dumps(rcausal.instances_from_chrome(trace), sort_keys=True)


def test_causal_and_straggler_pvars_and_reset():
    from ompi_tpu_torch.tool import mpit

    mpit.init_thread()
    try:
        names = [mpit.pvar_get_info(i).name for i in range(mpit.pvar_get_num())]
        for k in pcausal.PVARS:
            assert f"trace_causal_{k}" in names
        pcausal.enable(True)
        pcausal.begin_op("W", "allreduce", 0)
        pcausal.note_send(1)
        pcausal.end_op()
        idx = mpit.pvar_index("trace_causal_sends")
        assert mpit.pvar_read(idx) == 1
        mpit.pvar_reset_one(idx)
        assert mpit.pvar_read(idx) == 0
        assert mpit.pvar_read(mpit.pvar_index("trace_causal_records")) == 1
        pstrag.enable(True)
        pstrag.record("W", "bcast", 100, 350)
        cnt = mpit.pvar_index("straggler_bcast_count")
        wait = mpit.pvar_index("straggler_bcast_wait_ns")
        assert (mpit.pvar_read(cnt), mpit.pvar_read(wait)) == (1, 250)
        mpit.pvar_reset_one(wait)  # the pair resets together
        assert (mpit.pvar_read(cnt), mpit.pvar_read(wait)) == (0, 0)
        pstrag.record("W", "bcast", 0, 10)
        mpit.pvar_reset()
        assert mpit.pvar_read(mpit.pvar_index("trace_causal_records")) == 0
        assert mpit.pvar_read(cnt) == 0 and "straggler_bcast_count" in [
            mpit.pvar_get_info(i).name for i in range(mpit.pvar_get_num())]
    finally:
        mpit.finalize()


def test_straggler_records_summary_and_skew_join():
    arrivals = {0: [["W/allreduce/0", 100, 900], ["W/allreduce/1", 1000, 1900]],
                1: [["W/allreduce/0", 400, 905], ["W/allreduce/1", 1005, 1910]],
                2: [["W/allreduce/0", 150, 910]]}
    out = {}
    for pkg, strag in (("ref", rstrag), ("port", pstrag)):
        strag.enable(True)
        fn = strag.wrap_call("allreduce", lambda x: x * 2, comm="W")
        assert fn(21) == 42
        strag.note_provider("allreduce", "han")
        strag.record("W", "bcast", 10, 30)
        summ = strag.summary()
        out[pkg] = ({op: (st["count"], st["provider"]) for op, st in summ.items()},
                    summ["bcast"]["wait_ns"], [r[0] for r in strag.recent()],
                    strag.join_skew(arrivals, offsets_ns={1: 5}),
                    strag.instance_skew({0: 5, 1: 9, 2: 7}))
        strag.zero_stats()
        assert strag.op_count("bcast") == 0 and "bcast" in strag.ops()
    assert json.dumps(out["port"], sort_keys=True) == json.dumps(out["ref"], sort_keys=True)
    assert out["port"][0] == {"allreduce": (1, "han"), "bcast": (1, "")}


def test_coll_table_notes_the_provider():
    import ompi_tpu_torch.api as api

    api.finalize()
    w = api.init(device="cpu", nranks=4)
    try:
        pstrag.enable(True)
        import torch

        got = w.coll.lookup("allreduce")(torch.ones((4, 3)), pop.SUM)
        assert torch.equal(got, torch.full((4, 3), 4.0))
        assert pstrag._providers["allreduce"] == w.coll.providers["allreduce"] != "?"
    finally:
        api.finalize()


def test_trace_merge_matches_reference(tmp_path):
    docs = []
    for p in range(2):
        evs = [{"name": "allreduce", "ph": "X", "ts": 10.0 + p + 5 * i, "dur": 2.0, "pid": p,
                "tid": 1, "cat": "api", "args": {"comm": "W", "op": "allreduce", "seq": i}}
               for i in range(3)]
        evs.append({"name": "send", "ph": "i", "ts": 11.5 + p, "pid": p, "tid": 1,
                    "cat": "p2p", "args": {}})
        docs.append({"traceEvents": evs, "displayTimeUnit": "ns"})
    paths = []
    for p, d in enumerate(docs):
        paths.append(str(tmp_path / f"t.{p}.json"))
        Path(paths[-1]).write_text(json.dumps(d))
    snaps = [{"proc": 1, "clock": {"0": [2000, 50]}}]
    port, ref = pmerge.merge_files(paths), rmerge.merge_files(paths)
    assert port == ref
    assert pmerge.collective_keys(port, 1) == rmerge.collective_keys(ref, 1) == [
        ("W", "allreduce", i) for i in range(3)]
    assert pmerge.offsets_from_snapshots(snaps) == rmerge.offsets_from_snapshots(snaps)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_native_blocked_wait_reaches_the_snapshot(pkg):
    """A coll receive parked in the C engine is invisible to Python; the
    engine's ``waitinfo`` reader, registered through ``register_native``,
    puts it in the wait-graph snapshot naming the awaited peer."""
    from ompi_tpu.dcn import native as rnative
    from ompi_tpu_torch.dcn import native as pnative

    native = {"ref": rnative, "port": pnative}[pkg]
    wg = {"ref": rwg, "port": pwg}[pkg]
    wg.enable(True)
    a, b = native.NativeDcnEngine(0, 2), native.NativeDcnEngine(1, 2)
    addrs = [a.address, b.address]
    a.set_addresses(addrs)
    b.set_addresses(addrs)
    got = {}
    t = threading.Thread(target=lambda: got.update(r=b._recv_full(0, "hang", 0, timeout=30)))
    try:
        t.start()
        rows = []
        deadline = time.monotonic() + 10
        while not rows and time.monotonic() < deadline:
            time.sleep(0.1)
            rows = [w for w in wg.snapshot(stacks=False)["waits"] if w.get("plane") == "native"]
        a._send(1, "hang", 0, np.arange(3.0))
        t.join(timeout=30)
    finally:
        a.destroy()
        b.destroy()
    assert not t.is_alive() and np.array_equal(got["r"][1], np.arange(3.0))
    assert rows and rows[0]["peer"] == 0 and rows[0]["thread"] == "c-engine", rows


def test_port_job_causal_critical_path(tmp_path):
    """A port job with the straggler on process 1: its finalize causal
    export, joined through the solver, and the reference's
    ``trace_report.py --critical-path`` over its trace files name
    (rank 1, arrival-skew) dominant."""
    script = tmp_path / "w.py"
    script.write_text(
        "import time\n"
        "import numpy as np\n"
        "import ompi_tpu_torch.api as api\n"
        "from ompi_tpu_torch.op import SUM\n"
        "from ompi_tpu_torch.trace import causal, core\n"
        "w = api.init(device='cpu')\n"
        "assert causal.enabled() and core.enabled()\n"
        "t_end, iters = time.monotonic() + 2.5, 0\n"
        "while True:\n"
        "    vote = 1.0 if time.monotonic() < t_end else 0.0\n"
        "    out = w.allreduce(np.full((1, 4), vote), SUM)\n"
        "    iters += 1\n"
        "    if float(out[0, 0]) < w.size:\n"
        "        break\n"
        "c = causal.counters_snapshot()\n"
        "assert c['records'] >= iters and c['sends'] and c['recvs'], c\n"
        "api.finalize()\n"
        "print(f'OK causal proc={w.proc} iters={iters}', flush=True)\n")
    out_trace, out_metrics = tmp_path / "trace", tmp_path / "m"
    res = run_job("port", 2, 1, script, timeout=120, mca={
        "trace_causal": "1", "trace_output": out_trace, "metrics_enable": "1",
        "metrics_output": out_metrics, "btl": "tcp", "faultsim_enable": "1",
        "faultsim_seed": "3", "faultsim_plan": "delay:ms=30;site=recv;proc=1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("OK causal") == 2
    records = {}
    for p in range(2):
        rows = [json.loads(ln) for ln in open(f"{out_metrics}.{p}.jsonl") if ln.strip()]
        records[p] = rows[-1]["causal"]
        assert rows[-1]["causal_counters"]["records"] > 0 and "straggler" in rows[-1]
        assert "ompi_tpu_trace_causal_records" in open(f"{out_metrics}.{p}.prom").read()
    prof = pcausal.profile_from_records(records)
    assert prof["instances"] >= 8
    assert (prof["dominant"]["rank"], prof["dominant"]["cause"]) == (1, "arrival-skew"), prof
    rep = subprocess.run([sys.executable, str(REPO / "tools" / "trace_report.py"),
                          f"{out_trace}.0.json", f"{out_trace}.1.json", "--critical-path"],
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert "dominant: rank 1 cause=arrival-skew" in rep.stdout, rep.stdout
