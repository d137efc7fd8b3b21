"""The port's observability stack against the JAX package's.

The same call sequence on both 8-rank worlds must give equal SPC
snapshots, the same multiset of trace ``(layer, op)`` spans and the same
seq counters, the same sync barrier count and the same monitoring
accounting; bucket functions and the Prometheus rendering must agree;
the port's finalize exports must be readable by the repository's
report tools.  Each package's trace/metrics/SPC/monitoring state is
process-global, so every test starts and ends with both reset.
"""

import collections
import contextlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu import op as jop
from ompi_tpu.core import mca as jmca
from ompi_tpu.metrics import core as jmetrics
from ompi_tpu.metrics import export as jexport
from ompi_tpu.tool import monitoring as jmon
from ompi_tpu.tool import spc as jspc
from ompi_tpu.trace import core as jtrace
from ompi_tpu.trace import merge as jmerge
from ompi_tpu_torch import op as top
from ompi_tpu_torch.core import hooks
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.metrics import core as tmetrics
from ompi_tpu_torch.metrics import export as texport
from ompi_tpu_torch.tool import monitoring as tmon
from ompi_tpu_torch.tool import mpit
from ompi_tpu_torch.tool import spc as tspc
from ompi_tpu_torch.trace import chrome as tchrome
from ompi_tpu_torch.trace import core as ttrace

REPO = Path(__file__).resolve().parent.parent
N = 8


def _reset_all():
    for t in (jtrace, ttrace):
        t.reset()
        t.enable(False)
    for s in (jspc, tspc):
        s.clear()
        s.attach(False)
    for m in (jmetrics, tmetrics):
        m.reset(full=False)
        m.enable(False)
    for mon in (jmon, tmon):
        mon.reset()


@pytest.fixture(autouse=True)
def clean_state():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


def rank_data(shape, seed):
    return np.random.RandomState(seed).randn(N, *shape).astype(np.float32)


def run_sequence(w, op_mod):
    """One call of most entry points, numpy in and out."""
    x = rank_data((13,), 1)
    w.allreduce(x, op_mod.SUM)
    w.allreduce(x, op_mod.SUM)
    w.bcast(x, root=3)
    w.allgather(x)
    w.iallreduce(x, op_mod.SUM).wait()
    w.barrier()
    w.reduce(x, op_mod.SUM, root=1)
    w.scan(x, op_mod.SUM)
    w.alltoall(rank_data((N, 2), 2))
    w.reduce_scatter(rank_data((2 * N,), 3), op_mod.SUM, counts=[2] * N)
    w.allgatherv([x[r, : r + 1] for r in range(N)])


def test_spc_snapshots_equal(worlds):
    jw, tw = worlds
    for w in worlds:  # a pooled barrier token in both arenas
        w.barrier()
    jspc.attach(True)
    tspc.attach(True)
    run_sequence(jw, jop)
    run_sequence(tw, top)
    x = rank_data((5,), 4)
    for w, o in ((jw, jop), (tw, top)):
        w.allreduce_init(x, o.SUM).start().wait()  # the schedule path counts nothing
    want, got = jspc.snapshot(), tspc.snapshot()
    # the reference counts the host-staged signatures it resolves to a
    # buffer-donating XLA program; torch has no donation, so the port's
    # arena_donations stays untouched
    assert want.pop("arena_donations") > 0 and "arena_donations" not in got
    assert got == want
    assert got["allreduce"] == 2 and got["barrier"] == 1 and got["arena_stage_in"] >= 9


def test_trace_spans_and_seqs_equal(worlds):
    jw, tw = worlds
    # a store change invalidates the reference world's dispatch cache, so
    # both resolve (and decide) every signature afresh, as the new port
    # world does
    js = jmca.default_context().store
    js.set("coll_tuned_large_msg", js.get("coll_tuned_large_msg"))
    jtrace.enable(True)
    ttrace.enable(True)
    run_sequence(jw, jop)
    run_sequence(tw, top)

    def spans(t):
        return collections.Counter((e[3], e[4]) for e in t.events() if e[0] == "X")

    def keyed(t):
        return [(e[4], e[5], e[6]) for e in t.events() if e[0] == "X" and e[3] == "api"]

    assert spans(ttrace) == spans(jtrace)
    assert sorted(keyed(ttrace)) == sorted(keyed(jtrace))
    assert ttrace.seqs() == jtrace._seqs
    dec = [(e[4], e[7]) for e in ttrace.events() if e[4] == "tuned_decision"]
    assert dec == [(e[4], e[7]) for e in jtrace.events() if e[4] == "tuned_decision"]
    provs = {e[7]["provider"] for e in ttrace.events() if e[0] == "X" and e[3] == "coll"}
    assert provs == {"tuned", "basic"}
    assert {k for k in ttrace.span_stats()} == {k for k in jtrace.span_stats()}


def test_disabled_by_default_records_nothing(worlds):
    _, tw = worlds
    assert not ttrace.enabled()
    ttrace.instant("api", "nope")
    ttrace.complete("api", "nope", ttrace.now())
    run_sequence(tw, top)
    assert ttrace.event_count() == 0 and ttrace.dropped() == 0
    assert tspc.snapshot() == {} and tmetrics.op_stats() == {}


def test_ring_buffer_bounded_and_counts_drops():
    ttrace.enable(True, buffer_events=8)
    try:
        for i in range(20):
            ttrace.instant("api", f"e{i}")
        assert ttrace.event_count() == 8 and ttrace.dropped() == 12
        assert [e[4] for e in ttrace.events()] == [f"e{i}" for i in range(12, 20)]
    finally:
        ttrace.enable(True, buffer_events=65536)


def test_seq_counters_per_comm_op():
    assert ttrace.next_seq("c1", "allreduce") == 0
    assert ttrace.next_seq("c1", "allreduce") == 1
    assert ttrace.next_seq("c1", "bcast") == 0
    assert ttrace.next_seq("c2", "allreduce") == 0
    ttrace.reset()
    assert ttrace.next_seq("c1", "allreduce") == 0


def test_chrome_export_reads_in_the_reference_merge(worlds, tmp_path):
    _, tw = worlds
    ttrace.enable(True)
    x = rank_data((4,), 5)
    for _ in range(3):
        tw.allreduce(x, top.SUM)
    tw.barrier()
    tw.iallreduce(x, top.SUM).wait()
    p = tmp_path / "t.0.json"
    tchrome.dump(str(p), pid=0)
    doc = json.loads(p.read_text())
    assert doc["displayTimeUnit"] == "ms" and doc["otherData"]["dropped_events"] == 0
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert {"name", "cat", "pid", "tid", "ts", "dur"} <= set(e)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"api", "coll", "request"} <= lanes
    merged = jmerge.merge_files([str(p)])
    keys = jmerge.collective_keys(merged, pid=0)
    assert [k for k in keys if k[1] == "allreduce"] == [
        ("MPI_COMM_WORLD", "allreduce", i) for i in range(3)]


def test_bucket_functions_match_reference():
    grid = sorted({0, 1, 2, 3} | {v + d for e in range(0, 40)
                                  for v in (1 << e,) for d in (-1, 0, 1)})
    for v in grid:
        assert tmetrics.size_bucket(v) == jmetrics.size_bucket(v), v
        assert tmetrics.lat_bucket(v) == jmetrics.lat_bucket(v), v
    assert (tmetrics.SIZE_BUCKETS, tmetrics.LAT_BUCKETS) == (
        jmetrics.SIZE_BUCKETS, jmetrics.LAT_BUCKETS)
    assert tmetrics.NATIVE_COUNTERS == jmetrics.NATIVE_COUNTERS
    assert tmetrics.GAUGES == jmetrics.GAUGES


def test_prometheus_text_from_equal_snapshots_is_equal(worlds):
    _, tw = worlds
    tmetrics.enable(True)
    tspc.attach(True)
    ttrace.enable(True)
    x = rank_data((300,), 6)
    tw.allreduce(x, top.SUM)
    tw.iallreduce(x, top.SUM).wait()
    snap = tmetrics.snapshot(reason="finalize", proc=0)
    assert snap["ops"] and snap["spc"]["arena_stage_bytes"] == 2 * x.nbytes
    assert texport.to_prometheus(snap) == jexport.to_prometheus(snap)
    assert set(snap) == {"ts_ns", "reason", "proc", "native", "ops", "spc"}


def test_sync_barrier_count_equal(worlds):
    jw, tw = worlds
    for w in worlds:  # a pooled barrier token in both arenas
        w.barrier()
    ctxs = (jmca.default_context(), tmca.default_context())
    for c in ctxs:
        c.store.set("coll_sync_barrier_before", 2)
        c.framework("coll").close()
    try:
        jc, tc = jw.dup("synced"), tw.dup("synced")
        assert tc.coll.providers == jc.coll.providers
        assert tc.coll.providers["allreduce"] == "sync"
        assert tc.coll.providers["allgatherv"] == "sync"
        jspc.attach(True)
        tspc.attach(True)
        for w, o in ((jc, jop), (tc, top)):
            x = rank_data((6,), 7)
            for _ in range(5):
                w.allreduce(x, o.SUM)
            w.bcast(x, root=1)
        assert tspc.get("barrier") == jspc.get("barrier") == 3
        assert tspc.snapshot() == jspc.snapshot()
        jc.free()
        tc.free()
    finally:
        for c in ctxs:
            c.store.set("coll_sync_barrier_before", 0)
            c.framework("coll").close()


def test_monitoring_coll_accounting_equal(worlds):
    jw, tw = worlds
    ctxs = (jmca.default_context(), tmca.default_context())
    for c in ctxs:
        c.store.set("monitoring_base_enable", True)
        c.framework("coll").close()
    try:
        jc, tc = jw.dup("monitored"), tw.dup("monitored")
        assert tc.coll.providers == jc.coll.providers
        assert tc.coll.providers["allreduce"] == "monitoring"
        for w, o in ((jc, jop), (tc, top)):
            x = rank_data((4,), 8)
            w.allreduce(x, o.SUM)
            w.allreduce(x, o.PROD)
            w.bcast(x, root=2)
            w.barrier()
        want, got = jmon.flush()["coll"], tmon.flush()["coll"]
        assert got == want
        assert got["monitored:allreduce"] == {"calls": 2, "bytes": 2 * 4 * 4 * N}
        jc.free()
        tc.free()
    finally:
        for c in ctxs:
            c.store.set("monitoring_base_enable", False)
            c.framework("coll").close()


def test_monitoring_dump(tmp_path):
    tmon.account_coll("c", "bcast", 100)
    path = tmp_path / "mon.json"
    tmon.dump(str(path))
    assert json.loads(path.read_text())["coll"]["c:bcast"] == {"calls": 1, "bytes": 100}


# -- MPI_T -----------------------------------------------------------------


@contextlib.contextmanager
def mpit_session():
    mpit.init_thread()
    try:
        yield
    finally:
        mpit.finalize()


def test_mpit_requires_init():
    with pytest.raises(mpit.MPITNotInitialized):
        mpit.cvar_get_num()
    with mpit_session():
        assert mpit.cvar_get_num() > 0
    with pytest.raises(mpit.MPITNotInitialized):
        mpit.finalize()


def test_mpit_cvar_roundtrip(worlds):
    with mpit_session():
        i = mpit.cvar_index("coll_cuda_segcount")
        info = mpit.cvar_get_info(i)
        assert (info.name, info.type) == ("coll_cuda_segcount", "int")
        old = mpit.cvar_read(i)
        mpit.cvar_write(i, 123)
        assert mpit.cvar_read(i) == 123
        mpit.cvar_write(i, old)
        for name in ("trace_enable", "metrics_output", "coll_sched_cache_max",
                     "coll_tuned_huge_msg"):
            assert mpit.cvar_read(mpit.cvar_index(name)) is not None
        with pytest.raises(MPIArgError):
            mpit.cvar_index("no_such_var_xyz")
        with pytest.raises(MPIArgError):
            mpit.cvar_get_info(10 ** 9)


def test_mpit_pvar_reads_spc(worlds):
    _, tw = worlds
    with mpit_session():
        mpit.pvar_start()
        tw.allreduce(np.ones((N, 2), np.float32), top.SUM)
        i = mpit.pvar_index("spc_allreduce")
        assert mpit.pvar_read(i) == 1
        assert mpit.pvar_get_info(i).var_class == mpit.PVAR_CLASS_COUNTER
        mpit.pvar_reset()
        assert mpit.pvar_read(i) == 0
        mpit.pvar_stop()


def test_mpit_trace_and_metrics_pvars(worlds):
    _, tw = worlds
    x = np.ones((N, 2), np.float32)
    with mpit_session():
        ttrace.enable(True)
        tmetrics.enable(True)
        tw.iallreduce(x, top.SUM).wait()
        i = mpit.pvar_index("trace_span_api_iallreduce_count")
        h = mpit.pvar_index("trace_span_api_iallreduce_hist")
        assert mpit.pvar_read(i) == 1 and sum(mpit.pvar_read(h)) == 1
        assert mpit.pvar_get_info(h).var_class == mpit.PVAR_CLASS_AGGREGATE
        m = mpit.pvar_index("metrics_size_request_wait_ArrayRequest_hist")
        assert sum(mpit.pvar_read(m)) == 1
        n_names, ring = mpit.pvar_get_num(), mpit.pvar_read(mpit.pvar_index("trace_events"))
        mpit.pvar_reset()
        assert mpit.pvar_read(i) == 0 and mpit.pvar_get_num() == n_names
        assert mpit.pvar_read(mpit.pvar_index("trace_events")) == ring
        with pytest.raises(MPIArgError):
            mpit.pvar_reset_one(mpit.pvar_index("trace_events"))
        names = [mpit.pvar_get_info(k).name for k in range(n_names)]
        assert names[: len(jspc.known())] == ["spc_" + k for k in jspc.known()]


def test_mpit_categories(worlds):
    with mpit_session():
        ncat = mpit.category_get_num()
        names = [mpit.category_get_info(i)[0] for i in range(ncat)]
        assert {"coll", "trace", "metrics"} <= set(names)
        assert sum(mpit.category_get_info(i)[1] for i in range(ncat)) == mpit.cvar_get_num()


# -- init/finalize: hooks and exports --------------------------------------


def _metrics_report():
    spec = importlib.util.spec_from_file_location(
        "metrics_report_tool", REPO / "tools" / "metrics_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_finalize_writes_exports_the_report_tools_read(devices, tmp_path, capsys):
    fired = []
    for ev in hooks.EVENTS:
        hooks.register(ev, lambda ev=ev, **kw: fired.append(ev))
    try:
        tapi.finalize()
        fired.clear()
        tw = tapi.init({"trace_enable": "1", "trace_output": str(tmp_path / "tr"),
                        "metrics_enable": "1", "metrics_output": str(tmp_path / "m"),
                        "runtime_spc_attach": "all",
                        "monitoring_base_enable": "1",
                        "monitoring_base_output": str(tmp_path / "mon.json")},
                       device="cpu", nranks=N)
        assert ttrace.enabled() and tmetrics.enabled() and tspc.attached()
        x = rank_data((64,), 9)
        tw.allreduce(x, top.SUM)
        tw.iallreduce(x, top.SUM).wait()
        tw.allreduce_init(x, top.SUM).start().wait()
        tapi.finalize()
    finally:
        hooks.reset()
    assert fired == list(hooks.EVENTS)
    snaps = [json.loads(line) for line in (tmp_path / "m.0.jsonl").read_text().splitlines()]
    assert snaps[-1]["reason"] == "finalize"
    # monitoring has no resolver, so allreduce_init took the table path
    # and not the schedule cache; the counter schema is there all the same
    assert set(snaps[-1]["native"]) == set(tmetrics.NATIVE_COUNTERS)
    assert snaps[-1]["spc"]["allreduce"] == 1
    assert "ompi_tpu_spc_total" in (tmp_path / "m.0.prom").read_text()
    capsys.readouterr()
    assert _metrics_report().main([str(tmp_path / "m.0.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "native transport counters" in out and "request_wait_ArrayRequest" in out
    merged = jmerge.merge_files([str(tmp_path / "tr.0.json")])
    assert jmerge.collective_keys(merged, pid=0)[0] == ("MPI_COMM_WORLD", "allreduce", 0)
    mon = json.loads((tmp_path / "mon.json").read_text())
    assert mon["coll"]["MPI_COMM_WORLD:allreduce"]["calls"] == 1
