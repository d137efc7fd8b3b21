"""The port's crash-path export and flight watermarks against the
reference's, after the crash cases of ``tests/test_telemetry.py``.

* ``export.crash_dump`` writes the configured metrics files marked
  ``partial: true`` (reason ``crash``, a ``crash_export`` flight record
  first), latches once, and re-arms with ``reset_crash_latch``; with
  tracing on it writes the Chrome trace marked partial too;
* the trace merge keeps a rank that crash-dumped with no events in
  ``partial_processes``, as the reference's does;
* ``flight.check_watermarks`` latches each stall threshold once, with
  the reference's records on the same counter values;
* an np=2 port job whose peer dies mid-collective: the surviving process
  leaves ``partial`` metrics and trace files (through the deadline or
  peer escalation, or the exit hook, whichever fires first).
"""

import json
from pathlib import Path

import pytest

from ompi_tpu.metrics import core as rmcore
from ompi_tpu.metrics import flight as rflight
from ompi_tpu_torch.core import mca as pmca
from ompi_tpu_torch.metrics import core as pmcore
from ompi_tpu_torch.metrics import export as pexport
from ompi_tpu_torch.metrics import flight as pflight
from ompi_tpu_torch.trace import chrome as pchrome
from ompi_tpu_torch.trace import core as ptrace
from ompi_tpu_torch.trace import merge as pmerge
from torch_mp_common import run_job


@pytest.fixture(autouse=True)
def _clean():
    for m, f in ((rmcore, rflight), (pmcore, pflight)):
        m.reset(full=False)
        m.enable(False)
        f.reset()
    ptrace.reset()
    ptrace.enable(False)
    pexport.reset_crash_latch()
    yield
    for m, f in ((rmcore, rflight), (pmcore, pflight)):
        m.reset(full=False)
        m.enable(False)
        f.reset()
    ptrace.reset()
    ptrace.enable(False)
    pexport.reset_crash_latch()


@pytest.fixture
def store():
    st = pmca.default_context().store
    old = (st.get("metrics_output", ""), st.get("trace_output", ""))
    yield st
    st.set("metrics_output", old[0])
    st.set("trace_output", old[1])


def test_crash_dump_writes_partial_and_latches(tmp_path, store):
    pmcore.enable(True)
    pmcore.observe("dcn_p2p_send", 4096, 1000)
    store.set("metrics_output", str(tmp_path / "m"))
    paths = pexport.crash_dump("unit")
    assert paths, "crash_dump wrote nothing"
    lines = [json.loads(ln) for ln in Path(f"{tmp_path}/m.0.jsonl").read_text().splitlines()]
    final = lines[-1]
    assert final["partial"] is True and final["reason"] == "crash"
    assert "crash_export" in [ln.get("reason") for ln in lines]
    assert Path(f"{tmp_path}/m.0.prom").exists()
    assert pexport.crash_dump("again") == []          # once-latch
    pexport.reset_crash_latch()
    assert pexport.crash_dump("rearmed") != []


def test_crash_dump_without_outputs_keeps_the_latch_armed(tmp_path, store):
    store.set("metrics_output", "")
    assert pexport.crash_dump("nothing") == []        # nothing configured
    pmcore.enable(True)
    store.set("metrics_output", str(tmp_path / "m"))
    assert pexport.crash_dump("now") != []


def test_crash_dump_writes_partial_trace(tmp_path, store):
    ptrace.enable(True)
    store.set("trace_output", str(tmp_path / "tr"))
    paths = pexport.crash_dump("unit")
    assert paths == [f"{tmp_path}/tr.0.json"]
    doc = json.loads(Path(paths[0]).read_text())
    assert doc["otherData"]["partial"] is True and doc["otherData"]["pid"] == 0
    full = pchrome.dump(str(tmp_path / "full.json"))
    assert "partial" not in json.loads(Path(full).read_text())["otherData"]


def test_merge_partial_marker_survives_empty_crash_dump():
    full = {"traceEvents": [{"ph": "X", "name": "a", "cat": "api",
                             "pid": 0, "tid": 0, "ts": 1.0, "dur": 1.0}],
            "otherData": {"pid": 0}}
    empty_partial = {"traceEvents": [], "otherData": {"pid": 1, "partial": True}}
    merged = pmerge.merge_chrome([full, empty_partial])
    assert merged["otherData"]["partial_processes"] == [1]


class _Stalls:
    """A counter provider with the values a stalled native send shows."""

    def __init__(self, **vals):
        self.vals = vals

    def snap(self):
        return dict(self.vals)


def test_check_watermarks_latch_once_like_the_reference():
    records = {}
    for name, core, flight in (("ref", rmcore, rflight), ("port", pmcore, pflight)):
        core.enable(True)
        src = _Stalls(stall_ns=2_000_000, slot_waits=1)
        core.register_provider(src, src.snap)
        flight.check_watermarks()                      # off-cadence: no check
        assert flight.records() == []
        flight.check_watermarks(force=True)
        flight.check_watermarks(force=True)            # latched: no repeat
        src.vals["stall_ns"] = 2_000_000_000
        flight.check_watermarks(force=True)
        records[name] = [r["detail"] for r in flight.records()]
        core.enable(False)
        del src
    assert records["port"] == records["ref"] == [
        {"counter": "stall_ns", "level": 1_000_000, "value": 2_000_000},
        {"counter": "slot_waits", "level": 1, "value": 1},
        {"counter": "stall_ns", "level": 1_000_000_000, "value": 2_000_000_000}]


CRASH_JOB = r'''
import os
import sys
import time
import numpy as np
import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM
w = api.init(device="cpu")
w.barrier()
if w.proc == 1:
    os._exit(3)                 # the peer dies: no finalize, no exit hooks
time.sleep(0.5)
w.allreduce(np.ones((1, 1 << 16)), SUM)   # waits on the dead peer and raises
print("UNREACHABLE", flush=True)
'''


def test_np2_job_whose_peer_dies_leaves_partial_files(tmp_path):
    script = tmp_path / "crash.py"
    script.write_text(CRASH_JOB)
    mout, tout = tmp_path / "m", tmp_path / "tr"
    res = run_job("port", 2, 1, script, timeout=120, flags=["--ft"], mca={
        "metrics_enable": "1", "metrics_output": str(mout),
        "trace_enable": "1", "trace_output": str(tout), "dcn_recv_timeout": "5"})
    assert "UNREACHABLE" not in res.stdout
    assert res.returncode != 0, res.stdout + res.stderr
    lines = [json.loads(ln) for ln in Path(f"{mout}.0.jsonl").read_text().splitlines()]
    assert lines[-1]["partial"] is True and lines[-1]["reason"] == "crash", lines[-1]
    causes = [ln["detail"]["cause"] for ln in lines if ln.get("reason") == "crash_export"]
    assert len(causes) == 1, causes
    assert Path(f"{mout}.0.prom").exists()
    doc = json.loads(Path(f"{tout}.0.json").read_text())
    assert doc["otherData"]["partial"] is True
    assert not Path(f"{mout}.1.jsonl").exists()       # the dead process wrote nothing
