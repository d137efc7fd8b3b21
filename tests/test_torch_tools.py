"""The port's report tools against the reference's ``tools/``.

* each tool's ``--selftest`` through ``python -m ompi_tpu_torch``;
* parity over ``tests/golden/``: ``metrics-report`` and ``trace-report``
  (summary, ``--merge-out``, ``--critical-path``, ``--hangs``) print what
  the reference's ``tools/metrics_report.py`` and ``tools/trace_report.py``
  print over the same files, byte for byte, and ``--merge-out`` writes
  the same merged trace; the causal fixture's critical-path rendering is
  compared in process (its input is per-process records, not a trace);
* ``top --once`` renders a fixed 2-rank frame schedule, fed to each
  package's ``TelemetryAggregator``, as the reference's ``top.py``
  renders it;
* ``metrics-report --correlate`` over an np=2 port job's exports joins
  trace spans to counter windows and prints what the reference's tool
  prints over the same files.

Lines that must differ, and why:

* ``top``'s first line carries the aggregator's URL (each package's
  aggregator listens on its own port) and the wall-clock time of the
  render: both tokens are masked, the rest of the line is compared.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
REF_TOOLS = REPO / "tools"


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    return env


def port_cli(*args, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "ompi_tpu_torch", *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, env=_env(),
                          cwd=str(REPO))


def ref_cli(tool: str, *args, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(REF_TOOLS / f"{tool}.py"), *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, env=_env(),
                          cwd=str(REPO))


def both(port_args, tool, ref_args=None):
    """The port's CLI and the reference's tool over the same arguments:
    both must exit 0; returns (port stdout, reference stdout)."""
    p = port_cli(*port_args)
    r = ref_cli(tool, *(port_args[1:] if ref_args is None else ref_args))
    assert p.returncode == 0, p.stdout + p.stderr
    assert r.returncode == 0, r.stdout + r.stderr
    return p.stdout, r.stdout


# -- selftests -------------------------------------------------------------


@pytest.mark.parametrize("tool", ["metrics-report", "trace-report", "top"])
def test_tool_selftest(tool):
    res = port_cli(tool, "--selftest")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "selftest OK" in res.stdout


def test_tools_run_as_modules_too():
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.trace_report",
                          str(GOLDEN / "trace_fixture.json")], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout == port_cli("trace-report", GOLDEN / "trace_fixture.json").stdout


# -- parity over the golden fixtures --------------------------------------


def test_metrics_report_golden_fixture_byte_for_byte():
    port, ref = both(["metrics-report", GOLDEN / "metrics_fixture.jsonl"], "metrics_report")
    assert port == ref
    assert "stall-cause breakdown" in port and "rendezvous CTS wait" in port
    assert "recv_timeout" in port and "watermark" in port


@pytest.mark.parametrize("flags", [[], ["--top", "3"], ["--critical-path"]],
                         ids=["summary", "top3", "critical-path"])
def test_trace_report_golden_fixture_byte_for_byte(flags):
    port, ref = both(["trace-report", GOLDEN / "trace_fixture.json", *flags], "trace_report")
    assert port == ref
    assert "allreduce" in port and "p99" in port


def test_trace_report_merge_out_byte_for_byte(tmp_path):
    """Both tools write the merged trace to the same path in turn: the
    report text (which names the path) and the merged file are equal."""
    from ompi_tpu.trace import merge

    out = tmp_path / "merged.json"
    args = ["trace-report", GOLDEN / "trace_fixture.json", "--merge-out", out]
    port = port_cli(*args)
    port_doc = out.read_bytes()
    out.unlink()
    ref = ref_cli("trace_report", *args[1:])
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert port_doc == out.read_bytes()
    doc = json.loads(port_doc)
    assert doc["otherData"]["merged_processes"] == [0, 1]
    assert merge.collective_keys(doc, pid=0) == merge.collective_keys(doc, pid=1) != []


@pytest.mark.parametrize("case", ["deadlock", "straggler"])
def test_trace_report_hangs_byte_for_byte(tmp_path, case):
    """``--hangs`` over per-rank JSONL exports made from the golden
    wait-graph fixture's blocked-state snapshots."""
    doc = json.loads((GOLDEN / "waitgraph_fixture.json").read_text())["cases"][case]
    paths = []
    for rank, snap in sorted(doc["snaps_by_rank"].items()):
        p = tmp_path / f"m.{rank}.jsonl"
        p.write_text(json.dumps({"proc": int(rank), "ts_ns": snap["ts_ns"],
                                 "waits": snap["waits"],
                                 "failed": doc.get("failed") or []}) + "\n")
        paths.append(p)
    port, ref = both(["trace-report", *paths, "--hangs"], "trace_report")
    assert port == ref
    assert f"verdict: {doc['expect']['kind']}" in port


def test_critical_path_rendering_matches_on_the_causal_fixture():
    import importlib.util
    import io

    from ompi_tpu.trace import causal as rcausal
    from ompi_tpu_torch.tools import trace_report as port_tr
    from ompi_tpu_torch.trace import causal as pcausal

    spec = importlib.util.spec_from_file_location("ref_trace_report",
                                                  REF_TOOLS / "trace_report.py")
    ref_tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tr)
    doc = json.loads((GOLDEN / "causal_fixture.json").read_text())
    records = {int(p): rows for p, rows in doc["records_by_proc"].items()}
    texts = []
    for tr, causal in ((port_tr, pcausal), (ref_tr, rcausal)):
        buf = io.StringIO()
        tr.render_critical(causal.profile_from_records(records), top=5, out=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert f"cause={doc['expect']['cause']}" in texts[0]


# -- top ---------------------------------------------------------------------


def _frames():
    """A fixed 2-rank schedule: three rounds, rank 1 25 ms late at every
    collective, rank 0's plane demoted and promoted once (numpy-seeded
    counters)."""
    rng = np.random.default_rng(20261017)
    base = 1_700_000_000_000_000_000
    out = []
    for rnd in range(3):
        for proc in (0, 1):
            native = {"eager_bytes": int(rng.integers(1, 1 << 20)) * (rnd + 1),
                      "eager_msgs": 100 * (rnd + 1), "delivered": 50 * (rnd + 1),
                      "stall_ns": 5_000_000 * (rnd + 1),
                      "ring_stall_ns": 3_000_000 * (rnd + 1),
                      "cts_wait_ns": 1_000_000 * (rnd + 1),
                      "device_bytes_placed": int(rng.integers(1, 1 << 20)),
                      "device_dma_wait_ns": 2_000_000 * (rnd + 1)}
            if proc == 0:
                native.update(plane_demotions=1, plane_promotions=1, plane_heal_probes=1)
            late = 25_000_000 if proc == 1 else 0
            colls = [[f"MPI_COMM_WORLD/allreduce/{rnd * 4 + i}",
                      base + (rnd * 4 + i) * 50_000_000 + late,
                      base + (rnd * 4 + i) * 50_000_000 + late + 1_000_000]
                     for i in range(4)]
            out.append({"proc": proc, "nprocs": 2, "ts_ns": base + rnd * 500_000_000,
                        "native": native,
                        "straggler": {"allreduce": {"count": 4 * (rnd + 1),
                                                    "wait_ns": 30_000_000 * (rnd + 1),
                                                    "max_wait_ns": 9_000_000,
                                                    "provider": "han"}},
                        "colls": colls, "failed": []})
    return out


def test_top_once_renders_like_the_reference():
    from ompi_tpu.metrics.live import TelemetryAggregator as RefAgg
    from ompi_tpu_torch.metrics.live import TelemetryAggregator as PortAgg

    aggs = [PortAgg(http_port=0, history=16), RefAgg(http_port=0, history=16)]
    try:
        for agg in aggs:
            for frame in _frames():
                agg.ingest(json.loads(json.dumps(frame)))
        port = port_cli("top", "--url", aggs[0].url, "--once")
        ref = ref_cli("top", "--url", aggs[1].url, "--once")
    finally:
        for agg in aggs:
            agg.close()
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr

    def masked(text, url):
        head, _, rest = text.partition("\n")
        head = re.sub(r"\d\d:\d\d:\d\d$", "HH:MM:SS", head.replace(url, "URL"))
        return head + "\n" + rest

    assert masked(port.stdout, aggs[0].url) == masked(ref.stdout, aggs[1].url)
    rows = [ln for ln in port.stdout.splitlines() if re.match(r"^[01] ", ln)]
    assert len(rows) == 2 and "1v1^" in rows[0]
    assert "top stragglers" in port.stdout and "rank 1" in port.stdout


# -- --correlate over a port job's exports -------------------------------------


CORRELATE_JOB = """
import torch
import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM
w = api.init()
for i in range(6):
    out = w.allreduce(torch.full((1, 2048), i + 1.0, dtype=torch.float64), SUM)
    assert bool((out == 2 * (i + 1.0)).all())
w.barrier()
api.finalize()
"""


def test_metrics_report_correlate_over_an_np2_port_job(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(CORRELATE_JOB)
    m, t = tmp_path / "m", tmp_path / "t"
    res = port_cli("run", "-np", 2, "--nranks", 1, "--cpu", "--mca", "btl", "tcp",
                   "--mca", "metrics_enable", 1, "--mca", "metrics_output", m,
                   "--mca", "trace_enable", 1, "--mca", "trace_output", t, script,
                   timeout=150)
    assert res.returncode == 0, res.stdout + res.stderr
    jsonl = [tmp_path / f"m.{p}.jsonl" for p in (0, 1)]
    traces = [tmp_path / f"t.{p}.json" for p in (0, 1)]
    port, ref = both(["metrics-report", *jsonl, "--correlate", *traces], "metrics_report")
    assert port == ref
    joined = re.findall(r"Δstall [^,]+, (\d+) trace span\(s\) in window", port)
    assert len(joined) >= 2 and any(int(n) > 0 for n in joined), port
    assert "api/allreduce" in port


def test_report_tools_never_initialise_cuda(tmp_path):
    """The reports read files only: after one, CUDA is not initialized
    (checked here on the CPU build as on the card)."""
    code = ("import sys, torch\n"
            "from ompi_tpu_torch.__main__ import main\n"
            f"sys.argv = ['x', 'metrics-report', {str(GOLDEN / 'metrics_fixture.jsonl')!r}]\n"
            "rc = main()\n"
            f"sys.argv = ['x', 'trace-report', {str(GOLDEN / 'trace_fixture.json')!r}]\n"
            "rc |= main()\n"
            "print('CUDA_INITIALIZED', torch.cuda.is_initialized())\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=_env(), cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    assert "CUDA_INITIALIZED False" in res.stdout


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
