"""The port's np=2 DCN and device-plane legs, and the three joins, against the reference's.

``ompi_tpu_torch/tools/bench_dcn.py`` and ``bench_device_plane.py``
beside ``tools/bench_dcn.py`` and ``tools/bench_device_plane.py`` under
each package's launcher, one rank per process, on the CPU:

* ``DCNBENCH`` on ``btl`` tcp: the reference's keys plus ``device``, the
  same row sizes and iteration counts, the same ops and instance counts
  in ``arrival_skew.per_op``;
* ``DEVBENCH`` (``DEVBENCH_ITERS=2``) through ``bench-device-plane
  --cpu`` beside the reference worker plane on and plane off: the
  plane-on arbitration counters of both processes equal the reference's
  key for key, the plane-off leg has ``stats`` null in both, and the
  port's ``buffer`` is the world's device;
* the joins (``join_dispatch``, ``dcn``, ``join_plane``) give what
  ``bench.py``'s ``dispatch_floor_rows``, ``dcn_rows`` and
  ``device_plane_rows`` give on the same fixed worker output, and the
  counter check passes and fails where ``bench.py``'s does.
"""

import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu_torch.tools import bench_joins as bj

REPO = Path(__file__).resolve().parents[1]
PORT_TOOLS = REPO / "ompi_tpu_torch" / "tools"


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("OMPI_TPU_DEVICE", None)
    env.update(extra)
    return env


def _start(*args, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *map(str, args)], cwd=str(REPO), env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 180) -> tuple[int, str, str]:
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _ref_job(script: str, *mca, **env) -> subprocess.Popen:
    return _start("-m", "ompi_tpu", "run", "-np", 2, "--cpu-devices", 1, *mca,
                  REPO / "tools" / script, **env)


@pytest.fixture(scope="module")
def bench():
    """The reference's ``bench.py`` as a module (nothing of it runs)."""
    spec = importlib.util.spec_from_file_location("_ref_bench_np2", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- DCNBENCH ---------------------------------------------------------------------------


def test_dcnbench_equals_reference_on_tcp():
    ref = _ref_job("bench_dcn.py", "--mca", "btl", "tcp")
    port = _start("-m", "ompi_tpu_torch", "run", "-np", 2, "--nranks", 1, "--cpu",
                  "--mca", "btl", "tcp", PORT_TOOLS / "bench_dcn.py")
    rc_ref, ref_out, ref_err = _finish(ref)
    rc, out, err = _finish(port)
    assert rc_ref == 0, ref_out[-3000:] + ref_err[-3000:]
    assert rc == 0, out[-3000:] + err[-3000:]
    want, got = bj.marked(ref_out, "DCNBENCH"), bj.marked(out, "DCNBENCH")
    assert list(got) == list(want) + ["device"] and got["device"] == "cpu"
    assert got["estimator"] == want["estimator"] == "median-of-iterations"
    assert [(r["bytes"], r["iters"]) for r in got["p2p"]] == \
        [(r["bytes"], r["iters"]) for r in want["p2p"]]
    assert [list(r) for r in got["p2p"]] == [list(r) for r in want["p2p"]]
    assert [r["bytes"] for r in got["han"]] == [r["bytes"] for r in want["han"]]
    assert [list(r) for r in got["han"]] == [list(r) for r in want["han"]]
    assert all(r["p2p_us"] > 0 and r["p2p_p90_us"] >= r["p2p_us"] for r in got["p2p"])
    skew, ref_skew = got["arrival_skew"], want["arrival_skew"]
    assert list(skew) == list(ref_skew)
    assert skew["instances"] == ref_skew["instances"]
    assert {op: st["n"] for op, st in skew["per_op"].items()} == \
        {op: st["n"] for op, st in ref_skew["per_op"].items()}
    assert sorted(skew["per_proc"]) == sorted(ref_skew["per_proc"]) == ["0", "1"]
    assert got["native_counters"]["eager_msgs"] == want["native_counters"]["eager_msgs"]
    assert sorted(re.findall(r"^\[(\d)\] LAUNCHES (.*)$", out, re.M)) == \
        [(p, '{"ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": 0, "ring_hop_wait": 0}')
         for p in "01"]


# -- DEVBENCH ---------------------------------------------------------------------------


def test_devbench_equals_reference_plane_on_and_off():
    """``bench-device-plane --cpu`` (both legs and the join) beside the
    reference worker's two legs."""
    ref_on = _ref_job("bench_device_plane.py", "--mca", "btl", "tcp", DEVBENCH_ITERS="2")
    ref_off = _ref_job("bench_device_plane.py", "--mca", "btl", "tcp", "--mca",
                       "dcn_device_enable", "0", DEVBENCH_ITERS="2")
    port = _start("-m", "ompi_tpu_torch", "bench-device-plane", "--cpu", DEVBENCH_ITERS="2")
    results = [_finish(j) for j in (ref_on, ref_off, port)]
    for rc, out, err in results:
        assert rc == 0, out[-3000:] + err[-3000:]
    (_, on_out, _), (_, off_out, _), (_, out, err) = results
    # the port workers' own lines, echoed on stderr: plane on, then off
    lines = [json.loads(m) for m in re.findall(r"^\[0\] DEVBENCH (\{.*\})$", err, re.M)]
    peers = [json.loads(m) for m in re.findall(r"^\[1\] DEVBENCH_PEER (\{.*\})$", err, re.M)]
    assert len(lines) == len(peers) == 2
    for got, ref_text in zip(lines, (on_out, off_out)):
        want = bj.marked(ref_text, "DEVBENCH")
        assert list(got) == list(want) + ["device", "buffer"]
        assert got["device"] == got["buffer"] == "cpu"
        assert [r["bytes"] for r in got["rows"]] == [r["bytes"] for r in want["rows"]]
        assert (got["iters"], got["window"], got["min_size"]) == \
            (want["iters"], want["window"], want["min_size"])
    on, off = lines
    assert on["stats"] == bj.marked(on_out, "DEVBENCH")["stats"]  # key for key
    assert peers[0]["stats"] == bj.marked(on_out, "DEVBENCH_PEER")["stats"]
    assert off["stats"] is None and bj.marked(off_out, "DEVBENCH")["stats"] is None
    assert peers[1]["stats"] is None and bj.marked(off_out, "DEVBENCH_PEER")["stats"] is None
    line = bj.marked(out, "DEVBENCH_ALL")
    assert line["device_counters"] == on["stats"]
    assert line["device"] == line["buffer"] == {"device": "cpu", "host": "cpu"}
    assert line["tpu_gate"]["applied"] is False and line["tpu_gate"]["passed"] is None
    assert all("bw_vs_host" in r and "allreduce_vs_host" in r for r in line["rows"])
    assert line["launches"] == {"ring_hop": 0, "ring_hop_fold": 0,
                                "ring_hop_peer": 0, "ring_hop_wait": 0}


# -- the joins on fixed inputs ----------------------------------------------------------


class _Fake:
    """Canned worker output by (target name, np, mca), for the port's joins
    (as a ``Jobs``) and for ``bench.py``'s ``_run_tpurun``."""

    def __init__(self, canned: dict):
        self.canned = canned
        self.calls = []

    def text(self, np_, target, mca=None) -> str:
        key = (Path(target).name, np_, tuple(sorted((mca or {}).items())))
        self.calls.append(key)
        return self.canned[key]

    def __call__(self, np_, target, args=(), timeout=300, mca=None):
        return self.text(np_, target, mca)

    def c_job(self, np_, binary, args=(), timeout=300):
        return self.text(np_, binary)

    def run_tpurun(self, np_, target, args=None, timeout=300, mca=None):
        return self.text(np_, target, mca)


def _dispatch_canned(seed: int, port: bool) -> dict:
    """Fixed C and Python worker output at np 1 and 2; the port worker's
    (``port``) also has its device line and its ``LAUNCHES`` lines."""
    rng = np.random.default_rng(seed)
    canned = {}
    for np_ in (1, 2):
        rows = [{"op": op, "bytes": n} for n in (8, 64, 512, 4096)
                for op in ("allreduce", "bcast", "reduce", "allgather")] + \
            [{"op": "barrier", "bytes": 0}]
        c = {"np": np_, "iters": 2000,
             "rows": [dict(r, c_us=float(np.round(rng.uniform(0.1, 40), 3))) for r in rows],
             "persistent": {"bytes": 64, "percall_us": 4.0, "start_us": 3.0,
                            "start_speedup": 1.333}}
        py = [dict(r, py_us=float(rng.uniform(20, 900))) for r in rows[:-1]]  # no barrier twin
        py[3]["py_us"] = 0.0  # a zero time joins as no ratio
        canned[("dispatch_floor", np_, ())] = f"[0] DISPATCH {json.dumps(c)}\n"
        canned[("bench_dispatch_floor.py", np_, ())] = (
            "[0] PYDISPATCH device=cpu iters=400\n" * port
            + f"[0] PYDISPATCH {json.dumps(py)}\n"
            + '[0] LAUNCHES {"ring_hop": 0, "ring_hop_fold": 0}\n' * port)
    return canned


def test_dispatch_join_equals_bench_formulas(bench, monkeypatch):
    from ompi_tpu import native as ref_native

    fake = _Fake(_dispatch_canned(5, port=False))
    monkeypatch.setattr(bench, "_run_tpurun", fake.run_tpurun)
    monkeypatch.setattr(ref_native, "compile_mpi_program", lambda *a, **k: None)
    want = bench.dispatch_floor_rows()
    got = bj.dispatch_floor(_Fake(_dispatch_canned(5, port=True)), "dispatch_floor")
    assert list(got) == list(want) == ["np1", "np2"]
    for np_ in got:
        assert got[np_].pop("py_device") == "cpu"
        assert got[np_] == want[np_]
        assert got[np_]["rows"][3]["c_over_py"] is None and "c_over_py" not in \
            got[np_]["rows"][-1]
    assert bj.geomean([0.5, 2.0, 4.0]) == bench._geomean([0.5, 2.0, 4.0])


def _dcn_canned() -> dict:
    canned = {}
    for i, (name, mca) in enumerate(bj.BTLS):
        line = {"p2p": [{"bytes": 64, "p2p_us": 10.0 + i}], "han": [], "device": "cpu"}
        canned[("bench_dcn.py", 2, tuple(sorted((mca or {}).items())))] = \
            f"[1] LAUNCHES {{}}\n[0] DCNBENCH {json.dumps(line)}\n"
    return canned


def test_dcn_join_equals_bench_rows(bench, monkeypatch):
    fake = _Fake(_dcn_canned())
    monkeypatch.setattr(bench, "_run_tpurun", fake.run_tpurun)
    want = bench.dcn_rows()
    port = _Fake(_dcn_canned())
    assert bj.dcn(port) == want
    assert port.calls == fake.calls  # the same btls, in the same order


def _plane_legs(**dev_stats) -> tuple[dict, dict]:
    stats = {"device_sends": 38, "device_recvs": 6, "device_bytes_placed": 96468992,
             "device_arb_device": 38, "device_arb_host": 51, "device_fallbacks": 0}
    stats.update(dev_stats)
    rows = [{"bytes": n, "bw_MBs": 100.0 * (i + 1), "allreduce_us": 900.0 / (i + 1)}
            for i, n in enumerate((64 << 10, 256 << 10, 1 << 20, 4 << 20))]
    dev = {"np": 2, "iters": 12, "window": 8, "min_size": 1 << 20, "rows": rows,
           "stats": stats}
    host = {"np": 2, "iters": 12, "window": 8, "min_size": None, "stats": None,
            "rows": [dict(r, bw_MBs=r["bw_MBs"] * 1.5, allreduce_us=r["allreduce_us"] / 2)
                     for r in rows]}
    host["rows"][1]["bw_MBs"] = 0.0  # no ratio where the host row reads 0
    return dev, host


def _plane_canned(dev: dict, host: dict) -> dict:
    return {("bench_device_plane.py", 2, tuple(sorted(mca.items()))): (
        f"[0] DEVBENCH {json.dumps(line)}\n[1] DEVBENCH_PEER {json.dumps({'stats': None})}\n")
        for (_, mca), line in zip(bj.PLANE_LEGS, (dev, host))}


CASES = {
    "pass": ({}, None),
    "no_device_send": ({"device_sends": 0}, None),
    "placed_below_min_size": ({"device_bytes_placed": (1 << 20) - 1}, None),
    "no_device_arbitration": ({"device_arb_device": 0}, None),
    "no_host_arbitration": ({"device_arb_host": 0}, None),
    "host_leg_armed": ({}, {"device_sends": 0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plane_join_and_counter_check_equal_bench(bench, monkeypatch, case):
    dev_stats, host_stats = CASES[case]
    dev, host = _plane_legs(**dev_stats)
    host["stats"] = host_stats
    fake = _Fake(_plane_canned(dev, host))
    monkeypatch.setattr(bench, "_run_tpurun", fake.run_tpurun)
    port = _Fake(_plane_canned(dev, host))
    assert (bj.counter_failures(dev, host) == []) == (case == "pass")
    if case != "pass":
        with pytest.raises(RuntimeError):
            bench.device_plane_rows()
        with pytest.raises(RuntimeError):
            bj.device_plane(port)
        return
    want = bench.device_plane_rows()
    got = bj.device_plane(port)
    assert port.calls == fake.calls  # plane on, then off, with the same settings
    gate, ref_gate = got.pop("tpu_gate"), want.pop("tpu_gate")
    assert gate["criterion"] == ref_gate["criterion"] and ref_gate["skipped"]
    assert gate["applied"] is False and gate["passed"] is None and gate["reason"]
    assert {k: got[k] for k in want} == want
    assert got["rows"][1].get("bw_vs_host") is None and "allreduce_vs_host" in got["rows"][1]
    assert got["rows"][0]["bw_vs_host"] == round(100.0 / 150.0, 3)
    assert got["rows"][0]["allreduce_vs_host"] == 0.5


def test_plane_join_leaves_its_inputs_alone():
    dev, host = _plane_legs()
    before = copy.deepcopy((dev, host))
    bj.join_plane(dev, host)
    assert (dev, host) == before


# -- the shared launcher and parsers --------------------------------------------------

LAUNCH_CASES = {
    "one_per_process": ('[0] LAUNCHES {"ring_hop": 2}\n[1] LAUNCHES {"ring_hop_fold": 3}\n',
                        {"ring_hop": 2, "ring_hop_fold": 3}),
    "none": ("[0] DCNBENCH {}\n", None),
    "one_missing": ('[1] LAUNCHES {"ring_hop": 2}\n', None),
    "one_twice": ('[0] LAUNCHES {}\n[0] LAUNCHES {}\n[1] LAUNCHES {}\n', None),
}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_python_job_launches_need_one_line_from_each_process(case):
    out, want = LAUNCH_CASES[case]
    if want is None:
        with pytest.raises(RuntimeError, match="not one from each of 2"):
            bj.count_launches(out, 2)
    else:
        assert bj.count_launches(out, 2) == want


def test_marked_first_line_or_strictly_one():
    text = '[0] X {"a": 1}\nX [2]\n[1] XY {"b": 0}\nX not json\n'
    assert bj.marked(text, "X") == {"a": 1}
    assert bj.marked(text, "XY", strict=True) == {"b": 0}
    assert bj.marked(text, "Z") is None
    for marker in ("X", "Z"):
        with pytest.raises(RuntimeError, match="lines, not 1"):
            bj.marked(text, marker, strict=True)


def test_group_run_kills_the_whole_group_at_its_limit(tmp_path):
    pidfile = tmp_path / "child.pid"
    code = ("import subprocess, sys, time; "
            "c = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)']); "
            f"open({str(pidfile)!r}, 'w').write(str(c.pid)); print('up', flush=True); "
            "time.sleep(60)")
    with pytest.raises(subprocess.TimeoutExpired) as exc:
        bj.group_run([sys.executable, "-c", code], timeout=5)
    assert "up" in exc.value.output
    child = int(pidfile.read_text())
    try:  # the grandchild went with its group (a zombie until its reaper runs)
        stat = Path(f"/proc/{child}/stat").read_text()
        assert stat.rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        pass
    rc, out, err = bj.group_run([sys.executable, "-c", "import sys; print('o'); "
                                 "sys.stderr.write('e'); sys.exit(3)"], timeout=60)
    assert (rc, out, err) == (3, "o\n", "e")
