"""The port's dispatch-floor leg against the reference's, on the CPU.

``ompi_tpu_torch/tools/bench_dispatch_floor.py`` beside
``tools/bench_dispatch_floor.py``, and ``native/bench/dispatch_floor.c``
built with the port's ``mpicc``, at 10 calls per row:

* ``bench-dispatch-floor --cpu`` runs the C meter and the Python worker
  at np 1 and np 2 (one rank per process): every C line has the 17 rows
  the C source defines and its ``persistent`` block, every row is joined
  with its Python twin, and the port worker's ``PYDISPATCH`` rows at
  np 2 are the reference worker's, in order;
* the worker's exact answers (``expected``) equal a rank-by-rank loop,
  and its check (``matches``) fails a result one ulp off;
* without a card and without ``--cpu`` each join command and each np=2
  worker raises, and prints no marker line.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ompi_tpu_torch.tools import bench_dispatch_floor as bdf
from ompi_tpu_torch.tools import bench_joins as bj

REPO = Path(__file__).resolve().parents[1]
C_SOURCE = REPO / "native" / "bench" / "dispatch_floor.c"
PORT_TOOLS = REPO / "ompi_tpu_torch" / "tools"


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("OMPI_TPU_DEVICE", None)
    return env


def _start(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *map(str, args)], cwd=str(REPO), env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 180) -> tuple[int, str, str]:
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _c_rows() -> list[tuple[str, int]]:
    """The ``(op, bytes)`` rows ``dispatch_floor.c`` prints, read from its
    source: each size of ``SIZES`` in the order of its four ``ROW``
    calls, then the barrier."""
    src = C_SOURCE.read_text()
    sizes = [int(s) for s in re.search(r"SIZES\[\] = \{([^}]*)\}", src).group(1).split(",")]
    ops = re.findall(r'ROW\("(\w+)", SIZES\[s\]', src)
    assert re.search(r'ROW\("barrier", 0,', src)
    return [(op, n) for n in sizes for op in ops] + [("barrier", 0)]


def test_dispatch_join_on_the_cpu():
    """``bench-dispatch-floor --cpu`` beside the reference worker at np 2:
    17 C rows per np with ``persistent``, every row joined, the port
    worker's rows the reference's, no launch, no CUDA."""
    ref = _start("-m", "ompi_tpu", "run", "-np", 2, "--cpu-devices", 1,
                 REPO / "tools" / "bench_dispatch_floor.py", 10)
    port = _start("-m", "ompi_tpu_torch", "bench-dispatch-floor", "--cpu", "--iters", 10,
                  "--py-iters", 10)
    rc_ref, ref_out, ref_err = _finish(ref)
    rc, out, err = _finish(port, timeout=300)
    assert rc_ref == 0, ref_out[-3000:] + ref_err[-3000:]
    assert rc == 0, out[-3000:] + err[-3000:]
    line = bj.marked(out, "DISPATCHFLOOR")
    assert list(line) == ["np1", "np2", "c_cuda_initialized", "launches"]
    want_rows = _c_rows()
    assert len(want_rows) == 17
    for np_ in ("np1", "np2"):
        leg = line[np_]
        assert list(leg) == ["rows", "persistent", "c_over_py_max", "c_over_py_geomean",
                             "py_device"]
        assert [(r["op"], r["bytes"]) for r in leg["rows"]] == want_rows
        assert all(list(r) == ["op", "bytes", "c_us", "py_us", "c_over_py"]
                   for r in leg["rows"])
        assert all(r["c_over_py"] == round(r["c_us"] / r["py_us"], 3) for r in leg["rows"])
        assert leg["c_over_py_max"] == max(r["c_over_py"] for r in leg["rows"])
        assert leg["persistent"]["bytes"] == 64
        assert list(leg["persistent"]) == ["bytes", "percall_us", "start_us", "start_speedup"]
        assert leg["py_device"] == "cpu"
    assert line["c_cuda_initialized"] == [False] * 3  # one C rank at np 1, two at np 2
    assert line["launches"] == {"ring_hop": 0, "ring_hop_fold": 0,
                                "ring_hop_peer": 0, "ring_hop_wait": 0}
    # the workers' own lines, echoed on stderr: np 1's, then np 2's
    assert re.findall(r"^\[0\] PYDISPATCH device=(\S+) iters=(\d+)$", err, re.M) == \
        [("cpu", "10")] * 2
    port_np2 = [json.loads(m) for m in re.findall(r"^\[0\] PYDISPATCH (\[.*\])$", err, re.M)][1]
    want = bj.marked(ref_out, "PYDISPATCH")
    assert [(r["op"], r["bytes"]) for r in port_np2] == [(r["op"], r["bytes"]) for r in want]
    assert [list(r) for r in port_np2] == [list(r) for r in want]
    assert [(r["op"], r["bytes"]) for r in want] == want_rows
    assert all(r["py_us"] > 0 for r in port_np2)


def _world(nprocs: int, ranks_per_proc: int, proc: int):
    offsets = [p * ranks_per_proc for p in range(nprocs + 1)]
    return SimpleNamespace(nprocs=nprocs, proc=proc, local_size=ranks_per_proc,
                           size=offsets[-1], offsets=offsets,
                           locate=lambda r: (r // ranks_per_proc, r % ranks_per_proc))


@pytest.mark.parametrize("nprocs,ranks_per_proc", [(1, 1), (2, 1), (2, 3)])
def test_expected_answers_rank_by_rank(nprocs, ranks_per_proc):
    """``expected`` against a rank-by-rank loop: global rank r holds
    ``proc_of(r) + 1``; every local rank of every process gets the sum,
    rank 0's value, and all the values in rank order; only rank 0's
    process gets the reduce."""
    count = 3
    size = nprocs * ranks_per_proc
    vals = [float(r // ranks_per_proc + 1) for r in range(size)]
    for proc in range(nprocs):
        got = bdf.expected(_world(nprocs, ranks_per_proc, proc), count)
        for k in range(ranks_per_proc):
            assert all(v == sum(vals) for v in got["allreduce"][k])
            assert all(v == vals[0] for v in got["bcast"][k])
            for r in range(size):
                assert all(v == vals[r] for v in got["allgather"][k][r])
        assert got["allreduce"].dtype == got["bcast"].dtype == np.float32
        assert got["allgather"].shape == (ranks_per_proc, size, count)
        if proc == 0:
            assert got["reduce"] is got["allreduce"]
        else:
            assert got["reduce"] is None


def test_exact_check_catches_a_wrong_result():
    want = bdf.expected(_world(2, 1, 0), 4)
    assert bdf.matches(np.full((1, 4), 3.0, np.float32), want["allreduce"])
    off = np.full((1, 4), 3.0, np.float32)
    off[0, 2] = np.nextafter(np.float32(3.0), np.float32(4.0))
    assert not bdf.matches(off, want["allreduce"])
    assert not bdf.matches(None, want["allreduce"])
    assert not bdf.matches(want["allreduce"], None)
    assert bdf.matches(None, None)


# -- no card, no --cpu ------------------------------------------------------------------


def test_each_join_and_worker_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the joins and workers run on it")
    joins = [_start("-m", "ompi_tpu_torch", cmd)
             for cmd in ("bench-dispatch-floor", "bench-dcn", "bench-device-plane")]
    jobs = [_start("-m", "ompi_tpu_torch", "run", "-np", 2, "--nranks", 1, PORT_TOOLS / name)
            for name in ("bench_dispatch_floor.py", "bench_dcn.py", "bench_device_plane.py")]
    for job, marker in zip(jobs, ("PYDISPATCH", "DCNBENCH", "DEVBENCH")):
        rc, out, err = _finish(job)
        assert rc != 0 and "no CUDA device" in out + err
        assert f"{marker} " not in out and "LAUNCHES" not in out
    for join, marker in zip(joins, ("DISPATCHFLOOR", "DCNBENCH_ALL", "DEVBENCH_ALL")):
        rc, out, err = _finish(join)
        assert rc != 0 and "no CUDA device" in err and "RuntimeError" in err
        assert marker not in out and out.strip() == ""
