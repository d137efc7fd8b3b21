"""bench_joins — the np=2 measurement workers, launched and joined.

Usage::

    python -m ompi_tpu_torch bench-dispatch-floor [--cpu] [--iters N] [--py-iters N]
    python -m ompi_tpu_torch bench-dcn [--cpu]
    python -m ompi_tpu_torch bench-device-plane [--cpu]

Port of the reference's ``bench.py`` joins ``dispatch_floor_rows``,
``dcn_rows`` and ``device_plane_rows``.  Each launches its worker jobs
with ``python -m ompi_tpu_torch run -np N --nranks 1`` (one rank per
process, the reference's ``--cpu-devices 1``) as ``bench.py`` launches
``ompi_tpu run``, with the same btl and ``--mca`` settings, and prints
one joined line:

* ``DISPATCHFLOOR``: ``native/bench/dispatch_floor.c``, built with the
  port's ``mpicc`` into ``build/ompi_tpu_torch/bin/dispatch_floor``, then
  ``tools/bench_dispatch_floor.py``, at np 1 and np 2; each C row gains
  ``py_us`` and ``c_over_py``, each np its ``c_over_py_max`` and
  ``c_over_py_geomean`` (``bench.py``'s formulas);
* ``DCNBENCH_ALL``: ``tools/bench_dcn.py`` over ``btl`` native (the
  default), tcp and sm;
* ``DEVBENCH_ALL``: ``tools/bench_device_plane.py`` on ``btl`` tcp with
  the device plane on and off; the reference's counter check (the plane
  took large contiguous traffic, kept small and non-contiguous traffic
  on the host, and was off in the host leg) fails the command; each row
  gains ``bw_vs_host`` and ``allreduce_vs_host``.  The reference's
  TPU-only gate (device at least the host ring at ≥ 1 MiB) is recorded
  as not applied, with its reason.

Every worker runs on ``cuda:0`` unless ``--cpu`` is given; without a
card and without ``--cpu`` the first worker raises, and so does the
command, naming the missing card (the command itself never imports
torch: each worker process is the judge of the card).
Each line adds the workers' devices and ``launches``, the ring kernels'
launches summed over every process of the join (the Python workers
print theirs on a ``LAUNCHES`` line; the C ranks run with the metrics
export on, whose finalize file also says whether each brought up
CUDA).  A failed job raises with the end of its output; the workers'
output goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
TOOLS_DIR = PKG / "tools"
DISPATCH_FLOOR_C = REPO / "native" / "bench" / "dispatch_floor.c"
KERNELS = ("ring_hop", "ring_hop_fold")

#: the reference's TPU-only device-plane gate, recorded and not applied
TPU_GATE = {
    "criterion": "device >= host ring for osu_bw AND osu_allreduce at >= 1 MiB",
    "applied": False, "passed": None,
    "reason": "the reference applies it on the TPU only; on the card the plane's "
              "per-window setup outweighs its copy below 8 MiB per rank (PERF.md §5), "
              "and this bench stops at 4 MiB",
}


def marked(text: str, marker: str, strict: bool = False):
    """The JSON of the first ``<marker> {...}`` or ``<marker> [...]``
    line (a launcher's ``[p] `` prefix dropped), ``None`` if there is
    none; with ``strict``, of the one such line (raises unless there is
    exactly one)."""
    found = []
    for line in text.splitlines():
        line = re.sub(r"^\[\d+\] ", "", line)
        if line.startswith(marker + " ") and line[len(marker) + 1:][:1] in "{[":
            found.append(json.loads(line[len(marker) + 1:]))
    if strict and len(found) != 1:
        raise RuntimeError(f"{len(found)} {marker} lines, not 1")
    return found[0] if found else None


def group_run(cmd, timeout: float, env: dict | None = None) -> tuple[int, str, str]:
    """``cmd`` from the checkout in a process group of its own, with the
    checkout on ``PYTHONPATH``: its exit code, stdout and stderr.  A
    command that outlives ``timeout`` goes with every process it started
    and raises ``subprocess.TimeoutExpired`` carrying its output."""
    if env is None:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"]
                                         if env.get("PYTHONPATH") else "")
    job = subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO),
                           start_new_session=True)
    try:
        out, err = job.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(job.pid, signal.SIGKILL)
        out, err = job.communicate()
        raise subprocess.TimeoutExpired(cmd, timeout, out, err) from None
    return job.returncode, out, err


def count_launches(out: str, np_: int) -> dict:
    """The ring launches of a Python worker job: the sum of its
    ``[p] LAUNCHES {...}`` lines, which must be exactly one from each of
    its ``np_`` processes (a missing line is a number not measured)."""
    lines = re.findall(r"^\[(\d+)\] LAUNCHES (\{.*\})$", out, re.M)
    if sorted(int(p) for p, _ in lines) != list(range(np_)):
        raise RuntimeError(f"LAUNCHES lines from processes {[p for p, _ in lines]}, "
                           f"not one from each of {np_}")
    total = dict.fromkeys(KERNELS, 0)
    for _p, text in lines:
        for k, v in json.loads(text).items():
            total[k] = total.get(k, 0) + v
    return total


def geomean(ratios) -> float:
    """``bench.py``'s ``_geomean``."""
    return float(np.exp(np.mean([np.log(max(r, 1e-9)) for r in ratios])))


class Jobs:
    """Launches one join's worker jobs, each in a process group of its
    own, and sums their ring launches."""

    def __init__(self, cpu: bool):
        self.cpu = cpu
        self.launches = dict.fromkeys(KERNELS, 0)
        self.cuda_initialized: list[bool] = []

    def __call__(self, np_: int, target, args=(), timeout: float = 300,
                 mca: dict | None = None) -> str:
        """One ``run`` job's stdout; its output is echoed to stderr and, for
        a Python worker, its ``LAUNCHES`` lines counted.  Raises on a
        non-zero exit."""
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(np_), "--nranks", "1"]
        if self.cpu:
            cmd.append("--cpu")
        for k, v in (mca or {}).items():
            cmd += ["--mca", k, str(v)]
        cmd += [str(target), *map(str, args)]
        try:
            rc, out, err = group_run(cmd, timeout)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"run {Path(target).name} exceeded {timeout} s:\n"
                               f"{(e.output or '')[-2000:]}\n{(e.stderr or '')[-2000:]}"
                               ) from None
        sys.stderr.write(out + err)
        if rc != 0:
            raise RuntimeError(f"run {Path(target).name} rc={rc}:\n"
                               f"{out[-2000:]}\n{err[-2000:]}")
        if str(target).endswith(".py"):
            for k, v in count_launches(out, np_).items():
                self.launches[k] = self.launches.get(k, 0) + v
        return out

    def c_job(self, np_: int, binary, args=(), timeout: float = 300) -> str:
        """A compiled C program's job, with the metrics export on: each
        C rank's finalize file gives its launches and whether it brought
        up CUDA."""
        with tempfile.TemporaryDirectory(prefix="bench_joins_") as tmp:
            base = Path(tmp) / "c"
            out = self(np_, binary, args, timeout,
                       mca={"metrics_enable": 1, "metrics_output": base})
            for p in range(np_):
                snap = json.loads(Path(f"{base}.{p}.jsonl").read_text().splitlines()[-1])
                self.cuda_initialized.append(bool(snap["cuda_initialized"]))
                for k in KERNELS:
                    self.launches[k] += snap["kernel_launches"].get(k, 0)
        return out


# -- DISPATCHFLOOR ----------------------------------------------------------------------


def join_dispatch(c: dict, py_rows: list) -> dict:
    """One np's C ``DISPATCH`` line joined with its ``PYDISPATCH`` rows,
    as ``bench.py``'s ``dispatch_floor_rows`` joins them."""
    by_key = {(r["op"], r["bytes"]): r for r in py_rows}
    ratios = []
    for r in c["rows"]:
        pyr = by_key.get((r["op"], r["bytes"]))
        if pyr:
            r["py_us"] = pyr["py_us"]
            r["c_over_py"] = (round(r["c_us"] / pyr["py_us"], 3) if pyr["py_us"] else None)
            if r["c_over_py"] is not None:
                ratios.append(r["c_over_py"])
    return {"rows": c["rows"], "persistent": c.get("persistent"),
            "c_over_py_max": max(ratios) if ratios else None,
            "c_over_py_geomean": round(geomean(ratios), 3) if ratios else None}


def dispatch_floor(jobs, binary, iters: int = 2000, py_iters: int = 400) -> dict:
    out: dict = {}
    for np_ in (1, 2):
        text = jobs.c_job(np_, binary, [iters], timeout=600)
        c = marked(text, "DISPATCH")
        if c is None:
            raise RuntimeError(f"no DISPATCH line (np={np_}):\n{text[-2000:]}")
        text = jobs(np_, TOOLS_DIR / "bench_dispatch_floor.py", [py_iters], timeout=600)
        py_rows = marked(text, "PYDISPATCH") or []
        dev = re.search(r"^\[0\] PYDISPATCH device=(\S+) iters=\d+$", text, re.M)
        out[f"np{np_}"] = join_dispatch(c, py_rows) | {
            "py_device": dev.group(1) if dev else None}
    return out


# -- DCNBENCH_ALL -----------------------------------------------------------------------

#: ``bench.py``'s three transports: the C engine (the default btl) and
#: the Python compat planes
BTLS = (("native", None), ("tcp", {"btl": "tcp"}), ("sm", {"btl": "sm"}))


def dcn(jobs) -> dict:
    out = {}
    for name, mca in BTLS:
        text = jobs(2, TOOLS_DIR / "bench_dcn.py", mca=mca)
        line = marked(text, "DCNBENCH")
        if line is None:
            raise RuntimeError(f"no DCNBENCH line ({name}):\n{text[-2000:]}")
        out[name] = line
    return out


# -- DEVBENCH_ALL -----------------------------------------------------------------------

PLANE_LEGS = (("device", {"btl": "tcp"}),
              ("host", {"btl": "tcp", "dcn_device_enable": "0"}))


def counter_failures(dev: dict, host: dict) -> list[str]:
    """``bench.py``'s check of the plane-on leg's arbitration counters
    (large contiguous sends took the plane, small and non-contiguous
    traffic stayed host-side) and of the plane-off leg (no plane)."""
    st = dev.get("stats") or {}
    min_size = int(dev.get("min_size") or (1 << 20))
    failures = []
    if not (st.get("device_sends", 0) >= 1
            and st.get("device_bytes_placed", 0) >= min_size
            and st.get("device_arb_device", 0) >= 1
            and st.get("device_arb_host", 0) >= 1):
        failures.append(f"device-plane arbitration counters missing or wrong: {st}")
    if host.get("stats"):
        failures.append(f"host leg ran with the plane armed: {host.get('stats')}")
    return failures


def join_plane(dev: dict, host: dict) -> dict:
    """The plane-on rows beside the plane-off ones, as ``bench.py``'s
    ``device_plane_rows`` joins them (its counter check first)."""
    failures = counter_failures(dev, host)
    if failures:
        raise RuntimeError("; ".join(failures))
    host_by = {r["bytes"]: r for r in host.get("rows", [])}
    rows = []
    for r in dev.get("rows", []):
        h = host_by.get(r["bytes"], {})
        row = dict(r)
        if h.get("bw_MBs"):
            row["bw_vs_host"] = round(r["bw_MBs"] / h["bw_MBs"], 3)
        if h.get("allreduce_us") and r.get("allreduce_us"):
            row["allreduce_vs_host"] = round(h["allreduce_us"] / r["allreduce_us"], 3)
        rows.append(row)
    return {"np": 2, "min_size": int(dev.get("min_size") or (1 << 20)), "rows": rows,
            "device_counters": dev.get("stats") or {}, "tpu_gate": dict(TPU_GATE)}


def device_plane(jobs) -> dict:
    legs = {}
    for mode, mca in PLANE_LEGS:
        text = jobs(2, TOOLS_DIR / "bench_device_plane.py", mca=mca, timeout=600)
        legs[mode] = marked(text, "DEVBENCH")
        if legs[mode] is None:
            raise RuntimeError(f"no DEVBENCH line ({mode}):\n{text[-2000:]}")
    return join_plane(legs["device"], legs["host"]) | {
        "device": {m: legs[m].get("device") for m in legs},
        "buffer": {m: legs[m].get("buffer") for m in legs}}


# -- commands ---------------------------------------------------------------------------


def _start(prog: str, argv, extra=None):
    ap = argparse.ArgumentParser(prog=f"python -m ompi_tpu_torch {prog}",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run every worker on the CPU (default: cuda:0)")
    for flag, default, text in extra or ():
        ap.add_argument(flag, type=int, default=default, help=f"{text} (default: %(default)s)")
    args = ap.parse_args(argv)
    return args, Jobs(args.cpu)


def _emit(marker: str, line: dict, jobs: Jobs) -> int:
    line["launches"] = jobs.launches
    print(f"{marker} " + json.dumps(line), flush=True)
    return 0


def dispatch_floor_main(argv: list[str] | None = None) -> int:
    args, jobs = _start("bench-dispatch-floor", argv, [
        ("--iters", 2000, "calls per row of the C meter"),
        ("--py-iters", 400, "calls per row of the Python worker")])
    from ompi_tpu_torch import native

    binary = native.compile_mpi_program(DISPATCH_FLOOR_C, native.BIN_DIR / "dispatch_floor")
    line = dispatch_floor(jobs, binary, args.iters, args.py_iters)
    line["c_cuda_initialized"] = jobs.cuda_initialized
    return _emit("DISPATCHFLOOR", line, jobs)


def dcn_main(argv: list[str] | None = None) -> int:
    _args, jobs = _start("bench-dcn", argv)
    return _emit("DCNBENCH_ALL", dcn(jobs), jobs)


def device_plane_main(argv: list[str] | None = None) -> int:
    _args, jobs = _start("bench-device-plane", argv)
    return _emit("DEVBENCH_ALL", device_plane(jobs), jobs)
