"""bench — the framework against a raw torch primitive, OSU-style.

Usage::

    python -m ompi_tpu_torch bench [--cpu] [--check] [--max-bytes N]
        [--suite-max N] [--step K] [--iters N] [--no-subproc] [--detail]
        [--serve-runs N] [--lanes K] [--out PATH]

Port of the reference's ``bench.py``.  ``run()`` starts ``api.init()``
(8 ranks as the rows of one tensor on ``cuda:0``; ``--cpu``: on the CPU;
without a card and without ``--cpu`` it raises) and times, with the
reference's estimators (``_times``, ``_times_paired``: the host clock
around each call and a ``torch.cuda.synchronize()`` after it, the order
alternating within each pair):

* ``osu_allreduce``: f32 SUM from 8 B to ``--max-bytes`` per rank (1 GiB
  on the card, 4 MiB with ``--cpu``) in ``--step`` steps, the ceiling
  appended, each size's ``COMM_WORLD.allreduce`` paired with its raw
  primitive on the same tensor; the headline is the geomean of the
  per-pair raw/framework ratios;
* the blocking suite (``bcast``, ``allgather``, ``reduce_scatter_block``,
  ``alltoall``) from 64 B to ``--suite-max`` in ×32 steps against theirs;
* ``barrier``, the persistent ``allreduce_init``/``start().wait()`` row,
  ``gather``/``scatter``, the non-blocking overlap row
  (``bench_hostpath.measure_overlap`` at 4 MiB per rank) and, last, the
  numpy host-path rows with the arena's deltas.

The raw side is the reference's ``jit(shard_map(lax.<collective>))``;
the port has no such layer, so each raw primitive is one torch
expression over the rank-major tensor that computes the same function
(:data:`RAW`, named in the detail file's ``raw``).  Inputs to 16 MiB per
rank are the reference's seeded numpy draws; above that they are drawn
on the world's device from a seeded ``torch.Generator`` (each row says
which in ``input``).  Every row keeps the reference's keys and adds the
quartiles (``fw_us_p25`` … ``raw_us_p75``), ``input`` and the ring
kernels' ``launches`` during the row.

Unless ``--no-subproc``, the reference's nine joins follow in its order,
every job on ``cuda:0`` unless ``--cpu``, one rank per process
(``run -np N --nranks 1``): ``dcn``, ``capi`` (``osu_allreduce.c`` at
np 1 against ``tools/bench_pyapi.py``), ``capi_p2p`` (``osu_latency.c``,
``osu_bw.c`` at np 2), ``osu_bw_sweep`` (``osu_bw_sweep.c``),
``dispatch_floor``, ``device_plane``, ``algos_cpu8`` (``bench-algos``),
``hostpath_cpu8`` (``bench-hostpath``) and ``serve`` (a cold ``run -np 2``
against warm submissions to ``tpud -np 2`` of
``examples/serve_firstcoll.py``, both on ``btl`` tcp); ``--lanes K`` runs
the joins before ``serve`` K at a time (their rows then share the host),
``serve`` always alone.  The C programs
build with the port's ``mpicc`` into ``build/ompi_tpu_torch/bin/``; each C
rank runs with the metrics export on, which says whether it brought up
CUDA.  A failed join becomes ``{"error": ...}``, as in the reference.

The detail goes to ``build/ompi_tpu_torch/BENCH_DETAIL.json`` (``--out``);
the last stdout line is the reference's compact headline plus
``device``.  ``--check`` holds every timed framework result against its
raw primitive (``bcast``, ``allgather`` and ``alltoall`` bit for bit;
``allreduce`` and ``reduce_scatter`` within twice the rounding bound of
an 8-term f32 sum in any order) and each host-path row against the
numpy sum, runs the algos and hostpath joins in their ``--check`` form,
and exits 1 if a comparison fails or a join holds an error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ompi_tpu_torch.tools import bench_joins as bj
from ompi_tpu_torch.tools.bench_hostpath import SUM_ULPS, measure_overlap, sum_error

REPO = bj.REPO
TOOLS_DIR = bj.TOOLS_DIR
EXAMPLES_DIR = bj.PKG / "examples"
C_BENCH = REPO / "native" / "bench"
DETAIL_FILE = REPO / "build" / "ompi_tpu_torch" / "BENCH_DETAIL.json"
METRIC = "osu_allreduce_latency_ratio_vs_raw_psum"
#: per-rank sizes up to this are the reference's numpy draws; larger ones
#: are drawn on the world's device
HOST_RNG_MAX = 16 << 20
SUITE = ("bcast", "allgather", "reduce_scatter", "alltoall")
#: results compared bit for bit with their raw primitive (the rest are sums)
EXACT = ("bcast", "allgather", "alltoall")

#: the raw primitive of each collective: one torch expression over the
#: rank-major ``x`` ((n, count); reduce_scatter and alltoall (n, n, c))
#: with the function of the reference's raw ``shard_map`` program
RAW = {
    "allreduce": ("x.sum(0, keepdim=True).expand_as(x).contiguous()",
                  lambda x: x.sum(0, keepdim=True).expand_as(x).contiguous()),
    "bcast": ("x[:1].expand_as(x).contiguous()",
              lambda x: x[:1].expand_as(x).contiguous()),
    "allgather": ("x.reshape(1, -1).expand(n, -1).contiguous()",
                  lambda x: x.reshape(1, -1).expand(x.shape[0], -1).contiguous()),
    "reduce_scatter": ("x.sum(0).unsqueeze(1)", lambda x: x.sum(0).unsqueeze(1)),
    "alltoall": ("x.transpose(0, 1).reshape(n, -1)",
                 lambda x: x.transpose(0, 1).reshape(x.shape[0], -1)),
}


def _nosync() -> None:
    pass


def _times(fn, warmup: int, iters: int, sync=_nosync) -> list[float]:
    """The reference's ``_times``, ``sync()`` after each call."""
    for _ in range(warmup):
        fn()
        sync()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def _times_paired(fa, fb, warmup: int, iters: int, sync=_nosync):
    """The reference's interleaved timing of two callables: the order
    within each pair alternates, so no first-position cost is charged to
    one side; ``sync()`` after each call."""
    for _ in range(warmup):
        fa()
        sync()
        fb()
        sync()
    ta, tb = [], []
    for i in range(iters):
        first, second = (fa, fb) if i % 2 == 0 else (fb, fa)
        t0 = time.perf_counter()
        first()
        sync()
        t1 = time.perf_counter()
        second()
        sync()
        t2 = time.perf_counter()
        if i % 2 == 0:
            ta.append(t1 - t0)
            tb.append(t2 - t1)
        else:
            tb.append(t1 - t0)
            ta.append(t2 - t1)
    return ta, tb


def _iters_for(nbytes: int, iters: int) -> tuple[int, int]:
    """(warmup, iters): the reference's sample floors."""
    if nbytes >= 256 << 20:
        return 3, max(64, iters)
    if nbytes >= 8 << 20:
        return 4, max(40, iters)
    if nbytes <= 1 << 20:
        return 8, max(96, iters * 2)
    return 6, max(64, iters)


#: OSU bus-bandwidth factors by collective (the reference's)
_BUS_FACTOR = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "alltoall": lambda n: (n - 1) / n,
    "bcast": lambda n: 1.0,
}


def _row(nbytes: int, n: int, t_fw: list[float], t_raw: list[float],
         coll: str = "allreduce") -> dict:
    """The reference's row (``ratio``: the median of the per-pair raw/fw
    ratios) plus the quartiles of both sides."""
    fw_min, raw_min = min(t_fw), min(t_raw)
    fw_p50 = float(np.median(t_fw))
    raw_p50 = float(np.median(t_raw))
    alg = nbytes / fw_min / 1e9 if fw_min > 0 else 0.0
    pairs = [b / a for a, b in zip(t_fw, t_raw) if a > 0]
    pair = float(np.median(pairs)) if pairs else 0.0
    row = {
        "bytes": nbytes,
        "iters": len(t_fw),
        "fw_us_min": round(fw_min * 1e6, 2),
        "fw_us_p50": round(fw_p50 * 1e6, 2),
        "raw_us_min": round(raw_min * 1e6, 2),
        "raw_us_p50": round(raw_p50 * 1e6, 2),
        "fw_GBs": round(alg, 3),
        "ratio": round(pair, 4),
        "ratio_min": round(raw_min / fw_min, 4) if fw_min > 0 else 0.0,
    }
    if n > 1:  # bus bandwidth is a fabric concept; meaningless at n=1
        row["fw_busGBs"] = round(_BUS_FACTOR[coll](n) * alg, 3)
    for side, t in (("fw", t_fw), ("raw", t_raw)):
        p25, p75 = np.percentile(t, [25, 75])
        row[f"{side}_us_p25"] = round(float(p25) * 1e6, 2)
        row[f"{side}_us_p75"] = round(float(p75) * 1e6, 2)
    return row


def sweep_sizes(max_bytes: int, step: int) -> list[int]:
    """8 B up in ``step`` steps, the ceiling appended (the reference's)."""
    sizes, nbytes = [], 8
    while nbytes <= max_bytes:
        sizes.append(nbytes)
        nbytes *= step
    if sizes and sizes[-1] < max_bytes:
        sizes.append(max_bytes)
    return sizes


def suite_sizes(suite_max: int) -> list[int]:
    """64 B up in ×32 steps (the reference's)."""
    sizes, nbytes = [], 64
    while nbytes <= suite_max:
        sizes.append(nbytes)
        nbytes *= 32
    return sizes


def compare(coll: str, nbytes: int, got, want, x) -> dict:
    """A framework result against its raw primitive on the same input:
    bit for bit for the copies; for the two sums, every element within
    twice the rounding bound of an 8-term f32 sum in any order
    (``2 · SUM_ULPS · Σ|x|`` over the ranks), row by row."""
    got = got.reshape(want.shape)
    if coll in EXACT:
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().max()) if got.numel() else 0.0
        return {"coll": coll, "bytes": nbytes, "exact": True, "max_abs_err": err, "ok": bool(ok)}
    bound = (2 * SUM_ULPS * torch.linalg.vector_norm(x, 1, dim=0)
             + torch.finfo(torch.float32).tiny).reshape((-1,) + tuple(want.shape[1:]))
    err = ratio = 0.0
    for r in range(want.shape[0]):
        d = (got[r] - want[r]).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / bound[min(r, bound.shape[0] - 1)]).max()))
    return {"coll": coll, "bytes": nbytes, "exact": False, "max_abs_err": err,
            "err_over_bound": ratio, "ok": ratio <= 1.0}


def run(max_bytes: int, iters: int, suite_max: int, step: int, device: str = "cuda",
        checks: list | None = None) -> dict:
    """The reference's ``run()`` on the port; with ``checks`` a list, each
    timed collective's result is compared with its raw primitive's and
    each host-path row with the numpy sum, one entry appended per row."""
    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.op import SUM

    world = api.init(device=device)
    n = world.size
    dev = world.mesh.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else _nosync
    raw = {k: fn for k, (_text, fn) in RAW.items()}

    def staged(shape, seed: int, nbytes: int):
        """The row's input and its origin: the reference's numpy draw to
        HOST_RNG_MAX per rank, a seeded draw on the device above."""
        if nbytes <= HOST_RNG_MAX:
            host = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
            return world.mesh.stage_in(host), f"numpy default_rng({seed}).standard_normal"
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32),
                f"torch.Generator({dev}).manual_seed({seed}) randn")

    def free():
        if cuda:
            torch.cuda.empty_cache()

    def timed_row(name, nbytes, fw, x, w, it, origin) -> dict:
        before = dict(ck.LAUNCHES)
        t_fw, t_raw = _times_paired(fw, lambda: raw[name](x), w, it, sync)
        row = _row(nbytes, n, t_fw, t_raw, coll=name)
        if checks is not None:
            got, want = fw(), raw[name](x)
            sync()
            checks.append(compare(name, nbytes, got, want, x))
            del got, want
        row["input"] = origin
        row["launches"] = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        return row

    # -- headline: allreduce 8 B → max_bytes, x`step` ------------------
    rows = []
    for nbytes in sweep_sizes(max_bytes, step):
        count = max(1, nbytes // 4)
        x, origin = staged((n, count), 0, nbytes)
        w, it = _iters_for(nbytes, iters)
        rows.append(timed_row("allreduce", nbytes, lambda: world.allreduce(x, SUM), x, w, it,
                              origin))
        del x
        free()
    geomean = bj.geomean([r["ratio"] for r in rows])

    # -- blocking suite: smaller sweep ----------------------------------
    colls: dict[str, list[dict]] = {}
    for name in SUITE:
        out = []
        for nb in suite_sizes(suite_max):
            count = max(1, nb // 4)
            shape = ((n, n, max(1, count // n)) if name in ("reduce_scatter", "alltoall")
                     else (n, count))
            x, origin = staged(shape, 1, nb)
            fw = {
                "bcast": lambda: world.bcast(x, root=0),
                "allgather": lambda: world.allgather(x),
                "reduce_scatter": lambda: world.reduce_scatter_block(x, SUM),
                "alltoall": lambda: world.alltoall(x),
            }[name]
            w, it = _iters_for(nb, iters)
            if nb <= 1 << 20:  # suite rows are few; buy jitter immunity
                it = max(it, 160)
            out.append(timed_row(name, nb, fw, x, w, it, origin))
            del x
        colls[name] = out
    free()

    # -- barrier + persistent rows --------------------------------------
    t_bar = _times(lambda: world.barrier(), 5, 64, sync)
    barrier_row = {
        "iters": 64,
        "fw_us_min": round(min(t_bar) * 1e6, 2),
        "fw_us_p50": round(float(np.median(t_bar)) * 1e6, 2),
    }
    pers_nb = min(1 << 20, max_bytes)
    pr = world.allreduce_init(np.ones((n, max(1, pers_nb // 4)), np.float32), SUM)
    t_pers = _times(lambda: pr.start().wait(), 5, 48, sync)
    persistent_row = {
        "bytes": pers_nb,
        "iters": 48,
        "fw_us_min": round(min(t_pers) * 1e6, 2),
        "fw_us_p50": round(float(np.median(t_pers)) * 1e6, 2),
        "note": "MPI_Allreduce_init/Start: the buffer staged once, the schedule "
                "resolved once; each start() replays it",
    }

    # -- gather / scatter rows ------------------------------------------
    gs_nb = min(1 << 20, max_bytes)
    gx = world.mesh.stage_in(np.ones((n, max(1, gs_nb // 4)), np.float32))
    t_g = _times(lambda: world.gather(gx, 0), 4, 24, sync)
    t_s = _times(lambda: world.scatter(gx, 0), 4, 24, sync)
    gather_row = {
        "bytes": gs_nb,
        "iters": 24,
        "gather_us_p50": round(float(np.median(t_g)) * 1e6, 2),
        "scatter_us_p50": round(float(np.median(t_s)) * 1e6, 2),
        "note": f"the 8 ranks are rows of one tensor on {dev}: gather and scatter "
                "move rows within it, no fabric",
    }

    # -- non-blocking overlap -------------------------------------------
    xo = world.mesh.stage_in(np.ones((n, (4 << 20) // 4), np.float32))

    def coll_fn():
        world.allreduce(xo, SUM)
        sync()

    overlap = measure_overlap(coll_fn, lambda: world.iallreduce(xo, SUM))
    overlap["note"] = (
        f"the collective runs on {dev} and the numpy compute on the host: a "
        "positive saving means iallreduce returned before the collective "
        "finished and the host work ran beside it" if cuda else
        "the CPU collective and the numpy compute share the host's cores: a "
        "positive saving means the dispatch itself is non-blocking")

    # -- host path through the arena (stage → coll → unstage), last -----
    hostpath = []
    arena0 = world.mesh.arena.stats()
    for nb in (4096, 1 << 20, 16 << 20):
        if nb > max_bytes:
            continue
        count = max(1, nb // 4)
        hbuf = np.random.default_rng(2).standard_normal((n, count), dtype=np.float32)
        t = _times(lambda: world.allreduce(hbuf, SUM), 2, 8, sync)
        hostpath.append({
            "bytes": nb,
            "iters": 8,
            "fw_us_min": round(min(t) * 1e6, 2),
            "fw_us_p50": round(float(np.median(t)) * 1e6, 2),
            "fw_GBs": round(nb / min(t) / 1e9, 3),
        })
        if checks is not None:
            err, ratio = sum_error(np.asarray(world.allreduce(hbuf, SUM)), hbuf)
            checks.append({"coll": "allreduce_host", "bytes": nb, "exact": False,
                           "max_abs_err": err, "err_over_bound": ratio, "ok": ratio <= 1.0})
    arena1 = world.mesh.arena.stats()
    # -1 = "unobservable on this backend" sentinel: pass through
    arena = {
        k: (arena1[k] if isinstance(arena1[k], bool) or arena1[k] == -1
            else arena1[k] - arena0.get(k, 0))
        for k in arena1
    }
    arena["end_state"] = arena1

    return {
        "n_ranks": n,
        "headline_note": (
            "raw = one torch expression per collective over the rank-major "
            f"tensor on {dev} (detail key raw), the function of the reference's "
            "jit(shard_map(lax.psum)) and kin.  An unpinned SUM allreduce takes "
            "tuned's fused rank-axis sum at every size, so the ratio measures "
            "the framework's dispatch around the same sum; each row's launches "
            "show whether the ring kernels ran"),
        "geomean": geomean,
        "sizes": rows,
        "colls": colls,
        "barrier": barrier_row,
        "persistent": persistent_row,
        "gather_scatter": gather_row,
        "hostpath": hostpath,
        "hostpath_note": (
            "numpy in, numpy out: each call stages the host buffer in (a pageable "
            "H2D on the card), runs the collective and stages the result out (a "
            "D2H); these rows run last, as in the reference"),
        "arena": arena,
        "overlap": overlap,
    }


# ---------------------------------------------------------------------
# the joins: worker jobs under the port's launcher, one rank per process
# ---------------------------------------------------------------------


def osu_rows(text: str) -> list[dict]:
    """The reference's ``_parse_osu_rows``: the 2-token numeric lines
    (size, value) of an OSU table, the launcher's ``[p] `` prefix
    dropped."""
    out = []
    for line in text.splitlines():
        parts = line.split("] ", 1)[-1].split()
        if len(parts) == 2 and parts[0].isdigit():
            out.append({"bytes": int(parts[0]), "value": float(parts[1])})
    return out


def _program(name: str, out_name: str | None = None) -> Path:
    from ompi_tpu_torch import native

    return native.compile_mpi_program(C_BENCH / f"{name}.c",
                                      native.BIN_DIR / (out_name or name))


def capi_rows(jobs, max_bytes: int = 4096, iters: int = 400) -> dict:
    """The reference's ``capi_rows``: ``osu_allreduce.c`` (the C ABI) and
    ``bench_pyapi.py`` (the Python API) at np 1, the same sizes; adds
    the Python worker's device."""
    binary = _program("osu_allreduce", "bench_osu_allreduce")
    out_c = jobs.c_job(1, binary, [max_bytes, iters])
    c_rows = [{"bytes": r["bytes"], "c_us": r["value"]} for r in osu_rows(out_c)]
    out_py = jobs(1, TOOLS_DIR / "bench_pyapi.py", [max_bytes, iters])
    py_rows = bj.marked(out_py, "PYAPI") or []
    dev = re.search(r"^\[0\] PYAPI device=(\S+) ", out_py, re.M)
    by_bytes = {r["bytes"]: r for r in py_rows}
    rows = []
    for r in c_rows:
        pyr = by_bytes.get(r["bytes"])
        row = dict(r)
        if pyr:
            row["py_us"] = pyr["py_us"]
            row["shim_overhead_us"] = round(r["c_us"] - pyr["py_us"], 2)
        rows.append(row)
    return {"np": 1, "iters": iters, "rows": rows, "py_device": dev.group(1) if dev else None}


def capi_p2p_rows(jobs) -> dict:
    """The reference's ``capi_p2p_rows``: ``osu_latency.c`` and
    ``osu_bw.c`` at np 2 over the shim and the C byte plane."""
    rows = {}
    for name, args in (("osu_latency", [65536, 400]), ("osu_bw", [4 << 20, 32])):
        rows[name] = osu_rows(jobs.c_job(2, _program(name), args))
    return rows


def join_sweep(out: dict) -> dict:
    """The reference's ``osu_bw_sweep_rows`` arithmetic over one ``SWEEP``
    line: each row gains ``win_over_unwin``, ``win_doorbells_per_MiB``
    and ``win_doorbell_suppression``."""
    for r in out.get("rows", []):
        uw = r.get("unwin_MBs") or 0.0
        r["win_over_unwin"] = (round(r["win_MBs"] / uw, 3) if uw else None)
        wc = r.get("win_counters", {})
        total_mib = max(1e-9, r["bytes"] * out.get("window", 64) *
                        out.get("batches", 4) / (1 << 20))
        r["win_doorbells_per_MiB"] = round(wc.get("doorbells", 0) / total_mib, 3)
        db = wc.get("doorbells", 0) + wc.get("doorbells_suppressed", 0)
        r["win_doorbell_suppression"] = (
            round(wc.get("doorbells_suppressed", 0) / db, 4) if db else None)
    return out


def osu_bw_sweep_rows(jobs) -> dict:
    """``osu_bw_sweep.c`` at np 2, 64 KiB–16 MiB, window 64, 4 batches."""
    text = jobs.c_job(2, _program("osu_bw_sweep"), [16 << 20, 64, 4], timeout=600)
    out = bj.marked(text, "SWEEP")
    if out is None:
        raise RuntimeError(f"no SWEEP line:\n{text[-2000:]}")
    return join_sweep(out)


def _stamps(lines) -> list[tuple[int, str | None]]:
    """``(ns, device)`` of each ``FIRSTCOLL`` line."""
    out = []
    for line in list(lines):
        if "FIRSTCOLL " in line:
            m = re.search(r"device=(\S+)", line)
            out.append((int(line.split("ns=", 1)[1].split()[0]), m.group(1) if m else None))
    return out


def serve_rows(jobs, runs: int = 3) -> dict:
    """The reference's ``serve_rows``: submit→first collective of
    ``examples/serve_firstcoll.py`` in a cold ``run -np 2`` against warm
    submissions to a resident ``tpud -np 2`` (one rank per process, both
    on ``btl`` tcp), each leg's later ``FIRSTCOLL`` stamp less the
    driver's own on the same host clock; one untimed warm-up submission.
    Adds each leg's worker devices; the warm workers' ring launches come
    from the last job record (the resident workers' totals)."""
    from ompi_tpu_torch.serve import client

    job = EXAMPLES_DIR / "serve_firstcoll.py"
    mca = {"btl": "tcp"}
    devices: dict[str, set] = {"cold": set(), "warm": set()}

    def cold_once() -> float:
        t0 = time.time_ns()
        ts = _stamps(jobs(2, job, mca=mca).splitlines())
        if len(ts) != 2:
            raise RuntimeError(f"cold leg: {len(ts)} FIRSTCOLL lines, not 2")
        devices["cold"].update(d for _t, d in ts)
        return (max(t for t, _d in ts) - t0) / 1e3

    cold = [cold_once() for _ in range(runs)]

    cmd = [sys.executable, "-m", "ompi_tpu_torch", "tpud", "-np", "2", "--nranks", "1"]
    if jobs.cpu:
        cmd.append("--cpu")
    for k, v in mca.items():
        cmd += ["--mca", k, v]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=str(REPO), start_new_session=True)
    lines: list[str] = []

    def _reader():
        for line in iter(proc.stdout.readline, ""):
            lines.append(line)

    reader = threading.Thread(target=_reader, daemon=True)
    reader.start()
    warm, last = [], None
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            for line in list(lines):
                if "[tpud] ops: " in line:
                    url = line.split("[tpud] ops: ", 1)[1].split("/jobs")[0]
            time.sleep(0.05)
        if not url:
            raise RuntimeError("tpud never printed its ops URL:\n" + "".join(lines)[-1000:])

        def warm_once() -> float:
            nonlocal last
            seen = len(_stamps(lines))
            t0 = time.time_ns()
            last = client.wait(url, client.submit(url, str(job))["id"], timeout=300)
            if last.get("state") != "done":
                raise RuntimeError(f"warm job failed: {last}")
            deadline = time.monotonic() + 10
            while len(_stamps(lines)) < seen + 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            ts = _stamps(lines)[seen:seen + 2]
            if len(ts) != 2:
                raise RuntimeError("warm leg: FIRSTCOLL lines missing")
            devices["warm"].update(d for _t, d in ts)
            return (max(t for t, _d in ts) - t0) / 1e3

        warm_once()  # warm-up: the first submit overlaps worker boot
        warm = [warm_once() for _ in range(runs)]
        client.shutdown(url)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
        reader.join(timeout=10)
        sys.stderr.write("".join(lines))
    for rank in (last or {}).get("ranks", {}).values():
        for k, v in (rank.get("launches") or {}).items():
            jobs.launches[k] = jobs.launches.get(k, 0) + v
    cold_med = float(np.median(cold))
    warm_med = float(np.median(warm))
    return {
        "np": 2, "runs": runs,
        "cold_submit_to_first_coll_us": round(cold_med, 1),
        "warm_submit_to_first_coll_us": round(warm_med, 1),
        "cold_us_all": [round(c, 1) for c in cold],
        "warm_us_all": [round(w, 1) for w in warm],
        "warm_speedup": round(cold_med / max(warm_med, 1e-9), 2),
        "device": {leg: sorted(d for d in devs if d) for leg, devs in devices.items()},
    }


def tool_rows(jobs, command: str, marker: str, check: bool, timeout: float = 900) -> dict:
    """One of the port's single-process tools (``bench-algos``,
    ``bench-hostpath``) in a process of its own: its ``<marker>`` line,
    with ``check`` its ``--check`` form's ``<marker>_CHECK`` line under
    ``check`` and that line's launches counted."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch", command]
    if jobs.cpu:
        cmd.append("--cpu")
    if check:
        cmd.append("--check")
    try:
        rc, out, err = bj.group_run(cmd, timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{command} exceeded {timeout} s") from None
    sys.stderr.write(out + err)
    if rc != 0:
        raise RuntimeError(f"{command} rc={rc}:\n{out[-2000:]}\n{err[-1000:]}")
    line = bj.marked(out, marker, strict=True)
    if check:
        line["check"] = bj.marked(out, marker + "_CHECK", strict=True)
        for k, v in line["check"]["launches"].items():
            jobs.launches[k] = jobs.launches.get(k, 0) + v
    return line


#: the reference's joins, in its order: detail key → call(jobs, args)
JOINS = (
    ("dcn", lambda jobs, a: bj.dcn(jobs)),
    ("capi", lambda jobs, a: capi_rows(jobs)),
    ("capi_p2p", lambda jobs, a: capi_p2p_rows(jobs)),
    ("osu_bw_sweep", lambda jobs, a: osu_bw_sweep_rows(jobs)),
    ("dispatch_floor", lambda jobs, a: bj.dispatch_floor(
        jobs, _program("dispatch_floor"))),
    ("device_plane", lambda jobs, a: bj.device_plane(jobs)),
    ("algos_cpu8", lambda jobs, a: tool_rows(jobs, "bench-algos", "ALGOS8", a.check)),
    ("hostpath_cpu8", lambda jobs, a: tool_rows(jobs, "bench-hostpath", "HOSTPATH8",
                                                a.check)),
    ("serve", lambda jobs, a: serve_rows(jobs, a.serve_runs)),
)


def run_joins(args) -> dict:
    """Each join's row (``{"error": ...}`` if it raised), its ``Jobs`` and
    its wall time, in :data:`JOINS`' order.  The joins before ``serve``
    run ``args.lanes`` at a time (1: one after another, as the
    reference's); ``serve``, which times cold boots, always runs alone,
    last."""
    from concurrent.futures import ThreadPoolExecutor

    def one(key, fn):
        jobs = bj.Jobs(args.cpu)
        t0 = time.perf_counter()
        try:
            row = fn(jobs, args)
        except Exception as e:  # never lose the headline to a subrow
            row = {"error": f"{type(e).__name__}: {e}"[:500]}
        return key, (row, jobs, time.perf_counter() - t0)

    with ThreadPoolExecutor(args.lanes) as pool:
        done = [pool.submit(one, key, fn) for key, fn in JOINS if key != "serve"]
        out = dict(f.result() for f in done)
    out.update(one(key, fn) for key, fn in JOINS if key == "serve")
    return {key: out[key] for key, _fn in JOINS}


def headline(detail: dict) -> dict:
    """The reference's compact headline, plus ``device``."""
    rows = detail["sizes"]
    worst = min(rows, key=lambda r: r["ratio"])
    suite_rows = [r for c in detail["colls"].values() for r in c]
    suite_worst = min(suite_rows, key=lambda r: r["ratio"]) if suite_rows else None
    geomean = detail["geomean"]
    return {
        "metric": METRIC,
        "value": round(geomean, 4),
        "unit": "ratio",
        "vs_baseline": round(geomean / 0.8, 4),
        "n_ranks": detail["n_ranks"],
        "platform": detail["platform"],
        "max_bytes": rows[-1]["bytes"] if rows else 0,
        "min_size_ratio": worst["ratio"],
        "min_size_ratio_bytes": worst["bytes"],
        "suite_min_ratio": suite_worst["ratio"] if suite_worst else None,
        "overlap_saving_pct": detail["overlap"]["saving_pct"],
        "detail_file": detail["detail_file"],
        "device": detail["device"],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--max-bytes", type=int, default=None,
                    help="allreduce sweep ceiling per rank (default: 1 GiB on the "
                    "card, 4 MiB with --cpu)")
    ap.add_argument("--suite-max", type=int, default=4 << 20,
                    help="blocking-suite sweep ceiling (default 4 MiB)")
    ap.add_argument("--step", type=int, default=4,
                    help="size multiplier between sweep points (>= 2)")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--no-subproc", action="store_true",
                    help="skip the joins (the worker jobs and the tools)")
    ap.add_argument("--detail", action="store_true",
                    help="also print per-row lines (as # comments)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks and every worker on the CPU (default: cuda:0)")
    ap.add_argument("--check", action="store_true",
                    help="hold every result against its raw primitive; exit 1 on a "
                    "disagreement or a failed join")
    ap.add_argument("--serve-runs", type=int, default=3,
                    help="cold and warm samples of the serve join (default 3)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="run the joins before serve this many at a time (default 1: one "
                    "after another, as the reference; their rows then share the host)")
    ap.add_argument("--out", type=Path, default=DETAIL_FILE,
                    help="the detail file (default build/ompi_tpu_torch/BENCH_DETAIL.json)")
    args = ap.parse_args(argv)
    if args.step < 2:
        ap.error("--step must be >= 2")
    if args.lanes < 1:
        ap.error("--lanes must be >= 1")
    max_bytes = args.max_bytes or ((4 << 20) if args.cpu else (1 << 30))
    if max_bytes < 8:
        ap.error(f"--max-bytes {max_bytes} leaves an empty size sweep (minimum is 8)")

    from ompi_tpu_torch.coll import cuda_kernels as ck

    checks: list | None = [] if args.check else None
    before = dict(ck.LAUNCHES)
    t0 = time.perf_counter()
    detail = run(max_bytes, args.iters, args.suite_max, args.step,
                 "cpu" if args.cpu else "cuda", checks)
    walls = {"run": time.perf_counter() - t0}
    per_join = {"run": {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}}
    failed_joins = []
    if not args.no_subproc:
        for key, (row, jobs, wall_s) in run_joins(args).items():
            detail[key] = row
            walls[key] = wall_s
            per_join[key] = dict(jobs.launches)
            if "error" in row:
                failed_joins.append(key)
            if jobs.cuda_initialized:
                row["c_cuda_initialized"] = jobs.cuda_initialized
            row["launches"] = per_join[key]
        detail["join_lanes"] = args.lanes

    import ompi_tpu_torch.api as api

    world = api.init()
    detail["platform"] = "gpu" if world.mesh.device.type == "cuda" else "cpu"
    detail["device"] = str(world.mesh.device)
    detail["raw"] = {k: text for k, (text, _fn) in RAW.items()}
    detail["raw_note"] = (
        "x is the rank-major tensor of the row on the world's device ((n, count); "
        "reduce_scatter and alltoall (n, n, c)); one torch expression each, timed "
        "beside the framework call on the same tensor")
    dcn = detail.get("dcn")
    if isinstance(dcn, dict) and isinstance(dcn.get("native"), dict):
        detail["native_counters"] = dcn["native"].get("native_counters", {})
        detail["arrival_skew"] = dcn["native"].get("arrival_skew", {})
    detail["launches_per_join"] = per_join
    detail["wall_s"] = walls
    detail["launches"] = {k: sum(j.get(k, 0) for j in per_join.values()) for k in ck.LAUNCHES}
    if checks is not None:
        detail["check"] = {"ok": all(c["ok"] for c in checks) and not failed_joins,
                           "rows": checks, "failed_joins": failed_joins}
    out = args.out if args.out.is_absolute() else Path.cwd() / args.out
    try:
        detail["detail_file"] = str(out.relative_to(REPO))
    except ValueError:
        detail["detail_file"] = str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(detail, indent=1))

    if args.detail:
        for row in detail["sizes"]:
            print(f"# {row['bytes']:>11} B  fw {row['fw_us_min']:>10.1f} us "
                  f"(p50 {row['fw_us_p50']:>10.1f})  raw "
                  f"{row['raw_us_min']:>10.1f} us  {row['fw_GBs']:>8.2f} GB/s"
                  f"  ratio {row['ratio']:.3f}")
        for cname, crows in detail["colls"].items():
            for row in crows:
                print(f"# {cname:<15} {row['bytes']:>9} B  ratio {row['ratio']:.3f}")
        print(f"# overlap: {detail['overlap']}")
    # the compact headline is the last stdout line
    print(json.dumps(headline(detail)), flush=True)
    if checks is not None and not detail["check"]["ok"]:
        bad = [c for c in checks if not c["ok"]]
        print(f"bench --check: {len(bad)} comparisons failed {bad[:4]}, failed joins "
              f"{failed_joins}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
