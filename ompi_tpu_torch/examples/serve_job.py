"""tpud job script — runs INSIDE a resident serve worker, and unchanged
under a plain launch::

    python -m ompi_tpu_torch ctl --url URL submit ompi_tpu_torch/examples/serve_job.py
    python -m ompi_tpu_torch run -np 2 --nranks 4 [--cpu] ompi_tpu_torch/examples/serve_job.py

The port's counterpart of the reference's ``tests/workers/serve_job_worker.py``.
It exercises what warm reuse must keep correct:

* ``api.init()`` returns the JOB world (a fresh communicator on a
  disjoint CID block) — verified collectives prove its per-(comm, op)
  sequence state starts clean;
* cross-process p2p on the warm endpoints (no re-dial);
* ``api.finalize()`` ends the job, not the resident plane.

Env knobs (set per job via the submit payload), as in the reference:
  SERVE_ITERS       collectives to run (default 4)
  SERVE_SLEEP       post-loop sleep seconds (queue-depth tests)
  SERVE_ITER_SLEEP  per-iteration sleep seconds BEFORE each collective
  SERVE_KILL_RANK   job-world proc index that SIGKILLs itself at
                    iteration 2 (elastic-plane acceptance; default off)
  SERVE_KILL_FLAG   path making the kill one-shot: the proc touches the
                    flag before dying, and a later attempt sees it and
                    runs clean

``--sizes B1,B2,...`` adds the sweep of the card's ``serve`` cell: per
size, f32 SUM on tensors on the job world's device (rank r's row drawn
from its own seed), ``--calls`` (5) timed calls with ``cuda_ring`` forced
(``coll_cuda_allreduce_algorithm`` 7) and one with the plain ring
(enum 2); each process prints one ``SJSON`` line per size with the p50,
the ring-hop launches per call, the SHA-256 of its result and whether
it is bit-equal to the plain ring, and a last ``SJSON`` line with the
job's launches, its DCN device plane's counters, its fallbacks by cause
(``device_fallback_causes``) and the plane's health transitions
(``plane_transitions``: event, peer, cause) since the process started,
where each layer holds a peer failed (``marks``: the detector, its
false-positive heals, the engine, the device plane) and the seconds of
the process's one-time legs (``first_use``: ``native.FIRST_USE``).
``--repeat-sleep S`` sleeps S seconds before each timed call (untimed:
tenant overlap, a scrape window).

On the one-rank-per-device layout (a daemon started with ``--mca
"accelerator_cuda_layout" devices``) the sweep makes the same rows on
local rank 0's card and copies each onto its rank's card (``RankShards``
in and out), synchronizes every card of the job world's local mesh
around a call, and digests the gathered bytes, so a devices job and a
rows job of the same inputs compare; each size's line adds
``placement``, the devices its result's shards lie on and whether each
is its rank's.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch import native, serve
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.core import mca
from ompi_tpu_torch.examples.layout import digest, on_ranks, placement, sync
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op import SUM

SEED = 11


def emit(kind: str, **obj) -> None:
    print("SJSON " + json.dumps({"kind": kind, **obj}), flush=True)


def same_bits(a, b) -> bool:
    if isinstance(a, RankShards):
        return all(torch.equal(s.view(torch.int32), t.view(torch.int32))
                   for s, t in zip(a.shards, b.shards))
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def rank_rows(ranks, count: int, dev: torch.device) -> torch.Tensor:
    """Rank r's f32 row is drawn from its own seed: any process, in any
    job, makes the same data for the same rank."""
    rows = []
    for r in ranks:
        g = torch.Generator(device=dev).manual_seed(SEED * 1000 + r)
        rows.append(torch.randn(count, generator=g, device=dev))
    return torch.stack(rows)


def sweep(world, job_id: str, sizes: list[int], calls: int, pause: float) -> None:
    store = mca.default_context().store
    dev, k, lo = world.device, world.local_size, world.local_offset
    try:
        for nbytes in sizes:
            x = on_ranks(world, rank_rows(range(lo, lo + k), max(1, nbytes // 4), dev))
            store.set("coll_cuda_allreduce_algorithm", 7)
            times, launches, got = [], [], None
            for _ in range(calls):
                if pause:
                    time.sleep(pause)
                before = dict(ck.LAUNCHES)
                sync(world)
                t0 = time.perf_counter()
                got = world.allreduce(x, SUM)
                sync(world)
                times.append((time.perf_counter() - t0) * 1e3)
                launches.append({n: ck.LAUNCHES[n] - before[n] for n in ck.LAUNCHES})
            store.set("coll_cuda_allreduce_algorithm", 2)
            plain = world.allreduce(x, SUM)
            sync(world)
            emit("size", job=job_id, proc=world.proc, bytes=nbytes, times_ms=times,
                 p50_ms=float(np.median(times)), launches_per_call=launches[-1],
                 digest=digest(got), bitwise_vs_plain=same_bits(got, plain),
                 placement=placement(world, got))
            del x, got, plain
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)


def failure_marks(world, root, plane) -> dict:
    """Where this process holds a peer failed, layer by layer: the
    detector's set and its false-positive heals, the engine's set, the
    device plane's set.  A peer held by one layer and not by the others
    is a mark that did not lift with the rest."""
    det = getattr(world.procctx, "detector", None)
    return {"detector": sorted(det.failed()) if det is not None else None,
            "false_positive_heals": (det.counters["false_positive_heals"]
                                     if det is not None else None),
            "engine": sorted(root._failed_procs),
            "plane": plane.failed_peers() if plane is not None else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="", help="comma-separated bytes per rank")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--repeat-sleep", type=float, default=0.0)
    args = ap.parse_args()
    world = api.init()
    p, n = world.proc, world.size
    job = serve.current_job() or {}
    launches0 = dict(ck.LAUNCHES)
    iters = int(os.environ.get("SERVE_ITERS", "4"))
    kill = int(os.environ.get("SERVE_KILL_RANK", "-1"))
    kill_flag = os.environ.get("SERVE_KILL_FLAG", "")
    sleep_s = float(os.environ.get("SERVE_SLEEP", "0"))
    iter_sleep = float(os.environ.get("SERVE_ITER_SLEEP", "0"))

    for i in range(iters):
        if iter_sleep:
            time.sleep(iter_sleep)
        if p == kill and i == 2:
            if not (kill_flag and os.path.exists(kill_flag)):
                if kill_flag:
                    open(kill_flag, "w").close()
                os.kill(os.getpid(), signal.SIGKILL)
        out = world.allreduce(np.full((world.local_size, 4), float(i + 1)), SUM)
        assert float(np.asarray(out)[0][0]) == (i + 1) * n, (i, out)

    if world.nprocs >= 2 and kill < 0:
        # cross-process p2p over the warm endpoints (global ranks: first
        # local rank of procs 0 and 1 in the JOB world)
        src, dst = world.proc_range(0)[0], world.proc_range(1)[0]
        if p == 0:
            world.send(np.arange(8.0), source=src, dest=dst, tag=7)
        elif p == 1:
            payload, _st = world.recv(dst, source=src, tag=7)
            assert np.array_equal(np.asarray(payload), np.arange(8.0))

    if args.sizes:
        sweep(world, str(job.get("id", "run")),
              [int(s) for s in args.sizes.split(",") if s], args.calls,
              args.repeat_sleep)
        root = world.dcn._root_engine()
        plane = getattr(root, "_device_plane", None)
        emit("launches", job=str(job.get("id", "run")), proc=p,
             marks=failure_marks(world, root, plane),
             first_use=dict(native.FIRST_USE),
             device=dict(plane.stats) if plane is not None else None,
             device_fallback_causes=(dict(plane.fallback_causes) if plane is not None
                                     else None),
             plane_transitions=([list(t) for t in plane.health.transitions]
                                if plane is not None else None),
             **{name: ck.LAUNCHES[name] - launches0.get(name, 0) for name in ck.LAUNCHES})
    if sleep_s:
        time.sleep(sleep_s)
    print(f"OK SERVE_JOB proc={p} size={n} cid={world.cid} "
          f"id={job.get('id', '?')}", flush=True)
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
