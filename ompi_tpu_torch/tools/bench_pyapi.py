"""np=1 Python-API allreduce latency in OSU shape.

    python -m ompi_tpu_torch run -np 1 --nranks 1 [--cpu] \\
        ompi_tpu_torch/tools/bench_pyapi.py [max_bytes] [iters]

Port of the reference's ``tools/bench_pyapi.py``: the same argv
defaults (4096 bytes, 200 calls), sizes from 4 bytes up in ×4 steps,
per-call host buffers (a numpy array of ``(local_size, count)`` f32
through stage-in, the collective and stage-out, as the C harness's
``osu_allreduce.c`` passes them) after ``iters // 10 + 1`` warm-up
calls, and the same ``PYAPI [rows]`` line from process 0, each row the
average µs per call.  ``--nranks 1`` is the reference harness's one CPU
device per process.  The world is on ``cuda:0`` unless the launcher's
``--cpu`` is given (without a card and without ``--cpu`` the job
fails).  Process 0 first prints ``PYAPI device=<device> max_bytes=<n>
iters=<n>``, so a log shows where the buffers went; each size's last
result is held to the exact sum (the values are small integers) and a
wrong one exits 1.  Every process ends with a ``LAUNCHES {json}`` line,
its ring kernels' launches, which ``bench``'s capi join sums.
"""

import json
import sys
import time

import numpy as np

import ompi_tpu_torch.api as api
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.op import SUM

world = api.init()
max_bytes = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
iters = int(sys.argv[2]) if len(sys.argv) > 2 else 200
if world.proc == 0:
    print(f"PYAPI device={world.device} max_bytes={max_bytes} iters={iters}", flush=True)
nprocs = getattr(world, "nprocs", 1)
want = float(world.local_size * nprocs * (nprocs + 1) // 2)

rows = []
count = 1
while count * 4 <= max_bytes:
    # match the C harness: per-call host buffers through the full
    # stage-in → coll → stage-out path
    sbuf = np.full((world.local_size, count), float(world.proc + 1), np.float32)
    for _ in range(iters // 10 + 1):
        world.allreduce(sbuf, SUM)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = world.allreduce(sbuf, SUM)
    dt = (time.perf_counter() - t0) / iters
    if not np.array_equal(np.asarray(out), np.full(sbuf.shape, want, np.float32)):
        raise SystemExit(f"PYAPI: {count * 4} B allreduce gave {np.asarray(out)[:, :4]}, "
                         f"not {want}")
    rows.append({"bytes": count * 4, "py_us": dt * 1e6})
    count *= 4

if world.proc == 0:
    print("PYAPI " + json.dumps(rows), flush=True)
print("LAUNCHES " + json.dumps(dict(ck.LAUNCHES)), flush=True)
api.finalize()
