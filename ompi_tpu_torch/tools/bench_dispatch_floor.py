"""Python-API per-op latency, the twin of ``native/bench/dispatch_floor.c``.

    python -m ompi_tpu_torch run -np N --nranks 1 [--cpu] \\
        ompi_tpu_torch/tools/bench_dispatch_floor.py [iters]

Port of the reference's ``tools/bench_dispatch_floor.py``: the same
collectives at the same small sizes as the C meter, joined per
operation (``c_us`` against ``py_us``).  On the card the two are not on
one backend: the C fast path runs its whole schedule on host buffers in
C, while this worker's numpy inputs are staged to the world's device and
back, so there ``c_over_py`` sets the host C path against the Python path
through the card, staging included, and is not the dispatch floor alone
(no row splits staging from dispatch).  The same argv default (400 calls), sizes (8,
64, 512 and 4096 bytes per rank), ops (allreduce, bcast, reduce and
allgather at each size, then barrier), ``iters // 10 + 5`` warm-up calls
and one ``PYDISPATCH [rows]`` line from process 0, each row the average
µs per call.  The buffers are numpy arrays of ``(local_size, bytes / 4)``
f32, as in the reference.  The world is on ``cuda:0`` unless the
launcher's ``--cpu`` is given (without a card and without ``--cpu`` the
job fails).  Process 0 first prints ``PYDISPATCH device=<device>
iters=<n>``; each op's last result is held to the exact numpy answer
(the values are small integers) and a wrong one exits 1.
"""

import json
import sys
import time

import numpy as np

import ompi_tpu_torch.api as api
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.op import SUM

SIZES = (8, 64, 512, 4096)  # bytes per rank


def expected(world, count: int) -> dict:
    """The numpy answer of each op when global rank r contributes
    ``proc_of(r) + 1`` everywhere: what this process's ranks hold after
    the call (``None`` for reduce off the root's process)."""
    ln = world.local_size
    vals = np.repeat(np.arange(1, world.nprocs + 1, dtype=np.float32), np.diff(world.offsets))
    total = np.full((ln, count), vals.sum(), np.float32)
    return {
        "allreduce": total,
        "bcast": np.full((ln, count), vals[0], np.float32),
        "reduce": total if world.locate(0)[0] == world.proc else None,
        "allgather": np.broadcast_to(vals[None, :, None], (ln, world.size, count)),
    }


def matches(out, want) -> bool:
    """Whether an op's result is exactly the numpy answer (``None``
    where the process holds none)."""
    if out is None or want is None:
        return out is None and want is None
    return np.array_equal(np.asarray(out), want)


def main() -> int:
    world = api.init()
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    if world.proc == 0:
        print(f"PYDISPATCH device={world.device} iters={iters}", flush=True)
    ln = world.local_size
    rows = []
    wrong = []

    def timed(op, nbytes, fn, want=None):
        for _ in range(iters // 10 + 5):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        rows.append({"op": op, "bytes": nbytes,
                     "py_us": (time.perf_counter() - t0) * 1e6 / iters})
        if op == "barrier":
            return
        if not matches(out, want):
            wrong.append(f"{op} {nbytes} B")

    for nbytes in SIZES:
        count = nbytes // 4
        sbuf = np.full((ln, count), float(world.proc + 1), np.float32)
        want = expected(world, count)
        timed("allreduce", nbytes, lambda: world.allreduce(sbuf, SUM), want["allreduce"])
        timed("bcast", nbytes, lambda: world.bcast(sbuf, 0), want["bcast"])
        timed("reduce", nbytes, lambda: world.reduce(sbuf, SUM, 0), want["reduce"])
        timed("allgather", nbytes, lambda: world.allgather(sbuf), want["allgather"])
    timed("barrier", 0, world.barrier)
    if wrong:
        print(f"PYDISPATCH: process {world.proc} got wrong results: {wrong}",
              file=sys.stderr, flush=True)
    elif world.proc == 0:
        print("PYDISPATCH " + json.dumps(rows), flush=True)
    print("LAUNCHES " + json.dumps(dict(ck.LAUNCHES)), flush=True)
    api.finalize()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
