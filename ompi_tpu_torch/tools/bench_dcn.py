"""np=2 DCN hot-path measurements: p2p ping-pong and han's allreduce.

    python -m ompi_tpu_torch run -np 2 --nranks 1 [--cpu] [--mca btl tcp|sm] \\
        ompi_tpu_torch/tools/bench_dcn.py

Port of the reference's ``tools/bench_dcn.py``: p2p ping-pong latency
and bandwidth (``P2P_SIZES``, 150 round trips up to 64 KiB and 40 above,
a tenth of them first as warm-up) and han's allreduce (``COLL_SIZES``,
50 calls up to 64 KiB and 20 above) for whichever btl the launcher
selected.  Every row is a median over per-iteration samples with its
p90, the p2p rows in the OSU half-round-trip convention.  The straggler
profiler is on over the collective rows, and the processes' instance
records are joined on process 0 into ``arrival_skew`` beside the native
transport's counters.  The payloads are numpy arrays, as in the
reference: this leg measures the host planes.  The world is on
``cuda:0`` unless the launcher's ``--cpu`` is given (without a card and
without ``--cpu`` the job fails); the pairs run between the first rank
of each process.  Process 0 prints one ``DCNBENCH {json}`` line with the
reference's keys plus ``device``.
"""

import json
import sys
import time

import numpy as np

import ompi_tpu_torch.api as api
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.metrics import core as _mcore
from ompi_tpu_torch.metrics import straggler as _straggler
from ompi_tpu_torch.op import SUM

P2P_SIZES = [64, 65536, 1 << 20, 4 << 20]
COLL_SIZES = [64, 65536, 1 << 20]


def pingpong(world, nbytes: int, iters: int) -> np.ndarray:
    """Per-iteration round-trip samples (seconds), OSU osu_latency
    shape; the caller reduces to median/2."""
    buf = np.zeros(nbytes, np.uint8)
    r0, r1 = world.offsets[0], world.offsets[1]

    def once():
        if world.proc == 0:
            world.send(buf, source=r0, dest=r1, tag=9)
            world.recv(dest=r0, source=r1, tag=9)
        else:
            world.recv(dest=r1, source=r0, tag=9)
            world.send(buf, source=r1, dest=r0, tag=9)

    for _ in range(max(4, iters // 10)):
        once()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def coll_samples(world, nbytes: int, iters: int) -> np.ndarray:
    x = np.ones((world.local_size, max(1, nbytes // 4)), np.float32)
    for _ in range(max(2, iters // 10)):
        world.allreduce(x, SUM)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        world.allreduce(x, SUM)
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def arrival_skew(world, skew_rows: list) -> dict:
    """Process 0's join of every process's straggler records, arrivals
    aligned by the transports' handshake clock offsets."""
    offs = {pr: off for pr, (off, _rtt) in world.dcn.clock_offsets().items()}
    join = _straggler.join_skew(dict(enumerate(skew_rows)), offsets_ns=offs)
    return {
        "instances": join["instances"],
        "per_op": {op: {
            "n": st["n"],
            "skew_ms": st["skew_ns"] / 1e6,
            "max_skew_ms": st["max_skew_ns"] / 1e6,
            "slowest": {str(k): v for k, v in st["slowest"].items()},
        } for op, st in join["per_op"].items()},
        "per_proc": {str(pr): {
            "skew_ms": st["skew_ns"] / 1e6,
            "slowest": st["slowest"],
        } for pr, st in join["per_proc"].items()},
    }


def main() -> int:
    world = api.init()
    if getattr(world, "nprocs", 1) != 2:
        raise SystemExit("bench_dcn: run it as an np=2 job: python -m ompi_tpu_torch "
                         "run -np 2 --nranks 1 ompi_tpu_torch/tools/bench_dcn.py")
    _straggler.enable(True)
    rows = []
    for nb in P2P_SIZES:
        iters = 150 if nb <= 65536 else 40
        rt = pingpong(world, nb, iters)
        med = float(np.median(rt)) / 2.0  # half round trip, OSU convention
        p90 = float(np.percentile(rt, 90)) / 2.0
        rows.append({"bytes": nb, "p2p_us": med * 1e6, "p2p_p90_us": p90 * 1e6,
                     "p2p_MBs": nb / med / 1e6 if med > 0 else 0.0, "iters": iters})
    crows = []
    for nb in COLL_SIZES:
        iters = 50 if nb <= 65536 else 20
        ts = coll_samples(world, nb, iters)
        crows.append({"bytes": nb, "han_allreduce_us": float(np.median(ts)) * 1e6,
                      "han_allreduce_p90_us": float(np.percentile(ts, 90)) * 1e6})
    # cross-process skew join: exchange the instance records (bounded
    # ring, JSON-able rows) and attribute arrival lateness on process 0
    skew_rows = world.dcn.allgather_obj(_straggler.recent(), "bench#skew")
    if world.proc == 0:
        counters = _mcore.native_counters()
        print("DCNBENCH " + json.dumps(
            {"p2p": rows, "han": crows, "estimator": "median-of-iterations",
             "native_counters": {k: v for k, v in counters.items() if v},
             "arrival_skew": arrival_skew(world, skew_rows),
             "device": str(world.device)}), flush=True)
    print("LAUNCHES " + json.dumps(dict(ck.LAUNCHES)), flush=True)
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
