"""np=2 device-plane legs: osu_bw and osu_allreduce around the plane's threshold.

    python -m ompi_tpu_torch run -np 2 --nranks 1 [--cpu] --mca btl tcp \\
        [--mca dcn_device_enable 0] ompi_tpu_torch/tools/bench_device_plane.py

Port of the reference's ``tools/bench_device_plane.py``: OSU-shaped p2p
bandwidth (a window of ``WINDOW`` sends on tag 7, one ack on tag 8) and
allreduce latency at ``SIZES`` (64 KiB … 4 MiB, bracketing
``dcn_device_min_size``), ``DEVBENCH_ITERS`` (default 12) iterations per
size, each row a median, on whichever btl and ``dcn_device_enable`` the
launcher selected; then this process's ``dcn_device_*`` counters after a
non-contiguous probe of device-plane size that arbitration must keep on
the host.  Process 0 prints one ``DEVBENCH {json}`` line, process 1 one
``DEVBENCH_PEER {json}`` line.

One deliberate difference: the ``osu_bw`` buffer is a ``uint8`` tensor
on the world's device (``cuda:0`` unless the launcher's ``--cpu`` is
given), as ``diag_pp.py`` keeps its buffer, and the probe is a strided
view on that device; the line adds ``device`` and ``buffer``.  ``send``
stages a tensor to the host before the plane's arbitration, so the
plane-on ``osu_bw`` rows measure that staged send over the plane's
shared-memory windows, not CUDA IPC, and the buffer on the card adds one
device-to-host copy per message in both legs.  The
allreduce input stays a numpy array, as in the reference: ``allreduce``
stages it, and han hands the DCN leg the row on the card.  Without a
card and without ``--cpu`` the job fails.
"""

import json
import os
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.op import SUM

SIZES = [64 << 10, 256 << 10, 1 << 20, 4 << 20]
WINDOW = 8


def bw_row(world, nbytes: int, iters: int) -> tuple[float, str]:
    """osu_bw shape: a window of sends, one ack; returns MB/s median
    over iterations (process 0's clock) and the buffer's device."""
    buf = torch.zeros(nbytes, dtype=torch.uint8, device=world.device)
    ack = np.zeros(1, np.uint8)
    r0, r1 = world.offsets[0], world.offsets[1]
    rates = []
    for _ in range(iters):
        if world.proc == 0:
            t0 = time.perf_counter()
            for _w in range(WINDOW):
                world.send(buf, source=r0, dest=r1, tag=7)
            world.recv(dest=r0, source=r1, tag=8)
            rates.append(nbytes * WINDOW / (time.perf_counter() - t0) / 1e6)
        else:
            for _w in range(WINDOW):
                world.recv(dest=r1, source=r0, tag=7)
            world.send(ack, source=r1, dest=r0, tag=8)
    return (float(np.median(rates)) if rates else 0.0), str(buf.device)


def allreduce_row(world, nbytes: int, iters: int) -> float:
    """osu_allreduce shape: µs median per call."""
    x = np.zeros((world.local_size, nbytes // 8), np.float64)
    world.allreduce(x, SUM)  # warm the schedule
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        world.allreduce(x, SUM)
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def main() -> int:
    world = api.init()
    if getattr(world, "nprocs", 1) != 2:
        raise SystemExit("bench_device_plane: run it as an np=2 job: python -m ompi_tpu_torch "
                         "run -np 2 --nranks 1 ompi_tpu_torch/tools/bench_device_plane.py")
    iters = int(os.environ.get("DEVBENCH_ITERS", "12"))
    rows = []
    for nbytes in SIZES:
        bw, buffer = bw_row(world, nbytes, iters)
        rows.append({"bytes": nbytes, "bw_MBs": bw,
                     "allreduce_us": allreduce_row(world, nbytes, iters)})
    dp = world.dcn._root_engine()._device_plane
    stats = None
    if dp is not None:
        # the layout half of the arbitration, counted: a non-contiguous
        # payload of device-plane size still goes host
        nc = torch.ones((1 << 9, 1 << 9), dtype=torch.float64, device=world.device)[:, ::2]
        if dp.arbitrate(nc, 1):
            raise SystemExit("bench_device_plane: a non-contiguous payload took the device plane")
        stats = dict(dp.stats)
    if world.proc == 0:
        print("DEVBENCH " + json.dumps({
            "np": 2, "iters": iters, "window": WINDOW,
            "min_size": dp.min_size if dp is not None else None,
            "rows": rows, "stats": stats, "device": str(world.device),
            "buffer": buffer}), flush=True)
    else:
        print("DEVBENCH_PEER " + json.dumps({"stats": stats}), flush=True)
    print("LAUNCHES " + json.dumps(dict(ck.LAUNCHES)), flush=True)
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
