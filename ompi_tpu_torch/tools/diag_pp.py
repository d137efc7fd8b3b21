"""Diagnostic np=2 ping-pong: per-iteration latency distribution at one
size (TPDIAG_BYTES, default 1 MiB) — bimodality at +2 ms multiples
means doorbell wakeups are being missed (futex timeout cadence).

    python -m ompi_tpu_torch run -np 2 [--cpu] ompi_tpu_torch/tools/diag_pp.py

Port of the reference's ``tools/diag_pp.py``: the same knobs
(``TPDIAG_BYTES``, ``TPDIAG_ITERS`` default 60), 5 warm-up rounds, the
same send/recv pairs (tag 9) and the same two ``PPDIAG`` lines, printed
by process 0.  The buffer is a ``uint8`` tensor on the world's device:
``cuda:0`` unless the launcher's ``--cpu`` is given, so the hand-off
crosses the default transport (``btl/native``, ``pml_native``) from the
card, and a round trip ends once its payload is on the device.  The
pairs run between the first rank of each process (ranks 0 and 1 under
``--nranks 1``, the reference's layout).  Process 0 first prints
``PPDIAG device=<device> bytes=<n> iters=<n>``, so a log shows where the
buffer lived.
"""

import os
import time

import numpy as np
import torch

import ompi_tpu_torch.api as api

world = api.init()
if getattr(world, "nprocs", 1) != 2:
    raise SystemExit("diag_pp: run it as an np=2 job: "
                     "python -m ompi_tpu_torch run -np 2 ompi_tpu_torch/tools/diag_pp.py")
p = world.proc
nbytes = int(os.environ.get("TPDIAG_BYTES", 1 << 20))
iters = int(os.environ.get("TPDIAG_ITERS", 60))
buf = torch.zeros(nbytes, dtype=torch.uint8, device=world.device)
r0, r1 = world.offsets[0], world.offsets[1]  # the first rank of each process


def settle() -> None:
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)


for _ in range(5):
    if p == 0:
        world.send(buf, source=r0, dest=r1, tag=9)
        world.recv(dest=r0, source=r1, tag=9)
    else:
        world.recv(dest=r1, source=r0, tag=9)
        world.send(buf, source=r1, dest=r0, tag=9)
    settle()

ts = []
for _ in range(iters):
    t0 = time.perf_counter()
    if p == 0:
        world.send(buf, source=r0, dest=r1, tag=9)
        world.recv(dest=r0, source=r1, tag=9)
    else:
        world.recv(dest=r1, source=r0, tag=9)
        world.send(buf, source=r1, dest=r0, tag=9)
    settle()
    ts.append((time.perf_counter() - t0) * 1e6)

if p == 0:
    a = np.array(ts)
    print(f"PPDIAG device={world.device} bytes={nbytes} iters={iters}", flush=True)
    print("PPDIAG rt_us min=%.0f p25=%.0f med=%.0f p75=%.0f p90=%.0f max=%.0f"
          % (a.min(), np.percentile(a, 25), np.median(a),
             np.percentile(a, 75), np.percentile(a, 90), a.max()),
          flush=True)
    print("PPDIAG hist_ms " + " ".join("%.2f" % (x / 1e3) for x in sorted(a)),
          flush=True)
api.finalize()
