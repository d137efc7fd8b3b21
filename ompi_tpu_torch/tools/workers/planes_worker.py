"""``run --ft`` plane-failover soak worker: allreduce under an
event-indexed device-plane fault plan (launched by ``python -m
ompi_tpu_torch chaos --planes``).

The driver arms ``drop:site=device;n=6;proc=0`` with a small
``dcn_device_min_size`` and a short ``dcn_plane_heal_interval``, so on
rank 0 the first six device-window stage attempts abort as simulated
DMA failures.  Each op's row is a float64 tensor on the world's device:
on the card every stage is a CUDA IPC window (``csrc/device_window.cu``),
on the CPU (``--cpu``) an shm window.  With the default
``dcn_plane_strikes`` of 3 the plane's trajectory is fixed IN EVENT
SPACE (the fault schedule indexes stage events, not wall clock):

* stage events 1-3 drop → three consecutive strikes → (peer 1, device)
  demoted mid-job; traffic re-routes to the host btl, where each
  payload gets its own per-peer seq — the dedup watermark keeps
  delivery exactly-once with no replay protocol;
* heal probes are the ONLY stage events while demoted: events 4-6 drop
  → three ``probe``/``probe_fail`` rounds re-arm the interval;
* event 7 stages clean, the receiver consumes it, and the next
  arbitration's reap promotes the pair back to healthy — the remaining
  ops ride the device plane again.

So rank 0's transition log is deterministically ``demote, (probe,
probe_fail) x3, probe, promote`` regardless of scheduling jitter, and
every op's MPI_SUM must be bit-exact against the locally computed
golden (integer-derived halves, exact in IEEE double — the devsum.c
formula, so any plane, or none, gives these bits) on BOTH sides of the
demotion boundary.

One ``PLANES_TALLY <json>`` line per rank carries completion, the
injected-fault counts, the plane-health counters, the transition log,
the host-plane dedup count, the SHA-256 of every result in op order,
and the window and memory accounting after the last op: the windows
still pending (0: a dropped stage never opened one, every consumed one
was freed) and ``torch.cuda.memory_allocated`` before the first op and
after the last (equal on the card; 0 on the CPU).
"""

import gc
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch import faultsim
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.core.errors import (
    MPIProcFailedError,
    MPIProcFailedPendingError,
    MPIRevokedError,
)
from ompi_tpu_torch.op import SUM

OPS = int(os.environ.get("PLANES_OPS", "70"))
#: doubles per op — must clear the driver's lowered
#: ``dcn_device_min_size`` so every allreduce is device-eligible
COUNT = int(os.environ.get("PLANES_COUNT", "1024"))
#: inter-op pacing: the heal interval is wall-clock, so ops must keep
#: arriving while the plane is demoted for probes to be attempted
SLEEP = float(os.environ.get("PLANES_SLEEP", "0.012"))

world = api.init()
p, n, dev = world.proc, world.size, world.device
assert n == 2, f"planes soak is an np=2 drill (got np={n})"
assert faultsim.enabled(), "faultsim_enable did not propagate"
assert world.local_size == 1, world.local_size

dp = world.dcn._root_engine()._device_plane
assert dp is not None, "device plane is not armed (dcn_device_enable?)"

idx = np.arange(COUNT, dtype=np.int64)


def rank_vec(op: int, proc: int) -> np.ndarray:
    # devsum.c's shape: integer-derived halves, exact in IEEE double —
    # so the expected MPI_SUM is computable locally and the comparison
    # across the demotion boundary is bit-exact, not approximate
    return (((idx * 2654435761 + 7919 * (proc + 1) + 104729 * (op + 1))
             % 1000003).astype(np.float64) * 0.5)


def cuda_allocated() -> int:
    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.memory_allocated(dev))


allocated_start = cuda_allocated()
digest = hashlib.sha256()
escalated = ""
completed = 0
try:
    for i in range(OPS):
        x = torch.from_numpy(rank_vec(i, p)[None]).to(dev)
        out = world.allreduce(x, SUM)[0].cpu().numpy()
        want = rank_vec(i, 0) + rank_vec(i, 1)
        assert np.array_equal(out, want), (
            f"op {i}: MPI_SUM not bit-exact across plane failover")
        digest.update(out.tobytes())
        completed = i + 1
        time.sleep(SLEEP)
    del x
    # every receiver has consumed its windows once both ranks are here
    world.barrier()
except (MPIProcFailedError, MPIProcFailedPendingError,
        MPIRevokedError) as e:
    escalated = type(e).__name__
    print(f"[planes] proc {p} escalated after {completed} ops: {e}",
          file=sys.stderr, flush=True)

deadline = time.monotonic() + 2.0
dp.reap()
while dp.pending_windows() and time.monotonic() < deadline:
    time.sleep(0.001)
    dp.reap()
st = getattr(getattr(world.dcn, "transport", None), "stats", None) or {}
plane = {k: int(dp.stats.get(k, 0)) for k in (
    "device_sends", "device_fallbacks", "device_window_reclaimed",
    "plane_demotions", "plane_promotions", "plane_heal_probes")}
tally = {
    "proc": p,
    "completed": completed,
    "ops": OPS,
    "escalated": escalated,
    "injected": faultsim.counters(),
    "plane": plane,
    "healthy": bool(dp.health.ok(1 - p)),
    "transitions": [list(t) for t in dp.health.transitions],
    "dedup_drops": int(st.get("dedup_drops", 0)),
    "device": str(dev),
    "digest": digest.hexdigest(),
    "windows_left": dp.pending_windows(),
    "cuda_allocated": [allocated_start, cuda_allocated()],
    # ring-kernel launches: none, with one rank per process
    "launches": dict(ck.LAUNCHES),
}
print("PLANES_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

if escalated:
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)

api.finalize()
print(f"OK planes proc={p}", flush=True)
