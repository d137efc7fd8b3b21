"""``run --ft`` chaos soak worker: collectives + rendezvous bursts
under a seeded fault plan (launched by ``python -m ompi_tpu_torch
chaos``).

The driver passes ``--mca faultsim_enable 1 faultsim_seed N
faultsim_plan <plan>`` plus short ``dcn_*_timeout`` values and a small
``btl_tcp_eager_limit`` (so the p2p bursts take the RTS/CTS/FRAG
rendezvous path) on the framed-TCP transport (``--mca btl tcp``).
Every payload is a float64 tensor on the world's device (``cuda:0``, or
the CPU under ``--cpu``), the same bytes the reference's worker sends as
numpy arrays.

Contract asserted by the driver on this worker's output:

* every rank EITHER completes all its operations among survivors OR
  raises ``MPIProcFailedError``/``MPIRevokedError`` within the
  configured deadlines — never a bare RuntimeError, never a hang (the
  driver's subprocess timeout is the hang detector);
* one ``CHAOS_TALLY <json>`` line per rank: per-kind injected-fault
  counts (identical across runs of the same seed — the decisions are
  counter-hashed, heartbeats exempt), transport self-healing counters
  (reconnects / retry_dials / retry_sends / deadline_expired),
  completed-op count, the escalation class if any, and the device the
  rank ran on.

Ranks always exit 0: an escalation is a *survived, reported* outcome,
not a crash.  Escalated ranks leave via ``os._exit`` after the tally —
their world is poisoned and a finalize barrier against a peer that
already escalated could itself deadline out.
"""

import json
import os
import sys

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

OPS = int(os.environ.get("CHAOS_OPS", "24"))
#: p2p burst payload — must exceed the driver's eager limit so the
#: burst exercises the rendezvous (RTS/CTS/FRAG) protocol under faults
RNDV_BYTES = int(os.environ.get("CHAOS_RNDV_BYTES", str(96 * 1024)))

world = api.init()
p, n, dev = world.proc, world.size, world.device
assert faultsim.enabled(), "faultsim_enable did not propagate"
assert world.local_size == 1, world.local_size

payload = torch.ones(RNDV_BYTES // 8, dtype=torch.float64, device=dev)
escalated = ""
completed = 0
try:
    for i in range(OPS):
        out = world.allreduce(
            torch.full((1, 4), i + 1.0, dtype=torch.float64, device=dev), SUM)
        # among survivors the value is exact; after a silent drop the
        # op raises before producing — never silently wrong
        assert tuple(out.shape) == (1, 4), out
        assert bool((out == n * (i + 1.0)).all()), out
        if n == 2 and i % 3 == 0:
            if p == 0:
                world.send(payload * (i + 1), source=0, dest=1, tag=100 + i)
                got, _st = world.recv(dest=0, source=1, tag=200 + i)
            else:
                got, _st = world.recv(dest=1, source=0, tag=100 + i)
                assert float(got[0]) == i + 1, (got[0], i)
                world.send(payload * (i + 1), source=1, dest=0, tag=200 + i)
        completed = i + 1
except (MPIProcFailedError, MPIProcFailedPendingError,
        MPIRevokedError) as e:
    escalated = type(e).__name__
    print(f"[chaos] proc {p} escalated after {completed} ops: {e}",
          file=sys.stderr, flush=True)

st = getattr(getattr(world.dcn, "transport", None), "stats", None) or {}
tally = {
    "proc": p,
    "completed": completed,
    "ops": OPS,
    "escalated": escalated,
    "injected": faultsim.counters(),
    "reconnects": int(st.get("reconnects", 0)),
    "retry_dials": int(st.get("retry_dials", 0)),
    "retry_sends": int(st.get("retry_sends", 0)),
    "deadline_expired": int(st.get("deadline_expired", 0)),
    "dedup_drops": int(st.get("dedup_drops", 0)),
    "device": str(dev),
    # ring-kernel launches: none, with one rank per process
    "launches": dict(ck.LAUNCHES),
}
print("CHAOS_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

if escalated:
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)

api.finalize()
print(f"OK chaos proc={p}", flush=True)
