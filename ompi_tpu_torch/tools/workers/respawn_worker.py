"""``run --ft --respawn`` soak worker: rank death mid-job, full-size
recovery (launched by ``python -m ompi_tpu_torch chaos --respawn``).

Scenario (SPMD, deterministic; every payload a float64 tensor on the
world's device — ``cuda:0``, or the CPU under ``--cpu``):

* phase 1: every rank runs ``RESPAWN_OPS`` allreduces; rank
  ``RESPAWN_VICTIM`` SIGKILLs itself before op ``RESPAWN_KILL_AT`` on
  its FIRST incarnation (the external-kill analog, mid-collective for
  the survivors);
* survivors catch ``MPIProcFailedError``, ``revoke()`` the world, and
  call ``replace()`` — which awaits the launcher's respawn, installs
  the reborn endpoint, clears the failure marks, and rebuilds the
  communicator at FULL size;
* the reborn incarnation sees ``world.respawned`` and calls
  ``replace()`` right after init, joining the survivors' rendezvous;
* phase 2: everyone runs ``RESPAWN_OPS`` more allreduces on the
  replaced comm and asserts the results are exact at the restored
  size — the golden check that the job really is back to full
  strength, not shrunk.

One ``RESPAWN_TALLY <json>`` line per surviving process (the victim's
first incarnation dies tally-less by design): incarnation, phase
completions, the replaced comm's size, the ``respawns`` transport
counter, the per-kind injected-fault counts (for the --runs N same-seed
determinism diff when a fault plan is armed), and the device the
incarnation ran on.
"""

import json
import os
import signal
import sys

import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch import faultsim
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.core.errors import MPIProcFailedError, MPIRevokedError
from ompi_tpu_torch.op import SUM

OPS = int(os.environ.get("RESPAWN_OPS", "8"))
KILL_AT = int(os.environ.get("RESPAWN_KILL_AT", "4"))
VICTIM = int(os.environ.get("RESPAWN_VICTIM", "1"))

world = api.init()
p, n, dev = world.proc, world.size, world.device
incarnation = world.procctx.incarnation
assert world.local_size == 1, world.local_size


def row(v: float) -> torch.Tensor:
    return torch.full((1, 4), v, dtype=torch.float64, device=dev)


comm = world
completed = 0
recovered = False
if world.respawned:
    # reborn leg: rejoin the survivors' rendezvous before any traffic
    comm = world.replace()
    recovered = True
else:
    try:
        for i in range(OPS):
            if p == VICTIM and incarnation == 0 and i == KILL_AT:
                sys.stdout.flush()
                sys.stderr.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            out = comm.allreduce(row(i + 1.0), SUM)
            assert bool((out == n * (i + 1.0)).all()), out
            completed = i + 1
    except (MPIProcFailedError, MPIRevokedError) as e:
        print(f"[respawn] proc {p} caught {type(e).__name__} after "
              f"{completed} ops: {e}", file=sys.stderr, flush=True)
        comm.revoke()
        comm = comm.replace()
        recovered = True

# phase 2: the restored FULL-size membership must produce exact results
post = 0
for i in range(OPS):
    out = comm.allreduce(row(100.0 + i), SUM)
    assert bool((out == comm.size * (100.0 + i)).all()), out
    post = i + 1

st = getattr(getattr(world.dcn, "transport", None), "stats", None) or {}
tally = {
    "proc": p,
    "incarnation": incarnation,
    "completed": completed,
    "post": post,
    "ops": OPS,
    "recovered": recovered,
    "size": comm.size,
    "respawns": int(st.get("respawns", 0)),
    "dedup_drops": int(st.get("dedup_drops", 0)),
    "reconnects": int(st.get("reconnects", 0)),
    "injected": faultsim.counters() if faultsim.enabled() else {},
    "device": str(out.device),
    # ring-kernel launches: none, with one rank per process
    "launches": dict(ck.LAUNCHES),
}
print("RESPAWN_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

api.finalize()
print(f"OK respawn proc={p} incarnation={incarnation}", flush=True)
