"""np≥16 hierarchical-control-plane scale soak worker (launched by
``python -m ompi_tpu_torch chaos --scale`` under ``run --ft --respawn``,
and by its ``--hosts`` relay-failover leg).

Scenario (SPMD, deterministic; every payload a float64 tensor on the
world's device — ``cuda:0``, or the CPU under ``--cpu``):

* boot rides the sharded lazy modex — each rank snapshots its
  ``KVSClient`` op counters right after ``init`` (the sub-quadratic
  boot proof: per-rank modex ``get``s must be O(1) + lazy, not P−1);
* phase 1: allreduces; the ranks named in ``SCALE_VICTIMS`` SIGKILL
  themselves before op ``SCALE_KILL_AT`` on their first incarnation —
  one injected kill per detector group, mid-collective for everyone
  else;
* survivors escape the aborted collective (revoke interrupt), then
  poll ``get_failed()`` until the detector has surfaced EVERY victim,
  recording the wall-clock instant the full failure set converged —
  the hierarchical gossip convergence the driver bounds by
  ``2 × period × ceil(log2(groups))``;
* everyone joins ``replace()`` (reborn incarnations via the rejoin
  beacon), then phase 2 runs exact full-size allreduces;
* one ``SCALE_TALLY <json>`` line per surviving process: phase
  completions, restored size, KVS op counters (boot vs total), lazy
  address resolutions, detection timestamps, transport dial counters
  (bystander-group quietness), and injected-fault counts.
"""

import json
import os
import signal
import sys
import time

import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch import faultsim
from ompi_tpu_torch.core.errors import MPIProcFailedError, MPIRevokedError
from ompi_tpu_torch.op import SUM

OPS = int(os.environ.get("SCALE_OPS", "6"))
KILL_AT = int(os.environ.get("SCALE_KILL_AT", "3"))
#: post-phase-2 idle seconds before finalize (the relay-failover leg
#: scrapes the aggregator mid-job and needs the healed mesh to live
#: long enough for post-failover telemetry frames to accumulate)
LINGER = float(os.environ.get("SCALE_LINGER", "0"))
VICTIMS = sorted(int(v) for v in
                 os.environ.get("SCALE_VICTIMS", "").split(",") if v)

world = api.init()
p, n, dev = world.proc, world.size, world.device
ctx = world.procctx
incarnation = ctx.incarnation
boot_ops = dict(ctx.kvs.ops)  # the modex op signature, pre-traffic
table = world.dcn._root_engine().addresses
boot_lazy = int(getattr(table, "lazy_resolved", 0))



def row(v: float) -> torch.Tensor:
    return torch.full((1, 4), v, dtype=torch.float64, device=dev)


victim_ranks = set()
for v in VICTIMS:
    lo, hi = world.proc_range(v)
    victim_ranks.update(range(lo, hi))

comm = world
completed = 0
t_detect_all = 0.0
if world.respawned:
    comm = world.replace()
else:
    try:
        for i in range(OPS):
            if p in VICTIMS and incarnation == 0 and i == KILL_AT:
                sys.stdout.flush()
                sys.stderr.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            out = comm.allreduce(row(i + 1.0), SUM)
            assert bool((out == n * (i + 1.0)).all()), out
            completed = i + 1
    except (MPIProcFailedError, MPIRevokedError) as e:
        print(f"[scale] proc {p} caught {type(e).__name__} after "
              f"{completed} ops", file=sys.stderr, flush=True)
        comm.revoke()
        # convergence: wait until the (hierarchically gossiped) failure
        # set covers EVERY victim (the timestamp is the soak's
        # convergence measurement) AND has settled to exactly the
        # victims — replace() requires the survivors to agree on the
        # dead set, and a scheduler-starvation false positive about a
        # LIVE rank self-heals (its heartbeats retract the mark) within
        # about one period
        while True:
            f = set(comm.get_failed())
            if victim_ranks <= f and not t_detect_all:
                t_detect_all = time.time()
            if f == victim_ranks:
                break
            time.sleep(0.002)
        comm = comm.replace()

post = 0
for i in range(OPS):
    out = comm.allreduce(row(100.0 + i), SUM)
    assert bool((out == comm.size * (100.0 + i)).all()), out
    post = i + 1

st = getattr(getattr(world.dcn, "transport", None), "stats", None) or {}
det = ctx.detector
groups = getattr(ctx, "groups", [])
my_group = next((gi for gi, g in enumerate(groups) if p in g), -1)
tally = {
    "proc": p,
    "incarnation": incarnation,
    "completed": completed,
    "post": post,
    "ops": OPS,
    "size": comm.size,
    "groups": len(groups),
    "group": my_group,
    "boot_kvs_ops": boot_ops,
    "kvs_ops": dict(ctx.kvs.ops),
    "boot_lazy": boot_lazy,
    "lazy_resolved": int(getattr(table, "lazy_resolved", 0)),
    "t_detect_all": t_detect_all,
    "respawns": int(st.get("respawns", 0)),
    "reconnects": int(st.get("reconnects", 0)),
    "retry_dials": int(st.get("retry_dials", 0)),
    "dedup_drops": int(st.get("dedup_drops", 0)),
    "detector": dict(det.counters) if det is not None else {},
    "injected": faultsim.counters() if faultsim.enabled() else {},
}
print("SCALE_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

if LINGER > 0:
    time.sleep(LINGER)
api.finalize()
print(f"OK scale proc={p} incarnation={incarnation}", flush=True)
