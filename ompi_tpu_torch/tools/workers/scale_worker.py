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
  (bystander-group quietness), injected-fault counts, the device, the
  ring-kernel launches (none, with one rank per process), the card's
  allocated bytes and the boot split (interpreter start, ``import
  torch``, the port's imports, the CUDA context, ``api.init``).

The detection timestamps name where a late convergence stamp came
from: ``t_boot`` (the detector was built), ``t_caught`` (the survivor
left the aborted collective), ``t_seen`` (per victim, the instant it
first entered this process's failure set, and the path that put it
there — taken from a wrapper around the detector's ``mark_failed``)
and ``t_detect_all`` (every victim seen: the soak's convergence
stamp).  All are wall-clock seconds.
"""

import time

T_START = time.time()

import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

T_TORCH = time.time()

import ompi_tpu_torch.api as api  # noqa: E402
from ompi_tpu_torch import faultsim  # noqa: E402
from ompi_tpu_torch.boot.proc import ENV_DEVICE  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as ck  # noqa: E402
from ompi_tpu_torch.core.errors import (  # noqa: E402
    MPIProcFailedError,
    MPIRevokedError,
)
from ompi_tpu_torch.op import SUM  # noqa: E402

T_PORT = time.time()
OPS = int(os.environ.get("SCALE_OPS", "6"))
KILL_AT = int(os.environ.get("SCALE_KILL_AT", "3"))
#: post-phase-2 idle seconds before finalize (the relay-failover leg
#: scrapes the aggregator mid-job and needs the healed mesh to live
#: long enough for post-failover telemetry frames to accumulate)
LINGER = float(os.environ.get("SCALE_LINGER", "0"))
VICTIMS = sorted(int(v) for v in
                 os.environ.get("SCALE_VICTIMS", "").split(",") if v)


def process_start() -> float:
    """Wall-clock instant the kernel started this process (``0.0``
    where ``/proc`` does not say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime "))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return 0.0


# the CUDA context comes up here, on its own clock, unless the soak runs
# on the CPU; api.init then finds it ready
if os.environ.get(ENV_DEVICE) != "cpu":
    torch.empty(1, device="cuda")
T_CUDA = time.time()
world = api.init()
T_INIT = time.time()
p, n, dev = world.proc, world.size, world.device
ctx = world.procctx
_t0 = process_start()
boot = {"interpreter_s": round(T_START - _t0, 4) if _t0 else None,
        "import_torch_s": round(T_TORCH - T_START, 4),
        "import_port_s": round(T_PORT - T_TORCH, 4),
        "cuda_init_s": round(T_CUDA - T_PORT, 4),
        "api_init_s": round(T_INIT - T_CUDA, 4)}
incarnation = ctx.incarnation
boot_ops = dict(ctx.kvs.ops)  # the modex op signature, pre-traffic
table = world.dcn._root_engine().addresses
boot_lazy = int(getattr(table, "lazy_resolved", 0))


def row(v: float) -> torch.Tensor:
    return torch.full((1, 4), v, dtype=torch.float64, device=dev)


def cuda_allocated() -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return int(torch.cuda.memory_allocated(dev))


#: per victim proc: when it first entered this process's failure set
#: and by which path (the detector's ``how``)
seen: dict[str, dict] = {}
det = ctx.detector
if det is not None:
    _mark = det.mark_failed

    def _traced_mark(proc, *args, **kw):
        newly = _mark(proc, *args, **kw)
        if newly and str(proc) not in seen:
            seen[str(proc)] = {"t": time.time(),
                               "how": kw.get("how", "engine")}
        return newly

    det.mark_failed = _traced_mark


victim_ranks = set()
for v in VICTIMS:
    lo, hi = world.proc_range(v)
    victim_ranks.update(range(lo, hi))

comm = world
completed = 0
t_detect_all = 0.0
t_caught = 0.0
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
        t_caught = time.time()
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
    "t_boot": getattr(det, "t_boot", 0.0),
    "period": getattr(det, "period", 0.0),
    "t_caught": t_caught,
    "t_seen": {v: seen[v] for v in sorted(seen, key=int)
               if int(v) in VICTIMS},
    "respawns": int(st.get("respawns", 0)),
    "reconnects": int(st.get("reconnects", 0)),
    "retry_dials": int(st.get("retry_dials", 0)),
    "dedup_drops": int(st.get("dedup_drops", 0)),
    "detector": dict(det.counters) if det is not None else {},
    "injected": faultsim.counters() if faultsim.enabled() else {},
    "device": str(dev),
    # ring-kernel launches: none, with one rank per process
    "launches": dict(ck.LAUNCHES),
    "cuda_allocated": cuda_allocated(),
    "boot": boot,
}
print("SCALE_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

if LINGER > 0:
    time.sleep(LINGER)
api.finalize()
print(f"OK scale proc={p} incarnation={incarnation}", flush=True)
