"""Native-plane sharded-modex boot worker (the modex leg of ``python -m
ompi_tpu_torch chaos --hosts``).

Boots on whatever transport the ``btl`` var picked, runs two
allreduces (first sends force lazy cross-group address resolution),
and prints one ``MODEX_TALLY <json>`` line carrying the new
``addr_installs`` / ``addr_lazy_resolved`` native counters plus the
Python-side AddressTable signature — the proof that a native boot now
does ≤ group-size eager installs instead of P−1 — and the rank's device,
ring-kernel launches and allocated card bytes.
"""

import json

import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.metrics import core as mcore
from ompi_tpu_torch.op import SUM

world = api.init()
p, n = world.proc, world.size
ctx = world.procctx
table = world.dcn._root_engine().addresses
boot_installs = {k: int(v) for k, v in (mcore.native_counters()
                                        or {}).items()
                 if k in ("addr_installs", "addr_lazy_resolved")}

for i in range(2):
    out = world.allreduce(torch.full((world.local_size, 2), i + 1.0,
                                     dtype=torch.float64,
                                     device=world.device), SUM)
    assert float(out[0][0]) == (i + 1) * n, (i, out)

counters = mcore.native_counters() or {}
tally = {
    "proc": p,
    "nprocs": world.nprocs,
    "plane": ("native" if world.dcn._root_engine().address.startswith(
        "ntv:") else "python"),
    "addr_installs": int(boot_installs.get("addr_installs", 0)),
    "addr_lazy_resolved": int(counters.get("addr_lazy_resolved", 0)),
    "table_lazy": int(getattr(table, "lazy_resolved", 0)),
    "kvs_gets": int(ctx.kvs.ops.get("get", 0)),
    "device": str(world.device),
    # ring-kernel launches: none, with one rank per process
    "launches": dict(ck.LAUNCHES),
    "cuda_allocated": (int(torch.cuda.memory_allocated(world.device))
                       if world.device.type == "cuda" else 0),
}
print("MODEX_TALLY " + json.dumps(tally, sort_keys=True), flush=True)

api.finalize()
print(f"OK modex proc={p}", flush=True)
