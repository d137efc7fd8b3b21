"""Serve-bench job: launch→first-collective, the daemon's reason to
exist as a measured number.  The port's counterpart of the reference's
``tools/bench_serve_job.py``; runs unchanged in both legs of the
warm-vs-cold comparison:

* **cold** — ``python -m ompi_tpu_torch run -np 2 --nranks 4
  ompi_tpu_torch/examples/serve_firstcoll.py`` (full boot: ``import
  torch``, CUDA context, rendezvous, endpoint dials, engine threads
  before the collective);
* **warm** — submitted to a resident ``tpud`` (``api.init()`` returns
  the job communicator carved from the already-booted mesh).

Prints one ``FIRSTCOLL ns=<wallclock>`` line per process after the first
allreduce has completed on its device; the caller subtracts its own
submit/spawn timestamp (same host, same clock).
"""

import time

import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM

world = api.init()
x = torch.ones((world.local_size, 8), device=world.device)
out = world.allreduce(x, SUM)
if world.device.type == "cuda":
    torch.cuda.synchronize(world.device)
t = time.time_ns()
assert float(np.asarray(out.cpu())[0][0]) == float(world.size), out
print(f"FIRSTCOLL ns={t} proc={world.proc} size={world.size}", flush=True)
api.finalize()
