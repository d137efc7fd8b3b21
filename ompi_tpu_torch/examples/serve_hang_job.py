"""tpud job script for the hang-diagnosis acceptance — the port's
counterpart of the reference's ``tests/workers/serve_hang_job.py``.

Rank 1's bulk send rides the shared-memory ring (``--mca btl sm`` with
a lowered ``btl_sm_shm_threshold``), where a faultsim
``stall:ms=...;proc=1`` plan wedges the write for longer than
``serve_job_deadline_s``; rank 0 blocks in the matching recv.  The hang
diagnosis must name the same (rank 1, p2p_recv, peer 1) root on all
three surfaces: the live ``/waitgraph``, the revoked job's
``/job/<id>`` hang report, and the crash export the revoke path
flushes.
"""

import numpy as np

import ompi_tpu_torch.api as api

world = api.init()
p = world.proc
src = world.proc_range(1)[0]
dst = world.proc_range(0)[0]
if p == 0:
    payload, _st = world.recv(dst, source=src, tag=11)
else:
    # >= shm_threshold so the send takes the ring (the stalled path)
    world.send(np.ones(65536), source=src, dest=dst, tag=11)
print(f"OK HANG_JOB proc={p}", flush=True)
api.finalize()
