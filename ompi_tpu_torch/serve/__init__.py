"""Persistent serving plane — ``tpud`` (≈ orted/prted).

Port of ``ompi_tpu/serve``.  A plain ``run`` boots a full world per
invocation — rendezvous, endpoint dials, engine threads, CUDA context —
and tears it down at exit.  This package keeps that world warm across
jobs:

* :mod:`~ompi_tpu_torch.serve.daemon` — ``TpuDaemon``: hosts the boot
  KVS and the live-telemetry aggregator (its HTTP endpoint doubles as
  the ops surface: submit/status/drain/shutdown/scale), spawns N
  **resident** rank workers, gang-schedules a multi-tenant job queue
  onto them (:mod:`~ompi_tpu_torch.serve.queue`), and fires the
  elastic plane itself — a dead worker is respawned and restored via
  ``replace()``, ``/scale`` retires ranks.  The daemon holds no tensors
  and never creates a CUDA context;
* :mod:`~ompi_tpu_torch.serve.worker` — the resident rank loop: boot
  once on the card (or on the CPU when the daemon was started with
  ``--cpu``), then serve jobs; each job gets a disjoint CID block and a
  fresh ``MPI_COMM_WORLD``-equivalent carved from the warm mesh with
  **zero traffic and zero re-dials**, runs its script in-process
  (``api.init()`` inside the script returns the job world, its
  ``finalize()`` re-arms instead of tearing down), and reports a
  completion record;
* :mod:`~ompi_tpu_torch.serve.agent` — the per-host launch agent;
* :mod:`~ompi_tpu_torch.serve.state` — the pidfile and the job-stream
  journal (crash safety);
* :mod:`~ompi_tpu_torch.serve.client` — the attach-to-daemon HTTP client
  (``ompi_tpu_torch.api.tpud_submit`` and ``python -m ompi_tpu_torch
  ctl`` ride it).

Start one with ``python -m ompi_tpu_torch tpud -np N --nranks K`` (add
``--cpu`` to run the workers on the CPU) or ``python -m ompi_tpu_torch
run --daemon -np N``; knobs live in the centrally registered
``SERVING_VARS`` (``core/var.py``).
"""

from __future__ import annotations

#: the job record the resident worker is currently serving (None when
#: idle) — job scripts can introspect it via :func:`current_job`
_current: dict | None = None


def current_job() -> dict | None:
    """The job descriptor this process is serving right now (tenant,
    id, cid_base, args) — None outside a served job."""
    return _current


def _set_current(job: dict | None) -> None:
    global _current
    _current = job
