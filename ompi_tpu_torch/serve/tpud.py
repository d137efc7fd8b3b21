"""tpud — start the persistent serving daemon (``python -m ompi_tpu_torch tpud``).

Port of the reference's ``tools/tpud.py``.  Boots N resident rank
workers whose CUDA contexts, DCN endpoints (both planes) and boot KVS
stay warm across jobs, and serves a multi-tenant gang-scheduled job
queue with telemetry-driven admission control on the live aggregator's
HTTP endpoint (printed at start):

    python -m ompi_tpu_torch tpud -np 2 --nranks 4
    python -m ompi_tpu_torch ctl --url http://... submit my_job.py
    python -m ompi_tpu_torch ctl --url http://... shutdown

The workers run on CUDA and raise without a card; ``--cpu`` runs them on
the CPU (the counterpart of the reference's ``--cpu-devices``, whose
device count is ``--nranks`` here).  ``--mca accelerator_cuda_layout
devices`` gives every rank of every worker a buffer on its own card, as
under ``run``; the daemon hands its ``--mca`` options to every worker it
spawns or respawns.  Equivalent to ``python -m
ompi_tpu_torch run --daemon``; knobs are the ``serve_*`` MCA vars
(``SERVING_VARS`` in ``core/var.py``).  ``--mca serve_pidfile <path>``
arms the crash-safe control plane: stale-lock takeover, a journaled job
stream, and worker re-adoption across daemon restarts.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch tpud",
        description="persistent ompi_tpu_torch serving daemon (warm mesh, "
                    "multi-tenant job queue)")
    ap.add_argument("-np", type=int, required=True,
                    help="resident rank-worker count")
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"),
                    help="MCA parameter (repeatable), e.g. --mca "
                         "serve_max_pending 4")
    ap.add_argument("--nranks", type=int, default=None,
                    help="virtual ranks per worker (accelerator_cuda_nranks)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the workers' ranks on the CPU (default: CUDA, "
                         "raising where there is none)")
    ap.add_argument("--port", type=int, default=None,
                    help="ops/scrape HTTP port (default: serve_port "
                         "var; 0 = ephemeral)")
    ap.add_argument("--max-respawns", type=int, default=2,
                    help="respawn budget per rank (elastic scale-up "
                         "restore; default 2)")
    ns = ap.parse_args(argv)
    from ompi_tpu_torch.serve.daemon import run_daemon

    return run_daemon(ns.np, mca={k: v for k, v in ns.mca},
                      nranks=ns.nranks, cpu=ns.cpu,
                      max_respawns=ns.max_respawns, http_port=ns.port)


if __name__ == "__main__":
    sys.exit(main())
