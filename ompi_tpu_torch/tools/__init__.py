"""The port's operator tools, each ``python -m ompi_tpu_torch <name>``
and ``python -m ompi_tpu_torch.tools.<module>``:

* ``chaos`` (:mod:`.chaos`) — the seeded fault-injection soaks (framed
  TCP, device-plane failover, respawn, daemon restart, crash mid-repair,
  multi-tenant traffic, np ≥ 16 scale, emulated hosts) and their
  in-process self-checks;
* ``metrics-report`` (:mod:`.metrics_report`) — per-process counter
  tables, the stall-cause breakdown and ``--correlate`` over the metrics
  exports;
* ``trace-report`` (:mod:`.trace_report`) — summary, ``--merge-out``,
  ``--critical-path`` and ``--hangs`` over the Chrome trace exports;
* ``top`` (:mod:`.top`) — the dashboard over a live job's ``/json``.

Ports of the reference's ``tools/`` modules of the same names: the same
flags, defaults, tables and tally lines, so one runbook serves both.
The soaks' workers live in :mod:`.workers`.
"""

from __future__ import annotations

from pathlib import Path

#: the checkout's root (the package's parent)
REPO = Path(__file__).resolve().parent.parent.parent
#: the golden fixtures the report tools' self-checks hold their solvers to
GOLDEN = REPO / "tests" / "golden"
