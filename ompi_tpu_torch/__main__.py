"""CLI: ``python -m ompi_tpu_torch <command>``.

Commands:
  info    — frameworks/components/vars dump (≈ ompi_info); ``--parsable``
  run     — job launcher (≈ mpirun); see ``run --help``
  tpud    — persistent serving daemon (resident workers, warm job worlds);
            ``tpud -np 2 --nranks 4 [--cpu]``, see ``tpud --help``
  ctl     — ops CLI for a running daemon: submit|status|drain|shutdown|scale,
            ``--selftest``; see ``ctl --help``
  mpicc   — compile a stock MPI C program against the port's libtpumpi:
            ``mpicc prog.c [-o out] [gcc flags]`` (default out:
            build/ompi_tpu_torch/bin/<stem>); run it with ``run``
  check   — tpucheck over the port's tree (invariants, lockorder,
            abidrift; ``--sanitize``, ``--selftest``); see ``check --help``
  chaos   — the seeded fault soaks (np=2 framed TCP, ``--planes``,
            ``--respawn``, ``--daemon-restart``, ``--kill-in-repair``,
            ``--traffic``, ``--scale``, ``--hosts``; ``--selftest``); every
            process on cuda:0 unless ``--cpu``; see ``chaos --help``
  metrics-report — per-process tables, the stall-cause breakdown and
            ``--correlate`` over the metrics exports (``--selftest``)
  trace-report   — summary, ``--merge-out``, ``--critical-path`` and
            ``--hangs`` over the trace exports (``--selftest``)
  top     — dashboard over a live job's telemetry ``/json``:
            ``top --url URL [--once]`` (``--selftest``)
"""

from __future__ import annotations

import sys

#: the operator tools: command → module of ``ompi_tpu_torch.tools``
TOOLS = {"chaos": "chaos", "metrics-report": "metrics_report",
         "trace-report": "trace_report", "top": "top"}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = sys.argv[1], sys.argv[2:]
    if cmd == "info":
        from ompi_tpu_torch.core.info import main as info_main

        return info_main(rest)
    if cmd in ("run", "tpurun"):
        from ompi_tpu_torch.boot.tpurun import main as run_main

        return run_main(rest)
    if cmd == "tpud":
        from ompi_tpu_torch.serve.tpud import main as tpud_main

        return tpud_main(rest)
    if cmd == "ctl":
        from ompi_tpu_torch.serve.ctl import main as ctl_main

        return ctl_main(rest)
    if cmd == "mpicc":
        from ompi_tpu_torch.native import mpicc_main

        return mpicc_main(rest)
    if cmd == "check":
        from ompi_tpu_torch.analysis.check import main as check_main

        return check_main(rest)
    if cmd in TOOLS:
        import importlib

        return importlib.import_module(
            f"ompi_tpu_torch.tools.{TOOLS[cmd]}").main(rest)
    print(f"unknown command {cmd!r}; try 'info', 'run', 'tpud', 'ctl', 'mpicc', "
          "'check', 'chaos', 'metrics-report', 'trace-report' or 'top'",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
