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
  golden-capture — the reference library's golden fold vectors from Open
            MPI 4.1.4's libmpi (``--out``, default
            build/ompi_tpu_torch/golden/reduce_local.json)
  bench-algos    — coll/base's seven algorithm families at n = 8, µs per
            call at a small and a large payload (``ALGOS8``); ``--cpu``,
            ``--check``
  bench-hostpath — numpy in, numpy out through ``allreduce`` at 64 KiB,
            1 MiB and 16 MiB per rank with the arena's counters, and the
            n = 8 non-blocking overlap (``HOSTPATH8``); ``--cpu``, ``--check``
  bench-dispatch-floor — the C-ABI per-op floor (``dispatch_floor.c``,
            built with ``mpicc``) against the Python API's at 8 B … 4 KiB,
            np 1 and 2, and the persistent replay rate (``DISPATCHFLOOR``);
            ``--cpu``, ``--iters``, ``--py-iters``
  bench-dcn      — np=2 ping-pong and han's allreduce, median and p90, over
            btl native, tcp and sm (``DCNBENCH_ALL``); ``--cpu``
  bench-device-plane — np=2 osu_bw and allreduce with the device plane on
            and off, its arbitration counters checked (``DEVBENCH_ALL``); ``--cpu``
  bench   — the framework against a raw torch primitive (``bench.py``'s
            port): the osu_allreduce sweep to 1 GiB per rank, the blocking
            suite, barrier, persistent, gather/scatter, the overlap and
            host-path rows, then the nine joins; detail in
            build/ompi_tpu_torch/BENCH_DETAIL.json, the headline as the last
            line; ``--cpu``, ``--check``, ``--no-subproc``, ``--max-bytes``
            (see ``bench --help``)
  (the workers are ``run`` targets: ``run -np 1 --nranks 1 [--cpu]
   ompi_tpu_torch/tools/bench_pyapi.py``, and ``run -np 2 --nranks 1 [--cpu]``
   of ``bench_dispatch_floor.py``, ``bench_dcn.py``, ``bench_device_plane.py``)
"""

from __future__ import annotations

import sys

#: the operator tools: command → module of ``ompi_tpu_torch.tools``
#: (``module:function`` where the entry point is not ``main``)
TOOLS = {"chaos": "chaos", "metrics-report": "metrics_report",
         "trace-report": "trace_report", "top": "top",
         "golden-capture": "golden_capture", "bench-algos": "bench_algos",
         "bench-hostpath": "bench_hostpath",
         "bench-dispatch-floor": "bench_joins:dispatch_floor_main",
         "bench-dcn": "bench_joins:dcn_main",
         "bench-device-plane": "bench_joins:device_plane_main",
         "bench": "bench"}


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

        module, _, entry = TOOLS[cmd].partition(":")
        return getattr(importlib.import_module(f"ompi_tpu_torch.tools.{module}"),
                       entry or "main")(rest)
    print(f"unknown command {cmd!r}; try 'info', 'run', 'tpud', 'ctl', 'mpicc', "
          "'check', 'chaos', 'metrics-report', 'trace-report', 'top', "
          "'golden-capture', 'bench-algos', 'bench-hostpath', "
          "'bench-dispatch-floor', 'bench-dcn', 'bench-device-plane' or 'bench'",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
