"""CLI: ``python -m ompi_tpu_torch <command>``.

Commands:
  info    — frameworks/components/vars dump (≈ ompi_info); ``--parsable``
  run     — job launcher (≈ mpirun); see ``run --help``
"""

from __future__ import annotations

import sys


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
    print(f"unknown command {cmd!r}; try 'info' or 'run'", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
