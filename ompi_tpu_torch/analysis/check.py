"""``python -m ompi_tpu_torch check`` — the port's tpucheck command, with
the flags, output lines and exit codes of the reference's
``tools/check.py``.

Usage::

    # the contract gate: invariant linter + lock-order analyzer + ABI
    # drift checker, waivers applied, exit 1 on unwaived errors
    python -m ompi_tpu_torch check

    # machine-readable findings report (JSON schema v1)
    python -m ompi_tpu_torch check --json /tmp/tpucheck.json

    # pre-commit: skip the docs/tests --mca reference walk
    python -m ompi_tpu_torch check --fast

    # the native code under ASan/UBSan + TSan (+ cppcheck when present,
    # + the ring-hop kernels under compute-sanitizer on a card);
    # toolchain holes are LOGGED skips, never silent passes
    python -m ompi_tpu_torch check --sanitize

    # one pass only (repeatable)
    python -m ompi_tpu_torch check --pass lockorder

    # seeded-fixture + live-tree self-check: every pass must flag its
    # seeded violation and the port's tree must be clean modulo its
    # reviewed waivers
    python -m ompi_tpu_torch check --selftest

Exit codes: 0 clean, 1 unwaived errors (or a failed selftest), 2 a bad
waiver file.  Stdlib-only apart from the sanitize pass's builds; never
imports the modules under analysis.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ompi_tpu_torch.analysis import PASS_NAMES, Report, apply_waivers, load_waivers, run_pass
from ompi_tpu_torch.analysis.findings import SEV_ERROR, SEV_INFO
from ompi_tpu_torch.analysis.selftest import WAIVERS

REPO_ROOT = Path(__file__).resolve().parents[2]
STATIC_PASSES = ("invariants", "lockorder", "abidrift")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch check",
        description="tpucheck on the port: repo-native static analysis")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_NAMES, default=None,
                    help="run only this pass (repeatable)")
    ap.add_argument("--fast", action="store_true",
                    help="pre-commit mode: skip the docs/tests --mca "
                         "reference walk")
    ap.add_argument("--sanitize", action="store_true",
                    help="also build+run the sanitizer legs "
                         "(ASan/UBSan, TSan, cppcheck, cuda-memcheck)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable findings report")
    ap.add_argument("--waivers", metavar="PATH",
                    help=f"waiver file (default: <root>/{WAIVERS})")
    ap.add_argument("--no-waivers", action="store_true",
                    help="ignore the waiver file (show everything)")
    ap.add_argument("--selftest", action="store_true",
                    help="seeded-fixture + live-tree self-check")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    if args.selftest:
        from ompi_tpu_torch.analysis.selftest import run_selftest

        ok, log = run_selftest(root)
        for line in log:
            print(line)
        print("selftest", "OK" if ok else "FAILED")
        return 0 if ok else 1

    passes = list(args.passes or STATIC_PASSES)
    if args.sanitize and "sanitize" not in passes:
        passes.append("sanitize")

    report = Report(str(root))
    for name in passes:
        kw = {}
        if name == "invariants" and args.fast:
            kw["mca_docs"] = False
        report.extend(name, run_pass(name, root, **kw))

    if not args.no_waivers:
        wpath = Path(args.waivers) if args.waivers else root / WAIVERS
        try:
            waivers = load_waivers(wpath)
        except ValueError as e:
            print(f"check: bad waiver file: {e}", file=sys.stderr)
            return 2
        report.findings = apply_waivers(
            report.findings, waivers,
            waiver_file=str(wpath.relative_to(root))
            if wpath.is_relative_to(root) else str(wpath),
            # --fast skips the docs walk, so waivers against doc-walk
            # findings would read stale; staleness is a full-run check
            passes_run=[] if args.fast else report.passes_run)

    if args.json:
        report.write_json(args.json)

    infos = [f for f in report.findings if f.severity == SEV_INFO]
    for f in report.findings:
        if f.severity != SEV_INFO:
            print(f.render())
    for f in infos:
        print(f.render())
    errors = report.unwaived(SEV_ERROR)
    waived = sum(1 for f in report.findings if f.waived)
    print(f"tpucheck: {len(report.passes_run)} pass(es) "
          f"[{', '.join(report.passes_run)}], "
          f"{len(report.findings)} finding(s), {waived} waived, "
          f"{len(errors)} unwaived error(s)")
    return 1 if errors else 0
