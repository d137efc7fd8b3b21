"""Pass 4 — the port's native code under sanitizers (ASan/UBSan, TSan,
cppcheck, and the CUDA kernels under compute-sanitizer memcheck).

Builds ``ompi_tpu_torch/csrc/dcn_sanity.cc`` — a standalone,
Python-free soak program covering the shm-ring and framed-tcp transports
(eager / chunked / rendezvous, concurrent senders, the coll stream, the
p2p matcher, stats read-back) — together with the port's
``csrc/dcn.cc``, both compiled with the leg's sanitizer flags into one
executable under ``build/ompi_tpu_torch/san-<leg>/``, then runs it.  The
engine is linked in as an object, never as ``libtpudcn.so``: an
instrumented and a plain copy of the library can then never meet in one
process, and the ASan runtime comes first in an executable of its own.

Legs:

``asan``   ``-fsanitize=address,undefined`` — heap/stack corruption,
           UB (misaligned loads, signed overflow) in the ring codecs.
``tsan``   ``-fsanitize=thread`` — the lock/atomic discipline of the
           multi-threaded engine (reader thread + senders).  Not every
           toolchain ships libtsan; a missing one is a **logged skip**
           (an ``info`` finding with the reason), never a silent pass.

Each compiler leg takes the first of ``$CXX``, ``g++`` and ``c++`` that
links its flags (a compiler wrapper in ``$CXX`` may lack the runtimes).
``cppcheck`` static C analysis of ``dcn.cc`` and the C ABI's two shims
           when the ``cppcheck`` binary exists (suppressions:
           ``cppcheck.cfg`` beside this module); otherwise a logged
           skip.
``cuda-memcheck`` the ring-hop kernels under ``compute-sanitizer
           --tool memcheck`` (:mod:`.memcheck` drives them at every
           load width and over every fold dtype and op); a logged skip
           without a card, without the tool, or where the tool refuses
           the device (its own message is the reason).

Findings: a failed build or a sanitizer report is ``error``; an
unavailable toolchain leg is ``info`` (visible in the report and the
human output, excluded from the pass/fail verdict).  Each leg's skip
reason quotes the probe failure so "it skipped" is diagnosable.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from ompi_tpu_torch.analysis.findings import SEV_ERROR, SEV_INFO, Finding
from ompi_tpu_torch.analysis.repo import PORT

PASS = "sanitize"

DCN_CC = f"{PORT}/csrc/dcn.cc"
SANITY_CC = f"{PORT}/csrc/dcn_sanity.cc"
RING_HOP_CU = f"{PORT}/csrc/ring_hop.cu"

#: (leg name, sanitizer flags appended to the compile and link line)
LEGS = (
    ("asan", "-fsanitize=address,undefined -fno-sanitize-recover=all"),
    ("tsan", "-fsanitize=thread"),
)

#: sanitizer runtime knobs: abort on first report, no odr noise from
#: the duplicate-register probe pattern
_RUN_ENV = {
    "ASAN_OPTIONS": "halt_on_error=1:abort_on_error=0:exitcode=99",
    "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
    "TSAN_OPTIONS": "halt_on_error=1:exitcode=99:second_deadlock_stack=1",
}


def _run(cmd: list[str], cwd: Path, timeout: float,
         env: dict | None = None) -> tuple[int, str]:
    e = dict(os.environ)
    if env:
        e.update(env)
    try:
        p = subprocess.run(cmd, cwd=str(cwd), env=e, timeout=timeout,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, errors="replace")
        return p.returncode, p.stdout or ""
    except subprocess.TimeoutExpired as te:
        out = te.stdout or b""
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        return 124, out + f"\n[timeout after {timeout}s]"
    except FileNotFoundError as fe:
        return 127, str(fe)


def _probe_flag(cxx: str, flags: str, tmpdir: Path) -> tuple[bool, str]:
    """Can this compiler compile AND link a trivial program with the
    sanitizer flags?  (The compile succeeds but the link fails when the
    runtime lib — e.g. libtsan — is not installed for it.)"""
    probe = tmpdir / "san_probe.cc"
    probe.write_text("int main() { return 0; }\n")
    rc, out = _run([cxx, *flags.split(), "-o", str(tmpdir / "san_probe"),
                    str(probe)], tmpdir, timeout=60)
    if rc != 0:
        tail = "; ".join(out.strip().splitlines()[-2:]) or f"rc={rc}"
        return False, tail
    return True, ""


def _compilers() -> list[str]:
    """The C++ compilers a leg may use, in order: ``$CXX`` (the engine's
    own), then ``g++`` and ``c++`` on PATH — a wrapper in ``$CXX`` may
    lack the sanitizer runtimes that the system compiler ships."""
    out: list[str] = []
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path and path not in out:
            out.append(path)
    return out


def _pick_compiler(flags: str, tmpdir: Path) -> tuple[str | None, str]:
    """The first of :func:`_compilers` that links ``flags``, or None and
    every compiler's probe failure."""
    why = []
    for cxx in _compilers():
        ok, reason = _probe_flag(cxx, flags, tmpdir)
        if ok:
            return cxx, ""
        why.append(f"{cxx}: {reason}")
    return None, "; ".join(why) or "no C++ compiler ($CXX, g++, c++) on PATH"


def _excerpt(out: str, limit: int = 700) -> str:
    """The interesting tail of a sanitizer/build log: from the first
    ERROR/WARNING marker if present, else the last lines."""
    m = re.search(r"(==\d+==\s*(ERROR|WARNING).*|runtime error:.*|"
                  r"dcn_sanity FAIL.*|=+ (Invalid|ERROR SUMMARY: [1-9]).*)",
                  out)
    text = out[m.start():] if m else out
    text = text.strip()
    return text[-limit:] if len(text) > limit else text


def _build_sanity(root: Path, cxx: str, leg: str, flags: str) -> Path:
    """The leg's soak executable, from ``dcn.cc`` and ``dcn_sanity.cc``
    compiled with the engine's flags plus ``flags``, through the port's
    locked build (rebuilt when a source is newer or the command
    differs).  Raises ``NativeBuildError`` with the compiler's output."""
    from ompi_tpu_torch import native

    out = native.BUILD_DIR / f"san-{leg}" / "dcn_sanity"
    out.parent.mkdir(parents=True, exist_ok=True)
    cxxflags = [f for f in native.CXXFLAGS if f not in ("-fPIC", "-shared")]
    srcs = [str(root / DCN_CC), str(root / SANITY_CC)]
    return native._locked_build(out, srcs, lambda tmp: [
        cxx, *cxxflags, "-g", *flags.split(), *srcs, "-o", str(tmp),
        *native.LDLIBS], stamped=True)


def _host_legs(root: Path, legs, timeout: float) -> list[Finding]:
    """The compiler legs: probe each, build the runnable ones side by
    side (one compiler per leg), then run each soak in turn."""
    from concurrent.futures import ThreadPoolExecutor

    from ompi_tpu_torch import native

    out: list[Finding] = []
    runnable = []
    probe_dir = Path(tempfile.mkdtemp(prefix="tpucheck_san_"))
    try:
        for leg, flags in legs:
            cxx, why = _pick_compiler(flags, probe_dir)
            if cxx is not None:
                runnable.append((leg, flags, cxx))
            else:
                out.append(Finding(
                    PASS, "sanitize-skip", DCN_CC, 0, leg,
                    f"{leg} leg skipped: no compiler links {flags!r} "
                    f"({why})", SEV_INFO))
    finally:
        shutil.rmtree(probe_dir, ignore_errors=True)
    with ThreadPoolExecutor(max(1, len(runnable))) as pool:
        builds = [pool.submit(_build_sanity, root, cxx, leg, flags)
                  for leg, flags, cxx in runnable]
    for (leg, flags, cxx), build in zip(runnable, builds):
        try:
            exe = build.result()
        except native.NativeBuildError as e:
            out.append(Finding(
                PASS, "sanitize-build", DCN_CC, 0, leg,
                f"{leg} build failed: {_excerpt(str(e))}", SEV_ERROR))
            continue
        rc, log = _run([str(exe)], exe.parent, timeout, env=_RUN_ENV)
        if rc != 0:
            out.append(Finding(
                PASS, "sanitize-report", DCN_CC, 0, leg,
                f"{leg} run failed (rc={rc}): {_excerpt(log)}", SEV_ERROR))
        else:
            out.append(Finding(
                PASS, "sanitize-ok", DCN_CC, 0, leg,
                f"{leg} leg clean ({flags}, {cxx}): dcn_sanity OK", SEV_INFO))
    return out


def _cppcheck_leg(root: Path, timeout: float) -> Finding:
    cppcheck = shutil.which("cppcheck")
    if cppcheck is None:
        return Finding(PASS, "sanitize-skip", DCN_CC, 0, "cppcheck",
                       "cppcheck leg skipped: no `cppcheck` binary on PATH",
                       SEV_INFO)
    csrc = root / PORT / "csrc"
    cmd = [cppcheck,
           f"--suppressions-list={Path(__file__).with_name('cppcheck.cfg')}",
           "--std=c++17", "--language=c++", "--quiet",
           "--enable=warning,portability", "--inline-suppr",
           "--error-exitcode=2", f"-I{csrc / 'capi' / 'include'}",
           str(csrc / "dcn.cc"), str(csrc / "capi" / "shim.c"),
           str(csrc / "capi" / "shmem_shim.c")]
    rc, log = _run(cmd, csrc, timeout)
    if rc != 0:
        return Finding(PASS, "sanitize-cppcheck", DCN_CC, 0, "cppcheck",
                       f"cppcheck reported (rc={rc}): {_excerpt(log)}",
                       SEV_ERROR)
    return Finding(PASS, "sanitize-ok", DCN_CC, 0, "cppcheck",
                   "cppcheck leg clean (warning,portability)", SEV_INFO)


def _cuda_leg(root: Path, timeout: float) -> Finding:
    from ompi_tpu_torch.analysis import memcheck

    status, detail = memcheck.run_leg(root, timeout)
    if status == "error":
        return Finding(PASS, "sanitize-report", RING_HOP_CU, 0,
                       "cuda-memcheck",
                       f"cuda-memcheck leg failed: {_excerpt(detail)}",
                       SEV_ERROR)
    rule = "sanitize-ok" if status == "ok" else "sanitize-skip"
    what = "clean" if status == "ok" else "skipped"
    return Finding(PASS, rule, RING_HOP_CU, 0, "cuda-memcheck",
                   f"cuda-memcheck leg {what}: {detail}", SEV_INFO)


def run(root: str | Path, files=None, legs=LEGS,
        timeout: float = 420.0) -> list[Finding]:
    """Build+run the sanitizer legs.  ``files`` accepted for symmetry
    with the other passes.  Returns error findings for real failures and info
    findings for logged skips — a toolchain hole must be visible."""
    root = Path(root)
    if not (root / SANITY_CC).exists():
        return [Finding(PASS, "sanitize-setup", SANITY_CC, 0, "",
                        "sanity soak source missing", SEV_ERROR)]
    out = _host_legs(root, legs, timeout)
    out.append(_cppcheck_leg(root, timeout))
    out.append(_cuda_leg(root, timeout))
    return out
