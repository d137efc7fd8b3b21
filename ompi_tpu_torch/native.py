"""Build-on-demand loader for the port's native host data plane.

Counterpart of ``ompi_tpu/native.py`` for one library, ``libtpudcn.so``
(the C++ byte plane behind ``btl/native``, source
``ompi_tpu_torch/csrc/dcn.cc``).  At first use it compiles the source
with ``$CXX`` (or ``g++``) into ``build/ompi_tpu_torch/libtpudcn.so``
with the flags of the reference's ``native/Makefile``; a later use
rebuilds only when the source is newer than the library.  The build
holds a file lock and writes under a temporary name that is renamed
into place, so processes that start at once (test workers, the ranks
of a job) build it once and never load a half-written file.

The library is loaded with ``ctypes.CDLL``'s default ``RTLD_LOCAL``:
the reference's own ``libtpudcn.so`` exports the same symbols, and a
process that loads both (the parity tests) must keep them apart.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "dcn.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "ompi_tpu_torch"
LIB = BUILD_DIR / "libtpudcn.so"
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-shared", "-std=c++17")
LDLIBS = ("-lpthread", "-lrt")


class NativeBuildError(RuntimeError):
    """The C++ source could not be compiled (or no compiler exists)."""


def compiler() -> str | None:
    """The C++ compiler the build uses: ``$CXX``, else ``g++``."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def _stale() -> bool:
    return not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime


def build() -> Path:
    """Compile ``csrc/dcn.cc`` when the library is missing or older than
    the source; returns the library's path."""
    if not _stale():
        return LIB
    cxx = compiler()
    if cxx is None:
        raise NativeBuildError(
            f"no C++ compiler ({os.environ.get('CXX') or 'g++'}) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtpudcn.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while we waited
            return LIB
        tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
        res = subprocess.run(
            [cxx, *CXXFLAGS, str(SRC), "-o", str(tmp), *LDLIBS],
            capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{cxx} failed ({res.returncode}) on {SRC}:\n"
                f"{res.stderr[-4000:]}")
        os.replace(tmp, LIB)
    return LIB
