"""Build-on-demand loaders for the port's native libraries.

Counterpart of ``ompi_tpu/native.py`` for ``libtpudcn.so`` (the C++ byte
plane behind ``btl/native``, source ``ompi_tpu_torch/csrc/dcn.cc``), and
the one ``nvcc`` build of the port's CUDA sources (:func:`build_cuda`:
``csrc/ring_hop.cu``, ``csrc/device_window.cu``).  At first use it compiles the source
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
import hashlib
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


#: nvcc flags of every CUDA source: sm_90a code with a plain C interface
#: (no PyTorch headers), bound with ctypes; ``-Xptxas -v`` keeps the
#: register and spill report in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise NativeBuildError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def build_cuda(src: Path) -> tuple[Path, str]:
    """Compile one CUDA source into ``build/ompi_tpu_torch/lib<stem>-<tag>.so``
    once per source content and flags; returns the library's path and
    the compiler's report (empty when the library was already built).
    File-locked and renamed into place, like :func:`build`, so the
    processes of a job that start at once build it once."""
    src = Path(src)
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out, ""
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"nvcc failed ({res.returncode}) on {src}:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    return out, res.stderr
