"""Build-on-demand loaders for the port's native libraries.

Counterpart of ``ompi_tpu/native.py`` and ``native/Makefile`` for the
port's own sources (nothing under ``native/`` is built, read as a
library, or written):

* ``libtpudcn.so`` — the C++ byte plane behind ``btl/native``
  (``csrc/dcn.cc``), :func:`build`;
* ``libtpumpi.so`` — the MPI C ABI (``csrc/capi/shim.c`` over
  ``csrc/capi/include/mpi.h``), which embeds the running interpreter and
  imports :mod:`ompi_tpu_torch.capi`, :func:`build_capi`;
  :func:`compile_mpi_program` (``python -m ompi_tpu_torch mpicc``) builds
  a stock MPI C program against it;
* ``libtpushmem.so`` — the OpenSHMEM C API over libtpumpi
  (``csrc/capi/shmem_shim.c`` over ``csrc/capi/include/shmem.h``; no
  embedded Python of its own), :func:`build_shmem`; a program linked
  with ``-ltpushmem`` builds it;
* ``libtpuconvertor.so`` — the datatype pack/unpack kernels
  (``csrc/convertor.cc``), :func:`load_convertor`;
* the one ``nvcc`` build of the port's CUDA sources (:func:`build_cuda`:
  ``csrc/ring_hop.cu``, ``csrc/device_window.cu``).

At first use each C/C++ library is compiled with ``$CC``/``$CXX`` (or
``gcc``/``g++``) into ``build/ompi_tpu_torch/`` with the flags of the
reference's ``native/Makefile``; a later use rebuilds only when a source
(or, for libtpumpi, the libtpudcn it links) is newer than the library.
Every build holds a file lock and writes under a temporary name that is
renamed into place, so processes that start at once (test workers, the
ranks of a job) build it once and never load a half-written file.

The libraries are loaded with ``ctypes.CDLL``'s default ``RTLD_LOCAL``:
the reference's own libraries export the same symbols, and a process
that loads both (the parity tests) must keep them apart.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SRC = CSRC / "dcn.cc"
REPO_ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = REPO_ROOT / "build" / "ompi_tpu_torch"
LIB = BUILD_DIR / "libtpudcn.so"
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-shared", "-std=c++17")
LDLIBS = ("-lpthread", "-lrt")

#: the C ABI: shim source, the ``mpi.h`` programs compile against, the
#: library and the default home of compiled programs
CAPI_SRC = CSRC / "capi" / "shim.c"
CAPI_INCLUDE = CSRC / "capi" / "include"
MPI_LIB = BUILD_DIR / "libtpumpi.so"
BIN_DIR = BUILD_DIR / "bin"
#: the OpenSHMEM C API over the MPI one
SHMEM_SRC = CSRC / "capi" / "shmem_shim.c"
SHMEM_LIB = BUILD_DIR / "libtpushmem.so"
CFLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC")

CONV_SRC = CSRC / "convertor.cc"
CONV_LIB = BUILD_DIR / "libtpuconvertor.so"


class NativeBuildError(RuntimeError):
    """The C++ source could not be compiled (or no compiler exists)."""


def compiler() -> str | None:
    """The C++ compiler the build uses: ``$CXX``, else ``g++``."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def c_compiler() -> str | None:
    """The C compiler of the C ABI: ``$CC``, else ``gcc``."""
    cc = os.environ.get("CC") or "gcc"
    return shutil.which(cc)


def _stale(lib: Path, deps, stamp: str | None = None) -> bool:
    """``lib`` is missing, older than one of ``deps``, or (with
    ``stamp``) was built by another command, as its ``.cmd`` file says."""
    if not lib.exists():
        return True
    if stamp is not None:
        cmd_file = lib.with_name(lib.name + ".cmd")
        if not cmd_file.exists() or cmd_file.read_text() != stamp:
            return True
    mtime = lib.stat().st_mtime
    return any(Path(d).stat().st_mtime > mtime for d in deps)


def _locked_build(lib: Path, deps, cmd, stamped: bool = False) -> Path:
    """Run ``cmd(tmp)`` under ``lib``'s file lock when ``lib`` is stale;
    the output is renamed into place.  ``stamped``: the command itself
    (with ``lib`` for the output) is part of what the library must match."""
    stamp = " ".join(cmd(lib)) if stamped else None
    if not _stale(lib, deps, stamp):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(lib, deps, stamp):  # another process built it while we waited
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        argv = cmd(tmp)
        res = subprocess.run(argv, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{argv[0]} failed ({res.returncode}) building {lib.name}:\n"
                f"{res.stderr[-4000:]}")
        os.replace(tmp, lib)
        if stamp is not None:
            lib.with_name(lib.name + ".cmd").write_text(stamp)
    return lib


def build() -> Path:
    """Compile ``csrc/dcn.cc`` when the library is missing or older than
    the source; returns the library's path."""
    if not _stale(LIB, [SRC]):
        return LIB
    cxx = compiler()
    if cxx is None:
        raise NativeBuildError(
            f"no C++ compiler ({os.environ.get('CXX') or 'g++'}) on PATH")
    return _locked_build(LIB, [SRC], lambda tmp: [
        cxx, *CXXFLAGS, str(SRC), "-o", str(tmp), *LDLIBS])


def python_embed_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed the RUNNING interpreter,
    from its ``sysconfig`` (never a ``python3-config`` found on PATH,
    which may belong to another Python).  Raises when this Python has
    no shared libpython to embed."""
    cv = sysconfig.get_config_vars()
    include, libdir, ldlib = cv.get("INCLUDEPY"), cv.get("LIBDIR"), cv.get("LDLIBRARY")
    if not cv.get("Py_ENABLE_SHARED"):
        raise NativeBuildError(
            "this Python was built without a shared libpython "
            f"(Py_ENABLE_SHARED={cv.get('Py_ENABLE_SHARED')!r}, "
            f"LDLIBRARY={ldlib!r}); the C ABI embeds the interpreter and needs one")
    if not (include and Path(include, "Python.h").exists()):
        raise NativeBuildError(f"Python.h not found under INCLUDEPY={include!r}")
    if not (libdir and ldlib and Path(libdir, ldlib).exists()):
        raise NativeBuildError(f"libpython not found: LIBDIR={libdir!r}, LDLIBRARY={ldlib!r}")
    name = ldlib[3:].split(".so")[0]  # libpython3.12.so → python3.12
    return ([f"-I{include}"],
            [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}", "-ldl", "-lm"])


@lru_cache(maxsize=1)
def interpreter_sys_path() -> str:
    """The running interpreter's own ``sys.path``, ``:``-joined: what
    ``python -I`` sees (no ``PYTHONPATH``, user site or working
    directory), a virtual environment's site-packages included."""
    res = subprocess.run(
        [sys.executable, "-I", "-c",
         "import sys; print(':'.join(p for p in sys.path if p))"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip()


def _c_string(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def build_capi() -> Path:
    """``build/ompi_tpu_torch/libtpumpi.so`` from ``csrc/capi/shim.c``,
    linked against the port's ``libtpudcn.so`` (found next to it through
    ``$ORIGIN``) and the running interpreter's libpython.  Rebuilt when
    the shim, ``mpi.h`` or libtpudcn is newer, or the compile command
    differs (another interpreter, compiler or checkout).  The
    interpreter's own ``sys.path`` is baked in as the embedded
    interpreter's path where no launcher exports one
    (``TPUMPI_SYS_PATH``): a standalone C program then imports the same
    ``torch`` as this Python.  Raises :class:`NativeBuildError` when it
    cannot be built: the C ABI has no other path."""
    dcn = build()
    cc = c_compiler()
    if cc is None:
        raise NativeBuildError(
            f"no C compiler ({os.environ.get('CC') or 'gcc'}) on PATH")
    py_cflags, py_ldflags = python_embed_flags()
    return _locked_build(MPI_LIB, [CAPI_SRC, CAPI_INCLUDE / "mpi.h", dcn], lambda tmp: [
        cc, "-shared", *CFLAGS, f"-I{CAPI_INCLUDE}", *py_cflags,
        f"-DTPUMPI_PKG_ROOT={_c_string(str(REPO_ROOT))}",
        f"-DTPUMPI_SYS_PATH_DEFAULT={_c_string(interpreter_sys_path())}",
        str(CAPI_SRC), "-o", str(tmp),
        *py_ldflags, f"-L{BUILD_DIR}", "-ltpudcn", "-Wl,-rpath,$ORIGIN"], stamped=True)


def build_shmem() -> Path:
    """``build/ompi_tpu_torch/libtpushmem.so`` from
    ``csrc/capi/shmem_shim.c``, linked ``-ltpumpi`` against the port's
    libtpumpi (built first; found next to it through ``$ORIGIN``), as
    the reference's ``native/Makefile`` links its own.  Rebuilt when the
    shim, ``shmem.h``, ``mpi.h`` or libtpumpi is newer.  Raises
    :class:`NativeBuildError` when it cannot be built."""
    mpi = build_capi()
    cc = c_compiler()
    if cc is None:
        raise NativeBuildError(
            f"no C compiler ({os.environ.get('CC') or 'gcc'}) on PATH")
    deps = [SHMEM_SRC, CAPI_INCLUDE / "shmem.h", CAPI_INCLUDE / "mpi.h", mpi]
    return _locked_build(SHMEM_LIB, deps, lambda tmp: [
        cc, "-shared", *CFLAGS, f"-I{CAPI_INCLUDE}", str(SHMEM_SRC), "-o", str(tmp),
        f"-L{BUILD_DIR}", "-ltpumpi", "-Wl,-rpath,$ORIGIN"])


def compile_mpi_program(source: str | Path, output: str | Path | None = None,
                        extra_flags: list[str] | None = None) -> Path:
    """Compile a stock MPI C program against the port's libtpumpi.

    ≈ ``mpicc``: adds ``-I`` for the port's ``mpi.h`` and ``shmem.h`` and
    links ``-ltpumpi`` with an rpath, so the binary runs without
    ``LD_LIBRARY_PATH``; with ``-ltpushmem`` among ``extra_flags`` it
    builds libtpushmem first.  ``output`` defaults to
    ``build/ompi_tpu_torch/bin/<stem>``; it may not lie under the
    reference's ``native/`` tree."""
    build_capi()
    if "-ltpushmem" in (extra_flags or ()):
        build_shmem()
    src = Path(source)
    out = Path(output) if output is not None else BIN_DIR / src.stem
    if (REPO_ROOT / "native") in out.resolve().parents:
        raise NativeBuildError(f"refusing to write {out} under native/")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [c_compiler() or "gcc", "-O2", "-Wall", f"-I{CAPI_INCLUDE}",
           str(src), "-o", str(tmp), f"-L{BUILD_DIR}", "-ltpumpi",
           f"-Wl,-rpath,{BUILD_DIR}", *(extra_flags or [])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"mpicc failed: {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def mpicc_main(argv: list[str]) -> int:
    """``python -m ompi_tpu_torch mpicc prog.c [-o out] [gcc flags]``."""
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m ompi_tpu_torch mpicc <source.c> [-o out] "
              "[extra gcc flags]\n(default out: build/ompi_tpu_torch/bin/<stem>)")
        return 0 if argv else 2
    out, extra = None, []
    it = iter(argv[1:])
    for a in it:
        if a == "-o":
            out = next(it, None)
        else:
            extra.append(a)
    print(compile_mpi_program(argv[0], out, extra))
    return 0


_conv_lock = threading.Lock()
_convertor: ctypes.CDLL | None = None


def load_convertor() -> ctypes.CDLL | None:
    """The pack/unpack kernel library (``csrc/convertor.cc``), built on
    first use; None when there is no C++ compiler (the numpy convertor
    then serves every pack, as in the reference).  A source that does
    not compile raises."""
    global _convertor
    with _conv_lock:
        if _convertor is not None:
            return _convertor
        cxx = compiler()
        if cxx is None and _stale(CONV_LIB, [CONV_SRC]):
            return None
        path = _locked_build(CONV_LIB, [CONV_SRC], lambda tmp: [
            cxx, "-shared", "-O3", "-Wall", "-Wextra", "-fPIC", str(CONV_SRC),
            "-o", str(tmp)])
        lib = ctypes.CDLL(str(path))
        I64P = ctypes.POINTER(ctypes.c_int64)
        lib.tpuconv_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, I64P, I64P,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.tpuconv_unpack.argtypes = list(lib.tpuconv_pack.argtypes)
        lib.tpuconv_copy_strided.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.tpuconv_version.restype = ctypes.c_int
        _convertor = lib
        return lib


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
