"""The port's MPI C ABI: ``libtpumpi`` built from
``ompi_tpu_torch/csrc/capi/shim.c``, stock MPI C programs compiled with
``python -m ompi_tpu_torch mpicc`` and run under the port's launcher.

After ``tests/test_native_capi.py``, on the port: c_suite standalone and
at np=2, hello_ring at np=3, PMPI interposition, the symbol count and
the empty symbol diff against the installed ``libmpi.so.40``.  Besides:

* a C rank refuses a process that holds more than one virtual rank;
* the embedded interpreter of a C rank takes the launcher's ``sys.path``
  (the same ``torch``, a module only the launcher's path can see);
* the shim's hand-written ``tdcn_*`` prototypes match the definitions in
  ``csrc/dcn.cc``, and the fast path refuses an engine of a second
  loaded libtpudcn.

Every job runs with ``--cpu --nranks 1`` (one rank per process, on the
CPU).  Binaries go to a temporary directory; nothing is written under
``native/`` and the reference's build is never called.  The helpers
here are shared by the other ``test_torch_capi_*`` files.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from ompi_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "native" / "examples"
BENCH = REPO / "native" / "bench"
WORKERS = Path(__file__).resolve().parent / "workers"

pytestmark = pytest.mark.skipif(native.c_compiler() is None or native.compiler() is None,
                                reason="no C/C++ toolchain")


def compile_programs(out_dir: Path, sources: dict[str, Path]) -> dict[str, Path]:
    """``name → binary`` for each stock source, built against the port's
    libtpumpi into ``out_dir``."""
    return {name: native.compile_mpi_program(src, out_dir / name)
            for name, src in sources.items()}


def repo_env(env=None) -> dict:
    """``env`` (default: this process's) with the checkout first on
    ``PYTHONPATH``, so ``-m ompi_tpu_torch`` resolves from any directory."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_c(np_: int, binary, *, cwd, args=(), mca=None, timeout=240, env=None, cpu=True):
    """``python -m ompi_tpu_torch run -np N --cpu --nranks 1 [--mca k v] binary``
    in ``cwd``: a test's own directory, so that the files a program
    creates relative to it (c_suite's ``csuite_io.bin`` and its ``.shfp``)
    never meet another job's."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(np_), "--nranks", "1"]
    if cpu:
        cmd.append("--cpu")
    for k, v in (mca or {}).items():
        cmd += ["--mca", k, str(v)]
    cmd += [str(binary), *map(str, args)]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          cwd=str(cwd), env=repo_env(env))


def lines_with(out: str, marker: str) -> list[str]:
    return [line for line in out.splitlines() if marker in line]


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    return compile_programs(tmp_path_factory.mktemp("capi_bins"), {
        "c_suite": EXAMPLES / "c_suite.c",
        "hello_ring": EXAMPLES / "hello_ring.c",
        "pmpi_counter": EXAMPLES / "pmpi_counter.c",
    })


def test_mpicc_cli_and_c_suite_two_ranks(tmp_path):
    """The acceptance path: ``mpicc`` from the command line, then ``run
    -np 2 --cpu --nranks 1``."""
    out = tmp_path / "c_suite"
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "mpicc",
                          str(EXAMPLES / "c_suite.c"), "-o", str(out)],
                         capture_output=True, text=True, timeout=240, cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(out) and os.access(out, os.X_OK)
    res = run_c(2, out, cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "CSUITE PASS")) == 2
    assert "FAIL" not in res.stdout


def test_c_suite_standalone(bins, tmp_path):
    """Run without the launcher: a size-1 world, on the CPU when
    ``OMPI_TPU_DEVICE=cpu`` asks for it."""
    env = dict(os.environ, OMPI_TPU_DEVICE="cpu")
    env.pop("OMPI_TPU_PROC", None)
    res = subprocess.run([str(bins["c_suite"])], capture_output=True, text=True,
                         timeout=240, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CSUITE PASS rank=0 size=1" in res.stdout


def test_c_rank_refuses_two_virtual_ranks(bins, tmp_path):
    """A process that holds more than one virtual rank (the launcher's
    default of 8) is refused at MPI_Init, naming the flag that fixes it.
    The CUDA default of a C rank is checked in ``test_torch_hygiene.py``."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--cpu",
           str(bins["c_suite"])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=tmp_path,
                         env=repo_env())
    assert res.returncode != 0 and "CSUITE PASS" not in res.stdout
    assert "--nranks 1" in res.stdout + res.stderr


def test_hello_ring_three_ranks(bins, tmp_path):
    res = run_c(3, bins["hello_ring"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "done with ring")) == 3
    assert len(lines_with(res.stdout, "allreduce OK (6)")) == 3


def test_pmpi_interposition(bins, tmp_path):
    """A strong MPI_Allreduce in the program intercepts; PMPI_ forwards."""
    res = run_c(2, bins["pmpi_counter"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "calls=5 sum=2")) == 2, res.stdout


def _dyn_symbols(path) -> list[tuple[str, str]]:
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)], capture_output=True,
                         text=True, check=True).stdout
    return [(parts[1], parts[2]) for parts in map(str.split, out.splitlines())
            if len(parts) == 3]


def test_symbol_count_geq_400(bins):
    weak = {name for kind, name in _dyn_symbols(native.MPI_LIB)
            if kind == "W" and name.startswith("MPI_")}
    assert len(weak) >= 400, f"only {len(weak)} MPI_* weak symbols"


def test_symbol_diff_vs_installed_reference_empty(bins):
    ref = Path("/usr/lib/x86_64-linux-gnu/libmpi.so.40.30.4")
    if not ref.exists():
        pytest.skip("no installed libmpi.so.40 to compare with")

    def names(p):
        out = subprocess.run(["nm", "-D", str(p)], capture_output=True, text=True).stdout
        return {line.split()[-1] for line in out.splitlines()
                if line.split() and line.split()[-1].startswith("MPI_")}

    missing = names(ref) - names(native.MPI_LIB)
    assert not missing, f"missing vs installed reference: {sorted(missing)}"


def test_libtpumpi_lives_in_the_ports_build_and_links_its_libtpudcn(bins):
    assert native.MPI_LIB.parent == REPO / "build" / "ompi_tpu_torch"
    out = subprocess.run(["ldd", str(native.MPI_LIB)], capture_output=True, text=True).stdout
    dcn = [line for line in out.splitlines() if "libtpudcn.so" in line]
    assert len(dcn) == 1 and str(native.LIB) in dcn[0], out
    assert "native/build" not in out
    ldlib = __import__("sysconfig").get_config_var("LDLIBRARY")
    assert ldlib in out  # the running interpreter's libpython


PROBE_C = r"""
#include <mpi.h>
#include <Python.h>
#include <stdio.h>
int main(int argc, char **argv) {
  MPI_Init(&argc, &argv);
  PyGILState_STATE g = PyGILState_Ensure();
  PyRun_SimpleString(
      "import sys, torch\n"
      "try:\n"
      "    from capi_path_probe import VALUE\n"
      "except ImportError:\n"
      "    VALUE = 'absent'\n"
      "print('TORCH', torch.__file__, flush=True)\n"
      "print('PROBE', VALUE, flush=True)\n"
      "print('SYSPATH', ':'.join(sys.path), flush=True)\n");
  PyGILState_Release(g);
  MPI_Finalize();
  return 0;
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """A C program that prints the ``torch`` and ``sys.path`` of its
    embedded interpreter after MPI_Init."""
    out = tmp_path_factory.mktemp("capi_probe")
    src = out / "probe.c"
    src.write_text(PROBE_C)
    cflags, ldflags = native.python_embed_flags()
    return native.compile_mpi_program(src, out / "probe", cflags + ldflags)


def test_c_rank_imports_torch_from_the_launchers_path(probe, tmp_path):
    """The launcher passes its ``sys.path`` to the C ranks: the embedded
    interpreter imports the launcher's torch and a module that only the
    launcher's path holds."""
    import torch

    binary = probe
    extra = tmp_path / "only_on_the_launchers_path"
    extra.mkdir()
    (extra / "capi_path_probe.py").write_text("VALUE = 'seen'\n")
    code = ("import sys; sys.path.append(%r)\n"
            "from ompi_tpu_torch.boot.tpurun import main\n"
            "sys.exit(main(['-np', '2', '--cpu', '--nranks', '1', %r]))\n"
            % (str(extra), str(binary)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=tmp_path, env=repo_env())
    assert res.returncode == 0, res.stdout + res.stderr
    torches = {line.split()[-1] for line in lines_with(res.stdout, "TORCH ")}
    assert torches == {torch.__file__}, res.stdout
    assert len(lines_with(res.stdout, "PROBE seen")) == 2, res.stdout


def test_standalone_c_rank_imports_torch_from_the_building_interpreters_path(
        probe, tmp_path):
    """Without a launcher, without ``PYTHONPATH`` and without the
    building interpreter's directory on ``PATH`` (a shell where its
    virtual environment is not active), a C program's embedded
    interpreter takes the ``sys.path`` baked into libtpumpi by the
    interpreter that built it, site-packages included, so it imports
    that interpreter's torch."""
    import torch

    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPUMPI_SYS_PATH", "OMPI_TPU_PROC")}
    env["OMPI_TPU_DEVICE"] = "cpu"
    here = os.path.dirname(sys.executable)
    env["PATH"] = ":".join(d for d in env.get("PATH", "").split(":") if d and d != here)
    res = subprocess.run([str(probe)], capture_output=True, text=True, timeout=240,
                         env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert lines_with(res.stdout, "TORCH ") == [f"TORCH {torch.__file__}"], res.stdout
    baked = native.interpreter_sys_path().split(":")
    seen = lines_with(res.stdout, "SYSPATH ")[0].split(" ", 1)[1].split(":")
    assert seen[:len(baked)] == baked, (seen, baked)


_CANON = {"int64_t": "i64", "long long": "i64", "long": "i64", "int": "i32",
          "uint64_t": "u64", "unsigned long long": "u64", "double": "f64", "void": "void"}


def _canon(decl: str) -> str:
    """A C type (with or without a parameter name) in ABI terms."""
    decl = re.sub(r"\bconst\b", " ", decl).strip()
    if "*" in decl:
        return "ptr"
    words = decl.split()
    if len(words) > 1 and " ".join(words) not in _CANON:
        words = words[:-1]  # drop the parameter name
    name = " ".join(words)
    if name.endswith("_fn"):  # a callback type: a pointer
        return "ptr"
    return _CANON[name]


def _signatures(text: str, pattern: str) -> dict[str, tuple]:
    out = {}
    for ret, name, params in re.findall(pattern, text, re.S | re.M):
        ps = [p for p in (s.strip() for s in params.split(",")) if p and p != "void"]
        out[name] = (_canon(ret),) + tuple(_canon(p) for p in ps)
    return out


def test_shim_tdcn_prototypes_match_dcn_cc():
    """The shim's hand-written ``extern`` prototypes of ``tdcn_*`` and
    the definitions in ``csrc/dcn.cc`` agree in return and parameter
    types (a mismatch would be silent undefined behaviour)."""
    shim = (REPO / "ompi_tpu_torch" / "csrc" / "capi" / "shim.c").read_text()
    dcn = native.SRC.read_text()
    declared = _signatures(shim, r"extern\s+([\w\s\*]+?)\s*\b(tdcn_\w+)\s*\(([^;]*?)\)\s*;")
    defined = _signatures(dcn, r"^([\w][\w \*]*?)\s*\b(tdcn_\w+)\s*\(([^)]*)\)\s*\{")
    assert len(declared) >= 25, sorted(declared)
    assert {k: defined.get(k) for k in declared} == declared


def test_fast_path_refuses_an_engine_of_a_second_libtpudcn(tmp_path):
    """With libtpumpi mapped globally (as in a C rank), the engine of the
    port's own libtpudcn passes the one-instance check; a copy of the
    same library loaded from another path (what a rebuild renamed into
    place mid-job would be) is a second instance and is refused."""
    code = (
        "import ctypes, shutil, sys\n"
        "from ompi_tpu_torch import native, capi\n"
        "from ompi_tpu_torch.dcn import native as pn\n"
        "ctypes.CDLL(str(native.build_capi()), mode=ctypes.RTLD_GLOBAL)\n"
        "capi._check_one_dcn_instance(pn.load_library())\n"
        "copy = shutil.copy(native.LIB, sys.argv[1])\n"
        "try:\n"
        "    capi._check_one_dcn_instance(ctypes.CDLL(copy))\n"
        "except capi.err.MPIInternalError as e:\n"
        "    print('REFUSED', e)\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "libtpudcn.so")],
                         capture_output=True, text=True, timeout=240, cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    assert "REFUSED" in res.stdout and "two loaded instances" in res.stdout


def test_libtpumpi_is_rebuilt_for_another_compile_command(bins):
    """libtpumpi records the command that built it: one from another
    interpreter, compiler or checkout makes it stale; the same one and
    unchanged sources do not."""
    stamp = (native.MPI_LIB.parent / (native.MPI_LIB.name + ".cmd")).read_text()
    assert native.python_embed_flags()[0][0] in stamp and "-ltpudcn" in stamp
    deps = [native.CAPI_SRC, native.CAPI_INCLUDE / "mpi.h", native.LIB]
    assert not native._stale(native.MPI_LIB, deps, stamp)
    assert native._stale(native.MPI_LIB, deps, stamp.replace("python3", "python9"))


def test_compiled_programs_never_land_under_native(tmp_path):
    with pytest.raises(native.NativeBuildError, match="under native/"):
        native.compile_mpi_program(EXAMPLES / "c_suite.c", REPO / "native" / "build" / "x")
    assert not (REPO / "native" / "build" / "x").exists()
    assert native.compile_mpi_program(EXAMPLES / "hello_ring.c").parent == native.BIN_DIR
