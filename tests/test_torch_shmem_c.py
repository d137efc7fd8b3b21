"""The port's ``libtpushmem``: the OpenSHMEM C API over the port's
libtpumpi, after ``tests/test_shmem.py``'s C tests.

``build/ompi_tpu_torch/libtpushmem.so`` is built from
``ompi_tpu_torch/csrc/capi/shmem_shim.c`` (``native.build_shmem``, or
``mpicc ... -ltpushmem``); the stock programs
``native/examples/shmem_suite.c`` (np 2 and 3) and ``shmem_pipeline.c``
(np 2 and 4) compile into each test's own directory and run there under
``run -np N --cpu --nranks 1``.  The exported ``shmem_*`` set is held to
the reference's: the reference shim is compiled (not linked, nothing
written under ``native/``) into the test's directory and both symbol
tables must be equal.  A shim that does not compile raises
``NativeBuildError``.
"""

import os
import subprocess
import sys

import pytest

from ompi_tpu_torch import native
from test_torch_capi import EXAMPLES, REPO, lines_with, run_c

pytestmark = pytest.mark.skipif(native.c_compiler() is None or native.compiler() is None,
                                reason="no C/C++ toolchain")


def compile_shmem(name: str, out_dir):
    return native.compile_mpi_program(EXAMPLES / f"{name}.c", out_dir / name,
                                      extra_flags=["-ltpushmem"])


def exported_shmem(lib) -> set[str]:
    out = subprocess.run(["nm", "-D", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    return {line.split()[-1] for line in out.splitlines()
            if " T " in line and "shmem_" in line}


def test_mpicc_cli_links_libtpushmem(tmp_path):
    """``python -m ompi_tpu_torch mpicc prog.c -o out -ltpushmem`` builds
    libtpushmem under ``build/ompi_tpu_torch/`` and links the program
    against it."""
    out = tmp_path / "shmem_suite"
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "mpicc",
                          str(EXAMPLES / "shmem_suite.c"), "-o", str(out), "-ltpushmem"],
                         capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(out)
    assert native.SHMEM_LIB.is_file() and native.SHMEM_LIB.parent == native.BUILD_DIR
    ldd = subprocess.run(["ldd", str(out)], capture_output=True, text=True).stdout
    assert str(native.SHMEM_LIB) in ldd and str(native.MPI_LIB) in ldd, ldd


@pytest.mark.parametrize("npes", [2, 3])
def test_shmem_c_suite(npes, tmp_path):
    """The conformance suite: heap symmetry, ring puts, p/g, atomics,
    wait_until signaling, broadcast/fcollect/reductions, teams, contexts."""
    binary = compile_shmem("shmem_suite", tmp_path)
    res = run_c(npes, binary, cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "SHMEM SUITE COMPLETE" in res.stdout
    assert "FAIL" not in res.stdout


@pytest.mark.parametrize("npes", [2, 4])
def test_shmem_pipeline_example(npes, tmp_path):
    """Teams + signals + locks + contexts + _nbi composed into a
    producer/consumer pipeline."""
    binary = compile_shmem("shmem_pipeline", tmp_path)
    res = run_c(npes, binary, cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "pipeline OK")) == 1
    assert "MISMATCH" not in res.stdout


#: one representative per OpenSHMEM family (tests/test_shmem.py's set)
REQUIRED = {
    "shmem_init", "shmem_finalize", "shmem_my_pe", "shmem_n_pes",
    "shmem_malloc", "shmem_calloc", "shmem_align", "shmem_free",
    "shmem_barrier_all", "shmem_quiet", "shmem_fence",
    "shmem_ptr", "shmem_pe_accessible",
    "shmem_putmem", "shmem_getmem", "shmem_int_put", "shmem_int_get",
    "shmem_long_put", "shmem_double_put", "shmem_int_p",
    "shmem_int_g", "shmem_size_put", "shmem_ptrdiff_get",
    "shmem_put128", "shmem_get16",
    "shmem_putmem_nbi", "shmem_getmem_nbi", "shmem_double_put_nbi",
    "shmem_uint64_get_nbi", "shmem_int_iput", "shmem_long_iget",
    "shmem_iput64", "shmem_iget32",
    "shmem_int_atomic_fetch_add", "shmem_int_atomic_compare_swap",
    "shmem_long_atomic_swap", "shmem_uint64_atomic_fetch_add",
    "shmem_size_atomic_inc", "shmem_uint32_atomic_fetch_or",
    "shmem_int64_atomic_fetch_xor", "shmem_ulonglong_atomic_and",
    "shmem_float_atomic_swap", "shmem_double_atomic_fetch",
    "shmem_int_fadd", "shmem_long_cswap",
    "shmem_int_wait_until", "shmem_long_wait_until_all",
    "shmem_int64_wait_until_any", "shmem_size_wait_until_some",
    "shmem_int_test", "shmem_long_test_all", "shmem_uint64_test_any",
    "shmem_ptrdiff_test_some", "shmem_int_wait",
    "shmem_set_lock", "shmem_clear_lock", "shmem_test_lock",
    "shmem_putmem_signal", "shmem_signal_fetch",
    "shmem_signal_wait_until",
    "shmem_ctx_create", "shmem_ctx_destroy", "shmem_ctx_quiet",
    "shmem_ctx_fence", "shmem_ctx_int_put", "shmem_ctx_long_get",
    "shmem_ctx_int_atomic_fetch_add", "shmem_ctx_get_team",
    "shmem_team_split_strided", "shmem_team_my_pe",
    "shmem_team_translate_pe", "shmem_team_sync",
    "shmem_team_get_config", "shmem_team_destroy",
    "shmem_broadcast64", "shmem_collect64", "shmem_fcollect64",
    "shmem_alltoall32", "shmem_alltoalls64", "shmem_barrier",
    "shmem_sync", "shmem_int_sum_to_all", "shmem_double_sum_to_all",
    "shmem_float_min_to_all", "shmem_short_and_to_all",
    "shmem_longlong_prod_to_all", "shmem_complexd_sum_to_all",
    "shmem_broadcastmem", "shmem_alltoallmem", "shmem_int_broadcast",
    "shmem_double_fcollect", "shmem_long_alltoall",
    "shmem_int_sum_reduce", "shmem_uint64_max_reduce",
    "shmem_size_and_reduce", "shmem_complexf_sum_reduce",
}


def test_shmem_symbol_surface(tmp_path):
    """≥ 250 exported ``shmem_*`` symbols, one per family pinned by name,
    and the same set as the reference's shim compiles to; the vendor
    string (``shmem_info_get_name``) is the port's."""
    syms = exported_shmem(native.build_shmem())
    assert not REQUIRED - syms, sorted(REQUIRED - syms)
    assert len(syms) >= 250, len(syms)
    ref = tmp_path / "libref_shmem.so"
    subprocess.run([native.c_compiler(), "-shared", "-fPIC", "-O0",
                    f"-I{REPO / 'native' / 'include'}", str(REPO / "native" / "src" / "shmem_shim.c"),
                    "-o", str(ref)], check=True, capture_output=True, timeout=240)
    assert syms == exported_shmem(ref)
    # the one difference of the header: the vendor string names the port
    header = (native.CAPI_INCLUDE / "shmem.h").read_text()
    assert '#define SHMEM_VENDOR_STRING "ompi_tpu_torch"' in header


def test_broken_shim_raises_native_build_error(tmp_path, monkeypatch):
    """No other path: a shim that does not compile raises."""
    broken = tmp_path / "shmem_shim.c"
    broken.write_text('#include "shmem.h"\nvoid shmem_init(void) { not C }\n')
    monkeypatch.setattr(native, "SHMEM_SRC", broken)
    monkeypatch.setattr(native, "SHMEM_LIB", tmp_path / "libtpushmem.so")
    with pytest.raises(native.NativeBuildError, match="libtpushmem.so"):
        native.build_shmem()
    assert not (tmp_path / "libtpushmem.so").exists()
