"""The C conformance suites on the port's libtpumpi, after
``tests/test_native_capi.py``: c_suite2 and c_suite3 at np=2 and np=3,
c_suite4's fast-path comm-table soak, and c_suite2 over the alternate
transports (the shared-memory rings, the bml multiplexer).  Every job
runs with ``--cpu --nranks 1`` in its test's own directory.

c_suite3 and c_suite4 write their MPI-IO scratch files to fixed names
under ``/tmp`` (``/tmp/tpumpi_s3_<rank>.bin``,
``/tmp/tpumpi_hints_<rank>.bin``), where a reference job running at the
same time opens, and deletes, the same files.  They are compiled here
from copies whose only change is that prefix: the names are relative,
so each job's files lie in its own directory."""

import pytest

from test_torch_capi import EXAMPLES, compile_programs, lines_with, run_c

#: the fixed scratch-file prefix of c_suite3.c and c_suite4.c
TMP_PREFIX = '"/tmp/tpumpi_'


def private_scratch(src, out_dir):
    """A copy of the stock source ``src`` in ``out_dir`` whose
    ``/tmp/tpumpi_*`` scratch files are relative to the working
    directory."""
    text = src.read_text()
    assert text.count(TMP_PREFIX) == 1, src
    copy = out_dir / src.name
    copy.write_text(text.replace(TMP_PREFIX, '"tpumpi_'))
    return copy


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    out = tmp_path_factory.mktemp("capi_suites")
    return compile_programs(out, {
        "c_suite2": EXAMPLES / "c_suite2.c",
        **{name: private_scratch(EXAMPLES / f"{name}.c", out)
           for name in ("c_suite3", "c_suite4")}})


@pytest.mark.parametrize("nprocs", [2, 3])
def test_c_suite2_round3_breadth(bins, nprocs, tmp_path):
    """pack/unpack, alltoallv, attributes, Info, persistent p2p,
    sendrecv_replace, testsome, mprobe/mrecv, cart_sub, lock_all /
    get_accumulate / CAS on byte windows, win_allocate, resized and
    subarray types, error classes, handle conversions."""
    res = run_c(nprocs, bins["c_suite2"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "SUITE2 COMPLETE")) == 1
    assert "FAIL" not in res.stdout


@pytest.mark.parametrize("nprocs", [2, 3])
def test_c_suite3_batch2_breadth(bins, nprocs, tmp_path):
    """Neighbour collectives, alltoallw, type envelope/contents/darray,
    generalized requests, the name service over the job KVS, dynamic and
    shared windows, split-phase and ordered MPI-IO, MPI_T handles."""
    res = run_c(nprocs, bins["c_suite3"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "SUITE3 COMPLETE")) == 1
    assert "FAIL" not in res.stdout


def test_c_suite4_fp_table_soak(bins, tmp_path):
    """200-comm churn with no slot or request leak, 100 live fast-pathed
    comms, and a freed comm whose pending Irecv still completes."""
    res = run_c(2, bins["c_suite4"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "SUITE4 COMPLETE")) == 1
    assert "FAIL" not in res.stdout


@pytest.mark.parametrize("btl", ["sm", "bml"])
def test_c_suite_over_alternate_transports(bins, btl, tmp_path):
    res = run_c(2, bins["c_suite2"], cwd=tmp_path, mca={"btl": btl})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "SUITE2 COMPLETE" in res.stdout
    assert "FAIL" not in res.stdout
