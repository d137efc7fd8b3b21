"""The OSU C benchmarks and the dynamic-process, request and collective
fast-path programs on the port's libtpumpi, after
``tests/test_native_capi.py``: osu_allreduce/bcast/allgather/alltoall
validate, osu_latency and osu_bw report rows over the native plane,
MPI_Comm_spawn from C, MPI_Request_free on an active receive, and the
C collective fast path engaged (counter deltas) with persistent
collectives replaying cached schedules.  Every job runs with ``--cpu
--nranks 1``."""

import re
import time

import pytest

from test_torch_capi import BENCH, EXAMPLES, WORKERS, compile_programs, lines_with, run_c


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    srcs = {name: BENCH / f"{name}.c" for name in (
        "osu_allreduce", "osu_bcast", "osu_allgather", "osu_alltoall", "osu_latency", "osu_bw")}
    srcs.update(spawn_parent=EXAMPLES / "spawn_parent.c", spawn_child=EXAMPLES / "spawn_child.c",
                c_request_free=WORKERS / "c_request_free.c",
                c_coll_fastpath=WORKERS / "c_coll_fastpath.c")
    return compile_programs(tmp_path_factory.mktemp("capi_bench"), srcs)


def _rows(out: str) -> list[tuple[int, float]]:
    """The (bytes, value) rows of an OSU table."""
    rows = []
    for line in out.splitlines():
        m = re.match(r"^(?:\[\d+\] )?(\d+)\s+([0-9.]+)\s*$", line)
        if m:
            rows.append((int(m.group(1)), float(m.group(2))))
    return rows


def test_osu_allreduce_runs_and_validates(bins, tmp_path):
    res = run_c(2, bins["osu_allreduce"], cwd=tmp_path, args=[1024, 10])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "VALIDATION FAILED" not in res.stdout
    assert "Avg Latency(us)" in res.stdout


@pytest.mark.parametrize("bench,marker", [
    ("osu_bcast", "OSU_BCAST_DONE"),
    ("osu_allgather", "OSU_ALLGATHER_DONE"),
    ("osu_alltoall", "OSU_ALLTOALL_DONE"),
])
def test_osu_suite_runs_and_validates(bins, bench, marker, tmp_path):
    res = run_c(2, bins[bench], cwd=tmp_path, args=[4096, 10])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MISMATCH" not in res.stdout + res.stderr
    assert len(lines_with(res.stdout, marker)) == 2


@pytest.mark.parametrize("name,args", [
    ("osu_latency", ["16384", "60"]),
    ("osu_bw", ["1048576", "8"]),
])
def test_osu_p2p_benches_run(bins, name, args, tmp_path):
    """Ping-pong latency and windowed bandwidth over the native plane:
    every size reports a positive value, and small-message latency stays
    on the C fast path (a fall back to embedded Python costs tens of µs)."""
    res = run_c(2, bins[name], cwd=tmp_path, args=args)
    assert res.returncode == 0, res.stdout + res.stderr
    rows = _rows(res.stdout)
    assert len(rows) >= 5, res.stdout
    assert all(v > 0 for _, v in rows)
    if name == "osu_latency":
        assert min(v for b, v in rows if b <= 256) < 35.0, rows


def test_c_comm_spawn(bins, tmp_path):
    """MPI_Comm_spawn from C: children launched, p2p across the
    intercommunicator, Intercomm_merge and an allreduce over the union.
    The union's handle agreement keys on the spawn's KVS namespace, which
    both worlds share, so no process waits out the 120 s recv deadline
    (the reference's job takes over two minutes for that wait)."""
    t0 = time.monotonic()
    res = run_c(2, bins["spawn_parent"], cwd=tmp_path, args=[bins["spawn_child"]])
    wall = time.monotonic() - t0
    assert res.returncode == 0, res.stdout + res.stderr
    assert wall < 90, wall
    assert len(lines_with(res.stdout, "SPAWN_PARENT_OK")) == 2
    assert len(lines_with(res.stdout, "SPAWN_CHILD_OK")) == 2


def test_request_free_and_symbol_parity(bins, tmp_path):
    """MPI_Request_free on an active irecv still delivers; Get_count and
    Get_elements are byte-based; the predefined copy/delete functions
    link."""
    res = run_c(2, bins["c_request_free"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "RFREE COMPLETE" in res.stdout
    assert "FAIL" not in res.stdout


def test_c_coll_fastpath_engaged(bins, tmp_path):
    """Contiguous predefined-type collectives run in C (counter deltas),
    MPI_SUM is bit-exact against the embedded-Python plane, derived and
    user-op signatures take that plane, and persistent collectives replay
    compiled schedules with cache hits."""
    res = run_c(2, bins["c_coll_fastpath"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CFP COMPLETE" in res.stdout
    assert "FAIL" not in res.stdout
    engaged = lines_with(res.stdout, "coll_fastpath_ops=")
    assert len(engaged) == 2, res.stdout
    for line in engaged:
        ops = int(line.split("coll_fastpath_ops=")[1].split()[0])
        hits = int(line.split("sched_cache_hits=")[1].split()[0])
        assert ops >= 10 and hits >= 1, line
