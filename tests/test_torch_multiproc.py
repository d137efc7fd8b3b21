"""Multi-process jobs of the port against the reference: 2 processes of
2 virtual ranks each, on the CPU.

The same SPMD worker body (``torch_mp_common.BODY``: every collective,
the i- and persistent variants, the v-variants, split, dup,
create_group, probe and p2p) runs under the port's launcher and under
the reference's, on the same numpy inputs made from seed 20261016, both
on their default DCN engine, the native C plane (``btl/native``; p2p
through the C matcher).

* Reproducible vars on (port: ``coll_cuda_reproducible=1``, reference:
  ``coll_xla_reproducible=1``, both ``coll_han_reproducible=1``): the
  local legs fold in rank order and the DCN leg in process order, so
  every result is compared bit for bit.
* Port defaults (tuned's choice for the local leg, the ring above
  ``btl_tcp_ring_threshold`` on the DCN): compared to the reproducible
  reference with ``allclose`` (rtol 1e-12, atol 1e-12, float64 data).
"""

import numpy as np
import pytest

from torch_mp_common import (assert_bitwise_equal, load, mirrored_worker,
                             run_job)

REPRO = {
    "port": {"coll_cuda_reproducible": "1", "coll_han_reproducible": "1"},
    "ref": {"coll_xla_reproducible": "1", "coll_han_reproducible": "1"},
}


def _job(tmp_path, pkg, nprocs, nranks, mca, tag):
    out = tmp_path / tag
    out.mkdir()
    script = mirrored_worker(tmp_path / f"worker_{pkg}.py", pkg)
    res = run_job(pkg, nprocs, nranks, script, [out], mca=mca)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.count("OK worker") == nprocs, res.stdout
    # both launchers default to the native C plane
    assert res.stdout.count("ENGINE NativeDcnEngine") == nprocs, res.stdout
    return load(out, nprocs)


@pytest.fixture(scope="module")
def ref_2x2(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("ref"), "ref", 2, 2, REPRO["ref"], "ref")


def test_port_job_2x2_bitwise_equal_to_reference(tmp_path, ref_2x2):
    port = _job(tmp_path, "port", 2, 2, REPRO["port"], "port")
    assert_bitwise_equal(port, ref_2x2)
    # the checks the body ran are all there: 4 p2p receives, the isolation pair
    assert sum(k.startswith("p2p") for r in port for k in r) == 4
    np.testing.assert_array_equal(port[1]["isolation"], [111, 777])


def test_port_job_2x2_defaults_allclose_to_reference(tmp_path, ref_2x2):
    port = _job(tmp_path, "port", 2, 2, {}, "port_default")
    for p, (a, b) in enumerate(zip(port, ref_2x2)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12,
                                       err_msg=f"proc {p} {k}")


TENSOR_BODY = r'''
import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import MAX, SUM

w = api.init(device="cpu")
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
rng = np.random.default_rng(5)
X = rng.standard_normal((n, 6))
RS = rng.standard_normal((n, n, 2))
mine, rs = X[lo:lo + ln], RS[lo:lo + ln]
calls = {
    "allreduce": (mine, lambda a: w.allreduce(a, SUM)),
    "bcast": (mine, lambda a: w.bcast(a, root=n - 1)),
    "reduce": (mine, lambda a: w.reduce(a, SUM, root=0)),
    "allgather": (mine, w.allgather),
    "gather": (mine, lambda a: w.gather(a, root=n - 1)),
    "scatter": (X, lambda a: w.scatter(a, root=0)),
    "alltoall": (rs, w.alltoall),
    "reduce_scatter_block": (rs, lambda a: w.reduce_scatter_block(a, SUM)),
    "scan": (mine, lambda a: w.scan(a, SUM)),
    "exscan": (mine, lambda a: w.exscan(a, SUM)),
    "iallreduce": (mine, lambda a: w.iallreduce(a, MAX).wait()),
}
for name, (a, fn) in calls.items():
    want = fn(a)
    got = fn(torch.from_numpy(a.copy()))
    if want is None:
        assert got is None, name
        continue
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu", (name, type(got))
    assert got.numpy().tobytes() == want.tobytes() and got.shape == want.shape, name
# bfloat16 crosses the DCN as raw words and is folded by the op's torch
# kernel: the local fold, then the processes' partial rows in order
b = torch.from_numpy(mine.astype(np.float32)).to(torch.bfloat16)
got = w.allreduce(b, SUM)
part = w.local.allreduce(b, SUM)
rows = w.allgather(part)[0]  # (n, 6): every rank's local partial
want = rows[w.offsets[0]]
for q in range(1, w.nprocs):
    want = SUM.torch_fn(want, rows[w.offsets[q]])
assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                   want.expand_as(got).view(torch.int16))
assert torch.equal(w.bcast(b, root=0).view(torch.int16),
                   torch.from_numpy(X[0].astype(np.float32)).to(torch.bfloat16)
                   .expand_as(b).view(torch.int16))
# a bfloat16 message lands in a posted bfloat16 tensor bit for bit
if lo == 0:
    w.send(b[0], source=0, dest=n - 1, tag=9)
if lo + ln == n:
    out = torch.empty(6, dtype=torch.bfloat16)
    got, st = w.recv(dest=n - 1, source=0, tag=9, out=out)
    assert got is out and st.source == 0
    ref = torch.from_numpy(X[0].astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
print(f"OK tensors proc={p}", flush=True)
api.finalize()
'''


def test_tensors_in_tensors_out_and_bfloat16(tmp_path):
    """Every collective given CPU tensors returns tensors on the comm's
    device, bit-equal to the numpy call; bfloat16 allreduce, bcast and a
    bfloat16 message cross the processes bit for bit (seed 5, float64
    data; bfloat16 from its float32 rounding)."""
    script = tmp_path / "tensors.py"
    script.write_text(TENSOR_BODY)
    res = run_job("port", 2, 2, script, timeout=120)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.count("OK tensors") == 2, res.stdout


def test_a_failing_worker_kills_the_job(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(
        "import time\n"
        "import ompi_tpu_torch.api as api\n"
        "w = api.init(device='cpu')\n"
        "if w.proc == 1:\n"
        "    raise SystemExit(7)\n"
        "time.sleep(60)\n"
        "print('survivor finished', flush=True)\n")
    res = run_job("port", 2, 1, script, timeout=60)
    assert res.returncode == 7, res.stdout + res.stderr
    assert "survivor finished" not in res.stdout


def test_launcher_unlinks_what_dead_workers_left(tmp_path):
    """The names a killed worker's engine, sm rings and device windows
    leave are unlinked at the end of the job; other processes' are not,
    nor those of a live process that took a dead worker's pid."""
    import os
    import subprocess
    import sys

    from ompi_tpu_torch.boot.tpurun import _unlink_leftovers

    dead = []
    for _ in range(2):
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        dead.append(child.pid)
    a, b, live = dead[0], dead[1], os.getpid()
    mine = [f"tdcn-{a}-0-7f00", f"tdcn-db-{a}-0", f"ompitpu-{a}-0-ab", f"tpudev-{a}-3-1f",
            f"tdcn-db-{b}-1"]
    others = [f"tdcn-{a}1-0-7f00", "tdcn-db-7x-0", "unrelated", f"tdcn-{live}-0-1",
              f"tpudev-{live}-2-3"]
    for name in mine + others:
        (tmp_path / name).write_bytes(b"x")
    assert sorted(_unlink_leftovers([a, b, live], str(tmp_path))) == sorted(mine)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(others)


def test_chip_smoke_worker_rehearses_on_the_cpu():
    """The card's multiproc worker, at toy sizes on the CPU: every
    section reports, the results check out, and no JAX module loads."""
    import json

    from torch_mp_common import REPO

    res = run_job("port", 2, 4, REPO / "ompi_tpu_torch" / "examples" / "multiproc_smoke.py",
                  ["--device", "cpu", "--max-bytes", "8192", "--prod-bytes", "65536",
                   "--act", "96"], timeout=120)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rows = [json.loads(ln.split("MPJSON ", 1)[1]) for ln in res.stdout.splitlines()
            if "MPJSON " in ln]
    kinds = {}
    for r in rows:
        kinds.setdefault(r.pop("kind"), []).append(r)
    assert all(len(kinds.get(k, ())) == 2 for k in
               ("modules", "colls", "prod", "p2p", "ddp", "launches")), kinds.keys()
    assert all(r["ok"] for r in kinds["colls"])
    assert sorted(r["bytes"] for r in kinds["split"]) == [8, 8, 65536, 65536]
    assert len(kinds["osu"]) == 2 * 6 and all(r["ok"] for r in kinds["osu"])
    assert all(r["bitwise_vs_plain"] and r["bitwise_vs_numpy"] for r in kinds["prod"])
    assert all(not r["forbidden"] for r in kinds["modules"])
    recv = [r for r in kinds["p2p"] if r["role"] == "recv"]
    assert len(recv) == 1 and recv[0]["bitwise"] and len(recv[0]["times_ms"]) == 20
    assert all(r["replicas_identical"] for r in kinds["ddp"])
