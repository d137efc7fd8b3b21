"""Jobs of several processes on the one-rank-per-device layout (the MCA
variable ``accelerator_cuda_layout`` set to ``devices``) against the
reference's ``run`` jobs, on the CPU.

* Placement: :func:`ompi_tpu_torch.mesh.mesh.block_devices` gives global
  rank ``g = proc * K + r`` card ``g * C // (P * K)``.
* The shared SPMD body (``torch_mp_common.BODY``: every collective, the
  i- and persistent variants, the v-variants, split, dup, create_group,
  probe and p2p; numpy in, numpy out) runs under the port's launcher on
  the devices layout and under the reference's, on the numpy inputs of
  seed 20261016: 2 × 2 and 3 × 1.  Bit for bit on the ordered path
  (port ``coll_cuda_reproducible=1``, reference ``coll_xla_reproducible=1``,
  both ``coll_han_reproducible=1``) and on the ring path (the local leg's
  ``ring`` pinned in both, the DCN ring above ``btl_tcp_ring_threshold``);
  the port's defaults within ``allclose`` (rtol 1e-12, atol 1e-12,
  float64 data) of the reference's ordered job.
* A port-only body hands every han collective, and its ``i*`` and
  ``*_init`` forms, ``RankShards`` and checks that ``RankShards`` come back
  with shard l on local rank l's device, bit-equal to the numpy call.
* A second mirrored body runs a DCN window (a fence epoch, a
  post/start/complete/wait epoch — a fence epoch in the reference, which
  has no PSCW across processes — and lock epochs with atomics), a
  message across processes into a tensor on the receiving rank's device,
  and shmem put/get/``sum_to_all``/``fcollect``; results compared bit for
  bit with the reference job's.
* ``c_suite`` and ``devsum`` at ``--nranks 1`` on the devices layout
  (``devsum`` on the Python planes: its digest against numpy's from the
  formula in ``native/examples/devsum.c``).
* tpud serving and ULFM recovery on this layout are held to the
  reference in ``tests/test_torch_devices_recovery.py`` and
  ``tests/test_torch_devices_serve.py``.

Each reference job runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from torch_mp_common import (PRELUDE, REPO, assert_bitwise_equal, load, mirrored_worker,
                             run_job)

from ompi_tpu_torch.mesh.mesh import block_devices
from ompi_tpu_torch.mesh.shards import RankShards

DEVICES = {"accelerator_cuda_layout": "devices"}
REPRO = {
    "port": {**DEVICES, "coll_cuda_reproducible": "1", "coll_han_reproducible": "1"},
    "ref": {"coll_xla_reproducible": "1", "coll_han_reproducible": "1"},
}
#: the local leg's plain ring pinned (enum 2 in both packages)
RING = {
    "port": {**DEVICES, "coll_cuda_allreduce_algorithm": "2"},
    "ref": {"coll_xla_allreduce_algorithm": "2"},
}


# -- placement -------------------------------------------------------------


@pytest.mark.parametrize("nprocs,nranks,cards,want", [
    (2, 4, 1, [[0, 0, 0, 0], [0, 0, 0, 0]]),
    (2, 4, 4, [[0, 0, 1, 1], [2, 2, 3, 3]]),
    (4, 2, 4, [[0, 0], [1, 1], [2, 2], [3, 3]]),
    (3, 1, 4, [[0], [1], [2]]),
])
def test_job_wide_blocks_place_each_process_on_its_cards(nprocs, nranks, cards, want):
    got = [block_devices(list(range(cards)), nranks, p, nprocs) for p in range(nprocs)]
    assert got == want
    # global rank g on card g * C // N, and one process alone keeps the old rule
    n = nprocs * nranks
    assert sum(got, []) == [g * cards // n for g in range(n)]
    assert block_devices(list(range(cards)), n) == [g * cards // n for g in range(n)]


# -- the shared body against the reference --------------------------------


def _job(tmp_path, pkg, nprocs, nranks, mca, tag, script=None):
    out = tmp_path / tag
    out.mkdir()
    script = script or mirrored_worker(tmp_path / f"worker_{pkg}_{tag}.py", pkg)
    res = run_job(pkg, nprocs, nranks, script, [out], mca=mca)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.count("OK worker") == nprocs, res.stdout
    return load(out, nprocs)


@pytest.fixture(scope="module")
def ref_2x2(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("ref"), "ref", 2, 2, REPRO["ref"], "ref")


def test_devices_job_2x2_bitwise_equal_to_reference(tmp_path, ref_2x2):
    port = _job(tmp_path, "port", 2, 2, REPRO["port"], "port")
    assert_bitwise_equal(port, ref_2x2)
    assert sum(k.startswith("p2p") for r in port for k in r) == 4
    np.testing.assert_array_equal(port[1]["isolation"], [111, 777])


def test_devices_job_2x2_ring_bitwise_equal_to_reference(tmp_path_factory):
    base = tmp_path_factory.mktemp("ring")
    ref = _job(base, "ref", 2, 2, RING["ref"], "ref")
    port = _job(base, "port", 2, 2, RING["port"], "port")
    assert_bitwise_equal(port, ref)


def test_devices_job_2x2_defaults_allclose_to_reference(tmp_path, ref_2x2):
    port = _job(tmp_path, "port", 2, 2, DEVICES, "port_default")
    for p, (a, b) in enumerate(zip(port, ref_2x2)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12,
                                       err_msg=f"proc {p} {k}")


def test_devices_job_3x1_bitwise_equal_to_reference(tmp_path):
    ref = _job(tmp_path, "ref", 3, 1, REPRO["ref"], "ref")
    port = _job(tmp_path, "port", 3, 1, REPRO["port"], "port")
    assert_bitwise_equal(port, ref)


# -- RankShards in, RankShards out -----------------------------------------

SHARD_BODY = r'''
import numpy as np
import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op import MAX, SUM

w = api.init(device="cpu")
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
devs = w.local_mesh.devices
assert w.local_mesh.layout == "devices" and w.local.mesh.layout == "devices"
rng = np.random.default_rng(5)
X = rng.standard_normal((n, 6))
RS = rng.standard_normal((n, n, 2))
mine, rs = X[lo:lo + ln], RS[lo:lo + ln]
full = np.broadcast_to(X, (ln,) + X.shape)  # scatter: every local rank holds root's rows


def shards(a):
    return w.local_mesh.stage_in(np.ascontiguousarray(a))


def blocking(name, *args):
    return lambda a: getattr(w, name)(a, *args)


def nonblocking(name, *args):
    return lambda a: getattr(w, "i" + name)(a, *args).wait()


def persistent(name, *args):
    def run(a):
        req = getattr(w, name + "_init")(a, *args)
        outs = [req.start().wait() for _ in range(2)]
        return outs[-1]
    return run


calls = {}
for form in (blocking, nonblocking, persistent):
    tag = form.__name__
    calls.update({
        f"{tag}.allreduce": (mine, form("allreduce", SUM)),
        f"{tag}.allreduce_max": (mine, form("allreduce", MAX)),
        f"{tag}.bcast": (mine, form("bcast", n - 1)),
        f"{tag}.reduce": (mine, form("reduce", SUM, 0)),
        f"{tag}.allgather": (mine, form("allgather")),
        f"{tag}.gather": (mine, form("gather", n - 1)),
        f"{tag}.scatter": (full, form("scatter", 0)),
        f"{tag}.alltoall": (rs, form("alltoall")),
        f"{tag}.reduce_scatter_block": (rs, form("reduce_scatter_block", SUM)),
        f"{tag}.scan": (mine, form("scan", SUM)),
        f"{tag}.exscan": (mine, form("exscan", SUM)),
    })
checked = 0
for name, (a, fn) in calls.items():
    want = fn(X if name.endswith(".scatter") else a)
    got = fn(shards(a))
    if want is None:
        assert got is None, name
        continue
    if name.endswith(".gather"):  # root's recvbuf: one tensor on root's card
        assert isinstance(got, torch.Tensor) and got.device == devs[ln - 1], (name, got)
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), name
    else:
        assert isinstance(got, RankShards) and got.devices == devs, (name, type(got))
        assert got.to_host().tobytes() == np.asarray(want).tobytes(), name
        assert len({s.data_ptr() for s in got.shards}) == ln, name  # one buffer per rank
    checked += 1
w.barrier()
w.ibarrier().wait()
# jagged counts: rank l's segment on its device
counts = [1 + r % 2 for r in range(n)]
jag = rng.standard_normal((n, sum(counts), 2))[lo:lo + ln]
segs = w.reduce_scatter(shards(jag), SUM, counts)
want = w.reduce_scatter(jag, SUM, counts)
assert [s.device for s in segs] == list(devs)
assert all(s.numpy().tobytes() == v.tobytes() for s, v in zip(segs, want))
# the v-variants: tensor blocks in, tensors out (rank l's blocks on its device)
blocks = [torch.full((2, lo + l + 1), float(lo + l), device=d) for l, d in enumerate(devs)]
got = w.allgatherv(blocks)
assert [b.numpy().tolist() for b in got] == [np.full((2, r + 1), float(r)).tolist()
                                             for r in range(n)]
got = w.scatterv([torch.arange(r + 1.0) for r in range(n)], root=0)  # root's count
assert [b.device for b in got] == list(devs)
assert [b.numpy().tolist() for b in got] == [list(range(lo + l + 1)) for l in range(ln)]
got = w.alltoallv([[torch.full((j + 1,), 10.0 * (lo + l) + j, device=d) for j in range(n)]
                   for l, d in enumerate(devs)])
assert all(got[l][s].numpy().tolist() == [10.0 * s + lo + l] * (lo + l + 1)
           for l in range(ln) for s in range(n))
# a shard crosses the processes into a posted tensor on the receiving rank's device
if lo == 0:
    w.send(shards(mine)[ln - 1], source=ln - 1, dest=ln, tag=9)
    w.send(shards(mine)[0], source=0, dest=1, tag=10)  # within the process
    got, st = w.recv(dest=1, source=0, tag=10)
    assert isinstance(got, torch.Tensor) and got.device == devs[1]
    assert got.numpy().tobytes() == mine[0].tobytes()
else:
    out = torch.empty(6, dtype=torch.float64, device=devs[0])
    got, st = w.recv(dest=ln, source=ln - 1, tag=9, out=out)
    assert got is out and st.source == ln - 1
    assert out.numpy().tobytes() == X[ln - 1].tobytes()
# a window's fetched values land on the origin rank's device; bases stay on theirs
win = w.win_allocate(4, np.float64)
assert [win.memory(lo + l).device for l in range(ln)] == list(devs)
win.fence()
for l in range(ln):
    win.put((lo + l + 1) % n, np.full(4, float(lo + l)))
win.fence()
for l in range(ln):
    v = win.get((lo + l + 1) % n, 4, origin=lo + l)
    assert v.device == devs[l] and v.numpy().tolist() == [float(lo + l)] * 4
    old = win.fetch_and_op((lo + l + 1) % n, 0.0, 3, origin=lo + l)
    assert old.device == devs[l]
win.fence()
win.free()
# i-collectives record an event on every card they touch (CPU: none) and
# the memory checker guards every shard
from ompi_tpu_torch.tool import memchecker
memchecker.attach(True)
req = w.iallreduce(shards(mine), SUM)
assert req.wait().to_host().tobytes() == w.allreduce(mine, SUM).tobytes()
memchecker.attach(False)
print(f"OK shards proc={p} checked={checked}", flush=True)
api.finalize()
'''


def test_every_han_collective_takes_and_returns_rank_shards(tmp_path):
    """Every han collective in its blocking, ``i*`` and ``*_init`` form,
    the jagged ``reduce_scatter``, the v-variants, a message into a
    posted tensor across processes and within one, and a window's
    fetched values: ``RankShards`` in, ``RankShards`` out, shard l on
    local rank l's device, bit-equal to the same call given numpy (seed
    5, float64)."""
    script = tmp_path / "shards.py"
    script.write_text(SHARD_BODY)
    res = run_job("port", 2, 2, script, mca=DEVICES, timeout=120)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.count("OK shards") == 2, res.stdout
    assert res.stdout.count("checked=30") == 2, res.stdout  # 33 calls, 3 reduce off root


# -- windows, p2p and shmem against the reference --------------------------

SURF_PRELUDE = {
    "port": PRELUDE["port"] + (
        "import torch\n"
        "from ompi_tpu_torch import shmem\n"
        "def base(l, a):\n"
        "    return torch.from_numpy(a.copy()).to(w.local_mesh.devices[l])\n"
        "def host(v):\n"
        "    return np.asarray(v.cpu() if hasattr(v, 'cpu') else "
        "v.to_host() if hasattr(v, 'to_host') else v)\n"
        "def open_epoch(win):\n"
        "    win.post(range(w.size))\n"
        "    win.start(range(w.size))\n"
        "def close_epoch(win):\n"
        "    win.complete()\n"
        "    win.wait()\n"
    ),
    "ref": PRELUDE["ref"] + (
        "from ompi_tpu import shmem\n"
        "def base(l, a):\n"
        "    return a.copy()\n"
        "def host(v):\n"
        "    return np.asarray(v)\n"
        "def open_epoch(win):\n"
        "    win.fence()\n"
        "def close_epoch(win):\n"
        "    win.fence()\n"
    ),
}

SURF_BODY = r'''
out_dir = sys.argv[1]
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
res = {}
win = w.win_create([base(l, np.arange(8.0) * (lo + l + 1)) for l in range(ln)])
# fence epoch: accumulate into r+1, put into r+2, then get r-1
win.fence()
for l in range(ln):
    r = lo + l
    win.accumulate((r + 1) % n, np.full(4, r + 0.5), 0, SUM)
    win.put((r + 2) % n, np.full(2, -float(r)), 5)
win.fence()
for l in range(ln):
    res[f"fence_get{lo + l}"] = host(win.get((lo + l - 1) % n, 8))
win.fence()
# a general active-target epoch (post/start/complete/wait on the port)
open_epoch(win)
for l in range(ln):
    r = lo + l
    win.accumulate((r + 3) % n, np.full(8, 0.25 * r), 0, PROD)
close_epoch(win)
for l in range(ln):
    res[f"pscw_mem{lo + l}"] = host(win.memory(lo + l))
# lock epochs with atomics, one process at a time (the fetched values
# then do not depend on the processes' interleaving)
for q in range(w.nprocs):
    if q == p:
        for l in range(ln):
            r = lo + l
            win.lock(0)
            res[f"fao{r}"] = host(win.fetch_and_op(0, 1.5, 7, SUM))
            res[f"cas{r}"] = host(win.compare_and_swap(n - 1, 100.0 + r, res[f"fao{r}"] * 0 + 56.0, 6))
            win.unlock(0)
            win.lock(n - 1)
            win.unlock(n - 1)
    w.barrier()
win.fence()
for l in range(ln):
    res[f"lock_mem{lo + l}"] = host(win.memory(lo + l))
win.free()
# shmem: the heap is a window of the world
shmem.init(1 << 12)
me, npes = shmem.my_pe(), shmem.n_pes()
a = shmem.malloc(4, np.float64)
shmem.put(a, np.arange(4.0) + 10 * me, (me + ln) % npes)
shmem.barrier_all()
res["shmem_get"] = host(shmem.get(a, (me + ln) % npes))
res["shmem_view"] = host(a.view())
res["shmem_sum"] = host(shmem.sum_to_all(np.arange(4.0)[None] * (lo + np.arange(ln))[:, None]))
res["shmem_fcollect"] = host(shmem.fcollect(np.full((ln, 2), float(p))))
shmem.finalize()
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
print(f"OK worker proc={p} results={len(res)}", flush=True)
api.finalize()
'''


def _surf_worker(path, pkg):
    path.write_text("import os\nimport sys\n\nimport numpy as np\n\n"
                    + SURF_PRELUDE[pkg] + SURF_BODY)
    return path


def test_windows_and_shmem_match_the_reference(tmp_path):
    ref = _job(tmp_path, "ref", 2, 2, {}, "ref", _surf_worker(tmp_path / "s_ref.py", "ref"))
    port = _job(tmp_path, "port", 2, 2, DEVICES, "port",
                _surf_worker(tmp_path / "s_port.py", "port"))
    assert_bitwise_equal(port, ref)
    # rank 0's word 7: 7.0, times rank 1's 0.25 in the PSCW epoch, plus
    # four fetch_and_op increments of 1.5
    assert port[0]["lock_mem0"][7] == 7 * 0.25 + 4 * 1.5


# -- the C ABI at --nranks 1 -----------------------------------------------


@pytest.fixture(scope="module")
def c_bins(tmp_path_factory):
    from test_torch_capi import EXAMPLES, compile_programs

    return compile_programs(tmp_path_factory.mktemp("capi_devices"), {
        name: EXAMPLES / f"{name}.c" for name in ("c_suite", "devsum")})


def test_c_suite_and_devsum_on_the_devices_layout(c_bins, tmp_path):
    from test_torch_capi import lines_with, run_c
    from test_torch_capi_planes import COUNT, _digests, devsum_digest

    res = run_c(2, c_bins["c_suite"], cwd=tmp_path, mca=DEVICES)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert len(lines_with(res.stdout, "CSUITE PASS")) == 2 and "FAIL" not in res.stdout
    # the Python planes: the collective's row is a RankShards of one
    res = run_c(2, c_bins["devsum"], cwd=tmp_path, mca={**DEVICES, "btl": "tcp"})
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert _digests(res.stdout) == {devsum_digest(COUNT, 2)}, res.stdout


def test_memchecker_guards_every_shard():
    from ompi_tpu_torch.tool import memchecker

    x = RankShards([torch.arange(4.0), torch.arange(4.0) + 1])
    memchecker.attach(True)
    try:
        guards = memchecker.guard_shards(x, "iallreduce")
        assert len(guards) == 2
        x[1][0] = 9.0
        guards[0].release()
        with pytest.raises(memchecker.MPIBufferError, match="iallreduce"):
            guards[1].release()
    finally:
        memchecker.attach(False)
    assert memchecker.guard_shards(x, "iallreduce") == []
