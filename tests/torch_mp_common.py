"""Shared helpers of the port's multi-process tests.

One SPMD worker body runs in both packages: ``mirrored_worker`` writes
it to a file with the package's prelude (imports, ``init``), so a job
launched by the port's ``python -m ompi_tpu_torch run`` and one launched
by the reference's ``python -m ompi_tpu run`` call the same collectives
on the same numpy inputs (made from a seed).  Each process saves its
results to ``<out>/<proc>.npz`` for the test to compare bit for bit, and
prints its DCN engine's class (both packages default to the native C
plane, ``NativeDcnEngine``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

PRELUDE = {
    "port": (
        "import ompi_tpu_torch.api as api\n"
        "from ompi_tpu_torch.op import MAX, PROD, SUM\n"
        "w = api.init(device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ompi_tpu')]\n"
        "assert not bad, bad\n"
    ),
    "ref": (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import ompi_tpu.api as api\n"
        "from ompi_tpu.op import MAX, PROD, SUM\n"
        "w = api.init()\n"
    ),
}

#: the SPMD body: every collective on seeded numpy data, numpy in and
#: numpy out in both packages (the han contract there)
BODY = r'''
out_dir = sys.argv[1]
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
assert w.coll.providers["allreduce"] == "han", w.coll.providers
print(f"ENGINE {type(w.dcn).__name__}", flush=True)
rng = np.random.default_rng(20261016)
X = rng.standard_normal((n, 5))
BIG = rng.standard_normal((n, 20000))      # 160 KB rows: above the ring threshold
RS = rng.standard_normal((n, n, 3))
mine, big, rs = X[lo:lo + ln], BIG[lo:lo + ln], RS[lo:lo + ln]
res = {}

def keep(name, v):
    if v is None:
        return
    if isinstance(v, (list, tuple)):
        for i, e in enumerate(v):
            keep(f"{name}.{i}", e)
        return
    res[name] = np.asarray(v)

keep("allreduce_sum", w.allreduce(mine, SUM))
keep("allreduce_prod", w.allreduce(mine, PROD))
keep("allreduce_max", w.allreduce(mine, MAX))
keep("allreduce_big", w.allreduce(big, SUM))
keep("bcast", w.bcast(mine, root=n - 1))
keep("reduce", w.reduce(mine, SUM, root=0))
keep("allgather", w.allgather(mine))
keep("gather", w.gather(mine, root=n - 1))
keep("scatter", w.scatter(X, root=0))
keep("reduce_scatter_block", w.reduce_scatter_block(rs, SUM))
keep("alltoall", w.alltoall(rs))
keep("scan", w.scan(mine, SUM))
keep("exscan", w.exscan(mine, SUM))
w.barrier()
# non-blocking and persistent variants
keep("iallreduce", w.iallreduce(mine, SUM).wait())
keep("ibcast", w.ibcast(mine, 0).wait())
keep("iallgather", w.iallgather(mine).wait())
keep("ialltoall", w.ialltoall(rs).wait())
keep("iscan", w.iscan(mine, SUM).wait())
req = w.allreduce_init(mine, MAX)
for k in range(2):
    req.start()
    keep(f"allreduce_init{k}", req.wait())
# jagged variants
blocks = [np.full((2, lo + l + 1), lo + l, np.int32 if (lo + l) % 2 else np.float64)
          for l in range(ln)]
keep("allgatherv", w.allgatherv(blocks))
keep("scatterv", w.scatterv([np.arange(r + 1, dtype=np.float32) * r for r in range(n)]
                            if p == 0 else None, root=0))
keep("alltoallv", w.alltoallv([[np.full((lo + l + 1, j + 1), 10 * (lo + l) + j, np.int64)
                                for j in range(n)] for l in range(ln)]))
counts = [1 + r % 2 for r in range(n)]
keep("reduce_scatter_jagged", w.reduce_scatter(
    rng.standard_normal((n, sum(counts), 2))[lo:lo + ln], SUM, counts))
# communicator management: split by parity, then a dup
subs = w.split([(lo + l) % 2 for l in range(ln)], keys=[-(lo + l) for l in range(ln)]
               if n == 3 else None)
for l, sub in enumerate(subs):
    if l == 0 or sub is not subs[l - 1]:
        s_in = X[lo + l:lo + l + sub.local_size] * (sub.local_offset + 1)
        keep(f"split{(lo + l) % 2}.allreduce", sub.allreduce(s_in, SUM))
        keep(f"split{(lo + l) % 2}.allgather", sub.allgather(s_in))
        keep(f"split{(lo + l) % 2}.size", np.array([sub.size, sub.local_offset]))
d = w.dup()
keep("dup_allreduce", d.allreduce(mine, SUM))
# point-to-point: every rank sends its row to the next global rank,
# then receives from the previous (remote sends are eager: no deadlock)
for l in range(ln):
    r = lo + l
    w.send(mine[l] * 3, source=r, dest=(r + 1) % n, tag=40 + r)
for l in range(ln):
    r = lo + l
    src = (r - 1) % n
    payload, st = w.recv(dest=r, source=src, tag=40 + src)
    assert st.source == src and st.tag == 40 + src, (st.source, st.tag)
    keep(f"p2p{r}", payload)
# dup'd comm isolation: the same (src, tag) on two comms
if lo == 0:
    d.send(np.int64(777), source=0, dest=n - 1, tag=5)
    w.send(np.int64(111), source=0, dest=n - 1, tag=5)
if lo + ln == n:
    a, _ = w.recv(dest=n - 1, source=0, tag=5)
    b, _ = d.recv(dest=n - 1, source=0, tag=5)
    keep("isolation", np.concatenate([np.ravel(a), np.ravel(b)]))
d.free()
# probe before the receive; iprobe finds nothing on an unused tag
if lo == 0:
    w.send(np.arange(3.0) + p, source=0, dest=n - 1, tag=77)
if lo + ln == n:
    assert w.iprobe(dest=n - 1, source=0, tag=78) is None
    st = w.probe(dest=n - 1, source=0, tag=77)
    assert st.source == 0 and st.tag == 77, (st.source, st.tag)
    keep("probe_recv", w.recv(dest=n - 1, source=0, tag=77)[0])
# MPI_Comm_create_group over ranks [0, n-1): collective over its members
if lo < n - 1:
    g = w.create_group_members(list(range(n - 1)), tag=3)
    g_in = X[lo:lo + g.local_size] * 2
    keep("group_allreduce", g.allreduce(g_in, SUM))
    keep("group_bcast", g.bcast(g_in, root=g.size - 1))
    keep("group_size", np.array([g.size, g.local_offset]))
    g.free()
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
print(f"OK worker proc={p} results={len(res)}", flush=True)
api.finalize()
'''


def mirrored_worker(path: Path, pkg: str) -> Path:
    path.write_text("import os\nimport sys\n\nimport numpy as np\n\n"
                    + PRELUDE[pkg] + BODY)
    return path


def run_job(pkg: str, nprocs: int, nranks: int, script: Path, args=(),
            mca: dict | None = None, timeout: float = 150, flags=()):
    """Launch ``script`` under the package's launcher (``flags``: more
    launcher options, e.g. ``--ft``); returns the CompletedProcess
    (stdout and stderr as text)."""
    if pkg == "port":
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(nprocs),
               "--nranks", str(nranks)]
    else:
        cmd = [sys.executable, "-m", "ompi_tpu", "run", "-np", str(nprocs),
               "--cpu-devices", str(nranks)]
    cmd += list(flags)
    for k, v in (mca or {}).items():
        cmd += ["--mca", k, str(v)]
    cmd += [str(script), *map(str, args)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)  # the reference's workers get cpu from --cpu-devices
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=str(REPO))


def load(out: Path, nprocs: int) -> list[dict]:
    return [dict(np.load(out / f"{p}.npz")) for p in range(nprocs)]


def assert_bitwise_equal(a: list[dict], b: list[dict]) -> None:
    for p, (ra, rb) in enumerate(zip(a, b)):
        assert sorted(ra) == sorted(rb), (p, sorted(set(ra) ^ set(rb)))
        for k in ra:
            x, y = ra[k], rb[k]
            assert x.shape == y.shape and x.dtype == y.dtype, (p, k, x.shape, y.shape,
                                                               x.dtype, y.dtype)
            assert x.tobytes() == y.tobytes(), (p, k)


def fake_cards(monkeypatch, count: int) -> None:
    """Make ``torch.cuda`` report ``count`` cards, every two of them
    peers (the placement code asks nothing more; no kernel runs)."""
    import types

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: types.SimpleNamespace(
        pci_domain_id=0, pci_bus_id=i, pci_device_id=0))


def reborn_init(monkeypatch, proc: int, nprocs: int, nranks: int, device,
                incarnation: int = 1):
    """The port's ``init()`` in a process the launcher respawned (process
    ``proc`` of ``nprocs``, ``OMPI_TPU_INCARNATION`` set) on the devices
    layout, with the modex and the DCN engine left out: returns the world
    mesh the multi-process communicator would be built on."""
    import ompi_tpu_torch.api as tapi
    from ompi_tpu_torch.api import multiproc
    from ompi_tpu_torch.boot import proc as bproc

    built = {}

    class World:
        procctx = None
        local_offset = 0

        def __init__(self, ctx, wm, name=""):
            built["mesh"], self.size, self.proc = wm, wm.size, proc

        def free(self):
            pass

    monkeypatch.setattr(bproc, "ProcContext", lambda local_size=None: None)
    monkeypatch.setattr(multiproc, "MultiProcComm", World)
    monkeypatch.setenv(bproc.ENV_PROC, str(proc))
    monkeypatch.setenv(bproc.ENV_NPROCS, str(nprocs))
    monkeypatch.setenv(bproc.ENV_INCARNATION, str(incarnation))
    tapi.finalize()
    try:
        tapi.init({"accelerator_cuda_layout": "devices"}, device=device, nranks=nranks)
    finally:
        tapi.finalize()
    return built["mesh"]
