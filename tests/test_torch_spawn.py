"""Dynamic process management of the port against the reference's, after
``tests/test_multiproc.py::test_tpurun_comm_spawn``.

A 2-process job spawns 2 children; p2p crosses the worlds both ways, the
merged 4-process comm runs collectives, a cross-world ``dup`` (CID
agreement spans both worlds) and a window, the high-flag merge puts the
children first, and freeing the intercomm leaves the merged comm
working.  The same parent and child bodies (written into ``tmp_path``
with each package's prelude) run under both launchers, each process of
one and two ranks; every rank's results on seeded float64 data are
saved, and the port's must be bit-equal to the reference's (han on
both sides, folding the same float64 rows in the same order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_mp_common import REPO, assert_bitwise_equal

PRELUDE = {
    "port": ("import ompi_tpu_torch.api as api\n"
             "from ompi_tpu_torch.op import SUM\n"
             "w = api.init(device='cpu')\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ompi_tpu')]\n"
             "assert not bad, bad\n"),
    "ref": ("import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import ompi_tpu.api as api\n"
            "from ompi_tpu.op import SUM\n"
            "w = api.init()\n"),
}

COMMON = r'''
out_dir = sys.argv[1]
X = np.random.default_rng(20261021).standard_normal((64, 6))
res = {}


def merged_checks(m, tag):
    lo, ln = m.local_offset, m.local_size
    res[f"{tag}.sum"] = np.asarray(m.allreduce(X[lo:lo + ln], SUM))
    assert np.allclose(res[f"{tag}.sum"], X[:m.size].sum(0)), tag
    ones = np.asarray(m.allreduce(np.ones((ln, 2)), SUM))
    assert np.array_equal(ones, np.full((ln, 2), float(m.size))), ones
    d = m.dup()
    rows = np.repeat(np.arange(lo + 1.0, lo + ln + 1.0)[:, None], 3, 1)
    got = np.asarray(d.bcast(rows, root=m.size - 1))
    assert np.array_equal(got, np.full((ln, 3), float(m.size))), got
    res[f"{tag}.gather"] = np.asarray(d.allgather(X[lo:lo + ln, :2]))
    d.free()
'''

PARENT = r'''
assert w.nprocs == 2 and api.get_parent() is None
ic = api.spawn([sys.argv[2], out_dir], maxprocs=2)
assert ic.size == w.size and ic.remote_size == w.size, (ic.size, ic.remote_size)
if w.proc == 0:
    ic.send(np.array([123.0]), source=0, dest=0, tag=7)
if w.proc == 1:
    pay, st = ic.recv(dest=w.local_offset, source=0, tag=8)
    assert float(np.asarray(pay)[0]) == 321.0 and st.source == 0
m = ic.merge()
assert m.size == 2 * w.size and m.nprocs == 4 and m.proc == w.proc
merged_checks(m, "m")
m2 = ic.merge(high=True)  # parents high, children low: children first
assert m2.local_offset == w.size + w.local_offset, m2.local_offset
merged_checks(m2, "m2")
mw = m.win_create([np.zeros(2) for _ in range(m.local_size)])
mw.fence()
for l in range(m.local_size):
    r = m.local_offset + l
    mw.put((r + 1) % m.size, np.array([float(r)]), disp=0)
mw.fence()
for l in range(m.local_size):
    r = m.local_offset + l
    assert np.asarray(mw.memory(r))[0] == float((r - 1) % m.size)
mw.free()
ic.free()
res["after_free"] = np.asarray(m.allreduce(np.ones((m.local_size, 1)), SUM))
np.savez(os.path.join(out_dir, f"parent{w.proc}.npz"), **res)
print(f"OK spawn_parent proc={w.proc}", flush=True)
api.finalize()
'''

CHILD = r'''
parent = api.get_parent()
assert parent is not None and api.get_parent() is parent
assert parent.remote_size == parent.size == w.size
if w.proc == 0:
    pay, st = parent.recv(dest=0, source=0, tag=7)
    assert float(np.asarray(pay)[0]) == 123.0 and st.source == 0
    parent.send(np.array([321.0]), source=0, dest=w.size // 2, tag=8)
m = parent.merge()
merged_checks(m, "m")
m2 = parent.merge(high=False)
assert m2.local_offset == w.local_offset, m2.local_offset
merged_checks(m2, "m2")
mw = m.win_create([np.zeros(2) for _ in range(m.local_size)])
mw.fence()
for l in range(m.local_size):
    r = m.local_offset + l
    mw.put((r + 1) % m.size, np.array([float(r)]), disp=0)
mw.fence()
for l in range(m.local_size):
    r = m.local_offset + l
    assert np.asarray(mw.memory(r))[0] == float((r - 1) % m.size)
mw.free()
parent.free()
res["after_free"] = np.asarray(m.allreduce(np.ones((m.local_size, 1)), SUM))
np.savez(os.path.join(out_dir, f"child{w.proc}.npz"), **res)
print(f"OK spawn_child proc={w.proc} merged={m.nprocs}", flush=True)
api.finalize()
'''


def _spawn_job(tmp_path, pkg, nranks):
    out = tmp_path / f"{pkg}{nranks}"
    out.mkdir()
    head = "import os\nimport sys\n\nimport numpy as np\n\n" + PRELUDE[pkg] + COMMON
    parent, child = out / "parent.py", out / "child.py"
    parent.write_text(head + PARENT)
    child.write_text(head + CHILD)
    if pkg == "port":
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "--nranks", str(nranks)]
    else:
        cmd = [sys.executable, "-m", "ompi_tpu", "run", "--cpu-devices", str(nranks)]
    cmd += ["-np", "2", str(parent), str(out), str(child)]
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    lines = res.stdout.splitlines()
    assert sum("OK spawn_parent " in ln for ln in lines) == 2, res.stdout
    assert sum("OK spawn_child " in ln and "merged=4" in ln for ln in lines) == 2, res.stdout
    return [dict(np.load(out / f"{role}{p}.npz")) for role in ("parent", "child")
            for p in range(2)]


@pytest.mark.parametrize("nranks", [1, 2])
def test_tpurun_comm_spawn_matches_reference(tmp_path, nranks):
    assert_bitwise_equal(_spawn_job(tmp_path, "port", nranks),
                         _spawn_job(tmp_path, "ref", nranks))
