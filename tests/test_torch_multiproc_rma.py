"""Windows across processes (``MultiProcComm.win_*``, ``osc/dcn.py``)
against the reference's, after ``tests/workers/mp_rma_worker.py``.

One SPMD body runs under both launchers (2 processes × 2 ranks, the
default ``btl/native``, RMA envelopes delivered by the dispatcher
thread): fence epochs of put and accumulate (integer-valued, so the
arrival order cannot change the sums), get, fetch_and_op,
compare_and_swap, lock/unlock, flush, a MAX accumulate, and a window on
a split sub-communicator.  Each process saves what it read and what its
window holds; the two jobs agree bit for bit.  The port's job then
checks what only it has: ``win_allocate`` on the comm's device returns
tensors and keeps the window memory there, and ``win_create_dynamic``
attaches a region.
"""

from torch_mp_common import PRELUDE, assert_bitwise_equal, load, run_job

BODY = r'''
out_dir = sys.argv[1]
p, ln, n, lo = w.proc, w.local_size, w.size, w.local_offset
res = {}
win = w.win_create([np.full(8, float(lo + l), np.float64) for l in range(ln)])
res["sizes"] = np.array(win.sizes)
win.fence()
for l in range(ln):
    r = lo + l
    win.put(0, np.array([100.0 + r]), disp=r)
    for t in range(n):
        win.accumulate(t, np.array([1.0 + r]), disp=7, op=SUM)
win.fence()
res["fence"] = np.stack([np.asarray(win.memory(lo + l)) for l in range(ln)])
res["get"] = np.stack([win.get((lo + l + 1) % n, count=8) for l in range(ln)])
win.fence()
win.fence()
win.fetch_and_op(1, 10.0, disp=0, op=SUM)
win.fence()
res["fao"] = np.stack([np.asarray(win.memory(lo + l)) for l in range(ln)])
win.compare_and_swap(n - 1, value=500.0 + p, compare=float(n - 1), disp=1)
win.fence()
if lo + ln == n:
    res["cas_won"] = np.array([float(np.asarray(win.memory(n - 1))[1]) in
                               [500.0 + q for q in range(w.nprocs)]])
win.lock(0)
win.put(0, np.array([7.5]), disp=6)
win.unlock(0)
win.accumulate(0, np.array([999.0 + p]), disp=6, op=MAX)
win.flush(0)
w.barrier()
if lo == 0:
    res["passive"] = np.asarray(win.memory(0)).copy()
sub = w.split([0 if (lo + l) % 2 == 0 else 1 for l in range(ln)])
for l, s in enumerate(sub):
    if l == 0 or s is not sub[l - 1]:
        swin = s.win_create([np.zeros(2) for _ in range(s.local_size)])
        swin.fence()
        for sl in range(s.local_size):
            sr = s.local_offset + sl
            swin.put((sr + 1) % s.size, np.array([float(10 + sr)]), disp=0)
        swin.fence()
        res[f"sub{(lo + l) % 2}"] = np.stack([np.asarray(swin.memory(s.local_offset + sl))
                                              for sl in range(s.local_size)])
        swin.free()
win.free()
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
print(f"OK rma proc={p}", flush=True)
'''

#: what only the port has: windows of tensors on the comm's device
PORT_ONLY = r'''
import torch
t = w.win_allocate(4, np.float32)
assert all(isinstance(t.memory(lo + l), torch.Tensor) and t.memory(lo + l).device == w.device
           for l in range(ln))
t.fence()
for l in range(ln):
    t.accumulate((lo + l + 1) % n, torch.full((4,), float(lo + l + 1)), 0, SUM)
t.fence()
assert all(torch.equal(t.memory(lo + l), torch.full((4,), float((lo + l - 1) % n + 1)))
           for l in range(ln))
assert float(t.fetch_and_op((lo + ln) % n, 2.0, 1, SUM)) == float(lo + ln)
t.fence()
t.free()
d = w.win_create_dynamic(np.float64)
region = np.zeros(3)
for l in range(ln):
    d.attach(l, 0x10 + l, region if l == 0 else np.zeros(3))
d.fence()
if lo == 0:
    d.put(0, np.array([1.0, 2.0, 3.0]), 0)
d.fence()
if lo == 0:
    assert region.tolist() == [1.0, 2.0, 3.0] and d.memory(0) is region, region
d.free()
print(f"OK tensor windows proc={p}", flush=True)
'''


def _job(tmp_path, pkg):
    out = tmp_path / pkg
    out.mkdir()
    script = tmp_path / f"rma_{pkg}.py"
    script.write_text("import os\nimport sys\n\nimport numpy as np\n\n" + PRELUDE[pkg] + BODY
                      + (PORT_ONLY if pkg == "port" else "") + "api.finalize()\n")
    res = run_job(pkg, 2, 2, script, [out], timeout=150)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.count("OK rma") == 2, res.stdout
    return res, load(out, 2)


def test_windows_across_processes_match_reference(tmp_path):
    port_res, port = _job(tmp_path, "port")
    _, ref = _job(tmp_path, "ref")
    assert_bitwise_equal(port, ref)
    assert port_res.stdout.count("OK tensor windows") == 2, port_res.stdout
    # rank 0 holds every rank's put, and each rank's slot 7 the four adds
    assert port[0]["fence"][0][:4].tolist() == [100.0, 101.0, 102.0, 103.0]
    assert [int(r[7]) for r in port[0]["fence"]] == [10, 11]
    assert port[1]["cas_won"].tolist() == [True] and port[0]["passive"][6] == 1000.0
