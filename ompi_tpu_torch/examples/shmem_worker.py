"""The port's shmem API across real processes, one PE per process.

Port of ``tests/workers/shmem_worker.py`` for ``python -m
ompi_tpu_torch run -np 3 --nranks 1`` (add ``--cpu`` without a card):
heap symmetry, a ring put, the get back, atomics on PE 0 (an ``int64``
counter and a ``uint64`` sum past 2**63), collectives, a distributed
lock guarding a read-modify-write, a signaled put around the ring and a
team of the even PEs.  The heap and every result are tensors on the
world's device.  Each PE prints ``OK shmem_py pe=<pe> device=<device>``
when every check held, then finalizes the world (writing the metrics
file ``--mca metrics_enable 1`` asks for); a failed check exits
non-zero.
"""

import numpy as np
import torch

import ompi_tpu_torch.api as api
import ompi_tpu_torch.shmem as shmem


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check(cond, what) -> None:
    if not cond:
        raise SystemExit(f"shmem worker pe={shmem.my_pe()}: {what}")


shmem.init(heap_bytes=1 << 20)
me = shmem.my_pe()
n = shmem.n_pes()
check(n == 3, f"n_pes {n}")

a = shmem.malloc(8, np.int64)
ctr = shmem.malloc(1, np.int64)
a.view().fill_(-1)
ctr.view().zero_()
device = a.view().device
shmem.barrier_all()

# ring put: each PE writes a marker array into its RIGHT neighbor's
# symmetric slice (each PE receives exactly one put — no write race)
right = (me + 1) % n
left = (me - 1 + n) % n
marker = np.full(8, -1, np.int64)
marker[me] = 1000 + me
shmem.put(a, marker, right)
shmem.barrier_all()
mine = host(a.view())
check(mine[left] == 1000 + left, mine)

got = shmem.get(a, right)
check(got.device == device and int(got[me]) == 1000 + me, got)

# atomics: everyone bumps PE 0's counter
before = shmem.atomic_fetch_add(ctr, 1, 0)
check(0 <= before < n, before)
shmem.barrier_all()
check(shmem.atomic_fetch(ctr, 0) == n, "counter")

# collectives
s = shmem.sum_to_all(np.ones((1, 2)))
check(np.array_equal(host(s), np.full((1, 2), 3.0)), s)
b = shmem.broadcast(np.full((1, 4), float(me)), 0)
check(np.array_equal(host(b), np.zeros((1, 4))), b)

# an unsigned word crosses processes through its signed carrier: each
# PE adds a value with bit 62 set into PE 0's uint64 word
acc = shmem.malloc(1, np.uint64)
acc.view().zero_()
shmem.barrier_all()
shmem.atomic_fetch_add(acc, (1 << 62) + me, 0)
shmem.barrier_all()
check(shmem.atomic_fetch(acc, 0) == n * (1 << 62) + n * (n - 1) // 2, "uint64 sum")

shmem.barrier_all()

# phase 2: distributed lock guards a non-atomic RMW on PE 0
lk = shmem.malloc(1, np.int64)
cell = shmem.malloc(1, np.int64)
lk.view().zero_()
cell.view().zero_()
shmem.barrier_all()
for _ in range(4):
    shmem.set_lock(lk)
    cur = int(shmem.get(cell, 0)[0])
    shmem.put(cell, np.asarray([cur + 1], np.int64), 0)
    shmem.quiet()
    shmem.clear_lock(lk)
shmem.barrier_all()
check(int(shmem.get(cell, 0)[0]) == 4 * n, "lock-guarded count")

# signaled put around the ring + signal_wait_until
dest = shmem.malloc(2, np.float64)
sig = shmem.malloc(1, np.uint64)
sig.view().zero_()
shmem.barrier_all()
shmem.put_signal(dest, np.asarray([me + 0.25, me + 0.75]), sig, 1,
                 right, shmem.SIGNAL_SET)
check(shmem.signal_wait_until(sig, shmem.CMP_EQ, 1) == 1, "signal")
mine = host(dest.view())
check(mine[0] == left + 0.25 and mine[1] == left + 0.75, mine)

# team of the even PEs: sync + reduction over a REAL sub-communicator
ev = shmem.team_split_strided(0, 2, (n + 1) // 2)
if me % 2 == 0:
    check(ev is not None and ev.my_pe() == me // 2, "team membership")
    ev.sync()
    s = ev.sum_reduce(np.asarray([[float(me)]]))
    expect = float(sum(p for p in range(0, n, 2)))
    check(float(host(s).ravel()[0]) == expect, s)
    ev.destroy()
else:
    check(ev is None, "non-member got a team")

shmem.barrier_all()
shmem.finalize()
print(f"OK shmem_py pe={me} device={device}", flush=True)
api.finalize()
