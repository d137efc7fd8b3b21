"""The ring-hop CUDA kernels on the card, against their plain twins.

Marked ``cuda``: they skip where there is no CUDA device.  On a machine
with one (which need not have JAX), run them without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

``chip_smoke.py`` runs the full grid of ops, dtypes and shapes; these
are the quick checks a kernel change should pass first.
"""

import pytest
import torch

from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.op import MAX, MIN, PROD, SUM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not ck.kernel_available():
        pytest.skip("the ring-hop kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("m", [1, 7, 1003, 4096])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_hop_matches_plain(dev, n, m):
    g = torch.Generator(device=dev).manual_seed(n * m)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8, torch.int64):
        raw = torch.randint(0, 256, ((n * n * m + 1) * dtype.itemsize,), generator=g,
                            device=dev, dtype=torch.uint8)
        src = raw.view(dtype)[1:].view(n, n, m)  # misaligned by one element
        si = torch.randint(0, n, (n,), generator=g, device=dev, dtype=torch.int32)
        di = torch.randint(0, n, (n,), generator=g, device=dev, dtype=torch.int32)
        got, want = torch.zeros_like(src), torch.zeros_like(src)
        ck.ring_hop(src, si, got, di)
        ck.ring_hop_plain(src, si, want, di)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), dtype


@pytest.mark.parametrize("op", [SUM, PROD, MAX, MIN], ids=lambda o: o.name)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.float64, torch.int32, torch.uint64])
def test_ring_hop_fold_matches_plain(dev, op, dtype):
    n, m = 8, 1001
    g = torch.Generator(device=dev).manual_seed(3)
    if dtype.is_floating_point:
        a = (torch.randn((n, n, m), generator=g, device=dev, dtype=torch.float64) * 100).to(dtype)
        a[:, :, ::7] = float("nan")
        a[:, :, 3::7] = -0.0
        a[:, :, 5::7] = torch.finfo(dtype).tiny / 4
    else:
        a = torch.randint(-(1 << 30), 1 << 30, (n, n, m), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int64 if dtype.itemsize == 8 else torch.int32)
        a = a.view(dtype)
    tbl = ck._index_table(n, dev)
    for recv_first in (False, True):
        got, want = a.clone(), a.clone()
        ck.ring_hop_fold(got, tbl[n - 1], got, tbl[0], got, tbl[n - 1], op, recv_first)
        ck.ring_hop_fold_plain(want, tbl[n - 1], want, tbl[0], want, tbl[n - 1], op, recv_first)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), recv_first


def test_cuda_ring_allreduce_counts_its_launches(dev):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.mesh import CommMesh

    n = 8
    comm = Comm(Group(range(n)), CommMesh(dev, n))
    x = torch.randn((n, 12345), device=dev)
    store = mca.default_context().store
    try:
        store.set("coll_cuda_allreduce_algorithm", 2)
        want = comm.allreduce(x, SUM)
        store.set("coll_cuda_allreduce_algorithm", 7)
        before = dict(ck.LAUNCHES)
        got = comm.allreduce(x, SUM)
        torch.cuda.synchronize()
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == {
        "ring_hop": n - 1, "ring_hop_fold": n - 1}
    assert torch.equal(got, want)


def test_p2p_payload_is_a_clone_on_the_card_that_wait_fences(dev):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.mesh import CommMesh

    comm = Comm(Group(range(4)), CommMesh(dev, 4))
    x = torch.randn(1 << 22, device=dev)
    want = x.clone()
    comm.send(x, 0, 1)
    x.zero_()  # the sender's buffer is reusable at once
    got, st = comm.recv(1, 0)
    assert got.device == x.device and st.nbytes == x.nbytes
    assert torch.equal(got, want)  # wait() returned after the clone landed


def test_window_epoch_and_convertor_stay_on_the_card(dev):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.ddt import FLOAT, pack, unpack
    from ompi_tpu_torch.mesh import CommMesh

    comm = Comm(Group(range(4)), CommMesh(dev, 4))
    win = comm.win_allocate(1000)
    assert win.device_view().device.type == "cuda"
    win.fence()
    win.accumulate(0, 1, torch.ones(1000, device=dev), op=SUM)
    cas = win.compare_and_swap(2, 1, 5.0, 1.0)
    win.fence()
    assert float(cas.wait()) == 1.0 and float(win.memory(1)[0]) == 5.0
    vec = FLOAT.create_vector(10, 3, 7)
    x = torch.randn(10 * 7 * 4, device=dev)
    packed = pack(x, vec, 4)
    assert packed.device.type == "cuda"
    assert torch.equal(packed.cpu(), torch.from_numpy(pack(x.cpu().numpy(), vec, 4)))
    y = torch.zeros_like(x)
    unpack(y, vec, 4, packed)
    assert torch.equal(pack(y, vec, 4), packed)


def test_iallreduce_waits_for_the_callers_write(dev, tmp_path):
    """han's i-collectives run on a worker thread whose stream is not
    the caller's: a 2-process job issues ``iallreduce`` on a side stream
    right after a delayed write to its input, and must get the sum of
    the written values (the worker waits on an event of the caller's
    stream; ``wait()`` orders the caller's stream after the result)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--nranks", "2",
         str(repo / "ompi_tpu_torch" / "examples" / "multiproc_smoke.py"), "--only", "stream"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(repo))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rows = [json.loads(ln.split("MPJSON ", 1)[1]) for ln in res.stdout.splitlines()
            if "MPJSON " in ln]
    assert sum(r["kind"] == "stream" and r["ok"] for r in rows) == 2, rows
