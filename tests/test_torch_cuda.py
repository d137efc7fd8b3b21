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


def _edge_lengths(dtype):
    """One tile of the kernels' grid less and more one element, and
    several tiles and stages with a ragged end."""
    tile = ck.HOP_TILE_BYTES // dtype.itemsize
    return (tile - 1, tile + 1, (1 << 20) + 3)


def _at(shape, dtype, dev, offset, like=None):
    """``shape`` of ``dtype`` starting ``offset`` elements into a fresh
    allocation: zeros, or a copy of ``like``."""
    numel = 1
    for d in shape:
        numel *= d
    out = torch.zeros(numel + offset, dtype=dtype, device=dev)[offset:].view(shape)
    if like is not None:
        out.copy_(like)
    return out


def _edge_input(shape, dtype, g, dev):
    if dtype.is_floating_point:
        a = (torch.randn(shape, generator=g, device=dev, dtype=torch.float64) * 100).to(dtype)
        a[..., ::7] = float("nan")
        a[..., 3::7] = -0.0
        a[..., 5::7] = torch.finfo(dtype).tiny / 4
        return a
    wide = torch.int64 if dtype.itemsize == 8 else torch.int32
    return torch.randint(-(1 << 30), 1 << 30, shape, generator=g, device=dev,
                         dtype=torch.int64).to(wide).view(dtype)


#: element offsets of (source, destination): the ends agree modulo 16
#: (aligned or not) and disagree
_OFFSETS = ((0, 0), (1, 1), (1, 0), (0, 1))


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8, torch.float64],
                         ids=str)
def test_ring_hop_tiles_and_offsets(dev, dtype, n):
    """Chunks across tile and stage edges, at offsets that make a rank's
    ends agree (16-byte body, peeled head and tail) or disagree
    (narrower words), out of place and in place: bit-equal to the twin."""
    g = torch.Generator(device=dev).manual_seed(n)
    tbl = ck._index_table(n, dev)
    for m in _edge_lengths(dtype):
        raw = torch.randint(0, 256, (n * n * m * dtype.itemsize,), generator=g, device=dev,
                            dtype=torch.uint8).view(dtype).view(n, n, m)
        si = torch.randint(0, n, (n,), generator=g, device=dev, dtype=torch.int32)
        di = torch.randint(0, n, (n,), generator=g, device=dev, dtype=torch.int32)
        for so, do in _OFFSETS:
            src = _at(raw.shape, dtype, dev, so, raw)
            got, want = _at(raw.shape, dtype, dev, do), _at(raw.shape, dtype, dev, do)
            ck.ring_hop(src, si, got, di)
            ck.ring_hop_plain(src, si, want, di)
            ip = src.clone()
            ck.ring_hop(src, tbl[1], src, tbl[0])
            ck.ring_hop_plain(ip, tbl[1], ip, tbl[0])
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (m, so, do)
            assert torch.equal(_bits(src), _bits(ip)), (m, so, "in place")


@pytest.mark.parametrize("op", [SUM, PROD, MAX, MIN], ids=lambda o: o.name)
@pytest.mark.parametrize("dtype", list(ck._FOLD_DTYPES), ids=str)
def test_ring_hop_fold_tiles_and_offsets(dev, dtype, op):
    """The fold across tile and stage edges, in place at an offset and
    out of place into a destination whose ends agree or disagree with
    the operands' modulo 16, both operand orders: bit-equal to the twin."""
    n = 8
    g = torch.Generator(device=dev).manual_seed(5)
    tbl = ck._index_table(n, dev)
    ri, sent = tbl[n - 1], tbl[0]
    for m in _edge_lengths(dtype):
        x = _edge_input((n, n, m), dtype, g, dev)
        for so, do in _OFFSETS[:3]:
            for recv_first in (False, True):
                a = _at(x.shape, dtype, dev, so, x)
                want = x.clone()
                ck.ring_hop_fold(a, ri, a, sent, a, ri, op, recv_first)
                ck.ring_hop_fold_plain(want, ri, want, sent, want, ri, op, recv_first)
                d, dw = _at((n, 1, m), dtype, dev, do), _at((n, 1, m), dtype, dev, do)
                src = _at(x.shape, dtype, dev, so, x)
                ck.ring_hop_fold(src, ri, src, sent, d, tbl[n], op, recv_first)
                ck.ring_hop_fold_plain(src, ri, src, sent, dw, tbl[n], op, recv_first)
                torch.cuda.synchronize()
                assert torch.equal(_bits(a), _bits(want)), (m, so, recv_first)
                assert torch.equal(_bits(d), _bits(dw)), (m, so, do, recv_first)


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
        "ring_hop": n - 1, "ring_hop_fold": n - 1, "ring_hop_peer": 0, "ring_hop_wait": 0}
    assert torch.equal(got, want)


@pytest.mark.parametrize("epoch", [0, (1 << 64) - 3])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_hop_peer_matches_plain(dev, n, epoch):
    """The cross-device hop over ranks that each own a buffer (on one
    card all of them on ``dev``), at source and destination element
    offsets that agree (0 and 1: the body moves in 16-byte words) and
    disagree (narrower words), with counters from 0 and from near 2^64
    (the signed compare across the wrap)."""
    from ompi_tpu_torch.mesh import CommMesh

    mesh = CommMesh(dev, n, layout="devices")
    ring = ck.PeerRing(mesh.devices, epoch=epoch)
    g = torch.Generator(device=dev).manual_seed(n)
    for m in (1, 1003):
        for so, do in ((0, 0), (1, 1), (1, 0), (0, 1)):
            for dtype in (torch.float32, torch.bfloat16, torch.uint8, torch.complex64):
                raw = [torch.randint(0, 256, ((m + 1) * dtype.itemsize,), generator=g,
                                     device=d, dtype=torch.uint8).view(dtype)
                       for d in mesh.devices * 2]
                srcs, got = raw[:n], raw[n:]
                want = [t.clone() for t in got]
                ck.ring_hop_peer_plain(srcs, [so] * n, want, [do] * n, m)
                ck.ring_hop_peer(srcs, [so] * n, got, [do] * n, m, ring)
                torch.cuda.synchronize()
                assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    ring.check()
    assert ring.hops == epoch + 2 * 4 * 4


def test_devices_layout_allreduce_matches_the_rows_layout(dev):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.mesh import CommMesh
    from ompi_tpu_torch.mesh.shards import RankShards

    n = 8
    rows = Comm(Group(range(n)), CommMesh(dev, n))
    devs = Comm(Group(range(n)), CommMesh(dev, n, layout="devices"))
    x = torch.randn((n, 12345), device=dev)
    store = mca.default_context().store
    try:
        store.set("coll_cuda_allreduce_algorithm", 7)
        want = rows.allreduce(x, SUM)
        before = dict(ck.LAUNCHES)
        got = devs.allreduce(RankShards([x[r].to(d, copy=True)
                                         for r, d in enumerate(devs.mesh.devices)]), SUM)
        torch.cuda.synchronize()
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)
    # per hop one put and two waits on each card the ranks lie on
    hops, cards = 2 * (n - 1), len({d.index for d in devs.mesh.devices})
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == {
        "ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": hops * cards,
        "ring_hop_wait": 2 * hops * cards}
    assert all(torch.equal(got[r].to(dev), want[r]) for r in range(n))
    ck.peer_ring(devs.mesh).check()


def _layouts(dev, n=8):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.mesh import CommMesh

    rows = Comm(Group(range(n)), CommMesh(dev, n))
    devs = Comm(Group(range(n)), CommMesh(dev, n, layout="devices"))
    return rows, devs


def _shards_of(x, mesh):
    from ompi_tpu_torch.mesh.shards import RankShards

    return RankShards([x[r].to(d, copy=True) for r, d in enumerate(mesh.devices)])


def test_request_over_shards_waits_on_every_card(dev):
    """An ``iallreduce`` over shards on every card of the machine records
    one event per card; its wait leaves every card's stream past the
    collective, and the result equals the blocking call's."""
    rows, devs = _layouts(dev)
    x = torch.randn((8, 1 << 20), device=dev)
    shards = _shards_of(x, devs.mesh)
    want = devs.allreduce(shards, SUM)
    req = devs.iallreduce(shards, SUM)
    assert len(req._events) == len({d.index for d in devs.mesh.devices})
    got = req.wait()
    assert all(ev.query() for ev in req._events)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got.shards, want.shards))
    torch.testing.assert_close(got[0].to(dev), rows.allreduce(x, SUM)[0], rtol=1e-5,
                               atol=1e-5 * 8 * x.abs().max().item())
    ck.peer_ring(devs.mesh).check()


@pytest.mark.parametrize("algo", ["psum", "cuda_ring"])
def test_outstanding_iallreduce_then_allreduce_on_one_ring(dev, algo):
    """An ``iallreduce`` left outstanding while a blocking ``allreduce``
    runs on the same peer ring: the second call's puts must not land in a
    zone the first still reads (the epochs and the ``consumed`` credit).
    Both results are bit-equal to the same calls made one at a time."""
    from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
    from ompi_tpu_torch.core import mca

    _, devs = _layouts(dev)
    a = _shards_of(torch.randn((8, 3 << 20), device=dev), devs.mesh)
    b = _shards_of(torch.randn((8, 3 << 20), device=dev), devs.mesh)
    store = mca.default_context().store
    try:
        store.set("coll_cuda_allreduce_algorithm", ALLREDUCE_ALGOS[algo])
        want_a, want_b = devs.allreduce(a, SUM), devs.allreduce(b, SUM)
        torch.cuda.synchronize()
        req = devs.iallreduce(a, SUM)
        got_b = devs.allreduce(b, SUM)
        got_a = req.wait()
        torch.cuda.synchronize()
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got.shards, want.shards))
    ck.peer_ring(devs.mesh).check()


def test_psum_on_cuda_shards_launches_the_peer_kernels(dev, monkeypatch):
    """``auto`` (tuned's ``psum`` for SUM at every size) and reduce_scatter
    ``auto`` (``direct``) on CUDA shards run the ring over the hop: one
    put and two wait launches per card per hop, never the plain twin."""
    rows, devs = _layouts(dev)
    n, cards = 8, len({d.index for d in devs.mesh.devices})

    def no_plain(*_a, **_k):
        raise AssertionError("the plain twin ran on CUDA shards")

    monkeypatch.setattr(ck, "ring_hop_peer_plain", no_plain)
    x = torch.randn((n, 100003), device=dev)
    xx = torch.randn((n, n, 4099), device=dev)
    for call, hops, want in (
            (lambda: devs.allreduce(_shards_of(x, devs.mesh), SUM), 2 * (n - 1),
             rows.allreduce(x, SUM)),
            (lambda: devs.reduce_scatter_block(_shards_of(xx, devs.mesh), SUM), n - 1,
             rows.reduce_scatter_block(xx, SUM))):
        before = dict(ck.LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        assert {k: ck.LAUNCHES[k] - before[k] for k in before} == {
            "ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": hops * cards,
            "ring_hop_wait": 2 * hops * cards}
        for r in range(n):
            torch.testing.assert_close(got[r].to(dev), want[r], rtol=1e-5,
                                       atol=1e-5 * n * 8)
    ck.peer_ring(devs.mesh).check()


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


def test_cross_card_send_hands_over_the_old_bytes(dev):
    """A devices-layout send from the first rank's card to the last's:
    the payload lands on the receiver's card, and a sender that zeroes
    its tensor right after ``send`` still hands over the old bytes."""
    _, devs = _layouts(dev)
    src, dst = 0, 7
    x = torch.randn(1 << 24, device=devs.mesh.devices[src])
    want = x.clone()
    devs.send(x, src, dst)
    x.zero_()
    got, st = devs.recv(dst, src)
    assert got.device == devs.mesh.devices[dst] and st.nbytes == want.nbytes
    assert torch.equal(_bits(got.to(want.device)), _bits(want))


def test_get_after_a_fence_sees_another_cards_puts(dev):
    """Rank 0 puts and accumulates into rank 3's region (another card
    where there are several); after the fence rank 7 gets it onto its own
    card and sees both."""
    from ompi_tpu_torch.mesh.shards import RankShards

    _, devs = _layouts(dev)
    m = 1 << 22
    win = devs.win_allocate(m)
    data = torch.randn(m, device=devs.mesh.devices[0])
    win.fence()
    win.put(0, 3, data)
    win.accumulate(0, 3, data, op=SUM)
    win.fence()
    g = win.get(7, 3, m)
    win.fence()
    got = g.wait()
    assert got.device == devs.mesh.devices[7] and win.memory(3).device == devs.mesh.devices[3]
    assert torch.equal(_bits(got.to(data.device)), _bits(data + data))
    view = win.device_view()
    assert isinstance(view, RankShards) and view.devices == devs.mesh.devices


def test_restore_puts_shard_r_on_rank_rs_card(dev, tmp_path):
    from ompi_tpu_torch.io import checkpoint
    from ompi_tpu_torch.mesh.shards import RankShards

    _, devs = _layouts(dev)
    x = torch.randn((8, 1 << 20), device=dev)
    checkpoint.save(devs, str(tmp_path / "c"), _shards_of(x, devs.mesh))
    got, manifest = checkpoint.restore(devs, str(tmp_path / "c"))
    assert isinstance(got, RankShards) and got.devices == devs.mesh.devices
    assert manifest["shape"] == [8, 1 << 20]
    assert all(torch.equal(_bits(got[r].to(dev)), _bits(x[r])) for r in range(8))


def test_typed_allreduce_on_shards_launches_the_peer_kernels(dev):
    """A packed PROD ``allreduce_ddt`` over tensors on each rank's card
    under ``auto`` (tuned's ``cuda_ring`` at 64 MiB) runs the shard ring:
    one put and two wait launches per card per hop, bit-equal to the rows
    layout's same call."""
    from ompi_tpu_torch.ddt import FLOAT

    rows, devs = _layouts(dev)
    n, cards = 8, len({d.index for d in devs.mesh.devices})
    vec = FLOAT.create_vector(1024, 4, 5).commit()
    count = (64 << 20) // vec.size
    bufs = 1 + 1e-3 * torch.randn((n, (vec.lb + vec.span(count)) // 4), device=dev)
    want = rows.allreduce_ddt(list(bufs), count, vec, PROD)
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    got = devs.allreduce_ddt([bufs[r].to(d) for r, d in enumerate(devs.mesh.devices)],
                             count, vec, PROD)
    torch.cuda.synchronize()
    hops = 2 * (n - 1)
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == {
        "ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": hops * cards,
        "ring_hop_wait": 2 * hops * cards}
    assert got.devices == devs.mesh.devices
    assert all(torch.equal(_bits(got[r].to(dev)), _bits(want[r])) for r in range(n))
    ck.peer_ring(devs.mesh).check()


#: one process of a 2 × 4 job on the devices layout: each rank writes its
#: shard late on a side stream of its card, then an ``iallreduce`` is
#: issued on those streams; every ``_cuda_read`` of the device plane is
#: recorded with the card it landed on
DEVICES_JOB = r'''
import contextlib
import json

import torch

import ompi_tpu_torch.api as api
from ompi_tpu_torch.dcn import device as plane
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op import SUM

landed = []
_read = plane._cuda_read


def recording_read(*a, **k):
    out = _read(*a, **k)
    landed.append(str(out.device))
    return out


plane._cuda_read = recording_read
w = api.init()
k, lo, n = w.local_size, w.local_offset, w.size
devs = w.local_mesh.devices
sides = {d.index: torch.cuda.Stream(d) for d in devs}
with contextlib.ExitStack() as es:
    for s in sides.values():
        es.enter_context(torch.cuda.stream(s))
    xs = []
    for r, d in enumerate(devs):
        with torch.cuda.device(d):  # _sleep runs on the current card
            x = torch.zeros(1 << 20, device=d)
            torch.cuda._sleep(50_000_000)  # the write lands late on the caller's stream
            x += float(lo + r + 1)
        xs.append(x)
    got = w.iallreduce(RankShards(xs), SUM).wait()
    got = RankShards([s.clone() for s in got.shards])  # ordered on the side streams
for d in devs:
    torch.cuda.synchronize(d)
dp = w.dcn._root_engine()._device_plane
print("DEVJOB " + json.dumps({
    "proc": w.proc, "devices": [str(d) for d in devs], "current": torch.cuda.current_device(),
    "result_devices": [str(s.device) for s in got.shards],
    "ok": all(bool((s == n * (n + 1) / 2).all()) for s in got.shards),
    "landed": sorted(set(landed)), "device_recvs": dp.stats["device_recvs"]}), flush=True)
api.finalize()
'''


def _devices_job(tmp_path):
    """The 2 × 4 devices-layout job above on this machine's cards (plane
    on from 4 KiB, so the 4 MiB DCN leg rides CUDA IPC windows); each
    process's JSON row."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    script = tmp_path / "devjob.py"
    script.write_text(DEVICES_JOB)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--nranks", "4"]
    for k, v in {"accelerator_cuda_layout": "devices", "dcn_device_min_size": "4096"}.items():
        cmd += ["--mca", k, v]
    res = subprocess.run(cmd + [str(script)], capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(repo))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rows = [json.loads(ln.split("DEVJOB ", 1)[1]) for ln in res.stdout.splitlines()
            if "DEVJOB " in ln]
    assert len(rows) == 2, res.stdout[-3000:]
    return sorted(rows, key=lambda r: r["proc"])


def test_han_iallreduce_on_shards_waits_on_every_card(dev, tmp_path):
    """han's ``iallreduce`` over ``RankShards`` issued on a side stream of
    every card right after a delayed write to each shard: the worker
    thread waits on an event of each card's caller stream, and ``wait()``
    orders each card's stream after the result, so every shard holds the
    sum of the written values, on its rank's card."""
    for r in _devices_job(tmp_path):
        assert r["ok"] and r["result_devices"] == r["devices"], r


def test_cuda_window_lands_on_the_receiving_ranks_card(dev, tmp_path):
    """With ranks on cards 0, 0, 1, 1 | 2, 2, 3, 3 (or the two halves of
    two cards) the second process's DCN leg receives on its first rank's
    card, not the current card (``cuda:0``): every CUDA window read lands
    there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one card is every rank's and the current one")
    second = _devices_job(tmp_path)[1]
    assert second["device_recvs"] > 0, second
    assert second["landed"] == [second["devices"][0]] != [f"cuda:{second['current']}"], second


def _port_run(args, mca: dict, timeout: float = 300):
    """``python -m ompi_tpu_torch <args>`` with the MCA options ``mca``
    (built from a dict), from the checkout: the finished process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "ompi_tpu_torch", *args[:1]]
    for k, v in mca.items():
        cmd += ["--mca", k, v]
    res = subprocess.run(cmd + [str(a) for a in args[1:]], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=str(repo))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res


@pytest.fixture(scope="module")
def devices_respawn():
    """A 2 × 4 ``--ft --respawn`` job of ``ft_smoke.py`` on the devices
    layout at 1 MiB per rank (plane on from 4 KiB): its FTJSON rows by
    kind and process."""
    import json
    from pathlib import Path

    if not torch.cuda.is_available() or not ck.kernel_available():
        pytest.skip("needs a Hopper CUDA device")
    worker = Path(__file__).resolve().parent.parent / "ompi_tpu_torch" / "examples" / "ft_smoke.py"
    res = _port_run(["run", "-np", 2, "--nranks", 4, "--ft", "--respawn", worker,
                     "--mode", "respawn", "--bytes", 1 << 20],
                    {"accelerator_cuda_layout": "devices", "dcn_device_min_size": "4096",
                     "metrics_enable": "1"})
    by: dict = {}
    for ln in res.stdout.splitlines():
        if "FTJSON " in ln:
            rec = json.loads(ln.split("FTJSON ", 1)[1])
            by.setdefault(rec.pop("kind"), {})[rec["proc"]] = rec
    assert "respawning (incarnation 1)" in res.stdout, res.stdout[-3000:]
    return by


def _block_cards(proc: int) -> list:
    from ompi_tpu_torch.mesh.mesh import block_devices

    return [f"cuda:{c}" for c in block_devices(list(range(torch.cuda.device_count())), 4,
                                                proc, 2)]


def test_devices_respawn_reborn_shards_lie_on_their_cards(dev, devices_respawn):
    """The survivor's and the reborn process's results after ``replace()``
    are ``RankShards`` on their ranks' cards (the reborn process's ranks
    where its predecessor's were), equal to the results before the
    failure, with one put and two waits per card per hop in each call."""
    by = devices_respawn
    rec = by["recovered"]
    assert [rec[p]["incarnation"] for p in (0, 1)] == [0, 1]
    assert [rec[p]["size"] for p in (0, 1)] == [8, 8]
    want = {0: _block_cards(0), 1: _block_cards(1)}
    digests = {d for kind in ("pre", "post") for r in by[kind].values() for d in r["digests"]}
    assert len(digests) == 1, by
    for p in (0, 1):
        assert rec[p]["rank_devices"] == want[p], rec[p]
        assert by["post"][p]["placement"] == {"devices": want[p], "ok": True}
        cards, calls = len(set(want[p])), len(by["post"][p]["digests"])
        assert by["post"][p]["launches"] == {"ring_hop": 0, "ring_hop_fold": 0,
                                             "ring_hop_peer": calls * 6 * cards,
                                             "ring_hop_wait": calls * 12 * cards}
        assert rec[p]["device"]["device_fallbacks"] == 0 and rec[p]["heal_ms"] is not None


def test_reborn_process_lands_on_cards_2_2_3_3(dev, devices_respawn):
    """Four cards: process 1's ranks were on cards 2, 2, 3, 3, and so are
    its reborn incarnation's and their results, though its current card is
    ``cuda:0``."""
    if torch.cuda.device_count() != 4:
        pytest.skip("needs four cards")
    rec = devices_respawn["recovered"][1]
    assert rec["incarnation"] == 1
    assert rec["rank_devices"] == ["cuda:2", "cuda:2", "cuda:3", "cuda:3"]
    assert devices_respawn["post"][1]["placement"]["devices"] == rec["rank_devices"]


def test_devices_tpud_record_lists_every_card(dev, tmp_path):
    """A tpud of 2 × 4 ranks on the devices layout: a sweep job's results
    lie on their ranks' cards, and each process's completion record lists
    its ranks' devices and the allocator's bytes on each of its cards."""
    import json
    import os
    import re
    import subprocess
    import sys
    import threading
    import time
    from pathlib import Path

    from ompi_tpu_torch.serve import client

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "tpud", "-np", "2", "--nranks", "4"]
    for k, v in {"accelerator_cuda_layout": "devices", "dcn_device_min_size": "4096"}.items():
        cmd += ["--mca", k, v]
    d = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=str(repo), start_new_session=True)
    lines: list = []
    t = threading.Thread(target=lambda: lines.extend(iter(d.stdout.readline, "")), daemon=True)
    t.start()
    try:
        url = None
        for _ in range(1200):
            m = next((re.search(r"\[tpud\] ops: (\S+)/jobs", ln) for ln in list(lines)
                      if "[tpud] ops: " in ln), None)
            if m:
                url = m.group(1)
                break
            time.sleep(0.1)
        assert url, "".join(lines)[-3000:]
        job = repo / "ompi_tpu_torch" / "examples" / "serve_job.py"
        j = client.submit(url, str(job), args=["--sizes", str(1 << 20)], tenant="ops")
        rec = client.wait(url, j["id"], timeout=300)
        assert rec["state"] == "done", (rec, "".join(lines)[-3000:])
        client.shutdown(url)
        assert d.wait(timeout=120) == 0
    finally:
        if d.poll() is None:
            os.killpg(d.pid, 9)
            d.wait()
        t.join(timeout=10)
    for p in ("0", "1"):
        want = _block_cards(int(p))
        r = rec["ranks"][p]
        assert r["rank_devices"] == want and r["device"] == want[0], r
        assert [c["device"] for c in r["cards"]] == list(dict.fromkeys(want)), r
        assert all(c["cuda_allocated"] >= 0 for c in r["cards"])
        assert (r["cuda_allocated"], r["cuda_reserved"]) == (
            r["cards"][0]["cuda_allocated"], r["cards"][0]["cuda_reserved"])
    sizes = [json.loads(ln.split(" SJSON ", 1)[1]) for ln in lines if " SJSON " in ln]
    sizes = [r for r in sizes if r["kind"] == "size"]
    assert len(sizes) == 2, sizes
    assert all(r["placement"]["ok"] and r["bitwise_vs_plain"] for r in sizes), sizes
