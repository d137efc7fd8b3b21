"""Point-to-point, windows, the typed entry points and checkpoints on the devices layout.

The reference runs a communicator one rank per device: a send puts its
payload on the receiver's device, a window's ``device_view`` and a
checkpoint's ``restore`` return a value sharded one row per device.
The port's ``CommMesh("cpu", n, layout="devices")`` gives every rank a
buffer of its own (``RankShards``, or a tensor on rank r's device).  The
same seeded numpy inputs go through:

* the reference's ``Comm`` on the conftest's 8 virtual XLA devices (a
  sub-comm of 3, 6 or 8 ranks);
* the port's ``Comm`` on a devices-layout mesh of the same size, with
  numpy buffers and with tensors on each rank's own device;
* the port's ``Comm`` on the rows layout.

Covered: send/recv, isend/irecv, wildcards and the non-overtaking order,
probe/iprobe, sendrecv, persistent and partitioned channels; every
window flavour under fence, PSCW and lock epochs with put, get,
accumulate, get_accumulate, fetch_and_op and compare_and_swap (final
memory, fetched values and the errors of misuses) and ``device_view``;
``allreduce_ddt``/``bcast_ddt`` over a vector and a struct datatype;
checkpoint ``save``/``save_async``/``restore`` of ``RankShards``; an
intercomm's send/recv; MPI-IO writes from shards.

Tolerance: bit for bit on byte views.  The one exception is a typed
allreduce under ``auto`` with SUM, which the reference leaves to XLA
(``psum``) and the port runs as the ring over the cross-device hop: it
is held with ``allclose`` at the rtol of ``tests/test_torch_shard_colls.py``
(1e-5 for float32, 1e-12 for float64; atol the same times n times the
largest input magnitude).  Placement (each payload, region and restored
shard on its rank's card) is asserted here too, though every rank's
device is the CPU; the card tests in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``cross_device`` phase hold it across cards.
"""

import contextlib

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_coll import rank_data
from test_torch_io import io_program
from test_torch_osc import S, _rma_op

import ompi_tpu.api as japi
import ompi_tpu.ddt as jddt
import ompi_tpu.io as jio
import ompi_tpu.osc as josc
import ompi_tpu_torch.api as tapi
import ompi_tpu_torch.ddt as tddt
import ompi_tpu_torch.io as tio
from ompi_tpu import op as jop
from ompi_tpu.api.intercomm import create_intercomm as jintercomm
from ompi_tpu.core import mca as jmca
from ompi_tpu.io import checkpoint as jckpt
from ompi_tpu_torch import op as top
from ompi_tpu_torch.api import Comm, Group
from ompi_tpu_torch.api.intercomm import create_intercomm as tintercomm
from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch.io import checkpoint as tckpt
from ompi_tpu_torch.mesh.mesh import CommMesh
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.p2p import pml as tpml

N = 8
SIZES = (3, 6, N)
RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}


@pytest.fixture(scope="module")
def comms(devices):
    """size → (the reference's comm, the port's devices comm, its rows comm)."""
    tapi.finalize()
    tapi.init(device="cpu", nranks=N)  # registers the port's MCA vars
    jw = japi.init()
    tdev = Comm(Group(range(N)), CommMesh("cpu", N, layout="devices"), name="devices")
    trows = Comm(Group(range(N)), CommMesh("cpu", N), name="rows")
    out = {}
    for n in SIZES:
        colors = [0] * n + [1] * (N - n)
        pick = (lambda c: c) if n == N else (lambda c: c.split(colors)[0])
        out[n] = (pick(jw), pick(tdev), pick(trows))
        assert out[n][1].mesh.layout == "devices" and out[n][1].size == n
    yield out
    tapi.finalize()


def on_rank(a, comm, r: int) -> torch.Tensor:
    """A numpy array as a tensor on rank r's device."""
    return from_numpy(np.ascontiguousarray(a)).to(comm.mesh.devices[r])


def shards_on(x: np.ndarray, comm) -> RankShards:
    return RankShards([on_rank(x[r], comm, r) for r in range(comm.size)])


def host(v) -> np.ndarray:
    if isinstance(v, RankShards):
        return v.to_host()
    if isinstance(v, torch.Tensor):
        return to_numpy(v)
    return np.asarray(v)


def placed(tensors, comm) -> bool:
    """Tensor r lies on rank r's device."""
    return all(t.device == comm.mesh.devices[r] for r, t in enumerate(tensors))


# -- checkpoints (the repair: restore of shards) ------------------------------

CKPT_DTYPES = [np.float32, np.int64, ml_dtypes.bfloat16, np.uint16]


@pytest.mark.parametrize("dtype", CKPT_DTYPES, ids=[np.dtype(d).name for d in CKPT_DTYPES])
@pytest.mark.parametrize("n", SIZES)
def test_checkpoint_of_shards_matches_reference(comms, tmp_path, n, dtype):
    """``save`` and ``save_async`` of ``RankShards`` write the reference's
    bytes and manifest; ``restore`` on a devices comm returns
    ``RankShards``, shard r on rank r's device, as the reference returns
    its value sharded one row per device."""
    jc, tc, rc = comms[n]
    arr = rank_data(n, (3, 5), dtype, seed=n)
    jpath, tpath, apath = (str(tmp_path / p) for p in ("j.ckpt", "t.ckpt", "a.ckpt"))
    jckpt.save(jc, jpath, arr, {"step": n})
    shards = shards_on(arr, tc)
    tckpt.save(tc, tpath, shards, {"step": n})
    req = tckpt.save_async(tc, apath, shards, {"step": n})
    for s in shards.shards:
        s.zero_()  # the caller may overwrite at once
    req.wait()
    for p in (tpath, apath):
        assert open(p, "rb").read() == open(jpath, "rb").read()
        assert open(p + ".json", "rb").read() == open(jpath + ".json", "rb").read()
    got, manifest = tckpt.restore(tc, jpath)
    want, _ = jckpt.restore(jc, tpath)
    assert isinstance(got, RankShards) and got.shape == arr.shape and manifest["step"] == n
    assert placed(got.shards, tc)
    assert got.to_host().tobytes() == np.asarray(want).tobytes() == arr.tobytes()
    flat, _ = tckpt.restore(tc, tpath, stage=False)
    assert isinstance(flat, np.ndarray) and flat.tobytes() == arr.tobytes()
    rows, _ = tckpt.restore(rc, apath)  # the rows layout restores the same file
    assert isinstance(rows, torch.Tensor) and to_numpy(rows).tobytes() == arr.tobytes()


# -- point-to-point -----------------------------------------------------------


def p2p_round(comm, x: np.ndarray, tensors: bool) -> list:
    """On a fresh dup of ``comm``: a ring of sendrecvs, wildcard receives
    in the non-overtaking order, probe/iprobe, isend/irecv and PROC_NULL.
    Tensor payloads start on the sender's device.  Returns what was
    seen, payloads as (dtype, shape, bytes); asserts every tensor payload
    arrived on its receiver's device."""
    c = comm.dup()
    n = c.size

    def pay(a, source):
        return on_rank(a, c, source) if tensors else a

    def seen(dest, got):
        payload, st = got
        if isinstance(payload, torch.Tensor):
            assert payload.device == c.mesh.devices[dest]
        p = None if payload is None else host(payload)
        return (st.source, st.tag, st.count, st.nbytes,
                None if p is None else (str(p.dtype), p.shape, p.tobytes()))

    out = []
    # the ring: the last rank's send goes first, so each sendrecv finds
    # its left neighbour's message (one controller drives every rank)
    c.send(pay(x[n - 1], n - 1), n - 1, 0, tag=7)
    for r in range(n - 1):
        out.append(seen(r, c.sendrecv(pay(x[r], r), r, r + 1, (r - 1) % n, 7, 7)))
    out.append(seen(n - 1, c.recv(n - 1, n - 2, 7)))
    # wildcards and the non-overtaking order at the last rank
    dst, a, b = n - 1, 0, 1
    for i in range(4):
        src = (a, b)[i % 2]
        c.send(pay(np.full(2, i, np.int32), src), src, dst, tag=i % 2)
    for args in ((None, 1), (b, None), (None, None), (None, None)):
        out.append(seen(dst, c.recv(dst, *args)))
    # probe and iprobe leave the message queued
    c.send(pay(x[0], 0), 0, dst, tag=9)
    st = c.probe(dst, None, None)
    ist = c.iprobe(dst, 0, 9)
    out.append((st.source, st.tag, st.count, st.nbytes, ist.source, ist.nbytes))
    out.append(seen(dst, c.recv(dst)))
    out.append(c.iprobe(dst))  # nothing left: None
    # isend/irecv, the receive posted first
    req = c.irecv(1, 0, 5)
    c.isend(pay(x[2], 0), 0, 1, 5).wait()
    out.append(seen(1, (req.wait(), req.status)))
    out.append(seen(0, c.recv(0, tpml.PROC_NULL)))
    c.free()
    return out


@pytest.mark.parametrize("n", SIZES)
def test_point_to_point_matches_reference(comms, n):
    jc, tc, rc = comms[n]
    x = rank_data(n, (5,), np.float32, seed=10 + n)
    want = p2p_round(jc, x, False)
    assert p2p_round(tc, x, False) == want
    assert p2p_round(tc, x, True) == want
    assert p2p_round(rc, x, False) == want


def test_send_names_the_receivers_device(comms, monkeypatch):
    """A tensor payload is copied onto ``mesh.devices[dest]``, as the
    reference's ``send`` puts a device array onto the receiver's device
    (numpy payloads and the rows layout pass no device)."""
    import jax

    jc, tc, rc = comms[N]
    moved = jc.dup()
    moved.send(jax.device_put(np.ones(3, np.float32), jc.mesh.devices[2]), 2, 5)
    got, _ = moved.recv(5, 2)
    assert got.devices() == {jc.mesh.devices[5]}
    calls = []
    real = tpml._copy_payload
    monkeypatch.setattr(tpml, "_copy_payload",
                        lambda buf, dest_device=None: calls.append(dest_device)
                        or real(buf, dest_device))
    for comm, buf in ((tc, on_rank(np.ones(3), tc, 2)), (tc, np.ones(3)),
                      (rc, torch.ones(3))):
        c = comm.dup()
        c.send(buf, 2, 5)
        c.recv(5, 2)
    assert calls == [tc.mesh.devices[5], None, None]


def channels(comm, tensors: bool) -> list:
    """Persistent and partitioned channels from rank 0 to the last rank;
    the buffers are refilled between starts."""
    c = comm.dup()
    dst = c.size - 1

    def buffer(a):
        return on_rank(a, c, 0) if tensors else a

    out = []
    buf = buffer(np.array([1.0, 2.0]))
    ps, pr = c.send_init(buf, 0, dst, tag=5), c.recv_init(dst, 0, 5)
    for fill in ([1.0, 2.0], [7.0, 8.0]):
        buf[:] = buffer(np.array(fill))
        ps.start().wait()
        got = pr.start().wait()
        out.append((host(got).tobytes(), pr.status.source, pr.status.tag))
    buf = buffer(np.arange(24.0).reshape(8, 3))
    ps = c.psend_init(buf, partitions=4, source=0, dest=dst, tag=11)
    pr = c.precv_init(partitions=4, dest=dst, source=0, tag=11)
    for scale in (1.0, 10.0):
        buf *= scale
        pr.start()
        ps.start()
        for p in (2, 0, 3):
            ps.pready(p)
            out.append((ps.test(), pr.parrived(p)))
        ps.pready(1)  # the last partition: the transfer
        got = pr.wait()
        if isinstance(got, torch.Tensor):
            assert got.device == c.mesh.devices[dst]
        out.append((ps.test(), pr.parrived(1), pr.status.source, pr.status.tag,
                    host(got).tobytes()))
    c.free()
    return out


@pytest.mark.parametrize("n", SIZES)
def test_persistent_and_partitioned_channels_match_reference(comms, n):
    jc, tc, rc = comms[n]
    want = channels(jc, False)
    assert channels(tc, False) == want
    assert channels(tc, True) == want
    assert channels(rc, False) == want


def test_intercomm_send_recv_matches_reference(comms):
    """An intercomm over devices-layout sub-comms: its channel and its
    merge keep the layout, each rank on its own device, and its p2p in
    both directions matches the reference's."""
    jw, tdev, trows = comms[N]
    x = rank_data(N, (6,), np.float32, seed=21)
    outs = []
    for world, tensors in ((jw, False), (tdev, False), (tdev, True), (trows, False)):
        ic = (jintercomm if world is jw else tintercomm)(world, [0, 1, 2], [3, 4, 5, 6, 7])
        if world is tdev:
            assert ic._chan.mesh.layout == ic.merge().mesh.layout == "devices"
            assert ic.merge(True).mesh.devices == tuple(tdev.mesh.devices[r]
                                                        for r in (3, 4, 5, 6, 7, 0, 1, 2))

        def pay(r):  # world rank r's row on its device
            return on_rank(x[r], world, r) if tensors else x[r]

        ic.send(pay(0), 0, 2, tag=4)
        ic.send(pay(4), 1, 0, tag=5, from_remote=True)
        ic.send(pay(1), 1, 2, tag=6)
        got = [ic.recv(2, None, None, at_remote=True), ic.recv(0, 1, 5),
               ic.recv(2, 1, None, at_remote=True)]
        if tensors:
            assert [p.device for p, _ in got] == [tdev.mesh.devices[r] for r in (5, 0, 5)]
        outs.append([(host(p).tobytes(), st.source, st.tag) for p, st in got])
    assert outs[0] == outs[1] == outs[2] == outs[3]


# -- windows ------------------------------------------------------------------

FLAVOURS = ("allocate", "allocate_shared", "create", "create_tensors", "dynamic")
WIN_DTYPES = [np.float32, ml_dtypes.bfloat16, np.int32, np.uint32]
#: where a dynamic window's attachments start
ATTACH_AT = 100
#: the disp's place in each RMA step of ``tests/test_torch_osc.py``
DISP_AT = {"put": 4, "get": 4, "accumulate": 4, "get_accumulate": 4, "fetch_and_op": 4,
           "compare_and_swap": 5}


def win_program(seed: int, dtype, n: int) -> list:
    """A seeded RMA program over ``n`` ranks: a fence epoch, a PSCW epoch
    (origins 0 and 1 into the last rank, one op before its post), an
    exclusive lock with flushes and a lock_all with a flush_all."""
    rng = np.random.RandomState(seed)

    def rank():
        return int(rng.randint(n))

    steps = [("fence",)]
    steps += [_rma_op(rng, dtype, rank(), rank()) for _ in range(10)]
    steps += [("fence",), ("fence", josc.MODE_NOSUCCEED)]
    t = n - 1
    steps += [("start", 0, [t]), _rma_op(rng, dtype, 0, t),  # before post: an error
              ("post", t, [0, 1]), ("start", 1, [t])]
    steps += [_rma_op(rng, dtype, int(rng.randint(2)), t) for _ in range(6)]
    steps += [("wait", t), ("complete", 0), ("complete", 1), ("wait", t)]
    steps += [("lock", 1, 0, josc.LOCK_EXCLUSIVE), ("lock", 2, 0, josc.LOCK_SHARED)]
    for _ in range(5):
        steps.append(_rma_op(rng, dtype, 1, 0))
        if rng.rand() < 0.4:
            steps.append(("flush", 1, 0))
    steps += [("unlock", 1, 0), ("lock_all", 2)]
    steps += [_rma_op(rng, dtype, 2, rank()) for _ in range(6)]
    steps += [("flush_all", 2), _rma_op(rng, dtype, 2, rank()), ("unlock_all", 2)]
    return steps


def make_window(comm, flavour: str, dtype, port: bool):
    """(window, the per-rank memory to read back at the end)."""
    n = comm.size
    if flavour in ("allocate", "allocate_shared"):
        win = getattr(comm, "win_" + flavour)(S, dtype)
        return win, [win.memory(r) for r in range(n)]
    mems = [np.zeros(S, dtype) for _ in range(n)]
    if flavour in ("create_tensors", "dynamic") and port:  # tensors on their ranks' devices
        mems = [on_rank(m, comm, r) for r, m in enumerate(mems)]
    if flavour != "dynamic":
        return comm.win_create(mems), mems
    win = comm.win_create_dynamic(dtype)
    for r, m in enumerate(mems):
        win.attach(r, ATTACH_AT, m)
    return win, mems


def run_window(comm, flavour: str, steps: list, dtype, port: bool):
    """Run the program; (memory bytes per rank, fetched values and
    errors in issue order, the call log, the device_view's bytes)."""
    op_mod = top if port else jop
    win, mems = make_window(comm, flavour, dtype, port)
    if port and comm.mesh.layout == "devices" and flavour != "create":
        assert placed(mems, comm)  # every region on its rank's device
    log, reqs = [], []
    for step in steps:
        name, args = step[0], list(step[1:])
        if flavour == "dynamic" and name in DISP_AT:
            args[DISP_AT[name] - 1] += ATTACH_AT
        if name in ("accumulate", "get_accumulate", "fetch_and_op"):
            args[-1] = op_mod.PREDEFINED_OPS[args[-1]]
        if name == "compare_and_swap" and args[3] is None:
            args[3] = args[2]  # compare with the value itself
        try:
            out = getattr(win, name)(*args)
        except Exception as e:  # noqa: BLE001 — the class is the result
            log.append((len(log), name, type(e).__name__))
            continue
        if out is not None and not isinstance(out, bool):
            reqs.append((args[0], out))
        else:
            log.append((len(log), name, out))
    values = []
    for origin, r in reqs:
        try:
            v = r.wait()
        except Exception as e:  # noqa: BLE001
            values.append(type(e).__name__)
            continue
        if isinstance(v, torch.Tensor) and comm.mesh.layout == "devices":
            assert v.device == comm.mesh.devices[origin]  # fetched to the origin
        values.append(None if v is None else host(v).tobytes())
    view = win.device_view()
    if port and comm.mesh.layout == "devices":
        assert isinstance(view, RankShards) and placed(view.shards, comm)
        if flavour in ("allocate", "allocate_shared"):  # the regions themselves
            assert all(v.data_ptr() == m.data_ptr() for v, m in zip(view.shards, mems))
    win.fence()
    win.free()
    return [host(m).tobytes() for m in mems], values, log, host(view).tobytes()


@pytest.mark.parametrize("dtype", WIN_DTYPES, ids=[np.dtype(d).name for d in WIN_DTYPES])
@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("n", SIZES)
def test_window_program_matches_reference(comms, n, flavour, dtype):
    jc, tc, rc = comms[n]
    steps = win_program(n * 7 + FLAVOURS.index(flavour), dtype, n)
    want = run_window(jc, flavour, steps, dtype, False)
    got = run_window(tc, flavour, steps, dtype, True)
    assert got[2] == want[2]  # the same calls raised the same classes
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[3] == want[3]
    assert run_window(rc, flavour, steps, dtype, True) == want
    assert {e[2] for e in want[2]} >= {"MPIRMASyncError"}


def test_shared_query_hands_back_the_peers_region(comms):
    jc, tc, _ = comms[6]
    outs = []
    for w in (jc, tc):
        win = w.win_allocate_shared(5, np.int32)
        size, view = win.shared_query(4)
        view[:] = 7  # a direct store into rank 4's region
        win.fence()
        win.put(1, 2, np.arange(5, dtype=np.int32))
        win.fence()
        outs.append((size, host(win.device_view()).tobytes()))
        if w is tc:
            assert view is win.memory(4) and view.device == tc.mesh.devices[4]
        win.free()
    assert outs[0] == outs[1]


def test_tensors_on_another_device_are_refused(comms):
    """A window base, an attachment or a typed buffer on another device
    than its rank's raises ``MPIArgError``: nothing is moved implicitly
    (here the meta device stands for another card)."""
    _, tc, rc = comms[N]
    meta = [torch.empty(4, device="meta") for _ in range(N)]
    with pytest.raises(MPIArgError, match="nothing is moved"):
        tc.win_create(meta)
    win = tc.win_create_dynamic(torch.float32)
    with pytest.raises(MPIArgError, match="nothing is moved"):
        win.attach(3, 0, meta[3])
    with pytest.raises(MPIArgError, match="nothing is moved"):
        tc.allreduce_ddt([torch.ones(4)] * (N - 1) + [meta[0]], 4, tddt.FLOAT)
    with pytest.raises(MPIArgError, match="nothing is moved"):
        tc.bcast_ddt(meta[0], 4, tddt.FLOAT, root=2)
    assert rc.win_create(meta).memory(1) is meta[1]  # the rows layout aliases anything


# -- the typed entry points -----------------------------------------------------

#: (id, builder over a datatype module, numpy leaf dtype, count)
TYPED = [("vector", lambda m: m.FLOAT.create_vector(6, 3, 5), np.float32, 4),
         ("struct", lambda m: m.create_struct([2, 1], [0, 24], [m.DOUBLE, m.DOUBLE]),
          np.float64, 3)]
#: (algorithm pinned in both packages, op)
TYPED_ALGOS = [("auto", "MPI_SUM"), ("auto", "MPI_MAX"), ("ring", "MPI_PROD"),
               ("cuda_ring", "MPI_SUM")]


@contextlib.contextmanager
def allreduce_pinned(algo: str):
    stores = {"xla": jmca.default_context().store, "cuda": tmca.default_context().store}
    prev = {k: s.get(f"coll_{k}_allreduce_algorithm") for k, s in stores.items()}
    for k, s in stores.items():
        s.set(f"coll_{k}_allreduce_algorithm", ALLREDUCE_ALGOS[algo])
    try:
        yield
    finally:
        for k, s in stores.items():
            s.set(f"coll_{k}_allreduce_algorithm", prev[k])


@pytest.mark.parametrize("algo,opname", TYPED_ALGOS, ids=[f"{a}-{o}" for a, o in TYPED_ALGOS])
@pytest.mark.parametrize("name,build,dtype,count", TYPED, ids=[t[0] for t in TYPED])
@pytest.mark.parametrize("n", SIZES)
def test_allreduce_ddt_matches_reference(comms, n, name, build, dtype, count, algo, opname):
    jc, tc, rc = comms[n]
    j, t = build(jddt), build(tddt)
    nelem = (j.lb + j.span(count)) // np.dtype(dtype).itemsize + 2
    rng = np.random.RandomState(n + count)
    bufs = [(1 + 0.25 * rng.randn(nelem)).astype(dtype) for _ in range(n)]
    tbufs = [on_rank(b, tc, r) for r, b in enumerate(bufs)]
    jo, to = jop.PREDEFINED_OPS[opname], top.PREDEFINED_OPS[opname]
    with allreduce_pinned(algo):
        want = np.asarray(jc.allreduce_ddt(bufs, count, j, jo))
        got = tc.allreduce_ddt(bufs, count, t, to)
        got_t = tc.allreduce_ddt(tbufs, count, t, to)
        flat = rc.allreduce_ddt(bufs, count, t, to)
        jrecv = [np.zeros_like(b) for b in bufs]
        trecv = [torch.zeros_like(b) for b in tbufs]
        jc.allreduce_ddt(bufs, count, j, jo, recvbufs=jrecv)
        tc.allreduce_ddt(tbufs, count, t, to, recvbufs=trecv)
    assert isinstance(got, np.ndarray) and isinstance(got_t, RankShards)
    assert placed(got_t.shards, tc) and placed(trecv, tc)
    if algo == "auto" and opname == "MPI_SUM":
        rtol = RTOL[np.dtype(dtype)]
        atol = rtol * n * max(np.abs(b).max() for b in bufs)
        for v in (got, got_t.to_host(), flat):
            np.testing.assert_allclose(v, want, rtol=rtol, atol=atol)
        for a, b in zip(trecv, jrecv):
            np.testing.assert_allclose(to_numpy(a), b, rtol=rtol, atol=atol)
        return
    assert got.tobytes() == got_t.to_host().tobytes() == flat.tobytes() == want.tobytes()
    assert [to_numpy(a).tobytes() for a in trecv] == [b.tobytes() for b in jrecv]


#: (id, builder, count): a vector and a struct of mixed leaves
BCAST_TYPES = [("vector", lambda m: m.INT.create_vector(3, 2, 4), 2),
               ("struct", lambda m: m.create_struct([1, 2, 1], [0, 8, 24],
                                                    [m.DOUBLE, m.INT, m.SHORT]), 3)]


@pytest.mark.parametrize("name,build,count", BCAST_TYPES, ids=[t[0] for t in BCAST_TYPES])
@pytest.mark.parametrize("n", SIZES)
def test_bcast_ddt_matches_reference(comms, n, name, build, count):
    jc, tc, rc = comms[n]
    j, t = build(jddt), build(tddt)
    for root in (1, n - 1):
        buf = np.random.RandomState(root + n).randint(0, 256, j.lb + j.span(count) + 5)
        buf = buf.astype(np.uint8)
        want = [b.tobytes() for b in jc.bcast_ddt(buf, count, j, root=root)]
        got = tc.bcast_ddt(buf, count, t, root=root)
        got_t = tc.bcast_ddt(on_rank(buf, tc, root), count, t, root=root)
        flat = rc.bcast_ddt(torch.from_numpy(buf), count, t, root=root)
        assert all(isinstance(b, np.ndarray) for b in got) and placed(got_t, tc)
        for outs in (got, got_t, flat):
            assert [host(b).tobytes() for b in outs] == want


# -- MPI-IO from shards -----------------------------------------------------------


def test_file_writes_from_shards_match_reference(comms, tmp_path):
    """Every access mode of ``tests/test_torch_io.py``'s program with
    tensor data on the devices layout, and a collective write of a
    ``RankShards``' shards: the same file bytes and reads as the
    reference's."""
    jw, tdev, _ = comms[N]
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    want = io_program(jw, jddt, jio, jpath)
    assert io_program(tdev, tddt, tio, tpath, tensors=True) == want
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for n in SIZES:
        jc, tc, _ = comms[n]
        x = rank_data(n, (7,), np.float64, seed=n)
        files = []
        for comm, blocks, path in ((jc, list(x), jpath), (tc, shards_on(x, tc).shards, tpath)):
            f = comm.file_open(path, jio.MODE_CREATE | jio.MODE_RDWR)
            f.set_size(0)
            f.write_at_all([56 * r for r in range(n)], blocks)
            f.close()
            files.append(open(path, "rb").read())
        assert files[0] == files[1] == x.tobytes()
