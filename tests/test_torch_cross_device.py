"""The devices layout and the cross-device ring hop against the JAX package.

The reference runs a communicator one rank per device
(``ompi_tpu.mesh.CommMesh``) and its three ``pallas_ring`` schedules
(``ompi_tpu.coll.pallas_kernels``) hop each device's chunk into its
right neighbour.  The port's ``devices`` layout gives every rank a
buffer of its own (``RankShards``); here every buffer is on the CPU,
where ``ring_hop_peer`` runs its plain twin.  The same seeded numpy
inputs go through:

* the reference's rings under ``shard_map`` on the conftest's 8 virtual
  CPU devices, in its ``emulate`` and ``interpret`` modes;
* the port's shard schedules in both their forms (``plain``: fresh
  landing buffers; ``cuda``: the ring's double-buffered landing zones
  through the wrapper, which on CPU buffers copies with the plain twin),
  and the rows layout's ``cuda_ring``;
* ``Comm`` with ``cuda_ring`` pinned on a devices-layout mesh, against the
  reference's ``Comm`` with ``pallas_ring`` pinned (every other algorithm
  of every collective: ``tests/test_torch_shard_colls.py``).

Tolerance: none — bit for bit on byte views (``psum`` and ``direct``,
whose order XLA chooses: ``allclose`` at rtol 1e-5).  The kernels themselves
run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
``cross_device`` phase).
"""

import contextlib

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_coll import RINGS, _jax_op, _torch_op, rank_data, same_bits, spmd

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu.coll import pallas_kernels as pk
from ompi_tpu.core import mca as jmca
from ompi_tpu.mesh import AXIS
from ompi_tpu.mesh import mesh as jmesh
from ompi_tpu_torch import op as top
from ompi_tpu_torch.api import Comm, Group
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.coll.cuda import (
    ALLGATHER_ALGOS,
    ALLREDUCE_ALGOS,
    REDUCE_SCATTER_ALGOS,
)
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError, MPIInternalError
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch.mesh.mesh import CommMesh, block_devices, order_device_ids
from ompi_tpu_torch.mesh.shards import RankShards

N = 8
FORMS = ("plain", "cuda")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes(devices):
    from jax.sharding import Mesh

    return {n: Mesh(np.array(devices[:n]), (AXIS,)) for n in (3, 6, N)}


def shards_of(x: np.ndarray) -> RankShards:
    return RankShards([from_numpy(x[r]) for r in range(x.shape[0])])


def host(outs) -> np.ndarray:
    return np.stack([to_numpy(o) for o in outs])


def port_shards(coll, x, op, form):
    """The port's shard schedule over CPU shards in ``form``."""
    xs = shards_of(x)
    ring = ck.PeerRing(xs.devices) if form == "cuda" else None
    if coll == "allreduce":
        return host(ck.ring_allreduce_shards(xs, op, ring, _mode=form))
    if coll == "allgather":
        return host(ck.ring_allgather_shards(xs, ring, _mode=form))
    return host(ck.ring_reduce_scatter_shards(xs, op, ring, _mode=form))


def reference_ring(mesh, coll, x, jo, n, jax_mode):
    if coll == "allreduce":
        return spmd(mesh, lambda v: pk.ring_allreduce(v, jo, n, _mode=jax_mode), x)
    if coll == "allgather":
        return spmd(mesh, lambda v: pk.ring_allgather(v, n, _mode=jax_mode), x)
    return spmd(mesh, lambda v: pk.ring_reduce_scatter(v, jo, n, _mode=jax_mode), x)


def rows_ring(coll, x, to):
    t = from_numpy(x)
    if coll == "allreduce":
        return to_numpy(ck.ring_allreduce(t, to, _mode="cuda"))
    if coll == "allgather":
        return to_numpy(ck.ring_allgather(t, _mode="cuda"))
    return to_numpy(ck.ring_reduce_scatter(t, to, _mode="cuda"))


def ring_input(coll, n, dtype, seed):
    shape = {"allreduce": (41,), "allgather": (3, 5), "reduce_scatter": (n, 3, 7)}[coll]
    return rank_data(n, shape, dtype, seed=seed)


@pytest.mark.parametrize("jax_mode", ["emulate", "interpret"])
@pytest.mark.parametrize(
    "coll,opname,dtype,n", RINGS,
    ids=[f"{c}-{o}-{np.dtype(d).name}-n{n}" for c, o, d, n in RINGS])
def test_shard_rings_bitwise(meshes, coll, opname, dtype, n, jax_mode):
    """The reference's ring in ``jax_mode`` == the port's shard ring in
    both forms == the rows layout's kernel-form ring."""
    x = ring_input(coll, n, dtype, seed=n)
    jo = _jax_op(opname) if opname else None
    to = _torch_op(opname) if opname else None
    want = reference_ring(meshes[n], coll, x, jo, n, jax_mode)
    for form in FORMS:
        same_bits(port_shards(coll, x, to, form), want)
    same_bits(rows_ring(coll, x, to), want)


@pytest.mark.parametrize("n", [3, 6, N])
@pytest.mark.parametrize("coll", ["allreduce", "allgather", "reduce_scatter"])
def test_shard_rings_every_comm_size(meshes, coll, n):
    """f32 SUM (the chip's main case) at each comm size, with a chunk that
    does not split evenly: the padded path."""
    x = ring_input(coll, n, np.float32, seed=100 + n)
    want = reference_ring(meshes[n], coll, x, _jax_op("MPI_SUM"), n, "emulate")
    for form in FORMS:
        same_bits(port_shards(coll, x, top.SUM, form), want)


# -- the wrapper and its plain twin -------------------------------------------


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("length", [1, 7, 1003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int32,
                                   torch.uint64, torch.uint8, torch.complex64])
def test_ring_hop_peer_moves_each_chunk_right(dtype, length, offset):
    """``dsts[(r+1)%n]`` at its offset holds ``srcs[r]`` at its offset,
    byte for byte; every other byte of the destinations is untouched."""
    n = 3
    rng = np.random.RandomState(length + offset)
    raw = [torch.from_numpy(rng.randint(0, 256, (length + 2) * dtype.itemsize)
                            .astype(np.uint8)).view(dtype) for _ in range(2 * n)]
    srcs, dsts = raw[:n], raw[n:]
    before = [d.clone() for d in dsts]
    src_off = [offset, 0, offset]
    dst_off = [0, offset, 1]
    launches = dict(ck.LAUNCHES)
    ck.ring_hop_peer(srcs, src_off, dsts, dst_off, length)
    assert ck.LAUNCHES == launches  # CPU buffers launch nothing
    for r in range(n):
        to = (r + 1) % n
        want = before[to].clone().view(torch.uint8)
        es = dtype.itemsize
        want[dst_off[to] * es:(dst_off[to] + length) * es] = \
            srcs[r].view(torch.uint8)[src_off[r] * es:(src_off[r] + length) * es]
        assert torch.equal(dsts[to].view(torch.uint8), want)


def test_ring_hop_peer_checks_its_arguments():
    a = [torch.zeros(4) for _ in range(3)]
    with pytest.raises(MPIArgError, match="outside"):
        ck.ring_hop_peer(a, [0, 0, 1], a, [0, 0, 0], 4)
    with pytest.raises(MPIArgError, match="one source"):
        ck.ring_hop_peer(a, [0, 0], a, [0, 0, 0], 2)
    with pytest.raises(MPIArgError, match="contiguous"):
        ck.ring_hop_peer(a, [0] * 3, a[:2] + [torch.zeros(4, dtype=torch.int32)], [0] * 3, 2)


def test_mixing_cpu_and_cuda_shards_raises():
    """A mesh, a sharded value or a hop over buffers of two device kinds
    is refused before anything runs (the meta device stands in for a
    second kind on a machine without CUDA)."""
    with pytest.raises(MPIArgError, match="mixes device kinds"):
        CommMesh(layout="devices", devices=[torch.device("cpu"), torch.device("cuda", 0)])
    with pytest.raises(MPIArgError, match="mix device kinds"):
        RankShards([torch.zeros(2), torch.zeros(2, device="meta")])
    with pytest.raises(MPIArgError, match="mix device kinds"):
        ck.ring_hop_peer([torch.zeros(2), torch.zeros(2, device="meta")], [0, 0],
                         [torch.zeros(2), torch.zeros(2)], [0, 0], 2)
    with pytest.raises(MPIArgError, match="all CPU or all CUDA"):
        ck.PeerRing([torch.device("cpu"), torch.device("meta")])


def test_peer_wrapper_launches_or_raises_off_the_cpu():
    """Buffers that are not on the CPU never take the plain twin: the
    launch needs CUDA and an sm_90 card, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the wrapper launches there")
    meta = [torch.empty(8, device="meta") for _ in range(4)]
    before = dict(ck.LAUNCHES)
    with pytest.raises(ck.KernelUnavailable):
        ck.ring_hop_peer(meta, [0] * 4, meta, [0] * 4, 8, ring=None)
    with pytest.raises(ck.KernelUnavailable):
        ck._launch_peer(None, [torch.zeros(8)] * 4, [0] * 4, [torch.zeros(8)] * 4, [0] * 4, 8)
    assert ck.LAUNCHES == before


def test_landing_zones_alternate_and_grow():
    ring = ck.PeerRing([CPU] * 3)
    z0 = ring.landing(16)
    ck.ring_hop_peer([torch.zeros(4)] * 3, [0] * 3, [z.view(torch.float32) for z in z0],
                     [0] * 3, 4, ring)
    z1 = ring.landing(16)
    assert ring.hops == 1 and all(a.data_ptr() != b.data_ptr() for a, b in zip(z0, z1))
    assert [z.numel() for z in ring.landing(64)] == [64] * 3
    ring.check()


# -- the mesh --------------------------------------------------------------------


@pytest.mark.parametrize("count,want", [
    (1, [0] * 8), (2, [0, 0, 0, 0, 1, 1, 1, 1]), (3, [0, 0, 0, 1, 1, 1, 2, 2]),
    (4, [0, 0, 1, 1, 2, 2, 3, 3]), (8, list(range(8)))])
def test_ranks_go_to_cards_in_blocks(count, want):
    assert block_devices(list(range(count)), N) == want


def test_one_rank_per_device_as_the_reference_places_them(devices):
    """With as many devices as ranks, rank r is on device r, as under the
    reference's ``rank_sharding``; its ``submesh`` keeps the chosen
    ranks' devices in order, and so does the port's."""
    ref = jmesh.CommMesh(devices)
    port = CommMesh(layout="devices", devices=[torch.device("cpu", i) for i in range(N)])
    assert [d.index for d in port.devices] == [d.id for d in ref.devices] \
        == block_devices(list(range(N)), N)
    for idx in ([5, 2, 7], [7, 6, 5, 4, 3, 2, 1, 0], [3]):
        rsub, psub = ref.submesh(idx), port.submesh(idx)
        assert psub.layout == "devices" and psub.size == rsub.size
        assert [d.index for d in psub.devices] == [d.id for d in rsub.devices]


def test_device_order_id_sorts_as_the_reference_does(devices):
    """``accelerator_cuda_device_order id`` sorts cards by their stable id,
    as ``accelerator_tpu_device_order id`` sorts by ``d.id``."""
    shuffled = [devices[i] for i in (3, 0, 7, 1, 6, 2, 5, 4)]
    ref = sorted(shuffled, key=lambda d: d.id)
    keys = [d.id for d in shuffled]
    assert [shuffled[i] for i in order_device_ids(keys, "id")] == ref
    assert order_device_ids(keys, "default") == list(range(N))
    with pytest.raises(MPIArgError):
        order_device_ids(keys, "fastest")
    tapi.finalize()
    try:
        w = tapi.init({"accelerator_cuda_layout": "devices",
                       "accelerator_cuda_device_order": "id"}, device="cpu", nranks=4)
        assert w.mesh.layout == "devices" and w.mesh.devices == (CPU,) * 4
    finally:
        tapi.finalize()


def test_devices_layout_without_cpu_raises_on_this_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    with pytest.raises(MPIInternalError, match="no CUDA device"):
        CommMesh(layout="devices")
    tapi.finalize()
    with pytest.raises(MPIInternalError, match="no CUDA device"):
        tapi.init({"accelerator_cuda_layout": "devices"})
    assert not tapi.initialized()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, ml_dtypes.bfloat16, np.int32,
                                   np.uint64, np.uint8, np.complex64])
def test_stage_in_stage_out_round_trip(dtype):
    mesh = CommMesh("cpu", N, layout="devices")
    x = rank_data(N, (5, 3), dtype, seed=4) if np.dtype(dtype).kind != "c" else \
        (rank_data(N, (5, 3), np.float32, seed=4) + 1j).astype(dtype)
    s = mesh.stage_in(x)
    assert isinstance(s, RankShards) and s.shape == x.shape and s.devices == mesh.devices
    assert len({t.data_ptr() for t in s.shards}) == N  # one allocation per rank
    same_bits(mesh.stage_out(s), x)
    with pytest.raises(MPIArgError, match="leading dim"):
        mesh.stage_in(x[:3])


# -- Comm on the devices layout ------------------------------------------------


@contextlib.contextmanager
def pinned(store, values: dict):
    prev = {k: store.get(k) for k in values}
    for k, v in values.items():
        store.set(k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            store.set(k, v)


RING_VARS = {"allreduce": "allreduce_algorithm", "allgather": "allgather_algorithm",
             "reduce_scatter_block": "reduce_scatter_algorithm"}
#: the ``cuda_ring`` / ``pallas_ring`` slot of each collective's enum
RING_ALGO = {"allreduce": ALLREDUCE_ALGOS["cuda_ring"],
             "allgather": ALLGATHER_ALGOS["cuda_ring"],
             "reduce_scatter_block": REDUCE_SCATTER_ALGOS["cuda_ring"]}


@pytest.fixture(scope="module")
def ref_world(devices):
    return japi.init()


def devices_comm(n=N) -> Comm:
    return Comm(Group(range(n)), CommMesh("cpu", n, layout="devices"), name="devices")


def comm_call(comm, coll, x, op):
    return comm.allgather(x) if coll == "allgather" else getattr(comm, coll)(x, op)


COMM_CASES = [
    ("allreduce", "MPI_SUM", np.float32), ("allreduce", "MPI_MAX", np.float64),
    ("allreduce", "MPI_SUM", ml_dtypes.bfloat16), ("allreduce", "MPI_PROD", np.int32),
    ("allgather", None, np.float32), ("allgather", None, np.uint16),
    ("reduce_scatter_block", "MPI_SUM", np.float32),
    ("reduce_scatter_block", "MPI_MIN", np.float64),
]


@pytest.mark.parametrize("jax_mode", ["emulate", "interpret"])
@pytest.mark.parametrize("size", [3, 6, N])
@pytest.mark.parametrize("coll,opname,dtype", COMM_CASES,
                         ids=[f"{c}-{o}-{np.dtype(d).name}" for c, o, d in COMM_CASES])
def test_comm_cuda_ring_matches_reference_pallas_ring(ref_world, coll, opname, dtype, size,
                                                      jax_mode):
    """The whole entry point — staging, coll table (tuned over cuda),
    resolved callable, shard schedule, unstaging — against the
    reference's ``Comm`` with ``pallas_ring`` forced, on a sub-comm of
    ``size`` ranks of each world."""
    shape = (size, 3, 7) if coll == "reduce_scatter_block" else (37,)
    x = rank_data(size, shape, dtype, seed=size)
    var = RING_VARS[coll]
    jcomm = ref_world.split([0] * size + [1] * (N - size))[0] if size < N else ref_world
    tcomm = devices_comm(N).split([0] * size + [1] * (N - size))[0] if size < N \
        else devices_comm(N)
    assert tcomm.mesh.layout == "devices" and tcomm.size == size
    jstore, tstore = jmca.default_context().store, tmca.default_context().store
    with pinned(jstore, {f"coll_xla_{var}": RING_ALGO[coll],
                         "dcn_device_interpret": jax_mode == "interpret"}), \
            pinned(tstore, {f"coll_cuda_{var}": RING_ALGO[coll]}):
        want = comm_call(jcomm, coll, x, _jax_op(opname) if opname else None)
        got = comm_call(tcomm, coll, x, _torch_op(opname) if opname else None)
        again = comm_call(tcomm, coll, shards_of(x), _torch_op(opname) if opname else None)
    assert isinstance(got, np.ndarray) and isinstance(again, RankShards)
    same_bits(got, np.asarray(want))
    same_bits(again.to_host(), np.asarray(want))


@pytest.mark.parametrize("coll", list(RING_VARS))
def test_rows_and_devices_layouts_give_the_same_bits(coll):
    x = rank_data(N, (N, 5, 3) if coll == "reduce_scatter_block" else (1001,), np.float32,
                  seed=9)
    rows = Comm(Group(range(N)), CommMesh("cpu", N), name="rows")
    devs = devices_comm()
    store = tmca.default_context().store
    with pinned(store, {f"coll_cuda_{RING_VARS[coll]}": RING_ALGO[coll]}):
        a = comm_call(rows, coll, x, top.SUM)
        b = comm_call(devs, coll, x, top.SUM)
        for interp in (False, True):  # the plain rung too
            with pinned(store, {"dcn_device_interpret": interp}):
                same_bits(comm_call(devs, coll, x, top.SUM), a)
    same_bits(b, a)


OTHER_ALGORITHMS = [
    ("allreduce", "auto"), ("allreduce", "ring"), ("allreduce", "psum"),
    ("allgather", "auto"), ("allgather", "direct"),
    ("reduce_scatter_block", "auto"), ("reduce_scatter_block", "ring")]


@pytest.mark.parametrize("coll,algo", OTHER_ALGORITHMS)
def test_other_algorithms_raise_the_named_error(ref_world, coll, algo):
    """The algorithms besides ``cuda_ring`` run on the devices layout:
    each equals the reference's ``Comm`` with the same algorithm pinned
    and the rows layout's, bit for bit, except ``psum`` (and ``auto``,
    which is ``psum`` for SUM) and reduce_scatter ``auto`` (``direct``):
    XLA orders those reductions, so ``allclose`` at rtol 1e-5."""
    enum = {"allreduce": ALLREDUCE_ALGOS, "allgather": ALLGATHER_ALGOS,
            "reduce_scatter_block": REDUCE_SCATTER_ALGOS}[coll]
    x = rank_data(N, (N, 2) if coll == "reduce_scatter_block" else (41,), np.float32, seed=3)
    var = RING_VARS[coll]
    rows = Comm(Group(range(N)), CommMesh("cpu", N), name="rows")
    devs = devices_comm()
    assert devs.coll and rows.coll  # the coll framework's vars are registered
    jo, to = (_jax_op("MPI_SUM"), top.SUM) if coll != "allgather" else (None, None)
    with pinned(jmca.default_context().store, {f"coll_xla_{var}": enum[algo]}), \
            pinned(tmca.default_context().store, {f"coll_cuda_{var}": enum[algo]}):
        want = np.asarray(comm_call(ref_world, coll, x, jo))
        got = comm_call(devs, coll, x, to)
        flat = comm_call(rows, coll, x, to)
    if algo in ("auto", "psum") and coll != "allgather":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * N * np.abs(x).max())
        np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-5 * N * np.abs(x).max())
    else:
        same_bits(got, want)
        same_bits(got, flat)


def test_everything_else_raises_the_named_error(monkeypatch):
    """Point-to-point, windows and the typed (``*_ddt``) entry points run
    on a devices comm (each send posted before its receive: one
    controller drives every rank, so a receive with nothing sent would
    block), a devices comm still refuses one plain tensor with the named
    error (nothing is moved implicitly), and a respawned process's
    ``init()`` builds a devices world on ``block_devices``' devices
    (``tests/test_torch_devices_recovery.py`` runs the recovery jobs and
    the same ``init()`` on four cards)."""
    from torch_mp_common import reborn_init

    from ompi_tpu_torch.ddt.datatype import FLOAT

    comm = devices_comm()
    x = rank_data(N, (4,), np.float32)
    comm.send(x[0], 0, 1)
    got, st = comm.recv(1, 0)
    assert got.tobytes() == x[0].tobytes() and (st.source, st.nbytes) == (0, 16)
    comm.isend(x[2], 2, 1).wait()
    assert comm.iprobe(1).source == 2
    assert comm.irecv(1).wait().tobytes() == x[2].tobytes()
    comm.send_init(x[3], 3, 1).start()
    assert comm.recv(1, 3)[0].tobytes() == x[3].tobytes()
    bases = [np.zeros(4, np.float32) for _ in range(N)]
    win = comm.win_create(bases)
    win.fence()
    win.put(0, 5, x[0])
    win.fence()
    assert bases[5].tobytes() == x[0].tobytes()
    assert isinstance(comm.win_allocate(4).device_view(), RankShards)
    same_bits(comm.allreduce_ddt(list(x), 4, FLOAT, top.MAX), x.max(0, keepdims=True).repeat(N, 0))
    assert [b.tobytes() for b in comm.bcast_ddt(x[6], 4, FLOAT, root=6)] == [x[6].tobytes()] * N
    with pytest.raises(MPIArgError, match="numpy or RankShards"):
        comm.allreduce(torch.zeros(N, 4))
    mesh = reborn_init(monkeypatch, 0, 1, N, "cpu")
    assert mesh.layout == "devices"
    assert mesh.devices == tuple(block_devices([torch.device("cpu")], N, 0, 1))


def test_split_dup_and_submesh_keep_the_layout():
    comm = devices_comm()
    for c in (comm.dup(), comm.split([r % 2 for r in range(N)])[1],
              comm.create_group(Group([6, 1, 3]))):
        assert c.mesh.layout == "devices" and len(c.mesh.devices) == c.size
    shards = shards_of(rank_data(N, (4,), np.float32))
    with pytest.raises(MPIArgError, match="comm size|shape"):
        comm.split([r % 2 for r in range(N)])[0].allreduce(shards)


def test_init_builds_a_devices_world_on_the_cpu():
    tapi.finalize()
    try:
        w = tapi.init({"accelerator_cuda_layout": "devices",
                       "coll_cuda_allreduce_algorithm": "cuda_ring"}, device="cpu", nranks=N)
        assert w.mesh.layout == "devices" and w.mesh.devices == (CPU,) * N
        assert tapi.comm_self().mesh.layout == "devices"
        x = rank_data(N, (33,), np.float32, seed=2)
        same_bits(w.allreduce(x), np.asarray(ck.ring_allreduce(from_numpy(x), top.SUM,
                                                               _mode="cuda")))
    finally:
        tapi.finalize()
    with pytest.raises(MPIArgError):
        tapi.init({"accelerator_cuda_layout": "diagonal"}, device="cpu")
    tapi.finalize()

