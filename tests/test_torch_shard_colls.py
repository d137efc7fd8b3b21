"""Every collective of ``coll/cuda`` on the devices layout against the JAX package.

The reference runs a communicator one rank per device; the port's
``CommMesh("cpu", n, layout="devices")`` gives every rank a buffer of
its own (``RankShards``) and runs the reference's per-device algorithms
once per rank (``ompi_tpu_torch.coll.base_shards``).  The same seeded
numpy inputs (``rank_data``) go through:

* the reference's ``Comm`` on the conftest's 8 virtual XLA devices (a
  sub-comm of 3, 6 or 8 ranks), with the same ``coll_xla_*_algorithm``
  pinned;
* the port's ``Comm`` on a devices-layout mesh of the same size, with
  ``coll_cuda_*_algorithm`` pinned, in its blocking, i and init forms;
* the port's ``Comm`` on the rows layout, the same algorithm pinned.

Tolerance: bit for bit on byte views, except where the reference leaves
the reduction order to XLA (allreduce ``psum``, and ``auto``, which is
``psum`` for SUM/MAX/MIN; reduce_scatter ``direct``, and ``auto`` with
SUM).  There the port runs the ring over the cross-device hop and is
held with ``allclose``: rtol 1e-5 (f32), 1e-12 (f64), 1e-2 (bf16), atol
the same times n times the largest input magnitude; integers stay exact.
The rows layout's ``psum`` is one torch reduction over the rank axis, so
it too is held to the devices layout within that tolerance.
"""

import contextlib
import types

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_coll import J_AFFINE, T_AFFINE, _jax_op, _torch_op, rank_data

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu.core import mca as jmca
from ompi_tpu_torch import request as treq
from ompi_tpu_torch.api import Comm, Group
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.coll import sched
from ompi_tpu_torch.coll.cuda import (
    ALLGATHER_ALGOS,
    ALLREDUCE_ALGOS,
    ALLTOALL_ALGOS,
    BARRIER_ALGOS,
    BCAST_ALGOS,
    REDUCE_ALGOS,
    REDUCE_SCATTER_ALGOS,
)
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.ddt.datatype import from_numpy
from ompi_tpu_torch.mesh.mesh import CommMesh
from ompi_tpu_torch.mesh.shards import RankShards

N = 8
SIZES = (3, 6, N)
RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12,
        np.dtype(ml_dtypes.bfloat16): 1e-2}
#: a segment of ring_segmented and bcast pipeline: the inputs span several
SEGCOUNT = 16

#: collective → (its algorithm var, its enum); gather, scatter, scan and
#: exscan have one algorithm each
ENUMS = {
    "allreduce": ("allreduce_algorithm", ALLREDUCE_ALGOS),
    "bcast": ("bcast_algorithm", BCAST_ALGOS),
    "reduce": ("reduce_algorithm", REDUCE_ALGOS),
    "allgather": ("allgather_algorithm", ALLGATHER_ALGOS),
    "reduce_scatter_block": ("reduce_scatter_algorithm", REDUCE_SCATTER_ALGOS),
    "alltoall": ("alltoall_algorithm", ALLTOALL_ALGOS),
    "gather": (None, {"copy": None}),
    "scatter": (None, {"copy": None}),
    "scan": (None, {"ordered": None}),
    "exscan": (None, {"ordered": None}),
}
#: every collective × every algorithm of its enum, ``auto`` included
CASES = [(coll, algo) for coll, (_, enum) in ENUMS.items() for algo in enum]
CASE_IDS = [f"{c}-{a}" for c, a in CASES]
HAS_OP = {"allreduce", "reduce", "reduce_scatter_block", "scan", "exscan"}
ROOT = {"bcast": 2, "reduce": 1, "gather": 2, "scatter": 1}
FORMS = ("blocking", "i", "init")


@pytest.fixture(scope="module")
def comms(devices):
    """size → (the reference's comm, the port's devices comm, its rows
    comm), made once so each keeps its compiled programs."""
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


@contextlib.contextmanager
def pinned(coll: str | None, algo: str | None, reproducible: bool = False):
    """The same algorithm (same enum number) pinned in both packages."""
    stores = {"xla": jmca.default_context().store, "cuda": tmca.default_context().store}
    values = {"segcount": SEGCOUNT, "reproducible": reproducible}
    var, enum = ENUMS.get(coll, (None, {}))
    if var is not None:
        values[var] = enum[algo]
    prev = {(k, v): s.get(f"coll_{k}_{v}") for k, s in stores.items() for v in values}
    for k, s in stores.items():
        for v, val in values.items():
            s.set(f"coll_{k}_{v}", val)
    try:
        yield
    finally:
        for (k, v), val in prev.items():
            stores[k].set(f"coll_{k}_{v}", val)


def inputs(coll: str, n: int, dtype, seed: int) -> np.ndarray:
    shape = {"allgather": (3, 5), "reduce_scatter_block": (n, 7),
             "alltoall": (n, 5)}.get(coll, (37,))
    return rank_data(n, shape, dtype, seed=seed)


def args_of(coll: str, x, op):
    if coll in HAS_OP:
        return (x, op, ROOT[coll]) if coll == "reduce" else (x, op)
    return (x, ROOT[coll]) if coll in ROOT else (x,)


def call(comm, coll: str, x, op, form: str = "blocking"):
    args = args_of(coll, x, op)
    if form == "blocking":
        return getattr(comm, coll)(*args)
    if form == "i":
        return getattr(comm, "i" + coll)(*args).wait()
    req = getattr(comm, coll + "_init")(*args)
    outs = []
    for _ in range(2):  # a persistent request started twice
        req.start()
        outs.append(req.wait())
    same(outs[1], outs[0])
    return outs[0]


def host(v) -> np.ndarray:
    if isinstance(v, RankShards):
        return v.to_host()
    if isinstance(v, torch.Tensor):
        from ompi_tpu_torch.ddt.datatype import to_numpy

        return to_numpy(v)
    return np.asarray(v)


def same(got, want):
    got, want = host(got), host(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def close(got, want, x):
    """``allclose`` at the dtype's rtol (exact for integers)."""
    got, want = host(got), host(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    rtol = RTOL.get(np.dtype(want.dtype))
    if rtol is None:
        assert got.tobytes() == want.tobytes()
        return
    scale = np.abs(np.asarray(x, np.float64)).max() * x.shape[0]
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=rtol, atol=rtol * scale)


def xla_ordered(coll: str, algo: str, op, reproducible: bool) -> bool:
    """False where the reference's result order is XLA's own (psum,
    psum_scatter): the algorithm the module resolves ``algo`` to."""
    if reproducible or op is None or op.collective is None or not op.commutative:
        return True
    if coll == "allreduce":
        return algo not in ("auto", "psum")
    if coll == "reduce_scatter_block":
        return not (algo in ("auto", "direct") and op.collective == "sum")
    return True


def check(comms, coll, algo, n, dtype, opname, forms=FORMS, reproducible=False,
          seed=0, shards_too=False):
    """The reference's blocking call == the port's devices comm in every
    form == its rows comm (all with ``algo`` pinned)."""
    jcomm, tdev, trows = comms[n]
    x = inputs(coll, n, dtype, seed)
    if opname == "affine":
        jo, to = J_AFFINE, T_AFFINE
    else:
        jo = _jax_op(opname) if coll in HAS_OP else None
        to = _torch_op(opname) if coll in HAS_OP else None
    exact = xla_ordered(coll, algo, to, reproducible)
    with pinned(coll, algo, reproducible):
        want = call(jcomm, coll, x, jo)
        rows = call(trows, coll, x, to)
        for form in forms:
            got = call(tdev, coll, x, to, form)
            assert isinstance(got, np.ndarray)
            if exact:
                same(got, want)
                same(got, rows)
            else:
                close(got, want, x)
                close(got, rows, x)
        if shards_too:
            again = call(tdev, coll, RankShards([from_numpy(r) for r in x]), to)
            assert isinstance(again, RankShards if coll not in ("gather", "reduce")
                              else torch.Tensor)
            same(again, got)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("coll,algo", CASES, ids=CASE_IDS)
def test_every_algorithm_every_form(comms, coll, algo, n):
    """f32 (SUM where there is an op) at each comm size, in the blocking,
    i and init forms, and with ``RankShards`` in and out."""
    check(comms, coll, algo, n, np.float32, "MPI_SUM", seed=n, shards_too=True)


DTYPE_OPS = [(np.float64, "MPI_MIN"), (ml_dtypes.bfloat16, "MPI_SUM"), (np.int32, "MPI_PROD"),
             (np.uint16, "MPI_MAX")]


@pytest.mark.parametrize("dtype,opname", DTYPE_OPS,
                         ids=[f"{np.dtype(d).name}-{o}" for d, o in DTYPE_OPS])
@pytest.mark.parametrize("coll,algo", CASES, ids=CASE_IDS)
def test_every_algorithm_every_dtype(comms, coll, algo, dtype, opname):
    """f64, bf16, int32 and uint16 (unsigned words ride their signed
    carrier) at 8 ranks, blocking."""
    check(comms, coll, algo, N, dtype, opname, forms=("blocking",), seed=17)


NONCOMM = [(c, a) for c, a in CASES if c in HAS_OP]


@pytest.mark.parametrize("coll,algo", NONCOMM, ids=[f"{c}-{a}" for c, a in NONCOMM])
def test_non_commutative_user_op(comms, coll, algo):
    """A non-commutative user op at 6 ranks (not a power of two): the
    promotions to the ordered paths, and recursive doubling's and
    Rabenseifner's operand order, as the reference's."""
    check(comms, coll, algo, 6, np.int32, "affine", forms=("blocking", "i"), seed=23)


REPRO = [("allreduce", "cuda_ring"), ("allreduce", "psum"), ("allreduce", "auto"),
         ("reduce", "binomial"), ("reduce_scatter_block", "direct"),
         ("reduce_scatter_block", "cuda_ring")]


@pytest.mark.parametrize("coll,algo", REPRO, ids=[f"{c}-{a}" for c, a in REPRO])
def test_reproducible_mode_pins_the_ordered_paths(comms, coll, algo):
    """``coll_cuda_reproducible`` (and the reference's
    ``coll_xla_reproducible``) overrides the pinned algorithm with the
    rank-ordered fold: bit for bit in every form, even for SUM."""
    check(comms, coll, algo, N, np.float32, "MPI_SUM", reproducible=True, seed=29)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo", list(BARRIER_ALGOS))
def test_barrier_every_algorithm_every_form(comms, algo, n):
    """The barrier's token is one int32 per rank on its own device; its
    three forms complete, as the reference's do."""
    jcomm, tdev, _ = comms[n]
    with pinned("barrier", algo):
        jcomm.barrier()
        tdev.barrier()
        assert tdev.ibarrier().wait() is not None
        req = tdev.barrier_init()
        for _ in range(2):
            req.start()
            out = req.wait()
        assert isinstance(out, RankShards) and out.shape == (n,)
        assert out.devices == tdev.mesh.devices and out.dtype == torch.int32


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_MAX"])
def test_reduce_scatter_with_counts(comms, n, opname):
    """Equal counts (blocked into reduce_scatter_block, numpy and shards
    in) and jagged counts (the host path, the shards' host copy in) as
    the reference's."""
    jcomm, tdev, trows = comms[n]
    x = rank_data(n, (2 * n,), np.float32, seed=31 + n)
    jo, to = _jax_op(opname), _torch_op(opname)
    with pinned("reduce_scatter_block", "ring"):
        want = np.asarray(jcomm.reduce_scatter(x, jo, counts=[2] * n))
        same(tdev.reduce_scatter(x, to, counts=[2] * n), want)
        same(tdev.reduce_scatter(RankShards([from_numpy(r) for r in x]), to,
                                 counts=[2] * n), want)
        same(tdev.reduce_scatter(x.reshape(n, n, 2), to), want)
    jag = [1 + r % 3 for r in range(n - 1)]
    jag.append(2 * n - sum(jag))
    want = jcomm.reduce_scatter(x, jo, counts=jag)
    for got in (tdev.reduce_scatter(x, to, counts=jag),
                tdev.reduce_scatter(RankShards([from_numpy(r) for r in x]), to, counts=jag),
                trows.reduce_scatter(x, to, counts=jag)):
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            same(g, w)


@pytest.mark.parametrize("name", ["allgatherv", "gatherv", "scatterv", "alltoallv"])
def test_v_collectives_take_the_host_path(comms, name):
    jcomm, tdev, trows = comms[N]
    rng = np.random.RandomState(37)
    if name == "alltoallv":
        arg = [[rng.randn((r + j) % 3).astype(np.float32) for j in range(N)] for r in range(N)]
        want = getattr(jcomm, name)(arg)
        for got in (getattr(tdev, name)(arg), getattr(trows, name)(arg)):
            for grow, wrow in zip(got, want):
                for g, w in zip(grow, wrow):
                    same(g, w)
        return
    blocks = [rng.randn(r + 1).astype(np.float32) for r in range(N)]
    args = (blocks,) if name == "allgatherv" else (blocks, 3)
    want = getattr(jcomm, name)(*args)
    for got in (getattr(tdev, name)(*args),
                getattr(tdev, name)(*((list(map(from_numpy, blocks)),) + args[1:]))):
        assert len(got) == len(want) == N
        for g, w in zip(got, want):
            same(g, w)


# -- the request and the plan cache ------------------------------------------------


def test_tensors_of_rank_shards_lists_every_shard():
    s = RankShards([torch.full((2,), float(r)) for r in range(5)])
    got = treq._tensors(s)
    assert len(got) == 5 and all(a is b for a, b in zip(got, s.shards))
    assert len(treq._tensors([s, (torch.zeros(1), s)])) == 11


class _FakeEvent:
    log: list = []

    def __init__(self):
        self.stream = None
        self.synced = False

    def record(self, stream):
        self.stream = stream
        _FakeEvent.log.append(self)

    def query(self):
        return self.stream != "busy"

    def synchronize(self):
        self.synced = True


def test_request_records_one_event_per_card(monkeypatch):
    """An ArrayRequest over tensors on cards 0, 1 and 3 records one event
    on each card's current stream; it tests complete only when every
    event has, and its wait synchronizes every one."""
    cards = [0, 3, 0, 1, 3, 3]
    fakes = [types.SimpleNamespace(device=torch.device("cuda", c)) for c in cards]
    monkeypatch.setattr(treq, "_tensors", lambda _x: fakes)
    monkeypatch.setattr(treq.torch.cuda, "Event", _FakeEvent)
    streams = {0: "s0", 1: "busy", 3: "s3"}
    monkeypatch.setattr(treq.torch.cuda, "current_stream", lambda card: streams[card])
    _FakeEvent.log = []
    req = treq.ArrayRequest("shards")
    assert sorted(ev.stream for ev in _FakeEvent.log) == ["busy", "s0", "s3"]
    assert not req.test()  # card 1's stream is still busy
    assert req.wait() == "shards"
    assert all(ev.synced for ev in _FakeEvent.log)
    streams[1] = "s1"
    _FakeEvent.log = []
    done = treq.ArrayRequest("again")
    assert done.test() and len(_FakeEvent.log) == 3


def test_persistent_plan_keys_on_the_device_tuple(comms):
    """A fresh comm over the same devices replays the plan; one whose
    first device is the same but whose device tuple differs does not,
    and neither does a rows comm on the same device."""
    tup = [torch.device("cpu", i) for i in (0, 1, 2)]
    other = [torch.device("cpu", i) for i in (0, 2, 1)]
    x = rank_data(3, (11,), np.float32, seed=41)
    from ompi_tpu_torch.op import SUM

    def misses(devices=None):
        mesh = CommMesh("cpu", 3) if devices is None else \
            CommMesh(layout="devices", devices=devices)
        s0 = sched.CACHE.stats()
        req = Comm(Group(range(3)), mesh).allreduce_init(x, SUM)
        req.start()
        req.wait()
        s1 = sched.CACHE.stats()
        return s1["sched_cache_misses"] - s0["sched_cache_misses"]

    with pinned("allreduce", "ring"):
        misses(tup)
        assert misses(tup) == 0  # the same device tuple: a hit
        assert misses(other) == 1  # same first device, another tuple
        assert misses() == 1  # the rows layout on the same device
        assert misses() == 0


def test_cuda_shards_psum_without_a_ring_raises():
    """A shard ring handed CUDA buffers uses the kernels or raises: it
    never takes the plain twin (the meta device stands in for a card)."""
    xs = [torch.empty(8, device="meta") for _ in range(3)]
    before = dict(ck.LAUNCHES)
    with pytest.raises(MPIArgError, match="PeerRing"):
        ck.ring_allreduce_shards(xs, _torch_op("MPI_SUM"), None, _mode="cuda")
    assert ck.LAUNCHES == before
