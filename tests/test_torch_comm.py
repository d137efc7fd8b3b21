"""The port's communicator API against ``ompi_tpu.api.Comm``.

Both worlds are 8 ranks: the JAX one on the conftest's virtual CPU
devices, the port's as 8 rows of rank-major tensors on the CPU
(``init(device="cpu", nranks=8)``).  Each test pins the same algorithm
number on both sides (``coll_xla_<coll>_algorithm`` and
``coll_cuda_<coll>_algorithm``) and sends the same numpy buffers
through the whole path — argument checks, coll table, resolved
callable, staging — bit for bit except psum/direct (rtol 1e-6).
Mirrors ``tests/test_api_comm.py`` and its
``test_bit_exact_reproducible_mode``.
"""

import contextlib

import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu import op as jop
from ompi_tpu.core import mca as jmca
from ompi_tpu_torch import op as top
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.coll.cuda import (
    ALLGATHER_ALGOS,
    ALLREDUCE_ALGOS,
    REDUCE_SCATTER_ALGOS,
)
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError, MPIOpError, MPIRootError

N = 8
CLOSE = {"rtol": 1e-6}


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


@contextlib.contextmanager
def pinned(var, value):
    """``coll_xla_<var>`` and ``coll_cuda_<var>`` set to ``value``."""
    stores = {"xla": jmca.default_context().store, "cuda": tmca.default_context().store}
    prev = {k: s.get(f"coll_{k}_{var}") for k, s in stores.items()}
    for k, s in stores.items():
        s.set(f"coll_{k}_{var}", value)
    try:
        yield
    finally:
        for k, s in stores.items():
            s.set(f"coll_{k}_{var}", prev[k])


def rank_data(shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.randint(0, 100, (N,) + shape).astype(dtype)
    return (rng.randn(N, *shape) * 10.0 ** rng.randint(-3, 4, (N,) + shape)).astype(dtype)


def same(got, want, exact=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), **CLOSE)


def test_world_on_cpu(worlds):
    _, tw = worlds
    assert tw.size == N and tw.device == torch.device("cpu")
    assert tw.coll.providers["allreduce"] == "tuned"  # tuned wraps coll/cuda
    assert tw.coll.providers["allgatherv"] == "basic"


@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_MAX", "MPI_PROD"])
@pytest.mark.parametrize("algo", sorted(set(ALLREDUCE_ALGOS.values()) - {0}))
def test_allreduce_every_algorithm(worlds, algo, opname):
    jw, tw = worlds
    x = rank_data((37,), seed=algo)
    with pinned("allreduce_algorithm", algo):
        want = jw.allreduce(x, jop.PREDEFINED_OPS[opname])
        got = tw.allreduce(x, top.PREDEFINED_OPS[opname])
    assert isinstance(got, np.ndarray)
    same(got, want, exact=not (algo == ALLREDUCE_ALGOS["psum"] and opname == "MPI_SUM"))


def test_cuda_ring_enum_is_the_pallas_ring_slot():
    from ompi_tpu.coll import xla

    assert ALLREDUCE_ALGOS["cuda_ring"] == xla.ALLREDUCE_ALGOS["pallas_ring"] == 7
    assert ALLGATHER_ALGOS["cuda_ring"] == xla.ALLGATHER_ALGOS["pallas_ring"] == 4
    assert REDUCE_SCATTER_ALGOS["cuda_ring"] == xla.REDUCE_SCATTER_ALGOS["pallas_ring"] == 4
    for ours, theirs in ((ALLREDUCE_ALGOS, xla.ALLREDUCE_ALGOS),
                         (ALLGATHER_ALGOS, xla.ALLGATHER_ALGOS),
                         (REDUCE_SCATTER_ALGOS, xla.REDUCE_SCATTER_ALGOS)):
        assert sorted(ours.values()) == sorted(theirs.values())


def test_non_commutative_cuda_ring_promotes_to_ordered(worlds):
    jw, tw = worlds
    fn = lambda a, b: a * 3 + b  # noqa: E731
    x = rank_data((9,), np.int64, seed=2)
    with pinned("allreduce_algorithm", 7):
        want = jw.allreduce(x, jop.create_op(fn, commute=False))
        got = tw.allreduce(x, top.create_op(fn, commute=False))
    same(got, want)


@pytest.mark.parametrize("algo", [1, 2, 3, 4])
def test_allgather(worlds, algo):
    jw, tw = worlds
    x = rank_data((3, 4), seed=3)
    with pinned("allgather_algorithm", algo):
        same(tw.allgather(x), jw.allgather(x))


@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_MIN"])
@pytest.mark.parametrize("algo", [1, 2, 3, 4])
def test_reduce_scatter_block(worlds, algo, opname):
    jw, tw = worlds
    x = rank_data((N, 6), seed=4)
    with pinned("reduce_scatter_algorithm", algo):
        want = jw.reduce_scatter_block(x, jop.PREDEFINED_OPS[opname])
        got = tw.reduce_scatter_block(x, top.PREDEFINED_OPS[opname])
    same(got, want, exact=not (algo == 1 and opname == "MPI_SUM"))


@pytest.mark.parametrize("algo", [1, 2, 3])
def test_bcast(worlds, algo):
    jw, tw = worlds
    x = rank_data((11,), seed=5)
    with pinned("bcast_algorithm", algo):
        same(tw.bcast(x, root=5), jw.bcast(x, root=5))


@pytest.mark.parametrize("algo", [1, 2])
def test_reduce_alltoall_and_barrier(worlds, algo):
    jw, tw = worlds
    x = rank_data((11,), seed=6)
    blocks = rank_data((N, 3), seed=7)
    with pinned("reduce_algorithm", algo):
        same(tw.reduce(x, top.SUM, root=3), jw.reduce(x, jop.SUM, root=3))
    with pinned("alltoall_algorithm", algo):
        same(tw.alltoall(blocks), jw.alltoall(blocks))
    with pinned("barrier_algorithm", algo):
        tw.barrier()
        tw.ibarrier().wait()
        req = tw.barrier_init()
        req.start()
        req.wait()


def test_gather_scatter_scan_exscan(worlds):
    jw, tw = worlds
    x = rank_data((7,), seed=8)
    same(tw.gather(x, root=2), jw.gather(x, root=2))
    same(tw.scatter(x, root=2), jw.scatter(x, root=2))
    same(tw.scan(x, top.SUM), jw.scan(x, jop.SUM))
    same(tw.exscan(x, top.SUM)[1:], np.asarray(jw.exscan(x, jop.SUM))[1:])


def test_reduce_scatter_counts(worlds):
    jw, tw = worlds
    x = rank_data((N * 2,), seed=9)
    same(tw.reduce_scatter(x, top.SUM, counts=[2] * N),
         jw.reduce_scatter(x, jop.SUM, counts=[2] * N), exact=False)
    jag = [1, 3, 2, 2, 0, 4, 2, 2]
    got = tw.reduce_scatter(x, top.SUM, counts=jag)
    want = jw.reduce_scatter(x, jop.SUM, counts=jag)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        same(g, w)


def test_nonblocking_and_persistent(worlds):
    jw, tw = worlds
    x = rank_data((13,), seed=10)
    with pinned("allreduce_algorithm", 2):
        want = np.asarray(jw.allreduce(x, jop.SUM))
        same(tw.iallreduce(x, top.SUM).wait(), want)
        req = tw.allreduce_init(x, top.SUM)
        for _ in range(2):
            req.start()
            same(req.wait(), want)
    want_root = jw.reduce(x, jop.SUM, root=1)
    same(tw.ireduce(x, top.SUM, root=1).wait(), want_root)
    preq = tw.reduce_init(x, top.SUM, root=1)
    preq.start()
    same(preq.wait(), want_root)
    same(tw.iallgather(x).wait(), jw.allgather(x))
    blocks = rank_data((N, 2), seed=11)
    same(tw.ialltoall(blocks).wait(), jw.alltoall(blocks))
    same(tw.iscan(x, top.SUM).wait(), jw.scan(x, jop.SUM))


def test_tensor_in_tensor_out(worlds):
    _, tw = worlds
    x = torch.from_numpy(np.round(rank_data((5,), np.float64, seed=12)))
    out = tw.allreduce(x, top.SUM)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out[0], x.sum(0), rtol=0, atol=0)


def test_bit_exact_reproducible_mode(worlds):
    """``coll_cuda_reproducible`` → fp32 SUM bit-equal to the host golden
    fold through the whole API path, as the reference's mode is."""
    jw, tw = worlds
    x = rank_data((257,), np.float32, seed=13)
    golden = top.ordered_reduce_np(x, top.SUM)
    with pinned("reproducible", True):
        got = tw.allreduce(x, top.SUM)
        want = np.asarray(jw.allreduce(x, jop.SUM))
    for r in range(N):
        assert np.array_equal(got[r].view(np.uint8), golden.view(np.uint8))
    same(got, want)


def test_dup_split_and_subcomm_traffic(worlds):
    jw, tw = worlds
    colors = [r % 3 for r in range(N)]
    keys = [-r for r in range(N)]
    tsubs, jsubs = tw.split(colors, keys), jw.split(colors, keys)
    x = rank_data((6,), seed=14)
    for c in range(3):
        members = [r for r in range(N) if colors[r] == c]
        ts, js = tsubs[members[0]], jsubs[members[0]]
        assert ts.size == js.size == len(members)
        assert ts.group.ranks == tuple(sorted(members, key=lambda r: -r))
        sx = x[: ts.size]
        with pinned("allreduce_algorithm", 7):
            same(ts.allreduce(sx, top.SUM), js.allreduce(sx, jop.SUM))
    d = tw.dup()
    assert d.cid != tw.cid and d.size == N
    same(d.allgather(x), tw.allgather(x))
    d.free()


def test_argument_errors(worlds):
    _, tw = worlds
    x = rank_data((4,), seed=15)
    with pytest.raises(MPIRootError):
        tw.bcast(x, root=N)
    with pytest.raises(MPIArgError):
        tw.allreduce(x[:3], top.SUM)
    with pytest.raises(MPIOpError):
        tw.allreduce(x, top.BAND)  # bitwise op on floats


def test_cuda_ring_on_cpu_launches_no_kernel(worlds):
    _, tw = worlds
    x = rank_data((100,), seed=16)
    before = dict(ck.LAUNCHES)
    with pinned("allreduce_algorithm", 7):
        out = tw.allreduce(x, top.SUM)
    np.testing.assert_allclose(out[0], x.sum(0), rtol=1e-5, atol=1e-5 * np.abs(x).max())
    assert ck.LAUNCHES == before


def test_jagged_host_collectives(worlds):
    jw, tw = worlds
    rng = np.random.RandomState(17)
    blocks = [rng.randn(r + 1).astype(np.float32) for r in range(N)]
    for name in ("allgatherv", "gatherv", "scatterv"):
        got, want = getattr(tw, name)(blocks), getattr(jw, name)(blocks)
        assert len(got) == len(want) == N
        for g, w in zip(got, want):
            same(g, w)
    matrix = [[rng.randn((r + j) % 3).astype(np.float32) for j in range(N)] for r in range(N)]
    got, want = tw.alltoallv(matrix), jw.alltoallv(matrix)
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            same(g, w)
    with pytest.raises(MPIArgError):
        tw.allgatherv(blocks[:3])


def test_group_algebra_matches_reference():
    from ompi_tpu.api.group import Group as JGroup
    from ompi_tpu_torch.api.group import Group as TGroup

    a, b = [5, 1, 4, 0, 7], [4, 2, 5, 6]
    ja, jb, ta, tb = JGroup(a), JGroup(b), TGroup(a), TGroup(b)
    for op in ("union", "intersection", "difference"):
        assert getattr(ta, op)(tb).ranks == getattr(ja, op)(jb).ranks
    assert ta.incl([3, 0]).ranks == ja.incl([3, 0]).ranks
    assert ta.excl([1]).ranks == ja.excl([1]).ranks
    assert ta.range_incl([(0, 4, 2)]).ranks == ja.range_incl([(0, 4, 2)]).ranks
    assert ta.translate_ranks([0, 2], tb) == ja.translate_ranks([0, 2], jb)
    assert ta.compare(TGroup(a[::-1])) == ja.compare(JGroup(a[::-1]))


def test_barrier_token_comes_from_the_arena_pool(worlds):
    _, tw = worlds
    arena = tw.mesh.arena
    tw.barrier()
    hits = arena.pool_hits
    tw.barrier()
    tw.ibarrier().wait()
    assert arena.pool_hits == hits + 2
