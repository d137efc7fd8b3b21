"""``coll/cuda`` — the device collective component.

Port of ``ompi_tpu/coll/xla.py``.  Every collective resolves, once per
(op, algorithm, shape, dtype, …), to a callable over the communicator's
rank-major tensor, and the callable is cached per module — the
counterpart of the reference's jitted ``shard_map`` programs; re-dispatch
is one dict hit.

* The **algorithm enums** are the reference's, number for number, as
  MCA vars ``coll_cuda_<coll>_algorithm``; the reference's
  ``pallas_ring`` slot is named ``cuda_ring`` here (allreduce 7,
  allgather 4, reduce_scatter 4) and runs the hand-written ring-hop
  kernels of :mod:`.cuda_kernels`.
* ``auto`` applies the reference's module default: the fused rank-axis
  reduction (``psum``/``direct``: one torch reduction over the rank
  axis, broadcast back) when the op has one, the ordered fold otherwise.
  It governs only where ``coll/tuned`` is excluded: tuned stacks above
  this module and forces its per-call choice through :meth:`forced`.
* The fallback rules are the reference's: psum → ring for ops without a
  fused reduction, Rabenseifner with non-power-of-two n → ring,
  non-commutative ``cuda_ring`` → ordered, jagged ``reduce_scatter`` →
  ``coll/basic``.
* ``--mca coll_cuda_reproducible 1`` forces the bit-exact rank-ordered
  paths.
* i-variants return :class:`ArrayRequest` (a CUDA event on the current
  stream of every card the result lies on); ``*_init`` variants return
  :class:`PersistentRequest`.
* On a communicator whose mesh has the ``devices`` layout (one buffer
  per rank, :class:`~ompi_tpu_torch.mesh.shards.RankShards`), every
  collective runs in its blocking, i and init forms with every algorithm
  of its enum, chosen by the same rules: the algorithm runs over the
  ranks' own buffers (:mod:`.base_shards`, the reference's per-device
  functions run per rank), ``cuda_ring``, ``psum`` and reduce_scatter
  ``direct`` as the shard ring schedules of :mod:`.cuda_kernels` over
  the cross-device hop.  Each rank's result is made on its own device;
  nothing is gathered onto one device instead (only a root gather puts
  every block on root's, as MPI_Gather does).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

import torch

from ompi_tpu_torch.core.errors import MPIInternalError
from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op.op import Op, fused_reduce
from ompi_tpu_torch.request import (
    ArrayRequest,
    CompletedRequest,
    PersistentRequest,
    Request,
    block_until_ready,
)

from . import base as algos
from . import base_shards as shard_algos
from . import cuda_kernels as ck
from .module import CollModule

ALLREDUCE_ALGOS = {
    "auto": 0,
    "psum": 1,
    "ring": 2,
    "ring_segmented": 3,
    "recursive_doubling": 4,
    "rabenseifner": 5,
    "ordered_linear": 6,
    "cuda_ring": 7,
}
BCAST_ALGOS = {"auto": 0, "direct": 1, "binomial": 2, "pipeline": 3}
ALLGATHER_ALGOS = {"auto": 0, "direct": 1, "ring": 2, "bruck": 3, "cuda_ring": 4}
ALLTOALL_ALGOS = {"auto": 0, "direct": 1, "pairwise": 2}
REDUCE_SCATTER_ALGOS = {"auto": 0, "direct": 1, "ring": 2, "ordered": 3,
                        "cuda_ring": 4}
REDUCE_ALGOS = {"auto": 0, "binomial": 1, "ordered": 2}
BARRIER_ALGOS = {"auto": 0, "allreduce": 1, "dissemination": 2}


def _named(coll: str, enum: dict[str, int], algo: int) -> str:
    """``<coll>_<algorithm name>``, the name of a compile event."""
    return coll + "_" + next(k for k, v in enum.items() if v == algo)


class DevicesLayoutUnsupported(MPIInternalError):
    """A call that does not run on the ``devices`` layout yet: a job of
    several processes (``tpurun``), and what rides on one (han, the DCN
    windows, shmem's heap, the C ABI).  Every single-process call does."""


def unsupported_on_devices(what: str):
    raise DevicesLayoutUnsupported(
        f"{what} does not run on the devices layout yet: jobs of several processes "
        "(tpurun) and what rides on them (han, the DCN windows, shmem, the C ABI) do "
        "not; every call of a single-process comm does")


class CudaCollModule(CollModule):
    """Per-communicator module: resolved-callable cache over the mesh."""

    def __init__(self, comm, component: "CudaCollComponent"):
        super().__init__(comm)
        self.component = component
        self._cache: dict[tuple, Callable] = {}
        #: per-call var overrides installed by a decision layer (the
        #: coll/tuned module forces its chosen algorithm through here)
        self._forced: dict[str, int] = {}
        #: the devices layout's barrier token (see :meth:`_token`)
        self._shard_token: RankShards | None = None

    @contextmanager
    def forced(self, **overrides):
        """Temporarily force algorithm/segcount vars (tuned's decision);
        nests, and restores the previous overrides on exception."""
        prev = self._forced
        self._forced = {k: v for k, v in overrides.items() if v is not None}
        try:
            yield
        finally:
            self._forced = prev

    def _compiled(self, key: tuple, builder: Callable[[], Callable],
                  algorithm: str) -> Callable:
        fn = self._cache.get(key)
        if fn is None:
            if len(self._cache) > 4096:  # user-op churn backstop
                self._cache.clear()
            algos.compile_event(algorithm, self._n())
            fn = builder()
            self._cache[key] = fn
        return fn

    def _n(self) -> int:
        return self.comm.size

    def _on_devices(self) -> bool:
        return self.comm.mesh.layout == "devices"

    def _on_shards(self, key: tuple, name: str, build: Callable[[], Callable]):
        """The devices layout's cached callable: ``build()`` gives the
        function that maps the ranks' tensors to one result per rank (a
        ``RankShards``), or to root's one tensor."""

        def make():
            run = build()

            def fn(v):
                out = run(list(v.shards))
                return RankShards(out) if isinstance(out, list) else out

            return fn

        return self._compiled(key, make, name)

    def _ring(self):
        """The mesh's :class:`~.cuda_kernels.PeerRing` where the shard
        rings launch the peer kernels (CUDA shards), else None (their
        plain form: CPU shards, or ``dcn_device_interpret``)."""
        mesh = self.comm.mesh
        return ck.peer_ring(mesh) if ck._shard_mode(mesh.device, None) == "cuda" else None

    def _algo(self, var: str, enum: dict[str, int]) -> int:
        if var in self._forced:
            return int(self._forced[var])
        return int(self.component.store.get(f"coll_cuda_{var}", enum["auto"]))

    def _reproducible(self) -> bool:
        return bool(self.component.store.get("coll_cuda_reproducible", False))

    def _segcount(self) -> int:
        if "segcount" in self._forced:
            return int(self._forced["segcount"])
        return int(self.component.store.get("coll_cuda_segcount", 1 << 16))

    # -- fast-path resolution ------------------------------------------

    def resolve(self, base: str, *args):
        """The cached tensor → tensor callable for a call signature (the
        same positional arguments the blocking entry point takes)."""
        if base == "allreduce":
            return self._allreduce_fn(args[0], args[1])
        if base == "bcast":
            return self._bcast_fn(args[0], args[1] if len(args) > 1 else 0)
        if base == "reduce":
            return self._reduce_fn(args[0], args[1], args[2] if len(args) > 2 else 0)
        if base == "allgather":
            return self._allgather_fn(args[0])
        if base == "gather":
            return self._copy_fn(args[0], "gather", args[1] if len(args) > 1 else 0)
        if base == "scatter":
            return self._copy_fn(args[0], "scatter", args[1] if len(args) > 1 else 0)
        if base == "reduce_scatter_block":
            return self._reduce_scatter_block_fn(args[0], args[1])
        if base == "alltoall":
            return self._alltoall_fn(args[0])
        if base == "scan":
            return self._scan_fn(args[0], args[1], False)
        if base == "exscan":
            return self._scan_fn(args[0], args[1], True)
        return None

    # ==================================================================
    # allreduce
    # ==================================================================

    def _allreduce_fn(self, x, op: Op):
        algo = self._algo("allreduce_algorithm", ALLREDUCE_ALGOS)
        if self._reproducible():
            algo = ALLREDUCE_ALGOS["ordered_linear"]
        if algo == ALLREDUCE_ALGOS["auto"]:
            if op.collective is not None and op.commutative:
                algo = ALLREDUCE_ALGOS["psum"]
            else:
                algo = ALLREDUCE_ALGOS["ordered_linear"]
        if algo == ALLREDUCE_ALGOS["psum"] and op.collective is None:
            algo = ALLREDUCE_ALGOS["ring"]
        n = self._n()
        if algo == ALLREDUCE_ALGOS["rabenseifner"] and (n & (n - 1)):
            algo = ALLREDUCE_ALGOS["ring"]
        if algo == ALLREDUCE_ALGOS["cuda_ring"] and not op.commutative:
            # ring chain order != rank order: promote like the other rings
            algo = ALLREDUCE_ALGOS["ordered_linear"]
        seg = self._segcount()
        # op keyed by identity: two user ops may share a name
        key = ("allreduce", algo, tuple(x.shape), x.dtype, op, seg)
        name = _named("allreduce", ALLREDUCE_ALGOS, algo)
        if self._on_devices():
            sa = shard_algos
            return self._on_shards(key, name, lambda: {
                ALLREDUCE_ALGOS["psum"]: lambda xs: sa.allreduce_psum(xs, op, self._ring()),
                ALLREDUCE_ALGOS["ring"]: lambda xs: sa.allreduce_ring(xs, op),
                ALLREDUCE_ALGOS["ring_segmented"]:
                    lambda xs: sa.allreduce_ring_segmented(xs, op, seg),
                ALLREDUCE_ALGOS["recursive_doubling"]:
                    lambda xs: sa.allreduce_recursive_doubling(xs, op),
                ALLREDUCE_ALGOS["rabenseifner"]: lambda xs: sa.allreduce_rabenseifner(xs, op),
                ALLREDUCE_ALGOS["ordered_linear"]:
                    lambda xs: sa.allreduce_ordered_linear(xs, op),
                ALLREDUCE_ALGOS["cuda_ring"]:
                    lambda xs: ck.ring_allreduce_shards(xs, op, self._ring()),
            }[algo])

        def build():
            return {
                ALLREDUCE_ALGOS["psum"]: lambda v: algos.allreduce_psum(v, op),
                ALLREDUCE_ALGOS["ring"]: lambda v: algos.allreduce_ring(v, op),
                ALLREDUCE_ALGOS["ring_segmented"]:
                    lambda v: algos.allreduce_ring_segmented(v, op, seg),
                ALLREDUCE_ALGOS["recursive_doubling"]:
                    lambda v: algos.allreduce_recursive_doubling(v, op),
                ALLREDUCE_ALGOS["rabenseifner"]:
                    lambda v: algos.allreduce_rabenseifner(v, op),
                ALLREDUCE_ALGOS["ordered_linear"]:
                    lambda v: algos.allreduce_ordered_linear(v, op),
                ALLREDUCE_ALGOS["cuda_ring"]: lambda v: ck.ring_allreduce(v, op),
            }[algo]

        return self._compiled(key, build, name)

    def allreduce(self, x, op: Op):
        return self._allreduce_fn(x, op)(x)

    def iallreduce(self, x, op: Op) -> Request:
        return ArrayRequest(self._allreduce_fn(x, op)(x))

    def allreduce_init(self, x, op: Op) -> PersistentRequest:
        fn = self._allreduce_fn(x, op)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # ==================================================================
    # bcast / reduce
    # ==================================================================

    def _bcast_fn(self, x, root: int):
        algo = self._algo("bcast_algorithm", BCAST_ALGOS)
        if algo == BCAST_ALGOS["auto"]:
            algo = BCAST_ALGOS["direct"]
        seg = self._segcount()
        key = ("bcast", algo, tuple(x.shape), x.dtype, root, seg)
        if self._on_devices():
            return self._on_shards(key, _named("bcast", BCAST_ALGOS, algo), lambda: {
                BCAST_ALGOS["direct"]: lambda xs: shard_algos.bcast_direct(xs, root),
                BCAST_ALGOS["binomial"]: lambda xs: shard_algos.bcast_binomial(xs, root),
                BCAST_ALGOS["pipeline"]:
                    lambda xs: shard_algos.bcast_pipeline(xs, root, seg),
            }[algo])

        def build():
            return {
                BCAST_ALGOS["direct"]: lambda v: algos.bcast_direct(v, root),
                BCAST_ALGOS["binomial"]: lambda v: algos.bcast_binomial(v, root),
                BCAST_ALGOS["pipeline"]:
                    lambda v: algos.bcast_pipeline(v, root, seg),
            }[algo]

        return self._compiled(key, build, _named("bcast", BCAST_ALGOS, algo))

    def bcast(self, x, root: int = 0):
        return self._bcast_fn(x, root)(x)

    def ibcast(self, x, root: int = 0) -> Request:
        return ArrayRequest(self._bcast_fn(x, root)(x))

    def bcast_init(self, x, root: int = 0) -> PersistentRequest:
        fn = self._bcast_fn(x, root)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    def _reduce_fn(self, x, op: Op, root: int):
        algo = self._algo("reduce_algorithm", REDUCE_ALGOS)
        if self._reproducible():
            algo = REDUCE_ALGOS["ordered"]
        if algo == REDUCE_ALGOS["auto"]:
            algo = (REDUCE_ALGOS["binomial"] if op.commutative
                    else REDUCE_ALGOS["ordered"])
        key = ("reduce", algo, tuple(x.shape), x.dtype, op, root)
        if self._on_devices():
            return self._on_shards(key, _named("reduce", REDUCE_ALGOS, algo), lambda: {
                REDUCE_ALGOS["binomial"]: lambda xs: shard_algos.reduce_binomial(xs, op, root),
                REDUCE_ALGOS["ordered"]: lambda xs: shard_algos.reduce_ordered(xs, op, root),
            }[algo])

        def build():
            return {
                REDUCE_ALGOS["binomial"]: lambda v: algos.reduce_binomial(v, op, root),
                REDUCE_ALGOS["ordered"]: lambda v: algos.reduce_ordered(v, op, root),
            }[algo]

        return self._compiled(key, build, _named("reduce", REDUCE_ALGOS, algo))

    def reduce(self, x, op: Op, root: int = 0):
        return self._reduce_fn(x, op, root)(x)

    def ireduce(self, x, op: Op, root: int = 0) -> Request:
        return ArrayRequest(self._reduce_fn(x, op, root)(x))

    def reduce_init(self, x, op: Op, root: int = 0) -> PersistentRequest:
        fn = self._reduce_fn(x, op, root)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # ==================================================================
    # allgather / gather / scatter
    # ==================================================================

    def _allgather_fn(self, x):
        algo = self._algo("allgather_algorithm", ALLGATHER_ALGOS)
        if algo == ALLGATHER_ALGOS["auto"]:
            algo = ALLGATHER_ALGOS["direct"]
        key = ("allgather", algo, tuple(x.shape), x.dtype)
        if self._on_devices():
            return self._on_shards(key, _named("allgather", ALLGATHER_ALGOS, algo), lambda: {
                ALLGATHER_ALGOS["direct"]: shard_algos.allgather_direct,
                ALLGATHER_ALGOS["ring"]: shard_algos.allgather_ring,
                ALLGATHER_ALGOS["bruck"]: shard_algos.allgather_bruck,
                ALLGATHER_ALGOS["cuda_ring"]:
                    lambda xs: ck.ring_allgather_shards(xs, self._ring()),
            }[algo])

        def build():
            return {
                ALLGATHER_ALGOS["direct"]: algos.allgather_direct,
                ALLGATHER_ALGOS["ring"]: algos.allgather_ring,
                ALLGATHER_ALGOS["bruck"]: algos.allgather_bruck,
                ALLGATHER_ALGOS["cuda_ring"]: ck.ring_allgather,
            }[algo]

        return self._compiled(key, build, _named("allgather", ALLGATHER_ALGOS, algo))

    def allgather(self, x):
        """(n, *s) → (n, n, *s): out[r, j] is rank j's contribution."""
        return self._allgather_fn(x)(x)

    def iallgather(self, x) -> Request:
        return ArrayRequest(self._allgather_fn(x)(x))

    def allgather_init(self, x) -> PersistentRequest:
        fn = self._allgather_fn(x)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    def _copy_fn(self, x, kind: str, root: int):
        """Root gather and scatter.  With every rank a row of one tensor on
        one device, the rank-major buffer already IS root's gathered
        recvbuf (gather) and every rank's row (scatter) — the collective
        is a copy into a fresh buffer (MPI keeps sendbuf and recvbuf
        apart).  On the devices layout a gather moves every rank's block
        onto root's device, and a scatter gives each rank its row as a
        buffer of its own on its device."""
        if self._on_devices():
            return self._on_shards(
                (kind, tuple(x.shape), x.dtype, root), f"{kind}_copy",
                lambda: ((lambda xs: shard_algos.gather(xs, root)) if kind == "gather"
                         else shard_algos.scatter))
        return self._compiled((kind, tuple(x.shape), x.dtype),
                              lambda: torch.clone, f"{kind}_copy")

    def gather(self, x, root: int = 0):
        return self._copy_fn(x, "gather", root)(x)

    def igather(self, x, root: int = 0) -> Request:
        return ArrayRequest(self.gather(x, root))

    def gather_init(self, x, root: int = 0) -> PersistentRequest:
        fn = self._copy_fn(x, "gather", root)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    def scatter(self, x, root: int = 0):
        return self._copy_fn(x, "scatter", root)(x)

    def iscatter(self, x, root: int = 0) -> Request:
        return ArrayRequest(self.scatter(x, root))

    def scatter_init(self, x, root: int = 0) -> PersistentRequest:
        fn = self._copy_fn(x, "scatter", root)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # ==================================================================
    # reduce_scatter_block / reduce_scatter
    # ==================================================================

    def _reduce_scatter_block_fn(self, x, op: Op):
        algo = self._algo("reduce_scatter_algorithm", REDUCE_SCATTER_ALGOS)
        if self._reproducible():
            algo = REDUCE_SCATTER_ALGOS["ordered"]
        if algo == REDUCE_SCATTER_ALGOS["auto"]:
            if op.collective == "sum":
                algo = REDUCE_SCATTER_ALGOS["direct"]
            elif op.commutative:
                algo = REDUCE_SCATTER_ALGOS["ring"]
            else:
                algo = REDUCE_SCATTER_ALGOS["ordered"]
        if algo == REDUCE_SCATTER_ALGOS["direct"] and op.collective != "sum":
            algo = REDUCE_SCATTER_ALGOS["ring"]
        if algo in (REDUCE_SCATTER_ALGOS["ring"], REDUCE_SCATTER_ALGOS["cuda_ring"]) \
                and not op.commutative:
            # ring chain order starts at (b+1)%n — wrong for
            # non-commutative ops; promote to the rank-ordered path
            algo = REDUCE_SCATTER_ALGOS["ordered"]
        key = ("reduce_scatter_block", algo, tuple(x.shape), x.dtype, op)
        name = _named("reduce_scatter", REDUCE_SCATTER_ALGOS, algo)
        if self._on_devices():
            sa = shard_algos
            return self._on_shards(key, name, lambda: {
                REDUCE_SCATTER_ALGOS["direct"]:
                    lambda xs: sa.reduce_scatter_direct(xs, op, self._ring()),
                REDUCE_SCATTER_ALGOS["ring"]: lambda xs: sa.reduce_scatter_ring(xs, op),
                REDUCE_SCATTER_ALGOS["ordered"]: lambda xs: sa.reduce_scatter_ordered(xs, op),
                REDUCE_SCATTER_ALGOS["cuda_ring"]:
                    lambda xs: ck.ring_reduce_scatter_shards(xs, op, self._ring()),
            }[algo])

        def build():
            return {
                REDUCE_SCATTER_ALGOS["direct"]: lambda v: fused_reduce(v, op),
                REDUCE_SCATTER_ALGOS["ring"]:
                    lambda v: algos.reduce_scatter_ring(v, op),
                REDUCE_SCATTER_ALGOS["ordered"]:
                    lambda v: algos.reduce_scatter_ordered(v, op),
                REDUCE_SCATTER_ALGOS["cuda_ring"]:
                    lambda v: ck.ring_reduce_scatter(v, op),
            }[algo]

        return self._compiled(key, build, name)

    def reduce_scatter_block(self, x, op: Op):
        """x: (n, n, *s), x[r, j] rank r's part for rank j → (n, *s)."""
        return self._reduce_scatter_block_fn(x, op)(x)

    def ireduce_scatter_block(self, x, op: Op) -> Request:
        return ArrayRequest(self.reduce_scatter_block(x, op))

    def reduce_scatter_block_init(self, x, op: Op) -> PersistentRequest:
        fn = self._reduce_scatter_block_fn(x, op)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # MPI_Reduce_scatter: equal counts arrive pre-blocked from the API
    # layer; jagged counts fall back to the host path (coll/basic)
    def _host_fallback(self):
        from .basic import BasicCollModule

        for m in self.comm.coll.modules:
            if isinstance(m, BasicCollModule):
                return m
        return BasicCollModule(self.comm)

    def reduce_scatter(self, x, op: Op, counts=None):
        if counts is not None and len(set(counts)) != 1:
            return self._host_fallback().reduce_scatter(x, op, counts)
        return self.reduce_scatter_block(x, op)

    def ireduce_scatter(self, x, op: Op, counts=None) -> Request:
        if counts is not None and len(set(counts)) != 1:
            return CompletedRequest(self.reduce_scatter(x, op, counts))
        return ArrayRequest(self.reduce_scatter(x, op, counts))

    def reduce_scatter_init(self, x, op: Op, counts=None) -> PersistentRequest:
        if counts is not None and len(set(counts)) != 1:
            return PersistentRequest(lambda: self.ireduce_scatter(x, op, counts))
        fn = self._reduce_scatter_block_fn(x, op)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # ==================================================================
    # alltoall
    # ==================================================================

    def _alltoall_fn(self, x):
        algo = self._algo("alltoall_algorithm", ALLTOALL_ALGOS)
        if algo == ALLTOALL_ALGOS["auto"]:
            algo = ALLTOALL_ALGOS["direct"]
        key = ("alltoall", algo, tuple(x.shape), x.dtype)
        if self._on_devices():
            return self._on_shards(key, _named("alltoall", ALLTOALL_ALGOS, algo), lambda: {
                ALLTOALL_ALGOS["direct"]: shard_algos.alltoall_direct,
                ALLTOALL_ALGOS["pairwise"]: shard_algos.alltoall_pairwise,
            }[algo])
        return self._compiled(key, lambda: {
            ALLTOALL_ALGOS["direct"]: algos.alltoall_direct,
            ALLTOALL_ALGOS["pairwise"]: algos.alltoall_pairwise,
        }[algo], _named("alltoall", ALLTOALL_ALGOS, algo))

    def alltoall(self, x):
        """x: (n, n, *s), x[r, j] from rank r to rank j → out[j, r]."""
        return self._alltoall_fn(x)(x)

    def ialltoall(self, x) -> Request:
        return ArrayRequest(self.alltoall(x))

    def alltoall_init(self, x) -> PersistentRequest:
        fn = self._alltoall_fn(x)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    # ==================================================================
    # barrier
    # ==================================================================

    def _barrier_fn(self):
        n = self._n()
        algo = self._algo("barrier_algorithm", BARRIER_ALGOS)
        if algo == BARRIER_ALGOS["auto"]:
            algo = BARRIER_ALGOS["allreduce"]
        name = _named("barrier", BARRIER_ALGOS, algo)
        if self._on_devices():
            return self._on_shards(("barrier", algo), name,
                                   lambda: shard_algos.barrier_allreduce
                                   if algo == BARRIER_ALGOS["allreduce"]
                                   else shard_algos.barrier_dissemination)
        impl = (algos.barrier_allreduce if algo == BARRIER_ALGOS["allreduce"]
                else algos.barrier_dissemination)
        # the program reads the token, so its completion orders after it
        return self._compiled(("barrier", algo),
                              lambda: lambda tok: impl(n, tok.device) + 0 * tok, name)

    def _token(self):
        """The barrier's token: on the rows layout pooled from the mesh
        arena (a pool hit after the first barrier on a comm); on the
        devices layout one ``int32`` per rank on its own device, made once
        per comm (the barrier only reads it).  Returns (token, its
        release)."""
        mesh = self.comm.mesh
        if self._on_devices():
            if self._shard_token is None:
                self._shard_token = RankShards.full(mesh.devices, 0)
            return self._shard_token, lambda: None
        tok = mesh.arena.acquire((self._n(),), torch.int32, mesh.device)
        return tok, lambda: mesh.arena.release(tok)

    def barrier(self):
        tok, release = self._token()
        try:
            block_until_ready(self._barrier_fn()(tok))
        finally:
            release()

    def ibarrier(self) -> Request:
        tok, release = self._token()

        def _done(out):
            release()
            return out

        return ArrayRequest(self._barrier_fn()(tok), finalize=_done)

    def barrier_init(self) -> PersistentRequest:
        fn = self._barrier_fn()
        mesh = self.comm.mesh
        tok = (RankShards.full(mesh.devices, 0) if self._on_devices()
               else torch.zeros(self._n(), dtype=torch.int32, device=mesh.device))
        return PersistentRequest(lambda: ArrayRequest(fn(tok)))

    # ==================================================================
    # scan / exscan
    # ==================================================================

    def _scan_fn(self, x, op: Op, exclusive: bool):
        key = ("scan", exclusive, tuple(x.shape), x.dtype, op)
        name = "exscan_ordered" if exclusive else "scan_ordered"
        if self._on_devices():
            return self._on_shards(key, name, lambda: lambda xs: shard_algos.scan_ordered(
                xs, op, exclusive))
        return self._compiled(
            key, lambda: lambda v: algos.scan_ordered(v, op, exclusive), name)

    def scan(self, x, op: Op):
        return self._scan_fn(x, op, False)(x)

    def iscan(self, x, op: Op) -> Request:
        return ArrayRequest(self.scan(x, op))

    def scan_init(self, x, op: Op) -> PersistentRequest:
        fn = self._scan_fn(x, op, False)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))

    def exscan(self, x, op: Op):
        return self._scan_fn(x, op, True)(x)

    def iexscan(self, x, op: Op) -> Request:
        return ArrayRequest(self.exscan(x, op))

    def exscan_init(self, x, op: Op) -> PersistentRequest:
        fn = self._scan_fn(x, op, True)
        return PersistentRequest(lambda: ArrayRequest(fn(x)))


@register_component
class CudaCollComponent(Component):
    """``coll/cuda`` MCA component (peer of the reference's coll/xla)."""

    FRAMEWORK = "coll"
    NAME = "cuda"
    PRIORITY = 90  # above basic (10)

    def __init__(self):
        super().__init__()
        self.store = None

    def register_params(self, store) -> None:
        super().register_params(store)
        self.store = store
        for name, enum, help_ in (
            ("allreduce_algorithm", ALLREDUCE_ALGOS,
             "Allreduce algorithm (auto: psum for ops with a fused "
             "reduction, ordered_linear otherwise; cuda_ring: the ring-hop "
             "kernels)"),
            ("bcast_algorithm", BCAST_ALGOS, "Bcast algorithm"),
            ("allgather_algorithm", ALLGATHER_ALGOS, "Allgather algorithm"),
            ("alltoall_algorithm", ALLTOALL_ALGOS, "Alltoall algorithm"),
            ("reduce_scatter_algorithm", REDUCE_SCATTER_ALGOS,
             "Reduce_scatter algorithm"),
            ("reduce_algorithm", REDUCE_ALGOS, "Reduce algorithm"),
            ("barrier_algorithm", BARRIER_ALGOS, "Barrier algorithm"),
        ):
            store.register("coll", "cuda", name, 0, type="int", enum=enum, help=help_)
        store.register(
            "coll", "cuda", "reproducible", False,
            help="Force bit-exact rank-ordered reductions "
            "(≈ coll_han reproducible mode)",
        )
        store.register(
            "coll", "cuda", "segcount", 1 << 16, type="int",
            help="Segment element count for segmented/pipelined algorithms",
        )

    def query(self, comm) -> CudaCollModule | None:
        # serve single-process communicators; multi-process comms are
        # han's (remote ranks are not rows of this process's tensors)
        if getattr(comm, "dcn", None) is not None:
            return None
        return CudaCollModule(comm, self)
