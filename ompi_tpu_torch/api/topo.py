"""Process topologies — cartesian and graph communicators.

Port of ``ompi_tpu/api/topo.py`` (≈ ``ompi/mca/topo/basic`` and the
``MPI_Cart_*`` / ``MPI_Graph_*`` surface with ``MPI_Dims_create``).  A
cartesian topology maps ranks onto a grid in row-major order; the
``reorder`` flag is accepted and keeps the identity, which already
places the fastest-varying dimension's neighbours on adjacent rows of
the communicator's rank-major tensors.
"""

from __future__ import annotations

import math
from typing import Sequence

from ompi_tpu_torch.core.errors import MPIArgError, MPIDimsError, MPITopologyError
from ompi_tpu_torch.p2p.pml import PROC_NULL

from .comm import Comm
from .group import Group


def dims_create(nnodes: int, ndims: int, dims: Sequence[int] | None = None) -> list[int]:
    """MPI_Dims_create: balanced factorization of nnodes over ndims,
    honoring fixed (non-zero) entries; the free slots are sorted
    non-increasing, per the standard."""
    out = list(dims) if dims is not None else [0] * ndims
    if len(out) != ndims:
        raise MPIDimsError("dims length != ndims")
    fixed = 1
    free_idx = [i for i, d in enumerate(out) if d == 0]
    for d in out:
        if d < 0:
            raise MPIDimsError(f"negative dim {d}")
        if d > 0:
            fixed *= d
    if fixed == 0:
        raise MPIDimsError("zero fixed dims product")
    if nnodes % fixed:
        raise MPIDimsError(f"nnodes {nnodes} not divisible by fixed dims {fixed}")
    rem = nnodes // fixed
    if not free_idx:
        if rem != 1:
            raise MPIDimsError("dims product != nnodes")
        return out
    # factor rem into len(free_idx) balanced factors: prime factors,
    # largest first, each into the currently smallest bucket
    factors = [1] * len(free_idx)
    primes = []
    x, p = rem, 2
    while p * p <= x:
        while x % p == 0:
            primes.append(p)
            x //= p
        p += 1
    if x > 1:
        primes.append(x)
    for prime in sorted(primes, reverse=True):
        factors.sort()
        factors[0] *= prime
    factors.sort(reverse=True)
    for i, f in zip(free_idx, factors):
        out[i] = f
    return out


def cart_rank_of(dims: Sequence[int], periods: Sequence[int], coords: Sequence[int]) -> int:
    """Row-major rank of ``coords`` (periodic wrap per dim); raises for
    out-of-range coordinates on non-periodic dims."""
    if len(coords) != len(dims):
        raise MPIArgError("coords length != ndims")
    rank = 0
    for c, d, per in zip(coords, dims, periods):
        if per:
            c = c % d
        elif not 0 <= c < d:
            raise MPIArgError(f"coordinate {c} out of [0,{d}) (non-periodic)")
        rank = rank * d + c
    return rank


def cart_coords_of(dims: Sequence[int], rank: int) -> list[int]:
    """Row-major coordinates of ``rank``; validates the range."""
    n = math.prod(dims)
    if not 0 <= rank < n:
        raise MPIArgError(f"rank {rank} out of range [0, {n})")
    coords = []
    for d in reversed(dims):
        coords.append(rank % d)
        rank //= d
    return coords[::-1]


def validate_dims(dims: Sequence[int]) -> None:
    for d in dims:
        if d < 1:
            raise MPIDimsError(f"non-positive cartesian dim {d}")


class CartComm(Comm):
    """Cartesian communicator (MPI_Cart_create result)."""

    def __init__(self, parent: Comm, dims: Sequence[int],
                 periods: Sequence[int | bool], reorder: bool = False):
        dims = [int(d) for d in dims]
        if any(d <= 0 for d in dims):
            raise MPIDimsError(f"non-positive dim in {dims}")
        size = math.prod(dims)
        if size > parent.size:
            raise MPITopologyError(
                f"cart grid {dims} needs {size} ranks; comm has {parent.size}")
        if len(periods) != len(dims):
            raise MPIArgError("periods length != dims length")
        ranks = list(range(size))
        group = Group([parent.group.ranks[r] for r in ranks])
        super().__init__(group, parent.mesh.submesh(ranks),
                         name=f"{parent.name}.cart{tuple(dims)}")
        self.dims = tuple(dims)
        self.periods = tuple(bool(p) for p in periods)

    @property
    def ndims(self) -> int:
        return len(self.dims)

    # -- coordinate algebra (MPI_Cart_rank / Cart_coords) ----------------

    def cart_rank(self, coords: Sequence[int]) -> int:
        return cart_rank_of(self.dims, self.periods, coords)

    def cart_coords(self, rank: int) -> list[int]:
        return cart_coords_of(self.dims, rank)

    def cart_shift(self, direction: int, disp: int, rank: int) -> tuple[int, int]:
        """MPI_Cart_shift at ``rank``: returns (source, dest); PROC_NULL
        across non-periodic edges."""
        if not 0 <= direction < self.ndims:
            raise MPIArgError(f"direction {direction} out of range")
        coords = self.cart_coords(rank)

        def shifted(sign: int) -> int:
            c = list(coords)
            c[direction] += sign * disp
            d = self.dims[direction]
            if self.periods[direction]:
                c[direction] %= d
            elif not 0 <= c[direction] < d:
                return PROC_NULL
            return self.cart_rank(c)

        return shifted(-1), shifted(+1)

    def cart_sub(self, remain_dims: Sequence[bool]) -> list["CartComm"]:
        """MPI_Cart_sub: split into sub-grids keeping the remain_dims
        axes; returns per-rank sub-communicators (shared objects)."""
        if len(remain_dims) != self.ndims:
            raise MPIArgError("remain_dims length != ndims")
        keep = [i for i, k in enumerate(remain_dims) if k]
        drop = [i for i, k in enumerate(remain_dims) if not k]
        colors = []
        for r in range(self.size):
            c = self.cart_coords(r)
            colors.append(sum(c[i] * math.prod([self.dims[j] for j in drop[k + 1:]])
                              for k, i in enumerate(drop)) if drop else 0)
        sub_by_rank = self.split(colors)
        out = []
        for r, sub in enumerate(sub_by_rank):
            if sub is None:
                out.append(None)
                continue
            if not isinstance(sub, CartComm):
                cart = CartComm.__new__(CartComm)
                cart.__dict__.update(sub.__dict__)
                cart.dims = tuple(self.dims[i] for i in keep) or (1,)
                cart.periods = tuple(self.periods[i] for i in keep) or (False,)
                out.append(cart)
                # share the converted object among the members
                for r2 in range(r + 1, self.size):
                    if sub_by_rank[r2] is sub:
                        sub_by_rank[r2] = cart
            else:
                out.append(sub)
        return out


def graph_neighbors_of(index: Sequence[int], edges: Sequence[int], rank: int) -> list[int]:
    """Neighbors of ``rank`` in the (index, edges) CSR graph."""
    if not 0 <= rank < len(index):
        raise MPIArgError(f"rank {rank} out of graph range")
    lo = index[rank - 1] if rank else 0
    return list(edges[lo:index[rank]])


def validate_graph(index: Sequence[int], edges: Sequence[int]) -> None:
    """MPI_Graph_create argument checks: monotone non-negative index,
    edge targets inside the node set."""
    prev = 0
    for i in index:
        if i < prev:
            raise MPIArgError(
                f"graph index must be non-decreasing and >= 0; got {list(index)}")
        prev = i
    if index and index[-1] != len(edges):
        raise MPIArgError(f"graph index[-1] ({index[-1]}) != edge count ({len(edges)})")
    for e in edges:
        if not 0 <= e < len(index):
            raise MPITopologyError(f"edge target {e} out of range")


class GraphComm(Comm):
    """Graph topology communicator (MPI_Graph_create)."""

    def __init__(self, parent: Comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False):
        nnodes = len(index)
        if nnodes > parent.size:
            raise MPITopologyError("graph larger than communicator")
        group = Group([parent.group.ranks[r] for r in range(nnodes)])
        super().__init__(group, parent.mesh.submesh(range(nnodes)), name=f"{parent.name}.graph")
        self.index = tuple(index)
        self.edges = tuple(edges)

    def graph_neighbors(self, rank: int) -> list[int]:
        return graph_neighbors_of(self.index, self.edges, rank)

    def graph_neighbors_count(self, rank: int) -> int:
        return len(self.graph_neighbors(rank))
