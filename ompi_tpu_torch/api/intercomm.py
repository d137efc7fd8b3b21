"""Intercommunicators — two disjoint groups communicating.

Port of ``ompi_tpu/api/intercomm.py`` (≈ ``ompi/communicator/
intercomm_create`` + the coll/inter component).  Single-controller
form: one Python process drives BOTH groups, so an ``Intercomm`` holds
the two intra-communicators and its API takes/returns a rank-major
buffer per side (numpy in → numpy out, a tensor in → a tensor out on
the same device).  MPI intercomm collective semantics are preserved:

* ``allreduce(xa, xb)``: group A receives the reduction of group B's
  contributions and vice versa (the standard's crossed delivery);
* ``bcast``: the root's row lands on every rank of the OTHER group;
* ``allgather``: each group receives the other group's blocks;
* ``merge``: MPI_Intercomm_merge → an intracommunicator over the
  union, low group first.

p2p addresses the remote group: ``send(buf, source, dest)`` sends from
local-group rank ``source`` to REMOTE-group rank ``dest``.  p2p rides a
dedicated channel communicator over the union of both groups (its own
matching engine), so intercomm traffic cannot collide with the parent's
own p2p or with other intercomms.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIRankError, MPIRootError
from ompi_tpu_torch.mesh.mesh import CommMesh
from ompi_tpu_torch.op.op import SUM, Op

from .comm import Comm, _next_cid
from .group import Group

#: MPI_ROOT / MPI_PROC_NULL for the rooted intercomm collectives
ROOT = -3
PROC_NULL = -2


def _tiled(row, shape: tuple):
    """``row`` repeated into a fresh buffer of ``shape`` (a tensor stays
    a tensor on its device, anything else becomes numpy)."""
    if isinstance(row, torch.Tensor):
        return row.expand(shape).clone()
    return np.broadcast_to(np.asarray(row), shape).copy()


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def create_intercomm(parent: Comm, local_ranks, remote_ranks,
                     name: str = "") -> "Intercomm":
    """MPI_Intercomm_create, single-controller form: both leaders are
    visible, so the handshake collapses to constructing the pair of
    intracomms over disjoint rank sets of ``parent``."""
    a = list(local_ranks)
    b = list(remote_ranks)
    if not a or not b:
        raise MPIArgError("intercomm groups must be non-empty")
    if set(a) & set(b):
        raise MPIArgError("intercomm groups must be disjoint")
    comm_a = parent.create_group(Group(a), name=f"{name or 'inter'}.A")
    comm_b = parent.create_group(Group(b), name=f"{name or 'inter'}.B")
    return Intercomm(parent, comm_a, comm_b, name)


class Intercomm:
    """An intercommunicator over (group A, group B)."""

    def __init__(self, parent: Comm, comm_a: Comm, comm_b: Comm, name: str = ""):
        self.parent = parent
        self.local = comm_a   # the "local" group from A's perspective
        self.remote = comm_b
        self.cid = _next_cid()
        self.name = name or f"intercomm#{self.cid}"
        self.is_inter = True
        # dedicated p2p channel over the union (A then B): its own
        # matching engine isolates intercomm traffic completely
        self._chan = Comm(
            Group(list(comm_a.group.ranks) + list(comm_b.group.ranks)),
            CommMesh(parent.device, comm_a.size + comm_b.size),
            name=f"{self.name}.chan",
        )

    # -- geometry -------------------------------------------------------

    @property
    def size(self) -> int:
        """Local group size (MPI_Comm_size on an intercomm)."""
        return self.local.size

    @property
    def remote_size(self) -> int:
        """MPI_Comm_remote_size."""
        return self.remote.size

    def remote_group(self) -> Group:
        """MPI_Comm_remote_group (parent-rank view)."""
        return Group(self.remote.group.ranks)

    # -- p2p: source is a LOCAL-group rank, dest a REMOTE-group rank ---

    def _chan_rank(self, comm: Comm, offset: int, r: int) -> int:
        """Channel rank of side-local rank ``r`` (A occupies [0, |A|),
        B occupies [|A|, |A|+|B|))."""
        if not 0 <= r < comm.size:
            raise MPIRankError(f"rank {r} outside group of {comm.size}")
        return offset + r

    def _sides(self, remote_first: bool):
        a = (self.local, 0)
        b = (self.remote, self.local.size)
        return (b, a) if remote_first else (a, b)

    def send(self, buf, source: int, dest: int, tag: int = 0,
             from_remote: bool = False) -> None:
        """Send from group-A rank ``source`` to group-B rank ``dest``
        (``from_remote=True`` for the B→A direction)."""
        (sc, so), (dc, do) = self._sides(from_remote)
        self._chan.send(buf, self._chan_rank(sc, so, source),
                        self._chan_rank(dc, do, dest), tag)

    def recv(self, dest: int, source: int | None = None,
             tag: int | None = None, at_remote: bool = False):
        """Receive at group-A rank ``dest`` from group-B rank ``source``
        (``at_remote=True`` for B receiving from A).  Wildcards are safe:
        the channel's matching engine carries only this intercomm's
        traffic."""
        (dc, do), (sc, so) = self._sides(at_remote)
        pd = self._chan_rank(dc, do, dest)
        ps = None if source is None else self._chan_rank(sc, so, source)
        payload, st = self._chan.recv(pd, ps, tag)
        st.source = st.source - so  # back to sender-group rank
        return payload, st

    # -- collectives (rank-major per side) ------------------------------

    def allreduce(self, xa, xb, op: Op = SUM) -> tuple[Any, Any]:
        """Intercomm allreduce: A's rows receive reduce(B), B's rows
        receive reduce(A) — the crossed delivery of MPI 5.8."""
        ra = self.local.allreduce(xa, op)[0]
        rb = self.remote.allreduce(xb, op)[0]
        return _tiled(rb, _shape(xa)), _tiled(ra, _shape(xb))

    def bcast(self, x, root: int, root_in_local: bool = True):
        """Rooted intercomm bcast: the root's row is delivered to every
        rank of the OTHER group; returns that group's rank-major buffer
        (single-controller returns only the receiving side)."""
        src_comm, dst_comm = ((self.local, self.remote) if root_in_local
                              else (self.remote, self.local))
        if not 0 <= root < src_comm.size:
            raise MPIRootError(f"root {root} not in [0, {src_comm.size})")
        row = x[root] if isinstance(x, torch.Tensor) else np.asarray(x)[root]
        return _tiled(row, (dst_comm.size,) + _shape(row))

    def allgather(self, xa, xb) -> tuple[Any, Any]:
        """Each group receives the other group's blocks: A's result rows
        hold B's (remote_size, ...) blocks and vice versa."""
        a = xa if isinstance(xa, torch.Tensor) else np.asarray(xa)
        b = xb if isinstance(xb, torch.Tensor) else np.asarray(xb)
        return (_tiled(b[None], (_shape(a)[0],) + _shape(b)),
                _tiled(a[None], (_shape(b)[0],) + _shape(a)))

    def barrier(self) -> None:
        self.local.barrier()
        self.remote.barrier()

    # -- merge ----------------------------------------------------------

    def merge(self, high_group_local: bool = False) -> Comm:
        """MPI_Intercomm_merge: intracomm over the union; the group
        passing high=false is ordered first (here: local first unless
        ``high_group_local``)."""
        first, second = ((self.remote, self.local) if high_group_local
                         else (self.local, self.remote))
        ranks = list(first.group.ranks) + list(second.group.ranks)
        return Comm(Group(ranks), CommMesh(self.parent.device, len(ranks)),
                    name=f"{self.name}.merged")

    def free(self) -> None:
        self._chan.free()
        self.local.free()
        self.remote.free()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Intercomm {self.name} local={self.local.size} "
                f"remote={self.remote.size}>")
