"""``coll/basic`` — always-available host-path fallback collectives.

Port of ``ompi_tpu/coll/basic.py``: rank-sequential numpy folds on the
host, the lowest-priority fallback (jagged v-variants, jagged
``reduce_scatter``) and the in-tree golden order.  Tensor inputs (and a
devices-layout buffer's shards) are copied to the host; results are
numpy arrays.  i-variants complete eagerly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.ddt.datatype import to_numpy
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op.op import Op, ordered_reduce_np
from ompi_tpu_torch.request import CompletedRequest, PersistentRequest, Request

from .module import COLL_OPS, CollModule


def _host(x):
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, RankShards):  # the devices layout: the shards' host copy
        return x.to_host()
    if isinstance(x, (list, tuple)):
        return [_host(e) for e in x]
    return np.asarray(x)


class BasicCollModule(CollModule):
    """Rank-sequential host implementations of every collective."""

    def allreduce(self, x, op: Op):
        x = _host(x)
        return np.broadcast_to(ordered_reduce_np(x, op), x.shape).copy()

    def reduce(self, x, op: Op, root: int = 0):
        return self.allreduce(x, op)

    def reduce_scatter_block(self, x, op: Op):
        return ordered_reduce_np(_host(x), op)

    def reduce_scatter(self, x, op: Op, counts: Sequence[int] | None = None):
        x = _host(x)
        if counts is None:
            return self.reduce_scatter_block(x, op)
        if len(counts) != len(x):
            raise MPIArgError("reduce_scatter counts length != comm size")
        red = ordered_reduce_np(x, op)
        out, off = [], 0
        for c in counts:
            out.append(red[off : off + c])
            off += c
        return out

    def scan(self, x, op: Op):
        x = _host(x)
        out = np.empty_like(x)
        acc = x[0].copy()
        out[0] = acc
        for r in range(1, x.shape[0]):
            acc = op.np_fn(acc, x[r])
            out[r] = acc
        return out

    def exscan(self, x, op: Op):
        x = _host(x)
        out = np.zeros_like(x)
        if x.shape[0] > 1:
            acc = x[0].copy()
            out[1] = acc
            for r in range(2, x.shape[0]):
                acc = op.np_fn(acc, x[r - 1])
                out[r] = acc
        return out

    def bcast(self, x, root: int = 0):
        x = _host(x)
        return np.broadcast_to(x[root], x.shape).copy()

    def allgather(self, x):
        x = _host(x)
        return np.broadcast_to(x[None], (x.shape[0],) + x.shape).copy()

    def gather(self, x, root: int = 0):
        return _host(x).copy()

    def scatter(self, x, root: int = 0):
        return _host(x).copy()

    def alltoall(self, x):
        return np.swapaxes(_host(x), 0, 1).copy()

    def barrier(self):
        return None

    # -- jagged v-variants (lists of per-rank arrays) -------------------

    def allgatherv(self, blocks):
        return [_host(b).copy() for b in blocks]

    def gatherv(self, blocks, root: int = 0):
        return self.allgatherv(blocks)

    def scatterv(self, blocks, root: int = 0):
        return [_host(b).copy() for b in blocks]

    def alltoallv(self, matrix):
        n = len(matrix)
        for row in matrix:
            if len(row) != n:
                raise MPIArgError("alltoallv matrix must be n x n")
        return [[_host(matrix[r][j]).copy() for r in range(n)] for j in range(n)]

    # -- derived non-blocking / persistent slots ------------------------

    def __getattr__(self, name: str):
        # i<op> → eager completion; <op>_init → persistent wrapper
        if name.startswith("i") and name[1:] in COLL_OPS:
            blocking = getattr(self, name[1:])

            def ivariant(*a, **k) -> Request:
                return CompletedRequest(blocking(*a, **k))

            return ivariant
        if name.endswith("_init") and name[: -len("_init")] in COLL_OPS:
            blocking = getattr(self, name[: -len("_init")])

            def init_variant(*a, **k) -> PersistentRequest:
                return PersistentRequest(lambda: CompletedRequest(blocking(*a, **k)))

            return init_variant
        raise AttributeError(name)


@register_component
class BasicCollComponent(Component):
    """``coll/basic`` MCA component — priority 10, always usable."""

    FRAMEWORK = "coll"
    NAME = "basic"
    PRIORITY = 10

    def query(self, comm) -> BasicCollModule | None:
        # host fold over LOCAL rank-major rows: wrong on comms that span
        # processes (remote ranks invisible) — decline those (han serves)
        if getattr(comm, "dcn", None) is not None:
            return None
        return BasicCollModule(comm)
