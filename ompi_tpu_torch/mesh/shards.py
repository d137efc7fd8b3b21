"""A rank-sharded value: one tensor per rank, each its own allocation.

Port of a ``jax.Array`` under ``CommMesh.rank_sharding()`` in
``ompi_tpu/mesh/mesh.py``: rank r's slice of a rank-major value lives
on rank r's device.  On the ``devices`` layout of
:class:`~ompi_tpu_torch.mesh.mesh.CommMesh` a communicator's buffers
are :class:`RankShards`; ``stage_in`` builds one from a host rank-major
array and ``stage_out`` concatenates it back.  It only holds the
tensors (and makes fresh ones, :meth:`RankShards.full`): there is no
arithmetic on it; the algorithms over shards are
:mod:`ompi_tpu_torch.coll.base_shards`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy


class RankShards:
    """``shards[r]`` is rank r's buffer; every shard has one shape and one
    dtype, and all lie on devices of one kind (all CPU or all CUDA)."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        shards = tuple(shards)
        if not shards:
            raise MPIArgError("RankShards needs at least one shard")
        if not all(isinstance(s, torch.Tensor) for s in shards):
            raise MPIArgError("every shard must be a torch.Tensor")
        first = shards[0]
        if any(s.shape != first.shape or s.dtype != first.dtype for s in shards):
            raise MPIArgError(
                "shards differ in shape or dtype: "
                f"{sorted({(tuple(s.shape), str(s.dtype)) for s in shards})}")
        kinds = sorted({s.device.type for s in shards})
        if len(kinds) > 1:
            raise MPIArgError(f"shards mix device kinds {kinds}: all CPU or all CUDA")
        self.shards = shards

    @classmethod
    def from_host(cls, host_array: np.ndarray, devices: Sequence[torch.device]) -> "RankShards":
        """Rank-major host ``(n, ...)`` → row r as a fresh tensor on ``devices[r]``."""
        if host_array.shape[0] != len(devices):
            raise MPIArgError(
                f"rank-major buffer leading dim {host_array.shape[0]} != "
                f"comm size {len(devices)}")
        return cls([from_numpy(np.ascontiguousarray(host_array[r]), d)
                    for r, d in enumerate(devices)])

    @classmethod
    def full(cls, devices: Sequence[torch.device], value, shape: tuple = (),
             dtype: torch.dtype = torch.int32) -> "RankShards":
        """A fresh ``shape`` tensor of ``value`` on each of ``devices``
        (one per rank: a barrier's token, a zero buffer)."""
        return cls([torch.full(shape, value, dtype=dtype, device=d) for d in devices])

    def to_host(self) -> np.ndarray:
        """The rank-major numpy ``(n, ...)`` value."""
        return np.stack([to_numpy(s) for s in self.shards])

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> tuple:
        """Rank-major: ``(n,) + shard shape``."""
        return (len(self.shards),) + tuple(self.shards[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    @property
    def nbytes(self) -> int:
        """Bytes over every rank (a rank-major tensor's ``nbytes``)."""
        return sum(s.nbytes for s in self.shards)

    def __getitem__(self, r: int) -> torch.Tensor:
        return self.shards[r]

    def __repr__(self) -> str:  # pragma: no cover
        return f"<RankShards {self.shape} {self.dtype} on {sorted({str(d) for d in self.devices})}>"
