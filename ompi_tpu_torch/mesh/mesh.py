"""Virtual-rank device mesh — the fabric every communicator rides on.

Port of ``ompi_tpu/mesh/mesh.py``.  The reference gives each rank its
own XLA device and shards rank-major arrays one row per device.  Here a
communicator's n ranks are the **rows of one rank-major tensor on one
``torch.device``**: row r is rank r's buffer, and a ring hop moves row
r to row (r+1) % n.  This is how the JAX package's own tests run n
ranks on fewer devices (eight virtual XLA CPU devices), done on the GPU.

The accelerator component ``cuda`` (peer of the reference's
``accelerator/tpu``) builds the world mesh.  Its device defaults to
``cuda``; the CPU is used only when the caller asks for it, and asking
for CUDA on a machine without it raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.core import mca
from ompi_tpu_torch.core.errors import MPIArgError, MPIInternalError
from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.ddt.datatype import to_numpy

from .arena import DeviceArena

#: ranks of COMM_WORLD when the caller names no count
DEFAULT_NRANKS = 8


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device a mesh runs on: CUDA unless the caller asks for another.

    Raises when CUDA is asked for (explicitly or by default) and no
    CUDA device is present — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MPIInternalError(
                "no CUDA device is available; pass device='cpu' to run the "
                "collectives on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CommMesh:
    """A communicator's view of the fabric: ``nranks`` virtual ranks, the
    rows of rank-major tensors on ``device``."""

    def __init__(self, device: torch.device | str | None = None,
                 nranks: int = DEFAULT_NRANKS):
        if nranks <= 0:
            raise MPIArgError("a mesh needs at least one rank")
        self.device = resolve_device(device)
        self.nranks = int(nranks)
        #: pool of framework temporaries (mpool/rcache analog)
        self.arena = DeviceArena()

    @property
    def size(self) -> int:
        return self.nranks

    def stage_in(self, host_array: np.ndarray) -> torch.Tensor:
        """Host rank-major (n, ...) buffer → tensor on the mesh device."""
        if host_array.shape[0] != self.size:
            raise MPIArgError(
                f"rank-major buffer leading dim {host_array.shape[0]} != "
                f"comm size {self.size}"
            )
        return self.arena.stage_in(host_array, self.device)

    def stage_out(self, t: torch.Tensor) -> np.ndarray:
        return to_numpy(t)

    def submesh(self, indices: Sequence[int]) -> "CommMesh":
        """Sub-communicator mesh over local rank indices: the same device,
        ``len(indices)`` rows."""
        for i in indices:
            if not 0 <= i < self.size:
                raise MPIArgError(f"rank {i} outside a mesh of {self.size}")
        return CommMesh(self.device, len(indices))

    def __repr__(self) -> str:  # pragma: no cover
        return f"<CommMesh {self.size} ranks on {self.device}>"


@register_component
class CudaAcceleratorComponent(Component):
    """``accelerator/cuda`` — device choice + world-mesh bring-up."""

    FRAMEWORK = "accelerator"
    NAME = "cuda"
    PRIORITY = 50

    def __init__(self):
        super().__init__()
        self._world: CommMesh | None = None
        self._lock = threading.Lock()

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "accelerator", "cuda", "nranks", DEFAULT_NRANKS, type="int",
            help="Virtual ranks of COMM_WORLD when init() names no count "
            "(each rank is one row of the rank-major tensors on the device)",
        )

    def world_mesh(self, device=None, nranks: int | None = None) -> CommMesh:
        """The persistent job-wide mesh (created once)."""
        with self._lock:
            if self._world is None:
                if nranks is None:
                    nranks = int(mca.default_context().store.get(
                        "accelerator_cuda_nranks", DEFAULT_NRANKS))
                self._world = CommMesh(device, nranks)
            return self._world


def world_mesh(device=None, nranks: int | None = None) -> CommMesh:
    """The selected accelerator component's world mesh."""
    comp = mca.default_context().framework("accelerator").select_one()
    return comp.world_mesh(device, nranks)
