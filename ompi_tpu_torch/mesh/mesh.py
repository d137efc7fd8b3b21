"""Virtual-rank device mesh — the fabric every communicator rides on.

Port of ``ompi_tpu/mesh/mesh.py``.  The reference gives each rank its
own XLA device and shards rank-major arrays one row per device.  The
port has two layouts (``--mca accelerator_cuda_layout``):

* ``rows`` (the default): a communicator's n ranks are the **rows of
  one rank-major tensor on one ``torch.device``**: row r is rank r's
  buffer, and a ring hop moves row r to row (r+1) % n.  This is how the
  JAX package's own tests run n ranks on fewer devices (eight virtual
  XLA CPU devices), done on the GPU.
* ``devices``: the reference's one rank per device.  ``devices[r]`` is
  rank r's device and every rank's buffer is an allocation of its own
  there (a :class:`~ompi_tpu_torch.mesh.shards.RankShards`, the
  counterpart of ``rank_sharding``).  Rank r goes to card
  ``r * count // n`` of the ``count`` cards (blocks, so most ring
  neighbours share a card), so devices repeat when there are fewer
  cards than ranks; on one card every rank is on ``cuda:0``.  Two cards
  of one mesh that cannot reach each other's memory
  (``torch.cuda.can_device_access_peer``) make building the mesh
  raise: nothing is staged through the host instead.

The accelerator component ``cuda`` (peer of the reference's
``accelerator/tpu``) builds the world mesh.  Its device defaults to
``cuda``; the CPU is used only when the caller asks for it, and asking
for CUDA on a machine without it raises instead of carrying on on the CPU.
``accelerator_cuda_device_order`` is the reference's
``accelerator_tpu_device_order``: ``default`` (torch's enumeration) or
``id`` (sorted by PCI location, the card's stable id).
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
from .shards import RankShards

#: ranks of COMM_WORLD when the caller names no count
DEFAULT_NRANKS = 8
#: values of ``accelerator_cuda_layout``
LAYOUTS = ("rows", "devices")
#: values of ``accelerator_cuda_device_order``
DEVICE_ORDERS = ("default", "id")


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


def block_devices(ids: Sequence, nranks: int) -> list:
    """Rank r → ``ids[r * len(ids) // nranks]``: contiguous blocks of
    ranks per device, so that most ring neighbours share one."""
    if not ids:
        raise MPIArgError("no device to place ranks on")
    return [ids[r * len(ids) // nranks] for r in range(nranks)]


def order_device_ids(keys: Sequence, order: str) -> list[int]:
    """Device indices in ``order``: ``default`` keeps the enumeration,
    ``id`` sorts by ``keys[i]`` (the reference's ``d.id`` sort)."""
    if order not in DEVICE_ORDERS:
        raise MPIArgError(f"device order {order!r}: one of {DEVICE_ORDERS}")
    ids = list(range(len(keys)))
    if order == "id":
        ids.sort(key=lambda i: (keys[i], i))
    return ids


def _pci_key(i: int) -> tuple:
    props = torch.cuda.get_device_properties(i)
    return tuple(getattr(props, f, i) for f in ("pci_domain_id", "pci_bus_id",
                                                "pci_device_id"))


def rank_devices(device=None, nranks: int = DEFAULT_NRANKS,
                 order: str = "default") -> tuple:
    """The ``devices`` layout's device per rank: on CUDA, ranks in blocks
    over every card in ``order``; on another device, that device for
    every rank.  Raises where CUDA is asked for and there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        order_device_ids([], order)  # validates the name
        return (dev,) * nranks
    count = torch.cuda.device_count()
    ids = order_device_ids([_pci_key(i) for i in range(count)], order)
    return tuple(torch.device("cuda", i) for i in block_devices(ids, nranks))


def check_devices(devices: Sequence[torch.device]) -> None:
    """A ``devices``-layout mesh is all CPU or all CUDA, and on CUDA every
    two of its cards can reach each other's memory."""
    kinds = sorted({d.type for d in devices})
    if len(kinds) > 1:
        raise MPIArgError(f"a mesh mixes device kinds {kinds}: all CPU or all CUDA")
    if kinds != ["cuda"]:
        return
    resolve_device("cuda")
    cards = sorted({d.index for d in devices})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise MPIInternalError(
                    f"cuda:{a} cannot reach cuda:{b}'s memory: the devices layout "
                    "needs every two cards of a mesh to be peers and never stages "
                    "through the host")


class CommMesh:
    """A communicator's view of the fabric.  ``rows``: ``nranks`` virtual
    ranks, the rows of rank-major tensors on ``device``.  ``devices``:
    rank r's buffer on ``devices[r]``, given or placed by
    :func:`rank_devices` (``device`` is then ``devices[0]``)."""

    def __init__(self, device: torch.device | str | None = None,
                 nranks: int = DEFAULT_NRANKS, *, layout: str = "rows",
                 devices: Sequence | None = None, device_order: str = "default"):
        if layout not in LAYOUTS:
            raise MPIArgError(f"mesh layout {layout!r}: one of {LAYOUTS}")
        self.layout = layout
        if layout == "rows":
            if devices is not None:
                raise MPIArgError("the rows layout takes one device, not a device list")
            if nranks <= 0:
                raise MPIArgError("a mesh needs at least one rank")
            self.device = resolve_device(device)
            self.devices = (self.device,) * int(nranks)
        else:
            if devices is None:
                if nranks <= 0:
                    raise MPIArgError("a mesh needs at least one rank")
                devices = rank_devices(device, nranks, device_order)
            devices = tuple(torch.device(d) for d in devices)
            if not devices:
                raise MPIArgError("a mesh needs at least one rank")
            check_devices(devices)
            self.devices = devices
            self.device = devices[0]
        self.nranks = len(self.devices)
        #: pool of framework temporaries (mpool/rcache analog)
        self.arena = DeviceArena()

    @property
    def size(self) -> int:
        return self.nranks

    def stage_in(self, host_array: np.ndarray) -> torch.Tensor | RankShards:
        """Host rank-major (n, ...) buffer → tensor on the mesh device
        (``rows``) or row r on ``devices[r]`` (``devices``)."""
        if host_array.shape[0] != self.size:
            raise MPIArgError(
                f"rank-major buffer leading dim {host_array.shape[0]} != "
                f"comm size {self.size}"
            )
        if self.layout == "devices":
            return RankShards.from_host(host_array, self.devices)
        return self.arena.stage_in(host_array, self.device)

    def check_placed(self, rank: int, buf, what: str) -> None:
        """On the ``devices`` layout a tensor of rank r must lie on
        ``devices[r]``: nothing is moved implicitly (numpy buffers and the
        rows layout pass)."""
        if self.layout == "devices" and isinstance(buf, torch.Tensor) \
                and buf.device != self.devices[rank]:
            raise MPIArgError(
                f"rank {rank}'s {what} lies on {buf.device}, the rank on "
                f"{self.devices[rank]}: nothing is moved implicitly")

    def stage_out(self, t: torch.Tensor | RankShards) -> np.ndarray:
        if isinstance(t, RankShards):
            return t.to_host()
        return to_numpy(t)

    def submesh(self, indices: Sequence[int]) -> "CommMesh":
        """Sub-communicator mesh over local rank indices: ``rows`` keeps the
        device with ``len(indices)`` rows; ``devices`` keeps the chosen
        ranks' devices, in order, as the reference's does."""
        for i in indices:
            if not 0 <= i < self.size:
                raise MPIArgError(f"rank {i} outside a mesh of {self.size}")
        if self.layout == "devices":
            return CommMesh(layout="devices", devices=[self.devices[i] for i in indices])
        return CommMesh(self.device, len(indices))

    def __repr__(self) -> str:  # pragma: no cover
        if self.layout == "devices":
            return (f"<CommMesh {self.size} ranks, one per buffer on "
                    f"{sorted({str(d) for d in self.devices})}>")
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
        store.register(
            "accelerator", "cuda", "layout", "rows",
            help="COMM_WORLD's layout: 'rows' (every rank a row of one "
            "tensor on one device) or 'devices' (one buffer per rank, rank "
            "r on card r*count//n; every call of a single-process comm "
            "runs there, jobs of several processes not yet)",
        )
        store.register(
            "accelerator", "cuda", "device_order", "default",
            help="Card order of the devices layout: 'default' (torch's "
            "enumeration) or 'id' (sorted by PCI location)",
        )

    def world_mesh(self, device=None, nranks: int | None = None) -> CommMesh:
        """The persistent job-wide mesh (created once)."""
        with self._lock:
            if self._world is None:
                store = mca.default_context().store
                if nranks is None:
                    nranks = int(store.get("accelerator_cuda_nranks", DEFAULT_NRANKS))
                layout = str(store.get("accelerator_cuda_layout", "rows"))
                order = str(store.get("accelerator_cuda_device_order", "default"))
                if layout == "rows":
                    order_device_ids([], order)  # validates the name
                    self._world = CommMesh(device, nranks)
                else:
                    self._world = CommMesh(device, nranks, layout=layout,
                                           device_order=order)
            return self._world


def world_mesh(device=None, nranks: int | None = None) -> CommMesh:
    """The selected accelerator component's world mesh."""
    comp = mca.default_context().framework("accelerator").select_one()
    return comp.world_mesh(device, nranks)
