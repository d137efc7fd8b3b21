"""Persistent and partitioned point-to-point (``MPI_Send_init`` …,
MPI-4 ``MPI_Psend_init``/``MPI_Precv_init``).

Port of ``ompi_tpu/p2p/part.py`` (≈ ``part/persist``).  A partitioned
send buffer is filled in partitions, each marked ready with
``pready(i)``; the transfer is aggregated: the message goes to the pml
when the LAST partition is ready, so a partly ready start never
publishes stale bytes.  ``parrived(i)`` reports arrival, which with
aggregation is all partitions at once (late, never early).  A tensor
buffer is sent as a tensor: the pml copies it onto the receiver's
device (on the devices layout, the destination rank's card), and the
partitions are views of it on the sender's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIRequestError
from ompi_tpu_torch.request import CompletedRequest, PersistentRequest, Request


class PersistentP2PMixin:
    """Persistent (Send_init/Recv_init) and partitioned (Psend/Precv)
    channel constructors over any communicator exposing ``send`` and
    ``irecv``."""

    def send_init(self, buf, source: int, dest: int, tag: int = 0):
        """MPI_Send_init: ``buf`` is held by reference — each ``start()``
        sends its current contents (refill between starts)."""

        def dispatch():
            self.send(buf, source, dest, tag)
            return CompletedRequest()

        return PersistentRequest(dispatch)

    def recv_init(self, dest: int, source: int | None = None, tag: int | None = None):
        """MPI_Recv_init: persistent receive channel."""
        return PersistentRequest(lambda: self.irecv(dest, source, tag))

    def psend_init(self, buf, partitions: int, source: int, dest: int, tag: int = 0):
        """MPI_Psend_init (partitioned send — see the module docstring)."""
        return PsendRequest(self, buf, partitions, source, dest, tag)

    def precv_init(self, partitions: int, dest: int, source: int | None = None,
                   tag: int | None = None):
        """MPI_Precv_init."""
        return PrecvRequest(self, partitions, dest, source, tag)


class PsendRequest(Request):
    """Partitioned send channel (MPI_Psend_init → Start → Pready*)."""

    def __init__(self, comm, buf, partitions: int, source: int, dest: int, tag: int):
        super().__init__()
        if partitions < 1:
            raise MPIArgError(f"partitions must be >= 1, got {partitions}")
        arr = buf if isinstance(buf, torch.Tensor) else np.asarray(buf)
        if arr.shape[0] % partitions:
            raise MPIArgError(
                f"leading dim {arr.shape[0]} not divisible into {partitions} partitions")
        self.comm = comm
        self.buf = arr  # by reference: start() reads the current contents
        self.partitions = partitions
        self.source, self.dest, self.tag = source, dest, tag
        self._active = False
        self._ready: set[int] = set()
        self._complete = True  # an inactive persistent request is complete
        #: memchecker: partition → adler32 at its pready
        self._part_sums: dict[int, int] = {}

    def start(self) -> "PsendRequest":
        if self._active:
            raise MPIRequestError("partitioned send started while active")
        self._active = True
        self._ready.clear()
        self._part_sums.clear()
        self._complete = False
        return self

    def _partition_view(self, partition: int):
        rows = self.buf.shape[0] // self.partitions
        return self.buf[partition * rows: (partition + 1) * rows]

    def pready(self, partition: int) -> None:
        """MPI_Pready: the partition may be sent; on the last one the
        aggregated message goes to the matching engine.

        With the memchecker attached, each partition's checksum is taken
        at its pready and verified when the message goes: a partition
        changed after its pready raises instead of publishing torn bytes
        (filling before pready stays legal)."""
        from ompi_tpu_torch.tool import memchecker

        if not self._active:
            raise MPIRequestError("pready before start")
        if not 0 <= partition < self.partitions:
            raise MPIArgError(f"partition {partition} out of range")
        if partition in self._ready:
            raise MPIRequestError(f"partition {partition} already ready")
        self._ready.add(partition)
        if memchecker.attached():
            self._part_sums[partition] = memchecker.checksum(self._partition_view(partition))
        if len(self._ready) == self.partitions:
            for part, sum0 in self._part_sums.items():
                if memchecker.checksum(self._partition_view(part)) != sum0:
                    raise memchecker.MPIBufferError(
                        f"partition {part} mutated after its pready (partitioned "
                        f"send publishes ready partitions; memchecker diagnostic)")
            payload = self.buf if isinstance(self.buf, torch.Tensor) \
                else np.asarray(self.buf).copy()
            self.comm.send(payload, source=self.source, dest=self.dest, tag=self.tag)
            self._active = False
            self._complete = True

    def pready_range(self, lo: int, hi: int) -> None:
        for p in range(lo, hi + 1):
            self.pready(p)

    def _poll(self) -> bool:
        return not self._active

    def _block(self) -> None:
        if self._active:
            raise MPIRequestError(
                f"wait on partitioned send with only {len(self._ready)}/"
                f"{self.partitions} partitions ready — mark all with pready")


class PrecvRequest(Request):
    """Partitioned receive channel (MPI_Precv_init → Start → Parrived)."""

    def __init__(self, comm, partitions: int, dest: int, source: int | None,
                 tag: int | None):
        super().__init__()
        if partitions < 1:
            raise MPIArgError(f"partitions must be >= 1, got {partitions}")
        self.comm = comm
        self.partitions = partitions
        self.dest, self.source, self.tag = dest, source, tag
        self._inner = None
        self._complete = True

    def start(self) -> "PrecvRequest":
        if self._inner is not None and not self._inner.test():
            raise MPIRequestError("partitioned recv started while active")
        self._inner = self.comm.irecv(self.dest, self.source, self.tag)
        self._complete = False
        return self

    def parrived(self, partition: int) -> bool:
        """MPI_Parrived: has this partition's data arrived?"""
        if not 0 <= partition < self.partitions:
            raise MPIArgError(f"partition {partition} out of range")
        if self._inner is None:
            raise MPIRequestError("parrived before start")
        return self._inner.test()

    @property
    def status(self):
        return None if self._inner is None else self._inner.status

    def _poll(self) -> bool:
        return self._inner is None or self._inner.test()

    def _block(self) -> None:
        if self._inner is not None:
            self._inner.wait()

    def _finalize(self):
        return None if self._inner is None else self._inner.wait()
