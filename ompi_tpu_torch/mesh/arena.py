"""Device arena — host staging and a free list of framework temporaries.

Port of ``ompi_tpu/mesh/arena.py`` (≈ ``opal/mca/mpool`` + ``rcache``).
PyTorch's caching allocator already recycles device memory, so the
arena keeps the parts that are the framework's own: :meth:`stage_in`
(the H2D staging of host buffers, counted) and ``acquire``/``release``
pool temporaries (barrier tokens) keyed by ``(shape, dtype, device)``,
so that after warm-up every acquisition is a pool hit with no
allocation.  Contents are unspecified on a hit.  The SPC counters
``arena_stage_in``/``arena_stage_bytes``/``arena_pool_alloc`` are the
reference's; the port has no donating programs, so ``arena_donations``
stays 0.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ompi_tpu_torch.ddt.datatype import from_numpy
from ompi_tpu_torch.tool import spc

#: free-list depth per (shape, dtype, device) signature
_POOL_CAP = 4


class DeviceArena:
    """Per-mesh pool of device temporaries."""

    def __init__(self):
        self.pool_hits = 0
        self.pool_allocs = 0
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}

    def stage_in(self, host_array: np.ndarray, device: torch.device) -> torch.Tensor:
        """A host buffer as a tensor on ``device`` (counted in SPC)."""
        if spc.attached():
            spc.inc("arena_stage_in")
            spc.inc("arena_stage_bytes", host_array.nbytes)
        return from_numpy(host_array, device)

    def acquire(self, shape: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
        """A pooled device buffer of the given signature (stale bytes on
        a pool hit — callers use it as a token or scratch only)."""
        key = (tuple(shape), dtype, torch.device(device))
        with self._lock:
            lst = self._free.get(key)
            if lst:
                self.pool_hits += 1
                return lst.pop()
            self.pool_allocs += 1
        if spc.attached():
            spc.inc("arena_pool_alloc")
        return torch.zeros(shape, dtype=dtype, device=device)

    def release(self, buf: torch.Tensor | None) -> None:
        """Return a buffer to the free list (dropped when the list is full)."""
        if buf is None:
            return
        key = (tuple(buf.shape), buf.dtype, buf.device)
        with self._lock:
            if len(self._free) > 256:  # unbounded-signature backstop
                self._free.clear()
            lst = self._free.setdefault(key, [])
            if len(lst) < _POOL_CAP:
                lst.append(buf)
