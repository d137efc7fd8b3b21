"""Device arena — host staging and a free list of framework temporaries.

Port of ``ompi_tpu/mesh/arena.py`` (≈ ``opal/mca/mpool`` + ``rcache``).
PyTorch's caching allocator already recycles device memory, so the
arena keeps the parts that are the framework's own: :meth:`stage_in`
(the H2D staging of host buffers, counted) and ``acquire``/``release``
pool temporaries (barrier tokens) keyed by ``(shape, dtype, device)``,
so that after warm-up every acquisition is a pool hit with no
allocation.  Contents are unspecified on a hit.

:meth:`stats` has the reference's eight keys.  ``stage_calls`` and
``stage_bytes`` count every staging; ``addr_reuse``/``addr_new`` say
whether the allocator handed a staged tensor an address it had handed
that signature recently (``data_ptr()``, sampled as the reference samples
its buffer pointers: the first 8 calls, then 1 in 8; the last 64 sampled
addresses of a signature are remembered).  On the CPU a staged tensor is
a numpy-owned copy, whose block numpy recycles for the next copy of the
same size.  The SPC counters
``arena_stage_in``/``arena_stage_bytes``/``arena_pool_alloc`` are the
reference's; the port has no donating programs, so ``donate_signatures``
and ``arena_donations`` stay 0.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ompi_tpu_torch.ddt.datatype import from_numpy, host_tensor
from ompi_tpu_torch.tool import spc

#: free-list depth per (shape, dtype, device) signature
_POOL_CAP = 4

#: per-signature cap on remembered addresses (bounds ``_addrs``): the
#: most recently sampled ones are kept
_ADDR_CAP = 64


class DeviceArena:
    """Per-mesh staging accounting and pool of device temporaries."""

    def __init__(self):
        self.stage_calls = 0
        self.stage_bytes = 0
        self.pool_hits = 0
        self.pool_allocs = 0
        self.addr_reuse = 0
        self.addr_new = 0
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}
        #: (shape, dtype str) → the addresses staged to most recently,
        #: oldest first
        self._addrs: dict[tuple, OrderedDict] = {}
        #: a signature forgot an address past _ADDR_CAP — reuse counts
        #: undercount
        self._addr_overflow = False

    def _note_addr(self, ptr: int, key: tuple) -> None:
        """Count whether the allocator recycled an address this
        signature was staged to recently (``_lock`` held).  The most
        recent ``_ADDR_CAP`` addresses are remembered, not the first:
        torch's CPU allocator drifts over hundreds of addresses, so a set
        frozen at the first ones may never be hit again."""
        if len(self._addrs) > 512:  # unbounded-signature backstop
            self._addrs.clear()
        seen = self._addrs.setdefault(key, OrderedDict())
        if ptr in seen:
            seen.move_to_end(ptr)
            self.addr_reuse += 1
            return
        seen[ptr] = None
        if len(seen) > _ADDR_CAP:
            # the oldest is forgotten: recycled and fresh can no longer
            # be told apart for it
            seen.popitem(last=False)
            self._addr_overflow = True
        self.addr_new += 1

    def stage_in(self, host_array: np.ndarray, device: torch.device) -> torch.Tensor:
        """A host buffer as a tensor on ``device`` (counted here and in SPC)."""
        if spc.attached():
            spc.inc("arena_stage_in")
            spc.inc("arena_stage_bytes", host_array.nbytes)
        if torch.device(device).type == "cpu":
            # a numpy-owned copy: numpy hands the block a freed copy of one
            # size held back to the next copy of that size, as the
            # reference's BFC allocator does, where torch's CPU allocator
            # drifts over hundreds of addresses
            t = host_tensor(np.array(host_array, copy=True, order="C"))
        else:
            t = from_numpy(host_array, device)
        with self._lock:
            self.stage_calls += 1
            self.stage_bytes += host_array.nbytes
            if self.stage_calls <= 8 or (self.stage_calls & 7) == 0:
                self._note_addr(t.data_ptr(), (host_array.shape, host_array.dtype.str))
        return t

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

    def stats(self) -> dict:
        with self._lock:
            return {
                "stage_calls": self.stage_calls,
                "stage_bytes": self.stage_bytes,
                "donate_signatures": 0,  # no donating programs
                "pool_hits": self.pool_hits,
                "pool_allocs": self.pool_allocs,
                "addr_reuse": self.addr_reuse,
                "addr_new": self.addr_new,
                "addr_overflow": self._addr_overflow,
            }
