"""OpenSHMEM-style Python API over the port's osc/coll substrate.

Port of ``ompi_tpu/shmem/__init__.py``: PGAS symmetric-heap semantics
built on the components the C ``libtpushmem`` uses.  The symmetric heap
is a ``uint8`` byte window on the world's device under a run-long
passive epoch: in a single process one rank-major ``(n, heap_bytes)``
tensor (``Win.allocate``), across processes one tensor per local rank
(``MultiProcComm.win_allocate``).  put/get and the atomics are window
operations, and the collective forms ride the comm's coll table, so on
the card ``sum_to_all`` and ``fcollect`` run the ``ring_hop`` kernels
where ``cuda_ring`` serves them.  PE numbering follows the world's
global rank space (one PE per rank; under ``run --nranks 1`` one PE per
process, the classic OpenSHMEM layout).

The symmetric invariant is the memheap one: every PE performs the same
``malloc`` sequence, so a :class:`SymmArray`'s heap offset is identical
everywhere and remote addressing needs only (offset, pe).  Offsets are
16-byte aligned, which is what lets :meth:`SymmArray.view` re-view the
heap bytes as any dtype.

Where the reference returns numpy or JAX arrays, ``get`` and the
collectives return tensors on the heap's device, and ``SymmArray.view``
is a tensor view of the heap.  On the ``devices`` layout each PE's heap
region lies on its own card: ``put`` stages from the calling PE's card,
``get`` lands there, and the collectives hand the world ``RankShards``
(row l on local PE l's card) and return ``RankShards``.  An atomic returns a Python scalar
(``.item()``, its one host sync).  Unsigned words are updated through
their same-width signed carrier, since torch has no arithmetic for
``uint16``/``uint32``/``uint64``.

:func:`init` builds or adopts the world through the port's
:func:`ompi_tpu_torch.api.init`, so it runs on CUDA and raises where
there is none, unless the caller built a CPU world first.

C programs get the same model from ``shmem.h`` + ``libtpushmem.so``
(``csrc/capi/shmem_shim.c``, built by :func:`ompi_tpu_torch.native.build_shmem`)
over the port's MPI C ABI.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIInternalError
from ompi_tpu_torch.core.var import Deadline
from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN, from_numpy, numpy_dtype, to_numpy, torch_dtype

_state = None
_lock = threading.Lock()

#: heap offset alignment (``malloc``'s default) and heap size granule
_ALIGN = 16


class _ShmemState:
    def __init__(self, heap_bytes: int):
        import ompi_tpu_torch.api as api

        self.world = api.init()
        # whole granules: every PE's row of the single-process heap then
        # starts aligned, so a view at an aligned offset is legal
        self.heap_bytes = -(-int(heap_bytes) // _ALIGN) * _ALIGN
        self.brk = 0
        self.multi = hasattr(self.world, "procctx")
        if self.multi:
            self.local_pes = list(
                range(self.world.local_offset,
                      self.world.local_offset + self.world.local_size))
            self.win = self.world.win_allocate(self.heap_bytes, torch.uint8,
                                               name="shmem_heap")
        else:
            from ompi_tpu_torch.osc.win import Win

            self.local_pes = list(range(self.world.size))
            self.win = Win.allocate(self.world, self.heap_bytes, torch.uint8,
                                    name="shmem_heap")
            for pe in self.local_pes:
                self.win.lock_all(pe)

    def heap(self, pe: int) -> torch.Tensor:
        """Heap bytes of a locally-owned PE (both window kinds address
        memory() by global rank)."""
        return self.win.memory(pe)


def init(heap_bytes: int | None = None):
    """shmem_init: build (or adopt) the world and the symmetric heap.
    ``SHMEM_SYMMETRIC_SIZE`` overrides the default 64 MiB."""
    global _state
    with _lock:
        if _state is None:
            hb = heap_bytes or int(
                os.environ.get("SHMEM_SYMMETRIC_SIZE", 64 << 20))
            _state = _ShmemState(hb)
    return _state.world


def finalize() -> None:
    global _state
    with _lock:
        st, _state = _state, None
    if st is not None:
        if not st.multi:
            for pe in st.local_pes:
                st.win.unlock_all(pe)
        st.win.free()


def _st() -> _ShmemState:
    if _state is None:
        raise MPIInternalError("call shmem.init() first")
    return _state


def my_pe() -> int:
    """First locally-owned PE (the process index under the one-rank-
    per-process layout the C shmem world uses)."""
    return _st().local_pes[0]


def n_pes() -> int:
    return _st().world.size


def local_pes() -> list[int]:
    return list(_st().local_pes)


class SymmArray:
    """A symmetric allocation: same (offset, shape, dtype) on every PE.

    :meth:`view` is the calling PE's own heap slice as a tensor (PGAS
    local view); remote access goes through :func:`put`/:func:`get`/
    the atomics, addressed by (this object, pe).  ``dtype`` is a torch
    dtype (a numpy dtype is converted)."""

    def __init__(self, offset: int, shape, dtype):
        self.offset = int(offset)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self.nbytes = int(np.prod(self.shape)) * self.dtype.itemsize

    def view(self, pe: int | None = None) -> torch.Tensor:
        """Writable tensor view of a LOCALLY-OWNED pe's slice, on the
        heap's device."""
        st = _st()
        pe = st.local_pes[0] if pe is None else int(pe)
        if pe not in st.local_pes:
            raise MPIArgError(
                f"PE {pe} is not local; use shmem.get/put for remote "
                f"access")
        raw = st.heap(pe)[self.offset: self.offset + self.nbytes]
        return raw.view(self.dtype).reshape(self.shape)

    def __array__(self, dtype=None, copy=None):
        v = to_numpy(self.view())
        return v.astype(dtype) if dtype is not None else v


def malloc(shape, dtype=torch.float64, align: int = _ALIGN) -> SymmArray:
    """Collective symmetric allocation (lockstep bump pointer — the
    memheap invariant keeps offsets identical on every PE)."""
    st = _st()
    if np.isscalar(shape):
        shape = (int(shape),)
    else:
        shape = tuple(int(s) for s in shape)
    arr = SymmArray((st.brk + align - 1) // align * align, shape, dtype)
    if arr.offset + arr.nbytes > st.heap_bytes:
        raise MPIInternalError(
            "symmetric heap exhausted (set SHMEM_SYMMETRIC_SIZE)")
    st.brk = arr.offset + arr.nbytes
    barrier_all()  # collective per the spec; keeps divergence loud
    return arr


def free(arr: SymmArray) -> None:
    """Bump allocator: a collective no-op (region dies at finalize)."""
    del arr
    barrier_all()


# -- RMA ----------------------------------------------------------------

#: single-controller atomics: one address space, one mutation lock
_atomic_mu = threading.Lock()


def _tensor(x, dtype: torch.dtype | None, device) -> torch.Tensor:
    """``x`` as a contiguous tensor on ``device`` (of ``dtype`` when
    given); numpy input is converted on the host as the reference
    converts it, then moved."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to(device)
        return (t if dtype is None else t.to(dtype)).contiguous()
    a = np.asarray(x) if dtype is None else np.asarray(x, numpy_dtype(dtype))
    return from_numpy(a, device)


def _my_device(st) -> torch.device:
    """The calling PE's device (its heap region's)."""
    return st.heap(st.local_pes[0]).device


def _coll_input(comm, x):
    """A rank-major collective input for ``comm``: one tensor on its
    device, or on the devices layout ``RankShards`` with row l on local
    rank l's card."""
    from ompi_tpu_torch.mesh.shards import RankShards

    mesh = comm.mesh
    if mesh.layout != "devices":
        return _tensor(x, None, comm.device)
    if isinstance(x, RankShards):
        return x
    rows = x if isinstance(x, torch.Tensor) else np.asarray(x)
    return RankShards([_tensor(rows[i], None, d) for i, d in enumerate(mesh.devices)])


def put(dest: SymmArray, source, pe: int) -> None:
    """shmem_put: write ``source`` into ``dest``'s slice on ``pe``;
    remotely complete at return (quiet-per-op, the strong contract)."""
    st = _st()
    src = _tensor(source, dest.dtype, _my_device(st))
    if src.numel() * dest.dtype.itemsize > dest.nbytes:
        raise MPIArgError(
            f"put of {src.numel() * dest.dtype.itemsize} B into {dest.nbytes} B")
    u8 = src.reshape(-1).view(torch.uint8)
    if st.multi:
        st.win.put(pe, u8, disp=dest.offset)
        st.win.flush(pe)
    else:
        me = st.local_pes[0]
        st.win.put(me, pe, u8, target_disp=dest.offset)
        st.win.flush(me, pe)  # remote completion at return


def get(source: SymmArray, pe: int, count: int | None = None) -> torch.Tensor:
    """shmem_get: fetch ``source``'s slice from ``pe``, a tensor on the
    calling PE's heap device."""
    st = _st()
    nbytes = source.nbytes if count is None else int(count) * source.dtype.itemsize
    if st.multi:
        raw = st.win.get(pe, nbytes, disp=source.offset, origin=st.local_pes[0])
    else:
        me = st.local_pes[0]
        req = st.win.get(me, pe, nbytes, target_disp=source.offset)
        st.win.flush(me, pe)
        raw = req.wait()
    out = raw.view(source.dtype)
    return out.reshape(source.shape) if count is None else out


def _local_atomic(dest: SymmArray, pe: int, value, fn):
    """Read-modify-write of word 0 on a local PE: ``fn(old, value)`` on
    the signed carrier of an unsigned dtype (same bits, and torch has
    the arithmetic), the result stored unless it is None."""
    carrier = SIGNED_TWIN.get(dest.dtype, dest.dtype)
    with _atomic_mu:
        cell = dest.view(pe).reshape(-1)[:1].view(carrier)
        old = cell.clone()
        operand = None if value is None else _tensor(
            [value], dest.dtype, cell.device).view(carrier)
        nxt = fn(old, operand)
        if nxt is not None:
            cell.copy_(nxt)
    return old.view(dest.dtype).item()  # the atomic's one host sync


def _remote_atomic(dest: SymmArray, pe: int, value, op_name: str):
    from ompi_tpu_torch import op as opmod

    st = _st()
    return st.win.fetch_and_op(
        pe, value, disp=dest.offset // dest.dtype.itemsize,
        op=getattr(opmod, op_name), dt=numpy_dtype(dest.dtype)).item()


def atomic_fetch_add(dest: SymmArray, value, pe: int):
    """shmem_atomic_fetch_add on element 0 of ``dest``."""
    if _st().multi:
        return _remote_atomic(dest, pe, value, "SUM")
    return _local_atomic(dest, pe, value, lambda old, v: old + v)


def atomic_fetch(dest: SymmArray, pe: int):
    if _st().multi:
        return _remote_atomic(dest, pe, 0, "NO_OP")
    return _local_atomic(dest, pe, None, lambda old, v: None)


def atomic_set(dest: SymmArray, value, pe: int):
    if _st().multi:
        _remote_atomic(dest, pe, value, "REPLACE")
        return None
    _local_atomic(dest, pe, value, lambda old, v: v)


def atomic_compare_swap(dest: SymmArray, cond, value, pe: int):
    st = _st()
    if st.multi:
        return st.win.compare_and_swap(
            pe, value, cond, disp=dest.offset // dest.dtype.itemsize,
            dt=numpy_dtype(dest.dtype)).item()
    carrier = SIGNED_TWIN.get(dest.dtype, dest.dtype)
    return _local_atomic(
        dest, pe, value, lambda old, v: torch.where(
            old == _tensor([cond], dest.dtype, old.device).view(carrier), v, old))


# -- ordering / collectives --------------------------------------------


def quiet() -> None:
    st = _st()
    if st.multi:
        st.win.flush_all()


def fence() -> None:
    quiet()


def barrier_all() -> None:
    st = _st()
    quiet()
    st.world.barrier()


def broadcast(x, root: int = 0):
    """World broadcast of a rank-major value (the framework's coll
    table), returned as a tensor on the world's device (``RankShards``
    on the devices layout)."""
    world = _st().world
    return world.bcast(_coll_input(world, x), root)


def fcollect(x):
    world = _st().world
    return world.allgather(_coll_input(world, x))


def sum_to_all(x):
    from ompi_tpu_torch.op import SUM

    world = _st().world
    return world.allreduce(_coll_input(world, x), SUM)


# -- point synchronization (1.4/1.5 wait/test) --------------------------

CMP_EQ, CMP_NE, CMP_GT, CMP_LE, CMP_LT, CMP_GE = range(6)

_CMP = {
    CMP_EQ: lambda a, b: a == b,
    CMP_NE: lambda a, b: a != b,
    CMP_GT: lambda a, b: a > b,
    CMP_LE: lambda a, b: a <= b,
    CMP_LT: lambda a, b: a < b,
    CMP_GE: lambda a, b: a >= b,
}


def test(ivar: SymmArray, cmp: int, value, pe: int | None = None) -> bool:
    """shmem_test on element 0 of ``ivar`` (own PE by default)."""
    target = my_pe() if pe is None else pe
    return bool(_CMP[cmp](atomic_fetch(ivar, target), value))


def wait_until(ivar: SymmArray, cmp: int, value) -> None:
    """shmem_wait_until on the calling PE's copy of ``ivar``; a peer's
    update that does not come within ``dcn_recv_timeout`` raises
    :class:`~ompi_tpu_torch.core.errors.DeadlineExpiredError`."""
    me = my_pe()
    deadline = Deadline.for_timeout("recv")
    while not _CMP[cmp](atomic_fetch(ivar, me), value):
        deadline.check("shmem wait_until")
        time.sleep(0.0002)


# -- distributed locks --------------------------------------------------
# The PE-0 copy of the symmetric lock word is the arbiter (the same
# discipline as libtpushmem): 0 = free, pe+1 = held.


def set_lock(lock: SymmArray) -> None:
    token = my_pe() + 1
    while int(atomic_compare_swap(lock, 0, token, 0)) != 0:
        time.sleep(0.0002)


def clear_lock(lock: SymmArray) -> None:
    quiet()  # critical-section writes complete before the release
    atomic_compare_swap(lock, my_pe() + 1, 0, 0)


def test_lock(lock: SymmArray) -> int:
    """0 = acquired, 1 = busy (OpenSHMEM return convention)."""
    return 0 if int(atomic_compare_swap(lock, 0, my_pe() + 1, 0)) == 0 \
        else 1


# -- signaled puts (1.5) ------------------------------------------------

SIGNAL_SET = 0
SIGNAL_ADD = 1


def put_signal(dest: SymmArray, source, sig: SymmArray, signal: int,
               pe: int, sig_op: int = SIGNAL_SET) -> None:
    """shmem_putmem_signal: the data put completes remotely BEFORE the
    signal update becomes visible (put() here is remote-complete at
    return, so the ordering contract holds a fortiori)."""
    put(dest, source, pe)
    if sig_op == SIGNAL_ADD:
        atomic_fetch_add(sig, signal, pe)
    elif sig_op == SIGNAL_SET:
        atomic_set(sig, signal, pe)
    else:
        raise MPIArgError(f"bad sig_op {sig_op}")


def signal_wait_until(sig: SymmArray, cmp: int, value) -> int:
    """Returns the signal value that satisfied the wait (1.5); bounded
    by ``dcn_recv_timeout`` like :func:`wait_until`."""
    me = my_pe()
    deadline = Deadline.for_timeout("recv")
    while True:
        cur = atomic_fetch(sig, me)
        if _CMP[cmp](cur, value):
            return int(cur)
        deadline.check("shmem signal_wait_until")
        time.sleep(0.0002)


# -- teams (1.5) --------------------------------------------------------


class Team:
    """A (start, stride, size) strided subset of the world with a REAL
    sub-communicator, so team collectives and sync are first-class —
    the Python face of the C layer's team objects."""

    def __init__(self, comm, start: int, stride: int, size: int):
        self._comm = comm
        self.start = start
        self.stride = stride
        self.size = size

    def my_pe(self) -> int:
        off = my_pe() - self.start
        if off < 0 or off % self.stride or off // self.stride >= self.size:
            return -1
        return off // self.stride

    def n_pes(self) -> int:
        return self.size

    def translate_pe(self, src_pe: int, dest: "Team") -> int:
        if src_pe < 0 or src_pe >= self.size:
            return -1
        world = self.start + src_pe * self.stride
        off = world - dest.start
        if off < 0 or off % dest.stride or off // dest.stride >= dest.size:
            return -1
        return off // dest.stride

    def sync(self) -> None:
        self._comm.barrier()

    def sum_reduce(self, x):
        from ompi_tpu_torch.op import SUM

        return self._comm.allreduce(_coll_input(self._comm, x), SUM)

    def max_reduce(self, x):
        from ompi_tpu_torch.op import MAX

        return self._comm.allreduce(_coll_input(self._comm, x), MAX)

    def broadcast(self, x, root: int = 0):
        return self._comm.bcast(_coll_input(self._comm, x), root)

    def destroy(self) -> None:
        if self._comm is not None and self._comm is not _st().world:
            self._comm.free()
        self._comm = None


def team_world() -> Team:
    st = _st()
    return Team(st.world, 0, 1, st.world.size)


def team_split_strided(start: int, stride: int, size: int) -> Team | None:
    """Collective over ALL world PEs (the parent team), per 1.5:
    members receive a Team, nonmembers None.  The sub-communicator
    comes from the comm layer's split (color by membership)."""
    st = _st()
    if size < 1 or stride < 1 or start < 0 \
            or start + (size - 1) * stride >= st.world.size:
        raise MPIArgError("invalid team triple")
    member = {start + i * stride for i in range(size)}
    if st.multi:
        from ompi_tpu_torch.api.comm import COLOR_UNDEFINED

        colors = [0 if pe in member else COLOR_UNDEFINED
                  for pe in st.local_pes]
        subs = st.world.split(colors, list(st.local_pes))
        # the calling identity is the PRIMARY local PE (my_pe() ==
        # local_pes[0]): its membership decides Team-vs-None, never a
        # secondary local rank's
        sub = subs[0]
    elif member == set(range(st.world.size)):
        sub = st.world
    else:
        from ompi_tpu_torch.api.group import Group

        sub = st.world.create_group(Group(sorted(member)))
    if sub is None:
        return None
    return Team(sub, start, stride, size)
