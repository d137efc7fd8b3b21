"""One-sided communication (RMA): windows, synchronization epochs, atomics.

Port of ``ompi_tpu/osc/win.py`` (≈ the ``osc`` framework).  The
reference's *deferred completion* model is kept: ``put``/``get``/
``accumulate``/``get_accumulate``/``fetch_and_op``/``compare_and_swap``
queue **descriptors**, and each synchronization call is the moment a
batch is applied to window memory, in global issue order — one
deterministic serialization (stronger than, and conforming to, the
standard's default accumulate ordering).

Window memory lives where the comm runs.  On the rows layout
``allocate`` and ``allocate_shared`` hold one ``(n, size)`` rank-major
tensor on the comm's device whose rows are the ranks' regions (the
shared segment's layout), so :meth:`Win.device_view` hands it back with
no staging.  On the devices layout rank r's region lies on rank r's
device (``allocate``, ``allocate_shared``: one region per device, since
one tensor cannot span cards; ``create``/``attach``: a tensor must
already lie there), and :meth:`Win.device_view` returns
:class:`~ompi_tpu_torch.mesh.shards.RankShards`, the reference's value
sharded one row per device.  ``create`` and ``attach`` alias the
caller's tensors or numpy arrays and never copy them.  Descriptors apply
with the ops' ``torch_fn`` on the memory's device, with no host sync:
``cas`` selects with ``torch.where``, ``get``/``get_acc``/``fop``/``cas``
deliver copies (on the origin's device on the devices layout), and the
unsigned types fold through the op layer's signed carriers.  Origin
data is copied when the descriptor is queued (the origin buffer is
reusable at once) onto the target memory's device; a numpy origin is
converted to the window's dtype on the host, as the reference converts
it, then moved to the memory.  An epoch's close records one CUDA event
per card it touched and makes each of those cards' current streams wait
on the others', so what a batch wrote on card B is ordered before work
issued afterwards on card C; a fetched value's request completes with
its card's event.

Synchronization (MPI-3 complete): collective ``fence``; PSCW
``start/complete/post/wait/test``; passive target ``lock/lock_all/
unlock/unlock_all/flush/flush_all/flush_local{,_all}/sync``; the
request-returning ``rput/rget/raccumulate/rget_accumulate``.  Flavors:
create, allocate, allocate_shared (+``shared_query``), create_dynamic
(+``attach``/``detach``).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ompi_tpu_torch.core import mca
from ompi_tpu_torch.core.errors import (
    MPIArgError,
    MPIRankError,
    MPIRMAAttachError,
    MPIRMAConflictError,
    MPIRMARangeError,
    MPIRMASyncError,
    MPIWinError,
)
from ompi_tpu_torch.ddt.datatype import _is_bfloat16, from_numpy, numpy_dtype, torch_dtype
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op.op import NO_OP, REPLACE, SUM, Op
from ompi_tpu_torch.request import Request
from ompi_tpu_torch.tool import spc

# lock types (values as in mpi.h)
LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

# window create flavors (MPI_WIN_FLAVOR_*)
FLAVOR_CREATE = 1
FLAVOR_ALLOCATE = 2
FLAVOR_DYNAMIC = 3
FLAVOR_SHARED = 4

# one address space ⇒ the strong MPI_WIN_UNIFIED memory model
MODEL_UNIFIED = 1

# assertion bits for fence/post/start (accepted as hints)
MODE_NOCHECK = 1
MODE_NOSTORE = 2
MODE_NOPUT = 4
MODE_NOPRECEDE = 8
MODE_NOSUCCEED = 16

#: descriptor kind → SPC counter
_SPC_KIND = {"put": "put", "get": "get", "acc": "accumulate", "get_acc": "accumulate",
             "fop": "accumulate", "cas": "accumulate"}


class RMARequest(Request):
    """Request of an r-variant or fetching op; completed, with its value,
    when the enclosing epoch or flush applies the descriptor batch."""

    def __init__(self):
        super().__init__()
        self._event = threading.Event()
        self._value: Any = None
        #: the CUDA event of the value's card at the epoch's close (None
        #: for a value off the card)
        self._landed = None

    def _deliver(self, value: Any, landed=None) -> None:
        self._value = value
        self._landed = landed
        self._event.set()

    def _poll(self) -> bool:
        return self._event.is_set() and (self._landed is None or self._landed.query())

    def _block(self) -> None:
        # descriptors are applied by the controlling thread at epoch
        # close: a wait before any sync call is an epoch error
        if not self._event.is_set():
            raise MPIRMASyncError(
                "RMA request waited on before its epoch was completed "
                "(call fence/flush/unlock/complete first)")
        if self._landed is not None:
            self._landed.synchronize()

    def _finalize(self) -> Any:
        return self._value


@dataclass
class _Descriptor:
    """One queued RMA operation."""

    kind: str  # put | get | acc | get_acc | fop | cas
    origin: int
    target: int
    disp: int
    count: int
    seq: int
    data: torch.Tensor | None = None
    op: Op | None = None
    compare: torch.Tensor | None = None
    request: RMARequest | None = None


class _Epoch:
    """Per-window synchronization state machine."""

    def __init__(self, nranks: int):
        self.fence_active = False
        # PSCW: per-origin access set, per-target exposure set
        self.access: dict[int, set[int]] = {}
        self.access_nocheck: set[int] = set()  # origins started with NOCHECK
        self.exposure: dict[int, set[int]] = {}
        # passive target: target → {origin: lock_type}
        self.locks: dict[int, dict[int, int]] = {r: {} for r in range(nranks)}
        self.lock_all: set[int] = set()  # origins holding lock_all


def _window_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)


def _order_cards(cards) -> dict:
    """One CUDA event per card of ``cards`` on its current stream; with
    several cards, each card's current stream then waits on the other
    cards' events, so work issued on any of them afterwards is ordered
    after what every one of them had queued."""
    events = {}
    for c in sorted(cards):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(c))
        events[c] = ev
    if len(events) > 1:
        for c in events:
            stream = torch.cuda.current_stream(c)
            for other, ev in events.items():
                if other != c:
                    stream.wait_event(ev)
    return events


def _alias(base, dtype: torch.dtype) -> torch.Tensor:
    """A 1-D window base as a tensor sharing its memory (a numpy array
    is wrapped with ``torch.from_numpy``, never copied)."""
    if isinstance(base, torch.Tensor):
        if base.dim() != 1 or not base.is_contiguous():
            raise MPIWinError("window base must be a 1-D contiguous tensor")
        return base.detach()
    if _is_bfloat16(base.dtype):
        return torch.from_numpy(base.view(np.uint16)).view(dtype)
    return torch.from_numpy(base)


class Win:
    """An MPI window over per-rank regions.

    Addressing is in **elements** of ``dtype`` (``disp_unit`` =
    itemsize); region sizes may differ per rank, as each rank passes its
    own size to ``MPI_Win_create``."""

    _name_counter = itertools.count(0)

    def __init__(self, comm, sizes: Sequence[int], dtype: Any = torch.float32,
                 flavor: int = FLAVOR_CREATE, bases: Sequence[Any] | None = None,
                 name: str = ""):
        n = comm.size
        if len(sizes) != n:
            raise MPIWinError(f"need {n} per-rank sizes, got {len(sizes)}")
        self.comm = comm
        self.dtype = _window_dtype(dtype)
        self.flavor = flavor
        self.model = MODEL_UNIFIED
        self.name = name or f"win#{next(Win._name_counter)}"
        self._block: torch.Tensor | None = None
        #: one region per rank on its own device (the devices layout)
        self._sharded = comm.mesh.layout == "devices"
        devices = comm.mesh.devices
        if bases is not None:
            if len(bases) != n:
                raise MPIWinError("bases/sizes length mismatch")
            for r, (b, s) in enumerate(zip(bases, sizes)):
                if b.ndim != 1 or b.shape[0] != s or _window_dtype(b.dtype) != self.dtype:
                    raise MPIWinError("window base must be 1-D of the declared size/dtype")
                comm.mesh.check_placed(r, b, "window memory")
            self._user = [b if isinstance(b, torch.Tensor) else np.ascontiguousarray(b)
                          for b in bases]
            self._mem = [_alias(b, self.dtype) for b in self._user]
        elif flavor in (FLAVOR_ALLOCATE, FLAVOR_SHARED) and not self._sharded:
            # one rank-major block on the comm's device, rows = regions
            self._block = torch.zeros((n, sizes[0]), dtype=self.dtype, device=comm.device)
            self._mem = list(self._block.unbind(0))
            self._user = self._mem
        else:
            self._mem = [torch.zeros(s, dtype=self.dtype, device=d)
                         for s, d in zip(sizes, devices)]
            self._user = self._mem
        self.sizes = tuple(int(s) for s in sizes)
        self._attrs: dict[int, Any] = {}
        self._freed = False
        self._seq = itertools.count(0)
        self._pending: list[_Descriptor] = []
        # soft cap on queued descriptors (the osc_arena_max_pending var)
        self._max_pending = int(
            mca.default_context().store.get("osc_arena_max_pending", 1 << 20))
        self._epoch = _Epoch(n)
        # dynamic windows: per-rank {addr: memory} attachments
        self._dynamic: list[dict[int, torch.Tensor]] = [dict() for _ in range(n)]

    # -- constructors ----------------------------------------------------------

    @classmethod
    def create(cls, comm, bases: Sequence[Any], name: str = "") -> "Win":
        """MPI_Win_create: expose caller-owned per-rank buffers (tensors or
        numpy arrays), aliased."""
        bases = [b if isinstance(b, torch.Tensor) else np.asarray(b) for b in bases]
        if not bases:
            raise MPIWinError("empty bases")
        return cls(comm, [b.shape[0] for b in bases], bases[0].dtype,
                   flavor=FLAVOR_CREATE, bases=bases, name=name)

    @classmethod
    def allocate(cls, comm, size: int, dtype: Any = torch.float32, name: str = "") -> "Win":
        """MPI_Win_allocate: the window owns its memory, on the comm's device."""
        return cls(comm, [size] * comm.size, dtype, flavor=FLAVOR_ALLOCATE, name=name)

    @classmethod
    def allocate_shared(cls, comm, size: int, dtype: Any = torch.float32,
                        name: str = "") -> "Win":
        """MPI_Win_allocate_shared: one contiguous rank-major block (one
        region per device on the devices layout, whose cards are peers),
        load/store access through ``shared_query``."""
        return cls(comm, [size] * comm.size, dtype, flavor=FLAVOR_SHARED, name=name)

    @classmethod
    def create_dynamic(cls, comm, dtype: Any = torch.float32, name: str = "") -> "Win":
        """MPI_Win_create_dynamic: zero-size window; memory is attached
        later and addressed by attachment address."""
        return cls(comm, [0] * comm.size, dtype, flavor=FLAVOR_DYNAMIC, name=name)

    # -- dynamic attach/detach ---------------------------------------------------

    def attach(self, rank: int, addr: int, array) -> None:
        self._check_flavor_dynamic()
        self._check_rank(rank)
        if not isinstance(array, torch.Tensor):
            array = np.asarray(array)
        if _window_dtype(array.dtype) != self.dtype or array.ndim != 1:
            raise MPIRMAAttachError(
                f"attachment must be 1-D {self.dtype} (got {array.dtype} "
                f"ndim={array.ndim}); a dtype-converting copy would detach "
                "RMA from the caller's memory")
        self.comm.mesh.check_placed(rank, array, "window memory")
        if addr in self._dynamic[rank]:
            raise MPIRMAAttachError(f"address {addr} already attached on rank {rank}")
        length = array.shape[0]
        for a, arr in self._dynamic[rank].items():
            if a < addr + length and addr < a + arr.shape[0]:
                raise MPIRMAAttachError(
                    f"attachment [{addr},{addr + length}) overlaps "
                    f"existing [{a},{a + arr.shape[0]}) on rank {rank}")
        self._dynamic[rank][addr] = _alias(array, self.dtype)

    def detach(self, rank: int, addr: int) -> None:
        self._check_flavor_dynamic()
        self._check_rank(rank)
        if addr not in self._dynamic[rank]:
            raise MPIRMAAttachError(f"address {addr} not attached on rank {rank}")
        del self._dynamic[rank][addr]

    def _check_flavor_dynamic(self):
        if self.flavor != FLAVOR_DYNAMIC:
            raise MPIWinError("attach/detach only valid on dynamic windows")

    # -- shared query / introspection ----------------------------------------

    def shared_query(self, rank: int) -> tuple[int, torch.Tensor]:
        """(size, load/store view of rank's region) — shared flavor only."""
        if self.flavor != FLAVOR_SHARED:
            raise MPIWinError("shared_query requires allocate_shared window")
        self._check_rank(rank)
        return self.sizes[rank], self._mem[rank]

    @property
    def group(self):
        return self.comm.group

    def set_attr(self, key: int, value: Any) -> None:
        self._attrs[key] = value

    def get_attr(self, key: int) -> Any:
        return self._attrs.get(key)

    def set_name(self, name: str) -> None:
        self.name = name

    def memory(self, rank: int):
        """Local load/store access to rank's region (the base pointer: the
        caller's own array for a created window).  Reading it mid-epoch
        is the user's race, as in MPI."""
        self._check()
        self._check_rank(rank)
        return self._user[rank]

    def device_view(self) -> torch.Tensor | RankShards:
        """The window rank-major, ``(n, maxsize)`` (short regions
        zero-padded): one tensor on the comm's device (rows layout) or
        ``RankShards`` with row r on rank r's device (devices layout).
        Allocated windows are that value already and are returned as
        they are, with no staging."""
        if self._block is not None and self._block.device == self.comm.device:
            return self._block
        if self._sharded and self.flavor in (FLAVOR_ALLOCATE, FLAVOR_SHARED):
            return RankShards(self._mem)
        width = max(self.sizes) if self.sizes else 0
        if self._sharded:
            out = RankShards([torch.zeros(width, dtype=self.dtype, device=d)
                              for d in self.comm.mesh.devices])
        else:
            out = torch.zeros((self.comm.size, width), dtype=self.dtype, device=self.comm.device)
        for r, mem in enumerate(self._mem):
            out[r][: self.sizes[r]].copy_(mem)
        return out

    def free(self) -> None:
        if self._pending:
            raise MPIRMASyncError(f"{len(self._pending)} RMA operations pending at win free")
        self._freed = True

    # -- bounds/validation -----------------------------------------------------

    def _check_rank(self, r: int) -> None:
        if not 0 <= r < self.comm.size:
            raise MPIRankError(f"rank {r} outside [0, {self.comm.size})")

    def _check(self):
        if self._freed:
            raise MPIWinError(f"{self.name} has been freed")

    def _region(self, target: int, disp: int, count: int) -> torch.Tensor:
        """(target, disp, count) resolved to the backing view."""
        if count < 0 or disp < 0:
            raise MPIRMARangeError(f"negative disp/count ({disp}, {count})")
        if self.flavor == FLAVOR_DYNAMIC:
            for addr, arr in self._dynamic[target].items():
                if addr <= disp and disp + count <= addr + arr.shape[0]:
                    return arr[disp - addr: disp - addr + count]
            raise MPIRMARangeError(
                f"[{disp},{disp + count}) not within any attachment on rank {target}")
        if disp + count > self.sizes[target]:
            raise MPIRMARangeError(
                f"[{disp},{disp + count}) outside window of size "
                f"{self.sizes[target]} on rank {target}")
        return self._mem[target][disp: disp + count]

    def _check_epoch(self, origin: int, target: int) -> None:
        """An RMA op needs an access epoch at the origin covering the
        target: fence, a PSCW access group holding it, a lock, or lock_all."""
        e = self._epoch
        if e.fence_active:
            return
        if target in e.access.get(origin, ()):  # PSCW
            # ops may not pass start() before the matching post(),
            # unless start was given MODE_NOCHECK
            if origin in e.access_nocheck or origin in e.exposure.get(target, ()):
                return
            raise MPIRMASyncError(
                f"rank {origin} started an access epoch for {target} but "
                f"{target} has not posted a matching exposure epoch")
        if origin in e.locks[target] or origin in e.lock_all:
            return
        raise MPIRMASyncError(
            f"rank {origin} has no access epoch for target {target} "
            "(need fence / start / lock / lock_all)")

    def _origin_data(self, data, device: torch.device) -> torch.Tensor:
        """The origin buffer as a 1-D copy in the window's dtype on the
        target memory's device (the origin is reusable at once)."""
        if isinstance(data, torch.Tensor):
            t = data.detach().reshape(-1).to(device=device, dtype=self.dtype)
            return t.clone() if t.data_ptr() == data.data_ptr() else t
        a = np.asarray(data)
        if not _is_bfloat16(a.dtype):
            try:
                a = np.asarray(a, numpy_dtype(self.dtype))
            except ImportError:  # bfloat16 without ml_dtypes: torch converts
                return torch.from_numpy(np.ascontiguousarray(a.ravel())).to(
                    device=device, dtype=self.dtype)
        return from_numpy(a.ravel(), device).to(self.dtype)

    # -- descriptor queueing (the RMA verbs) -------------------------------------

    def _queue(self, d: _Descriptor) -> None:
        if len(self._pending) >= self._max_pending:
            raise MPIRMASyncError(
                f"{len(self._pending)} queued RMA descriptors exceed "
                "osc_arena_max_pending; synchronize (fence/flush) first")
        if spc._attached:
            spc.inc(_SPC_KIND[d.kind])
            if d.kind == "put" and d.data is not None:
                spc.inc("put_bytes", d.data.nbytes)
            elif d.kind == "get":
                spc.inc("get_bytes", d.count * self.dtype.itemsize)
        self._pending.append(d)

    def _open(self, origin: int, target: int) -> None:
        self._check()
        self._check_rank(origin)
        self._check_rank(target)
        self._check_epoch(origin, target)

    def _staged(self, target: int, disp: int, data) -> torch.Tensor:
        """Origin data on the target memory's device, range-checked
        eagerly (the reference faults when it builds the descriptor)."""
        t = self._origin_data(data, self._region(target, disp, 0).device)
        self._region(target, disp, t.shape[0])
        return t

    def put(self, origin: int, target: int, data, target_disp: int = 0) -> None:
        self._open(origin, target)
        t = self._staged(target, target_disp, data)
        self._queue(_Descriptor("put", origin, target, target_disp, t.shape[0],
                                next(self._seq), data=t))

    def get(self, origin: int, target: int, count: int, target_disp: int = 0) -> RMARequest:
        """Queue a get; the request's value (a copy of the region)
        materializes at epoch close (MPI_Rget semantics)."""
        self._open(origin, target)
        self._region(target, target_disp, count)
        req = RMARequest()
        self._queue(_Descriptor("get", origin, target, target_disp, count,
                                next(self._seq), request=req))
        return req

    def accumulate(self, origin: int, target: int, data, target_disp: int = 0,
                   op: Op = SUM) -> None:
        self._open(origin, target)
        if op.torch_fn is None:
            raise MPIArgError(f"{op.name} has no tensor kernel")
        t = self._staged(target, target_disp, data)
        self._queue(_Descriptor("acc", origin, target, target_disp, t.shape[0],
                                next(self._seq), data=t, op=op))

    def get_accumulate(self, origin: int, target: int, data, target_disp: int = 0,
                       op: Op = SUM) -> RMARequest:
        """Atomic read-modify-write; the request delivers the value before
        the op.  ``op=NO_OP`` is the atomic get."""
        self._open(origin, target)
        if op is not NO_OP and op.torch_fn is None:
            raise MPIArgError(f"{op.name} has no tensor kernel")
        t = self._staged(target, target_disp, data)
        req = RMARequest()
        self._queue(_Descriptor("get_acc", origin, target, target_disp, t.shape[0],
                                next(self._seq), data=t, op=op, request=req))
        return req

    def fetch_and_op(self, origin: int, target: int, value, target_disp: int = 0,
                     op: Op = SUM) -> RMARequest:
        """Single-element get_accumulate (the hot atomic)."""
        return self.get_accumulate(origin, target, [value], target_disp, op)

    def compare_and_swap(self, origin: int, target: int, value, compare,
                         target_disp: int = 0) -> RMARequest:
        self._open(origin, target)
        dev = self._region(target, target_disp, 1).device
        req = RMARequest()
        self._queue(_Descriptor(
            "cas", origin, target, target_disp, 1, next(self._seq),
            data=self._origin_data([value], dev),
            compare=self._origin_data([compare], dev), request=req))
        return req

    # r-variants: the same queueing; the request completes at the next
    # flush/sync covering it (put/acc deliver None)

    def rput(self, origin: int, target: int, data, target_disp: int = 0) -> RMARequest:
        self.put(origin, target, data, target_disp)
        req = self._pending[-1].request = RMARequest()
        return req

    def rget(self, origin: int, target: int, count: int, target_disp: int = 0) -> RMARequest:
        return self.get(origin, target, count, target_disp)

    def raccumulate(self, origin: int, target: int, data, target_disp: int = 0,
                    op: Op = SUM) -> RMARequest:
        self.accumulate(origin, target, data, target_disp, op)
        req = self._pending[-1].request = RMARequest()
        return req

    def rget_accumulate(self, origin: int, target: int, data, target_disp: int = 0,
                        op: Op = SUM) -> RMARequest:
        return self.get_accumulate(origin, target, data, target_disp, op)

    # -- descriptor application (the epoch program) ------------------------------

    def _fetched(self, value: torch.Tensor, origin: int) -> torch.Tensor:
        """A fetched value where the origin holds it: on the devices
        layout the origin's device, else where the memory is."""
        if self._sharded and value.device != self.comm.mesh.devices[origin]:
            return value.to(self.comm.mesh.devices[origin])
        return value

    def _apply(self, descs: list[_Descriptor], parties: Sequence[int] = ()) -> None:
        """Apply descriptors in global issue order, on the memory's device;
        then order the cards the batch touched and those of the ranks
        ``parties`` (see the module docstring) and complete the requests."""
        done, cards = [], set()
        for d in sorted(descs, key=lambda d: d.seq):
            r = self._region(d.target, d.disp, d.count)
            value = None
            if d.kind == "put":
                r.copy_(d.data)
            elif d.kind == "get":
                value = r.clone()
            elif d.kind == "acc":
                r.copy_(d.data if d.op is REPLACE else d.op.torch_fn(r, d.data))
            elif d.kind == "get_acc":
                value = r.clone()
                if d.op is not NO_OP:
                    r.copy_(d.data if d.op is REPLACE else d.op.torch_fn(value, d.data))
            elif d.kind == "cas":
                old = r.clone()
                r.copy_(torch.where(old == d.compare, d.data, old))
                value = old[0]
            if value is not None:
                value = self._fetched(value, d.origin)
            cards.update(t.device.index for t in (r, value)
                         if t is not None and t.device.type == "cuda")
            if d.request is not None:
                done.append((d.request, value))
        cards.update(self.comm.mesh.devices[p].index for p in parties
                     if self.comm.mesh.devices[p].type == "cuda")
        events = _order_cards(cards) if cards else {}
        for req, value in done:
            on_card = value is not None and value.device.type == "cuda"
            req._deliver(value, events.get(value.device.index) if on_card else None)

    def _drain(self, pred, parties: Sequence[int] = ()) -> None:
        hit = [d for d in self._pending if pred(d)]
        if hit:
            self._pending = [d for d in self._pending if not pred(d)]
            self._apply(hit, parties)

    # -- synchronization: fence --------------------------------------------------

    def fence(self, assertion: int = 0) -> None:
        """Collective fence: closes the previous fence epoch (applying every
        queued descriptor) and opens the next one."""
        self._check()
        e = self._epoch
        if e.access or any(e.locks[r] for r in e.locks) or e.lock_all:
            raise MPIRMASyncError("fence while PSCW/lock epoch active")
        self._drain(lambda d: True, range(self.comm.size))
        self.comm.barrier()
        e.fence_active = not (assertion & MODE_NOSUCCEED)

    # -- synchronization: PSCW ---------------------------------------------------

    def start(self, origin: int, targets: Sequence[int], assertion: int = 0) -> None:
        """MPI_Win_start: open an access epoch at origin for targets."""
        self._check()
        self._check_rank(origin)
        if origin in self._epoch.access:
            raise MPIRMASyncError(f"rank {origin} already in an access epoch")
        for t in targets:
            self._check_rank(t)
        self._epoch.access[origin] = set(targets)
        if assertion & MODE_NOCHECK:
            self._epoch.access_nocheck.add(origin)

    def post(self, target: int, origins: Sequence[int], assertion: int = 0) -> None:
        """MPI_Win_post: open an exposure epoch at target for origins."""
        self._check()
        self._check_rank(target)
        if target in self._epoch.exposure:
            raise MPIRMASyncError(f"rank {target} already in an exposure epoch")
        for o in origins:
            self._check_rank(o)
        self._epoch.exposure[target] = set(origins)

    def complete(self, origin: int) -> None:
        """MPI_Win_complete: close origin's access epoch, applying its ops."""
        self._check()
        if origin not in self._epoch.access:
            raise MPIRMASyncError(f"rank {origin} has no access epoch")
        targets = self._epoch.access.pop(origin)
        self._epoch.access_nocheck.discard(origin)
        self._drain(lambda d: d.origin == origin and d.target in targets, (origin,))

    def wait(self, target: int) -> None:
        """MPI_Win_wait: close target's exposure epoch; every origin of its
        group must have completed (an open one is the deadlock MPI hangs on)."""
        self._check()
        if target not in self._epoch.exposure:
            raise MPIRMASyncError(f"rank {target} has no exposure epoch")
        origins = self._epoch.exposure[target]
        still_open = [o for o in origins
                      if o in self._epoch.access and target in self._epoch.access[o]]
        if still_open:
            raise MPIRMASyncError(
                f"win_wait({target}) would deadlock: origins {still_open} "
                "have not called complete()")
        del self._epoch.exposure[target]

    def test(self, target: int) -> bool:
        """MPI_Win_test: non-blocking wait."""
        self._check()
        if target not in self._epoch.exposure:
            raise MPIRMASyncError(f"rank {target} has no exposure epoch")
        origins = self._epoch.exposure[target]
        if any(o in self._epoch.access and target in self._epoch.access[o] for o in origins):
            return False
        del self._epoch.exposure[target]
        return True

    # -- synchronization: passive target -----------------------------------------

    def lock(self, origin: int, target: int, lock_type: int = LOCK_SHARED,
             assertion: int = 0) -> None:
        self._check()
        self._check_rank(origin)
        self._check_rank(target)
        if lock_type not in (LOCK_SHARED, LOCK_EXCLUSIVE):
            raise MPIArgError(f"bad lock type {lock_type}")
        held = self._epoch.locks[target]
        if origin in held:
            raise MPIRMASyncError(f"rank {origin} already holds a lock on {target}")
        if lock_type == LOCK_EXCLUSIVE and (held or self._epoch.lock_all):
            # lock_all is a shared lock on every target
            raise MPIRMAConflictError(
                f"exclusive lock on {target} conflicts with holders "
                f"{sorted(held) or sorted(self._epoch.lock_all)}")
        if any(t == LOCK_EXCLUSIVE for t in held.values()):
            raise MPIRMAConflictError(f"rank {target} is exclusively locked")
        held[origin] = lock_type

    def unlock(self, origin: int, target: int) -> None:
        self._check()
        self._check_rank(origin)
        self._check_rank(target)
        if origin not in self._epoch.locks[target]:
            raise MPIRMASyncError(f"rank {origin} holds no lock on {target}")
        self._drain(lambda d: d.origin == origin and d.target == target, (origin,))
        del self._epoch.locks[target][origin]

    def lock_all(self, origin: int, assertion: int = 0) -> None:
        self._check()
        self._check_rank(origin)
        if origin in self._epoch.lock_all:
            raise MPIRMASyncError(f"rank {origin} already holds lock_all")
        excl = [t for t, held in self._epoch.locks.items()
                if any(ty == LOCK_EXCLUSIVE for ty in held.values())]
        if excl:
            raise MPIRMAConflictError(f"lock_all conflicts with exclusive locks on ranks {excl}")
        self._epoch.lock_all.add(origin)

    def unlock_all(self, origin: int) -> None:
        self._check()
        if origin not in self._epoch.lock_all:
            raise MPIRMASyncError(f"rank {origin} holds no lock_all")
        self._drain(lambda d: d.origin == origin, (origin,))
        self._epoch.lock_all.discard(origin)

    def flush(self, origin: int, target: int) -> None:
        """Complete every op from origin to target (the epoch stays open)."""
        self._check()
        self._check_rank(origin)
        self._check_rank(target)
        if origin not in self._epoch.locks[target] and origin not in self._epoch.lock_all:
            raise MPIRMASyncError("flush outside a passive-target epoch")
        self._drain(lambda d: d.origin == origin and d.target == target, (origin,))

    def flush_all(self, origin: int) -> None:
        self._check()
        if origin not in self._epoch.lock_all and not any(
                origin in self._epoch.locks[t] for t in self._epoch.locks):
            raise MPIRMASyncError("flush_all outside a passive-target epoch")
        self._drain(lambda d: d.origin == origin, (origin,))

    def flush_local(self, origin: int, target: int) -> None:
        """Origin-local completion: the origin data is copied when queued,
        so this is flush()."""
        self.flush(origin, target)

    def flush_local_all(self, origin: int) -> None:
        self.flush_all(origin)

    def sync(self, rank: int) -> None:
        """MPI_Win_sync: a no-op in the unified model of one address space."""
        self._check()
        self._check_rank(rank)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Win {self.name} flavor={self.flavor} sizes={self.sizes} "
                f"dtype={self.dtype} pending={len(self._pending)}>")
