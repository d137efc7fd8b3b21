"""Communicators — the MPI object model over the virtual-rank mesh.

Port of ``ompi_tpu/api/comm.py`` (single-process part).  One Python
process drives every rank, so a ``Comm`` is the whole communicator:
buffers are **rank-major**, the leading axis indexing the rank.  Each
comm owns a ``CommMesh`` (its ranks, as rows on one device) and a coll
table stacked from the selected coll components (cuda → device,
basic → host/jagged), built on first use.

Buffer flavours, as ``Comm._stage`` in the reference: numpy in → numpy
out (staged onto the mesh device and back), tensor in → tensor out
(stays on the device).  On a mesh with the ``devices`` layout (one
buffer per rank) a comm takes numpy (staged into
:class:`~ompi_tpu_torch.mesh.shards.RankShards`, row r on rank r's
device, and back) or ``RankShards`` (returned as ``RankShards``; a root
gather returns root's one tensor).  Everything runs there: every
collective in its blocking, i and init forms; point-to-point, whose
tensor payloads land on the receiver's device; windows, whose region r
lies on rank r's device; the typed (``*_ddt``) entry points, whose
tensor buffers are packed on each rank's own device; checkpoints; and
a ULFM shrink, whose survivors keep their devices.

Dispatch: an entry point checks its arguments once per call signature,
then asks the winning module's ``resolve()`` for the callable of that
signature and caches it under the MCA store's version, so later calls
are one dict hit plus the kernels.  The winner of the device slots is
``coll/tuned``, whose resolver bakes its algorithm decision into the
callable.  Persistent ``*_init`` plans come from the process-wide
schedule cache (:mod:`ompi_tpu_torch.coll.sched`), keyed by the comm's
shape (layout, every rank's device) so that a ``dup`` hits.  Entries with no resolver (barrier, the
jagged variants, ``reduce_scatter``) take the table path.

Observability hooks, each one flag test when off: SPC counts every
collective once (here on the fast path, in ``CollTable.lookup`` on the
table path); with tracing on, each entry records an ``api`` span keyed
(comm, op, seq), timed on the host.

Beyond the collectives: point-to-point through the comm's pml engine
(single-controller form — each call names both endpoints), persistent
and partitioned channels (:class:`~ompi_tpu_torch.p2p.part.PersistentP2PMixin`),
the ``win_*`` window constructors (osc), ``file_open`` (io), the
datatype-typed ``allreduce_ddt``/``bcast_ddt`` (convertor pack → the
collective on the leaf dtype → unpack, on the buffers' own device),
errhandlers and attribute caching, and the ULFM surface (``revoke``,
``shrink``, ``agree``, ``get_failed``, ``ack_failed``, ``is_revoked``):
every collective entry and every point-to-point call checks the comm's
fault-tolerance state first, one attribute test while no failure was
ever injected.  Intercommunicators and topologies build on ``Comm`` in
:mod:`~ompi_tpu_torch.api.intercomm` and :mod:`~ompi_tpu_torch.api.topo`.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np
import torch

from ompi_tpu_torch.coll import sched
from ompi_tpu_torch.coll.module import CollTable, select_coll_modules
from ompi_tpu_torch.core import mca
from ompi_tpu_torch.core import errors as _errors
from ompi_tpu_torch.core.errors import (
    MPIArgError,
    MPICommError,
    MPIKeyvalError,
    MPIRankError,
    MPIRootError,
    MPITypeError,
)
from ompi_tpu_torch.ddt.convertor import pack as ddt_pack
from ompi_tpu_torch.ddt.convertor import packed_to_typed, typed_to_packed
from ompi_tpu_torch.ddt.convertor import unpack as ddt_unpack
from ompi_tpu_torch.ddt.datatype import Datatype, from_torch_dtype, to_numpy, torch_dtype
from ompi_tpu_torch.ft import ulfm
from ompi_tpu_torch.mesh.mesh import CommMesh
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op.op import SUM, Op
from ompi_tpu_torch.p2p.part import PersistentP2PMixin
from ompi_tpu_torch.p2p.pml import ANY_SOURCE, ANY_TAG
from ompi_tpu_torch.request import (
    ArrayRequest,
    CompletedRequest,
    PersistentRequest,
    Request,
    _poll_backoff,
)
from ompi_tpu_torch.tool import spc
from ompi_tpu_torch.trace import core as _trace

from .group import UNDEFINED, Group

#: MPI_Comm_split color for "give me no communicator"
COLOR_UNDEFINED = UNDEFINED

#: (op, dtype) pairs whose arg check already passed
_OP_CHECK_OK: set[tuple] = set()

_cid_next = 0
_cid_lock = threading.Lock()


def _next_cid() -> int:
    global _cid_next
    with _cid_lock:
        c = _cid_next
        _cid_next += 1
        return c


def _peek_cid() -> int:
    """The next CID this process would hand out — the proposal each
    process contributes to the multi-process CID agreement."""
    with _cid_lock:
        return _cid_next


def _reserve_cid_block(floor: int, n: int) -> int:
    """Multi-process CID agreement commit (≈ ompi_comm_nextcid's
    MAX-allreduce): having agreed ``floor`` = max over processes of
    ``_peek_cid()``, every participant reserves the identical block
    ``[floor, floor + n)`` and jumps its local counter past it."""
    global _cid_next
    with _cid_lock:
        _cid_next = max(_cid_next, floor + n)
        return floor


class Comm(PersistentP2PMixin):
    """An intra-communicator over virtual ranks."""

    def __init__(self, group: Group, mesh: CommMesh, name: str = ""):
        if group.size != mesh.size:
            raise MPICommError(f"group size {group.size} != mesh size {mesh.size}")
        self.group = group
        self.mesh = mesh
        self.cid = _next_cid()
        self.name = name or f"comm#{self.cid}"
        self._coll: CollTable | None = None
        self._pml = None
        self._attrs: dict[int, Any] = {}
        self._errhandler = _errors.ERRORS_RETURN
        self._freed = False
        #: ULFM state, created by the first failure or revoke
        self._ft = None
        #: dispatch cache: key → (mca context, store version, callable)
        self._fast: dict[tuple, tuple] = {}

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _check(self):
        if self._freed:
            raise MPICommError(f"{self.name} has been freed")

    @property
    def coll(self) -> CollTable:
        """Per-comm coll table, built on first use."""
        self._check()
        if self._coll is None:
            self._coll = select_coll_modules(self, mca.default_context().framework("coll"))
        return self._coll

    def set_name(self, name: str) -> None:
        self.name = name

    @property
    def pml(self):
        """The comm's matching engine, from the selected pml component."""
        self._check()
        if self._pml is None:
            comp = mca.default_context().framework("pml").select_one()
            self._pml = comp.make_engine(self.size, self.name)
        return self._pml

    # -- errhandlers and attribute caching -----------------------------------

    def set_errhandler(self, errhandler) -> None:
        """MPI_Comm_set_errhandler.  The Python surface raises typed
        exceptions either way (≈ ERRORS_RETURN)."""
        if not isinstance(errhandler, _errors.Errhandler):
            raise MPIArgError(f"not an Errhandler: {errhandler!r}")
        self._errhandler = errhandler

    def get_errhandler(self):
        """MPI_Comm_get_errhandler (default ERRORS_RETURN)."""
        return self._errhandler

    def set_attr(self, keyval: int, value: Any) -> None:
        self._check()
        self._attrs[keyval] = value

    def get_attr(self, keyval: int) -> Any:
        self._check()
        if keyval not in self._attrs:
            raise MPIKeyvalError(f"no attribute {keyval}")
        return self._attrs[keyval]

    def delete_attr(self, keyval: int) -> None:
        self._check()
        self._attrs.pop(keyval, None)

    # -- construction (dup/split/create) -----------------------------------

    def _inherit(self, c: "Comm") -> "Comm":
        """dup/create/split inherit the errhandler (MPI-4 §9.5)."""
        c._errhandler = self._errhandler
        return c

    def dup(self, name: str = "") -> "Comm":
        self._check()
        return self._inherit(Comm(Group(self.group.ranks), self.mesh, name or f"{self.name}.dup"))

    def create_group(self, group: Group, name: str = "") -> "Comm | None":
        """MPI_Comm_create_group over a subset of this comm's ranks."""
        self._check()
        for r in group.ranks:
            if not 0 <= r < self.size:
                raise MPIRankError(f"rank {r} outside {self.name}")
        if group.size == 0:
            return None
        sub = self.mesh.submesh(group.ranks)
        world_ranks = [self.group.ranks[r] for r in group.ranks]
        return self._inherit(Comm(Group(world_ranks), sub, name))

    def split(self, colors: Sequence[int],
              keys: Sequence[int] | None = None) -> list["Comm | None"]:
        """MPI_Comm_split, whole-communicator view: ``colors[r]``/``keys[r]``
        are rank r's arguments; ranks sharing a color share the object."""
        self._check()
        if len(colors) != self.size:
            raise MPIArgError("colors length != comm size")
        keys = [0] * self.size if keys is None else keys
        if len(keys) != self.size:
            raise MPIArgError("keys length != comm size")
        by_color: dict[int, list[int]] = {}
        for r, c in enumerate(colors):
            if c == COLOR_UNDEFINED:
                continue
            if c < 0:
                raise MPIArgError(f"negative color {c}")
            by_color.setdefault(c, []).append(r)
        out: list[Comm | None] = [None] * self.size
        for c, members in sorted(by_color.items()):
            members.sort(key=lambda r: (keys[r], r))
            comm = self.create_group(Group(members), name=f"{self.name}.split({c})")
            for r in members:
                out[r] = comm
        return out

    def split_type_shared(self) -> "Comm":
        """MPI_Comm_split_type(MPI_COMM_TYPE_SHARED): every rank shares
        one device, so the whole comm is one shared domain."""
        return self.dup(name=f"{self.name}.shared")

    # -- ULFM (MPIX_Comm_*) --------------------------------------------------

    def _shrink_to(self, live: Sequence[int], name: str = "") -> "Comm":
        """ULFM shrink substrate: a fresh communicator over the live rank
        subset, renumbered contiguously, its mesh the live ranks' submesh.
        Unlike create_group this works on revoked comms — shrink is the
        recovery path — so no FT guard here.  On the devices layout
        every survivor keeps its device."""
        self._check()
        sub = self.mesh.submesh(list(live))
        world_ranks = [self.group.ranks[r] for r in live]
        return Comm(Group(world_ranks), sub, name or f"{self.name}.shrunk")

    def revoke(self) -> None:
        """MPIX_Comm_revoke."""
        ulfm.revoke(self)

    def shrink(self, name: str = "") -> "Comm":
        """MPIX_Comm_shrink."""
        return ulfm.shrink(self, name)

    def agree(self, flags: int, contributions=None) -> int:
        """MPIX_Comm_agree."""
        return ulfm.agree(self, flags, contributions)

    def get_failed(self) -> list[int]:
        """MPIX_Comm_get_failed."""
        return ulfm.get_failed(self)

    def ack_failed(self) -> int:
        """MPIX_Comm_ack_failed."""
        return ulfm.ack_failed(self)

    def is_revoked(self) -> bool:
        """MPIX_Comm_is_revoked."""
        return ulfm.is_revoked(self)

    # -- one-sided windows (osc) and MPI-IO ----------------------------------

    def _osc(self):
        return mca.default_context().framework("osc").select_one()

    def win_create(self, bases, name: str = ""):
        """MPI_Win_create: expose per-rank 1-D buffers (aliased) for RMA."""
        self._check()
        return self._osc().win_create(self, bases, name=name)

    def win_allocate(self, size: int, dtype=torch.float32, name: str = ""):
        """MPI_Win_allocate: window memory on the comm's device."""
        self._check()
        return self._osc().win_allocate(self, size, dtype, name=name)

    def win_allocate_shared(self, size: int, dtype=torch.float32, name: str = ""):
        self._check()
        return self._osc().win_allocate_shared(self, size, dtype, name=name)

    def win_create_dynamic(self, dtype=torch.float32, name: str = ""):
        self._check()
        return self._osc().win_create_dynamic(self, dtype, name=name)

    def file_open(self, path: str, amode: int, hints: dict | None = None):
        """MPI_File_open through the selected io component (io/ompio);
        ``hints`` are MPI_Info key/values (striping_factor/unit)."""
        self._check()
        comp = mca.default_context().framework("io").select_one()
        return comp.file_open(self, path, amode, hints=hints)

    def free(self) -> None:
        self._check()
        if self._coll is not None:
            for m in self._coll.modules:
                m.disable()
        self._coll = None
        self._fast.clear()
        self._freed = True

    # -- buffer staging ----------------------------------------------------

    def _stage(self, x, depth: int):
        """Normalize a rank-major input; returns (tensor, was_host)."""
        if self.mesh.layout == "devices":
            return self._stage_shards(x, depth)
        if isinstance(x, torch.Tensor):
            if x.dim() < depth or x.shape[0] != self.size:
                raise MPIArgError(
                    f"rank-major buffer must have shape ({self.size}, ...); "
                    f"got {tuple(x.shape)}")
            if x.device != self.mesh.device:
                x = x.to(self.mesh.device)
            return x.contiguous(), False
        arr = np.asarray(x)
        if arr.ndim < depth or arr.shape[0] != self.size:
            raise MPIArgError(
                f"rank-major buffer must have shape ({self.size}, ...); got {arr.shape}")
        return self.mesh.stage_in(arr), True

    def _stage_shards(self, x, depth: int):
        """The devices layout's inputs: ``RankShards`` on the mesh's
        devices as they are, numpy staged one row per rank's device."""
        if isinstance(x, RankShards):
            if len(x.shape) < depth or x.size != self.size:
                raise MPIArgError(
                    f"rank-major buffer must have shape ({self.size}, ...); got {x.shape}")
            if x.devices != self.mesh.devices:
                raise MPIArgError(
                    f"shards lie on {[str(d) for d in x.devices]}, the comm's ranks on "
                    f"{[str(d) for d in self.mesh.devices]}: nothing is moved implicitly")
            return x, False
        if isinstance(x, torch.Tensor):
            raise MPIArgError("a devices-layout comm takes numpy or RankShards, "
                              "not one tensor")
        arr = np.asarray(x)
        if arr.ndim < depth or arr.shape[0] != self.size:
            raise MPIArgError(
                f"rank-major buffer must have shape ({self.size}, ...); got {arr.shape}")
        return self.mesh.stage_in(arr), True

    def _unstage(self, out, host: bool):
        if host and isinstance(out, (torch.Tensor, RankShards)):
            return self.mesh.stage_out(out)
        return out

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self.size:
            raise MPIRootError(f"root {root} not in [0, {self.size})")

    def _check_op(self, op: Op, x) -> None:
        """Reject op × dtype pairs the standard forbids, once per pair."""
        if not isinstance(op, Op):
            raise MPIArgError(f"op must be an ompi_tpu_torch Op, got {type(op)}")
        dtype = getattr(x, "dtype", None)
        if dtype is None or (op, dtype) in _OP_CHECK_OK:
            return
        tdt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
        op.check(from_torch_dtype(tdt))
        if len(_OP_CHECK_OK) > 4096:  # user-op churn backstop
            _OP_CHECK_OK.clear()
        _OP_CHECK_OK.add((op, dtype))

    # -- dispatch ------------------------------------------------------------

    def _resolved(self, slot: str, base: str, args: tuple, key: tuple):
        """The slot owner's callable for this call signature, or None
        when the owner exposes no resolver (coll/basic, sync, monitoring)
        — then the caller takes the table path, which counts the call.
        The context is read as ``mca._default``, as the reference's fast
        path does: ``default_context()`` would re-scan the component
        registry on every call."""
        ctx = mca._default or mca.default_context()
        ent = self._fast.get(key)
        if ent is not None and ent[0] is ctx and ent[1] == ctx.store.version:
            if spc._attached:  # inlined flag test: this is the hot loop
                spc.inc(slot)
            return ent[2]
        resolve = getattr(self.coll.owners.get(slot), "resolve", None)
        fn = resolve(base, *args) if resolve is not None else None
        if fn is None:
            return None
        if len(self._fast) > 4096:  # user-op churn backstop
            self._fast.clear()
        self._fast[key] = (ctx, ctx.store.version, fn)
        spc.inc(slot)
        return fn

    def _prepare(self, base: str, x, depth: int, op: Op | None, root: int | None):
        self._check()
        if self._ft is not None:
            ulfm.check(self, collective=True)
        if op is not None:
            self._check_op(op, x)
        if root is not None:
            self._check_root(root)
        xd, host = self._stage(x, depth)
        args = (xd,) + ((op,) if op is not None else ()) \
            + ((root,) if root is not None else ())
        return xd, host, args, (base, op, root, tuple(xd.shape), xd.dtype)

    def _call(self, base: str, x, depth: int, op: Op | None = None,
              root: int | None = None):
        xd, host, args, key = self._prepare(base, x, depth, op, root)
        t0 = _trace.now() if _trace._enabled else 0
        fn = self._resolved(base, base, args, key)
        out = fn(xd) if fn is not None else self.coll.lookup(base)(*args)
        if t0:
            _trace.complete("api", base, t0, comm=self.name,
                            seq=_trace.next_seq(self.name, base),
                            nbytes=spc.payload_nbytes(xd))
        return self._unstage(out, host)

    def _icall(self, base: str, x, depth: int, op: Op | None = None,
               root: int | None = None) -> Request:
        slot = "i" + base
        xd, host, args, key = self._prepare(base, x, depth, op, root)
        t0 = _trace.now() if _trace._enabled else 0
        fn = self._resolved(slot, base, args, key)
        req = (ArrayRequest(fn(xd)) if fn is not None
               else self.coll.lookup(slot)(*args))
        if t0:
            _trace.complete("api", slot, t0, comm=self.name,
                            seq=_trace.next_seq(self.name, slot),
                            nbytes=spc.payload_nbytes(xd))
        return _wrap_unstage(req, self, host)

    def _init(self, base: str, x, depth: int, op: Op | None = None,
              root: int | None = None) -> Request:
        """Persistent collective: staged once, its plan taken from the
        process-wide schedule cache, each ``start()`` re-dispatching on
        the same buffer."""
        xd, host, args, _ = self._prepare(base, x, depth, op, root)
        fn = self._sched_fn(base, args, op, root)
        if fn is None:
            return self._lookup(base + "_init")(*args)
        return PersistentRequest(
            lambda: _wrap_unstage(ArrayRequest(fn(xd)), self, host))

    def _sched_fn(self, base: str, args: tuple, op: Op | None, root: int | None):
        """The persistent plan from :mod:`~ompi_tpu_torch.coll.sched`,
        keyed by the comm's shape (layout, every rank's device) and never
        its identity, so a fresh comm over the same devices replays the
        plan and one over other devices does not; None when the owner
        exposes no resolver."""
        resolve = getattr(self.coll.owners.get(base), "resolve", None)
        if resolve is None:
            return None
        xd = args[0]
        key = ("pers", base, self.mesh.layout, tuple(str(d) for d in self.mesh.devices),
               op, root, tuple(xd.shape), str(xd.dtype), mca.default_context().store.version)
        return sched.lookup(key, lambda: resolve(base, *args))

    def _lookup(self, slot: str):
        """Table-path entry: the slot's callable, in an ``api`` span when
        tracing (the table's own lookup counts SPC and adds the coll
        span).  With :meth:`_prepare`, the ULFM collective guard's only
        site."""
        if self._ft is not None:
            ulfm.check(self, collective=True)
        fn = self.coll.lookup(slot)
        if _trace._enabled:
            return _trace.wrap_call("api", slot, fn, comm=self.name)
        return fn

    # -- collectives ---------------------------------------------------------

    def allreduce(self, x, op: Op = SUM):
        return self._call("allreduce", x, 1, op=op)

    def iallreduce(self, x, op: Op = SUM) -> Request:
        return self._icall("allreduce", x, 1, op=op)

    def allreduce_init(self, x, op: Op = SUM) -> Request:
        return self._init("allreduce", x, 1, op=op)

    def bcast(self, x, root: int = 0):
        return self._call("bcast", x, 1, root=root)

    def ibcast(self, x, root: int = 0) -> Request:
        return self._icall("bcast", x, 1, root=root)

    def bcast_init(self, x, root: int = 0) -> Request:
        return self._init("bcast", x, 1, root=root)

    def reduce(self, x, op: Op = SUM, root: int = 0):
        """Returns root's recvbuf (the only one the standard defines)."""
        return self._call("reduce", x, 1, op=op, root=root)[root]

    def ireduce(self, x, op: Op = SUM, root: int = 0) -> Request:
        return _select(self._icall("reduce", x, 1, op=op, root=root), root)

    def reduce_init(self, x, op: Op = SUM, root: int = 0) -> Request:
        return _PersistentSelect(self._init("reduce", x, 1, op=op, root=root), root)

    def allgather(self, x):
        return self._call("allgather", x, 1)

    def iallgather(self, x) -> Request:
        return self._icall("allgather", x, 1)

    def allgather_init(self, x) -> Request:
        return self._init("allgather", x, 1)

    def gather(self, x, root: int = 0):
        """Root's recvbuf: the (n, *s) gathered blocks."""
        return self._call("gather", x, 1, root=root)

    def igather(self, x, root: int = 0) -> Request:
        return self._icall("gather", x, 1, root=root)

    def gather_init(self, x, root: int = 0) -> Request:
        return self._init("gather", x, 1, root=root)

    def scatter(self, x, root: int = 0):
        """x: root's sendbuf (n, *s) → (n, *s), row r is rank r's recvbuf."""
        return self._call("scatter", x, 1, root=root)

    def iscatter(self, x, root: int = 0) -> Request:
        return self._icall("scatter", x, 1, root=root)

    def scatter_init(self, x, root: int = 0) -> Request:
        return self._init("scatter", x, 1, root=root)

    def reduce_scatter_block(self, x, op: Op = SUM):
        return self._call("reduce_scatter_block", x, 2, op=op)

    def ireduce_scatter_block(self, x, op: Op = SUM) -> Request:
        return self._icall("reduce_scatter_block", x, 2, op=op)

    def reduce_scatter_block_init(self, x, op: Op = SUM) -> Request:
        return self._init("reduce_scatter_block", x, 2, op=op)

    def reduce_scatter(self, x, op: Op = SUM, counts: Sequence[int] | None = None):
        """MPI_Reduce_scatter, through the table as in the reference:
        jagged ``counts`` → host path (list results); equal counts c →
        (n, n*c, …) sendbufs reduced as blocks, returning (n, c, …);
        counts=None → x is (n, n, *s)."""
        self._check()
        self._check_op(op, x)
        if counts is not None:
            if len(counts) != self.size:
                raise MPIArgError("reduce_scatter counts length != comm size")
            if len(set(counts)) > 1:
                # the host path: a devices-layout buffer's shards copied in
                host = x if isinstance(x, (torch.Tensor, RankShards)) else np.asarray(x)
                return self._lookup("reduce_scatter")(host, op, list(counts))
            c = counts[0]
            if x.shape[1] != self.size * c:
                raise MPIArgError(
                    f"reduce_scatter sendbuf dim1 {x.shape[1]} != n*count {self.size * c}")
            blocks = _blocked(x, (self.size, c))
            xd, host = self._stage(blocks, 2)
            return self._unstage(self._lookup("reduce_scatter_block")(xd, op), host)
        xd, host = self._stage(x, 2)
        return self._unstage(self._lookup("reduce_scatter")(xd, op, None), host)

    def alltoall(self, x):
        return self._call("alltoall", x, 2)

    def ialltoall(self, x) -> Request:
        return self._icall("alltoall", x, 2)

    def alltoall_init(self, x) -> Request:
        return self._init("alltoall", x, 2)

    def scan(self, x, op: Op = SUM):
        return self._call("scan", x, 1, op=op)

    def iscan(self, x, op: Op = SUM) -> Request:
        return self._icall("scan", x, 1, op=op)

    def scan_init(self, x, op: Op = SUM) -> Request:
        return self._init("scan", x, 1, op=op)

    def exscan(self, x, op: Op = SUM):
        return self._call("exscan", x, 1, op=op)

    def iexscan(self, x, op: Op = SUM) -> Request:
        return self._icall("exscan", x, 1, op=op)

    def exscan_init(self, x, op: Op = SUM) -> Request:
        return self._init("exscan", x, 1, op=op)

    def barrier(self) -> None:
        self._lookup("barrier")()

    def ibarrier(self) -> Request:
        return self._lookup("ibarrier")()

    def barrier_init(self) -> Request:
        return self._lookup("barrier_init")()

    # jagged variants (host path)
    def allgatherv(self, blocks):
        if len(blocks) != self.size:
            raise MPIArgError("allgatherv needs one block per rank")
        return self._lookup("allgatherv")(blocks)

    def alltoallv(self, matrix):
        if len(matrix) != self.size:
            raise MPIArgError("alltoallv needs n rows")
        return self._lookup("alltoallv")(matrix)

    def gatherv(self, blocks, root: int = 0):
        self._check_root(root)
        return self._lookup("gatherv")(blocks, root)

    def scatterv(self, blocks, root: int = 0):
        self._check_root(root)
        return self._lookup("scatterv")(blocks, root)

    # -- point-to-point (pml) ------------------------------------------------

    def send(self, buf, source: int, dest: int, tag: int = 0) -> None:
        """MPI_Send from rank ``source`` to ``dest``.  Eager-buffered:
        returns at once, the sender's buffer reusable.  On the devices
        layout a tensor payload is copied onto ``dest``'s device."""
        if self._ft is not None:
            ulfm.check(self, peer=dest)
        dest_dev = (self.mesh.devices[dest]
                    if self.mesh.layout == "devices" and isinstance(buf, torch.Tensor)
                    and 0 <= dest < self.size else None)
        self.pml.send(source, dest, buf, tag, dest_dev)

    def isend(self, buf, source: int, dest: int, tag: int = 0) -> Request:
        self.send(buf, source, dest, tag)
        return CompletedRequest()  # an eager send completes locally

    def irecv(self, dest: int, source: int | None = None, tag: int | None = None) -> Request:
        if self._ft is not None:
            ulfm.check(self, peer=source, any_source=source is None)
        return self.pml.irecv(dest, ANY_SOURCE if source is None else source,
                              ANY_TAG if tag is None else tag)

    def recv(self, dest: int, source: int | None = None, tag: int | None = None):
        """MPI_Recv at rank ``dest``; returns (payload, Status)."""
        req = self.irecv(dest, source, tag)
        payload = req.wait()
        return payload, req.status

    def sendrecv(self, sendbuf, source: int, dest: int, recv_source: int,
                 sendtag: int = 0, recvtag: int | None = None):
        """MPI_Sendrecv at rank ``source``: send to ``dest``, receive from
        ``recv_source``; deadlock-free by eager buffering."""
        self.send(sendbuf, source, dest, sendtag)
        return self.recv(source, recv_source, recvtag)

    def probe(self, dest: int, source: int | None = None, tag: int | None = None):
        """MPI_Probe (blocking): wait for a matching envelope."""
        sleep = 0.0
        while True:
            st = self.iprobe(dest, source, tag)
            if st is not None:
                return st
            sleep = _poll_backoff(sleep)

    def iprobe(self, dest: int, source: int | None = None, tag: int | None = None):
        if self._ft is not None:
            # guarded here (not only in irecv) so a blocking probe raises
            # instead of spinning forever on a revoked comm or a dead peer
            ulfm.check(self, peer=source, any_source=source is None)
        return self.pml.iprobe(dest, ANY_SOURCE if source is None else source,
                               ANY_TAG if tag is None else tag)

    # -- datatype (convertor) entry points -------------------------------------

    def allreduce_ddt(self, sendbufs: Sequence[Any], count: int, datatype: Datatype,
                      op: Op = SUM, recvbufs: Sequence[Any] | None = None):
        """MPI_Allreduce over typed byte buffers: each rank's buffer is
        packed by the convertor, the packed rows are reduced in the leaf
        dtype, and unpacked into ``recvbufs`` (or returned packed).
        Tensors are packed on their own device and reduced there, so
        nothing crosses to the host: stacked into one tensor on the rows
        layout, into ``RankShards`` on the devices layout, where rank r's
        tensors must lie on rank r's device.  Numpy buffers stay numpy, as
        in the reference."""
        op.check(datatype)
        if len(sendbufs) != self.size:
            raise MPIArgError("one send buffer per rank required")
        if datatype.uniform_leaf is None:
            raise MPITypeError("reductions need a uniform-leaf datatype")
        for r, b in enumerate(sendbufs):
            self.mesh.check_placed(r, b, "send buffer")
        packed = [packed_to_typed(ddt_pack(b, datatype, count), datatype, count)
                  for b in sendbufs]
        if not all(isinstance(p, torch.Tensor) for p in packed):
            stacked = np.stack([to_numpy(p) if isinstance(p, torch.Tensor) else p
                                for p in packed])
        elif self.mesh.layout == "devices":
            stacked = RankShards(packed)  # (n, count*leaves), row r on rank r's device
        else:
            stacked = torch.stack(packed)  # (n, count*leaves) on the device
        red = self.allreduce(stacked, op)
        if recvbufs is None:
            return red
        if len(recvbufs) != self.size:
            raise MPIArgError("one recv buffer per rank required")
        for r, b in enumerate(recvbufs):
            self.mesh.check_placed(r, b, "recv buffer")
        for r in range(self.size):
            ddt_unpack(recvbufs[r], datatype, count, typed_to_packed(red[r]))
        return recvbufs

    def bcast_ddt(self, buf, count: int, datatype: Datatype, root: int = 0):
        """Typed bcast: packs root's buffer, broadcasts it and returns each
        rank's unpacked byte buffer: numpy for numpy, a tensor on the
        buffer's device (rows layout) or on each rank's own device
        (devices layout, where root's tensor must lie on root's)."""
        self._check_root(root)
        self.mesh.check_placed(root, buf, "bcast buffer")
        packed = ddt_pack(buf, datatype, count)
        nbytes = datatype.lb + datatype.span(count)
        if not isinstance(packed, torch.Tensor):
            out = np.asarray(self.bcast(np.stack([packed] * self.size), root))
            dsts = [np.zeros(nbytes, np.uint8) for _ in range(self.size)]
        elif self.mesh.layout == "devices":
            rows = [packed if r == root else torch.zeros_like(packed, device=d)
                    for r, d in enumerate(self.mesh.devices)]
            out = self.bcast(RankShards(rows), root)
            dsts = [torch.zeros(nbytes, dtype=torch.uint8, device=d) for d in self.mesh.devices]
        else:
            out = self.bcast(torch.stack([packed] * self.size), root)
            dsts = [torch.zeros(nbytes, dtype=torch.uint8, device=packed.device)
                    for _ in range(self.size)]
        for r, dst in enumerate(dsts):
            ddt_unpack(dst, datatype, count, typed_to_packed(out[r]))
        return dsts

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Comm {self.name} size={self.size} cid={self.cid} on {self.device}>"


class _Chained(Request):
    """A request whose result is ``post`` applied to an inner request's."""

    def __init__(self, inner: Request, post):
        super().__init__()
        self._inner = inner
        self._post = post

    def _poll(self) -> bool:
        return self._inner.test()

    def _block(self) -> None:
        self._inner.wait()

    def _finalize(self) -> Any:
        return self._post(self._inner.wait())


class _Unstage(_Chained):
    """The D2H copy of a host caller's result (the reference's class
    name, which names its ``request`` wait span)."""


def _wrap_unstage(req: Request, comm: Comm, host: bool) -> Request:
    """Chain the D2H copy onto a device request for host callers."""
    return _Unstage(req, lambda out: comm._unstage(out, True)) if host else req


def _blocked(x, lead: tuple):
    """An equal-count reduce_scatter's sendbufs ``(n, n*c, …)`` as the
    ``(n, n, c, …)`` blocks of reduce_scatter_block, shard by shard on
    the devices layout."""
    if isinstance(x, RankShards):
        return RankShards([s.reshape(lead + tuple(s.shape[1:])) for s in x.shards])
    return x.reshape((x.shape[0],) + lead + tuple(x.shape[2:]))


def _select(req: Request, root: int) -> Request:
    return _Chained(req, lambda out: out[root])


class _PersistentSelect(Request):
    """A persistent reduce whose result is root's row."""

    def __init__(self, inner: Request, root: int):
        super().__init__()
        self._inner = inner
        self._root = root
        self._complete = True

    def start(self) -> "_PersistentSelect":
        self._inner.start()
        self._complete = False
        return self

    def _poll(self) -> bool:
        return self._inner.test()

    def _block(self) -> None:
        self._inner.wait()

    def _finalize(self) -> Any:
        return self._inner.wait()[self._root]
