"""Multi-process communicators.

Port of ``ompi_tpu/api/multiproc.py``.  A ``tpurun`` job is P worker
processes, each owning a slice of the global rank space (its virtual
ranks: rows of rank-major tensors on the process's device).  Global
rank space is the ordered concatenation of each process's local ranks.
Collectives go through the MCA coll selection exactly like
single-process comms — ``coll/han`` wins on these communicators and
composes the local collectives on the card with inter-process DCN
traffic; ``coll/cuda``/``coll/basic`` (and so ``coll/tuned``) decline
them.

p2p runs on one of two planes.  On the native engine with the default
``eager`` pml, the C matcher holds this process's posted/unexpected
queues: remote sends ride a cached per-peer channel and a blocked
receive sleeps in C.  Otherwise (a Python transport, or an interposed
pml: monitoring, vprotocol) the Python matching engine holds them and
remote sends travel as DCN frames injected by the receiver thread — the
btl_tcp → ob1 callback path.  Either way a tensor payload crosses to
the host first and a remote payload arrives as numpy; ``recv(...,
out=tensor)`` lands it in a posted tensor of the receiver's dtype (the
one place a bfloat16 payload, which rides the wire as raw two-byte
words, is reinterpreted).

On the ``devices`` layout (``--mca accelerator_cuda_layout devices``)
the local mesh gives each local rank a buffer on its own card, so
``local`` is a devices :class:`Comm`, han takes and returns
:class:`~ompi_tpu_torch.mesh.shards.RankShards`, a window's base r lies
on local rank r's card, a message to a rank of this process is copied
onto its card and a posted receive buffer must lie on the receiving
rank's card.  ULFM recovery runs there too: ``shrink``, ``replace`` and
``replace_partial`` build the result's local mesh with
:meth:`~ompi_tpu_torch.mesh.mesh.CommMesh.submesh` (``_make_sub``), so a
survivor's ranks keep their cards and han's local leg is rebuilt over
``RankShards``; a reborn process's ranks land on the cards its
predecessor held (:func:`~ompi_tpu_torch.mesh.mesh.block_devices`, from
the launcher's environment).

Windows across processes (``win_*``) are :class:`~ompi_tpu_torch.osc.
dcn.MultiProcWin`.  ULFM over the DCN: ``revoke``/``agree``, and the two
recovery legs — ``shrink`` (the survivors agree the failed set and a new
CID) and ``replace``/``replace_partial`` (under ``tpurun --ft --respawn``
the reborn incarnation is installed and the communicator rebuilt at full
size).  ``_next_spawn`` names the KVS namespace of each
:func:`~ompi_tpu_torch.api.spawn.spawn`.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.boot.proc import ProcContext
from ompi_tpu_torch.coll.module import COLL_OPS, CollTable, select_coll_modules
from ompi_tpu_torch.core import mca
from ompi_tpu_torch.core import errors as _errors
from ompi_tpu_torch.core.errors import (
    MPIArgError,
    MPICommError,
    MPIInternalError,
    MPIRankError,
)
from ompi_tpu_torch.ddt.datatype import torch_dtype
from ompi_tpu_torch.mesh.mesh import CommMesh
from ompi_tpu_torch.metrics import straggler as _straggler
from ompi_tpu_torch.op.op import SUM, Op
from ompi_tpu_torch.p2p.part import PersistentP2PMixin
from ompi_tpu_torch.p2p.pml import ANY_SOURCE, ANY_TAG, MatchingEngine
from ompi_tpu_torch.request import Request, _poll_backoff
from ompi_tpu_torch.trace import causal as _causal
from ompi_tpu_torch.trace import core as _trace

from .comm import COLOR_UNDEFINED, Comm, _next_cid, _peek_cid, _reserve_cid_block
from .group import Group


class MultiProcComm(PersistentP2PMixin):
    """A communicator spanning processes of the job: the world (built by
    ``init`` via the modex) or any cross-process subset produced by
    :meth:`split` — sub-comms ride a :class:`~ompi_tpu_torch.dcn.collops.
    DcnSubEngine` over the shared transport with a globally agreed CID."""

    def __init__(self, ctx: ProcContext, local_mesh: CommMesh, name: str = "MPI_COMM_WORLD"):
        self.procctx = ctx
        self.proc = ctx.proc
        self.nprocs = ctx.nprocs
        self.dcn = ctx.engine
        self.local_mesh = local_mesh
        self.cid = _next_cid()
        self.name = name
        self._freed = False
        #: False only on the world built by init(): derived comms
        #: (split/shrink/replace results) repair via the PARTIAL replace
        #: leg even when they span every proc — their rank space is not
        #: the world's, so the world-level rejoin would rebuild the
        #: wrong communicator
        self._derived = False

        # modex: exchange local sizes → global rank layout.  Every first
        # boot publishes its size to the KVS so a respawned incarnation
        # can rebuild the SAME layout without the live allgather.
        ctx.kvs.put(f"{ctx.ns}wsize.{ctx.proc}", int(local_mesh.size))
        if ctx.incarnation and not ctx.rejoined:
            self.proc_sizes = [
                int(ctx.kvs.get(f"{ctx.ns}wsize.{p}"))
                for p in range(self.nprocs)]
        elif (getattr(ctx, "wsizes", None) is not None
              and len(ctx.wsizes) == self.nprocs):
            # the sharded modex already collected every rank's size
            # through the group leader's one bulk scan — no boot
            # collective at all (the instant-on path)
            self.proc_sizes = [int(w) for w in ctx.wsizes]
        else:
            sizes = self.dcn.allgather(
                np.array([local_mesh.size], np.int64), self.cid)
            self.proc_sizes = [int(s[0]) for s in sizes]
        self.offsets = np.cumsum([0] + self.proc_sizes).tolist()
        self.local_size = local_mesh.size
        self.local_offset = self.offsets[self.proc]
        self.size = self.offsets[-1]
        self.group = Group(range(self.size))

        # intra-process communicator (the han low_comm)
        self.local = Comm(
            Group(range(self.local_offset, self.local_offset + self.local_size)),
            local_mesh,
            name=f"{name}.local{self.proc}",
        )
        self._wire()

    def _wire(self) -> None:
        """Per-comm runtime wiring — ONE path shared by __init__ / dup /
        _make_sub: fresh coll/pml/NBC/FT state, frame routing, and
        failure fan-out registration.

        p2p routing picks one of two planes: on a native DCN engine
        with the default (``eager``) pml, frames go to the C matching
        engine and receives block in C (the fast path); interposed
        pmls (monitoring, vprotocol) keep Python delivery through the
        dispatcher thread."""
        self._coll = None
        self._pml = None
        self._pml_lock = threading.Lock()
        self._nbc_count = 0
        self._nbc_lock = threading.Lock()
        self._ft = None
        self._shrink_count = 0
        self._spawn_count = 0
        self._win_count = 0
        self._freed = False
        self._chans: dict[int, int] = {}
        self._pml_native = False
        if hasattr(self.dcn, "register_native_p2p"):
            from ompi_tpu_torch.p2p.component import EagerPmlComponent

            comp = mca.default_context().framework("pml").select_one()
            self._pml_native = type(comp) is EagerPmlComponent
        if self._pml_native:
            self.dcn.register_native_p2p(self.cid)
        else:
            self.dcn.register_p2p(self.cid, self._on_p2p_frame)
        self.dcn.register_comm(self.cid, self)
        self.procctx.register_comm(self)

    def _next_win(self) -> int:
        """Per-comm window counter (SPMD — window creation is
        collective)."""
        k = self._win_count
        self._win_count += 1
        return k

    # -- one-sided (windows across processes) ----------------------------

    def win_create(self, bases, name: str = ""):
        """MPI_Win_create over the DCN: one 1-D base per local rank,
        numpy or a tensor (a tensor on the card keeps its memory there;
        RMA payloads cross the DCN through the host).  On the devices
        layout a tensor base must lie on its rank's card."""
        from ompi_tpu_torch.osc.dcn import MultiProcWin

        for li, b in enumerate(bases):
            self.local_mesh.check_placed(li, b, "window base")
        return MultiProcWin(self, bases, name)

    def win_allocate(self, size: int, dtype=np.float32, name: str = ""):
        """MPI_Win_allocate: the window owns its memory, one buffer of
        ``size`` elements per local rank on that rank's device (numpy
        ``dtype`` or a torch dtype)."""
        tdt = torch_dtype(dtype)
        bases = [torch.zeros(max(int(size), 1), dtype=tdt, device=d)
                 for d in self.local_mesh.devices]
        return self.win_create(bases, name)

    def win_allocate_shared(self, size: int, dtype=np.float32,
                            name: str = ""):
        """MPI_Win_allocate_shared: the multi-process job runs on ONE
        host (a shared-memory domain), so allocation is win_allocate;
        shared_query resolves local ranks' buffers directly."""
        return self.win_allocate(size, dtype, name)

    def win_create_dynamic(self, dtype=np.float32, name: str = ""):
        """MPI_Win_create_dynamic over the DCN: starts empty; attach
        publishes a local region as the rank's window memory."""
        tdt = torch_dtype(dtype)
        w = self.win_create(
            [torch.zeros(0, dtype=tdt, device=d) for d in self.local_mesh.devices], name)
        w._dynamic_regions = {}

        def attach(rank_local, addr, array):
            self.local_mesh.check_placed(rank_local, array, "attachment")
            w._dynamic_regions[addr] = array
            w._user[rank_local] = array
            w._mem[rank_local] = w._as_base(array)

        def detach(rank_local, addr):
            w._dynamic_regions.pop(addr, None)

        w.attach = attach
        w.detach = detach
        return w

    def _next_spawn(self) -> int:
        """Per-comm spawn counter (SPMD-agreed, names the child world's
        KVS namespace)."""
        k = self._spawn_count
        self._spawn_count += 1
        return k

    def _next_nbc(self) -> int:
        """Per-comm non-blocking-collective issue counter: identical on
        every process by MPI's same-issue-order rule, it names each
        i-collective's private DCN stream (``<cid>#nbc<k>``)."""
        with self._nbc_lock:
            k = self._nbc_count
            self._nbc_count += 1
            return k

    # -- rank geometry ---------------------------------------------------

    def locate(self, global_rank: int) -> tuple[int, int]:
        """(owning process, local index) of a global rank."""
        if not 0 <= global_rank < self.size:
            raise MPIRankError(f"rank {global_rank} outside [0, {self.size})")
        for p in range(self.nprocs):
            if global_rank < self.offsets[p + 1]:
                return p, global_rank - self.offsets[p]
        raise MPIRankError(str(global_rank))  # pragma: no cover

    def proc_range(self, p: int) -> tuple[int, int]:
        return self.offsets[p], self.offsets[p + 1]

    def _check(self):
        if self._freed:
            raise MPICommError(f"{self.name} has been freed")

    @property
    def device(self) -> torch.device:
        """The local mesh's first device (local rank 0's; every rank's
        on the rows layout)."""
        return self.local_mesh.device

    # -- coll table ------------------------------------------------------

    @property
    def coll(self) -> CollTable:
        self._check()
        if self._coll is None:
            self._coll = select_coll_modules(self, mca.default_context().framework("coll"))
        return self._coll

    @property
    def mesh(self) -> CommMesh:
        return self.local_mesh

    # -- collectives (local rank-major buffers (local_n, ...)) ----------

    def _lookup(self, slot: str):
        """FT-guarded coll-table lookup — multi-process collectives honor
        ULFM state (revoked comm / failed member raises before any
        traffic)."""
        if self._ft is not None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, collective=True)
        fn = self.coll.lookup(slot)
        if _causal._enabled:
            # causal tracing: open the thread-local op context every
            # in-op send/recv stamps its wire context from — innermost
            # wrap, so its arrival is the closest to first traffic
            fn = _causal.wrap_call(slot, fn, comm=self.name)
        if _straggler._enabled:
            # straggler profiler: wall-clock arrival/exit per call,
            # keyed (comm, op, seq) like the trace merge key — sits
            # INSIDE the trace wrap so both see the same interval
            fn = _straggler.wrap_call(slot, fn, comm=self.name)
        if _trace._enabled:
            # api-layer span with the (comm, op, seq) merge key — the
            # per-(comm, op) issue counter is identical on every process
            # (MPI same-issue-order), so merged multi-process timelines
            # align one collective's spans across ranks
            return _trace.wrap_call("api", slot, fn, comm=self.name)
        return fn

    def allreduce(self, x, op: Op = SUM):
        return self._lookup("allreduce")(x, op)

    def bcast(self, x, root: int = 0):
        return self._lookup("bcast")(x, root)

    def reduce(self, x, op: Op = SUM, root: int = 0):
        """Root's recvbuf on the process owning ``root``; None elsewhere."""
        self.locate(root)  # MPI_ERR_RANK/ROOT before any traffic
        return self._lookup("reduce")(x, op, root)

    def allgather(self, x):
        return self._lookup("allgather")(x)

    def gather(self, x, root: int = 0):
        """Root's recvbuf (global_n, *s) on the process owning ``root``;
        None elsewhere (MPI: recvbuf significant only at root)."""
        return self._lookup("gather")(x, root)

    def scatter(self, x, root: int = 0):
        return self._lookup("scatter")(x, root)

    def reduce_scatter_block(self, x, op: Op = SUM):
        return self._lookup("reduce_scatter_block")(x, op)

    def reduce_scatter(self, x, op: Op = SUM, counts=None):
        """Jagged counts: x is each local rank's flat (sum(counts), …)
        contribution; returns this process's local ranks' segments."""
        return self._lookup("reduce_scatter")(x, op, counts)

    def alltoall(self, x):
        return self._lookup("alltoall")(x)

    def scan(self, x, op: Op = SUM):
        return self._lookup("scan")(x, op)

    def exscan(self, x, op: Op = SUM):
        return self._lookup("exscan")(x, op)

    def barrier(self) -> None:
        self._lookup("barrier")()

    def set_errhandler(self, errhandler) -> None:
        if not isinstance(errhandler, _errors.Errhandler):
            raise MPIArgError(f"not an Errhandler: {errhandler!r}")
        self._errhandler = errhandler

    def get_errhandler(self):
        return getattr(self, "_errhandler", _errors.ERRORS_RETURN)

    def __getattr__(self, name: str):
        """Non-blocking (i*) and persistent (*_init) variants of every
        collective, served from the coll table like their blocking
        counterparts."""
        if (name.startswith("i") and name[1:] in COLL_OPS) or (
            name.endswith("_init") and name[: -len("_init")] in COLL_OPS
        ):
            try:
                fn = self.coll.lookup(name)
            except MPIInternalError as e:
                # slot genuinely unserved → AttributeError keeps the
                # hasattr/getattr probe contract
                raise AttributeError(name) from e

            def guarded(*a, **k):
                # FT guard at CALL time (same choke as _lookup)
                if self._ft is not None:
                    from ompi_tpu_torch.ft import ulfm

                    ulfm.check(self, collective=True)
                return fn(*a, **k)

            return guarded
        raise AttributeError(name)

    def allgatherv(self, blocks: Sequence):
        return self._lookup("allgatherv")(blocks)

    def gatherv(self, blocks: Sequence, root: int = 0):
        return self._lookup("gatherv")(blocks, root)

    def scatterv(self, blocks: Sequence | None, root: int = 0):
        """blocks: one array per GLOBAL rank, meaningful on root's
        process; returns this process's local ranks' blocks."""
        return self._lookup("scatterv")(blocks, root)

    def alltoallv(self, matrix: Sequence[Sequence]):
        """matrix[l][j]: block from local rank l to global rank j;
        returns out[l][src] = block global rank src sent to l."""
        return self._lookup("alltoallv")(matrix)

    # -- p2p -------------------------------------------------------------

    @property
    def pml(self) -> MatchingEngine:
        self._check()
        if self._pml is None:
            # raced by the receiver thread (first inbound frame) vs the
            # main thread's first recv — double-checked lock
            with self._pml_lock:
                if self._pml is None:
                    if self._pml_native:
                        from ompi_tpu_torch.p2p.pml_native import (
                            NativeMatchingEngine,
                        )

                        self._pml = NativeMatchingEngine(
                            self.dcn._native_root(), self.cid, self.size)
                    else:
                        comp = (mca.default_context().framework("pml")
                                .select_one())
                        self._pml = comp.make_engine(self.size, self.name)
        return self._pml

    def _chan(self, dproc: int) -> int:
        """Cached native channel to a member process (pins peer + cid
        in C so the per-message crossing carries only scalars).  The
        lock closes the check-then-insert race between concurrent
        sender threads; channels are freed in :meth:`free`."""
        ch = self._chans.get(dproc)
        if ch is None:
            with self._pml_lock:
                ch = self._chans.get(dproc)
                if ch is None:
                    ch = self.dcn._native_root().chan_open(
                        self.dcn.addresses[dproc], self.cid)
                    self._chans[dproc] = ch
        return ch

    def _on_p2p_frame(self, env: dict, payload: np.ndarray) -> None:
        # relayed delivery: already accounted on the sending process
        self.pml.send(env["src"], env["dst"], payload, env["tag"],
                      _account=False)

    def send(self, buf, source: int, dest: int, tag: int = 0) -> None:
        """Send from a LOCAL global rank ``source`` to any global rank."""
        if self._ft is not None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, peer=dest)
        sproc, _ = self.locate(source)
        if sproc != self.proc:
            raise MPIRankError(
                f"rank {source} is owned by process {sproc}, not {self.proc}")
        dproc, dlocal = self.locate(dest)
        if dproc == self.proc:
            # on the devices layout a tensor lands on the receiver's card
            dest_dev = (self.local_mesh.devices[dlocal]
                        if self.local_mesh.layout == "devices"
                        and isinstance(buf, torch.Tensor) else None)
            self.pml.send(source, dest, buf, tag, dest_dev)
            return
        # sender-side accounting (the local pml never sees this send)
        from ompi_tpu_torch.coll.han import to_host
        from ompi_tpu_torch.tool import monitoring as _mon
        from ompi_tpu_torch.tool import spc as _spc

        if _spc.attached():
            _spc.inc("send")
            _spc.inc("send_bytes", _spc.payload_nbytes(buf))
        if _trace._enabled:
            _trace.instant("p2p", "send_remote", comm=self.name,
                           src=source, dst=dest, tag=tag,
                           nbytes=_spc.payload_nbytes(buf))
        if isinstance(self.pml, _mon.MonitoredEngine):
            _mon.account_p2p(self.name, self.size, source, dest,
                             _spc.payload_nbytes(buf))
        payload = (to_host(buf) if isinstance(buf, torch.Tensor)
                   else np.ascontiguousarray(np.asarray(buf)))
        if self._pml_native:
            from ompi_tpu_torch.dcn.native import FK_P2P

            self.dcn._native_root().chan_send(
                self._chan(dproc), FK_P2P, source, dest, tag, payload)
        else:
            self.dcn.send_p2p(
                dproc, {"cid": self.cid, "src": source, "dst": dest, "tag": tag},
                payload)

    def irecv(self, dest: int, source: int | None = None, tag: int | None = None) -> Request:
        if self._ft is not None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, peer=source, any_source=source is None)
        dproc, _ = self.locate(dest)
        if dproc != self.proc:
            raise MPIRankError(f"rank {dest} not owned by process {self.proc}")
        req = self.pml.irecv(
            dest,
            ANY_SOURCE if source is None else source,
            ANY_TAG if tag is None else tag,
        )
        if source is not None and self.locate(source)[0] != self.proc:
            # cross-process receive: converge on the shared deadline
            # policy + in-band failure sensitivity (a remote receive
            # must never hang; ANY_SOURCE and local receives keep plain
            # MPI blocking semantics)
            arm = getattr(req, "arm_remote_guard", None)
            if arm is not None:
                arm(*self._remote_recv_guard(source, tag))
                # hang diagnosis: tag the awaited peer's root proc so a
                # blocked wait site can name it (waitgraph edge target)
                req.wait_peer = self.dcn.root_proc_of(self.locate(source)[0])
        elif source is None:
            # opt-in bounded ANY_SOURCE wait (dcn_anysrc_timeout)
            guard = self._anysrc_guard()
            arm = getattr(req, "arm_remote_guard", None)
            if guard is not None and arm is not None:
                arm(*guard)
        return req

    def _remote_recv_guard(self, source: int, tag):
        """(timeout, check, escalate) for a blocked cross-process
        receive — the same deadline + ULFM escalation the coll and
        rendezvous waits use."""
        from ompi_tpu_torch.core.errors import MPIProcFailedError
        from ompi_tpu_torch.core.var import dcn_timeout

        sproc = self.locate(source)[0]

        def check() -> None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, peer=source)
            if self.dcn.proc_failed(sproc):
                raise MPIProcFailedError(
                    f"recv: peer rank {source} failed", failed=(source,))

        def escalate(timeout: float):
            self.dcn._escalate_deadline(
                "p2p_recv", timeout,
                f"recv deadline (dcn_recv_timeout={timeout}s) expired "
                f"on {self.name}: waiting for rank {source} (tag={tag})"
                f" — peer dead, wedged, or send never issued",
                failed_rank=source,
                root_proc=self.dcn.root_proc_of(sproc),
                comm=self.name, src=int(source))

        return dcn_timeout("recv"), check, escalate

    def _anysrc_guard(self):
        """(timeout, check, escalate) for an opt-in bounded ANY_SOURCE
        wait (``dcn_anysrc_timeout``; default 0 = off).  Expiry runs a
        communicator-wide liveness check: an unacknowledged failed
        member raises MPIProcFailedPendingError; an all-alive
        membership re-arms the wait."""
        from ompi_tpu_torch.core.var import dcn_timeout

        t = float(dcn_timeout("anysrc"))
        if t <= 0:
            return None

        def check() -> None:
            if self._ft is not None:
                from ompi_tpu_torch.ft import ulfm

                ulfm.check(self, any_source=True)

        def escalate(timeout: float) -> None:
            dead = [p for p in range(self.nprocs)
                    if p != self.proc and self.dcn.proc_failed(p)]
            if not dead:
                return  # every member alive: keep blocking
            from ompi_tpu_torch.ft import ulfm

            st = ulfm.peek(self)
            acked = st.acked if st is not None else set()
            ranks = tuple(r for p in dead
                          for r in range(*self.proc_range(p))
                          if r not in acked)
            if not ranks:
                return  # every known failure acknowledged: keep waiting
            from ompi_tpu_torch.core.errors import MPIProcFailedPendingError
            from ompi_tpu_torch.metrics import flight as _flight

            _flight.record("anysrc_liveness", comm=self.name,
                           timeout_s=float(timeout), failed=sorted(ranks))
            raise MPIProcFailedPendingError(
                f"ANY_SOURCE receive on {self.name}: liveness check "
                f"(dcn_anysrc_timeout={timeout}s) found failed ranks "
                f"{sorted(ranks)} (ack_failed to re-arm)", failed=ranks)

        return t, check, escalate

    def recv(self, dest: int, source: int | None = None,
             tag: int | None = None, out: torch.Tensor | None = None):
        """``out``: an optional posted tensor the payload lands in (on
        ``out``'s device, in ``out``'s dtype — a remote bfloat16 payload,
        which arrives as raw two-byte words, is reinterpreted here); the
        returned payload is then ``out`` itself.  On the native plane a
        CPU ``out`` is handed to the C engine as the ``recv_into``
        buffer, so the payload is placed in it without a Python copy.
        On the devices layout ``out`` must lie on ``dest``'s card."""
        if out is not None:
            dproc, dlocal = self.locate(dest)
            if dproc == self.proc:
                self.local_mesh.check_placed(dlocal, out, "receive buffer")
        if self._pml_native:
            payload, st = self._recv_native(dest, source, tag, out)
        else:
            req = self.irecv(dest, source, tag)
            payload, st = req.wait(), req.status
        if out is not None and payload is not out:
            payload = _land(payload, out)
        return payload, st

    def _recv_native(self, dest: int, source: int | None, tag: int | None,
                     out: torch.Tensor | None):
        """One C crossing: match-or-post + sleep on the request's
        condvar; a watched specific source also wakes on failure."""
        if self._ft is not None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, peer=source, any_source=source is None)
        dproc, _ = self.locate(dest)
        if dproc != self.proc:
            raise MPIRankError(f"rank {dest} not owned by process {self.proc}")
        fail_proc = -1
        remote = False
        if source is not None:
            sproc = self.locate(source)[0]
            remote = sproc != self.proc
            if remote:
                # watched regardless of FT: the C wait then wakes on a
                # marked failure AND the recv deadline can name the
                # proc it escalates.  Local sources are never watched
                # or deadlined (plain MPI blocking semantics)
                fail_proc = self.dcn.root_proc_of(sproc)
        into = _host_view(out)
        payload, st = self.pml.recv_blocking(
            dest,
            ANY_SOURCE if source is None else source,
            ANY_TAG if tag is None else tag,
            fail_proc,
            remote=remote,
            guard=(self._anysrc_guard() if source is None else None),
            into=into,
        )
        if into is not None and payload is into:
            payload = out  # placed in the posted tensor's memory
        return payload, st

    def iprobe(self, dest: int, source: int | None = None,
               tag: int | None = None):
        """MPI_Iprobe on the local matching engine (remote sends are
        injected there by the receiver thread, so probing is local).
        ``dest`` must be a locally-owned rank, like irecv."""
        dproc, _ = self.locate(dest)
        if dproc != self.proc:
            raise MPIRankError(f"rank {dest} not owned by process {self.proc}")
        if self._ft is not None:
            from ompi_tpu_torch.ft import ulfm

            ulfm.check(self, peer=source, any_source=source is None)
        return self.pml.iprobe(
            dest,
            ANY_SOURCE if source is None else source,
            ANY_TAG if tag is None else tag,
        )

    def probe(self, dest: int, source: int | None = None,
              tag: int | None = None):
        sleep = 0.0
        while True:
            st = self.iprobe(dest, source, tag)
            if st is not None:
                return st
            sleep = _poll_backoff(sleep)

    # -- fault tolerance (ULFM over DCN) ---------------------------------

    @property
    def respawned(self) -> bool:
        """True on a reborn incarnation that has not rejoined yet — the
        SPMD cue for worker code to call :meth:`replace` right after
        init instead of entering the normal loop."""
        return bool(self.procctx.incarnation) and not self.procctx.rejoined

    def _on_proc_failed(self, root_proc: int) -> None:
        """Detector fan-out: mark the dead process's global ranks failed
        on this comm (no-op if the proc isn't a member)."""
        from ompi_tpu_torch.ft import ulfm

        lp = self.dcn.local_proc_of(root_proc)
        if lp is None:
            return
        lo, hi = self.proc_range(lp)
        ulfm.state(self).failed.update(range(lo, hi))

    def _on_proc_healed(self, root_proc: int) -> None:
        """Detector heal fan-out: a FALSE-POSITIVE failure mark was
        retracted — clear its ranks from this comm's ULFM state.
        Revocation is sticky by design (ULFM revoke has no undo)."""
        from ompi_tpu_torch.ft import ulfm

        st = ulfm.peek(self)
        if st is None:
            return
        lp = self.dcn.local_proc_of(root_proc)
        if lp is None:
            return
        lo, hi = self.proc_range(lp)
        st.failed.difference_update(range(lo, hi))
        st.acked.difference_update(range(lo, hi))

    def revoke(self) -> None:
        """MPIX_Comm_revoke: poison this comm everywhere — the local
        mark plus a ``rvk`` control frame to every member process (the
        out-of-band broadcast that beats the failure news).  A frame is
        sent once, so it is retried while its peer is held live
        (:meth:`_send_revoke`); a peer marked failed gets none, and the
        revoke stands locally."""
        from ompi_tpu_torch.ft import ulfm

        ulfm.state(self).revoked = True
        # local C fast-path wake first: a schedule this process parked
        # on the comm's private stream must abort promptly
        self.dcn._root_engine().coll_revoke(self.cid)
        for p in range(self.nprocs):
            if p != self.proc:
                self._send_revoke(p)

    def _send_revoke(self, p: int) -> None:
        """One ``rvk`` frame to local proc ``p``, retried until it is sent
        or ``p`` is marked failed: the native plane refuses a control
        frame while the peer's send path is busy (a heartbeat or a data
        send holds it), so a live peer's first attempt may fail.  Past
        ``dcn_connect_timeout`` of failed attempts the peer is marked
        failed, as an in-band send error marks it.  Every failed attempt
        and every skipped peer is counted on the root engine's
        ``revoke_counts``."""
        from ompi_tpu_torch.core.var import Deadline

        root = self.dcn._root_engine()
        counts = root.revoke_counts
        deadline = Deadline.for_timeout("connect")
        pause = 0.001
        while not self.dcn.proc_failed(p):
            try:
                self.dcn.send_ctrl(p, {"kind": "rvk", "cid": self.cid})
                return
            except (ConnectionError, OSError, _errors.MPIError):
                counts["send_failed"] += 1
            if deadline.expired():
                rp = self.dcn.root_proc_of(p)
                if root._detector is not None:
                    root._detector.mark_failed(rp)
                else:
                    root.note_proc_failed(rp)
                return
            time.sleep(min(pause, deadline.remaining()))
            pause = min(0.05, 2 * pause)
        counts["skipped_failed"] += 1

    def is_revoked(self) -> bool:
        from ompi_tpu_torch.ft import ulfm

        return ulfm.is_revoked(self)

    def get_failed(self) -> list[int]:
        from ompi_tpu_torch.ft import ulfm

        return ulfm.get_failed(self)

    def ack_failed(self) -> int:
        from ompi_tpu_torch.ft import ulfm

        return ulfm.ack_failed(self)

    def agree(self, flags: int) -> int:
        """MPIX_Comm_agree over the surviving processes: bitwise-AND
        allreduce on a survivor stream (works on revoked comms —
        agreement is how ranks coordinate after revoke)."""
        from ompi_tpu_torch.op import BAND

        live = self._live_procs()
        eng = self.dcn if len(live) == self.nprocs else self.dcn.sub(live)
        k = self._next_shrink()
        out = eng.allreduce(np.array([int(flags)], np.int64), BAND,
                            f"{self.cid}#agree{k}", ordered=True)
        return int(out[0])

    def _live_procs(self) -> list[int]:
        from ompi_tpu_torch.ft import ulfm

        st = ulfm.peek(self)
        dead_ranks = st.failed if st else set()
        dead_procs = {
            p for p in range(self.nprocs)
            if set(range(*self.proc_range(p))) & dead_ranks
        }
        live = [p for p in range(self.nprocs) if p not in dead_procs]
        if self.proc not in live:
            raise MPICommError("calling process is marked failed")
        return live

    def _next_shrink(self) -> int:
        k = self._shrink_count
        self._shrink_count += 1
        return k

    def shrink(self, name: str = "") -> "MultiProcComm":
        """MPIX_Comm_shrink: rebuild membership over the surviving
        processes.  Survivors exchange their failed-set view and CID
        proposals on a derived stream; the union decides membership and
        the MAX decides the new CID (works on revoked comms — shrink IS
        the recovery path).

        Convergence requirement (ftagree's job in the reference): every
        survivor must already know the same failed set — heartbeat
        gossip converges within one period, so call shrink after
        ``get_failed`` reflects the failure on every survivor."""
        live = self._live_procs()
        eng = self.dcn.sub(live) if len(live) < self.nprocs else self.dcn
        k = self._next_shrink()
        infos = eng.allgather_obj(
            {"cid": _peek_cid(),
             "dead": sorted(set(range(self.nprocs)) - set(live))},
            f"{self.cid}#shrink{k}")
        all_dead: set[int] = set()
        for it in infos:
            all_dead.update(it["dead"])
        if all_dead & set(live):
            raise MPICommError(
                "shrink: survivors disagree on the failed set "
                f"(late detections {sorted(all_dead & set(live))}); "
                "wait for detection to converge and retry")
        cid = _reserve_cid_block(max(int(it["cid"]) for it in infos), 1)
        members = [r for p in live for r in range(*self.proc_range(p))]
        owners = [p for p in live for _ in range(self.proc_sizes[p])]
        sub = self._make_sub("shrunk", cid, members, owners, live)
        sub.name = name or f"{self.name}.shrunk"
        return sub

    # -- elastic recovery: replace (the PRRTE restart leg) ---------------

    def replace(self, name: str = "") -> "MultiProcComm":
        """Rebuild the communicator at FULL size after rank death —
        shrink's two-legged sibling (≈ PRRTE restarting the failed proc
        instead of the job contracting around it).

        Under ``tpurun --ft --respawn`` the launcher relaunches a dead
        rank with a bumped incarnation; the reborn process replays the
        boot rendezvous, re-publishing its endpoint under
        ``dcn.<proc>.i<k>``.  Survivors call ``replace()`` after
        detection converges (typically revoke → replace): each failed
        proc is awaited on the KVS, its new address installed on the
        root engine, its failure marks cleared (detector, engine, native
        C plane, device plane), and one CID-agreement round runs over
        the restored membership on a fresh ``replace.<proc>.i<k>``
        stream — a string-cid stream both the mid-job survivors and the
        fresh-booted reborn proc enter at seq 0.  The reborn process
        itself calls ``replace()`` right after ``init()`` and joins the
        same round.

        Returns the new full-membership communicator; the old one stays
        revoked.  A communicator that does NOT span the job (a split/sub
        comm, or any derived comm) repairs through the PARTIAL leg
        (:meth:`_replace_partial`): only the member procs participate,
        on comm-scoped beacon/agreement streams."""
        ctx = self.procctx
        timeout = self._respawn_timeout()
        world_shaped = (
            not self._derived
            and self.nprocs == self.dcn._root_engine().nprocs
            and all(self.dcn.root_proc_of(p) == p for p in range(self.nprocs)))
        if not world_shaped:
            return self._replace_partial(name, timeout)
        t0 = _trace.now() if _trace._enabled else 0
        tw0 = time.monotonic()
        if not ctx.rejoined:
            cid = self._replace_rejoin(timeout)
        else:
            live = self._live_procs()
            dead = sorted(set(range(self.nprocs)) - set(live))
            if not dead:
                # without a restoration round there is no agreement
                # exchange, and per-process CID reservation would diverge
                raise MPICommError("replace: no failed ranks on this communicator")
            proposals = self._replace_recover(sorted(live), dead, timeout)
            cid = _reserve_cid_block(max(int(c) for c in proposals), 1)
        sub = self._replace_build(cid, name)
        if _trace._enabled:
            _trace.complete("ft", "replace", t0, comm=self.name, cid=int(cid))
        # the restoration's end-to-end heal latency, flight-recorded on
        # every participant (no-op unless metrics are enabled)
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record(
            "replace", comm=self.name, cid=int(cid),
            incarnation=int(ctx.incarnation),
            heal_ms=round((time.monotonic() - tw0) * 1e3, 3))
        return sub

    def _respawn_timeout(self) -> float:
        from ompi_tpu_torch.boot.proc import respawn_timeout

        return respawn_timeout(mca.default_context().store)

    # -- partial replace (split/sub comms) -------------------------------

    def _replace_partial(self, name: str, timeout: float) -> "MultiProcComm":
        """``replace()`` on a communicator that does not span the job:
        repair ONLY the member ranks.  Survivor members restore each dead
        member proc at the root level (await its respawned incarnation,
        install the endpoint, clear the marks) unless a world-level
        replace already did; the minimum survivor publishes a
        comm-scoped beacon (``replace.sub.<proc>.i<k>.c<cid>``) carrying
        the repaired comm's coordinate recipe, and a CID round runs per
        restored proc on the comm-scoped stream
        (``replace.c<cid>.<proc>.i<k>``) that the reborn process joins via
        :meth:`replace_partial` on its fresh world.  Non-member procs
        never participate.  Nested splits repair here too: the recipe
        carries comm-relative (proc, local-index) pairs, and the beacon
        key is scoped (proc, incarnation, cid), so one death can heal
        several sub-comms (consumed in ascending-cid order)."""
        ctx = self.procctx
        if not ctx.rejoined:
            raise MPICommError(
                "partial replace is the survivors' call; a reborn "
                "incarnation rejoins via world.replace_partial()")
        tw0 = time.monotonic()
        t0 = _trace.now() if _trace._enabled else 0
        live = self._live_procs()
        dead = sorted(set(range(self.nprocs)) - set(live))
        if not dead:
            raise MPICommError("replace: no failed ranks on this communicator")
        recipe = self._partial_recipe(name)
        live_roots = [self.dcn.root_proc_of(p) for p in live]
        dead_roots = [self.dcn.root_proc_of(p) for p in dead]
        proposals = self._partial_rounds(live_roots, dead_roots, timeout, recipe)
        cid = _reserve_cid_block(max(int(c) for c in proposals), 1)
        sub = self._make_sub(
            "replaced", cid, list(range(self.size)),
            [p for p in range(self.nprocs) for _ in range(self.proc_sizes[p])],
            list(range(self.nprocs)))
        sub.name = recipe["name"]
        # metadata in WORLD coordinates, matching the reborn side's
        # recipe-built comm: a second partial repair of this result must
        # publish world ranks, not the [0..size) of _make_sub over the
        # old sub
        sub.group = Group(list(self.group.ranks))
        if _trace._enabled:
            _trace.complete("ft", "replace", t0, comm=self.name, cid=int(cid))
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record(
            "replace", comm=self.name, cid=int(cid), partial=True,
            heal_ms=round((time.monotonic() - tw0) * 1e3, 3))
        return sub

    def _partial_recipe(self, name: str = "") -> dict:
        """The repaired communicator's structure in COMM-RELATIVE
        coordinates — everything a reborn proc (holding only its fresh
        world) needs to build the identical comm: one (root proc, local
        index) pair per member rank in comm order, the owning procs (root
        ids, comm order), the old comm's cid (the queued-beacon
        discriminator), the comm-scoped stream prefix, and the name."""
        return {
            "coords": [[int(a), int(b)] for a, b in
                       (self._coord_of(r) for r in range(self.size))],
            "procs": [int(self.dcn.root_proc_of(p)) for p in range(self.nprocs)],
            "cid": int(self.cid),
            "skey": f"replace.c{int(self.cid)}",
            "name": name or f"{self.name}.replaced",
        }

    def _coord_of(self, r: int) -> tuple[int, int]:
        """Member rank ``r`` as a (root proc, proc-local index) pair — the
        nesting-independent address ``_make_sub`` threads down the split
        chain (``_world_coords``); computed directly on the world, where
        comm-local IS world-local."""
        wc = getattr(self, "_world_coords", None)
        if wc is not None:
            return wc[r]
        p, li = self.locate(r)
        return (int(self.dcn.root_proc_of(p)), int(li))

    def _partial_rounds(self, members: list[int], dead: list[int],
                        timeout: float, recipe: dict) -> list[int]:
        """Comm-scoped twin of :meth:`_replace_recover`: one rendezvous
        round per dead member proc (ROOT ids throughout), CID agreement
        over the membership restored so far; the minimum survivor
        publishes the beacon each reborn proc reads.  Shared by the
        survivor leg (on the sub-comm) and the reborn leg (on the world,
        for procs still dead after its own round)."""
        ctx = self.procctx
        root = self.dcn._root_engine()
        members = sorted(members)
        dead = list(dead)
        proposals = [_peek_cid()]
        while dead:
            r = dead.pop(0)
            if root.proc_failed(r) or r not in ctx.incarnations:
                inc, addr = ctx.await_respawn(r, timeout)
                self._integrate_respawn(r, inc, addr)
            else:
                # a world-level replace already restored this proc at
                # the root — only the comm-scoped agreement remains
                inc = ctx.incarnations[r]
            members = sorted(members + [r])
            stream = f"{recipe['skey']}.{r}.i{inc}"
            if root.proc == min(m for m in members if m != r):
                # beacon keyed (proc, incarnation, CID): each sub-comm the
                # dead proc belonged to queues its OWN recipe
                ctx.kvs.put(
                    f"{ctx.ns}replace.sub.{r}.i{inc}.c{int(recipe['cid'])}",
                    dict(recipe, stream=stream, round=members, dead=list(dead),
                         incs={str(k): v for k, v in ctx.incarnations.items()}))
            proposals = [int(c) for c in
                         root.sub(members).allgather_obj_hub(int(_peek_cid()), stream)]
        return proposals

    def replace_partial(self, name: str = "",
                        cid: int | None = None) -> "MultiProcComm":
        """The reborn-incarnation half of a PARTIAL replace: called on the
        fresh world right after ``init()`` (``world.respawned`` is the
        SPMD cue) when the communicator being repaired did not span the
        job.  Consumes the lowest-cid pending recipe of this
        incarnation's (proc, incarnation, cid)-keyed beacon queue (or
        exactly ``cid``), joins its CID round (helping restore any procs
        still dead after it), rebuilds the member communicator from the
        coordinate recipe, and retires non-member procs from the failure
        detector — this process has no live relationship with them, so
        their heartbeat silence toward it must not read as death.  Call
        it once per poisoned sub-comm, in the ascending-cid order the
        survivors repair them."""
        ctx = self.procctx
        if not ctx.incarnation:
            raise MPICommError(
                "replace_partial: not a reborn incarnation (survivors "
                "repair a partial communicator with replace() on it)")
        timeout = self._respawn_timeout()
        inc = ctx.incarnation
        info, beacon_key = self._next_partial_recipe(cid, timeout)
        ctx.adopt_incarnation_floors(info.get("incs"))
        ctx.incarnations[self.proc] = inc
        members_round = sorted(int(m) for m in info["round"])
        proposals = [int(c) for c in
                     self.dcn.sub(members_round).allgather_obj_hub(
                         int(_peek_cid()), str(info["stream"]))]
        recipe = {k: info[k] for k in ("coords", "procs", "skey", "name", "cid")}
        dead = [int(d) for d in info.get("dead", ())]
        if dead:
            proposals = self._partial_rounds(members_round, dead, timeout, recipe)
        new_cid = _reserve_cid_block(max(int(c) for c in proposals), 1)
        members = [self.proc_range(int(rp))[0] + int(li)
                   for rp, li in recipe["coords"]]
        member_procs = [int(p) for p in recipe["procs"]]
        owners = [self.locate(r)[0] for r in members]
        sub = self._make_sub("replaced", new_cid, members, owners, member_procs)
        sub.name = str(recipe["name"])
        # consume the beacon only now: a heal that failed mid-round must
        # leave the recipe discoverable for a retry
        ctx.healed_partials.add(beacon_key)
        first_rejoin = not ctx.rejoined
        ctx.rejoined = True
        det = ctx.detector
        if det is not None and first_rejoin:
            # only when this call IS the rejoin: a world-level rejoin that
            # already ran restored live relationships with every proc
            for p in range(self.nprocs):
                if p != self.proc and p not in member_procs:
                    det.retire_peer(p)
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record("replace", comm=sub.name, cid=int(new_cid),
                       partial=True, incarnation=int(inc))
        return sub

    def _next_partial_recipe(self, cid: int | None,
                             timeout: float) -> tuple[dict, str]:
        """Poll this incarnation's beacon queue for the next UNCONSUMED
        repair recipe: lowest cid first, or exactly ``cid``.  Returns
        (recipe, beacon key); the caller marks the key consumed once the
        heal succeeds."""
        ctx = self.procctx
        prefix = f"{ctx.ns}replace.sub.{self.proc}.i{ctx.incarnation}.c"
        seen = ctx.healed_partials
        deadline = time.monotonic() + float(timeout)
        while True:
            try:
                scan = ctx.kvs.get_prefix(prefix)
            except (ConnectionError, OSError):
                scan = {}
            pending = sorted(
                (int(k[len(prefix):]), k) for k in scan
                if k not in seen and k[len(prefix):].isdigit())
            if cid is not None:
                pending = [(c, k) for c, k in pending if c == int(cid)]
            if pending:
                _c, key = pending[0]
                return scan[key], key
            if time.monotonic() > deadline:
                from ompi_tpu_torch.core.errors import MPIProcFailedError

                raise MPIProcFailedError(
                    f"replace_partial: no pending repair recipe for "
                    f"proc {self.proc} incarnation {ctx.incarnation}"
                    + (f" cid {cid}" if cid is not None else "")
                    + f" within {timeout}s")
            time.sleep(0.05)

    def _replace_recover(self, members: list[int], dead: list[int],
                         timeout: float) -> list[int]:
        """Process the dead procs one rendezvous round at a time; each
        round's CID-agreement allgather spans the membership restored SO
        FAR (earlier-reborn procs join later rounds — they learn the
        remaining dead set from the round metadata the minimum survivor
        published).  Returns the final round's proposals."""
        ctx = self.procctx
        proposals = [_peek_cid()]
        dead = list(dead)
        while dead:
            p = dead.pop(0)
            inc, addr = ctx.await_respawn(p, timeout)
            members = sorted(members + [p])
            self._integrate_respawn(p, inc, addr)
            if self.proc == min(m for m in members if m != p):
                # rendezvous beacon for the reborn proc: who is in its
                # round, which procs it must help restore after, and the
                # survivors' incarnation floors (a reborn proc boots with
                # an EMPTY incarnation map, and would otherwise accept a
                # stale inc.<q> of an EARLIER recovery of q)
                ctx.kvs.put(f"{ctx.ns}replace.{p}.i{inc}",
                            {"members": members, "dead": list(dead),
                             "incs": {str(k): v for k, v in ctx.incarnations.items()}})
            proposals = self._replace_round(members, p, inc)
        return proposals

    def _replace_round(self, members: list[int], p: int, inc: int) -> list[int]:
        """One CID-agreement allgather over ``members`` on the (proc,
        incarnation)-scoped stream — fresh for every participant,
        mid-job or fresh-booted.  Hub pattern: 2(P−1) frames through the
        minimum member instead of a full-mesh dial storm on a degraded
        mesh."""
        ctx = self.procctx
        rec = {"stream": f"replace.{p}.i{inc}", "members": list(members),
               "incs": [inc if m == p else ctx.incarnation if m == self.proc
                        else ctx.incarnations.get(m, 0) for m in members]}
        ctx.replace_rounds.append(rec)
        t0 = time.monotonic()
        eng = self.dcn if len(members) == self.nprocs else self.dcn.sub(members)
        infos = eng.allgather_obj_hub(int(_peek_cid()), rec["stream"])
        rec["ms"] = round((time.monotonic() - t0) * 1e3, 3)
        return [int(c) for c in infos]

    def _integrate_respawn(self, p: int, inc: int, addr: str) -> None:
        """Install a reborn incarnation on the root engine: refresh its
        address, clear its failure marks everywhere (gossiping detector,
        engine failure set, native C plane, device plane), and account
        the restoration (``respawns`` counter, flight record, trace
        instant)."""
        root = self.dcn._root_engine()
        root.update_address(p, addr)
        # the incarnation seeds the detector's versioned-gossip floor:
        # late flr records about the corpse (inc < this) are stale
        root.note_proc_recovered(p, incarnation=int(inc))
        from ompi_tpu_torch.metrics import flight as _flight

        # the delivered-seq watermark for the CORPSE's identity (the
        # reborn endpoint starts a fresh one) — recovery observability
        wm = 0
        wm_fn = getattr(root.transport, "_rx_watermark", None)
        if wm_fn is not None:
            try:
                wm = int(wm_fn(addr))
            except Exception:  # noqa: BLE001 — diagnostic only
                wm = 0
        _flight.record("respawn", proc=int(p), incarnation=int(inc),
                       seq_watermark=wm)
        if _trace._enabled:
            _trace.instant("ft", "respawn", proc=int(p), incarnation=int(inc))

    def _replace_rejoin(self, timeout: float) -> int:
        """The reborn process's half of replace(): wait for the
        survivors' rendezvous beacon, join this incarnation's
        CID-agreement round, then help restore any procs still dead."""
        ctx = self.procctx
        inc = ctx.incarnation
        info = ctx.kvs.get(f"{ctx.ns}replace.{self.proc}.i{inc}", timeout=timeout)
        members = [int(m) for m in info["members"]]
        dead = [int(d) for d in info["dead"]]
        # adopt the survivors' incarnation floors before helping restore
        # any remaining dead procs — detector floors included, so a
        # FELLOW reborn peer's heartbeats are liveness, not a rebirth
        ctx.adopt_incarnation_floors(info.get("incs"))
        ctx.incarnations[self.proc] = inc
        proposals = self._replace_round(members, self.proc, inc)
        if dead:
            proposals = self._replace_recover(members, dead, timeout)
        ctx.rejoined = True
        return _reserve_cid_block(max(int(c) for c in proposals), 1)

    def _replace_build(self, cid: int, name: str) -> "MultiProcComm":
        members = list(range(self.size))
        owners = [p for p in range(self.nprocs) for _ in range(self.proc_sizes[p])]
        sub = self._make_sub("replaced", cid, members, owners, list(range(self.nprocs)))
        sub.name = name or f"{self.name}.replaced"
        # only reachable from the world leg: the healed comm spans the
        # job in rank order, so a LATER death must repair it through the
        # world leg again
        sub._derived = False
        return sub

    # -- lifecycle -------------------------------------------------------

    def _agree_cids(self, n: int) -> int:
        """Multi-process CID agreement (≈ ompi_comm_nextcid): every
        member proposes its local next-cid, the MAX wins, and all
        members reserve the identical block ``[max, max+n)``."""
        proposals = self.dcn.allgather_obj(_peek_cid(), self.cid)
        return _reserve_cid_block(max(int(p) for p in proposals), n)

    def dup(self, name: str = "") -> "MultiProcComm":
        self._check()
        c = MultiProcComm.__new__(MultiProcComm)
        c.__dict__.update(self.__dict__)
        c.cid = self._agree_cids(1)
        c.name = name or f"{self.name}.dup"
        c._wire()
        return c

    def split(
        self, colors: Sequence[int], keys: Sequence[int] | None = None
    ) -> list["MultiProcComm | None"]:
        """MPI_Comm_split across processes.

        Distributed SPMD view: ``colors[l]`` / ``keys[l]`` are the
        arguments of this process's l-th LOCAL rank.  Returns one entry
        per local rank: the sub-communicator its color landed in (ranks
        sharing a color on this process share the object;
        ``COLOR_UNDEFINED`` → None).

        Each sub-comm gets a globally agreed CID (block reservation over
        the parent stream), a :class:`DcnSubEngine` over the member
        processes, a submesh of the local mesh for its local ranks, and
        fresh han coll selection.  Rank order within a color is (key,
        parent rank); orderings that interleave the ranks of different
        processes are rejected (sub-comm rank space stays
        process-contiguous)."""
        self._check()
        if len(colors) != self.local_size:
            raise MPIArgError(
                f"colors length {len(colors)} != local size {self.local_size}")
        keys = [0] * self.local_size if keys is None else list(keys)
        if len(keys) != self.local_size:
            raise MPIArgError("keys length != local size")

        # one exchange: every process's (colors, keys, cid proposal)
        infos = self.dcn.allgather_obj(
            {
                "colors": [int(c) for c in colors],
                "keys": [int(k) for k in keys],
                "cid": _peek_cid(),
            },
            self.cid,
        )
        gcolors: list[int] = []
        gkeys: list[int] = []
        for it in infos:
            gcolors.extend(it["colors"])
            gkeys.extend(it["keys"])

        by_color: dict[int, list[int]] = {}
        for r, c in enumerate(gcolors):
            if c == COLOR_UNDEFINED:
                continue
            if c < 0:
                raise MPIArgError(f"negative color {c}")
            by_color.setdefault(c, []).append(r)

        # validate EVERY color before any construction: a failure must
        # leave no half-registered sub-comms or burned CIDs behind
        plans = []
        for c, members in sorted(by_color.items()):
            members.sort(key=lambda r: (gkeys[r], r))
            owners = [self.locate(r)[0] for r in members]
            plans.append((c, members, owners, self._member_procs(owners, f"split color {c}")))

        base = _reserve_cid_block(max(int(it["cid"]) for it in infos), len(by_color))

        out: list[MultiProcComm | None] = [None] * self.local_size
        for i, (c, members, owners, member_procs) in enumerate(plans):
            if self.proc not in member_procs:
                continue
            sub = self._make_sub(c, base + i, members, owners, member_procs)
            for r, p in zip(members, owners):
                if p == self.proc:
                    out[self.locate(r)[1]] = sub
        return out

    @staticmethod
    def _member_procs(owners: Sequence[int], what: str) -> list[int]:
        """Owning processes in first-appearance order; an order that
        interleaves the ranks of different processes is rejected."""
        member_procs: list[int] = []
        for p in owners:
            if member_procs and member_procs[-1] == p:
                continue
            if p in member_procs:
                raise MPIArgError(
                    f"{what}: rank order interleaves the ranks of different "
                    "processes — sub-comm rank space must stay "
                    "process-contiguous")
            member_procs.append(p)
        return member_procs

    def create_group_members(
        self, members: Sequence[int], tag: int = 0
    ) -> "MultiProcComm":
        """MPI_Comm_create_group: collective over the GROUP members
        ONLY.  CID agreement runs over a temporary sub-view of the member
        processes on a tag-scoped control stream whose key hashes the
        full member list (two groups sharing a process never share an
        agreement stream)."""
        import hashlib

        self._check()
        members = [int(r) for r in members]
        owners = [self.locate(r)[0] for r in members]
        member_procs = self._member_procs(owners, "create_group")
        if self.proc not in member_procs:
            raise MPIArgError(
                "MPI_Comm_create_group called by a process outside the "
                "group (the call is collective over members only)")
        agree = self.dcn.sub(member_procs)
        digest = hashlib.md5(f"{tag}:{members}".encode()).hexdigest()[:16]
        proposals = agree.allgather_obj(_peek_cid(), f"cg.{digest}")
        cid = _reserve_cid_block(max(int(p) for p in proposals), 1)
        return self._make_sub(int(tag), cid, members, owners, member_procs)

    def _make_sub(
        self,
        color: int,
        cid: int,
        members: Sequence[int],
        owners: Sequence[int],
        member_procs: Sequence[int],
    ) -> "MultiProcComm":
        """Construct one split result (members/owners in sub-rank order;
        ``member_procs`` = owning processes in first-appearance order,
        this process among them)."""
        c = MultiProcComm.__new__(MultiProcComm)
        c.procctx = self.procctx
        c.nprocs = len(member_procs)
        c.proc = member_procs.index(self.proc)
        c.dcn = self.dcn.sub(member_procs)
        c.cid = cid
        c.name = f"{self.name}.split({color})"
        c._freed = False
        c._derived = True
        c.proc_sizes = [owners.count(p) for p in member_procs]
        c.offsets = np.cumsum([0] + c.proc_sizes).tolist()
        c.local_size = c.proc_sizes[c.proc]
        c.local_offset = c.offsets[c.proc]
        c.size = len(members)
        c.group = Group(list(members))  # parent-global ranks, sub order
        #: members as (root proc, proc-local index) pairs — the
        #: nesting-independent addressing a partial-replace recipe
        #: publishes (a nested split's group ranks are only PARENT-
        #: relative; these chain through every level to the world)
        c._world_coords = [self._coord_of(m) for m in members]
        my_local = [self.locate(r)[1] for r, p in zip(members, owners) if p == self.proc]
        c.local_mesh = self.local_mesh.submesh(my_local)
        c.local = Comm(
            Group(range(c.local_offset, c.local_offset + c.local_size)),
            c.local_mesh,
            name=f"{c.name}.local{c.proc}",
        )
        c._wire()
        return c

    def free(self) -> None:
        self.dcn.unregister_p2p(self.cid)
        self.dcn.unregister_comm(self.cid)
        if self._chans:
            root = self.dcn._native_root()
            with self._pml_lock:
                for ch in self._chans.values():
                    root.chan_close(ch)
                self._chans.clear()
        self._freed = True

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"<MultiProcComm {self.name} size={self.size} "
            f"proc={self.proc}/{self.nprocs} local={self.local_size}>"
        )


def _host_view(out: torch.Tensor | None) -> np.ndarray | None:
    """A contiguous CPU tensor's memory as the numpy ``recv_into``
    buffer (bfloat16 as its raw words); None for a tensor on the card,
    which is landed by one H2D copy instead."""
    if out is None or out.device.type != "cpu" or not out.is_contiguous():
        return None
    if out.dtype == torch.bfloat16:
        from ompi_tpu_torch.dcn.tcp import BF16_HOST

        return out.view(torch.int16).numpy().view(BF16_HOST)
    return out.numpy()


def _land(payload, out: torch.Tensor) -> torch.Tensor:
    """Copy a received payload into the posted tensor ``out``."""
    from ompi_tpu_torch.coll.han import to_device

    if isinstance(payload, torch.Tensor):
        src = payload
    else:
        src = to_device(np.asarray(payload), out.dtype, out.device)
    if src.numel() != out.numel():
        raise _errors.MPITruncateError(
            f"received {src.numel()} elements into a buffer of {out.numel()}")
    out.copy_(src.reshape(out.shape))
    return out
