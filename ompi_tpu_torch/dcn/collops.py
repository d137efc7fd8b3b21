"""Inter-process collectives over the DCN TCP transport.

The host-side half of the han composition (SURVEY.md §2.7): these run
BETWEEN worker processes ("slices"), on numpy arrays that have already
been reduced/gathered on each process's local fabric.  Process count is
small (one per slice), so the algorithms favor determinism and
simplicity over asymptotics:

* ``allreduce``: gather-to-root with **process-ordered fold** (proc 0,
  1, 2, … — the deterministic order that keeps the multi-slice result
  reproducible) then broadcast;
* ``allgather``/``alltoall``: direct exchanges;
* ``barrier``: token allreduce.

Message matching: every collective on a (cid) stream carries a
monotonically increasing sequence number; SPMD discipline (all
processes issue collectives in the same order per communicator — the
same requirement MPI imposes) guarantees frames pair up.

Port of ``ompi_tpu/dcn/collops.py`` with the same fold orders — the
process-ordered fold and the ring above ``ring_threshold`` — so the
DCN leg of the two packages agrees bit for bit.  The device plane
(:mod:`.device`) is armed at creation, as the reference's is: a large
contiguous payload rides a window and the transport carries only its
descriptor.  With ``trace_causal`` on, coll frames carry the causal wire
context (``tc``) exactly as the reference's do.

``allreduce`` and ``bcast`` also take a tensor (han hands them its
row on the card when the plane is armed).  The schedule is the same:
the chunk bounds of ``np.array_split``, the same fold order, with the
op's ``torch_fn`` on the accumulator's device in place of its
``np_fn`` — for the ops and dtypes whose torch and numpy kernels agree
bit for bit (``tests/test_torch_op.py``), the bits are the numpy fold's.  A chunk
that arbitration keeps on the host plane goes D2H at its send and to
the accumulator's device at its receive; a chunk on a CUDA window stays
on the card, and the allgather phase's posted chunk is the destination
of the receiver's window copy.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.trace import causal as _causal

from . import device as _device
from ompi_tpu_torch.trace import waitgraph as _waitgraph
from . import tcp as tcp_mod
from .tcp import TcpTransport

#: the keys of an engine's ``revoke_counts``: ``rvk`` send attempts that
#: raised (each one retried), peers a revoke sent nothing to because they
#: were held failed, and ``rvk`` frames that arrived for a cid with no
#: live comm
REVOKE_COUNTS = ("send_failed", "skipped_failed", "unmatched")


class AddressTable(list):
    """Peer-address table with **lazy per-entry resolution** — the
    sharded-modex substrate (≈ PMIx "instant-on" lazy ``PMIx_Get``):
    boot primes only the local detector group's slice; a peer outside
    it resolves through ``resolver(proc)`` (one KVS get) on FIRST use
    and is cached.  List-compatible: plain iteration/``list()`` sees
    the RAW slots (``None`` = unresolved) so passive consumers
    (address→proc reverse lookups, diagnostics) never trigger KVS
    traffic; only indexed access — the send path — resolves."""

    def __init__(self, nprocs: int, resolver, primed: dict | None = None):
        super().__init__([None] * int(nprocs))
        self._resolver = resolver
        #: entries resolved on demand (the lazy-modex op signature the
        #: scale soak asserts on, next to the KVSClient op counters)
        self.lazy_resolved = 0
        for p, a in (primed or {}).items():
            list.__setitem__(self, int(p), a)

    def __getitem__(self, i):
        v = list.__getitem__(self, i)
        if v is None and isinstance(i, int) and 0 <= i < len(self):
            v = self._resolver(i)
            list.__setitem__(self, i, v)
            self.lazy_resolved += 1
        return v

    def resolved(self, i: int) -> bool:
        return list.__getitem__(self, i) is not None


class DcnCollEngine:
    """Per-process engine: transport + peer addresses + frame routing.

    Two-phase bring-up matching the modex: construct (opens the listen
    socket, so ``address`` can be published), then ``set_addresses``
    with every peer's endpoint after the fence — or, under the sharded
    lazy modex, an :class:`AddressTable` that resolves cross-group
    peers on first send."""

    def __init__(
        self,
        proc: int,
        nprocs: int,
        addresses: Sequence[str] | None = None,
        eager_limit: int = tcp_mod.EAGER_LIMIT,
        frag_size: int = tcp_mod.FRAG_SIZE,
        max_rndv: int = tcp_mod.MAX_RNDV,
        ring_threshold: int = 64 << 10,
        transport: str = "tcp",
        shm_threshold: int = 2 << 20,
    ):
        self.proc = proc
        self.nprocs = nprocs
        self.ring_threshold = int(ring_threshold)
        self.addresses: list[str] = list(addresses) if addresses else []
        self._queues: dict[tuple, queue.Queue] = {}
        self._qlock = threading.Lock()
        self._seq: dict[int, int] = {}
        #: failure-detection state (ft/detector.py): procs known dead,
        #: the attached detector, and cid → comm for revoke delivery
        self._failed_procs: set[int] = set()
        self._detector = None
        self._comms: dict = {}  # cid → weakref to MultiProcComm
        #: the revoke frames of this engine's comms (ft/ulfm): sends that
        #: raised, peers skipped as failed, frames that found no live comm
        self.revoke_counts = dict.fromkeys(REVOKE_COUNTS, 0)
        #: cid → handler: p2p frames are routed per-communicator so
        #: dup'd comms keep isolated matching (MPI comm isolation)
        self._p2p_handlers: dict[int, Callable] = {}
        #: frames that arrived before their cid was registered — a peer
        #: can send on a freshly dup'd comm before we finish dup() (the
        #: ob1 "unexpected message" problem at the transport layer)
        self._p2p_pending: dict[int, list] = {}
        #: cids explicitly freed: late frames for them are dropped, not
        #: buffered forever (cids are never reused — comm.py counter)
        self._p2p_closed: set[int] = set()
        self._p2p_lock = threading.Lock()
        if transport == "bml":
            # bml/r2: per-peer leg selection (sm same-host, tcp remote)
            self.transport = tcp_mod.BmlTransport(
                self._on_frame,
                eager_limit=eager_limit,
                frag_size=frag_size,
                max_rndv=max_rndv,
                shm_threshold=shm_threshold,
            )
        elif transport == "sm":
            # btl/sm: unix-socket framing + single-copy shm payloads
            self.transport = tcp_mod.ShmTransport(
                self._on_frame,
                eager_limit=eager_limit,
                frag_size=frag_size,
                max_rndv=max_rndv,
                shm_threshold=shm_threshold,
            )
        else:
            self.transport = TcpTransport(
                self._on_frame,
                eager_limit=eager_limit,
                frag_size=frag_size,
                max_rndv=max_rndv,
            )
        # transport-level escalation (deadline expiry, send failure
        # after the reconnect retry round) maps the peer address back
        # to its proc and marks it failed before the transport raises
        # MPIProcFailedError
        self.transport.on_peer_failed = self._transport_peer_failed
        # ... and a dial toward a proc already held failed gives up at
        # once instead of retrying until dcn_connect_timeout
        self.transport.peer_known_failed = self._transport_peer_known_failed
        # the device-resident zero-copy plane (dcn/device.py): large
        # contiguous payloads move through device windows while this
        # transport carries only their descriptor control frames; None
        # when disabled/unsupported — one attribute test per send
        self._device_plane = _device.maybe_create(proc, nprocs)
        # the transports' handshake clock samples, mapped to procs —
        # the cross-rank merge's skew correction (metrics snapshots
        # carry the merged view)
        from ompi_tpu_torch.metrics import core as _mcore

        _mcore.register_clock_provider(self, self.clock_offsets)
        # mesh doctor: transport-level waits (CTS grants, shm-ring
        # backpressure) know only the peer's composite address — this
        # resolver maps them back to root proc indices at snapshot time
        _waitgraph.register_resolver(self, self._waitgraph_resolve)

    def set_addresses(self, addresses: Sequence[str]) -> None:
        if len(addresses) != self.nprocs:
            raise ValueError("address count != nprocs")
        # an AddressTable keeps its resolver (copying through list()
        # would freeze the unresolved holes as None forever)
        self.addresses = (addresses if isinstance(addresses, AddressTable)
                          else list(addresses))

    def update_address(self, proc: int, address: str) -> None:
        """Refresh ONE peer's endpoint in place (elastic recovery:
        replace() installs a reborn incarnation) — works on plain
        lists and lazy AddressTables alike, without collapsing the
        table's unresolved holes the way list-copy-and-set would."""
        if isinstance(self.addresses, AddressTable):
            list.__setitem__(self.addresses, int(proc), address)
        else:
            self.addresses[int(proc)] = address

    @property
    def address(self) -> str:
        return self.transport.address

    def _waitgraph_resolve(self, address: str) -> int | None:
        """Composite address → root proc index for blocked-state
        snapshots (None: not a peer of this engine — spawn worlds)."""
        try:
            return list.index(self.addresses, address)
        except (ValueError, TypeError):
            return None

    def register_p2p(self, cid: int, fn: Callable[[dict, np.ndarray], None]) -> None:
        """Route kind='p2p' frames carrying this cid to the given
        communicator's matching engine (the BTL→pml callback path).
        Frames that beat the registration are drained in arrival order;
        the drain and direct delivery share ``_p2p_lock`` so a frame
        arriving mid-drain cannot overtake buffered predecessors."""
        with self._p2p_lock:
            self._p2p_handlers[cid] = fn
            for env, payload in self._p2p_pending.pop(cid, []):
                fn(env, payload)

    def unregister_p2p(self, cid: int) -> None:
        with self._p2p_lock:
            self._p2p_handlers.pop(cid, None)
            self._p2p_pending.pop(cid, None)
            self._p2p_closed.add(cid)

    # -- frame routing ---------------------------------------------------

    def _queue(self, key: tuple) -> queue.Queue:
        with self._qlock:
            q = self._queues.get(key)
            if q is None:
                q = queue.Queue()
                self._queues[key] = q
            return q

    def _drop_queue(self, key: tuple) -> None:
        with self._qlock:
            self._queues.pop(key, None)

    # -- failure detection / revoke hooks (ft/detector.py) ---------------

    def attach_detector(self, detector) -> None:
        self._detector = detector

    def note_proc_failed(self, proc: int) -> None:
        """Mark a ROOT-engine proc index dead: pending and future
        ``_recv`` calls naming it raise instead of timing out.  Device
        windows staged toward the corpse are reclaimed here — the dead
        receiver can never signal consumed."""
        self._failed_procs.add(proc)
        dp = getattr(self, "_device_plane", None)
        if dp is not None:
            dp.reclaim_failed(proc)

    def note_proc_recovered(self, proc: int,
                            incarnation: int | None = None) -> None:
        """The replace() leg of elastic recovery: a respawned
        incarnation of ROOT proc ``proc`` re-published its endpoint —
        clear the failure marks (engine set + gossiping detector) so
        traffic naming it flows again, and count the restoration on
        the ``respawns`` telemetry counter.  ``incarnation`` feeds the
        detector's versioned-gossip floor: a stale ``flr`` about the
        corpse's incarnation can never re-mark the heal."""
        self._failed_procs.discard(proc)
        det = self._detector
        if det is not None:
            det.clear_failed(proc, incarnation=incarnation)
        dp = getattr(self, "_device_plane", None)
        if dp is not None:
            dp.clear_failed(proc)
        self._bump_stat("respawns")

    def note_proc_healed(self, proc: int) -> None:
        """The detector's false-positive heal: un-mark the proc on the
        engine so blocked receives naming it resume waiting — no
        respawn accounting (nothing was respawned; the mark was
        wrong)."""
        self._failed_procs.discard(proc)
        dp = getattr(self, "_device_plane", None)
        if dp is not None:
            dp.clear_failed(proc)

    def coll_revoke(self, cid) -> None:
        """Revoke fan-out into an engine-resident collective fast path
        — a no-op on the Python plane (blocked receives poll
        ``_check_revoked`` between wait slices); the native engine
        overrides it to wake parked C schedule waits."""

    def _bump_stat(self, name: str) -> None:
        """Increment a Python-plane robustness counter on whatever
        stats surface this engine exports (transport dict here; the
        native engine overrides onto its _py_stats merge)."""
        tr = self.transport
        st = getattr(tr, "stats", None)
        if st is None:  # bml multiplexer: account on the tcp leg
            st = getattr(getattr(tr, "tcp", None), "stats", None)
        if st is not None:
            st[name] = st.get(name, 0) + 1

    def proc_failed(self, local_proc: int) -> bool:
        return local_proc in self._failed_procs

    def _root_engine(self) -> "DcnCollEngine":
        """The engine owning the transport/detector (sub/join views
        chain to their parent)."""
        return self

    def root_proc_of(self, local: int) -> int:
        """Map a LOCAL engine index to the root engine's proc index
        (-1 = unmapped, e.g. across spawn worlds) — same surface the
        native engines expose."""
        return local if 0 <= local < self.nprocs else -1

    def _addr_proc(self, address: str) -> int | None:
        """ROOT proc index owning a transport leg address (composite
        bml addresses match on any leg); None = unmapped."""
        root = self._root_engine()
        for p, a in enumerate(root.addresses):
            if not a:
                continue  # lazy table: never dialed → cannot match
            if a == address or (a.startswith("bml:")
                                and address in a.split("|")):
                return p
        return None

    def clock_offsets(self) -> dict[int, tuple[int, int]]:
        """Per-peer clock-offset estimates (root-proc keyed) from the
        transports' HELLO→SEQACK handshake samples — smallest-RTT
        sample wins when both legs measured a peer."""
        root = self._root_engine()
        tr = root.transport
        legs = ([tr] if hasattr(tr, "clock_offsets")
                else [leg for leg in (getattr(tr, "tcp", None),
                                      getattr(tr, "sm", None))
                      if leg is not None])
        out: dict[int, tuple[int, int]] = {}
        for leg in legs:
            if not getattr(leg, "_running", True):
                continue  # a closed transport measures nothing
            for addr, (off, rtt) in dict(
                    getattr(leg, "clock_offsets", None) or {}).items():
                p = self._addr_proc(addr)
                if p is None:
                    continue
                cur = out.get(p)
                if cur is None or rtt < cur[1]:
                    out[p] = (int(off), int(rtt))
        return out

    def _transport_peer_failed(self, address: str) -> int | None:
        """Transport escalation callback: peer address → ROOT proc,
        marking it failed on the detector (gossiped, like an in-band
        BTL error under ULFM) or the engine's failure set."""
        root = self._root_engine()
        proc = self._addr_proc(address)
        if proc is not None:
            det = root._detector
            if det is not None:
                det.mark_failed(proc)
            else:
                root.note_proc_failed(proc)
        return proc

    def _transport_peer_known_failed(self, address: str) -> bool:
        """Transport dial cut-off: whether the ROOT proc owning a peer
        address is held failed on this engine."""
        proc = self._addr_proc(address)
        return proc is not None and proc in self._root_engine()._failed_procs

    def _escalate_deadline(self, site: str, timeout: float, msg: str,
                           failed_rank: int | None = None,
                           root_proc: int | None = None,
                           **detail) -> None:
        """THE deadline-expiry escalation — every blocking wait that
        runs out its ``dcn_*_timeout`` converges here: flight-record
        the transport state, count ``dcn_deadline_expired``, mark the
        peer failed (gossiping detector when attached, engine failure
        set otherwise), and raise MPIProcFailedError — never a bare
        RuntimeError.  ``failed_rank`` is the caller-space index named
        in the error; ``root_proc`` the detector-space index to mark
        (resolved via root_proc_of(failed_rank) when omitted)."""
        from ompi_tpu_torch.core.errors import MPIProcFailedError
        from ompi_tpu_torch.metrics import export as _mexport
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record("deadline_expired", site=site,
                       timeout_s=float(timeout), **detail)
        # crash-path export: a deadline escalation often precedes the
        # process aborting — flush configured telemetry now (once-latch),
        # marked partial; a later clean finalize overwrites it
        _mexport.crash_dump(f"deadline_{site}")
        root = self._root_engine()
        tr = root.transport
        st = getattr(tr, "stats", None)
        if st is None:  # bml multiplexer: account on the tcp leg
            st = getattr(getattr(tr, "tcp", None), "stats", None)
        if st is not None:
            st["deadline_expired"] += 1
        else:
            py = getattr(root, "_py_stats", None)
            if py is not None:
                py["deadline_expired"] += 1
        rp = root_proc
        if rp is None and failed_rank is not None:
            rp = self.root_proc_of(failed_rank)
        if rp is not None and rp >= 0 and rp != root.proc:
            det = root._detector
            if det is not None:
                det.mark_failed(rp)
            else:
                root.note_proc_failed(rp)
        raise MPIProcFailedError(
            msg,
            failed=((failed_rank,)
                    if failed_rank is not None and failed_rank >= 0
                    else ()))

    def _note_peer_activity(self, src: int) -> None:
        """Refresh the failure detector's liveness clock for a peer we
        just received from: ANY inbound frame proves the process alive,
        so a rank pinned in a long collective that cannot pump
        heartbeats is not falsely declared dead."""
        root = self._root_engine()
        det = root._detector
        if det is None:
            return
        rp = self.root_proc_of(src)
        note = getattr(det, "note_activity", None)
        if note is not None and rp is not None and rp >= 0:
            note(rp)

    def send_ctrl(self, dst: int, envelope: dict) -> None:
        """Small control frame (heartbeat / failure gossip / revoke)."""
        self.transport.send(self.addresses[dst], dict(envelope),
                            np.zeros(0, np.uint8))

    def register_comm(self, cid, comm) -> None:
        import weakref

        self._comms[cid] = weakref.ref(comm)

    def unregister_comm(self, cid) -> None:
        self._comms.pop(cid, None)

    def _on_frame(self, env: dict, payload: np.ndarray) -> None:
        kind = env.get("kind")
        if kind == "hb":
            if self._detector is not None:
                # the envelope rides along: leader heartbeats carry the
                # anti-entropy failure-set digest
                self._detector.on_heartbeat(env["src"], env)
            return
        if kind == "flrsync":
            if self._detector is not None:
                self._detector.on_flrsync(env)
            return
        if kind == "flc":
            if self._detector is not None:
                self._detector.on_clear(env)
            return
        if self._detector is not None and kind != "flr":
            # any inbound frame refreshes the sender's liveness clock —
            # not just heartbeats.  The frame's src is local to the
            # engine its comm rides (sub-comm frames carry sub-local
            # indices); map through the registered comm's engine.
            src = env.get("src")
            if isinstance(src, int):
                ref = self._comms.get(env.get("cid"))
                comm = ref() if ref is not None else None
                eng = getattr(comm, "dcn", None) if comm is not None else None
                try:
                    rp = (eng.root_proc_of(src) if eng is not None
                          else self.root_proc_of(src))
                except Exception:  # noqa: BLE001 — stale comm mid-free
                    rp = -1
                if rp is not None and 0 <= rp < self.nprocs:
                    note = getattr(self._detector, "note_activity", None)
                    if note is not None:
                        note(rp)
        if kind == "flr":
            if self._detector is not None:
                # versioned gossip: (proc, inc, epoch) validated against
                # the heal floor; a leader relays accepted news into
                # its group (hierarchical flood, not full-mesh)
                self._detector.on_gossip(env)
            return
        if kind == "rvk":
            ref = self._comms.get(env["cid"])
            comm = ref() if ref is not None else None
            if comm is not None:
                from ompi_tpu_torch.ft import ulfm
                from ompi_tpu_torch.trace import waitgraph as _waitgraph

                if _waitgraph._enabled and _waitgraph.busy():
                    # the revoke is about to wake a blocked wait: flush the
                    # post-mortem export with the blocked state first, as
                    # the local revoke paths do (a peer's revoke can beat
                    # this process's own to the wait)
                    from ompi_tpu_torch.metrics import export as _mexport

                    _mexport.crash_dump("revoke")
                ulfm.state(comm).revoked = True
                # wake any C fast-path schedule parked on this comm's
                # private stream (the Python plane's _check_revoked
                # mirrored into cctx_recv_msg)
                self._root_engine().coll_revoke(env["cid"])
            else:
                self.revoke_counts["unmatched"] += 1
            return
        if env.get("kind") == "p2p":
            cid = env.get("cid")
            desc = env.pop("dev", None)
            if desc is not None:
                # device-plane p2p: the frame carried only the window
                # descriptor — materialize before matching (the recv-
                # semaphore wait runs on the delivery thread, bounded by
                # the shared recv deadline)
                src = env.get("src")
                payload = _device.materialize(
                    self._root_engine(), desc,
                    src_root=(int(src) if src is not None else None))
            with self._p2p_lock:
                fn = self._p2p_handlers.get(cid)
                if fn is not None:
                    fn(env, payload)
                elif cid not in self._p2p_closed:
                    self._p2p_pending.setdefault(cid, []).append((env, payload))
            return
        key = (env["cid"], env["seq"], env["src"])
        self._queue(key).put((env, payload))

    def _next_seq(self, cid: int) -> int:
        s = self._seq.get(cid, 0)
        self._seq[cid] = s + 1
        return s

    def _send(self, dst: int, cid: int, seq: int, payload: np.ndarray, meta=None) -> None:
        env = {"kind": "coll", "cid": cid, "seq": seq, "src": self.proc}
        if meta is not None:
            env["meta"] = meta
        if _causal._enabled:
            # causal wire context: root span id + hop index, riding
            # the frame envelope (zero wire bytes when disabled)
            tc = _causal.note_send(self.root_proc_of(dst))
            if tc is not None:
                env["tc"] = tc
        # plane arbitration (size / layout / reachability): a large
        # contiguous payload rides a device window and the host plane
        # carries only its descriptor — the RTS of the DMA protocol
        desc = _device.try_stage(self._root_engine(), payload,
                                 self.root_proc_of(dst))
        if desc is not None:
            env[_device.DESC_KEY] = desc
            self.transport.send(self.addresses[dst], env,
                                np.zeros(0, np.uint8))
            return
        self.transport.send(self.addresses[dst], env,
                            _device.host_array(payload))

    def _recv(self, src: int, cid: int, seq: int,
              timeout: float | None = None, into=None) -> np.ndarray:
        return self._recv_full(src, cid, seq, timeout, into=into)[1]

    def _recv_full(self, src: int, cid: int, seq: int,
                   timeout: float | None = None, into=None):
        """``into``: optional destination — an ndarray posted on the
        transport (recv_into-style delivery) so a matching inbound
        payload lands straight in it, or a tensor, which only a device
        window lands in, or a ``torch.device``, the card a CUDA window's
        bytes land on (the receiving rank's); the caller detects
        placement by identity (the returned payload IS ``into``) and
        skips its copy.  Best-effort:
        a frame that raced ahead of the posting simply delivers the
        copy-path array."""
        from ompi_tpu_torch.core.var import Deadline, dcn_timeout

        if timeout is None:
            timeout = dcn_timeout("recv")
        tw0 = time.perf_counter_ns() if _causal._enabled else 0
        key = (cid, seq, src)
        posted = None
        if isinstance(into, np.ndarray):
            post = getattr(self.transport, "post_recv_into", None)
            if post is not None:
                post(cid, seq, src, into)
                posted = True
        q = self._queue(key)
        dl = Deadline(timeout)
        wtok = 0
        try:
            while True:
                # short slices keep the wait sensitive to failure
                # detection: a peer declared dead mid-collective raises
                # promptly (ULFM in-band error) instead of waiting out
                # the full deadline
                try:
                    got = q.get(timeout=dl.slice(0.25))
                    break
                except queue.Empty:
                    # first missed slice = already blocked: register
                    # the wait for the mesh doctor (lazy — a recv that
                    # completes inside its first slice never pays)
                    if not wtok and _waitgraph._enabled:
                        wtok = _waitgraph.begin(
                            "coll_recv", peer=self.root_proc_of(src),
                            plane="host", cid=cid, seq=seq)
                    if self.proc_failed(src):
                        from ompi_tpu_torch.core.errors import (
                            MPIProcFailedError,
                        )

                        raise MPIProcFailedError(
                            f"DCN recv: peer proc {src} failed "
                            f"(cid={cid}, seq={seq})", failed=(src,)
                        ) from None
                    self._check_revoked(cid, src, seq)
                    if dl.expired():
                        self._escalate_deadline(
                            "coll_recv", timeout,
                            f"DCN recv deadline "
                            f"(dcn_recv_timeout={timeout}s)"
                            f" expired: proc {self.proc} waiting for "
                            f"proc {src} (cid={cid}, seq={seq}) — peer "
                            f"dead, wedged, or collective order "
                            f"mismatch",
                            failed_rank=src, cid=str(cid), seq=int(seq),
                            src=int(src))
        finally:
            if wtok:
                _waitgraph.end(wtok)
            if posted:
                # withdraw an unconsumed posting (frame raced ahead of
                # the registration, or this wait errored out)
                self.transport.discard_posted(cid, seq, src)
        env, payload = got
        desc = env.pop("dev", None)
        if desc is not None:
            # device-plane delivery: the frame was only the window
            # descriptor — run the recv-semaphore wait and materialize
            # (straight into the posted buffer when one matches)
            rp = self.root_proc_of(src)
            payload = _device.materialize(self._root_engine(), desc,
                                          into=into,
                                          src_root=(rp if rp >= 0
                                                    else None))
            got = (env, payload)
        # "tc" is a reserved envelope key: popped whether or not THIS
        # rank records (a causal-enabled peer's frame must never leak
        # a foreign field to envelope consumers — the native plane's
        # meta pop enforces the same contract)
        tc = env.pop("tc", None)
        if tw0:
            # causal edge head: the frame's wire context + this recv's
            # measured wait (device materialization included)
            _causal.note_recv(self.root_proc_of(src), tc,
                              time.perf_counter_ns() - tw0)
        self._note_peer_activity(src)
        # (cid, seq, src) keys are single-use (seqs are monotonic per
        # stream), and the producer's put necessarily preceded this get
        # — drop the queue so long-running jobs (and the per-instance
        # NBC streams) don't grow the dict without bound
        self._drop_queue(key)
        return got

    def _check_revoked(self, cid, src, seq) -> None:
        """Revoke interrupt for a BLOCKED collective receive (ULFM:
        ``MPIX_Comm_revoke`` must wake every pending operation on the
        comm, not just guard new ones).  Without it, a survivor parked
        in a fold/bcast recv when another member aborts the collective
        sits out the full recv deadline and then wrongly escalates the
        LIVE peer it was waiting on — at np≥16 that false positive
        poisons the whole recovery.  Recovery streams (replace/shrink/
        agree string cids) are never registered comms, so they stay
        uninterruptible by the old comm's revocation — by design."""
        ref = self._root_engine()._comms.get(cid)
        comm = ref() if ref is not None else None
        if comm is None:
            return
        from ompi_tpu_torch.ft import ulfm

        if ulfm.is_revoked(comm):
            from ompi_tpu_torch.core.errors import MPIRevokedError

            raise MPIRevokedError(
                f"DCN recv: {comm.name} revoked while waiting for "
                f"proc {src} (cid={cid}, seq={seq})")

    def send_p2p(self, dst_proc: int, envelope: dict, payload: np.ndarray) -> None:
        envelope = dict(envelope)
        envelope["kind"] = "p2p"
        desc = _device.try_stage(self._root_engine(), payload,
                                 self.root_proc_of(dst_proc))
        if desc is not None:
            envelope[_device.DESC_KEY] = desc
            self.transport.send(self.addresses[dst_proc], envelope,
                                np.zeros(0, np.uint8))
            return
        self.transport.send(self.addresses[dst_proc], envelope, payload)

    def local_proc_of(self, root_proc: int):
        """Root engine: proc indices ARE root indices."""
        return root_proc if 0 <= root_proc < self.nprocs else None

    # -- collectives -----------------------------------------------------

    def allreduce(self, x: np.ndarray, op: Op, cid: int,
                  ordered: bool = False) -> np.ndarray:
        """Inter-process allreduce.

        Small payloads (or ``ordered=True`` / non-commutative ops) use
        the process-ordered fold at proc 0 + broadcast — the
        deterministic bracketing that keeps multi-slice results
        reproducible.  Payloads ≥ ``ring_threshold`` with commutative
        ops take the bandwidth-optimal ring reduce-scatter + ring
        allgather schedule (2·N·(P−1)/P wire bytes per process instead
        of the root's O(P·N) ingress — ≈ coll_base_allreduce_intra_ring,
        SURVEY.md §2.2, now on the DCN level per VERDICT r1 weak #4).

        A tensor ``x`` folds with ``op.torch_fn`` on its own device and
        comes back as a tensor there (see the module docstring) — except
        a CUDA tensor whose messages are all below the device plane's
        threshold: they would each cross host memory anyway, so it moves
        to the host once and folds there, and comes back on the CPU."""
        tensor = isinstance(x, torch.Tensor)
        if self.nprocs == 1:
            return x if tensor else np.asarray(x)
        x = x if tensor else np.asarray(x)
        nbytes = x.numel() * x.element_size() if tensor else x.nbytes
        ring = (not ordered and getattr(op, "commutative", False)
                and nbytes >= self.ring_threshold)
        if tensor and x.is_cuda:
            dp = self._root_engine()._device_plane
            if dp is None or (nbytes // self.nprocs if ring else nbytes) < dp.min_size:
                x = x.cpu()
        if ring:
            return self._allreduce_ring(x, op, cid)
        seq_gather = self._next_seq(cid)
        seq_bcast = self._next_seq(cid)
        land = x.device if tensor else None  # a CUDA window lands on x's card
        if self.proc == 0:
            acc = x
            for p in range(1, self.nprocs):
                got = self._recv(p, cid, seq_gather, into=land)
                acc = (op.torch_fn(acc, _device.as_tensor(got, x)) if tensor
                       else op.np_fn(acc, got))
            for p in range(1, self.nprocs):
                self._send(p, cid, seq_bcast, acc)
            return acc if tensor else np.asarray(acc)
        self._send(0, cid, seq_gather, x)
        got = self._recv(0, cid, seq_bcast, into=land)
        return _device.as_tensor(got, x) if tensor else got

    def _allreduce_ring(self, x: np.ndarray, op: Op, cid: int) -> np.ndarray:
        """Ring allreduce: P−1 reduce-scatter steps + P−1 allgather
        steps over the process ring, each moving one ~N/P chunk to the
        right neighbor.  Commutative ops only (the per-chunk fold order
        walks the ring, not rank order).  A tensor accumulates on its
        own device, folding with ``op.torch_fn``."""
        P, me = self.nprocs, self.proc
        tensor = isinstance(x, torch.Tensor)
        if tensor:
            acc = x.detach().reshape(-1).clone()
        else:
            acc = np.ascontiguousarray(x).reshape(-1).copy()
        # chunk boundaries (np.array_split semantics: sizes differ by ≤1)
        base, extra = divmod(acc.shape[0], P)
        bounds = [0]
        for i in range(P):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))

        def chunk(i: int) -> slice:
            return slice(bounds[i], bounds[i + 1])

        right, left = (me + 1) % P, (me - 1) % P
        # every proc burns the same 2(P-1) seqs in the same order (SPMD)
        seqs = [self._next_seq(cid) for _ in range(2 * (P - 1))]
        for s in range(P - 1):
            send_i = (me - s) % P
            recv_i = (me - s - 1) % P
            self._send(right, cid, seqs[s], acc[chunk(send_i)])
            got = self._recv(left, cid, seqs[s], into=acc.device if tensor else None)
            dst = acc[chunk(recv_i)]
            if tensor:
                dst.copy_(op.torch_fn(_device.as_tensor(got, dst), dst))
            else:
                np.copyto(dst, op.np_fn(got, dst))
        for s in range(P - 1):
            seq = seqs[P - 1 + s]
            send_i = (me + 1 - s) % P
            recv_i = (me - s) % P
            self._send(right, cid, seq, acc[chunk(send_i)])
            # allgather phase: post the destination chunk itself —
            # recv_into-style delivery (or a device window's copy) lands
            # the neighbor's bytes straight in `acc` (identity confirms;
            # else copy)
            dst = acc[chunk(recv_i)]
            got = self._recv(left, cid, seq, into=dst)
            if got is not dst:
                if tensor:
                    dst.copy_(_device.as_tensor(got, dst))
                else:
                    np.copyto(dst, got)
        return acc.reshape(x.shape)

    def bcast(self, x: np.ndarray, root: int, cid: int) -> np.ndarray:
        """Root sends ``x`` to every process.  A tensor ``x`` (its value
        significant on the root only) comes back as a tensor like it."""
        if self.nprocs == 1:
            return x
        seq = self._next_seq(cid)
        if self.proc == root:
            for p in range(self.nprocs):
                if p != root:
                    self._send(p, cid, seq, x)
            return x
        if isinstance(x, torch.Tensor):
            return _device.as_tensor(self._recv(root, cid, seq, into=x.device), x)
        return self._recv(root, cid, seq)

    def allgather(self, x: np.ndarray, cid: int) -> list[np.ndarray]:
        """Returns [proc 0's x, proc 1's x, …] on every process."""
        if self.nprocs == 1:
            return [x]
        seq = self._next_seq(cid)
        for p in range(self.nprocs):
            if p != self.proc:
                self._send(p, cid, seq, x)
        out = []
        for p in range(self.nprocs):
            out.append(x if p == self.proc else self._recv(p, cid, seq))
        return out

    def alltoall(self, blocks: Sequence[np.ndarray], cid: int) -> list[np.ndarray]:
        """blocks[p] goes to process p; returns what each process sent us."""
        if self.nprocs == 1:
            return [np.asarray(blocks[0])]
        seq = self._next_seq(cid)
        for p in range(self.nprocs):
            if p != self.proc:
                self._send(p, cid, seq, np.asarray(blocks[p]))
        out = []
        for p in range(self.nprocs):
            out.append(
                np.asarray(blocks[self.proc]) if p == self.proc else self._recv(p, cid, seq)
            )
        return out

    def allgather_obj_hub(self, obj, cid) -> list:
        """Hub-pattern twin of :meth:`allgather_obj`: gather every
        member's object at index 0 (the lowest member) and rebroadcast
        the combined list — 2(P−1) frames through ONE well-connected
        hub instead of the full-mesh P(P−1) exchange.  Recovery rounds
        (replace/rejoin CID agreement) use this: they run while the
        mesh is already degraded, and at np≥16 a full-mesh object
        exchange is a thundering herd of simultaneous fresh dials that
        can overwhelm a starved box into cascade failures — the hub's
        connections already exist (it is the collective fold root or
        the minimum survivor that published the beacon)."""
        if self.nprocs == 1:
            return [obj]
        seq_gather = self._next_seq(cid)
        seq_bcast = self._next_seq(cid)
        empty = np.zeros(0, np.uint8)
        if self.proc == 0:
            out = [obj] * self.nprocs
            for p in range(1, self.nprocs):
                env, _ = self._recv_full(p, cid, seq_gather)
                out[p] = env.get("meta")
            for p in range(1, self.nprocs):
                self._send(p, cid, seq_bcast, empty, meta=out)
            return out
        self._send(0, cid, seq_gather, empty, meta=obj)
        env, _ = self._recv_full(0, cid, seq_bcast)
        return list(env.get("meta") or [])

    def allgather_obj(self, obj, cid: int) -> list:
        """Allgather of a small JSON-serializable object (rides the
        frame envelope; control metadata only, e.g. jagged shapes)."""
        if self.nprocs == 1:
            return [obj]
        seq = self._next_seq(cid)
        empty = np.zeros(0, np.uint8)
        for p in range(self.nprocs):
            if p != self.proc:
                self._send(p, cid, seq, empty, meta=obj)
        out = []
        for p in range(self.nprocs):
            if p == self.proc:
                out.append(obj)
            else:
                env, _ = self._recv_full(p, cid, seq)
                out.append(env.get("meta"))
        return out

    def scatter(self, blocks_by_proc: Sequence[np.ndarray] | None, root: int, cid: int) -> np.ndarray:
        """Root sends block p to process p (O(N) wire bytes); others
        receive their block. ``blocks_by_proc`` meaningful on root."""
        if self.nprocs == 1:
            return np.asarray(blocks_by_proc[0])
        seq = self._next_seq(cid)
        if self.proc == root:
            for p in range(self.nprocs):
                if p != root:
                    self._send(p, cid, seq, np.asarray(blocks_by_proc[p]))
            return np.asarray(blocks_by_proc[root])
        return self._recv(root, cid, seq)

    def gather(self, x: np.ndarray, root: int, cid: int) -> list[np.ndarray] | None:
        """True fan-in: every non-root process sends its block to root
        ONCE; root returns [proc 0's x, …], others return None (MPI:
        recvbuf significant only at root). O(total bytes) DCN ingress at
        root — vs allgather's P× aggregate."""
        if self.nprocs == 1:
            return [x]
        seq = self._next_seq(cid)
        if self.proc != root:
            self._send(root, cid, seq, x)
            return None
        return [
            x if p == root else self._recv(p, cid, seq)
            for p in range(self.nprocs)
        ]

    def barrier(self, cid: int) -> None:
        self.allreduce(np.zeros(1, np.int32), _SUM_TOKEN, cid)

    # -- view factories (overridden by the native engine so sub-comms
    # and spawn joins stay on the same byte plane as their root) ------

    def sub(self, procs: Sequence[int]) -> "DcnSubEngine":
        return DcnSubEngine(self, procs)

    def join(self, addresses: Sequence[str], proc: int) -> "DcnJoinEngine":
        return DcnJoinEngine(self, addresses, proc)

    def close(self) -> None:
        if getattr(self, "_device_plane", None) is not None:
            # drain-then-close: the plane gives in-flight staged windows
            # a bounded 2 s to be consumed before sweeping
            self._device_plane.close()
        self.transport.close()


class DcnSubEngine(DcnCollEngine):
    """A sub-communicator's view of the DCN (cross-process comm_split —
    VERDICT r1 missing #3): remaps a subset of the parent engine's
    processes onto contiguous indices ``[0, P')`` while sharing the
    parent's transport, frame router, and delivery queues.

    Stream isolation comes from the communicator's CID (globally agreed
    via the comm layer's CID block reservation), so a sub-engine only
    needs its own sequence space; frames it sends carry the SUB-local
    ``src`` index, and members of the same sub-comm look them up under
    the same key — the parent and any sibling sub-comms never share a
    cid.  Sub-engines compose: a sub-engine of a sub-engine chains the
    index mapping through ``addresses``/``send_p2p`` delegation
    (≈ ompi_comm_split of an already-split communicator)."""

    def __init__(self, parent: DcnCollEngine, procs: Sequence[int]):
        self.parent = parent
        self.procs = list(procs)
        self.proc = self.procs.index(parent.proc)
        self.nprocs = len(self.procs)
        self.ring_threshold = parent.ring_threshold
        self._seq = {}

    @property
    def addresses(self) -> list[str]:
        pa = self.parent.addresses
        return [pa[p] for p in self.procs]

    @property
    def transport(self) -> TcpTransport:
        return self.parent.transport

    def set_addresses(self, addresses) -> None:  # pragma: no cover
        raise NotImplementedError(
            "sub-engines inherit the parent's addresses")

    def _queue(self, key: tuple) -> queue.Queue:
        return self.parent._queue(key)

    def _drop_queue(self, key: tuple) -> None:
        self.parent._drop_queue(key)

    def register_p2p(self, cid: int, fn: Callable) -> None:
        self.parent.register_p2p(cid, fn)

    def unregister_p2p(self, cid: int) -> None:
        self.parent.unregister_p2p(cid)

    def send_p2p(self, dst_proc: int, envelope: dict, payload: np.ndarray) -> None:
        self.parent.send_p2p(self.procs[dst_proc], envelope, payload)

    def proc_failed(self, local_proc: int) -> bool:
        return self.parent.proc_failed(self.procs[local_proc])

    def _root_engine(self) -> DcnCollEngine:
        return self.parent._root_engine()

    def root_proc_of(self, local: int) -> int:
        return self.parent.root_proc_of(self.procs[local])

    def send_ctrl(self, dst: int, envelope: dict) -> None:
        self.parent.send_ctrl(self.procs[dst], envelope)

    def register_comm(self, cid, comm) -> None:
        self.parent.register_comm(cid, comm)

    def unregister_comm(self, cid) -> None:
        self.parent.unregister_comm(cid)

    def local_proc_of(self, root_proc: int):
        pl = self.parent.local_proc_of(root_proc)
        if pl is None or pl not in self.procs:
            return None
        return self.procs.index(pl)

    def close(self) -> None:
        """Lifecycle is owned by the root engine; freeing a sub-comm
        must not tear down the job's transport."""


class DcnJoinEngine(DcnCollEngine):
    """A JOINED view over two worlds' processes (MPI_Comm_spawn /
    MPI_Intercomm_merge across jobs): the address list spans both
    worlds, indices are global-in-the-union, and the local transport +
    delivery queues are shared with this process's own engine.  Stream
    isolation comes from spawn-scoped string cids (``sp<k>#...``),
    which neither world's integer cids can collide with."""

    def __init__(self, local: DcnCollEngine, addresses: Sequence[str],
                 proc: int):
        self.parent = local
        self._addresses = list(addresses)
        self.proc = proc
        self.nprocs = len(self._addresses)
        self.ring_threshold = local.ring_threshold
        self._seq = {}

    @property
    def addresses(self) -> list[str]:
        return self._addresses

    @property
    def transport(self) -> TcpTransport:
        return self.parent.transport

    def set_addresses(self, addresses) -> None:  # pragma: no cover
        raise NotImplementedError(
            "join engines are constructed with addresses")

    def _queue(self, key: tuple) -> queue.Queue:
        return self.parent._queue(key)

    def _drop_queue(self, key: tuple) -> None:
        self.parent._drop_queue(key)

    def register_p2p(self, cid, fn: Callable) -> None:
        self.parent.register_p2p(cid, fn)

    def unregister_p2p(self, cid) -> None:
        self.parent.unregister_p2p(cid)

    def register_comm(self, cid, comm) -> None:
        self.parent.register_comm(cid, comm)

    def unregister_comm(self, cid) -> None:
        self.parent.unregister_comm(cid)

    # send_p2p/send_ctrl: inherited — the base implementations read
    # self.addresses/self.transport, which these properties redirect

    def proc_failed(self, local_proc: int) -> bool:
        # FT does not span spawn worlds (each world runs its own
        # detector over its own index space)
        return False

    def _root_engine(self) -> DcnCollEngine:
        return self.parent._root_engine()

    def root_proc_of(self, local: int) -> int:
        return -1  # FT does not span spawn worlds

    def local_proc_of(self, root_proc: int):
        return None  # detector fan-out stays within each world

    def close(self) -> None:
        """Transport owned by the process's own engine."""


class _TokenSum:
    name = "token_sum"
    np_fn = staticmethod(lambda a, b: a + b)


_SUM_TOKEN = _TokenSum()
