"""Native matching engine bridge — pml over libtpudcn's C matcher.

Port of ``ompi_tpu/p2p/pml_native.py``.  The hot half of
``ompi/mca/pml/ob1`` (the matching engine under MPI_Send/Recv) lives in
C++: posted/unexpected queues, wildcard matching, and the
non-overtaking rule are in ``csrc/dcn.cc``; a blocked ``recv`` sleeps on
a C condition variable the C receiver thread signals — no Python
between wire and wakeup.  This module is the thin Python face: argument
checks, SPC accounting, the buffered-eager copy for local sends, and
Request/Status materialization.

Same-process sends of numpy payloads are memcpy'd into the C matcher;
tensors enter it as HANDLE references (the clone and its CUDA event stay
in a Python-side table, and a receiver waits on the event before it
returns the tensor), so ANY_SOURCE receives match local and remote
senders in one total arrival order — the single-queue property ob1's
matching relies on.

Selected automatically for communicators whose pml is the default
``eager`` component on a native DCN engine; monitored/logged pmls
(monitoring, vprotocol) keep the Python engine via the dispatcher
path.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ompi_tpu_torch.core.errors import MPIArgError, MPIRankError
from ompi_tpu_torch.request import Request
from ompi_tpu_torch.tool import spc
from ompi_tpu_torch.trace import waitgraph as _waitgraph
from .pml import (
    ANY_SOURCE,
    ANY_TAG,
    PROC_NULL,
    Status,
    _copy_payload,
    _count_of,
    _nbytes_of,
)


class _Held:
    """A local tensor send parked in the engine's handle table: the
    clone and the CUDA event recorded after it (None on the CPU)."""

    __slots__ = ("data", "event")

    def __init__(self, data, event):
        self.data = data
        self.event = event

    def take(self):
        if self.event is not None:
            self.event.synchronize()
        return self.data


def _from_handle(root, h: int):
    got = root.take_handle(h)
    return got.take() if isinstance(got, _Held) else got


class NativeRecvRequest(Request):
    """Pending receive whose completion lives in the C engine."""

    def __init__(self, root, rid: int):
        super().__init__()
        self._root = root
        self._rid = rid
        self._msg = None
        self.status: Status | None = None
        self._lock = threading.Lock()
        #: cross-process receives: (timeout_s, check, escalate) — the
        #: same remote-recv guard contract as pml.RecvRequest
        self._guard = None

    def arm_remote_guard(self, timeout: float, check, escalate) -> None:
        self._guard = (float(timeout), check, escalate)

    def _take(self, msg) -> None:
        from ompi_tpu_torch.dcn.native import _wrap_payload

        if msg.pyhandle:
            payload = _from_handle(self._root, msg.pyhandle)
            count, nbytes = int(msg.count), int(msg.nbytes)
        else:
            payload = _wrap_payload(self._root._lib, msg)
            count, nbytes = int(payload.size), int(payload.nbytes)
        self._msg = payload
        self.status = Status(int(msg.src), int(msg.tag), count, nbytes)

    def _poll(self) -> bool:
        from ompi_tpu_torch.dcn.native import TdcnMsg

        with self._lock:
            if self._msg is not None:
                return True
            msg = TdcnMsg()
            rc = self._root._lib.tdcn_req_test(
                self._root._h, self._rid, ctypes.byref(msg))
            if rc == 0:
                self._take(msg)
                return True
            return False

    def _block(self) -> None:
        from ompi_tpu_torch.dcn.native import TdcnMsg, _RC_CLOSED

        dl = None
        if self._guard is not None:
            from ompi_tpu_torch.core.var import Deadline

            dl = Deadline(self._guard[0])
        with self._lock:
            if self._msg is not None:
                return
            msg = TdcnMsg()
            wtok = 0
            try:
                while True:
                    rc = self._root._lib.tdcn_req_wait(
                        self._root._h, self._rid, 0.25, ctypes.byref(msg))
                    if rc == 0:
                        self._take(msg)
                        return
                    if rc == _RC_CLOSED or rc < 0:
                        from ompi_tpu_torch.core.errors import MPIInternalError

                        raise MPIInternalError(
                            f"native recv wait failed (rc={rc})")
                    # hang diagnosis: a timed-out wait slice means the
                    # request is blocked — register lazily (once)
                    if not wtok and _waitgraph._enabled:
                        wtok = _waitgraph.begin(
                            "p2p_recv",
                            peer=getattr(self, "wait_peer", None),
                            plane="native")
                    if dl is not None:
                        _timeout, check, escalate = self._guard
                        check()
                        if dl.expired():
                            escalate(_timeout)
                            # escalate returning = keep waiting (anysrc
                            # liveness guard, all members alive): re-arm
                            dl = Deadline(_timeout)
            finally:
                if wtok:
                    _waitgraph.end(wtok)

    def _finalize(self):
        return self._msg


class _NullRecvRequest(Request):
    def __init__(self):
        super().__init__()
        self.status = Status.null()
        self._complete = True
        self._result = None


class NativeMatchingEngine:
    """Per-communicator matching facade over the root native engine.

    Interface-compatible with :class:`ompi_tpu_torch.p2p.pml.MatchingEngine`
    (send/irecv/iprobe/pending_*) — everything the Comm layers and the
    persistent/partitioned mixins call."""

    def __init__(self, root, cid, comm_size: int):
        self._root = root
        self._cid = str(cid)
        self._cid_b = self._cid.encode()
        self.comm_size = comm_size

    def _check_rank(self, r: int, wild_ok: bool = False) -> None:
        if r == PROC_NULL or (wild_ok and r == ANY_SOURCE):
            return
        if not 0 <= r < self.comm_size:
            raise MPIRankError(f"rank {r} outside [0, {self.comm_size})")

    # -- send (local ranks only; remote riders use the DCN frame path) --

    def send(self, source: int, dest: int, payload, tag: int,
             dest_device=None, _account: bool = True) -> None:
        self._check_rank(source)
        self._check_rank(dest)
        if dest == PROC_NULL:
            return
        if tag < 0:
            raise MPIArgError(f"send tag must be >= 0, got {tag}")
        if _account and spc.attached():
            spc.inc("send")
            spc.inc("send_bytes", spc.payload_nbytes(payload))
        if isinstance(payload, np.ndarray):
            # the engine's local data path memcpys into C — that IS the
            # buffered-eager copy; a Python-side copy first would be a
            # second one
            data = payload
        else:
            data = _Held(*_copy_payload(payload))
        self._root.local_send(self._cid, source, dest, tag, data,
                              _count_of(payload), _nbytes_of(payload))

    # -- recv -----------------------------------------------------------

    def irecv(self, dest: int, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> Request:
        self._check_rank(dest)
        self._check_rank(source, wild_ok=True)
        spc.inc("irecv")
        if source == PROC_NULL:
            return _NullRecvRequest()
        rid = self._root._lib.tdcn_post_recv(
            self._root._h, self._cid_b, dest, source, tag)
        return NativeRecvRequest(self._root, rid)

    # -- probe ----------------------------------------------------------

    def iprobe(self, dest: int, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> Status | None:
        from ompi_tpu_torch.dcn.native import TdcnMsg

        self._check_rank(dest)
        self._check_rank(source, wild_ok=True)
        if source == PROC_NULL:
            return Status.null()
        msg = TdcnMsg()
        rc = self._root._lib.tdcn_probe(
            self._root._h, self._cid_b, dest, source, tag,
            ctypes.byref(msg))
        if rc != 0:
            return None
        if msg.pyhandle:
            count, nbytes = int(msg.count), int(msg.nbytes)
        else:
            dt = np.dtype(msg.dtype.decode() or "u1")
            count = int(msg.nbytes) // max(1, dt.itemsize)
            nbytes = int(msg.nbytes)
        return Status(int(msg.src), int(msg.tag), count, nbytes)

    def recv_blocking(self, dest: int, source: int, tag: int,
                      fail_proc: int = -1, remote: bool = False,
                      guard=None, into=None):
        """Blocking receive in ONE C crossing (match-or-post + sleep on
        the request condvar): the fast path under MPI_Recv.  Returns
        (payload, Status); raises on engine close or watched-proc
        failure — and, for a SPECIFIC REMOTE source (``remote`` is the
        comm layer's verdict), escalates after the shared
        ``dcn_recv_timeout`` deadline instead of re-arming the C wait
        forever.  ANY_SOURCE and local sources keep plain MPI blocking
        semantics: there is no dead transport to escalate — unless the
        comm layer armed ``guard`` (the opt-in ``dcn_anysrc_timeout``
        triple): then expiry runs the guard's communicator-wide
        liveness check and RE-ARMS when every member is alive.

        ``into``: optional contiguous destination ndarray — the ctypes
        ``recv_into`` surface (tdcn_precv_into): the post carries the
        buffer, so a racing in-order streamed RTS lands its FRAGs
        straight in it and a copy-path delivery is memcpy'd into it in
        C.  When placement/fill happened the returned payload IS
        ``into`` (identity check — nothing left to copy); oversized
        messages fall back to the engine-owned payload for the
        caller's truncation handling."""
        from ompi_tpu_torch.dcn.native import _tls, _tls_msg, _wrap_payload

        self._check_rank(dest)
        self._check_rank(source, wild_ok=True)
        spc.inc("irecv")
        if source == PROC_NULL:
            return None, Status.null()
        root = self._root
        msg = _tls_msg()
        into_ptr = 0
        into_cap = 0
        if into is not None:
            if not (isinstance(into, np.ndarray)
                    and into.flags["C_CONTIGUOUS"]):
                into = None
            else:
                into_ptr = into.ctypes.data
                into_cap = into.nbytes
        dl = None
        anysrc_guard = None
        if remote and source != ANY_SOURCE:
            from ompi_tpu_torch.core.var import Deadline

            dl = Deadline.for_timeout("recv")
        elif guard is not None and source == ANY_SOURCE:
            from ompi_tpu_torch.core.var import Deadline

            anysrc_guard = guard
            dl = Deadline(guard[0])
        wtok = 0
        try:
            while True:
                if into is not None:
                    rc = root._lib.tdcn_precv_into(
                        root._h, self._cid_b, dest, source, tag, fail_proc,
                        dl.slice(2.0) if dl is not None else 120.0,
                        into_ptr, into_cap, _tls.msg_ref)
                else:
                    rc = root._lib.tdcn_precv(
                        root._h, self._cid_b, dest, source, tag, fail_proc,
                        dl.slice(2.0) if dl is not None else 120.0,
                        _tls.msg_ref)
                if rc == 0:
                    break
                if rc == -2:
                    from ompi_tpu_torch.core.errors import MPIProcFailedError

                    raise MPIProcFailedError(
                        f"recv: peer rank {source} failed",
                        failed=(source,))
                if rc < 0:
                    from ompi_tpu_torch.core.errors import MPIInternalError

                    raise MPIInternalError(f"native recv failed (rc={rc})")
                # hang diagnosis: one expired C wait slice without a
                # match — register the blocked site lazily (once).
                # precv parks inside the C call, which does not hit the
                # engine's own wait registry, so this is the only
                # introspection point for the native p2p plane.
                if not wtok and _waitgraph._enabled:
                    wtok = _waitgraph.begin(
                        "p2p_recv",
                        peer=fail_proc if fail_proc >= 0 else None,
                        plane="native", cid=self._cid)
                if dl is not None and dl.expired():
                    if anysrc_guard is not None:
                        from ompi_tpu_torch.core.var import Deadline

                        _t, g_check, g_escalate = anysrc_guard
                        g_check()
                        g_escalate(_t)
                        dl = Deadline(_t)  # all alive: re-arm the wait
                        continue
                    root._escalate_deadline(
                        "p2p_recv", dl.seconds,
                        f"recv deadline (dcn_recv_timeout={dl.seconds}s) "
                        f"expired: rank {dest} waiting for rank {source} "
                        f"(tag={tag}) — peer dead, wedged, or send never "
                        f"issued", failed_rank=source, root_proc=fail_proc,
                        src=int(source), tag=int(tag))
        finally:
            if wtok:
                _waitgraph.end(wtok)
        if msg.pyhandle:
            payload = _from_handle(root, msg.pyhandle)
            count, nbytes = int(msg.count), int(msg.nbytes)
        elif into is not None and msg.data == into_ptr:
            # delivered in place (streamed RTS fill, ring eager
            # placement, or the C-side memcpy): the payload IS the
            # caller's buffer — identity tells the caller nothing is
            # left to copy or free
            payload = into
            nbytes = int(msg.nbytes)
            dt = np.dtype(msg.dtype.decode() or "u1")
            count = nbytes // max(1, dt.itemsize)
        else:
            payload = _wrap_payload(root._lib, msg)
            count, nbytes = int(payload.size), int(payload.nbytes)
        return payload, Status(int(msg.src), int(msg.tag), count, nbytes)

    def pending_unexpected(self, dest: int) -> int:
        return int(self._root._lib.tdcn_pending(
            self._root._h, self._cid_b, dest, 0))

    def pending_posted(self, dest: int) -> int:
        return int(self._root._lib.tdcn_pending(
            self._root._h, self._cid_b, dest, 1))
