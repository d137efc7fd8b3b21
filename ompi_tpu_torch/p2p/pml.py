"""Point-to-point messaging layer — the pml matching engine.

Port of ``ompi_tpu/p2p/pml.py`` (≈ ``pml/ob1`` reduced to its semantic
core).  One process drives every rank, so what remains of ob1 is **MPI
matching**:

* a posted-receive queue and an unexpected-message queue per
  destination rank;
* match on (source, tag) with ``ANY_SOURCE``/``ANY_TAG`` wildcards;
* non-overtaking: messages from one source match in send order;
* ``Status`` carrying (source, tag, count, nbytes); probe/iprobe.

Send is **buffered eager**: the payload is copied at send time, so the
sender's buffer is reusable at once.  Every virtual rank shares the
card, so a tensor's copy is a ``clone()`` on the tensor's own device,
queued on the current stream; a numpy payload stays numpy, and no
tensor is moved to the host.  The clone's completion rides with the
payload as a CUDA event (as ``ArrayRequest`` carries one for the
collectives): a receive completes on the host when the match happens,
and its ``wait()`` returns only once the clone has landed, so a
consumer on another stream or a host read never sees it in flight.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIRankError
from ompi_tpu_torch.metrics import core as _metrics
from ompi_tpu_torch.request import Request
from ompi_tpu_torch.tool import spc
from ompi_tpu_torch.trace import core as _trace

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2


@dataclass
class Status:
    """MPI_Status: envelope of a completed or probed receive."""

    source: int
    tag: int
    count: int  # elements of the payload's dtype
    nbytes: int = 0  # payload bytes

    @classmethod
    def null(cls) -> "Status":
        return cls(PROC_NULL, ANY_TAG, 0, 0)


def _copy_payload(buf):
    """The eager copy: (payload, CUDA event of its clone or None)."""
    if isinstance(buf, torch.Tensor):
        data = buf.detach().clone()
        if data.device.type != "cuda":
            return data, None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(data.device))
        return data, ev
    if isinstance(buf, np.ndarray):
        return buf.copy(), None
    return np.asarray(buf).copy(), None


def _count_of(payload) -> int:
    if isinstance(payload, torch.Tensor):
        return payload.numel()
    try:
        return int(np.prod(np.shape(payload)))
    except Exception:
        return 0


def _nbytes_of(payload) -> int:
    try:
        return int(payload.nbytes)
    except AttributeError:
        try:
            return int(np.asarray(payload).nbytes)
        except Exception:
            return 0


@dataclass
class _Posted:
    source: int
    tag: int
    request: "RecvRequest"
    seq: int


@dataclass
class _Unexpected:
    source: int
    tag: int
    payload: Any
    seq: int
    event: Any = None


class RecvRequest(Request):
    """Pending receive; completed by the matching engine."""

    def __init__(self):
        super().__init__()
        self._event = threading.Event()
        self.status: Status | None = None
        self._payload: Any = None
        #: the CUDA event of the payload's clone (None for host payloads)
        self._copied = None
        #: cross-process receives: (timeout_s, check, escalate) armed by
        #: the comm layer — see :meth:`arm_remote_guard`
        self._guard = None

    def _deliver(self, payload: Any, status: Status, copied=None) -> None:
        self._payload = payload
        self._copied = copied
        self.status = status
        self._event.set()

    def arm_remote_guard(self, timeout: float, check, escalate) -> None:
        """Make the blocking wait failure- and deadline-sensitive for a
        receive whose sender lives in another process: ``check()``
        raises once the watched peer is marked failed, ``escalate(t)``
        raises when the ``timeout`` deadline expires (returning instead
        re-arms it).  Local receives stay unguarded."""
        self._guard = (float(timeout), check, escalate)

    def _poll(self) -> bool:
        return self._event.is_set() and (self._copied is None or self._copied.query())

    def _block(self) -> None:
        if self._guard is None:
            self._event.wait()
        else:
            from ompi_tpu_torch.trace import waitgraph as _waitgraph

            timeout, check, escalate = self._guard
            deadline = time.monotonic() + timeout
            wtok = 0
            try:
                while not self._event.wait(max(0.0, min(0.25, deadline - time.monotonic()))):
                    # hang diagnosis: one full slice without delivery is a
                    # blocked wait — register lazily (first failed slice)
                    if not wtok and _waitgraph._enabled:
                        wtok = _waitgraph.begin(
                            "p2p_recv", peer=getattr(self, "wait_peer", None),
                            plane="host")
                    check()
                    if time.monotonic() >= deadline:
                        escalate(timeout)
                        deadline = time.monotonic() + timeout
            finally:
                if wtok:
                    _waitgraph.end(wtok)
        if self._copied is not None:
            self._copied.synchronize()

    def _finalize(self) -> Any:
        return self._payload


class MatchingEngine:
    """Per-communicator matching state (≈ ob1's per-comm match tables).

    Matching walks the queues in arrival order, so the non-overtaking
    guarantee holds: for a given (source, tag) the earliest-sent
    unexpected message (lowest seq) matches first, and the
    earliest-posted receive wins an incoming message."""

    def __init__(self, comm_size: int):
        self.comm_size = comm_size
        self._lock = threading.Lock()
        self._seq = 0
        # per destination rank
        self._posted: dict[int, list[_Posted]] = collections.defaultdict(list)
        self._unexpected: dict[int, list[_Unexpected]] = collections.defaultdict(list)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _check_rank(self, r: int, wild_ok: bool = False) -> None:
        if r == PROC_NULL:
            return
        if wild_ok and r == ANY_SOURCE:
            return
        if not 0 <= r < self.comm_size:
            raise MPIRankError(f"rank {r} outside [0, {self.comm_size})")

    # -- send ------------------------------------------------------------------

    def send(self, source: int, dest: int, payload: Any, tag: int,
             dest_device=None, _account: bool = True) -> None:
        """``dest_device`` is the reference's receiver device; every
        virtual rank shares the card here, so it is unused.
        ``_account=False`` marks a relayed delivery that the sending
        process already counted."""
        self._check_rank(source)
        self._check_rank(dest)
        if dest == PROC_NULL:
            return
        if tag < 0:
            raise MPIArgError(f"send tag must be >= 0, got {tag}")
        if _account and spc._attached:
            spc.inc("send")
            spc.inc("send_bytes", spc.payload_nbytes(payload))
        if _account and _metrics._enabled:
            _metrics.observe_size("p2p_send", spc.payload_nbytes(payload))
        t0 = _trace.now() if _trace._enabled else 0
        data, copied = _copy_payload(payload)
        with self._lock:
            seq = self._next_seq()
            posted = self._posted[dest]
            for i, p in enumerate(posted):
                if p.source in (ANY_SOURCE, source) and p.tag in (ANY_TAG, tag):
                    posted.pop(i)
                    p.request._deliver(
                        data, Status(source, tag, _count_of(data), _nbytes_of(data)),
                        copied)
                    if t0:
                        _trace.complete("p2p", "send", t0, src=source, dst=dest, tag=tag,
                                        matched=True, nbytes=_nbytes_of(data))
                    return
            self._unexpected[dest].append(_Unexpected(source, tag, data, seq, copied))
        if t0:
            _trace.complete("p2p", "send", t0, src=source, dst=dest, tag=tag,
                            matched=False, nbytes=_nbytes_of(data))

    # -- recv ------------------------------------------------------------------

    def irecv(self, dest: int, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> RecvRequest:
        self._check_rank(dest)
        self._check_rank(source, wild_ok=True)
        spc.inc("irecv")
        if _trace._enabled:
            _trace.instant("p2p", "irecv", dst=dest, src=source, tag=tag)
        req = RecvRequest()
        if source == PROC_NULL:
            req._deliver(None, Status.null())
            return req
        with self._lock:
            uq = self._unexpected[dest]
            best = None
            for i, m in enumerate(uq):
                if source in (ANY_SOURCE, m.source) and tag in (ANY_TAG, m.tag):
                    if best is None or m.seq < uq[best].seq:
                        best = i
            if best is not None:
                m = uq.pop(best)
                req._deliver(m.payload, Status(m.source, m.tag, _count_of(m.payload),
                                               _nbytes_of(m.payload)), m.event)
                return req
            self._posted[dest].append(_Posted(source, tag, req, self._next_seq()))
        return req

    # -- probe -----------------------------------------------------------------

    def iprobe(self, dest: int, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status | None:
        """Envelope of the first matching unexpected message, not
        consumed; a PROC_NULL probe matches at once with the null status."""
        self._check_rank(dest)
        self._check_rank(source, wild_ok=True)
        if source == PROC_NULL:
            return Status.null()
        with self._lock:
            best = None
            for m in self._unexpected[dest]:
                if source in (ANY_SOURCE, m.source) and tag in (ANY_TAG, m.tag):
                    if best is None or m.seq < best.seq:
                        best = m
            if best is None:
                return None
            return Status(best.source, best.tag, _count_of(best.payload),
                          _nbytes_of(best.payload))

    def pending_unexpected(self, dest: int) -> int:
        with self._lock:
            return len(self._unexpected[dest])

    def pending_posted(self, dest: int) -> int:
        with self._lock:
            return len(self._posted[dest])
