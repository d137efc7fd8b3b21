"""Request engine — completion objects for non-blocking operations.

Port of ``ompi_tpu/request.py``.  The reference's request holds async
XLA outputs; here it holds tensors produced by kernels launched on the
current CUDA stream, and

* ``wait``  ≈ ``MPI_Wait``  → ``torch.cuda.Event.synchronize()``
* ``test``  ≈ ``MPI_Test``  → ``torch.cuda.Event.query()``

One event is recorded on the current stream of every card the tensors
lie on (the shards of a ``RankShards`` included) when the request is
made; the request is complete when every one of them is.  A request
over CPU tensors is complete at once (CPU ops run eagerly).
Persistent requests (``MPI_*_init``/``MPI_Start``) hold the resolved
callable and re-dispatch on ``start()``.  A :class:`FutureRequest`
completes when work on a background thread does (the asynchronous
checkpoint writer).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from ompi_tpu_torch.core.errors import MPIRequestError
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.metrics import core as _metrics
from ompi_tpu_torch.trace import core as _trace


class Request:
    """Base non-blocking request (≈ ompi_request_t)."""

    def __init__(self):
        self._complete = False
        self._result: Any = None
        self._cancelled = False

    def _poll(self) -> bool:
        """True if the underlying work finished (non-blocking)."""
        return True

    def _finalize(self) -> Any:
        """The user-visible result; called once on completion."""
        return self._result

    def test(self) -> bool:
        """MPI_Test: non-blocking completion check."""
        if self._complete:
            return True
        if self._poll():
            self._result = self._finalize()
            self._complete = True
        return self._complete

    def wait(self) -> Any:
        """MPI_Wait: block until complete, return the operation result.

        With tracing or metrics on, the blocked time is recorded as a
        ``request`` span and a latency observation: for a request over
        CUDA tensors it includes the wait for the card."""
        if not self._complete:
            t0 = (time.perf_counter_ns()
                  if (_trace._enabled or _metrics._enabled) else 0)
            self._block()
            self._result = self._finalize()
            self._complete = True
            if t0:
                if _trace._enabled:
                    _trace.complete("request", f"{type(self).__name__}.wait", t0)
                if _metrics._enabled:
                    _metrics.observe(f"request_wait_{type(self).__name__}", 0,
                                     time.perf_counter_ns() - t0)
        return self._result

    def _block(self) -> None:
        while not self._poll():  # pragma: no cover - subclasses override
            time.sleep(0)

    def cancel(self) -> None:
        """MPI_Cancel: best effort; work already queued on the card
        cannot be revoked, so this only marks the request."""
        self._cancelled = True

    @property
    def completed(self) -> bool:
        return self._complete

    def free(self) -> None:
        self._result = None


class CompletedRequest(Request):
    """Immediately-complete request (host-path collectives)."""

    def __init__(self, result: Any = None):
        super().__init__()
        self._complete = True
        self._result = result


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, RankShards):
        return list(x.shards)
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def card_events(x) -> list[tuple[int, torch.cuda.Event]]:
    """``(card, event)`` for every card the tensors of ``x`` lie on (the
    shards of a ``RankShards`` included), each event recorded on that
    card's current stream; none for CPU tensors."""
    out = []
    for card in sorted({t.device.index for t in _tensors(x) if t.device.type == "cuda"}):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(card))
        out.append((card, ev))
    return out


class ArrayRequest(Request):
    """Request over tensors whose producing kernels may still be running.

    ``finalize`` post-processes the finished tensors (e.g. the D2H copy
    into a host caller's numpy buffer) exactly once."""

    def __init__(self, arrays: Any, finalize: Callable[[Any], Any] | None = None):
        super().__init__()
        self._arrays = arrays
        self._user_finalize = finalize
        self._events = [ev for _card, ev in card_events(arrays)]

    def _poll(self) -> bool:
        return all(ev.query() for ev in self._events)

    def _block(self) -> None:
        for ev in self._events:
            ev.synchronize()

    def _finalize(self) -> Any:
        if self._user_finalize is not None:
            return self._user_finalize(self._arrays)
        return self._arrays


def block_until_ready(arrays: Any) -> Any:
    """Wait until the kernels producing ``arrays`` have finished (≈
    ``jax.block_until_ready``; records no request span)."""
    ArrayRequest(arrays)._block()
    return arrays


class FutureRequest(Request):
    """Request over work on a background thread: wraps a
    ``concurrent.futures.Future``; a failure of that work re-raises at
    ``wait()``/``test()`` completion."""

    def __init__(self, future):
        super().__init__()
        self._future = future

    def _poll(self) -> bool:
        return self._future.done()

    def _block(self) -> None:
        self._future.exception()  # waits without raising; _finalize raises

    def _finalize(self) -> Any:
        return self._future.result()


class PersistentRequest(Request):
    """MPI persistent collective (``*_init`` → ``start`` → ``wait``,
    repeatable): holds the dispatcher, ``start()`` launches a round."""

    def __init__(self, dispatch: Callable[[], Request]):
        super().__init__()
        self._dispatch = dispatch
        self._active: Request | None = None
        self._complete = True  # inactive persistent requests are "complete"

    def start(self) -> "PersistentRequest":
        if self._active is not None and not self._active.completed:
            raise MPIRequestError("persistent request started while active")
        self._active = self._dispatch()
        self._complete = False
        return self

    def _poll(self) -> bool:
        return self._active is None or self._active.test()

    def _block(self) -> None:
        if self._active is not None:
            self._active.wait()

    def _finalize(self) -> Any:
        return None if self._active is None else self._active.wait()

    @property
    def status(self):
        """Envelope of the most recent round (persistent receive)."""
        return getattr(self._active, "status", None)


# -- wait/test families (MPI_Waitall etc.) -----------------------------


def waitall(requests: Sequence[Request]) -> list[Any]:
    return [r.wait() for r in requests]


def testall(requests: Sequence[Request]) -> bool:
    return all(r.test() for r in requests)


def _poll_backoff(sleep: float) -> float:
    """Exponential poll backoff (0 → 50µs → … → 1ms cap)."""
    time.sleep(sleep)
    return min(max(sleep * 2, 50e-6), 1e-3)


def waitany(requests: Sequence[Request]) -> tuple[int, Any]:
    """Block until at least one completes; returns (index, result)."""
    if not requests:
        raise MPIRequestError("waitany on empty request list")
    if len(requests) == 1:
        return 0, requests[0].wait()
    sleep = 0.0
    while True:
        for i, r in enumerate(requests):
            if r.test():
                return i, r.wait()
        sleep = _poll_backoff(sleep)


def testany(requests: Sequence[Request]) -> tuple[int, Any] | None:
    for i, r in enumerate(requests):
        if r.test():
            return i, r.wait()
    return None


def waitsome(requests: Sequence[Request]) -> list[tuple[int, Any]]:
    """Block until at least one completes; all completed (index, result)."""
    if not requests:
        return []
    sleep = 0.0
    while True:
        done = [(i, r.wait()) for i, r in enumerate(requests) if r.test()]
        if done:
            return done
        sleep = _poll_backoff(sleep)
