"""The tracer — a per-process ring buffer of events.

Port of ``ompi_tpu/trace/core.py``.  Every in-path hook is guarded by
the module-level ``_enabled`` boolean, so with tracing off (the
default) a hook costs one attribute test.  When on, an event append is
one tuple plus a ``deque.append``, and one short critical section
updates the per-(layer, op) aggregates the MPI_T pvars read.

Event model (Chrome trace-event phases):

* **complete** (``ph="X"``): a span with a start and a duration, one
  record emitted at the end;
* **instant** (``ph="i"``): a point event (an algorithm decision, the
  first build of a collective's callable).

Collective spans carry a ``(comm, op, seq)`` key, ``seq`` being a
per-(comm, op) issue counter — the cross-rank merge key of the
reference.

Spans time the **host**, as in the reference: timestamps are
``time.perf_counter_ns()`` around the Python call.  A CUDA launch
returns before the card finishes its work, so an api or coll span of a
collective on a CUDA tensor measures dispatch and launch, not the
kernels; the request ``wait`` span is where the device time of an
i-collective shows.  Export anchors the timestamps to the wall-clock
epoch captured at enable time.
"""

from __future__ import annotations

import collections
import threading
import time

#: the in-path gate — hooks read this attribute directly
_enabled = False

_DEFAULT_BUFFER = 65536

_events: collections.deque = collections.deque(maxlen=_DEFAULT_BUFFER)
_dropped = 0
_seq_lock = threading.Lock()
_seqs: dict[tuple[str, str], int] = {}
#: cumulative per-(layer, op) span aggregates, updated at append time.
#: Insertion-ordered and grow-only while tracing runs: the MPI_T pvar
#: namespace indexes into it (reset zeroes values in place).
_stats: dict[tuple[str, str], dict] = {}
#: wall-clock anchor: (time_ns, perf_counter_ns) captured at enable
_epoch: tuple[int, int] = (0, 0)

#: histogram buckets: log2 of the span duration in µs; bucket i holds
#: spans with 2**(i-1) µs <= dur < 2**i µs (bucket 0: sub-µs), the
#: last bucket is open-ended.
HIST_BUCKETS = 16


def now() -> int:
    """Monotonic timestamp (ns) — pair with :func:`complete`."""
    return time.perf_counter_ns()


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True, buffer_events: int | None = None) -> None:
    """Turn tracing on/off (``--mca trace_enable 1`` goes through
    :func:`sync_from_store`)."""
    global _enabled, _events, _epoch
    if buffer_events is not None and buffer_events != _events.maxlen:
        _events = collections.deque(_events, maxlen=max(1, int(buffer_events)))
    if flag and not _enabled:
        _epoch = (time.time_ns(), time.perf_counter_ns())
    _enabled = flag


def _zero(st: dict) -> None:
    st["count"] = 0
    st["total_ns"] = 0
    st["max_ns"] = 0
    st["hist"] = [0] * HIST_BUCKETS


def reset() -> None:
    """Drop recorded events, the drop count, the seq counters and the
    span aggregates (tests; a live tool session zeroes the aggregates
    in place with :func:`zero_stats` instead)."""
    global _dropped
    with _seq_lock:
        _events.clear()
        _dropped = 0
        _seqs.clear()
        _stats.clear()


def next_seq(comm: str, op: str) -> int:
    """Per-(comm, op) issue counter — the cross-rank merge key."""
    key = (comm, op)
    with _seq_lock:
        s = _seqs.get(key, 0)
        _seqs[key] = s + 1
        return s


def seqs() -> dict[tuple[str, str], int]:
    """The next seq of every (comm, op) issued so far."""
    with _seq_lock:
        return dict(_seqs)


def _append(ev: tuple) -> None:
    global _dropped
    if len(_events) == _events.maxlen:
        _dropped += 1  # benign race: diagnostic counter
    _events.append(ev)


def complete(layer: str, name: str, t0_ns: int, comm: str = "",
             seq: int = -1, **args) -> None:
    """Record a finished span: ``t0_ns`` from :func:`now` at entry."""
    if not _enabled:
        return
    dur = time.perf_counter_ns() - t0_ns
    _append(("X", t0_ns, dur, layer, name, comm, seq, args or None))
    # the pvar counters must match the ring's event census exactly, so
    # the read-modify-write takes the lock (enabled path only)
    with _seq_lock:
        st = _stats.get((layer, name))
        if st is None:
            st = _stats[(layer, name)] = {}
            _zero(st)
        st["count"] += 1
        st["total_ns"] += dur
        if dur > st["max_ns"]:
            st["max_ns"] = dur
        st["hist"][min((dur // 1000).bit_length(), HIST_BUCKETS - 1)] += 1


def instant(layer: str, name: str, comm: str = "", **args) -> None:
    """Record a point event (decision, protocol choice, milestone)."""
    if not _enabled:
        return
    _append(("i", time.perf_counter_ns(), 0, layer, name, comm, -1,
             args or None))


def wrap_call(layer: str, name: str, fn, comm: str = "", **args):
    """Closure recording one complete span around each ``fn(*a, **k)``
    call — used where a dispatch layer hands out a callable (coll-table
    lookups).  api-layer wraps get a fresh seq per call."""
    keyed = layer == "api"

    def traced(*a, **k):
        t0 = time.perf_counter_ns()
        try:
            return fn(*a, **k)
        finally:
            complete(layer, name, t0, comm=comm,
                     seq=next_seq(comm, name) if keyed else -1, **args)

    traced.__name__ = f"traced_{name}"
    traced.__wrapped__ = fn
    return traced


# -- introspection ------------------------------------------------------


def events() -> list[tuple]:
    """Snapshot of the ring buffer (oldest first)."""
    return list(_events)


def event_count() -> int:
    return len(_events)


def dropped() -> int:
    return _dropped


def epoch() -> tuple[int, int]:
    """(wall-clock ns, perf_counter ns) anchor captured at enable."""
    return _epoch


def span_stats() -> dict[tuple[str, str], dict]:
    """Cumulative per-(layer, op) span aggregates: count, total_ns,
    max_ns and the log2-µs latency histogram — the MPI_T pvar source."""
    return {k: dict(v, hist=list(v["hist"])) for k, v in _stats.items()}


def span_ops() -> list[tuple[str, str]]:
    """(layer, op) pairs with ≥1 recorded span, in first-seen order —
    the pvar namespace (grow-only while tracing runs)."""
    return list(_stats)


def span_count(layer: str, op: str) -> int:
    st = _stats.get((layer, op))
    return st["count"] if st else 0


def latency_histogram(layer: str, op: str) -> list[int]:
    """Log2-µs duration histogram for one (layer, op); zeros if unseen."""
    st = _stats.get((layer, op))
    return list(st["hist"]) if st else [0] * HIST_BUCKETS


def zero_stats() -> None:
    """Zero every span aggregate and the drop counter in place, keeping
    the event ring, the seq counters and the pvar namespace — the
    session-wide MPI_T pvar_reset."""
    global _dropped
    with _seq_lock:
        _dropped = 0
        for st in _stats.values():
            _zero(st)


def reset_span_stat(layer: str, op: str) -> None:
    """Zero one (layer, op) aggregate in place (single-handle reset)."""
    with _seq_lock:
        st = _stats.get((layer, op))
        if st is not None:
            _zero(st)


def reset_dropped() -> None:
    global _dropped
    _dropped = 0


# -- MCA wiring -----------------------------------------------------------


def register_vars(store) -> None:
    """Register this subsystem's vars on ``store`` (idempotent; the
    default context already has them from the central table)."""
    from ompi_tpu_torch.core.var import register_observability_vars

    register_observability_vars(store)


def sync_from_store(store) -> None:
    enable(
        bool(store.get("trace_enable", False)),
        buffer_events=int(store.get("trace_buffer_events", _DEFAULT_BUFFER)),
    )
