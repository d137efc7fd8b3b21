"""Event tracing — per-process timelines of api / coll / request spans.

Port of ``ompi_tpu/trace``: :mod:`.core` is the ring-buffer tracer
(``--mca trace_enable 1``; off by default, one boolean test per hook),
:mod:`.chrome` the Chrome trace-event export written at finalize when
``--mca trace_output <path>`` is set.  The cross-rank merge and causal
tracing of the reference belong to the multi-process planes and are
not ported yet.
"""

from .core import (  # noqa: F401
    complete,
    dropped,
    enable,
    enabled,
    event_count,
    events,
    instant,
    latency_histogram,
    next_seq,
    now,
    register_vars,
    reset,
    span_stats,
    sync_from_store,
    wrap_call,
)
