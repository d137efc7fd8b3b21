"""Event tracing — per-process timelines of api / coll / request spans.

Port of ``ompi_tpu/trace``: :mod:`.core` is the ring-buffer tracer
(``--mca trace_enable 1``; off by default, one boolean test per hook),
:mod:`.chrome` the Chrome trace-event export written at finalize when
``--mca trace_output <path>`` is set, :mod:`.merge` the cross-rank
merge of per-process trace files, :mod:`.causal` the cross-rank causal
tracer (``--mca trace_causal 1``) and :mod:`.waitgraph` the hang
diagnosis.
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
