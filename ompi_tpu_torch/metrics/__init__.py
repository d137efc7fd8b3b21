"""``ompi_tpu_torch.metrics`` — counters, histograms and their exports.

Port of ``ompi_tpu/metrics``: :mod:`.core` (counter/histogram
aggregation, ``--mca metrics_enable 1``), :mod:`.export` (Prometheus
text + JSONL at finalize, ``--mca metrics_output``) and :mod:`.flight`
(the flight recorder) and :mod:`.straggler` (the collective straggler
profiler, armed with the metrics plane) and :mod:`.live` (the live
telemetry plane: per-rank frame publishers, the aggregator's
``/metrics``, ``/json``, ``/history``, ``/critical`` and ``/waitgraph``
scrape endpoints, ``--mca telemetry_enable 1``).
"""

from .core import (  # noqa: F401
    GAUGES,
    LAT_BUCKETS,
    NATIVE_COUNTERS,
    SIZE_BUCKETS,
    enable,
    enabled,
    native_counters,
    native_value,
    observe,
    observe_size,
    op_stats,
    register_provider,
    register_vars,
    reset,
    size_histogram,
    size_ops,
    snapshot,
    sync_from_store,
    zero_stats,
)
