"""Snapshot exporters — Prometheus text format + JSONL.

Port of ``ompi_tpu/metrics/export.py``, with the same ``ompi_tpu_``
metric names and file layout, so ``tools/metrics_report.py`` reads the
port's files unchanged.  Written at finalize when ``--mca
metrics_enable 1`` is on and ``--mca metrics_output <path>`` names a
base path:

* ``<path>.<proc>.prom``  — Prometheus text exposition format;
* ``<path>.<proc>.jsonl`` — every flight record in order, then the
  final snapshot.

:func:`crash_dump` writes the same files early, marked ``partial``,
from the escalation paths (a deadline, a dead peer) and at exit of a
process that never reached finalize.
"""

from __future__ import annotations

import json
import sys

from . import core as _core
from . import flight as _flight

PREFIX = "ompi_tpu"


def _size_bucket_edges() -> list[int]:
    """Upper bucket edges in bytes: 1, 2, 4, … (last is +Inf)."""
    return [1 << i for i in range(_core.SIZE_BUCKETS - 1)]


def _lat_bucket_edges_us() -> list[int]:
    return [1 << i for i in range(_core.LAT_BUCKETS - 1)]


def _prom_hist(lines: list[str], name: str, labels: str, hist: list[int],
               edges: list[int], total: int | None = None) -> None:
    """Cumulative Prometheus _bucket series from a disjoint log2
    histogram."""
    cum = 0
    for i, edge in enumerate(edges):
        cum += hist[i] if i < len(hist) else 0
        lines.append(f'{name}_bucket{{{labels}le="{edge}"}} {cum}')
    cum += hist[len(edges)] if len(hist) > len(edges) else 0
    lines.append(f'{name}_bucket{{{labels}le="+Inf"}} {cum}')
    lines.append(f"{name}_count{{{labels.rstrip(',')}}} {cum}"
                 if labels else f"{name}_count {cum}")
    if total is not None:
        lines.append(f"{name}_sum{{{labels.rstrip(',')}}} {total}"
                     if labels else f"{name}_sum {total}")


def dcn_kind(k: str) -> str:
    """gauge-vs-counter classification of a ``dcn_<k>`` family."""
    return "gauge" if k in _core.GAUGES or k.endswith("_hwm") else "counter"


def dcn_family(lines: list[str], k: str, samples: list[tuple[str, int]],
               origin: str = "Native", suffix: str = "") -> None:
    """Append one ``{PREFIX}_dcn_<k>`` metric family: HELP/TYPE header
    plus one sample per ``(labels, value)`` row."""
    kind = dcn_kind(k)
    lines.append(f"# HELP {PREFIX}_dcn_{k} {origin} DCN transport "
                 f"{kind} {k}{suffix}")
    lines.append(f"# TYPE {PREFIX}_dcn_{k} {kind}")
    for labels, v in samples:
        lines.append(f"{PREFIX}_dcn_{k}{labels} {int(v)}")


def to_prometheus(snap: dict) -> str:
    """Render one snapshot as Prometheus text exposition format."""
    proc = snap.get("proc")
    plabel = f'proc="{proc}",' if proc is not None else ""
    lines: list[str] = []
    for k, v in (snap.get("native") or {}).items():
        labels = f'{{{plabel.rstrip(",")}}}' if plabel else ""
        dcn_family(lines, k, [(labels, int(v))],
                   suffix=" (libtpudcn TdcnStats block)")
    lines.append(f"# HELP {PREFIX}_op_size_bytes Per-op payload size "
                 "histogram (log2 buckets)")
    lines.append(f"# TYPE {PREFIX}_op_size_bytes histogram")
    for op, st in (snap.get("ops") or {}).items():
        labels = f'{plabel}op="{op}",'
        _prom_hist(lines, f"{PREFIX}_op_size_bytes", labels,
                   st["size_hist"], _size_bucket_edges(),
                   total=st.get("bytes"))
    lines.append(f"# HELP {PREFIX}_op_latency_us Per-op latency "
                 "histogram (log2 µs buckets)")
    lines.append(f"# TYPE {PREFIX}_op_latency_us histogram")
    for op, st in (snap.get("ops") or {}).items():
        if not any(st["lat_hist"]):
            continue
        labels = f'{plabel}op="{op}",'
        _prom_hist(lines, f"{PREFIX}_op_latency_us", labels,
                   st["lat_hist"], _lat_bucket_edges_us(),
                   total=(st.get("total_ns", 0) + 999) // 1000)
    # straggler profiler: per-op call/wait totals (the rank-local leg
    # of the cross-rank skew attribution)
    strag = snap.get("straggler") or {}
    if strag:
        lines.append(f"# HELP {PREFIX}_coll_wait_ns_total In-collective "
                     "wall time by op (arrival wait + wire)")
        lines.append(f"# TYPE {PREFIX}_coll_wait_ns_total counter")
        for op, st in strag.items():
            lines.append(f'{PREFIX}_coll_wait_ns_total{{{plabel}op="{op}"'
                         f'}} {int(st.get("wait_ns", 0))}')
    # causal-tracing counters (trace_causal_* pvar twins): rank-local
    # record/edge totals — the cross-rank blame itself lives in the
    # snapshot's "causal" records, joined offline
    causal_c = snap.get("causal_counters") or {}
    for k in sorted(causal_c):
        lines.append(f"# HELP {PREFIX}_trace_causal_{k} causal "
                     f"tracing {k} (trace/causal.py)")
        lines.append(f"# TYPE {PREFIX}_trace_causal_{k} counter")
        labels = f'{{{plabel.rstrip(",")}}}' if plabel else ""
        lines.append(f"{PREFIX}_trace_causal_{k}{labels} "
                     f"{int(causal_c[k])}")
    spc = snap.get("spc") or {}
    if spc:
        lines.append(f"# HELP {PREFIX}_spc_total SPC software "
                     "performance counters")
        lines.append(f"# TYPE {PREFIX}_spc_total counter")
        for k, v in sorted(spc.items()):
            lines.append(f'{PREFIX}_spc_total{{{plabel}counter="{k}"}} '
                         f"{int(v)}")
    lines.append("")
    return "\n".join(lines)


def write(path_base: str, proc: int = 0,
          partial: bool = False) -> list[str]:
    """Export the final snapshot (+ flight records) for one process;
    returns the paths written.  ``partial=True`` marks a crash-path
    dump: the snapshot carries ``"partial": true``, so the report tools
    know its counters stop mid-run."""
    snap = _core.snapshot(reason="crash" if partial else "finalize",
                          proc=proc)
    if partial:
        snap["partial"] = True
    # whether this process brought up a CUDA context (a CPU job never
    # does): the file then tells which processes worked on the card
    torch = sys.modules.get("torch")
    snap["cuda_initialized"] = bool(torch is not None and torch.cuda.is_initialized())
    # and the hand-written kernels it launched (none in a process that
    # never loaded them)
    ck = sys.modules.get("ompi_tpu_torch.coll.cuda_kernels")
    snap["kernel_launches"] = dict(ck.LAUNCHES) if ck is not None else {}
    from ompi_tpu_torch.trace import causal as _causal

    if _causal.enabled():
        # the finalize causal export: this rank's recent causal records
        # (the offline cross-rank join's per-rank input) + its counters
        snap["causal"] = _causal.recent()
        snap["causal_counters"] = _causal.counters_snapshot()
    prom_path = f"{path_base}.{proc}.prom"
    with open(prom_path, "w") as f:
        f.write(to_prometheus(snap))
    jsonl_path = f"{path_base}.{proc}.jsonl"
    with open(jsonl_path, "w") as f:
        for rec in _flight.records():
            f.write(json.dumps(rec) + "\n")
        f.write(json.dumps(snap) + "\n")
    return [prom_path, jsonl_path]


#: crash-path once-latch: a dying process flushes at most once (the
#: escalation sites and the atexit hook may all fire on one death)
_crashed = False


def crash_dump(reason: str = "crash") -> list[str]:
    """Crash-path export: flush the configured telemetry now, marked
    ``partial: true`` — called from the escalation paths and the api
    layer's atexit hook, so a dying or aborting process still leaves
    its metrics and trace files (a clean finalize later overwrites
    them).  Never raises; a no-op when nothing is configured (the latch
    stays armed then) and on every call after the first."""
    global _crashed
    if _crashed:
        return []
    paths: list[str] = []
    try:
        import os

        from ompi_tpu_torch.core import mca
        from ompi_tpu_torch.trace import chrome as _tchrome
        from ompi_tpu_torch.trace import core as _tcore

        store = mca.default_context().store
        proc = int(os.environ.get("OMPI_TPU_PROC", "0"))
        mout = store.get("metrics_output", "") if _core._enabled else ""
        tout = store.get("trace_output", "") if _tcore.enabled() else ""
        if not mout and not tout:
            return []
        _crashed = True
        if mout:
            _flight.record("crash_export", cause=reason)
            paths += write(str(mout), proc=proc, partial=True)
        if tout:
            paths.append(_tchrome.dump(f"{tout}.{proc}.json", pid=proc,
                                       partial=True))
    except Exception:  # noqa: BLE001 — the dump rides failure paths
        pass
    return paths


def reset_crash_latch() -> None:
    """Re-arm the crash-path latch (finalize, and tests)."""
    global _crashed
    _crashed = False
