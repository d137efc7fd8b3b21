"""Chrome trace-event JSON export.

Port of ``ompi_tpu/trace/chrome.py``, format for format: ``X``
(complete) events with microsecond ``ts``/``dur``, ``i`` (instant)
events, and ``M`` metadata naming the process and one virtual thread
per layer, so ``chrome://tracing``/Perfetto show lanes api / coll /
request, and ``tools/trace_report.py`` reads the file unchanged.
Timestamps are anchored to the wall-clock epoch captured when tracing
was enabled.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

#: lane order in the viewer (unknown layers append after these)
LAYERS = ("api", "coll", "p2p", "dcn", "request")


def _tid(layer: str, extra: dict[str, int]) -> int:
    try:
        return LAYERS.index(layer)
    except ValueError:
        tid = extra.get(layer)
        if tid is None:
            tid = extra[layer] = len(LAYERS) + len(extra)
        return tid


def to_chrome(
    events: Iterable[tuple],
    epoch: tuple[int, int],
    pid: int = 0,
    process_name: str | None = None,
) -> dict[str, Any]:
    """Build a Chrome trace dict from tracer event tuples; ``epoch`` is
    ``(wall_ns, perf_ns)`` from :func:`core.epoch`."""
    wall_ns, perf_ns = epoch
    base_us = wall_ns / 1000.0

    def ts_us(t_ns: int) -> float:
        return base_us + (t_ns - perf_ns) / 1000.0

    extra_tids: dict[str, int] = {}
    out: list[dict[str, Any]] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name or f"ompi_tpu rank {pid}"},
        }
    ]
    seen_layers: dict[str, int] = {}
    for ph, t_ns, dur_ns, layer, name, comm, seq, args in events:
        tid = _tid(layer, extra_tids)
        seen_layers.setdefault(layer, tid)
        ev: dict[str, Any] = {
            "ph": ph, "name": name, "cat": layer, "pid": pid, "tid": tid,
            "ts": round(ts_us(t_ns), 3),
        }
        if ph == "X":
            ev["dur"] = round(dur_ns / 1000.0, 3)
        ev_args: dict[str, Any] = dict(args) if args else {}
        if comm:
            ev_args["comm"] = comm
        if seq >= 0:
            ev_args["seq"] = seq
        if ev_args:
            ev["args"] = ev_args
        out.append(ev)
    for layer, tid in sorted(seen_layers.items(), key=lambda kv: kv[1]):
        out.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": layer},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump(path: str, pid: int = 0, process_name: str | None = None,
         partial: bool = False) -> str:
    """Write this process's ring buffer as Chrome trace JSON.
    ``partial=True`` marks a crash-path dump (the process died before
    finalize) in ``otherData`` for the merge and report tools."""
    from . import core

    doc = to_chrome(core.events(), core.epoch(), pid=pid,
                    process_name=process_name)
    doc["otherData"] = {
        "pid": pid,
        "dropped_events": core.dropped(),
        "recorded_events": core.event_count(),
    }
    if partial:
        doc["otherData"]["partial"] = True
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
