"""Cross-rank trace merge — one timeline from per-process trace files.

Port of ``ompi_tpu/trace/merge.py``, unchanged.

A ``tpurun`` job writes one Chrome trace per process
(``<trace_output>.<proc>.json``).  This module folds them into a single
timeline:

* every event keeps its originating ``pid`` (tpurun process index), so
  the viewer shows one process group per rank;
* collective api-layer spans carry a ``(comm, op, seq)`` key recorded
  at issue time; the merge stamps each with ``args.key =
  "comm/op/seq"`` so one collective's spans across ALL ranks select
  together in Perfetto — the cross-rank alignment the per-(comm, op)
  sequence counter exists for;
* events are sorted by timestamp (all processes share the host
  wall-clock anchor, so ordering is meaningful on one host).

:func:`collective_keys` extracts a rank's key sequence; ranks of one
communicator must produce identical sequences (MPI same-issue-order),
which the np=2 test asserts.
"""

from __future__ import annotations

import json
from typing import Any, Iterable


def load(path: str) -> dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace-event file")
    return doc


def span_key(ev: dict[str, Any]) -> str | None:
    """The merge key of a collective span, or None for unkeyed events."""
    args = ev.get("args") or {}
    if ev.get("ph") == "X" and "seq" in args and "comm" in args:
        return f"{args['comm']}/{ev['name']}/{args['seq']}"
    return None


def merge_chrome(docs: Iterable[dict[str, Any]],
                 offsets_us: dict[int, float] | None = None
                 ) -> dict[str, Any]:
    """Merge loaded Chrome trace dicts into one timeline.

    ``offsets_us`` is the per-process clock correction (pid → that
    process's clock MINUS the reference clock, µs — the HELLO→SEQACK
    handshake estimate each rank's metrics snapshot carries as
    ``clock``): each event's ``ts`` is shifted onto the reference
    timeline, so cross-rank span alignment survives host clock skew
    instead of trusting raw wall clocks.  The applied corrections are
    recorded in ``otherData.clock_offsets_us``."""
    offsets_us = offsets_us or {}
    events: list[dict[str, Any]] = []
    dropped = 0
    partial: list[int] = []
    for doc in docs:
        other = doc.get("otherData") or {}
        dropped += int(other.get("dropped_events", 0))
        for ev in doc["traceEvents"]:
            ev = dict(ev)
            off = offsets_us.get(int(ev.get("pid", 0)), 0.0)
            if off and "ts" in ev and ev.get("ph") != "M":
                ev["ts"] = round(float(ev["ts"]) - off, 3)
            key = span_key(ev)
            if key is not None:
                ev["args"] = dict(ev["args"], key=key)
            events.append(ev)
        if other.get("partial"):
            # the doc-level pid (chrome.dump records it) identifies a
            # partial rank even when it crash-dumped with ZERO events;
            # first-event pid is the fallback for older dumps
            if "pid" in other:
                partial.append(int(other["pid"]))
            else:
                partial += [int(e.get("pid", 0))
                            for e in doc["traceEvents"][:1]]
    # metadata (ph M) first, then by timestamp — Chrome tolerates any
    # order but a sorted timeline diffs cleanly and streams to viewers
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    other_out: dict[str, Any] = {"merged_processes": _pids(events),
                                 "dropped_events": dropped}
    if offsets_us:
        other_out["clock_offsets_us"] = {
            str(p): round(float(o), 3) for p, o in offsets_us.items()}
    if partial:
        other_out["partial_processes"] = sorted(set(partial))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other_out,
    }


def merge_files(paths: Iterable[str],
                offsets_us: dict[int, float] | None = None
                ) -> dict[str, Any]:
    return merge_chrome((load(p) for p in paths), offsets_us=offsets_us)


def _pids(events: list[dict[str, Any]]) -> list[int]:
    return sorted({int(e.get("pid", 0)) for e in events})


def offsets_from_snapshots(snaps: Iterable[dict]) -> dict[int, float]:
    """``{pid: offset_us}`` from metrics JSONL snapshots: each rank-0
    snapshot's ``clock`` section holds ``{proc: [offset_ns, rtt_ns]}``
    measured from rank 0 (peer_clock − rank0_clock), so subtracting
    the offset maps a peer's events onto rank 0's timeline.  Later
    snapshots refine earlier ones; rank 0 itself stays at 0."""
    out: dict[int, float] = {}
    for s in snaps:
        if int(s.get("proc") or 0) != 0:
            continue
        for p, v in (s.get("clock") or {}).items():
            off = v[0] if isinstance(v, (list, tuple)) else v
            out[int(p)] = float(off) / 1000.0
    return out


def collective_keys(doc: dict[str, Any], pid: int | None = None) -> list[tuple]:
    """Ordered (comm, op, seq) keys of one process's collective spans
    (``pid=None``: all processes).  Order is by seq within (comm, op)
    issue order — i.e. by timestamp."""
    out = []
    for ev in sorted(
        (e for e in doc["traceEvents"] if e.get("ph") == "X"),
        key=lambda e: e.get("ts", 0),
    ):
        if pid is not None and int(ev.get("pid", 0)) != pid:
            continue
        args = ev.get("args") or {}
        if "seq" in args and "comm" in args:
            out.append((args["comm"], ev["name"], int(args["seq"])))
    return out
