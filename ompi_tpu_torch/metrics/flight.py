"""Flight recorder — counter snapshots at the moment something goes wrong.

Port of ``ompi_tpu/metrics/flight.py``.  :func:`record` snapshots every
counter, tagged with why, into a bounded in-memory ring and — when
``--mca metrics_output`` is set — appends it at once to
``<output>.flight.<proc>.jsonl``, so a process that dies mid-run still
leaves its last state on disk.  The export's JSONL starts with these
records.  :func:`check_watermarks`, called from the native plane's send
paths, records the first crossing of each transport stall threshold
(the reference's watermarks: stall time, rendezvous slot exhaustion,
ring backpressure).
"""

from __future__ import annotations

import collections
import json
import threading

_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=64)
_output = ""
#: this process's index in a tpurun job (0 when one process drives
#: every rank): names the flight file and tags each snapshot
_proc = 0
#: watermark thresholds: (counter, level) latches, each crossed once
_WATERMARKS = (
    ("stall_ns", 1_000_000),      # >= 1 ms cumulative send-side stall
    ("stall_ns", 1_000_000_000),  # >= 1 s: the wedge precursor
    ("slot_waits", 1),            # rendezvous slot table saturated
    ("ring_stalls", 1),           # first ring-backpressure block
)
_crossed: set = set()
#: opportunistic check cadence (every Nth in-path call)
_CHECK_EVERY = 64
_check_tick = 0


def configure(output: str = "", max_records: int = 64) -> None:
    global _output, _records
    with _lock:
        _output = output
        if max_records != _records.maxlen:
            _records = collections.deque(_records,
                                         maxlen=max(1, int(max_records)))


def set_proc(proc: int) -> None:
    global _proc
    _proc = proc


def reset() -> None:
    global _check_tick
    with _lock:
        _records.clear()
        _crossed.clear()
        _check_tick = 0


def records() -> list[dict]:
    with _lock:
        return list(_records)


def record(reason: str, **extra) -> dict | None:
    """Snapshot now, tagged with why.  No-op when metrics are disabled."""
    from . import core

    if not core._enabled:
        return None
    snap = core.snapshot(reason=reason, proc=_proc)
    if extra:
        snap["detail"] = {k: v for k, v in extra.items()
                          if isinstance(v, (str, int, float, bool))}
    with _lock:
        _records.append(snap)
        out = _output
    if out:
        # append now (crash-robust); the recorder rides failure paths,
        # so a write error must not raise into the caller
        try:
            path = f"{out}.flight.{_proc}.jsonl"
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        except OSError:
            pass
    return snap


def check_watermarks(force: bool = False) -> None:
    """Opportunistic watermark check, every ``_CHECK_EVERY`` calls (one
    counter compare otherwise).  Each (counter, level) threshold latches
    once per run; the latch set changes under the lock, so two sender
    threads crossing on one tick record it once, and the snapshots are
    taken outside it (:func:`record` takes the lock again)."""
    global _check_tick
    from . import core

    if not core._enabled:
        return
    with _lock:
        _check_tick += 1
        if not force and _check_tick % _CHECK_EVERY:
            return
    native = core.native_counters()
    claimed = []
    with _lock:
        for name, level in _WATERMARKS:
            key = (name, level)
            if key not in _crossed and native.get(name, 0) >= level:
                _crossed.add(key)
                claimed.append((name, level))
    for name, level in claimed:
        record("watermark", counter=name, level=level,
               value=int(native.get(name, 0)))
