"""Flight recorder — counter snapshots at the moment something goes wrong.

Port of ``ompi_tpu/metrics/flight.py``.  :func:`record` snapshots every
counter, tagged with why, into a bounded in-memory ring and — when
``--mca metrics_output`` is set — appends it at once to
``<output>.flight.<proc>.jsonl``, so a process that dies mid-run still
leaves its last state on disk.  The export's JSONL starts with these
records.  The reference's watermark crossings read transport stall
counters; they come with the transport planes.
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
    with _lock:
        _records.clear()


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
