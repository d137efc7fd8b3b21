"""``vprotocol`` — message event logging for deterministic replay.

Port of ``ompi_tpu/p2p/vprotocol.py`` (≈ ``vprotocol/pessimist``): a pml
interposer that journals every point-to-point event and, above all, the
SOURCE each wildcard receive matched — the nondeterminism a pessimist
protocol pins down for replay.  Events go to a JSONL file (``--mca
vprotocol_pessimist_log PATH``, ``%r`` replaced by the process's rank);
:func:`load_log` returns the stream.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.tool.spc import payload_nbytes


class LoggedEngine:
    """Proxy over a matching engine, journaling p2p events."""

    def __init__(self, inner, comm_name: str, path: str):
        self._inner = inner
        self._comm_name = comm_name
        self._path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)

    def _log(self, event: str, **kw) -> None:
        rec = {"event": event, "comm": self._comm_name, **kw}
        with self._lock:
            self._fh.write(json.dumps(rec) + "\n")

    def send(self, source: int, dest: int, payload, tag: int,
             dest_device=None, _account: bool = True) -> None:
        self._inner.send(source, dest, payload, tag, dest_device, _account=_account)
        self._log("send", src=source, dst=dest, tag=tag, nbytes=payload_nbytes(payload))

    def irecv(self, dest: int, source: int = -1, tag: int = -1):
        req = self._inner.irecv(dest, source, tag)
        self._log("post", dst=dest, src=source, tag=tag)
        wildcard = source == -1
        log = self._log
        once = threading.Lock()
        done = [False]

        def log_match(status):
            # exactly one match record per receive: the wrapped deliver
            # and the already-completed branch below can race
            with once:
                if done[0]:
                    return
                done[0] = True
            log("match", dst=dest, src=int(status.source), tag=int(status.tag),
                wildcard=wildcard)

        orig_deliver = req._deliver

        def deliver(payload, status, *rest):
            orig_deliver(payload, status, *rest)
            log_match(status)

        req._deliver = deliver
        # an unexpected-queue hit: the engine delivered already
        if req._event.is_set():
            log_match(req.status)
        return req

    def __getattr__(self, name):
        return getattr(self._inner, name)


def load_log(path: str) -> list[dict[str, Any]]:
    """The journaled event stream (the replay driver's input)."""
    with open(path) as f:
        return [json.loads(line) for line in (ln.strip() for ln in f) if line]


@register_component
class VprotocolPmlComponent(Component):
    """pml/vprotocol — outbids the plain pml when a log path is set."""

    FRAMEWORK = "pml"
    NAME = "vprotocol"
    PRIORITY = 85  # above monitoring (80): logging wraps accounting

    def register_params(self, store) -> None:
        super().register_params(store)
        self._store = store
        store.register(
            "vprotocol", "pessimist", "log", "", type="string",
            help="Per-process p2p event-log path ('%%r' -> rank) — "
            "enables message logging (≈ vprotocol/pessimist)",
        )

    def open(self, store) -> bool:
        self._store = store
        return bool(store.get("vprotocol_pessimist_log", ""))

    def make_engine(self, comm_size: int, comm_name: str = "?"):
        from ompi_tpu_torch.p2p.pml import MatchingEngine

        inner = MatchingEngine(comm_size)
        # stack over monitoring when both are on, as the reference does
        if bool(self._store.get("monitoring_base_enable", False)):
            from ompi_tpu_torch.tool.monitoring import MonitoredEngine

            inner = MonitoredEngine(inner, comm_name, comm_size)
        path = str(self._store.get("vprotocol_pessimist_log"))
        path = path.replace("%r", os.environ.get("OMPI_TPU_PROC", "0"))
        return LoggedEngine(inner, comm_name, path)
