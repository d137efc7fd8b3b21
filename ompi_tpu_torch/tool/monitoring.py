"""Monitoring — per-peer traffic accounting at the module layer.

Port of ``ompi_tpu/tool/monitoring.py`` (≈ the reference's
``pml/monitoring`` and ``coll/monitoring``).  Two interposers:

* :class:`MonitoredEngine` wraps a pml matching engine: every ``send``
  adds (1 message, payload bytes) to the ``(source, dest)`` cell of the
  communicator's point-to-point matrices;
* :class:`MonitoringCollComponent` is a coll component at the top of
  the stack (priority 99, it sees the partly built table) whose module
  wraps every stacked slot with a counting shim — calls and payload
  bytes per (communicator, slot).  Like the reference's, the module has
  no resolver: with monitoring on, every collective takes the table
  path so that the shim sees it.

Both are enabled with ``--mca monitoring_base_enable 1``; :func:`flush`
returns the accounting and finalize dumps it to
``monitoring_base_output``.
"""

from __future__ import annotations

import json
import threading
from typing import Any

import numpy as np

from ompi_tpu_torch.core.registry import Component, register_component

from .spc import payload_nbytes

_lock = threading.Lock()
#: (class, comm_name) → size×size [messages, bytes] matrices
_matrices: dict[tuple[str, str], dict[str, np.ndarray]] = {}
#: coll op counts: (comm_name, slot) → [calls, bytes]
_coll_counts: dict[tuple[str, str], list[int]] = {}


def _matrix(cls: str, comm_name: str, size: int) -> dict[str, np.ndarray]:
    key = (cls, comm_name)
    with _lock:
        m = _matrices.get(key)
        if m is None:
            m = _matrices[key] = {
                "messages": np.zeros((size, size), np.int64),
                "bytes": np.zeros((size, size), np.int64),
            }
        return m


def account_p2p(comm_name: str, size: int, source: int, dest: int, nbytes: int) -> None:
    m = _matrix("pml", comm_name, size)
    with _lock:
        m["messages"][source, dest] += 1
        m["bytes"][source, dest] += nbytes


def account_coll(comm_name: str, op: str, nbytes: int) -> None:
    with _lock:
        cell = _coll_counts.setdefault((comm_name, op), [0, 0])
        cell[0] += 1
        cell[1] += nbytes


def flush() -> dict[str, Any]:
    """All accumulated accounting, JSON-shaped as the reference's dump."""
    with _lock:
        return {
            "p2p": {
                f"{cls}:{comm}": {k: v.tolist() for k, v in m.items()}
                for (cls, comm), m in _matrices.items()
            },
            "coll": {
                f"{comm}:{op}": {"calls": c, "bytes": b}
                for (comm, op), (c, b) in _coll_counts.items()
            },
        }


def reset() -> None:
    with _lock:
        _matrices.clear()
        _coll_counts.clear()


def dump(path: str) -> None:
    """Write the accounting (finalize-time behaviour of common/monitoring)."""
    with open(path, "w") as f:
        json.dump(flush(), f, indent=1)


def _register_vars(store) -> None:
    """Either interposer (pml or coll) may open first, so both register
    the common vars (registration is idempotent)."""
    store.register(
        "monitoring", "base", "enable", False,
        help="Account per-peer point-to-point and per-communicator "
        "collective traffic (≈ --mca pml monitoring)",
    )
    store.register(
        "monitoring", "base", "output", "", type="string",
        help="Path to dump the accounting at finalize",
    )


class MonitoredEngine:
    """pml/monitoring: proxy around a matching engine, accounting sends."""

    def __init__(self, inner, comm_name: str, comm_size: int):
        self._inner = inner
        self._comm_name = comm_name
        self._comm_size = comm_size

    def send(self, source: int, dest: int, payload, tag: int,
             dest_device=None, _account: bool = True) -> None:
        # deliver first: the engine validates ranks and tag, and only a
        # message that was sent is accounted
        self._inner.send(source, dest, payload, tag, dest_device, _account=_account)
        if _account and 0 <= dest < self._comm_size:
            account_p2p(self._comm_name, self._comm_size, source, dest,
                        payload_nbytes(payload))

    def __getattr__(self, name):
        return getattr(self._inner, name)


@register_component
class MonitoringPmlComponent(Component):
    """pml/monitoring: outbids pml/eager when enabled, returning a
    counting proxy over the engine it builds underneath."""

    FRAMEWORK = "pml"
    NAME = "monitoring"
    PRIORITY = 80  # above eager (50); open() gates on the enable var

    def register_params(self, store) -> None:
        super().register_params(store)
        _register_vars(store)

    def open(self, store) -> bool:
        return bool(store.get("monitoring_base_enable", False))

    def make_engine(self, comm_size: int, comm_name: str = "?"):
        from ompi_tpu_torch.p2p.pml import MatchingEngine

        return MonitoredEngine(MatchingEngine(comm_size), comm_name, comm_size)


class MonitoringCollModule:
    """coll/monitoring's module: wraps every stacked slot."""

    def __init__(self, comm, table):
        self.comm = comm
        self._table = table

    def enable(self) -> None:
        pass

    def disable(self) -> None:
        pass

    def provided(self) -> dict[str, Any]:
        return {slot: self._wrap(slot, fn) for slot, fn in self._table.slots.items()}

    def _wrap(self, slot: str, fn):
        comm_name = self.comm.name

        def shim(*args, **kwargs):
            account_coll(comm_name, slot, payload_nbytes(args[0]) if args else 0)
            return fn(*args, **kwargs)

        shim.__name__ = f"monitored_{slot}"
        return shim


@register_component
class MonitoringCollComponent(Component):
    FRAMEWORK = "coll"
    NAME = "monitoring"
    PRIORITY = 99  # top of the stack but for sync: wraps tuned/cuda/basic

    def register_params(self, store) -> None:
        super().register_params(store)
        _register_vars(store)

    def open(self, store) -> bool:
        return bool(store.get("monitoring_base_enable", False))

    def query(self, comm, table=None):
        if table is None or not table.slots:
            return None
        return MonitoringCollModule(comm, table)

    query.wants_table = True
