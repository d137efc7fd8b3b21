"""Monitoring — per-communicator collective accounting at the module layer.

Port of the coll half of ``ompi_tpu/tool/monitoring.py`` (≈ the
reference's ``coll/monitoring``): a coll component at the top of the
stack (priority 99, it sees the partly built table) whose module wraps
every stacked slot with a counting shim — calls and payload bytes per
(communicator, slot).  Enabled with ``--mca monitoring_base_enable 1``;
:func:`flush` returns the accounting and finalize dumps it to
``monitoring_base_output``.  Like the reference's, the module has no
resolver: with monitoring on, every collective takes the table path so
that the shim sees it.  The pml half (per-peer point-to-point
matrices) comes with the port of ``p2p/pml.py``.
"""

from __future__ import annotations

import json
import threading
from typing import Any

from ompi_tpu_torch.core.registry import Component, register_component

from .spc import payload_nbytes

_lock = threading.Lock()
#: coll op counts: (comm_name, slot) → [calls, bytes]
_coll_counts: dict[tuple[str, str], list[int]] = {}


def account_coll(comm_name: str, op: str, nbytes: int) -> None:
    with _lock:
        cell = _coll_counts.setdefault((comm_name, op), [0, 0])
        cell[0] += 1
        cell[1] += nbytes


def flush() -> dict[str, Any]:
    """All accumulated accounting, JSON-shaped as the reference's dump
    (its ``p2p`` matrices stay empty until the pml half is ported)."""
    with _lock:
        return {
            "p2p": {},
            "coll": {
                f"{comm}:{op}": {"calls": c, "bytes": b}
                for (comm, op), (c, b) in _coll_counts.items()
            },
        }


def reset() -> None:
    with _lock:
        _coll_counts.clear()


def dump(path: str) -> None:
    """Write the accounting (finalize-time behaviour of common/monitoring)."""
    with open(path, "w") as f:
        json.dump(flush(), f, indent=1)


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
        store.register(
            "monitoring", "base", "enable", False,
            help="Account per-communicator collective traffic "
            "(≈ --mca coll monitoring)",
        )
        store.register(
            "monitoring", "base", "output", "", type="string",
            help="Path to dump the accounting at finalize",
        )

    def open(self, store) -> bool:
        return bool(store.get("monitoring_base_enable", False))

    def query(self, comm, table=None):
        if table is None or not table.slots:
            return None
        return MonitoringCollModule(comm, table)

    query.wants_table = True
